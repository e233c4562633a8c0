"""Nestable span timers: one timing truth for JSONL and the profiler.

``with span("ckpt"): ...`` measures a wall-clock duration, emits a
``span`` event through the bus, and (by default) opens a
``torch.profiler.record_function`` range of the same name -- so the
phase boundaries in a run's JSONL and the named regions in a
``torch.profiler`` trace are the SAME brackets, not two
instrumentation layers that drift. (The JAX package's counterpart
opens a ``jax.profiler.TraceAnnotation`` here.)
Spans nest: each event carries its ``parent`` span name and depth, so
the report can attribute child time without double counting.

Clock contract (pinned in tests/test_trace.py): **durations come from
the monotonic clock** (``time.perf_counter``), never wall time -- an
NTP step mid-span must not corrupt a phase share. Every span event
also carries ``t_mono`` (the monotonic timestamp at span end, same
clock as the duration) next to the bus-stamped wall ``time``: a
cross-host trace merge (obs/trace.py) orders and measures each host
on its own monotonic axis and uses wall time only for coarse
alignment between hosts.

For phases whose duration is measured some other way (the Trainer's
chunk timer already brackets dispatch-to-fetch), :func:`emit_span`
records a pre-aggregated duration without re-timing it.
"""
from __future__ import annotations

import contextlib
import threading
import time
from typing import Iterator, Optional

from tpu_hpc_torch.obs.events import EventBus, get_bus

_stack = threading.local()


def _current_stack() -> list:
    st = getattr(_stack, "names", None)
    if st is None:
        st = _stack.names = []
    return st


def emit_span(
    name: str,
    dur_s: float,
    *,
    bus: Optional[EventBus] = None,
    sink: Optional[str] = None,
    step: Optional[int] = None,
    hist: Optional[str] = None,
    **fields,
) -> dict:
    """Emit one ``span`` record for an already-measured duration.
    ``hist`` additionally observes the duration into the global
    metrics registry under that histogram name."""
    if hist is not None:
        from tpu_hpc_torch.obs.registry import get_registry

        get_registry().observe(hist, dur_s)
    st = _current_stack()
    return (bus or get_bus()).emit(
        "span",
        sink=sink,
        name=name,
        dur_s=dur_s,
        t_mono=time.perf_counter(),
        step=step,
        parent=st[-1] if st else None,
        depth=len(st),
        **fields,
    )


@contextlib.contextmanager
def span(
    name: str,
    *,
    bus: Optional[EventBus] = None,
    sink: Optional[str] = None,
    step: Optional[int] = None,
    annotate: bool = True,
    hist: Optional[str] = None,
    **fields,
) -> Iterator[None]:
    """Time a block as a named span.

    Emits the ``span`` event in a ``finally`` (an exception inside the
    block still records the phase and its duration -- the flight
    recorder wants exactly the event that preceded the crash).
    ``annotate=False`` skips the profiler range (a
    ``record_function`` costs a few microseconds even with no profiler
    attached).
    """
    ann = contextlib.nullcontext()
    if annotate:
        import torch

        ann = torch.profiler.record_function(name)
    st = _current_stack()
    st.append(name)
    t0 = time.perf_counter()
    try:
        with ann:
            yield
    finally:
        dur = time.perf_counter() - t0
        st.pop()
        emit_span(
            name, dur, bus=bus, sink=sink, step=step, hist=hist,
            **fields,
        )
