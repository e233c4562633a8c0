"""Causal trace contexts: run_id-scoped trace ids and the ambient
trace every bus emit is stamped with.

Copied from the first part of the JAX package's ``obs/trace.py``. A
trace id is ``"<run_id>:<kind>:<key>"`` -- ``req:r0042`` for a serving
request, ``step:128`` for a training step. Because the id is a pure
function of (run_id, kind, key), every layer derives the SAME id with
zero coordination. Producers either stamp ``trace_id`` explicitly (the
request lifecycle events) or :func:`activate` a context around a call
so everything emitted inside -- engine spans, ``kv_block`` ring events
-- joins the trace ambiently.

The critical-path analyzer (``python -m tpu_hpc.obs.trace``) and the
anomaly-triggered capture of the JAX module are not ported yet
(ROADMAP); they read the same records.
"""
from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Iterator, Optional, Tuple

from tpu_hpc_torch.obs import events as events_mod
from tpu_hpc_torch.obs.events import EventBus, get_bus

# Trace kinds with a meaning the analyzer knows how to reconstruct.
KIND_REQUEST = "req"
KIND_STEP = "step"
KIND_TICK = "tick"


# -- trace contexts ----------------------------------------------------
@dataclasses.dataclass(frozen=True)
class TraceContext:
    """One trace's identity plus its birth clocks. ``t_mono`` /
    ``t_wall`` anchor the monotonic timeline against wall time for
    cross-host alignment; durations always come from the monotonic
    clock (the spans.py contract)."""

    trace_id: str
    kind: str
    key: str
    t_wall: float
    t_mono: float
    parent: Optional[str] = None


def trace_id_for(
    kind: str, key, run_id: Optional[str] = None,
    bus: Optional[EventBus] = None,
) -> str:
    """The canonical derived id: ``<run_id>:<kind>:<key>``. Pure in
    (run_id, kind, key), so every layer/host that knows the key
    derives the same id without a registry."""
    run = run_id or (bus or get_bus()).run_id
    return f"{run}:{kind}:{key}"


def request_trace_id(rid: str, run_id: Optional[str] = None) -> str:
    return trace_id_for(KIND_REQUEST, rid, run_id=run_id)


def step_trace_id(step: int, run_id: Optional[str] = None) -> str:
    return trace_id_for(KIND_STEP, int(step), run_id=run_id)


def parse_trace_id(trace_id: str) -> Tuple[Optional[str], str, str]:
    """``(run_id, kind, key)``; run_id None when the id is not in the
    canonical 3-part form (run ids never contain ':', so splitting
    from the right is unambiguous even for exotic run id spellings)."""
    parts = trace_id.rsplit(":", 2)
    if len(parts) == 3:
        return parts[0], parts[1], parts[2]
    return None, "", trace_id


def new_context(
    kind: str, key, parent: Optional[str] = None,
    run_id: Optional[str] = None, bus: Optional[EventBus] = None,
) -> TraceContext:
    return TraceContext(
        trace_id=trace_id_for(kind, key, run_id=run_id, bus=bus),
        kind=kind, key=str(key),
        t_wall=time.time(), t_mono=time.perf_counter(),
        parent=parent,
    )


def announce(
    ctx: TraceContext,
    *,
    tenant: Optional[str] = None,
    sink: Optional[str] = None,
    bus: Optional[EventBus] = None,
) -> dict:
    """Emit the ``trace_ctx`` birth record for ``ctx`` -- the anchor
    the analyzer joins later spans/events against."""
    return (bus or get_bus()).emit(
        "trace_ctx",
        sink=sink,
        trace_id=ctx.trace_id,
        kind=ctx.kind,
        key=ctx.key,
        tenant=tenant,
        parent=ctx.parent,
        t_wall=ctx.t_wall,
        t_mono=ctx.t_mono,
    )


@contextlib.contextmanager
def activate(ctx) -> Iterator[None]:
    """Make ``ctx`` (a TraceContext or a bare trace id string) the
    thread's ambient trace: every bus emit inside the block that does
    not carry an explicit ``trace_id`` is stamped with it. Nests --
    the previous ambient trace is restored on exit."""
    tid = ctx.trace_id if isinstance(ctx, TraceContext) else ctx
    prev = getattr(events_mod._TRACE, "trace_id", None)
    events_mod._TRACE.trace_id = tid
    try:
        yield
    finally:
        events_mod._TRACE.trace_id = prev
