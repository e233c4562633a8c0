"""End-to-end causal tracing: trace contexts, the critical-path
analyzer, and anomaly-triggered capture.

Port of the JAX package's ``obs/trace.py``; the analyzer reads the
same schema-stamped records, so it gives the JAX analyzer's report on
the same run log. The obs spine (schema/events/spans) measures
*totals*; this module adds *causality*. Three pieces:

**Trace contexts.** A trace id is a run_id-scoped string
``"<run_id>:<kind>:<key>"`` -- ``req:r0042`` for a serving request,
``step:128`` for a training step, ``tick:N`` for a load-harness tick.
Because the id is a pure function of (run_id, kind, key) and run_id is
shared process-wide (``TPU_HPC_RUN_ID``), every host and every layer
derives the SAME id with zero coordination -- which is what lets
flight-ring dumps from different hosts merge into one timeline.
Producers either stamp ``trace_id`` explicitly (the lifecycle events)
or :func:`activate` a context around a call so everything emitted
inside -- engine spans, ``kv_block`` ring events -- joins the trace
ambiently (one thread-local getattr per emit; the ring-only hot path
stays cheap).

**Critical-path analyzer** (``python -m tpu_hpc_torch.obs.trace
run.jsonl [--flight-dir D] [--json] [--chrome P]``). Reconstructs
per-request and per-step timelines from run JSONL plus any
flight-recorder dumps, decomposes TTFT into attributed phases (queue /
prefill execution / prefill interleave wait / decode), names the
dominant phase at each latency quantile (the request *at* p50/p95/p99,
not an average), does the same for training-step phase spans, and
exports a Chrome-trace / Perfetto JSON for visual inspection. A span
carrying a request trace id with no anchoring lifecycle event is an
**orphan** -- the analyzer counts them, and the tests pin zero on a
complete run.

**Anomaly-triggered capture** (:class:`AnomalyCapture`). When the
stall watermark trips, the numeric-health guard classifies a poisoned
step, or a loadgen SLO bound is breached, the capture controller
(armed by its owner: Trainer, LoadHarness, the fleet's burn monitor)
dumps the flight ring, arms ONE bounded ``torch.profiler`` window for
the next N steps (``profiling.TrainingProfiler``: a Chrome trace under
``<profile_dir>/capture<N>/``, with the card's kernels when the device
is a GPU), records the device-memory high-water mark, and emits a
``capture_triggered`` record keyed by the triggering trace_id.
Captures are one-shot by default: an anomaly storm must yield one
clean evidence bundle, not a disk full of overlapping traces.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import glob
import json
import os
import re
import sys
import time
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

from tpu_hpc_torch.obs import events as events_mod
from tpu_hpc_torch.obs.events import EventBus, get_bus
from tpu_hpc_torch.obs.quantiles import quantile
from tpu_hpc_torch.obs.schema import (
    SCHEMA_VERSION,
    SchemaError,
    load_records,
)

# Trace kinds with a meaning the analyzer knows how to reconstruct.
KIND_REQUEST = "req"
KIND_STEP = "step"
KIND_TICK = "tick"

# Scheduler-emitted spans whose durations are THIS request's own
# prefill execution (meter-clock, depth 0); everything else of the
# admit->first-token window is interleave/scheduling wait.
_PREFILL_EXEC_SPANS = ("prefill_chunk", "admit")
# Decode-side spans the ITL attribution splits shares over.
_DECODE_SIDE_SPANS = (
    "decode", "spec_draft", "spec_verify", "spec_draft_prefill",
    "colocated_train_step", "kv_transfer",
)


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


# -- anomaly-triggered capture ----------------------------------------
class AnomalyCapture:
    """Symptom -> evidence, automatically.

    ``trigger(reason, trace_id=...)`` (called by the stall watermark,
    the guard's poisoned verdict, or a loadgen SLO breach) dumps the
    flight ring, arms one bounded ``torch.profiler`` window covering
    the next ``n_steps`` steps (via profiling/profiler.TrainingProfiler),
    records the device-memory high-water mark, and emits a
    ``capture_triggered`` record correlating all of it by the
    triggering trace_id. The owner advances the bounded window with
    :meth:`step` and MUST :meth:`close` at run end (an open profiler
    window otherwise leaks for the life of the process, and blocks
    every later one: one torch profiler per process).

    ``device`` is the owner's (the Trainer's or the engine's): the
    window traces and synchronizes that device (None: the current CUDA
    device, or the CPU without one).

    One-shot by default (``max_captures=1``): exactly one evidence
    bundle per run unless the owner re-arms. Capture is diagnostics --
    every failure inside it is swallowed so a dying run's last act is
    never a new crash (the dump_flight contract).
    """

    def __init__(
        self,
        profile_dir: str,
        n_steps: int = 2,
        max_captures: int = 1,
        bus: Optional[EventBus] = None,
        device=None,
    ):
        if n_steps < 1:
            raise ValueError(f"n_steps {n_steps} must be >= 1")
        if max_captures < 1:
            raise ValueError(
                f"max_captures {max_captures} must be >= 1"
            )
        self.profile_dir = profile_dir
        self.n_steps = n_steps
        self.max_captures = max_captures
        self._bus = bus
        self.device = device
        # Lifetime count: also names the per-capture profiler dirs
        # (capture<N>), so a rearm NEVER re-numbers into a previous
        # bundle's directory -- the non-clobbering flight-dump
        # discipline applied to profiler output.
        self.captures = 0
        # Budget window: captures since the last rearm.
        self._window_used = 0
        self.last: Optional[dict] = None
        self._prof = None

    @property
    def armed(self) -> bool:
        return self._window_used < self.max_captures

    def rearm(self) -> None:
        """Allow another capture (a long-running service that has
        already shipped the previous evidence bundle). The lifetime
        counter keeps numbering, so the next bundle's profiler dir
        never overwrites an earlier one."""
        self._window_used = 0

    def trigger(
        self,
        reason: str,
        trace_id: Optional[str] = None,
        step: Optional[int] = None,
        sink: Optional[str] = None,
        arm_profiler: bool = True,
    ) -> Optional[dict]:
        """Fire one capture; returns the ``capture_triggered`` record,
        or None when the budget is spent (an anomaly storm re-triggers
        every tick -- only the first gets the evidence bundle).
        ``arm_profiler=False`` collects the flight dump + memory
        snapshot only -- for post-run triggers (an SLO breach at
        summary time) where no future steps exist to bound (or ever
        close) a profiler window."""
        if not self.armed:
            return None
        self.captures += 1
        self._window_used += 1
        bus = self._bus or get_bus()
        # The trace key rides in the dump filename so on-disk evidence
        # is greppable by request/step even before the JSONL is read.
        key = parse_trace_id(trace_id)[2] if trace_id else ""
        full_reason = f"capture.{reason}" + (f".{key}" if key else "")
        path = None
        if not bus.flight_dir:
            # The capture contract promises flight evidence under the
            # capture dir even when no TPU_HPC_FLIGHT_DIR is armed --
            # an unconfigured bus must not silently drop the dump.
            safe = re.sub(r"[^A-Za-z0-9_.-]", "_", full_reason)
            path = os.path.join(
                self.profile_dir,
                f"flight.{safe}.pid{os.getpid()}.jsonl",
            )
        flight_path = bus.dump_flight(full_reason, path=path)
        prof_dir = self._arm_profiler(step) if arm_profiler else None
        self._emit_device_memory(sink)
        self.last = bus.emit(
            "capture_triggered",
            sink=sink,
            reason=reason,
            trace_id=trace_id,
            step=step,
            n_steps=self.n_steps if prof_dir else 0,
            profile_dir=prof_dir,
            flight_path=flight_path,
        )
        return self.last

    def _arm_profiler(self, step: Optional[int]) -> Optional[str]:
        try:
            from tpu_hpc_torch.profiling import TrainingProfiler

            base = int(step or 0)
            log_dir = os.path.join(
                self.profile_dir, f"capture{self.captures}"
            )
            prof = TrainingProfiler(
                log_dir=log_dir, start_step=base,
                num_steps=self.n_steps, device=self.device,
            )
            prof.step(base)  # opens the trace NOW
            if prof.active:
                self._prof = prof
                return log_dir
        except Exception:
            # Profiler busy (the owner's own window, or any torch
            # profiler of this process, holds the one Kineto session)
            # or absent: the bundle goes on without a trace.
            pass
        return None

    def _emit_device_memory(self, sink: Optional[str]) -> None:
        try:
            from tpu_hpc_torch.profiling import device_memory_summary

            device_memory_summary(emit=True, sink=sink)
        except Exception:  # pragma: no cover - no allocator stats
            pass

    def step(self, step: int) -> None:
        """Advance the bounded profiler window; closes the trace once
        ``n_steps`` steps have passed since the trigger. Like every
        other capture path, failures are swallowed: a disk filling up
        while the trace flushes (likely during exactly the anomaly
        under capture) must not crash the run being diagnosed."""
        prof = self._prof
        if prof is None:
            return
        try:
            prof.step(int(step))
        except Exception:  # pragma: no cover - trace export I/O error
            self._prof = None
        else:
            if not prof.active:
                self._prof = None

    def close(self) -> None:
        """Stop any still-open capture trace (run teardown)."""
        if self._prof is not None:
            try:
                self._prof.stop()
            except Exception:  # pragma: no cover - disk-full teardown
                pass
            self._prof = None


# -- timeline reconstruction ------------------------------------------
@dataclasses.dataclass
class RequestTrace:
    """One request's reconstructed lifecycle (all times in ms on the
    meter clock, relative to its own submission)."""

    trace_id: str
    rid: str
    tenant: str = "default"
    arrival_ms: Optional[float] = None
    queue_ms: Optional[float] = None
    ttft_ms: Optional[float] = None
    total_ms: Optional[float] = None
    tokens: Optional[int] = None
    shed: Optional[str] = None
    anchored: bool = False
    itl_ms: List[float] = dataclasses.field(default_factory=list)
    # (name, dur_ms, depth)
    spans: List[Tuple[str, float, int]] = dataclasses.field(
        default_factory=list
    )

    @property
    def complete(self) -> bool:
        return self.ttft_ms is not None and self.total_ms is not None

    def phases(self) -> Dict[str, float]:
        """TTFT + decode decomposition into named phases. ``prefill``
        is execution attributable to this request's own admission/
        chunk work (the scheduler's meter-clock spans);
        ``prefill_wait`` is the remainder of the admit->first-token
        window -- interleaved other-request work and scheduling."""
        out: Dict[str, float] = {}
        if self.ttft_ms is None:
            return out
        queue = max(float(self.queue_ms or 0.0), 0.0)
        out["queue"] = min(queue, self.ttft_ms)
        window = max(self.ttft_ms - out["queue"], 0.0)
        exec_ms = sum(
            ms for name, ms, depth in self.spans
            if name in _PREFILL_EXEC_SPANS and depth == 0
        )
        out["prefill"] = min(exec_ms, window)
        out["prefill_wait"] = window - out["prefill"]
        if self.total_ms is not None:
            out["decode"] = max(self.total_ms - self.ttft_ms, 0.0)
        return out

    def ttft_breakdown(self) -> dict:
        """Phase shares of THIS request's TTFT plus the dominant
        phase -- the per-quantile critical-path row."""
        phases = {
            k: v for k, v in self.phases().items() if k != "decode"
        }
        ttft = self.ttft_ms or 0.0
        attributed = sum(phases.values())
        shares = {
            k: (v / ttft if ttft > 0 else 0.0)
            for k, v in phases.items()
        }
        dominant = (
            max(phases, key=phases.get) if phases else None
        )
        return {
            "rid": self.rid,
            "tenant": self.tenant,
            "ttft_ms": ttft,
            "phases_ms": phases,
            "shares": shares,
            "dominant": dominant,
            "attributed": (
                attributed / ttft if ttft > 0 else 1.0
            ),
        }


@dataclasses.dataclass
class StepTrace:
    """One training step/chunk's phase spans (wall-derived durations
    measured on the monotonic clock)."""

    trace_id: str
    step: int
    spans: List[Tuple[str, float, int]] = dataclasses.field(
        default_factory=list
    )
    stalls: int = 0

    @property
    def wall_ms(self) -> float:
        return sum(ms for _, ms, depth in self.spans if depth == 0)

    def phases(self) -> Dict[str, float]:
        out: Dict[str, float] = {}
        for name, ms, depth in self.spans:
            if depth == 0:
                out[name] = out.get(name, 0.0) + ms
        return out

    def breakdown(self) -> dict:
        phases = self.phases()
        wall = self.wall_ms
        dominant = max(phases, key=phases.get) if phases else None
        return {
            "step": self.step,
            "wall_ms": wall,
            "phases_ms": phases,
            "shares": {
                k: (v / wall if wall > 0 else 0.0)
                for k, v in phases.items()
            },
            "dominant": dominant,
        }


_LIFECYCLE_ANCHORS = (
    "trace_ctx", "lg_arrival", "lg_admit", "lg_first_token",
    "lg_finish", "lg_shed", "request",
)


def build_traces(records: Sequence[dict]) -> dict:
    """Group records by trace_id into request/step timelines.

    Returns ``{"requests": {tid: RequestTrace}, "steps":
    {tid: StepTrace}, "orphan_spans": int, "captures": [...]}`` --
    an orphan is a span carrying a request-kind trace id that no
    lifecycle event ever anchored (a propagation bug: some layer
    stamped an id nothing else knows about)."""
    requests: Dict[str, RequestTrace] = {}
    steps: Dict[str, StepTrace] = {}
    captures: List[dict] = []
    orphans = 0

    def req(tid: str, key: str) -> RequestTrace:
        rt = requests.get(tid)
        if rt is None:
            rt = requests[tid] = RequestTrace(trace_id=tid, rid=key)
        return rt

    for r in records:
        event = r.get("event")
        if event == "capture_triggered":
            captures.append(r)
            continue
        tid = r.get("trace_id")
        if not tid:
            continue
        _, kind, key = parse_trace_id(tid)
        if kind == KIND_REQUEST:
            rt = req(tid, key)
            if "tenant" in r:
                rt.tenant = r["tenant"]
            if event in _LIFECYCLE_ANCHORS:
                rt.anchored = True
            if event == "lg_arrival":
                rt.arrival_ms = float(r["arrival_ms"])
            elif event == "lg_admit":
                rt.queue_ms = float(r["queue_ms"])
            elif event == "lg_first_token":
                rt.ttft_ms = float(r["ttft_ms"])
            elif event == "lg_token" and "itl_ms" in r:
                rt.itl_ms.append(float(r["itl_ms"]))
            elif event == "lg_finish":
                rt.total_ms = float(r["total_ms"])
                rt.tokens = int(r["tokens"])
            elif event == "lg_shed":
                rt.shed = r.get("reason") or "shed"
            elif event == "request":
                # The plain ServeMeter path (non-loadgen replays).
                rt.queue_ms = float(r["queue_ms"])
                rt.ttft_ms = float(r["ttft_ms"])
                rt.total_ms = float(r["total_ms"])
                rt.tokens = int(r["tokens"])
                rt.anchored = True
            elif event == "span":
                rt.spans.append((
                    r["name"], 1e3 * float(r["dur_s"]),
                    int(r.get("depth") or 0),
                ))
        elif kind in (KIND_STEP, KIND_TICK):
            st = steps.get(tid)
            if st is None:
                try:
                    stepno = int(key)
                except ValueError:
                    stepno = -1
                st = steps[tid] = StepTrace(trace_id=tid, step=stepno)
            if event == "span":
                st.spans.append((
                    r["name"], 1e3 * float(r["dur_s"]),
                    int(r.get("depth") or 0),
                ))
            elif event == "stall":
                st.stalls += 1
        elif event == "span":
            # A span with an unparseable trace id can be attributed to
            # nothing -- that is exactly what the orphan count flags.
            orphans += 1

    orphans += sum(
        len(rt.spans) for rt in requests.values() if not rt.anchored
    )
    return {
        "requests": requests,
        "steps": steps,
        "orphan_spans": orphans,
        "captures": captures,
    }


# -- critical-path analysis -------------------------------------------
_QUANTILES = (("p50", 0.50), ("p95", 0.95), ("p99", 0.99))


def _at_quantile(sorted_items: list, q: float):
    """Nearest-rank pick: the actual item AT the quantile, so the
    decomposition describes a real request/step, not an average."""
    if not sorted_items:
        return None
    idx = min(
        len(sorted_items) - 1,
        max(0, int(round(q * (len(sorted_items) - 1)))),
    )
    return sorted_items[idx]


def _analyze_requests(requests: Dict[str, RequestTrace],
                      records: Sequence[dict]) -> Optional[dict]:
    if not requests:
        return None
    done = sorted(
        (rt for rt in requests.values() if rt.complete),
        key=lambda rt: rt.ttft_ms,
    )
    shed = sum(1 for rt in requests.values() if rt.shed)
    phase_totals: Dict[str, float] = {}
    for rt in requests.values():
        for k, v in rt.phases().items():
            phase_totals[k] = phase_totals.get(k, 0.0) + v
    ttfts = [rt.ttft_ms for rt in done]
    out: dict = {
        "count": len(requests),
        "complete": len(done),
        "shed": shed,
        "phase_totals_ms": {
            k: round(v, 3) for k, v in sorted(phase_totals.items())
        },
        "ttft_ms": {
            name: quantile(ttfts, q) for name, q in _QUANTILES
        },
        "ttft_critical_path": {
            name: rt.ttft_breakdown()
            for name, q in _QUANTILES
            if (rt := _at_quantile(done, q)) is not None
        },
    }
    # ITL: quantiles from the closing serve_summary when present
    # (lg_token is ring-only by design), else rebuilt from whatever
    # per-token evidence a flight dump carried.
    summaries = [
        r for r in records if r.get("event") == "serve_summary"
    ]
    itls: List[float] = []
    for rt in requests.values():
        itls.extend(rt.itl_ms)
    itl_q = None
    if summaries:
        s = summaries[-1]
        itl_q = {
            name: s[f"itl_ms_{name}"]
            for name, _ in _QUANTILES if f"itl_ms_{name}" in s
        }
    elif itls:
        itls.sort()
        itl_q = {name: quantile(itls, q) for name, q in _QUANTILES}
    if itl_q is not None:
        out["itl_ms"] = itl_q
        # Decode-window attribution is batch-level (one decode step
        # serves every slot), so shares come from the decode-side
        # span totals rather than per-gap evidence.
        decode_spans: Dict[str, float] = {}
        for r in records:
            if (
                r.get("event") == "span"
                and r.get("name") in _DECODE_SIDE_SPANS
                and not r.get("depth")
            ):
                decode_spans[r["name"]] = (
                    decode_spans.get(r["name"], 0.0)
                    + 1e3 * float(r["dur_s"])
                )
        total = sum(decode_spans.values())
        out["itl_attribution"] = {
            "shares": {
                k: (v / total if total > 0 else 0.0)
                for k, v in sorted(decode_spans.items())
            },
            "dominant": (
                max(decode_spans, key=decode_spans.get)
                if decode_spans else None
            ),
        }
    return out


def _analyze_steps(steps: Dict[str, StepTrace]) -> Optional[dict]:
    timed = sorted(
        (st for st in steps.values() if st.spans),
        key=lambda st: st.wall_ms,
    )
    if not timed:
        return None
    walls = [st.wall_ms for st in timed]
    phase_totals: Dict[str, float] = {}
    for st in timed:
        for k, v in st.phases().items():
            phase_totals[k] = phase_totals.get(k, 0.0) + v
    total = sum(phase_totals.values())
    return {
        "count": len(timed),
        "stalls": sum(st.stalls for st in steps.values()),
        "wall_ms": {
            name: quantile(walls, q) for name, q in _QUANTILES
        },
        "phase_totals_ms": {
            k: round(v, 3) for k, v in sorted(phase_totals.items())
        },
        "shares": {
            k: (v / total if total > 0 else 0.0)
            for k, v in sorted(phase_totals.items())
        },
        "critical_path": {
            name: st.breakdown()
            for name, q in _QUANTILES
            if (st := _at_quantile(timed, q)) is not None
        },
    }


def analyze(records: Sequence[dict]) -> dict:
    """The full critical-path report over one merged record set (run
    JSONL + any flight dumps) -- the ``--json`` object."""
    traces = build_traces(records)
    return {
        "schema_version": SCHEMA_VERSION,
        "run_id": next(
            (r["run_id"] for r in records if "run_id" in r), None
        ),
        "n_records": len(records),
        "orphan_spans": traces["orphan_spans"],
        "requests": _analyze_requests(traces["requests"], records),
        "steps": _analyze_steps(traces["steps"]),
        "captures": [
            {
                k: c.get(k)
                for k in ("reason", "trace_id", "step", "n_steps",
                          "profile_dir", "flight_path")
            }
            for c in traces["captures"]
        ],
    }


# -- Chrome-trace / Perfetto export -----------------------------------
def chrome_trace(records: Sequence[dict]) -> dict:
    """Chrome trace-event JSON (chrome://tracing, Perfetto's legacy
    importer). Request rows are laid out on the meter clock (each
    request relative to its own arrival); training spans on the
    monotonic clock (``t_mono``), both in microseconds."""
    traces = build_traces(records)
    ev: List[dict] = []
    ev.append({
        "ph": "M", "pid": 1, "name": "process_name",
        "args": {"name": "serve requests (meter-clock ms)"},
    })
    ev.append({
        "ph": "M", "pid": 2, "name": "process_name",
        "args": {"name": "train/tick spans (monotonic clock)"},
    })
    reqs = sorted(
        traces["requests"].values(),
        key=lambda rt: (rt.arrival_ms or 0.0, rt.rid),
    )
    for tid_row, rt in enumerate(reqs, start=1):
        base = (rt.arrival_ms or 0.0) * 1e3  # us
        ev.append({
            "ph": "M", "pid": 1, "tid": tid_row,
            "name": "thread_name", "args": {"name": rt.rid},
        })
        common = {
            "pid": 1, "tid": tid_row,
            "args": {"trace_id": rt.trace_id, "tenant": rt.tenant},
        }
        if rt.shed:
            ev.append({
                "ph": "i", "name": f"shed:{rt.shed}", "ts": base,
                "s": "t", **common,
            })
            continue
        phases = rt.phases()
        t = base
        for name in ("queue", "prefill", "prefill_wait", "decode"):
            dur = phases.get(name)
            if dur is None:
                continue
            ev.append({
                "ph": "X", "name": name, "ts": t, "dur": dur * 1e3,
                **common,
            })
            t += dur * 1e3
    # Training/tick spans on the monotonic axis, normalized to the
    # earliest t_mono seen so the file starts near zero.
    monos = [
        r.get("t_mono") for r in records
        if r.get("event") == "span" and r.get("t_mono") is not None
    ]
    t0 = min(monos) if monos else 0.0
    for r in records:
        if r.get("event") != "span" or not r.get("trace_id"):
            continue
        _, kind, _ = parse_trace_id(r["trace_id"])
        if kind not in (KIND_STEP, KIND_TICK):
            continue
        dur_us = 1e6 * float(r["dur_s"])
        end = r.get("t_mono")
        ts = (end - t0) * 1e6 - dur_us if end is not None else 0.0
        ev.append({
            "ph": "X", "pid": 2, "tid": 1 + int(r.get("depth") or 0),
            "name": r["name"], "ts": max(ts, 0.0), "dur": dur_us,
            "args": {"trace_id": r["trace_id"],
                     "step": r.get("step")},
        })
    for c in traces["captures"]:
        ev.append({
            "ph": "i", "pid": 2, "tid": 1, "s": "g", "ts": 0.0,
            "name": f"capture:{c.get('reason')}",
            "args": {"trace_id": c.get("trace_id"),
                     "flight_path": c.get("flight_path")},
        })
    return {"traceEvents": ev, "displayTimeUnit": "ms"}


def load_chrome_events(source) -> List[dict]:
    """The events of a Chrome trace -- a path to one (what
    ``chrome_trace`` and ``torch.profiler``'s ``export_chrome_trace``
    write), its parsed dict, or a ``torch.profiler.profile`` that has
    run (its events read in place, in the trace's own shape: ``name``,
    ``ts`` in microseconds, ``args`` with an allocation's ``Bytes`` and
    the metadata a backend recorded) -- timed events sorted by start
    (``ts``), metadata rows dropped. The one reader of Chrome traces in
    the package (``checks/collectives.py`` counts collectives and
    allocations from it)."""
    if hasattr(source, "export_chrome_trace"):
        events = []
        for e in source.profiler.kineto_results.events():
            args = {}
            if e.name() == "[memory]":
                args["Bytes"] = e.nbytes()
            meta = e.metadata_json() if hasattr(e, "metadata_json") else ""
            if meta:
                try:
                    args.update(json.loads("{" + meta + "}"))
                except ValueError:
                    pass
            events.append({"name": e.name(), "ts": e.start_ns() / 1e3,
                           "args": args})
        return sorted(events, key=lambda e: e["ts"])
    if isinstance(source, (str, os.PathLike)):
        with open(source) as f:
            source = json.load(f)
    events = source["traceEvents"] if isinstance(source, dict) else source
    timed = [e for e in events if e.get("ph") != "M"]
    return sorted(timed, key=lambda e: float(e.get("ts") or 0.0))


# -- rendering ---------------------------------------------------------
def format_analysis(rep: dict) -> str:
    lines = [
        f"# tpu_hpc trace report -- run_id {rep['run_id'] or '(none)'}"
        f" ({rep['n_records']} records)",
        "",
        f"orphan spans: {rep['orphan_spans']}"
        + (" (complete trace)" if not rep["orphan_spans"] else
           "  <-- propagation gap: spans whose trace no lifecycle "
           "event anchors"),
    ]
    req = rep.get("requests")
    if req:
        lines += [
            "",
            "## Requests -- TTFT critical path",
            "",
            f"{req['complete']}/{req['count']} complete, "
            f"{req['shed']} shed",
            "",
            "| quantile | TTFT (ms) | rid | decomposition | "
            "dominant | attributed |",
            "|---|---|---|---|---|---|",
        ]
        for name, _ in _QUANTILES:
            cp = (req.get("ttft_critical_path") or {}).get(name)
            if cp is None:
                continue
            decomp = " + ".join(
                f"{k} {v:.1f}" for k, v in cp["phases_ms"].items()
            )
            lines.append(
                f"| {name} | {cp['ttft_ms']:.1f} | {cp['rid']} | "
                f"{decomp} | **{cp['dominant']}** "
                f"({cp['shares'].get(cp['dominant'], 0.0):.0%}) | "
                f"{cp['attributed']:.0%} |"
            )
        if "itl_ms" in req:
            itl = req["itl_ms"]
            att = req.get("itl_attribution") or {}
            lines += [
                "",
                "ITL p50/p95/p99: "
                + " / ".join(
                    f"{itl.get(n, 0.0):.1f}" for n, _ in _QUANTILES
                )
                + " ms"
                + (
                    f" -- decode window dominated by "
                    f"**{att['dominant']}**"
                    if att.get("dominant") else ""
                ),
            ]
    steps = rep.get("steps")
    if steps:
        lines += [
            "",
            "## Training steps -- phase critical path",
            "",
            f"{steps['count']} step trace(s), {steps['stalls']} "
            "stall event(s); phase shares: "
            + ", ".join(
                f"{k} {v:.0%}" for k, v in steps["shares"].items()
            ),
            "",
            "| quantile | step wall (ms) | step | dominant |",
            "|---|---|---|---|",
        ]
        for name, _ in _QUANTILES:
            cp = (steps.get("critical_path") or {}).get(name)
            if cp is None:
                continue
            lines.append(
                f"| {name} | {cp['wall_ms']:.1f} | {cp['step']} | "
                f"**{cp['dominant']}** "
                f"({cp['shares'].get(cp['dominant'], 0.0):.0%}) |"
            )
    caps = rep.get("captures") or []
    if caps:
        lines += ["", "## Anomaly captures", ""]
        for c in caps:
            lines.append(
                f"- {c['reason']} (trace {c['trace_id']}): profiler "
                f"-> {c['profile_dir'] or '(unavailable)'}, flight "
                f"-> {c['flight_path'] or '(no flight dir)'}"
            )
    return "\n".join(lines) + "\n"


def _load_all(
    paths: Sequence[str],
    flight_dir: Optional[str],
    validate: bool,
) -> list:
    files = list(paths)
    if flight_dir:
        files += sorted(
            glob.glob(os.path.join(flight_dir, "flight.*.jsonl*"))
        )
    # Exact-duplicate records are dropped across the merge: the bus
    # writes ONE stamped record to both the sink and the flight ring,
    # so any dump taken during a sinked run overlaps the run log --
    # loading both copies would double every span duration and skew
    # every quantile. Two distinct emissions are never identical
    # (each carries its own wall-clock stamp), so full-record
    # equality is the correct identity.
    records: list = []
    seen = set()
    for p in files:
        for rec in load_records(p, validate=validate):
            key = json.dumps(rec, sort_keys=True)
            if key not in seen:
                seen.add(key)
                records.append(rec)
    return records


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="tpu_hpc_torch.obs.trace",
        description=__doc__.split("\n")[0],
    )
    ap.add_argument(
        "paths", nargs="+",
        help="run JSONL file(s) (run log, serve/loadgen trace, "
        "flight dumps) -- merged by trace_id",
    )
    ap.add_argument(
        "--flight-dir", default=None,
        help="also merge every flight.*.jsonl dump in this directory",
    )
    ap.add_argument("--json", action="store_true",
                    help="emit the analysis as one JSON object")
    ap.add_argument(
        "--chrome", default=None, metavar="PATH",
        help="write a Chrome-trace/Perfetto JSON timeline to PATH",
    )
    ap.add_argument(
        "--no-validate", action="store_true",
        help="skip schema validation (salvage partially-corrupt logs)",
    )
    args = ap.parse_args(argv)
    try:
        records = _load_all(
            args.paths, args.flight_dir, validate=not args.no_validate
        )
    except OSError as e:
        print(f"tpu_hpc_torch.obs.trace: {e}", file=sys.stderr)
        return 2
    except SchemaError as e:
        print(
            f"tpu_hpc_torch.obs.trace: schema error: {e}", file=sys.stderr
        )
        return 2
    if not records:
        print(
            "tpu_hpc_torch.obs.trace: no records in "
            + ", ".join(args.paths),
            file=sys.stderr,
        )
        return 2
    rep = analyze(records)
    if args.chrome:
        parent = os.path.dirname(args.chrome)
        if parent:
            os.makedirs(parent, exist_ok=True)
        with open(args.chrome, "w") as f:
            json.dump(chrome_trace(records), f)
    if args.json:
        print(json.dumps(rep))
    else:
        print(format_analysis(rep), end="")
    return 0


if __name__ == "__main__":
    sys.exit(main())
