"""The structured event bus + flight recorder.

One :class:`EventBus` per process: every record any subsystem emits is
(1) schema-stamped (run_id/host/pid/time, schema.py), (2) appended to a
bounded in-memory ring -- the **flight recorder** -- and (3) written to
a JSONL sink when one is configured (the bus's own ``path`` and/or a
per-emit ``sink``; the same file is never written twice for one
record).

The flight recorder answers the post-hoc forensics question every
crash report starts with: *what was the run doing right before it
died?* The ring holds the last ``ring_size`` events on every host (not
just host 0 -- the host that wedges is rarely the one writing the run
log), and :meth:`EventBus.dump_flight` writes it to disk. The dump is
wired into the three ways a run dies abnormally:

* SIGTERM / preemption notice -- resilience/signals.PreemptionGuard;
* hang-watchdog fire          -- resilience/heartbeat.HangWatchdog;
* injected fault (hard kill)  -- resilience/faults.FaultPlan.

Dumps go to ``TPU_HPC_FLIGHT_DIR`` (the supervisor exports its
``--log-dir`` so flight evidence lands next to the attempt logs) or an
explicitly configured ``flight_dir``; with neither, dumping is a no-op
-- an unconfigured process must not litter its cwd. The Trainer points
the dir at its checkpoint directory, where the hang dumps already go.
Filenames are non-clobbering (``flight.<reason>.pid<N>.jsonl[.k]``):
a restart loop must never overwrite the previous attempt's evidence
(the round-5 overwritten-OOM-log lesson, VERDICT item 9).
"""
from __future__ import annotations

import collections
import json
import os
import re
import socket
import threading
import time
import uuid
from typing import Deque, Iterable, Optional

from tpu_hpc_torch.obs.schema import stamp

ENV_RUN_ID = "TPU_HPC_RUN_ID"
ENV_EVENTS = "TPU_HPC_EVENTS"
ENV_FLIGHT_DIR = "TPU_HPC_FLIGHT_DIR"

DEFAULT_RING_SIZE = 512

# Ambient trace context (obs/trace.py activate()): while a trace is
# active on a thread, every emit on that thread is stamped with its
# trace_id -- so a scheduler that activates a request's context around
# an engine call gets the engine's internal spans and kv_block events
# correlated for free, without threading the id through every layer.
# Lives HERE (not in trace.py) so the per-emit lookup is one
# thread-local getattr with no import indirection on the hot path.
_TRACE = threading.local()


def current_trace_id() -> Optional[str]:
    """The thread's active trace id, or None."""
    return getattr(_TRACE, "trace_id", None)


_hostname: Optional[str] = None


def _host() -> str:
    global _hostname
    if _hostname is None:
        try:
            _hostname = socket.gethostname()
        except OSError:  # pragma: no cover - degenerate environments
            _hostname = "unknown"
    return _hostname


def gen_run_id() -> str:
    """Sortable-by-start-time, collision-safe run identifier."""
    return (
        time.strftime("%Y%m%d-%H%M%S")
        + f"-{os.getpid()}-{uuid.uuid4().hex[:6]}"
    )


class EventBus:
    """Process-local telemetry bus: stamp, ring, sink.

    ``path`` (default ``$TPU_HPC_EVENTS``): JSONL file every emit is
    appended to. ``run_id`` (default ``$TPU_HPC_RUN_ID``, else
    generated): stamped on every record so multi-attempt/multi-host
    artifacts join on it. ``flight_dir`` (default
    ``$TPU_HPC_FLIGHT_DIR``): where :meth:`dump_flight` writes; None
    disables dumping until a caller configures it.
    """

    def __init__(
        self,
        path: Optional[str] = None,
        run_id: Optional[str] = None,
        ring_size: int = DEFAULT_RING_SIZE,
        flight_dir: Optional[str] = None,
    ):
        if ring_size < 1:
            raise ValueError(f"ring_size {ring_size} must be >= 1")
        env = os.environ
        self.path = path if path is not None else env.get(ENV_EVENTS)
        self.run_id = run_id or env.get(ENV_RUN_ID) or gen_run_id()
        self.flight_dir = (
            flight_dir if flight_dir is not None
            else env.get(ENV_FLIGHT_DIR)
        )
        self._ring: Deque[dict] = collections.deque(maxlen=ring_size)
        # Reentrant: dump_flight may run from a signal handler that
        # interrupted the main thread mid-emit (PreemptionGuard's
        # on_trigger hook) -- a plain Lock would self-deadlock there.
        self._lock = threading.RLock()

    # -- emission ------------------------------------------------------
    def emit(self, event: str, sink: Optional[str] = None, **fields) -> dict:
        """Stamp + ring + write one record. ``sink`` is an extra JSONL
        file for this record (the Trainer routes its run log here);
        None-valued fields are dropped so optional context never
        serializes as ``null``."""
        rec = {
            "event": event,
            **{k: v for k, v in fields.items() if v is not None},
        }
        return self.emit_record(rec, sink=sink)

    def emit_record(self, record: dict, sink: Optional[str] = None) -> dict:
        """Emit a pre-built record (must carry ``event``); stamps the
        missing provenance fields without overwriting present ones."""
        rec = stamp(
            record, run_id=self.run_id, host=_host(), pid=os.getpid()
        )
        # Ambient trace stamping: an explicit trace_id always wins; a
        # record emitted while a trace is active on this thread joins
        # it. One thread-local read -- ring-only hot paths stay cheap.
        if "trace_id" not in rec:
            tid = current_trace_id()
            if tid is not None:
                rec["trace_id"] = tid
        with self._lock:
            self._ring.append(rec)
        # File I/O happens OUTSIDE the ring lock: a sink on a hung
        # filesystem must not wedge every other thread's emit (or the
        # watchdog's ring snapshot) behind it. Whole-line O_APPEND
        # writes don't interleave, and every record carries its own
        # timestamp, so relaxed cross-thread file order costs nothing.
        # A set: bus path and per-emit sink may be the same file (the
        # serve replay points both at the run JSONL) -- one record
        # must land once. Serialization is skipped entirely for
        # ring-only emits: hot paths (a span per decode step) pay one
        # deque append, not a json.dumps. Falsy paths are dropped
        # too: "" is the documented "off" spelling
        # (TrainingConfig.metrics_path) and a set-but-empty
        # $TPU_HPC_EVENTS must disable the sink, not crash every emit
        # on open("").
        paths = {self.path, sink} - {None, ""}
        if paths:
            line = json.dumps(rec)
            for p in paths:
                parent = os.path.dirname(p)
                if parent:
                    os.makedirs(parent, exist_ok=True)
                with open(p, "a") as f:
                    f.write(line + "\n")
        return rec

    # -- flight recorder -----------------------------------------------
    def ring(
        self, lock_timeout: Optional[float] = None
    ) -> Iterable[dict]:
        """Snapshot of the in-memory ring, oldest first.

        ``lock_timeout`` bounds the wait for the ring lock, then falls
        back to a lockless best-effort copy -- the hang watchdog's
        dump path must never block behind a thread wedged mid-emit
        (it still has an os._exit to deliver)."""
        if lock_timeout is None:
            acquired = self._lock.acquire()
        else:
            acquired = self._lock.acquire(timeout=lock_timeout)
        if acquired:
            try:
                return list(self._ring)
            finally:
                self._lock.release()
        try:
            return list(self._ring)
        except RuntimeError:  # pragma: no cover - mutated mid-copy
            return []

    def dump_flight(
        self, reason: str, path: Optional[str] = None
    ) -> Optional[str]:
        """Write the ring to disk: a ``flight_dump`` header record
        followed by the buffered events, oldest first. Returns the
        path written, or None when no destination is configured or the
        write fails (dumping is diagnostics -- it must never turn a
        dying run's last act into a new crash)."""
        try:
            if path is None:
                if not self.flight_dir:  # None or "" = disabled
                    return None
                safe = re.sub(r"[^A-Za-z0-9_.-]", "_", reason) or "dump"
                path = os.path.join(
                    self.flight_dir,
                    f"flight.{safe}.pid{os.getpid()}.jsonl",
                )
            base, k = path, 0
            while os.path.exists(path):
                k += 1
                path = f"{base}.{k}"
            parent = os.path.dirname(path)
            if parent:
                os.makedirs(parent, exist_ok=True)
            events = self.ring(lock_timeout=2.0)
            header = stamp(
                {
                    "event": "flight_dump",
                    "reason": reason,
                    "n_events": len(events),
                },
                run_id=self.run_id, host=_host(), pid=os.getpid(),
            )
            with open(path, "w") as f:
                f.write(json.dumps(header) + "\n")
                for rec in events:
                    f.write(json.dumps(rec) + "\n")
            return path
        except OSError:  # pragma: no cover - diagnostics best-effort
            return None


_BUS: Optional[EventBus] = None
# RLock for the same reason as EventBus._lock: a signal handler that
# dumps the ring (PreemptionGuard.flight_reason) re-enters get_bus()
# on the very thread that may already hold this lock mid-emit.
_BUS_LOCK = threading.RLock()


def get_bus() -> EventBus:
    """The process-wide bus, created lazily from the env contract."""
    global _BUS
    with _BUS_LOCK:
        if _BUS is None:
            _BUS = EventBus()
        return _BUS


def set_bus(bus: Optional[EventBus]) -> Optional[EventBus]:
    """Install ``bus`` as the process-wide bus; returns the previous
    one so scoped users (the serve replay, tests) can restore it."""
    global _BUS
    with _BUS_LOCK:
        prev, _BUS = _BUS, bus
        return prev


def dump_flight(reason: str, path: Optional[str] = None) -> Optional[str]:
    """Module-level convenience: dump the current bus's ring. The hook
    the resilience layer calls from signal handlers / watchdog threads
    (hence the blanket best-effort contract of EventBus.dump_flight)."""
    return get_bus().dump_flight(reason, path=path)
