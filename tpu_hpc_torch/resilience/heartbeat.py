"""Step-progress heartbeat + in-process hang watchdog.

The failure mode this covers is the worst one on a shared pod: a
training process that is neither dead nor progressing -- a wedged
collective, a coordinator that never answers, a host read blocked on a
dead filesystem. The allocation burns until the queue kills it, and
the only artifact is an empty log (the round-5 ad-hoc answer was a
shell `tail`-watching watchdog, HW_QUEUE_r05/watchdog.log).

Two cooperating pieces:

* ``Heartbeat`` -- the trainer atomically rewrites a small JSON file
  (step, wall time, pid, attempt) at every chunk boundary. Outside
  observers (the supervisor, an operator's `cat`) read progress
  without touching the process.
* ``HangWatchdog`` -- a daemon thread INSIDE the process. If the hot
  loop stops ticking for ``timeout_s``, it dumps every thread's stack
  (faulthandler) plus a diagnostic header to ``dump_path`` and aborts
  the process with ``EXIT_HANG`` -- turning an invisible hang into a
  restartable, diagnosable failure. ``os._exit`` is deliberate: a
  wedged XLA runtime cannot be trusted to run atexit handlers.

The timeout must exceed the longest legitimate gap between ticks
(one epoch chunk + one XLA compile on this path); the supervisor's
file-based monitor is the coarser outer layer for the cases where the
whole process (watchdog included) is wedged in C++.
"""
from __future__ import annotations

import faulthandler
import json
import os
import sys
import threading
import time
from typing import Callable, Optional

from tpu_hpc_torch.resilience.signals import EXIT_HANG

ENV_HEARTBEAT = "TPU_HPC_HEARTBEAT"
ENV_HANG_TIMEOUT = "TPU_HPC_HANG_TIMEOUT"
ENV_ATTEMPT = "TPU_HPC_ATTEMPT"


def current_attempt(env=None) -> int:
    """This process's restart ordinal (0 = first launch), exported by
    the supervisor; 0 when running unsupervised."""
    env = os.environ if env is None else env
    try:
        return int(env.get(ENV_ATTEMPT, "0") or 0)
    except ValueError:
        return 0


class Heartbeat:
    """Atomic step-progress file: one JSON object, rewritten in place.

    Write is tmp-file + ``os.replace`` so a reader never sees a torn
    record and a crash mid-tick never corrupts the previous one.
    """

    def __init__(self, path: str, attempt: Optional[int] = None):
        self.path = path
        self.attempt = (
            current_attempt() if attempt is None else int(attempt)
        )
        parent = os.path.dirname(path)
        if parent:
            os.makedirs(parent, exist_ok=True)

    @classmethod
    def from_env(cls, env=None) -> Optional["Heartbeat"]:
        """The supervisor's contract: it exports ``TPU_HPC_HEARTBEAT``
        and the trainer ticks it; None when unsupervised."""
        env = os.environ if env is None else env
        path = env.get(ENV_HEARTBEAT)
        return cls(path) if path else None

    def tick(self, step: int, **extra) -> None:
        rec = {
            "step": int(step),
            "time": time.time(),
            "pid": os.getpid(),
            "attempt": self.attempt,
            **extra,
        }
        tmp = f"{self.path}.tmp.{os.getpid()}"
        with open(tmp, "w") as f:
            json.dump(rec, f)
        os.replace(tmp, self.path)

    @staticmethod
    def read(path: str) -> Optional[dict]:
        """Parse a heartbeat file; None if absent or torn (a reader
        must never crash on the file it is monitoring)."""
        try:
            with open(path) as f:
                return json.load(f)
        except (OSError, ValueError):
            return None


class HangWatchdog:
    """Daemon thread that aborts the process when progress stalls.

    ``tick()`` from the hot loop resets the clock. If ``timeout_s``
    elapses without a tick, the watchdog writes a diagnostic dump
    (every Python thread's stack via faulthandler -- the wedged
    collective shows up as the main thread parked in an XLA wait) and
    calls ``on_hang`` -- by default ``os._exit(EXIT_HANG)``.

    The dump path is attempt-qualified and opened with ``"x"``-style
    non-clobbering naming: a restart loop must never overwrite the
    evidence of the previous hang (the round-5 overwritten-OOM-log
    lesson, VERDICT item 9).
    """

    def __init__(
        self,
        timeout_s: float,
        *,
        poll_s: Optional[float] = None,
        dump_path: Optional[str] = None,
        on_hang: Optional[Callable[[float], None]] = None,
        exit_code: int = EXIT_HANG,
    ):
        if timeout_s <= 0:
            raise ValueError(f"timeout_s {timeout_s} must be > 0")
        self.timeout_s = float(timeout_s)
        self.poll_s = (
            min(self.timeout_s / 4, 1.0) if poll_s is None else poll_s
        )
        self.dump_path = dump_path
        self.exit_code = exit_code
        self._on_hang = on_hang
        self._last = time.monotonic()
        self._stop = threading.Event()
        self._fired = threading.Event()
        self._thread: Optional[threading.Thread] = None

    @property
    def fired(self) -> bool:
        return self._fired.is_set()

    def tick(self) -> None:
        self._last = time.monotonic()

    def start(self) -> "HangWatchdog":
        self.tick()
        self._thread = threading.Thread(
            target=self._run, name="tpu-hpc-hang-watchdog", daemon=True
        )
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=self.poll_s * 4)
            self._thread = None

    def _unique_dump_path(self) -> str:
        base = self.dump_path or f"hang.attempt{current_attempt()}.dump"
        path, k = base, 0
        while os.path.exists(path):
            k += 1
            path = f"{base}.{k}"
        return path

    def _dump(self, stalled_s: float) -> Optional[str]:
        try:
            path = self._unique_dump_path()
            parent = os.path.dirname(path)
            if parent:
                os.makedirs(parent, exist_ok=True)
            with open(path, "w") as f:
                f.write(
                    "tpu_hpc hang watchdog: no progress for "
                    f"{stalled_s:.1f}s (timeout {self.timeout_s}s), "
                    f"pid {os.getpid()}, attempt {current_attempt()}; "
                    "all-thread stacks follow\n"
                )
                f.flush()
                faulthandler.dump_traceback(file=f)
            # The stacks say where the process is wedged NOW; the
            # flight-recorder ring says what it was doing on the way
            # there -- dump both. Cross-thread safe: the ring
            # snapshot's lock wait is bounded (EventBus.ring
            # lock_timeout, falling back to a lockless copy), so a
            # main thread wedged mid-emit cannot stop the watchdog
            # from reaching its os._exit.
            try:
                from tpu_hpc_torch.obs import dump_flight

                dump_flight("hang")
            except Exception:  # pragma: no cover - diagnostics only
                pass
            return path
        except OSError:  # pragma: no cover - diagnostics best-effort
            return None

    def _run(self) -> None:
        while not self._stop.wait(self.poll_s):
            stalled = time.monotonic() - self._last
            if stalled < self.timeout_s:
                continue
            self._fired.set()
            path = self._dump(stalled)
            if self._on_hang is not None:
                self._on_hang(stalled)
                return
            print(
                f"tpu_hpc hang watchdog: aborting after {stalled:.1f}s "
                f"without progress (diagnostics: {path})",
                file=sys.stderr, flush=True,
            )
            # A wedged runtime cannot be trusted with a clean
            # interpreter shutdown; exit hard with the contract code.
            os._exit(self.exit_code)
