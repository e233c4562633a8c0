"""Preemption-notice handling and the run exit-code contract.

TPU-VM spot/maintenance events deliver SIGTERM with a short grace
window (the reference's analogue is PBS resubmission, multinode_ddp_
basic.py:144-155 -- but there the *queue script* owns recovery). The
contract here:

* ``PreemptionGuard`` installs an async-signal-safe flag handler; the
  training loop polls ``guard.triggered`` at chunk boundaries,
  requests one final SYNCHRONOUS checkpoint, and exits cleanly.
* The process then exits with ``EXIT_RESUMABLE`` (75, the sysexits
  EX_TEMPFAIL convention): "nothing is wrong, relaunch me and I will
  resume". The supervisor (supervisor.py) restarts on it without
  treating the run as failing.
* ``EXIT_HANG`` (76) is the hang watchdog's abort code (heartbeat.py):
  the run was killed because it stopped making progress -- restart,
  but count it against the failure budget and keep the diagnostics.

Anything else nonzero is an ordinary crash. Exit codes are the ONLY
channel a dead process has, which is why they are pinned constants
here rather than conventions scattered through launch scripts.

Next to the exit-code contract lives the MORPH channel
(``MorphChannel``): planned topology events -- "slice N goes away in
90 s", "a slice came back" -- are requests to a LIVE process, not
death notices, so they ride a file-based request/ack log instead of a
signal. The JAX package's elastic coordinator drains it, quiesces
at a step boundary, and morphs in place; a completed morph burns zero
supervisor budget because no process ever exited.
"""
from __future__ import annotations

import dataclasses
import json
import os
import signal
import sys
import threading
from typing import Iterable, List, Optional, Tuple

# sysexits.h EX_TEMPFAIL: a clean preemption snapshot; relaunch resumes.
EXIT_RESUMABLE = 75
# Hang-watchdog abort: progress stalled; diagnostics were dumped.
EXIT_HANG = 76
# Numeric-health rollback (resilience.guard): poisoned snapshots were
# quarantined and a skip window recorded; the relaunch resumes from the
# last-good checkpoint and fast-forwards the data stream past the
# poisoned batches. Like EXIT_RESUMABLE it means "nothing is wrong
# with the PROCESS, relaunch me" -- but the supervisor counts it
# against a separate rollback budget: an unbounded rollback loop means
# the data (or the model) is poisoned faster than checkpoints land.
EXIT_ROLLBACK = 77

_MEANINGS = {
    0: "success",
    EXIT_RESUMABLE: "resumable (preemption snapshot taken)",
    EXIT_HANG: "hang-watchdog abort (progress stalled)",
    EXIT_ROLLBACK: "guard rollback (resume from last-good snapshot)",
}


def describe_exit(code: int) -> str:
    """Human label for the exit-code contract (supervisor logs)."""
    if code < 0:
        return f"killed by signal {-code}"
    return _MEANINGS.get(code, f"failure (exit {code})")


def exit_code_for(preempted: bool, rolled_back: bool = False) -> int:
    """The code a training entry point should exit with after fit():
    the rollback contract when the numeric-health guard rolled the
    run back (takes precedence -- the supervisor must charge its
    rollback budget, not the free preemption carve-out), the
    resumable contract when the run stopped on a preemption notice,
    plain success otherwise. Usage::

        result = trainer.fit(ds)
        sys.exit(exit_code_for(result.get("preempted", False),
                               result.get("rolled_back", False)))
    """
    if rolled_back:
        return EXIT_ROLLBACK
    return EXIT_RESUMABLE if preempted else 0


def resumable_exit() -> None:
    """Exit now under the resumable contract (snapshot already taken)."""
    sys.exit(EXIT_RESUMABLE)


# Path of the morph request/ack log, exported by whoever schedules
# topology events (supervisor, bench harness) to the process that can
# honor them (the elastic coordinator).
ENV_MORPH_CHANNEL = "TPU_HPC_MORPH_CHANNEL"

# Exported by the elastic coordinator to the Trainers it manages:
# "slice faults are MY job -- your vacuous-pass guard may stand down".
# A Trainer constructed outside the coordinator still hard-rejects an
# armed slice fault (faults.FaultPlan.slice_fault_keys contract).
ENV_ELASTIC_MANAGED = "TPU_HPC_ELASTIC_MANAGED"


@dataclasses.dataclass(frozen=True)
class MorphRequest:
    """One planned topology event on the morph channel.

    ``kind``      "shrink" (a slice is being reclaimed) or "grow" (a
                  slice came back).
    ``n_devices`` the TARGET device count after the event -- the
                  scheduler knows the allocation, the run does not.
    ``step``      earliest step the transition may happen at (the
                  coordinator quiesces at the first chunk boundary
                  with ``step >= this``); 0 means "as soon as legal".
    ``seq``       position in the channel file, assigned by post();
                  acks join on it.
    """

    kind: str
    n_devices: int
    step: int = 0
    seq: int = -1


class MorphChannel:
    """File-based request/ack log for planned topology events.

    Append-only JSONL: requests are ``{"kind", "n_devices", "step"}``
    rows, acks are ``{"ack": seq, ...}`` rows. Appends are O_APPEND
    single-write atomic (same discipline as the heartbeat/supervisor
    logs), so a scheduler posting while the coordinator drains never
    tears a row. The file IS the audit trail: after the run, every
    requested wave and every completed morph is one grep away.
    """

    def __init__(self, path: str):
        self.path = path

    @classmethod
    def from_env(cls, env=None) -> Optional["MorphChannel"]:
        env = os.environ if env is None else env
        path = env.get(ENV_MORPH_CHANNEL, "").strip()
        return cls(path) if path else None

    def _rows(self) -> List[dict]:
        try:
            with open(self.path) as f:
                return [
                    json.loads(line)
                    for line in f if line.strip()
                ]
        except FileNotFoundError:
            return []

    def _append(self, row: dict) -> None:
        d = os.path.dirname(self.path)
        if d:
            os.makedirs(d, exist_ok=True)
        with open(self.path, "a") as f:
            f.write(json.dumps(row) + "\n")

    def post(self, kind: str, n_devices: int, step: int = 0) -> int:
        """Schedule a topology event; returns its seq."""
        if kind not in ("shrink", "grow"):
            raise ValueError(
                f"morph kind {kind!r} must be 'shrink' or 'grow'"
            )
        if n_devices < 1:
            raise ValueError(
                f"morph n_devices {n_devices} must be >= 1"
            )
        seq = sum(1 for r in self._rows() if "kind" in r)
        self._append(
            {"kind": kind, "n_devices": int(n_devices),
             "step": int(step), "seq": seq}
        )
        return seq

    def pending(self) -> List[MorphRequest]:
        """Requests not yet acked, in post order."""
        reqs, acked = [], set()
        seq = 0
        for row in self._rows():
            if "ack" in row:
                acked.add(int(row["ack"]))
            elif "kind" in row:
                reqs.append(MorphRequest(
                    kind=row["kind"],
                    n_devices=int(row["n_devices"]),
                    step=int(row.get("step", 0)),
                    seq=seq,
                ))
                seq += 1
        return [r for r in reqs if r.seq not in acked]

    def ack(self, seq: int, **info) -> None:
        """Mark request ``seq`` completed; ``info`` (wire bytes, stall
        seconds, target mesh) rides along for the audit trail."""
        self._append({"ack": int(seq), **info})

    def acked(self) -> List[dict]:
        """The ack rows, in append order (supervisor accounting)."""
        return [r for r in self._rows() if "ack" in r]


class PreemptionGuard:
    """Flag-only signal handler for preemption notices.

    The handler does nothing but set a flag (async-signal-safe: no
    I/O, no locks, no jax) -- the training loop polls ``triggered`` at
    its own safe points. Install/restore are explicit so the guard can
    bracket exactly one fit() and always hand the previous disposition
    back (a dataset/OOM exception mid-loop must not leave the no-op
    flag handler installed for the life of the process).

    Non-main threads cannot install signal handlers; there ``install``
    is a no-op and the guard simply never triggers, matching the old
    inline behavior in Trainer.fit.

    ``flight_reason``: when set, the FIRST notice also dumps the obs
    flight-recorder ring under that reason (best-effort, from the
    handler -- safe because the bus ring lock is reentrant). The
    Trainer leaves this unset and dumps at its own poll point instead;
    the hook exists for embedders whose loop has no safe poll point a
    short grace window is guaranteed to reach.
    """

    def __init__(
        self,
        signums: Iterable[int] = (signal.SIGTERM,),
        flight_reason: Optional[str] = None,
    ):
        self.signums: Tuple[int, ...] = tuple(signums)
        self.flight_reason = flight_reason
        self._event = threading.Event()
        self._old: dict = {}

    @property
    def triggered(self) -> bool:
        return self._event.is_set()

    @property
    def installed(self) -> bool:
        return bool(self._old)

    def _handler(self, signum, frame):
        first = not self._event.is_set()
        self._event.set()
        if first and self.flight_reason is not None:
            try:
                from tpu_hpc_torch.obs import dump_flight

                dump_flight(self.flight_reason)
            except Exception:  # pragma: no cover - diagnostics only
                pass

    def install(self) -> "PreemptionGuard":
        for signum in self.signums:
            try:
                self._old[signum] = signal.signal(signum, self._handler)
            except ValueError:
                # Non-main thread: skip, keep training unguarded.
                pass
        return self

    def restore(self) -> None:
        """Put back the previous dispositions. ``signal.signal``
        returns None when the previous handler was installed from C;
        SIG_DFL is the honest restoration then."""
        for signum, old in self._old.items():
            signal.signal(
                signum, old if old is not None else signal.SIG_DFL
            )
        self._old.clear()

    def __enter__(self) -> "PreemptionGuard":
        return self.install()

    def __exit__(self, *exc) -> Optional[bool]:
        self.restore()
        return None
