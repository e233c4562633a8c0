"""Single-host run supervisor: bounded restart-with-resume.

Replaces the ad-hoc shell watchdogs every round-5 hardware run was
babysat by (HW_QUEUE_r05/watchdog.log) with one auditable process::

    python -m tpu_hpc_torch.resilience.supervisor \
        --max-restarts 3 --log-dir runs/job1 \
        --heartbeat runs/job1/heartbeat.json --heartbeat-timeout 900 \
        -- python train.py --config cfg.yaml

Contract with the child (any command; the Trainer honors all of it
automatically):

* ``TPU_HPC_ATTEMPT`` -- restart ordinal (0-based). Fault injection
  and log naming key off it.
* ``TPU_HPC_HEARTBEAT`` -- exported when ``--heartbeat`` is given; the
  child ticks it (Trainer does, at every chunk boundary). With
  ``--heartbeat-timeout``, a stale file means the child is wedged in a
  way its own in-process watchdog could not catch (e.g. the whole
  interpreter stuck in C++): the supervisor kills and restarts it.
* Exit 0 ends the run. ``EXIT_RESUMABLE`` (75, a clean preemption
  snapshot) restarts WITHOUT consuming the failure budget -- per the
  signals.py contract it means "nothing is wrong, relaunch me".
  ``EXIT_ROLLBACK`` (77, a numeric-health rollback from
  resilience.guard) also restarts without burning the failure budget,
  but against its own ``--max-rollbacks`` bound -- a run that keeps
  poisoning itself must not relaunch forever. Any other nonzero code
  restarts up to ``--max-restarts`` times; every attempt resumes from
  the newest checkpoint via the Trainer's own auto-resume.

Provenance rules (VERDICT item 9 -- the overwritten OOM dump): every
attempt logs to an ATTEMPT-UNIQUE path (``run.attempt<N>.log``; if a
previous supervision left one there, a numeric suffix is added -- a
failure dump is NEVER overwritten), and every attempt appends a JSON
event (rc, duration, log path, restart reason) to
``supervisor.jsonl``.
"""
from __future__ import annotations

import argparse
import json
import os
import signal
import subprocess
import sys
import time
from typing import IO, List, Optional, Sequence, Tuple

from tpu_hpc_torch.obs.events import ENV_FLIGHT_DIR, ENV_RUN_ID, gen_run_id
from tpu_hpc_torch.obs.schema import stamp
from tpu_hpc_torch.resilience.heartbeat import ENV_ATTEMPT, ENV_HEARTBEAT
from tpu_hpc_torch.resilience.retry import backoff_delays
from tpu_hpc_torch.resilience.signals import (
    EXIT_HANG,
    EXIT_RESUMABLE,
    EXIT_ROLLBACK,
    describe_exit,
)


def unique_attempt_path(log_dir: str, attempt: int) -> str:
    """``run.attempt<N>.log``, suffixed rather than overwritten when a
    previous supervision already left one in this directory."""
    base = os.path.join(log_dir, f"run.attempt{attempt}.log")
    path, k = base, 0
    while os.path.exists(path):
        k += 1
        path = f"{base}.{k}"
    return path


def _wait_rc(code: int) -> int:
    """Normalize Popen returncodes to shell convention (signal n ->
    128 + n) so the supervisor's own exit code is launcher-readable."""
    return 128 - code if code < 0 else code


class Supervisor:
    def __init__(
        self,
        cmd: Sequence[str],
        *,
        max_restarts: int = 3,
        log_dir: Optional[str] = None,
        heartbeat: Optional[str] = None,
        heartbeat_timeout: float = 0.0,
        backoff: float = 1.0,
        no_restart_on: Sequence[int] = (),
        kill_grace_s: float = 10.0,
        poll_s: float = 0.2,
        max_preemptions: int = 100,
        max_rollbacks: int = 8,
        max_stage_restarts: Optional[int] = None,
    ):
        if not cmd:
            raise ValueError("empty command")
        if max_restarts < 0:
            raise ValueError(f"max_restarts {max_restarts} must be >= 0")
        if max_preemptions < 0:
            raise ValueError(
                f"max_preemptions {max_preemptions} must be >= 0"
            )
        if max_rollbacks < 0:
            raise ValueError(
                f"max_rollbacks {max_rollbacks} must be >= 0"
            )
        if max_stage_restarts is not None and max_stage_restarts < 0:
            raise ValueError(
                f"max_stage_restarts {max_stage_restarts} must be "
                ">= 0"
            )
        self.cmd = list(cmd)
        self.max_restarts = max_restarts
        self.log_dir = log_dir
        self.heartbeat = heartbeat
        self.heartbeat_timeout = heartbeat_timeout
        self.backoff = backoff
        self.max_preemptions = max_preemptions
        self.max_rollbacks = max_rollbacks
        self.max_stage_restarts = max_stage_restarts
        self.no_restart_on = set(no_restart_on)
        self.kill_grace_s = kill_grace_s
        self.poll_s = poll_s
        self._child: Optional[subprocess.Popen] = None
        self._stop_requested = False
        # One run identity across every attempt: exported to each
        # child (TPU_HPC_RUN_ID) and stamped on the supervisor's own
        # events, so attempt logs, the run JSONL, and flight dumps all
        # join on it. An operator-set run id is honored.
        self.run_id = os.environ.get(ENV_RUN_ID) or gen_run_id()
        if log_dir:
            os.makedirs(log_dir, exist_ok=True)

    # -- event log ----------------------------------------------------
    def _event(self, **rec) -> None:
        # Schema-stamped like every other telemetry sink
        # (obs/schema.py declares the attempt_* event kinds), so one
        # validator and one report read supervisor.jsonl too.
        rec = stamp(rec, run_id=self.run_id, pid=os.getpid())
        line = json.dumps(rec)
        print(f"supervisor: {line}", file=sys.stderr, flush=True)
        if self.log_dir:
            with open(
                os.path.join(self.log_dir, "supervisor.jsonl"), "a"
            ) as f:
                f.write(line + "\n")

    # -- signal forwarding --------------------------------------------
    def _forward(self, signum, frame):
        """Preemption of the supervisor itself: pass the notice down
        (the child snapshots and exits resumable) and stop
        restarting -- the allocation is going away."""
        self._stop_requested = True
        if self._child is not None and self._child.poll() is None:
            self._child.send_signal(signum)

    # -- heartbeat staleness ------------------------------------------
    def _heartbeat_age(self, attempt_start: float) -> float:
        """Seconds since last observed progress: the heartbeat file's
        mtime, or the attempt start while none exists yet (startup /
        compile time counts against the same budget -- document the
        timeout accordingly)."""
        try:
            return time.time() - os.path.getmtime(self.heartbeat)
        except OSError:
            return time.monotonic() - attempt_start

    def _kill_child(self) -> None:
        assert self._child is not None
        self._child.terminate()
        try:
            self._child.wait(timeout=self.kill_grace_s)
        except subprocess.TimeoutExpired:
            self._child.kill()
            self._child.wait()

    # -- one attempt --------------------------------------------------
    def _run_attempt(self, attempt: int) -> Tuple[int, str, str]:
        """Returns (rc, reason, log_path). ``reason`` is "exit" or
        "heartbeat-stall"."""
        env = dict(os.environ, **{
            ENV_ATTEMPT: str(attempt), ENV_RUN_ID: self.run_id,
        })
        if self.max_stage_restarts is not None:
            # The per-stage budget rides DOWN to the child: an MPMD
            # pipeline run (tpu_hpc_torch.parallel.mpmd) recovers stage
            # failures in-process -- those recoveries never exit, so
            # they can never burn --max-restarts/--max-rollbacks; the
            # exported bound caps how long a flapping stage may keep
            # trying before the child dies with a code the budgets
            # above DO account (StageBudgetExhausted.exit_code).
            env["TPU_HPC_MAX_STAGE_RESTARTS"] = str(
                self.max_stage_restarts
            )
        # Flight-recorder dumps land next to the attempt logs (unless
        # the operator already pointed them elsewhere): the evidence
        # of WHY an attempt died belongs with that attempt's log.
        if self.log_dir and ENV_FLIGHT_DIR not in env:
            env[ENV_FLIGHT_DIR] = self.log_dir
        if self.heartbeat:
            env[ENV_HEARTBEAT] = self.heartbeat
            # Clear the previous attempt's heartbeat: a stale file
            # would read as an instant stall and kill every restarted
            # child within one poll, burning the whole budget on one
            # hang. With the file gone, staleness is measured from
            # this attempt's start.
            try:
                os.remove(self.heartbeat)
            except OSError:
                pass
        log_path, log_f = "", None  # type: str, Optional[IO]
        if self.log_dir:
            log_path = unique_attempt_path(self.log_dir, attempt)
            log_f = open(log_path, "w")
        start = time.monotonic()
        try:
            self._child = subprocess.Popen(
                self.cmd,
                stdout=log_f or None,
                stderr=subprocess.STDOUT if log_f else None,
                env=env,
            )
            reason = "exit"
            while True:
                rc = self._child.poll()
                if rc is not None:
                    break
                if (
                    self.heartbeat_timeout > 0
                    and not self._stop_requested
                    and self._heartbeat_age(start)
                    > self.heartbeat_timeout
                ):
                    self._event(
                        event="heartbeat_stall", attempt=attempt,
                        timeout_s=self.heartbeat_timeout,
                    )
                    self._kill_child()
                    # Policy-wise a supervisor-detected stall IS the
                    # watchdog abort, just caught one layer out.
                    rc, reason = EXIT_HANG, "heartbeat-stall"
                    break
                time.sleep(self.poll_s)
            return _wait_rc(rc), reason, log_path
        finally:
            self._child = None
            if log_f:
                log_f.close()

    # -- the loop -----------------------------------------------------
    def _surface_rollup(self, attempt: int) -> None:
        """Between attempts, surface what the live digest channels say
        (obs/live.py): the fleet scoreboard on stderr next to the
        attempt rows -- which host/stage was the straggler, who went
        silent -- plus one schema-stamped ``digest_stale`` record per
        publisher whose feed stopped, so the restart decision's
        context rides supervisor.jsonl. Diagnostics: every failure is
        swallowed (the dump_flight contract -- surfacing telemetry
        must never turn a restart loop into a new crash)."""
        from tpu_hpc_torch.obs.digest import ENV_DIGEST_DIR

        digest_dir = os.environ.get(ENV_DIGEST_DIR)
        if not digest_dir:
            return
        try:
            from tpu_hpc_torch.obs.live import (
                format_scoreboard,
                rollup_from_dir,
                stale_entries,
            )

            view = rollup_from_dir(digest_dir).build()
            if not view["sources"]:
                return
            for line in format_scoreboard(view).splitlines():
                print(f"supervisor: {line}", file=sys.stderr)
            sys.stderr.flush()
            for e in stale_entries(view):
                self._event(
                    event="digest_stale", attempt=attempt, **e
                )
        except Exception:
            return

    # -- the loop -----------------------------------------------------
    def run(self) -> int:
        old = {}
        for signum in (signal.SIGTERM, signal.SIGINT):
            try:
                old[signum] = signal.signal(signum, self._forward)
            except ValueError:  # non-main thread (tests)
                pass
        # seed=None -> pid-seeded jitter: one supervisor per pod
        # worker must NOT relaunch all ranks in lockstep after a
        # pod-wide fault (the thundering-herd knock the jitter
        # exists to break up).
        delays = backoff_delays(
            self.max_restarts, base_delay=self.backoff,
            max_delay=60.0, jitter=0.25, seed=None,
        )
        try:
            attempt = 0
            failures = 0
            preemptions = 0
            rollbacks = 0
            while True:
                self._event(
                    event="attempt_start", attempt=attempt,
                    cmd=self.cmd,
                )
                t0 = time.monotonic()
                rc, reason, log_path = self._run_attempt(attempt)
                self._event(
                    event="attempt_end", attempt=attempt, rc=rc,
                    meaning=describe_exit(rc), reason=reason,
                    duration_s=round(time.monotonic() - t0, 3),
                    log=log_path,
                )
                self._surface_rollup(attempt)
                if rc == 0:
                    return 0
                if self._stop_requested:
                    # Preemption rode through us: propagate the
                    # child's (resumable) code to the launcher above.
                    return rc
                if rc in self.no_restart_on:
                    self._event(
                        event="giving_up", attempt=attempt, rc=rc,
                        why="exit code marked non-restartable",
                    )
                    return rc
                if rc == EXIT_RESUMABLE:
                    # Clean preemption snapshot: "nothing is wrong,
                    # relaunch me" (signals.py contract) -- restart
                    # WITHOUT burning the failure budget or the
                    # escalating backoff (a spot run preempted
                    # max_restarts+1 times must not be abandoned
                    # while healthy). Separately GENEROUSLY bounded:
                    # a preemption cadence faster than the child's
                    # checkpoint cadence makes zero progress per
                    # attempt, and an unbounded loop would burn the
                    # allocation forever.
                    if preemptions >= self.max_preemptions:
                        self._event(
                            event="giving_up", attempt=attempt, rc=rc,
                            why=f"preemption budget "
                            f"({self.max_preemptions}) exhausted -- "
                            "preemption cadence may be outpacing "
                            "checkpoint cadence",
                        )
                        return rc
                    preemptions += 1
                    self._event(
                        event="restarting", next_attempt=attempt + 1,
                        backoff_s=round(self.backoff, 3),
                        why="resumable preemption snapshot",
                    )
                    time.sleep(self.backoff)
                    if self._stop_requested:
                        return rc
                    attempt += 1
                    continue
                if rc == EXIT_ROLLBACK:
                    # Numeric-health rollback (resilience.guard): the
                    # child quarantined poisoned snapshots, recorded a
                    # skip window, and asked to be relaunched from the
                    # last-good checkpoint. Healthy-process exits, so
                    # they never burn the failure budget -- but they
                    # get their OWN bound, distinct from both the
                    # restart and the preemption budgets: repeated
                    # rollbacks mean the run poisons itself faster
                    # than checkpoints land (bad data shard, diverging
                    # model), and relaunching forever just burns the
                    # allocation re-training the same span.
                    if rollbacks >= self.max_rollbacks:
                        self._event(
                            event="giving_up", attempt=attempt, rc=rc,
                            why=f"rollback budget "
                            f"({self.max_rollbacks}) exhausted -- the "
                            "run keeps hitting numeric anomalies "
                            "faster than it checkpoints past them",
                        )
                        return rc
                    rollbacks += 1
                    self._event(
                        event="restarting", next_attempt=attempt + 1,
                        backoff_s=round(self.backoff, 3),
                        why="guard rollback to last-good snapshot",
                    )
                    time.sleep(self.backoff)
                    if self._stop_requested:
                        return rc
                    attempt += 1
                    continue
                if failures >= self.max_restarts:
                    self._event(
                        event="giving_up", attempt=attempt, rc=rc,
                        why=f"restart budget ({self.max_restarts}) "
                        "exhausted",
                    )
                    return rc
                failures += 1
                delay = next(delays)
                self._event(
                    event="restarting", next_attempt=attempt + 1,
                    backoff_s=round(delay, 3),
                )
                time.sleep(delay)
                if self._stop_requested:
                    # Preemption arrived during the backoff sleep
                    # (no child to forward to): launching another
                    # attempt would strand a snapshot-less child in a
                    # dying allocation.
                    return rc
                attempt += 1
        finally:
            for signum, handler in old.items():
                # signal.signal returns None when the previous handler
                # was installed from C; SIG_DFL is the honest
                # restoration then (same edge PreemptionGuard handles).
                signal.signal(
                    signum,
                    handler if handler is not None else signal.SIG_DFL,
                )


def run_supervised(cmd: Sequence[str], **kwargs) -> int:
    """Library entry point (``python -m tpu_hpc_torch.train
    --supervise`` uses this)."""
    return Supervisor(cmd, **kwargs).run()


def strip_flag(argv: Sequence[str], flag: str) -> List[str]:
    """Remove ``flag N`` / ``flag=N`` from an argv copy -- the shared
    re-exec helper for CLIs that wrap themselves in the supervisor
    (``python -m tpu_hpc_torch.train --supervise``): the supervised
    child must run the program itself, and a surviving flag would
    recurse supervisors forever."""
    out: List[str] = []
    skip = False
    for a in argv:
        if skip:
            skip = False
            continue
        if a == flag:
            skip = True
            continue
        if a.startswith(flag + "="):
            continue
        out.append(a)
    return out


def _split_argv(
    argv: Sequence[str],
) -> Tuple[List[str], List[str]]:
    if "--" not in argv:
        raise SystemExit(
            "usage: python -m tpu_hpc_torch.resilience.supervisor "
            "[options] -- <command> [args...]   (the '--' is required)"
        )
    i = list(argv).index("--")
    return list(argv[:i]), list(argv[i + 1:])


def main(argv: Optional[Sequence[str]] = None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    opts, cmd = _split_argv(argv)
    ap = argparse.ArgumentParser(
        prog="tpu_hpc_torch.resilience.supervisor",
        description="bounded restart-with-resume run supervisor",
    )
    ap.add_argument("--max-restarts", type=int, default=3)
    ap.add_argument(
        "--log-dir", type=str, default=None,
        help="attempt-unique child logs + supervisor.jsonl here "
        "(default: inherit the supervisor's stdio)",
    )
    ap.add_argument(
        "--heartbeat", type=str, default=None,
        help="heartbeat file path exported to the child as "
        f"{ENV_HEARTBEAT}",
    )
    ap.add_argument(
        "--heartbeat-timeout", type=float, default=0.0,
        help="seconds of heartbeat staleness before the child is "
        "killed and restarted (0 = off); must cover startup + one "
        "epoch chunk + one XLA compile",
    )
    ap.add_argument("--backoff", type=float, default=1.0)
    ap.add_argument(
        "--max-preemptions", type=int, default=100,
        help="separate generous bound on EXIT_RESUMABLE (75) "
        "preemption restarts (they never burn --max-restarts); "
        "exhausting it usually means preemptions outpace checkpoints",
    )
    ap.add_argument(
        "--max-rollbacks", type=int, default=8,
        help="separate bound on EXIT_ROLLBACK (77) numeric-health "
        "rollback restarts (resilience.guard; they never burn "
        "--max-restarts); exhausting it means the run keeps "
        "poisoning itself faster than it checkpoints past the bad "
        "spans",
    )
    ap.add_argument(
        "--max-stage-restarts", type=int, default=None,
        help="per-STAGE restart budget exported to the child as "
        "TPU_HPC_MAX_STAGE_RESTARTS (MPMD pipeline runs, "
        "tpu_hpc_torch.parallel.mpmd): stage-local recoveries happen "
        "inside the child and never burn --max-restarts/"
        "--max-rollbacks; this bounds how often any ONE stage may "
        "restart before the child gives up with a budget-accounted "
        "exit (default: the child's own default, 3)",
    )
    ap.add_argument(
        "--no-restart-on", type=str, default="",
        help="comma-separated exit codes that end the run immediately "
        "(e.g. '2' for usage errors)",
    )
    args = ap.parse_args(opts)
    if not cmd:
        ap.error("no command after '--'")
    no_restart = tuple(
        int(c) for c in args.no_restart_on.split(",") if c.strip()
    )
    if args.heartbeat_timeout > 0 and not args.heartbeat:
        ap.error("--heartbeat-timeout requires --heartbeat")
    return run_supervised(
        cmd,
        max_restarts=args.max_restarts,
        log_dir=args.log_dir,
        heartbeat=args.heartbeat,
        heartbeat_timeout=args.heartbeat_timeout,
        backoff=args.backoff,
        no_restart_on=no_restart,
        max_preemptions=args.max_preemptions,
        max_rollbacks=args.max_rollbacks,
        max_stage_restarts=args.max_stage_restarts,
    )


if __name__ == "__main__":
    sys.exit(main())
