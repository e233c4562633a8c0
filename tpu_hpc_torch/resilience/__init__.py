"""Resilience: preemption-safe, self-healing training runs.

Port of the JAX package's ``tpu_hpc.resilience``. Every module but
``faults.py`` is a copy (they are stdlib-only); ``faults.py`` perturbs
the torch training step instead of a jitted one:

  signals.py    SIGTERM/preemption-notice guard: final synchronous
                checkpoint + clean exit with a distinct resumable code
  heartbeat.py  step-progress heartbeat file + in-process hang
                watchdog (a stalled collective aborts with diagnostics
                instead of hanging the allocation)
  retry.py      bounded retry/backoff with deterministic jitter, used
                for checkpoint restore
  supervisor.py bounded restart-with-resume process supervisor
                (``python -m tpu_hpc_torch.resilience.supervisor --
                <cmd>``); attempt-unique log paths, failure dumps are
                never overwritten
  faults.py     deterministic fault injection (kill-at-step,
                preempt-at-step, stall, corrupt/bitflip-ckpt-write,
                nan-loss, grad-spike, straggler delay) so all of the
                above is testable on CPU
  guard.py      numeric-health guard: per-step health vector
                classification (healthy/spike/poisoned) with
                skip-batch and rollback-to-last-good actions, plus
                the persisted skip windows that fast-forward the data
                stream past poisoned batches

Everything here is import-cheap: the supervisor must start (and
restart a dead run) without importing torch (faults.py's torch closure
imports it lazily).
"""
from tpu_hpc_torch.resilience.faults import FaultPlan, fault_plan_from_env  # noqa: F401
from tpu_hpc_torch.resilience.guard import (  # noqa: F401
    GuardError,
    GuardPolicy,
    StepVerdict,
)
from tpu_hpc_torch.resilience.heartbeat import HangWatchdog, Heartbeat  # noqa: F401
from tpu_hpc_torch.resilience.retry import backoff_delays, retry_call  # noqa: F401
from tpu_hpc_torch.resilience.signals import (  # noqa: F401
    EXIT_HANG,
    EXIT_RESUMABLE,
    EXIT_ROLLBACK,
    PreemptionGuard,
    exit_code_for,
)
