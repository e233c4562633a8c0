"""Deterministic fault injection: make failures a test input.

Every resilience mechanism in this package claims to survive a failure
class; none of those claims are testable on CPU unless the failure can
be produced on demand, at an exact step, on an exact attempt. This
module is that switch. It is env-var armed (``TPU_HPC_FAULTS``) so the
injected process needs NO code changes -- the supervisor test launches
the ordinary training entry point with::

    TPU_HPC_FAULTS="kill_at_step=4" \
        python -m tpu_hpc_torch.resilience.supervisor -- \
            python -m tpu_hpc_torch.train --checkpoint-dir D ...

Fault kinds (all step-indexed, fired at the trainer's chunk
boundaries, i.e. at the first progress point where ``step >= N``):

* ``kill_at_step=N``     SIGKILL self -- a hard preemption/OOM kill,
                         no grace, no snapshot.
* ``preempt_at_step=N``  SIGTERM self -- a graceful preemption notice;
                         exercises PreemptionGuard + emergency save.
* ``stall_at_step=N``    sleep ``stall_s`` (default 3600) -- a wedged
                         collective; exercises the hang watchdog.
* ``corrupt_ckpt_at_step=N``  garbage every file of checkpoint step N
                         after it lands -- a torn write; exercises
                         restore fallback to the previous step.
* ``bitflip_ckpt_at_step=N``  flip ONE BIT in one tensor of checkpoint
                         step N, rewritten through
                         torch.distributed.checkpoint so every file
                         stays parseable -- a silent data corruption
                         (SDC) the torn-write fallback cannot see;
                         exercises ckpt.integrity checksum
                         verification + quarantine.
* ``nan_loss_at_step=N`` force the training step's loss AND gradients
                         non-finite when the DATA INDEX equals N (a
                         poisoned batch); exercises the numeric-health
                         guard's skip / rollback-to-last-good paths.
                         Keyed on the data index, not the step, so a
                         rollback that really fast-forwards past the
                         poisoned batch never re-hits it.
* ``grad_spike_at_step=N`` (scale ``grad_spike_scale``, default 1e4)
                         multiply the step's gradients at data index N
                         -- a loss spike; exercises the guard's
                         rolling-median spike detection.
* ``straggler_ms=F``     sleep F ms inside every metered chunk (from
                         ``straggler_at_step``, default 0) -- a
                         degraded host; exercises the stall watermark.

Stage-scoped faults (consumed ONLY by the MPMD pipeline runtime,
``tpu_hpc_torch.parallel.mpmd`` -- the SPMD Trainer hard-rejects them at
construction so a stage fault on a non-MPMD run fails loudly instead
of passing a chaos test vacuously):

* ``stage_kill_at=<stage>:<step>``  kill that stage's worker
                         MID-STEP (at its last forward dispatch of
                         that step, every microbatch in flight) -- a
                         preempted slice / crashed host; exercises
                         per-stage crash detection, stage-local
                         restart, and in-flight microbatch replay.
* ``stage_nan_at=<stage>:<step>``   poison that stage's forward
                         output at that step (one-shot -- a transient
                         SDC on the stage's chips); exercises the
                         per-stage guard path: poisoned verdict,
                         stage-local rollback, recorded window.
* ``stage_straggler=<stage>:<factor>``  multiply that stage's op cost
                         by ``factor`` on the runtime's virtual
                         clock -- a thermally-degraded slice;
                         exercises cross-stage slow detection and the
                         bubble telemetry.

Slice-scoped faults (consumed ONLY by topology-aware runtimes -- the
elastic coordinator, ``tpu_hpc.elastic``, and the MPMD pipeline; a
plain SPMD Trainer hard-rejects them at construction unless it is
running UNDER the coordinator, so a slice fault on a run that cannot
morph fails loudly instead of passing a chaos test vacuously):

* ``slice_down_at_step=N``  a planned slice loss at the first
                         progress point where ``step >= N``: the
                         coordinator quiesces at the step boundary and
                         morphs onto the surviving device set; the
                         MPMD runtime remaps the lost stage onto
                         surviving devices WITHOUT burning its restart
                         budget.
* ``slice_up_at_step=N``    the wave recedes: a slice returns at
                         ``step >= N`` and the run grows back onto the
                         full device set (same quiesce-morph-resume
                         path, in reverse).

``on_attempt`` (default 0) scopes injection to one restart ordinal so
a supervised run fails once and then completes -- the
restart-with-resume round trip, deterministic end to end.
``on_attempt=-1`` arms the fault on EVERY attempt: the guard's
rollback proof uses it so the only way the relaunch survives is by
actually skipping the poisoned data index.
"""
from __future__ import annotations

import dataclasses
import os
import signal
import time
from typing import Optional

from tpu_hpc_torch.resilience.heartbeat import current_attempt

ENV_FAULTS = "TPU_HPC_FAULTS"

_INT_KEYS = (
    "kill_at_step",
    "preempt_at_step",
    "stall_at_step",
    "corrupt_ckpt_at_step",
    "bitflip_ckpt_at_step",
    "nan_loss_at_step",
    "grad_spike_at_step",
    "straggler_at_step",
    "slice_down_at_step",
    "slice_up_at_step",
    "on_attempt",
)

_FLOAT_KEYS = (
    "stall_s",
    "grad_spike_scale",
    "straggler_ms",
)

# Stage-scoped fault keys (MPMD pipeline runtime only): composite
# "<stage>:<value>" specs, parsed with their own typed casts.
STAGE_FAULT_KEYS = (
    "stage_kill_at",
    "stage_nan_at",
    "stage_straggler",
)

# Slice-scoped fault keys: planned topology events only a
# morph-capable runtime (tpu_hpc.elastic coordinator, MPMD pipeline)
# can honor. Plain int steps, so _INT_KEYS carries the casts.
SLICE_FAULT_KEYS = (
    "slice_down_at_step",
    "slice_up_at_step",
)


def _stage_step(v: str) -> "tuple[int, int]":
    sid, sep, at = v.partition(":")
    if not sep:
        raise ValueError(v)
    i, n = int(sid), int(at)
    if i < 0 or n < 0:
        raise ValueError(v)
    return (i, n)


def _stage_factor(v: str) -> "tuple[int, float]":
    sid, sep, factor = v.partition(":")
    if not sep:
        raise ValueError(v)
    i, f = int(sid), float(factor)
    if i < 0 or f <= 0:
        raise ValueError(v)
    return (i, f)


@dataclasses.dataclass(frozen=True)
class FaultPlan:
    """A parsed, armed fault schedule for THIS process."""

    kill_at_step: Optional[int] = None
    preempt_at_step: Optional[int] = None
    stall_at_step: Optional[int] = None
    corrupt_ckpt_at_step: Optional[int] = None
    bitflip_ckpt_at_step: Optional[int] = None
    nan_loss_at_step: Optional[int] = None
    grad_spike_at_step: Optional[int] = None
    grad_spike_scale: float = 1e4
    straggler_ms: float = 0.0
    straggler_at_step: int = 0
    stall_s: float = 3600.0
    # Stage-scoped (MPMD runtime only; the SPMD Trainer rejects armed
    # stage faults at construction -- see stage_fault_keys).
    stage_kill_at: Optional[tuple] = None     # (stage, step)
    stage_nan_at: Optional[tuple] = None      # (stage, step)
    stage_straggler: Optional[tuple] = None   # (stage, factor)
    # Slice-scoped (morph-capable runtimes only -- see
    # slice_fault_keys for the vacuous-pass guard contract).
    slice_down_at_step: Optional[int] = None
    slice_up_at_step: Optional[int] = None
    on_attempt: int = 0
    attempt: int = 0
    # Telemetry one-shot latch (mutable contents are legal on a
    # frozen dataclass): ``step >= N`` keeps re-matching on every
    # later progress point, and a re-fired stall must re-sleep -- but
    # it must NOT re-emit a fault event per chunk, flooding the ring
    # and the report's fault list.
    _announced: set = dataclasses.field(
        default_factory=set, compare=False, repr=False,
    )

    @property
    def active(self) -> bool:
        """Injection is scoped to one restart ordinal: the fault fires
        once, and the relaunched attempt runs clean. ``on_attempt=-1``
        arms every attempt (the rollback proofs need the poison to
        persist across the relaunch)."""
        return self.on_attempt == -1 or self.attempt == self.on_attempt

    def _announce(self, kind: str, step: int, dump: bool) -> None:
        """Record the injection in the telemetry spine: a ``fault``
        event into the bus ring (so post-hoc forensics see the cause
        next to its effects), plus -- for faults the process will not
        survive -- a flight-recorder dump NOW, while there is still a
        process to write it. Best-effort: injection must fire even if
        telemetry is broken (that may be what's under test). One
        event per fault kind, however often the ``step >= N`` match
        re-fires."""
        if kind in self._announced:
            return
        self._announced.add(kind)
        try:
            from tpu_hpc_torch.obs import dump_flight, get_bus

            get_bus().emit("fault", kind=kind, step=step)
            if dump:
                dump_flight(f"fault_{kind}")
        except Exception:  # pragma: no cover - diagnostics only
            pass

    def on_step(self, step: int) -> None:
        """Called from the training loop at each progress point."""
        if not self.active:
            return
        if (
            self.stall_at_step is not None
            and step >= self.stall_at_step
        ):
            # No dump here: the hang watchdog dumps when it fires --
            # that's the mechanism under test.
            self._announce("stall", step, dump=False)
            time.sleep(self.stall_s)
        if (
            self.preempt_at_step is not None
            and step >= self.preempt_at_step
        ):
            # Graceful notice to self: PreemptionGuard's flag is set
            # synchronously (same-process SIGTERM runs the Python
            # handler at the next bytecode boundary). The graceful
            # path dumps at the Trainer's poll point.
            self._announce("preempt", step, dump=False)
            os.kill(os.getpid(), signal.SIGTERM)
        if self.kill_at_step is not None and step >= self.kill_at_step:
            # SIGKILL gives no grace at all -- dump the ring first;
            # this IS the "what was it doing right before it died"
            # artifact a hard preemption otherwise destroys.
            self._announce("kill", step, dump=True)
            os.kill(os.getpid(), signal.SIGKILL)

    def maybe_straggle(self, step: int) -> None:
        """Per-chunk host delay (``straggler_ms``, from
        ``straggler_at_step``): the trainer calls this INSIDE its
        metered window so the injected slowness is visible to the
        stall watermark, exactly like a thermally-throttling host."""
        if (
            not self.active
            or self.straggler_ms <= 0
            or step < self.straggler_at_step
        ):
            return
        self._announce("straggler", step, dump=False)
        time.sleep(self.straggler_ms / 1000.0)

    def numeric_fault_fn(self):
        """A ``(data_index, loss, grads) -> (loss, grads)`` closure
        perturbing the training step, or None when no numeric fault is
        armed. Keyed on the DATA index (``step + skip-window offset``,
        a host int), so a guard rollback that fast-forwards the stream
        past the poisoned batch genuinely never re-hits it -- the
        end-to-end proof that the skip window works.

        ``grads`` is a list of tensors (this rank's shards on a mesh).
        The hit becomes a device scalar made by ``torch.full`` (the
        value rides the fill kernel's arguments: no copy, no host
        sync), and every step issues the same ops hit or not:
        ``torch.where`` against NaN for ``nan_loss_at_step``, a
        multiply by the scale or by exactly 1 for
        ``grad_spike_at_step``. torch is imported inside the closure:
        this module must stay import-cheap for the supervisor (package
        contract)."""
        if not self.active or (
            self.nan_loss_at_step is None
            and self.grad_spike_at_step is None
        ):
            return None
        if self.nan_loss_at_step is not None:
            self._announce("nan_loss", self.nan_loss_at_step, dump=False)
        if self.grad_spike_at_step is not None:
            self._announce(
                "grad_spike", self.grad_spike_at_step, dump=False
            )
        nan_at = self.nan_loss_at_step
        spike_at = self.grad_spike_at_step
        spike_scale = self.grad_spike_scale

        def apply(data_index, loss, grads):
            import torch

            dev = loss.device
            if nan_at is not None:
                bad = torch.full((), data_index == nan_at,
                                 dtype=torch.bool, device=dev)
                nan = torch.full((), float("nan"), device=dev)
                loss = torch.where(bad, nan.to(loss.dtype), loss)
                grads = [torch.where(bad, nan.to(g.dtype), g)
                         for g in grads]
            if spike_at is not None:
                scale = torch.full(
                    (), spike_scale if data_index == spike_at else 1.0,
                    device=dev)
                grads = [g * scale.to(g.dtype) for g in grads]
            return loss, grads

        return apply

    def stage_fault_keys(self) -> "list[str]":
        """The armed stage-scoped fault keys. Consumers that are NOT
        the MPMD pipeline runtime must hard-reject a plan where this
        is non-empty: a stage fault silently injecting nothing makes
        the chaos test pass vacuously (the loadgen fleet-fault
        discipline, applied to training)."""
        return [
            k for k in STAGE_FAULT_KEYS
            if getattr(self, k) is not None
        ]

    def slice_fault_keys(self) -> "list[str]":
        """The armed slice-scoped fault keys. Same vacuous-pass
        contract as :meth:`stage_fault_keys`: a runtime that cannot
        morph its topology (a plain SPMD Trainer outside the elastic
        coordinator) must hard-reject a plan where this is non-empty,
        and a morph-capable runtime must hard-fail a run where an
        armed slice fault never got the chance to fire."""
        return [
            k for k in SLICE_FAULT_KEYS
            if getattr(self, k) is not None
        ]

    def wants_ckpt_corruption(self, step: int) -> bool:
        return self.active and self.corrupt_ckpt_at_step == step

    def wants_ckpt_bitflip(self, step: int) -> bool:
        """Silent-corruption schedule: the actual flip lives in
        ckpt.CheckpointManager (it rewrites the step through
        torch.distributed.checkpoint, parseably); this module only owns
        WHEN."""
        return self.active and self.bitflip_ckpt_at_step == step

    def announce_bitflip(self, step: int) -> None:
        self._announce("bitflip_ckpt", step, dump=False)

    def corrupt_checkpoint(self, step_dir: str) -> int:
        """Garbage every regular file under ``step_dir`` (a torn
        multi-file write); returns the count corrupted."""
        n = 0
        for root, _, files in os.walk(step_dir):
            for name in files:
                corrupt_file(os.path.join(root, name))
                n += 1
        return n


def corrupt_file(path: str) -> None:
    """Deterministically destroy a file's contents in place (replace
    with a short garbage header -- breaks zarr/msgpack/json parsing
    alike)."""
    with open(path, "wb") as f:
        f.write(b"\x00TPU_HPC_FAULT_CORRUPTED\x00")


def parse_kv_spec(spec: str, env_name: str, casts) -> dict:
    """Parse a ``"key=value,key=value"`` fault/config spec with the
    typed-error discipline every injection spec in this repo follows:

    * unknown keys are a hard error naming the key, the FULL spec and
      the known-key set -- a typo'd key silently injecting nothing
      makes a chaos test pass vacuously;
    * malformed values are a hard error naming the key, the spec and
      the expected type -- a bare ``int()`` traceback would point at
      the parser instead of the operator's typo;
    * duplicate keys are last-wins, like the env vars they ride in on.

    ``casts`` maps each known key to ``(cast_fn, expected_kind)``;
    ``cast_fn`` raising ``ValueError`` marks the value malformed (so
    range checks belong inside the cast). Returns ``{key: parsed}``
    for the keys present. The one parse loop shared by
    ``TPU_HPC_FAULTS`` (this module) and ``TPU_HPC_LOADGEN_FAULTS``
    (tpu_hpc/loadgen/harness.py) -- the disciplines must not fork.
    """
    fields: dict = {}
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        key, _, val = part.partition("=")
        key = key.strip()
        if key not in casts:
            raise ValueError(
                f"unknown fault key {key!r} in {env_name}={spec!r} "
                f"(known: {', '.join(sorted(casts))})"
            )
        cast, kind = casts[key]
        try:
            fields[key] = cast(val.strip())
        except ValueError:
            raise ValueError(
                f"invalid value {val.strip()!r} for fault key "
                f"{key!r} in {env_name}={spec!r}: expected {kind}"
            ) from None
    return fields


def fault_plan_from_env(env=None) -> Optional[FaultPlan]:
    """Parse ``TPU_HPC_FAULTS`` ("k=v,k=v"); None when unset (the
    production default -- every injection site is a no-op). The
    unknown-key / malformed-value discipline lives in
    :func:`parse_kv_spec`.
    """
    env = os.environ if env is None else env
    spec = env.get(ENV_FAULTS, "").strip()
    if not spec:
        return None
    casts = {
        **{k: (int, "an integer") for k in _INT_KEYS},
        **{k: (float, "a number") for k in _FLOAT_KEYS},
        "stage_kill_at": (
            _stage_step, "'<stage>:<step>' (non-negative ints)",
        ),
        "stage_nan_at": (
            _stage_step, "'<stage>:<step>' (non-negative ints)",
        ),
        "stage_straggler": (
            _stage_factor,
            "'<stage>:<factor>' (non-negative int : factor > 0)",
        ),
    }
    fields = parse_kv_spec(spec, ENV_FAULTS, casts)
    return FaultPlan(attempt=current_attempt(env), **fields)
