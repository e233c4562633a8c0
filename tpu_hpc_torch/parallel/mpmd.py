"""MPMD pipeline runtime with per-stage fault domains.

Port of the JAX package's ``parallel/mpmd.py``. The SPMD pipeline
(``parallel/pp.py``) walks one schedule table in lockstep: one hung
host, one poisoned stage or one preempted slice takes the whole
pipeline down, and recovery means a process restart plus a full-state
restore. This runtime gives each stage a program set and a fault domain
of its own (arXiv 2412.14374; the containment argument of arXiv
2510.20171):

* **Per-stage programs.** Each :class:`StageWorker` owns a device, its
  stage's resident weights, and a table of programs (forward, backward,
  optimizer update, and the embed/head edge programs on the first/last
  stage). A program is an eager callable that :meth:`StageWorker._build`
  makes once per key and counts in ``compile_count``; after
  :meth:`StageWorker.warmup` the count must never move (the
  zero-rebuild pin). Fault injection is *data*: the forward takes a
  resident poison scalar, so a chaos run and a clean run call the same
  callables. The flash kernels run inside the stage function
  (``attn_fn``), as in the SPMD pipeline.
* **Backward recomputes the forward.** ``fwd`` runs under
  ``torch.no_grad()`` and keeps no graph; ``bwd`` re-runs the stage from
  its saved input on detached leaves and takes ``torch.autograd.grad``
  -- the JAX ``jax.vjp`` program, op for op. Accumulators add out of
  place, the backward in reverse microbatch order (the SPMD engine's
  accumulation order).
* **Bounded hops.** Activations and cotangents cross stage boundaries
  one microbatch at a time (``Tensor.to`` the next stage's device); every
  hop's bytes are counted in ``wire_bytes``, same-device hops included.
* **Per-stage fault domains.** Per-stage heartbeats on a discrete-event
  virtual clock detect a wedged worker (heartbeat timeout), a killed one
  (crash) or a poisoned one (a non-finite activation or gradient caught
  by the step's health flags *before* any update commits it). Recovery
  is stage-local: rebuild *that stage* from its last-good snapshot
  (crc32 content checksums, ``ckpt/integrity.py``, verified on restore),
  replay the in-flight microbatches, and resume. Healthy stages keep
  their programs and resident weights, and the recovered loss stream
  and final params are bit-identical to the no-fault run.
* **Budgets.** :class:`StageSupervisor` gives every stage its own
  restart budget (crash/heartbeat class) and rollback budget
  (guard-poisoned class), apart from the process supervisor's; a
  flapping stage surfaces as :class:`StageBudgetExhausted` carrying the
  exit code the process should die with. The process supervisor exports
  the restart budget as ``TPU_HPC_MAX_STAGE_RESTARTS``.

A step is the recovery unit: updates wait until every microbatch's
forward and backward passed the health check, so a failure anywhere in
a step leaves every healthy stage at its step-start values; the dead
stage restores its step-start snapshot (host copies of params and
momentum, taken at every step boundary) and the step replays.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from tpu_hpc_torch.parallel.pp import _flatten, _tree_map, _unflatten
from tpu_hpc_torch.resilience.faults import FaultPlan, fault_plan_from_env
from tpu_hpc_torch.resilience.guard import GuardPolicy
from tpu_hpc_torch.resilience.heartbeat import Heartbeat
from tpu_hpc_torch.resilience.signals import EXIT_ROLLBACK

ENV_MAX_STAGE_RESTARTS = "TPU_HPC_MAX_STAGE_RESTARTS"

# Virtual-time cost model (the fleet harness's discrete-event idiom):
# deterministic stand-ins for one stage op / one hop / one stage
# restart, in virtual seconds. Bubble fractions, heartbeat ages and
# recovery MTTR are all measured on this clock, so chaos runs replay
# bit-identically and the telemetry never depends on host speed.
OP_COST_S = 1.0
TRANSFER_COST_S = 0.1
RESTART_COST_S = 5.0

# The programs a worker builds, by role.
STAGE_PROGRAMS = ("fwd", "bwd", "update")
FIRST_PROGRAMS = ("embed", "embed_bwd", "update_embed")
LAST_PROGRAMS = ("head", "update_head")


class StageError(RuntimeError):
    """Base for stage-scoped failures; carries the stage id."""

    def __init__(self, stage: int, msg: str):
        super().__init__(msg)
        self.stage = stage


class StageDied(StageError):
    """The stage worker crash-exited (the kill fault / a real crash)."""


class StagePoisoned(StageError):
    """The stage produced non-finite values (SDC / poisoned compute)."""


class StageBudgetExhausted(StageError):
    """A stage blew through its per-stage budget. ``exit_code`` is
    what the hosting process should exit with: ``EXIT_ROLLBACK`` when
    the guard-poisoned (rollback-class) budget ran out -- the process
    supervisor charges its rollback budget, exactly like a whole-run
    guard rollback -- and plain 1 (ordinary failure) when the
    crash/heartbeat (restart-class) budget ran out: a stage that
    keeps dying is an infrastructure problem a relaunch won't fix."""

    def __init__(self, stage: int, kind: str, budget: int):
        super().__init__(
            stage,
            f"stage {stage} exhausted its {kind} budget ({budget}): "
            + (
                "the stage keeps hitting numeric anomalies -- "
                "rollback-class, exit EXIT_ROLLBACK"
                if kind == "rollback"
                else "the stage keeps dying -- restart-class, "
                "ordinary failure exit"
            ),
        )
        self.kind = kind
        self.budget = budget
        self.exit_code = EXIT_ROLLBACK if kind == "rollback" else 1


@dataclasses.dataclass(frozen=True)
class StageBundle:
    """The model, cut for MPMD: per-stage param trees plus the three
    functions the stage programs run. Build one with
    ``models/pipeline_transformer.mpmd_bundle`` or
    ``models/llama_pp.mpmd_bundle``.

    ``stage_fn(stage_params, x) -> y`` must be shape-preserving (the
    pp.py contract). ``embed_fn(embed_params, tokens) -> x`` runs on
    the FIRST stage's worker, ``loss_fn(head_params, y, targets) ->
    scalar`` (a per-microbatch mean, float32) on the LAST stage's
    worker. Param trees are nested dicts of tensors."""

    n_stages: int
    stage_fn: Callable[[Any, Any], Any]
    embed_fn: Callable[[Any, Any], Any]
    loss_fn: Callable[[Any, Any, Any], Any]
    stage_params: Tuple[Any, ...]
    embed_params: Any
    head_params: Any

    def __post_init__(self):
        if self.n_stages < 1:
            raise ValueError(f"n_stages {self.n_stages} must be >= 1")
        if len(self.stage_params) != self.n_stages:
            raise ValueError(
                f"{len(self.stage_params)} stage param trees for "
                f"{self.n_stages} stages"
            )


def _default_stage_restarts() -> int:
    """Per-stage restart budget: the supervisor's exported
    ``TPU_HPC_MAX_STAGE_RESTARTS`` (``--max-stage-restarts``) wins;
    3 otherwise (the --max-restarts default, scoped down)."""
    try:
        return int(os.environ.get(ENV_MAX_STAGE_RESTARTS, "") or 3)
    except ValueError:
        return 3


@dataclasses.dataclass(frozen=True)
class MpmdConfig:
    """Static runtime shape + the per-stage budgets.

    ``n_microbatches``: the pipeline schedule's M (the batch splits
    [B] -> [M, B/M]). ``learning_rate``/``momentum``: the per-stage
    SGD(+momentum) optimizer every worker applies locally.
    ``heartbeat_timeout_s``: virtual-clock staleness after which a
    silent stage is declared dead (must exceed one stage op at the
    worst legal straggle). ``straggler_factor``: a stage whose mean
    op cost exceeds this multiple of its PEERS' median (self
    excluded) is flagged in the bubble telemetry.
    ``max_stage_restarts`` default: ``TPU_HPC_MAX_STAGE_RESTARTS``
    (the supervisor's ``--max-stage-restarts`` export), else 3.
    """

    n_microbatches: int
    learning_rate: float = 1e-2
    momentum: float = 0.9
    heartbeat_timeout_s: float = 4.0
    straggler_factor: float = 3.0
    guard_spike_factor: float = 10.0
    max_stage_restarts: int = dataclasses.field(
        default_factory=_default_stage_restarts
    )
    max_stage_rollbacks: int = 3

    def __post_init__(self):
        if self.n_microbatches < 1:
            raise ValueError(
                f"n_microbatches {self.n_microbatches} must be >= 1"
            )
        if self.heartbeat_timeout_s <= OP_COST_S:
            raise ValueError(
                f"heartbeat_timeout_s {self.heartbeat_timeout_s} must "
                f"exceed one stage op ({OP_COST_S}s on the virtual "
                "clock) or every slow tick reads as death"
            )
        if self.max_stage_restarts < 0:
            raise ValueError(
                f"max_stage_restarts {self.max_stage_restarts} must "
                "be >= 0"
            )
        if self.max_stage_rollbacks < 0:
            raise ValueError(
                f"max_stage_rollbacks {self.max_stage_rollbacks} "
                "must be >= 0"
            )


class StageSupervisor:
    """Per-stage failure accounting: the stage-scoped analogue of the
    process supervisor's EXIT_RESUMABLE / EXIT_ROLLBACK split.

    ``charge(stage, "restart")`` for crash/heartbeat recoveries,
    ``charge(stage, "rollback")`` for guard-poisoned ones; each stage
    draws on its OWN budgets, so stage 2 flapping five times cannot
    consume stage 0's headroom -- nor the process supervisor's
    ``--max-restarts`` (a stage-local recovery never exits the
    process at all). Exhaustion raises :class:`StageBudgetExhausted`
    whose ``exit_code`` tells the hosting process how to die so the
    process supervisor charges the RIGHT whole-run budget."""

    def __init__(self, max_restarts: int, max_rollbacks: int):
        self.max_restarts = max_restarts
        self.max_rollbacks = max_rollbacks
        self.restarts: Dict[int, int] = {}
        self.rollbacks: Dict[int, int] = {}

    def charge(self, stage: int, kind: str) -> int:
        if kind not in ("restart", "rollback"):
            raise ValueError(f"unknown charge kind {kind!r}")
        book = self.restarts if kind == "restart" else self.rollbacks
        budget = (
            self.max_restarts if kind == "restart"
            else self.max_rollbacks
        )
        used = book.get(stage, 0)
        if used >= budget:
            raise StageBudgetExhausted(stage, kind, budget)
        book[stage] = used + 1
        return book[stage]


class _StageFailure(Exception):
    """Internal control flow: one detected stage failure, carried from
    the dispatch loop to the recovery path."""

    def __init__(
        self, stage: int, reason: str, step: int,
        microbatch: Optional[int] = None,
        beat_age_s: Optional[float] = None,
    ):
        super().__init__(f"stage {stage}: {reason} at step {step}")
        self.stage = stage
        self.reason = reason  # crash | heartbeat-timeout | guard-poisoned
        self.step = step
        self.microbatch = microbatch
        self.beat_age_s = beat_age_s


def _copy_tree(tree: Any, device: Any) -> Any:
    """A fresh copy of a tensor tree on ``device``: never an alias of
    the caller's tensors (``Tensor.to`` alone returns the same tensor
    when it already lives there)."""
    return _tree_map(
        lambda t: t.detach().to(device, copy=True), tree
    )


def _host_copy(tree: Any) -> Any:
    return _copy_tree(tree, "cpu")


def _zeros(tree: Any) -> Any:
    return _tree_map(torch.zeros_like, tree)


def _flat(tree: Any) -> Dict[str, torch.Tensor]:
    """``{"a/b/c": leaf}``: the flat state dict ``ckpt/integrity``
    checksums."""
    paths, leaves = _flatten(tree)
    return {"/".join(p): t for p, t in zip(paths, leaves)}


def _finite(*tensors: torch.Tensor) -> torch.Tensor:
    """int32 1 when every floating leaf is all-finite, else 0 -- on the
    device, fetched only at the step's health check."""
    flags = [torch.isfinite(t).all() for t in tensors
             if t.is_floating_point()]
    return torch.stack(flags).all().to(torch.int32)


def _grad_leaves(leaves: List[torch.Tensor]) -> List[torch.Tensor]:
    return [t.detach().requires_grad_() for t in leaves]


class StageWorker:
    """One stage's fault domain: a device, the stage's resident
    weights + optimizer velocity + gradient accumulator, and the
    program table its dispatches run from.

    Programs are made at :meth:`warmup`; ``compile_count`` increments on
    every build and must stay put in steady state. The forward carries a
    health flag (all-finite over the stage output) and a poison operand
    -- faults are data, so chaos and production runs call the same
    programs. State round-trips through :meth:`snapshot` /
    :meth:`load_state` with crc32 content checksums
    (``ckpt/integrity.py``) computed at snapshot time and verified on
    restore: a mismatch means the stage must not resume from them.
    """

    def __init__(
        self,
        sid: int,
        bundle: StageBundle,
        cfg: MpmdConfig,
        device: Any,
        mb_shape: Tuple[int, ...],
        act_shape: Tuple[int, ...],
        act_dtype: Any,
    ):
        self.sid = sid
        self.bundle = bundle
        self.cfg = cfg
        self.device = device
        self.is_first = sid == 0
        self.is_last = sid == bundle.n_stages - 1
        self.mb_shape = tuple(mb_shape)      # [mb, L] int tokens
        self.act_shape = tuple(act_shape)    # [mb, L, D]
        self.act_dtype = act_dtype
        # Fresh tensors on this stage's device: the caller's tree is
        # never aliased.
        self.params = _copy_tree(bundle.stage_params[sid], device)
        self.velocity = _zeros(self.params)
        self.embed_params = self.embed_vel = None
        self.head_params = self.head_vel = None
        if self.is_first:
            self.embed_params = _copy_tree(bundle.embed_params, device)
            self.embed_vel = _zeros(self.embed_params)
        if self.is_last:
            self.head_params = _copy_tree(bundle.head_params, device)
            self.head_vel = _zeros(self.head_params)
        self._execs: Dict[str, Callable] = {}
        self.compile_count = 0
        # The poison operand's two legal values, resident once: a fresh
        # host-to-device copy per dispatch would be per-op host traffic.
        self._poison = {
            v: torch.tensor(v, dtype=torch.int32, device=device)
            for v in (0, 1)
        }
        # Liveness (virtual clock): ``beat`` is the virtual time of
        # the last completed op; ``dead``/``wedged`` model crash-exit
        # and a silent hang (the heartbeat-timeout detection target).
        self.beat = 0.0
        self.avail = 0.0
        self.busy_s = 0.0
        self.op_count = 0
        self.dead = False
        self.wedged = False
        self.cost_factor = 1.0
        self._saved_x: Dict[int, Any] = {}
        self.grads = None
        self.embed_grads = None
        self.head_grads = None
        self.reset_grads()

    # -- programs -----------------------------------------------------
    def _build(self, key: str) -> Callable:
        """Make one program (counted). Each takes and returns flat leaf
        lists in ``_flatten`` order; accumulators are replaced, never
        written in place."""
        self.compile_count += 1
        stage_fn = self.bundle.stage_fn
        M = self.cfg.n_microbatches
        p_paths = _flatten(self.params)[0]

        if key == "fwd":
            # Poison is DATA: the armed chaos run and the clean run
            # call the identical program.
            @torch.no_grad()
            def fwd(p, x, poison):
                y = stage_fn(_unflatten(p_paths, p), x)
                y = y.masked_fill(poison > 0, float("nan"))
                return y, _finite(y)

            return fwd
        if key == "bwd":
            # The vjp program: re-run the stage from its saved input
            # (no graph is kept from ``fwd``) and pull the cotangent.
            def bwd(p, x, gy, gacc):
                with torch.enable_grad():
                    leaves = _grad_leaves(p)
                    xg = x.detach().requires_grad_()
                    y = stage_fn(_unflatten(p_paths, leaves), xg)
                    *gp, gx = torch.autograd.grad(
                        y, leaves + [xg], gy, materialize_grads=True)
                gacc = [a + g for a, g in zip(gacc, gp)]
                return gacc, gx, _finite(gx, *gacc)

            return bwd
        if key in ("update", "update_embed", "update_head"):
            lr, mu = self.cfg.learning_rate, self.cfg.momentum

            @torch.no_grad()
            def update(p, vel, g):
                vel = [mu * v.to(gg.dtype) + gg for v, gg in zip(vel, g)]
                p = [(pp - lr * v).to(pp.dtype) for pp, v in zip(p, vel)]
                gz = [torch.zeros_like(gg) for gg in g]
                gnorm = torch.sqrt(sum(
                    torch.sum(torch.square(gg.to(torch.float32)))
                    for gg in g
                ))
                return p, vel, gz, gnorm

            return update
        if key == "embed":
            embed_fn = self.bundle.embed_fn
            e_paths = _flatten(self.embed_params)[0]

            @torch.no_grad()
            def embed(ep, toks):
                return embed_fn(_unflatten(e_paths, ep), toks)

            return embed
        if key == "embed_bwd":
            embed_fn = self.bundle.embed_fn
            e_paths = _flatten(self.embed_params)[0]

            def embed_bwd(ep, toks, gx, geacc):
                with torch.enable_grad():
                    leaves = _grad_leaves(ep)
                    x = embed_fn(_unflatten(e_paths, leaves), toks)
                    ge = torch.autograd.grad(x, leaves, gx,
                                             materialize_grads=True)
                return [a + g for a, g in zip(geacc, ge)]

            return embed_bwd
        if key == "head":
            loss_fn = self.bundle.loss_fn
            h_paths = _flatten(self.head_params)[0]
            # Cotangent 1/M bakes "total loss = mean over the M
            # microbatch means" into the seed, matching the SPMD
            # engine's mean-of-per-microbatch-losses gradient.
            seed = torch.tensor(1.0 / M, dtype=torch.float32,
                                device=self.device)

            def head(hp, y, t, ghacc):
                with torch.enable_grad():
                    leaves = _grad_leaves(hp)
                    yg = y.detach().requires_grad_()
                    loss = loss_fn(_unflatten(h_paths, leaves), yg, t)
                    *gh, gy = torch.autograd.grad(
                        loss, leaves + [yg], seed, materialize_grads=True)
                loss = loss.detach()
                ghacc = [a + g for a, g in zip(ghacc, gh)]
                return loss, ghacc, gy, _finite(loss, gy, *ghacc)

            return head
        raise KeyError(f"unknown program {key!r}")

    def _get_exec(self, key: str) -> Callable:
        if key not in self._execs:
            self._execs[key] = self._build(key)
        return self._execs[key]

    def warmup(self) -> int:
        """Build every steady-state program up front; after this,
        ``compile_count`` must never move (the zero-rebuild pin)."""
        keys = list(STAGE_PROGRAMS)
        if self.is_first:
            keys += FIRST_PROGRAMS
        if self.is_last:
            keys += LAST_PROGRAMS
        for k in keys:
            self._get_exec(k)
        return self.compile_count

    # -- state --------------------------------------------------------
    def reset_grads(self) -> None:
        """Zero the gradient accumulators. Called at construction and
        whenever a failed step attempt leaves partial accumulation
        behind."""
        self.grads = _zeros(self.params)
        if self.is_first:
            self.embed_grads = _zeros(self.embed_params)
        if self.is_last:
            self.head_grads = _zeros(self.head_params)
        self._saved_x.clear()

    def _state(self) -> dict:
        state = {"params": self.params, "velocity": self.velocity}
        if self.is_first:
            state["embed_params"] = self.embed_params
            state["embed_vel"] = self.embed_vel
        if self.is_last:
            state["head_params"] = self.head_params
            state["head_vel"] = self.head_vel
        return state

    def snapshot(self, step: int) -> dict:
        """Host-side last-good copy of this stage's state, content-
        checksummed at snapshot time (``ckpt/integrity``): params +
        optimizer velocity + the edge params this stage owns."""
        from tpu_hpc_torch.ckpt.integrity import leaf_checksums

        host = _host_copy(self._state())
        return {
            "step": step,
            "stage": self.sid,
            "state": host,
            "checksums": leaf_checksums(_flat(host)),
        }

    def load_state(self, snap: dict) -> None:
        """Restore from a snapshot, verifying the crc32 checksums
        first -- a corrupted last-good must fail loudly
        (:class:`~tpu_hpc_torch.ckpt.integrity.CkptIntegrityError`),
        never resume silently wrong."""
        from tpu_hpc_torch.ckpt.integrity import (
            CkptIntegrityError,
            verify_tree,
        )

        bad = verify_tree(_flat(snap["state"]), snap["checksums"])
        if bad:
            raise CkptIntegrityError(
                f"stage {self.sid} snapshot (step {snap['step']}) "
                f"failed content verification at {bad}"
            )
        state = _copy_tree(snap["state"], self.device)
        self.params = state["params"]
        self.velocity = state["velocity"]
        if self.is_first:
            self.embed_params = state["embed_params"]
            self.embed_vel = state["embed_vel"]
        if self.is_last:
            self.head_params = state["head_params"]
            self.head_vel = state["head_vel"]
        self.reset_grads()

    # -- virtual-clock bookkeeping ------------------------------------
    def charge(self, ready_s: float, cost_s: float) -> float:
        """One op on this stage's timeline: starts when both the
        dependency and the stage are free, runs for ``cost_s`` x the
        stage's straggle factor; beats the heartbeat on completion.
        Returns the completion time."""
        start = max(self.avail, ready_s)
        dur = cost_s * self.cost_factor
        self.avail = start + dur
        self.busy_s += dur
        self.op_count += 1
        self.beat = self.avail
        return self.avail

    # -- dispatch -----------------------------------------------------
    def forward(self, x: Any, poison: int) -> Tuple[Any, Any]:
        """Dispatch the stage forward; returns (y, health_flag) as
        device tensors (async -- the flag is only fetched at the
        step's health check)."""
        if self.dead:
            raise StageDied(self.sid, f"stage {self.sid} is dead")
        return self._get_exec("fwd")(
            _flatten(self.params)[1], x, self._poison[int(bool(poison))]
        )

    def backward(self, x: Any, gy: Any) -> Tuple[Any, Any]:
        if self.dead:
            raise StageDied(self.sid, f"stage {self.sid} is dead")
        paths, p = _flatten(self.params)
        gacc, gx, ok = self._get_exec("bwd")(
            p, x, gy, _flatten(self.grads)[1]
        )
        self.grads = _unflatten(paths, gacc)
        return gx, ok

    def embed(self, tokens: Any) -> Any:
        return self._get_exec("embed")(
            _flatten(self.embed_params)[1], tokens
        )

    def embed_backward(self, tokens: Any, gx: Any) -> None:
        paths, ep = _flatten(self.embed_params)
        self.embed_grads = _unflatten(paths, self._get_exec("embed_bwd")(
            ep, tokens, gx, _flatten(self.embed_grads)[1]
        ))

    def head_loss(self, y: Any, targets: Any):
        paths, hp = _flatten(self.head_params)
        loss, ghacc, gy, ok = self._get_exec("head")(
            hp, y, targets, _flatten(self.head_grads)[1]
        )
        self.head_grads = _unflatten(paths, ghacc)
        return loss, gy, ok

    def _update(self, key: str, params, vel, grads):
        paths, p = _flatten(params)
        p, v, g, gnorm = self._get_exec(key)(
            p, _flatten(vel)[1], _flatten(grads)[1]
        )
        return (_unflatten(paths, p), _unflatten(paths, v),
                _unflatten(paths, g), gnorm)

    def apply_update(self) -> float:
        """Per-stage optimizer update (SGD + momentum), gradient
        accumulators zeroed in the same program; the edge trees this
        stage owns update through their own warmed programs. Returns
        the stage's global grad norm (the per-stage guard's spike
        signal)."""
        self.params, self.velocity, self.grads, gnorm = self._update(
            "update", self.params, self.velocity, self.grads
        )
        if self.is_first:
            (self.embed_params, self.embed_vel,
             self.embed_grads, _) = self._update(
                "update_embed", self.embed_params, self.embed_vel,
                self.embed_grads,
            )
        if self.is_last:
            (self.head_params, self.head_vel,
             self.head_grads, _) = self._update(
                "update_head", self.head_params, self.head_vel,
                self.head_grads,
            )
        self._saved_x.clear()
        return float(gnorm)


def visible_devices(n: int) -> List[torch.device]:
    """The first ``n`` visible CUDA devices (fewer when fewer exist)."""
    count = torch.cuda.device_count() if torch.cuda.is_available() else 0
    return [torch.device("cuda", i) for i in range(min(n, count))]


class MpmdPipeline:
    """The MPMD pipeline: per-stage workers, per-stage
    dispatch, per-stage fault domains.

    ``devices``: one device per stage (default: the first ``n_stages``
    visible CUDA devices, refusing fewer). An explicit list may name one
    device several times: the stages then share it, each still with its
    own worker, programs and state. ``fault_plan``: the
    ``TPU_HPC_FAULTS`` plan (parsed from the environment when omitted);
    only the ``stage_*`` and slice keys are consumed here -- this
    runtime is the consumer the vacuous-pass guard in the SPMD Trainer
    points at.

    Telemetry rides the obs spine: ``stage_down`` / ``stage_up`` /
    ``stage_redispatch`` / ``stage_remap`` / ``pipeline_bubble`` events
    (plus ``guard_verdict`` with a ``stage`` field on the poisoned path),
    a flight-recorder dump at every stage death, the supervisor heartbeat
    file (``TPU_HPC_HEARTBEAT``) ticked at step boundaries, and per-stage
    health digests under ``$TPU_HPC_DIGEST_DIR``.
    """

    def __init__(
        self,
        bundle: StageBundle,
        cfg: MpmdConfig,
        devices: Optional[Sequence[Any]] = None,
        fault_plan: Optional[FaultPlan] = None,
        events_path: Optional[str] = None,
    ):
        self.bundle = bundle
        self.cfg = cfg
        S = bundle.n_stages
        if devices is None:
            devices = visible_devices(S)
        if len(devices) < S:
            raise ValueError(
                f"{S} stages need {S} devices for disjoint fault "
                f"domains; {len(devices)} visible"
            )
        self.devices = [torch.device(d) for d in devices[:S]]
        self.fault_plan = (
            fault_plan if fault_plan is not None
            else fault_plan_from_env()
        )
        self.events_path = events_path
        self.supervisor = StageSupervisor(
            cfg.max_stage_restarts, cfg.max_stage_rollbacks
        )
        self.heartbeat = Heartbeat.from_env()
        self._mb_shape: Optional[Tuple[int, ...]] = None
        self._act_shape: Optional[Tuple[int, ...]] = None
        self._act_dtype = None
        self.workers: List[StageWorker] = []
        self.snapshots: Dict[int, dict] = {}
        self._guards: Dict[int, GuardPolicy] = {
            s: GuardPolicy(
                mode="skip", spike_factor=cfg.guard_spike_factor,
                spike_action="event",
            )
            for s in range(S)
        }
        self.clock_s = 0.0
        self.wire_bytes = 0
        self.redispatched = 0
        # Home devices: where each stage lives when its slice is
        # healthy. Slice chaos (slice_down_at_step) moves the last
        # stage OFF its home onto a surviving device; slice_up moves
        # it back. self.devices is the live placement.
        self._home_devices = list(self.devices)
        self.remaps: List[dict] = []
        self.recoveries: List[dict] = []
        self.poisoned_windows: List[dict] = []
        self.bubble_fractions: List[float] = []
        self.straggler_flags: Dict[int, int] = {}
        self.losses: List[List[float]] = []
        self._inflight: Dict[int, List[int]] = {}
        # Live telemetry plane (obs/digest.py): per-stage digest
        # publishers, built lazily at the first step close so the
        # env contract is read when the pipeline RUNS, not when it is
        # constructed. None entries = plane unarmed (free).
        self._digest_pubs: Optional[List] = None
        self._digest_state: List[dict] = []

    # -- bring-up ------------------------------------------------------
    def _emit(self, event: str, **fields) -> None:
        from tpu_hpc_torch.obs import get_bus

        get_bus().emit(event, sink=self.events_path, **fields)

    def build(self, sample_tokens: Any) -> "MpmdPipeline":
        """Construct + warm every stage worker against the microbatch
        shapes derived from one sample batch ([B, L] int tokens).
        After this, every worker's ``compile_count`` is pinned."""
        self._validate_stage_faults()
        B = np.shape(sample_tokens)[0]
        M = self.cfg.n_microbatches
        if B % M:
            raise ValueError(
                f"batch {B} not divisible by {M} microbatches"
            )
        mb = B // M
        L = np.shape(sample_tokens)[1]
        self._mb_shape = (mb, L)
        # Run the embed once on the meta device to learn the activation
        # shape/dtype the stage programs carry.
        with torch.no_grad():
            x = self.bundle.embed_fn(
                _tree_map(lambda t: torch.empty_like(t, device="meta"),
                          self.bundle.embed_params),
                torch.zeros((mb, L), dtype=torch.long, device="meta"),
            )
        self._act_shape = tuple(x.shape)
        self._act_dtype = x.dtype
        for s in range(self.bundle.n_stages):
            w = self._new_worker(s)
            w.warmup()
            self.workers.append(w)
        self._arm_straggler()
        for s, w in enumerate(self.workers):
            self.snapshots[s] = w.snapshot(step=0)
        return self

    def _new_worker(self, sid: int) -> StageWorker:
        return StageWorker(
            sid, self.bundle, self.cfg, self.devices[sid],
            self._mb_shape, self._act_shape, self._act_dtype,
        )

    def _validate_stage_faults(self) -> None:
        """Fail FAST (before any worker builds) on a stage fault
        naming a stage that does not exist: it would never fire and
        the chaos test would pass vacuously (the loadgen fleet-fault
        discipline)."""
        plan = self.fault_plan
        if plan is None or not plan.active:
            return
        S = self.bundle.n_stages
        for key in ("stage_kill_at", "stage_nan_at",
                    "stage_straggler"):
            armed = getattr(plan, key)
            if armed is not None and not 0 <= armed[0] < S:
                raise ValueError(
                    f"{key}={armed[0]}:{armed[1]}: the pipeline has "
                    f"{S} stages -- a stage fault naming a stage "
                    "that does not exist would pass vacuously"
                )
        # Slice-scoped chaos (the elastic fault family): the LAST
        # stage's slice goes away and the stage must remap onto a
        # surviving device without burning the restart budget.
        if plan.slice_fault_keys():
            if S < 2:
                raise ValueError(
                    "slice faults need a >=2-stage pipeline -- a "
                    "1-stage run has no surviving stage device to "
                    "remap onto, so the injection would pass "
                    "vacuously"
                )
            down, up = plan.slice_down_at_step, plan.slice_up_at_step
            if up is not None and (down is None or down >= up):
                raise ValueError(
                    f"slice_up_at_step={up} without an earlier "
                    "slice_down_at_step: the stage is still on its "
                    "home device, so the restore would inject "
                    "nothing -- refusing a vacuous chaos schedule"
                )

    def _arm_straggler(self) -> None:
        plan = self.fault_plan
        if plan is None or not plan.active:
            return
        sf = plan.stage_straggler
        if sf is None:
            return
        sid, factor = sf
        self.workers[sid].cost_factor = factor
        plan._announce("stage_straggler", 0, dump=False)

    @property
    def compile_counts(self) -> List[int]:
        return [w.compile_count for w in self.workers]

    # -- fault hooks ---------------------------------------------------
    def _kill_fires(self, sid: int, step: int, m: int) -> bool:
        """The kill fault fires MID-STEP, at the stage's last forward
        dispatch of the armed step: the worker dies holding every one
        of the step's microbatches in flight -- the worst-case
        in-flight replay the recovery path must prove."""
        plan = self.fault_plan
        if plan is None or not plan.active:
            return False
        armed = plan.stage_kill_at
        if armed is None or "stage_kill" in plan._announced:
            return False
        if armed[0] != sid or step < armed[1]:
            return False
        if m != self.cfg.n_microbatches - 1:
            return False
        plan._announce("stage_kill", step, dump=True)
        return True

    def _poison_fires(self, sid: int, step: int) -> bool:
        plan = self.fault_plan
        if plan is None or not plan.active:
            return False
        armed = plan.stage_nan_at
        if armed is None or "stage_nan" in plan._announced:
            return False
        if armed[0] != sid or step < armed[1]:
            return False
        plan._announce("stage_nan", step, dump=False)
        return True

    # -- slice loss: remap, don't restart ------------------------------
    def _maybe_remap_slice(self, step: int) -> None:
        """Consume the slice fault family at a step boundary. Losing
        a stage's slice is a TOPOLOGY event, not a stage failure: the
        stage remaps onto a surviving device and replays nothing (its
        step-boundary snapshot IS the current state), so the stage
        restart budget is untouched -- the supervisor's budgets exist
        for crashes, and a planned slice change is not one."""
        plan = self.fault_plan
        if plan is None or not plan.active:
            return
        sid = self.bundle.n_stages - 1
        down = plan.slice_down_at_step
        if (
            down is not None
            and "slice_down" not in plan._announced
            and step >= down
        ):
            plan._announce("slice_down", step, dump=False)
            self._remap_stage(
                sid, self._home_devices[0], "slice-lost", step
            )
        up = plan.slice_up_at_step
        if (
            up is not None
            and "slice_up" not in plan._announced
            and step >= up
        ):
            plan._announce("slice_up", step, dump=False)
            self._remap_stage(
                sid, self._home_devices[sid], "slice-restored", step
            )

    def _rebuild(self, sid: int) -> StageWorker:
        """A fresh worker for stage ``sid`` on its current device, warm
        and restored from the stage's snapshot (straggle re-armed)."""
        new = self._new_worker(sid)
        new.warmup()
        new.load_state(self.snapshots[sid])
        if self.fault_plan is not None:
            armed = self.fault_plan.stage_straggler
            if armed is not None and armed[0] == sid:
                new.cost_factor = armed[1]
        return new

    def _remap_stage(
        self, sid: int, device: Any, reason: str, step: int
    ) -> None:
        """Rebuild one stage on a DIFFERENT device from its snapshot.
        Same mechanics as _recover's rebuild -- warmup + load_state --
        minus the two things that make recovery a budgeted event:
        no ``supervisor.charge``, no microbatch replay (remaps land
        at step boundaries, where the snapshot is the live state)."""
        from_dev = str(self.devices[sid])
        self.devices[sid] = device
        new = self._rebuild(sid)
        t_down = self.clock_s = max(
            self.clock_s, self.workers[sid].beat
        )
        t_up = t_down + RESTART_COST_S
        new.avail = new.beat = t_up
        self.clock_s = t_up
        self.workers[sid] = new
        self.remaps.append({
            "stage": sid, "reason": reason, "step": step,
            "from_device": from_dev, "to_device": str(device),
        })
        self._emit(
            "stage_remap", stage=sid, reason=reason, step=step,
            from_device=from_dev, to_device=str(device),
            restore_step=self.snapshots[sid]["step"],
        )

    # -- one training step --------------------------------------------
    def run_step(
        self, step: int, tokens: Any, targets: Any,
        apply_update: bool = True,
    ) -> List[float]:
        """One pipeline step over M microbatches: forward chain,
        head loss, backward chain, health check, per-stage updates,
        step-boundary snapshots. Recovers stage-locally on any stage
        failure and replays until the step completes clean; returns
        the per-microbatch loss values."""
        self._maybe_remap_slice(step)
        while True:
            try:
                out = self._attempt_step(
                    step, tokens, targets, apply_update
                )
                break
            except _StageFailure as f:
                self._recover(f)
        if self.heartbeat is not None:
            self.heartbeat.tick(step)
        return out

    def _microbatches(self, tokens: Any, targets: Any):
        M = self.cfg.n_microbatches
        tok, tgt = (
            a.detach().cpu().numpy() if isinstance(a, torch.Tensor)
            else np.asarray(a)
            for a in (tokens, targets)
        )
        mb = tok.shape[0] // M
        if tok.shape[0] % M:
            raise ValueError(
                f"batch {tok.shape[0]} not divisible by {M}"
            )
        return (
            torch.from_numpy(tok.reshape(M, mb, *tok.shape[1:])
                             .astype(np.int64)),
            torch.from_numpy(tgt.reshape(M, mb, *tgt.shape[1:])
                             .astype(np.int64)),
        )

    def _check_alive(
        self, sid: int, step: int, m: Optional[int]
    ) -> None:
        """Heartbeat sweep before dispatching to a stage: a silently
        dead/wedged worker never completes its next op -- the runner
        waits out the virtual heartbeat timeout and declares the
        stage down, naming it."""
        w = self.workers[sid]
        if w.wedged or w.dead:
            # A wedged worker and a silently-dead one look identical
            # from outside: the heartbeat stops. Only stopped beats
            # cross the timeout -- the detection names the stage.
            timeout = self.cfg.heartbeat_timeout_s
            self.clock_s = max(w.beat, self.clock_s) + timeout
            raise _StageFailure(
                sid, "heartbeat-timeout", step,
                microbatch=m, beat_age_s=timeout,
            )

    def _transfer(self, t: torch.Tensor, dst_sid: int) -> torch.Tensor:
        """The bounded hop: one microbatch activation (or cotangent)
        moved to the next stage's device; wire bytes accounted. On the
        same device this is the same tensor (nothing modifies a
        transferred tensor in place)."""
        self.wire_bytes += t.numel() * t.element_size()
        return t.to(self.devices[dst_sid])

    def _attempt_step(
        self, step: int, tokens: Any, targets: Any,
        apply_update: bool,
    ) -> List[float]:
        S = self.bundle.n_stages
        M = self.cfg.n_microbatches
        xs, ts = self._microbatches(tokens, targets)
        step_t0 = self.clock_s
        for w in self.workers:
            w.avail = max(w.avail, step_t0)
            w.busy_s = 0.0
            w.op_count = 0
        # Track what each stage has been handed this attempt: the
        # in-flight set a failure must replay.
        inflight: Dict[int, List[int]] = {s: [] for s in range(S)}
        self._inflight = inflight
        fwd_ok: Dict[Tuple[int, int], Any] = {}
        bwd_ok: Dict[Tuple[int, int], Any] = {}
        head_ok: Dict[int, Any] = {}
        losses: Dict[int, Any] = {}
        acts_out: Dict[int, Any] = {}
        tok_dev: Dict[int, Any] = {}
        tgt_dev: Dict[int, Any] = {}

        # ---- forward: microbatch m through stages 0..S-1 ----
        ready: Dict[int, float] = {}
        for m in range(M):
            tok_m = xs[m].to(self.devices[0])
            tok_dev[m] = tok_m
            w0 = self.workers[0]
            self._check_alive(0, step, m)
            x = w0.embed(tok_m)
            r = w0.charge(step_t0, OP_COST_S * 0.25)
            for s in range(S):
                w = self.workers[s]
                self._check_alive(s, step, m)
                inflight[s].append(m)
                w._saved_x[m] = x
                if self._kill_fires(s, step, m):
                    w.dead = True
                    raise _StageFailure(
                        s, "crash", step, microbatch=m
                    )
                poison = 1 if self._poison_fires(s, step) else 0
                try:
                    y, ok = w.forward(x, poison)
                except StageDied:
                    raise _StageFailure(s, "crash", step, microbatch=m)
                fwd_ok[(s, m)] = ok
                r = w.charge(r, OP_COST_S)
                if s + 1 < S:
                    y = self._transfer(y, s + 1)
                    r += TRANSFER_COST_S
                x = y
            acts_out[m] = x
            ready[m] = r
            tgt_dev[m] = ts[m].to(self.devices[S - 1])

        # ---- head loss + backward: reverse microbatch order (the
        # SPMD engine's accumulation order) ----
        for m in reversed(range(M)):
            wl = self.workers[S - 1]
            self._check_alive(S - 1, step, m)
            loss_m, gy, okh = wl.head_loss(acts_out[m], tgt_dev[m])
            losses[m] = loss_m
            head_ok[m] = okh
            r = wl.charge(ready[m], OP_COST_S * 0.25)
            g = gy
            for s in reversed(range(S)):
                w = self.workers[s]
                self._check_alive(s, step, m)
                try:
                    gx, okb = w.backward(w._saved_x[m], g)
                except StageDied:
                    raise _StageFailure(s, "crash", step, microbatch=m)
                bwd_ok[(s, m)] = okb
                r = w.charge(r, OP_COST_S)
                if s > 0:
                    g = self._transfer(gx, s - 1)
                    r += TRANSFER_COST_S
                else:
                    self.workers[0].embed_backward(tok_dev[m], gx)
                    r = self.workers[0].charge(r, OP_COST_S * 0.25)

        # ---- health check: fetch the flags BEFORE any update
        # commits a poisoned step (the guard contract) ----
        # Origin attribution: NaN propagates downstream, so walk each
        # microbatch's chain in compute order -- the FIRST failing
        # flag names the stage that poisoned it. All flags come to the
        # host in one copy.
        order: List[Tuple[int, int, str]] = []
        for m in range(M):
            order += [(s, m, "forward") for s in range(S)]
            order.append((S - 1, m, "loss"))
            order += [(s, m, "backward") for s in reversed(range(S))]
        flags = {"forward": fwd_ok, "backward": bwd_ok}
        home = self.devices[0]
        fetched = torch.stack([
            (head_ok[m] if phase == "loss" else flags[phase][(s, m)])
            .to(home)
            for s, m, phase in order
        ]).cpu().tolist()
        for (s, m, phase), ok in zip(order, fetched):
            if not ok:
                raise self._poisoned(s, step, m, phase)

        loss_vals = torch.stack(
            [losses[m] for m in range(M)]
        ).cpu().tolist()

        # ---- per-stage optimizer updates + step-boundary snapshots
        if apply_update:
            for s, w in enumerate(self.workers):
                gnorm = w.apply_update()
                w.charge(w.avail, OP_COST_S * 0.1)
                verdict = self._guards[s].classify(step, {
                    "health_loss_finite": 1.0,
                    "health_grad_norm": gnorm,
                    "health_update_norm": gnorm,
                    "health_nonfinite": 0.0,
                })
                if verdict.verdict == "spike":
                    self._emit(
                        "guard_verdict", step=step,
                        verdict="spike", action="event",
                        grad_norm=verdict.grad_norm,
                        watermark=verdict.watermark,
                        ratio=verdict.ratio, stage=s,
                    )
            # Step-boundary snapshots: the state every stage would
            # restore to if step+1 fails -- what makes stage-local
            # recovery consistent without cross-stage coordination.
            for s, w in enumerate(self.workers):
                self.snapshots[s] = w.snapshot(step=step + 1)

        # ---- timeline close: bubble accounting ----
        makespan = max(w.avail for w in self.workers) - step_t0
        busy = sum(w.busy_s for w in self.workers)
        bubble = (
            0.0 if makespan <= 0
            else max(0.0, 1.0 - busy / (S * makespan))
        )
        self.bubble_fractions.append(bubble)
        self.clock_s = step_t0 + makespan
        straggler = self._straggler_verdict()
        self._emit(
            "pipeline_bubble", step=step,
            bubble_fraction=round(bubble, 4),
            makespan_s=round(makespan, 3),
            straggler_stage=straggler,
        )
        self._publish_digests(step, bubble)
        self._inflight = {}
        return loss_vals

    def _publish_digests(self, step: int, bubble: float) -> None:
        """Per-stage health digests onto $TPU_HPC_DIGEST_DIR (opt-in,
        obs/digest.py): the bubble fraction becomes a LIVE fleet-
        rollup number keyed by stage instead of a post-hoc event scan,
        and each stage's per-step busy time is the normalized signal
        the rollup's cross-stage straggler comparison judges on --
        all on the runtime's virtual clock, so replays publish
        bit-identical digests."""
        from tpu_hpc_torch.obs.digest import (
            DigestPublisher,
            LogBucketSketch,
        )

        if self._digest_pubs is None:
            self._digest_pubs = [
                DigestPublisher.from_env(role="stage", key=str(s))
                for s in range(len(self.workers))
            ]
            self._digest_state = [
                {"sketch": LogBucketSketch()} for _ in self.workers
            ]
        for s, (pub, w) in enumerate(
            zip(self._digest_pubs, self.workers)
        ):
            if pub is None:
                continue
            st = self._digest_state[s]
            # busy_s is zeroed at every step start, so it IS this
            # step's busy time.
            busy = w.busy_s
            st["sketch"].add(busy * 1e3)
            pub.publish(
                counters={"steps": float(step + 1)},
                gauges={
                    "bubble_fraction": round(bubble, 4),
                    "busy_s": round(w.busy_s, 6),
                },
                hists={"stage_busy_ms": st["sketch"]},
                t=self.clock_s,
                step_s=busy,
                step=step,
            )

    def _poisoned(
        self, sid: int, step: int, m: int, phase: str
    ) -> _StageFailure:
        self._emit(
            "guard_verdict", step=step, verdict="poisoned",
            action="rollback", stage=sid, data_index=m,
            loss_finite=phase != "loss",
        )
        self.poisoned_windows.append(
            {"stage": sid, "step": step, "microbatch": m,
             "phase": phase}
        )
        return _StageFailure(
            sid, "guard-poisoned", step, microbatch=m
        )

    def _straggler_verdict(self) -> Optional[int]:
        """Cross-stage slow detection: a stage whose mean op cost
        exceeds ``straggler_factor`` x the median of its PEERS' means
        (self excluded -- the fleet lesson) is named."""
        import statistics

        means = [
            w.busy_s / w.op_count if w.op_count else 0.0
            for w in self.workers
        ]
        if len(means) < 3:
            return None
        for s, mine in enumerate(means):
            peers = [v for i, v in enumerate(means) if i != s]
            med = statistics.median(peers)
            if med > 0 and mine > self.cfg.straggler_factor * med:
                self.straggler_flags[s] = (
                    self.straggler_flags.get(s, 0) + 1
                )
                return s
        return None

    # -- recovery ------------------------------------------------------
    def _recover(self, f: _StageFailure) -> None:
        from tpu_hpc_torch.obs import dump_flight

        sid = f.stage
        kind = (
            "rollback" if f.reason == "guard-poisoned" else "restart"
        )
        self.supervisor.charge(sid, kind)
        inflight = list(self._inflight.get(sid, []))
        t_down = self.clock_s = max(
            self.clock_s, self.workers[sid].beat
        )
        self._emit(
            "stage_down", stage=sid, reason=f.reason, step=f.step,
            microbatch=f.microbatch, inflight=len(inflight),
            beat_age_s=f.beat_age_s,
        )
        try:  # flight evidence of WHY, while the ring still has it
            dump_flight(f"stage{sid}_{kind}")
        except Exception:  # pragma: no cover - diagnostics only
            pass
        # Healthy stages: resident params are still the step-start
        # values (updates are deferred past the health check), their
        # programs stay put. Only the failed stage rebuilds.
        new = self._rebuild(sid)
        t_up = t_down + RESTART_COST_S
        new.avail = new.beat = t_up
        self.clock_s = t_up
        self.workers[sid] = new
        mttr = t_up - t_down
        self.recoveries.append({
            "stage": sid, "reason": f.reason, "step": f.step,
            "mttr_s": mttr, "kind": kind,
        })
        self._emit(
            "stage_up", stage=sid, reason=kind,
            restore_step=self.snapshots[sid]["step"],
            mttr_s=round(mttr, 3), compile_count=new.compile_count,
        )
        # Every stage that had work in flight on the dead stage gets
        # it replayed: the step re-executes from its start.
        for m in inflight:
            self.redispatched += 1
            self._emit(
                "stage_redispatch", stage=sid, microbatch=m,
                step=f.step,
            )
        if f.reason == "guard-poisoned":
            self._emit(
                "guard_rollback",
                to_step=self.snapshots[sid]["step"],
                first_bad=f.step, last_bad=f.step,
                data_from=f.microbatch or 0,
                data_to=f.microbatch or 0,
                reason=f"stage {sid} poisoned", stage=sid,
            )
        # Grads on EVERY worker are partial garbage from the aborted
        # attempt: zero them before the replay.
        for w in self.workers:
            w.reset_grads()

    # -- training loop -------------------------------------------------
    def train(
        self, batches: Sequence[Tuple[Any, Any]],
    ) -> dict:
        """Run one step per (tokens, targets) batch; returns the run
        summary (loss stream, bubble fraction, recoveries/MTTR,
        per-stage budgets used, wire bytes, compile counts)."""
        for step, (tokens, targets) in enumerate(batches):
            self.losses.append(self.run_step(step, tokens, targets))
        plan = self.fault_plan
        if plan is not None and plan.active:
            leftover = [
                k for k in ("slice_down", "slice_up")
                if getattr(plan, f"{k}_at_step") is not None
                and k not in plan._announced
            ]
            if leftover:
                raise RuntimeError(
                    f"TPU_HPC_FAULTS armed slice fault(s) "
                    f"{', '.join(leftover)} that never fired -- the "
                    "run ended before their step; refusing to let a "
                    "chaos schedule pass vacuously"
                )
        mttrs = [r["mttr_s"] for r in self.recoveries]
        return {
            "steps": len(self.losses),
            "losses": self.losses,
            "bubble_fraction": (
                float(np.mean(self.bubble_fractions))
                if self.bubble_fractions else 0.0
            ),
            "recoveries": list(self.recoveries),
            "recovery_mttr_s": (
                float(np.mean(mttrs)) if mttrs else 0.0
            ),
            "stage_restarts": dict(self.supervisor.restarts),
            "stage_rollbacks": dict(self.supervisor.rollbacks),
            "redispatched": self.redispatched,
            "stage_remaps": list(self.remaps),
            "poisoned_windows": list(self.poisoned_windows),
            "stragglers": dict(self.straggler_flags),
            "wire_bytes": self.wire_bytes,
            "compile_counts": self.compile_counts,
        }

    def stage_state(self, sid: int) -> dict:
        """Host COPIES of one stage's resident state (tests compare
        final params bit-for-bit across fault/no-fault runs)."""
        w = self.workers[sid]
        out = {
            "params": _host_copy(w.params),
            "velocity": _host_copy(w.velocity),
        }
        if w.is_first:
            out["embed_params"] = _host_copy(w.embed_params)
        if w.is_last:
            out["head_params"] = _host_copy(w.head_params)
        return out

    def loss_and_grads(self, tokens: Any, targets: Any):
        """One forward+backward WITHOUT the optimizer update: the
        parity hook (per-microbatch losses against the SPMD engine,
        grads within float32 accumulation noise). Returns host copies."""
        losses = self._attempt_step(0, tokens, targets, False)
        grads = [_host_copy(w.grads) for w in self.workers]
        edge = {
            "embed": _host_copy(self.workers[0].embed_grads),
            "head": _host_copy(self.workers[-1].head_grads),
        }
        for w in self.workers:
            w.reset_grads()
        return losses, grads, edge


__all__ = [
    "ENV_MAX_STAGE_RESTARTS",
    "MpmdConfig",
    "MpmdPipeline",
    "OP_COST_S",
    "RESTART_COST_S",
    "StageBudgetExhausted",
    "StageBundle",
    "StageDied",
    "StageError",
    "StagePoisoned",
    "StageSupervisor",
    "StageWorker",
    "TRANSFER_COST_S",
    "visible_devices",
]
