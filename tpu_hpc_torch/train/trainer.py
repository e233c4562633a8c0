"""The Trainer: forward, backward and optimizer update, on one device
or over a (data, model) mesh.

Port of the JAX package's ``train/trainer.py``: ``TrainState``, ``make_lr_schedule``,
``make_optimizer`` / ``make_adamw`` (optax's AdamW and SGD written out
by hand over the param dict), ``make_step_fn`` (gradient accumulation
as the mean of microbatch gradients and losses, the ``grad_norm``
metric) and ``Trainer`` with ``train_step``, ``fit`` and ``evaluate``.

The numerics are optax's, and they differ from ``torch.optim`` in
three places (ROADMAP queue 3): weight decay applies to every leaf,
norm scales and the embedding included (optax's mask is None); update
*n* (counting from 0) uses ``schedule(n)``, so a linear warmup gives lr
0 on the first update; the global-norm clip scales by max_norm / norm
with no epsilon. ``adam_moments_dtype="bfloat16"`` stores both moments
in bf16 (the JAX ``mu_dtype`` plus ``_cast_nu``) while the update math
runs in fp32.

PyTorch runs eagerly, so there is no compiled step or scanned epoch:
``fit`` calls ``train_step`` per update, generates each batch on the
host (``dataset.batch_at``) and moves it to the device, and fetches the
chunk's metrics from the device once per epoch, as the JAX loop does
once per chunk. Params are updated in place (no copy of the state per
step). Float32 matrix products run in full fp32:
``torch.backends.cuda.matmul.allow_tf32`` and
``torch.backends.cudnn.allow_tf32`` are set False when this module is
imported, as the JAX package's fp32 reference numerics need.

On a ``DeviceMesh`` the params are laid out by a plan
(``parallel.shard.shard_params``: TP DTensors on ``model``, FSDP2 over
``data``, or over data x context; stage-sharded DTensors on ``pipe``,
where the pipelined forward splits the batch itself and the trainer
hands every rank all of it, ``batch_pspec=P()``), each data rank takes its rows of the
global batch (each context rank its columns of them), and the optimizer
runs on each rank's shards -- the same optax arithmetic, with the clip
norm taken over the whole gradient.

The self-defending loop of the JAX Trainer: a checkpoint manager
(``ckpt.CheckpointManager``) with auto-resume and periodic saves, the
numeric-health guard (``guard_mode`` skip or rollback, the health
vector on the chunk's one host fetch, persisted skip windows),
``PreemptionGuard`` with an emergency snapshot, the hang watchdog, the
heartbeat, the stall watermark and fault plans from
``$TPU_HPC_FAULTS``; stage and slice faults are refused as the JAX
Trainer refuses them. ``profile`` opens one ``torch.profiler`` window
over the configured steps (``profiling.TrainingProfiler``, a Chrome
trace under ``profile_dir``); ``capture_on_anomaly`` arms an
``obs.AnomalyCapture`` under ``<checkpoint_dir or profile_dir>/anomaly``
that a stall or a poisoned guard verdict fires: a flight dump, a
device-memory record and a profiler window over the next
``capture_steps`` steps, keyed by the step's trace id.

Gradient sync (``cfg.comm_mode``, the JAX Trainer's resolution): "flat"
leaves it to the plan's own collectives (FSDP2, or none on one device);
"bucketed_overlap" and "hierarchical" are the DDP recipe -- params
replicated on every rank of a data mesh, each rank's gradient reduced
in buckets as the backward produces it (``comm.overlap.GradSync``, once
per update on the last microbatch), the loss averaged in one more
all-reduce; "auto" asks the collective planner
(``comm.planner.plan_trainer_grad_sync``) and logs its decision as a
``comm_plan`` event.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
import os
import time
from typing import Any, Callable, Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch

from tpu_hpc_torch import obs
from tpu_hpc_torch.config import TrainingConfig
from tpu_hpc_torch.models.datasets import step_seed
from tpu_hpc_torch.parallel import dp
from tpu_hpc_torch.parallel.plans import P
from tpu_hpc_torch.parallel.shard import (
    gather_params,
    is_dtensor,
    local,
    shard_params,
)
from tpu_hpc_torch.profiling import TrainingProfiler
from tpu_hpc_torch.resilience import guard as guard_lib
from tpu_hpc_torch.resilience.faults import fault_plan_from_env
from tpu_hpc_torch.resilience.guard import GuardPolicy
from tpu_hpc_torch.resilience.heartbeat import (
    ENV_HANG_TIMEOUT,
    HangWatchdog,
    Heartbeat,
    current_attempt,
)
from tpu_hpc_torch.resilience.signals import (
    ENV_ELASTIC_MANAGED,
    PreemptionGuard,
)
from tpu_hpc_torch.runtime import resolve_device
from tpu_hpc_torch.runtime.mesh import mesh_group
from tpu_hpc_torch.train.metrics import GoodputMeter, ThroughputMeter

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

# forward(params, model_state, batch, step_rng) -> (loss, new_model_state, aux)
ForwardFn = Callable[[Any, Any, Any, torch.Generator],
                     Tuple[torch.Tensor, Any, Dict]]
Schedule = Callable[[int], float]


@dataclasses.dataclass
class TrainState:
    """Carried training state. ``step`` counts optimizer updates (a
    host int: the data stream and the schedule index by it);
    ``model_state`` holds non-trainable collections."""

    step: int
    params: Any
    opt_state: Any
    model_state: Any


# ---------------------------------------------------------------------------
# Param trees: nested dicts of tensors, leaves in sorted key-path order
# (the order jax.tree.leaves gives a dict tree)
# ---------------------------------------------------------------------------

def tree_paths(tree, prefix: Tuple[str, ...] = ()) -> List[Tuple[str, ...]]:
    out = []
    for key in sorted(tree):
        node = tree[key]
        if isinstance(node, dict):
            out.extend(tree_paths(node, prefix + (key,)))
        else:
            out.append(prefix + (key,))
    return out


def tree_leaves(tree) -> List[Any]:
    leaves = []
    for path in tree_paths(tree):
        node = tree
        for key in path:
            node = node[key]
        leaves.append(node)
    return leaves


def tree_map(fn, tree):
    return {
        k: tree_map(fn, v) if isinstance(v, dict) else fn(v)
        for k, v in tree.items()
    }


# ---------------------------------------------------------------------------
# Schedules and optimizers (optax's arithmetic, by hand)
# ---------------------------------------------------------------------------

def _linear(init: float, end: float, steps: int, n: int) -> float:
    """optax.linear_schedule's value at update n."""
    if steps <= 0:
        return init
    frac = 1.0 - min(max(n, 0), steps) / steps
    return (init - end) * frac + end


def make_lr_schedule(cfg: TrainingConfig) -> Schedule:
    """The learning rate as a pure function of the update count ``n``
    (the count before the update, as optax's ``scale_by_schedule``
    reads it), so schedules are grad-accum-agnostic."""
    total = max(cfg.epochs * cfg.steps_per_epoch, 1)
    lr, warm = cfg.learning_rate, cfg.warmup_steps
    if cfg.lr_schedule == "cosine":
        if warm >= total:
            raise ValueError(
                f"warmup_steps {warm} must be < the run length of "
                f"{total} optimizer updates (epochs * steps_per_epoch) "
                "for cosine decay"
            )
        decay = total - warm

        def cosine(n: int) -> float:
            if n < warm:
                return _linear(0.0, lr, warm, n)
            c = min(n - warm, decay)
            return lr * 0.5 * (1.0 + math.cos(math.pi * c / decay))

        return cosine
    if cfg.lr_schedule != "constant":
        raise ValueError(
            f"unknown lr_schedule {cfg.lr_schedule!r}; "
            "expected 'constant' or 'cosine'"
        )
    if warm > 0:
        return lambda n: _linear(0.0, lr, warm, n) if n < warm else lr
    return lambda n: lr


def global_norm(grads: List[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares over every leaf, fp32, on device."""
    return torch.sqrt(sum(torch.sum(g.to(torch.float32) ** 2) for g in grads))


def _copies(t, group=None) -> int:
    """Ranks that hold the same shard of ``t``: the trainer's ranks
    (``group``, default the world) over the number of distinct shards
    (a plain tensor is whole on every rank)."""
    import torch.distributed as dist

    shards = 1
    if is_dtensor(t):
        mesh = t.device_mesh
        for i, p in enumerate(t.placements):
            if p.is_shard():
                shards *= mesh.size(i)
    return dist.get_world_size(group) // shards


def sharded_global_norm(grads: List[torch.Tensor],
                        copies: List[int], group=None) -> torch.Tensor:
    """:func:`global_norm` of the WHOLE gradient when ``grads`` are this
    rank's shards and ``copies[i]`` ranks hold shard i (:func:`_copies`):
    each rank sums its shards' squares, each divided by its number of
    copies, and one all-reduce adds the ranks up -- the same norm on
    every rank, so every rank clips alike."""
    import torch.distributed as dist

    total = sum(torch.sum(g.to(torch.float32) ** 2) / c
                for g, c in zip(grads, copies))
    dist.all_reduce(total, group=group)
    return torch.sqrt(total)


def clip_by_global_norm(grads: List[torch.Tensor], max_norm: float,
                        norm: Optional[torch.Tensor] = None
                        ) -> List[torch.Tensor]:
    """optax.clip_by_global_norm: leaves unchanged when the norm is
    below ``max_norm``, else ``g / norm * max_norm`` -- no epsilon, and
    no host sync (the choice is a ``torch.where`` on the device).
    ``norm`` overrides the norm of ``grads`` (sharded leaves pass the
    whole gradient's)."""
    if norm is None:
        norm = global_norm(grads)
    keep = norm < max_norm
    return [torch.where(keep, g, g / norm.to(g.dtype) * max_norm)
            for g in grads]


class _ScheduleTable:
    """An optimizer's per-update coefficients for updates 0 .. n-1 as
    one fp32 device tensor [n, k], rebuilt (doubling) when a longer one
    is asked for: the guarded update reads its row at the device
    count, so the schedule never needs the count on the host. Each row
    comes from the same host arithmetic the unguarded update runs."""

    def __init__(self, row: Callable[[int], Tuple[float, ...]]):
        self.row, self.table = row, None

    def get(self, n: int, device) -> torch.Tensor:
        t = self.table
        if t is None or t.shape[0] < n or t.device != torch.device(device):
            size = max(n, 2 * (t.shape[0] if t is not None else 8))
            t = torch.tensor([self.row(i) for i in range(size)],
                             dtype=torch.float32).to(device)
            self.table = t
        return t

    def at(self, n: int, count: torch.Tensor) -> torch.Tensor:
        """Row ``count`` (a 0-d device tensor) of the table for ``n``
        updates. ``index_select``, not ``t[count]``: indexing with a 0-d
        integer tensor reads it to the host, a sync per update."""
        return torch.index_select(self.get(n, count.device), 0,
                                  count.view(1))[0]


def _commit(ok, olds, news) -> None:
    """old <- new, or (``ok`` a device bool) old <- where(ok, new, old):
    a skipped update leaves every tensor bit-identical."""
    for old, new in zip(olds, news):
        if ok is None:
            old.copy_(new)
        else:
            old.copy_(torch.where(ok, new.to(old.dtype), old))


@dataclasses.dataclass(frozen=True)
class AdamW:
    """optax.adamw(lr, b1, b2, eps, weight_decay) with decoupled weight
    decay on every leaf, bias correction, and both moments stored in
    ``moments_dtype``; ``max_grad_norm > 0`` clips first (optax.chain's
    order). State: ``count`` (updates applied), ``mu``, ``nu`` (lists
    aligned with :func:`tree_leaves` of the params).

    ``count`` is a host int for :meth:`apply`; :meth:`apply_guarded`
    keeps it as a 0-d device tensor (``init(device=...)``), so a
    skipped update leaves it where it was without a host sync."""

    learning_rate: Schedule
    weight_decay: float
    moments_dtype: torch.dtype = torch.float32
    max_grad_norm: float = 0.0
    _table: _ScheduleTable = dataclasses.field(
        default=None, compare=False, repr=False)
    _decay: Tuple[float, float] = dataclasses.field(
        default=None, compare=False, repr=False)
    b1 = 0.9     # optax.adamw's defaults, the only values the JAX
    b2 = 0.999   # Trainer uses (class constants, not fields)
    eps = 1e-8

    def __post_init__(self):
        object.__setattr__(self, "_table", _ScheduleTable(self.coefficients))
        # apply_guarded reads them here, not per update: _decays reads
        # two scalars to the host.
        object.__setattr__(self, "_decay", self._decays())

    def init(self, params, device=None) -> Dict[str, Any]:
        leaves = tree_leaves(params)
        zeros = lambda p: torch.zeros_like(  # noqa: E731
            p, dtype=self.moments_dtype, requires_grad=False)
        count = 0 if device is None else torch.zeros(
            (), dtype=torch.int64, device=device)
        return {"count": count, "mu": [zeros(p) for p in leaves],
                "nu": [zeros(p) for p in leaves]}

    def coefficients(self, n: int) -> Tuple[float, float, float]:
        """Update n's step size (-schedule(n)) and the two bias
        corrections, as optax computes them (fp32)."""
        count = n + 1
        one = torch.tensor(1.0, dtype=torch.float32)
        bc1 = float(one - torch.tensor(self.b1, dtype=torch.float32) ** count)
        bc2 = float(one - torch.tensor(self.b2, dtype=torch.float32) ** count)
        return -float(self.learning_rate(n)), bc1, bc2

    def _decays(self) -> Tuple[float, float]:
        # optax multiplies the stored moment by its decay with the
        # decay taken in the moment's own dtype (a weak-typed Python
        # scalar takes the array's dtype); under jit, XLA then keeps the
        # product and the sum in fp32. With bf16 moments that makes b1
        # 0.8984375 and b2 exactly 1.0 -- nu never decays. The port keeps
        # the reference's arithmetic (ROADMAP queue 3).
        return (float(torch.tensor(self.b1, dtype=self.moments_dtype)),
                float(torch.tensor(self.b2, dtype=self.moments_dtype)))

    def _moments(self, g, mu, nu, d1, d2):
        g = g.to(torch.float32)
        m = (1 - self.b1) * g + d1 * mu.to(torch.float32)
        v = (1 - self.b2) * (g * g) + d2 * nu.to(torch.float32)
        return m, v

    @torch.no_grad()
    def apply(self, params: List[torch.Tensor], grads: List[torch.Tensor],
              state: Dict[str, Any],
              norm: Optional[torch.Tensor] = None) -> Dict[str, Any]:
        """Update ``params`` in place; returns the new state (its moment
        tensors are updated in place too). ``norm``: the whole
        gradient's global norm when ``grads`` are shards."""
        if self.max_grad_norm > 0:
            grads = clip_by_global_norm(grads, self.max_grad_norm, norm)
        n = state["count"]
        step_size, bc1, bc2 = self.coefficients(n)
        d1, d2 = self._decays()
        for p, g, mu, nu in zip(params, grads, state["mu"], state["nu"]):
            m, v = self._moments(g, mu, nu, d1, d2)
            u = (m / bc1) / (torch.sqrt(v / bc2) + self.eps)
            u = u + self.weight_decay * p
            p.add_(step_size * u)
            mu.copy_(m)
            nu.copy_(v)
        return {**state, "count": n + 1}

    @torch.no_grad()
    def apply_guarded(self, params, grads, state, decide, bound: int,
                      norm=None) -> Dict[str, Any]:
        """:meth:`apply`'s arithmetic with the count on the device: the
        update's coefficients are row ``count`` of the schedule table
        (``bound`` > any count it can hold), the new params and moments
        are proposed first, ``decide(updates)`` (the per-leaf updates
        ``step_size * u``) returns None to commit them or a device bool
        to commit them only where it is true -- params, moments and
        count alike."""
        if self.max_grad_norm > 0:
            grads = clip_by_global_norm(grads, self.max_grad_norm, norm)
        count = state["count"]
        step_size, bc1, bc2 = self._table.at(bound, count)
        d1, d2 = self._decay
        updates, ms, vs = [], [], []
        for p, g, mu, nu in zip(params, grads, state["mu"], state["nu"]):
            m, v = self._moments(g, mu, nu, d1, d2)
            u = (m / bc1) / (torch.sqrt(v / bc2) + self.eps)
            u = u + self.weight_decay * p
            updates.append(step_size * u)
            ms.append(m)
            vs.append(v)
        ok = decide(updates)
        _commit(ok, params, [p + u for p, u in zip(params, updates)])
        _commit(ok, state["mu"], ms)
        _commit(ok, state["nu"], vs)
        count.add_(1 if ok is None else ok.to(count.dtype))
        return state


@dataclasses.dataclass(frozen=True)
class SGD:
    """optax.sgd(lr, momentum): trace = g + momentum * trace, then
    p -= lr * trace; ``max_grad_norm > 0`` clips first. ``count`` as
    in :class:`AdamW`."""

    learning_rate: Schedule
    momentum: float = 0.9
    max_grad_norm: float = 0.0
    _table: _ScheduleTable = dataclasses.field(
        default=None, compare=False, repr=False)

    def __post_init__(self):
        object.__setattr__(self, "_table", _ScheduleTable(
            lambda n: (-float(self.learning_rate(n)),)))

    def init(self, params, device=None) -> Dict[str, Any]:
        count = 0 if device is None else torch.zeros(
            (), dtype=torch.int64, device=device)
        return {"count": count, "trace": [
            torch.zeros_like(p, requires_grad=False)
            for p in tree_leaves(params)
        ]}

    @torch.no_grad()
    def apply(self, params, grads, state, norm=None):
        if self.max_grad_norm > 0:
            grads = clip_by_global_norm(grads, self.max_grad_norm, norm)
        n = state["count"]
        step_size = -float(self.learning_rate(n))
        for p, g, tr in zip(params, grads, state["trace"]):
            tr.copy_(g + self.momentum * tr)
            p.add_(step_size * tr)
        return {**state, "count": n + 1}

    @torch.no_grad()
    def apply_guarded(self, params, grads, state, decide, bound: int,
                      norm=None):
        """:meth:`apply` with the count on the device; see
        :meth:`AdamW.apply_guarded`."""
        if self.max_grad_norm > 0:
            grads = clip_by_global_norm(grads, self.max_grad_norm, norm)
        count = state["count"]
        step_size = self._table.at(bound, count)[0]
        traces = [g + self.momentum * tr
                  for g, tr in zip(grads, state["trace"])]
        updates = [step_size * tr for tr in traces]
        ok = decide(updates)
        _commit(ok, state["trace"], traces)
        _commit(ok, params, [p + u for p, u in zip(params, updates)])
        count.add_(1 if ok is None else ok.to(count.dtype))
        return state


def make_adamw(lr, weight_decay: float, moments_dtype: str = "float32",
               max_grad_norm: float = 0.0) -> AdamW:
    """AdamW with both moments stored in ``moments_dtype`` ("float32"
    or "bfloat16"; the moment math stays fp32 either way)."""
    if moments_dtype not in ("float32", "bfloat16"):
        raise ValueError(
            f"adam_moments_dtype {moments_dtype!r} (float32|bfloat16)"
        )
    schedule = lr if callable(lr) else (lambda n: lr)
    return AdamW(schedule, weight_decay, getattr(torch, moments_dtype),
                 max_grad_norm)


def make_optimizer(cfg: TrainingConfig):
    """SGD+momentum or AdamW from config (AdamW when weight_decay > 0),
    with the configured LR schedule and, when ``max_grad_norm > 0``, a
    global-norm clip of the accumulated gradient before the update."""
    lr = make_lr_schedule(cfg)
    if cfg.max_grad_norm < 0:
        raise ValueError(
            f"max_grad_norm {cfg.max_grad_norm} must be >= 0 (0 = off)"
        )
    if cfg.weight_decay > 0:
        return make_adamw(lr, cfg.weight_decay, cfg.adam_moments_dtype,
                          cfg.max_grad_norm)
    if cfg.adam_moments_dtype != "float32":
        raise ValueError(
            f"adam_moments_dtype={cfg.adam_moments_dtype!r} has no "
            "effect on the SGD path -- set weight_decay > 0 to get "
            "AdamW, or drop the moments override"
        )
    return SGD(lr, cfg.momentum, cfg.max_grad_norm)


# ---------------------------------------------------------------------------
# The step
# ---------------------------------------------------------------------------

def make_step_fn(
    forward: ForwardFn,
    optimizer,
    seed: int,
    grad_accum: int = 1,
    log_grad_norm: bool = False,
    module: Optional[torch.nn.Module] = None,
    health: bool = False,
    skip_nonfinite: bool = False,
    numeric_fault: Optional[Callable] = None,
    grad_sync: Any = None,
    group: Any = None,
    metric_group: Any = None,
) -> Callable[..., Tuple[TrainState, Dict]]:
    """The training step ``step(state, batch, data_offset=0)``: forward,
    backward, optimizer update. ``group``: the process group over the
    trainer's mesh, where the step's norms run; None is the whole
    process group. ``metric_group``: where the loss and aux metrics are
    averaged (default ``group``).

    ``grad_accum > 1`` splits the batch into that many microbatches
    (rows ``[i*m, (i+1)*m)``, as the JAX reshape does), sums their
    gradients and applies ONE update with the mean gradient and the
    mean loss -- the full batch's trajectory at 1/grad_accum of the
    activation memory. ``log_grad_norm`` adds the pre-clip global norm
    of that mean gradient as ``metrics["grad_norm"]``. Metrics stay on
    the device; nothing here waits for the card.

    ``module``: the params laid out on a mesh
    (``parallel.shard.shard_params``). ``forward`` then gets the module
    instead of the param dict; FSDP2 reduce-scatters the gradients once,
    after the last microbatch (gradient sync off before it), averaged
    over ``data`` (and ``context``); the loss metric is averaged over the ranks; the norm
    is the whole gradient's (:func:`sharded_global_norm`); and the
    optimizer updates each rank's shards in place, its moments shaped
    like them.

    The numeric-health guard (the JAX ``make_step_fn``'s contract):
    ``health`` adds the health vector to the metrics --
    ``health_loss_finite``, ``health_grad_norm`` and
    ``health_update_norm`` (global norms of the mean gradient and of
    the optimizer's update) and ``health_nonfinite`` (leaves of the
    gradient with any non-finite element, by their max-abs norm, which
    a NaN reaches and an overflowing sum of squares does not) -- and
    runs the optimizer's guarded update (its count on the device). On a
    mesh the three reductions ride ONE all-reduce, so every rank sees
    the same vector. ``skip_nonfinite`` (guard_mode="skip") keeps the
    old params, moments, count and model state where the update is
    poisoned (non-finite loss, grad or update), as a ``torch.where`` on
    the device, and reports ``health_skipped``; the step and the data
    stream advance either way. ``numeric_fault(data_index, loss,
    grads)`` perturbs the loss and gradients before the update, keyed
    on ``state.step + data_offset``. With none of the three, the step
    issues exactly the ops it did before the guard existed.

    ``grad_sync`` (a ``comm.overlap.GradSync``, the manual comm modes):
    the params are replicated plain tensors; the sync is armed on the
    last microbatch, whose backward launches the bucket reductions as
    the gradients land; the mean gradient comes from its buckets, and
    the loss, aux and model state are averaged over the sync axes in
    one all-reduce. Each microbatch's rng folds in the rank's shard
    index (the JAX step's ``fold_in``); integer aux or model-state
    leaves are refused.
    """
    from tpu_hpc_torch.comm.overlap import check_inexact

    sharded = module is not None
    need_norm = log_grad_norm or (
        sharded and getattr(optimizer, "max_grad_norm", 0) > 0)

    def step(state: TrainState, batch,
             data_offset: int = 0) -> Tuple[TrainState, Dict]:
        leaves = tree_leaves(state.params)
        for p in leaves:
            p.grad = None
        rows = batch[0].shape[0]
        if rows % grad_accum:
            raise ValueError(
                f"batch of {rows} not divisible by grad_accum {grad_accum}"
            )
        micro = rows // grad_accum
        step_gen = step_seed(seed, state.step)
        ms_in = ms = state.model_state
        lsum, aux_sum = None, {}
        for i in range(grad_accum):
            if sharded and hasattr(module, "set_requires_gradient_sync"):
                module.set_requires_gradient_sync(i == grad_accum - 1)
            mb = tuple(a[i * micro:(i + 1) * micro] for a in batch)
            seed_i = step_seed(step_gen, i)
            if grad_sync is not None:
                grad_sync.begin(last=i == grad_accum - 1)
                seed_i = step_seed(seed_i, grad_sync.shard_index)
            rng = torch.Generator().manual_seed(seed_i)
            loss, ms, aux = forward(module if sharded else state.params,
                                    ms, mb, rng)
            if grad_sync is not None:
                check_inexact((ms, aux))
            loss.backward()
            loss = loss.detach()
            lsum = loss if lsum is None else lsum + loss
            for k, v in aux.items():
                v = torch.as_tensor(v).detach()
                aux_sum[k] = v if k not in aux_sum else aux_sum[k] + v
        if grad_sync is not None:
            grads = grad_sync.finish()
        else:
            grads = [
                torch.zeros_like(p) if p.grad is None else p.grad
                for p in leaves
            ]
        with torch.no_grad():
            copies = [_copies(g, group) for g in grads] if sharded \
                else None
            grads = [local(g) for g in grads]
            params = [local(p) for p in leaves]
        if grad_accum > 1:
            grads = [g / grad_accum for g in grads]
            lsum = lsum / grad_accum
            aux_sum = {k: v / grad_accum for k, v in aux_sum.items()}
        if numeric_fault is not None:
            # Keyed on the DATA index: after a guard rollback the skip
            # window shifts the stream past the poisoned index, so the
            # relaunch never re-hits it.
            lsum, grads = numeric_fault(state.step + data_offset, lsum,
                                        grads)
        metrics = {"loss": lsum, **aux_sum}
        if sharded:
            metrics = {k: _rank_mean(v, metric_group or group)
                       for k, v in metrics.items()}
        elif grad_sync is not None:
            metrics, ms = grad_sync.mean((metrics, ms))
        if log_grad_norm and "grad_norm" in aux_sum:
            raise ValueError(
                "forward() reports an aux metric named 'grad_norm', "
                "which collides with the optimizer-level norm logged "
                "when max_grad_norm > 0 -- rename the aux metric"
            )
        norm = None
        if need_norm:
            norm = (sharded_global_norm(grads, copies, group) if sharded
                    else global_norm(grads))
        if log_grad_norm:
            metrics["grad_norm"] = norm
        if health:
            def decide(updates):
                vec = _health(metrics["loss"], grads, updates, copies, norm,
                              group)
                metrics.update(vec)
                if not skip_nonfinite:
                    return None
                ok = ((vec["health_loss_finite"] > 0)
                      & (vec["health_nonfinite"] == 0)
                      & torch.isfinite(vec["health_grad_norm"])
                      & torch.isfinite(vec["health_update_norm"]))
                metrics["health_skipped"] = (~ok).to(torch.float32)
                return ok

            opt_state = optimizer.apply_guarded(
                params, grads, state.opt_state, decide,
                bound=state.step + 1, norm=norm)
            if skip_nonfinite:
                ms = _keep(metrics["health_skipped"] == 0, ms, ms_in)
        else:
            opt_state = optimizer.apply(params, grads, state.opt_state,
                                        norm=norm)
        for p in leaves:
            p.grad = None
        return TrainState(state.step + 1, state.params, opt_state, ms), metrics

    return step


def _health(loss, grads, updates, copies, norm,
            group=None) -> Dict[str, torch.Tensor]:
    """The health vector (fp32 device scalars): loss finite, global
    grad norm (``norm`` when the clip already took it), global update
    norm, and the number of gradient leaves with a non-finite element.
    With ``copies`` (this rank's shards) the squared norms and the
    per-leaf flags are summed over the ranks in one all-reduce."""
    def sq(ts):  # per-leaf squared L2 norms, over copies on a mesh
        out = torch.stack(torch._foreach_norm(ts)).square()
        return out if copies is None else out / div

    with torch.no_grad():
        flags = (~torch.isfinite(torch.stack(
            torch._foreach_norm(grads, float("inf"))))).to(torch.float32)
        if copies is not None:
            div = torch.tensor(copies, dtype=torch.float32,
                               device=flags.device)
        # [grad norm^2 (the clip's norm is already whole), update
        # norm^2, flags]: one all-reduce on a mesh.
        parts = [sq(updates).sum().view(1), flags]
        if norm is None:
            parts.insert(0, sq(grads).sum().view(1))
        total = torch.cat(parts)
        if copies is not None:
            import torch.distributed as dist

            dist.all_reduce(total, group=group)
        if norm is not None:
            total = torch.cat([norm.square().view(1), total])
        return {
            "health_loss_finite": torch.isfinite(loss).to(torch.float32),
            "health_grad_norm": torch.sqrt(total[0]),
            "health_update_norm": torch.sqrt(total[1]),
            "health_nonfinite": (total[2:] > 0).sum().to(torch.float32),
        }


def _keep(ok, new, old):
    """Model state: ``new`` where ``ok``, else ``old`` (dict trees)."""
    if isinstance(new, dict):
        return {k: _keep(ok, v, old[k]) for k, v in new.items()}
    if isinstance(new, torch.Tensor):
        return torch.where(ok, new, old)
    return new


def _rank_mean(v: torch.Tensor, group=None) -> torch.Tensor:
    """The mean of a metric over the trainer's ranks (``group``, default
    the process group; each data rank's mean over its rows, equal rows
    per rank make it the global mean)."""
    import torch.distributed as dist

    v = v.to(torch.float32).clone()
    dist.all_reduce(v, group=group)
    return v / dist.get_world_size(group)


# ---------------------------------------------------------------------------
# Carrying a JAX state across
# ---------------------------------------------------------------------------

def _fields(node):
    return getattr(node, "_fields", None) or ()


def _find_states(node, found: Dict[str, Any]) -> None:
    """Walk an optax state (tuples of namedtuples) for the Adam moments,
    the SGD trace and an update count."""
    fields = _fields(node)
    if "mu" in fields and "nu" in fields:
        found["adam"] = node
    elif "trace" in fields:
        found["trace"] = node
    elif fields == ("count",):
        found.setdefault("count", node.count)
    elif isinstance(node, (tuple, list)):
        for child in node:
            _find_states(child, found)


def state_from_numpy(step, params, opt_state, cfg,
                     device="cuda") -> TrainState:
    """A JAX ``TrainState`` fetched to the host (``jax.device_get``) ->
    the port's state on ``device``: fp32 params with ``requires_grad``,
    and the Adam ``mu``/``nu``/``count`` or the SGD trace, in the
    optimizer layout :func:`make_optimizer` builds for ``cfg``. Lets a
    run continue in the port from any point of a JAX run.
    ``serve.weights.params_from_numpy`` casts matrices to the compute
    dtype for serving, so it cannot serve training. ``opt_state=None``
    starts a fresh optimizer state for ``cfg``."""
    device = resolve_device(device)
    param_dtype = getattr(torch, cfg.param_dtype)

    def leaf(a, dtype, grad=False):
        t = torch.from_numpy(np.array(a, copy=True)).to(device, dtype)
        return t.requires_grad_(grad)

    tparams = tree_map(lambda a: leaf(a, param_dtype, grad=True), params)
    opt = make_optimizer(cfg)
    found: Dict[str, Any] = {}
    _find_states(opt_state, found)
    if opt_state is None:
        tstate = opt.init(tparams)
    elif isinstance(opt, AdamW):
        if "adam" not in found:
            raise ValueError("opt_state holds no Adam moments for an AdamW config")
        adam = found["adam"]
        tstate = {
            "count": int(np.asarray(adam.count)),
            "mu": [leaf(a, opt.moments_dtype) for a in tree_leaves(adam.mu)],
            "nu": [leaf(a, opt.moments_dtype) for a in tree_leaves(adam.nu)],
        }
    else:
        if "trace" not in found:
            raise ValueError("opt_state holds no SGD trace for an SGD config")
        count = found.get("count")
        tstate = {
            "count": int(np.asarray(count)) if count is not None else int(step),
            "trace": [leaf(a, param_dtype)
                      for a in tree_leaves(found["trace"].trace)],
        }
    return TrainState(int(np.asarray(step)), tparams, tstate, {})


# ---------------------------------------------------------------------------
# Trainer
# ---------------------------------------------------------------------------

def _checked_fault_plan():
    """``$TPU_HPC_FAULTS``'s plan, refusing the stage and slice faults
    this SPMD Trainer cannot inject (the JAX Trainer's vacuous-pass
    guards, word for word)."""
    plan = fault_plan_from_env()
    if plan is None:
        return None
    stage_keys = plan.stage_fault_keys()
    if stage_keys:
        raise ValueError(
            f"TPU_HPC_FAULTS arms stage fault(s) "
            f"{', '.join(stage_keys)}, but this is an SPMD "
            "Trainer run -- stage faults are consumed only "
            "by the MPMD pipeline runtime "
            "(tpu_hpc.parallel.mpmd / bench.py --workload "
            "llama-pp --pp-runtime mpmd); refusing to run a "
            "chaos schedule that cannot inject"
        )
    slice_keys = plan.slice_fault_keys()
    if slice_keys and os.environ.get(ENV_ELASTIC_MANAGED) != "1":
        raise ValueError(
            f"TPU_HPC_FAULTS arms slice fault(s) "
            f"{', '.join(slice_keys)}, but this Trainer is "
            "not running under the elastic coordinator "
            "(tpu_hpc.elastic) -- a fixed-topology run "
            "cannot morph; refusing to run a chaos schedule "
            "that cannot inject"
        )
    return plan


def _json_finite(x) -> Optional[float]:
    """JSON-safe float: a non-finite value becomes None (strict-JSON
    readers reject a bare NaN token)."""
    x = float(x)
    return x if math.isfinite(x) else None


def _world() -> int:
    import torch.distributed as dist

    return dist.get_world_size() if dist.is_initialized() else 1


def _rank() -> int:
    import torch.distributed as dist

    return dist.get_rank() if dist.is_initialized() else 0


@torch.no_grad()
def _local_tree(params):
    return tree_map(local, params)


def _is_device_mesh(mesh: Any) -> bool:
    return mesh is not None and not isinstance(mesh, Mapping)


class Trainer:
    def __init__(
        self,
        cfg: TrainingConfig,
        mesh: Any,
        forward: ForwardFn,
        params: Any,
        model_state: Any = None,
        param_pspecs: Any = None,
        batch_pspec: P = P("data"),
        optimizer: Any = None,
        checkpoint_manager: Any = None,
        eval_forward: Optional[Callable] = None,
        device: Any = None,
        comm_plan: Any = None,
    ):
        """``mesh``: None (one device), or a ``DeviceMesh`` with named
        dims (``runtime.build_mesh``) over the whole process group.
        ``params``: the full nested dict of tensors or numpy arrays, the
        same on every rank; the trainer keeps its own copies, so the
        caller's tensors are never updated in place.

        On a ``DeviceMesh`` the params are laid out by ``param_pspecs``
        (default: replicated, the DDP plan) through
        ``parallel.shard.shard_params``: TP DTensors on ``model``, FSDP2
        over ``data``. The global batch is split over
        ``batch_pspec[0]`` (the data axis): data rank r takes its rows
        of each microbatch, and the model ranks of one data group see
        the same rows. ``batch_pspec[1]`` (``P("data", "context")``,
        sequence parallelism) splits the sequence too: context rank c
        takes columns ``[c*S/n, (c+1)*S/n)`` of its rows -- its
        contiguous shard, or its zigzag chunk pair when the stream is
        laid out in zigzag order -- and FSDP2 then runs over data x
        context (``shard.fsdp_mesh``). ``device`` defaults to the
        mesh's device type (or the params' device).

        ``eval_forward(params, model_state, batch) -> (loss, aux)``
        defaults to the training forward with state updates
        discarded.

        ``cfg.comm_mode`` "bucketed_overlap" or "hierarchical" (or
        "auto" resolving to one): the DDP recipe on ``mesh``, which must
        be a ``DeviceMesh`` whose axes other than the batch's sync axes
        (``batch_pspec[0]``: ``P("data")``, ``P(("dcn", "data"))``) are
        of size 1; the params stay plain tensors, replicated (checked
        once, here), and each rank takes its rows of the batch.
        ``comm_plan``: a decision already made for ``comm_mode="auto"``
        (``comm.planner.CommDecision``; the CLI resolves before it builds
        the mesh), used instead of planning again."""
        if isinstance(mesh, Mapping) and math.prod(mesh.values()) > 1:
            raise ValueError(
                f"a mesh of {math.prod(mesh.values())} devices must be a "
                "DeviceMesh (runtime.build_mesh), not its sizes"
            )
        if optimizer is not None and cfg.max_grad_norm > 0:
            raise ValueError(
                f"max_grad_norm={cfg.max_grad_norm} has no effect on an "
                "explicitly passed optimizer -- give it max_grad_norm "
                "itself, or drop one of the two"
            )
        if cfg.grad_accum_steps < 1:
            raise ValueError(
                f"grad_accum_steps must be >= 1, got {cfg.grad_accum_steps}"
            )
        if cfg.global_batch_size % cfg.grad_accum_steps:
            raise ValueError(
                f"global_batch_size {cfg.global_batch_size} not divisible "
                f"by grad_accum_steps {cfg.grad_accum_steps}"
            )
        self.cfg = cfg
        self.forward = forward
        self.checkpoint_manager = checkpoint_manager
        # Fault injection is read HERE: the numeric kinds perturb the
        # step itself, so the plan must exist before the step is built.
        self.fault_plan = _checked_fault_plan()
        # Numeric-health guard: None when guard_mode == "off" -- the
        # step then issues the ops it did before the guard existed.
        self.guard_policy = GuardPolicy.from_config(cfg)
        if self.guard_policy is not None and checkpoint_manager is None and (
                self.guard_policy.mode == "rollback"
                or self.guard_policy.spike_action == "rollback"):
            raise ValueError(
                "guard_mode='rollback' (or guard_spike_action="
                "'rollback') needs a checkpoint_manager: rollback-to-"
                "last-good restores a snapshot; without one the guard "
                "can only skip or record events"
            )
        numeric_fault = (self.fault_plan.numeric_fault_fn()
                         if self.fault_plan is not None else None)
        self._guard_tracked = (self.guard_policy is not None
                               or numeric_fault is not None)
        # Skip windows (persisted guard state): loaded per fit() from
        # the checkpoint dir; empty until a rollback ever happened.
        self._skip_windows: list = []
        self._fit_offset = 0
        self._rolled_back = False
        self.mesh = mesh if _is_device_mesh(mesh) else None
        # The process group over the mesh's ranks: None when the mesh
        # spans the job (the elastic coordinator builds meshes over a
        # subset of the ranks).
        self.group = mesh_group(self.mesh)
        # Where the step's metrics are averaged: the trainer's ranks,
        # but over a ``replica`` axis (the elastic layouts') the rows
        # repeat, so only over the data ranks -- the mean then rounds
        # exactly as on the mesh without the replicas.
        self._metric_group = self.group
        if self.mesh is not None and "replica" in (
                self.mesh.mesh_dim_names or ()):
            from tpu_hpc_torch.parallel.shard import fsdp_mesh

            self._metric_group = fsdp_mesh(self.mesh).get_group()
        self.module = None
        self._data_shards, self._data_rank = 1, 0
        self._seq_shards, self._seq_rank = 1, 0
        self.grad_sync = None
        comm_mode, bucket_bytes = self._resolve_comm(
            cfg, params, param_pspecs, batch_pspec, comm_plan)
        if comm_mode != "flat":
            params = self._manual_sync(comm_mode, bucket_bytes, params,
                                       batch_pspec, device)
        elif self.mesh is not None:
            self.device = resolve_device(
                device if device is not None else self.mesh.device_type)
            if param_pspecs is None:
                param_pspecs = dp.param_pspecs(params)
            # The batch's second axis (context, or a domain's spatial
            # bands) splits each row: FSDP2 averages over it with data.
            seq_axis = batch_pspec[1] if len(batch_pspec) > 1 else None
            self.module = shard_params(params, self.mesh, param_pspecs,
                                       device=self.device,
                                       context_axis=seq_axis or "context")
            params = self.module.tree()
            axis = batch_pspec[0] if len(batch_pspec) else None
            if axis is not None and axis in self.mesh.mesh_dim_names:
                self._data_shards = self.mesh[axis].size()
                self._data_rank = self.mesh[axis].get_local_rank()
            if seq_axis is not None and seq_axis in self.mesh.mesh_dim_names:
                self._seq_shards = self.mesh[seq_axis].size()
                self._seq_rank = self.mesh[seq_axis].get_local_rank()
            if cfg.global_batch_size % (self._data_shards
                                        * cfg.grad_accum_steps):
                raise ValueError(
                    f"global_batch_size {cfg.global_batch_size} not "
                    f"divisible by {self._data_shards} data shards x "
                    f"grad_accum_steps {cfg.grad_accum_steps}")
        else:
            first = tree_leaves(params)[0]
            self.device = resolve_device(device if device is not None
                                         else first.device)
            params = tree_map(
                lambda t: t.detach().to(self.device).clone()
                .requires_grad_(True), params)
        self.optimizer = optimizer or make_optimizer(cfg)
        # The guarded update keeps the optimizer's count on the device.
        count_on = ({"device": self.device}
                    if self.guard_policy is not None else {})
        self.state = TrainState(
            step=0, params=params,
            opt_state=self.optimizer.init(_local_tree(params), **count_on),
            model_state=model_state if model_state is not None else {},
        )
        if eval_forward is None:
            def eval_forward(p, ms, batch):
                loss, _, aux = forward(
                    p, ms, batch, torch.Generator().manual_seed(cfg.seed)
                )
                return loss, aux
        self.eval_forward = eval_forward
        self._step = make_step_fn(
            forward, self.optimizer, cfg.seed,
            grad_accum=cfg.grad_accum_steps,
            log_grad_norm=cfg.max_grad_norm > 0,
            module=self.module,
            health=self.guard_policy is not None,
            skip_nonfinite=(self.guard_policy is not None
                            and self.guard_policy.mode == "skip"),
            numeric_fault=numeric_fault,
            grad_sync=self.grad_sync,
            group=self.group,
            metric_group=self._metric_group,
        )
        self.n_devices = self.mesh.size() if self.mesh is not None else 1
        self.meter = ThroughputMeter(n_devices=self.n_devices,
                                     device=self.device)
        self.goodput = GoodputMeter()
        self._adopted = False
        # Elastic quiesce hook (elastic/coordinator.py):
        # callable(done_step) -> Optional[target_step], polled at every
        # chunk boundary. A target caps the next chunk so the loop lands
        # EXACTLY on it; reaching it stops fit() cleanly with
        # result["quiesced"]=True -- state live, nothing saved, nothing
        # exited -- so the coordinator can morph and resume.
        self.quiesce_check: Optional[Callable[[int], Optional[int]]] = None
        self._quiesced = False
        # Resilience wiring: the heartbeat arms itself from the
        # supervisor's env contract; the stall watermark flags
        # stragglers and enriches the heartbeat.
        self.heartbeat = Heartbeat.from_env()
        self.stall = obs.StallDetector()
        # Anomaly-triggered capture (obs/trace.py): a stall-watermark
        # breach or a poisoned guard verdict fires ONE bounded
        # torch.profiler window + flight dump, keyed by the triggering
        # step's trace id, with zero operator intervention. Built per
        # fit() (cfg.capture_on_anomaly), but the knob is validated
        # HERE: a bad capture_steps must fail at construction, not
        # after a full bring-up.
        if cfg.capture_on_anomaly and cfg.capture_steps < 1:
            raise ValueError(
                f"capture_steps {cfg.capture_steps} must be >= 1 "
                "when capture_on_anomaly is set"
            )
        self.capture: Optional[obs.AnomalyCapture] = None
        # Live telemetry plane (obs/digest.py): per-HOST health digests
        # into $TPU_HPC_DIGEST_DIR every chunk boundary, keyed by rank,
        # so a fleet rollup (python -m tpu_hpc_torch.obs.live) compares
        # this host's step watermark against its peers while the run
        # goes on. None (free) unless the env contract arms it.
        self.digest = obs.DigestPublisher.from_env(role="host",
                                                   key=str(_rank()))
        self._watchdog: Optional[HangWatchdog] = None
        if checkpoint_manager is not None and hasattr(
                checkpoint_manager, "event_sink"):
            checkpoint_manager.event_sink = self._sink()
        bus = obs.get_bus()
        if bus.flight_dir is None and cfg.checkpoint_dir:
            bus.flight_dir = cfg.checkpoint_dir
        # The planner's comm_mode="auto" verdict, next to the epoch
        # records it explains.
        if self.comm_plan is not None:
            self._append_metrics({
                "event": "comm_plan",
                "resolved_from": "auto",
                **self.comm_plan.summary(),
            })
        reg = obs.get_registry()
        reg.describe("train_steps_total", "Optimizer steps completed")
        reg.describe("train_items_total",
                     "Training items consumed (global batch x steps)")
        reg.describe("train_step", "Current global optimizer step")
        reg.describe("train_step_s",
                     "Per-step wall time within the last chunk (s)")

    def _resolve_comm(self, cfg, params, param_pspecs, batch_pspec,
                      comm_plan) -> Tuple[str, int]:
        """The JAX Trainer's resolution of ``cfg.comm_mode``: "auto"
        asks the planner (or takes ``comm_plan``), whose bucket size
        then replaces ``comm_bucket_mb``; the mode is validated against
        the plan (manual modes need replicated params). Sets
        ``comm_plan`` and ``comm_mode_resolved``; returns (mode,
        bucket bytes)."""
        from tpu_hpc_torch.parallel.fsdp import validate_grad_sync_mode

        mode = cfg.comm_mode
        bucket_bytes = cfg.comm_bucket_mb * 2 ** 20
        specs = (param_pspecs if param_pspecs is not None
                 else dp.param_pspecs(params))
        self.comm_plan = None
        if mode == "auto":
            if comm_plan is not None:
                self.comm_plan = comm_plan
            else:
                from tpu_hpc_torch.comm.planner import plan_trainer_grad_sync

                self.comm_plan = plan_trainer_grad_sync(
                    self.mesh, batch_pspec, specs, params,
                    bucket_cap_bytes=bucket_bytes)
            mode = self.comm_plan.mode
            if self.comm_plan.bucket_bytes:
                bucket_bytes = self.comm_plan.bucket_bytes
        self.comm_mode_resolved = validate_grad_sync_mode(mode, specs)
        return self.comm_mode_resolved, bucket_bytes

    def _manual_sync(self, mode: str, bucket_bytes: int, params,
                     batch_pspec, device):
        """Set up a manual comm mode: replicated plain params on the
        device (checked equal on every rank), this rank's place in the
        batch split, and the bucketed sync. Returns the params."""
        from tpu_hpc_torch.comm import overlap

        if self.mesh is None:
            raise ValueError(
                f"comm_mode {mode!r} syncs gradients over the data axes "
                "of a process group's DeviceMesh, and this trainer has "
                "none: start a process group (one rank on one card) and "
                "pass its mesh -- a manual mode never trains unsynced")
        sync_axes = overlap.sync_axes_from_batch_pspec(batch_pspec)
        names = tuple(self.mesh.mesh_dim_names)
        missing = [a for a in sync_axes if a not in names]
        extra = {a: self.mesh.size(i) for i, a in enumerate(names)
                 if a not in sync_axes and self.mesh.size(i) > 1}
        if missing or extra:
            raise ValueError(
                f"comm_mode {mode!r} runs pure data parallelism over the "
                f"batch's sync axes {sync_axes}; the mesh {names} "
                + (f"lacks {missing}" if missing else
                   f"also splits {extra}"))
        self.device = resolve_device(
            device if device is not None else self.mesh.device_type)
        params = tree_map(
            lambda t: torch.as_tensor(np.asarray(t) if not isinstance(
                t, torch.Tensor) else t).detach().to(self.device).clone()
            .requires_grad_(True), params)
        leaves = tree_leaves(params)
        self.grad_sync = overlap.GradSync(leaves, self.mesh, sync_axes, mode,
                                          bucket_bytes)
        overlap.verify_replicated(
            leaves, self.grad_sync.reducer.group,
            ["/".join(p) for p in tree_paths(params)])
        self._data_shards = self.grad_sync.n_total
        self._data_rank = self.grad_sync.shard_index
        if self.cfg.global_batch_size % (self._data_shards
                                         * self.cfg.grad_accum_steps):
            raise ValueError(
                f"global_batch_size {self.cfg.global_batch_size} not "
                f"divisible by {self._data_shards} data shards x "
                f"grad_accum_steps {self.cfg.grad_accum_steps}")
        return params

    def gather_params(self) -> Dict[str, Any]:
        """The whole param tree as numpy arrays, on every rank
        (collective on a mesh)."""
        return gather_params(self.state.params)

    def adopt_state(self, state: TrainState) -> None:
        """Adopt a live state: :func:`state_from_numpy`'s on one device,
        or one laid out on this trainer's mesh -- the elastic
        coordinator's morphed state, whose params and moments are this
        rank's shards of the trainer's own layout (plain tensors or
        DTensors). On a mesh the values are copied into the trainer's
        own tensors (the params stay the module's, FSDP2's hooks on
        them); on one device the state's tensors are taken as they are
        and must already lie on this trainer's device. ``fit`` then
        continues from ``state.step``, trusting the in-memory step over
        any checkpoint on disk (a morph writes none; a snapshot
        predates it). A guarded trainer moves a host count to the
        device."""
        if self.module is not None or self.grad_sync is not None:
            self._adopt_laid_out(state)
        else:
            self.state = state
        count = self.state.opt_state.get("count")
        if self.guard_policy is not None and not isinstance(
                count, torch.Tensor):
            self.state.opt_state["count"] = torch.full(
                (), int(count), dtype=torch.int64, device=self.device)
        self._adopted = True

    @torch.no_grad()
    def _adopt_laid_out(self, state: TrainState) -> None:
        """Copy ``state``'s shards into the live tensors of a trainer on
        a mesh, checking each against this rank's shard."""
        live = self.state

        def copy(dst, src, what):
            dst_l, src_l = local(dst), local(torch.as_tensor(src))
            if tuple(dst_l.shape) != tuple(src_l.shape):
                raise ValueError(
                    f"adopt_state: {what} holds {tuple(src_l.shape)} on "
                    f"this rank, the trainer's shard is "
                    f"{tuple(dst_l.shape)}")
            dst_l.copy_(src_l)

        for path, dst, src in zip(tree_paths(live.params),
                                  tree_leaves(live.params),
                                  tree_leaves(state.params)):
            copy(dst, src, "/".join(path))
        opt = dict(live.opt_state)
        for name, value in state.opt_state.items():
            if isinstance(value, list):
                for j, (dst, src) in enumerate(zip(opt[name], value)):
                    copy(dst, src, f"opt_state/{name}/{j}")
            elif isinstance(opt.get(name), torch.Tensor):
                copy(opt[name], value, f"opt_state/{name}")
            else:
                opt[name] = int(value) if isinstance(
                    value, (int, torch.Tensor)) else value
        for dst, src in zip(tree_leaves(live.model_state or {}),
                            tree_leaves(state.model_state or {})):
            copy(dst, src, "model_state")
        self.state = TrainState(int(state.step), live.params, opt,
                                live.model_state)

    def _to_device(self, batch):
        """The global batch -> this rank's rows on the device: of each
        of the ``grad_accum`` microbatches, the data rank's slice; then,
        over a context axis, the context rank's columns."""
        n, r = self._data_shards, self._data_rank
        if n > 1:
            accum = self.cfg.grad_accum_steps
            batch = tuple(
                a.reshape(accum, n, a.shape[0] // (accum * n), *a.shape[1:])
                [:, r].reshape(-1, *a.shape[1:]) for a in batch)
        n, r = self._seq_shards, self._seq_rank
        if n > 1:
            seq = batch[0].shape[1]
            if seq % n:
                raise ValueError(f"seq {seq} not divisible by {n} context "
                                 "shards")
            s = seq // n
            batch = tuple(a[:, r * s:(r + 1) * s].contiguous() for a in batch)
        return tuple(a.to(self.device, non_blocking=True) for a in batch)

    def train_step(self, batch) -> Dict[str, torch.Tensor]:
        """One optimizer update on a global batch; metrics stay on the
        device."""
        extra = (self._fit_offset,) if self._guard_tracked else ()
        self.state, metrics = self._step(self.state, self._to_device(batch),
                                         *extra)
        return metrics

    @torch.no_grad()
    def evaluate(self, dataset, n_steps: Optional[int] = None) -> Dict[str, float]:
        """Mean loss (and aux metrics) over ``n_steps`` batches
        ``dataset.batch_at(i, global_batch)``, i = 0 .. n_steps - 1; one
        host fetch at the end."""
        n_steps = n_steps or self.cfg.steps_per_epoch
        bs = self.cfg.global_batch_size
        sums: Dict[str, torch.Tensor] = {}
        params = self.module if self.module is not None else self.state.params
        for i in range(n_steps):
            loss, aux = self.eval_forward(
                params, self.state.model_state,
                self._to_device(dataset.batch_at(i, bs)),
            )
            for k, v in {"loss": loss, **aux}.items():
                v = torch.as_tensor(v).detach().to(torch.float32)
                sums[k] = sums[k] + v if k in sums else v
        if self.module is not None or self.grad_sync is not None:
            sums = {k: _rank_mean(v, self._metric_group)
                    for k, v in sums.items()}
        if self.module is not None:
            # FSDP2 keeps the root's params whole after a forward with
            # no backward; shard them again.
            if hasattr(self.module, "reshard"):
                self.module.reshard()
        out = {k: float(v) / n_steps for k, v in sums.items()}
        self._append_metrics({
            **out, "event": "eval", "time": time.time(),
            "step": self.state.step, "n_steps": n_steps,
        })
        return out

    def _sink(self) -> Optional[str]:
        """The metrics JSONL path on rank 0 (which owns the run log);
        None elsewhere, so the bus keeps records in its ring only."""
        if self.cfg.metrics_path and _rank() == 0:
            return self.cfg.metrics_path
        return None

    def _append_metrics(self, record: Dict) -> None:
        """The run log (``cfg.metrics_path``) through the obs bus:
        schema-stamped, held in the flight ring, appended to the file
        on rank 0 when one is configured."""
        obs.get_bus().emit_record(record, sink=self._sink())

    # -- checkpoints ---------------------------------------------------
    @torch.no_grad()
    def _assign_state(self, restored: TrainState) -> None:
        """Copy a restored state into the live tensors (the params are
        the module's on a mesh, so they are written in place)."""
        live = self.state
        for dst, src in zip(tree_leaves(live.params),
                            tree_leaves(restored.params)):
            dst.copy_(src)
        opt = dict(live.opt_state)
        for name, value in restored.opt_state.items():
            if isinstance(value, list):
                for dst, src in zip(opt[name], value):
                    dst.copy_(src)
            elif isinstance(opt[name], torch.Tensor):
                opt[name].copy_(value)
            else:
                opt[name] = value
        ms = live.model_state
        for dst, src in zip(tree_leaves(ms or {}),
                            tree_leaves(restored.model_state or {})):
            dst.copy_(src)
        self.state = TrainState(restored.step, live.params, opt, ms)

    def maybe_resume(self) -> int:
        """Snapshot auto-resume: continue from the newest readable
        checkpoint when there is one (and ``cfg.resume``); returns the
        step resumed from, else 0."""
        if self.checkpoint_manager is None or not self.cfg.resume:
            return 0
        with self.goodput.measure("restore"), obs.span(
                "restore", sink=self._sink(), hist="train_restore_s"):
            restored = self.checkpoint_manager.restore_latest(self.state)
            if restored is None:
                return 0
            self._assign_state(restored)
        step = self.state.step
        info = getattr(self.checkpoint_manager, "last_restore_info", None)
        if info and info.get("elastic"):
            # The checkpoint was written on another mesh: DCP resharded
            # it into the live layout.
            self._append_metrics({
                "event": "elastic_restore", "from_step": step,
                "src_mesh": info.get("src_mesh"),
                "tgt_mesh": info.get("tgt_mesh"), "plan": None,
            })
        return step

    def _snapshot_config(self) -> None:
        """config.yaml next to the checkpoints, once per fit, after the
        first save landed (a run that never saved must not relabel
        another run's checkpoints)."""
        ckpt_dir = getattr(self.checkpoint_manager, "directory", None)
        if ckpt_dir is None or self._config_snapshotted:
            return
        self.checkpoint_manager.wait()
        self._config_snapshotted = True
        if _rank() == 0:
            self._effective_cfg.to_yaml(os.path.join(ckpt_dir,
                                                     "config.yaml"))

    def _save(self, tid: str, done: int, now: bool = False) -> None:
        with self.goodput.measure("ckpt"), obs.span(
                "ckpt", sink=self._sink(), step=done, hist="train_ckpt_s",
                trace_id=tid):
            mgr = self.checkpoint_manager
            if not now:
                mgr.save(self.state)
            else:
                # Emergency synchronous snapshot, unless this boundary's
                # periodic save already holds the state.
                mgr.wait()
                if done not in (mgr.all_steps() or []):
                    mgr.save_now(self.state)
            self._snapshot_config()

    def _agree(self, flag: bool, device) -> bool:
        """Whether ``flag`` holds on any of the trainer's ranks: a
        preemption notice that reached one rank must stop every rank at
        the same boundary (the emergency save is collective)."""
        if _world() == 1:
            return flag
        import torch.distributed as dist

        t = torch.tensor([float(flag)], device=device)
        dist.all_reduce(t, op=dist.ReduceOp.MAX, group=self.group)
        return bool(t.item())

    # -- the loop --------------------------------------------------------
    def fit(self, dataset, epochs: Optional[int] = None) -> Dict:
        """Epoch loop with throughput instrumentation. Dataset contract:
        ``batch_at(step, global_batch)``. Each epoch is timed from a
        synchronized start to the synchronized fetch of its metrics, so
        an epoch's ``items_per_s`` is the card's rate, host batch
        generation included. Returns the JAX result keys: ``epochs``
        (one meter summary per chunk, plus the loss of every update
        under ``losses``), ``final_loss``, ``preempted``,
        ``rolled_back``, ``quiesced``, ``goodput``.

        With a checkpoint manager the run resumes from its newest
        readable checkpoint, saves every ``save_every`` epochs, and a
        SIGTERM (``PreemptionGuard``) takes a synchronous snapshot at
        the next chunk boundary and stops (``preempted``: the caller
        exits ``EXIT_RESUMABLE``). The guard classifies every update at
        the chunk boundary, before the save; a verdict that wants a
        rollback quarantines the snapshots that hold it, records a skip
        window and stops (``rolled_back``: the caller exits
        ``EXIT_ROLLBACK``, and the relaunch resumes from the last good
        checkpoint with the stream fast-forwarded past the window).
        ``$TPU_HPC_HANG_TIMEOUT`` arms the hang watchdog; fault plans
        fire at chunk boundaries."""
        cfg = self.cfg
        epochs = epochs or cfg.epochs
        if epochs != cfg.epochs and cfg.lr_schedule == "cosine":
            raise ValueError(
                f"fit(epochs={epochs}) conflicts with lr_schedule="
                f"'cosine' sized for cfg.epochs={cfg.epochs}: set "
                "cfg.epochs to the intended run length instead"
            )
        self.goodput = GoodputMeter()
        self._rolled_back = False
        self._quiesced = False
        self._fit_offset = 0
        self._skip_windows = []
        if self.guard_policy is not None:
            self._skip_windows = guard_lib.load_state(
                self._guard_dir())["skip_windows"]
        self._effective_cfg = dataclasses.replace(cfg, epochs=epochs)
        self._config_snapshotted = False
        start_step = (self.state.step if self._adopted
                      else self.maybe_resume())
        spe = cfg.steps_per_epoch
        total_steps = epochs * spe
        self._append_metrics({
            "event": "run_start", "time": time.time(),
            "start_step": start_step, "total_steps": total_steps,
            "n_devices": self.n_devices, "n_processes": _world(),
            "device_kind": (torch.cuda.get_device_name(self.device)
                            if self.device.type == "cuda" else "cpu"),
            "jax_version": None, "torch_version": torch.__version__,
            "config": dataclasses.asdict(self._effective_cfg),
        })
        run_summaries: List[Dict] = []
        prof = None
        if cfg.profile:
            prof = TrainingProfiler(
                cfg.profile_dir, cfg.profile_start_step,
                cfg.profile_num_steps, device=self.device,
            )
        if cfg.capture_on_anomaly:
            self.capture = obs.AnomalyCapture(
                profile_dir=os.path.join(
                    cfg.checkpoint_dir or cfg.profile_dir, "anomaly"
                ),
                n_steps=cfg.capture_steps, device=self.device,
            )
        guard = (PreemptionGuard().install()
                 if self.checkpoint_manager is not None else None)
        hang_timeout = float(os.environ.get(ENV_HANG_TIMEOUT, "0") or 0)
        if hang_timeout > 0:
            self._watchdog = HangWatchdog(
                hang_timeout,
                dump_path=os.path.join(
                    cfg.checkpoint_dir or ".",
                    f"hang.attempt{current_attempt()}.dump"),
            ).start()
        preempted = False
        try:
            last, preempted = self._fit_loop(dataset, start_step,
                                             total_steps, prof, guard,
                                             run_summaries)
            if self.checkpoint_manager is not None:
                self.checkpoint_manager.wait()
        finally:
            if guard is not None:
                guard.restore()
            if self._watchdog is not None:
                self._watchdog.stop()
                self._watchdog = None
            if prof is not None:
                prof.stop()
            if self.capture is not None:
                # A capture window still open at teardown must not
                # leak its profiler.
                self.capture.close()
        goodput = self.goodput.summary()
        self._append_metrics({
            "event": "run_end", "time": time.time(), "step": self.state.step,
            "preempted": preempted, "rolled_back": self._rolled_back,
            "attempt": current_attempt(), "resumed_from_step": start_step,
            "goodput": goodput,
        })
        reg = obs.get_registry()
        reg.emit_snapshot(sink=self._sink(), step=self.state.step)
        reg.write_prometheus()
        return {
            "epochs": run_summaries,
            "final_loss": last.get("loss"),
            "preempted": preempted,
            "rolled_back": self._rolled_back,
            "quiesced": self._quiesced,
            "goodput": goodput,
            "resumed_from_step": start_step,
        }

    def _fit_loop(self, dataset, done: int, total_steps: int, prof, guard,
                  run_summaries: List[Dict]) -> Tuple[Dict, bool]:
        cfg = self.cfg
        spe = cfg.steps_per_epoch
        bs = cfg.global_batch_size
        last: Dict[str, float] = {}
        while done < total_steps:
            if self._watchdog is not None:
                self._watchdog.tick()
            # Elastic quiesce: the coordinator's hook names the step
            # boundary it wants the run stopped at. Reaching it stops
            # the loop with everything live (no save, no exit); a future
            # target caps the chunk so the loop lands exactly on it.
            quiesce_at = None
            if self.quiesce_check is not None:
                quiesce_at = self.quiesce_check(done)
                if quiesce_at is not None and quiesce_at <= done:
                    self._quiesced = True
                    break
            epoch = done // spe
            chunk = min(spe - done % spe, total_steps - done)
            if quiesce_at is not None:
                chunk = min(chunk, quiesce_at - done)
            # A chunk never spans a skip-window boundary: steps before
            # it replay their batches, steps from it on skip the
            # poisoned span of data indices.
            off = 0
            if self._guard_tracked and self._skip_windows:
                off = guard_lib.offset_at(self._skip_windows, done)
                nxt = guard_lib.next_boundary(self._skip_windows, done)
                if nxt is not None:
                    chunk = min(chunk, nxt - done)
            self._fit_offset = off
            if prof is not None:
                # The window opens and closes at chunk boundaries, on
                # the Trainer's step numbers.
                prof.step(done)
            self.meter.reset()
            self.meter.start_batch()
            losses, metrics, health = [], {}, []
            data_s = 0.0
            # Step-boundary range in the profile: one per chunk.
            ann = (prof.annotate(done) if prof is not None
                   else contextlib.nullcontext())
            with self.goodput.measure("productive"), ann:
                for i in range(chunk):
                    t_data = time.perf_counter()
                    batch = dataset.batch_at(done + i + off, bs)
                    data_s += time.perf_counter() - t_data
                    metrics = self.train_step(batch)
                    losses.append(metrics["loss"])
                    if self.guard_policy is not None:
                        health.append(torch.stack([
                            metrics[k].to(torch.float32)
                            for k in guard_lib.HEALTH_KEYS if k in metrics]))
                if self.fault_plan is not None:
                    self.fault_plan.maybe_straggle(done + chunk)
                # ONE host fetch per chunk: the losses of every update,
                # the last update's metrics and every update's health
                # vector.
                dev = losses[0].device
                fetched = torch.cat([
                    torch.stack(losses).to(torch.float32),
                    torch.stack([torch.as_tensor(v, dtype=torch.float32)
                                 .to(dev) for v in metrics.values()]),
                    *health]).tolist()
            chunk_s = self.meter.end_batch(chunk * bs)
            step_losses = fetched[:chunk]
            last = dict(zip(metrics, fetched[chunk:chunk + len(metrics)]))
            keys = [k for k in guard_lib.HEALTH_KEYS if k in metrics]
            rows = fetched[chunk + len(metrics):]
            health_rows = [dict(zip(keys, rows[j:j + len(keys)]))
                           for j in range(0, len(rows), len(keys) or 1)]
            done += chunk
            s_per_step = chunk_s / max(chunk, 1)
            tid = obs.step_trace_id(done)
            obs.emit_span("compute", max(chunk_s - data_s, 0.0),
                          sink=self._sink(), step=done, n=chunk,
                          hist="train_compute_s", trace_id=tid)
            if data_s > 0:
                obs.emit_span("data", data_s, sink=self._sink(), step=done,
                              n=chunk, hist="train_data_s", trace_id=tid)
            stall_info = self.stall.observe(done, s_per_step,
                                            sink=self._sink(), trace_id=tid)
            if stall_info is not None and self.capture is not None:
                # Stall -> evidence: one bounded profiler capture +
                # flight dump keyed by this chunk's trace id.
                self.capture.trigger("stall", trace_id=tid, step=done,
                                     sink=self._sink())
            if self.capture is not None:
                self.capture.step(done)
            reg = obs.get_registry()
            reg.inc("train_steps_total", chunk)
            reg.inc("train_items_total", chunk * bs)
            reg.set_gauge("train_step", done)
            reg.observe("train_step_s", s_per_step)
            if self._watchdog is not None:
                self._watchdog.tick()
            if self.heartbeat is not None:
                self.heartbeat.tick(done, **self.stall.heartbeat_extra())
            if self.digest is not None:
                # The digest twin of the heartbeat enrichment: the
                # registry's counters, gauges and sketches and the same
                # (step_s, watermark_s) signal, onto this host's channel.
                self.digest.publish_registry(
                    step=done, **self.stall.digest_extra())
            summary = self.meter.epoch_summary(skip_first=0)
            summary["losses"] = step_losses
            run_summaries.append(summary)
            rec = {
                "event": "epoch", "time": time.time(), "epoch": epoch,
                "step": done, "loss": _json_finite(last["loss"]),
                "items_per_s": summary["items_per_s"],
                "items_per_s_per_device": summary["items_per_s_per_device"],
                "s_per_step": s_per_step,
            }
            if "grad_norm" in last:
                rec["grad_norm"] = _json_finite(last["grad_norm"])
            self._append_metrics(rec)
            reg.set_gauge("train_loss", last["loss"])
            reg.set_gauge("train_items_per_s", summary["items_per_s"])
            reg.write_prometheus()
            # Classify BEFORE the periodic save: a poisoned state must
            # never become the newest snapshot.
            if self.guard_policy is not None and health_rows:
                if self._guard_check(done - chunk, health_rows, off):
                    break
            # Faults fire before the save, so a kill at step N leaves
            # the previous checkpoint as the newest.
            if self.fault_plan is not None:
                self.fault_plan.on_step(done)
            if (self.checkpoint_manager is not None and cfg.save_every
                    and done % (cfg.save_every * spe) == 0):
                self._save(tid, done)
            if guard is not None and self._agree(guard.triggered,
                                                 self.device):
                obs.dump_flight("preempt")
                self._save(tid, done, now=True)
                return last, True
        return last, False

    # -- numeric-health guard -------------------------------------------
    def _guard_dir(self) -> Optional[str]:
        """Where guard state (skip windows) persists: next to the
        checkpoints it rolls back to."""
        return (getattr(self.checkpoint_manager, "directory", None)
                or self.cfg.checkpoint_dir)

    def _guard_check(self, chunk_start: int, rows: List[Dict],
                     offset: int) -> bool:
        """Classify the chunk's health rows; emit ``guard_verdict``
        events and counters; on a verdict the policy wants rolled back,
        roll back and return True (the fit loop stops)."""
        policy = self.guard_policy
        reg = obs.get_registry()
        last_bad = rollback_at = None
        for i, row in enumerate(rows):
            step = chunk_start + i
            verdict = policy.classify(step, row)
            if verdict.skipped:
                reg.inc("guard_skipped_total")
            if verdict.healthy:
                continue
            reg.inc(f"guard_{verdict.verdict}_total")
            wants = policy.wants_rollback(verdict)
            rec = {
                "event": "guard_verdict", "step": step,
                "trace_id": obs.step_trace_id(step),
                "verdict": verdict.verdict,
                "action": ("rollback" if wants
                           else "skip" if verdict.skipped else "event"),
                "grad_norm": _json_finite(verdict.grad_norm),
                "update_norm": _json_finite(verdict.update_norm),
                "loss_finite": verdict.loss_finite,
                "nonfinite": verdict.nonfinite,
                "data_index": step + offset,
            }
            if verdict.watermark is not None:
                rec["watermark"] = verdict.watermark
            if verdict.ratio is not None:
                rec["ratio"] = verdict.ratio
            self._append_metrics(rec)
            if self.capture is not None and verdict.verdict == "poisoned":
                # Poisoned step -> evidence bundle keyed by the
                # poisoned step's trace id (the rollback also dumps the
                # ring; the bundle adds the memory state and, when the
                # run goes on in skip mode, a bounded profiler window).
                self.capture.trigger("guard_poisoned",
                                     trace_id=obs.step_trace_id(step),
                                     step=step, sink=self._sink())
            # The window anchors at the first verdict that DEMANDS a
            # rollback; an earlier event-only spike was fine to train
            # through by policy.
            if rollback_at is None and wants:
                rollback_at = step
            if rollback_at is not None:
                last_bad = step
        if rollback_at is None:
            return False
        self._guard_rollback(rollback_at, last_bad, offset)
        return True

    def _guard_rollback(self, first_bad: int, last_bad: int,
                        offset: int) -> None:
        """Rollback-to-last-good: quarantine any snapshot holding the
        anomaly, persist the skip window over the poisoned data
        indices, and mark the fit rolled back (the caller exits
        EXIT_ROLLBACK; the relaunch resumes from the last good
        checkpoint)."""
        mgr = self.checkpoint_manager
        steps = sorted(mgr.all_steps() or [])
        good = [s for s in steps if s <= first_bad]
        if not good:
            raise guard_lib.GuardError(
                f"guard rollback needed at step {first_bad} but no "
                f"checkpoint predates the anomaly (steps on disk: "
                f"{steps}) -- save more often than anomalies arrive "
                "(cfg.save_every), or run guard_mode='skip'"
            )
        # A snapshot taken at step S holds S updates, so any S >
        # first_bad contains the poisoned one.
        quarantined = [s for s in steps if s > first_bad and
                       mgr.quarantine_step(s, reason="poisoned") is not None]
        window = {"from_step": int(first_bad),
                  "data_from": int(first_bad + offset),
                  "data_to": int(last_bad + offset)}
        n_rollbacks = None
        if _rank() == 0:
            n_rollbacks = guard_lib.record_rollback(self._guard_dir(),
                                                    window)["rollbacks"]
        if _world() > 1:
            import torch.distributed as dist

            dist.barrier()  # rank 0's renames and window file land first
        obs.get_registry().inc("guard_rollbacks_total")
        rec = {
            "event": "guard_rollback", "step": last_bad + 1,
            "trace_id": obs.step_trace_id(first_bad),
            "to_step": int(max(good)), "first_bad": int(first_bad),
            "last_bad": int(last_bad), "data_from": window["data_from"],
            "data_to": window["data_to"], "quarantined": quarantined,
        }
        if n_rollbacks is not None:
            rec["n_rollbacks"] = n_rollbacks
        self._append_metrics(rec)
        obs.dump_flight("guard_rollback")
        self._rolled_back = True
