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
``data``), each data rank takes its rows of the global batch, and the
optimizer runs on each rank's shards -- the same optax arithmetic, with
the clip norm taken over the whole gradient.

Not ported yet, and refused by ``Trainer`` when set (ROADMAP queue 1):
a checkpoint manager, ``guard_mode != "off"``, ``comm_mode != "flat"``,
``profile``, ``capture_on_anomaly`` and fault plans from
``$TPU_HPC_FAULTS``.
"""
from __future__ import annotations

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
from tpu_hpc_torch.runtime import resolve_device
from tpu_hpc_torch.train.metrics import GoodputMeter, ThroughputMeter

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

# forward(params, model_state, batch, step_rng) -> (loss, new_model_state, aux)
ForwardFn = Callable[[Any, Any, Any, torch.Generator],
                     Tuple[torch.Tensor, Any, Dict]]
Schedule = Callable[[int], float]
ENV_FAULTS = "TPU_HPC_FAULTS"


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


def _copies(t) -> int:
    """Ranks that hold the same shard of ``t``: the world over the
    number of distinct shards (a plain tensor is whole on every rank)."""
    import torch.distributed as dist

    shards = 1
    if is_dtensor(t):
        mesh = t.device_mesh
        for i, p in enumerate(t.placements):
            if p.is_shard():
                shards *= mesh.size(i)
    return dist.get_world_size() // shards


def sharded_global_norm(grads: List[torch.Tensor],
                        copies: List[int]) -> torch.Tensor:
    """:func:`global_norm` of the WHOLE gradient when ``grads`` are this
    rank's shards and ``copies[i]`` ranks hold shard i (:func:`_copies`):
    each rank sums its shards' squares, each divided by its number of
    copies, and one all-reduce adds the ranks up -- the same norm on
    every rank, so every rank clips alike."""
    import torch.distributed as dist

    total = sum(torch.sum(g.to(torch.float32) ** 2) / c
                for g, c in zip(grads, copies))
    dist.all_reduce(total)
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


@dataclasses.dataclass(frozen=True)
class AdamW:
    """optax.adamw(lr, b1, b2, eps, weight_decay) with decoupled weight
    decay on every leaf, bias correction, and both moments stored in
    ``moments_dtype``; ``max_grad_norm > 0`` clips first (optax.chain's
    order). State: ``count`` (updates applied), ``mu``, ``nu`` (lists
    aligned with :func:`tree_leaves` of the params)."""

    learning_rate: Schedule
    weight_decay: float
    moments_dtype: torch.dtype = torch.float32
    max_grad_norm: float = 0.0
    b1 = 0.9     # optax.adamw's defaults, the only values the JAX
    b2 = 0.999   # Trainer uses (class constants, not fields)
    eps = 1e-8

    def init(self, params) -> Dict[str, Any]:
        leaves = tree_leaves(params)
        zeros = lambda p: torch.zeros_like(  # noqa: E731
            p, dtype=self.moments_dtype, requires_grad=False)
        return {"count": 0, "mu": [zeros(p) for p in leaves],
                "nu": [zeros(p) for p in leaves]}

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
        step_size = -float(self.learning_rate(n))
        count = n + 1
        one = torch.tensor(1.0, dtype=torch.float32)
        bc1 = float(one - torch.tensor(self.b1, dtype=torch.float32) ** count)
        bc2 = float(one - torch.tensor(self.b2, dtype=torch.float32) ** count)
        b1, b2, wd = self.b1, self.b2, self.weight_decay
        # optax multiplies the stored moment by its decay with the
        # decay taken in the moment's own dtype (a weak-typed Python
        # scalar takes the array's dtype); under jit, XLA then keeps the
        # product and the sum in fp32. With bf16 moments that makes b1
        # 0.8984375 and b2 exactly 1.0 -- nu never decays. The port keeps
        # the reference's arithmetic (ROADMAP queue 3).
        d1 = float(torch.tensor(b1, dtype=self.moments_dtype))
        d2 = float(torch.tensor(b2, dtype=self.moments_dtype))
        for p, g, mu, nu in zip(params, grads, state["mu"], state["nu"]):
            g = g.to(torch.float32)
            m = (1 - b1) * g + d1 * mu.to(torch.float32)
            v = (1 - b2) * (g * g) + d2 * nu.to(torch.float32)
            u = (m / bc1) / (torch.sqrt(v / bc2) + self.eps)
            u = u + wd * p
            p.add_(step_size * u)
            mu.copy_(m)
            nu.copy_(v)
        return {**state, "count": count}


@dataclasses.dataclass(frozen=True)
class SGD:
    """optax.sgd(lr, momentum): trace = g + momentum * trace, then
    p -= lr * trace; ``max_grad_norm > 0`` clips first."""

    learning_rate: Schedule
    momentum: float = 0.9
    max_grad_norm: float = 0.0

    def init(self, params) -> Dict[str, Any]:
        return {"count": 0, "trace": [
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
) -> Callable[[TrainState, Any], Tuple[TrainState, Dict]]:
    """The training step: forward, backward, optimizer update.

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
    over ``data``; the loss metric is averaged over the ranks; the norm
    is the whole gradient's (:func:`sharded_global_norm`); and the
    optimizer updates each rank's shards in place, its moments shaped
    like them.
    """
    sharded = module is not None
    need_norm = log_grad_norm or (
        sharded and getattr(optimizer, "max_grad_norm", 0) > 0)

    def step(state: TrainState, batch) -> Tuple[TrainState, Dict]:
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
        ms = state.model_state
        lsum, aux_sum = None, {}
        for i in range(grad_accum):
            if sharded and hasattr(module, "set_requires_gradient_sync"):
                module.set_requires_gradient_sync(i == grad_accum - 1)
            mb = tuple(a[i * micro:(i + 1) * micro] for a in batch)
            rng = torch.Generator().manual_seed(step_seed(step_gen, i))
            loss, ms, aux = forward(module if sharded else state.params,
                                    ms, mb, rng)
            loss.backward()
            loss = loss.detach()
            lsum = loss if lsum is None else lsum + loss
            for k, v in aux.items():
                v = torch.as_tensor(v).detach()
                aux_sum[k] = v if k not in aux_sum else aux_sum[k] + v
        grads = [
            torch.zeros_like(p) if p.grad is None else p.grad
            for p in leaves
        ]
        with torch.no_grad():
            copies = [_copies(g) for g in grads] if sharded else None
            grads = [local(g) for g in grads]
            params = [local(p) for p in leaves]
        if grad_accum > 1:
            grads = [g / grad_accum for g in grads]
            lsum = lsum / grad_accum
            aux_sum = {k: v / grad_accum for k, v in aux_sum.items()}
        metrics = {"loss": lsum, **aux_sum}
        if sharded:
            metrics = {k: _rank_mean(v) for k, v in metrics.items()}
        if log_grad_norm and "grad_norm" in aux_sum:
            raise ValueError(
                "forward() reports an aux metric named 'grad_norm', "
                "which collides with the optimizer-level norm logged "
                "when max_grad_norm > 0 -- rename the aux metric"
            )
        norm = None
        if need_norm:
            norm = (sharded_global_norm(grads, copies) if sharded
                    else global_norm(grads))
        if log_grad_norm:
            metrics["grad_norm"] = norm
        opt_state = optimizer.apply(params, grads, state.opt_state,
                                    norm=norm)
        for p in leaves:
            p.grad = None
        return TrainState(state.step + 1, state.params, opt_state, ms), metrics

    return step


def _rank_mean(v: torch.Tensor) -> torch.Tensor:
    """The mean of a metric over the process group (each data rank's
    mean over its rows; equal rows per rank make it the global mean)."""
    import torch.distributed as dist

    v = v.to(torch.float32).clone()
    dist.all_reduce(v)
    return v / dist.get_world_size()


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

def _refuse_unported(cfg: TrainingConfig, checkpoint_manager) -> None:
    refused = []
    if checkpoint_manager is not None:
        refused.append("checkpoint_manager (ROADMAP queue 1 item 4)")
    if cfg.guard_mode != "off":
        refused.append(f"guard_mode={cfg.guard_mode!r} (ROADMAP queue 1 item 3)")
    if cfg.comm_mode != "flat":
        refused.append(f"comm_mode={cfg.comm_mode!r} (ROADMAP queue 1 item 8)")
    if cfg.profile:
        refused.append("profile=True (ROADMAP queue 1 item 4)")
    if cfg.capture_on_anomaly:
        refused.append("capture_on_anomaly=True (ROADMAP queue 1 item 5)")
    if os.environ.get(ENV_FAULTS):
        refused.append(f"${ENV_FAULTS} fault plans (ROADMAP queue 1 item 4)")
    if refused:
        raise NotImplementedError(
            "not ported yet in tpu_hpc_torch.train: " + "; ".join(refused)
        )


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
        the same rows. ``device`` defaults to the mesh's device type
        (or the params' device).

        ``eval_forward(params, model_state, batch) -> (loss, aux)``
        defaults to the training forward with state updates
        discarded."""
        _refuse_unported(cfg, checkpoint_manager)
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
        self.mesh = mesh if _is_device_mesh(mesh) else None
        self.module = None
        self._data_shards, self._data_rank = 1, 0
        if self.mesh is not None:
            self.device = resolve_device(
                device if device is not None else self.mesh.device_type)
            if param_pspecs is None:
                param_pspecs = dp.param_pspecs(params)
            self.module = shard_params(params, self.mesh, param_pspecs,
                                       device=self.device)
            params = self.module.tree()
            axis = batch_pspec[0] if len(batch_pspec) else None
            if axis is not None and axis in self.mesh.mesh_dim_names:
                self._data_shards = self.mesh[axis].size()
                self._data_rank = self.mesh[axis].get_local_rank()
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
        self.state = TrainState(
            step=0, params=params,
            opt_state=self.optimizer.init(_local_tree(params)),
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
        )
        self.n_devices = self.mesh.size() if self.mesh is not None else 1
        self.meter = ThroughputMeter(n_devices=self.n_devices,
                                     device=self.device)
        self.goodput = GoodputMeter()
        self._adopted = False

    def gather_params(self) -> Dict[str, Any]:
        """The whole param tree as numpy arrays, on every rank
        (collective on a mesh)."""
        return gather_params(self.state.params)

    def adopt_state(self, state: TrainState) -> None:
        """Adopt a live state (e.g. :func:`state_from_numpy`'s): its
        params and optimizer state must already lie on this trainer's
        device. ``fit`` then continues from ``state.step``."""
        self.state = state
        self._adopted = True

    def _to_device(self, batch):
        """The global batch -> this rank's rows on the device: of each
        of the ``grad_accum`` microbatches, the data rank's slice."""
        n, r = self._data_shards, self._data_rank
        if n > 1:
            accum = self.cfg.grad_accum_steps
            batch = tuple(
                a.reshape(accum, n, a.shape[0] // (accum * n), *a.shape[1:])
                [:, r].reshape(-1, *a.shape[1:]) for a in batch)
        return tuple(a.to(self.device, non_blocking=True) for a in batch)

    def train_step(self, batch) -> Dict[str, torch.Tensor]:
        """One optimizer update on a global batch; metrics stay on the
        device."""
        self.state, metrics = self._step(self.state, self._to_device(batch))
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
        if self.module is not None:
            sums = {k: _rank_mean(v) for k, v in sums.items()}
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

    def _append_metrics(self, record: Dict) -> None:
        """The run log (``cfg.metrics_path``) through the obs bus:
        schema-stamped, held in the flight ring, appended to the file
        when one is configured."""
        obs.get_bus().emit_record(record, sink=self.cfg.metrics_path or None)

    def fit(self, dataset, epochs: Optional[int] = None) -> Dict:
        """Epoch loop with throughput instrumentation. Dataset contract:
        ``batch_at(step, global_batch)``. Each epoch is timed from a
        synchronized start to the synchronized fetch of its metrics, so
        an epoch's ``items_per_s`` is the card's rate, host batch
        generation included. Returns the JAX result keys: ``epochs``
        (one meter summary per epoch, plus the loss of every update
        under ``losses``), ``final_loss``, ``preempted``,
        ``rolled_back``, ``quiesced``, ``goodput``."""
        cfg = self.cfg
        epochs = epochs or cfg.epochs
        if epochs != cfg.epochs and cfg.lr_schedule == "cosine":
            raise ValueError(
                f"fit(epochs={epochs}) conflicts with lr_schedule="
                f"'cosine' sized for cfg.epochs={cfg.epochs}: set "
                "cfg.epochs to the intended run length instead"
            )
        self.goodput = GoodputMeter()
        start_step = self.state.step if self._adopted else 0
        spe = cfg.steps_per_epoch
        total_steps = epochs * spe
        bs = cfg.global_batch_size
        self._append_metrics({
            "event": "run_start", "time": time.time(),
            "start_step": start_step, "total_steps": total_steps,
            "n_devices": self.n_devices, "n_processes": self.n_devices,
            "device_kind": (torch.cuda.get_device_name(self.device)
                            if self.device.type == "cuda" else "cpu"),
            "jax_version": None, "torch_version": torch.__version__,
            "config": dataclasses.asdict(dataclasses.replace(cfg, epochs=epochs)),
        })
        run_summaries: List[Dict] = []
        last: Dict[str, float] = {}
        done = start_step
        while done < total_steps:
            epoch = done // spe
            chunk = min(spe - done % spe, total_steps - done)
            self.meter.reset()
            self.meter.start_batch()
            losses, metrics = [], {}
            with self.goodput.measure("productive"):
                for i in range(chunk):
                    metrics = self.train_step(dataset.batch_at(done + i, bs))
                    losses.append(metrics["loss"])
                # ONE host fetch per chunk: the losses of every update
                # and the last update's metrics.
                fetched = torch.stack(
                    losses + [torch.as_tensor(v, dtype=torch.float32)
                              .to(losses[0].device)
                              for v in metrics.values()]
                ).tolist()
            self.meter.end_batch(chunk * bs)
            step_losses = fetched[:chunk]
            last = dict(zip(metrics, fetched[chunk:]))
            done += chunk
            summary = self.meter.epoch_summary(skip_first=0)
            summary["losses"] = step_losses
            run_summaries.append(summary)
            rec = {
                "event": "epoch", "time": time.time(), "epoch": epoch,
                "step": done,
                "loss": last["loss"] if math.isfinite(last["loss"]) else None,
                "items_per_s": summary["items_per_s"],
                "items_per_s_per_device": summary["items_per_s_per_device"],
                "s_per_step": summary["total_s"] / max(chunk, 1),
            }
            if "grad_norm" in last:
                rec["grad_norm"] = last["grad_norm"]
            self._append_metrics(rec)
        goodput = self.goodput.summary()
        self._append_metrics({
            "event": "run_end", "time": time.time(), "step": self.state.step,
            "preempted": False, "rolled_back": False, "attempt": 0,
            "resumed_from_step": start_step, "goodput": goodput,
        })
        return {
            "epochs": run_summaries,
            "final_loss": last.get("loss"),
            "preempted": False,
            "rolled_back": False,
            "quiesced": False,
            "goodput": goodput,
        }
