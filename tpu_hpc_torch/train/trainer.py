"""The Trainer: forward, backward and optimizer update on one device.

Port of the single-device path of the JAX package's
``train/trainer.py``: ``TrainState``, ``make_lr_schedule``,
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

Not ported yet, and refused by ``Trainer`` when set (ROADMAP): a
checkpoint manager, ``guard_mode != "off"``, ``comm_mode != "flat"``,
``profile``, ``capture_on_anomaly``, fault plans from
``$TPU_HPC_FAULTS``, and any mesh above one device.
"""
from __future__ import annotations

import dataclasses
import math
import os
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from tpu_hpc_torch import obs
from tpu_hpc_torch.config import TrainingConfig
from tpu_hpc_torch.models.datasets import step_seed
from tpu_hpc_torch.parallel.tp import mesh_size
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


def clip_by_global_norm(grads: List[torch.Tensor],
                        max_norm: float) -> List[torch.Tensor]:
    """optax.clip_by_global_norm: leaves unchanged when the norm is
    below ``max_norm``, else ``g / norm * max_norm`` -- no epsilon, and
    no host sync (the choice is a ``torch.where`` on the device)."""
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
              state: Dict[str, Any]) -> Dict[str, Any]:
        """Update ``params`` in place; returns the new state (its moment
        tensors are updated in place too)."""
        if self.max_grad_norm > 0:
            grads = clip_by_global_norm(grads, self.max_grad_norm)
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
    def apply(self, params, grads, state):
        if self.max_grad_norm > 0:
            grads = clip_by_global_norm(grads, self.max_grad_norm)
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
) -> Callable[[TrainState, Any], Tuple[TrainState, Dict]]:
    """The training step: forward, backward, optimizer update.

    ``grad_accum > 1`` splits the batch into that many microbatches
    (rows ``[i*m, (i+1)*m)``, as the JAX reshape does), sums their
    gradients and applies ONE update with the mean gradient and the
    mean loss -- the full batch's trajectory at 1/grad_accum of the
    activation memory. ``log_grad_norm`` adds the pre-clip global norm
    of that mean gradient as ``metrics["grad_norm"]``. Metrics stay on
    the device; nothing here waits for the card.
    """

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
            mb = tuple(a[i * micro:(i + 1) * micro] for a in batch)
            rng = torch.Generator().manual_seed(step_seed(step_gen, i))
            loss, ms, aux = forward(state.params, ms, mb, rng)
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
        if grad_accum > 1:
            grads = [g / grad_accum for g in grads]
            lsum = lsum / grad_accum
            aux_sum = {k: v / grad_accum for k, v in aux_sum.items()}
        metrics = {"loss": lsum, **aux_sum}
        if log_grad_norm:
            if "grad_norm" in aux_sum:
                raise ValueError(
                    "forward() reports an aux metric named 'grad_norm', "
                    "which collides with the optimizer-level norm logged "
                    "when max_grad_norm > 0 -- rename the aux metric"
                )
            metrics["grad_norm"] = global_norm(grads)
        opt_state = optimizer.apply(leaves, grads, state.opt_state)
        for p in leaves:
            p.grad = None
        return TrainState(state.step + 1, state.params, opt_state, ms), metrics

    return step


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

def _refuse_unported(cfg: TrainingConfig, mesh, checkpoint_manager) -> None:
    refused = []
    if mesh_size(mesh) > 1:
        refused.append(f"a mesh of {mesh_size(mesh)} devices "
                       "(ROADMAP queue 1 item 5)")
    if checkpoint_manager is not None:
        refused.append("checkpoint_manager (ROADMAP queue 1 item 7)")
    if cfg.guard_mode != "off":
        refused.append(f"guard_mode={cfg.guard_mode!r} (ROADMAP queue 1 item 4)")
    if cfg.comm_mode != "flat":
        refused.append(f"comm_mode={cfg.comm_mode!r} (ROADMAP queue 1 item 11)")
    if cfg.profile:
        refused.append("profile=True (ROADMAP queue 1 item 7)")
    if cfg.capture_on_anomaly:
        refused.append("capture_on_anomaly=True (ROADMAP queue 1 item 8)")
    if os.environ.get(ENV_FAULTS):
        refused.append(f"${ENV_FAULTS} fault plans (ROADMAP queue 1 item 7)")
    if refused:
        raise NotImplementedError(
            "not ported yet in tpu_hpc_torch.train: " + "; ".join(refused)
        )


class Trainer:
    def __init__(
        self,
        cfg: TrainingConfig,
        mesh: Any,
        forward: ForwardFn,
        params: Any,
        model_state: Any = None,
        optimizer: Any = None,
        checkpoint_manager: Any = None,
        eval_forward: Optional[Callable] = None,
        device: Any = None,
    ):
        """``mesh``: None (or a one-device mesh) -- the only layout this
        slice ports. ``params``: a nested dict of tensors; the trainer
        keeps its own copies on ``device`` (default: the params'
        device) with ``requires_grad``, so the caller's tensors are
        never updated in place. ``eval_forward(params, model_state,
        batch) -> (loss, aux)`` defaults to the training forward with
        state updates discarded."""
        _refuse_unported(cfg, mesh, checkpoint_manager)
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
        first = tree_leaves(params)[0]
        self.device = resolve_device(device if device is not None
                                     else first.device)
        params = tree_map(
            lambda t: t.detach().to(self.device).clone().requires_grad_(True),
            params,
        )
        self.optimizer = optimizer or make_optimizer(cfg)
        self.state = TrainState(
            step=0, params=params, opt_state=self.optimizer.init(params),
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
        )
        self.meter = ThroughputMeter(n_devices=1, device=self.device)
        self.goodput = GoodputMeter()
        self._adopted = False

    def adopt_state(self, state: TrainState) -> None:
        """Adopt a live state (e.g. :func:`state_from_numpy`'s): its
        params and optimizer state must already lie on this trainer's
        device. ``fit`` then continues from ``state.step``."""
        self.state = state
        self._adopted = True

    def _to_device(self, batch):
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
        for i in range(n_steps):
            loss, aux = self.eval_forward(
                self.state.params, self.state.model_state,
                self._to_device(dataset.batch_at(i, bs)),
            )
            for k, v in {"loss": loss, **aux}.items():
                v = torch.as_tensor(v).detach().to(torch.float32)
                sums[k] = sums[k] + v if k in sums else v
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
            "n_devices": 1, "n_processes": 1,
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
