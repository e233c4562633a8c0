"""ResNet-18/34/50/101/152, and the vision models' shared layers.

Port of the JAX package's ``models/resnet.py``: BasicBlock (18/34) and
Bottleneck (expansion 4; 50/101/152) post-activation residual blocks,
the CIFAR stem (3x3 stride-1 conv, no max-pool) or the ImageNet one (7x7
stride-2 conv, 3x3 stride-2 SAME max-pool), global average pool and a
Dense head; ``init``/``apply``/``make_forward``/``make_eval_forward``
keep the JAX contract (params and ``model_state`` trees, NHWC batches).

The layers the U-Net, the ViT and the domain-parallel U-Net share live
here too:

* :func:`conv2d_same` and :func:`max_pool_same`: flax ``padding="SAME"``,
  which is asymmetric when the total pad is odd -- a 3x3 stride-2 conv
  on an even extent pads (0, 1), the 7x7 stride-2 stem (2, 3) -- so the
  pads are explicit (``F.pad``), never ``padding=k // 2``.
* The BatchNorm of flax ``nn.BatchNorm`` (:func:`batch_norm`, built from
  :func:`bn_moments`, :func:`bn_normalize`, :func:`bn_running`): the
  moments of the batch in float32 whatever the compute dtype, the
  *biased* variance ``max(E[x^2] - E[x]^2, 0)`` both to normalise and
  in the running average (torch's ``running_var`` keeps the unbiased
  one, so torch's running-stat update is not used), running stats as
  ``ra = 0.9 ra + 0.1 batch`` (flax momentum 0.9, torch's 0.1), eps
  1e-5, the output cast back to the compute dtype. ``all_sum`` sums
  the per-channel sums, sums of squares and counts over a process
  group (:func:`group_sum`): the moments of the global batch, as one
  jit over the global batch gives the JAX data-parallel run, or of the
  whole grid for the domain-parallel U-Net.

Layout: batches are NHWC ``[B, H, W, C]`` at every model boundary, as
in JAX. Inside, activations are NCHW tensors in ``channels_last``
memory (the NHWC input's ``permute(0, 3, 1, 2)`` is that view, no
copy). Conv kernels are stored OIHW (flax's are HWIO:
:func:`params_from_numpy` transposes), Dense kernels ``[in, out]`` as in
flax; both are kept in ``param_dtype`` and cast to the compute dtype at
use, as flax's ``dtype=`` does.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

BN_MOMENTUM = 0.9   # flax's: the fraction of the old average kept
BN_EPS = 1e-5

STAGE_SIZES = {
    18: (2, 2, 2, 2),
    34: (3, 4, 6, 3),
    50: (3, 4, 6, 3),
    101: (3, 4, 23, 3),
    152: (3, 8, 36, 3),
}

AllSum = Optional[Callable[[torch.Tensor], torch.Tensor]]


@dataclasses.dataclass(frozen=True)
class ResNetConfig:
    depth: int = 18
    num_classes: int = 10
    # CIFAR stem: 3x3 stride-1 conv1, no max-pool. False: the ImageNet
    # 7x7 stride-2 conv and 3x3 stride-2 max-pool.
    cifar_stem: bool = True
    dtype: Any = torch.float32        # compute dtype
    param_dtype: Any = torch.float32  # storage dtype

    @property
    def stage_sizes(self) -> Sequence[int]:
        return STAGE_SIZES[self.depth]

    @property
    def bottleneck(self) -> bool:
        return self.depth >= 50


# ---------------------------------------------------------------------
# Shared layers
# ---------------------------------------------------------------------

def same_pads(size: int, k: int, s: int) -> Tuple[int, int]:
    """XLA's SAME split of the total pad ``max((ceil(size/s) - 1) s + k
    - size, 0)``: ``lo = total // 2``, the odd row at the end."""
    out = -(-size // s)
    total = max((out - 1) * s + k - size, 0)
    return total // 2, total - total // 2


def nchw(x: torch.Tensor) -> torch.Tensor:
    """An NHWC batch as the NCHW ``channels_last`` view (no copy)."""
    return x.permute(0, 3, 1, 2)


def nhwc(x: torch.Tensor) -> torch.Tensor:
    """The inverse of :func:`nchw` (contiguous when ``x`` is
    ``channels_last``)."""
    return x.permute(0, 2, 3, 1)


def wide(t: torch.Tensor) -> torch.Tensor:
    """``t`` in at least float32 (float64 stays float64), as flax
    promotes its norms' statistics."""
    return t.to(torch.promote_types(t.dtype, torch.float32))


def _weight(kernel: torch.Tensor, dtype) -> torch.Tensor:
    return kernel.to(dtype).contiguous(memory_format=torch.channels_last)


def conv2d(x: torch.Tensor, kernel: torch.Tensor,
           bias: Optional[torch.Tensor] = None, stride: int = 1,
           pads: Tuple[int, int, int, int] = (0, 0, 0, 0)) -> torch.Tensor:
    """NCHW conv in ``x``'s dtype (kernel and bias cast to it) with the
    explicit ``pads`` (top, bottom, left, right); symmetric pads go to
    the conv itself, asymmetric ones through ``F.pad``."""
    top, bottom, left, right = pads
    if kernel.shape[2] == kernel.shape[3] == 1 and stride > 1 and not any(
            pads):
        # A strided 1x1 conv reads every s-th pixel: take them first.
        # (torch 2.13's CPU backward of a strided 1x1 conv over a
        # channels_last view corrupts the heap.)
        x, stride = x[:, :, ::stride, ::stride], 1
    w = _weight(kernel, x.dtype)
    b = None if bias is None else bias.to(x.dtype)
    if top == bottom and left == right:
        return F.conv2d(x, w, b, stride=stride, padding=(top, left))
    return F.conv2d(F.pad(x, (left, right, top, bottom)), w, b,
                    stride=stride)


def conv2d_same(x: torch.Tensor, kernel: torch.Tensor,
                bias: Optional[torch.Tensor] = None,
                stride: int = 1) -> torch.Tensor:
    """flax ``nn.Conv(padding="SAME")`` on an NCHW tensor, OIHW kernel."""
    kh, kw = kernel.shape[2], kernel.shape[3]
    pads = (*same_pads(x.shape[2], kh, stride),
            *same_pads(x.shape[3], kw, stride))
    return conv2d(x, kernel, bias, stride, pads)


def max_pool_same(x: torch.Tensor, k: int, s: int) -> torch.Tensor:
    """flax ``nn.max_pool(padding="SAME")``: -inf pads, split as XLA's."""
    top, bottom = same_pads(x.shape[2], k, s)
    left, right = same_pads(x.shape[3], k, s)
    if top or bottom or left or right:
        x = F.pad(x, (left, right, top, bottom), value=float("-inf"))
    return F.max_pool2d(x, k, s)


def dense(x: torch.Tensor, p: Dict[str, torch.Tensor], dtype) -> torch.Tensor:
    """flax ``nn.Dense(dtype=...)``: ``x @ kernel + bias`` in ``dtype``
    (kernel ``[in, out]``)."""
    y = x.to(dtype) @ p["kernel"].to(dtype)
    if "bias" in p:
        y = y + p["bias"].to(dtype)
    return y


def group_sum(group=None) -> AllSum:
    """A differentiable sum over ``group``'s ranks (its backward sums
    the gradients the same way); None with no process group. A one-rank
    group still issues the all-reduce, as a data-parallel world of n
    does."""
    import torch.distributed as dist

    if not dist.is_initialized():
        return None
    group = group if group is not None else dist.group.WORLD
    return lambda t: _GroupSum.apply(t, group)


def _all_reduce(t: torch.Tensor, group) -> torch.Tensor:
    from torch.distributed import _functional_collectives as funcol

    return funcol.wait_tensor(funcol.all_reduce(t.contiguous(), "sum",
                                                group))


class _GroupSum(torch.autograd.Function):
    """The sum over a group's ranks; its adjoint sums the gradients."""

    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        return _all_reduce(t, group)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.group), None


def bn_moments(xs: Sequence[torch.Tensor], all_sum: AllSum = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The batch's per-channel mean and biased variance in float32, over
    every NCHW tensor of ``xs`` (the tiles a process holds) and, with
    ``all_sum``, over the ranks: ONE sum of the stacked sums, sums of
    squares and element counts."""
    c = xs[0].shape[1]
    acc = None
    for x in xs:
        xf = wide(x)
        part = torch.cat([xf.sum((0, 2, 3)), xf.square().sum((0, 2, 3)),
                          xf.new_full((1,), x.numel() // c)])
        acc = part if acc is None else acc + part
    if all_sum is not None:
        acc = all_sum(acc)
    n = acc[2 * c]
    mean = acc[:c] / n
    var = torch.clamp_min(acc[c:2 * c] / n - mean.square(), 0.0)
    return mean, var


def bn_normalize(x: torch.Tensor, mean: torch.Tensor, var: torch.Tensor,
                 p: Dict[str, torch.Tensor], eps: float = BN_EPS
                 ) -> torch.Tensor:
    """flax's ``_normalize``: ``(x - mean) * (rsqrt(var + eps) * scale)
    + bias`` in float32, cast back to ``x``'s dtype."""
    mul = torch.rsqrt(var + eps) * wide(p["scale"])
    y = (wide(x) - mean[:, None, None]) * mul[:, None, None]
    return (y + wide(p["bias"])[:, None, None]).to(x.dtype)


def bn_running(ra: Dict[str, torch.Tensor], mean: torch.Tensor,
               var: torch.Tensor, momentum: float = BN_MOMENTUM
               ) -> Dict[str, torch.Tensor]:
    """flax's running-average update, on the biased batch variance; the
    stats carry no gradient."""
    return {"mean": momentum * ra["mean"] + (1 - momentum) * mean.detach(),
            "var": momentum * ra["var"] + (1 - momentum) * var.detach()}


def batch_norm(x: torch.Tensor, p: Dict[str, torch.Tensor],
               ra: Dict[str, torch.Tensor], train: bool,
               all_sum: AllSum = None, eps: float = BN_EPS,
               momentum: float = BN_MOMENTUM
               ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """flax ``nn.BatchNorm`` on an NCHW tensor: (output, new running
    stats). ``train`` normalises with the batch's moments (summed over
    ``all_sum``'s ranks) and updates the stats; otherwise the stored
    stats normalise and come back as they were."""
    if not train:
        return bn_normalize(x, ra["mean"], ra["var"], p, eps), ra
    mean, var = bn_moments([x], all_sum)
    return bn_normalize(x, mean, var, p, eps), bn_running(ra, mean, var,
                                                          momentum)


# ---------------------------------------------------------------------
# Param trees
# ---------------------------------------------------------------------

def tree_map(fn, tree):
    return {k: tree_map(fn, v) if isinstance(v, dict) else fn(k, v)
            for k, v in tree.items()}


def params_from_numpy(tree, dtype=torch.float32, device="cpu") -> Dict:
    """A flax param (or ``batch_stats``) tree of numpy arrays -> the
    port's, same keys, in ``dtype`` on ``device``: 4-D conv kernels HWIO
    -> OIHW; Dense kernels (``[in, out]``), biases, BatchNorm
    scale/bias/mean/var and embeddings as they are."""
    def leaf(name, a):
        a = np.asarray(a, dtype=np.float32)
        if name == "kernel" and a.ndim == 4:
            a = a.transpose(3, 2, 0, 1)
        return torch.from_numpy(np.array(a, order="C")).to(
            device=device, dtype=dtype)

    return tree_map(leaf, dict(tree))


def state_from_numpy(model_state, device="cpu") -> Dict:
    """A flax ``model_state`` (``{"batch_stats": ...}``) -> float32
    tensors on ``device``."""
    return params_from_numpy(model_state, torch.float32, device)


def params_to_numpy(tree) -> Dict:
    """The inverse of :func:`params_from_numpy` (float32 numpy, conv
    kernels back to HWIO): how a test holds port gradients or params
    against the JAX tree."""
    def leaf(name, t):
        a = t.detach().to("cpu", torch.float32).numpy()
        return a.transpose(2, 3, 1, 0) if name == "kernel" and a.ndim == 4 \
            else a

    return tree_map(leaf, tree)


def _normal(gen, shape, std, dtype, device):
    return (torch.randn(shape, generator=gen, device=device) * std).to(dtype)


def init_conv(gen, cin, cout, k, dtype, device, bias=False) -> Dict:
    """LeCun-normal OIHW kernel (flax's default fan-in scale), zero
    bias."""
    p = {"kernel": _normal(gen, (cout, cin, k, k),
                           1.0 / math.sqrt(cin * k * k), dtype, device)}
    if bias:
        p["bias"] = torch.zeros(cout, dtype=dtype, device=device)
    return p


def init_bn(c, dtype, device) -> Tuple[Dict, Dict]:
    """(params, running stats) of a BatchNorm: scale 1, bias 0; mean 0,
    var 1 (float32)."""
    return ({"scale": torch.ones(c, dtype=dtype, device=device),
             "bias": torch.zeros(c, dtype=dtype, device=device)},
            {"mean": torch.zeros(c, device=device),
             "var": torch.ones(c, device=device)})


def apply_tree(params, fn, *args):
    """``fn(params, *args)``; a module view (``parallel.shard``'s
    ``ParamTree``, under FSDP2) runs ``fn`` through its ``__call__`` so
    its params are gathered first."""
    if isinstance(params, torch.nn.Module):
        return params(fn, *args)
    return fn(params, *args)


# ---------------------------------------------------------------------
# ResNet
# ---------------------------------------------------------------------

def _block_names(bottleneck: bool):
    return (("conv1", 1), ("conv2", 3), ("conv3", 1)) if bottleneck \
        else (("conv1", 3), ("conv2", 3))


def init_resnet(gen: torch.Generator, cfg: ResNetConfig, device="cpu",
                in_channels: int = 3) -> Tuple[Dict, Dict]:
    """(params, model_state) from ``gen``: the JAX tree's keys and
    shapes (conv kernels OIHW), ``model_state = {"batch_stats": ...}``."""
    pd = cfg.param_dtype
    params: Dict[str, Any] = {}
    stats: Dict[str, Any] = {}
    stem = 3 if cfg.cifar_stem else 7
    params["conv1"] = init_conv(gen, in_channels, 64, stem, pd, device)
    params["bn1"], stats["bn1"] = init_bn(64, pd, device)
    cin = 64
    expand = 4 if cfg.bottleneck else 1
    for stage, n_blocks in enumerate(cfg.stage_sizes):
        features = 64 * 2 ** stage
        out_f = features * expand
        for b in range(n_blocks):
            strides = 2 if (b == 0 and stage > 0) else 1
            bp: Dict[str, Any] = {}
            bs: Dict[str, Any] = {}
            c = cin
            for i, (name, k) in enumerate(_block_names(cfg.bottleneck)):
                last = i == len(_block_names(cfg.bottleneck)) - 1
                cout = out_f if last else features
                bp[name] = init_conv(gen, c, cout, k, pd, device)
                bp[f"bn{i + 1}"], bs[f"bn{i + 1}"] = init_bn(cout, pd,
                                                             device)
                c = cout
            if strides != 1 or cin != out_f:
                bp["down"] = init_conv(gen, cin, out_f, 1, pd, device)
                bp["down_bn"], bs["down_bn"] = init_bn(out_f, pd, device)
            params[f"stage{stage + 1}_block{b}"] = bp
            stats[f"stage{stage + 1}_block{b}"] = bs
            cin = out_f
    params["fc"] = {
        "kernel": _normal(gen, (cin, cfg.num_classes),
                          1.0 / math.sqrt(cin), pd, device),
        "bias": torch.zeros(cfg.num_classes, dtype=pd, device=device)}
    return params, {"batch_stats": stats}


def _block(p, ra, x, strides, bottleneck, train, all_sum):
    new = {}
    h = x
    names = _block_names(bottleneck)
    strided = "conv2" if bottleneck else "conv1"
    for i, (name, _) in enumerate(names):
        stride = strides if name == strided else 1
        h = conv2d_same(h, p[name]["kernel"], stride=stride)
        bn = f"bn{i + 1}"
        h, new[bn] = batch_norm(h, p[bn], ra[bn], train, all_sum)
        if i < len(names) - 1:
            h = F.relu(h)
    if x.shape != h.shape:
        x = conv2d_same(x, p["down"]["kernel"], stride=strides)
        x, new["down_bn"] = batch_norm(x, p["down_bn"], ra["down_bn"],
                                       train, all_sum)
    return F.relu(x + h), new


def _resnet(params, model_state, x, cfg: ResNetConfig, train: bool,
            all_sum: AllSum):
    ra = model_state["batch_stats"]
    new: Dict[str, Any] = {}
    x = nchw(x.to(cfg.dtype))
    x = conv2d_same(x, params["conv1"]["kernel"],
                    stride=1 if cfg.cifar_stem else 2)
    x, new["bn1"] = batch_norm(x, params["bn1"], ra["bn1"], train, all_sum)
    x = F.relu(x)
    if not cfg.cifar_stem:
        x = max_pool_same(x, 3, 2)
    for stage, n_blocks in enumerate(cfg.stage_sizes):
        for b in range(n_blocks):
            name = f"stage{stage + 1}_block{b}"
            strides = 2 if (b == 0 and stage > 0) else 1
            x, new[name] = _block(params[name], ra[name], x, strides,
                                  cfg.bottleneck, train, all_sum)
    x = x.mean(dim=(2, 3))  # global average pool
    logits = dense(x, params["fc"], cfg.dtype).float()
    return logits, {**model_state, "batch_stats": new} if train \
        else model_state


def apply_resnet(params, model_state, x: torch.Tensor, cfg: ResNetConfig,
                 train: bool = True, all_sum: AllSum = None):
    """NHWC images -> (float32 logits, new model_state); ``all_sum``
    syncs the BatchNorm moments (:func:`group_sum`)."""
    return apply_tree(params, _resnet, model_state, x, cfg, train, all_sum)


def make_forward(cfg: ResNetConfig, all_sum: AllSum = None):
    """Trainer-contract forward: softmax cross-entropy and accuracy on
    (image, label) batches (``datasets.CIFARSynthetic``)."""
    from tpu_hpc_torch.models.losses import cross_entropy

    def forward(params, model_state, batch, step_rng):
        x, labels = batch
        logits, new_ms = apply_resnet(params, model_state, x, cfg, True,
                                      all_sum)
        acc = (logits.argmax(-1) == labels).float().mean()
        return cross_entropy(logits, labels), new_ms, {"accuracy": acc}

    return forward


def make_eval_forward(cfg: ResNetConfig):
    """Trainer-contract eval forward: BatchNorm on the stored stats,
    cross-entropy and accuracy."""
    from tpu_hpc_torch.models.losses import cross_entropy

    def eval_forward(params, model_state, batch):
        x, labels = batch
        logits, _ = apply_resnet(params, model_state, x, cfg, False)
        acc = (logits.argmax(-1) == labels).float().mean()
        return cross_entropy(logits, labels), {"accuracy": acc}

    return eval_forward
