"""SimpleViT for weather prediction (regression back to pixel space).

Port of the JAX package's ``models/vit.py``: a stride-p conv patch
embedding, a learned ``pos_embed``, pre-LN blocks with separate
``q_proj``/``k_proj``/``v_proj`` and ``out_proj`` and a tanh-GELU MLP
(``fc1``/``fc2``), a final LayerNorm and the pixel head with its
unpatchify. The param tree keeps the flax keys (``blocks_<i>/attn/
q_proj/kernel``, ...), so ``parallel.tp.vit_rules`` matches it; Dense
kernels stay ``[in, out]``, the patch-embedding conv kernel is OIHW.

What flax fixes and the port follows: ``nn.gelu`` is the tanh
approximation; ``nn.LayerNorm`` takes eps 1e-6 and computes in float32
(``dtype=float32``), its output cast to the compute dtype before the
next Dense; tokens are row-major over (h_patch, w_patch), and the
unpatchify transposes ``[B, hp, wp, p, p, C]`` by ``(0, 1, 3, 2, 4, 5)``.

Tensor parallelism: params laid out by ``parallel.shard.shard_params``
with ``tp.vit_rules`` on a ``model`` axis run each block on every rank's
local shards (local heads and MLP columns) with Megatron's collectives
around the two branches (``tp.tp_region``); the patch embedding, norms
and head are replicated.

Attention is a hook with the JAX signature, ``attn_fn(q, k, v)`` on
``[B, S, H, D]``: :func:`flash_attn_fn` (non-causal) takes the port's
three flash kernels for CUDA tensors and their plain versions for CPU
tensors; ``attn_fn=None`` keeps the einsum path (bf16 scores, float32
softmax), as in JAX.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, Optional

import torch
import torch.nn.functional as F

from tpu_hpc_torch.models import resnet
from tpu_hpc_torch.models.resnet import conv2d, dense, nchw, nhwc, wide

AttnFn = Optional[Callable[[torch.Tensor, torch.Tensor, torch.Tensor],
                           torch.Tensor]]
LN_EPS = 1e-6


@dataclasses.dataclass(frozen=True)
class ViTConfig:
    in_channels: int = 20
    out_channels: int = 20
    patch_size: int = 4
    lat: int = 64
    lon: int = 128
    embed_dim: int = 256
    depth: int = 6
    n_heads: int = 8
    mlp_ratio: int = 4
    dtype: Any = torch.bfloat16       # compute dtype
    param_dtype: Any = torch.float32  # storage dtype

    @property
    def h_patches(self) -> int:
        return self.lat // self.patch_size

    @property
    def w_patches(self) -> int:
        return self.lon // self.patch_size

    @property
    def n_patches(self) -> int:
        return self.h_patches * self.w_patches

    @property
    def head_dim(self) -> int:
        return self.embed_dim // self.n_heads


def flash_attn_fn(impl: str = "auto"):
    """The non-causal attention hook over the flash kernels
    (``kernels.attention.blockwise_attention(causal=False)``): the
    kernels for CUDA tensors, their plain versions for CPU tensors
    (``impl="auto"``)."""
    from tpu_hpc_torch.kernels.attention import blockwise_attention

    def attn(q, k, v):
        return blockwise_attention(q, k, v, causal=False, impl=impl)[0]

    return attn


def init_vit(gen: torch.Generator, cfg: ViTConfig, device="cpu") -> Dict:
    """Params from ``gen`` with the JAX tree's keys: Dense kernels
    normal(0.02) ``[in, out]``, zero biases, LayerNorm scale 1 / bias 0,
    the patch conv LeCun-normal (OIHW), ``pos_embed`` normal(0.02)."""
    pd, e, p = cfg.param_dtype, cfg.embed_dim, cfg.patch_size

    def normal(*shape, std=0.02):
        return (torch.randn(shape, generator=gen, device=device)
                * std).to(pd)

    def lin(cin, cout):
        return {"kernel": normal(cin, cout),
                "bias": torch.zeros(cout, dtype=pd, device=device)}

    def ln():
        return {"scale": torch.ones(e, dtype=pd, device=device),
                "bias": torch.zeros(e, dtype=pd, device=device)}

    params: Dict[str, Any] = {
        "patch_embed": {
            "kernel": normal(e, cfg.in_channels, p, p,
                             std=1 / math.sqrt(cfg.in_channels * p * p)),
            "bias": torch.zeros(e, dtype=pd, device=device)},
        "pos_embed": normal(1, cfg.n_patches, e),
    }
    for i in range(cfg.depth):
        params[f"blocks_{i}"] = {
            "norm1": ln(),
            "attn": {name: lin(e, e) for name in (
                "q_proj", "k_proj", "v_proj", "out_proj")},
            "norm2": ln(),
            "fc1": lin(e, e * cfg.mlp_ratio),
            "fc2": lin(e * cfg.mlp_ratio, e),
        }
    params["norm"] = ln()
    params["head"] = lin(e, cfg.out_channels * p * p)
    return params


def params_from_numpy(tree, cfg: ViTConfig, device="cpu") -> Dict:
    """``init_vit``'s flax tree (numpy) -> the port's, in
    ``cfg.param_dtype`` (the patch conv kernel HWIO -> OIHW)."""
    return resnet.params_from_numpy(tree, cfg.param_dtype, device)


def layer_norm(x: torch.Tensor, p) -> torch.Tensor:
    """flax ``nn.LayerNorm(dtype=float32)``: eps 1e-6, float32 out."""
    return F.layer_norm(wide(x), (x.shape[-1],), wide(p["scale"]),
                        wide(p["bias"]), LN_EPS)


def attention(p, x: torch.Tensor, cfg: ViTConfig, attn_fn: AttnFn,
              n_heads: Optional[int] = None) -> torch.Tensor:
    """The attention branch on ``[B, S, E]`` (before ``out_proj``'s
    output is added back): ``n_heads`` local heads (default all)."""
    b, n, _ = x.shape
    dt, hd = cfg.dtype, cfg.head_dim
    h = n_heads or cfg.n_heads
    q, k, v = (dense(x, p[name], dt).reshape(b, n, h, hd)
               for name in ("q_proj", "k_proj", "v_proj"))
    if attn_fn is not None:
        out = attn_fn(q, k, v)
    else:
        s = torch.einsum("bqhd,bkhd->bhqk", q, k) * hd ** -0.5
        probs = torch.softmax(wide(s), dim=-1).to(dt)
        out = torch.einsum("bhqk,bkhd->bqhd", probs, v)
    return out.reshape(b, n, h * hd)


def _identity(x: torch.Tensor) -> torch.Tensor:
    return x


def _rowwise(x: torch.Tensor, p, dtype, exit_) -> torch.Tensor:
    """A row-parallel Dense: the ranks' partial products summed by
    ``exit_``, then the (replicated) bias once."""
    return exit_(x.to(dtype) @ p["kernel"].to(dtype)) + p["bias"].to(dtype)


def _block(p, x: torch.Tensor, cfg: ViTConfig, attn_fn: AttnFn,
           enter=_identity, exit_=_identity, heads: Optional[int] = None):
    """A pre-LN block; under TP (:func:`_tp_local`) on this rank's
    shards, ``enter``/``exit_`` Megatron's collectives around each
    branch and ``heads`` the local heads."""
    dt = cfg.dtype
    a = attention(p["attn"], enter(layer_norm(x, p["norm1"]).to(dt)), cfg,
                  attn_fn, heads)
    x = x + _rowwise(a, p["attn"]["out_proj"], dt, exit_)
    h = dense(enter(layer_norm(x, p["norm2"]).to(dt)), p["fc1"], dt)
    h = F.gelu(h, approximate="tanh")
    return x + _rowwise(h, p["fc2"], dt, exit_)


def _tp_local(p, mesh):
    """A block's TP DTensors (``parallel.tp.vit_rules``: q/k/v_proj and
    fc1 colwise, out_proj and fc2 rowwise, the rest replicated) -> this
    rank's local tensors. A colwise Dense's bias is replicated in the
    plan: each rank takes its columns' slice, and its gradient is a
    partial sum over the ranks."""
    from torch.distributed.tensor import Partial

    r, n = mesh.get_local_rank(), mesh.size()

    def col_bias(b):
        full = b.to_local(grad_placements=[Partial()])
        m = full.shape[0] // n
        return full[r * m:(r + 1) * m]

    def col(d):
        return {"kernel": d["kernel"].to_local(), "bias": col_bias(d["bias"])}

    def whole(d):
        return {k: v.to_local() for k, v in d.items()}

    attn = {name: col(p["attn"][name])
            for name in ("q_proj", "k_proj", "v_proj")}
    attn["out_proj"] = whole(p["attn"]["out_proj"])
    return {"norm1": whole(p["norm1"]), "norm2": whole(p["norm2"]),
            "attn": attn, "fc1": col(p["fc1"]), "fc2": whole(p["fc2"])}


def _vit(params, x: torch.Tensor, cfg: ViTConfig, attn_fn: AttnFn):
    from tpu_hpc_torch.parallel.shard import is_dtensor, local

    if isinstance(params, torch.nn.Module):  # gathered by FSDP2 by now
        params = params.tree()
    b, p, dt = x.shape[0], cfg.patch_size, cfg.dtype
    tp_kernel = params["blocks_0"]["attn"]["q_proj"]["kernel"] \
        if cfg.depth else None
    mesh = tp_kernel.device_mesh if is_dtensor(tp_kernel) else None
    pe = params["patch_embed"]
    tok = conv2d(nchw(x.to(dt)), local(pe["kernel"]), local(pe["bias"]),
                 stride=p)
    tok = nhwc(tok).reshape(b, cfg.n_patches, cfg.embed_dim)
    tok = tok + local(params["pos_embed"]).to(dt)
    for i in range(cfg.depth):
        bp = params[f"blocks_{i}"]
        if mesh is None:
            tok = _block(bp, tok, cfg, attn_fn)
        else:
            from tpu_hpc_torch.parallel.tp import tp_region

            enter, exit_ = tp_region(mesh, sp=False)
            tok = _block(_tp_local(bp, mesh), tok, cfg, attn_fn, enter,
                         exit_, cfg.n_heads // mesh.size())
    tok = layer_norm(tok, {k: local(v) for k, v in params["norm"].items()})
    px = dense(tok.to(dt), {k: local(v) for k, v in params["head"].items()},
               dt)
    px = px.reshape(b, cfg.h_patches, cfg.w_patches, p, p, cfg.out_channels)
    px = px.permute(0, 1, 3, 2, 4, 5).reshape(b, cfg.lat, cfg.lon,
                                              cfg.out_channels)
    return px.float()


def apply_vit(params, x: torch.Tensor, cfg: ViTConfig,
              attn_fn: AttnFn = None) -> torch.Tensor:
    """``[B, lat, lon, Cin]`` -> float32 ``[B, lat, lon, Cout]``."""
    return resnet.apply_tree(params, _vit, x, cfg, attn_fn)


def make_forward(cfg: ViTConfig, attn_fn: AttnFn = None):
    """Trainer-contract forward: latitude-weighted MSE on (x, y) grids."""
    from tpu_hpc_torch.models.losses import lat_weighted_mse

    def forward(params, model_state, batch, step_rng):
        x, y = batch
        return lat_weighted_mse(apply_vit(params, x, cfg, attn_fn), y), \
            model_state, {}

    return forward
