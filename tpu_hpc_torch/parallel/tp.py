"""Tensor parallelism: the Megatron column/row plan, the sequence-
parallel residual layout, Megatron's region collectives, and flash
attention on local heads.

Port of the JAX package's ``parallel/tp.py``. "Colwise" shards a
kernel's output-features dim on the ``model`` axis and "Rowwise" its
input-features dim (flax ``[in, out]`` kernels). The trainer places the
params as DTensors on the ``model`` sub-mesh (``parallel/shard.py``).
Between blocks the residual stream is a DTensor on that mesh --
replicated, or sequence-sharded under SP (:func:`sp_constrain`) -- and
each block runs on every rank's local shards under ``local_map``
(``models.llama2._tp_block``): local heads (``n_heads / tp`` query and
``kv_heads / tp`` KV heads), local FFN columns, and :func:`tp_region`'s
collectives around the two branches (one all-reduce each, or a
reduce-scatter after and an all-gather before under SP). The data axis
is FSDP2's: each rank's activations hold only its batch rows.

``mesh``: None, a mapping of axis name to size, or a
``torch.distributed.device_mesh.DeviceMesh`` with named dims.
"""
from __future__ import annotations

import math
from typing import Any, Callable, List, Mapping, Optional, Sequence

import torch

from tpu_hpc_torch.parallel.plans import P, Rule, pspec_tree

AttnFn = Callable[[torch.Tensor, torch.Tensor, torch.Tensor], torch.Tensor]


def mesh_size(mesh: Any) -> int:
    """Devices in ``mesh`` (None counts as one)."""
    if mesh is None:
        return 1
    if isinstance(mesh, Mapping):
        return math.prod(int(v) for v in mesh.values())
    return int(mesh.size())


def llama_rules(axis: str = "model") -> List[Rule]:
    """Megatron TP plan for the Llama param tree: vocab-rowwise
    embedding, colwise wq/wk/wv/w1/w3 and LM head, rowwise wo/w2, norm
    scales replicated."""
    return [
        (r"tok_embeddings/embedding$", P(axis, None)),
        (r"attention/w[qkv]/kernel$", P(None, axis)),
        (r"attention/wo/kernel$", P(axis, None)),
        (r"feed_forward/w[13]/kernel$", P(None, axis)),
        (r"feed_forward/w2/kernel$", P(axis, None)),
        (r"^output/kernel$", P(None, axis)),
        (r"norm/scale$", P()),
    ]


def mlp_rules(axis: str = "model") -> List[Rule]:
    """Colwise -> Rowwise pairing for a 2-layer MLP stack."""
    return [
        (r"(^|/)(up|fc1|in)/kernel$", P(None, axis)),
        (r"(^|/)(down|fc2|out)/kernel$", P(axis, None)),
    ]


def vit_rules(axis: str = "model") -> List[Rule]:
    """ViT block plan: q/k/v + fc1 colwise, out_proj + fc2 rowwise,
    patch embed + norms replicated."""
    return [
        (r"(^|/)[qkv]_proj/kernel$", P(None, axis)),
        (r"(^|/)out_proj/kernel$", P(axis, None)),
        (r"(^|/)fc1/kernel$", P(None, axis)),
        (r"(^|/)fc2/kernel$", P(axis, None)),
    ]


def param_pspecs(params: Any, rules: Sequence[Rule]) -> Any:
    """Rule list -> full spec tree (unmatched leaves replicated)."""
    return pspec_tree(params, rules, default=P())


def sp_constrain(
    mesh: Any,
    dp_axis: Optional[str] = "data",
    sp_axis: str = "model",
) -> Callable[[torch.Tensor], torch.Tensor]:
    """Megatron-SP activation hook: the residual stream between blocks
    laid out (dp, sp, None) -- its sequence dim sharded on the TP axis,
    so each block's all-reduce becomes a reduce-scatter after it and an
    all-gather before it. ``dp_axis`` is FSDP2's, carried by the local
    batch rows. Plain tensors (no TP) pass through. Without it a TP run
    keeps the residual stream replicated."""
    from torch.distributed.tensor import DTensor, Shard

    del mesh, dp_axis, sp_axis  # the activations carry the TP mesh

    def constrain(x: torch.Tensor) -> torch.Tensor:
        if isinstance(x, DTensor) and x.ndim == 3:
            return x.redistribute(placements=[Shard(1)])
        return x

    return constrain


# ---------------------------------------------------------------------------
# Megatron's region operators, on each rank's local tensors
# ---------------------------------------------------------------------------

def _all_gather(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    from torch.distributed import _functional_collectives as funcol

    return funcol.wait_tensor(funcol.all_gather_tensor(
        x.contiguous(), dim, group))


def _reduce_scatter(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    from torch.distributed import _functional_collectives as funcol

    return funcol.wait_tensor(funcol.reduce_scatter_tensor(
        x.contiguous(), "sum", dim, group))


def _all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    from torch.distributed import _functional_collectives as funcol

    return funcol.wait_tensor(funcol.all_reduce(x.contiguous(), "sum", group))


class _CopyIn(torch.autograd.Function):
    """Into a TP region, activations replicated: identity; the backward
    sums the ranks' partial gradients (Megatron's f)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.group), None


class _ReduceOut(torch.autograd.Function):
    """Out of a TP region, activations replicated: the ranks' partial
    sums added (Megatron's g); the gradient passes as it is."""

    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherSeq(torch.autograd.Function):
    """Into a TP region under SP: the sequence shards all-gathered; the
    backward reduce-scatters the gradient back onto them."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_gather(x, 1, group)

    @staticmethod
    def backward(ctx, g):
        return _reduce_scatter(g, 1, ctx.group), None


class _ScatterSeq(torch.autograd.Function):
    """Out of a TP region under SP: the partial sums reduce-scattered
    onto the sequence shards; the backward all-gathers the gradient."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _reduce_scatter(x, 1, group)

    @staticmethod
    def backward(ctx, g):
        return _all_gather(g, 1, ctx.group), None


def _identity(x: torch.Tensor) -> torch.Tensor:
    return x


def tp_region(mesh: Any, sp: bool):
    """``(enter, exit)`` for a block computed on local shards over the
    1-D TP ``mesh``: ``enter`` before the colwise products (identity,
    or the SP all-gather), ``exit`` after the rowwise ones (all-reduce,
    or the SP reduce-scatter), each with Megatron's backward. On a TP
    mesh of one rank every one of them is the identity, and both are
    the identity function (as Megatron's mappings skip a world of
    one)."""
    if mesh.size() == 1:
        return _identity, _identity
    group = mesh.get_group()
    if sp:
        return (lambda x: _GatherSeq.apply(x, group),
                lambda x: _ScatterSeq.apply(x, group))
    return (lambda x: _CopyIn.apply(x, group),
            lambda x: _ReduceOut.apply(x, group))


def auto_tp_degree(
    n_devices: int, n_heads: int, kv_heads: int, cap: Optional[int] = None
) -> int:
    """Largest TP degree that divides the device count and both head
    counts, optionally capped; 1 when nothing fits."""
    limit = min(n_devices, cap or n_devices)
    return max(
        d
        for d in range(1, limit + 1)
        if n_devices % d == 0 and n_heads % d == 0 and kv_heads % d == 0
    )


def auto_mesh_axes(
    n_devices: int, n_heads: int, kv_heads: int, cap: Optional[int] = 4
) -> "dict[str, int]":
    """The standard auto-split mesh shape: TP (capped, head-divisible)
    on ``model``, remaining devices on ``data``."""
    tp = (
        auto_tp_degree(n_devices, n_heads, kv_heads, cap=cap)
        if n_devices > 1 else 1
    )
    axes = {"data": n_devices // tp}
    if tp > 1:
        axes["model"] = tp
    return axes


def validate_tp_degree(n_heads: int, kv_heads: int, tp: int) -> None:
    """Head-divisibility guard: each TP rank takes whole query and KV
    heads."""
    if n_heads % tp != 0:
        raise ValueError(f"n_heads={n_heads} not divisible by tp={tp}")
    if kv_heads % tp != 0:
        raise ValueError(
            f"n_kv_heads={kv_heads} not divisible by tp={tp}; "
            "GQA requires kv_heads % tp == 0"
        )


def make_tp_flash_attn_fn(
    mesh: Any = None,
    dp_axis: Optional[str] = "data",
    tp_axis: Optional[str] = "model",
    *,
    causal: bool = True,
    impl: str = "auto",
) -> AttnFn:
    """``(q [B,S,Hq,D], k [B,S,Hkv,D], v) -> out [B,S,Hq,D]`` through
    the flash kernels (``impl="auto"``: the kernels for CUDA tensors,
    the reference path for CPU tensors).

    With a ``DeviceMesh`` that has ``tp_axis``, the closure runs under
    ``local_map`` on ``mesh[tp_axis]`` -- the counterpart of the JAX
    package's ``shard_map`` -- with q, k, v and the output ``Shard(2)``
    (heads): each rank's kernels see its local heads, Hq/tp over
    Hkv/tp, GQA in-kernel. Called with plain tensors -- inside a block
    that already runs on local shards, as the hybrid plan's blocks do
    (``models.llama2._tp_block``) -- ``local_map`` calls the closure as
    it is, like the JAX factory's ``wrap=False``. The ``dp_axis`` rows
    are the local batch (FSDP2's data parallelism). With no mesh, a
    mapping of size 1, or ``tp_axis=None`` it returns the bare
    closure.
    """
    from tpu_hpc_torch.kernels.attention import blockwise_attention

    del dp_axis

    def flash(q, k, v):
        out, _ = blockwise_attention(q, k, v, causal=causal, impl=impl)
        return out

    if mesh is None or isinstance(mesh, Mapping):
        if mesh_size(mesh) > 1:
            raise ValueError(
                f"make_tp_flash_attn_fn on a mesh of {mesh_size(mesh)} "
                "devices needs the DeviceMesh itself (runtime.build_mesh), "
                "not its sizes"
            )
        return flash
    if tp_axis is None or tp_axis not in mesh.mesh_dim_names:
        return flash
    from torch.distributed.tensor import Shard
    from torch.distributed.tensor.experimental import local_map

    heads = [Shard(2)]
    return local_map(flash, out_placements=heads,
                     in_placements=(heads, heads, heads),
                     device_mesh=mesh[tp_axis], redistribute_inputs=True)
