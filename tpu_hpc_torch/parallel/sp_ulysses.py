"""DeepSpeed-Ulysses sequence parallelism: an all-to-all head scatter.

Port of the JAX package's ``parallel/sp_ulysses.py``. Each context rank
holds ``[B, S/n, H, D]``; an all-to-all (``all_to_all_single`` in an
autograd function whose backward is the inverse exchange, from
``parallel.sp_transport``) turns that into ``[B, S, H/n, D]``: the whole
sequence for H/n heads. One flash call (the three kernels, through
``kernels.attention.flash_attention``) attends over it with no LSE
merge, and the inverse all-to-all gives each rank its shard back. The
head count must divide by the degree.
"""
from __future__ import annotations

from typing import Any, List, Optional

import torch

from tpu_hpc_torch.kernels.attention import flash_attention
from tpu_hpc_torch.parallel.ring_attention import (
    AttnFn,
    per_rank,
    context_ring,
)
from tpu_hpc_torch.parallel.sp_transport import InProcessRing


def validate_ulysses_degree(n_heads: int, degree: int) -> None:
    """Ulysses shards heads across the sequence group: Hq % n == 0."""
    if n_heads % degree != 0:
        raise ValueError(
            f"Ulysses needs n_heads % degree == 0, got "
            f"{n_heads} % {degree}"
        )


def ulysses_attention(q, k, v, ring=None, *, causal: bool = True,
                      sm_scale: Optional[float] = None) -> List[torch.Tensor]:
    """q: shards [B, S_local, Hq, D]; k, v: [B, S_local, Hkv, D], one
    per rank ``ring`` plays, as ``ring_attention.ring_attention`` takes
    them; returns the outputs per rank. All-to-all to
    [B, S, H/n, D], flash attention over the whole sequence, all-to-all
    back. GQA: when Hkv divides by the degree K/V travel at their own
    head count (local q head j then maps to local kv head j // g, the
    kernels' grouped view); only otherwise are they repeated up to Hq
    before the exchange."""
    ring = ring if ring is not None else InProcessRing(1)
    qs, ks, vs = (per_rank(x, ring) for x in (q, k, v))
    n = ring.n
    hq, hkv = qs[0].shape[2], ks[0].shape[2]
    validate_ulysses_degree(hq, n)
    if hkv % n:
        g = hq // hkv
        ks = [x.repeat_interleave(g, dim=2) for x in ks]
        vs = [x.repeat_interleave(g, dim=2) for x in vs]
    if n > 1:
        qs, ks, vs = (ring.all_to_all(xs, 2, 1) for xs in (qs, ks, vs))
    outs = [flash_attention(qq, kk, vv, 0, 0, causal, sm_scale)[0]
            for qq, kk, vv in zip(qs, ks, vs)]
    if n > 1:
        outs = ring.all_to_all(outs, 1, 2)
    return outs


def make_ulysses_attn_fn(mesh: Any = None, *, sp_axis: str = "context",
                         causal: bool = True) -> AttnFn:
    """Model-facing hook, the mirror of
    ``ring_attention.make_ring_attn_fn``."""
    ring = context_ring(mesh, sp_axis)

    def attn_fn(q, k, v):
        (out,) = ulysses_attention([q], [k], [v], ring, causal=causal)
        return out

    return attn_fn


__all__ = ["make_ulysses_attn_fn", "ulysses_attention",
           "validate_ulysses_degree"]
