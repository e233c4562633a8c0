"""Ring attention: context parallelism over the sequence dimension.

Port of the JAX package's ``parallel/ring_attention.py``. Each context
rank holds one sequence shard of Q/K/V. At ring step s it attends its Q
to the K/V shard that began on rank ``(me - s) mod n``, merges the
partial into an fp32 ``(out, lse)`` through the exact LSE identity
(``kernels.attention.lse_merge``, from ``(0, MASK_VALUE)``) and passes
K/V on to rank ``me + 1``; the last step sends nothing. Every partial is
the flash forward kernel on one (q-chunk, kv-chunk) pair at the pair's
global offsets -- host integers from (rank, step), never read off the
device. On CPU tensors the kernels' plain versions run instead.

The transport (``parallel.sp_transport``) is a process group
(``ProcessGroupRing``: ``batch_isend_irecv`` to the next rank) or all n
ranks in one process (``InProcessRing``). Step s + 1's K/V hop is posted
before step s's kernels and waited on after them, the overlap the JAX
design leaves to XLA.

**Wholly-future pairs are skipped on the host.** A causal pair whose
every key lies after every query merges as an exact no-op (out 0, lse
-1e30), so it is not launched: a rank launches each kernel
:func:`causal_live_pairs` times per attention -- ``me + 1`` for the
contiguous ring, ``2n + 1`` for zigzag. The JAX package launches every
pair and skips the blocks inside its kernel.

**The backward is the ring's own.** It saves q, k, v, the merged output
and the merged lse -- not each step's K/V, as autodiff through the JAX
scan does (that is the whole sequence's K/V on every rank, per layer).
It computes ``dm = rowsum(dO * O)`` once, rotates K/V around the ring
again together with fp32 dK/dV accumulators, and at each live pair
launches the dq and dk/dv kernels with the *global* lse and dm: the
kernels rebuild ``P = exp(S - lse)`` per chunk, so the sum of the
pairs is the exact gradient. dq sums in an fp32 buffer and dK/dV in
fp32 accumulators: the kernels add each pair's result into them
unrounded (``accumulate=``), so no partial is rounded to the input
dtype before the sum. After n hops each dK/dV accumulator is back on
the rank its chunk began on. The order of every sum is fixed by the
ring, so two runs give the same bits.

**Zigzag** (:func:`zigzag_ring_attention`): the sequence is cut into 2n
chunks of ``c = S / 2n`` tokens and rank i holds the pair
``(i, 2n - 1 - i)``, which balances the causal work (2n + 1 live pairs
on every rank). The local shard is laid out chunk-major
(``[2, B, c, H, D]``, one copy of q, k and v per call) so every pair's
chunk is a contiguous tensor the kernels take as it is.

``cp_constrain`` has no counterpart: the JAX function pins the residual
stream's sharding for GSPMD, while here each rank only ever holds its
own shard of the sequence.
"""
from __future__ import annotations

from typing import Any, Callable, List, Optional

import numpy as np
import torch

from tpu_hpc_torch.kernels.attention import (
    MASK_VALUE,
    flash_attention_dkv,
    flash_attention_dq,
    flash_attention_fwd,
    lse_merge,
)
from tpu_hpc_torch.parallel.sp_transport import (
    InProcessRing,
    Move,
    ProcessGroupRing,
)


def zigzag_indices(n: int, s_global: int):
    """``(idx, inverse)`` int64 arrays: ``x[:, idx]`` lays a sequence out
    in zigzag ring order (rank i of an n-way ring holds chunks
    ``(i, 2n - 1 - i)`` of 2n), ``out[:, inverse]`` undoes it."""
    if s_global % (2 * n):
        raise ValueError(
            f"zigzag needs seq {s_global} divisible by 2*ring={2 * n}"
        )
    c = s_global // (2 * n)
    order = []
    for i in range(n):
        order += [i, 2 * n - 1 - i]
    idx = np.concatenate([np.arange(o * c, (o + 1) * c) for o in order])
    return idx, np.argsort(idx)


def causal_live_pairs(n: int, zigzag: bool) -> List[int]:
    """Per-rank count of causally live (q-chunk, kv-chunk) pairs over a
    full ring pass: ``1..n`` contiguous, ``2n + 1`` on every rank for
    zigzag. It is also each flash kernel's launch count per attention."""
    if not zigzag:
        return [i + 1 for i in range(n)]
    counts = []
    for i in range(n):
        qs = (i, 2 * n - 1 - i)
        total = 0
        for src in range(n):
            for kc in (src, 2 * n - 1 - src):
                total += sum(1 for qc in qs if kc <= qc)
        counts.append(total)
    return counts


def shard_positions(n: int, rank: int, s_global: int, zigzag: bool,
                    device: Any = None) -> torch.Tensor:
    """Global RoPE positions [S / n] (int64) of the tokens context rank
    ``rank`` holds: ``rank * S/n + arange(S/n)``, or its slice of the
    zigzag order. A model run on a local shard needs them, since its
    default ramp ``0..S/n - 1`` is only rank 0's."""
    if s_global % n:
        raise ValueError(f"seq {s_global} not divisible by context={n}")
    s = s_global // n
    pos = (zigzag_indices(n, s_global)[0][rank * s:(rank + 1) * s]
           if zigzag else np.arange(rank * s, (rank + 1) * s))
    return torch.as_tensor(pos, dtype=torch.int64, device=device)


def zigzag_moves(n: int, inverse: bool = False) -> List[Move]:
    """Chunk moves from the contiguous layout (rank r holds chunks
    ``2r, 2r + 1``) to the zigzag one, or back; in chunk order."""
    moves = []
    for g in range(2 * n):
        contiguous = (g // 2, g % 2)
        zigzag = (g, 0) if g < n else (2 * n - 1 - g, 1)
        moves.append((zigzag, contiguous) if inverse
                     else (contiguous, zigzag))
    return moves


def _chunks(x: torch.Tensor, m: int) -> torch.Tensor:
    """[B, m*c, ...] -> contiguous chunk-major [m, B, c, ...] (a view
    when m == 1 or B == 1)."""
    b, s = x.shape[:2]
    return x.reshape(b, m, s // m, *x.shape[2:]).transpose(0, 1).contiguous()


def _unchunk(x: torch.Tensor) -> torch.Tensor:
    m, b, c = x.shape[:3]
    return x.transpose(0, 1).reshape(b, m * c, *x.shape[3:])


def _chunk_ids(layout: str, n: int, rank: int):
    return (rank,) if layout == "ring" else (rank, 2 * n - 1 - rank)


def live_pairs(layout: str, n: int, rank: int, step: int, causal: bool):
    """``(q slot, kv slot, q chunk, kv chunk)`` of each pair ``rank``
    launches at ``step`` (the kv chunks began on ``(rank - step) mod
    n``): every pair, less the wholly-future ones when causal."""
    qids = _chunk_ids(layout, n, rank)
    kids = _chunk_ids(layout, n, (rank - step) % n)
    return [(qi, ki, qid, kid)
            for qi, qid in enumerate(qids) for ki, kid in enumerate(kids)
            if not causal or kid <= qid]


def _ring_forward(ring, layout, causal, scale, qs, ks, vs):
    n, c = ring.n, qs[0].shape[2]
    acc_o = [[torch.zeros(q.shape[1:], dtype=torch.float32,
                          device=q.device) for _ in q] for q in qs]
    acc_l = [[torch.full(q.shape[1:4], MASK_VALUE,
                         dtype=torch.float32, device=q.device) for _ in q]
             for q in qs]
    cur = [[k, v] for k, v in zip(ks, vs)]
    for step in range(n):
        wait = ring.shift(cur) if step < n - 1 else None
        for i, rank in enumerate(ring.ranks):
            k, v = cur[i]
            for qi, ki, qid, kid in live_pairs(layout, n, rank, step,
                                               causal):
                o, lse = flash_attention_fwd(
                    qs[i][qi], k[ki], v[ki], qid * c, kid * c,
                    causal=causal, sm_scale=scale)
                acc_o[i][qi], acc_l[i][qi] = lse_merge(
                    acc_o[i][qi], acc_l[i][qi], o.to(torch.float32), lse)
        if wait is not None:
            cur = wait()
    outs = [torch.stack(o).to(q.dtype) for o, q in zip(acc_o, qs)]
    return outs, [torch.stack(lse) for lse in acc_l]


def _ring_backward(ring, layout, causal, scale, qs, ks, vs, outs, lses,
                   douts):
    n, c = ring.n, qs[0].shape[2]
    f32 = torch.float32
    dms = [(do.to(f32) * o.to(f32)).sum(dim=-1)
           for do, o in zip(douts, outs)]
    dqs = [torch.zeros(q.shape, dtype=f32, device=q.device) for q in qs]
    cur = [[k, v] for k, v in zip(ks, vs)]
    grads = [[torch.zeros(k.shape, dtype=f32, device=k.device),
              torch.zeros(v.shape, dtype=f32, device=v.device)]
             for k, v in zip(ks, vs)]
    for step in range(n):
        wait_kv = ring.shift(cur) if step < n - 1 else None
        for i, rank in enumerate(ring.ranks):
            (k, v), (dk, dv) = cur[i], grads[i]
            for qi, ki, qid, kid in live_pairs(layout, n, rank, step,
                                               causal):
                args = (qs[i][qi], k[ki], v[ki], douts[i][qi], lses[i][qi],
                        dms[i][qi], qid * c, kid * c)
                kw = dict(causal=causal, sm_scale=scale)
                flash_attention_dq(*args, accumulate=dqs[i][qi], **kw)
                flash_attention_dkv(*args, accumulate=(dk[ki], dv[ki]), **kw)
        # n hops for the accumulators: the last brings each home.
        wait_grads = ring.shift(grads) if n > 1 else None
        if wait_kv is not None:
            cur = wait_kv()
        if wait_grads is not None:
            grads = wait_grads()
    return ([dq.to(q.dtype) for dq, q in zip(dqs, qs)],
            [dk.to(k.dtype) for (dk, _), k in zip(grads, ks)],
            [dv.to(v.dtype) for (_, dv), v in zip(grads, vs)])


class _RingAttention(torch.autograd.Function):
    """Chunk-major ``[m, B, c, H, D]`` q, k, v per local rank -> the
    outputs; the ring forward and the ring backward above."""

    @staticmethod
    def forward(ctx, ring, layout, causal, scale, *qkv):
        n_local = len(ring.ranks)
        qs, ks, vs = (qkv[j * n_local:(j + 1) * n_local] for j in range(3))
        outs, lses = _ring_forward(ring, layout, causal, scale, qs, ks, vs)
        ctx.save_for_backward(*qs, *ks, *vs, *outs, *lses)
        ctx.args = (ring, layout, causal, scale, n_local)
        return tuple(outs)

    @staticmethod
    def backward(ctx, *douts):
        ring, layout, causal, scale, n_local = ctx.args
        saved = ctx.saved_tensors
        qs, ks, vs, outs, lses = (saved[j * n_local:(j + 1) * n_local]
                                  for j in range(5))
        douts = [torch.zeros_like(o) if d is None else d.contiguous()
                 for d, o in zip(douts, outs)]
        dqs, dks, dvs = _ring_backward(ring, layout, causal, scale, qs, ks,
                                       vs, outs, lses, douts)
        return (None, None, None, None, *dqs, *dks, *dvs)


def per_rank(xs, ring) -> list:
    """``xs`` as a list, checked to hold one shard per rank ``ring``
    plays (one for a process-group ring, n for an in-process one)."""
    xs = list(xs)
    if len(xs) != len(ring.ranks):
        raise ValueError(f"{len(xs)} shards for a transport that plays "
                         f"{len(ring.ranks)} ranks")
    return xs


def _ring_chunks(ring, layout, causal, sm_scale, qz, kz, vz):
    d = qz[0].shape[-1]
    scale = float(sm_scale if sm_scale is not None else d ** -0.5)
    return list(_RingAttention.apply(ring, layout, bool(causal), scale,
                                     *qz, *kz, *vz))


def _run(ring, layout, causal, sm_scale, q, k, v):
    ring = ring if ring is not None else InProcessRing(1)
    qs, ks, vs = (per_rank(x, ring) for x in (q, k, v))
    m = 1 if layout == "ring" else 2
    s = qs[0].shape[1]
    if s % m:
        raise ValueError(f"zigzag needs seq {s * ring.n} divisible by "
                         f"2*ring={2 * ring.n}")
    outs = _ring_chunks(ring, layout, causal, sm_scale,
                        *([_chunks(x, m) for x in xs] for xs in (qs, ks, vs)))
    return [_unchunk(o) for o in outs]


def ring_attention(q, k, v, ring=None, *, causal: bool = True,
                   sm_scale: Optional[float] = None) -> List[torch.Tensor]:
    """Contiguous ring. q, k, v: sequences of one shard per rank
    ``ring`` plays (one for a :class:`ProcessGroupRing`, n for an
    :class:`InProcessRing`); q shards [B, S_local, Hq, D], k and v
    [B, S_local, Hkv, D] (GQA: the ring moves the Hkv heads; the kernels
    read the shared heads). Returns the outputs, per rank, in q's dtype.
    ``ring`` None: one rank, no communication. The model-facing hooks
    below take and return the rank's lone tensors."""
    return _run(ring, "ring", causal, sm_scale, q, k, v)


def zigzag_ring_attention(q, k, v, ring=None, *, causal: bool = True,
                          sm_scale: Optional[float] = None
                          ) -> List[torch.Tensor]:
    """Ring attention over the zigzag layout: each local shard is the
    chunk pair ``(me, 2n - 1 - me)`` concatenated (masking stays in the
    original coordinates through the chunks' offsets); as
    :func:`ring_attention` otherwise."""
    return _run(ring, "zigzag", causal, sm_scale, q, k, v)


def context_ring(mesh: Any = None, sp_axis: str = "context"):
    """The transport over ``mesh``'s ``sp_axis`` process group, or the
    one-rank ring when there is no such axis (or no mesh)."""
    if mesh is None or sp_axis not in (mesh.mesh_dim_names or ()):
        return InProcessRing(1)
    return ProcessGroupRing(mesh[sp_axis].get_group())


AttnFn = Callable[[torch.Tensor, torch.Tensor, torch.Tensor], torch.Tensor]


def make_ring_attn_fn(mesh: Any = None, *, sp_axis: str = "context",
                      causal: bool = True) -> AttnFn:
    """Model-facing hook (``models.llama2`` ``attn_fn``): ``(q, k, v)``
    of this rank's sequence shard -> its output, through the contiguous
    ring over ``sp_axis``. The rows are the rank's local batch, whatever
    the mesh's data axis (the JAX factory's ``dp_axis`` has no
    counterpart)."""
    ring = context_ring(mesh, sp_axis)

    def attn_fn(q, k, v):
        (out,) = ring_attention([q], [k], [v], ring, causal=causal)
        return out

    return attn_fn


def make_zigzag_ring_attn_fn(mesh: Any = None, *,
                             sp_axis: str = "context",
                             causal: bool = True,
                             data_layout: str = "contiguous") -> AttnFn:
    """Zigzag (balanced) ring hook. ``data_layout="zigzag"``: the tokens
    already come in zigzag order (``TokenStream(zigzag_ring=n)``, the
    model fed ``shard_positions(..., zigzag=True)``), so each rank's
    shard is its chunk pair and nothing moves but the ring's K/V.
    ``"contiguous"``: each layer moves q, k, v from the contiguous
    layout into the zigzag one (``zigzag_moves``: point-to-point, two
    chunks a rank) and the output back; the JAX factory's default, kept
    because a zigzag default would silently mis-mask contiguous shards."""
    if data_layout not in ("contiguous", "zigzag"):
        raise ValueError(
            f"unknown data_layout {data_layout!r} (contiguous|zigzag)")
    ring = context_ring(mesh, sp_axis)
    n = ring.n

    def check(q):
        if q.shape[1] % 2:
            raise ValueError(f"zigzag needs seq {q.shape[1] * n} divisible "
                             f"by 2*ring={2 * n}")

    if data_layout == "zigzag":
        def prelaid_attn_fn(q, k, v):
            check(q)
            (out,) = zigzag_ring_attention([q], [k], [v], ring,
                                           causal=causal)
            return out

        return prelaid_attn_fn

    def attn_fn(q, k, v):
        check(q)
        to_zigzag = zigzag_moves(n)
        qz, kz, vz = (ring.move_chunks([_chunks(x, 2)], to_zigzag)
                      for x in (q, k, v))
        (out,) = _ring_chunks(ring, "zigzag", causal, None, qz, kz, vz)
        (out,) = ring.move_chunks([out], zigzag_moves(n, inverse=True))
        return _unchunk(out)

    return attn_fn


__all__ = [
    "causal_live_pairs",
    "context_ring",
    "live_pairs",
    "make_ring_attn_fn",
    "make_zigzag_ring_attn_fn",
    "ring_attention",
    "shard_positions",
    "zigzag_indices",
    "zigzag_moves",
    "zigzag_ring_attention",
]
