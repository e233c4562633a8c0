"""Paged attention over the serving engine's KV pool.

Port of the JAX package's ``kernels/paged_attention.py``. The paged
engine (serve/paging.py) stores the KV cache as a pool of fixed-size
pages addressed through per-slot block tables; these two functions
read a slot's logical sequence straight through its table row, with no
gathered copy of the view:

  * :func:`paged_decode_attention` -- one query token per slot;
  * :func:`paged_prefill_attention` -- a chunked-prefill pass over one
    slot's table row, causal mask from the chunk ``start`` (data, not a
    build-time constant: one kernel serves every chunk).

On a CUDA tensor each launches a hand-written Hopper kernel
(``csrc/paged_attention.cu``, built at first launch by ``_build``) or
raises; it never falls back. The decode splits each slot's pages into
runs, one block each, and merges the runs in a second small kernel
(flash-decoding; :func:`paged_decode_splits` reports the runs, and
:func:`paged_decode_split_ref` / :func:`paged_decode_combine_ref` are
the two passes written plainly). The prefill has three kernels, chosen
by a rule of dtypes and shapes written in the C launcher
(:func:`paged_prefill_route` reports which one a launch takes): the
wgmma kernel for 16-bit q and pool of one dtype, the int8 wgmma kernel
for an int8 pool under a 16-bit q (exact integer tiles, the page scales
folded into S and P), the scalar kernel for float32, float32 q over
int8 and mixed 16-bit dtypes. On a CPU tensor it runs the plain PyTorch
version beside it (``*_ref``), which is also what ``chip_smoke.py``
holds the kernels against on the card. Each wrapper counts its kernel
launches in a plain integer attribute (``.launches``), so a run can
show that the main path went through the kernel; the prefill also
counts them by route (``.route_launches``, keyed by
:data:`PREFILL_ROUTES`).

Layouts are the JAX package's: q ``(slots, kv_heads, group, d)`` for
decode and ``(kv_heads, bucket, group, d)`` for prefill, pages
``(num_blocks, block_size, kv_heads, d)``. Pools may be f32, f16, bf16
or int8; int8 pages carry one f32 scale per page
(:func:`quantize_pages_int8` is the single write-side definition) and
are dequantized as they are read.

Non-finite values follow the JAX kernels. Each row max keeps a NaN (as
``jnp.max``): a row that sees a NaN score -- a NaN in its q row or in a
key it sees -- comes out NaN, and an inf in a value it sees comes out
non-finite. That holds for every decode pass (the split, its in-block
merge and the combine) and every prefill route (wgmma, wgmma_int8 and
scalar), and for their plain versions. Keys past a row's position are
masked before the max, an inactive slot gives zeros and reads no page,
and dead table entries and pages past the last live one are never read:
a NaN there does not reach the output.
"""
from __future__ import annotations

import functools
from typing import Optional, Tuple, Union

import torch

from tpu_hpc_torch.kernels.attention import DTYPE_CODES, MASK_VALUE

# Page 0 of the pool is the scratch page: never allocated, absorbs
# writes from inactive slots and padded chunk tails. Equals
# serve.paging.SCRATCH_BLOCK (asserted in the tests).
SCRATCH_PAGE = 0

# Per-page int8 scale floor: an all-zero page (fresh pool) would
# otherwise produce scale 0 and NaNs on dequantize-divide round trips.
INT8_SCALE_FLOOR = 1e-8

_Q_DTYPES = (torch.float32, torch.float16, torch.bfloat16)


# ---------------------------------------------------------------------------
# Per-page int8 quantization (single write-side definition)
# ---------------------------------------------------------------------------

def page_scales_int8(pages: torch.Tensor) -> torch.Tensor:
    """Per-page symmetric int8 scale: amax over the page's
    (block_size, kv_heads, head_dim) trailing dims / 127, floored."""
    amax = pages.to(torch.float32).abs().amax(dim=(-3, -2, -1))
    return torch.clamp_min(amax / 127.0, INT8_SCALE_FLOOR)


def quantize_pages_int8(
    pages: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Quantize ``[..., block_size, kv_heads, head_dim]`` pages to int8
    with one f32 scale per page. Round-half-even (``torch.round``,
    like ``jnp.round``), clipped to +-127 (symmetric; -128 unused so
    dequant is sign-symmetric)."""
    sc = page_scales_int8(pages)
    q = torch.clamp(
        torch.round(pages.to(torch.float32) / sc[..., None, None, None]),
        -127.0, 127.0,
    ).to(torch.int8)
    return q, sc


def dequantize_pages_int8(q: torch.Tensor, sc: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`quantize_pages_int8` (f32 out)."""
    return q.to(torch.float32) * sc[..., None, None, None]


# ---------------------------------------------------------------------------
# int8 divergence probe (pins the bounded-divergence tolerance)
# ---------------------------------------------------------------------------

def int8_logit_rmse_of(q: torch.Tensor, k: torch.Tensor,
                       block_size: int) -> float:
    """The probe's arithmetic on given scores' operands: q
    ``(n_heads, head_dim)``, k ``(seq_len, kv_heads, head_dim)``; RMSE
    between the exact-fp scores of q against k and the same scores from
    per-page quantize->dequantize K (pages of ``block_size`` keys), in
    float32."""
    q = q.to(torch.float32)
    k = k.to(torch.float32)
    seq_len, kv_heads, head_dim = k.shape
    pages = k.reshape(seq_len // block_size, block_size, kv_heads, head_dim)
    kq8, ksc = quantize_pages_int8(pages)
    k_hat = dequantize_pages_int8(kq8, ksc).reshape(k.shape)
    g = q.shape[0] // kv_heads
    qg = q.reshape(kv_heads, g, head_dim)
    scale = head_dim ** -0.5
    exact = torch.einsum("hgd,shd->hgs", qg, k) * scale
    approx = torch.einsum("hgd,shd->hgs", qg, k_hat) * scale
    return float(torch.sqrt(torch.mean((exact - approx) ** 2)))


def int8_logit_rmse(
    *,
    head_dim: int,
    kv_heads: int,
    n_heads: Optional[int] = None,
    seq_len: int = 256,
    block_size: int = 16,
    seed: int = 0,
) -> float:
    """Deterministic measure of the int8 page representational error at
    a model's attention dims: RMSE between exact-fp decode attention
    logits (pre-softmax scores of the last query against the full
    context) and the same scores computed from per-page
    quantize->dequantize K. This is what the bounded-divergence oracle
    tolerance is pinned from -- it needs no engine, no weights, and no
    clock: q and k are drawn on the CPU from a ``torch.Generator``
    seeded with ``seed``, so the value does not depend on the machine
    (the JAX function draws them with ``jax.random``; fed those arrays,
    :func:`int8_logit_rmse_of` gives its value)."""
    if seq_len % block_size:
        raise ValueError("seq_len must be a multiple of block_size")
    n_heads = n_heads or kv_heads
    if n_heads % kv_heads:
        raise ValueError("n_heads must be a multiple of kv_heads")
    gen = torch.Generator(device="cpu").manual_seed(seed)
    q = torch.randn((n_heads, head_dim), generator=gen, dtype=torch.float32)
    k = torch.randn((seq_len, kv_heads, head_dim), generator=gen,
                    dtype=torch.float32)
    return int8_logit_rmse_of(q, k, block_size)


# ---------------------------------------------------------------------------
# Plain PyTorch versions
# ---------------------------------------------------------------------------

def _softmax_rows(s: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Masked softmax with the kernels' rules: scores at MASK_VALUE get
    probability 0, a fully masked row keeps m_safe = 0 and l_safe = 1
    (so it outputs exact zeros). Returns (p, l_safe)."""
    m = s.amax(dim=-1, keepdim=True)
    m_safe = torch.where(m <= MASK_VALUE * 0.5, torch.zeros_like(m), m)
    p = torch.where(
        s > MASK_VALUE * 0.5, torch.exp(s - m_safe), torch.zeros_like(s)
    )
    l = p.sum(dim=-1, keepdim=True)
    return p, torch.where(l == 0.0, torch.ones_like(l), l)


def _gather_view(pages, scale, ids):
    """f32 pages ``ids`` of the pool, dequantized when ``scale`` is
    given: ``ids.shape + (block_size, kv_heads, d)``."""
    view = pages[ids].to(torch.float32)
    if scale is not None:
        view = view * scale[ids].to(torch.float32)[..., None, None, None]
    return view


def _pool_round(p: torch.Tensor, pool_dtype: torch.dtype) -> torch.Tensor:
    """P as the P.V product takes it: rounded to a 16-bit pool's dtype
    (the Pallas kernel's ``p.astype(v.dtype)``), fp32 for float32 and
    int8 pools."""
    if pool_dtype in (torch.float16, torch.bfloat16):
        return p.to(pool_dtype).to(torch.float32)
    return p


def _decode_view(q, k_pages, v_pages, tables, pos, active, block_size,
                 max_blocks, k_scale, v_scale):
    """Each slot's first ``max_blocks`` pages as f32 (slots, keys, hkv,
    d) K and V, zero at every key past ``pos`` or of an inactive slot
    (dead table entries may point at anything, NaN included), and the
    (slots, keys) mask of the keys each slot sees."""
    slots, hkv, _, d = q.shape
    ids = tables[:, :max_blocks].long()
    n_keys = max_blocks * block_size
    k = _gather_view(k_pages, k_scale, ids).reshape(slots, n_keys, hkv, d)
    v = _gather_view(v_pages, v_scale, ids).reshape(slots, n_keys, hkv, d)
    cols = torch.arange(n_keys, device=q.device)
    valid = (cols[None, :] <= pos.long()[:, None]) & (active[:, None] > 0)
    live = valid[:, :, None, None]
    k = torch.where(live, k, torch.zeros_like(k))
    v = torch.where(live, v, torch.zeros_like(v))
    return k, v, valid


def _decode_part(q, k, v, valid, sm_scale, pool_dtype):
    """fp32 attention of the decode rows over the keys ``valid`` marks:
    the output normalised by its own sum, and the natural-log lse
    (MASK_VALUE for a row that sees no key, whose output is 0). A row
    that sees a NaN score (a NaN q row, or a NaN key it sees) comes out
    NaN, lse included, as from the kernels' online softmax and the JAX
    kernel's."""
    s = torch.einsum("shgd,slhd->shgl", q.to(torch.float32), k) * sm_scale
    s = torch.where(valid[:, None, None, :], s, torch.full_like(s, MASK_VALUE))
    p, l_safe = _softmax_rows(s)
    out = torch.einsum("shgl,slhd->shgd", _pool_round(p, pool_dtype), v) / l_safe
    m = s.amax(dim=-1)
    out = torch.where(torch.isnan(m)[..., None],
                      torch.full_like(out, float("nan")), out)
    lse = torch.where(m <= MASK_VALUE * 0.5, torch.full_like(m, MASK_VALUE),
                      m + torch.log(l_safe[..., 0]))
    return out, lse


def paged_decode_attention_ref(
    q: torch.Tensor,
    k_pages: torch.Tensor,
    v_pages: torch.Tensor,
    tables: torch.Tensor,
    pos: torch.Tensor,
    active: torch.Tensor,
    *,
    block_size: int,
    max_blocks: int,
    k_scale: Optional[torch.Tensor] = None,
    v_scale: Optional[torch.Tensor] = None,
    sm_scale: Optional[float] = None,
) -> torch.Tensor:
    """Plain PyTorch decode attention: gather each slot's first
    ``max_blocks`` pages, zero every key past ``pos`` (dead table
    entries may point at anything, NaN included), fp32 masked softmax,
    P rounded to a 16-bit pool's dtype before P.V. Same contract as
    :func:`paged_decode_attention`."""
    if sm_scale is None:
        sm_scale = q.shape[-1] ** -0.5
    k, v, valid = _decode_view(q, k_pages, v_pages, tables, pos, active,
                               block_size, max_blocks, k_scale, v_scale)
    out, _ = _decode_part(q, k, v, valid, sm_scale, v_pages.dtype)
    return out.to(q.dtype)


def paged_decode_split_ref(
    q: torch.Tensor,
    k_pages: torch.Tensor,
    v_pages: torch.Tensor,
    tables: torch.Tensor,
    pos: torch.Tensor,
    active: torch.Tensor,
    *,
    block_size: int,
    max_blocks: int,
    n_split: int,
    k_scale: Optional[torch.Tensor] = None,
    v_scale: Optional[torch.Tensor] = None,
    sm_scale: Optional[float] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The decode's first pass, plainly: the view cut into ``n_split``
    runs of ``ceil(max_blocks / n_split)`` pages, and per run and row
    the fp32 output normalised by the run's own sum, ``(slots, kv_heads,
    n_split, group, d)``, and its lse, ``(slots, kv_heads, n_split,
    group)`` -- MASK_VALUE (and a zero output) for a run that sees no
    key. :func:`paged_decode_combine_ref` merges them."""
    if sm_scale is None:
        sm_scale = q.shape[-1] ** -0.5
    k, v, valid = _decode_view(q, k_pages, v_pages, tables, pos, active,
                               block_size, max_blocks, k_scale, v_scale)
    pps = -(-max_blocks // n_split)
    cols = torch.arange(valid.shape[1], device=q.device)
    outs, lses = [], []
    for run in range(n_split):
        mine = (cols >= run * pps * block_size) \
            & (cols < (run + 1) * pps * block_size)
        out, lse = _decode_part(q, k, v, valid & mine[None, :], sm_scale,
                                v_pages.dtype)
        outs.append(out)
        lses.append(lse)
    return torch.stack(outs, dim=2), torch.stack(lses, dim=2)


def paged_decode_combine_ref(
    o_part: torch.Tensor,    # (slots, kv_heads, n_split, group, d) f32
    lse_part: torch.Tensor,  # (slots, kv_heads, n_split, group) f32
    active: torch.Tensor,
    dtype: torch.dtype,
) -> torch.Tensor:
    """The decode's combine pass, plainly: per row, run i weighs
    ``exp(lse_i - m_safe) / denom_safe`` with the rules of
    :func:`tpu_hpc_torch.kernels.attention.lse_merge` (``m_safe`` 0
    where no run saw a key, ``denom_safe`` 1 where the weights sum to
    0); a run of weight 0 is skipped, whatever its output holds, and an
    inactive slot is zeros. Returns (slots, kv_heads, group, d) in
    ``dtype``."""
    m = lse_part.amax(dim=2, keepdim=True)
    m_safe = torch.where(m <= MASK_VALUE * 0.5, torch.zeros_like(m), m)
    w = torch.exp(lse_part - m_safe)
    denom = w.sum(dim=2, keepdim=True)
    w = w / torch.where(denom == 0.0, torch.ones_like(denom), denom)
    w = w[..., None]
    terms = torch.where(w > 0, w * o_part, torch.zeros_like(o_part))
    out = terms.sum(dim=2)
    out = torch.where(active[:, None, None, None] > 0, out,
                      torch.zeros_like(out))
    return out.to(dtype)


def paged_prefill_attention_ref(
    q: torch.Tensor,
    k_pages: torch.Tensor,
    v_pages: torch.Tensor,
    table: torch.Tensor,
    start: Union[int, torch.Tensor],
    *,
    block_size: int,
    max_blocks: int,
    k_scale: Optional[torch.Tensor] = None,
    v_scale: Optional[torch.Tensor] = None,
    sm_scale: Optional[float] = None,
) -> torch.Tensor:
    """Plain PyTorch chunked-prefill attention over one table row:
    query row b of the chunk sits at position ``start + b`` and sees
    keys ``<= start + b``; keys past the chunk's last row are zeroed
    before any arithmetic; fp32 masked softmax, P rounded to a 16-bit
    pool's dtype before P.V (relative to the whole view's max; the
    kernels round relative to a tile's running max). A row that sees a
    NaN score comes out NaN, as from the kernels' online softmax (and
    the JAX kernel's). Same contract as :func:`paged_prefill_attention`."""
    hkv, bucket, g, d = q.shape
    if sm_scale is None:
        sm_scale = d ** -0.5
    start = int(start)
    ids = table[:max_blocks].long()
    n_keys = max_blocks * block_size
    k = _gather_view(k_pages, k_scale, ids).reshape(n_keys, hkv, d)
    v = _gather_view(v_pages, v_scale, ids).reshape(n_keys, hkv, d)
    cols = torch.arange(n_keys, device=q.device)
    qpos = start + torch.arange(bucket, device=q.device)
    valid = cols[None, :] <= qpos[:, None]                  # (bucket, keys)
    live = (cols <= start + bucket - 1)[:, None, None]
    k = torch.where(live, k, torch.zeros_like(k))
    v = torch.where(live, v, torch.zeros_like(v))
    s = torch.einsum("hbgd,lhd->hbgl", q.to(torch.float32), k) * sm_scale
    s = torch.where(valid[None, :, None, :], s, torch.full_like(s, MASK_VALUE))
    p, l_safe = _softmax_rows(s)
    out = torch.einsum("hbgl,lhd->hbgd", _pool_round(p, v_pages.dtype),
                       v) / l_safe
    nan_rows = torch.isnan(s.amax(dim=-1, keepdim=True))
    out = torch.where(nan_rows, torch.full_like(out, float("nan")), out)
    return out.to(q.dtype)


# ---------------------------------------------------------------------------
# Wrappers: the kernel on the card, the plain version on the CPU
# ---------------------------------------------------------------------------

def _check_pool(q, k_pages, v_pages, k_scale, v_scale, block_size, hkv, d):
    if q.dtype not in _Q_DTYPES:
        raise TypeError(f"q dtype {q.dtype} not one of {_Q_DTYPES}")
    if k_pages.dtype not in DTYPE_CODES:
        raise TypeError(f"page dtype {k_pages.dtype} not supported")
    if v_pages.dtype != k_pages.dtype or v_pages.shape != k_pages.shape:
        raise ValueError("k_pages and v_pages must match in shape and dtype")
    if k_pages.dim() != 4 or tuple(k_pages.shape[1:]) != (block_size, hkv, d):
        raise ValueError(
            f"pages {tuple(k_pages.shape)} are not (num_blocks, "
            f"block_size={block_size}, kv_heads={hkv}, head_dim={d})"
        )
    quant = k_scale is not None
    if quant != (v_scale is not None):
        raise ValueError("k_scale and v_scale must be passed together")
    if quant != (k_pages.dtype == torch.int8):
        raise ValueError("int8 pages need k_scale/v_scale, and only they do")
    if quant:
        for sc in (k_scale, v_scale):
            if sc.dtype != torch.float32 or tuple(sc.shape) != (
                k_pages.shape[0],
            ):
                raise ValueError(
                    f"scales must be float32 ({k_pages.shape[0]},), got "
                    f"{sc.dtype} {tuple(sc.shape)}"
                )


def _check_cuda(tensors, device):
    for name, t in tensors.items():
        if t is None:
            continue
        if t.device != device:
            raise ValueError(f"{name} is on {t.device}, q on {device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


def paged_decode_attention(
    q: torch.Tensor,        # (slots, kv_heads, group, head_dim)
    k_pages: torch.Tensor,  # (num_blocks, block_size, kv_heads, head_dim)
    v_pages: torch.Tensor,
    tables: torch.Tensor,   # (slots, table_width) int32
    pos: torch.Tensor,      # (slots,) int32 position written this tick
    active: torch.Tensor,   # (slots,) int32
    *,
    block_size: int,
    max_blocks: int,
    k_scale: Optional[torch.Tensor] = None,  # (num_blocks,) f32 (int8 pools)
    v_scale: Optional[torch.Tensor] = None,
    sm_scale: Optional[float] = None,
    n_split: Optional[int] = None,
) -> torch.Tensor:
    """Single-token paged attention: returns (slots, kv_heads, group,
    head_dim) context in q.dtype. Slot s attends to its table row's
    keys at positions ``<= pos[s]`` (first ``max_blocks`` entries);
    inactive slots output zeros. CUDA tensors launch the decode kernels
    of ``csrc/paged_attention.cu`` -- the split kernel over
    :func:`paged_decode_splits` runs of pages, then the combine when
    there is more than one run (one launch in ``.launches``); head_dim
    must be a multiple of 16 up to 128. CPU tensors run
    :func:`paged_decode_attention_ref`.

    ``n_split`` (1 .. max_blocks) overrides the library's run count --
    the autotuner's sweep (kernels/autotune.py); None, what every
    caller on the serving path passes, keeps the library's pick. On CPU
    tensors a given ``n_split`` runs the two-pass plain version
    (:func:`paged_decode_split_ref` + :func:`paged_decode_combine_ref`)."""
    slots, hkv, g, d = q.shape
    _check_pool(q, k_pages, v_pages, k_scale, v_scale, block_size, hkv, d)
    if tables.dim() != 2 or tables.shape[0] != slots \
            or tables.shape[1] < max_blocks:
        raise ValueError(
            f"tables {tuple(tables.shape)} must be ({slots}, >= "
            f"max_blocks={max_blocks})"
        )
    for name, t in (("tables", tables), ("pos", pos), ("active", active)):
        if t.dtype != torch.int32:
            raise TypeError(f"{name} must be int32, got {t.dtype}")
    if pos.shape != (slots,) or active.shape != (slots,):
        raise ValueError(f"pos and active must be ({slots},)")
    if sm_scale is None:
        sm_scale = d ** -0.5
    if n_split is not None and not 1 <= n_split <= max_blocks:
        raise ValueError(
            f"n_split {n_split} must be in [1, max_blocks={max_blocks}]")
    if q.device.type == "cpu":
        kw = dict(block_size=block_size, max_blocks=max_blocks,
                  k_scale=k_scale, v_scale=v_scale, sm_scale=sm_scale)
        if n_split is None:
            return paged_decode_attention_ref(
                q, k_pages, v_pages, tables, pos, active, **kw)
        o_part, lse_part = paged_decode_split_ref(
            q, k_pages, v_pages, tables, pos, active, n_split=n_split, **kw)
        return paged_decode_combine_ref(o_part, lse_part, active, q.dtype)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    _check_cuda(
        dict(q=q, k_pages=k_pages, v_pages=v_pages, tables=tables, pos=pos,
             active=active, k_scale=k_scale, v_scale=v_scale),
        q.device,
    )
    if not (16 <= d <= 128 and d % 16 == 0):
        raise ValueError(
            f"head_dim {d}: the decode kernel takes multiples of 16 up to 128"
        )
    from tpu_hpc_torch.kernels import _build

    lib = _build.load_library()
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    with torch.cuda.device(q.device):
        if n_split is None:
            n_split = lib.tpuhpc_decode_splits(slots, hkv, g, max_blocks)
        o_part = lse_part = None
        if n_split > 1:  # the runs' partials, in one workspace
            rows = slots * hkv * n_split * g
            ws = torch.empty(rows * (d + 1), dtype=torch.float32,
                             device=q.device)
            o_part, lse_part = ws[:rows * d], ws[rows * d:]
        stream = torch.cuda.current_stream(q.device).cuda_stream
        code = lib.tpuhpc_paged_decode(
            q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
            tables.data_ptr(), pos.data_ptr(), active.data_ptr(),
            _ptr(k_scale), _ptr(v_scale), out.data_ptr(), _ptr(o_part),
            _ptr(lse_part), slots, hkv, g, d, block_size, tables.shape[1],
            max_blocks, n_split, float(sm_scale), DTYPE_CODES[q.dtype],
            DTYPE_CODES[k_pages.dtype], stream,
        )
    _build.check(lib, code, "paged_decode_attention")
    paged_decode_attention.launches += 1
    return out


paged_decode_attention.launches = 0


def paged_prefill_attention(
    q: torch.Tensor,        # (kv_heads, bucket, group, head_dim)
    k_pages: torch.Tensor,  # (num_blocks, block_size, kv_heads, head_dim)
    v_pages: torch.Tensor,
    table: torch.Tensor,    # (table_width,) int32: one slot's table row
    start: Union[int, torch.Tensor],  # chunk's first global position
    *,
    block_size: int,
    max_blocks: int,
    k_scale: Optional[torch.Tensor] = None,
    v_scale: Optional[torch.Tensor] = None,
    sm_scale: Optional[float] = None,
) -> torch.Tensor:
    """Chunked-prefill attention over the block-table view: returns
    (kv_heads, bucket, group, head_dim) context in q.dtype. Query row b
    of the chunk sits at position ``start + b`` and attends to the
    table row's keys ``<= start + b``; pages past the chunk's last row
    are never read. ``start`` is a host integer (or a CPU scalar
    tensor) passed to the kernel as an argument, so one kernel serves
    every chunk of every slot. CUDA tensors launch the prefill kernel
    of ``csrc/paged_attention.cu`` that :func:`paged_prefill_route`
    names (one launch in ``.launches``); CPU tensors run
    :func:`paged_prefill_attention_ref`."""
    hkv, bucket, g, d = q.shape
    _check_pool(q, k_pages, v_pages, k_scale, v_scale, block_size, hkv, d)
    if table.dim() != 1 or table.shape[0] < max_blocks:
        raise ValueError(
            f"table {tuple(table.shape)} must be (>= max_blocks="
            f"{max_blocks},)"
        )
    if table.dtype != torch.int32:
        raise TypeError(f"table must be int32, got {table.dtype}")
    if isinstance(start, torch.Tensor):
        if start.device.type != "cpu":
            raise ValueError(
                "start must be a host int or CPU tensor (reading a "
                "device scalar would synchronize the stream)"
            )
        start = int(start)
    if not 0 <= start < max_blocks * block_size:
        raise ValueError(
            f"start {start} outside the {max_blocks * block_size}-token view"
        )
    if sm_scale is None:
        sm_scale = d ** -0.5
    if q.device.type == "cpu":
        return paged_prefill_attention_ref(
            q, k_pages, v_pages, table, start,
            block_size=block_size, max_blocks=max_blocks,
            k_scale=k_scale, v_scale=v_scale, sm_scale=sm_scale,
        )
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    _check_cuda(
        dict(q=q, k_pages=k_pages, v_pages=v_pages, table=table,
             k_scale=k_scale, v_scale=v_scale),
        q.device,
    )
    from tpu_hpc_torch.kernels import _build

    lib = _build.load_library()
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        code = lib.tpuhpc_paged_prefill(
            q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
            table.data_ptr(), _ptr(k_scale), _ptr(v_scale), out.data_ptr(),
            hkv, bucket, g, d, block_size, max_blocks, start,
            float(sm_scale), DTYPE_CODES[q.dtype],
            DTYPE_CODES[k_pages.dtype], stream,
        )
    _build.check(lib, code, "paged_prefill_attention")
    paged_prefill_attention.launches += 1
    paged_prefill_attention.route_launches[_prefill_route_of(
        q.dtype, k_pages.dtype, d, block_size)] += 1
    return out


paged_prefill_attention.launches = 0

def paged_decode_splits(slots: int, kv_heads: int, group: int,
                        max_blocks: int) -> int:
    """Runs of pages a decode launch of this shape is split into on the
    card (1: the split kernel writes the output, no combine), as the C
    launcher picks it from the shape and the card's SM count, never
    from ``pos``; builds the library when needed, so call it only with
    a card. Run i covers table entries ``[i * pps, (i + 1) * pps)``,
    ``pps = ceil(max_blocks / runs)``."""
    from tpu_hpc_torch.kernels import _build

    return _build.load_library().tpuhpc_decode_splits(
        slots, kv_heads, group, max_blocks)


# The prefill kernels, by the C interface's route code:
# paged_prefill_kernel, paged_prefill_wgmma_kernel (16-bit q and pool of
# one dtype) and paged_prefill_int8_kernel (an int8 pool under a 16-bit
# q). The two tensor-core routes take head_dim a multiple of 16 up to
# 128 and pages that stack into (or split into) 64-key tiles: bs 8, 16,
# 32, 64 or a multiple of 64.
PREFILL_ROUTES = ("scalar", "wgmma", "wgmma_int8")
paged_prefill_attention.route_launches = dict.fromkeys(PREFILL_ROUTES, 0)


def paged_prefill_route(
    q_dtype: torch.dtype, pool_dtype: torch.dtype, head_dim: int,
    block_size: int,
) -> str:
    """The kernel a prefill launch with these dtypes and shapes takes on
    the card (a name of :data:`PREFILL_ROUTES`), as the C launcher
    decides it; builds the library when needed, so call it only with a
    card."""
    from tpu_hpc_torch.kernels import _build

    code = _build.load_library().tpuhpc_prefill_route(
        head_dim, block_size, DTYPE_CODES[q_dtype], DTYPE_CODES[pool_dtype])
    if code < 0:
        raise TypeError(f"no prefill kernel takes q {q_dtype} over a "
                        f"{pool_dtype} pool")
    return PREFILL_ROUTES[code]


@functools.lru_cache(maxsize=None)
def _prefill_route_of(q_dtype: torch.dtype, pool_dtype: torch.dtype,
                      head_dim: int, block_size: int) -> str:
    """:func:`paged_prefill_route`, asked of the C launcher once per
    shape and dtypes (the wrapper's by-route count)."""
    return paged_prefill_route(q_dtype, pool_dtype, head_dim, block_size)


__all__ = [
    "INT8_SCALE_FLOOR",
    "PREFILL_ROUTES",
    "SCRATCH_PAGE",
    "dequantize_pages_int8",
    "int8_logit_rmse",
    "int8_logit_rmse_of",
    "page_scales_int8",
    "paged_decode_attention",
    "paged_decode_attention_ref",
    "paged_decode_combine_ref",
    "paged_decode_split_ref",
    "paged_decode_splits",
    "paged_prefill_attention",
    "paged_prefill_attention_ref",
    "paged_prefill_route",
    "quantize_pages_int8",
]
