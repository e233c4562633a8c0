"""Blockwise (flash) attention with log-sum-exp output.

Port of the JAX package's ``kernels/attention.py``. Layout
``[B, S, H, D]`` (model order); the LSE is ``[B, S, H]`` fp32. Masking
uses the large finite ``MASK_VALUE`` instead of -inf, so a fully masked
row gives out = 0, lse = MASK_VALUE and zero, NaN-free gradients.

  * :func:`attention_reference` and :func:`lse_merge` -- plain torch,
    differentiable by autograd, the JAX package's reference path.
  * :func:`flash_attention` -- a ``torch.autograd.Function`` with the
    JAX ``flash_attention`` contract: ``(out, lse)``, a backward that
    takes ``dlse`` and folds it into the per-row ``D = rowsum(dO * O) -
    dlse``. Its three steps are the wrappers :func:`flash_attention_fwd`,
    :func:`flash_attention_dq` and :func:`flash_attention_dkv`: on a
    CUDA tensor each launches its hand-written Hopper kernel
    (``csrc/flash_attention.cu``, built at first launch by ``_build``)
    or raises -- never a fallback; on a CPU tensor each runs its plain
    PyTorch version beside it (``*_ref``: the gradient identities
    written out in fp32 with the kernels' masking rules), which is also
    what ``chip_smoke.py`` holds the kernels against on the card. Each
    wrapper counts its launches in ``.launches``.
  * :func:`blockwise_attention` -- the dispatcher: ``impl="auto"``
    takes the kernels for CUDA tensors and the reference path for CPU
    tensors.

``q_offset`` / ``kv_offset`` are runtime integers handed to the
kernels, so one build serves every ring step. The TPU's ``block_q`` /
``block_k`` arguments and ``pick_block_sizes``' 128-lane rule are not
ported: the Hopper kernels pick their own tiles, per kernel, dtype and
head dim (:func:`flash_tile_rows` reads them from the built library).

Head dims: the JAX kernel's blocks span the whole head, so it takes any
d; on the card the 16-bit kernels take every d from 1 to
:data:`MAX_HEAD_DIM` (256) and the float32 ones every d up to
:data:`MAX_HEAD_DIM_F32` (128), each in a 64-, 128- or 256-column
instantiation with zero columns past d. A row that is not a whole number
of 16 bytes (bf16 d 36, float32 d 37) cannot be strided by a tensor map
or read 16 bytes a chunk, so the wrappers copy q, k, v (and dout) into
zero-padded tensors of the next such width (:func:`padded_head_dim`),
launch on those and slice the results: only the copy is extra, and the
softmax scale stays ``d ** -0.5`` of the caller's d. Past those limits
the wrappers raise, naming the ROADMAP item.
"""
from __future__ import annotations

from typing import Optional, Tuple, Union

import torch

# Finite mask value (not -inf): a fully masked row keeps a defined
# result -- zero output -- instead of NaN from exp(-inf - -inf).
MASK_VALUE = -1e30

# Input dtypes the flash kernels take.
FLASH_DTYPES = (torch.float32, torch.float16, torch.bfloat16)
# dtype codes of the C interface of every csrc/*.cu (the DType enums).
DTYPE_CODES = {
    torch.float32: 0, torch.float16: 1, torch.bfloat16: 2, torch.int8: 3,
}
# Head dims the kernels take: 16-bit inputs, float32 inputs.
MAX_HEAD_DIM = 256
MAX_HEAD_DIM_F32 = 128

Offset = Union[int, torch.Tensor]


# ---------------------------------------------------------------------------
# Plain PyTorch: the reference path and the kernels' plain versions
# ---------------------------------------------------------------------------

def _offset(x: Offset) -> int:
    """A host integer offset (a 0-d CPU tensor is read; a device scalar
    would synchronize the stream, so it is refused)."""
    if isinstance(x, torch.Tensor) and x.device.type != "cpu":
        raise ValueError(
            "offsets must be host ints or CPU tensors (reading a device "
            "scalar would synchronize the stream)"
        )
    return int(x)


def _check_gqa(q: torch.Tensor, k: torch.Tensor) -> None:
    if q.shape[2] % k.shape[2]:
        raise ValueError(
            f"GQA needs Hq % Hkv == 0, got {q.shape[2]} % {k.shape[2]}"
        )


def _scores(q, k, q_offset, kv_offset, causal, sm_scale):
    """fp32 scores [B, Hkv, G, Sq, Sk] through a grouped query view (no
    repeated K), masked to MASK_VALUE where causal hides a key."""
    b, sq, hq, d = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    qf = q.to(torch.float32).reshape(b, sq, hkv, hq // hkv, d)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qf, k.to(torch.float32)) * sm_scale
    if causal:
        rows = q_offset + torch.arange(sq, device=q.device)[:, None]
        cols = kv_offset + torch.arange(sk, device=q.device)[None, :]
        s = torch.where(rows >= cols, s, torch.full_like(s, MASK_VALUE))
    return s


def _row_view(x: torch.Tensor, hkv: int) -> torch.Tensor:
    """Per-row [B, Sq, Hq] -> [B, Hkv, G, Sq, 1], the scores' layout."""
    b, sq, hq = x.shape
    return x.to(torch.float32).reshape(b, sq, hkv, hq // hkv) \
        .permute(0, 2, 3, 1)[..., None]


def _to_rows(x: torch.Tensor) -> torch.Tensor:
    """[B, Hkv, G, Sq] -> contiguous [B, Sq, Hq]."""
    b, hkv, g, sq = x.shape
    return x.permute(0, 3, 1, 2).reshape(b, sq, hkv * g).contiguous()


def attention_reference(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    q_offset: Offset = 0,
    kv_offset: Offset = 0,
    sm_scale: Optional[float] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Softmax attention of a Q chunk against a KV chunk, plain torch.

    q: [B, Sq, Hq, D]; k, v: [B, Sk, Hkv, D] with Hq a multiple of Hkv
    (GQA through a grouped query view). Returns (out [B, Sq, Hq, D] in
    q.dtype, lse [B, Sq, Hq] fp32). ``causal`` masks with global
    positions ``q_offset + i >= kv_offset + j``; a fully masked row
    yields out = 0, lse = MASK_VALUE (so it merges as a no-op).
    Probabilities are cast to v's dtype before P.V, as in the JAX
    reference.
    """
    _check_gqa(q, k)
    b, sq, hq, d = q.shape
    scale = sm_scale if sm_scale is not None else d ** -0.5
    s = _scores(q, k, _offset(q_offset), _offset(kv_offset), causal, scale)
    m = s.amax(dim=-1)
    m_safe = torch.where(m <= MASK_VALUE * 0.5, torch.zeros_like(m), m)
    p = torch.where(
        s > MASK_VALUE * 0.5, torch.exp(s - m_safe[..., None]),
        torch.zeros_like(s),
    )
    l = p.sum(dim=-1)
    l_safe = torch.where(l == 0.0, torch.ones_like(l), l)
    out = torch.einsum("bhgqk,bkhd->bqhgd", p.to(v.dtype), v)
    out = out.reshape(b, sq, hq, d)
    out = out / _to_rows(l_safe)[..., None].to(out.dtype)
    lse = m + torch.log(l_safe)  # fully masked: MASK_VALUE + 0
    return out.to(q.dtype), _to_rows(lse)


def lse_merge(
    o1: torch.Tensor, lse1: torch.Tensor, o2: torch.Tensor, lse2: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exactly merge two attention partials over disjoint KV sets
    (o: [B, S, H, D], lse: [B, S, H]); a MASK_VALUE (empty) side is an
    exact no-op and gradients stay NaN-free."""
    m = torch.maximum(lse1, lse2)
    m_safe = torch.where(m <= MASK_VALUE * 0.5, torch.zeros_like(m), m)
    w1 = torch.exp(lse1 - m_safe)
    w2 = torch.exp(lse2 - m_safe)
    denom = w1 + w2
    denom_safe = torch.where(denom == 0.0, torch.ones_like(denom), denom)
    lse = m + torch.log(denom_safe)
    wo1 = (w1 / denom_safe)[..., None].to(o1.dtype)
    wo2 = (w2 / denom_safe)[..., None].to(o2.dtype)
    return o1 * wo1 + o2 * wo2, lse


def flash_attention_fwd_ref(
    q, k, v, q_offset: Offset = 0, kv_offset: Offset = 0, *,
    causal: bool = True, sm_scale: Optional[float] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the forward kernel: (out in q.dtype, lse fp32),
    every step in fp32 -- :func:`attention_reference` on fp32 copies of
    the inputs. (The kernel rounds P to v's dtype before P.V; this
    version does not, so it is the exact value the kernel
    approximates.) A row whose lse is NaN comes out NaN, as from the
    online softmax of the kernels (and of the JAX kernel), where a NaN
    running max turns l and O NaN; the one-pass softmax would give 0
    where every score the row sees is NaN."""
    f32 = [t.to(torch.float32) for t in (q, k, v)]
    out, lse = attention_reference(*f32, causal=causal, q_offset=q_offset,
                                   kv_offset=kv_offset, sm_scale=sm_scale)
    out = torch.where(torch.isnan(lse)[..., None],
                      torch.full_like(out, float("nan")), out)
    return out.to(q.dtype), lse


def _bwd_probs(q, k, v, dout, lse, dm, q_offset, kv_offset, causal, scale):
    """P = exp(S - lse) and dS = P * (dO.V^T - D), fp32, [B,Hkv,G,Sq,Sk]."""
    b, sq, hq, d = q.shape
    hkv = k.shape[2]
    s = _scores(q, k, _offset(q_offset), _offset(kv_offset), causal, scale)
    p = torch.where(
        s > MASK_VALUE * 0.5, torch.exp(s - _row_view(lse, hkv)),
        torch.zeros_like(s),
    )
    dof = dout.to(torch.float32).reshape(b, sq, hkv, hq // hkv, d)
    dp = torch.einsum("bqhgd,bkhd->bhgqk", dof, v.to(torch.float32))
    return p, p * (dp - _row_view(dm, hkv)), dof


def flash_attention_dq_ref(
    q, k, v, dout, lse, dm, q_offset: Offset = 0, kv_offset: Offset = 0, *,
    causal: bool = True, sm_scale: Optional[float] = None,
    accumulate: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Plain version of the dq kernel: ``dq = scale * dS . K`` with
    P = exp(S - lse), dS = P * (dO.V^T - dm), in fp32; dq in q.dtype, or
    added, in fp32, into ``accumulate`` (returned). ``dm`` is the
    per-row ``rowsum(dO * O) - dlse`` [B, Sq, Hq]."""
    b, sq, hq, d = q.shape
    scale = sm_scale if sm_scale is not None else d ** -0.5
    _, ds, _ = _bwd_probs(q, k, v, dout, lse, dm, q_offset, kv_offset,
                          causal, scale)
    dq = torch.einsum("bhgqk,bkhd->bqhgd", ds, k.to(torch.float32)) * scale
    dq = dq.reshape(b, sq, hq, d)
    if accumulate is not None:
        return accumulate.add_(dq)
    return dq.to(q.dtype)


def flash_attention_dkv_ref(
    q, k, v, dout, lse, dm, q_offset: Offset = 0, kv_offset: Offset = 0, *,
    causal: bool = True, sm_scale: Optional[float] = None,
    accumulate: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the dk/dv kernel: ``dV = P^T . dO`` and
    ``dK = scale * dS^T . Q`` in fp32, summed over each KV head's group
    of query heads; dk/dv in k/v's dtype, or added, in fp32, into the
    pair ``accumulate`` (returned)."""
    d = q.shape[-1]
    scale = sm_scale if sm_scale is not None else d ** -0.5
    p, ds, dof = _bwd_probs(q, k, v, dout, lse, dm, q_offset, kv_offset,
                            causal, scale)
    qf = q.to(torch.float32).reshape(dof.shape)
    dv = torch.einsum("bhgqk,bqhgd->bkhd", p, dof)
    dk = torch.einsum("bhgqk,bqhgd->bkhd", ds, qf) * scale
    if accumulate is not None:
        return accumulate[0].add_(dk), accumulate[1].add_(dv)
    return dk.to(k.dtype), dv.to(v.dtype)


def dkv_split_heads(group: int, n_split: int, split: int) -> range:
    """The query heads, by index within a KV head's group of ``group``,
    that split ``split`` of ``n_split`` walks (``csrc/flash_attention.cu``'s
    dk/dv blocks: ``group // n_split`` heads from ``split * group //
    n_split``); ``n_split`` must divide the group."""
    if n_split < 1 or group % n_split or not 0 <= split < n_split:
        raise ValueError(f"split {split} of {n_split} over a group of "
                         f"{group}")
    per = group // n_split
    return range(split * per, (split + 1) * per)


def flash_attention_dkv_parts_ref(
    q, k, v, dout, lse, dm, q_offset: Offset = 0, kv_offset: Offset = 0, *,
    causal: bool = True, sm_scale: Optional[float] = None, n_split: int = 1,
) -> torch.Tensor:
    """Plain version of what the split dk/dv blocks write: the fp32
    partials ``[n_split, 2, B, Sk, Hkv, D]`` -- ``scale * dS^T . Q`` then
    ``P^T . dO`` -- of each split's query heads (:func:`dkv_split_heads`)."""
    b, sq, hq, d = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    g = hq // hkv
    parts = torch.empty((n_split, 2, b, sk, hkv, d), dtype=torch.float32,
                        device=q.device)

    def heads(x, idx):  # [B, S, Hq, ...] -> the split's heads of each group
        y = x.reshape(b, sq, hkv, g, *x.shape[3:])[:, :, :, idx]
        return y.reshape(b, sq, hkv * len(idx), *x.shape[3:]).contiguous()

    for s in range(n_split):
        idx = list(dkv_split_heads(g, n_split, s))
        zeros = (torch.zeros_like(parts[s, 0]), torch.zeros_like(parts[s, 1]))
        flash_attention_dkv_ref(
            heads(q, idx), k, v, heads(dout, idx), heads(lse, idx),
            heads(dm, idx), q_offset, kv_offset, causal=causal,
            sm_scale=sm_scale, accumulate=zeros)
        parts[s, 0], parts[s, 1] = zeros
    return parts


def flash_attention_dkv_sum_ref(
    parts: torch.Tensor, dtype: torch.dtype,
    accumulate: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the split dk/dv's sum: ``parts[s, 0]`` and
    ``parts[s, 1]`` added in split order s = 0, 1, ... in fp32, as (dk,
    dv) in ``dtype`` or added into the pair ``accumulate`` (returned)."""
    dk, dv = parts[0, 0].clone(), parts[0, 1].clone()
    for s in range(1, parts.shape[0]):
        dk += parts[s, 0]
        dv += parts[s, 1]
    if accumulate is not None:
        return accumulate[0].add_(dk), accumulate[1].add_(dv)
    return dk.to(dtype), dv.to(dtype)


def flash_attention_dkv_split_ref(
    q, k, v, dout, lse, dm, q_offset: Offset = 0, kv_offset: Offset = 0, *,
    causal: bool = True, sm_scale: Optional[float] = None, n_split: int = 1,
    accumulate: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`flash_attention_dkv_ref` the way the split kernel sums it:
    each split's partials (:func:`flash_attention_dkv_parts_ref`), then
    their sum in split order (:func:`flash_attention_dkv_sum_ref`). For
    the tests; no path of the port calls it."""
    parts = flash_attention_dkv_parts_ref(
        q, k, v, dout, lse, dm, q_offset, kv_offset, causal=causal,
        sm_scale=sm_scale, n_split=n_split)
    return flash_attention_dkv_sum_ref(parts, k.dtype, accumulate)


# ---------------------------------------------------------------------------
# TF32, emulated: what the float32 kernels' tensor-core passes see
# ---------------------------------------------------------------------------

def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """float32 ``x`` rounded to TF32 (10 explicit mantissa bits; to
    nearest, ties away from zero, as ``cvt.rna.tf32.f32``), bit for bit
    as ``csrc/hopper.cuh::tf32_rna_bits`` computes it: a rounding that
    would overflow to inf truncates instead, and inf and NaN pass
    through. For the tests and ``chip_smoke.py``'s controls; no path of
    the port calls it."""
    if x.dtype != torch.float32:
        raise TypeError(f"tf32_round takes float32, got {x.dtype}")
    u = x.contiguous().view(torch.int32)
    exp = torch.bitwise_and(u, 0x7F800000)
    finite = exp != 0x7F800000
    keep = torch.tensor(-8192, dtype=torch.int32)  # 0xFFFFE000
    r = torch.bitwise_and(u + 0x1000, keep)
    r = torch.where(torch.bitwise_and(r, 0x7F800000) == 0x7F800000,
                    torch.bitwise_and(u, keep), r)
    return torch.where(finite, r, u).view(torch.float32).reshape(x.shape)


def tf32_split(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """float32 ``x`` as ``(hi, lo)``, both exact in TF32, ``hi + lo``
    within 2^-22 |x| of ``x``: ``hi = tf32_round(x)``, ``lo =
    tf32_round(x - hi)``; a non-finite ``x`` gives ``(x, 0)``. The
    float32 kernels multiply two split operands in three TF32 passes
    (hi hi, hi lo, lo hi), as ``csrc/hopper.cuh::tf32_split`` splits
    them."""
    hi = tf32_round(x)
    lo = tf32_round(torch.where(torch.isfinite(x), x - hi,
                                torch.zeros_like(x)))
    return hi, lo


def tf32_split_p(p: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """A float32 probability ``p`` (>= 0, or NaN) as ``(hi, lo)``, both
    exact in TF32, as ``csrc/hopper.cuh::tf32_split_p`` splits P before
    P . V and P^T . dO: ``hi`` truncated, so ``lo = tf32_round(p - hi)``
    is >= 0 and within 2^-21 p of it, and at least 2^-126 wherever ``hi
    > 0`` -- so the products' three passes of a key agree in sign and an
    inf in V or dO gives +-inf, never inf - inf; ``(0, 0)`` for ``p =
    0``."""
    if p.dtype != torch.float32:
        raise TypeError(f"tf32_split_p takes float32, got {p.dtype}")
    keep = torch.tensor(-8192, dtype=torch.int32)  # 0xFFFFE000
    hi = torch.bitwise_and(p.contiguous().view(torch.int32), keep) \
        .view(torch.float32).reshape(p.shape)
    tiny = torch.tensor(2.0 ** -126, dtype=torch.float32)
    lo = torch.where(hi > 0, torch.fmax(tf32_round(p - hi), tiny),
                     torch.zeros_like(p))
    return hi, lo


# ---------------------------------------------------------------------------
# Wrappers: the kernel on the card, the plain version on the CPU
# ---------------------------------------------------------------------------

def _check_inputs(q, k, v, extra=()):
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("q, k, v must be [B, S, H, D]")
    if k.shape != v.shape:
        raise ValueError(f"k {tuple(k.shape)} and v {tuple(v.shape)} differ")
    if k.shape[0] != q.shape[0] or k.shape[3] != q.shape[3]:
        raise ValueError(
            f"q {tuple(q.shape)} and k {tuple(k.shape)} disagree in "
            "batch or head_dim"
        )
    _check_gqa(q, k)
    if q.shape[1] < 1 or k.shape[1] < 1:
        raise ValueError("sequence lengths must be >= 1")
    for name, t in extra:
        if t.shape[:3] != q.shape[:3]:
            raise ValueError(f"{name} {tuple(t.shape)} does not match q")


def _check_cuda(named, dtypes):
    """Raise unless every tensor is on the first one's CUDA device,
    contiguous, 16-byte aligned and of its expected dtype."""
    device = named[0][1].device
    if device.type != "cuda":
        raise ValueError(f"unsupported device {device}")
    for (name, t), dt in zip(named, dtypes):
        if t.device != device:
            raise ValueError(f"{name} is on {t.device}, q on {device}")
        if t.dtype != dt:
            raise TypeError(f"{name} must be {dt}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")


def _kernel_dtype(q: torch.Tensor) -> int:
    if q.dtype not in FLASH_DTYPES:
        raise TypeError(
            f"flash kernels take {sorted(map(str, FLASH_DTYPES))}, got "
            f"{q.dtype}"
        )
    d = q.shape[-1]
    if d > MAX_HEAD_DIM:
        raise ValueError(
            f"head_dim {d}: the flash kernels take head dims up to "
            f"{MAX_HEAD_DIM} "
            '(ROADMAP: "Flash attention past head_dim 256")')
    if q.dtype == torch.float32 and d > MAX_HEAD_DIM_F32:
        raise ValueError(
            f"head_dim {d}: the float32 flash kernels take head dims up to "
            f"{MAX_HEAD_DIM_F32} "
            '(ROADMAP: "The TF32 walk at head dims 129-256")')
    return DTYPE_CODES[q.dtype]


def padded_head_dim(d: int, dtype: torch.dtype) -> int:
    """The width the kernels see for head dim ``d`` of ``dtype``: d
    itself where its rows are a whole number of 16 bytes, else the next
    such width (the wrappers zero-pad to it and slice the results)."""
    per = 16 // dtype.itemsize
    return -(-d // per) * per


def _pad(x: torch.Tensor, width: int) -> torch.Tensor:
    """``x`` with zero columns up to ``width`` in its last dim (``x``
    itself at that width already)."""
    d = x.shape[-1]
    if d == width:
        return x
    return torch.nn.functional.pad(x, (0, width - d))


def _dims(q, k):
    b, sq, hq, d = q.shape
    return b, sq, k.shape[1], hq, k.shape[2], d


def _launch(name, fn, *args):
    """Call C entry point ``fn`` on the current stream and raise on a
    refused launch."""
    from tpu_hpc_torch.kernels import _build

    lib = _build.load_library()
    device = args[0].device
    ptrs = [a.data_ptr() if isinstance(a, torch.Tensor) else a
            for a in args]
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        code = getattr(lib, fn)(*ptrs, stream)
    _build.check(lib, code, name)


def gqa_cluster(b: int, sq: int, hq: int, hkv: int, d: int,
                dtype: torch.dtype, max_cluster: int = 8) -> int:
    """Blocks of one q tile that run as a cluster in the 16-bit kD 256
    forward and dq kernels (``csrc/flash_attention.cu``): query heads of
    one KV head's group, side by side on the grid's head axis, each K/V
    tile loaded once from L2 and multicast into all of them. The largest
    of 8, 4, 2 and 1 that divides the group ``hq // hkv`` and is at most
    ``max_cluster`` (what the card can schedule:
    :func:`max_gqa_cluster`); 1 for float32 and wherever the padded head
    dim is 128 or less (those kernels share nothing). A pure function of
    the shape: the same cluster, and the same bits, on every launch.
    ``b`` and ``sq`` do not change it: every block of a cluster walks
    the same q tile, so the grid keeps its blocks and its balance."""
    del b, sq  # the grid's other axes: any cluster along heads fits them
    if dtype == torch.float32 or padded_head_dim(d, dtype) <= 128:
        return 1
    g = hq // hkv
    for c in (8, 4, 2):
        if c <= max_cluster and g % c == 0:
            return c
    return 1


_MAX_CLUSTER: dict = {}


def max_gqa_cluster(kernel: str, dtype: torch.dtype = torch.bfloat16) -> int:
    """The largest cluster (8, 4, 2, else 1) of ``kernel``'s kD 256
    instantiation (``flash_attention_fwd`` or ``flash_attention_dq``, in
    a 16-bit ``dtype``) the card can schedule at once, read once from
    the library (``cudaOccupancyMaxActiveClusters``); call it only with
    a card."""
    from tpu_hpc_torch.kernels import _build

    if kernel not in FLASH_KERNELS[:2] or dtype not in (torch.float16,
                                                         torch.bfloat16):
        raise ValueError(f"no clustered {kernel} in {dtype}")
    key = (kernel, dtype, torch.cuda.current_device())
    if key not in _MAX_CLUSTER:
        _MAX_CLUSTER[key] = _build.load_library().tpuhpc_flash_max_cluster(
            FLASH_KERNELS.index(kernel), DTYPE_CODES[dtype])
    return _MAX_CLUSTER[key]


def _cluster(kernel, q, k, cluster: Optional[int]) -> int:
    """The cluster a forward or dq launch takes: ``cluster`` where the
    caller names one (the kernel refuses one it cannot take), else the
    rule's (:func:`gqa_cluster`)."""
    if cluster is not None:
        return int(cluster)
    b, sq, _, hq, hkv, d = _dims(q, k)
    c = gqa_cluster(b, sq, hq, hkv, d, q.dtype)
    if c == 1:  # no card query for the kernels that share nothing
        return 1
    return gqa_cluster(b, sq, hq, hkv, d, q.dtype,
                       max_gqa_cluster(kernel, q.dtype))


def _shape_name(name, q, k, cluster) -> str:
    b, sq, sk, hq, hkv, d = _dims(q, k)
    return (f"{name} (b {b}, sq {sq}, sk {sk}, hq {hq}, hkv {hkv}, d {d}, "
            f"{str(q.dtype)[6:]}, cluster {cluster})")


def flash_attention_fwd(
    q, k, v, q_offset: Offset = 0, kv_offset: Offset = 0, *,
    causal: bool = True, sm_scale: Optional[float] = None,
    cluster: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Forward: (out [B, Sq, Hq, D] in q.dtype, lse [B, Sq, Hq] fp32).
    CUDA tensors launch ``flash_fwd_wgmma_kernel`` (bf16, fp16; at a
    padded head dim past 128 in clusters of :func:`gqa_cluster` blocks
    sharing each K/V tile) or ``flash_fwd_tf32_kernel`` (float32: split
    TF32, see :func:`tf32_split`); CPU tensors run
    :func:`flash_attention_fwd_ref`. ``cluster`` (card only) overrides
    the rule; one the kernel cannot take, or the card cannot schedule,
    raises."""
    _check_inputs(q, k, v)
    qo, ko = _offset(q_offset), _offset(kv_offset)
    scale = sm_scale if sm_scale is not None else q.shape[-1] ** -0.5
    if q.device.type == "cpu":
        return flash_attention_fwd_ref(q, k, v, qo, ko, causal=causal,
                                       sm_scale=scale)
    code = _kernel_dtype(q)
    _check_cuda([("q", q), ("k", k), ("v", v)], [q.dtype] * 3)
    b, sq, sk, hq, hkv, d = _dims(q, k)
    c = _cluster("flash_attention_fwd", q, k, cluster)
    name = _shape_name("flash_attention_fwd", q, k, c)
    w = padded_head_dim(d, q.dtype)
    q, k, v = (_pad(t, w) for t in (q, k, v))
    out = torch.empty_like(q)
    lse = torch.empty((b, sq, hq), dtype=torch.float32, device=q.device)
    _launch(name, "tpuhpc_flash_fwd", q, k, v, out, lse, b, sq, sk, hq, hkv,
            w, qo, ko, int(bool(causal)), c, float(scale), code)
    flash_attention_fwd.launches += 1
    return (out if w == d else out[..., :d].contiguous()), lse


flash_attention_fwd.launches = 0


def _check_accumulate(named) -> None:
    for name, t, like in named:
        if t.shape != like.shape:
            raise ValueError(f"accumulate {name} {tuple(t.shape)} does not "
                             f"match {tuple(like.shape)}")
        if t.dtype != torch.float32:
            raise TypeError(f"accumulate {name} must be float32, got "
                            f"{t.dtype}")


def flash_attention_dq(
    q, k, v, dout, lse, dm, q_offset: Offset = 0, kv_offset: Offset = 0, *,
    causal: bool = True, sm_scale: Optional[float] = None,
    accumulate: Optional[torch.Tensor] = None,
    cluster: Optional[int] = None,
) -> torch.Tensor:
    """dq in q.dtype from the saved lse and ``dm = rowsum(dO*O) - dlse``
    (both [B, Sq, Hq] fp32); with ``accumulate`` (fp32, q's shape) the
    kernel adds dq into it unrounded and it is returned -- how a ring sums
    its pairs. CUDA tensors launch ``flash_dq_wgmma_kernel`` (bf16, fp16
    up to a padded head dim of 128), ``flash_dq_gqa_kernel`` (bf16, fp16
    past it: a producer warp, a pipelined step, and clusters of
    :func:`gqa_cluster` blocks sharing each K/V tile) or
    ``flash_dq_tf32_kernel`` (float32: split TF32, see
    :func:`tf32_split`); CPU tensors run :func:`flash_attention_dq_ref`.
    ``cluster`` (card only) overrides the rule, as in
    :func:`flash_attention_fwd`."""
    _check_inputs(q, k, v, (("lse", lse), ("dm", dm)))
    qo, ko = _offset(q_offset), _offset(kv_offset)
    scale = sm_scale if sm_scale is not None else q.shape[-1] ** -0.5
    if accumulate is not None:
        _check_accumulate([("dq", accumulate, q)])
    if q.device.type == "cpu":
        return flash_attention_dq_ref(q, k, v, dout, lse, dm, qo, ko,
                                      causal=causal, sm_scale=scale,
                                      accumulate=accumulate)
    code = _kernel_dtype(q)
    dq = accumulate if accumulate is not None else torch.empty_like(q)
    _check_cuda(
        [("q", q), ("k", k), ("v", v), ("dout", dout), ("lse", lse),
         ("dm", dm), ("dq", dq)],
        [q.dtype] * 4 + [torch.float32] * 2 + [dq.dtype],
    )
    b, sq, sk, hq, hkv, d = _dims(q, k)
    c = _cluster("flash_attention_dq", q, k, cluster)
    name = _shape_name("flash_attention_dq", q, k, c)
    w = padded_head_dim(d, q.dtype)
    q, k, v, dout, out = (_pad(t, w) for t in (q, k, v, dout, dq))
    _launch(name, "tpuhpc_flash_dq", q, k, v, dout, lse, dm, out, b, sq, sk,
            hq, hkv, w, qo, ko, int(bool(causal)),
            int(accumulate is not None), c, float(scale), code)
    flash_attention_dq.launches += 1
    if out is not dq:  # a padded copy: its first d columns
        dq.copy_(out[..., :d])
    return dq


flash_attention_dq.launches = 0


def dkv_splits(b: int, sk: int, hq: int, hkv: int, d: int,
               dtype: torch.dtype, sms: int) -> int:
    """Blocks a key tile's query-head group is split over in the 16-bit
    dk/dv kernel: doubled from 1 while the group divides evenly and the
    grid -- ``b x hkv x`` key tiles (128 keys up to a padded head dim of
    128, 64 past it) ``x`` splits -- would give the ``sms`` SMs fewer
    than two blocks each: causal walks differ in length, and a second
    wave of shorter blocks fills in behind the longest. 1 for float32
    (the TF32 kernel walks whole groups) and wherever the grid already
    fills the card, as at the training shape (B 4, 8 KV heads). A pure
    function of the shape: the same split, and so the same bits, on
    every launch."""
    if dtype == torch.float32:
        return 1
    g = hq // hkv
    rows = 64 if padded_head_dim(d, dtype) > 128 else 128
    blocks = b * hkv * -(-sk // rows)
    n = 1
    while g % (2 * n) == 0 and blocks * n < 2 * sms:
        n *= 2
    return n


def flash_attention_dkv_sum(
    parts: torch.Tensor, dk: torch.Tensor, dv: torch.Tensor,
    accumulate: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The split dk/dv's second pass: ``parts`` (fp32 ``[n_split, 2,
    ...]``, what the split kernel wrote) summed in split order into dk
    and dv (16-bit, or with ``accumulate`` fp32 buffers the sum is added
    into). CUDA tensors launch ``flash_dkv_sum_kernel``; CPU tensors run
    :func:`flash_attention_dkv_sum_ref`. Returns (dk, dv)."""
    if parts.shape[2:] != dk.shape or dk.shape != dv.shape \
            or parts.shape[1] != 2:
        raise ValueError(f"parts {tuple(parts.shape)} do not match dk "
                         f"{tuple(dk.shape)} and dv {tuple(dv.shape)}")
    if parts.device.type == "cpu":
        if accumulate:
            return flash_attention_dkv_sum_ref(parts, dk.dtype, (dk, dv))
        got = flash_attention_dkv_sum_ref(parts, dk.dtype)
        dk.copy_(got[0])
        dv.copy_(got[1])
        return dk, dv
    if dk.dtype not in ((torch.float32,) if accumulate
                        else (torch.float16, torch.bfloat16)):
        raise TypeError(f"dk/dv sum: outputs of {dk.dtype} (accumulate="
                        f"{accumulate})")
    _check_cuda([("parts", parts), ("dk", dk), ("dv", dv)],
                [torch.float32, dk.dtype, dk.dtype])
    _launch("flash_attention_dkv_sum", "tpuhpc_flash_dkv_sum", parts, dk, dv,
            parts.shape[0], dk.numel(), int(bool(accumulate)),
            DTYPE_CODES[dk.dtype])
    flash_attention_dkv_sum.launches += 1
    return dk, dv


flash_attention_dkv_sum.launches = 0


def flash_attention_dkv(
    q, k, v, dout, lse, dm, q_offset: Offset = 0, kv_offset: Offset = 0, *,
    causal: bool = True, sm_scale: Optional[float] = None,
    accumulate: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
    n_split: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dk, dv) in k/v's dtype, summed over each KV head's query-head
    group; with ``accumulate`` (a pair of fp32 tensors of k's shape) the
    kernel adds them into it unrounded and it is returned. CUDA tensors
    launch ``flash_dkv_wgmma_kernel`` (bf16, fp16) or
    ``flash_dkv_tf32_kernel`` (float32: split TF32, P split by
    :func:`tf32_split_p`); CPU tensors run :func:`flash_attention_dkv_ref`.
    ``n_split`` (card only; default :func:`dkv_splits`, a divisor of the
    group, 1 in float32): the 16-bit kernel's blocks each walk ``group /
    n_split`` heads into fp32 partials, which
    :func:`flash_attention_dkv_sum` adds up in split order
    (:func:`flash_attention_dkv_split_ref` is that computation written
    plainly)."""
    _check_inputs(q, k, v, (("lse", lse), ("dm", dm)))
    qo, ko = _offset(q_offset), _offset(kv_offset)
    scale = sm_scale if sm_scale is not None else q.shape[-1] ** -0.5
    if accumulate is not None:
        _check_accumulate([("dk", accumulate[0], k),
                           ("dv", accumulate[1], v)])
    if q.device.type == "cpu":
        return flash_attention_dkv_ref(q, k, v, dout, lse, dm, qo, ko,
                                       causal=causal, sm_scale=scale,
                                       accumulate=accumulate)
    code = _kernel_dtype(q)
    dk, dv = (accumulate if accumulate is not None
              else (torch.empty_like(k), torch.empty_like(v)))
    _check_cuda(
        [("q", q), ("k", k), ("v", v), ("dout", dout), ("lse", lse),
         ("dm", dm), ("dk", dk), ("dv", dv)],
        [q.dtype] * 4 + [torch.float32] * 2 + [dk.dtype] * 2,
    )
    b, sq, sk, hq, hkv, d = _dims(q, k)
    if n_split is None:
        n_split = dkv_splits(
            b, sk, hq, hkv, d, q.dtype,
            torch.cuda.get_device_properties(q.device).multi_processor_count)
    w = padded_head_dim(d, q.dtype)
    q, k, v, dout, pk, pv = (_pad(t, w) for t in (q, k, v, dout, dk, dv))
    parts = None
    if n_split > 1:  # the kernels allocate nothing: the partials' room
        parts = torch.empty((n_split, 2, b, sk, hkv, w), dtype=torch.float32,
                            device=q.device)
    _launch("flash_attention_dkv", "tpuhpc_flash_dkv", q, k, v, dout, lse,
            dm, pk, pv, 0 if parts is None else parts.data_ptr(), b, sq, sk,
            hq, hkv, w, qo, ko, int(bool(causal)),
            int(accumulate is not None), n_split, float(scale), code)
    flash_attention_dkv.launches += 1
    if parts is not None:
        flash_attention_dkv_sum(parts, pk, pv, accumulate is not None)
    if pk is not dk:  # padded copies: their first d columns
        dk.copy_(pk[..., :d])
        dv.copy_(pv[..., :d])
    return dk, dv


flash_attention_dkv.launches = 0


class _FlashAttention(torch.autograd.Function):
    """(out, lse) forward through the forward kernel; backward from
    the saved (out, lse) through the dq and dk/dv kernels -- no forward
    recompute, no [S, S] buffer:

      P  = exp(S - lse)             (S rebuilt tile by tile from q, k)
      dS = P * (dO.V^T - (rowsum(dO*O) - dlse))
      dq = scale * dS.K;  dk = scale * dS^T.Q;  dv = P^T.dO

    The per-row D = rowsum(dO*O) - dlse is a torch op before the
    kernels, as the JAX package leaves it to XLA."""

    @staticmethod
    def forward(ctx, q, k, v, q_offset, kv_offset, causal, sm_scale):
        out, lse = flash_attention_fwd(q, k, v, q_offset, kv_offset,
                                       causal=causal, sm_scale=sm_scale)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.args = (q_offset, kv_offset, causal, sm_scale)
        return out, lse

    @staticmethod
    def backward(ctx, dout, dlse):
        q, k, v, out, lse = ctx.saved_tensors
        q_offset, kv_offset, causal, sm_scale = ctx.args
        dout = dout.contiguous()
        dm = (dout.to(torch.float32) * out.to(torch.float32)).sum(dim=-1)
        dm = (dm - dlse).contiguous()
        kw = dict(causal=causal, sm_scale=sm_scale)
        dq = flash_attention_dq(q, k, v, dout, lse, dm, q_offset, kv_offset,
                                **kw)
        dk, dv = flash_attention_dkv(q, k, v, dout, lse, dm, q_offset,
                                     kv_offset, **kw)
        return dq, dk, dv, None, None, None, None


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    q_offset: Offset = 0,
    kv_offset: Offset = 0,
    causal: bool = True,
    sm_scale: Optional[float] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Flash attention: (out, lse), the contract of
    :func:`attention_reference`, differentiable in q, k, v (and through
    lse). CUDA tensors run the three Hopper kernels; CPU tensors their
    plain versions."""
    scale = sm_scale if sm_scale is not None else q.shape[-1] ** -0.5
    return _FlashAttention.apply(
        q, k, v, _offset(q_offset), _offset(kv_offset), bool(causal),
        float(scale),
    )


def blockwise_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    q_offset: Offset = 0,
    kv_offset: Offset = 0,
    sm_scale: Optional[float] = None,
    impl: str = "auto",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunk attention with LSE; ``impl`` in {auto, reference, cuda}.
    ``auto`` takes the kernels (``cuda``) for CUDA tensors and the
    reference path for CPU tensors; ``cuda`` on CPU tensors runs the
    kernels' plain versions through the same autograd function."""
    _check_gqa(q, k)  # for BOTH impls, as in the JAX dispatcher
    if impl == "auto":
        impl = "cuda" if q.device.type == "cuda" else "reference"
    if impl == "reference":
        return attention_reference(
            q, k, v, causal=causal, q_offset=q_offset, kv_offset=kv_offset,
            sm_scale=sm_scale,
        )
    if impl == "cuda":
        return flash_attention(q, k, v, q_offset, kv_offset, causal, sm_scale)
    raise ValueError(f"unknown attention impl: {impl!r}")


# The three flash kernels' wrappers, in the order of the C interface's
# kernel codes (tpuhpc_flash_tile_rows).
FLASH_KERNELS = ("flash_attention_fwd", "flash_attention_dq",
                 "flash_attention_dkv")


def flash_tile_rows(kernel: str, dtype: torch.dtype, head_dim: int) -> int:
    """Rows a block of ``kernel`` (a name of :data:`FLASH_KERNELS`) owns
    for ``dtype`` at ``head_dim`` -- q rows for the forward and dq, keys
    for dk/dv (128 in 16 bits up to head_dim 128, 64 past it; 64 in
    float32) -- read from the library (csrc/flash_attention.cu); builds
    it when needed, so call it only with a card."""
    from tpu_hpc_torch.kernels import _build

    if kernel not in FLASH_KERNELS:
        raise ValueError(
            f"no flash kernel {kernel!r}; one of {FLASH_KERNELS}")
    if dtype not in FLASH_DTYPES:
        raise TypeError(f"flash kernels take no {dtype}")
    limit = MAX_HEAD_DIM_F32 if dtype == torch.float32 else MAX_HEAD_DIM
    if not 1 <= head_dim <= limit:
        raise ValueError(f"no {dtype} flash kernel takes head_dim "
                         f"{head_dim}")
    return _build.load_library().tpuhpc_flash_tile_rows(
        FLASH_KERNELS.index(kernel), DTYPE_CODES[dtype],
        padded_head_dim(head_dim, dtype))


def kernel_launches() -> dict:
    """The three flash kernels' launch counts, by wrapper name."""
    return {
        "flash_attention_fwd": flash_attention_fwd.launches,
        "flash_attention_dq": flash_attention_dq.launches,
        "flash_attention_dkv": flash_attention_dkv.launches,
    }


__all__ = [
    "FLASH_DTYPES",
    "FLASH_KERNELS",
    "MASK_VALUE",
    "MAX_HEAD_DIM",
    "MAX_HEAD_DIM_F32",
    "attention_reference",
    "blockwise_attention",
    "dkv_split_heads",
    "dkv_splits",
    "flash_attention",
    "flash_attention_dkv",
    "flash_attention_dkv_parts_ref",
    "flash_attention_dkv_ref",
    "flash_attention_dkv_split_ref",
    "flash_attention_dkv_sum",
    "flash_attention_dkv_sum_ref",
    "flash_attention_dq",
    "flash_attention_dq_ref",
    "flash_attention_fwd",
    "flash_attention_fwd_ref",
    "flash_tile_rows",
    "gqa_cluster",
    "kernel_launches",
    "lse_merge",
    "max_gqa_cluster",
    "padded_head_dim",
    "tf32_round",
    "tf32_split",
    "tf32_split_p",
]
