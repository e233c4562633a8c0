"""The port's paged-attention functions against the JAX package's
Pallas kernels (tpu_hpc_torch/kernels/paged_attention.py vs
tpu_hpc/kernels/paged_attention.py).

On the CPU the port's wrappers run their plain PyTorch versions; the
JAX kernels run under ``interpret=True``, as tests/test_paged_kernels.py
runs them. Same inputs, made from a numpy seed: random block tables
with ragged lengths, pages recycled across slots, an inactive slot, and
dead table entries pointing at a NaN page -- a read of a dead page
would poison the output.

Tolerance: float32 pools at ``atol 2e-5 / rtol 1e-5`` -- the two sides
sum in different orders (an online softmax page by page against one
softmax over the whole view), nothing else differs. bf16 pools (the
serving path's working dtype): ``tpu_hpc_torch/checks/tolerance.py``'s
bf16 rule, the one the card holds the kernels to -- the Pallas kernels
round P to the pool's bf16 before P.V (paged_attention.py:152-156,
:297-301); the plain decode and prefill do too (relative to the whole
view's max, where the Pallas kernel rounds relative to its running
max), and all round the output to bf16. int8 pools under a 16-bit q:
the rule for q's dtype -- both sides dequantize in f32 and keep P in
f32, and differ in summation order and the output's rounding.

The CUDA kernels themselves are held against the plain versions on the
card by tests/test_torch_gpu.py. JAX is imported through
``importorskip`` so that ``pytest tests/test_torch_*.py -m gpu`` also
collects cleanly on a card machine without JAX.
"""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax", reason="the JAX reference package")
jnp = jax.numpy

from tpu_hpc.kernels import attention as jax_attention
from tpu_hpc.kernels import paged_attention as jax_pa
from tpu_hpc.serve.paging import SCRATCH_BLOCK as JAX_SCRATCH_BLOCK
from tpu_hpc_torch.checks.tolerance import compare, rule_dtype
from tpu_hpc_torch.kernels import attention as pt_attention
from tpu_hpc_torch.kernels import paged_attention as pt_pa
from tpu_hpc_torch.serve.paging import SCRATCH_BLOCK

ATOL, RTOL = 2e-5, 1e-5


def _random_case(rng, *, slots=4, hkv=2, g=2, d=16, block_size=4,
                 max_blocks=6, num_blocks=24, poison=True):
    """Random pool + tables. Page 0 is scratch (zeros); the LAST page is
    NaN-poisoned and never allocated -- every dead table entry points at
    it."""
    shape = (num_blocks, block_size, hkv, d)
    k_pages = rng.standard_normal(shape).astype(np.float32)
    v_pages = rng.standard_normal(shape).astype(np.float32)
    k_pages[0] = v_pages[0] = 0.0
    poison_page = num_blocks - 1
    if poison:
        k_pages[poison_page] = v_pages[poison_page] = np.nan
    q = rng.standard_normal((slots, hkv, g, d)).astype(np.float32)
    pos = rng.integers(0, max_blocks * block_size, size=slots).astype(np.int32)
    active = (rng.random(slots) < 0.75).astype(np.int32)
    active[0], active[-1] = 1, 0  # one live, one dead slot at least
    tables = np.zeros((slots, max_blocks), np.int32)
    for s in range(slots):
        # drawn per slot from one small pool: pages recur across slots
        tables[s] = rng.choice(
            np.arange(1, poison_page), size=max_blocks, replace=False
        )
        n_live = -(-(int(pos[s]) + 1) // block_size)
        tables[s, n_live:] = poison_page
        if not active[s]:
            tables[s] = poison_page
    return q, k_pages, v_pages, tables, pos, active


def _table_row(rng, num_blocks, max_blocks, ctx_pages):
    poison_page = num_blocks - 1
    row = rng.choice(
        np.arange(1, poison_page), size=max_blocks, replace=False
    ).astype(np.int32)
    row[ctx_pages:] = poison_page
    return row


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _quantized(kp, vp):
    """int8 pools through the port's quantizer, as numpy for both."""
    kq, ksc = pt_pa.quantize_pages_int8(_t(kp))
    vq, vsc = pt_pa.quantize_pages_int8(_t(vp))
    return kq.numpy(), ksc.numpy(), vq.numpy(), vsc.numpy()


# ---------------------------------------------------------------------
# Constants
# ---------------------------------------------------------------------


def test_constants_match_the_reference():
    assert pt_pa.SCRATCH_PAGE == jax_pa.SCRATCH_PAGE == SCRATCH_BLOCK \
        == JAX_SCRATCH_BLOCK == 0
    assert pt_pa.INT8_SCALE_FLOOR == jax_pa.INT8_SCALE_FLOOR
    assert pt_attention.MASK_VALUE == jax_attention.MASK_VALUE


# ---------------------------------------------------------------------
# Decode
# ---------------------------------------------------------------------


@pytest.mark.parametrize("g", [1, 2])
def test_decode_matches_pallas_kernel(g):
    rng = np.random.default_rng(10 + g)
    for trial in range(3):
        q, kp, vp, tables, pos, active = _random_case(rng, g=g)
        want = np.asarray(jax_pa.paged_decode_attention(
            jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp),
            jnp.asarray(tables), jnp.asarray(pos), jnp.asarray(active),
            block_size=4, max_blocks=6, interpret=True,
        ))
        got = pt_pa.paged_decode_attention(
            _t(q), _t(kp), _t(vp), _t(tables), _t(pos), _t(active),
            block_size=4, max_blocks=6,
        ).numpy()
        assert np.isfinite(got).all(), trial  # the NaN page stayed out
        np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL,
                                   err_msg=f"trial {trial}")
        assert not got[active == 0].any()  # inactive slots: exact zeros


def test_decode_int8_pool_matches_pallas_kernel():
    rng = np.random.default_rng(21)
    q, kp, vp, tables, pos, active = _random_case(rng, poison=False)
    kq, ksc, vq, vsc = _quantized(kp, vp)
    want = np.asarray(jax_pa.paged_decode_attention(
        jnp.asarray(q), jnp.asarray(kq), jnp.asarray(vq),
        jnp.asarray(tables), jnp.asarray(pos), jnp.asarray(active),
        block_size=4, max_blocks=6,
        k_scale=jnp.asarray(ksc), v_scale=jnp.asarray(vsc), interpret=True,
    ))
    got = pt_pa.paged_decode_attention(
        _t(q), _t(kq), _t(vq), _t(tables), _t(pos), _t(active),
        block_size=4, max_blocks=6, k_scale=_t(ksc), v_scale=_t(vsc),
    ).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("g", [1, 4])
def test_decode_bf16_pool_matches_pallas_kernel(g):
    """q and pool in bf16: the Pallas kernel's bf16 matmuls (P rounded
    to bf16 before P.V) against the port's plain version on the same
    bf16 values, under the bf16 rule of checks/tolerance.py."""
    rng = np.random.default_rng(90 + g)
    q, kp, vp, tables, pos, active = _random_case(rng, g=g, d=64,
                                                  block_size=8)
    qb, kb, vb = (_t(a).to(torch.bfloat16) for a in (q, kp, vp))
    want = jax_pa.paged_decode_attention(
        *(jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)
          for t in (qb, kb, vb)),
        jnp.asarray(tables), jnp.asarray(pos), jnp.asarray(active),
        block_size=8, max_blocks=6, interpret=True,
    )
    assert want.dtype == jnp.bfloat16
    got = pt_pa.paged_decode_attention(
        qb, kb, vb, _t(tables), _t(pos), _t(active),
        block_size=8, max_blocks=6,
    )
    assert got.dtype == torch.bfloat16
    assert torch.isfinite(got).all()
    readings = compare(got, _t(np.asarray(want, np.float32)), torch.bfloat16)
    assert readings["ok"], readings


def _run_boundary_case(rng, pps, *, slots=5, hkv=2, g=2, d=16, bs=4, mb=6,
                       num_blocks=24):
    """Slots whose ``pos`` is the last key of run 0, the first key of
    run 1 (runs of ``pps`` pages), 0, and random; the last slot is
    inactive. Dead entries point at the NaN last page."""
    shape = (num_blocks, bs, hkv, d)
    kp = rng.standard_normal(shape).astype(np.float32)
    vp = rng.standard_normal(shape).astype(np.float32)
    kp[0] = vp[0] = 0.0
    kp[-1] = vp[-1] = np.nan
    q = rng.standard_normal((slots, hkv, g, d)).astype(np.float32)
    pos = np.array([pps * bs - 1, pps * bs, 0, rng.integers(0, mb * bs), 7],
                   np.int32)
    active = np.array([1, 1, 1, 1, 0], np.int32)
    tables = np.full((slots, mb), num_blocks - 1, np.int32)
    for s in range(slots - 1):
        n_live = int(pos[s]) // bs + 1
        tables[s, :n_live] = rng.choice(np.arange(1, num_blocks - 1),
                                        size=n_live, replace=False)
    return q, kp, vp, tables, pos, active


@pytest.mark.parametrize("pool", ["float32", "int8", "bfloat16"])
@pytest.mark.parametrize("pps", [1, 2, 3])
def test_decode_split_then_combine_matches_plain_and_pallas(pps, pool):
    """The kernel's two passes written plainly: the view cut into runs
    of ``pps`` pages (6, 3 and 2 runs), each run's partial, then the
    combine, equal the plain decode and the Pallas decode. Runs past
    ``pos`` and the inactive slot's runs have lse exactly MASK_VALUE,
    and their outputs -- never written by the kernel -- are NaN here, so
    a combine that reads them poisons its output. float32 and int8
    pools at ``atol 2e-5 / rtol 1e-5`` (summation order only); bf16 under
    checks/tolerance.py's bf16 rule (P is rounded to bf16 relative to
    each run's own max, not the whole view's)."""
    rng = np.random.default_rng(100 + 10 * pps + len(pool))
    bs, mb = 4, 6
    n_split = -(-mb // pps)
    q, kp, vp, tables, pos, active = _run_boundary_case(rng, pps, bs=bs,
                                                        mb=mb)
    kw = dict(block_size=bs, max_blocks=mb)
    jkw = dict(kw)
    if pool == "int8":
        kp[-1] = vp[-1] = 0.0
        kq, ksc, vq, vsc = _quantized(kp, vp)
        ksc[-1] = vsc[-1] = np.nan
        kp, vp = kq, vq
        kw.update(k_scale=_t(ksc), v_scale=_t(vsc))
        jkw.update(k_scale=jnp.asarray(ksc), v_scale=jnp.asarray(vsc))
    args = [_t(q), _t(kp), _t(vp), _t(tables), _t(pos), _t(active)]
    jargs = [jnp.asarray(a) for a in (q, kp, vp)]
    if pool == "bfloat16":
        for i in range(3):
            args[i] = args[i].to(torch.bfloat16)
            jargs[i] = jnp.asarray(args[i].float().numpy()).astype(
                jnp.bfloat16)
    o_part, lse_part = pt_pa.paged_decode_split_ref(*args, n_split=n_split,
                                                     **kw)
    assert o_part.shape == (5, 2, n_split, 2, 16)
    empty = lse_part <= pt_attention.MASK_VALUE * 0.5
    assert (lse_part[empty] == pt_attention.MASK_VALUE).all()
    assert empty[4].all()                      # the inactive slot
    assert empty[0, :, 1:].all() and not empty[0, :, 0].any()
    assert empty[1, :, 2:].all() and not empty[1, :, :2].any()
    assert empty[2, :, 1:].all()               # pos 0: one key, run 0
    o_part = torch.where(empty[..., None], float("nan"), o_part)
    got = pt_pa.paged_decode_combine_ref(o_part, lse_part, args[5],
                                         args[0].dtype)
    plain = pt_pa.paged_decode_attention_ref(*args, **kw)
    pallas = jax_pa.paged_decode_attention(
        *jargs, *(jnp.asarray(a) for a in (tables, pos, active)),
        interpret=True, **jkw)
    pallas = _t(np.array(pallas, np.float32))
    assert torch.isfinite(got).all()
    assert not got[4].any()                    # inactive: exact zeros
    if pool == "bfloat16":
        for want in (plain, pallas):
            readings = compare(got, want, torch.bfloat16)
            assert readings["ok"], readings
        return
    for want in (plain, pallas):
        np.testing.assert_allclose(got.numpy(), want.numpy(), atol=ATOL,
                                   rtol=RTOL)
    # The combine is lse_merge's rule: folding the live runs pairwise
    # with it gives the same output.
    o_fold, lse_fold = o_part[:, :, 0], lse_part[:, :, 0]
    for run in range(1, n_split):
        o_run = torch.nan_to_num(o_part[:, :, run])
        o_fold, lse_fold = pt_attention.lse_merge(
            torch.nan_to_num(o_fold), lse_fold, o_run, lse_part[:, :, run])
    np.testing.assert_allclose(got.numpy()[:4], o_fold.numpy()[:4],
                               atol=1e-6, rtol=1e-6)


def test_decode_wider_table_reads_only_max_blocks():
    """The engine's table rows are wider than the view (scratch
    padding past capacity); only the first ``max_blocks`` entries are
    the view."""
    rng = np.random.default_rng(22)
    q, kp, vp, tables, pos, active = _random_case(rng)
    wide = np.concatenate(
        [tables, np.full((tables.shape[0], 3), kp.shape[0] - 1, np.int32)],
        axis=1,
    )
    narrow = pt_pa.paged_decode_attention(
        _t(q), _t(kp), _t(vp), _t(tables), _t(pos), _t(active),
        block_size=4, max_blocks=6,
    )
    got = pt_pa.paged_decode_attention(
        _t(q), _t(kp), _t(vp), _t(wide), _t(pos), _t(active),
        block_size=4, max_blocks=6,
    )
    torch.testing.assert_close(got, narrow, atol=0, rtol=0)


# ---------------------------------------------------------------------
# Chunked prefill
# ---------------------------------------------------------------------


@pytest.mark.parametrize("g", [1, 2])
@pytest.mark.parametrize("start", [0, 8, 16])
def test_prefill_matches_pallas_kernel(start, g):
    """``start`` is data: chunk 0 and continuation chunks whose rows
    attend across earlier pages."""
    rng = np.random.default_rng(30 + start + g)
    hkv, bucket, d, bs, mb = 2, 8, 16, 4, 6
    _, kp, vp, _, _, _ = _random_case(rng, g=g)
    table = _table_row(rng, kp.shape[0], mb, -(-(start + bucket) // bs))
    q = rng.standard_normal((hkv, bucket, g, d)).astype(np.float32)
    want = np.asarray(jax_pa.paged_prefill_attention(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp),
        jnp.asarray(table), jnp.asarray(start, jnp.int32),
        block_size=bs, max_blocks=mb, interpret=True,
    ))
    got = pt_pa.paged_prefill_attention(
        _t(q), _t(kp), _t(vp), _t(table), start,
        block_size=bs, max_blocks=mb,
    ).numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("g", [1, 2])
@pytest.mark.parametrize("start", [0, 5])
def test_prefill_bf16_pool_matches_pallas_kernel(start, g):
    """q and pool in bf16: the Pallas kernel's bf16 matmuls against the
    port's plain version on the same bf16 values."""
    rng = np.random.default_rng(80 + start + g)
    hkv, bucket, d, bs, mb = 2, 8, 16, 4, 6
    _, kp, vp, _, _, _ = _random_case(rng, g=g)
    table = _table_row(rng, kp.shape[0], mb, -(-(start + bucket) // bs))
    q = rng.standard_normal((hkv, bucket, g, d)).astype(np.float32)
    qb, kb, vb = (_t(a).to(torch.bfloat16) for a in (q, kp, vp))
    want = jax_pa.paged_prefill_attention(
        *(jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)
          for t in (qb, kb, vb)),
        jnp.asarray(table), jnp.asarray(start, jnp.int32),
        block_size=bs, max_blocks=mb, interpret=True,
    )
    assert want.dtype == jnp.bfloat16
    got = pt_pa.paged_prefill_attention(
        qb, kb, vb, _t(table), start, block_size=bs, max_blocks=mb,
    )
    assert got.dtype == torch.bfloat16
    readings = compare(got, _t(np.asarray(want, np.float32)), torch.bfloat16)
    assert readings["ok"], readings


def test_prefill_int8_pool_matches_pallas_kernel():
    rng = np.random.default_rng(41)
    hkv, bucket, g, d, bs, mb = 2, 8, 2, 16, 4, 6
    _, kp, vp, _, _, _ = _random_case(rng, poison=False)
    table = _table_row(rng, kp.shape[0], mb, -(-(8 + bucket) // bs))
    kq, ksc, vq, vsc = _quantized(kp, vp)
    q = rng.standard_normal((hkv, bucket, g, d)).astype(np.float32)
    want = np.asarray(jax_pa.paged_prefill_attention(
        jnp.asarray(q), jnp.asarray(kq), jnp.asarray(vq),
        jnp.asarray(table), jnp.asarray(8, jnp.int32),
        block_size=bs, max_blocks=mb,
        k_scale=jnp.asarray(ksc), v_scale=jnp.asarray(vsc), interpret=True,
    ))
    got = pt_pa.paged_prefill_attention(
        _t(q), _t(kq), _t(vq), _t(table), 8, block_size=bs, max_blocks=mb,
        k_scale=_t(ksc), v_scale=_t(vsc),
    ).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)


def _prefill_16bit_case(seed, g, start, *, pool_dtype=torch.bfloat16,
                        q_dtype=torch.bfloat16, hkv=2, bucket=32, d=64, bs=8,
                        mb=12, num_blocks=24):
    """One slot's chunk over a 12-page view of 8-token pages. Entries
    past the chunk's last page point at the last page of the pool, whose
    values (float pools) or scales (int8 pools) are NaN. Returns the
    port's arguments, keywords and the Pallas kernel's output (interpret
    mode) as an f32 tensor."""
    rng = np.random.default_rng(seed)
    shape = (num_blocks, bs, hkv, d)
    kp = rng.standard_normal(shape).astype(np.float32)
    vp = rng.standard_normal(shape).astype(np.float32)
    table = _table_row(rng, num_blocks, mb, -(-(start + bucket) // bs))
    q = _t(rng.standard_normal((hkv, bucket, g, d)).astype(np.float32))
    q = q.to(q_dtype)
    jq = jnp.asarray(q.float().numpy()).astype(
        jnp.bfloat16 if q_dtype == torch.bfloat16 else jnp.float16)
    kw = dict(block_size=bs, max_blocks=mb)
    jkw = dict(kw, interpret=True)
    if pool_dtype == torch.int8:
        kq, ksc, vq, vsc = _quantized(kp, vp)
        ksc[-1] = vsc[-1] = np.nan
        k, v = _t(kq), _t(vq)
        jk, jv = jnp.asarray(kq), jnp.asarray(vq)
        kw.update(k_scale=_t(ksc), v_scale=_t(vsc))
        jkw.update(k_scale=jnp.asarray(ksc), v_scale=jnp.asarray(vsc))
    else:
        kp[-1] = vp[-1] = np.nan
        k, v = _t(kp).to(pool_dtype), _t(vp).to(pool_dtype)
        jk, jv = (jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)
                  for t in (k, v))
    want = jax_pa.paged_prefill_attention(
        jq, jk, jv, jnp.asarray(table), jnp.asarray(start, jnp.int32),
        **jkw)
    assert want.dtype == jq.dtype
    return (q, k, v, _t(table), start), kw, _t(np.asarray(want, np.float32))


# (g, start, pinned relative RMS error of the plain prefill against the
# Pallas prefill, bf16 q and pool). Measured on the CPU: 0.000833,
# 0.001263 and 0.001839 with P rounded to bf16 before P.V, as the Pallas
# kernel rounds it; 0.001736, 0.001921 and 0.002022 with P kept in fp32,
# as the plain prefill did before. Each pin lies between the two.
P_ROUNDING_PINS = [(1, 0, 1.2e-3), (2, 5, 1.55e-3), (4, 24, 1.93e-3)]


@pytest.mark.parametrize("g, start, pin", P_ROUNDING_PINS)
def test_prefill_plain_rounds_p_like_pallas(g, start, pin):
    """The plain prefill rounds P to a bf16 pool's dtype before P.V, as
    the Pallas kernel does (paged_attention.py:297-298): against the
    Pallas prefill its relative RMS error stays under a pin that the
    same arithmetic with P in fp32 exceeds."""
    args, kw, want = _prefill_16bit_case(200 + g, g, start)
    got = pt_pa.paged_prefill_attention(*args, **kw)
    assert got.dtype == torch.bfloat16 and torch.isfinite(got).all()
    rel = float((got.float() - want).norm() / want.norm())
    assert rel <= pin, (rel, pin)
    readings = compare(got, want, torch.bfloat16)
    assert readings["ok"], readings


@pytest.mark.parametrize("q_dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("start", [0, 13])
@pytest.mark.parametrize("g", [1, 4])
def test_prefill_int8_pool_under_16bit_q_matches_pallas_kernel(g, start,
                                                              q_dtype):
    """An int8 pool under a bf16 or f16 q (the card's int8 wgmma route):
    chunk 0 and a chunk that starts inside a page, groups 1 and 4; pages
    past the chunk and dead entries have NaN scales. Held by
    checks/tolerance.py's rule for q's dtype."""
    args, kw, want = _prefill_16bit_case(
        300 + 10 * g + start, g, start, pool_dtype=torch.int8,
        q_dtype=q_dtype)
    got = pt_pa.paged_prefill_attention(*args, **kw)
    assert got.dtype == q_dtype and torch.isfinite(got).all()
    readings = compare(got, want, q_dtype)
    assert readings["ok"], readings


_JNP = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16,
        torch.float16: jnp.float16}

# (q dtype, pool dtype): the pairs the card's TF32 prefill route takes
# (float32 q or pool, mixed 16-bit dtypes).
TF32_PAIRS = [
    (torch.float32, torch.float32), (torch.bfloat16, torch.float16),
    (torch.float16, torch.bfloat16), (torch.float32, torch.int8),
    (torch.float32, torch.bfloat16), (torch.bfloat16, torch.float32),
]


@pytest.mark.parametrize("g, start", [(1, 0), (2, 5)])
@pytest.mark.parametrize("q_dtype, pool_dtype", TF32_PAIRS,
                         ids=lambda t: str(t)[6:])
def test_prefill_tf32_route_pairs_match_pallas_kernel(q_dtype, pool_dtype, g,
                                                     start):
    """The pairs the card's TF32 route takes: the plain prefill against
    the Pallas prefill (interpret mode) on the same values -- 16-bit q
    and pools cast once, int8 pools through the port's quantizer -- over
    4-token pages whose dead entries point at a NaN page (NaN scales for
    int8), held by checks/tolerance.py's rule for q's dtype; a float32 q
    over a 16-bit pool by the pool's rule (``rule_dtype``: both sides
    round P to the pool's dtype, each relative to another max)."""
    rng = np.random.default_rng(500 + 10 * g + start)
    hkv, bucket, d, bs, mb, nb = 2, 16, 32, 4, 10, 24
    shape = (nb, bs, hkv, d)
    kp = rng.standard_normal(shape).astype(np.float32)
    vp = rng.standard_normal(shape).astype(np.float32)
    table = _table_row(rng, nb, mb, -(-(start + bucket) // bs))
    q = _t(rng.standard_normal((hkv, bucket, g, d)).astype(np.float32))
    q = q.to(q_dtype)
    kw = dict(block_size=bs, max_blocks=mb)
    jkw = dict(kw, interpret=True)
    if pool_dtype == torch.int8:
        kq, ksc, vq, vsc = _quantized(kp, vp)
        ksc[-1] = vsc[-1] = np.nan
        k, v = _t(kq), _t(vq)
        jk, jv = jnp.asarray(kq), jnp.asarray(vq)
        kw.update(k_scale=_t(ksc), v_scale=_t(vsc))
        jkw.update(k_scale=jnp.asarray(ksc), v_scale=jnp.asarray(vsc))
    else:
        kp[-1] = vp[-1] = np.nan
        k, v = _t(kp).to(pool_dtype), _t(vp).to(pool_dtype)
        jk, jv = (jnp.asarray(t.float().numpy()).astype(_JNP[pool_dtype])
                  for t in (k, v))
    jq = jnp.asarray(q.float().numpy()).astype(_JNP[q_dtype])
    want = jax_pa.paged_prefill_attention(
        jq, jk, jv, jnp.asarray(table), jnp.asarray(start, jnp.int32),
        **jkw)
    got = pt_pa.paged_prefill_attention(q, k, v, _t(table), start, **kw)
    assert got.dtype == q_dtype and torch.isfinite(got).all()
    readings = compare(got, _t(np.array(want, np.float32)),
                       rule_dtype(q_dtype, pool_dtype))
    assert readings["ok"], readings


# ---------------------------------------------------------------------
# Non-finite scores
# ---------------------------------------------------------------------


def _plant(kernel, planted, q, kp, tables, pos):
    """One NaN in a q row or in a key the row sees (slot 0 is active;
    for the prefill, a key of the first live page, seen by every row)."""
    if planted == "q_nan_row":
        q[(0, 1, 0, 3) if kernel == "decode" else (1, 5, 0, 3)] = np.nan
    elif kernel == "decode":
        kp[tables[0, int(pos[0]) // 4], int(pos[0]) % 4, 1, 2] = np.nan
    else:
        kp[tables[0], 1, 0, 5] = np.nan


@pytest.mark.parametrize("planted", ["k_nan_live_key", "q_nan_row"])
@pytest.mark.parametrize("kernel", ["decode", "prefill"])
def test_nonfinite_rows_match_pallas_kernel(kernel, planted):
    """The plain versions the card's kernels are held to keep a NaN
    score's row NaN, as the Pallas kernels' online softmax does (its
    running max takes the NaN): the same rows come out non-finite, the
    others agree at the file's limits, and the poisoned dead page
    stays out."""
    rng = np.random.default_rng(70)
    q, kp, vp, tables, pos, active = _random_case(rng, g=2)
    if kernel == "prefill":
        start, bucket, mb = 5, 8, 6
        tables = _table_row(rng, kp.shape[0], mb, -(-(start + bucket) // 4))
        q = rng.standard_normal((2, bucket, 2, 16)).astype(np.float32)
    _plant(kernel, planted, q, kp, tables, pos)
    if kernel == "decode":
        want = np.asarray(jax_pa.paged_decode_attention(
            jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp),
            jnp.asarray(tables), jnp.asarray(pos), jnp.asarray(active),
            block_size=4, max_blocks=6, interpret=True))
        got = pt_pa.paged_decode_attention(
            _t(q), _t(kp), _t(vp), _t(tables), _t(pos), _t(active),
            block_size=4, max_blocks=6).numpy()
    else:
        want = np.asarray(jax_pa.paged_prefill_attention(
            jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp),
            jnp.asarray(tables), jnp.asarray(start, jnp.int32),
            block_size=4, max_blocks=mb, interpret=True))
        got = pt_pa.paged_prefill_attention(
            _t(q), _t(kp), _t(vp), _t(tables), start,
            block_size=4, max_blocks=mb).numpy()
    bad_want = ~np.isfinite(want).all(axis=-1)
    bad_got = ~np.isfinite(got).all(axis=-1)
    assert bad_want.any() and not bad_want.all()
    np.testing.assert_array_equal(bad_got, bad_want)
    np.testing.assert_allclose(got[~bad_got], want[~bad_want],
                               atol=ATOL, rtol=RTOL)


# ---------------------------------------------------------------------
# int8 quantization
# ---------------------------------------------------------------------


def test_quantize_matches_reference():
    """Scales within rtol 1e-6; payloads equal except where x / scale
    sits on an exact .5 tie, where the two frameworks' divisions may
    round to either side (they then differ by exactly 1)."""
    rng = np.random.default_rng(50)
    pages = rng.standard_normal((12, 4, 2, 16)).astype(np.float32)
    pages[3] = 0.0  # the all-zero page hits the scale floor
    pages[5, 0, 0, :4] = [0.5, -0.5, 1.5, 2.5]  # crafted near-ties
    jq, jsc = jax_pa.quantize_pages_int8(jnp.asarray(pages))
    pq, psc = pt_pa.quantize_pages_int8(_t(pages))
    np.testing.assert_allclose(psc.numpy(), np.asarray(jsc), rtol=1e-6)
    assert psc.dtype == torch.float32 and pq.dtype == torch.int8
    diff = np.abs(pq.numpy().astype(np.int32) - np.asarray(jq, np.int32))
    assert diff.max() <= 1
    ratio = pages / np.asarray(jsc)[:, None, None, None]
    ties = np.isclose(np.abs(ratio) % 1.0, 0.5, atol=1e-4)
    assert not (diff.astype(bool) & ~ties).any()
    assert np.all(psc.numpy()[3] == pt_pa.INT8_SCALE_FLOOR)
    np.testing.assert_allclose(
        pt_pa.dequantize_pages_int8(pq, psc).numpy(),
        np.asarray(jax_pa.dequantize_pages_int8(jq, jsc)),
        atol=float(np.asarray(jsc).max()) + 1e-7, rtol=0,
    )
    np.testing.assert_allclose(
        pt_pa.page_scales_int8(_t(pages)).numpy(),
        np.asarray(jax_pa.page_scales_int8(jnp.asarray(pages))), rtol=1e-6,
    )


def test_round_half_even_and_clip():
    """torch.round rounds half to even like jnp.round; the clip keeps
    -128 unused."""
    pages = np.zeros((1, 4, 1, 4), np.float32)
    pages[0, 0, 0] = [127.0, -127.0, 0.5 * 127 / 127, 2.5]
    q, sc = pt_pa.quantize_pages_int8(_t(pages))
    assert float(sc[0]) == pytest.approx(1.0)
    assert q[0, 0, 0].tolist() == [127, -127, 0, 2]
    assert int(q.min()) >= -127


# ---------------------------------------------------------------------
# The wrappers' contract on the CPU
# ---------------------------------------------------------------------


def test_cpu_tensors_take_the_plain_version_and_count_nothing():
    rng = np.random.default_rng(60)
    q, kp, vp, tables, pos, active = _random_case(rng)
    n_dec = pt_pa.paged_decode_attention.launches
    n_pre = pt_pa.paged_prefill_attention.launches
    got = pt_pa.paged_decode_attention(
        _t(q), _t(kp), _t(vp), _t(tables), _t(pos), _t(active),
        block_size=4, max_blocks=6,
    )
    ref = pt_pa.paged_decode_attention_ref(
        _t(q), _t(kp), _t(vp), _t(tables), _t(pos), _t(active),
        block_size=4, max_blocks=6,
    )
    torch.testing.assert_close(got, ref, atol=0, rtol=0)
    table = _table_row(rng, kp.shape[0], 6, 4)
    qp = _t(rng.standard_normal((2, 8, 2, 16)).astype(np.float32))
    got = pt_pa.paged_prefill_attention(
        qp, _t(kp), _t(vp), _t(table), 4, block_size=4, max_blocks=6,
    )
    ref = pt_pa.paged_prefill_attention_ref(
        qp, _t(kp), _t(vp), _t(table), 4, block_size=4, max_blocks=6,
    )
    torch.testing.assert_close(got, ref, atol=0, rtol=0)
    assert pt_pa.paged_decode_attention.launches == n_dec
    assert pt_pa.paged_prefill_attention.launches == n_pre


def test_prefill_route_is_asked_of_the_library_in_use():
    """paged_prefill_route names the route of the library the wrappers
    launch from: a variant under ``_build.use_library`` (such as a build
    with -DTPUHPC_PREFILL_BOXES=0) is asked on its own, never answered
    from what another library said for the same shape."""
    from tpu_hpc_torch.kernels import _build

    class Lib:
        def __init__(self, code):
            self.code = code

        def tpuhpc_prefill_route(self, d, bs, q_code, kv_code):
            return self.code

    args = (torch.bfloat16, torch.bfloat16, 128, 16)
    for code, name in ((1, "wgmma"), (4, "wgmma_gather"), (1, "wgmma")):
        with _build.use_library(Lib(code)):
            assert pt_pa.paged_prefill_route(*args) == name
    with _build.use_library(Lib(-1)):
        with pytest.raises(TypeError, match="no prefill kernel"):
            pt_pa.paged_prefill_route(*args)


def test_wrappers_reject_what_the_kernel_does_not_take():
    rng = np.random.default_rng(61)
    q, kp, vp, tables, pos, active = _random_case(rng)
    args = [_t(q), _t(kp), _t(vp), _t(tables), _t(pos), _t(active)]
    kw = dict(block_size=4, max_blocks=6)
    with pytest.raises(TypeError, match="int32"):
        pt_pa.paged_decode_attention(*args[:3], args[3].long(), *args[4:], **kw)
    with pytest.raises(ValueError, match="block_size"):
        pt_pa.paged_decode_attention(*args, block_size=8, max_blocks=3)
    with pytest.raises(ValueError, match="together"):
        pt_pa.paged_decode_attention(*args, k_scale=torch.ones(24), **kw)
    with pytest.raises(ValueError, match="int8"):
        pt_pa.paged_decode_attention(
            *args, k_scale=torch.ones(24), v_scale=torch.ones(24), **kw
        )
    with pytest.raises(TypeError, match="q dtype"):
        pt_pa.paged_decode_attention(args[0].to(torch.int8), *args[1:], **kw)
    with pytest.raises(ValueError, match="outside"):
        pt_pa.paged_prefill_attention(
            _t(q[:2]), _t(kp), _t(vp), _t(tables[0]), 24, **kw
        )


# ---------------------------------------------------------------------
# int8 divergence probe
# ---------------------------------------------------------------------
# TINY's attention dims (tests/test_paged_kernels.py's probe case) and
# the 7B's at its 16-token pages (bench.py's logit_rmse pin).
PROBE_DIMS = [
    dict(head_dim=16, kv_heads=2, n_heads=4, seq_len=48, block_size=4),
    dict(head_dim=128, kv_heads=32, n_heads=32, block_size=16),
]
INT8_LOGIT_TOL = 0.02  # tests/test_paged_kernels.py's pin at TINY


@pytest.mark.parametrize("dims", PROBE_DIMS, ids=["tiny", "7b"])
def test_int8_logit_rmse_equals_jax_on_its_arrays(dims):
    """Fed the JAX function's own jax.random q and k, the port's score
    arithmetic gives the JAX value."""
    want = jax_pa.int8_logit_rmse(**dims)
    n_heads = dims.get("n_heads") or dims["kv_heads"]
    kq, kk = jax.random.split(jax.random.PRNGKey(0))
    q = jax.random.normal(kq, (n_heads, dims["head_dim"]), jnp.float32)
    k = jax.random.normal(
        kk, (dims.get("seq_len", 256), dims["kv_heads"], dims["head_dim"]),
        jnp.float32)
    got = pt_pa.int8_logit_rmse_of(torch.from_numpy(np.array(q)),
                                   torch.from_numpy(np.array(k)),
                                   dims["block_size"])
    assert got == pytest.approx(want, rel=1e-6)


def test_int8_logit_rmse_pins_the_tolerance():
    """The port's probe draws its own q and k from a seeded CPU
    generator: deterministic, and under the JAX pin at TINY's dims."""
    r = pt_pa.int8_logit_rmse(**PROBE_DIMS[0])
    assert r == pt_pa.int8_logit_rmse(**PROBE_DIMS[0])
    assert 0.0 < r < INT8_LOGIT_TOL
    assert pt_pa.int8_logit_rmse(**PROBE_DIMS[0], seed=1) != r


@pytest.mark.parametrize("bad,match", [
    (dict(head_dim=16, kv_heads=2, seq_len=50, block_size=4),
     "multiple of block_size"),
    (dict(head_dim=16, kv_heads=2, n_heads=3), "multiple of kv_heads"),
], ids=["seq_len", "n_heads"])
def test_int8_logit_rmse_validates_shapes_like_jax(bad, match):
    with pytest.raises(ValueError, match=match) as got:
        pt_pa.int8_logit_rmse(**bad)
    with pytest.raises(ValueError) as want:
        jax_pa.int8_logit_rmse(**bad)
    assert str(got.value) == str(want.value)
