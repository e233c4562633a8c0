"""The port's CUDA kernels on the card (``-m gpu``).

Run on a machine with an NVIDIA H100:

    python -m pytest tests/test_torch_*.py -m gpu

Each test decides inside the ``cuda`` fixture whether a card is
present, and skips with a reason where there is none. The kernels are
built from tpu_hpc_torch/csrc at the first launch and held against
their plain PyTorch versions at small shapes (head_dim 64 and 128, pages
of 1 to 250 tokens, GQA groups 1 to 8); dead table entries point at NaN
pages, so a read of a dead page poisons the output. The prefill tests
also assert which kernel the library routes each launch to. This file
imports no JAX: the card machine need not have it.

Tolerance ``2e-2``: bf16 outputs of O(1) attention values against the
plain version's fp32 arithmetic on the same inputs -- the output's bf16
rounding (2^-8 relative) dominates. Prefill outputs under a 16-bit q
must also pass tpu_hpc_torch/checks/tolerance.py's rule for q's dtype
(the flash kernels' rule): the wgmma kernel rounds P to the pool's dtype
before P.V, as the Pallas kernel and the plain version do; the int8
wgmma kernel rounds P times the key's V scale to q's dtype where the
plain version keeps fp32; the scalar kernel rounds P to a 16-bit pool's
dtype as the plain version does. Decode
outputs are held by that rule for the output's dtype (the decode and
its plain version both round P to a 16-bit pool's dtype, each relative
to its own running max). Float32 engines must agree on every greedy
token.
"""
import numpy as np
import pytest
import torch

from tpu_hpc_torch.checks.tolerance import compare, rule_dtype
from tpu_hpc_torch.kernels import paged_attention as pa
from tpu_hpc_torch.models import llama2
from tpu_hpc_torch.serve import (
    ContinuousBatcher,
    PagedConfig,
    PagedEngine,
    Request,
    ServeConfig,
)

TOL = 2e-2


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (python -m pytest "
                    "tests/test_torch_*.py -m gpu on the card)")
    return torch.device("cuda")


def _case(rng, slots=5, hkv=2, g=4, d=128, bs=16, mb=5, num_blocks=20):
    """Pool, tables, positions; the last page is NaN and every dead
    entry points at it; slot ``slots-1`` is inactive."""
    shape = (num_blocks, bs, hkv, d)
    kp = rng.standard_normal(shape).astype(np.float32)
    vp = rng.standard_normal(shape).astype(np.float32)
    kp[-1] = vp[-1] = np.nan
    q = rng.standard_normal((slots, hkv, g, d)).astype(np.float32)
    pos = rng.integers(0, mb * bs, size=slots).astype(np.int32)
    active = np.ones(slots, np.int32)
    active[-1] = 0
    tables = np.full((slots, mb + 2), num_blocks - 1, np.int32)
    for s in range(slots - 1):
        n_live = int(pos[s]) // bs + 1
        tables[s, :n_live] = rng.choice(
            np.arange(1, num_blocks - 1), size=n_live, replace=False
        )
    return q, kp, vp, tables, pos, active


def _pool(dev, kp, vp, pool):
    k = torch.from_numpy(kp).to(dev)
    v = torch.from_numpy(vp).to(dev)
    if pool == "int8":
        k, ksc = pa.quantize_pages_int8(k)
        v, vsc = pa.quantize_pages_int8(v)
        return k, v, dict(k_scale=ksc, v_scale=vsc)
    dtype = getattr(torch, pool)
    return k.to(dtype), v.to(dtype), {}


# Pool kinds of the decode tests: (pool dtype, q dtype).
DECODE_POOLS = {
    "float32": ("float32", torch.float32),
    "float16": ("float16", torch.float16),
    "bfloat16": ("bfloat16", torch.bfloat16),
    "int8": ("int8", torch.bfloat16),
    "bf16_q_over_f16_pool": ("float16", torch.bfloat16),
}


def _decode_long(dev, kind, *, g, d, bs, slots=6, hkv=2, mb=64, seed=0):
    """Contexts that cross several of the kernel's runs: a full 64-page
    view, the last key of run 0 and the first key of run 1 (``pos`` on
    a run boundary), ``pos`` 0, a random ``pos``, and an inactive slot.
    Dead table entries (inside a run too) point at a NaN page; in float
    pools the keys past ``pos`` of a slot's last live page are NaN as
    well (int8 pools: the dead page's scale is NaN)."""
    rng = np.random.default_rng(seed)
    pool, q_dtype = DECODE_POOLS[kind]
    pps = -(-mb // pa.paged_decode_splits(slots, hkv, g, mb))
    pos = np.array([mb * bs - 1, pps * bs - 1, pps * bs, 0,
                    rng.integers(0, mb * bs), 5 * bs + 3], np.int32)
    active = np.ones(slots, np.int32)
    active[-1] = 0
    n_live = [int(p) // bs + 1 for p in pos]
    num_blocks = sum(n_live) + 2
    shape = (num_blocks, bs, hkv, d)
    kp = rng.standard_normal(shape).astype(np.float32)
    vp = rng.standard_normal(shape).astype(np.float32)
    kp[-1] = vp[-1] = np.nan
    tables = np.full((slots, mb + 3), num_blocks - 1, np.int32)
    pages = rng.permutation(np.arange(1, num_blocks - 1)).astype(np.int32)
    nxt = 0
    for s in range(slots):
        tables[s, :n_live[s]] = pages[nxt:nxt + n_live[s]]
        nxt += n_live[s]
        if pool != "int8" and active[s]:
            last, tail = tables[s, n_live[s] - 1], int(pos[s]) % bs + 1
            kp[last, tail:] = vp[last, tail:] = np.nan
    k, v, scales = _pool(dev, kp, vp, pool)
    q = torch.from_numpy(
        rng.standard_normal((slots, hkv, g, d)).astype(np.float32)
    ).to(dev, q_dtype)
    args = (q, k, v, *(torch.from_numpy(a).to(dev)
                       for a in (tables, pos, active)))
    return args, dict(block_size=bs, max_blocks=mb, **scales)


def _check_decode(args, kw):
    n0 = pa.paged_decode_attention.launches
    got = pa.paged_decode_attention(*args, **kw)
    torch.cuda.synchronize()
    assert pa.paged_decode_attention.launches == n0 + 1
    want = pa.paged_decode_attention_ref(*args, **kw)
    assert torch.isfinite(got).all()
    assert not got[args[5] == 0].any()  # inactive slot: exact zeros
    readings = compare(got, want, got.dtype)
    assert readings["ok"], readings
    return got


@pytest.mark.gpu
@pytest.mark.parametrize("pool", list(DECODE_POOLS))
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("g", [1, 2, 8])
@pytest.mark.parametrize("bs", [8, 16, 32, 64])
def test_decode_kernel_matches_plain(cuda, bs, g, d, pool):
    """Every pool kind over page sizes 8-64, groups 1-8 and both
    head-dim variants, on contexts that cross several runs, held by
    checks/tolerance.py's rule for the output's dtype."""
    _check_decode(*_decode_long(cuda, pool, g=g, d=d, bs=bs,
                                seed=bs + 3 * g + d))


@pytest.mark.gpu
@pytest.mark.parametrize("g", [1, 8])
def test_decode_kernel_is_bit_identical_across_launches(cuda, g):
    """The runs are merged in a fixed order, with no atomics."""
    args, kw = _decode_long(cuda, "bfloat16", g=g, d=128, bs=16, seed=g)
    first = _check_decode(args, kw)
    again = pa.paged_decode_attention(*args, **kw)
    assert torch.equal(first, again)


@pytest.mark.gpu
def test_decode_kernel_short_views(cuda):
    """A view of fewer than eight pages takes one run, whose block
    writes the output itself (no combine)."""
    rng = np.random.default_rng(70)
    q, kp, vp, tables, pos, active = _case(rng)
    assert pa.paged_decode_splits(5, 2, 4, 5) == 1
    k, v, scales = _pool(cuda, kp, vp, "bfloat16")
    args = (torch.from_numpy(q).to(cuda, torch.bfloat16), k, v,
            *(torch.from_numpy(a).to(cuda) for a in (tables, pos, active)))
    _check_decode(args, dict(block_size=16, max_blocks=5, **scales))


# Pool kinds of the prefill tests: (pool dtype, q dtype, the kernel the
# library must route the launch to).
PREFILL_POOLS = {
    "bfloat16": ("bfloat16", torch.bfloat16, "wgmma"),
    "float16": ("float16", torch.float16, "wgmma"),
    "int8": ("int8", torch.bfloat16, "wgmma_int8"),
    "int8_f16_q": ("int8", torch.float16, "wgmma_int8"),
    "f32_q_over_int8_pool": ("int8", torch.float32, "wgmma_tf32"),
    "float32": ("float32", torch.float32, "wgmma_tf32"),
    "bf16_q_over_f16_pool": ("float16", torch.bfloat16, "wgmma_tf32"),
    "f16_q_over_bf16_pool": ("bfloat16", torch.float16, "wgmma_tf32"),
    "f32_q_over_bf16_pool": ("bfloat16", torch.float32, "wgmma_tf32"),
    "f32_q_over_f16_pool": ("float16", torch.float32, "wgmma_tf32"),
    "bf16_q_over_f32_pool": ("float32", torch.bfloat16, "wgmma_tf32"),
    "f16_q_over_f32_pool": ("float32", torch.float16, "wgmma_tf32"),
}
# The pool kinds the TF32 route takes (every pair but 16-bit q over its
# own dtype or over int8).
TF32_POOLS = [k for k, (_, _, route) in PREFILL_POOLS.items()
              if route == "wgmma_tf32"]


def _prefill(dev, kind, *, hkv=2, bucket=32, g=4, d=128, bs=16, start=0,
             seed=0, spread=False):
    """A chunk of ``bucket`` positions at ``start`` over one table row:
    live pages up to the chunk's last row, then dead entries that point
    at a NaN page -- as does every row of the last 64-key tile past the
    live pages, so a kernel that reads a page past the limit, or feeds
    an unloaded row into P.V, poisons its output (int8 pools: the NaN
    page's scales are NaN). ``spread``: the live pages' keys and values
    scaled by 1/4 and 4 in turns along the table row, so neighbouring
    pages' int8 scales differ 16-fold. The route is the pair's on pages TMA boxes tile
    (:func:`_route_at` gives it at ``bs``)."""
    rng = np.random.default_rng(seed)
    pool, q_dtype, route = PREFILL_POOLS[kind]
    ctx_pages = (start + bucket - 1) // bs + 1
    mb = ctx_pages + 2
    num_blocks = mb + 8
    shape = (num_blocks, bs, hkv, d)
    kp = rng.standard_normal(shape).astype(np.float32)
    vp = rng.standard_normal(shape).astype(np.float32)
    kp[-1] = vp[-1] = np.nan
    table = np.full(mb + 2, num_blocks - 1, np.int32)
    table[:ctx_pages] = rng.choice(
        np.arange(1, num_blocks - 1), size=ctx_pages, replace=False
    )
    if spread:
        for i, page in enumerate(table[:ctx_pages]):
            kp[page] *= 4.0 if i % 2 else 0.25
            vp[page] *= 0.25 if i % 2 else 4.0
    k, v, scales = _pool(dev, kp, vp, pool)
    q = torch.from_numpy(
        rng.standard_normal((hkv, bucket, g, d)).astype(np.float32)
    ).to(dev, q_dtype)
    args = (q, k, v, torch.from_numpy(table).to(dev), start)
    return args, dict(block_size=bs, max_blocks=mb, **scales), route


def _check_prefill(args, kw, route):
    q, k = args[0], args[1]
    assert pa.paged_prefill_route(q.dtype, k.dtype, q.shape[-1],
                                  kw["block_size"]) == route
    n0 = pa.paged_prefill_attention.launches
    r0 = pa.paged_prefill_attention.route_launches[route]
    got = pa.paged_prefill_attention(*args, **kw)
    torch.cuda.synchronize()
    assert pa.paged_prefill_attention.launches == n0 + 1
    assert pa.paged_prefill_attention.route_launches[route] == r0 + 1
    want = pa.paged_prefill_attention_ref(*args, **kw)
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got.float(), want.float(), atol=TOL, rtol=TOL)
    readings = compare(got, want, rule_dtype(
        q.dtype, None if k.dtype == torch.int8 else k.dtype))
    assert readings["ok"], readings


@pytest.mark.gpu
@pytest.mark.parametrize("pool", list(PREFILL_POOLS))
@pytest.mark.parametrize("start", [0, 40])
def test_prefill_kernel_matches_plain(cuda, pool, start):
    """Every pool kind, on the route the library reports: 16-bit q and
    pool of one dtype take the wgmma kernel, an int8 pool under a 16-bit
    q the int8 wgmma kernel, every other pair (float32 q or pool, mixed
    16-bit dtypes) the TF32 wgmma kernel."""
    _check_prefill(*_prefill(cuda, pool, start=start, seed=71 + start))


@pytest.mark.gpu
@pytest.mark.parametrize("pool",
                         ["bfloat16", "float16", "int8", "int8_f16_q"])
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("g", [1, 4, 8])
@pytest.mark.parametrize("bs", [8, 16, 32, 64])
def test_prefill_wgmma_kernel_shapes(cuda, bs, g, d, pool):
    """Both tensor-core prefills (a 16-bit pool; an int8 pool under a
    bf16 or f16 q) over page sizes that stack 8, 4, 2 or 1 pages into a
    64-key tile, query groups, both head-dim variants, at a start that
    is not page-aligned; dead entries point at a page of NaNs (for int8,
    a page whose scales are NaN)."""
    _check_prefill(*_prefill(cuda, pool, g=g, d=d, bs=bs, start=40,
                             seed=bs + g + d))


@pytest.mark.gpu
@pytest.mark.parametrize("pool", ["bfloat16", "int8"])
@pytest.mark.parametrize("d", [48, 80, 112])
def test_prefill_kernel_narrow_head_dims(cuda, d, pool):
    """Head dims the tensor-core routes take below their 64- or
    128-column tiles: the columns past d are zeros, never read."""
    _check_prefill(*_prefill(cuda, pool, g=2, d=d, bs=16, start=40,
                             seed=120 + d))


@pytest.mark.gpu
@pytest.mark.parametrize("pool", ["bfloat16", "int8", "int8_f16_q"])
@pytest.mark.parametrize("bs", [16, 64])
def test_prefill_kernel_long_chunks(cuda, bs, pool):
    """A 256-token chunk at start 200: row tiles walk up to 8 key tiles,
    so the tensor-core routes wrap their 3-stage rings, and every tile
    after the first is full."""
    _check_prefill(*_prefill(cuda, pool, bucket=256, g=1, bs=bs, start=200,
                             seed=110 + bs))


@pytest.mark.gpu
@pytest.mark.parametrize("start", [0, 40])
@pytest.mark.parametrize("bs", [12, 16, 128])
@pytest.mark.parametrize("pool", ["bfloat16", "int8"])
def test_prefill_wgmma_kernel_ragged_rows(cuda, bs, start, pool):
    """bucket * g = 40 rows: one 64-row tile, partly past the end; pages
    of 128 keys are read as two 64-key tiles; pages of 12 are gathered
    (bf16 on the gathering route)."""
    args, kw, route = _prefill(cuda, pool, bucket=40, g=1, bs=bs,
                               start=start, seed=90 + bs)
    _check_prefill(args, kw, _route_at(route, bs))


@pytest.mark.gpu
@pytest.mark.parametrize("pool", TF32_POOLS)
@pytest.mark.parametrize("d", [64, 96, 128])
@pytest.mark.parametrize("bs", [8, 16, 32, 64, 128])
def test_prefill_tf32_kernel_shapes(cuda, bs, d, pool):
    """The TF32 route for every pair it takes, over pages that stack 8,
    4 or 2 into a 64-key tile or split into them, both head-dim variants
    and d 96 (columns past d read as zeros), 40 grouped rows (one
    ragged 64-row tile) at a start inside a page; dead entries point at
    a NaN page. Held by the rule for q's dtype, or a coarser 16-bit
    pool's (rule_dtype)."""
    _check_prefill(*_prefill(cuda, pool, bucket=20, g=2, d=d, bs=bs,
                             start=37, seed=bs + d))


@pytest.mark.gpu
@pytest.mark.parametrize("pool", ["float32", "f32_q_over_int8_pool",
                                  "bf16_q_over_f32_pool"])
def test_prefill_tf32_kernel_long_chunk(cuda, pool):
    """A 256-token chunk at start 200: the TF32 route's rings wrap many
    times (2 stages over a float32 pool, 4 over an int8 one)."""
    _check_prefill(*_prefill(cuda, pool, bucket=256, g=1, bs=16, start=200,
                             seed=140))


# Head dims past 128 on the TF32 route (kD 256: two blocks a row tile,
# each holding half of the output's columns and streaming every K tile
# but only its half of V): 136 (the second half 8 columns wide), 200 and
# 256, on pages TMA boxes would tile (16) and two they could not (12,
# 250).
TF32_WIDE_DIMS = [136, 200, 256]
TF32_WIDE_PAGES = [16, 12, 250]


@pytest.mark.gpu
@pytest.mark.parametrize("pool", TF32_POOLS)
@pytest.mark.parametrize("d", TF32_WIDE_DIMS)
@pytest.mark.parametrize("bs", TF32_WIDE_PAGES)
def test_prefill_tf32_kernel_past_head_dim_128(cuda, bs, d, pool):
    """Every pair the TF32 route takes at head dims 129-256, on its route
    (never the scalar one), at Gemma-2B's grouping (1 KV head, group 8):
    a 40-row chunk at a start inside a page (five 64-row tiles, the last
    ragged), dead entries on a NaN page; held by the rule for q's dtype
    (float32: 1e-4), or a coarser 16-bit pool's."""
    _check_prefill(*_prefill(cuda, pool, hkv=1, bucket=40, g=8, d=d, bs=bs,
                             start=37, seed=400 + bs + d))


@pytest.mark.gpu
@pytest.mark.parametrize("pool", ["float32", "f32_q_over_int8_pool",
                                  "bf16_q_over_f32_pool",
                                  "f32_q_over_bf16_pool"])
def test_prefill_tf32_kernel_long_chunk_at_head_dim_256(cuda, pool):
    """Gemma's serving chunk (240 rows of group 8 at start 240, 30 row
    tiles, 60 blocks): a float32 pool's one-stage ring and the two-stage
    ones wrap 15 times."""
    _check_prefill(*_prefill(cuda, pool, hkv=1, bucket=240, g=8, d=256,
                             bs=16, start=240, seed=440))


# Page sizes TMA boxes cannot tile (neither a divisor of 64 from 8 up
# nor a multiple of 64), up to a 250-token page at head_dim 128.
ODD_PAGES = [1, 4, 12, 24, 48, 100, 250]


def _route_at(route, bs):
    """The route of a pair whose route on TMA-tiled pages is ``route``,
    at pages of ``bs`` tokens: 16-bit q over its own dtype gathers on
    pages TMA boxes cannot tile; every other route takes any page."""
    boxes = (bs >= 8 and 64 % bs == 0) or bs % 64 == 0
    return "wgmma_gather" if route == "wgmma" and not boxes else route


def _route_for(route, bs, d):
    """The route of a pair whose route at head_dim 128 on TMA-tiled pages
    is ``route``, at pages of ``bs`` tokens and head_dim ``d``: TMA boxes
    only where they tile the pages and stride the rows (d % 8 == 0),
    else the gathering kernel; the TF32 route at every d up to 256;
    every pair past 256 on the scalar route."""
    if d > pa.MAX_HEAD_DIM:
        return "scalar"
    if route == "wgmma_tf32":
        return route
    if route == "wgmma" and d % 8:
        return "wgmma_gather"
    return _route_at(route, bs)


@pytest.mark.gpu
@pytest.mark.parametrize("pool", ["float32", "bf16_q_over_f16_pool",
                                  "bfloat16", "int8"])
@pytest.mark.parametrize("d", [72, 200, 300])
def test_prefill_scalar_route_outside_the_page_rule(cuda, d, pool):
    """The route rule by head dim on pages of 12 tokens: at d 72 every
    pair is on a tensor-core route (padded to 128); at d 200 every pair
    still is (kD 256: the float32 and mixed pairs on the TF32 route's
    column halves); at d 300 every pair takes the scalar kernel."""
    args, kw, route = _prefill(cuda, pool, g=2, d=d, bs=12, start=30,
                               seed=150)
    want = _route_for(route, 12, d)
    assert (want == "scalar") == (d > 256)
    _check_prefill(args, kw, want)


@pytest.mark.gpu
def test_decode_refuses_head_dims_past_256(cuda):
    """The decode takes every head dim up to 256 and raises past it,
    naming its ROADMAP item, with no launch."""
    args, kw = _decode_long(cuda, "bfloat16", g=2, d=264, bs=16, mb=8)
    n0 = pa.paged_decode_attention.launches
    with pytest.raises(ValueError, match="Paged attention past head_dim 256"):
        pa.paged_decode_attention(*args, **kw)
    assert pa.paged_decode_attention.launches == n0


# Head dims around and between the 64-, 128- and 256-column
# instantiations: 8 (a sliver of a 64-column tile), 24, 36 (72-byte bf16
# rows on 8-byte boundaries, 36-byte int8 rows on 4: no tensor map, a
# partial last chunk), 37 (odd: 74-byte bf16 rows on 2-byte boundaries,
# 37-byte int8 rows on 1, 148-byte float32 rows on 4; the decode's
# combine by element), 50 (d % 4 == 2: 100-byte bf16 rows on 4, 50-byte
# int8 rows on 2), 72, 100 (200-byte bf16 rows), 136 (kD 256 with two
# of its four panels past d), 192, 256; pages that TMA boxes stack (8,
# 16), split (64) and gather (12, 250).
HEAD_DIMS = [8, 24, 36, 37, 50, 72, 100, 136, 192, 256]
HEAD_DIM_PAGES = [8, 12, 16, 64, 250]


@pytest.mark.gpu
@pytest.mark.parametrize("pool", list(PREFILL_POOLS))
@pytest.mark.parametrize("d", HEAD_DIMS)
@pytest.mark.parametrize("bs", HEAD_DIM_PAGES)
def test_prefill_kernel_at_every_head_dim(cuda, bs, d, pool):
    """Every pair at every head dim up to 256 on its route (_route_for):
    the 16-bit routes padded to 64, 128 or 256 columns (TMA boxes where
    they tile the pages and stride the rows, the gathering producer
    elsewhere, Q loaded by it where no tensor map can stride q), the
    TF32 route up to 256 (column halves past 128); a chunk of 20 rows of
    group 2 at a start inside a page, dead entries pointing at a NaN
    page, so a load past a row's end or a page's shows."""
    args, kw, route = _prefill(cuda, pool, bucket=20, g=2, d=d, bs=bs,
                               start=37, seed=300 + bs + d)
    _check_prefill(args, kw, _route_for(route, bs, d))


@pytest.mark.gpu
@pytest.mark.parametrize("pool", ["bfloat16", "float16"])
@pytest.mark.parametrize("d", HEAD_DIMS)
def test_prefill_head_dims_bit_identical_across_page_sizes(cuda, d, pool):
    """The same keys through 12- and 16-token pages on the 16-bit routes
    (gathered against TMA boxes where d % 8 == 0, gathered both ways
    elsewhere) at every head dim: equal bit for bit."""
    outs = []
    for size in (12, 16):
        args, kw = _same_keys(cuda, pool, size, d=d, seed=320 + d)
        _check_prefill(args, kw, _route_for("wgmma", size, d))
        outs.append(pa.paged_prefill_attention(*args, **kw))
    torch.cuda.synchronize()
    assert torch.equal(outs[0], outs[1])


@pytest.mark.gpu
@pytest.mark.parametrize("n_split", [None, 1])
@pytest.mark.parametrize("pool", list(DECODE_POOLS))
@pytest.mark.parametrize("d", HEAD_DIMS)
@pytest.mark.parametrize("bs", HEAD_DIM_PAGES)
def test_decode_kernel_at_every_head_dim(cuda, bs, d, pool, n_split):
    """Every pool kind at every head dim up to 256 (group 8 over 2 KV
    heads: two 4-row blocks a head), rows staged 16-byte aligned whatever
    d, on contexts that cross the runs (the library's count), and in one
    run (n_split 1: the split kernel writes the output); held by the rule
    for the output's dtype."""
    args, kw = _decode_long(cuda, pool, g=8, d=d, bs=bs, mb=8 if bs == 250
                            else 64, seed=340 + bs + d)
    n0 = pa.paged_decode_attention.launches
    got = pa.paged_decode_attention(*args, **kw, n_split=n_split)
    torch.cuda.synchronize()
    assert pa.paged_decode_attention.launches == n0 + 1
    want = pa.paged_decode_attention_ref(*args, **kw)
    assert torch.isfinite(got).all()
    assert not got[args[5] == 0].any()
    readings = compare(got, want, got.dtype)
    assert readings["ok"], readings


@pytest.mark.gpu
@pytest.mark.parametrize("pool", list(PREFILL_POOLS))
@pytest.mark.parametrize("d", [64, 96, 128])
@pytest.mark.parametrize("bs", ODD_PAGES)
def test_prefill_kernel_at_any_page_size(cuda, bs, d, pool):
    """Every pair over pages TMA boxes cannot tile, on a tensor-core
    route: 16-bit q over its own dtype on the gathering kernel, an int8
    pool under a 16-bit q on the gathering kernel with per-key scales,
    every other pair on the TF32 kernel. Both head-dim variants and d 96
    (columns past d written as zeros); a start inside a page; 20 rows
    of group 2 (one ragged 64-row tile); dead entries point at a NaN
    page."""
    args, kw, route = _prefill(cuda, pool, bucket=20, g=2, d=d, bs=bs,
                               start=37, seed=170 + bs + d)
    _check_prefill(args, kw, _route_at(route, bs))


@pytest.mark.gpu
@pytest.mark.parametrize("pool", ["bfloat16", "int8"])
@pytest.mark.parametrize("bs", [12, 100])
def test_prefill_gather_kernel_long_chunks(cuda, bs, pool):
    """A 256-token chunk at start 200 over odd pages: the gathering
    kernel's 3-stage ring wraps, and tiles span up to six pages or part
    of one."""
    args, kw, route = _prefill(cuda, pool, bucket=256, g=1, bs=bs,
                               start=200, seed=180 + bs)
    _check_prefill(args, kw, _route_at(route, bs))


def _same_keys(dev, kind, bs, *, hkv=2, bucket=32, g=2, d=128, start=37,
               seed=0):
    """One sequence of keys and values (the same for every ``bs``: 512
    positions from ``seed``) laid out in pages of ``bs`` tokens in a
    shuffled order, whole pages up to the chunk's last row, and dead
    entries that point at a NaN page; q from ``seed``. Keys past the
    chunk in its last page are the sequence's, finite, whatever
    ``bs``."""
    rng = np.random.default_rng(seed)
    pool, q_dtype, _ = PREFILL_POOLS[kind]
    seq = rng.standard_normal((2, 512, hkv, d)).astype(np.float32)
    q = torch.from_numpy(
        rng.standard_normal((hkv, bucket, g, d)).astype(np.float32)
    ).to(dev, q_dtype)
    n_pages = -(-(start + bucket) // bs)
    mb = n_pages + 2
    num_blocks = mb + 4
    pages = np.full((2, num_blocks, bs, hkv, d), np.nan, np.float32)
    ids = np.random.default_rng(bs).permutation(
        np.arange(1, num_blocks - 1))[:n_pages]
    pages[:, ids] = seq[:, :n_pages * bs].reshape(2, n_pages, bs, hkv, d)
    table = np.full(mb + 2, num_blocks - 1, np.int32)
    table[:n_pages] = ids
    k, v = (torch.from_numpy(p).to(dev, getattr(torch, pool))
            for p in pages)
    args = (q, k, v, torch.from_numpy(table).to(dev), start)
    return args, dict(block_size=bs, max_blocks=mb)


@pytest.mark.gpu
@pytest.mark.parametrize("pool", ["bfloat16", "float16", "float32",
                                  "bf16_q_over_f16_pool",
                                  "f32_q_over_bf16_pool"])
@pytest.mark.parametrize("bs", ODD_PAGES)
def test_prefill_is_bit_identical_across_page_sizes(cuda, bs, pool):
    """The same keys through pages of ``bs`` tokens and of 16: the tiles
    the walk reads hold the same values wherever the mask lets a key
    through (the gathering producer writes zeros where the TMA route may
    hold a hidden key), so the outputs are equal bit for bit -- for
    16-bit q over its own dtype (gathering against TMA) and for the
    TF32 route's pairs. int8 pools are quantized per page, so another
    page size holds other values."""
    route = PREFILL_POOLS[pool][2]
    outs = []
    for size in (bs, 16):
        args, kw = _same_keys(cuda, pool, size, seed=195)
        _check_prefill(args, kw, _route_at(route, size))
        outs.append(pa.paged_prefill_attention(*args, **kw))
    torch.cuda.synchronize()
    assert torch.equal(outs[0], outs[1])


@pytest.mark.gpu
@pytest.mark.parametrize("pool", ["int8", "int8_f16_q"])
@pytest.mark.parametrize("bs", [4, 12, 100])
def test_prefill_int8_scales_straddle_groups(cuda, bs, pool):
    """Pages of 4, 12 or 100 tokens: an 8-key group of a tile straddles
    two pages whose scales differ up to 16-fold. The gathering kernel
    reads each key's own page scales, within the rule; the same chunk
    with each key dequantized by the scale of its 8-key group's first
    key (what one scale a group would give) must be rejected by it."""
    args, kw, route = _prefill(cuda, pool, g=2, bs=bs, start=90, seed=200,
                               spread=True)
    _check_prefill(args, kw, route)
    got = pa.paged_prefill_attention(*args, **kw)
    q, k, v, table, start = args
    mb = kw["max_blocks"]
    ids = table[:mb].long()
    keys = torch.arange(mb * bs, device=cuda)
    page_of_group = ids[(keys // 8 * 8) // bs]
    wrong = [(x[ids].float().reshape(mb * bs, *x.shape[2:])
              * kw[sc][page_of_group][:, None, None])
             .reshape(mb, bs, *x.shape[2:])
             for x, sc in ((k, "k_scale"), (v, "v_scale"))]
    pool_f = [torch.zeros((k.shape[0],) + k.shape[1:], device=cuda)
              for _ in range(2)]
    for pf, w in zip(pool_f, wrong):
        pf[ids] = w
    bad = pa.paged_prefill_attention_ref(q, *pool_f, table, start,
                                         block_size=bs, max_blocks=mb)
    assert not compare(bad, got, q.dtype)["ok"]


def _rejects_one_rounding(args, kw, route):
    from tpu_hpc_torch.kernels.attention import tf32_round

    _check_prefill(args, kw, route)
    got = pa.paged_prefill_attention(*args, **kw)
    q, k, v, table, start = args
    bad = pa.paged_prefill_attention_ref(
        tf32_round(q), tf32_round(k), tf32_round(v), table, start, **kw)
    assert not compare(bad, got, torch.float32)["ok"]


@pytest.mark.gpu
@pytest.mark.parametrize("bs", [12, 250])
def test_prefill_tf32_odd_pages_reject_one_rounding(cuda, bs):
    """A float32 chunk over odd pages: within the float32 rule, and the
    plain version on q, K and V rounded once to TF32 (one pass, no
    split) is rejected by it -- the rule still tells split TF32 from
    one rounding on these pages."""
    _rejects_one_rounding(*_prefill(cuda, "float32", hkv=4, bucket=256, g=1,
                                    bs=bs, start=200, seed=210))


@pytest.mark.gpu
@pytest.mark.parametrize("bs", [16, 12])
def test_prefill_tf32_rejects_one_rounding_at_head_dim_256(cuda, bs):
    """The same control at Gemma's chunk and head_dim 256: the column
    halves keep split TF32's float32 rule, which one TF32 rounding of the
    inputs fails."""
    _rejects_one_rounding(*_prefill(cuda, "float32", hkv=1, bucket=240, g=8,
                                    d=256, bs=bs, start=240, seed=450))


# Non-finite values planted for the TF32 route: (tensor, index, value),
# q's [kv head, row, group, d] and (key, kv head, d) of the first live
# page.
TF32_NONFINITE = [("q", (1, 5, 0, 3), "nan"), ("q", (0, 9, 1, 7), "inf"),
                  ("k", (2, 0, 5), "nan"), ("k", (3, 1, 9), "inf"),
                  ("k", (4, 0, 2), "-inf"), ("v", (1, 1, 4), "inf")]


def _nonfinite_rows(args, kw, route, planted):
    q, k, v, table, start = args
    which, idx, value = planted
    if which == "q":
        q[idx] = float(value)
    else:
        (k if which == "k" else v)[(int(table[0]),) + idx] = float(value)
    assert pa.paged_prefill_route(q.dtype, k.dtype, q.shape[-1],
                                  kw["block_size"]) == route
    got = pa.paged_prefill_attention(*args, **kw)
    want = pa.paged_prefill_attention_ref(*args, **kw)
    torch.cuda.synchronize()
    bad_got = ~torch.isfinite(got.float()).all(dim=-1)
    bad_want = ~torch.isfinite(want.float()).all(dim=-1)
    assert torch.equal(bad_got, bad_want)
    keep = ~bad_want
    if keep.any():
        readings = compare(got[keep], want[keep],
                           rule_dtype(q.dtype, k.dtype))
        assert readings["ok"], readings


@pytest.mark.gpu
@pytest.mark.parametrize("pool", ["float32", "bf16_q_over_f32_pool",
                                  "f32_q_over_bf16_pool"])
@pytest.mark.parametrize("planted", TF32_NONFINITE,
                         ids=lambda p: f"{p[0]}_{p[2]}")
def test_prefill_tf32_kernel_nonfinite_rows(cuda, planted, pool):
    """One NaN or inf in q or in a live key or value: the TF32 route's
    non-finite rows are the plain version's (an inf in q or K gives the
    row the plain fp32 product's +-inf or NaN, never a NaN from a split
    term), and every other row is within the rule."""
    _nonfinite_rows(*_prefill(cuda, pool, bucket=32, g=2, start=20,
                              seed=160), planted)


@pytest.mark.gpu
@pytest.mark.parametrize("pool", ["float32", "bf16_q_over_f32_pool",
                                  "f32_q_over_bf16_pool"])
@pytest.mark.parametrize("planted", TF32_NONFINITE,
                         ids=lambda p: f"{p[0]}_{p[2]}")
def test_prefill_tf32_kernel_nonfinite_rows_at_head_dim_256(cuda, planted,
                                                             pool):
    """The same at head_dim 256 (column halves; group 8 over 1 KV head):
    a non-finite value in q or K reaches both blocks of a row tile (each
    computes the whole S), one in V the block holding its column (here
    the second half's: column 132) -- the rows come out non-finite where
    the plain version's do."""
    which, idx, value = planted
    idx = ((0,) + idx[1:] if which == "q" else
           (idx[0], 0, idx[2] + (128 if which == "v" else 0)))
    _nonfinite_rows(*_prefill(cuda, pool, hkv=1, bucket=32, g=8, d=256,
                              start=20, seed=170), (which, idx, value))


@pytest.mark.gpu
def test_float32_kernels_match_plain_tightly(cuda):
    """Float32 in and out: only the summation order differs."""
    rng = np.random.default_rng(72)
    q, kp, vp, tables, pos, active = _case(rng, g=1)
    args = [torch.from_numpy(a).to(cuda)
            for a in (q, kp, vp, tables, pos, active)]
    kw = dict(block_size=16, max_blocks=5)
    got = pa.paged_decode_attention(*args, **kw)
    want = pa.paged_decode_attention_ref(*args, **kw)
    torch.testing.assert_close(got, want, atol=2e-5, rtol=1e-5)


@pytest.mark.gpu
def test_wrapper_raises_instead_of_falling_back(cuda):
    rng = np.random.default_rng(73)
    q, kp, vp, tables, pos, active = _case(rng)
    args = [torch.from_numpy(a).to(cuda)
            for a in (q, kp, vp, tables, pos, active)]
    with pytest.raises(ValueError, match="tables is on cpu"):
        pa.paged_decode_attention(
            *args[:3], args[3].cpu(), *args[4:], block_size=16, max_blocks=5
        )
    with pytest.raises(ValueError, match="contiguous"):
        pa.paged_decode_attention(
            args[0].transpose(2, 3).contiguous().transpose(2, 3), *args[1:],
            block_size=16, max_blocks=5,
        )
    # The prefill's TF32 route (float32 q and pool) raises the same way,
    # and counts no launch.
    pargs, pkw, route = _prefill(cuda, "float32")
    assert route == "wgmma_tf32"
    n0 = pa.paged_prefill_attention.route_launches[route]
    with pytest.raises(ValueError, match="table is on cpu"):
        pa.paged_prefill_attention(*pargs[:3], pargs[3].cpu(), pargs[4],
                                   **pkw)
    q = pargs[0]
    with pytest.raises(ValueError, match="contiguous"):
        pa.paged_prefill_attention(
            q.transpose(2, 3).contiguous().transpose(2, 3), *pargs[1:], **pkw)
    assert pa.paged_prefill_attention.route_launches[route] == n0


@pytest.mark.gpu
@pytest.mark.parametrize("kv_quant", ["none", "int8"])
def test_engine_kernels_match_gather_on_card(cuda, kv_quant):
    """A small float32 model on the card: the engine's kernel path
    launches both kernels and its greedy tokens equal the gather
    path's."""
    cfg = llama2.LlamaConfig(
        dim=256, n_layers=2, n_heads=4, n_kv_heads=2, vocab_size=512,
        multiple_of=64, max_seq_len=128, dtype=torch.float32,
    )
    params = llama2.init_llama(
        torch.Generator(device=cuda).manual_seed(0), cfg, cuda
    )
    rng = np.random.default_rng(74)
    reqs = [(f"r{i}", rng.integers(0, 512, size=n).tolist(), 8)
            for i, n in enumerate((5, 37, 64, 20, 90, 12))]
    results = {}
    for kernel in ("cuda", "gather"):
        eng = PagedEngine(
            params, cfg, ServeConfig(slots=4, max_seq_len=128,
                                     prefill_buckets=(32, 64)), cuda,
            PagedConfig(block_size=16, num_blocks=40, prefill_chunk=32,
                        kernel=kernel, kv_quant=kv_quant),
        )
        n0 = eng.warmup()
        dec0 = pa.paged_decode_attention.launches
        pre0 = pa.paged_prefill_attention.launches
        batcher = ContinuousBatcher(eng)
        results[kernel] = batcher.run(
            [Request(rid=r, prompt=p, max_new_tokens=n) for r, p, n in reqs]
        )
        assert eng.compile_count == n0
        if kernel == "cuda":
            assert pa.paged_decode_attention.launches > dec0
            assert pa.paged_prefill_attention.launches > pre0
    assert results["cuda"] == results["gather"]
