"""The flash-attention kernels on the card (``-m gpu``).

Run on a machine with an NVIDIA H100:

    python -m pytest tests/test_torch_*.py -m gpu

Each test decides inside the ``cuda`` fixture whether a card is present
and skips with a reason where there is none. The forward, dq and dk/dv
kernels (csrc/flash_attention.cu) are held against their plain PyTorch
versions on the same inputs, every case through all three: ragged lengths that cross tiles, q/kv
offsets, GQA, rows with no visible key, non-causal cross attention,
sequences just under and over the backward kernels' 128-row tiles, head
dims 32, 37, 64, 72, 80, 100 and 128 in every dtype, and 136, 200 and
256 (the 256-column kernels: the forward's two warpgroups splitting one
64-row walk, dq's producer warp and pipelined step, both in clusters of
a KV group's query heads sharing each K/V tile at every cluster size
that divides the group; dk/dv two warpgroups over 64 keys with the
query-head group split over blocks, n_split 1-8) in bf16 and fp16;
bf16, fp16 and float32 (the float32 forward,
dq and dk/dv on split TF32). Head dims whose rows are not a whole number
of 16 bytes (37 in every dtype, 100 in 16 bits) reach the kernels
through the wrappers' zero-padded copies. This file imports no JAX.

Tolerances: ``tpu_hpc_torch/checks/tolerance.py``, the rule
``chip_smoke.py`` holds the kernels to. Every element is bounded by a
share of its own value and of its row's RMS (the kernels round P and dS
to a 16-bit input dtype before their products, as the JAX kernels do, so
the error scales with each row's terms), and 16-bit outputs also bound
the relative RMS error of the whole tensor. Float32: ``atol = rtol =
1e-4`` -- the kernels take each product of two fp32 operands in three
TF32 passes over split operands (hi + lo carries each to 2^-22), summed
in another order than the plain versions' fp32 matrix products; TF32 is
off for the plain versions (the ``cuda`` fixture).
"""
import pytest
import torch

from tpu_hpc_torch.checks.tolerance import compare
from tpu_hpc_torch.kernels import attention as ta


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (python -m pytest "
                    "tests/test_torch_*.py -m gpu on the card)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


# (name, b, sq, sk, hq, hkv, d, causal, q_offset, kv_offset)
CASES = [
    ("ragged_causal", 2, 200, 200, 4, 4, 128, True, 0, 0),
    ("offsets", 1, 130, 190, 4, 2, 128, True, 64, 0),
    ("gqa_group4", 2, 96, 96, 8, 2, 64, True, 0, 0),
    ("fully_masked_rows", 1, 100, 100, 2, 2, 128, True, 0, 40),
    ("non_causal_cross", 2, 70, 150, 4, 4, 128, False, 0, 0),
    # Around the backward kernels' 128-row / 128-key blocks and 64-row
    # streamed tiles, and their two head-dim variants (64, 128).
    ("tiles_127", 1, 127, 127, 2, 2, 64, True, 0, 0),
    ("tiles_129", 1, 129, 129, 2, 2, 64, True, 0, 0),
    ("tiles_257", 2, 257, 257, 2, 2, 128, True, 0, 0),
    ("keys_shorter_than_a_tile", 2, 150, 40, 4, 4, 64, True, 0, 0),
    ("head_dim_80", 1, 200, 200, 4, 2, 80, True, 0, 0),
    ("head_dim_32", 1, 200, 200, 4, 4, 32, True, 0, 0),
    ("gqa_group8", 1, 300, 300, 16, 2, 64, True, 0, 0),
    ("odd_offsets", 1, 150, 260, 4, 2, 64, True, 100, 37),
    # Head dims padded inside the 64- and 128-column kernels: rows of
    # 74 bytes (bf16 37) and 200 bytes (bf16 100) are copied into padded
    # tensors by the wrappers; 72 is whole in every dtype.
    ("head_dim_37", 1, 200, 200, 4, 2, 37, True, 0, 0),
    ("head_dim_72", 2, 150, 150, 8, 2, 72, True, 30, 0),
    ("head_dim_100", 1, 260, 260, 4, 4, 100, True, 0, 0),
]
# Past head_dim 128: the 16-bit kernels' 256-column instantiations (the
# float32 kernels refuse these; test_wrappers_raise_instead_of_falling_back).
# d 136 leaves the last 64-column panel wholly past d (zeroed, never
# loaded); 256 at Gemma-2B's grouping (8 query heads over 1 KV head),
# with offsets and rows that see no key.
WIDE_CASES = [
    ("head_dim_136", 1, 200, 200, 4, 2, 136, True, 0, 0),
    ("head_dim_200", 1, 150, 190, 4, 4, 200, True, 64, 0),
    ("head_dim_256_gqa8", 1, 300, 300, 8, 1, 256, True, 0, 0),
    ("head_dim_256_offsets", 2, 130, 260, 8, 1, 256, True, 100, 37),
    ("head_dim_256_masked_rows", 1, 200, 200, 8, 1, 256, True, 0, 70),
    ("head_dim_256_non_causal", 1, 70, 150, 4, 2, 256, False, 0, 0),
]


def _inputs(dev, dtype, case, seed=0):
    _, b, sq, sk, hq, hkv, d, causal, qo, ko = case
    g = torch.Generator(device=dev).manual_seed(seed)

    def rnd(*shape):
        return torch.randn(shape, generator=g, device=dev).to(dtype)

    return (rnd(b, sq, hq, d), rnd(b, sk, hkv, d), rnd(b, sk, hkv, d),
            rnd(b, sq, hq, d), torch.randn((b, sq, hq), generator=g,
                                           device=dev))


def _close(got, want, dtype, what):
    readings = compare(got, want, dtype)
    assert readings["ok"], f"{what}: {readings}"


def _check_kernels(dev, dtype, case):
    causal, qo, ko = case[7:]
    q, k, v, dout, dlse = _inputs(dev, dtype, case)
    kw = dict(causal=causal)
    n0 = ta.kernel_launches()
    out, lse = ta.flash_attention_fwd(q, k, v, qo, ko, **kw)
    torch.cuda.synchronize()
    want_o, want_l = ta.flash_attention_fwd_ref(q, k, v, qo, ko, **kw)
    _close(out, want_o, dtype, "out")
    live = want_l > ta.MASK_VALUE * 0.5
    torch.testing.assert_close(lse[live], want_l[live], atol=2e-3, rtol=1e-4)
    assert (lse[~live] == ta.MASK_VALUE).all()
    if "masked" in case[0]:
        assert (~live).any() and not out[~live].any()
    # The backward kernels on the plain forward's lse and D.
    dm = (dout.float() * want_o.float()).sum(-1) - dlse
    args = (q, k, v, dout, want_l, dm, qo, ko)
    dq = ta.flash_attention_dq(*args, **kw)
    dk, dv = ta.flash_attention_dkv(*args, **kw)
    torch.cuda.synchronize()
    _close(dq, ta.flash_attention_dq_ref(*args, **kw), dtype, "dq")
    want_dk, want_dv = ta.flash_attention_dkv_ref(*args, **kw)
    _close(dk, want_dk, dtype, "dk")
    _close(dv, want_dv, dtype, "dv")
    if "masked" in case[0]:
        assert not dq[~live].any()
    n1 = ta.kernel_launches()
    assert all(n1[name] == n0[name] + 1 for name in n1), (n0, n1)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16,
                                   torch.float32], ids=str)
@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_flash_kernels_match_plain(cuda, dtype, case):
    _check_kernels(cuda, dtype, case)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16], ids=str)
@pytest.mark.parametrize("case", WIDE_CASES, ids=[c[0] for c in WIDE_CASES])
def test_flash_kernels_match_plain_past_head_dim_128(cuda, dtype, case):
    _check_kernels(cuda, dtype, case)


def _bit_identical(dev, dtype, case):
    q, k, v, dout, dlse = _inputs(dev, dtype, case, seed=2)
    out, lse = ta.flash_attention_fwd_ref(q, k, v, 37, 0)
    dm = (dout.float() * out.float()).sum(-1) - dlse
    args = (q, k, v, dout, lse, dm, 37, 0)
    first = (ta.flash_attention_dq(*args), *ta.flash_attention_dkv(*args))
    second = (ta.flash_attention_dq(*args), *ta.flash_attention_dkv(*args))
    torch.cuda.synchronize()
    for name, a, b in zip(("dq", "dk", "dv"), first, second):
        assert torch.equal(a, b), name


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16,
                                   torch.float32], ids=str)
def test_backward_kernels_are_bit_identical_across_launches(cuda, dtype):
    """No atomics: dq, dk and dv from two launches on the same inputs are
    equal bit for bit (GQA, ragged, offsets)."""
    _bit_identical(cuda, dtype, ("repeat", 2, 300, 300, 8, 2, 128, True, 37,
                                 0))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16], ids=str)
def test_backward_kernels_are_bit_identical_at_head_dim_256(cuda, dtype):
    """The 256-column kernels too (dk/dv's split blocks each sum their
    heads, a second kernel the splits in order): GQA 8 over 1, ragged,
    offsets."""
    _bit_identical(cuda, dtype, ("repeat", 2, 300, 300, 8, 1, 256, True, 37,
                                 0))


def _accumulates(dev, dtype, case):
    causal, qo, ko = case[7:]
    q, k, v, dout, dlse = _inputs(dev, dtype, case, seed=3)
    want_o, lse = ta.flash_attention_fwd_ref(q, k, v, qo, ko, causal=causal)
    dm = (dout.float() * want_o.float()).sum(-1) - dlse
    args = (q, k, v, dout, lse, dm, qo, ko)
    acc = [torch.zeros(x.shape, device=dev) for x in (q, k, v)]
    sums = []
    for _ in range(2):
        ta.flash_attention_dq(*args, causal=causal, accumulate=acc[0])
        ta.flash_attention_dkv(*args, causal=causal,
                               accumulate=(acc[1], acc[2]))
        torch.cuda.synchronize()
        sums.append([a.clone() for a in acc])
    zeros = [torch.zeros_like(a) for a in acc]
    want = (ta.flash_attention_dq_ref(*args, causal=causal,
                                      accumulate=zeros[0]),
            *ta.flash_attention_dkv_ref(*args, causal=causal,
                                        accumulate=(zeros[1], zeros[2])))
    for name, once, twice, w in zip(("dq", "dk", "dv"), *sums, want):
        _close(once, w, dtype, name)
        assert torch.equal(twice, 2 * once), name


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16,
                                   torch.float32], ids=str)
@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_backward_accumulate_adds_unrounded(cuda, dtype, case):
    """``accumulate=``: the backward kernels add dq and dk/dv into fp32
    buffers. From zero, the first sum is held against the plain
    versions' fp32 result; a second launch doubles it bit for bit."""
    _accumulates(cuda, dtype, case)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16], ids=str)
@pytest.mark.parametrize("case", WIDE_CASES, ids=[c[0] for c in WIDE_CASES])
def test_backward_accumulate_adds_unrounded_past_head_dim_128(cuda, dtype,
                                                              case):
    """``accumulate=`` in the 256-column kernels (the ring's kAcc
    variants): as above."""
    _accumulates(cuda, dtype, case)


# The 16-bit dk/dv with the query-head group split over blocks
# (``n_split``: each block walks group / n_split heads into fp32
# partials, a second kernel sums them in split order): head dims 256,
# 200 and 136 at groups 1, 2 and 8 (8 query heads), causal with
# offsets, every split that divides the group and the rule's (None).
SPLIT_CASES = [(f"head_dim_{d}_group{g}", 1, 300, 300, 8, 8 // g, d, True,
                37, 0, n)
               for d in (256, 200, 136) for g in (1, 2, 8)
               for n in (None, 1, 2, 4, 8) if n is None or g % n == 0]
# chip_smoke.py's Gemma-2B cases the ring and the masked rows launch:
# the rule splits both 8 ways.
GEMMA_CASES = [
    ("gemma_2b_ring_past_chunk", 1, 512, 512, 8, 1, 256, True, 1536, 0),
    ("gemma_2b_masked_rows", 1, 1000, 1000, 8, 1, 256, True, 0, 512),
]


def _split_args(dev, dtype, case, seed):
    causal, qo, ko = case[7:10]
    q, k, v, dout, dlse = _inputs(dev, dtype, case[:10], seed=seed)
    out, lse = ta.flash_attention_fwd_ref(q, k, v, qo, ko, causal=causal)
    dm = (dout.float() * out.float()).sum(-1) - dlse
    return (q, k, v, dout, lse, dm, qo, ko), dict(causal=causal)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16], ids=str)
@pytest.mark.parametrize("case", SPLIT_CASES,
                         ids=[f"{c[0]}_split{c[10]}" for c in SPLIT_CASES])
def test_dkv_split_matches_plain_and_repeats(cuda, dtype, case):
    """dk/dv at each ``n_split``: within the dtype's rule of the unsplit
    plain version, bit-identical across two launches, the sum kernel
    launched once a call where the group is split and never where it is
    not; from zero with ``accumulate=``, within the rule, and a second
    launch doubles it bit for bit."""
    n_split = case[10]
    args, kw = _split_args(cuda, dtype, case, seed=5)
    b, sq, hq, d = args[0].shape
    n = n_split or ta.dkv_splits(
        b, args[1].shape[1], hq, args[1].shape[2], d, dtype,
        torch.cuda.get_device_properties(cuda).multi_processor_count)
    s0 = ta.flash_attention_dkv_sum.launches
    first = ta.flash_attention_dkv(*args, n_split=n_split, **kw)
    second = ta.flash_attention_dkv(*args, n_split=n_split, **kw)
    torch.cuda.synchronize()
    assert ta.flash_attention_dkv_sum.launches == s0 + (2 if n > 1 else 0)
    want = ta.flash_attention_dkv_ref(*args, **kw)
    for name, a, b_, w in zip(("dk", "dv"), first, second, want):
        _close(a, w, dtype, name)
        assert torch.equal(a, b_), name
    k = args[1]
    acc = [torch.zeros(k.shape, device=cuda) for _ in range(2)]
    sums = []
    for _ in range(2):
        ta.flash_attention_dkv(*args, n_split=n_split, accumulate=acc, **kw)
        torch.cuda.synchronize()
        sums.append([a.clone() for a in acc])
    want = ta.flash_attention_dkv_ref(
        *args, accumulate=[torch.zeros_like(a) for a in acc], **kw)
    for name, once, twice, w in zip(("dk", "dv"), *sums, want):
        _close(once, w, dtype, name)
        assert torch.equal(twice, 2 * once), name


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16], ids=str)
@pytest.mark.parametrize("case", GEMMA_CASES, ids=[c[0] for c in GEMMA_CASES])
def test_gemma_cases_split_dkv(cuda, dtype, case):
    """chip_smoke.py's ring and masked-rows cases at Gemma-2B's attention:
    all three kernels against their plain versions (dk/dv split 8 ways by
    the rule), ``accumulate=``, and dk/dv bit-identical across launches."""
    b, sq, sk, hq, hkv, d = case[1:7]
    assert ta.dkv_splits(
        b, sk, hq, hkv, d, dtype,
        torch.cuda.get_device_properties(cuda).multi_processor_count) == 8
    _check_kernels(cuda, dtype, case)
    _accumulates(cuda, dtype, case)
    args, kw = _split_args(cuda, dtype, case, seed=6)
    first = ta.flash_attention_dkv(*args, **kw)
    second = ta.flash_attention_dkv(*args, **kw)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b_) for a, b_ in zip(first, second))


@pytest.mark.gpu
@pytest.mark.parametrize("accumulate", [False, True])
@pytest.mark.parametrize("n_split", [2, 8])
def test_dkv_sum_kernel_matches_plain(cuda, n_split, accumulate):
    """The sum kernel alone on random partials: the ordered fp32 sum
    (flash_attention_dkv_sum_ref), written in bf16 to the bit, or added
    into fp32 buffers to the bit."""
    g = torch.Generator(device=cuda).manual_seed(8)
    parts = torch.randn((n_split, 2, 1, 300, 2, 200), generator=g,
                        device=cuda)
    if accumulate:
        start = [torch.randn(parts.shape[2:], generator=g, device=cuda)
                 for _ in range(2)]
        got = [a.clone() for a in start]
        ta.flash_attention_dkv_sum(parts, *got, accumulate=True)
        want = ta.flash_attention_dkv_sum_ref(parts, torch.float32,
                                              [a.clone() for a in start])
    else:
        got = [torch.empty(parts.shape[2:], device=cuda,
                           dtype=torch.bfloat16) for _ in range(2)]
        ta.flash_attention_dkv_sum(parts, *got)
        want = ta.flash_attention_dkv_sum_ref(parts, torch.bfloat16)
    torch.cuda.synchronize()
    for a, w in zip(got, want):
        assert torch.equal(a, w)


@pytest.mark.gpu
@pytest.mark.parametrize("case", [c for c in CASES if c[0] in (
    "offsets", "fully_masked_rows", "head_dim_80", "gqa_group8",
    "odd_offsets", "head_dim_32")], ids=lambda c: c[0])
def test_float32_accumulate_adds_the_written_result(cuda, case):
    """Float32 ``accumulate=``: the TF32 backward kernels add into the
    buffers, bit for bit what adding a fresh result to them gives (the
    wrappers added it after the launch before the kernels did)."""
    causal, qo, ko = case[7:]
    q, k, v, dout, dlse = _inputs(cuda, torch.float32, case, seed=4)
    want_o, lse = ta.flash_attention_fwd_ref(q, k, v, qo, ko, causal=causal)
    dm = (dout * want_o).sum(-1) - dlse
    args = (q, k, v, dout, lse, dm, qo, ko)
    start = [torch.randn(x.shape, device=cuda) for x in (q, k, v)]
    acc = [a.clone() for a in start]
    ta.flash_attention_dq(*args, causal=causal, accumulate=acc[0])
    ta.flash_attention_dkv(*args, causal=causal, accumulate=(acc[1], acc[2]))
    fresh = (ta.flash_attention_dq(*args, causal=causal),
             *ta.flash_attention_dkv(*args, causal=causal))
    torch.cuda.synchronize()
    for name, got, s0, f in zip(("dq", "dk", "dv"), acc, start, fresh):
        assert torch.equal(got, s0 + f), name
    rows = {kernel: ta.flash_tile_rows(kernel, torch.float32, case[6])
            for kernel in ta.FLASH_KERNELS}
    assert rows == dict.fromkeys(ta.FLASH_KERNELS, 64), rows


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16], ids=str)
def test_forward_fully_masked_rows_exact_and_repeatable(cuda, dtype):
    """Rows that see no key (kv_offset past them) give out exactly 0 and
    lse exactly MASK_VALUE, and two forward launches agree bit for bit
    (GQA, a ragged end, rows on both sides of the limit in one tile)."""
    case = ("masked", 2, 300, 200, 8, 2, 128, True, 0, 150)
    q, k, v, _, _ = _inputs(cuda, dtype, case, seed=3)
    first = ta.flash_attention_fwd(q, k, v, 0, 150)
    second = ta.flash_attention_fwd(q, k, v, 0, 150)
    torch.cuda.synchronize()
    out, lse = first
    assert (lse[:, :150] == ta.MASK_VALUE).all()
    assert not out[:, :150].any()
    assert (lse[:, 150:] > ta.MASK_VALUE * 0.5).all()
    for a, b in zip(first, second):
        assert torch.equal(a, b)


@pytest.mark.gpu
def test_flash_autograd_matches_reference_on_card(cuda):
    """flash_attention's autograd (three kernels) against autograd through
    attention_reference, float32, GQA, offsets, nonzero dlse."""
    case = ("gqa", 2, 150, 150, 8, 2, 128, True, 20, 0)
    q, k, v, dout, dlse = _inputs(cuda, torch.float32, case, seed=1)
    grads = {}
    for impl in ("cuda", "reference"):
        leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
        out, lse = ta.blockwise_attention(*leaves, q_offset=20, impl=impl)
        torch.autograd.backward((out, lse), (dout, dlse))
        grads[impl] = (out.detach(), lse.detach(),
                       *(t.grad for t in leaves))
    for got, want in zip(grads["cuda"], grads["reference"]):
        torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-4)


@pytest.mark.gpu
def test_wrappers_raise_instead_of_falling_back(cuda):
    case = ("small", 1, 40, 40, 2, 2, 64, True, 0, 0)
    q, k, v, dout, dlse = _inputs(cuda, torch.bfloat16, case)
    n0 = ta.kernel_launches()
    with pytest.raises(ValueError, match="k is on cpu"):
        ta.flash_attention_fwd(q, k.cpu(), v)
    with pytest.raises(TypeError, match="k must be"):
        ta.flash_attention_fwd(q, k.float(), v)
    with pytest.raises(TypeError, match="flash kernels take"):
        ta.flash_attention_fwd(q.double(), k.double(), v.double())
    with pytest.raises(ValueError, match="contiguous"):
        ta.flash_attention_fwd(q.transpose(1, 2).contiguous().transpose(1, 2),
                               k, v)
    wide = [torch.randn(1, 40, 2, 264, device=cuda).bfloat16()
            for _ in range(3)]
    with pytest.raises(ValueError, match='"Flash attention past head_dim '
                       '256"'):
        ta.flash_attention_fwd(*wide)
    with pytest.raises(ValueError, match='"The TF32 walk at head dims '
                       '129-256"'):
        ta.flash_attention_fwd(*(t[..., :136].float().contiguous()
                                 for t in wide))
    out, lse = ta.flash_attention_fwd(q, k, v)
    dm = torch.zeros_like(lse)
    with pytest.raises(ValueError, match="dm is on cpu"):
        ta.flash_attention_dq(q, k, v, dout, lse, dm.cpu())
    with pytest.raises(TypeError, match="lse must be"):
        ta.flash_attention_dkv(q, k, v, dout, lse.double(), dm)
    with pytest.raises(RuntimeError, match="launch failed"):
        ta.flash_attention_dkv(q, k, v, dout, lse, dm, n_split=3)
    n1 = ta.kernel_launches()
    assert n1["flash_attention_fwd"] == n0["flash_attention_fwd"] + 1
    assert n1["flash_attention_dq"] == n0["flash_attention_dq"]
    assert n1["flash_attention_dkv"] == n0["flash_attention_dkv"]


# The kD 256 forward and dq with the blocks of one q tile whose query
# heads share a KV head run as a cluster, each K/V tile loaded once and
# multicast into all of them (attention.gqa_cluster): groups of 2, 3 and
# 8 over 1 and 2 KV heads at head dims 256 and 200, a ragged S, causal
# with offsets (rows 0-15 see no key), at every cluster that divides the
# group and the rule's (None).
CLUSTER_CASES = [(f"head_dim_{d}_group{g}_over{hkv}", 1, 200, 200, g * hkv,
                  hkv, d, True, 5, 21, c)
                 for d in (256, 200) for g in (2, 3, 8) for hkv in (1, 2)
                 for c in (None, 1, 2, 4, 8) if c is None or g % c == 0]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16], ids=str)
@pytest.mark.parametrize("case", CLUSTER_CASES,
                         ids=[f"{c[0]}_cluster{c[10]}" for c in CLUSTER_CASES])
def test_clustered_forward_and_dq_match_plain(cuda, dtype, case):
    """The forward and dq at each cluster: within the dtype's rule of the
    plain versions, the same bits as one block a head (sharing a tile
    changes no arithmetic), dq the same bits across launches, rows that
    see no key exact; with ``accumulate=`` dq adds unrounded (a second
    launch doubles the first bit for bit)."""
    cluster = case[10]
    causal, qo, ko = case[7:10]
    q, k, v, dout, dlse = _inputs(cuda, dtype, case[:10], seed=9)
    kw = dict(causal=causal)
    out, lse = ta.flash_attention_fwd(q, k, v, qo, ko, cluster=cluster, **kw)
    alone = ta.flash_attention_fwd(q, k, v, qo, ko, cluster=1, **kw)
    torch.cuda.synchronize()
    want_o, want_l = ta.flash_attention_fwd_ref(q, k, v, qo, ko, **kw)
    _close(out, want_o, dtype, "out")
    assert torch.equal(out, alone[0]) and torch.equal(lse, alone[1])
    live = want_l > ta.MASK_VALUE * 0.5
    assert (~live).any() and (lse[~live] == ta.MASK_VALUE).all()
    assert not out[~live].any()
    dm = (dout.float() * want_o.float()).sum(-1) - dlse
    args = (q, k, v, dout, want_l, dm, qo, ko)
    dq = ta.flash_attention_dq(*args, cluster=cluster, **kw)
    again = ta.flash_attention_dq(*args, cluster=cluster, **kw)
    dq1 = ta.flash_attention_dq(*args, cluster=1, **kw)
    torch.cuda.synchronize()
    _close(dq, ta.flash_attention_dq_ref(*args, **kw), dtype, "dq")
    assert torch.equal(dq, again) and torch.equal(dq, dq1)
    assert not dq[~live].any()
    acc = torch.zeros(q.shape, device=cuda)
    sums = []
    for _ in range(2):
        ta.flash_attention_dq(*args, cluster=cluster, accumulate=acc, **kw)
        torch.cuda.synchronize()
        sums.append(acc.clone())
    _close(sums[0], ta.flash_attention_dq_ref(
        *args, accumulate=torch.zeros_like(acc), **kw), dtype, "dq acc")
    assert torch.equal(sums[1], 2 * sums[0])


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16], ids=str)
def test_gemma_training_shape_clustered(cuda, dtype):
    """Gemma-2B's training attention (B 1, S 2048, 8 query heads over 1 KV
    head of 256, causal): the rule's cluster is the largest the card
    schedules (8 on an H100), the forward and dq within the rule of
    their plain versions, dq bit-identical across launches and equal to
    one block a head."""
    case = ("gemma", 1, 2048, 2048, 8, 1, 256, True, 0, 0)
    fwd_max = ta.max_gqa_cluster("flash_attention_fwd", dtype)
    dq_max = ta.max_gqa_cluster("flash_attention_dq", dtype)
    assert fwd_max in (1, 2, 4, 8) and dq_max in (1, 2, 4, 8)
    assert ta.gqa_cluster(1, 2048, 8, 1, 256, dtype, fwd_max) == fwd_max
    assert fwd_max >= 2 and dq_max >= 2, (fwd_max, dq_max)
    q, k, v, dout, dlse = _inputs(cuda, dtype, case, seed=11)
    out, lse = ta.flash_attention_fwd(q, k, v)
    torch.cuda.synchronize()
    want_o, want_l = ta.flash_attention_fwd_ref(q, k, v)
    _close(out, want_o, dtype, "out")
    torch.testing.assert_close(lse, want_l, atol=2e-3, rtol=1e-4)
    dm = (dout.float() * want_o.float()).sum(-1) - dlse
    args = (q, k, v, dout, want_l, dm)
    dq = ta.flash_attention_dq(*args)
    again = ta.flash_attention_dq(*args)
    dq1 = ta.flash_attention_dq(*args, cluster=1)
    torch.cuda.synchronize()
    _close(dq, ta.flash_attention_dq_ref(*args), dtype, "dq")
    assert torch.equal(dq, again) and torch.equal(dq, dq1)


@pytest.mark.gpu
def test_refused_cluster_raises(cuda):
    """A cluster the kernels cannot take raises, naming the shape and the
    cluster, and launches nothing: past the portable 8, not a power of
    two, not dividing the group, or below the 256-column kernels."""
    n0 = ta.kernel_launches()
    for case, cluster in (
            (("wide", 1, 100, 100, 8, 1, 256, True, 0, 0), 16),
            (("wide", 1, 100, 100, 8, 1, 256, True, 0, 0), 3),
            (("group3", 1, 100, 100, 3, 1, 256, True, 0, 0), 2),
            (("narrow", 1, 100, 100, 8, 1, 128, True, 0, 0), 2)):
        q, k, v, dout, dlse = _inputs(cuda, torch.bfloat16, case)
        lse = torch.zeros(dlse.shape, device=cuda)
        with pytest.raises(RuntimeError, match=f"cluster {cluster}.*launch "
                           "failed"):
            ta.flash_attention_fwd(q, k, v, cluster=cluster)
        with pytest.raises(RuntimeError, match=f"cluster {cluster}.*launch "
                           "failed"):
            ta.flash_attention_dq(q, k, v, dout, lse, lse, cluster=cluster)
    assert ta.kernel_launches() == n0
