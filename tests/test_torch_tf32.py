"""Split TF32, emulated on the CPU: what the float32 kernels' tensor-core
passes see (tpu_hpc_torch/kernels/attention.py: ``tf32_round``,
``tf32_split``, ``tf32_split_p``; csrc/hopper.cuh computes the same
bits).

TF32 keeps 10 explicit mantissa bits, so one pass rounds each fp32
operand to 2^-11. The float32 kernels split each fp32 operand into hi +
lo, both exact in TF32, and take a product of two fp32 operands in three
passes. These tests hold the emulation to that: 16-bit and int8 values
are exact in TF32 (never split), hi + lo reproduces x to 2^-22, the
split of inf, NaN and FLT_MAX, the sign-coherent split of a
probability, and a three-pass forward and backward that meet
``checks/tolerance.py``'s float32 rule against the JAX flash forward
and backward where one pass does not. One thread, a few seconds.
"""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax", reason="the JAX reference package")
jnp = jax.numpy

from tpu_hpc.kernels import attention as ja
from tpu_hpc_torch.checks.tolerance import compare
from tpu_hpc_torch.kernels import attention as ta
from tpu_hpc_torch.kernels.attention import (tf32_round, tf32_split,
                                             tf32_split_p)

LOW13 = 0x1FFF
FLT_MAX = float(np.finfo(np.float32).max)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """torch on one intra-op thread for this file, leaving the other
    cores to the test files running beside it under xdist."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _bits(x: torch.Tensor) -> torch.Tensor:
    return x.contiguous().view(torch.int32)


def _all_finite(dtype) -> torch.Tensor:
    """Every finite value of a 16-bit dtype, as float32."""
    pats = torch.arange(-32768, 32768, dtype=torch.int32).to(torch.int16)
    x = pats.view(dtype).to(torch.float32)
    return x[torch.isfinite(x)]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16],
                         ids=["bf16", "f16"])
def test_16bit_values_are_fixed_points(dtype):
    """Every finite bf16 and f16 bit pattern (subnormals and signed zeros
    included) is exact in TF32: tf32_round returns its bits, and its
    split is (x, 0)."""
    x = _all_finite(dtype)
    assert x.numel() > 60000
    assert torch.equal(_bits(tf32_round(x)), _bits(x))
    hi, lo = tf32_split(x)
    assert torch.equal(_bits(hi), _bits(x))
    assert not lo.any()


def test_int8_values_are_fixed_points():
    x = torch.arange(-128, 128, dtype=torch.int8).to(torch.float32)
    assert torch.equal(_bits(tf32_round(x)), _bits(x))
    assert not tf32_split(x)[1].any()


def _wide_floats(n=200000, seed=0):
    """Random finite float32 values, both signs, over every exponent from
    2^-100 up (below it lo falls under float32's normal range and the
    split loses bits there), and the mantissas TF32 rounding treats
    specially (ties, all ones)."""
    rng = np.random.default_rng(seed)
    sign = rng.integers(0, 2, n, dtype=np.uint32) << 31
    exp = rng.integers(27, 255, n, dtype=np.uint32) << 23
    mant = rng.integers(0, 1 << 23, n, dtype=np.uint32)
    mant[: n // 8] = (mant[: n // 8] & ~np.uint32(LOW13)) | np.uint32(0x1000)
    mant[n // 8: n // 4] |= np.uint32(LOW13)
    x = (sign | exp | mant).view(np.float32)
    edges = np.array([FLT_MAX, -FLT_MAX, np.finfo(np.float32).tiny, 1.0,
                      np.nextafter(np.float32(1), np.float32(2))], np.float32)
    return torch.from_numpy(np.concatenate([x, edges]))


def test_split_reproduces_x_within_2_pow_minus_22():
    x = _wide_floats()
    hi, lo = tf32_split(x)
    assert torch.isfinite(hi).all() and torch.isfinite(lo).all()
    for part in (hi, lo):  # both exact in TF32: the low 13 bits are 0
        assert not torch.bitwise_and(_bits(part), LOW13).any()
    err = (x.double() - hi.double() - lo.double()).abs()
    assert (err <= 2.0 ** -22 * x.double().abs()).all()
    # hi alone is the one-pass rounding: within 2^-11, and no better.
    rel = ((x.double() - hi.double()).abs() / x.double().abs()).max()
    assert 2.0 ** -12 < rel <= 2.0 ** -11


def test_round_is_nearest_ties_away_from_zero():
    one = 1.0
    ulp = 2.0 ** -10
    x = torch.tensor([one + ulp / 2, -(one + ulp / 2), one + ulp / 2 - 2 ** -23,
                      one + 1.5 * ulp], dtype=torch.float32)
    assert tf32_round(x).tolist() == [one + ulp, -(one + ulp), one,
                                      one + 2 * ulp]


def test_split_of_nonfinite_and_flt_max():
    x = torch.tensor([float("inf"), float("-inf"), float("nan"), FLT_MAX,
                      -FLT_MAX], dtype=torch.float32)
    hi, lo = tf32_split(x)
    assert hi[0] == float("inf") and hi[1] == float("-inf")
    assert lo[0] == 0 and lo[1] == 0
    assert torch.isnan(hi[2])
    # FLT_MAX would round up to inf: its hi is truncated instead.
    assert torch.isfinite(hi[3:]).all() and torch.isfinite(lo[3:]).all()
    err = (hi[3:].double() + lo[3:].double() - x[3:].double()).abs()
    assert (err <= 2.0 ** -22 * FLT_MAX).all()
    with pytest.raises(TypeError, match="float32"):
        tf32_round(torch.ones(2, dtype=torch.bfloat16))


def _product(a_eq, a, b, passes):
    """einsum(a_eq, a, b) as the kernels' TF32 passes take it: three
    (the cross terms summed apart, as the kernel's second accumulator)
    or one, each pass an fp32 sum of exact TF32 products."""
    if passes == 1:
        return torch.einsum(a_eq, tf32_round(a), tf32_round(b))
    ah, al = tf32_split(a)
    bh, bl = tf32_split(b)
    return torch.einsum(a_eq, ah, bh) + (torch.einsum(a_eq, ah, bl)
                                         + torch.einsum(a_eq, al, bh))


def emulated_forward(q, k, v, passes, causal=True):
    """The float32 forward with S = Q . K^T and O = P . V each taken in
    ``passes`` TF32 passes; softmax, masking and the output in fp32, as
    the kernel's registers hold them. Equal q and KV heads."""
    b, sq, h, d = q.shape
    s = _product("bqhd,bkhd->bhqk", q, k, passes) * d ** -0.5
    if causal:
        keep = torch.ones(sq, k.shape[1], dtype=torch.bool).tril()
        s = s.masked_fill(~keep, ta.MASK_VALUE)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    out = _product("bhqk,bkhd->bhqd", p, v, passes) / p.sum(-1, keepdim=True)
    return out.permute(0, 2, 1, 3)


def test_three_pass_forward_meets_the_float32_rule_and_one_pass_does_not():
    """B 1, S 128, 2 heads, d 128, causal: against the JAX flash forward
    (its Pallas kernel in interpret mode, as tests/test_torch_attention.py
    runs it), the three-pass forward passes the float32 rule of
    checks/tolerance.py and the one-pass forward is rejected -- the rule
    tells split TF32 from one rounding."""
    rng = np.random.default_rng(19)
    q, k, v = (rng.standard_normal((1, 128, 2, 128)).astype(np.float32)
               for _ in range(3))
    want, _ = ja.blockwise_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True,
        impl="pallas_interpret", block_q=64, block_k=64)
    want = torch.from_numpy(np.array(want))
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    three = compare(emulated_forward(tq, tk, tv, 3), want, torch.float32)
    one = compare(emulated_forward(tq, tk, tv, 1), want, torch.float32)
    assert three["ok"], three
    assert three["tol_used"] < 0.2, three
    assert not one["ok"], one
    assert one["tol_used"] > 2.0, one


def test_split_p_truncates_and_keeps_sign():
    """A probability's split, as the float32 kernels take P before P . V
    and P^T . dO: hi is p truncated to TF32, lo >= 0 is exact in TF32
    and at least 2^-126 wherever hi > 0, hi + lo within 2^-21 p for p >=
    2^-100 (below about 2^-105 the 2^-126 floor of lo is larger than
    that); 0 gives (0, 0), inf (inf, 2^-126), NaN (NaN, 0)."""
    p = _wide_floats().abs()
    hi, lo = tf32_split_p(p)
    assert torch.equal(_bits(hi), torch.bitwise_and(_bits(p), ~LOW13))
    assert not torch.bitwise_and(_bits(lo), LOW13).any()
    assert (lo >= 0).all() and (lo[hi > 0] >= 2.0 ** -126).all()
    err = (p.double() - hi.double() - lo.double()).abs()
    normal = p >= 2.0 ** -100
    assert normal.sum() > 190000
    assert (err[normal] <= 2.0 ** -21 * p.double()[normal]).all()
    edge = torch.tensor([0.0, float("inf"), float("nan")])
    hi, lo = tf32_split_p(edge)
    assert hi[0] == 0 and lo[0] == 0
    assert hi[1] == float("inf") and lo[1] == 2.0 ** -126
    assert torch.isnan(hi[2]) and lo[2] == 0
    with pytest.raises(TypeError, match="float32"):
        tf32_split_p(torch.ones(2, dtype=torch.float64))


def _product_p(eq, p, b, passes):
    """einsum(eq, p, b) with the probability p split as the kernels split
    it (tf32_split_p) in three passes, or both rounded once in one."""
    if passes == 1:
        return torch.einsum(eq, tf32_round(p), tf32_round(b))
    ph, pl = tf32_split_p(p)
    bh, bl = tf32_split(b)
    return torch.einsum(eq, ph, bh) + (torch.einsum(eq, pl, bh)
                                       + torch.einsum(eq, ph, bl))


def emulated_backward(q, k, v, dout, dlse, passes, causal=True):
    """dq, dk and dv as the float32 backward kernels take them, each of
    the five products -- S = Q . K^T, dP = dO . V^T, dq = dS . K, dk =
    dS^T . Q, dv = P^T . dO -- in ``passes`` TF32 passes (P split as the
    kernel splits it); P rebuilt from the saved lse and dS = P * (dP -
    D), D = rowsum(dO * O) - dlse, in fp32 as the kernels' registers
    hold them. Equal q and KV heads."""
    b, sq, h, d = q.shape
    scale = d ** -0.5
    out, lse = ta.attention_reference(q, k, v, causal=causal)
    dm = ((dout * out).sum(-1) - dlse).permute(0, 2, 1)[..., None]
    s = _product("bqhd,bkhd->bhqk", q, k, passes) * scale
    keep = torch.ones(sq, k.shape[1], dtype=torch.bool)
    if causal:
        keep = keep.tril()
    p = torch.where(keep, torch.exp(s - lse.permute(0, 2, 1)[..., None]),
                    torch.zeros_like(s))
    ds = p * (_product("bqhd,bkhd->bhqk", dout, v, passes) - dm)
    dq = _product("bhqk,bkhd->bqhd", ds, k, passes) * scale
    dk = _product("bhqk,bqhd->bkhd", ds, q, passes) * scale
    dv = _product_p("bhqk,bqhd->bkhd", p, dout, passes)
    return dq, dk, dv


def test_three_pass_backward_meets_the_float32_rule_and_one_pass_does_not():
    """B 1, S 128, 2 heads, d 128, causal, with an lse cotangent: against
    the JAX flash backward (jax.vjp through its Pallas kernels in
    interpret mode), the three-pass dq, dk and dv pass the float32 rule
    of checks/tolerance.py and the one-pass ones are rejected."""
    rng = np.random.default_rng(20)
    q, k, v, dout = (rng.standard_normal((1, 128, 2, 128)).astype(np.float32)
                     for _ in range(4))
    dlse = rng.standard_normal((1, 128, 2)).astype(np.float32)

    def fwd(q, k, v):
        return ja.blockwise_attention(q, k, v, causal=True,
                                      impl="pallas_interpret", block_q=64,
                                      block_k=64)

    _, vjp = jax.vjp(fwd, *(jnp.asarray(a) for a in (q, k, v)))
    want = [torch.from_numpy(np.array(g))
            for g in vjp((jnp.asarray(dout), jnp.asarray(dlse)))]
    t = [torch.from_numpy(a) for a in (q, k, v, dout, dlse)]
    three, one = emulated_backward(*t, 3), emulated_backward(*t, 1)
    for name, got3, got1, w in zip(("dq", "dk", "dv"), three, one, want):
        r3 = compare(got3, w, torch.float32)
        r1 = compare(got1, w, torch.float32)
        assert r3["ok"] and r3["tol_used"] < 0.2, (name, r3)
        assert not r1["ok"] and r1["tol_used"] > 2.0, (name, r1)
