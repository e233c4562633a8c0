"""The port's flash-attention family (tpu_hpc_torch/kernels/attention.py)
against the JAX package's (tpu_hpc/kernels/attention.py) on the CPU.

On CPU tensors the port's ``flash_attention`` runs the plain versions of
its three kernels through the same autograd function the card uses; the
JAX side runs its Pallas kernels in interpret mode with 8-row blocks, as
tests/test_sp.py does, so ragged lengths cross several blocks. Inputs
come from numpy with a fixed seed. Float32 throughout: both sides do the
same arithmetic in another order (blocked online softmax against one
full softmax), so ``atol = rtol = 1e-5`` covers summation order on O(1)
values and nothing else.
"""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax", reason="the JAX reference package")
jnp = jax.numpy

from tpu_hpc.kernels import attention as ja
from tpu_hpc_torch.kernels import attention as ta

TOL = dict(atol=1e-5, rtol=1e-5)


def _qkv(seed, b=2, sq=16, sk=16, hq=4, hkv=4, d=16):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, sq, hq, d)).astype(np.float32)
    k = rng.standard_normal((b, sk, hkv, d)).astype(np.float32)
    v = rng.standard_normal((b, sk, hkv, d)).astype(np.float32)
    return rng, q, k, v


def _t(*arrays, grad=False):
    return [torch.from_numpy(a).requires_grad_(grad) for a in arrays]


# (name, sq, sk, hq, hkv, causal, q_offset, kv_offset)
CASES = [
    ("causal", 16, 16, 4, 4, True, 0, 0),
    ("ragged_37", 37, 37, 4, 4, True, 0, 0),
    ("gqa", 24, 24, 8, 2, True, 0, 0),
    ("offsets", 21, 30, 4, 2, True, 16, 0),
    ("fully_masked_rows", 19, 19, 4, 4, True, 0, 9),
    ("non_causal_cross", 13, 41, 4, 4, False, 0, 0),
]


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_attention_reference_matches_jax(case):
    _, sq, sk, hq, hkv, causal, qo, ko = case
    _, q, k, v = _qkv(1, sq=sq, sk=sk, hq=hq, hkv=hkv)
    want_o, want_l = ja.attention_reference(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        causal=causal, q_offset=qo, kv_offset=ko,
    )
    got_o, got_l = ta.attention_reference(
        *_t(q, k, v), causal=causal, q_offset=qo, kv_offset=ko,
    )
    np.testing.assert_allclose(got_o.numpy(), np.asarray(want_o), **TOL)
    np.testing.assert_allclose(got_l.numpy(), np.asarray(want_l), **TOL)


def test_lse_merge_matches_jax_and_empty_side_is_a_no_op():
    rng = np.random.default_rng(2)
    o1, o2 = (rng.standard_normal((2, 5, 3, 8)).astype(np.float32)
              for _ in range(2))
    l1, l2 = (rng.standard_normal((2, 5, 3)).astype(np.float32)
              for _ in range(2))
    l2[:, 0] = ta.MASK_VALUE  # an empty partial for row 0
    want_o, want_l = ja.lse_merge(*map(jnp.asarray, (o1, l1, o2, l2)))
    got_o, got_l = ta.lse_merge(*_t(o1, l1, o2, l2))
    np.testing.assert_allclose(got_o.numpy(), np.asarray(want_o), **TOL)
    np.testing.assert_allclose(got_l.numpy(), np.asarray(want_l), **TOL)
    np.testing.assert_allclose(got_o.numpy()[:, 0], o1[:, 0], **TOL)


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_flash_forward_and_grads_match_jax_pallas(case):
    """out, lse, dq, dk, dv of ``sum(out*w1) + sum(lse*w2)`` -- a nonzero
    dlse, as ring attention's merge produces -- against the JAX Pallas
    kernels' custom_vjp in interpret mode."""
    _, sq, sk, hq, hkv, causal, qo, ko = case
    rng, q, k, v = _qkv(3, sq=sq, sk=sk, hq=hq, hkv=hkv)
    w1 = rng.standard_normal(q.shape).astype(np.float32)
    w2 = rng.standard_normal(q.shape[:3]).astype(np.float32)

    def jax_loss(q, k, v):
        out, lse = ja.blockwise_attention(
            q, k, v, causal=causal, q_offset=qo, kv_offset=ko,
            impl="pallas_interpret", block_q=8, block_k=8,
        )
        return jnp.sum(out * w1) + jnp.sum(lse * w2), (out, lse)

    (_, (jo, jl)), jg = jax.value_and_grad(
        jax_loss, argnums=(0, 1, 2), has_aux=True
    )(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))

    tq, tk, tv = _t(q, k, v, grad=True)
    launches0 = ta.kernel_launches()
    out, lse = ta.blockwise_attention(
        tq, tk, tv, causal=causal, q_offset=qo, kv_offset=ko, impl="cuda"
    )
    (out * torch.from_numpy(w1)).sum().add(
        (lse * torch.from_numpy(w2)).sum()
    ).backward()
    assert ta.kernel_launches() == launches0  # CPU tensors never launch
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jo), **TOL)
    np.testing.assert_allclose(lse.detach().numpy(), np.asarray(jl), **TOL)
    for name, got, want in zip("qkv", (tq.grad, tk.grad, tv.grad), jg):
        assert torch.isfinite(got).all(), name
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL,
                                   err_msg=f"d{name}")
    if case[0] == "fully_masked_rows":
        dead = np.arange(sq) + qo < ko  # rows with no visible key
        assert dead.any()
        assert not out.detach().numpy()[:, dead].any()
        assert (lse.detach().numpy()[:, dead] == np.float32(ta.MASK_VALUE)).all()
        assert not tq.grad.numpy()[:, dead].any()


def test_plain_backward_matches_autograd_of_plain_forward():
    """The dq and dk/dv identities against autograd through the plain
    forward (GQA, offsets, nonzero dlse)."""
    rng, q, k, v = _qkv(4, sq=20, sk=26, hq=6, hkv=2)
    dout = rng.standard_normal(q.shape).astype(np.float32)
    dlse = rng.standard_normal(q.shape[:3]).astype(np.float32)
    tq, tk, tv = _t(q, k, v, grad=True)
    out, lse = ta.flash_attention_fwd_ref(tq, tk, tv, 6, 0, causal=True)
    torch.autograd.backward((out, lse), (torch.from_numpy(dout),
                                         torch.from_numpy(dlse)))
    o, l = out.detach(), lse.detach()
    dm = (torch.from_numpy(dout) * o).sum(-1) - torch.from_numpy(dlse)
    args = (*_t(q, k, v), torch.from_numpy(dout), l, dm, 6, 0)
    dq = ta.flash_attention_dq_ref(*args, causal=True)
    dk, dv = ta.flash_attention_dkv_ref(*args, causal=True)
    for got, want in ((dq, tq.grad), (dk, tk.grad), (dv, tv.grad)):
        np.testing.assert_allclose(got.numpy(), want.numpy(), **TOL)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=str)
def test_backward_accumulate_adds_the_fp32_result(dtype):
    """``accumulate=`` (how the ring backward sums its pairs): dq and
    dk/dv are added, in fp32 and unrounded, into the buffers given, which
    come back; a buffer of another shape or dtype is refused."""
    rng, q, k, v = _qkv(7, sq=12, sk=20, hq=4, hkv=2)
    dout = rng.standard_normal(q.shape).astype(np.float32)
    tq, tk, tv, tdo = (t.to(dtype) for t in _t(q, k, v, dout))
    _, lse = ta.flash_attention_fwd_ref(tq, tk, tv, 8, 0)
    dm = torch.from_numpy(rng.standard_normal(q.shape[:3])
                          .astype(np.float32))
    args = (tq, tk, tv, tdo, lse, dm, 8, 0)
    wide = (tq.float(), tk.float(), tv.float(), tdo.float(), lse, dm, 8, 0)
    start = [torch.from_numpy(rng.standard_normal(x.shape)
                              .astype(np.float32)) for x in (q, k, v)]
    acc = [x.clone() for x in start]
    assert ta.flash_attention_dq(*args, accumulate=acc[0]) is acc[0]
    got = ta.flash_attention_dkv(*args, accumulate=(acc[1], acc[2]))
    assert got[0] is acc[1] and got[1] is acc[2]
    want = (ta.flash_attention_dq_ref(*wide),
            *ta.flash_attention_dkv_ref(*wide))
    for a, x0, w in zip(acc, start, want):
        assert w.dtype == torch.float32
        assert torch.equal(a, x0 + w)
    with pytest.raises(TypeError, match="float32"):
        ta.flash_attention_dq(*args, accumulate=acc[0].to(torch.bfloat16))
    with pytest.raises(ValueError, match="does not match"):
        ta.flash_attention_dkv(*args, accumulate=(acc[0], acc[2]))


def test_dispatch_rules():
    _, q, k, v = _qkv(5, hq=4, hkv=4)
    tq, tk, tv = _t(q, k, v)
    ref = ta.blockwise_attention(tq, tk, tv)  # auto on CPU: reference
    want = ta.attention_reference(tq, tk, tv)
    for a, b in zip(ref, want):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="unknown attention impl"):
        ta.blockwise_attention(tq, tk, tv, impl="pallas")
    _, q6, k4, v4 = _qkv(6, hq=6, hkv=4)
    for impl in ("reference", "cuda", "auto"):
        with pytest.raises(ValueError, match="Hq % Hkv"):
            ta.blockwise_attention(*_t(q6, k4, v4), impl=impl)
    with pytest.raises(ValueError, match="host ints"):
        ta.flash_attention_fwd(tq, tk, tv, torch.tensor(0, device="meta"))


def test_flash_tile_rows_checks_its_arguments_before_the_library():
    """The per-kernel tile-rows query names one of the three wrappers
    (in the C interface's kernel order), a flash dtype and a head dim
    that dtype's kernels take; all are checked before the library is
    built, so a bad call fails on CPU."""
    assert ta.FLASH_KERNELS == tuple(ta.kernel_launches())
    with pytest.raises(ValueError, match="no flash kernel"):
        ta.flash_tile_rows("flash_attention_bwd", torch.bfloat16, 128)
    with pytest.raises(TypeError, match="flash kernels take no"):
        ta.flash_tile_rows("flash_attention_dq", torch.float64, 128)
    for dtype, d in ((torch.bfloat16, 264), (torch.float32, 136),
                     (torch.bfloat16, 0)):
        with pytest.raises(ValueError, match=f"takes head_dim {d}"):
            ta.flash_tile_rows("flash_attention_fwd", dtype, d)


# (name, sequence length, tensor, index, value) of a causal [1, S, 2, 64]
# case under 128-row JAX blocks: at S 128 one causal tile holds every
# pair; at S 256 the q rows sit in the last q tile and the keys in the
# first key tile, where every tile the JAX kernels walk reaches them, as
# every position of the plain versions does.
NONFINITE = [
    ("q_nan_row", 128, "q", (0, 5, 1, 5), np.nan),
    ("k_nan_key", 128, "k", (0, 3, 1, 7), np.nan),
    ("v_inf_key", 128, "v", (0, 3, 0, 9), np.inf),
    ("q_nan_row_2tiles", 256, "q", (0, 200, 1, 5), np.nan),
    ("q_inf_row_2tiles", 256, "q", (0, 200, 1, 5), np.inf),
    ("k_nan_key_2tiles", 256, "k", (0, 3, 1, 7), np.nan),
    ("k_inf_key_2tiles", 256, "k", (0, 3, 0, 7), np.inf),
    ("v_nan_key_2tiles", 256, "v", (0, 3, 1, 7), np.nan),
]


@pytest.mark.parametrize("case", NONFINITE, ids=[c[0] for c in NONFINITE])
def test_plain_flash_nonfinite_rows_match_jax_pallas(case):
    """NaN or inf planted in a q row or a key: the plain forward, dq and
    dk/dv give non-finite exactly in the rows (keys) where the JAX
    Pallas kernels do -- including a row whose every score is NaN, which
    the online softmax turns NaN where a one-pass softmax gives 0 -- and
    agree elsewhere."""
    _, seq, which, idx, value = case
    rng, q, k, v = _qkv(6, b=1, sq=seq, sk=seq, hq=2, hkv=2, d=64)
    {"q": q, "k": k, "v": v}[which][idx] = value
    dout = rng.standard_normal(q.shape).astype(np.float32)
    dlse = rng.standard_normal(q.shape[:3]).astype(np.float32)

    def fwd(q, k, v):
        return ja.flash_attention(q, k, v, 0, 0, True, None, 128, 128, True)

    (jo, jl), vjp = jax.vjp(fwd, *map(jnp.asarray, (q, k, v)))
    jdq, jdk, jdv = vjp((jnp.asarray(dout), jnp.asarray(dlse)))

    tq, tk, tv, tdo = _t(q, k, v, dout)
    out, lse = ta.flash_attention_fwd_ref(tq, tk, tv)
    dm = (tdo * out).sum(-1) - torch.from_numpy(dlse)
    dq = ta.flash_attention_dq_ref(tq, tk, tv, tdo, lse, dm)
    dk, dv = ta.flash_attention_dkv_ref(tq, tk, tv, tdo, lse, dm)
    bad_rows = []
    for name, got, want in (("out", out, jo), ("lse", lse[..., None],
                                               jnp.asarray(jl)[..., None]),
                            ("dq", dq, jdq), ("dk", dk, jdk),
                            ("dv", dv, jdv)):
        got, want = got.numpy(), np.asarray(want)
        bad = ~np.isfinite(got).all(-1)
        np.testing.assert_array_equal(bad, ~np.isfinite(want).all(-1),
                                      err_msg=name)
        np.testing.assert_allclose(got[~bad], want[~bad], **TOL,
                                   err_msg=name)
        bad_rows.append(int(bad.sum()))
    assert max(bad_rows) > 0
