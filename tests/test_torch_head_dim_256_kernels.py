"""The two head_dim-256 redesigns' plain versions against the JAX
package's Pallas kernels, on the CPU.

dk/dv split over the query-head group. On the card the 16-bit dk/dv
kernel may split a KV head's group of query heads over ``n_split``
blocks a key tile (``attention.dkv_splits``), each writing fp32
partials that a second pass adds up in split order.
``flash_attention_dkv_split_ref`` is that computation written plainly
(per split, then the ordered sum); it is held here against the JAX
package's ``_flash_backward`` (its Pallas dq and dk/dv kernels in
interpret mode, 8-row blocks, the group summed at the end) at head dims
256 and 136, Gemma-2B's group of 8 over 1 KV head and a group of 2 over
4, causal with nonzero offsets (rows 0-3 see no key), every ``n_split``
that divides the group, bf16 and float32 -- and against the unsplit
``flash_attention_dkv_ref`` within fp32 rounding.

The TF32 prefill at head dims 129-256. The float32 and mixed pairs now
take the TF32 kernel there (column halves of the output); their plain
version is what the card holds it to. tests/test_torch_head_dims.py
holds the float32 pair at 136 and 256 against the Pallas prefill; here
the other head dim of the card tests (200) and the float32 q over a
bf16 and an int8 pool at 136, 200 and 256, on 12- and 16-token pages.

Tolerances: ``tpu_hpc_torch/checks/tolerance.py``'s rule of each dtype
(bf16 for bf16 inputs, whose Pallas kernels round P and dS before their
products; the pool's where P is rounded to a coarser pool); float32
dk/dv against the Pallas backward ``atol = rtol = 2e-5`` (the same fp32
arithmetic in another order), as tests/test_torch_flash_head_dims.py
has it; the split against the unsplit plain version 1e-5 relative to
the largest value (fp32 sums of up to 8 heads x 20 rows in another
order). One JAX bring-up per (head dim, heads, dtype) serves every split.
"""

import functools

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax", reason="the JAX reference package")
jnp = jax.numpy

from tpu_hpc.kernels import attention as ja
from tpu_hpc.kernels import paged_attention as jax_pa
from tpu_hpc_torch.checks.tolerance import compare, rule_dtype
from tpu_hpc_torch.kernels import attention as ta
from tpu_hpc_torch.kernels import paged_attention as pt_pa

F32_TOL = dict(atol=2e-5, rtol=2e-5)
SPLIT_RTOL = 1e-5
# (b, sq, sk, q_offset, kv_offset): rows 0-3 see no key.
SEQ = (1, 20, 24, 3, 7)
# (query heads, KV heads): Gemma-2B's MQA group of 8, and a group of 2.
HEADS = {"group8_over1": (8, 1), "group2_over4": (8, 4)}
DKV_CASES = [(d, heads, n, dt)
             for d in (256, 136)
             for heads, (hq, hkv) in HEADS.items()
             for n in (1, 2, 4, 8) if (hq // hkv) % n == 0
             for dt in ("bfloat16", "float32")]


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.from_numpy(np.array(a))


@functools.lru_cache(maxsize=None)
def _backward(d, heads, dtype_name):
    """Inputs from a numpy seed (rounded once to the dtype) and the JAX
    forward and Pallas backward on them: (the port's dk/dv arguments,
    JAX's dk and dv as float32 arrays)."""
    dtype = getattr(torch, dtype_name)
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    b, sq, sk, qo, ko = SEQ
    hq, hkv = HEADS[heads]
    rng = np.random.default_rng(2400 + d + hkv)
    arrays = [_t(rng.standard_normal(shape).astype(np.float32)).to(dtype)
              for shape in ((b, sq, hq, d), (b, sk, hkv, d), (b, sk, hkv, d),
                            (b, sq, hq, d))]
    dlse = rng.standard_normal((b, sq, hq)).astype(np.float32)
    jq, jk, jv, jdo = (jnp.asarray(t.float().numpy()).astype(jdt)
                       for t in arrays)
    jo, jlse = ja.flash_attention(jq, jk, jv, qo, ko, True, None, 8, 8, True)
    _, jdk, jdv = ja._flash_backward(
        jq, jk, jv, jo, jlse, jdo, jnp.asarray(dlse), qo, ko, causal=True,
        sm_scale=d ** -0.5, block_q=8, block_k=8, interpret=True)
    q, k, v, dout = arrays
    out = _t(np.asarray(jo, np.float32)).to(dtype)
    lse = _t(np.array(jlse))
    dm = (dout.float() * out.float()).sum(-1) - _t(dlse)
    args = (q, k, v, dout, lse, dm, qo, ko)
    return args, (np.asarray(jdk, np.float32), np.asarray(jdv, np.float32))


def _close(got, want, dtype, what):
    if dtype == torch.float32:
        np.testing.assert_allclose(got.numpy(), want, **F32_TOL, err_msg=what)
    else:
        r = compare(got, _t(want), dtype)
        assert r["ok"], f"{what}: {r}"


@pytest.mark.parametrize("d,heads,n_split,dtype_name", DKV_CASES)
def test_dkv_split_matches_pallas_backward(d, heads, n_split, dtype_name):
    """The split-and-sum plain version (what the split kernel and its sum
    pass compute) against JAX's Pallas backward under its dtype's rule,
    and against the unsplit plain version within fp32 rounding."""
    dtype = getattr(torch, dtype_name)
    args, (jdk, jdv) = _backward(d, heads, dtype_name)
    dk, dv = ta.flash_attention_dkv_split_ref(*args, n_split=n_split)
    assert dk.dtype == dv.dtype == dtype
    assert torch.isfinite(dk).all() and torch.isfinite(dv).all()
    _close(dk, jdk, dtype, "dk")
    _close(dv, jdv, dtype, "dv")

    k = args[1]
    zeros = lambda: (torch.zeros(k.shape), torch.zeros(k.shape))  # noqa: E731
    split = ta.flash_attention_dkv_split_ref(*args, n_split=n_split,
                                             accumulate=zeros())
    whole = ta.flash_attention_dkv_ref(*args, accumulate=zeros())
    for name, a, w in zip(("dk", "dv"), split, whole):
        np.testing.assert_allclose(
            a.numpy(), w.numpy(), rtol=0,
            atol=SPLIT_RTOL * float(w.abs().max()), err_msg=name)
    if n_split == 1:  # one split: the unsplit sum, bit for bit
        assert all(torch.equal(a, w) for a, w in zip(split, whole))



@pytest.mark.parametrize("n_split", [1, 2, 4])
def test_dkv_parts_sum_in_split_order(n_split):
    """The partials are each split's own heads (its slice of every group)
    and the sum pass adds them in order: partial s of the split equals
    the unsplit plain version over that split's heads alone, and the sum
    (written, or added with ``accumulate``) is the ordered fp32 sum."""
    args, _ = _backward(136, "group8_over1", "float32")
    q, k, v, dout, lse, dm, qo, ko = args
    parts = ta.flash_attention_dkv_parts_ref(*args, n_split=n_split)
    assert parts.shape == (n_split, 2, *k.shape)
    for s in range(n_split):
        idx = list(ta.dkv_split_heads(8, n_split, s))
        alone = ta.flash_attention_dkv_ref(
            q[:, :, idx], k, v, dout[:, :, idx], lse[:, :, idx],
            dm[:, :, idx], qo, ko, accumulate=(torch.zeros(k.shape),
                                               torch.zeros(k.shape)))
        assert torch.equal(parts[s, 0], alone[0])
        assert torch.equal(parts[s, 1], alone[1])
    want_k, want_v = parts[0, 0].clone(), parts[0, 1].clone()
    for s in range(1, n_split):
        want_k += parts[s, 0]
        want_v += parts[s, 1]
    dk, dv = torch.empty(k.shape), torch.empty(k.shape)
    got = ta.flash_attention_dkv_sum(parts, dk, dv)
    assert got[0] is dk and torch.equal(dk, want_k) and torch.equal(dv, want_v)
    acc = (torch.ones(k.shape), torch.ones(k.shape))
    ta.flash_attention_dkv_sum(parts, *acc, accumulate=True)
    assert torch.equal(acc[0], want_k + 1) and torch.equal(acc[1], want_v + 1)
    assert ta.flash_attention_dkv_sum.launches == 0  # CPU tensors never launch


# (b, sk, hq, hkv, d, dtype): the shapes the card tests and chip_smoke.py
# launch dk/dv at, each with the split the rule gives on 132 SMs.
SPLIT_SHAPES = {
    "gemma_2b_train": ((1, 2048, 8, 1, 256, torch.bfloat16), 8),
    "gemma_2b_ring_past_chunk": ((1, 512, 8, 1, 256, torch.bfloat16), 8),
    "gemma_2b_masked_rows": ((1, 1000, 8, 1, 256, torch.bfloat16), 8),
    "head_dim_136_group2": ((1, 2048, 8, 4, 136, torch.bfloat16), 2),
    "train_main": ((4, 2048, 8, 8, 128, torch.bfloat16), 1),
    "head_dim_72": ((4, 2048, 8, 8, 72, torch.bfloat16), 1),
    "vit": ((8, 512, 8, 8, 32, torch.bfloat16), 1),
    "gqa_70b_dims": ((1, 2048, 64, 8, 128, torch.bfloat16), 4),
    "float32_gemma": ((1, 2048, 8, 1, 256, torch.float32), 1),
}


@pytest.mark.parametrize("shape", sorted(SPLIT_SHAPES))
def test_dkv_splits_rule(shape):
    """The split rule: a pure function of the shape (the same answer on
    every call, so the same bits from launch to launch), a power of two
    dividing the group whose splits cover every head of the group once;
    1 for float32 and wherever the grid already fills the card."""
    (b, sk, hq, hkv, d, dtype), want = SPLIT_SHAPES[shape]
    n = ta.dkv_splits(b, sk, hq, hkv, d, dtype, sms=132)
    assert n == want
    assert all(ta.dkv_splits(b, sk, hq, hkv, d, dtype, sms=132) == n
               for _ in range(3))
    g = hq // hkv
    assert g % n == 0 and n & (n - 1) == 0
    heads = [h for s in range(n) for h in ta.dkv_split_heads(g, n, s)]
    assert heads == list(range(g))
    with pytest.raises(ValueError):
        ta.dkv_split_heads(g, n, n)


# The prefill: (q dtype, pool dtype) of each pair held here.
PAIRS = {"float32": (torch.float32, torch.float32),
         "float32_over_bfloat16": (torch.float32, torch.bfloat16),
         "float32_over_int8": (torch.float32, torch.int8)}
PREFILL_CASES = [(d, pair, bs) for d in (136, 200, 256)
                 for pair in PAIRS for bs in (12, 16)
                 # covered by tests/test_torch_head_dims.py
                 if not (pair == "float32" and d in (136, 256))]


@pytest.mark.parametrize("d,pair,bs", PREFILL_CASES)
def test_tf32_prefill_pairs_past_128_match_pallas(d, pair, bs):
    """The prefill's plain version -- what the card's TF32 kernel is held
    to at head dims 129-256 -- against the Pallas prefill (interpret
    mode): Gemma-2B's MQA shape (1 KV head, group 8), a 24-token chunk at
    29 over shuffled pages, a dead entry past them on a NaN page (NaN
    scales over int8) that no row may read."""
    rng = np.random.default_rng(2450 + d + bs + len(pair))
    q_dtype, pool_dtype = PAIRS[pair]
    hkv, g, bucket, start = 1, 8, 24, 29
    n_live = -(-(start + bucket) // bs)
    mb = num_blocks = n_live + 2
    dead = num_blocks - 1
    table = np.full(mb, dead, np.int32)
    table[:n_live] = rng.permutation(np.arange(1, num_blocks - 1))
    shape = (num_blocks, bs, hkv, d)
    kp, vp = (rng.standard_normal(shape).astype(np.float32) for _ in "kv")
    if pool_dtype == torch.int8:
        k, ksc = pt_pa.quantize_pages_int8(_t(kp))
        v, vsc = pt_pa.quantize_pages_int8(_t(vp))
        ksc[dead] = vsc[dead] = float("nan")
        kw = dict(k_scale=ksc, v_scale=vsc)
        jk, jv = jnp.asarray(k.numpy()), jnp.asarray(v.numpy())
        jkw = dict(k_scale=jnp.asarray(ksc.numpy()),
                   v_scale=jnp.asarray(vsc.numpy()))
    else:
        kp[dead] = vp[dead] = np.nan
        k, v = _t(kp).to(pool_dtype), _t(vp).to(pool_dtype)
        jdt = jnp.bfloat16 if pool_dtype == torch.bfloat16 else jnp.float32
        jk, jv = (jnp.asarray(t.float().numpy()).astype(jdt) for t in (k, v))
        kw, jkw = {}, {}
    q = _t(rng.standard_normal((hkv, bucket, g, d)).astype(np.float32))
    got = pt_pa.paged_prefill_attention(q, k, v, _t(table), start,
                                        block_size=bs, max_blocks=mb, **kw)
    want = jax_pa.paged_prefill_attention(
        jnp.asarray(q.numpy()), jk, jv, jnp.asarray(table),
        jnp.asarray(start, jnp.int32), block_size=bs, max_blocks=mb,
        interpret=True, **jkw)
    assert got.dtype == q_dtype and got.shape == q.shape
    assert torch.isfinite(got).all()
    readings = compare(got, _t(np.array(want, np.float32)), rule_dtype(
        q_dtype, None if pool_dtype == torch.int8 else pool_dtype))
    assert readings["ok"], readings


def test_a_library_without_the_sum_pass_is_refused():
    """No fallback: a kernel library that lacks the split dk/dv's sum pass
    (an older build) fails to load -- declaring its entry points raises --
    so no wrapper can launch the split kernel without its second pass."""
    from tpu_hpc_torch.kernels import _build

    class Entry:
        pass

    class Library:
        def __getattr__(self, name):
            if name == "tpuhpc_flash_dkv_sum":
                raise AttributeError(f"undefined symbol: {name}")
            entry = Entry()
            object.__setattr__(self, name, entry)
            return entry

    with pytest.raises(AttributeError, match="tpuhpc_flash_dkv_sum"):
        _build._declare_flash(Library())
