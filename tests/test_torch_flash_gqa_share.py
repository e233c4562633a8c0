"""The kD 256 forward and dq with the query heads of one KV group sharing
each K/V tile: their launch rule, and their plain versions against the
JAX package's Pallas flash kernels, on the CPU.

On the card the 16-bit forward and dq at a padded head dim past 128 run
the blocks of one q tile whose query heads share a KV head as a cluster
(``attention.gqa_cluster``: the largest of 8, 4, 2 and 1 that divides
the group and the card can schedule), each K/V tile loaded once from L2
and multicast into every block of it. Sharing the tiles changes no
arithmetic, so the plain versions the card holds the kernels to
(``flash_attention_fwd_ref``, ``flash_attention_dq_ref``) stay what they
were; here they are held against JAX's ``_flash_forward`` and
``_flash_backward`` (Pallas, ``interpret=True``, 64-row blocks as the
card's tiles) at the shapes the rule clusters: head dims 256 and 200
(padded to the 256-column kernels), groups of 2, 3 and 8 over one KV
head, a ragged S of 200 (not a whole number of 64-row tiles), causal at
q_offset 5 and kv_offset 21 (rows 0-15 see no key), bf16 and float32.
tests/test_torch_flash_head_dims.py holds d 256 at 20 x 24 rows, group
8; these shapes are new.

Tolerances: ``tpu_hpc_torch/checks/tolerance.py``'s bf16 rule for bf16
(the Pallas kernel, like the card's, rounds P and dS to bf16 before
their products and its outputs to bf16, where the plain versions keep
fp32); float32 ``atol = rtol = 2e-5`` (the same fp32 arithmetic in
another order over dot products of up to 256 terms and 200 keys), as
tests/test_torch_flash_head_dims.py has it. One JAX bring-up per case
serves its forward and dq.
"""

import functools

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax", reason="the JAX reference package")
jnp = jax.numpy

from tpu_hpc.kernels import attention as ja
from tpu_hpc_torch.checks.tolerance import compare
from tpu_hpc_torch.kernels import attention as ta

F32_TOL = dict(atol=2e-5, rtol=2e-5)
# (b, s, q_offset, kv_offset): S 200 is ragged against 64-row tiles;
# rows 0-15 see no key.
SEQ = (1, 200, 5, 21)
BLOCK = 64
CASES = [(d, g, dt) for d in (256, 200) for g in (2, 3, 8)
         for dt in ("bfloat16", "float32")]
GROUPS = (1, 2, 3, 4, 6, 8)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# The launch rule
# ---------------------------------------------------------------------------

def _cluster_heads(hq, cluster):
    """The query heads each cluster of the grid's head axis holds: the
    kernels' clusters of ``cluster`` blocks along it, block h the query
    head h."""
    return [range(j, j + cluster) for j in range(0, hq, cluster)]


@pytest.mark.parametrize("hkv", [1, 2])
@pytest.mark.parametrize("g", GROUPS)
def test_gqa_cluster_divides_the_group_and_covers_every_head(g, hkv):
    """For every cap the card might give: the cluster is 1, 2, 4 or 8,
    divides the group, is the largest such under the cap (1 for a group
    of 1 or an odd group), does not move with b or sq, and its clusters
    along the head axis hold every query head once, each cluster's heads
    on one KV head."""
    hq = g * hkv
    for cap in (8, 4, 2, 1):
        c = ta.gqa_cluster(1, 2048, hq, hkv, 256, torch.bfloat16, cap)
        assert c in (1, 2, 4, 8) and g % c == 0 and c <= cap
        assert c == max(x for x in (1, 2, 4, 8) if x <= cap and g % x == 0)
        if g == 1 or g % 2:
            assert c == 1
        again = [ta.gqa_cluster(b, sq, hq, hkv, 256, torch.bfloat16, cap)
                 for b, sq in ((1, 2048), (4, 200), (2, 64))]
        assert again == [c] * 3
        clusters = _cluster_heads(hq, c)
        heads = [h for r in clusters for h in r]
        assert sorted(heads) == list(range(hq))
        assert all(len({h // g for h in r}) == 1 and len(r) == c
                   for r in clusters)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16,
                                   torch.float32], ids=str)
def test_gqa_cluster_only_on_the_256_column_kernels(dtype):
    """Only the 16-bit kernels at a padded head dim past 128 share tiles:
    every other head dim, and float32 at any, takes 1; Gemma-2B's 8 over
    1 takes 8 from 129 to 256 in 16 bits."""
    for d in range(1, 257):
        c = ta.gqa_cluster(1, 2048, 8, 1, d, dtype)
        want = 8 if dtype != torch.float32 and \
            ta.padded_head_dim(d, dtype) > 128 else 1
        assert c == want, d
    assert ta._cluster("flash_attention_fwd", torch.zeros(1, 4, 8, 64),
                       torch.zeros(1, 4, 1, 64), None) == 1
    assert ta._cluster("flash_attention_dq", torch.zeros(1, 4, 8, 256),
                       torch.zeros(1, 4, 1, 256), 2) == 2


# ---------------------------------------------------------------------------
# The plain versions against the Pallas kernels
# ---------------------------------------------------------------------------

def _t(a):
    return torch.from_numpy(np.array(a))


@functools.lru_cache(maxsize=None)
def _pallas(d, g, dtype_name):
    """Inputs from a numpy seed (rounded once to the dtype) and JAX's
    Pallas forward and backward on them: (the port's inputs, dout and
    dlse; JAX's out, lse and dq as float32 arrays)."""
    dtype = getattr(torch, dtype_name)
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    b, s, qo, ko = SEQ
    rng = np.random.default_rng(2500 + d + g)
    q, k, v, dout = (_t(rng.standard_normal(shape).astype(np.float32))
                     .to(dtype) for shape in ((b, s, g, d), (b, s, 1, d),
                                              (b, s, 1, d), (b, s, g, d)))
    dlse = rng.standard_normal((b, s, g)).astype(np.float32)
    jq, jk, jv, jdo = (jnp.asarray(t.float().numpy()).astype(jdt)
                       for t in (q, k, v, dout))
    kw = dict(causal=True, sm_scale=d ** -0.5, block_q=BLOCK,
              block_k=BLOCK, interpret=True)
    jo, jlse = ja._flash_forward(jq, jk, jv, qo, ko, **kw)
    jdq, _, _ = ja._flash_backward(jq, jk, jv, jo, jlse, jdo,
                                   jnp.asarray(dlse), qo, ko, **kw)
    return ((q, k, v, dout, dlse),
            tuple(np.asarray(x, np.float32) for x in (jo, jlse, jdq)))


def _close(got, want, dtype, what):
    if dtype == torch.float32:
        np.testing.assert_allclose(got.numpy(), want, **F32_TOL, err_msg=what)
    else:
        r = compare(got, _t(want), dtype)
        assert r["ok"], f"{what}: {r}"


def _live():
    _, s, qo, ko = SEQ
    live = np.arange(s) + qo >= ko
    assert not live.all()
    return live


@pytest.mark.parametrize("d,g,dtype_name", CASES)
def test_forward_plain_version_matches_pallas(d, g, dtype_name):
    """out and lse of the forward's plain version (what the wrapper runs
    on CPU tensors) against JAX's Pallas forward; rows that see no key
    give out 0 and lse MASK_VALUE."""
    dtype = getattr(torch, dtype_name)
    (q, k, v, _, _), (jo, jlse, _) = _pallas(d, g, dtype_name)
    _, _, qo, ko = SEQ
    launches = ta.kernel_launches()
    out, lse = ta.flash_attention_fwd(q, k, v, qo, ko)
    assert ta.kernel_launches() == launches  # CPU tensors never launch
    assert out.dtype == dtype and out.shape == q.shape
    live = _live()
    _close(out, jo, dtype, "out")
    np.testing.assert_allclose(lse.numpy()[:, live], jlse[:, live], **F32_TOL)
    assert (lse.numpy()[:, ~live] == np.float32(ta.MASK_VALUE)).all()
    assert not out.float().numpy()[:, ~live].any()


@pytest.mark.parametrize("d,g,dtype_name", CASES)
def test_dq_plain_version_matches_pallas(d, g, dtype_name):
    """dq of the dq kernel's plain version from JAX's (out, lse) against
    JAX's Pallas dq kernel; the same call twice gives the same bits, and
    with ``accumulate=`` it adds fp32 dq into the buffer."""
    dtype = getattr(torch, dtype_name)
    (q, k, v, dout, dlse), (jo, jlse, jdq) = _pallas(d, g, dtype_name)
    _, _, qo, ko = SEQ
    out = _t(jo).to(dtype)
    dm = (dout.float() * out.float()).sum(-1) - _t(dlse)
    args = (q, k, v, dout, _t(jlse), dm, qo, ko)
    dq = ta.flash_attention_dq(*args)
    assert dq.dtype == dtype and torch.isfinite(dq).all()
    _close(dq, jdq, dtype, "dq")
    assert torch.equal(dq, ta.flash_attention_dq(*args))
    assert not dq.float().numpy()[:, ~_live()].any()
    acc = torch.ones(q.shape)
    got = ta.flash_attention_dq(*args, accumulate=acc)
    assert got is acc
    fresh = ta.flash_attention_dq(*args, accumulate=torch.zeros(q.shape))
    assert torch.equal(got, 1 + fresh)
