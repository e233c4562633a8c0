"""The port's paged decode and prefill and its paged engine at head dims
off the 64- and 128-column kernels (36, 72, 136, 256) against the JAX
package's Pallas kernels and paged engine, on the CPU.

On the card the decode takes every head dim up to 256, and the prefill
takes every one up to 256 on a tensor-core route (up to 128 for the
float32 and mixed pairs), each padded to its 64-, 128- or 256-column
instantiation (tests/test_torch_gpu.py holds those kernels against the
plain versions). Here the port's wrappers run their plain versions on
CPU tensors and the JAX kernels run with ``interpret=True``, as
tests/test_paged_kernels.py runs them. Same inputs from a numpy seed:
shuffled table rows, a chunk that starts inside a page, dead entries
pointing at a page of NaNs (NaN scales for an int8 pool), an inactive
decode slot.

Tolerance: ``tpu_hpc_torch/checks/tolerance.py``'s rule for q's dtype,
or a coarser 16-bit pool's (``rule_dtype``) -- the rule the card holds
the kernels to. Float32 q and pool: both sides sum in fp32 in other
orders. bf16 q and pool: both round P to bf16 before P.V, each relative
to another max, and round the output to bf16. An int8 pool under a bf16
q: both dequantize in f32 and keep P in f32. The engines are float32 and
must agree on every greedy token.
"""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax", reason="the JAX reference package")
jnp = jax.numpy

from tpu_hpc.kernels import paged_attention as jax_pa
from tpu_hpc.models import llama2 as jl
from tpu_hpc.runtime import MeshSpec, build_mesh
from tpu_hpc.serve import ContinuousBatcher as JaxBatcher
from tpu_hpc.serve import PagedConfig as JaxPagedConfig
from tpu_hpc.serve import PagedEngine as JaxPagedEngine
from tpu_hpc.serve import Request as JaxRequest
from tpu_hpc.serve import ServeConfig as JaxServeConfig
from tpu_hpc_torch.checks.tolerance import compare, rule_dtype
from tpu_hpc_torch.kernels import paged_attention as pt_pa
from tpu_hpc_torch.models import llama2 as tl
from tpu_hpc_torch.serve import (
    ContinuousBatcher,
    PagedConfig,
    PagedEngine,
    Request,
    ServeConfig,
    params_from_numpy,
)

_JNP = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}
# (q dtype, pool dtype): float32 (the card's TF32 route up to 128, the
# scalar one past it), bf16 (TMA boxes or the gathering producer), an
# int8 pool under a bf16 q (the gathering producer with page scales).
POOLS = {"float32": (torch.float32, torch.float32),
         "bfloat16": (torch.bfloat16, torch.bfloat16),
         "int8": (torch.bfloat16, torch.int8)}
HEAD_DIMS = [36, 72, 136, 256]
PAGE_SIZES = [12, 16]


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _heads(d):
    """(kv heads, group): Gemma-2B's MQA shape past 128, else GQA."""
    return (1, 8) if d > 128 else (2, 2)


def _pools(rng, num_blocks, bs, hkv, d, pool, dead):
    """K and V pools of ``pool`` for both frameworks (page ``dead`` NaN,
    or NaN scales over int8) and the scale keywords of each."""
    shape = (num_blocks, bs, hkv, d)
    kp = rng.standard_normal(shape).astype(np.float32)
    vp = rng.standard_normal(shape).astype(np.float32)
    q_dtype, pool_dtype = POOLS[pool]
    if pool_dtype == torch.int8:
        kq, ksc = pt_pa.quantize_pages_int8(_t(kp))
        vq, vsc = pt_pa.quantize_pages_int8(_t(vp))
        ksc[dead] = vsc[dead] = float("nan")
        jkw = dict(k_scale=jnp.asarray(ksc.numpy()),
                   v_scale=jnp.asarray(vsc.numpy()))
        return (kq, vq, dict(k_scale=ksc, v_scale=vsc),
                jnp.asarray(kq.numpy()), jnp.asarray(vq.numpy()), jkw)
    kp[dead] = vp[dead] = np.nan
    k, v = _t(kp).to(pool_dtype), _t(vp).to(pool_dtype)
    jk, jv = (jnp.asarray(t.float().numpy()).astype(_JNP[pool_dtype])
              for t in (k, v))
    return k, v, {}, jk, jv, {}


def _q(rng, shape, q_dtype):
    q = _t(rng.standard_normal(shape).astype(np.float32)).to(q_dtype)
    return q, jnp.asarray(q.float().numpy()).astype(_JNP[q_dtype])


def _prefill_case(rng, d, bs, pool, *, bucket=24, start=29):
    """One slot's chunk of ``bucket`` tokens at ``start`` (53 keys) over
    pages of ``bs`` in shuffled order, two dead entries after them
    pointing at the pool's last page. Returns the port's output and the
    JAX kernel's (interpret mode) as f32, and the rule's dtype."""
    hkv, g = _heads(d)
    n_live = -(-(start + bucket) // bs)
    mb = num_blocks = n_live + 2
    table = np.full(mb, num_blocks - 1, np.int32)
    table[:n_live] = rng.permutation(np.arange(1, num_blocks - 1))
    k, v, kw, jk, jv, jkw = _pools(rng, num_blocks, bs, hkv, d, pool,
                                   num_blocks - 1)
    q_dtype, pool_dtype = POOLS[pool]
    q, jq = _q(rng, (hkv, bucket, g, d), q_dtype)
    got = pt_pa.paged_prefill_attention(q, k, v, _t(table), start,
                                        block_size=bs, max_blocks=mb, **kw)
    want = jax_pa.paged_prefill_attention(
        jq, jk, jv, jnp.asarray(table), jnp.asarray(start, jnp.int32),
        block_size=bs, max_blocks=mb, interpret=True, **jkw)
    return got, _t(np.array(want, np.float32))


def _decode_case(rng, d, bs, pool, *, slots=3, mb=6):
    """Three slots at positions within 64 keys of shuffled pages (the
    last one inactive); every entry past a slot's live pages points at
    the pool's last page. Returns the port's output and the JAX
    kernel's (interpret mode) as f32."""
    hkv, g = _heads(d)
    pos = np.array([min(mb * bs, 64) - 1, 17, 40], np.int32)
    active = np.array([1, 1, 0], np.int32)
    n_live = [int(p) // bs + 1 if a else 0 for p, a in zip(pos, active)]
    num_blocks = sum(n_live) + 2
    pages = rng.permutation(np.arange(1, num_blocks - 1)).astype(np.int32)
    tables = np.full((slots, mb), num_blocks - 1, np.int32)
    nxt = 0
    for s in range(slots):
        tables[s, :n_live[s]] = pages[nxt:nxt + n_live[s]]
        nxt += n_live[s]
    k, v, kw, jk, jv, jkw = _pools(rng, num_blocks, bs, hkv, d, pool,
                                   num_blocks - 1)
    q_dtype, _ = POOLS[pool]
    q, jq = _q(rng, (slots, hkv, g, d), q_dtype)
    got = pt_pa.paged_decode_attention(
        q, k, v, _t(tables), _t(pos), _t(active), block_size=bs,
        max_blocks=mb, **kw)
    want = jax_pa.paged_decode_attention(
        jq, jk, jv, jnp.asarray(tables), jnp.asarray(pos),
        jnp.asarray(active), block_size=bs, max_blocks=mb, interpret=True,
        **jkw)
    return got, _t(np.array(want, np.float32))


@pytest.mark.parametrize("kernel", ["prefill", "decode"])
@pytest.mark.parametrize("bs", PAGE_SIZES)
@pytest.mark.parametrize("pool", list(POOLS))
@pytest.mark.parametrize("d", HEAD_DIMS)
def test_paged_kernels_at_head_dims_match_pallas(d, pool, bs, kernel):
    """The plain prefill and decode (what the card's kernels are held
    to) against the Pallas kernels at head dims 36 (72-byte bf16 rows),
    72, 136 and 256 (Gemma-2B's MQA shape: 1 KV head, group 8), every
    pool, pages of 12 and 16."""
    rng = np.random.default_rng(700 + d + bs + len(pool))
    case = _prefill_case if kernel == "prefill" else _decode_case
    got, want = case(rng, d, bs, pool)
    q_dtype, pool_dtype = POOLS[pool]
    assert got.dtype == q_dtype and got.shape[-1] == d
    assert torch.isfinite(got).all()
    readings = compare(got, want, rule_dtype(
        q_dtype, None if pool_dtype == torch.int8 else pool_dtype))
    assert readings["ok"], readings
    if kernel == "decode":
        assert not got[2].any()  # the inactive slot: exact zeros


# The tiny float32 Llamas: head_dim 256 (dim 512 over 2 heads, one KV
# head: Gemma-2B's MQA in miniature) on 16-token pages, and head_dim 72
# (dim 144 over 2 heads) on 12-token pages; chunks of 24 or 32 tokens,
# so prompts of 30 and 41 tokens prefill in two chunks.
ENGINES = {
    256: dict(model=dict(dim=512, n_heads=2, n_kv_heads=1),
              serve=dict(slots=2, max_seq_len=64, prefill_buckets=(32, 64)),
              paged=dict(block_size=16, num_blocks=10, prefill_chunk=32)),
    72: dict(model=dict(dim=144, n_heads=2, n_kv_heads=2),
             serve=dict(slots=2, max_seq_len=60, prefill_buckets=(24, 48)),
             paged=dict(block_size=12, num_blocks=12, prefill_chunk=24)),
}


def _mix():
    rng = np.random.default_rng(22)
    return [(f"r{i}", rng.integers(0, 128, size=n).tolist(), 5)
            for i, n in enumerate((30, 7, 41, 13))]


def _drive(engine, batcher_cls, request_cls):
    batcher = batcher_cls(engine)
    for rid, prompt, n in _mix():
        batcher.submit(request_cls(rid=rid, prompt=prompt, max_new_tokens=n))
    while not batcher.done:
        batcher.step()
    return dict(batcher.results)


@pytest.mark.parametrize("head_dim", sorted(ENGINES))
def test_paged_engine_at_head_dim_matches_jax_engine(head_dim):
    """The port's PagedEngine on a tiny float32 Llama whose head_dim is
    ``head_dim`` (kernel="cuda": on the CPU the kernels' plain versions)
    gives the JAX PagedEngine's greedy tokens (kernel="pallas",
    interpret mode) on every request, with the JAX weights carried over
    by the numpy converter, and builds nothing after warmup."""
    spec = ENGINES[head_dim]
    common = dict(n_layers=2, vocab_size=128, multiple_of=16, max_seq_len=72,
                  **spec["model"])
    jcfg = jl.LlamaConfig(dtype=jnp.float32, **common)
    cfg = tl.LlamaConfig(dtype=torch.float32, **common)
    assert jcfg.head_dim == cfg.head_dim == head_dim
    jax_params = jl.init_llama(jax.random.key(4), jcfg)
    mesh = build_mesh(MeshSpec(axes={"data": 1}), devices=jax.devices()[:1])
    jeng = JaxPagedEngine(jax_params, jcfg, JaxServeConfig(**spec["serve"]),
                          mesh, JaxPagedConfig(kernel="pallas",
                                               **spec["paged"]))
    jeng.warmup()
    want = _drive(jeng, JaxBatcher, JaxRequest)
    eng = PagedEngine(
        params_from_numpy(jax.device_get(jax_params), cfg, "cpu"), cfg,
        ServeConfig(**spec["serve"]), "cpu",
        PagedConfig(kernel="cuda", **spec["paged"]))
    n0 = eng.warmup()
    got = _drive(eng, ContinuousBatcher, Request)
    assert got == want
    assert sorted(got) == [rid for rid, _, _ in _mix()]
    assert eng.compile_count == n0
