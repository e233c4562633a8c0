"""The port's paged prefill and paged engine at page sizes that 64-key
tiles do not stack (1, 4, 12, 24, 100 tokens) against the JAX package's
Pallas prefill and paged engine, on the CPU.

On the card every page size of a head dim that is a multiple of 16 up
to 128 prefills on a tensor-core route (tests/test_torch_gpu.py holds
those kernels against the plain version); here the port's wrapper runs
its plain version on CPU tensors and the JAX kernel runs with
``interpret=True``, as tests/test_torch_paged_attention.py runs it.
Same inputs from a numpy seed: a table row of shuffled pages, a chunk
that starts inside a page, dead entries pointing at a page of NaNs (NaN
scales for an int8 pool), so a read of a dead page poisons the output.

Tolerance: ``tpu_hpc_torch/checks/tolerance.py``'s rule for q's dtype,
or a coarser 16-bit pool's (``rule_dtype``) -- the rule the card holds
the kernels to. Float32 q and pool: both sides sum in fp32 in other
orders (1e-4). bf16 q and pool: both round P to bf16 before P.V, each
relative to another max, and round the output to bf16. An int8 pool
under a bf16 q: both dequantize in f32 and keep P in f32. A float32 q
over a bf16 pool: the pool's rule (P rounded to bf16 on both sides).
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
# (q dtype, pool dtype): float32 over float32 (the card's TF32 route),
# bf16 over bf16 (its gathering route), an int8 pool under a bf16 q (the
# gathering route with per-key scales), float32 over bf16 (TF32).
PAIRS = [(torch.float32, torch.float32), (torch.bfloat16, torch.bfloat16),
         (torch.bfloat16, torch.int8), (torch.float32, torch.bfloat16)]
PAGE_SIZES = [1, 4, 12, 24, 100]


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _odd_pages_case(bs, q_dtype, pool_dtype, seed, *, hkv=2, g=2, d=32,
                    bucket=24, start=29):
    """One slot's chunk of ``bucket`` tokens at ``start`` over pages of
    ``bs``: the pages up to the chunk's last row in shuffled order, two
    dead entries after them pointing at the pool's last page (NaN, or
    NaN scales over int8). Returns the port's arguments and keywords and
    the JAX kernel's output (interpret mode) as an f32 tensor."""
    rng = np.random.default_rng(seed)
    n_live = -(-(start + bucket) // bs)
    mb = n_live + 2
    num_blocks = n_live + 2
    shape = (num_blocks, bs, hkv, d)
    kp = rng.standard_normal(shape).astype(np.float32)
    vp = rng.standard_normal(shape).astype(np.float32)
    table = np.full(mb, num_blocks - 1, np.int32)
    table[:n_live] = rng.permutation(np.arange(1, num_blocks - 1))
    q = _t(rng.standard_normal((hkv, bucket, g, d)).astype(np.float32))
    q = q.to(q_dtype)
    jq = jnp.asarray(q.float().numpy()).astype(_JNP[q_dtype])
    kw = dict(block_size=bs, max_blocks=mb)
    jkw = dict(kw, interpret=True)
    if pool_dtype == torch.int8:
        kq, ksc = pt_pa.quantize_pages_int8(_t(kp))
        vq, vsc = pt_pa.quantize_pages_int8(_t(vp))
        ksc[-1] = vsc[-1] = float("nan")
        k, v = kq, vq
        jk, jv = jnp.asarray(kq.numpy()), jnp.asarray(vq.numpy())
        kw.update(k_scale=ksc, v_scale=vsc)
        jkw.update(k_scale=jnp.asarray(ksc.numpy()),
                   v_scale=jnp.asarray(vsc.numpy()))
    else:
        kp[-1] = vp[-1] = np.nan
        k, v = _t(kp).to(pool_dtype), _t(vp).to(pool_dtype)
        jk, jv = (jnp.asarray(t.float().numpy()).astype(_JNP[pool_dtype])
                  for t in (k, v))
    want = jax_pa.paged_prefill_attention(
        jq, jk, jv, jnp.asarray(table), jnp.asarray(start, jnp.int32), **jkw)
    return ((q, k, v, _t(table), start), kw,
            _t(np.array(want, np.float32)))


@pytest.mark.parametrize("q_dtype, pool_dtype", PAIRS,
                         ids=lambda t: str(t)[6:])
@pytest.mark.parametrize("bs", PAGE_SIZES)
def test_prefill_at_odd_pages_matches_pallas_kernel(bs, q_dtype,
                                                    pool_dtype):
    """The plain prefill (what the card's kernels are held to) against
    the Pallas prefill at pages of 1 to 100 tokens: a 24-token chunk at
    position 29, so a page (or an 8-key group of a 64-key tile) straddles
    the chunk's first row, and dead entries past the chunk."""
    args, kw, want = _odd_pages_case(bs, q_dtype, pool_dtype, seed=600 + bs)
    got = pt_pa.paged_prefill_attention(*args, **kw)
    assert got.dtype == q_dtype and torch.isfinite(got).all()
    readings = compare(got, want, rule_dtype(
        q_dtype, None if pool_dtype == torch.int8 else pool_dtype))
    assert readings["ok"], readings


JAX_TINY = jl.LlamaConfig(
    dim=64, n_layers=2, n_heads=4, n_kv_heads=2, vocab_size=128,
    multiple_of=16, max_seq_len=72, dtype=jnp.float32,
)
TINY = tl.LlamaConfig(
    dim=64, n_layers=2, n_heads=4, n_kv_heads=2, vocab_size=128,
    multiple_of=16, max_seq_len=72, dtype=torch.float32,
)
# Pages of 12 tokens, chunks of 24: prompts of 30 and 41 tokens prefill
# in two chunks, each over a chunk that ends inside a page.
SERVE = dict(slots=2, max_seq_len=60, prefill_buckets=(24, 48))
PAGED = dict(block_size=12, num_blocks=12, prefill_chunk=24)


def _mix():
    rng = np.random.default_rng(21)
    return [(f"r{i}", rng.integers(0, 128, size=n).tolist(), 5)
            for i, n in enumerate((30, 7, 41, 13))]


def _drive(engine, batcher_cls, request_cls):
    batcher = batcher_cls(engine)
    for rid, prompt, n in _mix():
        batcher.submit(request_cls(rid=rid, prompt=prompt, max_new_tokens=n))
    while not batcher.done:
        batcher.step()
    return dict(batcher.results)


def test_paged_engine_at_pages_of_12_matches_jax_engine():
    """The port's PagedEngine at 12-token pages and 24-token chunks
    (kernel="cuda": on the CPU the kernels' plain versions) gives the
    JAX PagedEngine's greedy tokens (kernel="pallas", interpret mode)
    on every request, and builds nothing after warmup."""
    jax_params = jl.init_llama(jax.random.key(3), JAX_TINY)
    mesh = build_mesh(MeshSpec(axes={"data": 1}), devices=jax.devices()[:1])
    jeng = JaxPagedEngine(jax_params, JAX_TINY, JaxServeConfig(**SERVE), mesh,
                          JaxPagedConfig(kernel="pallas", **PAGED))
    jeng.warmup()
    want = _drive(jeng, JaxBatcher, JaxRequest)
    eng = PagedEngine(
        params_from_numpy(jax.device_get(jax_params), TINY, "cpu"), TINY,
        ServeConfig(**SERVE), "cpu", PagedConfig(kernel="cuda", **PAGED))
    n0 = eng.warmup()
    got = _drive(eng, ContinuousBatcher, Request)
    assert got == want
    assert sorted(got) == [rid for rid, _, _ in _mix()]
    assert eng.compile_count == n0
    assert eng.paged_stats["prefill_chunks"] > len(_mix())
