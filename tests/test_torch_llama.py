"""The port's Llama-2 (tpu_hpc_torch/models/llama2.py) against the JAX
package's (tpu_hpc/models/llama2.py) on the CPU.

The JAX params are carried across with ``params_from_numpy``; inputs
come from a numpy seed. Float32 throughout, so the tolerances only
cover summation order: logits ``atol 1e-4`` (two layers of 64-wide
matmuls and softmaxes), RoPE/RMSNorm pieces ``1e-6``.
"""
import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax", reason="the JAX reference package")
jnp = jax.numpy

from tpu_hpc.models import llama2 as jl
from tpu_hpc.serve import engine as jax_engine
from tpu_hpc_torch.models import llama2 as tl
from tpu_hpc_torch.serve import engine as pt_engine
from tpu_hpc_torch.serve.weights import params_from_numpy

JAX_TINY = jl.LlamaConfig(
    dim=64, n_layers=2, n_heads=4, n_kv_heads=2, vocab_size=128,
    multiple_of=16, max_seq_len=64, dtype=jnp.float32,
)
TINY = tl.LlamaConfig(
    dim=64, n_layers=2, n_heads=4, n_kv_heads=2, vocab_size=128,
    multiple_of=16, max_seq_len=64, dtype=torch.float32,
)


@pytest.fixture(scope="module")
def jax_params():
    return jl.init_llama(jax.random.key(0), JAX_TINY)


@pytest.fixture(scope="module")
def port_params(jax_params):
    return params_from_numpy(jax.device_get(jax_params), TINY, "cpu")


def _shape_tree(tree):
    return {
        k: _shape_tree(v) if isinstance(v, dict) else tuple(v.shape)
        for k, v in tree.items()
    }


def test_config_fields_and_presets_match():
    assert [f.name for f in dataclasses.fields(tl.LlamaConfig)] == [
        f.name for f in dataclasses.fields(jl.LlamaConfig)
    ]
    assert sorted(tl.PRESETS) == sorted(jl.PRESETS)
    for name in tl.PRESETS:
        a, b = tl.PRESETS[name], jl.PRESETS[name]
        for attr in ("dim", "n_layers", "n_heads", "kv_heads", "head_dim",
                     "ffn_hidden", "vocab_size", "max_seq_len", "norm_eps"):
            assert getattr(a, attr) == getattr(b, attr), (name, attr)
        assert a.flops_per_token(2048) == b.flops_per_token(2048)
    assert tl.PRESETS["7b"].dtype == torch.bfloat16


@pytest.mark.parametrize("name", ["tiny", "7b", "13b", "70b"])
def test_count_params_matches(name):
    if name == "tiny":
        assert tl.count_params(TINY) == jl.count_params(JAX_TINY)
    else:
        assert tl.count_params(tl.PRESETS[name]) == jl.count_params(
            jl.PRESETS[name]
        )


def test_init_tree_keys_shapes_and_distributions(jax_params):
    gen = torch.Generator().manual_seed(0)
    cfg = dataclasses.replace(TINY, n_layers=3, dim=128, vocab_size=512)
    params = tl.init_llama(gen, cfg, "cpu")
    jax_cfg = dataclasses.replace(
        JAX_TINY, n_layers=3, dim=128, vocab_size=512
    )
    want = jax.eval_shape(lambda: jl.init_llama(jax.random.key(0), jax_cfg))
    assert _shape_tree(params) == _shape_tree(want)
    assert params["layers_0"]["attention"]["wq"]["kernel"].dtype \
        == torch.float32
    emb = params["tok_embeddings"]["embedding"]
    assert abs(float(emb.std()) - 1.0) < 0.02
    for i in range(3):
        lp = params[f"layers_{i}"]
        want_std = 0.02 / (2 * (i + 1)) ** 0.5  # depth-scaled residual init
        for w in (lp["attention"]["wo"]["kernel"],
                  lp["feed_forward"]["w2"]["kernel"]):
            assert abs(float(w.std()) / want_std - 1.0) < 0.05
        assert abs(float(lp["attention"]["wq"]["kernel"].std()) / 0.02
                   - 1.0) < 0.05
        assert torch.all(lp["ffn_norm"]["scale"] == 1.0)
    head = params["output"]["kernel"]
    assert float(head.abs().max()) <= 0.04  # truncated at 2 std
    # same seed, same numbers; another seed, others
    again = tl.init_llama(torch.Generator().manual_seed(0), cfg, "cpu")
    torch.testing.assert_close(again["output"]["kernel"], head)


def test_apply_llama_logits_match(jax_params, port_params):
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, TINY.vocab_size, size=(2, 24)).astype(np.int32)
    want = np.asarray(jl.apply_llama(jax_params, jnp.asarray(tokens),
                                     JAX_TINY))
    got = tl.apply_llama(
        port_params, torch.from_numpy(tokens).long(), TINY
    ).numpy()
    assert got.shape == want.shape == (2, 24, TINY.vocab_size)
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)
    assert (got.argmax(-1) == want.argmax(-1)).all()


def test_rope_tables_and_rotation_match():
    rng = np.random.default_rng(1)
    jc, js = jl.rope_cos_sin(12, 16)
    tc, ts = tl.rope_cos_sin(12, 16)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=1e-6)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), atol=1e-6)
    positions = np.array([0, 5, 47, 3], np.int32)
    jc, js = jl.rope_cos_sin(1, 16, positions=jnp.asarray(positions))
    tc, ts = tl.rope_cos_sin(1, 16, positions=torch.from_numpy(positions))
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=1e-6)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), atol=1e-6)
    # shared [S, D/2] tables and per-row [B, 1, D/2] tables
    x = rng.standard_normal((4, 12, 3, 16)).astype(np.float32)
    jc, js = jl.rope_cos_sin(12, 16)
    want = np.asarray(jl.apply_rope(jnp.asarray(x), jc, js))
    got = tl.apply_rope(torch.from_numpy(x), *tl.rope_cos_sin(12, 16))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6)
    x1 = x[:, :1]
    jc, js = jl.rope_cos_sin(1, 16, positions=jnp.asarray(positions))
    want = np.asarray(jl.apply_rope(jnp.asarray(x1), jc[:, None], js[:, None]))
    tc, ts = tl.rope_cos_sin(1, 16, positions=torch.from_numpy(positions))
    got = tl.apply_rope(torch.from_numpy(x1), tc[:, None], ts[:, None])
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6)


def test_rmsnorm_matches_and_keeps_dtype():
    rng = np.random.default_rng(2)
    x = rng.standard_normal((3, 5, 64)).astype(np.float32)
    scale = rng.standard_normal(64).astype(np.float32)
    want = np.asarray(jax_engine._rmsnorm(
        jnp.asarray(x), jnp.asarray(scale), 1e-5
    ))
    got = pt_engine._rmsnorm(torch.from_numpy(x), torch.from_numpy(scale),
                             1e-5)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=1e-6)
    half = pt_engine._rmsnorm(torch.from_numpy(x).bfloat16(),
                              torch.from_numpy(scale), 1e-5)
    assert half.dtype == torch.bfloat16


def test_params_from_numpy_layout(port_params):
    """Dense kernels stay flax [in, out]; matrices in the compute dtype,
    norm scales in float32."""
    wq = port_params["layers_0"]["attention"]["wq"]["kernel"]
    assert tuple(wq.shape) == (TINY.dim, TINY.n_heads * TINY.head_dim)
    bf = params_from_numpy(
        {"w": {"kernel": np.ones((4, 8), np.float32)},
         "n": {"scale": np.ones(4, np.float32)}},
        dataclasses.replace(TINY, dtype=torch.bfloat16), "cpu",
    )
    assert bf["w"]["kernel"].dtype == torch.bfloat16
    assert bf["n"]["scale"].dtype == torch.float32
