"""The port's flash attention and its training slice at head dims off the
64- and 128-column kernels (36, 72, 136, 256) against the JAX package's
Pallas flash kernels and JAX step, on the CPU.

On the card the 16-bit flash kernels take every head dim up to 256 and
the float32 ones every one up to 128, each padded to its 64-, 128- or
256-column instantiation (tests/test_torch_gpu_flash.py holds those
kernels against the plain versions). Here the port's wrappers run their
plain versions on CPU tensors, through the autograd function the card
uses, and the JAX side runs its Pallas kernels with ``interpret=True``
and 8-row blocks, as tests/test_torch_attention.py does. Same inputs
from a numpy seed: GQA 8 over 1, runtime offsets on both sides, and the
first rows fully masked (q_offset 3 < kv_offset 7); one shape per head
dim and dtype, so each JAX compile serves the forward, dq and dk/dv.

Tolerances. Float32 kernels: ``atol = rtol = 2e-5`` -- both sides do the
same fp32 arithmetic in another order (the Pallas kernel's blocked
online softmax against one full softmax) over dot products of up to 256
terms. bf16 kernels: ``tpu_hpc_torch/checks/tolerance.py``'s bf16 rule,
the one the card holds the kernels to: the Pallas kernel, like the
card's, rounds P and dS to bf16 before their products and its outputs to
bf16, where the plain versions keep them in fp32. The slice (a Llama
with head_dim 256: dim 512, 2 heads over 1 KV head, 2 layers, vocab 128)
is float32 and keeps test_torch_train.py's bounds: loss ``rtol 1e-5``,
gradients ``atol 1e-6, rtol 1e-4``, params after 3 AdamW updates ``atol
2e-6, rtol 1e-5``.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax", reason="the JAX reference package")
jnp = jax.numpy

from tpu_hpc.config import TrainingConfig as JaxTrainingConfig
from tpu_hpc.kernels import attention as ja
from tpu_hpc.models import llama2 as jl
from tpu_hpc.parallel import tp as jtp
from tpu_hpc.train import trainer as jtrainer
from tpu_hpc_torch.checks.tolerance import compare
from tpu_hpc_torch.config import TrainingConfig
from tpu_hpc_torch.kernels import attention as ta
from tpu_hpc_torch.models import datasets as tds
from tpu_hpc_torch.models import llama2 as tl
from tpu_hpc_torch.parallel import tp as ttp
from tpu_hpc_torch.train import trainer as ttrainer

HEAD_DIMS = [36, 72, 136, 256]
F32_TOL = dict(atol=2e-5, rtol=2e-5)
# (b, sq, sk, hq, hkv, q_offset, kv_offset): rows 0-3 see no key.
SHAPE = (1, 20, 24, 8, 1, 3, 7)


def _close(got, want, dtype, what):
    got = got.detach()
    if dtype == torch.float32:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32_TOL,
                                   err_msg=what)
    else:
        r = compare(got, torch.from_numpy(np.asarray(want, np.float32)),
                    dtype)
        assert r["ok"], f"{what}: {r}"


def _inputs(d, dtype):
    """q, k, v, dout and dlse from a numpy seed, rounded once to the
    working dtype (float32 arrays holding those values)."""
    b, sq, sk, hq, hkv, _, _ = SHAPE
    rng = np.random.default_rng(d)
    arrays = [rng.standard_normal(shape).astype(np.float32) for shape in (
        (b, sq, hq, d), (b, sk, hkv, d), (b, sk, hkv, d), (b, sq, hq, d))]
    dlse = rng.standard_normal((b, sq, hq)).astype(np.float32)
    return [np.asarray(torch.from_numpy(a).to(dtype).float())
            for a in arrays] + [dlse]


def _check_masked_rows(out, lse, dq):
    _, sq, _, _, _, qo, ko = SHAPE
    dead = np.arange(sq) + qo < ko
    assert dead.any()
    assert (lse.detach().numpy()[:, dead] == np.float32(ta.MASK_VALUE)).all()
    assert not out.detach().float().numpy()[:, dead].any()
    assert not dq.detach().float().numpy()[:, dead].any()
    return ~dead


@pytest.mark.parametrize("d", HEAD_DIMS)
def test_flash_autograd_matches_pallas_at_head_dim_float32(d):
    """out, lse, dq, dk, dv of ``sum(out*w1) + sum(lse*w2)`` (a nonzero
    dlse) through the port's flash_attention (the forward, dq and dk/dv
    kernels' plain versions, in the autograd function the card runs)
    against the JAX Pallas kernels' custom_vjp, float32."""
    _, _, _, _, _, qo, ko = SHAPE
    q, k, v, w1, w2 = _inputs(d, torch.float32)

    def jax_loss(q, k, v):
        out, lse = ja.blockwise_attention(
            q, k, v, causal=True, q_offset=qo, kv_offset=ko,
            impl="pallas_interpret", block_q=8, block_k=8)
        return jnp.sum(out * w1) + jnp.sum(lse * w2), (out, lse)

    (_, (jo, jlse)), jg = jax.value_and_grad(
        jax_loss, argnums=(0, 1, 2), has_aux=True,
    )(*(jnp.asarray(a) for a in (q, k, v)))
    tq, tk, tv = (torch.from_numpy(a).requires_grad_(True) for a in (q, k, v))
    launches0 = ta.kernel_launches()
    out, lse = ta.blockwise_attention(tq, tk, tv, causal=True, q_offset=qo,
                                      kv_offset=ko, impl="cuda")
    (out * torch.from_numpy(w1)).sum().add(
        (lse * torch.from_numpy(w2)).sum()).backward()
    assert ta.kernel_launches() == launches0  # CPU tensors never launch
    live = _check_masked_rows(out, lse, tq.grad)
    _close(out, jo, torch.float32, "out")
    np.testing.assert_allclose(lse.detach().numpy()[:, live],
                               np.asarray(jlse)[:, live], **F32_TOL)
    for name, got, want in zip("qkv", (tq.grad, tk.grad, tv.grad), jg):
        _close(got, want, torch.float32, f"d{name}")


@pytest.mark.parametrize("d", HEAD_DIMS)
def test_flash_kernels_match_pallas_at_head_dim_bf16(d):
    """The forward kernel's plain version against the Pallas forward, then
    dq and dk/dv from the same (out, lse, dout, dlse) against the Pallas
    backward kernels, bf16: each kernel on its own, so the bf16 rounding
    of one side's out does not reach the other's D = rowsum(dO * O)."""
    _, _, _, _, _, qo, ko = SHAPE
    q, k, v, dout, dlse = _inputs(d, torch.bfloat16)
    jq, jk, jv, jdo = (jnp.asarray(a, jnp.bfloat16) for a in (q, k, v, dout))
    jo, jlse = ja.flash_attention(jq, jk, jv, qo, ko, True, None, 8, 8, True)
    jdq, jdk, jdv = ja._flash_backward(
        jq, jk, jv, jo, jlse, jdo, jnp.asarray(dlse), qo, ko, causal=True,
        sm_scale=d ** -0.5, block_q=8, block_k=8, interpret=True)

    tq, tk, tv, tdo = (torch.from_numpy(a).bfloat16() for a in (q, k, v, dout))
    out, lse = ta.flash_attention_fwd(tq, tk, tv, qo, ko)
    assert out.dtype == torch.bfloat16
    _close(out, np.asarray(jo, np.float32), torch.bfloat16, "out")
    to = torch.from_numpy(np.asarray(jo, np.float32)).bfloat16()
    tl_ = torch.from_numpy(np.array(jlse))
    dm = (tdo.float() * to.float()).sum(-1) - torch.from_numpy(dlse)
    args = (tq, tk, tv, tdo, tl_, dm, qo, ko)
    dq = ta.flash_attention_dq(*args)
    dk, dv = ta.flash_attention_dkv(*args)
    live = _check_masked_rows(out, lse, dq)
    np.testing.assert_allclose(lse.numpy()[:, live], np.asarray(jlse)[:, live],
                               **F32_TOL)
    for name, got, want in (("dq", dq, jdq), ("dk", dk, jdk), ("dv", dv, jdv)):
        assert got.dtype == torch.bfloat16 and torch.isfinite(got).all()
        _close(got, np.asarray(want, np.float32), torch.bfloat16, name)


@pytest.mark.parametrize("dtype", [torch.float16, torch.bfloat16,
                                   torch.float32], ids=str)
def test_padded_head_dim_rounds_rows_to_16_bytes(dtype):
    """The width the wrappers pad a head dim to on the card: the least
    multiple of 16 bytes at or above it, so every d from 1 to 256 reaches
    a kernel."""
    per = 4 if dtype == torch.float32 else 8
    for d in range(1, 257):
        w = ta.padded_head_dim(d, dtype)
        assert w % per == 0 and d <= w < d + per
        assert w == d or d % per
    x = torch.randn(2, 3, 4, 37).to(dtype)
    padded = ta._pad(x, ta.padded_head_dim(37, dtype))
    assert padded.shape[-1] == 40 and padded.is_contiguous()
    assert torch.equal(padded[..., :37], x) and not padded[..., 37:].any()
    assert ta._pad(x, 37) is x


# ---------------------------------------------------------------------------
# The slice: a Llama with head_dim 256, forward, gradients, Trainer updates
# ---------------------------------------------------------------------------

SEQ = 16
WIDE = dict(dim=512, n_layers=2, n_heads=2, n_kv_heads=1, vocab_size=128,
            multiple_of=16, max_seq_len=SEQ)
JAX_WIDE = jl.LlamaConfig(**WIDE, dtype=jnp.float32)
TORCH_WIDE = tl.LlamaConfig(**WIDE, dtype=torch.float32)


@pytest.fixture(scope="module")
def jax_params():
    assert TORCH_WIDE.head_dim == 256
    return jl.init_llama(jax.random.key(1), JAX_WIDE)


@pytest.fixture(scope="module")
def one_device_mesh():
    return jax.sharding.Mesh(np.array(jax.devices()[:1]), ("data",))


def _port_params(jax_params):
    return ttrainer.state_from_numpy(
        0, jax.device_get(jax_params), None, TrainingConfig(), "cpu").params


def _flat(tree):
    return [np.asarray(a) for a in jax.tree.leaves(tree)]


def test_head_dim_256_llama_loss_and_grads_match_jax_flash(
        jax_params, one_device_mesh):
    """Loss and every param gradient of make_forward with the flash hook
    at head_dim 256 (one KV head), against JAX make_forward through the
    Pallas flash kernels (interpret mode) on a one-device mesh."""
    rng = np.random.default_rng(5)
    tokens = rng.integers(0, 128, size=(2, SEQ + 1)).astype(np.int32)
    batch = (tokens[:, :-1], tokens[:, 1:])
    jfwd = jl.make_forward(JAX_WIDE, attn_fn=jtp.make_tp_flash_attn_fn(
        one_device_mesh, impl="pallas_interpret", block_q=SEQ, block_k=SEQ))
    (jloss, _), jgrads = jax.value_and_grad(
        lambda p: jfwd(p, {}, tuple(map(jnp.asarray, batch)), None)[:2],
        has_aux=True,
    )(jax_params)
    params = _port_params(jax_params)
    fwd = tl.make_forward(TORCH_WIDE, attn_fn=ttp.make_tp_flash_attn_fn(
        None, impl="cuda"))
    loss, _, _ = fwd(params, {}, tuple(torch.from_numpy(a).long()
                                       for a in batch), None)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=1e-5)
    grads = ttrainer.tree_leaves(ttrainer.tree_map(lambda p: p.grad, params))
    want = _flat(jgrads)
    assert len(grads) == len(want)
    for g, w in zip(grads, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(g.numpy(), w, atol=1e-6, rtol=1e-4)


def test_head_dim_256_trainer_updates_match_jax_step(jax_params,
                                                     one_device_mesh):
    """3 AdamW updates (accum 2, clipping, warmup) of the port's
    Trainer.fit with the flash hook against the jitted JAX step on the
    same batches: every loss and the params after."""
    kw = dict(epochs=1, steps_per_epoch=3, global_batch_size=4, seed=0,
              weight_decay=0.1, learning_rate=3e-3, warmup_steps=2,
              max_grad_norm=0.5, grad_accum_steps=2)
    jcfg, cfg = JaxTrainingConfig(**kw), TrainingConfig(**kw)
    rng = np.random.default_rng(9)
    batches = []
    for _ in range(3):
        t = rng.integers(0, 128, size=(4, SEQ + 1)).astype(np.int32)
        batches.append((t[:, :-1], t[:, 1:]))
    jfwd = jl.make_forward(JAX_WIDE, attn_fn=jtp.make_tp_flash_attn_fn(
        one_device_mesh, impl="xla"))
    jopt = jtrainer.make_optimizer(jcfg)
    jstep = jax.jit(jtrainer.make_step_fn(
        jfwd, jopt, jcfg.seed, grad_accum=jcfg.grad_accum_steps,
        log_grad_norm=True))
    jstate = jtrainer.TrainState(step=jnp.int32(0), params=jax_params,
                                 opt_state=jopt.init(jax_params),
                                 model_state={})
    jlosses = []
    for b in batches:
        jstate, m = jstep(jstate, tuple(map(jnp.asarray, b)))
        jlosses.append(float(m["loss"]))

    trainer = ttrainer.Trainer(
        cfg, None, tl.make_forward(TORCH_WIDE, attn_fn=ttp.make_tp_flash_attn_fn(
            None, impl="cuda")),
        _port_params(jax_params), device="cpu")
    result = trainer.fit(tds.ArrayBatches(batches))
    np.testing.assert_allclose(result["epochs"][0]["losses"], jlosses,
                               rtol=1e-5)
    got = np.concatenate([p.detach().numpy().ravel() for p in
                          ttrainer.tree_leaves(trainer.state.params)])
    want = np.concatenate([w.ravel() for w in _flat(jstate.params)])
    np.testing.assert_allclose(got, want, atol=2e-6, rtol=1e-5)
