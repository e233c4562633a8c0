"""The port's training slice (tpu_hpc_torch/train, models, config,
parallel/tp, checks/roofline) against the JAX package's on the CPU.

Params are the JAX init carried across with ``state_from_numpy``;
batches are the JAX ``TokenStream``'s own, replayed through
``ArrayBatches``. Float32 throughout, so every tolerance covers
summation order only: the loss ``rtol 1e-5``; gradients ``atol 1e-6,
rtol 1e-4`` (two layers of 64-wide products, summed over 2 x 24 tokens);
params after Adam updates ``atol 2e-6`` -- each element moves by about
lr x (mu_hat / sqrt(nu_hat)), so a gradient's relative rounding
difference moves it by far less than that. bf16 Adam moments add rare
rounding-boundary flips, bounded as stated in that test.

The port's flash path on CPU tensors runs the kernels' plain versions
through the same autograd function the card uses (``impl="cuda"``).
"""
import dataclasses
import json
import subprocess
import sys

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax", reason="the JAX reference package")
jnp = jax.numpy

from tpu_hpc.config import TrainingConfig as JaxTrainingConfig
from tpu_hpc.models import datasets as jds
from tpu_hpc.models import llama2 as jl
from tpu_hpc.models import losses as jlosses
from tpu_hpc.parallel import tp as jtp
from tpu_hpc.train import metrics as jmetrics
from tpu_hpc.train import trainer as jtrainer
from tpu_hpc_torch.checks import roofline
from tpu_hpc_torch.config import TrainingConfig
from tpu_hpc_torch.models import datasets as tds
from tpu_hpc_torch.models import llama2 as tl
from tpu_hpc_torch.models import losses as tlosses
from tpu_hpc_torch.parallel import tp as ttp
from tpu_hpc_torch.train import __main__ as tmain
from tpu_hpc_torch.train import metrics as tmetrics
from tpu_hpc_torch.train import trainer as ttrainer

SEQ = 24
JAX_TINY = jl.LlamaConfig(
    dim=64, n_layers=2, n_heads=4, n_kv_heads=2, vocab_size=128,
    multiple_of=16, max_seq_len=SEQ, dtype=jnp.float32,
)
TINY = tl.LlamaConfig(
    dim=64, n_layers=2, n_heads=4, n_kv_heads=2, vocab_size=128,
    multiple_of=16, max_seq_len=SEQ, dtype=torch.float32,
)


@pytest.fixture(scope="module")
def jax_params():
    return jl.init_llama(jax.random.key(0), JAX_TINY)


@pytest.fixture(scope="module")
def one_device_mesh():
    return jax.sharding.Mesh(np.array(jax.devices()[:1]), ("data",))


def _port_params(jax_params):
    return ttrainer.state_from_numpy(
        0, jax.device_get(jax_params), None, TrainingConfig(), "cpu").params


def _flat(tree):
    return [np.asarray(a) for a in jax.tree.leaves(tree)]


# ---------------------------------------------------------------------------
# Framework-free pieces
# ---------------------------------------------------------------------------

def test_training_config_fields_and_defaults_match():
    ours = dataclasses.fields(TrainingConfig)
    theirs = dataclasses.fields(JaxTrainingConfig)
    assert [f.name for f in ours] == [f.name for f in theirs]
    for a, b in zip(ours, theirs):
        assert a.default == b.default, a.name
    cfg = TrainingConfig.from_args(["--grad-accum-steps", "4", "--resume",
                                    "false", "--learning-rate", "0.5"])
    want = JaxTrainingConfig.from_args(["--grad-accum-steps", "4",
                                        "--resume", "false",
                                        "--learning-rate", "0.5"])
    assert dataclasses.asdict(cfg) == dataclasses.asdict(want)
    assert cfg.torch_dtypes() == (torch.float32, torch.bfloat16)
    with pytest.raises(ValueError, match="unsupported dtype"):
        TrainingConfig(compute_dtype="int8").torch_dtypes()


@pytest.mark.parametrize("kind,warmup", [("constant", 0), ("constant", 3),
                                         ("cosine", 2), ("cosine", 0)])
def test_lr_schedule_matches_optax(kind, warmup):
    kw = dict(epochs=2, steps_per_epoch=5, learning_rate=3e-3,
              lr_schedule=kind, warmup_steps=warmup)
    ours = ttrainer.make_lr_schedule(TrainingConfig(**kw))
    theirs = jtrainer.make_lr_schedule(JaxTrainingConfig(**kw))
    for n in range(12):
        want = theirs(n) if callable(theirs) else theirs
        # optax evaluates in float32, the port in float64
        np.testing.assert_allclose(ours(n), float(want), rtol=1e-5,
                                   atol=1e-12)
    if warmup:
        assert ours(0) == 0.0  # optax: update 0 reads schedule(0)


def test_optimizer_validation_matches():
    for kw in (dict(adam_moments_dtype="bfloat16"), dict(max_grad_norm=-1.0),
               dict(weight_decay=0.1, adam_moments_dtype="float16")):
        with pytest.raises(ValueError):
            jtrainer.make_optimizer(JaxTrainingConfig(**kw))
        with pytest.raises(ValueError):
            ttrainer.make_optimizer(TrainingConfig(**kw))
    assert isinstance(ttrainer.make_optimizer(TrainingConfig()), ttrainer.SGD)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cross_entropy_matches(dtype):
    rng = np.random.default_rng(0)
    logits = rng.standard_normal((2, 7, 50)).astype(np.float32) * 3
    targets = rng.integers(0, 50, size=(2, 7)).astype(np.int32)
    want = jlosses.cross_entropy(jnp.asarray(logits, dtype), jnp.asarray(targets))
    got = tlosses.cross_entropy(torch.from_numpy(logits).to(getattr(torch, dtype)),
                                torch.from_numpy(targets))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
    grid = rng.standard_normal((2, 9, 5, 3)).astype(np.float32)
    np.testing.assert_allclose(
        float(tlosses.lat_weighted_mse(torch.from_numpy(grid),
                                       torch.zeros(2, 9, 5, 3))),
        float(jlosses.lat_weighted_mse(jnp.asarray(grid), jnp.zeros_like(grid))),
        rtol=1e-5)


def test_meters_match_jax():
    ours, theirs = tmetrics.ThroughputMeter(n_devices=2), \
        jmetrics.ThroughputMeter(n_devices=2)
    for meter in (ours, theirs):
        for dt, items in ((0.5, 10), (0.25, 10)):
            meter.batch_times.append(dt)
            meter.batch_items.append(items)
    assert ours.epoch_summary() == theirs.epoch_summary()
    assert ours.epoch_summary(skip_first=0) == theirs.epoch_summary(skip_first=0)
    with pytest.raises(RuntimeError, match="start_batch"):
        ours.end_batch(1)
    g = tmetrics.GoodputMeter()
    g.add("productive", 1.0)
    with pytest.raises(ValueError, match="goodput bucket"):
        g.add("compile", 1.0)
    assert set(g.summary()) == set(jmetrics.GoodputMeter().summary())
    assert tmetrics.mfu(1e3, 10**6, 1, 1e12) == jmetrics.mfu(1e3, 10**6, 1, 1e12)


def test_peak_table_is_the_one_source():
    from tpu_hpc_torch.serve import server

    sxm = roofline.chip_for_kind("NVIDIA H100 80GB HBM3")
    assert sxm.peak_bf16_flops == 989e12 and sxm.hbm_bytes_per_s == 3.35e12
    assert sxm.peak_flops(torch.float32) == 67e12
    assert roofline.chip_for_kind("NVIDIA H100 PCIe").peak_bf16_flops == 756e12
    assert roofline.chip_for_kind("NVIDIA H100 NVL") is None
    assert roofline.chip_for_kind("NVIDIA A100-SXM4-80GB") is None
    assert roofline.peak_flops_for_device(torch.device("cpu")) is None
    assert server.peak_flops_for_device is roofline.peak_flops_for_device


def test_token_stream_contract():
    ds = tds.TokenStream(vocab_size=50, seq_len=9, seed=3)
    x, y = ds.batch_at(5, 4)
    assert x.shape == y.shape == (4, 9) and x.dtype == torch.int64
    assert torch.equal(x[:, 1:], y[:, :-1])  # next-token targets
    assert torch.equal(ds.batch_at(5, 4)[0], x)  # index-stateless
    assert not torch.equal(ds.batch_at(6, 4)[0], x)
    assert not torch.equal(tds.TokenStream(50, 9, seed=4).batch_at(5, 4)[0], x)
    assert int(x.max()) < 50
    with pytest.raises(ValueError, match=r"divisible by 2\*ring=4"):
        tds.TokenStream(vocab_size=50, seq_len=9, zigzag_ring=2)
    replay = tds.ArrayBatches([(np.ones((2, 3), np.int32),
                                np.zeros((2, 3), np.int32))])
    assert replay.batch_at(0, 2)[0].dtype == torch.int64
    with pytest.raises(ValueError, match="holds 2 rows"):
        replay.batch_at(0, 4)


def test_tp_factory_is_one_device_only():
    """Without a DeviceMesh the factory is the one-device closure (None,
    or sizes of one device; sizes above one device name the missing
    mesh). With a one-rank gloo world's (data 1, model 1) DeviceMesh it
    runs the same closure under local_map on the model axis: DTensor
    heads in and out, the plain closure's values."""
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor, Shard

    from tpu_hpc_torch.runtime import MeshSpec, build_mesh
    from tpu_hpc_torch.runtime.sim import free_port

    fn = ttp.make_tp_flash_attn_fn(None)
    q = torch.randn(1, 8, 2, 16)
    out = fn(q, q, q)
    assert out.shape == q.shape
    assert callable(ttp.make_tp_flash_attn_fn({"data": 1, "model": 1}))
    with pytest.raises(ValueError, match="DeviceMesh"):
        ttp.make_tp_flash_attn_fn({"data": 2, "model": 1})
    dist.init_process_group("gloo", init_method=f"tcp://localhost:"
                            f"{free_port()}", world_size=1, rank=0)
    try:
        mesh = build_mesh(MeshSpec(axes={"data": 1, "model": 1}), "cpu")
        heads = DTensor.from_local(q, mesh["model"], [Shard(2)])
        got = ttp.make_tp_flash_attn_fn(mesh)(heads, heads, heads)
        assert isinstance(got, DTensor) and got.placements == (Shard(2),)
        torch.testing.assert_close(got.to_local(), out, rtol=0, atol=0)
        assert ttp.make_tp_flash_attn_fn(mesh, "data", None)(q, q, q) \
            .shape == q.shape  # no model axis: the bare closure
    finally:
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# The model's training forward
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("remat", [False, True], ids=["plain", "remat"])
def test_make_forward_loss_and_grads_match_jax_flash(
    jax_params, one_device_mesh, remat
):
    """Loss and every param gradient of make_forward with the flash
    attention hook, against JAX make_forward through the Pallas flash
    kernels (interpret mode) on a one-device mesh."""
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, 128, size=(2, SEQ + 1)).astype(np.int32)
    batch = (tokens[:, :-1], tokens[:, 1:])
    jfwd = jl.make_forward(dataclasses.replace(JAX_TINY, remat=remat),
                           attn_fn=jtp.make_tp_flash_attn_fn(
                               one_device_mesh, impl="pallas_interpret",
                               block_q=8, block_k=8))
    (jloss, _), jgrads = jax.value_and_grad(
        lambda p: jfwd(p, {}, tuple(map(jnp.asarray, batch)), None)[:2],
        has_aux=True,
    )(jax_params)
    params = _port_params(jax_params)
    fwd = tl.make_forward(dataclasses.replace(TINY, remat=remat),
                          attn_fn=ttp.make_tp_flash_attn_fn(None, impl="cuda"))
    loss, ms, aux = fwd(params, {}, tuple(torch.from_numpy(a).long()
                                          for a in batch), None)
    loss.backward()
    assert ms == {} and aux == {}
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=1e-5)
    grads = ttrainer.tree_map(lambda p: p.grad, params)
    got = ttrainer.tree_leaves(grads)
    assert ttrainer.tree_paths(grads) == [
        tuple(k.key for k in path)
        for path, _ in jax.tree_util.tree_flatten_with_path(jgrads)[0]
    ]
    for g, w in zip(got, _flat(jgrads)):
        np.testing.assert_allclose(g.numpy(), w, atol=1e-6, rtol=1e-4)


def test_embedding_backward_sums_in_fp32_and_rounds_once():
    """iota_embed: the table gradient of repeated tokens is the fp32 sum
    rounded to bf16 once, where a bf16 scatter-add would round per add."""
    table = torch.zeros(4, 8, dtype=torch.bfloat16, requires_grad=True)
    tokens = torch.tensor([[1] * 300])
    g = torch.full((1, 300, 8), 1.0 + 2 ** -7, dtype=torch.bfloat16)
    out = tl._EmbedLookup.apply(table, tokens)
    out.backward(g)
    want = torch.tensor(300 * (1.0 + 2 ** -7)).to(torch.bfloat16)
    assert torch.all(table.grad[1] == want)
    assert not table.grad[[0, 2, 3]].any()


# ---------------------------------------------------------------------------
# The slice as a whole: Trainer updates against the JAX step
# ---------------------------------------------------------------------------

def _jax_stream_batches(n, batch):
    ds = jds.TokenStream(vocab_size=128, seq_len=SEQ, seed=7)
    return [tuple(np.asarray(a) for a in ds.batch_at(i, batch))
            for i in range(n)]


TRAIN_CASES = {
    "adamw_warmup_clip_accum2": dict(
        weight_decay=0.1, learning_rate=3e-3, warmup_steps=2,
        max_grad_norm=0.5, grad_accum_steps=2),
    "adamw_bf16_moments_cosine": dict(
        weight_decay=0.1, learning_rate=3e-3, lr_schedule="cosine",
        warmup_steps=1, adam_moments_dtype="bfloat16", grad_accum_steps=2),
    "sgd_momentum": dict(learning_rate=0.05, momentum=0.9,
                         max_grad_norm=1.0),
}


@pytest.mark.parametrize("name", list(TRAIN_CASES))
def test_trainer_updates_match_jax_step(jax_params, one_device_mesh, name):
    """3 updates of the port's Trainer.fit against the JAX step
    (make_step_fn + make_optimizer, jitted) on the JAX stream's batches:
    every update's loss, the grad_norm metric, and the params after."""
    kw = dict(epochs=1, steps_per_epoch=3, global_batch_size=4, seed=0,
              **TRAIN_CASES[name])
    jcfg, cfg = JaxTrainingConfig(**kw), TrainingConfig(**kw)
    batches = _jax_stream_batches(3, 4)
    jfwd = jl.make_forward(JAX_TINY, attn_fn=jtp.make_tp_flash_attn_fn(
        one_device_mesh, impl="xla"))
    jopt = jtrainer.make_optimizer(jcfg)
    jstep = jax.jit(jtrainer.make_step_fn(
        jfwd, jopt, jcfg.seed, grad_accum=jcfg.grad_accum_steps,
        log_grad_norm=jcfg.max_grad_norm > 0))
    jstate = jtrainer.TrainState(step=jnp.int32(0), params=jax_params,
                                 opt_state=jopt.init(jax_params),
                                 model_state={})
    jlosses_, jnorms = [], []
    for b in batches:
        jstate, m = jstep(jstate, tuple(map(jnp.asarray, b)))
        jlosses_.append(float(m["loss"]))
        jnorms.append(float(m.get("grad_norm", 0.0)))

    trainer = ttrainer.Trainer(
        cfg, None, tl.make_forward(TINY, attn_fn=ttp.make_tp_flash_attn_fn(
            None, impl="cuda")),
        _port_params(jax_params), device="cpu")
    result = trainer.fit(tds.ArrayBatches(batches))
    np.testing.assert_allclose(result["epochs"][0]["losses"], jlosses_,
                               rtol=1e-5)
    assert result["final_loss"] == result["epochs"][0]["losses"][-1]
    assert trainer.state.step == 3 and trainer.state.opt_state["count"] == 3
    got = np.concatenate([p.detach().numpy().ravel() for p in
                          ttrainer.tree_leaves(trainer.state.params)])
    want = np.concatenate([w.ravel() for w in _flat(jstate.params)])
    if cfg.adam_moments_dtype == "float32":
        np.testing.assert_allclose(got, want, atol=2e-6, rtol=1e-5)
    else:
        # A bf16 moment whose fp32 value lies within rounding noise of a
        # bf16 rounding boundary is stored one bf16 ulp (2^-8 relative)
        # apart on the two sides; the next update then moves that
        # element up to 2^-8 x lr apart. Such elements are rare; every
        # other element holds the float32 tolerance.
        diff = np.abs(got - want)
        assert (diff > 2e-6 + 1e-5 * np.abs(want)).mean() < 1e-3
        assert diff.max() <= 2 ** -7 * cfg.learning_rate * 3
    if cfg.adam_moments_dtype == "bfloat16":
        assert trainer.state.opt_state["mu"][0].dtype == torch.bfloat16
        assert trainer.state.opt_state["nu"][0].dtype == torch.bfloat16
        for got, want in zip(trainer.state.opt_state["nu"],
                             _flat(jstate.opt_state[0].nu)):
            np.testing.assert_allclose(got.float().numpy(),
                                       want.astype(np.float32),
                                       rtol=1e-2, atol=1e-12)


def test_state_carried_mid_run_continues_like_jax(jax_params, one_device_mesh):
    """Two JAX updates, the state carried across with state_from_numpy,
    then two more updates on each side: same losses and params."""
    kw = dict(epochs=1, steps_per_epoch=4, global_batch_size=4,
              weight_decay=0.1, learning_rate=3e-3, warmup_steps=3,
              max_grad_norm=0.5, grad_accum_steps=2)
    jcfg, cfg = JaxTrainingConfig(**kw), TrainingConfig(**kw)
    batches = _jax_stream_batches(4, 4)
    jfwd = jl.make_forward(JAX_TINY)
    jopt = jtrainer.make_optimizer(jcfg)
    jstep = jax.jit(jtrainer.make_step_fn(jfwd, jopt, 0, grad_accum=2))
    jstate = jtrainer.TrainState(step=jnp.int32(0), params=jax_params,
                                 opt_state=jopt.init(jax_params),
                                 model_state={})
    for b in batches[:2]:
        jstate, _ = jstep(jstate, tuple(map(jnp.asarray, b)))
    host = jax.device_get(jstate)
    carried = ttrainer.state_from_numpy(host.step, host.params,
                                        host.opt_state, cfg, "cpu")
    assert carried.step == 2 and carried.opt_state["count"] == 2
    trainer = ttrainer.Trainer(cfg, None, tl.make_forward(TINY),
                               carried.params, device="cpu")
    trainer.adopt_state(carried)
    result = trainer.fit(tds.ArrayBatches(batches))
    want = []
    for b in batches[2:]:
        jstate, m = jstep(jstate, tuple(map(jnp.asarray, b)))
        want.append(float(m["loss"]))
    np.testing.assert_allclose(result["epochs"][0]["losses"], want, rtol=1e-5)
    for got, w in zip(ttrainer.tree_leaves(trainer.state.params),
                      _flat(jstate.params)):
        np.testing.assert_allclose(got.detach().numpy(), w, atol=2e-6,
                                   rtol=1e-5)


def test_trainer_refuses_what_is_not_ported(monkeypatch, tmp_path):
    params = {"w": torch.zeros(2, 2)}
    fwd = lambda p, ms, b, rng: ((p["w"] ** 2).sum(), ms, {})  # noqa: E731
    # Profiling and anomaly capture are ported
    # (tests/test_torch_profiling.py, test_torch_trace.py): accepted,
    # with the JAX Trainer's refusal of a window of no steps.
    for kw in (dict(profile=True), dict(capture_on_anomaly=True)):
        tr = ttrainer.Trainer(TrainingConfig(**kw), None, fwd, params,
                              device="cpu")
        assert tr.capture is None  # built per fit()
    with pytest.raises(ValueError, match="capture_steps 0 must be >= 1"):
        ttrainer.Trainer(TrainingConfig(capture_on_anomaly=True,
                                        capture_steps=0), None, fwd,
                         params, device="cpu")
    # The comm modes are ported (tests/test_torch_comm_sync.py); a
    # manual one needs a process group's mesh and never trains unsynced.
    with pytest.raises(ValueError, match="never trains unsynced"):
        ttrainer.Trainer(TrainingConfig(comm_mode="hierarchical"), None, fwd,
                         params, device="cpu")
    # A mesh above one device is ported: it must be the DeviceMesh
    # itself (tests/test_torch_distributed.py trains on one).
    with pytest.raises(ValueError, match="mesh of 4 devices must be a "
                       "DeviceMesh"):
        ttrainer.Trainer(TrainingConfig(), {"data": 4}, fwd, params,
                         device="cpu")
    # The guard, a checkpoint manager and a fault plan are ported
    # (tests/test_torch_guard.py, test_torch_ckpt.py): accepted, with the
    # JAX Trainer's refusals of what they cannot do.
    from tpu_hpc_torch.ckpt import CheckpointManager

    mgr = CheckpointManager(str(tmp_path / "ck"))
    for kw in (dict(guard_mode="skip"), dict(guard_mode="rollback")):
        tr = ttrainer.Trainer(TrainingConfig(**kw), None, fwd, params,
                              checkpoint_manager=mgr, device="cpu")
        assert tr.guard_policy.mode == kw["guard_mode"]
    with pytest.raises(ValueError, match="needs a checkpoint_manager"):
        ttrainer.Trainer(TrainingConfig(guard_mode="rollback"), None, fwd,
                         params, device="cpu")
    monkeypatch.setenv("TPU_HPC_FAULTS", "kill_at_step=1")
    tr = ttrainer.Trainer(TrainingConfig(), None, fwd, params, device="cpu")
    assert tr.fault_plan.kill_at_step == 1
    for spec, what in (("stage_kill_at=1:2", "stage fault"),
                       ("slice_down_at_step=2", "slice fault")):
        monkeypatch.setenv("TPU_HPC_FAULTS", spec)
        with pytest.raises(ValueError, match=what):
            ttrainer.Trainer(TrainingConfig(), None, fwd, params,
                             device="cpu")
    monkeypatch.delenv("TPU_HPC_FAULTS")
    with pytest.raises(ValueError, match="divisible"):
        ttrainer.Trainer(TrainingConfig(global_batch_size=5,
                                        grad_accum_steps=2),
                         None, fwd, params, device="cpu")
    trainer = ttrainer.Trainer(TrainingConfig(steps_per_epoch=2), None, fwd,
                               params, device="cpu")
    assert trainer.evaluate(tds.TokenStream(8, 4))["loss"] == 0.0
    assert params["w"].grad is None  # the caller's tensors are untouched


def test_train_cli_on_cpu_and_without_a_card(capsys):
    tiny = ["--dim", "32", "--n-layers", "1", "--n-heads", "2", "--vocab",
            "64", "--multiple-of", "16", "--seq-len", "16", "--steps", "2",
            "--epochs", "1", "--batch", "4", "--grad-accum-steps", "2"]
    assert tmain.main(["--device", "cpu", *tiny]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["device"] == {"type": "cpu", "name": "cpu", "count": 1}
    assert len(out["losses"]) == 2 and all(np.isfinite(out["losses"]))
    assert out["mfu"] is None and out["flash_tile_rows"] is None  # no card
    assert set(out["kernel_launches"].values()) == {0}
    assert tmain.resolve_batch_accum(None, None) == (32, 8)
    assert tmain.bench_model_cfg().ffn_hidden == 2816
    if not torch.cuda.is_available():
        with pytest.raises(SystemExit) as exc:
            tmain.main(tiny)
        assert exc.value.code == 2
        assert "no CUDA device" in capsys.readouterr().err


def test_port_modules_import_no_jax():
    code = (
        "import sys\n"
        "import tpu_hpc_torch.train.trainer, tpu_hpc_torch.train.__main__\n"
        "import tpu_hpc_torch.kernels.attention, tpu_hpc_torch.parallel.tp\n"
        "import tpu_hpc_torch.checks.roofline, tpu_hpc_torch.models.datasets\n"
        "import tpu_hpc_torch.runtime.distributed, tpu_hpc_torch.runtime.mesh\n"
        "import tpu_hpc_torch.runtime.topology, tpu_hpc_torch.runtime.sim\n"
        "import tpu_hpc_torch.parallel.plans, tpu_hpc_torch.parallel.dp\n"
        "import tpu_hpc_torch.parallel.fsdp, tpu_hpc_torch.parallel.hybrid\n"
        "import tpu_hpc_torch.parallel.shard, tpu_hpc_torch.config\n"
        "import tpu_hpc_torch.ckpt, tpu_hpc_torch.resilience.supervisor\n"
        "import tpu_hpc_torch.resilience, tpu_hpc_torch.obs.stall\n"
        "import tpu_hpc_torch.serve.spec, tpu_hpc_torch.serve.prng\n"
        "import tpu_hpc_torch.loadgen, tpu_hpc_torch.serve.server\n"
        "import tpu_hpc_torch.parallel.ring_attention\n"
        "import tpu_hpc_torch.parallel.sp_ulysses\n"
        "import tpu_hpc_torch.parallel.sp_transport\n"
        "import tpu_hpc_torch.parallel.pp, tpu_hpc_torch.parallel.pp_transport\n"
        "import tpu_hpc_torch.models.pipeline_transformer\n"
        "import tpu_hpc_torch.models.llama_pp\n"
        "import tpu_hpc_torch.comm.primitives, tpu_hpc_torch.comm.overlap\n"
        "import tpu_hpc_torch.comm.hierarchical, tpu_hpc_torch.comm.bench\n"
        "import tpu_hpc_torch.comm.planner\n"
        "import chip_smoke\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'tpu_hpc', 'flax', 'optax')]\n"
        "print(bad)\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True, timeout=120)
    assert out.stdout.strip() == "[]"


# ---------------------------------------------------------------------------
# The vision and weather workloads (train/vision.py) and llama-long
# ---------------------------------------------------------------------------

VISION_TINY = {
    "unet": ["--lat", "19", "--lon", "12", "--channels", "3",
             "--base-features", "4", "--batch", "2", "--eval-steps", "1"],
    "vit": ["--lat", "16", "--lon", "32", "--channels", "3", "--dim", "32",
            "--n-layers", "2", "--n-heads", "4", "--batch", "2"],
    "resnet": ["--batch", "4", "--eval-steps", "1"],
    "domain-unet": ["--lat", "16", "--lon", "8", "--base-features", "4",
                    "--batch", "2", "--spatial", "2"],
}


@pytest.mark.parametrize("workload", sorted(VISION_TINY))
def test_vision_workload_trains_on_cpu(workload, capsys):
    """Each workload through the CLI at a tiny size on the CPU: its
    metric in samples/s, finite losses, the unet on a one-rank world's
    {"data": 1} mesh (FSDP2 over data, BatchNorm summed over the group),
    the domain U-Net's bands in process, no kernel launch on the CPU,
    and the evaluation pass on the stored stats where asked."""
    assert tmain.main(["--device", "cpu", "--workload", workload, "--steps",
                       "2", "--epochs", "1", *VISION_TINY[workload]]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["workload"] == workload and out["unit"] == "samples/s"
    assert out["metric"] == {
        "unet": "unet_dp_train_throughput",
        "vit": "vit_train_samples_per_s",
        "resnet": "resnet18_train_samples_per_s",
        "domain-unet": "domain_unet_train_samples_per_s"}[workload]
    assert out["value"] == out["samples_per_s"] > 0
    assert len(out["losses"]) == 2 and all(np.isfinite(out["losses"]))
    assert set(out["kernel_launches"].values()) == {0}
    assert out["mesh"] == ({"data": 1} if workload == "unet" else None)
    assert out["batch_stats"] == (workload != "vit")
    assert out["spatial"] == (2 if workload == "domain-unet" else None)
    if "--eval-steps" in VISION_TINY[workload]:
        assert np.isfinite(out["eval"]["loss"])
    assert not torch.distributed.is_initialized()


def test_unet_workload_is_bench_rows_size():
    """bench.py's unet row (bench_unet): ERA5 181 x 360 x 20, base 64, 8
    samples per data rank, lr 1e-3, bf16 compute over fp32 params --
    read off the built trainer's config without training."""
    from tpu_hpc_torch.train import vision

    args = vision.VisionArgs(workload="unet")
    ds = vision._dataset(args)
    assert ds.sample_shape == (181, 360, 20)
    assert vision.DEFAULT_BATCH["unet"] == 8
    assert vision.LEARNING_RATE == 1e-3
    fwd, _, params, state, cfg = vision.build_model(
        vision.VisionArgs(workload="unet", lat=16, lon=8), ds, "cpu")
    assert cfg.base_features == 64 and cfg.in_channels == 20
    assert cfg.dtype == torch.bfloat16 and cfg.param_dtype == torch.float32
    assert set(state["batch_stats"]) == {"enc1", "enc2", "bottleneck",
                                         "dec2", "dec1"}
    vit_cfg = vision.build_model(vision.VisionArgs(workload="vit"),
                                 vision._dataset(vision.VisionArgs(
                                     workload="vit")), "cpu")[4]
    assert (vit_cfg.lat, vit_cfg.lon, vit_cfg.patch_size, vit_cfg.embed_dim,
            vit_cfg.depth, vit_cfg.n_heads, vit_cfg.head_dim) == (
        64, 128, 4, 256, 6, 8, 32)


def test_vision_trainer_carries_and_evaluates_batch_stats():
    """model_state carries the BatchNorm running stats from update to
    update, and the evaluation pass normalises with the stored stats
    (its loss is the eval forward's on them, not a training forward's)."""
    from tpu_hpc_torch.train import vision

    trainer, ds = vision.build_vision_trainer(
        vision.VisionArgs(workload="resnet", batch=4), steps=2, epochs=1,
        device="cpu")
    before = trainer.state.model_state["batch_stats"]["bn1"]["mean"].clone()
    trainer.fit(ds)
    after = trainer.state.model_state["batch_stats"]["bn1"]["mean"]
    assert not torch.equal(before, after)
    got = trainer.evaluate(ds, 1)["loss"]
    batch = ds.batch_at(0, 4)
    want, _ = trainer.eval_forward(trainer.state.params,
                                   trainer.state.model_state, batch)
    train_loss, _, _ = trainer.forward(trainer.state.params,
                                       trainer.state.model_state, batch,
                                       None)
    assert got == pytest.approx(float(want.detach()), rel=1e-6)
    assert float(train_loss.detach()) != pytest.approx(got, rel=1e-6)


@pytest.mark.parametrize("argv, words", [
    (["--workload", "unet", "--comm-mode", "bucketed_overlap"],
     "--comm-mode is only consumed by the llama workloads"),
    (["--workload", "vit", "--pp-schedule", "1f1b"],
     "--pp-* is only consumed by the llama workloads"),
    (["--workload", "resnet", "--sp-mode", "ring"],
     "--sp-mode is only consumed by the llama workloads"),
    (["--workload", "resnet", "--model", "2"],
     "the resnet workload has no tensor parallel plan"),
    (["--workload", "vit", "--model", "2"],
     "does not cover the 1 processes"),
    (["--workload", "domain-unet", "--lat", "30", "--spatial", "4"],
     "lat(30) % (spatial*4) == 0 is needed"),
    (["--workload", "unet", "--spatial", "2"],
     "--spatial needs --workload domain-unet"),
    (["--workload", "resnet", "--lat", "16"],
     "size the grids and U-Nets, not --workload resnet"),
    (["--workload", "unet", "--dim", "64"], "size the ViT"),
    (["--workload", "llama", "--lat", "16"],
     "--lat sizes the vision workloads"),
    (["--workload", "llama-long", "--sp-mode", "ring"],
     "--pp-* and --sp-mode belong to --workload llama"),
    (["--workload", "unet", "--checkpoint-dir", "x"],
     "wired for the llama workloads only"),
])
def test_vision_refusals(argv, words, capsys):
    with pytest.raises(SystemExit) as exc:
        tmain.main(["--device", "cpu", *argv])
    assert exc.value.code == 2
    assert words in capsys.readouterr().err


def test_llama_long_workload(capsys):
    """bench.py's llama-long row: microbatch 1 accumulated 8 times (a
    batch of 8) at seq 8192 by default, and its own metric name (here at
    a tiny size and sequence)."""
    assert tmain.resolve_batch_accum(None, None, microbatch=1) == (8, 8)
    tiny = ["--dim", "32", "--n-layers", "1", "--n-heads", "2", "--vocab",
            "64", "--multiple-of", "16", "--seq-len", "16", "--steps", "1",
            "--epochs", "1", "--grad-accum-steps", "2"]
    assert tmain.main(["--device", "cpu", "--workload", "llama-long",
                       *tiny]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["metric"] == "llama2_seq16_tokens_per_s_per_chip"
    assert out["global_batch"] == 2 and out["grad_accum_steps"] == 2
    assert out["seq_len"] == 16 and np.isfinite(out["final_loss"])


def test_vision_modules_import_no_jax():
    code = (
        "import sys\n"
        "import tpu_hpc_torch.train.vision, tpu_hpc_torch.models.unet\n"
        "import tpu_hpc_torch.models.resnet, tpu_hpc_torch.models.vit\n"
        "import tpu_hpc_torch.parallel.domain\n"
        "import tpu_hpc_torch.parallel.domain_unet\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'tpu_hpc', 'flax', 'optax')]\n"
        "print(bad)\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True, timeout=120)
    assert out.stdout.strip() == "[]"


def test_batch_stats_ride_the_checkpoint(tmp_path):
    """The BatchNorm running stats are model_state: a checkpoint carries
    them, and a fresh trainer resumed from it holds the saved stats bit
    for bit (not its own init's), then trains on from them."""
    from tpu_hpc_torch.ckpt import CheckpointManager
    from tpu_hpc_torch.train import vision

    ck = str(tmp_path / "ck")

    def trainer():
        args = vision.VisionArgs(workload="resnet", batch=2)
        ds = vision._dataset(args)
        fwd, eval_fwd, params, state, _ = vision.build_model(args, ds, "cpu")
        cfg = TrainingConfig(global_batch_size=2, steps_per_epoch=2,
                             epochs=1, save_every=1, checkpoint_dir=ck)
        return ttrainer.Trainer(cfg, None, fwd, params, state,
                                eval_forward=eval_fwd,
                                checkpoint_manager=CheckpointManager(ck),
                                device="cpu"), ds

    first, ds = trainer()
    first.fit(ds)
    saved = first.state.model_state["batch_stats"]
    second, _ = trainer()
    assert not torch.equal(second.state.model_state["batch_stats"]["bn1"]
                           ["var"], saved["bn1"]["var"])
    assert second.maybe_resume() == 2
    got = second.state.model_state["batch_stats"]
    for block, stats in (("bn1", None), ("stage4_block1", "bn2")):
        a = got[block] if stats is None else got[block][stats]
        b = saved[block] if stats is None else saved[block][stats]
        assert torch.equal(a["mean"], b["mean"])
        assert torch.equal(a["var"], b["var"])
