"""The port's distributed main path on a 2 x 2 (data, model) gloo world
on CPU, against the one-device port and the JAX hybrid Trainer.

One world of four processes serves the whole file: the module fixture
launches this file as a script four times, with torchrun's variables
(RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR, MASTER_PORT). Each process
trains every case for three updates from the JAX init's params and the
JAX TokenStream's batches, laid out by ``hybrid_pspecs(llama_rules,
data_size=2, min_size=1000)`` (FSDP2 over ``data``, DTensor TP over
``model``, SP on the residual stream or not, the flash kernels' plain
versions under ``local_map`` on local heads); then it runs the train
CLI on the same world. Rank 0 writes what it gathered.

The JAX side is tests/test_llama_tp.py::test_hybrid_training_step's:
the Trainer on a 2 x 2 sub-mesh of the 8 simulated devices with the
same plan and ``sp_constrain``. Float32 throughout; the tolerances are
tests/test_torch_train.py's (summation order only): losses rtol 1e-5,
gathered gradients atol 1e-6 / rtol 1e-4, params atol 2e-6 / rtol 1e-5.
The training cases are that file's ``adamw_warmup_clip_accum2`` with
the clip off, or small enough to fire on every update (that case also
checkpoints each block, ``remat``, on both sides).
"""
import contextlib
import io
import json
import os
import pickle
import sys

import numpy as np
import pytest
import torch

WORLD, SEQ, BATCH, UPDATES = 4, 16, 4, 3
MODEL = dict(dim=64, n_layers=2, n_heads=4, vocab_size=128, multiple_of=16,
             max_seq_len=SEQ)
TRAIN = dict(epochs=1, steps_per_epoch=UPDATES, global_batch_size=BATCH,
             seed=0, weight_decay=0.1, learning_rate=3e-3, warmup_steps=2,
             grad_accum_steps=2)
CASES = {
    "mha_sp": dict(kv=None, sp=True, clip=0.0, remat=False),
    "gqa_tp2_sp": dict(kv=2, sp=True, clip=0.0, remat=False),
    "mha_sp_clip_remat": dict(kv=None, sp=True, clip=0.05, remat=True),
    "gqa_tp2_no_sp": dict(kv=2, sp=False, clip=0.0, remat=False),
}
CLI = ["--device", "cpu", "--data", "2", "--model", "2", "--dim", "64",
       "--n-layers", "2", "--n-heads", "4", "--vocab", "128",
       "--multiple-of", "16", "--seq-len", "16", "--steps", "2",
       "--epochs", "1", "--batch", "4", "--grad-accum-steps", "2"]
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class Recorder:
    """The configured optimizer, keeping this rank's first-update
    gradient shards (the mean over microbatches, before any optimizer
    math) and every update's clip norm."""

    def __init__(self, inner):
        self.inner, self.grads, self.norms = inner, None, []
        self.max_grad_norm = inner.max_grad_norm

    def init(self, params):
        return self.inner.init(params)

    def apply(self, params, grads, state, norm=None):
        from tpu_hpc_torch.train.trainer import global_norm

        if self.grads is None:
            self.grads = [g.detach().clone() for g in grads]
        if self.max_grad_norm > 0:
            # one device: the optimizer takes the norm itself
            self.norms.append(float(norm if norm is not None
                                    else global_norm(grads)))
        return self.inner.apply(params, grads, state, norm)


def _train_cfg(clip):
    from tpu_hpc_torch.config import TrainingConfig

    return TrainingConfig(**TRAIN), TrainingConfig(**TRAIN,
                                                   max_grad_norm=clip)


def _model_cfg(case):
    from tpu_hpc_torch.models import llama2

    return llama2.LlamaConfig(**MODEL, n_kv_heads=case["kv"],
                              remat=case["remat"], dtype=torch.float32)


def _world_main(workdir):
    """One rank of the world (run as a script)."""
    from torch.distributed.tensor import DTensor

    from tpu_hpc_torch.models import datasets, llama2
    from tpu_hpc_torch.parallel import hybrid, tp
    from tpu_hpc_torch.runtime import (
        MeshSpec,
        build_mesh,
        cleanup_distributed,
        init_distributed,
    )
    from tpu_hpc_torch.train import __main__ as tmain
    from tpu_hpc_torch.train.trainer import Trainer, make_optimizer, tree_paths

    torch.set_num_threads(1)
    with open(os.path.join(workdir, "inputs.pkl"), "rb") as f:
        inputs = pickle.load(f)
    info = init_distributed(device="cpu", verbose=False)
    mesh = build_mesh(MeshSpec(axes={"data": 2, "model": 2}), "cpu")
    out = {}
    for name, case in CASES.items():
        params, batches = inputs[name]
        cfg, opt_cfg = _train_cfg(case["clip"])
        opt = Recorder(make_optimizer(opt_cfg))
        constrain = tp.sp_constrain(mesh) if case["sp"] else (lambda x: x)
        fwd = llama2.make_forward(_model_cfg(case), constrain,
                                  tp.make_tp_flash_attn_fn(mesh, impl="cuda"))
        specs = hybrid.hybrid_pspecs(params, tp.llama_rules(), data_size=2,
                                     min_size=1000)
        trainer = Trainer(cfg, mesh, fwd, params, param_pspecs=specs,
                          optimizer=opt)
        result = trainer.fit(datasets.ArrayBatches(batches))
        leaves, paths = [], tree_paths(trainer.state.params)
        for path in paths:
            node = trainer.state.params
            for key in path:
                node = node[key]
            leaves.append(node)
        grads = [DTensor.from_local(g, p.device_mesh, p.placements,
                                    shape=p.shape, stride=p.stride())
                 .full_tensor().numpy() for g, p in zip(opt.grads, leaves)]
        out[name] = {
            "losses": result["epochs"][0]["losses"],
            "grads": dict(zip(("/".join(p) for p in paths), grads)),
            "params": trainer.gather_params(),
            "norms": opt.norms,
            "placements": {"/".join(p): str(tuple(leaf.placements))
                           for p, leaf in zip(paths, leaves)},
        }
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        tmain.main(CLI)  # leaves the process group at its end
    out["cli"] = buf.getvalue()
    if info.process_id == 0:
        with open(os.path.join(workdir, "results.pkl"), "wb") as f:
            pickle.dump(out, f)
    cleanup_distributed()


@pytest.fixture(scope="module")
def jax_inputs():
    """Per case: the JAX init's params and the JAX TokenStream's
    batches, as numpy, plus the JAX model config."""
    jax = pytest.importorskip("jax", reason="the JAX reference package")
    from tpu_hpc.models import datasets as jds
    from tpu_hpc.models import llama2 as jl

    ds = jds.TokenStream(vocab_size=MODEL["vocab_size"], seq_len=SEQ)
    batches = [tuple(np.asarray(a) for a in ds.batch_at(i, BATCH))
               for i in range(UPDATES)]
    inits = {}
    for kv in {case["kv"] for case in CASES.values()}:
        jcfg = jl.LlamaConfig(**MODEL, n_kv_heads=kv, dtype=jax.numpy.float32)
        inits[kv] = jax.device_get(jl.init_llama(jax.random.key(0), jcfg))
    return {name: (inits[case["kv"]], batches, jl.LlamaConfig(
                **MODEL, n_kv_heads=case["kv"], remat=case["remat"],
                dtype=jax.numpy.float32))
            for name, case in CASES.items()}


def _launch_world(jax_inputs, workdir):
    """Start the 2 x 2 gloo world on the cases' inputs."""
    from tpu_hpc_torch.runtime.sim import launch_local_world

    with open(os.path.join(workdir, "inputs.pkl"), "wb") as f:
        pickle.dump({k: v[:2] for k, v in jax_inputs.items()}, f)
    return launch_local_world(
        [sys.executable, os.path.abspath(__file__), workdir], WORLD,
        env=dict(os.environ, PYTHONPATH=REPO), cwd=REPO)


def _collect_world(procs, workdir):
    """Wait for the world and read rank 0's results."""
    from tpu_hpc_torch.runtime.sim import wait_world

    logs = wait_world(procs)
    assert all(rc == 0 for rc, _, _ in logs), [err for _, _, err in logs]
    with open(os.path.join(workdir, "results.pkl"), "rb") as f:
        return pickle.load(f)


@pytest.fixture(scope="module")
def runs(jax_inputs, tmp_path_factory):
    """The world's, the one-device port's and the JAX hybrid Trainer's
    results; the world runs while this process computes the other
    two."""
    workdir = str(tmp_path_factory.mktemp("world"))
    procs = _launch_world(jax_inputs, workdir)
    try:
        one, jax_ = _one_device(jax_inputs), _jax_hybrid(jax_inputs)
    finally:
        world = _collect_world(procs, workdir)
    return world, one, jax_


@pytest.fixture(scope="module")
def world(runs):
    return runs[0]


@pytest.fixture(scope="module")
def one_device(runs):
    return runs[1]


@pytest.fixture(scope="module")
def jax_hybrid(runs):
    return runs[2]


def _one_device(jax_inputs):
    """The one-device port on the same params and batches."""
    from tpu_hpc_torch.models import datasets, llama2
    from tpu_hpc_torch.parallel import tp
    from tpu_hpc_torch.train.trainer import Trainer, make_optimizer, tree_map

    out = {}
    for name, case in CASES.items():
        params, batches, _ = jax_inputs[name]
        cfg, opt_cfg = _train_cfg(case["clip"])
        opt = Recorder(make_optimizer(opt_cfg))
        trainer = Trainer(
            cfg, None, llama2.make_forward(
                _model_cfg(case),
                attn_fn=tp.make_tp_flash_attn_fn(None, impl="cuda")),
            tree_map(torch.from_numpy, params), optimizer=opt,
            device="cpu")
        result = trainer.fit(datasets.ArrayBatches(batches))
        out[name] = {"losses": result["epochs"][0]["losses"],
                     "grads": opt.grads, "norms": opt.norms,
                     "params": tree_map(lambda t: t.detach().numpy(),
                                        trainer.state.params)}
    return out


def _jax_hybrid(jax_inputs):
    """The JAX Trainer on a 2 x 2 sub-mesh, hybrid plan, per case."""
    import jax

    from jax.sharding import Mesh, PartitionSpec

    from tpu_hpc.config import TrainingConfig as JCfg
    from tpu_hpc.models import llama2 as jl
    from tpu_hpc.parallel import hybrid as jhybrid
    from tpu_hpc.parallel import tp as jtp
    from tpu_hpc.train import Trainer as JTrainer

    mesh = Mesh(np.array(jax.devices()[:4]).reshape(2, 2), ("data", "model"))
    out, grads = {}, {}
    for name, case in CASES.items():
        params, batches, jcfg = jax_inputs[name]
        params = jax.tree.map(jax.numpy.asarray, params)
        constrain = (jtp.sp_constrain(mesh) if case["sp"]
                     else (lambda x: x))
        trainer = JTrainer(
            JCfg(**TRAIN, max_grad_norm=case["clip"]), mesh,
            jl.make_forward(jcfg, constrain, jtp.make_tp_flash_attn_fn(
                mesh, "data", "model", impl="xla")),
            params,
            param_pspecs=jhybrid.hybrid_pspecs(
                params, jtp.llama_rules(), data_size=2, min_size=1000),
            batch_pspec=PartitionSpec("data"))
        if case["kv"] not in grads:
            grads[case["kv"]] = _jax_first_grads(jcfg, params, batches[0])
        losses, norms = [], []
        for b in batches:
            m = trainer.train_step(tuple(map(jax.numpy.asarray, b)))
            losses.append(float(m["loss"]))
            if "grad_norm" in m:
                norms.append(float(m["grad_norm"]))
        out[name] = {"losses": losses, "norms": norms,
                     "grads": grads[case["kv"]],
                     "params": jax.device_get(trainer.state.params)}
    return out


def _jax_first_grads(jcfg, params, batch):
    """The first update's gradient on the JAX side: the mean over the
    microbatches of jax.grad of the JAX forward (one device, einsum
    attention; SP and remat move no value)."""
    import dataclasses

    import jax

    from tpu_hpc.models import llama2 as jl

    fwd = jl.make_forward(dataclasses.replace(jcfg, remat=False))
    accum = TRAIN["grad_accum_steps"]
    micro = BATCH // accum

    def mean_loss(p, b):
        return sum(fwd(p, {}, tuple(a[i * micro:(i + 1) * micro] for a in b),
                       jax.random.key(0))[0] for i in range(accum)) / accum

    return jax.device_get(jax.jit(jax.grad(mean_loss))(
        params, tuple(map(jax.numpy.asarray, batch))))


def _leaves(tree, prefix=""):
    for key in sorted(tree):
        node, path = tree[key], f"{prefix}/{key}" if prefix else key
        if isinstance(node, dict):
            yield from _leaves(node, path)
        else:
            yield path, np.asarray(node)


@pytest.mark.parametrize("name", list(CASES))
def test_losses_match_one_device_and_jax(world, one_device, jax_hybrid,
                                         name):
    got = world[name]["losses"]
    assert len(got) == UPDATES and all(np.isfinite(got))
    np.testing.assert_allclose(got, one_device[name]["losses"], rtol=1e-5)
    np.testing.assert_allclose(got, jax_hybrid[name]["losses"], rtol=1e-5)


@pytest.mark.parametrize("name", list(CASES))
def test_gathered_gradients_match_one_device_and_jax(world, one_device,
                                                     jax_hybrid, name):
    """The first update's gradient, summed over model by the blocks'
    region collectives and reduce-scattered over data by FSDP2,
    gathered whole: every leaf equals the one-device port's and the JAX
    forward's (jax.grad, mean over the microbatches)."""
    got = world[name]["grads"]
    want = one_device[name]["grads"]
    jax_grads = dict(_leaves(jax_hybrid[name]["grads"]))
    assert len(got) == len(want) and got.keys() == jax_grads.keys()
    for (path, g), w in zip(sorted(got.items()), want):
        np.testing.assert_allclose(g, w.numpy(), atol=1e-6, rtol=1e-4,
                                   err_msg=path)
        np.testing.assert_allclose(g, jax_grads[path], atol=1e-6,
                                   rtol=1e-4, err_msg=path)


@pytest.mark.parametrize("name", list(CASES))
def test_params_after_three_updates_match(world, one_device, jax_hybrid,
                                          name):
    got = dict(_leaves(world[name]["params"]))
    for ref in (one_device[name]["params"], jax_hybrid[name]["params"]):
        want = dict(_leaves(ref))
        assert got.keys() == want.keys()
        for path, w in want.items():
            np.testing.assert_allclose(got[path], w, atol=2e-6, rtol=1e-5,
                                       err_msg=path)


def test_clipping_fires_on_the_whole_gradient(world, one_device, jax_hybrid):
    """With max_grad_norm below the norm every update clips, and the
    norm each rank clips by is the whole gradient's: the JAX Trainer's
    grad_norm metric and the one-device port's norm."""
    case = CASES["mha_sp_clip_remat"]
    want = jax_hybrid["mha_sp_clip_remat"]["norms"]
    assert len(want) == UPDATES and min(want) > case["clip"]
    got = world["mha_sp_clip_remat"]["norms"]
    np.testing.assert_allclose(got, want, rtol=1e-5)
    np.testing.assert_allclose(got, one_device["mha_sp_clip_remat"]["norms"],
                               rtol=1e-5)
    assert world["mha_sp"]["norms"] == []  # no clip, no norm taken


def test_params_lie_as_the_plan_names(world):
    """TP then FSDP2: (data placement, model placement) per leaf. Where
    the plan names a data dim FSDP2 shards that dim; a leaf the plan
    keeps whole on data (under min_size) is still sharded by FSDP2, on
    dim 0 -- FSDP2 shards every param of a unit."""
    got = world["gqa_tp2_sp"]["placements"]
    assert got["layers_0/attention/wq/kernel"] == \
        "(Shard(dim=0), Shard(dim=1))"       # P("data", "model")
    assert got["layers_0/attention/wo/kernel"] == \
        "(Shard(dim=1), Shard(dim=0))"       # P("model", "data")
    assert got["tok_embeddings/embedding"] == \
        "(Shard(dim=1), Shard(dim=0))"       # P("model", "data")
    assert got["output/kernel"] == "(Shard(dim=0), Shard(dim=1))"
    assert got["norm/scale"] == "(Shard(dim=0), Replicate())"  # P()


def test_train_cli_on_the_2x2_world(world):
    """``python -m tpu_hpc_torch.train --data 2 --model 2`` under the
    world's launcher variables: the hybrid plan over the (data, model)
    mesh, one JSON line on rank 0, per-device tokens/s."""
    lines = [ln for ln in world["cli"].splitlines() if ln.startswith("{")]
    assert len(lines) == 1
    out = json.loads(lines[0])
    assert out["mesh"] == {"data": 2, "model": 2}
    assert out["world_size"] == 4 and out["plan"] == "hybrid"
    assert out["device"]["count"] == 4 and out["global_batch"] == 8
    assert out["layout"]["fsdp_units"] == 3  # two blocks and the root
    assert len(out["losses"]) == 2 and all(np.isfinite(out["losses"]))
    assert out["tokens_per_s_per_device"] == pytest.approx(
        out["tokens_per_s"] / 4)
    assert out["mfu"] is None  # no card, no peak


if __name__ == "__main__":
    _world_main(sys.argv[1])
