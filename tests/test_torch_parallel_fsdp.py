"""Data-only FSDP: a 4 x 1 gloo world on CPU against the one-device port.

The port's counterpart of tests/test_train_dp.py::
test_fsdp_training_matches_dp: FSDP must be numerically DP -- the same
loss trajectory and params, laid out differently (the ZeRO invariant).
One world of four processes serves the file (this file run as a script
under torchrun's variables, ``runtime.sim.launch_local_world``); each
case trains three updates of a tiny float32 Llama from the same seeded
params and batches, with params laid out by ``fsdp.param_pspecs`` over
``data`` (FSDP2, no TP: the activations stay plain tensors and the flash
closure is the bare one). Tolerances are tests/test_torch_train.py's:
losses rtol 1e-5, params atol 2e-6 / rtol 1e-5.
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

WORLD, SEQ, BATCH, UPDATES = 4, 16, 8, 3
MODEL = dict(dim=64, n_layers=2, n_heads=4, n_kv_heads=2, vocab_size=128,
             multiple_of=16, max_seq_len=SEQ)
CASES = {
    # tests/test_torch_train.py's TRAIN_CASES, at a batch of 8.
    "adamw_warmup_clip_accum2": dict(
        weight_decay=0.1, learning_rate=3e-3, warmup_steps=2,
        max_grad_norm=0.5, grad_accum_steps=2, min_size=1000),
    "sgd_momentum_clip": dict(learning_rate=0.05, momentum=0.9,
                              max_grad_norm=1.0, min_size=200),
}
CLI = ["--device", "cpu", "--model", "1", "--dim", "64", "--n-layers", "1", "--n-heads",
       "4", "--vocab", "128", "--multiple-of", "16", "--seq-len", "16",
       "--steps", "2", "--epochs", "1", "--batch", "2",
       "--grad-accum-steps", "2"]
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _setup(name):
    """The case's (TrainingConfig, model config, params, batches),
    from seeds: the same on every rank and in this process."""
    from tpu_hpc_torch.config import TrainingConfig
    from tpu_hpc_torch.models import datasets, llama2

    kw = {k: v for k, v in CASES[name].items() if k != "min_size"}
    cfg = TrainingConfig(epochs=1, steps_per_epoch=UPDATES,
                         global_batch_size=BATCH, seed=0, **kw)
    mcfg = llama2.LlamaConfig(**MODEL, dtype=torch.float32)
    params = llama2.init_llama(torch.Generator().manual_seed(0), mcfg, "cpu")
    ds = datasets.TokenStream(vocab_size=MODEL["vocab_size"], seq_len=SEQ,
                              seed=0)
    return cfg, mcfg, params, ds


def _run(name, mesh):
    """Three updates (and an evaluation) of case ``name``: one device
    when ``mesh`` is None, else FSDP over its data axis."""
    from tpu_hpc_torch.models import llama2
    from tpu_hpc_torch.parallel import fsdp, tp
    from tpu_hpc_torch.parallel.shard import layout_summary
    from tpu_hpc_torch.train.trainer import Trainer, tree_map

    cfg, mcfg, params, ds = _setup(name)
    specs = None
    if mesh is not None:
        specs = fsdp.param_pspecs(params, axis_size=WORLD,
                                  min_size=CASES[name]["min_size"])
    attn = tp.make_tp_flash_attn_fn(mesh, "data", None, impl="cuda")
    trainer = Trainer(cfg, mesh, llama2.make_forward(mcfg, attn_fn=attn),
                      params, param_pspecs=specs, device="cpu")
    result = trainer.fit(ds)
    out = {"losses": result["epochs"][0]["losses"],
           "eval": trainer.evaluate(ds, 2)["loss"]}
    if mesh is None:
        out["params"] = tree_map(lambda t: t.detach().numpy(),
                                 trainer.state.params)
    else:
        out["params"] = trainer.gather_params()
        out["layout"] = layout_summary(trainer.module)
        out["specs"] = specs
    return out


def _world_main(workdir):
    """One rank of the world (run as a script)."""
    from tpu_hpc_torch.runtime import (
        MeshSpec,
        build_mesh,
        cleanup_distributed,
        init_distributed,
    )
    from tpu_hpc_torch.train import __main__ as tmain

    torch.set_num_threads(1)
    info = init_distributed(device="cpu", verbose=False)
    mesh = build_mesh(MeshSpec(axes={"data": -1}), "cpu")
    out = {name: _run(name, mesh) for name in CASES}
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        tmain.main(CLI)  # leaves the process group at its end
    out["cli"] = buf.getvalue()
    if info.process_id == 0:
        with open(os.path.join(workdir, "results.pkl"), "wb") as f:
            pickle.dump(out, f)
    cleanup_distributed()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(the 4 x 1 world's results, the one-device port's)."""
    from tpu_hpc_torch.runtime.sim import launch_local_world, wait_world

    workdir = str(tmp_path_factory.mktemp("fsdp_world"))
    procs = launch_local_world(
        [sys.executable, os.path.abspath(__file__), workdir], WORLD,
        env=dict(os.environ, PYTHONPATH=REPO), cwd=REPO)
    try:
        one = {name: _run(name, None) for name in CASES}
    finally:
        logs = wait_world(procs)
    assert all(rc == 0 for rc, _, _ in logs), [err for _, _, err in logs]
    with open(os.path.join(workdir, "results.pkl"), "rb") as f:
        return pickle.load(f), one


def _leaves(tree, prefix=""):
    for key in sorted(tree):
        node, path = tree[key], f"{prefix}/{key}" if prefix else key
        if isinstance(node, dict):
            yield from _leaves(node, path)
        else:
            yield path, np.asarray(node)


@pytest.mark.parametrize("name", list(CASES))
def test_fsdp_training_matches_one_device(runs, name):
    world, one = runs
    got, want = world[name], one[name]
    assert all(np.isfinite(got["losses"]))
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=1e-5)
    np.testing.assert_allclose(got["eval"], want["eval"], rtol=1e-5)
    want_p = dict(_leaves(want["params"]))
    got_p = dict(_leaves(got["params"]))
    assert got_p.keys() == want_p.keys()
    for path, w in want_p.items():
        np.testing.assert_allclose(got_p[path], w, atol=2e-6, rtol=1e-5,
                                   err_msg=path)


@pytest.mark.parametrize("name", list(CASES))
def test_large_params_are_sharded_on_the_planned_dim(runs, name):
    """FSDP2 shards each param over data on the dim the plan names
    (``shard_placement_fn``), and the small ones the plan keeps whole
    on dim 0 (FSDP2 shards every param of a unit); one unit per block
    and the root; no DTensor TP (plain activations)."""
    world, _ = runs
    layout, specs = world[name]["layout"], world[name]["specs"]
    assert layout["fsdp_units"] == MODEL["n_layers"] + 1
    planned = [next((f"(Shard(dim={d}),)" for d, e in enumerate(s)
                     if e == "data"), "(Shard(dim=0),)")
               for _, s in _leaves(specs)]
    want = {}
    for key in planned:
        want[key] = want.get(key, 0) + 1
    assert layout["params"] == want
    sharded = sum(1 for _, s in _leaves(specs) if "data" in tuple(s))
    assert sharded >= 7


def test_train_cli_plans_fsdp_on_a_data_only_world(runs):
    """4 processes and no --data/--model: tp.auto_mesh_axes gives TP 4
    for 4 heads; --model 1 keeps the world on data and the plan on
    FSDP."""
    world, _ = runs
    lines = [ln for ln in world["cli"].splitlines() if ln.startswith("{")]
    out = json.loads(lines[-1])
    assert out["mesh"] == {"data": 4, "model": 1}
    assert out["plan"] == "fsdp" and out["world_size"] == 4
    assert out["global_batch"] == 8
    assert all(np.isfinite(out["losses"]))


if __name__ == "__main__":
    _world_main(sys.argv[1])
