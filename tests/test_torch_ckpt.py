"""The port's checkpoints (tpu_hpc_torch/ckpt over
torch.distributed.checkpoint) against the JAX package's contract.

The crc32 of a leaf equals ``tpu_hpc.ckpt.integrity.leaf_checksum`` of
the same array, exactly (fp32 and bf16). The rest holds the port's
manager to what tests/test_ckpt.py and tests/test_guard.py hold the
Orbax one to: round trip, auto-resume, a mid-epoch resume bit-identical
to the uninterrupted run, a bit flip caught by the checksums and
quarantined, a torn write not re-probed, SIGTERM to a snapshot and
EXIT_RESUMABLE, fp32 moments restored into bf16 ones, and -- in one
4-process gloo world (this file run as a script under torchrun's
variables) -- a save under the 2 x 2 hybrid layout restored under 4 x 1
FSDP, bit for bit, and a bit flipped in a sharded leaf caught by the
per-rank shard checksums on the mesh it was saved on.
"""
import json
import os
import pickle
import sys

import numpy as np
import pytest
import torch

from tpu_hpc_torch import obs
from tpu_hpc_torch.ckpt import (
    CheckpointManager,
    TopologyMismatchError,
    integrity,
)
from tpu_hpc_torch.ckpt.checkpoint import state_dict
from tpu_hpc_torch.config import TrainingConfig
from tpu_hpc_torch.models import datasets, llama2
from tpu_hpc_torch.parallel import tp
from tpu_hpc_torch.resilience import EXIT_RESUMABLE, exit_code_for
from tpu_hpc_torch.train.trainer import Trainer

WORLD, SEQ = 4, 16
MODEL = dict(dim=64, n_layers=2, n_heads=4, vocab_size=128, multiple_of=16,
             max_seq_len=SEQ)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture()
def fresh_bus():
    prev = obs.set_bus(obs.EventBus(path="", flight_dir=""))
    yield obs.get_bus()
    obs.set_bus(prev)


def _trainer(ckpt_dir, epochs=2, steps=2, metrics="", seed=0, **cfg_kw):
    mcfg = llama2.LlamaConfig(**MODEL, dtype=torch.float32)
    cfg = TrainingConfig(epochs=epochs, steps_per_epoch=steps,
                         global_batch_size=4, grad_accum_steps=2, seed=0,
                         weight_decay=0.1, learning_rate=3e-3, save_every=1,
                         checkpoint_dir=ckpt_dir, metrics_path=metrics,
                         **cfg_kw)
    params = llama2.init_llama(torch.Generator().manual_seed(seed), mcfg,
                               "cpu")
    mgr = CheckpointManager(ckpt_dir)
    attn = tp.make_tp_flash_attn_fn(None, "data", None)
    return Trainer(cfg, None, llama2.make_forward(mcfg, attn_fn=attn),
                   params, checkpoint_manager=mgr, device="cpu")


def _ds():
    return datasets.TokenStream(vocab_size=MODEL["vocab_size"], seq_len=SEQ,
                                seed=0)


def _tensors(state):
    return {k: v.detach().clone() for k, v in state_dict(state).items()}


def _assert_same(a, b):
    assert a.keys() == b.keys()
    for k in a:
        assert torch.equal(a[k], b[k]), k


def _events(path, kind):
    with open(path) as f:
        return [r for r in map(json.loads, f) if r["event"] == kind]


# ---------------------------------------------------------------------
# Checksums: the JAX package's, exactly
# ---------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int32"])
def test_leaf_checksum_equals_jax(dtype):
    jnp = pytest.importorskip("jax").numpy
    from tpu_hpc.ckpt import integrity as jintegrity

    x = np.random.default_rng(3).standard_normal((37, 19)).astype(np.float32)
    if dtype == "int32":
        x = (x * 1000).astype(np.int32)
    t = torch.from_numpy(x).to(getattr(torch, dtype))
    j = jnp.asarray(x).astype(getattr(jnp, dtype))
    assert integrity.leaf_checksum(t) == jintegrity.leaf_checksum(j)
    sums = integrity.leaf_checksums({"a": t})
    assert integrity.verify_tree({"a": t}, sums) == []
    flipped = t.clone()
    flipped.view(-1)[7] = flipped.view(-1)[7] + 1
    assert integrity.verify_tree({"a": flipped}, sums) == ["a"]
    # A leaf restored into another dtype is a legal cast, not corruption.
    assert integrity.verify_tree({"a": t.double()}, sums) == []


# ---------------------------------------------------------------------
# Round trip, resume, mid-epoch
# ---------------------------------------------------------------------

@pytest.mark.parametrize("how", ["save", "save_now"])
def test_save_restore_roundtrip(tmp_path, how):
    tr = _trainer(str(tmp_path / "ck"), epochs=1)
    mgr = tr.checkpoint_manager
    if how == "save":  # the epoch-end save: asynchronous
        tr.fit(_ds())
    else:
        for i in range(2):
            tr.train_step(_ds().batch_at(i, 4))
        mgr.save_now(tr.state)
    assert mgr.all_steps() == [2]
    meta = mgr.read_sidecar(2)
    assert meta["step"] == 2 and "mesh" not in meta
    assert set(meta["checksums"]) == set(state_dict(tr.state))
    restored = mgr.restore_latest(tr.state)
    assert restored.step == 2
    _assert_same(_tensors(restored), _tensors(tr.state))
    assert mgr.restore(2, tr.state).step == 2


def test_auto_resume_continues_from_step_and_keeps_max(tmp_path):
    ck = str(tmp_path / "ck")
    tr1 = _trainer(ck, epochs=2)
    tr1.fit(_ds())
    tr2 = _trainer(ck, epochs=4)
    r2 = tr2.fit(_ds())
    assert tr2.state.step == 8 and r2["resumed_from_step"] == 4
    assert len(r2["epochs"]) == 2  # epochs 0 and 1 were not re-run
    assert tr2.checkpoint_manager.all_steps() == [4, 6, 8]  # max_to_keep 3
    assert sorted(os.listdir(os.path.join(ck, ".tpu_hpc_meta"))) == [
        "4.json", "6.json", "8.json"]
    assert os.path.exists(os.path.join(ck, "config.yaml"))


def test_mid_epoch_resume_is_bit_identical(tmp_path):
    """A checkpoint landing mid-epoch: the resumed run replays neither
    a batch nor an RNG draw, so it ends where the uninterrupted one
    does, bit for bit (tests/test_ckpt.py's stream alignment)."""
    full = _trainer(str(tmp_path / "full"), epochs=2, steps=3)
    full.fit(_ds())
    ck = str(tmp_path / "cut")
    cut = _trainer(ck, epochs=2, steps=3)
    for i in range(2):
        cut.train_step(_ds().batch_at(i, 4))
    cut.checkpoint_manager.save_now(cut.state)
    resumed = _trainer(ck, epochs=2, steps=3, seed=9)  # other init
    r = resumed.fit(_ds())
    assert r["resumed_from_step"] == 2
    assert [len(e["losses"]) for e in r["epochs"]] == [1, 3]
    _assert_same(_tensors(resumed.state), _tensors(full.state))


def test_fp32_moments_restore_into_bf16(tmp_path):
    ck = str(tmp_path / "ck")
    tr = _trainer(ck, epochs=1)
    tr.fit(_ds())
    bf = _trainer(ck, epochs=2, adam_moments_dtype="bfloat16")
    assert bf.maybe_resume() == 2
    for got, want in zip(bf.state.opt_state["mu"] + bf.state.opt_state["nu"],
                         tr.state.opt_state["mu"] + tr.state.opt_state["nu"]):
        assert got.dtype == torch.bfloat16
        assert torch.equal(got, want.to(torch.bfloat16))
    bf.fit(_ds())
    assert bf.state.step == 4


def test_structural_mismatch_is_typed(tmp_path):
    ck = str(tmp_path / "ck")
    _trainer(ck, epochs=1).fit(_ds())
    mcfg = llama2.LlamaConfig(**{**MODEL, "dim": 32}, dtype=torch.float32)
    wide = Trainer(TrainingConfig(global_batch_size=4, weight_decay=0.1),
                   None,
                   llama2.make_forward(mcfg),
                   llama2.init_llama(torch.Generator().manual_seed(0), mcfg,
                                     "cpu"),
                   checkpoint_manager=CheckpointManager(ck), device="cpu")
    with pytest.raises(TopologyMismatchError, match="shape"):
        wide.maybe_resume()
    assert wide.checkpoint_manager.all_steps() == [2]  # nothing quarantined


# ---------------------------------------------------------------------
# Corruption: bit flip, torn write
# ---------------------------------------------------------------------

def test_bitflip_caught_falls_back_and_quarantines(tmp_path, monkeypatch,
                                                   fresh_bus):
    ck, metrics = str(tmp_path / "ck"), str(tmp_path / "run.jsonl")
    monkeypatch.setenv("TPU_HPC_FAULTS", "bitflip_ckpt_at_step=4")
    _trainer(ck, epochs=2).fit(_ds())
    monkeypatch.delenv("TPU_HPC_FAULTS")
    tr = _trainer(ck, epochs=2, metrics=metrics)
    assert tr.maybe_resume() == 2
    assert [(e["step"], e["verdict"]) for e in
            _events(metrics, "ckpt_integrity")] == [(4, "mismatch"),
                                                     (2, "ok")]
    falls = _events(metrics, "ckpt_fallback")
    assert [(e["step"], e["quarantined"]) for e in falls] == [(4, "4.corrupt")]
    assert "CkptIntegrityError" in falls[0]["error"]
    assert tr.checkpoint_manager.all_steps() == [2]
    assert os.path.isdir(os.path.join(ck, "4.corrupt"))
    snap = obs.get_registry().snapshot()["counters"]
    assert snap["ckpt_integrity_fail_total"] >= 1
    assert obs.validate_file(metrics) > 0


def test_torn_write_falls_back_and_is_not_reprobed(tmp_path, monkeypatch,
                                                   fresh_bus):
    ck, metrics = str(tmp_path / "ck"), str(tmp_path / "run.jsonl")
    monkeypatch.setenv("TPU_HPC_FAULTS", "corrupt_ckpt_at_step=4")
    _trainer(ck, epochs=2).fit(_ds())
    monkeypatch.delenv("TPU_HPC_FAULTS")
    tr = _trainer(ck, epochs=2, metrics=metrics)
    assert tr.maybe_resume() == 2
    assert [(e["step"], e["quarantined"]) for e in
            _events(metrics, "ckpt_fallback")] == [(4, "4.corrupt")]
    # The next restart lists step 2 only: the corpse is never re-probed.
    again = _trainer(ck, epochs=2, metrics=metrics)
    assert again.maybe_resume() == 2
    assert len(_events(metrics, "ckpt_fallback")) == 1


def test_every_step_failing_raises(tmp_path, monkeypatch):
    ck = str(tmp_path / "ck")
    monkeypatch.setenv("TPU_HPC_FAULTS", "corrupt_ckpt_at_step=2")
    _trainer(ck, epochs=1).fit(_ds())
    monkeypatch.delenv("TPU_HPC_FAULTS")
    from torch.distributed.checkpoint.api import CheckpointException

    with pytest.raises(CheckpointException):  # not None: a silent restart
        _trainer(ck, epochs=1).maybe_resume()
    assert _trainer(ck).checkpoint_manager.all_steps() == [2]


# ---------------------------------------------------------------------
# Preemption
# ---------------------------------------------------------------------

def test_sigterm_snapshots_and_exits_resumable(tmp_path, monkeypatch,
                                               fresh_bus):
    ck, metrics = str(tmp_path / "ck"), str(tmp_path / "run.jsonl")
    monkeypatch.setenv("TPU_HPC_FAULTS", "preempt_at_step=2")
    tr = _trainer(ck, epochs=3, metrics=metrics)
    res = tr.fit(_ds())
    monkeypatch.delenv("TPU_HPC_FAULTS")
    assert res["preempted"] is True and tr.state.step == 2
    assert exit_code_for(res["preempted"], res["rolled_back"]) \
        == EXIT_RESUMABLE
    assert tr.checkpoint_manager.all_steps() == [2]
    end = _events(metrics, "run_end")[-1]
    assert end["preempted"] is True and end["goodput"]["ckpt_s"] > 0
    resumed = _trainer(ck, epochs=3, metrics=metrics)
    r = resumed.fit(_ds())
    assert r["resumed_from_step"] == 2 and resumed.state.step == 6


def test_export_consolidated(tmp_path):
    tr = _trainer(str(tmp_path / "ck"), epochs=1)
    tr.fit(_ds())
    path = tr.checkpoint_manager.export_consolidated(
        tr.state, str(tmp_path / "full.npz"))
    got = np.load(path)
    for k, v in state_dict(tr.state).items():
        np.testing.assert_array_equal(got[k], v.detach().numpy())


# ---------------------------------------------------------------------
# 2 x 2 hybrid -> 4 x 1 FSDP on one gloo world
# ---------------------------------------------------------------------

def _gathered(state):
    out = {}
    for k, v in state_dict(state).items():
        v = v.full_tensor() if hasattr(v, "full_tensor") else v
        out[k] = v.detach().cpu().numpy()
    return out


def _world_main(workdir):
    """One rank: train an epoch under the 2 x 2 hybrid plan and save;
    then restore that checkpoint under 4 x 1 FSDP. Then, back on 2 x 2,
    save a step with one bit flipped in a sharded leaf and restore."""
    from tpu_hpc_torch.runtime import (
        MeshSpec,
        build_mesh,
        cleanup_distributed,
        init_distributed,
    )
    from tpu_hpc_torch.train.__main__ import build_trainer

    torch.set_num_threads(1)
    info = init_distributed(device="cpu", verbose=False)
    mcfg = llama2.LlamaConfig(**MODEL, dtype=torch.float32)
    ck = os.path.join(workdir, "ck")
    kw = dict(steps=2, epochs=1, batch=4, grad_accum_steps=2, device="cpu",
              checkpoint_dir=ck, save_every=1)
    def hybrid_trainer(**over):
        return build_trainer(mcfg, plan="hybrid", mesh=build_mesh(
            MeshSpec(axes={"data": 2, "model": 2}), "cpu"), **{**kw, **over})

    hybrid, ds = hybrid_trainer()
    hybrid.fit(ds)
    saved = _gathered(hybrid.state)
    meta = hybrid.checkpoint_manager.read_sidecar(2)
    fsdp, _ = build_trainer(mcfg, plan="fsdp", mesh=build_mesh(
        MeshSpec(axes={"data": 4, "model": 1}), "cpu"), **kw)
    before = _gathered(fsdp.state)
    step = fsdp.maybe_resume()
    out = {"saved": saved, "restored": _gathered(fsdp.state),
           "before": before, "step": step, "meta_mesh": meta["mesh"],
           "info": fsdp.checkpoint_manager.last_restore_info}
    # Every param and moment is a shard on 2 x 2: only a rank's shard
    # checksums can see a bit flipped in one.
    os.environ["TPU_HPC_FAULTS"] = "bitflip_ckpt_at_step=4"
    flipped, ds = hybrid_trainer(epochs=2)
    flipped.fit(ds)  # resumes at 2, saves step 4 with one bit flipped
    del os.environ["TPU_HPC_FAULTS"]
    meta4 = flipped.checkpoint_manager.read_sidecar(4)
    again, _ = hybrid_trainer(epochs=2)
    out["flip"] = {
        "step": again.maybe_resume(),
        "steps": again.checkpoint_manager.all_steps(),
        "quarantined": os.path.isdir(os.path.join(ck, "4.corrupt")),
        "whole_sums": sorted(meta4["checksums"]),
        "shard_sums": {r: sorted(v)
                       for r, v in meta4["shard_checksums"].items()},
        "fails": obs.get_registry().snapshot()["counters"].get(
            "ckpt_integrity_fail_total"),
        "restored": _gathered(again.state)}
    if info.process_id == 0:
        with open(os.path.join(workdir, "results.pkl"), "wb") as f:
            pickle.dump(out, f)
    cleanup_distributed()


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    from tpu_hpc_torch.runtime.sim import launch_local_world, wait_world

    workdir = str(tmp_path_factory.mktemp("ckpt_world"))
    procs = launch_local_world(
        [sys.executable, os.path.abspath(__file__), workdir], WORLD,
        env=dict(os.environ, PYTHONPATH=REPO), cwd=REPO)
    logs = wait_world(procs)
    assert all(rc == 0 for rc, _, _ in logs), [err for _, _, err in logs]
    with open(os.path.join(workdir, "results.pkl"), "rb") as f:
        return pickle.load(f)


def test_hybrid_2x2_checkpoint_restores_under_fsdp_4x1(world):
    assert world["step"] == 2
    assert world["meta_mesh"] == {"data": 2, "model": 2}
    assert world["info"]["elastic"] is True
    assert world["info"]["tgt_mesh"]["data"] == 4  # FSDP2's data mesh
    saved, got = world["saved"], world["restored"]
    assert saved.keys() == got.keys()
    for k in saved:
        np.testing.assert_array_equal(got[k], saved[k], err_msg=k)
    moved = [k for k in saved if k.startswith("params.")
             and not np.array_equal(world["before"][k], saved[k])]
    assert moved  # the restore, not the init, put them there


def test_bitflip_in_a_shard_is_caught_on_the_save_mesh(world):
    flip = world["flip"]
    assert flip["whole_sums"] == ["opt.count", "step"]
    sharded = sorted(k for k in world["saved"] if k not in flip["whole_sums"])
    assert flip["shard_sums"] == {str(r): sharded for r in range(WORLD)}
    assert flip["step"] == 2 and flip["steps"] == [2]
    assert flip["quarantined"] and flip["fails"] == 1
    for k, v in world["saved"].items():
        np.testing.assert_array_equal(flip["restored"][k], v, err_msg=k)


if __name__ == "__main__":
    _world_main(sys.argv[1])
