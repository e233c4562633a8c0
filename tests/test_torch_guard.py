"""The port's numeric-health guard against the JAX Trainer's, on the CPU.

Both trainers run a tiny float32 Llama from the same params (the JAX
init carried across) on the same batches (the JAX TokenStream's,
replayed through ``ArrayBatches``), with the same ``$TPU_HPC_FAULTS``
plan: ``nan_loss_at_step`` under guard_mode skip and under rollback with
a checkpoint manager (Orbax on the JAX side, torch.distributed.checkpoint
on the port's), and ``grad_spike_at_step``. Verdicts, skipped steps and
rollback windows must be equal exactly; losses agree within
tests/test_torch_train.py's rtol 1e-5 (NaN where the poisoned update's
loss is NaN on both sides). A skipped update leaves the port's params,
moments and count bit-identical. In one 4-process gloo world (this file
run as a script under torchrun's variables) every rank of a 2 x 2
hybrid run takes the same decisions. With the guard off the step issues
exactly the aten ops it did before the guard existed; with it on, the
step reads no scalar to the host.
"""
import collections
import json
import os
import pickle
import sys

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from tpu_hpc_torch import obs
from tpu_hpc_torch.ckpt import CheckpointManager
from tpu_hpc_torch.config import TrainingConfig
from tpu_hpc_torch.models import datasets as tds
from tpu_hpc_torch.models import llama2 as tl
from tpu_hpc_torch.parallel import tp as ttp
from tpu_hpc_torch.resilience import EXIT_ROLLBACK, exit_code_for
from tpu_hpc_torch.resilience import guard as tguard
from tpu_hpc_torch.train import trainer as ttrainer

SEQ, BATCH, WORLD = 16, 4, 4
MODEL = dict(dim=64, n_layers=2, n_heads=4, n_kv_heads=2, vocab_size=128,
             multiple_of=16, max_seq_len=SEQ)
TRAIN = dict(steps_per_epoch=2, global_batch_size=BATCH, seed=0,
             weight_decay=0.1, learning_rate=3e-3, grad_accum_steps=2,
             save_every=1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture()
def fresh_bus():
    from tpu_hpc import obs as jobs

    prev, jprev = (obs.set_bus(obs.EventBus(path="", flight_dir="")),
                   jobs.set_bus(jobs.EventBus(path="", flight_dir="")))
    yield
    obs.set_bus(prev)
    jobs.set_bus(jprev)


def _events(path, kind):
    if not os.path.exists(path):
        return []
    with open(path) as f:
        return [r for r in map(json.loads, f) if r["event"] == kind]


def _verdicts(path):
    return [(r["step"], r["verdict"], r["action"], r["data_index"])
            for r in _events(path, "guard_verdict")]


def _rollbacks(path):
    keys = ("to_step", "first_bad", "last_bad", "data_from", "data_to",
            "quarantined")
    return [{k: r[k] for k in keys} for r in _events(path, "guard_rollback")]


class Pair:
    """The JAX and port trainers of one case, built alike."""

    def __init__(self, tmp, **cfg_kw):
        self.jax = pytest.importorskip("jax")
        self.tmp = tmp
        self.cfg_kw = cfg_kw
        from tpu_hpc.models import datasets as jds
        from tpu_hpc.models import llama2 as jl

        jnp = self.jax.numpy
        self.jcfg_model = jl.LlamaConfig(**MODEL, dtype=jnp.float32)
        self.jparams = jl.init_llama(self.jax.random.key(0), self.jcfg_model)
        self.jds = jds.TokenStream(vocab_size=128, seq_len=SEQ, seed=7)
        batches = [tuple(np.asarray(a) for a in self.jds.batch_at(i, BATCH))
                   for i in range(24)]
        self.tds = tds.ArrayBatches(batches)
        self.mesh = self.jax.sharding.Mesh(
            np.array(self.jax.devices()[:1]), ("data",))

    def _cfg(self, side, tag):
        from tpu_hpc.config import TrainingConfig as JaxTrainingConfig

        cls = JaxTrainingConfig if side == "jax" else TrainingConfig
        return cls(**TRAIN, **self.cfg_kw,
                   checkpoint_dir=str(self.tmp / side / "ck"),
                   metrics_path=str(self.tmp / side / f"{tag}.jsonl"))

    def jax_trainer(self, tag="run", manager=True):
        from tpu_hpc.ckpt import CheckpointManager as JaxManager
        from tpu_hpc.models import llama2 as jl
        from tpu_hpc.parallel import tp as jtp
        from tpu_hpc.train import Trainer as JaxTrainer

        cfg = self._cfg("jax", tag)
        fwd = jl.make_forward(self.jcfg_model, attn_fn=jtp.make_tp_flash_attn_fn(
            self.mesh, impl="xla"))
        mgr = (JaxManager(cfg.checkpoint_dir, async_save=False)
               if manager else None)
        return JaxTrainer(cfg, self.mesh, fwd, self.jparams,
                          checkpoint_manager=mgr)

    def port_trainer(self, tag="run", manager=True):
        cfg = self._cfg("port", tag)
        params = ttrainer.state_from_numpy(
            0, self.jax.device_get(self.jparams), None, cfg, "cpu").params
        fwd = tl.make_forward(tl.LlamaConfig(**MODEL, dtype=torch.float32),
                              attn_fn=ttp.make_tp_flash_attn_fn(None,
                                                                impl="cuda"))
        mgr = CheckpointManager(cfg.checkpoint_dir) if manager else None
        return ttrainer.Trainer(cfg, None, fwd, params,
                                checkpoint_manager=mgr, device="cpu")

    def metrics(self, side, tag="run"):
        return str(self.tmp / side / f"{tag}.jsonl")


def _same_losses(jax_metrics_path, port_metrics_path):
    """Every chunk's last loss, from the two run logs (NaN as null)."""
    got = [r["loss"] for r in _events(port_metrics_path, "epoch")]
    want = [r["loss"] for r in _events(jax_metrics_path, "epoch")]
    assert [g is None for g in got] == [w is None for w in want]
    np.testing.assert_allclose([g for g in got if g is not None],
                               [w for w in want if w is not None], rtol=1e-5)


def _spy_skips(trainer):
    """Wrap the trainer's step: for each update, whether the state after
    it is bit-identical to the state before."""
    inner, same = trainer._step, {}

    def snap(state):
        leaves = list(ttrainer.tree_leaves(state.params))
        for v in state.opt_state.values():
            leaves += v if isinstance(v, list) else [v]
        return [t.detach().clone() for t in leaves]

    def spy(state, batch, off=0):
        before = snap(state)
        new, m = inner(state, batch, off)
        same[state.step] = all(torch.equal(a, b)
                               for a, b in zip(before, snap(new)))
        return new, m

    trainer._step = spy
    return same


def test_nan_skip_matches_jax(tmp_path, monkeypatch, fresh_bus):
    monkeypatch.setenv("TPU_HPC_FAULTS", "nan_loss_at_step=3,on_attempt=-1")
    pair = Pair(tmp_path, guard_mode="skip", epochs=3)
    jres = pair.jax_trainer(manager=False).fit(pair.jds)
    port = pair.port_trainer(manager=False)
    same = _spy_skips(port)
    res = port.fit(pair.tds)
    want = _verdicts(pair.metrics("jax"))
    assert want == [(3, "poisoned", "skip", 3)]
    assert _verdicts(pair.metrics("port")) == want
    assert res["rolled_back"] is jres["rolled_back"] is False
    assert port.state.step == 6 and int(port.state.opt_state["count"]) == 5
    # Only the poisoned update left the state as it found it.
    assert [s for s, kept in same.items() if kept] == [3]
    _same_losses(pair.metrics("jax"), pair.metrics("port"))
    np.testing.assert_allclose(res["final_loss"], jres["final_loss"],
                               rtol=1e-5)
    assert obs.get_registry().snapshot()["counters"][
        "guard_skipped_total"] >= 1


def test_nan_rollback_pair_matches_jax(tmp_path, monkeypatch, fresh_bus):
    """Attempt 0 poisons at data index 3 and rolls back (quarantine +
    skip window + EXIT_ROLLBACK); the relaunch, the fault still armed,
    resumes from the last good checkpoint and skips the index. Both
    packages take the same decisions and write the same window."""
    monkeypatch.setenv("TPU_HPC_FAULTS", "nan_loss_at_step=3,on_attempt=-1")
    pair = Pair(tmp_path, guard_mode="rollback", epochs=3)
    for side in ("jax", "port"):
        make = pair.jax_trainer if side == "jax" else pair.port_trainer
        ds = pair.jds if side == "jax" else pair.tds
        r0 = make().fit(ds)
        assert r0["rolled_back"] is True
        assert exit_code_for(r0["preempted"], r0["rolled_back"]) \
            == EXIT_ROLLBACK
        r1 = make().fit(ds)
        assert r1["rolled_back"] is False
    assert _verdicts(pair.metrics("port")) == _verdicts(pair.metrics("jax"))
    assert _verdicts(pair.metrics("port")) == [(3, "poisoned", "rollback",
                                                3)]
    assert _rollbacks(pair.metrics("port")) == _rollbacks(
        pair.metrics("jax"))
    assert _rollbacks(pair.metrics("port"))[0]["to_step"] == 2
    windows = [tguard.load_state(str(tmp_path / side / "ck"))
               for side in ("jax", "port")]
    assert windows[0]["skip_windows"] == windows[1]["skip_windows"] == [
        {"from_step": 3, "data_from": 3, "data_to": 3}]
    starts = [[r["start_step"] for r in _events(pair.metrics(s),
                                                "run_start")]
              for s in ("jax", "port")]
    assert starts[0] == starts[1] == [0, 2]
    _same_losses(pair.metrics("jax"), pair.metrics("port"))


def test_grad_spike_matches_jax(tmp_path, monkeypatch, fresh_bus):
    monkeypatch.setenv("TPU_HPC_FAULTS",
                       "grad_spike_at_step=5,on_attempt=-1")
    pair = Pair(tmp_path, guard_mode="skip", epochs=4,
                guard_spike_factor=10.0)
    pair.jax_trainer(manager=False).fit(pair.jds)
    port = pair.port_trainer(manager=False)
    port.fit(pair.tds)
    want = [(r["step"], r["verdict"], r["action"], r["data_index"])
            for r in _events(pair.metrics("jax"), "guard_verdict")]
    assert want and want[0] == (5, "spike", "event", 5)
    assert _verdicts(pair.metrics("port")) == want
    ratios = [[r["ratio"] for r in _events(pair.metrics(s), "guard_verdict")]
              for s in ("jax", "port")]
    np.testing.assert_allclose(ratios[1], ratios[0], rtol=1e-3)
    _same_losses(pair.metrics("jax"), pair.metrics("port"))


def test_rollback_without_checkpoint_or_predating_one(tmp_path, monkeypatch,
                                                      fresh_bus):
    pair = Pair(tmp_path, guard_mode="rollback", epochs=2)
    with pytest.raises(ValueError, match="needs a checkpoint_manager"):
        pair.port_trainer(manager=False)
    monkeypatch.setenv("TPU_HPC_FAULTS", "nan_loss_at_step=0,on_attempt=-1")
    with pytest.raises(tguard.GuardError, match="no checkpoint predates"):
        pair.port_trainer().fit(pair.tds)


# ---------------------------------------------------------------------
# Guard off: the ops of the step before the guard existed
# ---------------------------------------------------------------------

class _CountOps(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.ops = collections.Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops[str(func)] += 1
        return func(*args, **(kwargs or {}))


def _linear_forward(p, ms, batch, rng):
    x, y = batch
    return ((x @ p["w"] + p["b"] - y) ** 2).mean(), ms, {}


# aten ops of one guard-off update (counted on the tree before the guard
# was ported): AdamW with warmup, a clip and 2 microbatches; SGD.
GUARD_OFF_OPS = {"adamw_clip_accum2": 107, "sgd": 30}
OPT_CASES = {
    "adamw_clip_accum2": dict(weight_decay=0.1, max_grad_norm=0.5,
                              grad_accum_steps=2, learning_rate=1e-2,
                              warmup_steps=2),
    "sgd": dict(learning_rate=1e-2, momentum=0.9),
}


@pytest.mark.parametrize("name", list(OPT_CASES))
def test_guard_off_step_issues_the_same_ops(name):
    counts = {}
    for mode in ("off", "skip"):
        g = torch.Generator().manual_seed(0)
        params = {"w": torch.randn(4, 3, generator=g), "b": torch.zeros(3)}
        tr = ttrainer.Trainer(TrainingConfig(global_batch_size=4,
                                             guard_mode=mode,
                                             **OPT_CASES[name]),
                              None, _linear_forward, params, device="cpu")
        batch = (torch.randn(4, 4, generator=g), torch.randn(4, 3,
                                                             generator=g))
        tr.train_step(batch)
        with _CountOps() as c:
            tr.train_step(batch)
        counts[mode] = sum(c.ops.values())
        if mode == "skip":
            # The guarded update keeps its decision and count on the
            # device: no scalar is read to the host.
            assert "aten._local_scalar_dense.default" not in c.ops
    assert counts["off"] == GUARD_OFF_OPS[name]
    assert counts["skip"] > counts["off"]  # the guard is not free


class _Listed:
    def __init__(self, batches):
        self.batches = batches

    def batch_at(self, i, bs):
        return self.batches[i]


def test_skipped_update_is_bit_identical_with_bf16_moments(tmp_path,
                                                           monkeypatch):
    monkeypatch.setenv("TPU_HPC_FAULTS", "nan_loss_at_step=1")
    cfg = TrainingConfig(epochs=1, steps_per_epoch=3, global_batch_size=4,
                         weight_decay=0.1, adam_moments_dtype="bfloat16",
                         guard_mode="skip")
    g = torch.Generator().manual_seed(0)
    tr = ttrainer.Trainer(cfg, None, _linear_forward,
                          {"w": torch.randn(4, 3, generator=g),
                           "b": torch.zeros(3)}, device="cpu")
    same = _spy_skips(tr)
    xs = [(torch.randn(4, 4, generator=g), torch.randn(4, 3, generator=g))
          for _ in range(3)]
    tr.fit(_Listed(xs))
    assert same == {0: False, 1: True, 2: False}
    assert int(tr.state.opt_state["count"]) == 2


# ---------------------------------------------------------------------
# Ranks of a 2 x 2 world take one decision
# ---------------------------------------------------------------------

def _world_main(workdir):
    from tpu_hpc_torch.runtime import (
        MeshSpec,
        build_mesh,
        cleanup_distributed,
        init_distributed,
    )
    from tpu_hpc_torch.train.__main__ import build_trainer

    torch.set_num_threads(1)
    info = init_distributed(device="cpu", verbose=False)
    mesh = build_mesh(MeshSpec(axes={"data": 2, "model": 2}), "cpu")
    mcfg = tl.LlamaConfig(**{**MODEL, "n_kv_heads": None},
                          dtype=torch.float32)
    os.environ["TPU_HPC_FAULTS"] = ("nan_loss_at_step=2,grad_spike_at_step=5,"
                                    "on_attempt=-1")
    trainer, ds = build_trainer(mcfg, steps=2, epochs=4, batch=2,
                                grad_accum_steps=2, device="cpu", mesh=mesh,
                                plan="hybrid", guard_mode="skip")
    trainer.guard_policy.min_samples = 2
    res = trainer.fit(ds)
    verdicts = [(r["step"], r["verdict"], r["action"], r["grad_norm"])
                for r in obs.get_bus().ring()
                if r.get("event") == "guard_verdict"]
    out = {"verdicts": verdicts, "count": int(trainer.state.opt_state["count"]),
           "losses": [x for e in res["epochs"] for x in e["losses"]]}
    with open(os.path.join(workdir, f"rank{info.process_id}.pkl"), "wb") as f:
        pickle.dump(out, f)
    cleanup_distributed()


def test_ranks_of_a_2x2_world_take_one_decision(tmp_path):
    from tpu_hpc_torch.runtime.sim import launch_local_world, wait_world

    procs = launch_local_world(
        [sys.executable, os.path.abspath(__file__), str(tmp_path)], WORLD,
        env=dict(os.environ, PYTHONPATH=REPO), cwd=REPO)
    logs = wait_world(procs)
    assert all(rc == 0 for rc, _, _ in logs), [err for _, _, err in logs]
    ranks = []
    for r in range(WORLD):
        with open(tmp_path / f"rank{r}.pkl", "rb") as f:
            ranks.append(pickle.load(f))
    first = ranks[0]
    assert [v[:3] for v in first["verdicts"]][0] == (2, "poisoned", "skip")
    assert any(v[1] == "spike" and v[0] == 5 for v in first["verdicts"])
    assert first["count"] == 7  # 8 updates, one skipped
    for other in ranks[1:]:
        assert other["verdicts"] == first["verdicts"]
        assert other["count"] == first["count"]
        np.testing.assert_array_equal(other["losses"], first["losses"])


if __name__ == "__main__":
    _world_main(sys.argv[1])
