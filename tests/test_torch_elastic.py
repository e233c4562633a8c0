"""Live elastic training (``tpu_hpc_torch.elastic``) against the JAX
package's (``tpu_hpc.elastic``) on the CPU.

* The layout policy: ``legal_extents`` and ``choose_layout`` decide as
  JAX does for the same device count, batch and state -- axes, extent,
  whether the extent was kept, and the transition's wire bytes --
  including the 5-device case (extent 1, five replicas).
* The coordinator on one 4-process gloo world (this file run as a
  script, once for the module), training a small MLP: the preemption
  storm 4 -> 2 -> 4 gives segments [4, 2, 4], two morphs, zero
  restarts, every rank's pid unchanged, and a loss stream bit-identical
  to the port's fixed run on the final layout and within 2e-3 of the
  JAX coordinator's on 4 -> 2 -> 4 simulated devices; a channel-driven
  shrink acks with its costs and lands in the topology history; an
  armed slice fault that never fires fails the run in JAX's words.
* ``python -m tpu_hpc_torch.train --workload elastic`` prints bench.py's
  record keys, and its misplaced or never-firing storm flags are
  argparse errors in bench.py's words.
"""
import json
import os
import pickle
import subprocess
import sys

import numpy as np
import pytest
import torch

WORLD = 4
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STEPS, BATCH, EXTENT = 6, 8, 2
FAULTS = "slice_down_at_step=2,slice_up_at_step=4"
IN_DIM, HIDDEN, OUT_DIM = 16, 32, 4


def _params_np():
    rng = np.random.default_rng(7)
    return {"w1": (rng.standard_normal((IN_DIM, HIDDEN)) * 0.1).astype(
                np.float32),
            "w2": (rng.standard_normal((HIDDEN, OUT_DIM)) * 0.1).astype(
                np.float32)}


def _batch_np(step, gbs):
    rng = np.random.default_rng(1000 + int(step))
    return (rng.standard_normal((gbs, IN_DIM)).astype(np.float32),
            rng.standard_normal((gbs, OUT_DIM)).astype(np.float32))


def _losses(path):
    out = []
    with open(path) as f:
        for line in f:
            r = json.loads(line)
            if r.get("event") == "epoch":
                out.append((r["step"], r["loss"]))
    return out


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------
# the layout policy
# ---------------------------------------------------------------------

def test_legal_extents_equal_jax():
    from tpu_hpc.elastic import legal_extents as jlegal

    from tpu_hpc_torch.elastic import legal_extents

    for n in range(1, 9):
        for batch in (1, 6, 8, 16, 12):
            assert legal_extents(n, batch) == jlegal(n, batch), (n, batch)


@pytest.mark.parametrize("n,batch,current", [
    (8, 16, None), (8, 16, 4), (4, 16, 8), (5, 16, None), (4, 12, 2),
    (2, 8, 2), (6, 12, 4), (1, 4, 1),
], ids=lambda v: str(v))
def test_choose_layout_equals_jax(n, batch, current, devices):
    """Decisions over a live state: a weight sharded over the data axis
    of the current 2 x 2 mesh, a replicated one, and a host scalar."""
    import jax
    from jax.sharding import Mesh as JMesh
    from jax.sharding import NamedSharding, PartitionSpec

    from tpu_hpc.elastic import choose_layout as jchoose
    from tpu_hpc_torch.elastic import choose_layout
    from tpu_hpc_torch.parallel.plans import P
    from tpu_hpc_torch.reshard import Mesh, Sharding, TensorSpec

    jm = JMesh(np.array(devices[:4]).reshape(2, 2), ("data", "replica"))
    jstate = {"params": {
        "w": jax.ShapeDtypeStruct((16, 24), np.float32,
                                  sharding=NamedSharding(
                                      jm, PartitionSpec("data"))),
        "b": jax.ShapeDtypeStruct((24,), np.float32,
                                  sharding=NamedSharding(
                                      jm, PartitionSpec())),
    }}
    tm = Mesh.of_ranks({"data": 2, "replica": 2}, range(4))
    tstate = {"params": {
        "w": TensorSpec((16, 24), torch.float32, Sharding(tm, P("data"))),
        "b": TensorSpec((24,), torch.float32, Sharding(tm, P())),
    }}
    for with_state in (False, True):
        want = jchoose(devices[:n], global_batch=batch,
                       current_data_extent=current,
                       state=jstate if with_state else None)
        got = choose_layout(list(range(n)), global_batch=batch,
                            current_data_extent=current,
                            state=tstate if with_state else None,
                            device_type="cpu")
        assert got.axes == want.axes
        assert got.data_extent == want.data_extent
        assert got.preserved_data_extent == want.preserved_data_extent
        assert got.transition_wire_bytes == want.transition_wire_bytes
        assert [c["axes"] for c in got.candidates] == \
            [c["axes"] for c in want.candidates]
        assert [c["transition_wire_bytes"] for c in got.candidates] == \
            [c["transition_wire_bytes"] for c in want.candidates]
        json.dumps(got.summary())


def test_layout_refusals_equal_jax(devices):
    from tpu_hpc.elastic import choose_layout as jchoose
    from tpu_hpc_torch.elastic import choose_layout

    with pytest.raises(ValueError) as got:
        choose_layout([], global_batch=16, device_type="cpu")
    with pytest.raises(ValueError) as want:
        jchoose([], global_batch=16)
    assert str(got.value) == str(want.value)


# ---------------------------------------------------------------------
# the coordinator on a 4-rank world
# ---------------------------------------------------------------------

def _port_factory(cfg):
    from tpu_hpc_torch.parallel.plans import P
    from tpu_hpc_torch.train.elastic import forward
    from tpu_hpc_torch.train.trainer import Trainer

    def factory(mesh):
        params = {k: torch.from_numpy(v) for k, v in _params_np().items()}
        return Trainer(cfg, mesh, forward, params,
                       param_pspecs={k: P() for k in params},
                       batch_pspec=P("data"), device="cpu")
    return factory


class _PortData:
    def batch_at(self, step, gbs):
        return tuple(torch.from_numpy(a) for a in _batch_np(step, gbs))


def _cfg(cfg_cls, path, steps=STEPS):
    return cfg_cls(epochs=steps, steps_per_epoch=1, global_batch_size=BATCH,
                   learning_rate=1e-2, weight_decay=0.01, metrics_path=path)


def _world_main(workdir):
    """One rank of the world (run as a script)."""
    import torch.distributed as dist

    from tpu_hpc_torch.config import TrainingConfig
    from tpu_hpc_torch.elastic import TopologyCoordinator, choose_layout
    from tpu_hpc_torch.elastic.coordinator import build_rank_mesh
    from tpu_hpc_torch.reshard import read_topology_history
    from tpu_hpc_torch.resilience.signals import MorphChannel
    from tpu_hpc_torch.runtime import cleanup_distributed, init_distributed

    torch.set_num_threads(1)
    info = init_distributed(device="cpu", verbose=False)
    me = info.process_id
    out = {"pid_start": os.getpid()}
    path = os.path.join(workdir, "{}.jsonl")
    # The fixed reference on the final layout.
    decision = choose_layout(list(range(WORLD)), global_batch=BATCH,
                             current_data_extent=EXTENT, device_type="cpu")
    out["fixed_axes"] = decision.axes
    _port_factory(_cfg(TrainingConfig, path.format("fixed")))(
        build_rank_mesh(decision.axes, range(WORLD), "cpu")).fit(_PortData())
    # The storm, chaos-driven.
    os.environ["TPU_HPC_FAULTS"] = FAULTS
    coord = TopologyCoordinator(
        _port_factory(_cfg(TrainingConfig, path.format("storm"))),
        global_batch=BATCH, data_extent=EXTENT, device_type="cpu")
    summary = coord.run(_PortData())
    del os.environ["TPU_HPC_FAULTS"]
    out["storm"] = {k: summary[k] for k in (
        "morph_count", "restarts", "pid", "wire_bytes")}
    out["segments"] = [s["n_devices"] for s in summary["segments"]]
    out["morphs"] = [(m["step"], m["kind"], m["src_mesh"], m["tgt_mesh"],
                      m["preserved_data_extent"]) for m in summary["morphs"]]
    # Channel-driven: a shrink at step 2, the topology history kept.
    chan = MorphChannel(os.path.join(workdir, "chan.jsonl"))
    if me == 0:
        chan.post("shrink", 2, step=2)
    dist.barrier()
    ckpt = os.path.join(workdir, "ck")
    coord = TopologyCoordinator(
        _port_factory(_cfg(TrainingConfig, path.format("chan"), steps=4)),
        global_batch=BATCH, data_extent=EXTENT, channel=chan,
        checkpoint_dir=ckpt, device_type="cpu")
    summary = coord.run(_PortData())
    out["channel"] = {"morphs": [(m["source"], m["step"], m["tgt_mesh"])
                                 for m in summary["morphs"]],
                      "segments": [s["n_devices"]
                                   for s in summary["segments"]],
                      "acked": chan.acked(), "pending": chan.pending(),
                      "history": read_topology_history(ckpt)}
    # Unfired: the storm never reaches its step.
    os.environ["TPU_HPC_FAULTS"] = "slice_down_at_step=99"
    try:
        TopologyCoordinator(
            _port_factory(_cfg(TrainingConfig, path.format("unfired"),
                               steps=3)),
            global_batch=BATCH, data_extent=EXTENT,
            device_type="cpu").run(_PortData())
        out["unfired"] = None
    except RuntimeError as e:
        out["unfired"] = str(e)
    del os.environ["TPU_HPC_FAULTS"]
    out["pid_end"] = os.getpid()
    with open(os.path.join(workdir, f"rank{me}.pkl"), "wb") as f:
        pickle.dump(out, f)
    cleanup_distributed()


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    from tpu_hpc_torch.runtime.sim import launch_local_world, wait_world

    workdir = str(tmp_path_factory.mktemp("elastic_world"))
    procs = launch_local_world(
        [sys.executable, os.path.abspath(__file__), workdir], WORLD,
        env=dict(os.environ, PYTHONPATH=REPO), cwd=REPO)
    pids = [p.pid for p in procs]
    logs = wait_world(procs)
    assert all(rc == 0 for rc, _, _ in logs), [err for _, _, err in logs]
    ranks = []
    for r in range(WORLD):
        with open(os.path.join(workdir, f"rank{r}.pkl"), "rb") as f:
            ranks.append(pickle.load(f))
    return {"ranks": ranks, "workdir": workdir, "pids": pids}


@pytest.fixture(scope="module")
def jax_storm(devices, tmp_path_factory):
    """The JAX coordinator's storm on 4 simulated devices, same model,
    params and batches."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec

    from tpu_hpc.config import TrainingConfig
    from tpu_hpc.elastic import TopologyCoordinator
    from tpu_hpc.train.trainer import Trainer

    def forward(params, model_state, b, rng):
        pred = jnp.tanh(b["x"] @ params["w1"]) @ params["w2"]
        return jnp.mean((pred - b["y"]) ** 2), model_state, {}

    class Data:
        def batch_at(self, step, gbs):
            x, y = _batch_np(step, gbs)
            return {"x": jnp.asarray(x), "y": jnp.asarray(y)}

    path = str(tmp_path_factory.mktemp("jax_storm") / "storm.jsonl")

    def factory(mesh):
        params = {k: jnp.asarray(v) for k, v in _params_np().items()}
        return Trainer(_cfg(TrainingConfig, path), mesh, forward, params,
                       param_pspecs=jax.tree.map(lambda _: PartitionSpec(),
                                                 params),
                       batch_pspec=PartitionSpec("data"))

    prev = os.environ.get("TPU_HPC_FAULTS")
    os.environ["TPU_HPC_FAULTS"] = FAULTS
    try:
        summary = TopologyCoordinator(factory, global_batch=BATCH,
                                      devices=devices[:WORLD],
                                      data_extent=EXTENT).run(Data())
    finally:
        if prev is None:
            os.environ.pop("TPU_HPC_FAULTS", None)
        else:
            os.environ["TPU_HPC_FAULTS"] = prev
    return summary, _losses(path)


def test_storm_shape_zero_restarts_same_pids(world):
    for r, rank in enumerate(world["ranks"]):
        assert rank["segments"] == [4, 2, 4]
        assert rank["storm"]["morph_count"] == 2
        assert rank["storm"]["restarts"] == 0
        assert rank["pid_start"] == rank["pid_end"] == \
            rank["storm"]["pid"] == world["pids"][r]
        assert rank["fixed_axes"] == {"data": 2, "replica": 2}
        assert rank["morphs"] == [
            (2, "shrink", {"data": 2, "replica": 2}, {"data": 2}, True),
            (4, "grow", {"data": 2}, {"data": 2, "replica": 2}, True)]


def test_storm_loss_stream_bit_identical_to_fixed_and_near_jax(world,
                                                               jax_storm):
    path = os.path.join(world["workdir"], "{}.jsonl")
    fixed, storm = _losses(path.format("fixed")), _losses(path.format(
        "storm"))
    assert [s for s, _ in storm] == list(range(1, STEPS + 1))
    assert storm == fixed
    jsummary, jlosses = jax_storm
    assert jsummary["morph_count"] == 2 and jsummary["restarts"] == 0
    assert [s for s, _ in jlosses] == [s for s, _ in storm]
    np.testing.assert_allclose([v for _, v in storm],
                               [v for _, v in jlosses], rtol=2e-3)


def test_storm_events_in_the_run_log(world):
    path = os.path.join(world["workdir"], "storm.jsonl")
    with open(path) as f:
        recs = [json.loads(line) for line in f]
    morphs = [r for r in recs if r["event"] == "topology_morph"]
    assert [m["reason"] for m in morphs] == ["shrink", "grow"]
    assert [m["n_devices_from"] for m in morphs] == [4, 2]
    assert all(m["plan"]["preserved_data_extent"] for m in morphs)
    assert [r["kind"] for r in recs if r["event"] == "fault"] == \
        ["slice_down", "slice_up"]
    assert sum(1 for r in recs if r["event"] == "reshard_plan") == 2
    assert sum(1 for r in recs if r["event"] == "span"
               and r["name"] == "morph") == 2


def test_channel_driven_morph_acks_and_records_history(world):
    for rank in world["ranks"]:
        ch = rank["channel"]
        assert ch["morphs"] == [("channel", 2, {"data": 2})]
        assert ch["segments"] == [4, 2]
        assert len(ch["acked"]) == 1 and ch["pending"] == []
        ack = ch["acked"][0]
        assert ack["step"] == 2 and ack["tgt_mesh"] == {"data": 2}
        assert "wire_bytes" in ack and "stall_s" in ack
        assert ch["history"] == [{"step": 2, "mesh": {"data": 2},
                                  "device_count": 2,
                                  "reason": "morph-shrink"}]


def test_unfired_slice_fault_fails_in_jax_words(world, devices, tmp_path,
                                                monkeypatch):
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec

    from tpu_hpc.config import TrainingConfig
    from tpu_hpc.elastic import TopologyCoordinator
    from tpu_hpc.train.trainer import Trainer

    def forward(params, model_state, b, rng):
        return jnp.mean(b["x"] @ params["w1"]), model_state, {}

    class Data:
        def batch_at(self, step, gbs):
            return {"x": jnp.ones((gbs, IN_DIM), jnp.float32)}

    def factory(mesh):
        params = {"w1": jnp.ones((IN_DIM, 2), jnp.float32)}
        return Trainer(_cfg(TrainingConfig, str(tmp_path / "m.jsonl"), 3),
                       mesh, forward, params,
                       param_pspecs={"w1": PartitionSpec()},
                       batch_pspec=PartitionSpec("data"))

    monkeypatch.setenv("TPU_HPC_FAULTS", "slice_down_at_step=99")
    with pytest.raises(RuntimeError) as want:
        TopologyCoordinator(factory, global_batch=BATCH,
                            devices=devices[:WORLD],
                            data_extent=EXTENT).run(Data())
    for rank in world["ranks"]:
        assert rank["unfired"] == str(want.value)


# ---------------------------------------------------------------------
# the CLI row
# ---------------------------------------------------------------------

def test_workload_elastic_prints_bench_record_keys():
    import ast

    out = subprocess.run(
        [sys.executable, "-m", "tpu_hpc_torch.train", "--workload", "elastic",
         "--device", "cpu", "--steps", "6"],
        cwd=REPO, capture_output=True, text=True, timeout=180,
        env=dict(os.environ, OMP_NUM_THREADS="1"))
    assert out.returncode == 0, out.stderr[-2000:]
    rec = json.loads(out.stdout.splitlines()[-1])
    # bench.py's bench_elastic return record, read from its source.
    with open(os.path.join(REPO, "bench.py")) as f:
        tree = ast.parse(f.read())
    fn = next(n for n in ast.walk(tree) if isinstance(n, ast.FunctionDef)
              and n.name == "bench_elastic")
    ret = fn.body[-1].value
    assert list(rec) == [k.value for k in ret.keys]
    assert rec["metric"] == "elastic_morph_stall_s"
    assert rec["morphs"] == 2 and rec["segments"] == 3
    assert rec["restarts"] == 0 and rec["loss_parity"] is True
    assert rec["n_devices"] == 1


@pytest.mark.parametrize("args", [
    ["--elastic-shrink-at", "2"],
    ["--elastic-grow-at", "4"],
    ["--workload", "elastic", "--elastic-shrink-at", "4",
     "--elastic-grow-at", "2"],
    ["--workload", "elastic", "--elastic-shrink-at", "0"],
    ["--workload", "elastic", "--steps", "4"],
], ids=lambda a: " ".join(a))
def test_storm_flag_errors_match_bench(args, capsys):
    import bench

    from tpu_hpc_torch.train.__main__ import main

    steps = [] if "--steps" in args else ["--steps", "20"]
    msgs = []
    for fn, argv in ((main, ["--device", "cpu", *args, *steps]),
                     (bench.main, [*args, *steps])):
        with pytest.raises(SystemExit) as e:
            fn(argv)
        assert e.value.code == 2
        msgs.append(capsys.readouterr().err.strip().splitlines()[-1])
    got, want = (m.split("error: ", 1)[1] for m in msgs)
    assert got == want


if __name__ == "__main__":
    _world_main(sys.argv[1])
