"""The port's reshard engine (``tpu_hpc_torch.reshard``) against the JAX
package's (``tpu_hpc.reshard``) on the CPU.

* Plans: for the same shapes, specs and ``max_inflight_bytes``, every
  step's kind, chunk (axis, rows, count), modeled wire bytes, transient,
  HBM bound and bound verdict, the executor's stage grouping and the
  plan summary equal the JAX plan's -- over same-mesh, cross-mesh and
  bounded pairs, and ``"auto"``. A port mesh of ranks 0..n-1 stands for
  the JAX mesh of simulated devices 0..n-1.
* Execution: in process (host data onto a device, a chunked transfer
  between two tiers of one device) the outputs are bit-equal to the
  JAX engine's, and the ``reshard_plan`` event equals JAX's apart from
  its stamps; across ranks, one 4-process gloo world (this file run as
  a script, once for the module) executes the same-mesh and cross-mesh
  cases and every rank's shard is bit-equal to the JAX output's region,
  each rank's event equals JAX's, and a bounded plan's staging arena
  stays within its step's transient.
* ``serve.weights.place_params`` goes through the engine: its output
  equals the JAX ``place_params``'s and its event is JAX's.
"""
import os
import pickle
import sys

import numpy as np
import pytest
import torch

WORLD = 4
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STAMPS = ("time", "run_id", "host", "pid", "schema_version", "t_wall",
          "t_mono")

# (name, {leaf: shape}, src (axes, ranks, spec per leaf), tgt (...),
# max_inflight_bytes). Specs are tuples of axis names / None / tuples.
CASES = [
    ("exchange", {"a": (8, 12), "b": (4, 6)},
     ({"data": 4}, (0, 1, 2, 3), {"a": ("data",), "b": ("data",)}),
     ({"data": 4}, (0, 1, 2, 3), {"a": (None, "data"), "b": ()}), None),
    ("exchange_bounded", {"a": (8, 12), "b": (4, 8)},
     ({"data": 4}, (0, 1, 2, 3), {"a": ("data",), "b": ("data",)}),
     ({"data": 4}, (0, 1, 2, 3), {"a": (None, "data"), "b": (None, "data")}),
     96),
    ("gather_local_noop", {"a": (8, 4), "b": (8, 4), "c": (6,)},
     ({"data": 2, "model": 2}, (0, 1, 2, 3),
      {"a": ("data",), "b": (), "c": ("model",)}),
     ({"data": 2, "model": 2}, (0, 1, 2, 3),
      {"a": (), "b": (("data", "model"),), "c": ("model",)}), 64),
    ("shrink", {"w": (8, 16), "m": (8, 16), "s": (16,)},
     ({"data": 2, "replica": 2}, (0, 1, 2, 3),
      {"w": ("data",), "m": ("data",), "s": ()}),
     ({"data": 2}, (0, 1), {"w": ("data",), "m": (None, "data"), "s": ()}),
     128),
    ("grow", {"w": (8, 16), "m": (8, 16)},
     ({"data": 2}, (0, 1), {"w": ("data",), "m": ("data",)}),
     ({"data": 4}, (0, 1, 2, 3), {"w": ("data",), "m": ()}), None),
    ("auto", {"w": (64, 32), "v": (32,)},
     ({"data": 4}, (0, 1, 2, 3), {"w": ("data",), "v": ()}),
     ({"data": 2}, (2, 3), {"w": (None, "data"), "v": ()}), "auto"),
]
CASE_IDS = [c[0] for c in CASES]


def _global(name, leaf, shape):
    seed = sum(map(ord, name + leaf))
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _port_sharding(layout, leaf):
    from tpu_hpc_torch.parallel.plans import P
    from tpu_hpc_torch.reshard import Mesh, Sharding

    axes, ranks, specs = layout
    return Sharding(Mesh.of_ranks(axes, ranks), P(*specs[leaf]))


def _port_plan(case):
    from tpu_hpc_torch.reshard import TensorSpec, plan_reshard

    name, leaves, src, tgt, bound = case
    tree = {k: TensorSpec(s, torch.float32, _port_sharding(src, k))
            for k, s in leaves.items()}
    return plan_reshard(tree, {k: _port_sharding(tgt, k) for k in leaves},
                        max_inflight_bytes=bound, label=name)


def _jax_sharding(layout, leaf):
    import jax
    from jax.sharding import Mesh, NamedSharding, PartitionSpec

    axes, ranks, specs = layout
    devs = np.array([jax.devices()[r] for r in ranks]).reshape(
        tuple(axes.values()))
    return NamedSharding(Mesh(devs, tuple(axes)), PartitionSpec(*specs[leaf]))


def _jax_plan_and_outputs(case):
    """The JAX plan, its event and its (global) outputs on the case's
    seeded data."""
    import jax

    from tpu_hpc import obs as jobs
    from tpu_hpc import reshard as jr

    name, leaves, src, tgt, bound = case
    tree = {k: jax.device_put(_global(name, k, s), _jax_sharding(src, k))
            for k, s in leaves.items()}
    plan = jr.plan_reshard(tree, {k: _jax_sharding(tgt, k) for k in leaves},
                           max_inflight_bytes=bound, label=name)
    bus = jobs.EventBus(path=None, run_id="t", ring_size=1 << 12)
    prev = jobs.set_bus(bus)
    try:
        out = plan.execute(tree)
    finally:
        jobs.set_bus(prev)
    event = [r for r in bus.ring() if r["event"] == "reshard_plan"][-1]
    return plan, _unstamped(event), {k: np.asarray(v) for k, v in out.items()}


def _unstamped(rec):
    return {k: v for k, v in rec.items() if k not in STAMPS}


def _unpriced(rec):
    """A plan record without its predicted wall time: the port's planner
    prices the wire at NVLink-class rates (comm/planner.py), JAX's at
    the TPU's."""
    return {k: v for k, v in rec.items() if k != "predicted_cost_ms"}


def _step_fields(s):
    return (s.path, s.kind, s.shape, s.dtype, s.bytes, s.wire_bytes,
            s.inflight_bytes, s.resident_bytes, s.src_resident_bytes,
            s.same_mesh, None if s.chunk is None else
            (s.chunk.axis, s.chunk.size, s.chunk.count), s.bound_met,
            s.hbm_bound_bytes)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jax_side(devices):
    return {c[0]: _jax_plan_and_outputs(c) for c in CASES}


@pytest.mark.parametrize("case", CASES, ids=CASE_IDS)
def test_plans_equal_jax_field_for_field(case, jax_side):
    from tpu_hpc.reshard import execute as jexec

    from tpu_hpc_torch.reshard import execute as texec

    want = jax_side[case[0]][0]
    got = _port_plan(case)
    assert [_step_fields(s) for s in got.steps] == \
        [_step_fields(s) for s in want.steps]
    for copy_noop in (False, True):
        assert texec._stages(got, copy_noop) == \
            jexec._stages(want, copy_noop)
    assert ("predicted_cost_ms" in got.summary()) == \
        ("predicted_cost_ms" in want.summary())
    assert _unpriced(got.summary()) == _unpriced(want.summary())
    assert got.max_inflight_bytes == want.max_inflight_bytes
    if case[4] is not None and case[4] != "auto":
        assert all(s.inflight_bytes <= case[4] for s in got.steps
                   if s.bound_met)


def test_wire_model_equals_jax_over_spec_pairs(devices):
    """modeled_wire_bytes over every (source, target) pair of a spec set
    on a 2 x 2 mesh and across to a 2-device sub-mesh."""
    from tpu_hpc.reshard import modeled_wire_bytes as jwire

    from tpu_hpc_torch.reshard import modeled_wire_bytes as twire

    specs = [(), ("data",), ("model",), (None, "data"), ("data", "model"),
             (("data", "model"),), ("model", "data")]
    full = ({"data": 2, "model": 2}, (0, 1, 2, 3))
    sub = ({"data": 2, "model": 1}, (1, 3))
    shape = (8, 4)
    for a in specs:
        for b in specs:
            for tgt in (full, sub):
                src_l = (*full, {"x": a})
                tgt_l = (*tgt, {"x": b})
                assert twire(shape, 4, _port_sharding(src_l, "x"),
                             _port_sharding(tgt_l, "x")) == \
                    jwire(shape, 4, _jax_sharding(src_l, "x"),
                          _jax_sharding(tgt_l, "x")), (a, b, tgt)


def test_in_process_transfer_is_bit_equal_and_its_event_is_jax(devices):
    """A chunked move between two tiers (JAX: two one-device meshes;
    port: two named tiers of the CPU), and host data placed: outputs
    bit-equal to JAX's, events equal apart from stamps, and a held plan
    replays with no new buffer."""
    import jax
    from jax.sharding import Mesh as JMesh
    from jax.sharding import NamedSharding, PartitionSpec

    from tpu_hpc import obs as jobs
    from tpu_hpc import reshard as jr
    from tpu_hpc_torch import obs as tobs
    from tpu_hpc_torch import reshard as tr
    from tpu_hpc_torch.parallel.plans import P

    x = _global("tier", "k", (2, 4, 8, 2, 4))
    jm = [JMesh(np.array([d]).reshape(1, 1), ("data", "model"))
          for d in devices[:2]]
    js = [NamedSharding(m, PartitionSpec(None, None, None, None, None))
          for m in jm]
    jx = jax.device_put(x, js[0])
    tm = [tr.Mesh.of_device("cpu", tier, {"data": 1, "model": 1})
          for tier in ("prefill", "decode")]
    ts = [tr.Sharding(m, P(None, None, None, None, None)) for m in tm]
    results = {}
    for side in ("jax", "port"):
        obs = jobs if side == "jax" else tobs
        bus = obs.EventBus(path=None, run_id="t", ring_size=1 << 10)
        prev = obs.set_bus(bus)
        try:
            if side == "jax":
                plan = jr.plan_reshard({"k": jx, "h": x[0]},
                                       {"k": js[1], "h": NamedSharding(
                                           jm[1], PartitionSpec())},
                                       max_inflight_bytes=512, label="hop")
                out = plan.execute({"k": jx, "h": x[0]})
                out = {k: np.asarray(v) for k, v in out.items()}
            else:
                src = {"k": tr.TensorSpec(x.shape, torch.float32, ts[0]),
                       "h": x[0]}
                plan = tr.plan_reshard(src, {"k": ts[1], "h": tr.Sharding(
                    tm[1])},
                                       max_inflight_bytes=512, label="hop")
                leaves = {"k": torch.from_numpy(x.copy()), "h": x[0]}
                out = plan.execute(leaves)
                n = plan.compiled_program_count
                again = plan.execute(leaves)
                assert plan.compiled_program_count == n
                assert again["k"] is out["k"]
                out = {k: v.numpy().copy() for k, v in out.items()}
        finally:
            obs.set_bus(prev)
        events = [_unstamped(r) for r in bus.ring()
                  if r["event"] == "reshard_plan"]
        results[side] = (plan, out, events[0])
    (jp, jout, jev), (tp, tout, tev) = results["jax"], results["port"]
    assert [s.kind for s in tp.steps] == [s.kind for s in jp.steps] == \
        ["place", "transfer"]
    assert tp.steps[1].chunk is not None
    for k in jout:
        assert np.array_equal(tout[k], jout[k]), k
    assert tev == jev


def test_place_params_equals_jax_and_emits_its_event(devices):
    import jax
    from jax.sharding import PartitionSpec

    from tpu_hpc import obs as jobs
    from tpu_hpc.models import llama2 as jl
    from tpu_hpc.runtime import MeshSpec, build_mesh
    from tpu_hpc.serve import weights as jweights
    from tpu_hpc_torch import obs as tobs
    from tpu_hpc_torch.models import llama2 as tl
    from tpu_hpc_torch.serve import weights

    jcfg = jl.LlamaConfig(dim=32, n_layers=1, n_heads=4, n_kv_heads=2,
                          vocab_size=64, multiple_of=16, max_seq_len=32,
                          dtype=jax.numpy.float32)
    tcfg = tl.LlamaConfig(dim=32, n_layers=1, n_heads=4, n_kv_heads=2,
                          vocab_size=64, multiple_of=16, max_seq_len=32,
                          dtype=torch.float32)
    jp = jl.init_llama(jax.random.key(3), jcfg)
    host = jax.device_get(jp)
    mesh = build_mesh(MeshSpec(axes={"data": 1}), devices=devices[:1])
    specs = jax.tree.map(lambda _: PartitionSpec(), jp)
    events = {}
    for side, obs in (("jax", jobs), ("port", tobs)):
        bus = obs.EventBus(path=None, run_id="t", ring_size=1 << 10)
        prev = obs.set_bus(bus)
        try:
            if side == "jax":
                got_j = jweights.place_params(jp, mesh, specs,
                                              max_inflight_bytes=4096)
            else:
                src = {k: v for k, v in weights.flat_params(
                    jax.tree.map(lambda a: torch.from_numpy(np.array(a)),
                                 host)).items()}
                got_t = weights.place_params(
                    weights._unflatten(src), tcfg, "cpu",
                    max_inflight_bytes=4096)
        finally:
            obs.set_bus(prev)
        events[side] = [_unstamped(r) for r in bus.ring()
                        if r["event"] == "reshard_plan"]
    flat_t = weights.flat_params(got_t)
    flat_j = weights.flat_params(jax.tree.map(np.asarray, got_j))
    assert list(flat_t) == list(flat_j)
    for k, v in flat_j.items():
        assert np.array_equal(flat_t[k].numpy(), v), k
    assert events["port"] == events["jax"]
    assert events["port"][0]["label"] == "serving_params"


def test_apply_keeps_no_reference_to_its_source():
    """The source tree frees as soon as the caller drops it (no cycle
    holds it for the collector): a served model's float32 init must not
    outlive its placement."""
    import gc
    import weakref

    from tpu_hpc_torch import reshard

    src = {"a": {"w": torch.ones(64, 64)}, "b": [torch.zeros(8)]}
    ref = weakref.ref(src["a"]["w"])
    gc.disable()
    try:
        out = reshard.apply(src, "cpu", copy_noop=True,
                            dtypes=torch.bfloat16, max_inflight_bytes=1024)
        del src
        assert ref() is None
    finally:
        gc.enable()
    assert out["a"]["w"].dtype == torch.bfloat16


def test_operations_modules_import_no_jax():
    """The slice's modules and the entry points wired to them import
    neither jax nor the JAX package."""
    import subprocess

    code = (
        "import sys\n"
        "import tpu_hpc_torch.reshard, tpu_hpc_torch.elastic\n"
        "import tpu_hpc_torch.serve.disagg, tpu_hpc_torch.serve.server\n"
        "import tpu_hpc_torch.train.elastic, tpu_hpc_torch.train.__main__\n"
        "import tpu_hpc_torch.comm.bench, chip_smoke\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'tpu_hpc', 'flax', 'optax')]\n"
        "print(bad)\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True, timeout=120, cwd=REPO)
    assert out.stdout.strip() == "[]"


# ---------------------------------------------------------------------
# the 4-rank gloo world
# ---------------------------------------------------------------------

def _world_main(workdir):
    """One rank of the world (run as a script)."""
    from tpu_hpc_torch import obs
    from tpu_hpc_torch.reshard import execute as texec
    from tpu_hpc_torch.reshard.plan import boxes
    from tpu_hpc_torch.runtime import cleanup_distributed, init_distributed

    torch.set_num_threads(1)
    info = init_distributed(device="cpu", verbose=False)
    me = info.process_id
    out = {}
    for case in CASES:
        name, leaves, src, tgt, bound = case
        plan = _port_plan(case)
        local = {}
        for k, shape in leaves.items():
            box = boxes(_port_sharding(src, k), shape).get((None, me))
            g = torch.from_numpy(_global(name, k, shape))
            local[k] = None if box is None else g[tuple(
                slice(lo, hi) for lo, hi in box)].clone()
        bus = obs.EventBus(path=None, run_id="t", ring_size=1 << 10)
        prev = obs.set_bus(bus)
        try:
            got = plan.execute(local, device="cpu")
        finally:
            obs.set_bus(prev)
        arena = plan._programs.get(("arena", "cpu"))
        out[name] = {
            "out": {k: None if v is None else v.numpy().copy()
                    for k, v in got.items()},
            "event": [_unstamped(r) for r in bus.ring()
                      if r["event"] == "reshard_plan"][0],
            "arena": 0 if arena is None else arena.numel(),
            "in_process": [texec.in_process(s, me) for s in plan.steps],
        }
    with open(os.path.join(workdir, f"rank{me}.pkl"), "wb") as f:
        pickle.dump(out, f)
    cleanup_distributed()


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    from tpu_hpc_torch.runtime.sim import launch_local_world, wait_world

    workdir = str(tmp_path_factory.mktemp("reshard_world"))
    procs = launch_local_world(
        [sys.executable, os.path.abspath(__file__), workdir], WORLD,
        env=dict(os.environ, PYTHONPATH=REPO), cwd=REPO)
    logs = wait_world(procs)
    assert all(rc == 0 for rc, _, _ in logs), [err for _, _, err in logs]
    ranks = []
    for r in range(WORLD):
        with open(os.path.join(workdir, f"rank{r}.pkl"), "rb") as f:
            ranks.append(pickle.load(f))
    return ranks


@pytest.mark.parametrize("case", CASES, ids=CASE_IDS)
def test_world_execution_is_bit_equal_to_jax(case, world, jax_side):
    from tpu_hpc_torch.reshard.plan import boxes

    name, leaves, _, tgt, bound = case
    _, jevent, jout = jax_side[name]
    plan = _port_plan(case)
    for r, rank in enumerate(world):
        got = rank[name]
        assert not any(got["in_process"])
        for k, shape in leaves.items():
            box = boxes(_port_sharding(tgt, k), shape).get((None, r))
            if box is None:
                assert got["out"][k] is None
                continue
            want = jout[k][tuple(slice(lo, hi) for lo, hi in box)]
            assert np.array_equal(got["out"][k], want), (r, k)
        assert _unpriced(got["event"]) == _unpriced(jevent)
        assert ("predicted_cost_ms" in got["event"]) == (bound == "auto")
        # The staging arena holds one stage's (chunk's) pieces: never
        # more than the plan's transient for bounded plans.
        if bound is not None and bound != "auto":
            assert got["arena"] <= max(
                s.inflight_bytes for s in plan.steps
                if s.kind not in ("noop", "local")) + 64


if __name__ == "__main__":
    _world_main(sys.argv[1])
