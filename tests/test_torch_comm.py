"""The port's comm layer on a 4-rank gloo world against the JAX comm
package on 4 of the simulated CPU devices: the named collectives, the
two-phase collectives, the ring all-gather and gather-matmul, the
two-tier mesh, and the comm bench.

One world of four processes serves the file: the module fixture
launches this file as a script four times with torchrun's variables;
each rank runs every case on its shard of the same seeded global
arrays and writes what it got. The inputs are small integers in
float32, so every sum is exact and the results must equal the JAX
package's bit for bit (``_pad_leading``'s uneven lengths included).
The bench formulas and the refusal texts are checked in this process.
"""
import json
import os
import pickle
import re
import sys

import numpy as np
import pytest
import torch

WORLD = 4
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# (name, global shape, in spec, op kwargs): the named collectives over
# the 4-wide "data" axis; "sharded" inputs are split on dim 0 over the
# ranks, "replicated" ones given whole to every rank.
PRIMS = (
    ("all_reduce", (12, 5), "sharded", {}),
    ("all_gather", (12, 5), "sharded", {}),
    ("reduce_scatter", (8, 5), "replicated", {}),
    ("broadcast", (12, 5), "sharded", {}),
    ("broadcast_root2", (12, 5), "sharded", {"root": 2}),
    ("ring_shift", (12, 5), "sharded", {}),
    ("ring_shift_3", (12, 5), "sharded", {"shift": 3}),
    ("all_to_all", (8, 12), "sharded", {}),
)
# Two-phase collectives on (dcn x ici) meshes of 4 ranks: 2 x 2, and
# the degenerate 4 x 1 and 1 x 4; leading dims 3 and 5 per shard take
# the scatter phase's zero padding.
HIER_MESHES = {"2x2": (2, 2), "4x1": (4, 1), "1x4": (1, 4)}
HIER = (
    ("hier_all_reduce", 4, "sharded"),
    ("hier_all_reduce_pad3", 3, "sharded"),
    ("hier_all_reduce_pad5", 5, "sharded"),
    ("hier_all_gather", 3, "sharded"),
    ("hier_reduce_scatter", 8, "replicated"),
)
BENCH_SIZES = [1000]


def _global(name, shape):
    seed = sum(map(ord, name))
    return np.random.default_rng(seed).integers(
        -8, 9, size=shape).astype(np.float32)


def _shard(x, rank, n=WORLD):
    k = x.shape[0] // n
    return x[rank * k:(rank + 1) * k]


def _world_main(workdir):
    """One rank of the world (run as a script)."""
    import torch.distributed as dist

    from tpu_hpc_torch.comm import bench, hierarchical, overlap, primitives
    from tpu_hpc_torch.runtime import (
        MeshSpec,
        build_hybrid_mesh,
        build_mesh,
        cleanup_distributed,
        init_distributed,
        node_groups,
        two_tier_spec,
    )

    torch.set_num_threads(1)
    info = init_distributed(device="cpu", verbose=False)
    r = info.process_id
    out = {}
    flat = build_mesh(MeshSpec(axes={"data": WORLD}), "cpu")
    for name, shape, kind, kw in PRIMS:
        x = _global(name, shape)
        mine = _shard(x, r) if kind == "sharded" else x
        fn = getattr(primitives, name.split("_root")[0].split("_3")[0])
        out[name] = fn(flat, "data", **kw)(torch.from_numpy(mine)).numpy()
    for mname, (d, i) in HIER_MESHES.items():
        mesh = build_mesh(MeshSpec(axes={"dcn": d, "ici": i}), "cpu")
        for name, lead, kind in HIER:
            x = _global(name, (WORLD * lead, 3) if kind == "sharded"
                        else (lead, 3))
            mine = _shard(x, r) if kind == "sharded" else x
            op = getattr(hierarchical, "_".join(name.split("_")[:3]))
            out[f"{mname}/{name}"] = op(mesh)(torch.from_numpy(mine)).numpy()
    x = _global("ring_all_gather", (8, 3))
    out["ppermute_all_gather"] = overlap.ppermute_all_gather(flat, "data")(
        torch.from_numpy(_shard(x, r))).numpy()
    xa, w = _global("gm_x", (8, 16)), _global("gm_w", (16, 6))
    out["gather_matmul"] = overlap.make_pipelined_gather_matmul(
        flat, "data")(torch.from_numpy(_shard(xa, r)),
                      torch.from_numpy(_shard(w, r))).numpy()
    # The two-tier mesh: emulated nodes on the CPU, and node identity
    # (host names) where the device is a card.
    spec = MeshSpec(axes={"dcn": 1, "ici": 2}, dcn_axes={"dcn": 2})
    out["hybrid_grid"] = build_mesh(spec, "cpu").mesh.tolist()
    out["two_tier_grid"] = build_mesh(two_tier_spec(WORLD, 1),
                                      "cpu").mesh.tolist()
    out["node_groups"] = node_groups()
    try:
        build_hybrid_mesh(spec, "cuda")
        out["cuda_refusal"] = None
    except ValueError as e:
        out["cuda_refusal"] = str(e)
    # The bench: every flat, overlap and hierarchical op, CSV + JSONL.
    stem = os.path.join(workdir, "bench")
    records = bench.run_comm_bench(
        sizes=BENCH_SIZES, warmup=1, iters=2,
        ops=bench.OPS + bench.HIER_OPS + bench.OVERLAP_OPS,
        output=stem + ".csv", device_type="cpu")
    out["bench_records"] = records
    try:
        bench.run_comm_bench(sizes=BENCH_SIZES, ops=("reshard_exchange",),
                             device_type="cpu")
        out["reshard_refusal"] = None
    except NotImplementedError as e:
        out["reshard_refusal"] = str(e)
    dist.barrier()
    with open(os.path.join(workdir, f"rank{r}.pkl"), "wb") as f:
        pickle.dump(out, f)
    cleanup_distributed()


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """Every rank's results, by rank."""
    from tpu_hpc_torch.runtime.sim import launch_local_world, wait_world

    workdir = str(tmp_path_factory.mktemp("comm_world"))
    procs = launch_local_world(
        [sys.executable, os.path.abspath(__file__), workdir], WORLD,
        env=dict(os.environ, PYTHONPATH=REPO), cwd=REPO)
    logs = wait_world(procs)
    assert all(rc == 0 for rc, _, _ in logs), [err for _, _, err in logs]
    ranks = []
    for r in range(WORLD):
        with open(os.path.join(workdir, f"rank{r}.pkl"), "rb") as f:
            ranks.append(pickle.load(f))
    return {"ranks": ranks, "workdir": workdir}


@pytest.fixture(scope="module")
def jax_side():
    """The JAX comm package's results on the same global arrays, over
    4 of the simulated devices."""
    jax = pytest.importorskip("jax", reason="the JAX reference package")
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as JP

    from tpu_hpc.comm import hierarchical as jh
    from tpu_hpc.comm import overlap as jo
    from tpu_hpc.comm import primitives as jprim

    devs = np.array(jax.devices()[:WORLD])
    flat = Mesh(devs, ("data",))
    out = {}
    for name, shape, kind, kw in PRIMS:
        x = _global(name, shape)
        fn = getattr(jprim, name.split("_root")[0].split("_3")[0])(
            flat, "data", **kw)
        spec = JP("data") if kind == "sharded" else JP()
        out[name] = np.asarray(fn(jax.device_put(x, NamedSharding(flat,
                                                                  spec))))
    for mname, (d, i) in HIER_MESHES.items():
        mesh = Mesh(devs.reshape(d, i), ("dcn", "ici"))
        for name, lead, kind in HIER:
            x = _global(name, (WORLD * lead, 3) if kind == "sharded"
                        else (lead, 3))
            spec = JP(("dcn", "ici")) if kind == "sharded" else JP()
            op = getattr(jh, "_".join(name.split("_")[:3]))
            out[f"{mname}/{name}"] = np.asarray(op(mesh)(
                jax.device_put(x, NamedSharding(mesh, spec))))
    x = _global("ring_all_gather", (8, 3))
    out["ppermute_all_gather"] = np.asarray(jo.ppermute_all_gather(
        flat, "data")(jax.device_put(x, NamedSharding(flat, JP("data")))))
    xa, w = _global("gm_x", (8, 16)), _global("gm_w", (16, 6))
    shard = NamedSharding(flat, JP("data"))
    out["gather_matmul"] = np.asarray(jo.make_pipelined_gather_matmul(
        flat, "data")(jax.device_put(xa, shard), jax.device_put(w, shard)))
    return out


def _assemble(ranks, key, out_sharded):
    """The global result from the ranks' outputs: their concatenation
    for a sharded output (after checking nothing), else rank 0's after
    checking every rank holds the same."""
    got = [r[key] for r in ranks]
    if out_sharded:
        return np.concatenate(got, axis=0)
    for g in got[1:]:
        np.testing.assert_array_equal(g, got[0])
    return got[0]


@pytest.mark.parametrize("name", [p[0] for p in PRIMS])
def test_primitive_equals_jax_bit_for_bit(world, jax_side, name):
    ranks = world["ranks"]
    if name == "all_to_all":
        # P(None, axis) out: each rank holds a column block.
        got = np.concatenate([r[name] for r in ranks], axis=1)
    else:
        got = _assemble(ranks, name, name in (
            "reduce_scatter", "ring_shift", "ring_shift_3"))
    np.testing.assert_array_equal(got, jax_side[name])


@pytest.mark.parametrize("mesh", list(HIER_MESHES))
@pytest.mark.parametrize("name", [h[0] for h in HIER])
def test_two_phase_equals_jax_bit_for_bit(world, jax_side, mesh, name):
    key = f"{mesh}/{name}"
    got = _assemble(world["ranks"], key, name == "hier_reduce_scatter")
    np.testing.assert_array_equal(got, jax_side[key])


def test_two_phase_all_reduce_equals_flat_all_reduce(world):
    """psum_two_phase over dcn 2 x ici 2 sums what the flat all-reduce
    over the 4-wide axis sums (the decomposition's whole claim)."""
    for r in world["ranks"]:
        x = _global("hier_all_reduce", (WORLD * 4, 3))
        np.testing.assert_array_equal(r["2x2/hier_all_reduce"],
                                      x.reshape(WORLD, 4, 3).sum(0))


@pytest.mark.parametrize("name", ["ppermute_all_gather", "gather_matmul"])
def test_overlap_ops_equal_jax(world, jax_side, name):
    got = _assemble(world["ranks"], name, name == "gather_matmul")
    np.testing.assert_array_equal(got, jax_side[name])


def test_hybrid_mesh_matches_jax_layout(world):
    """dcn_axes on the CPU: equal contiguous chunks as emulated nodes,
    the DCN component slowest -- the JAX CPU branch's device order; the
    two-tier spec of 4 ranks on one node is dcn 2 x ici 2; a gloo world
    is one node."""
    jax = pytest.importorskip("jax", reason="the JAX reference package")
    from tpu_hpc.runtime import MeshSpec as JSpec
    from tpu_hpc.runtime.mesh import build_hybrid_mesh as jhybrid

    jmesh = jhybrid(JSpec(axes={"dcn": 1, "ici": 2}, dcn_axes={"dcn": 2}),
                    jax.devices()[:WORLD])
    want = [[d.id for d in row] for row in jmesh.devices]
    for r in world["ranks"]:
        assert r["hybrid_grid"] == want == [[0, 1], [2, 3]]
        assert r["two_tier_grid"] == [[0, 1], [2, 3]]
        assert r["node_groups"] == [[0, 1, 2, 3]]


@pytest.mark.parametrize("dcn_axes,axes", [
    ({"data": 2}, {"data": 2, "model": 2}),
    ({"dcn": 2}, {"dcn": 1, "ici": 4}),
    ({"data": 2, "model": 2}, {"data": 2, "model": 1}),
])
def test_hybrid_rank_grid_matches_jax_device_order(dcn_axes, axes):
    """The rank arrangement of build_hybrid_mesh against the JAX CPU
    branch's device ids on 8 simulated devices, for specs with one and
    two across-node axes."""
    jax = pytest.importorskip("jax", reason="the JAX reference package")
    from tpu_hpc.runtime import MeshSpec as JSpec
    from tpu_hpc.runtime.mesh import build_hybrid_mesh as jhybrid

    from tpu_hpc_torch.runtime.mesh import MeshSpec, hybrid_rank_grid

    devs = jax.devices()[:8]
    want = np.vectorize(lambda d: d.id)(
        jhybrid(JSpec(axes=axes, dcn_axes=dcn_axes), devs).devices)
    spec = MeshSpec(axes=axes, dcn_axes=dcn_axes)
    per = 8 // spec.num_slices
    groups = [list(range(i * per, (i + 1) * per))
              for i in range(spec.num_slices)]
    np.testing.assert_array_equal(hybrid_rank_grid(spec, groups), want)


def test_node_identity_is_checked_on_cards(world):
    """On a card the nodes come from the ranks' hosts: a dcn_axes spec
    wanting 2 nodes in a one-host world is refused in the JAX words."""
    for r in world["ranks"]:
        assert r["cuda_refusal"] == (
            "spec wants 2 slices (dcn_axes={'dcn': 2}) but the devices "
            "span 1 physical slice(s)")


def test_two_tier_spec_words_match_jax():
    jax = pytest.importorskip("jax", reason="the JAX reference package")
    from tpu_hpc.runtime.mesh import two_tier_spec as jtwo

    from tpu_hpc_torch.runtime.mesh import two_tier_spec

    for n_dev, n_slices, dcn in ((4, 1, None), (8, 2, None), (16, 2, None),
                                 (8, 1, 4)):
        a, b = two_tier_spec(n_dev, n_slices, dcn), jtwo(n_dev, n_slices, dcn)
        assert (dict(a.axes), dict(a.dcn_axes)) == (dict(b.axes),
                                                    dict(b.dcn_axes))
    for n_dev, n_slices, dcn in ((1, 1, None), (2, 1, None), (6, 1, 4),
                                 (4, 4, None)):
        with pytest.raises(ValueError) as ours:
            two_tier_spec(n_dev, n_slices, dcn, inner_axis="data")
        with pytest.raises(ValueError) as theirs:
            jtwo(n_dev, n_slices, dcn, inner_axis="data")
        assert str(ours.value) == str(theirs.value)


def _jax_bench_fields():
    """The JAX bench's record fields per op: flat and overlap ops on a
    4-wide axis, hierarchical ones on dcn 2 x ici 2."""
    jax = pytest.importorskip("jax", reason="the JAX reference package")
    from jax.sharding import Mesh

    from tpu_hpc.comm import bench as jb

    devs = np.array(jax.devices()[:WORLD])
    recs = jb.CommBenchmark(mesh=Mesh(devs, ("data",)), sizes=BENCH_SIZES,
                            warmup=0, iters=1,
                            ops=jb.OPS + jb.OVERLAP_OPS).run()
    recs += jb.CommBenchmark(mesh=Mesh(devs.reshape(2, 2), ("dcn", "ici")),
                             axis="ici", dcn_axis="dcn", sizes=BENCH_SIZES,
                             warmup=0, iters=1, ops=jb.HIER_OPS).run()
    return recs


def test_bench_writes_csv_and_jsonl_with_jax_fields(world):
    from tpu_hpc_torch.comm import bench

    jax_recs = {r["op"]: r for r in _jax_bench_fields()}
    recs = world["ranks"][0]["bench_records"]
    # Flat and overlap ops first, then the two-tier mesh's, as in JAX.
    ops = bench.OPS + bench.OVERLAP_OPS + bench.HIER_OPS
    assert [r["op"] for r in recs] == list(ops)
    stem = os.path.join(world["workdir"], "bench")
    with open(stem + ".jsonl") as f:
        lines = [json.loads(line) for line in f]
    assert [r["op"] for r in lines] == list(ops)
    with open(stem + ".csv") as f:
        text = f.read()
    meta = [ln for ln in text.splitlines() if ln.startswith("# ")]
    assert any(ln.startswith("# backend: gloo") for ln in meta)
    header = [ln for ln in text.splitlines() if not ln.startswith("#")][0]
    for rec in lines:
        want = jax_recs[rec["op"]]
        assert list(rec) == list(want), rec["op"]
        assert rec["bytes_per_shard"] == want["bytes_per_shard"], rec["op"]
        assert rec["world_size"] == want["world_size"] == WORLD
        assert rec["mean_s"] > 0 and rec["min_s"] <= rec["max_s"]
        assert set(rec) <= set(header.split(","))
    hier = {r["op"]: r for r in lines if r["op"].startswith("hier_")}
    assert hier["hier_all_reduce"]["n_dcn"] == 2
    assert hier["hier_all_reduce"]["dcn_bytes_per_shard"] == \
        jax_recs["hier_all_reduce"]["dcn_bytes_per_shard"]
    # Every row keys the one table of this device set.
    assert len({r["fingerprint"] for r in lines}) == 1


def test_bench_refuses_the_reshard_ops(world):
    from tpu_hpc_torch.comm import bench

    for r in world["ranks"]:
        assert r["reshard_refusal"] == bench.RESHARD_REFUSAL.format(
            ops=["reshard_exchange"])
    assert "The operations modules" in r["reshard_refusal"]
    with pytest.raises(SystemExit):
        bench.main(["--op", "reshard_replicate", "--device", "cpu"])


@pytest.mark.parametrize("n", range(1, 17))
def test_bench_formulas_equal_jax(n):
    """wire_factor, bus_bandwidth_gb_s and two_phase_bytes against the
    JAX bench's for every axis size 1..16 (two-phase splits n = d x i
    over every divisor)."""
    pytest.importorskip("jax", reason="the JAX reference package")
    from tpu_hpc.comm import bench as jb

    from tpu_hpc_torch.comm import bench

    for op in bench.OPS:
        assert bench.wire_factor(op, n) == jb.wire_factor(op, n)
    for op in bench._BUSBW_BASE:
        for nbytes, t in ((4000, 1e-5), (4 * 10**8, 3.2e-3), (8, 0.0)):
            assert bench.bus_bandwidth_gb_s(op, nbytes, n, t) == \
                jb.bus_bandwidth_gb_s(op, nbytes, n, t)
    for d in (k for k in range(1, n + 1) if n % k == 0):
        for op in bench.HIER_OPS:
            assert bench.two_phase_bytes(op, 4096, d, n // d) == \
                jb.two_phase_bytes(op, 4096, d, n // d)
    with pytest.raises(ValueError):
        bench.two_phase_bytes("all_reduce", 4096, 2, 2)


def test_refusals_name_roadmap_items_by_title():
    """Each "not ported" text in the port names its ROADMAP item by a
    title that ROADMAP.md carries, never by a queue number a re-anchor
    renumbers; and the Trainer keeps no list of unported knobs (the
    last two, profile and capture_on_anomaly, are served now)."""
    from tpu_hpc_torch.config import TrainingConfig
    from tpu_hpc_torch.train import trainer

    with open(os.path.join(REPO, "ROADMAP.md")) as f:
        roadmap = f.read()
    titles, numbered = [], []
    for root, _, files in os.walk(os.path.join(REPO, "tpu_hpc_torch")):
        for name in files:
            if name.endswith(".py"):
                with open(os.path.join(root, name)) as f:
                    text = f.read()
                titles += re.findall(r'ROADMAP: \\?"([^"\\]+)\\?"', text)
                numbered += re.findall(r"queue \d+\s+item \d+", text)
    assert numbered == []
    assert titles and all(t in roadmap for t in titles), titles
    # The Trainer refuses no knob of TrainingConfig as unported any
    # more: comm_mode, profile and capture_on_anomaly are all served.
    assert not hasattr(trainer, "UNPORTED")
    assert not hasattr(trainer, "_refuse_unported")
    TrainingConfig(comm_mode="bucketed_overlap", profile=True,
                   capture_on_anomaly=True)


if __name__ == "__main__":
    _world_main(sys.argv[1])
