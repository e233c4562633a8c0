"""The port's gradient sync (bucketed_overlap, hierarchical, auto) on a
4-rank gloo world against flat FSDP and the JAX Trainer's same mode;
the bucket assignment, the planner and the train CLI's comm flags
against the JAX package.

One world of four processes serves the file: the module fixture
launches this file as a script four times with torchrun's variables.
Each rank trains a small Llama (2 layers, dim 64, float32) for three
updates of 8 rows (2 microbatches) from the JAX init's params and the
JAX TokenStream's batches under each case, and writes its losses, its
first update's gradient, its params after three updates and its
bucket launches. The JAX side is the JAX Trainer on 4 of the simulated
devices with the same mode (the same planner decision for the 64 KiB
cases), and jax.grad of the global batch's mean loss on one device.

Tolerances (tests/test_torch_distributed.py's: the sync reorders fp32
sums -- the port syncs the accumulated gradient once, the JAX step each
microbatch): losses rtol 1e-5; gradients atol 1e-6 / rtol 1e-4; params
atol 2e-6 / rtol 1e-5.
"""
import contextlib
import dataclasses
import io
import json
import os
import pickle
import sys
import types

import numpy as np
import pytest
import torch

WORLD, SEQ, BATCH, UPDATES, ACCUM = 4, 16, 8, 3, 2
MODEL = dict(dim=64, n_layers=2, n_heads=4, vocab_size=128, multiple_of=16,
             max_seq_len=SEQ)
TRAIN = dict(epochs=1, steps_per_epoch=UPDATES, global_batch_size=BATCH,
             seed=0, weight_decay=0.1, learning_rate=3e-3, warmup_steps=2,
             grad_accum_steps=ACCUM)
SMALL_BUCKET = 64 * 1024
# case -> (comm_mode, bucket bytes of a planner decision or None, mesh)
CASES = {
    "bucketed": ("bucketed_overlap", None, {"data": 4}),
    "bucketed_64k": ("bucketed_overlap", SMALL_BUCKET, {"data": 4}),
    "hierarchical_64k": ("hierarchical", SMALL_BUCKET, {"dcn": 2, "data": 2}),
}
CLI = ["--device", "cpu", "--dim", "64", "--n-layers", "2", "--n-heads", "4",
       "--vocab", "128", "--multiple-of", "16", "--seq-len", "16",
       "--steps", "2", "--epochs", "1", "--batch", "2",
       "--grad-accum-steps", "2"]
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class Recorder:
    """The configured optimizer, keeping the first update's gradient
    (the mean over microbatches and ranks) as this rank received it."""

    def __init__(self, inner):
        self.inner, self.grads = inner, None
        self.max_grad_norm = inner.max_grad_norm

    def init(self, params, **kw):
        return self.inner.init(params, **kw)

    def apply(self, params, grads, state, norm=None):
        if self.grads is None:
            self.grads = [g.detach().clone() for g in grads]
        return self.inner.apply(params, grads, state, norm)


def _decision(planner_mod, mode, bucket):
    """A planner decision both packages' Trainers take as comm_plan."""
    return planner_mod.CommDecision(
        op="grad_sync", payload_bytes=1, dtype="float32", mode=mode,
        bucket_bytes=bucket, predicted_cost_s=1e-3, source="measured",
        fingerprint="test", table=None, candidates=())


def _port_trainer(case, params, mesh, opt):
    from tpu_hpc_torch.comm import planner
    from tpu_hpc_torch.config import TrainingConfig
    from tpu_hpc_torch.models import llama2
    from tpu_hpc_torch.parallel.plans import P
    from tpu_hpc_torch.train.trainer import Trainer

    mode, bucket, axes = CASES[case] if case in CASES else ("flat", None,
                                                            None)
    cfg = TrainingConfig(**TRAIN, comm_mode="auto" if bucket else mode)
    mcfg = llama2.LlamaConfig(**MODEL, dtype=torch.float32)
    plan = _decision(planner, mode, bucket) if bucket else None
    batch_pspec = P(("dcn", "data")) if axes and "dcn" in axes \
        else P("data")
    specs = None
    if case == "flat":
        from tpu_hpc_torch.parallel import fsdp

        specs = fsdp.param_pspecs(params, axis_size=WORLD, min_size=1000)
    return Trainer(cfg, mesh, llama2.make_forward(mcfg), params,
                   param_pspecs=specs, batch_pspec=batch_pspec,
                   optimizer=opt, comm_plan=plan)


def _world_main(workdir):
    """One rank of the world (run as a script)."""
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor

    from tpu_hpc_torch.comm import overlap, planner
    from tpu_hpc_torch.models import llama2
    from tpu_hpc_torch.obs import schema
    from tpu_hpc_torch.parallel.plans import P
    from tpu_hpc_torch.runtime import (
        MeshSpec,
        build_mesh,
        cleanup_distributed,
        init_distributed,
    )
    from tpu_hpc_torch.train import __main__ as tmain
    from tpu_hpc_torch.train.trainer import make_optimizer, tree_leaves
    from tpu_hpc_torch.config import TrainingConfig

    torch.set_num_threads(1)
    with open(os.path.join(workdir, "inputs.pkl"), "rb") as f:
        params, batches = pickle.load(f)
    info = init_distributed(device="cpu", verbose=False)
    r = info.process_id
    meshes = {"data": build_mesh(MeshSpec(axes={"data": 4}), "cpu"),
              "dcn": build_mesh(MeshSpec(axes={"dcn": 2, "data": 2}), "cpu")}
    out = {}
    for case in (*CASES, "flat"):
        axes = CASES[case][2] if case in CASES else {"data": 4}
        mesh = meshes["dcn" if "dcn" in axes else "data"]
        opt = Recorder(make_optimizer(TrainingConfig(**TRAIN)))
        trainer = _port_trainer(case, params, mesh, opt)
        sync = trainer.grad_sync
        losses, launches, counts = [], [], []
        for b in batches:
            before = sync.allreduces if sync else 0
            m = trainer.train_step(tuple(torch.from_numpy(a) for a in b))
            losses.append(float(m["loss"]))
            if sync is not None:
                counts.append(sync.allreduces - before)
                launches.append(list(sync.launch_log))
        grads = opt.grads
        if case == "flat":
            leaves = tree_leaves(trainer.state.params)
            grads = [DTensor.from_local(g, p.device_mesh, p.placements,
                                        shape=p.shape, stride=p.stride())
                     .full_tensor() for g, p in zip(grads, leaves)]
        out[case] = {
            "losses": losses,
            "grads": [g.numpy() for g in grads],
            "params": trainer.gather_params(),
            "resolved": trainer.comm_mode_resolved,
            "n_buckets": sync.n_buckets if sync else None,
            "buckets": sync.buckets if sync else None,
            "order": sync.order if sync else None,
            "counts": counts,
            "launches": launches,
        }
        if sync is not None:
            sync.remove()
    # make_bucket_sync over a whole gradient tree, both modes: the mean
    # of the ranks' trees (small integers: exact).
    tree = {k: {"w": torch.full((50, 300), float(r + i))}
            for i, k in enumerate(("a", "b", "c"))}
    for mode, mesh, axes in (("bucketed_overlap", meshes["data"], ("data",)),
                             ("hierarchical", meshes["dcn"],
                              ("dcn", "data"))):
        sync = overlap.make_bucket_sync(tree, mesh, axes, mode, 64 * 1024)
        out[f"bucket_sync_{mode}"] = {
            k: v["w"].numpy() for k, v in sync(tree).items()}
    # Replicated params are checked: a rank whose params differ fails
    # every rank.
    ps = [torch.from_numpy(np.array(a)) for a in tree_leaves(params)]
    if r == 2:
        ps[3] = ps[3] + 1.0
    try:
        overlap.verify_replicated(ps, dist.group.WORLD)
        out["replicated_error"] = None
    except RuntimeError as e:
        out["replicated_error"] = str(e)
    # Integer aux is refused; each shard draws its own rng.
    seeds = []

    def fwd(p, ms, batch, rng):
        seeds.append(rng.initial_seed())
        loss = (batch[0].to(torch.float32) * p["w"]).mean()
        return loss, ms, {"n": torch.tensor(3, dtype=torch.int32)}

    w = {"w": torch.ones((), requires_grad=True)}
    vg = overlap.make_synced_value_and_grad(
        fwd, meshes["data"], P("data"), w, "bucketed_overlap")
    try:
        vg(w, {}, (torch.ones(2),), torch.Generator().manual_seed(7))
        out["int_aux_error"] = None
    except ValueError as e:
        out["int_aux_error"] = str(e)
    vg.sync.remove()

    def fwd_float(p, ms, batch, rng):
        seeds.append(rng.initial_seed())
        draw = torch.randn((), generator=rng)
        loss = (batch[0] * p["w"]).mean() + draw * 0.0
        return loss, ms, {"draw": draw}

    w = {"w": torch.ones((), requires_grad=True)}
    vg = overlap.make_synced_value_and_grad(
        fwd_float, meshes["data"], P("data"), w, "bucketed_overlap")
    (loss, (_, aux)), grads = vg(w, {}, (torch.full((2,), float(r)),),
                                 torch.Generator().manual_seed(7))
    out["svag"] = {"loss": float(loss), "draw_mean": float(aux["draw"]),
                   "grad": float(grads["w"]), "seeds": seeds[1:],
                   "allreduces": vg.sync.allreduces}
    vg.sync.remove()
    # run_train through the CLI's entry points: bucketed_overlap, and
    # auto from a measured table that makes buckets win (its comm_plan
    # event into the run log).
    cfg = tmain.bench_model_cfg(SEQ, dim=64, n_layers=2, n_heads=4,
                                vocab_size=128, multiple_of=16)
    run = dict(steps=2, epochs=1, batch=2, grad_accum_steps=2, device="cpu",
               attn="reference")
    out["run_bucketed"] = tmain.run_train(
        cfg, mesh=meshes["data"], comm_mode="bucketed_overlap", **run)
    tables = os.path.join(workdir, "tables")
    fp = planner.fingerprint_mesh(meshes["data"])
    if r == 0:
        t = planner.CostTable(fingerprint=fp.canonical(), digest=fp.digest)
        t.add("all_reduce", "float32", 16 * 1024, 1e-5)
        t.add("all_reduce", "float32", 2 ** 20, 1e-1)
        t.save(tables)
    dist.barrier()
    os.environ["TPU_HPC_COMM_TABLES"] = tables
    metrics = os.path.join(workdir, "auto.jsonl")
    out["run_auto"] = tmain.run_train(cfg, mesh=meshes["data"],
                                      comm_mode="auto", metrics_path=metrics,
                                      **run)
    if r == 0:
        out["auto_events"] = [rec for rec in schema.load_records(metrics)
                              if rec["event"] == "comm_plan"]
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        tmain.main([*CLI, "--comm-mode", "hierarchical"])
    out["cli"] = buf.getvalue()
    with open(os.path.join(workdir, f"rank{r}.pkl"), "wb") as f:
        pickle.dump(out, f)


@pytest.fixture(scope="module")
def jax_inputs():
    jax = pytest.importorskip("jax", reason="the JAX reference package")
    from tpu_hpc.models import datasets as jds
    from tpu_hpc.models import llama2 as jl

    ds = jds.TokenStream(vocab_size=MODEL["vocab_size"], seq_len=SEQ)
    batches = [tuple(np.asarray(a) for a in ds.batch_at(i, BATCH))
               for i in range(UPDATES)]
    jcfg = jl.LlamaConfig(**MODEL, dtype=jax.numpy.float32)
    params = jax.device_get(jl.init_llama(jax.random.key(0), jcfg))
    return params, batches, jcfg


@pytest.fixture(scope="module")
def runs(jax_inputs, tmp_path_factory):
    """The world's results by rank, and the JAX side's by case; the
    world runs while this process computes the JAX side."""
    from tpu_hpc_torch.runtime.sim import launch_local_world, wait_world

    workdir = str(tmp_path_factory.mktemp("sync_world"))
    with open(os.path.join(workdir, "inputs.pkl"), "wb") as f:
        pickle.dump(jax_inputs[:2], f)
    procs = launch_local_world(
        [sys.executable, os.path.abspath(__file__), workdir], WORLD,
        env=dict(os.environ, PYTHONPATH=REPO), cwd=REPO)
    try:
        jax_ = _jax_side(jax_inputs)
    finally:
        logs = wait_world(procs)
    assert all(rc == 0 for rc, _, _ in logs), [err for _, _, err in logs]
    ranks = []
    for r in range(WORLD):
        with open(os.path.join(workdir, f"rank{r}.pkl"), "rb") as f:
            ranks.append(pickle.load(f))
    return ranks, jax_


def _jax_side(jax_inputs):
    import jax
    from jax.sharding import Mesh, PartitionSpec as JP

    from tpu_hpc.comm import planner as jplanner
    from tpu_hpc.config import TrainingConfig as JCfg
    from tpu_hpc.models import llama2 as jl
    from tpu_hpc.train import Trainer as JTrainer

    params, batches, jcfg = jax_inputs
    devs = np.array(jax.devices()[:WORLD])
    out = {}
    for case, (mode, bucket, axes) in CASES.items():
        if "dcn" in axes:
            mesh, bspec = Mesh(devs.reshape(2, 2), ("dcn", "data")), \
                JP(("dcn", "data"))
        else:
            mesh, bspec = Mesh(devs, ("data",)), JP("data")
        cfg = JCfg(**TRAIN, comm_mode="auto" if bucket else mode)
        trainer = JTrainer(
            cfg, mesh, jl.make_forward(jcfg),
            jax.tree.map(jax.numpy.asarray, params), batch_pspec=bspec,
            comm_plan=_decision(jplanner, mode, bucket) if bucket else None)
        losses = []
        for b in batches:
            m = trainer.train_step(tuple(map(jax.numpy.asarray, b)))
            losses.append(float(m["loss"]))
        out[case] = {"losses": losses,
                     "resolved": trainer.comm_mode_resolved,
                     "params": jax.device_get(trainer.state.params)}
    fwd = jl.make_forward(jcfg)
    micro = BATCH // ACCUM

    def mean_loss(p, b):
        return sum(fwd(p, {}, tuple(a[i * micro:(i + 1) * micro] for a in b),
                       jax.random.key(0))[0] for i in range(ACCUM)) / ACCUM

    out["grads"] = jax.device_get(jax.jit(jax.grad(mean_loss))(
        jax.tree.map(jax.numpy.asarray, params),
        tuple(map(jax.numpy.asarray, batches[0]))))
    return out


@pytest.fixture(scope="module")
def ranks(runs):
    return runs[0]


@pytest.fixture(scope="module")
def jax_runs(runs):
    return runs[1]


def _flat_leaves(tree):
    from tpu_hpc_torch.train.trainer import tree_leaves

    return [np.asarray(a) for a in tree_leaves(tree)]


@pytest.mark.parametrize("case", list(CASES))
def test_losses_match_flat_and_jax(ranks, jax_runs, case):
    got = ranks[0][case]["losses"]
    assert len(got) == UPDATES and all(np.isfinite(got))
    for r in ranks[1:]:
        assert r[case]["losses"] == got
    assert ranks[0][case]["resolved"] == CASES[case][0] \
        == jax_runs[case]["resolved"]
    np.testing.assert_allclose(got, ranks[0]["flat"]["losses"], rtol=1e-5)
    np.testing.assert_allclose(got, jax_runs[case]["losses"], rtol=1e-5)


@pytest.mark.parametrize("case", list(CASES))
def test_first_gradient_matches_flat_and_jax(ranks, jax_runs, case):
    """The mean gradient every rank hands the optimizer on the first
    update: the same bits on every rank (replicated), and within the
    tolerance of flat FSDP's gathered gradient and of jax.grad."""
    got = ranks[0][case]["grads"]
    for r in ranks[1:]:
        for a, b in zip(r[case]["grads"], got):
            np.testing.assert_array_equal(a, b)
    flat = ranks[0]["flat"]["grads"]
    want = _flat_leaves(jax_runs["grads"])
    assert len(got) == len(flat) == len(want)
    for g, f, w in zip(got, flat, want):
        np.testing.assert_allclose(g, f, atol=1e-6, rtol=1e-4)
        np.testing.assert_allclose(g, w, atol=1e-6, rtol=1e-4)


@pytest.mark.parametrize("case", list(CASES))
def test_params_after_three_updates_match(ranks, jax_runs, case):
    got = _flat_leaves(ranks[0][case]["params"])
    for ref in (ranks[0]["flat"]["params"], jax_runs[case]["params"]):
        for g, w in zip(got, _flat_leaves(ref)):
            np.testing.assert_allclose(g, w, atol=2e-6, rtol=1e-5)


@pytest.mark.parametrize("case", list(CASES))
def test_allreduces_per_update_and_launch_order(ranks, jax_inputs, case):
    """n_buckets + 1 all-reduces an update (the buckets and the loss),
    the buckets JAX's assignment, one launch order on every rank, and
    from the second update on (the order fixed by the first) at least
    one bucket launched while the last microbatch's backward runs."""
    jax = pytest.importorskip("jax", reason="the JAX reference package")
    from tpu_hpc.comm import overlap as jov

    bucket = CASES[case][1] or 25 * 2 ** 20
    want = jov.assign_buckets(jax.tree.leaves(jax_inputs[0]), bucket)
    first = ranks[0][case]
    assert first["buckets"] == want
    assert first["n_buckets"] == len(want)
    if CASES[case][1]:
        assert len(want) > 1
    assert first["counts"] == [len(want) + 1] * UPDATES
    assert sorted(first["order"]) == list(range(len(want)))
    for r in ranks:
        assert r[case]["order"] == first["order"]
        assert [[b for b, _ in u] for u in r[case]["launches"]] == \
            [first["order"]] * UPDATES
        assert not any(during for _, during in r[case]["launches"][0])
        for update in r[case]["launches"][1:]:
            assert any(during for _, during in update)
    if len(want) > 1:
        # The embedding (bucket 0, reverse order) is ready last.
        assert first["order"][-1] == 0


def test_bucket_assignment_equals_jax_on_the_bench_llama():
    """The bench Llama's leaf shapes (templates, nothing allocated):
    equal to JAX's assignment index for index at caps 1, 4, 25 and 64
    MB; 22 buckets at DDP's 25 MB, the embedding and the output head
    alone in the first two."""
    jax = pytest.importorskip("jax", reason="the JAX reference package")
    import bench
    from tpu_hpc.comm import overlap as jov
    from tpu_hpc.models import llama2 as jl

    from tpu_hpc_torch.comm import overlap
    from tpu_hpc_torch.models import llama2
    from tpu_hpc_torch.train.__main__ import bench_model_cfg
    from tpu_hpc_torch.train.trainer import tree_leaves, tree_paths

    jtree = jax.eval_shape(lambda k: jl.init_llama(k, bench.bench_model_cfg()),
                           jax.random.key(0))
    jleaves = jax.tree.leaves(jtree)
    shapes = llama2.param_shapes(bench_model_cfg())
    leaves = [types.SimpleNamespace(shape=s, dtype=np.float32)
              for s in tree_leaves(shapes)]
    assert [tuple(a.shape) for a in jleaves] == [a.shape for a in leaves]
    for mb in (1, 4, 25, 64):
        assert overlap.assign_buckets(leaves, mb * 2 ** 20) == \
            jov.assign_buckets(jleaves, mb * 2 ** 20)
    b = overlap.assign_buckets(leaves, 25 * 2 ** 20)
    paths = ["/".join(p) for p in tree_paths(shapes)]
    assert len(b) == 22
    assert [paths[i] for i in b[0]] == ["tok_embeddings/embedding"]
    assert [paths[i] for i in b[1]] == ["output/kernel"]


@pytest.mark.parametrize("seed", range(4))
def test_bucket_assignment_equals_jax_on_mixed_dtypes(seed):
    """Random trees of float32, bfloat16 and float16 leaves (a dtype
    change cuts a bucket; an oversized leaf sits alone)."""
    jax = pytest.importorskip("jax", reason="the JAX reference package")
    from tpu_hpc.comm import overlap as jov

    from tpu_hpc_torch.comm import overlap

    rng = np.random.default_rng(seed)
    names = ("float32", "bfloat16", "float16")
    shapes = [tuple(int(s) for s in rng.integers(1, 300, rng.integers(1, 3)))
              for _ in range(40)]
    dts = [names[i] for i in rng.integers(0, 3, 40)]
    jleaves = [jax.ShapeDtypeStruct(s, jax.numpy.dtype(d))
               for s, d in zip(shapes, dts)]
    tleaves = [types.SimpleNamespace(shape=s, dtype=getattr(torch, d))
               for s, d in zip(shapes, dts)]
    for cap in (1, 1000, 40_000, 10 ** 6):
        assert overlap.assign_buckets(tleaves, cap) == \
            jov.assign_buckets(jleaves, cap)
    with pytest.raises(ValueError, match="must be > 0"):
        overlap.assign_buckets(tleaves, 0)


@pytest.mark.parametrize("mode", ["bucketed_overlap", "hierarchical"])
def test_make_bucket_sync_is_the_mean_of_the_ranks(ranks, mode):
    """Three 60 KB leaves in 64 KiB buckets (three buckets): every leaf
    comes back as the mean over the 4 ranks, on every rank."""
    for r in ranks:
        got = r[f"bucket_sync_{mode}"]
        for i, k in enumerate(("a", "b", "c")):
            np.testing.assert_array_equal(got[k], np.full((50, 300),
                                                          1.5 + i))


def test_sync_refuses_what_jax_refuses(ranks):
    """Integer aux leaves (JAX's words), and params that differ across
    ranks (every rank fails)."""
    for r in ranks:
        assert r["int_aux_error"].startswith(
            "manual comm modes cannot return non-inexact aux/model-state "
            "leaves (got int32)")
        assert "params differ" in r["replicated_error"]
    assert "['3']" in ranks[2]["replicated_error"]
    assert "another rank" in ranks[0]["replicated_error"]


def test_synced_value_and_grad_is_global_and_folds_the_shard(ranks):
    """make_synced_value_and_grad: the loss and the gradient are the
    global batch's (rank r's rows are all r: mean 1.5), every rank's the
    same; one bucket + one mean = 2 all-reduces; each rank's rng seed
    folds in its shard index (four distinct seeds, four draws whose
    mean is not one rank's)."""
    seeds = set()
    for r in ranks:
        s = r["svag"]
        assert s["loss"] == pytest.approx(1.5) and s["grad"] == \
            pytest.approx(1.5)
        assert s["allreduces"] == 2
        seeds.update(s["seeds"])
        assert s["draw_mean"] == ranks[0]["svag"]["draw_mean"]
    assert len(seeds) == WORLD


def test_run_train_comm_modes_on_the_gloo_world(ranks):
    """run_train(comm_mode=...) through the CLI's entry points:
    bucketed_overlap on {"data": 4} (the "dp" plan, the comm block), and
    auto resolving to bucketed_overlap from a measured table, its
    decision in the JSON and as a schema-valid comm_plan event."""
    out = ranks[0]["run_bucketed"]
    assert out["comm_mode"] == out["comm_mode_resolved"] == "bucketed_overlap"
    assert out["plan"] == "dp" and out["mesh"] == {"data": 4}
    assert out["layout"] is None and out["comm_plan"] is None
    comm = out["comm"]
    assert comm["allreduces"] == 2 * comm["allreduces_per_update"]
    assert comm["allreduces_per_update"] == comm["n_buckets"] + 1
    assert len(out["losses"]) == 2 and all(np.isfinite(out["losses"]))
    auto = ranks[0]["run_auto"]
    assert auto["comm_mode"] == "auto"
    assert auto["comm_mode_resolved"] == "bucketed_overlap"
    plan = auto["comm_plan"]
    assert plan["source"] == "measured" and plan["bucket_bytes"] < 2 ** 20
    assert auto["comm"]["bucket_bytes"] == plan["bucket_bytes"]
    (event,) = ranks[0]["auto_events"]
    assert event["resolved_from"] == "auto" and event["mode"] == \
        "bucketed_overlap"
    assert event["fingerprint"] == plan["fingerprint"]


def test_cli_hierarchical_on_the_world(ranks):
    lines = [ln for ln in ranks[0]["cli"].splitlines() if ln.startswith("{")]
    (line,) = lines
    out = json.loads(line)
    assert out["mesh"] == {"dcn": 2, "data": 2} and out["plan"] == "dp"
    assert out["comm"]["sync_axes"] == ["dcn", "data"]
    assert out["global_batch"] == 8


def test_hierarchical_on_one_rank_is_refused_in_bench_words(capsys):
    pytest.importorskip("jax", reason="the JAX reference package")
    import bench

    from tpu_hpc_torch.train import __main__ as tmain

    with pytest.raises(ValueError) as theirs:
        bench.comm_mode_mesh("hierarchical", 1, 1)
    with pytest.raises(ValueError) as ours:
        tmain.comm_mode_mesh("hierarchical", 1, 1)
    assert str(ours.value) == str(theirs.value)
    with pytest.raises(SystemExit) as e:
        tmain.main([*CLI, "--comm-mode", "hierarchical"])
    assert e.value.code == 2
    assert str(theirs.value) in capsys.readouterr().err
    import torch.distributed as dist

    assert not dist.is_initialized()


def test_cli_comm_flag_discipline(capsys):
    """bench.py's guards: --comm-table only with auto; a comm mode only
    on the llama workload; a manual mode makes the whole world data."""
    from tpu_hpc_torch.train import __main__ as tmain

    for argv, needle in (
            (["--comm-table", "t.json"], "only consumed by --comm-mode auto"),
            (["--comm-mode", "bucketed_overlap", "--sp-mode", "ring"],
             "with --sp-mode it would silently run flat"),
            (["--comm-mode", "auto", "--pp-schedule", "1f1b"],
             "with --pp-* it would silently run flat"),
            (["--comm-mode", "bucketed_overlap", "--data", "2"],
             "makes the whole world data")):
        with pytest.raises(SystemExit) as e:
            tmain.main([*CLI, *argv])
        assert e.value.code == 2
        assert needle in capsys.readouterr().err


def test_one_process_runs_a_one_rank_world(capsys):
    """A manual mode on one process joins a one-rank world (data: 1) and
    leaves it after; auto on one device plans flat by constraint."""
    import torch.distributed as dist

    from tpu_hpc_torch.train import __main__ as tmain

    assert tmain.main([*CLI, "--comm-mode", "bucketed_overlap"]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["mesh"] == {"data": 1} and out["world_size"] == 1
    assert out["comm"]["allreduces"] == 2 * out["comm"][
        "allreduces_per_update"]
    assert not dist.is_initialized()
    assert tmain.main([*CLI, "--comm-mode", "auto"]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["comm_mode_resolved"] == "flat" and out["comm"] is None
    assert out["comm_plan"]["mode"] == "flat"


@pytest.mark.parametrize("mode", ["bucketed_overlap", "hierarchical"])
def test_manual_modes_refuse_sharded_plans_in_jax_words(mode):
    """A manual mode under an FSDP (or TP) plan is refused with
    validate_grad_sync_mode's words: the JAX package's, with FSDP2's
    collectives where it names GSPMD's."""
    pytest.importorskip("jax", reason="the JAX reference package")
    from tpu_hpc.parallel import fsdp as jfsdp

    from tpu_hpc_torch.config import TrainingConfig
    from tpu_hpc_torch.parallel import fsdp
    from tpu_hpc_torch.train.trainer import Trainer

    params = {"w": torch.zeros(512, 256), "b": torch.zeros(4)}
    specs = fsdp.param_pspecs(params, axis_size=4, min_size=1000)
    fwd = lambda p, ms, b, rng: ((p["w"] ** 2).sum(), ms, {})  # noqa: E731
    with pytest.raises(ValueError) as ours:
        Trainer(TrainingConfig(comm_mode=mode), None, fwd, params,
                param_pspecs=specs, device="cpu")
    jspecs = jfsdp.param_pspecs({"w": np.zeros((512, 256)),
                                 "b": np.zeros(4)}, axis_size=4,
                                min_size=1000)
    with pytest.raises(ValueError) as theirs:
        jfsdp.validate_grad_sync_mode(mode, jspecs)
    assert str(ours.value) == str(theirs.value).replace(
        "GSPMD's fused", "the fused")


# -- the planner ---------------------------------------------------------

FIELDS = (
    ("NVIDIA H100 80GB HBM3", "gpu", 1, 1),
    ("NVIDIA H100 80GB HBM3", "gpu", 4, 1),
    ("NVIDIA H100 80GB HBM3", "gpu", 8, 1),
    ("NVIDIA H100 80GB HBM3", "gpu", 16, 2),
    ("NVIDIA H100 80GB HBM3", "gpu", 32, 4),
    ("cpu", "cpu", 8, 1),
    ("cpu", "cpu", 8, 2),
    ("cpu", "cpu", 6, 1),
)


def _jax_fp(kind, platform, n, slices):
    """The JAX fingerprint of n devices of this kind over ``slices``
    slices (one process: the JAX test process's count)."""
    from tpu_hpc.comm import planner as jp

    devs = [types.SimpleNamespace(device_kind=kind, platform=platform)] * n
    return jp.fingerprint_devices(devs, slices=slices)


@pytest.mark.parametrize("fields", FIELDS)
def test_fingerprint_digest_equals_jax(fields):
    pytest.importorskip("jax", reason="the JAX reference package")
    from tpu_hpc_torch.comm import planner

    kind, platform, n, slices = fields
    jfp = _jax_fp(*fields)
    fp = planner.make_fingerprint(kind, platform, n, 1, slices)
    assert fp.canonical() == jfp.canonical()
    assert fp.digest == jfp.digest
    assert fp.two_tier == jfp.two_tier
    assert fp.tier_sizes() == jfp.tier_sizes()


def _table(mod, fp):
    t = mod.CostTable(fingerprint=fp.canonical(), digest=fp.digest)
    for op, scale in (("all_reduce", 1.0), ("hier_all_reduce", 0.7)):
        for b, s in ((2 ** 12, 2e-5), (2 ** 16, 3e-5), (2 ** 20, 9e-5),
                     (2 ** 24, 1.1e-3), (2 ** 28, 1.8e-2)):
            t.add(op, "float32", b, s * scale if b > 2 ** 16 else s)
    return t


def test_tables_cross_between_the_packages(tmp_path):
    """A table saved by JAX loads in the port and the reverse, with
    equal lookups; the cache path is <digest>.json under
    $TPU_HPC_COMM_TABLES in both."""
    pytest.importorskip("jax", reason="the JAX reference package")
    from tpu_hpc.comm import planner as jp

    from tpu_hpc_torch.comm import planner

    jfp = _jax_fp("NVIDIA H100 80GB HBM3", "gpu", 16, 2)
    fp = planner.make_fingerprint("NVIDIA H100 80GB HBM3", "gpu", 16, 1, 2)
    jpath = _table(jp, jfp).save(str(tmp_path / "jax"))
    ppath = _table(planner, fp).save(str(tmp_path / "port"))
    assert os.path.basename(jpath) == os.path.basename(ppath) == \
        f"{fp.digest}.json"
    ours, theirs = planner.load_table(jpath), jp.load_table(ppath)
    assert ours.to_json() == jp.load_table(jpath).to_json()
    assert theirs.to_json() == planner.load_table(ppath).to_json()
    for nbytes in (1, 3000, 2 ** 16, 123456789, 2 ** 30):
        assert ours.lookup("all_reduce", "float32", nbytes) == \
            theirs.lookup("all_reduce", "float32", nbytes)
    assert planner.load_cached(fp, str(tmp_path / "jax")).digest == fp.digest
    assert planner.ENV_TABLE_DIR == jp.ENV_TABLE_DIR
    assert planner.TABLE_VERSION == jp.TABLE_VERSION == 1


@pytest.mark.parametrize("two_tier", [False, True])
def test_decisions_equal_jax_from_one_table(two_tier):
    """plan and plan_grad_sync from the same measured table: JAX's mode,
    bucket bytes and source exactly, the predicted cost within 1e-12."""
    pytest.importorskip("jax", reason="the JAX reference package")
    from tpu_hpc.comm import planner as jp

    from tpu_hpc_torch.comm import planner

    slices = 2 if two_tier else 1
    jfp = _jax_fp("NVIDIA H100 80GB HBM3", "gpu", 16, slices)
    fp = planner.make_fingerprint("NVIDIA H100 80GB HBM3", "gpu", 16, 1,
                                  slices)
    ours = planner.Planner(fp, _table(planner, fp))
    theirs = jp.Planner(jfp, _table(jp, jfp))
    for nbytes in (100, 2 ** 14, 2 ** 20, 50 * 2 ** 20, 673_000_000):
        a, b = ours.plan("all_reduce", nbytes), theirs.plan("all_reduce",
                                                           nbytes)
        assert (a.mode, a.source, a.bucket_bytes) == (b.mode, b.source,
                                                      b.bucket_bytes)
        assert a.predicted_cost_s == pytest.approx(b.predicted_cost_s,
                                                   rel=1e-12)
        for cap in (None, 4 * 2 ** 20, 25 * 2 ** 20):
            a = ours.plan_grad_sync(nbytes, two_tier=two_tier,
                                    bucket_cap_bytes=cap)
            b = theirs.plan_grad_sync(nbytes, two_tier=two_tier,
                                      bucket_cap_bytes=cap)
            assert (a.mode, a.source, a.bucket_bytes) == (b.mode, b.source,
                                                          b.bucket_bytes)
            assert a.predicted_cost_s == pytest.approx(b.predicted_cost_s,
                                                       rel=1e-12)
            assert a.summary() == b.summary()


def test_fallback_keeps_the_properties_jax_pins():
    """The H100 spec-sheet model: cost strictly increasing in bytes, the
    inter-node tier costlier than NVLink at equal bytes, one crossover
    (flat small, hierarchical large) across two nodes, no hierarchical
    candidate on one node."""
    from tpu_hpc_torch.comm import planner

    fp2 = planner.make_fingerprint("NVIDIA H100 80GB HBM3", "gpu", 16, 16, 2)
    sizes = [2 ** k for k in range(10, 31, 2)]
    for op in ("all_reduce", "all_gather", "hier_all_reduce", "transfer"):
        costs = [planner.model_cost(op, s, fp2) for s in sizes]
        assert all(b > a for a, b in zip(costs, costs[1:])), (op, costs)
    for nbytes in (0, 1024, 2 ** 20, 2 ** 30):
        assert planner.tier_cost("dcn", nbytes) > planner.tier_cost("ici",
                                                                    nbytes)
    pl = planner.Planner(fp2)
    modes = [pl.plan("all_reduce", s).mode
             for s in (4096, 65536, 2 ** 20, 2 ** 24, 2 ** 28)]
    assert modes[0] == "flat" and modes[-1] == "hierarchical"
    assert sum(1 for a, b in zip(modes, modes[1:]) if a != b) == 1
    one = planner.Planner(planner.make_fingerprint(
        "NVIDIA H100 80GB HBM3", "gpu", 8, 8, 1))
    d = one.plan("all_reduce", 2 ** 28)
    assert d.mode == "flat" and [c["mode"] for c in d.candidates] == ["flat"]
    assert d.source == "model"
    # Spec-sheet NVLink 4 (450 GB/s a direction) and one 400 Gb/s NIC.
    assert planner.TIER_MODEL["ici"][1] == 4.5e11
    assert planner.TIER_MODEL["dcn"][1] == 5.0e10


def test_corrupt_table_degrades_and_inventory(tmp_path, caplog):
    from tpu_hpc_torch.comm import planner

    fp = planner.fingerprint_devices(device_type="cpu")
    assert planner.table_inventory(str(tmp_path), device_type="cpu")[
        "status"] == "absent"
    (tmp_path / f"{fp.digest}.json").write_text("{not json")
    with caplog.at_level("WARNING"):
        assert planner.load_cached(fp, str(tmp_path)) is None
    assert "corrupt cost table" in caplog.text
    inv = planner.table_inventory(str(tmp_path), device_type="cpu")
    assert inv["status"] == "stale" and "corrupt" in \
        planner.format_inventory(inv)
    _table(planner, fp).save(str(tmp_path))
    inv = planner.table_inventory(str(tmp_path), device_type="cpu")
    assert inv["status"] == "measured" and inv["entries"] == 10


def test_planner_cli(capsys, tmp_path):
    from tpu_hpc_torch.comm import planner

    assert planner.main(["--explain", "grad_sync", "673000000", "--devices",
                         "4", "--table-dir", str(tmp_path), "--json"]) == 0
    out = json.loads(capsys.readouterr().out)
    assert out["op"] == "grad_sync" and out["source"] == "model"
    assert planner.main(["--sweep", "4096", "268435456", "--devices", "16",
                         "--slices", "2", "--table-dir", str(tmp_path)]) == 0
    rows = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()]
    assert [r["mode"] for r in rows] == ["flat", "hierarchical"]
    assert rows[0]["metric"] == "comm_planner_all_reduce_n4096_pred_ms"
    with pytest.raises(SystemExit):
        planner.main(["--output", "x.jsonl", "--explain", "all_reduce", "1"])


def test_resolve_comm_auto_payload_is_the_param_bytes():
    from tpu_hpc_torch.models import llama2
    from tpu_hpc_torch.train import __main__ as tmain
    from tpu_hpc_torch.train.trainer import tree_leaves

    cfg = tmain.bench_model_cfg(SEQ, dim=64, n_layers=2, n_heads=4,
                                vocab_size=128, multiple_of=16)
    params = llama2.init_llama(torch.Generator().manual_seed(0), cfg, "cpu")
    assert tmain.param_bytes(cfg) == sum(
        p.numel() * p.element_size() for p in tree_leaves(params))
    assert tmain.param_bytes(tmain.bench_model_cfg()) == \
        llama2.count_params(tmain.bench_model_cfg()) * 4
    d = tmain.resolve_comm_auto(tmain.bench_model_cfg(), n_dev=1,
                                device_type="cpu")
    assert d.mode == "flat" and d.payload_bytes == tmain.param_bytes(
        tmain.bench_model_cfg())


if __name__ == "__main__":
    _world_main(sys.argv[1])
