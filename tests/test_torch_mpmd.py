"""The port's MPMD pipeline runtime against the JAX package's, in one
process: ``tpu_hpc_torch.parallel.mpmd`` on four CPU "stages"
(``devices=["cpu"] * 4``, the flash kernels' plain versions in every
stage) and ``tpu_hpc.parallel.mpmd`` on four simulated CPU devices (the
einsum attention), from the same JAX init (``pipe_params_from_numpy``)
and the same numpy batch.

  * parity: the per-microbatch losses of ``loss_and_grads``, the stage
    and edge gradients, and every param after three steps, for the stack
    model and a small Llama (``mpmd_bundle`` of each);
  * inside the port: the losses bit-identical to its own SPMD gpipe
    (``pp.pipelined`` over ``InProcessPipe(4)``, the head applied per
    microbatch), the gradients within JAX's own pin of that comparison,
    the mean loss at ``apply_sequential``'s;
  * every chaos case of tests/test_mpmd.py through both runtimes with
    the same ``TPU_HPC_FAULTS`` spec: the virtual-clock telemetry and
    every count equal exactly, the event streams equal (but for run ids,
    pids, wall times and device strings), each recovered port run
    bit-identical to the clean port run, and the refusals in JAX's words;
  * the programs built once (compile counts pinned after warmup), and the
    train CLI's ``--pp-runtime mpmd`` refusals in bench.py's words.

The JAX runtime compiles about five programs a stage per pipeline; its
programs are pure functions of their operands, so this module compiles
each (bundle, config, stage, device, program) once and hands later
pipelines the same executable (``compile_count`` still counts every
build).

Float32 throughout. Tolerances: losses atol 2e-6; gradients atol 1e-6 /
rtol 1e-4 against JAX, atol 1e-7 / rtol 1e-5 against the port's SPMD
engine (tests/test_mpmd.py's pin); params after three steps atol 1e-5.
"""
import contextlib
import copy
import io
import sys

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax", reason="the JAX reference package")
jnp = jax.numpy

from tpu_hpc import obs as jobs  # noqa: E402
from tpu_hpc.models import llama2 as jl  # noqa: E402
from tpu_hpc.models import llama_pp as jlpp  # noqa: E402
from tpu_hpc.models import pipeline_transformer as jptx  # noqa: E402
from tpu_hpc.parallel import mpmd as jmpmd  # noqa: E402
from tpu_hpc.resilience import faults as jfaults  # noqa: E402
from tpu_hpc_torch import obs as tobs  # noqa: E402
from tpu_hpc_torch.ckpt.integrity import CkptIntegrityError  # noqa: E402
from tpu_hpc_torch.kernels.attention import blockwise_attention  # noqa: E402
from tpu_hpc_torch.models import llama2, llama_pp  # noqa: E402
from tpu_hpc_torch.models import pipeline_transformer as ptx  # noqa: E402
from tpu_hpc_torch.models.losses import cross_entropy  # noqa: E402
from tpu_hpc_torch.obs.schema import load_records, validate_file  # noqa: E402
from tpu_hpc_torch.parallel import mpmd, pp  # noqa: E402
from tpu_hpc_torch.parallel.pp_transport import InProcessPipe  # noqa: E402
from tpu_hpc_torch.resilience import faults  # noqa: E402

LOSS_ATOL, GRAD_ATOL, GRAD_RTOL, PARAM_ATOL = 2e-6, 1e-6, 1e-4, 1e-5
SPMD_ATOL, SPMD_RTOL = 1e-7, 1e-5
S, M, BATCH, SEQ = 4, 4, 8, 16
STACK = dict(vocab_size=64, dim=32, n_heads=2, n_stages=S,
             layers_per_stage=1, max_seq_len=SEQ)
LLAMA = dict(dim=64, n_layers=4, n_heads=4, vocab_size=97, multiple_of=32,
             max_seq_len=SEQ)
CPU4 = ["cpu"] * S
# Record fields that name a run, a process, a wall time or a device.
PROVENANCE = ("time", "run_id", "host", "pid", "from_device", "to_device")


def _flash(q, k, v):
    return blockwise_attention(q, k, v, causal=True, impl="cuda")[0]


def _np(tree):
    return jax.tree.map(lambda a: np.array(a), jax.device_get(tree))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The models here are tiny: one intra-op thread runs them as fast,
    and leaves the other cores to the test files running beside this
    one under xdist."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module", autouse=True)
def jax_programs_once():
    orig = jmpmd.StageWorker._build
    cache = {}

    def build(self, key):
        k = (id(self.bundle), self.cfg, self.sid, self.device, key)
        if k not in cache:
            cache[k] = (self.bundle, orig(self, key))
        else:
            self.compile_count += 1
        return cache[k][1]

    jmpmd.StageWorker._build = build
    yield
    jmpmd.StageWorker._build = orig


@pytest.fixture(scope="module")
def data():
    jcfg = jptx.PipeConfig(**STACK)
    jparams = jax.jit(lambda k: jptx.init_pipeline_transformer(k, jcfg))(
        jax.random.key(0))
    rng = np.random.default_rng(1)
    tokens = rng.integers(0, STACK["vocab_size"], (BATCH, SEQ)).astype(
        np.int32)
    targets = rng.integers(0, STACK["vocab_size"], (BATCH, SEQ)).astype(
        np.int32)
    cfg = ptx.PipeConfig(**STACK)
    params = ptx.pipe_params_from_numpy(_np(jparams), cfg, S)
    return {"jcfg": jcfg, "jparams": jparams, "cfg": cfg, "params": params,
            "jbundle": jptx.mpmd_bundle(jparams, jcfg),
            "tokens": tokens, "targets": targets,
            "batches": [(tokens, targets)] * 3}


@contextlib.contextmanager
def buses(tmp_path):
    """Both packages' event buses onto their own JSONL sinks (flight
    dumps off); yields (jax_sink, port_sink)."""
    sinks = (str(tmp_path / "jax.jsonl"), str(tmp_path / "port.jsonl"))
    prev = (jobs.set_bus(jobs.EventBus(path=sinks[0], flight_dir="")),
            tobs.set_bus(tobs.EventBus(path=sinks[1], flight_dir="")))
    try:
        yield sinks
    finally:
        jobs.set_bus(prev[0])
        tobs.set_bus(prev[1])


def _build(pkg, data, spec=None, events_path=None, **cfg_kw):
    """One pipeline of either package over the stack model."""
    env = {"TPU_HPC_FAULTS": spec} if spec else None
    if pkg == "jax":
        plan = jfaults.fault_plan_from_env(env) if spec else None
        return jmpmd.MpmdPipeline(
            data["jbundle"], jmpmd.MpmdConfig(n_microbatches=M, **cfg_kw),
            fault_plan=plan, events_path=events_path).build(data["tokens"])
    plan = faults.fault_plan_from_env(env) if spec else None
    bundle = ptx.mpmd_bundle(data["params"], data["cfg"], attn_fn=_flash)
    return mpmd.MpmdPipeline(
        bundle, mpmd.MpmdConfig(n_microbatches=M, **cfg_kw), devices=CPU4,
        fault_plan=plan, events_path=events_path).build(data["tokens"])


def _leaves(tree):
    """Leaves in the same order for a JAX tree and a port tree (both
    dicts: sorted keys)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    return [np.asarray(tree.numpy() if isinstance(tree, torch.Tensor)
                       else tree)]


def _close(got, want, atol, rtol=0.0, what=""):
    g, w = _leaves(got), _leaves(want)
    assert len(g) == len(w), what
    for i, (a, b) in enumerate(zip(g, w)):
        np.testing.assert_allclose(a, b, atol=atol, rtol=rtol,
                                   err_msg=f"{what} leaf {i}")


def _same_state(pipe, states):
    return all(
        all(np.array_equal(a, b) for a, b in zip(
            _leaves(pipe.stage_state(s)), _leaves(states[s])))
        for s in range(S))


def _events(path):
    validate_file(path)
    return [{k: v for k, v in r.items() if k not in PROVENANCE}
            for r in load_records(path)]


def _summary(res):
    """A train() summary without its losses, device strings dropped."""
    out = {k: v for k, v in res.items() if k != "losses"}
    out["stage_remaps"] = [{k: v for k, v in r.items()
                            if k not in PROVENANCE}
                           for r in res["stage_remaps"]]
    return out


@pytest.fixture(scope="module")
def clean(data):
    """Both packages' clean pipelines: the parity pass off the fresh
    state, then three steps -- the baseline every chaos case compares
    against."""
    out = {}
    for pkg in ("jax", "port"):
        pipe = _build(pkg, data)
        warm = list(pipe.compile_counts)
        lv, grads, edge = pipe.loss_and_grads(data["tokens"],
                                              data["targets"])
        res = pipe.train(data["batches"])
        out[pkg] = {"pipe": pipe, "warm": warm, "lv": lv, "grads": grads,
                    "edge": edge, "res": res,
                    "states": [pipe.stage_state(s) for s in range(S)]}
    return out


# ---------------------------------------------------------------------------
# Parity: the stack model against JAX and against the port's SPMD engine
# ---------------------------------------------------------------------------

def test_loss_grads_and_params_match_jax(clean):
    j, t = clean["jax"], clean["port"]
    np.testing.assert_allclose(t["lv"], j["lv"], atol=LOSS_ATOL, rtol=0)
    for s in range(S):
        _close(t["grads"][s], _np(j["grads"][s]), GRAD_ATOL, GRAD_RTOL,
               f"stage {s} grads")
    for name in ("embed", "head"):
        _close(t["edge"][name], _np(j["edge"][name]), GRAD_ATOL, GRAD_RTOL,
               f"{name} grads")
    for steps_t, steps_j in zip(t["res"]["losses"], j["res"]["losses"]):
        np.testing.assert_allclose(steps_t, steps_j, atol=LOSS_ATOL, rtol=0)
    for s in range(S):
        _close(t["states"][s], j["states"][s], PARAM_ATOL,
               what=f"stage {s} state after 3 steps")


def test_telemetry_and_compile_counts_equal_jax(clean):
    j, t = clean["jax"], clean["port"]
    assert _summary(t["res"]) == _summary(j["res"])
    # Zero rebuilds: one parity pass and three steps after warmup.
    assert t["pipe"].compile_counts == t["warm"] == j["warm"]
    assert t["pipe"].bubble_fractions == j["pipe"].bubble_fractions


def test_losses_bit_identical_to_the_port_spmd_gpipe(data, clean):
    cfg, params = data["cfg"], data["params"]
    tok = torch.from_numpy(data["tokens"]).long()
    tgt = pp.microbatch(torch.from_numpy(data["targets"]).long(), M)
    fn = pp.pipelined(ptx.make_stage_fn(cfg, _flash), InProcessPipe(S),
                      schedule="gpipe")
    p = ptx._map(lambda a: a.clone().requires_grad_(), params)
    ys = fn(p["stages"], ptx.embed(p, pp.microbatch(tok, M), cfg))
    lv = torch.stack([cross_entropy(ptx.head(p, ys[m], cfg), tgt[m])
                      for m in range(M)])
    assert lv.tolist() == clean["port"]["lv"]
    lv.mean().backward()
    for s in range(S):
        _close(clean["port"]["grads"][s],
               ptx._map(lambda a: a.grad[s], p["stages"]), SPMD_ATOL,
               SPMD_RTOL, f"stage {s}")
    _close(clean["port"]["edge"],
           {"embed": ptx._map(lambda a: a.grad, p["embed"]),
            "head": ptx._map(lambda a: a.grad, p["head"])},
           SPMD_ATOL, SPMD_RTOL, "edges")
    oracle = cross_entropy(ptx.apply_sequential(params, tok, cfg, _flash),
                           torch.from_numpy(data["targets"]).long())
    np.testing.assert_allclose(np.mean(clean["port"]["lv"]), float(oracle),
                               atol=1e-5)


def test_llama_bundle_matches_jax():
    jcfg = jl.LlamaConfig(**LLAMA, dtype=jnp.float32)
    split = jlpp.split_params(jl.init_llama(jax.random.key(0), jcfg), jcfg,
                              S)
    rng = np.random.default_rng(2)
    tok = rng.integers(0, LLAMA["vocab_size"], (BATCH, SEQ + 1)).astype(
        np.int32)
    batch = (tok[:, :-1], tok[:, 1:])
    jpipe = jmpmd.MpmdPipeline(jlpp.mpmd_bundle(split, jcfg),
                               jmpmd.MpmdConfig(n_microbatches=M)
                               ).build(batch[0])
    cfg = llama2.LlamaConfig(**LLAMA, dtype=torch.float32)
    tsplit = llama_pp.pipe_params_from_numpy(_np(split), cfg, S)
    tpipe = mpmd.MpmdPipeline(
        llama_pp.mpmd_bundle(tsplit, cfg, attn_fn=_flash),
        mpmd.MpmdConfig(n_microbatches=M), devices=CPU4).build(batch[0])
    assert tpipe.compile_counts == jpipe.compile_counts
    runs = [p.loss_and_grads(*batch) + (p.train([batch] * 2),)
            for p in (jpipe, tpipe)]
    (jlv, jg, je, jres), (tlv, tg, te, tres) = runs
    np.testing.assert_allclose(tlv, jlv, atol=LOSS_ATOL, rtol=0)
    for s in range(S):
        _close(tg[s], _np(jg[s]), GRAD_ATOL, GRAD_RTOL, f"stage {s}")
    _close(te, _np(je), GRAD_ATOL, GRAD_RTOL, "edges")
    np.testing.assert_allclose(tres["losses"], jres["losses"],
                               atol=LOSS_ATOL, rtol=0)
    for s in range(S):
        _close(tpipe.stage_state(s), jpipe.stage_state(s), PARAM_ATOL,
               what=f"stage {s} state")
    assert _summary(tres) == _summary(jres)


# ---------------------------------------------------------------------------
# Chaos: every case of tests/test_mpmd.py through both runtimes
# ---------------------------------------------------------------------------

def _train(pipe, data):
    return pipe.train(data["batches"])


def _wedged(pipe, data):
    pipe.workers[2].wedged = True
    return {"loss0": pipe.run_step(0, data["tokens"], data["targets"]),
            "recoveries": list(pipe.recoveries)}


def _flapping(pipe, data):
    pipe.workers[1].wedged = True
    orig = pipe._new_worker

    def wedged_worker(sid):
        w = orig(sid)
        w.wedged = True  # the replacement flaps too
        return w

    pipe._new_worker = wedged_worker
    try:
        pipe.run_step(0, data["tokens"], data["targets"])
    except (mpmd.StageBudgetExhausted, jmpmd.StageBudgetExhausted) as e:
        return {"stage": e.stage, "kind": e.kind, "budget": e.budget,
                "exit_code": e.exit_code, "msg": str(e)}
    raise AssertionError("the flapping stage never exhausted its budget")


def _unfired(pipe, data):
    try:
        pipe.train(data["batches"][:1])
    except RuntimeError as e:
        return {"msg": str(e)}
    raise AssertionError("an unfired slice fault passed")


# name: (spec, MpmdConfig overrides, what drives it, the stages that keep
# their worker objects)
CHAOS = {
    "kill": ("stage_kill_at=1:1", {}, _train, (0, 2, 3)),
    "nan": ("stage_nan_at=2:1", {}, _train, (0, 1, 3)),
    "straggler": ("stage_straggler=1:8", {}, _train, (0, 1, 2, 3)),
    "slice": ("slice_down_at_step=1,slice_up_at_step=2", {}, _train,
              (0, 1, 2)),
    "wedged": (None, {}, _wedged, (0, 1, 3)),
    "flapping": (None, {"max_stage_restarts": 1}, _flapping, None),
    "unfired_slice": ("slice_down_at_step=99", {}, _unfired, None),
}


@pytest.fixture(scope="module")
def chaos(data, tmp_path_factory):
    """Each chaos case once per package: (output, pipe, workers at build,
    compile counts at build, events)."""
    out = {}
    for name, (spec, kw, drive, _) in CHAOS.items():
        tmp = tmp_path_factory.mktemp(name)
        runs = {}
        with buses(tmp) as sinks:
            for pkg, sink in zip(("jax", "port"), sinks):
                pipe = _build(pkg, data, spec, events_path=sink, **kw)
                before = (list(pipe.workers), list(pipe.compile_counts))
                runs[pkg] = (drive(pipe, data), pipe, *before)
        out[name] = {pkg: runs[pkg] + (_events(sink),)
                     for pkg, sink in zip(("jax", "port"), sinks)}
    return out


@pytest.mark.parametrize("name", sorted(CHAOS))
def test_chaos_telemetry_and_events_equal_jax(chaos, name):
    jout, jpipe, _, _, jev = chaos[name]["jax"]
    tout, tpipe, _, _, tev = chaos[name]["port"]
    assert tev == jev
    assert tpipe.clock_s == jpipe.clock_s
    assert tpipe.compile_counts == jpipe.compile_counts
    if name in ("flapping", "unfired_slice"):
        assert tout == jout
    elif name == "wedged":
        np.testing.assert_allclose(tout["loss0"], jout["loss0"],
                                   atol=LOSS_ATOL, rtol=0)
        assert tout["recoveries"] == jout["recoveries"]
    else:
        assert _summary(tout) == _summary(jout)
        np.testing.assert_allclose(tout["losses"], jout["losses"],
                                   atol=LOSS_ATOL, rtol=0)


@pytest.mark.parametrize("name", ["kill", "nan", "straggler", "slice",
                                  "wedged"])
def test_chaos_port_recovers_bit_identical_and_stage_local(chaos, clean,
                                                           name):
    out, pipe, workers, counts, events = chaos[name]["port"]
    base = clean["port"]
    if name == "wedged":
        assert out["loss0"] == base["res"]["losses"][0]
        assert not pipe.workers[2].wedged
    else:
        assert out["losses"] == base["res"]["losses"]
        assert _same_state(pipe, base["states"])
    keep = CHAOS[name][3]
    for s in range(S):
        if s in keep:
            assert pipe.workers[s] is workers[s], s
            assert pipe.compile_counts[s] == counts[s], s
        else:
            assert pipe.workers[s] is not workers[s], s
    if name == "kill":
        assert out["redispatched"] == M
        assert out["recoveries"][0]["reason"] == "crash"
    if name == "nan":
        assert out["poisoned_windows"] == [{
            "stage": 2, "step": 1, "microbatch": 0, "phase": "forward"}]
        assert out["stage_rollbacks"] == {2: 1}
    if name == "straggler":
        assert out["stragglers"].get(1, 0) >= 1
        assert out["bubble_fraction"] > base["res"]["bubble_fraction"]
    if name == "slice":
        assert pipe.devices[S - 1] is pipe._home_devices[S - 1]
        assert [e["event"] for e in events if e["event"] in (
            "stage_down", "stage_remap")] == ["stage_remap"] * 2


def test_recovery_from_an_older_snapshot_is_not_bit_identical(data, clean):
    """The control: the killed stage restored from the step-0 snapshot
    instead of its step-start one ends elsewhere."""
    pipe = _build("port", data, "stage_kill_at=2:1")
    first = pipe.snapshots[2]
    rebuild = pipe._rebuild

    def stale(sid):
        pipe.snapshots[sid] = first
        return rebuild(sid)

    pipe._rebuild = stale
    res = pipe.train(data["batches"])
    assert res["recoveries"][0]["stage"] == 2
    assert res["losses"][1:] != clean["port"]["res"]["losses"][1:]


def test_corrupt_snapshot_fails_restore_loudly(clean):
    pipe = clean["port"]["pipe"]
    snap = copy.deepcopy(pipe.snapshots[1])  # corrupt a COPY only
    leaf = pp._flatten(snap["state"])[1][0]
    leaf.view(-1)[0] += 1.0
    with pytest.raises(CkptIntegrityError, match="stage 1"):
        pipe.workers[1].load_state(snap)
    pipe.workers[1].load_state(pipe.snapshots[1])  # the intact one loads


def _same_error(exc, jax_call, port_call):
    with pytest.raises(exc) as jerr:
        jax_call()
    with pytest.raises(exc) as perr:
        port_call()
    assert str(perr.value) == str(jerr.value)


@pytest.mark.parametrize("spec", [
    "stage_kill_at=9:1", "stage_straggler=7:2.0", "slice_up_at_step=1"])
def test_vacuous_stage_faults_refused_like_jax(data, spec):
    _same_error(ValueError, lambda: _build("jax", data, spec),
                lambda: _build("port", data, spec))


def test_needs_one_device_per_stage(data):
    jbundle = jptx.mpmd_bundle(data["jparams"], data["jcfg"])
    bundle = ptx.mpmd_bundle(data["params"], data["cfg"])
    cfg_j, cfg_t = (m.MpmdConfig(n_microbatches=M) for m in (jmpmd, mpmd))
    _same_error(ValueError,
                lambda: jmpmd.MpmdPipeline(jbundle, cfg_j,
                                           devices=jax.devices()[:2]),
                lambda: mpmd.MpmdPipeline(bundle, cfg_t,
                                          devices=["cpu"] * 2))
    if not torch.cuda.is_available():
        # No card: the default placement finds none and refuses; it never
        # falls back to the CPU.
        with pytest.raises(ValueError, match="0 visible"):
            mpmd.MpmdPipeline(bundle, cfg_t)


def test_budgets_and_exit_codes_equal_jax(monkeypatch):
    for m in (jmpmd, mpmd):
        sup = m.StageSupervisor(max_restarts=2, max_rollbacks=1)
        assert [sup.charge(0, "restart"), sup.charge(0, "restart"),
                sup.charge(1, "restart"), sup.charge(3, "rollback")] \
            == [1, 2, 1, 1]
    got = []
    for m in (jmpmd, mpmd):
        sup = m.StageSupervisor(max_restarts=0, max_rollbacks=0)
        for kind in ("restart", "rollback"):
            with pytest.raises(m.StageBudgetExhausted) as e:
                sup.charge(2, kind)
            got.append((str(e.value), e.value.exit_code, e.value.kind))
        with pytest.raises(ValueError) as e:
            sup.charge(0, "bogus")
        got.append(str(e.value))
    assert got[:3] == got[3:]
    assert [got[0][1], got[1][1]] == [1, 77]
    for value, want in (("7", 7), ("", 3), ("x", 3)):
        monkeypatch.setenv(mpmd.ENV_MAX_STAGE_RESTARTS, value)
        assert mpmd.MpmdConfig(n_microbatches=2).max_stage_restarts \
            == jmpmd.MpmdConfig(n_microbatches=2).max_stage_restarts == want
    for kw in (dict(n_microbatches=0), dict(n_microbatches=2,
                                            heartbeat_timeout_s=1.0),
               dict(n_microbatches=2, max_stage_restarts=-1),
               dict(n_microbatches=2, max_stage_rollbacks=-1)):
        _same_error(ValueError, lambda: jmpmd.MpmdConfig(**kw),
                    lambda: mpmd.MpmdConfig(**kw))


def test_supervisor_exports_stage_budget(tmp_path):
    from tpu_hpc_torch.resilience.supervisor import Supervisor

    probe = ("import os, sys; sys.exit(0 if os.environ.get("
             "'TPU_HPC_MAX_STAGE_RESTARTS') == '2' else 3)")
    assert Supervisor([sys.executable, "-c", probe], max_restarts=0,
                      max_stage_restarts=2, log_dir=str(tmp_path)).run() == 0
    with pytest.raises(ValueError, match="max_stage_restarts"):
        Supervisor(["true"], max_stage_restarts=-1)


@pytest.mark.parametrize("spec", [
    "stage_kill_at=1:2,stage_straggler=0:2.5", "stage_kill_at=3",
    "stage_straggler=1:0", "stage_nan_at=a:1"])
def test_stage_fault_parse_equals_jax(spec):
    env = {"TPU_HPC_FAULTS": spec}
    try:
        want = jfaults.fault_plan_from_env(env)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            faults.fault_plan_from_env(env)
        assert str(got.value) == str(e)
        return
    plan = faults.fault_plan_from_env(env)
    assert (plan.stage_kill_at, plan.stage_straggler,
            plan.stage_fault_keys()) == (want.stage_kill_at,
                                         want.stage_straggler,
                                         want.stage_fault_keys())


# ---------------------------------------------------------------------------
# The train CLI's MPMD row
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def bench():
    import importlib.util
    import pathlib

    path = pathlib.Path(__file__).resolve().parent.parent / "bench.py"
    spec = importlib.util.spec_from_file_location("bench_cli_torch_mpmd",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _cli_error(main, argv) -> str:
    err = io.StringIO()
    with contextlib.redirect_stderr(err), pytest.raises(SystemExit) as e:
        main(argv)
    assert e.value.code == 2
    return err.getvalue().strip().splitlines()[-1].split("error: ", 1)[1]


@pytest.mark.parametrize("bench_argv,port_argv", [
    (["--workload", "llama"], ["--comm-mode", "bucketed_overlap"]),
    (["--workload", "llama-sp"], ["--sp-mode", "ring"]),
    (["--workload", "unet"], ["--workload", "unet"]),
    (["--workload", "llama-long"], ["--workload", "llama-long"]),
    (["--workload", "pp"], []),
    (["--workload", "pp", "--pp-schedule", "interleaved"],
     ["--pp-schedule", "interleaved"]),
    (["--workload", "pp", "--pp-schedule", "gpipe", "--pp-backward",
      "stash"], ["--pp-schedule", "gpipe", "--pp-backward", "stash"]),
])
def test_cli_refusals_are_bench_words(bench, bench_argv, port_argv):
    from tpu_hpc_torch.train.__main__ import main

    want = _cli_error(bench.main, [*bench_argv, "--pp-runtime", "mpmd"])
    got = _cli_error(main, ["--device", "cpu", *port_argv, "--pp-runtime",
                            "mpmd"])
    assert got == want


def test_cli_refuses_what_it_does_not_consume(monkeypatch):
    from tpu_hpc_torch.train.__main__ import main

    base = ["--device", "cpu", "--pp-runtime", "mpmd", "--pp-schedule",
            "gpipe"]
    for extra, needle in ((["--guard-mode", "skip"], "stage-local"),
                          (["--grad-accum-steps", "2"], "accumulate"),
                          (["--batch", "32"], "--batch is not consumed"),
                          (["--epochs", "2"], "--epochs is not consumed"),
                          (["--moments-dtype", "float32"],
                           "--moments-dtype is not consumed"),
                          (["--comm-table", "t.json"],
                           "--comm-table is not consumed"),
                          (["--supervise", "1"],
                           "--supervise is not consumed"),
                          (["--model", "2"], "PP x TP")):
        assert needle in _cli_error(main, [*base, *extra])
    monkeypatch.setenv("WORLD_SIZE", "4")
    assert "one card per stage" in _cli_error(main, base)


def test_cli_runs_the_row_on_the_cpu(tmp_path):
    import json

    from tpu_hpc_torch.train import __main__ as tmain

    small = ["--dim", "32", "--n-layers", "4", "--n-heads", "2", "--vocab",
             "64", "--seq-len", "16", "--steps", "2", "--pp-microbatches",
             "4", "--pp-microbatch-size", "2"]
    out = io.StringIO()
    metrics = str(tmp_path / "run.jsonl")
    with contextlib.redirect_stdout(out):
        rc = tmain.main(["--device", "cpu", "--pp-runtime", "mpmd",
                         "--pp-schedule", "gpipe", "--metrics", metrics,
                         *small])
    assert rc == 0
    rec = json.loads(out.getvalue().strip().splitlines()[-1])
    assert rec["metric"] == "pp_mpmd_tokens_per_s_per_chip"
    assert rec["n_stages"] == 1 and rec["recompiles"] == 0
    assert rec["updates"] == 3 and all(np.isfinite(rec["losses"]))
    assert [r["event"] for r in load_records(metrics)].count(
        "pipeline_bubble") == 3
    # Four CPU stages through the API, the stage faults armed from the
    # environment's spec: the -chaos record of a recovered run.
    cfg = tmain.bench_model_cfg(16, dim=32, n_layers=4, n_heads=2,
                                vocab_size=64)
    args = tmain.PipeArgs(schedule="gpipe", model="llama", microbatches=4,
                          microbatch_size=2)
    plan = faults.fault_plan_from_env(
        {"TPU_HPC_FAULTS": "stage_kill_at=2:1"})
    rec = tmain.run_mpmd(cfg, args, ["cpu"] * 4, steps=2, fault_plan=plan)
    assert rec["metric"] == "pp_mpmd-llama-chaos_tokens_per_s_per_chip"
    assert rec["faults"] == "stage_kill_at"
    assert (rec["n_stages"], rec["stage_restarts"], rec["redispatched"],
            rec["recovery_mttr_s"], rec["recompiles"]) == (4, 1, 4, 5.0, 0)
    assert rec["device"]["count"] == 1

