"""The port's causal tracing against the JAX package's, on the CPU.

``tpu_hpc_torch.obs.trace`` ports ``tpu_hpc.obs.trace``: the analyzer
(``analyze``, ``chrome_trace``, ``format_analysis``, ``main``) is a
framework-free copy, so one record list -- a seeded ``colocate``
loadgen run with a capture -- gives the same report, the same Perfetto
file and the same ``--json`` line through both packages.
``AnomalyCapture`` keeps the JAX contract (each case of
``tests/test_trace.py``'s ``TestAnomalyCapture``), with its profiler
window on ``torch.profiler`` and the busy path the JAX one swallows.
Port and JAX load harnesses over the same TINY model capture the same
stall on the virtual clock (reason, tick trace id, counts, TTFT
decompositions); the port Trainer's straggler fault captures once,
keyed to the first stall; ``--capture-dir`` and ``FleetHarness``
(``tests/test_torch_fleet.py``) are wired as in the JAX package.
Wall-clock quantities are never compared; virtual-clock ones exactly.
"""
import json
import os

import pytest
import torch

jax = pytest.importorskip("jax", reason="the JAX reference package")
jnp = jax.numpy

from tpu_hpc import loadgen as jlg
from tpu_hpc import obs as jobs
from tpu_hpc.models import llama2 as jl
from tpu_hpc.obs import trace as jtrace
from tpu_hpc.obs.schema import load_records as jload
from tpu_hpc.runtime import MeshSpec, build_mesh
from tpu_hpc.serve import PagedConfig as JaxPagedConfig
from tpu_hpc.serve import PagedEngine as JaxPagedEngine
from tpu_hpc.serve import ServeConfig as JaxServeConfig
from tpu_hpc_torch import loadgen as tlg
from tpu_hpc_torch import obs as tobs
from tpu_hpc_torch.models import llama2 as tl
from tpu_hpc_torch.obs import trace as ttrace
from tpu_hpc_torch.obs.schema import load_records
from tpu_hpc_torch.profiling import profiler_busy
from tpu_hpc_torch.serve import (
    PagedConfig,
    PagedEngine,
    ServeConfig,
    params_from_numpy,
)

JAX_TINY = jl.LlamaConfig(
    dim=64, n_layers=2, n_heads=4, n_kv_heads=2, vocab_size=128,
    multiple_of=16, max_seq_len=64, dtype=jnp.float32,
)
TINY = tl.LlamaConfig(
    dim=64, n_layers=2, n_heads=4, n_kv_heads=2, vocab_size=128,
    multiple_of=16, max_seq_len=64, dtype=torch.float32,
)
SERVE = dict(slots=4, max_seq_len=48, prefill_buckets=(8, 16))
PAGED = dict(block_size=4, num_blocks=48, prefill_chunk=8)
MAX_PROMPT, MAX_NEW = 16, 6
RUN_ID = "trace-test"
LIFECYCLE = (
    "trace_ctx", "lg_arrival", "lg_admit", "lg_first_token",
    "lg_finish", "lg_shed", "admission", "request",
)
SIDES = {"port": (tobs, tlg, load_records), "jax": (jobs, jlg, jload)}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def engines():
    """One warmed TINY paged engine a side (the JAX init carried
    across), shared by the module: the file's one JAX bring-up."""
    jt = jl.init_llama(jax.random.key(0), JAX_TINY)
    tt = params_from_numpy(jax.device_get(jt), TINY, "cpu")
    mesh = build_mesh(MeshSpec(axes={"data": 1}), devices=jax.devices()[:1])
    jeng = JaxPagedEngine(jt, JAX_TINY, JaxServeConfig(**SERVE), mesh,
                          JaxPagedConfig(**PAGED))
    jeng.warmup()
    teng = PagedEngine(tt, TINY, ServeConfig(**SERVE), "cpu",
                       PagedConfig(**PAGED))
    teng.warmup()
    return {"jax": jeng, "port": teng}


@pytest.fixture()
def scoped_obs(tmp_path):
    """Fresh port bus + registry per test; flight dir armed so capture
    dumps have a home."""
    bus = tobs.EventBus(path=None, run_id=RUN_ID, flight_dir=str(tmp_path))
    reg = tobs.MetricsRegistry()
    prev_bus, prev_reg = tobs.set_bus(bus), tobs.set_registry(reg)
    yield bus, reg
    tobs.set_bus(prev_bus)
    tobs.set_registry(prev_reg)


def _loadgen(engines, side, name, tmp_path, capture=True, n=24):
    """One seeded loadgen run on ``side`` under a fresh bus (flight dir
    off: the capture's dump lands in its own dir) and registry."""
    obs, lg, load = SIDES[side]
    engine = engines[side]
    engine.reset_pool(force=True)
    bus = obs.EventBus(path=None, run_id=RUN_ID, flight_dir="")
    prev_bus, prev_reg = obs.set_bus(bus), obs.set_registry(
        obs.MetricsRegistry())
    cap_dir = str(tmp_path / f"{side}-{name}-capture")
    cap = obs.AnomalyCapture(cap_dir, n_steps=3) if capture else None
    path = tmp_path / f"{side}-{name}.jsonl"
    try:
        sc = lg.build_scenario(name, seed=7, n_requests=n,
                               vocab_size=TINY.vocab_size,
                               max_prompt=MAX_PROMPT, max_new=MAX_NEW)
        h = lg.LoadHarness(engine, sc, metrics_path=str(path),
                           faults=lg.parse_faults(""), capture=cap)
        summary = h.run()
    finally:
        obs.set_bus(prev_bus)
        obs.set_registry(prev_reg)
    return {"summary": summary, "records": load(str(path)), "path": path,
            "cap": cap, "cap_dir": cap_dir,
            "streams": dict(h.batcher.results)}


@pytest.fixture(scope="module")
def colocate(engines, tmp_path_factory):
    tmp = tmp_path_factory.mktemp("colocate")
    return {side: _loadgen(engines, side, "colocate", tmp)
            for side in SIDES}


def _assert_complete_traces(records, expect_requests):
    """tests/test_trace.py's acceptance bundle: every lifecycle event
    trace-tagged, zero orphan spans, >= 95% of TTFT attributed."""
    life = [r for r in records if r["event"] in LIFECYCLE
            and (r["event"] != "admission" or "rid" in r)]
    assert life, "no lifecycle events in the run log"
    assert not [r for r in life if "trace_id" not in r]
    rep = ttrace.analyze(records)
    assert rep["orphan_spans"] == 0
    req = rep["requests"]
    assert req["count"] == expect_requests
    assert req["complete"] + req["shed"] == expect_requests
    for q in ("p50", "p95", "p99"):
        cp = req["ttft_critical_path"][q]
        assert cp["attributed"] >= 0.95, (q, cp)
        assert cp["dominant"] in cp["phases_ms"]
    return rep


# ---------------------------------------------------------------------
# the analyzer: one record list through both packages
# ---------------------------------------------------------------------
def test_analyzer_matches_jax_on_a_colocate_run(colocate):
    records = colocate["port"]["records"]
    rep = ttrace.analyze(records)
    assert rep == jtrace.analyze(records)
    assert ttrace.chrome_trace(records) == jtrace.chrome_trace(records)
    assert ttrace.format_analysis(rep) == jtrace.format_analysis(rep)
    got = ttrace.build_traces(records)
    want = jtrace.build_traces(records)
    assert got["orphan_spans"] == want["orphan_spans"] == 0
    assert {k: v.ttft_breakdown() for k, v in got["requests"].items()} \
        == {k: v.ttft_breakdown() for k, v in want["requests"].items()}
    assert [c["reason"] for c in rep["captures"]] == ["stall"]
    _assert_complete_traces(records, 24)


def test_cli_matches_jax(colocate, tmp_path, capsys):
    """``--json`` and ``--chrome`` over the run log plus the capture's
    flight dump: the same line and the same Perfetto file; the text
    report too; exit 2 on missing and empty input."""
    run = colocate["port"]
    args = [str(run["path"]), "--flight-dir", run["cap_dir"]]
    out = {}
    for name, mod in (("port", ttrace), ("jax", jtrace)):
        chrome = tmp_path / f"{name}.chrome.json"
        assert mod.main([*args, "--json", "--chrome", str(chrome)]) == 0
        line = capsys.readouterr().out
        assert mod.main(args) == 0
        text = capsys.readouterr().out
        out[name] = (line, chrome.read_text(), text)
    assert out["port"] == out["jax"]
    rep = json.loads(out["port"][0])
    for key in ("schema_version", "run_id", "n_records", "orphan_spans",
                "requests", "steps", "captures"):
        assert key in rep
    assert rep["orphan_spans"] == 0 and rep["run_id"] == RUN_ID
    assert json.loads(out["port"][1])["traceEvents"]
    assert "## Anomaly captures" in out["port"][2]
    empty = tmp_path / "empty.jsonl"
    empty.write_text("")
    for path in (str(tmp_path / "nope.jsonl"), str(empty)):
        assert ttrace.main([path]) == 2
    capsys.readouterr()


def _stamped(rec):
    return tobs.stamp(rec, run_id="r", host="h", pid=1)


def test_orphan_spans_and_step_traces_match_jax():
    records = [
        _stamped({"event": "lg_arrival", "rid": "a", "tenant": "t",
                  "arrival_ms": 0.0, "trace_id": "r:req:a"}),
        _stamped({"event": "span", "name": "prefill_chunk",
                  "dur_s": 0.01, "trace_id": "r:req:a"}),
        _stamped({"event": "span", "name": "prefill_chunk",
                  "dur_s": 0.01, "trace_id": "r:req:GHOST"}),
        _stamped({"event": "span", "name": "compute", "dur_s": 0.5,
                  "trace_id": "r:step:3", "step": 3, "t_mono": 2.0}),
        _stamped({"event": "span", "name": "data", "dur_s": 0.1,
                  "trace_id": "r:step:3", "step": 3, "t_mono": 2.1}),
        _stamped({"event": "stall", "step": 3, "step_s": 0.6,
                  "watermark_s": 0.1, "ratio": 6.0,
                  "trace_id": "r:step:3"}),
    ]
    assert ttrace.build_traces(records)["orphan_spans"] == 1
    rep = ttrace.analyze(records)
    assert rep == jtrace.analyze(records)
    assert rep["steps"]["critical_path"]["p95"]["dominant"] == "compute"
    assert rep["steps"]["stalls"] == 1
    assert ttrace.chrome_trace(records) == jtrace.chrome_trace(records)


def test_merge_dedupes_sink_and_flight_copies(scoped_obs, tmp_path,
                                              capsys):
    """One record in both the sink and the ring (and two dumps of the
    ring) counts once."""
    bus, _ = scoped_obs
    run = tmp_path / "run.jsonl"
    with tobs.activate(f"{RUN_ID}:step:5"):
        tobs.emit_span("compute", 0.5, bus=bus, step=5, sink=str(run))
    bus.dump_flight("dedup_a")
    bus.dump_flight("dedup_b")
    assert ttrace.main([str(run), "--flight-dir", str(tmp_path),
                        "--json"]) == 0
    out = json.loads(capsys.readouterr().out)
    assert out["steps"]["critical_path"]["p95"]["phases_ms"] == {
        "compute": 500.0}


# ---------------------------------------------------------------------
# AnomalyCapture (tests/test_trace.py's TestAnomalyCapture on the port)
# ---------------------------------------------------------------------
class TestAnomalyCapture:
    def test_one_shot_bundle_and_rearm(self, scoped_obs, tmp_path):
        cap = tobs.AnomalyCapture(str(tmp_path / "prof"), n_steps=2)
        sink = str(tmp_path / "cap.jsonl")
        rec = cap.trigger("stall", trace_id=f"{RUN_ID}:step:9", step=9,
                          sink=sink)
        assert rec is not None and rec["event"] == "capture_triggered"
        assert rec["trace_id"] == f"{RUN_ID}:step:9"
        assert rec["flight_path"] and os.path.exists(rec["flight_path"])
        assert ".9." in os.path.basename(rec["flight_path"])
        # The profiler window opened at the trigger (a CPU trace here).
        assert rec["profile_dir"] == str(tmp_path / "prof" / "capture1")
        assert rec["n_steps"] == 2 and profiler_busy()
        assert cap.trigger("stall", step=10, sink=sink) is None
        assert cap.captures == 1 and not cap.armed
        cap.step(10)
        assert cap._prof is not None  # [9, 11): still open
        cap.step(11)
        assert cap._prof is None and not profiler_busy()
        assert os.listdir(rec["profile_dir"]) == ["rank0.step9.pt.trace.json"]
        cap.close()
        cap.rearm()
        assert cap.armed
        kinds = [r["event"] for r in load_records(sink)]
        assert kinds.count("capture_triggered") == 1

    def test_flight_dump_falls_back_to_capture_dir(self, tmp_path):
        bus = tobs.EventBus(path=None, run_id="nofd", flight_dir="")
        prev = tobs.set_bus(bus)
        try:
            cap = tobs.AnomalyCapture(str(tmp_path / "prof"), n_steps=1)
            rec = cap.trigger("stall", trace_id="nofd:tick:3",
                              arm_profiler=False)
        finally:
            tobs.set_bus(prev)
        assert rec["flight_path"].startswith(str(tmp_path / "prof"))
        assert os.path.exists(rec["flight_path"])
        assert ".3." in os.path.basename(rec["flight_path"])

    def test_rearm_never_renumbers_into_old_bundle(self, scoped_obs,
                                                   tmp_path):
        cap = tobs.AnomalyCapture(str(tmp_path / "prof"), n_steps=1)
        r1 = cap.trigger("stall", step=1)
        cap.close()
        cap.rearm()
        r2 = cap.trigger("stall", step=2)
        cap.close()
        assert cap.captures == 2
        assert [r1["profile_dir"], r2["profile_dir"]] == [
            str(tmp_path / "prof" / "capture1"),
            str(tmp_path / "prof" / "capture2")]
        for r, step in ((r1, 1), (r2, 2)):
            assert os.listdir(r["profile_dir"]) == [
                f"rank0.step{step}.pt.trace.json"]

    def test_post_run_trigger_never_arms_a_profiler(self, scoped_obs,
                                                    tmp_path):
        cap = tobs.AnomalyCapture(str(tmp_path / "prof"), n_steps=4)
        rec = cap.trigger("slo_breach", arm_profiler=False)
        assert rec is not None
        assert rec.get("profile_dir") is None
        assert rec["n_steps"] == 0
        assert cap._prof is None and not profiler_busy()
        assert rec["flight_path"]

    def test_validation(self, tmp_path):
        for mod in (tobs, jobs):
            with pytest.raises(ValueError, match="n_steps"):
                mod.AnomalyCapture(str(tmp_path), n_steps=0)
            with pytest.raises(ValueError, match="max_captures"):
                mod.AnomalyCapture(str(tmp_path), max_captures=0)

    def test_busy_profiler_gives_a_bundle_without_a_trace(self, scoped_obs,
                                                          tmp_path):
        """One torch profiler per process: a capture that fires while
        another profile runs (the Trainer's own window, a profiled
        update) gets no profiler -- ``profile_dir`` None, ``n_steps``
        0, as the JAX capture on a busy profiler -- and still files its
        flight dump; the running profile keeps recording."""
        from torch.profiler import ProfilerActivity, profile

        outer = profile(activities=[ProfilerActivity.CPU])
        outer.start()
        try:
            cap = tobs.AnomalyCapture(str(tmp_path / "prof"), n_steps=2)
            rec = cap.trigger("stall", trace_id=f"{RUN_ID}:step:4", step=4)
            with torch.profiler.record_function("outer_still_recording"):
                torch.ones(8).sum()
        finally:
            outer.stop()
        assert rec.get("profile_dir") is None and rec["n_steps"] == 0
        assert cap._prof is None and cap.captures == 1
        assert os.path.exists(rec["flight_path"])
        assert not os.path.exists(str(tmp_path / "prof" / "capture1"))
        assert "outer_still_recording" in {
            e.key for e in outer.key_averages()}
        cap.step(10)
        cap.close()

    def test_window_traces_the_owners_device(self, scoped_obs, tmp_path,
                                             monkeypatch):
        """The capture's profiler traces and synchronizes the device
        its owner gives it, not the process's current CUDA device: with
        the default pointed at a card, a CPU owner's window still opens
        as a CPU trace."""
        from tpu_hpc_torch.profiling import profiler as prof_mod

        monkeypatch.setattr(prof_mod, "_default_device",
                            lambda: torch.device("cuda", 1))
        cap = tobs.AnomalyCapture(str(tmp_path / "prof"), n_steps=1,
                                  device="cpu")
        rec = cap.trigger("stall", step=3)
        assert rec["profile_dir"] == str(tmp_path / "prof" / "capture1")
        assert cap._prof.device == torch.device("cpu")
        cap.step(4)
        assert cap._prof is None and not profiler_busy()
        assert os.listdir(rec["profile_dir"]) == ["rank0.step3.pt.trace.json"]


# ---------------------------------------------------------------------
# the load harness: the same stall captured on both sides
# ---------------------------------------------------------------------
def _capture_rec(run):
    (rec,) = [r for r in run["records"] if r["event"] == "capture_triggered"]
    return rec


def test_loadgen_stall_capture_matches_jax(colocate):
    port, jax_run = colocate["port"], colocate["jax"]
    assert port["streams"] == jax_run["streams"]
    assert port["summary"] == jax_run["summary"]
    assert port["summary"]["captures"] == 1
    assert port["summary"]["stall_events"] >= 1
    for run in (port, jax_run):
        rec = _capture_rec(run)
        stall_tids = {r["trace_id"] for r in run["records"]
                      if r["event"] == "stall"}
        assert rec["reason"] == "stall" and rec["trace_id"] in stall_tids
        assert run["cap"].captures == 1 and run["cap"]._prof is None
        assert os.path.exists(rec["flight_path"])
        assert rec["flight_path"].startswith(run["cap_dir"])
    got, want = _capture_rec(port), _capture_rec(jax_run)
    assert (got["reason"], got["trace_id"], got["step"]) == (
        want["reason"], want["trace_id"], want["step"])
    # The port's window: a CPU trace over the next 3 ticks.
    assert got["n_steps"] == 3
    assert os.listdir(got["profile_dir"]) == [
        f"rank0.step{got['step']}.pt.trace.json"]
    # Virtual-clock TTFT decompositions, request by request.
    reps = {side: ttrace.analyze(run["records"])
            for side, run in colocate.items()}
    assert reps["port"]["requests"] == reps["jax"]["requests"]
    assert reps["port"]["orphan_spans"] == reps["jax"]["orphan_spans"] == 0


def test_clean_run_never_captures(engines, tmp_path):
    runs = {side: _loadgen(engines, side, "steady", tmp_path, n=16)
            for side in SIDES}
    assert runs["port"]["summary"] == runs["jax"]["summary"]
    for run in runs.values():
        assert run["cap"].captures == 0
        assert run["summary"]["captures"] == 0
        assert not [r for r in run["records"]
                    if r["event"] == "capture_triggered"]
    _assert_complete_traces(runs["port"]["records"], 16)


# ---------------------------------------------------------------------
# the server CLI: --loadgen ... --capture-dir
# ---------------------------------------------------------------------
def test_server_capture_dir_writes_one_capture(tmp_path, capsys,
                                               monkeypatch):
    from tpu_hpc_torch.serve import server

    monkeypatch.delenv(tobs.ENV_FLIGHT_DIR, raising=False)
    bus = tobs.EventBus(path=None, run_id="cli", flight_dir="")
    prev_bus, prev_reg = tobs.set_bus(bus), tobs.set_registry(
        tobs.MetricsRegistry())
    cap_dir, metrics = tmp_path / "anomaly", tmp_path / "run.jsonl"
    try:
        rc = server.main([
            "--device", "cpu", "--model", "tiny", "--paged",
            "--loadgen", "colocate", "--capture-dir", str(cap_dir),
            "--metrics", str(metrics), "--requests", "24", "--max-new",
            "4", "--slots", "2", "--buckets", "8", "--vocab", "64",
            "--kv-block-size", "4",
        ])
    finally:
        tobs.set_bus(prev_bus)
        tobs.set_registry(prev_reg)
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rc in (0, None)
    assert summary["captures"] == 1 and summary["recompiles"] == 0
    records = load_records(str(metrics))
    (rec,) = [r for r in records if r["event"] == "capture_triggered"]
    assert rec["reason"] == "stall"
    assert rec["trace_id"] in {r["trace_id"] for r in records
                               if r["event"] == "stall"}
    assert rec["n_steps"] == 8 and os.path.isdir(rec["profile_dir"])
    assert os.path.dirname(rec["flight_path"]) == str(cap_dir)
    _assert_complete_traces(records, 24)


# ---------------------------------------------------------------------
# the Trainer: straggler fault -> one capture keyed to the first stall
# ---------------------------------------------------------------------
class _LinearDS:
    def batch_at(self, step, bs):
        g = torch.Generator().manual_seed(int(step) % 97)
        x = torch.randn(bs, 4, generator=g)
        return x, x @ torch.arange(4.0)


def _forward(params, model_state, batch, rng):
    x, y = batch
    return ((x @ params["w"] - y) ** 2).mean(), model_state, {}


def _fit(tmp_path, monkeypatch, faults=None, stall_factor=None):
    from tpu_hpc_torch.config import TrainingConfig
    from tpu_hpc_torch.train.trainer import Trainer

    if faults:
        monkeypatch.setenv("TPU_HPC_FAULTS", faults)
    else:
        monkeypatch.delenv("TPU_HPC_FAULTS", raising=False)
    metrics = str(tmp_path / "run.jsonl")
    cfg = TrainingConfig(
        epochs=9, steps_per_epoch=1, global_batch_size=8,
        learning_rate=1e-2, metrics_path=metrics,
        capture_on_anomaly=True, capture_steps=2,
        checkpoint_dir=str(tmp_path / "ck"),
        profile_dir=str(tmp_path / "prof"),
    )
    tr = Trainer(cfg, None, _forward, {"w": torch.zeros(4)}, device="cpu")
    if stall_factor is not None:
        # A clean run whose millisecond chunks could breach the default
        # 3x watermark on scheduler noise alone: a huge factor pins "no
        # stall => no capture" (the JAX test's discipline).
        tr.stall = tobs.StallDetector(factor=stall_factor)
    tr.fit(_LinearDS())
    return tr, load_records(metrics)


def test_straggler_fault_triggers_one_capture(tmp_path, monkeypatch,
                                              scoped_obs):
    tr, recs = _fit(
        tmp_path, monkeypatch,
        faults="straggler_ms=400,straggler_at_step=7,on_attempt=-1")
    stalls = [r for r in recs if r["event"] == "stall"]
    assert stalls and all("trace_id" in r for r in stalls)
    caps = [r for r in recs if r["event"] == "capture_triggered"]
    assert len(caps) == 1, "exactly one capture per run (one-shot latch)"
    cap = caps[0]
    assert cap["trace_id"] == stalls[0]["trace_id"]
    assert cap["reason"] == "stall" and os.path.exists(cap["flight_path"])
    # Under <checkpoint_dir>/anomaly, its window a CPU trace over the
    # next capture_steps steps.
    assert cap["profile_dir"] == str(tmp_path / "ck" / "anomaly"
                                     / "capture1")
    assert os.listdir(cap["profile_dir"]) == [
        f"rank0.step{cap['step']}.pt.trace.json"]
    rep = ttrace.analyze(recs)
    assert rep == jtrace.analyze(recs)
    assert rep["orphan_spans"] == 0 and rep["steps"]["count"] >= 8
    strag = [st for st in ttrace.build_traces(recs)["steps"].values()
             if st.step >= 7 and st.wall_ms > 300]
    assert strag, "injected straggler chunks missing from traces"
    for st in strag:
        assert st.breakdown()["dominant"] == "compute"
    # The capture window closed with the run (no leaked profile).
    assert tr.capture is not None and tr.capture._prof is None
    assert not profiler_busy()


def test_guard_poisoned_verdict_triggers_a_capture(tmp_path, monkeypatch,
                                                   scoped_obs):
    """The guard's poisoned verdict is the Trainer's second trigger,
    keyed by the poisoned step's trace id (skip mode: the run goes on
    and the window closes with it)."""
    from tpu_hpc_torch.config import TrainingConfig
    from tpu_hpc_torch.train.trainer import Trainer

    monkeypatch.setenv("TPU_HPC_FAULTS", "nan_loss_at_step=3")
    metrics = str(tmp_path / "run.jsonl")
    cfg = TrainingConfig(
        epochs=5, steps_per_epoch=1, global_batch_size=8,
        learning_rate=1e-2, metrics_path=metrics, guard_mode="skip",
        capture_on_anomaly=True, checkpoint_dir="",
        profile_dir=str(tmp_path / "prof"),
    )
    tr = Trainer(cfg, None, _forward, {"w": torch.zeros(4)}, device="cpu")
    tr.stall = tobs.StallDetector(factor=1e6)
    tr.fit(_LinearDS())
    recs = load_records(metrics)
    (verdict,) = [r for r in recs if r["event"] == "guard_verdict"]
    (cap,) = [r for r in recs if r["event"] == "capture_triggered"]
    assert verdict["verdict"] == "poisoned"
    assert (cap["reason"], cap["trace_id"], cap["step"]) == (
        "guard_poisoned", verdict["trace_id"], verdict["step"])
    # No checkpoint_dir: the bundle goes under <profile_dir>/anomaly.
    assert cap["profile_dir"] == str(tmp_path / "prof" / "anomaly"
                                     / "capture1")
    assert tr.capture._prof is None and not profiler_busy()


def test_clean_run_no_capture(tmp_path, monkeypatch, scoped_obs):
    tr, recs = _fit(tmp_path, monkeypatch, stall_factor=1e6)
    assert not [r for r in recs if r["event"] == "capture_triggered"]
    assert tr.capture is not None and tr.capture.captures == 0


def test_build_trainer_takes_the_capture_settings(tmp_path):
    """build_trainer sets ``train_overrides`` before the Trainer is
    built, so the constructor's capture_steps check sees them."""
    from tpu_hpc_torch.train.__main__ import build_trainer

    kw = dict(steps=1, epochs=1, batch=2, grad_accum_steps=1,
              device="cpu", attn="reference")
    with pytest.raises(ValueError, match="capture_steps"):
        build_trainer(TINY, **kw, train_overrides=dict(
            capture_on_anomaly=True, capture_steps=0))
    tr, _ = build_trainer(TINY, **kw, train_overrides=dict(
        profile=True, profile_dir=str(tmp_path), profile_start_step=2,
        capture_on_anomaly=True))
    assert (tr.cfg.profile, tr.cfg.profile_dir, tr.cfg.profile_start_step,
            tr.cfg.capture_on_anomaly) == (True, str(tmp_path), 2, True)
