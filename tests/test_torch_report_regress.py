"""The port's offline readers of the event records (``obs/report.py`` and
``obs/regress.py``) against the JAX package's: the same JSONL record
sets through both ``build_report`` / ``format_report`` and the same
report pairs through both ``regress.compare`` and ``regress.main``.

Record sets: a two-attempt training run (goodput, phases, MFU at an
explicit peak), the pipeline and live records of tests/test_mpmd.py's
``TestObs``, and the event logs of two port MPMD runs (clean, and a
stage killed mid-step). The only difference allowed is the package's
name where the text prints it.
"""
import contextlib
import io

import pytest
import torch

pytest.importorskip("jax", reason="the JAX reference package")

from tpu_hpc.obs import regress as jregress  # noqa: E402
from tpu_hpc.obs import report as jreport  # noqa: E402
from tpu_hpc_torch import obs as tobs  # noqa: E402
from tpu_hpc_torch.models import pipeline_transformer as ptx  # noqa: E402
from tpu_hpc_torch.obs import regress as tregress  # noqa: E402
from tpu_hpc_torch.obs import report as treport  # noqa: E402
from tpu_hpc_torch.obs.schema import load_records, stamp  # noqa: E402
from tpu_hpc_torch.parallel import mpmd  # noqa: E402
from tpu_hpc_torch.resilience.faults import fault_plan_from_env  # noqa: E402

M = 4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The models here are tiny: one intra-op thread runs them as fast,
    and leaves the other cores to the test files running beside this
    one under xdist."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _name(text: str) -> str:
    return text.replace("tpu_hpc_torch", "tpu_hpc")


def _training(kind="cpu"):
    recs = [
        {"event": "run_start", "start_step": 0, "total_steps": 4,
         "n_devices": 8, "n_processes": 1, "device_kind": kind,
         "jax_version": "0", "run_id": "r",
         "config": {"model_flops_per_item": 1e9}},
        {"event": "span", "name": "compute", "dur_s": 8.0, "step": 2},
        {"event": "span", "name": "data", "dur_s": 1.0, "step": 2},
        {"event": "span", "name": "ckpt", "dur_s": 1.0, "step": 2},
        {"event": "epoch", "epoch": 0, "step": 2, "loss": 1.0,
         "items_per_s": 100.0, "items_per_s_per_device": 12.5,
         "s_per_step": 4.0},
        {"event": "run_end", "step": 2, "preempted": True, "attempt": 0,
         "resumed_from_step": 0,
         "goodput": {"total_s": 10.0, "productive_s": 8.0, "ckpt_s": 1.0,
                     "restore_s": 0.0, "other_s": 1.0, "goodput": 0.8}},
        {"event": "stall", "step": 2, "step_s": 9.0, "watermark_s": 3.0,
         "ratio": 3.0},
        {"event": "epoch", "epoch": 1, "step": 4, "loss": 0.5,
         "items_per_s": 100.0, "items_per_s_per_device": 12.5,
         "s_per_step": 4.0},
        {"event": "run_end", "step": 4, "preempted": False, "attempt": 1,
         "resumed_from_step": 2,
         "goodput": {"total_s": 10.0, "productive_s": 9.0, "ckpt_s": 0.5,
                     "restore_s": 0.5, "other_s": 0.0, "goodput": 0.9}},
    ]
    return [stamp(r) for r in recs]


def _pipeline():
    """tests/test_mpmd.py TestObs's records."""
    return [stamp(r) for r in (
        {"event": "stage_down", "stage": 1, "reason": "crash", "step": 1,
         "microbatch": 3, "inflight": M},
        {"event": "stage_up", "stage": 1, "reason": "restart",
         "restore_step": 1, "mttr_s": 5.0, "compile_count": 3},
        *({"event": "stage_redispatch", "stage": 1, "microbatch": m,
           "step": 1} for m in range(M)),
        *({"event": "pipeline_bubble", "step": s, "bubble_fraction": 0.45,
           "makespan_s": 10.0} for s in range(3)),
    )]


def _live(tmp_path):
    """health_digest records on a run log: two stages, one a straggler."""
    path = str(tmp_path / "live.jsonl")
    bus = tobs.EventBus(path=path, flight_dir="")
    for s in range(3):
        pub = tobs.DigestPublisher(str(tmp_path / "d"), "stage", str(s),
                                   bus=bus)
        sk = tobs.LogBucketSketch()
        for step in range(3):
            sk.add(10.0 * (4 if s == 2 else 1) + step)
            pub.publish(counters={"steps": step + 1.0},
                        gauges={"bubble_fraction": 0.3}, hists={
                            "stage_busy_ms": sk}, t=float(step),
                        step_s=1.0 * (4 if s == 2 else 1), step=step)
    return load_records(path)


def _mpmd_log(tmp_path, spec):
    """A port MPMD run's own event log (4 CPU stages, 3 steps)."""
    cfg = ptx.PipeConfig(vocab_size=64, dim=32, n_heads=2, n_stages=4,
                         layers_per_stage=1, max_seq_len=16)
    params = ptx.init_pipeline_transformer(
        torch.Generator().manual_seed(0), cfg)
    tok = torch.randint(0, 64, (8, 16), generator=torch.Generator()
                        .manual_seed(1))
    path = str(tmp_path / f"mpmd_{bool(spec)}.jsonl")
    prev = tobs.set_bus(tobs.EventBus(path=path, flight_dir=""))
    try:
        plan = fault_plan_from_env({"TPU_HPC_FAULTS": spec}) if spec \
            else None
        pipe = mpmd.MpmdPipeline(
            ptx.mpmd_bundle(params, cfg), mpmd.MpmdConfig(n_microbatches=M),
            devices=["cpu"] * 4, fault_plan=plan, events_path=path,
        ).build(tok)
        pipe.train([(tok, tok)] * 3)
    finally:
        tobs.set_bus(prev)
    return path


@pytest.fixture(scope="module")
def record_sets(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("records")
    clean = _mpmd_log(tmp, None)
    chaos = _mpmd_log(tmp, "stage_kill_at=1:1")
    return {"training": _training(), "pipeline": _pipeline(),
            "live": _live(tmp), "mpmd_clean": load_records(clean),
            "mpmd_chaos": load_records(chaos),
            "paths": {"mpmd_clean": clean, "mpmd_chaos": chaos}}


@pytest.mark.parametrize("name", ["training", "pipeline", "live",
                                  "mpmd_clean", "mpmd_chaos"])
@pytest.mark.parametrize("peak", [None, 1e12])
def test_reports_equal(record_sets, name, peak):
    """A TPU device_kind would send the two packages to different chip
    tables: the training run names one only beside an explicit peak."""
    recs = record_sets[name]
    if name == "training" and peak:
        recs = _training("TPU v5 lite")
    jrep = jreport.build_report(recs, peak_flops_per_device=peak)
    trep = treport.build_report(recs, peak_flops_per_device=peak)
    assert trep == jrep
    assert _name(treport.format_report(trep)) == \
        jreport.format_report(jrep)
    if name == "training" and peak:
        assert trep["mfu"]["mfu"] == pytest.approx(100 * 1e9 / (1e12 * 8))
    if name in ("pipeline", "mpmd_chaos"):
        assert "MPMD pipeline" in treport.format_report(trep)
        assert trep["pipeline"]["redispatched"] == M
    if name == "live":
        assert trep["live"] is not None


def test_report_of_a_port_device_kind():
    """A run_start stamped with an H100's name resolves the port's own
    chip table (checks/roofline.py): MFU without an explicit peak."""
    from tpu_hpc_torch.checks.roofline import CHIPS, peak_flops_for_kind

    recs = _training()
    recs[0] = dict(recs[0], device_kind="NVIDIA H100 80GB HBM3")
    rep = treport.build_report(recs)
    assert rep["mfu"]["peak_flops_per_device"] == \
        CHIPS["h100-sxm"].peak_bf16_flops
    assert peak_flops_for_kind("TPU v5 lite") is None
    assert peak_flops_for_kind("cpu", default=1.0) == 1.0


def test_regress_verdicts_equal(record_sets):
    reports = {pkg: {n: mod.build_report(record_sets[n]) for n in (
        "mpmd_clean", "mpmd_chaos", "training")}
        for pkg, mod in (("jax", jreport), ("port", treport))}
    flat = {pkg: {n: reg.report_metrics(r) for n, r in reps.items()}
            for (pkg, reps), reg in zip(reports.items(),
                                        (jregress, tregress))}
    assert flat["port"] == flat["jax"]
    for base, cand in (("mpmd_clean", "mpmd_chaos"),
                       ("mpmd_chaos", "mpmd_clean"),
                       ("training", "training")):
        got = tregress.compare(flat["port"][base], flat["port"][cand])
        want = jregress.compare(flat["jax"][base], flat["jax"][cand])
        assert got == want
    # The chaos log regresses the pipeline's robustness numbers.
    bad = {v["metric"] for v in tregress.compare(
        flat["port"]["mpmd_clean"], flat["port"]["mpmd_chaos"])[0]}
    assert "pipeline.redispatched" in bad or "pipeline.stage_down" in bad
    for name in ("pipeline.stage_down", "pipeline.redispatched",
                 "pipeline.bubble_fraction", "pipeline.recovery_mttr_s"):
        assert tregress.lower_is_better(name) == \
            jregress.lower_is_better(name) is True


@pytest.mark.parametrize("pair", [("mpmd_clean", "mpmd_chaos"),
                                  ("mpmd_chaos", "mpmd_chaos")])
def test_regress_cli_equal(record_sets, pair):
    paths = [record_sets["paths"][n] for n in pair]
    outs = []
    for main in (jregress.main, tregress.main):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf), \
                contextlib.redirect_stderr(io.StringIO()):
            rc = main(paths)
        outs.append((rc, _name(buf.getvalue())))
    assert outs[1] == outs[0]
    assert outs[1][0] == (0 if pair[0] == pair[1] else 1)
