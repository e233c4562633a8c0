"""The port's ``profiling/`` and ``logging_/`` against the JAX package's.

``tpu_hpc_torch.profiling.TrainingProfiler`` keeps the JAX window
semantics on ``torch.profiler`` (a CPU-only trace here): the window
opens when the owner's step reaches ``start_step`` (threshold, so a
chunk may cross it), closes ``num_steps`` later, writes one Chrome
trace, refuses to start while another torch profiler runs, and never
leaks an open profile. ``device_memory_summary`` returns None on the
CPU, as the JAX function does there, and turns the same allocator
numbers into the same ``device_memory`` record and gauge.
``logging_`` behaves as ``tests/test_logging.py`` pins the JAX one.
"""
import glob
import json
import logging
import os

import pytest
import torch

jax = pytest.importorskip("jax", reason="the JAX reference package")

from tpu_hpc import obs as jobs
from tpu_hpc.profiling import device_memory_summary as jax_memory_summary
from tpu_hpc_torch import obs as tobs
from tpu_hpc_torch.logging_ import (
    get_logger,
    host_log,
    redirect_output,
    verify_min_device_count,
)
from tpu_hpc_torch.obs.regress import lower_is_better, report_metrics
from tpu_hpc_torch.obs.report import build_report
from tpu_hpc_torch.obs.schema import load_records
from tpu_hpc_torch.profiling import (
    TrainingProfiler,
    device_memory_summary,
    profiler_busy,
    training_profiler,
)
from tpu_hpc_torch.profiling import profiler as profiler_mod


def _trace(log_dir):
    (path,) = glob.glob(os.path.join(str(log_dir), "*.pt.trace.json"))
    with open(path) as f:
        return path, json.load(f)


def _work():
    torch.ones(64).mul_(2).sum()


# ---------------------------------------------------------------------
# TrainingProfiler windows
# ---------------------------------------------------------------------
def test_window_triggering(tmp_path):
    prof = TrainingProfiler(str(tmp_path), start_step=2, num_steps=3,
                            device="cpu")
    prof.step(0)
    assert not prof.active
    prof.step(2)
    assert prof.active and profiler_busy()
    with prof.annotate(2):
        _work()
    prof.step(4)
    assert prof.active  # [2, 5): step 4 is still inside
    prof.step(5)
    assert not prof.active and not profiler_busy()
    path, trace = _trace(tmp_path)
    # One Chrome trace per window, named by rank and the opening step.
    assert os.path.basename(path) == "rank0.step2.pt.trace.json"
    assert prof.trace_path == path
    names = {e.get("name") for e in trace["traceEvents"]}
    assert "train" in names
    # CPU device: a CPU-only trace (no kernel or memcpy events).
    assert not [e for e in trace["traceEvents"]
                if e.get("cat") in ("kernel", "gpu_memcpy")]


def test_chunk_boundary_triggering(tmp_path):
    """Chunked loops only call step() at epoch boundaries (0, 20,
    40...); a window like [3, 8) must still open at the first boundary
    past start_step."""
    prof = TrainingProfiler(str(tmp_path), start_step=3, num_steps=5,
                            device="cpu")
    prof.step(0)
    assert not prof.active
    prof.step(20)
    assert prof.active
    _work()
    prof.step(40)
    assert not prof.active
    assert _trace(tmp_path)[0].endswith("rank0.step20.pt.trace.json")


def test_context_manager_stops_on_error(tmp_path):
    with pytest.raises(RuntimeError, match="boom"):
        with training_profiler(str(tmp_path), start_step=0,
                               device="cpu") as prof:
            prof.step(0)
            assert prof.active
            raise RuntimeError("boom")
    assert not prof.active and not profiler_busy()


def test_exhausted_loop_inside_window_closes_trace(tmp_path):
    """A loop that ends INSIDE the window (step never reaches
    start+num) must not leak the open profile: the class is its own
    context manager, and a second window can start after it."""
    with TrainingProfiler(str(tmp_path / "a"), start_step=0,
                          num_steps=100, device="cpu") as prof:
        prof.step(0)
        assert prof.active
        _work()
    assert not prof.active
    with TrainingProfiler(str(tmp_path / "b"), start_step=0, num_steps=1,
                          device="cpu") as prof2:
        prof2.step(0)
        assert prof2.active
        _work()
    assert not prof2.active
    _trace(tmp_path / "a")
    _trace(tmp_path / "b")


def test_stop_clears_active_even_when_export_raises(tmp_path, monkeypatch):
    """An export that raises (full disk mid-write) must still mark the
    profiler inactive, or every later stop re-raises on an already-dead
    trace."""
    prof = TrainingProfiler(str(tmp_path), start_step=0, num_steps=5,
                            device="cpu")
    prof.step(0)
    assert prof.active

    def boom(self, path):
        raise OSError("disk full")

    monkeypatch.setattr(torch.profiler.profile, "export_chrome_trace", boom)
    with pytest.raises(OSError, match="disk full"):
        prof.stop()
    assert not prof.active and not profiler_busy()
    prof.stop()  # idempotent now, must not re-raise


def test_busy_profiler_refuses_a_second_window(tmp_path):
    """One torch profiler per process: a second ``start()`` would take
    the running session over silently, so the window refuses to open
    and the running profile keeps recording."""
    from torch.profiler import ProfilerActivity, profile

    outer = profile(activities=[ProfilerActivity.CPU])
    outer.start()
    try:
        prof = TrainingProfiler(str(tmp_path), start_step=0, device="cpu")
        with pytest.raises(RuntimeError, match="profiler busy"):
            prof.step(0)
        assert not prof.active
        with torch.profiler.record_function("outer_still_recording"):
            _work()
    finally:
        outer.stop()
    assert "outer_still_recording" in {e.key for e in outer.key_averages()}


def test_rank_gating_and_activities(tmp_path, monkeypatch):
    monkeypatch.setenv("RANK", "1")
    assert not TrainingProfiler(str(tmp_path), device="cpu").enabled
    off = TrainingProfiler(str(tmp_path), start_step=0, device="cpu")
    off.step(0)
    assert not off.active and not glob.glob(str(tmp_path / "*"))
    assert TrainingProfiler(str(tmp_path), host0_only=False,
                            device="cpu").enabled
    monkeypatch.delenv("RANK")
    assert TrainingProfiler(str(tmp_path)).device.type == (
        "cuda" if torch.cuda.is_available() else "cpu")
    assert not TrainingProfiler(str(tmp_path), device="cpu")._cuda
    assert TrainingProfiler(str(tmp_path), device="cuda:0")._cuda


def test_trainer_profile_flag(tmp_path):
    """The Trainer opens the window on its own step numbers: steps
    2..3 of 5 single-step epochs, one trace, one ``train`` range per
    chunk inside it."""
    from tpu_hpc_torch.config import TrainingConfig
    from tpu_hpc_torch.train.trainer import Trainer

    class DS:
        def batch_at(self, step, bs):
            g = torch.Generator().manual_seed(int(step))
            x = torch.randn(bs, 4, generator=g)
            return x, x @ torch.arange(4.0)

    def forward(p, ms, batch, rng):
        x, y = batch
        return ((x @ p["w"] - y) ** 2).mean(), ms, {}

    cfg = TrainingConfig(
        epochs=5, steps_per_epoch=1, global_batch_size=8,
        learning_rate=1e-2, profile=True, profile_dir=str(tmp_path),
        profile_start_step=2, profile_num_steps=2,
    )
    result = Trainer(cfg, None, forward, {"w": torch.zeros(4)},
                     device="cpu").fit(DS())
    assert torch.isfinite(torch.tensor(result["final_loss"]))
    assert not profiler_busy()
    path, trace = _trace(tmp_path)
    assert os.path.basename(path) == "rank0.step2.pt.trace.json"
    assert [e["name"] for e in trace["traceEvents"]].count("train") == 2


# ---------------------------------------------------------------------
# device_memory_summary
# ---------------------------------------------------------------------
class _FakeDevice:
    def __init__(self, name, peak):
        self._name, self._peak = name, peak

    def memory_stats(self):
        return {
            "bytes_in_use": self._peak // 2,
            "bytes_limit": 4 * self._peak,
            "peak_bytes_in_use": self._peak,
        }

    def __str__(self):
        return self._name


UNSTAMPED = ("time", "run_id", "host", "pid", "schema_version")


def _summary(obs, summarize, sink, devices):
    bus = obs.EventBus(path=None, run_id="mem-test")
    reg = obs.MetricsRegistry()
    prev_bus, prev_reg = obs.set_bus(bus), obs.set_registry(reg)
    try:
        stats = summarize(devices=devices, emit=True, sink=str(sink))
    finally:
        obs.set_bus(prev_bus)
        obs.set_registry(prev_reg)
    recs = load_records(str(sink)) if os.path.exists(sink) else []
    return stats, [{k: v for k, v in r.items() if k not in UNSTAMPED}
                   for r in recs], reg.gauge("hbm_peak_bytes")


def test_summary_equals_jax_for_the_same_numbers(tmp_path):
    devices = [_FakeDevice("d0", 100), _FakeDevice("d1", 300)]
    got = _summary(tobs, device_memory_summary, tmp_path / "t.jsonl",
                   devices)
    want = _summary(jobs, jax_memory_summary, tmp_path / "j.jsonl",
                    devices)
    assert got == want
    stats, recs, gauge = got
    assert set(stats) == {"d0", "d1"} and gauge == 300.0
    assert len(recs) == 1 and recs[0]["hbm_peak_bytes"] == 300
    # The report's memory section and the regress namespace see it.
    rep = build_report(load_records(str(tmp_path / "t.jsonl")))
    assert rep["memory"]["hbm_peak_bytes"] == 300
    assert report_metrics(rep)["memory.hbm_peak_bytes"] == 300.0
    assert lower_is_better("memory.hbm_peak_bytes")


def test_cpu_gives_none_like_jax(tmp_path):
    """No CUDA device: None and nothing emitted -- what the JAX function
    gives on its CPU devices (``memory_stats()`` is None there)."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    got = _summary(tobs, device_memory_summary, tmp_path / "t.jsonl", None)
    want = _summary(jobs, jax_memory_summary, tmp_path / "j.jsonl", None)
    assert got == want == (None, [], None)
    assert device_memory_summary(devices=[torch.device("cpu")]) is None


def test_cuda_devices_read_the_caching_allocator(tmp_path, monkeypatch):
    """A CUDA device's numbers come from the caching allocator (in use,
    peak) and the card's total memory (limit), in the JAX keys."""
    class Props:
        total_memory = 80 * 2**30

    monkeypatch.setattr(torch.cuda, "memory_allocated",
                        lambda d: 10 * (d.index + 1))
    monkeypatch.setattr(torch.cuda, "max_memory_allocated",
                        lambda d: 50 * (d.index + 1))
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda d: Props())
    assert profiler_mod._memory_stats(torch.device("cuda", 1)) == {
        "bytes_in_use": 20, "peak_bytes_in_use": 100,
        "bytes_limit": 80 * 2**30}
    stats, recs, gauge = _summary(
        tobs, device_memory_summary, tmp_path / "t.jsonl",
        [torch.device("cuda", 0), torch.device("cuda", 1)])
    assert stats == {"cuda:0": {"in_use": 10, "limit": 80 * 2**30,
                                "peak": 50},
                     "cuda:1": {"in_use": 20, "limit": 80 * 2**30,
                                "peak": 100}}
    assert (recs[0]["hbm_peak_bytes"], recs[0]["hbm_in_use_bytes"],
            recs[0]["hbm_limit_bytes"], gauge) == (100, 20, 80 * 2**30,
                                                   100.0)


# ---------------------------------------------------------------------
# logging_ (tests/test_logging.py's pins, and the rank gate)
# ---------------------------------------------------------------------
def test_level_honored_after_first_configure():
    get_logger("tpu_hpc_torch.lvltest")
    lg = get_logger("tpu_hpc_torch.lvltest", logging.DEBUG)
    assert lg.level == logging.DEBUG
    assert lg.isEnabledFor(logging.DEBUG)
    assert get_logger(
        "tpu_hpc_torch.lvltest", logging.WARNING
    ).level == logging.WARNING


def test_default_call_does_not_clobber_explicit_level():
    get_logger("tpu_hpc_torch.lvltest2", logging.DEBUG)
    lg = get_logger("tpu_hpc_torch.lvltest2")
    assert lg.level == logging.DEBUG


def test_same_logger_object_returned():
    assert get_logger("tpu_hpc_torch.same") is \
        get_logger("tpu_hpc_torch.same")


def test_host_log_only_on_rank_zero(caplog, monkeypatch):
    lg = get_logger("tpu_hpc_torch.hostlog")
    with caplog.at_level(logging.INFO, logger="tpu_hpc_torch.hostlog"):
        monkeypatch.setenv("RANK", "1")
        host_log("from %s", "rank one", logger=lg)
        monkeypatch.setenv("RANK", "0")
        host_log("from %s", "rank zero", logger=lg)
    assert [r.getMessage() for r in caplog.records
            if r.name == "tpu_hpc_torch.hostlog"] == ["from rank zero"]


def test_verify_min_device_count():
    n = torch.cuda.device_count()
    assert verify_min_device_count(n)
    assert not verify_min_device_count(n + 1)


def test_redirect_output_captures_python_and_native(tmp_path, capfd):
    prefix = str(tmp_path / "run")
    with redirect_output(prefix, process_id=3):
        print("python stdout")
        os.write(1, b"native stdout\n")
        os.write(2, b"native stderr\n")
    print("after")
    assert open(f"{prefix}.3.out").read() == "python stdout\nnative stdout\n"
    assert open(f"{prefix}.3.err").read() == "native stderr\n"
    assert "after" in capfd.readouterr().out
    with redirect_output(str(tmp_path / "dflt")):
        pass
    assert os.path.exists(str(tmp_path / "dflt.0.out"))


def test_slice_modules_import_no_jax():
    """This slice's modules (and the entry points they are wired into)
    import neither jax nor the JAX package."""
    import subprocess
    import sys

    code = (
        "import sys\n"
        "import tpu_hpc_torch.logging_, tpu_hpc_torch.profiling\n"
        "import tpu_hpc_torch.obs.trace, tpu_hpc_torch.obs.bank\n"
        "import tpu_hpc_torch.loadgen.harness, tpu_hpc_torch.serve.fleet\n"
        "import tpu_hpc_torch.serve.server, tpu_hpc_torch.train.trainer\n"
        "import tpu_hpc_torch.kernels.paged_attention\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'tpu_hpc', 'flax', 'optax')]\n"
        "print(bad)\n"
    )
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True, timeout=120, cwd=repo)
    assert out.stdout.strip() == "[]"
