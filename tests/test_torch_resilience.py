"""The port's resilience modules against the JAX package's, on the CPU.

``tpu_hpc_torch/resilience`` copies the JAX package's framework-free
modules and ports ``faults.py``; this file holds each to the original:
fault plans parse alike (the error messages for bad values and unknown
keys included); the same health rows give the same ``GuardPolicy``
verdicts and rollback wants; skip windows give the same offsets and
boundaries and persist the same file; the stall watermark trips alike;
exit codes, backoff delays. Then one supervised kill-resume round trip
through ``python -m tpu_hpc_torch.resilience.supervisor`` on a tiny
Llama, and the train CLI's guard and supervise flags.
"""
import dataclasses
import json
import math
import os
import subprocess
import sys

import numpy as np
import pytest

from tpu_hpc_torch.obs.stall import StallDetector
from tpu_hpc_torch.resilience import faults, guard, retry, signals

jax = pytest.importorskip("jax", reason="the JAX reference package")

from tpu_hpc.obs.stall import StallDetector as JaxStallDetector  # noqa: E402
from tpu_hpc.resilience import faults as jfaults  # noqa: E402
from tpu_hpc.resilience import guard as jguard  # noqa: E402
from tpu_hpc.resilience import retry as jretry  # noqa: E402
from tpu_hpc.resilience import signals as jsignals  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = ["--device", "cpu", "--dim", "64", "--n-layers", "2", "--n-heads",
        "4", "--vocab", "128", "--multiple-of", "16", "--seq-len", "16",
        "--batch", "4", "--grad-accum-steps", "2"]


def _plan_fields(plan):
    return {f.name: getattr(plan, f.name) for f in dataclasses.fields(plan)
            if f.name != "_announced"}


@pytest.mark.parametrize("spec", [
    "kill_at_step=4",
    "nan_loss_at_step=3,on_attempt=-1",
    "grad_spike_at_step=5,grad_spike_scale=100",
    "straggler_ms=2.5,straggler_at_step=1",
    "corrupt_ckpt_at_step=6,bitflip_ckpt_at_step=4,preempt_at_step=2",
    "stall_at_step=1,stall_s=0.5",
    "stage_kill_at=1:2,stage_straggler=0:1.5",
    "slice_down_at_step=3,slice_up_at_step=5",
    "kill_at_step=2,kill_at_step=5",
])
def test_fault_plans_parse_like_jax(spec):
    env = {"TPU_HPC_FAULTS": spec, "TPU_HPC_ATTEMPT": "1"}
    got = faults.fault_plan_from_env(env)
    want = jfaults.fault_plan_from_env(env)
    assert _plan_fields(got) == _plan_fields(want)
    assert got.active == want.active
    assert got.stage_fault_keys() == want.stage_fault_keys()
    assert got.slice_fault_keys() == want.slice_fault_keys()
    assert faults.fault_plan_from_env({}) is None


@pytest.mark.parametrize("spec", [
    "kill_at_step=soon", "straggler_ms=fast", "nosuch=1", "stage_kill_at=1",
    "stage_straggler=0:-1", " =3",
])
def test_bad_fault_specs_fail_like_jax(spec):
    env = {"TPU_HPC_FAULTS": spec}
    with pytest.raises(ValueError) as got:
        faults.fault_plan_from_env(env)
    with pytest.raises(ValueError) as want:
        jfaults.fault_plan_from_env(env)
    assert str(got.value) == str(want.value)


def test_numeric_fault_keys_on_the_data_index():
    import torch

    plan = faults.fault_plan_from_env(
        {"TPU_HPC_FAULTS": "nan_loss_at_step=2,grad_spike_at_step=3,"
                           "grad_spike_scale=8"})
    fn = plan.numeric_fault_fn()
    loss, grads = torch.tensor(1.5), [torch.ones(2), torch.full((3,), 2.0)]
    for index, nan, scale in ((1, False, 1.0), (2, True, 1.0),
                              (3, False, 8.0)):
        out_loss, out = fn(index, loss, grads)
        assert math.isnan(float(out_loss)) is nan
        assert all(torch.isnan(g).all() for g in out) is nan
        if not nan:
            assert torch.equal(out[1], grads[1] * scale)
    assert faults.fault_plan_from_env(
        {"TPU_HPC_FAULTS": "kill_at_step=9"}).numeric_fault_fn() is None


# ---------------------------------------------------------------------
# The guard policy and its skip windows
# ---------------------------------------------------------------------

def _health_rows(seed, n=80):
    rng = np.random.default_rng(seed)
    rows = []
    for i in range(n):
        row = {"health_loss_finite": 1.0,
               "health_grad_norm": float(rng.lognormal(0.0, 0.3)),
               "health_update_norm": float(rng.lognormal(-3.0, 0.2)),
               "health_nonfinite": 0.0, "health_skipped": 0.0}
        kind = rng.integers(12)
        if kind == 0:
            row["health_grad_norm"] *= float(rng.choice([5.0, 20.0, 1e4]))
        elif kind == 1:
            row.update(health_loss_finite=0.0, health_grad_norm=math.nan,
                       health_nonfinite=3.0, health_skipped=1.0)
        elif kind == 2:
            row["health_update_norm"] = math.inf
        rows.append(row)
    return rows


def _verdict_fields(v):
    d = dataclasses.asdict(v)
    return {k: ("nan" if isinstance(x, float) and math.isnan(x) else x)
            for k, x in d.items()}


@pytest.mark.parametrize("mode,spike_factor,spike_action,window", [
    ("skip", 10.0, "event", 8), ("rollback", 10.0, "event", 8),
    ("skip", 3.0, "rollback", 4), ("rollback", 0.0, "event", 3),
])
def test_guard_policy_verdicts_match_jax(mode, spike_factor, spike_action,
                                         window):
    kw = dict(mode=mode, spike_factor=spike_factor,
              spike_action=spike_action, window=window)
    ours, theirs = guard.GuardPolicy(**kw), jguard.GuardPolicy(**kw)
    rows = _health_rows(window)
    kinds = set()
    for step, row in enumerate(rows):
        a, b = ours.classify(step, row), theirs.classify(step, row)
        assert _verdict_fields(a) == _verdict_fields(b)
        assert ours.wants_rollback(a) == theirs.wants_rollback(b)
        kinds.add(a.verdict)
    assert kinds == ({"healthy", "spike", "poisoned"} if spike_factor
                     else {"healthy", "poisoned"})
    assert ours.watermark == theirs.watermark


def test_guard_config_validation_matches_jax():
    for kw in (dict(mode="off"), dict(spike_factor=-1.0),
               dict(spike_action="panic"), dict(window=1),
               dict(min_samples=1)):
        with pytest.raises(ValueError) as got:
            guard.GuardPolicy(**kw)
        with pytest.raises(ValueError) as want:
            jguard.GuardPolicy(**kw)
        assert str(got.value) == str(want.value)


def test_skip_windows_offsets_boundaries_and_file_match_jax(tmp_path):
    windows = [{"from_step": 3, "data_from": 3, "data_to": 4},
               {"from_step": 9, "data_from": 11, "data_to": 11},
               {"from_step": 20, "data_from": 23, "data_to": 27}]
    for step in range(30):
        assert guard.offset_at(windows, step) == jguard.offset_at(windows,
                                                                  step)
        assert guard.next_boundary(windows, step) == jguard.next_boundary(
            windows, step)
    for lib, d in ((guard, tmp_path / "port"), (jguard, tmp_path / "jax")):
        for w in reversed(windows):
            lib.record_rollback(str(d), w)
    ours = json.loads((tmp_path / "port" / guard.GUARD_STATE_FILE)
                      .read_text())
    theirs = json.loads((tmp_path / "jax" / jguard.GUARD_STATE_FILE)
                        .read_text())
    assert ours == theirs and ours["rollbacks"] == 3
    assert guard.load_state(str(tmp_path / "port")) == jguard.load_state(
        str(tmp_path / "jax"))
    assert guard.load_state(str(tmp_path / "none")) == {
        "skip_windows": [], "rollbacks": 0}
    stacked = {"health_grad_norm": np.array([1.0, 2.0]),
               "health_nonfinite": np.array([0, 3])}
    assert guard.health_rows(stacked, 2) == jguard.health_rows(stacked, 2)


# ---------------------------------------------------------------------
# Stall watermark, exit codes, backoff
# ---------------------------------------------------------------------

def test_stall_watermark_matches_jax():
    times = [0.10, 0.11, 0.09, 0.10, 0.12, 0.50, 0.10, 0.11, 2.0, 0.1,
             0.1, 0.1, 0.35, 0.1]
    ours, theirs = StallDetector(), JaxStallDetector()
    trips = []
    for step, t in enumerate(times):
        a, b = ours.observe(step, t), theirs.observe(step, t)
        assert (a is None) == (b is None)
        if a is not None:
            assert {k: v for k, v in a.items() if k != "trace_id"} == {
                k: v for k, v in b.items() if k != "trace_id"}
            trips.append(step)
        assert ours.heartbeat_extra() == theirs.heartbeat_extra()
        assert ours.watermark_s == theirs.watermark_s
    assert trips  # the 0.50 and 2.0 steps breach the watermark


def test_exit_codes_and_backoff_match_jax():
    assert (signals.EXIT_RESUMABLE, signals.EXIT_HANG,
            signals.EXIT_ROLLBACK) == (jsignals.EXIT_RESUMABLE,
                                       jsignals.EXIT_HANG,
                                       jsignals.EXIT_ROLLBACK) == (75, 76, 77)
    for pre, rb in ((False, False), (True, False), (False, True)):
        assert signals.exit_code_for(pre, rb) == jsignals.exit_code_for(pre,
                                                                        rb)
    for code in (0, 1, 2, 75, 76, 77, 137, 143):
        assert signals.describe_exit(code) == jsignals.describe_exit(code)
    assert list(retry.backoff_delays(5, seed=3)) == list(
        jretry.backoff_delays(5, seed=3))


# ---------------------------------------------------------------------
# The supervisor and the CLI
# ---------------------------------------------------------------------

def _cli(*args, env=None, timeout=240):
    return subprocess.run(
        [sys.executable, "-m", "tpu_hpc_torch.train", *args],
        capture_output=True, text=True, timeout=timeout, cwd=REPO,
        env=dict(os.environ if env is None else env, PYTHONPATH=REPO))


def test_supervised_kill_resume_round_trip(tmp_path):
    """kill_at_step=3 on attempt 0: SIGKILL at the first boundary past
    step 3 (step 4, before its save), so attempt 0 ends 137 with step 2
    the newest checkpoint; attempt 1 resumes there and exits 0."""
    ck, logs = tmp_path / "ck", tmp_path / "logs"
    env = dict(os.environ, PYTHONPATH=REPO, TPU_HPC_FAULTS="kill_at_step=3")
    proc = subprocess.run(
        [sys.executable, "-m", "tpu_hpc_torch.resilience.supervisor",
         "--max-restarts", "2", "--backoff", "0", "--log-dir", str(logs),
         "--", sys.executable, "-m", "tpu_hpc_torch.train", *TINY,
         "--steps", "2", "--epochs", "3", "--guard-mode", "skip",
         "--checkpoint-dir", str(ck), "--save-every", "1"],
        capture_output=True, text=True, timeout=300, cwd=REPO, env=env)
    assert proc.returncode == 0, proc.stderr[-3000:]
    events = [json.loads(line) for line in
              (logs / "supervisor.jsonl").read_text().splitlines()]
    ends = [(e["attempt"], e["rc"]) for e in events
            if e["event"] == "attempt_end"]
    assert ends == [(0, 137), (1, 0)]
    summary = [json.loads(line) for line in
               (logs / "run.attempt1.log").read_text().splitlines()
               if line.startswith("{")][-1]
    assert summary["resumed_from_step"] <= 3
    assert summary["resumed_from_step"] == 2 and summary["updates"] == 4
    assert all(math.isfinite(x) for x in summary["losses"])


def test_train_cli_guard_and_supervise_flags(tmp_path):
    bad = _cli(*TINY, "--guard-mode", "rollback")
    assert bad.returncode == 2 and "needs --checkpoint-dir" in bad.stderr
    under = _cli(*TINY, "--supervise", "1",
                 env=dict(os.environ, WORLD_SIZE="4"))
    assert under.returncode == 2 and "supervisor around" in under.stderr
    # --supervise wraps the run; a rollback exits 77, which the
    # supervisor relaunches (its own budget) and the relaunch finishes.
    ck = tmp_path / "ck"
    run = _cli(*TINY, "--steps", "2", "--epochs", "2", "--guard-mode",
               "rollback", "--checkpoint-dir", str(ck), "--save-every", "1",
               "--supervise", "1",
               env=dict(os.environ,
                        TPU_HPC_FAULTS="nan_loss_at_step=3,on_attempt=-1"))
    assert run.returncode == 0, run.stderr[-3000:]
    lines = [json.loads(x) for x in run.stdout.splitlines()
             if x.startswith("{")]
    assert [s["rolled_back"] for s in lines] == [True, False]
    assert lines[-1]["resumed_from_step"] == 2
    assert guard.load_state(str(ck))["skip_windows"] == [
        {"from_step": 3, "data_from": 3, "data_to": 3}]
