"""The port's runtime tuning presets (tpu_hpc_torch.runtime.tuning) and
environment checks (tpu_hpc_torch.checks.env_check) on the CPU: the
JAX package's merge rules over the NCCL / CUDA / allocator knobs, the
--shell launcher form, the refusal after CUDA or NCCL initialized, the
gloo all-reduce smoke test with its exact sum, and the microbenchmark's
indeterminate-timing error."""
import pytest
import torch

from tpu_hpc_torch.checks import env_check
from tpu_hpc_torch.runtime import tuning

# (profile, existing env, expected additions) -- the merge rules: the
# user's token wins, a force profile overrides instead, no token name
# twice.
MERGES = [
    ("default", {}, {}),
    ("collective-overlap", {},
     {"CUDA_DEVICE_MAX_CONNECTIONS": "1",
      "TORCH_NCCL_AVOID_RECORD_STREAMS": "1"}),
    # The user's value of a one-value variable wins.
    ("collective-overlap", {"CUDA_DEVICE_MAX_CONNECTIONS": "8"},
     {"CUDA_DEVICE_MAX_CONNECTIONS": "8",
      "TORCH_NCCL_AVOID_RECORD_STREAMS": "1"}),
    # data-parallel is a superset of the overlap set.
    ("data-parallel", {"TORCH_NCCL_AVOID_RECORD_STREAMS": "0"},
     {"CUDA_DEVICE_MAX_CONNECTIONS": "1",
      "TORCH_NCCL_AVOID_RECORD_STREAMS": "0", "NCCL_NVLS_ENABLE": "1"}),
    # memory-bound forces its tokens over the user's, keeping the
    # user's other allocator tokens.
    ("memory-bound",
     {"PYTORCH_CUDA_ALLOC_CONF":
      "expandable_segments:False,max_split_size_mb:128",
      "TORCH_NCCL_AVOID_RECORD_STREAMS": "0"},
     {"PYTORCH_CUDA_ALLOC_CONF":
      "expandable_segments:True,max_split_size_mb:128",
      "TORCH_NCCL_AVOID_RECORD_STREAMS": "1"}),
    ("memory-bound", {},
     {"PYTORCH_CUDA_ALLOC_CONF": "expandable_segments:True",
      "TORCH_NCCL_AVOID_RECORD_STREAMS": "1"}),
]


@pytest.mark.parametrize("profile,base,want", MERGES)
def test_tuning_env_merge_rules(profile, base, want):
    got = tuning.tuning_env(profile, base=base)
    assert got == want
    for var, value in got.items():
        names = [tuning._token_name(var, t) for t in
                 tuning._tokens(var, value)]
        assert len(names) == len(set(names)), (var, value)


def test_list_variable_user_tokens_win_without_force():
    tuning.PROFILES["_probe"] = {
        "PYTORCH_CUDA_ALLOC_CONF": "expandable_segments:True,"
                                   "garbage_collection_threshold:0.8"}
    try:
        got = tuning.tuning_env("_probe", base={
            "PYTORCH_CUDA_ALLOC_CONF": "expandable_segments:False"})
    finally:
        del tuning.PROFILES["_probe"]
    assert got["PYTORCH_CUDA_ALLOC_CONF"] == (
        "garbage_collection_threshold:0.8,expandable_segments:False")


def test_unknown_profile_is_refused():
    with pytest.raises(ValueError, match="unknown tuning profile"):
        tuning.tuning_env("fast")


def test_same_profiles_as_jax():
    jt = pytest.importorskip("tpu_hpc.runtime.tuning")
    assert sorted(tuning.PROFILES) == sorted(jt.PROFILES)
    assert tuning._FORCE_PROFILES == jt._FORCE_PROFILES


def test_shell_output(capsys, monkeypatch):
    for var in ("CUDA_DEVICE_MAX_CONNECTIONS",
                "TORCH_NCCL_AVOID_RECORD_STREAMS"):
        monkeypatch.delenv(var, raising=False)
    assert tuning.main(["--profile", "collective-overlap", "--shell"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines == ["export CUDA_DEVICE_MAX_CONNECTIONS='1'",
                     "export TORCH_NCCL_AVOID_RECORD_STREAMS='1'"]
    assert tuning.main(["--profile", "memory-bound"]) == 0
    assert "PYTORCH_CUDA_ALLOC_CONF=expandable_segments:True" in \
        capsys.readouterr().out


@pytest.mark.parametrize("what", ["cuda", "nccl"])
def test_apply_tuning_refused_after_init(monkeypatch, what):
    import torch.distributed as dist

    if what == "cuda":
        monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    else:
        monkeypatch.setattr(dist, "is_initialized", lambda: True)
        monkeypatch.setattr(dist, "get_backend", lambda *a: "nccl")
    with pytest.raises(RuntimeError, match="already read its settings"):
        tuning.apply_tuning("collective-overlap")


def test_apply_tuning_sets_the_env(monkeypatch):
    monkeypatch.delenv("PYTORCH_CUDA_ALLOC_CONF", raising=False)
    monkeypatch.delenv("TORCH_NCCL_AVOID_RECORD_STREAMS", raising=False)
    env = tuning.apply_tuning("memory-bound")
    import os

    assert os.environ["PYTORCH_CUDA_ALLOC_CONF"] == \
        env["PYTORCH_CUDA_ALLOC_CONF"] == "expandable_segments:True"


def test_smoke_all_reduce_on_gloo_is_exact():
    ok, msg = env_check._smoke_all_reduce("cpu")
    assert ok, msg
    assert "gloo all_reduce over 1 rank(s)" in msg
    import torch.distributed as dist

    assert not dist.is_initialized()  # the one-rank world is torn down


def test_microbench_indeterminate_raises(monkeypatch):
    monkeypatch.setattr(env_check, "time_loop", lambda n, fn, x: 1.0)
    with pytest.raises(RuntimeError, match="indeterminate"):
        env_check.chip_microbench(dim=8, iters=1, device="cpu",
                                  copy_bytes=1024)
    with pytest.raises(RuntimeError, match="hbm copy timing indeterminate"):
        env_check._marginal(2.0, 2.0 - 5e-5, "hbm copy")
    assert env_check._marginal(2.0, 1.0, "matmul") == 1.0


def test_microbench_rates_on_the_cpu():
    rates = env_check.chip_microbench(dim=64, iters=20, device="cpu",
                                      copy_bytes=1 << 22)
    assert rates["matmul_tflops"] > 0 and rates["hbm_gb_s"] > 0


def test_version_pins_drift_is_a_warning(tmp_path):
    pins = tmp_path / "pins.txt"
    pins.write_text(f"# comment\ntorch=={torch.__version__}\n"
                    "numpy==0.0.1\nno-such-package==1.0\n")
    ok, msg = env_check.check_version_pins(pins)
    assert ok and "DRIFT" in msg
    assert "numpy: pinned 0.0.1" in msg and "no-such-package" in msg
    assert "torch:" not in msg
    ok, msg = env_check.check_version_pins(tmp_path / "none.txt")
    assert ok and "skipped" in msg


def test_check_environment_on_the_cpu(capsys):
    rep = env_check.check_environment(verbose=True, device="cpu")
    assert rep["all_passed"], rep["checks"]
    names = [c["name"] for c in rep["checks"]]
    assert names == ["version_pins", "all_reduce_smoke"]
    assert {"torch", "cuda", "nccl", "nvcc", "triton"} <= set(rep["versions"])
    assert "ALL CHECKS PASSED" in capsys.readouterr().out


def test_check_environment_without_a_card_fails(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rep = env_check.check_environment(verbose=False, device="cuda")
    assert not rep["all_passed"]
    failed = {c["name"] for c in rep["checks"] if not c["passed"]}
    assert failed == {"devices_visible", "all_reduce_smoke"}


def test_env_check_cli(capsys):
    assert env_check.main(["--device", "cpu"]) == 0
