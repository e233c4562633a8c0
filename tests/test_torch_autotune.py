"""The port's autotuner (tpu_hpc_torch.kernels.autotune) on the CPU,
where every candidate runs the kernels' plain versions: the JAX
module's contract (tests/test_autotune.py: ranked records, the markdown
table, the pinned-forward backward sweep, the refusals and the warning)
against the port, the decode's n_split invariance, the "refused" row,
and the n_split keyword of the decode wrapper.

Tolerances: the plain flash versions ignore the tile constants, so the
numbers are identical across candidates (exact); the decode's two-pass
plain version sums per-run partials, so over a float32 pool it is held
to the one-pass plain version at atol 1e-5 / rtol 1e-5, and over a bf16
pool (P rounded per run) under the bf16 rule of checks/tolerance.py.
"""
import pytest
import torch

from tpu_hpc_torch.kernels import autotune
from tpu_hpc_torch.kernels import paged_attention as pa

B, S, H, D = 2, 256, 2, 64
CPU = dict(seq_len=S, batch=B, n_heads=H, head_dim=D, device="cpu",
           dtype=torch.float32)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The shapes here are tiny: one intra-op thread runs them as fast,
    and leaves the other cores to the test files running beside this
    one under xdist (timing-based tests among them)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_autotune_ranks_and_records():
    records = autotune.autotune(mode="grad", candidates=(2, 4), iters=2,
                                **CPU)
    assert len(records) == 2
    times = [r.ms_per_call for r in records]
    assert times == sorted(times)
    assert {r.defines["TPUHPC_FWD_STAGES"] for r in records} == {2, 4}
    assert [r.library_pick for r in records].count(True) == 1
    assert all(r.max_abs_err == 0.0 for r in records)  # plain versions
    md = autotune.to_markdown(
        records, seq_len=S, batch=B, n_heads=H, kv_heads=H, head_dim=D,
        device_kind="cpu")
    assert "Best:" in md and "ms/call" in md
    assert "(library)" in md
    # The CPU has no wall column: the host clock is the ranked time.
    assert all(r.wall_ms is None for r in records)


def test_autotune_sweep_bwd_appends_pinned_fwd_rows():
    records = autotune.autotune(mode="grad", candidates=(2, 3),
                                sweep_bwd=True, iters=1, **CPU)
    # 2 forward rows + 1 backward row (kBwdStep 64 is the forward
    # rows' own; another step is refused by the layout, unbuilt).
    assert len(records) == 3
    bwd_rows = [r for r in records if "kBwdStep" in r.candidate]
    assert len(bwd_rows) == 1 and records[-1] is bwd_rows[0]
    best_fwd = min((r for r in records if "kBwdStep" not in r.candidate),
                   key=lambda r: r.ms_per_call)
    assert bwd_rows[0].defines == best_fwd.defines
    assert bwd_rows[0].candidate == (
        f"kFwdStages={best_fwd.defines['TPUHPC_FWD_STAGES']} "
        f"kBwdStep={autotune.SWEPT_BWD_STEP}")
    assert bwd_rows[0].ms_per_call is None
    assert bwd_rows[0].reason() == autotune.BWD_STEP_LAYOUT


def test_bwd_step_reason_is_the_sources_static_assert():
    """The refused backward row quotes csrc/flash_attention.cu's own
    static_assert, which pins kBwdStep to 64."""
    import re
    from pathlib import Path

    src = (Path(autotune.__file__).resolve().parent.parent / "csrc"
           / "flash_attention.cu").read_text()
    m = re.search(r"static_assert\(kBwdStep == 64,\s*((?:\"[^\"]*\"\s*)+)\)",
                  src)
    assert m, "flash_attention.cu lost its kBwdStep static_assert"
    assert "".join(re.findall(r'"([^"]*)"', m.group(1))) == \
        autotune.BWD_STEP_LAYOUT
    assert re.search(r"constexpr int kBwdStep = 64;", src)
    assert "TPUHPC_BWD_STEP" not in src


def test_autotune_rejects_unknown_mode():
    with pytest.raises(ValueError):
        autotune.autotune(mode="bogus", candidates=(2,), iters=1, **CPU)


def test_autotune_rejects_no_fitting_candidate():
    cpu = dict(CPU, seq_len=64)
    with pytest.raises(ValueError, match="no candidate fits"):
        autotune.autotune(mode="fwd", candidates=(2, 4), iters=1, **cpu)
    with pytest.raises(ValueError, match="no candidate fits"):
        autotune.autotune(mode="decode", candidates=(65, 128), iters=1,
                          device="cpu", decode_kv_heads=2)


def test_autotune_warns_on_fwd_sweep_bwd(capsys):
    records = autotune.autotune(mode="fwd", sweep_bwd=True, candidates=(2,),
                                iters=1, **CPU)
    assert "ignoring" in capsys.readouterr().err
    assert all("kBwdStep" not in r.candidate for r in records)


def test_tiling_is_numerics_invariant():
    """The counterpart of the JAX test_bwd_tiling_is_numerics_invariant:
    every candidate's forward and gradients are held to the plain
    versions; on the CPU the candidates run the plain versions
    themselves, which no tile constant reaches, so every error is 0."""
    records = autotune.autotune(mode="grad", iters=1, sweep_bwd=True, **CPU)
    assert {r.defines["TPUHPC_FWD_STAGES"] for r in records} == {2, 3, 4}
    timed = [r for r in records if r.refused is None]
    assert len(timed) == 3 and len(records) == 4  # + the kBwdStep row
    assert all(r.max_abs_err == 0.0 for r in timed)


def _small_decode():
    return autotune.decode_case(torch.device("cpu"), 0, kv_heads=2, group=2,
                                head_dim=32)


def test_decode_is_invariant_across_n_split():
    from tpu_hpc_torch.checks.tolerance import compare

    args, kw = _small_decode()
    one_pass = pa.paged_decode_attention_ref(*args, **kw)
    q = args[0]
    args32 = tuple(a.float() if a.is_floating_point() else a for a in args)
    one_pass32 = pa.paged_decode_attention_ref(*args32, **kw)
    for n in (*autotune.DECODE_SPLITS, kw["max_blocks"]):
        out = pa.paged_decode_attention(*args, n_split=n, **kw)
        assert out.dtype == q.dtype and out.shape == q.shape
        assert compare(out, one_pass, q.dtype)["ok"], n
        # A float32 pool has no P rounding: the two passes equal the
        # one pass to fp32 summation order.
        out32 = pa.paged_decode_attention(*args32, n_split=n, **kw)
        torch.testing.assert_close(out32, one_pass32, atol=1e-5, rtol=1e-5)
        assert not out[args[5] == 0].any()  # inactive slot: zeros
    # None keeps the library's pick: on the CPU the one-pass version.
    assert torch.equal(pa.paged_decode_attention(*args, **kw), one_pass)


def test_decode_autotune_on_the_plain_versions():
    records = autotune._autotune_decode(autotune.DECODE_SPLITS, 1,
                                        torch.device("cpu"), 0,
                                        _small_decode())
    assert len(records) == len(autotune.DECODE_SPLITS) + 1
    assert [r.candidate for r in records if r.library_pick] == ["auto"]
    assert all(r.mode == "decode" and r.ms_per_call > 0 for r in records)
    md = autotune.to_markdown(records, seq_len=0, batch=0, n_heads=0,
                              kv_heads=0, head_dim=0, device_kind="cpu")
    assert "7B decode" in md and "Best:" in md


@pytest.mark.parametrize("n", [0, 65])
def test_decode_n_split_out_of_range_is_refused(n):
    args, kw = _small_decode()
    with pytest.raises(ValueError, match="n_split"):
        pa.paged_decode_attention(*args, n_split=n, **kw)


def test_markdown_refused_row():
    timed = autotune.TuneRecord("kFwdStages=4", "fwd", 0.155,
                                {"TPUHPC_FWD_STAGES": 4}, 0.0078, True)
    refused = autotune.TuneRecord(
        "kFwdStages=8", "fwd", None, {"TPUHPC_FWD_STAGES": 8},
        refused="nvcc failed (exit 2): nvcc ...\nflash_attention.cu(944): "
                "error: static assertion failed with \"kFwdStages: the Q "
                "tile and the K/V ring exceed 227 KB of shared memory\"\n"
                "1 error detected")
    records = autotune._sort([refused, timed])
    assert records == [timed, refused]  # refused rows sort last, kept
    md = autotune.to_markdown(records, seq_len=2048, batch=4, n_heads=8,
                              kv_heads=8, head_dim=128, device_kind="H100")
    row = [ln for ln in md.splitlines() if ln.startswith("| kFwdStages=8")]
    assert row and "refused" in row[0] and "static assertion failed" in row[0]
    header = [ln for ln in md.splitlines() if ln.startswith("| candidate")]
    assert row[0].count("|") == header[0].count("|")
    assert "Best: **kFwdStages=4 (library)** at 0.155 ms/call." in md
    only = autotune.to_markdown([refused], seq_len=2048, batch=4, n_heads=8,
                                kv_heads=8, head_dim=128, device_kind="H100")
    assert "every candidate was refused" in only


def test_a_wrong_candidate_is_an_error():
    bad = {"max_abs_err": 1.0, "ok": False}
    with pytest.raises(RuntimeError, match="disagrees with the plain"):
        autotune._check("kFwdStages=3", [{"max_abs_err": 0.0, "ok": True},
                                          bad])


def test_cli_on_the_cpu(capsys, tmp_path):
    out = tmp_path / "tune.md"
    assert autotune.main(["--device", "cpu", "--mode", "fwd", "--seq-len",
                          "256", "--batch", "1", "--heads", "2",
                          "--head-dim", "32", "--iters", "1",
                          "--out", str(out)]) == 0
    assert "Best:" in capsys.readouterr().out
    assert "ms/call" in out.read_text()
