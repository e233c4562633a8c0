"""chip_smoke.py's bookkeeping, on CPU: the -Xptxas -v summary of its
build line and the work (bytes, FLOPs) its bounds are computed from.
Imports no JAX and needs no card."""
import pytest

import chip_smoke

PTXAS_LOG = """\
ptxas info    : Compiling entry function '_ZN51_GLOBAL__N__9ef67e69_18_flash_attention_cu_2a72bd0a22flash_dkv_wgmma_kernelI13__nv_bfloat16Li128EEEv14CUtensorMap_stS2_S2_S2_PKfS4_PT_S6_iiiiiiiif' for 'sm_90a'
ptxas info    : Function properties for _ZN51_GLOBAL__N__9ef67e69_18_flash_attention_cu_2a72bd0a22flash_dkv_wgmma_kernelI13__nv_bfloat16Li128EEEv14CUtensorMap_stS2_S2_S2_PKfS4_PT_S6_iiiiiiiif
0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 240 registers, used 1 barriers
ptxas info    : Compiling entry function '_ZN51_GLOBAL__N__9ef67e69_18_flash_attention_cu_2a72bd0a15flash_dq_kernelIfEEvPKT_S3_S3_S3_PKfS5_PS1_iiiiiiiif' for 'sm_90a'
0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 40 registers, used 1 barriers
ptxas info    : Compiling entry function '_ZN51_GLOBAL__N__c2d5e0ab_18_paged_attention_cu_1a2b3c4d25paged_decode_split_kernelI13__nv_bfloat16Li128ELi1EEEvPKvPKT_S6_PKiS8_S8_PKfSA_PvPfSC_iiiiiiiiif' for 'sm_90a'
16 bytes stack frame, 16 bytes spill stores, 16 bytes spill loads
ptxas info    : Used 32 registers, used 1 barriers, 64 bytes smem
ptxas info    : Compiling entry function '_ZN51_GLOBAL__N__c2d5e0ab_18_paged_attention_cu_1a2b3c4d27paged_decode_combine_kernelEPKfS1_PKiPviiiii' for 'sm_90a'
0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 30 registers, used 1 barriers
"""


def test_ptxas_summary_names_each_kernel_and_its_spills():
    rows = chip_smoke.ptxas_summary(PTXAS_LOG)
    assert rows == [
        {"kernel": "flash_dkv_wgmma_kernel<bf16, 128>", "spill_stores": 0,
         "spill_loads": 0, "registers": 240, "smem_static": 0},
        {"kernel": "flash_dq_kernel<f32>", "spill_stores": 0,
         "spill_loads": 0, "registers": 40, "smem_static": 0},
        {"kernel": "paged_decode_split_kernel<bf16, 128, 1>",
         "spill_stores": 16, "spill_loads": 16, "registers": 32,
         "smem_static": 64},
        {"kernel": "paged_decode_combine_kernel", "spill_stores": 0,
         "spill_loads": 0, "registers": 30, "smem_static": 0},
    ]


@pytest.mark.parametrize("mangled, readable", [
    ("13__nv_bfloat16Li128E", "bf16, 128"),
    ("13__nv_bfloat16Li128ELb1E", "bf16, 128, true"),
    ("6__halfLi64ELb0E", "f16, 64, false"),
    ("6__halfLi64E", "f16, 64"),
    ("f", "f32"),
    ("13__nv_bfloat16S1_", "bf16, S1_"),
])
def test_template_args(mangled, readable):
    assert chip_smoke.template_args(mangled) == readable


def test_flash_work_counts_visible_pairs():
    """4, 6 and 8 x head_dim FLOPs per visible (row, key) pair; a causal
    square S x S has S (S + 1) / 2 of them, and a q_offset shifts the
    diagonal."""
    case = ("t", 2, 8, 8, 4, 2, 16, True, 0, 0, "bfloat16", False)
    work = chip_smoke.flash_work(case)
    pairs = 2 * 4 * 8 * 9 // 2
    assert work["flash_attention_fwd"][1] == 4 * 16 * pairs
    assert work["flash_attention_dq"][1] == 6 * 16 * pairs
    assert work["flash_attention_dkv"][1] == 8 * 16 * pairs
    q_bytes, kv_bytes, row_bytes = 2 * 8 * 4 * 16 * 2, 2 * 8 * 2 * 16 * 2, \
        2 * 8 * 4 * 4
    assert work["flash_attention_dkv"][0] == \
        2 * q_bytes + 4 * kv_bytes + 2 * row_bytes
    assert chip_smoke.visible_pairs(4, 6, True, 2, 0) == 3 + 4 + 5 + 6
    assert chip_smoke.visible_pairs(4, 6, False, 2, 0) == 24



def test_next_live_page_scales_shifts_the_live_pages_only():
    """The int8 scale control: each live page of the table row takes the
    next live page's K and V scales (the last takes the first's); dead
    and unlisted pages keep theirs."""
    import torch

    k_scale = torch.arange(10, dtype=torch.float32)
    v_scale = 100 + torch.arange(10, dtype=torch.float32)
    table = torch.tensor([4, 7, 2, 9, 9], dtype=torch.int32)
    kw = dict(block_size=16, max_blocks=5, k_scale=k_scale, v_scale=v_scale)
    bad = chip_smoke.next_live_page_scales(torch, kw, table, 3)
    assert bad["k_scale"][[4, 7, 2]].tolist() == [7.0, 2.0, 4.0]
    assert bad["v_scale"][[4, 7, 2]].tolist() == [107.0, 102.0, 104.0]
    others = [0, 1, 3, 5, 6, 8, 9]
    assert bad["k_scale"][others].tolist() == k_scale[others].tolist()
    assert bad["block_size"] == 16 and kw["k_scale"] is k_scale


def test_kernel_cases_cover_every_prefill_route():
    """bf16 and int8 pools at both shapes, every prefill at chunk 0 and
    at 256, and the scalar route's float32 and mixed-dtype pairs at the
    7B chunk; the int8 prefill has its own summary entry."""
    cases = chip_smoke.kernel_cases()
    prefill = {(shape, pool, q, start)
               for k, shape, _, pool, q, start in cases
               if k == "paged_prefill_attention"}
    for shape in ("7b", "gqa"):
        for pool in ("bfloat16", "int8"):
            for start in (0, 256):
                assert (shape, pool, "bfloat16", start) in prefill
    assert ("7b", "float32", "float32", 256) in prefill
    assert ("7b", "float16", "bfloat16", 256) in prefill
    assert len(cases) == 14
    name = chip_smoke.INT8_PREFILL
    assert chip_smoke.SOURCES[name] == chip_smoke.PAGED_SOURCE
    assert chip_smoke.REPLACES[name] == \
        chip_smoke.REPLACES["paged_prefill_attention"]


def test_phase_list_names_serve_spec_after_serve_int8():
    """serve_spec follows serve and serve_int8 and comes before the
    serving crosscheck; main drives it there."""
    import inspect
    import re

    doc = chip_smoke.__doc__
    order = [re.search(pat, doc, re.M).start() for pat in (
        r"^ *5\. serve ", r"^ *serve_int8 ", r"^ *serve_spec ",
        r"^ *6\. crosscheck ")]
    assert order == sorted(order)
    src = inspect.getsource(chip_smoke.main)
    calls = [src.index(f) for f in (
        '"serve_int8"', "serve_spec_phase(", "# -- 6. cross-check")]
    assert calls == sorted(calls)


def test_phase_list_names_serve_tier_fleet_after_serve_spec():
    """serve_tier_fleet follows serve_spec and comes before the serving
    crosscheck, in the docstring and in main; its launches ride the
    summary line. (Its gates run on CPU tensors in
    tests/test_torch_{tier,fleet,serve_weights}.py.)"""
    import inspect
    import re

    doc = chip_smoke.__doc__
    order = [re.search(pat, doc, re.M).start() for pat in (
        r"^ *serve_spec ", r"^ *serve_tier_fleet ", r"^ *6\. crosscheck ")]
    assert order == sorted(order)
    src = inspect.getsource(chip_smoke.main)
    calls = [src.index(f) for f in (
        "serve_spec_phase(", "serve_tier_fleet_phase(",
        "# -- 6. cross-check", '"serve_tier_fleet_launches"')]
    assert calls == sorted(calls)


def test_last_line_contract_is_unchanged():
    """The last print of main is the fixed result line, after the
    kernels line and nvidia-smi's line; without a card main prints no
    result and exits non-zero."""
    import inspect

    src = inspect.getsource(chip_smoke.main)
    tail = src[src.index('print(json.dumps({"kernels": kernels}))'):]
    assert tail.index("print(smi)") < tail.index('print(json.dumps({"ok"')
    assert 'print(json.dumps({"ok": True, "device": {\n' \
        '        "platform": "gpu", "kind": kind,\n' \
        '        "count": torch.cuda.device_count(),\n    }}))\n' \
        '    return 0\n' in tail


def test_chip_smoke_without_a_card_prints_no_result():
    import os
    import subprocess
    import sys

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=repo,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert out.stdout == ""


def _greedy_rows(**overrides):
    launches = {"paged_decode_attention": 0, "paged_prefill_attention": 9}
    rows = {}
    for kernel in ("cuda", "gather"):
        rows[f"{kernel}/plain"] = {"rebuilds": 0, "drained": True,
                                   "launches": launches}
        for mode in ("ngram", "draft", "self_draft"):
            rows[f"{kernel}/{mode}"] = {
                "rebuilds": 0, "drained": True, "launches": launches,
                "equals_plain": True, "differing": [],
                "spec_launches": {"draft": 0 if mode == "ngram" else 4,
                                  "verify": 8},
                "drafted": 12, "accepted": 12 if mode == "self_draft" else 0,
            }
    for key, fields in overrides.items():
        rows[key] = dict(rows[key], **fields)
    return rows


@pytest.mark.parametrize("overrides, failures", [
    ({}, 0),
    ({"cuda/ngram": {"equals_plain": False, "differing": ["r0003"]}}, 1),
    ({"gather/draft": {"equals_plain": False, "differing": ["r0000"]}}, 1),
    ({"cuda/draft": {"spec_launches": {"draft": 0, "verify": 8}}}, 1),
    ({"cuda/ngram": {"spec_launches": {"draft": 0, "verify": 0}}}, 1),
    ({"gather/ngram": {"spec_launches": {"draft": 0, "verify": 0}}}, 0),
    ({"cuda/plain": {"rebuilds": 1}}, 1),
    ({"cuda/ngram": {"drained": False}}, 1),
    ({"cuda/self_draft": {"accepted": 6}}, 0),
    ({"cuda/self_draft": {"accepted": 5}}, 1),
    ({"cuda/self_draft": {"drafted": 0, "accepted": 0}}, 1),
    ({"cuda/self_draft": {"spec_launches": {"draft": 0, "verify": 8}}}, 1),
])
def test_spec_greedy_failures(overrides, failures):
    """serve_spec (a) fails on a greedy token that differs from plain
    decode, a cuda-route spec run that did not launch its kernels, a
    rebuild, an undrained pool, or a self-draft that rejected more than
    half its drafts."""
    got = chip_smoke.spec_greedy_failures(_greedy_rows(**overrides))
    assert len(got) == failures, got


@pytest.mark.parametrize("ok, inactive_zero, control_ok, failures", [
    (True, True, False, 0),
    (True, True, True, 1),    # the control passes: the rule is too loose
    (False, True, False, 1),
    (True, False, False, 1),
])
def test_verify_kernel_failures(ok, inactive_zero, control_ok, failures):
    got = chip_smoke.verify_kernel_failures(
        {"ok": ok}, {"ok": control_ok}, inactive_zero)
    assert len(got) == failures


def test_spec_rng_check_runs_on_cpu_tensors():
    """serve_spec (b)'s code path with the CPU as the "card": every
    draw equal."""
    import torch

    checks = chip_smoke.spec_rng(torch, torch.device("cpu"))
    assert len(checks) == 12 and all(checks.values())


def test_phase_list_names_train_hybrid_after_train():
    """The docstring's phases, in order: train_hybrid follows train and
    comes before the profile and the crosscheck."""
    import re

    doc = chip_smoke.__doc__
    order = [re.search(rf"^ *{n}\. {name} ", doc, re.M).start()
             for n, name in ((7, "train"), (8, "train_hybrid"),
                             (9, "train_profile"), (10, "train_crosscheck"),
                             (11, "train_resilience"))]
    assert order == sorted(order)


@pytest.mark.parametrize("losses, launches, layout, failures", [
    ([2.0, 1.0], 4, {"fsdp_units": 9, "params": {"(Shard(dim=0),)": 3}}, 0),
    ([2.0 * (1 + 1.9e-3), 1.0], 4,
     {"fsdp_units": 9, "params": {"(Shard(dim=0),)": 3}}, 0),
    ([2.0 * (1 + 2.1e-3), 1.0], 4,
     {"fsdp_units": 9, "params": {"(Shard(dim=0),)": 3}}, 1),
    ([2.0], 4, {"fsdp_units": 9, "params": {"(Shard(dim=0),)": 3}}, 1),
    ([2.0, 1.0], 3, {"fsdp_units": 9, "params": {"(Shard(dim=0),)": 3}}, 1),
    ([2.0, 1.0], 4, {"fsdp_units": 9, "params": {"plain": 3}}, 1),
    ([2.0, 1.0], 4, None, 1),
])
def test_hybrid_failures(losses, launches, layout, failures):
    """train_hybrid fails on a loss off train's by more than
    HYBRID_LOSS_RTOL, a missing update, a wrong launch count, or params
    that are not DTensors under FSDP2."""
    assert chip_smoke.HYBRID_LOSS_RTOL == 2e-3
    got = chip_smoke.hybrid_failures(
        [2.0, 1.0], losses, {"flash_attention_fwd": launches,
                             "flash_attention_dq": 4}, 4, layout)
    assert len(got) == failures


# ---------------------------------------------------------------------
# train_resilience's helpers
# ---------------------------------------------------------------------

def test_nonfinite_rows_and_reading():
    import torch

    want = torch.zeros(2, 3, 4)
    want[0, 1, 2] = float("nan")
    got = want.clone()
    assert chip_smoke.nonfinite_rows(torch, want).tolist() == [
        [False, True, False], [False, False, False]]
    r = chip_smoke.nonfinite_reading(torch, got, want, torch.bfloat16)
    assert r["same_rows"] and r["ok"] and r["nonfinite"] == 1
    got[1, 0, 0] = float("inf")  # a row the plain version keeps finite
    assert not chip_smoke.nonfinite_reading(torch, got, want,
                                            torch.bfloat16)["ok"]
    got = want.clone()
    got[0, 0] += 1.0  # a finite row out of tolerance
    r = chip_smoke.nonfinite_reading(torch, got, want, torch.bfloat16)
    assert r["same_rows"] and not r["finite_rows_ok"] and not r["ok"]


def test_nonfinite_cases_sit_where_every_tile_reaches_them():
    """q rows in the last 128-row q tile, keys in the first key tile,
    inside the training shape; prefill keys in the chunk's first page."""
    b, s, h, d = chip_smoke.TRAIN_SHAPE
    for _, which, idx, value in chip_smoke.NONFINITE_FLASH:
        assert value in ("nan", "inf") and len(idx) == 4
        assert all(0 <= i < n for i, n in zip(idx, (b, s, h, d)))
        assert (idx[1] >= s - 128) if which == "q" else (idx[1] < 64)
    for _, which, idx, _ in chip_smoke.NONFINITE_PREFILL:
        assert len(idx) == (4 if which == "q" else 3)
        assert which == "q" or idx[0] < 16  # slot within a 16-token page


def test_flash_nonfinite_runs_on_cpu_tensors():
    """The check's code path at a small shape on the CPU, where each
    wrapper is its plain version: every planted case reads equal."""
    import torch

    cases = (("q_nan_row", "q", (0, 60, 1, 5), "nan"),
             ("k_inf_key", "k", (0, 3, 0, 4), "inf"),
             ("v_nan_key", "v", (0, 1, 1, 2), "nan"))
    rows = chip_smoke.flash_nonfinite(torch, torch.device("cpu"),
                                      shape=(1, 64, 2, 16), cases=cases)
    assert [r["case"] for r in rows] == [c[0] for c in cases]
    assert all(r["ok"] and r["lse_same_rows"] for r in rows)
    assert rows[0]["out"]["nonfinite"] == 1  # the NaN q row itself
    assert rows[2]["dv"]["nonfinite"] == 0


def test_snapshot_and_same_bits():
    import torch

    from tpu_hpc_torch.train.trainer import TrainState

    state = TrainState(3, {"a": torch.ones(2), "b": {"c": torch.zeros(3)}},
                       {"count": torch.tensor(2), "mu": [torch.ones(2),
                                                         torch.ones(3)]}, {})
    snap = chip_smoke.snapshot(torch, state)
    assert len(snap) == 5
    assert chip_smoke.same_bits(torch, snap, chip_smoke.snapshot(torch,
                                                                 state))
    state.params["a"].add_(1e-7)
    assert not chip_smoke.same_bits(torch, snap,
                                    chip_smoke.snapshot(torch, state))


def test_armed_sets_the_fault_plan_for_the_block(monkeypatch, tmp_path):
    import os

    monkeypatch.delenv("TPU_HPC_FAULTS", raising=False)
    with chip_smoke.armed("kill_at_step=3"):
        assert os.environ["TPU_HPC_FAULTS"] == "kill_at_step=3"
    assert "TPU_HPC_FAULTS" not in os.environ
    path = tmp_path / "run.jsonl"
    path.write_text('{"event": "a", "x": 1}\n{"event": "b"}\n'
                    '{"event": "a", "x": 2}\n')
    assert [r["x"] for r in chip_smoke.read_events(str(path), "a")] == [1, 2]
    (tmp_path / "d").mkdir()
    (tmp_path / "d" / "f").write_bytes(b"12345")
    assert chip_smoke.step_bytes(str(tmp_path / "d")) == 5


# ---------------------------------------------------------------------
# train_sp's helpers
# ---------------------------------------------------------------------

def test_phase_list_names_train_sp_after_train_hybrid():
    """train_sp follows train_hybrid and comes before the profile, in
    the docstring and in main."""
    import inspect
    import re

    doc = chip_smoke.__doc__
    order = [re.search(pat, doc, re.M).start() for pat in (
        r"^ *8\. train_hybrid ", r"^ *train_sp ", r"^ *9\. train_profile ")]
    assert order == sorted(order)
    src = inspect.getsource(chip_smoke.main)
    calls = [src.index(f) for f in (
        "train_hybrid_phase(", "train_sp_phase(", "train_profile_phase(")]
    assert calls == sorted(calls)


def test_sp_predicted_launches():
    """Each flash kernel's launches for one attention over a ring of 4:
    1 + 2 + 3 + 4 contiguous, 4 x 9 zigzag, one a rank for Ulysses; in
    (b)'s run on a context axis of 1, zigzag's three half-chunk pairs."""
    from tpu_hpc_torch.train.__main__ import bench_model_cfg

    assert [chip_smoke.sp_predicted_launches(m, 4)
            for m in chip_smoke.SP_MODES] == [10, 36, 4]
    cfg = bench_model_cfg()
    per = cfg.n_layers * chip_smoke.TRAIN_ACCUM * chip_smoke.TRAIN_STEPS \
        * chip_smoke.TRAIN_EPOCHS
    assert [chip_smoke.train_sp_expected(cfg, m)
            for m in chip_smoke.SP_MODES] == [per, 3 * per, per]


@pytest.mark.parametrize("mode", ["ring", "zigzag", "ulysses"])
def test_sp_shards_round_trip(mode):
    import torch

    x = torch.arange(2 * 16 * 3).reshape(2, 16, 3)
    shards = chip_smoke.sp_shards(torch, mode, 4, x)
    assert len(shards) == 4 and all(s.shape == (2, 4, 3) for s in shards)
    assert torch.equal(chip_smoke.sp_whole(torch, mode, shards), x)


def _sp_inputs(torch):
    gen = torch.Generator().manual_seed(0)
    return [torch.randn(shape, generator=gen) for shape in
            ((2, 32, 4, 16), (2, 32, 2, 16), (2, 32, 2, 16), (2, 32, 4, 16))]


@pytest.mark.parametrize("mode", ["ring", "zigzag", "ulysses"])
def test_sp_run_matches_the_reference_on_cpu(mode):
    """(a)'s drive on CPU tensors (the kernels' plain versions, float32):
    every rank's shard through the in-process ring of 4 equals the whole
    sequence's exact values and the one-device flash path's."""
    import torch

    from tpu_hpc_torch.checks.tolerance import compare
    from tpu_hpc_torch.parallel.sp_transport import InProcessRing

    q, k, v, dout = _sp_inputs(torch)
    got = chip_smoke.sp_run(torch, mode, InProcessRing(4), q, k, v, dout)
    for ref in (chip_smoke.sp_reference(torch, q, k, v, dout),
                chip_smoke.sp_flash(torch, q, k, v, dout)):
        for name in ("out", "dq", "dk", "dv"):
            assert compare(got[name], ref[name], torch.float32)["ok"], name


def test_frozen_offset_control_is_rejected():
    """The control: the ring with every kv_offset frozen at step 0's
    value (the rank's own chunk) masks earlier chunks as diagonals; the
    bf16 rule rejects its output, and the patch is gone after the
    block."""
    import torch

    from tpu_hpc_torch.checks.tolerance import compare
    from tpu_hpc_torch.kernels import attention as fa
    from tpu_hpc_torch.parallel import ring_attention as ra
    from tpu_hpc_torch.parallel.sp_transport import InProcessRing

    q, k, v, dout = _sp_inputs(torch)
    want = chip_smoke.sp_reference(torch, q, k, v, dout)["out"]
    real = ra.flash_attention_fwd
    with chip_smoke.frozen_ring():
        assert ra.flash_attention_fwd is not real
        assert fa.flash_attention_fwd is real  # the wrapper is untouched
        bad = chip_smoke.sp_run(torch, "ring", InProcessRing(4), q, k, v,
                                dout)["out"]
    assert ra.flash_attention_fwd is real
    assert not compare(bad, want, torch.bfloat16)["ok"]
    # rank 0 holds only its own chunk: its rows are untouched
    assert compare(bad[:, :8], want[:, :8], torch.float32)["ok"]
    calls = []
    frozen = chip_smoke.frozen_kv_offset(lambda *a, **kw: calls.append(a))
    frozen(q, k, v, 24, 8, causal=True)
    assert calls[0][3:] == (24, 24)


def test_sp_exact_readings_leave_out_only_the_one_key_rows():
    """Against the exact values: dq is read at the path's own D and
    leaves out position 0 (one visible key: rounding noise on both
    sides), and says so; noise there passes, a wrong later row fails;
    out, dk and dv are read whole. A path whose output is off moves D,
    and the out reading catches it."""
    import torch

    q, k, v, dout = (x.to(torch.bfloat16) for x in _sp_inputs(torch))
    exact = chip_smoke.sp_reference(torch, q, k, v, dout)
    got = {g: exact[g].clone() for g in ("out", "dq", "dk", "dv")}
    got["dq"][:, 0] = 1e-3
    r = chip_smoke.sp_exact_readings(torch, got, exact, q, k, v, dout)
    assert list(r) == ["out", "dq", "dk", "dv"]
    assert all(x["ok"] for x in r.values()), r
    assert r["dq"]["rows_left_out"] == 2 * 4
    assert r["dq"]["left_out_max_abs"] == pytest.approx(1e-3)
    got["dq"][:, 1] *= 1.5
    got["dv"][:, -1] = 0
    r = chip_smoke.sp_exact_readings(torch, got, exact, q, k, v, dout)
    assert not r["dq"]["ok"] and not r["dv"]["ok"] and r["dk"]["ok"]
    got = {g: exact[g].clone() for g in ("out", "dq", "dk", "dv")}
    got["out"][:, 5:] *= 1.1
    r = chip_smoke.sp_exact_readings(torch, got, exact, q, k, v, dout)
    assert not r["out"]["ok"]


def test_sp_flash_cases_are_pairs_the_sp_path_launches():
    """The flash phase's SP cases sit at (q_offset, kv_offset) pairs
    that train_sp launches: the ring and zigzag at degree 4 over S 2048,
    and zigzag at context 1."""
    from tpu_hpc_torch.parallel.ring_attention import live_pairs

    def offsets(layout, n, s):
        c = s // (n if layout == "ring" else 2 * n)
        return {(qid * c, kid * c, c) for r in range(n) for st in range(n)
                for _, _, qid, kid in live_pairs(layout, n, r, st, True)}

    launched = (offsets("ring", 4, 2048) | offsets("zigzag", 4, 2048)
                | offsets("zigzag", 1, 2048))
    cases = [c for c in chip_smoke.FLASH_CASES
             if c[0].startswith(("ring_", "zigzag_"))]
    assert len(cases) == 6
    for name, _, sq, sk, _, _, _, causal, qo, ko, _, _ in cases:
        assert causal and sq == sk and (qo, ko, sq) in launched, name
    assert {c[8] > c[9] for c in cases} == {True, False}


def test_zigzag_copy_bytes_match_the_chunk_layout():
    """What a zigzag call copies: the chunk-major layout of q, k, v and
    the output (forward), of dO, dq, dk, dv (backward), per rank; B 1
    copies nothing, as ring_attention._chunks says."""
    import torch

    from tpu_hpc_torch.parallel.ring_attention import _chunks

    b, s, hq, hkv, d, n = 4, 2048, 8, 2, 128, 4
    x = torch.zeros(b, s // n, hq, d, dtype=torch.bfloat16)
    assert _chunks(x, 2).data_ptr() != x.data_ptr()
    assert _chunks(x[:1], 2).data_ptr() == x.data_ptr()
    per_head = b * (s // n) * d * 2
    assert chip_smoke.zigzag_copy_bytes(b, s, hq, hkv, d, n) == \
        2 * (2 * hq + 2 * hkv) * per_head
    assert chip_smoke.zigzag_copy_bytes(1, s, hq, hkv, d, n) == 0


@pytest.mark.parametrize("ok, control_ok, launches, same, failures", [
    (True, False, 10, True, 0),
    (False, False, 10, True, 1),
    (True, True, 10, True, 1),
    (True, None, 10, True, 0),
    (True, False, 9, True, 1),
    (True, False, 10, False, 1),
])
def test_sp_failures(ok, control_ok, launches, same, failures):
    readings = {"out": {"ok": True}, "dq": {"ok": True},
                "dq_vs_exact": {"ok": ok}}
    control = None if control_ok is None else {"ok": control_ok}
    got = chip_smoke.sp_failures(
        readings, control, {"flash_attention_fwd": launches,
                            "flash_attention_dq": 10}, 10, same)
    assert len(got) == failures


# ---------------------------------------------------------------------
# train_pp's helpers, and the decode's non-finite cases
# ---------------------------------------------------------------------

def test_phase_list_names_train_pp_after_train_sp():
    """train_pp follows train_sp and comes before the profile, in the
    docstring and in main."""
    import inspect
    import re

    doc = chip_smoke.__doc__
    order = [re.search(pat, doc, re.M).start() for pat in (
        r"^ *train_sp ", r"^ *train_pp ", r"^ *9\. train_profile ")]
    assert order == sorted(order)
    src = inspect.getsource(chip_smoke.main)
    calls = [src.index(f) for f in (
        "train_sp_phase(", "train_pp_phase(", "train_profile_phase(")]
    assert calls == sorted(calls)


def test_pp_rows_are_the_bench_rows():
    """bench.py run_all's five llama-pp rows, in its order."""
    assert chip_smoke.PP_ROWS == (
        ("1f1b", "stack", "remat"), ("1f1b", "llama", "remat"),
        ("1f1b", "stack", "stash"), ("gpipe", "stack", "remat"),
        ("interleaved-1f1b", "stack", "remat"))


@pytest.mark.parametrize("schedule, backward, remat_stage, fwd", [
    ("1f1b", "remat", False, 192), ("interleaved-1f1b", "remat", False, 192),
    ("1f1b", "stash", False, 128), ("interleaved-1f1b", "stash", False, 128),
    ("gpipe", "remat", True, 128), ("interleaved", "remat", True, 128),
    ("gpipe", "remat", False, 64),
])
def test_pp_predicted_launches_per_bench_update(schedule, backward,
                                                remat_stage, fwd):
    """8 layers x 8 microbatches: forward launches 3, 2 or 1 per layer
    and microbatch, dq and dk/dv one each; six updates are six times."""
    got = chip_smoke.pp_predicted_launches(schedule, backward, remat_stage,
                                           8, 8)
    assert got == {"flash_attention_fwd": fwd, "flash_attention_dq": 64,
                   "flash_attention_dkv": 64}
    six = chip_smoke.pp_predicted_launches(schedule, backward, remat_stage,
                                           8, 8, updates=6)
    assert six == {k: 6 * n for k, n in got.items()}


@pytest.mark.parametrize("row", [
    ("1f1b", "remat", 1), ("1f1b", "stash", 1), ("gpipe", "remat", 1),
    ("interleaved", "remat", 2), ("interleaved-1f1b", "remat", 2),
    ("interleaved-1f1b", "stash", 2)])
def test_pp_predicted_launches_equal_the_driver(monkeypatch, row):
    """The stage attention's forward, dq and dk/dv calls of one pipelined
    update at 4 stages, counted where the wrappers launch their kernels
    (on the CPU they run the plain versions), equal the prediction."""
    import torch

    from tpu_hpc_torch.kernels import attention as fa
    from tpu_hpc_torch.models import pipeline_transformer as ptx
    from tpu_hpc_torch.parallel.pp_transport import InProcessPipe

    calls = {n: 0 for n in fa.FLASH_KERNELS}
    for name in fa.FLASH_KERNELS:
        orig = getattr(fa, name)

        def counted(*a, _orig=orig, _name=name, **kw):
            calls[_name] += 1
            return _orig(*a, **kw)

        monkeypatch.setattr(fa, name, counted)
    schedule, backward, v = row
    remat_stage = schedule in ("gpipe", "interleaved")
    n_layers, m = 8, 4
    cfg = ptx.PipeConfig(vocab_size=32, dim=16, n_heads=2, n_stages=4 * v,
                         layers_per_stage=n_layers // (4 * v),
                         max_seq_len=8)
    params = ptx.init_pipeline_transformer(torch.Generator().manual_seed(0),
                                           cfg)
    forward = ptx.make_forward(
        cfg, InProcessPipe(4), m, schedule=schedule, backward=backward,
        remat_stage=remat_stage, n_chunks=v,
        attn_fn=lambda q, k, v_: fa.blockwise_attention(
            q, k, v_, causal=True, impl="cuda")[0])
    params = ptx._map(lambda a: a.requires_grad_(), params)
    tok = torch.randint(0, 32, (8, 8))
    forward(params, {}, (tok, tok), None)[0].backward()
    assert calls == chip_smoke.pp_predicted_launches(
        schedule, backward, remat_stage, n_layers, m)


def test_pp_regroup_keeps_the_global_layer_order():
    import torch

    from tpu_hpc_torch.parallel import pp

    stages = {f"layer_{i}": {"w": torch.full((1, 2), float(i))}
              for i in range(8)}
    four = chip_smoke.pp_regroup(torch, stages, 4, 1)
    assert four["layer_1"]["w"][:, 0].tolist() == [1, 3, 5, 7]
    eight = chip_smoke.pp_regroup(torch, stages, 4, 2)
    seq = chip_smoke.pp_regroup(torch, stages, 4, 2, interleave=False)
    assert seq["layer_0"]["w"][:, 0].tolist() == list(range(8))
    assert eight["layer_0"]["w"][:, 0].tolist() == \
        pp.interleave_stacked(seq, 4)["layer_0"]["w"][:, 0].tolist() == \
        [0, 4, 1, 5, 2, 6, 3, 7]


def test_train_pp_in_process_checks_run_on_cpu():
    """(b) at a tiny width on the CPU: the 4-stage loss equals the
    1-stage run's bit for bit (the same attention path), loss and
    gradients pass the bf16 rule against the oracle, and the control
    (interleaved params in sequential order) is rejected."""
    import torch

    from tpu_hpc_torch.checks.tolerance import compare
    from tpu_hpc_torch.kernels.attention import blockwise_attention
    from tpu_hpc_torch.models import datasets
    from tpu_hpc_torch.train.__main__ import (
        PipeArgs,
        bench_model_cfg,
        run_train,
    )

    cfg = bench_model_cfg(16, dim=32, n_layers=8, n_heads=2, vocab_size=64,
                          multiple_of=16)
    dev = torch.device("cpu")

    def attn(q, k, v):
        return blockwise_attention(q, k, v, causal=True)[0]

    batch = datasets.TokenStream(vocab_size=64, seq_len=16, seed=0
                                 ).batch_at(0, 32)
    row = ("interleaved-1f1b", "stack", "remat")
    first = run_train(cfg, steps=1, epochs=1, grad_accum_steps=1,
                      device=dev, pp=PipeArgs(*row))["losses"][0]
    loss, grads, _, seq, v, _ = chip_smoke._pp_in_process(
        torch, dev, cfg, row, batch, attn)
    assert v == 2 and loss == first
    want_loss, want = chip_smoke._pp_oracle(torch, cfg, row, seq, batch,
                                            attn, v)
    assert compare(torch.tensor([[loss]]), torch.tensor([[want_loss]]),
                   torch.bfloat16)["ok"]
    assert chip_smoke.pp_grad_readings(torch, grads, want)["ok"]
    _, cgrads, _, cseq, _, _ = chip_smoke._pp_in_process(
        torch, dev, cfg, row, batch, attn, interleave=False)
    _, cwant = chip_smoke._pp_oracle(torch, cfg, row, cseq, batch, attn, v,
                                     interleave=False)
    assert not chip_smoke.pp_grad_readings(torch, cgrads, cwant)["ok"]


@pytest.mark.parametrize("losses, launches, moved, failures", [
    ([2.0] * 6, 10, False, 0),
    ([2.0] * 5, 10, False, 1),
    ([2.0] * 5 + [float("nan")], 10, False, 1),
    ([2.0] * 6, 9, False, 1),
    ([2.0] * 6, 10, True, 1),
])
def test_pp_failures(losses, launches, moved, failures):
    want = {"flash_attention_fwd": 10}
    got = {"flash_attention_fwd": launches}
    summary = {"flash_attention_fwd": launches + 1 if moved else launches}
    assert len(chip_smoke.pp_failures({"losses": losses}, got, want,
                                      summary)) == failures


def test_decode_and_scalar_prefill_nonfinite_run_on_cpu_tensors():
    """The new non-finite cases run end to end on CPU tensors (plain
    versions on both sides): the planted rows and only they come out
    non-finite, one per case, a whole slot's heads over an int8 page
    scale."""
    import torch

    rows = chip_smoke.decode_nonfinite(torch, torch.device("cpu"))
    assert [(r["pool"], r["case"]) for r in rows] == [
        (p, c[0]) for p in ("bfloat16", "int8")
        for c in chip_smoke.NONFINITE_DECODE]
    assert all(r["ok"] and r["nonfinite"] >= 1 for r in rows)
    assert [r["nonfinite"] for r in rows] == [1, 1, 1, 1, 32, 32]
    rows = chip_smoke.prefill_nonfinite(
        torch, torch.device("cpu"), cases=chip_smoke.NONFINITE_PREFILL[:1],
        routes=chip_smoke.NONFINITE_PREFILL_ROUTES[1:])
    assert [(r["pool"], r["q_dtype"]) for r in rows] == [
        ("float32", "float32"), ("float16", "bfloat16")]
    assert all(r["ok"] and r["nonfinite"] == 1 for r in rows)


# ---------------------------------------------------------------------
# train_comm's helpers
# ---------------------------------------------------------------------

def test_phase_list_names_train_comm_after_train_pp():
    """train_comm follows train_pp and comes before the profile, in the
    docstring and in main; the kernels line's flash rows carry its
    launches."""
    import inspect
    import re

    doc = chip_smoke.__doc__
    order = [re.search(pat, doc, re.M).start() for pat in (
        r"^ *train_pp ", r"^ *train_comm ", r"^ *9\. train_profile ")]
    assert order == sorted(order)
    src = inspect.getsource(chip_smoke.main)
    calls = [src.index(f) for f in (
        "train_pp_phase(", "train_comm_phase(", "train_profile_phase(")]
    assert calls == sorted(calls)
    assert 'entry["train_comm_launches"] = comm_launches[' in src
    assert chip_smoke.COMM_BENCH_SIZES == tuple(10 ** k for k in range(3, 9))


@pytest.mark.parametrize("overrides, failures", [
    ({}, 0),
    ({"losses": [2.0] * 5 + [2.1]}, 1),
    ({"launches": 383}, 1),
    ({"allreduces": 137}, 1),
    ({"resolved": "flat"}, 1),
    ({"losses": [2.0] * 5}, 1),
])
def test_comm_failures(overrides, failures):
    summary = {"losses": overrides.get("losses", [2.0] * 6),
               "comm_mode_resolved": overrides.get("resolved",
                                                   "bucketed_overlap"),
               "comm": {"n_buckets": 22,
                        "allreduces": overrides.get("allreduces", 138)}}
    launches = {"flash_attention_fwd": overrides.get("launches", 384)}
    assert len(chip_smoke.comm_failures(
        [2.0] * 6, summary, launches, 384, 6)) == failures


# ---------------------------------------------------------------------
# train_vision, train_domain, train_long and the ViT flash cases
# ---------------------------------------------------------------------

def test_phase_list_names_the_vision_domain_and_long_phases():
    """train_vision, train_domain and train_long follow train_comm and
    come before the profile, in the docstring and in main; the kernels
    line's flash rows carry their launches and the ViT case's times."""
    import inspect
    import re

    doc = chip_smoke.__doc__
    order = [re.search(pat, doc, re.M).start() for pat in (
        r"^ *train_comm ", r"^ *train_vision ", r"^ *train_domain ",
        r"^ *train_long ", r"^ *9\. train_profile ")]
    assert order == sorted(order)
    src = inspect.getsource(chip_smoke.main)
    calls = [src.index(f) for f in (
        "train_comm_phase(", "train_vision_phase(", "train_domain_phase(",
        "train_long_phase(", "train_profile_phase(")]
    assert calls == sorted(calls)
    for key in ('entry["train_vision_launches"]',
                'entry["train_long_launches"]', 'entry["vit_noncausal"]'):
        assert key in src


def test_vit_flash_cases_are_the_vits_attention():
    """The ViT's attention at examples/03's size: S = (64 / 4) x (128 /
    4) = 512 patches, 8 heads of 256 / 8 = 32, no causal mask; the S 512
    case timed, a ragged S 500 beside it; both run the controls and the
    determinism check, their zeroed rows inside the sequence."""
    cases = {c[0]: c for c in chip_smoke.FLASH_CASES}
    vit, ragged = cases["vit_noncausal"], cases["vit_noncausal_ragged"]
    assert vit[1:] == (chip_smoke.VIT_BATCH, 512, 512, 8, 8, 32, False, 0,
                       0, "bfloat16", True)
    assert ragged[1:] == (8, 500, 500, 8, 8, 32, False, 0, 0, "bfloat16",
                          False)
    for name in ("train_main", "vit_noncausal", "vit_noncausal_ragged"):
        assert 0 < chip_smoke.CONTROL_CASES[name] < cases[name][2]
    work = chip_smoke.flash_work(vit)
    assert work["flash_attention_fwd"][1] == 4 * 32 * 8 * 8 * 512 * 512


def test_rounding_controls_without_a_mask_on_cpu():
    """The rounding controls' non-causal forms are attention without a
    mask: the narrow accumulator walked in float32 tiles is the exact
    output, and rounded scores stay close to it."""
    import torch

    from tpu_hpc_torch.kernels.attention import attention_reference

    gen = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(1, 96, 2, 16, generator=gen) for _ in range(3))
    want = attention_reference(q, k, v, causal=False)[0]
    got = chip_smoke.out_with_narrow_accumulator(torch, q, k, v, tile=32,
                                                 causal=False)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    rounded = chip_smoke.out_with_rounded_scores(torch, q, k, v, causal=False)
    assert (rounded - want).abs().max() < 0.1


def _summary(losses, launches=36):
    return {"losses": losses,
            "kernel_launches": {"flash_attention_fwd": launches}}


@pytest.mark.parametrize("name, summary, expected, failures", [
    ("unet", _summary([1.0, 0.9, 0.8, 0.7, 0.6, 0.5]), None, 0),
    ("unet", _summary([1.0, 0.9, 0.8, 0.7, 0.6, 1.1]), None, 1),
    ("unet", _summary([1.0, float("nan"), 0.8, 0.7, 0.6, 0.5]), None, 1),
    ("unet", _summary([1.0, 0.9]), None, 1),
    ("vit", _summary([1.0, 1.1, 1.2, 1.3, 1.4, 1.5]), 36, 0),
    ("vit", _summary([1.0] * 6, launches=35), 36, 1),
    ("resnet", _summary([2.0, 2.5, 2.1, 2.2, 2.0, 1.9]), None, 0),
])
def test_vision_failures(name, summary, expected, failures):
    """Six updates expected: a missing or non-finite loss, a U-Net whose
    loss does not fall, or a launch count off the prediction fails."""
    assert len(chip_smoke.vision_failures(name, summary, 6,
                                          expected)) == failures


def _oks(*oks):
    return {k: {"ok": ok} for k, ok in zip(("out", "grads", "stats"), oks)}


@pytest.mark.parametrize("sound, control, failures", [
    ((True, True, True), (False, False), 0),
    ((True, False, True), (False, False), 1),
    ((False, True, False), (False, False), 2),
    ((True, True, True), (True, False), 0),
    ((True, True, True), (False, True), 0),
    ((True, True, True), (True, True), 1),
])
def test_domain_failures(sound, control, failures):
    """Each dtype's sound run fails on any reading not ok (here the
    float32 one's); each no-halo control must fail its output's or its
    gradients' check (here the bfloat16 one's)."""
    readings = {"float32": _oks(*sound), "bfloat16": _oks(True, True, True)}
    controls = {"float32": _oks(False, False), "bfloat16": _oks(*control)}
    assert len(chip_smoke.domain_failures(readings, controls)) == failures


def test_tracks_holds_a_run_to_its_counterparts_distance():
    import torch

    exact = torch.linspace(1.0, 2.0, 100)
    ref = exact * 1.01
    assert chip_smoke.tracks(exact * 1.015, ref, exact)["ok"]
    assert not chip_smoke.tracks(exact * 1.05, ref, exact)["ok"]
    assert chip_smoke.tracks(exact, exact, exact)["ok"]


def test_vit_update_checks_run_on_cpu(monkeypatch):
    """(c) on a small ViT on the CPU, where the kernels' wrappers run
    their plain versions: every attention call is recorded with its
    gradients and passes the rule, and the control that drops the last
    rows of every attention output is rejected by the per-call rule --
    while the model-level check alone accepts it."""
    import functools

    import torch

    from tpu_hpc_torch.models import vit

    monkeypatch.setattr(vit, "ViTConfig", functools.partial(
        vit.ViTConfig, lat=16, lon=32, embed_dim=32, depth=2, n_heads=2))
    monkeypatch.setattr(chip_smoke, "VIT_BATCH", 2)
    monkeypatch.setitem(chip_smoke.CONTROL_CASES, "vit_noncausal", 28)
    r = chip_smoke.vit_update_readings(torch, torch.device("cpu"))
    assert r["flash"]["ok"] and r["flash"]["attention"]["calls"] == 2
    assert r["flash"]["attention"]["dq"]["rel_rms_err"] == 0.0
    assert not r["control"]["ok"]
    assert not any(r["control"]["attention"][k]["ok"]
                   for k in ("out", "dq", "dk", "dv"))
    assert r["control"]["out"]["ok"]


@pytest.mark.parametrize("name, family", [
    ("flash_fwd_wgmma_kernel<__nv_bfloat16, 64>", "flash_attention"),
    ("ncclDevKernel_AllReduce_Sum_f32_RING_LL", "nccl"),
    ("sm90_xmma_fprop_implicit_gemm_bf16bf16_bf16f32_f32_nhwckrsc_nhwc",
     "conv"),
    ("cudnn::detail::dgrad2d_alg1_1", "conv"),
    ("sm90_xmma_gemm_bf16bf16_bf16f32_f32_tn_n_tilesize128x128x64",
     "matmul"),
    ("nvjet_tst_128x256_64x4_1x2_h_bz_coopA_TNT", "matmul"),
    ("void at::native::vectorized_elementwise_kernel<4, ...>",
     "elementwise"),
    ("void at::native::reduce_kernel<128, 4, ...>", "reduction"),
    ("void at::native::index_elementwise_kernel", "elementwise"),
    ("memcpy", "other"),
])
def test_kernel_family(name, family):
    """One classifier for every profiled update: convolutions before
    matmuls (cuDNN's implicit-GEMM kernels name both)."""
    assert chip_smoke.kernel_family(name) == family


def test_train_domain_checks_run_on_cpu(monkeypatch):
    """The phase at a small grid on the CPU (the card's calls made
    no-ops): the domain U-Net passes every check against the one-device
    U-Net, and the no-halo control is rejected."""
    import torch

    for fn in ("synchronize", "reset_peak_memory_stats", "empty_cache"):
        monkeypatch.setattr(torch.cuda, fn, lambda *a, **k: None)
    monkeypatch.setattr(torch.cuda, "max_memory_allocated",
                        lambda *a, **k: 0)
    monkeypatch.setattr(chip_smoke, "DOMAIN_GRID", (16, 8, 3))
    chip_smoke.train_domain_phase(torch, torch.device("cpu"))


def test_domain_grid_is_a_one_degree_band_the_bands_tile():
    lat, lon, ch = chip_smoke.DOMAIN_GRID
    assert lat % (chip_smoke.DOMAIN_DEGREE * 4) == 0 and lat <= 181
    assert lat + chip_smoke.DOMAIN_DEGREE * 4 > 181  # the largest that does
    assert (lon, ch) == (360, 20)


def test_phase_list_names_train_mpmd_after_train_pp():
    """train_mpmd follows train_pp and comes before train_comm, in the
    docstring and in main; its launches ride the summary line."""
    import inspect
    import re

    doc = chip_smoke.__doc__
    order = [re.search(pat, doc, re.M).start() for pat in (
        r"^ *train_pp ", r"^ *train_mpmd ", r"^ *train_comm ")]
    assert order == sorted(order)
    src = inspect.getsource(chip_smoke.main)
    calls = [src.index(f) for f in (
        "train_pp_phase(", "train_mpmd_phase(", "train_comm_phase(",
        '"train_mpmd_launches"')]
    assert calls == sorted(calls)


def test_mpmd_predicted_launches_per_step():
    """8 layers x 8 microbatches: the forward kernel twice per layer and
    microbatch (the forward and the backward program's recompute), dq
    and dk/dv once; three steps are three times."""
    one = chip_smoke.mpmd_predicted_launches(8, 8)
    assert one == {"flash_attention_fwd": 128, "flash_attention_dq": 64,
                   "flash_attention_dkv": 64}
    assert chip_smoke.mpmd_predicted_launches(8, 8, 3) == {
        k: 3 * n for k, n in one.items()}


@pytest.mark.parametrize("n_stages", [1, 4])
def test_mpmd_predicted_launches_equal_the_runtime(monkeypatch, n_stages):
    """The stage attention's forward, dq and dk/dv calls of one MPMD step
    (one stage, and 4 stages of 2 layers), counted where the wrappers
    launch their kernels (the plain versions here), equal the
    prediction."""
    import torch

    from tpu_hpc_torch.kernels import attention as fa
    from tpu_hpc_torch.kernels.attention import blockwise_attention
    from tpu_hpc_torch.models import pipeline_transformer as ptx
    from tpu_hpc_torch.parallel import mpmd

    calls = {n: 0 for n in fa.FLASH_KERNELS}
    for name in fa.FLASH_KERNELS:
        orig = getattr(fa, name)

        def counted(*a, _orig=orig, _name=name, **kw):
            calls[_name] += 1
            return _orig(*a, **kw)

        monkeypatch.setattr(fa, name, counted)
    cfg = ptx.PipeConfig(vocab_size=32, dim=16, n_heads=2,
                         n_stages=n_stages, layers_per_stage=8 // n_stages,
                         max_seq_len=8)
    params = ptx.init_pipeline_transformer(torch.Generator().manual_seed(0),
                                           cfg)
    bundle = ptx.mpmd_bundle(params, cfg, attn_fn=lambda q, k, v:
                             blockwise_attention(q, k, v, impl="cuda")[0])
    tok = torch.zeros((8, 8), dtype=torch.long)
    pipe = mpmd.MpmdPipeline(bundle, mpmd.MpmdConfig(n_microbatches=8),
                             devices=["cpu"] * n_stages).build(tok)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)  # tiny ops; leave the cores to other files
    try:
        pipe.run_step(0, tok, tok)
    finally:
        torch.set_num_threads(threads)
    assert calls == chip_smoke.mpmd_predicted_launches(8, 8)


def _mpmd_summary(**kw):
    return {"losses": [10.4, 10.3, 10.2], "measured_updates": 2,
            "recompiles": 0,
            "kernel_launches": chip_smoke.mpmd_predicted_launches(8, 8, 3),
            **kw}


@pytest.mark.parametrize("summary, launches, reloaded, failures", [
    ({}, None, False, 0),
    ({"losses": [10.4, float("nan"), 10.2]}, None, False, 1),
    ({"losses": [10.4, 10.3]}, None, False, 1),
    ({"recompiles": 1}, None, False, 1),
    ({}, None, True, 1),
    ({}, {"flash_attention_fwd": 0, "flash_attention_dq": 0,
          "flash_attention_dkv": 0}, False, 2),
])
def test_mpmd_a_failures(summary, launches, reloaded, failures):
    want = chip_smoke.mpmd_predicted_launches(8, 8, 3)
    got = chip_smoke.mpmd_a_failures(_mpmd_summary(**summary),
                                     want if launches is None else launches,
                                     want, reloaded)
    assert len(got) == failures, got


def _chaos_run(**kw):
    return {"losses": [[1.0, 2.0]], "states_equal": True, "rebuilt": [2],
            "kept_counts": 3, "redispatched": 8, "inflight": 8, **kw}


@pytest.mark.parametrize("run, ok", [
    ({}, True),
    ({"losses": [[1.0, 2.5]]}, False),      # the stale-snapshot control
    ({"states_equal": False}, False),
    ({"rebuilt": [1, 2]}, False),
    ({"kept_counts": 2}, False),
    ({"redispatched": 4}, False),
    ({"redispatched": 0, "inflight": 0}, False),
])
def test_mpmd_chaos_gate(run, ok):
    clean = {"losses": [[1.0, 2.0]]}
    assert chip_smoke.mpmd_chaos_gate(_chaos_run(**run), clean, 2,
                                      4)["ok"] is ok


def test_mpmd_gate_failures_count_failed_gates_and_passed_controls():
    assert chip_smoke.mpmd_gate_failures({
        "a": {"ok": True, "control_ok": False}, "b": {"ok": True}}) == []
    bad = chip_smoke.mpmd_gate_failures({
        "a": {"ok": False, "why": "x"}, "b": {"ok": True,
                                             "control_ok": True}})
    assert len(bad) == 2 and "control passed" in bad[1]


def test_mpmd_stages_gates_and_controls_on_the_cpu(monkeypatch, tmp_path):
    """train_mpmd (b) end to end on CPU tensors at a tiny size in float32
    (the plain versions in every stage): every gate passes and every
    control is rejected; the launch gate reads 0 launches here, where no
    kernel runs."""
    import dataclasses

    import torch

    from tpu_hpc_torch.kernels.attention import blockwise_attention
    from tpu_hpc_torch.train.__main__ import bench_model_cfg

    monkeypatch.chdir(tmp_path)
    cfg = dataclasses.replace(
        bench_model_cfg(16, dim=32, n_layers=8, n_heads=2, vocab_size=64,
                        multiple_of=16), dtype=torch.float32)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)  # tiny ops; leave the cores to other files
    try:
        b = chip_smoke.mpmd_stages(
            torch, torch.device("cpu"), cfg, mb_size=1, profile=False,
            attn_fn=lambda q, k, v: blockwise_attention(q, k, v,
                                                        impl="cuda")[0])
    finally:
        torch.set_num_threads(threads)
    gates = {k: b[k] for k in ("loss_vs_spmd", "grads_vs_oracle",
                               "clean_run", "chaos_kill", "chaos_nan")}
    assert chip_smoke.mpmd_gate_failures(gates) == []
    assert b["loss_vs_spmd"]["control_ok"] is False
    assert b["grads_vs_oracle"]["control_ok"] is False
    assert b["chaos_kill"]["control_ok"] is False
    assert b["chaos_kill"]["redispatched"] == 8
    assert b["chaos_nan"]["poisoned_windows"] == [
        {"stage": 1, "step": 2, "microbatch": 0, "phase": "forward"}]
    assert b["clean"]["compile_counts"] == [6, 3, 3, 5]


def test_phase_list_names_obs_capture_last():
    """obs_capture follows train_resilience in the docstring and in main,
    and its launches ride the summary line."""
    import inspect
    import re

    doc = chip_smoke.__doc__
    order = [re.search(pat, doc, re.M).start() for pat in (
        r"^ *11\. train_resilience ", r"^ *12\. obs_capture ")]
    assert order == sorted(order)
    src = inspect.getsource(chip_smoke.main)
    calls = [src.index(f) for f in (
        "train_resilience_phase(", "obs_capture_phase(",
        '"obs_capture_launches"', 'print(json.dumps({"kernels"')]
    assert calls == sorted(calls)


def test_device_kernel_counts_and_window_reading(tmp_path):
    """Kernel events of a Chrome trace counted by name (host ops and
    other categories are not kernels); a window's launches are the
    wrappers' counts at its close less those at its open."""
    import json

    trace = {"traceEvents": [
        {"ph": "X", "cat": "kernel",
         "name": "void paged_decode_split_kernel<__nv_bfloat16, 128, 1>()"},
        {"ph": "X", "cat": "kernel",
         "name": "void paged_decode_split_kernel<__nv_bfloat16, 128, 1>()"},
        {"ph": "X", "cat": "kernel", "name": "paged_decode_combine_kernel"},
        {"ph": "X", "cat": "kernel", "name": "elementwise_kernel"},
        {"ph": "X", "cat": "cpu_op", "name": "paged_decode_split_kernel"},
        {"ph": "M", "name": "process_name"},
    ]}
    path = tmp_path / "rank0.step3.pt.trace.json"
    path.write_text(json.dumps(trace))
    names = ("paged_decode_split_kernel", "paged_decode_combine_kernel",
             "paged_prefill_wgmma_kernel")
    assert chip_smoke.device_kernel_counts(str(path), names) == {
        "paged_decode_split_kernel": 2, "paged_decode_combine_kernel": 1,
        "paged_prefill_wgmma_kernel": 0, "all_kernels": 4}
    win = {"opened_at": 3, "open": {"paged_decode_attention": 5},
           "close": {"paged_decode_attention": 7}, "start_s": 0.1,
           "stop_export_s": 0.5,
           "trace_path": str(path)}
    reading = chip_smoke.window_reading(win, names)
    assert reading["launched"] == {"paged_decode_attention": 2}
    assert reading["device_events"]["paged_decode_split_kernel"] == 2


def test_complete_trace_failures():
    base = [{"event": "lg_arrival", "trace_id": "r:req:a"},
            {"event": "admission", "trace_id": "r:req:a", "rid": "a"},
            {"event": "admission"}]  # a batch-level record names none
    cp = {"attributed": 0.99}
    rep = {"orphan_spans": 0, "requests": {
        "count": 3, "complete": 2, "shed": 1,
        "ttft_critical_path": {q: cp for q in ("p50", "p95", "p99")}}}
    assert chip_smoke.complete_trace_failures(base, rep, 3) == []
    bad = {"orphan_spans": 2, "requests": {
        "count": 3, "complete": 1, "shed": 1,
        "ttft_critical_path": {"p50": {"attributed": 0.9}}}}
    fails = chip_smoke.complete_trace_failures(
        base + [{"event": "lg_finish"}], bad, 3)
    assert len(fails) == 6  # tags, orphans, requests, p50, p95, p99


def test_recorded_windows_restore_the_classes(tmp_path, monkeypatch):
    """The recorder wraps the profiler window and the capture trigger
    for its block only, reading the wrappers' counts at each end."""
    import torch

    from tpu_hpc_torch import obs
    from tpu_hpc_torch.obs import trace
    from tpu_hpc_torch.profiling import TrainingProfiler, profiler

    originals = (profiler.TrainingProfiler._start,
                 profiler.TrainingProfiler.stop, trace.AnomalyCapture.trigger)
    monkeypatch.setattr(torch.cuda, "max_memory_allocated", lambda d: 123)
    with chip_smoke.fresh_obs("rec"), \
            chip_smoke.recorded_windows(torch, "cpu") as (windows, triggers):
        cap = obs.AnomalyCapture(str(tmp_path / "cap"), n_steps=1)
        cap.trigger("stall", trace_id="rec:step:4", step=4)
        cap.step(5)
        TrainingProfiler(str(tmp_path / "p"), start_step=0,
                         device="cpu").stop()  # never opened: no window
    assert (profiler.TrainingProfiler._start, profiler.TrainingProfiler.stop,
            trace.AnomalyCapture.trigger) == originals
    (win,) = windows
    assert win["opened_at"] == 4 and win["open"] == win["close"]
    assert win["trace_path"].endswith("rank0.step4.pt.trace.json")
    (trig,) = triggers
    assert trig["reason"] == "stall" and trig["max_memory_allocated"] == 123
    assert trig["record"]["flight_path"].startswith(str(tmp_path / "cap"))


def test_phase_list_names_ops_after_obs_capture():
    """ops follows obs_capture in the docstring and in main, and its
    launches ride the summary line."""
    import inspect
    import re

    doc = chip_smoke.__doc__
    order = [re.search(pat, doc, re.M).start() for pat in (
        r"^ *12\. obs_capture ", r"^ *13\. ops ")]
    assert order == sorted(order)
    src = inspect.getsource(chip_smoke.main)
    calls = [src.index(f) for f in (
        "recorded_runs()", "obs_capture_phase(", "ops_phase(",
        '"ops_launches"', 'print(json.dumps({"kernels"')]
    assert calls == sorted(calls)


OPS_TINY = dict(dim=64, n_layers=2, n_heads=4, n_kv_heads=2, vocab_size=128,
                multiple_of=16, max_seq_len=64)


def test_ops_disagg_gates_pass_and_reject_the_control_on_cpu():
    """(a) at a tiny size on the CPU (both tiers on the CPU, the paged
    kernels' plain versions): the gates pass against the single tier's
    tokens, bf16 and int8 pools, and the wrong-page-id control is
    rejected."""
    import dataclasses

    import torch

    from tpu_hpc_torch.models import llama2 as tl
    from tpu_hpc_torch.serve import PagedConfig, ServeConfig
    from tpu_hpc_torch.serve.server import run_replay

    torch.set_num_threads(1)
    cfg = tl.LlamaConfig(dtype=torch.float32, **OPS_TINY)
    serve_cfg = ServeConfig(slots=4, max_seq_len=48,
                            prefill_buckets=(8, 16))
    paged = PagedConfig(block_size=4, num_blocks=48, prefill_chunk=8,
                        kernel="cuda")
    dev = torch.device("cpu")
    lens, n, max_new = (5, 11, 20, 7), 8, 6
    with chip_smoke.recorded_runs() as runs:
        run_replay(cfg, serve_cfg, n, lens, max_new, seed=0, paged=paged,
                   device=dev)
    single = runs[-1]
    got = chip_smoke.ops_disagg_run(torch, dev, cfg, serve_cfg, paged, n,
                                    prompt_lens=lens, max_new=max_new)
    assert chip_smoke.ops_disagg_failures(got, single, False) == []
    assert got["hop_pieces"] > n  # the 20-token prompts hop in two
    control = chip_smoke.ops_disagg_run(torch, dev, cfg, serve_cfg, paged, n,
                                        control=True, prompt_lens=lens,
                                        max_new=max_new)
    fails = chip_smoke.ops_disagg_failures(control, single, False)
    # The page check rejects it (on a tiny random model the greedy
    # tokens barely read the prompt's K/V, so they may not change).
    assert any("hops left the decode tier's pages unequal" in f
               for f in fails)
    assert control["hops"]["mismatched"] == control["hops"]["checked"] - 1
    # The int8 pool: pages and their scales hop, held to its own single
    # tier.
    int8 = dataclasses.replace(paged, kv_quant="int8")
    with chip_smoke.recorded_runs() as runs:
        run_replay(cfg, serve_cfg, n, lens, max_new, seed=0, paged=int8,
                   device=dev)
    got8 = chip_smoke.ops_disagg_run(torch, dev, cfg, serve_cfg, int8, n,
                                     prompt_lens=lens, max_new=max_new)
    assert chip_smoke.ops_disagg_failures(got8, runs[-1], False) == []
    assert got8["summary"]["disagg"]["kv_plans"][16]["steps"] == 4
    # A launch gate reads the tiers' counts: a decode launch on the
    # prefill tier fails it.
    bad = dict(got, tiers={"prefill": {"paged_decode_attention": 1,
                                       "paged_prefill_attention": 3},
                           "decode": {"paged_decode_attention": 5,
                                      "paged_prefill_attention": 0}})
    assert any("the other's kernel" in f for f in
               chip_smoke.ops_disagg_failures(bad, single, True))


def test_ops_reshard_and_elastic_parts_on_cpu(monkeypatch, tmp_path):
    """(b) and (c) at a tiny width on a one-rank gloo world: the state
    round trip is bit-equal and the held plan replays without new
    buffers; the storm gives 2 morphs, 3 segments and the fixed run's
    loss stream."""
    import torch
    import torch.distributed as dist

    from tpu_hpc_torch.runtime.sim import free_port
    from tpu_hpc_torch.train.__main__ import bench_model_cfg

    torch.set_num_threads(1)
    monkeypatch.setattr(chip_smoke, "TRAIN_BATCH", 4)
    monkeypatch.setattr(chip_smoke, "TRAIN_ACCUM", 2)
    monkeypatch.setattr(chip_smoke, "OPS_DIR", str(tmp_path / "ops"))
    cfg = bench_model_cfg(16, False, **{k: v for k, v in OPS_TINY.items()
                                        if k not in ("n_kv_heads",
                                                     "max_seq_len")})
    dev = torch.device("cpu")
    dist.init_process_group("gloo", init_method=f"tcp://localhost:"
                            f"{free_port()}", world_size=1, rank=0)
    try:
        state, state_fails = chip_smoke.ops_reshard_part(torch, dev, cfg)
        storm, storm_fails, _ = chip_smoke.ops_elastic_part(torch, dev, cfg)
    finally:
        dist.destroy_process_group()
    assert state_fails == [] and storm_fails == []
    assert state["plan"]["kinds"]["transfer"] > 0
    assert state["stages"] > 1  # the bound splits the move into stages
    assert storm["segments"] == [1, 1, 1]
    assert storm["loss_bit_identical"]


def test_native_tools_corpus_is_the_repos_markdown(tmp_path):
    """(a)'s corpus: every *.md at the root and under docs/, through the
    byte tokenizer; at seq 2048 it holds more windows than the run's 6
    updates of 32 read, so the run never wraps an epoch."""
    import os

    from tpu_hpc_torch.native import NativeTokenDataset, prepare_corpus

    root = os.path.dirname(os.path.abspath(chip_smoke.__file__))
    files = chip_smoke.corpus_files(root)
    assert os.path.join(root, "README.md") in files
    assert any("/docs/" in f for f in files)
    assert all(f.endswith(".md") for f in files)
    info = prepare_corpus(str(tmp_path / "c.bin"), files)
    ds = NativeTokenDataset(str(tmp_path / "c.bin"), chip_smoke.TRAIN_BATCH,
                            2048)
    updates = chip_smoke.NATIVE_STEPS * chip_smoke.NATIVE_EPOCHS
    assert ds.n_windows >= updates * chip_smoke.TRAIN_BATCH
    assert info["n_tokens"] == ds.n_tokens and ds.max_token_id == 256
    ds.close()


def test_native_tools_train_and_fit_parts_on_the_cpu(tmp_path, monkeypatch):
    """(a) and (b) at a tiny width on the CPU: the token-file run passes
    its gates, and the fit's static bytes equal, to the byte, the
    tensors the optimizer received at the first update."""
    import torch

    from tpu_hpc_torch.train.__main__ import bench_model_cfg

    from tpu_hpc_torch.train import __main__ as tmain

    torch.set_num_threads(1)
    monkeypatch.setattr(chip_smoke, "TRAIN_BATCH", 4)
    monkeypatch.setattr(chip_smoke, "TRAIN_ACCUM", 2)
    # The bench's 3e-4 barely moves a 64-wide model in 6 updates (its
    # losses sit in the noise around ln(300), whatever the repo's
    # Markdown holds); at 1e-2 the sixth is clearly below the first.
    monkeypatch.setattr(tmain, "LEARNING_RATE", 1e-2)
    cfg = bench_model_cfg(32, False, dim=64, n_layers=2, n_heads=4,
                          vocab_size=300, multiple_of=16)
    dev = torch.device("cpu")
    train = {"tokens_per_s": 1.0, "update_s": 1.0}
    row, fails, live = chip_smoke.native_train_part(
        torch, dev, train, str(tmp_path), cfg)
    assert fails == []
    assert row["launches"] == {k: 0 for k in row["launches"]}  # CPU
    assert row["corpus"]["windows_served"] == 6 * 4
    fit_row, fit_fails = chip_smoke.native_fit_part(torch, dev, live, cfg)
    assert fit_fails == []
    assert fit_row["static_bytes"] == live
    from tpu_hpc_torch.models import llama2

    assert live["params"] == live["grads"] == 4 * llama2.count_params(cfg)
    assert fit_row["backend"] == "gloo-cpu x 1"


def test_served_batches_records_and_restores(tmp_path):
    """The token-file gate's recorder: [step, CRC] of each batch the
    reader hands out inside the block, the reader's own method after."""
    import numpy as np

    from tpu_hpc_torch.native import NativeTokenDataset, write_token_dataset

    path = write_token_dataset(str(tmp_path / "c.bin"), np.arange(500) % 97)
    ds = NativeTokenDataset(path, 2, 16)
    with chip_smoke.served_batches() as served:
        x, y = ds.batch_at(3, 2)
        ds.batch_at(4, 2)
    ds.batch_at(5, 2)
    ds.close()
    assert [s for s, _ in served] == [3, 4]
    assert served[0][1] == chip_smoke.batch_crc(x, y)
    assert "batch_at" not in vars(NativeTokenDataset)


def test_state_bytes_counts_tensors_only():
    import torch

    params = [torch.zeros(3, 4), torch.zeros(5, dtype=torch.bfloat16)]
    state = {"count": 0, "mu": [torch.zeros(3, 4), torch.zeros(5)],
             "nu": [torch.zeros(3, 4), torch.zeros(5)]}
    assert chip_smoke.state_bytes(params, params, state) == {
        "params": 58, "grads": 58, "opt": 136}
    state["count"] = torch.zeros((), dtype=torch.int64)
    assert chip_smoke.state_bytes(params, params, state)["opt"] == 144
