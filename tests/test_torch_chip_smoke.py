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
