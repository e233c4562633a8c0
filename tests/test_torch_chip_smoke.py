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

