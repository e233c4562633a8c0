"""The rule the flash kernels are held to (tpu_hpc_torch/checks/tolerance.py),
on the CPU: it accepts the rounding a correct 16-bit kernel adds and
rejects the faults it exists to catch. This file imports no JAX."""
import numpy as np
import pytest
import torch

from tpu_hpc_torch.checks.tolerance import TOLERANCES, compare
from tpu_hpc_torch.kernels import attention as ta


def _attention(dtype, seed=0, b=2, n=96, h=2, d=32):
    """The plain forward's fp32 output and that output rounded to
    ``dtype``, as a correct kernel's final cast rounds it."""
    rng = np.random.default_rng(seed)
    q, k, v = (torch.from_numpy(rng.standard_normal((b, n, h, d))
                                .astype(np.float32)).to(dtype)
               for _ in range(3))
    want, _ = ta.flash_attention_fwd_ref(q.float(), k.float(), v.float())
    return want.to(dtype), want


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16], ids=str)
def test_accepts_the_final_rounding(dtype):
    got, want = _attention(dtype)
    r = compare(got, want, dtype)
    assert r["ok"] and r["tol_used"] < 0.5, r
    assert r["rel_rms_err"] < TOLERANCES[dtype].rel_rms / 2


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16], ids=str)
def test_rejects_late_rows_left_out(dtype):
    """Causal rows late in the sequence are small; zeroing them barely
    moves a bound scaled by the largest value, but fails a per-row one."""
    got, want = _attention(dtype)
    got = got.clone()
    got[:, 90:] = 0
    assert not compare(got, want, dtype)["ok"]


def test_rejects_a_diffuse_scale_error_by_relative_rms():
    got, want = _attention(torch.bfloat16)
    scaled = want * 1.01  # within rtol per element, not in RMS
    r = compare(scaled, want, torch.bfloat16)
    assert r["tol_used"] <= 1.0 and not r["ok"]


def test_zero_rows_must_be_exact_and_values_finite():
    _, want = _attention(torch.bfloat16)
    want = want.clone()
    want[0, 5] = 0.0
    got = want.clone()
    assert compare(got, want, torch.bfloat16)["ok"]
    got[0, 5, 0, 0] = 1e-6
    assert not compare(got, want, torch.bfloat16)["ok"]
    got = want.clone()
    got[1, 3, 1, 7] = float("nan")
    assert not compare(got, want, torch.bfloat16)["ok"]


def test_float32_is_absolute_and_relative_1e4():
    _, want = _attention(torch.float32)
    rng = np.random.default_rng(1)
    noise = torch.from_numpy(rng.uniform(-1, 1, want.shape).astype(np.float32))
    for scale in (5e-5, 3e-4):
        got = want + scale * noise
        assert compare(got, want, torch.float32)["ok"] == torch.allclose(
            got, want, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("q, pool, rule", [
    (torch.float32, torch.float32, torch.float32),
    (torch.float32, None, torch.float32),          # an int8 pool: P in fp32
    (torch.float32, torch.bfloat16, torch.bfloat16),
    (torch.float32, torch.float16, torch.float16),
    (torch.float16, torch.bfloat16, torch.bfloat16),
    (torch.bfloat16, torch.float16, torch.bfloat16),
    (torch.bfloat16, torch.float32, torch.bfloat16),
    (torch.float16, torch.float32, torch.float16),
    (torch.bfloat16, torch.bfloat16, torch.bfloat16),
], ids=str)
def test_rule_dtype_is_q_unless_p_is_rounded_coarser(q, pool, rule):
    """q's rule, unless the pool is a 16-bit dtype coarser than q's, to
    which P is rounded before P.V: then the pool's."""
    from tpu_hpc_torch.checks.tolerance import rule_dtype

    assert rule_dtype(q, pool) == rule
