"""How a flash kernel's output is held against its plain version.

One rule for ``chip_smoke.py`` and the card tests, per input dtype.
Every element must satisfy

    |got - want| <= rtol * |want| + row_atol * rms_row(want) + atol

where ``rms_row`` is the root mean square of ``want`` over the last
(head_dim) axis of that element's row, and the whole tensor must keep
``||got - want|| / ||want|| <= rel_rms``.

Why per row. The 16-bit kernels round P and dS to the input dtype before
their products, as the JAX kernels do, while the plain versions stay in
fp32. That rounding error is a small multiple of the terms of each row's
sum, and so scales with the row's own magnitude, not with the largest
value of the tensor: in causal attention the first rows and keys are 10-
100x larger than the last. A bound scaled per row holds a late row as
tightly as an early one, so a kernel that skips the last keys or gets
P.V wrong on the last rows fails it, and a row that must be exactly zero
(no visible key) must be exactly zero. ``rtol`` carries the final
rounding of the output to the input dtype (one or two ulps).

The constants come from ``chip_smoke.py``'s flash phase on an NVIDIA
H100 80GB HBM3 (700 W), over its six cases. bf16: the largest
``row_atol`` a correct kernel needed (at ``rtol`` 2e-2) was 0.0097 and
its relative RMS error at most 0.0027; two forwards that round at the
wrong place (the scores before the softmax, the running output between
KV tiles) needed 0.030 and 0.039 at 0.0037. ``row_atol`` sits between
the two (about 1.75x from each), so both controls fail the rule, and
``rel_rms`` is about twice the correct reading. fp16: 0.0146 for dk (dS
rounded to fp16 loses precision where it falls below fp16's normal
range, as in the JAX kernel), 0.0025 or less elsewhere, and a relative
RMS error of at most 0.00033, so ``rel_rms`` is the tight check there.

Float32 keeps the absolute and relative 1e-4 of the first card tests:
its kernels take their products in another order than the plain
versions' (scalar FMAs, or split-TF32 passes whose hi + lo carries each
operand to 2^-22), with no rounding to a narrower type.

An output of q over a 16-bit KV pool of a coarser dtype than q's -- a
float32 q over a bf16 or f16 pool, an f16 q over a bf16 pool -- does
carry such a rounding: P is rounded to the pool's dtype before P.V (the
Pallas kernel's ``p.astype(v.dtype)``), by a blocked kernel relative to
its running max, by the plain version relative to the whole row's. Two
roundings of one P at different scales differ by up to an ulp of the
pool's dtype, so no blocked kernel meets q's rule there: not the JAX
Pallas prefill either, which rounds P page by page
(tests/test_torch_paged_attention.py holds it to the pool's rule
against the plain version). On an H100, the TF32 prefill kernel at the
7B chunk of 256 at start 256: float32 q over bf16 8.96x the float32
bound; f16 q over bf16 a relative RMS error of 0.00135 against f16's
0.001 (PERF.md, the kernel table). :func:`rule_dtype` names the rule
such an output is held to: the pool's.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch


@dataclasses.dataclass(frozen=True)
class Tolerance:
    rtol: float
    row_atol: float
    atol: float
    rel_rms: Optional[float]


TOLERANCES: Dict[torch.dtype, Tolerance] = {
    torch.bfloat16: Tolerance(rtol=2e-2, row_atol=1.7e-2, atol=0.0,
                              rel_rms=5e-3),
    torch.float16: Tolerance(rtol=4e-3, row_atol=3e-2, atol=0.0,
                             rel_rms=1e-3),
    torch.float32: Tolerance(rtol=1e-4, row_atol=0.0, atol=1e-4,
                             rel_rms=None),
}


def rule_dtype(q_dtype: torch.dtype,
               pool_dtype: Optional[torch.dtype] = None) -> torch.dtype:
    """The dtype whose rule holds an attention output of q in
    ``q_dtype`` over K/V in ``pool_dtype``: q's, unless the pool is a
    16-bit dtype coarser than q's, to which P is rounded before P.V (see
    above) -- then the pool's."""
    if pool_dtype in (torch.bfloat16, torch.float16) and \
            torch.finfo(pool_dtype).eps > torch.finfo(q_dtype).eps:
        return pool_dtype
    return q_dtype


def compare(got: torch.Tensor, want: torch.Tensor,
            dtype: torch.dtype) -> dict:
    """Readings of ``got`` against ``want`` under the rule for inputs of
    ``dtype``: ``max_abs_err``; ``tol_used``, the largest share of its
    element's bound that any element's error takes (the rule holds at
    <= 1); ``row_atol_needed``, the least ``row_atol`` that would pass
    every element at this ``rtol`` and ``atol`` (what the constants are
    chosen from); ``rel_rms_err``; and ``ok``."""
    tol = TOLERANCES[dtype]
    got, want = got.float(), want.float()
    if not torch.isfinite(got).all():
        return {"max_abs_err": float("inf"), "tol_used": float("inf"),
                "row_atol_needed": float("inf"),
                "rel_rms_err": float("inf"), "ok": False}
    err = (got - want).abs()
    row_rms = want.square().mean(dim=-1, keepdim=True).sqrt()
    bound = tol.rtol * want.abs() + tol.row_atol * row_rms + tol.atol
    share = torch.where(bound > 0, err / bound,
                        torch.where(err > 0, float("inf"), 0.0))
    over = (err - tol.rtol * want.abs() - tol.atol).clamp_min(0)
    need = torch.where(row_rms > 0, over / row_rms,
                       torch.where(over > 0, float("inf"), 0.0))
    norm = float(torch.linalg.vector_norm(want))
    diff = float(torch.linalg.vector_norm(got - want))
    rel_rms = diff / norm if norm > 0 else (0.0 if diff == 0 else
                                            float("inf"))
    used = float(share.max())
    ok = used <= 1.0 and (tol.rel_rms is None or rel_rms <= tol.rel_rms)
    return {"max_abs_err": float(err.max()), "tol_used": used,
            "row_atol_needed": float(need.max()), "rel_rms_err": rel_rms,
            "ok": ok}


__all__ = ["TOLERANCES", "Tolerance", "compare", "rule_dtype"]
