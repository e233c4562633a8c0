"""Throughput accounting: model FLOPs utilization.

Ported from the JAX package's ``train/metrics.py``: only :func:`mfu`,
which ``serve/metrics.ServeMeter`` imports. The throughput and goodput
meters come with the training slice (ROADMAP).
"""
from __future__ import annotations


def mfu(
    tokens_per_s: float,
    n_params: int,
    n_devices: int,
    peak_flops_per_device: float,
    attn_flops_per_token: float = 0.0,
    mode: str = "train",
) -> float:
    """Model FLOPs utilization: achieved / peak.

    ``mode="train"`` (the default) uses the standard 6N FLOPs/token
    estimate for dense transformers (fwd 2N + bwd 4N).
    ``mode="inference"`` uses the forward-only 2N estimate: a decode
    step runs no backward, so judging serving throughput against 6N
    would understate its utilization 3x (the serving meter reports
    this mode). Optional explicit attention FLOPs add on either way.
    """
    factors = {"train": 6.0, "inference": 2.0}
    if mode not in factors:
        raise ValueError(
            f"unknown mfu mode {mode!r} (one of {sorted(factors)})"
        )
    flops_per_token = factors[mode] * n_params + attn_flops_per_token
    achieved = tokens_per_s * flops_per_token
    return achieved / (peak_flops_per_device * n_devices)
