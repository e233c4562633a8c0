"""Loss functions, including the latitude-weighted MSE.

Port of the JAX package's ``models/losses.py``. ``cross_entropy``
reduces in float32 whatever the logits' dtype; the gold logit is a
gather (the JAX version's iota-compare mask exists only to avoid TPU
scatters in the backward).
"""
from __future__ import annotations

import torch


def latitude_weights(n_lat: int, dtype=torch.float32, device=None) -> torch.Tensor:
    """cos(lat) weights normalized to mean 1, for a grid of n_lat rows
    from -90..90 degrees."""
    lats = torch.linspace(-90.0, 90.0, n_lat, dtype=dtype, device=device)
    w = torch.cos(torch.deg2rad(lats))
    return w / w.mean()


def lat_weighted_mse(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Latitude-weighted MSE over NHWC grids (lat = dim 1)."""
    w = latitude_weights(pred.shape[1], pred.dtype, pred.device)
    se = (pred - target) ** 2
    return torch.mean(se * w[None, :, None, None])


def mse(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return torch.mean((pred - target) ** 2)


def cross_entropy(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Mean softmax cross-entropy over integer targets ([..., V] vs
    [...]), computed in float32 regardless of the logits' dtype."""
    logits = logits.to(torch.float32)
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, targets.long()[..., None])[..., 0]
    return torch.mean(logz - gold)
