"""The domain-parallel SimpleUNet: the whole encoder/decoder over
latitude bands.

Port of the JAX package's ``parallel/domain_unet.py``. It runs
``models/unet.py``'s own param and ``batch_stats`` trees through a
spatially sharded forward, so the one-device ``apply_unet`` is the
oracle for the whole network:

- 3x3 SAME convs -> :func:`domain.halo_conv2d` (1-row halos);
- 2x2 stride-2 max-pools -> :func:`domain.max_pool_2x2` (no halo);
- bilinear 2x upsampling -> :func:`domain.halo_upsample2x` (one halo row
  a side, edge-clamped at the global boundary);
- BatchNorm -> the shared ``models.resnet`` BatchNorm with its sums
  taken over every local tile and, through ``all_sum``, over the ranks
  that hold the rest of the batch and grid (data x spatial), so each
  band normalises with the global moments; the running stats come out
  the same on every rank.

The global H must divide by ``ring.n * 4`` (two pool levels of whole
windows per band). The odd 181-row grid belongs to the batch-parallel
``unet`` workload.
"""
from __future__ import annotations

from typing import Dict, List

import torch
import torch.nn.functional as F

from tpu_hpc_torch.models.losses import latitude_weights
from tpu_hpc_torch.models.resnet import (
    AllSum,
    apply_tree,
    bn_moments,
    bn_normalize,
    bn_running,
    nchw,
    nhwc,
)
from tpu_hpc_torch.models.unet import UNetConfig
from tpu_hpc_torch.parallel import domain


def _batch_norm(xs, p, ra, train: bool, all_sum: AllSum):
    """The shared BatchNorm over NHWC tiles: moments over every tile
    (and ``all_sum``'s ranks)."""
    views = [nchw(x) for x in xs]
    if train:
        mean, var = bn_moments(views, all_sum)
        new = bn_running(ra, mean, var)
    else:
        mean, var, new = ra["mean"], ra["var"], ra
    return [nhwc(bn_normalize(v, mean, var, p)) for v in views], new


def _conv_block(ring, p, ra, xs, train, all_sum):
    """(halo Conv3x3 -> BatchNorm -> ReLU) x 2 -- unet.conv_block."""
    new = {}
    for i in range(2):
        c = p[f"Conv_{i}"]
        xs = domain.halo_conv2d(xs, c["kernel"], c["bias"], ring=ring)
        xs, new[f"BatchNorm_{i}"] = _batch_norm(
            xs, p[f"BatchNorm_{i}"], ra[f"BatchNorm_{i}"], train, all_sum)
        xs = [F.relu(x) for x in xs]
    return xs, new


def _program(params, model_state, xs: List[torch.Tensor], ring,
             cfg: UNetConfig, train: bool, all_sum: AllSum):
    ra = model_state["batch_stats"]
    new: Dict[str, Dict] = {}

    def block(name, h):
        out, new[name] = _conv_block(ring, params[name], ra[name], h, train,
                                     all_sum)
        return out

    def cat(a, b):
        return [torch.cat([u, e], dim=-1) for u, e in zip(a, b)]

    xs = [x.to(cfg.dtype) for x in xs]
    e1 = block("enc1", xs)
    e2 = block("enc2", domain.max_pool_2x2(e1))
    b = block("bottleneck", domain.max_pool_2x2(e2))
    d2 = block("dec2", cat(domain.halo_upsample2x(b, ring), e2))
    d1 = block("dec1", cat(domain.halo_upsample2x(d2, ring), e1))
    h = params["head"]
    out = domain.halo_conv2d(d1, h["kernel"], h["bias"], ring=ring)
    state = {**model_state, "batch_stats": new} if train else model_state
    return [o.float() for o in out], state


def make_domain_unet(ring, cfg: UNetConfig, all_sum: AllSum = None):
    """``apply(params, model_state, x, train=True) -> (pred, new_state)``:
    the domain-parallel twin of ``models.unet.apply_unet`` on
    ``init_unet``'s trees. ``x`` holds this process's bands of an NHWC
    batch, concatenated along H -- the whole grid for an
    :class:`domain.InProcessHalo` (every band here), one band for a
    :class:`domain.ProcessGroupHalo`; ``pred`` has the same layout.
    ``all_sum`` sums the BatchNorm moments over the other processes that
    hold bands or batch rows (``models.resnet.group_sum`` over the data
    x spatial group); the in-process ring sums its own tiles."""
    def apply(params, model_state, x, train: bool = True):
        if x.shape[1] % (len(ring.ranks) * 4):
            raise ValueError(
                f"the bands' height {x.shape[1]} must divide by "
                f"{len(ring.ranks)} local bands x 4 (two pool levels)")
        h = x.shape[1] // len(ring.ranks)
        xs = [x[:, i * h:(i + 1) * h] for i in range(len(ring.ranks))]
        out, state = apply_tree(params, _program, model_state, xs, ring,
                                cfg, train, all_sum)
        return torch.cat(out, dim=1), state

    return apply


def band_lat_weighted_mse(pred: torch.Tensor, target: torch.Tensor,
                          n_lat: int, row0: int) -> torch.Tensor:
    """``losses.lat_weighted_mse`` of the rows ``[row0, row0 + H)`` of an
    ``n_lat``-row grid: the global grid's latitude weights, the band's
    mean. The mean of the bands' values is the whole grid's loss."""
    w = latitude_weights(n_lat, pred.dtype, pred.device)
    w = w[row0:row0 + pred.shape[1]]
    return torch.mean((pred - target) ** 2 * w[None, :, None, None])


def make_forward(ring, cfg: UNetConfig, all_sum: AllSum = None):
    """Trainer-contract forward: latitude-weighted MSE on (x, y) bands,
    weighted by the band's place in the whole grid (so the mean over
    the ranks is the whole grid's loss, and the ranks' averaged
    gradients its gradient)."""
    apply = make_domain_unet(ring, cfg, all_sum)
    first = ring.ranks[0]

    def forward(params, model_state, batch, step_rng):
        x, y = batch
        pred, new_state = apply(params, model_state, x, train=True)
        n_lat = x.shape[1] * ring.n // len(ring.ranks)
        row0 = first * x.shape[1] // len(ring.ranks)
        return band_lat_weighted_mse(pred, y, n_lat, row0), new_state, {}

    return forward


__all__ = ["band_lat_weighted_mse", "make_domain_unet", "make_forward"]
