"""SimpleUNet: the 3-level conv U-Net for ERA5-like weather grids.

Port of the JAX package's ``models/unet.py``: (Conv3x3 -> BatchNorm ->
ReLU) x 2 blocks, 2x2 stride-2 VALID max-pools (181 -> 90 -> 45 on the
1-degree grid), bilinear upsampling to the exact skip size (45 -> 90,
90 -> 181: odd grids survive the round trip) and a 1x1 head. The param
and ``model_state`` trees keep flax's keys (``enc1/Conv_0``,
``enc1/BatchNorm_0``, ...); batches are NHWC, activations NCHW in
``channels_last`` memory (``models.resnet``'s shared layers and
BatchNorm). ``F.interpolate(mode="bilinear", align_corners=False)`` is
``jax.image.resize(method="bilinear")`` when upsampling (half-pixel
centres, edge clamp).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Tuple

import torch
import torch.nn.functional as F

from tpu_hpc_torch.models import resnet
from tpu_hpc_torch.models.resnet import (
    AllSum,
    apply_tree,
    batch_norm,
    conv2d_same,
    init_bn,
    init_conv,
    nchw,
    nhwc,
)

@dataclasses.dataclass(frozen=True)
class UNetConfig:
    in_channels: int = 20
    out_channels: int = 20
    base_features: int = 64
    dtype: Any = torch.float32        # compute dtype
    param_dtype: Any = torch.float32  # storage dtype

    def block_channels(self) -> Dict[str, Tuple[int, int]]:
        """(in, out) channels of each ConvBlock."""
        f = self.base_features
        return {"enc1": (self.in_channels, f), "enc2": (f, 2 * f),
                "bottleneck": (2 * f, 4 * f), "dec2": (6 * f, 2 * f),
                "dec1": (3 * f, f)}


def init_unet(gen: torch.Generator, cfg: UNetConfig,
              device="cpu") -> Tuple[Dict, Dict]:
    """(params, model_state) from ``gen``: the JAX tree's keys, conv
    kernels OIHW, ``model_state = {"batch_stats": ...}``."""
    pd = cfg.param_dtype
    params: Dict[str, Any] = {}
    stats: Dict[str, Any] = {}
    for name, (cin, cout) in cfg.block_channels().items():
        bp, bs = {}, {}
        for i in range(2):
            bp[f"Conv_{i}"] = init_conv(gen, cin if i == 0 else cout, cout,
                                        3, pd, device, bias=True)
            bp[f"BatchNorm_{i}"], bs[f"BatchNorm_{i}"] = init_bn(cout, pd,
                                                                 device)
        params[name], stats[name] = bp, bs
    params["head"] = init_conv(gen, cfg.base_features, cfg.out_channels, 1,
                               pd, device, bias=True)
    return params, {"batch_stats": stats}


def params_from_numpy(tree, cfg: UNetConfig, device="cpu") -> Dict:
    """``init_unet``'s flax tree (numpy) -> the port's, in
    ``cfg.param_dtype`` (conv kernels HWIO -> OIHW)."""
    return resnet.params_from_numpy(tree, cfg.param_dtype, device)


def conv_block(p, ra, x, train: bool, all_sum: AllSum = None):
    """(Conv3x3 SAME -> BatchNorm -> ReLU) x 2 on an NCHW tensor."""
    new = {}
    for i in range(2):
        c = p[f"Conv_{i}"]
        x = conv2d_same(x, c["kernel"], c["bias"])
        x, new[f"BatchNorm_{i}"] = batch_norm(
            x, p[f"BatchNorm_{i}"], ra[f"BatchNorm_{i}"], train, all_sum)
        x = F.relu(x)
    return x, new


def bilinear_resize(x: torch.Tensor, hw: Tuple[int, int]) -> torch.Tensor:
    """NCHW bilinear resize to an exact size (half-pixel centres)."""
    return F.interpolate(x, size=tuple(hw), mode="bilinear",
                         align_corners=False)


def _unet(params, model_state, x, cfg: UNetConfig, train: bool,
          all_sum: AllSum):
    ra = model_state["batch_stats"]
    new: Dict[str, Any] = {}
    x = nchw(x.to(cfg.dtype))

    def block(name, h):
        out, new[name] = conv_block(params[name], ra[name], h, train,
                                    all_sum)
        return out

    e1 = block("enc1", x)
    e2 = block("enc2", F.max_pool2d(e1, 2, 2))
    b = block("bottleneck", F.max_pool2d(e2, 2, 2))
    d2 = block("dec2", torch.cat([bilinear_resize(b, e2.shape[2:]), e2], 1))
    d1 = block("dec1", torch.cat([bilinear_resize(d2, e1.shape[2:]), e1], 1))
    out = conv2d_same(d1, params["head"]["kernel"], params["head"]["bias"])
    state = {**model_state, "batch_stats": new} if train else model_state
    return nhwc(out).float(), state


def apply_unet(params, model_state, x: torch.Tensor, cfg: UNetConfig,
               train: bool = True, all_sum: AllSum = None):
    """NHWC grids -> (float32 NHWC prediction, new model_state);
    ``all_sum`` syncs the BatchNorm moments over a process group
    (``resnet.group_sum``)."""
    return apply_tree(params, _unet, model_state, x, cfg, train, all_sum)


def make_forward(cfg: UNetConfig, all_sum: AllSum = None):
    """Trainer-contract forward: latitude-weighted MSE on (x, y) grids
    (bench.py's ``unet`` row)."""
    from tpu_hpc_torch.models.losses import lat_weighted_mse

    def forward(params, model_state, batch, step_rng):
        x, y = batch
        pred, new_ms = apply_unet(params, model_state, x, cfg, True, all_sum)
        return lat_weighted_mse(pred, y), new_ms, {}

    return forward


def make_eval_forward(cfg: UNetConfig):
    """Trainer-contract eval forward: BatchNorm on the stored stats,
    latitude-weighted test MSE."""
    from tpu_hpc_torch.models.losses import lat_weighted_mse

    def eval_forward(params, model_state, batch):
        x, y = batch
        pred, _ = apply_unet(params, model_state, x, cfg, False)
        return lat_weighted_mse(pred, y), {}

    return eval_forward
