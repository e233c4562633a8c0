"""Weights into the serving layout.

Port of the JAX package's ``serve/weights.py``. The JAX version
reshards a trainer checkpoint onto the serving mesh; on one card the
serving layout is simply "on the device, in the compute dtype":

  * :func:`params_from_numpy` carries a JAX param tree across (as
    numpy arrays, e.g. ``jax.device_get(params)``) -- the parity tests
    and any JAX-trained weights enter the port this way;
  * :func:`place_params` moves a torch param tree onto the device.

Dense kernels keep flax's ``[in, out]`` layout in the serving param
dict, so the functional forward computes ``x @ W`` exactly as the JAX
engine's ``_dense`` does. Matrices (Dense kernels, the embedding) are
cast to ``cfg.dtype`` once, here -- the JAX engine casts them at every
use, to the same values. The 1-D RMSNorm scales stay float32, since
RMSNorm reads them in float32; casting them to bf16 would change their
values. Orbax checkpoint restore waits for a later slice (ROADMAP).
"""
from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from tpu_hpc_torch.models import llama2
from tpu_hpc_torch.runtime import resolve_device


def _place_leaf(t: torch.Tensor, cfg: llama2.LlamaConfig, device):
    dtype = cfg.dtype if t.dim() >= 2 else torch.float32
    return t.to(device=device, dtype=dtype)


def place_params(params: Mapping, cfg: llama2.LlamaConfig, device) -> dict:
    """A torch param tree on ``device``: matrices in ``cfg.dtype``,
    norm scales in float32. Leaves already placed are returned as they
    are (no copy)."""
    device = resolve_device(device)
    return {
        k: place_params(v, cfg, device) if isinstance(v, Mapping)
        else _place_leaf(v, cfg, device)
        for k, v in params.items()
    }


def params_from_numpy(tree: Mapping, cfg: llama2.LlamaConfig, device) -> dict:
    """A nested mapping of arrays (a flax param tree fetched to the
    host) -> the serving param dict on ``device``, same keys."""
    def to_torch(node):
        return {
            k: to_torch(v) if isinstance(v, Mapping)
            else torch.from_numpy(np.array(v, copy=True))
            for k, v in node.items()
        }

    return place_params(to_torch(tree), cfg, device)
