"""The flash-attention factory of the tensor-parallel layer.

Port of the single-device branch of the JAX package's
``parallel/tp.py::make_tp_flash_attn_fn``: with no mesh, or a mesh of
one device, it returns the bare closure around
``kernels.attention.blockwise_attention`` -- the whole training forward
reaches the flash kernels through this one factory, as in the JAX
package. Head-parallel attention over a (data, model) mesh is the
distributed slice's work (ROADMAP queue 1 item 5); a mesh with any axis
above one device raises until then.

``mesh``: None, a mapping of axis name to size, or an object with a
``size()`` method (``torch.distributed.device_mesh.DeviceMesh``). The
axis names, the ``wrap`` switch and the TPU's ``block_q`` / ``block_k``
tiling knobs come with a real mesh, or never (the Hopper kernels pick
their own tiles).
"""
from __future__ import annotations

import math
from typing import Any, Callable, Mapping

import torch

AttnFn = Callable[[torch.Tensor, torch.Tensor, torch.Tensor], torch.Tensor]


def mesh_size(mesh: Any) -> int:
    """Devices in ``mesh`` (None counts as one)."""
    if mesh is None:
        return 1
    if isinstance(mesh, Mapping):
        return math.prod(int(v) for v in mesh.values())
    return int(mesh.size())


def make_tp_flash_attn_fn(
    mesh: Any = None,
    *,
    causal: bool = True,
    impl: str = "auto",
) -> AttnFn:
    """``(q [B,S,Hq,D], k [B,S,Hkv,D], v) -> out [B,S,Hq,D]`` through
    the flash kernels (``impl="auto"``: the kernels for CUDA tensors,
    the reference path for CPU tensors). Only one device is ported:
    any mesh larger than that raises ``NotImplementedError``."""
    from tpu_hpc_torch.kernels.attention import blockwise_attention

    if mesh_size(mesh) > 1:
        raise NotImplementedError(
            f"make_tp_flash_attn_fn on a mesh of {mesh_size(mesh)} "
            "devices: data/tensor-parallel attention is not ported yet "
            "(ROADMAP queue 1 item 5); pass mesh=None for one device"
        )

    def flash(q, k, v):
        out, _ = blockwise_attention(q, k, v, causal=causal, impl=impl)
        return out

    return flash
