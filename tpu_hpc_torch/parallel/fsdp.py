"""Fully-sharded data parallelism (ZeRO-3) as a plan.

Port of the JAX package's ``parallel/fsdp.py``: each tensor of at least
``min_size`` elements is sharded over ``data`` along its largest
divisible dim (the reference's ``min_num_params=1e5`` wrap policy);
smaller ones stay replicated in the plan. The trainer carries the plan
out with FSDP2 (``parallel/shard.py``), which all-gathers each block's
params before use and reduce-scatters its gradients.

``grad_op_pspecs`` (SHARD_GRAD_OP) and ``hybrid_shard_pspecs``
(HYBRID_SHARD) are not ported yet (ROADMAP: "Distributed leftovers").
"""
from __future__ import annotations

import math
from typing import Optional

from tpu_hpc_torch.parallel.plans import P, map_with_path, tree_specs

# Gradient-sync modes (config.comm_mode). The manual modes reduce the
# raw per-shard gradient, which equals the gradient contribution only
# when params are replicated over the sync axes; sharded plans keep
# "flat".
GRAD_SYNC_MODES = ("flat", "hierarchical", "bucketed_overlap")


def default_axis_size() -> int:
    """The job's process count (the JAX default is the device count):
    1 when no process group is up."""
    import torch.distributed as dist

    return dist.get_world_size() if dist.is_initialized() else 1


def validate_grad_sync_mode(mode: str, param_pspecs) -> str:
    """Check a comm_mode against a sharding plan; returns the mode.
    Manual modes (anything but "flat") need fully replicated params: a
    plan that shards any dim is refused, as in the JAX package."""
    if mode not in GRAD_SYNC_MODES:
        raise ValueError(
            f"unknown comm_mode {mode!r}; expected one of "
            f"{GRAD_SYNC_MODES}"
        )
    if mode == "flat":
        return mode
    sharded = [spec for spec in tree_specs(param_pspecs)
               if any(entry is not None for entry in spec)]
    if sharded:
        raise ValueError(
            f"comm_mode {mode!r} needs fully replicated params "
            f"(DDP-style), but the plan shards {len(sharded)} "
            "tensor(s) -- FSDP/TP layouts rely on the fused "
            "gather/scatter; use comm_mode='flat' for them (or "
            "dp.param_pspecs for a manual-sync run)"
        )
    return mode


def _choose_dim(shape, divisor: int, exclude: tuple = ()) -> Optional[int]:
    """The largest dim divisible by the axis size (dim 0 on ties);
    ``exclude`` skips dims already claimed by another axis."""
    best, best_size = None, -1
    for i, s in enumerate(shape):
        if i in exclude:
            continue
        if s % divisor == 0 and s > best_size:
            best, best_size = i, s
    return best


def param_pspecs(params, axis: str = "data",
                 axis_size: Optional[int] = None, min_size: int = 100_000):
    """Shard each large-enough tensor along its largest divisible dim."""
    if axis_size is None:
        axis_size = default_axis_size()

    def rule(_, leaf):
        shape = tuple(leaf.shape)
        if math.prod(shape) < min_size:
            return P()
        dim = _choose_dim(shape, axis_size)
        if dim is None:
            return P()
        spec = [None] * len(shape)
        spec[dim] = axis
        return P(*spec)

    return map_with_path(rule, params)


def batch_pspec(axis: str = "data") -> P:
    return P(axis)
