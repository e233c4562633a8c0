"""Hybrid FSDP x TP (+SP): the two plans composed on a (data, model)
mesh.

Port of the JAX package's ``parallel/hybrid.py``: a param's TP spec
claims one dim on ``model``; FSDP then shards the largest remaining
divisible dim on ``data``. One spec tree drives the whole 2D layout.
The trainer carries it out as the reference's recipe does
(``fsdp_tp_example.py``): TP placements as DTensors on the ``model``
sub-mesh first, then FSDP2 over ``data``, with each param's data dim
handed to FSDP2 (``parallel/shard.py``).
"""
from __future__ import annotations

import math
from typing import Any, Optional, Sequence

from tpu_hpc_torch.parallel.fsdp import _choose_dim, default_axis_size
from tpu_hpc_torch.parallel.plans import P, Rule, map_with_path, pspec_tree


def fsdp_extend(
    specs: Any,
    params: Any,
    data_axis: str = "data",
    data_size: Optional[int] = None,
    min_size: int = 100_000,
) -> Any:
    """Add ZeRO-3 sharding on top of a TP spec tree: keep the TP-claimed
    dims, shard the largest unclaimed dim divisible by the data-axis
    size. Tensors under ``min_size`` elements stay as they are."""
    if data_size is None:
        data_size = default_axis_size()

    def extend(_, spec: P, leaf) -> P:
        shape = tuple(leaf.shape)
        if math.prod(shape) < min_size:
            return spec
        entries = list(spec) + [None] * (len(shape) - len(spec))
        claimed = tuple(i for i, e in enumerate(entries) if e is not None)
        best = _choose_dim(shape, data_size, exclude=claimed)
        if best is None:
            return spec
        entries[best] = data_axis
        return P(*entries)

    return map_with_path(extend, specs, params)


def hybrid_pspecs(
    params: Any,
    tp_rules: Sequence[Rule],
    data_axis: str = "data",
    data_size: Optional[int] = None,
    min_size: int = 100_000,
) -> Any:
    """TP rules first, FSDP fills the rest."""
    tp_specs = pspec_tree(params, tp_rules, default=P())
    return fsdp_extend(tp_specs, params, data_axis, data_size, min_size)
