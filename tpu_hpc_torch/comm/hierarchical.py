"""Two-tier hierarchical collectives: two-phase decompositions.

Port of the JAX package's ``comm/hierarchical.py``. The premise is the
reference's: the cross-node fabric (the inter-node network) is the
bottleneck while the inside of a node (NVLink) has bandwidth to spare. A
flat collective over the combined (dcn x inner) axis pushes the FULL
payload across nodes; the decompositions here push only the
1/n_inner-reduced shard across and keep the bulk on NVLink.

Mesh contract (the JAX one): two named axes for the same logical data
axis, the across-node (``dcn``) component varying slowest and the
inner one fastest -- ``runtime.mesh.two_tier_spec`` builds it, by node
on real nodes (``build_hybrid_mesh``) and emulated on one node or the
CPU. Data sharded over ``(dcn, inner)`` then matches a flat layout
shard for shard, so every decomposition is parity-testable against the
flat primitives in :mod:`tpu_hpc_torch.comm.primitives`.

Decompositions (per-rank payload S, n = n_dcn * n_inner):

==================  =============================================
op                  phases
==================  =============================================
all-reduce          inner reduce-scatter -> dcn all-reduce on the
                    S/n_inner shard -> inner all-gather
all-gather          dcn all-gather of the local shard -> inner
                    all-gather -> local reorder
reduce-scatter      local reorder -> inner reduce-scatter -> dcn
                    reduce-scatter on the 1/n_inner chunk
==================  =============================================

A size-1 dcn axis degrades every op to the flat inner collective, and
a size-1 inner axis to the pure dcn one. The phase functions
(``psum_two_phase`` etc.) take the two axes' process groups -- the
counterpart of the axis names inside a JAX ``shard_map`` -- and are what
the bucketed gradient sync (:mod:`tpu_hpc_torch.comm.overlap`)
composes; the ``hier_*`` wrappers take a mesh, as ``primitives`` does.
"""
from __future__ import annotations

from typing import Any, Callable, Tuple

import torch

from tpu_hpc_torch.comm.primitives import (
    all_gather_into,
    axis_group,
    reduce_scatter_into,
)

# Canonical axis names for a two-level data mesh (the JAX package's).
DCN_AXIS = "dcn"
ICI_AXIS = "ici"


def _axis_sizes(mesh: Any, dcn_axis: str, ici_axis: str) -> Tuple[int, int]:
    return (mesh.size(mesh.mesh_dim_names.index(dcn_axis)),
            mesh.size(mesh.mesh_dim_names.index(ici_axis)))


def _pad_leading(x: torch.Tensor, multiple: int):
    """Zero-pad dim 0 to a multiple (for the inner scatter phase);
    returns (padded, original_length)."""
    lead = x.shape[0]
    pad = (-lead) % multiple
    if pad:
        x = torch.cat([x, x.new_zeros((pad,) + x.shape[1:])], dim=0)
    return x, lead


def _gather(x: torch.Tensor, group, n: int) -> torch.Tensor:
    """Every rank's ``x`` stacked on a new leading dim ``[n, ...]``."""
    x = x.contiguous()
    out = x.new_empty((n * x.shape[0],) + x.shape[1:])
    all_gather_into(out, x, group)
    return out.reshape((n,) + x.shape)


def _scatter(x: torch.Tensor, group, n: int) -> torch.Tensor:
    x = x.contiguous()
    out = x.new_empty((x.shape[0] // n,) + x.shape[1:])
    reduce_scatter_into(out, x, group)
    return out


def _psum(x: torch.Tensor, group) -> torch.Tensor:
    import torch.distributed as dist

    out = x.clone()
    dist.all_reduce(out, group=group)
    return out


# ---------------------------------------------------------------------------
# Phase compositions over two process groups
# ---------------------------------------------------------------------------

def psum_two_phase(x: torch.Tensor, dcn_group, ici_group, *, n_dcn: int,
                   n_ici: int) -> torch.Tensor:
    """All-reduce ``x`` over (dcn x inner) as inner reduce-scatter ->
    dcn all-reduce on the 1/n_inner shard -> inner all-gather. Equal to
    a flat all-reduce over both axes, but only the reduced S/n_inner
    shard crosses nodes. Degenerate axes collapse to the flat
    single-axis all-reduce."""
    if n_dcn == 1:
        return _psum(x, ici_group)
    if n_ici == 1:
        return _psum(x, dcn_group)
    x, lead = _pad_leading(x, n_ici)
    y = _scatter(x, ici_group, n_ici)
    y = _psum(y, dcn_group)
    out = _gather(y, ici_group, n_ici).reshape(x.shape)
    return out[:lead] if out.shape[0] != lead else out


def all_gather_two_phase(x: torch.Tensor, dcn_group, ici_group, *,
                         n_dcn: int, n_ici: int) -> torch.Tensor:
    """Gather shards over (dcn x inner) into the flat combined-axis
    order (dcn slowest), pulling each shard across nodes exactly once:
    the dcn phase first, then the inner phase redistributes inside the
    node; the two stacked dims come out inner-major, and a local
    transpose restores the combined order."""
    if n_dcn == 1:
        return _gather(x, ici_group, n_ici).reshape(
            (n_ici * x.shape[0],) + x.shape[1:])
    if n_ici == 1:
        return _gather(x, dcn_group, n_dcn).reshape(
            (n_dcn * x.shape[0],) + x.shape[1:])
    y = _gather(x, dcn_group, n_dcn)            # [n_dcn, S, ...]
    z = _gather(y, ici_group, n_ici)            # [n_ici, n_dcn, S, ...]
    z = z.transpose(0, 1)                       # [n_dcn, n_ici, S, ...]
    return z.reshape((n_dcn * n_ici * x.shape[0],) + x.shape[1:])


def reduce_scatter_two_phase(x: torch.Tensor, dcn_group, ici_group, *,
                             n_dcn: int, n_ici: int) -> torch.Tensor:
    """Reduce-scatter ``x`` (each rank's full-size contribution) so rank
    (d, i) ends with the summed combined-order slice d * n_inner + i;
    only the 1/n_inner inner-reduced chunk crosses nodes. A local block
    transpose (inner-major) precedes the inner scatter so the two
    phases compose into the flat slice assignment. Dim 0 must divide by
    n_dcn * n_inner, as for the flat op."""
    if n_dcn == 1:
        return _scatter(x, ici_group, n_ici)
    if n_ici == 1:
        return _scatter(x, dcn_group, n_dcn)
    m = x.shape[0]
    n = n_dcn * n_ici
    if m % n:
        raise ValueError(
            f"reduce-scatter payload dim 0 ({m}) must divide by the "
            f"total axis size {n} (= dcn {n_dcn} x inner {n_ici}); the "
            "scattered slices must be whole"
        )
    blocks = x.reshape((n_dcn, n_ici, m // n) + x.shape[1:])
    xt = blocks.transpose(0, 1).reshape((m,) + x.shape[1:])
    y = _scatter(xt, ici_group, n_ici)
    return _scatter(y, dcn_group, n_dcn)


# ---------------------------------------------------------------------------
# One-op functions over a mesh, the primitives.py convention: what
# comm.bench times and the parity tests pin.
# ---------------------------------------------------------------------------

def _two_groups(mesh: Any, dcn_axis: str, ici_axis: str):
    n_dcn, n_ici = _axis_sizes(mesh, dcn_axis, ici_axis)
    return (axis_group(mesh, dcn_axis), axis_group(mesh, ici_axis),
            n_dcn, n_ici)


def hier_all_reduce(mesh: Any, dcn_axis: str = DCN_AXIS,
                    ici_axis: str = ICI_AXIS
                    ) -> Callable[[torch.Tensor], torch.Tensor]:
    """Hierarchical all-reduce over the (dcn x inner) data axis. Input:
    this rank's shard of the global array sharded over ``(dcn_axis,
    ici_axis)``; output replicated, equal to ``primitives.all_reduce``
    over both axes. Non-divisible leading dims are zero-padded for the
    scatter phase and sliced back after the gather."""
    dcn, ici, n_dcn, n_ici = _two_groups(mesh, dcn_axis, ici_axis)
    return lambda x: psum_two_phase(x, dcn, ici, n_dcn=n_dcn, n_ici=n_ici)


def hier_all_gather(mesh: Any, dcn_axis: str = DCN_AXIS,
                    ici_axis: str = ICI_AXIS
                    ) -> Callable[[torch.Tensor], torch.Tensor]:
    """Hierarchical all-gather: the dcn phase on the local shard, the
    inner phase inside the node, a local reorder to combined order."""
    dcn, ici, n_dcn, n_ici = _two_groups(mesh, dcn_axis, ici_axis)
    return lambda x: all_gather_two_phase(x, dcn, ici, n_dcn=n_dcn,
                                          n_ici=n_ici)


def hier_reduce_scatter(mesh: Any, dcn_axis: str = DCN_AXIS,
                        ici_axis: str = ICI_AXIS
                        ) -> Callable[[torch.Tensor], torch.Tensor]:
    """Hierarchical reduce-scatter: input replicated (each rank's copy
    its contribution), output this rank's slice of the sum in combined
    (dcn, inner) order, matching ``primitives.reduce_scatter``."""
    dcn, ici, n_dcn, n_ici = _two_groups(mesh, dcn_axis, ici_axis)
    return lambda x: reduce_scatter_two_phase(x, dcn, ici, n_dcn=n_dcn,
                                              n_ici=n_ici)


def groups_for(mesh: Any, sync_axes: Tuple[str, ...]):
    """``(dcn_group, inner_group, n_dcn, n_inner)`` of a two-axis sync
    (outer first)."""
    return _two_groups(mesh, sync_axes[0], sync_axes[1])

