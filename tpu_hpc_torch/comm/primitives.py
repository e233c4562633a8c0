"""Named collective primitives over a mesh axis.

Port of the JAX package's ``comm/primitives.py``: all-reduce,
all-gather, reduce-scatter, broadcast, send/recv around a ring and
all-to-all -- the reference's NCCL primitive set. The JAX helpers jit a
``shard_map`` program over one mesh axis; here each helper returns a
function of THIS rank's shard that runs the collective over the axis's
process group (``DeviceMesh.get_group``: NCCL on cards, gloo on the
CPU).

The global-shape contract is the JAX one. A rank's input is its shard
of the global array stacked along the axis (``in_spec``), and its output
is its part of the result the ``out_spec`` names: the whole result for a
replicated ``P()``, its own slice for ``P(axis)``. So the rank at
position i of a size-n axis holding ``x_i`` gets, for

  * ``all_reduce``:     ``sum_j x_j``                      (P(axis) -> P())
  * ``all_gather``:     ``concat_j x_j`` along dim 0        (P(axis) -> P())
  * ``reduce_scatter``: slice i of ``sum_j x_j``            (P()     -> P(axis))
  * ``broadcast``:      ``x_root``                          (P(axis) -> P())
  * ``ring_shift``:     ``x_{i - shift}``                   (P(axis) -> P(axis))
  * ``all_to_all``:     ``[a, n*b]`` blocks transposed to ``[n*a, b]``
                        (P(axis) -> P(None, axis)).

``comm.bench`` times exactly these; ``comm.hierarchical`` and
``comm.overlap`` compose the same process-group calls.
"""
from __future__ import annotations

from typing import Any, Callable

import torch


def axis_group(mesh: Any, axis: str):
    """The process group of ``mesh``'s ``axis`` (a ``DeviceMesh``), or
    the whole world when ``mesh`` is None."""
    import torch.distributed as dist

    if mesh is None:
        return dist.group.WORLD
    return mesh.get_group(axis)


def group_size(group) -> int:
    import torch.distributed as dist

    return dist.get_world_size(group)


def group_rank(group) -> int:
    """This rank's position in ``group``."""
    import torch.distributed as dist

    return dist.get_rank(group)


def global_rank(group, position: int) -> int:
    """The global rank at ``position`` (mod the size) of ``group``."""
    import torch.distributed as dist

    return dist.get_global_rank(group, position % group_size(group))


def reduce_scatter_into(out: torch.Tensor, x: torch.Tensor, group,
                        async_op: bool = False):
    """``out`` <- this rank's slice of the sum of every rank's ``x``
    (``reduce_scatter_single`` where torch has it, else
    ``reduce_scatter_tensor``: the same call under its older name)."""
    import torch.distributed as dist

    fn = getattr(dist, "reduce_scatter_single", None) \
        or dist.reduce_scatter_tensor
    return fn(out, x, group=group, async_op=async_op)


def all_gather_into(out: torch.Tensor, x: torch.Tensor, group,
                    async_op: bool = False):
    """``out`` <- every rank's ``x`` concatenated along dim 0 in group
    order (``all_gather_single`` / ``all_gather_into_tensor``)."""
    import torch.distributed as dist

    fn = getattr(dist, "all_gather_single", None) \
        or dist.all_gather_into_tensor
    return fn(out, x, group=group, async_op=async_op)


def all_reduce(mesh: Any, axis: str) -> Callable[[torch.Tensor], torch.Tensor]:
    """Sum across ``axis``; every rank gets the total (NCCL allreduce).
    Input: this rank's shard of a global ``[n*size, ...]`` stacked on
    ``axis``; output: the reduced ``[size, ...]``, replicated."""
    import torch.distributed as dist

    group = axis_group(mesh, axis)

    def fn(x: torch.Tensor) -> torch.Tensor:
        out = x.clone()
        dist.all_reduce(out, group=group)
        return out

    return fn


def all_gather(mesh: Any, axis: str) -> Callable[[torch.Tensor], torch.Tensor]:
    """Concatenate the shards along dim 0 on every rank (NCCL
    allgather)."""
    group = axis_group(mesh, axis)

    def fn(x: torch.Tensor) -> torch.Tensor:
        x = x.contiguous()
        out = x.new_empty((group_size(group) * x.shape[0],) + x.shape[1:])
        all_gather_into(out, x, group)
        return out

    return fn


def reduce_scatter(mesh: Any, axis: str) -> Callable[[torch.Tensor], torch.Tensor]:
    """Sum across ``axis`` then scatter dim-0 slices (NCCL
    reducescatter). Input: the global ``[m, ...]``, each rank's copy
    its contribution; output: this rank's summed ``[m/n, ...]`` slice."""
    group = axis_group(mesh, axis)

    def fn(x: torch.Tensor) -> torch.Tensor:
        n = group_size(group)
        if x.shape[0] % n:
            raise ValueError(
                f"reduce-scatter payload dim 0 ({x.shape[0]}) must divide "
                f"by the axis size {n}")
        x = x.contiguous()
        out = x.new_empty((x.shape[0] // n,) + x.shape[1:])
        reduce_scatter_into(out, x, group)
        return out

    return fn


def broadcast(mesh: Any, axis: str, root: int = 0
              ) -> Callable[[torch.Tensor], torch.Tensor]:
    """Every rank receives the shard of the rank at position ``root``
    (NCCL broadcast). The JAX helper is a masked psum; NCCL's own
    broadcast gives the same values."""
    import torch.distributed as dist

    group = axis_group(mesh, axis)

    def fn(x: torch.Tensor) -> torch.Tensor:
        out = x.clone()
        dist.broadcast(out, src=global_rank(group, root), group=group)
        return out

    return fn


def ring_shift(mesh: Any, axis: str, shift: int = 1
               ) -> Callable[[torch.Tensor], torch.Tensor]:
    """Neighbour exchange around the ``axis`` ring (the send/recv
    analogue): position i's shard moves to position (i + shift) mod n,
    one ``batch_isend_irecv``."""
    import torch.distributed as dist

    group = axis_group(mesh, axis)

    def fn(x: torch.Tensor) -> torch.Tensor:
        n = group_size(group)
        if n == 1 or shift % n == 0:
            return x.clone()
        me = group_rank(group)
        x = x.contiguous()
        out = torch.empty_like(x)
        ops = [dist.P2POp(dist.isend, x, global_rank(group, me + shift),
                          group),
               dist.P2POp(dist.irecv, out, global_rank(group, me - shift),
                          group)]
        for work in dist.batch_isend_irecv(ops):
            work.wait()
        return out

    return fn


def all_to_all(mesh: Any, axis: str) -> Callable[[torch.Tensor], torch.Tensor]:
    """Transpose dim-0 <-> dim-1 blocks across ``axis`` (NCCL alltoall;
    the Ulysses building block). Input: this rank's ``[a, n*b]`` shard
    of a global ``[n*a, n*b]`` sharded on dim 0; output: its ``[n*a,
    b]`` shard of the same array sharded on dim 1."""
    import torch.distributed as dist

    group = axis_group(mesh, axis)

    def fn(x: torch.Tensor) -> torch.Tensor:
        n = group_size(group)
        a, cols = x.shape[0], x.shape[1]
        if cols % n:
            raise ValueError(f"all_to_all: dim 1 ({cols}) must divide by "
                             f"the axis size {n}")
        # Column block j goes to position j; row block i of the result
        # comes from position i.
        send = x.reshape(a, n, cols // n).transpose(0, 1).contiguous()
        out = torch.empty_like(send)
        dist.all_to_all_single(out, send, group=group)
        return out.reshape(n * a, cols // n)

    return fn
