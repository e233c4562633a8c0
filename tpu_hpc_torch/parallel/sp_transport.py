"""How sequence-parallel attention moves tensors between context ranks.

The JAX package moves K/V with ``jax.lax.ppermute`` and exchanges heads
with ``jax.lax.all_to_all`` inside ``shard_map``, and XLA schedules both.
The port keeps these moves behind one small interface with two
implementations:

  * :class:`ProcessGroupRing` -- this process is one rank of the context
    group (a ``torch.distributed`` process group: NCCL on cards, gloo on
    the CPU). ``shift`` posts one ``batch_isend_irecv`` (send to ring
    position ``me + 1``, receive from ``me - 1``) and returns its wait;
    ``all_to_all`` is ``all_to_all_single`` inside an autograd function
    whose backward is the inverse exchange; ``move_chunks`` is one batch
    of point-to-point sends, its backward the inverse moves.
  * :class:`InProcessRing` -- all ``n`` ranks' shards in one process, on
    one device. ``shift`` hands rank i's buffers to rank i + 1 (no copy);
    ``all_to_all`` and ``move_chunks`` are tensor indexing, differentiable
    as they stand. The attention functions then run the n ranks'
    schedules step by step, in the order each rank would. NCCL puts no
    two ranks on one card, so this is how one card runs the schedule of
    a ring of degree n; no CLI flag selects it. ``InProcessRing(1)`` is
    the ring of one rank that a run without a context axis takes.

Every method takes and returns one entry per *local* rank: ``ranks`` are
the ring positions this process plays, ``(me,)`` or ``range(n)``.
"""
from __future__ import annotations

from typing import Callable, List, Sequence, Tuple

import torch

# A chunk move: ((source rank, source slot), (destination rank, slot)).
Move = Tuple[Tuple[int, int], Tuple[int, int]]
Wait = Callable[[], List[List[torch.Tensor]]]


class InProcessRing:
    """All ``n`` ring ranks in this process (see the module docstring)."""

    def __init__(self, n: int):
        if n < 1:
            raise ValueError(f"a ring needs n >= 1 ranks, got {n}")
        self.n = n
        self.ranks = tuple(range(n))

    def shift(self, sends: Sequence[Sequence[torch.Tensor]]) -> Wait:
        """Rank i's tensors go to rank i + 1 (mod n)."""
        recv = [list(sends[(i - 1) % self.n]) for i in range(self.n)]
        return lambda: recv

    def all_to_all(self, xs: Sequence[torch.Tensor], split_axis: int,
                   concat_axis: int) -> List[torch.Tensor]:
        """``jax.lax.all_to_all(tiled=True)``: rank j gets the j-th part
        of every rank's tensor split along ``split_axis``, concatenated
        in rank order along ``concat_axis``."""
        parts = [x.chunk(self.n, split_axis) for x in xs]
        return [torch.cat([p[j] for p in parts], concat_axis)
                for j in range(self.n)]

    def move_chunks(self, xs: Sequence[torch.Tensor],
                    moves: Sequence[Move]) -> List[torch.Tensor]:
        """Chunk-major tensors ``[slots, ...]`` per rank -> the same
        after every chunk has moved as ``moves`` says."""
        out = {}
        for (src, s_slot), (dst, d_slot) in moves:
            out[dst, d_slot] = xs[src][s_slot]
        slots = xs[0].shape[0]
        return [torch.stack([out[r, s] for s in range(slots)])
                for r in self.ranks]


class ProcessGroupRing:
    """This process as one rank of ``group``'s ring (see the module
    docstring)."""

    def __init__(self, group):
        import torch.distributed as dist

        self.group = group
        self.n = dist.get_world_size(group)
        self.ranks = (dist.get_rank(group),)

    def _peer(self, position: int) -> int:
        import torch.distributed as dist

        return dist.get_global_rank(self.group, position % self.n)

    def shift(self, sends: Sequence[Sequence[torch.Tensor]]) -> Wait:
        """Post the sends to ``me + 1`` and the receives from ``me - 1``
        (one ``batch_isend_irecv``); the returned wait blocks until the
        receives have landed (on a card: orders the current stream after
        them) and returns them."""
        (tensors,) = sends
        if self.n == 1:
            return lambda: [list(tensors)]
        import torch.distributed as dist

        me = self.ranks[0]
        recvs = [torch.empty_like(t) for t in tensors]
        ops = [dist.P2POp(dist.isend, t, self._peer(me + 1), self.group)
               for t in tensors]
        ops += [dist.P2POp(dist.irecv, r, self._peer(me - 1), self.group)
                for r in recvs]
        works = dist.batch_isend_irecv(ops)

        def wait(sent=tuple(tensors)):  # the buffers live until the wait
            for w in works:
                w.wait()
            return [recvs]

        return wait

    def all_to_all(self, xs: Sequence[torch.Tensor], split_axis: int,
                   concat_axis: int) -> List[torch.Tensor]:
        (x,) = xs
        if self.n == 1:
            return [x]
        return [_AllToAll.apply(x, self, split_axis, concat_axis)]

    def move_chunks(self, xs: Sequence[torch.Tensor],
                    moves: Sequence[Move]) -> List[torch.Tensor]:
        (x,) = xs
        return [_MoveChunks.apply(x, self, tuple(moves))]


def _all_to_all(x: torch.Tensor, ring: ProcessGroupRing, split_axis: int,
                concat_axis: int) -> torch.Tensor:
    import torch.distributed as dist

    send = torch.stack(x.chunk(ring.n, split_axis)).contiguous()
    recv = torch.empty_like(send)
    dist.all_to_all_single(recv, send, group=ring.group)
    return torch.cat(recv.unbind(0), concat_axis)


class _AllToAll(torch.autograd.Function):
    """The tiled all-to-all; its adjoint swaps the two axes."""

    @staticmethod
    def forward(ctx, x, ring, split_axis, concat_axis):
        ctx.args = (ring, split_axis, concat_axis)
        return _all_to_all(x, ring, split_axis, concat_axis)

    @staticmethod
    def backward(ctx, g):
        ring, split_axis, concat_axis = ctx.args
        return (_all_to_all(g.contiguous(), ring, concat_axis, split_axis),
                None, None, None)


def _move_chunks(x: torch.Tensor, ring: ProcessGroupRing,
                 moves: Sequence[Move]) -> torch.Tensor:
    """One batch of sends and receives, issued in chunk order on both
    sides (and tagged with the chunk's index), so two chunks between
    the same pair of ranks match in order."""
    import torch.distributed as dist

    me = ring.ranks[0]
    out = torch.empty_like(x)
    ops = []
    for tag, ((src, s_slot), (dst, d_slot)) in enumerate(moves):
        if src == me and dst == me:
            out[d_slot] = x[s_slot]
        elif src == me:
            ops.append(dist.P2POp(dist.isend, x[s_slot].contiguous(),
                                  ring._peer(dst), ring.group, tag))
        elif dst == me:
            ops.append(dist.P2POp(dist.irecv, out[d_slot],
                                  ring._peer(src), ring.group, tag))
    if ops:
        for w in dist.batch_isend_irecv(ops):
            w.wait()
    return out


class _MoveChunks(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ring, moves):
        ctx.args = (ring, moves)
        return _move_chunks(x.contiguous(), ring, moves)

    @staticmethod
    def backward(ctx, g):
        ring, moves = ctx.args
        inverse = tuple((dst, src) for src, dst in moves)
        return _move_chunks(g.contiguous(), ring, inverse), None, None


__all__ = ["InProcessRing", "Move", "ProcessGroupRing"]
