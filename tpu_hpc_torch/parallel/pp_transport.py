"""How the pipeline moves activations and cotangents between stages.

The JAX package hands each tick's activation to the next stage with one
``jax.lax.ppermute`` inside ``shard_map`` and broadcasts the last
stage's outputs with a ``psum`` (``parallel/pp.py``). The port keeps
these moves behind one small interface with two implementations, on
the pattern of ``parallel/sp_transport.py``:

  * :class:`ProcessGroupPipe` -- this process is one stage (pipe rank)
    of the pipe group (a ``torch.distributed`` process group: NCCL on
    cards, gloo on the CPU). ``exchange`` posts one tick's sends and
    receives as one ``batch_isend_irecv``; ``from_stage`` broadcasts a
    stage's stacked microbatches to every pipe rank. With a data group
    (``P(None, "data")``: the microbatch rows split over data ranks),
    ``rows`` takes this rank's rows, ``gather_rows`` puts every rank's
    back together and ``reduce_grads`` sums the stage gradients over the
    data ranks (the JAX programs' hand-inserted ``psum``).
  * :class:`InProcessPipe` -- all ``n`` stages in this process, on one
    device. ``exchange`` hands each tensor to its stage (no copy). NCCL
    puts no two ranks on one card, so this is how one card runs a
    pipeline of ``n`` stages; no CLI flag selects it.

Every stage runs the same operations in the same order under either,
so the two give the same bits. A message is ``(stage, kind, tensor)``:
``kind`` is ``"fwd"`` (an activation for the stage's next forward) or
``"bwd"`` (a cotangent for its next backward).
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import torch

# (destination stage, kind, tensor) and (source stage, kind).
Send = Tuple[int, str, torch.Tensor]
Recv = Tuple[int, int, str]  # (this stage, source stage, kind)
KINDS = ("fwd", "bwd")


def _missing(got: dict, recvs: Sequence[Recv]) -> None:
    want = {(dst, kind) for dst, _, kind in recvs}
    if set(got) != want:
        raise RuntimeError(
            f"pipeline schedule out of step: stages were sent "
            f"{sorted(got)} but expect {sorted(want)}")


class InProcessPipe:
    """All ``n`` pipeline stages in this process (see the module
    docstring)."""

    def __init__(self, n: int):
        if n < 1:
            raise ValueError(f"a pipeline needs n >= 1 stages, got {n}")
        self.n = n
        self.stages = tuple(range(n))

    def exchange(self, sends: Sequence[Send], recvs: Sequence[Recv],
                 like: torch.Tensor) -> Dict[Tuple[int, str], torch.Tensor]:
        """One tick's hand-offs: ``{(stage, kind): tensor}``; every
        expected receive must have been sent, and nothing else."""
        del like
        got = {(dst, kind): t for dst, kind, t in sends}
        _missing(got, recvs)
        return got

    def from_stage(self, tensors: Optional[torch.Tensor], src: int,
                   like: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Stage ``src``'s tensor, as every stage sees it."""
        del src, like
        return tensors

    def rows(self, x: torch.Tensor) -> torch.Tensor:
        return x

    def gather_rows(self, x: torch.Tensor) -> torch.Tensor:
        return x

    def reduce_grads(self, grads: List[torch.Tensor]) -> List[torch.Tensor]:
        return grads


class ProcessGroupPipe:
    """This process as one stage of ``group``'s pipeline, and with
    ``data_group`` one data rank of its microbatch rows (see the module
    docstring)."""

    def __init__(self, group, data_group=None):
        import torch.distributed as dist

        self.group = group
        self.n = dist.get_world_size(group)
        self.stages = (dist.get_rank(group),)
        self.data_group = data_group
        self.data_n = (dist.get_world_size(data_group)
                       if data_group is not None else 1)
        self.data_rank = (dist.get_rank(data_group)
                          if data_group is not None else 0)
        if self.n > 1:
            # NCCL: a batch of P2P ops that leaves out some ranks of the
            # group is defined only once a collective has run on it.
            dist.barrier(group=group)

    @classmethod
    def from_mesh(cls, mesh, axis: str = "pipe",
                  data_axis: Optional[str] = None) -> "ProcessGroupPipe":
        """The pipe (and data) groups of a ``DeviceMesh``."""
        data = mesh[data_axis].get_group() if data_axis else None
        return cls(mesh[axis].get_group(), data)

    def _peer(self, stage: int) -> int:
        import torch.distributed as dist

        return dist.get_global_rank(self.group, stage % self.n)

    def exchange(self, sends: Sequence[Send], recvs: Sequence[Recv],
                 like: torch.Tensor) -> Dict[Tuple[int, str], torch.Tensor]:
        """Post the tick's sends and receives as one batch (between a
        pair of stages the activation goes before the cotangent on both
        sides, each tagged with its kind) and wait for them."""
        import torch.distributed as dist

        got, ops = {}, []
        for dst, kind, t in sorted(sends, key=lambda s: (s[0],
                                                         KINDS.index(s[1]))):
            ops.append(dist.P2POp(dist.isend, t.contiguous(), self._peer(dst),
                                  self.group, KINDS.index(kind)))
        for dst, src, kind in sorted(recvs, key=lambda r: (r[1],
                                                           KINDS.index(r[2]))):
            got[dst, kind] = buf = torch.empty_like(like)
            ops.append(dist.P2POp(dist.irecv, buf, self._peer(src),
                                  self.group, KINDS.index(kind)))
        if ops:
            for w in dist.batch_isend_irecv(ops):
                w.wait()
        return got

    def from_stage(self, tensors: Optional[torch.Tensor], src: int,
                   like: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Stage ``src``'s tensor broadcast to every stage (the JAX
        program's ``psum`` of the masked outputs); the others pass
        None and a ``like`` for its shape."""
        import torch.distributed as dist

        if self.n == 1:
            return tensors
        buf = (tensors.contiguous() if self.stages[0] == src
               else torch.empty_like(like))
        dist.broadcast(buf, self._peer(src), group=self.group)
        return buf

    def rows(self, x: torch.Tensor) -> torch.Tensor:
        """This data rank's rows of each microbatch ``[M, mb, ...]``."""
        if self.data_n == 1:
            return x
        if x.shape[1] % self.data_n:
            raise ValueError(
                f"microbatch of {x.shape[1]} rows not divisible by "
                f"{self.data_n} data ranks")
        return x.chunk(self.data_n, 1)[self.data_rank].contiguous()

    def gather_rows(self, x: torch.Tensor) -> torch.Tensor:
        """Every data rank's rows, in rank order along dim 1."""
        import torch.distributed as dist

        if self.data_n == 1:
            return x
        parts = [torch.empty_like(x) for _ in range(self.data_n)]
        dist.all_gather(parts, x.contiguous(), group=self.data_group)
        return torch.cat(parts, 1)

    def reduce_grads(self, grads: List[torch.Tensor]) -> List[torch.Tensor]:
        """Stage gradients summed over the data ranks: each saw only its
        rows, and the stage params are whole on every one of them."""
        import torch.distributed as dist

        if self.data_n > 1:
            for g in grads:
                dist.all_reduce(g, group=self.data_group)
        return grads


__all__ = ["InProcessPipe", "ProcessGroupPipe"]
