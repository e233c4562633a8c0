"""Synthetic token data: reproducible training input without data files.

Port of the JAX package's ``models/datasets.py::TokenStream``. A
dataset is an index-stateless generator: ``batch_at(step, batch_size)``
returns the same batch for the same (seed, step) on any machine and at
any point of a run, so a resumed run needs only its step counter. The
values come from a CPU ``torch.Generator`` seeded from (seed, step);
``jax.random`` gives other numbers from the same seed, so parity tests
replay the JAX stream's own batches through :class:`ArrayBatches`.

``zigzag_ring=n`` emits every batch in the zigzag layout of an n-way
ring (``parallel.ring_attention.zigzag_indices``), the layout the
zigzag ring takes with ``data_layout="zigzag"``. The other datasets of
the JAX module come with their models.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

_MIX = 0x9E3779B97F4A7C15  # golden-ratio odd constant: spreads seeds apart


def step_seed(seed: int, step: int) -> int:
    """One 63-bit generator seed for (seed, step); distinct seeds never
    share a stream over any realistic number of steps."""
    return (int(seed) * _MIX + int(step)) % (1 << 63)


@dataclasses.dataclass(frozen=True)
class TokenStream:
    """Random token batches: inputs and next-token targets.

    ``zigzag_ring=n``: slot p of every batch holds the token of global
    position ``zigzag_indices(n, seq_len)[0][p]``; inputs and targets
    permute together, so each input keeps its next token. Feed the model
    the slots' global RoPE positions (:meth:`positions`, or a context
    rank's slice of them: ``ring_attention.shard_positions``).
    """

    vocab_size: int = 32000
    seq_len: int = 2048
    seed: int = 0
    zigzag_ring: Optional[int] = None

    def __post_init__(self) -> None:
        self._perm()  # a seq_len the ring cannot split raises here

    def _perm(self) -> Optional[np.ndarray]:
        """The zigzag permutation (None in contiguous mode)."""
        if self.zigzag_ring is None:
            return None
        from tpu_hpc_torch.parallel.ring_attention import zigzag_indices

        return zigzag_indices(self.zigzag_ring, self.seq_len)[0]

    def positions(self) -> Optional[torch.Tensor]:
        """Global RoPE position of each slot ([seq_len] int64); None in
        contiguous mode, where the model's default ramp is right."""
        perm = self._perm()
        return None if perm is None else torch.from_numpy(perm)

    def batch_at(
        self, step: int, batch_size: int
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Deterministic (inputs, targets) int64 CPU tensors
        [batch_size, seq_len] for a global step."""
        gen = torch.Generator().manual_seed(step_seed(self.seed, step))
        tokens = torch.randint(
            0, self.vocab_size, (batch_size, self.seq_len + 1),
            generator=gen, dtype=torch.int64,
        )
        inputs, targets = tokens[:, :-1], tokens[:, 1:]
        perm = self._perm()
        if perm is not None:
            idx = torch.from_numpy(perm)
            inputs, targets = inputs[:, idx], targets[:, idx]
        return inputs, targets


@dataclasses.dataclass(frozen=True, eq=False)
class ArrayBatches:
    """Replays given (inputs, targets) array pairs: ``batch_at(step,
    batch_size)`` returns pair ``step`` -- how a test feeds the port
    exactly the batches another stream (the JAX ``TokenStream``) made."""

    batches: Sequence[Tuple[np.ndarray, np.ndarray]]

    def batch_at(
        self, step: int, batch_size: int
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        if not 0 <= step < len(self.batches):
            raise IndexError(
                f"step {step} outside the {len(self.batches)} given batches"
            )
        inputs, targets = self.batches[step]
        if len(inputs) != batch_size:
            raise ValueError(
                f"batch {step} holds {len(inputs)} rows, asked for "
                f"{batch_size}"
            )
        return (torch.from_numpy(np.array(inputs)).long(),
                torch.from_numpy(np.array(targets)).long())
