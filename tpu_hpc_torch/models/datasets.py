"""Synthetic datasets: reproducible training input without data files.

Port of the JAX package's ``models/datasets.py``: ``ERA5Synthetic``
(weather grids, NHWC), ``ToyRegression``, ``CIFARSynthetic`` (images and
labels), ``TokenStream`` and ``shard_batch``. A dataset is an
index-stateless generator: ``batch_at(step, batch_size)``
returns the same batch for the same (seed, step) on any machine and at
any point of a run, so a resumed run needs only its step counter. The
values come from a ``torch.Generator`` seeded from (seed, step), on the
CPU (the grids and images may take the card's: ``device``);
``jax.random`` gives other numbers from the same seed, so parity tests
replay the JAX stream's own batches through :class:`ArrayBatches`.

``zigzag_ring=n`` emits every batch in the zigzag layout of an n-way
ring (``parallel.ring_attention.zigzag_indices``), the layout the
zigzag ring takes with ``data_layout="zigzag"``.
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


def _generator(seed: int, step: int, device=None) -> torch.Generator:
    return torch.Generator(device=device or "cpu").manual_seed(
        step_seed(seed, step))


@dataclasses.dataclass(frozen=True)
class ERA5Synthetic:
    """ERA5-like weather grids: ``channels = n_vars x n_levels`` on a
    ``[lat, lon]`` grid (default the 1-degree 181 x 360 grid, whose odd
    latitude count takes the U-Net's odd-size upsampling), NHWC float32
    pairs ``y = 0.5 x + 0.1 noise``."""

    n_samples: int = 1024
    n_vars: int = 5
    n_levels: int = 4
    lat: int = 181
    lon: int = 360
    seed: int = 0
    # Where the batches are drawn (None: the CPU). On a card the draw is
    # the card's own generator, as the JAX bench draws its batches on
    # the device: an 83 MB ERA5 batch drawn on the host and copied over
    # costs more than the U-Net's update.
    device: Optional[str] = None

    @property
    def channels(self) -> int:
        return self.n_vars * self.n_levels

    @property
    def sample_shape(self) -> Tuple[int, int, int]:
        return (self.lat, self.lon, self.channels)  # NHWC

    def batch_at(self, step: int,
                 batch_size: int) -> Tuple[torch.Tensor, torch.Tensor]:
        """Deterministic (input, target) float32 tensors ``[batch_size,
        lat, lon, channels]`` on ``device`` for a global step (the same
        for the same device type)."""
        gen = _generator(self.seed, step, self.device)
        shape = (batch_size, *self.sample_shape)
        kw = dict(generator=gen, dtype=torch.float32, device=gen.device)
        x = torch.randn(shape, **kw)
        y = 0.5 * x + 0.1 * torch.randn(shape, **kw)
        return x, y


@dataclasses.dataclass(frozen=True)
class ToyRegression:
    """``in_features`` -> ``out_features`` float32 pairs, both standard
    normal."""

    n_samples: int = 2048
    in_features: int = 20
    out_features: int = 1
    seed: int = 0

    def batch_at(self, step: int,
                 batch_size: int) -> Tuple[torch.Tensor, torch.Tensor]:
        gen = _generator(self.seed, step)
        x = torch.randn((batch_size, self.in_features), generator=gen)
        y = torch.randn((batch_size, self.out_features), generator=gen)
        return x, y


@dataclasses.dataclass(frozen=True)
class CIFARSynthetic:
    """CIFAR-shaped (image, label) batches: NHWC float32 standard-normal
    images and int64 labels in ``[0, n_classes)`` (the JAX stream's are
    int32; torch's losses index with int64)."""

    n_classes: int = 10
    size: int = 32
    channels: int = 3
    seed: int = 0
    device: Optional[str] = None  # as ERA5Synthetic's

    @property
    def sample_shape(self) -> Tuple[int, int, int]:
        return (self.size, self.size, self.channels)

    def batch_at(self, step: int,
                 batch_size: int) -> Tuple[torch.Tensor, torch.Tensor]:
        gen = _generator(self.seed, step, self.device)
        x = torch.randn((batch_size, *self.sample_shape), generator=gen,
                        device=gen.device)
        labels = torch.randint(0, self.n_classes, (batch_size,),
                               generator=gen, dtype=torch.int64,
                               device=gen.device)
        return x, labels


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
        gen = _generator(self.seed, step)
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
    exactly the batches another stream (a JAX dataset) made. Integer
    arrays come back int64 (tokens, labels), float arrays float32
    (grids, images)."""

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
        return _tensor(inputs), _tensor(targets)


def _tensor(a) -> torch.Tensor:
    a = np.asarray(a)
    if np.issubdtype(a.dtype, np.integer):
        return torch.from_numpy(a.astype(np.int64))
    return torch.from_numpy(np.array(a, dtype=np.float32))


def shard_batch(batch, n_shards: int, rank: int):
    """This rank's slice of a host-global batch: rows ``[rank * m,
    (rank + 1) * m)`` of every array, ``m = rows / n_shards`` -- the
    DistributedSampler's exclusive subset, the rows the JAX
    ``shard_batch`` places on data shard ``rank``."""
    rows = batch[0].shape[0]
    if rows % n_shards or not 0 <= rank < n_shards:
        raise ValueError(f"a batch of {rows} rows does not split into "
                         f"{n_shards} shards (rank {rank})")
    m = rows // n_shards
    return tuple(a[rank * m:(rank + 1) * m] for a in batch)
