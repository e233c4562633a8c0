"""Counter-based random draws for seeded sampling: JAX's threefry chain.

The JAX package derives every sampling draw from ``jax.random``'s
default generator, threefry2x32, with keys folded from (request seed,
absolute position, stream). This module computes the same functions on
torch tensors, so a sampled stream of the port equals the JAX
package's token for token, on the CPU and on the card alike, and a
request's draws depend on its own seed and positions only -- never on
its slot, its batch or a step counter. No ``torch.Generator`` is
involved.

Integers are carried as int64 tensors holding uint32 values (torch has
no uint32 arithmetic on every device); every add is masked back to 32
bits. Constants (the base key, the stream, a uniform's range) stay
Python numbers: no draw copies a host value to the card, so none waits
on the work queued before it. The definitions follow ``jax/_src/prng.py`` and
``jax/_src/random.py`` of JAX 0.9 with ``jax_threefry_partitionable``
on (its default):

* a key is a pair of uint32 words, shape ``[..., 2]``; ``key(0)`` is
  ``(0, 0)``;
* ``fold_in(key, d)`` is ``threefry2x32(key, (0, d))``;
* random bits of shape ``(n,)`` hash the counters ``(0, i)`` and XOR
  the two output words;
* ``uniform`` keeps the top 23 bits as the mantissa of a float in
  [1, 2), subtracts 1, then scales by ``maxval - minval`` (computed in
  float32), adds ``minval`` and floors at ``minval``;
* ``categorical`` is the Gumbel-max draw
  ``argmax(-log(-log(uniform(tiny, 1))) + logits)`` (JAX's "low"
  dynamic-range Gumbel).
"""
from __future__ import annotations

from typing import Optional, Tuple, Union

import numpy as np
import torch

_MASK = 0xFFFFFFFF
_PARITY = 0x1BD11BDA
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_ONE_BITS = 0x3F800000  # float32 1.0
_TINY = torch.finfo(torch.float32).tiny

IntLike = Union[int, torch.Tensor]


def _u32(x: IntLike) -> IntLike:
    if isinstance(x, torch.Tensor):
        return x.to(torch.int64) & _MASK
    return int(x) & _MASK


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & _MASK


def threefry2x32(
    k0: IntLike, k1: IntLike, x0: IntLike, x1: IntLike
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The Threefry-2x32 block (20 rounds) on broadcastable int64
    tensors of uint32 values (any of them may be a Python int, as long
    as one is a tensor); returns the two output words."""
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = (x0 + ks[0]) & _MASK
    x1 = (x1 + ks[1]) & _MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _MASK
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _MASK
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & _MASK
    return x0, x1


def key(seed: int = 0, device=None) -> torch.Tensor:
    """``jax.random.key(seed)`` for a seed below 2**32: ``(0, seed)``."""
    return torch.tensor(
        [0, int(seed) & _MASK], dtype=torch.int64, device=device
    )


def fold_in(k: torch.Tensor, data: IntLike) -> torch.Tensor:
    """``jax.random.fold_in``: ``k`` is ``[..., 2]``, ``data`` an int
    or a tensor broadcasting against ``k[..., 0]``."""
    y0, y1 = threefry2x32(k[..., 0], k[..., 1], 0, _u32(data))
    return torch.stack(torch.broadcast_tensors(y0, y1), dim=-1)


def position_keys(
    seeds: torch.Tensor, positions: IntLike, stream: int
) -> torch.Tensor:
    """Per-element keys from (request seed, absolute position, stream):
    ``key(0)`` -- the words ``(0, 0)`` -- folded with each in turn.
    ``[...]`` int tensors (``positions`` may be an int) -> ``[..., 2]``
    keys."""
    k0, k1 = threefry2x32(0, 0, 0, _u32(seeds))
    k0, k1 = threefry2x32(k0, k1, 0, _u32(positions))
    k0, k1 = threefry2x32(k0, k1, 0, _u32(stream))
    return torch.stack(torch.broadcast_tensors(k0, k1), dim=-1)


def random_bits(k: torch.Tensor, n: Optional[int] = None) -> torch.Tensor:
    """32 random bits per key (``n`` None: shape ``k.shape[:-1]``) or
    ``n`` per key (shape ``k.shape[:-1] + (n,)``), as int64."""
    k0, k1 = k[..., 0], k[..., 1]
    if n is None:
        y0, y1 = threefry2x32(k0, k1, 0, 0)
        return y0 ^ y1
    count = torch.arange(n, dtype=torch.int64, device=k.device)
    y0, y1 = threefry2x32(k0[..., None], k1[..., None], 0, count)
    return y0 ^ y1


def _bits_to_unit(bits: torch.Tensor) -> torch.Tensor:
    """Top 23 bits as a float32 in [0, 1): JAX's mantissa trick."""
    fbits = (bits >> 9) | _ONE_BITS
    return fbits.to(torch.int32).view(torch.float32) - 1.0


def uniform(
    k: torch.Tensor,
    n: Optional[int] = None,
    minval: float = 0.0,
    maxval: float = 1.0,
) -> torch.Tensor:
    """``jax.random.uniform(key, shape, float32, minval, maxval)`` per
    key: shape ``k.shape[:-1]`` (``n`` None) or ``k.shape[:-1] +
    (n,)``."""
    f = _bits_to_unit(random_bits(k, n))
    # float32 bounds and their float32 difference, as JAX takes them;
    # a float32 tensor times a Python float computes in float32.
    lo, hi = np.float32(minval), np.float32(maxval)
    return torch.clamp_min(f * float(hi - lo) + float(lo), float(lo))


def gumbel(k: torch.Tensor, n: int) -> torch.Tensor:
    """``jax.random.gumbel(key, (n,), float32)`` (mode "low") per key."""
    return -torch.log(-torch.log(uniform(k, n, minval=_TINY, maxval=1.0)))


def categorical(k: torch.Tensor, logits: torch.Tensor) -> torch.Tensor:
    """``jax.random.categorical(key, logits)`` over the last axis, one
    key per row: ``k`` ``[..., 2]``, ``logits`` ``[..., n]`` float32 ->
    int64 ``[...]``. A row that is ``log`` of a one-hot draws its hot
    index whatever the noise."""
    g = gumbel(k, logits.shape[-1])
    return torch.argmax(g + logits, dim=-1)


def categorical_probs(k: torch.Tensor, probs: torch.Tensor) -> torch.Tensor:
    """``categorical(k, log(probs))``: the draw the spec programs make
    from a token distribution (zeroed entries are ``-inf``)."""
    return categorical(k, torch.log(probs))

