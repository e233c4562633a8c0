"""Throughput accounting: the trainer's meters and MFU.

Port of the JAX package's ``train/metrics.py``: :class:`ThroughputMeter`
(per-batch and per-epoch global / per-device items per second),
:class:`GoodputMeter` (productive time against the overheads) and
:func:`mfu`. The pipeline bubble fraction waits for the pipeline slice.

PyTorch returns before the card finishes, so a clock read after an
enqueue measures the enqueue. A meter given a CUDA ``device`` therefore
calls ``torch.cuda.synchronize(device)`` before it reads the clock at
the end of a batch: the time it reports is the card's.
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import time
from typing import Any, Deque, Dict, Iterator, Optional

import torch


@dataclasses.dataclass
class ThroughputMeter:
    """Wall-clock throughput over batches and epochs.

    The caller brackets each batch (or chunk of steps) with
    ``start_batch`` / ``end_batch``; items are global. Per-batch samples
    are windowed (the newest ``window`` batches) so a long run does not
    grow host memory. ``device``: a CUDA device is synchronized before
    the clock is read in ``end_batch``.
    """

    n_devices: int = 1
    window: int = 4096
    batch_times: Optional[Deque[float]] = None
    batch_items: Optional[Deque[int]] = None
    _t0: Optional[float] = None
    device: Optional[Any] = None

    def __post_init__(self) -> None:
        if self.window < 1:
            raise ValueError(f"window {self.window} must be >= 1")
        if self.batch_times is None:
            self.batch_times = collections.deque(maxlen=self.window)
        if self.batch_items is None:
            self.batch_items = collections.deque(maxlen=self.window)

    def _sync(self) -> None:
        if self.device is not None and torch.device(self.device).type == "cuda":
            torch.cuda.synchronize(self.device)

    def start_batch(self) -> None:
        self._sync()
        self._t0 = time.perf_counter()

    def end_batch(self, items: int) -> float:
        if self._t0 is None:
            raise RuntimeError("end_batch called without start_batch")
        self._sync()
        dt = time.perf_counter() - self._t0
        self.batch_times.append(dt)
        self.batch_items.append(items)
        self._t0 = None
        return dt

    @property
    def last_throughput(self) -> float:
        """Global items/s for the most recent batch."""
        return self.batch_items[-1] / self.batch_times[-1]

    def epoch_summary(self, skip_first: int = 1) -> Dict[str, float]:
        """Aggregate items/s over the epoch, skipping warmup batches."""
        times = list(self.batch_times)[skip_first:] \
            or list(self.batch_times)
        items = list(self.batch_items)[skip_first:] \
            or list(self.batch_items)
        total_t = sum(times)
        total_i = sum(items)
        thpt = total_i / total_t if total_t else 0.0
        return {
            "items_per_s": thpt,
            "items_per_s_per_device": thpt / self.n_devices,
            "mean_batch_s": total_t / max(len(times), 1),
            "total_s": total_t,
            "batches": len(times),
        }

    def reset(self) -> None:
        self.batch_times.clear()
        self.batch_items.clear()


@dataclasses.dataclass
class GoodputMeter:
    """Goodput accounting: the fraction of a run's wall clock that
    advanced the model. Buckets:

    * ``productive_s`` -- time inside training chunks;
    * ``ckpt_s``       -- checkpoint saves (their blocking part);
    * ``restore_s``    -- checkpoint restore on resume;
    * ``other_s``      -- the remainder (kernel build, data prep, ...).
    """

    productive_s: float = 0.0
    ckpt_s: float = 0.0
    restore_s: float = 0.0
    _t_start: float = dataclasses.field(
        default_factory=time.monotonic
    )

    _KINDS = ("productive", "ckpt", "restore")

    def add(self, kind: str, seconds: float) -> None:
        if kind not in self._KINDS:
            raise ValueError(
                f"unknown goodput bucket {kind!r} (one of {self._KINDS})"
            )
        setattr(self, f"{kind}_s", getattr(self, f"{kind}_s") + seconds)

    @contextlib.contextmanager
    def measure(self, kind: str) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.add(kind, time.perf_counter() - t0)

    def summary(self) -> Dict[str, float]:
        total = time.monotonic() - self._t_start
        accounted = self.productive_s + self.ckpt_s + self.restore_s
        return {
            "total_s": total,
            "productive_s": self.productive_s,
            "ckpt_s": self.ckpt_s,
            "restore_s": self.restore_s,
            "other_s": max(total - accounted, 0.0),
            "goodput": self.productive_s / total if total > 0 else 0.0,
        }


def mfu(
    tokens_per_s: float,
    n_params: int,
    n_devices: int,
    peak_flops_per_device: float,
    attn_flops_per_token: float = 0.0,
    mode: str = "train",
) -> float:
    """Model FLOPs utilization: achieved / peak.

    ``mode="train"`` (the default) uses the standard 6N FLOPs/token
    estimate for dense transformers (fwd 2N + bwd 4N).
    ``mode="inference"`` uses the forward-only 2N estimate: a decode
    step runs no backward, so judging serving throughput against 6N
    would understate its utilization 3x (the serving meter reports
    this mode). Optional explicit attention FLOPs add on either way.
    """
    factors = {"train": 6.0, "inference": 2.0}
    if mode not in factors:
        raise ValueError(
            f"unknown mfu mode {mode!r} (one of {sorted(factors)})"
        )
    flops_per_token = factors[mode] * n_params + attn_flops_per_token
    achieved = tokens_per_s * flops_per_token
    return achieved / (peak_flops_per_device * n_devices)
