"""Mergeable log-bucket histogram sketch (the registry's second store).

Copied from the JAX package's ``obs/digest.py``: only
:class:`LogBucketSketch`, which ``obs/registry.py`` feeds alongside its
sample windows. The digest publisher and the fleet rollup that ship
these sketches between processes are not ported yet (ROADMAP).

Quantiles over sample windows do NOT merge: p95 of two windows is not
the p95 of the union. The sketch uses log-spaced buckets (the DDSketch
construction): the bucket index of value ``v`` is ``ceil(log_gamma v)``
with ``gamma = (1+alpha)/(1-alpha)``, so any quantile estimate is
within relative error ``alpha`` of the true value, and merging two
sketches is bucket-count addition.
"""
from __future__ import annotations

import math
from typing import Dict, Mapping

# Pinned default relative-error bound for digest sketches.
DEFAULT_ALPHA = 0.01

# Values at or below this land in the zero bucket: log-bucketing can't
# represent 0, and sub-picosecond durations are measurement noise.
_ZERO_EPS = 1e-12


class LogBucketSketch:
    """DDSketch-style log-bucketed histogram with relative-error
    bound ``alpha``.

    ``add(v)`` maps v to bucket ``k = ceil(log_gamma v)``; the bucket's
    representative value ``2*gamma^k / (gamma+1)`` (the midpoint of
    ``(gamma^(k-1), gamma^k]``) is within ``alpha`` relative error of
    every value in the bucket. ``merge`` adds bucket counts, so
    quantiles over the union of any number of streams are exact up to
    the same bound -- the property the fleet rollup is built on.
    Negative values are clamped to the zero bucket (durations and
    sizes; a negative sample is a producer bug, not a distribution).
    """

    __slots__ = ("alpha", "gamma", "_log_gamma", "buckets", "zero",
                 "count", "sum", "min", "max")

    def __init__(self, alpha: float = DEFAULT_ALPHA):
        if not (0.0 < alpha < 1.0):
            raise ValueError(f"alpha {alpha} must be in (0, 1)")
        self.alpha = float(alpha)
        self.gamma = (1.0 + alpha) / (1.0 - alpha)
        self._log_gamma = math.log(self.gamma)
        self.buckets: Dict[int, int] = {}
        self.zero = 0
        self.count = 0
        self.sum = 0.0
        self.min = math.inf
        self.max = -math.inf

    def add(self, value: float, n: int = 1) -> None:
        v = float(value)
        if n < 1:
            raise ValueError(f"n {n} must be >= 1")
        self.count += n
        self.sum += v * n
        self.min = min(self.min, v)
        self.max = max(self.max, v)
        if v <= _ZERO_EPS:
            self.zero += n
            return
        k = math.ceil(math.log(v) / self._log_gamma)
        self.buckets[k] = self.buckets.get(k, 0) + n

    def merge(self, other: "LogBucketSketch") -> "LogBucketSketch":
        """In-place merge; returns self. Both sketches must share
        ``alpha`` (bucket boundaries are alpha-derived -- merging
        mismatched sketches would silently corrupt quantiles)."""
        if abs(other.alpha - self.alpha) > 1e-12:
            raise ValueError(
                f"cannot merge sketches with alpha {self.alpha} vs "
                f"{other.alpha}"
            )
        for k, n in other.buckets.items():
            self.buckets[k] = self.buckets.get(k, 0) + n
        self.zero += other.zero
        self.count += other.count
        self.sum += other.sum
        self.min = min(self.min, other.min)
        self.max = max(self.max, other.max)
        return self

    def _value_of(self, k: int) -> float:
        return 2.0 * self.gamma ** k / (self.gamma + 1.0)

    def quantile(self, q: float) -> float:
        """Nearest-rank quantile estimate; 0.0 on an empty sketch.
        Within ``alpha`` relative error of the exact nearest-rank
        quantile of everything ever added (across merges)."""
        if not (0.0 <= q <= 1.0):
            raise ValueError(f"q {q} must be in [0, 1]")
        if self.count == 0:
            return 0.0
        rank = max(0, math.ceil(q * self.count) - 1)
        if rank < self.zero:
            return 0.0
        seen = self.zero
        for k in sorted(self.buckets):
            seen += self.buckets[k]
            if rank < seen:
                return self._value_of(k)
        return self._value_of(max(self.buckets))

    def summary(self) -> Dict[str, float]:
        """The registry's histogram_summary shape plus p999 -- what a
        rollup row renders. min/max are exact (tracked outside the
        buckets), quantiles are alpha-bounded."""
        empty = self.count == 0
        return {
            "count": self.count,
            "sum": self.sum,
            "min": 0.0 if empty else self.min,
            "max": 0.0 if empty else self.max,
            "p50": self.quantile(0.50),
            "p95": self.quantile(0.95),
            "p99": self.quantile(0.99),
            "p999": self.quantile(0.999),
        }

    # -- wire form -----------------------------------------------------
    def to_dict(self) -> dict:
        """JSON-safe wire form. Buckets are emitted in sorted index
        order so equal sketches serialize byte-identically -- the
        property the merge tests (and deterministic --json rollups)
        lean on."""
        out: dict = {
            "alpha": self.alpha,
            "count": self.count,
            "sum": self.sum,
            "zero": self.zero,
            "buckets": {
                str(k): self.buckets[k] for k in sorted(self.buckets)
            },
        }
        if self.count:
            out["min"] = self.min
            out["max"] = self.max
        return out

    @classmethod
    def from_dict(cls, d: Mapping) -> "LogBucketSketch":
        sk = cls(alpha=float(d.get("alpha", DEFAULT_ALPHA)))
        sk.count = int(d.get("count", 0))
        sk.sum = float(d.get("sum", 0.0))
        sk.zero = int(d.get("zero", 0))
        sk.buckets = {
            int(k): int(n) for k, n in dict(d.get("buckets", {})).items()
        }
        if sk.count:
            sk.min = float(d.get("min", 0.0))
            sk.max = float(d.get("max", 0.0))
        return sk
