"""The one quantile implementation every latency number comes from.

Before this module, obs/registry.py and serve/metrics.py each carried
a private nearest-rank ``_quantile`` helper. Two copies of
almost-the-same estimator is exactly how a regression gate ends up
comparing a p95 computed one way against a p95 computed another; the
regress gate (obs/regress.py) stakes exit codes on these numbers, so
they are computed in ONE place, with the standard linear-interpolation
estimator (numpy's default ``percentile`` method) and pinned against
``np.percentile`` on known distributions in tests/test_obs.py.
"""
from __future__ import annotations

from typing import Dict, Iterable, Sequence, Tuple

DEFAULT_QS: Tuple[float, ...] = (0.50, 0.95, 0.99)


def quantile(sorted_vals: Sequence[float], q: float) -> float:
    """Linear-interpolation quantile of an ascending-sorted sequence
    (numpy's default method: index ``q * (n - 1)``, interpolated).
    Empty input returns 0.0 -- the registry/meter convention for "no
    samples yet" (summaries must render, not crash, mid-warmup)."""
    n = len(sorted_vals)
    if n == 0:
        return 0.0
    if not 0.0 <= q <= 1.0:
        raise ValueError(f"quantile q {q} must be in [0, 1]")
    pos = q * (n - 1)
    lo = int(pos)
    hi = min(lo + 1, n - 1)
    frac = pos - lo
    return sorted_vals[lo] * (1.0 - frac) + sorted_vals[hi] * frac


def summarize(
    values: Iterable[float], qs: Sequence[float] = DEFAULT_QS,
    prefix: str = "p",
) -> Dict[str, float]:
    """``{"p50": ..., "p95": ..., "p99": ...}`` over ``values``
    (sorted internally)."""
    vals = sorted(values)
    return {
        f"{prefix}{round(q * 100):d}": quantile(vals, q) for q in qs
    }
