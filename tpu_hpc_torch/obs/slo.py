"""Multi-window error-budget burn-rate alerting over the fleet rollup.

A framework-free copy of the JAX package's ``obs/slo.py``.

One bad minute must not page, and a slow leak must not hide: the
standard SRE construction is to alert on the *burn rate* of the error
budget -- ``(error rate) / (1 - target)`` -- over TWO windows at once.
The fast window catches an active incident quickly; the slow window
proves it is sustained; only when BOTH exceed the threshold is the
condition page-worthy. A transient spike trips the fast window alone
(no page); a slow regression trips the slow window alone until it
accelerates (no page); a real burn trips both.

:class:`BurnRateMonitor` feeds on the cumulative ``slo_good`` /
``slo_bad`` totals the rollup (obs/live.py) already sums across the
fleet, so the verdict is over what *every* replica saw, not one lucky
process. On page it emits one ``slo_burn`` record and arms the
``AnomalyCapture`` trigger -- a burning SLO
yields one correlated evidence bundle (flight ring + memory snapshot)
keyed by trace_id, not a bare alert line. One-shot latched, like the
capture itself: an incident storm re-trips every tick, only the first
gets the page + bundle (``rearm()`` for multi-incident harnesses).

Time is whatever clock the caller observes on -- the serving harness
passes its virtual wall, so breach tests replay bit-identically.
"""
from __future__ import annotations

from typing import List, Optional, Tuple


class BurnRateMonitor:
    """Two-window error-budget burn monitor.

    ``observe(now, good, bad)`` takes CUMULATIVE totals (the digest
    counter discipline); the monitor differences them over each
    window. A window only judges once it is fully covered -- there is
    a sample at or before its left edge -- so a run shorter than the
    slow window can never page (no cold-start false positives).
    """

    def __init__(
        self,
        *,
        target: float = 0.99,
        fast_window_s: float = 60.0,
        slow_window_s: float = 600.0,
        threshold: float = 10.0,
        bus=None,
    ):
        if not (0.0 < target < 1.0):
            raise ValueError(f"target {target} must be in (0, 1)")
        if fast_window_s <= 0 or slow_window_s <= fast_window_s:
            raise ValueError(
                f"need 0 < fast_window_s {fast_window_s} < "
                f"slow_window_s {slow_window_s}"
            )
        if threshold <= 0:
            raise ValueError(f"threshold {threshold} must be > 0")
        self.target = target
        self.budget = 1.0 - target
        self.fast_window_s = fast_window_s
        self.slow_window_s = slow_window_s
        self.threshold = threshold
        self._bus = bus
        # (t, good_total, bad_total), append-only in observe order;
        # pruned to one sample at/behind the slow window's left edge.
        self._samples: List[Tuple[float, float, float]] = []
        self.fired = False
        self.burns = 0
        self.last_record: Optional[dict] = None

    # -- internals -----------------------------------------------------
    def _baseline(self, edge: float) -> Optional[Tuple[float, float, float]]:
        """Newest sample with t <= edge; None when the window is not
        yet covered by the observation history."""
        base = None
        for s in self._samples:
            if s[0] <= edge:
                base = s
            else:
                break
        return base

    def _window_rate(self, now: float, window_s: float,
                     good: float, bad: float) -> Optional[float]:
        base = self._baseline(now - window_s)
        if base is None:
            return None
        d_good = good - base[1]
        d_bad = bad - base[2]
        total = d_good + d_bad
        if total <= 0:
            return 0.0
        return d_bad / total

    def budget_remaining(self) -> Optional[float]:
        """Fraction of the whole-run error budget left (1.0 = untouched,
        0.0 = spent, negative = overspent); None before any traffic."""
        if not self._samples:
            return None
        _, good, bad = self._samples[-1]
        total = good + bad
        if total <= 0:
            return None
        return 1.0 - (bad / total) / self.budget

    # -- the monitor ---------------------------------------------------
    def observe(
        self,
        now: float,
        good: float,
        bad: float,
        *,
        sink: Optional[str] = None,
        trace_id: Optional[str] = None,
        capture=None,
        reason: Optional[str] = None,
    ) -> Optional[dict]:
        """Feed one rollup sample; returns the ``slo_burn`` record when
        this sample pages, else None. ``capture`` (AnomalyCapture) is
        triggered profiler-less (the post-run contract: the evidence
        is the fleet state, not a future step window)."""
        if self._samples and now < self._samples[-1][0]:
            raise ValueError(
                f"time went backwards: {now} < {self._samples[-1][0]}"
            )
        self._samples.append((float(now), float(good), float(bad)))
        # Prune: keep exactly one sample at/behind the slow edge (the
        # baseline) -- bounded memory for a million-tick run.
        edge = now - self.slow_window_s
        while (
            len(self._samples) >= 2 and self._samples[1][0] <= edge
        ):
            self._samples.pop(0)

        rate_fast = self._window_rate(
            now, self.fast_window_s, good, bad
        )
        rate_slow = self._window_rate(
            now, self.slow_window_s, good, bad
        )
        if rate_fast is None or rate_slow is None:
            return None
        burn_fast = rate_fast / self.budget
        burn_slow = rate_slow / self.budget
        if burn_fast < self.threshold or burn_slow < self.threshold:
            return None
        if self.fired:
            return None
        self.fired = True
        self.burns += 1

        from tpu_hpc_torch.obs.events import get_bus

        bus = self._bus or get_bus()
        remaining = self.budget_remaining()
        rec = bus.emit(
            "slo_burn",
            sink=sink,
            trace_id=trace_id,
            burn_fast=round(burn_fast, 4),
            burn_slow=round(burn_slow, 4),
            threshold=self.threshold,
            budget=round(self.budget, 6),
            fast_window_s=self.fast_window_s,
            slow_window_s=self.slow_window_s,
            error_rate_fast=round(rate_fast, 6),
            error_rate_slow=round(rate_slow, 6),
            good=good,
            bad=bad,
            budget_remaining=(
                round(remaining, 4) if remaining is not None else None
            ),
            reason=reason,
            t=float(now),
        )
        self.last_record = rec
        if capture is not None:
            capture.trigger(
                "slo_burn", trace_id=trace_id, sink=sink,
                arm_profiler=False,
            )
        return rec

    def rearm(self) -> None:
        """Allow the next sustained burn to page again (multi-incident
        harnesses; the capture's own budget is separate)."""
        self.fired = False
