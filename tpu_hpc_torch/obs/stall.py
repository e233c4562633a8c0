"""Rolling step-time watermark: distinguish *slow* from *hung*.

The hang watchdog (resilience/heartbeat.py) only knows binary
liveness: ticks or no ticks. A straggling host -- a chip thermally
throttling, a data loader degrading, DCN congestion -- ticks happily
while the fleet bleeds goodput, and the 100k-GPU operations
literature (arxiv 2510.20171) names exactly this gray failure as the
expensive one. :class:`StallDetector` keeps a rolling watermark of
recent step times and

* flags any step slower than ``factor`` x the watermark (a ``stall``
  event through the bus, so the report's restart timeline shows the
  degradation leading up to a watchdog kill), and
* feeds :meth:`heartbeat_extra` into the heartbeat file -- the
  supervisor (or an operator's ``cat``) then sees ``step_s`` next to
  the tick and can tell "wedged" from "3x slower than its own
  recent past" without attaching to the process.
"""
from __future__ import annotations

import collections
import statistics
from typing import Deque, Dict, Optional


class StallDetector:
    """Per-run step-time watermark. ``observe`` once per progress
    point with that point's per-step wall time."""

    def __init__(
        self,
        window: int = 32,
        factor: float = 3.0,
        min_samples: int = 5,
        bus=None,
    ):
        if factor <= 1.0:
            raise ValueError(f"factor {factor} must be > 1")
        if min_samples < 2:
            raise ValueError(f"min_samples {min_samples} must be >= 2")
        if window < min_samples:
            # The deque can never hold min_samples entries: the
            # detector would silently never warm up and never fire.
            raise ValueError(
                f"window {window} must be >= min_samples {min_samples}"
            )
        self.window = window
        self.factor = factor
        self.min_samples = min_samples
        self._bus = bus
        self._times: Deque[float] = collections.deque(maxlen=window)
        self.last_step: Optional[int] = None
        self.last_step_s: Optional[float] = None
        self.stalls = 0

    @property
    def watermark_s(self) -> Optional[float]:
        """Median of the recent window; None until warm."""
        if len(self._times) < self.min_samples:
            return None
        return statistics.median(self._times)

    def observe(
        self, step: int, step_s: float, sink: Optional[str] = None,
        trace_id: Optional[str] = None,
    ) -> Optional[dict]:
        """Record one step time; returns the stall info dict (and
        emits a ``stall`` event) when this step breached the
        watermark, else None. ``trace_id`` (obs/trace.py) correlates
        the stall with the step/tick trace it happened on -- the key
        an anomaly-triggered capture is filed under. The breaching
        sample still enters the window -- a run that *stays* slow
        re-baselines instead of alarming forever."""
        watermark = self.watermark_s
        info = None
        # A non-positive watermark carries no cadence to breach (a
        # window of zero-duration steps -- e.g. virtual-clock ticks
        # that did no metered work); treat it as not-warm rather than
        # dividing by it.
        if watermark is not None and watermark <= 0.0:
            watermark = None
        if watermark is not None and step_s > self.factor * watermark:
            self.stalls += 1
            info = {
                "step": step,
                "step_s": step_s,
                "watermark_s": watermark,
                "ratio": step_s / watermark,
            }
            from tpu_hpc_torch.obs.events import get_bus

            (self._bus or get_bus()).emit(
                "stall", sink=sink, trace_id=trace_id, **info
            )
        self._times.append(step_s)
        self.last_step = step
        self.last_step_s = step_s
        return info

    def heartbeat_extra(self) -> Dict[str, float]:
        """Enrichment fields for Heartbeat.tick -- only what is known
        (an un-warmed detector contributes nothing rather than
        nulls)."""
        out: Dict[str, float] = {}
        if self.last_step_s is not None:
            out["step_s"] = round(self.last_step_s, 4)
        wm = self.watermark_s
        if wm is not None:
            out["watermark_s"] = round(wm, 4)
        return out
