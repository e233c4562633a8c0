"""Counters / gauges / histograms with JSONL snapshots and Prometheus
text exposition.

One process-wide :class:`MetricsRegistry` that training (ThroughputMeter,
GoodputMeter), serving (ServeMeter, the engine's prefill/decode
timers) and the scheduler all publish into -- so MFU, TTFT/ITL and
goodput live in ONE namespace with one export path instead of three
private dicts. Two consumers:

* ``emit_snapshot()`` -- a ``metrics`` event through the bus (the
  Trainer appends one at run_end, so the run JSONL closes with the
  final counter state);
* ``prometheus_text()`` / ``write_prometheus()`` -- the standard text
  exposition format, atomically rewritten to ``$TPU_HPC_PROM_FILE``
  for a node-exporter textfile collector or a sidecar to scrape (no
  HTTP server in the training process: a wedged run must not also
  wedge a metrics port).

Histograms are windowed (bounded deques): the registry must be safe to
leave on for a million-step run, the same discipline the flight
recorder ring follows.
"""
from __future__ import annotations

import collections
import os
import re
import threading
from typing import Deque, Dict, Optional

from tpu_hpc_torch.obs.digest import LogBucketSketch
from tpu_hpc_torch.obs.quantiles import quantile as _quantile

ENV_PROM_FILE = "TPU_HPC_PROM_FILE"

_NAME_RE = re.compile(r"[^a-zA-Z0-9_:]")


def _sanitize(name: str) -> str:
    """Prometheus metric-name charset; JSONL keeps the raw name."""
    out = _NAME_RE.sub("_", name)
    return out if not out[:1].isdigit() else "_" + out


class MetricsRegistry:
    """Thread-safe metrics store. ``hist_window`` bounds each
    histogram's sample memory (the summary is over the most recent
    window, which is what an operator alarming on p95 wants anyway)."""

    def __init__(
        self, hist_window: int = 4096, sketch_alpha: float = 0.01,
    ):
        if hist_window < 1:
            raise ValueError(f"hist_window {hist_window} must be >= 1")
        self.hist_window = hist_window
        self.sketch_alpha = sketch_alpha
        self._counters: Dict[str, float] = {}
        self._gauges: Dict[str, float] = {}
        self._hists: Dict[str, Deque[float]] = {}
        # Mergeable log-bucket sketches (obs/digest.py) fed alongside
        # the sample windows: the window answers "recent p95 here",
        # the sketch answers "fleet p99.9 across every process" --
        # window quantiles cannot merge, sketch quantiles can.
        self._sketches: Dict[str, "LogBucketSketch"] = {}
        self._help: Dict[str, str] = {}
        self._lock = threading.Lock()

    # -- writes --------------------------------------------------------
    def describe(self, name: str, help: str) -> None:
        """Attach HELP text to a metric (the Prometheus exposition
        emits it as a ``# HELP`` line). First description wins --
        producers re-describing on a hot path pay one dict lookup."""
        with self._lock:
            self._help.setdefault(name, help)

    def inc(
        self, name: str, value: float = 1.0,
        help: Optional[str] = None,
    ) -> None:
        if value < 0:
            raise ValueError(
                f"counter {name!r} increment {value} must be >= 0 "
                "(use a gauge for values that go down)"
            )
        if help is not None:
            self.describe(name, help)
        with self._lock:
            self._counters[name] = self._counters.get(name, 0.0) + value

    def set_gauge(
        self, name: str, value: float, help: Optional[str] = None,
    ) -> None:
        if help is not None:
            self.describe(name, help)
        with self._lock:
            self._gauges[name] = float(value)

    def observe(
        self, name: str, value: float, help: Optional[str] = None,
    ) -> None:
        if help is not None:
            self.describe(name, help)
        with self._lock:
            hist = self._hists.get(name)
            if hist is None:
                hist = self._hists[name] = collections.deque(
                    maxlen=self.hist_window
                )
                self._sketches[name] = LogBucketSketch(
                    alpha=self.sketch_alpha
                )
            hist.append(float(value))
            self._sketches[name].add(float(value))

    def reset(self) -> None:
        with self._lock:
            self._counters.clear()
            self._gauges.clear()
            self._hists.clear()
            self._sketches.clear()
            self._help.clear()

    # -- reads ---------------------------------------------------------
    def counter(self, name: str) -> float:
        with self._lock:
            return self._counters.get(name, 0.0)

    def gauge(self, name: str) -> Optional[float]:
        with self._lock:
            return self._gauges.get(name)

    def histogram_summary(self, name: str) -> Dict[str, float]:
        with self._lock:
            vals = sorted(self._hists.get(name, ()))
        return {
            "count": len(vals),
            "sum": sum(vals),
            "min": vals[0] if vals else 0.0,
            "max": vals[-1] if vals else 0.0,
            "p50": _quantile(vals, 0.50),
            "p95": _quantile(vals, 0.95),
            "p99": _quantile(vals, 0.99),
            "p999": _quantile(vals, 0.999),
        }

    def sketch_snapshot(self) -> Dict[str, LogBucketSketch]:
        """Copies of the mergeable sketches, one per histogram -- the
        payload a DigestPublisher ships. Copies, not references: the
        caller serializes outside the lock while producers keep
        observing."""
        with self._lock:
            return {
                n: LogBucketSketch.from_dict(sk.to_dict())
                for n, sk in self._sketches.items()
            }

    def snapshot(self) -> Dict[str, Dict]:
        with self._lock:
            counters = dict(self._counters)
            gauges = dict(self._gauges)
            hist_names = list(self._hists)
        return {
            "counters": counters,
            "gauges": gauges,
            "histograms": {
                n: self.histogram_summary(n) for n in hist_names
            },
        }

    def emit_snapshot(
        self, bus=None, sink: Optional[str] = None,
        step: Optional[int] = None,
    ) -> dict:
        """One ``metrics`` event holding the full snapshot."""
        from tpu_hpc_torch.obs.events import get_bus

        return (bus or get_bus()).emit(
            "metrics", sink=sink, metrics=self.snapshot(), step=step
        )

    # -- Prometheus text exposition ------------------------------------
    def prometheus_text(self, prefix: str = "tpu_hpc") -> str:
        """Counters/gauges as their native types; histograms as
        summaries (p50/p95/p99 quantiles + _sum/_count). Described
        metrics get a ``# HELP`` line ahead of ``# TYPE`` (exposition
        format: HELP text escapes ``\\`` and newlines) -- a scrape
        surface an operator can read without the source."""
        snap = self.snapshot()
        with self._lock:
            helps = dict(self._help)

        def head(name: str, m: str, kind: str) -> list:
            out = []
            text = helps.get(name)
            if text:
                text = text.replace("\\", "\\\\").replace("\n", "\\n")
                out.append(f"# HELP {m} {text}")
            out.append(f"# TYPE {m} {kind}")
            return out

        lines = []
        for name, val in sorted(snap["counters"].items()):
            m = f"{prefix}_{_sanitize(name)}"
            lines += head(name, m, "counter") + [f"{m} {val}"]
        for name, val in sorted(snap["gauges"].items()):
            m = f"{prefix}_{_sanitize(name)}"
            lines += head(name, m, "gauge") + [f"{m} {val}"]
        for name, s in sorted(snap["histograms"].items()):
            m = f"{prefix}_{_sanitize(name)}"
            lines += head(name, m, "summary") + [
                f'{m}{{quantile="0.5"}} {s["p50"]}',
                f'{m}{{quantile="0.95"}} {s["p95"]}',
                f'{m}{{quantile="0.99"}} {s["p99"]}',
                f'{m}{{quantile="0.999"}} {s["p999"]}',
                f"{m}_sum {s['sum']}",
                f"{m}_count {s['count']}",
            ]
        return "\n".join(lines) + ("\n" if lines else "")

    def write_prometheus(
        self, path: Optional[str] = None, prefix: str = "tpu_hpc"
    ) -> Optional[str]:
        """Atomically rewrite the exposition file (textfile-collector
        contract: readers must never see a torn scrape). ``path``
        defaults to ``$TPU_HPC_PROM_FILE``; with neither, a no-op."""
        path = path or os.environ.get(ENV_PROM_FILE)
        if not path:
            return None
        parent = os.path.dirname(path)
        if parent:
            os.makedirs(parent, exist_ok=True)
        tmp = f"{path}.tmp.{os.getpid()}"
        with open(tmp, "w") as f:
            f.write(self.prometheus_text(prefix))
        os.replace(tmp, path)
        return path


_REGISTRY: Optional[MetricsRegistry] = None
# RLock, matching events._BUS_LOCK: signal-handler telemetry may
# re-enter get_registry() on a thread already holding it.
_REGISTRY_LOCK = threading.RLock()


def get_registry() -> MetricsRegistry:
    """The process-wide registry, created lazily."""
    global _REGISTRY
    with _REGISTRY_LOCK:
        if _REGISTRY is None:
            _REGISTRY = MetricsRegistry()
        return _REGISTRY


def set_registry(
    registry: Optional[MetricsRegistry],
) -> Optional[MetricsRegistry]:
    """Swap the process-wide registry; returns the previous one."""
    global _REGISTRY
    with _REGISTRY_LOCK:
        prev, _REGISTRY = _REGISTRY, registry
        return prev
