"""Mergeable per-process health digests: the fleet's gossip unit.

Port of the JAX package's ``obs/digest.py``: framework-free, so copied
with its imports renamed to this package.

Everything in obs/ so far is per-process and mostly post-hoc: the
registry's Prometheus textfile covers one process, ``obs.report``
reads a finished JSONL. A fleet of N serving replicas, S MPMD stages
and H training hosts needs the *live* union, and the fleet-scale
diagnosability literature (arxiv 2510.20171) is blunt that the signal
must aggregate across the fleet with bounded loss -- not be sampled
from one lucky process. Two obstacles:

* the registry's histograms are sample windows (bounded deques).
  Quantiles over sample windows do NOT merge: p95 of two windows is
  not the p95 of the union. :class:`LogBucketSketch` fixes this with
  log-spaced buckets (the DDSketch construction): the bucket index of
  value ``v`` is ``ceil(log_gamma v)`` with ``gamma = (1+alpha)/
  (1-alpha)``, so any quantile estimate is within relative error
  ``alpha`` of the true value, and merging two sketches is bucket-
  count addition -- associative, commutative, and loss-free.
* cross-process transport. We reuse the MorphChannel file idiom
  (resilience/signals.py): each publisher appends schema-stamped
  ``health_digest`` records to its own JSONL under
  ``$TPU_HPC_DIGEST_DIR`` (O_APPEND single-write atomicity; no
  coordination, no server), with flight-dump non-clobbering names so
  a restarted process never truncates its predecessor's evidence.

Counters in a digest are CUMULATIVE (each record carries the
publisher's totals so far), not per-period deltas: a reader that
misses a record, or reads the same record twice, still converges to
the right totals by keeping the latest ``seq`` per publisher -- the
idempotence that makes the aggregator's merge safe under replays and
arbitrary interleavings (property-tested in tests/test_live.py).
"""
from __future__ import annotations

import json
import math
import os
import time
from typing import Dict, List, Mapping, Optional, Tuple

ENV_DIGEST_DIR = "TPU_HPC_DIGEST_DIR"

# Pinned default relative-error bound for digest sketches. 1% is tight
# enough that a merged fleet p99 is operationally the p99, and coarse
# enough that a sketch spanning nanoseconds..hours stays ~a few
# thousand buckets.
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


def _non_clobbering(path: str) -> str:
    """Flight-dump naming discipline: never overwrite a predecessor's
    channel -- append ``.1``, ``.2``, ... until the name is free."""
    if not os.path.exists(path):
        return path
    i = 1
    while os.path.exists(f"{path}.{i}"):
        i += 1
    return f"{path}.{i}"


class DigestPublisher:
    """One process's periodic ``health_digest`` feed.

    Each ``publish*`` call stamps a schema-valid record through the
    event bus (so it also lands in the run log + flight ring with
    run_id/host/pid provenance) and appends the same record to this
    publisher's own channel file under ``dir`` -- the MorphChannel
    append idiom: makedirs-then-append, one ``write()`` per record, no
    locks. ``seq`` is monotonic per publisher; counters passed in must
    be cumulative (see module docstring).

    ``t`` is the publisher's notion of now -- the harnesses pass their
    virtual clock so a replayed run publishes bit-identical digests;
    wall-clock producers (the Trainer) default to ``time.time()``.
    """

    def __init__(
        self,
        dir: str,
        role: str,
        key: str,
        *,
        alpha: float = DEFAULT_ALPHA,
        period_s: Optional[float] = None,
        bus=None,
    ):
        if not role or not key:
            raise ValueError(
                f"role {role!r} and key {key!r} must be non-empty"
            )
        self.dir = dir
        self.role = role
        self.key = str(key)
        self.alpha = alpha
        self.period_s = period_s
        self._bus = bus
        safe = f"digest.{role}.{self.key}.pid{os.getpid()}.jsonl"
        os.makedirs(dir, exist_ok=True)
        self.path = _non_clobbering(os.path.join(dir, safe))
        self.seq = 0
        self.last_publish_t: Optional[float] = None

    @classmethod
    def from_env(
        cls, role: str, key: str, **kw
    ) -> Optional["DigestPublisher"]:
        """None when ``$TPU_HPC_DIGEST_DIR`` is unset -- the live plane
        is strictly opt-in; producers guard with ``if pub:``."""
        d = os.environ.get(ENV_DIGEST_DIR)
        if not d:
            return None
        return cls(d, role, key, **kw)

    def due(self, now: float) -> bool:
        """Rate limit helper: True when ``period_s`` has elapsed since
        the last publish (or on the first call / no period set)."""
        if self.period_s is None or self.last_publish_t is None:
            return True
        return now - self.last_publish_t >= self.period_s

    def publish(
        self,
        *,
        counters: Optional[Mapping[str, float]] = None,
        gauges: Optional[Mapping[str, float]] = None,
        hists: Optional[Mapping[str, LogBucketSketch]] = None,
        t: Optional[float] = None,
        step_s: Optional[float] = None,
        watermark_s: Optional[float] = None,
        step: Optional[int] = None,
        sink: Optional[str] = None,
    ) -> dict:
        """Build + emit + append one digest record; returns the
        stamped record. The build/append cost is metered: a
        ``digest_publish`` span plus the ``obs.digest_publish_ms``
        histogram the regress gate banks -- the plane's own overhead
        is gate-diffed like any other hot path."""
        from tpu_hpc_torch.obs.events import get_bus
        from tpu_hpc_torch.obs.registry import get_registry
        from tpu_hpc_torch.obs.spans import emit_span

        t0 = time.perf_counter()
        bus = self._bus or get_bus()
        fields: dict = {
            "role": self.role,
            "key": self.key,
            "t": float(t if t is not None else time.time()),
            "seq": self.seq,
            "counters": {
                k: float(v) for k, v in sorted((counters or {}).items())
            },
            "gauges": {
                k: float(v) for k, v in sorted((gauges or {}).items())
            },
            "hists": {
                k: v.to_dict() for k, v in sorted((hists or {}).items())
            },
            "alpha": self.alpha,
        }
        if step_s is not None:
            fields["step_s"] = round(float(step_s), 4)
        if watermark_s is not None:
            fields["watermark_s"] = round(float(watermark_s), 4)
        if self.period_s is not None:
            fields["period_s"] = self.period_s
        rec = bus.emit("health_digest", sink=sink, step=step, **fields)
        # MorphChannel append idiom: one write, O_APPEND-atomic for
        # records far under PIPE_BUF-scale sizes.
        os.makedirs(self.dir, exist_ok=True)
        with open(self.path, "a") as f:
            f.write(json.dumps(rec, sort_keys=True) + "\n")
        self.seq += 1
        self.last_publish_t = fields["t"]
        dur = time.perf_counter() - t0
        emit_span("digest_publish", dur, bus=bus, step=step,
                  n=len(fields["hists"]))
        # NOT via emit_span's hist= (that observes seconds); this
        # histogram is ms-named and banked in ms.
        get_registry().observe(
            "obs.digest_publish_ms", dur * 1e3,
            help="health-digest build+append cost per publish (ms)",
        )
        return rec

    def publish_registry(
        self,
        registry=None,
        *,
        t: Optional[float] = None,
        step_s: Optional[float] = None,
        watermark_s: Optional[float] = None,
        step: Optional[int] = None,
        sink: Optional[str] = None,
    ) -> dict:
        """Digest the process-wide registry: counters + gauges verbatim,
        histograms from the registry's mergeable sketch backend (the
        sample windows stay process-local -- they can't merge)."""
        from tpu_hpc_torch.obs.registry import get_registry

        reg = registry or get_registry()
        snap = reg.snapshot()
        return self.publish(
            counters=snap["counters"],
            gauges=snap["gauges"],
            hists=reg.sketch_snapshot(),
            t=t, step_s=step_s, watermark_s=watermark_s,
            step=step, sink=sink,
        )


def merge_digest_hists(
    records: List[Mapping],
) -> Dict[str, LogBucketSketch]:
    """Merge the ``hists`` payloads of digest records (each already the
    latest per publisher) into one sketch per histogram name."""
    out: Dict[str, LogBucketSketch] = {}
    for rec in records:
        for name, d in (rec.get("hists") or {}).items():
            sk = LogBucketSketch.from_dict(d)
            if name in out:
                out[name].merge(sk)
            else:
                out[name] = sk
    return out


def read_channel(path: str) -> List[dict]:
    """Read one digest channel file; skips blank lines, fails loudly
    on non-JSON (a torn channel is evidence corruption, not noise)."""
    records: List[dict] = []
    with open(path) as f:
        for lineno, line in enumerate(f, start=1):
            line = line.strip()
            if not line:
                continue
            try:
                records.append(json.loads(line))
            except ValueError as e:
                raise ValueError(
                    f"{path}:{lineno}: not JSON ({e})"
                ) from None
    return records


def read_digest_dir(dir: str) -> List[dict]:
    """Every ``health_digest`` record from every channel under
    ``dir`` (sorted filenames -- deterministic ingest order). Non-
    digest records in a channel are ignored: publishers share the
    directory with nothing, but defensiveness is cheap."""
    records: List[dict] = []
    try:
        names = sorted(os.listdir(dir))
    except FileNotFoundError:
        return records
    for name in names:
        if ".jsonl" not in name or not name.startswith("digest."):
            continue
        for rec in read_channel(os.path.join(dir, name)):
            if rec.get("event") == "health_digest":
                records.append(rec)
    return records
