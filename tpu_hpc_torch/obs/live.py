"""Fleet rollup aggregator + live scoreboard over digest channels.

Port of the JAX package's ``obs/live.py``: framework-free, so copied
with its imports renamed to this package.

The read side of the live plane: tail every per-process digest channel
under ``$TPU_HPC_DIGEST_DIR`` (obs/digest.py), merge into one fleet
view keyed by (role, key) -- occupancy, KV pressure, SLO attainment,
bubble fraction, step time -- and judge two fleet-level verdicts the
per-process view structurally cannot:

* **straggler**: a key whose normalized step signal (the StallDetector
  watermark the supervisor already trusts, falling back to the last
  step time) exceeds ``straggler_factor`` x the median of its *peers*
  -- self-excluded, the PR-14/15 idiom: N-1 healthy members pin the
  baseline, so one slow member cannot drag the median toward itself;
* **stale**: a publisher whose newest digest is older than
  ``stale_after_s``. Absence of telemetry is a first-class signal
  (``digest_stale``), not a silently thinner rollup -- the wedged
  process is precisely the one that stops publishing.

The merge is idempotent and order-free: sources are keyed by
(role, key, host, pid) and only the highest-``seq`` record per source
is kept, so re-reading a channel, reading channels in any order, or
merging partial rollups from two aggregators all converge to the same
view (property-tested in tests/test_live.py). Counters are cumulative
in the digests, so cross-source aggregation is plain summation.

``python -m tpu_hpc_torch.obs.live DIR --json`` is the machine-readable
contract (one deterministic JSON document, floats rounded, no
wall-clock or host/pid fields); ``--watch`` renders a refreshing terminal
scoreboard; ``--prom`` writes the fleet-merged Prometheus textfile
(one atomic file for the whole fleet -- per-process files unchanged).
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time
from typing import Dict, List, Mapping, Optional, Tuple

from tpu_hpc_torch.obs.digest import (
    ENV_DIGEST_DIR,
    LogBucketSketch,
    read_digest_dir,
)
from tpu_hpc_torch.obs.schema import SCHEMA_VERSION

ENV_FLEET_PROM_FILE = "TPU_HPC_FLEET_PROM_FILE"

DEFAULT_STALE_AFTER_S = 15.0
DEFAULT_STRAGGLER_FACTOR = 3.0

# One publishing process: the dedup unit. A restarted process (new
# pid) is a NEW source under the same (role, key) -- its counters sum
# with its predecessor's final cumulative totals instead of silently
# replacing them.
_SourceKey = Tuple[str, str, str, int]


def _r(x: float, nd: int = 6) -> float:
    """Rollup floats are rounded so the --json document is stable
    across platforms' float formatting."""
    return round(float(x), nd)


class Rollup:
    """Mergeable fleet view over ``health_digest`` records."""

    def __init__(
        self,
        stale_after_s: float = DEFAULT_STALE_AFTER_S,
        straggler_factor: float = DEFAULT_STRAGGLER_FACTOR,
    ):
        if stale_after_s <= 0:
            raise ValueError(
                f"stale_after_s {stale_after_s} must be > 0"
            )
        if straggler_factor <= 1.0:
            raise ValueError(
                f"straggler_factor {straggler_factor} must be > 1"
            )
        self.stale_after_s = stale_after_s
        self.straggler_factor = straggler_factor
        self._sources: Dict[_SourceKey, dict] = {}
        self.digests = 0

    # -- write side ----------------------------------------------------
    def ingest(self, records) -> "Rollup":
        """Fold digest records in; keeps the latest ``seq`` per source
        (ties broken by ``t``). Duplicate or out-of-order delivery is
        a no-op -- the idempotence the merge algebra rests on."""
        for rec in records:
            if rec.get("event") != "health_digest":
                continue
            self.digests += 1
            src: _SourceKey = (
                str(rec.get("role")), str(rec.get("key")),
                str(rec.get("host", "")), int(rec.get("pid", 0)),
            )
            cur = self._sources.get(src)
            if cur is not None:
                key_new = (int(rec.get("seq", 0)), float(rec.get("t", 0.0)))
                key_cur = (int(cur.get("seq", 0)), float(cur.get("t", 0.0)))
                if key_new <= key_cur:
                    continue
            self._sources[src] = rec
        return self

    def merge(self, other: "Rollup") -> "Rollup":
        """In-place merge of another rollup (two aggregators covering
        overlapping channel sets converge): per-source latest wins."""
        for src, rec in other._sources.items():
            cur = self._sources.get(src)
            if cur is not None:
                key_new = (int(rec.get("seq", 0)), float(rec.get("t", 0.0)))
                key_cur = (int(cur.get("seq", 0)), float(cur.get("t", 0.0)))
                if key_new <= key_cur:
                    continue
            self._sources[src] = rec
        self.digests += other.digests
        return self

    # -- read side -----------------------------------------------------
    def latest_t(self) -> Optional[float]:
        if not self._sources:
            return None
        return max(float(r.get("t", 0.0)) for r in self._sources.values())

    def build(self, now: Optional[float] = None) -> dict:
        """The fleet view as one deterministic JSON-safe document.
        ``now`` defaults to the newest digest time seen -- the only
        deterministic notion of "now" an offline/virtual-clock reader
        has; live watchers pass wall time."""
        if now is None:
            now = self.latest_t() or 0.0
        # (role, key) -> list of that pair's latest-per-source records.
        by_rk: Dict[Tuple[str, str], List[dict]] = {}
        for (role, key, _h, _p), rec in sorted(self._sources.items()):
            by_rk.setdefault((role, key), []).append(rec)

        roles: Dict[str, dict] = {}
        for (role, key), recs in sorted(by_rk.items()):
            latest = max(
                recs,
                key=lambda r: (float(r.get("t", 0.0)), int(r.get("seq", 0))),
            )
            counters: Dict[str, float] = {}
            hists: Dict[str, LogBucketSketch] = {}
            for rec in recs:
                for name, v in (rec.get("counters") or {}).items():
                    counters[name] = counters.get(name, 0.0) + float(v)
                for name, d in (rec.get("hists") or {}).items():
                    sk = LogBucketSketch.from_dict(d)
                    if name in hists:
                        hists[name].merge(sk)
                    else:
                        hists[name] = sk
            age = now - float(latest.get("t", 0.0))
            row: dict = {
                "seq": int(latest.get("seq", 0)),
                "t": _r(float(latest.get("t", 0.0))),
                "age_s": _r(age),
                "sources": len(recs),
                "counters": {
                    k: _r(v) for k, v in sorted(counters.items())
                },
                "gauges": {
                    k: _r(float(v))
                    for k, v in sorted((latest.get("gauges") or {}).items())
                },
                "hists": {
                    k: {f: _r(v) for f, v in hists[k].summary().items()}
                    for k in sorted(hists)
                },
                "stale": bool(age > self.stale_after_s),
                "straggler": False,  # judged below, needs peers
            }
            for f in ("step_s", "watermark_s"):
                if latest.get(f) is not None:
                    row[f] = _r(float(latest[f]))
            roles.setdefault(role, {"keys": {}})["keys"][key] = row
            row["_sketches"] = hists  # stripped before return

        # Straggler verdicts: within each role, compare every key's
        # normalized step signal to the median of its PEERS (self
        # excluded). >= 2 peers required -- with one peer the "median"
        # is just the other member and either could be the slow one.
        for role, block in roles.items():
            keys = block["keys"]
            signals = {
                k: (row.get("watermark_s") or row.get("step_s"))
                for k, row in keys.items()
            }
            for k, row in keys.items():
                v = signals.get(k)
                if v is None:
                    continue
                peers = [
                    s for pk, s in signals.items()
                    if pk != k and s is not None
                ]
                if len(peers) < 2:
                    continue
                med = statistics.median(peers)
                if med > 0 and v > self.straggler_factor * med:
                    row["straggler"] = True

        # Role-level aggregates + verdict lists.
        stragglers: List[str] = []
        stale: List[str] = []
        for role, block in sorted(roles.items()):
            keys = block["keys"]
            counters: Dict[str, float] = {}
            hists: Dict[str, LogBucketSketch] = {}
            for key, row in sorted(keys.items()):
                for name, v in row["counters"].items():
                    counters[name] = counters.get(name, 0.0) + v
                for name, sk in row.pop("_sketches").items():
                    if name in hists:
                        hists[name].merge(sk)
                    else:
                        hists[name] = sk
                if row["straggler"]:
                    stragglers.append(f"{role}:{key}")
                if row["stale"]:
                    stale.append(f"{role}:{key}")
            block["counters"] = {
                k: _r(v) for k, v in sorted(counters.items())
            }
            block["hists"] = {
                k: {f: _r(v) for f, v in hists[k].summary().items()}
                for k in sorted(hists)
            }
            block["stragglers"] = sorted(
                k for k, row in keys.items() if row["straggler"]
            )
            block["stale"] = sorted(
                k for k, row in keys.items() if row["stale"]
            )

        out: dict = {
            "schema_version": SCHEMA_VERSION,
            "now": _r(now),
            "sources": len(self._sources),
            "digests": self.digests,
            "stale_after_s": self.stale_after_s,
            "straggler_factor": self.straggler_factor,
            "roles": roles,
            "stragglers": sorted(stragglers),
            "stale": sorted(stale),
        }
        # Fleet SLO attainment from the cumulative slo_good/slo_bad
        # counters any producer may carry (serve/fleet.py does).
        good = bad = 0.0
        for block in roles.values():
            good += block["counters"].get("slo_good", 0.0)
            bad += block["counters"].get("slo_bad", 0.0)
        if good + bad > 0:
            out["slo"] = {
                "good": _r(good),
                "bad": _r(bad),
                "attainment": _r(good / (good + bad)),
            }
        else:
            out["slo"] = None
        return out


def rollup_from_dir(
    dir: str,
    *,
    stale_after_s: float = DEFAULT_STALE_AFTER_S,
    straggler_factor: float = DEFAULT_STRAGGLER_FACTOR,
) -> Rollup:
    """One-shot: read every channel under ``dir`` into a Rollup."""
    roll = Rollup(
        stale_after_s=stale_after_s, straggler_factor=straggler_factor
    )
    roll.ingest(read_digest_dir(dir))
    return roll


def stale_entries(view: Mapping) -> List[dict]:
    """The ``digest_stale`` payloads a built view implies -- what a
    producer-side monitor (FleetTelemetry, the supervisor) emits, one
    record per stale (role, key)."""
    out: List[dict] = []
    for role, block in (view.get("roles") or {}).items():
        for key, row in block["keys"].items():
            if row.get("stale"):
                out.append({
                    "role": role,
                    "key": key,
                    "age_s": row["age_s"],
                    "stale_after_s": view.get("stale_after_s"),
                    "last_t": row["t"],
                    "last_seq": row["seq"],
                })
    return sorted(out, key=lambda d: (d["role"], d["key"]))


# -- scoreboard ---------------------------------------------------------
def format_scoreboard(view: Mapping) -> str:
    """Terminal rendering of a built view: one row per (role, key),
    verdict flags inline, fleet SLO at the foot."""
    lines = [
        f"fleet rollup @ t={view['now']}  sources={view['sources']}  "
        f"digests={view['digests']}  stragglers={len(view['stragglers'])}"
        f"  stale={len(view['stale'])}"
    ]
    header = (
        f"{'role':<10} {'key':<8} {'age_s':>8} {'step_s':>9} "
        f"{'watermark':>10}  gauges / flags"
    )
    lines += [header, "-" * len(header)]
    for role, block in sorted((view.get("roles") or {}).items()):
        for key, row in sorted(block["keys"].items()):
            gauges = " ".join(
                f"{k}={v}" for k, v in list(row["gauges"].items())[:3]
            )
            flags = []
            if row.get("straggler"):
                flags.append("STRAGGLER")
            if row.get("stale"):
                flags.append("STALE")
            step_s = row.get("step_s")
            wm = row.get("watermark_s")
            lines.append(
                f"{role:<10} {key:<8} {row['age_s']:>8.3f} "
                f"{(f'{step_s:.4f}' if step_s is not None else '-'):>9} "
                f"{(f'{wm:.4f}' if wm is not None else '-'):>10}  "
                f"{gauges}{('  ' + ' '.join(flags)) if flags else ''}"
            )
    slo = view.get("slo")
    if slo:
        lines.append(
            f"SLO: attainment {slo['attainment']:.4f} "
            f"(good {slo['good']:g} / bad {slo['bad']:g})"
        )
    return "\n".join(lines)


# -- fleet-merged Prometheus textfile -----------------------------------
def fleet_prometheus_text(
    view: Mapping, prefix: str = "tpu_hpc_fleet"
) -> str:
    """The whole fleet in one exposition: per-key counters/gauges with
    ``role``/``key`` labels, merged per-role histogram quantiles
    (p50/p95/p99/p99.9 from the mergeable sketches), and the verdict
    gauges. Per-process textfiles (registry.write_prometheus) are
    untouched -- this is the aggregator's file."""
    from tpu_hpc_torch.obs.registry import _sanitize

    lines: List[str] = []
    for role, block in sorted((view.get("roles") or {}).items()):
        for key, row in sorted(block["keys"].items()):
            lab = f'role="{role}",key="{key}"'
            for name, v in sorted(row["counters"].items()):
                lines.append(
                    f"{prefix}_{_sanitize(name)}{{{lab}}} {v}"
                )
            for name, v in sorted(row["gauges"].items()):
                lines.append(
                    f"{prefix}_{_sanitize(name)}{{{lab}}} {v}"
                )
            lines.append(
                f"{prefix}_digest_age_s{{{lab}}} {row['age_s']}"
            )
            lines.append(
                f"{prefix}_straggler{{{lab}}} "
                f"{1 if row.get('straggler') else 0}"
            )
            lines.append(
                f"{prefix}_digest_stale{{{lab}}} "
                f"{1 if row.get('stale') else 0}"
            )
        for name, s in sorted(block["hists"].items()):
            m = f"{prefix}_{_sanitize(name)}"
            for q, f in (("0.5", "p50"), ("0.95", "p95"),
                         ("0.99", "p99"), ("0.999", "p999")):
                lines.append(
                    f'{m}{{role="{role}",quantile="{q}"}} {s[f]}'
                )
            lines.append(f'{m}_sum{{role="{role}"}} {s["sum"]}')
            lines.append(f'{m}_count{{role="{role}"}} {s["count"]}')
    slo = view.get("slo")
    if slo:
        lines.append(f"{prefix}_slo_attainment {slo['attainment']}")
    return "\n".join(lines) + ("\n" if lines else "")


def write_fleet_prometheus(
    view: Mapping,
    path: Optional[str] = None,
    prefix: str = "tpu_hpc_fleet",
) -> Optional[str]:
    """Atomic tmp+rename (the textfile-collector contract, same as
    registry.write_prometheus). ``path`` defaults to
    ``$TPU_HPC_FLEET_PROM_FILE``; with neither, a no-op."""
    path = path or os.environ.get(ENV_FLEET_PROM_FILE)
    if not path:
        return None
    parent = os.path.dirname(path)
    if parent:
        os.makedirs(parent, exist_ok=True)
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w") as f:
        f.write(fleet_prometheus_text(view, prefix))
    os.replace(tmp, path)
    return path


# -- digest-plane micro-bench (the banked overhead evidence) ------------
def bench_live(out_path: str, n_publish: int = 64) -> List[dict]:
    """Measure the plane's own cost and error bound; appends two
    ``bench`` records to ``out_path`` and returns them:

    * ``obs.digest_publish_ms`` -- median wall cost of one
      ``DigestPublisher.publish`` (build + stamp + append) with a
      registry-shaped payload;
    * ``obs.digest_quantile_rel_err`` -- worst observed relative error
      of merged-sketch quantiles vs exact nearest-rank over a
      deterministic two-stream workload (must sit under the pinned
      DEFAULT_ALPHA bound).

    This is how BENCH_LIVE rows are (re)generated:
    ``python -m tpu_hpc_torch.obs.live --bench BENCH_LIVE_rN.jsonl``.
    """
    import random
    import tempfile

    from tpu_hpc_torch.obs.digest import DEFAULT_ALPHA, DigestPublisher
    from tpu_hpc_torch.obs.events import get_bus

    rng = random.Random(20260807)
    # -- publish cost --
    durs: List[float] = []
    with tempfile.TemporaryDirectory() as td:
        pub = DigestPublisher(td, "bench", "0")
        sketch = LogBucketSketch()
        for _ in range(2048):
            sketch.add(rng.lognormvariate(1.0, 1.0))
        counters = {f"c{i}": float(i * 7) for i in range(24)}
        gauges = {f"g{i}": i / 3.0 for i in range(12)}
        hists = {f"h{i}": sketch for i in range(4)}
        for i in range(n_publish):
            t0 = time.perf_counter()
            pub.publish(
                counters=counters, gauges=gauges, hists=hists,
                t=float(i),
            )
            durs.append((time.perf_counter() - t0) * 1e3)
    durs.sort()
    publish_ms = durs[len(durs) // 2]

    # -- merged-quantile error vs exact nearest-rank --
    streams = [
        [rng.lognormvariate(0.0, 2.0) for _ in range(4000)],
        [rng.uniform(0.5, 50.0) for _ in range(4000)],
    ]
    sketches = []
    for s in streams:
        sk = LogBucketSketch()
        for v in s:
            sk.add(v)
        sketches.append(sk)
    merged = sketches[0].merge(sketches[1])
    union = sorted(streams[0] + streams[1])
    worst = 0.0
    import math
    for q in (0.5, 0.9, 0.95, 0.99, 0.999):
        exact = union[max(0, math.ceil(q * len(union)) - 1)]
        est = merged.quantile(q)
        worst = max(worst, abs(est - exact) / exact)

    bus = get_bus()
    rows = [
        bus.emit(
            "bench", sink=out_path, metric="obs.digest_publish_ms",
            value=round(publish_ms, 4), unit="ms",
            n_publish=n_publish, n_counters=len(counters),
            n_gauges=len(gauges), n_hists=len(hists),
            workload="digest_publish",
        ),
        bus.emit(
            "bench", sink=out_path,
            metric="obs.digest_quantile_rel_err",
            value=round(worst, 6), unit="ratio",
            alpha=DEFAULT_ALPHA, n_values=len(union),
            workload="digest_merge_quantiles",
        ),
    ]
    return rows


# -- CLI ----------------------------------------------------------------
def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m tpu_hpc_torch.obs.live",
        description="Fleet rollup over health-digest channels.",
    )
    p.add_argument(
        "dir", nargs="?", default=os.environ.get(ENV_DIGEST_DIR),
        help=f"digest channel directory (default ${ENV_DIGEST_DIR})",
    )
    p.add_argument("--json", action="store_true",
                   help="print the rollup as one JSON document")
    p.add_argument("--watch", action="store_true",
                   help="refreshing terminal scoreboard")
    p.add_argument("--interval", type=float, default=2.0,
                   help="--watch refresh period (s)")
    p.add_argument("--now", type=float, default=None,
                   help="override 'now' (virtual-clock runs); default "
                        "is the newest digest time seen")
    p.add_argument("--stale-after", type=float,
                   default=DEFAULT_STALE_AFTER_S,
                   help="seconds without a digest before a publisher "
                        "is flagged stale")
    p.add_argument("--straggler-factor", type=float,
                   default=DEFAULT_STRAGGLER_FACTOR,
                   help="x peer-median threshold for the straggler "
                        "verdict")
    p.add_argument("--prom", default=None, metavar="FILE",
                   help="also write the fleet-merged Prometheus "
                        "textfile here")
    p.add_argument("--bench", default=None, metavar="FILE",
                   help="measure digest publish cost + sketch error "
                        "bound; append bench rows to FILE and exit")
    args = p.parse_args(argv)

    if args.bench:
        rows = bench_live(args.bench)
        for r in rows:
            print(f"{r['metric']} = {r['value']} {r['unit']}")
        return 0

    if not args.dir:
        print(
            f"error: no digest dir (pass DIR or set ${ENV_DIGEST_DIR})",
            file=sys.stderr,
        )
        return 2

    def snapshot(now: Optional[float]) -> dict:
        roll = rollup_from_dir(
            args.dir,
            stale_after_s=args.stale_after,
            straggler_factor=args.straggler_factor,
        )
        view = roll.build(now=now)
        if args.prom:
            write_fleet_prometheus(view, args.prom)
        return view

    if args.watch:
        try:
            while True:
                view = snapshot(args.now or time.time())
                sys.stdout.write(
                    "\x1b[2J\x1b[H" + format_scoreboard(view) + "\n"
                )
                sys.stdout.flush()
                time.sleep(args.interval)
        except KeyboardInterrupt:
            return 0

    view = snapshot(args.now)
    if view["sources"] == 0:
        print(
            f"error: no health digests under {args.dir}",
            file=sys.stderr,
        )
        return 2
    if args.json:
        print(json.dumps(view, indent=2, sort_keys=True))
    else:
        print(format_scoreboard(view))
    return 0


if __name__ == "__main__":  # pragma: no cover - exercised via CLI tests
    raise SystemExit(main())
