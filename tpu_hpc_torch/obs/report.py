"""``python -m tpu_hpc_torch.obs.report run.jsonl`` -- where did the time go?

Port of the JAX package's ``obs/report.py``: framework-free, so copied
with its imports renamed to this package.

Turns one run's schema-stamped JSONL (the Trainer's run log, a serve
replay's trace, or a flight-recorder dump -- they all validate against
obs/schema.py) into the report every perf or robustness change is
judged by:

* **step-time breakdown** -- per-phase seconds and shares from the
  span events (data / compute / sync / ckpt, plus any other spans
  found; phases XLA fuses away on a given path are reported as such
  instead of silently omitted);
* **goodput** -- productive vs ckpt/restore/other wall-clock, per
  attempt and combined across a preempted-and-resumed run;
* **MFU** -- when the run's config carries ``model_flops_per_item``
  and the device kind has a known peak (checks/roofline.py's spec
  table; ``--peak-flops`` overrides for sim/CPU runs);
* **restart timeline** -- one line per attempt (resumed-from step,
  end step, exit disposition);
* **serving** -- tokens/s/chip, TTFT/ITL quantiles and serving MFU
  when the file holds serve records;
* **load generator** -- per-tenant lifecycle/shed/queued breakdown
  and admission-control decisions when the file holds loadgen
  (``lg_*``) records.

``--json`` emits the same report as one JSON object for tools.
The JSON contract (pinned by tests): the JSON carries
``schema_version``; exit code 0 = report produced, 2 = empty, missing
or schema-invalid input. obs/regress.py and CI consume exactly this.
"""
from __future__ import annotations

import argparse
import json
import sys
from typing import Dict, Optional, Sequence

from tpu_hpc_torch.obs.schema import (  # noqa: F401
    SCHEMA_VERSION,
    SchemaError,
    load_records,
)
# (load_records re-exported: the schema module owns the one
# parse-and-validate loop; the report is just its largest consumer.)

# Canonical training phases, always shown (a phase the current path
# cannot measure separately prints a note, not a silent hole).
CANONICAL_PHASES = ("data", "compute", "sync", "ckpt")
_PHASE_NOTES = {
    "data": "on-device generator fused into the step program",
    "sync": "grad collectives fused into compute by GSPMD/XLA",
}


def _phase_breakdown(records: Sequence[dict]) -> Dict[str, dict]:
    spans = [r for r in records if r.get("event") == "span"]
    by: Dict[str, dict] = {}
    # The share denominator counts TOP-LEVEL spans only: a nested
    # span's time is already inside its parent's (that is what the
    # parent/depth fields exist for), so summing every span would
    # double-count it. Child phases still get their own rows, with
    # shares against the same wall-clock denominator.
    total = 0.0
    for s in spans:
        e = by.setdefault(s["name"], {"total_s": 0.0, "count": 0})
        e["total_s"] += float(s["dur_s"])
        e["count"] += 1
        if not s.get("depth"):
            total += float(s["dur_s"])
    for e in by.values():
        e["share"] = e["total_s"] / total if total > 0 else 0.0
    return by


def _goodput(run_ends: Sequence[dict]) -> Optional[dict]:
    if not run_ends:
        return None
    attempts = [
        {
            "attempt": r["attempt"],
            "resumed_from_step": r["resumed_from_step"],
            "step": r["step"],
            "preempted": r["preempted"],
            **r["goodput"],
        }
        for r in run_ends
    ]
    totals = {
        k: sum(a[k] for a in attempts)
        for k in ("total_s", "productive_s", "ckpt_s", "restore_s",
                  "other_s")
    }
    totals["goodput"] = (
        totals["productive_s"] / totals["total_s"]
        if totals["total_s"] > 0 else 0.0
    )
    return {"attempts": attempts, "combined": totals}


def _mfu(
    records: Sequence[dict],
    run_start: Optional[dict],
    peak_flops_per_device: Optional[float],
) -> Optional[dict]:
    if run_start is None:
        return None
    cfg = run_start.get("config") or {}
    flops_per_item = float(cfg.get("model_flops_per_item") or 0.0)
    if flops_per_item <= 0:
        return None
    peak = peak_flops_per_device
    if peak is None:
        try:
            from tpu_hpc_torch.checks.roofline import peak_flops_for_kind

            peak = peak_flops_for_kind(
                run_start.get("device_kind", "")
            )
        except ImportError:  # pragma: no cover - minimal installs
            peak = None
    if not peak:
        return None
    # Time-weighted throughput: each epoch record's rate weighted by
    # the wall time its chunk covered (steps-advanced x s/step), so a
    # slow straggling chunk depresses the run MFU the way it
    # depressed the run. Walked in FILE ORDER with prev_step re-seeded
    # at every run_start: a preempted-and-resumed log interleaves
    # attempts, and seeding once from the last attempt would clamp
    # every earlier attempt's first chunk to a ~1-step weight.
    num = den = 0.0
    prev_step = 0
    for r in records:
        event = r.get("event")
        if event == "run_start":
            prev_step = r.get("start_step", 0)
        elif event == "epoch":
            chunk_s = max(r["step"] - prev_step, 1) * r["s_per_step"]
            prev_step = r["step"]
            num += r["items_per_s"] * chunk_s
            den += chunk_s
    if den == 0.0:
        return None
    items_per_s = num / den
    n_dev = run_start["n_devices"]
    return {
        "items_per_s": items_per_s,
        "flops_per_item": flops_per_item,
        "peak_flops_per_device": peak,
        "n_devices": n_dev,
        "mfu": items_per_s * flops_per_item / (peak * n_dev),
    }


def _serve(records: Sequence[dict]) -> Optional[dict]:
    summaries = [
        r for r in records if r.get("event") == "serve_summary"
    ]
    if not summaries:
        return None
    s = summaries[-1]
    out = {
        k: s[k]
        for k in (
            "requests", "tokens", "tokens_per_s",
            "tokens_per_s_per_chip", "ttft_ms_p50", "ttft_ms_p95",
            "ttft_ms_p99", "itl_ms_p50", "itl_ms_p95", "itl_ms_p99",
            # Paged KV cache (serve/paging.py): cache-efficiency
            # numbers next to the latency quantiles, so the regress
            # gate's serve.* namespace holds hit rate and page
            # headroom too.
            "kv_layout", "kv_block_size", "kv_blocks",
            "kv_blocks_free_min", "prefix_hit_rate", "prefix_hits",
            "prefix_hit_blocks", "prefill_chunks",
            # Speculative decoding (serve/spec.py): mode/k are
            # identity, acceptance_rate and draft_ms are the judged
            # signals (regress excludes the identity + raw counts).
            "spec_mode", "spec_k", "acceptance_rate", "draft_ms",
            "drafted", "accepted", "rejected", "verify_steps",
            # Host-DRAM KV tier (serve/tier.py): pool config
            # (kv_host_blocks, inflight) is identity, the wire bytes
            # and hop quantiles are the judged signals (regress
            # excludes the config + raw counts).
            "kv_host_blocks", "kv_host_used", "kv_host_free",
            "kv_host_drops", "kv_host_inflight_bytes",
            "kv_host_inflight_source", "kv_hop_ms_p50",
            "kv_hop_ms_p95", "kv_spills", "kv_spill_pages",
            "kv_spill_wire_bytes", "kv_refills", "kv_refill_pages",
            "kv_refill_wire_bytes",
        )
        if k in s
    }
    if "serve_mfu" in s:
        out["serve_mfu"] = s["serve_mfu"]
    stalls = (s.get("batcher") or {}).get("block_stalls")
    if stalls is not None:
        out["block_stalls"] = stalls
    return out


def _loadgen(records: Sequence[dict]) -> Optional[dict]:
    """Load-harness breakdown: per-tenant lifecycle counts and TTFT
    quantiles rebuilt from the lg_* events themselves (the breakdown
    must exist even when a run died before its serve_summary), plus
    the admission-control decision counts that attribute shed load."""
    from tpu_hpc_torch.obs.quantiles import quantile

    headers = [
        r for r in records if r.get("event") == "load_scenario"
    ]
    lifecycle = [
        r for r in records
        if r.get("event") in (
            "lg_arrival", "lg_admit", "lg_first_token", "lg_finish",
            "lg_shed",
        )
    ]
    admissions = [
        r for r in records if r.get("event") == "admission"
    ]
    if not headers and not lifecycle and not admissions:
        return None
    tenants: Dict[str, dict] = {}

    def entry(name: str) -> dict:
        return tenants.setdefault(name, {
            "arrivals": 0, "admitted": 0, "queued": 0,
            "finished": 0, "shed": 0, "_ttfts": [],
        })

    for r in lifecycle:
        e = entry(r["tenant"])
        ev = r["event"]
        if ev == "lg_arrival":
            e["arrivals"] += 1
        elif ev == "lg_admit":
            e["admitted"] += 1
            # The producer's explicit tick-aware flag when present;
            # queue_ms alone over-counts same-tick admissions (an
            # earlier slot's prefill advances the shared clock).
            if r.get("queued", r["queue_ms"] > 1e-9):
                e["queued"] += 1
        elif ev == "lg_first_token":
            e["_ttfts"].append(float(r["ttft_ms"]))
        elif ev == "lg_finish":
            e["finished"] += 1
        elif ev == "lg_shed":
            e["shed"] += 1
    summaries = [
        r for r in records
        if r.get("event") == "serve_summary" and "scenario" in r
    ]
    if summaries:
        # Per-tenant ITL quantiles exist only in the closing
        # summary: lg_token is ring-only by design, so the file's
        # lifecycle events cannot reconstruct them. Merge them in so
        # the regress gate sees per-tenant ITL too.
        for name, st in (summaries[-1].get("tenants") or {}).items():
            e = entry(name)
            for k in ("itl_ms_p50", "itl_ms_p95"):
                if k in st:
                    e[k] = st[k]
    for e in tenants.values():
        ttfts = sorted(e.pop("_ttfts"))
        e["ttft_ms_p50"] = quantile(ttfts, 0.50)
        e["ttft_ms_p95"] = quantile(ttfts, 0.95)
        e["ttft_ms_p99"] = quantile(ttfts, 0.99)
    decisions = {"shed": 0, "queue": 0}
    for r in admissions:
        decisions[r["action"]] = decisions.get(r["action"], 0) + 1
    # The closing serve_summary's loadgen extras (occupancy, SLO
    # verdicts) ride along when present.
    out: dict = {"tenants": tenants, "admission_decisions": decisions}
    if headers:
        out["scenario"] = headers[-1]["scenario"]
        out["seed"] = headers[-1]["seed"]
    if summaries:
        s = summaries[-1]
        for k in ("occupancy_mean", "occupancy_p95", "stall_events",
                  "slo_violations", "shed", "queued"):
            if k in s:
                out[k] = s[k]
    return out


def _fleet(records: Sequence[dict]) -> Optional[dict]:
    """Serving-fleet breakdown (serve/fleet.py): replica losses,
    redispatched requests, weight-swap outcomes and autoscale
    decisions from the fleet lifecycle events, plus the router's
    prefix-affinity outcome from the closing summary -- the
    robustness counters the regress gate's ``fleet.*`` namespace
    judges."""
    downs = [r for r in records if r.get("event") == "replica_down"]
    ups = [r for r in records if r.get("event") == "replica_up"]
    redispatches = [
        r for r in records if r.get("event") == "redispatch"
    ]
    swaps = [r for r in records if r.get("event") == "weight_swap"]
    scales = [r for r in records if r.get("event") == "fleet_scale"]
    summaries = [
        r for r in records
        if r.get("event") == "serve_summary" and "fleet" in r
    ]
    if not (downs or ups or redispatches or swaps or scales
            or summaries):
        return None
    out = {
        "replica_down": len(downs),
        "redispatched": len(redispatches),
        "restarts": sum(
            1 for r in ups if r["reason"] == "restart"
        ),
        "swapped_replicas": sum(
            1 for r in swaps if r["status"] == "swapped"
        ),
        "swap_rollbacks": sum(
            1 for r in swaps if r["status"] == "rolled_back"
        ),
        "scale_ups": sum(
            1 for r in scales if r["action"] == "grow"
        ),
        "scale_downs": sum(
            1 for r in scales if r["action"] == "shrink"
        ),
    }
    if summaries:
        f = summaries[-1]["fleet"]
        for k in ("replicas", "live_min", "live_max",
                  "prefix_affinity_hit_rate", "router",
                  "affinity_routes", "weights_version",
                  "mixed_weights"):
            if k in f:
                out[k] = f[k]
    return out


def _pipeline(records: Sequence[dict]) -> Optional[dict]:
    """MPMD pipeline breakdown (parallel/mpmd.py): per-stage
    up/down timeline, in-flight replays, bubble fraction and
    recovery MTTR -- the robustness counters the regress gate's
    ``pipeline.*`` namespace judges."""
    downs = [r for r in records if r.get("event") == "stage_down"]
    ups = [r for r in records if r.get("event") == "stage_up"]
    redispatches = [
        r for r in records if r.get("event") == "stage_redispatch"
    ]
    bubbles = [
        r for r in records if r.get("event") == "pipeline_bubble"
    ]
    if not (downs or ups or redispatches or bubbles):
        return None
    timeline: Dict[str, list] = {}
    for r in (*downs, *ups):
        entry = {
            "t": r.get("time"),
            "event": "down" if r["event"] == "stage_down" else "up",
            "reason": r["reason"],
        }
        if r["event"] == "stage_down" and "step" in r:
            entry["step"] = r["step"]
        timeline.setdefault(str(r["stage"]), []).append(entry)
    for entries in timeline.values():
        entries.sort(key=lambda e: (e["t"] is None, e["t"]))
    mttrs = [r["mttr_s"] for r in ups if "mttr_s" in r]
    stragglers = sorted({
        r["straggler_stage"] for r in bubbles
        if r.get("straggler_stage") is not None
    })
    return {
        "stage_down": len(downs),
        "redispatched": len(redispatches),
        "restarts": sum(1 for r in ups if r["reason"] == "restart"),
        "rollbacks": sum(
            1 for r in ups if r["reason"] == "rollback"
        ),
        "bubble_fraction": (
            sum(r["bubble_fraction"] for r in bubbles) / len(bubbles)
            if bubbles else None
        ),
        "recovery_mttr_s": (
            sum(mttrs) / len(mttrs) if mttrs else None
        ),
        "straggler_stages": stragglers,
        "stages": timeline,
    }


def _live(records: Sequence[dict]) -> Optional[dict]:
    """Live telemetry plane breakdown (obs/digest, obs/live, obs/slo):
    the fleet-rollup verdicts -- per-role straggler/stale flags, SLO
    attainment and error-budget remaining, burn-rate pages -- from
    the ``health_digest``/``digest_stale``/``slo_burn`` records in
    the log plus the closing summary's ``live`` block. The regress
    gate's ``live.*``/``slo.*`` namespaces judge exactly these."""
    digests = [
        r for r in records if r.get("event") == "health_digest"
    ]
    stales = [r for r in records if r.get("event") == "digest_stale"]
    burns = [r for r in records if r.get("event") == "slo_burn"]
    summaries = [
        r for r in records
        if r.get("event") == "serve_summary" and "live" in r
    ]
    if not (digests or stales or burns or summaries):
        return None
    out: dict = {
        "digests": len(digests),
        "digest_stale": len(stales),
        "stale_keys": sorted({
            f"{r['role']}:{r['key']}" for r in stales
        }),
        "slo_burns": len(burns),
        "stragglers": [],
    }
    if digests:
        # Re-derive the per-role rollup from the digests the log
        # holds -- same merge the live aggregator runs, so the
        # post-hoc report and the live scoreboard cannot disagree.
        from tpu_hpc_torch.obs.live import Rollup

        view = Rollup().ingest(digests).build()
        out["roles"] = {
            role: {
                "keys": sorted(block["keys"]),
                "stragglers": block["stragglers"],
                "stale": block["stale"],
                "counters": block["counters"],
            }
            for role, block in view["roles"].items()
        }
        out["stragglers"] = view["stragglers"]
    if burns:
        b = burns[-1]
        out["burn_fast"] = b["burn_fast"]
        out["burn_slow"] = b["burn_slow"]
        out["burn_trace_id"] = b.get("trace_id")
        if b.get("budget_remaining") is not None:
            out["budget_remaining"] = b["budget_remaining"]
    if summaries:
        lv = summaries[-1]["live"]
        for k in ("stragglers", "slo_attainment", "budget_remaining",
                  "slo_good", "slo_bad", "digests"):
            if lv.get(k) is not None:
                out[k] = lv[k]
        out["digest_stale"] = max(
            out["digest_stale"], lv.get("digest_stale", 0) or 0
        )
    return out


def _elastic(records: Sequence[dict]) -> Optional[dict]:
    """Topology-morph breakdown (the JAX package's tpu_hpc.elastic): the
    per-morph timeline plus the totals the regress gate's ``elastic.*``
    namespace judges -- morph count, wire bytes moved, quiesce-to-
    resume stall. MPMD stage-slice remaps (budget-free recoveries)
    ride along."""
    morphs = [
        r for r in records if r.get("event") == "topology_morph"
    ]
    remaps = [r for r in records if r.get("event") == "stage_remap"]
    if not morphs and not remaps:
        return None
    return {
        "morphs": len(morphs),
        "wire_bytes": sum(
            int(r.get("wire_bytes", 0)) for r in morphs
        ),
        "stall_s": round(
            sum(float(r.get("stall_s", 0.0)) for r in morphs), 6
        ),
        "stage_remaps": len(remaps),
        "timeline": [
            {
                "step": r["step"],
                "reason": r.get("reason"),
                "src_mesh": r["src_mesh"],
                "tgt_mesh": r["tgt_mesh"],
                "wire_bytes": r["wire_bytes"],
                "stall_s": r["stall_s"],
                "preserved_data_extent": r.get(
                    "preserved_data_extent"
                ),
            }
            for r in morphs
        ],
    }


def _guard(records: Sequence[dict]) -> Optional[dict]:
    """Numeric-health guard breakdown: verdict counts, skip count,
    and the rollback timeline with its goodput cost (steps re-trained
    plus poisoned batches skipped -- the price of each anomaly)."""
    verdicts = [
        r for r in records if r.get("event") == "guard_verdict"
    ]
    rollbacks = [
        r for r in records if r.get("event") == "guard_rollback"
    ]
    if not verdicts and not rollbacks:
        return None
    out = {
        "poisoned": sum(
            1 for v in verdicts if v["verdict"] == "poisoned"
        ),
        "spikes": sum(1 for v in verdicts if v["verdict"] == "spike"),
        "skipped": sum(
            1 for v in verdicts if v.get("action") == "skip"
        ),
        "rollbacks": [
            {
                "to_step": r["to_step"],
                "first_bad": r["first_bad"],
                "last_bad": r["last_bad"],
                "data_from": r["data_from"],
                "data_to": r["data_to"],
                "quarantined": r.get("quarantined") or [],
            }
            for r in rollbacks
        ],
        # Poisoned-window goodput loss, in optimizer steps: each
        # rollback re-trains [to_step, first_bad) and skips the
        # anomaly window itself -- all work the anomaly destroyed.
        "lost_steps": sum(
            r["last_bad"] + 1 - r["to_step"] for r in rollbacks
        ),
    }
    return out


def _memory(records: Sequence[dict]) -> Optional[dict]:
    """HBM high-water marks from ``device_memory`` events
    (profiling/profiler.device_memory_summary, also emitted by every
    anomaly capture): the max across records is the run's peak."""
    mems = [
        r for r in records if r.get("event") == "device_memory"
    ]
    if not mems:
        return None
    return {
        "snapshots": len(mems),
        "hbm_peak_bytes": max(r["hbm_peak_bytes"] for r in mems),
        "hbm_limit_bytes": max(
            (r["hbm_limit_bytes"] for r in mems
             if "hbm_limit_bytes" in r),
            default=None,
        ),
    }


def _ckpt(records: Sequence[dict]) -> Optional[dict]:
    """Checkpoint-health breakdown: restore fallbacks (each one a
    snapshot that silently failed to come back) and content-integrity
    verdicts."""
    fallbacks = [
        r for r in records if r.get("event") == "ckpt_fallback"
    ]
    integrity = [
        r for r in records if r.get("event") == "ckpt_integrity"
    ]
    if not fallbacks and not integrity:
        return None
    return {
        "fallbacks": len(fallbacks),
        "fallback_steps": [r["step"] for r in fallbacks],
        "quarantined": [
            r["quarantined"] for r in fallbacks if r.get("quarantined")
        ],
        "integrity_checks": len(integrity),
        "integrity_failures": sum(
            1 for r in integrity if r["verdict"] != "ok"
        ),
    }


def build_report(
    records: Sequence[dict],
    peak_flops_per_device: Optional[float] = None,
) -> dict:
    """Aggregate a record list into the report dict (the ``--json``
    output; ``format_report`` renders it for humans)."""
    run_starts = [r for r in records if r.get("event") == "run_start"]
    run_ends = [r for r in records if r.get("event") == "run_end"]
    stalls = [r for r in records if r.get("event") == "stall"]
    faults = [r for r in records if r.get("event") == "fault"]
    run_start = run_starts[-1] if run_starts else None
    return {
        # The --json contract: consumers (obs/regress.py, CI) key on
        # this stamp the same way record consumers do.
        "schema_version": SCHEMA_VERSION,
        "run_id": next(
            (r["run_id"] for r in records if "run_id" in r), None
        ),
        "n_records": len(records),
        "phases": _phase_breakdown(records),
        "goodput": _goodput(run_ends),
        "mfu": _mfu(records, run_start, peak_flops_per_device),
        "timeline": [
            {
                "attempt": r["attempt"],
                "resumed_from_step": r["resumed_from_step"],
                "end_step": r["step"],
                "disposition": (
                    "preempted (resumable snapshot)" if r["preempted"]
                    else "completed"
                ),
            }
            for r in run_ends
        ],
        "stalls": len(stalls),
        "faults": [
            {"kind": f["kind"], "step": f.get("step")} for f in faults
        ],
        "serve": _serve(records),
        "loadgen": _loadgen(records),
        "fleet": _fleet(records),
        "pipeline": _pipeline(records),
        "elastic": _elastic(records),
        "live": _live(records),
        "guard": _guard(records),
        "ckpt": _ckpt(records),
        "memory": _memory(records),
    }


def format_report(rep: dict) -> str:
    lines = [
        f"# tpu_hpc_torch run report -- run_id {rep['run_id'] or '(none)'} "
        f"({rep['n_records']} records)",
        "",
        "## Step-time breakdown (span events)",
        "",
        "| phase | total_s | share | spans |",
        "|---|---|---|---|",
    ]
    phases = rep["phases"]
    shown = set()
    for name in (*CANONICAL_PHASES, *sorted(phases)):
        if name in shown:
            continue
        shown.add(name)
        e = phases.get(name)
        if e is not None:
            lines.append(
                f"| {name} | {e['total_s']:.3f} | {e['share']:.1%} "
                f"| {e['count']} |"
            )
        else:
            note = _PHASE_NOTES.get(name, "not measured on this run")
            lines.append(f"| {name} | - | - | {note} |")
    lines.append("")
    gp = rep["goodput"]
    lines.append("## Goodput")
    lines.append("")
    if gp is None:
        lines.append("no run_end record (run died before closing, or "
                     "not a training log)")
    else:
        for a in gp["attempts"]:
            lines.append(
                f"- attempt {a['attempt']}: steps "
                f"{a['resumed_from_step']} -> {a['step']}, productive "
                f"{a['productive_s']:.2f}s / total {a['total_s']:.2f}s "
                f"= {a['goodput']:.1%} (ckpt {a['ckpt_s']:.2f}s, "
                f"restore {a['restore_s']:.2f}s, other "
                f"{a['other_s']:.2f}s)"
            )
        c = gp["combined"]
        lines.append(
            f"- **combined**: productive {c['productive_s']:.2f}s / "
            f"total {c['total_s']:.2f}s = **{c['goodput']:.1%} "
            "goodput**"
        )
    lines.append("")
    lines.append("## MFU")
    lines.append("")
    m = rep["mfu"]
    if m is None:
        lines.append(
            "unavailable: needs config.model_flops_per_item in the "
            "run_start record and a known device peak (or "
            "--peak-flops)"
        )
    else:
        lines.append(
            f"{m['mfu']:.1%} -- {m['items_per_s']:.1f} items/s x "
            f"{m['flops_per_item']:.3g} FLOPs/item over "
            f"{m['n_devices']} device(s) at "
            f"{m['peak_flops_per_device']:.3g} peak FLOP/s each"
        )
    lines.append("")
    lines.append("## Restart timeline")
    lines.append("")
    if not rep["timeline"]:
        lines.append("(no attempts recorded)")
    for t in rep["timeline"]:
        lines.append(
            f"- attempt {t['attempt']}: resumed from step "
            f"{t['resumed_from_step']}, ended at step {t['end_step']} "
            f"-- {t['disposition']}"
        )
    if rep["stalls"]:
        lines.append(f"- stall events flagged: {rep['stalls']}")
    for f in rep["faults"]:
        lines.append(
            f"- injected fault: {f['kind']} at step {f['step']}"
        )
    g = rep.get("guard")
    if g is not None:
        lines += [
            "",
            "## Numeric-health guard",
            "",
            f"- verdicts: {g['poisoned']} poisoned, {g['spikes']} "
            f"spike(s); {g['skipped']} update(s) skipped on-device",
        ]
        for r in g["rollbacks"]:
            lines.append(
                f"- ROLLBACK: anomaly steps [{r['first_bad']}, "
                f"{r['last_bad']}] -> resumed from last-good step "
                f"{r['to_step']}, data indices [{r['data_from']}, "
                f"{r['data_to']}] skipped"
                + (
                    f", quarantined snapshots {r['quarantined']}"
                    if r["quarantined"] else ""
                )
            )
        if g["rollbacks"]:
            lines.append(
                f"- poisoned-window goodput loss: {g['lost_steps']} "
                "optimizer step(s) re-trained or skipped"
            )
    mem = rep.get("memory")
    if mem is not None:
        lines += [
            "",
            "## Device memory",
            "",
            f"- HBM peak {mem['hbm_peak_bytes'] / 2**30:.2f} GiB "
            + (
                f"of {mem['hbm_limit_bytes'] / 2**30:.2f} GiB limit "
                if mem.get("hbm_limit_bytes") else ""
            )
            + f"({mem['snapshots']} snapshot(s))",
        ]
    ck = rep.get("ckpt")
    if ck is not None:
        lines += [
            "",
            "## Checkpoint health",
            "",
            f"- restore fallbacks: {ck['fallbacks']} "
            f"(steps {ck['fallback_steps']})",
            f"- integrity: {ck['integrity_failures']} failure(s) in "
            f"{ck['integrity_checks']} verified restore(s)",
        ]
        if ck["quarantined"]:
            lines.append(
                f"- quarantined: {', '.join(ck['quarantined'])}"
            )
    if rep["serve"] is not None:
        s = rep["serve"]
        lines += [
            "",
            "## Serving",
            "",
            f"- {s.get('tokens_per_s', 0):.1f} tokens/s "
            f"({s.get('tokens_per_s_per_chip', 0):.1f}/chip), "
            f"{s.get('requests')} requests",
            f"- TTFT p50/p95: {s.get('ttft_ms_p50', 0):.1f} / "
            f"{s.get('ttft_ms_p95', 0):.1f} ms; ITL p50/p95: "
            f"{s.get('itl_ms_p50', 0):.1f} / "
            f"{s.get('itl_ms_p95', 0):.1f} ms",
        ]
        if "serve_mfu" in s:
            lines.append(f"- serving MFU (2N forward accounting): "
                         f"{s['serve_mfu']:.1%}")
        if s.get("kv_layout") == "paged":
            blocks = s.get("kv_blocks", 0)
            free_min = s.get("kv_blocks_free_min", 0)
            occ_peak = (
                1.0 - free_min / max(1, blocks - 1)
            )
            lines.append(
                f"- paged KV cache: {blocks} pages x "
                f"{s.get('kv_block_size', 0)} tokens, peak occupancy "
                f"{occ_peak:.0%} (min {free_min} pages free); prefix "
                f"cache hit rate {s.get('prefix_hit_rate', 0.0):.0%} "
                f"({s.get('prefix_hit_blocks', 0)} pages reused, "
                f"{s.get('prefill_chunks', 0)} prefill chunks)"
            )
        if s.get("kv_host_blocks"):
            lines.append(
                f"- host KV tier: {s['kv_host_blocks']} host slots "
                f"({s.get('kv_host_used', 0)} used, "
                f"{s.get('kv_host_drops', 0)} drops); "
                f"{s.get('kv_spill_pages', 0)} pages spilled / "
                f"{s.get('kv_refill_pages', 0)} refilled "
                f"({s.get('kv_spill_wire_bytes', 0)} + "
                f"{s.get('kv_refill_wire_bytes', 0)} wire bytes), "
                f"hop p50/p95 {s.get('kv_hop_ms_p50', 0.0):.1f} / "
                f"{s.get('kv_hop_ms_p95', 0.0):.1f} ms "
                f"(inflight bound "
                f"{s.get('kv_host_inflight_bytes', 0)} B, "
                f"{s.get('kv_host_inflight_source', '?')})"
            )
        if s.get("spec_mode"):
            lines.append(
                f"- speculative decode ({s['spec_mode']}, "
                f"k={s.get('spec_k')}): acceptance "
                f"{s.get('acceptance_rate', 0.0):.0%} "
                f"({s.get('accepted', 0)}/{s.get('drafted', 0)} "
                f"drafts over {s.get('verify_steps', 0)} verify "
                f"steps), draft cost {s.get('draft_ms', 0.0):.1f} ms"
            )
    lg = rep.get("loadgen")
    if lg is not None:
        lines += [
            "",
            "## Load generator",
            "",
        ]
        if "scenario" in lg:
            lines.append(
                f"scenario `{lg['scenario']}` seed {lg['seed']}"
            )
            lines.append("")
        lines += [
            "| tenant | arrivals | admitted | queued | shed | "
            "finished | TTFT p50/p95/p99 (ms) |",
            "|---|---|---|---|---|---|---|",
        ]
        for name in sorted(lg["tenants"]):
            t = lg["tenants"][name]
            lines.append(
                f"| {name} | {t['arrivals']} | {t['admitted']} | "
                f"{t['queued']} | {t['shed']} | {t['finished']} | "
                f"{t['ttft_ms_p50']:.1f} / {t['ttft_ms_p95']:.1f} / "
                f"{t['ttft_ms_p99']:.1f} |"
            )
        dec = lg["admission_decisions"]
        lines.append("")
        lines.append(
            f"- admission decisions: {dec.get('shed', 0)} shed, "
            f"{dec.get('queue', 0)} saturated-queue ticks"
        )
        if "occupancy_mean" in lg:
            lines.append(
                f"- occupancy mean {lg['occupancy_mean']:.1%} / "
                f"p95 {lg.get('occupancy_p95', 0):.1%}; stall events "
                f"{lg.get('stall_events', 0)}"
            )
        if lg.get("slo_violations"):
            lines.append(
                "- SLO VIOLATED: " + ", ".join(lg["slo_violations"])
            )
    pl = rep.get("pipeline")
    if pl is not None:
        bub = pl.get("bubble_fraction")
        mttr = pl.get("recovery_mttr_s")
        lines += [
            "",
            "## MPMD pipeline",
            "",
            f"- stage failures: {pl['stage_down']} down "
            f"({pl['restarts']} restart(s), {pl['rollbacks']} "
            f"rollback(s)); {pl['redispatched']} in-flight "
            "microbatch(es) replayed",
            "- bubble fraction "
            + (f"{bub:.1%}" if bub is not None else "(not measured)")
            + "; recovery MTTR "
            + (f"{mttr:.2f}s" if mttr is not None else "n/a"),
        ]
        if pl["straggler_stages"]:
            lines.append(
                "- straggler stage(s) flagged: "
                + ", ".join(str(s) for s in pl["straggler_stages"])
            )
        for sid in sorted(pl["stages"], key=int):
            steps = " -> ".join(
                f"{e['event']}[{e['reason']}]"
                + (f"@step{e['step']}" if "step" in e else "")
                for e in pl["stages"][sid]
            )
            lines.append(f"- stage {sid} timeline: {steps}")
    el = rep.get("elastic")
    if el is not None:
        lines += [
            "",
            "## Topology morphs",
            "",
            f"- {el['morphs']} live transition(s), "
            f"{el['wire_bytes'] / 2**20:.2f} MiB over the wire, "
            f"{el['stall_s']:.3f}s total stall -- zero process "
            "restarts",
        ]
        for m in el["timeline"]:
            lines.append(
                f"- step {m['step']}: {m['src_mesh']} -> "
                f"{m['tgt_mesh']} ({m['reason']}), "
                f"{m['wire_bytes']} wire bytes in "
                f"{m['stall_s']:.3f}s"
                + (
                    "" if m.get("preserved_data_extent")
                    else " [data extent changed -- bit-exact "
                    "continuity given up]"
                )
            )
        if el["stage_remaps"]:
            lines.append(
                "- MPMD stage remaps (restart budget not burned): "
                f"{el['stage_remaps']}"
            )
    fl = rep.get("fleet")
    if fl is not None:
        lines += [
            "",
            "## Serving fleet",
            "",
            f"- replicas: {fl.get('replicas', '?')} "
            f"(live {fl.get('live_min', '?')}..{fl.get('live_max', '?')}); "
            f"router {fl.get('router', '?')}, prefix-affinity hit "
            f"rate {fl.get('prefix_affinity_hit_rate', 0.0):.0%}",
            f"- failures: {fl['replica_down']} replica(s) down, "
            f"{fl['redispatched']} request(s) redispatched, "
            f"{fl['restarts']} restart(s)",
            f"- weight swaps: {fl['swapped_replicas']} swapped, "
            f"{fl['swap_rollbacks']} rolled back (checksum)",
            f"- autoscale: {fl['scale_ups']} grow, "
            f"{fl['scale_downs']} shrink",
        ]
    lv = rep.get("live")
    if lv is not None:
        lines += [
            "",
            "## Fleet rollup (live telemetry plane)",
            "",
            f"- {lv['digests']} health digest(s) merged; "
            f"{lv['digest_stale']} publisher(s) went stale"
            + (
                f" ({', '.join(lv['stale_keys'])})"
                if lv.get("stale_keys") else ""
            ),
        ]
        if lv.get("roles"):
            lines += [
                "",
                "| role | keys | stragglers | stale |",
                "|---|---|---|---|",
            ]
            for role, block in sorted(lv["roles"].items()):
                lines.append(
                    f"| {role} | {len(block['keys'])} "
                    f"| {', '.join(block['stragglers']) or '-'} "
                    f"| {', '.join(block['stale']) or '-'} |"
                )
            lines.append("")
        if lv.get("stragglers"):
            lines.append(
                f"- stragglers vs peer median: "
                f"{', '.join(lv['stragglers'])}"
            )
        if lv.get("slo_attainment") is not None:
            budget = lv.get("budget_remaining")
            lines.append(
                f"- SLO attainment {lv['slo_attainment']:.4f}"
                + (
                    f"; error budget remaining {budget:.1%}"
                    if budget is not None else ""
                )
            )
        if lv["slo_burns"]:
            lines.append(
                f"- {lv['slo_burns']} burn-rate page(s): fast burn "
                f"{lv.get('burn_fast', '?')}x, slow burn "
                f"{lv.get('burn_slow', '?')}x"
                + (
                    f" (trace {lv['burn_trace_id']})"
                    if lv.get("burn_trace_id") else ""
                )
            )
        else:
            lines.append("- no burn-rate pages")
    return "\n".join(lines) + "\n"


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="tpu_hpc_torch.obs.report",
        description=__doc__.split("\n")[0],
    )
    ap.add_argument("path", help="run JSONL (metrics log, serve "
                    "trace, or flight-recorder dump)")
    ap.add_argument("--json", action="store_true",
                    help="emit the report as one JSON object")
    ap.add_argument(
        "--peak-flops", type=float, default=None,
        help="peak FLOP/s per device for MFU (overrides the "
        "device-kind spec table; required on CPU-sim runs)",
    )
    ap.add_argument(
        "--no-validate", action="store_true",
        help="skip schema validation (salvage partially-corrupt logs)",
    )
    args = ap.parse_args(argv)
    try:
        records = load_records(args.path, validate=not args.no_validate)
    except OSError as e:
        print(f"tpu_hpc_torch.obs.report: {e}", file=sys.stderr)
        return 2
    except SchemaError as e:
        print(f"tpu_hpc_torch.obs.report: schema error: {e}", file=sys.stderr)
        return 2
    if not records:
        print(
            f"tpu_hpc_torch.obs.report: {args.path} holds no records",
            file=sys.stderr,
        )
        return 2
    rep = build_report(records, peak_flops_per_device=args.peak_flops)
    if args.json:
        print(json.dumps(rep))
    else:
        print(format_report(rep), end="")
    return 0


if __name__ == "__main__":
    sys.exit(main())
