"""``python -m tpu_hpc_torch.obs.regress baseline.jsonl candidate.jsonl`` --

Port of the JAX package's ``obs/regress.py``: framework-free, so copied
with its imports renamed to this package.
the perf-regression gate.

Every perf claim in this repo's history was a headline number, and the
BENCH_r01..r05 trajectory (46.3% -> 57.6% MFU with four bench
outages in between) shows how easily one number lies. This gate
replaces it: two schema-stamped run JSONLs (a training run log, a
serve replay trace, or a tpu_hpc_torch.loadgen run) are reduced through
``obs.report.build_report`` to their quantile metrics -- TTFT/ITL
p50/p95/p99, goodput, MFU, tokens/s, per-tenant loadgen quantiles,
shed counts, occupancy -- and diffed metric by metric against
per-metric tolerances. Exit is non-zero on ANY violated metric, named
with its quantile, so CI can gate a PR on measured distributions
instead of a headline (the DDP/FSDP characterization study's
discipline, arxiv 2505.12832).

Modes:

* default -- both files are run JSONLs; their reports are compared.
* ``--bank`` -- the baseline is a normalized bench-history JSONL
  (the JAX package's ``python -m tpu_hpc.obs.bank`` lifts the
  BENCH_r*.json bench captures into one), the candidate holds new
  ``bench`` records; each candidate metric (its LATEST record per
  metric -- the round under judgment, never masked by a better
  earlier row in the same file) is compared against the bank's best
  value for that metric (the trajectory's high-water mark, not
  whichever round happened to run last).

SLO config (``--slo slo.json``)::

    {"default_tol": 0.1,
     "metrics": {"serve.ttft_ms_p95": {"tol": 0.05, "max": 200.0},
                 "goodput":           {"min": 0.85}}}

``tol`` is the relative regression allowed vs baseline; ``max``/
``min`` are absolute bounds on the candidate alone (true SLOs -- they
fire even when the baseline was already out of bounds, and a bound on
a metric the candidate never produced is itself a violation: a typoed
name must not silently never fire).

Exit codes (pinned by tests): 0 = gate passes, 1 = regression or SLO
violation (each printed as ``REGRESSION: <metric> ...``), 2 = unusable
input (missing/empty/schema-invalid file, or no comparable metrics --
a gate with nothing to compare must fail loudly, not pass silently).
"""
from __future__ import annotations

import argparse
import json
import sys
from typing import Dict, List, Optional, Sequence, Tuple

from tpu_hpc_torch.obs.report import build_report
from tpu_hpc_torch.obs.schema import SCHEMA_VERSION, SchemaError, load_records

DEFAULT_TOL = 0.10

# Substrings marking a metric as lower-is-better; everything else
# (throughput, goodput, MFU, occupancy) regresses by going DOWN.
# "wire_bytes"/"inflight": reshard-cost metrics (comm/bench.py's
# reshard rows) -- more bytes over the wire or a higher transient peak
# is the regression, so the bank diff catches a plan that started
# moving or materializing more than its history.
# "rollback"/"fallback"/"poisoned"/"spike"/"skipped"/"lost_steps"/
# "integrity_fail": the robustness counters (resilience.guard +
# ckpt.integrity) -- more guard rollbacks, skipped updates, silent
# restore fallbacks or checksum failures IS the regression, so the
# --bank gate fails on robustness drift, not just perf.
# Paged-KV cache efficiency (serve/paging.py): "stall" already
# covers serve.block_stalls (admissions waiting on the page pool --
# more stalls means the cache got less efficient at the same
# traffic); the prefix-cache gains ride the default direction --
# "prefix_hit*" matches no token here, so a DROPPING hit rate is the
# regression (higher-is-better), which is how the --bank gate
# catches cache-efficiency drift.
# Speculative decoding (serve/spec.py): "rejected" lower-is-better
# (more rejected drafts at the same traffic = a worse draft source);
# "draft_ms" rides the "_ms" token (a costlier draft is the
# regression); "acceptance_rate"/"accepted" match NO token here, so
# they judge higher-is-better by absence -- a dropping acceptance
# rate fails the --bank gate exactly like a dropping prefix-hit
# rate. All four pinned in tests/test_regress.py so the speculative
# rows are judged, never skipped.
_LOWER_IS_BETTER = (
    "ttft", "itl", "_ms", "latency", "shed", "stall", "queued",
    "wire_bytes", "inflight", "rejected",
    "rollback", "fallback", "poisoned", "spike", "skipped",
    "lost_steps", "lost_requests", "integrity_fail", "nonfinite",
    # HBM high-water mark (the device_memory events): a higher peak
    # at the same workload is a memory regression -- the fit-check's
    # budget erodes before anything OOMs.
    "hbm_peak",
    # Serving-fleet robustness counters (serve/fleet.py): more
    # redispatched requests, more replicas lost, or more swap
    # rollbacks at the same chaos schedule means failure handling
    # got worse -- the --bank gate fails on fleet-robustness drift
    # like it does on guard/ckpt drift.
    # "fleet.prefix_affinity_hit_rate" deliberately matches NO token
    # here: like prefix_hit_rate and acceptance_rate it judges
    # higher-is-better by absence -- a router change that cools the
    # per-replica tries fails the gate.
    "redispatch", "replica_down", "swap",
    # MPMD pipeline robustness (parallel/mpmd.py): more stages lost,
    # a fatter bubble, or a slower stage recovery at the same chaos
    # schedule is the regression -- the --bank gate fails on
    # pipeline-robustness drift like it does on fleet/guard drift.
    # ("redispatch" above already covers the replayed-microbatch
    # counter; "bubble" covers bubble_fraction, "mttr" covers
    # recovery_mttr_s.)
    "stage_down", "bubble", "mttr",
    # Topology morphing (the JAX package's tpu_hpc.elastic): more
    # morphs at the same chaos schedule, more wire bytes per
    # transition, or a longer quiesce-to-resume stall is the
    # regression -- the --bank gate fails on elastic drift like it
    # does on pipeline/fleet drift.
    # ("wire_bytes" above already covers elastic.wire_bytes and the
    # morph_wire_bytes side key; "stall" covers elastic.stall_s;
    # "morph" covers the morph counters and the elastic_morph_*
    # headline rows.)
    "morph",
    # Host-DRAM KV tier (serve/tier.py): more pages crossing the
    # HBM/DRAM boundary at the same workload means the tier is
    # thrashing -- the --bank gate fails on spill/refill drift like
    # it does on morph drift. ("wire_bytes" above already covers the
    # kv_spill_wire_bytes / kv_refill_wire_bytes side keys; "ttft"
    # and "shed" cover ttft_on_return_ms_* and shed_on_return;
    # "resident_sessions" deliberately matches NO token -- like
    # prefix_hit_rate it judges higher-is-better by absence: a tier
    # change that sheds returning sessions fails the gate.)
    "spill", "refill",
    # Live telemetry plane (obs/digest, obs/live, obs/slo): more
    # burn-rate pages, more publishers going stale, or more flagged
    # stragglers at the same workload is a fleet-health regression;
    # "rel_err" covers the banked sketch quantile error bound -- a
    # sketch change that loosens the merge accuracy fails the gate.
    # ("slo_attainment" and "budget_remaining" deliberately match NO
    # token: higher-is-better by absence, like prefix_hit_rate.)
    "burn", "stale", "straggler", "rel_err",
    # Quantized KV pages (tpu_hpc_torch.kernels.paged_attention): the
    # banked logit_rmse side key pins the int8 quantizer's
    # pre-softmax score error -- a quantizer change that widens the
    # drift fails the gate even while the latency headline still
    # rides within tolerance. ("kv_kernel"/"kv_quant" are identity,
    # carried in the metric family name, never judged.)
    "rmse",
)


def lower_is_better(name: str) -> bool:
    # Direction comes from the LEAF segment only: composite names
    # ("<headline metric>.<side key>", "loadgen.<tenant>.<stat>")
    # must not inherit the parent's tokens -- a banked
    # "..._ttft_ms_p95.acceptance_rate" is an acceptance rate
    # (higher-is-better), not a latency, and judging it by the
    # headline's "ttft" would wave a collapsing draft source through
    # the gate.
    low = name.lower().rsplit(".", 1)[-1]
    return any(tok in low for tok in _LOWER_IS_BETTER)


# -- metric extraction -------------------------------------------------
def report_metrics(rep: dict) -> Dict[str, float]:
    """Flatten a build_report() dict into the comparable numeric
    metrics namespace."""
    flat: Dict[str, float] = {}
    gp = rep.get("goodput")
    if gp:
        flat["goodput"] = float(gp["combined"]["goodput"])
    m = rep.get("mfu")
    if m:
        flat["mfu"] = float(m["mfu"])
    for key, val in (rep.get("serve") or {}).items():
        # "requests" is workload size; kv_block_size/kv_blocks are
        # pool CONFIG and kv_blocks_free_min follows it -- identity,
        # not performance; diffing them would fail the gate on a
        # deliberate re-size. prefill_chunks and the raw hit COUNTS
        # are excluded too: an IMPROVED prefix cache shortens chunk
        # plans (fewer chunks = better), which the default
        # higher-is-better direction would flag as a regression --
        # prefix_hit_rate (normalized, higher-is-better) and
        # block_stalls (lower) are the two cache-efficiency signals
        # the gate judges.
        # Speculative rows follow the same split (serve/spec.py):
        # spec_k is config, drafted/accepted/rejected/verify_steps
        # are raw counts that scale with the workload (an IMPROVED
        # acceptance rate means FEWER verify steps for the same
        # tokens, which a naive direction would flag) --
        # acceptance_rate (higher-is-better by token absence) and
        # draft_ms (lower, via "_ms") are the two judged speculative
        # signals.
        # Host-tier rows split the same way (serve/tier.py):
        # kv_host_blocks / kv_host_inflight_bytes are pool CONFIG
        # and kv_host_used/free follow it; the kv_spills/kv_refills
        # EVENT counts and the pages they carried are raw counts a
        # bigger workload inflates -- the judged tier signals are
        # the wire bytes (lower via "wire_bytes") and the hop
        # quantiles (lower via "_ms").
        if isinstance(val, (int, float)) and key not in (
            "requests", "kv_block_size", "kv_blocks",
            "kv_blocks_free_min", "prefill_chunks",
            "prefix_hits", "prefix_hit_blocks",
            "spec_k", "drafted", "accepted", "rejected",
            "verify_steps",
            "kv_host_blocks", "kv_host_used", "kv_host_free",
            "kv_host_inflight_bytes", "kv_spills", "kv_refills",
            "kv_spill_pages", "kv_refill_pages", "kv_host_drops",
        ):
            flat[f"serve.{key}"] = float(val)
    lg = rep.get("loadgen")
    if lg:
        for name, t in lg["tenants"].items():
            for k in ("ttft_ms_p50", "ttft_ms_p95", "ttft_ms_p99",
                      "itl_ms_p50", "itl_ms_p95"):
                if k in t:
                    flat[f"loadgen.{name}.{k}"] = float(t[k])
            flat[f"loadgen.{name}.shed"] = float(t["shed"])
            flat[f"loadgen.{name}.queued"] = float(t["queued"])
        for k in ("occupancy_mean", "occupancy_p95", "stall_events",
                  "shed", "queued"):
            if k in lg:
                flat[f"loadgen.{k}"] = float(lg[k])
    fl = rep.get("fleet")
    if fl:
        # The robustness counters are the judged signals (all
        # lower-is-better via the redispatch/replica_down/swap
        # tokens) plus the router's affinity outcome (higher by
        # absence). replicas / live range / scale decisions are
        # CONFIG-cum-behavior identity -- a deliberate re-size or a
        # different autoscale schedule must not fail the gate by
        # itself; its latency consequences already do.
        flat["fleet.replica_down"] = float(fl["replica_down"])
        flat["fleet.redispatched"] = float(fl["redispatched"])
        flat["fleet.swap_rollbacks"] = float(fl["swap_rollbacks"])
        if "prefix_affinity_hit_rate" in fl:
            flat["fleet.prefix_affinity_hit_rate"] = float(
                fl["prefix_affinity_hit_rate"]
            )
    pl = rep.get("pipeline")
    if pl:
        # The judged pipeline signals: stage losses, replays, bubble
        # and recovery MTTR (all lower-is-better via the
        # stage_down/redispatch/bubble/mttr tokens). The per-stage
        # timeline and straggler list are identity/behavior detail
        # the latency consequences already cover.
        flat["pipeline.stage_down"] = float(pl["stage_down"])
        flat["pipeline.redispatched"] = float(pl["redispatched"])
        if pl.get("bubble_fraction") is not None:
            flat["pipeline.bubble_fraction"] = float(
                pl["bubble_fraction"]
            )
        if pl.get("recovery_mttr_s") is not None:
            flat["pipeline.recovery_mttr_s"] = float(
                pl["recovery_mttr_s"]
            )
    el = rep.get("elastic")
    if el:
        # The judged elastic signals: morph count, total wire bytes
        # moved and total quiesce-to-resume stall (all lower-is-better
        # via the morph/wire_bytes/stall tokens). The per-morph
        # timeline is identity detail the totals already cover.
        flat["elastic.morphs"] = float(el["morphs"])
        flat["elastic.wire_bytes"] = float(el["wire_bytes"])
        flat["elastic.stall_s"] = float(el["stall_s"])
    g = rep.get("guard")
    if g:
        flat["guard.poisoned"] = float(g["poisoned"])
        flat["guard.spikes"] = float(g["spikes"])
        flat["guard.skipped"] = float(g["skipped"])
        flat["guard.rollbacks"] = float(len(g["rollbacks"]))
        flat["guard.lost_steps"] = float(g["lost_steps"])
    ck = rep.get("ckpt")
    if ck:
        flat["ckpt.fallbacks"] = float(ck["fallbacks"])
        flat["ckpt.integrity_failures"] = float(
            ck["integrity_failures"]
        )
    mem = rep.get("memory")
    if mem:
        # The HBM high-water mark (lower-is-better via "hbm_peak"):
        # a run whose peak grew against baseline fails the gate even
        # while latency holds.
        flat["memory.hbm_peak_bytes"] = float(mem["hbm_peak_bytes"])
    lv = rep.get("live")
    if lv:
        # The judged live-plane signals: stale publishers (lower via
        # "stale"), flagged stragglers (lower via "straggler"),
        # burn-rate pages (lower via "burn"), and SLO attainment /
        # budget remaining (higher-is-better by token absence). The
        # digest count and per-role tables are workload-size /
        # identity detail the verdict counters already cover.
        flat["live.digest_stale"] = float(lv["digest_stale"])
        flat["live.stragglers"] = float(len(lv.get("stragglers", [])))
        flat["slo.burns"] = float(lv["slo_burns"])
        if lv.get("slo_attainment") is not None:
            flat["slo.slo_attainment"] = float(lv["slo_attainment"])
        if lv.get("budget_remaining") is not None:
            flat["slo.budget_remaining"] = float(
                lv["budget_remaining"]
            )
    return flat


# Side metrics banked alongside a record's headline value: the
# latency quantiles, MFU -- and the speculative acceptance rate
# (serve/spec.py), the MECHANISM metric: a draft source going stale
# must fail the --bank gate even while the latency outcome still
# rides within tolerance. Producers lift these to the record's top
# level (bench.serve_record / loadgen_record); sub-dict fields are
# deliberately not walked.
_BANKED_SIDE_KEYS = (
    "ttft_ms_p50", "ttft_ms_p95", "ttft_ms_p99",
    "itl_ms_p50", "itl_ms_p95", "itl_ms_p99", "mfu",
    "acceptance_rate",
    # Fleet rows (serve/fleet.py): the router's prefix-affinity
    # outcome is the MECHANISM metric next to the latency headline --
    # a routing change that destroys per-replica trie warmth must
    # fail --bank even while the diurnal quantiles still ride within
    # tolerance (higher-is-better by token absence, like
    # acceptance_rate) -- and the robustness counters ride as side
    # keys too (producers lift them to the record top level;
    # sub-dict fields are deliberately not walked), so a chaos
    # schedule that starts losing replicas, replaying more requests
    # or rolling back swaps fails the gate even at equal latency.
    "prefix_affinity_hit_rate",
    "redispatched", "replica_down", "swap_rollbacks",
    "lost_requests",
    # MPMD pipeline rows (bench.py --pp-runtime mpmd): the measured
    # bubble and the stage-recovery MTTR ride next to the
    # tokens-per-second headline (both lower-is-better via the
    # "bubble"/"mttr" tokens) -- a runtime change that fattens the
    # bubble or slows recovery fails --bank even while throughput
    # still rides within tolerance. (The SPMD pp_* rows carry an
    # ANALYTIC bubble_fraction; it is schedule-determined and
    # constant at equal config, so judging it is a no-op there.)
    "bubble_fraction", "recovery_mttr_s",
    # int8 KV rows (tpu_hpc_torch.kernels.paged_attention): the
    # deterministic quantizer-error pin rides next to the latency
    # headline (lower-is-better via the "rmse" token) -- see the
    # _LOWER_IS_BETTER note above.
    "logit_rmse",
    # Elastic rows (bench.py --workload elastic): the morph count and
    # total transition wire bytes ride next to the stall-seconds
    # headline (all lower-is-better via the "morph"/"wire_bytes"
    # tokens) -- a layout-policy change that starts moving more bytes
    # per transition fails --bank even while the stall headline still
    # rides within tolerance.
    "morphs", "morph_wire_bytes",
    # Host-tier rows (bench.py --serve-host-blocks, the
    # long_idle_sessions scenario): the returning-tenant latency
    # quantiles and shed count (lower via "ttft"/"shed"), the
    # resident-session count (higher by token absence), and the
    # cross-tier wire bytes (lower via "wire_bytes") all ride next
    # to the scenario's TTFT headline -- a tier change that sheds
    # returning sessions or starts thrashing pages across the
    # boundary fails --bank even while the headline holds.
    "ttft_on_return_ms_p50", "ttft_on_return_ms_p95",
    "shed_on_return", "resident_sessions",
    "kv_spill_wire_bytes", "kv_refill_wire_bytes",
)


def bank_metrics(
    records: Sequence[dict], keep: str = "best",
) -> Dict[str, float]:
    """Reduce a bench-record JSONL to one value per metric.

    ``keep="best"`` (the BASELINE side): max for higher-is-better,
    min for lower -- the trajectory's high-water mark.
    ``keep="latest"`` (the CANDIDATE side): the last record per
    metric in file order -- a candidate file holding several rounds
    must be judged by its newest measurement, or a regressed latest
    round hides behind any better earlier one (review finding).
    Failure rows (``value: null``) contribute nothing but are
    legitimate history."""
    if keep not in ("best", "latest"):
        raise ValueError(f"keep {keep!r} must be 'best' or 'latest'")
    out: Dict[str, float] = {}

    def consider(name: str, value) -> None:
        if not isinstance(value, (int, float)) or isinstance(
            value, bool
        ):
            return
        value = float(value)
        if keep == "latest" or name not in out:
            out[name] = value
        elif lower_is_better(name):
            out[name] = min(out[name], value)
        else:
            out[name] = max(out[name], value)

    for rec in records:
        if rec.get("event") != "bench":
            continue
        metric = rec.get("metric")
        if not metric:
            continue
        consider(metric, rec.get("value"))
        for k in _BANKED_SIDE_KEYS:
            if k in rec:
                consider(f"{metric}.{k}", rec[k])
    return out


# -- comparison --------------------------------------------------------
def load_slo(path: Optional[str]) -> dict:
    if path is None:
        return {}
    with open(path) as f:
        cfg = json.load(f)
    if not isinstance(cfg, dict):
        raise ValueError(f"{path}: SLO config must be a JSON object")
    return cfg


def compare(
    baseline: Dict[str, float],
    candidate: Dict[str, float],
    slo: Optional[dict] = None,
    tol: float = DEFAULT_TOL,
) -> Tuple[List[dict], int]:
    """Diff candidate against baseline; returns (violations, number of
    checks run). A metric present on only one side is skipped for the
    relative check (a new subsystem must not fail the gate for
    existing), but absolute SLO bounds apply to every candidate metric
    they name."""
    slo = slo or {}
    per_metric = slo.get("metrics", {})
    default_tol = float(slo.get("default_tol", tol))
    violations: List[dict] = []
    checked = 0
    for name in sorted(set(baseline) & set(candidate)):
        base, cand = baseline[name], candidate[name]
        m_tol = float(per_metric.get(name, {}).get("tol", default_tol))
        checked += 1
        if lower_is_better(name):
            limit = base * (1.0 + m_tol) + 1e-9
            bad = cand > limit
        else:
            limit = base * (1.0 - m_tol) - 1e-9
            bad = cand < limit
        if bad:
            violations.append({
                "metric": name,
                "kind": "regression",
                "baseline": base,
                "candidate": cand,
                "allowed": limit,
                "tol": m_tol,
                "direction": (
                    "lower" if lower_is_better(name) else "higher"
                ),
            })
    for name, bounds in per_metric.items():
        if name not in candidate:
            # An absolute bound on a metric the candidate never
            # produced is unverifiable -- a typoed name (or a config
            # pointed at the wrong run type) must fail the gate, not
            # silently never fire (review finding; same discipline as
            # parse_faults / TenantClass SLO-key validation).
            # tol-only entries are tolerance *modifiers* for the
            # relative pass and may legitimately cover metrics other
            # run types emit, so they skip quietly.
            if "max" in bounds or "min" in bounds:
                checked += 1
                violations.append({
                    "metric": name, "kind": "slo_missing",
                    "candidate": None,
                    "allowed": bounds.get("max", bounds.get("min")),
                })
            continue
        cand = candidate[name]
        # Every evaluated bound counts as a check, violated or not:
        # an SLO-only gate (no overlapping baseline metrics) whose
        # bounds all pass must exit 0, not "nothing to compare"
        # (review finding).
        if "max" in bounds:
            checked += 1
            if cand > float(bounds["max"]):
                violations.append({
                    "metric": name, "kind": "slo_max",
                    "candidate": cand,
                    "allowed": float(bounds["max"]),
                })
        if "min" in bounds:
            checked += 1
            if cand < float(bounds["min"]):
                violations.append({
                    "metric": name, "kind": "slo_min",
                    "candidate": cand,
                    "allowed": float(bounds["min"]),
                })
    return violations, checked


def _fmt_violation(v: dict) -> str:
    if v["kind"] == "regression":
        arrow = ">" if v["direction"] == "lower" else "<"
        return (
            f"REGRESSION: {v['metric']} {v['candidate']:.6g} {arrow} "
            f"allowed {v['allowed']:.6g} "
            f"(baseline {v['baseline']:.6g}, tol {v['tol']:.0%}, "
            f"{v['direction']}-is-better)"
        )
    if v["kind"] == "slo_missing":
        return (
            f"REGRESSION: {v['metric']} has an absolute SLO bound "
            "but the candidate produced no such metric (typoed name, "
            "or wrong run type for this SLO config?)"
        )
    bound = "max" if v["kind"] == "slo_max" else "min"
    return (
        f"REGRESSION: {v['metric']} {v['candidate']:.6g} violates "
        f"SLO {bound} {v['allowed']:.6g}"
    )


# -- CLI ---------------------------------------------------------------
def _metrics_from_file(
    path: str, bank: bool, keep: str = "best",
) -> Dict[str, float]:
    records = load_records(path, validate=True)
    if not records:
        raise SchemaError(f"{path} holds no records")
    if bank:
        return bank_metrics(records, keep=keep)
    return report_metrics(build_report(records))


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="tpu_hpc_torch.obs.regress",
        description=__doc__.split("\n")[0],
    )
    ap.add_argument("baseline", help="baseline run JSONL (or, with "
                    "--bank, the normalized bench-history JSONL)")
    ap.add_argument("candidate", help="candidate run JSONL (or, with "
                    "--bank, a JSONL of new bench records)")
    ap.add_argument(
        "--bank", action="store_true",
        help="bench-history mode: compare candidate bench records "
        "against the bank's best value per metric",
    )
    ap.add_argument(
        "--slo", type=str, default=None,
        help="per-metric SLO/tolerance config (JSON; see module doc)",
    )
    ap.add_argument(
        "--tol", type=float, default=DEFAULT_TOL,
        help="default relative regression tolerance "
        f"(default {DEFAULT_TOL:.0%}; --slo overrides per metric)",
    )
    ap.add_argument("--json", action="store_true",
                    help="emit the verdict as one JSON object")
    args = ap.parse_args(argv)
    try:
        slo = load_slo(args.slo)
        base = _metrics_from_file(args.baseline, args.bank)
        # Candidate side of --bank: latest per metric, NOT best --
        # the newest round is the one under judgment.
        cand = _metrics_from_file(
            args.candidate, args.bank, keep="latest"
        )
    except (OSError, ValueError, SchemaError) as e:
        # SchemaError subclasses ValueError; both are "bad input".
        print(f"tpu_hpc_torch.obs.regress: {e}", file=sys.stderr)
        if args.bank and "schema_version" in str(e):
            print(
                "hint: un-stamped bench rows (pre-schema history) "
                "must be lifted first: python -m tpu_hpc.obs.bank "
                "<file> -o lifted.jsonl",
                file=sys.stderr,
            )
        return 2
    violations, checked = compare(base, cand, slo=slo, tol=args.tol)
    if checked == 0:
        print(
            "tpu_hpc_torch.obs.regress: no comparable metrics between "
            f"{args.baseline} and {args.candidate} -- a gate with "
            "nothing to check must not pass",
            file=sys.stderr,
        )
        return 2
    if args.json:
        print(json.dumps({
            "schema_version": SCHEMA_VERSION,
            "checked": checked,
            "violations": violations,
            "pass": not violations,
        }))
    else:
        for v in violations:
            print(_fmt_violation(v))
        verdict = "FAIL" if violations else "PASS"
        print(
            f"regress: {verdict} -- {checked} metric(s) checked, "
            f"{len(violations)} violation(s)"
        )
    return 1 if violations else 0


if __name__ == "__main__":
    sys.exit(main())
