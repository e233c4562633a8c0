"""The one record schema every telemetry sink speaks.

Before this module, three subsystems emitted JSONL with three ad-hoc
shapes: the Trainer's run log (train/trainer.py), the serving meter
(serve/metrics.py), and bench.py's record lines. A consumer (the
goodput report, a dashboard, a CI job) had to know which producer
wrote which file. Now every record carries ``schema_version`` and an
``event`` kind with a declared field contract, and one validator
covers all of them -- the "structured events with a schema" discipline
the fleet-scale observability literature treats as table stakes
(arxiv 2510.20171's attribution pipelines start from exactly this).

Contract:

* every record is a flat-ish JSON object with ``schema_version``,
  ``event`` and ``time`` (wall clock, seconds);
* ``run_id`` / ``host`` / ``pid`` / ``attempt`` / ``step`` are common
  optional provenance fields (the event bus stamps the first three);
* each event kind declares required fields plus either a closed set of
  optional fields or ``open=True`` (kinds that carry user-named aux
  metrics -- eval records, serve summaries, bench rows);
* :func:`validate_record` / :func:`validate_file` fail loudly on an
  unknown kind, a missing required field, or (for closed kinds) an
  unknown field -- a producer drifting off-schema breaks a test, not
  a dashboard three weeks later.
"""
from __future__ import annotations

import dataclasses
import json
import time
from typing import Dict, Mapping, Tuple

SCHEMA_VERSION = 1

# Stamped on every record.
COMMON_REQUIRED: Tuple[str, ...] = ("schema_version", "event", "time")
# Provenance fields any record may carry. ``trace_id`` is the causal
# join key (obs/trace.py): "<run_id>:<kind>:<key>" ties a request's
# admit/prefill/token lifecycle (or a training step's phase spans)
# into one correlated record across every host's sink and flight
# ring. ``t_mono`` is a monotonic-clock timestamp (time.perf_counter)
# next to the wall-clock ``time``: cross-host trace merges order and
# measure on the monotonic clock (NTP skew cannot reorder a host
# against itself) and keep wall time for coarse alignment only.
COMMON_OPTIONAL: Tuple[str, ...] = (
    "run_id", "host", "pid", "attempt", "step", "seq",
    "trace_id", "t_mono",
)

# The canonical span-name table: every ``span(name)`` /
# ``emit_span(name)`` call site in the tree must use a name registered
# here (pinned by the tier-1 lint test in tests/test_trace.py), so
# span names cannot silently drift into an unbounded namespace as
# subsystems grow -- the report's phase table and the critical-path
# analyzer key on exactly these.
SPANS: Dict[str, str] = {
    "admit": "paged admission: page reservation + prefix-trie lookup "
             "(+ the disagg KV-plan warm)",
    "ckpt": "checkpoint save (sync or async dispatch)",
    "colocated_train_step": "loadgen colocation: a training step "
                            "stealing the chip from serving",
    "compute": "training forward/backward/update (fused chunk)",
    "data": "host-side batch generation (host-fed path only)",
    "decode": "one batched decode step (all slots)",
    "digest_publish": "health-digest build + append to the per-process "
                      "digest channel (obs/digest.py)",
    "elastic_reshard": "cross-topology restore reshard",
    "kv_transfer": "disagg prefill->decode KV hop",
    "morph": "live topology transition: quiesce -> reshard -> "
             "rebuild -> resume (tpu_hpc.elastic)",
    "prefill": "one prompt prefill forward (slab whole-prompt or one "
               "paged chunk)",
    "prefill_chunk": "scheduler-level per-request prefill advance "
                     "(meter-clock duration, trace-tagged)",
    "reshard": "bounded cross-sharding reshard execution",
    "restore": "checkpoint restore",
    "spec_draft": "speculative draft-model burst (k steps)",
    "spec_draft_prefill": "draft-model prompt prefill",
    "spec_verify": "speculative (k+1)-position verify forward",
    "warmup": "AOT executable-table warmup",
}


class SchemaError(ValueError):
    """A record violates the telemetry schema."""


@dataclasses.dataclass(frozen=True)
class EventSpec:
    """Field contract for one event kind. ``open=True`` permits extra
    fields (kinds that carry user-named metrics); closed kinds reject
    anything outside required+optional+common."""

    required: Tuple[str, ...]
    optional: Tuple[str, ...] = ()
    open: bool = False


EVENTS: Dict[str, EventSpec] = {
    # -- training run log (train/trainer.py) --
    "run_start": EventSpec((
        "start_step", "total_steps", "n_devices", "n_processes",
        "device_kind", "jax_version", "config",
    ), optional=("torch_version",)),
    "epoch": EventSpec(
        ("epoch", "step", "loss", "items_per_s",
         "items_per_s_per_device", "s_per_step"),
        optional=("grad_norm",),
    ),
    "eval": EventSpec(("step", "n_steps", "loss"), open=True),
    "run_end": EventSpec((
        "step", "preempted", "attempt", "resumed_from_step", "goodput",
    ), optional=("rolled_back",)),
    # -- the telemetry spine itself (obs/) --
    "span": EventSpec(
        ("name", "dur_s"),
        optional=("parent", "depth", "n", "tier", "slot"),
    ),
    "metrics": EventSpec(("metrics",)),
    "stall": EventSpec(("step", "step_s", "watermark_s", "ratio")),
    # -- causal tracing (obs/trace.py) --
    # One record per trace birth (a request entering the scheduler):
    # announces the trace_id every later lifecycle event/span will
    # carry, with both clocks so cross-host merges can anchor the
    # monotonic timeline against wall time.
    "trace_ctx": EventSpec(
        ("trace_id", "kind", "key"),
        optional=("t_wall", "tenant", "parent"),
    ),
    # Anomaly-triggered capture (obs/trace.py AnomalyCapture): the
    # symptom->evidence record -- what tripped, which trace_id it is
    # keyed to, and where the bounded profiler trace + flight dump
    # landed.
    "capture_triggered": EventSpec(
        ("reason",),
        optional=("n_steps", "profile_dir", "flight_path"),
    ),
    # Per-device HBM high-water marks (profiling/profiler.py
    # device_memory_summary) -- was logger-only; the report's memory
    # section and the regress gate read exactly this.
    "device_memory": EventSpec(
        ("hbm_peak_bytes",),
        optional=(
            "n_devices", "hbm_in_use_bytes", "hbm_limit_bytes",
            "per_device",
        ),
    ),
    "fault": EventSpec(("kind",)),
    "flight_dump": EventSpec(("reason", "n_events")),
    # -- serving (serve/metrics.py) --
    "request": EventSpec(
        ("rid", "ttft_ms", "queue_ms", "tokens", "total_ms"),
    ),
    "serve_summary": EventSpec(
        ("requests", "tokens", "wall_s", "tokens_per_s",
         "tokens_per_s_per_chip", "ttft_ms_p50", "ttft_ms_p95",
         "itl_ms_p50", "itl_ms_p95", "prefill_tokens"),
        open=True,
    ),
    # -- bench.py record lines (metric/value/unit + workload extras) --
    "bench": EventSpec(("metric", "value", "unit"), open=True),
    # -- load generator (tpu_hpc/loadgen): one event per request
    #    lifecycle edge, so the report and the regress gate can
    #    reconstruct queueing/shedding behavior per tenant class --
    "load_scenario": EventSpec(
        ("scenario", "seed", "n_requests"), open=True,
    ),
    "lg_arrival": EventSpec(
        ("rid", "tenant", "arrival_ms"),
        optional=("prompt_len", "max_new_tokens", "priority"),
    ),
    "lg_admit": EventSpec(
        ("rid", "tenant", "queue_ms"),
        optional=("prefill_tokens", "queued"),
    ),
    "lg_first_token": EventSpec(("rid", "tenant", "ttft_ms")),
    # Per-token cadence evidence; hot path, so producers usually emit
    # it ring-only (flight-recorder forensics) rather than to the sink.
    "lg_token": EventSpec(("rid",), optional=("itl_ms",)),
    "lg_finish": EventSpec(("rid", "tenant", "tokens", "total_ms")),
    "lg_shed": EventSpec(("rid", "tenant", "reason")),
    # -- admission-control decisions (serve/scheduler.py policy) --
    "admission": EventSpec(
        ("action", "occupancy"),
        optional=("rid", "tenant", "reason", "pending", "by_tenant"),
    ),
    # -- speculative decoding (serve/spec.py): one record per verify
    #    step with the accepted/drafted counts. Verify-step cadence
    #    is decode cadence, so producers emit it ring-only (the
    #    lg_token discipline); acceptance_rate/draft_ms aggregates
    #    ride the serve_summary instead. --
    "spec_step": EventSpec(
        ("accepted",),
        optional=("drafted", "slot", "rid", "n_valid"),
    ),
    # -- paged KV cache (serve/paging.py): page lifecycle edges --
    #    alloc/free/cow/prefix_hit. Page churn runs at admission
    #    cadence, so producers emit these ring-only (flight-recorder
    #    forensics, the lg_token discipline); the aggregate hit-rate/
    #    occupancy numbers ride the serve_summary instead. --
    "kv_block": EventSpec(
        ("action",),
        optional=("rid", "slot", "n", "block", "blocks", "reason"),
    ),
    # -- host-DRAM KV page tier (serve/tier.py): one record per
    #    bounded transfer group -- parked pages leaving HBM for host
    #    buffers (kv_spill) and host-resident chains prefetched back
    #    before a returning request seats (kv_refill). Spill/refill
    #    runs at admission cadence, so producers emit these ring-only
    #    (the kv_block discipline); the wire-byte and page aggregates
    #    ride the serve_summary instead. --
    "kv_spill": EventSpec(
        ("pages", "bytes"),
        optional=("reason", "host_free", "blocks"),
    ),
    "kv_refill": EventSpec(
        ("pages", "bytes"),
        optional=("reason", "host_free", "blocks"),
    ),
    # -- resharding engine (tpu_hpc/reshard): one record per executed
    #    plan, modeled wire/peak bytes next to measured moved bytes --
    "reshard_plan": EventSpec(
        ("steps", "bytes", "wire_bytes", "peak_inflight_bytes"),
        optional=(
            "chunked_steps", "max_inflight_bytes", "bound_met",
            "kinds", "label", "measured_bytes", "predicted_cost_ms",
            "inflight_source",
        ),
    ),
    # -- collective planner (comm/planner.py): one record per resolved
    #    comm_mode="auto" decision -- the chosen strategy, predicted
    #    cost, candidate table, and whether the numbers came from a
    #    measured cost table or the alpha-beta fallback --
    "comm_plan": EventSpec(
        ("op", "mode", "source"),
        optional=(
            "payload_bytes", "dtype", "bucket_bytes",
            "predicted_cost_ms", "fingerprint", "table", "candidates",
            "reason", "resolved_from",
        ),
    ),
    # -- elastic resume (ckpt.restore_latest cross-topology path) --
    "elastic_restore": EventSpec(
        ("from_step", "src_mesh", "tgt_mesh"),
        optional=("plan", "device_count"),
    ),
    # -- live topology morph (tpu_hpc.elastic coordinator): one record
    #    per completed in-place transition -- no process exited, no
    #    checkpoint was read; the report's elastic section and the
    #    regress gate's elastic.* namespace read exactly this --
    "topology_morph": EventSpec(
        ("step", "src_mesh", "tgt_mesh", "wire_bytes", "stall_s"),
        optional=(
            "reason", "plan", "n_devices_from", "n_devices_to",
            "morph_seq", "preserved_data_extent", "compiled_programs",
            "predicted_cost_s",
        ),
    ),
    # One MPMD stage remapped onto a surviving device after its slice
    # was reclaimed (parallel/mpmd.py): the restart budget is NOT
    # charged -- the device went away, the stage did nothing wrong.
    "stage_remap": EventSpec(
        ("stage", "reason"),
        optional=("from_device", "to_device", "restore_step"),
    ),
    # -- numeric-health guard (resilience/guard.py via the Trainer):
    #    one verdict per anomalous step, one rollback record per
    #    rollback-to-last-good -- the report's guard section and the
    #    regress gate's rollback/skip counters read exactly these --
    "guard_verdict": EventSpec(
        ("step", "verdict", "action"),
        optional=(
            "grad_norm", "update_norm", "loss_finite", "nonfinite",
            "watermark", "ratio", "data_index",
            # Stage-scoped verdicts (the MPMD runtime's per-stage
            # guard path): which stage's fault domain the anomaly
            # was contained to.
            "stage",
        ),
    ),
    "guard_rollback": EventSpec(
        ("to_step", "first_bad", "last_bad", "data_from", "data_to"),
        optional=("quarantined", "n_rollbacks", "reason", "stage"),
    ),
    # -- checkpoint integrity + restore fallback (ckpt/checkpoint.py):
    #    every restore-side checksum verdict, and every fall-back-to-
    #    older (previously only a logger warning -- a silent fallback
    #    is a robustness regression the gate must see) --
    "ckpt_integrity": EventSpec(
        ("step", "verdict"), optional=("checked", "mismatched"),
    ),
    "ckpt_fallback": EventSpec(
        ("step", "error"), optional=("quarantined",),
    ),
    # -- multi-replica serving fleet (serve/fleet.py): the failure-
    #    handling contract's evidence trail. Routing runs at request
    #    cadence, so producers emit fleet_route ring-only (the
    #    lg_token discipline); the lifecycle edges below are rare and
    #    land in the sink. --
    "fleet_route": EventSpec(
        ("rid", "replica"),
        optional=("tenant", "affinity", "reason"),
    ),
    # A replica left the serving set: heartbeat timeout (killed /
    # wedged), with its in-flight count and how many requests were
    # re-dispatched onto survivors.
    "replica_down": EventSpec(
        ("replica", "reason"),
        optional=("inflight", "redispatched", "last_beat_age_s"),
    ),
    # A replica (re)joined: bring-up, jittered-backoff restart after
    # death, or autoscale activation of a warm standby.
    "replica_up": EventSpec(
        ("replica", "reason"), optional=("weights_version",),
    ),
    # One in-flight request replayed onto a survivor from prompt +
    # committed tokens (seeded/greedy determinism makes the resumed
    # stream byte-identical to the no-failure run).
    "redispatch": EventSpec(
        ("rid", "from_replica", "to_replica"),
        optional=("committed", "tenant"),
    ),
    # Autoscaler decisions over the occupancy gauge + block-stall
    # watermark: grow (standby -> live), drain_start, shrink
    # (drained -> standby).
    "fleet_scale": EventSpec(
        ("action", "live"),
        optional=("replica", "occupancy", "reason"),
    ),
    # Live weight hot-swap lifecycle per replica: drain_start ->
    # swapped, or corrupt -> rolled_back when the content checksums
    # (ckpt/integrity.py) catch a bad artifact.
    "weight_swap": EventSpec(
        ("replica", "version", "status"),
        optional=("reason", "mismatched"),
    ),
    # -- MPMD pipeline runtime (parallel/mpmd.py): the per-stage
    #    fault-domain evidence trail -- a stage leaving/rejoining the
    #    pipeline, the in-flight microbatches replayed through a
    #    recovered stage, and the per-step bubble telemetry the
    #    report's pipeline section and the regress gate's pipeline.*
    #    namespace read. --
    # A stage left the pipeline: crash (killed worker),
    # heartbeat-timeout (wedged worker), or guard-poisoned
    # (non-finite output caught before any update committed it).
    "stage_down": EventSpec(
        ("stage", "reason"),
        optional=("microbatch", "inflight", "beat_age_s"),
    ),
    # A stage rejoined after stage-local recovery: fresh worker,
    # last-good snapshot restored (checksum-verified), healthy
    # stages untouched. ``reason`` is the budget class charged:
    # restart (crash/heartbeat) or rollback (guard-poisoned).
    "stage_up": EventSpec(
        ("stage", "reason"),
        optional=("restore_step", "mttr_s", "compile_count"),
    ),
    # One in-flight microbatch the dead stage held, replayed through
    # the recovered stage (the step re-executes from its start;
    # determinism makes the replayed stream bit-identical).
    "stage_redispatch": EventSpec(("stage", "microbatch")),
    # Per-step pipeline idle fraction on the runtime's virtual
    # clock, with cross-stage slow detection's verdict riding along.
    "pipeline_bubble": EventSpec(
        ("step", "bubble_fraction"),
        optional=("makespan_s", "straggler_stage"),
    ),
    # -- live telemetry plane (obs/digest.py, obs/live.py, obs/slo.py):
    #    the fleet-wide merge layer. One health_digest per publisher
    #    period -- cumulative counters, gauge snapshot, and mergeable
    #    log-bucket histogram sketches (bounded relative error), keyed
    #    by (role, key) so the aggregator can roll N replicas, S
    #    stages, and H hosts into one fleet view. ``t`` is the
    #    publisher's clock (virtual under the harnesses -- replays are
    #    bit-identical), ``seq`` dedups re-reads of the same channel. --
    "health_digest": EventSpec(
        ("role", "key", "t", "counters", "gauges", "hists"),
        optional=("step_s", "watermark_s", "period_s", "alpha"),
    ),
    # A publisher stopped publishing: the aggregator's first-class
    # "absence of telemetry is itself a signal" record -- a wedged or
    # dead process must not silently drop out of the rollup.
    "digest_stale": EventSpec(
        ("role", "key", "age_s"),
        optional=("stale_after_s", "last_t", "last_seq"),
    ),
    # Multi-window error-budget burn (obs/slo.py): emitted once when
    # BOTH the fast and slow windows burn past the threshold -- the
    # page-worthy condition, wired to AnomalyCapture for one
    # correlated evidence bundle.
    "slo_burn": EventSpec(
        ("burn_fast", "burn_slow", "threshold", "budget"),
        optional=(
            "fast_window_s", "slow_window_s", "error_rate_fast",
            "error_rate_slow", "good", "bad", "budget_remaining",
            "reason", "t",
        ),
    ),
    # -- supervisor attempt log (resilience/supervisor.py) --
    "attempt_start": EventSpec(("attempt", "cmd")),
    "attempt_end": EventSpec(
        ("attempt", "rc", "meaning", "reason", "duration_s", "log"),
    ),
    "restarting": EventSpec(
        ("next_attempt", "backoff_s"), optional=("why",),
    ),
    "giving_up": EventSpec(("attempt", "rc", "why")),
    "heartbeat_stall": EventSpec(("attempt", "timeout_s")),
    # Morph-channel accounting (supervisor): how many live topology
    # transitions the attempt completed -- with, by contract, ZERO
    # restart/preemption/rollback budget burned (nothing exited).
    "morphs_complete": EventSpec(
        ("attempt", "count"), optional=("budget_burned",),
    ),
}


def stamp(
    record: Mapping,
    *,
    run_id: str | None = None,
    host: str | None = None,
    pid: int | None = None,
) -> dict:
    """Return a copy of ``record`` with ``schema_version``/``time`` (and
    the provenance fields, when given) filled in -- existing values are
    never overwritten, so producers that already carry a wall-clock
    ``time`` keep it."""
    rec = dict(record)
    rec.setdefault("schema_version", SCHEMA_VERSION)
    rec.setdefault("time", time.time())
    if run_id is not None:
        rec.setdefault("run_id", run_id)
    if host is not None:
        rec.setdefault("host", host)
    if pid is not None:
        rec.setdefault("pid", pid)
    return rec


def validate_record(record) -> dict:
    """Validate one record against the schema; returns it unchanged.

    Raises :class:`SchemaError` on: non-dict input, a missing/wrong
    ``schema_version``, an unknown ``event`` kind, a missing required
    field, or -- for closed kinds -- an unknown field.
    """
    if not isinstance(record, dict):
        raise SchemaError(f"record is {type(record).__name__}, not an object")
    ver = record.get("schema_version")
    if ver != SCHEMA_VERSION:
        raise SchemaError(
            f"schema_version {ver!r} != {SCHEMA_VERSION} "
            f"(event {record.get('event')!r})"
        )
    event = record.get("event")
    spec = EVENTS.get(event)
    if spec is None:
        raise SchemaError(
            f"unknown event kind {event!r} "
            f"(known: {', '.join(sorted(EVENTS))})"
        )
    missing = [
        f for f in (*COMMON_REQUIRED, *spec.required) if f not in record
    ]
    if missing:
        raise SchemaError(f"event {event!r} missing required {missing}")
    if not spec.open:
        allowed = {
            *COMMON_REQUIRED, *COMMON_OPTIONAL,
            *spec.required, *spec.optional,
        }
        unknown = sorted(set(record) - allowed)
        if unknown:
            raise SchemaError(
                f"event {event!r} carries unknown fields {unknown} "
                "(closed kind; extend EventSpec.optional or mark open)"
            )
    return record


def load_records(path: str, validate: bool = True) -> list:
    """Parse (and by default schema-validate) a JSONL file, raising
    :class:`SchemaError` naming the first bad line. The ONE
    parse-and-validate loop -- the report and the validator must not
    drift in what they accept."""
    records = []
    with open(path) as f:
        for lineno, line in enumerate(f, start=1):
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
            except ValueError as e:
                raise SchemaError(
                    f"{path}:{lineno}: not JSON ({e})"
                ) from None
            if validate:
                try:
                    validate_record(rec)
                except SchemaError as e:
                    raise SchemaError(
                        f"{path}:{lineno}: {e}"
                    ) from None
            records.append(rec)
    return records


def validate_file(path: str) -> int:
    """Validate every JSONL record in ``path``; returns the record
    count."""
    return len(load_records(path, validate=True))
