"""tpu_hpc_torch.obs -- the telemetry spine, ported.

The same schema-stamped JSONL discipline as the JAX package's
``tpu_hpc.obs``, so one consumer reads the records of both:

  schema.py    the record schema: required/optional fields per event
               kind, ``schema_version`` on every record, a validator.
  events.py    the structured event bus: JSONL sink + bounded in-memory
               flight-recorder ring.
  spans.py     nestable span timers (also open a
               ``torch.profiler.record_function`` range, so a torch
               profiler trace and the JSONL agree on where time went).
  registry.py  counters / gauges / histograms with JSONL snapshots and
               Prometheus text exposition.
  quantiles.py the one quantile estimator every latency number comes
               from.
  trace.py     end-to-end causal tracing: run_id-scoped trace
               contexts stamped into every span/event, the
               ``python -m tpu_hpc_torch.obs.trace`` critical-path
               analyzer (TTFT/step decomposition + Chrome-trace
               export), and AnomalyCapture (symptom -> one bounded
               torch.profiler window + flight dump, keyed by
               trace_id).
  digest.py    mergeable per-process health digests: cumulative
               counters + gauges + log-bucket histogram sketches,
               appended to per-process channels under
               $TPU_HPC_DIGEST_DIR.
  live.py      the fleet rollup over the digest channels: straggler
               and stale verdicts, ``python -m tpu_hpc_torch.obs.live``
               and the fleet-merged Prometheus textfile.
  stall.py     the step-time watermark: flags stragglers and stalls
               (a ``stall`` event) and enriches the heartbeat and the
               digest.
  report.py    ``python -m tpu_hpc_torch.obs.report run.jsonl``: goodput,
               MFU and the step-time breakdown of a run's JSONL.
  regress.py   ``python -m tpu_hpc_torch.obs.regress base.jsonl
               cand.jsonl``: the regression gate over report numbers.
  slo.py       the two-window error-budget burn-rate monitor the
               serving fleet feeds its rollup to.
  bank.py      ``python -m tpu_hpc_torch.obs.bank BENCH_r*.json`` --
               lifts the bench captures into the validated bench
               history JSONL for regress --bank.
"""
from tpu_hpc_torch.obs.digest import (  # noqa: F401
    ENV_DIGEST_DIR,
    DigestPublisher,
    LogBucketSketch,
    read_digest_dir,
)
from tpu_hpc_torch.obs.events import (  # noqa: F401
    ENV_EVENTS,
    ENV_FLIGHT_DIR,
    ENV_RUN_ID,
    EventBus,
    dump_flight,
    get_bus,
    set_bus,
)
from tpu_hpc_torch.obs.live import (  # noqa: F401
    ENV_FLEET_PROM_FILE,
    Rollup,
    format_scoreboard,
    rollup_from_dir,
    stale_entries,
    write_fleet_prometheus,
)
from tpu_hpc_torch.obs.quantiles import quantile, summarize  # noqa: F401
from tpu_hpc_torch.obs.registry import (  # noqa: F401
    ENV_PROM_FILE,
    MetricsRegistry,
    get_registry,
    set_registry,
)
from tpu_hpc_torch.obs.slo import BurnRateMonitor  # noqa: F401
from tpu_hpc_torch.obs.schema import (  # noqa: F401
    SCHEMA_VERSION,
    SchemaError,
    stamp,
    validate_file,
    validate_record,
)
from tpu_hpc_torch.obs.spans import emit_span, span  # noqa: F401
from tpu_hpc_torch.obs.stall import StallDetector  # noqa: F401

# trace.py exports are lazy (PEP 562): eagerly importing the module
# here would make ``python -m tpu_hpc_torch.obs.trace`` re-execute it
# under runpy with a sys.modules warning. ``from tpu_hpc_torch.obs
# import activate`` etc. still work -- module __getattr__ covers
# from-imports.
_TRACE_EXPORTS = (
    "AnomalyCapture",
    "TraceContext",
    "activate",
    "request_trace_id",
    "step_trace_id",
    "trace_id_for",
)


def __getattr__(name):
    if name in _TRACE_EXPORTS:
        from tpu_hpc_torch.obs import trace

        return getattr(trace, name)
    raise AttributeError(
        f"module {__name__!r} has no attribute {name!r}"
    )


__all__ = [
    "AnomalyCapture",
    "BurnRateMonitor",
    "DigestPublisher",
    "ENV_DIGEST_DIR",
    "ENV_EVENTS",
    "ENV_FLEET_PROM_FILE",
    "ENV_FLIGHT_DIR",
    "ENV_PROM_FILE",
    "ENV_RUN_ID",
    "EventBus",
    "LogBucketSketch",
    "MetricsRegistry",
    "Rollup",
    "SCHEMA_VERSION",
    "SchemaError",
    "StallDetector",
    "TraceContext",
    "activate",
    "dump_flight",
    "emit_span",
    "format_scoreboard",
    "get_bus",
    "get_registry",
    "quantile",
    "read_digest_dir",
    "request_trace_id",
    "rollup_from_dir",
    "set_bus",
    "set_registry",
    "span",
    "stale_entries",
    "stamp",
    "step_trace_id",
    "summarize",
    "trace_id_for",
    "validate_file",
    "validate_record",
    "write_fleet_prometheus",
]
