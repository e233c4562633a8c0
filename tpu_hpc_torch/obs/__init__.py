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
  trace.py     run_id-scoped trace contexts stamped into every
               span/event.
  digest.py    the mergeable log-bucket sketch the registry feeds.
  stall.py     the step-time watermark: flags stragglers and stalls
               (a ``stall`` event) and enriches the heartbeat.

The rest of the JAX package's obs (live rollup, SLO burn rates, report,
regress, the trace analyzer and anomaly capture) is not ported yet;
ROADMAP lists it.
"""
from tpu_hpc_torch.obs.digest import LogBucketSketch  # noqa: F401
from tpu_hpc_torch.obs.events import (  # noqa: F401
    ENV_EVENTS,
    ENV_FLIGHT_DIR,
    ENV_RUN_ID,
    EventBus,
    dump_flight,
    get_bus,
    set_bus,
)
from tpu_hpc_torch.obs.quantiles import quantile, summarize  # noqa: F401
from tpu_hpc_torch.obs.registry import (  # noqa: F401
    ENV_PROM_FILE,
    MetricsRegistry,
    get_registry,
    set_registry,
)
from tpu_hpc_torch.obs.schema import (  # noqa: F401
    SCHEMA_VERSION,
    SchemaError,
    stamp,
    validate_file,
    validate_record,
)
from tpu_hpc_torch.obs.spans import emit_span, span  # noqa: F401
from tpu_hpc_torch.obs.stall import StallDetector  # noqa: F401
from tpu_hpc_torch.obs.trace import (  # noqa: F401
    TraceContext,
    activate,
    request_trace_id,
    step_trace_id,
    trace_id_for,
)

__all__ = [
    "ENV_EVENTS",
    "ENV_FLIGHT_DIR",
    "ENV_PROM_FILE",
    "ENV_RUN_ID",
    "EventBus",
    "LogBucketSketch",
    "MetricsRegistry",
    "SCHEMA_VERSION",
    "SchemaError",
    "StallDetector",
    "TraceContext",
    "activate",
    "dump_flight",
    "emit_span",
    "get_bus",
    "get_registry",
    "quantile",
    "request_trace_id",
    "set_bus",
    "set_registry",
    "span",
    "stamp",
    "step_trace_id",
    "summarize",
    "trace_id_for",
    "validate_file",
    "validate_record",
]
