"""Serving metrics: TTFT, inter-token latency, tokens/s/chip.

The serving counterparts of train/metrics.ThroughputMeter, recorded in
the same JSONL discipline the Trainer uses (append-only, one ``event``
field per record) so one consumer reads both training and serving
artifacts. Latency quantiles are reported in milliseconds (the unit
operators alarm on); throughput is global and per-chip.

MFU for serving divides by the FORWARD-only 2N FLOPs/token estimate
(train/metrics.mfu(mode="inference")) -- the 6N training convention
would understate serving utilization 3x.

The time source is injectable (``clock``): the load generator
(tpu_hpc/loadgen) drives the meter on a VIRTUAL clock so a seeded
scenario replay yields bit-identical latency quantiles -- the
determinism the regress gate (obs/regress.py) stakes exit codes on.
Real serving keeps the default ``time.perf_counter``.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Optional

from tpu_hpc_torch.obs import get_bus, get_registry, request_trace_id
from tpu_hpc_torch.obs.quantiles import quantile as _quantile
from tpu_hpc_torch.train.metrics import mfu


@dataclasses.dataclass
class _Trace:
    t_submit: float               # entered the queue
    t_admit: Optional[float] = None  # got a slot (prefill started)
    t_first: Optional[float] = None
    token_times: List[float] = dataclasses.field(default_factory=list)
    t_done: Optional[float] = None


class ServeMeter:
    """Per-request latency traces + run-level throughput.

    Wire it into a ContinuousBatcher; call :meth:`summary` after the
    drain. ``metrics_path`` (optional) appends one JSONL record per
    finished request plus one ``serve_summary`` record -- the Trainer's
    run-log discipline applied to serving. ``clock`` (optional)
    replaces ``time.perf_counter`` as the monotonic time source.
    """

    def __init__(
        self,
        metrics_path: Optional[str] = None,
        clock: Optional[Callable[[], float]] = None,
    ):
        self.metrics_path = metrics_path
        self.clock = clock or time.perf_counter
        self.traces: Dict[str, _Trace] = {}
        # rid -> causal trace id (obs/trace.py): derived ONCE at
        # submission and stamped on every lifecycle record, so a
        # request's queue wait, prefill chunks and token cadence join
        # into one correlated timeline across sink and flight rings.
        self.trace_ids: Dict[str, str] = {}
        self.prefill_tokens = 0  # padded prompt tokens forwarded
        self.shed = 0            # requests dropped by admission control
        self._t0 = self.clock()
        # HELP text once at construction (the Engine.__init__
        # discipline) -- the finish path and the per-token ITL loop
        # must not re-describe under the registry lock per request.
        reg = get_registry()
        reg.describe("serve_requests_total",
                     "Requests finished by the serve engine")
        reg.describe("serve_tokens_total",
                     "Tokens generated (decode emissions)")
        reg.describe("serve_ttft_ms",
                     "Time to first token, submission to first "
                     "emission (ms)")
        reg.describe("serve_itl_ms", "Inter-token latency (ms)")

    # -- batcher callbacks --------------------------------------------
    def submitted(self, rid: str) -> None:
        self.traces[rid] = _Trace(t_submit=self.clock())
        self.trace_ids.setdefault(rid, request_trace_id(rid))

    def admitted(self, rid: str, prefill_tokens: int = 0) -> None:
        # TTFT is measured from SUBMISSION: an oversubscribed replay
        # must show its queue wait in the quantiles operators alarm
        # on, not hide it between submit and slot admission. Callers
        # that never signal submission (direct engine callers) still
        # get a trace anchored here.
        t = self.clock()
        trace = self.traces.get(rid)
        if trace is None:
            trace = self.traces[rid] = _Trace(t_submit=t)
        trace.t_admit = t
        # Prefill forwards this many (padded-bucket) tokens through
        # the model; serving MFU must count them -- the generated
        # token count alone would understate the FLOPs actually done
        # several-fold at long-prompt/short-output mixes.
        self.prefill_tokens += prefill_tokens

    def token(self, rid: str, first: bool = False) -> None:
        t = self.clock()
        trace = self.traces[rid]
        if first:
            trace.t_first = t
        trace.token_times.append(t)

    def finished(self, rid: str) -> None:
        trace = self.traces[rid]
        trace.t_done = self.clock()
        ttft_ms = 1e3 * (trace.t_first - trace.t_submit)
        self._append({
            "event": "request",
            "time": time.time(),
            "rid": rid,
            "trace_id": self.trace_ids.get(
                rid, request_trace_id(rid)
            ),
            "ttft_ms": ttft_ms,
            "queue_ms": 1e3 * (
                (trace.t_admit or trace.t_submit) - trace.t_submit
            ),
            "tokens": len(trace.token_times),
            "total_ms": 1e3 * (trace.t_done - trace.t_submit),
        })
        # The shared metrics namespace (obs/registry.py): serving
        # counters/latency live next to the training gauges, one
        # snapshot + one Prometheus exposition for both.
        reg = get_registry()
        reg.inc("serve_requests_total")
        reg.inc("serve_tokens_total", len(trace.token_times))
        reg.observe("serve_ttft_ms", ttft_ms)
        for a, b in zip(trace.token_times, trace.token_times[1:]):
            reg.observe("serve_itl_ms", 1e3 * (b - a))

    def request_shed(self, rid: str, reason: str = "") -> None:
        """Admission control dropped ``rid`` before it ever got a
        slot. Part of the required meter protocol -- the batcher
        calls it unconditionally (no hasattr duck-check), so a
        subclass that typos the override fails loudly instead of
        silently losing shed telemetry. The trace is removed so the
        latency quantiles describe only served requests; the shed
        count rides the summary (a gate that ignored shed load would
        reward shedding)."""
        self.traces.pop(rid, None)
        self.shed += 1

    # -- aggregation ---------------------------------------------------
    def summary(
        self,
        n_devices: int = 1,
        n_params: Optional[int] = None,
        peak_flops_per_device: Optional[float] = None,
    ) -> Dict[str, float]:
        """TTFT/ITL quantiles (ms), tokens/s (global and per chip --
        GENERATED tokens, the number operators provision against),
        and -- when ``n_params``+``peak_flops_per_device`` are given --
        serving MFU on the forward-only 2N estimate over ALL tokens
        the model forwarded (padded prefill + generated): utilization
        measures work done, not work delivered."""
        wall = self.clock() - self._t0
        ttfts = sorted(
            t.t_first - t.t_submit
            for t in self.traces.values() if t.t_first is not None
        )
        itls: List[float] = []
        total_tokens = 0
        for t in self.traces.values():
            total_tokens += len(t.token_times)
            itls.extend(
                b - a for a, b in zip(t.token_times, t.token_times[1:])
            )
        itls.sort()
        tokens_per_s = total_tokens / wall if wall > 0 else 0.0
        out = {
            "requests": len(self.traces),
            "tokens": total_tokens,
            "wall_s": wall,
            "tokens_per_s": tokens_per_s,
            "tokens_per_s_per_chip": tokens_per_s / n_devices,
            "ttft_ms_p50": 1e3 * _quantile(ttfts, 0.50),
            "ttft_ms_p95": 1e3 * _quantile(ttfts, 0.95),
            "ttft_ms_p99": 1e3 * _quantile(ttfts, 0.99),
            "itl_ms_p50": 1e3 * _quantile(itls, 0.50),
            "itl_ms_p95": 1e3 * _quantile(itls, 0.95),
            "itl_ms_p99": 1e3 * _quantile(itls, 0.99),
            "prefill_tokens": self.prefill_tokens,
        }
        if self.shed:
            out["shed"] = self.shed
        if n_params is not None and peak_flops_per_device:
            forwarded_per_s = (
                (total_tokens + self.prefill_tokens) / wall
                if wall > 0 else 0.0
            )
            out["serve_mfu"] = mfu(
                forwarded_per_s, n_params, n_devices,
                peak_flops_per_device, mode="inference",
            )
        return out

    def write_summary(self, summary: Dict) -> None:
        self._append({
            "event": "serve_summary", "time": time.time(), **summary
        })
        reg = get_registry()
        for key in ("tokens_per_s", "tokens_per_s_per_chip",
                    "serve_mfu"):
            if key in summary:
                reg.set_gauge(f"serve_{key}", summary[key])
        # Speculative-decode health on the scrape surface: a falling
        # acceptance rate is the first sign a draft went stale
        # against its target (serve/spec.py).
        if "acceptance_rate" in summary:
            reg.set_gauge(
                "serve_spec_acceptance_rate",
                summary["acceptance_rate"],
            )
        # Textfile-collector exposition (no-op unless
        # $TPU_HPC_PROM_FILE is set), now carrying the serving gauges.
        reg.write_prometheus()

    def _append(self, record: Dict) -> None:
        """Every record rides the obs bus: schema-stamped, into the
        flight-recorder ring on this host, and appended to
        ``metrics_path`` when one is configured -- the Trainer's
        ``_append_metrics`` discipline, shared."""
        get_bus().emit_record(record, sink=self.metrics_path)
