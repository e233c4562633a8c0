"""The load harness: drive the serve engine with a seeded scenario,
emit every request's lifecycle as schema-stamped ``obs`` records.

Port of the JAX package's ``loadgen/harness.py``. The virtual clock,
the cost model, the meter and the per-tenant SLO aggregation are the
JAX package's, so a scenario run on the port's engine gives the JAX
harness's summary. Anomaly-triggered capture (``capture=``, an
``obs.AnomalyCapture``): a stall-watermark trip files one bounded
profiler window over the next ticks plus a flight dump, keyed by the
tick's trace id; an SLO breach at summary time files the flight dump
and memory snapshot only.

Timing runs on a **virtual clock**: each engine call charges a modeled
cost (``decode_step_ms`` per decode tick, ``prefill_ms_per_token`` x
padded bucket per admission, plus the scenario's colocated-train
steals), so a seeded run's TTFT/ITL/goodput quantiles are a pure
function of (scenario, seed, engine shape) -- bit-identical on replay,
which is what lets obs/regress.py treat ANY diff as signal. The engine
calls themselves are real (real prefill/decode programs, real tokens);
only the clock is modeled. Wall-clock serving throughput remains
`python -m tpu_hpc_torch.serve`'s job -- this harness
measures *scheduling behavior* (queueing, admission, tenant isolation)
that machine noise would otherwise drown.

Fault injection (``TPU_HPC_LOADGEN_FAULTS``, the TPU_HPC_FAULTS
spelling): ``prefill_delay=1.5`` / ``decode_delay=2.0`` multiply the
modeled costs -- the injected-latency path the regress gate's CI smoke
proves itself against.

Lifecycle events (obs/schema.py): ``load_scenario`` header, then per
request ``lg_arrival`` -> ``lg_admit`` -> ``lg_first_token`` ->
``lg_token`` (ring-only: per-token cadence is flight-recorder
forensics, not sink volume) -> ``lg_finish``, or ``lg_shed`` when
admission control drops it; the scheduler's own ``admission`` events
land in the same sink. The ServeMeter rides along on the virtual
clock, so ``serve_summary`` -- and through it the obs.report quantile
machinery -- works on load runs for free.
"""
from __future__ import annotations

import os
from typing import Callable, Dict, List, Optional

from tpu_hpc_torch.obs import (
    AnomalyCapture,
    StallDetector,
    emit_span,
    get_bus,
    get_registry,
    request_trace_id,
    trace_id_for,
)
from tpu_hpc_torch.obs.quantiles import quantile
from tpu_hpc_torch.serve.metrics import ServeMeter
from tpu_hpc_torch.serve.scheduler import AdmissionPolicy, ContinuousBatcher
from tpu_hpc_torch.loadgen.scenarios import Scenario

ENV_FAULTS = "TPU_HPC_LOADGEN_FAULTS"

# Faults only the multi-replica fleet harness (serve/fleet.py) can
# inject: a single-engine LoadHarness has no replica to kill, slow
# down, or hand a corrupt weight swap. LoadHarness hard-rejects them
# (below) -- a fleet fault silently doing nothing on a single-engine
# run is exactly the vacuous-chaos-test failure this parser exists to
# prevent.
FLEET_FAULT_KEYS = ("replica_kill_at", "swap_corrupt", "slow_replica")


def _cost_multiplier(v: str) -> float:
    x = float(v)
    if x <= 0:
        raise ValueError(v)
    return x


def _fleet_tick(v: str) -> int:
    x = int(v)
    if x < 0:
        raise ValueError(v)
    return x


def _bool01(v: str) -> bool:
    x = int(v)
    if x not in (0, 1):
        raise ValueError(v)
    return bool(x)


def _slow_replica(v: str) -> "tuple[int, float]":
    idx, sep, factor = v.partition(":")
    if not sep:
        raise ValueError(v)
    i, f = int(idx), float(factor)
    if i < 0 or f <= 0:
        raise ValueError(v)
    return (i, f)


# key -> (cast, expected-type text) for the shared typed parser
# (resilience/faults.parse_kv_spec -- one loop, one error discipline
# for TPU_HPC_FAULTS and TPU_HPC_LOADGEN_FAULTS alike).
_FAULT_CASTS = {
    "prefill_delay": (
        _cost_multiplier, "a positive number (cost multiplier, > 0)",
    ),
    "decode_delay": (
        _cost_multiplier, "a positive number (cost multiplier, > 0)",
    ),
    "replica_kill_at": (
        _fleet_tick, "a non-negative integer (fleet tick index)",
    ),
    "swap_corrupt": (_bool01, "0 or 1"),
    "slow_replica": (
        _slow_replica,
        "'<replica>:<factor>' (non-negative int : factor > 0)",
    ),
}

FAULT_DEFAULTS: Dict[str, object] = {
    "prefill_delay": 1.0,
    "decode_delay": 1.0,
    "replica_kill_at": None,
    "swap_corrupt": False,
    "slow_replica": None,
}


def parse_faults(spec: Optional[str] = None) -> Dict[str, object]:
    """``"prefill_delay=1.5,replica_kill_at=40"`` -> fault dict over
    :data:`FAULT_DEFAULTS`. Unknown keys AND malformed values raise a
    typed error naming the key, the full spec and the expected type
    (resilience/faults.py's parse discipline, shared via
    ``parse_kv_spec``): a typoed fault silently injecting nothing
    would make the gate's failure proof vacuous."""
    from tpu_hpc_torch.resilience.faults import parse_kv_spec

    if spec is None:
        spec = os.environ.get(ENV_FAULTS, "")
    out: Dict[str, object] = dict(FAULT_DEFAULTS)
    out.update(parse_kv_spec(spec, ENV_FAULTS, _FAULT_CASTS))
    return out


def fleet_faults_set(faults: Dict[str, object]) -> "list[str]":
    """The fleet-only fault keys armed (non-default) in ``faults``.
    Identity checks, not ``in (None, False)``: ``replica_kill_at=0``
    is a legal armed value that compares equal to False, and
    treating it as unarmed would let a kill-at-tick-0 fault slip
    silently through the single-engine harness's guard."""
    return [
        k for k in FLEET_FAULT_KEYS
        if not (faults.get(k) is None or faults.get(k) is False)
    ]


class VirtualClock:
    """Monotonic seconds, advanced explicitly. Calling it returns the
    current time, so it drops in wherever ``time.perf_counter``
    goes."""

    def __init__(self, t0: float = 0.0):
        self._t = float(t0)

    def __call__(self) -> float:
        return self._t

    def advance(self, dt_s: float) -> None:
        if dt_s < 0:
            raise ValueError(f"cannot advance clock by {dt_s}")
        self._t += dt_s

    def jump_to(self, t_s: float) -> None:
        """Set the clock to an absolute time, BACKWARD jumps allowed.
        Single-timeline consumers never need this; the fleet harness
        (serve/fleet.py) multiplexes N per-replica timelines through
        one meter clock -- each replica tick rewinds the shared clock
        to that replica's local time, so concurrent replicas charge
        OVERLAPPING virtual intervals instead of serializing (adding
        a replica must reduce latency, not add its tick costs to the
        global clock). Per-request timestamps stay monotonic: a
        request lives on one replica's timeline at a time, and
        redispatch only ever moves it to a replica whose local time
        has already passed the detection timeout."""
        self._t = float(t_s)


# Modeled KV-traffic factors for the paged read paths
# (tpu_hpc_torch.kernels.paged_attention), relative to the gather/fp16
# baseline the cost model was calibrated against. The gather path
# materializes every slot's pages into a dense per-step copy before
# the attention (pool read + copy write + copy re-read, ~3 HBM
# passes over the context); the cuda kernels walk the block table
# in-kernel and touch each page once -- the JAX package's "pallas"
# route, with its factors, so both packages charge the same virtual
# time. int8 pages halve the bytes
# the pool read moves (the fp32 scale side array is noise); under
# gather the dense copy still moves at the activation dtype, so only
# the pool-read pass shrinks. The (gather, none) entry MUST stay
# exactly 1.0 -- the cost model was calibrated on that path, and the
# multiplier below is skipped at 1.0 so its virtual clock stays
# byte-identical to the JAX harness's.
_KV_TRAFFIC = {
    ("gather", "none"): 1.0,
    ("cuda", "none"): 1 / 3,
    ("gather", "int8"): 2 / 3,
    ("cuda", "int8"): 1 / 6,
}
# How much of each charge is KV-bandwidth: decode is famously
# KV-bound (one token of compute against the whole context's reads),
# prefill is compute-bound with KV writes a small slice.
_KV_DECODE_FRAC = 0.6
_KV_PREFILL_FRAC = 0.2


class _CostModelEngine:
    """Engine proxy: runs the real programs, charges modeled virtual
    time for each. Placed between batcher and engine so the meter's
    timestamps (taken inside the batcher, after each engine call
    returns) see prefill/decode costs without the batcher knowing
    about clocks.

    Paged engines (serve/paging.py) pass through transparently:
    ``prefill_step`` charges each CHUNK's padded tokens as they
    forward (so chunked prefill's TTFT/ITL interleaving shows up on
    the virtual clock exactly as it would on chips, and a prefix hit's
    skipped chunks cost nothing -- the hit is visible in the
    quantiles, not just the counters); everything else of the paged
    protocol (admit/release/validate_request/stats) delegates via
    ``__getattr__``."""

    def __init__(
        self,
        engine,
        clock: VirtualClock,
        decode_step_ms: float,
        prefill_ms_per_token: float,
        faults: Dict[str, float],
        draft_cost_frac: float = 0.15,
        hop_ms_per_page: float = 0.5,
    ):
        self._engine = engine
        self._clock = clock
        # Host-tier hop cost (serve/tier.py): each page spilled to or
        # refilled from host DRAM charges this much modeled time --
        # ~an order cheaper per token than prefill (a DMA, not a
        # forward pass), which is the whole tier thesis. Engines
        # without a tier never move pages, so legacy runs charge 0
        # and stay byte-identical.
        self._hop_s_per_page = hop_ms_per_page / 1e3
        self._decode_s = decode_step_ms / 1e3 * faults["decode_delay"]
        self._prefill_s_per_token = (
            prefill_ms_per_token / 1e3 * faults["prefill_delay"]
        )
        # Kernel/quant read-path discount (_KV_TRAFFIC above): paged
        # engines advertise kv_kernel/kv_quant (serve/paging.py);
        # slab engines have neither attribute and charge the
        # calibrated baseline untouched.
        traffic = _KV_TRAFFIC[(
            getattr(engine, "kv_kernel", "gather"),
            getattr(engine, "kv_quant", "none"),
        )]
        if traffic != 1.0:
            self._decode_s *= (
                (1 - _KV_DECODE_FRAC) + _KV_DECODE_FRAC * traffic
            )
            self._prefill_s_per_token *= (
                (1 - _KV_PREFILL_FRAC) + _KV_PREFILL_FRAC * traffic
            )
        # Speculative cost model (serve/spec.py): one verify step
        # charges ONE decode forward -- the whole premise is that a
        # (k+1)-token forward is latency-bound like a 1-token one --
        # plus, for draft-model speculation, k draft steps at
        # ``draft_cost_frac`` of a target step each (a ~10x smaller
        # draft is ~0.1-0.2x per step). Prompt-lookup drafting is
        # host-side and charges nothing. The draft's prefill charges
        # at the same fraction per forwarded token.
        self._draft_frac = draft_cost_frac
        self.draft_charged_s = 0.0
        # Cumulative prefill charge: the harness subtracts its
        # per-tick delta before feeding the stall detector -- an
        # admission tick is EXPECTED to be long (one 512-token bucket
        # costs ~16 decode ticks of modeled time), and letting it
        # trip the watermark would shed tenants on ordinary prefill
        # scheduling, not on stalls (review finding).
        self.prefill_charged_s = 0.0

    def __getattr__(self, name):
        # Cost-neutral surface (serve_cfg, the paged protocol's
        # release/validate_request, stats/occupancy reads) delegates;
        # only the compute calls below (and admit/prefetch_prompt,
        # which charge the host-tier hop) cost time.
        return getattr(self._engine, name)

    def _draft_forwarded(self) -> int:
        spec = getattr(self._engine, "spec", None)
        if spec is None or spec.draft is None:
            return 0
        return spec.draft.prefill_forwarded_total

    def _hop_pages(self) -> int:
        tier = getattr(self._engine, "host_tier", None)
        if tier is None:
            return 0
        return (
            tier.stats["kv_spill_pages"] + tier.stats["kv_refill_pages"]
        )

    def _charge_hop(self, pages_before: int) -> None:
        """Charge the tier pages moved since ``pages_before``. Folded
        into ``prefill_charged_s``: like a prefill chunk, a hop is
        EXPECTED admission-path work, and the stall detector must not
        shed tenants on it."""
        pages = self._hop_pages() - pages_before
        if pages > 0:
            cost = self._hop_s_per_page * pages
            self.prefill_charged_s += cost
            self._clock.advance(cost)

    def admit(self, *args, **kwargs):
        # A host-tier admit may spill parked pages to make room; the
        # charge must land even when admission then fails (the bytes
        # moved either way).
        before = self._hop_pages()
        try:
            return self._engine.admit(*args, **kwargs)
        finally:
            self._charge_hop(before)

    def prefetch_prompt(self, prompt):
        before = self._hop_pages()
        try:
            return self._engine.prefetch_prompt(prompt)
        finally:
            self._charge_hop(before)

    def prefill(self, idx: int, prompt: List[int]) -> int:
        out = self._engine.prefill(idx, prompt)
        bucket = self._engine.serve_cfg.bucket_for(len(prompt))
        cost = self._prefill_s_per_token * bucket
        self.prefill_charged_s += cost
        self._clock.advance(cost)
        return out

    def prefill_step(self, idx: int):
        before = self._engine.prefill_forwarded_total
        d_before = self._draft_forwarded()
        out = self._engine.prefill_step(idx)
        cost = self._prefill_s_per_token * (
            self._engine.prefill_forwarded_total - before
        )
        draft_cost = (
            self._prefill_s_per_token * self._draft_frac
            * (self._draft_forwarded() - d_before)
        )
        self.draft_charged_s += draft_cost
        self.prefill_charged_s += cost + draft_cost
        self._clock.advance(cost + draft_cost)
        return out

    def decode(self, tokens, positions, active=None):
        if active is not None:
            out = self._engine.decode(tokens, positions, active)
        else:
            out = self._engine.decode(tokens, positions)
        self._clock.advance(self._decode_s)
        return out

    def spec_decode(self, *args, **kwargs):
        out = self._engine.spec_decode(*args, **kwargs)
        spec = self._engine.spec
        cost = self._decode_s
        if spec.draft is not None:
            draft_cost = self._decode_s * self._draft_frac * spec.cfg.k
            self.draft_charged_s += draft_cost
            cost += draft_cost
        self._clock.advance(cost)
        return out


class LoadMeter(ServeMeter):
    """ServeMeter + the lg_* lifecycle events and per-tenant
    aggregation. ``tenant_of[rid]`` is filled by the harness at
    submission time."""

    def __init__(
        self,
        metrics_path: Optional[str] = None,
        clock: Optional[Callable[[], float]] = None,
    ):
        super().__init__(metrics_path=metrics_path, clock=clock)
        self.tenant_of: Dict[str, str] = {}
        self.ttft_ms: Dict[str, List[float]] = {}   # per tenant
        self.itl_ms: Dict[str, List[float]] = {}
        self.finished_by: Dict[str, int] = {}
        self.queued_by: Dict[str, int] = {}         # waited >= 1 tick
        self.shed_by: Dict[str, int] = {}
        # Set by the harness before each batcher tick: "queued" means
        # submitted BEFORE the tick that admitted it. queue_ms alone
        # cannot tell (an earlier slot's prefill charge advances the
        # shared clock between two same-tick admissions -- review
        # finding).
        self.tick_start_s = 0.0

    def _tenant(self, rid: str) -> str:
        return self.tenant_of.get(rid, "default")

    def admitted(self, rid: str, prefill_tokens: int = 0) -> None:
        super().admitted(rid, prefill_tokens=prefill_tokens)
        trace = self.traces[rid]
        queue_ms = 1e3 * (trace.t_admit - trace.t_submit)
        tenant = self._tenant(rid)
        queued = trace.t_submit < self.tick_start_s
        if queued:
            self.queued_by[tenant] = self.queued_by.get(tenant, 0) + 1
        get_bus().emit(
            "lg_admit", sink=self.metrics_path,
            rid=rid, trace_id=self.trace_ids.get(rid),
            tenant=tenant, queue_ms=queue_ms,
            prefill_tokens=prefill_tokens, queued=queued,
        )

    def token(self, rid: str, first: bool = False) -> None:
        super().token(rid, first=first)
        trace = self.traces[rid]
        tenant = self._tenant(rid)
        if first:
            ttft_ms = 1e3 * (trace.t_first - trace.t_submit)
            self.ttft_ms.setdefault(tenant, []).append(ttft_ms)
            get_bus().emit(
                "lg_first_token", sink=self.metrics_path,
                rid=rid, trace_id=self.trace_ids.get(rid),
                tenant=tenant, ttft_ms=ttft_ms,
            )
        else:
            itl = 1e3 * (trace.token_times[-1] - trace.token_times[-2])
            self.itl_ms.setdefault(tenant, []).append(itl)
            # Ring-only (no sink): per-token cadence at decode rate is
            # flight-recorder forensics, not per-run sink volume --
            # but it still carries the trace id, so a flight dump's
            # token cadence joins the request timeline.
            get_bus().emit(
                "lg_token", rid=rid,
                trace_id=self.trace_ids.get(rid), itl_ms=itl,
            )

    def finished(self, rid: str) -> None:
        trace = self.traces[rid]
        tenant = self._tenant(rid)
        super().finished(rid)
        self.finished_by[tenant] = self.finished_by.get(tenant, 0) + 1
        get_bus().emit(
            "lg_finish", sink=self.metrics_path,
            rid=rid, trace_id=self.trace_ids.get(rid),
            tenant=tenant, tokens=len(trace.token_times),
            total_ms=1e3 * (trace.t_done - trace.t_submit),
        )

    def request_shed(self, rid: str, reason: str = "") -> None:
        tenant = self._tenant(rid)
        super().request_shed(rid, reason=reason)
        self.shed_by[tenant] = self.shed_by.get(tenant, 0) + 1
        get_bus().emit(
            "lg_shed", sink=self.metrics_path,
            rid=rid,
            trace_id=self.trace_ids.get(rid, request_trace_id(rid)),
            tenant=tenant, reason=reason,
        )


def tenant_summary(
    scenario: Scenario,
    meter: "LoadMeter",
    spec_by_tenant: Optional[Dict[str, Dict[str, int]]] = None,
):
    """Per-tenant quantiles, lifecycle counts and SLO verdicts from a
    LoadMeter -- ``(tenants, slo_violations, violated_tenants)``. One
    aggregation for the single-engine LoadHarness and the fleet
    harness (serve/fleet.py): the SLO verdict logic must not fork.

    ``violated_tenants`` keeps the violating tenant NAMES next to the
    composite ``"<tenant>.<metric>"`` strings -- consumers (the
    capture trigger) must not re-parse the composites (a tenant name
    containing '.' would truncate)."""
    spec_by_tenant = spec_by_tenant or {}
    tenants = {}
    slo_violations: List[str] = []
    violated_tenants: List[str] = []
    for t in scenario.tenants:
        ttfts = sorted(meter.ttft_ms.get(t.name, []))
        itls = sorted(meter.itl_ms.get(t.name, []))
        entry = {
            "priority": t.priority,
            "finished": meter.finished_by.get(t.name, 0),
            "shed": meter.shed_by.get(t.name, 0),
            "queued": meter.queued_by.get(t.name, 0),
            "ttft_ms_p50": quantile(ttfts, 0.50),
            "ttft_ms_p95": quantile(ttfts, 0.95),
            "ttft_ms_p99": quantile(ttfts, 0.99),
            "itl_ms_p50": quantile(itls, 0.50),
            "itl_ms_p95": quantile(itls, 0.95),
        }
        st = spec_by_tenant.get(t.name)
        if st is not None:
            # Per-request-class acceptance evidence: the banked
            # rows report acceptance per scenario AND per tenant.
            entry["spec_drafted"] = st["drafted"]
            entry["spec_accepted"] = st["accepted"]
            entry["acceptance_rate"] = (
                st["accepted"] / st["drafted"]
                if st["drafted"] else 0.0
            )
        if t.slo:
            # entry[k], not .get(): TenantClass validated the SLO
            # keys against SLO_METRICS, and a drift between that
            # set and what summarize produces must crash, not
            # silently never-violate.
            violated = sorted(
                k for k, bound in t.slo.items()
                if entry[k] > bound
            )
            entry["slo"] = dict(t.slo)
            entry["slo_violated"] = violated
            slo_violations += [f"{t.name}.{k}" for k in violated]
            if violated:
                violated_tenants.append(t.name)
        tenants[t.name] = entry
    return tenants, slo_violations, violated_tenants


class LoadHarness:
    """One scenario end to end: submit arrivals on schedule, tick the
    batcher, watch the stall watermark, aggregate per-tenant SLOs."""

    def __init__(
        self,
        engine,
        scenario: Scenario,
        metrics_path: Optional[str] = None,
        decode_step_ms: float = 8.0,
        prefill_ms_per_token: float = 0.25,
        policy: Optional[AdmissionPolicy] = None,
        stall_factor: float = 3.0,
        faults: Optional[Dict[str, float]] = None,
        capture: Optional[AnomalyCapture] = None,
        hop_ms_per_page: float = 0.5,
    ):
        self.scenario = scenario
        self.metrics_path = metrics_path
        self.clock = VirtualClock()
        # Anomaly-triggered capture (obs/trace.py): a stall-watermark
        # trip or an SLO breach fires ONE bounded profiler trace +
        # flight dump keyed by the triggering trace id. None = off.
        self.capture = capture
        faults = faults if faults is not None else parse_faults()
        armed = fleet_faults_set(faults)
        if armed:
            # A fleet fault on a single-engine harness has no replica
            # to kill/slow/corrupt -- silently ignoring it would make
            # the chaos test it belongs to pass vacuously (the
            # unknown-key discipline, applied to misplaced keys).
            raise ValueError(
                f"fleet fault(s) {armed} need the fleet harness "
                "(serve/fleet.FleetHarness); LoadHarness drives one "
                "engine and cannot inject them"
            )
        self.engine = _CostModelEngine(
            engine, self.clock, decode_step_ms, prefill_ms_per_token,
            faults, hop_ms_per_page=hop_ms_per_page,
        )
        self.meter = LoadMeter(metrics_path=metrics_path,
                               clock=self.clock)
        self.detector = StallDetector(
            window=16, factor=stall_factor, min_samples=5,
        )
        self._stalled = False
        self.batcher = ContinuousBatcher(
            self.engine,
            meter=self.meter,
            policy=policy or AdmissionPolicy(
                queue_limit=scenario.queue_limit
            ),
            stall_signal=lambda: self._stalled,
        )
        self._occupancy: List[float] = []

    # -- the drive loop -----------------------------------------------
    def run(
        self,
        n_devices: int = 1,
        n_params: Optional[int] = None,
        peak_flops_per_device: Optional[float] = None,
        max_ticks: Optional[int] = None,
        tick_cb=None,
        extra: Optional[dict] = None,
    ) -> dict:
        """drive() then summarize() -- the one-call convenience."""
        self.drive(max_ticks=max_ticks, tick_cb=tick_cb)
        return self.summarize(
            n_devices=n_devices, n_params=n_params,
            peak_flops_per_device=peak_flops_per_device, extra=extra,
        )

    def _submit_arrival(self, lr) -> None:
        self.meter.tenant_of[lr.rid] = lr.tenant
        get_bus().emit(
            "lg_arrival", sink=self.metrics_path,
            rid=lr.rid, trace_id=request_trace_id(lr.rid),
            tenant=lr.tenant,
            arrival_ms=lr.arrival_ms,
            prompt_len=len(lr.prompt),
            max_new_tokens=lr.max_new_tokens,
            priority=lr.priority,
        )
        self.batcher.submit(lr.to_request())

    def drive(
        self, max_ticks: Optional[int] = None, tick_cb=None,
    ) -> None:
        sc = self.scenario
        bus = get_bus()
        bus.emit("load_scenario", sink=self.metrics_path, **sc.header())
        arrivals = list(sc.requests)  # already arrival-sorted
        if max_ticks is not None:
            budget = max_ticks
        else:
            budget = (
                sum(r.max_new_tokens + 1 for r in arrivals)
                + len(arrivals) + 16
            )
            if getattr(self.engine, "is_paged", False):
                from tpu_hpc_torch.serve.scheduler import paged_drain_bound

                budget += paged_drain_bound(self.engine, arrivals)
        try:
            self._drive_loop(arrivals, budget, tick_cb)
        finally:
            if self.capture is not None:
                # A capture window still open when the drive ends (or
                # aborts on the budget) must not leak its profiler
                # trace.
                self.capture.close()

    def _drive_loop(self, arrivals, budget, tick_cb) -> None:
        sc = self.scenario
        i = 0
        tick = 0
        while i < len(arrivals) or not self.batcher.done:
            # A request is "queued" iff it was submitted before this
            # iteration began -- stamp the boundary BEFORE this
            # tick's submissions (and before any colocation advance,
            # which would otherwise age same-tick arrivals).
            self.meter.tick_start_s = self.clock()
            now_ms = self.clock() * 1e3
            while i < len(arrivals) and arrivals[i].arrival_ms <= now_ms:
                self._submit_arrival(arrivals[i])
                i += 1
            if self.batcher.done:
                # Idle: jump the virtual clock to the next arrival
                # instead of spinning empty decode ticks -- and
                # submit it DIRECTLY: the ms->s->ms float round trip
                # can land the clock a hair short of arrival_ms, and
                # re-testing the due-predicate on that value would
                # advance(0) forever (review finding: a reproducible
                # livelock on ~0.7% of uniform arrival times).
                lr = arrivals[i]
                self.clock.advance(
                    max(lr.arrival_ms / 1e3 - self.clock(), 0.0)
                )
                self._submit_arrival(lr)
                i += 1
                continue
            if tick >= budget:
                raise RuntimeError(
                    f"load harness did not drain within {budget} ticks"
                )
            t_before = self.clock()
            if (
                sc.colocate_every > 0
                and tick % sc.colocate_every == 0
            ):
                # The colocated training job steals the chip for one
                # step; span events make the theft attributable in the
                # report's phase table. emit_span with the VIRTUAL
                # duration (a wall-clock span here would leak machine
                # noise into an otherwise deterministic run).
                self.clock.advance(sc.colocate_train_ms / 1e3)
                emit_span(
                    "colocated_train_step",
                    sc.colocate_train_ms / 1e3,
                    sink=self.metrics_path, step=tick,
                )
            prefill_before = self.engine.prefill_charged_s
            decode_before = self.batcher.stats["decode_steps"]
            self.batcher.step()
            # The watermark watches decode cadence + colocation
            # steals; this tick's prefill admission charges are
            # excluded (expected work, not a stall -- see
            # _CostModelEngine.prefill_charged_s).
            tick_s = (
                self.clock() - t_before
                - (self.engine.prefill_charged_s - prefill_before)
            )
            if self.batcher.stats["decode_steps"] > decode_before:
                tick_tid = trace_id_for("tick", tick)
                info = self.detector.observe(
                    tick, tick_s, sink=self.metrics_path,
                    trace_id=tick_tid,
                )
                self._stalled = info is not None
                if self._stalled and self.capture is not None:
                    # Symptom -> evidence, keyed by the tick trace
                    # that breached the watermark. One-shot: a stall
                    # storm yields one clean bundle.
                    self.capture.trigger(
                        "stall", trace_id=tick_tid, step=tick,
                        sink=self.metrics_path,
                    )
            else:
                # A tick with NO decode step (chunked prefill still
                # filling every active slot, or an admission-only
                # tick) has no cadence to measure: feeding its zero
                # to the window would drag the median watermark to 0
                # -- and LEAVING the previous verdict standing would
                # let admission keep shedding on a stall that is
                # already over. The verdict describes the last decode
                # tick only; clear it.
                self._stalled = False
            self._occupancy.append(self.batcher.occupancy)
            if self.capture is not None:
                # Advance (and eventually close) the bounded capture
                # window on the tick axis.
                self.capture.step(tick)
            if tick_cb is not None:
                tick_cb(tick)
            tick += 1

    # -- aggregation ---------------------------------------------------
    def summarize(
        self,
        n_devices: int = 1,
        n_params: Optional[int] = None,
        peak_flops_per_device: Optional[float] = None,
        extra: Optional[dict] = None,
    ) -> dict:
        summary = self.meter.summary(
            n_devices=n_devices, n_params=n_params,
            peak_flops_per_device=peak_flops_per_device,
        )
        m = self.meter
        tenants, slo_violations, violated_tenants = tenant_summary(
            self.scenario, m, self.batcher.spec_by_tenant
        )
        occ = sorted(self._occupancy)
        # The cache layout is part of the run's identity (a paged
        # quantile must never be diffed against a slab one unlabeled);
        # paged engines contribute their hit-rate/pool evidence.
        paged_summary = getattr(self.engine, "paged_summary", None)
        if callable(paged_summary):
            summary.update(paged_summary())
        else:
            summary["kv_layout"] = "slab"
        spec = getattr(self.engine, "spec", None)
        if spec is not None:
            spec_block = spec.spec_summary()
            # The runner's draft_ms is WALL time -- machine noise a
            # byte-identical virtual-clock summary must not carry.
            # Substitute the cost model's modeled charge (a pure
            # function of scenario, seed and the draft fraction).
            spec_block["draft_ms"] = round(
                self.engine.draft_charged_s * 1e3, 3
            )
            summary.update(spec_block)
        summary.update(
            scenario=self.scenario.name,
            seed=self.scenario.seed,
            n_arrivals=len(self.scenario.requests),
            tenants=tenants,
            shed=self.batcher.stats["shed"],
            queued=sum(m.queued_by.values()),
            slo_violations=slo_violations,
            occupancy_mean=(
                sum(occ) / len(occ) if occ else 0.0
            ),
            occupancy_p95=quantile(occ, 0.95),
            stall_events=self.detector.stalls,
            decode_steps=self.batcher.stats["decode_steps"],
            admitted=self.batcher.stats["admitted"],
            virtual_clock=True,
        )
        if extra:
            summary.update(extra)
        if slo_violations and self.capture is not None:
            # SLO breach is the third capture trigger: the run is
            # over (drive()'s finally already closed the bounded
            # window), so no profiler is armed -- there are no future
            # steps to bound or ever close one. The flight dump +
            # device-memory snapshot still preserve the evidence
            # trail, keyed by the first violated tenant's class.
            self.capture.trigger(
                "slo_breach",
                trace_id=trace_id_for("tenant", violated_tenants[0]),
                sink=self.metrics_path,
                arm_profiler=False,
            )
        if self.capture is not None:
            # AFTER the SLO trigger above, so an SLO-breach-only
            # capture is counted -- the summary is the join point the
            # banked rows and the on-disk evidence must agree on.
            summary["captures"] = self.capture.captures
        self.meter.write_summary(summary)
        get_registry().emit_snapshot(sink=self.metrics_path)
        return summary
