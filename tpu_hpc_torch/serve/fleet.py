"""Multi-replica serving fleet: routing, failure handling, autoscale,
live weight hot-swap.

Port of the JAX package's ``serve/fleet.py``. A replica is one
:class:`PagedEngine` on one device (the JAX package's mesh slice): the
default split gives each replica its own card, and an explicit
``devices=`` list may repeat a device, which is how one card holds
several replicas. The cost model, the event sequence and every
summary field are the JAX package's, so a seeded scenario gives the
JAX fleet's summary on the same engines' tokens.

Everything below serves ONE contract -- **no admitted request is ever
lost, and no tenant above the SLO-class floor ever sheds** -- under
the failure modes a real fleet meets: a replica dying mid-decode, a
replica running slow, a corrupt weight artifact, diurnal load swings.
The fleet-scale operations literature (arXiv 2510.20171) argues these
systems live or die on *diagnosable* failure handling; every
transition here is a schema-stamped ``obs`` event, and every recovery
path has a pinning chaos test (tests/test_fleet.py).

Layers (all in this module -- they share the replica table):

* **Replicas** -- N :class:`~tpu_hpc_torch.serve.paging.PagedEngine`
  units, one device each, each behind its own
  :class:`~tpu_hpc_torch.serve.scheduler.ContinuousBatcher`. Chunked
  prefill is REQUIRED: redispatch replays ``prompt + committed``,
  which can exceed any single prefill bucket.
* **Router** -- places each request by tenant SLO class *and prefix
  affinity*: the leading prompt block keys a map to the replica whose
  prefix trie is already warm (a shared system prompt costs its
  prefill FLOPs once PER FLEET, not once per replica -- naive
  round-robin, kept as the measured control, destroys the
  per-replica hit rate). Affinity misses go to the least-loaded
  healthy replica; slow/draining/dead replicas take no new load.
* **Health + redispatch** -- each replica heartbeats (its last
  completed tick) on the fleet clock; a silent replica past
  ``heartbeat_timeout_s`` is declared dead, its in-flight requests
  are **re-dispatched** onto survivors by replaying from ``prompt +
  committed tokens`` (the tokens the router already streamed to the
  client). Greedy decode is a pure function of the token sequence and
  seeded sampling folds (request seed, absolute position) only -- so
  the resumed stream is byte-identical to the no-failure run, pinned.
  Dead replicas restart under jittered exponential backoff
  (resilience/retry.backoff_delays -- N replicas restarting against
  one checkpoint FS must not stampede).
* **Autoscaler** -- grows/shrinks the live set from the occupancy
  gauge and the block-stall watermark. Scale-up activates a warm
  standby (weights placed through the bounded train->serve path if
  its version is stale); scale-down DRAINS first -- in-flight
  decodes finish on the draining replica before its pool is released
  (pinned: draining never drops a request).
* **Weight hot-swap** -- a published update swaps replicas ONE AT A
  TIME: drain -> place through serve/weights.place_params (fresh
  buffers, bounded groups) -> verify against the publisher's content
  checksums (ckpt/integrity.py) -> flush the KV pool (cached K/V
  encodes the old weights) -> resume. A checksum mismatch rolls the
  replica back to its resident weights and aborts the update -- the
  fleet keeps serving the old model, pinned byte-identical. The old
  weights are released only after the new ones verify. Published
  weights come in the serving dtypes (matrices in ``cfg.dtype``, norm
  scales float32): the checksums are over the bytes a replica holds.

The :class:`FleetHarness` drives a loadgen scenario over the fleet on
per-replica VIRTUAL timelines (a discrete-event loop over the
single-engine harness's cost model): concurrent replicas charge
overlapping virtual intervals, so adding a replica reduces latency
instead of serializing onto one clock, and a slow replica hurts only
its own requests. ``TPU_HPC_LOADGEN_FAULTS`` grows the fleet fault
keys -- ``replica_kill_at=<tick>``, ``swap_corrupt=1``,
``slow_replica=<id>:<factor>`` -- parsed with the same typed-error
discipline as every other injection spec in this repo.
"""
from __future__ import annotations

import collections
import dataclasses
import os
import statistics
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch

from tpu_hpc_torch.obs import StallDetector, get_bus, get_registry
from tpu_hpc_torch.obs.digest import (
    ENV_DIGEST_DIR,
    DigestPublisher,
    LogBucketSketch,
)
from tpu_hpc_torch.obs.live import (
    Rollup,
    stale_entries,
    write_fleet_prometheus,
)
from tpu_hpc_torch.obs.slo import BurnRateMonitor
from tpu_hpc_torch.serve.scheduler import (
    AdmissionPolicy,
    ContinuousBatcher,
    Request,
)
# Import DAG note: fleet -> loadgen.harness -> serve.{metrics,
# scheduler} is acyclic BECAUSE serve/__init__ exports this module
# lazily (PEP 562) -- an eager re-export there would close the loop
# through the partially-initialized loadgen package.
from tpu_hpc_torch.loadgen.harness import (
    LoadMeter,
    VirtualClock,
    _CostModelEngine,
    parse_faults,
    tenant_summary,
)

# Replica lifecycle states.
LIVE = "live"            # serving: routed new requests, ticked
STANDBY = "standby"      # warm (compiled, parked): autoscale headroom
DRAINING = "draining"    # scale-down: finishes in-flight, no new load
SWAPPING = "swapping"    # weight swap: draining toward the swap
DEAD = "dead"            # heartbeat-timed-out; restart may be pending


@dataclasses.dataclass(frozen=True)
class FleetConfig:
    """Fleet policy knobs: everything the router, health monitor,
    autoscaler and swap controller decide from.

    ``initial_replicas``/``min_replicas``/``max_replicas`` bound the
    live set (``max_replicas`` defaults to the engine count -- every
    constructed engine is warm standby headroom). The health monitor
    declares a replica dead after ``heartbeat_timeout_s`` of silence
    on the fleet clock, and marks it slow when its recent decode-tick
    mean exceeds ``slow_factor`` x the median of its PEERS' means
    (cross-replica: a uniformly slow replica never trips its OWN
    watermark, and excluding self keeps a small fleet's straggler
    from dragging the baseline toward itself). The
    autoscaler acts on the mean live occupancy over ``scale_window``
    observations, at most once per ``scale_cooldown`` ticks; a
    block-stall increase inside the window also triggers growth (the
    pool is the scarce resource the occupancy gauge can understate).
    Dead replicas restart up to ``restart_retries`` times under
    jittered exponential backoff (deterministic per replica via
    ``restart_seed`` -- the thundering-herd guard is testable)."""

    initial_replicas: int = 1
    min_replicas: int = 1
    max_replicas: Optional[int] = None
    router: str = "affinity"
    heartbeat_timeout_s: float = 0.25
    slow_factor: float = 3.0
    health_window: int = 6
    stall_factor: float = 3.0
    scale_up_occupancy: float = 0.85
    scale_down_occupancy: float = 0.25
    scale_window: int = 12
    scale_cooldown: int = 24
    restart_dead: bool = True
    restart_retries: int = 2
    restart_base_delay_s: float = 0.2
    restart_max_delay_s: float = 2.0
    restart_jitter: float = 0.5
    restart_seed: int = 0
    swap_max_inflight_bytes: Optional[int] = None
    # Affinity spill: honor a prefix-affinity hit only while the warm
    # replica's load is within this many requests of the least-loaded
    # candidate -- a warm trie saves one system prompt's prefill, but
    # queueing behind a hot-spot costs whole requests of latency.
    # None = the replica's slot count (one full batch of slack).
    affinity_spill: Optional[int] = None

    def __post_init__(self):
        if self.router not in ("affinity", "round_robin"):
            raise ValueError(
                f"router {self.router!r} must be 'affinity' or "
                "'round_robin'"
            )
        if not 1 <= self.min_replicas <= self.initial_replicas:
            raise ValueError(
                f"need 1 <= min_replicas {self.min_replicas} <= "
                f"initial_replicas {self.initial_replicas}"
            )
        if self.heartbeat_timeout_s <= 0:
            raise ValueError(
                f"heartbeat_timeout_s {self.heartbeat_timeout_s} "
                "must be > 0"
            )
        if self.slow_factor <= 1.0:
            raise ValueError(
                f"slow_factor {self.slow_factor} must be > 1"
            )
        if not 0.0 < self.scale_down_occupancy \
                < self.scale_up_occupancy <= 1.0:
            raise ValueError(
                "need 0 < scale_down_occupancy "
                f"{self.scale_down_occupancy} < scale_up_occupancy "
                f"{self.scale_up_occupancy} <= 1"
            )
        if self.restart_retries < 0:
            raise ValueError(
                f"restart_retries {self.restart_retries} must be >= 0"
            )


@dataclasses.dataclass
class Replica:
    """One serving unit: engine + batcher + health bookkeeping. The
    fleet mutates this; nothing outside fleet.py should."""

    idx: int
    engine: Any                      # PagedEngine (possibly cost-wrapped)
    status: str = STANDBY
    batcher: Optional[ContinuousBatcher] = None
    responsive: bool = True          # False = killed/wedged (undetected)
    t_local: float = 0.0             # this replica's virtual timeline
    last_beat: float = 0.0           # last completed tick (fleet clock)
    weights_version: int = 0
    ticks: int = 0                   # completed batcher ticks
    restarts: int = 0
    restart_at: Optional[float] = None
    _restart_delays: Optional[Any] = None
    tick_durs: Any = None            # deque of recent decode-tick durs
    stalled: bool = False            # per-replica stall verdict
    detector: Optional[StallDetector] = None

    @property
    def busy(self) -> bool:
        return self.batcher is not None and (
            self.batcher.active > 0 or bool(self.batcher.pending)
        )

    @property
    def load(self) -> int:
        if self.batcher is None:
            return 0
        return self.batcher.active + len(self.batcher.pending)


def split_fleet_devices(n_devices: int, n_replicas: int) -> List[torch.device]:
    """One device per replica over the visible cards, by the JAX
    package's split rule: ``n_devices // n_replicas`` cards a replica,
    at least one each. A port engine runs on one device, so a replica
    serves from the first card of its share."""
    if n_replicas < 1:
        raise ValueError(f"n_replicas {n_replicas} must be >= 1")
    per = n_devices // n_replicas
    if per < 1:
        raise ValueError(
            f"{n_replicas} replicas over {n_devices} device(s): each "
            "replica needs at least one chip"
        )
    return [torch.device("cuda", k * per) for k in range(n_replicas)]


def build_fleet_engines(
    params: Any,
    cfg,
    serve_cfg,
    paged_cfg,
    n_replicas: int,
    warmup: bool = True,
    devices: Optional[Sequence[Any]] = None,
) -> List[Any]:
    """Construct (and optionally warm) ``n_replicas`` PagedEngines from
    ONE param tree -- each engine's ``__init__`` places its own copy on
    its device through serve/weights.place_params (the train->serve
    path). ``devices`` (one per replica, repeats allowed) overrides
    the default split (:func:`split_fleet_devices` over the visible
    cards). Chunked prefill must be configured
    (``paged_cfg.prefill_chunk > 0``): redispatch replays
    ``prompt + committed``, which can exceed any single bucket."""
    from tpu_hpc_torch.serve.paging import PagedEngine

    if devices is None:
        devices = split_fleet_devices(torch.cuda.device_count(), n_replicas)
    elif len(devices) != n_replicas:
        raise ValueError(
            f"{len(devices)} device(s) given for {n_replicas} replicas"
        )
    engines = []
    for device in devices:
        engine = PagedEngine(params, cfg, serve_cfg, device, paged_cfg)
        if warmup:
            engine.warmup()
        engines.append(engine)
    return engines


class ServingFleet:
    """The replica table plus the four controllers (router, health,
    autoscaler, swap). Time is INJECTED: every decision method takes
    ``now`` (the driver's clock -- virtual under FleetHarness, wall
    under a live server), so the failure machinery is deterministic
    under test and honest in production."""

    def __init__(
        self,
        engines: Sequence[Any],
        cfg: FleetConfig,
        meter,
        policy_factory: Optional[Callable[[], AdmissionPolicy]] = None,
        metrics_path: Optional[str] = None,
        corrupt_next_swap: bool = False,
    ):
        if not engines:
            raise ValueError("a fleet needs at least one engine")
        for e in engines:
            if not getattr(e, "is_paged", False):
                raise ValueError(
                    "fleet replicas must be paged engines (the "
                    "router's prefix affinity is trie state)"
                )
            if getattr(e, "spec", None) is not None:
                raise ValueError(
                    "fleet replicas must not carry a SpecRunner "
                    "(reset_pool cannot flush the mirrored draft "
                    "pool)"
                )
            if not e.paged.prefill_chunk:
                raise ValueError(
                    "fleet replicas need chunked prefill "
                    "(paged.prefill_chunk > 0): redispatch replays "
                    "prompt + committed tokens, which can exceed any "
                    "single prefill bucket"
                )
        n_max = cfg.max_replicas or len(engines)
        if not cfg.initial_replicas <= n_max <= len(engines):
            raise ValueError(
                f"need initial_replicas {cfg.initial_replicas} <= "
                f"max_replicas {n_max} <= engines {len(engines)}"
            )
        self.cfg = cfg
        self.meter = meter
        self.metrics_path = metrics_path
        self._policy_factory = policy_factory or AdmissionPolicy
        self._corrupt_next_swap = corrupt_next_swap
        self._block_size = engines[0].paged.block_size

        self.replicas = [
            Replica(
                idx=i, engine=e,
                tick_durs=collections.deque(
                    maxlen=cfg.health_window
                ),
                detector=StallDetector(
                    window=16, factor=cfg.stall_factor, min_samples=5,
                ),
            )
            for i, e in enumerate(engines[:n_max])
        ]
        # Request bookkeeping: the router is the layer that streams
        # tokens to clients, so ``results`` (synced every tick) IS
        # the committed prefix redispatch replays from -- nothing is
        # ever read back from a dead replica.
        self.requests: Dict[str, Request] = {}
        self.owner: Dict[str, int] = {}
        self.results: Dict[str, List[int]] = {}
        self._base: Dict[str, List[int]] = {}   # committed pre-redispatch
        self._orphans: List[Request] = []       # no live replica yet

        # Router state.
        self._affinity: Dict[Tuple[int, ...], int] = {}
        self._rr = 0
        self.router_stats = {
            "routes": 0, "affinity_lookups": 0, "affinity_routes": 0,
            "affinity_spills": 0,
        }
        self._spill_slack = (
            cfg.affinity_spill
            if cfg.affinity_spill is not None
            else engines[0].serve_cfg.slots
        )

        # Controllers' state.
        self.weights_version = 0
        self._weights_src: Optional[Tuple[Any, Dict]] = None
        self._pending_swap: Optional[Dict[str, Any]] = None
        self._occ_window: collections.deque = collections.deque(
            maxlen=max(cfg.scale_window, 2)
        )
        self._stall_window: collections.deque = collections.deque(
            maxlen=max(cfg.scale_window, 2)
        )
        self._last_scale = -cfg.scale_cooldown

        self.stats = {
            "redispatched": 0, "replica_down": 0, "restarts": 0,
            "swapped_replicas": 0, "swap_rollbacks": 0,
            "scale_ups": 0, "scale_downs": 0,
        }
        # Batcher stats harvested before a batcher is dropped (park,
        # restart): aggregate_stats must count a retired batcher's
        # decode steps/admissions/block stalls, or every scale-down
        # and restart silently shrinks the banked mechanism numbers.
        self._retired_stats: Dict[str, int] = {}
        self._live_min = self._live_max = 0

        reg = get_registry()
        reg.describe(
            "fleet_live_replicas",
            "Replicas currently serving (live, not draining)",
        )
        reg.describe(
            "fleet_redispatch_total",
            "In-flight requests replayed onto a survivor after a "
            "replica loss",
        )
        reg.describe(
            "fleet_replica_down_total",
            "Replicas declared dead by the heartbeat monitor",
        )
        reg.describe(
            "fleet_swap_total",
            "Replica weight hot-swaps completed (checksum-verified)",
        )
        reg.describe(
            "fleet_swap_rollback_total",
            "Weight swaps rolled back on a content-checksum mismatch",
        )
        for r in self.replicas[:cfg.initial_replicas]:
            self._activate(r, reason="bringup", now=0.0)
        # A bring-up-sized fleet is the baseline the live range is
        # measured against, not the empty pre-bring-up instant.
        self._live_min = len(self.live)
        self._set_gauges()

    # -- replica set ----------------------------------------------------
    @property
    def live(self) -> List[Replica]:
        return [r for r in self.replicas if r.status == LIVE]

    def _set_gauges(self) -> None:
        n = len(self.live)
        self._live_min = min(self._live_min, n)
        self._live_max = max(self._live_max, n)
        get_registry().set_gauge("fleet_live_replicas", n)

    def _retire_batcher(self, r: Replica) -> None:
        """Fold a batcher's counters into the retired pool before it
        is dropped -- a parked or restarted replica's work already
        happened and must stay counted."""
        if r.batcher is None:
            return
        for k, v in r.batcher.stats.items():
            if isinstance(v, int):
                self._retired_stats[k] = (
                    self._retired_stats.get(k, 0) + v
                )
        r.batcher = None

    def _make_batcher(self, r: Replica) -> ContinuousBatcher:
        return ContinuousBatcher(
            r.engine,
            meter=self.meter,
            policy=self._policy_factory(),
            stall_signal=lambda rep=r: rep.stalled,
        )

    def _activate(
        self, r: Replica, reason: str, now: float
    ) -> None:
        """STANDBY/DEAD -> LIVE: fresh batcher, weights synced to the
        fleet's current version. The KV pool survives a warm park
        (its trie is valid cache under unchanged weights) and is
        flushed only on the paths that invalidate it: a dead-replica
        restart (the crashed predecessor's admitted state) or a
        weight-version sync (_place_verified flushes)."""
        if r.batcher is not None or r.status == DEAD:
            self._retire_batcher(r)
            r.engine.reset_pool(force=True)
        if self._weights_src is not None \
                and r.weights_version != self.weights_version:
            # A False return (current weights failing their own
            # checksums -- a broken source, not a swap) leaves the
            # replica on its resident weights; the "corrupt" event
            # already names the evidence, and serving the older
            # version beats refusing capacity.
            self._place_verified(r, *self._weights_src,
                                 version=self.weights_version)
        r.batcher = self._make_batcher(r)
        r.status = LIVE
        r.responsive = True
        r.t_local = max(r.t_local, now)
        r.last_beat = now
        r.restart_at = None
        r.stalled = False
        r.tick_durs.clear()
        get_bus().emit(
            "replica_up", sink=self.metrics_path, replica=r.idx,
            reason=reason, weights_version=r.weights_version,
        )
        self._set_gauges()
        self._flush_orphans(now)

    def compile_count_total(self) -> int:
        return sum(
            getattr(r.engine, "compile_count_total",
                    r.engine.compile_count)
            for r in self.replicas
        )

    def warmup(self) -> int:
        for r in self.replicas:
            r.engine.warmup()
        return self.compile_count_total()

    # -- router ---------------------------------------------------------
    def _prefix_key(self, prompt: Sequence[int]):
        if len(prompt) >= self._block_size:
            return tuple(prompt[:self._block_size])
        return None

    def _slow_indices(self) -> set:
        """Cross-replica slowness, one pass: each windowed replica's
        recent decode-tick mean against the median of its PEERS'
        means (excluding itself -- in a small fleet the straggler
        would drag a fleet-wide median toward itself and mask the
        very asymmetry being judged; a uniformly slow fleet never
        trips, because every peer is equally slow). Means are
        computed once per call, not once per (replica, peer) pair --
        route() sits on the request hot path."""
        means = {
            p.idx: statistics.fmean(p.tick_durs)
            for p in self.replicas
            if p.status in (LIVE, DRAINING, SWAPPING)
            and len(p.tick_durs) >= self.cfg.health_window
        }
        if len(means) < 2:
            return set()
        slow = set()
        for idx, mean in means.items():
            peers = [v for k, v in means.items() if k != idx]
            baseline = statistics.median(peers)
            if baseline > 0 and mean > self.cfg.slow_factor * baseline:
                slow.add(idx)
        return slow

    def _is_slow(self, r: Replica) -> bool:
        return r.idx in self._slow_indices()

    def route(self, req: Request) -> Optional[Replica]:
        """Pick the serving replica for one request: prefix affinity
        (a warm trie beats an idle pool), then least-loaded among
        healthy live replicas. Slow replicas take NO new load -- the
        router sheds load away from degradation before it becomes an
        SLO breach (every queued request behind a 3x-slow decode
        loop pays 3x ITL). Returns None when nothing is live (the
        caller parks the request as an orphan)."""
        live = self.live
        slow = self._slow_indices()
        healthy = [r for r in live if r.idx not in slow]
        pool = healthy or live
        if not pool:
            return None
        self.router_stats["routes"] += 1
        affinity = False
        if self.cfg.router == "round_robin":
            chosen = pool[self._rr % len(pool)]
            self._rr += 1
        else:
            chosen = None
            key = self._prefix_key(req.prompt)
            if key is not None:
                self.router_stats["affinity_lookups"] += 1
                idx = self._affinity.get(key)
                if idx is not None:
                    cand = self.replicas[idx]
                    slots = cand.engine.serve_cfg.slots
                    min_load = min(r.load for r in pool)
                    # Honor the warm replica while it can seat the
                    # request soon (within ``affinity_spill`` of a
                    # free slot), or when EVERYONE queues -- at fleet
                    # saturation the prefix FLOPs savings are worth
                    # the most and queueing is unavoidable anywhere.
                    # Spill only in the asymmetric case: the warm
                    # replica is a hot-spot while a peer could seat
                    # the request now.
                    honor = (
                        cand.load < slots + self._spill_slack
                        or min_load >= slots
                        or cand.load <= min_load + self._spill_slack
                    )
                    if cand in pool and honor:
                        chosen = cand
                        affinity = True
                        self.router_stats["affinity_routes"] += 1
                        # Host-tier prefetch on the affinity hit: the
                        # warm replica starts pulling this prompt's
                        # spilled prefix pages out of host DRAM NOW,
                        # while the request still rides the queue --
                        # the hop hides behind queueing instead of
                        # stretching TTFT-on-return.
                        eng = cand.engine
                        if getattr(eng, "host_tier", None) is not None:
                            eng.prefetch_prompt(req.prompt)
                    elif cand in pool:
                        # The mapping stays: the trie is still warm
                        # for the next, calmer arrival.
                        self.router_stats["affinity_spills"] += 1
            if chosen is None:
                chosen = min(pool, key=lambda r: (r.load, r.idx))
                if key is not None:
                    # (Re-)pin the prefix to its new home -- a dead or
                    # slow replica's mapping must not keep bouncing
                    # misses off it.
                    self._affinity[key] = chosen.idx
        # Ring-only: routing runs at request cadence (the lg_token
        # discipline); the flight ring still joins it to the trace.
        get_bus().emit(
            "fleet_route", rid=req.rid, replica=chosen.idx,
            tenant=req.tenant, affinity=affinity,
        )
        return chosen

    def _assign(self, req: Request, target: Replica, now: float) -> None:
        self.owner[req.rid] = target.idx
        # The target's timeline floors at the submission instant:
        # an idle replica's clock was parked wherever its last work
        # ended, and a BUSY survivor taking a redispatch can lag the
        # dead replica's last streamed-token time -- either way,
        # admitting a request "in the past" would mint negative
        # queue/TTFT/ITL times. For ordinary arrivals to busy
        # replicas this is a no-op (the event loop only submits at or
        # behind every busy timeline); a forward jump is always legal
        # (the target's own requests stay monotonic).
        target.t_local = max(target.t_local, now)
        target.batcher.submit(req)

    def submit(self, req: Request, now: float) -> None:
        """Route + enqueue one request. With no live replica (a full
        outage mid-restart) the request parks as an orphan and is
        flushed to the first replica that comes up -- queued, never
        dropped."""
        self.requests[req.rid] = req
        # Stamp submission NOW, before routing: an orphaned arrival
        # (full outage) reaches a batcher only after a restart, and
        # anchoring t_submit there would erase exactly the worst-case
        # client wait the chaos quantiles exist to carry. Idempotent
        # for any meter (the batcher's own submitted() call finds the
        # trace already present on FleetMeter, and is guarded here
        # for the rest).
        if req.rid not in self.meter.traces:
            self.meter.submitted(req.rid)
        target = self.route(req)
        if target is None:
            self._orphans.append(req)
            return
        self._assign(req, target, now)

    def _flush_orphans(self, now: float) -> None:
        if not self._orphans:
            return
        parked, self._orphans = self._orphans, []
        for req in parked:
            target = self.route(req)
            if target is None:
                self._orphans.append(req)
            else:
                self._assign(req, target, now)

    # -- results streaming ----------------------------------------------
    def sync_results(self, r: Replica) -> None:
        """Pull newly generated tokens from ``r`` into the fleet's
        client-visible streams. This runs after every tick -- the
        "already streamed to the client" committed prefix is exactly
        what redispatch may replay, so nothing is ever read back from
        a replica after its death."""
        if r.batcher is None:
            return
        for rid, toks in r.batcher.results.items():
            if self.owner.get(rid) != r.idx:
                continue
            base = self._base.get(rid)
            self.results[rid] = (base + toks) if base else list(toks)

    # -- health + redispatch --------------------------------------------
    def kill(self, idx: int) -> None:
        """Fault-injection hook: the replica stops responding (no
        ticks, no heartbeats). NOTHING is emitted here -- detection
        is the health monitor's job, and the detect->recover latency
        is part of what the chaos tests measure."""
        self.replicas[idx].responsive = False

    def unfinished_on(self, r: Replica) -> List[str]:
        """rids owned by ``r`` that neither finished nor shed, in
        submission order."""
        out = []
        for rid, idx in self.owner.items():
            if idx != r.idx:
                continue
            trace = self.meter.traces.get(rid)
            if trace is None or trace.t_done is not None:
                continue   # shed (trace popped) or finished
            out.append(rid)
        return out

    def check_health(self, now: float) -> None:
        """Declare silent replicas dead (-> redispatch, schedule a
        jittered restart), bring restarts that are due back up, and
        flush any orphans. A responsive replica heartbeats between
        ticks (the idle-timer a real replica process runs -- the
        simulation seam: ``responsive`` is the hidden fault state the
        injector flips, and the monitor only ever sees its
        heartbeats); only a replica whose heartbeats STOPPED crosses
        the timeout."""
        for r in self.replicas:
            if r.status in (LIVE, DRAINING, SWAPPING):
                if r.responsive:
                    r.last_beat = max(r.last_beat, now)
                elif now - r.last_beat \
                        > self.cfg.heartbeat_timeout_s:
                    self._on_dead(r, now)
            elif r.status == DEAD and r.restart_at is not None \
                    and now >= r.restart_at:
                r.restarts += 1
                self.stats["restarts"] += 1
                self._activate(r, reason="restart", now=now)
        self._flush_orphans(now)

    def _on_dead(self, r: Replica, now: float) -> None:
        victims = self.unfinished_on(r)
        r.status = DEAD
        self.stats["replica_down"] += 1
        get_registry().inc("fleet_replica_down_total")
        get_bus().emit(
            "replica_down", sink=self.metrics_path, replica=r.idx,
            reason="heartbeat_timeout",
            inflight=len(victims), redispatched=len(victims),
            last_beat_age_s=now - r.last_beat,
        )
        for rid in victims:
            self._redispatch(rid, r, now)
        if self.cfg.restart_dead \
                and r.restarts < self.cfg.restart_retries:
            if r._restart_delays is None:
                from tpu_hpc_torch.resilience.retry import backoff_delays

                # Deterministic per (fleet seed, replica): the jitter
                # de-synchronizes N replicas restarting against one
                # checkpoint filesystem, and the bounds are pinned by
                # the retry unit tests.
                r._restart_delays = backoff_delays(
                    self.cfg.restart_retries,
                    base_delay=self.cfg.restart_base_delay_s,
                    max_delay=self.cfg.restart_max_delay_s,
                    jitter=self.cfg.restart_jitter,
                    seed=self.cfg.restart_seed * 997 + r.idx,
                )
            try:
                r.restart_at = now + next(r._restart_delays)
            except StopIteration:
                r.restart_at = None
        self._set_gauges()

    def _redispatch(self, rid: str, dead: Replica, now: float) -> None:
        """Replay one in-flight request onto a survivor from prompt +
        committed tokens. Greedy decode is a pure function of the
        token sequence (and seeded sampling folds absolute position
        only), so the resumed stream is byte-identical to the
        no-failure run -- the redispatch determinism contract."""
        orig = self.requests[rid]
        committed = list(self.results.get(rid, []))
        remaining = orig.max_new_tokens - len(committed)
        if remaining < 1:
            return   # fully generated; eviction raced the death
        replay = Request(
            rid=rid,
            prompt=list(orig.prompt) + committed,
            max_new_tokens=remaining,
            eos_id=orig.eos_id,
            tenant=orig.tenant,
            priority=orig.priority,
            temperature=orig.temperature,
            top_p=orig.top_p,
            seed=orig.seed,
        )
        self._base[rid] = committed
        self.stats["redispatched"] += 1
        get_registry().inc("fleet_redispatch_total")
        target = self.route(replay)
        get_bus().emit(
            "redispatch", sink=self.metrics_path, rid=rid,
            from_replica=dead.idx,
            to_replica=target.idx if target else -1,
            committed=len(committed), tenant=orig.tenant,
        )
        if target is None:
            self._orphans.append(replay)
            self.owner.pop(rid, None)
        else:
            self._assign(replay, target, now)

    def observe_tick(
        self, r: Replica, now: float, decoded: bool, decode_dur_s: float,
    ) -> None:
        """Per-tick health bookkeeping, called by the driver after
        each replica tick: heartbeat, the cross-replica slowness
        window, and this replica's own stall watermark (the admission
        policy's shed_on_stall input)."""
        r.last_beat = now
        r.ticks += 1
        if decoded:
            r.tick_durs.append(decode_dur_s)
            info = r.detector.observe(r.ticks, decode_dur_s)
            r.stalled = info is not None
        else:
            # No decode ran (admission-only / chunked-prefill tick):
            # no cadence to judge, and a standing verdict would keep
            # shedding on a stall that is already over (the
            # LoadHarness discipline).
            r.stalled = False

    def next_deadline(self, now: float) -> Optional[float]:
        """The earliest future time at which the health monitor has
        something to do (an undetected death crossing the timeout, a
        restart coming due) -- the driver jumps its clock here when
        nothing else is schedulable, so a stranded request is always
        either recovered or loudly lost, never hung."""
        deadlines = []
        for r in self.replicas:
            if r.status in (LIVE, DRAINING, SWAPPING) \
                    and not r.responsive:
                deadlines.append(
                    r.last_beat + self.cfg.heartbeat_timeout_s
                )
            elif r.status == DEAD and r.restart_at is not None:
                deadlines.append(r.restart_at)
        future = [d for d in deadlines if d > now]
        if future:
            return min(future)
        # A deadline at/behind ``now`` still needs one more
        # check_health pass; nudge past it.
        return min(deadlines) + 1e-6 if deadlines else None

    def has_stranded_work(self) -> bool:
        """Unfinished requests held by unresponsive/dead replicas, or
        orphans with nothing live to serve them."""
        if self._orphans:
            return True
        for r in self.replicas:
            if (not r.responsive or r.status == DEAD) \
                    and self.unfinished_on(r):
                return True
        return False

    # -- autoscaler -----------------------------------------------------
    def maybe_autoscale(self, now: float, tick: int) -> None:
        live = self.live
        occ = (
            statistics.fmean(r.batcher.occupancy for r in live)
            if live else 0.0
        )
        self._occ_window.append(occ)
        # Retired counters included: a park/restart dropping a
        # batcher must not step the cumulative sum backward and read
        # as negative stall growth.
        self._stall_window.append(
            self._retired_stats.get("block_stalls", 0) + sum(
                r.batcher.stats.get("block_stalls", 0)
                for r in self.replicas if r.batcher is not None
            )
        )
        # Scale-down completion: a DRAINING replica parks only once
        # its last in-flight decode finished -- drain-before-release,
        # pinned.
        for r in self.replicas:
            if r.status == DRAINING and not r.busy:
                # Park WITHOUT flushing: the trie-parked pages are
                # still valid K/V under the current weights, so a
                # re-activation serves its tenants' prefixes warm.
                # The flush happens where it is actually required --
                # a weight-version change (_place_verified) or a
                # dead-replica restart (_activate). The batcher's
                # counters retire into the fleet aggregate first.
                self._retire_batcher(r)
                r.status = STANDBY
                self.stats["scale_downs"] += 1
                get_bus().emit(
                    "fleet_scale", sink=self.metrics_path,
                    action="shrink", live=len(self.live),
                    replica=r.idx, occupancy=occ,
                )
                self._set_gauges()
        if len(self._occ_window) < self.cfg.scale_window:
            return
        if tick - self._last_scale < self.cfg.scale_cooldown:
            return
        occ_avg = statistics.fmean(self._occ_window)
        stall_growth = (
            self._stall_window[-1] - self._stall_window[0]
        )
        live = self.live
        standby = [r for r in self.replicas if r.status == STANDBY]
        if (occ_avg >= self.cfg.scale_up_occupancy
                or stall_growth > 0) and standby:
            r = standby[0]
            self._activate(r, reason="scale_up", now=now)
            self.stats["scale_ups"] += 1
            get_bus().emit(
                "fleet_scale", sink=self.metrics_path, action="grow",
                live=len(self.live), replica=r.idx, occupancy=occ_avg,
                reason=(
                    "block_stalls" if stall_growth > 0 else "occupancy"
                ),
            )
            self._last_scale = tick
        elif occ_avg <= self.cfg.scale_down_occupancy \
                and len(live) > self.cfg.min_replicas \
                and self._pending_swap is None:
            r = min(live, key=lambda x: (x.load, x.idx))
            r.status = DRAINING
            get_bus().emit(
                "fleet_scale", sink=self.metrics_path,
                action="drain_start", live=len(self.live),
                replica=r.idx, occupancy=occ_avg,
            )
            self._last_scale = tick
            self._set_gauges()

    # -- weight hot-swap ------------------------------------------------
    def publish_weights(
        self,
        params: Any,
        checksums: Optional[Dict] = None,
        label: str = "",
    ) -> int:
        """Publish a model update. ``checksums`` are the PUBLISHER's
        content checksums (ckpt/integrity.leaf_checksums at save
        time); omitted, they are computed from ``params`` here --
        which models a trusted publisher, not an untrusted transport.
        Replicas swap one at a time as :meth:`advance_swap` is
        driven. Returns the new version number."""
        from tpu_hpc_torch.ckpt.integrity import leaf_checksums
        from tpu_hpc_torch.serve.weights import flat_params, serving_dtype

        cfg = self.replicas[0].engine.cfg
        wrong = [
            p for p, t in flat_params(params).items()
            if t.dtype != serving_dtype(t, cfg)
        ]
        if wrong:
            # A leaf in another dtype than the replica holds would be
            # skipped by verify_tree (a legal restore cast), so its
            # corruption could never be caught.
            raise ValueError(
                f"publish_weights: {wrong[0]} is not in the serving "
                "dtype (matrices in cfg.dtype, norm scales float32); "
                "place the tree through serve/weights.place_params "
                "first"
            )
        version = self.weights_version + 1
        self._pending_swap = {
            "version": version,
            "params": params,
            "checksums": (
                checksums if checksums is not None
                else leaf_checksums(flat_params(params))
            ),
            "label": label,
        }
        return version

    def advance_swap(self, now: float) -> None:
        """One controller step of the drain-and-swap rollout: at most
        ONE replica is ever out of the serving set for a swap, and
        the last live replica never drains (capacity floor)."""
        upd = self._pending_swap
        if upd is None:
            return
        swapping = [r for r in self.replicas if r.status == SWAPPING]
        if swapping:
            r = swapping[0]
            if not r.busy:
                self._do_swap(r, now)
            return
        candidates = [
            r for r in self.live
            if r.weights_version != upd["version"]
        ]
        if not candidates:
            # Every live replica runs the new version: the update is
            # the fleet's current truth (standbys and restarts sync
            # from _weights_src on activation).
            self.weights_version = upd["version"]
            self._weights_src = (upd["params"], upd["checksums"])
            self._pending_swap = None
            return
        # Capacity floor: the LAST live replica drains only when it
        # is already idle (swapping an idle sole replica drops
        # nothing; draining a busy one would park the whole fleet's
        # traffic behind the swap).
        r = min(candidates, key=lambda x: (x.busy, x.load, x.idx))
        if len(self.live) < 2 and r.busy:
            return
        r.status = SWAPPING
        get_bus().emit(
            "weight_swap", sink=self.metrics_path, replica=r.idx,
            version=upd["version"], status="drain_start",
        )
        self._set_gauges()

    def _place_verified(
        self, r: Replica, params: Any, checksums: Dict, version: int,
        fault_ok: bool = False,
    ) -> bool:
        """Place ``params`` onto ``r``'s device as fresh buffers
        (bounded groups) and verify content checksums on what LANDED -- whatever the transport did in between, a
        mismatch means the bytes on this replica are not the bytes
        the publisher summed. On success the engine's weights are
        swapped in place (zero recompiles) and its KV pool flushed
        (cached K/V encodes the old weights). The resident tree is
        released only then: until the new one verifies, both are
        held, and a mismatch drops the new one."""
        from tpu_hpc_torch.ckpt.integrity import verify_tree
        from tpu_hpc_torch.serve.weights import flat_params, place_params

        placed = place_params(
            params, r.engine.cfg, r.engine.device,
            max_inflight_bytes=self.cfg.swap_max_inflight_bytes,
        )
        if fault_ok and self._corrupt_next_swap:
            # Fault injection (swap_corrupt=1): flip one value in the
            # largest placed leaf -- corruption AFTER the publisher
            # summed, exactly the silent-transport-corruption class
            # the checksums exist to catch. One-shot, and armed only
            # on the PUBLISHED swap path (a restart/activation
            # placement is a different code path with its own
            # failure story).
            self._corrupt_next_swap = False
            placed = _flip_one_value(placed)
        bad = verify_tree(flat_params(placed), checksums)
        if bad:
            get_bus().emit(
                "weight_swap", sink=self.metrics_path, replica=r.idx,
                version=version, status="corrupt",
                mismatched=len(bad), reason=bad[0],
            )
            return False
        r.engine.swap_params(placed)
        r.engine.reset_pool(force=True)
        r.weights_version = version
        return True

    def _do_swap(self, r: Replica, now: float) -> None:
        upd = self._pending_swap
        ok = self._place_verified(
            r, upd["params"], upd["checksums"], upd["version"],
            fault_ok=True,
        )
        if ok:
            r.status = LIVE
            self.stats["swapped_replicas"] += 1
            get_registry().inc("fleet_swap_total")
            get_bus().emit(
                "weight_swap", sink=self.metrics_path, replica=r.idx,
                version=upd["version"], status="swapped",
            )
        else:
            # Rollback: the resident (old-version) weights were never
            # touched -- the replica simply resumes serving them, and
            # the whole update aborts (a corrupt artifact is corrupt
            # for every replica; re-publish after fixing the source).
            # Replicas that ALREADY swapped this rollout keep the new
            # version (their previous tree is gone): the fleet is
            # mixed until a clean re-publish, and fleet_summary's
            # mixed_weights flag + this event's reason say so.
            r.status = LIVE
            self.stats["swap_rollbacks"] += 1
            get_registry().inc("fleet_swap_rollback_total")
            already = sum(
                1 for p in self.replicas
                if p.weights_version == upd["version"]
            )
            get_bus().emit(
                "weight_swap", sink=self.metrics_path, replica=r.idx,
                version=upd["version"], status="rolled_back",
                reason=(
                    "content checksum mismatch; serving previous "
                    "weights"
                    + (f"; {already} replica(s) already on "
                       f"v{upd['version']} (mixed until re-publish)"
                       if already else "")
                ),
            )
            self._pending_swap = None
        self._set_gauges()
        # A sole-replica swap window can orphan an arrival (live was
        # briefly empty); the replica is LIVE again on BOTH branches,
        # so flush here -- leaving it to the next health pass would
        # strand the request if the run is otherwise drained (review
        # finding).
        self._flush_orphans(now)

    # -- reporting ------------------------------------------------------
    def aggregate_stats(self) -> Dict[str, int]:
        out = {
            "admitted": 0, "evicted": 0, "decode_steps": 0,
            "shed": 0, "block_stalls": 0,
        }
        for k in out:
            out[k] += self._retired_stats.get(k, 0)
        for r in self.replicas:
            if r.batcher is None:
                continue
            for k in out:
                out[k] += r.batcher.stats.get(k, 0)
        return out

    def prefix_affinity_hit_rate(self) -> float:
        """Aggregate trie hit rate ACROSS replicas -- directly
        comparable to a single replica's prefix_hit_rate: affinity
        routing preserves it, round-robin divides every tenant's
        prefix across N cold tries."""
        hits = lookups = 0
        for r in self.replicas:
            s = r.engine.paged_stats
            hits += s["prefix_hits"]
            lookups += s["prefix_lookups"]
        return hits / lookups if lookups else 0.0

    def fleet_summary(self) -> Dict[str, Any]:
        # A mid-rollout abort (checksum rollback after >= 1 replica
        # already swapped) leaves the fleet on MIXED weight versions
        # -- already-swapped replicas cannot be rolled back (their
        # previous tree is gone) and the rest keep the old version.
        # That state breaks the cross-replica byte-identity contract
        # (the same prompt answers differently by routing), so it is
        # surfaced loudly here for operators and the report, not
        # silently folded into one version number.
        live_versions = sorted(
            {r.weights_version for r in self.live}
        )
        return {
            "replicas": len(self.replicas),
            "live": len(self.live),
            "live_min": self._live_min,
            "live_max": self._live_max,
            "router": self.cfg.router,
            "weights_version": self.weights_version,
            "live_weight_versions": live_versions,
            "mixed_weights": len(live_versions) > 1,
            "prefix_affinity_hit_rate": self.prefix_affinity_hit_rate(),
            "affinity_routes": self.router_stats["affinity_routes"],
            "affinity_lookups": self.router_stats["affinity_lookups"],
            "affinity_spills": self.router_stats["affinity_spills"],
            **self.stats,
        }


def _flip_one_value(tree: Any) -> Any:
    """Corrupt one element of the largest leaf (fault injection for
    swap_corrupt=1): a single-value change no structural check can
    see -- only the content checksums. ``tree`` is a freshly placed
    copy, so the flip happens in place."""
    from tpu_hpc_torch.serve.weights import flat_params

    flat = list(flat_params(tree).values())
    leaf = flat[max(range(len(flat)), key=lambda k: flat[k].numel())]
    leaf[(0,) * leaf.dim()] += 1
    return tree


# ---------------------------------------------------------------------
# The fleet load harness
# ---------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class LiveConfig:
    """Knobs for the harness-driven live telemetry plane (obs/digest,
    obs/live, obs/slo). All times are VIRTUAL seconds -- the digest
    plane rides the harness's discrete-event clock, so a replayed
    scenario publishes bit-identical digests and the breach tests are
    deterministic. ``itl_slo_ms`` is the per-decode-tick latency SLO
    the slo_good/slo_bad counters are judged against;
    ``slo_target``/``burn_threshold`` and the two windows parameterize
    the BurnRateMonitor (fast AND slow must both burn to page)."""

    period_s: float = 0.05
    itl_slo_ms: float = 25.0
    slo_target: float = 0.99
    fast_window_s: float = 0.5
    slow_window_s: float = 2.0
    burn_threshold: float = 5.0
    stale_after_s: float = 2.0
    straggler_factor: float = 3.0


class FleetTelemetry:
    """The fleet's live-plane producer + in-process aggregator.

    One :class:`~tpu_hpc_torch.obs.digest.DigestPublisher` per replica
    (role="replica", key=idx) publishing every ``period_s`` of virtual
    wall: cumulative tick/SLO counters, the occupancy gauge, the
    mergeable per-tick decode-latency sketch, and the replica's
    StallDetector watermark (the normalized straggler signal). Each
    published record is also folded straight into a local
    :class:`~tpu_hpc_torch.obs.live.Rollup` -- the harness aggregates what
    an external ``python -m tpu_hpc_torch.obs.live`` reader of the same
    channel directory would see, byte-for-byte, and feeds the fleet
    SLO totals to the :class:`~tpu_hpc_torch.obs.slo.BurnRateMonitor`
    (paging arms ``capture``, an ``obs.AnomalyCapture``, for one
    correlated evidence bundle). A replica that stops ticking (killed, wedged) stops
    publishing, and the aggregation step surfaces it as a first-class
    ``digest_stale`` event exactly once."""

    def __init__(
        self,
        dir: str,
        cfg: Optional[LiveConfig] = None,
        *,
        metrics_path: Optional[str] = None,
        capture=None,
        run_key: str = "fleet",
    ):
        from tpu_hpc_torch.obs import trace_id_for

        self.dir = dir
        self.cfg = cfg or LiveConfig()
        self.metrics_path = metrics_path
        self.capture = capture
        self.rollup = Rollup(
            stale_after_s=self.cfg.stale_after_s,
            straggler_factor=self.cfg.straggler_factor,
        )
        self.monitor = BurnRateMonitor(
            target=self.cfg.slo_target,
            fast_window_s=self.cfg.fast_window_s,
            slow_window_s=self.cfg.slow_window_s,
            threshold=self.cfg.burn_threshold,
        )
        # One trace id for the whole fleet-SLO condition: the slo_burn
        # record, the capture bundle, and the flight dump all join on
        # it -- "the fleet burned its budget on scenario X" is one
        # correlated story, not three unlinked files.
        self.trace_id = trace_id_for("slo", run_key)
        self._pubs: Dict[int, DigestPublisher] = {}
        self._state: Dict[int, dict] = {}
        self._stale_flagged: set = set()
        self.digests = 0
        self.stale_events = 0
        self.last_view: Optional[dict] = None

    def _replica_state(self, idx: int) -> dict:
        st = self._state.get(idx)
        if st is None:
            st = self._state[idx] = {
                "ticks": 0.0, "slo_good": 0.0, "slo_bad": 0.0,
                "sketch": LogBucketSketch(),
            }
        return st

    def on_tick(
        self, r: "Replica", now: float, decoded: bool,
        decode_dur_s: float, wall: float,
    ) -> None:
        """Fold one replica tick in; publish + aggregate when the
        replica's digest period has elapsed on ITS timeline."""
        st = self._replica_state(r.idx)
        st["ticks"] += 1
        if decoded:
            dur_ms = decode_dur_s * 1e3
            st["sketch"].add(dur_ms)
            if dur_ms <= self.cfg.itl_slo_ms:
                st["slo_good"] += 1
            else:
                st["slo_bad"] += 1
        pub = self._pubs.get(r.idx)
        if pub is None:
            pub = self._pubs[r.idx] = DigestPublisher(
                self.dir, "replica", str(r.idx),
                period_s=self.cfg.period_s,
            )
        if pub.due(now):
            self._publish(
                r.idx, now,
                occupancy=r.batcher.occupancy, detector=r.detector,
            )
            self._aggregate(wall)

    def _publish(
        self, idx: int, t: float, occupancy: float, detector=None,
    ) -> None:
        st = self._replica_state(idx)
        extra = detector.digest_extra() if detector is not None else {}
        # Ring-only on the bus (the lg_token cadence discipline: one
        # digest per period per replica would bloat the run JSONL);
        # the channel file under self.dir is the durable copy.
        rec = self._pubs[idx].publish(
            counters={
                "ticks": st["ticks"],
                "slo_good": st["slo_good"],
                "slo_bad": st["slo_bad"],
            },
            gauges={"occupancy": float(occupancy)},
            hists={"tick_ms": st["sketch"]},
            t=t,
            step_s=extra.get("step_s"),
            watermark_s=extra.get("watermark_s"),
        )
        self.rollup.ingest([rec])
        self.digests += 1

    def _aggregate(self, wall: float) -> None:
        view = self.rollup.build(now=wall)
        self.last_view = view
        for e in stale_entries(view):
            key = (e["role"], e["key"])
            if key in self._stale_flagged:
                continue
            self._stale_flagged.add(key)
            self.stale_events += 1
            get_registry().inc("live_digest_stale_total")
            get_bus().emit(
                "digest_stale", sink=self.metrics_path, **e
            )
        slo = view.get("slo")
        if slo:
            self.monitor.observe(
                wall, slo["good"], slo["bad"],
                sink=self.metrics_path, trace_id=self.trace_id,
                capture=self.capture, reason="fleet_itl_slo",
            )

    def finalize(self, fleet: "ServingFleet", wall: float) -> dict:
        """Final per-replica publish (responsive replicas only -- a
        dead one staying silent IS the signal), one last aggregation,
        the fleet-merged Prometheus textfile when armed, and the
        summary block the report/regress plane reads."""
        for r in fleet.replicas:
            if r.idx not in self._pubs:
                continue
            if r.status == DEAD or not r.responsive:
                continue
            self._publish(
                r.idx, max(wall, self._pubs[r.idx].last_publish_t or 0.0),
                occupancy=r.batcher.occupancy, detector=r.detector,
            )
        self._aggregate(wall)
        view = self.last_view or self.rollup.build(now=wall)
        write_fleet_prometheus(view)
        remaining = self.monitor.budget_remaining()
        slo = view.get("slo") or {}
        return {
            "digests": self.digests,
            "digest_stale": self.stale_events,
            "stragglers": view["stragglers"],
            "stale_keys": view["stale"],
            "slo_burns": self.monitor.burns,
            "slo_attainment": slo.get("attainment"),
            "slo_good": slo.get("good"),
            "slo_bad": slo.get("bad"),
            "budget_remaining": (
                round(remaining, 4) if remaining is not None else None
            ),
            "trace_id": self.trace_id,
        }


class FleetHarness:
    """Drive one loadgen scenario over a :class:`ServingFleet` on
    per-replica virtual timelines.

    A discrete-event loop over the single-engine harness's cost
    model: each replica owns a local virtual clock (``t_local``);
    the next event is whichever comes first of (the earliest busy
    replica's next tick, the next scheduled arrival). The shared
    meter clock is JUMPED to the event's time before it runs, so
    concurrent replicas charge overlapping intervals -- adding a
    replica reduces latency instead of serializing onto one clock,
    and a slow replica's costs land only on its own requests.
    Per-request timestamps stay monotonic: a request lives on one
    replica's timeline at a time, and redispatch only moves it to a
    survivor whose timeline has already passed the detection
    timeout. Seeded scenarios replay bit-identically -- the regress
    gate's determinism contract, now fleet-wide.

    Fleet faults (``TPU_HPC_LOADGEN_FAULTS``):
    ``replica_kill_at=<tick>`` silences the busiest live replica at
    that global tick; ``slow_replica=<id>:<factor>`` multiplies one
    replica's modeled costs; ``swap_corrupt=1`` corrupts the next
    published weight swap after checksum computation. ``swap_at=``
    (+ ``swap_weights=``) schedules a mid-run model update."""

    def __init__(
        self,
        engines: Sequence[Any],
        scenario,
        fleet_cfg: Optional[FleetConfig] = None,
        metrics_path: Optional[str] = None,
        decode_step_ms: float = 8.0,
        prefill_ms_per_token: float = 0.25,
        faults: Optional[Dict[str, Any]] = None,
        swap_at: Optional[int] = None,
        swap_weights: Any = None,
        swap_checksums: Optional[Dict] = None,
        live_cfg: Optional[LiveConfig] = None,
        capture=None,
    ):
        if scenario.colocate_every:
            raise ValueError(
                "colocation scenarios drive the single-engine "
                "LoadHarness; the fleet harness does not model a "
                "colocated trainer"
            )
        if (swap_at is None) != (swap_weights is None):
            raise ValueError(
                "swap_at and swap_weights come together (a scheduled "
                "update needs weights; weights need a schedule)"
            )
        faults = faults if faults is not None else parse_faults()
        self.faults = faults
        if faults.get("swap_corrupt") and swap_at is None:
            # The vacuous-chaos discipline: a corrupt-swap fault with
            # no scheduled swap injects nothing, and the chaos test
            # reading this run would pass without its fault.
            raise ValueError(
                "swap_corrupt=1 needs a scheduled weight update "
                "(swap_at/--fleet-swap-at): with no swap to corrupt "
                "the fault injects nothing"
            )
        slow = faults.get("slow_replica")
        if slow is not None and slow[0] >= len(engines):
            raise ValueError(
                f"slow_replica={slow[0]}:{slow[1]}: the fleet has "
                f"{len(engines)} replica(s) -- a fault naming a "
                "nonexistent replica must not pass vacuously"
            )
        self.scenario = scenario
        self.metrics_path = metrics_path
        self.clock = VirtualClock()
        self.meter = FleetMeter(
            metrics_path=metrics_path, clock=self.clock
        )
        cost_engines = []
        for i, engine in enumerate(engines):
            mult = (
                slow[1] if slow is not None and slow[0] == i else 1.0
            )
            cost_engines.append(_CostModelEngine(
                engine, self.clock, decode_step_ms,
                prefill_ms_per_token,
                {
                    "prefill_delay":
                        faults["prefill_delay"] * mult,
                    "decode_delay":
                        faults["decode_delay"] * mult,
                },
            ))
        self.fleet = ServingFleet(
            cost_engines,
            fleet_cfg or FleetConfig(
                initial_replicas=len(engines),
                min_replicas=1,
            ),
            meter=self.meter,
            policy_factory=lambda: AdmissionPolicy(
                queue_limit=scenario.queue_limit
            ),
            metrics_path=metrics_path,
            corrupt_next_swap=bool(faults.get("swap_corrupt")),
        )
        self.kill_at = faults.get("replica_kill_at")
        self.swap_at = swap_at
        self.swap_weights = swap_weights
        self.swap_checksums = swap_checksums
        self._killed = False
        self._published = False
        self._occupancy: List[float] = []
        self.ticks = 0
        self.wall = 0.0
        # Live telemetry plane: strictly opt-in via the env contract
        # (the digest.from_env discipline) -- an unconfigured harness
        # publishes nothing and pays nothing.
        digest_dir = os.environ.get(ENV_DIGEST_DIR)
        if live_cfg is not None and not digest_dir:
            raise ValueError(
                f"live_cfg given but ${ENV_DIGEST_DIR} is unset: the "
                "live plane would silently publish nowhere"
            )
        self.telemetry = (
            FleetTelemetry(
                digest_dir, live_cfg, metrics_path=metrics_path,
                capture=capture, run_key=scenario.name,
            )
            if digest_dir else None
        )

    # -- drive ----------------------------------------------------------
    def run(self, n_devices: int = 1, max_ticks: Optional[int] = None,
            extra: Optional[dict] = None) -> dict:
        self.drive(max_ticks=max_ticks)
        return self.summarize(n_devices=n_devices, extra=extra)

    def _submit_arrival(self, lr) -> None:
        self.meter.tenant_of[lr.rid] = lr.tenant
        from tpu_hpc_torch.obs import request_trace_id

        get_bus().emit(
            "lg_arrival", sink=self.metrics_path,
            rid=lr.rid, trace_id=request_trace_id(lr.rid),
            tenant=lr.tenant, arrival_ms=lr.arrival_ms,
            prompt_len=len(lr.prompt),
            max_new_tokens=lr.max_new_tokens,
            priority=lr.priority,
        )
        self.fleet.submit(lr.to_request(), self.clock())

    def _budget(self, arrivals) -> int:
        from tpu_hpc_torch.serve.scheduler import paged_drain_bound

        # The chunk/stall drain bound is the scheduler's ONE helper
        # (paged_drain_bound's charter: the budgets must not silently
        # diverge); the fleet adds headroom for redispatch
        # re-prefill, drain-and-swap stalls, and the detection/
        # restart idle jumps -- loud RuntimeError past it.
        base = (
            sum(a.max_new_tokens + 1 for a in arrivals)
            + len(arrivals) + 16
            + paged_drain_bound(
                self.fleet.replicas[0].engine, arrivals
            )
        )
        return 4 * base + 512

    def drive(self, max_ticks: Optional[int] = None) -> None:
        sc = self.scenario
        get_bus().emit(
            "load_scenario", sink=self.metrics_path, **sc.header()
        )
        arrivals = list(sc.requests)
        budget = (
            max_ticks if max_ticks is not None
            else self._budget(arrivals)
        )
        fleet = self.fleet
        clock = self.clock
        i = 0
        wall = 0.0   # observer time: max event time seen so far
        idle_jumps = 0
        while True:
            if self.kill_at is not None and not self._killed \
                    and self.ticks >= self.kill_at:
                live = [
                    r for r in fleet.live if r.responsive
                ]
                if live:
                    # The busiest responsive replica dies (max
                    # in-flight exercises redispatch the hardest; tie
                    # -> lowest idx). With nothing live at this tick,
                    # keep trying -- the kill stays armed, and the
                    # end-of-drive check catches a kill that never
                    # landed.
                    victim = max(
                        live, key=lambda r: (r.load, -r.idx)
                    )
                    fleet.kill(victim.idx)
                    self._killed = True
            if self.swap_at is not None and not self._published \
                    and self.ticks >= self.swap_at:
                fleet.publish_weights(
                    self.swap_weights, checksums=self.swap_checksums,
                )
                self._published = True
            fleet.check_health(wall)
            fleet.advance_swap(wall)

            busy = [
                r for r in fleet.replicas
                if r.status in (LIVE, DRAINING, SWAPPING)
                and r.responsive and r.busy
            ]
            t_busy = (
                min(r.t_local for r in busy) if busy else float("inf")
            )
            t_arr = (
                arrivals[i].arrival_ms / 1e3 if i < len(arrivals)
                else float("inf")
            )
            if t_arr == float("inf") and not busy:
                if fleet.has_stranded_work():
                    deadline = fleet.next_deadline(wall)
                    if deadline is None:
                        raise RuntimeError(
                            "fleet harness: stranded requests with "
                            "no recovery pending (restart budget "
                            "exhausted with no live replica?)"
                        )
                    idle_jumps += 1
                    if idle_jumps > budget:
                        raise RuntimeError(
                            "fleet harness: recovery loop did not "
                            f"converge within {budget} idle jumps"
                        )
                    wall = max(wall, deadline)
                    clock.jump_to(wall)
                    continue
                break
            if t_arr <= t_busy:
                clock.jump_to(t_arr)
                wall = max(wall, t_arr)
                self._submit_arrival(arrivals[i])
                i += 1
                continue
            if self.ticks >= budget:
                raise RuntimeError(
                    f"fleet harness did not drain within {budget} "
                    "ticks"
                )
            r = min(busy, key=lambda x: (x.t_local, x.idx))
            clock.jump_to(r.t_local)
            self.meter.tick_start_s = r.t_local
            prefill_before = r.engine.prefill_charged_s
            decode_before = r.batcher.stats["decode_steps"]
            r.batcher.step()
            fleet.sync_results(r)
            t_end = clock()
            decode_dur = (
                t_end - r.t_local
                - (r.engine.prefill_charged_s - prefill_before)
            )
            decoded = (
                r.batcher.stats["decode_steps"] > decode_before
            )
            r.t_local = t_end
            wall = max(wall, t_end)
            fleet.observe_tick(r, t_end, decoded, decode_dur)
            if self.telemetry is not None:
                self.telemetry.on_tick(
                    r, t_end, decoded, decode_dur, wall
                )
            # Autoscale observes per TICK (not per event-loop
            # iteration): an arrival burst must not flood the
            # occupancy window with pre-admission zeros and trigger a
            # spurious scale-down before the first decode.
            fleet.maybe_autoscale(wall, self.ticks)
            live = fleet.live
            self._occupancy.append(
                statistics.fmean(
                    x.batcher.occupancy for x in live
                ) if live else 0.0
            )
            self.ticks += 1
        # A mid-run update whose rollout outlived the traffic (or
        # whose last replica drained exactly at the end) completes on
        # the drained fleet: each replica takes TWO advances (one
        # marks it SWAPPING/drained, the next performs the swap),
        # plus one to finalize the version.
        for _ in range(2 * len(fleet.replicas) + 1):
            fleet.advance_swap(wall)
        # Vacuous-fault discipline (the parse_faults contract,
        # extended to scheduling): a kill or swap armed at a tick the
        # run never reached injected NOTHING, and the chaos test
        # reading this run would pass without its fault -- fail loudly
        # instead.
        if self.kill_at is not None and not self._killed:
            raise RuntimeError(
                f"replica_kill_at={self.kill_at} never fired: the "
                f"run drained after {self.ticks} tick(s) (or no live "
                "replica remained to kill) -- the chaos schedule "
                "must not pass vacuously"
            )
        if self.swap_at is not None and not self._published:
            raise RuntimeError(
                f"swap_at={self.swap_at} never fired: the run "
                f"drained after {self.ticks} tick(s) -- the mid-run "
                "model update must not pass vacuously"
            )
        self.wall = wall

    # -- aggregation ----------------------------------------------------
    def summarize(
        self, n_devices: int = 1, extra: Optional[dict] = None,
    ) -> dict:
        from tpu_hpc_torch.obs.quantiles import quantile

        m = self.meter
        summary = m.summary(n_devices=n_devices)
        tenants, slo_violations, _ = tenant_summary(self.scenario, m)
        occ = sorted(self._occupancy)
        fleet_block = self.fleet.fleet_summary()
        agg = self.fleet.aggregate_stats()
        first_engine = self.fleet.replicas[0].engine
        arrived = len(self.scenario.requests)
        finished = sum(m.finished_by.values())
        shed = sum(m.shed_by.values())
        summary.update(
            scenario=self.scenario.name,
            seed=self.scenario.seed,
            n_arrivals=arrived,
            tenants=tenants,
            shed=shed,
            queued=sum(m.queued_by.values()),
            slo_violations=slo_violations,
            occupancy_mean=(
                sum(occ) / len(occ) if occ else 0.0
            ),
            occupancy_p95=quantile(occ, 0.95),
            stall_events=sum(
                r.detector.stalls for r in self.fleet.replicas
            ),
            decode_steps=agg["decode_steps"],
            admitted=agg["admitted"],
            block_stalls=agg["block_stalls"],
            virtual_clock=True,
            kv_layout="paged",
            kv_block_size=first_engine.paged.block_size,
            kv_blocks=first_engine.paged.num_blocks,
            prefix_hit_rate=fleet_block["prefix_affinity_hit_rate"],
            prefix_affinity_hit_rate=(
                fleet_block["prefix_affinity_hit_rate"]
            ),
            # The zero-lost-requests contract, as a first-class
            # summary field: every arrival is finished or (floor-
            # class) shed; anything else is a lost request and the
            # chaos gate fails on it.
            lost_requests=arrived - finished - shed,
            fleet=fleet_block,
        )
        if self.telemetry is not None:
            summary["live"] = self.telemetry.finalize(
                self.fleet, self.wall
            )
        if extra:
            summary.update(extra)
        m.write_summary(summary)
        get_registry().emit_snapshot(sink=self.metrics_path)
        return summary


class FleetMeter(LoadMeter):
    """LoadMeter that tolerates redispatch rejoin: a replayed request
    keeps its ORIGINAL timeline (t_submit, committed token times), so
    TTFT and ITL quantiles describe what the client experienced --
    including the detection gap -- rather than restarting the clock
    at redispatch."""

    def submitted(self, rid: str) -> None:
        if rid in self.traces:
            return   # redispatch rejoin: never reset the timeline
        super().submitted(rid)

    def token(self, rid: str, first: bool = False) -> None:
        trace = self.traces[rid]
        if first and trace.t_first is not None:
            # The replay's "first" token is the continuation of an
            # already-started stream: meter it as an ordinary token
            # (its ITL gap IS the failure-detection + re-prefill
            # cost, which the quantiles must carry honestly).
            first = False
        super().token(rid, first=first)
