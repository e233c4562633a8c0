"""Continuous batching: admit/evict requests at decode-step granularity.

Copied from the JAX package's ``serve/scheduler.py`` (it is framework
free), with its speculative-decoding tick, the seeded-sampling rule,
the per-request n-gram index (serve/spec.py) and the host-tier
prefetch-before-seat (serve/tier.py). The disaggregated engine's
transfer stats are left out with the module they drive
(``serve/disagg.py``, which waits on the reshard engine;
ROADMAP: "The operations modules").

The engine's decode program has a FIXED batch width (``slots``) -- the
discipline that keeps it one built shape. The scheduler makes
that width elastic in effect: every decode step it (1) evicts slots
whose request finished (hit ``max_new_tokens`` or EOS), (2) admits
waiting requests into the freed slots (one bucketed prefill each), and
(3) runs ONE decode step for all occupied slots. A long request never
stalls short ones behind it and a finished one never leaves its slot
idle -- the continuous-batching property, without ever changing a
compiled shape.

Slot invariants (pinned by tests/test_serve.py):
  * a slot's position counter equals prompt_len + tokens generated so
    far, resets on (re-)admission, and is what feeds RoPE in decode;
  * slot reuse is safe: the engine's per-slot length mask bounds every
    read to ``<= pos``, so a previous tenant's stale cache rows are
    unreachable;
  * generated tokens per request are independent of what shares the
    batch (each slot's attention sees only its own rows).

Admission control (:class:`AdmissionPolicy`) closes the telemetry
loop the obs spine opened: the occupancy gauge (``serve_active_slots``)
and the stall watermark (obs/stall.py, via ``stall_signal``) feed a
shed/queue decision per tick -- when every slot is busy and the
backlog exceeds ``queue_limit``, or the watermark trips, the batcher
sheds the lowest-priority tenant class instead of letting every
tenant's TTFT collapse together. Every decision is emitted as a
schema-stamped ``admission`` event so the report can attribute the
shed load per tenant class.

Paged engines (serve/paging.py, ``engine.is_paged``) change what
"capacity" means: admission budgets KV **pages**, not slots. The
batcher drives the paged protocol -- ``admit`` (page reservation +
prefix-trie lookup), ``prefill_step`` (one block-aligned chunk per
tick per prefilling slot, interleaved with decode so a long admission
never stalls in-flight ITL), ``release`` on eviction -- and both the
occupancy the policy reads and the shed decisions consult the
allocator: a tick where a free slot exists but the pool cannot seat
the head-of-queue request counts as a ``block_stall`` (the request
stays queued; the overflow/watermark rules above still bound the
backlog). ``submit()`` keeps the fail-at-submit discipline only for
the truly unservable: prompt + max_new exceeding the total page
budget raises a typed error naming both numbers
(paging.UnservableRequestError).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np

from tpu_hpc_torch.obs import activate, emit_span, get_bus, get_registry
from tpu_hpc_torch.obs.trace import (
    KIND_REQUEST,
    announce,
    new_context,
    request_trace_id,
)
from tpu_hpc_torch.serve.engine import Engine


def paged_drain_bound(engine, requests) -> int:
    """Upper bound on the EXTRA ticks a paged engine can add to a
    drain of ``requests``: chunked prefill spreads each prompt over
    up to ceil(len/stride) ticks, and block stalls wait at most until
    in-flight requests free pages (trie eviction guarantees progress
    once the pool empties). One helper so the batcher's and the load
    harness's drain budgets cannot silently diverge."""
    requests = list(requests)
    paged = getattr(engine, "paged", None)
    stride = getattr(paged, "prefill_chunk", 0) or None
    return sum(
        -(-len(r.prompt) // stride) if stride else 1
        for r in requests
    ) + 2 * len(requests)


@dataclasses.dataclass
class Request:
    """One generation request: prompt token ids + a stop condition.

    ``tenant``/``priority`` classify the request for multi-tenant
    admission control: higher ``priority`` admits first and sheds
    last. The defaults make single-tenant callers policy-free.

    ``temperature``/``top_p``/``seed`` are the per-request sampling
    contract (serve/spec.py): temperature 0 is greedy (the default --
    byte-exact against the no-cache oracle); temperature > 0 samples
    with top-p nucleus filtering under a seeded key that folds in
    (request seed, position) only, so the stream replays identically
    regardless of batch composition or slot reassignment. ``seed``
    None derives a stable seed from ``rid``. Sampling rides the
    speculative-decode path, so temperature > 0 needs a spec-attached
    paged engine (submit() enforces it)."""

    rid: str
    prompt: List[int]
    max_new_tokens: int = 16
    eos_id: Optional[int] = None
    tenant: str = "default"
    priority: int = 0
    temperature: float = 0.0
    top_p: float = 1.0
    seed: Optional[int] = None

    def __post_init__(self):
        if not self.prompt:
            raise ValueError(f"request {self.rid!r}: empty prompt")
        if self.max_new_tokens < 1:
            raise ValueError(
                f"request {self.rid!r}: max_new_tokens must be >= 1"
            )
        if self.temperature < 0:
            raise ValueError(
                f"request {self.rid!r}: temperature must be >= 0"
            )
        if not 0.0 < self.top_p <= 1.0:
            raise ValueError(
                f"request {self.rid!r}: top_p must be in (0, 1]"
            )


@dataclasses.dataclass(frozen=True)
class AdmissionPolicy:
    """Shed/queue policy over the occupancy gauge + stall watermark.

    ``queue_limit``: backlog tolerated while every slot is busy;
    beyond it, the newest lowest-priority requests are shed until the
    backlog fits (bounded queues, not unbounded TTFT).
    ``occupancy_high``: occupancy fraction at/above which the backlog
    limit applies (below it, free slots will drain the queue anyway).
    ``shed_on_stall``: when the stall watermark trips (decode ticks
    running >= factor x their own recent median -- a colocated train
    step, a straggling host), shed the entire lowest-priority pending
    class to protect the higher classes' SLOs.
    """

    queue_limit: int = 32
    occupancy_high: float = 1.0
    shed_on_stall: bool = True

    def __post_init__(self):
        if self.queue_limit < 0:
            raise ValueError(
                f"queue_limit {self.queue_limit} must be >= 0"
            )
        if not 0.0 < self.occupancy_high <= 1.0:
            raise ValueError(
                f"occupancy_high {self.occupancy_high} must be in (0, 1]"
            )


@dataclasses.dataclass
class _Slot:
    """Host-side view of one batch slot."""

    rid: Optional[str] = None
    pos: int = 0          # next cache write position == tokens held
    last_token: int = 0   # the token the next decode step consumes
    remaining: int = 0    # new tokens still to generate
    prefilling: bool = False  # paged: prompt chunks still running

    @property
    def free(self) -> bool:
        return self.rid is None

    @property
    def decoding(self) -> bool:
        return self.rid is not None and not self.prefilling


class ContinuousBatcher:
    """Drives an :class:`Engine` over a request stream.

    ``meter`` (serve/metrics.ServeMeter, optional) gets the
    admit/first-token/token/finish callbacks for TTFT and inter-token
    latency accounting. ``policy`` (AdmissionPolicy, optional) turns
    on admission control; ``stall_signal`` (callable -> bool,
    optional) is its watermark input -- the load harness wires it to
    an obs.StallDetector over tick durations. ``results[rid]``
    accumulates each request's generated tokens; ``stats`` counts
    admissions, evictions, decode steps and sheds (the slot-reuse and
    shed-load evidence the tests read).

    Scope note: per-request host state (``results``, the request
    table, the meter's traces) is retained for the life of the
    batcher -- right for the bounded replay windows this repo drives
    (the caller owns the results dict), but an indefinitely-running
    deployment should recreate the batcher per replay window or drain
    ``results`` between windows rather than let one instance
    accumulate forever.
    """

    def __init__(
        self,
        engine: Engine,
        meter=None,
        policy: Optional[AdmissionPolicy] = None,
        stall_signal: Optional[Callable[[], bool]] = None,
    ):
        self.engine = engine
        self.meter = meter
        self.policy = policy
        self.stall_signal = stall_signal
        self._paged = bool(getattr(engine, "is_paged", False))
        self._spec = getattr(engine, "spec", None) is not None
        self.slots = [_Slot() for _ in range(engine.serve_cfg.slots)]
        self.pending: List[Request] = []
        self.results: Dict[str, List[int]] = {}
        self.stats = {
            "admitted": 0, "evicted": 0, "decode_steps": 0, "shed": 0,
        }
        if self._paged:
            self.stats["block_stalls"] = 0
        self._requests: Dict[str, Request] = {}
        self._order: Dict[str, int] = {}  # rid -> submission sequence
        # Per-tenant acceptance evidence ("per request class" in the
        # obs registry): the batcher is the one layer that knows both
        # the tenant and the per-slot verify outcome.
        self.spec_by_tenant: Dict[str, Dict[str, int]] = {}
        # rid -> incremental prompt-lookup index (ngram mode only):
        # the batcher commits every token, so it is the one layer
        # that can keep proposals O(1) in history length instead of
        # rescanning prompt+results per slot per tick.
        self._spec_ngram = (
            self._spec and engine.spec.cfg.mode == "ngram"
        )
        self._ngram_idx: Dict[str, Any] = {}
        # rid -> derived sampling seed, computed ONCE at submit (the
        # crc32 derivation would otherwise rerun per slot per tick on
        # the decode hot path).
        self._seeds: Dict[str, int] = {}
        # Causal tracing (obs/trace.py): trace ids are a pure
        # function of (run_id, rid), so the batcher derives them on
        # demand (request_trace_id) instead of caching a second copy
        # of what the meter already holds. The batcher is the one
        # layer that knows which request an engine call serves, so
        # it activates the request's context around
        # admit/prefill/release -- engine spans and
        # kv_block/kv_transfer ring events join the trace ambiently
        # -- and emits meter-clock "prefill_chunk"/"admit" spans the
        # critical-path analyzer attributes TTFT with.
        # Durations for the trace spans come from the meter's clock
        # (virtual on loadgen runs, so seeded replays stay
        # bit-identical; monotonic wall otherwise).
        self._clock = (
            meter.clock if meter is not None else time.perf_counter
        )
        get_registry().describe(
            "serve_active_slots",
            "Batch slots currently held by live requests",
        )
        # The occupancy gauge exists (at 0) from bring-up: a scraper
        # must distinguish "serving, idle" from "no batcher yet".
        self._set_occupancy()

    # -- queue ---------------------------------------------------------
    def submit(self, request: Request) -> None:
        if request.rid in self._requests:
            raise ValueError(f"duplicate request id {request.rid!r}")
        cap = self.engine.serve_cfg.max_seq_len
        if len(request.prompt) + request.max_new_tokens > cap:
            raise ValueError(
                f"request {request.rid!r}: prompt "
                f"{len(request.prompt)} + max_new "
                f"{request.max_new_tokens} exceeds cache capacity {cap}"
            )
        # Validate the truly-unservable NOW: failing at admission time
        # (mid-drain) would abort every other in-flight request's
        # partial results for one oversized prompt. Paged engines
        # budget pages (with chunked prefill a prompt longer than the
        # largest bucket is perfectly servable); the slab keeps the
        # bucket check.
        if self._paged:
            self.engine.validate_request(
                len(request.prompt), request.max_new_tokens,
                rid=request.rid,
            )
        else:
            self.engine.serve_cfg.bucket_for(len(request.prompt))
        if request.temperature > 0 and not self._spec:
            # Sampling rides the speculative path (the verify program
            # with zero drafts IS the sampled single-token decode);
            # silently serving a sampled request greedily would be a
            # correctness lie, so fail at submit like the capacity
            # checks do.
            raise ValueError(
                f"request {request.rid!r}: temperature "
                f"{request.temperature} needs a speculative engine "
                "(serve/spec.py attach_spec; mode 'ngram' works "
                "without a draft checkpoint)"
            )
        self._requests[request.rid] = request
        self._order[request.rid] = len(self._order)
        # Trace birth: announce the id every later lifecycle event,
        # span and ring record for this request will carry.
        ctx = new_context(KIND_REQUEST, request.rid)
        announce(ctx, tenant=request.tenant, sink=self._sink())
        self.pending.append(request)
        if self._spec:
            from tpu_hpc_torch.serve.spec import derive_request_seed

            self._seeds[request.rid] = derive_request_seed(
                request.rid, request.seed
            )
        if self.meter is not None:
            self.meter.submitted(request.rid)

    def slot_positions(self) -> List[int]:
        """Per-slot position counters (the RoPE positions the next
        decode step will use); test hook for the slot invariants."""
        return [s.pos for s in self.slots]

    @property
    def active(self) -> int:
        return sum(1 for s in self.slots if not s.free)

    @property
    def occupancy(self) -> float:
        """The fraction of the scarce resource in use: slots for the
        slab engine; for paged engines the max of slot and PAGE
        occupancy -- a pool out of pages is saturated even with free
        slots (the admission policy's shed/queue input must see it)."""
        slot_occ = self.active / len(self.slots)
        if self._paged:
            return max(slot_occ, self.engine.block_occupancy)
        return slot_occ

    @property
    def done(self) -> bool:
        return not self.pending and self.active == 0

    def _set_occupancy(self) -> None:
        # Occupancy is THE continuous-batching health number: a low
        # gauge under queued load means admission is starving decode.
        # Updated on EVERY transition (admit, evict, bring-up) so the
        # gauge equals the live slot count at any instant, not just
        # after the last decode step.
        get_registry().set_gauge("serve_active_slots", self.active)

    def _next_pending(self) -> Request:
        """Highest priority first, submission order within a class --
        plain FIFO when every request carries the default priority."""
        best = min(
            self.pending,
            key=lambda r: (-r.priority, self._order[r.rid]),
        )
        self.pending.remove(best)
        return best

    # -- admission control --------------------------------------------
    def _shed(self, req: Request, reason: str, occupancy: float) -> None:
        self.pending.remove(req)
        self.stats["shed"] += 1
        reg = get_registry()
        reg.inc("serve_shed_total")
        if self.meter is not None:
            # request_shed is part of the meter PROTOCOL (base
            # ServeMeter implements it): a meter missing it fails
            # loudly here instead of silently losing shed telemetry
            # -- the old hasattr duck-check let a typo'd override
            # ride through and the shed counts vanish.
            self.meter.request_shed(req.rid, reason=reason)
        get_bus().emit(
            "admission",
            sink=self._sink(),
            action="shed",
            rid=req.rid,
            trace_id=request_trace_id(req.rid),
            tenant=req.tenant,
            occupancy=occupancy,
            pending=len(self.pending),
            reason=reason,
        )

    def _sink(self) -> Optional[str]:
        # Admission decisions land in the same JSONL the meter writes,
        # so one file tells the whole story.
        return getattr(self.meter, "metrics_path", None)

    def _admission_control(self) -> None:
        """One policy pass per tick, BEFORE admissions: bound the
        backlog while saturated; dump the lowest class on a watermark
        trip; record who is left queueing."""
        if self.policy is None or not self.pending:
            return
        occupancy = self.occupancy
        saturated = occupancy >= self.policy.occupancy_high
        # The backlog that actually queues excludes what the admit
        # loop will seat THIS tick: with occupancy_high < 1 a tick
        # can be "saturated" while slots are free, and shedding a
        # request a free slot would serve is pure waste (review
        # finding).
        free = len(self.slots) - self.active
        backlog = len(self.pending) - free
        if saturated and backlog > self.policy.queue_limit:
            overflow = backlog - self.policy.queue_limit
            # Newest of the lowest class go first: oldest requests
            # have already paid the most queue time (shedding them
            # wastes the wait), and higher classes are shed only when
            # the lowest is exhausted.
            victims = sorted(
                self.pending,
                key=lambda r: (r.priority, -self._order[r.rid]),
            )[:overflow]
            for req in victims:
                self._shed(req, "queue_overflow", occupancy)
        if (
            self.policy.shed_on_stall
            and self.pending
            and self.stall_signal is not None
            and self.stall_signal()
        ):
            low = min(r.priority for r in self.pending)
            high = max(r.priority for r in self.pending)
            # Shedding is class PROTECTION: dump the lowest waiting
            # class so a higher one keeps its SLO through the stall.
            # A homogeneous backlog has nobody to protect -- it rides
            # the stall out queued (the overflow rule above still
            # bounds it).
            if low < high:
                victims = [
                    r for r in self.pending if r.priority == low
                ]
                for req in victims:
                    self._shed(req, "stall_watermark", occupancy)
        if saturated and self.pending:
            by_tenant: Dict[str, int] = {}
            for r in self.pending:
                by_tenant[r.tenant] = by_tenant.get(r.tenant, 0) + 1
            get_bus().emit(
                "admission",
                sink=self._sink(),
                action="queue",
                occupancy=occupancy,
                pending=len(self.pending),
                by_tenant=by_tenant,
            )

    # -- one decode-granularity tick ----------------------------------
    def _admit_slab(self, idx: int, slot: _Slot) -> bool:
        req = self._next_pending()
        tid = request_trace_id(req.rid)
        if self.meter is not None:
            self.meter.admitted(
                req.rid,
                prefill_tokens=self.engine.serve_cfg.bucket_for(
                    len(req.prompt)
                ),
            )
        # The request's context is ambient for the engine call (its
        # internal prefill span joins the trace); the meter-clock
        # duration lands as this request's one prefill chunk.
        t0 = self._clock()
        with activate(tid):
            first = self.engine.prefill(idx, req.prompt)
        emit_span(
            "prefill_chunk", self._clock() - t0, sink=self._sink(),
            trace_id=tid, slot=idx,
        )
        self.stats["admitted"] += 1
        get_registry().inc("serve_admitted_total")
        slot.rid = req.rid
        slot.pos = len(req.prompt)
        slot.last_token = first
        slot.remaining = req.max_new_tokens - 1
        self._set_occupancy()
        self.results[req.rid] = [first]
        self._track_ngram(req, first)
        if self.meter is not None:
            self.meter.token(req.rid, first=True)
        if slot.remaining == 0 or first == req.eos_id:
            self._evict(idx, slot)
        return True

    def _track_ngram(self, req: Request, first: int) -> None:
        """Seed the request's incremental prompt-lookup index with
        prompt + first token (exactly the ``prompt + results`` history
        the rescan used to rebuild per tick)."""
        if not self._spec_ngram:
            return
        from tpu_hpc_torch.serve.spec import NgramIndex

        spec = self.engine.spec
        index = NgramIndex(req.prompt, max_n=spec.cfg.ngram)
        index.append(first)
        self._ngram_idx[req.rid] = index

    def _block_stall(self, req: Request, tid: str, reason: str) -> None:
        """Re-queue a page-short request (FIFO within its class --
        skipping ahead to a smaller request would starve the large one
        forever) and count the tick as a block stall."""
        self.pending.append(req)  # _order keeps its place
        self.stats["block_stalls"] += 1
        get_registry().inc("serve_block_stalls_total")
        get_bus().emit(
            "admission",
            sink=self._sink(),
            action="block_stall",
            rid=req.rid,
            trace_id=tid,
            tenant=req.tenant,
            occupancy=self.occupancy,
            pending=len(self.pending),
            reason=reason,
        )

    def _admit_paged(self, idx: int, slot: _Slot) -> bool:
        """Seat the head-of-queue request if the page pool can hold
        it; on a transient page shortage the request stays queued
        (FIFO within its class -- skipping ahead to a smaller request
        would starve the large one forever) and the tick is counted
        as a block stall. Returns False to stop this tick's admission
        loop on a stall."""
        from tpu_hpc_torch.serve.paging import BlockBudgetError

        req = self._next_pending()
        tid = request_trace_id(req.rid)
        sampling = None
        if self._spec:
            sampling = (
                self._seeds[req.rid], req.temperature, req.top_p,
            )
        # Host-tier prefetch-before-seat: refill this prompt's spilled
        # prefix pages WHILE the request is still queued, so the
        # host->device hop hides behind queueing instead of stretching
        # TTFT. Gated on a cheap headroom pre-check -- a request that
        # is about to block-stall anyway must not burn the hop (it
        # would re-pay it on every stalled tick).
        if getattr(self.engine, "host_tier", None) is not None:
            if not self.engine.admission_headroom(
                req.prompt, req.max_new_tokens
            ):
                self._block_stall(req, tid, "kv_pool_exhausted")
                return False
            with activate(tid):
                self.engine.prefetch_prompt(req.prompt)
        t0 = self._clock()
        try:
            # The request's trace is ambient, so page allocations and
            # prefix-hit events inside correlate to it.
            with activate(tid):
                if sampling is not None:
                    info = self.engine.admit(
                        idx, req.prompt, req.max_new_tokens,
                        sampling=sampling,
                    )
                else:
                    info = self.engine.admit(
                        idx, req.prompt, req.max_new_tokens
                    )
        except BlockBudgetError:
            self._block_stall(req, tid, "kv_pool_exhausted")
            return False
        emit_span(
            "admit", self._clock() - t0, sink=self._sink(),
            trace_id=tid, slot=idx,
        )
        slot.rid = req.rid
        slot.prefilling = True
        slot.pos = 0
        slot.remaining = req.max_new_tokens
        self.stats["admitted"] += 1
        get_registry().inc("serve_admitted_total")
        self._set_occupancy()
        if self.meter is not None:
            self.meter.admitted(
                req.rid,
                prefill_tokens=info["planned_prefill_tokens"],
            )
        return True

    def _prefill_tick(self) -> None:
        """Advance every prefilling slot by ONE chunk -- the
        interleave that keeps a long admission from stalling in-flight
        decode ITL. A slot whose last chunk completes yields its first
        token and joins the decode batch next tick."""
        for idx, slot in enumerate(self.slots):
            if slot.free or not slot.prefilling:
                continue
            tid = request_trace_id(slot.rid)
            t0 = self._clock()
            with activate(tid):
                first = self.engine.prefill_step(idx)
            emit_span(
                "prefill_chunk", self._clock() - t0,
                sink=self._sink(), trace_id=tid, slot=idx,
            )
            if first is None:
                continue
            req = self._requests[slot.rid]
            slot.prefilling = False
            slot.pos = len(req.prompt)
            slot.last_token = first
            slot.remaining = req.max_new_tokens - 1
            self.results[req.rid] = [first]
            self._track_ngram(req, first)
            if self.meter is not None:
                self.meter.token(req.rid, first=True)
            if slot.remaining == 0 or first == req.eos_id:
                self._evict(idx, slot)

    def step(self) -> None:
        """Apply admission policy, admit into free slots, advance
        prefill chunks (paged), then one decode step for all."""
        self._admission_control()
        for idx, slot in enumerate(self.slots):
            if not slot.free or not self.pending:
                continue
            if self._paged:
                if not self._admit_paged(idx, slot):
                    break
            else:
                self._admit_slab(idx, slot)
        if self._paged:
            self._prefill_tick()

        if not any(s.decoding for s in self.slots):
            return
        if self._spec:
            self._spec_tick()
            return
        tokens = [s.last_token for s in self.slots]
        positions = [s.pos for s in self.slots]
        if self._paged:
            out = self.engine.decode(
                tokens, positions,
                active=[s.decoding for s in self.slots],
            )
        else:
            out = self.engine.decode(tokens, positions)
        self.stats["decode_steps"] += 1
        get_registry().inc("serve_decode_steps_total")
        for idx, (slot, tok) in enumerate(
            zip(self.slots, np.asarray(out))
        ):
            if not slot.decoding:
                continue
            req = self._requests[slot.rid]
            tok = int(tok)
            self.results[slot.rid].append(tok)
            if self.meter is not None:
                self.meter.token(slot.rid)
            slot.pos += 1
            slot.last_token = tok
            slot.remaining -= 1
            if slot.remaining == 0 or tok == req.eos_id:
                self._evict(idx, slot)

    def _spec_tick(self) -> None:
        """One speculative decode tick (serve/spec.py): every decoding
        slot drafts up to ``min(k, remaining - 1)`` candidates and the
        target verifies all of them in ONE batched forward; the
        accepted prefix plus the corrected/bonus token commit as this
        tick's emissions. One tick still counts ONE decode step --
        that is the latency win the ITL quantiles measure."""
        slots = self.slots
        spec = self.engine.spec
        k = spec.cfg.k
        # Proposals feed the prompt-lookup draft source only; the
        # draft-model path never reads them (the decode hot path).
        ngram = self._spec_ngram
        tokens, positions, active, n_valid = [], [], [], []
        seeds, temps, top_ps, proposals = [], [], [], []
        for s in slots:
            active.append(s.decoding)
            tokens.append(s.last_token)
            positions.append(s.pos)
            if s.decoding:
                req = self._requests[s.rid]
                n_valid.append(min(k, s.remaining - 1))
                seeds.append(self._seeds[req.rid])
                temps.append(req.temperature)
                top_ps.append(req.top_p)
                # Each request's OWN incremental n-gram index (prompt
                # + emitted) proposes -- per request, so batch
                # composition cannot leak in, and O(1) in history
                # length where the rescan was O(T) per slot per tick.
                proposals.append(
                    self._ngram_idx[s.rid].propose(k) if ngram
                    else []
                )
            else:
                n_valid.append(0)
                seeds.append(0)
                temps.append(0.0)
                top_ps.append(1.0)
                proposals.append([])
        out, n_acc, drafted = self.engine.spec_decode(
            tokens, positions, active, n_valid, seeds, temps, top_ps,
            proposals=proposals if ngram else None,
        )
        self.stats["decode_steps"] += 1
        reg = get_registry()
        reg.inc("serve_decode_steps_total")
        for idx, slot in enumerate(slots):
            if not slot.decoding:
                continue
            req = self._requests[slot.rid]
            t = self.spec_by_tenant.setdefault(
                req.tenant, {"drafted": 0, "accepted": 0}
            )
            t["drafted"] += int(drafted[idx])
            t["accepted"] += int(n_acc[idx])
            reg.inc(
                f"serve_spec_drafted_{req.tenant}_total",
                int(drafted[idx]),
            )
            reg.inc(
                f"serve_spec_accepted_{req.tenant}_total",
                int(n_acc[idx]),
            )
            index = self._ngram_idx.get(slot.rid)
            for tok in out[idx, :int(n_acc[idx]) + 1]:
                tok = int(tok)
                self.results[slot.rid].append(tok)
                if index is not None:
                    index.append(tok)
                if self.meter is not None:
                    self.meter.token(slot.rid)
                slot.pos += 1
                slot.last_token = tok
                slot.remaining -= 1
                if slot.remaining == 0 or tok == req.eos_id:
                    # EOS inside an accepted run truncates the stream
                    # exactly where non-speculative decode would have
                    # stopped -- the tail beyond it is discarded.
                    self._evict(idx, slot)
                    break

    def _evict(self, idx: int, slot: _Slot) -> None:
        if self.meter is not None:
            self.meter.finished(slot.rid)
        self._ngram_idx.pop(slot.rid, None)
        if self._paged:
            # Page frees join the request's trace (the ambient stamp
            # covers the engine's ring-only kv_block events).
            with activate(request_trace_id(slot.rid)):
                self.engine.release(idx)
        self.stats["evicted"] += 1
        slot.rid = None
        slot.remaining = 0
        slot.prefilling = False
        slot.pos = 0
        self._set_occupancy()
        # last_token is reset on the next admission; stale cache
        # contents are safe because the length mask bounds reads (and
        # paged release returned the pages to the pool).

    # -- drain ---------------------------------------------------------
    def run(
        self,
        requests: Sequence[Request] = (),
        max_steps: Optional[int] = None,
        tick=None,
    ) -> Dict[str, List[int]]:
        """Submit ``requests`` and step until every request finished
        (or was shed). ``tick(step_index)`` is the liveness hook (the
        replay server wires the resilience heartbeat here). Returns
        ``{rid: generated tokens}``."""
        for r in requests:
            self.submit(r)
        steps = 0
        if max_steps is not None:
            budget = max_steps
        else:
            # Worst case: every request runs its full length alone.
            budget = (
                sum(r.max_new_tokens + 1
                    for r in self._requests.values())
                + len(self._requests) + 1
            )
            if self._paged:
                budget += paged_drain_bound(
                    self.engine, self._requests.values()
                )
        while not self.done:
            if steps >= budget:
                raise RuntimeError(
                    f"batcher did not drain within {budget} steps "
                    f"({self.active} active, {len(self.pending)} pending)"
                )
            self.step()
            if tick is not None:
                tick(steps)
            steps += 1
        # Replay shutdown: the gauge must read the true (empty) state
        # even if the last transition was shed-from-pending (which
        # never touches a slot).
        self._set_occupancy()
        # Paged engines count prefix hits, prefill chunks and CoW
        # copies; fold them in so the replay summary carries them.
        paged = getattr(self.engine, "paged_stats", None)
        if paged:
            self.stats.update(paged)
        # Host-tier engines count page spills/refills and the wire
        # bytes they moved; fold them in so the serve summary carries
        # the tier's load.
        tier = getattr(self.engine, "host_tier", None)
        if tier is not None:
            self.stats.update(tier.stats)
        # Speculative engines count drafts/accepts per verify step;
        # fold the counts (deterministic -- draft wall time stays out
        # of the batcher stats so virtual-clock replays stay
        # byte-identical).
        spec = getattr(self.engine, "spec", None)
        if spec is not None:
            self.stats.update(spec.stats)
        return self.results


def replay_requests(
    n_requests: int,
    vocab_size: int,
    prompt_lens: Sequence[int],
    max_new_tokens: int,
    seed: int = 0,
    temperature: float = 0.0,
    top_p: float = 1.0,
) -> List[Request]:
    """Deterministic synthetic request mix for the replay server and
    benches: random prompts cycling through ``prompt_lens`` (so every
    prefill bucket gets traffic). ``temperature``/``top_p`` sample
    the whole mix under per-request seeds derived from the rid --
    still fully deterministic (the seeded-sampling contract)."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n_requests):
        n = int(prompt_lens[i % len(prompt_lens)])
        out.append(Request(
            rid=f"r{i:04d}",
            prompt=rng.integers(0, vocab_size, size=n).tolist(),
            max_new_tokens=max_new_tokens,
            temperature=temperature,
            top_p=top_p,
        ))
    return out
