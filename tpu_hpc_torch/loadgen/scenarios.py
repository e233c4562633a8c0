"""Seeded scenario catalog: reproducible serving traffic mixes.

Copied from the JAX package's ``loadgen/scenarios.py`` (numpy only),
building the port's ``serve.scheduler.Request``; the catalog and every
draw are unchanged, so a (name, seed, knobs) triple gives the same
requests in both packages.

Every scenario is generated from ONE ``numpy.random.default_rng(seed)``
stream, so the same (name, seed, knobs) always yields byte-identical
request lists -- the reproducibility the regress gate
(obs/regress.py) needs to call two runs of the same scenario
"the same workload". The catalog covers the traffic shapes the
DDP/FSDP characterization study (arxiv 2505.12832) argues systems must
be judged under -- measured distributions, not the single steady
replay `python -m tpu_hpc_torch.serve` ships:

* ``steady``            Poisson arrivals, near-uniform lengths;
* ``bursty``            on/off bursts (B requests at burst rate, then
                        silence) -- queue-depth stress;
* ``heavy_tail``        lognormal prompt/output lengths clipped to the
                        engine's buckets -- slot-occupancy skew;
* ``multi_tenant``      three tenant classes (interactive/batch/
                        background) with priorities and per-tenant
                        SLOs;
* ``saturating_burst``  everything arrives at once, far past slot
                        capacity -- the admission-control acceptance
                        scenario (the lowest class MUST shed);
* ``colocate``          steady serving while a colocated training job
                        periodically steals the chip -- the stall
                        watermark's admission input;
* ``shared_prefix``     multi-tenant with a common per-tenant system
                        prompt and heavy-tail suffixes -- the paged
                        engine's prefix-reuse acceptance scenario
                        (serve/paging.py);
* ``decode_heavy``      chat-style short prompts with near-full
                        generation budgets -- the decode-bound mix
                        where ITL (not TTFT) is the product metric,
                        and the speculative-decoding acceptance
                        scenario (serve/spec.py): the prefill-bound
                        mixes above cannot show a decode-side win;
* ``diurnal``           day/night traffic: a sinusoidally-modulated
                        arrival rate (peaks oversubscribe a minimal
                        replica set, troughs idle it) over three
                        tenant classes with per-tenant system
                        prompts -- the serving-fleet acceptance
                        scenario (serve/fleet.py): autoscale rides
                        the swings, prefix affinity rides the
                        prompts, and the chaos harness injects a
                        mid-run weight swap + replica kill on top;
* ``long_idle_sessions`` returning chat users: first visits cache
                        their prompts, a filler wave floods the page
                        pool while the chatters idle, then everyone
                        returns at once -- the host-DRAM tier's
                        acceptance scenario (serve/tier.py): an
                        HBM-only pool must shed the return wave, a
                        tiered pool (parked pages spilled, refilled
                        on return) must shed none.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Mapping, Optional, Tuple

import numpy as np

from tpu_hpc_torch.serve.scheduler import Request


# The per-tenant summary metrics an SLO may bound (what
# LoadHarness.summarize actually produces per tenant).
SLO_METRICS: Tuple[str, ...] = (
    "ttft_ms_p50", "ttft_ms_p95", "ttft_ms_p99",
    "itl_ms_p50", "itl_ms_p95",
)


@dataclasses.dataclass(frozen=True)
class TenantClass:
    """One traffic class: who it is, how much it sends, what it is
    owed. ``slo`` maps per-tenant summary metric names (the
    :data:`SLO_METRICS` set) to upper bounds in ms."""

    name: str
    priority: int = 0
    share: float = 1.0
    slo: Mapping[str, float] = dataclasses.field(default_factory=dict)

    def __post_init__(self):
        # Same discipline as parse_faults: a typoed SLO key that is
        # silently never violated would make every gate built on its
        # verdict vacuous.
        unknown = sorted(set(self.slo) - set(SLO_METRICS))
        if unknown:
            raise ValueError(
                f"tenant {self.name!r}: unknown SLO metric(s) "
                f"{unknown} (known: {', '.join(SLO_METRICS)})"
            )


@dataclasses.dataclass(frozen=True)
class LoadRequest:
    """One scheduled arrival: a serve Request plus its arrival time
    (ms on the harness clock)."""

    rid: str
    tenant: str
    priority: int
    arrival_ms: float
    prompt: Tuple[int, ...]
    max_new_tokens: int

    def to_request(self) -> Request:
        return Request(
            rid=self.rid,
            prompt=list(self.prompt),
            max_new_tokens=self.max_new_tokens,
            tenant=self.tenant,
            priority=self.priority,
        )


@dataclasses.dataclass(frozen=True)
class Scenario:
    """A fully materialized load scenario: the request schedule plus
    the policy/colocation knobs the harness consumes."""

    name: str
    seed: int
    tenants: Tuple[TenantClass, ...]
    requests: Tuple[LoadRequest, ...]
    # Admission backlog bound handed to serve.AdmissionPolicy.
    queue_limit: int = 32
    # Train+serve colocation: every `colocate_every` ticks the
    # harness charges `colocate_train_ms` of virtual time to a
    # colocated training step (0 = no colocation).
    colocate_train_ms: float = 0.0
    colocate_every: int = 0

    def tenant(self, name: str) -> TenantClass:
        for t in self.tenants:
            if t.name == name:
                return t
        raise KeyError(name)

    def header(self) -> dict:
        """The ``load_scenario`` record the harness emits first."""
        return {
            "scenario": self.name,
            "seed": self.seed,
            "n_requests": len(self.requests),
            "queue_limit": self.queue_limit,
            "colocate_train_ms": self.colocate_train_ms,
            "colocate_every": self.colocate_every,
            "tenants": {
                t.name: {
                    "priority": t.priority,
                    "share": t.share,
                    "slo": dict(t.slo),
                }
                for t in self.tenants
            },
        }


# -- building blocks ---------------------------------------------------
def poisson_arrivals(
    rng: np.random.Generator, n: int, rate_per_s: float,
) -> np.ndarray:
    """Arrival times (ms) of a Poisson process: cumulative exponential
    inter-arrival gaps."""
    if rate_per_s <= 0:
        raise ValueError(f"rate_per_s {rate_per_s} must be > 0")
    gaps_s = rng.exponential(1.0 / rate_per_s, size=n)
    return np.cumsum(gaps_s) * 1e3


def onoff_arrivals(
    rng: np.random.Generator,
    n: int,
    burst_size: int,
    burst_rate_per_s: float,
    off_ms: float,
) -> np.ndarray:
    """On/off bursts: ``burst_size`` Poisson arrivals at the burst
    rate, then ``off_ms`` of silence, repeated."""
    if burst_size < 1:
        raise ValueError(f"burst_size {burst_size} must be >= 1")
    if burst_rate_per_s <= 0:
        raise ValueError(
            f"burst_rate_per_s {burst_rate_per_s} must be > 0"
        )
    if off_ms < 0:
        raise ValueError(f"off_ms {off_ms} must be >= 0")
    out: List[float] = []
    t = 0.0
    while len(out) < n:
        take = min(burst_size, n - len(out))
        gaps = rng.exponential(1.0 / burst_rate_per_s, size=take) * 1e3
        for g in gaps:
            t += g
            out.append(t)
        t += off_ms
    return np.asarray(out)


def heavy_tail_lengths(
    rng: np.random.Generator,
    n: int,
    median: float,
    sigma: float,
    lo: int,
    hi: int,
) -> np.ndarray:
    """Lognormal lengths (median ``median``, shape ``sigma``) clipped
    into [lo, hi] -- the heavy-tailed prompt/output distributions real
    serving traffic shows."""
    if not 1 <= lo <= hi:
        raise ValueError(f"bad length range [{lo}, {hi}]")
    vals = rng.lognormal(mean=np.log(median), sigma=sigma, size=n)
    return np.clip(np.rint(vals), lo, hi).astype(np.int64)


def _assemble(
    name: str,
    seed: int,
    rng: np.random.Generator,
    tenants: Tuple[TenantClass, ...],
    tenant_of: np.ndarray,       # index into tenants, per request
    arrival_ms: np.ndarray,
    prompt_lens: np.ndarray,     # SUFFIX lengths when prefixes given
    max_new: np.ndarray,
    vocab_size: int,
    prefixes: Optional[Mapping[str, Tuple[int, ...]]] = None,
    **scenario_kw,
) -> Scenario:
    order = np.argsort(arrival_ms, kind="stable")
    reqs = []
    for k, i in enumerate(order):
        t = tenants[int(tenant_of[i])]
        plen = int(prompt_lens[i])
        prefix = tuple(prefixes.get(t.name, ())) if prefixes else ()
        reqs.append(LoadRequest(
            rid=f"{name[:2]}{k:05d}",
            tenant=t.name,
            priority=t.priority,
            arrival_ms=float(arrival_ms[i]),
            prompt=prefix + tuple(
                int(x) for x in rng.integers(0, vocab_size, size=plen)
            ),
            max_new_tokens=int(max_new[i]),
        ))
    return Scenario(
        name=name, seed=seed, tenants=tenants, requests=tuple(reqs),
        **scenario_kw,
    )


def diurnal_arrivals(
    rng: np.random.Generator,
    n: int,
    rate_per_s: float,
    cycles: float = 2.0,
    trough_frac: float = 0.2,
) -> np.ndarray:
    """Nonhomogeneous Poisson arrivals whose rate swings
    sinusoidally between ``trough_frac * rate_per_s`` and
    ``rate_per_s`` over ``cycles`` full day/night cycles across the
    ``n`` arrivals -- thinning over a homogeneous process at the
    peak rate, so the schedule stays a pure function of the rng
    stream. The period is derived from the EXPECTED span of ``n``
    arrivals at the mean rate, so the same shape scales with ``n``."""
    if not 0.0 < trough_frac <= 1.0:
        raise ValueError(
            f"trough_frac {trough_frac} must be in (0, 1]"
        )
    if cycles <= 0:
        raise ValueError(f"cycles {cycles} must be > 0")
    if rate_per_s <= 0:
        raise ValueError(f"rate_per_s {rate_per_s} must be > 0")
    mean_rate = rate_per_s * (1.0 + trough_frac) / 2.0
    period_s = (n / mean_rate) / cycles
    out: List[float] = []
    t = 0.0
    while len(out) < n:
        t += rng.exponential(1.0 / rate_per_s)
        phase = 2.0 * np.pi * (t / period_s)
        # rate(t)/rate_max in [trough_frac, 1]; start at the peak so
        # the run opens under load (the autoscale-up case) and dips
        # mid-run (the drain-down case).
        accept_p = trough_frac + (1.0 - trough_frac) * (
            0.5 * (1.0 + np.cos(phase))
        )
        if rng.random() < accept_p:
            out.append(t * 1e3)
    return np.asarray(out)


# -- the catalog -------------------------------------------------------
def build_scenario(
    name: str,
    seed: int = 0,
    n_requests: int = 32,
    vocab_size: int = 512,
    max_prompt: int = 16,
    max_new: int = 8,
    rate_per_s: float = 40.0,
) -> Scenario:
    """Materialize catalog scenario ``name``. ``max_prompt`` must not
    exceed the engine's largest prefill bucket and ``max_prompt +
    max_new`` must fit its cache capacity -- the caller (server
    ``--loadgen``, bench, tests) aligns these with its ServeConfig."""
    if name not in SCENARIOS:
        raise ValueError(
            f"unknown scenario {name!r} (catalog: "
            f"{', '.join(sorted(SCENARIOS))})"
        )
    if n_requests < 1:
        raise ValueError(f"n_requests {n_requests} must be >= 1")
    if max_prompt < 2 or max_new < 2:
        raise ValueError(
            f"max_prompt {max_prompt} and max_new {max_new} must both "
            "be >= 2 (the catalog's length distributions need a range)"
        )
    rng = np.random.default_rng(seed)
    n = n_requests
    lo_p = min(2, max_prompt)

    if name == "steady":
        tenants = (TenantClass("default", priority=0, share=1.0),)
        return _assemble(
            name, seed, rng, tenants,
            tenant_of=np.zeros(n, np.int64),
            arrival_ms=poisson_arrivals(rng, n, rate_per_s),
            prompt_lens=rng.integers(lo_p, max_prompt + 1, size=n),
            max_new=rng.integers(2, max_new + 1, size=n),
            vocab_size=vocab_size,
        )

    if name == "bursty":
        tenants = (TenantClass("default", priority=0, share=1.0),)
        return _assemble(
            name, seed, rng, tenants,
            tenant_of=np.zeros(n, np.int64),
            arrival_ms=onoff_arrivals(
                rng, n, burst_size=max(4, n // 4),
                burst_rate_per_s=rate_per_s * 10, off_ms=250.0,
            ),
            prompt_lens=rng.integers(lo_p, max_prompt + 1, size=n),
            max_new=rng.integers(2, max_new + 1, size=n),
            vocab_size=vocab_size,
        )

    if name == "heavy_tail":
        tenants = (TenantClass("default", priority=0, share=1.0),)
        return _assemble(
            name, seed, rng, tenants,
            tenant_of=np.zeros(n, np.int64),
            arrival_ms=poisson_arrivals(rng, n, rate_per_s),
            prompt_lens=heavy_tail_lengths(
                rng, n, median=max(2.0, max_prompt / 4), sigma=1.0,
                lo=1, hi=max_prompt,
            ),
            max_new=heavy_tail_lengths(
                rng, n, median=max(2.0, max_new / 3), sigma=0.8,
                lo=1, hi=max_new,
            ),
            vocab_size=vocab_size,
        )

    if name in ("multi_tenant", "saturating_burst"):
        tenants = (
            TenantClass(
                "interactive", priority=2, share=0.5,
                slo={"ttft_ms_p95": 400.0, "itl_ms_p95": 60.0},
            ),
            TenantClass(
                "batch", priority=1, share=0.3,
                slo={"ttft_ms_p95": 2000.0},
            ),
            TenantClass("background", priority=0, share=0.2),
        )
        shares = np.array([t.share for t in tenants])
        tenant_of = rng.choice(
            len(tenants), size=n, p=shares / shares.sum()
        )
        # Interactive sends short prompts/outputs; batch and
        # background send long ones.
        short = tenant_of == 0
        prompt_lens = np.where(
            short,
            rng.integers(lo_p, max(lo_p, max_prompt // 2) + 1, size=n),
            heavy_tail_lengths(
                rng, n, median=max(2.0, max_prompt / 2), sigma=0.6,
                lo=1, hi=max_prompt,
            ),
        )
        max_new_arr = np.where(
            short,
            rng.integers(1, max(2, max_new // 2) + 1, size=n),
            rng.integers(max(1, max_new // 2), max_new + 1, size=n),
        )
        if name == "saturating_burst":
            # Everyone at (nearly) once, way past slot capacity; a
            # tight backlog bound forces the policy's hand.
            arrival_ms = np.sort(rng.uniform(0.0, 5.0, size=n))
            return _assemble(
                name, seed, rng, tenants, tenant_of, arrival_ms,
                prompt_lens, max_new_arr, vocab_size,
                queue_limit=max(2, n // 8),
            )
        return _assemble(
            name, seed, rng, tenants, tenant_of,
            poisson_arrivals(rng, n, rate_per_s),
            prompt_lens, max_new_arr, vocab_size,
        )

    if name == "shared_prefix":
        # Multi-tenant with a COMMON per-tenant system prompt: every
        # request of a tenant opens with the same token prefix (half
        # the prompt budget), followed by a heavy-tail suffix. On a
        # paged engine with the prefix trie this is the
        # cache-efficiency acceptance scenario -- hit rate and the
        # pages (and prefill FLOPs) it saves are the point; on a slab
        # engine it degrades to a valid heavy-tail mix, so the same
        # seeded schedule measures both layouts.
        tenants = (
            TenantClass(
                "assistant", priority=1, share=0.45,
                slo={"ttft_ms_p95": 800.0},
            ),
            TenantClass(
                "search", priority=1, share=0.35,
                slo={"ttft_ms_p95": 800.0},
            ),
            TenantClass("batch", priority=0, share=0.2),
        )
        sys_len = min(max(2, max_prompt // 2), max_prompt - 1)
        # One fixed system prompt per tenant, drawn ONCE from the same
        # stream -- (name, seed) stays byte-identical.
        prefixes = {
            t.name: tuple(
                int(x)
                for x in rng.integers(0, vocab_size, size=sys_len)
            )
            for t in tenants
        }
        shares = np.array([t.share for t in tenants])
        tenant_of = rng.choice(
            len(tenants), size=n, p=shares / shares.sum()
        )
        suffix_hi = max(1, max_prompt - sys_len)
        suffix_lens = heavy_tail_lengths(
            rng, n, median=max(2.0, suffix_hi / 3), sigma=0.8,
            lo=1, hi=suffix_hi,
        )
        return _assemble(
            name, seed, rng, tenants, tenant_of,
            poisson_arrivals(rng, n, rate_per_s),
            suffix_lens,
            heavy_tail_lengths(
                rng, n, median=max(2.0, max_new / 3), sigma=0.8,
                lo=1, hi=max_new,
            ),
            vocab_size,
            prefixes=prefixes,
        )

    if name == "decode_heavy":
        # Chat-style decode-bound traffic: prompts a fraction of the
        # budget, generation budgets near max_new -- the inverse of
        # heavy_tail's long-prompt/short-output skew. Here the decode
        # loop IS the latency (prefill is one short bucket per
        # request), so this is where speculative decoding's
        # tokens-per-verify win lands in the ITL quantiles.
        tenants = (TenantClass("chat", priority=0, share=1.0),)
        hi_p = max(lo_p, max_prompt // 4)
        return _assemble(
            name, seed, rng, tenants,
            tenant_of=np.zeros(n, np.int64),
            arrival_ms=poisson_arrivals(rng, n, rate_per_s),
            prompt_lens=rng.integers(lo_p, hi_p + 1, size=n),
            max_new=rng.integers(
                max(2, (3 * max_new) // 4), max_new + 1, size=n
            ),
            vocab_size=vocab_size,
        )

    if name == "diurnal":
        # Day/night swings over three classes WITH per-tenant system
        # prompts: the fleet acceptance scenario. ``background`` is
        # the SLO-class floor -- the only class the zero-shed-above-
        # the-floor contract allows admission control to drop under
        # pressure. Generous SLO bounds: the chaos runs this gates
        # (replica kill + weight swap mid-run) must breach them only
        # when failure handling actually regresses, not on ordinary
        # peak queueing.
        tenants = (
            TenantClass(
                "interactive", priority=2, share=0.45,
                slo={"ttft_ms_p95": 4000.0},
            ),
            TenantClass(
                "batch", priority=1, share=0.35,
                slo={"ttft_ms_p95": 12000.0},
            ),
            TenantClass("background", priority=0, share=0.2),
        )
        sys_len = min(max(2, max_prompt // 2), max_prompt - 1)
        prefixes = {
            t.name: tuple(
                int(x)
                for x in rng.integers(0, vocab_size, size=sys_len)
            )
            for t in tenants
        }
        shares = np.array([t.share for t in tenants])
        tenant_of = rng.choice(
            len(tenants), size=n, p=shares / shares.sum()
        )
        suffix_hi = max(1, max_prompt - sys_len)
        return _assemble(
            name, seed, rng, tenants, tenant_of,
            diurnal_arrivals(rng, n, rate_per_s),
            heavy_tail_lengths(
                rng, n, median=max(2.0, suffix_hi / 3), sigma=0.8,
                lo=1, hi=suffix_hi,
            ),
            rng.integers(2, max_new + 1, size=n),
            vocab_size,
            prefixes=prefixes,
        )

    if name == "long_idle_sessions":
        # Returning chat users: a wave of first visits caches its
        # prompts in the trie, a filler wave floods the page pool
        # while the chatters idle, then every chatter comes back at
        # once with its old prompt plus a short new turn. An
        # HBM-only pool evicted the parked prompts to seat the
        # fillers, so the return wave re-prefills from scratch,
        # drains slowly, and overflows the (tight) backlog bound --
        # returns shed. A host-tiered pool SPILLED the parked pages
        # instead; the return wave prefix-hits after a cheap
        # refill hop and drains fast -- zero returns shed. The
        # tenant split keeps the contrast measurable per class
        # (TTFT-on-return is ``tenants["return"]``'s quantiles).
        n_sessions = max(1, n // 3)
        n_fill = max(1, n // 3)
        n_return = max(1, n - n_sessions - n_fill)
        ret_suffix = max(1, min(max_new, max_prompt // 4))
        first_hi = max(lo_p, max_prompt - ret_suffix)
        first_lo = max(lo_p, first_hi // 2)
        tenants = (
            TenantClass("chat", priority=1, share=0.34),
            TenantClass("filler", priority=0, share=0.33),
            TenantClass("return", priority=1, share=0.33),
        )
        first_prompts = [
            tuple(
                int(x) for x in rng.integers(
                    0, vocab_size,
                    size=int(rng.integers(first_lo, first_hi + 1)),
                )
            )
            for _ in range(n_sessions)
        ]
        idle_gap_ms = 1000.0
        chat_arr = poisson_arrivals(rng, n_sessions, rate_per_s)
        fill_arr = (
            float(chat_arr.max()) + idle_gap_ms
            + poisson_arrivals(rng, n_fill, rate_per_s)
        )
        # The whole cohort returns in a tight wave (3x the base
        # rate): the drain-rate contrast (prefix hit vs full
        # re-prefill) is what decides whether the backlog bound
        # overflows.
        ret_arr = (
            float(fill_arr.max()) + idle_gap_ms
            + poisson_arrivals(rng, n_return, rate_per_s * 3)
        )
        reqs = []
        for i in range(n_sessions):
            reqs.append((
                "chat", 1, float(chat_arr[i]), first_prompts[i],
                int(rng.integers(2, max_new + 1)),
            ))
        for i in range(n_fill):
            plen = int(rng.integers(
                max(lo_p, (3 * max_prompt) // 4), max_prompt + 1
            ))
            reqs.append((
                "filler", 0, float(fill_arr[i]),
                tuple(
                    int(x)
                    for x in rng.integers(0, vocab_size, size=plen)
                ),
                int(rng.integers(2, max_new + 1)),
            ))
        for i in range(n_return):
            base = first_prompts[i % n_sessions]
            suffix = tuple(
                int(x)
                for x in rng.integers(0, vocab_size, size=ret_suffix)
            )
            reqs.append((
                "return", 1, float(ret_arr[i]), base + suffix,
                int(rng.integers(2, max_new + 1)),
            ))
        reqs.sort(key=lambda r: r[2])
        return Scenario(
            name=name, seed=seed, tenants=tenants,
            requests=tuple(
                LoadRequest(
                    rid=f"{name[:2]}{k:05d}",
                    tenant=t, priority=p, arrival_ms=a,
                    prompt=prompt, max_new_tokens=mn,
                )
                for k, (t, p, a, prompt, mn) in enumerate(reqs)
            ),
            # Tight backlog: the return wave must DRAIN, not park --
            # the shed-vs-zero-shed contrast is the acceptance
            # signal, and an unbounded queue would absorb it.
            queue_limit=max(2, n // 8),
        )

    assert name == "colocate"
    # Two classes: when the colocated train step trips the stall
    # watermark, admission control sheds `background` and the
    # `online` class keeps its SLO -- the class-protection property
    # the scenario exists to measure.
    tenants = (
        TenantClass(
            "online", priority=1, share=0.7,
            slo={"ttft_ms_p95": 600.0},
        ),
        TenantClass("background", priority=0, share=0.3),
    )
    shares = np.array([t.share for t in tenants])
    return _assemble(
        name, seed, rng, tenants,
        tenant_of=rng.choice(
            len(tenants), size=n, p=shares / shares.sum()
        ),
        arrival_ms=poisson_arrivals(rng, n, rate_per_s),
        prompt_lens=rng.integers(lo_p, max_prompt + 1, size=n),
        max_new=rng.integers(2, max_new + 1, size=n),
        vocab_size=vocab_size,
        # A 40 ms train step every 8 serve ticks: >3x a default 8 ms
        # decode tick, so the stall watermark trips by design.
        colocate_train_ms=40.0,
        colocate_every=8,
    )


SCENARIOS: Tuple[str, ...] = (
    "steady", "bursty", "heavy_tail", "multi_tenant",
    "saturating_burst", "colocate", "shared_prefix", "decode_heavy",
    "diurnal", "long_idle_sessions",
)
