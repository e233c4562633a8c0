"""The port's host-DRAM KV page tier against the JAX package's, on the CPU.

``tpu_hpc_torch.serve.tier.HostTier`` ports ``tpu_hpc.serve.tier``: the
spill of trie-parked pages before eviction, the prefetch-before-seat
refill, the bounded transfer groups sized by the comm planner, and the
tier block of ``paged_summary``. Held against the JAX tiered engine on
the JAX tier tests' TINY float32 model (JAX init, carried across):
tokens, spilled and refilled page ids and counts, the tier counters,
no build after warmup, ``reset_pool`` flushing the tier, the config
refusals, and ``long_idle_sessions`` through both load harnesses
without and with a tier. Then ``chip_smoke.py``'s ``serve_tier_fleet``
(a) gates and controls at a tiny width.
"""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax", reason="the JAX reference package")
jnp = jax.numpy

import chip_smoke
from tpu_hpc import loadgen as jlg
from tpu_hpc.models import llama2 as jl
from tpu_hpc.runtime import MeshSpec, build_mesh
from tpu_hpc.serve import ContinuousBatcher as JaxBatcher
from tpu_hpc.serve import PagedConfig as JaxPagedConfig
from tpu_hpc.serve import PagedEngine as JaxPagedEngine
from tpu_hpc.serve import Request as JaxRequest
from tpu_hpc.serve import ServeConfig as JaxServeConfig
from tpu_hpc.serve.tier import HostTier as JaxHostTier
from tpu_hpc_torch import loadgen as tlg
from tpu_hpc_torch.models import llama2 as tl
from tpu_hpc_torch.serve import (
    ContinuousBatcher,
    PagedConfig,
    PagedEngine,
    Request,
    ServeConfig,
    params_from_numpy,
)
from tpu_hpc_torch.serve.tier import HostTier

JAX_TINY = jl.LlamaConfig(
    dim=64, n_layers=2, n_heads=4, n_kv_heads=2, vocab_size=128,
    multiple_of=16, max_seq_len=64, dtype=jnp.float32,
)
TINY = tl.LlamaConfig(
    dim=64, n_layers=2, n_heads=4, n_kv_heads=2, vocab_size=128,
    multiple_of=16, max_seq_len=64, dtype=torch.float32,
)
SERVE = dict(slots=4, max_seq_len=48, prefill_buckets=(8, 16))
TIERED = dict(block_size=4, num_blocks=16, prefill_chunk=8, host_blocks=16)
# Summary fields that carry wall-clock hop times.
WALL_KEYS = ("kv_hop_ms_p50", "kv_hop_ms_p95")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def weights(devices):
    jp = jl.init_llama(jax.random.key(0), JAX_TINY)
    mesh = build_mesh(MeshSpec(axes={"data": 1}), devices=devices[:1])
    return jp, params_from_numpy(jax.device_get(jp), TINY, "cpu"), mesh


def _pair(weights, **paged):
    jp, tp, mesh = weights
    kw = dict(TIERED, **paged)
    j = JaxPagedEngine(jp, JAX_TINY, JaxServeConfig(**SERVE), mesh,
                       JaxPagedConfig(**kw))
    t = PagedEngine(tp, TINY, ServeConfig(**SERVE), "cpu", PagedConfig(**kw))
    return (j, j.warmup()), (t, t.warmup())


@pytest.fixture(scope="module")
def tiered(weights):
    """One tiered engine a side serves the round-trip tests in order:
    a 15-page pool over a 15-slot host tier."""
    return _pair(weights)


def _drain(side, engine, reqs):
    if side == "jax":
        b = JaxBatcher(engine)
        return b, b.run([JaxRequest(**r) for r in reqs])
    b = ContinuousBatcher(engine)
    return b, b.run([Request(**r) for r in reqs])


def _summary(engine):
    return {k: v for k, v in engine.paged_summary().items()
            if k not in WALL_KEYS}


def test_warmup_builds_the_tier_programs_in_the_engine_table(tiered):
    (j, jw), (t, tw) = tiered
    assert tw == jw == len(SERVE["prefill_buckets"]) + 2 + 2
    assert t.host_tier.group == j.host_tier.group
    assert t.host_tier.inflight_source == "planner"
    assert t.host_tier.max_inflight_bytes == j.host_tier.max_inflight_bytes
    assert t.host_tier.host_bytes == j.host_tier.host_bytes


def test_spill_refill_round_trip_matches_jax(tiered):
    """Serve, park, spill the WHOLE chain, return with the same prompt:
    the same tokens, the same host slots and refilled page ids, the
    same counters on both sides, and no build after warmup."""
    rng = np.random.default_rng(21)
    prompt = rng.integers(0, TINY.vocab_size, size=16).tolist()
    seen = {}
    for side, (eng, warmed) in zip(("jax", "port"), tiered):
        _, first = _drain(side, eng, [dict(rid="first", prompt=prompt,
                                           max_new_tokens=4)])
        parked = eng.allocator.used_blocks
        spilled = eng.host_tier.spill_parked(parked)
        eng.allocator.check_invariant()
        host_slots = sorted(eng.allocator._host_used)
        assert eng.trie.match(prompt) == []
        refilled = eng.prefetch_prompt(prompt)
        blocks = eng.trie.match(prompt)
        batcher, again = _drain(side, eng, [dict(rid="again", prompt=prompt,
                                                 max_new_tokens=4)])
        seen[side] = dict(
            first=first, again=again, parked=parked, spilled=spilled,
            host_slots=host_slots, refilled=refilled, blocks=blocks,
            stats=dict(eng.host_tier.stats),
            refill_pages=batcher.stats["kv_refill_pages"],
            rebuilds=eng.compile_count - warmed)
    assert seen["port"] == seen["jax"]
    got = seen["port"]
    assert got["first"]["first"] == got["again"]["again"]
    assert got["parked"] == got["spilled"] == got["refilled"] == 4
    assert got["rebuilds"] == 0


def test_paged_summary_tier_block_matches_jax(tiered):
    (j, _), (t, _) = tiered
    got, want = _summary(t), _summary(j)
    assert got.pop("kv_kernel") == "gather" == want.pop("kv_kernel")
    assert got == want
    assert got["kv_host_blocks"] == 16
    assert got["kv_host_inflight_source"] == "planner"
    assert set(WALL_KEYS) <= set(t.paged_summary())


def test_prefetch_and_headroom_precheck_match_jax(tiered):
    for prompt, new in (([7] * 12, 4), ([1] * 8, 4), ([1] * 44, 20)):
        assert tiered[1][0].admission_headroom(prompt, new) == \
            tiered[0][0].admission_headroom(prompt, new)
    assert tiered[1][0].prefetch_prompt([7] * 12) == 0
    assert not tiered[1][0].admission_headroom([1] * 44, 20)


def test_admission_pressure_spills_before_evicting_like_jax(tiered):
    """Distinct prompts overflow the 15-page pool: admission spills
    parked chains instead of evicting them, on both sides alike."""
    rng = np.random.default_rng(31)
    reqs = [
        dict(rid=f"p{i}", prompt=rng.integers(
            0, TINY.vocab_size, size=8 + (4 * i) % 8).tolist(),
            max_new_tokens=1 + i % 3)
        for i in range(8)
    ]
    seen = {}
    for side, (eng, warmed) in zip(("jax", "port"), tiered):
        ev, sp = eng.paged_stats["trie_evictions"], \
            eng.host_tier.stats["kv_spills"]
        _, got = _drain(side, eng, reqs)
        eng.allocator.check_invariant()
        seen[side] = (got, eng.paged_stats["trie_evictions"] - ev,
                      eng.host_tier.stats["kv_spills"] - sp,
                      _summary(eng), eng.compile_count - warmed)
    assert seen["port"][:3] == seen["jax"][:3]
    got, evicted, spills, _, rebuilds = seen["port"]
    assert spills > 0 and evicted == 0 and rebuilds == 0


def test_reset_pool_flushes_the_tier(tiered):
    for eng, _ in tiered:
        assert eng.host_tier.stats["kv_spill_pages"] > 0
        eng.reset_pool()
        assert eng.allocator.host_used_slots == 0
        assert eng.allocator.host_drops == 0
        assert all(v == 0 for v in eng.host_tier.stats.values())
        eng.allocator.check_invariant()


@pytest.mark.parametrize("pool", [
    dict(cache_dtype="bfloat16"), dict(kv_quant="int8"),
], ids=["bf16", "int8"])
def test_bf16_and_int8_pools_round_trip_like_jax(weights, pool):
    """A 16-bit and an int8 pool: the port's refilled pages (and int8
    scales) are bit-equal to what was spilled, and a page one off is
    not; tokens, page ids and wire bytes equal the JAX tier's."""
    jp, tp, mesh = weights
    paged = {k: v for k, v in pool.items() if k == "kv_quant"}
    serve = dict(SERVE)
    if "cache_dtype" in pool:
        j = JaxPagedEngine(
            jp, JAX_TINY, JaxServeConfig(**serve, cache_dtype=jnp.bfloat16),
            mesh, JaxPagedConfig(**TIERED))
        t = PagedEngine(tp, TINY,
                        ServeConfig(**serve, cache_dtype=torch.bfloat16),
                        "cpu", PagedConfig(**TIERED))
    else:
        j = JaxPagedEngine(jp, JAX_TINY, JaxServeConfig(**serve), mesh,
                           JaxPagedConfig(**TIERED, **paged))
        t = PagedEngine(tp, TINY, ServeConfig(**serve), "cpu",
                        PagedConfig(**TIERED, **paged))
    prompt = np.random.default_rng(5).integers(0, 128, 16).tolist()
    seen = {}
    for side, eng in (("jax", j), ("port", t)):
        warmed = eng.warmup()
        _, first = _drain(side, eng, [dict(rid="a", prompt=prompt,
                                           max_new_tokens=3)])
        blocks = eng.trie.match(prompt)
        if side == "port":
            want = chip_smoke.page_bytes(torch, eng, blocks)
        eng.host_tier.spill_parked(len(blocks))
        eng.prefetch_prompt(prompt)
        back = eng.trie.match(prompt)
        if side == "port":
            assert chip_smoke.same_pages(
                torch, chip_smoke.page_bytes(torch, eng, back), want)
            assert not chip_smoke.same_pages(
                torch, chip_smoke.page_bytes(torch, eng, back[1:] + back[:1]),
                want)
        _, again = _drain(side, eng, [dict(rid="b", prompt=prompt,
                                           max_new_tokens=3)])
        seen[side] = (first, again, blocks, back, dict(eng.host_tier.stats),
                      eng.compile_count - warmed)
    assert seen["port"] == seen["jax"]
    assert seen["port"][0]["a"] == seen["port"][1]["b"]


def test_tier_config_refusals_match_jax(weights):
    jp, tp, mesh = weights
    for kw in (dict(host_blocks=1),
               dict(host_blocks=16, prefix_cache=False)):
        with pytest.raises(ValueError) as got:
            PagedConfig(block_size=4, num_blocks=16, **kw)
        with pytest.raises(ValueError) as want:
            JaxPagedConfig(block_size=4, num_blocks=16, **kw)
        assert str(got.value) == str(want.value)
    plain = dict(block_size=4, num_blocks=16, prefix_cache=False)
    with pytest.raises(ValueError) as got:
        HostTier(PagedEngine(tp, TINY, ServeConfig(**SERVE), "cpu",
                             PagedConfig(**plain)))
    with pytest.raises(ValueError) as want:
        JaxHostTier(JaxPagedEngine(jp, JAX_TINY, JaxServeConfig(**SERVE),
                                   mesh, JaxPagedConfig(**plain)))
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("host_blocks", [0, 129], ids=["hbm", "tiered"])
def test_long_idle_sessions_summary_matches_jax(weights, host_blocks):
    """The tier's acceptance scenario through both load harnesses on a
    20-usable-page pool: every virtual-clock field and counter of the
    summaries equal, without and with the tier (JAX tests'
    TestTierShedContrast schedule)."""
    jp, tp, mesh = weights
    kw = dict(block_size=4, num_blocks=21, prefill_chunk=8,
              host_blocks=host_blocks)
    sc = dict(seed=7, n_requests=48, vocab_size=128, max_prompt=16,
              max_new=6, rate_per_s=15.0)
    j = JaxPagedEngine(jp, JAX_TINY, JaxServeConfig(**SERVE), mesh,
                       JaxPagedConfig(**kw))
    j.warmup()
    want_h = jlg.LoadHarness(j, jlg.build_scenario("long_idle_sessions", **sc),
                             faults=jlg.parse_faults(""),
                             prefill_ms_per_token=8.0)
    want = want_h.run()
    t = PagedEngine(tp, TINY, ServeConfig(**SERVE), "cpu", PagedConfig(**kw))
    warmed = t.warmup()
    got_h = tlg.LoadHarness(t, tlg.build_scenario("long_idle_sessions", **sc),
                            faults=tlg.parse_faults(""),
                            prefill_ms_per_token=8.0)
    got = got_h.run()
    assert dict(got_h.batcher.results) == dict(want_h.batcher.results)
    for k in WALL_KEYS:
        got.pop(k, None), want.pop(k, None)
    assert got == want
    assert t.compile_count == warmed
    if host_blocks:
        assert got["tenants"]["return"]["shed"] == 0
        assert got["kv_refill_pages"] > 0
    else:
        assert got["tenants"]["return"]["shed"] > 0


CHIP_CFG = tl.LlamaConfig(
    dim=32, n_layers=1, n_heads=2, n_kv_heads=2, vocab_size=512,
    multiple_of=16, max_seq_len=1024, dtype=torch.float32,
)


@pytest.fixture(scope="module")
def chip_tier():
    """chip_smoke's (a) at a tiny width on the CPU: the three
    long_idle_sessions runs at the phase's serve shape and pool sizes,
    and the bf16 and int8 page round trips."""
    from tpu_hpc_torch import obs

    prev = obs.set_bus(obs.EventBus(path=None))
    try:
        dev = torch.device("cpu")
        serve = ServeConfig(**chip_smoke.TIER_SERVE)
        runs = chip_smoke.tier_runs(torch, dev, CHIP_CFG, serve)
        params = tl.init_llama(torch.Generator().manual_seed(0), CHIP_CFG,
                               dev)
        trips = [chip_smoke.page_round_trip(torch, dev, params, CHIP_CFG,
                                            serve, q)
                 for q in ("none", "int8")]
    finally:
        obs.set_bus(prev)
    return runs, trips


def _launched(runs, trips):
    """The kernels launch only on a card: fill the launch readings with
    one launch each so every other gate is what decides."""
    one = {"paged_decode_attention": 1, "paged_prefill_attention": 1}
    runs = {k: dict(r, launches=one) for k, r in runs.items()}
    trips = [dict(t, launches_after_refill=one) for t in trips]
    return runs, trips


def test_chip_smoke_tier_gates_pass_on_cpu(chip_tier):
    runs, trips = _launched(*chip_tier)
    assert chip_smoke.tier_failures(runs, trips) == []
    assert runs["hbm"]["return_shed"] > 0
    assert runs["tiered"]["return_shed"] == 0
    for trip in trips:
        assert trip["bit_equal"] and not trip["control_one_page_off_equal"]
        assert trip["pages"] == chip_smoke.TIER_PROMPT // 16


def test_chip_smoke_tier_controls_are_rejected(chip_tier):
    runs, trips = _launched(*chip_tier)
    cases = {
        "hbm: the return wave shed nothing": (
            dict(runs, hbm=dict(runs["hbm"], return_shed=0)), trips),
        "tiered: 1 returns shed": (
            dict(runs, tiered=dict(runs["tiered"], return_shed=1)), trips),
        "tiered vs roomy: tokens differ": (dict(runs, tiered=dict(
            runs["tiered"], streams={k: v + [0] for k, v in
                                     runs["tiered"]["streams"].items()})),
            trips),
        "none: the one-page-off control passed": (runs, [dict(
            trips[0], control_one_page_off_equal=True), trips[1]]),
        "int8: refilled pages not bit-equal": (runs, [trips[0], dict(
            trips[1], bit_equal=False)]),
        "kernel never launched": chip_tier,
    }
    for message, (r, t) in cases.items():
        failures = chip_smoke.tier_failures(r, t)
        assert any(message in f for f in failures), (message, failures)
