"""The port's serving fleet against the JAX package's, on the CPU.

``tpu_hpc_torch.serve.fleet`` ports ``tpu_hpc.serve.fleet``: the
replica table, the router (prefix affinity and the round-robin
control), heartbeat health with redispatch and jittered restarts, the
autoscaler, the drain-and-swap weight rollout behind content checksums,
the live telemetry plane with its burn-rate monitor, and the
per-replica virtual-clock ``FleetHarness``. Each case of
``tests/test_fleet.py``'s chaos matrix runs through both harnesses on
the same scenario, faults and TINY float32 weights (JAX init, carried
across), and must give equal summaries (every virtual-clock field and
counter), equal greedy streams and the same event sequence, apart from
wall-clock stamps and span durations.
"""
import os

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax", reason="the JAX reference package")
jnp = jax.numpy

from tpu_hpc import obs as jobs
from tpu_hpc import loadgen as jlg
from tpu_hpc.models import llama2 as jl
from tpu_hpc.obs.slo import BurnRateMonitor as JaxBurnRateMonitor
from tpu_hpc.runtime import MeshSpec, build_mesh
from tpu_hpc.serve import PagedConfig as JaxPagedConfig
from tpu_hpc.serve import PagedEngine as JaxPagedEngine
from tpu_hpc.serve import Request as JaxRequest
from tpu_hpc.serve import ServeConfig as JaxServeConfig
from tpu_hpc.serve import fleet as jfleet
from tpu_hpc_torch import obs as tobs
from tpu_hpc_torch import loadgen as tlg
from tpu_hpc_torch.models import llama2 as tl
from tpu_hpc_torch.obs.slo import BurnRateMonitor
from tpu_hpc_torch.serve import (
    PagedConfig,
    Request,
    ServeConfig,
    params_from_numpy,
)
from tpu_hpc_torch.serve import fleet as tfleet

JAX_TINY = jl.LlamaConfig(
    dim=64, n_layers=2, n_heads=4, n_kv_heads=2, vocab_size=128,
    multiple_of=16, max_seq_len=64, dtype=jnp.float32,
)
TINY = tl.LlamaConfig(
    dim=64, n_layers=2, n_heads=4, n_kv_heads=2, vocab_size=128,
    multiple_of=16, max_seq_len=64, dtype=torch.float32,
)
SERVE = dict(slots=4, max_seq_len=48, prefill_buckets=(8, 16))
PAGED = dict(block_size=4, num_blocks=48, prefill_chunk=8)
MAX_PROMPT, MAX_NEW = 16, 6
N_REPLICAS = 3
# Record keys that carry wall-clock or process provenance; the record
# kinds that carry wall-clock durations (spans, the registry snapshot's
# histograms); and the JAX reshard engine's plan record, which its
# place_params emits and the port (no reshard engine) does not.
UNSTAMPED = ("time", "run_id", "host", "pid", "schema_version", "t_wall",
             "t_mono")
SKIPPED_KINDS = ("span", "metrics", "reshard_plan")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def fleets(devices):
    """Three warmed replicas a side (JAX: one-device meshes; port: the
    CPU three times over, the repeated-device split), shared by the
    module, with the v1 and v2 weight trees."""
    jp = jl.init_llama(jax.random.key(0), JAX_TINY)
    jp2 = jl.init_llama(jax.random.key(1), JAX_TINY)
    tp = params_from_numpy(jax.device_get(jp), TINY, "cpu")
    tp2 = params_from_numpy(jax.device_get(jp2), TINY, "cpu")
    jengines = []
    for d in devices[:N_REPLICAS]:
        mesh = build_mesh(MeshSpec(axes={"data": 1}), devices=[d])
        e = JaxPagedEngine(jp, JAX_TINY, JaxServeConfig(**SERVE), mesh,
                           JaxPagedConfig(**PAGED))
        e.warmup()
        jengines.append(e)
    tengines = tfleet.build_fleet_engines(
        tp, TINY, ServeConfig(**SERVE), PagedConfig(**PAGED), N_REPLICAS,
        devices=["cpu"] * N_REPLICAS,
    )
    for e in jengines + tengines:
        e._params0 = e.params
    return {"jax": (jengines, jp, jp2), "port": (tengines, tp, tp2)}


@pytest.fixture()
def engines(fleets):
    for side in fleets.values():
        for e in side[0]:
            e.reset_pool(force=True)
            if e.params is not e._params0:
                e.swap_params(e._params0)
    return fleets


def _scenario(pkg, name, seed=7, n=16, rate=40.0):
    return pkg.build_scenario(
        name, seed=seed, n_requests=n, vocab_size=TINY.vocab_size,
        max_prompt=MAX_PROMPT, max_new=MAX_NEW, rate_per_s=rate,
    )


SIDES = {"jax": (jfleet, jlg, jobs), "port": (tfleet, tlg, tobs)}


def _run(fleets, side, scenario, cfg, faults="", swap=None, live=None,
         digest_dir=None, monkeypatch=None, capture_dir=None):
    """One FleetHarness run on ``side`` under a fresh event bus and
    registry (``capture_dir``: an AnomalyCapture there, its flight dump
    path given relative to it); returns (summary, streams, events,
    harness)."""
    fleet_mod, lg, obs = SIDES[side]
    engines, p1, p2 = fleets[side]
    cfg_obj = fleet_mod.FleetConfig(**cfg)
    bus = obs.EventBus(path=None, run_id="fleet-test", ring_size=1 << 20)
    prev_bus, prev_reg = obs.set_bus(bus), obs.set_registry(
        obs.MetricsRegistry())
    kw = {}
    if swap is not None:
        kw = dict(swap_at=swap[0], swap_weights=p2 if swap[1] else p1)
    if live is not None:
        monkeypatch.setenv(obs.ENV_DIGEST_DIR, os.path.join(digest_dir, side))
        kw["live_cfg"] = fleet_mod.LiveConfig(**live)
    if capture_dir is not None:
        capture_dir = os.path.join(capture_dir, side)
        kw["capture"] = obs.AnomalyCapture(capture_dir)
    try:
        harness = fleet_mod.FleetHarness(
            engines[:cfg_obj.max_replicas or len(engines)],
            _scenario(lg, *scenario), cfg_obj,
            faults=lg.parse_faults(faults), **kw,
        )
        n0 = harness.fleet.compile_count_total()
        summary = harness.run(n_devices=1)
        summary["_recompiles"] = harness.fleet.compile_count_total() - n0
    finally:
        obs.set_bus(prev_bus)
        obs.set_registry(prev_reg)
        if live is not None:
            monkeypatch.delenv(obs.ENV_DIGEST_DIR)
    events = [
        {k: v for k, v in rec.items() if k not in UNSTAMPED}
        for rec in bus.ring() if rec["event"] not in SKIPPED_KINDS
    ]
    for e in events:
        if e["event"] == "capture_triggered":
            assert os.path.exists(e["flight_path"])
            e["flight_path"] = os.path.relpath(e["flight_path"], capture_dir)
    return summary, dict(harness.fleet.results), events, harness


def _cfg(**kw):
    kw.setdefault("initial_replicas", 2)
    kw.setdefault("min_replicas", 2)
    kw.setdefault("max_replicas", 2)
    return kw


# (id, scenario args, fleet config, faults, swap (tick, v2?))
CASES = [
    ("clean", ("steady", 7, 12), _cfg(), "", None),
    ("kill", ("steady", 7, 12), _cfg(), "replica_kill_at=8", None),
    ("restart_backoff", ("steady", 7, 24, 15.0), _cfg(),
     "replica_kill_at=6", None),
    ("clean_swap", ("steady", 7, 12), _cfg(), "", (6, True)),
    ("corrupt_swap", ("steady", 7, 12), _cfg(), "swap_corrupt=1",
     (6, True)),
    ("slow_replica", ("multi_tenant", 7, 32, 60.0),
     _cfg(health_window=2), "slow_replica=1:8", None),
    ("scale_down", ("steady", 7, 16, 10.0),
     _cfg(min_replicas=1, scale_window=6, scale_cooldown=8), "", None),
    ("scale_up", ("saturating_burst", 7, 32),
     dict(initial_replicas=1, min_replicas=1, max_replicas=2,
          scale_window=4, scale_cooldown=4, scale_up_occupancy=0.7),
     "", None),
    ("diurnal_kill_swap", ("diurnal", 11, 32, 80.0),
     _cfg(max_replicas=3), "replica_kill_at=20", (30, False)),
    ("round_robin", ("shared_prefix", 7, 24), _cfg(router="round_robin"),
     "", None),
]
CASE_IDS = [c[0] for c in CASES]


@pytest.fixture(scope="module")
def clean_streams(fleets):
    """The no-failure run's streams on each side (the redispatch and
    rollback contracts compare against them)."""
    for side in fleets.values():
        for e in side[0]:
            e.reset_pool(force=True)
    out = {side: _run(fleets, side, *CASES[0][1:4])[1] for side in SIDES}
    assert out["jax"] == out["port"]
    return out["port"]


@pytest.mark.parametrize("case", CASES, ids=CASE_IDS)
def test_chaos_matrix_matches_jax(case, engines, clean_streams):
    _, scenario, cfg, faults, swap = case
    got = _run(engines, "port", scenario, cfg, faults, swap)
    want = _run(engines, "jax", scenario, cfg, faults, swap)
    assert got[1] == want[1]            # greedy streams
    assert got[0] == want[0]            # every summary field
    assert got[2] == want[2]            # the event sequence
    s, streams, events, h = got
    fl = s["fleet"]
    assert s["lost_requests"] == 0 and s["_recompiles"] == 0
    kinds = [e["event"] for e in events]
    name = case[0]
    if name in ("kill", "restart_backoff", "diurnal_kill_swap"):
        assert fl["replica_down"] == 1 and fl["redispatched"] >= 1
        assert "redispatch" in kinds
    if name == "kill":
        # The redispatch contract: resumed greedy streams are
        # byte-identical to the no-failure run.
        assert streams == clean_streams
    if name == "restart_backoff":
        assert fl["restarts"] == 1 and len(h.fleet.live) == 2
    if name == "clean_swap":
        assert fl["weights_version"] == 1 and fl["swap_rollbacks"] == 0
        assert fl["swapped_replicas"] >= 1
        assert all(r.weights_version == 1 for r in h.fleet.live)
    if name == "corrupt_swap":
        assert fl["swap_rollbacks"] == 1 and fl["swapped_replicas"] == 0
        assert fl["weights_version"] == 0
        # Old weights kept serving: byte-identical to the clean run.
        assert streams == clean_streams
        statuses = [e["status"] for e in events
                    if e["event"] == "weight_swap"]
        assert "corrupt" in statuses and "rolled_back" in statuses
    if name == "slow_replica":
        owners = list(h.fleet.owner.values())
        assert owners.count(0) > owners.count(1)
    if name == "scale_down":
        assert fl["scale_downs"] >= 1 and s["shed"] == 0
    if name == "scale_up":
        assert fl["scale_ups"] >= 1 and fl["live_max"] == 2
    if name == "diurnal_kill_swap":
        assert fl["swapped_replicas"] >= 1
        assert all(t["shed"] == 0 for n, t in s["tenants"].items()
                   if n != "background")


def test_live_plane_and_burn_monitor_match_jax(engines, tmp_path,
                                               monkeypatch):
    """The live telemetry plane on a slowed replica: per-replica
    digests, the rollup's straggler verdict and one SLO burn page that
    fires the fleet's AnomalyCapture (``fleet_itl_slo``: a flight dump,
    no profiler window) -- the same ``live`` block and events on both
    sides."""
    live = dict(period_s=0.02, itl_slo_ms=16.0, slo_target=0.99,
                fast_window_s=0.1, slow_window_s=0.4, burn_threshold=5.0,
                stale_after_s=30.0, straggler_factor=3.0)
    args = (("diurnal", 7, 48, 240.0), _cfg(max_replicas=3,
                                             initial_replicas=3,
                                             min_replicas=3),
            "slow_replica=1:4")
    got = _run(engines, "port", *args, live=live,
               digest_dir=str(tmp_path), monkeypatch=monkeypatch,
               capture_dir=str(tmp_path / "capture"))
    want = _run(engines, "jax", *args, live=live,
                digest_dir=str(tmp_path), monkeypatch=monkeypatch,
                capture_dir=str(tmp_path / "capture"))
    assert got[1] == want[1]
    assert got[0] == want[0]
    assert got[2] == want[2]
    lv = got[0]["live"]
    assert lv["stragglers"] == ["replica:1"] and lv["slo_burns"] == 1
    assert [e["event"] for e in got[2]].count("slo_burn") == 1
    (burn,) = [e for e in got[2] if e["event"] == "slo_burn"]
    (cap,) = [e for e in got[2] if e["event"] == "capture_triggered"]
    assert burn["reason"] == "fleet_itl_slo"
    assert (cap["reason"], cap["trace_id"], cap["n_steps"]) == (
        "slo_burn", burn["trace_id"], 0)
    assert cap.get("profile_dir") is None
    assert got[3].telemetry.capture.captures == 1


def test_burn_rate_monitor_verdicts_match_jax():
    """The same cumulative (good, bad) stream through both monitors:
    a transient spike, a sustained burn (one page, latched), a rearm
    and a second burn -- every verdict and record equal."""
    rng = np.random.default_rng(5)
    samples, good, bad = [], 0.0, 0.0
    for k in range(400):
        t = 0.05 * k
        rate = 0.5 if 40 <= k < 44 or 200 <= k < 300 or k >= 350 else 0.002
        n = float(rng.integers(20, 40))
        b = float(rng.binomial(int(n), rate))
        good, bad = good + n - b, bad + b
        samples.append((t, good, bad))
    verdicts = {}
    for name, cls, obs in (("jax", JaxBurnRateMonitor, jobs),
                           ("port", BurnRateMonitor, tobs)):
        bus = obs.EventBus(path=None, run_id="slo-test")
        mon = cls(target=0.99, fast_window_s=0.5, slow_window_s=2.0,
                  threshold=5.0, bus=bus)
        out = []
        for k, (t, g, b) in enumerate(samples):
            if k == 320:
                mon.rearm()
            rec = mon.observe(t, g, b, trace_id="tid", reason="test")
            out.append(None if rec is None else {
                key: v for key, v in rec.items() if key not in UNSTAMPED})
        verdicts[name] = (out, mon.burns, mon.budget_remaining())
    assert verdicts["port"] == verdicts["jax"]
    assert verdicts["port"][1] == 2
    for bad_kw in (dict(target=1.0), dict(fast_window_s=700.0),
                   dict(threshold=0)):
        with pytest.raises(ValueError) as got:
            BurnRateMonitor(**bad_kw)
        with pytest.raises(ValueError) as want:
            JaxBurnRateMonitor(**bad_kw)
        assert str(got.value) == str(want.value)
    with pytest.raises(ValueError, match="time went backwards"):
        mon = BurnRateMonitor()
        mon.observe(1.0, 1, 0)
        mon.observe(0.5, 1, 0)


def _refusal(side, fleets, **kw):
    fleet_mod, lg, _ = SIDES[side]
    engines, _, p2 = fleets[side]
    faults = kw.pop("faults", "")
    with pytest.raises(ValueError) as e:
        fleet_mod.FleetHarness(
            engines[:2], _scenario(lg, "steady", n=4),
            fleet_mod.FleetConfig(initial_replicas=2, min_replicas=2,
                                  max_replicas=2),
            faults=lg.parse_faults(faults), **kw)
    return str(e.value)


@pytest.mark.parametrize("kw", [
    dict(faults="slow_replica=7:3"),
    dict(faults="swap_corrupt=1"),
    dict(swap_at=3),
], ids=["slow_index", "corrupt_without_swap", "swap_without_weights"])
def test_fleet_harness_refusals_match_jax(kw, engines):
    assert _refusal("port", engines, **dict(kw)) == \
        _refusal("jax", engines, **dict(kw))


@pytest.mark.parametrize("spec", ["replica_kill_at=5", "replica_kill_at=0",
                                  "swap_corrupt=1", "slow_replica=1:2"])
def test_single_engine_harness_refuses_fleet_faults_like_jax(spec, engines):
    errors = {}
    for side in SIDES:
        _, lg, _ = SIDES[side]
        with pytest.raises(ValueError) as e:
            lg.LoadHarness(engines[side][0][0], _scenario(lg, "steady", n=4),
                           faults=lg.parse_faults(spec))
        errors[side] = str(e.value)
    assert errors["port"] == errors["jax"]


def test_fleet_config_and_device_split(engines):
    for bad in (dict(router="random"), dict(min_replicas=3),
                dict(heartbeat_timeout_s=0), dict(slow_factor=1.0),
                dict(scale_down_occupancy=0.9), dict(restart_retries=-1)):
        with pytest.raises(ValueError) as got:
            tfleet.FleetConfig(**bad)
        with pytest.raises(ValueError) as want:
            jfleet.FleetConfig(**bad)
        assert str(got.value) == str(want.value)
    assert tfleet.split_fleet_devices(4, 2) == [
        torch.device("cuda", 0), torch.device("cuda", 2)]
    with pytest.raises(ValueError, match="at least one chip"):
        tfleet.split_fleet_devices(1, 2)
    # The router skips draining and standby replicas, and finds nothing
    # when nothing is live.
    tengines = engines["port"][0]
    h = tfleet.FleetHarness(
        tengines[:2], _scenario(tlg, "steady", n=4),
        tfleet.FleetConfig(initial_replicas=2, min_replicas=2,
                           max_replicas=2),
        faults=tlg.parse_faults(""))
    fleet = h.fleet
    fleet.replicas[0].status = tfleet.DRAINING
    req = Request(rid="x0", prompt=list(range(8)), max_new_tokens=2)
    assert fleet.route(req).idx == 1
    fleet.replicas[1].status = tfleet.STANDBY
    assert fleet.route(req) is None
    assert JaxRequest(rid="x0", prompt=list(range(8))).prompt == req.prompt


CHIP_CFG = tl.LlamaConfig(
    dim=32, n_layers=1, n_heads=2, n_kv_heads=2, vocab_size=512,
    multiple_of=16, max_seq_len=1024, dtype=torch.float32,
)


@pytest.fixture(scope="module")
def chip_fleet():
    """chip_smoke's (b) at a tiny width on the CPU: the clean, kill,
    clean-swap, corrupt-swap and verify-skipped runs of two replicas on
    one device through run_fleet_loadgen."""
    import chip_smoke

    prev = tobs.set_bus(tobs.EventBus(path=None))
    try:
        return chip_smoke.fleet_runs(
            torch, torch.device("cpu"), CHIP_CFG,
            ServeConfig(slots=8, max_seq_len=1024,
                        prefill_buckets=(256, 512)),
            PagedConfig(block_size=16, num_blocks=513, prefill_chunk=256,
                        kernel="cuda"))
    finally:
        tobs.set_bus(prev)


def _fleet_launched(runs):
    """The kernels launch only on a card: one launch per replica fills
    the readings, so every other gate is what decides."""
    one = {"paged_decode_attention": 1, "paged_prefill_attention": 1}
    return {k: dict(r, replica_launches=[one, one]) for k, r in runs.items()}


def test_chip_smoke_fleet_gates_pass_on_cpu(chip_fleet):
    import chip_smoke

    runs = _fleet_launched(chip_fleet)
    assert chip_smoke.fleet_failures(runs) == []
    assert runs["kill"]["fleet"]["redispatched"] >= 1
    assert runs["swap"]["fleet"]["swapped_replicas"] == 2
    assert runs["corrupt"]["fleet"]["swap_rollbacks"] == 1
    assert sum(runs["corrupt_unverified"]["replicas_off_published"]) >= 1


def test_chip_smoke_fleet_controls_are_rejected(chip_fleet):
    import chip_smoke

    runs = _fleet_launched(chip_fleet)
    unverified = dict(runs["corrupt_unverified"],
                      replicas_off_published=[0, 0])
    cases = {
        "kill: redispatched streams differ from clean":
            chip_smoke.altered_after_redispatch(runs),
        "corrupt_unverified: the corrupt weights did not get through":
            dict(runs, corrupt_unverified=unverified),
        "corrupt: no rollback": dict(runs, corrupt=runs["swap"]),
        "a replica launched no kernel": chip_fleet,
    }
    for message, r in cases.items():
        failures = chip_smoke.fleet_failures(r)
        assert any(message in f for f in failures), (message, failures)
