"""The port's load harness against the JAX package's, on the CPU.

``tpu_hpc_torch.loadgen`` keeps its own copy of the scenario catalog and
ports the virtual-clock harness. Held exactly against
``tpu_hpc.loadgen``: every scenario of the catalog for two seeds
(arrivals, lengths, tenants, prompts, knobs), the fault parser, the
virtual-clock cost model (the port's ``"cuda"`` route charges what the
JAX ``"pallas"`` route charges), and whole harness summaries -- token
streams, shed verdicts, virtual-clock TTFT/ITL quantiles, occupancy,
speculative counts -- on ``steady``, ``saturating_burst`` and
``decode_heavy`` (with and without prompt-lookup speculation), the same
TINY float32 model (JAX init, carried across) on both sides.
"""
import json
import os
import subprocess
import sys
import types

import pytest
import torch

jax = pytest.importorskip("jax", reason="the JAX reference package")
jnp = jax.numpy

from tpu_hpc import loadgen as jlg
from tpu_hpc.loadgen import harness as jharness
from tpu_hpc.models import llama2 as jl
from tpu_hpc.runtime import MeshSpec, build_mesh
from tpu_hpc.serve import PagedConfig as JaxPagedConfig
from tpu_hpc.serve import PagedEngine as JaxPagedEngine
from tpu_hpc.serve import ServeConfig as JaxServeConfig
from tpu_hpc.serve import spec as jspec
from tpu_hpc_torch import loadgen as tlg
from tpu_hpc_torch.loadgen import harness as tharness
from tpu_hpc_torch.models import llama2 as tl
from tpu_hpc_torch.serve import (
    PagedConfig,
    PagedEngine,
    ServeConfig,
    SpecConfig,
    attach_spec,
    params_from_numpy,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

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
MAX_PROMPT = 16


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The models here are tiny: one intra-op thread runs them as fast,
    and leaves the other cores to the test files running beside this
    one under xdist (timing-based tests among them)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

# (scenario, spec mode or None, n_requests, max_new)
RUNS = [
    ("steady", None, 10, 6),
    ("saturating_burst", None, 16, 6),
    ("decode_heavy", None, 8, 24),
    ("decode_heavy", "ngram", 8, 24),
]
RUN_IDS = [f"{s}-{m or 'plain'}" for s, m, _, _ in RUNS]


def _requests(sc):
    return [
        (r.rid, r.arrival_ms, list(r.prompt), r.max_new_tokens, r.tenant,
         r.priority)
        for r in sc.requests
    ]


@pytest.mark.parametrize("seed", [0, 3])
@pytest.mark.parametrize("name", list(jlg.SCENARIOS))
def test_scenario_catalog_matches_jax(name, seed):
    kw = dict(seed=seed, n_requests=24, vocab_size=128, max_prompt=64,
              max_new=32)
    want = jlg.build_scenario(name, **kw)
    got = tlg.build_scenario(name, **kw)
    assert got.header() == want.header()
    assert _requests(got) == _requests(want)
    assert (got.queue_limit, got.colocate_train_ms, got.colocate_every) \
        == (want.queue_limit, want.colocate_train_ms, want.colocate_every)
    assert [(t.name, t.priority, dict(t.slo)) for t in got.tenants] == \
        [(t.name, t.priority, dict(t.slo)) for t in want.tenants]
    req = got.requests[0].to_request()
    assert (req.rid, req.prompt, req.tenant) == (
        got.requests[0].rid, list(got.requests[0].prompt),
        got.requests[0].tenant)


def test_catalog_names_and_unknown_scenario():
    assert tuple(tlg.SCENARIOS) == tuple(jlg.SCENARIOS)
    assert tuple(tlg.SLO_METRICS) == tuple(jlg.SLO_METRICS)
    with pytest.raises(ValueError) as got:
        tlg.build_scenario("nope", seed=0)
    with pytest.raises(ValueError) as want:
        jlg.build_scenario("nope", seed=0)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("spec", [
    "", "prefill_delay=1.5", "decode_delay=2,prefill_delay=0.5",
    "replica_kill_at=0", "slow_replica=1:4,swap_corrupt=1",
])
def test_fault_parsing_matches_jax(spec):
    assert tlg.parse_faults(spec) == jlg.parse_faults(spec)
    assert tlg.fleet_faults_set(tlg.parse_faults(spec)) == \
        jlg.fleet_faults_set(jlg.parse_faults(spec))


@pytest.mark.parametrize("spec", [
    "prefil_delay=2", "prefill_delay=0", "decode_delay=abc",
    "slow_replica=1", "swap_corrupt=2",
])
def test_bad_fault_specs_raise_like_jax(spec):
    with pytest.raises(ValueError) as got:
        tlg.parse_faults(spec)
    with pytest.raises(ValueError) as want:
        jlg.parse_faults(spec)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("kernel,jax_kernel", [
    ("gather", "gather"), ("cuda", "pallas"),
])
@pytest.mark.parametrize("quant", ["none", "int8"])
def test_cost_model_charges_what_jax_charges(kernel, jax_kernel, quant):
    """The virtual clock's per-call charges: the port's cuda route
    takes the JAX pallas route's KV-traffic factors."""
    def charges(mod, kk):
        eng = types.SimpleNamespace(kv_kernel=kk, kv_quant=quant)
        cm = mod._CostModelEngine(
            eng, mod.VirtualClock(), 8.0, 0.25, mod.parse_faults(""))
        return cm._decode_s, cm._prefill_s_per_token
    assert charges(tharness, kernel) == charges(jharness, jax_kernel)


@pytest.fixture(scope="module")
def engines():
    jt = jl.init_llama(jax.random.key(0), JAX_TINY)
    tt = params_from_numpy(jax.device_get(jt), TINY, "cpu")
    mesh = build_mesh(MeshSpec(axes={"data": 1}), devices=jax.devices()[:1])
    return jt, tt, mesh


def _jax_summary(engines, name, mode, n, max_new, kernel="gather"):
    jt, _, mesh = engines
    engine = JaxPagedEngine(jt, JAX_TINY, JaxServeConfig(**SERVE), mesh,
                            JaxPagedConfig(kernel=kernel, **PAGED))
    if mode:
        jspec.attach_spec(engine, jspec.SpecConfig(mode=mode))
    engine.warmup()
    sc = jlg.build_scenario(name, seed=1, n_requests=n, vocab_size=128,
                            max_prompt=MAX_PROMPT, max_new=max_new)
    h = jlg.LoadHarness(engine, sc, faults=jlg.parse_faults(""))
    summary = h.run()
    return summary, dict(h.batcher.results)


def _port_summary(engines, name, mode, n, max_new, kernel="gather"):
    _, tt, _ = engines
    engine = PagedEngine(tt, TINY, ServeConfig(**SERVE), "cpu",
                         PagedConfig(kernel=kernel, **PAGED))
    if mode:
        attach_spec(engine, SpecConfig(mode=mode))
    n_programs = engine.warmup()
    sc = tlg.build_scenario(name, seed=1, n_requests=n, vocab_size=128,
                            max_prompt=MAX_PROMPT, max_new=max_new)
    h = tlg.LoadHarness(engine, sc, faults=tlg.parse_faults(""))
    summary = h.run()
    assert engine.compile_count_total == n_programs
    return summary, dict(h.batcher.results)


@pytest.fixture(scope="module")
def jax_summaries(engines):
    return {rid: _jax_summary(engines, *run) for rid, run in
            zip(RUN_IDS, RUNS)}


@pytest.mark.parametrize("run", RUNS, ids=RUN_IDS)
def test_harness_summary_matches_jax(run, engines, jax_summaries):
    """Whole summaries equal: virtual-clock TTFT/ITL quantiles per
    tenant and overall, shed and queued verdicts, occupancy, decode
    steps, prefix-hit counters and the spec block -- and every
    request's token stream."""
    want, want_streams = jax_summaries[RUN_IDS[RUNS.index(run)]]
    got, got_streams = _port_summary(engines, *run)
    assert got_streams == want_streams
    assert got == want
    if run[0] == "saturating_burst":
        assert got["shed"] > 0
    if run[1] == "ngram":
        assert got["accepted"] > 0


def test_cuda_route_summary_matches_jax_pallas(engines):
    """The port's cuda route (the kernels' plain versions on the CPU)
    against the JAX package's pallas route (its spec prefill through
    the Pallas prefill kernel in interpret mode): the same tokens and
    the same whole summary -- both routes charge the same modeled KV
    discount on the virtual clock."""
    run = RUNS[-1]
    want, want_streams = _jax_summary(engines, *run, kernel="pallas")
    got, streams = _port_summary(engines, *run, kernel="cuda")
    assert streams == want_streams
    assert got.pop("kv_kernel") == "cuda"
    assert want.pop("kv_kernel") == "pallas"
    assert got == want


def test_harness_refuses_fleet_faults_and_capture(engines):
    _, tt, _ = engines
    engine = PagedEngine(tt, TINY, ServeConfig(**SERVE), "cpu",
                         PagedConfig(**PAGED))
    sc = tlg.build_scenario("steady", seed=0, n_requests=4,
                            vocab_size=128, max_prompt=16, max_new=4)
    with pytest.raises(ValueError, match="fleet fault"):
        tlg.LoadHarness(engine, sc,
                        faults=tlg.parse_faults("replica_kill_at=0"))
    # Anomaly capture is ported (tests/test_torch_trace.py): accepted.
    from tpu_hpc_torch.obs import AnomalyCapture

    cap = AnomalyCapture("unused", n_steps=2)
    assert tlg.LoadHarness(engine, sc, faults=tlg.parse_faults(""),
                           capture=cap).capture is cap


def test_cli_runs_decode_heavy_with_ngram_spec():
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run(
        [sys.executable, "-m", "tpu_hpc_torch.serve", "--device", "cpu",
         "--paged", "--spec", "ngram", "--loadgen", "decode_heavy",
         "--requests", "6", "--max-new", "12", "--slots", "2",
         "--buckets", "16", "--vocab", "64", "--kv-kernel", "cuda"],
        capture_output=True, text=True, timeout=300, cwd=REPO, env=env,
    )
    assert proc.returncode == 0, proc.stderr
    summary = json.loads(proc.stdout.strip().splitlines()[-1])
    assert summary["scenario"] == "decode_heavy"
    assert summary["spec_mode"] == "ngram"
    assert summary["virtual_clock"] is True
    assert summary["recompiles"] == 0
    assert summary["tenants"]["chat"]["finished"] == 6
    assert summary["wall_clock_tokens_per_s"] > 0
    assert summary["spec_kernel_launches"] == {"draft": 0, "verify": 0}
    assert set(summary["spec_wall_clock_s"]) == {"draft", "verify"}


@pytest.mark.parametrize("args,message", [
    (["--spec", "ngram"], "--spec rides the paged engine"),
    (["--paged", "--spec-k", "4"], "--spec-k is only consumed"),
    (["--paged", "--temperature", "0.8"], "--temperature is only"),
    (["--paged", "--spec", "ngram", "--top-p", "0.9"], "--top-p is only"),
    (["--paged", "--spec", "draft", "--spec-draft-ckpt", "x"],
     "checkpoint restore into the serving layout"),
    (["--paged", "--spec", "ngram", "--loadgen", "steady",
      "--temperature", "0.5"], "replay workload"),
    (["--paged", "--spec", "ngram", "--temperature", "-0.5"], "must be >= 0"),
    (["--paged", "--spec", "ngram", "--kv-quant", "int8"], "int8"),
    (["--loadgen", "nope"], "unknown scenario"),
])
def test_cli_refusals(args, message, capsys):
    from tpu_hpc_torch.serve import server

    with pytest.raises(SystemExit) as exit_:
        server.main(["--device", "cpu", *args])
    assert exit_.value.code == 2
    assert message in capsys.readouterr().err
