"""The port's serving engines against the JAX package's, on the CPU.

Same TINY float32 model and churn mix as tests/test_paged_kernels.py:
more requests than slots, a fully cached prompt, a shared-prefix
divergence, a prompt crossing the prefill chunk stride -- drained
twice, so the second round reads pages the first round left in the
prefix trie. The JAX ``PagedEngine(kernel="pallas")`` (kernels in
interpret mode) is driven once and recorded; each port engine is driven
through the same requests and must match it exactly: greedy tokens,
the block tables after every scheduler step, the slot positions, and
the prefix/CoW counters. The port engines also match the no-cache
greedy oracle and build nothing after warmup.

On the CPU the port's ``kernel="cuda"`` path runs the kernels' plain
PyTorch versions (the wrappers take them only for CPU tensors);
tests/test_torch_gpu.py drives the real kernels on the card.
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax", reason="the JAX reference package")
jnp = jax.numpy

from tpu_hpc.models import llama2 as jl
from tpu_hpc.runtime import MeshSpec, build_mesh
from tpu_hpc.serve import ContinuousBatcher as JaxBatcher
from tpu_hpc.serve import Engine as JaxEngine
from tpu_hpc.serve import PagedConfig as JaxPagedConfig
from tpu_hpc.serve import PagedEngine as JaxPagedEngine
from tpu_hpc.serve import Request as JaxRequest
from tpu_hpc.serve import ServeConfig as JaxServeConfig
from tpu_hpc_torch.models import llama2 as tl
from tpu_hpc_torch.runtime import resolve_device
from tpu_hpc_torch.serve import (
    ContinuousBatcher,
    Engine,
    PagedConfig,
    PagedEngine,
    Request,
    ServeConfig,
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
ROUNDS = 2
_ORACLE_LEN = 48


def _churn_mix():
    """The tests/test_paged_kernels.py churn mix, as plain tuples."""
    rng = np.random.default_rng(20)
    base = rng.integers(0, TINY.vocab_size, size=12).tolist()
    tail = rng.integers(0, TINY.vocab_size, size=2).tolist()
    short = rng.integers(0, TINY.vocab_size, size=4).tolist()
    longp = rng.integers(0, TINY.vocab_size, size=13).tolist()
    mid = rng.integers(0, TINY.vocab_size, size=7).tolist()
    return [
        ("r0", base, 6), ("r1", list(base), 6), ("r2", base[:8] + tail, 6),
        ("r3", short, 6), ("r4", longp, 5), ("r5", mid, 4),
    ]


def _drive(engine, batcher_cls, request_cls):
    """Drain the churn mix ROUNDS times (one batcher per round),
    recording the block tables and slot positions after every step."""
    trace, results = [], []
    for _ in range(ROUNDS):
        batcher = batcher_cls(engine)
        for rid, prompt, n in _churn_mix():
            batcher.submit(request_cls(rid=rid, prompt=prompt,
                                       max_new_tokens=n))
        while not batcher.done:
            batcher.step()
            trace.append((
                engine._tables.copy() if hasattr(engine, "_tables") else None,
                tuple(batcher.slot_positions()),
            ))
        results.append(dict(batcher.results))
    stats = dict(getattr(engine, "paged_stats", {}))
    return {"trace": trace, "results": results, "stats": stats}


@pytest.fixture(scope="module")
def jax_params():
    return jl.init_llama(jax.random.key(0), JAX_TINY)


@pytest.fixture(scope="module")
def port_params(jax_params):
    return params_from_numpy(jax.device_get(jax_params), TINY, "cpu")


@pytest.fixture(scope="module")
def mesh1():
    return build_mesh(MeshSpec(axes={"data": 1}), devices=jax.devices()[:1])


def _jax_paged_record(jax_params, mesh1, **kw):
    eng = JaxPagedEngine(
        jax_params, JAX_TINY, JaxServeConfig(**SERVE), mesh1,
        JaxPagedConfig(kernel="pallas", **PAGED, **kw),
    )
    eng.warmup()
    return _drive(eng, JaxBatcher, JaxRequest)


@pytest.fixture(scope="module")
def jax_fp_record(jax_params, mesh1):
    return _jax_paged_record(jax_params, mesh1)


@pytest.fixture(scope="module")
def jax_q8_record(jax_params, mesh1):
    return _jax_paged_record(jax_params, mesh1, kv_quant="int8")


@pytest.fixture(scope="module")
def greedy_oracle(jax_params):
    """Greedy continuation via the full NO-CACHE JAX forward pass at a
    fixed padded length."""
    fwd = jax.jit(lambda toks: jl.apply_llama(jax_params, toks, JAX_TINY))

    def oracle(prompt, steps):
        toks, out = list(prompt), []
        for _ in range(steps):
            padded = np.zeros((1, _ORACLE_LEN), np.int32)
            padded[0, :len(toks)] = toks
            t = int(jnp.argmax(fwd(jnp.asarray(padded))[0, len(toks) - 1]))
            out.append(t)
            toks.append(t)
        return out

    return oracle


def _port_paged(port_params, kernel, **kw):
    eng = PagedEngine(
        port_params, TINY, ServeConfig(**SERVE), "cpu",
        PagedConfig(kernel=kernel, **PAGED, **kw),
    )
    eng.warmup()
    return eng


def _assert_same_run(got, want):
    assert got["results"] == want["results"]
    assert len(got["trace"]) == len(want["trace"])
    for step, ((gt, gp), (wt, wp)) in enumerate(
        zip(got["trace"], want["trace"])
    ):
        assert gp == wp, step
        np.testing.assert_array_equal(gt, wt, err_msg=f"step {step}")
    assert got["stats"] == want["stats"]


@pytest.mark.parametrize("kernel", ["cuda", "gather"])
def test_paged_engine_matches_jax_pallas_engine(
    kernel, port_params, jax_fp_record, greedy_oracle
):
    eng = _port_paged(port_params, kernel)
    n0 = eng.compile_count
    got = _drive(eng, ContinuousBatcher, Request)
    _assert_same_run(got, jax_fp_record)
    assert got["stats"]["prefix_hits"] > 0  # round 2 read trie pages
    assert eng.compile_count == n0  # zero builds after warmup
    for rid, prompt, n in _churn_mix():
        for rnd in range(ROUNDS):
            assert got["results"][rnd][rid] == greedy_oracle(prompt, n), rid


@pytest.mark.parametrize("kernel", ["cuda", "gather"])
def test_int8_paged_engine_matches_jax_int8_engine(
    kernel, port_params, jax_q8_record
):
    eng = _port_paged(port_params, kernel, kv_quant="int8")
    n0 = eng.compile_count
    got = _drive(eng, ContinuousBatcher, Request)
    _assert_same_run(got, jax_q8_record)
    assert eng.compile_count == n0
    assert eng.ks.dtype == torch.int8 and eng.k_scales.dtype == torch.float32


def test_slab_engine_matches_jax_slab_engine(
    jax_params, port_params, mesh1, greedy_oracle
):
    jeng = JaxEngine(jax_params, JAX_TINY, JaxServeConfig(**SERVE), mesh1)
    jeng.warmup()
    want = _drive(jeng, JaxBatcher, JaxRequest)
    eng = Engine(port_params, TINY, ServeConfig(**SERVE), "cpu")
    n0 = eng.warmup()
    got = _drive(eng, ContinuousBatcher, Request)
    assert got["results"] == want["results"]
    assert [p for _, p in got["trace"]] == [p for _, p in want["trace"]]
    assert eng.compile_count == n0
    for rid, prompt, n in _churn_mix():
        assert got["results"][0][rid] == greedy_oracle(prompt, n), rid


def test_cow_copy_moves_page_and_scale(port_params):
    """Copy-on-write: a shared write target is copied (payload and its
    int8 scale) before the decode write."""
    eng = _port_paged(port_params, "cuda", kv_quant="int8")
    eng.admit(0, list(range(1, 10)), 4)
    src = eng.slot_state(0).blocks[2]  # page holding position 8
    eng.ks[:, src] = 7
    eng.k_scales[:, src] = 0.5
    eng.allocator.retain([src])  # a second owner appears
    eng._cow_write_target(0, 9)
    dst = eng.slot_state(0).blocks[2]
    assert dst != src and eng.paged_stats["cow_copies"] == 1
    assert torch.all(eng.ks[:, dst] == 7)
    assert torch.all(eng.k_scales[:, dst] == 0.5)
    assert int(eng._tables[0, 2]) == dst


def test_reset_pool_refuses_undrained_then_flushes(port_params):
    eng = _port_paged(port_params, "gather")
    eng.admit(1, list(range(1, 10)), 4)
    with pytest.raises(RuntimeError, match="undrained"):
        eng.reset_pool()
    eng.reset_pool(force=True)
    assert not eng._tables.any()  # every row back to the scratch page
    assert eng.allocator.free_blocks == PAGED["num_blocks"] - 1
    eng.allocator.check_invariant()
    assert eng.trie.match(list(range(1, 10))) == []


def test_cli_prints_summary_line(tmp_path):
    cmd = [
        sys.executable, "-m", "tpu_hpc_torch.serve", "--device", "cpu",
        "--model", "tiny", "--vocab", "64", "--paged", "--kv-kernel",
        "cuda", "--prefill-chunk", "16", "--requests", "5", "--max-new",
        "3", "--slots", "2", "--buckets", "16,32", "--prompt-lens",
        "9,40", "--metrics", str(tmp_path / "run.jsonl"),
    ]
    out = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr
    summary = json.loads(out.stdout.strip().splitlines()[-1])
    assert summary["requests"] == 5 and summary["tokens"] == 15
    assert summary["recompiles"] == 0
    assert summary["kv_kernel"] == "cuda" and summary["kv_layout"] == "paged"
    assert summary["device"] == {"type": "cpu", "name": "cpu", "count": 1}
    # CPU tensors take the plain versions: no kernel launched
    assert summary["kernel_launches"] == {
        "paged_decode_attention": 0, "paged_prefill_attention": 0,
    }
    from tpu_hpc_torch.obs import validate_file

    assert validate_file(str(tmp_path / "run.jsonl")) > 0


def test_cli_rejects_paged_flags_without_paged():
    out = subprocess.run(
        [sys.executable, "-m", "tpu_hpc_torch.serve", "--device", "cpu",
         "--kv-kernel", "cuda"],
        cwd=REPO, capture_output=True, text=True, timeout=120,
    )
    assert out.returncode == 2 and "--paged" in out.stderr


def test_port_imports_no_jax_and_nothing_of_tpu_hpc():
    code = (
        "import importlib, pkgutil, sys\n"
        "import tpu_hpc_torch\n"
        "for m in pkgutil.walk_packages(tpu_hpc_torch.__path__,"
        " 'tpu_hpc_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "import tpu_hpc_torch.serve, chip_smoke\n"
        "bad = sorted(m for m in sys.modules if m == 'jax'"
        " or m.startswith(('jax.', 'jaxlib', 'flax'))"
        " or m == 'tpu_hpc' or m.startswith('tpu_hpc.'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr


def test_resolve_device(monkeypatch):
    assert resolve_device("cpu") == torch.device("cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device("cuda")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Engine({}, TINY, ServeConfig(**SERVE), "cuda")


def test_later_slices_refuse_loudly(port_params):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        PagedEngine(
            port_params, TINY, ServeConfig(**SERVE), "cpu",
            PagedConfig(host_blocks=4, **PAGED),
        )
    with pytest.raises(ValueError, match="'gather' or 'cuda'"):
        PagedConfig(kernel="pallas", **PAGED)
    eng = _port_paged(port_params, "gather")
    eng.spec = object()
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        ContinuousBatcher(eng)
    eng.spec = None
    with pytest.raises(ValueError, match="speculative"):
        ContinuousBatcher(eng).submit(
            Request(rid="s", prompt=[1, 2], temperature=0.7)
        )
