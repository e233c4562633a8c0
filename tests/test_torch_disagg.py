"""Disaggregated prefill/decode serving (``tpu_hpc_torch.serve.disagg``)
against the JAX package's (``tpu_hpc.serve.disagg``) on the CPU.

Mirrors tests/test_disagg.py's ten tests, with the JAX engine on two
simulated devices (one a tier) and the port's two tiers on the CPU:

* **token parity** -- greedy decode through the disaggregated path
  equals the single-tier engine's and JAX's ``DisaggEngine``'s, token
  for token, slab and paged; on a paged pool every hop's page ids
  (prefill tier's gather, decode tier's scatter) and ``kv_transfers``
  equal JAX's, and an int8 pool hops its scales with its pages;
* **no rebuilds** -- after warmup a request stream makes no new plan,
  buffer or program;
* **tier attribution** -- ``describe()`` carries the tier meshes, the
  transfer load and each bucket's plan summary, equal to JAX's;
* **flag discipline** -- ``--disagg`` with ``--loadgen``, or a sizing
  flag without ``--disagg``, is a CLI error; ``--disagg`` runs through
  ``python -m tpu_hpc_torch.serve --device cpu``.
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
from tpu_hpc.serve import ContinuousBatcher as JaxBatcher
from tpu_hpc.serve import DisaggEngine as JaxDisagg
from tpu_hpc.serve import PagedConfig as JaxPagedConfig
from tpu_hpc.serve import Request as JaxRequest
from tpu_hpc.serve import ServeConfig as JaxServeConfig
from tpu_hpc.serve import split_serving_meshes as jsplit
from tpu_hpc_torch.models import llama2 as tl
from tpu_hpc_torch.serve import (
    ContinuousBatcher,
    DisaggEngine,
    Engine,
    PagedConfig,
    PagedEngine,
    Request,
    ServeConfig,
    params_from_numpy,
    split_serving_meshes,
)
from tpu_hpc_torch.serve import server

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
BOUND = 1 << 14


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _mix(req=Request, seed=0, n=6, max_new=5, lens=(7, 11, 9, 16, 3, 13)):
    rng = np.random.default_rng(seed)
    return [req(rid=f"r{i}", prompt=rng.integers(
        0, TINY.vocab_size, size=lens[i % len(lens)]).tolist(),
        max_new_tokens=max_new) for i in range(n)]


# Prompts past the largest bucket hop as several page groups.
LONG = (7, 21, 9, 30, 3, 17)


def _record_hops(engine, log):
    """Wrap an engine's page-group move to log (bucket, src ids, tgt
    ids)."""
    inner = engine._move_kv_paged

    def move(bucket, src, tgt):
        log.append((int(bucket), [int(i) for i in src],
                    [int(i) for i in tgt]))
        return inner(bucket, src, tgt)

    engine._move_kv_paged = move


@pytest.fixture(scope="module")
def params(devices):
    jp = jl.init_llama(jax.random.key(0), JAX_TINY)
    return jp, params_from_numpy(jax.device_get(jp), TINY, "cpu")


@pytest.fixture(scope="module")
def sides(params):
    """Warmed engines: JAX's slab and paged DisaggEngines on two
    simulated devices, the port's on the CPU twice, and the port's
    single-tier engines."""
    jp, tp = params
    pm, dm = jsplit(2, JAX_TINY)
    out = {
        "jax_slab": JaxDisagg(jp, JAX_TINY, JaxServeConfig(**SERVE), pm, dm,
                              max_inflight_bytes=BOUND),
        "jax_paged": JaxDisagg(jp, JAX_TINY, JaxServeConfig(**SERVE), pm, dm,
                               max_inflight_bytes=BOUND,
                               paged=JaxPagedConfig(**PAGED)),
        "slab": DisaggEngine(tp, TINY, ServeConfig(**SERVE), "cpu", "cpu",
                             max_inflight_bytes=BOUND),
        "paged": DisaggEngine(tp, TINY, ServeConfig(**SERVE), "cpu", "cpu",
                              max_inflight_bytes=BOUND,
                              paged=PagedConfig(**PAGED)),
        "single_slab": Engine(tp, TINY, ServeConfig(**SERVE), "cpu"),
        "single_paged": PagedEngine(tp, TINY, ServeConfig(**SERVE), "cpu",
                                    PagedConfig(**PAGED)),
    }
    for e in out.values():
        e.warmup()
    return out


class TestDisaggParity:
    def test_mixed_stream_token_exact_vs_single_tier_and_jax(self, sides):
        """Both buckets, slot reuse, mid-stream admissions: every
        request's tokens equal the single-tier engine's and JAX's."""
        for mode in ("slab", "paged"):
            single = ContinuousBatcher(sides[f"single_{mode}"]).run(_mix())
            got = ContinuousBatcher(sides[mode]).run(_mix())
            want = JaxBatcher(sides[f"jax_{mode}"]).run(_mix(JaxRequest))
            assert got == single == want, mode

    def test_paged_hops_and_transfers_equal_jax(self, sides):
        """Long prompts hop as several bucket-sized page groups: every
        hop's prefill-tier and decode-tier page ids, and the transfer
        count, equal JAX's."""
        logs = {"paged": [], "jax_paged": []}
        for name in logs:
            _record_hops(sides[name], logs[name])
        before = {n: sides[n].transfer_stats["kv_transfers"] for n in logs}
        got = ContinuousBatcher(sides["paged"]).run(
            _mix(seed=5, lens=LONG))
        want = JaxBatcher(sides["jax_paged"]).run(
            _mix(JaxRequest, seed=5, lens=LONG))
        assert got == want
        assert logs["paged"] == logs["jax_paged"]
        assert any(len(src) == 4 for _, src, _ in logs["paged"])
        assert any(s != t for _, s, t in logs["paged"])
        assert sides["paged"].transfer_stats["kv_transfers"] - \
            before["paged"] == sides["jax_paged"].transfer_stats[
                "kv_transfers"] - before["jax_paged"]

    def test_split_gives_distinct_tiers_and_one_card_twice_hops(self,
                                                                params):
        """The default split puts the tiers on distinct cards; an
        explicit pair may name one device twice, and the plan still
        moves the KV between the two tiers (a transfer, not a noop)."""
        assert split_serving_meshes(8, TINY) == (
            torch.device("cuda", 0), torch.device("cuda", 4))
        assert split_serving_meshes(3, TINY, prefill_devices=2) == (
            torch.device("cuda", 0), torch.device("cuda", 2))
        eng = DisaggEngine(params[1], TINY, ServeConfig(**SERVE), "cpu",
                           "cpu")
        assert eng.prefill_mesh != eng.decode_mesh
        eng._build_bucket(8)
        assert eng._plans[8].counts() == {"transfer": 2}

    def test_split_needs_two_devices(self):
        for kw in ({"n_devices": 1}, {"n_devices": 8, "prefill_devices": 8}):
            with pytest.raises(ValueError) as got:
                split_serving_meshes(cfg=TINY, **kw)
            with pytest.raises(ValueError) as want:
                jsplit(cfg=JAX_TINY, **kw)
            assert str(got.value) == str(want.value)

    def test_int8_pool_hops_pages_with_their_scales(self, params):
        """An int8 pool's hop carries each page's scales: tokens equal
        the single-tier int8 engine's."""
        paged = PagedConfig(kv_quant="int8", **PAGED)
        single = PagedEngine(params[1], TINY, ServeConfig(**SERVE), "cpu",
                             paged)
        single.warmup()
        eng = DisaggEngine(params[1], TINY, ServeConfig(**SERVE), "cpu",
                           "cpu", paged=paged)
        eng.warmup()
        assert set(eng._plans[8].summary()["kinds"]) == {"transfer"}
        assert eng._plans[8].summary()["steps"] == 4
        assert ContinuousBatcher(eng).run(_mix()) == \
            ContinuousBatcher(single).run(_mix())


class TestDisaggCompileDiscipline:
    def test_zero_rebuilds_after_warmup(self, sides):
        for mode in ("slab", "paged"):
            eng = sides[mode]
            n = eng.compile_count
            ContinuousBatcher(eng).run(_mix(seed=3))
            assert eng.compile_count == n, mode

    def test_transfer_stats_ride_batcher(self, sides):
        eng = sides["slab"]
        before = eng.transfer_stats["kv_transfers"]
        batcher = ContinuousBatcher(eng)
        batcher.run(_mix(seed=4, n=3))
        assert eng.transfer_stats["kv_transfers"] == before + 3
        assert batcher.stats["kv_transfers"] == before + 3
        assert batcher.stats["kv_transfer_bytes"] > 0

    def test_describe_reports_tiers_and_plans_like_jax(self, sides):
        for mode in ("slab", "paged"):
            got, want = sides[mode].describe(), sides[f"jax_{mode}"].describe()
            assert got["prefill_mesh"] == want["prefill_mesh"]
            assert got["decode_mesh"] == want["decode_mesh"]
            assert sorted(got["kv_plans"]) == [8, 16]
            assert got["kv_plans"] == want["kv_plans"], mode
            for plan in got["kv_plans"].values():
                assert plan["bound_met"] is True
                assert plan["max_inflight_bytes"] == BOUND


class TestDisaggCLI:
    def test_replay_main_with_disagg(self, capsys):
        rc = server.main([
            "--device", "cpu", "--requests", "3", "--max-new", "2",
            "--slots", "2", "--buckets", "8", "--prompt-lens", "3,6",
            "--vocab", "64", "--disagg", "--disagg-max-inflight-mb", "1",
        ])
        assert rc == 0
        summary = json.loads(capsys.readouterr().out.splitlines()[-1])
        assert summary["recompiles"] == 0
        d = summary["disagg"]
        assert d["kv_transfers"] == 3
        assert d["kv_transfer_bytes"] > 0
        assert "kv_transfer_ms_p95" in d
        assert summary["batcher"]["kv_transfers"] == 3

    def test_disagg_with_loadgen_is_cli_error(self):
        with pytest.raises(SystemExit):
            server.main(["--device", "cpu", "--loadgen", "steady",
                         "--disagg"])

    def test_disagg_sizing_without_disagg_is_cli_error(self):
        with pytest.raises(SystemExit):
            server.main(["--device", "cpu", "--disagg-max-inflight-mb", "4"])

    def test_module_entry_point_serves_paged_disagg(self):
        """``python -m tpu_hpc_torch.serve --disagg`` end to end, paged,
        the bound from the planner ("auto")."""
        out = subprocess.run(
            [sys.executable, "-m", "tpu_hpc_torch.serve", "--device", "cpu",
             "--requests", "3", "--max-new", "2", "--slots", "2",
             "--buckets", "16,32", "--prompt-lens", "5,20", "--vocab", "64",
             "--paged", "--disagg", "--disagg-max-inflight-mb", "auto"],
            cwd=REPO, capture_output=True, text=True, timeout=180,
            env=dict(os.environ, OMP_NUM_THREADS="1"))
        assert out.returncode == 0, out.stderr[-2000:]
        summary = json.loads(out.stdout.splitlines()[-1])
        assert summary["kv_layout"] == "paged"
        assert summary["recompiles"] == 0
        d = summary["disagg"]
        assert d["inflight_source"] == "planner"
        assert d["kv_transfers"] >= 3
        assert set(d["kv_plans"]) == {"16", "32"}
