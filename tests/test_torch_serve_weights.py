"""Train -> serve weights and the serving CLI's new paths, on the CPU.

``tpu_hpc_torch.serve.weights`` ports ``serving_pspecs``,
``place_params``, ``abstract_train_state`` and ``load_serving_params``:
a port trainer checkpoint restores into the serving layout bit for
bit, and a directory with nothing to restore raises the JAX package's
``FileNotFoundError``. ``PagedEngine.swap_params`` refuses a shape
mismatch in the JAX words. The CLI serves from ``--checkpoint-dir``,
drafts from ``--spec-draft-ckpt``, runs the tier and the fleet, keeps
the JAX package's misplaced-flag guards word for word, refuses the
flags of later slices, and re-emits its summary under ``--supervise``.
Then ``chip_smoke.py``'s ``serve_tier_fleet`` (c) at a tiny width.
"""
import json
import os
import subprocess
import sys

import pytest
import torch

jax = pytest.importorskip("jax", reason="the JAX reference package")
jnp = jax.numpy

import chip_smoke
from tpu_hpc.models import llama2 as jl
from tpu_hpc.runtime import MeshSpec, build_mesh
from tpu_hpc.serve import PagedConfig as JaxPagedConfig
from tpu_hpc.serve import PagedEngine as JaxPagedEngine
from tpu_hpc.serve import ServeConfig as JaxServeConfig
from tpu_hpc.serve import server as jserver
from tpu_hpc.serve import weights as jweights
from tpu_hpc_torch.models import llama2 as tl
from tpu_hpc_torch.serve import (
    ContinuousBatcher,
    PagedConfig,
    PagedEngine,
    ServeConfig,
    params_from_numpy,
    replay_requests,
)
from tpu_hpc_torch.serve import server
from tpu_hpc_torch.serve import weights
from tpu_hpc_torch.serve.spec import default_draft_config

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
# The CLI's --model tiny at --vocab 64, and its default half-depth draft.
CLI_CFG = server.tiny_config(64)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _train(cfg, directory, updates=2):
    """A port trainer on ``cfg`` (reference attention, CPU), fit for
    ``updates`` updates with a checkpoint saved after them; returns it."""
    from tpu_hpc_torch.train.__main__ import build_trainer

    trainer, ds = build_trainer(cfg, steps=updates, epochs=1, batch=2,
                                grad_accum_steps=1, attn="reference",
                                device="cpu", checkpoint_dir=directory,
                                save_every=1)
    trainer.fit(ds)
    return trainer


@pytest.fixture(scope="module")
def checkpoints(tmp_path_factory):
    """Checkpoints of the CLI's tiny model and of its draft (at a
    sequence of 48 tokens: the serving shape's capacity)."""
    root = tmp_path_factory.mktemp("ckpt")
    out = {}
    for name, cfg in (("target", CLI_CFG),
                      ("draft", default_draft_config(CLI_CFG))):
        d = str(root / name)
        out[name] = (d, _train(cfg, d))
    return out


def test_restore_is_bit_equal_to_the_saved_params(checkpoints):
    d, trainer = checkpoints["target"]
    got = weights.flat_params(weights.load_serving_params(d, CLI_CFG, "cpu"))
    want = weights.flat_params(trainer.state.params)
    assert list(got) == list(want)
    for k, v in got.items():
        assert v.dtype == want[k].dtype == CLI_CFG.param_dtype
        assert torch.equal(v, want[k].detach()), k
    # The template mirrors what fit saved (AdamW: count, mu, nu).
    template = weights.abstract_train_state(CLI_CFG)
    assert set(template.opt_state) == set(trainer.state.opt_state)
    assert [t.shape for t in template.opt_state["mu"]] == \
        [t.shape for t in trainer.state.opt_state["mu"]]


def test_nothing_to_restore_raises_the_jax_words(tmp_path, devices):
    mesh = build_mesh(MeshSpec(axes={"data": 1}), devices=devices[:1])
    empty = tmp_path / "empty"
    empty.mkdir()
    for d in (str(empty), str(tmp_path / "missing")):
        with pytest.raises(FileNotFoundError) as got:
            weights.load_serving_params(d, TINY, "cpu")
        with pytest.raises(FileNotFoundError) as want:
            jweights.load_serving_params(d, JAX_TINY, mesh)
        assert str(got.value) == str(want.value)


def test_place_params_gives_fresh_buffers_in_bounded_groups():
    params = tl.init_llama(torch.Generator().manual_seed(0), TINY, "cpu")
    once = weights.place_params(params, TINY, "cpu")
    again = weights.place_params(once, TINY, "cpu")
    grouped = weights.place_params(once, TINY, "cpu", max_inflight_bytes=1)
    flat, re, gr = (weights.flat_params(t) for t in (once, again, grouped))
    for k, v in flat.items():
        # Already placed, copied all the same: callers may free or
        # overwrite the source after placement.
        assert re[k].data_ptr() != v.data_ptr() != gr[k].data_ptr()
        assert torch.equal(re[k], v) and torch.equal(gr[k], v)
    with pytest.raises(ValueError, match="max_inflight_bytes"):
        weights.place_params(once, TINY, "cpu", max_inflight_bytes=0)


def test_serving_pspecs_replicate_without_a_model_axis(devices):
    mesh = build_mesh(MeshSpec(axes={"data": 1}), devices=devices[:1])
    jp = jl.init_llama(jax.random.key(0), JAX_TINY)
    want = jax.tree.leaves(jweights.serving_pspecs(jp, mesh),
                           is_leaf=lambda x: isinstance(x, tuple))
    tp = tl.init_llama(torch.Generator().manual_seed(0), TINY, "cpu")
    got = list(weights.flat_params(weights.serving_pspecs(tp)).values())
    assert len(got) == len(want)
    assert all(tuple(g) == tuple(w) == () for g, w in zip(got, want))


@pytest.fixture(scope="module")
def engines(devices):
    jp = jl.init_llama(jax.random.key(0), JAX_TINY)
    jp2 = jl.init_llama(jax.random.key(1), JAX_TINY)
    mesh = build_mesh(MeshSpec(axes={"data": 1}), devices=devices[:1])
    j = JaxPagedEngine(jp, JAX_TINY, JaxServeConfig(**SERVE), mesh,
                       JaxPagedConfig(**PAGED))
    t = PagedEngine(params_from_numpy(jax.device_get(jp), TINY, "cpu"),
                    TINY, ServeConfig(**SERVE), "cpu", PagedConfig(**PAGED))
    t2 = params_from_numpy(jax.device_get(jp2), TINY, "cpu")
    return j, t, t2


def test_swap_params_swaps_without_rebuilds_and_refuses_like_jax(engines):
    j, t, t2 = engines
    warmed = t.warmup()
    reqs = replay_requests(4, TINY.vocab_size, (5, 9, 13), 4, seed=0)
    fresh = PagedEngine(t2, TINY, ServeConfig(**SERVE), "cpu",
                        PagedConfig(**PAGED))
    want = ContinuousBatcher(fresh).run(reqs)
    old = t.params
    t.swap_params(weights.place_params(t2, TINY, "cpu"))
    t.reset_pool()
    assert ContinuousBatcher(t).run(reqs) == want
    assert t.compile_count == warmed
    t.swap_params(old)
    other_t = dict(TINY.__dict__, dim=32)
    other_j = dict(JAX_TINY.__dict__, dim=32)
    bad_t = tl.init_llama(torch.Generator().manual_seed(2),
                          tl.LlamaConfig(**other_t), "cpu")
    bad_j = jl.init_llama(jax.random.key(2), jl.LlamaConfig(**other_j))
    with pytest.raises(ValueError) as got:
        t.swap_params(weights.place_params(bad_t, TINY, "cpu"))
    with pytest.raises(ValueError) as want_e:
        j.swap_params(bad_j)
    assert str(got.value) == str(want_e.value)
    assert "swap_params: leaf mismatch" in str(got.value)
    bad_t.pop("norm")
    with pytest.raises(ValueError, match="swap_params: tree has"):
        t.swap_params(bad_t)
    t.admit(0, list(range(8)), 4)
    with pytest.raises(RuntimeError) as got:
        t.reset_pool()
    j.admit(0, list(range(8)), 4)
    with pytest.raises(RuntimeError) as want_e:
        j.reset_pool()
    assert str(got.value) == str(want_e.value)
    t.reset_pool(force=True)
    j.reset_pool(force=True)


def _cli(args, capsys):
    assert server.main(["--device", "cpu", *args]) == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


SMALL = ["--vocab", "64", "--slots", "2", "--buckets", "16,32",
         "--max-new", "6"]


def test_cli_serves_from_checkpoints(checkpoints, capsys):
    target, draft = checkpoints["target"][0], checkpoints["draft"][0]
    base = _cli(["--paged", "--requests", "3", *SMALL,
                 "--checkpoint-dir", target], capsys)
    assert base["recompiles"] == 0 and base["requests"] == 3
    spec = _cli(["--paged", "--spec", "draft", "--requests", "3", *SMALL,
                 "--checkpoint-dir", target, "--spec-draft-ckpt", draft],
                capsys)
    assert spec["spec_mode"] == "draft" and spec["drafted"] > 0
    assert spec["tokens"] == base["tokens"]


def test_cli_runs_the_tier_and_the_fleet(capsys):
    tier = _cli(["--paged", "--kv-host-blocks", "64", "--kv-blocks", "20",
                 "--prefill-chunk", "16", "--loadgen", "long_idle_sessions",
                 "--requests", "24", "--max-new", "8", "--slots", "4",
                 "--buckets", "16,32", "--vocab", "512"], capsys)
    assert tier["kv_host_blocks"] == 64 and tier["recompiles"] == 0
    assert tier["kv_spill_pages"] > 0 and tier["compiled_programs"] == 6
    fleet = _cli(["--paged", "--prefill-chunk", "16", "--fleet", "2",
                  "--fleet-swap-at", "4", "--fleet-router", "round_robin",
                  "--loadgen", "diurnal", "--requests", "10", *SMALL],
                 capsys)
    fl = fleet["fleet"]
    assert fleet["lost_requests"] == 0 and fleet["recompiles"] == 0
    assert fl["router"] == "round_robin" and fl["weights_version"] == 1
    assert fleet["devices"] == ["cpu", "cpu"]


# Misplaced-flag guards the two CLIs share, word for word.
SHARED_GUARDS = [
    ["--fleet", "2"],
    ["--fleet", "2", "--loadgen", "steady"],
    ["--fleet", "2", "--loadgen", "steady", "--paged"],
    ["--fleet", "0"],
    ["--fleet", "2", "--loadgen", "steady", "--paged", "--prefill-chunk",
     "16", "--fleet-min", "3"],
    ["--fleet", "2", "--loadgen", "steady", "--paged", "--prefill-chunk",
     "16", "--fleet-swap-at", "-1"],
    ["--fleet", "2", "--loadgen", "steady", "--paged", "--prefill-chunk",
     "16", "--spec", "ngram"],
    ["--fleet", "2", "--loadgen", "steady", "--paged", "--prefill-chunk",
     "16", "--disagg"],
    ["--fleet-min", "1"],
    ["--fleet-router", "round_robin"],
    ["--fleet-swap-at", "3"],
    ["--kv-host-blocks", "8"],
    ["--paged", "--kv-host-blocks", "1"],
    ["--disagg", "--loadgen", "steady"],
    ["--disagg-max-inflight-mb", "8"],
    ["--disagg", "--disagg-max-inflight-mb", "0"],
    ["--capture-dir", "x"],
    ["--fleet", "2", "--loadgen", "steady", "--paged", "--prefill-chunk",
     "16", "--capture-dir", "x"],
    ["--paged", "--spec", "ngram", "--disagg"],
    ["--paged", "--spec-draft-ckpt", "x"],
]


def _error(main, args, capsys):
    with pytest.raises(SystemExit) as e:
        main(args)
    assert e.value.code == 2
    return capsys.readouterr().err.strip().splitlines()[-1]


@pytest.mark.parametrize("args", SHARED_GUARDS,
                         ids=[" ".join(a) for a in SHARED_GUARDS])
def test_cli_guards_match_jax(args, capsys):
    got = _error(server.main, ["--device", "cpu", *args], capsys)
    want = _error(jserver.main, args, capsys)
    assert got.split("error: ", 1)[1] == want.split("error: ", 1)[1]


@pytest.mark.parametrize("args,message", [
    (["--disagg"], 'reshard plan, and the reshard engine is not ported '
     'yet (ROADMAP: "The operations modules")'),
    (["--disagg", "--disagg-max-inflight-mb", "auto"], "--disagg:"),
    (["--fleet", "2", "--loadgen", "steady", "--paged", "--prefill-chunk",
      "16", "--capture-dir", "x"],
     "--capture-dir is only consumed by the single-engine"),
    (["--checkpoint-dir", "/nonexistent/ck"], "is not a directory"),
    (["--paged", "--spec", "draft", "--spec-draft-ckpt", "/nonexistent"],
     "checkpoint restore into the serving layout"),
])
def test_cli_refuses_later_slices_and_missing_checkpoints(args, message,
                                                          capsys):
    assert message in _error(server.main, ["--device", "cpu", *args], capsys)


def test_supervise_round_trip_reemits_the_summary(tmp_path):
    env = dict(os.environ, PYTHONPATH=REPO,
               TPU_HPC_SUPERVISE_LOGS=str(tmp_path / "logs"))
    proc = subprocess.run(
        [sys.executable, "-m", "tpu_hpc_torch.serve", "--supervise", "1",
         "--heartbeat-timeout", "120", "--device", "cpu", "--paged",
         "--requests", "2", *SMALL],
        capture_output=True, text=True, timeout=300, cwd=str(tmp_path),
        env=env,
    )
    assert proc.returncode == 0, proc.stderr
    summary = json.loads(proc.stdout.strip().splitlines()[-1])
    assert summary["requests"] == 2 and summary["recompiles"] == 0
    assert os.path.exists(tmp_path / "logs" / "heartbeat.json")
    assert server._last_json_line(str(tmp_path / "logs")) == \
        proc.stdout.strip().splitlines()[-1]


def test_chip_smoke_restore_gates_on_cpu(tmp_path):
    """chip_smoke's (c) at a tiny width: the restored params bit-equal
    the trainer's, the replays from them equal, and the checkpoint as
    the draft of a float32 target gives plain greedy's streams; each
    gate rejects its control."""
    from tpu_hpc_torch import obs
    from tpu_hpc_torch.train.__main__ import bench_model_cfg

    draft = bench_model_cfg(seq_len=1024, dim=32, n_layers=1, n_heads=2,
                            vocab_size=512, multiple_of=16)
    target = tl.LlamaConfig(dim=32, n_layers=1, n_heads=2, n_kv_heads=2,
                            vocab_size=512, multiple_of=16,
                            max_seq_len=1024, dtype=torch.float32)
    serve = ServeConfig(slots=8, max_seq_len=1024,
                        prefill_buckets=(256, 512))
    paged = PagedConfig(block_size=16, num_blocks=513, prefill_chunk=256,
                        kernel="cuda")
    prev = obs.set_bus(obs.EventBus(path=None))
    try:
        row = chip_smoke.restore_part(torch, torch.device("cpu"),
                                      str(tmp_path), target, serve, paged,
                                      train_cfg=draft, batch=2, accum=1)
    finally:
        obs.set_bus(prev)
    assert chip_smoke.restore_failures(row) == []
    assert row["checkpoint_bytes"] > 0 and row["drafted"] > 0
    for key in ("restored_bit_equal", "replay_equal", "spec_equals_plain"):
        assert chip_smoke.restore_failures(dict(row, **{key: False})) == [
            f"restore: {key} is false"]
