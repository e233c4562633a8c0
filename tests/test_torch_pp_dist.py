"""The port's pipeline parallelism across processes: one gloo world of
four CPU processes against ``InProcessPipe`` and the JAX ``Trainer``.

The module fixture launches this file as a script four times with
torchrun's variables. Each rank first runs every schedule of the stack
model on a ``{"pipe": 4}`` mesh through ``ProcessGroupPipe`` (its own
stage; the flash kernels' plain versions in the stage), and rank 0 runs
the same through ``InProcessPipe(4)``: the outputs, the input
cotangents and every stage's gradients must be equal bit for bit. Then
each rank trains three updates per case with the ``Trainer`` on a
``{"pipe": 4}`` and a ``{"data": 2, "pipe": 2}`` mesh (stage leaves
``Shard(0)`` DTensors on the pipe sub-mesh, edges replicated, the
microbatch rows split over data), the global-norm clip on; last it runs
the train CLI with ``--pp-schedule 1f1b``. Meanwhile this process runs
the JAX ``Trainer`` with ``llama_pp.make_forward`` / the bench's stack
forward on the same mesh shapes over simulated CPU devices.

Float32 throughout. Tolerances: losses rtol 1e-5, params atol 2e-6 /
rtol 1e-5 (tests/test_torch_distributed.py's limits), the clip's
grad_norm rtol 1e-5.
"""
import contextlib
import io
import json
import os
import pickle
import sys

import numpy as np
import pytest
import torch

WORLD, S = 4, 4
BATCH, SEQ, M, UPDATES = 8, 16, 4, 3
STACK = dict(vocab_size=128, dim=32, n_heads=2, max_seq_len=SEQ)
LLAMA = dict(dim=64, n_layers=8, n_heads=4, vocab_size=128, multiple_of=32,
             max_seq_len=SEQ)
TRAIN = dict(epochs=1, steps_per_epoch=UPDATES, global_batch_size=BATCH,
             seed=0, max_grad_norm=0.5)
# The bench's AdamW for the Llama; SGD with momentum for the stack model,
# whose key bias has a zero gradient in exact arithmetic (softmax does
# not move when every score of a row moves alike): AdamW would turn each
# side's rounding noise there into steps of +-lr.
OPTIMIZER = {"llama": dict(weight_decay=0.1, learning_rate=1e-3),
             "stack": dict(weight_decay=0.0, learning_rate=1e-2)}
LOSS_RTOL, PARAM_ATOL, PARAM_RTOL, NORM_RTOL = 1e-5, 2e-6, 1e-5, 1e-5
# The ProcessGroupPipe / InProcessPipe cases: (schedule, backward,
# remat_stage, v) on the stack model of 8 layers.
BIT_CASES = (("gpipe", "remat", False, 1), ("gpipe", "remat", True, 1),
             ("1f1b", "remat", False, 1), ("1f1b", "stash", False, 1),
             ("interleaved", "remat", True, 2),
             ("interleaved-1f1b", "remat", False, 2),
             ("interleaved-1f1b", "stash", False, 2))
# The trainer cases: (mesh axes, model, schedule, backward, remat_stage).
TRAIN_CASES = (
    ({"pipe": 4}, "llama", "1f1b", "remat", False),
    ({"pipe": 4}, "llama", "interleaved-1f1b", "stash", False),
    ({"pipe": 4}, "stack", "gpipe", "remat", True),
    ({"data": 2, "pipe": 2}, "stack", "1f1b", "remat", False),
    ({"data": 2, "pipe": 2}, "stack", "interleaved", "remat", True),
    ({"data": 2, "pipe": 2}, "llama", "gpipe", "remat", True),
)
CLI = ["--device", "cpu", "--pp-schedule", "1f1b", "--dim", "64",
       "--n-layers", "8", "--n-heads", "4", "--vocab", "128",
       "--multiple-of", "16", "--seq-len", "16", "--steps", "2",
       "--epochs", "1", "--pp-microbatches", "4",
       "--pp-microbatch-size", "2"]
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _chunks(schedule):
    return 2 if schedule in ("interleaved", "interleaved-1f1b") else 1


def _flash(q, k, v):
    from tpu_hpc_torch.kernels.attention import blockwise_attention

    return blockwise_attention(q, k, v, causal=True, impl="cuda")[0]


def _bit_case(mesh_or_pipe, stacked, xs, cot, schedule, backward,
              remat_stage, v):
    """ys, d(xs) and the stage gradients of sum(ys * cot)."""
    from tpu_hpc_torch.models import pipeline_transformer as ptx
    from tpu_hpc_torch.parallel import pp

    cfg = ptx.PipeConfig(**STACK, n_stages=S * v, layers_per_stage=2 // v)
    fn = pp.pipelined(ptx.make_stage_fn(cfg, _flash), mesh_or_pipe,
                      schedule=schedule, backward=backward,
                      remat_stage=remat_stage, n_chunks=v)
    stacked = ptx._map(lambda a: a.clone().requires_grad_(), stacked)
    xs = xs.clone().requires_grad_()
    ys = fn(stacked, xs)
    (ys * cot).sum().backward()
    return {"ys": ys.detach().numpy(), "dxs": xs.grad.numpy(),
            "grads": [a.grad.numpy() for a in pp._flatten(stacked)[1]]}


def _port_trainer(mesh, model, schedule, backward, remat_stage, params):
    from tpu_hpc_torch.config import TrainingConfig
    from tpu_hpc_torch.models import llama2, llama_pp
    from tpu_hpc_torch.models import pipeline_transformer as ptx
    from tpu_hpc_torch.parallel.plans import P
    from tpu_hpc_torch.runtime.mesh import mesh_axis_size
    from tpu_hpc_torch.train.trainer import Trainer

    n = mesh_axis_size(mesh, "pipe")
    v = _chunks(schedule)
    kw = dict(schedule=schedule, backward=backward, remat_stage=remat_stage,
              n_chunks=v, attn_fn=_flash,
              batch_spec=P(None, "data") if "data" in mesh.mesh_dim_names
              else P())
    if model == "llama":
        cfg = llama2.LlamaConfig(**LLAMA, dtype=torch.float32)
        tree = llama_pp.pipe_params_from_numpy(params, cfg, n, v)
        forward = llama_pp.make_forward(cfg, mesh, M, **kw)
        specs = llama_pp.pp_pspecs(tree)
    else:
        cfg = ptx.PipeConfig(**STACK, n_stages=n * v,
                             layers_per_stage=8 // (n * v))
        tree = ptx.pipe_params_from_numpy(params, cfg, n, v)
        forward = ptx.make_forward(cfg, mesh, M, **kw)
        specs = ptx.pp_pspecs(tree)
    return Trainer(TrainingConfig(**TRAIN, **OPTIMIZER[model]), mesh,
                   forward, tree,
                   param_pspecs=specs, batch_pspec=P(), device="cpu")


def _world_main(workdir):
    """One rank of the world (run as a script)."""
    from tpu_hpc_torch.parallel.pp_transport import InProcessPipe
    from tpu_hpc_torch.runtime import (
        MeshSpec,
        build_mesh,
        cleanup_distributed,
        init_distributed,
    )
    from tpu_hpc_torch.train import __main__ as tmain

    torch.set_num_threads(1)
    with open(os.path.join(workdir, "inputs.pkl"), "rb") as f:
        inputs = pickle.load(f)
    info = init_distributed(device="cpu", verbose=False)
    rank = info.process_id
    pipe_mesh = build_mesh(MeshSpec(axes={"pipe": S}), "cpu")
    xs, cot = (torch.from_numpy(a) for a in inputs["xs_cot"])
    out = {"bits": {}, "in_process": {}, "train": {}}
    for case in BIT_CASES:
        v = case[-1]
        stacked = inputs["bit_stages"][v]
        mine = {k: torch.from_numpy(a[rank * v:(rank + 1) * v])
                for k, a in stacked.items()}
        whole = {k: torch.from_numpy(a) for k, a in stacked.items()}
        out["bits"][case] = _bit_case(pipe_mesh, _tree(mine), xs, cot, *case)
        if rank == 0:
            out["in_process"][case] = _bit_case(InProcessPipe(S),
                                                _tree(whole), xs, cot, *case)
    meshes = {}
    for axes, model, *rest in TRAIN_CASES:
        key = tuple(axes.items())
        if key not in meshes:
            meshes[key] = build_mesh(MeshSpec(axes=axes), "cpu")
        v = _chunks(rest[0])
        trainer = _port_trainer(meshes[key], model, *rest,
                                inputs["params"][key, model, v])
        losses, norms = [], []
        for b in inputs["batches"]:
            m = trainer.train_step(tuple(torch.from_numpy(a) for a in b))
            losses.append(float(m["loss"]))
            norms.append(float(m["grad_norm"]))
        out["train"][key, model, *rest] = {
            "losses": losses, "norms": norms,
            "params": trainer.gather_params()}
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        tmain.main(CLI)  # leaves the process group at its end
    out["cli"] = buf.getvalue()
    with open(os.path.join(workdir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)
    cleanup_distributed()


def _tree(flat):
    """{"a/b/c": leaf} -> nested dict."""
    out = {}
    for path, leaf in flat.items():
        *heads, last = path.split("/")
        node = out
        for k in heads:
            node = node.setdefault(k, {})
        node[last] = leaf
    return out


def _flat(tree, prefix=""):
    out = {}
    for k in sorted(tree):
        path = f"{prefix}/{k}" if prefix else k
        if isinstance(tree[k], dict):
            out.update(_flat(tree[k], path))
        else:
            out[path] = tree[k]
    return out


# ---------------------------------------------------------------------------
# The JAX side (this process)
# ---------------------------------------------------------------------------

def _jax_params(jax, model, n, v):
    """The JAX init for ``model`` split for ``n`` stages x ``v`` chunks,
    as numpy, with its config."""
    import jax.numpy as jnp

    from tpu_hpc.models import llama2 as jl
    from tpu_hpc.models import llama_pp as jlpp
    from tpu_hpc.models import pipeline_transformer as jptx
    from tpu_hpc.parallel import pp as jpp

    if model == "llama":
        cfg = jl.LlamaConfig(**LLAMA, dtype=jnp.float32)
        full = jl.init_llama(jax.random.key(0), cfg)
        split = (jlpp.split_params_interleaved(full, cfg, n, v) if v > 1
                 else jlpp.split_params(full, cfg, n))
        return cfg, jax.device_get(split)
    cfg = jptx.PipeConfig(**STACK, n_stages=n * v,
                          layers_per_stage=8 // (n * v))
    p = jax.jit(lambda k: jptx.init_pipeline_transformer(k, cfg))(
        jax.random.key(0))
    if v > 1:
        p = dict(p, stages=jpp.interleave_stacked(p["stages"], n))
    return cfg, jax.device_get(p)


def _jax_train(jax, inputs):
    """The JAX Trainer per TRAIN_CASES on the same mesh shapes: losses,
    grad_norms and final params."""
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec

    from tpu_hpc.config import TrainingConfig as JCfg
    from tpu_hpc.models import llama_pp as jlpp
    from tpu_hpc.models import losses as jlosses
    from tpu_hpc.models import pipeline_transformer as jptx
    from tpu_hpc.parallel import pp as jpp
    from tpu_hpc.runtime import MeshSpec, build_mesh
    from tpu_hpc.train import Trainer as JTrainer

    out = {}
    for axes, model, schedule, backward, remat_stage in TRAIN_CASES:
        key = tuple(axes.items())
        n = axes["pipe"]
        v = _chunks(schedule)
        mesh = build_mesh(MeshSpec(axes=axes), devices=jax.devices()[:WORLD])
        cfg, params = inputs["jax_cfgs"][key, model, v], \
            inputs["params"][key, model, v]
        kw = dict(schedule=schedule, backward=backward,
                  remat_stage=remat_stage, n_chunks=v,
                  batch_spec=PartitionSpec(None, "data") if "data" in axes
                  else PartitionSpec())
        if model == "llama":
            forward = jlpp.make_forward(cfg, mesh, M, **kw)
            specs = jlpp.pp_pspecs(params)
        else:
            pipe = jpp.pipelined(jptx.make_stage_fn(cfg), mesh, axis="pipe",
                                 **kw)

            def forward(p, ms, batch, rng, pipe=pipe, cfg=cfg):
                tok, tgt = batch
                xs = jptx.embed(p, jpp.microbatch(tok, M), cfg)
                logits = jptx.head(p, pipe(p["stages"], xs), cfg)
                return (jlosses.cross_entropy(
                    logits, jpp.microbatch(tgt, M)), ms, {})

            specs = {
                "embed": jax.tree.map(lambda _: PartitionSpec(),
                                      params["embed"]),
                "stages": jpp.stage_pspecs(params["stages"], axis="pipe"),
                "head": jax.tree.map(lambda _: PartitionSpec(),
                                     params["head"])}
        trainer = JTrainer(JCfg(**TRAIN, **OPTIMIZER[model]), mesh, forward,
                           jax.tree.map(jnp.asarray, params),
                           param_pspecs=specs,
                           batch_pspec=PartitionSpec())
        losses, norms = [], []
        for b in inputs["batches"]:
            m = trainer.train_step(tuple(map(jnp.asarray, b)))
            losses.append(float(m["loss"]))
            norms.append(float(m["grad_norm"]))
        out[key, model, schedule, backward, remat_stage] = {
            "losses": losses, "norms": norms,
            "params": jax.device_get(trainer.state.params)}
    return out


@pytest.fixture(scope="module")
def inputs():
    """The JAX inits as numpy (per mesh shape, model and chunk count),
    the JAX TokenStream's batches, and the bit cases' stacked stages,
    activations and cotangent."""
    jax = pytest.importorskip("jax", reason="the JAX reference package")
    from tpu_hpc.models import datasets as jds

    out = {"params": {}, "jax_cfgs": {}, "bit_stages": {}}
    for axes, model, schedule, *_ in TRAIN_CASES:
        key, n = tuple(axes.items()), axes["pipe"]
        v = _chunks(schedule)
        if (key, model, v) not in out["params"]:
            cfg, p = _jax_params(jax, model, n, v)
            out["params"][key, model, v] = p
            out["jax_cfgs"][key, model, v] = cfg
    for v in (1, 2):
        _, p = _jax_params(jax, "stack", S, v)
        out["bit_stages"][v] = {k: np.asarray(a)
                                for k, a in _flat(p["stages"]).items()}
    rng = np.random.default_rng(5)
    out["xs_cot"] = tuple(rng.standard_normal((M, 2, SEQ, STACK["dim"]))
                          .astype(np.float32) for _ in range(2))
    ds = jds.TokenStream(vocab_size=STACK["vocab_size"], seq_len=SEQ)
    out["batches"] = [tuple(np.asarray(a) for a in ds.batch_at(i, BATCH))
                      for i in range(UPDATES)]
    return out


@pytest.fixture(scope="module")
def runs(inputs, tmp_path_factory):
    """The world's per-rank results and the JAX trainers'; the world
    runs while this process computes the JAX side."""
    import jax

    from tpu_hpc_torch.runtime.sim import launch_local_world, wait_world

    workdir = str(tmp_path_factory.mktemp("pp_world"))
    with open(os.path.join(workdir, "inputs.pkl"), "wb") as f:
        pickle.dump({k: v for k, v in inputs.items() if k != "jax_cfgs"}, f)
    procs = launch_local_world(
        [sys.executable, os.path.abspath(__file__), workdir], WORLD,
        env=dict(os.environ, PYTHONPATH=REPO), cwd=REPO)
    try:
        jax_train = _jax_train(jax, inputs)
    finally:
        logs = wait_world(procs)
    assert all(rc == 0 for rc, _, _ in logs), [err for _, _, err in logs]
    world = []
    for r in range(WORLD):
        with open(os.path.join(workdir, f"rank{r}.pkl"), "rb") as f:
            world.append(pickle.load(f))
    return world, jax_train


@pytest.mark.parametrize("case", BIT_CASES,
                         ids=["-".join(map(str, c)) for c in BIT_CASES])
def test_process_group_pipe_equals_in_process_pipe_bit_for_bit(runs, case):
    world, _ = runs
    ref = world[0]["in_process"][case]
    v = case[-1]
    for rank, out in enumerate(world):
        got = out["bits"][case]
        assert np.array_equal(got["ys"], ref["ys"]), rank
        assert np.array_equal(got["dxs"], ref["dxs"]), rank
        for g, w in zip(got["grads"], ref["grads"]):
            assert np.array_equal(g, w[rank * v:(rank + 1) * v]), rank


@pytest.mark.parametrize("case", TRAIN_CASES,
                         ids=["-".join(map(str, (*c[0].values(), *c[1:])))
                              for c in TRAIN_CASES])
def test_trainer_matches_jax(runs, case):
    """Three updates with the clip on: losses, the clip's global norm
    (over stage shards that live on different ranks) and the params
    against the JAX Trainer on the same mesh shape, on every rank."""
    world, jax_train = runs
    axes, *rest = case
    key = (tuple(axes.items()), *rest)
    want = jax_train[key]
    for rank, out in enumerate(world):
        got = out["train"][key]
        np.testing.assert_allclose(got["losses"], want["losses"],
                                   rtol=LOSS_RTOL, err_msg=f"rank {rank}")
        np.testing.assert_allclose(got["norms"], want["norms"],
                                   rtol=NORM_RTOL, err_msg=f"rank {rank}")
        flat_want = _flat(want["params"])
        flat_got = _flat(got["params"])
        assert flat_got.keys() == flat_want.keys()
        for path, w in flat_want.items():
            np.testing.assert_allclose(flat_got[path], np.asarray(w),
                                       atol=PARAM_ATOL, rtol=PARAM_RTOL,
                                       err_msg=f"rank {rank} {path}")
    # the clip was on: the norm is above the limit at the start
    assert max(want["norms"]) > TRAIN["max_grad_norm"]


def test_train_cli_pp_on_the_4_process_world(runs):
    world, _ = runs
    lines = [ln for ln in world[0]["cli"].splitlines() if ln.startswith("{")]
    out = json.loads(lines[-1])
    assert out["metric"] == "pp_1f1b_tokens_per_s_per_chip"
    assert out["mesh"] == {"pipe": 4} and out["plan"] == "pipe"
    assert out["n_chunks"] == 1 and out["pp"]["n_stages"] == 4
    assert out["bubble_fraction"] == 3 / 7
    assert out["layout"]["fsdp_units"] == 0
    assert set(out["layout"]["params"]) == {"(Replicate(),)",
                                            "(Shard(dim=0),)"}
    assert len(out["losses"]) == 2
    assert all(np.isfinite(out["losses"]))
    for rank in range(1, WORLD):
        assert world[rank]["cli"] == ""


if __name__ == "__main__":
    _world_main(sys.argv[1])
