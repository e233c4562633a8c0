"""The port's sequence parallelism against the JAX package: ring, zigzag
ring and Ulysses attention on a context axis of 4, and the trainer on a
(data 2, context 2) mesh, in one gloo world of four CPU processes.

The module fixture launches this file as a script four times with
torchrun's variables. Each rank builds a (data 1, context 4) mesh and
runs every attention case on its shard through ``ProcessGroupRing``
(the flash kernels' plain versions, ``flash_attention_dq_ref`` /
``_dkv_ref`` in the ring backward); rank 0 also runs every case on all
four shards at once through ``InProcessRing``. Then each rank trains the
small Llama for three updates per SP mode on a (data 2, context 2) mesh
(FSDP2 over data x context), and once more with the contiguous ring fed
the default local RoPE ramp instead of the shards' global positions;
last it runs the train CLI with ``--sp-mode zigzag``. Meanwhile this
process runs the JAX side on the simulated CPU devices: the JAX
attention functions under ``shard_map`` on a (data 1, context 4) mesh,
the JAX Trainer with the same attn_fn on a (data 2, context 2) mesh,
and the one-device port.

Float32 throughout. Tolerances: attention outputs atol 1e-5; dq/dk/dv
(through a fixed random cotangent) atol 1e-5 / rtol 1e-4 -- the ring's
dq and dK/dV accumulators are float32, as are the merged output and lse;
trainer losses rtol 1e-5 and params atol 2e-6 / rtol 1e-5
(tests/test_torch_distributed.py's limits).
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

WORLD, N_CTX = 4, 4
B, D = 2, 16
# name: (seq, hq, hkv, causal, modes)
ATTN_CASES = {
    "mha": (64, 4, 4, True, ("ring", "zigzag", "zigzag_contiguous",
                             "ulysses")),
    "gqa": (64, 4, 2, True, ("ring", "zigzag", "ulysses")),
    "non_causal": (64, 4, 4, False, ("ring",)),
    # one token per zigzag chunk, two per ring shard: most pairs lie
    # wholly in the future and are skipped, rank 0's q sees one key.
    "short": (8, 4, 4, True, ("ring", "zigzag")),
}
OUT_ATOL, GRAD_ATOL, GRAD_RTOL = 1e-5, 1e-5, 1e-4
LOSS_RTOL, PARAM_ATOL, PARAM_RTOL = 1e-5, 2e-6, 1e-5

SEQ, BATCH, UPDATES, TRAIN_CTX = 32, 4, 3, 2
MODEL = dict(dim=64, n_layers=2, n_heads=4, vocab_size=128, multiple_of=16,
             max_seq_len=SEQ)
TRAIN = dict(epochs=1, steps_per_epoch=UPDATES, global_batch_size=BATCH,
             seed=0, weight_decay=0.1, learning_rate=3e-3, warmup_steps=2,
             grad_accum_steps=2)
SP_MODES = ("ring", "zigzag", "ulysses")
CLI = ["--device", "cpu", "--sp-mode", "zigzag", "--data", "2",
       "--context", "2", "--dim", "64", "--n-layers", "2", "--n-heads", "4",
       "--vocab", "128", "--multiple-of", "16", "--seq-len", "32",
       "--steps", "2", "--epochs", "1", "--batch", "4",
       "--grad-accum-steps", "2"]
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _attn_inputs():
    """Per case: q, k, v and the cotangent, float32, from a numpy seed."""
    rng = np.random.default_rng(0)
    out = {}
    for name, (s, hq, hkv, _, _) in ATTN_CASES.items():
        out[name] = tuple(rng.standard_normal(shape).astype(np.float32)
                          for shape in ((B, s, hq, D), (B, s, hkv, D),
                                        (B, s, hkv, D), (B, s, hq, D)))
    return out


def _layout(mode, s):
    """(idx, inverse) of the layout the port's mode takes its shards in."""
    from tpu_hpc_torch.parallel.ring_attention import zigzag_indices

    if mode == "zigzag":
        return zigzag_indices(N_CTX, s)
    ident = np.arange(s)
    return ident, ident


def _port_attn(mode, ring, causal, q, k, v):
    from tpu_hpc_torch.parallel import ring_attention as ra
    from tpu_hpc_torch.parallel import sp_ulysses
    from tpu_hpc_torch.parallel.ring_attention import (
        _chunks,
        _ring_chunks,
        _unchunk,
    )

    if mode == "ring":
        return ra.ring_attention(q, k, v, ring, causal=causal)
    if mode == "zigzag":
        return ra.zigzag_ring_attention(q, k, v, ring, causal=causal)
    if mode == "ulysses":
        return sp_ulysses.ulysses_attention(q, k, v, ring, causal=causal)
    # zigzag_contiguous: make_zigzag_ring_attn_fn(data_layout=
    # "contiguous")'s moves, on the transport given
    qz, kz, vz = (ring.move_chunks([_chunks(x, 2) for x in xs],
                                   ra.zigzag_moves(ring.n))
                  for xs in (q, k, v))
    outs = _ring_chunks(ring, "zigzag", causal, None, qz, kz, vz)
    outs = ring.move_chunks(outs, ra.zigzag_moves(ring.n, inverse=True))
    return [_unchunk(o) for o in outs]


def _run_attn(ring, shards):
    """Every case and mode on ``shards[name] = [per local rank (q, k, v,
    dout)]``: outputs and gradients per local rank, numpy."""
    out = {}
    for name, (s, _, _, causal, modes) in ATTN_CASES.items():
        for mode in modes:
            idx, _ = _layout(mode, s)
            per = [[torch.from_numpy(np.ascontiguousarray(a[:, idx]))
                    .chunk(N_CTX, 1)[r].contiguous() for a in shards[name]]
                   for r in ring.ranks]
            q, k, v = ([p[j].requires_grad_(True) for p in per]
                       for j in range(3))
            outs = _port_attn(mode, ring, causal, q, k, v)
            grads = torch.autograd.grad(
                outs, [*q, *k, *v], [p[3] for p in per])
            n = len(per)
            out[name, mode] = [
                tuple(t.detach().numpy() for t in
                      (outs[i], grads[i], grads[n + i], grads[2 * n + i]))
                for i in range(n)]
    return out


def _train_cfgs():
    from tpu_hpc_torch.config import TrainingConfig
    from tpu_hpc_torch.models import llama2

    return (TrainingConfig(**TRAIN),
            llama2.LlamaConfig(**MODEL, dtype=torch.float32))


def _world_main(workdir):
    """One rank of the world (run as a script)."""
    from tpu_hpc_torch.models import datasets, llama2
    from tpu_hpc_torch.parallel import fsdp
    from tpu_hpc_torch.parallel import ring_attention as ra
    from tpu_hpc_torch.parallel.plans import P
    from tpu_hpc_torch.parallel.sp_transport import InProcessRing
    from tpu_hpc_torch.runtime import (
        MeshSpec,
        build_mesh,
        cleanup_distributed,
        init_distributed,
    )
    from tpu_hpc_torch.train import __main__ as tmain
    from tpu_hpc_torch.train.trainer import Trainer

    torch.set_num_threads(1)
    with open(os.path.join(workdir, "inputs.pkl"), "rb") as f:
        inputs = pickle.load(f)
    info = init_distributed(device="cpu", verbose=False)
    rank = info.process_id
    attn_mesh = build_mesh(MeshSpec(axes={"data": 1, "context": N_CTX}),
                           "cpu")
    out = {"attn": _run_attn(ra.context_ring(attn_mesh), inputs["attn"])}
    if rank == 0:
        out["in_process"] = _run_attn(InProcessRing(N_CTX), inputs["attn"])

    mesh = build_mesh(MeshSpec(axes={"data": 2, "context": TRAIN_CTX}), "cpu")
    ctx_rank = mesh["context"].get_local_rank()
    cfg, model_cfg = _train_cfgs()
    params = inputs["params"]
    specs = fsdp.param_pspecs(params, axis="data", axis_size=WORLD,
                              min_size=1000)
    makers = {
        "ring": lambda: ra.make_ring_attn_fn(mesh),
        "zigzag": lambda: ra.make_zigzag_ring_attn_fn(
            mesh, data_layout="zigzag"),
        "ulysses": lambda: tmain.sp_attention("ulysses", mesh, model_cfg,
                                              "cpu")[0],
    }
    out["train"] = {}
    for case in (*SP_MODES, "ring_local_positions"):
        mode = case.split("_")[0]
        zigzag = mode == "zigzag"
        positions = (None if case == "ring_local_positions" else
                     ra.shard_positions(TRAIN_CTX, ctx_rank, SEQ, zigzag))
        trainer = Trainer(
            cfg, mesh, llama2.make_forward(model_cfg,
                                           attn_fn=makers[mode](),
                                           positions=positions),
            params, param_pspecs=specs, batch_pspec=P("data", "context"))
        batches = inputs["batches_zigzag" if zigzag else "batches"]
        result = trainer.fit(datasets.ArrayBatches(batches))
        out["train"][case] = {"losses": result["epochs"][0]["losses"],
                              "params": trainer.gather_params()}
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        tmain.main(CLI)  # leaves the process group at its end
    out["cli"] = buf.getvalue()
    with open(os.path.join(workdir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)
    cleanup_distributed()


# ---------------------------------------------------------------------------
# The JAX side and the one-device port (this process)
# ---------------------------------------------------------------------------


def _jax_attn(attn_inputs):
    """Each case and mode through the JAX functions under shard_map on a
    (data 1, context 4) mesh: (out, dq, dk, dv) in contiguous order."""
    import jax
    from jax.sharding import Mesh

    from tpu_hpc.parallel import ring_attention as jra
    from tpu_hpc.parallel import sp_ulysses as jsu

    mesh = Mesh(np.array(jax.devices()[:N_CTX]).reshape(1, N_CTX),
                ("data", "context"))
    def with_grads(fn):
        def run(q, k, v, dout):
            o, vjp = jax.vjp(fn, q, k, v)
            return (o, *vjp(dout))

        return jax.jit(run)

    out = {}
    for name, (_, _, _, causal, modes) in ATTN_CASES.items():
        arrays = tuple(map(jax.numpy.asarray, attn_inputs[name]))
        for mode in modes:
            if mode == "zigzag_contiguous":  # the same JAX function
                out[name, mode] = out[name, "zigzag"]
                continue
            if mode == "ring":
                fn = jra.make_ring_attn_fn(mesh, causal=causal, impl="xla")
            elif mode == "ulysses":
                fn = jsu.make_ulysses_attn_fn(mesh, causal=causal,
                                              impl="xla")
            else:  # the JAX permute-run-unpermute over contiguous arrays
                fn = jra.make_zigzag_ring_attn_fn(mesh, causal=causal,
                                                  impl="xla")
            out[name, mode] = tuple(np.asarray(a)
                                    for a in with_grads(fn)(*arrays))
    return out


def _jax_train(inputs):
    """The JAX Trainer per SP mode on a (data 2, context 2) mesh with the
    mode's attn_fn, cp_constrain, P("data", "context") batches and, for
    zigzag, the stream's positions."""
    import jax
    from jax.sharding import Mesh, PartitionSpec

    from tpu_hpc.config import TrainingConfig as JCfg
    from tpu_hpc.models import datasets as jds
    from tpu_hpc.models import llama2 as jl
    from tpu_hpc.parallel import ring_attention as jra
    from tpu_hpc.parallel import sp_ulysses as jsu
    from tpu_hpc.train import Trainer as JTrainer

    mesh = Mesh(np.array(jax.devices()[:WORLD]).reshape(2, TRAIN_CTX),
                ("data", "context"))
    jcfg = jl.LlamaConfig(**MODEL, dtype=jax.numpy.float32)
    params = jax.tree.map(jax.numpy.asarray, inputs["params"])
    out = {}
    for mode in SP_MODES:
        positions = None
        if mode == "ring":
            attn = jra.make_ring_attn_fn(mesh, impl="xla")
        elif mode == "ulysses":
            attn = jsu.make_ulysses_attn_fn(mesh, impl="xla")
        else:
            attn = jra.make_zigzag_ring_attn_fn(mesh, impl="xla",
                                                data_layout="zigzag")
            positions = jds.TokenStream(
                vocab_size=MODEL["vocab_size"], seq_len=SEQ,
                zigzag_ring=TRAIN_CTX).positions()
        trainer = JTrainer(
            JCfg(**TRAIN), mesh,
            jl.make_forward(jcfg, jra.cp_constrain(mesh), attn, positions),
            params, batch_pspec=PartitionSpec("data", "context"))
        batches = inputs["batches_zigzag" if mode == "zigzag" else "batches"]
        losses = [float(trainer.train_step(
            tuple(map(jax.numpy.asarray, b)))["loss"]) for b in batches]
        out[mode] = {"losses": losses,
                     "params": jax.device_get(trainer.state.params)}
    return out


def _one_device(inputs):
    """The one-device port on the contiguous batches (flash plain
    versions, no context axis)."""
    from tpu_hpc_torch.models import datasets, llama2
    from tpu_hpc_torch.parallel import tp
    from tpu_hpc_torch.train.trainer import Trainer, tree_map

    cfg, model_cfg = _train_cfgs()
    trainer = Trainer(
        cfg, None, llama2.make_forward(
            model_cfg, attn_fn=tp.make_tp_flash_attn_fn(None, impl="cuda")),
        tree_map(torch.from_numpy, inputs["params"]), device="cpu")
    result = trainer.fit(datasets.ArrayBatches(inputs["batches"]))
    return {"losses": result["epochs"][0]["losses"],
            "params": tree_map(lambda t: t.detach().numpy(),
                               trainer.state.params)}


@pytest.fixture(scope="module")
def inputs():
    """The attention cases' arrays, the JAX init's params and the JAX
    TokenStream's batches (contiguous and zigzag), as numpy."""
    jax = pytest.importorskip("jax", reason="the JAX reference package")
    from tpu_hpc.models import datasets as jds
    from tpu_hpc.models import llama2 as jl

    jcfg = jl.LlamaConfig(**MODEL, dtype=jax.numpy.float32)
    out = {"attn": _attn_inputs(),
           "params": jax.device_get(jl.init_llama(jax.random.key(0), jcfg))}
    for key, ring in (("batches", None), ("batches_zigzag", TRAIN_CTX)):
        ds = jds.TokenStream(vocab_size=MODEL["vocab_size"], seq_len=SEQ,
                             zigzag_ring=ring)
        out[key] = [tuple(np.asarray(a) for a in ds.batch_at(i, BATCH))
                    for i in range(UPDATES)]
    return out


@pytest.fixture(scope="module")
def runs(inputs, tmp_path_factory):
    """The world's per-rank results, the JAX attention and trainer
    results and the one-device port's; the world runs while this
    process computes the rest."""
    from tpu_hpc_torch.runtime.sim import launch_local_world, wait_world

    workdir = str(tmp_path_factory.mktemp("sp_world"))
    with open(os.path.join(workdir, "inputs.pkl"), "wb") as f:
        pickle.dump(inputs, f)
    procs = launch_local_world(
        [sys.executable, os.path.abspath(__file__), workdir], WORLD,
        env=dict(os.environ, PYTHONPATH=REPO), cwd=REPO)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)  # the world's four processes share the cores
    try:
        jax_attn = _jax_attn(inputs["attn"])
        jax_train = _jax_train(inputs)
        one = _one_device(inputs)
    finally:
        torch.set_num_threads(threads)
        logs = wait_world(procs)
    assert all(rc == 0 for rc, _, _ in logs), [err for _, _, err in logs]
    world = []
    for r in range(WORLD):
        with open(os.path.join(workdir, f"rank{r}.pkl"), "rb") as f:
            world.append(pickle.load(f))
    return world, jax_attn, jax_train, one


def _whole(per_rank, mode, s):
    """Per-rank (out, dq, dk, dv) shards -> whole arrays in contiguous
    order."""
    _, inv = _layout(mode, s)
    return [np.concatenate([r[j] for r in per_rank], axis=1)[:, inv]
            for j in range(4)]


ATTN_PARAMS = [(name, mode) for name, case in ATTN_CASES.items()
               for mode in case[4]]


@pytest.mark.parametrize("name,mode", ATTN_PARAMS)
def test_attention_matches_jax(runs, name, mode):
    """Output and dq/dk/dv of each rank's shard, gathered, against the
    JAX function under shard_map on the same arrays."""
    world, jax_attn, _, _ = runs
    got = _whole([w["attn"][name, mode][0] for w in world], mode,
                 ATTN_CASES[name][0])
    want = jax_attn[name, mode]
    np.testing.assert_allclose(got[0], want[0], atol=OUT_ATOL, rtol=0,
                               err_msg="out")
    for label, g, w in zip(("dq", "dk", "dv"), got[1:], want[1:]):
        assert np.isfinite(g).all(), label
        np.testing.assert_allclose(g, w, atol=GRAD_ATOL, rtol=GRAD_RTOL,
                                   err_msg=label)


@pytest.mark.parametrize("name,mode", ATTN_PARAMS)
def test_in_process_ring_equals_the_gloo_world(runs, name, mode):
    """The in-process transport runs the schedule the process-group ring
    runs: the same outputs and gradients, bit for bit, per rank."""
    world = runs[0]
    local = world[0]["in_process"][name, mode]
    for r in range(N_CTX):
        remote = world[r]["attn"][name, mode][0]
        for a, b in zip(local[r], remote):
            assert np.array_equal(a, b)


def test_wholly_future_partial_merges_as_a_no_op():
    """A kv chunk wholly after the q chunk (what the ring skips) merges
    into (0, MASK_VALUE) as an exact no-op, NaN-free forward and
    backward -- the JAX test_fully_masked_chunk_is_noop."""
    from tpu_hpc_torch.kernels import attention as fa

    gen = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn((2, 8, 4, D), generator=gen).requires_grad_(True)
               for _ in range(3))
    o, lse = fa.flash_attention(q, k, v, 0, 100, True)
    assert not o.any() and bool((lse <= fa.MASK_VALUE * 0.5).all())
    out0 = torch.zeros(o.shape, dtype=torch.float32)
    lse0 = torch.full(lse.shape, fa.MASK_VALUE)
    out, merged = fa.lse_merge(out0, lse0, o, lse)
    assert not out.any() and torch.equal(merged, lse0)
    o2, l2 = fa.flash_attention(q, k, v, 0, 0, True)
    out, merged = fa.lse_merge(*fa.lse_merge(out0, lse0, o, lse), o2, l2)
    assert torch.equal(out, o2) and torch.equal(merged, l2)
    grads = torch.autograd.grad(out.sum() + merged.sum(), (q, k, v))
    assert all(torch.isfinite(g).all() for g in grads)


@pytest.mark.parametrize("mode", SP_MODES)
def test_trainer_matches_jax_and_one_device(runs, mode):
    """Three updates on (data 2, context 2): losses and final params
    against the JAX Trainer with the same attn_fn on the same mesh, and
    against the one-device port on the contiguous batches."""
    world, _, jax_train, one = runs
    got = world[0]["train"][mode]
    assert len(got["losses"]) == UPDATES and np.isfinite(got["losses"]).all()
    for r in range(1, WORLD):
        assert world[r]["train"][mode]["losses"] == got["losses"]
    for ref in (jax_train[mode], one):
        np.testing.assert_allclose(got["losses"], ref["losses"],
                                   rtol=LOSS_RTOL)
        want = dict(_leaves(ref["params"]))
        have = dict(_leaves(got["params"]))
        assert have.keys() == want.keys()
        for path, w in want.items():
            np.testing.assert_allclose(have[path], w, atol=PARAM_ATOL,
                                       rtol=PARAM_RTOL, err_msg=path)


def test_default_local_positions_fail_to_match(runs):
    """A context rank runs the model on its local shard: fed the default
    ramp 0..S/n-1 instead of its global positions, rank 1's rotations
    are wrong, and after three updates the params leave the JAX
    Trainer's by more than the limits. (The losses barely move: at this
    init attention is near uniform, and the loss is ~log(vocab) either
    way.)"""
    world, _, jax_train, _ = runs
    wrong = world[0]["train"]["ring_local_positions"]
    assert np.isfinite(wrong["losses"]).all()
    want = dict(_leaves(jax_train["ring"]["params"]))
    have = dict(_leaves(wrong["params"]))
    off = {path: not np.allclose(have[path], w, atol=PARAM_ATOL,
                                 rtol=PARAM_RTOL)
           for path, w in want.items()}
    # RoPE rotates q and k only: the attention projections leave the
    # limits, the leaves the rotation never reaches may not.
    assert off["layers_0/attention/wq/kernel"], off
    assert off["layers_0/attention/wk/kernel"], off


def _leaves(tree, prefix=""):
    for key in sorted(tree):
        node, path = tree[key], f"{prefix}/{key}" if prefix else key
        if isinstance(node, dict):
            yield from _leaves(node, path)
        else:
            yield path, np.asarray(node)


def test_train_cli_sp_on_the_2x2_world(runs):
    """``python -m tpu_hpc_torch.train --sp-mode zigzag --data 2
    --context 2``: FSDP2 over data x context, bench.py's metric name."""
    lines = [ln for ln in runs[0][0]["cli"].splitlines()
             if ln.startswith("{")]
    assert len(lines) == 1
    out = json.loads(lines[0])
    assert out["metric"] == "llama2_sp_zigzag_tokens_per_s_per_chip"
    assert out["sp_mode"] == "zigzag" and out["plan"] == "fsdp"
    assert out["mesh"] == {"data": 2, "context": 2}
    assert out["world_size"] == 4 and out["global_batch"] == 8
    assert out["layout"]["fsdp_units"] == 3
    assert len(out["losses"]) == 2 and all(np.isfinite(out["losses"]))
    assert out["value"] == pytest.approx(out["tokens_per_s"] / 4)


def test_pure_parts_match_jax():
    """zigzag_indices (permutation, inverse, divisibility error) and
    causal_live_pairs equal the JAX functions for n in 1..8."""
    jax = pytest.importorskip("jax", reason="the JAX reference package")
    del jax
    from tpu_hpc.parallel import ring_attention as jra

    from tpu_hpc_torch.parallel import ring_attention as ra

    for n in range(1, 9):
        for s in (2 * n, 8 * n, 48 * n):
            for got, want in zip(ra.zigzag_indices(n, s),
                                 jra.zigzag_indices(n, s)):
                assert np.array_equal(got, np.asarray(want))
        for zigzag in (False, True):
            assert ra.causal_live_pairs(n, zigzag) == \
                jra.causal_live_pairs(n, zigzag)
        with pytest.raises(ValueError, match=f"2\\*ring={2 * n}"):
            ra.zigzag_indices(n, 2 * n + 1)
        with pytest.raises(ValueError, match=f"2\\*ring={2 * n}"):
            jra.zigzag_indices(n, 2 * n + 1)


def test_live_pairs_are_what_causal_live_pairs_counts():
    """The ring's host-side skip launches, per rank, exactly the pairs
    causal_live_pairs counts; the zigzag ring's 2n + 1 on every rank."""
    from tpu_hpc_torch.parallel import ring_attention as ra

    for n in range(1, 9):
        for layout, zigzag in (("ring", False), ("zigzag", True)):
            got = [sum(len(ra.live_pairs(layout, n, r, s, True))
                       for s in range(n)) for r in range(n)]
            assert got == ra.causal_live_pairs(n, zigzag)
            assert all(len(ra.live_pairs(layout, n, r, s, False))
                       == (1 if layout == "ring" else 4)
                       for r in range(n) for s in range(n))


def test_token_stream_zigzag_layout_and_positions():
    """TokenStream(zigzag_ring=n): the JAX permutation applied to the
    same tokens (inputs and targets together), positions() the
    permutation; a context rank's shard_positions are its slice."""
    jax = pytest.importorskip("jax", reason="the JAX reference package")
    del jax
    from tpu_hpc.models import datasets as jds

    from tpu_hpc_torch.models import datasets
    from tpu_hpc_torch.parallel import ring_attention as ra

    contig = datasets.TokenStream(vocab_size=64, seq_len=32)
    zig = datasets.TokenStream(vocab_size=64, seq_len=32, zigzag_ring=4)
    ci, ct = contig.batch_at(3, 2)
    zi, zt = zig.batch_at(3, 2)
    jidx = np.asarray(jds.TokenStream(vocab_size=64, seq_len=32,
                                      zigzag_ring=4).positions())
    assert torch.equal(zi, ci[:, jidx]) and torch.equal(zt, ct[:, jidx])
    assert np.array_equal(zig.positions().numpy(), jidx)
    assert contig.positions() is None
    for r in range(4):
        assert np.array_equal(ra.shard_positions(4, r, 32, True).numpy(),
                              jidx[r * 8:(r + 1) * 8])
        assert np.array_equal(ra.shard_positions(4, r, 32, False).numpy(),
                              np.arange(r * 8, (r + 1) * 8))


def test_refusals():
    """Ulysses' degree (the JAX check), zigzag's S % 2n at the stream
    and the hook, and --sp-mode with --model > 1 at the CLI."""
    from tpu_hpc_torch.models import datasets
    from tpu_hpc_torch.parallel import ring_attention as ra
    from tpu_hpc_torch.parallel import sp_ulysses
    from tpu_hpc_torch.parallel.sp_transport import InProcessRing
    from tpu_hpc_torch.train import __main__ as tmain

    with pytest.raises(ValueError, match="n_heads % degree"):
        sp_ulysses.validate_ulysses_degree(6, 4)
    sp_ulysses.validate_ulysses_degree(8, 4)
    x = torch.zeros(1, 6, 6, D)
    with pytest.raises(ValueError, match="n_heads % degree"):
        sp_ulysses.ulysses_attention([x] * 4, [x] * 4, [x] * 4,
                                     InProcessRing(4))
    with pytest.raises(ValueError, match=r"divisible by 2\*ring=8"):
        datasets.TokenStream(seq_len=36, zigzag_ring=4)
    with pytest.raises(ValueError, match=r"divisible by 2\*ring=2"):
        ra.make_zigzag_ring_attn_fn(None, data_layout="zigzag")(x[:, :5],
                                                               x[:, :5],
                                                               x[:, :5])
    with pytest.raises(ValueError, match="data_layout"):
        ra.make_zigzag_ring_attn_fn(None, data_layout="striped")
    with pytest.raises(SystemExit) as e:
        tmain.main(["--device", "cpu", "--sp-mode", "ring", "--model", "2"])
    assert e.value.code == 2
    with pytest.raises(ValueError, match="does not combine with TP"):
        tmain.resolve_plan("hybrid", None, "ring")
    assert tmain.sp_mesh_axes(4) == {"data": 1, "context": 4}
    assert tmain.sp_mesh_axes(4, context=2) == {"data": 2, "context": 2}
    assert tmain.sp_mesh_axes(4, data=3) is None


if __name__ == "__main__":
    _world_main(sys.argv[1])
