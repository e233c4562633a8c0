"""The port's pipeline parallelism against the JAX package, in one
process: every stage through ``InProcessPipe`` here, the JAX
``pp.pipelined`` on 4 simulated CPU devices.

  * the schedule tables (``pp.schedule_table``) against the JAX tick
    programs' own decode of each tick (which ops run, on which stage and
    chunk, at which tick) for S in {1, 2, 4}, M in {S, 2S, S+1} and v in
    {1, 2}, and ``bubble_fraction`` equal to JAX's over the same grid;
  * the most stage inputs or graphs a stage holds (1F1B: 2(S-s)-1);
  * microbatching, the interleave helpers, the Llama split/merge and the
    refusals (their messages equal JAX's word for word);
  * the pipeline's outputs and the loss and gradients of every schedule x
    backward for the stack model and the Llama, from the JAX init's
    params (``pipe_params_from_numpy``). The JAX side runs the einsum
    attention, the port its flash kernels' plain versions through the
    same ``torch.autograd.Function`` the card uses.

Float32 throughout. Tolerances: outputs and losses atol 1e-5; gradients
atol 1e-5 / rtol 1e-4 (tests/test_torch_sp.py's limits).
"""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax", reason="the JAX reference package")
jnp = jax.numpy

from tpu_hpc.models import llama2 as jl  # noqa: E402
from tpu_hpc.models import llama_pp as jlpp  # noqa: E402
from tpu_hpc.models import losses as jlosses  # noqa: E402
from tpu_hpc.models import pipeline_transformer as jptx  # noqa: E402
from tpu_hpc.parallel import pp as jpp  # noqa: E402
from tpu_hpc.runtime import MeshSpec, build_mesh  # noqa: E402
from tpu_hpc_torch.kernels.attention import blockwise_attention  # noqa: E402
from tpu_hpc_torch.models import llama2, llama_pp  # noqa: E402
from tpu_hpc_torch.models import pipeline_transformer as ptx  # noqa: E402
from tpu_hpc_torch.parallel import pp  # noqa: E402
from tpu_hpc_torch.parallel.pp_transport import InProcessPipe  # noqa: E402

OUT_ATOL, GRAD_ATOL, GRAD_RTOL = 1e-5, 1e-5, 1e-4
S = 4
BATCH, SEQ = 8, 16
STACK = dict(vocab_size=64, dim=32, n_heads=2, max_seq_len=SEQ)
LLAMA = dict(dim=64, n_layers=8, n_heads=4, vocab_size=97, multiple_of=32,
             max_seq_len=SEQ)


# ---------------------------------------------------------------------------
# Schedules
# ---------------------------------------------------------------------------

def _jax_decode(schedule, S, M, V, program):
    """The ops the JAX tick programs run (their valid ticks), decoded as
    pp.py's programs decode each (tick, axis_index), and their tick
    count."""
    ops = []

    def fwd(t, sid):
        if schedule in ("gpipe", "1f1b"):
            f = t - sid
            return (0, f) if 0 <= f < M else None
        d = t - sid
        r = max(d, 0) % S
        e = max(d - r, 0) // S
        f = (e // V) * S + r
        return (e % V, f) if d >= 0 and f < M else None

    if program == "forward" or schedule in ("gpipe", "interleaved"):
        n = (M + S - 1 if schedule in ("gpipe", "1f1b") else
             ((M - 1) // S) * S * V + S * V - 1 + ((M - 1) % S) + 1)
        for t in range(n):
            for sid in range(S):
                op = fwd(t, sid)
                if op is not None:
                    ops.append((t, sid, op[0], "F", op[1]))
        if program == "backward":  # the transposed scan
            ops = [(n - 1 - t, s, j, "B", f) for t, s, j, _, f in ops]
        return sorted(ops), n
    if schedule == "1f1b":
        n = M + 2 * S - 1
    else:
        G = S * V
        n = G + ((M - 1) // S) * G + (V - 1) * S + (S - 1) + (M - 1) % S + 1
    for t in range(n):
        for sid in range(S):
            op = fwd(t, sid)
            if op is not None:
                ops.append((t, sid, op[0], "F", op[1]))
            if schedule == "1f1b":
                b, j2 = t - (2 * S - 1 - sid), 0
                ok = 0 <= b < M
            else:
                d2 = t - S * V - (S - 1 - sid)
                r2 = max(d2, 0) % S
                e2 = max(d2 - r2, 0) // S
                j2, b = V - 1 - (e2 % V), (e2 // V) * S + r2
                ok = d2 >= 0 and b < M
            if ok:
                ops.append((t, sid, j2, "B", b))
    return sorted(ops), n


GRID = [(s, m, v) for s in (1, 2, 4) for m in sorted({s, 2 * s, s + 1})
        for v in (1, 2)]


@pytest.mark.parametrize("schedule", pp.SCHEDULES)
@pytest.mark.parametrize("program", ["forward", "backward"])
def test_schedule_tables_equal_the_jax_tick_programs(schedule, program):
    for s, m, v in GRID:
        if v > 1 and schedule not in pp.INTERLEAVED:
            continue
        table = pp.schedule_table(schedule, s, m, v, program)
        want, n_ticks = _jax_decode(schedule, s, m, v, program)
        assert sorted(tuple(o) for o in table) == want, (s, m, v)
        assert max(o.tick for o in table) + 1 == n_ticks, (s, m, v)
        # one forward and one backward op per stage and tick at most
        slots = [(o.tick, o.stage, o.op) for o in table]
        assert len(slots) == len(set(slots)), (s, m, v)
        # the driver's order: by tick, then stage, backward first
        assert table == sorted(table, key=lambda o: (o.tick, o.stage, o.op))


def test_bubble_fraction_equals_jax():
    for s, m, v in GRID + [(8, 8, 1), (4, 8, 2), (2, 3, 4)]:
        assert pp.bubble_fraction(s, m, v) == jpp.bubble_fraction(s, m, v)
        assert pp.forward_ticks(s, m, v) == _jax_decode(
            "interleaved", s, m, v, "forward")[1]


def _scale_stage(tree, x):
    return x * tree["w"]


@pytest.mark.parametrize("schedule,backward,want", [
    ("1f1b", "remat", lambda s, m: min(2 * (S - s) - 1, m)),
    ("1f1b", "stash", lambda s, m: min(2 * (S - s) - 1, m)),
    ("gpipe", "remat", lambda s, m: m),
])
def test_most_inputs_or_graphs_a_stage_holds(schedule, backward, want):
    """1F1B keeps at most 2(S-s)-1 stage inputs (remat) or graphs
    (stash) at stage s between ticks; GPipe keeps every microbatch's."""
    for m in (S, 2 * S, 3 * S):
        fn = pp.pipelined(_scale_stage, InProcessPipe(S), schedule=schedule,
                          backward=backward)
        w = torch.linspace(0.5, 2.0, S)[:, None].requires_grad_()
        xs = torch.randn(m, 2, 3, requires_grad=True)
        fn({"w": w}, xs).sum().backward()
        assert fn.engine.peak_live == {s: want(s, m) for s in range(S)}
        torch.testing.assert_close(xs.grad, torch.prod(w.detach()).expand(
            m, 2, 3), rtol=0, atol=1e-6)


def test_microbatching_and_interleave_helpers_equal_jax():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((8, 3, 5)).astype(np.float32)
    got = pp.microbatch(torch.from_numpy(x), 4)
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(jpp.microbatch(x, 4)))
    np.testing.assert_array_equal(pp.unmicrobatch(got).numpy(), x)
    with pytest.raises(ValueError, match="not divisible by 3"):
        pp.microbatch(torch.from_numpy(x), 3)
    per = [{"a": {"w": rng.standard_normal((2, 3)).astype(np.float32)},
            "b": rng.standard_normal(4).astype(np.float32)} for _ in range(8)]
    tper = [{"a": {"w": torch.from_numpy(p["a"]["w"])},
             "b": torch.from_numpy(p["b"])} for p in per]
    for n_dev in (2, 4):
        want = jpp.stack_interleaved_stage_params(per, n_dev)
        got = pp.stack_interleaved_stage_params(tper, n_dev)
        np.testing.assert_array_equal(got["a"]["w"].numpy(),
                                      np.asarray(want["a"]["w"]))
        again = pp.interleave_stacked(pp.stack_stage_params(tper), n_dev)
        np.testing.assert_array_equal(again["b"].numpy(),
                                      np.asarray(want["b"]))
    assert pp.stage_pspecs({"w": torch.zeros(4, 2, 3)}) == {
        "w": pp.P("pipe", None, None)}


def test_manual_stage_step_equals_jax():
    mesh = build_mesh(MeshSpec(axes={"pipe": S}), devices=jax.devices()[:S])
    x = np.arange(S * 3, dtype=np.float32).reshape(S, 3)
    want = np.asarray(jpp.manual_stage_step(mesh)(jnp.asarray(x)))
    got = pp.manual_stage_step(InProcessPipe(S))(
        list(torch.from_numpy(x)[:, None]))
    np.testing.assert_array_equal(torch.cat(got).numpy(), want)


def _raises_same(jax_call, port_call):
    with pytest.raises(ValueError) as jerr:
        jax_call()
    with pytest.raises(ValueError) as perr:
        port_call()
    assert str(perr.value) == str(jerr.value)


@pytest.mark.parametrize("kw", [
    dict(schedule="gpipe", n_chunks=2),
    dict(schedule="foo", n_chunks=2),
    dict(schedule="1f1b", backward="bogus"),
    dict(schedule="gpipe", backward="stash"),
    dict(schedule="interleaved", backward="stash", n_chunks=2),
    dict(schedule="1f1b", remat_stage=True),
    dict(schedule="interleaved-1f1b", remat_stage=True, n_chunks=2),
    dict(schedule="foo"),
], ids=lambda kw: "-".join(f"{k}={v}" for k, v in kw.items()))
def test_refusals_match_jax(kw):
    mesh = build_mesh(MeshSpec(axes={"pipe": S}), devices=jax.devices()[:S])
    _raises_same(lambda: jpp.pipelined(lambda p, x: x, mesh, **kw),
                 lambda: pp.pipelined(_scale_stage, InProcessPipe(S), **kw))


def test_chunk_mismatch_refused_like_jax():
    """Params stacked for one chunk a stage under n_chunks=2 (the
    forgot-to-interleave mistake) are refused, as JAX refuses them."""
    mesh = build_mesh(MeshSpec(axes={"pipe": S}), devices=jax.devices()[:S])
    w = np.ones((S, 1), np.float32)
    xs = np.ones((4, 2, 1), np.float32)
    jfn = jpp.pipelined(lambda p, x: x * p["w"], mesh,
                        schedule="interleaved", n_chunks=2)
    pfn = pp.pipelined(_scale_stage, InProcessPipe(S),
                       schedule="interleaved", n_chunks=2)
    _raises_same(lambda: jfn({"w": jnp.asarray(w)}, jnp.asarray(xs)),
                 lambda: pfn({"w": torch.from_numpy(w)},
                             torch.from_numpy(xs)))


# ---------------------------------------------------------------------------
# Models: the port against pp.pipelined, schedule by schedule
# ---------------------------------------------------------------------------

def _np(tree):
    return jax.tree.map(lambda a: np.array(a), jax.device_get(tree))


@pytest.fixture(scope="module")
def jax_params():
    """The JAX inits (stack at v = 1 and v = 2, the Llama split both
    ways), the batch, and the 4-device pipe mesh."""
    mesh = build_mesh(MeshSpec(axes={"pipe": S}), devices=jax.devices()[:S])
    cfg = jptx.PipeConfig(**STACK, n_stages=S, layers_per_stage=2)
    p = jax.jit(lambda k: jptx.init_pipeline_transformer(k, cfg))(
        jax.random.key(0))
    # v = 2: the same layers as 8 one-layer stages (global stage g is
    # stage g // 2's layer g % 2), stacked in the interleaved layout.
    eight = jax.tree.map(lambda *ls: jnp.stack(ls), *[
        {"layer_0": jax.tree.map(lambda a: a[g // 2],
                                 p["stages"][f"layer_{g % 2}"])}
        for g in range(2 * S)])
    stacks = {1: (cfg, p), 2: (
        jptx.PipeConfig(**STACK, n_stages=2 * S, layers_per_stage=1),
        dict(p, stages=jpp.interleave_stacked(eight, S)))}
    lcfg = jl.LlamaConfig(**LLAMA, dtype=jnp.float32)
    full = jl.init_llama(jax.random.key(0), lcfg)
    llamas = {1: (lcfg, jlpp.split_params(full, lcfg, S)),
              2: (lcfg, jlpp.split_params_interleaved(full, lcfg, S, 2)),
              "full": full}
    rng = np.random.default_rng(3)
    tokens = rng.integers(0, 64, (BATCH, SEQ + 1)).astype(np.int32)
    return mesh, stacks, llamas, (tokens[:, :-1], tokens[:, 1:])


def _flash(q, k, v):
    return blockwise_attention(q, k, v, causal=True, impl="cuda")[0]


def _jax_run(model, cfg, params, mesh, batch, M, schedule, backward,
             remat_stage, v):
    """JAX: (ys of the pipelined body on the embedded batch, loss,
    grads)."""
    kw = dict(schedule=schedule, backward=backward,
              remat_stage=remat_stage, n_chunks=v)
    tok, tgt = map(jnp.asarray, batch)
    if model == "stack":
        pipe = jpp.pipelined(jptx.make_stage_fn(cfg), mesh, axis="pipe", **kw)

        def embed(p):
            return jptx.embed(p, jpp.microbatch(tok, M), cfg)

        def loss(p):
            ys = pipe(p["stages"], embed(p))
            return jlosses.cross_entropy(jptx.head(p, ys, cfg),
                                         jpp.microbatch(tgt, M))
    else:
        pipe = jpp.pipelined(jlpp.make_stage_fn(cfg, S * v), mesh,
                             axis="pipe", **kw)
        forward = jlpp.make_forward(cfg, mesh, M, **kw)

        def embed(p):
            return jlpp.embed(p["edges"], jpp.microbatch(tok, M), cfg)

        def loss(p):
            return forward(p, {}, (tok, tgt), None)[0]

    ys, (value, grads) = jax.jit(lambda p: (
        pipe(p["stages"], embed(p)), jax.value_and_grad(loss)(p)))(params)
    return np.asarray(ys), float(value), _np(grads)


def _port_run(model, cfg, params, batch, M, schedule, backward,
              remat_stage, v):
    kw = dict(schedule=schedule, backward=backward,
              remat_stage=remat_stage, n_chunks=v, attn_fn=_flash)
    tok, tgt = (torch.from_numpy(a).long() for a in batch)
    mod = ptx if model == "stack" else llama_pp
    forward = mod.make_forward(cfg, InProcessPipe(S), M, **kw)
    params = ptx._map(lambda t: t.requires_grad_(), params)
    loss, _, _ = forward(params, {}, (tok, tgt), None)
    loss.backward()
    with torch.no_grad():
        if model == "stack":
            xs = ptx.embed(params, pp.microbatch(tok, M), cfg)
        else:
            xs = llama_pp.embed(params["edges"], pp.microbatch(tok, M), cfg)
        ys = forward.pipe(ptx.local_tree(params)["stages"], xs)
    return (ys.numpy(), float(loss.detach()),
            ptx._map(lambda t: t.grad.numpy(), params))


CASES = [
    # model, schedule, backward, remat_stage, v, M
    ("stack", "gpipe", "remat", False, 1, 4),
    ("stack", "gpipe", "remat", True, 1, 4),
    ("stack", "1f1b", "remat", False, 1, 4),
    ("stack", "1f1b", "stash", False, 1, 4),
    ("stack", "interleaved", "remat", False, 2, 4),
    ("stack", "interleaved", "remat", True, 2, 8),
    ("stack", "interleaved-1f1b", "remat", False, 2, 4),
    ("stack", "interleaved-1f1b", "stash", False, 2, 2),
    ("llama", "gpipe", "remat", True, 1, 4),
    ("llama", "1f1b", "remat", False, 1, 8),
    ("llama", "1f1b", "stash", False, 1, 4),
    ("llama", "interleaved", "remat", True, 2, 4),
    ("llama", "interleaved-1f1b", "remat", False, 2, 4),
    ("llama", "interleaved-1f1b", "stash", False, 2, 2),
]


@pytest.mark.parametrize("model,schedule,backward,remat_stage,v,M", CASES,
                         ids=["-".join(map(str, c)) for c in CASES])
def test_schedule_matches_jax_pipelined(jax_params, model, schedule, backward,
                                        remat_stage, v, M):
    mesh, stacks, llamas, batch = jax_params
    jcfg, jparams = (stacks if model == "stack" else llamas)[v]
    want = _jax_run(model, jcfg, jparams, mesh, batch, M, schedule,
                    backward, remat_stage, v)
    if model == "stack":
        cfg = ptx.PipeConfig(**STACK, n_stages=S * v,
                             layers_per_stage=2 // v)
        params = ptx.pipe_params_from_numpy(_np(jparams), cfg, S, v)
    else:
        cfg = llama2.LlamaConfig(**LLAMA, dtype=torch.float32)
        params = llama_pp.pipe_params_from_numpy(_np(jparams), cfg, S, v)
    ys, loss, grads = _port_run(model, cfg, params, batch, M, schedule,
                                backward, remat_stage, v)
    np.testing.assert_allclose(ys, want[0], atol=OUT_ATOL, rtol=0)
    np.testing.assert_allclose(loss, want[1], atol=OUT_ATOL, rtol=0)
    flat_want = jax.tree_util.tree_flatten_with_path(want[2])[0]
    got_leaves = pp._flatten(grads)[1]
    assert len(flat_want) == len(got_leaves)
    for (path, w), g in zip(flat_want, got_leaves):
        np.testing.assert_allclose(g, w, atol=GRAD_ATOL, rtol=GRAD_RTOL,
                                   err_msg=jax.tree_util.keystr(path))


def test_interleaved_params_not_reordered_fail_to_match(jax_params):
    """The control: the same params stacked in sequential order under
    the interleaved schedule run the stages in another order, and the
    loss no longer matches."""
    mesh, stacks, _, batch = jax_params
    jcfg, jparams = stacks[2]
    want = _jax_run("stack", jcfg, jparams, mesh, batch, 4,
                    "interleaved-1f1b", "remat", False, 2)
    cfg = ptx.PipeConfig(**STACK, n_stages=S * 2, layers_per_stage=1)
    params = ptx.pipe_params_from_numpy(_np(jparams), cfg, S, 2)
    order = pp._interleave_order(S * 2, S)
    inv = sorted(range(len(order)), key=order.__getitem__)
    params["stages"] = ptx._map(lambda a: a[inv], params["stages"])
    _, loss, _ = _port_run("stack", cfg, params, batch, 4,
                           "interleaved-1f1b", "remat", False, 2)
    assert abs(loss - want[1]) > 1e-4


def test_llama_split_merge_equal_jax(jax_params):
    _, _, llamas, _ = jax_params
    full = _np(llamas["full"])
    cfg = llama2.LlamaConfig(**LLAMA, dtype=torch.float32)
    tfull = ptx._map(torch.from_numpy, full)
    for v, split in ((1, llama_pp.split_params(tfull, cfg, S)),
                     (2, llama_pp.split_params_interleaved(tfull, cfg, S,
                                                           2))):
        want = jax.tree.leaves(_np(llamas[v][1]))
        got = pp._flatten(split)[1]
        for w, g in zip(want, got):
            np.testing.assert_array_equal(g.numpy(), w)
    back = llama_pp.merge_params_interleaved(split, cfg, S, 2)
    for a, b in zip(pp._flatten(back)[1], pp._flatten(tfull)[1]):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="divisible by the stage count 3"):
        llama_pp.split_params(tfull, cfg, 3)


def test_sequential_oracles_equal_jax(jax_params):
    """The port's own oracles (``apply_sequential``, ``apply_llama`` on
    ``merge_params``) give JAX's logits on the same params."""
    _, stacks, llamas, (tok, _) = jax_params
    jcfg, jparams = stacks[1]
    cfg = ptx.PipeConfig(**STACK, n_stages=S, layers_per_stage=2)
    params = ptx.pipe_params_from_numpy(_np(jparams), cfg, S)
    got = ptx.apply_sequential(params, torch.from_numpy(tok), cfg)
    want = np.asarray(jax.jit(jptx.apply_sequential, static_argnums=2)(
        jparams, jnp.asarray(tok), jcfg))
    np.testing.assert_allclose(got.detach().numpy(), want, atol=OUT_ATOL)
    lcfg, lsplit = llamas[1]
    tcfg = llama2.LlamaConfig(**LLAMA, dtype=torch.float32)
    split = llama_pp.pipe_params_from_numpy(_np(lsplit), tcfg, S)
    got = llama2.apply_llama(llama_pp.merge_params(split, tcfg),
                             torch.from_numpy(tok).long(), tcfg)
    want = np.asarray(jax.jit(jl.apply_llama, static_argnums=2)(
        jlpp.merge_params(lsplit, lcfg), jnp.asarray(tok), lcfg))
    np.testing.assert_allclose(got.detach().numpy(), want, atol=OUT_ATOL)
    assert cfg.flops_per_token() == jptx.PipeConfig(
        **STACK, n_stages=S, layers_per_stage=2).flops_per_token()


def test_cli_refusals_and_bench_record_names(capsys):
    """The CLI refuses the MPMD runtime and a pipe axis under TP or SP,
    naming the ROADMAP item; the metric names are bench.py's; the mesh
    is one stage a process."""
    from tpu_hpc_torch.train import __main__ as tmain

    for argv, needle in (
            (["--pp-runtime", "mpmd"],
             'ROADMAP: "Pipeline, the MPMD half"'),
            (["--pp-schedule", "1f1b", "--model", "2"], "PP x TP"),
            (["--pp-model", "llama", "--sp-mode", "ring"], "PP x SP")):
        with pytest.raises(SystemExit) as e:
            tmain.main(["--device", "cpu", *argv])
        assert e.value.code == 2
        assert needle in capsys.readouterr().err
    names = [tmain.PipeArgs(schedule=s, model=m, backward=b).metric()
             for s, m, b in (("1f1b", "stack", "remat"),
                             ("1f1b", "llama", "remat"),
                             ("1f1b", "stack", "stash"),
                             ("gpipe", "stack", "remat"),
                             ("interleaved-1f1b", "stack", "remat"),
                             ("interleaved-1f1b", "llama", "stash"))]
    assert names == [
        "pp_1f1b_tokens_per_s_per_chip", "pp_1f1b-llama_tokens_per_s_per_chip",
        "pp_1f1b-stash_tokens_per_s_per_chip", "pp_gpipe_tokens_per_s_per_chip",
        "pp_interleaved-1f1b_tokens_per_s_per_chip",
        "pp_interleaved-1f1b-stash-llama_tokens_per_s_per_chip"]
    assert tmain.pp_mesh_axes(4) == {"pipe": 4}
    assert tmain.pp_mesh_axes(4, 2) == {"data": 2, "pipe": 2}
    assert tmain.pp_mesh_axes(4, 3) is None
    # bench.py:530-535: two chunks only where 2S divides the depth
    assert [tmain.pp_chunks("interleaved-1f1b", s, 8) for s in (1, 2, 4, 8)] \
        == [1, 2, 2, 1]
    assert tmain.pp_chunks("1f1b", 4, 8) == 1
