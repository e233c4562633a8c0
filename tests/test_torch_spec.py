"""The port's speculative decoding and seeded sampling against the JAX
package's, on the CPU.

The same TINY float32 model (JAX init, carried across with
``params_from_numpy``), the same paged shape and the same request mixes
as tests/test_spec.py go through the JAX ``PagedEngine`` with
``attach_spec`` and through the port's, under the port's ``"gather"``
route and its ``"cuda"`` route (whose kernels run their plain PyTorch
versions on CPU tensors). Held exactly: the threefry keys, uniforms and
categorical draws against ``jax.random``; every greedy and sampled token
stream; the drafted/accepted counts; the verify and draft programs'
tokens on a hand-built batch. Held to 1e-6: the sampling distributions.
"""
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

jax = pytest.importorskip("jax", reason="the JAX reference package")
jnp = jax.numpy

from tpu_hpc.models import llama2 as jl
from tpu_hpc.runtime import MeshSpec, build_mesh
from tpu_hpc.serve import ContinuousBatcher as JaxBatcher
from tpu_hpc.serve import PagedConfig as JaxPagedConfig
from tpu_hpc.serve import PagedEngine as JaxPagedEngine
from tpu_hpc.serve import Request as JaxRequest
from tpu_hpc.serve import ServeConfig as JaxServeConfig
from tpu_hpc.serve import spec as jspec
from tpu_hpc_torch.models import llama2 as tl
from tpu_hpc_torch.serve import (
    ContinuousBatcher,
    Engine,
    PagedConfig,
    PagedEngine,
    Request,
    ServeConfig,
    SpecConfig,
    attach_spec,
    params_from_numpy,
)
from tpu_hpc_torch.serve import prng
from tpu_hpc_torch.serve import spec as tspec

K = 3


def _cfgs(n_layers):
    kw = dict(dim=64, n_layers=n_layers, n_heads=4, n_kv_heads=2,
              vocab_size=128, multiple_of=16, max_seq_len=256)
    return (jl.LlamaConfig(dtype=jnp.float32, **kw),
            tl.LlamaConfig(dtype=torch.float32, **kw))


JAX_TINY, TINY = _cfgs(2)
JAX_DRAFT, DRAFT = _cfgs(1)
SERVE = dict(slots=4, max_seq_len=48, prefill_buckets=(8, 16))
PAGED = dict(block_size=4, num_blocks=48, prefill_chunk=8)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The models here are tiny: one intra-op thread runs them as fast,
    and leaves the other cores to the test files running beside this
    one under xdist (timing-based tests among them)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def mesh1():
    return build_mesh(MeshSpec(axes={"data": 1}), devices=jax.devices()[:1])


@pytest.fixture(scope="module")
def weights():
    """(jax target, jax draft, port target, port draft) params."""
    jt = jl.init_llama(jax.random.key(0), JAX_TINY)
    jd = jl.init_llama(jax.random.key(7), JAX_DRAFT)
    return (jt, jd,
            params_from_numpy(jax.device_get(jt), TINY, "cpu"),
            params_from_numpy(jax.device_get(jd), DRAFT, "cpu"))


# ---------------------------------------------------------------------
# The scripted runs: one engine per (side, mode), the same sequence of
# batcher runs on every side
# ---------------------------------------------------------------------


def _mix():
    rng = np.random.default_rng(11)
    shapes = [(11, 6), (5, 8), (13, 3), (7, 5), (9, 7), (4, 2)]
    return [(f"r{i}", rng.integers(0, 128, size=p).tolist(), m, {})
            for i, (p, m) in enumerate(shapes)]


def _budget():
    rng = np.random.default_rng(5)
    return [(f"b{i}", rng.integers(0, 128, size=6 + i).tolist(), m, {})
            for i, m in enumerate((1, 2, 3, 7))]


def _long_prompt():
    return np.random.default_rng(21).integers(0, 128, size=13).tolist()


def _sampled(rid="x", seed=42):
    prompt = np.random.default_rng(33).integers(0, 128, size=9).tolist()
    return (rid, prompt, 8, dict(temperature=0.8, top_p=0.9, seed=seed))


def _others():
    rng = np.random.default_rng(34)
    return [(f"o{i}", rng.integers(0, 128, size=5 + 2 * i).tolist(), 5,
             dict(temperature=0.5, top_p=0.95, seed=i)) for i in range(3)]


EOS_PROMPT = [3, 1, 4, 1, 5]


def _script(eos):
    """(name, requests) batcher runs, in order, on one engine."""
    return [
        ("mix", _mix()),
        ("budget", _budget()),
        ("eos", [("e", EOS_PROMPT, 24, dict(eos_id=eos))]),
        ("prefix_cold", [("cold", _long_prompt(), 30, {})]),
        ("prefix_warm", [("warm", _long_prompt(), 30, {})]),
        ("sampled", _others() + [_sampled()]),
        ("sampled_mixed", _mix() + [_sampled(rid="s")]),
    ]


SCRIPT_NAMES = [n for n, _ in _script(0)]
STAT_KEYS = ("verify_steps", "drafted", "accepted", "rejected", "emitted")


def _run_script(engine, batcher_cls, request_cls, eos):
    out = {}
    prev = dict.fromkeys(STAT_KEYS, 0)
    for name, reqs in _script(eos):
        got = batcher_cls(engine).run([
            request_cls(rid=rid, prompt=list(p), max_new_tokens=m, **kw)
            for rid, p, m, kw in reqs
        ])
        stats = {k: engine.spec.stats[k] - prev[k] for k in STAT_KEYS}
        prev = dict(engine.spec.stats)
        out[name] = (got, stats, engine.paged_stats["prefix_hits"])
    return out


@pytest.fixture(scope="module")
def eos_token(weights):
    """An EOS from the middle of the free-run greedy stream of
    EOS_PROMPT (the port's non-spec engine; it equals the JAX one,
    tests/test_torch_serve.py)."""
    free = ContinuousBatcher(_port_engine(weights, "gather")).run(
        [Request(rid="f", prompt=EOS_PROMPT, max_new_tokens=24)]
    )["f"]
    return free[len(free) // 2]


def _port_engine(weights, kernel, mode=None, self_draft=False):
    _, _, tt, td = weights
    engine = PagedEngine(tt, TINY, ServeConfig(**SERVE), "cpu",
                         PagedConfig(kernel=kernel, **PAGED))
    if mode is not None:
        draft = ((tt, TINY) if self_draft else (td, DRAFT)) \
            if mode == "draft" else (None, None)
        attach_spec(engine, SpecConfig(mode=mode, k=K),
                    draft_params=draft[0], draft_cfg=draft[1])
    engine.warmup()
    return engine


def _jax_engine(weights, mesh1, mode):
    jt, jd, _, _ = weights
    engine = JaxPagedEngine(jt, JAX_TINY, JaxServeConfig(**SERVE), mesh1,
                            JaxPagedConfig(**PAGED))
    jspec.attach_spec(
        engine, jspec.SpecConfig(mode=mode, k=K),
        draft_params=jd if mode == "draft" else None,
        draft_cfg=JAX_DRAFT if mode == "draft" else None,
    )
    engine.warmup()
    return engine


@pytest.fixture(scope="module")
def jax_runs(weights, mesh1, eos_token):
    return {
        mode: _run_script(_jax_engine(weights, mesh1, mode), JaxBatcher,
                          JaxRequest, eos_token)
        for mode in ("ngram", "draft")
    }


@pytest.fixture(scope="module")
def port_runs(weights, eos_token):
    runs = {}
    for kernel in ("gather", "cuda"):
        for mode in ("ngram", "draft"):
            engine = _port_engine(weights, kernel, mode)
            warmed = engine.compile_count_total
            runs[kernel, mode] = _run_script(
                engine, ContinuousBatcher, Request, eos_token
            )
            runs[kernel, mode]["rebuilds"] = (
                engine.compile_count_total - warmed
            )
            runs[kernel, mode]["engine"] = engine
    return runs


@pytest.fixture(scope="module")
def greedy_oracle(weights, eos_token):
    """The port's non-spec greedy streams of every greedy run."""
    engine = _port_engine(weights, "gather")
    out = {}
    for name, reqs in _script(eos_token):
        if name.startswith("sampled"):
            continue
        out[name] = ContinuousBatcher(engine).run([
            Request(rid=rid, prompt=list(p), max_new_tokens=m, **kw)
            for rid, p, m, kw in reqs
        ])
    return out


ROUTES = [(k, m) for k in ("gather", "cuda") for m in ("ngram", "draft")]
ROUTE_IDS = [f"{k}-{m}" for k, m in ROUTES]


# ---------------------------------------------------------------------
# The key chain
# ---------------------------------------------------------------------


RNG_SEEDS = np.array([0, 1, 42, 99, 12345, 2**31 - 1], np.int32)
RNG_POS = np.array([0, 1, 7, 48, 1000, 4095], np.int32)


@pytest.mark.parametrize("stream", [0, 1, 2])
def test_position_keys_and_uniform_match_jax_bitwise(stream):
    jkeys = jspec._position_keys(
        jnp.asarray(RNG_SEEDS), jnp.asarray(RNG_POS), stream
    )
    tkeys = prng.position_keys(
        torch.tensor(RNG_SEEDS), torch.tensor(RNG_POS), stream
    )
    np.testing.assert_array_equal(
        np.asarray(jax.random.key_data(jkeys)).astype(np.int64),
        tkeys.numpy(),
    )
    ju = np.asarray(jax.vmap(jax.random.uniform)(jkeys))
    tu = prng.uniform(tkeys).numpy()
    np.testing.assert_array_equal(ju.view(np.int32), tu.view(np.int32))
    # The Gumbel's uniform: floored at float32's tiny, 128 per key.
    jt = np.asarray(jax.vmap(lambda k: jax.random.uniform(
        k, (128,), minval=np.finfo(np.float32).tiny, maxval=1.0))(jkeys))
    tt = prng.uniform(tkeys, 128, minval=np.finfo(np.float32).tiny).numpy()
    np.testing.assert_array_equal(jt.view(np.int32), tt.view(np.int32))


def test_fold_in_and_bits_match_jax():
    k = jax.random.key(0)
    tk = prng.key(0)
    for d in (0, 1, 3, 2**31 - 1, 2**32 - 1):
        k = jax.random.fold_in(k, d)
        tk = prng.fold_in(tk, d)
        np.testing.assert_array_equal(
            np.asarray(jax.random.key_data(k)).astype(np.int64), tk.numpy()
        )
        jb = np.asarray(jax.random.bits(k, (33,), jnp.uint32))
        np.testing.assert_array_equal(
            jb.astype(np.int64), prng.random_bits(tk, 33).numpy()
        )


@pytest.mark.parametrize("stream", [0, 1, 2])
def test_categorical_matches_jax(stream):
    """The Gumbel-max draw over distributions with zeroed (nucleus)
    entries and over greedy one-hots."""
    rng = np.random.default_rng(stream)
    probs = rng.dirichlet(np.full(128, 0.3), size=len(RNG_SEEDS))
    probs = probs.astype(np.float32)
    probs[:, ::3] = 0.0
    probs /= probs.sum(-1, keepdims=True)
    onehot = np.eye(128, dtype=np.float32)[rng.integers(0, 128, 6)]
    jkeys = jspec._position_keys(
        jnp.asarray(RNG_SEEDS), jnp.asarray(RNG_POS), stream
    )
    tkeys = prng.position_keys(
        torch.tensor(RNG_SEEDS), torch.tensor(RNG_POS), stream
    )
    for p in (probs, onehot):
        want = np.asarray(jspec._categorical(jkeys, jnp.asarray(p)))
        got = prng.categorical_probs(tkeys, torch.tensor(p)).numpy()
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        prng.categorical_probs(tkeys, torch.tensor(onehot)).numpy(),
        onehot.argmax(-1),
    )


# ---------------------------------------------------------------------
# The sampling head and prompt lookup
# ---------------------------------------------------------------------


def test_sampling_probs_matches_jax():
    rng = np.random.default_rng(0)
    logits = (rng.normal(size=(4, 3, 128)) * 3).astype(np.float32)
    temps = np.array([0.0, 0.8, 1.0, 1.7], np.float32)
    tops = np.array([1.0, 0.9, 0.5, 0.95], np.float32)
    want = np.asarray(jspec.sampling_probs(
        jnp.asarray(logits), jnp.asarray(temps), jnp.asarray(tops)
    ))
    got = tspec.sampling_probs(
        torch.tensor(logits), torch.tensor(temps), torch.tensor(tops)
    ).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    # Greedy rows are exact one-hots of the argmax.
    np.testing.assert_array_equal(
        got[0], np.eye(128, dtype=np.float32)[logits[0].argmax(-1)]
    )
    # The nucleus drops what JAX drops.
    np.testing.assert_array_equal(got == 0.0, want == 0.0)


NGRAM_CASES = [
    ([1, 2, 3, 9, 9, 2, 3, 7, 7, 2, 3], 3, 2),
    ([5, 6, 1, 2, 6], 4, 2),
    ([1, 2, 3, 4], 4, 2),
    ([7], 4, 2),
    ([], 4, 2),
    ([1, 2, 3, 4, 5, 1, 2], 2, 2),
]


@pytest.mark.parametrize("history,k,max_n", NGRAM_CASES)
def test_ngram_propose_matches_jax(history, k, max_n):
    want = jspec.ngram_propose(history, k, max_n=max_n)
    assert tspec.ngram_propose(history, k, max_n=max_n) == want
    assert tspec.NgramIndex(history, max_n=max_n).propose(k) == \
        jspec.NgramIndex(history, max_n=max_n).propose(k)


def test_ngram_index_matches_jax_incrementally():
    rng = np.random.default_rng(11)
    for max_n in (1, 2, 3):
        for k in (1, 4):
            toks = rng.integers(0, 5, size=200).tolist()
            ti, ji = tspec.NgramIndex(max_n=max_n), \
                jspec.NgramIndex(max_n=max_n)
            for tok in toks:
                ti.append(tok)
                ji.append(tok)
                assert ti.propose(k) == ji.propose(k)


def test_derive_request_seed_matches_jax():
    for rid in ("r1", "r2", "r0007", "x"):
        assert tspec.derive_request_seed(rid) == \
            jspec.derive_request_seed(rid)
    assert tspec.derive_request_seed("r1", seed=5) == 5
    assert tspec.derive_request_seed("r1", seed=-3) == \
        jspec.derive_request_seed("r1", seed=-3)


# ---------------------------------------------------------------------
# Streams
# ---------------------------------------------------------------------


@pytest.mark.parametrize("name", SCRIPT_NAMES)
@pytest.mark.parametrize("route", ROUTES, ids=ROUTE_IDS)
def test_streams_and_counts_match_jax(name, route, port_runs, jax_runs):
    """Every run of the script -- the churned greedy mix, the max_new
    budget, EOS inside an accepted run, a cold and a warm (prefix hit)
    long stream, sampled requests (temperature 0.5-0.8, top-p 0.9-0.95)
    alone and beside greedy ones -- gives the JAX package's tokens and
    its drafted/accepted counts."""
    got, stats, hits = port_runs[route][name]
    want, want_stats, want_hits = jax_runs[route[1]][name]
    assert got == want
    assert stats == want_stats
    assert hits == want_hits


@pytest.mark.parametrize("route", ROUTES, ids=ROUTE_IDS)
def test_greedy_streams_equal_plain_decode(route, port_runs, greedy_oracle):
    """Speculation changes latency only: every greedy run equals the
    port's non-spec greedy stream, and the accept path, the reject path
    and the prefix hit all ran."""
    runs = port_runs[route]
    for name, want in greedy_oracle.items():
        assert runs[name][0] == want, name
    got_mix = runs["sampled_mixed"][0]
    for rid, toks in greedy_oracle["mix"].items():
        assert got_mix[rid] == toks, rid
    assert runs["prefix_warm"][2] >= 1
    if route[1] == "ngram":  # the cycling greedy stream accepts
        assert runs["prefix_cold"][1]["accepted"] > 0
    else:  # an independent random draft rarely guesses the argmax
        assert runs["mix"][1]["rejected"] > 0
    for r in _budget():
        assert len(runs["budget"][0][r[0]]) == r[2]
    assert runs["rebuilds"] == 0


@pytest.mark.parametrize("route", ROUTES, ids=ROUTE_IDS)
def test_pools_drain_to_idle(route, port_runs):
    engine = port_runs[route]["engine"]
    engine.allocator.check_invariant()
    assert not engine._slot_state
    if engine.spec.draft is not None:
        engine.spec.draft.allocator.check_invariant()
        assert not engine.spec.draft._slot_state


@pytest.mark.parametrize("mode", ["ngram", "draft"])
def test_sampled_stream_is_slot_and_batch_invariant(mode, weights):
    """The same (seed, temperature, top_p) gives the same tokens alone,
    with company, and submitted last (another slot); another seed
    gives another stream; a draft model equal to the target accepts
    every sampled draft of a greedy request."""
    def run(reqs, self_draft=False):
        engine = _port_engine(weights, "gather", mode, self_draft)
        return ContinuousBatcher(engine).run([
            Request(rid=rid, prompt=list(p), max_new_tokens=m, **kw)
            for rid, p, m, kw in reqs
        ]), engine

    solo = run([_sampled()])[0]["x"]
    assert run(_others() + [_sampled()])[0]["x"] == solo
    assert run([_sampled()] + _others()[::-1])[0]["x"] == solo
    assert run([_sampled(seed=43)])[0]["x"] != solo
    if mode == "draft":
        _, engine = run(_mix(), self_draft=True)
        st = engine.spec.stats
        assert st["drafted"] > 0 and st["accepted"] == st["drafted"]


def test_request_seed_rides_slot_state(weights):
    engine = _port_engine(weights, "gather", "ngram")
    engine.admit(0, [1, 2, 3, 4, 5], 4, sampling=(99, 0.5, 0.9))
    st = engine.slot_state(0)
    assert (st.seed, st.temperature, st.top_p) == (99, 0.5, 0.9)
    engine.release(0)
    # 2 sampled prefill buckets + verify + copy_block; no draft side.
    assert engine.compile_count_total == 4


# ---------------------------------------------------------------------
# The programs on one hand-built batch
# ---------------------------------------------------------------------


def _program_batch():
    rng = np.random.default_rng(9)
    slots, bs, nb, mb = 4, 4, 64, 12
    tw = mb + 4
    pools = [rng.normal(size=(2, nb, bs, 2, 16)).astype(np.float32)
             for _ in range(2)]
    tables = np.zeros((slots, tw), np.int32)
    perm = rng.permutation(np.arange(1, nb))
    for s in range(slots):
        tables[s, :mb] = perm[s * mb:(s + 1) * mb]
    return dict(
        pools=pools, tables=tables,
        pos=np.array([5, 17, 9, 30], np.int32),
        active=np.array([1, 1, 0, 1], np.int32),
        n_valid=np.array([3, 1, 0, 2], np.int32),
        tokens=rng.integers(0, 128, size=(slots, K + 1)).astype(np.int32),
        seeds=np.array([3, 1234, 7, 2**31 - 1], np.int32),
        temps=np.array([0.0, 0.8, 0.8, 1.0], np.float32),
        top_ps=np.array([1.0, 0.9, 0.95, 0.9], np.float32),
        draft_probs=rng.dirichlet(np.ones(128), size=(slots, K)).astype(
            np.float32),
        bs=bs, mb=mb, tw=tw,
    )


def _torch_args(b, keys):
    return [torch.tensor(b[k]) for k in keys]


@pytest.mark.parametrize("onehot", [True, False], ids=["ngram", "draft"])
@pytest.mark.parametrize("kernel", ["gather", "cuda"])
def test_verify_program_matches_jax(onehot, kernel, weights):
    jt, _, tt, _ = weights
    b = _program_batch()
    jfn = jax.jit(jspec.make_spec_verify_fn(
        JAX_TINY, K, b["bs"], b["mb"], b["tw"], onehot_q=onehot))
    tfn = tspec.make_spec_verify_fn(
        TINY, K, b["bs"], b["mb"], b["tw"], onehot_q=onehot, kernel=kernel)
    keys = ["tokens", "pos", "tables", "active", "n_valid"]
    tail = ["seeds", "temps", "top_ps"]
    if not onehot:
        tail = ["draft_probs"] + tail
    jks, jvs, jout, jacc = jfn(
        jt, jnp.asarray(b["pools"][0]), jnp.asarray(b["pools"][1]),
        *[jnp.asarray(b[k]) for k in keys + tail])
    ks, vs = (torch.tensor(p) for p in b["pools"])
    tout, tacc = tfn(tt, ks, vs, *_torch_args(b, keys + tail))
    live = b["active"] > 0
    np.testing.assert_array_equal(tacc.numpy()[live], np.asarray(jacc)[live])
    np.testing.assert_array_equal(tout.numpy()[live], np.asarray(jout)[live])
    if kernel == "gather":  # the JAX formulation: every row
        np.testing.assert_array_equal(tout.numpy(), np.asarray(jout))
    # The pages written IN PLACE are the JAX program's outputs (but the
    # scratch page 0, where several redirected rows land at once: the
    # last writer differs, and nothing reads it).
    np.testing.assert_allclose(ks.numpy()[:, 1:], np.asarray(jks)[:, 1:],
                               rtol=0, atol=1e-6)
    np.testing.assert_allclose(vs.numpy()[:, 1:], np.asarray(jvs)[:, 1:],
                               rtol=0, atol=1e-6)


@pytest.mark.parametrize("kernel", ["gather", "cuda"])
def test_draft_program_matches_jax(kernel, weights):
    _, jd, _, td = weights
    b = _program_batch()
    jfn = jax.jit(jspec.make_spec_draft_fn(
        JAX_DRAFT, K, b["bs"], b["mb"], b["tw"]))
    tfn = tspec.make_spec_draft_fn(
        DRAFT, K, b["bs"], b["mb"], b["tw"], kernel=kernel)
    pools = [p[:1] for p in b["pools"]]  # one draft layer
    keys = ["pos", "tables", "active", "n_valid", "seeds", "temps",
            "top_ps"]
    _, _, jtok, jprob = jfn(
        jd, jnp.asarray(pools[0]), jnp.asarray(pools[1]),
        jnp.asarray(b["tokens"][:, 0]), *[jnp.asarray(b[k]) for k in keys])
    ks, vs = (torch.tensor(p) for p in pools)
    ttok, tprob = tfn(td, ks, vs, torch.tensor(b["tokens"][:, 0]),
                      *_torch_args(b, keys))
    jtok, jprob = np.asarray(jtok), np.asarray(jprob)
    # Steps j < n_valid of active slots are the drafts that reach the
    # verify; the gather route equals JAX on every row.
    used = (b["active"][:, None] > 0) & (
        np.arange(K)[None, :] < b["n_valid"][:, None])
    rows = slice(None) if kernel == "gather" else used
    np.testing.assert_array_equal(ttok.numpy()[rows], jtok[rows])
    np.testing.assert_allclose(tprob.numpy()[rows], jprob[rows],
                               rtol=0, atol=1e-6)


# ---------------------------------------------------------------------
# Refusals
# ---------------------------------------------------------------------


def test_spec_validation(weights):
    _, _, tt, _ = weights
    with pytest.raises(ValueError, match="unknown spec mode"):
        SpecConfig(mode="medusa")
    with pytest.raises(ValueError, match="k must be >= 1"):
        SpecConfig(k=0)
    small = ServeConfig(slots=2, max_seq_len=48, prefill_buckets=(16,))
    with pytest.raises(ValueError, match="paged"):
        attach_spec(Engine(tt, TINY, small, "cpu"), SpecConfig())
    paged = PagedEngine(tt, TINY, small, "cpu",
                        PagedConfig(block_size=4, num_blocks=32))
    with pytest.raises(ValueError, match="draft_params"):
        attach_spec(paged, SpecConfig(mode="draft"))
    with pytest.raises(ValueError, match="largest prefill"):
        attach_spec(paged, SpecConfig(mode="ngram", k=17))
    bad_vocab = tl.LlamaConfig(
        dim=64, n_layers=1, n_heads=4, n_kv_heads=2, vocab_size=64,
        multiple_of=16, max_seq_len=256, dtype=torch.float32,
    )
    with pytest.raises(ValueError, match="vocab"):
        attach_spec(
            paged, SpecConfig(mode="draft"),
            draft_params=tl.init_llama(
                torch.Generator().manual_seed(1), bad_vocab, "cpu"),
            draft_cfg=bad_vocab,
        )
    quant = PagedEngine(tt, TINY, small, "cpu",
                        PagedConfig(block_size=4, num_blocks=32,
                                    kv_quant="int8"))
    with pytest.raises(ValueError, match="quantized KV pool"):
        attach_spec(quant, SpecConfig())
    paged.warmup()
    with pytest.raises(ValueError, match="BEFORE engine.warmup"):
        attach_spec(paged, SpecConfig(mode="ngram"))
    with pytest.raises(ValueError, match="no attached SpecRunner"):
        paged.spec_decode([0, 0], [0, 0], [False, False], [0, 0], [0, 0],
                          [0.0, 0.0], [1.0, 1.0])


def test_sampling_requires_spec_engine(weights):
    batcher = ContinuousBatcher(_port_engine(weights, "gather"))
    rid, prompt, m, kw = _sampled()
    with pytest.raises(ValueError, match="speculative"):
        batcher.submit(Request(rid=rid, prompt=prompt, max_new_tokens=m,
                               **kw))


class _HostReads(TorchDispatchMode):
    """Counts the scalars an op sequence reads back to the host."""

    def __init__(self):
        super().__init__()
        self.reads = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func is torch.ops.aten._local_scalar_dense.default:
            self.reads += 1
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("kernel", ["gather", "cuda"])
def test_spec_programs_read_nothing_back(kernel, weights):
    """The verify (both draft sources), draft and sampled-prefill
    programs keep every decision on the device: no scalar is read to
    the host inside them (on the card such a read waits for all the
    work queued before it). The engine fetches the tokens once, after
    the program."""
    _, _, tt, td = weights
    b = _program_batch()
    pools = [torch.tensor(p) for p in b["pools"]]
    keys = ["tokens", "pos", "tables", "active", "n_valid"]
    tail = ["seeds", "temps", "top_ps"]
    calls = []
    for onehot in (True, False):
        fn = tspec.make_spec_verify_fn(TINY, K, b["bs"], b["mb"], b["tw"],
                                       onehot_q=onehot, kernel=kernel)
        args = _torch_args(b, keys + ([] if onehot else ["draft_probs"])
                           + tail)
        calls.append(lambda fn=fn, args=args: fn(tt, *pools, *args))
    draft = tspec.make_spec_draft_fn(DRAFT, K, b["bs"], b["mb"], b["tw"],
                                     kernel=kernel)
    calls.append(lambda: draft(
        td, pools[0][:1].clone(), pools[1][:1].clone(),
        torch.tensor(b["tokens"][:, 0]),
        *_torch_args(b, ["pos", "tables", "active", "n_valid"] + tail)))
    prefill = tspec.make_spec_prefill_fn(TINY, 8, b["bs"], b["mb"], b["tw"],
                                         kernel=kernel)
    calls.append(lambda: prefill(
        tt, *pools, None, None, torch.tensor(b["tokens"][:1, :2]).repeat(
            1, 4).long(), 4, 7, torch.tensor(b["tables"][1]), 1234, 0.8,
        0.9))
    for call in calls:
        with _HostReads() as mode:
            call()
        assert mode.reads == 0
