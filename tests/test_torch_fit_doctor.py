"""The port's planning tools against the JAX package's: the fit analyzer
(tpu_hpc_torch.checks.fit), the step-time estimator
(tpu_hpc_torch.checks.roofline) and the strategy doctor
(tpu_hpc_torch.checks.doctor), plus the fit's one real update on a gloo
world of 2 and the one table of H100 figures the roofline and the
collective planner share.

Exactness: every byte count equals the JAX package's, with one named
difference -- optax keeps AdamW's update count as an int32 array leaf
(4 bytes on every chip), the port's AdamW as a host int, so the port's
``opt_bytes`` (and so its totals) are 4 bytes below JAX's on the
layouts whose optimizer state is accounted from the tree (tp, cp; the
pp layout's is analytic on both sides). The doctor's plans (layout, dp,
axis2, accum, fits) are equal and in the same order under a ChipSpec
with the JAX spec's numbers; roofline floats agree within 1e-9
relative. The JAX side runs with do_compile=False only.
"""
import dataclasses
import json

import pytest
import torch

from tpu_hpc_torch.checks import doctor, fit, roofline
from tpu_hpc_torch.models import llama2

# The JAX optax count leaf the port's AdamW keeps on the host.
COUNT_BYTES = 4
INT_FIELDS = ("n_params", "param_bytes", "grad_bytes", "grad_accum",
              "kv_cache_bytes", "kv_slots", "kv_block_bytes", "kv_blocks",
              "kv_block_size", "kv_host_blocks", "kv_host_bytes",
              "draft_n_params", "draft_param_bytes", "draft_kv_block_bytes")
ALL_TERMS = dict(kv_slots=8, kv_seq_len=2048, kv_blocks=256,
                 kv_block_size=16, kv_quant="int8", kv_host_blocks=64,
                 draft="half")
# (preset, layout, dp, second axis, terms)
FIT_CASES = [
    ("7b", "tp", 4, 8, ALL_TERMS),
    ("7b", "cp", 4, 4, ALL_TERMS),
    ("7b", "pp", 2, 4, ALL_TERMS),
    ("13b", "tp", 4, 4, ALL_TERMS),
    ("70b", "pp", 2, 8, dict(ALL_TERMS, draft=None)),
] + [
    ("7b", "tp", 2, 4, {}),
    ("7b", "tp", 4, 2, dict(kv_slots=12)),
    ("7b", "tp", 4, 8, dict(kv_slots=16, kv_blocks=512,
                            kv_cache_dtype="float32")),
    ("7b", "cp", 8, 2, dict(moments_dtype="bfloat16")),
    ("7b", "pp", 4, 2, dict(pp_backward="stash", kv_blocks=100,
                            kv_quant="int8")),
]


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
def jax_checks():
    pytest.importorskip("jax", reason="the JAX reference package")
    from tpu_hpc.checks import doctor as jdoctor
    from tpu_hpc.checks import fit as jfit
    from tpu_hpc.checks import roofline as jroofline
    from tpu_hpc.models import llama2 as jllama2
    from tpu_hpc.serve import spec as jspec

    return dict(fit=jfit, doctor=jdoctor, roofline=jroofline,
                llama2=jllama2, spec=jspec)


def _analyze(mod, llama, spec_mod, name, layout, dp, ax, terms):
    terms = dict(terms)
    cfg = dataclasses.replace(llama.PRESETS[name], max_seq_len=4096)
    if terms.pop("draft", None):
        terms["draft_cfg"] = spec_mod.default_draft_config(cfg)
    return mod.analyze(cfg=cfg, dp=dp, tp_size=ax, global_batch=16 * dp,
                       seq_len=4096, hbm_gib=32.0, do_compile=False,
                       grad_accum=2, layout=layout, **terms)


@pytest.mark.parametrize("name,layout,dp,ax,terms", FIT_CASES)
def test_fit_bytes_equal_jax(jax_checks, name, layout, dp, ax, terms):
    from tpu_hpc_torch.serve import spec as tspec

    j = _analyze(jax_checks["fit"], jax_checks["llama2"], jax_checks["spec"],
                 name, layout, dp, ax, terms)
    t = _analyze(fit, llama2, tspec, name, layout, dp, ax, terms)
    for f in INT_FIELDS:
        assert getattr(t, f) == getattr(j, f), f
    assert t.act_bytes == j.act_bytes
    count = 0 if layout == "pp" else COUNT_BYTES
    assert t.opt_bytes == j.opt_bytes - count
    assert t.total_bytes == j.total_bytes - count
    assert t.fits == j.fits
    assert (t.layout, t.kv_quant, t.moments_dtype) == (
        j.layout, j.kv_quant, j.moments_dtype)
    md = fit.to_markdown(t)
    assert "Per-card HBM budget" in md and "**total**" in md


def test_static_accounting_is_the_meta_models_state():
    """The static rows are the bytes of the port's own tensors: params on
    the meta device, their gradients, and make_adamw's state."""
    from tpu_hpc_torch.train.trainer import make_adamw, tree_leaves

    cfg = llama2.LlamaConfig(dim=256, n_layers=2, n_heads=4, vocab_size=512,
                             multiple_of=32, max_seq_len=64)
    r = fit.analyze(cfg, dp=1, tp_size=1, global_batch=4, seq_len=64,
                    do_compile=False, grad_accum=2)
    params = fit.meta_params(cfg)
    leaves = tree_leaves(params)
    p_bytes = sum(t.numel() * t.element_size() for t in leaves)
    state = make_adamw(3e-4, 0.1).init(params)
    o_bytes = sum(t.numel() * t.element_size()
                  for t in state["mu"] + state["nu"])
    assert (r.param_bytes, r.grad_bytes, r.opt_bytes) == (
        p_bytes, p_bytes, o_bytes)
    assert r.param_bytes == 4 * llama2.count_params(cfg)
    assert all(t.device.type == "meta" for t in leaves)


def test_sizing_table_rows():
    table = fit.sizing_table(hbm_gib=32.0).splitlines()
    assert len(table) == 2 + len(fit._TABLE_ROWS)
    assert table[2].startswith("| 7b | 6.7B | 8 | `{data: 2, model: 4}`")
    assert "fits 80 GiB?" in fit.sizing_table()


def test_h100_is_the_default_card():
    r = fit.analyze(dp=4, tp_size=8, do_compile=False)
    assert r.hbm_gib == roofline.CHIPS["h100-sxm"].hbm_gib == 80.0
    assert r.fits


@pytest.mark.parametrize("kw,match", [
    (dict(tpu_topology="v5e:4x8"), "no TPU compiler"),
    (dict(compiler_options={"xla_foo": "1"}), "XLA compiler options"),
    (dict(attn="xla"), "unknown attn"),
])
def test_tpu_and_xla_options_are_refused(kw, match):
    with pytest.raises(ValueError, match=match):
        fit.analyze(do_compile=False, **kw)


@pytest.mark.parametrize("flag", [["--tpu-topology", "v5e:4x8"],
                                  ["--xla-opt", "a=b"]])
def test_cli_refuses_tpu_flags(flag, capsys):
    with pytest.raises(SystemExit) as e:
        fit.main(["--no-compile", *flag])
    assert e.value.code == 2
    assert "no counterpart" in capsys.readouterr().err


def test_cli_json_and_flags(capsys):
    rc = fit.main(["--no-compile", "--json", "--model", "7b", "--dp", "4",
                   "--tp", "8", "--global-batch", "16", "--kv-blocks", "64",
                   "--kv-quant", "int8", "--spec-draft", "half",
                   "--kv-host-tier", "8"])
    out = json.loads(capsys.readouterr().out)
    assert rc == 0 and out["fits"] and out["kv_quant"] == "int8"
    assert out["draft_n_params"] > 0 and out["kv_host_bytes"] > 0
    assert out["compiled"] is False


def test_one_real_update_on_a_gloo_world_of_two():
    """do_compile=True: one update of the port's Trainer at the layout,
    on 2 CPU ranks; the collectives it issued are recorded by kind."""
    cfg = llama2.LlamaConfig(dim=64, n_layers=2, n_heads=4, vocab_size=128,
                             multiple_of=16, max_seq_len=32)
    r = fit.analyze(cfg, dp=2, tp_size=1, global_batch=4, seq_len=32,
                    grad_accum=2, do_compile=True, device="cpu")
    assert r.compiled and r.compile_backend == "gloo-cpu x 2"
    assert r.collectives["all-gather"] > 0
    assert r.collectives["reduce-scatter"] > 0
    assert r.measured_peak_bytes is None  # no allocator stats on the CPU
    assert r.measured_baseline_bytes is None
    md = fit.to_markdown(r)
    assert "Evidence from one real update" in md and "| all-gather |" in md
    assert "Measured peak" not in md
    with pytest.raises(RuntimeError, match="at most 4"):
        fit.analyze(cfg, dp=8, tp_size=1, global_batch=16, seq_len=32,
                    do_compile=True, device="cpu")


def test_markdown_reports_the_updates_own_peak():
    """A card's reading is the update's peak less what the process held
    before it, and the report names both."""
    r = fit.analyze(llama2.PRESETS["7b"], dp=4, tp_size=8, global_batch=16,
                    seq_len=4096, do_compile=False)
    r = dataclasses.replace(r, compiled=True, compile_backend="cuda:H100 x 1",
                            measured_peak_bytes=3 * 2**30,
                            measured_baseline_bytes=1_234_567)
    md = fit.to_markdown(r)
    assert ("max_memory_allocated less the 1,234,567 bytes held before "
            "it): 3,221,225,472 bytes (3.00 GiB)") in md


@pytest.fixture(scope="module")
def doctor_pair(jax_checks):
    """Both doctors for 7B on 16 chips in 2 nodes (slices), the port's
    under a ChipSpec with the JAX v5e spec's numbers."""
    v = jax_checks["roofline"].CHIPS["v5e"]
    spec = roofline.ChipSpec(v.name, v.peak_bf16_flops, v.peak_bf16_flops,
                             v.hbm_gbps, v.hbm_gib, v.ici_gbps, v.dcn_gbps)
    kw = dict(chips=16, global_batch=64, slices=2)
    return (jax_checks["doctor"].diagnose("7b", chip="v5e", **kw),
            doctor.diagnose("7b", chip=spec, **kw))


def _plan_key(p):
    return (p.layout, p.dp, p.axis2, p.grad_accum, p.fits)


def test_doctor_plans_equal_jax(doctor_pair):
    j, t = doctor_pair
    assert [_plan_key(p) for p in t] == [_plan_key(p) for p in j]
    assert len(t) > 1 and t[0].fits


ROOF_FIELDS = ("compute_s", "memory_s", "comm_s", "schedule_factor",
               "step_time_lower_bound_s", "mfu_upper_bound",
               "tokens_per_s_per_chip_bound")


def _close(a, b):
    for f in ROOF_FIELDS:
        x, y = getattr(a, f), getattr(b, f)
        assert abs(x - y) <= 1e-9 * max(abs(x), abs(y), 1e-300), (f, x, y)
    assert a.bound == b.bound
    for k in a.memory_breakdown:
        x, y = a.memory_breakdown[k], b.memory_breakdown[k]
        assert abs(x - y) <= 1e-9 * max(abs(x), 1e-300)
    assert set(a.comm_breakdown) == set(b.comm_breakdown)


def test_doctor_rooflines_equal_jax(doctor_pair):
    for a, b in zip(*doctor_pair):
        _close(a.roofline, b.roofline)


ROOF_CASES = [
    dict(dp=4, axis2=8, layout="tp", global_batch=32, grad_accum=2),
    dict(dp=8, axis2=4, layout="cp", global_batch=32),
    dict(dp=2, axis2=4, layout="pp", global_batch=16, grad_accum=8),
    dict(dp=2, axis2=4, layout="pp", global_batch=16, grad_accum=8,
         pp_backward="stash", moments_dtype="bfloat16"),
    dict(dp=16, axis2=2, layout="tp", global_batch=64, slices=4),
    dict(dp=1, axis2=1, layout="tp", global_batch=4),
]


@pytest.mark.parametrize("kw", ROOF_CASES)
@pytest.mark.parametrize("card", ["h100-sxm", "h100-pcie"])
def test_roofline_equals_jax_under_the_same_spec(jax_checks, kw, card):
    jr = jax_checks["roofline"]
    c = roofline.CHIPS[card]
    jspec = jr.ChipSpec(c.name, c.peak_bf16_flops, c.hbm_gib, c.hbm_gbps,
                        c.ici_gbps, c.dcn_gbps)
    cfg = dataclasses.replace(llama2.PRESETS["7b"], max_seq_len=4096)
    jcfg = dataclasses.replace(jax_checks["llama2"].PRESETS["7b"],
                               max_seq_len=4096)
    _close(jr.estimate(jcfg, chip=jspec, **kw),
           roofline.estimate(cfg, chip=card, **kw))


def test_roofline_cli(capsys):
    assert roofline.main(["--model", "7b", "--dp", "8", "--global-batch",
                          "64", "--json"]) == 0
    out = json.loads(capsys.readouterr().out)
    assert out["chip"] == "h100-sxm" and out["bound"] == "compute"


def test_planner_reads_the_card_table():
    """comm/planner.py's alpha-beta fabric and the roofline's H100 row
    are one table: the same link rates."""
    from tpu_hpc_torch.comm import planner

    card = roofline.CHIPS["h100-sxm"]
    assert planner.TIER_MODEL["ici"][1] == card.ici_gbps * 1e9 == 4.5e11
    assert planner.TIER_MODEL["dcn"][1] == card.dcn_gbps * 1e9 == 5.0e10
    assert planner.tier_cost("ici", 4.5e11) == pytest.approx(
        planner.TIER_MODEL["ici"][0] + 1.0)


def test_doctor_defaults_to_h100_nodes(capsys):
    plans = doctor.diagnose("7b", chips=16, global_batch=64)
    assert plans and all(p.axis2 <= doctor.CARDS_PER_NODE for p in plans)
    assert all(p.dp % 2 == 0 for p in plans)  # 2 nodes: data spans them
    assert doctor.main(["--model", "7b", "--chips", "16", "--global-batch",
                        "64", "--json"]) == 0
    rows = json.loads(capsys.readouterr().out)
    assert [r["mesh"] for r in rows] == [p.mesh for p in plans]
