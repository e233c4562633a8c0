"""The port's vision models and datasets (tpu_hpc_torch/models/{unet,
resnet,vit,datasets}.py) against the JAX package's on the CPU.

Weights come from the JAX ``init_*`` functions and are carried across
with ``params_from_numpy``; inputs come from a numpy seed. Each model
runs in float64 (the exact check), float32 and bfloat16; the
tolerances and why are stated beside ``F64`` below.

Also here: the datasets' shapes and formulas, and three BatchNorm
properties -- the biased running variance, float32 moments under bf16
compute (a mean-4 input stays finite and tracks the float32 oracle),
and on a 2-rank gloo world the synced BatchNorm's loss, gradients and
stats equal one rank's over the global batch while an unsynced control
differs; the same world holds the tensor-parallel ViT (tp.vit_rules) to
the one-process one.
"""
import functools
import os
import pickle
import sys

import numpy as np
import pytest
import torch

from tpu_hpc_torch.models import datasets as tds
from tpu_hpc_torch.models import resnet as tr
from tpu_hpc_torch.models import unet as tu
from tpu_hpc_torch.models import vit as tv
from tpu_hpc_torch.models.losses import cross_entropy, lat_weighted_mse

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# float32 outputs and losses: conv and matmul summation order, the
# bilinear weights; the ResNets' last stage is 2x2, so their BatchNorms
# normalise over 16 values and scale that rounding by 1/std. Float32
# BatchNorm stats: the moments' sums in another order.
F32 = dict(rtol=1e-3, atol=1e-4)


def _jax():
    return pytest.importorskip("jax", reason="the JAX reference package")


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want),
                                                  1e-30))


def _close(got, want, tol=F32):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, **tol)


def _port_grads(params):
    return tr.params_to_numpy(tr.tree_map(lambda _, t: t.grad, params))


def _leaf_params(tree):
    return tr.tree_map(lambda _, t: t.requires_grad_(True), tree)


# ---------------------------------------------------------------------
# Datasets
# ---------------------------------------------------------------------

def test_era5_shape_dtype_and_formula_match_the_jax_stream():
    jax = _jax()
    from tpu_hpc.models import datasets as jds

    port, ref = tds.ERA5Synthetic(lat=19, lon=12), jds.ERA5Synthetic(
        lat=19, lon=12)
    assert port.sample_shape == ref.sample_shape == (19, 12, 20)
    assert port.channels == ref.channels
    x, y = port.batch_at(3, 4)
    jx, jy = ref.batch_at(3, 4)
    assert x.shape == tuple(jx.shape) and x.dtype == torch.float32
    assert str(jx.dtype) == "float32"
    noise = (y - 0.5 * x) / 0.1  # y = 0.5 x + 0.1 noise, noise ~ N(0, 1)
    assert abs(float(noise.mean())) < 0.05
    assert abs(float(noise.std()) - 1.0) < 0.05
    assert abs(float(x.std()) - 1.0) < 0.05
    again = port.batch_at(3, 4)
    assert torch.equal(again[0], x) and torch.equal(again[1], y)
    assert not torch.equal(port.batch_at(4, 4)[0], x)
    del jax


def test_toy_regression_and_cifar_shapes_and_dtypes():
    _jax()
    from tpu_hpc.models import datasets as jds

    x, y = tds.ToyRegression().batch_at(0, 8)
    jx, jy = jds.ToyRegression().batch_at(0, 8)
    assert x.shape == tuple(jx.shape) == (8, 20)
    assert y.shape == tuple(jy.shape) == (8, 1)
    img, lab = tds.CIFARSynthetic().batch_at(2, 64)
    jimg, jlab = jds.CIFARSynthetic().batch_at(2, 64)
    assert tds.CIFARSynthetic().sample_shape == \
        jds.CIFARSynthetic().sample_shape
    assert img.shape == tuple(jimg.shape) == (64, 32, 32, 3)
    assert img.dtype == torch.float32 and lab.dtype == torch.int64
    assert int(lab.min()) >= 0 and int(lab.max()) < 10
    assert len(set(lab.tolist())) > 5


def test_shard_batch_takes_the_jax_shards_rows():
    jax = _jax()
    from jax.sharding import Mesh

    from tpu_hpc.models import datasets as jds

    mesh = Mesh(np.array(jax.devices()[:4]), ("data",))
    x = np.arange(8 * 3, dtype=np.float32).reshape(8, 3)
    y = np.arange(8, dtype=np.int32)
    placed = jds.shard_batch((x, y), mesh)
    for r in range(4):
        px, py = tds.shard_batch((torch.from_numpy(x), torch.from_numpy(y)),
                                 4, r)
        shard = [s for s in placed[0].addressable_shards
                 if s.device == jax.devices()[r]][0]
        np.testing.assert_array_equal(px.numpy(), np.asarray(shard.data))
        assert py.tolist() == list(range(2 * r, 2 * r + 2))
    with pytest.raises(ValueError, match="does not split"):
        tds.shard_batch((torch.zeros(6, 1),), 4, 0)


def test_array_batches_keep_floats_and_widen_ints():
    x = np.ones((2, 3, 3, 1), np.float32)
    lab = np.array([1, 2], np.int32)
    gx, glab = tds.ArrayBatches([(x, lab)]).batch_at(0, 2)
    assert gx.dtype == torch.float32 and glab.dtype == torch.int64


# ---------------------------------------------------------------------
# Shared layers
# ---------------------------------------------------------------------

@pytest.mark.parametrize("size, k, s, pads", [
    (32, 3, 2, (0, 1)), (32, 7, 2, (2, 3)), (32, 1, 2, (0, 0)),
    (31, 3, 2, (1, 1)), (181, 3, 1, (1, 1)), (16, 3, 2, (0, 1)),
])
def test_same_pads_are_xla_s_split(size, k, s, pads):
    assert tr.same_pads(size, k, s) == pads


@pytest.mark.parametrize("k, s", [(3, 2), (7, 2), (1, 2), (3, 1)])
def test_conv2d_same_equals_lax_same_conv(k, s):
    jax = _jax()
    rng = np.random.default_rng(k * 10 + s)
    x = rng.standard_normal((2, 16, 14, 3)).astype(np.float32)
    w = (0.1 * rng.standard_normal((k, k, 3, 5))).astype(np.float32)
    want = jax.lax.conv_general_dilated(
        x, w, (s, s), "SAME", dimension_numbers=("NHWC", "HWIO", "NHWC"))
    kernel = torch.from_numpy(w.transpose(3, 2, 0, 1).copy())
    got = tr.nhwc(tr.conv2d_same(tr.nchw(torch.from_numpy(x)), kernel,
                                 stride=s))
    _close(got, want)


def test_max_pool_same_equals_flax():
    jax = _jax()
    import flax.linen as nn

    x = np.random.default_rng(0).standard_normal((2, 16, 15, 4)).astype(
        np.float32)
    want = nn.max_pool(jax.numpy.asarray(x), (3, 3), strides=(2, 2),
                       padding="SAME")
    got = tr.nhwc(tr.max_pool_same(tr.nchw(torch.from_numpy(x)), 3, 2))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ---------------------------------------------------------------------
# BatchNorm
# ---------------------------------------------------------------------

def test_batchnorm_keeps_the_biased_running_variance():
    """flax momentum 0.9 over 3 samples: the running var moves by 0.1 x
    the BIASED batch variance, as flax's does; torch's own running-stat
    update (unbiased) lands elsewhere."""
    jax = _jax()
    import flax.linen as nn

    x = np.random.default_rng(1).standard_normal((3, 1, 1, 4)).astype(
        np.float32) * 2.0 + 0.5
    bn = nn.BatchNorm(momentum=0.9)
    variables = bn.init(jax.random.key(0), x, use_running_average=False)
    want, upd = bn.apply(variables, x, use_running_average=False,
                         mutable=["batch_stats"])
    p, ra = tr.init_bn(4, torch.float32, "cpu")
    got, new = tr.batch_norm(tr.nchw(torch.from_numpy(x)), p, ra, True)
    _close(tr.nhwc(got), want)
    np.testing.assert_allclose(new["var"].numpy(),
                               np.asarray(upd["batch_stats"]["var"]),
                               rtol=1e-6)
    biased = x.reshape(3, 4).var(axis=0)
    np.testing.assert_allclose(new["var"].numpy(), 0.9 + 0.1 * biased,
                               rtol=1e-6)
    run_var = torch.ones(4)
    torch.nn.functional.batch_norm(torch.from_numpy(x.reshape(3, 4)),
                                   torch.zeros(4), run_var, training=True,
                                   momentum=0.1)
    assert not np.allclose(run_var.numpy(), new["var"].numpy(), rtol=1e-3)
    # Eval mode normalises with the stored stats and returns them as is.
    ev, same = tr.batch_norm(tr.nchw(torch.from_numpy(x)), p, new, False)
    want_ev = bn.apply({**variables, **upd}, x, use_running_average=True)
    _close(tr.nhwc(ev), want_ev)
    assert same is new


# Each model runs three ways, on the same params (the JAX init's) and
# inputs, through both packages. Stats and gradients are held leaf by
# leaf by norm, within a share of the leaf's norm plus the tree's RMS
# over its elements (``_tree_close``: a leaf whose exact value is 0, as a
# conv bias's gradient before a BatchNorm, carries rounding only):
#
# * float64 (``jax.enable_x64``): outputs, loss, stats and gradients at
#   ``F64_REL`` -- the check of padding, layout, strides and the
#   BatchNorm formulas; the models still hand out float32 (JAX's final
#   ``astype``), so float32 roundings of the output remain;
# * float32: outputs and loss elementwise (``F32``), stats at
#   ``F32_STATS_REL``, gradients at ``F32_GRAD_REL``: one ReLU input
#   within 1e-5 of zero may fall on either side in float32 and move an
#   early layer's gradient by a few percent;
# * bfloat16: each output, stat and gradient leaf of the port may be off
#   the float64 value by at most ``BF16_VS_REF`` x what the reference's
#   own bf16 run is off it, plus ``BF16_FLOOR`` of the leaf's norm and
#   of the tree's RMS over its elements. Two bf16 runs round in
#   different places, so they are not compared with each other.
F64_REL = 1e-6
F32_STATS_REL, F32_GRAD_REL = 1e-5, 5e-2
BF16_VS_REF, BF16_FLOOR = 3.0, 1e-3
DTYPES = ("float64", "float32", "bfloat16")


def _bf16_tracks(got, ref, exact, name=""):
    got, ref, exact = _flat(got), _flat(ref), _flat(exact)
    if not exact:
        return
    every = np.concatenate([w.ravel() for w in exact.values()])
    rms = float(np.sqrt(np.mean(np.square(every, dtype=np.float64))))
    for k, w in exact.items():
        assert np.isfinite(got[k]).all(), (name, k)
        err = float(np.linalg.norm(got[k] - w))
        bound = BF16_VS_REF * float(np.linalg.norm(ref[k] - w)) + \
            BF16_FLOOR * (float(np.linalg.norm(w)) + rms * np.sqrt(w.size))
        assert err <= bound, (name, k, err, bound)


def _numpy(t):
    return t.detach().to(torch.float64).numpy() if isinstance(
        t, torch.Tensor) else np.asarray(t, np.float64)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = _numpy(v)
    return out


def _tree_close(got, want, rel, name=""):
    """Each leaf within ``rel`` x (its norm + the tree's RMS over its
    elements), by norm."""
    got, want = _flat(got), _flat(want)
    assert sorted(got) == sorted(want), name
    if not want:
        return
    rms = float(np.sqrt(np.mean(np.concatenate(
        [np.square(v).ravel() for v in want.values()]))))
    for k, v in want.items():
        assert got[k].shape == v.shape, (name, k)
        err = float(np.linalg.norm(got[k] - v))
        bound = rel * (float(np.linalg.norm(v)) + rms * np.sqrt(v.size))
        assert err <= bound, (name, k, err, bound)


def _held(got, dtype_name, jax_run):
    """``got`` = the port's (out, loss, stats, grads) at ``dtype_name``;
    ``jax_run(name)`` the JAX package's at ``name``."""
    out, loss, stats, grads = got
    fwd = {"out": _numpy(out), "loss": _numpy(loss)}
    if dtype_name == "bfloat16":
        ref, exact = jax_run("bfloat16"), jax_run("float64")
        for name, g, r, e in (
                ("out", fwd, {"out": ref[0], "loss": ref[1]},
                 {"out": exact[0], "loss": exact[1]}),
                ("stats", stats, ref[2], exact[2]),
                ("grads", grads, ref[3], exact[3])):
            _bf16_tracks(g, r, e, name)
        return
    ref = jax_run(dtype_name)
    wide = dtype_name == "float64"
    for k, v in (("out", ref[0]), ("loss", ref[1])):
        v = np.asarray(v, np.float64)
        if wide:
            np.testing.assert_allclose(fwd[k], v, err_msg=k, rtol=F64_REL,
                                       atol=F64_REL * float(np.abs(v).max()))
        else:
            np.testing.assert_allclose(fwd[k], v, err_msg=k, **F32)
    _tree_close(stats, ref[2], F64_REL if wide else F32_STATS_REL, "stats")
    _tree_close(grads, ref[3], F64_REL if wide else F32_GRAD_REL, "grads")


def _jax_dtype(name):
    import jax.numpy as jnp

    return getattr(jnp, name)


def _torch_dtype(name):
    return getattr(torch, name)


def _jax_grad_run(name, loss_fn, params):
    """``jax.value_and_grad(loss_fn, has_aux=True)`` jitted at ``name``
    (float64 under ``jax.enable_x64``, the params cast to it):
    (out, loss, stats, grads) as numpy."""
    jax = _jax()

    def run():
        p = params
        if name == "float64":
            p = jax.tree.map(lambda a: np.asarray(a, np.float64), params)
        (loss, (out, stats)), grads = jax.jit(jax.value_and_grad(
            loss_fn, has_aux=True))(p)
        return jax.device_get((out, loss, stats, grads))

    if name == "float64":
        with jax.enable_x64(True):
            return run()
    return run()


def _port_params(tree, name):
    dt = _torch_dtype(name)
    pd = torch.float64 if dt == torch.float64 else torch.float32
    return _leaf_params(tr.params_from_numpy(tree, pd)), \
        torch.float64 if dt == torch.float64 else torch.float32, dt


# ---------------------------------------------------------------------
# U-Net
# ---------------------------------------------------------------------

UNET = dict(in_channels=3, out_channels=3, base_features=8)


@functools.lru_cache(maxsize=None)
def _unet_inputs(lat, lon, offset=0.0, scale=1.0, batch=4):
    """The JAX init's params and stats (numpy) and a numpy batch."""
    jax = _jax()
    from tpu_hpc.models import unet as ju

    params, state = jax.device_get(jax.jit(lambda k: ju.init_unet(
        k, ju.UNetConfig(**UNET), (lat, lon, 3)))(jax.random.key(0)))
    rng = np.random.default_rng(1)
    x = (rng.standard_normal((batch, lat, lon, 3)) * scale + offset).astype(
        np.float32)
    y = rng.standard_normal((batch, lat, lon, 3)).astype(np.float32)
    return params, state, x, y


@functools.lru_cache(maxsize=None)
def _jax_unet(name, *case):
    from tpu_hpc.models import losses as jlosses
    from tpu_hpc.models import unet as ju

    params, state, x, y = _unet_inputs(*case)
    wide = name == "float64"
    jcfg = ju.UNetConfig(**UNET, dtype=_jax_dtype(name),
                         param_dtype=_jax_dtype(name) if wide
                         else _jax_dtype("float32"))
    if wide:
        x, y = x.astype(np.float64), y.astype(np.float64)

    def loss_fn(p):
        st = state
        if wide:
            import jax

            st = jax.tree.map(lambda a: a.astype(np.float64), state)
        pred, ns = ju.apply_unet(p, st, x, jcfg, train=True)
        return jlosses.lat_weighted_mse(pred, y), (pred, ns)

    return _jax_grad_run(name, loss_fn, params)


def _port_unet(name, *case):
    params, state, x, y = _unet_inputs(*case)
    p, pd, dt = _port_params(params, name)
    cfg = tu.UNetConfig(**UNET, dtype=dt, param_dtype=pd)
    st = tr.params_from_numpy(state, pd)
    xs, ys = (torch.from_numpy(a).to(pd) for a in (x, y))
    pred, ns = tu.apply_unet(p, st, xs, cfg, train=True)
    loss = lat_weighted_mse(pred, ys)
    loss.backward()
    return pred, loss, ns, _port_grads(p)


def test_bf16_batchnorm_moments_stay_fp32():
    """The property the JAX package's
    ``test_bf16_batchnorm_stats_stay_fp32`` states, held by the port: on
    a mean-4, small-spread input (where bf16-accumulated moments lose
    the variance to the E[x^2] - E[x]^2 cancellation) the bf16 U-Net's
    output, stats and gradients stay finite and track the exact values
    as closely as the reference's bf16 run does, every variance
    positive."""
    case = (32, 16, 4.0, 0.5)
    got = _port_unet("bfloat16", *case)
    _held(got, "bfloat16", lambda n: _jax_unet(n, *case))
    stats = _flat(got[2])
    for k, v in stats.items():
        if k.endswith("/var"):
            assert (v > 0).all(), k
    # The first BatchNorm's input has mean ~4 x sum(kernel): a bf16
    # E[x^2] - E[x]^2 would lose this variance.
    assert (stats["batch_stats/enc1/BatchNorm_0/var"] > 0.9).all()


@pytest.mark.parametrize("dtype_name", DTYPES)
def test_unet_matches_jax_odd_grid(dtype_name):
    """An odd latitude count (19 -> 9 -> 4 -> 9 -> 19, the 181-row
    grid's round trip in small): outputs, the loss, every gradient and
    the updated batch_stats."""
    case = (19, 12)
    got = _port_unet(dtype_name, *case)
    assert got[0].shape == (4, 19, 12, 3)
    assert got[0].dtype == torch.float32  # as JAX's astype(float32)
    _held(got, dtype_name, lambda n: _jax_unet(n, *case))


def test_unet_eval_forward_uses_the_stored_stats():
    """Eval mode normalises with the running stats (here the ones a
    training forward left) and leaves them as they are."""
    jax = _jax()
    from tpu_hpc.models import losses as jlosses
    from tpu_hpc.models import unet as ju

    case = (19, 12)
    params, _, x, y = _unet_inputs(*case)
    ns = _jax_unet("float32", *case)[2]
    want = jlosses.lat_weighted_mse(ju.apply_unet(
        params, ns, x, ju.UNetConfig(**UNET), train=False)[0], y)
    cfg = tu.UNetConfig(**UNET)
    state = tr.state_from_numpy(ns)
    got = tu.make_eval_forward(cfg)(
        tu.params_from_numpy(params, cfg), state,
        (torch.from_numpy(x), torch.from_numpy(y)))[0]
    _close(got, jax.device_get(want))


def test_unet_resize_is_jax_bilinear_at_the_era5_sizes():
    """The decoder's two upsamples at the 1-degree grid's sizes, 45 -> 90
    and 90 -> 181 (by 90 -> 180 and 180 -> 360 columns), in float32 and
    bf16 (within two bf16 ulps of each other: both round the
    interpolation in bf16, in different orders)."""
    jax = _jax()
    rng = np.random.default_rng(5)
    for (h, w), (oh, ow) in (((45, 90), (90, 180)), ((90, 180),
                                                     (181, 360))):
        x = rng.standard_normal((1, h, w, 2)).astype(np.float32)
        for dt, jdt in ((torch.float32, jax.numpy.float32),
                        (torch.bfloat16, jax.numpy.bfloat16)):
            want = np.asarray(jax.image.resize(
                jax.numpy.asarray(x, jdt), (1, oh, ow, 2),
                method="bilinear"), np.float32)
            got = tr.nhwc(tu.bilinear_resize(
                tr.nchw(torch.from_numpy(x).to(dt)), (oh, ow))).float()
            if dt == torch.float32:
                np.testing.assert_allclose(got.numpy(), want, atol=1e-6)
            else:
                np.testing.assert_allclose(got.numpy(), want, rtol=2 ** -6,
                                           atol=2 ** -6)


# ---------------------------------------------------------------------
# ResNet
# ---------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _resnet_inputs(depth, cifar_stem, size, batch):
    jax = _jax()
    from tpu_hpc.models import resnet as jr

    jcfg = jr.ResNetConfig(depth=depth, cifar_stem=cifar_stem)
    params, state = jax.device_get(jax.jit(lambda k: jr.init_resnet(
        k, jcfg, (size, size, 3)))(jax.random.key(depth)))
    rng = np.random.default_rng(depth)
    x = rng.standard_normal((batch, size, size, 3)).astype(np.float32)
    labels = rng.integers(0, 10, batch).astype(np.int32)
    return params, state, x, labels


@functools.lru_cache(maxsize=None)
def _jax_resnet(name, *case):
    from tpu_hpc.models import losses as jlosses
    from tpu_hpc.models import resnet as jr

    depth, cifar_stem = case[:2]
    params, state, x, labels = _resnet_inputs(*case)
    wide = name == "float64"
    jcfg = jr.ResNetConfig(depth=depth, cifar_stem=cifar_stem,
                           dtype=_jax_dtype(name),
                           param_dtype=_jax_dtype(name) if wide
                           else _jax_dtype("float32"))
    if wide:
        x = x.astype(np.float64)

    def loss_fn(p):
        st = state
        if wide:
            import jax

            st = jax.tree.map(lambda a: a.astype(np.float64), state)
        logits, ns = jr.apply_resnet(p, st, x, jcfg, train=True)
        return jlosses.cross_entropy(logits, labels), (logits, ns)

    return _jax_grad_run(name, loss_fn, params)


def _port_resnet(name, *case):
    depth, cifar_stem = case[:2]
    params, state, x, labels = _resnet_inputs(*case)
    p, pd, dt = _port_params(params, name)
    cfg = tr.ResNetConfig(depth=depth, cifar_stem=cifar_stem, dtype=dt,
                          param_dtype=pd)
    logits, ns = tr.apply_resnet(p, tr.params_from_numpy(state, pd),
                                 torch.from_numpy(x).to(pd), cfg)
    loss = cross_entropy(logits, torch.from_numpy(labels).long())
    loss.backward()
    return logits, loss, ns, _port_grads(p)


RESNET_CASES = {"18-cifar": (18, True, 16, 4),
                "18-imagenet": (18, False, 64, 4),
                "50-cifar": (50, True, 16, 4)}


@pytest.mark.parametrize("case, dtype_name", [
    (c, d) for c in sorted(RESNET_CASES) for d in DTYPES
    if c == "18-cifar" or d != "bfloat16"])
def test_resnet_matches_jax(case, dtype_name):
    """BasicBlock (18) and Bottleneck (50), the CIFAR stem and the
    ImageNet stem (7x7 stride 2 padded (2, 3), the SAME max-pool padded
    (0, 1)) with the stride-2 blocks' (0, 1) pads: logits, loss,
    gradients and batch_stats."""
    args = RESNET_CASES[case]
    got = _port_resnet(dtype_name, *args)
    assert got[0].shape == (args[3], 10)
    _held(got, dtype_name, lambda n: _jax_resnet(n, *args))


def _shapes(tree, prefix=""):
    """{path: shape} of a tree of arrays, tensors or shape structs; the
    port's conv kernels read in flax's HWIO order."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_shapes(v, f"{prefix}{k}/"))
        else:
            shape = tuple(v.shape)
            if isinstance(v, torch.Tensor) and k == "kernel" and \
                    len(shape) == 4:
                shape = (shape[2], shape[3], shape[1], shape[0])
            out[prefix + k] = shape
    return out


def test_init_trees_have_the_jax_keys_and_shapes():
    """ResNet-18 and -50 (ImageNet stem), the U-Net and the ViT: the
    port's init gives the JAX init's param and batch_stats trees."""
    jax = _jax()
    from tpu_hpc.models import resnet as jr
    from tpu_hpc.models import unet as ju
    from tpu_hpc.models import vit as jv

    key = jax.random.key(0)
    gen = torch.Generator().manual_seed(0)
    for depth in (18, 50):
        want = jax.eval_shape(lambda k: jr.init_resnet(k, jr.ResNetConfig(
            depth=depth, cifar_stem=False), (32, 32, 3)), key)
        got = tr.init_resnet(gen, tr.ResNetConfig(depth=depth,
                                                  cifar_stem=False))
        assert [_shapes(t) for t in got] == [_shapes(t) for t in want]
    want = jax.eval_shape(lambda k: ju.init_unet(k, ju.UNetConfig(),
                                                 (16, 16, 20)), key)
    got = tu.init_unet(gen, tu.UNetConfig())
    assert [_shapes(t) for t in got] == [_shapes(t) for t in want]
    want = jax.eval_shape(lambda k: jv.init_vit(k, jv.ViTConfig(depth=2)),
                          key)
    assert _shapes(tv.init_vit(gen, tv.ViTConfig(depth=2))) == \
        _shapes(want)


# ---------------------------------------------------------------------
# ViT
# ---------------------------------------------------------------------

VIT = dict(in_channels=3, out_channels=3, patch_size=4, lat=16, lon=32,
           embed_dim=32, depth=2, n_heads=4)


@functools.lru_cache(maxsize=None)
def _vit_inputs():
    jax = _jax()
    from tpu_hpc.models import vit as jv

    params = jax.device_get(jax.jit(lambda k: jv.init_vit(
        k, jv.ViTConfig(**VIT)))(jax.random.key(3)))
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 16, 32, 3)).astype(np.float32)
    y = rng.standard_normal((2, 16, 32, 3)).astype(np.float32)
    return params, x, y


@functools.lru_cache(maxsize=None)
def _jax_vit(name, attn):
    """The JAX ViT with ``attn_fn=None`` (einsum) or
    ``blockwise_attention(causal=False, impl="xla")``."""
    from tpu_hpc.kernels.attention import blockwise_attention
    from tpu_hpc.models import losses as jlosses
    from tpu_hpc.models import vit as jv

    params, x, y = _vit_inputs()
    wide = name == "float64"
    jcfg = jv.ViTConfig(**VIT, dtype=_jax_dtype(name),
                        param_dtype=_jax_dtype(name) if wide
                        else _jax_dtype("float32"))
    if wide:
        x, y = x.astype(np.float64), y.astype(np.float64)
    attn_fn = None if attn == "einsum" else (
        lambda q, k, v: blockwise_attention(q, k, v, causal=False,
                                            impl="xla")[0])

    def loss_fn(p):
        pred = jv.apply_vit(p, x, jcfg, attn_fn)
        return jlosses.lat_weighted_mse(pred, y), (pred, {})

    return _jax_grad_run(name, loss_fn, params)


@pytest.mark.parametrize("attn", ["einsum", "flash"])
@pytest.mark.parametrize("dtype_name", DTYPES)
def test_vit_matches_jax(attn, dtype_name):
    """The ViT through JAX ``attn_fn=None`` (einsum) and
    ``blockwise_attention(causal=False, impl="xla")`` against the port's
    einsum path and its flash hook (the plain versions on the CPU):
    output, loss and every gradient."""
    params, x, y = _vit_inputs()
    p, pd, dt = _port_params(params, dtype_name)
    cfg = tv.ViTConfig(**VIT, dtype=dt, param_dtype=pd)
    pred = tv.apply_vit(p, torch.from_numpy(x).to(pd), cfg,
                        None if attn == "einsum" else tv.flash_attn_fn())
    loss = lat_weighted_mse(pred, torch.from_numpy(y).to(pd))
    loss.backward()
    assert pred.shape == (2, 16, 32, 3)
    _held((pred, loss, {}, _port_grads(p)), dtype_name,
          lambda n: _jax_vit(n, attn))


def test_vit_flash_hook_runs_non_causal():
    """The hook's attention sees every key: a query's output moves when
    a later key changes (a causal mask would hide it)."""
    q = torch.randn(1, 8, 2, 16)
    k, v = torch.randn(1, 8, 2, 16), torch.randn(1, 8, 2, 16)
    out = tv.flash_attn_fn()(q, k, v)
    v2 = v.clone()
    v2[:, -1] += 1.0
    assert not torch.allclose(tv.flash_attn_fn()(q, k, v2)[:, 0], out[:, 0])


# ---------------------------------------------------------------------
# Synced BatchNorm on a 2-rank gloo world
# ---------------------------------------------------------------------

WORLD = 2


def _sync_case():
    cfg = tu.UNetConfig(in_channels=3, out_channels=3, base_features=4)
    params, state = tu.init_unet(torch.Generator().manual_seed(0), cfg)
    rng = np.random.default_rng(11)
    x = rng.standard_normal((4, 8, 8, 3)).astype(np.float32)
    y = rng.standard_normal((4, 8, 8, 3)).astype(np.float32)
    return cfg, params, state, x, y


def _bn_run(cfg, params, state, x, y, all_sum):
    p = _leaf_params(tr.tree_map(lambda _, t: t.clone(), params))
    pred, ns = tu.apply_unet(p, state, torch.from_numpy(x), cfg, True,
                             all_sum)
    loss = lat_weighted_mse(pred, torch.from_numpy(y))
    loss.backward()
    return float(loss.detach()), _port_grads(p), tr.params_to_numpy(ns)


def _tp_vit_case():
    cfg = tv.ViTConfig(**VIT, dtype=torch.float32)
    params = tv.init_vit(torch.Generator().manual_seed(5), cfg)
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.standard_normal((2, 16, 32, 3)).astype(
        np.float32))
    y = torch.from_numpy(rng.standard_normal((2, 16, 32, 3)).astype(
        np.float32))
    return cfg, params, x, y


def _tp_vit_run(params, cfg, x, y):
    """(loss, pred, {path: whole gradient}) of the ViT through the flash
    hook; ``params`` a plain tree or the TP module."""
    from tpu_hpc_torch.parallel.shard import is_dtensor

    pred = tv.apply_vit(params, x, cfg, tv.flash_attn_fn())
    loss = lat_weighted_mse(pred, y)
    loss.backward()
    leaves = (params.named_parameters() if isinstance(
        params, torch.nn.Module) else _flat_tensors(params).items())
    grads = {}
    for name, t in leaves:
        g = t.grad.full_tensor() if is_dtensor(t.grad) else t.grad
        grads[name.replace(".", "/")] = g.detach().numpy()
    return float(loss.detach()), pred.detach().numpy(), grads


def _flat_tensors(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat_tensors(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v
    return out


def _world_main(workdir: str) -> None:
    """One rank: its half of the batch through the U-Net with the BN
    moments summed over the world (synced) and without (the control);
    the gradients summed over the world as data parallelism does. Then
    the ViT tensor-parallel over the two ranks ({"model": 2}, by
    tp.vit_rules)."""
    import torch.distributed as dist

    from tpu_hpc_torch.parallel import tp
    from tpu_hpc_torch.parallel.shard import shard_params
    from tpu_hpc_torch.runtime import MeshSpec, build_mesh, init_distributed

    init_distributed(device="cpu", verbose=False)
    rank = dist.get_rank()
    cfg, params, state, x, y = _sync_case()
    rows = slice(2 * rank, 2 * rank + 2)
    out = {}
    for name, all_sum in (("synced", tr.group_sum()), ("local", None)):
        loss, grads, ns = _bn_run(cfg, params, state, x[rows], y[rows],
                                  all_sum)
        t = torch.tensor([loss])
        dist.all_reduce(t)
        flat = _flat(grads)
        for k in sorted(flat):
            g = torch.from_numpy(flat[k].copy())
            dist.all_reduce(g)
            flat[k] = (g / WORLD).numpy()
        out[name] = {"loss": float(t) / WORLD, "grads": flat,
                     "stats": _flat(ns)}
    cfg, params, x, y = _tp_vit_case()
    mesh = build_mesh(MeshSpec(axes={"model": WORLD}), "cpu")
    module = shard_params(params, mesh, tp.param_pspecs(
        params, tp.vit_rules()), device="cpu")
    out["vit_tp"] = _tp_vit_run(module, cfg, x, y)
    with open(os.path.join(workdir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)
    dist.destroy_process_group()


def test_synced_batchnorm_and_tp_vit_on_two_ranks(tmp_path):
    """Each rank holds half of the global batch. With the moments summed
    over the world, the mean loss, the averaged gradients and every
    rank's updated stats equal one rank's run over the whole batch; with
    local moments (the control) the stats differ. The same world runs
    the ViT tensor parallel (tp.vit_rules over {"model": 2}, the flash
    hook on each rank's local heads): loss, output and every gathered
    gradient equal the one-process run's (float32: ``rtol 1e-4``, the
    all-reduced partial sums in another order)."""
    from tpu_hpc_torch.runtime.sim import launch_local_world, wait_world

    procs = launch_local_world(
        [sys.executable, os.path.abspath(__file__), str(tmp_path)], WORLD,
        env=dict(os.environ, PYTHONPATH=REPO), cwd=REPO)
    logs = wait_world(procs, timeout=120)
    assert all(rc == 0 for rc, _, _ in logs), [err for _, _, err in logs]
    ranks = []
    for r in range(WORLD):
        with open(tmp_path / f"rank{r}.pkl", "rb") as f:
            ranks.append(pickle.load(f))
    cfg, params, state, x, y = _sync_case()
    loss, grads, ns = _bn_run(cfg, params, state, x, y, None)
    want_stats = _flat(ns)
    for got in ranks:
        synced = got["synced"]
        np.testing.assert_allclose(synced["loss"], loss, rtol=1e-5)
        for k, v in _flat(grads).items():
            np.testing.assert_allclose(synced["grads"][k], v, rtol=1e-3,
                                       atol=1e-6, err_msg=k)
        for k, v in want_stats.items():
            np.testing.assert_allclose(synced["stats"][k], v, rtol=1e-5,
                                       atol=1e-6, err_msg=k)
        worst = max(_rel(got["local"]["stats"][k], v)
                    for k, v in want_stats.items())
        assert worst > 1e-3, worst
    # The ViT over a {"model": 2} mesh: each rank's blocks on local heads
    # and MLP columns, the whole gradients gathered, against one process.
    cfg, params, x, y = _tp_vit_case()
    one = _tp_vit_run(tr.tree_map(lambda _, t: t.requires_grad_(True),
                                  params), cfg, x, y)
    for got in ranks:
        loss, pred, grads = got["vit_tp"]
        np.testing.assert_allclose(loss, one[0], rtol=1e-5)
        np.testing.assert_allclose(pred, one[1], rtol=1e-4, atol=1e-5)
        assert sorted(grads) == sorted(one[2])
        for k, v in one[2].items():
            np.testing.assert_allclose(grads[k], v, rtol=1e-4, atol=1e-6,
                                       err_msg=k)


if __name__ == "__main__":
    _world_main(sys.argv[1])
