"""The port's domain parallelism (tpu_hpc_torch/parallel/{domain,
domain_unet}.py) against the JAX package's on the CPU.

The JAX functions run under ``shard_map`` on a (data 2, spatial 4) mesh
of the 8 simulated CPU devices (tests/conftest.py); the port runs the
same 4 bands through its in-process transport (every band in this
process) and, in a 4-process gloo world, through the process-group
transport. Inputs come from a numpy seed; the U-Net's params and stats
from the JAX ``init_unet``.

Tolerances: halo exchange, pooling and the control are exact (data
movement and max); convs and upsampling ``atol 1e-5`` (summation order,
float32), their gradients ``rtol 1e-4, atol 1e-4``; the domain U-Net
against the JAX twin ``rtol 2e-4, atol 2e-4`` (outputs), ``1e-5`` (stats),
``rtol 2e-3, atol 2e-4`` (gradients), as the JAX package's own domain
tests hold its twin to its oracle. The two transports give the same
bands bit for bit for every function of ``parallel/domain.py``, values
and input gradients; the domain U-Net over gloo sums its BatchNorm
moments over the ranks in gloo's order, so it is held to the in-process
run at ``1e-5``.
"""
import os
import pickle
import sys

import numpy as np
import pytest
import torch

from tpu_hpc_torch.models import resnet as tr
from tpu_hpc_torch.models import unet as tu
from tpu_hpc_torch.parallel import domain, domain_unet

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N = 4  # spatial ranks
CONV = dict(atol=1e-5)
GRAD = dict(rtol=1e-4, atol=1e-4)


def _jax():
    return pytest.importorskip("jax", reason="the JAX reference package")


@pytest.fixture(scope="module")
def mesh():
    jax = _jax()
    from jax.sharding import Mesh

    return Mesh(np.array(jax.devices()[:8]).reshape(2, N),
                ("data", "spatial"))


def _rand(seed, shape, scale=1.0):
    return (scale * np.random.default_rng(seed).standard_normal(shape)
            ).astype(np.float32)


def _oihw(hwio):
    return torch.from_numpy(np.ascontiguousarray(hwio.transpose(3, 2, 0, 1)))


def _port(body, ring=None):
    return domain.domain_parallel(body, ring or domain.InProcessHalo(N))


# ---------------------------------------------------------------------
# halo_exchange
# ---------------------------------------------------------------------

@pytest.mark.parametrize("halo, wrap", [
    (1, False), (2, False), ((0, 1), False), ((2, 0), False), (1, True),
    ((1, 2), True)])
def test_halo_exchange_matches_jax(mesh, halo, wrap):
    """Each band padded with its neighbours' rows (zeros at the ring ends
    unless ``wrap``), as the JAX ppermute pair gives them: the padded
    bands, stitched, are equal bit for bit."""
    jax = _jax()
    from tpu_hpc.parallel import domain as jd

    x = _rand(1, (2, 32, 4, 3))
    lo, hi = (halo, halo) if isinstance(halo, int) else halo
    h = 32 // N
    # The padded bands are taller than the tiles: gather them as a
    # [B, N, lo + h + hi, ...] stack on both sides.
    want = jax.jit(jd.domain_parallel(
        lambda ax, p, t: jd.halo_exchange(t, ax, halo, wrap=wrap)[
            :, None], mesh))(None, x.reshape(2, 32, 4, 3))
    want = np.asarray(want).reshape(2, N, lo + h + hi, 4, 3)
    tiles = domain.halo_exchange(
        domain.split_tiles(torch.from_numpy(x), domain.InProcessHalo(N)),
        domain.InProcessHalo(N), halo, wrap=wrap)
    got = torch.stack(tiles, dim=1).numpy()
    np.testing.assert_array_equal(got, want)


def test_halo_too_large_and_negative_refused_in_jax_words(mesh):
    jax = _jax()
    from tpu_hpc.parallel import domain as jd

    x = np.zeros((2, 32, 4, 1), np.float32)
    for halo in (9, (-1, 1)):
        with pytest.raises(ValueError) as want:
            jd.domain_parallel(lambda ax, p, t: jd.halo_exchange(
                t, ax, halo), mesh)(None, x)
        with pytest.raises(ValueError) as got:
            _port(lambda r, p, t: domain.halo_exchange(t, r, halo))(
                None, torch.from_numpy(x))
        assert str(got.value) == str(want.value)
    del jax


# ---------------------------------------------------------------------
# halo_conv2d
# ---------------------------------------------------------------------

CONV_CASES = [(3, 1, False), (5, 1, False), (3, 2, False), (2, 2, False),
              (5, 2, False), (1, 2, False), (4, 2, False), (3, 4, False),
              (4, 1, False), (3, 1, True), (4, 2, True), (6, 2, True)]


@pytest.mark.parametrize("k, stride, wrap", CONV_CASES)
def test_halo_conv2d_matches_jax_with_gradients(mesh, k, stride, wrap):
    """Any (kernel, stride): the halos land where SAME places the
    windows -- the 5x5 two-row halo, stride 2's asymmetric (0, 1) split,
    the periodic ring -- and the gradients of the kernel, the bias and
    the input (the shifts' transposes) equal the JAX ones."""
    jax = _jax()
    from tpu_hpc.parallel import domain as jd

    x = _rand(k * 10 + stride, (2, 32, 16, 3))
    w = _rand(k, (k, k, 3, 5), 0.1)
    b = _rand(k + 1, (5,), 0.1)
    fn = jd.domain_parallel(lambda ax, p, t: jd.halo_conv2d(
        t, p[0], p[1], axis_name=ax, stride=stride, wrap=wrap), mesh)

    def loss(p, t):
        return jax.numpy.sum(fn(p, t) ** 2)

    want = jax.jit(fn)((w, b), x)
    gw, gx = jax.jit(jax.grad(loss, argnums=(0, 1)))((w, b), x)
    kernel = _oihw(w).requires_grad_(True)
    bias = torch.from_numpy(b).requires_grad_(True)
    xt = torch.from_numpy(x).requires_grad_(True)
    got = _port(lambda r, p, t: domain.halo_conv2d(
        t, p[0], p[1], ring=r, stride=stride, wrap=wrap))((kernel, bias), xt)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **CONV)
    (got ** 2).sum().backward()
    np.testing.assert_allclose(kernel.grad.numpy().transpose(2, 3, 1, 0),
                               np.asarray(gw[0]), **GRAD)
    np.testing.assert_allclose(bias.grad.numpy(), np.asarray(gw[1]), **GRAD)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gx), **GRAD)


def test_naive_split_conv_corrupts_the_seams(mesh):
    """The control: without halos each band zero-pads its own borders;
    it equals the JAX naive split and differs from the halo conv on the
    kh // 2 rows beside every internal seam, nowhere else."""
    jax = _jax()
    from tpu_hpc.parallel import domain as jd

    x = _rand(2, (2, 32, 8, 3))
    w = _rand(3, (3, 3, 3, 4), 0.1)
    want = jax.jit(jd.domain_parallel(
        lambda ax, p, t: jd.naive_split_conv2d(t, p, axis_name=ax),
        mesh))(w, x)
    naive = _port(lambda r, p, t: domain.naive_split_conv2d(t, p))(
        _oihw(w), torch.from_numpy(x))
    halo = _port(lambda r, p, t: domain.halo_conv2d(t, p, ring=r))(
        _oihw(w), torch.from_numpy(x))
    np.testing.assert_allclose(naive.numpy(), np.asarray(want), **CONV)
    rows = (naive - halo).abs().amax(dim=(0, 2, 3)) > 1e-4
    seams = {s + d for s in range(8, 32, 8) for d in (-1, 0)}
    assert {int(i) for i in torch.nonzero(rows)} == seams


@pytest.mark.parametrize("kwargs, stride, x_shape", [
    (dict(global_h=0), 1, (2, 32, 16, 3)),
    (dict(global_w=0), 1, (2, 32, 16, 3)),
    (dict(global_h=-4), 1, (2, 32, 16, 3)),
    (dict(global_h=30), 1, (2, 32, 16, 3)),
    (dict(global_w=8), 1, (2, 32, 16, 3)),
    ({}, 3, (2, 32, 16, 3)),
    ({}, 0, (2, 32, 16, 3)),
    (dict(wrap=True), 2, (2, 32, 16, 3)),
], ids=["global_h_0", "global_w_0", "global_h_negative",
        "global_h_not_multiple", "global_w_not_width", "uneven_stride",
        "stride_0", "periodic_odd_split"])
def test_halo_conv2d_refusals_in_jax_words(mesh, kwargs, stride, x_shape):
    """Every refusal of the JAX function, word for word: non-positive or
    non-multiple global extents, a stride that leaves a band fractional
    rows, a periodic strided conv with an odd k - s."""
    jax = _jax()
    from tpu_hpc.parallel import domain as jd

    x = np.zeros(x_shape, np.float32)
    w = np.zeros((3, 3, 3, 4), np.float32)
    with pytest.raises(ValueError) as want:
        jax.jit(jd.domain_parallel(lambda ax, p, t: jd.halo_conv2d(
            t, p, axis_name=ax, stride=stride, **kwargs), mesh))(w, x)
    with pytest.raises(ValueError) as got:
        _port(lambda r, p, t: domain.halo_conv2d(
            t, p, ring=r, stride=stride, **kwargs))(
                _oihw(w), torch.from_numpy(x))
    assert str(got.value) == str(want.value)


def test_explicit_global_extents_match_the_default(mesh):
    x = torch.from_numpy(_rand(11, (2, 32, 16, 3)))
    w = _oihw(_rand(12, (3, 3, 3, 4), 0.1))

    def conv(gh, gw):
        return _port(lambda r, p, t: domain.halo_conv2d(
            t, p, ring=r, global_h=gh, global_w=gw))(w, x)

    assert torch.equal(conv(32, 16), conv(None, None))


# ---------------------------------------------------------------------
# Pool, upsample, layouts
# ---------------------------------------------------------------------

def test_max_pool_matches_and_refuses_odd_bands(mesh):
    jax = _jax()
    from tpu_hpc.parallel import domain as jd

    x = _rand(3, (2, 32, 16, 6))
    want = jax.jit(jd.domain_parallel(lambda ax, p, t: jd.max_pool_2x2(t),
                                      mesh))({}, x)
    got = _port(lambda r, p, t: domain.max_pool_2x2(t))(
        {}, torch.from_numpy(x))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    odd = np.zeros((2, 36, 4, 1), np.float32)  # bands of 9 rows
    with pytest.raises(ValueError) as want_err:
        jd.domain_parallel(lambda ax, p, t: jd.max_pool_2x2(t), mesh)({}, odd)
    with pytest.raises(ValueError) as got_err:
        _port(lambda r, p, t: domain.max_pool_2x2(t))(
            {}, torch.from_numpy(odd))
    assert str(got_err.value) == str(want_err.value)


def test_upsample_matches_jax_with_gradient(mesh):
    """The 2x bilinear upsample (one halo row a side, edge rows clamped
    at the global boundary) and its gradient."""
    jax = _jax()
    from tpu_hpc.parallel import domain as jd

    x = _rand(4, (2, 16, 8, 6))
    fn = jd.domain_parallel(lambda ax, p, t: jd.halo_upsample2x(t, ax), mesh)
    want = jax.jit(fn)({}, x)
    gx = jax.jit(jax.grad(lambda t: jax.numpy.sum(fn({}, t) ** 2)))(x)
    xt = torch.from_numpy(x).requires_grad_(True)
    got = _port(lambda r, p, t: domain.halo_upsample2x(t, r))({}, xt)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-5)
    (got ** 2).sum().backward()
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gx), **GRAD)
    # ... and it is the one-device resize.
    whole = tu.bilinear_resize(tr.nchw(torch.from_numpy(x)), (32, 16))
    np.testing.assert_allclose(got.detach().numpy(),
                               tr.nhwc(whole).numpy(), atol=1e-6)


def test_spatial_pspec_and_domain_constrain():
    _jax()
    from tpu_hpc.parallel import domain as jd

    assert tuple(domain.spatial_pspec()) == tuple(jd.spatial_pspec())
    assert tuple(domain.spatial_pspec(None, "sp")) == tuple(
        jd.spatial_pspec(None, "sp"))
    # Without a mesh nothing is split; a 3-D tensor always passes (on a
    # (data, spatial) mesh: the gloo world below).
    x = torch.arange(2 * 8 * 3 * 1.0).reshape(2, 8, 3, 1)
    assert torch.equal(domain.domain_constrain(None)(x), x)
    flat = torch.zeros(2, 8, 3)
    assert domain.domain_constrain(None)(flat) is flat


# ---------------------------------------------------------------------
# The domain U-Net
# ---------------------------------------------------------------------

UNET = dict(in_channels=3, out_channels=3, base_features=8)


@pytest.fixture(scope="module")
def unet_case():
    jax = _jax()
    from tpu_hpc.models import unet as ju

    params, state = jax.device_get(jax.jit(lambda k: ju.init_unet(
        k, ju.UNetConfig(**UNET), (32, 16, 3)))(jax.random.key(0)))
    x = _rand(1, (4, 32, 16, 3))
    y = _rand(2, (4, 32, 16, 3))
    return params, state, x, y


@pytest.fixture(scope="module")
def jax_twin(mesh, unet_case):
    """The JAX domain twin: train forward, new stats, param grads of the
    plain MSE, and the eval forward."""
    jax = _jax()
    from tpu_hpc.models import unet as ju
    from tpu_hpc.parallel import domain_unet as jdu

    params, state, x, y = unet_case
    dom = jdu.make_domain_unet(mesh, ju.UNetConfig(**UNET))
    pred, ns = jax.jit(lambda p, s, t: dom(p, s, t, train=True))(
        params, state, x)
    grads = jax.jit(jax.grad(lambda p: jax.numpy.mean(
        (dom(p, state, x, train=True)[0] - y) ** 2)))(params)
    ev, _ = jax.jit(lambda p, s, t: dom(p, s, t, train=False))(
        params, ns, x)
    return jax.device_get((pred, ns, grads, ev))


def _port_twin(unet_case, ring, x=None, all_sum=None):
    params, state, x0, y = unet_case
    x = x0 if x is None else x
    cfg = tu.UNetConfig(**UNET)
    p = tr.tree_map(lambda _, t: t.requires_grad_(True),
                    tu.params_from_numpy(params, cfg))
    apply = domain_unet.make_domain_unet(ring, cfg, all_sum)
    pred, ns = apply(p, tr.state_from_numpy(state), torch.from_numpy(x))
    return p, pred, ns


def test_domain_unet_matches_the_jax_twin(unet_case, jax_twin):
    """The whole U-Net over 4 bands in process against the JAX twin on
    the (data 2, spatial 4) mesh: the train forward, the updated stats,
    every param gradient, and the eval forward on the new stats."""
    params, state, x, y = unet_case
    pred_w, ns_w, grads_w, ev_w = jax_twin
    p, pred, ns = _port_twin(unet_case, domain.InProcessHalo(N))
    np.testing.assert_allclose(pred.detach().numpy(), pred_w, rtol=2e-4,
                               atol=2e-4)
    for (k, v), w in zip(sorted(_flat(tr.params_to_numpy(ns)).items()),
                         [v for _, v in sorted(_flat(ns_w).items())]):
        np.testing.assert_allclose(v, w, rtol=1e-5, atol=1e-5, err_msg=k)
    ((pred - torch.from_numpy(y)) ** 2).mean().backward()
    got = _flat(tr.params_to_numpy(tr.tree_map(lambda _, t: t.grad, p)))
    for k, w in _flat(grads_w).items():
        np.testing.assert_allclose(got[k], w, rtol=2e-3, atol=2e-4,
                                   err_msg=k)
    cfg = tu.UNetConfig(**UNET)
    ev, same = domain_unet.make_domain_unet(domain.InProcessHalo(N), cfg)(
        tu.params_from_numpy(params, cfg), tr.state_from_numpy(ns_w),
        torch.from_numpy(x), train=False)
    np.testing.assert_allclose(ev.numpy(), ev_w, rtol=2e-4, atol=2e-4)


def test_domain_unet_equals_the_one_device_unet(unet_case):
    """The twin's oracle in the port: the one-device ``apply_unet`` on
    the same trees -- and a band count the pools cannot tile is
    refused."""
    params, state, x, _ = unet_case
    cfg = tu.UNetConfig(**UNET)
    _, pred, ns = _port_twin(unet_case, domain.InProcessHalo(N))
    want, want_ns = tu.apply_unet(tu.params_from_numpy(params, cfg),
                                  tr.state_from_numpy(state),
                                  torch.from_numpy(x), cfg)
    np.testing.assert_allclose(pred.detach().numpy(),
                               want.detach().numpy(), rtol=1e-4, atol=1e-4)
    for k, v in _flat(tr.params_to_numpy(want_ns)).items():
        np.testing.assert_allclose(_flat(tr.params_to_numpy(ns))[k], v,
                                   rtol=1e-5, atol=1e-6, err_msg=k)
    with pytest.raises(ValueError, match="two pool levels"):
        _port_twin(unet_case, domain.InProcessHalo(N),
                   x=np.zeros((1, 24, 16, 3), np.float32))


def test_band_loss_means_to_the_whole_grid_loss():
    """The band-weighted MSE of each rank's rows, averaged over the
    bands, is the whole grid's latitude-weighted MSE."""
    from tpu_hpc_torch.models.losses import lat_weighted_mse

    pred, y = torch.randn(2, 32, 5, 3), torch.randn(2, 32, 5, 3)
    bands = [domain_unet.band_lat_weighted_mse(
        pred[:, r * 8:(r + 1) * 8], y[:, r * 8:(r + 1) * 8], 32, r * 8)
        for r in range(N)]
    torch.testing.assert_close(sum(bands) / N, lat_weighted_mse(pred, y))


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = np.asarray(v, np.float32)
    return out


# ---------------------------------------------------------------------
# The process-group transport on a 4-rank gloo world
# ---------------------------------------------------------------------

def _transport_ops(ring, x, w, up_x):
    """Every function of parallel/domain.py on the local bands, forward
    and input gradient: {name: (value tiles, gradient tiles)}."""
    out = {}
    tiles = domain.split_tiles(x, ring)
    for name, fn in (
        ("exchange_2", lambda t: domain.halo_exchange(t, ring, 2)),
        ("exchange_wrap", lambda t: domain.halo_exchange(t, ring, (1, 2),
                                                         wrap=True)),
        ("conv_5x5", lambda t: domain.halo_conv2d(t, w, ring=ring)),
        ("conv_s2", lambda t: domain.halo_conv2d(t, w[..., :3, :3],
                                                 ring=ring, stride=2)),
        ("conv_wrap", lambda t: domain.halo_conv2d(t, w[..., :3, :3],
                                                   ring=ring, wrap=True)),
        ("pool", domain.max_pool_2x2),
    ):
        leaves = [t.detach().clone().requires_grad_(True) for t in tiles]
        vals = fn(leaves)
        sum((v ** 2).sum() for v in vals).backward()
        out[name] = ([v.detach().numpy() for v in vals],
                     [t.grad.numpy() for t in leaves])
    leaves = [t.detach().clone().requires_grad_(True)
              for t in domain.split_tiles(up_x, ring)]
    vals = domain.halo_upsample2x(leaves, ring)
    sum((v ** 2).sum() for v in vals).backward()
    out["upsample"] = ([v.detach().numpy() for v in vals],
                       [t.grad.numpy() for t in leaves])
    return out


def _transport_inputs():
    x = torch.from_numpy(_rand(20, (2, 32, 8, 3)))
    w = _oihw(_rand(21, (5, 5, 3, 4), 0.1))
    up_x = torch.from_numpy(_rand(22, (2, 16, 8, 3)))
    return x, w, up_x


def _world_main(workdir: str) -> None:
    import torch.distributed as dist

    from tpu_hpc_torch.runtime import init_distributed

    init_distributed(device="cpu", verbose=False)
    rank = dist.get_rank()
    from torch.distributed.device_mesh import init_device_mesh

    ring = domain.ProcessGroupHalo()
    out = {"ops": _transport_ops(ring, *_transport_inputs())}
    mesh = init_device_mesh("cpu", (1, N), mesh_dim_names=("data", "spatial"))
    out["constrain"] = domain.domain_constrain(mesh)(
        _transport_inputs()[0]).numpy()
    with open(os.path.join(workdir, "unet.pkl"), "rb") as f:
        case = pickle.load(f)
    h = case[2].shape[1] // N
    band = case[2][:, rank * h:(rank + 1) * h]
    p, pred, ns = _port_twin(case, ring, x=band, all_sum=tr.group_sum())
    pred.sum().backward()
    out["unet"] = (pred.detach().numpy(), _flat(tr.params_to_numpy(ns)))
    with open(os.path.join(workdir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)
    dist.destroy_process_group()


def test_process_group_transport_equals_in_process(unet_case, tmp_path):
    """Four gloo ranks, one band each: every domain function's bands and
    input gradients equal the in-process transport's bit for bit, the
    (data 1, spatial 4) layout hook hands each rank its band, and the
    domain U-Net's band and stats equal the in-process run's."""
    from tpu_hpc_torch.runtime.sim import launch_local_world, wait_world

    with open(tmp_path / "unet.pkl", "wb") as f:
        pickle.dump(unet_case, f)
    procs = launch_local_world(
        [sys.executable, os.path.abspath(__file__), str(tmp_path)], N,
        env=dict(os.environ, PYTHONPATH=REPO), cwd=REPO)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)  # the world's processes share the cores
    try:
        local = _transport_ops(domain.InProcessHalo(N), *_transport_inputs())
        _, pred, ns = _port_twin(unet_case, domain.InProcessHalo(N))
    finally:
        torch.set_num_threads(threads)
        logs = wait_world(procs, timeout=180)
    assert all(rc == 0 for rc, _, _ in logs), [err for _, _, err in logs]
    h = pred.shape[1] // N
    stats = _flat(tr.params_to_numpy(ns))
    for r in range(N):
        with open(tmp_path / f"rank{r}.pkl", "rb") as f:
            got = pickle.load(f)
        for name, (vals, grads) in local.items():
            g_vals, g_grads = got["ops"][name]
            np.testing.assert_array_equal(g_vals[0], vals[r], err_msg=name)
            np.testing.assert_array_equal(g_grads[0], grads[r],
                                          err_msg=name)
        np.testing.assert_array_equal(
            got["constrain"], _transport_inputs()[0][:, r * 8:(r + 1) * 8])
        band, g_stats = got["unet"]
        np.testing.assert_allclose(
            band, pred.detach().numpy()[:, r * h:(r + 1) * h], rtol=1e-5,
            atol=1e-5)
        for k, v in stats.items():
            np.testing.assert_allclose(g_stats[k], v, rtol=1e-5, atol=1e-6,
                                       err_msg=k)


if __name__ == "__main__":
    _world_main(sys.argv[1])
