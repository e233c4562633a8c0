"""Domain parallelism: a grid sharded by latitude bands, with halo
exchange.

Port of the JAX package's ``parallel/domain.py``. Each spatial rank owns
a band of rows of an NHWC grid and, before each conv, takes ``halo``
boundary rows from its neighbours, so the stitched result equals the
one-device conv; ring ends receive zeros (the zero SAME pad at the
global boundary) unless ``wrap`` closes the ring (a periodic domain).

The JAX package moves rows with ``jax.lax.ppermute`` inside
``shard_map``. The port keeps the move behind a transport, in the
pattern of ``parallel/sp_transport.py``:

  * :class:`InProcessHalo` -- all ``n`` ranks' tiles in this process, on
    one device: a shift is list indexing (rank i's rows to rank i + 1),
    differentiable as it stands. One card runs a degree-n domain this
    way; no CLI flag selects it for a process group.
  * :class:`ProcessGroupHalo` -- this process is one rank of a
    ``torch.distributed`` group (NCCL on cards, gloo on the CPU): a
    shift is one ``batch_isend_irecv``, and its backward the shift the
    other way (``ppermute``'s transpose).

Every function takes and returns a list with one NHWC tile per *local*
rank (``ring.ranks``: all of them in process, one in a group); the two
transports give the same tiles bit for bit. Conv kernels are OIHW, as
everywhere in the port (flax's HWIO transposed by
``models.resnet.params_from_numpy``).
"""
from __future__ import annotations

from typing import Callable, List, Optional, Sequence

import torch
import torch.nn.functional as F

from tpu_hpc_torch.models.resnet import conv2d, nchw, nhwc, same_pads
from tpu_hpc_torch.parallel.plans import P

Tiles = List[torch.Tensor]


class InProcessHalo:
    """All ``n`` spatial ranks' tiles in this process."""

    def __init__(self, n: int):
        if n < 1:
            raise ValueError(f"a domain needs n >= 1 ranks, got {n}")
        self.n = n
        self.ranks = tuple(range(n))

    def shift(self, xs: Sequence[torch.Tensor], step: int, wrap: bool,
              fill: Optional[Sequence[torch.Tensor]] = None) -> Tiles:
        """Rank i's tensor goes to rank i + ``step``; a rank nothing
        reaches (a ring end, unless ``wrap``) gets zeros, or its entry of
        ``fill``."""
        out = []
        for r in range(self.n):
            src = r - step
            if wrap or 0 <= src < self.n:
                out.append(xs[src % self.n])
            elif fill is not None:
                out.append(fill[r])
            else:
                out.append(torch.zeros_like(xs[r]))
        return out


class ProcessGroupHalo:
    """This process as one rank of ``group`` (its position in the group
    is its band)."""

    def __init__(self, group=None):
        import torch.distributed as dist

        self.group = group
        self.n = dist.get_world_size(group)
        self.ranks = (dist.get_rank(group),)

    def _peer(self, position: int) -> int:
        import torch.distributed as dist

        return dist.get_global_rank(self.group, position % self.n) \
            if self.group is not None else position % self.n

    def shift(self, xs: Sequence[torch.Tensor], step: int, wrap: bool,
              fill: Optional[Sequence[torch.Tensor]] = None) -> Tiles:
        (x,) = xs
        (f,) = fill if fill is not None else (None,)
        return [_Shift.apply(x, f, self, step, wrap)]


def _has_source(ring, step: int, wrap: bool) -> bool:
    return wrap or 0 <= ring.ranks[0] - step < ring.n


def _shift(x: torch.Tensor, ring: ProcessGroupHalo, step: int,
           wrap: bool) -> torch.Tensor:
    """One ``batch_isend_irecv``: ``x`` to rank me + step, the result
    from me - step (zeros where there is none)."""
    import torch.distributed as dist

    me, n = ring.ranks[0], ring.n
    out = torch.zeros_like(x, memory_format=torch.contiguous_format)
    if n == 1:
        return x.clone() if wrap else out
    ops = []
    if wrap or 0 <= me + step < n:
        ops.append(dist.P2POp(dist.isend, x.contiguous(),
                              ring._peer(me + step), ring.group))
    if _has_source(ring, step, wrap):
        ops.append(dist.P2POp(dist.irecv, out, ring._peer(me - step),
                              ring.group))
    for w in dist.batch_isend_irecv(ops):
        w.wait()
    return out


class _Shift(torch.autograd.Function):
    """A shift by ``step`` (a ring end takes ``fill``, or zeros); its
    adjoint shifts the gradient back. Every rank uses the result, so
    every rank runs the backward's send and receive."""

    @staticmethod
    def forward(ctx, x, fill, ring, step, wrap):
        ctx.args = (ring, step, wrap, fill is not None)
        out = _shift(x, ring, step, wrap)
        if fill is not None and not _has_source(ring, step, wrap):
            out = fill.clone()
        return out

    @staticmethod
    def backward(ctx, g):
        ring, step, wrap, filled = ctx.args
        gx = _shift(g.contiguous(), ring, -step, wrap)
        gf = None
        if filled:
            gf = g if not _has_source(ring, step, wrap) \
                else torch.zeros_like(g)
        return gx, gf, None, None, None


def halo_exchange(xs: Sequence[torch.Tensor], ring, halo, *, axis: int = 1,
                  wrap: bool = False) -> Tiles:
    """Pad each local tile with its neighbours' rows along ``axis``:
    ``[..., H_loc, ...]`` -> ``[..., lo + H_loc + hi, ...]``. ``halo`` is
    an int (symmetric) or an ``(lo, hi)`` pair -- strided convs need
    asymmetric halos, as SAME padding is asymmetric when the total pad
    is odd (k=3, s=2 pads (0, 1)). Ring ends receive zeros unless
    ``wrap``."""
    lo, hi = (halo, halo) if isinstance(halo, int) else halo
    if lo == 0 and hi == 0:
        return list(xs)
    if lo < 0 or hi < 0:
        raise ValueError(f"negative halo ({lo}, {hi})")
    size = xs[0].shape[axis]
    if max(lo, hi) > size:
        raise ValueError(
            f"halo ({lo}, {hi}) exceeds local tile size {size}"
        )
    parts: List[Tiles] = []
    if lo:
        # My last rows become the right neighbour's left halo.
        parts.append(ring.shift([x.narrow(axis, size - lo, lo) for x in xs],
                                1, wrap))
    parts.append(list(xs))
    if hi:
        parts.append(ring.shift([x.narrow(axis, 0, hi) for x in xs], -1,
                                wrap))
    return [torch.cat([p[i] for p in parts], axis) for i in range(len(xs))]


def halo_conv2d(
    xs: Sequence[torch.Tensor],
    kernel: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
    *,
    ring,
    stride: int = 1,
    wrap: bool = False,
    global_h: Optional[int] = None,
    global_w: Optional[int] = None,
) -> Tiles:
    """The one-device SAME conv on H-sharded NHWC tiles, any stride.

    ``xs``: local tiles ``[B, H_loc, W, Cin]``; ``kernel``: OIHW. Each
    tile takes the exact (asymmetric) halo the global window placement
    needs and runs a VALID conv in H (W padded locally, SAME). Under
    stride s, SAME puts window j at rows ``[j s - pad_lo, j s - pad_lo +
    k)``, so a tile needs ``pad_lo`` rows from its left neighbour and
    ``k - s - pad_lo`` (at least 0) from its right; the ring ends get
    zeros, the global boundary's pad. ``H_loc % s == 0`` is required
    (whole output rows per rank); ``global_h``/``global_w`` override the
    extents the SAME arithmetic assumes (defaults: the tile's)."""
    kh, kw = kernel.shape[2], kernel.shape[3]
    h_loc, w = xs[0].shape[1], xs[0].shape[2]
    if stride < 1:
        raise ValueError(f"stride {stride} must be >= 1")
    if global_h is not None and (global_h <= 0 or global_h % h_loc):
        raise ValueError(
            f"global_h {global_h} must be a positive multiple of the "
            f"local tile height {h_loc}"
        )
    if global_w is not None and global_w != w:
        raise ValueError(
            f"global_w {global_w} must equal the tile width {w}: W is "
            "never sharded here (there is no W halo exchange), so any "
            "other extent would silently mis-pad the SAME conv"
        )
    if h_loc % stride:
        raise ValueError(
            f"local tile height {h_loc} must divide by stride {stride} "
            "(each device must emit whole output rows)"
        )
    # The H split depends only on (H % s, k, s): with H_loc % s == 0 the
    # tile has the residue of any global multiple. wrap=True: no
    # boundary pad, symmetric halos.
    if wrap:
        if (kh - stride) % 2:
            raise ValueError(
                f"periodic strided conv needs k-s even (k={kh}, "
                f"s={stride}): the wrap halo has no zero-pad slack "
                "to absorb an asymmetric split"
            )
        pad_lo = (kh - stride) // 2 if kh > stride else 0
    else:
        pad_lo, _ = same_pads(h_loc if global_h is None else global_h, kh,
                              stride)
    halo_hi = max(kh - stride - pad_lo, 0)
    padded = halo_exchange(xs, ring, (pad_lo, halo_hi), axis=1, wrap=wrap)
    pw_lo, pw_hi = same_pads(w if global_w is None else global_w, kw,
                             stride)
    return [nhwc(conv2d(nchw(x), kernel, bias, stride, (0, 0, pw_lo, pw_hi)))
            for x in padded]


def max_pool_2x2(xs: Sequence[torch.Tensor]) -> Tiles:
    """2x2 stride-2 max pool on H-sharded NHWC tiles: with H_loc even
    the windows tile each band exactly, so the local pool is the global
    one -- no halo."""
    out = []
    for x in xs:
        if x.shape[1] % 2:
            raise ValueError(
                f"local tile height {x.shape[1]} must be even for a 2x2 "
                "pool (whole windows per device)"
            )
        out.append(nhwc(F.max_pool2d(nchw(x), 2, 2)))
    return out


def halo_upsample2x(xs: Sequence[torch.Tensor], ring) -> Tiles:
    """Bilinear 2x upsample of H-sharded NHWC tiles, equal to the
    one-device ``F.interpolate(mode="bilinear")`` (``jax.image.resize``).
    Output row j reads source position ``j/2 - 0.25``, so seam rows read
    one row across the seam: one halo row per side; at the global edges
    the resize clamps, so the ring ends take their own edge row. With
    padded rows p: even rows ``0.25 p[i] + 0.75 p[i+1]``, odd rows
    ``0.75 p[i+1] + 0.25 p[i+2]``. W is unsharded and resized locally
    (bilinear is separable)."""
    tops = [x[:, :1] for x in xs]
    bots = [x[:, -1:] for x in xs]
    # Global edges: clamp == the band's own edge row.
    from_left = ring.shift(bots, 1, False, fill=tops)
    from_right = ring.shift(tops, -1, False, fill=bots)
    out = []
    for i, x in enumerate(xs):
        p = torch.cat([from_left[i], x, from_right[i]], dim=1)
        a, mid, z = p[:, :-2], p[:, 1:-1], p[:, 2:]
        even = 0.25 * a + 0.75 * mid
        odd = 0.75 * mid + 0.25 * z
        b, h, w, c = x.shape
        up = torch.stack([even, odd], dim=2).reshape(b, 2 * h, w, c)
        up = F.interpolate(nchw(up), size=(2 * h, 2 * w), mode="bilinear",
                           align_corners=False)
        out.append(nhwc(up).to(x.dtype))
    return out


def spatial_pspec(dp_axis: Optional[str] = "data",
                  spatial_axis: str = "spatial") -> P:
    """Layout of an NHWC activation: batch on ``dp_axis``, H (latitude
    bands) on ``spatial_axis``."""
    return P(dp_axis, spatial_axis, None, None)


def domain_constrain(mesh, dp_axis: Optional[str] = "data",
                     spatial_axis: str = "spatial"
                     ) -> Callable[[torch.Tensor], torch.Tensor]:
    """The (data, spatial) layout as the hook the JAX package pins with
    ``with_sharding_constraint``: a whole 4-D NHWC tensor -> this rank's
    piece of it (its batch rows on ``dp_axis``, its band on
    ``spatial_axis``); other ranks' tensors pass through. ``mesh``: a
    ``DeviceMesh`` naming the axes (an absent axis is not split)."""
    names = tuple(mesh.mesh_dim_names or ()) if mesh is not None else ()

    def coord(axis):
        if axis is None or axis not in names:
            return 1, 0
        return mesh[axis].size(), mesh[axis].get_local_rank()

    def constrain(x: torch.Tensor) -> torch.Tensor:
        if x.ndim != 4:
            return x
        for dim, axis in ((0, dp_axis), (1, spatial_axis)):
            n, r = coord(axis)
            if x.shape[dim] % n:
                raise ValueError(f"dim {dim} of {tuple(x.shape)} does not "
                                 f"split over {n} {axis} ranks")
            m = x.shape[dim] // n
            x = x.narrow(dim, r * m, m)
        return x

    return constrain


def split_tiles(x: torch.Tensor, ring) -> Tiles:
    """A whole NHWC grid -> the local ranks' bands (H split evenly)."""
    if x.shape[1] % ring.n:
        raise ValueError(f"H {x.shape[1]} does not split into {ring.n} "
                         "bands")
    h = x.shape[1] // ring.n
    return [x[:, r * h:(r + 1) * h] for r in ring.ranks]


def gather_tiles(tiles: Sequence[torch.Tensor], ring) -> torch.Tensor:
    """The inverse of :func:`split_tiles`: every band, in order, on every
    rank (a differentiable all-gather for a process group)."""
    if isinstance(ring, InProcessHalo):
        return torch.cat(list(tiles), dim=1)
    (t,) = tiles
    if ring.n == 1:
        return t
    from torch.distributed.nn.functional import all_gather

    return torch.cat(all_gather(t.contiguous(), group=ring.group), dim=1)


def domain_parallel(fn: Callable, ring, *, n_outputs: int = 1):
    """A spatial-domain program over whole grids: ``fn(ring, params,
    *tile_lists)`` receives each NHWC tensor as the local ranks' bands
    (:func:`split_tiles`) and returns a tile list (or ``n_outputs`` of
    them); the wrapper stitches each back into the whole grid
    (:func:`gather_tiles`). ``params`` pass as they are (replicated).
    The batch is not split: data parallelism is the trainer's."""

    def wrapped(params, *tensors):
        out = fn(ring, params, *(split_tiles(t, ring) for t in tensors))
        if n_outputs == 1:
            return gather_tiles(out, ring)
        return tuple(gather_tiles(o, ring) for o in out)

    return wrapped


def naive_split_conv2d(xs: Sequence[torch.Tensor],
                       kernel: torch.Tensor) -> Tiles:
    """The wrong way, kept as the control: each tile zero-pads its own
    borders (no halo), corrupting the ``kh // 2`` rows on both sides of
    every internal seam."""
    kh, kw = kernel.shape[2], kernel.shape[3]
    return [nhwc(conv2d(nchw(x), kernel, None, 1,
                        (kh // 2, kh // 2, kw // 2, kw // 2))) for x in xs]


__all__ = [
    "InProcessHalo", "ProcessGroupHalo", "domain_constrain",
    "domain_parallel", "gather_tiles", "halo_conv2d", "halo_exchange",
    "halo_upsample2x", "max_pool_2x2", "naive_split_conv2d",
    "spatial_pspec", "split_tiles",
]
