"""Device-mesh construction: named axes over the job's processes.

Port of the JAX package's ``runtime/mesh.py``. ``MeshSpec`` names the
axes once; :func:`build_mesh` turns it into a
``torch.distributed.device_mesh.DeviceMesh`` (one process per card).
Earlier axes change slowest across the ranks, so the bandwidth-tolerant
axis (``data``) goes first and the latency-sensitive one (``model``)
last: with ranks numbered node by node, TP then stays inside a node on
NVLink and FSDP crosses nodes (the reference's
``fsdp_tp_example.py:12-26`` doctrine). Sequence parallelism takes a
(data, context) mesh: ``context`` splits each sequence over its ranks
(``parallel.ring_attention``, ``parallel.sp_ulysses``); it is not the
Megatron SP that the hybrid plan runs on ``model``.

``dcn_axes`` keeps the JAX meaning -- the extent of an axis across
nodes (there: TPU slices). :func:`build_mesh` hands a spec with
``dcn_axes`` to :func:`build_hybrid_mesh`: the node groups
(:func:`node_groups`, ranks that share a host, the counterpart of the
JAX ``slice_groups``) give the across-node component, which varies
slowest on each axis, so the inner component stays on one node's
NVLink. :func:`two_tier_spec` is the one construction policy for a
two-tier (dcn x inner) data mesh, as in the JAX package.
"""
from __future__ import annotations

import dataclasses
import math
import socket
from typing import Any, List, Mapping, Optional, Tuple

# Canonical axis names used by the recipes.
DATA_AXIS = "data"
FSDP_AXIS = "fsdp"
MODEL_AXIS = "model"
CONTEXT_AXIS = "context"
SEQ_AXIS = "seq"
PIPE_AXIS = "pipe"


@dataclasses.dataclass(frozen=True)
class MeshSpec:
    """Declarative mesh shape: ordered ``{axis_name: size}``. A size of
    -1 means "all remaining devices" (at most one axis may use it).
    ``dcn_axes`` gives an axis's extent across nodes: the built axis
    has size ``axes[k] * dcn_axes[k]``, the across-node part varying
    slowest."""

    axes: Mapping[str, int]
    dcn_axes: Mapping[str, int] = dataclasses.field(default_factory=dict)

    def __post_init__(self):
        unknown = [k for k in self.dcn_axes if k not in self.axes]
        if unknown:
            raise ValueError(
                f"dcn_axes {unknown} not present in axes "
                f"{tuple(self.axes)}; give each DCN axis an ICI extent "
                f"(use 1 for a pure cross-slice axis)"
            )
        bad = {k: v for k, v in self.dcn_axes.items() if v < 1}
        if bad:
            raise ValueError(f"dcn_axes sizes must be >= 1, got {bad}")

    @property
    def num_slices(self) -> int:
        return math.prod(self.dcn_axes.values()) if self.dcn_axes else 1

    def resolved_sizes(self, n_devices: int) -> "dict[str, int]":
        """Full (within-node x across-node) axis sizes for
        ``n_devices`` total devices."""
        sizes = dict(self.axes)
        wild = [k for k, v in sizes.items() if v == -1]
        if len(wild) > 1:
            raise ValueError(f"at most one -1 axis allowed, got {wild}")
        dcn_total = self.num_slices
        if n_devices % dcn_total != 0:
            raise ValueError(
                f"{n_devices} devices not divisible by "
                f"{dcn_total} slices (dcn_axes={dict(self.dcn_axes)})"
            )
        per_slice = n_devices // dcn_total
        fixed = math.prod(v for v in sizes.values() if v != -1)
        if wild:
            if per_slice % fixed != 0:
                raise ValueError(
                    f"{per_slice} per-slice devices not divisible by "
                    f"fixed axes {fixed}"
                )
            sizes[wild[0]] = per_slice // fixed
        return {
            k: v * self.dcn_axes.get(k, 1) for k, v in sizes.items()
        }

    def ici_sizes(self, n_devices: int) -> "dict[str, int]":
        """Per-node axis sizes."""
        full = self.resolved_sizes(n_devices)
        return {k: v // self.dcn_axes.get(k, 1) for k, v in full.items()}

    @property
    def axis_names(self) -> Tuple[str, ...]:
        return tuple(self.axes.keys())


def build_mesh(spec: MeshSpec, device_type: str = "cuda",
               world_size: Optional[int] = None):
    """A ``DeviceMesh`` over the whole job (``torch.distributed`` must
    be up, or ``init_device_mesh`` brings it up from the environment).
    A mesh that leaves processes idle is refused, as the JAX package
    refuses a whole-job mesh that leaves chips idle. A spec with
    ``dcn_axes`` goes to :func:`build_hybrid_mesh`."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    if world_size is None:
        world_size = dist.get_world_size() if dist.is_initialized() else 1
    sizes = spec.resolved_sizes(world_size)
    total = math.prod(sizes.values())
    if total != world_size:
        raise ValueError(
            f"mesh {sizes} uses {total} of {world_size} processes; the "
            "mesh must cover the job (add a -1 wildcard axis)"
        )
    if spec.dcn_axes:
        return build_hybrid_mesh(spec, device_type, world_size)
    return init_device_mesh(device_type, tuple(sizes.values()),
                            mesh_dim_names=tuple(sizes.keys()))


_NODE_GROUPS: dict = {}


def node_groups(group: Any = None) -> List[List[int]]:
    """The job's ranks grouped by host: ranks on one host form one
    group, ordered by rank, and the groups are ordered by their first
    rank -- the JAX ``slice_groups``, with a node in the place of a TPU
    slice. Each rank's host name is gathered once per process group (a
    collective the first time); with no process group up, one group of
    rank 0."""
    import torch.distributed as dist

    if not dist.is_initialized():
        return [[0]]
    pg = group if group is not None else dist.distributed_c10d._get_default_group()
    key = (id(pg), dist.get_world_size(group))
    if key not in _NODE_GROUPS:
        names: List[Optional[str]] = [None] * dist.get_world_size(group)
        dist.all_gather_object(names, socket.gethostname(), group=group)
        by_host: "dict[str, list[int]]" = {}
        for rank, host in enumerate(names):
            by_host.setdefault(host, []).append(rank)
        _NODE_GROUPS[key] = sorted(by_host.values(), key=lambda g: g[0])
    return [list(g) for g in _NODE_GROUPS[key]]


def hybrid_rank_grid(spec: MeshSpec, groups: List[List[int]]):
    """The ranks of a two-tier mesh as a numpy array of the spec's full
    axis sizes: ``groups`` (one list of ranks a node, ``num_slices`` of
    equal size) stacked into the across-node dims, each laid out in the
    per-node shape, then interleaved so every named axis factors as
    (dcn, inner) with dcn slowest -- the JAX ``build_hybrid_mesh``'s
    arrangement (index = dcn_i * inner_k + inner_i)."""
    import numpy as np

    names = spec.axis_names
    n = sum(len(g) for g in groups)
    full = spec.resolved_sizes(n)
    ici_shape = tuple(spec.ici_sizes(n)[k] for k in names)
    dcn_shape = tuple(spec.dcn_axes.get(k, 1) for k in names)
    arr = np.empty(dcn_shape + ici_shape, dtype=np.int64)
    for si, g in enumerate(groups):
        arr[np.unravel_index(si, dcn_shape)] = np.asarray(g).reshape(ici_shape)
    k = len(names)
    perm = [x for i in range(k) for x in (i, k + i)]
    return arr.transpose(perm).reshape(tuple(full[k_] for k_ in names))


def build_hybrid_mesh(spec: MeshSpec, device_type: str = "cuda",
                      world_size: Optional[int] = None):
    """Hybrid (inner x across-node) mesh: the DCN component of every
    axis varies slowest.

    On cards the node partition comes from the ranks' hosts
    (:func:`node_groups`); a ``dcn_axes`` request against another node
    count, or uneven nodes, raises with the JAX package's words. A gloo
    world on the CPU carries no node identity (its processes share one
    host by construction), so its nodes are emulated as equal contiguous
    chunks of the ranks, as the JAX CPU branch emulates slices -- the
    two-phase collectives then run and parity-check without a
    cluster."""
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    if world_size is None:
        world_size = dist.get_world_size() if dist.is_initialized() else 1
    n_slices = spec.num_slices
    per_slice = world_size // n_slices
    if torch.device(device_type).type == "cuda":
        groups = node_groups()
        if len(groups) != n_slices:
            raise ValueError(
                f"spec wants {n_slices} slices (dcn_axes="
                f"{dict(spec.dcn_axes)}) but the devices span "
                f"{len(groups)} physical slice(s)"
            )
        sizes = {len(g) for g in groups}
        if sizes != {per_slice}:
            raise ValueError(
                f"uneven slices: sizes {sorted(sizes)}, need "
                f"{per_slice} devices in each of {n_slices} slices"
            )
    else:
        groups = [list(range(i * per_slice, (i + 1) * per_slice))
                  for i in range(n_slices)]
    grid = hybrid_rank_grid(spec, groups)
    return DeviceMesh(device_type, torch.as_tensor(grid),
                      mesh_dim_names=spec.axis_names)


def two_tier_spec(
    n_dev: int,
    n_slices: int,
    dcn: Optional[int] = None,
    inner_axis: str = "ici",
    dcn_axis: str = "dcn",
) -> MeshSpec:
    """Spec for a two-tier (dcn x inner) data mesh -- THE construction
    policy for everything that runs the hierarchical collectives
    (``comm.hierarchical``), shared by the train CLI's ``--comm-mode``
    path and ``comm.bench``, as in the JAX package.

    ``dcn=None`` resolves to the node count when there is more than one
    node, else an emulated 2 (one node: the decomposition still runs
    and parity-checks; the inter-node win needs real nodes). Across
    real nodes the dcn axis is declared via ``dcn_axes`` so
    :func:`build_hybrid_mesh` partitions it by node. Topologies that
    cannot split into dcn x (inner >= 2) raise -- measuring something
    else while claiming "hierarchical" would poison any sweep built on
    the result.
    """
    if dcn is None:
        dcn = n_slices if n_slices > 1 else 2
    if dcn < 2 or n_dev % dcn or n_dev // dcn < 2:
        raise ValueError(
            f"no two-tier ({dcn_axis} x {inner_axis}>=2) mesh from "
            f"{n_dev} device(s) with {dcn_axis}={dcn} across "
            f"{n_slices} physical slice(s)"
        )
    if n_slices > 1:
        return MeshSpec(
            axes={dcn_axis: 1, inner_axis: n_dev // dcn},
            dcn_axes={dcn_axis: dcn},
        )
    return MeshSpec(axes={dcn_axis: dcn, inner_axis: n_dev // dcn})


def mesh_shape(mesh: Any) -> "dict[str, int]":
    """``{axis: size}`` of a ``DeviceMesh`` or of a plain mapping;
    None is one device with no axes."""
    if mesh is None:
        return {}
    if isinstance(mesh, Mapping):
        return {k: int(v) for k, v in mesh.items()}
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def local_batch_size(global_batch: int, mesh: Any, axis: str = DATA_AXIS) -> int:
    """Per-data-shard batch size, validating divisibility."""
    n = mesh_axis_size(mesh, axis)
    if global_batch % n != 0:
        raise ValueError(f"global batch {global_batch} not divisible by {axis}={n}")
    return global_batch // n


def mesh_axis_size(mesh: Any, axis: Optional[str]) -> int:
    """Size of ``axis`` (1 for None, or for an axis the mesh lacks)."""
    if axis is None:
        return 1
    return mesh_shape(mesh).get(axis, 1)


_MESH_GROUPS: dict = {}


def register_mesh_group(ranks, group: Any) -> None:
    """Record ``group`` as the process group over ``ranks`` (made by
    ``dist.new_group`` on every rank, where all of them can call it),
    for :func:`mesh_group` to find."""
    _MESH_GROUPS[tuple(int(r) for r in ranks)] = group


def mesh_group(mesh: Any) -> Any:
    """The process group over a ``DeviceMesh``'s ranks: None when the
    mesh spans the whole job (the default group) or there is no mesh;
    the mesh's own group when it is 1-D; else the group registered for
    its ranks (:func:`register_mesh_group`)."""
    import torch.distributed as dist

    if mesh is None or not dist.is_initialized():
        return None
    ranks = tuple(int(r) for r in mesh.mesh.flatten().tolist())
    if len(ranks) == dist.get_world_size():
        return None
    if mesh.mesh.ndim == 1:
        return mesh.get_group()
    if ranks in _MESH_GROUPS:
        return _MESH_GROUPS[ranks]
    raise ValueError(
        f"a {mesh.mesh.ndim}-D mesh over ranks {list(ranks)} of "
        f"{dist.get_world_size()}: register the process group over its "
        "ranks first (runtime.mesh.register_mesh_group)")
