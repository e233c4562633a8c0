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
nodes (there: TPU slices) -- for ``resolved_sizes`` and ``ici_sizes``;
building a two-tier mesh from it is not ported yet (ROADMAP queue 1
item 1).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Mapping, Optional, Tuple

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
    refuses a whole-job mesh that leaves chips idle."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    if spec.dcn_axes:
        raise NotImplementedError(
            "a two-tier (dcn_axes) mesh is not ported yet (ROADMAP queue "
            "1 item 1); give the flat axes instead"
        )
    if world_size is None:
        world_size = dist.get_world_size() if dist.is_initialized() else 1
    sizes = spec.resolved_sizes(world_size)
    total = math.prod(sizes.values())
    if total != world_size:
        raise ValueError(
            f"mesh {sizes} uses {total} of {world_size} processes; the "
            "mesh must cover the job (add a -1 wildcard axis)"
        )
    return init_device_mesh(device_type, tuple(sizes.values()),
                            mesh_dim_names=tuple(sizes.keys()))


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
