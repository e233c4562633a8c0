"""The reshard planner: decompose source->target redistribution into
memory-bounded steps.

Port of the JAX package's ``reshard/plan.py`` (arXiv:2112.01075's
decomposition). The planner is pure integer arithmetic over shapes and
shardings, so for the same shapes, specs and ``max_inflight_bytes`` it
gives the JAX plan's steps exactly: each step's kind, chunk axis and
offsets, modeled wire bytes, per-step HBM bound, and the executor's
stage grouping.

What a sharding is here. JAX names a ``NamedSharding`` (a ``Mesh`` of
devices plus a ``PartitionSpec``); the port has no device mesh object
inside one process, so :class:`Sharding` is the pair it keeps:

* a :class:`Mesh` -- axis names, axis sizes and the flat row-major
  list of its devices. A device is a **rank** of the process group
  (``Mesh.from_device_mesh`` / ``Mesh.of_ranks``: the elastic
  coordinator's meshes, the comm bench's) or a **torch device** in this
  process (``Mesh.of_device``: a serving tier). ``tier`` names the
  logical tier a device mesh stands for, so two tiers on one card are
  two devices to the planner -- the disaggregated engine's prefill and
  decode tiers may share a card and still hop their KV;
* a :class:`~tpu_hpc_torch.parallel.plans.P` spec over those axes.

A leaf's source sharding comes from the leaf: a :class:`TensorSpec`
carries one (plan before any byte exists, or describe a rank's local
shard), a DTensor has its mesh and placements, a CUDA tensor lies on
one device. A CPU tensor, a numpy array or a Python scalar is host data
(``None``, the ``place`` kind), as a numpy array is to the JAX engine.

Shards follow ``torch.chunk``: a dim of ``n`` split ``k`` ways gives
``ceil(n / k)`` rows a shard, the last ones shorter or empty -- the
layout FSDP2 uses for an uneven dim. On even splits (the only ones JAX
accepts) this is the JAX layout.

Execution lives in :mod:`tpu_hpc_torch.reshard.execute`;
``plan.execute`` binds the two and caches the target buffers and the
staging arena inside the plan, so a held plan replays with no new
allocation -- the port's reading of the JAX "zero recompiles" pin.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from tpu_hpc_torch.parallel.plans import P

# Step kinds, in "how much does this move" order:
#   noop     -- source placement already equivalent to the target.
#   local    -- placements differ but every target device already
#               holds the bytes it needs (replicated -> sharded: a
#               local slice, zero wire traffic).
#   gather   -- same mesh, target fully replicated: the full copy per
#               device IS the requested residency.
#   exchange -- same mesh, sharded -> sharded with real wire traffic
#               (the chunkable case).
#   transfer -- different meshes (elastic morphs, cross-tier KV moves),
#               chunked the same way.
#   place    -- source is host data: a straight copy onto the target.
STEP_KINDS = ("noop", "local", "gather", "exchange", "transfer", "place")
# The plan-cache keys that hold buffers (``compiled_program_count``);
# the rest (stage lists, piece tables) are bookkeeping.
CACHED_BUFFERS = ("target", "arena")


# ---------------------------------------------------------------------
# meshes and shardings
# ---------------------------------------------------------------------

def _device_name(device: Any) -> str:
    """A torch device as a canonical string (``cuda`` -> ``cuda:<n>``
    of the current card), so one card always compares equal."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return str(dev)


@dataclasses.dataclass(frozen=True)
class Mesh:
    """Named axes over a flat, row-major device list. Devices are ranks
    (ints) or torch device names (strings); ``tier`` tells two logical
    tiers on one card apart."""

    axis_names: Tuple[str, ...]
    shape: Tuple[int, ...]
    devices: Tuple[Any, ...]
    tier: Optional[str] = None

    def __post_init__(self):
        if len(self.axis_names) != len(self.shape):
            raise ValueError(
                f"mesh axes {self.axis_names} vs sizes {self.shape}")
        if math.prod(self.shape) != len(self.devices):
            raise ValueError(
                f"mesh of sizes {self.shape} over {len(self.devices)} "
                "device(s)")

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def axis_sizes(self) -> Dict[str, int]:
        """``{axis: size}`` in axis order (the JAX ``mesh.shape``)."""
        return dict(zip(self.axis_names, self.shape))

    @property
    def is_ranks(self) -> bool:
        return all(isinstance(d, int) for d in self.devices)

    def keys(self) -> Tuple[Tuple[Optional[str], Any], ...]:
        """The planner's device identities: (tier, device)."""
        return tuple((self.tier, d) for d in self.devices)

    @classmethod
    def of_device(cls, device: Any, tier: Optional[str] = None,
                  axes: Optional[Dict[str, int]] = None) -> "Mesh":
        """A one-device mesh on a torch device (a serving tier);
        ``axes`` names its (size-1) axes, default none."""
        axes = dict(axes or {})
        if math.prod(axes.values()) != 1:
            raise ValueError(f"a one-device mesh has size-1 axes: {axes}")
        return cls(tuple(axes), tuple(axes.values()),
                   (_device_name(device),), tier)

    @classmethod
    def of_ranks(cls, axes: Dict[str, int], ranks) -> "Mesh":
        """A mesh over process-group ranks, row-major."""
        return cls(tuple(axes), tuple(int(v) for v in axes.values()),
                   tuple(int(r) for r in ranks))

    @classmethod
    def from_device_mesh(cls, dm: Any) -> "Mesh":
        """A torch ``DeviceMesh`` -> its ranks under its axis names."""
        names = tuple(dm.mesh_dim_names or
                      (f"dim{i}" for i in range(dm.mesh.ndim)))
        return cls(names, tuple(int(s) for s in dm.mesh.shape),
                   tuple(int(r) for r in dm.mesh.flatten().tolist()))


def _entry_axes(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    if isinstance(entry, (tuple, list)):
        return tuple(entry)
    return (entry,)


@dataclasses.dataclass(frozen=True)
class Sharding:
    """A spec over a mesh: the port's ``NamedSharding``."""

    mesh: Mesh
    spec: P = P()

    def __post_init__(self):
        if not isinstance(self.spec, P):
            object.__setattr__(self, "spec", P(*self.spec))
        sizes = self.mesh.axis_sizes
        seen = set()
        for entry in self.spec:
            for ax in _entry_axes(entry):
                if ax not in sizes:
                    raise ValueError(
                        f"spec {self.spec} names axis {ax!r}, not in the "
                        f"mesh {tuple(sizes)}")
                if ax in seen:
                    raise ValueError(
                        f"spec {self.spec} uses axis {ax!r} twice")
                seen.add(ax)

    @property
    def is_fully_replicated(self) -> bool:
        sizes = self.mesh.axis_sizes
        return all(math.prod(sizes[a] for a in _entry_axes(e)) == 1
                   for e in self.spec)

    def devices_indices_map(self, shape) -> Dict[Any, Tuple[slice, ...]]:
        """``{device key: (slice per dim)}`` in the mesh's flat order --
        the JAX method's contract, shards split by ``torch.chunk``."""
        shape = tuple(int(s) for s in shape)
        if len(self.spec) > len(shape):
            raise ValueError(
                f"spec {self.spec} has more entries than the {len(shape)}"
                "-dim shape")
        names = self.mesh.axis_names
        sizes = self.mesh.shape
        out: Dict[Any, Tuple[slice, ...]] = {}
        for flat, key in enumerate(self.mesh.keys()):
            coord = dict(zip(names, np.unravel_index(flat, sizes))) \
                if sizes else {}
            idx = []
            for dim, n in enumerate(shape):
                axes = _entry_axes(self.spec[dim]) \
                    if dim < len(self.spec) else ()
                parts, part = 1, 0
                for ax in axes:
                    k = self.mesh.axis_sizes[ax]
                    part = part * k + int(coord[ax])
                    parts *= k
                if parts == 1:
                    idx.append(slice(None))
                    continue
                rows = -(-n // parts)
                lo = min(part * rows, n)
                idx.append(slice(lo, min(lo + rows, n)))
            out[key] = tuple(idx)
        return out

    def is_equivalent_to(self, other: "Sharding", ndim: int) -> bool:
        """Same devices in the same order, and the same shard on each
        (JAX's test: equal HLO shardings over equal device lists)."""
        if not isinstance(other, Sharding):
            return False
        if self.mesh.keys() != other.mesh.keys():
            return False
        if self.is_fully_replicated and other.is_fully_replicated:
            return True
        n = self.mesh.size * other.mesh.size
        probe = (n,) * ndim
        return (list(self.devices_indices_map(probe).values())
                == list(other.devices_indices_map(probe).values()))

    def __repr__(self) -> str:
        return f"Sharding({_describe_sharding(self)})"


@dataclasses.dataclass(frozen=True)
class TensorSpec:
    """A leaf before (or without) its bytes: shape, dtype and sharding
    -- the JAX ``ShapeDtypeStruct`` with a sharding."""

    shape: Tuple[int, ...]
    dtype: Any
    sharding: Optional[Sharding] = None


def sharding_of_dtensor(t: Any) -> Sharding:
    """A DTensor's layout as a :class:`Sharding`: its mesh's ranks, and
    ``Shard(d)`` on mesh dim i named into spec entry d (Replicate and
    Partial leave the dim whole)."""
    from torch.distributed.tensor import Shard

    mesh = Mesh.from_device_mesh(t.device_mesh)
    entries: List[Any] = [None] * t.ndim
    for name, pl in zip(mesh.axis_names, t.placements):
        if isinstance(pl, Shard):
            d = pl.dim % t.ndim
            cur = _entry_axes(entries[d])
            entries[d] = name if not cur else (*cur, name)
    while entries and entries[-1] is None:
        entries.pop()
    return Sharding(mesh, P(*entries))


def leaf_sharding(leaf: Any) -> Optional[Sharding]:
    """The source sharding of a leaf (None: host data, the ``place``
    kind)."""
    if isinstance(leaf, TensorSpec):
        return leaf.sharding
    from tpu_hpc_torch.parallel.shard import is_dtensor

    if isinstance(leaf, torch.Tensor):
        if is_dtensor(leaf):
            return sharding_of_dtensor(leaf)
        if leaf.device.type == "cpu":
            return None
        return Sharding(Mesh.of_device(leaf.device))
    return None


# ---------------------------------------------------------------------
# the exact wire model
# ---------------------------------------------------------------------

def _norm_index(idx, shape) -> Tuple[Tuple[int, int], ...]:
    """A devices_indices_map entry -> ((start, stop), ...) per dim."""
    out = []
    for sl, dim in zip(idx, shape):
        start = 0 if sl.start is None else int(sl.start)
        stop = dim if sl.stop is None else int(sl.stop)
        out.append((start, stop))
    return tuple(out)


def _vol(box: Tuple[Tuple[int, int], ...]) -> int:
    return math.prod(hi - lo for lo, hi in box)


def _intersect_vol(a, b) -> int:
    v = 1
    for (alo, ahi), (blo, bhi) in zip(a, b):
        d = min(ahi, bhi) - max(alo, blo)
        if d <= 0:
            return 0
        v *= d
    return v


def _intersect(a, b) -> Optional[Tuple[Tuple[int, int], ...]]:
    """The box both ``a`` and ``b`` cover, or None."""
    out = []
    for (alo, ahi), (blo, bhi) in zip(a, b):
        lo, hi = max(alo, blo), min(ahi, bhi)
        if hi <= lo:
            return None
        out.append((lo, hi))
    return tuple(out)


def boxes(sharding: Sharding, shape) -> Dict[Any, Tuple[Tuple[int, int], ...]]:
    """``{device key: box}`` of ``sharding`` over ``shape``."""
    return {k: _norm_index(idx, shape)
            for k, idx in sharding.devices_indices_map(shape).items()}


def modeled_wire_bytes(
    shape: Tuple[int, ...], itemsize: int, src, tgt
) -> int:
    """Exact wire model: bytes that must arrive over links, summed per
    target device as (bytes the device needs) - (bytes of that region
    already resident on it)."""
    smap = boxes(src, shape)
    wire = 0
    for d, box in boxes(tgt, shape).items():
        need = _vol(box)
        have = smap.get(d)
        avail = _intersect_vol(have, box) if have is not None else 0
        wire += (need - avail) * itemsize
    return wire


def _spec_without_axis(spec: P, ax: int) -> P:
    """The chunk spec: ``spec`` with dim ``ax`` unsharded (chunks keep
    the layout on every other dim and stay whole along the chunk
    axis)."""
    entries = list(spec) if spec is not None else []
    while len(entries) <= ax:
        entries.append(None)
    entries[ax] = None
    while entries and entries[-1] is None:
        entries.pop()
    return P(*entries)


@dataclasses.dataclass(frozen=True)
class ChunkPlan:
    """Decomposition of one leaf move along ``axis`` into ``count``
    slices of at most ``size`` rows each."""

    axis: int
    size: int
    count: int


@dataclasses.dataclass(frozen=True)
class ReshardStep:
    """One leaf's move. The summary fields describe the step; the
    shardings (repr-suppressed) are what the executor moves by."""

    path: str
    kind: str
    shape: Tuple[int, ...]
    dtype: str
    bytes: int                 # global leaf bytes
    wire_bytes: int            # modeled bytes received over links
    inflight_bytes: int        # modeled peak transient per device
    resident_bytes: int        # largest per-device target residency
    src_resident_bytes: int    # largest per-device source residency
    same_mesh: bool
    chunk: Optional[ChunkPlan]
    bound_met: bool
    src_desc: str
    tgt_desc: str
    src_sharding: Any = dataclasses.field(repr=False, compare=False)
    tgt_sharding: Any = dataclasses.field(repr=False, compare=False)
    # The dtype the target is written in (a move and a cast in one
    # copy); None keeps the source dtype. Not part of the JAX record.
    tgt_dtype: Any = dataclasses.field(default=None, repr=False,
                                       compare=False)

    def summary(self) -> dict:
        """JSON-safe step record (what the obs event carries)."""
        rec = {
            "path": self.path,
            "kind": self.kind,
            "bytes": self.bytes,
            "wire_bytes": self.wire_bytes,
            "inflight_bytes": self.inflight_bytes,
        }
        if self.chunk is not None:
            rec["chunks"] = self.chunk.count
        return rec

    @property
    def hbm_bound_bytes(self) -> int:
        """The modeled per-device memory ceiling for this step: the
        larger of the required residencies (source shard, target
        shard) and the allowed transient."""
        return max(
            self.inflight_bytes,
            self.resident_bytes,
            self.src_resident_bytes,
        )


def _describe_sharding(s) -> str:
    if s is None:
        return "host"
    mesh = s.mesh
    shape = ",".join(f"{k}={v}" for k, v in mesh.axis_sizes.items())
    where = f"{mesh.tier}@" if mesh.tier else ""
    devs = ",".join(str(d) for d in mesh.devices)
    return f"[{shape}] {where}{devs} {s.spec}"


def _chunk_offsets(extent: int, size: int) -> List[Tuple[int, int]]:
    return [(a, min(a + size, extent)) for a in range(0, extent, size)]


def _plan_chunks(
    shape: Tuple[int, ...], itemsize: int, max_inflight: int
) -> Tuple[Optional[ChunkPlan], bool]:
    """Pick a chunk axis and size so one chunk's bytes fit the bound:
    the axis needing the fewest chunks; an unchunkable leaf falls back
    to the finest split of the largest dim with bound_met=False."""
    nbytes = math.prod(shape) * itemsize
    if nbytes <= max_inflight:
        return None, True
    best: Optional[ChunkPlan] = None
    for ax in sorted(range(len(shape)), key=lambda a: -shape[a]):
        if shape[ax] < 2:
            continue
        row_bytes = nbytes // shape[ax]
        rows = max(1, max_inflight // max(row_bytes, 1))
        if rows >= shape[ax]:
            continue  # one chunk = whole leaf: no help on this axis
        count = -(-shape[ax] // rows)
        cand = ChunkPlan(axis=ax, size=rows, count=count)
        if row_bytes * rows <= max_inflight:
            return cand, True
        if best is None:
            best = cand  # finest split of the largest dim
    if best is not None:
        return best, False
    return None, False  # nothing to chunk along (scalar-ish leaf)


def dtype_name(dtype: Any) -> str:
    """``float32``, ``bfloat16``, ``int8`` ... for a torch or numpy
    dtype (numpy's spelling, as the JAX plan records it)."""
    if isinstance(dtype, torch.dtype):
        return str(dtype).replace("torch.", "")
    return str(np.dtype(dtype))


def itemsize_of(dtype: Any) -> int:
    if isinstance(dtype, torch.dtype):
        return dtype.itemsize
    if str(dtype) == "bfloat16":
        return 2
    return np.dtype(dtype).itemsize


def plan_step(
    path: str,
    shape: Tuple[int, ...],
    dtype,
    src,
    tgt,
    max_inflight_bytes: Optional[int] = None,
    tgt_dtype: Any = None,
) -> ReshardStep:
    """Classify and (if needed) decompose one leaf's move."""
    itemsize = itemsize_of(dtype)
    nbytes = math.prod(shape) * itemsize
    ndim = len(shape)
    resident = max(
        (_vol(b) * itemsize for b in boxes(tgt, shape).values()),
        default=nbytes,
    )
    src_resident = 0 if src is None else max(
        (_vol(b) * itemsize for b in boxes(src, shape).values()),
        default=nbytes,
    )

    def build(kind, wire, inflight, chunk=None, bound_met=True):
        return ReshardStep(
            path=path, kind=kind, shape=tuple(shape),
            dtype=dtype_name(dtype), bytes=nbytes,
            wire_bytes=wire, inflight_bytes=inflight,
            resident_bytes=resident,
            src_resident_bytes=src_resident,
            same_mesh=src is not None and src.mesh == tgt.mesh,
            chunk=chunk, bound_met=bound_met,
            src_desc=_describe_sharding(src),
            tgt_desc=_describe_sharding(tgt),
            src_sharding=src, tgt_sharding=tgt, tgt_dtype=tgt_dtype,
        )

    if src is None:
        # Host data: the device side only ever holds its target shard.
        return build("place", wire=nbytes, inflight=0)
    if src.is_equivalent_to(tgt, ndim):
        return build("noop", wire=0, inflight=0)
    wire = modeled_wire_bytes(shape, itemsize, src, tgt)
    same_mesh = src.mesh == tgt.mesh
    if wire == 0:
        return build("local", wire=0, inflight=0)
    if same_mesh and tgt.is_fully_replicated:
        return build("gather", wire=wire, inflight=0)
    kind = "exchange" if same_mesh else "transfer"
    # Conservative transient: the whole leaf, unless the bound forces
    # the chunked decomposition.
    if max_inflight_bytes is None or nbytes <= max_inflight_bytes:
        return build(kind, wire=wire, inflight=nbytes)
    chunk, bound_met = _plan_chunks(shape, itemsize, max_inflight_bytes)
    if chunk is None:
        return build(kind, wire=wire, inflight=nbytes, bound_met=False)
    inflight = min(nbytes, chunk.size * (nbytes // shape[chunk.axis]))
    return build(
        kind, wire=wire, inflight=inflight, chunk=chunk,
        bound_met=bound_met,
    )


# ---------------------------------------------------------------------
# pytrees (nested dicts / lists / tuples / dataclasses)
# ---------------------------------------------------------------------

def _is_leaf(node) -> bool:
    return isinstance(node, (torch.Tensor, np.ndarray, TensorSpec,
                             Sharding, torch.device, torch.dtype, str,
                             int, float, np.generic))


def _children(node):
    """(kind, keys, children) of an inner node; dict keys sorted, as
    JAX flattens them."""
    if isinstance(node, dict):
        keys = sorted(node)
        return ("dict", tuple(keys), [node[k] for k in keys])
    if dataclasses.is_dataclass(node) and not isinstance(node, type):
        keys = tuple(f.name for f in dataclasses.fields(node))
        return (type(node), keys, [getattr(node, k) for k in keys])
    if isinstance(node, tuple) and hasattr(node, "_fields"):
        return (type(node), tuple(node._fields), list(node))
    if isinstance(node, (list, tuple)):
        return (type(node), tuple(range(len(node))), list(node))
    raise TypeError(f"not a tree node: {type(node).__name__}")


def _walk(node, prefix: str, none_is_leaf: bool, leaves: list):
    """One level of :func:`tree_flatten_with_path` (module level: a
    recursive closure would be a reference cycle holding the leaves
    until the collector runs)."""
    if node is None and not none_is_leaf:
        return ("none",)
    if node is None or _is_leaf(node):
        leaves.append((prefix, node))
        return ("leaf",)
    kind, keys, kids = _children(node)
    subs = tuple(
        _walk(kid, f"{prefix}/{k}" if prefix else str(k), none_is_leaf,
              leaves)
        for k, kid in zip(keys, kids))
    return (kind, keys, subs)


def tree_flatten_with_path(
    tree, none_is_leaf: bool = False,
) -> Tuple[List[Tuple[str, Any]], Any]:
    """``([(path, leaf), ...], treedef)``; paths are '/'-joined keys
    (the JAX ``_path_str``). None is an empty subtree, as in JAX, or
    with ``none_is_leaf`` a leaf (a rank that holds no shard of it)."""
    leaves: List[Tuple[str, Any]] = []
    treedef = _walk(tree, "", none_is_leaf, leaves)
    return leaves, treedef


def _build(td, it):
    if td[0] == "none":
        return None
    if td[0] == "leaf":
        return next(it)
    kind, keys, subs = td
    vals = [_build(sub, it) for sub in subs]
    if kind == "dict":
        return dict(zip(keys, vals))
    if dataclasses.is_dataclass(kind):
        return kind(**dict(zip(keys, vals)))
    if hasattr(kind, "_fields"):
        return kind(*vals)
    return kind(vals)


def tree_unflatten(treedef, leaves: List[Any]) -> Any:
    return _build(treedef, iter(leaves))


def _leaf_shape_dtype(leaf) -> Tuple[Tuple[int, ...], Any]:
    if isinstance(leaf, TensorSpec):
        return tuple(leaf.shape), leaf.dtype
    if isinstance(leaf, torch.Tensor):
        return tuple(leaf.shape), leaf.dtype  # a DTensor's: global
    if isinstance(leaf, np.ndarray):
        return tuple(leaf.shape), leaf.dtype
    return (), np.asarray(leaf).dtype


@dataclasses.dataclass
class ReshardPlan:
    """An ordered, introspectable redistribution: one step per leaf.

    Aggregates (``wire_bytes``, ``peak_inflight_bytes``) are modeled
    BEFORE execution. ``execute`` (reshard/execute.py) materializes the
    target tree; its target buffers and staging arena are cached inside
    the plan, so a held plan replays with no new allocation -- and a
    replay writes into the previous replay's outputs, which the caller
    consumes first (the disaggregated hop scatters them into its cache
    at once).
    """

    steps: List[ReshardStep]
    treedef: Any
    max_inflight_bytes: Optional[int] = None
    label: Optional[str] = None
    # "planner" when max_inflight_bytes="auto" resolved through the
    # collective planner's cost model (comm/planner.py).
    inflight_source: Optional[str] = None
    # Planner-predicted wall time of the whole move (auto plans only).
    predicted_cost_s: Optional[float] = None
    _programs: Dict[Any, Any] = dataclasses.field(
        default_factory=dict, repr=False
    )

    # -- modeled aggregates -------------------------------------------
    @property
    def bytes(self) -> int:
        return sum(s.bytes for s in self.steps)

    @property
    def wire_bytes(self) -> int:
        return sum(s.wire_bytes for s in self.steps)

    @property
    def peak_inflight_bytes(self) -> int:
        return max((s.inflight_bytes for s in self.steps), default=0)

    @property
    def chunked_steps(self) -> int:
        return sum(1 for s in self.steps if s.chunk is not None)

    @property
    def bound_met(self) -> bool:
        return all(s.bound_met for s in self.steps)

    @property
    def compiled_program_count(self) -> int:
        """Buffers cached on this plan (targets and staging arenas) --
        the number the no-new-allocation guards count, as the JAX plan
        counts its compiled programs. The stage lists and piece tables
        are bookkeeping and are not counted."""
        return sum(1 for k in self._programs if k[0] in CACHED_BUFFERS)

    def counts(self) -> Dict[str, int]:
        out: Dict[str, int] = {}
        for s in self.steps:
            out[s.kind] = out.get(s.kind, 0) + 1
        return out

    def summary(self) -> dict:
        """JSON-safe plan record (the ``reshard_plan`` obs event)."""
        rec = {
            "steps": len(self.steps),
            "bytes": self.bytes,
            "wire_bytes": self.wire_bytes,
            "peak_inflight_bytes": self.peak_inflight_bytes,
            "chunked_steps": self.chunked_steps,
            "max_inflight_bytes": self.max_inflight_bytes,
            "bound_met": self.bound_met,
            "kinds": self.counts(),
        }
        if self.inflight_source is not None:
            rec["inflight_source"] = self.inflight_source
        if self.predicted_cost_s is not None:
            rec["predicted_cost_ms"] = round(
                self.predicted_cost_s * 1e3, 6
            )
        return rec

    def describe(self) -> str:
        """Human-readable step table."""
        lines = [
            f"reshard plan: {len(self.steps)} step(s), "
            f"{self.bytes} B total, {self.wire_bytes} B wire, "
            f"peak inflight {self.peak_inflight_bytes} B"
            + (
                f" (bound {self.max_inflight_bytes} B"
                + ("" if self.bound_met else ", NOT met")
                + ")"
                if self.max_inflight_bytes is not None else ""
            ),
            f"{'kind':9} {'bytes':>12} {'wire':>12} {'inflight':>12} "
            f"{'chunks':>6}  path: src -> tgt",
        ]
        for s in self.steps:
            lines.append(
                f"{s.kind:9} {s.bytes:>12} {s.wire_bytes:>12} "
                f"{s.inflight_bytes:>12} "
                f"{s.chunk.count if s.chunk else 1:>6}  "
                f"{s.path}: {s.src_desc} -> {s.tgt_desc}"
            )
        return "\n".join(lines)

    def peak_device_bytes(self, device: Any) -> int:
        """Modeled rise in memory on one device over a first execution:
        every target shard that lands on it (the cached outputs) plus
        the largest stage transient. A held plan's replay allocates
        nothing."""
        from tpu_hpc_torch.reshard import execute as _exec

        return _exec.modeled_device_bytes(self, device)

    def execute(self, tree, donate: bool = False, copy_noop: bool = False,
                sink=None, device=None):
        """Run the plan on ``tree`` (must match the planned leaves);
        returns the tree in the target placement. See
        :func:`tpu_hpc_torch.reshard.execute.execute_plan`."""
        from tpu_hpc_torch.reshard import execute as _exec

        return _exec.execute_plan(
            self, tree, donate=donate, copy_noop=copy_noop, sink=sink,
            device=device,
        )


def _planner_for_steps(steps: List[ReshardStep]):
    """The collective planner over the device set this plan touches
    (the union of source and target meshes)."""
    from tpu_hpc_torch.comm.planner import Planner

    devs, kinds = set(), set()
    for s in steps:
        for sh in (s.src_sharding, s.tgt_sharding):
            if sh is None:
                continue
            devs.update(sh.mesh.keys())
            kinds.update("cpu" if str(d).startswith("cpu") else
                         "cuda" if isinstance(d, str) else None
                         for d in sh.mesh.devices)
    kinds.discard(None)
    device_type = kinds.pop() if len(kinds) == 1 else None
    return Planner.for_devices(n_devices=max(len(devs), 1), slices=1,
                               device_type=device_type)


def _predict_cost(steps: List[ReshardStep], planner) -> float:
    """Modeled wall time of the plan: per-step (and per-chunk) launch
    latency plus wire bytes over the fabric tier."""
    from tpu_hpc_torch.comm.planner import tier_cost

    total = 0.0
    tier = "dcn" if planner.fingerprint.n_slices > 1 else "ici"
    for s in steps:
        if s.wire_bytes <= 0:
            continue
        chunks = s.chunk.count if s.chunk else 1
        total += chunks * tier_cost(tier, s.wire_bytes / chunks)
    return total


def _as_sharding(t) -> Sharding:
    """A target: a Sharding, or a torch device (a one-device mesh)."""
    if isinstance(t, Sharding):
        return t
    if isinstance(t, (torch.device, str)):
        return Sharding(Mesh.of_device(t))
    raise TypeError(f"not a target sharding: {type(t).__name__}")


def plan_reshard(
    tree: Any,
    targets: Any,
    *,
    max_inflight_bytes: "Optional[int | str]" = None,
    label: Optional[str] = None,
    dtypes: Any = None,
) -> ReshardPlan:
    """Plan a source->target redistribution for a whole tree.

    ``tree`` may hold tensors, DTensors, numpy arrays, scalars or
    :class:`TensorSpec` leaves. ``targets`` is a matching tree of
    :class:`Sharding` (or torch device) leaves, or one for every leaf.
    ``max_inflight_bytes`` bounds the modeled per-device transient of
    every step: a leaf whose conservative move exceeds it becomes a
    chunked slice->move->write step. ``"auto"`` asks the collective
    planner for the bound (the chunk that amortizes the fabric's launch
    latency); the plan then records ``inflight_source="planner"`` and
    the predicted wall time. ``dtypes`` (port only): a matching tree of
    torch dtypes (or one for every leaf, or None) the targets are
    written in -- a move and a cast in one copy.
    """
    flat, treedef = tree_flatten_with_path(tree)
    if isinstance(targets, (Sharding, torch.device, str)):
        tgt_flat = [_as_sharding(targets)] * len(flat)
    else:
        tgt_leaves, tgt_def = tree_flatten_with_path(targets)
        if tgt_def != treedef:
            raise ValueError(
                "target sharding tree structure does not match the "
                "input tree"
            )
        tgt_flat = [_as_sharding(t) for _, t in tgt_leaves]
    if dtypes is None or isinstance(dtypes, torch.dtype):
        dt_flat = [dtypes] * len(flat)
    else:
        dt_flat = [d for _, d in tree_flatten_with_path(dtypes)[0]]

    def build_steps(bound: Optional[int]) -> List[ReshardStep]:
        steps = []
        for (path, leaf), tgt, dt in zip(flat, tgt_flat, dt_flat):
            shape, dtype = _leaf_shape_dtype(leaf)
            steps.append(plan_step(
                path, shape, dtype, leaf_sharding(leaf), tgt,
                max_inflight_bytes=bound, tgt_dtype=dt,
            ))
        return steps

    inflight_source = None
    predicted = None
    if max_inflight_bytes == "auto":
        # Classify unbounded first (kinds and wire bytes do not depend
        # on the bound), ask the planner for the chunk that amortizes
        # the tier's launch latency, then re-plan under it.
        steps0 = build_steps(None)
        planner = _planner_for_steps(steps0)
        movers = [s for s in steps0 if s.wire_bytes > 0]
        if movers:
            max_inflight_bytes = planner.chunk_bytes(
                max(s.bytes for s in movers)
            )
        else:
            max_inflight_bytes = None  # nothing moves: no bound needed
        inflight_source = "planner"
        steps = build_steps(max_inflight_bytes)
        predicted = _predict_cost(steps, planner)
    else:
        if max_inflight_bytes is not None and not hasattr(
            max_inflight_bytes, "__index__"
        ):
            raise TypeError(
                f"max_inflight_bytes must be an int, None, or "
                f"'auto'; got {max_inflight_bytes!r}"
            )
        steps = build_steps(max_inflight_bytes)
    return ReshardPlan(
        steps=steps, treedef=treedef,
        max_inflight_bytes=max_inflight_bytes, label=label,
        inflight_source=inflight_source, predicted_cost_s=predicted,
    )
