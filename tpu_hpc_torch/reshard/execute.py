"""The reshard executor: run a :class:`~tpu_hpc_torch.reshard.plan.ReshardPlan`.

Port of the JAX package's ``reshard/execute.py``. The stages are the
JAX executor's, grouped by the same rule (``_stages``): noop
passthroughs, one stage per chunked step, packed same-mesh groups and
packed cross-mesh groups, each pack bounded by ``max_inflight_bytes``
over the summed conservative transients. What carries the bytes is
PyTorch's, in two transports:

* **in process** -- both ends lie in this process: a torch device (a
  serving tier, ``place_params``), host data, or a one-rank mesh of
  this rank. The target is preallocated on its device; a chunked step
  copies each chunk ``source.narrow(...)`` into the matching view of the
  target with ``copy_(non_blocking=True)``, so no chunk ever needs a
  buffer of its own.
* **across ranks** -- a mesh of several ranks (the elastic coordinator,
  the comm bench): per stage (per chunk of a chunked step) one
  ``dist.batch_isend_irecv`` over the boxes the plan's intersections
  name. Each piece of a target shard comes from one holder of that
  region: the target rank itself where it holds it (a local copy),
  else one of the source replicas, picked round-robin by the target's
  position. So the bytes that cross equal the plan's modeled wire
  bytes. Received pieces (and sends of non-contiguous slices) are
  staged in one arena, sized by the largest stage and reused by the
  next, and every request completes before the next stage starts.

Outputs are plain local tensors -- the whole tensor in process, this
rank's shard across ranks, None on a rank outside the target mesh --
except a ``noop`` step's, which passes its input through (unless
``copy_noop``). Target buffers and the arena are cached INSIDE the
plan: a held plan replays with no new allocation
(``compiled_program_count`` counts them), and each replay writes into
the previous one's outputs.

Observability, as in JAX: each execution is bracketed in a ``reshard``
span, emits one ``reshard_plan`` event -- the plan's modeled summary
next to ``measured_bytes``, the global bytes of the outputs it wrote
(an accounting cross-check on the plan, not a wire counter) -- sets the
``reshard_inflight_bytes`` gauge around every stage and
``reshard_peak_hbm_bytes`` to the execution's modeled per-device peak,
and counts ``reshard_wire_bytes_total``.
"""
from __future__ import annotations

import math
from typing import Any, List, Optional, Tuple

import numpy as np
import torch

from tpu_hpc_torch.obs import get_bus, get_registry, span
from tpu_hpc_torch.reshard.plan import (
    ReshardPlan,
    ReshardStep,
    _chunk_offsets,
    _intersect,
    _leaf_shape_dtype,
    boxes,
    itemsize_of,
    tree_flatten_with_path,
    tree_unflatten,
)

_ARENA_ALIGN = 16


def _rank() -> int:
    import torch.distributed as dist

    return dist.get_rank() if dist.is_initialized() else 0


def _stages(
    plan: ReshardPlan, copy_noop: bool = False
) -> List[Tuple[str, Any]]:
    """Group steps into execution stages (cached on the plan), by the
    JAX executor's rule: ``("pass", i)`` noop passthrough;
    ``("chunked", i)`` one chunked step; ``("jit", (i, ...))`` a packed
    same-mesh (or host-sourced) group; ``("dput", (i, ...))`` a packed
    cross-mesh group. Packs stay under ``max_inflight_bytes`` over the
    summed conservative transients; ``copy_noop=True`` packs noop
    leaves too (fresh buffers instead of aliasing the input)."""
    key = ("stages", copy_noop)
    if key in plan._programs:
        return plan._programs[key]
    bound = plan.max_inflight_bytes
    stages: List[Tuple[str, Any]] = []
    jit_groups = {}   # target mesh -> (indices, inflight sum)
    dput: Tuple[list, int] = ([], 0)

    def flush_jit(gkey):
        idxs, _ = jit_groups.pop(gkey)
        if idxs:
            stages.append(("jit", tuple(idxs)))

    def flush_dput():
        nonlocal dput
        if dput[0]:
            stages.append(("dput", tuple(dput[0])))
        dput = ([], 0)

    def pack_jit(i, step):
        gkey = step.tgt_sharding.mesh
        idxs, acc = jit_groups.get(gkey, ([], 0))
        if bound is not None and idxs and (
            acc + step.inflight_bytes > bound
        ):
            jit_groups[gkey] = (idxs, acc)
            flush_jit(gkey)
            idxs, acc = [], 0
        idxs.append(i)
        jit_groups[gkey] = (idxs, acc + step.inflight_bytes)

    for i, step in enumerate(plan.steps):
        if step.kind == "noop":
            if copy_noop:
                pack_jit(i, step)
            else:
                stages.append(("pass", i))
        elif step.chunk is not None:
            stages.append(("chunked", i))
        elif step.same_mesh or step.kind == "place":
            pack_jit(i, step)
        else:
            idxs, acc = dput
            if bound is not None and idxs and (
                acc + step.inflight_bytes > bound
            ):
                flush_dput()
                idxs, acc = dput
            idxs.append(i)
            dput = (idxs, acc + step.inflight_bytes)
    for gkey in list(jit_groups):
        flush_jit(gkey)
    flush_dput()
    plan._programs[key] = stages
    return stages


def _stage_inflight(plan: ReshardPlan, stage) -> int:
    kind, payload = stage
    if kind == "pass":
        return 0
    if kind == "chunked":
        return plan.steps[payload].inflight_bytes
    return sum(plan.steps[i].inflight_bytes for i in payload)


def _stage_hbm(plan: ReshardPlan, stage) -> int:
    """Modeled per-device peak while a stage runs: the per-stage SUM of
    (source shard still live + target shard being built + transient)."""
    kind, payload = stage
    idxs = (payload,) if kind in ("pass", "chunked") else payload
    return sum(
        plan.steps[i].src_resident_bytes
        + plan.steps[i].resident_bytes
        + plan.steps[i].inflight_bytes
        for i in idxs
    )


# ---------------------------------------------------------------------
# where a step's ends live
# ---------------------------------------------------------------------

def _local_mesh(sharding, me: int) -> bool:
    """Whether this process holds the whole of ``sharding``: host data,
    a torch-device mesh, or a one-rank mesh of this rank."""
    if sharding is None:
        return True
    mesh = sharding.mesh
    if not mesh.is_ranks:
        return True
    return mesh.size == 1 and mesh.devices[0] == me


def in_process(step: ReshardStep, me: Optional[int] = None) -> bool:
    me = _rank() if me is None else me
    return _local_mesh(step.src_sharding, me) and \
        _local_mesh(step.tgt_sharding, me)


def _target_device(step: ReshardStep, fallback: torch.device) -> torch.device:
    mesh = step.tgt_sharding.mesh
    if mesh.is_ranks:
        return fallback
    return torch.device(mesh.devices[0])


def _as_local(leaf: Any) -> Any:
    """The bytes this process holds of a leaf: a DTensor's local shard,
    a host array or scalar as a CPU tensor."""
    from tpu_hpc_torch.parallel.shard import local

    if isinstance(leaf, torch.Tensor):
        return local(leaf)
    if leaf is None:
        return None
    return torch.as_tensor(np.asarray(leaf))


def _out_dtype(step: ReshardStep, src: Optional[torch.Tensor]):
    if step.tgt_dtype is not None:
        return step.tgt_dtype
    if src is not None:
        return src.dtype
    return getattr(torch, step.dtype)


def _target(plan: ReshardPlan, i: int, shape, dtype, device) -> torch.Tensor:
    """Step ``i``'s cached target buffer on this process."""
    key = ("target", i)
    buf = plan._programs.get(key)
    if buf is None or tuple(buf.shape) != tuple(shape) \
            or buf.dtype != dtype or buf.device != device:
        buf = torch.empty(tuple(shape), dtype=dtype, device=device)
        plan._programs[key] = buf
    return buf


def _arena(plan: ReshardPlan, nbytes: int, device) -> torch.Tensor:
    """The cached staging arena on ``device``, grown to ``nbytes``."""
    key = ("arena", str(device))
    buf = plan._programs.get(key)
    if buf is None or buf.numel() < nbytes:
        buf = torch.empty(max(nbytes, 1), dtype=torch.uint8, device=device)
        plan._programs[key] = buf
    return buf


def _box_slices(box, origin) -> Tuple[slice, ...]:
    return tuple(slice(lo - o, hi - o) for (lo, hi), (o, _) in
                 zip(box, origin))


def _restrict(box, axis: Optional[int], a: int, b: int):
    if axis is None:
        return box
    lo, hi = box[axis]
    lo, hi = max(lo, a), min(hi, b)
    if hi <= lo:
        return None
    return box[:axis] + ((lo, hi),) + box[axis + 1:]


def pieces(plan: ReshardPlan, i: int) -> List[Tuple[Any, Any, tuple]]:
    """Step ``i``'s move as ``(source key, target key, global box)``
    pieces (cached): each region of each target shard from one holder
    -- the target itself where it holds the region, else a source
    replica picked round-robin by the target's position. A host source
    has key None."""
    key = ("pieces", i)
    if key in plan._programs:
        return plan._programs[key]
    step = plan.steps[i]
    shape = step.shape
    tgt = boxes(step.tgt_sharding, shape)
    out: List[Tuple[Any, Any, tuple]] = []
    if step.src_sharding is None:
        out = [(None, t, box) for t, box in tgt.items()
               if math.prod(hi - lo for lo, hi in box)]
    else:
        distinct: dict = {}
        for s, box in boxes(step.src_sharding, shape).items():
            distinct.setdefault(box, []).append(s)
        for pos, (t, tbox) in enumerate(tgt.items()):
            for sbox, holders in distinct.items():
                inter = _intersect(sbox, tbox)
                if inter is None:
                    continue
                src = t if t in holders else holders[pos % len(holders)]
                out.append((src, t, inter))
    plan._programs[key] = out
    return out


# ---------------------------------------------------------------------
# the in-process transport
# ---------------------------------------------------------------------

def _move_in_process(plan: ReshardPlan, i: int, leaf, device) -> torch.Tensor:
    step = plan.steps[i]
    src = _as_local(leaf)
    out = _target(plan, i, step.shape, _out_dtype(step, src),
                  _target_device(step, device))
    if step.chunk is None:
        out.copy_(src, non_blocking=True)
        return out
    ax = step.chunk.axis
    for a, b in _chunk_offsets(step.shape[ax], step.chunk.size):
        out.narrow(ax, a, b - a).copy_(src.narrow(ax, a, b - a),
                                       non_blocking=True)
    return out


# ---------------------------------------------------------------------
# the cross-rank transport
# ---------------------------------------------------------------------

class _Exchange:
    """One stage's (or chunk's) P2P batch on this rank: local copies
    now, sends and receives posted together, receives landed after."""

    def __init__(self, plan: ReshardPlan, me: int, device):
        self.plan = plan
        self.me = (None, me)
        self.device = device
        self.local: list = []      # (dst view, src view)
        self.sends: list = []      # (peer rank, src view)
        self.recvs: list = []      # (peer rank, dst view)

    def add(self, i: int, src_local, out, axis=None, a=0, b=0):
        step = self.plan.steps[i]
        shape = step.shape
        sbox = (boxes(step.src_sharding, shape)
                if step.src_sharding is not None else {})
        tbox = boxes(step.tgt_sharding, shape)
        whole = tuple((0, n) for n in shape)
        for s, t, box in pieces(self.plan, i):
            box = _restrict(box, axis, a, b)
            if box is None or self.me not in (s, t):
                continue
            if t == self.me:
                dst = out[_box_slices(box, tbox[t])]
                if s is None:
                    self.local.append((dst, src_local[_box_slices(box,
                                                                  whole)]))
                elif s == self.me:
                    self.local.append((dst, src_local[_box_slices(
                        box, sbox[s])]))
                else:
                    self.recvs.append((s[1], dst))
            elif s == self.me:
                self.sends.append((t[1], src_local[_box_slices(box,
                                                               sbox[s])]))

    def run(self) -> None:
        import torch.distributed as dist

        for dst, src in self.local:
            dst.copy_(src)
        if not self.sends and not self.recvs:
            return
        # Stage buffers: every receive, and every send whose slice is
        # not contiguous, in one arena.
        need = 0
        for _, view in self.recvs + [s for s in self.sends
                                     if not s[1].is_contiguous()]:
            need += -(-view.numel() * view.element_size()
                      // _ARENA_ALIGN) * _ARENA_ALIGN
        arena = _arena(self.plan, need, self.device)
        off = 0

        def carve(view):
            nonlocal off
            n = view.numel() * view.element_size()
            buf = arena[off:off + n].view(view.dtype).view(view.shape)
            off += -(-n // _ARENA_ALIGN) * _ARENA_ALIGN
            return buf

        ops, landed = [], []
        for peer, view in self.sends:
            if not view.is_contiguous():
                buf = carve(view)
                buf.copy_(view)
                view = buf
            ops.append(dist.P2POp(dist.isend, view, peer))
        for peer, dst in self.recvs:
            buf = carve(dst)
            ops.append(dist.P2POp(dist.irecv, buf, peer))
            landed.append((dst, buf))
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        for dst, buf in landed:
            dst.copy_(buf)


def _local_target(plan: ReshardPlan, i: int, me: int, dtype, device):
    step = plan.steps[i]
    tb = boxes(step.tgt_sharding, step.shape).get((None, me))
    if tb is None:
        return None
    return _target(plan, i, tuple(hi - lo for lo, hi in tb), dtype, device)


def _check_local(step: ReshardStep, src, me: int) -> None:
    if step.src_sharding is None or src is None:
        return
    sb = boxes(step.src_sharding, step.shape).get((None, me))
    want = tuple(hi - lo for lo, hi in sb) if sb is not None else None
    if want is not None and tuple(src.shape) != want:
        raise ValueError(
            f"leaf {step.path}: this rank holds {tuple(src.shape)}, the "
            f"plan's shard is {want}")


# ---------------------------------------------------------------------
# execution
# ---------------------------------------------------------------------

def _default_device(flat) -> torch.device:
    for leaf in flat:
        if isinstance(leaf, torch.Tensor) and leaf.device.type != "meta":
            from tpu_hpc_torch.parallel.shard import local

            return local(leaf).device
    return torch.device("cuda", torch.cuda.current_device()) \
        if torch.cuda.is_available() else torch.device("cpu")


def modeled_device_bytes(plan: ReshardPlan, device: Any) -> int:
    """Modeled rise in memory on ``device`` (a torch device of this
    process) over a first execution: the target of every step that
    lands there and is not passed through, plus the largest stage
    transient."""
    from tpu_hpc_torch.reshard.plan import _device_name

    name = _device_name(device)
    total = 0
    for step in plan.steps:
        if step.kind == "noop":
            continue
        mesh = step.tgt_sharding.mesh
        if name not in mesh.devices and not mesh.is_ranks:
            continue
        size = itemsize_of(step.tgt_dtype or step.dtype)
        total += step.resident_bytes // itemsize_of(step.dtype) * size
    return total + plan.peak_inflight_bytes


def execute_plan(
    plan: ReshardPlan,
    tree: Any,
    *,
    donate: bool = False,
    copy_noop: bool = False,
    sink: Optional[str] = None,
    device: Any = None,
) -> Any:
    """Execute ``plan`` on ``tree``; returns the target-placed tree.

    ``tree`` holds the leaves the plan was made for: whole tensors in
    process; across ranks, this rank's local shards (a DTensor counts
    as its local shard; a rank outside the source mesh passes None).
    ``device``: where this rank's target shards live (default: the
    first tensor leaf's device). ``donate=True`` drops the executor's
    references to each stage's sources as the stage completes, so they
    free as soon as the caller lets go too. ``copy_noop=True`` gives
    already-placed (noop) leaves fresh buffers instead of aliasing the
    input -- the serve weight placement's fresh-buffer contract.
    """
    leaves, treedef = tree_flatten_with_path(tree, none_is_leaf=True)
    flat = [leaf for _, leaf in leaves]
    if treedef != plan.treedef:
        raise ValueError("tree structure does not match the plan")
    me = _rank()
    device = torch.device(device) if device is not None \
        else _default_device(flat)
    for leaf, step in zip(flat, plan.steps):
        if in_process(step, me) and leaf is not None:
            shape, dtype = _leaf_shape_dtype(leaf)
            if tuple(shape) != step.shape or itemsize_of(dtype) != \
                    itemsize_of(step.dtype):
                raise ValueError(
                    f"leaf {step.path}: {tuple(shape)}/{dtype} does not "
                    f"match the planned {step.shape}/{step.dtype}"
                )
    out: List[Any] = [None] * len(flat)
    reg = get_registry()
    stages = _stages(plan, copy_noop)
    peak_hbm = max((_stage_hbm(plan, s) for s in stages), default=0)
    moved = 0

    def release(indices):
        if donate:
            for i in indices:
                flat[i] = None

    bound = plan.max_inflight_bytes
    pending = {"bytes": 0, "devices": set()}

    def catch_up():
        # In-process copies are asynchronous on a card: at most
        # ``max_inflight_bytes`` of them are enqueued before the
        # devices catch up (one leaf larger than the bound alone).
        for dev in pending["devices"]:
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
        pending["bytes"], pending["devices"] = 0, set()

    def run_steps(indices):
        nonlocal moved
        exch = None
        for i in indices:
            step = plan.steps[i]
            if in_process(step, me):
                nbytes = math.prod(step.shape) * itemsize_of(
                    step.tgt_dtype or step.dtype)
                if bound is not None and pending["bytes"] \
                        and pending["bytes"] + nbytes > bound:
                    catch_up()
                out[i] = _move_in_process(plan, i, flat[i], device)
                pending["bytes"] += nbytes
                pending["devices"].add(out[i].device)
            else:
                src = _as_local(flat[i])
                _check_local(step, src, me)
                o = _local_target(plan, i, me, _out_dtype(step, src), device)
                exch = exch or _Exchange(plan, me, device)
                if step.chunk is None:
                    exch.add(i, src, o)
                else:
                    ax = step.chunk.axis
                    for a, b in _chunk_offsets(step.shape[ax],
                                               step.chunk.size):
                        one = _Exchange(plan, me, device)
                        one.add(i, src, o, ax, a, b)
                        one.run()
                out[i] = o
            moved += math.prod(step.shape) * itemsize_of(
                step.tgt_dtype or step.dtype)
        if exch is not None:
            exch.run()

    with span("reshard", sink=sink, n=len(plan.steps),
              hist="reshard_execute_s"):
        for stage in stages:
            kind, payload = stage
            reg.set_gauge(
                "reshard_inflight_bytes", _stage_inflight(plan, stage)
            )
            if kind == "pass":
                leaf = flat[payload]
                step = plan.steps[payload]
                if step.tgt_dtype is not None and isinstance(
                        leaf, torch.Tensor) and leaf.dtype != step.tgt_dtype:
                    leaf = leaf.to(step.tgt_dtype)
                out[payload] = leaf
            elif kind == "chunked":
                run_steps((payload,))
                release((payload,))
            else:
                run_steps(payload)
                release(payload)
        catch_up()
        reg.set_gauge("reshard_inflight_bytes", 0)
    reg.set_gauge("reshard_peak_hbm_bytes", peak_hbm)
    reg.inc("reshard_wire_bytes_total", plan.wire_bytes)
    reg.inc("reshard_executions_total")
    get_bus().emit(
        "reshard_plan",
        sink=sink,
        label=plan.label,
        measured_bytes=moved,
        **plan.summary(),
    )
    return tree_unflatten(plan.treedef, out)


def apply(
    tree: Any,
    targets: Any,
    *,
    max_inflight_bytes: "Optional[int | str]" = None,
    donate: bool = False,
    copy_noop: bool = False,
    label: Optional[str] = None,
    sink: Optional[str] = None,
    dtypes: Any = None,
    device: Any = None,
) -> Any:
    """Plan + execute in one call: reshard ``tree`` onto ``targets``.
    For repeated moves of same-shaped trees build the plan once with
    :func:`~tpu_hpc_torch.reshard.plan.plan_reshard` and call
    ``plan.execute`` -- its buffers are cached on the plan."""
    from tpu_hpc_torch.reshard.plan import plan_reshard

    plan = plan_reshard(
        tree, targets, max_inflight_bytes=max_inflight_bytes,
        label=label, dtypes=dtypes,
    )
    return execute_plan(
        plan, tree, donate=donate, copy_noop=copy_noop, sink=sink,
        device=device,
    )
