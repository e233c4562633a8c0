"""Checkpointing over ``torch.distributed.checkpoint`` (DCP).

Port of the JAX package's ``ckpt/checkpoint.py`` (an Orbax manager).
The reference this repo was built from has three checkpoint patterns:
rank-0 save + barrier, the FSDP full state dict gathered to rank 0, and
snapshot auto-resume. One class covers them:

  * DCP sharded save: every rank writes its own shards (no gather);
    ``export_consolidated`` writes the single-file full state when a
    portable dump is wanted.
  * ``restore_latest``: give it the live state, get back the newest
    readable checkpoint laid out like it, or None -- the Trainer
    resumes from ``state.step`` exactly.

A checkpoint step is the directory ``<directory>/<step>``; it counts as
committed once DCP's ``.metadata`` file is in it (DCP writes it last).
The state goes to DCP as one flat dict of tensors
(:func:`state_dict`): ``step``, ``params.<path>``, ``opt.count`` and
``opt.<mu|nu|trace>.<param path>``, ``model_state.<path>``. Params on
a mesh are DTensors, so a restore onto a different (data, model) mesh
is DCP's own load-time resharding into the live DTensors -- the
counterpart of the JAX package's explicit elastic reshard.

Resilience: ``save`` is asynchronous (``dcp.async_save``): it returns
once the state is staged to host memory, so the optimizer's next
in-place update cannot reach the bytes being written; the write, and
the checksums of the staged copy, finish in the background.
``save_now`` is the emergency synchronous preemption snapshot.
``restore_latest`` retries transient failures (``retry_call``) and
falls back to the next-older step when the newest is torn or corrupt.

Content integrity (``ckpt.integrity``): saves record per-leaf crc32
checksums of the staged copy in a ``.tpu_hpc_meta/<step>.json``
sidecar, beside the topology (mesh axes, per-leaf shape, dtype and
placements): of each leaf a rank holds whole, and -- keyed by rank --
of each rank's local shard of the leaves sharded over the mesh.
Restores recompute them and treat a mismatch on any rank exactly like
a torn write. Shard checksums are compared only when the restore's
mesh and the leaf's placements are the save's: a restore that DCP
reshards cuts other shards, and checks the whole leaves alone. Every
fallback quarantines the dead step as ``<step>.corrupt`` so later
restarts skip it, and emits ``ckpt_fallback`` / ``ckpt_integrity``
events plus registry counters.
A checkpoint whose leaves differ from the live state's in structure
raises :class:`TopologyMismatchError` naming both.

Fault injection (``$TPU_HPC_FAULTS``): ``corrupt_ckpt_at_step`` garbles
every file of that step after it lands; ``bitflip_ckpt_at_step`` flips
one bit of the largest tensor and rewrites the step through DCP, so
every file still parses and only the checksums can tell.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from tpu_hpc_torch.ckpt import integrity
from tpu_hpc_torch.logging_ import get_logger
from tpu_hpc_torch.resilience.faults import fault_plan_from_env
from tpu_hpc_torch.resilience.retry import retry_call

SIDECAR_DIR = ".tpu_hpc_meta"
METADATA = ".metadata"  # DCP's, written last
RESTORE_RETRIES = 1  # extra attempts per step (a flaky shared filesystem)


class TopologyMismatchError(ValueError):
    """A checkpoint exists but cannot be restored into the live state:
    the two trees differ in structure (leaf names or shapes), not just
    in layout -- a wrong model or config on relaunch. A mesh change
    alone is resharded by DCP and never raises this."""


def _warn(msg: str, *args) -> None:
    get_logger("tpu_hpc_torch.ckpt").warning(msg, *args)


# ---------------------------------------------------------------------
# TrainState <-> a flat state dict
# ---------------------------------------------------------------------

def state_dict(state: Any) -> Dict[str, Any]:
    """The flat ``{key: tensor}`` DCP saves for a ``TrainState``: its
    step, params, optimizer state (moment lists keyed by their param's
    path) and model state. Host ints (the step; an unguarded
    optimizer's count) become 0-d int64 CPU tensors."""
    from tpu_hpc_torch.train.trainer import tree_leaves, tree_paths

    def key(prefix, path):
        return prefix + "." + ".".join(path)

    def tensor(x):
        return x if isinstance(x, torch.Tensor) else torch.tensor(
            int(x), dtype=torch.int64)

    paths = tree_paths(state.params)
    params = tree_leaves(state.params)
    flat: Dict[str, Any] = {"step": tensor(state.step)}
    for path, leaf in zip(paths, params):
        flat[key("params", path)] = leaf
    for name, value in sorted(state.opt_state.items()):
        if isinstance(value, (list, tuple)):
            for path, leaf, param in zip(paths, value, params):
                flat[key("opt." + name, path)] = _like_param(leaf, param)
        else:
            flat["opt." + name] = tensor(value)
    ms = state.model_state or {}
    for path, leaf in zip(tree_paths(ms), tree_leaves(ms)):
        flat[key("model_state", path)] = leaf
    return flat


def _like_param(moment: Any, param: Any) -> Any:
    """A moment as DCP must see it: on a mesh the optimizer keeps each
    rank's shard as a plain tensor, which DCP would take for a
    replicated one; wrapped in its param's placements it is saved as
    the shard it is (and resharded on load like the param)."""
    mesh = getattr(param, "device_mesh", None)
    if mesh is None or getattr(moment, "device_mesh", None) is not None:
        return moment
    from torch.distributed.tensor import DTensor

    return DTensor.from_local(moment, mesh, param.placements,
                              shape=param.shape, stride=param.stride(),
                              run_check=False)


def _local(t: Any) -> Any:
    return t.to_local() if hasattr(t, "to_local") else t


def _from_state_dict(template: Any, flat: Dict[str, Any]) -> Any:
    """A ``TrainState`` shaped like ``template`` from restored
    buffers (host ints stay host ints)."""
    from tpu_hpc_torch.train.trainer import TrainState, tree_paths

    def key(prefix, path):
        return prefix + "." + ".".join(path)

    def build(tree, prefix, path=()):
        return {k: build(v, prefix, path + (k,)) if isinstance(v, dict)
                else flat[key(prefix, path + (k,))] for k, v in tree.items()}

    paths = tree_paths(template.params)
    opt = {}
    for name, value in template.opt_state.items():
        if isinstance(value, (list, tuple)):
            opt[name] = [_local(flat[key("opt." + name, p)])
                         if getattr(v, "device_mesh", None) is None
                         else flat[key("opt." + name, p)]
                         for p, v in zip(paths, value)]
        elif isinstance(value, torch.Tensor):
            opt[name] = flat["opt." + name]
        else:
            opt[name] = int(flat["opt." + name])
    return TrainState(step=int(flat["step"]),
                      params=build(template.params, "params"),
                      opt_state=opt,
                      model_state=build(template.model_state or {},
                                        "model_state"))


def _empty_like(t: Any) -> Any:
    return torch.empty_like(t.detach())


def _host_copy(t: Any) -> Any:
    """A copy of ``t`` in host memory that later in-place updates of
    ``t`` cannot reach (a DTensor keeps its mesh and placements)."""
    t = t.detach()
    return t.clone() if t.device.type == "cpu" else t.to("cpu")


def _mesh_of(flat: Dict[str, Any]):
    for t in flat.values():
        mesh = getattr(t, "device_mesh", None)
        if mesh is not None:
            return mesh
    return None


def topology_of(flat: Dict[str, Any]) -> dict:
    """The sidecar's topology record: the mesh axes (when a leaf is a
    DTensor) and per-leaf shape, dtype and placements."""
    import torch.distributed as dist

    mesh = _mesh_of(flat)
    leaves = {}
    for k, t in flat.items():
        rec = {"shape": [int(d) for d in t.shape],
               "dtype": integrity.dtype_name(t)}
        if getattr(t, "placements", None) is not None:
            rec["spec"] = [str(p) for p in t.placements]
        leaves[k] = rec
    topo = {"leaves": leaves,
            "device_count": dist.get_world_size()
            if dist.is_initialized() else 1}
    if mesh is not None:
        topo["mesh"] = dict(zip(mesh.mesh_dim_names or (),
                                (int(s) for s in mesh.shape)))
    return topo


def describe_mismatch(meta: dict, flat: Dict[str, Any]) -> Optional[str]:
    """The structural difference between a sidecar and the live state,
    or None when they agree."""
    saved = meta.get("leaves", {})
    live = {k: [int(d) for d in t.shape] for k, t in flat.items()}
    missing = sorted(set(saved) - set(live))
    extra = sorted(set(live) - set(saved))
    if missing or extra:
        return (f"tree structure differs: {len(missing)} leaf/leaves only "
                f"in the checkpoint (first: {missing[:3]}), {len(extra)} "
                f"only in the live state (first: {extra[:3]})")
    for k, shape in live.items():
        if saved[k].get("shape") != shape:
            return (f"leaf {k!r} has shape {saved[k].get('shape')} in the "
                    f"checkpoint but {shape} in the live state (wrong "
                    "model config?)")
    return None


class _Staged:
    """DCP's staging hook for a state dict the manager already copied
    to host memory: nothing left to copy."""

    should_synchronize_after_execute = True

    def stage(self, sd):
        return sd

    def synchronize_staging(self) -> None:
        pass

    def close(self) -> None:
        pass


class CheckpointManager:
    """Asynchronous sharded checkpoints of a ``TrainState`` in one
    directory, keeping the newest ``max_to_keep`` steps."""

    def __init__(self, directory: str, max_to_keep: int = 3):
        import torch.distributed as dist

        if max_to_keep < 1:
            raise ValueError(f"max_to_keep {max_to_keep} must be >= 1")
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        # Provenance of the last restore_latest: step, and whether the
        # checkpoint's mesh differs from the live one.
        self.last_restore_info: Optional[dict] = None
        # JSONL sink for this manager's events (the Trainer points it
        # at the run log on rank 0).
        self.event_sink: Optional[str] = None
        self._pending_fallbacks: list = []
        # The save in flight: (step, upload future, sidecar thread,
        # the replaced copy to remove once it is durable).
        self._inflight: Optional[
            Tuple[int, Any, threading.Thread, Optional[str]]] = None
        self._sidecar: Optional[dict] = None
        self._shard_sums: Dict[str, Any] = {}
        self._rank, self._world = 0, 1
        self._pg = None
        if dist.is_initialized():
            self._rank, self._world = dist.get_rank(), dist.get_world_size()
            # DCP coordinates ranks over a CPU-capable group (async
            # saves refuse one without it): a gloo group beside NCCL.
            if dist.get_backend() != "gloo":
                self._pg = dist.new_group(backend="gloo")
        if self._rank == 0:
            os.makedirs(os.path.join(self.directory, SIDECAR_DIR),
                        exist_ok=True)
        self._barrier()

    # -- ranks ----------------------------------------------------------
    def _dist_kw(self) -> dict:
        return {"process_group": self._pg, "no_dist": self._world == 1}

    def _barrier(self) -> None:
        if self._world > 1:
            import torch.distributed as dist

            dist.barrier(group=self._pg)

    def _gather(self, obj: Any) -> List[Any]:
        """``obj`` of every rank, in rank order, on rank 0 (other ranks
        get an empty list)."""
        if self._world == 1:
            return [obj]
        import torch.distributed as dist

        out = [None] * self._world if self._rank == 0 else None
        dist.gather_object(obj, out, dst=0, group=self._pg)
        return out or []

    def _any(self, flag: bool) -> bool:
        """Whether ``flag`` holds on any rank."""
        if self._world == 1:
            return flag
        import torch.distributed as dist

        t = torch.tensor([int(flag)])
        dist.all_reduce(t, op=dist.ReduceOp.MAX, group=self._pg)
        return bool(t.item())

    # -- paths ----------------------------------------------------------
    def _step_dir(self, step: int) -> str:
        return os.path.join(self.directory, str(int(step)))

    def _sidecar_path(self, step: int) -> str:
        return os.path.join(self.directory, SIDECAR_DIR, f"{int(step)}.json")

    def all_steps(self) -> List[int]:
        """Committed steps, oldest first."""
        try:
            names = os.listdir(self.directory)
        except OSError:
            return []
        return sorted(int(n) for n in names if n.isdigit() and os.path.exists(
            os.path.join(self.directory, n, METADATA)))

    def read_sidecar(self, step: int) -> Optional[dict]:
        try:
            with open(self._sidecar_path(step)) as f:
                return json.load(f)
        except (OSError, ValueError):
            return None

    # -- save -----------------------------------------------------------
    def save(self, state: Any, step: Optional[int] = None) -> bool:
        """Asynchronous sharded save at ``step`` (default
        ``state.step``): returns once the state is staged to host
        memory; the write and the sidecar finish in the background
        (:meth:`wait`). One save is in flight at a time."""
        import torch.distributed.checkpoint as dcp

        step = int(state.step if step is None else step)
        self.wait()
        aside = self._stash_existing(step)
        staged = {k: _host_copy(v) for k, v in state_dict(state).items()}
        resp = dcp.async_save(staged, checkpoint_id=self._step_dir(step),
                              async_stager=_Staged(), **self._dist_kw())
        upload = getattr(resp, "upload_completion", resp)
        thread = threading.Thread(target=self._write_sidecar,
                                  args=(step, staged), daemon=True)
        thread.start()
        self._inflight = (step, upload, thread, aside)
        if self._fault_wants(step):
            self.wait()
            self._maybe_corrupt(step)
        return True

    def save_now(self, state: Any, step: Optional[int] = None) -> int:
        """Emergency SYNCHRONOUS save: the snapshot is durable when
        this returns (the preemption grace window may be seconds).
        Returns the step saved."""
        import torch.distributed.checkpoint as dcp

        step = int(state.step if step is None else step)
        self.wait()
        aside = self._stash_existing(step)
        flat = state_dict(state)
        dcp.save(flat, checkpoint_id=self._step_dir(step),
                 **self._dist_kw())
        self._write_sidecar(step, flat)
        self._finish(step, aside)
        self._maybe_corrupt(step)
        return step

    def wait(self) -> None:
        """Block until the save in flight (and its sidecar) landed --
        call before job exit."""
        if self._inflight is None:
            return
        step, upload, thread, aside = self._inflight
        self._inflight = None
        upload.result()
        thread.join()
        self._finish(step, aside)

    def close(self) -> None:
        self.wait()

    def _finish(self, step: int, aside: Optional[str]) -> None:
        """After step's write is durable: its sidecar, with every rank's
        shard checksums, to disk (rank 0), the replaced copy and the
        steps beyond ``max_to_keep`` removed."""
        sidecar, self._sidecar = self._sidecar, None
        shards, self._shard_sums = self._gather(self._shard_sums), {}
        if sidecar is not None and any(shards):
            sidecar["shard_checksums"] = {
                str(r): sums for r, sums in enumerate(shards)}
        if self._rank == 0:
            if sidecar is not None:
                path = self._sidecar_path(step)
                with open(path + ".tmp", "w") as f:
                    json.dump(sidecar, f)
                os.replace(path + ".tmp", path)
            if aside is not None:
                shutil.rmtree(aside, ignore_errors=True)
            for old in self.all_steps()[:-self.max_to_keep]:
                shutil.rmtree(self._step_dir(old), ignore_errors=True)
                try:
                    os.remove(self._sidecar_path(old))
                except OSError:
                    pass
        self._barrier()

    def _write_sidecar(self, step: int, flat: Dict[str, Any]) -> None:
        """The sidecar record (topology + the checksums of what was
        staged), built on rank 0 and written by :meth:`_finish` once the
        step is durable; every rank sums its own shards. Never fails the
        save: a missing sidecar only means an unverified restore."""
        try:
            self._shard_sums = integrity.leaf_checksums(flat, shards=True)
            if self._rank != 0:
                return
            rec = topology_of(flat)
            rec["step"] = int(step)
            sums = integrity.leaf_checksums(flat)
            if sums:
                rec["checksums"] = sums
            self._sidecar = rec
        except Exception as exc:  # noqa: BLE001 - advisory metadata
            _warn("could not build the sidecar of step %d (%s: %s)",
                  step, type(exc).__name__, exc)

    def _stash_existing(self, step: int) -> Optional[str]:
        """A run restored below its newest snapshot re-trains through
        steps it already saved: the old copy is renamed aside (removed
        once its replacement is durable) so the fresh save replaces
        it."""
        path = self._step_dir(step)
        aside = None
        if self._rank == 0 and os.path.isdir(path):
            aside = self._rename_aside(path, "replaced")
        self._barrier()
        return aside

    @staticmethod
    def _rename_aside(path: str, suffix: str) -> str:
        """``path`` -> ``<path>.<suffix>`` (uniqued: an aside copy is
        evidence and never overwritten)."""
        dst, k = f"{path}.{suffix}", 0
        while os.path.exists(dst):
            k += 1
            dst = f"{path}.{suffix}.{k}"
        os.rename(path, dst)
        return dst

    # -- fault injection ------------------------------------------------
    @staticmethod
    def _fault_wants(step: int) -> bool:
        plan = fault_plan_from_env()
        return plan is not None and (plan.wants_ckpt_corruption(step)
                                     or plan.wants_ckpt_bitflip(step))

    def _maybe_corrupt(self, step: int) -> None:
        """No-op unless ``$TPU_HPC_FAULTS`` asks: garble every file of
        the step (a torn write), or flip one bit of its largest tensor
        through DCP (a silent corruption only the checksums catch)."""
        plan = fault_plan_from_env()
        if plan is None:
            return
        if plan.wants_ckpt_corruption(step) and self._rank == 0:
            n = plan.corrupt_checkpoint(self._step_dir(step))
            _warn("fault injection: corrupted %d files of checkpoint "
                  "step %d", n, step)
        if plan.wants_ckpt_bitflip(step) and self._rank == 0:
            plan.announce_bitflip(step)
            self._bitflip_step(step)
            _warn("fault injection: bit-flipped one tensor of checkpoint "
                  "step %d (files remain parseable)", step)
        self._barrier()

    def _bitflip_step(self, step: int) -> None:
        """Flip the top bit of the middle byte of the step's largest
        tensor and rewrite the step through DCP (one process, whole
        tensors). The sidecar keeps the save-time checksums."""
        import torch.distributed.checkpoint as dcp
        from torch.distributed.checkpoint.metadata import (
            TensorStorageMetadata,
        )

        path = self._step_dir(step)
        meta = dcp.FileSystemReader(path).read_metadata()
        bufs = {k: torch.empty(tuple(m.size), dtype=m.properties.dtype)
                for k, m in meta.state_dict_metadata.items()
                if isinstance(m, TensorStorageMetadata)}
        dcp.load(bufs, checkpoint_id=path, no_dist=True)
        name = max(bufs, key=lambda k: bufs[k].numel()
                   * bufs[k].element_size())
        raw = bufs[name].view(-1).view(torch.uint8)
        raw[raw.numel() // 2] ^= 0x80
        tmp = f"{path}.bitflip.tmp"
        shutil.rmtree(tmp, ignore_errors=True)
        dcp.save(bufs, checkpoint_id=tmp, no_dist=True)
        old = self._rename_aside(path, "preflip")
        os.rename(tmp, path)
        shutil.rmtree(old, ignore_errors=True)

    # -- restore --------------------------------------------------------
    def _load(self, step: int, template: Any) -> Dict[str, Any]:
        import torch.distributed.checkpoint as dcp

        bufs = {k: _empty_like(v) for k, v in state_dict(template).items()}
        dcp.load(bufs, checkpoint_id=self._step_dir(step),
                 **self._dist_kw())
        return bufs

    def restore(self, step: int, template_state: Any) -> Any:
        """Checkpoint ``step`` laid out like ``template_state`` (new
        tensors; the template is not written)."""
        self.wait()
        return _from_state_dict(template_state,
                                self._load(step, template_state))

    def restore_latest(self, template_state: Any) -> Optional[Any]:
        """The newest READABLE checkpoint laid out like
        ``template_state`` (new tensors, DTensors resharded onto the
        live placements), or None when there is no checkpoint.

        Each step gets ``RESTORE_RETRIES`` extra attempts (a flaky
        shared filesystem); a step that still fails -- a torn write or a
        checksum mismatch -- falls back to the next-older one, and once
        an older step restores, the dead ones are quarantined. If every
        step fails, the failure is raised (as TopologyMismatchError when
        the sidecar shows a different tree): returning None would
        restart from step 0 and overwrite the survivors."""
        # DCP raises CheckpointException, a BaseException.
        from torch.distributed.checkpoint.api import CheckpointException

        failures = (Exception, CheckpointException)
        self.wait()
        steps = sorted(self.all_steps(), reverse=True)
        self.last_restore_info = None
        self._pending_fallbacks = []
        last_exc: Optional[Exception] = None
        live_mesh = _mesh_of(state_dict(template_state))
        for step in steps:
            meta = self.read_sidecar(step)
            try:
                flat = retry_call(
                    self._load, (step, template_state),
                    retries=RESTORE_RETRIES,
                    base_delay=0.2, max_delay=5.0, retry_on=failures,
                    describe=f"checkpoint restore (step {step})")
                live = (dict(zip(live_mesh.mesh_dim_names or (),
                                 (int(s) for s in live_mesh.shape)))
                        if live_mesh is not None else None)
                src = (meta or {}).get("mesh")
                self._verify_integrity(step, flat, meta, same_mesh=(
                    src == live
                    and (meta or {}).get("device_count") == self._world))
                self.last_restore_info = {
                    "step": step, "elastic": src is not None and src != live,
                    "src_mesh": src, "tgt_mesh": live}
                self._flush_fallbacks(quarantine=True)
                return _from_state_dict(template_state, flat)
            except failures as exc:  # fall back older
                last_exc = exc
                _warn("checkpoint step %d unreadable (%s: %s); falling "
                      "back to the previous one", step,
                      type(exc).__name__, exc)
                self._pending_fallbacks.append((step, exc))
        self._flush_fallbacks(quarantine=False)
        if last_exc is not None:
            self._raise_restore_failure(steps, template_state, last_exc)
        return None

    def _emit(self, event: str, **fields) -> None:
        """Schema-stamped telemetry, best-effort."""
        try:
            from tpu_hpc_torch import obs

            obs.get_bus().emit(event, sink=self.event_sink, **fields)
        except Exception:  # pragma: no cover - diagnostics only
            pass

    def _count(self, name: str) -> None:
        try:
            from tpu_hpc_torch import obs

            obs.get_registry().inc(name)
        except Exception:  # pragma: no cover - diagnostics only
            pass

    def _verify_integrity(self, step: int, flat: Dict[str, Any],
                          meta: Optional[dict], same_mesh: bool) -> None:
        """Recompute the checksums of the restored leaves this rank
        holds whole, and -- when the checkpoint was saved on this mesh
        -- of this rank's shards of the leaves whose placements are the
        save's, and compare with the sidecar's; a mismatch on any rank
        raises CkptIntegrityError on every rank."""
        meta = meta or {}
        sums = meta.get("checksums")
        if not sums:
            return
        shards = {}
        if same_mesh:
            leaves = meta.get("leaves", {})
            shards = {
                k: rec for k, rec in meta.get("shard_checksums", {}).get(
                    str(self._rank), {}).items()
                if k in flat and leaves.get(k, {}).get("spec") == [
                    str(p) for p in getattr(flat[k], "placements", ())]}
        bad = (integrity.verify_tree(flat, sums)
               + integrity.verify_tree(flat, shards, shards=True))
        mismatch = self._any(bool(bad))
        self._emit("ckpt_integrity", step=step,
                   verdict="mismatch" if mismatch else "ok",
                   checked=len(sums) + len(shards),
                   mismatched=bad[:8] if bad else None)
        self._count("ckpt_integrity_checks_total")
        if mismatch:
            self._count("ckpt_integrity_fail_total")
            raise integrity.CkptIntegrityError(
                f"checkpoint step {step}: restored content differs from "
                f"the save-time checksums (first: {bad[:3]}) -- silent "
                "corruption; treating like a torn write")

    def quarantine_step(self, step: int,
                        reason: str = "corrupt") -> Optional[str]:
        """Move a dead snapshot out of the step listing: ``<step>`` ->
        ``<step>.<reason>`` and its sidecar aside with it, so later
        restarts skip it. Rank 0 renames; other ranks return None."""
        if self._rank != 0:
            return None
        src = self._step_dir(step)
        if not os.path.isdir(src):
            return None
        try:
            dst = self._rename_aside(src, reason)
        except OSError as exc:
            _warn("could not quarantine checkpoint step %d (%s)", step, exc)
            return None
        side = self._sidecar_path(step)
        if os.path.exists(side):
            try:
                os.rename(side, self._rename_aside(side, reason))
            except OSError:
                pass
        _warn("quarantined checkpoint step %d -> %s (%s)", step,
              os.path.basename(dst), reason)
        return dst

    def _flush_fallbacks(self, quarantine: bool) -> None:
        """Record each failed step as a ``ckpt_fallback`` event; with
        ``quarantine`` (an older step restored, so the failures were the
        snapshots' own) rename the dead ones aside. A structural
        mismatch or a filesystem error is never quarantined: the
        snapshot itself may be fine."""
        pending, self._pending_fallbacks = self._pending_fallbacks, []
        for step, exc in pending:
            quarantined = None
            if quarantine and not isinstance(
                    exc, (TopologyMismatchError, OSError)):
                quarantined = self.quarantine_step(step, reason="corrupt")
            self._emit("ckpt_fallback", step=step,
                       error=f"{type(exc).__name__}: {exc}"[:500],
                       quarantined=(os.path.basename(quarantined)
                                    if quarantined else None))
            self._count("ckpt_fallback_total")
        if pending:
            self._barrier()

    def _raise_restore_failure(self, steps, template_state, last_exc):
        flat = state_dict(template_state)
        for step in steps:
            meta = self.read_sidecar(step)
            if meta is None:
                continue
            mismatch = describe_mismatch(meta, flat)
            if mismatch is not None:
                raise TopologyMismatchError(
                    f"no checkpoint under {self.directory!r} restores into "
                    f"the live state. Checkpoint step {step} was written on "
                    f"mesh {meta.get('mesh')} ({meta.get('device_count')} "
                    f"ranks); the live state's mesh is "
                    f"{topology_of(flat).get('mesh', 'none')}. Structural "
                    f"difference: {mismatch}. A mesh change alone is "
                    "resharded on load; this means the saved and live "
                    "trees disagree -- wrong model/config on relaunch?"
                ) from last_exc
            break
        raise last_exc

    # -- export ---------------------------------------------------------
    def export_consolidated(self, state: Any, path: str) -> str:
        """The whole state as one portable ``.npz`` (every rank takes
        part in the gather; rank 0 writes). 16-bit float leaves are
        widened to float32, numpy having no bfloat16."""
        flat = {}
        for k, t in state_dict(state).items():
            full = t.full_tensor() if hasattr(t, "full_tensor") else t
            full = full.detach().to("cpu")
            if full.is_floating_point() and full.element_size() < 4:
                full = full.float()
            flat[k] = full.numpy()
        if self._rank == 0:
            np.savez(path, **flat)
        return path
