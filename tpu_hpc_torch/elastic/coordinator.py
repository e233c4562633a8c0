"""The topology coordinator: grow/shrink a training run with no restart.

Port of the JAX package's ``elastic/coordinator.py``. A planned
topology change is a live transition, not a snapshot-exit-relaunch::

    coord = TopologyCoordinator(
        trainer_factory,            # callable(DeviceMesh) -> Trainer
        global_batch=cfg.global_batch_size,
        data_extent=2,              # sustainable across the storm
    )
    summary = coord.run(dataset)

On a morph event -- a ``slice_down_at_step``/``slice_up_at_step`` chaos
fault (``slice_down`` keeps the first half of the rank pool,
``slice_up`` restores all of it) or a request on the morph channel
(resilience.signals.MorphChannel) -- the coordinator:

1. **quiesces** the running Trainer at the first step boundary at or
   past the event's step (the trainer's ``quiesce_check`` hook caps its
   chunk to land exactly there; nothing is saved, nothing exits);
2. **chooses the target layout** for the new rank set
   (:func:`tpu_hpc_torch.elastic.layout.choose_layout`; the data-axis
   extent is preserved whenever legal, which keeps the loss stream
   bit-identical across the morph);
3. **morphs live**: builds the new ``DeviceMesh`` over the surviving
   ranks and a Trainer on it, moves params, optimizer state and the
   step through the bounded reshard engine
   (``max_inflight_bytes="auto"``: one batched P2P exchange per stage
   between the old and the new layout) and hands the result to the new
   Trainer's ``adopt_state`` -- the in-memory step stays the data
   stream's truth;
4. **resumes** ``fit`` on the new topology.

Zero restarts, one pid per rank. PyTorch runs one process per card, so
the JAX "one process, no restart" becomes: every rank of the process
group runs this coordinator and KEEPS ITS PID through every morph.
Ranks outside the live mesh do not exit -- they wait at the coordinator
(in the collective that announces the next event) for the grow that
brings them back, and take part in each morph's exchange: sending
their shards on a shrink, receiving on a grow. A completed morph burns
none of the supervisor's budgets; every morph emits a
``topology_morph`` record (wire bytes, stall seconds, layout decision,
trace id), a ``morph`` span, and appends to the checkpoint directory's
topology history. On a pool of one rank both storm events are 1 -> 1
(``max(n // 2, 1)``, as in JAX): the morph still quiesces, rebuilds
the mesh and trainer and moves the state, where JAX refuses a
same-count morph on a larger pool and so does this port.

Chaos discipline, both directions: a Trainer outside this coordinator
refuses armed slice faults (it cannot morph); this coordinator
hard-FAILS a run that ends with an armed slice fault that never fired.
"""
from __future__ import annotations

import os
import time
from typing import Any, Callable, Dict, List, Optional, Sequence

import torch

from tpu_hpc_torch import obs
from tpu_hpc_torch.elastic.layout import choose_layout
from tpu_hpc_torch.resilience.faults import fault_plan_from_env
from tpu_hpc_torch.resilience.signals import ENV_ELASTIC_MANAGED, MorphChannel


def _dist():
    import torch.distributed as dist

    return dist


def _world() -> int:
    dist = _dist()
    return dist.get_world_size() if dist.is_initialized() else 1


def _rank() -> int:
    dist = _dist()
    return dist.get_rank() if dist.is_initialized() else 0


def build_rank_mesh(axes: Dict[str, int], ranks: Sequence[int],
                    device_type: str):
    """A ``DeviceMesh`` with ``axes`` over ``ranks``, row-major but for a
    ``replica`` axis, which is outermost in rank order: each prefix of
    ``ranks`` that the pool's shrink keeps is whole replicas, so the
    surviving ranks already hold every data shard and a shrink moves
    only what a replica lacks. Every rank of the process group must call
    it (its sub-groups are made collectively); ranks outside it get a
    mesh they do not belong to."""
    from torch.distributed.device_mesh import DeviceMesh

    names = list(axes)
    order = (["replica"] + [a for a in names if a != "replica"]
             if "replica" in axes else names)
    mesh = torch.tensor(list(ranks), dtype=torch.int64).reshape(
        tuple(int(axes[a]) for a in order))
    mesh = mesh.permute(*(order.index(a) for a in names)).contiguous()
    return DeviceMesh(device_type, mesh, mesh_dim_names=tuple(names))


def state_layout(trainer) -> tuple:
    """``(abstract, local)`` trees of a trainer's live state: the
    abstract tree's leaves are ``reshard.TensorSpec`` (global shape,
    dtype, sharding over the trainer's whole mesh), the local tree's are
    this rank's shards. Moments share their param's sharding; the step,
    counts and scalar state are host values (the ``place`` kind)."""
    from tpu_hpc_torch.parallel.plans import P
    from tpu_hpc_torch.parallel.shard import is_dtensor, local
    from tpu_hpc_torch.reshard.plan import (
        Mesh,
        Sharding,
        TensorSpec,
        sharding_of_dtensor,
    )
    from tpu_hpc_torch.train.trainer import tree_leaves, tree_paths

    state = trainer.state
    mesh = (Mesh.from_device_mesh(trainer.mesh) if trainer.mesh is not None
            else Mesh.of_ranks({}, [_rank()]))

    def sharding_of(t) -> Sharding:
        if not is_dtensor(t):
            return Sharding(mesh, P())
        spec = sharding_of_dtensor(t).spec
        return Sharding(mesh, spec)

    params = tree_leaves(state.params)
    paths = tree_paths(state.params)
    shardings = [sharding_of(p) for p in params]

    def nest(leaves):
        tree: dict = {}
        for path, leaf in zip(paths, leaves):
            node = tree
            for key in path[:-1]:
                node = node.setdefault(key, {})
            node[path[-1]] = leaf
        return tree

    abstract = {"step": int(state.step),
                "params": nest([TensorSpec(tuple(p.shape), p.dtype, sh)
                                for p, sh in zip(params, shardings)]),
                "opt_state": {}, "model_state": {}}
    loc = {"step": int(state.step),
           "params": nest([local(p).detach() for p in params]),
           "opt_state": {}, "model_state": {}}
    for name, value in state.opt_state.items():
        if isinstance(value, list):
            abstract["opt_state"][name] = [
                TensorSpec(tuple(p.shape), v.dtype, sh)
                for p, v, sh in zip(params, value, shardings)]
            loc["opt_state"][name] = list(value)
        elif isinstance(value, torch.Tensor):
            abstract["opt_state"][name] = TensorSpec(
                tuple(value.shape), value.dtype, Sharding(mesh, P()))
            loc["opt_state"][name] = value
        else:
            abstract["opt_state"][name] = int(value)
            loc["opt_state"][name] = int(value)
    ms = state.model_state or {}
    for path, leaf in zip(tree_paths(ms), tree_leaves(ms)):
        key = "/".join(path)
        abstract["model_state"][key] = TensorSpec(
            tuple(leaf.shape), leaf.dtype, Sharding(mesh, P()))
        loc["model_state"][key] = leaf
    return abstract, loc


def state_targets(abstract) -> Any:
    """The shardings of an abstract state tree (:func:`state_layout`'s),
    to plan a move onto that layout; host scalars land replicated on
    the mesh of the first tensor."""
    from tpu_hpc_torch.parallel.plans import P
    from tpu_hpc_torch.reshard.plan import (
        Sharding,
        TensorSpec,
        tree_flatten_with_path,
        tree_unflatten,
    )

    leaves, treedef = tree_flatten_with_path(abstract)
    mesh = next(leaf.sharding.mesh for _, leaf in leaves
                if isinstance(leaf, TensorSpec))
    return tree_unflatten(treedef, [
        leaf.sharding if isinstance(leaf, TensorSpec)
        else Sharding(mesh, P()) for _, leaf in leaves])


def _to_state(tree) -> Any:
    from tpu_hpc_torch.train.trainer import TrainState

    def scalar(v):
        return int(v) if isinstance(v, torch.Tensor) and v.dim() == 0 \
            and not v.is_floating_point() else v

    opt = {k: scalar(v) if not isinstance(v, list) else v
           for k, v in tree["opt_state"].items()}
    ms: dict = {}
    for key, leaf in tree["model_state"].items():
        node = ms
        *parents, last = key.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[last] = leaf
    return TrainState(int(tree["step"]), tree["params"], opt, ms)


class TopologyCoordinator:
    """Runs a Trainer through planned topology transitions, on every
    rank of the process group.

    ``trainer_factory``: callable(DeviceMesh) -> Trainer, called on the
    ranks of each new mesh, every Trainer from the same config and
    dataset contract. ``devices``: the FULL rank pool (default: every
    rank of the process group) -- shrink events keep a prefix of it,
    grow events extend back toward it. ``data_extent``: pin the data
    axis to this extent on every layout (must divide every rank count
    the run morphs through). ``checkpoint_dir``: where the topology
    history lands (default: none recorded). ``device_type``: where the
    trainers run (default: cuda when a card is visible).
    """

    def __init__(
        self,
        trainer_factory: Callable[[Any], Any],
        *,
        global_batch: int,
        devices: Optional[Sequence[int]] = None,
        data_extent: Optional[int] = None,
        table_dir: Optional[str] = None,
        checkpoint_dir: Optional[str] = None,
        channel: Optional[MorphChannel] = None,
        sink: Optional[str] = None,
        device_type: Optional[str] = None,
    ):
        self.trainer_factory = trainer_factory
        self.global_batch = int(global_batch)
        self.all_devices = list(devices if devices is not None
                                else range(_world()))
        self.data_extent = data_extent
        self.table_dir = table_dir
        self.checkpoint_dir = checkpoint_dir
        self.channel = channel or MorphChannel.from_env()
        self.sink = sink
        self.device_type = device_type or (
            "cuda" if torch.cuda.is_available() else "cpu")
        self.fault_plan = fault_plan_from_env()
        self._consumed_faults: set = set()
        self.morphs: List[dict] = []
        self.pid = os.getpid()
        # The live Trainer of the CURRENT segment on this rank (None on
        # a rank outside the live mesh).
        self.trainer: Optional[Any] = None
        self._live: List[int] = []
        self._axes: Dict[str, int] = {}
        self._live_group = None

    # -- event sources -------------------------------------------------
    def _fault_events(self) -> List[dict]:
        """Slice-chaos events still to fire (the two-slice pod model:
        slice_down keeps the surviving half of the pool, slice_up
        restores the full set)."""
        plan = self.fault_plan
        if plan is None or not plan.active:
            return []
        half = max(len(self.all_devices) // 2, 1)
        events = []
        if (plan.slice_down_at_step is not None
                and "slice_down" not in self._consumed_faults):
            events.append({
                "kind": "shrink", "fault": "slice_down",
                "n_devices": half, "step": plan.slice_down_at_step,
                "source": "fault",
            })
        if (plan.slice_up_at_step is not None
                and "slice_up" not in self._consumed_faults):
            events.append({
                "kind": "grow", "fault": "slice_up",
                "n_devices": len(self.all_devices),
                "step": plan.slice_up_at_step, "source": "fault",
            })
        return events

    def _next_event(self) -> Optional[dict]:
        """The earliest un-honored morph event, chaos or channel."""
        events = self._fault_events()
        if self.channel is not None:
            for req in self.channel.pending():
                events.append({
                    "kind": req.kind, "n_devices": req.n_devices,
                    "step": req.step, "source": "channel", "seq": req.seq,
                })
        if not events:
            return None
        return min(events, key=lambda e: (e["step"], e["kind"]))

    def _quiesce_check(self, done: int) -> Optional[int]:
        """The Trainer's quiesce hook: the step boundary the earliest
        pending event wants (never before the event's step, never
        before where the run already is). With a channel the live ranks
        agree on it (the earliest any of them has seen), since they
        read the channel file at different moments."""
        ev = self._next_event()
        target = None if ev is None else max(int(ev["step"]), int(done))
        if self.channel is not None and _world() > 1:
            dist = _dist()
            t = torch.tensor([float("inf") if target is None else target],
                             dtype=torch.float64,
                             device=self.trainer.device)
            dist.all_reduce(t, op=dist.ReduceOp.MIN, group=self._live_group)
            v = t.item()
            target = None if v == float("inf") else int(v)
        return target

    # -- the run loop --------------------------------------------------
    def run(self, dataset, epochs: Optional[int] = None) -> Dict:
        """Train to completion through every morph event, on every rank.
        Returns the same summary on every rank (but ``pid``): the fit
        segments, the morph records, total wire bytes and stall seconds,
        and the zero-restart evidence (this rank's pid, restarts=0)."""
        prev = os.environ.get(ENV_ELASTIC_MANAGED)
        os.environ[ENV_ELASTIC_MANAGED] = "1"
        try:
            return self._run(dataset, epochs)
        finally:
            if prev is None:
                os.environ.pop(ENV_ELASTIC_MANAGED, None)
            else:
                os.environ[ENV_ELASTIC_MANAGED] = prev

    def _build(self, devices, state=None, current_extent=None):
        """Layout decision -> DeviceMesh over ``devices`` (built on every
        rank) -> a Trainer on the mesh's ranks (None elsewhere)."""
        decision = choose_layout(
            devices, global_batch=self.global_batch, state=state,
            current_data_extent=(self.data_extent
                                 if self.data_extent is not None
                                 else current_extent),
            table_dir=self.table_dir, device_type=self.device_type,
        )
        mesh = build_rank_mesh(decision.axes, devices, self.device_type)
        self._live_group = None
        if _world() > 1 and len(devices) < _world():
            from tpu_hpc_torch.runtime.mesh import register_mesh_group

            # Every rank makes the live ranks' group (new_group is
            # collective); the trainer's reductions run on it.
            self._live_group = _dist().new_group(list(devices))
            register_mesh_group(devices, self._live_group)
        trainer = None
        if _rank() in devices:
            trainer = self.trainer_factory(mesh)
            trainer.quiesce_check = self._quiesce_check
        self._live = list(devices)
        self._axes = dict(decision.axes)
        return decision, trainer

    def _announce(self, payload, src: int = 0):
        """Broadcast one picklable payload from ``src`` to every rank
        (the collective idle ranks wait in)."""
        if _world() == 1:
            return payload
        box = [payload]
        _dist().broadcast_object_list(box, src=src)
        return box[0]

    def _run(self, dataset, epochs) -> Dict:
        _, trainer = self._build(list(self.all_devices))
        segments: List[dict] = []
        while True:
            self.trainer = trainer
            seg = None
            if trainer is not None:
                result = trainer.fit(dataset, epochs=epochs)
                seg = {"n_devices": len(self._live),
                       "axes": dict(self._axes), "fit": result}
            # Rank 0 is always live (a shrink keeps the first half):
            # it announces the segment and what comes next. Idle ranks
            # wait here for the grow.
            seg, ev = self._announce(
                (seg, self._next_event() if seg and seg["fit"].get(
                    "quiesced") else None))
            segments.append(seg)
            if not seg["fit"].get("quiesced"):
                break
            if ev is None:  # pragma: no cover - hook/event race
                break
            trainer = self._morph(trainer, ev)
        leftover = [e["fault"] for e in self._fault_events()]
        if leftover:
            raise RuntimeError(
                f"TPU_HPC_FAULTS armed slice fault(s) "
                f"{', '.join(leftover)} that never fired -- the run "
                "ended before their step; refusing to let a chaos "
                "schedule pass vacuously"
            )
        return {
            "segments": segments,
            "morphs": list(self.morphs),
            "morph_count": len(self.morphs),
            "wire_bytes": sum(m["wire_bytes"] for m in self.morphs),
            "stall_s": round(sum(m["stall_s"] for m in self.morphs), 6),
            "restarts": 0,
            "pid": self.pid,
            "final_loss": segments[-1]["fit"]["final_loss"],
            "preempted": segments[-1]["fit"].get("preempted", False),
        }

    # -- one transition ------------------------------------------------
    def _morph(self, old_trainer, ev: dict):
        from tpu_hpc_torch.reshard import plan_reshard
        from tpu_hpc_torch.reshard.elastic import append_topology_history

        n_target = int(ev["n_devices"])
        n_current = len(self._live)
        if n_target == n_current and len(self.all_devices) > 1:
            raise RuntimeError(
                f"morph event {ev} targets the current device count "
                f"({n_current}) -- a no-op transition cannot inject; "
                "refusing to ack it"
            )
        if n_target > len(self.all_devices):
            raise RuntimeError(
                f"morph event {ev} wants {n_target} devices but the "
                f"pool holds {len(self.all_devices)}"
            )
        first = self._live[0]
        abstract = local_state = None
        sink = self.sink
        if old_trainer is not None:
            abstract, local_state = state_layout(old_trainer)
            if sink is None:
                sink = old_trainer._sink()
        # The source layout, the same on every rank (idle ranks hold no
        # trainer to read it from).
        abstract = self._announce(abstract, src=first)
        step = int(abstract["step"])
        src_axes = dict(self._axes)
        seq = len(self.morphs)
        tid = obs.step_trace_id(step)
        if ev["source"] == "fault":
            obs.get_bus().emit("fault", sink=sink, kind=ev["fault"],
                               step=step, trace_id=tid)
        t0 = time.perf_counter()
        devices = self.all_devices[:n_target]
        decision, new_trainer = self._build(
            devices, state=abstract,
            current_extent=int(src_axes.get("data", 1)))
        new_abstract = None
        if new_trainer is not None:
            new_abstract, _ = state_layout(new_trainer)
        new_abstract = self._announce(new_abstract, src=devices[0])
        plan = plan_reshard(abstract, state_targets(new_abstract),
                            max_inflight_bytes="auto", label=f"morph{seq}")
        device = (old_trainer.device if old_trainer is not None else
                  new_trainer.device if new_trainer is not None else None)
        morphed = plan.execute(local_state if local_state is not None
                               else _empty_like(abstract),
                               donate=True, sink=sink, device=device)
        del local_state
        if new_trainer is not None:
            new_trainer.adopt_state(_to_state(morphed))
        if old_trainer is not None:
            old_trainer.quiesce_check = None
        if _world() > 1:
            _dist().barrier()
        stall_s = time.perf_counter() - t0
        obs.emit_span("morph", stall_s, sink=sink, step=step, trace_id=tid)
        rec = {
            "event": "topology_morph",
            "step": step,
            "trace_id": tid,
            "src_mesh": src_axes,
            "tgt_mesh": dict(decision.axes),
            "wire_bytes": int(plan.wire_bytes),
            "stall_s": round(stall_s, 6),
            "reason": ev["kind"],
            "n_devices_from": n_current,
            "n_devices_to": n_target,
            "morph_seq": seq,
            "preserved_data_extent": decision.preserved_data_extent,
            "compiled_programs": int(plan.compiled_program_count),
            "plan": decision.summary(),
        }
        if plan.predicted_cost_s is not None:
            rec["predicted_cost_s"] = round(plan.predicted_cost_s, 6)
        obs.get_bus().emit_record(rec, sink=sink)
        if self.checkpoint_dir:
            append_topology_history(
                self.checkpoint_dir, step,
                {"mesh": dict(decision.axes), "device_count": n_target},
                reason=f"morph-{ev['kind']}",
            )
        if ev["source"] == "channel" and self.channel is not None:
            if _rank() == 0:
                self.channel.ack(
                    ev["seq"], step=step, wire_bytes=int(plan.wire_bytes),
                    stall_s=round(stall_s, 6),
                    tgt_mesh=dict(decision.axes),
                )
            if _world() > 1:
                _dist().barrier()  # the ack lands before anyone reads
        elif ev["source"] == "fault":
            self._consumed_faults.add(ev["fault"])
        self.morphs.append({
            "seq": seq,
            "step": step,
            "kind": ev["kind"],
            "source": ev["source"],
            "src_mesh": src_axes,
            "tgt_mesh": dict(decision.axes),
            "wire_bytes": int(plan.wire_bytes),
            "stall_s": round(stall_s, 6),
            "preserved_data_extent": decision.preserved_data_extent,
            "compiled_programs": int(plan.compiled_program_count),
        })
        return new_trainer


def _empty_like(abstract):
    """A rank outside the source mesh holds nothing: None per tensor
    leaf, the host values as they are."""
    from tpu_hpc_torch.reshard.plan import (
        TensorSpec,
        tree_flatten_with_path,
        tree_unflatten,
    )

    leaves, treedef = tree_flatten_with_path(abstract)
    return tree_unflatten(treedef, [
        None if isinstance(leaf, TensorSpec) else leaf
        for _, leaf in leaves])
