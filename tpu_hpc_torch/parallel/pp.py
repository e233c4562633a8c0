"""Pipeline parallelism over a pipe axis: GPipe, 1F1B and the
interleaved (virtual-chunk) schedules.

Port of the JAX package's ``parallel/pp.py``. Stages are structural, as
there: every stage's params are stacked on a leading dim, and each pipe
rank holds its slice (``stage_pspecs``: ``P("pipe", ...)``). Embedding,
head and loss run outside the pipelined body, replicated over the pipe
axis. Stage functions are shape-preserving.

The JAX package writes each schedule as a ``shard_map`` tick loop: every
tick every stage runs ``stage_fn`` -- on zeros or stale data in the
bubbles, masked away after -- and hands its output on with one
``ppermute``. The port writes each schedule down once, as a table
(:func:`schedule_table`: ``(tick, stage, chunk, op, microbatch)`` for
every forward ``F`` and backward ``B`` op), and one driver walks any
table tick by tick, running only the ops the table holds and handing
their outputs on through a transport (``parallel.pp_transport``: a
process group, or every stage in one process). A stage therefore never
takes a bubble's output: every op's input is the output of the op the
table puts one tick before it, on the stage before it.

The ticks are the JAX programs':

  * forward, every schedule: microbatch ``f = q*S + r`` runs global
    stage ``g = j*S + s`` (pipe rank ``s``, chunk ``j``) at tick
    ``q*v*S + g + r`` -- ``f + s`` at ``v = 1`` (GPipe, 1F1B);
  * 1F1B and interleaved 1F1B, backward: at tick
    ``v*S + q*v*S + (v-1-j)*S + (S-1-s) + r`` -- ``2S-1-s + f`` at
    ``v = 1`` -- beside each forward op of the forward formula;
  * GPipe and interleaved (the JAX autodiff backward): the forward ops
    in reverse tick order, as the transposed scan runs them.

Within a tick a stage runs its backward op before its forward op (they
share no data), so a 1F1B stage holds at most ``2(S-s)-1`` saved inputs
or graphs between ticks.

What each schedule keeps is the JAX program's FLOPs and memory contract.
Every schedule is a ``torch.autograd.Function``: 1F1B's forward runs the
forward table without autograd and saves only ``(stacked params, xs)``,
as the JAX ``custom_vjp`` does; its backward walks the combined table:
``backward="remat"`` saves each microbatch's stage input in the forward
slot and recomputes the stage before its backward (5/3 of the ideal
FLOPs), ``"stash"`` keeps the forward slot's autograd graph, torch's
counterpart of the vjp residuals (4/3). GPipe and interleaved keep each
forward op's graph, as autodiff saves the scan's intermediates, and
their backward walks those graphs in reverse tick order;
``remat_stage`` builds each through ``torch.utils.checkpoint``
(non-reentrant), so only the stage input is kept and the backward
recomputes the stage. With a data axis (``batch_spec=P(None,
"data")``) each data rank runs its rows of every microbatch and the
stage gradients are summed over the data ranks (the JAX programs'
``grad_reduce_axes`` psum).
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, NamedTuple, Tuple

import torch

from tpu_hpc_torch.parallel.plans import P
from tpu_hpc_torch.parallel.pp_transport import InProcessPipe, ProcessGroupPipe
from tpu_hpc_torch.runtime.mesh import PIPE_AXIS

# stage_fn(stage_params, x_microbatch) -> y_microbatch (same shape)
StageFn = Callable[[Any, torch.Tensor], torch.Tensor]

SCHEDULES = ("gpipe", "1f1b", "interleaved", "interleaved-1f1b")
ONE_F_ONE_B = ("1f1b", "interleaved-1f1b")
INTERLEAVED = ("interleaved", "interleaved-1f1b")


class Op(NamedTuple):
    """One op of a schedule: ``op`` "F" (forward) or "B" (backward) of
    ``microbatch`` on pipe rank ``stage``'s chunk ``chunk`` at ``tick``."""

    tick: int
    stage: int
    chunk: int
    op: str
    microbatch: int


def bubble_fraction(
    n_stages: int, n_microbatches: int, n_chunks: int = 1
) -> float:
    """Exact idle fraction of the pipeline's tick programs: work is M*v
    ops per device over the forward program's ticks -- (S-1)/(M*v + S-1)
    when S divides M (and always at v=1), larger when a partial
    round-robin group adds dilated-tail ticks on the interleaved
    schedules."""
    S, M, V = n_stages, n_microbatches, n_chunks
    ticks = ((M - 1) // S) * S * V + S * V + (M - 1) % S
    return (ticks - M * V) / ticks


def forward_ticks(n_stages: int, n_microbatches: int,
                  n_chunks: int = 1) -> int:
    """Ticks of the forward program (the last forward op's tick + 1)."""
    S, M, V = n_stages, n_microbatches, n_chunks
    return ((M - 1) // S) * S * V + S * V + (M - 1) % S


def _check_chunks(schedule: str, n_chunks: int) -> None:
    if n_chunks != 1 and schedule not in INTERLEAVED:
        raise ValueError(
            f"n_chunks={n_chunks} only applies to the interleaved "
            f"schedules, got {schedule!r} -- a multi-chunk param stack "
            "under gpipe/1f1b would silently run wrong stages"
        )


def _check_schedule(schedule: str) -> None:
    if schedule not in SCHEDULES:
        raise ValueError(
            f"unknown schedule {schedule!r} "
            "(gpipe|1f1b|interleaved|interleaved-1f1b)"
        )


def schedule_table(schedule: str, n_stages: int, n_microbatches: int,
                   n_chunks: int = 1, program: str = "forward") -> List[Op]:
    """Every op of ``schedule``'s ``program`` ("forward" or "backward"),
    in the order the driver runs them: by tick, then stage, a stage's
    backward op before its forward op. The backward program of the 1F1B
    schedules holds the forward slot's ops beside the backward ones;
    GPipe's and interleaved's hold the backward ops alone."""
    _check_chunks(schedule, n_chunks)
    _check_schedule(schedule)
    if program not in ("forward", "backward"):
        raise ValueError(f"unknown program {program!r} (forward|backward)")
    S, M, V = n_stages, n_microbatches, n_chunks
    fwd, bwd = [], []
    for f in range(M):
        q, r = divmod(f, S)
        for s in range(S):
            for j in range(V):
                fwd.append(Op(q * V * S + j * S + s + r, s, j, "F", f))
                bwd.append(Op(V * S + q * V * S + (V - 1 - j) * S
                              + (S - 1 - s) + r, s, j, "B", f))
    if program == "forward":
        ops = fwd
    elif schedule in ONE_F_ONE_B:
        ops = fwd + bwd
    else:
        last = forward_ticks(S, M, V) - 1
        ops = [Op(last - o.tick, o.stage, o.chunk, "B", o.microbatch)
               for o in fwd]
    return sorted(ops, key=lambda o: (o.tick, o.stage, o.op))


def microbatch(x: torch.Tensor, n_microbatches: int) -> torch.Tensor:
    """[B, ...] -> [M, B/M, ...]."""
    if x.shape[0] % n_microbatches != 0:
        raise ValueError(
            f"batch {x.shape[0]} not divisible by {n_microbatches} microbatches"
        )
    return x.reshape(n_microbatches, x.shape[0] // n_microbatches,
                     *x.shape[1:])


def unmicrobatch(x: torch.Tensor) -> torch.Tensor:
    """[M, mb, ...] -> [B, ...]."""
    return x.reshape(x.shape[0] * x.shape[1], *x.shape[2:])


# ---------------------------------------------------------------------------
# Stacked stage params (dict trees, leaves in sorted key order)
# ---------------------------------------------------------------------------

def _flatten(tree, prefix=()) -> Tuple[List[tuple], List[Any]]:
    paths, leaves = [], []
    for key in sorted(tree):
        node = tree[key]
        if isinstance(node, dict):
            p, lv = _flatten(node, prefix + (key,))
            paths += p
            leaves += lv
        else:
            paths.append(prefix + (key,))
            leaves.append(node)
    return paths, leaves


def _unflatten(paths, leaves) -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    for path, leaf in zip(paths, leaves):
        node = out
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = leaf
    return out


def _tree_map(fn, tree):
    return {k: _tree_map(fn, v) if isinstance(v, dict) else fn(v)
            for k, v in tree.items()}


def stack_stage_params(per_stage: list) -> Any:
    """Stack a list of per-stage param trees on a new leading dim (to be
    sharded ``P(pipe_axis)``)."""
    paths, _ = _flatten(per_stage[0])
    cols = zip(*(_flatten(t)[1] for t in per_stage))
    return _unflatten(paths, [torch.stack(c) for c in cols])


def _interleave_order(n_stages: int, n_devices: int) -> List[int]:
    if n_stages % n_devices != 0:
        raise ValueError(
            f"{n_stages} stages not divisible by {n_devices} pipeline devices"
        )
    v = n_stages // n_devices
    return [j * n_devices + s for s in range(n_devices) for j in range(v)]


def stack_interleaved_stage_params(per_stage: list, n_devices: int) -> Any:
    """Stack v*S per-stage trees in the interleaved device layout:
    device s owns global stages {s, S+s, 2S+s, ...}, so position
    ``s*v + j`` holds global stage ``j*S + s``."""
    order = _interleave_order(len(per_stage), n_devices)
    return stack_stage_params([per_stage[g] for g in order])


def interleave_stacked(stacked: Any, n_devices: int) -> Any:
    """Reorder a sequentially stacked [L, ...] stage tree (position g =
    global stage g) into the interleaved device layout (position
    ``s*v + j`` = global stage ``j*S + s``)."""
    L = _flatten(stacked)[1][0].shape[0]
    order = _interleave_order(L, n_devices)
    return _tree_map(lambda a: a[torch.as_tensor(order, device=a.device)]
                     if isinstance(a, torch.Tensor) else a[order], stacked)


def stage_pspecs(stacked_params: Any, axis: str = PIPE_AXIS) -> Any:
    """Spec tree sharding the stacked leading dim over the pipe axis
    (each pipe rank holds its stages' weights)."""
    return _tree_map(lambda a: P(axis, *([None] * (a.ndim - 1))),
                     stacked_params)


# ---------------------------------------------------------------------------
# The driver
# ---------------------------------------------------------------------------

class _Engine:
    """Walks a schedule's tables for ``stage_fn`` over ``pipe``."""

    def __init__(self, stage_fn: StageFn, pipe, schedule: str,
                 n_chunks: int, remat_stage: bool, stash: bool):
        self.stage_fn, self.pipe = stage_fn, pipe
        self.schedule, self.V = schedule, n_chunks
        self.remat_stage, self.stash = remat_stage, stash
        self.paths: List[tuple] = []
        # Per local stage, the most saved stage inputs or graphs it held
        # between two ticks in the last backward.
        self.peak_live: Dict[int, int] = {}

    def _views(self, leaves, grad: bool) -> Dict[Tuple[int, int], tuple]:
        """(stage, chunk) -> (tree, leaves): this call's views of the
        stacked params; with ``grad`` detached leaves that collect the
        stage's gradient."""
        out = {}
        for i, s in enumerate(self.pipe.stages):
            for j in range(self.V):
                ls = [a[i * self.V + j] for a in leaves]
                if grad:
                    ls = [a.detach().requires_grad_() for a in ls]
                out[s, j] = (_unflatten(self.paths, ls), ls)
        return out

    def _walk(self, table, views, xs, ybar, fmode, saved, grads):
        """Run ``table``'s ops on this process's stages. ``fmode`` says
        what a forward op keeps: "none", "input" (for a remat backward),
        "graph" (its autograd graph) or "checkpoint" (a checkpointed
        graph). Returns the last global stage's outputs and global stage
        0's input cotangents by microbatch."""
        from torch.utils.checkpoint import checkpoint

        pipe, S, V = self.pipe, self.pipe.n, self.V
        G = S * V
        mine = [o for o in table if o.stage in pipe.stages]
        by_tick: Dict[int, List[Op]] = {}
        for o in mine:
            by_tick.setdefault(o.tick, []).append(o)
        n_ticks = max(o.tick for o in table) + 1
        inbox: Dict[Tuple[int, str], torch.Tensor] = {}
        ys, gxs = {}, {}
        live = {s: sum(1 for k in saved if k[0] == s) for s in pipe.stages}
        peak = dict(live)
        for t in range(n_ticks):
            sends = []
            for o in by_tick.get(t, ()):
                s, j, f = o.stage, o.chunk, o.microbatch
                g = j * S + s
                tree, ls = views[s, j]
                if o.op == "B":
                    gy = ybar[f] if g == G - 1 else inbox.pop((s, "bwd"))
                    keep = saved.pop((s, j, f))
                    live[s] -= 1
                    if isinstance(keep, tuple):
                        out, x = keep
                    else:
                        with torch.enable_grad():
                            x = keep.detach().requires_grad_()
                            out = self.stage_fn(tree, x)
                    gx, *pg = torch.autograd.grad(out, [x, *ls], gy,
                                                  allow_unused=True)
                    del out, keep
                    acc = grads.get((s, j))
                    pg = [torch.zeros_like(a) if d is None else d
                          for a, d in zip(ls, pg)]
                    grads[s, j] = pg if acc is None else [
                        a + d for a, d in zip(acc, pg)]
                    if g == 0:
                        gxs[f] = gx
                    else:
                        sends.append(((s - 1) % S, "bwd", gx))
                    continue
                x = xs[f] if g == 0 else inbox.pop((s, "fwd"))
                if fmode in ("graph", "checkpoint"):
                    with torch.enable_grad():
                        xg = x.detach().requires_grad_()
                        out = (checkpoint(self.stage_fn, tree, xg,
                                          use_reentrant=False)
                               if fmode == "checkpoint"
                               else self.stage_fn(tree, xg))
                    saved[s, j, f] = (out, xg)
                    out = out.detach()
                else:
                    if fmode == "input":
                        saved[s, j, f] = x
                    with torch.no_grad():
                        out = self.stage_fn(tree, x)
                if fmode != "none":
                    live[s] += 1
                if g == G - 1:
                    ys[f] = out
                else:
                    sends.append(((s + 1) % S, "fwd", out))
            recvs = []
            for o in by_tick.get(t + 1, ()):
                g = o.chunk * S + o.stage
                if o.op == "F" and g > 0:
                    recvs.append((o.stage, (o.stage - 1) % S, "fwd"))
                elif o.op == "B" and g < G - 1:
                    recvs.append((o.stage, (o.stage + 1) % S, "bwd"))
            if sends or recvs:
                inbox.update(pipe.exchange(sends, recvs, xs[0]))
            for s in pipe.stages:
                peak[s] = max(peak[s], live[s])
        self.peak_live = peak
        return ys, gxs

    def _stacked(self, by_mb: Dict[int, torch.Tensor], src: int, like):
        mine = src in self.pipe.stages
        t = torch.stack([by_mb[f] for f in range(like.shape[0])]) \
            if mine else None
        return self.pipe.from_stage(t, src, like)

    def forward(self, xs, leaves):
        S, M = self.pipe.n, xs.shape[0]
        table = schedule_table(self.schedule, S, M, self.V, "forward")
        autodiff = self.schedule not in ONE_F_ONE_B
        views = self._views(leaves, grad=autodiff)
        fmode = ("checkpoint" if self.remat_stage else "graph") \
            if autodiff else "none"
        saved: dict = {}
        ys, _ = self._walk(table, views, xs, None, fmode, saved, {})
        state = (views, saved) if autodiff else None
        return self._stacked(ys, S - 1, xs), state

    def backward(self, xs, leaves, ybar, state):
        S, M = self.pipe.n, xs.shape[0]
        table = schedule_table(self.schedule, S, M, self.V, "backward")
        if state is None:  # 1F1B: the combined program
            views, saved = self._views(leaves, grad=True), {}
            fmode = "graph" if self.stash else "input"
        else:
            (views, saved), fmode = state, "none"
        grads: dict = {}
        _, gxs = self._walk(table, views, xs, ybar, fmode, saved, grads)
        stacked = [
            torch.stack([grads[s, j][k] for s in self.pipe.stages
                         for j in range(self.V)])
            for k in range(len(leaves))]
        return (self._stacked(gxs, 0, xs),
                self.pipe.reduce_grads(stacked))


class _Pipeline(torch.autograd.Function):
    """The pipelined body: ``ys = pipe(stacked, xs)``. The forward saves
    the stacked params and xs (and, for the autodiff schedules, each
    forward op's graph); the backward walks the schedule's backward
    table."""

    @staticmethod
    def forward(ctx, engine, xs, *leaves):
        xs_local = engine.pipe.rows(xs)
        ys, state = engine.forward(xs_local, leaves)
        ctx.engine, ctx.state = engine, state
        ctx.save_for_backward(xs_local, *leaves)
        return engine.pipe.gather_rows(ys)

    @staticmethod
    def backward(ctx, ybar):
        xs, *leaves = ctx.saved_tensors
        engine, state = ctx.engine, ctx.state
        ctx.state = None
        gxs, grads = engine.backward(
            xs, leaves, engine.pipe.rows(ybar.contiguous()), state)
        return (None, engine.pipe.gather_rows(gxs), *grads)


def _transport(mesh, axis: str, batch_spec: P):
    """The transport for ``mesh``: a transport as given, or the pipe
    (and data) groups of a ``DeviceMesh``."""
    data_axes = [a for a in batch_spec if a is not None]
    if data_axes and (len(batch_spec) != 2 or batch_spec[0] is not None
                      or not isinstance(batch_spec[1], str)):
        raise ValueError(
            f"batch_spec {batch_spec}: the port splits only the microbatch "
            "rows, P() or P(None, <data axis>)")
    if isinstance(mesh, (InProcessPipe, ProcessGroupPipe)):
        if data_axes:
            raise ValueError(
                f"batch_spec {batch_spec} needs a DeviceMesh naming "
                f"{data_axes[0]!r}, not a transport")
        return mesh
    return ProcessGroupPipe.from_mesh(mesh, axis,
                                      data_axes[0] if data_axes else None)


def pipe_size(mesh: Any, axis: str = PIPE_AXIS) -> int:
    """Stages of ``mesh``'s pipe axis (a ``DeviceMesh``) or of a
    transport."""
    if isinstance(mesh, (InProcessPipe, ProcessGroupPipe)):
        return mesh.n
    return mesh[axis].size()


def pipelined(
    stage_fn: StageFn,
    mesh: Any,
    axis: str = PIPE_AXIS,
    schedule: str = "gpipe",
    batch_spec: P = P(),
    n_chunks: int = 1,
    remat_stage: bool = False,
    backward: str = "remat",
):
    """Build ``fn(stacked_params, xs) -> ys``: the pipelined,
    differentiable forward over ``mesh``'s axis ``axis`` -- a
    ``DeviceMesh`` (this process is one stage) or a transport
    (``pp_transport.InProcessPipe(S)``: every stage here).

    ``stacked_params``: this process's stages' params stacked on dim 0
    (the pipe rank's slice of the ``[S*v, ...]`` stack, or all of it in
    one process); ``xs``: ``[M, mb, ...]`` microbatched activations,
    the same on every stage. ``schedule``: "gpipe", "1f1b",
    "interleaved" (``n_chunks`` virtual chunks per stage; stack with
    :func:`interleave_stacked`) or "interleaved-1f1b". ``remat_stage``
    checkpoints each stage on the autodiff schedules (gpipe,
    interleaved); ``backward`` is the 1F1B schedules' "remat" or
    "stash" (see the module docstring). ``batch_spec``: ``P()``, or
    ``P(None, "data")`` to split each microbatch's rows over the mesh's
    data axis."""
    _check_chunks(schedule, n_chunks)
    if backward not in ("remat", "stash"):
        raise ValueError(
            f"unknown backward {backward!r} (remat|stash)"
        )
    if backward != "remat" and schedule not in ONE_F_ONE_B:
        raise ValueError(
            f"backward={backward!r} only applies to the 1f1b "
            f"schedules, got {schedule!r} -- gpipe/interleaved use "
            "autodiff backward"
        )
    if remat_stage and schedule in ONE_F_ONE_B:
        raise ValueError(
            f"remat_stage has no effect under schedule={schedule!r}: "
            "the 1f1b custom_vjp already rematerialises each stage's "
            "forward in its backward pass -- drop the flag"
        )
    _check_schedule(schedule)
    engine = _Engine(stage_fn, _transport(mesh, axis, batch_spec), schedule,
                     n_chunks, remat_stage, backward == "stash")

    def fn(stacked, xs):
        paths, leaves = _flatten(stacked)
        local = leaves[0].shape[0] // len(engine.pipe.stages)
        if local * len(engine.pipe.stages) != leaves[0].shape[0] \
                or local != n_chunks:
            raise ValueError(
                f"stacked stage params have {local} chunks per "
                f"device, schedule was built with n_chunks="
                f"{n_chunks}; stack with "
                f"stack_interleaved_stage_params/interleave_stacked"
            )
        engine.paths = paths
        return _Pipeline.apply(engine, xs, *leaves)

    fn.engine = engine
    return fn


def manual_stage_step(mesh: Any, axis: str = PIPE_AXIS
                      ) -> Callable[[List[torch.Tensor]], List[torch.Tensor]]:
    """One explicit activation hand-off to the next stage: each stage's
    tensor (a list, one per stage this process plays) moves to stage
    + 1, and stage 0 gets zeros -- the JAX ``ppermute`` hop."""
    pipe = _transport(mesh, axis, P())

    def shift(xs: List[torch.Tensor]) -> List[torch.Tensor]:
        sends = [(s + 1, "fwd", x) for s, x in zip(pipe.stages, xs)
                 if s + 1 < pipe.n]
        recvs = [(s, s - 1, "fwd") for s in pipe.stages if s > 0]
        got = pipe.exchange(sends, recvs, xs[0])
        return [got[s, "fwd"] if s > 0 else torch.zeros_like(x)
                for s, x in zip(pipe.stages, xs)]

    return shift


__all__ = [
    "Op",
    "SCHEDULES",
    "bubble_fraction",
    "forward_ticks",
    "interleave_stacked",
    "manual_stage_step",
    "microbatch",
    "pipe_size",
    "pipelined",
    "schedule_table",
    "stack_interleaved_stage_params",
    "stack_stage_params",
    "stage_pspecs",
    "unmicrobatch",
]
