"""Communication/compute overlap: bucketed gradient sync and pipelined
parameter gathers.

Port of the JAX package's ``comm/overlap.py``.

* **Bucketed gradient synchronization** -- the DDP idiom: params
  replicated, each rank's gradient reduced in size-capped buckets
  (:func:`assign_buckets`, the JAX assignment index for index), each
  bucket's collective launched as soon as its last gradient has
  accumulated, so it runs under the rest of the backward.
  :class:`GradSync` does it with ``register_post_accumulate_grad_hook``:
  a bucket's gradients are copied into its flat buffer as they land,
  and the bucket is reduced -- one all-reduce (``bucketed_overlap``) or
  the two-phase decomposition (``hierarchical``: inner reduce-scatter,
  dcn all-reduce, inner all-gather) -- in ONE order shared by every
  rank: the order the buckets became ready on the first update, rank
  0's, broadcast (before that order exists, the first update launches
  after its backward). The synced gradients are views into the bucket
  buffers (copied in, never copied out).
* **Gradient accumulation** syncs once, on the last microbatch (DDP's
  ``no_sync``): the JAX step syncs every microbatch, which equals
  syncing the sum (the reduction is linear) up to the fp32 summation
  order.
* **ppermute-pipelined all-gather / gather-matmul** -- the
  collective-matmul decomposition: ``y = x @ W`` with ``W`` sharded on
  dim 0 over an axis, computed around a ring whose next hop is posted
  (one ``batch_isend_irecv``) before the partial product of the shard in
  hand, so the transfer runs under the matmul. The partial products are
  ``torch.matmul`` -- the JAX package computes them in XLA, not in a
  Pallas kernel.
"""
from __future__ import annotations

import math
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from tpu_hpc_torch.comm.hierarchical import groups_for, psum_two_phase
from tpu_hpc_torch.comm.primitives import (
    axis_group,
    global_rank,
    group_rank,
    group_size,
)

# DDP's default bucket cap (the JAX package's too).
DEFAULT_BUCKET_BYTES = 25 * 2 ** 20

MANUAL_MODES = ("bucketed_overlap", "hierarchical")


def sync_axes_from_batch_pspec(batch_pspec) -> Tuple[str, ...]:
    """The mesh axes a gradient sync must reduce over: every axis the
    batch's leading dim shards across. ``P('data')`` -> ('data',);
    ``P(('dcn', 'data'))`` -> ('dcn', 'data') -- for hierarchical mode
    the outer name is the across-node tier (slowest)."""
    from tpu_hpc_torch.parallel.plans import P, tree_specs

    specs = [batch_pspec] if isinstance(batch_pspec, P) \
        else tree_specs(batch_pspec)
    axes: List[str] = []
    for spec in specs:
        if len(spec) == 0 or spec[0] is None:
            continue
        entry = spec[0]
        for name in (entry if isinstance(entry, tuple) else (entry,)):
            if name not in axes:
                axes.append(name)
    if not axes:
        raise ValueError(
            f"batch pspec {batch_pspec} shards the batch over no mesh "
            "axis; manual gradient sync has nothing to reduce over"
        )
    return tuple(axes)


def _dtype_key(dtype) -> str:
    """One name per dtype for torch and numpy alike ("float32")."""
    if isinstance(dtype, torch.dtype):
        return str(dtype).replace("torch.", "")
    return np.dtype(dtype).name


def _itemsize(dtype) -> int:
    if isinstance(dtype, torch.dtype):
        return torch.empty((), dtype=dtype).element_size()
    return np.dtype(dtype).itemsize


def assign_buckets(leaves: Sequence[Any], bucket_bytes: int) -> List[List[int]]:
    """Partition leaf indices into size-capped, dtype-homogeneous
    buckets, walking the leaves in REVERSE order -- the DDP convention
    (backward produces the last layers' gradients first). Every bucket
    holds >= 1 leaf (a leaf over the cap gets its own bucket); a dtype
    change always cuts a bucket. ``leaves``: anything with ``shape`` and
    ``dtype`` (tensors, numpy arrays), in the param tree's leaf order."""
    if bucket_bytes <= 0:
        raise ValueError(f"bucket_bytes must be > 0, got {bucket_bytes}")
    buckets: List[List[int]] = []
    cur: List[int] = []
    cur_bytes = 0
    cur_dtype = None
    for i in reversed(range(len(leaves))):
        leaf = leaves[i]
        key = _dtype_key(leaf.dtype)
        nbytes = int(math.prod(leaf.shape)) * _itemsize(leaf.dtype)
        if cur and (key != cur_dtype or cur_bytes + nbytes > bucket_bytes):
            buckets.append(cur)
            cur, cur_bytes = [], 0
        cur.append(i)
        cur_bytes += nbytes
        cur_dtype = key
    if cur:
        buckets.append(cur)
    return buckets


def _check_mode(mode: str, sync_axes: Tuple[str, ...]) -> None:
    if mode not in MANUAL_MODES:
        raise ValueError(f"unknown manual sync mode {mode!r}; expected one "
                         f"of {MANUAL_MODES}")
    if mode == "hierarchical" and len(sync_axes) != 2:
        raise ValueError(
            f"hierarchical sync needs exactly two sync axes "
            f"(dcn, ici); the batch shards over {sync_axes}"
        )


def sync_group(mesh: Any, sync_axes: Tuple[str, ...]):
    """The process group over every sync axis at once (one axis: its
    group; several: the mesh's dims flattened)."""
    if len(sync_axes) == 1:
        return axis_group(mesh, sync_axes[0])
    return mesh[tuple(sync_axes)]._flatten("_".join(sync_axes)).get_group()


def shard_index(mesh: Any, sync_axes: Tuple[str, ...]) -> int:
    """This rank's linear position over the sync axes (outer slowest),
    the index the JAX step folds into its rng."""
    idx = 0
    for ax in sync_axes:
        idx = idx * mesh.size(mesh.mesh_dim_names.index(ax)) \
            + mesh.get_local_rank(ax)
    return idx


def _extent(mesh: Any, sync_axes: Tuple[str, ...]) -> int:
    return math.prod(mesh.size(mesh.mesh_dim_names.index(a))
                     for a in sync_axes)


class _Reducer:
    """One bucket vector's reduction over the sync axes, the mode's way
    (the sum; the caller divides)."""

    def __init__(self, mesh: Any, sync_axes: Tuple[str, ...], mode: str):
        _check_mode(mode, sync_axes)
        self.mode = mode
        self.sync_axes = tuple(sync_axes)
        self.n_total = _extent(mesh, self.sync_axes)
        self.group = sync_group(mesh, self.sync_axes)
        self.two = groups_for(mesh, self.sync_axes) \
            if mode == "hierarchical" else None

    def reduce(self, vec: torch.Tensor, async_op: bool = False):
        """Sum ``vec`` in place over the sync axes; returns the pending
        work of an async flat all-reduce, else None."""
        import torch.distributed as dist

        if self.two is None:
            return dist.all_reduce(vec, group=self.group, async_op=async_op)
        dcn, ici, n_dcn, n_ici = self.two
        vec.copy_(psum_two_phase(vec, dcn, ici, n_dcn=n_dcn, n_ici=n_ici))
        return None


def make_bucket_sync(
    template: Any,
    mesh: Any,
    sync_axes: Tuple[str, ...],
    mode: str = "bucketed_overlap",
    bucket_bytes: int = DEFAULT_BUCKET_BYTES,
) -> Callable[[Any], Any]:
    """The gradient mean as a function of a whole gradient tree: per
    bucket, the sum over ``sync_axes`` divided by their extent (the
    gradient of the global mean is the mean of the per-shard
    gradients). ``mode="bucketed_overlap"``: one flat all-reduce a
    bucket; ``"hierarchical"``: the two-phase decomposition, ``sync_axes``
    = (dcn, inner). Runs after the backward, bucket by bucket; the
    trainer overlaps the buckets with the backward through
    :class:`GradSync` instead."""
    from tpu_hpc_torch.train.trainer import tree_leaves, tree_paths

    leaves = tree_leaves(template)
    buckets = assign_buckets(leaves, bucket_bytes)
    reducer = _Reducer(mesh, tuple(sync_axes), mode)

    def sync(grads):
        flat = tree_leaves(grads)
        out: List[Any] = [None] * len(flat)
        for bucket in buckets:
            vec = torch.cat([flat[i].reshape(-1) for i in bucket])
            reducer.reduce(vec)
            vec = vec / reducer.n_total
            offset = 0
            for i in bucket:
                size = flat[i].numel()
                out[i] = vec[offset:offset + size].reshape(flat[i].shape)
                offset += size
        return _unflatten(tree_paths(grads), out)

    return sync


def _unflatten(paths, leaves) -> Dict[str, Any]:
    tree: Dict[str, Any] = {}
    for path, leaf in zip(paths, leaves):
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = leaf
    return tree


INEXACT_ERROR = (
    "manual comm modes cannot return non-inexact "
    "aux/model-state leaves (got {dtype}): the "
    "per-shard value of an integer metric is not the "
    "global one, and no reduction is universally "
    "correct (a batch count wants psum, a replicated "
    "step counter wants identity) -- return it as a "
    "float, or run comm_mode='flat'"
)


def check_inexact(tree: Any) -> None:
    """Refuse integer and bool leaves of aux/model state with the JAX
    package's words."""
    for leaf in _tree_values(tree):
        t = torch.as_tensor(leaf)
        if not (t.is_floating_point() or t.is_complex()):
            raise ValueError(INEXACT_ERROR.format(dtype=_jax_dtype(t.dtype)))


def _jax_dtype(dtype: torch.dtype) -> str:
    return "bool" if dtype == torch.bool else _dtype_key(dtype)


def _tree_values(tree: Any) -> List[Any]:
    if isinstance(tree, dict):
        return [v for k in sorted(tree) for v in _tree_values(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [v for x in tree for v in _tree_values(x)]
    return [tree]


def _tree_replace(tree: Any, values: List[Any]) -> Any:
    it = iter(values)

    def walk(node):
        if isinstance(node, dict):
            return {k: walk(node[k]) for k in sorted(node)}
        if isinstance(node, (list, tuple)):
            return type(node)(walk(x) for x in node)
        return next(it)

    return walk(tree)


class GradSync:
    """Bucketed gradient sync driven by the backward (see the module
    docstring). ``params``: the replicated leaf tensors in the param
    tree's leaf order (``trainer.tree_leaves``).

    Per update: :meth:`begin` before each microbatch's forward (armed on
    the last one only), the backward, then :meth:`finish`, which waits
    for every bucket and returns the mean gradient per leaf; then
    :meth:`mean` averages the loss, aux and model-state leaves over the
    sync axes in ONE all-reduce. So an update issues ``n_buckets + 1``
    all-reduces (``allreduces`` counts them; a hierarchical bucket
    counts once, for its three phases). ``launch_log`` holds the last
    update's launches as ``(bucket, during_backward)``."""

    def __init__(self, params: Sequence[torch.Tensor], mesh: Any,
                 sync_axes: Tuple[str, ...], mode: str = "bucketed_overlap",
                 bucket_bytes: int = DEFAULT_BUCKET_BYTES):
        self.reducer = _Reducer(mesh, tuple(sync_axes), mode)
        self.mode, self.sync_axes = mode, tuple(sync_axes)
        self.n_total = self.reducer.n_total
        self.shard_index = shard_index(mesh, self.sync_axes)
        self.params = list(params)
        self.bucket_bytes = int(bucket_bytes)
        self.buckets = assign_buckets(self.params, self.bucket_bytes)
        self.where: List[Tuple[int, int]] = [(0, 0)] * len(self.params)
        sizes = []
        for b, bucket in enumerate(self.buckets):
            offset = 0
            for i in bucket:
                self.where[i] = (b, offset)
                offset += self.params[i].numel()
            sizes.append(offset)
        self.buffers = [
            torch.empty(size, dtype=self.params[bucket[0]].dtype,
                        device=self.params[bucket[0]].device)
            for size, bucket in zip(sizes, self.buckets)]
        self.order: Optional[List[int]] = None
        self.allreduces = 0
        self.launch_log: List[Tuple[int, bool]] = []
        self._armed = False
        self._finishing = False
        self._pending: List[set] = []
        self._ready: List[int] = []
        self._next = 0
        self._works: list = []
        self._handles = [
            p.register_post_accumulate_grad_hook(self._hook(i))
            for i, p in enumerate(self.params)]

    @property
    def n_buckets(self) -> int:
        return len(self.buckets)

    def remove(self) -> None:
        """Unregister the hooks."""
        for h in self._handles:
            h.remove()
        self._handles = []

    def begin(self, last: bool) -> None:
        """Before a microbatch's forward: arm the hooks on the update's
        last microbatch (the earlier ones only accumulate)."""
        self._armed = last
        if last:
            self._pending = [set(bucket) for bucket in self.buckets]
            self._ready, self._next, self._works = [], 0, []
            self._finishing = False
            self.launch_log = []

    def _hook(self, i: int):
        def hook(p: torch.Tensor) -> None:
            if not self._armed or i not in self._pending[self.where[i][0]]:
                return
            self._land(i, p.grad)
            if self.order is not None:
                self._launch_ready()
        return hook

    def _land(self, i: int, grad: Optional[torch.Tensor]) -> None:
        """Copy leaf ``i``'s gradient into its bucket (zeros for a leaf
        the backward never reached); a bucket whose last leaf landed is
        ready."""
        b, offset = self.where[i]
        n = self.params[i].numel()
        dst = self.buffers[b][offset:offset + n]
        with torch.no_grad():
            if grad is None:
                dst.zero_()
            else:
                dst.copy_(grad.reshape(-1))
        self._pending[b].discard(i)
        if not self._pending[b]:
            self._ready.append(b)

    def _launch_ready(self) -> None:
        """Launch, in the shared order, every bucket whose turn has come
        and whose gradients are all in."""
        ready = set(self._ready)
        while self._next < len(self.order) and self.order[self._next] in ready:
            b = self.order[self._next]
            work = self.reducer.reduce(self.buffers[b], async_op=True)
            if work is not None:
                self._works.append(work)
            self.allreduces += 1
            self.launch_log.append((b, not self._finishing))
            self._next += 1

    def _fix_order(self) -> None:
        """The first update's ready order, rank 0's, for every rank."""
        import torch.distributed as dist

        local = torch.tensor(self._ready, dtype=torch.int64,
                             device=self.buffers[0].device)
        dist.broadcast(local, src=global_rank(self.reducer.group, 0),
                       group=self.reducer.group)
        self.order = [int(b) for b in local.tolist()]

    def finish(self) -> List[torch.Tensor]:
        """After the last microbatch's backward: land what the hooks did
        not, fix the launch order on the first update, launch the rest,
        wait for every bucket and divide by the sync extent. Returns the
        mean gradient of each leaf, a view into its bucket buffer."""
        self._finishing = True
        self._armed = False
        for b, pending in enumerate(self._pending):
            for i in sorted(pending):
                self._land(i, self.params[i].grad)
        if self.order is None:
            self._fix_order()
        self._launch_ready()
        for work in self._works:
            work.wait()
        self._works = []
        with torch.no_grad():
            for buf in self.buffers:
                buf.div_(self.n_total)
        out = []
        for i, p in enumerate(self.params):
            b, offset = self.where[i]
            out.append(self.buffers[b][offset:offset + p.numel()]
                       .view(p.shape))
        return out

    def mean(self, tree: Any) -> Any:
        """The mean over the sync axes of every leaf of ``tree`` (loss,
        aux, model state: float tensors or numbers), in one all-reduce;
        integer leaves are refused (:func:`check_inexact`)."""
        import torch.distributed as dist

        check_inexact(tree)
        values = [torch.as_tensor(v) for v in _tree_values(tree)]
        if not values:
            return tree
        device = self.buffers[0].device
        vec = torch.cat([v.detach().to(device, torch.float32).reshape(-1)
                         for v in values])
        dist.all_reduce(vec, group=self.reducer.group)
        self.allreduces += 1
        vec = vec / self.n_total
        out, offset = [], 0
        for v in values:
            out.append(vec[offset:offset + v.numel()].reshape(v.shape))
            offset += v.numel()
        return _tree_replace(tree, out)


def verify_replicated(params: Sequence[torch.Tensor], group,
                      names: Optional[Sequence[str]] = None) -> None:
    """Check once that every rank holds the same params: each leaf's sum
    and absolute sum in float64 against rank 0's (one broadcast), then
    one MAX all-reduce of the verdict, so every rank fails together when
    any differs."""
    import torch.distributed as dist

    if not params:
        return
    device = params[0].device
    with torch.no_grad():
        mine = torch.stack([
            torch.stack([p.sum(dtype=torch.float64),
                         p.abs().sum(dtype=torch.float64)])
            for p in params]).to(device)
    ref = mine.clone()
    dist.broadcast(ref, src=global_rank(group, 0), group=group)
    bad_rows = (mine != ref).any(dim=1)
    flag = bad_rows.any().to(torch.float32).reshape(1)
    dist.all_reduce(flag, op=dist.ReduceOp.MAX, group=group)
    if float(flag) > 0:
        bad = [(names[i] if names else str(i))
               for i in torch.nonzero(bad_rows).flatten().tolist()]
        raise RuntimeError(
            "manual comm modes need replicated params, but the ranks' "
            f"params differ (rank {dist.get_rank()}: "
            f"{bad or 'another rank'}) -- build them from one seed on "
            "every rank")


def make_synced_value_and_grad(
    forward: Callable,
    mesh: Any,
    batch_pspec,
    params_template: Any,
    mode: str,
    bucket_bytes: int = DEFAULT_BUCKET_BYTES,
) -> Callable:
    """The counterpart of the JAX ``value_and_grad`` that owns gradient
    synchronization: ``(params, model_state, batch, rng) -> ((loss,
    (new_model_state, aux)), grads)``. ``params``: the replicated param
    tree of leaf tensors with ``requires_grad`` (``params_template``'s
    structure; hooks are registered on its leaves once); ``batch``:
    this rank's shard of the global batch (``batch_pspec``'s split).
    Runs forward and backward on the shard with :class:`GradSync` armed
    (the buckets reduce as the backward produces them), then averages
    loss, aux and model state over the sync axes in one all-reduce --
    global values, as the flat path's. The rng is a ``torch.Generator``;
    the shard's linear index is folded into its seed, so rng-consuming
    forwards draw decorrelated randomness per shard. The returned
    function carries the sync as ``.sync``."""
    from tpu_hpc_torch.models.datasets import step_seed
    from tpu_hpc_torch.train.trainer import tree_leaves, tree_paths

    sync_axes = sync_axes_from_batch_pspec(batch_pspec)
    leaves = tree_leaves(params_template)
    sync = GradSync(leaves, mesh, sync_axes, mode, bucket_bytes)
    paths = tree_paths(params_template)

    def synced_value_and_grad(params, ms, batch, rng):
        for p in leaves:
            p.grad = None
        sync.begin(last=True)
        rng = torch.Generator().manual_seed(
            step_seed(rng.initial_seed(), sync.shard_index))
        loss, new_ms, aux = forward(params, ms, batch, rng)
        check_inexact((new_ms, aux))
        loss.backward()
        grads = sync.finish()
        for p in leaves:
            p.grad = None
        loss, new_ms, aux = sync.mean((loss.detach(), new_ms, aux))
        return (loss, (new_ms, aux)), _unflatten(paths, grads)

    synced_value_and_grad.sync = sync
    return synced_value_and_grad


# ---------------------------------------------------------------------------
# ppermute-pipelined all-gather and collective-matmul-style gather-matmul
# ---------------------------------------------------------------------------

def _hop(t: torch.Tensor, group, me: int):
    """Post one ring hop: ``t`` to position me + 1, a buffer from me - 1;
    returns (buffer, works)."""
    import torch.distributed as dist

    nxt = torch.empty_like(t)
    ops = [dist.P2POp(dist.isend, t, global_rank(group, me + 1), group),
           dist.P2POp(dist.irecv, nxt, global_rank(group, me - 1), group)]
    return nxt, dist.batch_isend_irecv(ops)


def ring_all_gather(x: torch.Tensor, group, n: Optional[int] = None
                    ) -> torch.Tensor:
    """Ring all-gather over ``group``: n - 1 neighbour hops, each moving
    only one shard; the tiled gather in group order, equal to the flat
    all-gather."""
    n = group_size(group) if n is None else n
    if n == 1:
        return x
    me = group_rank(group)
    buf: List[Optional[torch.Tensor]] = [None] * n
    cur = x.contiguous()
    buf[me] = cur
    for t in range(1, n):
        cur, works = _hop(cur, group, me)
        for w in works:
            w.wait()
        # After t forward hops this rank holds shard (me - t) mod n.
        buf[(me - t) % n] = cur
    return torch.cat(buf, dim=0)


def gather_matmul(x: torch.Tensor, w_shard: torch.Tensor, group,
                  n: Optional[int] = None) -> torch.Tensor:
    """Collective matmul: ``y = x @ W`` with ``W`` sharded over ``group``
    on dim 0 (the FSDP layout). ``x`` is the local activation ``[...,
    K]`` (full contraction dim), ``w_shard`` ``[K/n, N]``. Each step
    posts the next hop of the ring, then multiplies the shard in hand
    against its K-slice of ``x`` while the hop is in flight; the
    gathered ``[K, N]`` never materializes. The partial products add up
    in the JAX order (shard ``me``, then ``me - 1``, ...)."""
    n = group_size(group) if n is None else n
    k_shard = w_shard.shape[0]
    if n == 1:
        return x @ w_shard
    me = group_rank(group)
    dtype = torch.promote_types(x.dtype, w_shard.dtype)
    acc = torch.zeros(x.shape[:-1] + (w_shard.shape[1],), dtype=dtype,
                      device=x.device)
    w_cur = w_shard.contiguous()
    for t in range(n):
        pending = _hop(w_cur, group, me) if t < n - 1 else None
        j = (me - t) % n
        xs = x[..., j * k_shard:(j + 1) * k_shard]
        acc = acc + torch.matmul(xs.to(dtype), w_cur.to(dtype))
        if pending is not None:
            w_cur, works = pending
            for w in works:
                w.wait()
    return acc


def ppermute_all_gather(mesh: Any, axis: str) -> Callable:
    """The ring all-gather over ``mesh``'s ``axis`` (the primitives.py
    convention): this rank's shard in, the gathered whole out."""
    group = axis_group(mesh, axis)
    return lambda x: ring_all_gather(x, group)


def make_pipelined_gather_matmul(mesh: Any, axis: str) -> Callable:
    """``(x, w) -> x @ W`` with ``x`` batch-sharded and ``w``
    dim-0-sharded over ``axis`` (the FSDP forward shape): this rank's
    rows of the product, through :func:`gather_matmul`."""
    group = axis_group(mesh, axis)
    return lambda x, w: gather_matmul(x, w, group)
