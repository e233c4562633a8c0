"""A param tree laid out on a (data, model) mesh by a plan, and back.

The JAX package hands a spec tree to ``jit``; the port carries it out
as the reference's FSDP x TP recipe does (``fsdp_tp_example.py``):

  1. the tree becomes modules (:class:`ParamTree`: one module per dict,
     flax key names kept), since FSDP2 hooks modules;
  2. when the plan names the ``model`` axis, every leaf becomes a
     DTensor on the ``model`` sub-mesh, ``Shard(d)`` on the dim its spec
     names, else ``Replicate()`` (TP first);
  3. ``fully_shard`` over the ``data`` sub-mesh, once per block
     (``layers_<i>``) and once at the root, each param sharded on the
     dim its spec names for ``data`` (``shard_placement_fn``). On a
     mesh with a ``context`` axis (sequence parallelism) FSDP2 runs over
     ``data`` and ``context`` flattened into one dim (torchtitan's
     ``dp_shard x cp``): each context rank computes the gradient of its
     own tokens, and the reduce-scatter averages over both axes -- with
     equal tokens per rank, the gradient of the global mean loss.

FSDP2 shards every param of a unit: a leaf the plan keeps whole on
``data`` (under ``min_size``, or with no divisible dim) is sharded on
dim 0, padded where uneven. The numerics do not depend on the layout.

On a mesh with a ``pipe`` axis (pipeline parallelism, ``parallel.pp``)
every leaf becomes a DTensor on the ``pipe`` sub-mesh instead --
``Shard(0)`` for a stage leaf, whose spec names the axis on its stacked
dim (``pp.stage_pspecs``), ``Replicate()`` for the edges -- and FSDP2
is not applied: the pipeline keeps the params whole over ``data``, as
the JAX bench's ``pp_pspecs`` do, and sums the stage gradients over the
data ranks itself. The placements tell the trainer's global norm which
ranks hold the same shard.

:func:`shard_params` takes the full tree (numpy arrays or tensors, the
same on every rank, e.g. a JAX param tree fetched to the host);
:func:`gather_params` brings the whole tree back as numpy on every
rank. Both are collective when a process group is up.
"""
from __future__ import annotations

import re
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch
from torch import nn

from tpu_hpc_torch.parallel.plans import (
    P,
    map_with_path,
    placements,
    tree_specs,
)

BLOCK_PATTERN = r"^layers_\d+$"


class ParamTree(nn.Module):
    """A nested param dict as modules: each dict a module, each leaf an
    ``nn.Parameter`` under its key. ``tree[key]`` reads a child as the
    dict would, so model code indexes it like the dict;
    ``tree(fn, *args)`` runs ``fn(tree, *args)`` through the module's
    ``__call__``, where FSDP2 gathers the unit's params first."""

    def __init__(self, tree: Dict[str, Any]):
        super().__init__()
        for key, node in tree.items():
            if isinstance(node, dict):
                self.add_module(key, ParamTree(node))
            else:
                self.register_parameter(
                    key, node if isinstance(node, nn.Parameter)
                    else nn.Parameter(node))

    def __getitem__(self, key: str):
        return getattr(self, key)

    def forward(self, fn: Callable, *args):
        return fn(self, *args)

    def tree(self) -> Dict[str, Any]:
        """The params as a nested dict, keys in the tree's order."""
        out: Dict[str, Any] = {}
        for key, param in self.named_parameters(recurse=False):
            out[key] = param
        for key, child in self.named_children():
            out[key] = child.tree()
        return out


def _dim_of(spec: P, axis: str) -> Optional[int]:
    """The tensor dim ``spec`` shards over ``axis``, or None."""
    for dim, entry in enumerate(spec):
        if entry == axis or (isinstance(entry, tuple) and axis in entry):
            return dim
    return None


def shard_params(
    params: Any,
    mesh: Any,
    specs: Any,
    *,
    data_axis: str = "data",
    model_axis: str = "model",
    context_axis: str = "context",
    pipe_axis: str = "pipe",
    device: Any = "cuda",
) -> ParamTree:
    """The full tree ``params`` (numpy arrays or tensors) -> a
    :class:`ParamTree` on ``device`` laid out by ``specs`` over
    ``mesh`` (a ``DeviceMesh`` naming ``data_axis`` and/or
    ``model_axis``): TP DTensors on the model sub-mesh, then FSDP2 over
    :func:`fsdp_mesh`; or, on a mesh naming ``pipe_axis``, DTensors on
    the pipe sub-mesh and no FSDP2. Each leaf keeps its dtype."""
    from torch.distributed.tensor import Shard, distribute_tensor

    names = mesh.mesh_dim_names or ()
    tp_mesh = None
    dp_mesh = fsdp_mesh(mesh, data_axis, context_axis)
    if pipe_axis in names:
        if model_axis in names or context_axis in names:
            raise ValueError(
                f"mesh {names}: a pipe axis composes with data only "
                "(PP x TP and PP x SP are not ported, "
                'ROADMAP: "Pipeline, the MPMD half")')
        tp_mesh, dp_mesh = mesh[pipe_axis], None
    elif model_axis in names and any(_dim_of(spec, model_axis) is not None
                                     for spec in tree_specs(specs)):
        tp_mesh = mesh[model_axis]
    device = torch.device(device)
    data_dims: Dict[int, Optional[int]] = {}

    def place(_, leaf, spec):
        if not isinstance(leaf, torch.Tensor):
            leaf = torch.from_numpy(np.array(leaf))
        t = leaf.detach().to(device).clone()
        if tp_mesh is not None:
            t = distribute_tensor(t, tp_mesh, placements(spec, tp_mesh),
                                  src_data_rank=None)
        param = nn.Parameter(t)
        data_dims[id(param)] = _dim_of(spec, data_axis)
        return param

    root = ParamTree(map_with_path(place, params, specs))
    if dp_mesh is not None:
        from torch.distributed.fsdp import fully_shard

        def placement_fn(param):
            dim = data_dims[id(param)]
            return Shard(dim) if dim is not None else None

        for name, child in root.named_children():
            if re.search(BLOCK_PATTERN, name):
                fully_shard(child, mesh=dp_mesh,
                            shard_placement_fn=placement_fn)
        fully_shard(root, mesh=dp_mesh, shard_placement_fn=placement_fn)
    return root


def fsdp_mesh(mesh: Any, data_axis: str = "data",
              context_axis: str = "context") -> Any:
    """The 1-D mesh FSDP2 shards over: ``data``, ``context``, or the two
    flattened (``data_context``); None when the mesh has neither."""
    names = mesh.mesh_dim_names or ()
    axes = tuple(a for a in (data_axis, context_axis) if a in names)
    if not axes:
        return None
    if len(axes) == 1:
        return mesh[axes[0]]
    return mesh[axes]._flatten("_".join(axes))


def is_dtensor(t: Any) -> bool:
    """Whether ``t`` is a DTensor (a param or activation under TP)."""
    from torch.distributed.tensor import DTensor

    return isinstance(t, DTensor)


def local(t: torch.Tensor) -> torch.Tensor:
    """This rank's shard of ``t`` (``t`` itself when it is no DTensor)."""
    from torch.distributed.tensor import DTensor

    return t.to_local() if isinstance(t, DTensor) else t


def layout_summary(module: Optional[nn.Module]) -> Optional[Dict[str, Any]]:
    """What carries a laid-out tree: its FSDP2 units, and its params by
    placement (``"(Shard(dim=0), Shard(dim=1))": n``; plain tensors
    under ``"plain"``). None for no module."""
    if module is None:
        return None
    from torch.distributed.fsdp import FSDPModule

    placements: Dict[str, int] = {}
    for _, p in sorted(module.named_parameters()):
        key = str(tuple(p.placements)) if is_dtensor(p) else "plain"
        placements[key] = placements.get(key, 0) + 1
    return {
        "fsdp_units": sum(isinstance(m, FSDPModule) for m in module.modules()),
        "params": placements,
    }


def gather_params(tree: Any) -> Any:
    """A tree of (possibly sharded) tensors -> the whole tree as numpy
    arrays, on every rank (collective for DTensor leaves)."""
    from torch.distributed.tensor import DTensor

    def whole(_, t):
        if isinstance(t, DTensor):
            t = t.full_tensor()
        return t.detach().to("cpu", torch.float32 if t.dtype in (
            torch.bfloat16, torch.float16) else t.dtype).numpy()

    return map_with_path(whole, tree)
