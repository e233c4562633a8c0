"""Train -> serve weight flow: restore a trainer checkpoint into the
serving layout.

Port of the JAX package's ``serve/weights.py``. The JAX version
reshards a trainer checkpoint onto the serving mesh; the port's serving
engines each run on one device, where the serving layout is "on the
device, in the compute dtype":

  * :func:`serving_pspecs` -- the serving param plan: Megatron TP over
    ``model`` when a mesh has that axis, everything replicated
    otherwise (the only case a one-device engine meets);
  * :func:`place_params` -- a torch param tree onto one device as FRESH
    buffers, through the reshard engine (``reshard.apply``, as the JAX
    ``place_params`` does), copies bounded by ``max_inflight_bytes``;
  * :func:`abstract_train_state` / :func:`load_serving_params` -- the
    newest trainer checkpoint (``ckpt.CheckpointManager.restore_latest``:
    torn-snapshot fallback, integrity check and quarantine included)
    -> its params on the serving device;
  * :func:`params_from_numpy` -- a JAX param tree carried across as
    numpy arrays (the parity tests enter the port this way).

Dense kernels keep flax's ``[in, out]`` layout in the serving param
dict, so the functional forward computes ``x @ W`` exactly as the JAX
engine's ``_dense`` does. Matrices (Dense kernels, the embedding) are
cast to ``cfg.dtype`` once, in :func:`place_params` -- the JAX engine
casts them at every use, to the same values. The 1-D RMSNorm scales
stay float32, since RMSNorm reads them in float32; casting them to bf16
would change their values.
"""
from __future__ import annotations

import os
from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch

from tpu_hpc_torch.models import llama2
from tpu_hpc_torch.runtime import resolve_device


def flat_params(tree: Mapping, prefix: str = "") -> Dict[str, Any]:
    """``{"layers_0/attention/wq/kernel": leaf, ...}`` in sorted key
    order: the JAX package's path convention for checksums
    (``ckpt.integrity.leaf_checksums`` of a param tree)."""
    out: Dict[str, Any] = {}
    for key in sorted(tree):
        path = f"{prefix}/{key}" if prefix else str(key)
        node = tree[key]
        if isinstance(node, Mapping):
            out.update(flat_params(node, path))
        else:
            out[path] = node
    return out


def serving_pspecs(params: Mapping, mesh: Any = None) -> Any:
    """The serving param plan: Megatron TP over ``model`` when the
    mesh has that axis with more than one device (``tp.llama_rules``,
    the training split), everything replicated (``P()``) otherwise --
    one device, or a mesh without a ``model`` axis. No FSDP: decode is
    latency-bound, and gathering params per token would put the full
    weight traffic on every step."""
    from tpu_hpc_torch.parallel import tp
    from tpu_hpc_torch.parallel.plans import P, map_with_path, pspec_tree

    names = getattr(mesh, "mesh_dim_names", None) or ()
    if "model" in names and mesh.size(names.index("model")) > 1:
        return pspec_tree(params, tp.llama_rules("model"), default=P())
    return map_with_path(lambda _path, _leaf: P(), params)


def serving_dtype(t: torch.Tensor, cfg: llama2.LlamaConfig):
    """A leaf's dtype in the serving layout: matrices in ``cfg.dtype``,
    the 1-D norm scales float32."""
    return cfg.dtype if t.dim() >= 2 else torch.float32


def place_params(
    params: Mapping,
    cfg: llama2.LlamaConfig,
    device: Any,
    max_inflight_bytes: Optional[int] = None,
) -> dict:
    """A torch param tree on ``device`` as fresh buffers: matrices in
    ``cfg.dtype``, norm scales in float32, moved and cast in one copy
    per leaf by the reshard engine (``reshard.apply`` onto the device,
    ``copy_noop=True``; one ``reshard_plan`` event labelled
    ``serving_params``, as the JAX ``place_params`` emits). A leaf
    already placed is copied all the same (callers may free or
    overwrite their source tree after placement, and the fleet swaps a
    placed tree in while the resident one stays intact for a rollback).
    ``max_inflight_bytes`` bounds the plan's steps and the in-process
    copies: at most that many destination bytes are in flight before
    the device catches up (one leaf larger than the bound moves alone);
    None moves them all at once."""
    from tpu_hpc_torch import reshard

    device = resolve_device(device)
    if max_inflight_bytes is not None and max_inflight_bytes < 1:
        raise ValueError(
            f"max_inflight_bytes {max_inflight_bytes} must be >= 1"
        )
    flat = flat_params(params)
    tree = {k: v.detach() for k, v in flat.items()}
    dtypes = {k: serving_dtype(v, cfg) for k, v in flat.items()}
    placed = reshard.apply(
        tree, device, max_inflight_bytes=max_inflight_bytes,
        copy_noop=True, label="serving_params", dtypes=dtypes,
        device=device,
    )
    return _unflatten(placed)


def _unflatten(flat: Mapping[str, Any]) -> dict:
    tree: dict = {}
    for path, leaf in flat.items():
        node = tree
        *parents, last = path.split("/")
        for key in parents:
            node = node.setdefault(key, {})
        node[last] = leaf
    return tree


def params_from_numpy(tree: Mapping, cfg: llama2.LlamaConfig, device) -> dict:
    """A nested mapping of arrays (a flax param tree fetched to the
    host) -> the serving param dict on ``device``, same keys."""
    def to_torch(node):
        return {
            k: to_torch(v) if isinstance(v, Mapping)
            else torch.from_numpy(np.array(v, copy=True))
            for k, v in node.items()
        }

    return place_params(to_torch(tree), cfg, device)


def abstract_train_state(
    cfg: llama2.LlamaConfig,
    learning_rate: float = 3e-4,
    weight_decay: float = 0.1,
    moments_dtype: str = "float32",
):
    """A ``TrainState`` template shaped like what the Trainer's ``fit``
    saves for ``cfg`` under AdamW (``train.trainer.make_adamw``, the
    shared single source): params in ``cfg.param_dtype`` and both
    moments, as empty host tensors. The checkpoint restores into it on
    the host, so the moments (about 8 bytes a param in float32) never
    transit the serving device; the caller keeps only the params."""
    from tpu_hpc_torch.train.trainer import TrainState, make_adamw, tree_map

    shapes = llama2.init_llama(torch.Generator(), cfg, "meta")
    params = tree_map(lambda t: torch.empty_like(t, device="cpu"), shapes)
    optimizer = make_adamw(learning_rate, weight_decay, moments_dtype)
    return TrainState(step=0, params=params,
                      opt_state=optimizer.init(params), model_state={})


def load_serving_params(
    checkpoint_dir: str,
    cfg: llama2.LlamaConfig,
    device: Any = "cuda",
    **trainer_opt_kwargs,
) -> dict:
    """Newest trainer checkpoint -> its params on ``device``, as saved
    (``cfg.param_dtype``; an engine casts them into the serving layout
    when it places them).

    Uses ``CheckpointManager.restore_latest`` (torn-snapshot fallback,
    integrity check and quarantine included), so a serving relaunch
    inherits the same self-healing restore path training has. Returns
    the params tree only; raises FileNotFoundError when the directory
    holds no restorable step."""
    from tpu_hpc_torch.ckpt import CheckpointManager
    from tpu_hpc_torch.train.trainer import tree_map

    device = resolve_device(device)
    if not os.path.isdir(checkpoint_dir):
        raise FileNotFoundError(
            f"no restorable checkpoint under {checkpoint_dir!r}"
        )
    template = abstract_train_state(cfg, **trainer_opt_kwargs)
    mgr = CheckpointManager(checkpoint_dir)
    try:
        restored = mgr.restore_latest(template)
    finally:
        mgr.close()
    if restored is None:
        raise FileNotFoundError(
            f"no restorable checkpoint under {checkpoint_dir!r}"
        )
    return tree_map(lambda t: t.to(device), restored.params)
