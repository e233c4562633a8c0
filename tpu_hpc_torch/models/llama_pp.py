"""Llama-2 through the pipeline engine: the flagship model, stage-split.

Port of the JAX package's ``models/llama_pp.py``. The transformer blocks
are homogeneous (the depth-scaled init changes values, never the
program), so ``n_layers/S`` consecutive blocks form one shape-preserving
stage function and the whole body pipelines under ``parallel.pp``.

``split_params`` regroups ``llama2.init_llama``'s tree into ``edges``
(tok_embeddings, the final norm and the output head: replicated over
the pipe axis, applied outside the pipelined body) and ``stages`` (a
``[S, ...]`` stacked tree, stage s = layers ``s*lps .. s*lps+lps-1``,
sharded ``P("pipe")``). ``merge_params`` is its exact inverse, so the
sequential oracle of every pipelined run is ``llama2.apply_llama`` on
the same values. ``mpmd_bundle`` (the MPMD runtime's cut) is not ported
yet (ROADMAP: "Pipeline, the MPMD half").
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from tpu_hpc_torch.models.llama2 import (
    AttnFn,
    LlamaConfig,
    _block,
    _embed,
    _identity,
    _proj,
    _rmsnorm,
    rope_cos_sin,
)
from tpu_hpc_torch.models.pipeline_transformer import (
    _map,
    local_tree,
    numpy_leaf,
)
from tpu_hpc_torch.parallel import pp
from tpu_hpc_torch.parallel.plans import P

EDGE_KEYS = ("tok_embeddings", "norm", "output")


def layers_per_stage(cfg: LlamaConfig, n_stages: int) -> int:
    if n_stages < 1 or cfg.n_layers % n_stages:
        raise ValueError(
            f"pipeline needs n_layers {cfg.n_layers} divisible by "
            f"the stage count {n_stages}"
        )
    return cfg.n_layers // n_stages


def split_params(params: Dict, cfg: LlamaConfig, n_stages: int) -> Dict:
    """init_llama tree -> {"edges": {...}, "stages": [S, ...] stacked};
    stage s's subtree is {"layer_j": <layers_{s*lps+j}>}."""
    lps = layers_per_stage(cfg, n_stages)
    edges = {k: params[k] for k in EDGE_KEYS}
    per_stage = [
        {f"layer_{j}": params[f"layers_{s * lps + j}"] for j in range(lps)}
        for s in range(n_stages)
    ]
    return {"edges": edges, "stages": pp.stack_stage_params(per_stage)}


def merge_params(split: Dict, cfg: LlamaConfig) -> Dict:
    """Exact inverse of :func:`split_params`: the tree
    ``llama2.apply_llama`` consumes."""
    stages = split["stages"]
    S = pp._flatten(stages)[1][0].shape[0]
    lps = layers_per_stage(cfg, S)
    out = dict(split["edges"])
    for s in range(S):
        stage = _map(lambda a: a[s], stages)
        for j in range(lps):
            out[f"layers_{s * lps + j}"] = stage[f"layer_{j}"]
    return out


def split_params_interleaved(params: Dict, cfg: LlamaConfig,
                             n_devices: int, n_chunks: int) -> Dict:
    """:func:`split_params` into ``n_devices * n_chunks`` global stages,
    stacked in the interleaved layout (device s holds chunks {s, S+s,
    ...}, ``pp.interleave_stacked``)."""
    split = split_params(params, cfg, n_devices * n_chunks)
    return {"edges": split["edges"],
            "stages": pp.interleave_stacked(split["stages"], n_devices)}


def merge_params_interleaved(split: Dict, cfg: LlamaConfig,
                             n_devices: int, n_chunks: int) -> Dict:
    """Exact inverse of :func:`split_params_interleaved`."""
    order = pp._interleave_order(n_devices * n_chunks, n_devices)
    inv = sorted(range(len(order)), key=order.__getitem__)
    stages = _map(lambda a: a[torch.as_tensor(inv, device=a.device)],
                  split["stages"])
    return merge_params({"edges": split["edges"], "stages": stages}, cfg)


def pipe_params_from_numpy(tree: Dict, cfg: LlamaConfig, n_stages: int,
                           n_chunks: int = 1, device: Any = "cpu") -> Dict:
    """The JAX package's split params (numpy: ``edges`` and the stacked
    ``[S*v, ...]`` stage tree, interleaved or not) -> the port's, in
    ``cfg.param_dtype`` on ``device``; Dense kernels stay ``[in, out]``
    and the stage order stays as stacked."""
    lead = pp._flatten(tree["stages"])[1][0].shape[0]
    if lead != n_stages * n_chunks:
        raise ValueError(f"stage tree of {lead} stages for {n_stages} "
                         f"stages x {n_chunks} chunks")
    return _map(lambda a: numpy_leaf(a, cfg.param_dtype, device), tree)


def make_stage_fn(cfg: LlamaConfig, n_stages: int, attn_fn: AttnFn = None,
                  positions: Optional[torch.Tensor] = None):
    """stage_fn(stage_params, x) for ``pp.pipelined``: this stage's
    ``n_layers/S`` blocks (``llama2._block``) in order, RoPE at
    ``positions`` (None: the full sequence 0..L-1)."""
    lps = layers_per_stage(cfg, n_stages)

    def stage_fn(stage_params, x):
        cos, sin = rope_cos_sin(x.shape[1], cfg.head_dim,
                                positions=positions, device=x.device)
        for j in range(lps):
            x = _block(stage_params[f"layer_{j}"], x, cfg, cos, sin,
                       _identity, attn_fn)
        return x

    return stage_fn


def embed(edges: Dict, tokens: torch.Tensor, cfg: LlamaConfig) -> torch.Tensor:
    """[.., L] int tokens -> [.., L, D] in cfg.dtype: the table cast to
    the compute dtype, looked up with ``llama2._EmbedLookup`` (the
    iota_embed backward) when ``cfg.iota_embed``."""
    table = edges["tok_embeddings"]["embedding"].to(cfg.dtype)
    return _embed(table, tokens.long(), cfg.iota_embed)


def head(edges: Dict, x: torch.Tensor, cfg: LlamaConfig) -> torch.Tensor:
    """Final RMSNorm + LM head -> logits in cfg.dtype (the loss upcasts
    inside its reductions)."""
    x = _rmsnorm(x, edges["norm"]["scale"], cfg.norm_eps)
    return _proj(x, edges["output"]["kernel"], cfg.dtype)


def pp_pspecs(split: Dict, axis: str = "pipe") -> Dict:
    """Spec tree: edges replicated, stages stage-sharded over ``axis``."""
    return {"edges": _map(lambda _: P(), split["edges"]),
            "stages": pp.stage_pspecs(split["stages"], axis=axis)}


def make_forward(
    cfg: LlamaConfig,
    mesh: Any,
    n_microbatches: int,
    axis: str = "pipe",
    schedule: str = "1f1b",
    backward: str = "remat",
    batch_spec: P = P(),
    attn_fn: AttnFn = None,
    positions: Optional[torch.Tensor] = None,
    remat_stage: bool = False,
    n_chunks: int = 1,
):
    """Trainer-contract forward for pipelined Llama training: embed ->
    pipelined stage body -> head -> next-token cross-entropy, the batch
    microbatched [B, L] -> [M, B/M, L] around it. ``mesh``: a
    ``DeviceMesh`` with ``axis`` or a ``pp_transport`` transport;
    ``batch_spec`` ``P(None, "data")`` splits the microbatch rows over
    the data axis."""
    from tpu_hpc_torch.models.losses import cross_entropy

    S = pp.pipe_size(mesh, axis)
    pipe = pp.pipelined(
        make_stage_fn(cfg, S * n_chunks, attn_fn, positions), mesh,
        axis=axis, schedule=schedule, batch_spec=batch_spec,
        backward=backward, remat_stage=remat_stage, n_chunks=n_chunks,
    )

    def forward(params, model_state, batch, step_rng):
        inputs, targets = batch
        p = local_tree(params)
        xs = embed(p["edges"], pp.microbatch(inputs, n_microbatches), cfg)
        ys = pipe(p["stages"], xs)
        logits = head(p["edges"], ys, cfg)
        loss = cross_entropy(logits, pp.microbatch(targets, n_microbatches))
        return loss, model_state, {}

    forward.pipe = pipe
    return forward


__all__ = [
    "EDGE_KEYS",
    "embed",
    "head",
    "layers_per_stage",
    "make_forward",
    "make_stage_fn",
    "merge_params",
    "merge_params_interleaved",
    "pipe_params_from_numpy",
    "pp_pspecs",
    "split_params",
    "split_params_interleaved",
]
