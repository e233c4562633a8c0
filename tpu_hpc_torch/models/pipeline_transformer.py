"""PipelineTransformer: a causal LM built for stage-wise pipelining.

Port of the JAX package's ``models/pipeline_transformer.py``: the
per-stage block params are stacked on a leading dim and sharded over the
``pipe`` axis (``parallel.pp``); embedding and LM head run outside the
pipelined body, replicated over the pipe axis. A stage is
``layers_per_stage`` pre-LN causal transformer layers.

The flax modules' numerics, written out over a plain param tree with
flax's keys (``layer_0/ln1/{scale,bias}``, ``layer_0/qkv/{kernel,bias}``
...; Dense kernels ``[in, out]``):

  * ``nn.LayerNorm`` (epsilon 1e-6): mean and the fast variance
    ``E[x^2] - E[x]^2`` (clipped at 0) in float32, scale and bias in
    float32, the result cast to the compute dtype;
  * ``nn.Dense(dtype, param_dtype)``: input, kernel and bias cast to the
    compute dtype;
  * ``nn.gelu``: the tanh approximation;
  * the einsum attention: scores scaled by ``1/sqrt(D//H)`` in the
    compute dtype, masked with the dtype's ``finfo.min``, softmax in
    float32, probabilities cast back. ``attn_fn`` replaces it (the flash
    kernels through ``kernels.attention.blockwise_attention``, which
    mask with their own finite value: every causal row sees its first
    key, so the two masks give the same softmax);
  * the head's hand-written LayerNorm (epsilon 1e-5) in the activations'
    dtype, promoted to float32 by its float32 scale and bias, and a
    float32 head product: ``head`` returns float32 logits.

``mpmd_bundle`` cuts the same params for the MPMD runtime
(``parallel/mpmd.py``): per-stage trees, embed on the first stage's
worker, head and loss on the last.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, Optional

import torch
import torch.nn.functional as F

# (q, k, v) [B, L, H, Dh] -> out [B, L, H, Dh]
AttnFn = Callable[[torch.Tensor, torch.Tensor, torch.Tensor], torch.Tensor]


@dataclasses.dataclass(frozen=True)
class PipeConfig:
    vocab_size: int = 1000
    dim: int = 256
    n_heads: int = 8
    n_stages: int = 4
    layers_per_stage: int = 2
    max_seq_len: int = 128
    mlp_ratio: int = 4
    dtype: Any = torch.float32        # compute dtype
    param_dtype: Any = torch.float32

    @property
    def n_layers(self) -> int:
        return self.n_stages * self.layers_per_stage

    def flops_per_token(self, seq_len: Optional[int] = None) -> int:
        """Training FLOPs/token (6ND convention) -- the MFU denominator.
        The 1f1b schedules' recompute is not counted."""
        s = seq_len if seq_len is not None else self.max_seq_len
        d = self.dim
        per_layer = (
            2 * d * 3 * d          # qkv projection
            + 2 * d * d            # out projection
            + 2 * 2 * d * self.mlp_ratio * d  # fc1 + fc2
            + 2 * s * d            # causal QK^T + AV (halved by mask)
        )
        head = 2 * d * self.vocab_size
        return 3 * (self.n_layers * per_layer + head)


def _layer_norm(x, p, eps: float, dtype):
    """flax ``nn.LayerNorm(dtype, param_dtype)``."""
    xf = x.to(torch.float32)
    mu = xf.mean(-1, keepdim=True)
    var = torch.clamp((xf * xf).mean(-1, keepdim=True) - mu * mu, min=0.0)
    mul = torch.rsqrt(var + eps) * p["scale"].to(torch.float32)
    return ((xf - mu) * mul + p["bias"].to(torch.float32)).to(dtype)


def _dense(x, p, dtype):
    """flax ``nn.Dense(dtype, param_dtype)``: ``x @ kernel + bias``."""
    return torch.matmul(x.to(dtype), p["kernel"].to(dtype)) \
        + p["bias"].to(dtype)


def _causal_layer(lp, x, cfg: PipeConfig, attn_fn: Optional[AttnFn]):
    """Pre-LN causal self-attention + GELU MLP."""
    dt = cfg.dtype
    B, L, D = x.shape
    H = cfg.n_heads
    h = _layer_norm(x, lp["ln1"], 1e-6, dt)
    # Each a contiguous [B, L, H, D/H] tensor, as the kernels take them.
    q, k, v = (t.reshape(B, L, H, D // H).contiguous()
               for t in _dense(h, lp["qkv"], dt).chunk(3, dim=-1))
    if attn_fn is not None:
        out = attn_fn(q, k, v)
    else:
        scores = torch.einsum("blhd,bmhd->bhlm", q, k) / math.sqrt(D // H)
        mask = torch.tril(torch.ones((L, L), dtype=torch.bool,
                                     device=x.device))
        scores = torch.where(mask, scores, torch.finfo(scores.dtype).min)
        attn = torch.softmax(scores.to(torch.float32), dim=-1)
        out = torch.einsum("bhlm,bmhd->blhd", attn.to(x.dtype), v)
    x = x + _dense(out.reshape(B, L, D), lp["proj"], dt)
    h = _layer_norm(x, lp["ln2"], 1e-6, dt)
    h = F.gelu(_dense(h, lp["fc1"], dt), approximate="tanh")
    return x + _dense(h, lp["fc2"], dt)


def _stage(stage_params, x, cfg: PipeConfig, attn_fn: Optional[AttnFn]):
    for i in range(cfg.layers_per_stage):
        x = _causal_layer(stage_params[f"layer_{i}"], x, cfg, attn_fn)
    return x


def _lecun_normal(shape, dtype, device, generator):
    """flax's default Dense kernel init: truncated normal (+-2 std) of
    variance 1/fan_in."""
    std = math.sqrt(1.0 / shape[-2]) / 0.87962566103423978
    t = torch.empty(shape, dtype=torch.float32, device=device)
    torch.nn.init.trunc_normal_(t, 0.0, std, -2 * std, 2 * std,
                                generator=generator)
    return t.to(dtype)


def init_pipeline_transformer(generator: torch.Generator, cfg: PipeConfig,
                              device: Any = None) -> Dict:
    """Random params with the flax init's distributions, in
    ``cfg.param_dtype``: ``{embed: {tok, pos}, stages: <stacked [S,
    ...]>, head: {ln_scale, ln_bias, kernel}}``, every stage an
    independent draw. The same seed gives other numbers than
    ``jax.random``; parity tests carry the JAX params across
    (:func:`pipe_params_from_numpy`)."""
    device = torch.device(device) if device is not None else generator.device
    pd, d, S = cfg.param_dtype, cfg.dim, cfg.n_stages

    def normal(shape, std):
        t = torch.empty(shape, dtype=torch.float32, device=device)
        return t.normal_(0.0, std, generator=generator).to(pd)

    def dense(n_in, n_out):
        return {"kernel": _lecun_normal((S, n_in, n_out), pd, device,
                                        generator),
                "bias": torch.zeros((S, n_out), dtype=pd, device=device)}

    def norm():
        return {"scale": torch.ones((S, d), dtype=pd, device=device),
                "bias": torch.zeros((S, d), dtype=pd, device=device)}

    stages = {
        f"layer_{i}": {
            "ln1": norm(), "qkv": dense(d, 3 * d), "proj": dense(d, d),
            "ln2": norm(), "fc1": dense(d, cfg.mlp_ratio * d),
            "fc2": dense(cfg.mlp_ratio * d, d),
        }
        for i in range(cfg.layers_per_stage)
    }
    return {
        "embed": {"tok": normal((cfg.vocab_size, d), 0.02),
                  "pos": normal((cfg.max_seq_len, d), 0.02)},
        "stages": stages,
        "head": {"ln_scale": torch.ones((d,), dtype=pd, device=device),
                 "ln_bias": torch.zeros((d,), dtype=pd, device=device),
                 "kernel": normal((d, cfg.vocab_size), 0.02)},
    }


def pipe_params_from_numpy(tree: Dict, cfg: PipeConfig, n_stages: int,
                           n_chunks: int = 1, device: Any = "cpu") -> Dict:
    """The JAX package's params (numpy arrays: the stacked ``[S*v,
    ...]`` stage tree in whatever order it was stacked, interleaved
    included, and the edges) -> the port's tree, in ``cfg.param_dtype``
    on ``device``. Both keep Dense kernels ``[in, out]``: nothing is
    transposed or reordered."""
    lead = _first_leaf(tree["stages"]).shape[0]
    if lead != n_stages * n_chunks or lead != cfg.n_stages:
        raise ValueError(
            f"stage tree of {lead} stages for {n_stages} stages x "
            f"{n_chunks} chunks and cfg.n_stages {cfg.n_stages}")
    return _map(lambda a: numpy_leaf(a, cfg.param_dtype, device), tree)


def numpy_leaf(a, dtype, device) -> torch.Tensor:
    """A numpy array (a JAX leaf fetched to the host, bf16 included) as
    a ``dtype`` tensor on ``device``."""
    import numpy as np

    return torch.from_numpy(np.array(a, dtype=np.float32)).to(
        device=device, dtype=dtype)


def _first_leaf(tree):
    while isinstance(tree, dict):
        tree = tree[sorted(tree)[0]]
    return tree


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    return fn(tree)


def embed(params: Dict, tokens: torch.Tensor, cfg: PipeConfig) -> torch.Tensor:
    """[.., L] int tokens -> [.., L, D] activations (token + learned
    positional embedding) in the compute dtype."""
    e = params["embed"]
    x = e["tok"][tokens.long()] + e["pos"][: tokens.shape[-1]]
    return x.to(cfg.dtype)


def head(params: Dict, x: torch.Tensor, cfg: PipeConfig) -> torch.Tensor:
    """Final LayerNorm + LM head -> float32 logits."""
    h = params["head"]
    mu = x.mean(-1, keepdim=True)
    var = ((x - mu) ** 2).mean(-1, keepdim=True)
    x = (x - mu) * torch.rsqrt(var + 1e-5)
    x = x * h["ln_scale"] + h["ln_bias"]
    return torch.matmul(x, h["kernel"]).to(torch.float32)


def local_tree(params: Any) -> Dict:
    """The trainer's params as this rank's plain tensors: a module tree
    (``parallel.shard.ParamTree``) read as its dict, each DTensor leaf
    as its local shard (differentiably: the stage leaves' gradients
    come back as their shards, the replicated edges' as themselves)."""
    from tpu_hpc_torch.parallel.shard import local

    tree = params.tree() if isinstance(params, torch.nn.Module) else params
    return _map(local, tree)


def make_stage_fn(cfg: PipeConfig, attn_fn: Optional[AttnFn] = None):
    """stage_fn(stage_params, x) for ``parallel.pp.pipelined``."""

    def stage_fn(stage_params, x):
        return _stage(stage_params, x, cfg, attn_fn)

    return stage_fn


def make_forward(cfg: PipeConfig, mesh: Any, n_microbatches: int,
                 axis: str = "pipe", schedule: str = "1f1b",
                 backward: str = "remat", batch_spec=None,
                 attn_fn: Optional[AttnFn] = None,
                 remat_stage: bool = False, n_chunks: int = 1):
    """The bench's trainer-contract forward (bench.py's ``forward`` in
    ``bench_llama_pp``): embed -> pipelined stages -> head ->
    cross-entropy, the batch microbatched [B, L] -> [M, B/M, L] around
    the pipeline (``parallel.pp.pipelined`` over ``mesh``)."""
    from tpu_hpc_torch.models.losses import cross_entropy
    from tpu_hpc_torch.parallel import pp
    from tpu_hpc_torch.parallel.plans import P

    pipe = pp.pipelined(
        make_stage_fn(cfg, attn_fn), mesh, axis=axis, schedule=schedule,
        batch_spec=P() if batch_spec is None else batch_spec,
        n_chunks=n_chunks, backward=backward, remat_stage=remat_stage)

    def forward(params, model_state, batch, step_rng):
        inputs, targets = batch
        p = local_tree(params)
        xs = embed(p, pp.microbatch(inputs, n_microbatches), cfg)
        ys = pipe(p["stages"], xs)
        logits = head(p, ys, cfg)
        loss = cross_entropy(logits, pp.microbatch(targets, n_microbatches))
        return loss, model_state, {}

    forward.pipe = pipe
    return forward


def pp_pspecs(params: Dict, axis: str = "pipe") -> Dict:
    """bench.py's spec tree: embed and head replicated, the stages
    stage-sharded over ``axis``."""
    from tpu_hpc_torch.parallel import pp
    from tpu_hpc_torch.parallel.plans import P

    return {"embed": _map(lambda _: P(), params["embed"]),
            "stages": pp.stage_pspecs(params["stages"], axis=axis),
            "head": _map(lambda _: P(), params["head"])}


def apply_sequential(params: Dict, tokens: torch.Tensor, cfg: PipeConfig,
                     attn_fn: Optional[AttnFn] = None) -> torch.Tensor:
    """Single-device oracle: every stage in order, no pipelining
    (``attn_fn`` as in :func:`make_stage_fn`)."""
    x = embed(params, tokens, cfg)
    stage_fn = make_stage_fn(cfg, attn_fn)
    for s in range(cfg.n_stages):
        x = stage_fn(_map(lambda a: a[s], params["stages"]), x)
    return head(params, x, cfg)


def mpmd_bundle(params: Dict, cfg: PipeConfig,
                attn_fn: Optional[AttnFn] = None):
    """Cut this model for the MPMD pipeline runtime
    (``tpu_hpc_torch.parallel.mpmd``): per-stage param trees off the
    stacked dim (views; each worker copies its own onto its device), the
    shape-preserving stage function, and the edge functions placed on
    the edge stages' workers (embed on stage 0, head+loss on stage S-1).
    The loss is the per-microbatch mean cross-entropy; the runtime's
    total is the mean over microbatches, matching the SPMD engine's
    per-microbatch loss vector bit for bit."""
    from tpu_hpc_torch.models.losses import cross_entropy
    from tpu_hpc_torch.parallel.mpmd import StageBundle

    stage_params = tuple(
        _map(lambda a: a[s], params["stages"])
        for s in range(cfg.n_stages)
    )

    def embed_fn(ep, tokens):
        return embed({"embed": ep}, tokens, cfg)

    def loss_fn(hp, y, targets):
        return cross_entropy(head({"head": hp}, y, cfg), targets)

    return StageBundle(
        n_stages=cfg.n_stages,
        stage_fn=make_stage_fn(cfg, attn_fn),
        embed_fn=embed_fn,
        loss_fn=loss_fn,
        stage_params=stage_params,
        embed_params=params["embed"],
        head_params=params["head"],
    )


__all__ = [
    "PipeConfig",
    "apply_sequential",
    "embed",
    "head",
    "init_pipeline_transformer",
    "local_tree",
    "make_forward",
    "make_stage_fn",
    "mpmd_bundle",
    "pipe_params_from_numpy",
    "pp_pspecs",
]
