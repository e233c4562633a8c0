"""Llama-2 in PyTorch: config, init, RoPE, the forward and the
training forward.

Ported from the JAX package's ``models/llama2.py``, with the same
numerics:

  * :class:`LlamaConfig` with the same fields and :data:`PRESETS`
    (dtypes are ``torch.dtype``);
  * :func:`count_params` from shapes (the JAX version runs
    ``eval_shape`` over the real init -- here the tree's shapes are
    written out, and the tests hold the two counts equal);
  * :func:`rope_cos_sin` / :func:`apply_rope`: real (cos, sin) pairs,
    adjacent-pair rotation in fp32;
  * :func:`init_llama`: the same distributions and the same param-tree
    keys as the flax init (``tok_embeddings/embedding``,
    ``layers_i/attention/wq/kernel`` ...), Dense kernels kept in flax's
    ``[in, out]`` layout so ``x @ W`` is the projection;
  * :func:`apply_llama`: the forward, differentiable. ``attn_fn`` plugs
    in the attention op (``parallel.tp.make_tp_flash_attn_fn`` -> the
    flash kernels); None keeps the einsum path with the -inf causal
    mask. ``cfg.remat`` checkpoints each block
    (``torch.utils.checkpoint``, non-reentrant), so its forward --
    attention kernel included -- runs again in the backward.
    ``cfg.iota_embed`` gives the embedding lookup the JAX package's
    backward: the table gradient summed over positions in fp32 and
    rounded once to the compute dtype;
  * :func:`make_forward`: the trainer's forward, next-token
    cross-entropy, ``(loss, model_state, aux)``.

Params are a plain nested dict of tensors -- the flax tree's shape --
rather than ``nn.Module``s. On a mesh the trainer hands
:func:`apply_llama` the same tree as modules
(``parallel.shard.ParamTree``, one per block and a root), which FSDP2
hooks; each block's forward is still :func:`_block`, under TP on each
rank's local shards (:func:`_tp_block`). Training keeps the params in
``cfg.param_dtype`` (fp32) with ``requires_grad``; each matrix is cast
to ``cfg.dtype`` at use, as flax's ``Dense(dtype=...)`` does, so its
gradient flows back to the fp32 master copy.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from tpu_hpc_torch.parallel.shard import is_dtensor

Constrain = Callable[[torch.Tensor], torch.Tensor]
# (q [B,S,Hq,D], k [B,S,Hkv,D], v) -> [B,S,Hq,D]; None -> the einsum path.
AttnFn = Optional[Callable[[torch.Tensor, torch.Tensor, torch.Tensor],
                           torch.Tensor]]


def _identity(x: torch.Tensor) -> torch.Tensor:
    return x


@dataclasses.dataclass(frozen=True)
class LlamaConfig:
    """Same fields as the JAX ``LlamaConfig``; defaults are the 7B
    configuration."""

    dim: int = 4096
    n_layers: int = 32
    n_heads: int = 32
    n_kv_heads: Optional[int] = None  # None -> MHA; < n_heads -> GQA
    vocab_size: int = 32000
    multiple_of: int = 256
    ffn_dim_multiplier: Optional[float] = None
    norm_eps: float = 1e-5
    max_seq_len: int = 32768
    depth_init: bool = True
    dtype: Any = torch.bfloat16       # compute dtype
    param_dtype: Any = torch.float32  # storage dtype of the init
    remat: bool = False               # checkpoint each block
    iota_embed: bool = True           # fp32-summed embedding backward

    @property
    def kv_heads(self) -> int:
        return self.n_kv_heads if self.n_kv_heads is not None else self.n_heads

    @property
    def head_dim(self) -> int:
        return self.dim // self.n_heads

    @property
    def ffn_hidden(self) -> int:
        """SwiGLU 2/3 rule + multiple_of rounding."""
        hidden = int(2 * (4 * self.dim) / 3)
        if self.ffn_dim_multiplier is not None:
            hidden = int(self.ffn_dim_multiplier * hidden)
        return self.multiple_of * (
            (hidden + self.multiple_of - 1) // self.multiple_of
        )

    def flops_per_token(self, seq_len: Optional[int] = None) -> int:
        """Training FLOPs/token (forward matmul count x 3, the 6ND
        convention) including the causal attention term at
        ``seq_len`` (defaults to max_seq_len)."""
        s = seq_len if seq_len is not None else self.max_seq_len
        d, h = self.dim, self.ffn_hidden
        per_layer = (
            2 * d * (self.n_heads + 2 * self.kv_heads) * self.head_dim
            + 2 * d * d
            + 3 * 2 * d * h
            + 2 * s * d
        )
        embed = 2 * d * self.vocab_size
        return 3 * (self.n_layers * per_layer + embed)


# Llama-2 family shapes (public architecture constants), identical to
# the JAX package's table. 70B is GQA (8 KV heads) with the
# 1.3x/4096-rounded SwiGLU -> ffn_hidden 28672.
PRESETS: Dict[str, LlamaConfig] = {
    "7b": LlamaConfig(max_seq_len=4096, remat=True),
    "13b": LlamaConfig(
        dim=5120, n_layers=40, n_heads=40, max_seq_len=4096, remat=True
    ),
    "70b": LlamaConfig(
        dim=8192, n_layers=80, n_heads=64, n_kv_heads=8,
        ffn_dim_multiplier=1.3, multiple_of=4096,
        max_seq_len=4096, remat=True,
    ),
}


def param_shapes(cfg: LlamaConfig) -> Dict[str, Any]:
    """The param tree's leaf shapes, keyed like the flax tree."""
    d, hd = cfg.dim, cfg.head_dim
    layer = {
        "attention_norm": {"scale": (d,)},
        "attention": {
            "wq": {"kernel": (d, cfg.n_heads * hd)},
            "wk": {"kernel": (d, cfg.kv_heads * hd)},
            "wv": {"kernel": (d, cfg.kv_heads * hd)},
            "wo": {"kernel": (cfg.n_heads * hd, d)},
        },
        "ffn_norm": {"scale": (d,)},
        "feed_forward": {
            "w1": {"kernel": (d, cfg.ffn_hidden)},
            "w2": {"kernel": (cfg.ffn_hidden, d)},
            "w3": {"kernel": (d, cfg.ffn_hidden)},
        },
    }
    tree: Dict[str, Any] = {
        "tok_embeddings": {"embedding": (cfg.vocab_size, d)},
    }
    for i in range(cfg.n_layers):
        tree[f"layers_{i}"] = layer
    tree["norm"] = {"scale": (d,)}
    tree["output"] = {"kernel": (d, cfg.vocab_size)}
    return tree


def _leaves(tree):
    for v in tree.values():
        if isinstance(v, dict):
            yield from _leaves(v)
        else:
            yield v


def _size(tree) -> int:
    """Elements in a tree of shapes."""
    total = 0
    for shape in _leaves(tree):
        n = 1
        for s in shape:
            n *= s
        total += n
    return total


def count_params(cfg: LlamaConfig) -> int:
    """Total trainable parameters for ``cfg``, from the tree's shapes."""
    return _size(param_shapes(cfg))


def count_params_by_part(cfg: LlamaConfig) -> Dict[str, int]:
    """Param counts split by pipeline role: one transformer layer
    (``per_layer``), the token embedding (``embed``), the LM head
    (``head``) and everything else (``other``, the final norm); so
    ``per_layer * n_layers + embed + head + other == count_params``.
    The source of the pipeline stage-shard accounting in
    ``checks/fit.py`` and ``checks/roofline.py``."""
    shapes = param_shapes(cfg)
    rest = {k: v for k, v in shapes.items()
            if not k.startswith("layers_") and k not in ("tok_embeddings",
                                                         "output")}
    return {"per_layer": _size(shapes["layers_0"]) if cfg.n_layers else 0,
            "embed": _size(shapes["tok_embeddings"]),
            "head": _size(shapes["output"]), "other": _size(rest)}


def pp_worst_stage_params(cfg: LlamaConfig, stages: int) -> int:
    """Params the fullest pipeline stage holds: its share of the layers
    plus the embed/head edge weights (both on one card when ``stages``
    is 1; otherwise the bigger of the two, since embed and head live on
    opposite ends of the pipe)."""
    if stages < 1 or cfg.n_layers % stages:
        raise ValueError(
            f"pipeline needs n_layers {cfg.n_layers} divisible by "
            f"the stage count {stages}"
        )
    parts = count_params_by_part(cfg)
    edge = (parts["embed"] + parts["head"] if stages == 1
            else max(parts["embed"], parts["head"]))
    return (parts["per_layer"] * (cfg.n_layers // stages) + edge
            + parts["other"])


def rope_cos_sin(
    seq_len: int,
    head_dim: int,
    theta: float = 10000.0,
    positions: Optional[torch.Tensor] = None,
    device: Optional[torch.device] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """RoPE tables as fp32 (cos, sin) of shape [seq, head_dim//2].
    ``positions`` overrides the default 0..seq_len-1 ramp (and sets
    the device); slot p gets the rotation of global position
    positions[p]."""
    if positions is not None:
        device = positions.device
    inv_freq = 1.0 / (
        theta ** (
            torch.arange(0, head_dim, 2, dtype=torch.float32, device=device)
            / head_dim
        )
    )
    if positions is None:
        t = torch.arange(seq_len, dtype=torch.float32, device=device)
    else:
        t = positions.to(torch.float32)
    freqs = torch.outer(t.reshape(-1), inv_freq).reshape(
        *t.shape, inv_freq.shape[0]
    )
    return torch.cos(freqs), torch.sin(freqs)


def apply_rope(
    x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor
) -> torch.Tensor:
    """Rotate [B, S, H, D] by position: adjacent-pair convention, fp32
    rotation, result cast back. ``cos``/``sin`` are [S, D//2] tables
    shared across the batch, or [B, S, D//2] per-row tables (the
    serving decode step, where each slot sits at its own position)."""
    orig_dtype = x.dtype
    xf = x.to(torch.float32).reshape(*x.shape[:-1], x.shape[-1] // 2, 2)
    x1 = xf[..., 0]
    x2 = xf[..., 1]
    # [.., S, D/2] -> [.., S, 1, D/2]: broadcasts over heads.
    c = cos.unsqueeze(-2)
    s = sin.unsqueeze(-2)
    r1 = x1 * c - x2 * s
    r2 = x1 * s + x2 * c
    out = torch.stack([r1, r2], dim=-1).reshape(x.shape)
    return out.to(orig_dtype)


def init_llama(
    generator: torch.Generator,
    cfg: LlamaConfig,
    device: Any = None,
) -> Dict[str, Any]:
    """Random params with the flax init's distributions, in
    ``cfg.param_dtype`` on ``device`` (default: the generator's
    device):

      * token embedding: normal(std 1.0);
      * wq/wk/wv/w1/w3: normal(std 0.02);
      * residual-path wo/w2: normal(std 0.02/sqrt(2*depth)), depth =
        layer_id + 1 when ``depth_init`` else n_layers;
      * output head: normal(std 0.02) truncated to +-2 std;
      * norm scales: ones.

    The same seed gives other numbers than ``jax.random``; parity
    tests carry the JAX params across (serve/weights.py) instead.
    """
    device = torch.device(device) if device is not None else generator.device
    dt = cfg.param_dtype

    def normal(shape, std):
        t = torch.empty(shape, dtype=dt, device=device)
        return t.normal_(0.0, std, generator=generator)

    def ones(shape):
        return torch.ones(shape, dtype=dt, device=device)

    shapes = param_shapes(cfg)
    params: Dict[str, Any] = {
        "tok_embeddings": {
            "embedding": normal(shapes["tok_embeddings"]["embedding"], 1.0)
        },
    }
    for i in range(cfg.n_layers):
        sh = shapes[f"layers_{i}"]
        depth = i + 1 if cfg.depth_init else cfg.n_layers
        out_std = 0.02 / (2 * depth) ** 0.5
        params[f"layers_{i}"] = {
            "attention_norm": {"scale": ones(sh["attention_norm"]["scale"])},
            "attention": {
                "wq": {"kernel": normal(sh["attention"]["wq"]["kernel"], 0.02)},
                "wk": {"kernel": normal(sh["attention"]["wk"]["kernel"], 0.02)},
                "wv": {"kernel": normal(sh["attention"]["wv"]["kernel"], 0.02)},
                "wo": {
                    "kernel": normal(sh["attention"]["wo"]["kernel"], out_std)
                },
            },
            "ffn_norm": {"scale": ones(sh["ffn_norm"]["scale"])},
            "feed_forward": {
                "w1": {
                    "kernel": normal(sh["feed_forward"]["w1"]["kernel"], 0.02)
                },
                "w2": {
                    "kernel": normal(
                        sh["feed_forward"]["w2"]["kernel"], out_std
                    )
                },
                "w3": {
                    "kernel": normal(sh["feed_forward"]["w3"]["kernel"], 0.02)
                },
            },
        }
    params["norm"] = {"scale": ones(shapes["norm"]["scale"])}
    head = torch.empty(shapes["output"]["kernel"], dtype=dt, device=device)
    torch.nn.init.trunc_normal_(
        head, mean=0.0, std=0.02, a=-0.04, b=0.04, generator=generator
    )
    params["output"] = {"kernel": head}
    return params


def _rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    """RMSNorm in fp32 with a learned scale, cast back to x.dtype."""
    xf = x.to(torch.float32)
    normed = xf * torch.rsqrt(
        torch.mean(xf * xf, dim=-1, keepdim=True) + eps
    )
    return (normed * scale.to(torch.float32)).to(x.dtype)


def _proj(x: torch.Tensor, kernel: torch.Tensor, dtype) -> torch.Tensor:
    """Bias-free Dense in the compute dtype, flax [in, out] kernel. A
    DTensor input sharded on a leading dim (the sequence, under SP) is
    all-gathered first, Megatron-SP's gather before a colwise
    product."""
    x = x.to(dtype)
    if is_dtensor(x) and any(p.is_shard() and p.dim < x.ndim - 1
                             for p in x.placements):
        from torch.distributed.tensor import Replicate

        x = x.redistribute(placements=[Replicate()] * len(x.placements))
    return torch.matmul(x, kernel.to(dtype))


class _EmbedLookup(torch.autograd.Function):
    """``table[tokens]`` whose backward is the JAX package's iota_embed
    one (llama2.py:62-98): the table gradient is the sum over positions
    with each token, accumulated in fp32 and rounded once to the
    table's dtype (the JAX version contracts a one-hot against the
    cotangent with an fp32 accumulator; the values are the same). The
    sum is ``index_put_(accumulate=True)``, which on CUDA sorts the
    tokens and adds each row's in a fixed order: the same bits on every
    run, so a resumed run repeats the uninterrupted one (``index_add_``
    adds with atomics, in whatever order they land)."""

    @staticmethod
    def forward(ctx, table, tokens):
        ctx.save_for_backward(tokens)
        ctx.table_shape = table.shape
        ctx.table_dtype = table.dtype
        return table[tokens]

    @staticmethod
    def backward(ctx, g):
        (tokens,) = ctx.saved_tensors
        dtable = torch.zeros(ctx.table_shape, dtype=torch.float32,
                             device=g.device)
        dtable.index_put_((tokens.reshape(-1),),
                          g.reshape(-1, g.shape[-1]).to(torch.float32),
                          accumulate=True)
        return dtable.to(ctx.table_dtype), None


def _attention(lp, x, cfg, cos, sin, attn_fn):
    dt = cfg.dtype
    b, s, _ = x.shape
    hd, n_kv = cfg.head_dim, cfg.kv_heads
    groups = cfg.n_heads // n_kv
    ap = lp["attention"]
    q = _proj(x, ap["wq"]["kernel"], dt).reshape(b, s, cfg.n_heads, hd)
    k = _proj(x, ap["wk"]["kernel"], dt).reshape(b, s, n_kv, hd)
    v = _proj(x, ap["wv"]["kernel"], dt).reshape(b, s, n_kv, hd)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)
    if attn_fn is not None:
        out = attn_fn(q, k, v)
    else:
        # scores [B, Hkv, G, S, S] in the compute dtype, fp32 softmax
        # under a -inf causal mask; GQA through a grouped query view.
        qg = q.reshape(b, s, n_kv, groups, hd)
        scores = torch.einsum("bqhgd,bkhd->bhgqk", qg, k) * hd ** -0.5
        causal = torch.tril(torch.ones((s, s), dtype=torch.bool,
                                       device=x.device))
        scores = scores.to(torch.float32).masked_fill(~causal, float("-inf"))
        probs = torch.softmax(scores, dim=-1).to(dt)
        out = torch.einsum("bhgqk,bkhd->bqhgd", probs, v)
    out = out.reshape(b, s, cfg.n_heads * hd)
    return _proj(out, ap["wo"]["kernel"], dt)


def _block(lp, x, cfg, cos, sin, constrain, attn_fn, enter=_identity):
    """Pre-norm residual block: attention then SwiGLU feed-forward.
    ``enter`` takes each normed input into the projections, and
    ``constrain`` each branch's output back to the residual stream (TP
    on local shards: Megatron's region operators, ``tp.tp_region``)."""
    dt = cfg.dtype
    h = x + constrain(_attention(
        lp, enter(_rmsnorm(x, lp["attention_norm"]["scale"], cfg.norm_eps)),
        cfg, cos, sin, attn_fn,
    ))
    ff = lp["feed_forward"]
    y = enter(_rmsnorm(h, lp["ffn_norm"]["scale"], cfg.norm_eps))
    gate = _proj(y, ff["w1"]["kernel"], dt)
    up = _proj(y, ff["w3"]["kernel"], dt)
    return h + constrain(_proj(
        torch.nn.functional.silu(gate) * up, ff["w2"]["kernel"], dt
    ))


def _tp_block(lp, x, cfg, cos, sin, constrain, attn_fn):
    """:func:`_block` on each TP rank's local shards, under
    ``local_map`` over the TP mesh -- the counterpart of a JAX
    ``shard_map`` around the block. The params come in as their TP
    DTensors and the residual ``x`` as ``Replicate`` or, under SP,
    ``Shard(1)``; inside, the block sees local heads (``n_heads / tp``
    query and ``kv_heads / tp`` KV heads of the same head_dim) and
    local FFN columns, with ``tp.tp_region``'s collectives around its
    two branches (``constrain`` is the residual's layout, already set).
    A replicated param's gradient is a partial sum under SP (each rank
    saw its rows), and FSDP2 adds the ranks up."""
    from torch.distributed.tensor import Partial, Replicate
    from torch.distributed.tensor.experimental import local_map

    from tpu_hpc_torch.parallel.plans import map_with_path
    from tpu_hpc_torch.parallel.tp import tp_region

    del constrain
    mesh = x.device_mesh
    if x.placements[0].is_partial():
        x = x.redistribute(placements=[Replicate()])
    (layout,) = x.placements
    sp = layout.is_shard()
    tp = mesh.size()
    local_cfg = dataclasses.replace(
        cfg, dim=cfg.dim // tp, n_heads=cfg.n_heads // tp,
        n_kv_heads=cfg.kv_heads // tp)
    tree = lp.tree() if isinstance(lp, torch.nn.Module) else lp
    paths, leaves = [], []
    map_with_path(lambda path, t: (paths.append(path), leaves.append(t)),
                  tree)
    enter, exit_ = tp_region(mesh, sp)

    def body(x_local, *shards):
        local = {}
        for path, shard in zip(paths, shards):
            *heads, last = path.split("/")
            node = local
            for key in heads:
                node = node.setdefault(key, {})
            node[last] = shard
        return _block(local, x_local, local_cfg, cos, sin, exit_, attn_fn,
                      enter)

    grads = [[Partial()] if sp and t.placements[0].is_replicate()
             else list(t.placements) for t in leaves]
    return local_map(
        body, out_placements=[layout],
        in_placements=([layout], *(list(t.placements) for t in leaves)),
        in_grad_placements=([layout], *grads), device_mesh=mesh,
    )(x, *leaves)


def _embed(table: torch.Tensor, tokens: torch.Tensor, iota: bool):
    """``table[tokens]``; a table sharded on vocab over the TP mesh (a
    DTensor) takes the vocab-parallel lookup."""
    if is_dtensor(table):
        return _vocab_parallel_embed(table, tokens, iota)
    return _EmbedLookup.apply(table, tokens) if iota else table[tokens]


class _ShardLookup(torch.autograd.Function):
    """Megatron's vocab-parallel lookup on one shard: rows ``[lo, lo +
    rows)`` of the table, zeros for tokens outside them; summed over the
    TP ranks it is ``table[tokens]``. The backward is
    :class:`_EmbedLookup`'s, restricted to the shard's rows: each row's
    gradient lives on one rank, summed in fp32 and rounded once."""

    @staticmethod
    def forward(ctx, table, tokens, lo):
        rows = table.shape[0]
        mine = (tokens >= lo) & (tokens < lo + rows)
        idx = torch.where(mine, tokens - lo, torch.zeros_like(tokens))
        ctx.save_for_backward(idx, mine)
        ctx.table_shape, ctx.table_dtype = table.shape, table.dtype
        return table[idx] * mine[..., None].to(table.dtype)

    @staticmethod
    def backward(ctx, g):
        idx, mine = ctx.saved_tensors
        g = g.to(torch.float32) * mine[..., None]
        dtable = torch.zeros(ctx.table_shape, dtype=torch.float32,
                             device=g.device)
        dtable.index_put_((idx.reshape(-1),), g.reshape(-1, g.shape[-1]),
                          accumulate=True)
        return dtable.to(ctx.table_dtype), None, None


def _vocab_parallel_embed(table, tokens, iota: bool):
    """The lookup of a DTensor table on the TP mesh under ``local_map``:
    sharded on vocab (``Shard(0)``), each rank looks up its rows and the
    output is the ``Partial`` sum, which the model's ``constrain`` or
    the next block settles (an all-reduce, or a reduce-scatter under
    SP); a replicated table looks up every token."""
    from torch.distributed.tensor import Partial
    from torch.distributed.tensor.experimental import local_map

    (placement,) = table.placements
    mesh = table.device_mesh
    lo, out = 0, placement
    if placement.is_shard():
        rows = -(-table.shape[0] // mesh.size())  # torch.chunk's shard rows
        lo, out = mesh.get_local_rank() * rows, Partial()

    def lookup(t, tok):
        if iota:
            return _ShardLookup.apply(t, tok, lo)
        mine = (tok >= lo) & (tok < lo + t.shape[0])
        idx = torch.where(mine, tok - lo, torch.zeros_like(tok))
        return t[idx] * mine[..., None].to(t.dtype)

    return local_map(lookup, out_placements=[out],
                     in_placements=([placement], None),
                     device_mesh=mesh)(table, tokens)


def _call(tree, fn, *args):
    """``fn(tree, *args)``; a module tree (``parallel.shard.ParamTree``)
    runs it through its ``__call__``, where FSDP2 gathers its params."""
    if isinstance(tree, torch.nn.Module):
        return tree(fn, *args)
    return fn(tree, *args)


def _forward(params, tokens, cfg, constrain, attn_fn, positions):
    dt = cfg.dtype
    s = tokens.shape[1]
    table = params["tok_embeddings"]["embedding"].to(dt)
    x = constrain(_embed(table, tokens, cfg.iota_embed))
    cos, sin = rope_cos_sin(s, cfg.head_dim, positions=positions,
                            device=tokens.device)
    block = _tp_block if is_dtensor(table) else _block
    for i in range(cfg.n_layers):
        lp = params[f"layers_{i}"]
        if cfg.remat and torch.is_grad_enabled():
            x = checkpoint(_call, lp, block, x, cfg, cos, sin, constrain,
                           attn_fn, use_reentrant=False)
        else:
            x = _call(lp, block, x, cfg, cos, sin, constrain, attn_fn)
    x = _rmsnorm(x, params["norm"]["scale"], cfg.norm_eps)
    return _proj(x, params["output"]["kernel"], dt)


def apply_llama(
    params: Any,
    tokens: torch.Tensor,
    cfg: LlamaConfig,
    constrain: Constrain = _identity,
    attn_fn: AttnFn = None,
    positions: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """[B, S] int tokens -> [B, S, vocab] logits in cfg.dtype (the loss
    upcasts inside its reductions). ``positions`` [S]: global RoPE
    position of each slot; None = 0..S-1. ``attn_fn`` None: the einsum
    attention (scores in the compute dtype, fp32 softmax under a -inf
    mask, GQA through a grouped query view with no repeated K/V).

    ``params`` is the param dict, or its module view laid out on a mesh
    (``parallel.shard.shard_params``): then each block runs through its
    module, FSDP2 gathering the block's params; under TP the residual
    stream is a DTensor on the TP mesh and each block runs on local
    shards (:func:`_tp_block`). The logits come
    back whole on every rank, gathered in the compute dtype, so the
    loss is the one-device fp32 cross-entropy."""
    if not isinstance(params, torch.nn.Module):
        return _forward(params, tokens, cfg, constrain, attn_fn, positions)
    logits = params(_forward, tokens, cfg, constrain, attn_fn, positions)
    return logits.full_tensor() if is_dtensor(logits) else logits


def make_forward(
    cfg: LlamaConfig,
    constrain: Constrain = _identity,
    attn_fn: AttnFn = None,
    positions: Optional[torch.Tensor] = None,
):
    """Trainer-contract forward: next-token cross-entropy on (inputs,
    targets) token batches (datasets.TokenStream);
    ``forward(params, model_state, batch, step_rng) -> (loss,
    model_state, aux)``."""
    from tpu_hpc_torch.models.losses import cross_entropy

    def forward(params, model_state, batch, step_rng):
        inputs, targets = batch
        logits = apply_llama(params, inputs, cfg, constrain, attn_fn,
                             positions)
        return cross_entropy(logits, targets), model_state, {}

    return forward
