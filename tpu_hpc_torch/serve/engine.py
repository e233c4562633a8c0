"""The serving engine: prefill + single-token decode over a KV cache.

Port of the JAX package's ``serve/engine.py``. The engine owns ONE
preallocated KV cache (``[layers, slots, seq, kv_heads, head_dim]`` for
K and V) on one device, and exactly two program shapes run in steady
state:

  * **prefill** -- full causal attention over one request's prompt,
    padded up to a bucket length, writing the prompt's K/V into that
    request's slot rows and returning the first greedy token;
  * **decode** -- ONE token for EVERY slot: append each token's K/V at
    its slot's position counter, attend over the cache (length-masked
    per slot), return the next greedy token per slot.

What changes from JAX to PyTorch:

  * the mesh becomes a single ``torch.device``;
  * the AOT executable table becomes a dict of built program closures,
    one per bucket plus the decode step. ``compile_count`` still counts
    builds, so the zero-rebuild-after-warmup contract holds and the
    same recompile guards read it. (CUDA graphs per program are a later
    PR's work; the programs run eagerly.)
  * JAX's donated, immutable cache buffers become IN-PLACE updates:
    every program writes the new K/V into ``engine.ks`` / ``engine.vs``
    by index assignment and returns only its token(s).

The model math is a functional replay of ``models/llama2.py`` over the
same param tree, with the JAX engine's dtype promotions (compute-dtype
matmuls, fp32 RMSNorm/RoPE/softmax), so greedy decode with the cache is
token-exact against the no-cache forward pass.

Precision flags are set at import and stated here: float32 matmuls and
cuDNN convolutions run in full float32, never TF32
(``torch.backends.cuda.matmul.allow_tf32 = False``,
``torch.backends.cudnn.allow_tf32 = False``), so a float32 engine on
the card computes what the float32 reference computes.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Sequence, Tuple

import numpy as np
import torch

from tpu_hpc_torch.models import llama2
from tpu_hpc_torch.obs import get_registry, span
from tpu_hpc_torch.runtime import resolve_device

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    """Static serving shape: everything a built program depends on.

    ``slots``: fixed decode batch width. ``max_seq_len``: KV-cache
    capacity per slot (prompt + generated tokens). ``prefill_buckets``:
    the padded prompt lengths prefill builds for -- a prompt pads up to
    the smallest bucket that holds it. ``cache_dtype``: KV storage
    dtype (defaults to the model's compute dtype).
    """

    slots: int = 8
    max_seq_len: int = 256
    prefill_buckets: Tuple[int, ...] = (64, 128)
    cache_dtype: Any = None

    def __post_init__(self):
        if self.slots < 1:
            raise ValueError(f"slots must be >= 1, got {self.slots}")
        if not self.prefill_buckets:
            raise ValueError("need at least one prefill bucket")
        bad = [b for b in self.prefill_buckets if b > self.max_seq_len]
        if bad:
            raise ValueError(
                f"prefill buckets {bad} exceed the cache capacity "
                f"max_seq_len={self.max_seq_len}"
            )
        object.__setattr__(
            self, "prefill_buckets", tuple(sorted(self.prefill_buckets))
        )

    def bucket_for(self, prompt_len: int) -> int:
        """Smallest built bucket holding ``prompt_len`` tokens."""
        for b in self.prefill_buckets:
            if prompt_len <= b:
                return b
        raise ValueError(
            f"prompt of {prompt_len} tokens exceeds the largest "
            f"prefill bucket {self.prefill_buckets[-1]}"
        )


# ---------------------------------------------------------------------
# Functional Llama forward over the raw param dict (the JAX engine's
# helpers, same promotions, same contractions).
# ---------------------------------------------------------------------


def _dense(x: torch.Tensor, kernel: torch.Tensor, dtype) -> torch.Tensor:
    """Bias-free Dense in the compute dtype: promote both operands,
    contract the trailing dim with the flax ``[in, out]`` kernel."""
    return torch.matmul(x.to(dtype), kernel.to(dtype))


def _rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    """RMSNorm in fp32 with a learned scale (llama2.RMSNorm)."""
    xf = x.to(torch.float32)
    normed = xf * torch.rsqrt(
        torch.mean(xf * xf, dim=-1, keepdim=True) + eps
    )
    return (normed * scale.to(torch.float32)).to(x.dtype)


def _embed(params: Dict, tokens: torch.Tensor, cfg: llama2.LlamaConfig):
    """Token embedding lookup in the compute dtype."""
    table = params["tok_embeddings"]["embedding"].to(cfg.dtype)
    return table[tokens]


def _attn_out_proj(h, lp, cfg):
    b, s = h.shape[0], h.shape[1]
    return _dense(
        h.reshape(b, s, cfg.n_heads * cfg.head_dim),
        lp["attention"]["wo"]["kernel"], cfg.dtype,
    )


def _mlp(x, lp, cfg):
    gate = _dense(x, lp["feed_forward"]["w1"]["kernel"], cfg.dtype)
    up = _dense(x, lp["feed_forward"]["w3"]["kernel"], cfg.dtype)
    return _dense(
        torch.nn.functional.silu(gate) * up,
        lp["feed_forward"]["w2"]["kernel"], cfg.dtype,
    )


def _qkv(x, lp, cfg):
    b, s = x.shape[0], x.shape[1]
    hd, n_kv = cfg.head_dim, cfg.kv_heads
    q = _dense(x, lp["attention"]["wq"]["kernel"], cfg.dtype)
    k = _dense(x, lp["attention"]["wk"]["kernel"], cfg.dtype)
    v = _dense(x, lp["attention"]["wv"]["kernel"], cfg.dtype)
    return (
        q.reshape(b, s, cfg.n_heads, hd),
        k.reshape(b, s, n_kv, hd),
        v.reshape(b, s, n_kv, hd),
    )


def _grouped_attention(q, k, v, mask, cfg):
    """The model's einsum attention with an explicit mask: scores in
    the compute dtype, fp32 softmax, GQA via the grouped query view
    (no repeated K/V)."""
    b, s_q = q.shape[0], q.shape[1]
    n_kv = cfg.kv_heads
    groups = cfg.n_heads // n_kv
    qg = q.reshape(b, s_q, n_kv, groups, cfg.head_dim)
    scale = cfg.head_dim ** -0.5
    scores = torch.einsum("bqhgd,bkhd->bhgqk", qg, k) * scale
    scores = scores.to(torch.float32).masked_fill(~mask, float("-inf"))
    probs = torch.softmax(scores, dim=-1).to(cfg.dtype)
    out = torch.einsum("bhgqk,bkhd->bqhgd", probs, v)
    return out.reshape(b, s_q, cfg.n_heads, cfg.head_dim)


def _logits_head(x, params, cfg):
    x = _rmsnorm(x, params["norm"]["scale"], cfg.norm_eps)
    return _dense(x, params["output"]["kernel"], cfg.dtype)


def make_prefill_fn(cfg: llama2.LlamaConfig, bucket: int, slots: int):
    """Prefill program for one padded bucket length.

    ``(params, ks, vs, tokens [1, bucket], true_len, slot)`` ->
    ``next_token`` (0-d int tensor on the device): full causal
    attention over the padded prompt, the prompt's K/V written IN PLACE
    into ``ks``/``vs`` slot ``slot`` rows ``[0:bucket)`` (the padded
    tail is garbage the per-slot length mask never reads), greedy token
    from the logits at row ``true_len - 1``.
    """
    del slots  # shape comes from the cache operand

    def prefill(params, ks, vs, tokens, true_len: int, slot: int):
        x = _embed(params, tokens, cfg)
        cos, sin = llama2.rope_cos_sin(
            bucket, cfg.head_dim, device=tokens.device
        )
        causal = torch.tril(
            torch.ones((bucket, bucket), dtype=torch.bool,
                       device=tokens.device)
        )
        mask = causal[None, None, None, :, :]
        for i in range(cfg.n_layers):
            lp = params[f"layers_{i}"]
            h = _rmsnorm(x, lp["attention_norm"]["scale"], cfg.norm_eps)
            q, k, v = _qkv(h, lp, cfg)
            q = llama2.apply_rope(q, cos, sin)
            k = llama2.apply_rope(k, cos, sin)
            ks[i, slot, :bucket] = k[0].to(ks.dtype)
            vs[i, slot, :bucket] = v[0].to(vs.dtype)
            attn = _grouped_attention(
                q, k.to(cfg.dtype), v.to(cfg.dtype), mask, cfg
            )
            x = x + _attn_out_proj(attn, lp, cfg)
            h = _rmsnorm(x, lp["ffn_norm"]["scale"], cfg.norm_eps)
            x = x + _mlp(h, lp, cfg)
        last = x[:, true_len - 1:true_len]
        logits = _logits_head(last, params, cfg)
        return torch.argmax(logits[0, 0], dim=-1).to(torch.int32)

    return prefill


def make_decode_fn(cfg: llama2.LlamaConfig, cache_len: int):
    """The single-token decode program over every slot at once.

    ``(params, ks, vs, tokens [slots], pos [slots])`` ->
    ``next_tokens [slots]``: each slot's incoming token is embedded,
    rotated to its own position ``pos[slot]``, its K/V written IN PLACE
    at that position, and attention runs over cache columns
    ``<= pos[slot]`` -- stale entries from an evicted request and the
    padded prefill tail are masked out, which is what makes slot reuse
    safe.
    """

    def decode(params, ks, vs, tokens, pos):
        slots = tokens.shape[0]
        dev = tokens.device
        x = _embed(params, tokens[:, None], cfg)  # [slots, 1, dim]
        cos, sin = llama2.rope_cos_sin(1, cfg.head_dim, positions=pos)
        cos, sin = cos[:, None, :], sin[:, None, :]  # [slots, 1, D/2]
        col = torch.arange(cache_len, device=dev)
        mask = (col[None, :] <= pos[:, None])[:, None, None, None, :]
        rows = torch.arange(slots, device=dev)
        pos_l = pos.long()
        for i in range(cfg.n_layers):
            lp = params[f"layers_{i}"]
            h = _rmsnorm(x, lp["attention_norm"]["scale"], cfg.norm_eps)
            q, k, v = _qkv(h, lp, cfg)
            q = llama2.apply_rope(q, cos, sin)
            k = llama2.apply_rope(k, cos, sin)
            ks[i, rows, pos_l] = k[:, 0].to(ks.dtype)
            vs[i, rows, pos_l] = v[:, 0].to(vs.dtype)
            attn = _grouped_attention(
                q, ks[i].to(cfg.dtype), vs[i].to(cfg.dtype), mask, cfg,
            )
            x = x + _attn_out_proj(attn, lp, cfg)
            h = _rmsnorm(x, lp["ffn_norm"]["scale"], cfg.norm_eps)
            x = x + _mlp(h, lp, cfg)
        logits = _logits_head(x, params, cfg)  # [slots, 1, vocab]
        return torch.argmax(logits[:, 0], dim=-1).to(torch.int32)

    return decode


class Engine:
    """Prefill/decode programs over one resident KV cache.

    Owns the cache and the program table; the scheduler
    (serve/scheduler.py) drives it one prefill or decode at a time.
    ``compile_count`` increments on every program build -- after
    :meth:`warmup` it must stay put (the zero-rebuild guard).
    """

    def __init__(
        self,
        params: Any,
        cfg: llama2.LlamaConfig,
        serve_cfg: ServeConfig,
        device: Any = "cuda",
    ):
        from tpu_hpc_torch.serve.weights import place_params

        if cfg.n_heads % cfg.kv_heads:
            raise ValueError(
                f"n_heads {cfg.n_heads} must be a multiple of kv_heads "
                f"{cfg.kv_heads}"
            )
        if serve_cfg.max_seq_len > cfg.max_seq_len:
            raise ValueError(
                f"cache capacity {serve_cfg.max_seq_len} exceeds the "
                f"model's max_seq_len {cfg.max_seq_len}"
            )
        self.cfg = cfg
        self.serve_cfg = serve_cfg
        self.device = resolve_device(device)
        self.params = place_params(params, cfg, self.device)
        reg = get_registry()
        reg.describe(
            "serve_prefill_s",
            "Prompt prefill forward, dispatch to first-token fetch "
            "(s; one slab prompt or one paged chunk)",
        )
        reg.describe(
            "serve_decode_s",
            "One batched decode step across all slots, dispatch to "
            "token fetch (s)",
        )

        self._init_cache()

        self._execs: Dict[Any, Any] = {}
        self.compile_count = 0

    def _cache_shape(self) -> Tuple[int, ...]:
        """Resident K (and V) cache shape; the paged engine
        (serve/paging.py) overrides this with its block pool."""
        return (
            self.cfg.n_layers, self.serve_cfg.slots,
            self.serve_cfg.max_seq_len, self.cfg.kv_heads,
            self.cfg.head_dim,
        )

    def _init_cache(self) -> None:
        cache_dtype = self.serve_cfg.cache_dtype or self.cfg.dtype
        shape = self._cache_shape()
        self.ks = torch.zeros(shape, dtype=cache_dtype, device=self.device)
        self.vs = torch.zeros(shape, dtype=cache_dtype, device=self.device)
        self.cache_bytes = 2 * self.ks.numel() * self.ks.element_size()

    # -- program table -------------------------------------------------
    def _build(self, key):
        """Build one program (counted)."""
        self.compile_count += 1
        if key[0] == "prefill":
            return make_prefill_fn(self.cfg, key[1], self.serve_cfg.slots)
        return make_decode_fn(self.cfg, self.serve_cfg.max_seq_len)

    def _get_exec(self, key):
        if key not in self._execs:
            self._execs[key] = self._build(key)
        return self._execs[key]

    def warmup(self) -> int:
        """Build every steady-state program up front: one prefill per
        bucket + the decode step. Returns the program count -- after
        this, ``compile_count`` must never move."""
        for b in self.serve_cfg.prefill_buckets:
            self._get_exec(("prefill", b))
        self._get_exec(("decode",))
        return self.compile_count

    @property
    def compile_count_total(self) -> int:
        """Program builds across the whole serving unit (the slab
        engine IS the unit)."""
        return self.compile_count

    # -- serving ops ----------------------------------------------------
    def _rep_arr(self, value) -> torch.Tensor:
        """Host int32 value -> device tensor (the JAX engine's
        replicated ``device_put``)."""
        return torch.as_tensor(np.asarray(value, np.int32), device=self.device)

    @torch.inference_mode()
    def prefill(self, slot: int, prompt: Sequence[int]) -> int:
        """Run one request's prompt through the bucketed prefill
        program, writing its K/V into ``slot``; returns the first
        greedy token. ``int(tok)`` inside the ``prefill`` span is the
        device fetch, so the span measures dispatch-to-result."""
        n = len(prompt)
        if n < 1:
            raise ValueError("empty prompt")
        if not 0 <= slot < self.serve_cfg.slots:
            raise ValueError(f"slot {slot} out of range")
        bucket = self.serve_cfg.bucket_for(n)
        padded = np.zeros((1, bucket), np.int32)
        padded[0, :n] = np.asarray(prompt, np.int32)
        exec_ = self._get_exec(("prefill", bucket))
        with span("prefill", hist="serve_prefill_s", n=bucket):
            tok = exec_(
                self.params, self.ks, self.vs,
                self._rep_arr(padded).long(), n, slot,
            )
            return int(tok)

    @torch.inference_mode()
    def decode(
        self, tokens: Sequence[int], positions: Sequence[int]
    ) -> np.ndarray:
        """One decode step for every slot: ``tokens[s]`` enters at
        position ``positions[s]``. Returns the next greedy token per
        slot (inactive slots produce garbage the scheduler ignores).
        The one host fetch of the step's tokens rides inside the span."""
        exec_ = self._get_exec(("decode",))
        with span("decode", hist="serve_decode_s"):
            toks = exec_(
                self.params, self.ks, self.vs,
                self._rep_arr(np.asarray(tokens, np.int32)).long(),
                self._rep_arr(np.asarray(positions, np.int32)),
            )
            return toks.cpu().numpy()
