"""Speculative decoding + seeded sampling on the paged serving engine.

Port of the JAX package's ``serve/spec.py``. The decode loop is
latency-bound: one full target forward per emitted token. Speculative
decoding (Leviathan et al., arXiv 2211.17192) drafts ``k`` cheap
candidate tokens per slot and verifies all ``k + 1`` positions in ONE
batched target forward over the paged cache -- accepted drafts commit,
the first rejection is corrected by a draw from the residual
distribution, and the target distribution is preserved (greedy streams
are token-exact). Two draft sources:

* **draft model** (``mode="draft"``) -- a small llama with its own
  mirrored paged KV pool drafts ``k`` tokens per slot (``k`` sampled
  decode steps);
* **prompt lookup** (``mode="ngram"``) -- the most recent earlier
  occurrence of the request's trailing n-gram in its OWN token history
  proposes the tokens that followed it (arXiv 2304.04487).

**Seeded sampling.** Temperature/top-p sampling uses per-request seeds,
and every draw's key folds in ``(request seed, absolute position,
stream)`` through the port's threefry chain (``serve/prng.py``, equal to
``jax.random`` bit for bit) -- never the slot, the batch or a step
counter. Streams: 0 = the emitted-token draw (prefill first token,
verify bonus/residual), 1 = the draft model's own draw, 2 = the
acceptance uniform. Greedy (``temperature == 0``) makes every draw a
one-hot categorical, exactly ``argmax``.

**Attention** follows the engine's ``PagedConfig.kernel``: ``"gather"``
reads each slot's dense view through its block table (what the JAX
programs compute); ``"cuda"`` runs the hand-written kernels of
``kernels/paged_attention.py`` -- one paged decode launch per layer for
a draft step, one per layer for the verify step over ``slots * (k+1)``
pseudo-slots (row ``j`` of slot ``s`` is a pseudo-slot with ``s``'s
table row, position ``pos + j`` and ``s``'s active flag, so the
kernel's "keys <= pos" rule IS the verify's causal mask), and the paged
prefill kernel under the spec prefill. On CPU tensors the wrappers run
their plain versions.

**Page accounting.** Admission reserves ``ceil((prompt + max_new) /
block_size)`` pages, and a verify step writes at most positions
``pos .. pos + n_valid`` with ``n_valid <= remaining - 1``: every
speculative write lands inside the reservation, and accept/reject churn
moves no page through the allocator. The draft pool mirrors the
target's admissions one-for-one.
"""
from __future__ import annotations

import dataclasses
import time
import weakref
import zlib
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from tpu_hpc_torch.kernels.paged_attention import paged_decode_attention
from tpu_hpc_torch.models import llama2
from tpu_hpc_torch.obs import get_bus, get_registry, span
from tpu_hpc_torch.serve import prng
from tpu_hpc_torch.serve.engine import (
    _attn_out_proj,
    _embed,
    _grouped_attention,
    _logits_head,
    _mlp,
    _qkv,
    _rmsnorm,
)

SPEC_MODES = ("draft", "ngram")

# Key streams: one per independent random decision at a position.
_STREAM_EMIT = 0    # the emitted-token draw (bonus/residual/prefill)
_STREAM_DRAFT = 1   # the draft model's own sampling draw
_STREAM_ACCEPT = 2  # the acceptance uniform

_SCRATCH_BLOCK = 0  # serve.paging.SCRATCH_BLOCK


@dataclasses.dataclass(frozen=True)
class SpecConfig:
    """Static speculative-decoding shape.

    ``mode``: ``"draft"`` (draft-model path; needs draft params) or
    ``"ngram"`` (prompt-lookup self-speculation -- no extra model).
    ``k``: drafted tokens per verify step -- the verify program's
    fixed width (``k + 1`` query rows per slot). ``ngram``: longest
    trailing n-gram the prompt-lookup matcher tries (it falls back to
    shorter grams down to 1)."""

    mode: str = "ngram"
    k: int = 4
    ngram: int = 2

    def __post_init__(self):
        if self.mode not in SPEC_MODES:
            raise ValueError(
                f"unknown spec mode {self.mode!r} "
                f"(known: {', '.join(SPEC_MODES)})"
            )
        if self.k < 1:
            raise ValueError(f"spec k must be >= 1, got {self.k}")
        if self.ngram < 1:
            raise ValueError(
                f"ngram order must be >= 1, got {self.ngram}"
            )


def default_draft_config(
    cfg: llama2.LlamaConfig,
) -> llama2.LlamaConfig:
    """A development draft architecture for ``mode="draft"`` with no
    checkpoint: the target's config at half depth. A random-init draft
    accepts ~1/vocab of its guesses and only proves wiring."""
    return dataclasses.replace(
        cfg, n_layers=max(1, cfg.n_layers // 2)
    )


def derive_request_seed(rid: str, seed: Optional[int] = None) -> int:
    """The per-request sampling seed: the explicit one when given,
    else a stable hash of the request id -- NEVER anything positional
    (slot, batch index, step), so replay determinism survives slot
    reassignment and batch-composition changes."""
    if seed is not None:
        return int(seed) & 0x7FFFFFFF
    return zlib.crc32(rid.encode()) & 0x7FFFFFFF


# ---------------------------------------------------------------------
# Host-side prompt lookup (the self-speculative draft source)
# ---------------------------------------------------------------------


def ngram_propose(
    history: Sequence[int], k: int, max_n: int = 2
) -> List[int]:
    """Prompt-lookup drafting: find the most recent EARLIER occurrence
    of the history's trailing ``n``-gram (longest first, down to 1)
    and propose the ``k`` tokens that followed it. Empty when nothing
    matches -- the verify step then degenerates to a plain (sampled)
    single-token decode."""
    h = list(history)
    if len(h) < 2:
        return []
    for n in range(min(max_n, len(h) - 1), 0, -1):
        tail = h[-n:]
        for start in range(len(h) - n - 1, -1, -1):
            if h[start:start + n] == tail:
                follow = h[start + n:start + n + k]
                if follow:
                    return [int(t) for t in follow]
    return []


class NgramIndex:
    """Incremental prompt-lookup state for ONE request, proposing
    exactly what ``ngram_propose`` proposes over the same history.

    ``append`` is O(max_n) per committed token and ``propose`` is
    O(max_n + k): the map remembers each gram's two most recent start
    positions -- the trailing gram's own occurrence is always the most
    recent, so the *prior* one (what the rescan finds) sits in the
    second slot."""

    def __init__(
        self, history: Sequence[int] = (), max_n: int = 2
    ) -> None:
        self.max_n = max_n
        self.history: List[int] = []
        self._starts: Dict[
            Tuple[int, ...], Tuple[int, Optional[int]]
        ] = {}
        for tok in history:
            self.append(tok)

    def append(self, tok: int) -> None:
        h = self.history
        h.append(int(tok))
        end = len(h)
        for n in range(1, min(self.max_n, end) + 1):
            g = tuple(h[end - n:end])
            prev = self._starts.get(g)
            self._starts[g] = (
                end - n, prev[0] if prev is not None else None
            )

    def propose(self, k: int) -> List[int]:
        h = self.history
        if len(h) < 2:
            return []
        for n in range(min(self.max_n, len(h) - 1), 0, -1):
            entry = self._starts.get(tuple(h[-n:]))
            start = None if entry is None else entry[1]
            if start is None:
                continue
            return h[start + n:start + n + k]
        return []


# ---------------------------------------------------------------------
# The shared sampling head: ONE token rule for draft and target
# ---------------------------------------------------------------------


def _one_hot(idx: torch.Tensor, n: int) -> torch.Tensor:
    """float32 one-hot rows of ``idx`` -- by a scatter, since
    ``F.one_hot`` reads its indices' range back to the host (a sync
    inside the program on the card)."""
    out = torch.zeros(*idx.shape, n, dtype=torch.float32, device=idx.device)
    return out.scatter_(-1, idx.long()[..., None], 1.0)


def sampling_probs(
    logits: torch.Tensor, temp: torch.Tensor, top_p: torch.Tensor
) -> torch.Tensor:
    """``[slots, n, vocab]`` logits + per-slot temperature / top-p ->
    the per-row token distributions BOTH the draft and the target
    sample from (rejection sampling is lossless only against a shared
    rule), float32. ``temp == 0`` selects the greedy one-hot -- exact
    {0, 1} floats, so the downstream categorical is exactly argmax."""
    lf = logits.to(torch.float32)
    vocab = lf.shape[-1]
    greedy = _one_hot(torch.argmax(lf, dim=-1), vocab)
    t = temp.to(torch.float32)[:, None, None]
    safe_t = torch.where(t > 0, t, torch.ones_like(t))
    probs = torch.softmax(lf / safe_t, dim=-1)
    # Nucleus filter: keep the smallest prefix of the sorted
    # distribution whose mass reaches top_p (the crossing token
    # included; the top-1 token always survives). Stable sort, like
    # jnp.argsort: ties keep index order.
    order = torch.argsort(-probs, dim=-1, stable=True)
    sorted_p = torch.gather(probs, -1, order)
    csum = torch.cumsum(sorted_p, dim=-1)
    keep_sorted = (csum - sorted_p) < (
        top_p.to(torch.float32)[:, None, None]
    )
    keep = torch.zeros_like(keep_sorted).scatter(-1, order, keep_sorted)
    filtered = torch.where(keep, probs, torch.zeros_like(probs))
    filtered = filtered / torch.sum(filtered, dim=-1, keepdim=True)
    return torch.where(t > 0, filtered, greedy)


def sample_token(
    logits: torch.Tensor,
    seed: int,
    position: int,
    temp: float,
    top_p: float,
) -> torch.Tensor:
    """One token from one ``[vocab]`` logits row under the shared rule
    -- the seeded first-token head of the spec prefill (stream 0 at the
    producing row's absolute position). Host numbers in (filled on the
    logits' device, never copied there), 0-d int32 out."""
    dev = logits.device
    p = sampling_probs(
        logits[None, None, :],
        torch.full((1,), temp, dtype=torch.float32, device=dev),
        torch.full((1,), top_p, dtype=torch.float32, device=dev),
    )[0, 0]
    k = prng.position_keys(
        torch.full((), seed, dtype=torch.int64, device=dev), position,
        _STREAM_EMIT,
    )
    return prng.categorical_probs(k, p).to(torch.int32)


# ---------------------------------------------------------------------
# Programs
# ---------------------------------------------------------------------


def _rope_for(positions: torch.Tensor, head_dim: int):
    """Per-row RoPE tables for a ``[slots, n]`` position matrix."""
    cos, sin = llama2.rope_cos_sin(
        1, head_dim, positions=positions.reshape(-1)
    )
    shape = (*positions.shape, head_dim // 2)
    return cos.reshape(shape), sin.reshape(shape)


def _paged_rows_attention(q, ks_l, vs_l, tables, qpos, active, cfg,
                          block_size, max_blocks, use_kernel):
    """Attention of ``[slots, n, heads, d]`` query rows at absolute
    positions ``qpos [slots, n]`` over each slot's paged view, keys
    ``<= qpos``. ``use_kernel``: one :func:`paged_decode_attention`
    call over ``slots * n`` pseudo-slots (row ``j`` of slot ``s``: slot
    ``s``'s table row, position ``qpos[s, j]``, ``active[s]``); else
    the gathered dense view under the mask ``col <= qpos`` (the JAX
    programs' formulation)."""
    slots, n = qpos.shape
    hd, n_kv = cfg.head_dim, cfg.kv_heads
    groups = cfg.n_heads // n_kv
    if use_kernel:
        rows = slots * n
        qd = q.to(cfg.dtype).reshape(rows, n_kv, groups, hd).contiguous()
        ctx = paged_decode_attention(
            qd, ks_l, vs_l,
            tables.repeat_interleave(n, dim=0),
            qpos.reshape(rows).to(torch.int32),
            active.repeat_interleave(n).to(torch.int32),
            block_size=block_size, max_blocks=max_blocks,
        )
        return ctx.reshape(slots, n, cfg.n_heads, hd)
    cache_cap = max_blocks * block_size
    col = torch.arange(cache_cap, device=qpos.device)
    mask = (col[None, None, :] <= qpos[:, :, None])[:, None, None, :, :]
    view_ids = tables[:, :max_blocks].long()
    k_view = ks_l[view_ids].reshape(slots, cache_cap, n_kv, hd)
    v_view = vs_l[view_ids].reshape(slots, cache_cap, n_kv, hd)
    return _grouped_attention(
        q, k_view.to(cfg.dtype), v_view.to(cfg.dtype), mask, cfg
    )


def make_spec_draft_fn(
    cfg: llama2.LlamaConfig,
    k: int,
    block_size: int,
    max_blocks: int,
    table_width: int,
    kernel: str = "gather",
):
    """The draft program: ``k`` sampled decode steps of the draft
    model over every slot at once.

    ``(params, ks, vs, tokens [slots], pos [slots], tables [slots,
    table_width], active [slots], n_valid [slots], seeds [slots],
    temps [slots], top_ps [slots])`` -> ``(draft_tokens [slots, k]
    int32, draft_probs [slots, k, vocab] float32)``: step ``j`` embeds
    the previous token at position ``pos + j``, writes its K/V IN PLACE
    into the draft pool (scratch-redirected for inactive slots and
    ``j >= n_valid``), and SAMPLES the next candidate with the shared
    rule under the per-request key (stream 1 at the producing row's
    position). The per-step distributions stay on the device for the
    verify step's rejection test."""
    del table_width
    use_kernel = kernel == "cuda"

    def draft(params, ks, vs, tokens, pos, tables, active, n_valid,
              seeds, temps, top_ps):
        slots = tokens.shape[0]
        rows = torch.arange(slots, device=tokens.device)
        cur = tokens.long()
        out_toks, out_probs = [], []
        for j in range(k):
            pj = pos.long() + j
            x = _embed(params, cur[:, None], cfg)
            cos, sin = _rope_for(pj[:, None], cfg.head_dim)
            write_ok = (active > 0) & (j < n_valid)
            pb = torch.where(
                write_ok, tables[rows, pj // block_size].long(),
                torch.full_like(pj, _SCRATCH_BLOCK),
            )
            off = pj % block_size
            for i in range(cfg.n_layers):
                lp = params[f"layers_{i}"]
                h = _rmsnorm(x, lp["attention_norm"]["scale"], cfg.norm_eps)
                q, kk, v = _qkv(h, lp, cfg)
                q = llama2.apply_rope(q, cos, sin)
                kk = llama2.apply_rope(kk, cos, sin)
                ks[i, pb, off] = kk[:, 0].to(ks.dtype)
                vs[i, pb, off] = v[:, 0].to(vs.dtype)
                attn = _paged_rows_attention(
                    q, ks[i], vs[i], tables, pj[:, None], active, cfg,
                    block_size, max_blocks, use_kernel,
                )
                x = x + _attn_out_proj(attn, lp, cfg)
                h = _rmsnorm(x, lp["ffn_norm"]["scale"], cfg.norm_eps)
                x = x + _mlp(h, lp, cfg)
            logits = _logits_head(x, params, cfg)  # [slots, 1, vocab]
            p = sampling_probs(logits, temps, top_ps)[:, 0]
            keys = prng.position_keys(seeds, pj, _STREAM_DRAFT)
            tok = prng.categorical_probs(keys, p)
            out_toks.append(tok.to(torch.int32))
            out_probs.append(p)
            cur = tok
        return torch.stack(out_toks, dim=1), torch.stack(out_probs, dim=1)

    return draft


def make_spec_verify_fn(
    cfg: llama2.LlamaConfig,
    k: int,
    block_size: int,
    max_blocks: int,
    table_width: int,
    onehot_q: bool,
    kernel: str = "gather",
):
    """The verify program: ``k + 1`` query rows per slot through the
    target in ONE forward over the paged cache, plus the whole
    rejection-sampling decision on the device.

    ``(params, ks, vs, tokens [slots, k+1], pos [slots], tables,
    active, n_valid, [draft_probs [slots, k, vocab],] seeds, temps,
    top_ps)`` -> ``(out_tokens [slots, k+1], n_accepted [slots])``,
    both int32. Row ``j`` carries token ``j`` of ``[last_committed,
    d_1 .. d_k]`` at absolute position ``pos + j``; every row's K/V is
    written IN PLACE into page ``tables[s, (pos+j)//bs]``
    (scratch-redirected when inactive or ``j > n_valid``) BEFORE
    attention, so each row attends to the cache AND to the candidate
    rows before it under the causal rule ``key <= pos + j``.

    Acceptance per Leviathan et al.: draft ``d_{j+1}`` (drawn from
    ``q_j``) accepts iff ``u_j * q_j(d) < p_j(d)`` with ``u_j`` from
    the (seed, position, stream-2) key; the emitting row is ALWAYS
    index ``n_accepted`` -- a rejection draws from the residual
    ``norm(max(p - q, 0))`` there, a clean sweep draws the bonus from
    ``p`` (``q`` zeroed makes the residual collapse to ``p``). With
    ``onehot_q=True`` (prompt-lookup drafts) ``q`` is the one-hot of
    the proposed token, built in the program.

    Rejected rows' K/V writes land at positions the per-slot length
    rule keeps unreadable until the NEXT verify step overwrites them --
    the rollback is positional, so the allocator sees no traffic."""
    del table_width
    n_rows = k + 1
    use_kernel = kernel == "cuda"

    def verify(params, ks, vs, tokens, pos, tables, active, n_valid,
               *rest):
        if onehot_q:
            (seeds, temps, top_ps) = rest
            draft_probs = None
        else:
            (draft_probs, seeds, temps, top_ps) = rest
        slots = tokens.shape[0]
        dev = tokens.device
        rows_j = torch.arange(n_rows, device=dev)
        qpos = pos.long()[:, None] + rows_j[None, :]
        x = _embed(params, tokens.long(), cfg)  # [slots, k+1, dim]
        cos, sin = _rope_for(qpos, cfg.head_dim)
        write_ok = (active[:, None] > 0) & (
            rows_j[None, :] <= n_valid.long()[:, None]
        )
        pb = torch.where(
            write_ok, torch.gather(tables.long(), 1, qpos // block_size),
            torch.full_like(qpos, _SCRATCH_BLOCK),
        )
        off = qpos % block_size
        for i in range(cfg.n_layers):
            lp = params[f"layers_{i}"]
            h = _rmsnorm(x, lp["attention_norm"]["scale"], cfg.norm_eps)
            q, kk, v = _qkv(h, lp, cfg)
            q = llama2.apply_rope(q, cos, sin)
            kk = llama2.apply_rope(kk, cos, sin)
            # Every row's K/V lands before any row attends: row j must
            # see rows < j of this same step.
            ks[i, pb, off] = kk.to(ks.dtype)
            vs[i, pb, off] = v.to(vs.dtype)
            attn = _paged_rows_attention(
                q, ks[i], vs[i], tables, qpos, active, cfg, block_size,
                max_blocks, use_kernel,
            )
            x = x + _attn_out_proj(attn, lp, cfg)
            h = _rmsnorm(x, lp["ffn_norm"]["scale"], cfg.norm_eps)
            x = x + _mlp(h, lp, cfg)
        logits = _logits_head(x, params, cfg)  # [slots, k+1, vocab]
        p = sampling_probs(logits, temps, top_ps)

        drafts = tokens[:, 1:].long()  # [slots, k]: d_1 .. d_k
        if onehot_q:
            q_probs = _one_hot(drafts, cfg.vocab_size)
        else:
            q_probs = draft_probs.to(torch.float32)
        p_d = torch.gather(p[:, :k], -1, drafts[..., None])[..., 0]
        q_d = torch.gather(q_probs, -1, drafts[..., None])[..., 0]
        u_keys = prng.position_keys(
            seeds[:, None].expand(slots, k), qpos[:, :k], _STREAM_ACCEPT,
        )
        u = prng.uniform(u_keys)
        valid = torch.arange(k, device=dev)[None, :] < n_valid.long()[:, None]
        accept = (u * q_d < p_d) & valid
        n_acc = torch.sum(
            torch.cumprod(accept.to(torch.int64), dim=1), dim=1
        )

        # The emitting row is n_acc in both outcomes: residual draw on
        # a rejection, bonus draw on a clean sweep (q zeroed -> the
        # residual is p).
        vocab = cfg.vocab_size
        p_row = torch.gather(
            p, 1, n_acc[:, None, None].expand(slots, 1, vocab)
        )[:, 0]
        q_row = torch.gather(
            torch.cat(
                [q_probs, torch.zeros(slots, 1, vocab, device=dev)], dim=1
            ),
            1, n_acc[:, None, None].expand(slots, 1, vocab),
        )[:, 0]
        q_row = torch.where(
            (n_acc == n_valid.long())[:, None], torch.zeros_like(q_row),
            q_row,
        )
        resid = torch.clamp_min(p_row - q_row, 0.0)
        rsum = torch.sum(resid, dim=-1, keepdim=True)
        resid = torch.where(rsum > 0, resid / rsum, p_row)
        emit_keys = prng.position_keys(
            seeds, pos.long() + n_acc, _STREAM_EMIT
        )
        emit = prng.categorical_probs(emit_keys, resid)
        out = torch.cat(
            [drafts, torch.zeros(slots, 1, dtype=torch.int64, device=dev)],
            dim=1,
        )
        out = torch.where(
            rows_j[None, :] == n_acc[:, None], emit[:, None], out
        )
        return out.to(torch.int32), n_acc.to(torch.int32)

    return verify


def make_spec_prefill_fn(
    cfg: llama2.LlamaConfig,
    bucket: int,
    block_size: int,
    max_blocks: int,
    table_width: int,
    kernel: str = "gather",
):
    """The sampled chunk-prefill program: the greedy program's layer
    loop (``paging.make_chunk_logits_fn`` -- one body, two token
    rules; ``kernel="cuda"`` runs the paged prefill kernel) with the
    seeded temperature/top-p head on the final logits row, keyed at the
    producing row's absolute position ``start + true_len - 1`` -- the
    verify program's convention, so a sampled request's first token is
    part of the same deterministic stream.

    ``(params, ks, vs, ksc, vsc, tokens [1, bucket], start, true_len,
    table, seed, temp, top_p)`` -> 0-d int32 token; ``start``,
    ``true_len``, ``seed``, ``temp`` and ``top_p`` are host numbers."""
    from tpu_hpc_torch.serve.paging import make_chunk_logits_fn

    inner = make_chunk_logits_fn(
        cfg, bucket, block_size, max_blocks, table_width, kernel=kernel,
    )

    def spec_prefill(params, ks, vs, ksc, vsc, tokens, start: int,
                     true_len: int, table, seed, temp, top_p):
        logits = inner(
            params, ks, vs, ksc, vsc, tokens, start, true_len, table
        )
        return sample_token(logits, seed, start + true_len - 1, temp, top_p)

    return spec_prefill


def _verify_builder(spec_cfg: SpecConfig):
    def build(engine, key):
        del key
        return make_spec_verify_fn(
            engine.cfg, spec_cfg.k, engine.paged.block_size,
            engine.max_blocks_per_seq, engine.table_width,
            onehot_q=spec_cfg.mode == "ngram", kernel=engine.paged.kernel,
        )
    return build


def _draft_builder(spec_cfg: SpecConfig):
    def build(draft, key):
        del key
        return make_spec_draft_fn(
            draft.cfg, spec_cfg.k, draft.paged.block_size,
            draft.max_blocks_per_seq, draft.table_width,
            kernel=draft.paged.kernel,
        )
    return build


def _build_spec_prefill(engine, key):
    return make_spec_prefill_fn(
        engine.cfg, key[1], engine.paged.block_size,
        engine.max_blocks_per_seq, engine.table_width,
        kernel=engine.paged.kernel,
    )


# ---------------------------------------------------------------------
# The runner
# ---------------------------------------------------------------------


class SpecRunner:
    """Owns the speculative-decode state attached to one PagedEngine:
    the draft engine (``mode="draft"``), the program builders the
    engines' program tables dispatch to, the per-slot proposal
    bookkeeping, and the acceptance/draft-cost stats the summary and
    the ``obs`` registry read. Construct via :func:`attach_spec` -- it
    wires the engine hooks.

    The engine owns the runner (``engine.spec``); the runner holds its
    engine weakly and the builders hold neither, so dropping the engine
    frees its pools and weights (and the draft's) at once, without
    waiting for a cycle collection."""

    def __init__(
        self,
        engine,
        cfg: SpecConfig,
        draft_params: Any = None,
        draft_cfg: Optional[llama2.LlamaConfig] = None,
    ):
        from tpu_hpc_torch.serve.paging import PagedEngine

        if not getattr(engine, "is_paged", False) or not isinstance(
            engine, PagedEngine
        ):
            raise ValueError(
                "speculative decoding rides the paged engine "
                "(serve/paging.py); slab engines are not supported"
            )
        if cfg.k > max(engine.serve_cfg.prefill_buckets):
            raise ValueError(
                f"spec k {cfg.k} exceeds the largest prefill bucket "
                f"{max(engine.serve_cfg.prefill_buckets)} (the verify "
                "write window must fit the table's scratch slack)"
            )
        if engine.paged.kv_quant != "none":
            raise ValueError(
                "speculative decoding on a quantized KV pool is not "
                "supported: the verify window's multi-token rewrites "
                "would requantize shared pages per candidate (and the "
                "mirrored draft pool would need its own scale "
                "arrays); serve int8 pools with plain greedy decode"
            )
        if engine._execs:
            # Attaching to a warmed engine would leave the spec
            # programs to build mid-traffic -- a latency spike and a
            # nonzero rebuild count with no error.
            raise ValueError(
                "attach_spec must run BEFORE engine.warmup(): the "
                "program table already holds built programs"
            )
        self._engine = weakref.ref(engine)
        self.cfg = cfg
        self.draft = None
        if cfg.mode == "draft":
            if draft_params is None or draft_cfg is None:
                raise ValueError(
                    "mode='draft' needs draft_params and draft_cfg "
                    "(restore a draft checkpoint, or use "
                    "default_draft_config for a dev-mode random init)"
                )
            if draft_cfg.vocab_size != engine.cfg.vocab_size:
                raise ValueError(
                    f"draft vocab {draft_cfg.vocab_size} != target "
                    f"vocab {engine.cfg.vocab_size} -- token ids must "
                    "mean the same thing to both models"
                )
            # The draft mirrors the target pool's shape: same pages,
            # same admissions, so reservation arithmetic is identical
            # on both sides.
            self.draft = PagedEngine(
                draft_params, draft_cfg, engine.serve_cfg,
                engine.device, engine.paged,
            )
            self.draft.gauge_suffix = "_draft"
            self.draft._spec_builders = {"spec_draft": _draft_builder(cfg)}
        engine.spec = self
        engine._spec_builders = {
            "spec_verify": _verify_builder(cfg),
            "spec_prefill": _build_spec_prefill,
        }
        self.stats = {
            "verify_steps": 0, "drafted": 0, "accepted": 0,
            "rejected": 0, "emitted": 0,
        }
        self.draft_time_s = 0.0
        # Wall time of the verify steps, dispatch to token fetch: what
        # the chip smoke prints beside the draft's (not a summary key --
        # spec_summary stays the JAX package's block).
        self.verify_time_s = 0.0
        # Paged decode kernel launches made by the draft steps and by
        # the verify steps (0 on the gather route and on CPU tensors):
        # what the serving summary reports beside the launches per
        # emitted token of plain decode.
        self.kernel_launches = {"draft": 0, "verify": 0}
        reg = get_registry()
        reg.describe(
            "serve_spec_draft_s",
            "Draft-side forward (k-step burst or draft prefill), "
            "dispatch to handoff (s)",
        )
        reg.describe(
            "serve_spec_verify_s",
            "Batched (k+1)-position target verify forward (s)",
        )
        reg.describe("serve_spec_drafted_total",
                     "Speculative draft tokens proposed")
        reg.describe("serve_spec_accepted_total",
                     "Speculative draft tokens accepted by the "
                     "target verify forward")

    @property
    def engine(self):
        return self._engine()

    # -- warmup / build accounting -------------------------------------
    def warmup_draft(self) -> None:
        """Build the draft side's steady-state programs: one greedy
        chunk prefill per bucket (its tokens are discarded -- only the
        K/V matter) + the k-step draft program."""
        if self.draft is None:
            return
        for b in self.draft.serve_cfg.prefill_buckets:
            self.draft._get_exec(("prefill", b))
        self.draft._get_exec(("spec_draft",))

    @property
    def draft_compile_count(self) -> int:
        return self.draft.compile_count if self.draft is not None else 0

    # -- engine lifecycle mirroring ------------------------------------
    def on_admit(self, slot: int, prompt, max_new: int) -> None:
        """Mirror a target admission into the draft pool. The pools
        are shaped identically and see identical operation sequences,
        so a draft-side budget error means real skew -- roll the
        TARGET admission back and re-raise so the request re-queues
        atomically."""
        if self.draft is None:
            return
        try:
            self.draft.admit(slot, prompt, max_new)
        except Exception:
            self.engine.release(slot)
            raise

    def on_prefill_done(self, slot: int) -> None:
        """The target finished a request's prompt -- run the draft's
        whole chunk plan now. Wall time lands in ``draft_time_s``."""
        if self.draft is None:
            return
        t0 = time.perf_counter()
        with span("spec_draft_prefill", hist="serve_spec_draft_s"):
            st = self.draft.slot_state(slot)
            while st.next_chunk < len(st.plan):
                self.draft.prefill_step(slot)
        self.draft_time_s += time.perf_counter() - t0

    def on_release(self, slot: int) -> None:
        if self.draft is not None:
            self.draft.release(slot)

    # -- the decode step -----------------------------------------------
    @torch.no_grad()
    def decode(
        self,
        tokens: Sequence[int],
        positions: Sequence[int],
        active: Sequence[bool],
        n_valid: Sequence[int],
        seeds: Sequence[int],
        temps: Sequence[float],
        top_ps: Sequence[float],
        histories: Optional[Sequence[Sequence[int]]] = None,
        proposals: Optional[Sequence[Sequence[int]]] = None,
    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """One speculative decode step for every slot: draft (model or
        prompt lookup), then ONE batched target verify. Returns
        ``(out_tokens [slots, k+1], n_accepted [slots], n_drafted
        [slots])`` -- slot ``s`` emits ``out_tokens[s, :n_accepted[s] +
        1]`` and staked ``n_drafted[s]`` draft tokens. ``n_valid[s]``
        caps the drafts that participate (the batcher sets ``min(k,
        remaining - 1)``, which also keeps every speculative write
        inside the admission-time page reservation). ngram mode takes
        per-slot ``proposals`` (each request's :class:`NgramIndex`) or
        raw ``histories`` to rescan with :func:`ngram_propose`; the two
        are identical."""
        engine = self.engine
        k = self.cfg.k
        slots = engine.serve_cfg.slots
        pos = np.asarray(positions, np.int32)
        act = np.asarray(active, bool)
        nv = np.asarray(n_valid, np.int32)
        seeds_a = np.asarray(seeds, np.int64)
        temps_a = np.asarray(temps, np.float32)
        tops_a = np.asarray(top_ps, np.float32)

        # CoW guard over every page the verify writes touch -- and the
        # draft's mirrored window when a draft model runs. By
        # construction the pages are exclusively ours.
        guarded = (engine,) if self.draft is None else (
            engine, self.draft,
        )
        for eng in guarded:
            bs = eng.paged.block_size
            for s in range(slots):
                if not act[s]:
                    continue
                for page_idx in range(
                    int(pos[s]) // bs,
                    (int(pos[s]) + int(nv[s])) // bs + 1,
                ):
                    eng._cow_write_target(s, page_idx * bs)

        token_rows = np.zeros((slots, k + 1), np.int32)
        token_rows[:, 0] = np.asarray(tokens, np.int32)
        dev = engine.device
        seeds_t = torch.as_tensor(seeds_a, device=dev)
        temps_t = torch.as_tensor(temps_a, device=dev)
        tops_t = torch.as_tensor(tops_a, device=dev)
        draft_probs = None
        if self.cfg.mode == "draft":
            d = self.draft
            exec_ = d._get_exec(("spec_draft",))
            t0 = time.perf_counter()
            launches0 = paged_decode_attention.launches
            with span("spec_draft", hist="serve_spec_draft_s"):
                dtoks, draft_probs = exec_(
                    d.params, d.ks, d.vs,
                    d._rep_arr(token_rows[:, 0]),
                    d._rep_arr(pos),
                    d._tables_device(),
                    d._rep_arr(act.astype(np.int32)),
                    d._rep_arr(nv),
                    seeds_t, temps_t, tops_t,
                )
                dtoks_np = dtoks.cpu().numpy()
            self.draft_time_s += time.perf_counter() - t0
            self.kernel_launches["draft"] += (
                paged_decode_attention.launches - launches0
            )
            token_rows[:, 1:] = dtoks_np
        else:
            # Prompt lookup over each request's OWN history; a short
            # (or empty) proposal shrinks that slot's n_valid -- the
            # verify degenerates to a plain (sampled) decode.
            if histories is None and proposals is None:
                raise ValueError(
                    "ngram spec decode needs proposals or histories"
                )
            for s in range(slots):
                if not act[s]:
                    nv[s] = 0
                    continue
                if proposals is not None:
                    prop = list(proposals[s])
                else:
                    prop = ngram_propose(
                        histories[s], k, max_n=self.cfg.ngram
                    )
                nv[s] = min(int(nv[s]), len(prop))
                token_rows[s, 1:1 + len(prop)] = prop[:k]

        exec_ = engine._get_exec(("spec_verify",))
        args = [
            engine.params, engine.ks, engine.vs,
            engine._rep_arr(token_rows),
            engine._rep_arr(pos),
            engine._tables_device(),
            engine._rep_arr(act.astype(np.int32)),
            engine._rep_arr(nv),
        ]
        if draft_probs is not None:
            args.append(draft_probs)
        args += [seeds_t, temps_t, tops_t]
        launches0 = paged_decode_attention.launches
        t0 = time.perf_counter()
        with span("spec_verify", hist="serve_spec_verify_s"):
            out, n_acc = exec_(*args)
            out_np = out.cpu().numpy()
            n_acc_np = n_acc.cpu().numpy()
        self.verify_time_s += time.perf_counter() - t0
        self.kernel_launches["verify"] += (
            paged_decode_attention.launches - launches0
        )

        drafted = int(nv[act].sum()) if act.any() else 0
        accepted = int(n_acc_np[act].sum()) if act.any() else 0
        emitted = int(act.sum()) + accepted
        st = self.stats
        st["verify_steps"] += 1
        st["drafted"] += drafted
        st["accepted"] += accepted
        st["rejected"] += drafted - accepted
        st["emitted"] += emitted
        reg = get_registry()
        reg.inc("serve_spec_drafted_total", drafted)
        reg.inc("serve_spec_accepted_total", accepted)
        get_bus().emit(
            "spec_step", accepted=accepted, drafted=drafted,
        )
        return out_np, n_acc_np, nv

    # -- reporting ------------------------------------------------------
    def spec_summary(self) -> Dict[str, Any]:
        """The serve-summary block describing this runner: mode/k are
        identity, acceptance_rate and draft_ms are the judged
        signals."""
        st = self.stats
        return {
            "spec_mode": self.cfg.mode,
            "spec_k": self.cfg.k,
            "verify_steps": st["verify_steps"],
            "drafted": st["drafted"],
            "accepted": st["accepted"],
            "rejected": st["rejected"],
            "acceptance_rate": (
                st["accepted"] / st["drafted"] if st["drafted"]
                else 0.0
            ),
            "draft_ms": round(self.draft_time_s * 1e3, 3),
        }


def attach_spec(
    engine,
    cfg: SpecConfig,
    draft_params: Any = None,
    draft_cfg: Optional[llama2.LlamaConfig] = None,
) -> SpecRunner:
    """Attach speculative decoding to a PagedEngine (before
    ``warmup()``). Returns the runner; the engine's ``spec`` attribute,
    warmup, prefill routing and admission mirroring all key off it."""
    return SpecRunner(
        engine, cfg, draft_params=draft_params, draft_cfg=draft_cfg
    )
