"""Disaggregated prefill/decode: two engine tiers, one request stream.

Port of the JAX package's ``serve/disagg.py``. Prefill is a
compute-bound batch job over a whole prompt, decode a latency-bound
single-token tick; run them on the same engine and every admission's
prefill stalls the decode batch. The disaggregated tier gives each
phase its own engine:

* the **prefill tier** runs the bucketed prefill programs (on a paged
  pool, the paged prefill kernel) and writes the prompt's K/V into its
  own cache rows;
* the KV block then crosses to the **decode tier** as an explicit
  :mod:`tpu_hpc_torch.reshard` plan -- planned once per bucket at
  warmup, executed with buffers cached on the plan (no new plan,
  buffer or program in steady state), bounded by
  ``max_inflight_bytes``, and span-bracketed as ``kv_transfer`` so TTFT
  decomposes into prefill-tier time + hop time;
* the **decode tier** owns the resident KV cache and the decode program
  (on a paged pool, the split/combine decode kernels).

A tier is ONE device, as the port's serving engine and fleet replica
are (``serve/fleet.py``): :func:`split_serving_meshes` gives each tier
the first card of its share, so the default split needs at least two
cards. An explicit ``prefill_device``/``decode_device`` pair may name
one card twice -- the two tiers are then two engines, two pools and two
param copies on that card, and the hop is a real copy between them
(the plan knows the tiers apart by name). That is how a one-card
machine runs both tiers.

:class:`DisaggEngine` presents the single-tier engine interface
(``prefill``/``decode``/``warmup``/``compile_count``, and the paged
protocol ``admit``/``prefill_step``/``release``), so the continuous
batcher and the replay server drive it unchanged, and greedy decode
through it equals the single-tier engine's token for token.

**Paged mode** (``paged=PagedConfig(...)``): both tiers run the
block-table pool, and the hop ships **the referenced pages only**:
per bucket, the pages a request's table names are gathered on the
prefill tier into a buffer cached for that bucket, the bounded plan
moves them, and they are scattered at the decode tier's own page ids
(each tier has its own allocator; page ids never have to agree). An
int8 pool hops each page's scales with it. Prompts longer than the
largest bucket hop as a sequence of bucket-sized page groups through
the same plans. Prefix reuse lives on the prefill tier.
"""
from __future__ import annotations

import math
import time
from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from tpu_hpc_torch.models import llama2
from tpu_hpc_torch.obs import get_registry, span
from tpu_hpc_torch.parallel.plans import P
from tpu_hpc_torch.runtime import resolve_device
from tpu_hpc_torch.serve.engine import Engine, ServeConfig


def _tier_axes(cfg: llama2.LlamaConfig) -> Dict[str, int]:
    """A one-device tier's mesh axes, as the JAX split names a tier of
    one chip (``tp.auto_mesh_axes``)."""
    from tpu_hpc_torch.parallel import tp

    return tp.auto_mesh_axes(1, cfg.n_heads, cfg.kv_heads, cap=4)


def split_serving_meshes(
    n_devices: int,
    cfg: llama2.LlamaConfig,
    prefill_devices: Optional[int] = None,
) -> Tuple[torch.device, torch.device]:
    """(prefill device, decode device) over the visible cards: the
    first ``prefill_devices`` (default: half) are the prefill share, the
    rest decode; each tier runs on the first card of its share."""
    del cfg  # a tier is one card: no TP split to size
    if n_devices < 2:
        raise ValueError(
            f"disaggregated serving needs >= 2 devices (one per "
            f"tier), got {n_devices}"
        )
    k = prefill_devices if prefill_devices is not None else n_devices // 2
    if not 1 <= k < n_devices:
        raise ValueError(
            f"prefill tier of {k} device(s) leaves "
            f"{n_devices - k} for decode (need >= 1 each of "
            f"{n_devices})"
        )
    return torch.device("cuda", 0), torch.device("cuda", k)


def _kv_rows_pspec() -> P:
    """Layout for one request's extracted KV rows ``[layers, 1, bucket,
    kv_heads, head_dim]`` (paged: ``[layers, pages, block, kv_heads,
    head_dim]``): whole on a one-device tier, as the JAX spec is on a
    tier without a ``model`` axis."""
    return P(None, None, None, None, None)


class DisaggEngine:
    """Prefill on one tier, decode on another, KV blocks moved by
    per-bucket reshard plans. Drop-in for :class:`Engine` from the
    batcher's point of view."""

    def __init__(
        self,
        params: Any,
        cfg: llama2.LlamaConfig,
        serve_cfg: ServeConfig,
        prefill_device: Any = "cuda",
        decode_device: Any = "cuda",
        max_inflight_bytes: "Optional[int | str]" = None,
        paged=None,
    ):
        from tpu_hpc_torch.reshard import Mesh, Sharding

        self.cfg = cfg
        self.serve_cfg = serve_cfg
        self.max_inflight_bytes = max_inflight_bytes
        self.paged = paged
        self.is_paged = paged is not None
        self.prefill_device = resolve_device(prefill_device)
        self.decode_device = resolve_device(decode_device)
        if paged is not None:
            from tpu_hpc_torch.serve.paging import PagedEngine

            self.prefill_engine = PagedEngine(
                params, cfg, serve_cfg, self.prefill_device, paged)
            self.decode_engine = PagedEngine(
                params, cfg, serve_cfg, self.decode_device, paged)
            # Two pools in one process: distinct gauge names, or the
            # tiers overwrite each other's page readings.
            for eng, suffix in ((self.prefill_engine, "_prefill"),
                                (self.decode_engine, "_decode")):
                eng.gauge_suffix = suffix
                eng._set_block_gauges()
        else:
            self.prefill_engine = Engine(params, cfg, serve_cfg,
                                         self.prefill_device)
            self.decode_engine = Engine(params, cfg, serve_cfg,
                                        self.decode_device)
        self.device = self.decode_device  # the resident (decode) tier
        axes = _tier_axes(cfg)
        self.prefill_mesh = Mesh.of_device(self.prefill_device, "prefill",
                                           axes)
        self.decode_mesh = Mesh.of_device(self.decode_device, "decode", axes)
        self._src_sh = Sharding(self.prefill_mesh, _kv_rows_pspec())
        self._tgt_sh = Sharding(self.decode_mesh, _kv_rows_pspec())
        # "auto": size the page-group moves from the cost model -- the
        # chunk that amortizes the cross-tier launch latency, bounded by
        # the largest bucket's KV leaf. --disagg-max-inflight-mb N
        # overrides.
        self.inflight_source = None
        if max_inflight_bytes == "auto":
            from tpu_hpc_torch.comm.planner import Planner

            rows = self._rows_shape(max(serve_cfg.prefill_buckets))
            leaf_bytes = int(math.prod(rows)
                             * self.prefill_engine.ks.element_size())
            planner = Planner.for_devices(
                n_devices=2, slices=1, device_type=self.decode_device.type)
            self.max_inflight_bytes = planner.chunk_bytes(leaf_bytes)
            self.inflight_source = "planner"
        self.cache_bytes = (
            self.prefill_engine.cache_bytes + self.decode_engine.cache_bytes
        )
        self._aot_builds = 0
        self._extract: Dict[int, Dict[str, torch.Tensor]] = {}
        self._plans: Dict[int, Any] = {}
        self.transfer_stats = {"kv_transfers": 0, "kv_transfer_bytes": 0}
        # Per-ENGINE hop samples for the summary quantiles (the registry
        # histogram is process-wide). Warmup's dummy moves stay out.
        self._hop_s: list = []
        self.spec = None
        self.host_tier = None
        get_registry().describe(
            "serve_kv_transfer_s",
            "Prefill->decode tier KV hop, dispatch until the decode "
            "cache holds the rows (s)",
        )

    # -- program / buffer table ----------------------------------------
    @property
    def compile_count(self) -> int:
        """Every program and buffer the serving unit has built: both
        tiers' program tables, the per-bucket gather buffers and
        scatters, and the buffers cached on the reshard plans. After
        :meth:`warmup` it must stay put -- the zero-rebuild guard."""
        return (
            self.prefill_engine.compile_count_total
            + self.decode_engine.compile_count_total
            + self._aot_builds
            + sum(p.compiled_program_count for p in self._plans.values())
        )

    @property
    def compile_count_total(self) -> int:
        return self.compile_count

    @property
    def kv_quant(self) -> str:
        return getattr(self.paged, "kv_quant", "none")

    def _rows_shape(self, bucket: int) -> Tuple[int, ...]:
        c = self.cfg
        if self.is_paged:
            bs = self.paged.block_size
            return (c.n_layers, bucket // bs, bs, c.kv_heads, c.head_dim)
        return (c.n_layers, 1, bucket, c.kv_heads, c.head_dim)

    def _abstract(self, bucket: int) -> Dict[str, Any]:
        from tpu_hpc_torch.reshard import Sharding, TensorSpec

        rows = self._rows_shape(bucket)
        dtype = self.prefill_engine.ks.dtype
        tree = {"k": TensorSpec(rows, dtype, self._src_sh),
                "v": TensorSpec(rows, dtype, self._src_sh)}
        if self.kv_quant == "int8":
            sc = (self.cfg.n_layers, rows[1])
            scale = Sharding(self.prefill_mesh)
            tree["k_scale"] = TensorSpec(sc, torch.float32, scale)
            tree["v_scale"] = TensorSpec(sc, torch.float32, scale)
        return tree

    def _targets(self, tree) -> Dict[str, Any]:
        from tpu_hpc_torch.reshard import Sharding

        return {k: self._tgt_sh if k in ("k", "v")
                else Sharding(self.decode_mesh) for k in tree}

    def _build_bucket_paged(self, bucket: int) -> None:
        """Paged hop for one bucket: a gather buffer on the prefill tier
        for exactly the pages a table slice names, the bounded
        cross-tier plan, and the scatter at the decode tier's page ids
        -- the referenced pages only, nothing else crosses."""
        from tpu_hpc_torch import reshard

        pe = self.prefill_engine
        rows = self._rows_shape(bucket)
        bufs = {
            "k": torch.empty(rows, dtype=pe.ks.dtype, device=pe.device),
            "v": torch.empty(rows, dtype=pe.ks.dtype, device=pe.device),
        }
        if self.kv_quant == "int8":
            sc = (self.cfg.n_layers, rows[1])
            bufs["k_scale"] = torch.empty(sc, dtype=torch.float32,
                                          device=pe.device)
            bufs["v_scale"] = torch.empty(sc, dtype=torch.float32,
                                          device=pe.device)
        self._extract[bucket] = bufs
        self._aot_builds += 2  # the gather and the scatter
        abstract = self._abstract(bucket)
        self._plans[bucket] = reshard.plan_reshard(
            abstract, self._targets(abstract),
            max_inflight_bytes=self.max_inflight_bytes,
            label=f"kv_pages_b{bucket}",
        )

    def _build_bucket(self, bucket: int) -> None:
        """Slab hop for one bucket: the slot's rows read as a view of
        the prefill cache, the cross-tier plan, the write into the
        decode cache's rows."""
        from tpu_hpc_torch import reshard

        self._aot_builds += 2  # the row view and the row write
        self._plans[bucket] = reshard.plan_reshard(
            self._abstract(bucket), {"k": self._tgt_sh, "v": self._tgt_sh},
            max_inflight_bytes=self.max_inflight_bytes,
            label=f"kv_transfer_b{bucket}",
        )

    def warmup(self) -> int:
        """Build both tiers' program tables, each bucket's hop, and (by
        a dummy move) every buffer the plans cache. Returns the total
        count; after this ``compile_count`` must never move."""
        self.prefill_engine.warmup()
        self.decode_engine.warmup()
        for b in self.serve_cfg.prefill_buckets:
            if self.is_paged:
                self._build_bucket_paged(b)
                # Dummy move of all-scratch page ids: scratch garbage
                # over scratch garbage.
                zeros = np.zeros((b // self.paged.block_size,), np.int32)
                self._move_kv_paged(b, zeros, zeros)
            else:
                self._build_bucket(b)
                # Dummy move of the (all-zero) slot-0 rows.
                self._move_kv(b, 0)
        return self.compile_count

    # -- serving ops ---------------------------------------------------
    def _sync_decode(self) -> None:
        # Every hop timer wraps the move: block until the decode cache
        # holds the rows, or the copy's cost would leak into the next
        # decode tick's ITL.
        if self.decode_device.type == "cuda":
            torch.cuda.synchronize(self.decode_device)

    def _move_kv(self, bucket: int, slot: int) -> int:
        """One request's KV rows: prefill cache -> decode cache, via the
        bucket's cached plan. Returns bytes moved."""
        pe, de = self.prefill_engine, self.decode_engine
        rows = {"k": pe.ks[:, slot:slot + 1, :bucket],
                "v": pe.vs[:, slot:slot + 1, :bucket]}
        moved = self._plans[bucket].execute(rows)
        de.ks[:, slot:slot + 1, :bucket].copy_(moved["k"])
        de.vs[:, slot:slot + 1, :bucket].copy_(moved["v"])
        self._sync_decode()
        return sum(t.numel() * t.element_size() for t in rows.values())

    @torch.no_grad()
    def _move_kv_paged(self, bucket: int, src_ids, tgt_ids) -> int:
        """One bucket-sized page group: gather ``src_ids`` pages on the
        prefill tier, move, scatter at ``tgt_ids`` on the decode tier."""
        pe, de = self.prefill_engine, self.decode_engine
        bufs = self._extract[bucket]
        src = torch.as_tensor(np.asarray(src_ids, np.int64),
                              device=pe.device)
        tgt = torch.as_tensor(np.asarray(tgt_ids, np.int64),
                              device=de.device)
        torch.index_select(pe.ks, 1, src, out=bufs["k"])
        torch.index_select(pe.vs, 1, src, out=bufs["v"])
        if "k_scale" in bufs:
            torch.index_select(pe.k_scales, 1, src, out=bufs["k_scale"])
            torch.index_select(pe.v_scales, 1, src, out=bufs["v_scale"])
        moved = self._plans[bucket].execute(bufs)
        de.ks[:, tgt] = moved["k"]
        de.vs[:, tgt] = moved["v"]
        if "k_scale" in moved:
            de.k_scales[:, tgt] = moved["k_scale"]
            de.v_scales[:, tgt] = moved["v_scale"]
        self._sync_decode()
        return sum(t.numel() * t.element_size() for t in bufs.values())

    def _hop_pieces(self, prompt_len: int):
        """Bucket-sized page groups covering the prompt region -- fixed
        shapes only, so a chunked prompt longer than the largest bucket
        hops through the same plans."""
        bs = self.paged.block_size
        largest = max(self.serve_cfg.prefill_buckets)
        total = -(-prompt_len // bs) * bs
        pieces = []
        pos = 0
        while pos < total:
            rem = total - pos
            b = largest if rem >= largest \
                else self.serve_cfg.bucket_for(rem)
            pieces.append((pos // bs, b))
            pos += b
        return pieces

    @torch.no_grad()
    def prefill(self, slot: int, prompt: Sequence[int]) -> int:
        """Prefill on the prefill tier, then ship the slot's KV block to
        the decode tier inside a ``kv_transfer`` span, so TTFT = prefill
        span + kv_transfer span on one timeline."""
        tok = self.prefill_engine.prefill(slot, prompt)
        bucket = self.serve_cfg.bucket_for(len(prompt))
        t0 = time.perf_counter()
        with span("kv_transfer", tier="transfer",
                  hist="serve_kv_transfer_s", n=bucket):
            nbytes = self._move_kv(bucket, slot)
        self._hop_s.append(time.perf_counter() - t0)
        self.transfer_stats["kv_transfers"] += 1
        self.transfer_stats["kv_transfer_bytes"] += nbytes
        return tok

    # -- the paged protocol (serve/paging.py), tier-split ---------------
    def validate_request(self, prompt_len: int, max_new: int,
                         rid: str = "?") -> None:
        # The decode tier holds prompt + generation; the prefill tier
        # only the prompt (plus its one-token admit pad).
        self.decode_engine.validate_request(prompt_len, max_new, rid)
        self.prefill_engine.validate_request(prompt_len, 1, rid)

    def admit(self, slot: int, prompt: Sequence[int], max_new: int) -> dict:
        """Reserve pages on BOTH tiers, all or nothing. The decode tier
        goes first: its admit touches no trie, so a failure there never
        leaves the prefill tier's prefix counters inflated."""
        self.decode_engine.admit(slot, prompt, max_new, run_prefill=False)
        try:
            return self.prefill_engine.admit(slot, prompt, 1)
        except Exception:
            self.decode_engine.release(slot)
            raise

    def _hop_table(self, slot: int) -> np.ndarray:
        """The decode-tier page ids the hop scatters at."""
        return self.decode_engine.slot_table(slot)

    @torch.no_grad()
    def prefill_step(self, slot: int):
        """Advance one chunk on the prefill tier; on prompt completion
        ship the referenced pages to the decode tier's page ids and
        release the prefill reservation (its trie keeps the prompt
        pages for future hits)."""
        tok = self.prefill_engine.prefill_step(slot)
        if tok is None:
            return None
        pe = self.prefill_engine
        plen = len(pe.slot_state(slot).prompt)
        src_table = pe.slot_table(slot)
        tgt_table = self._hop_table(slot)
        t0 = time.perf_counter()
        nbytes = 0
        pieces = self._hop_pieces(plen)
        with span("kv_transfer", tier="transfer",
                  hist="serve_kv_transfer_s", n=plen):
            for start_blk, b in pieces:
                nb = b // self.paged.block_size
                nbytes += self._move_kv_paged(
                    b, src_table[start_blk:start_blk + nb],
                    tgt_table[start_blk:start_blk + nb])
        self._hop_s.append(time.perf_counter() - t0)
        self.transfer_stats["kv_transfers"] += len(pieces)
        self.transfer_stats["kv_transfer_bytes"] += nbytes
        pe.release(slot)
        return tok

    def release(self, slot: int) -> None:
        self.decode_engine.release(slot)

    def planned_prefill_tokens(self, slot: int) -> int:
        return self.prefill_engine.planned_prefill_tokens(slot)

    @property
    def block_occupancy(self) -> float:
        return max(self.prefill_engine.block_occupancy,
                   self.decode_engine.block_occupancy)

    @property
    def prefill_forwarded_total(self) -> int:
        return self.prefill_engine.prefill_forwarded_total

    @property
    def paged_stats(self) -> dict:
        pe = self.prefill_engine.paged_stats
        de = self.decode_engine.paged_stats
        return {k: pe[k] + de[k] for k in pe}

    def paged_summary(self) -> dict:
        """The decode tier's resident pool, the prefill tier's
        prefix/chunk activity."""
        out = self.decode_engine.paged_summary()
        src = self.prefill_engine.paged_summary()
        for k in ("prefix_lookups", "prefix_hits", "prefix_hit_blocks",
                  "prefix_hit_rate", "prefill_chunks"):
            out[k] = src[k]
        out["cow_copies"] = src["cow_copies"] + out["cow_copies"]
        return out

    def decode(self, tokens: Sequence[int], positions: Sequence[int],
               active: Optional[Sequence[bool]] = None) -> np.ndarray:
        if self.is_paged:
            return self.decode_engine.decode(tokens, positions, active)
        return self.decode_engine.decode(tokens, positions)

    def describe(self) -> dict:
        """The summary block the replay server reports per tier,
        hop-latency quantiles included (this engine's own samples)."""
        from tpu_hpc_torch.obs import quantile

        plans = {b: p.summary() for b, p in sorted(self._plans.items())}
        hops = sorted(self._hop_s)
        return {
            "kv_transfer_ms_p50": round(
                quantile(hops, 0.50) * 1e3, 3) if hops else 0.0,
            "kv_transfer_ms_p95": round(
                quantile(hops, 0.95) * 1e3, 3) if hops else 0.0,
            "prefill_mesh": self.prefill_mesh.axis_sizes,
            "decode_mesh": self.decode_mesh.axis_sizes,
            "prefill_device": str(self.prefill_device),
            "decode_device": str(self.decode_device),
            "max_inflight_bytes": self.max_inflight_bytes,
            "inflight_source": self.inflight_source,
            "kv_transfers": self.transfer_stats["kv_transfers"],
            "kv_transfer_bytes": self.transfer_stats["kv_transfer_bytes"],
            "kv_plans": plans,
        }
