"""Host-DRAM KV page tier: session residency past the device pool.

Port of the JAX package's ``serve/tier.py``. Servable sessions per card
are capped by device pages. The paged pool (serve/paging.py) and the
prefix trie already know which pages are warm-but-parked -- a finished
chat turn's prompt K/V, held only by the trie, waiting for the user to
come back -- but parked pages still burn device memory, so a returning
user forces either a shed or a full re-prefill. This module adds the
memory-hierarchy step behind the allocator (the vLLM PagedAttention
thesis, arXiv 2309.06180, one tier down):

* **Spill**: under pool pressure, admission asks the tier for pages
  *before* falling back to trie eviction. The tier takes the coldest
  parked pages the trie can give up without breaking a live request
  (``PrefixTrie.spillable``: refcount 1, children already spilled),
  gathers them on the device and lands them in pinned host buffers.
  The allocator moves the page's accounting across tiers (``spill``),
  so ``scratch + free + referenced + host == total`` holds at every
  step.
* **Prefetch/refill**: the scheduler's admit path (and the fleet
  router's affinity hit) calls :meth:`prefetch` with the incoming
  prompt *before* the request is seated. Spilled chain nodes refill in
  chain order (``match`` stops at the first still-spilled node, so a
  partial refill still lengthens the served prefix) through a page
  scatter into the resident pool. A refilled page lands at a NEW
  device page id; the trie node takes it, and the block table is
  written from the trie at admission, so no kernel reads a stale id.

The gather and scatter are the JAX package's XLA programs, not Pallas
kernels, so plain ``index_select`` / ``index_copy_`` carry them on the
device; on the host each page moves by one strided copy. They
register in the engine's program table (same table, same build
counter) at :meth:`warmup`, so the no-rebuild-after-warmup pins cover
the tier. Transfers move in bounded groups: ``max_inflight_bytes=
"auto"`` sizes the group from the comm planner's cost tables
(``comm/planner.Planner.chunk_bytes``). Each hop stages through a
pinned buffer and blocks until the bytes have landed, inside its
``kv_transfer`` span, so the hop's time is honest and the staging
buffer is free before the next group writes it; ``kv_spill`` /
``kv_refill`` are ring-only events.
"""
from __future__ import annotations

import time
from typing import Any, List, Sequence

import torch

from tpu_hpc_torch.obs import get_bus, get_registry, quantile, span
from tpu_hpc_torch.serve.paging import SCRATCH_BLOCK, BlockBudgetError


class HostTier:
    """Host-memory page tier attached to one :class:`PagedEngine`.

    Owns the host-side K/V buffers (``[layers, host_blocks, block_size,
    kv_heads, head_dim]``, the device pool's page layout, slot 0
    scratch like the device pool's block 0; pinned when the engine is
    on a card) and the two programs that move page groups across the
    device/host boundary. All *accounting* lives on the engine's
    :class:`BlockAllocator` and :class:`PrefixTrie`; this class only
    moves bytes and keeps the tier's telemetry."""

    def __init__(self, engine: Any, max_inflight_bytes="auto"):
        if engine.trie is None:
            raise ValueError(
                "HostTier needs the prefix trie (prefix_cache=True): "
                "parked trie pages are the only thing worth spilling"
            )
        self.engine = engine
        c = engine.cfg
        bs = engine.paged.block_size
        self.host_blocks = engine.paged.host_blocks
        dtype = engine.ks.dtype
        pin = engine.device.type == "cuda"
        shape = (c.n_layers, self.host_blocks, bs, c.kv_heads, c.head_dim)
        self._host_k = torch.zeros(shape, dtype=dtype, pin_memory=pin)
        self._host_v = torch.zeros(shape, dtype=dtype, pin_memory=pin)
        self.host_bytes = 2 * self._host_k.numel() * dtype.itemsize
        # int8 pools: a page is its bytes PLUS its f32 scale -- a
        # spilled page that came back without its scale would
        # dequantize to garbage, so the scale rows ride every hop.
        self._quant = engine.paged.kv_quant == "int8"
        self._host_ksc = self._host_vsc = None
        if self._quant:
            sc_shape = (c.n_layers, self.host_blocks)
            self._host_ksc = torch.zeros(sc_shape, dtype=torch.float32,
                                         pin_memory=pin)
            self._host_vsc = torch.zeros(sc_shape, dtype=torch.float32,
                                         pin_memory=pin)
            self.host_bytes += 2 * self._host_ksc.numel() * 4
        # One page's K (or V) leaf: the transfer-group unit.
        self._page_bytes = c.n_layers * bs * c.kv_heads * c.head_dim \
            * dtype.itemsize
        # Bounded streams: group pages so one hop moves about
        # max_inflight_bytes. "auto" asks the planner's cost tables for
        # the chunk that amortizes launch latency, capped at the
        # largest bucket's page count.
        max_group = max(engine.serve_cfg.prefill_buckets) // bs
        self.inflight_source = None
        if max_inflight_bytes == "auto":
            from tpu_hpc_torch.comm.planner import Planner

            planner = Planner.for_devices(n_devices=1)
            max_inflight_bytes = planner.chunk_bytes(
                self._page_bytes * max_group
            )
            self.inflight_source = "planner"
        self.max_inflight_bytes = int(max_inflight_bytes)
        self.group = max(
            1, min(max_group, self.max_inflight_bytes // self._page_bytes)
        )
        self._rows_shape = (c.n_layers, self.group, bs, c.kv_heads,
                            c.head_dim)
        # Pinned staging for one group: the device<->host copies run
        # asynchronously from/to it, and each hop synchronizes before
        # the buffer is touched again.
        self._stage_k = torch.zeros(self._rows_shape, dtype=dtype,
                                    pin_memory=pin)
        self._stage_v = torch.zeros(self._rows_shape, dtype=dtype,
                                    pin_memory=pin)
        if self._quant:
            sc_rows = (c.n_layers, self.group)
            self._stage_ksc = torch.zeros(sc_rows, dtype=torch.float32,
                                          pin_memory=pin)
            self._stage_vsc = torch.zeros(sc_rows, dtype=torch.float32,
                                          pin_memory=pin)
        engine._tier_builders["spill_gather"] = self._build_gather
        engine._tier_builders["refill_scatter"] = self._build_scatter
        self.stats = {
            "kv_spills": 0, "kv_spill_pages": 0,
            "kv_spill_wire_bytes": 0,
            "kv_refills": 0, "kv_refill_pages": 0,
            "kv_refill_wire_bytes": 0,
        }
        # Engine-local hop samples for the summary quantiles (the
        # registry histogram is process-wide; a second pool in the
        # same process would blend runs).
        self._hop_s: List[float] = []
        reg = get_registry()
        reg.describe(
            "serve_kv_transfer_s",
            "Cross-tier KV hop, dispatch until the destination holds "
            "the rows (s)",
        )
        reg.describe(
            "serve_kv_spill_pages_total",
            "KV pages spilled from device memory to the host-DRAM tier",
        )
        reg.describe(
            "serve_kv_refill_pages_total",
            "KV pages refilled from the host-DRAM tier into device memory",
        )

    # -- programs (built through the engine's table) -------------------
    def _build_gather(self, key):
        if self._quant:
            def gather_q(ks, vs, ksc, vsc, page_ids):
                return (
                    ks.index_select(1, page_ids),
                    vs.index_select(1, page_ids),
                    ksc.index_select(1, page_ids),
                    vsc.index_select(1, page_ids),
                )

            return gather_q

        def gather(ks, vs, page_ids):
            return ks.index_select(1, page_ids), vs.index_select(1, page_ids)

        return gather

    def _build_scatter(self, key):
        if self._quant:
            def scatter_q(ks, vs, ksc, vsc, k_rows, v_rows, ksc_rows,
                          vsc_rows, page_ids):
                ks.index_copy_(1, page_ids, k_rows)
                vs.index_copy_(1, page_ids, v_rows)
                ksc.index_copy_(1, page_ids, ksc_rows)
                vsc.index_copy_(1, page_ids, vsc_rows)

            return scatter_q

        def scatter(ks, vs, k_rows, v_rows, page_ids):
            ks.index_copy_(1, page_ids, k_rows)
            vs.index_copy_(1, page_ids, v_rows)

        return scatter

    def warmup(self) -> None:
        """Build the gather/scatter programs and run one all-scratch
        round trip, so the copy paths are warm too. Scratch garbage
        over scratch garbage: both tiers' slot 0 absorb it."""
        self.engine._get_exec(("spill_gather",))
        self.engine._get_exec(("refill_scatter",))
        pad = [SCRATCH_BLOCK] * self.group
        self._move_out(pad, [0] * self.group)
        self._move_in([0] * self.group, pad)

    # -- byte movement -------------------------------------------------
    def _pad_ids(self, blocks: Sequence[int]) -> torch.Tensor:
        """Fixed-shape page-id vector: real ids first, scratch padding
        after (gather padding reads block 0, scatter padding writes
        over block 0 -- both absorbed by design)."""
        ids = [SCRATCH_BLOCK] * self.group
        ids[:len(blocks)] = [int(b) for b in blocks]
        return torch.tensor(ids, dtype=torch.long, device=self.engine.device)

    def _synchronize(self) -> None:
        if self.engine.device.type == "cuda":
            torch.cuda.synchronize(self.engine.device)

    def _move_out(self, blocks: Sequence[int], slots: Sequence[int]) -> int:
        """One page group, device pages -> host slots. Returns wire
        bytes (the padded group buffer -- what actually crosses)."""
        eng = self.engine
        ex = eng._get_exec(("spill_gather",))
        ids = self._pad_ids(blocks)
        if self._quant:
            k, v, ksc, vsc = ex(eng.ks, eng.vs, eng.k_scales,
                                eng.v_scales, ids)
            self._stage_ksc.copy_(ksc, non_blocking=True)
            self._stage_vsc.copy_(vsc, non_blocking=True)
        else:
            k, v = ex(eng.ks, eng.vs, ids)
        self._stage_k.copy_(k, non_blocking=True)
        self._stage_v.copy_(v, non_blocking=True)
        # The rows are host-side only once the copies have landed: the
        # same dispatch-to-result bracketing every hop timer relies on.
        self._synchronize()
        for host, stage in self._host_pairs():
            for lane, slot in enumerate(slots):
                host[:, slot].copy_(stage[:, lane])
        nbytes = 2 * self._stage_k.numel() * self._stage_k.itemsize
        if self._quant:
            nbytes += 2 * self._stage_ksc.numel() * 4
        return nbytes

    def _host_pairs(self):
        """(host buffer, staging buffer) pairs a hop moves: K, V and, for
        an int8 pool, both scale rows. Their pages are copied one page
        (all layers) a ``copy_``: a strided copy per page runs at memory
        speed, where a gathering ``index_select`` into a temporary ran
        30x slower on the host."""
        pairs = [(self._host_k, self._stage_k), (self._host_v, self._stage_v)]
        if self._quant:
            pairs += [(self._host_ksc, self._stage_ksc),
                      (self._host_vsc, self._stage_vsc)]
        return pairs

    def _move_in(self, slots: Sequence[int], blocks: Sequence[int]) -> int:
        """One page group, host slots -> device pages, scattered into
        the resident pool. Returns wire bytes."""
        eng = self.engine
        # Padding lanes keep whatever the staging buffer held (rows of an
        # earlier hop, or zeros): they scatter over the scratch page 0,
        # which no live table row reads, and an int8 pool's scale there
        # is only ever multiplied on read.
        for host, stage in self._host_pairs():
            for lane, slot in enumerate(slots):
                stage[:, lane].copy_(host[:, slot])
        dev = eng.device
        k_dev = self._stage_k.to(dev, non_blocking=True)
        v_dev = self._stage_v.to(dev, non_blocking=True)
        ex = eng._get_exec(("refill_scatter",))
        ids = self._pad_ids(blocks)
        nbytes = 2 * self._stage_k.numel() * self._stage_k.itemsize
        if self._quant:
            ksc_dev = self._stage_ksc.to(dev, non_blocking=True)
            vsc_dev = self._stage_vsc.to(dev, non_blocking=True)
            ex(eng.ks, eng.vs, eng.k_scales, eng.v_scales,
               k_dev, v_dev, ksc_dev, vsc_dev, ids)
            nbytes += 2 * self._stage_ksc.numel() * 4
        else:
            ex(eng.ks, eng.vs, k_dev, v_dev, ids)
        self._synchronize()
        return nbytes

    # -- tier operations -----------------------------------------------
    def spill_parked(self, n_needed: int) -> int:
        """Move up to ``n_needed`` of the coldest parked pages to the
        host tier, freeing their device pages. Called by admission
        BEFORE trie eviction: a spilled page is a cheap hop on return,
        an evicted one is a full re-prefill. Returns pages freed."""
        eng = self.engine
        alloc = eng.allocator
        t0 = time.perf_counter()
        taken = 0
        nbytes = 0
        with span(
            "kv_transfer", tier="host_spill",
            hist="serve_kv_transfer_s", n=n_needed,
        ):
            # spillable() only offers nodes whose children already
            # left the device (leaf-first, the eviction rule), so
            # spilling a layer makes its parents spillable -- re-walk
            # until the quota is met or a pass makes no progress.
            while taken < n_needed:
                nodes = eng.trie.spillable(alloc)
                take = min(
                    n_needed - taken, len(nodes), alloc.host_free_slots,
                )
                if take <= 0:
                    break
                nodes = nodes[:take]
                for i in range(0, take, self.group):
                    grp = nodes[i:i + self.group]
                    blocks = [n.block for n in grp]
                    # Accounting first, bytes second: spill() frees the
                    # device page before the gather reads it, which is
                    # safe single-threaded -- nothing allocates between
                    # here and the copy, so the freed page still holds
                    # its rows.
                    slots = [alloc.spill(b) for b in blocks]
                    nbytes += self._move_out(blocks, slots)
                    for node, slot in zip(grp, slots):
                        node.host = slot
                        node.block = -1
                taken += take
        self._hop_s.append(time.perf_counter() - t0)
        if not taken:
            return 0
        self.stats["kv_spills"] += 1
        self.stats["kv_spill_pages"] += taken
        self.stats["kv_spill_wire_bytes"] += nbytes
        get_registry().inc("serve_kv_spill_pages_total", taken)
        # Ring-only (no sink): spills happen at admission cadence,
        # flight-recorder forensics is the right volume tier.
        get_bus().emit(
            "kv_spill", pages=taken, bytes=nbytes,
            host_free=alloc.host_free_slots,
        )
        return taken

    def prefetch(self, prompt: Sequence[int]) -> int:
        """Refill ``prompt``'s host-resident chain nodes back into the
        device pool, in chain order, before the request is seated. A
        partial refill (device pool filled up mid-way) is still
        progress: ``match`` serves the refilled prefix and the request
        re-prefills only the remainder. Returns pages refilled."""
        eng = self.engine
        alloc = eng.allocator
        nodes = eng.trie.spilled_chain(prompt)
        if not nodes:
            return 0
        short = len(nodes) - alloc.free_blocks
        if short > 0:
            # Make room by evicting cold DEVICE leaves; eviction may
            # also drop spilled leaves (possibly ours), so re-walk the
            # chain afterwards rather than trust stale node refs.
            eng.paged_stats["trie_evictions"] += eng.trie.evict(
                alloc, short
            )
            nodes = eng.trie.spilled_chain(prompt)
            if not nodes:
                return 0
        t0 = time.perf_counter()
        refilled = 0
        nbytes = 0
        with span(
            "kv_transfer", tier="host_refill",
            hist="serve_kv_transfer_s", n=len(nodes),
        ):
            for i in range(0, len(nodes), self.group):
                grp = nodes[i:i + self.group]
                got: List[Any] = []
                blocks: List[int] = []
                for node in grp:
                    try:
                        blocks.append(alloc.refill(node.host))
                    except BlockBudgetError:
                        break
                    got.append(node)
                if not got:
                    break
                # refill() already released the host slots, but the
                # rows are still in the buffers -- nothing writes host
                # memory between accounting and copy.
                slots = [n.host for n in got]
                nbytes += self._move_in(slots, blocks)
                for node, blk in zip(got, blocks):
                    node.host = None
                    node.block = int(blk)
                refilled += len(got)
                if len(got) < len(grp):
                    break
        self._hop_s.append(time.perf_counter() - t0)
        if refilled:
            self.stats["kv_refills"] += 1
            self.stats["kv_refill_pages"] += refilled
            self.stats["kv_refill_wire_bytes"] += nbytes
            get_registry().inc("serve_kv_refill_pages_total", refilled)
            get_bus().emit(
                "kv_refill", pages=refilled, bytes=nbytes,
                host_free=alloc.host_free_slots,
            )
        return refilled

    # -- lifecycle / reporting -----------------------------------------
    def reset(self) -> None:
        """Forget everything (the reset_pool weight-swap contract): the
        buffers' contents become unreachable with the fresh allocator;
        only the telemetry needs clearing."""
        for k in self.stats:
            self.stats[k] = 0
        self._hop_s = []

    def summary(self) -> dict:
        alloc = self.engine.allocator
        hops = sorted(self._hop_s)
        return {
            "kv_host_blocks": self.host_blocks,
            "kv_host_used": alloc.host_used_slots,
            "kv_host_free": alloc.host_free_slots,
            "kv_host_drops": alloc.host_drops,
            "kv_host_inflight_bytes": self.max_inflight_bytes,
            "kv_host_inflight_source": self.inflight_source,
            "kv_hop_ms_p50": round(
                quantile(hops, 0.50) * 1e3, 3
            ) if hops else 0.0,
            "kv_hop_ms_p95": round(
                quantile(hops, 0.95) * 1e3, 3
            ) if hops else 0.0,
            **self.stats,
        }
