"""Paged KV cache: block-table attention, prefix reuse, chunked prefill.

Port of the JAX package's ``serve/paging.py``. The slab engine
(serve/engine.py) preallocates one ``[layers, slots, seq, kv_heads,
head_dim]`` cache where a 32-token request pins the same memory as a
4096-token one. This module carves that memory into fixed-size
**pages** instead (the vLLM PagedAttention design):

* **cache** ``[layers, num_blocks, block_size, kv_heads, head_dim]``:
  one physical pool on the engine's device;
* **BlockAllocator** (host side, copied unchanged): LIFO free list +
  refcounts. Physical block 0 is the **scratch block**: padded-tail
  writes of a bucketed prefill and inactive slots' decode writes land
  there, and the per-slot length mask keeps its garbage unreachable;
* **block tables**: per-slot ``int32`` rows of physical block ids, fed
  to the programs as *data* -- shapes never change, so no program is
  rebuilt in steady state;
* **PrefixTrie** (copied unchanged): a hash-trie over full prompt token
  blocks with copy-on-write refcounts, so a shared system prompt costs
  its prefill FLOPs once;
* **chunked prefill**: a long prompt is admitted as block-aligned
  chunks interleaved with decode steps, each through the same
  per-bucket program.

Attention reads the logical sequence one of two ways, selected by
``PagedConfig.kernel``: ``"gather"`` -- a gather over the block table
(``ks[layer][table]``) into a dense view, the reference formulation --
or ``"cuda"``, the counterpart of the JAX package's ``"pallas"``: the
kernels/paged_attention.py wrappers, which on the card launch the
hand-written Hopper kernels (table walked in-kernel, each live page read
once, no gathered intermediate) and on the CPU run their plain PyTorch
versions. ``PagedConfig.kv_quant="int8"`` stores the pool as per-page
symmetric int8 with f32 scale side arrays (``k_scales``/``v_scales``,
one scalar per page per layer).

JAX's donated pool buffers become IN-PLACE updates: every program
writes pages (and scales) into the engine's resident tensors by index
assignment and returns only its result. Speculative decoding
(serve/spec.py) attaches to a PagedEngine through ``attach_spec``: its
verify, draft and sampled-prefill programs live in the same program
table, under the same build counter. ``host_blocks > 0`` puts the
host-DRAM page tier (serve/tier.py) behind the pool: admission spills
parked trie pages there before it evicts any, and a returning prompt's
spilled chain refills before it is seated; its gather and scatter live
in the same program table too.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from tpu_hpc_torch.models import llama2
from tpu_hpc_torch.kernels.paged_attention import (
    INT8_SCALE_FLOOR,
    dequantize_pages_int8,
    paged_decode_attention,
    paged_prefill_attention,
    quantize_pages_int8,
)
from tpu_hpc_torch.obs import get_bus, get_registry, span
from tpu_hpc_torch.serve.engine import (
    Engine,
    ServeConfig,
    _embed,
    _grouped_attention,
    _logits_head,
    _mlp,
    _qkv,
    _rmsnorm,
    _attn_out_proj,
)

SCRATCH_BLOCK = 0


class BlockBudgetError(RuntimeError):
    """Transient: the allocator cannot seat this request *right now*.
    The batcher keeps the request queued and retries next tick (free
    blocks appear as in-flight requests finish)."""


class UnservableRequestError(ValueError):
    """Permanent: the request can never fit the configured page budget
    (prompt + max_new exceeds what the whole pool holds). Raised at
    submit() so one oversized request cannot abort a mid-flight
    drain."""


@dataclasses.dataclass(frozen=True)
class PagedConfig:
    """Static paged-cache shape: everything the pool layout and the
    compiled programs depend on.

    ``block_size``: tokens per page. ``num_blocks``: physical pages in
    the pool, INCLUDING the reserved scratch block 0 (usable pages =
    ``num_blocks - 1``). ``prefill_chunk``: chunked-prefill stride in
    tokens (0 = whole-prompt bucketed prefill); must be block-aligned
    so every chunk starts on a page boundary. ``prefix_cache``: keep
    finished prompts' full pages in the prefix trie for reuse.
    ``host_blocks``: host-DRAM page slots behind the device pool
    (serve/tier.py; 0 = no tier). Like ``num_blocks`` it INCLUDES a
    reserved scratch slot 0, so a non-zero tier needs >= 2 slots.
    ``kernel``: how attention reads
    the pool -- ``"gather"`` (an index gather into a dense view, the
    reference) or ``"cuda"`` (the JAX package's ``"pallas"``:
    kernels/paged_attention.py, block table walked in-kernel on the
    card, each live page read once; the plain PyTorch version on the
    CPU). ``kv_quant``: pool storage
    -- ``"none"`` (cache_dtype as configured) or ``"int8"`` (per-page
    symmetric int8 with f32 scale side arrays; half the pool bytes)."""

    block_size: int = 16
    num_blocks: int = 64
    prefill_chunk: int = 0
    prefix_cache: bool = True
    host_blocks: int = 0
    kernel: str = "gather"
    kv_quant: str = "none"

    def __post_init__(self):
        if self.block_size < 1:
            raise ValueError(
                f"block_size must be >= 1, got {self.block_size}"
            )
        if self.num_blocks < 2:
            raise ValueError(
                f"num_blocks must be >= 2 (scratch + at least one "
                f"usable page), got {self.num_blocks}"
            )
        if self.host_blocks < 0 or self.host_blocks == 1:
            raise ValueError(
                f"host_blocks must be 0 (no host tier) or >= 2 "
                f"(scratch + at least one resident slot), got "
                f"{self.host_blocks}"
            )
        if self.host_blocks and not self.prefix_cache:
            raise ValueError(
                "host_blocks needs prefix_cache=True: the host tier "
                "spills TRIE-parked pages (a pool with no trie has "
                "nothing parked to spill)"
            )
        if self.prefill_chunk < 0 or (
            self.prefill_chunk % self.block_size
        ):
            raise ValueError(
                f"prefill_chunk {self.prefill_chunk} must be a "
                f"multiple of block_size {self.block_size} (chunks "
                "start on page boundaries)"
            )
        if self.kernel not in ("gather", "cuda"):
            raise ValueError(
                f"kernel must be 'gather' or 'cuda', got "
                f"{self.kernel!r}"
            )
        if self.kv_quant not in ("none", "int8"):
            raise ValueError(
                f"kv_quant must be 'none' or 'int8', got "
                f"{self.kv_quant!r}"
            )

    @property
    def usable_blocks(self) -> int:
        return self.num_blocks - 1

    def blocks_for(self, tokens: int) -> int:
        """Pages needed to hold ``tokens`` cache positions."""
        return -(-tokens // self.block_size)


DEFAULT_BLOCK_SIZE = 16


def derive_paged_config(
    slots: int,
    max_seq: int,
    buckets: Sequence[int],
    block_size: Optional[int] = None,
    num_blocks: Optional[int] = None,
    prefill_chunk: Optional[int] = None,
    align_capacity: bool = False,
    host_blocks: Optional[int] = None,
    kernel: Optional[str] = None,
    kv_quant: Optional[str] = None,
) -> Tuple["PagedConfig", int]:
    """CLI-shared sizing: ``(PagedConfig, capacity)`` from the flag
    values, with every invalid combination raising ``ValueError``
    BEFORE any backend bring-up. One derivation for server.py and
    bench.py, so the bench rows and the serving CLI can never
    silently diverge on the default block size, the page-rounding
    rule, or the slab-equivalent pool default.

    ``align_capacity=True`` rounds a DERIVED capacity up to a whole
    number of pages; an explicitly chosen capacity must align itself
    (callers pass False so the mismatch errors loudly)."""
    bs = block_size or DEFAULT_BLOCK_SIZE
    if align_capacity:
        max_seq = -(-max_seq // bs) * bs
    misaligned = [n for n in (max_seq, *buckets) if n % bs]
    if misaligned:
        raise ValueError(
            f"kv block size {bs} must divide the cache capacity and "
            f"every prefill bucket; {misaligned} are not multiples"
        )
    if (prefill_chunk or 0) > max(buckets):
        raise ValueError(
            f"prefill chunk {prefill_chunk} exceeds the largest "
            f"bucket {max(buckets)} (chunks run through the compiled "
            "bucket programs)"
        )
    cfg = PagedConfig(
        block_size=bs,
        num_blocks=(
            num_blocks if num_blocks is not None
            # Slab-equivalent HBM by default: same token capacity,
            # plus the scratch page.
            else slots * max_seq // bs + 1
        ),
        prefill_chunk=prefill_chunk or 0,
        host_blocks=host_blocks or 0,
        kernel=kernel or "gather",
        kv_quant=kv_quant or "none",
    )
    return cfg, max_seq

# ---------------------------------------------------------------------
# Host-side page accounting
# ---------------------------------------------------------------------


class BlockAllocator:
    """Free-list + refcount accounting over the physical page pool.

    Invariant (pinned by the property suite in tests/test_paging.py):
    ``1 (scratch) + len(free) + len(referenced) == num_blocks`` at all
    times -- no page is ever both free and referenced, double-freed,
    or leaked. ``retain``/``release`` move refcounts; a page frees
    only at refcount zero, which is what lets the prefix trie keep a
    finished request's prompt pages alive for future hits.

    With ``host_blocks > 0`` (the host-DRAM tier, serve/tier.py) the
    identity extends across tiers: device scratch + free + referenced
    plus host scratch + free + resident must equal
    ``num_blocks + host_blocks`` -- a page lives in exactly one tier
    at a time. ``spill``/``refill`` move a page's accounting between
    tiers; the device<->host copies themselves are the tier's job."""

    def __init__(self, num_blocks: int, host_blocks: int = 0):
        if num_blocks < 2:
            raise ValueError(f"num_blocks {num_blocks} must be >= 2")
        if host_blocks < 0 or host_blocks == 1:
            raise ValueError(
                f"host_blocks {host_blocks} must be 0 or >= 2"
            )
        self.num_blocks = num_blocks
        self.host_blocks = host_blocks
        # LIFO: the most recently freed page is the next handed out --
        # it is the page most likely still warm in HBM caches.
        self._free: List[int] = list(range(num_blocks - 1, 0, -1))
        self._ref: Dict[int, int] = {}
        # Host tier: slot 0 mirrors the device scratch block (refill
        # padding gathers from it, spill padding scatters to it).
        self._host_free: List[int] = (
            list(range(host_blocks - 1, 0, -1)) if host_blocks else []
        )
        self._host_used: set = set()
        self.host_drops = 0

    @property
    def free_blocks(self) -> int:
        return len(self._free)

    @property
    def used_blocks(self) -> int:
        return len(self._ref)

    @property
    def host_free_slots(self) -> int:
        return len(self._host_free)

    @property
    def host_used_slots(self) -> int:
        return len(self._host_used)

    def refcount(self, block: int) -> int:
        return self._ref.get(block, 0)

    def alloc(self, n: int) -> List[int]:
        """Take ``n`` fresh pages at refcount 1."""
        if n < 0:
            raise ValueError(f"cannot alloc {n} blocks")
        if n > len(self._free):
            raise BlockBudgetError(
                f"need {n} free pages, have {len(self._free)} "
                f"(pool {self.num_blocks}, {len(self._ref)} in use)"
            )
        out = [self._free.pop() for _ in range(n)]
        for b in out:
            self._ref[b] = 1
        return out

    def retain(self, blocks: Sequence[int]) -> None:
        """Add one reference to each (already-referenced) page."""
        for b in blocks:
            if b not in self._ref:
                raise ValueError(
                    f"retain of unreferenced block {b} (free or "
                    "scratch) -- a share must start from a live page"
                )
            self._ref[b] += 1

    def release(self, blocks: Sequence[int]) -> int:
        """Drop one reference from each page; pages reaching zero
        return to the free list. Returns how many pages freed."""
        freed = 0
        for b in blocks:
            n = self._ref.get(b)
            if n is None:
                raise ValueError(
                    f"double free of block {b} (not referenced)"
                )
            if n == 1:
                del self._ref[b]
                self._free.append(b)
                freed += 1
            else:
                self._ref[b] = n - 1
        return freed

    def cow(self, block: int) -> Tuple[int, bool]:
        """Copy-on-write: writing into ``block`` is safe only while
        this owner holds the sole reference. Returns ``(block,
        False)`` when exclusive; otherwise drops this owner's
        reference, allocates a fresh page, and returns ``(new_block,
        True)`` -- the caller must copy the page contents device-side
        before writing."""
        n = self._ref.get(block)
        if n is None:
            raise ValueError(f"cow of unreferenced block {block}")
        if n == 1:
            return block, False
        self._ref[block] = n - 1
        try:
            new = self.alloc(1)[0]
        except BlockBudgetError:
            self._ref[block] = n  # roll back: caller keeps its ref
            raise
        return new, True

    # -- host-tier accounting (serve/tier.py moves the bytes) ----------
    def spill(self, block: int) -> int:
        """Move one device page's accounting to the host tier: frees
        the device page, returns the host slot now holding it.

        Refuses pages any live request still shares (refcount above
        the spiller's single trie reference) -- the PR-8 shared-leaf
        eviction lesson applied to spill: a page a live request still
        reads through its block table must stay in HBM, or the next
        decode gather reads a recycled page."""
        n = self._ref.get(block)
        if n is None:
            raise ValueError(f"spill of unreferenced block {block}")
        if n != 1:
            raise ValueError(
                f"spill of shared block {block} (refcount {n}): a "
                "page a live request still reads must stay in HBM"
            )
        if not self._host_free:
            raise BlockBudgetError(
                f"host tier full ({len(self._host_used)} of "
                f"{self.host_blocks} slot(s) resident)"
            )
        slot = self._host_free.pop()
        self._host_used.add(slot)
        del self._ref[block]
        self._free.append(block)
        return slot

    def refill(self, host_slot: int) -> int:
        """Bring one host-resident page's accounting back: allocates a
        device page at refcount 1, frees the host slot. Raises
        :class:`BlockBudgetError` when the device pool is full (the
        caller's spill/evict pass must free pages first)."""
        if host_slot not in self._host_used:
            raise ValueError(
                f"refill of non-resident host slot {host_slot}"
            )
        block = self.alloc(1)[0]
        self._host_used.remove(host_slot)
        self._host_free.append(host_slot)
        return block

    def host_drop(self, host_slot: int) -> None:
        """Discard a host-resident page (host-tier eviction, or a
        trie re-insert adopting a freshly recomputed device copy)."""
        if host_slot not in self._host_used:
            raise ValueError(
                f"host drop of non-resident slot {host_slot}"
            )
        self._host_used.remove(host_slot)
        self._host_free.append(host_slot)
        self.host_drops += 1

    def check_invariant(self) -> None:
        """Raises if the accounting identity is violated (the property
        suite calls this after every random operation)."""
        free = set(self._free)
        held = set(self._ref)
        if len(free) != len(self._free):
            raise AssertionError("duplicate pages on the free list")
        if free & held:
            raise AssertionError(
                f"pages both free and referenced: {sorted(free & held)}"
            )
        if SCRATCH_BLOCK in free or SCRATCH_BLOCK in held:
            raise AssertionError("scratch block leaked into the pool")
        if any(n < 1 for n in self._ref.values()):
            raise AssertionError("zero/negative refcount retained")
        total = 1 + len(free) + len(held)
        if total != self.num_blocks:
            raise AssertionError(
                f"page accounting broken: scratch + {len(free)} free "
                f"+ {len(held)} held = {total} != {self.num_blocks}"
            )
        hfree = set(self._host_free)
        if len(hfree) != len(self._host_free):
            raise AssertionError(
                "duplicate slots on the host free list"
            )
        if hfree & self._host_used:
            raise AssertionError(
                f"host slots both free and resident: "
                f"{sorted(hfree & self._host_used)}"
            )
        if self.host_blocks and (0 in hfree or 0 in self._host_used):
            raise AssertionError(
                "host scratch slot leaked into the tier"
            )
        htotal = (
            1 + len(hfree) + len(self._host_used)
            if self.host_blocks else 0
        )
        if self.host_blocks and htotal != self.host_blocks:
            raise AssertionError(
                f"host tier accounting broken: scratch + "
                f"{len(hfree)} free + {len(self._host_used)} resident "
                f"= {htotal} != {self.host_blocks}"
            )
        # The cross-tier identity the host tier extends the pool
        # with: scratch + free + referenced + host == total pages.
        if total + htotal != self.num_blocks + self.host_blocks:
            raise AssertionError(
                f"cross-tier accounting broken: device {total} + "
                f"host {htotal} != "
                f"{self.num_blocks + self.host_blocks}"
            )


@dataclasses.dataclass
class _TrieNode:
    block: int
    children: Dict[Tuple[int, ...], "_TrieNode"] = dataclasses.field(
        default_factory=dict
    )
    last_used: int = 0
    # Host-tier residency (serve/tier.py): the host slot holding this
    # block's K/V while it is spilled out of HBM; None = device-
    # resident (block is the live page id; spilled nodes park -1).
    host: Optional[int] = None


class PrefixTrie:
    """Hash-trie over full prompt token blocks.

    Each edge is one block's worth of token ids; each node owns one
    reference on a physical page holding that block's K/V. A lookup
    walks the longest cached chain for a new prompt; an insert
    registers a finished prefill's full prompt blocks. Eviction is
    LRU leaf-first (an inner node's page is only reachable through
    its chain, so leaves must go first), and releasing the trie's
    reference frees the page only when no live request still holds
    it -- which is exactly why a prefix hit stays token-exact after
    the original owner was evicted."""

    def __init__(self, block_size: int):
        self.block_size = block_size
        self._root: Dict[Tuple[int, ...], _TrieNode] = {}
        self._clock = 0
        self.nodes = 0

    def _tick(self) -> int:
        self._clock += 1
        return self._clock

    def _full_blocks(
        self, prompt: Sequence[int]
    ) -> List[Tuple[int, ...]]:
        bs = self.block_size
        n_full = len(prompt) // bs
        return [
            tuple(prompt[i * bs:(i + 1) * bs]) for i in range(n_full)
        ]

    def match(self, prompt: Sequence[int]) -> List[int]:
        """Physical pages of the longest cached full-block prefix of
        ``prompt`` (possibly empty). Bumps LRU clocks; takes no
        references -- the caller retains what it keeps. Stops at the
        first HOST-resident node: a spilled page has no device id to
        share until a prefetch (serve/tier.py) refills it."""
        blocks: List[int] = []
        level = self._root
        now = self._tick()
        for key in self._full_blocks(prompt):
            node = level.get(key)
            if node is None or node.host is not None:
                break
            node.last_used = now
            blocks.append(node.block)
            level = node.children
        return blocks

    def spilled_chain(
        self, prompt: Sequence[int]
    ) -> List[_TrieNode]:
        """The HOST-resident nodes along ``prompt``'s cached chain, in
        chain order -- what a prefetch must refill before
        :meth:`match` can serve the full prefix. Read-only: no LRU
        bump (the refill itself is the evidence of heat)."""
        out: List[_TrieNode] = []
        level = self._root
        for key in self._full_blocks(prompt):
            node = level.get(key)
            if node is None:
                break
            if node.host is not None:
                out.append(node)
            level = node.children
        return out

    def spillable(
        self, allocator: BlockAllocator
    ) -> List[_TrieNode]:
        """Device-resident nodes whose page only the trie holds and
        whose children (if any) are all host-resident already --
        the pages a host-tier spill may take without breaking a
        chain's device-prefix/host-suffix shape. LRU first, so the
        coldest suffixes leave HBM first (evict's leaf-first rule,
        applied to spill)."""
        cands: List[Tuple[int, _TrieNode]] = []

        def walk(level: Dict) -> None:
            for node in level.values():
                walk(node.children)
                if (
                    node.host is None
                    and all(
                        c.host is not None
                        for c in node.children.values()
                    )
                    and allocator.refcount(node.block) == 1
                ):
                    cands.append((node.last_used, node))

        walk(self._root)
        cands.sort(key=lambda t: t[0])
        return [node for _, node in cands]

    def insert(
        self,
        prompt: Sequence[int],
        blocks: Sequence[int],
        allocator: BlockAllocator,
    ) -> int:
        """Register a finished prefill's full prompt blocks
        (``blocks[i]`` holds tokens ``[i*bs, (i+1)*bs)``). Existing
        nodes win (a concurrent identical prompt already cached the
        chain; the caller keeps its private copy). Returns how many
        new nodes (trie references) were created."""
        level = self._root
        now = self._tick()
        created = 0
        for i, key in enumerate(self._full_blocks(prompt)):
            node = level.get(key)
            if node is None:
                node = _TrieNode(block=int(blocks[i]), last_used=now)
                allocator.retain([node.block])
                level[key] = node
                self.nodes += 1
                created += 1
            else:
                if node.host is not None:
                    # The prefill just recomputed this block's K/V
                    # into the request's own device page (match
                    # stopped at the spilled node, so the chunk plan
                    # covered it): adopt that page and drop the now-
                    # redundant host copy -- a chain demonstrably hot
                    # again belongs in HBM, not behind a refill hop.
                    allocator.retain([int(blocks[i])])
                    allocator.host_drop(node.host)
                    node.host = None
                    node.block = int(blocks[i])
                node.last_used = now
            level = node.children
        return created

    def evict(
        self, allocator: BlockAllocator, n_needed: int
    ) -> int:
        """Drop LRU leaf nodes until ``n_needed`` pages came FREE (a
        released page still referenced by a live request frees
        nothing) or nothing evictable remains. Returns pages freed.

        One walk collects the current leaves; the whole batch drains
        in LRU order before re-walking (a re-walk is only needed when
        evicting a batch exposed parents as new leaves), so freeing
        ``n`` pages costs O(depth) walks, not O(n) -- evict runs
        inside admit() on every page-short admission, the hot path of
        a saturated pool.

        Leaves whose page is SHARED with a live request (refcount
        above the trie's own reference) are skipped: releasing them
        frees nothing toward the shortage, and deleting the node
        would throw away a demonstrably-hot prefix -- the next
        same-prompt request would pay the full prefill again (review
        finding: one unsatisfiable shortage must not wipe the warm
        cache)."""
        freed = 0
        while freed < n_needed:
            leaves: List[Tuple[int, Dict, Tuple, _TrieNode]] = []
            spilled: List[Tuple[int, Dict, Tuple, _TrieNode]] = []

            def walk(level: Dict) -> None:
                for key, node in level.items():
                    if node.children:
                        walk(node.children)
                    elif node.host is not None:
                        # Host-resident leaf: pins no HBM, but blocks
                        # the walk from exposing its device-resident
                        # ancestors as leaves.
                        spilled.append(
                            (node.last_used, level, key, node)
                        )
                    elif allocator.refcount(node.block) == 1:
                        leaves.append(
                            (node.last_used, level, key, node)
                        )

            walk(self._root)
            if leaves:
                leaves.sort(key=lambda t: t[0])
                for _, level, key, node in leaves:
                    del level[key]
                    self.nodes -= 1
                    freed += allocator.release([node.block])
                    if freed >= n_needed:
                        break
            elif spilled:
                # Device leaves exhausted while still short: the pool-
                # pressure endgame. Dropping host-resident leaves
                # frees no HBM directly, but the re-walk then reaches
                # their (device-resident) parents -- without this the
                # eviction loop stalls on a full host tier while
                # parked pages still hold HBM.
                spilled.sort(key=lambda t: t[0])
                for _, level, key, node in spilled:
                    del level[key]
                    self.nodes -= 1
                    allocator.host_drop(node.host)
            else:
                break
        return freed



# ---------------------------------------------------------------------
# Programs
# ---------------------------------------------------------------------


def make_chunk_logits_fn(
    cfg: llama2.LlamaConfig,
    bucket: int,
    block_size: int,
    max_blocks: int,
    table_width: int,
    kernel: str = "gather",
    kv_quant: str = "none",
):
    """One prefill **chunk** at a padded bucket length (whole-prompt
    prefill is the ``start=0`` single-chunk case). Returns the raw
    logits row (``[vocab]``) at ``true_len - 1``;
    :func:`make_chunk_prefill_fn` argmaxes it.

    ``(params, ks, vs, ksc, vsc, tokens [1, bucket], start, true_len,
    table [table_width])`` -> ``logits``: the chunk's K/V is written IN
    PLACE into the pages ``table[start/bs :]`` names, then attention
    runs over the WHOLE logical sequence view under the global causal
    mask ``key_pos <= start + q`` -- so a chunk attends to every
    previously prefilled chunk and to shared prefix pages it never
    computed. ``start`` and ``true_len`` are host ints; ``ksc``/``vsc``
    are the int8 pool's scale side arrays (``None`` for other pools).

    ``kernel="gather"`` reads the view through an index gather of the
    first ``max_blocks`` table entries (the reference);
    ``kernel="cuda"`` hands the table row to
    :func:`tpu_hpc_torch.kernels.paged_attention.paged_prefill_attention`.
    ``kv_quant="int8"`` quantizes whole pages on write (per-page f32
    scale into ``ksc``/``vsc``) and both read paths dequantize -- so
    gather and cuda always see the identical pool state.

    ``table_width > max_blocks``: the trailing entries are scratch
    padding, so a bucket-padded write near the capacity edge stays in
    range (tensor slicing would silently shorten an out-of-range slice,
    where JAX's dynamic_slice clamps it) and never touches a real page.
    """
    nb_chunk = bucket // block_size
    cache_cap = max_blocks * block_size
    quant = kv_quant == "int8"
    use_kernel = kernel == "cuda"
    groups = cfg.n_heads // cfg.kv_heads
    hd, n_kv = cfg.head_dim, cfg.kv_heads

    def chunk_logits(params, ks, vs, ksc, vsc, tokens, start: int,
                     true_len: int, table):
        dev = tokens.device
        x = _embed(params, tokens, cfg)
        qpos = start + torch.arange(bucket, device=dev)
        cos, sin = llama2.rope_cos_sin(bucket, hd, positions=qpos)
        first = start // block_size
        blk_ids = table[first:first + nb_chunk].long()
        if not use_kernel:
            col = torch.arange(cache_cap, device=dev)
            mask = (col[None, :] <= qpos[:, None])[None, None, None, :, :]
            view_ids = table[:max_blocks].long()
        for i in range(cfg.n_layers):
            lp = params[f"layers_{i}"]
            h = _rmsnorm(x, lp["attention_norm"]["scale"], cfg.norm_eps)
            q, k, v = _qkv(h, lp, cfg)
            q = llama2.apply_rope(q, cos, sin)
            k = llama2.apply_rope(k, cos, sin)
            kb = k[0].reshape(nb_chunk, block_size, n_kv, hd)
            vb = v[0].reshape(nb_chunk, block_size, n_kv, hd)
            if quant:
                kq, k_sc = quantize_pages_int8(kb)
                vq, v_sc = quantize_pages_int8(vb)
                ks[i, blk_ids] = kq
                vs[i, blk_ids] = vq
                ksc[i, blk_ids] = k_sc
                vsc[i, blk_ids] = v_sc
            else:
                ks[i, blk_ids] = kb.to(ks.dtype)
                vs[i, blk_ids] = vb.to(vs.dtype)
            if use_kernel:
                qp = q[0].to(cfg.dtype).reshape(
                    bucket, n_kv, groups, hd
                ).permute(1, 0, 2, 3).contiguous()
                ctx = paged_prefill_attention(
                    qp, ks[i], vs[i], table, start,
                    block_size=block_size, max_blocks=max_blocks,
                    k_scale=ksc[i] if quant else None,
                    v_scale=vsc[i] if quant else None,
                )
                attn = ctx.permute(1, 0, 2, 3).reshape(
                    1, bucket, cfg.n_heads, hd
                )
            else:
                k_view = ks[i][view_ids]
                v_view = vs[i][view_ids]
                if quant:
                    k_view = dequantize_pages_int8(k_view, ksc[i][view_ids])
                    v_view = dequantize_pages_int8(v_view, vsc[i][view_ids])
                k_view = k_view.reshape(1, cache_cap, n_kv, hd)
                v_view = v_view.reshape(1, cache_cap, n_kv, hd)
                attn = _grouped_attention(
                    q, k_view.to(cfg.dtype), v_view.to(cfg.dtype), mask,
                    cfg,
                )
            x = x + _attn_out_proj(attn, lp, cfg)
            h = _rmsnorm(x, lp["ffn_norm"]["scale"], cfg.norm_eps)
            x = x + _mlp(h, lp, cfg)
        last = x[:, true_len - 1:true_len]
        logits = _logits_head(last, params, cfg)
        return logits[0, 0]

    return chunk_logits


def make_chunk_prefill_fn(
    cfg: llama2.LlamaConfig,
    bucket: int,
    block_size: int,
    max_blocks: int,
    table_width: int,
    kernel: str = "gather",
    kv_quant: str = "none",
):
    """The greedy chunk-prefill program: :func:`make_chunk_logits_fn`
    with the argmax token rule (meaningful on the final chunk only).
    Returns a 0-d int32 device tensor."""
    inner = make_chunk_logits_fn(
        cfg, bucket, block_size, max_blocks, table_width,
        kernel=kernel, kv_quant=kv_quant,
    )

    def chunk_prefill(params, ks, vs, ksc, vsc, tokens, start, true_len,
                      table):
        logits = inner(
            params, ks, vs, ksc, vsc, tokens, start, true_len, table
        )
        return torch.argmax(logits, dim=-1).to(torch.int32)

    return chunk_prefill


def make_paged_decode_fn(
    cfg: llama2.LlamaConfig,
    block_size: int,
    max_blocks: int,
    table_width: int,
    kernel: str = "gather",
    kv_quant: str = "none",
):
    """The single-token decode program over every slot, block-table
    edition.

    ``(params, ks, vs, ksc, vsc, tokens [slots], pos [slots],
    tables [slots, table_width], active [slots])`` -> ``next_tokens``:
    each active slot's token K/V is written IN PLACE into page
    ``tables[s, pos/bs]`` at offset ``pos % bs``; inactive slots (free,
    or still prefilling their prompt) are redirected to the scratch
    block so their garbage write cannot corrupt a live page. Attention
    reads each slot's logical view through its table and masks columns
    ``> pos`` -- stale pages from an evicted tenant are unreachable.

    ``kernel="cuda"`` swaps the view gather + dense attention for
    :func:`tpu_hpc_torch.kernels.paged_attention.paged_decode_attention`.
    ``kv_quant="int8"`` makes the token write a page REQUANTIZE:
    dequantize the target page, insert the token, zero the
    not-yet-written tail (so stale garbage cannot leak into the scale),
    requantize with a fresh per-page amax scale.
    """
    cache_cap = max_blocks * block_size
    quant = kv_quant == "int8"
    use_kernel = kernel == "cuda"
    groups = cfg.n_heads // cfg.kv_heads
    hd, n_kv = cfg.head_dim, cfg.kv_heads

    def decode(params, ks, vs, ksc, vsc, tokens, pos, tables, active):
        slots = tokens.shape[0]
        dev = tokens.device
        x = _embed(params, tokens[:, None], cfg)
        cos, sin = llama2.rope_cos_sin(1, hd, positions=pos)
        cos, sin = cos[:, None, :], sin[:, None, :]
        rows = torch.arange(slots, device=dev)
        pos_l = pos.long()
        off = pos_l % block_size
        pb = torch.where(
            active > 0, tables[rows, pos_l // block_size],
            torch.full_like(pos, SCRATCH_BLOCK),
        ).long()
        if not use_kernel:
            col = torch.arange(cache_cap, device=dev)
            mask = (col[None, :] <= pos_l[:, None])[:, None, None, None, :]
            view_ids = tables[:, :max_blocks].long()
        if quant:
            idx = torch.arange(block_size, device=dev)
            written = (idx[None, :] <= off[:, None])[..., None, None]
        for i in range(cfg.n_layers):
            lp = params[f"layers_{i}"]
            h = _rmsnorm(x, lp["attention_norm"]["scale"], cfg.norm_eps)
            q, k, v = _qkv(h, lp, cfg)
            q = llama2.apply_rope(q, cos, sin)
            k = llama2.apply_rope(k, cos, sin)
            if quant:
                k_page = dequantize_pages_int8(ks[i, pb], ksc[i, pb])
                v_page = dequantize_pages_int8(vs[i, pb], vsc[i, pb])
                k_page[rows, off] = k[:, 0].to(torch.float32)
                v_page[rows, off] = v[:, 0].to(torch.float32)
                k_page = torch.where(written, k_page, 0.0)
                v_page = torch.where(written, v_page, 0.0)
                kq, k_sc = quantize_pages_int8(k_page)
                vq, v_sc = quantize_pages_int8(v_page)
                ks[i, pb] = kq
                vs[i, pb] = vq
                ksc[i, pb] = k_sc
                vsc[i, pb] = v_sc
            else:
                ks[i, pb, off] = k[:, 0].to(ks.dtype)
                vs[i, pb, off] = v[:, 0].to(vs.dtype)
            if use_kernel:
                qd = q[:, 0].to(cfg.dtype).reshape(
                    slots, n_kv, groups, hd
                ).contiguous()
                ctx = paged_decode_attention(
                    qd, ks[i], vs[i], tables, pos, active,
                    block_size=block_size, max_blocks=max_blocks,
                    k_scale=ksc[i] if quant else None,
                    v_scale=vsc[i] if quant else None,
                )
                attn = ctx.reshape(slots, 1, cfg.n_heads, hd)
            else:
                k_view = ks[i][view_ids]
                v_view = vs[i][view_ids]
                if quant:
                    k_view = dequantize_pages_int8(k_view, ksc[i][view_ids])
                    v_view = dequantize_pages_int8(v_view, vsc[i][view_ids])
                k_view = k_view.reshape(slots, cache_cap, n_kv, hd)
                v_view = v_view.reshape(slots, cache_cap, n_kv, hd)
                attn = _grouped_attention(
                    q, k_view.to(cfg.dtype), v_view.to(cfg.dtype), mask,
                    cfg,
                )
            x = x + _attn_out_proj(attn, lp, cfg)
            h = _rmsnorm(x, lp["ffn_norm"]["scale"], cfg.norm_eps)
            x = x + _mlp(h, lp, cfg)
        logits = _logits_head(x, params, cfg)
        return torch.argmax(logits[:, 0], dim=-1).to(torch.int32)

    return decode


def make_copy_block_fn(kv_quant: str = "none"):
    """``(ks, vs, ksc, vsc, src, dst)``: copy one physical page (all
    layers) IN PLACE -- the device half of copy-on-write. In int8 mode
    the page's scale entry travels with its payload (a copied page that
    kept the source's bytes but not its scale would dequantize to
    garbage)."""
    quant = kv_quant == "int8"

    def copy_block(ks, vs, ksc, vsc, src: int, dst: int):
        ks[:, dst] = ks[:, src]
        vs[:, dst] = vs[:, src]
        if quant:
            ksc[:, dst] = ksc[:, src]
            vsc[:, dst] = vsc[:, src]

    return copy_block


# ---------------------------------------------------------------------
# The engine
# ---------------------------------------------------------------------


@dataclasses.dataclass
class _PagedSlot:
    """Host-side request state behind one batch slot."""

    prompt: List[int]
    max_new: int
    blocks: List[int]          # pages this request references, in order
    n_shared: int              # leading pages resolved from the trie
    plan: List[Tuple[int, int, int]]   # (start, run, bucket) chunks
    next_chunk: int = 0
    # Per-request sampling contract (serve/spec.py): the seeded
    # temperature/top-p head of the spec prefill program reads these.
    seed: int = 0
    temperature: float = 0.0
    top_p: float = 1.0


class PagedEngine(Engine):
    """Prefill/decode programs over a paged KV pool.

    Presents the slab :class:`Engine`'s build/warmup surface plus the
    paged protocol the scheduler drives (``is_paged`` marks it):

    * :meth:`validate_request` -- submit-time page-budget check (typed
      :class:`UnservableRequestError` for never-servable requests);
    * :meth:`admit` -- prefix-trie lookup, conservative page
      reservation for prompt + max_new (a request that admits always
      finishes), chunk plan; raises :class:`BlockBudgetError` when the
      pool is transiently full (after trying to reclaim trie-only
      pages);
    * :meth:`prefill_step` -- run the next chunk; returns the first
      greedy token once the prompt is fully prefilled (and registers
      the prompt's full pages in the trie);
    * :meth:`decode` -- one token for every slot, block tables and the
      active mask riding as data;
    * :meth:`release` -- drop the request's page references (trie
      references survive, so its prompt stays hit-able).
    """

    is_paged = True

    def __init__(
        self,
        params: Any,
        cfg: llama2.LlamaConfig,
        serve_cfg: ServeConfig,
        device: Any,
        paged: PagedConfig,
    ):
        bs = paged.block_size
        if serve_cfg.max_seq_len % bs:
            raise ValueError(
                f"max_seq_len {serve_cfg.max_seq_len} must be a "
                f"multiple of block_size {bs} (the logical view is a "
                "whole number of pages)"
            )
        bad = [b for b in serve_cfg.prefill_buckets if b % bs]
        if bad:
            raise ValueError(
                f"prefill buckets {bad} are not multiples of "
                f"block_size {bs} (chunk writes are page-aligned)"
            )
        if paged.prefill_chunk > max(serve_cfg.prefill_buckets):
            raise ValueError(
                f"prefill_chunk {paged.prefill_chunk} exceeds the "
                f"largest built bucket "
                f"{max(serve_cfg.prefill_buckets)}"
            )
        if paged.kv_quant == "int8" and serve_cfg.cache_dtype is not None:
            raise ValueError(
                "kv_quant='int8' fixes the pool storage dtype; drop "
                f"cache_dtype={serve_cfg.cache_dtype!r} (the scale "
                "side arrays are always f32)"
            )
        per_seq = serve_cfg.max_seq_len // bs
        self.paged = paged
        self.kv_kernel = paged.kernel
        self.kv_quant = paged.kv_quant
        self.max_blocks_per_seq = per_seq
        # Table rows carry extra scratch entries past capacity so a
        # bucket-padded chunk write at the capacity edge stays
        # in-range (see make_chunk_logits_fn).
        self.table_width = per_seq + max(serve_cfg.prefill_buckets) // bs
        super().__init__(params, cfg, serve_cfg, device)

        # Speculative decoding (serve/spec.py): attach_spec sets the
        # runner + the extra program builders the program table
        # dispatches to; None means plain greedy single-token decode.
        self.spec = None
        self._spec_builders: Dict[str, Any] = {}
        self._tier_builders: Dict[str, Any] = {}
        self.allocator = BlockAllocator(
            paged.num_blocks, host_blocks=paged.host_blocks
        )
        self.trie: Optional[PrefixTrie] = (
            PrefixTrie(bs) if paged.prefix_cache else None
        )
        # Host-DRAM page tier (serve/tier.py): parked pages spill to
        # host buffers under pool pressure and prefetch back on a
        # returning prompt. None = no tier (host_blocks == 0). The
        # tier builds its gather/scatter through THIS program table.
        self.host_tier = None
        if paged.host_blocks:
            from tpu_hpc_torch.serve.tier import HostTier

            self.host_tier = HostTier(self)
        self._tables = np.full(
            (serve_cfg.slots, self.table_width), SCRATCH_BLOCK,
            np.int32,
        )
        self._tables_dev = None  # rebuilt lazily after table edits
        self._slot_state: Dict[int, _PagedSlot] = {}
        self.prefill_forwarded_total = 0
        # Registry gauge names are process-global: a second pool in
        # the process (the spec draft engine) suffixes them, or the
        # pools overwrite each other's readings.
        self.gauge_suffix = ""
        self._described_suffix: Optional[str] = None
        self.paged_stats = {
            "prefix_lookups": 0, "prefix_hits": 0,
            "prefix_hit_blocks": 0, "prefill_chunks": 0,
            "cow_copies": 0, "trie_evictions": 0,
        }
        self._blocks_free_min = self.allocator.free_blocks
        reg = get_registry()
        reg.describe(
            "serve_prefix_hit_total",
            "Admissions whose prompt prefix was served from the trie "
            "(prefill FLOPs skipped)",
        )
        reg.describe(
            "serve_prefix_hit_blocks_total",
            "KV pages reused from the prefix trie",
        )
        self._set_block_gauges()

    # -- cache layout overrides ----------------------------------------
    def _cache_shape(self) -> Tuple[int, ...]:
        return (
            self.cfg.n_layers, self.paged.num_blocks,
            self.paged.block_size, self.cfg.kv_heads,
            self.cfg.head_dim,
        )

    def _init_cache(self) -> None:
        """int8 pools override the slab allocation: int8 payload pages
        plus f32 per-page scale side arrays ``[n_layers, num_blocks]``
        for K and V. ``cache_bytes`` counts both."""
        if self.paged.kv_quant != "int8":
            super()._init_cache()
            self.k_scales = self.v_scales = None
            return
        shape = self._cache_shape()
        sc_shape = (self.cfg.n_layers, self.paged.num_blocks)
        dev = self.device
        self.ks = torch.zeros(shape, dtype=torch.int8, device=dev)
        self.vs = torch.zeros(shape, dtype=torch.int8, device=dev)
        # Floor, not zero: a never-written page must dequantize to
        # exact zeros without a 0/0 hazard on the requantize round
        # trip.
        self.k_scales = torch.full(
            sc_shape, INT8_SCALE_FLOOR, dtype=torch.float32, device=dev
        )
        self.v_scales = torch.full(
            sc_shape, INT8_SCALE_FLOOR, dtype=torch.float32, device=dev
        )
        self.cache_bytes = (
            2 * int(np.prod(shape)) + 2 * int(np.prod(sc_shape)) * 4
        )

    # -- program table -------------------------------------------------
    def _build(self, key):
        self.compile_count += 1
        # Speculative programs (spec_verify / spec_draft /
        # spec_prefill): serve/spec.py's builders, called with THIS
        # engine -- same table, same counter, so the no-rebuild pins
        # cover them too.
        if key[0] in self._spec_builders:
            return self._spec_builders[key[0]](self, key)
        # Host-tier programs (serve/tier.py spill gather / refill
        # scatter): same table, same counter.
        if key[0] in self._tier_builders:
            return self._tier_builders[key[0]](key)
        if key[0] == "prefill":
            return make_chunk_prefill_fn(
                self.cfg, key[1], self.paged.block_size,
                self.max_blocks_per_seq, self.table_width,
                kernel=self.paged.kernel, kv_quant=self.paged.kv_quant,
            )
        if key[0] == "decode":
            return make_paged_decode_fn(
                self.cfg, self.paged.block_size,
                self.max_blocks_per_seq, self.table_width,
                kernel=self.paged.kernel, kv_quant=self.paged.kv_quant,
            )
        return make_copy_block_fn(kv_quant=self.paged.kv_quant)

    def warmup(self) -> int:
        """Build every steady-state program (one prefill per bucket,
        decode, copy_block). With ``kernel="cuda"`` on the card this
        also builds and loads the kernel library, so nvcc runs here
        and not inside the first request's TTFT.

        With a SpecRunner attached the steady state is the sampled
        prefill per bucket, the verify step, copy_block and the draft
        side's programs; the plain greedy decode program is NOT built
        (the verify step is the decode step), so a stray call would
        count as a rebuild. Returns :attr:`compile_count_total`."""
        if self.spec is not None:
            for b in self.serve_cfg.prefill_buckets:
                self._get_exec(("spec_prefill", b))
            self._get_exec(("spec_verify",))
            self._get_exec(("copy_block",))
            self.spec.warmup_draft()
        else:
            for b in self.serve_cfg.prefill_buckets:
                self._get_exec(("prefill", b))
            self._get_exec(("decode",))
            self._get_exec(("copy_block",))
        if self.host_tier is not None:
            self.host_tier.warmup()
        if self.paged.kernel == "cuda" and self.device.type == "cuda":
            from tpu_hpc_torch.kernels import _build

            _build.load_library()
        return self.compile_count_total

    @property
    def compile_count_total(self) -> int:
        """Program builds across the WHOLE serving unit: this engine
        plus the attached draft engine -- the number the rebuild guards
        pin (a draft-side rebuild is as much a steady-state violation
        as a target one)."""
        n = self.compile_count
        if self.spec is not None:
            n += self.spec.draft_compile_count
        return n

    # -- page bookkeeping ----------------------------------------------
    def _set_block_gauges(self) -> None:
        free = self.allocator.free_blocks
        self._blocks_free_min = min(self._blocks_free_min, free)
        reg = get_registry()
        sfx = self.gauge_suffix
        if self._described_suffix != sfx:
            self._described_suffix = sfx
            reg.describe(
                f"serve_kv_blocks_free{sfx}",
                "KV pages on the free list (trie-parked pages are "
                "reclaimable and not counted free)",
            )
            reg.describe(
                f"serve_kv_blocks_used{sfx}",
                "KV pages referenced by live requests or the prefix trie",
            )
        reg.set_gauge(f"serve_kv_blocks_free{sfx}", free)
        reg.set_gauge(
            f"serve_kv_blocks_used{sfx}", self.allocator.used_blocks
        )

    @property
    def block_occupancy(self) -> float:
        """Fraction of the pool held by LIVE requests (trie-parked
        pages are a reclaimable cache and are excluded)."""
        usable = self.paged.usable_blocks
        if not usable:
            return 0.0
        live: set = set()
        for st in self._slot_state.values():
            live.update(st.blocks)
        return len(live) / usable

    def slot_table(self, slot: int) -> np.ndarray:
        """Host copy of one slot's block-table row (the disaggregated
        hop reads it to ship exactly the referenced pages)."""
        return self._tables[slot].copy()

    def slot_state(self, slot: int) -> _PagedSlot:
        return self._slot_state[slot]

    def _tables_device(self) -> torch.Tensor:
        if self._tables_dev is None:
            self._tables_dev = self._rep_arr(self._tables)
        return self._tables_dev

    def _write_table(self, slot: int, blocks: Sequence[int]) -> None:
        row = np.full((self.table_width,), SCRATCH_BLOCK, np.int32)
        row[:len(blocks)] = blocks
        self._tables[slot] = row
        self._tables_dev = None

    # -- the paged protocol --------------------------------------------
    def validate_request(
        self, prompt_len: int, max_new: int, rid: str = "?"
    ) -> None:
        """Submit-time discipline: reject only the truly unservable.
        With chunked prefill any prompt length up to capacity chunks
        through the built buckets; without it, the whole remainder
        must fit one bucket."""
        need = self.paged.blocks_for(prompt_len + max_new)
        usable = self.paged.usable_blocks
        if need > usable:
            raise UnservableRequestError(
                f"request {rid!r}: prompt {prompt_len} + max_new "
                f"{max_new} needs {need} pages of "
                f"{self.paged.block_size} tokens, but the pool budget "
                f"is {usable} usable pages "
                f"({self.paged.num_blocks} minus scratch)"
            )
        if not self.paged.prefill_chunk:
            self.serve_cfg.bucket_for(prompt_len)

    def _chunk_plan(
        self, start: int, prompt_len: int
    ) -> List[Tuple[int, int, int]]:
        plan = []
        pos = start
        stride = self.paged.prefill_chunk or None
        while pos < prompt_len:
            run = prompt_len - pos
            if stride is not None:
                run = min(stride, run)
            plan.append((pos, run, self.serve_cfg.bucket_for(run)))
            pos += run
        return plan

    def admit(
        self,
        slot: int,
        prompt: Sequence[int],
        max_new: int,
        run_prefill: bool = True,
        sampling: Optional[Tuple[int, float, float]] = None,
    ) -> Dict[str, int]:
        """Reserve pages and build the chunk plan for one request.

        Conservative reservation: ``ceil((prompt + max_new) / bs)``
        pages up front (minus prefix hits), so decode can never hit an
        empty free list mid-request -- admission is the only place the
        pool says no. ``run_prefill=False`` (the disaggregated decode
        tier) reserves the same pages but skips the trie and the chunk
        plan: the page contents arrive by the cross-tier hop.

        ``sampling`` (``(seed, temperature, top_p)``, spec engines
        only) is the request's seeded-sampling contract; the spec
        prefill program's first-token head reads it, and the attached
        draft pool mirrors the admission one-for-one.
        """
        if slot in self._slot_state:
            raise ValueError(f"slot {slot} already admitted")
        plen = len(prompt)
        need = self.paged.blocks_for(plen + max_new)
        shared: List[int] = []
        if run_prefill and self.trie is not None:
            shared = self.trie.match(prompt)
            # Keep at least one prompt token to (re-)prefill: the
            # first greedy token comes from the last prompt position's
            # logits, which a fully-cached prompt would never compute.
            while shared and len(shared) * self.paged.block_size >= plen:
                shared.pop()
        self.allocator.retain(shared)
        fresh_needed = need - len(shared)
        short = fresh_needed - self.allocator.free_blocks
        if short > 0 and self.host_tier is not None:
            # Spill beats evict: a parked page moved to host DRAM is a
            # cheap hop on return, an evicted page is a full
            # re-prefill. Only pages the tier could not place fall
            # through to the trie eviction below.
            short -= self.host_tier.spill_parked(short)
        if short > 0 and self.trie is not None:
            self.paged_stats["trie_evictions"] += self.trie.evict(
                self.allocator, short
            )
        try:
            fresh = self.allocator.alloc(fresh_needed)
        except BlockBudgetError:
            self.allocator.release(shared)
            raise
        start = len(shared) * self.paged.block_size
        plan = self._chunk_plan(start, plen) if run_prefill else []
        seed, temperature, top_p = sampling or (0, 0.0, 1.0)
        state = _PagedSlot(
            prompt=list(int(t) for t in prompt),
            max_new=max_new,
            blocks=shared + fresh,
            n_shared=len(shared),
            plan=plan,
            seed=int(seed), temperature=float(temperature),
            top_p=float(top_p),
        )
        self._slot_state[slot] = state
        self._write_table(slot, state.blocks)
        if self.spec is not None:
            self.spec.on_admit(slot, prompt, max_new)
        bus = get_bus()
        bus.emit("kv_block", action="alloc", n=len(fresh), slot=slot)
        # Hit-rate stats count SEATED admissions only (a block-stalled
        # request is re-queued and retried every tick).
        if run_prefill and self.trie is not None:
            self.paged_stats["prefix_lookups"] += 1
        if shared:
            self.paged_stats["prefix_hits"] += 1
            self.paged_stats["prefix_hit_blocks"] += len(shared)
            get_registry().inc("serve_prefix_hit_total")
            get_registry().inc(
                "serve_prefix_hit_blocks_total", len(shared)
            )
            bus.emit(
                "kv_block", action="prefix_hit", n=len(shared),
                slot=slot,
            )
        self._set_block_gauges()
        return {
            "shared_blocks": len(shared),
            "shared_tokens": start,
            "chunks": len(plan),
            "planned_prefill_tokens": sum(b for _, _, b in plan),
        }

    def prefetch_prompt(self, prompt: Sequence[int]) -> int:
        """Refill host-spilled prefix pages for ``prompt`` back into
        the device pool *before* the request is seated, so the
        host->device hop hides behind queueing instead of stretching
        TTFT. No-op (0) without a host tier. Returns pages refilled."""
        if self.host_tier is None:
            return 0
        return self.host_tier.prefetch(prompt)

    def admission_headroom(self, prompt: Sequence[int], max_new: int) -> bool:
        """Cheap pre-check: could ``admit()`` plausibly succeed for
        this request right now? Counts free pages, trie-matched pages,
        and parked pages reclaimable by spill or eviction. Heuristic
        only -- ``admit()``'s ``BlockBudgetError`` stays the authority
        -- but it lets the scheduler skip the prefetch hop for a
        request that is about to block-stall anyway."""
        need = self.paged.blocks_for(len(prompt) + max_new)
        matched = 0
        reclaimable = 0
        if self.trie is not None:
            matched = len(self.trie.match(list(int(t) for t in prompt)))
            # Parked exclusive pages: spillable or evictable on demand.
            reclaimable = sum(
                1
                for b, c in self.allocator._ref.items()
                if c == 1 and b != SCRATCH_BLOCK
            ) - self._held_by_live_slots()
        avail = self.allocator.free_blocks + matched + max(0, reclaimable)
        return avail >= need

    def _held_by_live_slots(self) -> int:
        """Pages referenced by seated requests (refcount floor: these
        can never be spilled or evicted)."""
        live = set()
        for st in self._slot_state.values():
            live.update(st.blocks)
        return len(live)

    @torch.no_grad()
    def prefill_step(self, slot: int) -> Optional[int]:
        """Run the next prefill chunk for ``slot``. Returns the first
        token when the prompt is complete, else ``None``. The final
        chunk's token fetch rides inside the span, so the span measures
        dispatch-to-result. With a SpecRunner attached the chunk runs
        the sampled prefill variant (same layer loop, the request's
        seeded temperature/top-p head; greedy requests get exactly the
        argmax token), and a finished prompt runs the draft's prefill
        too."""
        st = self._slot_state[slot]
        if st.next_chunk >= len(st.plan):
            raise ValueError(f"slot {slot} has no prefill pending")
        start, run, bucket = st.plan[st.next_chunk]
        padded = np.zeros((1, bucket), np.int32)
        padded[0, :run] = st.prompt[start:start + run]
        args = [
            self.params, self.ks, self.vs, self.k_scales, self.v_scales,
            self._rep_arr(padded).long(), start, run,
            self._rep_arr(self._tables[slot]),
        ]
        if self.spec is not None:
            exec_ = self._get_exec(("spec_prefill", bucket))
            args += [st.seed, st.temperature, st.top_p]
        else:
            exec_ = self._get_exec(("prefill", bucket))
        with span("prefill", hist="serve_prefill_s", n=bucket):
            tok = exec_(*args)
            st.next_chunk += 1
            # Padded tokens forwarded: the loadgen cost model charges
            # each chunk by it (a prefix hit's skipped chunks cost
            # nothing).
            self.prefill_forwarded_total += bucket
            self.paged_stats["prefill_chunks"] += 1
            if st.next_chunk < len(st.plan):
                return None
            first = int(tok)
        if self.trie is not None:
            n_full = len(st.prompt) // self.paged.block_size
            if n_full:
                self.trie.insert(
                    st.prompt, st.blocks[:n_full], self.allocator
                )
        if self.spec is not None:
            self.spec.on_prefill_done(slot)
        return first

    @torch.no_grad()
    def _cow_write_target(self, slot: int, pos: int) -> None:
        """Guard rail before a decode write: the target page must be
        exclusively ours. By construction it always is (writes start
        past the shared prefix) -- but if a reference appeared, copy
        the page first instead of corrupting the other owner."""
        st = self._slot_state[slot]
        idx = pos // self.paged.block_size
        blk = st.blocks[idx]
        if self.allocator.refcount(blk) <= 1:
            return
        new, copied = self.allocator.cow(blk)
        if copied:
            exec_ = self._get_exec(("copy_block",))
            exec_(self.ks, self.vs, self.k_scales, self.v_scales, blk, new)
            st.blocks[idx] = new
            self._write_table(slot, st.blocks)
            self.paged_stats["cow_copies"] += 1
            get_bus().emit(
                "kv_block", action="cow", block=int(new), slot=slot
            )
            self._set_block_gauges()

    @torch.no_grad()
    def decode(
        self,
        tokens: Sequence[int],
        positions: Sequence[int],
        active: Optional[Sequence[bool]] = None,
    ) -> np.ndarray:
        """One decode step for every slot; ``active[s]`` False redirects
        slot ``s``'s write to the scratch page (free slots, and slots
        still mid-chunked-prefill, must not dirty live pages). Exactly
        one host fetch per step: the next tokens, inside the span."""
        if active is None:
            active = [True] * self.serve_cfg.slots
        for s, (is_on, pos) in enumerate(zip(active, positions)):
            if is_on and s in self._slot_state:
                self._cow_write_target(s, int(pos))
        exec_ = self._get_exec(("decode",))
        with span("decode", hist="serve_decode_s"):
            toks = exec_(
                self.params, self.ks, self.vs, self.k_scales,
                self.v_scales,
                self._rep_arr(np.asarray(tokens, np.int32)).long(),
                self._rep_arr(np.asarray(positions, np.int32)),
                self._tables_device(),
                self._rep_arr(np.asarray(active, np.int32)),
            )
            return toks.cpu().numpy()

    def release(self, slot: int) -> None:
        """Drop the request's page references (the trie keeps its own,
        so the prompt stays reusable) and reset the table row."""
        st = self._slot_state.pop(slot, None)
        if st is None:
            return
        freed = self.allocator.release(st.blocks)
        self._write_table(slot, [])
        get_bus().emit("kv_block", action="free", n=freed, slot=slot)
        self._set_block_gauges()
        if self.spec is not None:
            self.spec.on_release(slot)

    def reset_pool(self, force: bool = False) -> None:
        """Drop ALL cached KV state: allocator, prefix trie, block
        tables, slot bookkeeping (the weight-swap half of a
        drain-and-swap). The pool tensors keep their (now garbage)
        contents; a fresh allocator plus scratch-reset tables make
        every stale row unreachable. ``force=False`` refuses while
        requests are still admitted."""
        if self._slot_state and not force:
            raise RuntimeError(
                f"reset_pool on an undrained engine ({len(self._slot_state)} "
                "slot(s) still admitted); drain first, or force=True "
                "on the dead-replica restart path"
            )
        if self.spec is not None:
            raise NotImplementedError(
                "reset_pool with an attached SpecRunner: the mirrored "
                "draft pool would desync"
            )
        self._slot_state = {}
        self.allocator = BlockAllocator(
            self.paged.num_blocks, host_blocks=self.paged.host_blocks
        )
        if self.trie is not None:
            self.trie = PrefixTrie(self.paged.block_size)
        if self.host_tier is not None:
            # Host pages also encode old-weight K/V: flush them too.
            self.host_tier.reset()
        self._tables[:] = SCRATCH_BLOCK
        self._tables_dev = None
        self._set_block_gauges()

    def spec_decode(self, *args, **kwargs):
        """One speculative decode step (serve/spec.py): draft k
        candidates per slot, verify all k+1 positions in one batched
        target forward. A named method (not a bare runner call) so the
        loadgen cost-model proxy can intercept it and charge the
        modeled draft + verify costs on the virtual clock."""
        if self.spec is None:
            raise ValueError(
                "spec_decode on an engine with no attached SpecRunner"
            )
        return self.spec.decode(*args, **kwargs)

    def prefill(self, slot: int, prompt: Sequence[int]) -> int:
        raise NotImplementedError(
            "PagedEngine is driven through admit()/prefill_step(); "
            "the one-shot prefill surface belongs to the slab Engine"
        )

    # -- reporting ------------------------------------------------------
    def paged_summary(self) -> Dict[str, Any]:
        """The serve-summary block describing this pool: layout, hit
        rate, page headroom."""
        s = self.paged_stats
        lookups = s["prefix_lookups"]
        return {
            "kv_layout": "paged",
            "kv_kernel": self.paged.kernel,
            "kv_quant": self.paged.kv_quant,
            "kv_block_size": self.paged.block_size,
            "kv_blocks": self.paged.num_blocks,
            "kv_blocks_usable": self.paged.usable_blocks,
            "kv_blocks_free": self.allocator.free_blocks,
            "kv_blocks_free_min": self._blocks_free_min,
            "prefix_lookups": lookups,
            "prefix_hits": s["prefix_hits"],
            "prefix_hit_blocks": s["prefix_hit_blocks"],
            "prefix_hit_rate": (
                s["prefix_hits"] / lookups if lookups else 0.0
            ),
            "prefill_chunks": s["prefill_chunks"],
            "cow_copies": s["cow_copies"],
            "trie_evictions": s["trie_evictions"],
            **(
                self.host_tier.summary()
                if self.host_tier is not None else {}
            ),
        }
