"""Shard/fit analysis: does a Llama training (or serving) configuration
fit the cards' HBM, and what does its update look like?

Port of the JAX package's ``checks/fit.py`` for H100 cards:

  1. **Exact static accounting** -- the port's Llama built on the
     ``meta`` device (``llama2.init_llama(..., device="meta")``: shapes
     and dtypes, no memory) with the port's spec trees
     (``parallel.hybrid.hybrid_pspecs`` over ``tp.llama_rules``,
     ``parallel.fsdp.param_pspecs``) gives per-card bytes for params,
     gradients and the AdamW state the port's Trainer keeps
     (``train.trainer.make_adamw(...).init`` on the meta params), exactly.
     Its one difference from the JAX numbers: optax keeps the update
     count as an int32 array leaf (4 bytes on every chip), the port's
     AdamW as a host int (no device bytes), so ``opt_bytes`` is 4 bytes
     below the JAX package's for the same configuration.
  2. **Analytic activation, KV-cache, draft and host-tier terms** --
     the JAX package's models, unchanged.
  3. **Evidence from one real update** (``do_compile=True``; there is
     no AOT compile in PyTorch) -- the port's Trainer at the analyzed
     layout runs one update: in this process on one card, across one
     process per card when the layout spans several (NCCL), or across a
     gloo world of at most 4 CPU ranks with ``device="cpu"``. It
     records the measured peak memory (``max_memory_allocated`` less
     what the process held before the update, on a card) and the
     collectives the update issued, by kind
     (``checks/collectives.py`` over a ``torch.profiler`` trace).

HBM is the card table's (``checks/roofline.py``: an 80 GiB H100). The
JAX flags that name XLA or the TPU compiler (``tpu_topology``,
``compiler_options``; ``--tpu-topology``, ``--xla-opt``) are refused.

Run: ``python -m tpu_hpc_torch.checks.fit --markdown REPORT.md``.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import tempfile
import time
from typing import Any, Dict, List, Optional

import torch

from tpu_hpc_torch.models import llama2
from tpu_hpc_torch.parallel import fsdp, hybrid, tp
from tpu_hpc_torch.parallel.plans import P, map_with_path

GIB = 1024 ** 3
DEFAULT_CHIP = "h100-sxm"
ATTN_PATHS = ("flash", "reference")


def _default_hbm_gib() -> float:
    from tpu_hpc_torch.checks.roofline import CHIPS

    return CHIPS[DEFAULT_CHIP].hbm_gib


def _itemsize(dtype) -> int:
    """Bytes per element of a dtype name ("bfloat16") or torch dtype."""
    if isinstance(dtype, str):
        dtype = getattr(torch, dtype)
    return torch.empty((), dtype=dtype, device="meta").element_size()


def _leaf_bytes_per_chip(leaf, spec: P, mesh_axes: Dict[str, int]) -> int:
    """Bytes one card holds of ``leaf`` under ``spec``: the full size
    divided by the product of the mesh-axis sizes the spec claims."""
    size = leaf.numel() * leaf.element_size()
    denom = 1
    for entry in spec:
        if entry is None:
            continue
        names = entry if isinstance(entry, tuple) else (entry,)
        for name in names:
            denom *= mesh_axes[name]
    return -(-size // denom)  # ceil: padding rounds up, never down


def _leaves_and_specs(tree: Any, specs: Any) -> List[tuple]:
    pairs: List[tuple] = []
    map_with_path(lambda _, leaf, spec: pairs.append((leaf, spec)),
                  tree, specs)
    return pairs


def tree_bytes_per_chip(tree: Any, specs: Any,
                        mesh_axes: Dict[str, int]) -> int:
    """Per-card bytes of a tensor tree laid out by a spec tree of the
    same structure."""
    return sum(_leaf_bytes_per_chip(leaf, spec, mesh_axes)
               for leaf, spec in _leaves_and_specs(tree, specs))


def meta_params(cfg: llama2.LlamaConfig) -> Dict[str, Any]:
    """The port's Llama params on the meta device: the real init's tree,
    shapes and dtypes, no memory."""
    return llama2.init_llama(torch.Generator(), cfg, device="meta")


def adamw_state_bytes(params: Any, specs: Any, mesh_axes: Dict[str, int],
                      moments_dtype: str = "float32") -> int:
    """Per-card bytes of the AdamW state the port's Trainer keeps for
    ``params``: ``make_adamw(...).init`` on them; each moment leaf takes
    its param's spec, the count is a host int (no bytes)."""
    from tpu_hpc_torch.train.trainer import (
        make_adamw,
        tree_leaves,
        tree_paths,
    )

    state = make_adamw(3e-4, 0.1, moments_dtype).init(params)
    # The moments follow tree_leaves' (sorted-key) order of the params.
    param_specs = []
    for path in tree_paths(params):
        node = specs
        for key in path:
            node = node[key]
        param_specs.append(node)
    total = 0
    for key in ("mu", "nu"):
        for leaf, spec in zip(state[key], param_specs):
            total += _leaf_bytes_per_chip(leaf, spec, mesh_axes)
    extra = [v for k, v in state.items() if k not in ("mu", "nu")]
    for leaf in tree_leaves(extra):
        if isinstance(leaf, torch.Tensor):
            total += leaf.numel() * leaf.element_size()
    return total


def kv_cache_bytes(
    cfg: llama2.LlamaConfig,
    batch_slots: int,
    max_seq_len: Optional[int] = None,
    cache_dtype: str = "bfloat16",
) -> int:
    """Per-POD bytes of a decode KV cache: batch_slots x seq x layers
    x kv_heads x head_dim x 2 (K and V) x dtype. The term the serving
    engine preallocates (serve/engine.py) and the memory-fit
    analysis previously ignored -- at 70B GQA with 4k context and 64
    slots this is ~80 GiB, not a rounding error. Divide by the mesh
    extents sharding the cache (slots over data, kv_heads over model)
    for the per-chip share; analyze() does that with its own mesh."""
    s = max_seq_len if max_seq_len is not None else cfg.max_seq_len
    itemsize = _itemsize(cache_dtype)
    return (
        batch_slots * s * cfg.n_layers * cfg.kv_heads * cfg.head_dim
        * 2 * itemsize
    )


def kv_paged_bytes(
    cfg: llama2.LlamaConfig,
    num_blocks: int,
    block_size: int,
    cache_dtype: str = "bfloat16",
    kv_quant: str = "none",
) -> int:
    """Per-POD bytes of a PAGED decode KV cache
    (serve/paging.py): num_blocks pages x block_size tokens x
    layers x kv_heads x head_dim x 2 (K and V) x dtype. The paged
    engine provisions pages for the tokens traffic actually holds,
    not ``slots x max_seq`` worst case -- the difference against
    :func:`kv_cache_bytes` at the same traffic mix is the
    fragmentation/slack headroom paging reclaims, which
    ``analyze(kv_blocks=...)`` reports next to the slab term. The
    pool shards KV heads over the model axis only (pages are globally
    addressable, so the block dim stays whole per replica).

    ``kv_quant="int8"`` (kernels/paged_attention.py) stores
    pages at 1 byte/element plus a per-page fp32 scale side array
    (one scale per page per layer, K and V each) -- the halved pool
    the quantized-capacity report line budgets."""
    if kv_quant == "int8":
        page_bytes = (
            num_blocks * block_size * cfg.n_layers * cfg.kv_heads
            * cfg.head_dim * 2
        )
        scale_bytes = num_blocks * cfg.n_layers * 2 * 4
        return page_bytes + scale_bytes
    itemsize = _itemsize(cache_dtype)
    return (
        num_blocks * block_size * cfg.n_layers * cfg.kv_heads
        * cfg.head_dim * 2 * itemsize
    )


@dataclasses.dataclass
class FitResult:
    cfg: llama2.LlamaConfig
    dp: int
    tp_size: int
    global_batch: int
    seq_len: int
    hbm_gib: float
    n_params: int
    param_bytes: int          # per card, fp32 masters
    grad_bytes: int           # per card, fp32, live during the update
    opt_bytes: int            # per card, AdamW mu+nu
    act_bytes: Dict[str, int]  # per card, analytic model
    grad_accum: int = 1
    compiled: bool = False    # one real update ran (do_compile=True)
    compile_seconds: float = 0.0  # that update's wall time, build included
    collectives: Dict[str, int] = dataclasses.field(default_factory=dict)
    # Peak device memory of that update on one card
    # (torch.cuda.max_memory_allocated less the baseline below), where
    # the JAX report keeps XLA's memory analysis; None when it ran on
    # the CPU.
    measured_peak_bytes: Optional[int] = None
    # What the process held on that card before the update
    # (torch.cuda.memory_allocated), not part of the peak above.
    measured_baseline_bytes: Optional[int] = None
    compile_backend: str = ""  # "cuda:<card> x N" | "gloo-cpu x N"
    attn: str = "flash"          # attention path of that update
    moments_dtype: str = "float32"  # AdamW moment storage dtype
    layout: str = "tp"           # "tp" (FSDPxTP+SP) | "cp" | "pp"
    kv_cache_bytes: int = 0      # per card, decode-config KV cache
    kv_slots: int = 0            # decode batch slots the term assumes
    kv_block_bytes: int = 0      # per card, PAGED decode KV pool
    kv_blocks: int = 0           # physical pages the paged term assumes
    kv_block_size: int = 0       # tokens per page
    kv_quant: str = "none"       # page storage: "none" (dtype) | "int8"
    # Host-DRAM KV page tier (serve/tier.py): parked prefixes spill
    # into host buffers, so this term is DRAM, not HBM -- reported
    # for sizing but never part of total_bytes or the fits verdict.
    kv_host_blocks: int = 0      # host tier slots incl. scratch
    kv_host_bytes: int = 0       # per host, full-width K+V buffers
    # Speculative-decode draft model (serve/spec.py): its params live
    # on the same cards and its KV pool mirrors the target's pages --
    # a draft that does not fit must fail THIS report, not OOM at
    # serving bring-up.
    draft_n_params: int = 0
    draft_param_bytes: int = 0   # per card, serving-layout fp32
    draft_kv_block_bytes: int = 0  # per card, mirrored paged pool

    @property
    def static_bytes(self) -> int:
        return self.param_bytes + self.grad_bytes + self.opt_bytes

    @property
    def total_bytes(self) -> int:
        # The paged pool REPLACES the slab cache when both are given
        # (you deploy one engine); the slab term stays reported for
        # the fragmentation-headroom comparison.
        kv = self.kv_block_bytes if self.kv_blocks \
            else self.kv_cache_bytes
        return (
            self.static_bytes + sum(self.act_bytes.values()) + kv
            + self.draft_param_bytes + self.draft_kv_block_bytes
        )

    @property
    def fits(self) -> bool:
        return self.total_bytes <= self.hbm_gib * GIB

    def to_json(self) -> Dict:
        d = {
            f.name: getattr(self, f.name)
            for f in dataclasses.fields(self)
            if f.name != "cfg"
        }
        d.update(
            model=dict(
                dim=self.cfg.dim, n_layers=self.cfg.n_layers,
                n_heads=self.cfg.n_heads, vocab_size=self.cfg.vocab_size,
                ffn_hidden=self.cfg.ffn_hidden, remat=self.cfg.remat,
            ),
            static_bytes=self.static_bytes,
            total_bytes=self.total_bytes,
            fits=self.fits,
        )
        return d


def activation_model(
    cfg: llama2.LlamaConfig, dp: int, tp_size: int,
    global_batch: int, seq_len: int, grad_accum: int = 1,
) -> Dict[str, int]:
    """Per-chip activation bytes under the bench configuration:
    remat-per-block (only block inputs saved), Megatron-SP (residual
    stream sequence-sharded over the model axis between blocks), flash
    attention (O(S) saved state, no S x S scores), bf16 compute.

    ``grad_accum > 1``: each microbatch's activations live only for its
    own forward/backward inside the accumulation scan, so every term
    scales by 1/grad_accum (the gradient-sum carry is accounted
    separately in analyze()).

    An analytic model, not a measurement: the real peak adds the
    framework's temporaries, but the dominant terms (checkpointed residuals, one
    block's recompute live-set, the logits/CE head) are all here.
    """
    # Per-chip, per-microbatch rows (DP shards the batch dim).
    bl = global_batch // dp // grad_accum
    s_sp = seq_len // tp_size        # SP-sharded sequence slice
    d, hd = cfg.dim, cfg.head_dim
    h_loc = cfg.n_heads // tp_size   # TP shards heads
    kv_loc = max(cfg.kv_heads // tp_size, 1)
    ffn_loc = cfg.ffn_hidden // tp_size
    bf16, f32 = 2, 4

    # Saved between fwd and bwd: one residual checkpoint per block
    # (sequence-sharded thanks to SP) + embedding output.
    checkpoints = (cfg.n_layers + 1) * bl * s_sp * d * bf16
    # Live while recomputing/backpropping ONE block (full seq per chip
    # -- the SP all-gather happens at the block boundary): input + QKV +
    # flash out/LSE + two SwiGLU hiddens, roughly doubled for the
    # matching gradient buffers.
    qkv = bl * seq_len * (h_loc + 2 * kv_loc) * hd * bf16
    attn_out = bl * seq_len * h_loc * hd * bf16
    lse = bl * h_loc * seq_len * f32
    mlp = 2 * bl * seq_len * ffn_loc * bf16
    block_live = 2 * (bl * seq_len * d * bf16 + qkv + attn_out + lse + mlp)
    # LM head: logits are vocab-sharded (output Colwise) and stay in
    # bf16 -- the loss upcasts inside its reductions (models/losses.py):
    # bf16 logits + bf16 logit-grad + one fp32 reduction pass.
    vocab_loc = cfg.vocab_size // tp_size
    head = bl * seq_len * vocab_loc * (2 * bf16 + f32)
    return {
        "residual_checkpoints": checkpoints,
        "block_recompute_live": block_live,
        "lm_head_and_loss": head,
    }


def activation_model_cp(
    cfg: llama2.LlamaConfig, dp: int, cp: int,
    global_batch: int, seq_len: int, grad_accum: int = 1,
) -> Dict[str, int]:
    """Per-chip activation bytes for the long-context layout: FSDP
    over ``data``, ring-attention context parallelism over
    ``context`` (``train --sp-mode ring``). The residual stream is
    sequence-sharded EVERYWHERE (cp_constrain), attention is the ring
    (O(S/cp) per chip: a device never holds more than its own Q chunk
    plus the KV chunk passing through), and there is no TP -- heads,
    FFN and vocab are full-width but only S/cp tokens deep.
    """
    bl = global_batch // dp // grad_accum
    s_loc = seq_len // cp
    d, hd = cfg.dim, cfg.head_dim
    h, kv = cfg.n_heads, cfg.kv_heads
    bf16, f32 = 2, 4

    checkpoints = (cfg.n_layers + 1) * bl * s_loc * d * bf16
    qkv = bl * s_loc * (h + 2 * kv) * hd * bf16
    # Ring state: the rotating K/V chunk is double-buffered (current +
    # in-flight send/recv), and the merge carries an fp32 output
    # accumulator + LSE.
    ring_kv = 2 * 2 * bl * s_loc * kv * hd * bf16
    out_acc = bl * s_loc * h * hd * f32
    lse = bl * h * s_loc * f32
    mlp = 2 * bl * s_loc * cfg.ffn_hidden * bf16
    block_live = 2 * (
        bl * s_loc * d * bf16 + qkv + ring_kv + out_acc + lse + mlp
    )
    head = bl * s_loc * cfg.vocab_size * (2 * bf16 + f32)
    return {
        "residual_checkpoints": checkpoints,
        "block_recompute_live": block_live,
        "lm_head_and_loss": head,
    }


def activation_model_pp(
    cfg: llama2.LlamaConfig, dp: int, stages: int,
    global_batch: int, seq_len: int, microbatches: int,
    pp_backward: str = "remat",
) -> Dict[str, int]:
    """Per-chip activation bytes for the pipeline layout (1F1B,
    pp.pipelined): each chip holds ONE stage's layers; at the 1F1B
    steady state up to ``stages`` microbatches are in flight per chip.
    ``pp_backward="remat"`` (the default): each in-flight microbatch
    contributes its stage's residual checkpoints only (the custom-vjp
    backward recomputes everything else). ``"stash"``: each in-flight
    slot instead holds the full vjp residuals -- every per-layer
    intermediate plus a compute-dtype copy of the stage params
    (parallel/pp.py, backward="stash"). Sequence is NOT sharded
    (full seq per chip, flash attention assumed -- no S x S scores).
    """
    if global_batch % (dp * microbatches):
        raise ValueError(
            f"global_batch {global_batch} must divide into dp {dp} x "
            f"microbatches {microbatches} rows"
        )
    mbr = global_batch // dp // microbatches  # rows per microbatch
    d, hd = cfg.dim, cfg.head_dim
    h, kv = cfg.n_heads, cfg.kv_heads
    bf16, f32 = 2, 4
    layers_loc = cfg.n_layers // stages
    # The tick programs allocate their ring buffers at FIXED depth
    # 2S (parallel/pp.py: D = 2 * n_stages), resident for the whole
    # schedule -- capacity follows the allocation, not the in-flight
    # high-water mark.
    ring_depth = 2 * stages
    # Residuals per microbatch per layer-token: dim (input) +
    # q/k/v/attn-out + both SwiGLU hiddens (matches the roofline's
    # stash_residuals traffic term, checks/roofline.py).
    per_tok = d + (h + 2 * kv + h) * hd + 2 * cfg.ffn_hidden
    if pp_backward == "stash":
        # Every ring slot holds a full vjp residual set, including a
        # bf16 stage-param copy.
        checkpoints = ring_depth * (
            layers_loc * mbr * seq_len * per_tok * bf16
            + llama2.pp_worst_stage_params(cfg, stages) * bf16
        )
    else:
        # Remat: ring slots hold stage INPUTS only; the backward's
        # vjp materializes ONE microbatch's full stage residuals
        # transiently each tick.
        checkpoints = (
            ring_depth * mbr * seq_len * d * bf16
            + layers_loc * mbr * seq_len * per_tok * bf16
        )
    qkv = mbr * seq_len * (h + 2 * kv) * hd * bf16
    attn_out = mbr * seq_len * h * hd * bf16
    lse = mbr * h * seq_len * f32
    mlp = 2 * mbr * seq_len * cfg.ffn_hidden * bf16
    block_live = 2 * (
        mbr * seq_len * d * bf16 + qkv + attn_out + lse + mlp
    )
    head = mbr * seq_len * cfg.vocab_size * (2 * bf16 + f32)
    return {
        "inflight_stage_checkpoints": checkpoints,
        "block_recompute_live": block_live,
        "lm_head_and_loss": head,
    }


def _update_run(args: Dict[str, Any], rank: int, world: int) -> Dict[str, Any]:
    """One real update of the port's Trainer at the analyzed layout, on
    this rank of a ``world``-rank job (the process group is up when
    ``world`` > 1); returns its collectives by kind, the update's own
    peak device memory (the peak less what the process held before it:
    on one rank the caller's process may hold tensors of its own), that
    baseline, the wall time and the loss."""
    from torch.profiler import ProfilerActivity, profile

    from tpu_hpc_torch.checks.collectives import collective_counts
    from tpu_hpc_torch.runtime import MeshSpec, build_mesh
    from tpu_hpc_torch.train.__main__ import PipeArgs, build_trainer

    cfg, layout = args["cfg"], args["layout"]
    dp, axis2 = args["dp"], args["axis2"]
    device = torch.device(args["device"], rank) \
        if args["device"] == "cuda" else torch.device("cpu")
    baseline = None
    if device.type == "cuda":
        torch.cuda.set_device(device)
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
        baseline = torch.cuda.memory_allocated(device)
    axis_name = {"tp": "model", "cp": "context", "pp": "pipe"}[layout]
    mesh = None
    if world > 1:
        mesh = build_mesh(MeshSpec(axes={"data": dp, axis_name: axis2}),
                          device.type)
    kw: Dict[str, Any] = dict(
        steps=1, epochs=1, attn=args["attn"],
        moments_dtype=args["moments_dtype"], device=device, mesh=mesh)
    if layout == "pp":
        kw["pp"] = PipeArgs(
            schedule="1f1b", model="llama", backward=args["pp_backward"],
            microbatches=args["grad_accum"],
            microbatch_size=args["global_batch"] // args["grad_accum"])
        kw.update(batch=args["global_batch"], grad_accum_steps=1)
    else:
        kw.update(batch=args["global_batch"] // dp,
                  grad_accum_steps=args["grad_accum"])
        if layout == "cp":
            kw["sp_mode"] = "ring"
    t0 = time.perf_counter()
    trainer, ds = build_trainer(cfg, **kw)
    batch = ds.batch_at(0, trainer.cfg.global_batch_size)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        loss = float(trainer.train_step(batch)["loss"])
    seconds = time.perf_counter() - t0
    return {
        "collectives": collective_counts(prof),
        "peak_bytes": (torch.cuda.max_memory_allocated(device) - baseline
                       if device.type == "cuda" else None),
        "baseline_bytes": baseline,
        "seconds": seconds,
        "loss": loss,
        "backend": (f"cuda:{torch.cuda.get_device_name(device)} x {world}"
                    if device.type == "cuda" else f"gloo-cpu x {world}"),
    }


def _update_rank(rank: int, world: int, port: int, args: Dict[str, Any],
                 out_path: str) -> None:
    """mp.spawn entry: join the job (NCCL on cards, gloo on the CPU),
    run the update, rank 0 writes its record."""
    import torch.distributed as dist

    if args["device"] == "cuda":
        torch.cuda.set_device(rank)
    else:
        torch.set_num_threads(1)  # the ranks share one host's cores
    dist.init_process_group(
        "nccl" if args["device"] == "cuda" else "gloo",
        init_method=f"tcp://127.0.0.1:{port}", rank=rank, world_size=world)
    try:
        rec = _update_run(args, rank, world)
        if rank == 0:
            with open(out_path, "w") as f:
                json.dump(rec, f)
    finally:
        dist.destroy_process_group()


MAX_CPU_RANKS = 4


def _measure_update(result: "FitResult", cfg: llama2.LlamaConfig,
                    layout: str, dp: int, axis2: int, global_batch: int,
                    grad_accum: int, attn: str, moments_dtype: str,
                    pp_backward: str, device: str) -> "FitResult":
    """The compile pass's counterpart: run one real update at the
    analyzed layout (in this process for one rank, else one spawned
    process per rank) and attach what it measured to ``result``."""
    world = dp * axis2
    if device == "cuda":
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if have < world:
            raise RuntimeError(
                f"the update at data={dp} x {layout}={axis2} needs {world} "
                f"CUDA devices, {have} visible (pass device='cpu' for a "
                f"gloo world of at most {MAX_CPU_RANKS} ranks, or "
                "do_compile=False)")
    elif world > MAX_CPU_RANKS:
        raise RuntimeError(
            f"the update at data={dp} x {layout}={axis2} needs {world} "
            f"ranks; a CPU run takes at most {MAX_CPU_RANKS}")
    args = dict(cfg=cfg, layout=layout, dp=dp, axis2=axis2,
                global_batch=global_batch, grad_accum=grad_accum, attn=attn,
                moments_dtype=moments_dtype, pp_backward=pp_backward,
                device=device)
    if world == 1:
        rec = _update_run(args, 0, 1)
    else:
        import torch.multiprocessing as mp

        from tpu_hpc_torch.runtime.sim import free_port

        with tempfile.TemporaryDirectory() as tmp:
            out = os.path.join(tmp, "update.json")
            mp.spawn(_update_rank, args=(world, free_port(), args, out),
                     nprocs=world, join=True)
            with open(out) as f:
                rec = json.load(f)
    result.compiled = True
    result.compile_seconds = rec["seconds"]
    result.collectives = rec["collectives"]
    result.measured_peak_bytes = rec["peak_bytes"]
    result.measured_baseline_bytes = rec["baseline_bytes"]
    result.compile_backend = rec["backend"]
    return result


def analyze(
    cfg: Optional[llama2.LlamaConfig] = None,
    dp: int = 4,
    tp_size: int = 8,
    global_batch: int = 8,
    seq_len: int = 4096,
    hbm_gib: Optional[float] = None,
    do_compile: bool = True,
    grad_accum: int = 1,
    tpu_topology: Optional[str] = None,
    attn: str = "flash",
    compiler_options: Optional[Dict[str, str]] = None,
    moments_dtype: str = "float32",
    layout: str = "tp",
    pp_backward: str = "remat",
    kv_slots: int = 0,
    kv_seq_len: Optional[int] = None,
    kv_cache_dtype: str = "bfloat16",
    kv_blocks: int = 0,
    kv_block_size: int = 16,
    kv_quant: str = "none",
    kv_host_blocks: int = 0,
    draft_cfg: Optional[llama2.LlamaConfig] = None,
    device: str = "cuda",
) -> FitResult:
    """Shard/fit analysis of the Llama training update (the JAX
    signature; see the module docstring).

    Defaults: 7B on a (data=4, model=8) mesh -- 32 cards, four nodes of
    eight -- against the H100's HBM (``hbm_gib`` None: the card table's
    ``h100-sxm`` row). ``layout`` "tp" (hybrid FSDP x TP + SP), "cp"
    (FSDP x ring attention over ``context``) or "pp" (DP x 1F1B
    pipeline, ``grad_accum`` microbatches); ``tp_size`` is the second
    axis' degree in each. ``do_compile`` runs one real update (see
    :func:`_measure_update`) on ``device`` ("cuda", the default, or
    "cpu"); ``attn`` is its attention path ("flash": the Hopper kernels;
    "reference": the model's einsum path). ``tpu_topology`` and
    ``compiler_options`` name the TPU compiler and are refused.
    """
    if tpu_topology is not None:
        raise ValueError(
            f"tpu_topology={tpu_topology!r}: there is no TPU compiler to "
            "compile against; do_compile=True runs one real update of the "
            "port's Trainer instead")
    if compiler_options:
        raise ValueError(
            f"compiler_options={compiler_options!r}: XLA compiler options "
            "have no counterpart in the PyTorch port")
    if attn not in ATTN_PATHS:
        raise ValueError(f"unknown attn {attn!r} ({'|'.join(ATTN_PATHS)})")
    if hbm_gib is None:
        hbm_gib = _default_hbm_gib()
    if cfg is None:
        cfg = llama2.LlamaConfig(max_seq_len=seq_len, remat=True)
    if layout not in ("tp", "cp", "pp"):
        raise ValueError(f"unknown layout {layout!r} (tp|cp|pp)")
    axis2 = "model" if layout == "tp" else (
        "context" if layout == "cp" else "pipe"
    )
    if layout == "tp":
        tp.validate_tp_degree(cfg.n_heads, cfg.kv_heads, tp_size)
    elif layout == "cp" and seq_len % tp_size:
        raise ValueError(
            f"context parallelism needs seq_len {seq_len} divisible "
            f"by the ring degree {tp_size}"
        )
    elif layout == "pp" and cfg.n_layers % tp_size:
        raise ValueError(
            f"pipeline needs n_layers {cfg.n_layers} divisible by "
            f"the stage count {tp_size}"
        )
    if grad_accum < 1 or global_batch % grad_accum or (
        (global_batch // grad_accum) % dp
    ):
        raise ValueError(
            f"grad_accum {grad_accum} must divide global_batch "
            f"{global_batch} into microbatches divisible by dp {dp}"
        )

    # Decode-config KV-cache term (``kv_slots > 0``): what a serving
    # engine co-resident with this config would preallocate
    # (serve/engine.py). Sharded like the engine shards it -- slots over
    # data, KV heads over the model axis -- when the extents divide;
    # otherwise that dimension is replicated.
    kv_bytes_chip = 0
    if kv_slots:
        full = kv_cache_bytes(cfg, kv_slots, kv_seq_len, kv_cache_dtype)
        denom = 1
        if dp > 1 and kv_slots % dp == 0:
            denom *= dp
        if layout == "tp" and tp_size > 1 \
                and cfg.kv_heads % tp_size == 0:
            denom *= tp_size
        kv_bytes_chip = -(-full // denom)

    # Paged pool term (``kv_blocks > 0``): what the paged engine
    # (serve/paging.py) would provision instead of the slab. Sharded as
    # the pool is: KV heads over the model axis when they divide; the
    # block dim replicates over data.
    kv_block_bytes_chip = 0
    if kv_quant not in ("none", "int8"):
        raise ValueError(
            f"unknown kv_quant {kv_quant!r} (none|int8)"
        )
    if kv_quant == "int8" and not kv_blocks:
        raise ValueError(
            "kv_quant='int8' needs the paged pool term (kv_blocks > "
            "0): only paged pages quantize "
            "(kernels/paged_attention.py)"
        )
    if kv_blocks:
        if kv_block_size < 1:
            raise ValueError(
                f"kv_block_size {kv_block_size} must be >= 1"
            )
        full = kv_paged_bytes(
            cfg, kv_blocks, kv_block_size, kv_cache_dtype, kv_quant
        )
        denom = 1
        if layout == "tp" and tp_size > 1 \
                and cfg.kv_heads % tp_size == 0:
            denom *= tp_size
        kv_block_bytes_chip = -(-full // denom)

    # Host-tier term (``kv_host_blocks > 0``, serve/tier.py): the
    # host-DRAM buffers parked prefixes spill into. Full-width per
    # host, and host DRAM -- never part of the HBM verdict.
    kv_host_bytes = 0
    if kv_host_blocks:
        if not kv_blocks:
            raise ValueError(
                "a host KV tier needs the paged pool term too "
                "(kv_blocks > 0): the tier spills the paged pool's "
                "pages"
            )
        kv_host_bytes = kv_paged_bytes(
            cfg, kv_host_blocks, kv_block_size, kv_cache_dtype,
            kv_quant,
        )

    # Speculative-draft term (``draft_cfg``, serve/spec.py): the draft's
    # serving params (fp32, TP-sharded over the model axis where its
    # heads divide, else replicated) plus its mirrored paged KV pool
    # (same page COUNT as the target's, smaller pages).
    draft_params_chip = 0
    draft_kv_chip = 0
    draft_n_params = 0
    if draft_cfg is not None:
        if not kv_blocks:
            raise ValueError(
                "a speculative draft budget needs the paged pool "
                "term too (kv_blocks > 0): the draft's KV pool "
                "mirrors the target's pages"
            )
        draft_n_params = llama2.count_params(draft_cfg)
        tp_div = (
            tp_size
            if layout == "tp" and tp_size > 1
            and draft_cfg.n_heads % tp_size == 0 else 1
        )
        draft_params_chip = -(-draft_n_params * 4 // tp_div)
        full = kv_paged_bytes(
            draft_cfg, kv_blocks, kv_block_size, kv_cache_dtype,
            kv_quant,
        )
        kv_div = (
            tp_size
            if layout == "tp" and tp_size > 1
            and draft_cfg.kv_heads % tp_size == 0 else 1
        )
        draft_kv_chip = -(-full // kv_div)

    common = dict(
        cfg=cfg, dp=dp, tp_size=tp_size, global_batch=global_batch,
        seq_len=seq_len, hbm_gib=hbm_gib, n_params=llama2.count_params(cfg),
        grad_accum=grad_accum, moments_dtype=moments_dtype, layout=layout,
        attn=attn, kv_cache_bytes=kv_bytes_chip, kv_slots=kv_slots,
        kv_block_bytes=kv_block_bytes_chip, kv_blocks=kv_blocks,
        kv_block_size=kv_block_size if kv_blocks else 0,
        kv_quant=kv_quant if kv_blocks else "none",
        kv_host_blocks=kv_host_blocks, kv_host_bytes=kv_host_bytes,
        draft_n_params=draft_n_params, draft_param_bytes=draft_params_chip,
        draft_kv_block_bytes=draft_kv_chip,
    )
    if layout == "pp":
        # Stage-local params replicated over data (the PP x DP
        # composition the pipeline trainer runs), at the worst stage.
        f32 = 4
        mom = 2 if moments_dtype == "bfloat16" else 4
        p_stage = llama2.pp_worst_stage_params(cfg, tp_size)
        result = FitResult(
            param_bytes=p_stage * f32,
            grad_bytes=p_stage * f32,
            opt_bytes=p_stage * 2 * mom,
            act_bytes=activation_model_pp(
                cfg, dp, tp_size, global_batch, seq_len, grad_accum,
                pp_backward=pp_backward,
            ),
            **common,
        )
    else:
        params = meta_params(cfg)
        mesh_axes = {"data": dp, axis2: tp_size}
        if layout == "cp":
            # Long-context layout: pure FSDP over data (the context
            # axis carries activations, not params).
            specs = fsdp.param_pspecs(params, axis="data", axis_size=dp)
            act = activation_model_cp(
                cfg, dp, tp_size, global_batch, seq_len, grad_accum
            )
        else:
            specs = hybrid.hybrid_pspecs(params, tp.llama_rules(),
                                         data_size=dp)
            act = activation_model(
                cfg, dp, tp_size, global_batch, seq_len, grad_accum
            )
        param_bytes = tree_bytes_per_chip(params, specs, mesh_axes)
        grad_bytes = param_bytes  # each gradient has its param's layout
        if grad_accum > 1:
            # The fp32 gradient-sum carry coexists with each
            # microbatch's freshly computed gradient.
            act["grad_accum_sum_carry"] = grad_bytes
        result = FitResult(
            param_bytes=param_bytes, grad_bytes=grad_bytes,
            opt_bytes=adamw_state_bytes(params, specs, mesh_axes,
                                        moments_dtype),
            act_bytes=act, **common,
        )
    if not do_compile:
        return result
    return _measure_update(
        result, cfg, layout, dp, tp_size, global_batch, grad_accum, attn,
        moments_dtype, pp_backward, device)


def to_markdown(r: FitResult) -> str:
    cfg = r.cfg
    act_total = sum(r.act_bytes.values())
    chips = r.dp * r.tp_size
    size_b = f"{r.n_params/1e9:.0f}B"
    strategy = {
        "tp": "hybrid FSDPxTP(+SP)",
        "cp": "FSDP x ring-attention context parallel",
        "pp": "DP x pipeline (1F1B)",
    }[r.layout]
    axis2 = {"tp": "model", "cp": "context", "pp": "pipe"}[r.layout]
    lines = [
        f"# {size_b} shard/fit analysis -- Llama-2 {strategy} "
        f"on a {chips}-card (data={r.dp} x {axis2}={r.tp_size}) mesh",
        "",
        "Produced by `python -m tpu_hpc_torch.checks.fit`: the "
        "reference's hybrid FSDP x TP example run at full scale (its "
        "ModelArgs ladder), on H100 cards.",
        "",
        "## Configuration",
        "",
        f"- model: dim={cfg.dim}, layers={cfg.n_layers}, "
        f"heads={cfg.n_heads} (kv {cfg.kv_heads}), "
        f"ffn_hidden={cfg.ffn_hidden}, "
        f"vocab={cfg.vocab_size} -> **{r.n_params/1e9:.2f}B params**",
        f"- mesh: (data={r.dp}, {axis2}={r.tp_size}) = "
        f"{r.dp*r.tp_size} cards "
        + (
            "(FSDP over `data`, Megatron TP+SP over `model`)"
            if r.layout == "tp" else
            "(DP over `data`, stage-sharded layers over `pipe`: "
            f"each card holds {cfg.n_layers//r.tp_size} of "
            f"{cfg.n_layers} layers)"
            if r.layout == "pp" else
            "(FSDP over `data`, ring attention over `context`: "
            f"each card holds {r.seq_len//r.tp_size} of "
            f"{r.seq_len} tokens)"
        ),
        f"- batch: global {r.global_batch} sequences x {r.seq_len} "
        f"tokens (per-card batch {r.global_batch//r.dp}"
        + (
            f", {r.grad_accum}-way gradient accumulation -> per-card "
            f"microbatch {r.global_batch//r.dp//r.grad_accum}"
            if r.grad_accum > 1 else ""
        )
        + f"); remat={cfg.remat}, bf16 compute / fp32 params",
        "",
        "## Per-card HBM budget",
        "",
        "| Component | Bytes | GiB |",
        "|---|---|---|",
        f"| params (fp32, "
        + {"tp": "FSDPxTP-sharded", "cp": "FSDP-sharded",
           "pp": "stage-sharded, worst stage"}[r.layout] + ") "
        f"| {r.param_bytes:,} | "
        f"{r.param_bytes/GIB:.2f} |",
        f"| gradients (fp32, same layout) | {r.grad_bytes:,} | "
        f"{r.grad_bytes/GIB:.2f} |",
        f"| AdamW mu+nu ({'bf16' if r.moments_dtype == 'bfloat16' else 'fp32'}, "
        f"same layout) | {r.opt_bytes:,} | "
        f"{r.opt_bytes/GIB:.2f} |",
    ]
    for name, b in r.act_bytes.items():
        lines.append(f"| activations: {name} | {b:,} | {b/GIB:.2f} |")
    if r.kv_cache_bytes and not r.kv_blocks:
        lines.append(
            f"| KV cache (decode, {r.kv_slots} slots) | "
            f"{r.kv_cache_bytes:,} | {r.kv_cache_bytes/GIB:.2f} |"
        )
    if r.kv_blocks:
        quant_tag = (
            ", int8 + fp32 scales" if r.kv_quant == "int8" else ""
        )
        lines.append(
            f"| KV cache (paged, {r.kv_blocks} pages x "
            f"{r.kv_block_size} tok{quant_tag}) | "
            f"{r.kv_block_bytes:,} | {r.kv_block_bytes/GIB:.2f} |"
        )
    if r.draft_param_bytes:
        # The speculative-draft budget (serve/spec.py): params + the
        # mirrored paged pool. Landing here means a too-big draft
        # flips the verdict below to DOES NOT FIT -- the whole point.
        lines.append(
            f"| spec draft params ({r.draft_n_params/1e9:.2f}B, "
            f"fp32 serving layout) | {r.draft_param_bytes:,} | "
            f"{r.draft_param_bytes/GIB:.2f} |"
        )
        lines.append(
            f"| spec draft KV pool (mirrored {r.kv_blocks} pages) | "
            f"{r.draft_kv_block_bytes:,} | "
            f"{r.draft_kv_block_bytes/GIB:.2f} |"
        )
    kv_live = r.kv_block_bytes if r.kv_blocks else r.kv_cache_bytes
    lines += [
        f"| **total** | **{r.total_bytes:,}** | "
        f"**{r.total_bytes/GIB:.2f}** |",
        "",
        f"Against **{r.hbm_gib:.0f} GiB** HBM per card: "
        f"**{'FITS' if r.fits else 'DOES NOT FIT'}** "
        f"({r.total_bytes/ (r.hbm_gib*GIB) * 100:.1f}% of HBM; "
        f"static {r.static_bytes/GIB:.2f} GiB + activations "
        f"{act_total/GIB:.2f} GiB"
        + (
            f" + decode KV cache {kv_live/GIB:.2f} GiB"
            if kv_live else ""
        )
        + (
            f" + spec draft {(r.draft_param_bytes + r.draft_kv_block_bytes)/GIB:.2f} GiB"
            if r.draft_param_bytes else ""
        )
        + ").",
    ]
    if r.kv_blocks and r.kv_cache_bytes:
        # The fragmentation-headroom comparison: same traffic, two
        # cache disciplines, compared as LOGICAL capacity bytes --
        # per-chip numbers would mix different shardings (the slab
        # shards slots over data, the pool replicates per data
        # replica) and mislabel a correctly sized pool at dp > 1.
        # Reconstruct the unsharded totals from the
        # per-chip values and the denominators analyze() applied.
        tp_div = (
            r.tp_size
            if r.layout == "tp" and r.tp_size > 1
            and cfg.kv_heads % r.tp_size == 0 else 1
        )
        # Per DATA REPLICA: the slab's per-chip term already divides
        # by dp (slots shard over data) and tp; multiplying tp back
        # gives the replica's slab share. The pool IS per-replica by
        # construction, so the same multiply makes the two directly
        # comparable at every dp.
        slab_replica = r.kv_cache_bytes * tp_div
        paged_replica = r.kv_block_bytes * tp_div
        saved = slab_replica - paged_replica
        lines += [
            "",
            f"Fragmentation headroom (per data replica -- the slab "
            f"shards slots over data while each replica runs its own "
            f"pool, so raw per-chip numbers are not comparable): the "
            f"slab's replica share ({r.kv_slots} slots over "
            f"dp={r.dp}, worst-case length) pins {slab_replica:,} "
            f"bytes ({slab_replica/GIB:.2f} GiB); the paged pool "
            f"({r.kv_blocks} pages x {r.kv_block_size} tokens) holds "
            f"the same share in {paged_replica:,} bytes "
            f"({paged_replica/GIB:.2f} GiB) -- "
            + (
                f"**{saved:,} bytes ({saved/GIB:.2f} GiB) of "
                "slack/fragmentation reclaimed** for more concurrent "
                "requests at equal HBM."
                if saved >= 0 else
                f"**{-saved:,} bytes ({-saved/GIB:.2f} GiB) MORE** "
                "than the slab share -- this pool out-provisions the "
                "mix; shrink --kv-blocks."
            ),
        ]
    if r.kv_blocks and r.kv_quant == "int8":
        # The quantized-capacity line (kernels/paged_attention.py): int8 pages + per-page fp32 scales vs the same
        # page count at bf16 -- the multiplier is how many MORE
        # resident tokens the same HBM seats, the number --kv-quant
        # exists to print. Full-pod bytes on both sides (one
        # sharding), so the ratio is sharding-independent.
        q_full = kv_paged_bytes(
            cfg, r.kv_blocks, r.kv_block_size, kv_quant="int8"
        )
        fp_full = kv_paged_bytes(
            cfg, r.kv_blocks, r.kv_block_size, "bfloat16"
        )
        q_pages_equal_hbm = fp_full * r.kv_blocks // q_full
        lines += [
            "",
            f"Quantized KV capacity (int8 pages + per-page fp32 "
            f"scales): the {r.kv_blocks:,}-page pool stores "
            f"{q_full:,} bytes ({q_full/GIB:.2f} GiB) vs {fp_full:,} "
            f"bytes ({fp_full/GIB:.2f} GiB) at bf16 -- the bf16 "
            f"pool's HBM seats **{q_pages_equal_hbm:,} int8 pages, "
            f"{fp_full/q_full:.1f}x the resident context at equal "
            f"HBM**.",
        ]
    if r.kv_host_blocks:
        # The tier's sizing line: host DRAM buys parked-session KV
        # capacity at ZERO HBM cost, so the multiplier is the page
        # ratio (minus each pool's scratch slot). This is the number
        # --kv-host-tier exists to print: how many more idle sessions
        # stay resident (return visits prefetch their prefix back
        # instead of re-prefilling) at the same device pool.
        dev_pages = max(r.kv_blocks - 1, 1)
        host_pages = max(r.kv_host_blocks - 1, 0)
        mult = (dev_pages + host_pages) / dev_pages
        lines += [
            "",
            f"Host KV tier (serve/tier.py): {r.kv_host_blocks} host "
            f"slots x {r.kv_block_size} tokens = "
            f"{r.kv_host_bytes:,} bytes ({r.kv_host_bytes/GIB:.2f} "
            f"GiB) of host DRAM per host -- NOT in the HBM total "
            f"above. Parked-session KV capacity: {dev_pages:,} "
            f"device pages HBM-only vs {dev_pages + host_pages:,} "
            f"pages with the tier -- **{mult:.1f}x the resident "
            f"sessions** at equal HBM.",
        ]
    lines += [
        "",
        "Static accounting is exact (the port's Llama on the meta "
        "device + the spec-tree plan; the AdamW count is a host int); "
        "the activation rows are the analytic model described "
        + {
            "tp": "in `tpu_hpc_torch/checks/fit.py:activation_model` "
            "(remat-per-block, SP-sharded residual checkpoints, flash "
            "attention).",
            "cp": "in `tpu_hpc_torch/checks/fit.py:activation_model_cp` "
            "(remat-per-block, context-sharded residual stream, "
            "double-buffered KV ring, full-width FFN/vocab).",
            "pp": "in `tpu_hpc_torch/checks/fit.py:activation_model_pp` "
            "(1F1B: up to `stages` in-flight microbatches of stage "
            "checkpoints, backward remat, full seq/card).",
        }[r.layout],
    ]
    if r.compiled:
        lines += [
            "",
            "## Evidence from one real update",
            "",
            f"The port's Trainer ran one update at the "
            f"{r.dp}x{r.tp_size} layout in {r.compile_seconds:.1f}s "
            f"(kernel builds included; backend: **{r.compile_backend}**; "
            f"attention path: {r.attn}).",
        ]
        if r.measured_peak_bytes is not None:
            lines += [
                "",
                f"Measured peak device memory of the update "
                f"(max_memory_allocated less the "
                f"{r.measured_baseline_bytes:,} bytes held before it): "
                f"{r.measured_peak_bytes:,} bytes "
                f"({r.measured_peak_bytes/GIB:.2f} GiB) against the "
                f"analytic total's {r.total_bytes/GIB:.2f} GiB.",
            ]
        lines += [
            "",
            "Collectives the update issued (torch.profiler, "
            "checks/collectives.py):",
            "",
            "| op | count |",
            "|---|---|",
        ]
        for op, n in r.collectives.items():
            lines.append(f"| {op} | {n} |")
    return "\n".join(lines) + "\n"


# (model preset, dp, tp, grad_accum): the reference's planning ladder (docs/guide/11_choosing_a_strategy.md:
# 109-127, "7B: TP4xFSDP4 ... 70B: TP4xFSDP20"). TP stays within the
# head-divisibility limits; chips = dp*tp; per-chip batch 8 at seq
# 4096 (the REPORT_7b_v4-32.md working configuration).
_TABLE_ROWS = (
    ("7b", 2, 4, 1),     # 8 chips: the minimal-footprint 7B config
    ("7b", 4, 8, 1),     # v4-32, the north star (REPORT_7b_v4-32.md)
    ("13b", 4, 4, 1),    # 16 chips
    ("13b", 8, 8, 1),    # 64 chips, roomy
    ("70b", 8, 8, 1),    # 64 chips: minimal 70B footprint
    ("70b", 16, 8, 1),   # 128 chips (v4-256 class)
)


def sizing_table(
    seq_len: int = 4096, hbm_gib: Optional[float] = None
) -> str:
    """Computed (not hand-waved) strategy ladder: for each row the
    analytic shard/fit analysis runs at per-chip batch 8 (the
    REPORT_7b_v4-32.md working configuration), and the table records
    the verdict against ``hbm_gib``. Regenerate
    docs/guide/11_choosing_a_strategy.md with
    ``python -m tpu_hpc_torch.checks.fit --table``."""
    hbm_gib = _default_hbm_gib() if hbm_gib is None else hbm_gib
    lines = [
        "| Model | params | chips | mesh | per-chip state | "
        f"per-chip total | fits {hbm_gib:.0f} GiB? |",
        "|---|---|---|---|---|---|---|",
    ]
    for name, dp, tp_size, accum in _TABLE_ROWS:
        cfg = dataclasses.replace(
            llama2.PRESETS[name], max_seq_len=seq_len
        )
        r = analyze(
            cfg=cfg, dp=dp, tp_size=tp_size,
            global_batch=8 * dp * accum, seq_len=seq_len,
            hbm_gib=hbm_gib, do_compile=False, grad_accum=accum,
        )
        mesh = f"`{{data: {dp}, model: {tp_size}}}`" + (
            f" + accum {accum}" if accum > 1 else ""
        )
        lines.append(
            f"| {name} | {r.n_params/1e9:.1f}B | {dp*tp_size} | {mesh} "
            f"| {r.static_bytes/GIB:.1f} GiB | {r.total_bytes/GIB:.1f} "
            f"GiB | {'yes' if r.fits else 'NO'} |"
        )
    return "\n".join(lines)


def main(argv=None) -> int:
    import sys

    if argv is None:
        argv = sys.argv[1:]
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--dp", type=int, default=4)
    parser.add_argument("--tp", type=int, default=8)
    parser.add_argument("--cp", type=int, default=0,
                        help="context-parallel ring degree: switches "
                        "to the long-context layout (FSDP over data x "
                        "ring attention over context; no TP) and "
                        "replaces --tp as the second mesh axis")
    parser.add_argument("--pp", type=int, default=0,
                        help="pipeline stage count: switches to the "
                        "PP x DP layout (stage-sharded params, "
                        "--grad-accum = microbatch count); the compile "
                        "pass runs one real update of the stage-split "
                        "Llama 1F1B pipeline (models/llama_pp.py)")
    parser.add_argument("--global-batch", type=int, default=8)
    parser.add_argument("--seq-len", type=int, default=4096)
    parser.add_argument("--hbm-gib", type=float, default=None,
                        help="HBM per card (default: the h100-sxm row "
                        "of checks/roofline.py's card table)")
    parser.add_argument("--layers", type=int, default=None,
                        help="override n_layers (default: 7B's 32)")
    parser.add_argument("--dim", type=int, default=None,
                        help="override model dim (with --heads/"
                        "--vocab, analyzes arbitrary architectures, "
                        "e.g. the bench model: --dim 1024 --layers 8 "
                        "--heads 8)")
    parser.add_argument("--heads", type=int, default=None)
    parser.add_argument("--kv-heads", type=int, default=None)
    parser.add_argument("--vocab", type=int, default=None)
    parser.add_argument("--grad-accum", type=int, default=1,
                        help="analyze the N-way accumulated step")
    parser.add_argument("--model", type=str, default=None,
                        choices=sorted(llama2.PRESETS),
                        help="model preset (default: 7B)")
    parser.add_argument("--table", action="store_true",
                        help="print the computed 7B..70B sizing table "
                        "(analytic only, no compile) and exit")
    parser.add_argument("--no-compile", action="store_true",
                        help="analytic report only: skip the one real "
                        "update")
    parser.add_argument("--device", choices=("cuda", "cpu"),
                        default="cuda",
                        help="where the update runs: the card(s) "
                        "(default; one process per card of the layout) "
                        "or a gloo world of at most 4 CPU ranks")
    parser.add_argument("--markdown", type=str, default=None,
                        help="write the report to this path")
    parser.add_argument("--json", action="store_true",
                        help="print one JSON line instead of the report")
    parser.add_argument("--tpu-topology", type=str, default=None,
                        help="refused: the JAX package's virtual-TPU "
                        "compile has no counterpart here")
    parser.add_argument("--attn", choices=ATTN_PATHS, default="flash",
                        help="attention path of the update: 'flash' = "
                        "the Hopper kernels (heads on the TP axis; under "
                        "--cp inside the KV ring), 'reference' = the "
                        "model's einsum path")
    parser.add_argument("--moments-dtype",
                        choices=("float32", "bfloat16"),
                        default="float32",
                        help="AdamW moment storage dtype; bfloat16 "
                        "halves optimizer-state HBM")
    parser.add_argument("--pp-backward", choices=("remat", "stash"),
                        default="remat",
                        help="1f1b backward for --pp accounting: remat "
                        "saves stage inputs only; stash adds the vjp-"
                        "residual buffers (Megatron-style) to the HBM "
                        "model")
    parser.add_argument("--kv-slots", type=int, default=0,
                        help="add a decode-config KV-cache term: "
                        "batch slots of a co-resident serving engine "
                        "(0 = no serving, the training-only budget)")
    parser.add_argument("--kv-seq-len", type=int, default=None,
                        help="KV-cache capacity per slot "
                        "(default: the model's max_seq_len)")
    parser.add_argument("--kv-cache-dtype",
                        choices=("bfloat16", "float32"),
                        default="bfloat16",
                        help="KV-cache storage dtype")
    parser.add_argument("--kv-blocks", type=int, default=0,
                        help="add a PAGED decode KV-cache term "
                        "instead of the slab: physical pages of a "
                        "co-resident paged serving engine "
                        "(serve/paging.py); with --kv-slots "
                        "also given, the report adds the "
                        "fragmentation-headroom comparison line")
    parser.add_argument("--kv-block-size", type=int, default=16,
                        help="tokens per page for --kv-blocks "
                        "(default 16)")
    parser.add_argument("--kv-quant", choices=("none", "int8"),
                        default=None,
                        help="paged page storage "
                        "(kernels/paged_attention.py): 'int8' "
                        "budgets 1-byte pages + per-page fp32 scales "
                        "-- about half the pool bytes, ~2x the "
                        "resident context at equal HBM; the report "
                        "adds the quantized-capacity line (requires "
                        "--kv-blocks)")
    parser.add_argument("--kv-host-tier", type=int, default=0,
                        metavar="N",
                        help="budget a host-DRAM KV page tier "
                        "(serve/tier.py): N host slots incl. scratch "
                        "that parked session prefixes spill into; "
                        "reported as host DRAM next to the HBM "
                        "verdict with the resident-sessions "
                        "multiplier (requires --kv-blocks)")
    parser.add_argument("--spec-draft", type=str, default=None,
                        choices=("half", *sorted(llama2.PRESETS)),
                        help="budget a speculative-decode draft model "
                        "(serve/spec.py) co-resident with this "
                        "config: its fp32 serving params + a KV pool "
                        "mirroring --kv-blocks. 'half' = the target "
                        "at half depth (the dev default); a draft "
                        "that does not fit fails this report instead "
                        "of OOMing at serving bring-up (requires "
                        "--kv-blocks)")
    parser.add_argument("--xla-opt", action="append", default=[],
                        metavar="KEY=VALUE",
                        help="refused: XLA compiler options have no "
                        "counterpart here")
    args = parser.parse_args(argv)
    if args.tpu_topology is not None:
        parser.error("--tpu-topology names the JAX package's virtual-TPU "
                     "compile, which has no counterpart here: the update "
                     "runs on the card(s) or a CPU gloo world (--device)")
    if args.xla_opt:
        parser.error("--xla-opt passes XLA compiler options, which have "
                     "no counterpart in the PyTorch port")

    if args.table:
        print(sizing_table(seq_len=args.seq_len, hbm_gib=args.hbm_gib))
        return 0
    if args.pp and args.cp:
        parser.error("--pp and --cp are mutually exclusive")

    if args.model is not None:
        cfg = dataclasses.replace(
            llama2.PRESETS[args.model], max_seq_len=args.seq_len
        )
    else:
        cfg = llama2.LlamaConfig(max_seq_len=args.seq_len, remat=True)
    overrides = {
        k: v for k, v in (
            ("n_layers", args.layers), ("dim", args.dim),
            ("n_heads", args.heads), ("n_kv_heads", args.kv_heads),
            ("vocab_size", args.vocab),
        ) if v is not None
    }
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    if args.kv_host_tier and not args.kv_blocks:
        parser.error(
            "--kv-host-tier needs --kv-blocks: the tier spills the "
            "paged pool's pages"
        )
    if args.kv_quant is not None and not args.kv_blocks:
        parser.error(
            "--kv-quant needs --kv-blocks: only paged pages quantize "
            "(kernels/paged_attention.py)"
        )
    draft_cfg = None
    if args.spec_draft is not None:
        if not args.kv_blocks:
            parser.error(
                "--spec-draft needs --kv-blocks: the draft's KV pool "
                "mirrors the target's paged pool"
            )
        if args.spec_draft == "half":
            from tpu_hpc_torch.serve.spec import default_draft_config

            draft_cfg = default_draft_config(cfg)
        else:
            draft_cfg = dataclasses.replace(
                llama2.PRESETS[args.spec_draft],
                max_seq_len=args.seq_len,
            )
    r = analyze(
        cfg=cfg, dp=args.dp, tp_size=args.pp or args.cp or args.tp,
        global_batch=args.global_batch, seq_len=args.seq_len,
        hbm_gib=args.hbm_gib, do_compile=not args.no_compile,
        grad_accum=args.grad_accum, attn=args.attn,
        moments_dtype=args.moments_dtype,
        layout="pp" if args.pp else ("cp" if args.cp else "tp"),
        pp_backward=args.pp_backward,
        kv_slots=args.kv_slots,
        kv_seq_len=args.kv_seq_len,
        kv_cache_dtype=args.kv_cache_dtype,
        kv_blocks=args.kv_blocks,
        kv_block_size=args.kv_block_size,
        kv_quant=args.kv_quant or "none",
        kv_host_blocks=args.kv_host_tier,
        draft_cfg=draft_cfg,
        device=args.device,
    )
    md = to_markdown(r)
    if args.markdown:
        with open(args.markdown, "w") as f:
            f.write(md)
    if args.json:
        print(json.dumps(r.to_json()))
    else:
        print(md)
    return 0 if r.fits else 1


if __name__ == "__main__":
    import sys

    sys.exit(main())
