"""`python -m tpu_hpc_torch.train` -- the bench Llama's training run.

Port of the JAX package's ``bench.py --workload llama``
(``bench_llama``): the bench architecture (``bench_model_cfg``: dim
1024, 8 layers, 8 heads, head_dim 128, vocab 32000, seq 2048, ~168M
params, bf16 compute, fp32 params) trained with AdamW (lr 3e-4, weight
decay 0.1) on the synthetic ``TokenStream``, with bench.py's CLI
defaults: microbatch 4 accumulated 8 times (a batch of 32 sequences,
65,536 tokens per update and data rank), attention through
``parallel.tp.make_tp_flash_attn_fn`` -> the flash kernels. Epoch 0
absorbs the kernel build and warm-up; the last epoch is measured.

Under ``torchrun`` (or another launcher ``runtime.get_host_info``
knows) every process joins the job's process group (NCCL on cards,
gloo with ``--device cpu``) and the run takes a (data, model) mesh:
``--data`` / ``--model``, or ``tp.auto_mesh_axes(world, heads,
kv_heads, cap=4)``. The plan follows bench.py (:256-273): hybrid FSDP x
TP with SP when ``model`` > 1, FSDP when only ``data`` > 1, none at one
process. For example, a 2 x 2 world on the CPU:

    torchrun --nproc-per-node 4 -m tpu_hpc_torch.train --device cpu \
        --data 2 --model 2 --dim 64 --n-layers 2 --n-heads 4 --vocab 128 \
        --multiple-of 16 --seq-len 32 --steps 2 --epochs 1 --batch 4 \
        --grad-accum-steps 2

Sequence parallelism (bench.py ``--workload llama-sp``,
``bench_llama_sp``): ``--sp-mode ring|zigzag|ulysses`` trains over a
(data, context) mesh, by default context = every process and data 1, as
bench.py does (``--context N`` for another split). Each context rank
runs the model on its shard of each sequence, RoPE at the shard's global
positions; attention is the contiguous ring, the zigzag ring (the stream
laid out in zigzag order, ``TokenStream(zigzag_ring=n)``) or Ulysses,
each around the flash kernels; FSDP2 runs over data x context. For
example:

    torchrun --nproc-per-node 4 -m tpu_hpc_torch.train --sp-mode zigzag \
        --context 4

``--sp-mode`` with ``--model`` above 1 is refused: the JAX bench never
combines TP and context parallelism, and neither does the port yet.

Pipeline parallelism (bench.py ``--workload llama-pp``,
``bench_llama_pp``): any ``--pp-*`` flag trains the pipelined model over
a ``{"pipe": S}`` mesh, or ``{"data": d, "pipe": S}`` with ``--data d``
(S = the world over d; one process runs one stage). ``--pp-schedule``
gpipe|1f1b|interleaved|interleaved-1f1b (default 1f1b), ``--pp-model``
stack (the bench's PipelineTransformer at the bench width: vocab 32000,
dim 1024, 8 heads, 8 layers, seq 2048, bf16 compute, fp32 params) or
llama (the bench Llama, stage-split), ``--pp-backward`` remat|stash (the
1F1B schedules' backward), ``--pp-microbatches`` M (default 8) of
``--pp-microbatch-size`` rows (default 4): the global batch is M x that,
each microbatch's rows split over the data ranks. The interleaved
schedules take 2 chunks a stage when S > 1 and the depth divides into
2S stages; gpipe and interleaved checkpoint each stage
(``remat_stage``). The flash kernels run inside every stage. For
example, on the CPU:

    torchrun --nproc-per-node 4 -m tpu_hpc_torch.train --device cpu \
        --pp-schedule 1f1b --dim 64 --n-layers 4 --n-heads 4 --vocab 128 \
        --seq-len 32 --steps 2 --epochs 1 --pp-microbatches 4 \
        --pp-microbatch-size 2

A pipe axis with ``--model`` above 1 and ``--pp-*`` with ``--sp-mode``
are refused: the JAX bench composes neither.

``--pp-runtime mpmd --pp-schedule gpipe`` is bench.py's MPMD row
(``bench_llama_pp_mpmd``): the per-stage runtime of
``parallel/mpmd.py`` in one process, one stage per visible card (one
stage on the CPU; ``run_mpmd(devices=...)`` takes any list), the
stack model or ``--pp-model llama`` cut by ``mpmd_bundle``, SGD with
momentum at lr 3e-4, ``--steps`` timed steps after one warm step.
``TPU_HPC_FAULTS`` arms its stage faults (``stage_kill_at=1:2``,
``stage_nan_at``, ``stage_straggler``, the slice keys), recovered
stage-locally; a stage that exhausts its budget exits with the code
the supervisor accounts (1, or 77 for the rollback class). It refuses
what bench.py refuses, in its words: another workload (a vision
``--workload``, ``--sp-mode``, ``--comm-mode``), a schedule other than
an explicit gpipe, and ``--pp-backward stash``; and a launch of more
than one process and the flags it does not consume: ``--guard-mode``,
``--checkpoint-dir``, ``--grad-accum-steps``, ``--batch``, ``--epochs``,
``--moments-dtype``, ``--comm-table`` and ``--supervise``. The record is
bench.py's (``pp_mpmd[-llama][-chaos]_tokens_per_s_per_chip`` with
``bubble_fraction``, ``recovery_mttr_s``, ``stage_restarts``,
``stage_rollbacks``, ``redispatched``, ``recompiles``, ``wire_mb``)
with the port's losses, ``update_s``, peak memory and flash launches.
For example, on one card and on the CPU:

    python -m tpu_hpc_torch.train --pp-runtime mpmd --pp-schedule gpipe
    python -m tpu_hpc_torch.train --device cpu --pp-runtime mpmd \
        --pp-schedule gpipe --dim 32 --n-layers 2 --n-heads 2 --vocab 64 \
        --seq-len 16 --steps 2 --pp-microbatches 4 --pp-microbatch-size 2

Gradient sync (bench.py ``--comm-mode``, its row "llama dp
bucketed-overlap sync"): ``--comm-mode bucketed_overlap`` trains the
DDP way -- the whole world is one ``data`` axis (``comm_mode_mesh``),
params replicated on every rank (``dp.param_pspecs``), the batch split
over the ranks, and each rank's gradient all-reduced in buckets of
``comm_bucket_mb`` (25 MB) launched as the backward produces them
(``comm.overlap.GradSync``). ``hierarchical`` takes a two-tier (dcn x
data) mesh (``runtime.mesh.two_tier_spec``: dcn the node count, or an
emulated 2 on one node) and reduces each bucket in two phases; it is
refused where no such split exists (one card), in bench.py's words.
``auto`` asks the collective planner (``comm.planner``, the cost table
of this topology in ``$TPU_HPC_COMM_TABLES`` or ``--comm-table``, else
the H100 fabric's spec-sheet model) for the mode and bucket size before
the mesh is built. A manual mode on one process runs on a one-rank
world (``data: 1``, bench.py's shape on one chip); it never trains
without a process group. For example, on four cards:

    torchrun --nproc-per-node 4 -m tpu_hpc_torch.train \
        --comm-mode bucketed_overlap

Workloads (``--workload``, default ``llama``): ``elastic`` is bench.py's
preemption-storm row (``train/elastic.py``: the topology coordinator
shrinks the rank pool at ``--elastic-shrink-at`` and grows it back at
``--elastic-grow-at``, no process restarting; ``--steps`` updates);
``llama-long`` is
bench.py's long-context row (``bench_llama_long``: the bench Llama at
seq 8192, microbatch 1 accumulated 8 times, metric
``llama2_seq8192_tokens_per_s_per_chip``); ``unet`` (bench.py's "unet
ddp" row), ``vit``, ``resnet`` and ``domain-unet`` are the vision and
weather workloads of ``train/vision.py`` (see there), sized by
``--lat``/``--lon``/``--channels``/``--base-features``/``--spatial``
(grids and U-Nets) and ``--dim``/``--n-layers``/``--n-heads`` (the
ViT); they refuse the
gradient-sync modes, ``--pp-*``, ``--sp-mode``/``--context`` and
``--model`` (but the ViT's, tensor parallel by ``tp.vit_rules``). For
example, the U-Net row on one card, or on the CPU at a tiny size:

    python -m tpu_hpc_torch.train --workload unet
    python -m tpu_hpc_torch.train --workload unet --device cpu --lat 19 \
        --lon 12 --channels 3 --base-features 4 --batch 2 --steps 2 \
        --epochs 1

Rank 0 prints one JSON line: the device's name and the world size, the
mesh and plan, tokens/s (the whole job's, and per device), MFU against
the world's peak from ``checks/roofline.py`` (bench.py's formula:
tokens/s x ``flops_per_token(seq)`` / (peak x world)), the loss of every
update, the three flash kernels' launch counts and tile rows (null on
the CPU, where no kernel runs), and the peak device memory; a pipeline
run adds its schedule, ``n_chunks`` and ``bubble_fraction``, under the
metric ``pp_{schedule}{-stash}{-llama}_tokens_per_s_per_chip``.
``--device cpu`` with the model-size flags rehearses the run at a tiny
size (the kernels' plain versions; no launches). Without ``--device
cpu`` on a machine with no card it is an argparse error naming the
missing device.

Training that survives (the JAX ``bench.py --guard-mode skip
--supervise N``): ``--checkpoint-dir D --save-every 1`` checkpoints
every epoch through ``torch.distributed.checkpoint`` and resumes from
D's newest readable step; ``--guard-mode skip`` drops a poisoned update
on the device, ``rollback`` (with ``--checkpoint-dir``) exits 77 for a
relaunch from the last good checkpoint; a SIGTERM snapshots and exits
75. Under the supervisor a relaunch picks the run up again:

    python -m tpu_hpc_torch.resilience.supervisor --max-restarts 2 -- \
        python -m tpu_hpc_torch.train --guard-mode skip \
        --checkpoint-dir D --save-every 1

(``--supervise N`` wraps the one-process run the same way.) The exit
code is 0, 75 (preempted) or 77 (rolled back).

A real corpus (the JAX package's ``train_llama_hybrid.py --tokens-file``):
``--tokens-file PATH`` trains the llama workloads from a pretokenized
corpus through the C++ reader (``native.NativeTokenDataset``: mmap'd,
epoch-shuffled windows of seq_len + 1 tokens, prefetched by native
threads) in place of the synthetic ``TokenStream``. A corpus whose
largest id does not fit the vocabulary is refused. The JSON line then
carries ``corpus``: its tokens, windows, largest id, and the windows
the run took from it. For example:

    python -m tpu_hpc_torch.native.prepare README.md docs/*.md \
        --out build/corpus.bin
    python -m tpu_hpc_torch.train --tokens-file build/corpus.bin
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys
from typing import Optional, Sequence

import torch

from tpu_hpc_torch.models import llama2


def bench_model_cfg(seq_len: int = 2048, remat: bool = False,
                    **overrides) -> llama2.LlamaConfig:
    """THE bench architecture (bench.py:93-103); ``overrides`` shrink it
    for a CPU rehearsal."""
    fields = dict(dim=1024, n_layers=8, n_heads=8, vocab_size=32000,
                  multiple_of=256, max_seq_len=seq_len, remat=remat)
    fields.update({k: v for k, v in overrides.items() if v is not None})
    return llama2.LlamaConfig(**fields)


def resolve_batch_accum(batch, accum, microbatch: int = 4):
    """bench.py's policy: with no --batch, the measured-best microbatch
    accumulated 8x; with an explicit --batch and no --grad-accum-steps,
    unaccumulated."""
    if batch is None:
        accum = 8 if accum is None else accum
        return microbatch * max(accum, 1), accum
    return batch, 1 if accum is None else accum


# bench.py:278-292: the bench's optimizer; seed 0 for init and data.
LEARNING_RATE, WEIGHT_DECAY, SEED = 3e-4, 0.1, 0


WORKLOADS = ("llama", "llama-long", "unet", "vit", "resnet", "domain-unet",
             "elastic")
VISION_WORKLOADS = ("unet", "vit", "resnet", "domain-unet")
VISION_FLAGS = ("lat", "lon", "channels", "base_features", "spatial",
                "eval_steps")
PLANS = ("auto", "hybrid", "fsdp", "dp", "none")
COMM_MODES = ("flat", "hierarchical", "bucketed_overlap", "auto")
MANUAL_COMM_MODES = ("hierarchical", "bucketed_overlap")
SP_MODES = ("ring", "zigzag", "ulysses")


class CorpusRefused(ValueError):
    """A ``--tokens-file`` the run cannot train from."""


def token_corpus(path: str, model_cfg: llama2.LlamaConfig,
                 global_batch: int):
    """The run's ``NativeTokenDataset`` over ``path`` (seed 0, windows of
    ``model_cfg.max_seq_len``); :class:`CorpusRefused` when it cannot be
    read or holds an id the model's vocabulary does not (the JAX
    example's check of the header's largest id)."""
    from tpu_hpc_torch.native import NativeTokenDataset
    try:
        ds = NativeTokenDataset(path, global_batch, model_cfg.max_seq_len,
                                seed=SEED)
    except (OSError, ValueError) as e:
        raise CorpusRefused(f"corpus {path}: {e}") from e
    if ds.max_token_id >= model_cfg.vocab_size:
        ds.close()
        raise CorpusRefused(
            f"corpus {path} has token id {ds.max_token_id} >= vocab_size "
            f"{model_cfg.vocab_size}: the model cannot embed it")
    return ds


def resolve_plan(plan: str, mesh, sp_mode: Optional[str] = None,
                 comm_mode: str = "flat") -> str:
    """bench.py's rule (bench.py:256-273) for ``plan="auto"``: hybrid
    FSDP x TP + SP when the mesh has a ``model`` axis above one device,
    FSDP when only ``data`` is above one, none at one device. With
    ``sp_mode``: FSDP over data x context whenever there is a mesh
    (context ranks must exchange gradients); TP is refused. Under a
    manual ``comm_mode`` (resolved): "dp", the replicated params of the
    DDP recipe (another plan is kept, for the trainer to refuse)."""
    from tpu_hpc_torch.runtime.mesh import mesh_axis_size

    if plan not in PLANS:
        raise ValueError(f"unknown plan {plan!r}; one of {PLANS}")
    if comm_mode in MANUAL_COMM_MODES:
        return "dp" if plan == "auto" else plan
    if sp_mode is not None:
        if sp_mode not in SP_MODES:
            raise ValueError(
                f"unknown sp_mode {sp_mode!r} (ring|zigzag|ulysses)")
        if plan == "hybrid" or mesh_axis_size(mesh, "model") > 1:
            raise ValueError(
                "sequence parallelism does not combine with TP (a model "
                "axis) yet: the JAX bench never combines them")
        if plan == "none" and mesh_axis_size(mesh, "context") > 1:
            raise ValueError(
                "plan 'none' on a context axis would leave each context "
                "rank with its own gradients; use 'fsdp'")
        if plan == "auto":
            return "none" if mesh is None else "fsdp"
        return plan
    if plan != "auto":
        return plan
    if mesh_axis_size(mesh, "model") > 1:
        return "hybrid"
    return "fsdp" if mesh_axis_size(mesh, "data") > 1 else "none"


def comm_mode_mesh(comm_mode: str, n_dev: int, n_slices: int = 1):
    """bench.py's ``comm_mode_mesh`` (bench.py:67-90): the mesh of a
    manual comm-mode run, ``(mesh_spec, batch_axes, dp_extent)``. The
    whole mesh is data parallelism; ``hierarchical`` needs the two
    tiers as separate axes (``runtime.mesh.two_tier_spec``, the shared
    policy), and a topology with no such split is refused naming the
    CLI lever."""
    from tpu_hpc_torch.runtime.mesh import MeshSpec, two_tier_spec

    if comm_mode == "hierarchical":
        try:
            spec = two_tier_spec(n_dev, n_slices, inner_axis="data")
        except ValueError as e:
            raise ValueError(
                f"--comm-mode hierarchical: {e} -- use "
                "bucketed_overlap or flat on this topology"
            ) from None
        return spec, ("dcn", "data"), n_dev
    return MeshSpec(axes={"data": n_dev}), ("data",), n_dev


def param_bytes(model_cfg: llama2.LlamaConfig) -> int:
    """The gradient payload of ``model_cfg``: every param's bytes, from
    the tree's shapes (no tensor is made)."""
    return llama2.count_params(model_cfg) * torch.empty(
        (), dtype=model_cfg.param_dtype).element_size()


def resolve_comm_auto(model_cfg: llama2.LlamaConfig,
                      comm_table: Optional[str] = None,
                      bucket_cap_bytes: Optional[int] = None,
                      n_dev: Optional[int] = None,
                      device_type: Optional[str] = None):
    """bench.py's ``resolve_comm_auto`` (bench.py:106-154): the
    planner's gradient-sync decision for the exact gradient payload of
    ``model_cfg`` on this topology (``n_dev`` cards, default the world),
    before any mesh exists -- the resolved mode decides the mesh
    family. ``bucket_cap_bytes`` defaults to the config's
    comm_bucket_mb."""
    import torch.distributed as dist

    from tpu_hpc_torch.comm import planner as comm_planner
    from tpu_hpc_torch.config import TrainingConfig
    from tpu_hpc_torch.runtime.mesh import node_groups, two_tier_spec

    if bucket_cap_bytes is None:
        bucket_cap_bytes = TrainingConfig().comm_bucket_mb * 2 ** 20
    if n_dev is None:
        n_dev = dist.get_world_size() if dist.is_initialized() else 1
    n_slices = len(node_groups())
    try:
        two_tier_spec(n_dev, n_slices)
        two_tier_ok = True
    except ValueError:
        two_tier_ok = False
    table = comm_planner.load_table(comm_table) if comm_table else None
    return comm_planner.Planner.for_devices(
        table=table, device_type=device_type, n_devices=n_dev,
    ).plan_grad_sync(
        param_bytes(model_cfg), two_tier=two_tier_ok,
        bucket_cap_bytes=bucket_cap_bytes,
    )


def sp_attention(sp_mode: str, mesh, model_cfg: llama2.LlamaConfig,
                 device):
    """bench.py's llama-sp wiring (bench.py:371-390): the attention hook
    for ``sp_mode`` over ``mesh``'s context axis, this rank's global
    RoPE positions, and the stream's ``zigzag_ring`` (zigzag only: the
    loader lays the tokens out once, no per-layer permute)."""
    from tpu_hpc_torch.parallel import ring_attention as ra
    from tpu_hpc_torch.parallel import sp_ulysses

    ring = ra.context_ring(mesh)
    n, rank = ring.n, ring.ranks[0]
    zigzag = sp_mode == "zigzag"
    if sp_mode == "ulysses":
        sp_ulysses.validate_ulysses_degree(model_cfg.n_heads, n)
        attn_fn = sp_ulysses.make_ulysses_attn_fn(mesh)
    elif zigzag:
        attn_fn = ra.make_zigzag_ring_attn_fn(mesh, data_layout="zigzag")
    elif sp_mode == "ring":
        attn_fn = ra.make_ring_attn_fn(mesh)
    else:
        raise ValueError(f"unknown sp_mode {sp_mode!r} (ring|zigzag|ulysses)")
    positions = ra.shard_positions(n, rank, model_cfg.max_seq_len, zigzag,
                                   device)
    return attn_fn, positions, (n if zigzag else None)


PP_SCHEDULES = ("gpipe", "1f1b", "interleaved", "interleaved-1f1b")


@dataclasses.dataclass(frozen=True)
class PipeArgs:
    """bench.py's ``bench_llama_pp`` knobs (its CLI defaults)."""

    schedule: str = "1f1b"
    model: str = "stack"
    backward: str = "remat"
    microbatches: int = 8
    microbatch_size: int = 4

    def metric(self) -> str:
        """bench.py's record name (bench.py:639-651)."""
        tag = (f"-{self.backward}" if self.schedule in (
            "1f1b", "interleaved-1f1b") and self.backward != "remat"
            else "") + ("-llama" if self.model == "llama" else "")
        return f"pp_{self.schedule}{tag}_tokens_per_s_per_chip"


def pp_chunks(schedule: str, n_stages: int, depth: int) -> int:
    """bench.py's rule (bench.py:530-535): 2 chunks a stage on the
    interleaved schedules when S > 1 and the depth divides into 2S
    stages, else 1."""
    if schedule in ("interleaved", "interleaved-1f1b") and n_stages > 1 \
            and depth % (2 * n_stages) == 0:
        return 2
    return 1


def pipe_model(model_cfg: llama2.LlamaConfig, args: PipeArgs, mesh, device,
               attn: str = "flash"):
    """bench_llama_pp's model (bench.py:521-623) over ``mesh``'s pipe
    axis (None: one stage in this process): ``(forward, params, specs,
    flops_cfg, n_chunks)``. ``model_cfg`` gives the width, depth,
    sequence and compute dtype: ``stack`` builds the PipelineTransformer
    from them, ``llama`` stage-splits the Llama itself. The stages'
    attention is the flash kernels (``blockwise_attention``,
    ``impl="auto"``) or, with ``attn="reference"``, the einsum path."""
    from tpu_hpc_torch.kernels.attention import blockwise_attention
    from tpu_hpc_torch.models import llama_pp
    from tpu_hpc_torch.models import pipeline_transformer as ptx
    from tpu_hpc_torch.parallel import pp
    from tpu_hpc_torch.parallel.plans import P
    from tpu_hpc_torch.parallel.pp_transport import InProcessPipe
    from tpu_hpc_torch.runtime.mesh import mesh_axis_size

    if args.schedule not in PP_SCHEDULES:
        raise ValueError(f"unknown pp schedule {args.schedule!r}")
    if args.model not in ("stack", "llama"):
        raise ValueError(f"unknown pp model {args.model!r} (stack|llama)")
    n_stages = mesh_axis_size(mesh, "pipe")
    depth = model_cfg.n_layers
    v = pp_chunks(args.schedule, n_stages, depth)
    # bench.py:565-573: the autodiff schedules checkpoint each stage.
    remat_stage = args.schedule in ("gpipe", "interleaved")
    names = mesh.mesh_dim_names if mesh is not None else ()
    kw = dict(schedule=args.schedule, backward=args.backward,
              batch_spec=P(None, "data") if "data" in names else P(),
              remat_stage=remat_stage, n_chunks=v)
    transport = mesh if mesh is not None else InProcessPipe(1)
    attn_fn = None
    if attn == "flash":
        def attn_fn(q, k, v_):
            return blockwise_attention(q, k, v_, causal=True)[0]
    gen = torch.Generator(device=device).manual_seed(SEED)
    if args.model == "llama":
        if depth % (n_stages * v):
            raise ValueError(
                f"llama pp needs n_layers {depth} divisible by stages "
                f"{n_stages} x chunks {v}")
        full = llama2.init_llama(gen, model_cfg, device)
        params = (llama_pp.split_params_interleaved(full, model_cfg,
                                                    n_stages, v)
                  if v > 1 else
                  llama_pp.split_params(full, model_cfg, n_stages))
        del full
        forward = llama_pp.make_forward(
            model_cfg, transport, args.microbatches, attn_fn=attn_fn, **kw)
        return (forward, params, llama_pp.pp_pspecs(params), model_cfg, v)
    pcfg = ptx.PipeConfig(
        vocab_size=model_cfg.vocab_size, dim=model_cfg.dim,
        n_heads=model_cfg.n_heads, n_stages=n_stages * v,
        layers_per_stage=max(depth // (n_stages * v), 1),
        max_seq_len=model_cfg.max_seq_len, dtype=model_cfg.dtype)
    params = ptx.init_pipeline_transformer(gen, pcfg, device)
    if v > 1:
        params["stages"] = pp.interleave_stacked(params["stages"], n_stages)
    forward = ptx.make_forward(pcfg, transport, args.microbatches,
                               attn_fn=attn_fn, **kw)
    return forward, params, ptx.pp_pspecs(params), pcfg, v


def build_trainer(
    model_cfg: llama2.LlamaConfig,
    *,
    steps: int = 20,
    epochs: int = 2,
    batch: int = 32,
    grad_accum_steps: int = 8,
    attn: str = "flash",
    moments_dtype: str = "float32",
    device="cuda",
    mesh=None,
    plan: str = "auto",
    guard_mode: str = "off",
    checkpoint_dir: Optional[str] = None,
    save_every: int = 0,
    resume: bool = True,
    metrics_path: str = "",
    sp_mode: Optional[str] = None,
    pp: Optional[PipeArgs] = None,
    comm_mode: str = "flat",
    comm_plan=None,
    train_overrides: Optional[dict] = None,
    tokens_file: Optional[str] = None,
):
    """The bench run's ``(Trainer, TokenStream)``: ``model_cfg`` from a
    seeded random init, bench.py's AdamW, attention through
    ``make_tp_flash_attn_fn`` (``attn="flash"``) or the model's einsum
    path (``"reference"``). :func:`run_train` fits it; ``chip_smoke.py``
    profiles one of its updates.

    ``guard_mode`` arms the numeric-health guard; ``checkpoint_dir``
    gives the trainer a ``CheckpointManager`` there (saves every
    ``save_every`` epochs, auto-resume unless ``resume`` is False);
    ``metrics_path`` is the run's JSONL log. A fault plan in
    ``$TPU_HPC_FAULTS`` is read when the trainer is built.

    ``mesh``: None (one device) or a ``DeviceMesh`` with ``data`` and/or
    ``model`` dims. ``plan`` (:func:`resolve_plan`): ``hybrid`` lays the
    params out by ``hybrid_pspecs(llama_rules)`` with SP on the residual
    stream and the flash kernels under ``local_map`` on local heads;
    ``fsdp`` by ``fsdp.param_pspecs``; ``none`` keeps one device.
    ``batch`` is each data rank's: the global batch is ``batch`` x the
    data axis, as in bench.py. ``sp_mode`` (ring, zigzag, ulysses):
    sequence parallelism over ``mesh``'s context axis
    (:func:`sp_attention`), the batch split ``P("data", "context")``.
    ``pp``: pipeline parallelism over ``mesh``'s pipe axis
    (:func:`pipe_model`; ``batch`` and ``plan`` are then unused: the
    global batch is ``pp.microbatches x pp.microbatch_size``, each
    microbatch's rows split over ``data``). ``comm_mode``: the
    trainer's gradient sync (``TrainingConfig.comm_mode``); a manual
    mode (or "auto" whose ``comm_plan`` resolved to one) takes the
    "dp" plan over ``mesh``, which must be :func:`comm_mode_mesh`'s
    (checked here: hierarchical on a world with no two-tier split is
    refused in bench.py's words), the batch split over its data
    axes. ``train_overrides``: ``TrainingConfig`` fields set over
    bench.py's before the Trainer is built (``profile`` and its window,
    ``capture_on_anomaly``), so its constructor checks them.
    ``tokens_file``: the batches come from that corpus
    (:func:`token_corpus`) instead of the ``TokenStream``; llama only
    (no ``pp``, no ``sp_mode``)."""
    from tpu_hpc_torch.models import datasets
    from tpu_hpc_torch.parallel import dp, fsdp, hybrid, tp
    from tpu_hpc_torch.parallel.plans import P
    from tpu_hpc_torch.runtime import resolve_device
    from tpu_hpc_torch.runtime.mesh import mesh_axis_size
    from tpu_hpc_torch.train.trainer import Trainer

    device = resolve_device(device)
    resolved = comm_plan.mode if comm_mode == "auto" and comm_plan \
        is not None else comm_mode
    manual = resolved in MANUAL_COMM_MODES
    if comm_mode != "flat" and (pp is not None or sp_mode is not None):
        raise ValueError(
            f"comm_mode {comm_mode!r} is only consumed by the llama "
            "workload (bench.py's llama/llama-long); "
            + ("pipeline" if pp is not None else "sequence")
            + " parallelism would silently run flat")
    if tokens_file is not None and (pp is not None or sp_mode is not None):
        raise ValueError(
            "--tokens-file feeds the llama workload's plain batches; "
            "pipeline and sequence parallelism read the TokenStream")
    if pp is not None:
        return _build_pipe_trainer(
            model_cfg, pp, steps=steps, epochs=epochs,
            grad_accum_steps=grad_accum_steps, attn=attn,
            moments_dtype=moments_dtype, device=device, mesh=mesh,
            sp_mode=sp_mode, guard_mode=guard_mode,
            checkpoint_dir=checkpoint_dir, save_every=save_every,
            resume=resume, metrics_path=metrics_path,
            train_overrides=train_overrides)
    plan = resolve_plan(plan, mesh, sp_mode, resolved)
    dp_size = mesh_axis_size(mesh, "data")
    cp_size = mesh_axis_size(mesh, "context")
    batch_pspec = P("data", "context")
    if manual and mesh is not None:
        from tpu_hpc_torch.runtime.mesh import mesh_shape, node_groups

        spec, batch_axes, _ = comm_mode_mesh(resolved, mesh.size(),
                                             len(node_groups()))
        want = spec.resolved_sizes(mesh.size())
        if mesh_shape(mesh) != want:
            raise ValueError(
                f"comm_mode {resolved!r} trains over the mesh {want} "
                f"(comm_mode_mesh), not {mesh_shape(mesh)}")
        dp_size = mesh.size()
        batch_pspec = P(batch_axes)
    # The corpus is refused before the model is built.
    ds = (token_corpus(tokens_file, model_cfg, batch * dp_size)
          if tokens_file is not None else None)
    params = llama2.init_llama(
        torch.Generator(device=device).manual_seed(SEED), model_cfg, device
    )
    constrain, specs = llama2._identity, None
    if plan == "dp":
        specs = dp.param_pspecs(params)
    elif plan == "hybrid":
        if attn != "flash":
            raise ValueError("the hybrid plan runs attention through the "
                             "flash kernels only (attn='flash')")
        tp.validate_tp_degree(model_cfg.n_heads, model_cfg.kv_heads,
                              mesh_axis_size(mesh, "model"))
        specs = hybrid.hybrid_pspecs(params, tp.llama_rules(),
                                     data_size=dp_size)
        constrain = tp.sp_constrain(mesh, dp_axis="data", sp_axis="model")
    elif plan == "fsdp":
        specs = fsdp.param_pspecs(params, axis="data",
                                  axis_size=dp_size * cp_size)
    else:
        mesh = None
    attn_fn, positions, zigzag_ring = None, None, None
    if sp_mode is not None:
        if attn != "flash":
            raise ValueError("sequence parallelism runs attention through "
                             "the flash kernels only (attn='flash')")
        attn_fn, positions, zigzag_ring = sp_attention(sp_mode, mesh,
                                                       model_cfg, device)
    elif attn == "flash":
        attn_fn = tp.make_tp_flash_attn_fn(
            mesh, "data", "model" if plan == "hybrid" else None)
    cfg, manager = _config_and_manager(
        batch * dp_size, steps=steps, epochs=epochs,
        grad_accum_steps=grad_accum_steps, moments_dtype=moments_dtype,
        guard_mode=guard_mode, checkpoint_dir=checkpoint_dir,
        save_every=save_every, resume=resume, metrics_path=metrics_path,
        comm_mode=comm_mode, overrides=train_overrides)
    if ds is None:
        ds = datasets.TokenStream(vocab_size=model_cfg.vocab_size,
                                  seq_len=model_cfg.max_seq_len, seed=SEED,
                                  zigzag_ring=zigzag_ring)
    # The trainer keeps its own copy of the params.
    return Trainer(cfg, mesh,
                   llama2.make_forward(model_cfg, constrain, attn_fn,
                                       positions),
                   params, param_pspecs=specs, batch_pspec=batch_pspec,
                   checkpoint_manager=manager, device=device,
                   comm_plan=comm_plan), ds


def _config_and_manager(global_batch: int, *, steps, epochs,
                        grad_accum_steps, moments_dtype, guard_mode,
                        checkpoint_dir, save_every, resume, metrics_path,
                        comm_mode: str = "flat",
                        overrides: Optional[dict] = None):
    """bench.py's TrainingConfig for the run with ``overrides`` set
    over it, and its CheckpointManager (None without a checkpoint
    dir)."""
    from tpu_hpc_torch.config import TrainingConfig

    cfg = TrainingConfig(
        epochs=epochs, steps_per_epoch=steps,
        global_batch_size=global_batch,
        learning_rate=LEARNING_RATE, weight_decay=WEIGHT_DECAY,
        grad_accum_steps=grad_accum_steps, adam_moments_dtype=moments_dtype,
        seed=SEED, guard_mode=guard_mode, save_every=save_every,
        checkpoint_dir=checkpoint_dir or "", resume=resume,
        metrics_path=metrics_path, comm_mode=comm_mode,
    )
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    manager = None
    if checkpoint_dir:
        from tpu_hpc_torch.ckpt import CheckpointManager

        manager = CheckpointManager(checkpoint_dir)
    return cfg, manager


def _build_pipe_trainer(model_cfg, pp: PipeArgs, *, steps, epochs,
                        grad_accum_steps, attn, moments_dtype, device, mesh,
                        sp_mode, guard_mode, checkpoint_dir, save_every,
                        resume, metrics_path, train_overrides=None):
    """:func:`build_trainer` for a pipeline run (bench_llama_pp)."""
    from tpu_hpc_torch.models import datasets
    from tpu_hpc_torch.parallel.plans import P
    from tpu_hpc_torch.runtime.mesh import mesh_axis_size
    from tpu_hpc_torch.train.trainer import Trainer

    if sp_mode is not None or mesh_axis_size(mesh, "model") > 1 \
            or mesh_axis_size(mesh, "context") > 1:
        raise ValueError(
            "pipeline parallelism composes with a data axis only: PP x TP "
            "and PP x SP are not ported (the JAX bench composes neither; "
            'ROADMAP: "Pipeline, the MPMD half")')
    if grad_accum_steps > 1 and pp.microbatch_size % grad_accum_steps:
        raise ValueError(
            f"--grad-accum-steps {grad_accum_steps} must divide the "
            f"pipeline microbatch size {pp.microbatch_size}")
    forward, params, specs, flops_cfg, v = pipe_model(model_cfg, pp, mesh,
                                                      device, attn)
    forward.cfg, forward.n_chunks = flops_cfg, v
    cfg, manager = _config_and_manager(
        pp.microbatches * pp.microbatch_size, steps=steps, epochs=epochs,
        grad_accum_steps=grad_accum_steps, moments_dtype=moments_dtype,
        guard_mode=guard_mode, checkpoint_dir=checkpoint_dir,
        save_every=save_every, resume=resume, metrics_path=metrics_path,
        overrides=train_overrides)
    ds = datasets.TokenStream(vocab_size=model_cfg.vocab_size,
                              seq_len=model_cfg.max_seq_len, seed=SEED)
    return Trainer(cfg, mesh, forward, params, param_pspecs=specs,
                   batch_pspec=P(), checkpoint_manager=manager,
                   device=device), ds


def run_train(
    model_cfg: llama2.LlamaConfig,
    *,
    steps: int = 20,
    epochs: int = 2,
    batch: int = 32,
    grad_accum_steps: int = 8,
    attn: str = "flash",
    moments_dtype: str = "float32",
    device="cuda",
    mesh=None,
    plan: str = "auto",
    sp_mode: Optional[str] = None,
    pp: Optional[PipeArgs] = None,
    comm_mode: str = "flat",
    comm_table: Optional[str] = None,
    comm_plan=None,
    metric: Optional[str] = None,
    tokens_file: Optional[str] = None,
    **resilience,
) -> dict:
    """Train ``model_cfg`` from a seeded random init for ``epochs`` x
    ``steps`` updates and return the summary dict (the CLI prints it
    on rank 0). ``resilience``: :func:`build_trainer`'s guard and
    checkpoint arguments; the summary then says where the run resumed
    and whether it was preempted or rolled back. ``comm_mode`` (with
    ``comm_table`` or an already made ``comm_plan`` for "auto", which
    is otherwise resolved here for ``mesh``'s size): the gradient sync;
    the summary carries the requested and resolved modes, the decision,
    and under a manual mode the buckets and the all-reduces an update
    issues (n_buckets + 1) beside the ones counted in the run.
    ``metric`` names the record (default by the run's kind: bench.py's
    ``llama-long`` row is ``llama2_seq8192_tokens_per_s_per_chip``).
    ``tokens_file``: train from that corpus (:func:`token_corpus`); the
    summary's ``corpus`` says what the reader held and served."""
    from tpu_hpc_torch.checks.roofline import peak_flops_for_device
    from tpu_hpc_torch.kernels import attention
    from tpu_hpc_torch.parallel.shard import layout_summary
    from tpu_hpc_torch.runtime.mesh import mesh_shape
    from tpu_hpc_torch.train.trainer import tree_leaves

    if comm_mode not in COMM_MODES:
        raise ValueError(f"unknown comm_mode {comm_mode!r}; one of "
                         f"{COMM_MODES}")
    if comm_table is not None and comm_mode != "auto":
        raise ValueError(
            f"--comm-table {comm_table} is only consumed by --comm-mode "
            f"auto; --comm-mode {comm_mode} never consults the planner")
    if comm_mode == "auto" and comm_plan is None:
        comm_plan = resolve_comm_auto(
            model_cfg, comm_table,
            n_dev=mesh.size() if mesh is not None else 1,
            device_type=torch.device(device).type)
    trainer, ds = build_trainer(
        model_cfg, steps=steps, epochs=epochs, batch=batch,
        grad_accum_steps=grad_accum_steps, attn=attn,
        moments_dtype=moments_dtype, device=device, mesh=mesh, plan=plan,
        sp_mode=sp_mode, pp=pp, comm_mode=comm_mode, comm_plan=comm_plan,
        tokens_file=tokens_file, **resilience,
    )
    device = trainer.device
    flops_cfg = model_cfg if pp is None else trainer.forward.cfg
    world = trainer.n_devices
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
    launches0 = attention.kernel_launches()
    sync = trainer.grad_sync
    allreduces0 = sync.allreduces if sync is not None else 0
    result = trainer.fit(ds)
    launches = {k: v - launches0[k]
                for k, v in attention.kernel_launches().items()}
    losses = [loss for e in result["epochs"] for loss in e["losses"]]
    # The last chunk is the measured one (a resumed run may have none).
    summary = (result["epochs"][-1] if result["epochs"]
               else {"items_per_s": 0.0, "total_s": 0.0, "losses": [None]})
    seq = model_cfg.max_seq_len
    tokens_per_s = summary["items_per_s"] * seq
    flops_per_token = flops_cfg.flops_per_token(seq)
    peak = peak_flops_for_device(device)
    if metric is None:
        metric = (pp.metric() if pp is not None else
                  f"llama2_sp_{sp_mode}_tokens_per_s_per_chip" if sp_mode
                  else "llama2_train_tokens_per_s_per_chip")
    out = {
        "metric": metric,
        "value": tokens_per_s / world,
        "unit": "tokens/s/chip",
        "device": {
            "type": device.type,
            "name": (torch.cuda.get_device_name(device)
                     if device.type == "cuda" else "cpu"),
            "count": world,
        },
        "mesh": mesh_shape(trainer.mesh) or None,
        "world_size": world,
        "plan": "pipe" if pp is not None else resolve_plan(
            plan, mesh, sp_mode, trainer.comm_mode_resolved),
        "sp_mode": sp_mode,
        "layout": layout_summary(trainer.module),
        "tokens_per_s": tokens_per_s,
        "tokens_per_s_per_device": tokens_per_s / world,
        "mfu": (tokens_per_s * flops_per_token / (peak * world)
                if peak is not None else None),
        "peak_flops": peak,
        "flops_per_token": flops_per_token,
        "update_s": summary["total_s"] / len(summary["losses"]),
        "final_loss": result["final_loss"],
        "losses": losses,
        "updates": len(losses),
        "global_batch": trainer.cfg.global_batch_size,
        "grad_accum_steps": grad_accum_steps,
        "seq_len": seq,
        "n_params": (llama2.count_params(model_cfg) if pp is None else
                     sum(t.numel() for t in tree_leaves(
                         trainer.state.params))),
        "model": {"dim": model_cfg.dim, "n_layers": model_cfg.n_layers,
                  "n_heads": model_cfg.n_heads,
                  "kv_heads": model_cfg.kv_heads,
                  "vocab_size": model_cfg.vocab_size,
                  "dtype": str(model_cfg.dtype).replace("torch.", ""),
                  "remat": model_cfg.remat},
        "attn": attn,
        "kernel_launches": launches,
        "flash_tile_rows": ({k: attention.flash_tile_rows(k, model_cfg.dtype)
                             for k in attention.FLASH_KERNELS}
                            if attn == "flash" and device.type == "cuda"
                            else None),
        "goodput": result["goodput"],
        "guard_mode": trainer.cfg.guard_mode,
        "resumed_from_step": result["resumed_from_step"],
        "preempted": result["preempted"],
        "rolled_back": result["rolled_back"],
        "comm_mode": comm_mode,
        "comm_mode_resolved": trainer.comm_mode_resolved,
        "comm_plan": (trainer.comm_plan.summary()
                      if trainer.comm_plan is not None else None),
        "comm": ({
            "sync_axes": list(sync.sync_axes),
            "n_buckets": sync.n_buckets,
            "bucket_bytes": sync.bucket_bytes,
            "allreduces_per_update": sync.n_buckets + 1,
            "allreduces": sync.allreduces - allreduces0,
            "launch_order": sync.order,
            "launched_in_backward": sum(
                1 for _, during in sync.launch_log if during),
        } if sync is not None else None),
    }
    if pp is not None:
        from tpu_hpc_torch.parallel.pp import bubble_fraction
        from tpu_hpc_torch.runtime.mesh import mesh_axis_size

        v = trainer.forward.n_chunks
        out["pp"] = {**dataclasses.asdict(pp),
                     "remat_stage": trainer.forward.pipe.engine.remat_stage,
                     "n_stages": mesh_axis_size(trainer.mesh, "pipe")}
        out["model"]["pp_model"] = pp.model
        out["n_chunks"] = v
        out["bubble_fraction"] = bubble_fraction(
            out["pp"]["n_stages"], pp.microbatches, n_chunks=v)
    if tokens_file is not None:
        out["corpus"] = {
            "path": tokens_file,
            "n_tokens": ds.n_tokens,
            "n_windows": ds.n_windows,
            "max_token_id": ds.max_token_id,
            # One batch_at of the global batch an update.
            "windows_served": len(losses) * trainer.cfg.global_batch_size,
        }
        ds.close()
    if device.type == "cuda":
        out["peak_memory_bytes"] = torch.cuda.max_memory_allocated(device)
    return out


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="tpu_hpc_torch.train",
        description=__doc__.split("\n")[0],
        allow_abbrev=False,
    )
    ap.add_argument("--workload", choices=WORKLOADS, default="llama",
                    help="llama: bench.py's llama row (and its sp, pp and "
                    "comm rows by flag); llama-long: seq 8192 at microbatch "
                    "1; unet (bench.py's unet ddp row), vit, resnet, "
                    "domain-unet: train/vision.py's workloads; elastic: "
                    "bench.py's preemption-storm row (train/elastic.py)")
    ap.add_argument("--steps", type=int, default=20,
                    help="optimizer updates per epoch")
    ap.add_argument("--epochs", type=int, default=None,
                    help="epochs (default 2); the first absorbs build and "
                    "warm-up, the last is measured")
    ap.add_argument("--batch", type=int, default=None,
                    help="batch per data rank (default: microbatch 4 x "
                    "accum); the global batch is this x the data axis")
    ap.add_argument("--grad-accum-steps", type=int, default=None,
                    help="microbatches per update (default 8 with no "
                    "--batch, else 1)")
    ap.add_argument("--seq-len", type=int, default=None,
                    help="default 2048 (llama-long: 8192)")
    ap.add_argument("--attn", choices=("flash", "reference"),
                    default="flash",
                    help="flash: the Hopper kernels through "
                    "make_tp_flash_attn_fn; reference: the model's einsum "
                    "attention")
    ap.add_argument("--remat", action="store_true")
    ap.add_argument("--moments-dtype", choices=("float32", "bfloat16"),
                    default=None, help="AdamW moments (default float32)")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="where to train (default cuda; a missing card is "
                    "an error, never a silent CPU run)")
    ap.add_argument("--data", type=int, default=None,
                    help="data-axis size (FSDP); default: what "
                    "tp.auto_mesh_axes leaves after --model")
    ap.add_argument("--model", type=int, default=None,
                    help="model-axis size (TP + SP); default: "
                    "tp.auto_mesh_axes(world, heads, kv_heads, cap=4)")
    ap.add_argument("--sp-mode", choices=SP_MODES, default=None,
                    help="sequence parallelism over a (data, context) mesh "
                    "(bench.py --workload llama-sp): the contiguous ring, "
                    "the zigzag ring or Ulysses, around the flash kernels")
    ap.add_argument("--context", type=int, default=None,
                    help="context-axis size (with --sp-mode; default: every "
                    "process, data 1)")
    ap.add_argument("--pp-schedule", choices=PP_SCHEDULES, default=None,
                    help="pipeline parallelism (bench.py --workload "
                    "llama-pp) over a pipe axis of world / --data stages; "
                    "default 1f1b when another --pp-* flag is given")
    ap.add_argument("--pp-model", choices=("stack", "llama"), default=None,
                    help="stack: the PipelineTransformer at the bench width "
                    "(default); llama: the bench Llama, stage-split")
    ap.add_argument("--pp-backward", choices=("remat", "stash"),
                    default=None,
                    help="the 1f1b schedules' backward (default remat)")
    ap.add_argument("--pp-microbatches", type=int, default=None,
                    help="pipeline microbatches per update (default 8)")
    ap.add_argument("--pp-microbatch-size", type=int, default=None,
                    help="rows per microbatch (default 4); the global batch "
                    "is microbatches x this")
    ap.add_argument("--comm-mode", choices=COMM_MODES, default="flat",
                    help="gradient sync (bench.py --comm-mode): flat = the "
                    "plan's own collectives (FSDP2 over data); "
                    "bucketed_overlap = replicated params, size-capped "
                    "bucket all-reduces launched during the backward; "
                    "hierarchical = the same over a two-tier (dcn x data) "
                    "mesh, each bucket in two phases; auto = the collective "
                    "planner picks mode and bucket size. A manual mode "
                    "makes the whole world data")
    ap.add_argument("--comm-table", default=None, metavar="PATH",
                    help="explicit planner cost-table file for --comm-mode "
                    "auto (default: $TPU_HPC_COMM_TABLES's entry for this "
                    "topology); requires --comm-mode auto")
    ap.add_argument("--tokens-file", default=None, metavar="PATH",
                    help="train the llama workload from this pretokenized "
                    "corpus (python -m tpu_hpc_torch.native.prepare) "
                    "through the C++ reader instead of the synthetic "
                    "TokenStream; refused when its largest id does not fit "
                    "the vocabulary")
    ap.add_argument("--pp-runtime", choices=("spmd", "mpmd"), default=None,
                    help="spmd: the tick-table pipeline; mpmd: per-stage "
                    "programs and fault domains (parallel/mpmd.py), one "
                    "stage per visible card, with an explicit "
                    "--pp-schedule gpipe")
    for flag in ("dim", "n-layers", "n-heads", "vocab", "multiple-of"):
        ap.add_argument(f"--{flag}", type=int, default=None,
                        help="model-size override (CPU rehearsals; the "
                        "ViT's embed, depth and heads)")
    for flag, what in (
            ("lat", "grid latitudes (unet 181, vit 64, domain-unet 32)"),
            ("lon", "grid longitudes (unet 360, vit 128, domain-unet 64)"),
            ("channels", "grid channels (unet, vit 20; domain-unet 3)"),
            ("base-features", "U-Net width (unet 64, domain-unet 16)"),
            ("spatial", "domain-unet latitude bands (one process: 4, in "
             "process; a launch: the world over --data)"),
            ("eval-steps", "vision workloads: batches of the evaluation "
             "pass after training (BatchNorm on the stored stats)")):
        ap.add_argument(f"--{flag}", type=int, default=None, help=what)
    ap.add_argument("--guard-mode", choices=("off", "skip", "rollback"),
                    default="off",
                    help="numeric-health guard: skip drops a poisoned "
                    "update on the device; rollback (needs "
                    "--checkpoint-dir) exits 77 for the supervisor to "
                    "relaunch from the last good checkpoint")
    ap.add_argument("--checkpoint-dir", default=None,
                    help="checkpoint here (torch.distributed.checkpoint); "
                    "the run resumes from the newest readable step")
    ap.add_argument("--save-every", type=int, default=0,
                    help="save every N epochs (0: never)")
    ap.add_argument("--resume", action=argparse.BooleanOptionalAction,
                    default=True,
                    help="resume from --checkpoint-dir's newest step")
    ap.add_argument("--metrics", default="",
                    help="append the run's JSONL records here")
    ap.add_argument("--supervise", type=int, default=None, metavar="N",
                    help="run under tpu_hpc_torch.resilience.supervisor "
                    "with N restarts (a preemption or a guard rollback "
                    "relaunches without spending one)")
    ap.add_argument("--elastic-shrink-at", type=int, default=None,
                    metavar="N",
                    help="topology coordinator chaos: lose half the rank "
                    "pool at step N (live shrink, no restart; --workload "
                    "elastic only; default 2)")
    ap.add_argument("--elastic-grow-at", type=int, default=None,
                    metavar="N",
                    help="topology coordinator chaos: the lost ranks "
                    "return at step N (live grow back to the full pool; "
                    "--workload elastic only; default 4)")
    args = ap.parse_args(argv)
    from tpu_hpc_torch.train.elastic import elastic_flag_error

    why = elastic_flag_error(args)
    if why is not None:
        ap.error(why)
    if args.tokens_file is not None and (
            args.workload not in ("llama", "llama-long")
            or args.sp_mode is not None or args.pp_schedule is not None
            or args.pp_runtime is not None or args.pp_model is not None
            or args.pp_backward is not None
            or args.pp_microbatches is not None
            or args.pp_microbatch_size is not None):
        ap.error("--tokens-file feeds the llama workload's plain batches: "
                 "not --sp-mode, --pp-* or another --workload")
    if args.workload == "elastic":
        return _main_elastic(ap, args)
    if args.pp_runtime == "mpmd":
        why = mpmd_flag_error(args) or mpmd_unused_flag_error(args)
        if why is not None:
            ap.error(why)
    args.epochs = 2 if args.epochs is None else args.epochs
    args.moments_dtype = args.moments_dtype or "float32"
    if args.workload in VISION_WORKLOADS:
        return _main_vision(ap, args)
    vision_only = [f for f in VISION_FLAGS if getattr(args, f) is not None]
    if vision_only:
        ap.error(f"--{vision_only[0].replace('_', '-')} sizes the vision "
                 f"workloads, not --workload {args.workload}")
    pp_flags = {k[3:]: v for k, v in vars(args).items()
                if k.startswith("pp_") and v is not None}
    pp = None
    mpmd_run = False
    if pp_flags:
        mpmd_run = pp_flags.pop("runtime", "spmd") == "mpmd"
        if args.sp_mode is not None or (args.model or 1) > 1:
            ap.error("--pp-* composes with --data only: PP x TP (--model) "
                     "and PP x SP (--sp-mode) are not ported (the JAX bench "
                     "composes neither)")
        pp = PipeArgs(**pp_flags)
    if mpmd_run:
        return _main_mpmd(ap, args, pp)
    if args.sp_mode is not None and (args.model or 1) > 1:
        ap.error("--sp-mode does not combine with --model > 1: TP x "
                 "context parallelism is not ported (the JAX bench never "
                 "combines them)")
    if args.sp_mode is not None and args.attn != "flash":
        ap.error("--sp-mode runs attention through the flash kernels only")
    if args.context is not None and args.sp_mode is None:
        ap.error("--context needs --sp-mode")
    if args.comm_table is not None and args.comm_mode != "auto":
        ap.error(f"--comm-table {args.comm_table} is only consumed by "
                 f"--comm-mode auto; --comm-mode {args.comm_mode} never "
                 "consults the planner")
    if args.comm_mode != "flat":
        other = ("--sp-mode" if args.sp_mode is not None else
                 "--pp-*" if pp is not None else None)
        if other:
            ap.error(f"--comm-mode {args.comm_mode} is only consumed by the "
                     f"llama workload; with {other} it would silently run "
                     "flat")
        if args.comm_mode != "auto" and any(
                v is not None for v in (args.data, args.model, args.context)):
            ap.error(f"--comm-mode {args.comm_mode} makes the whole world "
                     "data (comm_mode_mesh): drop --data/--model/--context")
    if args.guard_mode == "rollback" and not args.checkpoint_dir:
        ap.error("--guard-mode rollback needs --checkpoint-dir: "
                 "rollback-to-last-good restores a snapshot; without one "
                 "the guard can only skip or record events")
    if args.supervise is not None:
        import os

        from tpu_hpc_torch.resilience.supervisor import (
            run_supervised,
            strip_flag,
        )

        if int(os.environ.get("WORLD_SIZE", "1")) > 1:
            ap.error("--supervise under a multi-process launch would "
                     "supervise each rank: put the supervisor around the "
                     "launcher instead (python -m "
                     "tpu_hpc_torch.resilience.supervisor -- torchrun ...)")
        child = strip_flag(sys.argv[1:] if argv is None else argv,
                           "--supervise")
        return run_supervised(
            [sys.executable, "-m", "tpu_hpc_torch.train", *child],
            max_restarts=args.supervise)

    from tpu_hpc_torch.resilience.signals import exit_code_for
    from tpu_hpc_torch.runtime import (
        MeshSpec,
        build_mesh,
        cleanup_distributed,
        init_distributed,
        is_main_host,
        resolve_device,
    )

    try:
        device = resolve_device(args.device)
    except RuntimeError as e:
        ap.error(str(e))
    long = args.workload == "llama-long"
    if long and (pp is not None or args.sp_mode is not None):
        ap.error("--workload llama-long is bench.py's one-device long-context "
                 "row: --pp-* and --sp-mode belong to --workload llama")
    seq_len = args.seq_len or (8192 if long else 2048)
    batch, accum = resolve_batch_accum(args.batch, args.grad_accum_steps,
                                       microbatch=1 if long else 4)
    if pp is not None:
        # bench.py's llama-pp: the batch is the microbatches' rows, no
        # accumulation unless asked for.
        accum = args.grad_accum_steps or 1
        batch = pp.microbatches * pp.microbatch_size
    model_cfg = bench_model_cfg(
        seq_len, args.remat, dim=args.dim, n_layers=args.n_layers,
        n_heads=args.n_heads, vocab_size=args.vocab,
        multiple_of=args.multiple_of,
    )
    if batch % max(accum, 1):
        ap.error(f"--batch {batch} is not divisible by the accumulation "
                 f"{accum}")
    # Under torchrun (or any launcher get_host_info knows) join the
    # process group; then the mesh, by bench.py's rule.
    info = init_distributed(device=device.type, verbose=False)
    mesh = None
    asked = (args.data or 1) * (args.model or 1) * (args.context or 1)
    comm_plan, resolved = None, args.comm_mode
    if args.comm_mode == "auto":
        comm_plan = resolve_comm_auto(model_cfg, args.comm_table,
                                      n_dev=info.num_processes,
                                      device_type=device.type)
        resolved = comm_plan.mode
    if resolved in MANUAL_COMM_MODES:
        from tpu_hpc_torch.runtime.mesh import node_groups

        _one_rank_world(device)
        try:
            spec, _, _ = comm_mode_mesh(resolved, info.num_processes,
                                        len(node_groups()))
        except ValueError as e:
            cleanup_distributed()
            ap.error(str(e))
        mesh = build_mesh(spec, device.type)
    elif info.num_processes > 1:
        if pp is not None:
            axes = pp_mesh_axes(info.num_processes, args.data)
        elif args.sp_mode is not None:
            axes = sp_mesh_axes(info.num_processes, args.data, args.context)
        else:
            axes = mesh_axes(info.num_processes, model_cfg, args.data,
                             args.model)
        if axes is None:
            ap.error(f"--data {args.data} x --model {args.model} x --context "
                     f"{args.context} does not cover the "
                     f"{info.num_processes} processes")
        mesh = build_mesh(MeshSpec(axes=axes), device.type)
    elif asked > 1:
        ap.error(f"--data/--model/--context ask for {asked} processes; "
                 "launch them with torchrun --nproc-per-node")
    try:
        summary = run_train(
            model_cfg, steps=args.steps, epochs=args.epochs, batch=batch,
            grad_accum_steps=accum, attn=args.attn,
            moments_dtype=args.moments_dtype, device=device, mesh=mesh,
            guard_mode=args.guard_mode, checkpoint_dir=args.checkpoint_dir,
            save_every=args.save_every, resume=args.resume,
            metrics_path=args.metrics, sp_mode=args.sp_mode, pp=pp,
            comm_mode=args.comm_mode, comm_plan=comm_plan,
            metric=(f"llama2_seq{seq_len}_tokens_per_s_per_chip" if long
                    else None),
            tokens_file=args.tokens_file,
        )
        if is_main_host():
            print(json.dumps(summary), flush=True)
    except CorpusRefused as e:
        ap.error(f"--tokens-file: {e}")
    finally:
        cleanup_distributed()
    return exit_code_for(summary["preempted"], summary["rolled_back"])


def mpmd_flag_error(args) -> Optional[str]:
    """bench.py's refusals of ``--pp-runtime mpmd`` (bench.py:1944-1966),
    word for word, or None. The port's ``--pp-*`` flags select the
    pipeline, so bench.py's "another workload" is a vision
    ``--workload``, ``llama-long``, ``--sp-mode`` (bench.py's llama-sp)
    or ``--comm-mode`` (its llama row); an absent ``--pp-schedule`` is
    bench.py's default, 1f1b."""
    workload = (args.workload if args.workload != "llama" else
                "llama-sp" if args.sp_mode is not None else
                "llama" if args.comm_mode != "flat" else None)
    if workload is not None:
        return ("--pp-runtime mpmd is only consumed by --workload "
                f"llama-pp/pp; --workload {workload} would "
                "silently run without it")
    schedule = args.pp_schedule or PipeArgs.schedule
    if schedule != "gpipe":
        return ("--pp-runtime mpmd dispatches its own gpipe-ordered "
                "schedule; pass --pp-schedule gpipe explicitly "
                f"(got {schedule!r} -- a 1f1b/interleaved "
                "row label would misdescribe what ran)")
    if (args.pp_backward or PipeArgs.backward) != "remat":
        return ("--pp-runtime mpmd does not consume --pp-backward "
                "(its per-stage backward is an explicit vjp program)")
    return None


def mpmd_unused_flag_error(args) -> Optional[str]:
    """The first flag ``--pp-runtime mpmd`` would silently ignore, or
    None: its batch is --pp-microbatches x --pp-microbatch-size, its
    steps are one warm and --steps timed ones, its optimizer is SGD with
    momentum, and it runs unsupervised in one process."""
    for flag, value in (("--batch", args.batch), ("--epochs", args.epochs),
                        ("--moments-dtype", args.moments_dtype),
                        ("--comm-table", args.comm_table),
                        ("--supervise", args.supervise)):
        if value is not None:
            return (f"{flag} is not consumed by --pp-runtime mpmd: a step "
                    "is one gpipe pass over --pp-microbatches x "
                    "--pp-microbatch-size rows, one warm step and --steps "
                    "timed ones, SGD with momentum, in one unsupervised "
                    "process; it would silently run without it")
    return None


def mpmd_model(model_cfg: llama2.LlamaConfig, args: PipeArgs,
               n_stages: int, device, attn: str = "flash"):
    """bench_llama_pp_mpmd's model (bench.py:699-738) cut for
    ``n_stages`` stages: ``(bundle, flops_cfg)``. ``stack`` is the
    PipelineTransformer at ``model_cfg``'s width, depth, sequence and
    compute dtype; ``llama`` stage-splits the Llama itself. Attention is
    the flash kernels (``blockwise_attention``) or, with
    ``attn="reference"``, the model's einsum path. Params are made from
    seed 0 on ``device``; each stage worker copies its own."""
    from tpu_hpc_torch.kernels.attention import blockwise_attention
    from tpu_hpc_torch.models import llama_pp
    from tpu_hpc_torch.models import pipeline_transformer as ptx

    if args.model not in ("stack", "llama"):
        raise ValueError(f"unknown pp model {args.model!r} (stack|llama)")
    attn_fn = None
    if attn == "flash":
        def attn_fn(q, k, v):
            return blockwise_attention(q, k, v, causal=True)[0]
    gen = torch.Generator(device=device).manual_seed(SEED)
    if args.model == "llama":
        if model_cfg.n_layers % n_stages:
            raise ValueError(
                f"llama mpmd needs n_layers {model_cfg.n_layers} "
                f"divisible by {n_stages} stages")
        full = llama2.init_llama(gen, model_cfg, device)
        split = llama_pp.split_params(full, model_cfg, n_stages)
        return (llama_pp.mpmd_bundle(split, model_cfg, attn_fn=attn_fn),
                model_cfg)
    pcfg = ptx.PipeConfig(
        vocab_size=model_cfg.vocab_size, dim=model_cfg.dim,
        n_heads=model_cfg.n_heads, n_stages=n_stages,
        layers_per_stage=max(model_cfg.n_layers // n_stages, 1),
        max_seq_len=model_cfg.max_seq_len, dtype=model_cfg.dtype)
    params = ptx.init_pipeline_transformer(gen, pcfg, device)
    return ptx.mpmd_bundle(params, pcfg, attn_fn=attn_fn), pcfg


def run_mpmd(model_cfg: llama2.LlamaConfig, pp: PipeArgs, devices, *,
             steps: int = 20, attn: str = "flash",
             events_path: Optional[str] = None, fault_plan=None) -> dict:
    """bench.py's MPMD row: build the pipeline over ``devices``, one
    stage each, run one warm step, then ``steps`` timed steps, and
    return bench.py's record with the port's usual fields.
    ``fault_plan``: as ``MpmdPipeline`` takes it (default:
    ``$TPU_HPC_FAULTS``)."""
    import time

    from tpu_hpc_torch.checks.roofline import peak_flops_for_device
    from tpu_hpc_torch.kernels import attention
    from tpu_hpc_torch.models import datasets
    from tpu_hpc_torch.parallel import mpmd
    from tpu_hpc_torch.train.trainer import tree_leaves

    devices = [torch.device(d) for d in devices]
    cards = sorted({d for d in devices if d.type == "cuda"}, key=str)
    n_stages = len(devices)
    n_dev = len(set(devices))
    bundle, flops_cfg = mpmd_model(model_cfg, pp, n_stages, devices[0],
                                   attn)
    cfg = mpmd.MpmdConfig(n_microbatches=pp.microbatches,
                          learning_rate=LEARNING_RATE)
    ds = datasets.TokenStream(vocab_size=model_cfg.vocab_size,
                              seq_len=model_cfg.max_seq_len, seed=SEED)
    batch = pp.microbatches * pp.microbatch_size
    batches = [ds.batch_at(i, batch) for i in range(steps + 1)]
    pipe = mpmd.MpmdPipeline(bundle, cfg, devices=devices,
                             fault_plan=fault_plan,
                             events_path=events_path).build(batches[0][0])
    warm_counts = list(pipe.compile_counts)

    def sync():
        for d in cards:
            torch.cuda.synchronize(d)

    sync()
    for d in cards:
        torch.cuda.reset_peak_memory_stats(d)
    launches0 = attention.kernel_launches()
    step_losses = [pipe.run_step(0, *batches[0])]  # warm, untimed
    sync()
    t0 = time.perf_counter()
    for step in range(1, steps + 1):
        step_losses.append(pipe.run_step(step, *batches[step]))
    sync()
    wall = time.perf_counter() - t0
    launches = {k: v - launches0[k]
                for k, v in attention.kernel_launches().items()}
    seq = model_cfg.max_seq_len
    tokens_per_s = steps * batch * seq / wall if steps else 0.0
    flops_per_token = flops_cfg.flops_per_token(seq)
    peak = peak_flops_for_device(devices[0])
    mfu = (tokens_per_s * flops_per_token / (peak * n_dev)
           if peak is not None else None)
    tag = "-llama" if pp.model == "llama" else ""
    # A chaos-armed run banks under its own -chaos family: its recovery
    # MTTR and redispatches must not pollute the clean family's.
    armed = (pipe.fault_plan.stage_fault_keys()
             if pipe.fault_plan is not None else [])
    if armed:
        tag += "-chaos"
    mttrs = [r["mttr_s"] for r in pipe.recoveries]
    losses = [sum(v) / len(v) for v in step_losses]
    out = {
        "metric": f"pp_mpmd{tag}_tokens_per_s_per_chip",
        "value": tokens_per_s / n_dev,
        "unit": "tokens/s/chip",
        "vs_baseline": mfu / 0.40 if mfu is not None else None,
        "pp_runtime": "mpmd",
        **({"faults": ",".join(armed)} if armed else {}),
        "bubble_fraction": (sum(pipe.bubble_fractions)
                            / len(pipe.bubble_fractions)),
        "recovery_mttr_s": sum(mttrs) / len(mttrs) if mttrs else 0.0,
        "stage_restarts": sum(pipe.supervisor.restarts.values()),
        "stage_rollbacks": sum(pipe.supervisor.rollbacks.values()),
        "redispatched": pipe.redispatched,
        "recompiles": sum(pipe.compile_counts) - sum(warm_counts),
        "wire_mb": pipe.wire_bytes / 2**20,
        "attn": attn,
        "device": {
            "type": devices[0].type,
            "name": (torch.cuda.get_device_name(devices[0])
                     if devices[0].type == "cuda" else "cpu"),
            "count": n_dev,
        },
        "n_stages": n_stages,
        "stage_devices": [str(d) for d in devices],
        "tokens_per_s": tokens_per_s,
        "tokens_per_s_per_device": tokens_per_s / n_dev,
        "mfu": mfu,
        "peak_flops": peak,
        "flops_per_token": flops_per_token,
        "update_s": wall / steps if steps else None,
        "final_loss": losses[-1],
        "losses": losses,
        "microbatch_losses": step_losses,
        "updates": len(losses),
        "measured_updates": steps,
        "global_batch": batch,
        "seq_len": seq,
        "n_params": sum(t.numel() for tree in (
            *bundle.stage_params, bundle.embed_params, bundle.head_params)
            for t in tree_leaves(tree)),
        "model": {"dim": model_cfg.dim, "n_layers": model_cfg.n_layers,
                  "n_heads": model_cfg.n_heads,
                  "vocab_size": model_cfg.vocab_size,
                  "dtype": str(model_cfg.dtype).replace("torch.", ""),
                  "pp_model": pp.model},
        "pp": {**dataclasses.asdict(pp), "runtime": "mpmd"},
        "compile_counts": pipe.compile_counts,
        "kernel_launches": launches,
        "flash_tile_rows": ({k: attention.flash_tile_rows(k, model_cfg.dtype)
                             for k in attention.FLASH_KERNELS}
                            if attn == "flash" and devices[0].type == "cuda"
                            else None),
        "recoveries": pipe.recoveries,
        "stage_remaps": pipe.remaps,
    }
    if cards:
        out["peak_memory_bytes"] = max(torch.cuda.max_memory_allocated(d)
                                       for d in cards)
    return out


def _main_mpmd(ap, args, pp: PipeArgs) -> int:
    """``main`` for ``--pp-runtime mpmd`` (bench.py's MPMD row)."""
    import os

    from tpu_hpc_torch.parallel.mpmd import (
        StageBudgetExhausted,
        visible_devices,
    )
    from tpu_hpc_torch.runtime import resolve_device

    if int(os.environ.get("WORLD_SIZE", "1")) > 1:
        ap.error("--pp-runtime mpmd is one process that drives one card "
                 "per stage (parallel/mpmd.py): a launch of "
                 f"{os.environ['WORLD_SIZE']} processes would run that many "
                 "separate pipelines; run it without torchrun")
    if args.data is not None or args.context is not None:
        ap.error("--pp-runtime mpmd places one stage on each visible card; "
                 "--data/--context split a multi-process launch it does "
                 "not use")
    if args.guard_mode != "off" or args.checkpoint_dir:
        ap.error("--guard-mode and --checkpoint-dir are not consumed by "
                 "--pp-runtime mpmd: its recovery is stage-local (per-stage "
                 "snapshots, guards and budgets; TPU_HPC_FAULTS arms its "
                 "stage faults)")
    if (args.grad_accum_steps or 1) > 1:
        ap.error("--pp-runtime mpmd does not accumulate: a step is "
                 "--pp-microbatches x --pp-microbatch-size rows")
    try:
        device = resolve_device(args.device)
    except RuntimeError as e:
        ap.error(str(e))
    devices = (visible_devices(torch.cuda.device_count())
               if device.type == "cuda" else [device])
    model_cfg = bench_model_cfg(
        args.seq_len or 2048, args.remat, dim=args.dim,
        n_layers=args.n_layers, n_heads=args.n_heads,
        vocab_size=args.vocab, multiple_of=args.multiple_of)
    try:
        summary = run_mpmd(model_cfg, pp, devices, steps=args.steps,
                           attn=args.attn, events_path=args.metrics or None)
    except StageBudgetExhausted as e:
        print(f"tpu_hpc_torch.train: {e}", file=sys.stderr)
        return e.exit_code
    print(json.dumps(summary), flush=True)
    return 0


def _main_vision(ap, args) -> int:
    """``main`` for the vision workloads (``train/vision.py``)."""
    from tpu_hpc_torch.runtime import (
        MeshSpec,
        build_mesh,
        cleanup_distributed,
        init_distributed,
        is_main_host,
        resolve_device,
    )
    from tpu_hpc_torch.train import vision

    w = args.workload
    pp_flags = [k for k, v in vars(args).items()
                if k.startswith("pp_") and v is not None]
    other = ("--comm-mode" if args.comm_mode != "flat" else
             "--comm-table" if args.comm_table is not None else
             "--pp-*" if pp_flags else
             "--sp-mode" if args.sp_mode is not None else
             "--context" if args.context is not None else
             "--seq-len" if args.seq_len is not None else
             "--vocab/--multiple-of" if args.vocab or args.multiple_of else
             "--remat" if args.remat else None)
    if other:
        ap.error(f"{other} is only consumed by the llama workloads; "
                 f"--workload {w} would silently ignore it")
    if (args.model or 1) > 1 and w != "vit":
        ap.error(f"--model {args.model}: the {w} workload has no tensor "
                 "parallel plan (the ViT's is tp.vit_rules)")
    if w != "vit" and (args.dim or args.n_layers or args.n_heads
                       or args.attn != "flash"):
        ap.error("--dim/--n-layers/--n-heads/--attn size the ViT, not "
                 f"--workload {w}")
    if w == "resnet" and any(getattr(args, f) is not None for f in (
            "lat", "lon", "channels", "base_features", "spatial")):
        ap.error("--lat/--lon/--channels/--base-features/--spatial size "
                 "the grids and U-Nets, not --workload resnet")
    if w != "domain-unet" and args.spatial is not None:
        ap.error("--spatial needs --workload domain-unet")
    if w not in ("unet", "domain-unet") and args.base_features is not None:
        ap.error("--base-features sizes the U-Nets")
    if args.guard_mode != "off" or args.checkpoint_dir or args.supervise:
        ap.error("--guard-mode, --checkpoint-dir and --supervise are wired "
                 "for the llama workloads only")
    try:
        device = resolve_device(args.device)
    except RuntimeError as e:
        ap.error(str(e))
    vargs = vision.VisionArgs(
        workload=w, batch=args.batch,
        grad_accum_steps=args.grad_accum_steps or 1, attn=args.attn,
        lat=args.lat, lon=args.lon, channels=args.channels,
        base_features=args.base_features, spatial=args.spatial,
        embed_dim=args.dim, depth=args.n_layers, n_heads=args.n_heads,
        eval_steps=args.eval_steps or 0)
    batch = vargs.default("batch", vision.DEFAULT_BATCH[w])
    if batch % vargs.grad_accum_steps:
        ap.error(f"--batch {batch} is not divisible by the accumulation "
                 f"{vargs.grad_accum_steps}")
    info = init_distributed(device=device.type, verbose=False)
    world = info.num_processes
    mesh = None
    try:
        if w == "domain-unet":
            spatial = vargs.default("spatial", 4) if world == 1 else (
                args.spatial or (world // args.data if args.data else world))
            if world > 1 and (spatial < 1 or world % spatial or (
                    args.data and args.data * spatial != world)):
                ap.error(f"--data {args.data} x --spatial {args.spatial} "
                         f"does not cover the {world} processes")
            try:
                vision.check_domain_grid(
                    vargs.default("lat", vision.GRIDS[w][0]), spatial)
            except ValueError as e:
                ap.error(str(e))
            if world > 1:
                mesh = build_mesh(MeshSpec(axes={
                    "data": world // spatial, "spatial": spatial}),
                    device.type)
        elif w == "vit" and (args.model or 1) > 1:
            axes = mesh_axes(world, None, args.data, args.model)
            if axes is None:
                ap.error(f"--data {args.data} x --model {args.model} does "
                         f"not cover the {world} processes")
            mesh = build_mesh(MeshSpec(axes=axes), device.type)
        elif args.data is not None and args.data != world:
            ap.error(f"--data {args.data}: the {w} workload is data parallel "
                     f"over all {world} processes")
        elif world > 1 or w == "unet":
            if world == 1:
                _one_rank_world(device)
            mesh = build_mesh(MeshSpec(axes={"data": world}), device.type)
        summary = vision.run_vision(vargs, steps=args.steps,
                                    epochs=args.epochs, device=device,
                                    mesh=mesh, metrics_path=args.metrics)
        if is_main_host():
            print(json.dumps(summary), flush=True)
    finally:
        cleanup_distributed()
    return 0


def _main_elastic(ap, args) -> int:
    """``main`` for ``--workload elastic`` (train/elastic.py): every rank
    of the launch (or a one-rank world) runs the storm; rank 0 prints
    bench.py's record."""
    from tpu_hpc_torch.runtime import (
        cleanup_distributed,
        init_distributed,
        resolve_device,
    )
    from tpu_hpc_torch.train.elastic import run_elastic

    llama_only = [flag for flag, set_ in (
        ("--sp-mode", args.sp_mode is not None),
        ("--pp-*", any(v is not None for k, v in vars(args).items()
                       if k.startswith("pp_"))),
        ("--comm-mode", args.comm_mode != "flat"),
        ("--data/--model/--context", any(
            v is not None for v in (args.data, args.model, args.context))),
        ("--checkpoint-dir", args.checkpoint_dir is not None),
        ("--guard-mode", args.guard_mode != "off"),
        ("--supervise", args.supervise is not None),
    ) if set_]
    if llama_only:
        ap.error(f"{llama_only[0]} is not consumed by --workload elastic "
                 "(the storm row trains bench.py's MLP on the "
                 "coordinator's layouts)")
    try:
        device = resolve_device(args.device)
    except RuntimeError as e:
        ap.error(str(e))
    init_distributed(device=device.type, verbose=False)
    _one_rank_world(device)
    try:
        rec = run_elastic(args.steps, shrink_at=args.elastic_shrink_at,
                          grow_at=args.elastic_grow_at, device=device)
        import torch.distributed as dist

        if dist.get_rank() == 0:
            print(json.dumps(rec), flush=True)
    finally:
        cleanup_distributed()
    return 0


def _one_rank_world(device) -> None:
    """Join a one-rank world on ``device`` (NCCL on a card, gloo on the
    CPU) when no process group is up: a manual comm mode on one process
    runs there, never without a process group."""
    import torch.distributed as dist

    from tpu_hpc_torch.runtime.sim import free_port

    if dist.is_initialized():
        return
    if device.type == "cuda":
        torch.cuda.set_device(device.index or 0)
    dist.init_process_group(
        "nccl" if device.type == "cuda" else "gloo",
        init_method=f"tcp://localhost:{free_port()}", world_size=1, rank=0)


def mesh_axes(world: int, model_cfg: llama2.LlamaConfig,
              data: Optional[int] = None,
              model: Optional[int] = None) -> Optional[dict]:
    """``{"data": d, "model": m}`` for ``world`` processes: the explicit
    sizes (one may be left out and is then the rest), or
    ``tp.auto_mesh_axes(world, heads, kv_heads, cap=4)``; None when the
    explicit sizes do not cover the world."""
    from tpu_hpc_torch.parallel import tp

    if data is None and model is None:
        axes = tp.auto_mesh_axes(world, model_cfg.n_heads,
                                 model_cfg.kv_heads, cap=4)
        return {"data": axes["data"], "model": axes.get("model", 1)}
    if model is None:
        model = world // data if world % data == 0 else 0
    if data is None:
        data = world // model if world % model == 0 else 0
    if data * model != world:
        return None
    return {"data": data, "model": model}


def pp_mesh_axes(world: int, data: Optional[int] = None) -> Optional[dict]:
    """``{"pipe": S}`` or ``{"data": d, "pipe": S}`` for ``world``
    processes: one stage a process (bench.py:522-524), S = world / d;
    None when d does not divide the world."""
    data = data or 1
    if world % data:
        return None
    return ({"pipe": world} if data == 1
            else {"data": data, "pipe": world // data})


def sp_mesh_axes(world: int, data: Optional[int] = None,
                 context: Optional[int] = None) -> Optional[dict]:
    """``{"data": d, "context": c}`` for ``world`` processes: bench.py's
    context = world, data 1 by default; one size given, the other is the
    rest; None when the sizes do not cover the world."""
    if data is None and context is None:
        data = 1
    if context is None:
        context = world // data if world % data == 0 else 0
    if data is None:
        data = world // context if world % context == 0 else 0
    if data * context != world:
        return None
    return {"data": data, "context": context}


if __name__ == "__main__":
    sys.exit(main())
