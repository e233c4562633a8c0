#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``tpu_hpc_torch``) on one card.

Run from the root of a checkout, on a machine with one NVIDIA H100:

    python3 chip_smoke.py

Phases, one JSON line each; any failure raises and exits non-zero:

  1. device      -- the card's name and count, and nvidia-smi's name and
                    power limit.
  2. build       -- nvcc builds every csrc/*.cu into one library, the
                    sources in parallel (seconds, and the -Xptxas -v
                    registers / spills per kernel).
  3. kernels     -- each paged-attention kernel against its plain PyTorch
                    version at the serving path's shapes (Llama-2-7B: 32
                    KV heads, group 1, head_dim 128, 16-token pages, 8
                    slots, 64-page views, ragged positions, one inactive
                    slot) and at a GQA shape (8 KV heads, group 8: the
                    70B attention dims), with bf16 and int8 pools whose
                    dead and scratch pages are NaN, under a bf16 q; and
                    the prefill's scalar route at the 7B chunk over a
                    float32 pool (float32 q) and under a bf16 q over an
                    f16 pool. Every row names the kernel the library
                    routed it to (the decode splits each slot's pages
                    into ``n_split`` runs and merges them; the prefill
                    has a wgmma route for 16-bit pools, a wgmma_int8
                    route for int8 pools under a 16-bit q and a scalar
                    one for the rest) and must pass checks/tolerance.py's
                    rule for q's dtype. Controls, each of which the bf16
                    rule must reject, at the 7B shape: the decode output
                    computed without the longest slot's last live page;
                    the prefill output computed without the chunk's last
                    live page; the int8 prefill output computed with each
                    live page's scales taken from the next live page.
                    Times from CUDA events over back-to-back calls
                    (``ms``, which a short kernel's Python wrapper can
                    set) and the kernels' own device time from
                    torch.profiler (``device_ms``; the decode's split
                    and combine kernels together); the library call
                    both ways (``library_ms``, ``library_device_ms``).
                    Bounds at the peak rate of q's dtype.
  4. flash       -- the flash-attention forward, dq and dk/dv kernels
                    against their plain versions under the per-element,
                    per-row-scaled rule of checks/tolerance.py: the
                    training path's shape (B 4, S 2048, 8 heads,
                    head_dim 128, causal, bf16, timed beside
                    scaled_dot_product_attention; and in fp16), the 70B
                    attention dims (64 query heads over 8 KV heads), S
                    1000 with q_offset 512, S 1000 with rows that see no
                    key, non-causal cross attention, a ragged GQA case
                    that crosses the backward kernels' 128-row tiles
                    (S 1100, 16 query heads over 2 KV heads, q_offset
                    300), a float32 case (timed too, its bound at the
                    card's fp32 rate), and the (q-chunk, kv-chunk)
                    pairs train_sp launches at their offsets: the
                    ring's 512-token chunks wholly visible, on the
                    diagonal and under GQA, zigzag's 256-token chunks,
                    and zigzag at context 1. Every case also runs dq
                    and dk/dv with accumulate= (added, unrounded, into
                    fp32 buffers, as the ring backward calls them), twice
                    from zero: the first sum is held against the plain
                    versions' fp32 result, the second must double it bit
                    for bit. Controls
                    at the training shape: outputs with their last rows
                    or keys zeroed must be rejected; two forwards that
                    round at the wrong place must be rejected too. dq,
                    dk and dv must come out bit-identical from a second
                    launch on the same inputs (no atomics).
  5. serve       -- run_replay on Llama-2-7B at full width and depth
                    (seeded random weights, bf16, paged pool, the CUDA
                    kernels): 16 requests of 100-500 prompt tokens, 32
                    new tokens each. The paged kernels' launch counts are
                    set to 0 just before and read just after.
     serve_int8  -- the same replay over an int8 pool (kv_quant="int8"):
                    its prefill launches take the wgmma_int8 route; the
                    line carries int8_logit_rmse at the 7B's attention
                    dims and page size (logit_rmse, as bench.py pins it).
     serve_spec  -- speculative decoding and seeded sampling on the paged
                    engine, kernel="cuda": (a) at 7B width, 2 layers,
                    float32, the greedy streams of ngram spec (k 4) and
                    of draft spec (a 1-layer draft) equal plain greedy
                    decode on every request, under "cuda" and "gather",
                    and so does the target drafting for itself (cuda),
                    which must accept at least half its drafts;
                    (b) the threefry keys, uniforms and categorical draws
                    on the card equal the CPU's bit for bit; (c) the
                    serve mix at temperature 0.8, top-p 0.95 through
                    ngram spec on the 7B: two replays and a reversed
                    submission order give the same tokens, the pools
                    drain, nothing rebuilds; (d) decode_heavy through
                    run_loadgen without and with ngram spec, twice each:
                    byte-identical virtual-clock summaries, beside the
                    acceptance, the virtual TTFT/ITL and the wall-clock
                    tokens/s; (e) the decode kernel over the verify's
                    pseudo-slots (row j at pos + j) at the 7B shape
                    against its plain version, with a control (no + j)
                    the bf16 rule must reject, timed beside its plain
                    version and SDPA over the gathered pages. The
                    verify and draft steps' decode launches and the
                    spec prefill's launches are counted; each part's
                    seconds and peak memory are printed.
     serve_tier_fleet -- serving past one engine. (a) The host-DRAM KV
                    tier at 7B, full depth: long_idle_sessions through
                    run_loadgen on a 120-page pool without a tier (the
                    return wave must shed), with 512 pinned host slots
                    (no return sheds; pages spill and refill) and on a
                    513-page pool (the tiered run's greedy tokens equal
                    it on every request both served); then a 500-token
                    chain spilled and prefetched back on a bf16 and an
                    int8 pool: refilled pages (and scales) bit-equal,
                    a control one page off rejected, the return
                    request's tokens after the refill equal the chain
                    that never left, both paged kernels launched over
                    the refilled pages, the refill's time and GB/s
                    beside a re-prefill of the prompt. (b) The fleet at
                    7B width (layers: FLEET_LAYERS): two replicas on
                    this card through run_fleet_loadgen over diurnal,
                    clean, with a replica killed (redispatched streams
                    byte-identical to clean), a clean swap (rolls
                    through both), a corrupt swap (rolls back, old
                    weights serve byte-identically); controls: a stream
                    altered after redispatch and a swap with
                    verify_tree skipped (the corrupt weights get
                    through). Each replica's paged-kernel launches, the
                    swap's place and checksum seconds. (c) The bench
                    Llama trained 2 updates with a checkpoint, restored
                    by load_serving_params (bit-equal, the same greedy
                    replay as the trainer's params), then the draft of
                    a 7B-width 2-layer float32 target: spec greedy
                    equals plain greedy.
  6. crosscheck  -- the same request mix at 7B width with 2 layers in
                    float32, through kernel="cuda" and kernel="gather",
                    and the no-cache forward for two requests: greedy
                    tokens identical.
  7. train       -- python -m tpu_hpc_torch.train's run_train on the
                    bench Llama at full width and depth (dim 1024, 8
                    layers, seq 2048, vocab 32000, bf16 compute, fp32
                    params, AdamW), microbatch 4 x accum 8, two epochs of
                    3 updates (the first is warm-up). The flash kernels'
                    launch counts are set to 0 just before and read just
                    after; each must equal layers x accum x updates.
  8. train_hybrid -- the distributed main path on this card: a one-rank
                    NCCL world in this process, a (data 1, model 1)
                    mesh, and run_train's hybrid plan (hybrid_pspecs +
                    SP; params through shard_params: DTensors under
                    FSDP2 per block and at the root; each block on local
                    shards under local_map, the flash kernels on local
                    heads) at train's seed, batch,
                    accumulation and updates. Losses equal train's
                    within HYBRID_LOSS_RTOL, each flash kernel launches
                    layers x accum x updates times (counts set to 0 just
                    before), update_s, tokens/s and peak memory beside
                    train's; the process group is destroyed after.
     train_sp    -- sequence parallelism: (a) ring, zigzag and Ulysses
                    attention at degree 4 on this card through the
                    in-process transport (every rank's shard here, the
                    ranks' schedules run step by step), at the training
                    shape (B 4, S 2048, 8 heads), at llama-long's S 8192
                    (B 1) and at a GQA shape (16 query heads over 2 KV
                    heads), bf16, causal: out and dq/dk/dv against the
                    one-device flash path over the whole sequence under
                    the bf16 rule, and against the exact values (dq
                    at the path's own D = rowsum(dO * O), position 0 left
                    out; the one-device path is held to them the same
                    way), a ring with every
                    kv_offset frozen at step 0's value that the rule
                    must reject, each flash kernel launched as
                    causal_live_pairs predicts, dq/dk/dv bit-identical
                    across two runs, forward+backward ms beside the
                    one-device flash path's; (b) run_train with each
                    --sp-mode on a one-rank NCCL world, a (data 1,
                    context 1) mesh (the degenerate ring, still the
                    SP path: FSDP2 over data x context, the batch split
                    over both, the flash kernels per live pair), at
                    train's seed, batch, accumulation and updates:
                    losses within HYBRID_LOSS_RTOL of train's, each flash
                    kernel launched layers x accum x updates x live
                    pairs times, update_s, tokens/s and peak memory
                    beside train's.
     train_pp    -- pipeline parallelism: (a) bench.py's five llama-pp
                    rows (1f1b, 1f1b on the flagship Llama, 1f1b-stash,
                    gpipe, interleaved-1f1b) through run_train at the
                    bench width (the stack model: vocab 32000, dim 1024,
                    8 heads, 8 layers, seq 2048, bf16; microbatches 8 x
                    4) on a one-rank NCCL world, a {"pipe": 1} mesh (one
                    stage, as bench.py runs on one chip), two epochs of 3
                    updates: tokens/s, MFU, update_s, peak memory and
                    bubble_fraction beside train's, each flash kernel
                    launched as the schedule implies (layers x
                    microbatches x stage forwards or backwards per
                    update); (b) each row at 4 stages through the
                    in-process pipe on this card (2 layers a stage;
                    interleaved-1f1b at 2 chunks of 1 layer): the first
                    update's loss against (a)'s (equal bits expected,
                    PP_LOSS_RTOL), its loss and every gradient under the
                    bf16 rule against the sequential oracle (microbatch
                    by microbatch, the flash kernels in it too), launches
                    as predicted, and a control the rule must reject:
                    the interleaved params left in sequential order.
     train_mpmd  -- the MPMD pipeline runtime (parallel/mpmd.py): (a)
                    bench.py's MPMD row through run_mpmd (the stack model
                    and the flagship Llama at the bench width, one stage
                    on this card, microbatches 8 x 4), one warm and 2
                    timed steps: losses, tokens/s, MFU, update_s, peak
                    memory, 0 programs rebuilt and the kernel library not
                    loaded again after warmup, each flash kernel launched
                    as predicted (a step: 128 forwards -- the forward and
                    the backward program's recompute -- 64 dq, 64 dk/dv);
                    (b) the stack model at 4 stages of 2 layers on this
                    card, each gate with a control it must reject: the
                    per-microbatch losses of loss_and_grads bit-equal to
                    the SPMD gpipe's (control: stages 1 and 2 swapped),
                    every stage and edge gradient under the bf16 rule
                    against the sequential oracle (control: stage 2's
                    gradient without microbatch 0), a clean run of 3
                    steps on one batch whose losses fall, and the chaos
                    runs (stage_kill_at=2:1, stage_nan_at=1:2): loss
                    stream and final params bit-equal to the clean run,
                    only the failed stage rebuilt, redispatched equal to
                    what the dead stage held (control: the killed stage
                    restored from the step-0 snapshot); launches as
                    predicted; each clean step's wall time and the share
                    spent in StageWorker.snapshot (timed from here), and
                    one step under torch.profiler.
     train_comm  -- the comm layer, bench.py's "llama dp bucketed-overlap
                    sync" row: (a) run_train with
                    comm_mode="bucketed_overlap" on a one-rank NCCL world,
                    a {"data": 1} mesh (comm_mode_mesh's shape on one card:
                    replicated params, 25 MB buckets reduced as the
                    backward produces them, copied in, handed out as
                    views), at train's seed, batch, accumulation and
                    updates: losses within HYBRID_LOSS_RTOL of train's
                    (bit-equality reported), each flash kernel launched
                    layers x accum x updates times, the port's counter at
                    updates x (n_buckets + 1) all-reduces, and one more
                    update under torch.profiler counting its NCCL
                    all-reduces (n_buckets + 1); update_s, tokens/s, MFU
                    and peak memory beside train's; (b) comm_mode="auto"
                    with no cost table: the planner's logged decision
                    (mode, source, bucket bytes); (c) "hierarchical" on
                    one card, refused in bench.py's words; (d)
                    run_comm_bench over the one-rank world, every flat and
                    overlap op at 10^3..10^8 elements: times, which at one
                    rank are launch cost (the bus bandwidth of a one-rank
                    world is 0 by the formula).
     train_vision -- the vision and weather workloads at full width
                    (train/vision.py): (a) bench.py's "unet ddp" row on a
                    one-rank NCCL world ({"data": 1}; ERA5 181 x 360 x
                    20, base 64, bf16, 8 samples, lr 1e-3, the BatchNorm
                    moments all-reduced over the data group), two epochs
                    of 3 updates whose losses must be finite and fall,
                    and one more update under torch.profiler (device time
                    by family, the BatchNorm all-reduces, the idle
                    share); (b) the ViT at examples/03's size (64 x 128,
                    patch 4, embed 256, depth 6, 8 heads, bf16, batch 8)
                    through the flash kernels without a causal mask (head
                    dim 32), each kernel's launches set to 0 just before
                    and read just after, equal to depth x accum x
                    updates, plus one profiled update (the kernels'
                    device ms and share of the update); (c) one ViT
                    forward and backward through the kernels: every
                    attention call's output, dq, dk and dv against the
                    plain versions on that call's inputs under the bf16
                    rule, and the model's output and gradient as close to
                    the float32 run as the plain attention's (within
                    MODEL_VS_REF); the same ViT with the last rows of each
                    attention output zeroed must be rejected;
                    (d) ResNet-18 on CIFARSynthetic (batch 32), two epochs
                    of 3 updates. The batches are drawn on the card. Each
                    part prints its seconds, peak memory, losses and
                    samples/s (the second epoch's).
     train_domain -- domain parallelism: the U-Net (base 64, 20 channels,
                    bf16) on a 176 x 360 grid (16 x 11 rows, the 1-degree
                    band that lat % 16 admits) over 4 latitude bands
                    through the in-process halo transport, one training
                    forward and backward against the one-device U-Net on
                    the same grid, batch and trees: in float32 (TF32 off)
                    output and stats under the float32 rule, gradients
                    within DOMAIN_GRAD_REL_RMS; in bf16 the loss and every
                    BatchNorm running stat under the bf16 rule, output and
                    gradients tracking the float32 values as the
                    one-device run's do; the same runs with no halos
                    (naive_split_conv2d) must be rejected by those checks.
     train_long  -- bench.py's llama-long row through run_train: the bench
                    Llama at seq 8192, microbatch 1 x accum 8, two epochs
                    of one update, each flash kernel launched layers x
                    accum x updates times (counts set to 0 just before).
  9. train_profile -- one more bench-Llama update under torch.profiler:
                    device time by kernel family, the top kernels, the
                    card's idle share. Reports; gates nothing.
 10. train_crosscheck -- bench width in float32, 2 layers, seq 512,
                    batch 4 with accum 2: 3 updates from the same params
                    and batches through the flash kernels and through
                    the reference attention; the first update's
                    gradients, the losses and the params agree.
 11. train_resilience -- the bench Llama at full width and depth with
                    the numeric-health guard and checkpoints
                    (torch.distributed.checkpoint): (a) guard skip under
                    nan_loss_at_step=3 gives one poisoned verdict, at
                    data index 3, and leaves the state bit-identical;
                    (b) a fresh trainer resumed from the epoch-2
                    checkpoint ends epoch 3 bit-identical to the
                    uninterrupted run (and the manager's save, save_now
                    and restore_latest times and the bytes of a step);
                    (c) bitflip_ckpt_at_step falls back to the older step
                    and quarantines the flipped one; (d) the supervised
                    CLI (2 layers) preempted at step 2 exits 75, resumes
                    and exits 0; (e) NaN and inf planted in q, k or v:
                    the flash forward, dq and dk/dv, the prefill (the
                    16-bit route, and the scalar route's float32 and
                    mixed bf16-over-f16 cases) and the decode (bf16 and
                    int8 pools, whose dead entries and pages past the
                    last live one are NaN) give the non-finite rows of
                    their plain versions. Then the update time with the
                    guard off and on skip, in turns.
 12. obs_capture -- observability on the card. (a) Llama-2-7B at full
                    width and depth (bf16, 8 slots, 16-token pages, the
                    cuda kernels) serves the colocate scenario (24
                    requests) through run_loadgen with the server's
                    capture (--capture-dir: AnomalyCapture(dir,
                    n_steps=8)): exactly one capture_triggered record,
                    reason stall, keyed to a stall record's trace id; the
                    flight dump; the torch.profiler window closed by
                    itself, its Chrome trace holding as many
                    paged_decode_split_kernel (and, when the decode
                    splits, paged_decode_combine_kernel) device events as
                    the decode wrapper launched in it; the device_memory
                    record's hbm_peak_bytes equal to max_memory_allocated
                    at the trigger and under the card's total; python -m
                    tpu_hpc_torch.obs.trace --json --chrome over the run
                    log: every request complete or shed, 0 orphan spans,
                    >= 95% of TTFT attributed at p50/p95/p99, the Chrome
                    file loads. Controls it must reject: steady triggers
                    no capture; a window over kernel="gather" (2 layers)
                    holds no paged-kernel event. (b) The bench Llama
                    through Trainer.fit, microbatch 4 x accum 8, one
                    update an epoch: profile=True over updates 2-3 of 5
                    (each flash kernel's device events equal its
                    wrapper's launches in the window; no profiler left
                    open), then capture_on_anomaly under the straggler
                    fault straggler_ms=400 at step 7 (9 updates): one
                    capture keyed to the first stall, a flight dump, the
                    analyzer's step timelines with 0 orphan spans. The
                    update time with the profiler on and off, and each
                    window's stop + export seconds, are readings.
 13. ops         -- the operations path. (a) The serve phase's replay
                    (Llama-2-7B, full width and depth, the same requests)
                    through run_replay(disagg=True) with both tiers on
                    this card: the prefill tier's paged prefill kernel
                    and the decode tier's split/combine kernels, the KV
                    hop a reshard plan per bucket, bounded by the
                    planner's "auto" chunk. Gates: the greedy
                    tokens equal the serve phase's on every request;
                    nothing made after warmup (no plan, buffer or
                    program); kv_transfers equal the requests' hop
                    pieces and kv_transfer_bytes the plans' measured and
                    modeled wire bytes; after each prompt's hop the
                    decode tier's pages at its own page ids equal the
                    prefill tier's bit for bit; each tier launched only its
                    kernel, as many times as the wrappers count (the
                    prefill on its wgmma route). Control the gates must
                    reject: every hop scattering at the prefill tier's
                    page ids. Then the serve_int8 replay the same way
                    over an int8 pool (its pages' scales hop with them;
                    the prefill tier on the wgmma_int8 route), held to
                    serve_int8's tokens. TTFT/ITL, the hop's ms and peak
                    memory are readings. (b) The bench Llama's TrainState (FSDP2
                    params on a one-rank NCCL mesh, fp32 params and
                    AdamW moments, about 2.02 GB) moved by the reshard
                    engine to plain tensors on this card and back, under
                    max_inflight_bytes = total / 4: bit-equal both ways,
                    the rise in max_memory_allocated within the plan's
                    modeled peak, and a replay of the held plan making
                    no allocation; plan ms, execute ms and GB/s. (c) The
                    TopologyCoordinator drives the bench Llama (FSDP2,
                    the flash kernels) through slice_down_at_step=2,
                    slice_up_at_step=4 over 6 updates on the one-rank
                    world (both morphs 1 -> 1): 2 morphs, 3 segments, 0
                    restarts, the loss stream bit-identical to a
                    fixed-topology run, each flash kernel launched
                    layers x accum x updates times (384).
 14. native_tools -- the last modules of the port. (a) The repo's own
                    Markdown (*.md at the root and under docs/) through
                    native.prepare's byte tokenizer into a corpus, then
                    run_train --tokens-file on the bench Llama (microbatch
                    4 x accum 8, 6 updates: 192 windows of 2,049 tokens,
                    no epoch wrap): each flash kernel launched 384 times,
                    the first update's loss within 0.5 of ln(32000) and
                    the sixth below it, and the CRC of every batch served
                    (recorded here, around the reader) equal to a fresh
                    reader's batch_at at that step;
                    tokens/s and update seconds beside the train phase's
                    TokenStream run. (b) checks.fit for the bench Llama
                    on this card: param + grad + AdamW bytes equal, to
                    the byte, the tensors (a)'s optimizer received at its
                    first update; with do_compile=True it runs one
                    update and reports its own peak (max_memory_allocated
                    less what the process held before it) beside its
                    analytic total (a reading). (c) check_environment()
                    on the card: versions, the one-rank NCCL all-reduce
                    exact, the microbenchmark's TFLOP/s and GB/s beside
                    the h100-sxm row (above 105% of it fails); then
                    doctor.diagnose("7b", chips=8). (d) kernels.autotune:
                    decode over n_split 1-16 and auto at the 7B decode
                    shape, fwd and grad over the kFwdStages builds at the
                    bench attention shape (grad also records kBwdStep,
                    refused by its wgmma layout), every candidate held to
                    the plain versions; the tables ranked by the
                    candidates' kernels' device time (torch.profiler,
                    the wall time beside it) and the library pick's
                    place in them.

The flash phase also holds the ViT's attention: B 8, S 512 (and a
ragged S 500), 8 heads of head_dim 32, no causal mask, with the
zeroed-rows controls and the determinism check (the two rounding
controls are read there, not gated), the S 512 case timed beside SDPA.

Then the per-kernel summary line (the flash rows with their launches in
train_sp (b) by mode, in train_pp (a) by bench row, in train_mpmd (a) by
model, in train_comm (a), in
train_vision (b) and in train_long, and the ViT case's times; every row
with its launches in obs_capture and in ops; the flash and decode rows
with theirs in native_tools), nvidia-smi's
line, and last the
one-line result ``{"ok": true, "device": {...}}``. Without a CUDA device
(or without the rest of the repository beside it) it exits non-zero
before printing any result.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import re
import subprocess
import sys
import time

# Every kernel output is held to tpu_hpc_torch/checks/tolerance.py's
# rule for its dtype, per element and scaled by each row's own magnitude
# (see there).
PAGED_SOURCE = "tpu_hpc_torch/csrc/paged_attention.cu"
FLASH_SOURCE = "tpu_hpc_torch/csrc/flash_attention.cu"
# The summary line's entry for the prefill's int8 route (an int8 pool
# under a bf16 q: paged_prefill_int8_kernel), beside the bf16 one.
INT8_PREFILL = "paged_prefill_attention_int8"
SOURCES = {
    "paged_decode_attention": PAGED_SOURCE,
    "paged_prefill_attention": PAGED_SOURCE,
    INT8_PREFILL: PAGED_SOURCE,
    "flash_attention_fwd": FLASH_SOURCE,
    "flash_attention_dq": FLASH_SOURCE,
    "flash_attention_dkv": FLASH_SOURCE,
}
REPLACES = {
    "paged_decode_attention":
        "tpu_hpc/kernels/paged_attention.py:101",   # _decode_kernel
    "paged_prefill_attention":
        "tpu_hpc/kernels/paged_attention.py:237",   # _prefill_kernel
    INT8_PREFILL:
        "tpu_hpc/kernels/paged_attention.py:237",   # _prefill_kernel, quant
    "flash_attention_fwd":
        "tpu_hpc/kernels/attention.py:148",         # _flash_kernel
    "flash_attention_dq":
        "tpu_hpc/kernels/attention.py:402",         # _flash_dq_kernel
    "flash_attention_dkv":
        "tpu_hpc/kernels/attention.py:455",         # _flash_dkv_kernel
}


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


# Mangled template arguments the kernels take, and their short names.
MANGLED_TYPES = (("13__nv_bfloat16", "bf16"), ("6__half", "f16"),
                 ("f", "f32"), ("a", "int8"))


def template_args(mangled: str) -> str:
    """A kernel's mangled template arguments, readable: element types,
    integers and booleans (``13__nv_bfloat16Li128ELb1E`` -> ``bf16, 128,
    true``); anything else is kept as it stands."""
    out = []
    while mangled:
        for code, name in MANGLED_TYPES:
            if mangled.startswith(code):
                out.append(name)
                mangled = mangled[len(code):]
                break
        else:
            n = re.match(r"L([ib])(\d+)E", mangled)
            if not n:
                out.append(mangled)
                break
            kind, value = n.groups()
            out.append(value if kind == "i" else
                       ("false", "true")[int(value)])
            mangled = mangled[n.end():]
    return ", ".join(out)


def ptxas_summary(log: str) -> list:
    """Registers, spills and static shared memory per compiled kernel,
    from nvcc's -Xptxas -v report."""
    rows, cur = [], None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            k = re.search(
                r"(?<=\d)((?:paged|flash)_\w+?_kernel)(?:I(\w+?)EEv|E)",
                m.group(1))
            name = m.group(1)
            if k:
                name = k.group(1) + (f"<{template_args(k.group(2))}>"
                                     if k.group(2) else "")
            cur = {"kernel": name}
            rows.append(cur)
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            cur["spill_stores"], cur["spill_loads"] = map(int, m.groups())
        m = re.search(r"Used (\d+) registers", line)
        if m:
            cur["registers"] = int(m.group(1))
            s = re.search(r"(\d+) bytes smem", line)
            cur["smem_static"] = int(s.group(1)) if s else 0
    return rows


def time_ms(fn, iters: int, warmup: int = 3) -> float:
    """Mean ms per call over ``iters`` calls, CUDA events, warmed up."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, kernel: str, iters: int = 20) -> float:
    """Mean device time (ms) per call of the kernels whose names contain
    ``kernel`` (every kernel for ""), from torch.profiler over ``iters``
    calls after a warm-up call: the kernels' own time, without their
    wrapper's host time. None if the profiler recorded no such kernel."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA and kernel in e.key]
    if not events:
        return None
    return sum(e.self_device_time_total for e in events) / 1e3 / iters


CHIP = None  # the card's row of tpu_hpc_torch/checks/roofline.py


def bound(bytes_: int, flops: int, dtype) -> tuple:
    """Least time (ms) for the work on this card, from its published
    peaks in the roofline table, and which bound sets it."""
    t_bytes = bytes_ / CHIP.hbm_bytes_per_s
    t_flops = flops / CHIP.peak_flops(dtype)
    return 1e3 * max(t_bytes, t_flops), (
        "bytes" if t_bytes >= t_flops else "operations"
    )


# ---------------------------------------------------------------------
# Phase 3: kernel cases
# ---------------------------------------------------------------------


def _pool(torch, gen, dev, num_blocks, bs, hkv, d, live, pool):
    """Random K/V pools of dtype ``pool`` (a torch dtype name, or
    "int8": quantized, one f32 scale per page); every page outside
    ``live`` (scratch page 0 included) is NaN -- for int8 pools, its
    scale is NaN."""
    shape = (num_blocks, bs, hkv, d)
    k = torch.randn(shape, generator=gen, device=dev)
    v = torch.randn(shape, generator=gen, device=dev)
    dead = torch.ones(num_blocks, dtype=torch.bool, device=dev)
    dead[torch.as_tensor(sorted(live), device=dev, dtype=torch.long)] = False
    if pool == "int8":
        from tpu_hpc_torch.kernels.paged_attention import quantize_pages_int8

        k, ksc = quantize_pages_int8(k)
        v, vsc = quantize_pages_int8(v)
        ksc[dead] = float("nan")
        vsc[dead] = float("nan")
        return k, v, dict(k_scale=ksc, v_scale=vsc)
    k[dead] = float("nan")
    v[dead] = float("nan")
    dtype = getattr(torch, pool)
    return k.to(dtype), v.to(dtype), {}


DECODE_POS = (1023, 517, 64, 15, 300, 811, 0, 700)


def decode_case(torch, dev, hkv, g, quant, seed=0, pos=DECODE_POS,
                extra=0):
    """8 slots over a 513-page pool, 64-page views in 96-wide table rows
    (the engine's width at max_seq_len 1024 with a 512 bucket). Each
    active slot's pages are live up to position ``pos + extra`` (a
    verify step writes ``extra`` positions past ``pos``)."""
    slots, d, bs, mb, width, num_blocks = 8, 128, 16, 64, 96, 513
    gen = torch.Generator(device=dev).manual_seed(seed)
    pos = torch.tensor(pos, dtype=torch.int32)
    active = torch.tensor([1, 1, 1, 1, 1, 1, 0, 1], dtype=torch.int32)
    perm = torch.randperm(num_blocks - 1, generator=torch.Generator()
                          .manual_seed(seed)) + 1
    tables = torch.empty((slots, width), dtype=torch.int32)
    live, nxt = set(), 0
    for s in range(slots):
        n_live = (int(pos[s]) + extra) // bs + 1 if active[s] else 0
        row = perm[nxt:nxt + n_live].tolist()
        nxt += n_live
        live.update(row)
        tables[s, :n_live] = torch.tensor(row, dtype=torch.int32)
    dead_pages = [p for p in range(num_blocks) if p not in live]
    for s in range(slots):  # dead entries and inactive rows: NaN pages
        n_live = (int(pos[s]) + extra) // bs + 1 if active[s] else 0
        tables[s, n_live:] = torch.tensor(
            [dead_pages[(s + j) % len(dead_pages)]
             for j in range(width - n_live)], dtype=torch.int32)
    k, v, scales = _pool(torch, gen, dev, num_blocks, bs, hkv, d, live,
                         "int8" if quant else "bfloat16")
    q = torch.randn((slots, hkv, g, d), generator=gen, device=dev)
    args = (q.bfloat16(), k, v, tables.to(dev), pos.to(dev), active.to(dev))
    kw = dict(block_size=bs, max_blocks=mb, **scales)
    esize = k.element_size()
    page_bytes = bs * hkv * d * esize + (4 if quant else 0)
    n_bytes = 2 * q.numel() * 2 + 8 * slots
    flops = 0
    for p, a in zip(pos.tolist(), active.tolist()):
        if a:
            pages = p // bs + 1
            n_bytes += 2 * pages * page_bytes + 4 * pages
            flops += 4 * hkv * g * (p + 1) * d
    return args, kw, (n_bytes, flops)


def prefill_case(torch, dev, hkv, g, pool, start, q_dtype, seed=0):
    """A 256-token chunk at ``start`` over one 96-wide table row, q in
    ``q_dtype`` over a ``pool`` pool (see _pool)."""
    bucket, d, bs, mb, width, num_blocks = 256, 128, 16, 64, 96, 513
    gen = torch.Generator(device=dev).manual_seed(seed)
    ctx_pages = (start + bucket - 1) // bs + 1
    perm = (torch.randperm(num_blocks - 1, generator=torch.Generator()
                           .manual_seed(seed)) + 1).tolist()
    live = perm[:ctx_pages]
    table = torch.tensor(
        live + perm[ctx_pages:ctx_pages + width - ctx_pages],
        dtype=torch.int32,
    )
    k, v, scales = _pool(torch, gen, dev, num_blocks, bs, hkv, d, live, pool)
    q = torch.randn((hkv, bucket, g, d), generator=gen, device=dev)
    args = (q.to(q_dtype), k, v, table.to(dev), start)
    kw = dict(block_size=bs, max_blocks=mb, **scales)
    page_bytes = bs * hkv * d * k.element_size() + (4 if scales else 0)
    n_bytes = (2 * q.numel() * args[0].element_size()
               + 2 * ctx_pages * page_bytes + 4 * ctx_pages)
    keys = sum(start + b + 1 for b in range(bucket))
    return args, kw, (n_bytes, 4 * hkv * g * keys * d)


def library_decode(torch, args, kw):
    """scaled_dot_product_attention over the pre-gathered contiguous
    view (the yardstick; the port never calls it)."""
    from tpu_hpc_torch.kernels.paged_attention import dequantize_pages_int8

    q, k, v, tables, pos, active = args
    slots, hkv, g, d = q.shape
    ids = tables[:, :kw["max_blocks"]].long()
    n_keys = ids.shape[1] * kw["block_size"]

    def view(pages, sc):
        x = pages[ids]
        if sc is not None:
            x = dequantize_pages_int8(x, sc[ids])
        x = x.to(q.dtype).reshape(slots, n_keys, hkv, d)
        x = torch.nan_to_num(x).permute(0, 2, 1, 3)
        return x.repeat_interleave(g, dim=1).contiguous()

    kv = view(k, kw.get("k_scale")), view(v, kw.get("v_scale"))
    qq = q.reshape(slots, hkv * g, 1, d)
    cols = torch.arange(n_keys, device=q.device)
    mask = (cols[None, :] <= pos.long()[:, None])[:, None, None, :]
    sdpa = torch.nn.functional.scaled_dot_product_attention
    return lambda: sdpa(qq, kv[0], kv[1], attn_mask=mask)


def library_prefill(torch, args, kw):
    from tpu_hpc_torch.kernels.paged_attention import dequantize_pages_int8

    q, k, v, table, start = args
    hkv, bucket, g, d = q.shape
    ctx = start + bucket
    ids = table[:(ctx - 1) // kw["block_size"] + 1].long()

    def view(pages, sc):
        x = pages[ids]
        if sc is not None:
            x = dequantize_pages_int8(x, sc[ids])
        x = x.to(q.dtype).reshape(-1, hkv, d)[:ctx].permute(1, 0, 2)
        return x.repeat_interleave(g, dim=0)[None].contiguous()

    kv = view(k, kw.get("k_scale")), view(v, kw.get("v_scale"))
    qq = q.permute(0, 2, 1, 3).reshape(1, hkv * g, bucket, d).contiguous()
    qpos = start + torch.arange(bucket, device=q.device)
    mask = torch.arange(ctx, device=q.device)[None, :] <= qpos[:, None]
    sdpa = torch.nn.functional.scaled_dot_product_attention
    return lambda: sdpa(qq, kv[0], kv[1], attn_mask=mask)


def prefill_control(torch, args, kw, want) -> None:
    """The 7B chunk's output computed without the chunk's last live page
    (a kernel that stops one page short), held to the rule the kernel is
    held to: it must be rejected."""
    from tpu_hpc_torch.checks.tolerance import compare
    from tpu_hpc_torch.kernels import paged_attention as pa

    q, _, _, _, start = args
    ctx_pages = (start + q.shape[1] - 1) // kw["block_size"] + 1
    short = dict(kw, max_blocks=ctx_pages - 1)
    bad = pa.paged_prefill_attention_ref(*args, **short)
    r = compare(bad, want, torch.bfloat16)
    emit("kernels_control", control="prefill_without_last_live_page",
         start=start, rejected=not r["ok"],
         **{k: v for k, v in r.items() if k != "ok"})
    if r["ok"]:
        raise SystemExit(f"prefill control: the tolerance accepts an "
                         f"output without the last live page ({r})")


def next_live_page_scales(torch, kw, table, n_live) -> dict:
    """``kw`` with each of the first ``n_live`` table entries' K and V
    scales taken from the next live entry's page (the last from the
    first's): a kernel that reads the scale of the wrong page."""
    live = table[:n_live].long()
    nxt = torch.roll(live, -1)
    out = dict(kw)
    for name in ("k_scale", "v_scale"):
        sc = kw[name].clone()
        sc[live] = kw[name][nxt]
        out[name] = sc
    return out


def scale_control(torch, args, kw, want) -> None:
    """The 7B int8 chunk computed with each live page's scales taken
    from the next live page, held to the rule the kernel is held to: it
    must be rejected."""
    from tpu_hpc_torch.checks.tolerance import compare
    from tpu_hpc_torch.kernels import paged_attention as pa

    q, _, _, table, start = args
    n_live = (start + q.shape[1] - 1) // kw["block_size"] + 1
    bad = pa.paged_prefill_attention_ref(
        *args, **next_live_page_scales(torch, kw, table, n_live))
    r = compare(bad, want, torch.bfloat16)
    emit("kernels_control", control="prefill_int8_scales_of_next_live_page",
         start=start, rejected=not r["ok"],
         **{k: v for k, v in r.items() if k != "ok"})
    if r["ok"]:
        raise SystemExit(f"int8 scale control: the tolerance accepts an "
                         f"output with the wrong pages' scales ({r})")


def decode_control(torch, args, kw, want) -> None:
    """The 7B decode output computed without the longest slot's last
    live page (a kernel that stops a run one page short), held to the
    rule the kernel is held to: it must be rejected."""
    from tpu_hpc_torch.checks.tolerance import compare
    from tpu_hpc_torch.kernels import paged_attention as pa

    q, k_pages, v_pages, tables, pos, active = args
    bs = kw["block_size"]
    live = torch.where(active > 0, pos, torch.full_like(pos, -1))
    slot = int(live.argmax())
    short = pos.clone()
    short[slot] = int(pos[slot]) // bs * bs - 1
    bad = pa.paged_decode_attention_ref(q, k_pages, v_pages, tables, short,
                                        active, **kw)
    r = compare(bad, want, torch.bfloat16)
    emit("kernels_control", control="decode_without_last_live_page",
         slot=slot, pos=int(pos[slot]), rejected=not r["ok"],
         **{k: v for k, v in r.items() if k != "ok"})
    if r["ok"]:
        raise SystemExit(f"decode control: the tolerance accepts an "
                         f"output without the last live page ({r})")


# Kernel cases: (wrapper, shape, (kv heads, group), pool, q dtype,
# start: None for the decode). The 7B and GQA shapes over bf16 and int8
# pools, every prefill at chunk 0 and at 256 (timed); and, timed at the
# 7B chunk at 256, the prefill's scalar route over a float32 pool and
# under a bf16 q over an f16 pool.
def kernel_cases() -> list:
    cases = []
    for name, shape in (("7b", (32, 1)), ("gqa", (8, 8))):
        for pool in ("bfloat16", "int8"):
            cases.append(("paged_decode_attention", name, shape, pool,
                          "bfloat16", None))
            for start in (0, 256):
                cases.append(("paged_prefill_attention", name, shape, pool,
                              "bfloat16", start))
    cases.append(("paged_prefill_attention", "7b", (32, 1), "float32",
                  "float32", 256))
    cases.append(("paged_prefill_attention", "7b", (32, 1), "float16",
                  "bfloat16", 256))
    return cases


def kernel_phase(torch, dev, lib) -> dict:
    from tpu_hpc_torch.checks.tolerance import TOLERANCES, compare
    from tpu_hpc_torch.kernels import paged_attention as pa
    from tpu_hpc_torch.kernels.attention import DTYPE_CODES

    main_rows = {}
    for kname, shape_name, (hkv, g), pool, q_name, start in kernel_cases():
        q_dtype = getattr(torch, q_name)
        if kname == "paged_decode_attention":
            args, kw, (nb, fl) = decode_case(torch, dev, hkv, g,
                                             pool == "int8")
            fn, ref = pa.paged_decode_attention, pa.paged_decode_attention_ref
            library, kernel_name = library_decode, "paged_decode"
            route = "split"
        else:
            args, kw, (nb, fl) = prefill_case(torch, dev, hkv, g, pool, start,
                                              q_dtype)
            fn, ref = pa.paged_prefill_attention, pa.paged_prefill_attention_ref
            library, kernel_name = library_prefill, "paged_prefill"
            route = pa.paged_prefill_route(args[0].dtype, args[1].dtype,
                                           args[0].shape[3], kw["block_size"])
        out = fn(*args, **kw)
        torch.cuda.synchronize()
        want = ref(*args, **kw)
        if not torch.isfinite(out).all():
            raise SystemExit(f"{kname} {shape_name}: non-finite output")
        readings = compare(out, want, q_dtype)
        row = {
            "kernel": kname, "shape": shape_name, "pool": pool,
            "q_dtype": q_name, "route": route,
            "max_abs_err": readings["max_abs_err"],
            "tolerance": dataclasses.asdict(TOLERANCES[q_dtype]),
            "readings": readings,
        }
        if start is None:
            q = args[0]
            row["n_split"] = pa.paged_decode_splits(
                q.shape[0], q.shape[1], q.shape[2], kw["max_blocks"])
        else:
            row.update(start=start, tile_rows=(
                lib.tpuhpc_prefill_tile_rows(
                    hkv, args[0].shape[1], g, args[0].shape[3],
                    kw["block_size"], DTYPE_CODES[args[0].dtype],
                    DTYPE_CODES[args[1].dtype])))
        if not readings["ok"]:
            emit("kernels", **row)
            raise SystemExit(f"{kname} {shape_name} pool={pool} q={q_name} "
                             f"start={start}: outside the {q_name} rule "
                             f"{readings}")
        if kname == "paged_decode_attention" and out[args[5] == 0].any():
            raise SystemExit(f"{kname}: inactive slot not exact zeros")
        if shape_name == "7b" and pool == "bfloat16" and start in (None, 256):
            control = prefill_control if start else decode_control
            control(torch, args, kw, want)
        if shape_name == "7b" and pool == "int8" and start == 256:
            scale_control(torch, args, kw, want)
        if start in (None, 256):
            # The peak rate is that of q's dtype, whatever the route
            # does inside: float32 only when q (and so the pool) is.
            bound_ms, bound_by = bound(nb, fl, q_dtype)
            lib_fn = library(torch, args, kw)
            row.update(
                ms=time_ms(lambda: fn(*args, **kw), iters=50),
                device_ms=device_ms(lambda: fn(*args, **kw), kernel_name),
                plain_ms=time_ms(lambda: ref(*args, **kw), iters=5, warmup=1),
                library_ms=time_ms(lib_fn, iters=50),
                library_device_ms=device_ms(lib_fn, ""),
                bound_ms=bound_ms, bound_by=bound_by,
                bytes=nb, flops=fl,
            )
            if shape_name == "7b" and pool == "bfloat16":
                main_rows[kname] = row
            if shape_name == "7b" and pool == "int8" and start == 256:
                main_rows[INT8_PREFILL] = row
        emit("kernels", **row)
        del args, kw, out, want
        torch.cuda.empty_cache()
    return main_rows


# ---------------------------------------------------------------------
# Phase 4: flash-attention kernels
# ---------------------------------------------------------------------

# (name, b, sq, sk, hq, hkv, d, causal, q_offset, kv_offset, dtype, timed)
FLASH_CASES = (
    ("train_main", 4, 2048, 2048, 8, 8, 128, True, 0, 0, "bfloat16", True),
    ("train_main_fp16", 4, 2048, 2048, 8, 8, 128, True, 0, 0, "float16",
     False),
    ("gqa_70b_dims", 1, 2048, 2048, 64, 8, 128, True, 0, 0, "bfloat16",
     False),
    ("ragged_q_offset", 2, 1000, 1000, 8, 8, 128, True, 512, 0, "bfloat16",
     False),
    ("fully_masked_rows", 2, 1000, 1000, 8, 8, 128, True, 0, 512,
     "bfloat16", False),
    ("non_causal_cross", 2, 1000, 1500, 8, 8, 128, False, 0, 0, "bfloat16",
     False),
    ("ragged_gqa_tiles", 2, 1100, 1100, 16, 2, 128, True, 300, 0, "bfloat16",
     False),
    ("float32", 1, 1000, 1000, 8, 8, 128, True, 0, 0, "float32", True),
    # The pairs sequence parallelism launches (train_sp): the ring at
    # degree 4 on the training shape (512-token shards: rank 3's chunk
    # against rank 0's, wholly visible; rank 1's own chunk, the diagonal
    # at offset 512; GQA), zigzag's 256-token chunks (chunk 7 against
    # chunk 3, and its own), and zigzag at context 1 (chunk 1 of 1024
    # against chunk 0).
    ("ring_past_chunk", 4, 512, 512, 8, 8, 128, True, 1536, 0, "bfloat16",
     False),
    ("ring_diagonal_chunk", 4, 512, 512, 8, 8, 128, True, 512, 512,
     "bfloat16", False),
    ("ring_past_chunk_gqa", 2, 512, 512, 16, 2, 128, True, 1536, 0,
     "bfloat16", False),
    ("zigzag_past_chunk", 4, 256, 256, 8, 8, 128, True, 1792, 768,
     "bfloat16", False),
    ("zigzag_diagonal_chunk", 4, 256, 256, 8, 8, 128, True, 1792, 1792,
     "bfloat16", False),
    ("zigzag_context1_chunk", 4, 1024, 1024, 8, 8, 128, True, 1024, 0,
     "bfloat16", False),
    # The ViT's attention (train_vision): B 8, S 512 (16 x 32 patches), 8
    # heads of head_dim 32 (embed 256), no causal mask -- head_dim 32
    # takes each wgmma kernel's kD = 64 template, half of each tile
    # padded -- timed beside SDPA; and a ragged S 500.
    ("vit_noncausal", 8, 512, 512, 8, 8, 32, False, 0, 0, "bfloat16", True),
    ("vit_noncausal_ragged", 8, 500, 500, 8, 8, 32, False, 0, 0, "bfloat16",
     False),
)
# The cases that run the controls and the determinism check, and the row
# (forward, dq) or key (dk/dv) from which a control zeroes a kernel's
# output: the last 148 of the training shape's 2048, where causal
# attention's values are the smallest; any rows without a mask.
CONTROL_CASES = {"train_main": 1900, "vit_noncausal": 500,
                 "vit_noncausal_ragged": 488}
# The flash kernels' device-time names (torch.profiler), by wrapper.
FLASH_KERNEL_NAMES = {
    "flash_attention_fwd": "flash_fwd",
    "flash_attention_dq": "flash_dq",
    "flash_attention_dkv": "flash_dkv",
}


def visible_pairs(sq, sk, causal, q_offset, kv_offset) -> int:
    """(row, key) pairs the mask leaves visible, per (batch, q head)."""
    if not causal:
        return sq * sk
    return sum(min(sk, max(0, q_offset + i - kv_offset + 1))
               for i in range(sq))


def flash_work(case) -> dict:
    """(bytes, flops) per kernel: each input read once and each output
    written once; 4, 6 and 8 x head_dim FLOPs per visible (row, key)
    pair for the forward (QK^T, PV), dq (QK^T, dO V^T, dS K) and dk/dv
    (those and P^T dO, dS^T Q)."""
    _, b, sq, sk, hq, hkv, d, causal, qo, ko, dtype, _ = case
    e = 4 if dtype == "float32" else 2
    pairs = b * hq * visible_pairs(sq, sk, causal, qo, ko)
    qb, kvb, rb = b * sq * hq * d * e, b * sk * hkv * d * e, b * sq * hq * 4
    return {
        "flash_attention_fwd": (2 * qb + 2 * kvb + rb, 4 * d * pairs),
        "flash_attention_dq": (3 * qb + 2 * kvb + 2 * rb, 6 * d * pairs),
        "flash_attention_dkv": (2 * qb + 4 * kvb + 2 * rb, 8 * d * pairs),
    }


def out_with_rounded_scores(torch, q, k, v, causal=True):
    """The forward with the scores rounded to the input dtype before the
    softmax (the kernels round only P, after exp). Equal q and KV heads,
    no offsets."""
    d = q.shape[-1]
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * d ** -0.5
    s = s.to(q.dtype).float()
    if causal:
        n = s.shape[-1]
        keep = torch.ones(n, n, dtype=torch.bool, device=q.device).tril()
        s = s.masked_fill(~keep, float("-inf"))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype).float(), v.float())


def out_with_narrow_accumulator(torch, q, k, v, tile=64, causal=True):
    """The forward walked over 64-key tiles as the kernel walks them, but
    with the running output kept in the input dtype between tiles (the
    kernels keep it in fp32). Equal heads, no offsets."""
    b, n, h, d = q.shape
    qf = q.float() * d ** -0.5
    rows = torch.arange(n, device=q.device)[:, None]
    m = torch.full((b, h, n, 1), float("-inf"), device=q.device)
    l = torch.zeros((b, h, n, 1), device=q.device)
    acc = torch.zeros((b, h, n, d), dtype=q.dtype, device=q.device)
    for j0 in range(0, n, tile):
        kt, vt = k[:, j0:j0 + tile].float(), v[:, j0:j0 + tile]
        s = torch.einsum("bqhd,bkhd->bhqk", qf, kt)
        if causal:
            cols = j0 + torch.arange(kt.shape[1], device=q.device)[None, :]
            s = s.masked_fill(cols > rows, float("-inf"))
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new)
        l = l * alpha + p.sum(dim=-1, keepdim=True)
        pv = torch.einsum("bhqk,bkhd->bhqd", p.to(v.dtype).float(),
                          vt.float())
        acc = (acc.float() * alpha + pv).to(q.dtype)
        m = m_new
    return (acc.float() / l).permute(0, 2, 1, 3)


def flash_controls(torch, q, k, v, got, want, causal, control_from,
                   case) -> None:
    """Deliberately wrong outputs, held to the same rule as the kernels',
    each of which must be rejected: each kernel's output with its last
    rows (forward, dq) or keys (dk/dv) from ``control_from`` set to zero
    -- a kernel that misses the end of its walk. At the causal training
    shape, two forwards that round to bf16 at the wrong place (the
    scores before the softmax; the running output between KV tiles)
    must be rejected too; elsewhere they are read and reported
    (``gated`` false): how far the rule sits from them there."""
    from tpu_hpc_torch.checks.tolerance import compare

    controls = {}
    for name in ("out", "dq", "dk", "dv"):
        bad = got[name].clone()
        bad[:, control_from:] = 0
        controls[f"{name}_from_{control_from}_zeroed"] = (bad, want[name],
                                                          True)
    controls["out_scores_rounded"] = (
        out_with_rounded_scores(torch, q, k, v, causal), want["out"],
        causal)
    controls["out_narrow_accumulator"] = (
        out_with_narrow_accumulator(torch, q, k, v, causal=causal),
        want["out"], causal)
    for name, (bad, ref, gated) in controls.items():
        r = compare(bad, ref, q.dtype)
        emit("flash_control", case=case, control=name,
             dtype=str(q.dtype)[6:], rejected=not r["ok"], gated=gated,
             **{k: v for k, v in r.items() if k != "ok"})
        if r["ok"] and gated:
            raise SystemExit(f"flash control {name} ({case}): the "
                             f"tolerance accepts a wrong output ({r})")


def flash_determinism(torch, fa, bargs, kw, got) -> None:
    """dq, dk and dv from a second launch on the same inputs must equal
    the first bit for bit: the backward kernels sum in a fixed order,
    with no atomics."""
    dq = fa.flash_attention_dq(*bargs, **kw)
    dk, dv = fa.flash_attention_dkv(*bargs, **kw)
    torch.cuda.synchronize()
    same = {name: bool(torch.equal(a, got[name]))
            for name, a in (("dq", dq), ("dk", dk), ("dv", dv))}
    emit("flash_determinism", dtype=str(got["dq"].dtype)[6:],
         shape=list(got["dq"].shape), **same)
    if not all(same.values()):
        raise SystemExit(f"flash backward not bit-identical across "
                         f"launches: {same}")


def flash_accumulate(torch, fa, bargs, kw, dtype) -> dict:
    """The backward kernels adding into fp32 buffers (``accumulate=``, as
    the ring backward calls them), twice from zero: what the first launch
    added is held against the plain versions' fp32 result under the rule
    for ``dtype``, and the second must double it bit for bit (it adds,
    not overwrites). A random start would hide the small last keys' dk
    under the start's own fp32 rounding."""
    from tpu_hpc_torch.checks.tolerance import compare

    q, k, v = bargs[:3]
    acc = [torch.zeros(x.shape, device=x.device) for x in (q, k, v)]

    def add():
        fa.flash_attention_dq(*bargs, accumulate=acc[0], **kw)
        fa.flash_attention_dkv(*bargs, accumulate=(acc[1], acc[2]), **kw)
        torch.cuda.synchronize()
        return [a.clone() for a in acc]

    once, twice = add(), add()
    zeros = [torch.zeros_like(a) for a in acc]
    want = (fa.flash_attention_dq_ref(*bargs, accumulate=zeros[0], **kw),
            *fa.flash_attention_dkv_ref(*bargs,
                                        accumulate=(zeros[1], zeros[2]),
                                        **kw))
    out = {}
    for name, a, b, w in zip(("dq", "dk", "dv"), once, twice, want):
        out[name] = compare(a, w, dtype)
        out[name]["adds"] = bool(torch.equal(b, 2 * a))
        out[name]["ok"] = out[name]["ok"] and out[name]["adds"]
    return out


def library_flash(torch, q, k, v, dout, causal):
    """scaled_dot_product_attention forward, and its autograd backward
    (dq, dk, dv together), on the same inputs in its [B, H, S, D]
    layout -- the yardstick; the port never calls it."""
    sdpa = torch.nn.functional.scaled_dot_product_attention
    qq, kk, vv = (t.transpose(1, 2).contiguous().requires_grad_(True)
                  for t in (q, k, v))
    do = dout.transpose(1, 2).contiguous()
    out = sdpa(qq, kk, vv, is_causal=causal)

    def fwd():
        with torch.no_grad():
            sdpa(qq, kk, vv, is_causal=causal)

    def bwd():
        torch.autograd.grad(out, (qq, kk, vv), do, retain_graph=True)

    return fwd, bwd


def flash_phase(torch, dev) -> dict:
    from tpu_hpc_torch.checks.tolerance import TOLERANCES, compare
    from tpu_hpc_torch.kernels import attention as fa

    main_rows, vit_rows = {}, {}
    for case in FLASH_CASES:
        name, b, sq, sk, hq, hkv, d, causal, qo, ko, dtype_name, timed = case
        dtype = getattr(torch, dtype_name)
        gen = torch.Generator(device=dev).manual_seed(7)

        def rnd(*shape):
            return torch.randn(shape, generator=gen, device=dev).to(dtype)

        q, k, v = rnd(b, sq, hq, d), rnd(b, sk, hkv, d), rnd(b, sk, hkv, d)
        dout = rnd(b, sq, hq, d)
        dlse = torch.randn((b, sq, hq), generator=gen, device=dev)
        kw = dict(causal=causal)
        out, lse = fa.flash_attention_fwd(q, k, v, qo, ko, **kw)
        torch.cuda.synchronize()
        want_o, want_l = fa.flash_attention_fwd_ref(q, k, v, qo, ko, **kw)
        dm = (dout.float() * want_o.float()).sum(-1) - dlse
        bargs = (q, k, v, dout, want_l, dm, qo, ko)
        dq = fa.flash_attention_dq(*bargs, **kw)
        dk, dv = fa.flash_attention_dkv(*bargs, **kw)
        torch.cuda.synchronize()
        want_dq = fa.flash_attention_dq_ref(*bargs, **kw)
        want_dk, want_dv = fa.flash_attention_dkv_ref(*bargs, **kw)
        live = want_l > fa.MASK_VALUE * 0.5
        lse_err = float((lse[live] - want_l[live]).abs().max())
        if lse_err > 1e-3 or not (lse[~live] == fa.MASK_VALUE).all():
            raise SystemExit(f"flash {name}: lse off by {lse_err}")
        if (~live).any() and (out[~live].any() or dq[~live].any()):
            raise SystemExit(f"flash {name}: a fully masked row is not zero")
        got = {"out": out, "dq": dq, "dk": dk, "dv": dv}
        want = {"out": want_o, "dq": want_dq, "dk": want_dk, "dv": want_dv}
        if name in CONTROL_CASES:
            flash_controls(torch, q, k, v, got, want, causal,
                           CONTROL_CASES[name], name)
            flash_determinism(torch, fa, bargs, kw, got)
        added = flash_accumulate(torch, fa, bargs, kw, dtype)
        emit("flash_accumulate", case=name, dtype=dtype_name,
             q_offset=qo, kv_offset=ko, readings=added)
        if not all(r["ok"] for r in added.values()):
            raise SystemExit(f"flash {name}: accumulate= outside the "
                             f"tolerance {TOLERANCES[dtype]}: {added}")
        work = flash_work(case)
        outputs = {
            "flash_attention_fwd": (
                fa.flash_attention_fwd, fa.flash_attention_fwd_ref,
                (q, k, v, qo, ko), ("out",)),
            "flash_attention_dq": (
                fa.flash_attention_dq, fa.flash_attention_dq_ref, bargs,
                ("dq",)),
            "flash_attention_dkv": (
                fa.flash_attention_dkv, fa.flash_attention_dkv_ref, bargs,
                ("dk", "dv")),
        }
        lib = library_flash(torch, q, k, v, dout, causal) if timed else None
        for kname, (fn, ref, args, names) in outputs.items():
            readings = {n: compare(got[n], want[n], dtype) for n in names}
            row = {
                "kernel": kname, "case": name, "dtype": dtype_name,
                "shape": {"b": b, "sq": sq, "sk": sk, "hq": hq,
                          "hkv": hkv, "d": d},
                "causal": causal, "q_offset": qo, "kv_offset": ko,
                "max_abs_err": max(r["max_abs_err"]
                                   for r in readings.values()),
                "tolerance": dataclasses.asdict(TOLERANCES[dtype]),
                "readings": readings,
                "fully_masked_rows": int((~live).sum()),
            }
            if kname == "flash_attention_fwd":
                row["lse_max_abs_err"] = lse_err
            if timed:
                nb, fl = work[kname]
                bound_ms, bound_by = bound(nb, fl, dtype)
                lib_fn = lib[0] if kname == "flash_attention_fwd" else lib[1]
                row.update(
                    ms=time_ms(lambda: fn(*args, **kw), iters=20),
                    device_ms=device_ms(lambda: fn(*args, **kw),
                                        FLASH_KERNEL_NAMES[kname]),
                    plain_ms=time_ms(lambda: ref(*args, **kw), iters=3,
                                     warmup=1),
                    library_ms=time_ms(lib_fn, iters=20),
                    library_device_ms=device_ms(lib_fn, ""),
                    library="sdpa forward" if kname == "flash_attention_fwd"
                    else "sdpa autograd backward (dq, dk, dv together)",
                    bound_ms=bound_ms, bound_by=bound_by,
                    bytes=nb, flops=fl,
                    tile_rows=fa.flash_tile_rows(kname, dtype),
                )
                if name == "train_main":
                    main_rows[kname] = row
                if name == "vit_noncausal":
                    vit_rows[kname] = row
            emit("flash", **row)
            if not all(r["ok"] for r in readings.values()):
                raise SystemExit(
                    f"flash {name} {kname}: outside the tolerance "
                    f"{TOLERANCES[dtype]}: {readings}"
                )
        del q, k, v, dout, out, dq, dk, dv, want_o, want_dq, want_dk, want_dv
        del lib, outputs, bargs, got, want
        torch.cuda.empty_cache()
    return main_rows, vit_rows


# ---------------------------------------------------------------------
# Phases 7-8: training
# ---------------------------------------------------------------------

TRAIN_STEPS, TRAIN_EPOCHS, TRAIN_BATCH, TRAIN_ACCUM = 3, 2, 32, 8


def train_phase(torch, dev) -> dict:
    """The training path: the bench Llama through run_train, the flash
    kernels' launch counts set to 0 just before and read just after."""
    import math

    from tpu_hpc_torch.kernels import attention as fa
    from tpu_hpc_torch.train.__main__ import bench_model_cfg, run_train

    cfg = bench_model_cfg()
    for fn in (fa.flash_attention_fwd, fa.flash_attention_dq,
               fa.flash_attention_dkv):
        fn.launches = 0
    summary = run_train(cfg, steps=TRAIN_STEPS, epochs=TRAIN_EPOCHS,
                        batch=TRAIN_BATCH, grad_accum_steps=TRAIN_ACCUM,
                        device=dev)
    launches = fa.kernel_launches()
    expected = cfg.n_layers * TRAIN_ACCUM * TRAIN_STEPS * TRAIN_EPOCHS
    emit("train", model="bench", dim=cfg.dim, n_layers=cfg.n_layers,
         n_heads=cfg.n_heads, seq_len=cfg.max_seq_len,
         vocab_size=cfg.vocab_size, dtype="bfloat16", param_dtype="float32",
         microbatch=TRAIN_BATCH // TRAIN_ACCUM, grad_accum=TRAIN_ACCUM,
         updates=summary["updates"], measured_updates=TRAIN_STEPS,
         launches=launches, expected_launches=expected,
         **{k: summary[k] for k in (
             "tokens_per_s", "mfu", "update_s", "peak_memory_bytes",
             "losses", "final_loss", "n_params", "flops_per_token",
             "peak_flops", "flash_tile_rows", "goodput")})
    if not all(math.isfinite(x) for x in summary["losses"]):
        raise SystemExit(f"train: non-finite loss {summary['losses']}")
    if len(summary["losses"]) != TRAIN_STEPS * TRAIN_EPOCHS:
        raise SystemExit("train: an update's loss is missing")
    if any(n != expected for n in launches.values()) \
            or launches != summary["kernel_launches"]:
        raise SystemExit(
            f"train: flash launches {launches}, expected {expected} each"
        )
    return launches, summary


# train_hybrid's limit on its losses against train's: the same bf16
# compute on one card, only the machinery (DTensor, FSDP2, local_map)
# differs.
HYBRID_LOSS_RTOL = 2e-3


def hybrid_failures(train_losses, losses, launches, expected, layout) -> list:
    """What fails the train_hybrid phase: a loss off train's by more
    than HYBRID_LOSS_RTOL, a flash kernel launched other than
    ``expected`` times, or a layout that is not DTensors under FSDP2."""
    bad = []
    errs = [abs(a - b) / abs(b) for a, b in zip(losses, train_losses)]
    if len(losses) != len(train_losses) or max(errs) > HYBRID_LOSS_RTOL:
        bad.append(f"losses {losses} against train's {train_losses}")
    if any(n != expected for n in launches.values()):
        bad.append(f"flash launches {launches}, expected {expected} each")
    if not layout or layout["fsdp_units"] < 2 or "plain" in layout["params"]:
        bad.append(f"layout {layout}: not DTensor params under FSDP2")
    return bad


def train_hybrid_phase(torch, dev, train) -> None:
    """The distributed main path on this card: a one-rank NCCL world
    in this process, a (data 1, model 1) mesh, and run_train's hybrid
    plan (hybrid_pspecs + SP, params through shard_params: DTensors
    under FSDP2, each block on local shards under local_map, the flash
    kernels on local heads) at train's seed,
    batch, accumulation and updates. Its losses must equal train's
    within HYBRID_LOSS_RTOL and each flash kernel must launch layers x
    accum x updates times; the process group is gone after."""
    import torch.distributed as dist

    from tpu_hpc_torch.kernels import attention as fa
    from tpu_hpc_torch.runtime import MeshSpec, build_mesh
    from tpu_hpc_torch.runtime.sim import free_port
    from tpu_hpc_torch.train.__main__ import bench_model_cfg, run_train

    cfg = bench_model_cfg()
    dist.init_process_group("nccl", init_method=f"tcp://localhost:"
                            f"{free_port()}", world_size=1, rank=0)
    try:
        mesh = build_mesh(MeshSpec(axes={"data": 1, "model": 1}), "cuda")
        for fn in (fa.flash_attention_fwd, fa.flash_attention_dq,
                   fa.flash_attention_dkv):
            fn.launches = 0
        summary = run_train(cfg, steps=TRAIN_STEPS, epochs=TRAIN_EPOCHS,
                            batch=TRAIN_BATCH, grad_accum_steps=TRAIN_ACCUM,
                            device=dev, mesh=mesh, plan="hybrid")
        launches = fa.kernel_launches()
    finally:
        dist.destroy_process_group()
    expected = cfg.n_layers * TRAIN_ACCUM * TRAIN_STEPS * TRAIN_EPOCHS
    errs = [abs(a - b) / abs(b)
            for a, b in zip(summary["losses"], train["losses"])]
    emit("train_hybrid", model="bench", mesh=summary["mesh"],
         world_size=summary["world_size"], plan=summary["plan"],
         layout=summary["layout"], backend="nccl", dtype="bfloat16",
         microbatch=TRAIN_BATCH // TRAIN_ACCUM, grad_accum=TRAIN_ACCUM,
         updates=summary["updates"], launches=launches,
         expected_launches=expected, loss_max_rel_err=max(errs),
         loss_rtol=HYBRID_LOSS_RTOL,
         **{k: summary[k] for k in (
             "tokens_per_s", "update_s", "peak_memory_bytes", "mfu",
             "losses")},
         train={k: train[k] for k in (
             "tokens_per_s", "update_s", "peak_memory_bytes", "mfu")})
    bad = hybrid_failures(train["losses"], summary["losses"], launches,
                          expected, summary["layout"])
    if launches != summary["kernel_launches"]:
        bad.append("launch counts moved outside the run")
    if bad:
        raise SystemExit("train_hybrid: " + "; ".join(bad))


# ---------------------------------------------------------------------
# Phase 8b: sequence parallelism
# ---------------------------------------------------------------------

# (name, b, s, hq, hkv, d): the training shape, llama-long's length
# (bench.py:435) and a GQA shape, bf16, causal, a ring of SP_DEGREE.
SP_CASES = (
    ("train_shape", 4, 2048, 8, 8, 128),
    ("long_context", 1, 8192, 8, 8, 128),
    ("gqa", 2, 2048, 16, 2, 128),
)
SP_DEGREE = 4
SP_MODES = ("ring", "zigzag", "ulysses")


def zero_flash_launches() -> None:
    from tpu_hpc_torch.kernels import attention as fa

    for fn in (fa.flash_attention_fwd, fa.flash_attention_dq,
               fa.flash_attention_dkv):
        fn.launches = 0


def sp_predicted_launches(mode: str, n: int) -> int:
    """Each flash kernel's launches for one causal attention over all n
    ranks of a ring: every rank's live pairs (causal_live_pairs), or one
    call a rank for Ulysses."""
    from tpu_hpc_torch.parallel.ring_attention import causal_live_pairs

    if mode == "ulysses":
        return n
    return sum(causal_live_pairs(n, mode == "zigzag"))


def train_sp_expected(cfg, mode: str) -> int:
    """Each flash kernel's launches in (b)'s run on a context axis of 1:
    layers x accum x updates x live pairs (zigzag: 3 pairs of half
    chunks; the ring and Ulysses: 1)."""
    updates = TRAIN_STEPS * TRAIN_EPOCHS
    return cfg.n_layers * TRAIN_ACCUM * updates * sp_predicted_launches(
        mode, 1)


def zigzag_copy_bytes(b: int, s: int, hq: int, hkv: int, d: int, n: int,
                      elem: int = 2) -> int:
    """Bytes one rank's zigzag attention writes to lay its shard out
    chunk-major and back, per call (one layer): q, k, v in and the
    output out in the forward, dO in and dq, dk, dv out in the backward,
    each read once more. Nothing when B is 1: the chunks are views."""
    if b == 1:
        return 0
    return 2 * (2 * hq + 2 * hkv) * b * (s // n) * d * elem


def sp_shards(torch, mode: str, n: int, x) -> list:
    """A whole [B, S, ...] tensor -> the n ranks' shards in ``mode``'s
    layout (zigzag: the zigzag order), contiguous."""
    from tpu_hpc_torch.parallel.ring_attention import zigzag_indices

    if mode == "zigzag":
        x = x[:, torch.from_numpy(zigzag_indices(n, x.shape[1])[0])
              .to(x.device)]
    return [c.contiguous() for c in x.chunk(n, 1)]


def sp_whole(torch, mode: str, shards):
    """The inverse of :func:`sp_shards`."""
    from tpu_hpc_torch.parallel.ring_attention import zigzag_indices

    x = torch.cat(shards, 1)
    if mode == "zigzag":
        inv = zigzag_indices(len(shards), x.shape[1])[1]
        x = x[:, torch.from_numpy(inv).to(x.device)]
    return x


def sp_step(torch, mode: str, ring, q, k, v, dout):
    """``mode``'s forward and backward over ``ring`` (an InProcessRing:
    every rank's shard on this card) as a closure on pre-made shards of
    the whole tensors; it returns the outputs and the gradients, per
    rank."""
    from tpu_hpc_torch.parallel import ring_attention as ra
    from tpu_hpc_torch.parallel import sp_ulysses

    fn = {"ring": ra.ring_attention, "zigzag": ra.zigzag_ring_attention,
          "ulysses": sp_ulysses.ulysses_attention}[mode]
    n = ring.n
    qs, ks, vs = ([s.requires_grad_(True)
                   for s in sp_shards(torch, mode, n, x)]
                  for x in (q, k, v))
    douts = sp_shards(torch, mode, n, dout)

    def step():
        outs = fn(qs, ks, vs, ring)
        grads = torch.autograd.grad(outs, [*qs, *ks, *vs], douts)
        return [o.detach() for o in outs], grads

    return step


def sp_run(torch, mode: str, ring, q, k, v, dout) -> dict:
    """One forward and backward of ``mode`` over ``ring`` on whole
    tensors: out, dq, dk, dv, whole and in sequence order."""
    n = ring.n
    outs, grads = sp_step(torch, mode, ring, q, k, v, dout)()
    return {"out": sp_whole(torch, mode, outs),
            "dq": sp_whole(torch, mode, grads[:n]),
            "dk": sp_whole(torch, mode, grads[n:2 * n]),
            "dv": sp_whole(torch, mode, grads[2 * n:])}


def sp_readings(torch, got, ref) -> dict:
    """The bf16 rule's readings of out and dq/dk/dv against ``ref``."""
    from tpu_hpc_torch.checks.tolerance import compare

    return {g: compare(got[g], ref[g], torch.bfloat16)
            for g in ("out", "dq", "dk", "dv")}


def sp_exact_readings(torch, got, exact, q, k, v, dout) -> dict:
    """The bf16 rule's readings against the whole sequence's exact
    values (:func:`sp_reference`): out, dk and dv as they stand. dq
    against the plain dq over the whole sequence at the exact lse and
    the path's own D = rowsum(dO * O), O the path's output in the input
    dtype -- the dm every 16-bit path hands the dq kernel. Against the
    exact D the rule cannot hold dq: the error of O's rounding enters
    each row as (D's error) x scale x sum_j P_ij k_j, which does not
    shrink with the row's dq where P sits on one or two keys. Position
    0 is left out (one visible key: P = 1, so dq = scale (dP - D) k_0,
    rounding noise on both sides with no scale to hold it to); it stays
    held against the one-device flash path. The dq reading names how
    many rows it left out and the largest |dq| among them."""
    from tpu_hpc_torch.checks.tolerance import compare
    from tpu_hpc_torch.kernels import attention as fa

    out = {g: compare(got[g], exact[g], torch.bfloat16)
           for g in ("out", "dk", "dv")}
    wide = [x.float() for x in (q, k, v, dout)]
    dm = (wide[3] * got["out"].float()).sum(-1)
    want = fa.flash_attention_dq_ref(*wide, exact["lse"], dm)
    dq = compare(got["dq"][:, 1:], want[:, 1:], torch.bfloat16)
    dq["rows_left_out"] = got["dq"].shape[0] * got["dq"].shape[2]
    dq["left_out_max_abs"] = float(got["dq"][:, 0].float().abs().max())
    out["dq"] = dq
    return {g: out[g] for g in ("out", "dq", "dk", "dv")}


def frozen_kv_offset(fwd):
    """The control's forward: ``fwd`` with every launch's kv_offset
    frozen at ring step 0's value, the rank's own chunk (= its
    q_offset), so each earlier chunk is masked as if it were the
    diagonal."""
    def frozen(q, k, v, q_offset=0, kv_offset=0, **kw):
        return fwd(q, k, v, q_offset, q_offset, **kw)

    return frozen


@contextlib.contextmanager
def frozen_ring():
    """The ring's forward launches through :func:`frozen_kv_offset`
    inside the block (the ring module's name for the wrapper; the
    wrapper itself, and its launch count, stay as they are)."""
    from tpu_hpc_torch.parallel import ring_attention as ra

    real = ra.flash_attention_fwd
    ra.flash_attention_fwd = frozen_kv_offset(real)
    try:
        yield
    finally:
        ra.flash_attention_fwd = real


def sp_reference(torch, q, k, v, dout) -> dict:
    """The whole sequence's exact values (out, dq, dk, dv, and the lse):
    the flash kernels' plain versions on the inputs widened to fp32 (so
    nothing is rounded to the input dtype), dlse 0."""
    from tpu_hpc_torch.kernels import attention as fa

    q, k, v, dout = (x.float() for x in (q, k, v, dout))
    out, lse = fa.flash_attention_fwd_ref(q, k, v)
    dm = (dout.float() * out.float()).sum(-1)
    args = (q, k, v, dout, lse, dm)
    dk, dv = fa.flash_attention_dkv_ref(*args)
    return {"out": out, "dq": fa.flash_attention_dq_ref(*args), "dk": dk,
            "dv": dv, "lse": lse}


def sp_flash(torch, q, k, v, dout) -> dict:
    """The one-device flash path on the card over the whole sequence:
    flash_attention forward and its autograd backward (the three
    kernels)."""
    from tpu_hpc_torch.kernels import attention as fa

    qq, kk, vv = (x.detach().requires_grad_(True) for x in (q, k, v))
    out, _ = fa.flash_attention(qq, kk, vv)
    dq, dk, dv = torch.autograd.grad(out, (qq, kk, vv), dout)
    return {"out": out.detach(), "dq": dq, "dk": dk, "dv": dv}


def sp_failures(readings, control, launches, expected, same_bits) -> list:
    """What fails (a): a reading (against the one-device flash path or
    the exact values) outside the bf16 rule, a control the rule accepts,
    a kernel launched other than ``expected`` times, or a backward that
    is not bit-identical across runs."""
    bad = [f"{name}: {r}" for name, r in readings.items() if not r["ok"]]
    if control is not None and control["ok"]:
        bad.append(f"the frozen-offset ring passes the rule: {control}")
    if any(n != expected for n in launches.values()):
        bad.append(f"launches {launches}, predicted {expected} each")
    if not same_bits:
        bad.append("the backward is not bit-identical across runs")
    return bad


def train_sp_phase(torch, dev, train) -> dict:
    """Phase 8b, sequence parallelism. (a) ring, zigzag and Ulysses at
    degree SP_DEGREE on this card through the in-process transport, at
    each SP_CASES shape: out and dq/dk/dv under the bf16 rule against
    the one-device flash path over the whole sequence and against the
    exact values (sp_exact_readings; the one-device path is held to
    the exact values the same way), a frozen-offset control the rule
    must reject, launches as predicted,
    the backward bit-identical across runs, and forward+backward ms
    beside the one-device flash path's (and the device time of all
    their kernels, torch.profiler). (b) run_train with each
    --sp-mode on a one-rank NCCL world, (data 1, context 1): losses
    against train's, launches layers x accum x updates x live pairs,
    update_s, tokens/s and peak memory beside train's. Returns the
    flash kernels' launches in (b), by mode."""
    import torch.distributed as dist

    from tpu_hpc_torch.checks.tolerance import compare
    from tpu_hpc_torch.kernels import attention as fa
    from tpu_hpc_torch.parallel.sp_transport import InProcessRing
    from tpu_hpc_torch.runtime import MeshSpec, build_mesh
    from tpu_hpc_torch.runtime.sim import free_port
    from tpu_hpc_torch.train.__main__ import bench_model_cfg, run_train

    t0 = time.perf_counter()
    ring = InProcessRing(SP_DEGREE)
    for name, b, s, hq, hkv, d in SP_CASES:
        gen = torch.Generator(device=dev).manual_seed(11)
        q, k, v, dout = (
            torch.randn(shape, generator=gen, device=dev).bfloat16()
            for shape in ((b, s, hq, d), (b, s, hkv, d), (b, s, hkv, d),
                          (b, s, hq, d)))
        exact = sp_reference(torch, q, k, v, dout)
        flash = sp_flash(torch, q, k, v, dout)
        torch.cuda.synchronize()
        flash_ms = time_ms(lambda: sp_flash(torch, q, k, v, dout), iters=5)
        flash_device_ms = device_ms(lambda: sp_flash(torch, q, k, v, dout),
                                    "", iters=5)
        flash_exact = sp_exact_readings(torch, flash, exact, q, k, v, dout)
        emit("train_sp", check="a_flash_vs_exact", case=name,
             readings=flash_exact)
        bad = [f"{g}: {r}" for g, r in flash_exact.items() if not r["ok"]]
        if bad:
            raise SystemExit(f"train_sp (a) {name}: the one-device flash "
                             f"path against the exact values: {bad}")
        for mode in SP_MODES:
            zero_flash_launches()
            got = sp_run(torch, mode, ring, q, k, v, dout)
            torch.cuda.synchronize()
            launches = fa.kernel_launches()
            again = sp_run(torch, mode, ring, q, k, v, dout)
            same = all(torch.equal(got[g], again[g])
                       for g in ("dq", "dk", "dv"))
            readings = sp_readings(torch, got, flash)
            exact_readings = sp_exact_readings(torch, got, exact, q, k, v,
                                               dout)
            control = None
            if mode == "ring":
                with frozen_ring():
                    frozen = sp_run(torch, mode, ring, q, k, v, dout)
                control = compare(frozen["out"], flash["out"],
                                  torch.bfloat16)
                del frozen
            expected = sp_predicted_launches(mode, SP_DEGREE)
            row = {
                "case": name, "mode": mode, "degree": SP_DEGREE,
                "shape": {"b": b, "s": s, "hq": hq, "hkv": hkv, "d": d},
                "launches": launches, "predicted_launches": expected,
                "chunk_copy_bytes_per_rank": (
                    zigzag_copy_bytes(b, s, hq, hkv, d, SP_DEGREE)
                    if mode == "zigzag" else 0),
                "bit_identical": same,
                "max_abs_err": max(r["max_abs_err"]
                                   for r in readings.values()),
                "max_tol_used_vs_exact": max(
                    r["tol_used"] for r in exact_readings.values()),
                "readings": readings,
                "readings_vs_exact": exact_readings,
                "flash_ms": flash_ms, "flash_device_ms": flash_device_ms,
            }
            step = sp_step(torch, mode, ring, q, k, v, dout)
            row.update(ms=time_ms(step, iters=5),
                       device_ms=device_ms(step, "", iters=5))
            del step
            if control is not None:
                row["control_frozen_kv_offset"] = {
                    "rejected": not control["ok"], **control}
            emit("train_sp", check="a_ring_schedules", **row)
            checked = {**readings, **{f"{g}_vs_exact": r for g, r
                                      in exact_readings.items()}}
            bad = sp_failures(checked, control, launches, expected, same)
            if bad:
                raise SystemExit(f"train_sp (a) {name} {mode}: "
                                 + "; ".join(bad))
            del got, again
        del q, k, v, dout, exact, flash
        torch.cuda.empty_cache()

    cfg = bench_model_cfg()
    runs = {}
    dist.init_process_group("nccl", init_method=f"tcp://localhost:"
                            f"{free_port()}", world_size=1, rank=0)
    try:
        mesh = build_mesh(MeshSpec(axes={"data": 1, "context": 1}), "cuda")
        for mode in SP_MODES:
            # The previous run's trainer may sit in a reference cycle:
            # collect it, so each run's peak is its own.
            _release(torch)
            held = torch.cuda.memory_allocated(dev)
            zero_flash_launches()
            summary = run_train(cfg, steps=TRAIN_STEPS, epochs=TRAIN_EPOCHS,
                                batch=TRAIN_BATCH,
                                grad_accum_steps=TRAIN_ACCUM, device=dev,
                                mesh=mesh, sp_mode=mode)
            runs[mode] = (summary, fa.kernel_launches(), held)
    finally:
        dist.destroy_process_group()
    out = {}
    for mode, (summary, launches, held) in runs.items():
        expected = train_sp_expected(cfg, mode)
        errs = [abs(a - b) / abs(b)
                for a, b in zip(summary["losses"], train["losses"])]
        emit("train_sp", check="b_run_train", sp_mode=mode,
             metric=summary["metric"], mesh=summary["mesh"],
             plan=summary["plan"], layout=summary["layout"],
             backend="nccl", updates=summary["updates"], launches=launches,
             expected_launches=expected, loss_max_rel_err=max(errs),
             loss_rtol=HYBRID_LOSS_RTOL,
             losses_bit_equal_to_train=summary["losses"] == train["losses"],
             allocated_at_start_bytes=held,
             **{k: summary[k] for k in (
                 "tokens_per_s", "tokens_per_s_per_device", "update_s",
                 "peak_memory_bytes", "mfu", "losses")},
             train={k: train[k] for k in (
                 "tokens_per_s", "update_s", "peak_memory_bytes", "mfu")})
        bad = hybrid_failures(train["losses"], summary["losses"], launches,
                              expected, summary["layout"])
        if launches != summary["kernel_launches"]:
            bad.append("launch counts moved outside the run")
        if bad:
            raise SystemExit(f"train_sp (b) {mode}: " + "; ".join(bad))
        out[mode] = launches
    emit("train_sp", check="cost", seconds=time.perf_counter() - t0)
    return out


# ---------------------------------------------------------------------
# Phase 8c: pipeline parallelism
# ---------------------------------------------------------------------

# bench.py run_all's llama-pp rows (bench.py:1578-1588), in its order:
# (schedule, model, backward).
PP_ROWS = (("1f1b", "stack", "remat"), ("1f1b", "llama", "remat"),
           ("1f1b", "stack", "stash"), ("gpipe", "stack", "remat"),
           ("interleaved-1f1b", "stack", "remat"))
PP_MICROBATCHES, PP_MICROBATCH_SIZE, PP_STAGES = 8, 4, 4
# (b)'s loss at S = 4 against (a)'s first loss of the same row at S = 1:
# the same per-layer ops on the same rows and the same accumulation
# order, so equal bits are expected; the limit leaves room for a
# summation order that would differ.
PP_LOSS_RTOL = 1e-4


def pp_forward_passes(schedule: str, backward: str, remat_stage: bool) -> int:
    """Stage forwards a microbatch takes in one update: 1F1B (and
    interleaved 1F1B) 3 with remat -- the forward, the backward
    program's forward slot and the recompute -- and 2 with stash;
    GPipe and interleaved 1, or 2 under remat_stage (the checkpoint's
    recompute)."""
    if schedule in ("1f1b", "interleaved-1f1b"):
        return 3 if backward == "remat" else 2
    return 2 if remat_stage else 1


def pp_predicted_launches(schedule: str, backward: str, remat_stage: bool,
                          n_layers: int, microbatches: int,
                          updates: int = 1) -> dict:
    """Each flash kernel's launches: one per layer, microbatch and
    stage forward (the forward kernel) or backward (dq, dk/dv)."""
    n = n_layers * microbatches * updates
    return {"flash_attention_fwd":
            pp_forward_passes(schedule, backward, remat_stage) * n,
            "flash_attention_dq": n, "flash_attention_dkv": n}


def pp_regroup(torch, stages: dict, n_stages: int, v: int,
               interleave: bool = True) -> dict:
    """A stack stage tree of one stage (``[1, ...]`` leaves, layer_0 ..
    layer_{L-1}) as ``n_stages * v`` stages of ``L / (n_stages * v)``
    layers, in the interleaved layout when v > 1 (unless ``interleave``
    is False: the sequential stacking the interleaved schedule must not
    be given): the same values, in the same global order."""
    from tpu_hpc_torch.models.pipeline_transformer import _map
    from tpu_hpc_torch.parallel import pp

    g_all = n_stages * v
    lps = len(stages) // g_all
    per = [{f"layer_{j}": _map(lambda a: a[0],
                               stages[f"layer_{g * lps + j}"])
            for j in range(lps)} for g in range(g_all)]
    out = pp.stack_stage_params(per)
    return pp.interleave_stacked(out, n_stages) if v > 1 and interleave \
        else out


def pp_grad_readings(torch, got: dict, want: dict) -> dict:
    """Every gradient leaf under the bf16 rule: the worst leaf's
    reading and whether all pass."""
    from tpu_hpc_torch.checks.tolerance import compare
    from tpu_hpc_torch.parallel import pp

    paths, g = pp._flatten(got)
    _, w = pp._flatten(want)
    worst, ok = None, True
    for path, a, b in zip(paths, g, w):
        r = compare(a, b, torch.bfloat16)
        ok = ok and r["ok"]
        if worst is None or r["tol_used"] > worst["tol_used"]:
            worst = {"leaf": "/".join(path), **r}
    return {"ok": ok, "leaves": len(paths), "worst": worst}


def _pp_in_process(torch, dev, cfg, row, batch, attn_fn, interleave=True):
    """Row ``row`` at PP_STAGES stages through InProcessPipe: the loss,
    the gradients (in the stacked layout) and each flash kernel's
    launches, from the seed-0 init run_train gives the row."""
    from tpu_hpc_torch.kernels import attention as fa
    from tpu_hpc_torch.models import llama2, llama_pp
    from tpu_hpc_torch.models import pipeline_transformer as ptx
    from tpu_hpc_torch.parallel.pp_transport import InProcessPipe
    from tpu_hpc_torch.train.__main__ import SEED, pp_chunks

    schedule, model, backward = row
    v = pp_chunks(schedule, PP_STAGES, cfg.n_layers)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    kw = dict(schedule=schedule, backward=backward, n_chunks=v,
              remat_stage=schedule in ("gpipe", "interleaved"),
              attn_fn=attn_fn)
    if model == "llama":
        full = llama2.init_llama(gen, cfg, dev)
        params = llama_pp.split_params(full, cfg, PP_STAGES)
        params = ptx._map(lambda a: a.detach().clone().requires_grad_(),
                          params)
        fwd = llama_pp.make_forward(cfg, InProcessPipe(PP_STAGES),
                                    PP_MICROBATCHES, **kw)
        seq = (full, None)
    else:
        one = ptx.PipeConfig(vocab_size=cfg.vocab_size, dim=cfg.dim,
                             n_heads=cfg.n_heads, n_stages=1,
                             layers_per_stage=cfg.n_layers,
                             max_seq_len=cfg.max_seq_len, dtype=cfg.dtype)
        full = ptx.init_pipeline_transformer(gen, one, dev)
        params = dict(full, stages=pp_regroup(
            torch, full["stages"], PP_STAGES, v, interleave))
        params = ptx._map(lambda a: a.detach().clone().requires_grad_(),
                          params)
        pcfg = ptx.PipeConfig(vocab_size=cfg.vocab_size, dim=cfg.dim,
                              n_heads=cfg.n_heads,
                              n_stages=PP_STAGES * v,
                              layers_per_stage=cfg.n_layers
                              // (PP_STAGES * v),
                              max_seq_len=cfg.max_seq_len, dtype=cfg.dtype)
        fwd = ptx.make_forward(pcfg, InProcessPipe(PP_STAGES),
                               PP_MICROBATCHES, **kw)
        seq = (full, one)
    zero_flash_launches()
    loss, _, _ = fwd(params, {}, batch, None)
    loss.backward()
    if dev.type == "cuda":
        torch.cuda.synchronize()
    launches = fa.kernel_launches()
    grads = ptx._map(lambda a: a.grad, params)
    return float(loss.detach()), grads, launches, seq, v, kw["remat_stage"]


def _pp_oracle(torch, cfg, row, seq, batch, attn_fn, v, interleave=True):
    """The sequential oracle's loss and gradients, microbatch by
    microbatch (the mean of their means is the batch's), its
    gradients in the pipelined run's layout."""
    from tpu_hpc_torch.models import llama2, llama_pp
    from tpu_hpc_torch.models import pipeline_transformer as ptx
    from tpu_hpc_torch.models.losses import cross_entropy

    _, model, _ = row
    full, one = seq
    full = ptx._map(lambda a: a.detach().clone().requires_grad_(), full)
    total = 0.0
    rows = batch[0].shape[0] // PP_MICROBATCHES
    for i in range(PP_MICROBATCHES):
        tok, tgt = (a[i * rows:(i + 1) * rows] for a in batch)
        logits = (llama2.apply_llama(full, tok, cfg, attn_fn=attn_fn)
                  if model == "llama" else
                  ptx.apply_sequential(full, tok, one, attn_fn))
        loss = cross_entropy(logits, tgt) / PP_MICROBATCHES
        loss.backward()
        total += float(loss.detach())
        del logits, loss
    grads = ptx._map(lambda a: a.grad, full)
    if model == "llama":
        return total, llama_pp.split_params(grads, cfg, PP_STAGES)
    return total, dict(grads, stages=pp_regroup(
        torch, grads["stages"], PP_STAGES, v, interleave))


def pp_failures(row_a, launches, expected, summary_launches) -> list:
    """What fails a train_pp (a) row: a non-finite or missing loss, or a
    flash kernel launched other than the schedule implies."""
    import math

    bad = []
    losses = row_a["losses"]
    if len(losses) != TRAIN_STEPS * TRAIN_EPOCHS \
            or not all(math.isfinite(x) for x in losses):
        bad.append(f"losses {losses}")
    if launches != expected:
        bad.append(f"flash launches {launches}, expected {expected}")
    if launches != summary_launches:
        bad.append("launch counts moved outside the run")
    return bad


def train_pp_phase(torch, dev, train) -> dict:
    """Phase 8c, pipeline parallelism. (a) bench.py's five llama-pp
    rows through run_train at the bench width on a one-rank NCCL world,
    a {"pipe": 1} mesh (one stage: the degenerate ring bench.py runs on
    one chip, the real code path): losses, tokens/s, MFU, update_s,
    peak memory, bubble_fraction and each flash kernel's launches
    against the schedule's count. (b) each row at PP_STAGES stages
    through InProcessPipe on this card (the stack model at 2 layers a
    stage, interleaved 1F1B at 2 chunks of 1 layer): the first update's
    loss against (a)'s, its loss and gradients under the bf16 rule
    against the sequential oracle, launches as predicted, and a control
    the rule must reject: the interleaved params left in sequential
    order. Returns (a)'s launches by row."""
    import torch.distributed as dist

    from tpu_hpc_torch.checks.tolerance import compare
    from tpu_hpc_torch.kernels import attention as fa
    from tpu_hpc_torch.kernels.attention import blockwise_attention
    from tpu_hpc_torch.models import datasets
    from tpu_hpc_torch.runtime import MeshSpec, build_mesh
    from tpu_hpc_torch.runtime.sim import free_port
    from tpu_hpc_torch.train.__main__ import (
        SEED,
        PipeArgs,
        bench_model_cfg,
        run_train,
    )

    t0 = time.perf_counter()
    cfg = bench_model_cfg()
    runs = {}
    dist.init_process_group("nccl", init_method=f"tcp://localhost:"
                            f"{free_port()}", world_size=1, rank=0)
    try:
        mesh = build_mesh(MeshSpec(axes={"pipe": 1}), "cuda")
        for row in PP_ROWS:
            _release(torch)
            zero_flash_launches()
            args = PipeArgs(schedule=row[0], model=row[1], backward=row[2],
                            microbatches=PP_MICROBATCHES,
                            microbatch_size=PP_MICROBATCH_SIZE)
            summary = run_train(cfg, steps=TRAIN_STEPS, epochs=TRAIN_EPOCHS,
                                grad_accum_steps=1, device=dev, mesh=mesh,
                                pp=args)
            runs[row] = (summary, fa.kernel_launches())
    finally:
        dist.destroy_process_group()
    out = {}
    for row, (summary, launches) in runs.items():
        expected = pp_predicted_launches(
            row[0], row[2], summary["pp"]["remat_stage"], cfg.n_layers,
            PP_MICROBATCHES, TRAIN_STEPS * TRAIN_EPOCHS)
        emit("train_pp", check="a_bench_row", metric=summary["metric"],
             schedule=row[0], pp_model=row[1], backward=row[2],
             remat_stage=summary["pp"]["remat_stage"], mesh=summary["mesh"],
             plan=summary["plan"], layout=summary["layout"], backend="nccl",
             microbatches=PP_MICROBATCHES,
             microbatch_size=PP_MICROBATCH_SIZE, updates=summary["updates"],
             measured_updates=TRAIN_STEPS, launches=launches,
             expected_launches=expected,
             **{k: summary[k] for k in (
                 "n_chunks", "bubble_fraction", "tokens_per_s",
                 "tokens_per_s_per_device", "mfu", "update_s",
                 "peak_memory_bytes", "flops_per_token", "n_params",
                 "losses")},
             train={k: train[k] for k in (
                 "tokens_per_s", "update_s", "peak_memory_bytes", "mfu")})
        bad = pp_failures(summary, launches, expected,
                          summary["kernel_launches"])
        if bad:
            raise SystemExit(f"train_pp (a) {summary['metric']}: "
                             + "; ".join(bad))
        out[summary["metric"]] = launches

    def attn_fn(q, k, v):
        return blockwise_attention(q, k, v, causal=True)[0]

    ds = datasets.TokenStream(vocab_size=cfg.vocab_size,
                              seq_len=cfg.max_seq_len, seed=SEED)
    batch = tuple(a.to(dev) for a in ds.batch_at(
        0, PP_MICROBATCHES * PP_MICROBATCH_SIZE))
    for row in PP_ROWS:
        _release(torch)
        first = runs[row][0]["losses"][0]
        loss, grads, launches, seq, v, remat_stage = _pp_in_process(
            torch, dev, cfg, row, batch, attn_fn)
        expected = pp_predicted_launches(row[0], row[2], remat_stage,
                                         cfg.n_layers, PP_MICROBATCHES)
        want_loss, want_grads = _pp_oracle(torch, cfg, row, seq, batch,
                                           attn_fn, v)
        loss_reading = compare(torch.tensor([[loss]]),
                               torch.tensor([[want_loss]]), torch.bfloat16)
        readings = pp_grad_readings(torch, grads, want_grads)
        del grads, want_grads, seq
        control = None
        if v > 1:
            _release(torch)
            _, cgrads, _, cseq, _, _ = _pp_in_process(
                torch, dev, cfg, row, batch, attn_fn, interleave=False)
            _, cwant = _pp_oracle(torch, cfg, row, cseq, batch, attn_fn, v,
                                  interleave=False)
            control = pp_grad_readings(torch, cgrads, cwant)
            del cgrads, cwant, cseq
        rel = abs(loss - first) / abs(first)
        emit("train_pp", check="b_in_process", schedule=row[0],
             pp_model=row[1], backward=row[2], n_stages=PP_STAGES,
             n_chunks=v, loss=loss, loss_s1=first,
             loss_bit_equal_to_s1=loss == first, loss_rel_err_to_s1=rel,
             loss_rtol=PP_LOSS_RTOL, oracle_loss=want_loss,
             loss_vs_oracle=loss_reading, grads_vs_oracle=readings,
             launches=launches, expected_launches=expected,
             **({"control_not_interleaved": {
                 "rejected": not control["ok"], **control}}
                if control is not None else {}))
        bad = []
        if rel > PP_LOSS_RTOL:
            bad.append(f"loss {loss} against (a)'s {first}")
        if not (loss_reading["ok"] and readings["ok"]):
            bad.append(f"against the oracle: loss {loss_reading}, "
                       f"grads {readings['worst']}")
        if launches != expected:
            bad.append(f"flash launches {launches}, expected {expected}")
        if control is not None and control["ok"]:
            bad.append("the control (params not interleaved) passed")
        if bad:
            raise SystemExit(f"train_pp (b) {row}: " + "; ".join(bad))
    emit("train_pp", check="cost", seconds=time.perf_counter() - t0)
    return out


# ---------------------------------------------------------------------
# Phase 8c': the MPMD pipeline runtime
# ---------------------------------------------------------------------

# (a): bench.py's MPMD row on one stage, MPMD_STEPS timed steps after the
# warm one. (b): MPMD_STAGES stages on this card, 2 layers a stage, the
# chaos runs MPMD_CHAOS_STEPS steps on one repeated batch: (name, spec,
# the stage the fault hits).
MPMD_STEPS, MPMD_STAGES, MPMD_CHAOS_STEPS = 2, 4, 3
MPMD_CHAOS = (("kill", "stage_kill_at=2:1", 2),
              ("nan", "stage_nan_at=1:2", 1))
MPMD_DIR = "build/chip_smoke_mpmd"


def mpmd_predicted_launches(n_layers: int, microbatches: int,
                            steps: int = 1) -> dict:
    """Each flash kernel's launches in ``steps`` MPMD steps: every layer
    and microbatch runs the forward kernel twice (the no-grad forward
    and the backward program's recompute) and dq and dk/dv once."""
    n = n_layers * microbatches * steps
    return {"flash_attention_fwd": 2 * n, "flash_attention_dq": n,
            "flash_attention_dkv": n}


def mpmd_a_failures(summary, launches, expected, library_reloaded) -> list:
    """What fails a train_mpmd (a) row: a missing or non-finite loss, a
    program rebuilt after warmup, the kernel library loaded or built
    again, or a flash kernel launched other than predicted."""
    import math

    bad = []
    losses = summary["losses"]
    if len(losses) != summary["measured_updates"] + 1 \
            or not all(math.isfinite(x) for x in losses):
        bad.append(f"losses {losses}")
    if summary["recompiles"] != 0:
        bad.append(f"{summary['recompiles']} programs rebuilt after warmup")
    if library_reloaded:
        bad.append("the kernel library was loaded or built again")
    if launches != expected:
        bad.append(f"flash launches {launches}, expected {expected}")
    if launches != summary["kernel_launches"]:
        bad.append("launch counts moved outside the run")
    return bad


def mpmd_gate_failures(gates: dict) -> list:
    """What fails train_mpmd (b): a gate that did not pass, or a control
    it did not reject. ``gates``: name -> {"ok": ..., "control_ok": ...}
    (``control_ok`` True when the control PASSED the gate)."""
    bad = []
    for name, g in gates.items():
        if not g["ok"]:
            bad.append(f"{name} failed: {g.get('why', g)}")
        if g.get("control_ok", False):
            bad.append(f"{name}: the control passed")
    return bad


def mpmd_chaos_gate(run: dict, clean: dict, failed: int,
                    n_stages: int) -> dict:
    """A chaos run against the clean run: the loss stream and the final
    params bit-identical, only the failed stage rebuilt (every other
    stage's worker object and compile count unchanged), the redispatched
    microbatches equal to what the dead stage held in flight."""
    why = []
    if run["losses"] != clean["losses"]:
        why.append("loss stream differs")
    if not run["states_equal"]:
        why.append("final params differ")
    if sorted(run["rebuilt"]) != [failed]:
        why.append(f"rebuilt stages {run['rebuilt']}, expected [{failed}]")
    if run["kept_counts"] != n_stages - 1:
        why.append("a healthy stage's compile count moved")
    if run["redispatched"] != run["inflight"] or run["inflight"] < 1:
        why.append(f"redispatched {run['redispatched']}, in flight "
                   f"{run['inflight']}")
    return {"ok": not why, "why": why}


def mpmd_row(torch, dev, cfg, model: str) -> tuple:
    """train_mpmd (a): run_mpmd's row on one stage of ``dev``; returns
    (summary, launches counted around it, whether the kernel library
    was loaded or built again)."""
    from tpu_hpc_torch.kernels import attention as fa
    from tpu_hpc_torch.kernels import _build
    from tpu_hpc_torch.train.__main__ import PipeArgs, run_mpmd

    args = PipeArgs(schedule="gpipe", model=model,
                    microbatches=PP_MICROBATCHES,
                    microbatch_size=PP_MICROBATCH_SIZE)
    lib = _build._lib
    stamp = _build.LIBRARY.stat().st_mtime if _build.LIBRARY.exists() \
        else None
    zero_flash_launches()
    summary = run_mpmd(cfg, args, [dev], steps=MPMD_STEPS)
    launches = fa.kernel_launches()
    reloaded = dev.type == "cuda" and (
        _build._lib is not lib or _build.LIBRARY.stat().st_mtime != stamp)
    return summary, launches, reloaded


def _mpmd_pipeline(dev, bundle, spec=None, events_path=None):
    from tpu_hpc_torch.parallel import mpmd
    from tpu_hpc_torch.resilience.faults import fault_plan_from_env

    plan = fault_plan_from_env({"TPU_HPC_FAULTS": spec}) if spec else None
    return mpmd.MpmdPipeline(
        bundle, mpmd.MpmdConfig(n_microbatches=PP_MICROBATCHES,
                                learning_rate=3e-4),
        devices=[dev] * MPMD_STAGES, fault_plan=plan,
        events_path=events_path)


def mpmd_stages(torch, dev, cfg, mb_size: int = PP_MICROBATCH_SIZE,
                attn_fn=None, profile: bool = True) -> dict:
    """train_mpmd (b): the stack model at ``cfg``'s width, MPMD_STAGES
    stages of cfg.n_layers / MPMD_STAGES layers on ``dev``. Returns the
    readings of the four gates and the timings."""
    import os

    from tpu_hpc_torch.checks.tolerance import compare
    from tpu_hpc_torch.kernels import attention as fa
    from tpu_hpc_torch.models import datasets
    from tpu_hpc_torch.models import pipeline_transformer as ptx
    from tpu_hpc_torch.models.losses import cross_entropy
    from tpu_hpc_torch.parallel import mpmd, pp
    from tpu_hpc_torch.parallel.pp_transport import InProcessPipe
    from tpu_hpc_torch.train.__main__ import SEED
    from tpu_hpc_torch.train.trainer import tree_leaves

    sync = (lambda: torch.cuda.synchronize(dev)) if dev.type == "cuda" \
        else (lambda: None)
    M, S = PP_MICROBATCHES, MPMD_STAGES
    pcfg = ptx.PipeConfig(
        vocab_size=cfg.vocab_size, dim=cfg.dim, n_heads=cfg.n_heads,
        n_stages=S, layers_per_stage=cfg.n_layers // S,
        max_seq_len=cfg.max_seq_len, dtype=cfg.dtype)
    params = ptx.init_pipeline_transformer(
        torch.Generator(device=dev).manual_seed(SEED), pcfg, dev)
    bundle = ptx.mpmd_bundle(params, pcfg, attn_fn=attn_fn)
    ds = datasets.TokenStream(vocab_size=cfg.vocab_size,
                              seq_len=cfg.max_seq_len, seed=SEED)
    tok, tgt = ds.batch_at(0, M * mb_size)
    out = {"n_stages": S, "layers_per_stage": pcfg.layers_per_stage,
           "microbatches": M, "microbatch_size": mb_size}

    # -- gate 1: the loss vector against the SPMD gpipe engine, bit for bit
    pipe = _mpmd_pipeline(dev, bundle).build(tok)
    zero_flash_launches()
    lv, grads, edge = pipe.loss_and_grads(tok, tgt)
    sync()
    out["launches_loss_and_grads"] = fa.kernel_launches()
    out["expected_launches_loss_and_grads"] = mpmd_predicted_launches(
        cfg.n_layers, M)
    del pipe

    def spmd_losses(stages):
        fn = pp.pipelined(ptx.make_stage_fn(pcfg, attn_fn),
                          InProcessPipe(S), schedule="gpipe")
        with torch.no_grad():
            tm = pp.microbatch(tgt.to(dev), M)
            ys = fn(stages, ptx.embed(params, pp.microbatch(tok.to(dev), M),
                                      pcfg))
            return [float(cross_entropy(ptx.head(params, ys[m], pcfg),
                                        tm[m])) for m in range(M)]

    spmd = spmd_losses(params["stages"])
    order = [0, 2, 1, 3]  # the control: stages 1 and 2 swapped
    swapped = spmd_losses(ptx._map(lambda a: a[order], params["stages"]))
    out["loss_vs_spmd"] = {
        "ok": lv == spmd, "mpmd": lv, "spmd": spmd,
        "max_abs_diff": max(abs(a - b) for a, b in zip(lv, spmd)),
        "control_stages_swapped": swapped, "control_ok": swapped == lv,
        "why": "per-microbatch losses differ from the SPMD gpipe's"}

    # -- gate 2: the gradients against the sequential oracle, microbatch
    #    by microbatch; the control leaves one microbatch out of stage 2
    full = ptx._map(lambda a: a.detach().clone().requires_grad_(), params)
    first = None
    rows = tok.shape[0] // M
    for m in range(M):
        t = tok[m * rows:(m + 1) * rows].to(dev)
        y = tgt[m * rows:(m + 1) * rows].to(dev)
        loss = cross_entropy(ptx.apply_sequential(full, t, pcfg, attn_fn),
                             y) / M
        loss.backward()
        if m == 0:
            first = ptx._map(lambda a: a.grad[2].detach().clone(),
                             full["stages"])
        del loss
    want = [ptx._map(lambda a, s=s: a.grad[s].cpu(), full["stages"])
            for s in range(S)]
    want_edge = {"embed": ptx._map(lambda a: a.grad.cpu(), full["embed"]),
                 "head": ptx._map(lambda a: a.grad.cpu(), full["head"])}
    readings = [pp_grad_readings(torch, grads[s], want[s]) for s in range(S)]
    readings.append(pp_grad_readings(torch, edge, want_edge))
    paths, leaves = pp._flatten(grads[2])
    control = pp_grad_readings(torch, pp._unflatten(paths, [
        g - f.cpu() for g, f in zip(leaves, pp._flatten(first)[1])]),
        want[2])
    out["grads_vs_oracle"] = {
        "ok": all(r["ok"] for r in readings),
        "worst": max((r["worst"] for r in readings),
                     key=lambda w: w["tol_used"]),
        "control_microbatch_left_out": control["worst"],
        "control_ok": control["ok"],
        "why": "a gradient leaf outside the bf16 rule"}
    del full, first, grads, edge, want, want_edge
    loss_rule = compare(torch.tensor([lv]), torch.tensor([spmd]),
                        torch.bfloat16)
    out["loss_vs_spmd"]["bf16_rule"] = loss_rule

    # -- gate 3: chaos; the clean run first, timed, its snapshots timed
    #    from outside the runtime
    batches = [(tok, tgt)] * MPMD_CHAOS_STEPS
    snap_s = []
    orig_snapshot = mpmd.StageWorker.snapshot

    def timed_snapshot(self, step):
        sync()
        t0 = time.perf_counter()
        try:
            return orig_snapshot(self, step)
        finally:
            snap_s.append(time.perf_counter() - t0)

    pipe = _mpmd_pipeline(dev, bundle).build(tok)
    step_s, step_snap = [], []
    zero_flash_launches()
    mpmd.StageWorker.snapshot = timed_snapshot
    try:
        for step, batch in enumerate(batches):
            sync()
            del snap_s[:]
            t0 = time.perf_counter()
            pipe.losses.append(pipe.run_step(step, *batch))
            sync()
            step_s.append(time.perf_counter() - t0)
            step_snap.append(sum(snap_s))
    finally:
        mpmd.StageWorker.snapshot = orig_snapshot
    out["launches_clean"] = fa.kernel_launches()
    out["expected_launches_clean"] = mpmd_predicted_launches(
        cfg.n_layers, M, MPMD_CHAOS_STEPS)
    clean = {"losses": pipe.losses,
             "states": [tree_leaves(pipe.stage_state(s))
                        for s in range(S)]}
    flat = [x for step in clean["losses"] for x in step]
    means = [sum(v) / len(v) for v in clean["losses"]]
    out["clean"] = {
        "losses": means, "falls": means[-1] < means[0],
        "finite": all(x == x and abs(x) != float("inf") for x in flat),
        "step_s": step_s, "snapshot_s": step_snap,
        "snapshot_share": [a / b for a, b in zip(step_snap, step_s)],
        "bubble_fraction": pipe.bubble_fractions[-1],
        "wire_mb": pipe.wire_bytes / 2**20,
        "compile_counts": pipe.compile_counts,
        "snapshot_bytes": sum(
            t.numel() * t.element_size() for s in range(S)
            for t in tree_leaves(pipe.snapshots[s]["state"]))}
    out["clean_run"] = {"ok": out["clean"]["finite"]
                        and out["clean"]["falls"],
                        "why": "clean losses not finite or not falling"}
    if profile:
        steps = iter(range(MPMD_CHAOS_STEPS, MPMD_CHAOS_STEPS + 2))

        class _Step:
            @staticmethod
            def train_step(batch):
                pipe.run_step(next(steps), *batch)

        out["profile"] = profiled_update(torch, _Step, lambda i: (tok, tgt))
    del pipe
    _release(torch) if dev.type == "cuda" else None

    os.makedirs(MPMD_DIR, exist_ok=True)

    def chaos_run(spec, stale=False):
        events = os.path.join(MPMD_DIR, f"{spec}{'_stale' * stale}.jsonl")
        if os.path.exists(events):
            os.remove(events)
        p = _mpmd_pipeline(dev, bundle, spec, events).build(tok)
        workers, counts = list(p.workers), list(p.compile_counts)
        if stale:  # the control: restore the dead stage from step 0
            first_snaps = dict(p.snapshots)
            rebuild = p._rebuild

            def from_step0(sid):
                p.snapshots[sid] = first_snaps[sid]
                return rebuild(sid)

            p._rebuild = from_step0
        res = p.train(batches)
        run = {"losses": res["losses"],
               "states_equal": all(
                   same_bits(torch, tree_leaves(p.stage_state(s)),
                             clean["states"][s]) for s in range(S)),
               "rebuilt": [s for s in range(S)
                           if p.workers[s] is not workers[s]],
               "kept_counts": sum(p.compile_counts[s] == counts[s]
                                  for s in range(S)
                                  if p.workers[s] is workers[s]),
               "redispatched": res["redispatched"],
               # what the dead stage held, as its stage_down said
               "inflight": sum(r["inflight"] for r in read_events(
                   events, "stage_down")),
               "recoveries": res["recoveries"],
               "poisoned_windows": res["poisoned_windows"],
               "bubble_fraction": res["bubble_fraction"],
               "recovery_mttr_s": res["recovery_mttr_s"]}
        del p
        return run

    gates = {}
    for name, spec, failed in MPMD_CHAOS:
        run = chaos_run(spec)
        gate = mpmd_chaos_gate(run, clean, failed, S)
        if name == "kill":
            control = chaos_run(spec, stale=True)
            gate["control_ok"] = mpmd_chaos_gate(control, clean, failed,
                                                 S)["ok"]
            gate["control_losses_equal"] = control["losses"] == \
                clean["losses"]
        gates[f"chaos_{name}"] = {**gate, **{k: run[k] for k in (
            "rebuilt", "redispatched", "recoveries", "poisoned_windows",
            "bubble_fraction", "recovery_mttr_s")}}
    out.update(gates)
    out["launches"] = {
        "ok": out["launches_loss_and_grads"]
        == out["expected_launches_loss_and_grads"]
        and out["launches_clean"] == out["expected_launches_clean"],
        "why": "flash launches other than predicted"}
    return out


def train_mpmd_phase(torch, dev) -> dict:
    """Phase 8c', the MPMD pipeline runtime. (a) bench.py's MPMD row
    (run_mpmd: the stack model and the flagship Llama at the bench
    width, one stage on this card), one warm and MPMD_STEPS timed steps:
    losses, tokens/s, MFU, update_s, peak memory, no program rebuilt and
    the kernel library not loaded again after warmup, and each flash
    kernel launched as predicted (128 forwards, 64 dq and 64 dk/dv a
    step). (b) the stack model at MPMD_STAGES stages on this card
    (mpmd_stages): the gates, each with its control. Returns (a)'s
    launches by model."""
    from tpu_hpc_torch.kernels.attention import blockwise_attention
    from tpu_hpc_torch.train.__main__ import bench_model_cfg

    t0 = time.perf_counter()
    cfg = bench_model_cfg()
    out = {}
    for model in ("stack", "llama"):
        _release(torch)
        summary, launches, reloaded = mpmd_row(torch, dev, cfg, model)
        expected = mpmd_predicted_launches(cfg.n_layers, PP_MICROBATCHES,
                                           MPMD_STEPS + 1)
        emit("train_mpmd", check="a_cli_row", metric=summary["metric"],
             launches=launches, expected_launches=expected,
             library_reloaded=reloaded,
             losses_fall=summary["losses"][-1] < summary["losses"][0],
             **{k: summary[k] for k in (
                 "n_stages", "losses", "tokens_per_s", "mfu", "update_s",
                 "peak_memory_bytes", "recompiles", "bubble_fraction",
                 "wire_mb", "compile_counts", "flops_per_token",
                 "n_params", "global_batch", "measured_updates")})
        bad = mpmd_a_failures(summary, launches, expected, reloaded)
        if bad:
            raise SystemExit(f"train_mpmd (a) {summary['metric']}: "
                             + "; ".join(bad))
        out[model] = launches
    _release(torch)

    def attn_fn(q, k, v):
        return blockwise_attention(q, k, v, causal=True)[0]

    b = mpmd_stages(torch, dev, cfg, attn_fn=attn_fn)
    gates = {k: b[k] for k in ("loss_vs_spmd", "grads_vs_oracle",
                               "clean_run", "chaos_kill", "chaos_nan",
                               "launches")}
    emit("train_mpmd", check="b_four_stages", model="stack",
         **{k: v for k, v in b.items() if k not in gates}, gates=gates)
    bad = mpmd_gate_failures(gates)
    if bad:
        raise SystemExit("train_mpmd (b): " + "; ".join(bad))
    _release(torch)
    emit("train_mpmd", check="cost", seconds=time.perf_counter() - t0)
    return out


# ---------------------------------------------------------------------
# Phase 8d: the comm layer
# ---------------------------------------------------------------------

COMM_BENCH_SIZES = tuple(10 ** k for k in range(3, 9))
COMM_DIR = "build/chip_smoke_comm"


def comm_failures(train_losses, summary, launches, expected,
                  updates) -> list:
    """What fails train_comm (a): a loss off train's by more than
    HYBRID_LOSS_RTOL, a flash kernel launched other than ``expected``
    times, a resolved mode other than bucketed_overlap, or a run whose
    all-reduces are not updates x (n_buckets + 1)."""
    bad = []
    losses = summary["losses"]
    errs = [abs(a - b) / abs(b) for a, b in zip(losses, train_losses)]
    if len(losses) != len(train_losses) or max(errs) > HYBRID_LOSS_RTOL:
        bad.append(f"losses {losses} against train's {train_losses}")
    if any(n != expected for n in launches.values()):
        bad.append(f"flash launches {launches}, expected {expected} each")
    comm = summary.get("comm") or {}
    if summary.get("comm_mode_resolved") != "bucketed_overlap":
        bad.append(f"resolved {summary.get('comm_mode_resolved')!r}")
    want = updates * (comm.get("n_buckets", -2) + 1)
    if comm.get("allreduces") != want:
        bad.append(f"all-reduces {comm.get('allreduces')}, expected {want}")
    return bad


def comm_profile(torch, dev, mesh) -> dict:
    """One update of the bucketed sync under torch.profiler, after one
    warm-up update (which fixes the launch order): the port's counter,
    the profiler's ``nccl:all_reduce`` ranges (one a collective the
    process group issues) and its NCCL all-reduce kernels on the card.
    NCCL may run a one-rank world's in-place all-reduce without a
    kernel, so the kernel count is reported, not gated."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from tpu_hpc_torch.train.__main__ import bench_model_cfg, build_trainer

    trainer, ds = build_trainer(bench_model_cfg(), batch=TRAIN_BATCH,
                                grad_accum_steps=TRAIN_ACCUM, device=dev,
                                mesh=mesh, comm_mode="bucketed_overlap")
    sync = trainer.grad_sync
    trainer.train_step(ds.batch_at(0, TRAIN_BATCH))
    torch.cuda.synchronize()
    before = sync.allreduces
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        trainer.train_step(ds.batch_at(1, TRAIN_BATCH))
        torch.cuda.synchronize()
    events = prof.key_averages()
    ranges = sum(e.count for e in events if e.key == "nccl:all_reduce")
    kernels = sum(e.count for e in events
                  if e.device_type == DeviceType.CUDA
                  and "allreduce" in e.key.lower().replace("_", ""))
    out = {"counter": sync.allreduces - before, "n_buckets": sync.n_buckets,
           "profiler_nccl_all_reduce": ranges,
           "profiler_allreduce_kernels": kernels,
           "launched_in_backward": sum(1 for _, d in sync.launch_log if d)}
    sync.remove()
    del trainer
    _release(torch)
    return out


def train_comm_phase(torch, dev, train) -> dict:
    """Phase 8d, the comm layer (bench.py's "llama dp bucketed-overlap
    sync" row) on a one-rank NCCL world: (a) run_train with
    comm_mode="bucketed_overlap" against train, plus one profiled update;
    (b) comm_mode="auto"'s logged decision; (c) hierarchical refused on
    one card; (d) the comm bench's flat and overlap ops at 10^3..10^8
    elements. Returns (a)'s flash launches."""
    import os

    import torch.distributed as dist

    from tpu_hpc_torch.comm import bench as comm_bench
    from tpu_hpc_torch.kernels import attention as fa
    from tpu_hpc_torch.obs import schema
    from tpu_hpc_torch.runtime import MeshSpec, build_mesh
    from tpu_hpc_torch.runtime.sim import free_port
    from tpu_hpc_torch.train.__main__ import (
        bench_model_cfg,
        comm_mode_mesh,
        run_train,
    )

    t0 = time.perf_counter()
    cfg = bench_model_cfg()
    updates = TRAIN_STEPS * TRAIN_EPOCHS
    os.makedirs(COMM_DIR, exist_ok=True)
    # The planner reads its tables here, never from $HOME.
    os.environ["TPU_HPC_COMM_TABLES"] = os.path.join(COMM_DIR, "tables")
    dist.init_process_group("nccl", init_method=f"tcp://localhost:"
                            f"{free_port()}", world_size=1, rank=0)
    try:
        mesh = build_mesh(MeshSpec(axes={"data": 1}), "cuda")
        _release(torch)
        zero_flash_launches()
        summary = run_train(cfg, steps=TRAIN_STEPS, epochs=TRAIN_EPOCHS,
                            batch=TRAIN_BATCH, grad_accum_steps=TRAIN_ACCUM,
                            device=dev, mesh=mesh,
                            comm_mode="bucketed_overlap")
        launches = fa.kernel_launches()
        _release(torch)
        prof = comm_profile(torch, dev, mesh)
        # (b) auto, no table: the decision as the run log records it.
        log = os.path.join(COMM_DIR, "auto.jsonl")
        if os.path.exists(log):
            os.remove(log)
        auto = run_train(cfg, steps=1, epochs=1, batch=TRAIN_BATCH,
                         grad_accum_steps=TRAIN_ACCUM, device=dev, mesh=mesh,
                         comm_mode="auto", metrics_path=log)
        logged = [r for r in schema.load_records(log)
                  if r["event"] == "comm_plan"]
        _release(torch)
        # (c) hierarchical on one card.
        try:
            run_train(cfg, steps=1, epochs=1, batch=TRAIN_BATCH,
                      grad_accum_steps=TRAIN_ACCUM, device=dev, mesh=mesh,
                      comm_mode="hierarchical")
            refusal = None
        except ValueError as e:
            refusal = str(e)
        try:
            comm_mode_mesh("hierarchical", 1, 1)
            want_refusal = None
        except ValueError as e:
            want_refusal = str(e)
        # (d) the comm bench over the one-rank world.
        t_bench = time.perf_counter()
        records = comm_bench.run_comm_bench(
            mesh=mesh, sizes=COMM_BENCH_SIZES, warmup=3, iters=10,
            ops=comm_bench.OPS + comm_bench.OVERLAP_OPS,
            output=os.path.join(COMM_DIR, "comm_bench.csv"),
            device_type="cuda")
        bench_s = time.perf_counter() - t_bench
    finally:
        dist.destroy_process_group()
    expected = cfg.n_layers * TRAIN_ACCUM * updates
    errs = [abs(a - b) / abs(b)
            for a, b in zip(summary["losses"], train["losses"])]
    emit("train_comm", check="a_bucketed_overlap", model="bench",
         mesh=summary["mesh"], world_size=summary["world_size"],
         plan=summary["plan"], comm_mode=summary["comm_mode"],
         comm=summary["comm"], backend="nccl", dtype="bfloat16",
         microbatch=TRAIN_BATCH // TRAIN_ACCUM, grad_accum=TRAIN_ACCUM,
         updates=summary["updates"], launches=launches,
         expected_launches=expected, loss_max_rel_err=max(errs),
         loss_rtol=HYBRID_LOSS_RTOL,
         losses_bit_equal_to_train=summary["losses"] == train["losses"],
         profiled_update=prof,
         **{k: summary[k] for k in (
             "tokens_per_s", "update_s", "peak_memory_bytes", "mfu",
             "losses")},
         train={k: train[k] for k in (
             "tokens_per_s", "update_s", "peak_memory_bytes", "mfu")})
    decision = logged[0] if logged else None
    emit("train_comm", check="b_auto",
         decision=None if decision is None else {
             k: decision.get(k) for k in (
                 "mode", "source", "bucket_bytes", "payload_bytes",
                 "predicted_cost_ms", "fingerprint", "candidates",
                 "reason")},
         resolved=auto["comm_mode_resolved"], plan=auto["plan"],
         losses=auto["losses"])
    emit("train_comm", check="c_hierarchical_refused", refusal=refusal,
         bench_words=want_refusal)
    emit("train_comm", check="d_comm_bench", world_size=1,
         seconds=bench_s, note="one rank: times are launch cost, the "
         "bus bandwidth of a one-rank world is 0 by the formula",
         rows=[{k: r[k] for k in ("op", "size_elements", "bytes_per_shard",
                                  "mean_s", "min_s", "max_s")}
               for r in records])
    emit("train_comm", check="cost", seconds=time.perf_counter() - t0)
    bad = comm_failures(train["losses"], summary, launches, expected,
                        updates)
    if launches != summary["kernel_launches"]:
        bad.append("launch counts moved outside the run")
    if prof["counter"] != prof["n_buckets"] + 1 or (
            prof["profiler_nccl_all_reduce"]
            and prof["profiler_nccl_all_reduce"] != prof["counter"]):
        bad.append(f"profiled update: {prof}")
    if decision is None or decision["mode"] != auto["comm_mode_resolved"]:
        bad.append(f"auto: logged decision {decision}")
    if refusal is None or refusal != want_refusal:
        bad.append(f"hierarchical on one card: {refusal!r}")
    ops = {r["op"] for r in records}
    want_ops = set(comm_bench.OPS + comm_bench.OVERLAP_OPS)
    if ops != want_ops or len(records) != len(want_ops) * len(
            COMM_BENCH_SIZES) or not all(r["mean_s"] > 0 for r in records):
        bad.append(f"comm bench ran {sorted(ops)} ({len(records)} rows)")
    if bad:
        raise SystemExit("train_comm: " + "; ".join(bad))
    return launches


# ---------------------------------------------------------------------
# Phases 8e-8g: the vision and weather workloads, domain parallelism,
# llama-long
# ---------------------------------------------------------------------

VISION_STEPS, VISION_EPOCHS = 3, 2
VIT_BATCH = 8          # the vit_noncausal flash case's B
RESNET_BATCH = 32
DOMAIN_GRID = (176, 360, 20)  # lat (16 x 11, the 1-degree band), lon, C
DOMAIN_DEGREE, DOMAIN_BATCH = 4, 2
LONG_SEQ, LONG_ACCUM, LONG_UPDATES = 8192, 8, 2


def vision_failures(name, summary, updates, expected_launches=None) -> list:
    """What fails a train_vision run: a missing or non-finite loss, a
    U-Net whose losses do not fall, or a flash kernel launched other
    than ``expected_launches`` times."""
    bad = []
    losses = summary["losses"]
    if len(losses) != updates or not all(
            isinstance(x, float) and x == x and abs(x) != float("inf")
            for x in losses):
        bad.append(f"{name}: losses {losses}, {updates} finite expected")
    elif name == "unet" and not losses[-1] < losses[0]:
        bad.append(f"{name}: losses do not fall {losses}")
    if expected_launches is not None and any(
            n != expected_launches
            for n in summary["kernel_launches"].values()):
        bad.append(f"{name}: flash launches {summary['kernel_launches']}, "
                   f"expected {expected_launches} each")
    return bad


# Model-level checks in bf16 (train_vision (c), train_domain): a whole
# model's bf16 output sits ~1% from its float32 value, beyond the
# per-element kernel rule, so each bf16 run is held to the float32 run
# of the same params and inputs (TF32 off): the run under test may be
# off it by at most MODEL_VS_REF x what its counterpart (the plain
# attention, the one-device U-Net) is off it, by relative RMS, plus
# MODEL_FLOOR. Sound runs read 1.00-1.01 x; the domain's no-halo control
# about 18 x (PERF.md, train_domain). At the ViT's random init the
# attention adds little to the output, so a ViT whose attention drops
# rows still tracks (about 1.05 x): (c) holds each attention call to
# the kernel rule as well.
MODEL_VS_REF, MODEL_FLOOR = 2.0, 1e-3
# train_domain's float32 gradients against the one-device U-Net's, by
# relative RMS: the sound run reads 5.4e-4 (sums in another order over
# four bands and the BatchNorm's mean subtraction), the no-halo control
# far more.
DOMAIN_GRAD_REL_RMS = 5e-3


@contextlib.contextmanager
def no_tf32(torch):
    """Float32 convs and matmuls in float32 (cuDNN's and cuBLAS's TF32
    off) for the duration."""
    saved = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = saved


def rel_rms(a, b) -> float:
    return float((a.float() - b.float()).norm() / b.float().norm())


def tracks(got, ref, exact) -> dict:
    """``got`` against the float32 ``exact``, with ``ref``'s distance as
    the yardstick (MODEL_VS_REF, MODEL_FLOOR)."""
    err, ref_err = rel_rms(got, exact), rel_rms(ref, exact)
    return {"rel_rms_vs_float32": err, "ref_rel_rms_vs_float32": ref_err,
            "vs_ref": err / ref_err if ref_err > 0 else None,
            "ok": err <= MODEL_VS_REF * ref_err + MODEL_FLOOR}


def recording(attn, calls: list):
    """``attn`` as a ViT attention hook that records, per call, its q, k,
    v and output, and in the backward the output's gradient and dq, dk,
    dv (each of q, k, v feeds only the attention)."""
    def fn(q, k, v):
        call = {"q": q.detach(), "k": k.detach(), "v": v.detach()}
        calls.append(call)
        for name, t in (("dq", q), ("dk", k), ("dv", v)):
            t.register_hook(lambda g, name=name: call.update({name: g}))
        out = attn(q, k, v)
        out.register_hook(lambda g: call.update(dout=g))
        call["out"] = out.detach()
        return out
    return fn


def rows_zeroed(torch, attn, start: int):
    """(c)'s control: ``attn`` with its output's rows from ``start`` set
    to zero -- an attention that misses the end of its walk."""
    def fn(q, k, v):
        out = attn(q, k, v)
        return torch.cat([out[:, :start], torch.zeros_like(out[:, start:])],
                         1)
    return fn


def attention_calls_readings(torch, calls) -> dict:
    """Each recorded non-causal attention call against the kernels' plain
    versions on the same q, k, v and output gradient (``dm`` from the
    plain output), under the bf16 rule: per output, the reading of the
    call that uses the most of its tolerance, and ``ok`` over all."""
    from tpu_hpc_torch.checks.tolerance import compare
    from tpu_hpc_torch.kernels import attention as fa

    out = {}
    for call in calls:
        q, k, v, dout = call["q"], call["k"], call["v"], call["dout"]
        want = dict(zip(("out", "lse"), fa.flash_attention_fwd_ref(
            q, k, v, causal=False)))
        dm = (dout.float() * want["out"].float()).sum(-1)
        bargs = (q, k, v, dout, want["lse"], dm)
        want["dq"] = fa.flash_attention_dq_ref(*bargs, causal=False)
        want["dk"], want["dv"] = fa.flash_attention_dkv_ref(*bargs,
                                                            causal=False)
        for name in ("out", "dq", "dk", "dv"):
            r = compare(call[name], want[name], q.dtype)
            worst = out.setdefault(name, r)
            if r["tol_used"] > worst["tol_used"]:
                out[name] = r
            out[name]["ok"] = worst["ok"] and r["ok"]
    out["calls"] = len(calls)
    return out


def vit_update_readings(torch, dev, impl="cuda") -> dict:
    """(c) One ViT forward and backward at the example's size -- the same
    params and batch -- through the flash kernels (``impl``), and its
    control, the same with each attention output's rows from
    CONTROL_CASES["vit_noncausal"] zeroed; each held by two checks: (1)
    every attention call's output and dq, dk, dv against the kernels'
    plain versions on that call's inputs, under the bf16 rule
    (``attention_calls_readings``); (2) the model's output and gradients
    against the float32 run's, as close as the run through the plain
    attention in bf16 (``tracks``). The sound run must pass both, the
    control must fail one."""
    from tpu_hpc_torch.models import datasets, vit
    from tpu_hpc_torch.models.losses import lat_weighted_mse
    from tpu_hpc_torch.train.trainer import tree_leaves, tree_map

    cfg = vit.ViTConfig()
    params = vit.init_vit(torch.Generator(device=dev).manual_seed(0), cfg,
                          dev)
    x, y = (t.to(dev) for t in datasets.ERA5Synthetic(
        lat=cfg.lat, lon=cfg.lon, n_vars=cfg.in_channels,
        n_levels=1).batch_at(0, VIT_BATCH))
    kernels, plain = vit.flash_attn_fn(impl), vit.flash_attn_fn("reference")
    calls = {"flash": [], "control": []}
    runs = {}
    for name, attn, dtype in (
            ("flash", recording(kernels, calls["flash"]), torch.bfloat16),
            ("control", recording(rows_zeroed(
                torch, kernels, CONTROL_CASES["vit_noncausal"]),
                calls["control"]),
             torch.bfloat16),
            ("plain", plain, torch.bfloat16),
            ("float32", plain, torch.float32)):
        p = tree_map(lambda t: t.detach().clone().requires_grad_(True),
                     params)
        with no_tf32(torch):
            pred = vit.apply_vit(p, x, dataclasses.replace(cfg, dtype=dtype),
                                 attn)
            loss = lat_weighted_mse(pred, y)
            loss.backward()
        grads = torch.cat([t.grad.detach().float().reshape(-1)
                           for t in tree_leaves(p)])
        runs[name] = (pred.detach(), float(loss.detach()), grads)
    out = {}
    for name in ("flash", "control"):
        got = runs[name]
        r = {"attention": attention_calls_readings(torch, calls[name]),
             "out": tracks(got[0], runs["plain"][0], runs["float32"][0]),
             "grads": tracks(got[2], runs["plain"][2], runs["float32"][2])}
        r["ok"] = (r["attention"]["calls"] == cfg.depth
                   and all(r[k]["ok"] for k in ("out", "grads"))
                   and all(r["attention"][k]["ok"]
                           for k in ("out", "dq", "dk", "dv")))
        out[name] = r
    out["loss"] = {name: run[1] for name, run in runs.items()}
    return out


def train_vision_phase(torch, dev) -> dict:
    """Phase 8e, the vision and weather workloads at full width: (a)
    bench.py's unet row on a one-rank NCCL world ({"data": 1}: FSDP2
    over data, the BatchNorm moments all-reduced over the group), two
    epochs of 3 updates, plus one profiled update; (b) the ViT at
    examples/03's size (64 x 128, patch 4, embed 256, depth 6, 8 heads,
    bf16, batch 8) through the flash kernels without a causal mask, each
    kernel's launches set to 0 before and read after, predicted depth x
    accum x updates, plus one profiled update (the kernels' share of
    it); (c) one ViT forward and backward through the kernels, each
    attention call against the plain versions and the whole against the
    float32 run, and a control with rows of attention dropped that must
    be rejected (``vit_update_readings``); (d) ResNet-18 (batch 32) on
    CIFARSynthetic, two epochs of 3 updates. Each part prints its
    seconds, peak memory, losses and samples/s (the second epoch's).
    Returns (b)'s launches."""
    import torch.distributed as dist

    from tpu_hpc_torch.kernels import attention as fa
    from tpu_hpc_torch.runtime import MeshSpec, build_mesh
    from tpu_hpc_torch.runtime.sim import free_port
    from tpu_hpc_torch.train.vision import (VisionArgs, build_vision_trainer,
                                            run_vision)

    def profile_one(args, mesh=None):
        trainer, ds = build_vision_trainer(args, steps=1, epochs=1,
                                           device=dev, mesh=mesh)
        batch = trainer.cfg.global_batch_size
        got = profiled_update(torch, trainer,
                              lambda i: ds.batch_at(i, batch))
        del trainer
        _release(torch)
        return got

    keys = ("samples_per_s", "update_s", "losses", "final_loss", "n_params",
            "peak_memory_bytes", "global_batch", "sample_shape", "mesh",
            "layout")
    updates = VISION_STEPS * VISION_EPOCHS
    bad, out = [], {}
    t0 = time.perf_counter()
    _peak_reset(torch, dev)
    dist.init_process_group("nccl", init_method=f"tcp://localhost:"
                            f"{free_port()}", world_size=1, rank=0)
    try:
        mesh = build_mesh(MeshSpec(axes={"data": 1}), "cuda")
        unet = run_vision(VisionArgs(workload="unet"), steps=VISION_STEPS,
                          epochs=VISION_EPOCHS, device=dev, mesh=mesh)
        _release(torch)
        prof = profile_one(VisionArgs(workload="unet"), mesh)
    finally:
        dist.destroy_process_group()
    emit("train_vision", check="a_unet", seconds=time.perf_counter() - t0,
         model={k: unet["model"][k] for k in (
             "in_channels", "base_features", "dtype", "param_dtype")},
         profiled_update=prof, **{k: unet.get(k) for k in keys})
    bad += vision_failures("unet", unet, updates)
    out["unet"] = unet
    # (b) the ViT through the flash kernels
    t0 = time.perf_counter()
    _peak_reset(torch, dev)
    zero_flash_launches()
    vit_args = VisionArgs(workload="vit", batch=VIT_BATCH)
    vit = run_vision(vit_args, steps=VISION_STEPS, epochs=VISION_EPOCHS,
                     device=dev)
    launches = fa.kernel_launches()
    expected = vit["model"]["depth"] * vit["grad_accum_steps"] * updates
    _release(torch)
    prof = profile_one(vit_args)
    flash_ms = prof["families"].get("flash_attention", {}).get("ms", 0.0)
    emit("train_vision", check="b_vit", seconds=time.perf_counter() - t0,
         launches=launches, expected_launches=expected,
         attention={"b": VIT_BATCH, "s": 512, "heads": 8, "head_dim": 32,
                    "causal": False},
         profiled_update=prof, flash_device_ms=flash_ms,
         flash_share_of_update=flash_ms / (1e3 * vit["update_s"]),
         **{k: vit.get(k) for k in keys})
    bad += vision_failures("vit", vit, updates, expected)
    if launches != vit["kernel_launches"]:
        bad.append("vit: launch counts moved outside the run")
    # (c) one ViT update through the kernels against the plain versions
    t0 = time.perf_counter()
    _peak_reset(torch, dev)
    r = vit_update_readings(torch, dev)
    emit("train_vision", check="c_vit_kernels_vs_plain",
         seconds=time.perf_counter() - t0,
         max_memory_allocated=torch.cuda.max_memory_allocated(dev),
         control_rejected=not r["control"]["ok"], **r)
    if not r["flash"]["ok"]:
        bad.append(f"vit kernels against plain: {r['flash']}")
    if r["control"]["ok"]:
        bad.append(f"vit: the checks accept the control with rows of "
                   f"attention dropped: {r['control']}")
    _release(torch)
    # (d) ResNet-18
    t0 = time.perf_counter()
    _peak_reset(torch, dev)
    res = run_vision(VisionArgs(workload="resnet", batch=RESNET_BATCH),
                     steps=VISION_STEPS, epochs=VISION_EPOCHS, device=dev)
    emit("train_vision", check="d_resnet", seconds=time.perf_counter() - t0,
         **{k: res.get(k) for k in keys})
    bad += vision_failures("resnet", res, updates)
    _release(torch)
    if bad:
        raise SystemExit("train_vision: " + "; ".join(bad))
    return launches


def naive_halo_conv2d(xs, kernel, bias=None, *, ring, **kw):
    """train_domain's control: the conv with no halo (each band zero-pads
    its own borders), in halo_conv2d's signature."""
    from tpu_hpc_torch.parallel import domain

    del ring, kw
    out = domain.naive_split_conv2d(xs, kernel)
    return out if bias is None else [o + bias.to(o.dtype) for o in out]


def domain_readings(torch, got, one, exact, dtype) -> dict:
    """A domain run (pred, loss, batch stats, gradients) against the
    one-device run's: in float32, output and stats under the float32
    rule and the gradients within DOMAIN_GRAD_REL_RMS; in bf16, the loss
    and stats under the bf16 rule, output and gradients tracking the
    float32 one-device values as the bf16 one-device run's do."""
    from tpu_hpc_torch.checks.tolerance import compare
    from tpu_hpc_torch.train.trainer import tree_leaves

    r = {}
    if dtype == torch.float32:
        r["out"] = compare(got[0], one[0], dtype)
        err = rel_rms(got[3], one[3])
        r["grads"] = {"rel_rms": err, "limit": DOMAIN_GRAD_REL_RMS,
                      "ok": err <= DOMAIN_GRAD_REL_RMS}
    else:
        r["out"] = tracks(got[0], one[0], exact[0])
        r["loss"] = compare(got[1], one[1], dtype)
        r["grads"] = tracks(got[3], one[3], exact[3])
    stats = [compare(a[None], b[None], dtype) for a, b in zip(
        tree_leaves(got[2]), tree_leaves(one[2]))]
    r["stats"] = {"tol_used": max(s["tol_used"] for s in stats),
                  "ok": all(s["ok"] for s in stats), "n": len(stats)}
    return r


def domain_failures(readings, controls) -> list:
    """What fails train_domain: a reading of the sound runs not ok, or a
    no-halo control whose output and gradients both pass the check that
    holds the sound run's."""
    bad = [f"{name}/{k}: {r}" for name, rs in readings.items()
           for k, r in rs.items() if not r["ok"]]
    bad += [f"the checks accept the {name} no-halo control: {r}"
            for name, r in controls.items()
            if r["out"]["ok"] and r["grads"]["ok"]]
    return bad


def train_domain_phase(torch, dev) -> None:
    """Phase 8f, domain parallelism: the U-Net (base 64, 20 channels) on
    a 176 x 360 grid over 4 latitude bands through the in-process halo
    transport on this card, one training forward and backward, against
    the one-device U-Net on the same grid, batch and trees, in float32
    (TF32 off) and in bf16 (``domain_readings``); the same runs with no
    halos (naive_split_conv2d) must be rejected by the same checks. Step
    times and peak memory of both."""
    from unittest import mock

    from tpu_hpc_torch.models import datasets, unet
    from tpu_hpc_torch.models.losses import lat_weighted_mse
    from tpu_hpc_torch.parallel import domain, domain_unet
    from tpu_hpc_torch.train.trainer import tree_leaves, tree_map

    t0 = time.perf_counter()
    lat, lon, ch = DOMAIN_GRID
    cfgs = {name: unet.UNetConfig(in_channels=ch, out_channels=ch,
                                  base_features=64, dtype=dt)
            for name, dt in (("float32", torch.float32),
                             ("bfloat16", torch.bfloat16))}
    params, state = unet.init_unet(torch.Generator(device=dev).manual_seed(0),
                                   cfgs["float32"], dev)
    x, y = (t.to(dev) for t in datasets.ERA5Synthetic(
        lat=lat, lon=lon, n_vars=ch, n_levels=1).batch_at(0, DOMAIN_BATCH))

    def step(apply):
        p = tree_map(lambda t: t.detach().clone().requires_grad_(True),
                     params)
        pred, ns = apply(p, state, x)
        loss = lat_weighted_mse(pred, y)
        loss.backward()
        grads = torch.cat([t.grad.float().reshape(-1)
                           for t in tree_leaves(p)])
        return pred.detach(), loss.detach().reshape(1, 1), ns, grads

    def timed(apply):
        _peak_reset(torch, dev)
        step(apply)  # warm-up
        torch.cuda.synchronize()
        t = time.perf_counter()
        got = step(apply)
        torch.cuda.synchronize()
        return got, 1e3 * (time.perf_counter() - t), \
            torch.cuda.max_memory_allocated(dev)

    runs, times, readings, controls = {}, {}, {}, {}
    for name, cfg in cfgs.items():
        dtype = getattr(torch, name)
        dom = domain_unet.make_domain_unet(
            domain.InProcessHalo(DOMAIN_DEGREE), cfg)
        with no_tf32(torch):
            runs[name, "one"], *times[name, "one"] = timed(
                lambda p, s, t, cfg=cfg: unet.apply_unet(p, s, t, cfg))
            runs[name, "domain"], *times[name, "domain"] = timed(dom)
            with mock.patch.object(domain_unet.domain, "halo_conv2d",
                                   naive_halo_conv2d):
                no_halo = step(dom)
        one, exact = runs[name, "one"], runs["float32", "one"]
        readings[name] = domain_readings(torch, runs[name, "domain"], one,
                                         exact, dtype)
        controls[name] = domain_readings(torch, no_halo, one, exact, dtype)
    emit("train_domain", degree=DOMAIN_DEGREE, transport="in_process",
         grid=list(DOMAIN_GRID), batch=DOMAIN_BATCH, base_features=64,
         loss={f"{n}/{k}": float(r[1]) for (n, k), r in runs.items()},
         readings=readings, control_no_halo=controls,
         step_ms={f"{n}/{k}": t[0] for (n, k), t in times.items()},
         peak_memory_bytes={f"{n}/{k}": t[1] for (n, k), t in times.items()},
         seconds=time.perf_counter() - t0)
    bad = domain_failures(readings, controls)
    _release(torch)
    if bad:
        raise SystemExit("train_domain: " + "; ".join(bad))


def train_long_phase(torch, dev, train) -> dict:
    """Phase 8g, bench.py's llama-long row: the bench Llama at seq 8192,
    microbatch 1 accumulated 8 times, through run_train: two epochs of
    one update (the first is warm-up), each flash kernel's launches set
    to 0 before and read after (layers x accum x updates); tokens/s,
    MFU, update_s and peak memory beside train's."""
    import math

    from tpu_hpc_torch.kernels import attention as fa
    from tpu_hpc_torch.train.__main__ import bench_model_cfg, run_train

    t0 = time.perf_counter()
    cfg = bench_model_cfg(seq_len=LONG_SEQ)
    zero_flash_launches()
    summary = run_train(cfg, steps=1, epochs=LONG_UPDATES,
                        batch=LONG_ACCUM, grad_accum_steps=LONG_ACCUM,
                        device=dev,
                        metric=f"llama2_seq{LONG_SEQ}_tokens_per_s_per_chip")
    launches = fa.kernel_launches()
    expected = cfg.n_layers * LONG_ACCUM * LONG_UPDATES
    emit("train_long", metric=summary["metric"], seq_len=LONG_SEQ,
         microbatch=1, grad_accum=LONG_ACCUM, updates=summary["updates"],
         launches=launches, expected_launches=expected,
         seconds=time.perf_counter() - t0,
         train={k: train[k] for k in ("tokens_per_s", "update_s", "mfu",
                                      "peak_memory_bytes")},
         **{k: summary[k] for k in ("tokens_per_s", "mfu", "update_s",
                                    "peak_memory_bytes", "losses",
                                    "flash_tile_rows")})
    bad = []
    if len(summary["losses"]) != LONG_UPDATES or not all(
            math.isfinite(x) for x in summary["losses"]):
        bad.append(f"losses {summary['losses']}")
    if any(n != expected for n in launches.values()) \
            or launches != summary["kernel_launches"]:
        bad.append(f"flash launches {launches}, expected {expected} each")
    _release(torch)
    if bad:
        raise SystemExit("train_long: " + "; ".join(bad))
    return launches


def kernel_family(name: str) -> str:
    """A profiled kernel by what it does."""
    low = name.lower()
    if "flash_" in low:
        return "flash_attention"
    if "nccl" in low:
        return "nccl"
    if any(s in low for s in ("conv", "fprop", "dgrad", "wgrad", "cudnn",
                              "winograd", "implicit")):
        return "conv"
    if any(s in low for s in ("gemm", "xmma", "cutlass", "cublas", "wgmma",
                              "nvjet")):
        return "matmul"
    if "elementwise" in low or "vectorized" in low:
        return "elementwise"
    if "reduce" in low or "softmax" in low or "norm" in low:
        return "reduction"
    return "other"


def profiled_update(torch, trainer, batch_at) -> dict:
    """One update of ``trainer`` on ``batch_at(1)`` under torch.profiler,
    after a warm-up update on ``batch_at(0)``: device time by kernel
    family, the top kernels, the all-reduce ranges (count and host
    time), and the share of the update's wall time the card sat idle
    (the profiler's own overhead counts as idle, so that share is an
    upper bound). A measurement, not a gate: if the profiler records no
    device time it says so and the run goes on."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    trainer.train_step(batch_at(0))
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        trainer.train_step(batch_at(1))
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    events = prof.key_averages()
    kernels = [(e.key, e.self_device_time_total / 1e3, e.count)
               for e in events if e.device_type == DeviceType.CUDA]
    busy_ms = sum(ms for _, ms, _ in kernels)
    families: dict = {}
    for name, ms, count in kernels:
        fam = families.setdefault(kernel_family(name),
                                  {"ms": 0.0, "launches": 0})
        fam["ms"] += ms
        fam["launches"] += count
    return {"wall_ms": wall_ms, "device_time_available": busy_ms > 0,
            "device_busy_ms": busy_ms,
            "idle_share": (1.0 - busy_ms / wall_ms) if busy_ms > 0 else None,
            "families": families,
            "all_reduce": {e.key: {"count": e.count,
                                   "host_ms": e.cpu_time_total / 1e3}
                           for e in events if "all_reduce" in e.key
                           and e.device_type != DeviceType.CUDA},
            "top": [{"kernel": n[:100], "ms": ms, "launches": c}
                    for n, ms, c in sorted(kernels, key=lambda k: -k[1])[:12]]}


def train_profile_phase(torch, dev) -> None:
    """One bench-Llama update under torch.profiler
    (``profiled_update``)."""
    from tpu_hpc_torch.train.__main__ import bench_model_cfg, build_trainer

    trainer, ds = build_trainer(bench_model_cfg(), batch=TRAIN_BATCH,
                                grad_accum_steps=TRAIN_ACCUM, device=dev)
    emit("train_profile", model="bench", updates=1,
         microbatches=TRAIN_ACCUM,
         **profiled_update(torch, trainer,
                           lambda i: ds.batch_at(i, TRAIN_BATCH)))
    del trainer
    torch.cuda.empty_cache()


class FirstGradients:
    """An optimizer that keeps a copy of the first update's gradients --
    the mean over the microbatches, before any optimizer math -- and
    then defers to ``inner``."""

    def __init__(self, inner):
        self.inner, self.grads = inner, None

    def init(self, params):
        return self.inner.init(params)

    def apply(self, params, grads, state, norm=None):
        if self.grads is None:
            self.grads = [g.detach().clone() for g in grads]
        return self.inner.apply(params, grads, state, norm)


# train_crosscheck limits: about 10x what the flash kernels measured
# against the reference attention on an NVIDIA H100 80GB HBM3 (700 W;
# they differ in float32 summation order only): losses 9.1e-8 relative,
# the first gradients at 0.106 of the CROSS_GRAD_RTOL bound and 1.06e-6
# relative in norm, params 2.8e-6 apart after 3 updates.
CROSS_LOSS_RTOL = 1e-6
CROSS_GRAD_RTOL = 5e-5
CROSS_GRAD_REL_NORM = 1e-5
CROSS_PARAM_ATOL = 3e-5


def train_crosscheck_phase(torch, dev) -> None:
    """Bench width in float32, 2 layers, seq 512: 3 updates through the
    flash kernels and through the reference attention, from the same
    params and batches. The first update's gradients (taken before the
    optimizer, whose per-weight normalisation would hide a gradient off
    by a factor) agree per element to CROSS_GRAD_RTOL of the element
    plus CROSS_GRAD_RTOL of its tensor's RMS, and per tensor to
    CROSS_GRAD_REL_NORM in norm; losses to CROSS_LOSS_RTOL; every
    parameter after 3 updates to CROSS_PARAM_ATOL."""
    from tpu_hpc_torch.config import TrainingConfig
    from tpu_hpc_torch.models import datasets, llama2
    from tpu_hpc_torch.parallel import tp
    from tpu_hpc_torch.train.__main__ import bench_model_cfg
    from tpu_hpc_torch.train.trainer import Trainer, make_optimizer, tree_leaves

    cfg = bench_model_cfg(seq_len=512, n_layers=2, dtype=torch.float32)
    tcfg = TrainingConfig(epochs=1, steps_per_epoch=3, global_batch_size=4,
                          grad_accum_steps=2, learning_rate=3e-4,
                          weight_decay=0.1, seed=0)
    params = llama2.init_llama(torch.Generator(device=dev).manual_seed(3),
                               cfg, dev)
    ds = datasets.TokenStream(vocab_size=cfg.vocab_size, seq_len=512, seed=1)
    results = {}
    for impl in ("cuda", "reference"):
        opt = FirstGradients(make_optimizer(tcfg))
        trainer = Trainer(tcfg, None, llama2.make_forward(
            cfg, attn_fn=tp.make_tp_flash_attn_fn(None, impl=impl)),
            params, optimizer=opt, device=dev)
        res = trainer.fit(ds)
        flat = torch.cat([p.detach().reshape(-1)
                          for p in tree_leaves(trainer.state.params)])
        results[impl] = (res["epochs"][0]["losses"], flat, opt.grads)
        del trainer
    (l_cuda, p_cuda, g_cuda), (l_ref, p_ref, g_ref) = (
        results["cuda"], results["reference"])
    loss_err = max(abs(a - b) / abs(b) for a, b in zip(l_cuda, l_ref))
    grad_used, grad_rel = 0.0, 0.0
    for gc, gr in zip(g_cuda, g_ref):
        rms = float(gr.square().mean().sqrt())
        bound = (CROSS_GRAD_RTOL * (gr.abs() + rms)).clamp_min(1e-30)
        grad_used = max(grad_used, float(((gc - gr).abs() / bound).max()))
        grad_rel = max(grad_rel, float(torch.linalg.vector_norm(gc - gr))
                       / float(torch.linalg.vector_norm(gr)))
    max_diff = float((p_cuda - p_ref).abs().max())
    emit("train_crosscheck", model="bench-width-2-layers", dtype="float32",
         seq_len=512, updates=3, losses_cuda=l_cuda, losses_reference=l_ref,
         loss_max_rel_err=loss_err, grad_tol_used=grad_used,
         grad_max_rel_norm_err=grad_rel, grad_tensors=len(g_ref),
         param_max_abs_diff=max_diff, params=int(p_ref.numel()),
         limits={"loss_rtol": CROSS_LOSS_RTOL, "grad_rtol": CROSS_GRAD_RTOL,
                 "grad_rel_norm": CROSS_GRAD_REL_NORM,
                 "param_atol": CROSS_PARAM_ATOL})
    if (loss_err > CROSS_LOSS_RTOL or grad_used > 1.0
            or grad_rel > CROSS_GRAD_REL_NORM or max_diff > CROSS_PARAM_ATOL):
        raise SystemExit(
            f"train_crosscheck: losses {loss_err}, gradients {grad_used} of "
            f"their bound and {grad_rel} in norm, params {max_diff} -- "
            "over the limits"
        )
    del params, results
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------
# Phase 11: training that survives
# ---------------------------------------------------------------------

# Non-finite planted in one element: (name, tensor, index, value). The
# flash indices are [b, s, h, d] of the training shape: q rows in the
# last q tile (every key tile's dk/dv walk reaches it), keys in the
# first key tile (every q tile's forward and dq walk reaches it), so the
# kernels' causal tile skipping cannot hide a row the plain versions
# (which sum over every key) make non-finite. The prefill indices are
# q's [kv head, row, group, d] and a key of the first live page.
NONFINITE_FLASH = (
    ("q_nan_row", "q", (0, 2040, 3, 5), "nan"),
    ("q_inf_row", "q", (1, 2000, 6, 9), "inf"),
    ("k_nan_key", "k", (0, 3, 2, 7), "nan"),
    ("k_inf_key", "k", (2, 5, 4, 11), "inf"),
    ("v_nan_key", "v", (3, 1, 1, 2), "nan"),
)
NONFINITE_PREFILL = (
    ("q_nan_row", "q", (5, 100, 0, 7), "nan"),
    ("q_inf_row", "q", (9, 30, 0, 3), "inf"),
    ("k_nan_key", "k", (3, 5, 7), "nan"),
    ("k_inf_key", "k", (6, 20, 9), "inf"),
)
# The prefill's pools and q dtypes: the wgmma route (bf16 over bf16) and
# the scalar route's float32 and mixed 16-bit cases.
NONFINITE_PREFILL_ROUTES = (("bfloat16", "bfloat16"), ("float32", "float32"),
                            ("float16", "bfloat16"))
# The decode (decode_case's 7B shape): a q row [slot, kv head, group,
# d], and a live key or value (slot, position <= that slot's pos, kv
# head, d); over an int8 pool the key's or value's page scale is
# planted instead (an int8 page holds no NaN or inf).
NONFINITE_DECODE = (
    ("q_nan_row", "q", (0, 5, 0, 7), "nan"),
    ("k_nan_live_key", "k", (1, 300, 11, 3), "nan"),
    ("v_inf_live_key", "v", (4, 17, 20, 9), "inf"),
)
TRAIN_SHAPE = (4, 2048, 8, 128)


def nonfinite_rows(torch, t):
    """Which rows (every index but the last) hold a non-finite value."""
    return ~torch.isfinite(t.float()).all(dim=-1)


def nonfinite_reading(torch, got, want, dtype) -> dict:
    """The kernel's non-finite rows against the plain version's, and the
    tolerance rule on the rows finite in both."""
    from tpu_hpc_torch.checks.tolerance import compare

    bad_got, bad_want = nonfinite_rows(torch, got), nonfinite_rows(torch, want)
    keep = ~(bad_got | bad_want)
    r = {"rows": int(bad_want.numel()), "nonfinite": int(bad_want.sum()),
         "same_rows": bool(torch.equal(bad_got, bad_want))}
    if keep.any():
        c = compare(got[keep], want[keep], dtype)
        r.update(finite_rows_ok=c["ok"], tol_used=c["tol_used"])
    else:
        r.update(finite_rows_ok=True, tol_used=0.0)
    r["ok"] = r["same_rows"] and r["finite_rows_ok"]
    return r


def flash_nonfinite(torch, dev, shape=TRAIN_SHAPE, cases=NONFINITE_FLASH):
    """Each case: bf16 q, k, v, dO and an lse cotangent from a seed (as
    in the flash phase), one element planted; the forward, dq and dk/dv
    wrappers against their plain versions (the backward from the plain
    forward's lse and D). Returns one reading per case."""
    from tpu_hpc_torch.kernels import attention as fa

    b, s, h, d = shape
    out = []
    for name, which, idx, value in cases:
        gen = torch.Generator(device=dev).manual_seed(11)
        t = {n: torch.randn(shape, generator=gen, device=dev).bfloat16()
             for n in ("q", "k", "v", "dout")}
        t[which][idx] = float(value)
        q, k, v, dout = t["q"], t["k"], t["v"], t["dout"]
        dlse = torch.randn((b, s, h), generator=gen, device=dev)
        o, lse = fa.flash_attention_fwd(q, k, v)
        want_o, want_l = fa.flash_attention_fwd_ref(q, k, v)
        dm = (dout.float() * want_o.float()).sum(-1) - dlse
        bargs = (q, k, v, dout, want_l, dm)
        dq = fa.flash_attention_dq(*bargs)
        dk, dv = fa.flash_attention_dkv(*bargs)
        want_dq = fa.flash_attention_dq_ref(*bargs)
        want_dk, want_dv = fa.flash_attention_dkv_ref(*bargs)
        lse_same = bool(torch.equal(~torch.isfinite(lse),
                                    ~torch.isfinite(want_l)))
        readings = {
            n: nonfinite_reading(torch, g, w, torch.bfloat16)
            for n, g, w in (("out", o, want_o), ("dq", dq, want_dq),
                            ("dk", dk, want_dk), ("dv", dv, want_dv))}
        out.append({"case": name, "planted": which, "at": list(idx),
                    "value": value, "lse_same_rows": lse_same,
                    "ok": lse_same and all(r["ok"] for r in readings.values()),
                    **readings})
    return out


def prefill_nonfinite(torch, dev, cases=NONFINITE_PREFILL,
                      routes=NONFINITE_PREFILL_ROUTES):
    """The prefill (the 7B chunk of 256 at start 256) over each route's
    pool and q dtype, with one element of q or of a live key planted,
    against its plain version (the rule of q's dtype)."""
    from tpu_hpc_torch.kernels import paged_attention as pa

    out = []
    for pool, q_dtype in routes:
        dtype = getattr(torch, q_dtype)
        for name, which, idx, value in cases:
            args, kw, _ = prefill_case(torch, dev, 32, 1, pool, 256, dtype)
            q, k, v, table, start = args
            if which == "q":
                q[idx] = float(value)
            else:
                k[(int(table[0]),) + idx] = float(value)
            got = pa.paged_prefill_attention(q, k, v, table, start, **kw)
            want = pa.paged_prefill_attention_ref(q, k, v, table, start,
                                                  **kw)
            r = nonfinite_reading(torch, got, want, dtype)
            route = (pa.paged_prefill_route(q.dtype, k.dtype, q.shape[-1],
                                            kw["block_size"])
                     if q.is_cuda else None)
            out.append({"case": name, "pool": pool, "q_dtype": q_dtype,
                        "route": route, "planted": which, "at": list(idx), "value": value,
                        **r})
    return out


def decode_nonfinite(torch, dev, cases=NONFINITE_DECODE,
                     pools=("bfloat16", "int8")):
    """The decode (split, in-block merge and combine) at decode_case's 7B
    shape, whose dead table entries and pages past each slot's last live
    page are NaN, with one NaN or inf planted in a q row or in a key or
    value the slot sees (over an int8 pool: that page's scale), against
    its plain version. Rows of the other slots must stay finite."""
    from tpu_hpc_torch.kernels import paged_attention as pa

    out = []
    for pool in pools:
        for name, which, idx, value in cases:
            args, kw, _ = decode_case(torch, dev, 32, 1, pool == "int8")
            q, k, v, tables = args[:4]
            if which == "q":
                q[idx] = float(value)
            else:
                slot, p, h, d = idx
                page = int(tables[slot, p // kw["block_size"]])
                if pool == "int8":
                    kw[f"{which}_scale"][page] = float(value)
                else:
                    (k if which == "k" else v)[
                        page, p % kw["block_size"], h, d] = float(value)
            got = pa.paged_decode_attention(*args, **kw)
            want = pa.paged_decode_attention_ref(*args, **kw)
            r = nonfinite_reading(torch, got, want, torch.bfloat16)
            n_split = (pa.paged_decode_splits(q.shape[0], q.shape[1],
                                              q.shape[2], kw["max_blocks"])
                       if q.is_cuda else None)
            out.append({"case": name, "pool": pool, "planted": which,
                        "at": list(idx), "value": value, "n_split": n_split,
                        **r})
    return out


def snapshot(torch, state) -> list:
    """Copies of every tensor of a TrainState (params, moments, count)."""
    from tpu_hpc_torch.train.trainer import tree_leaves

    leaves = list(tree_leaves(state.params))
    for value in state.opt_state.values():
        leaves += value if isinstance(value, list) else [value]
    return [t.detach().clone() if isinstance(t, torch.Tensor) else t
            for t in leaves]


def same_bits(torch, a, b) -> bool:
    return len(a) == len(b) and all(
        torch.equal(x, y) if isinstance(x, torch.Tensor) else x == y
        for x, y in zip(a, b))


def resilient_trainer(torch, dev, cfg, workdir=None, *, steps=2, epochs=3,
                      metrics=""):
    """The bench run's trainer (build_trainer: seed, batch, accumulation,
    AdamW) with guard_mode skip and a checkpoint manager saving every
    epoch under ``workdir`` (none without one)."""
    from tpu_hpc_torch.train.__main__ import build_trainer

    return build_trainer(cfg, steps=steps, epochs=epochs, batch=TRAIN_BATCH,
                         grad_accum_steps=TRAIN_ACCUM, device=dev,
                         guard_mode="skip", checkpoint_dir=workdir,
                         save_every=1, metrics_path=metrics)


@contextlib.contextmanager
def armed(faults: str):
    """``$TPU_HPC_FAULTS=faults`` for the block: the trainer reads the
    plan when it is built, the checkpoint manager at each save."""
    import os

    os.environ["TPU_HPC_FAULTS"] = faults
    try:
        yield
    finally:
        del os.environ["TPU_HPC_FAULTS"]


def read_events(path, kind) -> list:
    with open(path) as f:
        return [r for r in map(json.loads, f) if r.get("event") == kind]


def resilience_skip(torch, dev, cfg, workdir) -> dict:
    """(a) guard skip under nan_loss_at_step=3: one update per chunk,
    five chunks; exactly one poisoned verdict, at data index 3, and the
    state after that update bit-identical to the state before it."""
    import os

    metrics = os.path.join(workdir, "run.jsonl")
    with armed("nan_loss_at_step=3"):
        tr, ds = resilient_trainer(torch, dev, cfg, steps=1, epochs=5,
                                   metrics=metrics)
    inner, snaps = tr._step, {}

    def spy(state, batch, off=0):
        if state.step == 3:
            snaps["before"] = snapshot(torch, state)
        new, m = inner(state, batch, off)
        if state.step == 3:
            snaps["after"] = snapshot(torch, new)
        return new, m

    tr._step = spy
    res = tr.fit(ds)
    verdicts = [(v["step"], v["verdict"], v["action"], v["data_index"])
                for v in read_events(metrics, "guard_verdict")]
    same = same_bits(torch, snaps["before"], snaps["after"])
    losses = [x for e in res["epochs"] for x in e["losses"]]
    return {"verdicts": verdicts, "state_bit_identical": same,
            "losses": [x if x == x else None for x in losses],
            "ok": verdicts == [(3, "poisoned", "skip", 3)] and same
            and all(x == x for i, x in enumerate(losses) if i != 3)}


def step_bytes(path) -> int:
    import os

    return sum(os.path.getsize(os.path.join(r, f))
               for r, _, fs in os.walk(path) for f in fs)


def resilience_resume(torch, dev, cfg, workdir) -> dict:
    """(b) save every epoch (2 updates each, 3 epochs, guard skip), then
    a fresh trainer resumes from the epoch-2 step (step 6 held out) and
    trains epoch 3: params, moments and count equal the uninterrupted
    run's bit for bit. The uninterrupted run is this slice's main path:
    the flash kernels' counts are set to 0 just before it and read just
    after (layers x accum x updates each). Also times the manager on the
    bench state: save's blocking part (staging to host) and its whole
    write, save_now, restore_latest, and the bytes of one step."""
    import os
    import time as _t

    from tpu_hpc_torch.ckpt import CheckpointManager
    from tpu_hpc_torch.kernels import attention as fa

    ck = os.path.join(workdir, "ck")
    a, ds = resilient_trainer(torch, dev, cfg, ck)
    for fn in (fa.flash_attention_fwd, fa.flash_attention_dq,
               fa.flash_attention_dkv):
        fn.launches = 0
    a.fit(ds)
    launches = fa.kernel_launches()  # this slice's main path: 6 updates
    expected = cfg.n_layers * TRAIN_ACCUM * a.state.step
    steps = a.checkpoint_manager.all_steps()
    want = snapshot(torch, a.state)
    nbytes = step_bytes(os.path.join(ck, "6"))
    # The manager's times, on a directory of their own.
    timing = CheckpointManager(os.path.join(workdir, "timing"))
    torch.cuda.synchronize()
    t0 = _t.perf_counter()
    timing.save(a.state)
    t1 = _t.perf_counter()
    timing.wait()
    t2 = _t.perf_counter()
    timing.save_now(a.state, step=7)
    t3 = _t.perf_counter()
    a.checkpoint_manager.quarantine_step(6, reason="held_out")
    del a
    torch.cuda.empty_cache()
    metrics = os.path.join(workdir, "run.jsonl")
    b, _ = resilient_trainer(torch, dev, cfg, ck, metrics=metrics)
    torch.cuda.synchronize()
    t4 = _t.perf_counter()
    restored = b.checkpoint_manager.restore_latest(b.state)
    torch.cuda.synchronize()
    t5 = _t.perf_counter()
    del restored
    b.fit(ds)
    same = same_bits(torch, snapshot(torch, b.state), want)
    out = {"steps_saved": steps,
           "resumed_from": read_events(metrics, "run_end")[-1][
               "resumed_from_step"],
           "bit_identical": same, "launches": launches,
           "expected_launches": expected,
           "embedding_backward_repeats": embedding_backward_repeats(
               torch, dev, cfg, ds),
           "checkpoint_bytes": nbytes,
           "save_blocking_s": t1 - t0, "save_total_s": t2 - t0,
           "save_now_s": t3 - t2, "restore_latest_s": t5 - t4}
    out["ok"] = (same and steps == [2, 4, 6] and out["resumed_from"] == 4
                 and out["embedding_backward_repeats"]["lookup_backward"]
                 and all(n == expected for n in launches.values()))
    del b
    torch.cuda.empty_cache()
    return out


def embedding_backward_repeats(torch, dev, cfg, ds) -> dict:
    """The embedding lookup's backward twice on one microbatch's tokens
    and one cotangent: bit-identical (llama2's sorted index_put_), where
    ``index_add_`` (atomics) is not."""
    from tpu_hpc_torch.models.llama2 import _EmbedLookup

    tokens = ds.batch_at(0, TRAIN_BATCH // TRAIN_ACCUM)[0].to(dev)
    table = torch.zeros((cfg.vocab_size, cfg.dim), device=dev,
                        requires_grad=True)
    g = torch.randn(tuple(tokens.shape) + (cfg.dim,), device=dev,
                    generator=torch.Generator(device=dev).manual_seed(5))
    grads, adds = [], []
    for _ in range(2):
        (dt,) = torch.autograd.grad(_EmbedLookup.apply(table, tokens), table,
                                    g)
        grads.append(dt)
        d = torch.zeros_like(table)
        adds.append(d.index_add_(0, tokens.reshape(-1),
                                 g.reshape(-1, cfg.dim)))
    return {"lookup_backward": bool(torch.equal(*grads)),
            "index_add_": bool(torch.equal(*adds))}


def resilience_bitflip(torch, dev, cfg, workdir) -> dict:
    """(c) bitflip_ckpt_at_step=4: two epochs saved (steps 2, 4; 4 flipped
    after it landed); a fresh trainer's resume finds step 4's checksums
    wrong, falls back to step 2 and quarantines step 4."""
    import os

    ck = os.path.join(workdir, "ck")
    metrics = os.path.join(workdir, "run.jsonl")
    with armed("bitflip_ckpt_at_step=4"):
        a, ds = resilient_trainer(torch, dev, cfg, ck, epochs=2)
        a.fit(ds)
    del a
    torch.cuda.empty_cache()
    b, _ = resilient_trainer(torch, dev, cfg, ck, metrics=metrics)
    step = b.maybe_resume()
    fallbacks = read_events(metrics, "ckpt_fallback")
    checks = read_events(metrics, "ckpt_integrity")
    out = {"resumed_from": step,
           "fallbacks": [(f["step"], f["quarantined"]) for f in fallbacks],
           "integrity": [(c["step"], c["verdict"]) for c in checks],
           "listing": sorted(os.listdir(ck))}
    out["ok"] = (step == 2 and out["fallbacks"] == [(4, "4.corrupt")]
                 and out["integrity"] == [(4, "mismatch"), (2, "ok")]
                 and "4.corrupt" in out["listing"])
    del b
    torch.cuda.empty_cache()
    return out


def resilience_preempt(workdir) -> dict:
    """(d) the supervised CLI, bench width cut to 2 layers, 3 epochs of 2
    updates, guard skip, a save every epoch, preempt_at_step=2 on
    attempt 0: attempt 0 snapshots and exits 75 (EXIT_RESUMABLE),
    attempt 1 resumes from step 2 and exits 0."""
    import os

    ck, logs = os.path.join(workdir, "ck"), os.path.join(workdir, "logs")
    cmd = [sys.executable, "-m", "tpu_hpc_torch.resilience.supervisor",
           "--max-restarts", "2", "--backoff", "0", "--log-dir", logs, "--",
           sys.executable, "-m", "tpu_hpc_torch.train", "--guard-mode",
           "skip", "--checkpoint-dir", ck, "--save-every", "1",
           "--n-layers", "2", "--steps", "2", "--epochs", "3"]
    env = dict(os.environ, TPU_HPC_FAULTS="preempt_at_step=2")
    proc = subprocess.run(cmd, env=env, capture_output=True, text=True,
                          timeout=600)
    with open(os.path.join(logs, "supervisor.jsonl")) as f:
        events = [json.loads(line) for line in f]
    ends = [(e["attempt"], e["rc"]) for e in events
            if e["event"] == "attempt_end"]
    last = [json.loads(line) for line in
            open(os.path.join(logs, "run.attempt1.log"))
            if line.startswith("{")] if len(ends) > 1 else []
    out = {"rc": proc.returncode, "attempts": ends,
           "resumed_from": last[-1].get("resumed_from_step") if last else None,
           "updates_after_resume": len(last[-1]["losses"]) if last else None}
    out["ok"] = (proc.returncode == 0 and ends == [(0, 75), (1, 0)]
                 and out["resumed_from"] == 2)
    return out


def guard_update_s(torch, dev, cfg, updates=4) -> dict:
    """Update time with guard_mode off and skip, built from the same
    seed and timed in turns (off, skip, skip, off): ``updates`` updates
    between two synchronizations after one warm-up update each."""
    import time as _t

    from tpu_hpc_torch.train.__main__ import build_trainer

    times = {"off": [], "skip": []}
    for mode in ("off", "skip", "skip", "off"):
        tr, ds = build_trainer(cfg, batch=TRAIN_BATCH,
                               grad_accum_steps=TRAIN_ACCUM, device=dev,
                               guard_mode=mode)
        tr.train_step(ds.batch_at(0, TRAIN_BATCH))
        torch.cuda.synchronize()
        t0 = _t.perf_counter()
        for i in range(updates):
            tr.train_step(ds.batch_at(1 + i, TRAIN_BATCH))
        torch.cuda.synchronize()
        times[mode].append((_t.perf_counter() - t0) / updates)
        del tr
        torch.cuda.empty_cache()
    return {m: sum(v) / len(v) for m, v in times.items()} | {"readings": times}


def train_resilience_phase(torch, dev) -> None:
    """(a)-(e) and the manager's timings; any check that fails exits
    non-zero. The checkpoints live under build/ in the checkout and are
    removed after."""
    import shutil
    from pathlib import Path

    from tpu_hpc_torch.train.__main__ import bench_model_cfg

    cfg = bench_model_cfg()
    root = Path(__file__).resolve().parent / "build" / "chip_smoke_resilience"
    shutil.rmtree(root, ignore_errors=True)
    results = {}
    try:
        for name, fn in (("skip", resilience_skip),
                         ("resume", resilience_resume),
                         ("bitflip", resilience_bitflip)):
            work = root / name
            work.mkdir(parents=True)
            results[name] = fn(torch, dev, cfg, str(work))
            emit("train_resilience", check=name, **results[name])
            shutil.rmtree(work, ignore_errors=True)
        (root / "preempt").mkdir(parents=True)
        results["preempt"] = resilience_preempt(str(root / "preempt"))
        emit("train_resilience", check="preempt", **results["preempt"])
    finally:
        shutil.rmtree(root, ignore_errors=True)
    results["flash_nonfinite"] = flash_nonfinite(torch, dev)
    for r in results["flash_nonfinite"]:
        emit("train_resilience", check="flash_nonfinite", **r)
    results["prefill_nonfinite"] = prefill_nonfinite(torch, dev)
    for r in results["prefill_nonfinite"]:
        emit("train_resilience", check="prefill_nonfinite", **r)
    results["decode_nonfinite"] = decode_nonfinite(torch, dev)
    for r in results["decode_nonfinite"]:
        emit("train_resilience", check="decode_nonfinite", **r)
    upd = guard_update_s(torch, dev, cfg)
    emit("train_resilience", check="guard_update_s", model="bench",
         microbatch=TRAIN_BATCH // TRAIN_ACCUM, grad_accum=TRAIN_ACCUM, **upd)
    bad = [k for k, v in results.items()
           if not (all(r["ok"] for r in v) if isinstance(v, list)
                   else v["ok"])]
    if bad:
        raise SystemExit(f"train_resilience: {', '.join(bad)} failed")


# The serving phases' request mix: 16 requests of 100-500 prompt tokens,
# 32 new tokens each.
SERVE_PROMPT_LENS = (100, 180, 260, 340, 420, 500)
SERVE_REQUESTS, SERVE_MAX_NEW = 16, 32


def serve_phase(torch, dev, phase, cfg, serve_cfg, paged) -> dict:
    """run_replay on ``cfg`` through the paged kernels, their launch
    counts set to 0 just before and read just after: every request
    finishes with all its tokens, nothing is rebuilt, both kernels ran.
    Names the prefill route the replay's launches take (one dtype pair
    and shape for the whole replay)."""
    from tpu_hpc_torch.kernels import paged_attention as pa
    from tpu_hpc_torch.serve.server import run_replay

    pool_dtype = torch.int8 if paged.kv_quant == "int8" else cfg.dtype
    route = pa.paged_prefill_route(cfg.dtype, pool_dtype, cfg.head_dim,
                                   paged.block_size)
    pa.paged_decode_attention.launches = 0
    pa.paged_prefill_attention.launches = 0
    summary = run_replay(cfg, serve_cfg, SERVE_REQUESTS, SERVE_PROMPT_LENS,
                         SERVE_MAX_NEW, seed=0, paged=paged, device=dev)
    launches = {
        "paged_decode_attention": pa.paged_decode_attention.launches,
        "paged_prefill_attention": pa.paged_prefill_attention.launches,
    }
    extra = {}
    if paged.kv_quant == "int8":
        # The int8 pool's score error at this model's attention dims
        # and page size, as bench.py pins it onto its int8 rows.
        extra["logit_rmse"] = round(pa.int8_logit_rmse(
            head_dim=cfg.head_dim, kv_heads=cfg.kv_heads,
            n_heads=cfg.n_heads, block_size=paged.block_size), 6)
    emit(phase, model="7b", n_layers=cfg.n_layers, dim=cfg.dim,
         dtype=str(cfg.dtype)[6:], kv_quant=paged.kv_quant,
         prefill_route=route, launches=launches, **extra,
         **{k: summary[k] for k in (
             "requests", "tokens", "wall_s", "tokens_per_s",
             "ttft_ms_p50", "ttft_ms_p95", "ttft_ms_p99", "itl_ms_p50",
             "itl_ms_p95", "itl_ms_p99", "recompiles", "compiled_programs",
             "prefill_chunks", "peak_memory_bytes", "cache_bytes",
             "serve_mfu", "batcher",
         ) if k in summary})
    if summary["requests"] != SERVE_REQUESTS \
            or summary["tokens"] != SERVE_REQUESTS * SERVE_MAX_NEW:
        raise SystemExit(f"{phase}: not every request finished: {summary}")
    if summary["recompiles"] != 0:
        raise SystemExit(f"{phase}: {summary['recompiles']} rebuilds")
    if min(launches.values()) < 1 or launches != summary["kernel_launches"]:
        raise SystemExit(f"{phase}: kernels not on the main path: {launches}")
    want = "wgmma_int8" if paged.kv_quant == "int8" else "wgmma"
    if route != want:
        raise SystemExit(f"{phase}: the prefill takes the {route} route, "
                         f"not {want}")
    torch.cuda.empty_cache()
    return launches


# ---------------------------------------------------------------------
# Phase 5c: speculative decoding and seeded sampling
# ---------------------------------------------------------------------

SPEC_K = 4
SPEC_TEMPERATURE, SPEC_TOP_P = 0.8, 0.95
# The RNG check's (seed, position) pairs, each under streams 0-2.
RNG_SEEDS = (0, 1, 42, 99, 12345, 2**31 - 1)
RNG_POSITIONS = (0, 1, 7, 48, 1000, 4095)
# The target drafting for itself accepts less than every draft: as in
# the JAX package (spec.py's draft program writes K/V for steps
# j < n_valid), the last draft of a clean sweep never has its K/V written
# into the draft pool, so the next draft step reads that position
# unwritten (docs/port/spec_draft_hole.py measures what that costs, and
# that one more write closes it). The gate asks
# only that the accept path ran at scale; the greedy stream is gated
# apart.
SELF_DRAFT_MIN_ACCEPTANCE = 0.5
# Summary keys a virtual-clock loadgen run takes from the host's clock:
# everything else must repeat byte for byte.
WALL_CLOCK_KEYS = ("wall_clock_s", "wall_clock_tokens_per_s",
                   "spec_wall_clock_s", "peak_memory_bytes")


def _release(torch) -> None:
    """Free the card memory of engines just dropped: a spec engine and
    its runner hold each other (engine.spec, runner.engine), so their
    pools and weights go only with a collection of the cycle."""
    import gc

    gc.collect()
    torch.cuda.empty_cache()


def _peak_reset(torch, dev) -> None:
    torch.cuda.synchronize(dev)
    torch.cuda.reset_peak_memory_stats(dev)


def _spec_engine(torch, dev, params, cfg, serve_cfg, paged, mode,
                 draft=None):
    """A paged engine with a SpecRunner (``mode`` None: plain), warmed."""
    from tpu_hpc_torch.serve import PagedEngine, SpecConfig, attach_spec

    eng = PagedEngine(params, cfg, serve_cfg, dev, paged)
    if mode is not None:
        attach_spec(eng, SpecConfig(mode=mode, k=SPEC_K),
                    draft_params=draft[0] if mode == "draft" else None,
                    draft_cfg=draft[1] if mode == "draft" else None)
    return eng, eng.warmup()


def serve_shape() -> tuple:
    """The serving phases' shape: Llama-2-7B, 8 slots of 1024 tokens,
    prefill buckets 256 and 512, a pool of 16-token pages read by the
    cuda kernels; (model config, ServeConfig, PagedConfig)."""
    from tpu_hpc_torch.models import llama2
    from tpu_hpc_torch.serve import PagedConfig, ServeConfig

    serve_cfg = ServeConfig(slots=8, max_seq_len=1024,
                            prefill_buckets=(256, 512))
    paged = PagedConfig(block_size=16, num_blocks=513, prefill_chunk=256,
                        kernel="cuda")
    return llama2.PRESETS["7b"], serve_cfg, paged


def _launch_counts():
    from tpu_hpc_torch.kernels import paged_attention as pa

    return {"paged_decode_attention": pa.paged_decode_attention.launches,
            "paged_prefill_attention": pa.paged_prefill_attention.launches}


def _zero_launches() -> None:
    from tpu_hpc_torch.kernels import paged_attention as pa

    pa.paged_decode_attention.launches = 0
    pa.paged_prefill_attention.launches = 0
    pa.paged_prefill_attention.route_launches = dict.fromkeys(
        pa.PREFILL_ROUTES, 0)


def _drained(eng) -> bool:
    """Both pools back to idle with the allocator identity intact."""
    engines = [eng] + ([eng.spec.draft] if eng.spec is not None
                       and eng.spec.draft is not None else [])
    for e in engines:
        e.allocator.check_invariant()
        if e._slot_state:
            return False
    return True


def spec_greedy_failures(rows) -> list:
    """(a)'s gates over its runs (``"<kernel>/<plain|ngram|draft|
    self_draft>"`` -> row): no rebuild and both pools drained on every
    run; every spec run's greedy tokens equal plain decode's; the
    self-draft accepts at least SELF_DRAFT_MIN_ACCEPTANCE of its drafts;
    on the cuda route the spec prefill
    launched the prefill kernel and the verify (and, for a draft model,
    the draft steps) the decode kernel."""
    failures = []
    for key, row in rows.items():
        kernel, name = key.split("/")
        if row["rebuilds"] or not row["drained"]:
            failures.append(f"{key}: rebuilt or not drained")
        if name == "plain":
            continue
        if not row["equals_plain"]:
            failures.append(f"{key}: greedy tokens differ from plain "
                            f"decode on {row['differing']}")
        if name == "self_draft" and not (
                row["drafted"] > 0 and row["accepted"]
                >= SELF_DRAFT_MIN_ACCEPTANCE * row["drafted"]):
            failures.append(f"{key}: the target drafting for itself "
                            f"accepted {row['accepted']} of "
                            f"{row['drafted']}")
        if kernel == "cuda":
            sl = row["spec_launches"]
            if row["launches"]["paged_prefill_attention"] < 1 \
                    or sl["verify"] < 1 \
                    or (name != "ngram" and sl["draft"] < 1):
                failures.append(f"{key}: kernels not on the spec path: "
                                f"{row['launches']} {sl}")
    return failures


def spec_greedy(torch, dev, cfg, serve_cfg, paged) -> dict:
    """(a) 7B width, 2 layers, float32 (the crosscheck's model), its
    half-depth draft: under kernel="cuda" and "gather", the greedy
    streams of ngram spec and of draft spec equal the plain greedy
    stream on every request. Launches counted per run."""
    from tpu_hpc_torch.models import llama2
    from tpu_hpc_torch.serve import ContinuousBatcher, replay_requests
    from tpu_hpc_torch.serve.spec import default_draft_config

    small = dataclasses.replace(cfg, n_layers=2, dtype=torch.float32)
    dcfg = default_draft_config(small)
    params = llama2.init_llama(
        torch.Generator(device=dev).manual_seed(1), small, dev)
    draft = (llama2.init_llama(
        torch.Generator(device=dev).manual_seed(2), dcfg, dev), dcfg)
    rows = {}
    for kernel in ("cuda", "gather"):
        pk = dataclasses.replace(paged, kernel=kernel)
        base = None
        # The self-draft (the target drafting for itself) accepts every
        # greedy draft: the accept path and the bonus draw on the card.
        for name in ("plain", "ngram", "draft") + (
                ("self_draft",) if kernel == "cuda" else ()):
            mode = {"plain": None, "self_draft": "draft"}.get(name, name)
            eng, n_programs = _spec_engine(
                torch, dev, params, small, serve_cfg, pk, mode,
                (params, small) if name == "self_draft" else draft)
            reqs = replay_requests(SERVE_REQUESTS, small.vocab_size,
                                   SERVE_PROMPT_LENS, SERVE_MAX_NEW, seed=0)
            _zero_launches()
            got = ContinuousBatcher(eng).run(reqs)
            launches = _launch_counts()
            row = {"launches": launches,
                   "rebuilds": eng.compile_count_total - n_programs,
                   "drained": _drained(eng),
                   "tokens": sum(len(t) for t in got.values())}
            if name == "plain":
                base = got
            else:
                row.update(
                    equals_plain=got == base,
                    differing=[r for r in base if got[r] != base[r]],
                    spec_launches=dict(eng.spec.kernel_launches),
                    **{k: eng.spec.stats[k] for k in (
                        "verify_steps", "drafted", "accepted", "emitted")})
                row["verify_launches_per_decode_token"] = (
                    row["spec_launches"]["verify"] / row["emitted"])
            rows[f"{kernel}/{name}"] = row
            del eng
            _release(torch)
    emit("serve_spec", check="a_greedy_exact", model="7b-width-2-layers",
         draft_layers=dcfg.n_layers, dtype="float32", k=SPEC_K, runs=rows)
    failures = spec_greedy_failures(rows)
    if failures:
        raise SystemExit(f"serve_spec (a): {failures}")
    del params, draft
    _release(torch)
    return rows


def spec_rng(torch, dev) -> dict:
    """(b) The threefry keys, uniforms (plain and the Gumbel's, floored
    at float32's tiny) and categorical draws on the card equal the same
    calls on the CPU, bit for bit (the CPU ones are what the CPU tests
    pin against jax.random)."""
    import numpy as np

    from tpu_hpc_torch.serve import prng

    tiny = torch.finfo(torch.float32).tiny
    seeds, positions = torch.tensor(RNG_SEEDS), torch.tensor(RNG_POSITIONS)
    probs = np.random.default_rng(0).dirichlet(
        np.full(32000, 0.1), size=len(RNG_SEEDS)).astype(np.float32)
    probs[:, ::3] = 0.0
    probs = torch.tensor(probs / probs.sum(-1, keepdims=True))
    checks = {}
    for stream in (0, 1, 2):
        kc = prng.position_keys(seeds, positions, stream)
        kg = prng.position_keys(seeds.to(dev), positions.to(dev), stream)
        checks[f"keys_{stream}"] = torch.equal(kc, kg.cpu())
        checks[f"uniform_{stream}"] = torch.equal(
            prng.uniform(kc).view(torch.int32),
            prng.uniform(kg).cpu().view(torch.int32))
        checks[f"gumbel_uniform_{stream}"] = torch.equal(
            prng.uniform(kc, 32000, minval=tiny).view(torch.int32),
            prng.uniform(kg, 32000, minval=tiny).cpu().view(torch.int32))
        checks[f"categorical_{stream}"] = torch.equal(
            prng.categorical_probs(kc, probs),
            prng.categorical_probs(kg, probs.to(dev)).cpu())
    emit("serve_spec", check="b_rng_card_equals_cpu", seeds=list(RNG_SEEDS),
         positions=list(RNG_POSITIONS), vocab=32000, equal=checks)
    if not all(checks.values()):
        raise SystemExit(f"serve_spec (b): card draws differ from the "
                         f"CPU's: {checks}")
    return checks


def spec_sampled(torch, dev, cfg, serve_cfg, paged) -> dict:
    """(c) The serve phase's 16 requests at temperature 0.8, top-p 0.95
    through ngram spec on Llama-2-7B (bf16, the cuda route): two
    replays, then the requests submitted in reverse order (other slots,
    other batch company) -- the same tokens each time; the pools drain,
    nothing is rebuilt after warmup, the kernels ran."""
    from tpu_hpc_torch.models import llama2
    from tpu_hpc_torch.serve import ContinuousBatcher, replay_requests
    from tpu_hpc_torch.serve.weights import place_params

    params = place_params(llama2.init_llama(
        torch.Generator(device=dev).manual_seed(0), cfg, dev), cfg, dev)
    runs = []
    for order in ("submitted", "again", "reversed"):
        eng, n_programs = _spec_engine(torch, dev, params, cfg, serve_cfg,
                                       paged, "ngram")
        reqs = replay_requests(SERVE_REQUESTS, cfg.vocab_size,
                               SERVE_PROMPT_LENS, SERVE_MAX_NEW, seed=0,
                               temperature=SPEC_TEMPERATURE,
                               top_p=SPEC_TOP_P)
        if order == "reversed":
            reqs = reqs[::-1]
        _peak_reset(torch, dev)
        _zero_launches()
        t0 = time.perf_counter()
        got = ContinuousBatcher(eng).run(reqs)
        torch.cuda.synchronize(dev)
        wall = time.perf_counter() - t0
        launches = _launch_counts()
        tokens = sum(len(t) for t in got.values())
        st = eng.spec.stats
        runs.append({
            "order": order, "streams": got, "wall_s": wall,
            "tokens": tokens, "tokens_per_s": tokens / wall,
            "launches": launches,
            "spec_launches": dict(eng.spec.kernel_launches),
            "verify_launches_per_decode_token": (
                eng.spec.kernel_launches["verify"]
                / max(1, tokens - len(got))),
            "rebuilds": eng.compile_count_total - n_programs,
            "drained": _drained(eng),
            "peak_memory_bytes": torch.cuda.max_memory_allocated(dev),
            **{k: st[k] for k in ("verify_steps", "drafted", "accepted",
                                  "emitted")},
        })
        del eng
        _release(torch)
    del params
    _release(torch)
    same = [r["streams"] == runs[0]["streams"] for r in runs[1:]]
    emit("serve_spec", check="c_sampled", model="7b", dtype="bfloat16",
         temperature=SPEC_TEMPERATURE, top_p=SPEC_TOP_P, k=SPEC_K,
         replay_equal=same[0], reversed_equal=same[1],
         runs=[{k: v for k, v in r.items() if k != "streams"}
               for r in runs])
    for r in runs:
        if r["tokens"] != SERVE_REQUESTS * SERVE_MAX_NEW or r["rebuilds"] \
                or not r["drained"]:
            raise SystemExit(f"serve_spec (c) {r['order']}: unfinished, "
                             f"rebuilt or not drained")
        if r["launches"]["paged_prefill_attention"] < 1 \
                or r["spec_launches"]["verify"] < 1:
            raise SystemExit(f"serve_spec (c): kernels not on the spec "
                             f"path: {r['launches']}")
    if not all(same):
        raise SystemExit(f"serve_spec (c): sampled streams moved with the "
                         f"replay or the slots: {same}")
    return runs[0]


def spec_loadgen(torch, dev, cfg, serve_cfg, paged) -> dict:
    """(d) decode_heavy through run_loadgen at the serve phase's shape
    (16 requests, generation budgets up to 32 tokens after prompts up
    to a quarter of the 512 bucket), without and with ngram spec, twice
    each: the virtual-clock summaries repeat byte for byte."""
    from tpu_hpc_torch.serve import SpecConfig
    from tpu_hpc_torch.serve.server import run_loadgen

    out = {}
    for name, spec in (("plain", None),
                       ("ngram", SpecConfig(mode="ngram", k=SPEC_K))):
        summaries = []
        for _ in range(2):
            _zero_launches()
            summaries.append(run_loadgen(
                cfg, serve_cfg, "decode_heavy", SERVE_REQUESTS,
                SERVE_MAX_NEW, seed=0, paged=paged, device=dev, spec=spec))
            _release(torch)
        virtual = [json.dumps({k: v for k, v in sm.items()
                               if k not in WALL_CLOCK_KEYS}, sort_keys=True)
                   for sm in summaries]
        sm = summaries[0]
        row = {
            "identical": virtual[0] == virtual[1],
            "tokens": sm["tokens"], "decode_steps": sm["decode_steps"],
            "recompiles": sm["recompiles"],
            "kernel_launches": sm["kernel_launches"],
            "virtual": {k: sm[k] for k in (
                "ttft_ms_p50", "ttft_ms_p99", "itl_ms_p50", "itl_ms_p99")},
            "wall_clock_tokens_per_s": [
                x["wall_clock_tokens_per_s"] for x in summaries],
            "wall_clock_s": [x["wall_clock_s"] for x in summaries],
            "peak_memory_bytes": sm.get("peak_memory_bytes"),
        }
        if spec is not None:
            row.update(
                spec_launches=sm["spec_kernel_launches"],
                **{k: sm[k] for k in ("acceptance_rate", "drafted",
                                      "accepted", "verify_steps",
                                      "draft_ms")},
                emitted=sm["spec_emitted"],
                wall_clock_draft_verify_s=[
                    x["spec_wall_clock_s"] for x in summaries],
            )
        out[name] = row
    emit("serve_spec", check="d_loadgen", scenario="decode_heavy",
         model="7b", requests=SERVE_REQUESTS, max_new=SERVE_MAX_NEW, runs=out)
    for name, row in out.items():
        if not row["identical"] or row["recompiles"]:
            raise SystemExit(f"serve_spec (d) {name}: virtual-clock "
                             f"summaries differ or rebuilt: {row}")
        if min(row["kernel_launches"].values()) < 1:
            raise SystemExit(f"serve_spec (d) {name}: kernels not on the "
                             f"path: {row['kernel_launches']}")
    return out


def verify_kernel_failures(readings, control, inactive_zero) -> list:
    """(e)'s gates: the kernel inside the bf16 rule with the inactive
    slot's rows exact zeros, and the control (no + j) rejected by the
    same rule."""
    failures = []
    if not readings["ok"] or not inactive_zero:
        failures.append(f"the decode kernel over verify pseudo-slots is "
                        f"outside the bf16 rule: {readings}")
    if control["ok"]:
        failures.append(f"the tolerance accepts the pseudo-slots without "
                        f"+ j: {control}")
    return failures


def spec_verify_kernel(torch, dev) -> dict:
    """(e) The decode kernel over verify pseudo-slots (row j of slot s:
    s's table row at position pos + j) at the 7B shape -- ragged
    positions, one inactive slot, NaN dead pages -- against
    paged_decode_attention_ref over the same pseudo-slots under the
    bf16 rule; the control (every pseudo-slot at its slot's own pos,
    no + j) must be rejected."""
    from tpu_hpc_torch.checks.tolerance import compare
    from tpu_hpc_torch.kernels import paged_attention as pa

    n = SPEC_K + 1
    pos = (1019, 517, 64, 15, 300, 811, 0, 700)
    args, kw, _ = decode_case(torch, dev, 32, 1, False, seed=3, pos=pos,
                              extra=SPEC_K)
    _, k_pages, v_pages, tables, pos_t, active = args
    slots, hkv, g, d = 8, 32, 1, 128
    gen = torch.Generator(device=dev).manual_seed(4)
    q = torch.randn((slots * n, hkv, g, d), generator=gen,
                    device=dev).bfloat16()
    tables_ps = tables.repeat_interleave(n, dim=0).contiguous()
    pos_ps = (pos_t[:, None] + torch.arange(n, device=dev,
                                            dtype=torch.int32)).reshape(-1)
    active_ps = active.repeat_interleave(n).contiguous()
    ps_args = (q, k_pages, v_pages, tables_ps, pos_ps.contiguous(),
               active_ps)
    out = pa.paged_decode_attention(*ps_args, **kw)
    torch.cuda.synchronize()
    want = pa.paged_decode_attention_ref(*ps_args, **kw)
    r = compare(out, want, torch.bfloat16)
    zero_inactive = not out[active_ps == 0].any()
    bad = pa.paged_decode_attention_ref(
        q, k_pages, v_pages, tables_ps,
        pos_t.repeat_interleave(n).contiguous(), active_ps, **kw)
    rc = compare(bad, want, torch.bfloat16)
    # Each input read once: a slot's pages (up to pos + k) once for its
    # k + 1 pseudo-slots, q in and the output out per pseudo-slot; the
    # operations are every pseudo-slot's own.
    page_bytes = kw["block_size"] * hkv * d * 2
    n_bytes = 2 * q.numel() * 2 + 8 * slots * n
    flops = 0
    for p, a in zip(pos, active.tolist()):
        if a:
            pages = (p + SPEC_K) // kw["block_size"] + 1
            n_bytes += 2 * pages * page_bytes + 4 * pages
            flops += sum(4 * hkv * g * (p + j + 1) * d for j in range(n))
    bound_ms, bound_by = bound(n_bytes, flops, torch.bfloat16)
    row = {
        "pseudo_slots": slots * n, "pos": list(pos), "k": SPEC_K,
        "n_split": pa.paged_decode_splits(slots * n, hkv, g,
                                          kw["max_blocks"]),
        "max_abs_err": r["max_abs_err"], "readings": r,
        "inactive_zero": zero_inactive,
        "control_without_plus_j": {"rejected": not rc["ok"], **rc},
        "ms": time_ms(lambda: pa.paged_decode_attention(*ps_args, **kw),
                      iters=50),
        "device_ms": device_ms(
            lambda: pa.paged_decode_attention(*ps_args, **kw),
            "paged_decode"),
        "plain_ms": time_ms(
            lambda: pa.paged_decode_attention_ref(*ps_args, **kw),
            iters=3, warmup=1),
        "bound_ms": bound_ms, "bound_by": bound_by,
    }
    lib = library_decode(torch, ps_args, kw)
    row.update(library_ms=time_ms(lib, iters=50),
               library_device_ms=device_ms(lib, ""))
    emit("serve_spec", check="e_verify_pseudo_slots", **row)
    failures = verify_kernel_failures(r, rc, zero_inactive)
    if failures:
        raise SystemExit(f"serve_spec (e): {failures}")
    return row


def serve_spec_phase(torch, dev, cfg, serve_cfg, paged, plain) -> dict:
    """Phase 5c: (a)-(e), each with its card seconds and peak memory;
    ``plain`` is the serve phase's launches (decode launches per
    decode-emitted token beside the verify's)."""
    t0 = time.perf_counter()
    parts = {}
    for name, fn, fargs in (
        ("a", spec_greedy, (cfg, serve_cfg, paged)),
        ("b", spec_rng, ()),
        ("c", spec_sampled, (cfg, serve_cfg, paged)),
        ("d", spec_loadgen, (cfg, serve_cfg, paged)),
        ("e", spec_verify_kernel, ()),
    ):
        _peak_reset(torch, dev)
        t = time.perf_counter()
        parts[name] = fn(torch, dev, *fargs)
        emit("serve_spec", check=f"{name}_cost",
             seconds=time.perf_counter() - t,
             max_memory_allocated=torch.cuda.max_memory_allocated(dev))
    sampled = parts["c"]
    launches = {
        "draft": sum(r["spec_launches"]["draft"]
                     for r in parts["a"].values() if "spec_launches" in r),
        "verify": sampled["spec_launches"]["verify"],
        "prefill": sampled["launches"]["paged_prefill_attention"],
    }
    emit("serve_spec", check="summary", seconds=time.perf_counter() - t0,
         launches_per_decode_token={
             "plain_decode": plain["paged_decode_attention"]
             / (SERVE_REQUESTS * (SERVE_MAX_NEW - 1)),
             "spec_verify": sampled["verify_launches_per_decode_token"],
         },
         launches=launches)
    return launches



# ---------------------------------------------------------------------
# Phase 5d: serving past one engine -- the host tier, the fleet, restore
# ---------------------------------------------------------------------

# (a) long_idle_sessions through run_loadgen: a 120-page pool the filler
# wave overflows, without a tier and with 512 host slots, and a 513-page
# pool where nothing needs to spill (rehearsed on the CPU at this serve
# shape: the HBM-only pool sheds 9 of the 16 returns, the tiered pool
# none).
TIER_SERVE = dict(slots=4, max_seq_len=1024, prefill_buckets=(256, 512))
TIER_REQUESTS, TIER_MAX_NEW = 48, 32
TIER_BLOCKS, TIER_HOST_BLOCKS, TIER_ROOMY_BLOCKS = 120, 512, 513
# The page round trip's returning prompt: 500 tokens, 31 full pages.
TIER_PROMPT, TIER_SUFFIX, TIER_RETURN_NEW = 500, 8, 8
# (b) the fleet: two replicas on one card over diurnal, each fault run
# against the clean run of the same seed.
FLEET_REQUESTS, FLEET_MAX_NEW = 16, 16
FLEET_KILL_AT, FLEET_SWAP_AT = 6, 10
# The fleet's depth at 7B width. Memory would hold 32 layers (two
# replicas, the published copy and the rollback copy, 4 x 13.5 GB, and
# two 513-page pools, ~63 GB), but each swap checksums the published
# tree and what lands on each replica on the host (ckpt/integrity), so
# the depth sets the phase's time (PERF.md, PR 15).
FLEET_LAYERS = 4
# (c) the bench Llama's updates before the checkpoint is restored, and
# where the checkpoint goes (under build/ in the checkout).
RESTORE_UPDATES = 2
RESTORE_DIR = "build/chip_smoke_restore"


def _sync(torch, dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


@contextlib.contextmanager
def captured_harnesses():
    """The load harnesses (single-engine and fleet) that summarize inside
    the block, in order: their streams are what the exact-token gates
    read (run_loadgen and run_fleet_loadgen return only the summary)."""
    from tpu_hpc_torch.loadgen import harness as lh
    from tpu_hpc_torch.serve import fleet

    seen = []
    originals = {cls: cls.summarize
                 for cls in (lh.LoadHarness, fleet.FleetHarness)}

    def recording(orig):
        def summarize(self, *args, **kwargs):
            seen.append(self)
            return orig(self, *args, **kwargs)
        return summarize

    for cls, orig in originals.items():
        cls.summarize = recording(orig)
    try:
        yield seen
    finally:
        for cls, orig in originals.items():
            cls.summarize = orig


@contextlib.contextmanager
def launches_by_engine():
    """The paged kernels' launches inside each batcher tick, by the
    engine the batcher drives (``id`` of the engine under the cost-model
    proxy): with two replicas in one process the kernels' own counts are
    shared, so a replica's launches are the sum over its ticks."""
    from tpu_hpc_torch.serve.scheduler import ContinuousBatcher

    counts = {}
    orig = ContinuousBatcher.step

    def step(self, *args, **kwargs):
        before = _launch_counts()
        try:
            return orig(self, *args, **kwargs)
        finally:
            after = _launch_counts()
            eng = getattr(self.engine, "_engine", self.engine)
            row = counts.setdefault(id(eng), dict.fromkeys(after, 0))
            for k in after:
                row[k] += after[k] - before[k]

    ContinuousBatcher.step = step
    try:
        yield counts
    finally:
        ContinuousBatcher.step = orig


@contextlib.contextmanager
def loadgen_faults(spec: str):
    """``$TPU_HPC_LOADGEN_FAULTS=spec`` for the block (run_fleet_loadgen
    reads it when it builds the harness)."""
    import os

    os.environ["TPU_HPC_LOADGEN_FAULTS"] = spec
    try:
        yield
    finally:
        del os.environ["TPU_HPC_LOADGEN_FAULTS"]


def page_bytes(torch, eng, blocks) -> list:
    """Pages ``blocks`` of the pool (K, V, and for an int8 pool both
    scale rows) as raw bytes: equal means bit-equal."""
    idx = torch.tensor(list(blocks), dtype=torch.long, device=eng.device)
    parts = [eng.ks, eng.vs] + (
        [eng.k_scales, eng.v_scales] if eng.k_scales is not None else [])
    return [p.index_select(1, idx).contiguous().view(torch.uint8)
            for p in parts]


def same_pages(torch, a, b) -> bool:
    return all(torch.equal(x, y) for x, y in zip(a, b))


def page_round_trip(torch, dev, params, cfg, serve_cfg, quant) -> dict:
    """One tiered engine (16-token pages, 64-page pool, 64 host slots):
    a 500-token prompt served once parks 31 pages in the trie; they
    spill to the host tier and prefetch back. Readings: the refilled
    pages (and an int8 pool's scales) bit-equal to the spilled ones, and
    a control, the same check against the refilled pages one page off,
    that must fail; the return request's greedy tokens after the refill
    equal those of the same request on a chain that never left the card,
    with the paged kernels' launches reading the refilled pages; the
    spill's and refill's seconds and wire bytes beside the time to
    prefill the same prompt again."""
    import numpy as np

    from tpu_hpc_torch.serve import (
        ContinuousBatcher,
        PagedConfig,
        PagedEngine,
        Request,
    )

    eng = PagedEngine(params, cfg, serve_cfg, dev, PagedConfig(
        block_size=16, num_blocks=64, prefill_chunk=256, host_blocks=64,
        kernel="cuda", kv_quant=quant))
    n_programs = eng.warmup()
    rng = np.random.default_rng(3)
    prompt = rng.integers(0, cfg.vocab_size, TIER_PROMPT).tolist()
    ret = prompt + rng.integers(0, cfg.vocab_size, TIER_SUFFIX).tolist()

    def serve(rid, toks, max_new):
        return ContinuousBatcher(eng).run(
            [Request(rid=rid, prompt=toks, max_new_tokens=max_new)])[rid]

    # The reference: the return request on a chain that stayed put.
    serve("first", prompt, 1)
    want_tokens = serve("return", ret, TIER_RETURN_NEW)
    eng.reset_pool()
    serve("first", prompt, 1)
    blocks = eng.trie.match(prompt)
    want = page_bytes(torch, eng, blocks)
    tier = eng.host_tier
    _sync(torch, dev)
    t0 = time.perf_counter()
    spilled = tier.spill_parked(len(blocks))
    _sync(torch, dev)
    spill_s = time.perf_counter() - t0
    left = eng.trie.match(prompt)
    t0 = time.perf_counter()
    refilled = eng.prefetch_prompt(prompt)
    _sync(torch, dev)
    refill_s = time.perf_counter() - t0
    back = eng.trie.match(prompt)
    bit_equal = len(back) == len(blocks) and same_pages(
        torch, page_bytes(torch, eng, back), want)
    shifted = back[1:] + back[:1]
    control_equal = same_pages(torch, page_bytes(torch, eng, shifted), want)
    _zero_launches()
    got_tokens = serve("return", ret, TIER_RETURN_NEW)
    launches = _launch_counts()
    stats = dict(tier.stats)
    # The same prompt prefilled again from nothing.
    eng.reset_pool()
    _sync(torch, dev)
    t0 = time.perf_counter()
    eng.admit(0, prompt, 1)
    while eng.prefill_step(0) is None:
        pass
    _sync(torch, dev)
    reprefill_s = time.perf_counter() - t0
    eng.release(0)
    out = {
        "kv_quant": quant, "pages": len(blocks), "spilled": spilled,
        "refilled": refilled, "left_on_card_after_spill": len(left),
        "bit_equal": bit_equal, "control_one_page_off_equal": control_equal,
        "tokens_after_refill_equal": got_tokens == want_tokens,
        "launches_after_refill": launches,
        "spill_s": spill_s, "refill_s": refill_s,
        "reprefill_s": reprefill_s,
        "spill_wire_bytes": stats["kv_spill_wire_bytes"],
        "refill_wire_bytes": stats["kv_refill_wire_bytes"],
        "refill_gb_per_s": stats["kv_refill_wire_bytes"] / refill_s / 1e9,
        "spill_gb_per_s": stats["kv_spill_wire_bytes"] / spill_s / 1e9,
        "group_pages": tier.group, "inflight_bytes": tier.max_inflight_bytes,
        "rebuilds": eng.compile_count_total - n_programs,
        "host_bytes": tier.host_bytes,
    }
    del eng
    return out


TIER_KEYS = ("shed", "kv_spill_pages", "kv_refill_pages",
             "kv_spill_wire_bytes", "kv_refill_wire_bytes", "kv_hop_ms_p50",
             "kv_hop_ms_p95", "trie_evictions", "prefix_hits", "recompiles",
             "kernel_launches", "wall_clock_s", "wall_clock_tokens_per_s",
             "ttft_ms_p50", "ttft_ms_p95", "peak_memory_bytes")


def tier_runs(torch, dev, cfg, serve_cfg, n=TIER_REQUESTS,
              max_new=TIER_MAX_NEW) -> dict:
    """long_idle_sessions through run_loadgen three times: the small
    pool without a tier ("hbm"), with one ("tiered"), and a pool where
    nothing spills ("roomy"). Each row: the summary's tier, shed and
    timing fields, the return wave's sheds and the greedy streams."""
    from tpu_hpc_torch.serve import PagedConfig
    from tpu_hpc_torch.serve.server import run_loadgen

    runs = {}
    for name, blocks, host in (("hbm", TIER_BLOCKS, 0),
                               ("tiered", TIER_BLOCKS, TIER_HOST_BLOCKS),
                               ("roomy", TIER_ROOMY_BLOCKS, 0)):
        paged = PagedConfig(block_size=16, num_blocks=blocks,
                            prefill_chunk=256, host_blocks=host,
                            kernel="cuda")
        _zero_launches()
        with captured_harnesses() as seen:
            s = run_loadgen(cfg, serve_cfg, "long_idle_sessions", n, max_new,
                            seed=0, paged=paged, device=dev)
        row = {k: s[k] for k in TIER_KEYS if k in s}
        row.update(return_shed=s["tenants"]["return"]["shed"],
                   return_finished=s["tenants"]["return"]["finished"],
                   launches=_launch_counts(),
                   streams=dict(seen[-1].batcher.results))
        tier = seen[-1].engine.host_tier
        if tier is not None:
            # Every hop's seconds (dispatch until the bytes landed) over
            # the wire bytes both ways: the host link as the run used it.
            hop_s = sum(tier._hop_s)
            row.update(hop_s_total=hop_s, link_gb_per_s=(
                s["kv_spill_wire_bytes"] + s["kv_refill_wire_bytes"])
                / hop_s / 1e9 if hop_s else 0.0)
        runs[name] = row
        del seen
        if dev.type == "cuda":
            _release(torch)
    return runs


def tier_failures(runs, trips) -> list:
    """(a)'s gates: the HBM-only pool sheds part of the return wave and
    the tiered pool none, after spilling and refilling pages; every
    request the tiered and roomy runs both served has the same greedy
    tokens; no run rebuilt and every run launched both kernels; each
    page round trip is bit-equal with its one-page-off control unequal,
    with both kernels launched after the refill and the return tokens
    equal to the chain that never left."""
    failures = []
    hbm, tiered, roomy = runs["hbm"], runs["tiered"], runs["roomy"]
    if hbm["return_shed"] < 1:
        failures.append("hbm: the return wave shed nothing")
    if tiered["return_shed"] != 0:
        failures.append(f"tiered: {tiered['return_shed']} returns shed")
    if tiered.get("kv_spill_pages", 0) < 1 \
            or tiered.get("kv_refill_pages", 0) < 1:
        failures.append("tiered: nothing spilled or refilled")
    common = sorted(set(tiered["streams"]) & set(roomy["streams"]))
    differ = [r for r in common
              if tiered["streams"][r] != roomy["streams"][r]]
    if differ or not common:
        failures.append(f"tiered vs roomy: tokens differ on {differ}")
    for name, row in runs.items():
        if row["recompiles"] or min(row["launches"].values()) < 1:
            failures.append(f"{name}: rebuilt or a kernel never launched "
                            f"{row['launches']}")
    for trip in trips:
        q = trip["kv_quant"]
        if not trip["bit_equal"] or trip["refilled"] != trip["pages"] \
                or trip["left_on_card_after_spill"]:
            failures.append(f"{q}: refilled pages not bit-equal")
        if trip["control_one_page_off_equal"]:
            failures.append(f"{q}: the one-page-off control passed")
        if not trip["tokens_after_refill_equal"] or trip["rebuilds"] \
                or min(trip["launches_after_refill"].values()) < 1:
            failures.append(f"{q}: tokens or kernels after the refill")
    return failures


FLEET_KEYS = ("lost_requests", "shed", "recompiles", "wall_clock_s",
              "wall_clock_tokens_per_s", "ttft_ms_p50", "ttft_ms_p95",
              "itl_ms_p50", "itl_ms_p95", "kernel_launches",
              "peak_memory_bytes", "tokens")


def fleet_run(torch, dev, cfg, serve_cfg, paged, faults="", swap_at=None,
              n=FLEET_REQUESTS, max_new=FLEET_MAX_NEW) -> dict:
    """run_fleet_loadgen over diurnal with two replicas on ``dev``
    (``faults`` in $TPU_HPC_LOADGEN_FAULTS). The row: the summary's
    fleet block and timing fields, the greedy streams, each replica's
    paged-kernel launches, and the published update's checksums with
    each replica's weights verified against them after the run."""
    from tpu_hpc_torch.ckpt.integrity import leaf_checksums
    from tpu_hpc_torch.serve.server import run_fleet_loadgen
    from tpu_hpc_torch.serve.weights import flat_params

    _zero_launches()
    with loadgen_faults(faults), captured_harnesses() as seen, \
            launches_by_engine() as by_engine:
        s = run_fleet_loadgen(
            cfg, serve_cfg, "diurnal", n, max_new, paged, n_replicas=2,
            min_replicas=2, initial_replicas=2, swap_at=swap_at, seed=0,
            devices=[dev, dev])
    h = seen[-1]
    row = {k: s[k] for k in FLEET_KEYS if k in s}
    row.update(
        fleet=s["fleet"], streams=dict(h.fleet.results),
        replica_launches=[by_engine.get(id(r.engine._engine))
                          for r in h.fleet.replicas],
        launches=_launch_counts())
    src = h.fleet._weights_src
    if src is not None:
        # Leaves off the published checksums, recomputed here (not
        # through verify_tree, which the control run replaces).
        row["replicas_off_published"] = []
        for r in h.fleet.replicas:
            mine = leaf_checksums(flat_params(r.engine.params))
            row["replicas_off_published"].append(sum(
                mine.get(p, {}).get("crc32") != rec["crc32"]
                for p, rec in src[1].items()))
    del seen, h
    return row


def fleet_runs(torch, dev, cfg, serve_cfg, paged) -> dict:
    """(b)'s runs: clean, a replica killed mid-decode, a clean swap, a
    corrupt swap, and the control: the corrupt swap with verify_tree
    skipped."""
    from tpu_hpc_torch.ckpt import integrity

    runs = {}
    for name, faults, swap in (
            ("clean", "", None),
            ("kill", f"replica_kill_at={FLEET_KILL_AT}", None),
            ("swap", "", FLEET_SWAP_AT),
            ("corrupt", "swap_corrupt=1", FLEET_SWAP_AT)):
        runs[name] = fleet_run(torch, dev, cfg, serve_cfg, paged, faults,
                               swap)
        if dev.type == "cuda":
            _release(torch)
    verify = integrity.verify_tree
    integrity.verify_tree = lambda restored, sums, shards=False: []
    try:
        runs["corrupt_unverified"] = fleet_run(
            torch, dev, cfg, serve_cfg, paged, "swap_corrupt=1",
            FLEET_SWAP_AT)
    finally:
        integrity.verify_tree = verify
    if dev.type == "cuda":
        _release(torch)
    return runs


def altered_after_redispatch(runs) -> dict:
    """The control for the redispatch gate: the kill run with the last
    token of one stream changed."""
    kill = dict(runs["kill"])
    streams = {k: list(v) for k, v in kill["streams"].items()}
    rid = sorted(streams)[0]
    streams[rid][-1] += 1
    kill["streams"] = streams
    return {**runs, "kill": kill}


def fleet_failures(runs) -> list:
    """(b)'s gates: no run lost a request or rebuilt, and every run
    launched both kernels in both replicas; the kill was detected and
    redispatched with the streams byte-identical to the clean run's; the
    clean swap rolled through both replicas; the corrupt swap rolled back
    with the streams of the old weights; and the swap with verify_tree
    skipped let the corrupt weights through (a replica serves weights
    off the published checksums) -- the check is what catches them."""
    failures = []
    clean = runs["clean"]
    for name in ("clean", "kill", "swap", "corrupt"):
        row = runs[name]
        if row["lost_requests"] or row["recompiles"]:
            failures.append(f"{name}: lost requests or rebuilt")
        if any(r is None or min(r.values()) < 1
               for r in row["replica_launches"]):
            failures.append(f"{name}: a replica launched no kernel "
                            f"{row['replica_launches']}")
    kill = runs["kill"]
    if kill["fleet"]["replica_down"] != 1 \
            or kill["fleet"]["redispatched"] < 1:
        failures.append("kill: no replica down or nothing redispatched")
    if kill["streams"] != clean["streams"]:
        failures.append("kill: redispatched streams differ from clean")
    swap = runs["swap"]["fleet"]
    if swap["swapped_replicas"] != 2 or swap["weights_version"] != 1 \
            or swap["swap_rollbacks"]:
        failures.append(f"swap: did not roll through both replicas {swap}")
    corrupt = runs["corrupt"]
    if corrupt["fleet"]["swap_rollbacks"] != 1 \
            or corrupt["fleet"]["weights_version"] != 0 \
            or corrupt["streams"] != clean["streams"]:
        failures.append("corrupt: no rollback or old weights not serving")
    unverified = runs["corrupt_unverified"]
    if unverified["fleet"]["swap_rollbacks"] \
            or not any(unverified.get("replicas_off_published", [])):
        failures.append("corrupt_unverified: the corrupt weights did not "
                        "get through without the check")
    return failures


def restore_part(torch, dev, workdir, target_cfg, serve_cfg, paged,
                 train_cfg=None, batch=TRAIN_BATCH,
                 accum=TRAIN_ACCUM) -> dict:
    """(c) The bench Llama trained RESTORE_UPDATES updates with a
    checkpoint saved, restored by load_serving_params (seconds, bytes):
    bit-equal to the trainer's params, and the greedy replay from it
    equal to the replay from the trainer's in-memory params. Then the
    checkpoint is the draft (build_spec's draft_ckpt, the CLI's
    --spec-draft-ckpt) of ``target_cfg``: spec greedy equals plain
    greedy, with its acceptance."""
    import os
    import shutil

    from tpu_hpc_torch.models import llama2
    from tpu_hpc_torch.serve import (
        ContinuousBatcher,
        PagedEngine,
        SpecConfig,
        replay_requests,
    )
    from tpu_hpc_torch.serve.server import build_spec
    from tpu_hpc_torch.serve.weights import flat_params, load_serving_params
    from tpu_hpc_torch.train.__main__ import bench_model_cfg, build_trainer

    cfg = train_cfg or bench_model_cfg()
    ck = os.path.join(workdir, "ck")
    shutil.rmtree(ck, ignore_errors=True)
    trainer, ds = build_trainer(cfg, steps=RESTORE_UPDATES, epochs=1,
                                batch=batch, grad_accum_steps=accum,
                                device=dev, checkpoint_dir=ck,
                                save_every=1)
    trainer.fit(ds)
    step = trainer.checkpoint_manager.all_steps()[-1]
    _sync(torch, dev)
    t0 = time.perf_counter()
    restored = load_serving_params(ck, cfg, dev)
    _sync(torch, dev)
    restore_s = time.perf_counter() - t0
    live = {k: v.detach() for k, v in flat_params(trainer.state.params).items()}
    bit_equal = all(torch.equal(v, live[k])
                    for k, v in flat_params(restored).items())

    def replay(params, c, spec=None):
        eng = PagedEngine(params, c, serve_cfg, dev, paged)
        if spec is not None:
            spec(eng)
        n_programs = eng.warmup()
        reqs = replay_requests(SERVE_REQUESTS, c.vocab_size,
                               SERVE_PROMPT_LENS, SERVE_MAX_NEW, seed=0)
        got = ContinuousBatcher(eng).run(reqs)
        stats = dict(eng.spec.stats) if eng.spec is not None else {}
        return got, stats, eng.compile_count_total - n_programs

    from_ckpt, _, r0 = replay(restored, cfg)
    from_live, _, r1 = replay(trainer.state.params, cfg)
    del trainer, ds, restored, live
    if dev.type == "cuda":
        _release(torch)
    target = llama2.init_llama(
        torch.Generator(device=dev).manual_seed(1), target_cfg, dev)
    plain, _, r2 = replay(target, target_cfg)
    spec, stats, r3 = replay(target, target_cfg, lambda eng: build_spec(
        eng, target_cfg, SpecConfig(mode="draft", k=SPEC_K), draft_ckpt=ck,
        draft_cfg=cfg))
    del target
    nbytes = step_bytes(os.path.join(ck, str(step)))
    shutil.rmtree(ck, ignore_errors=True)
    return {
        "checkpoint_step": step, "checkpoint_bytes": nbytes,
        "restore_s": restore_s, "restored_bit_equal": bit_equal,
        "replay_equal": from_ckpt == from_live,
        "spec_equals_plain": spec == plain,
        "differing": [r for r in plain if spec.get(r) != plain[r]],
        "drafted": stats.get("drafted", 0),
        "accepted": stats.get("accepted", 0),
        "acceptance": (stats.get("accepted", 0) / stats["drafted"]
                       if stats.get("drafted") else 0.0),
        "rebuilds": r0 + r1 + r2 + r3,
    }


def restore_failures(row) -> list:
    failures = []
    for key in ("restored_bit_equal", "replay_equal", "spec_equals_plain"):
        if not row[key]:
            failures.append(f"restore: {key} is false")
    if row["rebuilds"] or row["drafted"] < 1:
        failures.append("restore: rebuilt, or the draft drafted nothing")
    return failures


def serve_tier_fleet_phase(torch, dev, cfg, workdir, fleet_layers) -> dict:
    """Phase 5d: (a) the host tier at 7B, (b) the fleet at 7B width and
    ``fleet_layers`` layers, (c) restore into the serving layout; each
    part's seconds and peak memory. Returns the paged kernels' launches
    (the tiered run's, after each refill, and by fleet replica)."""
    from tpu_hpc_torch.models import llama2
    from tpu_hpc_torch.serve import ServeConfig
    from tpu_hpc_torch.serve.weights import place_params

    t_phase = time.perf_counter()
    # (a)
    _peak_reset(torch, dev)
    t = time.perf_counter()
    tier_serve = ServeConfig(**TIER_SERVE)
    runs = tier_runs(torch, dev, cfg, tier_serve)
    params = place_params(llama2.init_llama(
        torch.Generator(device=dev).manual_seed(0), cfg, dev), cfg, dev)
    _release(torch)
    trips = [page_round_trip(torch, dev, params, cfg, tier_serve, q)
             for q in ("none", "int8")]
    del params
    _release(torch)
    emit("serve_tier_fleet", check="a_tier", model="7b",
         n_layers=cfg.n_layers, requests=TIER_REQUESTS,
         pool_blocks=TIER_BLOCKS, host_blocks=TIER_HOST_BLOCKS,
         roomy_blocks=TIER_ROOMY_BLOCKS,
         runs={k: {f: v for f, v in r.items() if f != "streams"}
               for k, r in runs.items()},
         page_round_trips=trips)
    failures = tier_failures(runs, trips)
    emit("serve_tier_fleet", check="a_cost", seconds=time.perf_counter() - t,
         max_memory_allocated=torch.cuda.max_memory_allocated(dev))
    if failures:
        raise SystemExit(f"serve_tier_fleet (a): {failures}")
    # (b)
    _peak_reset(torch, dev)
    t = time.perf_counter()
    fcfg = dataclasses.replace(cfg, n_layers=fleet_layers)
    _, serve_cfg, fpaged = serve_shape()
    fruns = fleet_runs(torch, dev, fcfg, serve_cfg, fpaged)
    one = one_engine(torch, dev, fcfg, serve_cfg, fpaged)
    emit("serve_tier_fleet", check="b_fleet", model="7b",
         n_layers=fleet_layers, replicas=2, requests=FLEET_REQUESTS,
         kill_at=FLEET_KILL_AT, swap_at=FLEET_SWAP_AT,
         runs={k: {f: v for f, v in r.items() if f != "streams"}
               for k, r in fruns.items()},
         one_engine=one, swap_timing=swap_timing(torch, dev, fcfg))
    failures = fleet_failures(fruns)
    control = fleet_failures(altered_after_redispatch(fruns))
    emit("serve_tier_fleet", check="b_cost", seconds=time.perf_counter() - t,
         max_memory_allocated=torch.cuda.max_memory_allocated(dev),
         altered_stream_rejected=bool(control))
    if failures or not control:
        raise SystemExit(f"serve_tier_fleet (b): {failures}, control "
                         f"{control}")
    _release(torch)
    # (c)
    _peak_reset(torch, dev)
    t = time.perf_counter()
    small = dataclasses.replace(cfg, n_layers=2, dtype=torch.float32)
    row = restore_part(torch, dev, workdir, small, serve_cfg, fpaged)
    emit("serve_tier_fleet", check="c_restore", model="bench",
         target="7b-width-2-layers", target_dtype="float32", **row)
    failures = restore_failures(row)
    emit("serve_tier_fleet", check="c_cost", seconds=time.perf_counter() - t,
         max_memory_allocated=torch.cuda.max_memory_allocated(dev))
    if failures:
        raise SystemExit(f"serve_tier_fleet (c): {failures}")
    _release(torch)
    launches = {
        k: {"tiered": runs["tiered"]["launches"][k],
            "after_refill": trips[0]["launches_after_refill"][k],
            "fleet_replicas": [r[k] for r in fruns["clean"]
                               ["replica_launches"]]}
        for k in ("paged_decode_attention", "paged_prefill_attention")}
    launches[INT8_PREFILL] = {"after_refill": trips[1][
        "launches_after_refill"]["paged_prefill_attention"]}
    emit("serve_tier_fleet", check="summary",
         seconds=time.perf_counter() - t_phase, launches=launches)
    return launches


def one_engine(torch, dev, cfg, serve_cfg, paged) -> dict:
    """The fleet's comparison: the same diurnal mix through run_loadgen
    on one engine of the same depth (wall seconds and tokens/s)."""
    from tpu_hpc_torch.serve.server import run_loadgen

    s = run_loadgen(cfg, serve_cfg, "diurnal", FLEET_REQUESTS,
                    FLEET_MAX_NEW, seed=0, paged=paged, device=dev)
    if dev.type == "cuda":
        _release(torch)
    return {k: s[k] for k in ("wall_clock_s", "wall_clock_tokens_per_s",
                              "tokens", "ttft_ms_p50", "itl_ms_p50",
                              "peak_memory_bytes") if k in s}


def swap_timing(torch, dev, cfg) -> dict:
    """The two steps of a swap on one replica's weights, timed: the
    placement (fresh buffers on the card) and the checksum over what
    landed (ckpt/integrity, which hashes on the host)."""
    from tpu_hpc_torch.ckpt.integrity import leaf_checksums, verify_tree
    from tpu_hpc_torch.models import llama2
    from tpu_hpc_torch.serve.weights import flat_params, place_params

    src = place_params(llama2.init_llama(
        torch.Generator(device=dev).manual_seed(1), cfg, dev), cfg, dev)
    sums = leaf_checksums(flat_params(src))
    _sync(torch, dev)
    t0 = time.perf_counter()
    placed = place_params(src, cfg, dev)
    _sync(torch, dev)
    t1 = time.perf_counter()
    bad = verify_tree(flat_params(placed), sums)
    t2 = time.perf_counter()
    nbytes = sum(t.numel() * t.element_size()
                 for t in flat_params(placed).values())
    del src, placed
    return {"place_s": t1 - t0, "checksum_s": t2 - t1, "bytes": nbytes,
            "verified": not bad}


# ---------------------------------------------------------------------
# Phase 12: observability -- anomaly capture, torch.profiler windows and
# the trace analyzer on the card
# ---------------------------------------------------------------------

OBS_DIR = "build/chip_smoke_obs"
OBS_REQUESTS, OBS_MAX_NEW = 24, 32
# The capture's window on the serving run: the server's own
# (serve/server.py's run_loadgen builds AnomalyCapture(dir, n_steps=8)).
OBS_CAPTURE_TICKS = 8
OBS_CONTROL_LAYERS = 2
# The bench-Llama profile window and its updates (bench update numbers).
OBS_PROFILE_START, OBS_PROFILE_STEPS, OBS_PROFILE_UPDATES = 2, 2, 5
# The JAX test's straggler fault (tests/test_trace.py), at the bench
# Llama: 400 ms on top of an update of about 0.38 s makes that update
# about 2x the median, under StallDetector's default watermark of 3x
# the median (which the JAX test's millisecond steps clear 100-fold),
# so the capture run watches at OBS_STALL_FACTOR; updates run within a
# few percent of each other.
OBS_FAULTS = "straggler_ms=400,straggler_at_step=7,on_attempt=-1"
OBS_STALL_FACTOR = 1.5
OBS_CAPTURE_UPDATES = 9
PAGED_DEVICE_KERNELS = ("paged_decode_split_kernel",
                        "paged_decode_combine_kernel",
                        "paged_prefill_wgmma_kernel",
                        "paged_prefill_int8_kernel", "paged_prefill_kernel")
FLASH_DEVICE_KERNELS = {"flash_attention_fwd": "flash_fwd_wgmma_kernel",
                        "flash_attention_dq": "flash_dq_wgmma_kernel",
                        "flash_attention_dkv": "flash_dkv_wgmma_kernel"}


def _all_launches():
    from tpu_hpc_torch.kernels import attention as fa

    return {**_launch_counts(), **fa.kernel_launches()}


@contextlib.contextmanager
def recorded_windows(torch, dev):
    """Every profiler window opened in the block, with the kernel
    wrappers' launch counts when it opened and when it closed, its
    trace file, its start seconds (the process's first start pays for
    the CUDA profiling library's set-up) and its stop + export seconds;
    and every capture
    trigger, with ``torch.cuda.max_memory_allocated`` read just before
    it. The counts are the wrappers' own (host side, one per launch);
    the window synchronizes the card at both ends, so the kernels it
    records are the ones launched between the two readings."""
    from tpu_hpc_torch.obs import trace as trace_mod
    from tpu_hpc_torch.profiling import profiler as prof_mod

    windows, triggers = [], []
    start, stop = prof_mod.TrainingProfiler._start, \
        prof_mod.TrainingProfiler.stop
    trigger = trace_mod.AnomalyCapture.trigger

    def _start(self, step):
        t0 = time.perf_counter()
        start(self, step)
        windows.append({"opened_at": int(step), "open": _all_launches(),
                        "start_s": time.perf_counter() - t0,
                        "log_dir": self.log_dir})

    def _stop(self):
        if not self.active:
            return stop(self)
        closing = _all_launches()
        t0 = time.perf_counter()
        try:
            return stop(self)
        finally:
            windows[-1].update(close=closing,
                               stop_export_s=time.perf_counter() - t0,
                               trace_path=self.trace_path)

    def _trigger(self, reason, *args, **kw):
        peak = torch.cuda.max_memory_allocated(dev)
        t0 = time.perf_counter()
        rec = trigger(self, reason, *args, **kw)
        if rec is not None:
            triggers.append({"reason": reason, "max_memory_allocated": peak,
                             "seconds": time.perf_counter() - t0,
                             "record": rec})
        return rec

    prof_mod.TrainingProfiler._start = _start
    prof_mod.TrainingProfiler.stop = _stop
    trace_mod.AnomalyCapture.trigger = _trigger
    try:
        yield windows, triggers
    finally:
        prof_mod.TrainingProfiler._start = start
        prof_mod.TrainingProfiler.stop = stop
        trace_mod.AnomalyCapture.trigger = trigger


def device_kernel_counts(path, names) -> dict:
    """Kernel events in a Chrome trace, by which of ``names`` they
    contain, and how many kernel events it holds in all."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    kernels = [e["name"] for e in events if e.get("cat") == "kernel"]
    counts = {n: sum(1 for k in kernels if n in k) for n in names}
    counts["all_kernels"] = len(kernels)
    return counts


def window_reading(win, device_names) -> dict:
    """A closed window: the wrappers' launches inside it and the
    trace's device events by kernel."""
    launched = {k: win["close"][k] - win["open"][k] for k in win["open"]}
    return {"opened_at": win["opened_at"], "start_s": win["start_s"],
            "stop_export_s": win["stop_export_s"],
            "trace_mb": os.path.getsize(win["trace_path"]) / 2**20,
            "launched": launched,
            "device_events": device_kernel_counts(win["trace_path"],
                                                  device_names)}


@contextlib.contextmanager
def fresh_obs(run_id: str):
    """A fresh event bus (no flight dir: a capture's dump lands in its
    own dir) and registry for the block."""
    from tpu_hpc_torch import obs

    prev_bus = obs.set_bus(obs.EventBus(path=None, run_id=run_id,
                                        flight_dir=""))
    prev_reg = obs.set_registry(obs.MetricsRegistry())
    try:
        yield
    finally:
        obs.set_bus(prev_bus)
        obs.set_registry(prev_reg)


def analyzer_json(root, run_log, flight_dir, chrome) -> dict:
    """``python -m tpu_hpc_torch.obs.trace --json --chrome`` over a run
    log and a flight dir, as a user runs it."""
    out = subprocess.run(
        [sys.executable, "-m", "tpu_hpc_torch.obs.trace", str(run_log),
         "--flight-dir", str(flight_dir), "--json", "--chrome",
         str(chrome)],
        capture_output=True, text=True, timeout=300, cwd=str(root),
        check=True)
    rep = json.loads(out.stdout)
    with open(chrome) as f:
        rep["_chrome_events"] = len(json.load(f)["traceEvents"])
    return rep


def complete_trace_failures(records, rep, n_requests) -> list:
    """tests/test_trace.py's acceptance bundle on a run log and its
    analysis: every request complete or shed (colocate sheds its
    background class while the stall lasts, by design), every
    lifecycle event trace-tagged, 0 orphan spans, >= 95% of TTFT
    attributed."""
    failures = []
    life = [r for r in records if r["event"] in (
        "trace_ctx", "lg_arrival", "lg_admit", "lg_first_token",
        "lg_finish", "lg_shed", "request")
        or (r["event"] == "admission" and "rid" in r)]
    if not life or any("trace_id" not in r for r in life):
        failures.append("lifecycle events without trace ids")
    if rep["orphan_spans"]:
        failures.append(f"{rep['orphan_spans']} orphan spans")
    req = rep["requests"] or {}
    if req.get("count") != n_requests \
            or req.get("complete", 0) + req.get("shed", 0) != n_requests:
        failures.append(f"requests {req.get('count')} counted, "
                        f"{req.get('complete')} complete and "
                        f"{req.get('shed')} shed of {n_requests}")
    for q in ("p50", "p95", "p99"):
        cp = (req.get("ttft_critical_path") or {}).get(q)
        if cp is None or cp["attributed"] < 0.95:
            failures.append(f"TTFT {q} attributed {cp and cp['attributed']}")
    return failures


def obs_serve_run(torch, dev, cfg, serve_cfg, paged, scenario, workdir):
    """run_loadgen with --capture-dir's capture; its summary, run log
    records, recorded windows and triggers, and the wrappers' launches
    over the run (set to 0 just before), the prefill's by route too."""
    import shutil

    from tpu_hpc_torch.kernels import paged_attention as pa
    from tpu_hpc_torch.obs.schema import load_records
    from tpu_hpc_torch.serve.server import run_loadgen

    shutil.rmtree(workdir, ignore_errors=True)
    os.makedirs(workdir)
    run_log = os.path.join(workdir, "run.jsonl")
    cap_dir = os.path.join(workdir, "anomaly")
    _zero_launches()
    _peak_reset(torch, dev)
    with fresh_obs("chip-smoke-obs"), recorded_windows(torch, dev) as (
            windows, triggers):
        t0 = time.perf_counter()
        summary = run_loadgen(cfg, serve_cfg, scenario, OBS_REQUESTS,
                              OBS_MAX_NEW, metrics_path=run_log, seed=0,
                              paged=paged, device=dev, capture_dir=cap_dir)
        seconds = time.perf_counter() - t0
    launches = _launch_counts()
    routes = dict(pa.paged_prefill_attention.route_launches)
    _release(torch)
    return {"summary": summary, "records": load_records(run_log),
            "run_log": run_log, "cap_dir": cap_dir, "windows": windows,
            "triggers": triggers, "launches": launches,
            "prefill_routes": routes, "seconds": seconds}


def obs_serve_part(torch, dev, cfg, serve_cfg, paged, root) -> tuple:
    """(a): the 7B colocate run with its capture, the analyzer over its
    log, and the two controls. Returns (readings, failures, launches)."""
    from tpu_hpc_torch.kernels import paged_attention as pa
    from tpu_hpc_torch.profiling import profiler_busy

    failures = []
    work = os.path.join(root, OBS_DIR)
    run = obs_serve_run(torch, dev, cfg, serve_cfg, paged, "colocate",
                        os.path.join(work, "serve"))
    recs = run["records"]
    caps = [r for r in recs if r["event"] == "capture_triggered"]
    stall_ids = [r["trace_id"] for r in recs if r["event"] == "stall"]
    mem = [r for r in recs if r["event"] == "device_memory"]
    if len(caps) != 1 or run["summary"].get("captures") != 1:
        failures.append(f"(a) {len(caps)} capture records, summary "
                        f"captures {run['summary'].get('captures')}")
    cap = caps[0] if caps else {}
    if cap.get("reason") != "stall" or cap.get("trace_id") not in stall_ids:
        failures.append(f"(a) capture {cap.get('reason')} keyed "
                        f"{cap.get('trace_id')}, not a stall's id")
    if not cap.get("flight_path") or not os.path.exists(cap["flight_path"]):
        failures.append("(a) no flight dump")
    if not cap.get("profile_dir") or cap.get("n_steps") != OBS_CAPTURE_TICKS:
        failures.append(f"(a) no profiler window: {cap}")
    if len(run["windows"]) != 1 or "trace_path" not in run["windows"][0] \
            or profiler_busy():
        failures.append("(a) the capture window did not close by itself")
    window = (window_reading(run["windows"][0], PAGED_DEVICE_KERNELS)
              if run["windows"] and "trace_path" in run["windows"][0]
              else None)
    n_split = pa.paged_decode_splits(
        serve_cfg.slots, cfg.kv_heads, cfg.n_heads // cfg.kv_heads,
        serve_cfg.max_seq_len // paged.block_size)
    if window is not None:
        n = window["launched"]["paged_decode_attention"]
        ev = window["device_events"]
        want = {"paged_decode_split_kernel": n,
                "paged_decode_combine_kernel": n if n_split > 1 else 0}
        if n < 1 or any(ev[k] != v for k, v in want.items()):
            failures.append(f"(a) decode kernels in the window {ev}, "
                            f"the wrapper launched {n} (n_split {n_split})")
    # Every prefill launch of the bf16 pool takes the bf16 wgmma kernel,
    # counted by route where the wrapper launches it.
    routes = run["prefill_routes"]
    if sum(routes.values()) != run["launches"]["paged_prefill_attention"] \
            or routes["wgmma"] != run["launches"]["paged_prefill_attention"] \
            or routes["wgmma"] < 1:
        failures.append(f"(a) prefill launches by route {routes}, the "
                        f"wrapper's {run['launches']}")
    peak = run["triggers"][0]["max_memory_allocated"] \
        if run["triggers"] else None
    total = torch.cuda.get_device_properties(dev).total_memory
    if len(mem) != 1 or mem[0]["hbm_peak_bytes"] != peak \
            or not 0 < mem[0]["hbm_peak_bytes"] < total:
        failures.append(f"(a) device_memory {mem}, max_memory_allocated at "
                        f"the trigger {peak}, card {total}")
    rep = analyzer_json(root, run["run_log"], run["cap_dir"],
                        os.path.join(work, "serve", "chrome.json"))
    failures += ["(a) analyzer: " + f for f in complete_trace_failures(
        recs, rep, OBS_REQUESTS)]
    if [c["reason"] for c in rep["captures"]] != ["stall"] \
            or not rep["_chrome_events"]:
        failures.append(f"(a) analyzer captures {rep['captures']}, chrome "
                        f"events {rep['_chrome_events']}")
    readings = {
        "model": "7b", "n_layers": cfg.n_layers, "scenario": "colocate",
        "requests": OBS_REQUESTS, "seconds": run["seconds"],
        "launches": run["launches"], "prefill_routes": routes,
        "summary": {k: run["summary"].get(k) for k in (
            "tokens", "shed", "captures", "stall_events", "recompiles",
            "ttft_ms_p50", "ttft_ms_p99", "wall_clock_s",
            "wall_clock_tokens_per_s", "peak_memory_bytes")},
        "capture": {k: cap.get(k) for k in ("reason", "trace_id", "step",
                                            "n_steps")},
        "trigger_s": run["triggers"][0]["seconds"] if run["triggers"]
        else None,
        "window": window, "decode_n_split": n_split,
        "device_memory": {k: mem[0][k] for k in (
            "hbm_peak_bytes", "hbm_in_use_bytes", "hbm_limit_bytes")}
        if mem else None,
        "max_memory_allocated_at_trigger": peak,
        "analyzer": {k: rep[k] for k in ("orphan_spans", "n_records")} | {
            "complete": rep["requests"]["complete"],
            "shed": rep["requests"]["shed"],
            "attributed": {q: cp["attributed"] for q, cp in
                           rep["requests"]["ttft_critical_path"].items()},
            "dominant": {q: cp["dominant"] for q, cp in
                         rep["requests"]["ttft_critical_path"].items()},
            "chrome_events": rep["_chrome_events"]},
    }
    # Controls, each of which the gates above must reject.
    small = dataclasses.replace(cfg, n_layers=OBS_CONTROL_LAYERS)
    steady = obs_serve_run(torch, dev, small, serve_cfg, paged, "steady",
                           os.path.join(work, "steady"))
    steady_caps = [r for r in steady["records"]
                   if r["event"] == "capture_triggered"]
    gather = obs_serve_run(torch, dev, small, serve_cfg,
                           dataclasses.replace(paged, kernel="gather"),
                           "colocate", os.path.join(work, "gather"))
    gather_win = (window_reading(gather["windows"][0], PAGED_DEVICE_KERNELS)
                  if gather["windows"] and "trace_path" in gather["windows"][0]
                  else None)
    paged_events = (sum(gather_win["device_events"][k]
                        for k in PAGED_DEVICE_KERNELS)
                    if gather_win else None)
    controls = {
        "steady_captures": len(steady_caps),
        "steady_rejected": not steady_caps
        and steady["summary"].get("captures") == 0,
        "gather_window": gather_win,
        "gather_rejected": gather_win is not None and paged_events == 0
        and gather_win["device_events"]["all_kernels"] > 0
        and gather["launches"]["paged_decode_attention"] == 0,
    }
    readings["controls"] = controls
    if not (controls["steady_rejected"] and controls["gather_rejected"]):
        failures.append(f"(a) a control was not rejected: {controls}")
    launches = {**run["launches"], INT8_PREFILL: routes["wgmma_int8"]}
    return readings, failures, launches


def obs_train_run(torch, dev, updates, *, profile=False, capture=False,
                  workdir):
    """The bench Llama through ``Trainer.fit`` (one update an epoch,
    microbatch 4 x accum 8) with ``profile`` or ``capture_on_anomaly``
    set; its records, windows, triggers and the flash launches over
    the run (set to 0 just before)."""
    import shutil

    from tpu_hpc_torch import obs
    from tpu_hpc_torch.kernels import attention as fa
    from tpu_hpc_torch.obs.schema import load_records
    from tpu_hpc_torch.train.__main__ import bench_model_cfg, build_trainer

    shutil.rmtree(workdir, ignore_errors=True)
    os.makedirs(workdir)
    run_log = os.path.join(workdir, "run.jsonl")
    trainer, ds = build_trainer(
        bench_model_cfg(), steps=1, epochs=updates, batch=TRAIN_BATCH,
        grad_accum_steps=TRAIN_ACCUM, device=dev, metrics_path=run_log,
        train_overrides=dict(
            profile=profile, profile_dir=workdir,
            profile_start_step=OBS_PROFILE_START,
            profile_num_steps=OBS_PROFILE_STEPS,
            capture_on_anomaly=capture))
    if capture:
        trainer.stall = obs.StallDetector(factor=OBS_STALL_FACTOR)
    zero_flash_launches()
    with fresh_obs(f"chip-smoke-train-{'capture' if capture else 'prof'}"), \
            recorded_windows(torch, dev) as (windows, triggers):
        trainer.fit(ds)
    launches = fa.kernel_launches()
    records = load_records(run_log)
    capture_obj = trainer.capture
    del trainer
    _release(torch)
    return {"records": records, "windows": windows, "triggers": triggers,
            "launches": launches, "capture": capture_obj}


def update_seconds(records) -> dict:
    """Each update's seconds from the run log's epoch records, by the
    step it ended at."""
    return {r["step"]: r["s_per_step"] for r in records
            if r["event"] == "epoch"}


def obs_train_part(torch, dev, root) -> tuple:
    """(b): the profiled bench-Llama updates and the straggler capture.
    Returns (readings, failures, launches)."""
    from tpu_hpc_torch.obs import trace as trace_mod
    from tpu_hpc_torch.profiling import profiler_busy
    from tpu_hpc_torch.train.__main__ import bench_model_cfg

    failures = []
    work = os.path.join(root, OBS_DIR)
    prof = obs_train_run(torch, dev, OBS_PROFILE_UPDATES, profile=True,
                         workdir=os.path.join(work, "profile"))
    window = (window_reading(prof["windows"][0],
                             tuple(FLASH_DEVICE_KERNELS.values()))
              if len(prof["windows"]) == 1
              and "trace_path" in prof["windows"][0] else None)
    expected = OBS_PROFILE_STEPS * TRAIN_ACCUM * bench_model_cfg().n_layers
    if window is None or profiler_busy():
        failures.append(f"(b) profile windows {prof['windows']}, "
                        f"busy {profiler_busy()}")
    else:
        for wrapper, kernel in FLASH_DEVICE_KERNELS.items():
            n = window["launched"][wrapper]
            if n != window["device_events"][kernel] or n < 1:
                failures.append(
                    f"(b) {kernel}: {window['device_events'][kernel]} "
                    f"device events, the wrapper launched {n}")
    secs = update_seconds(prof["records"])
    inside = [secs[s + 1] for s in range(
        OBS_PROFILE_START, OBS_PROFILE_START + OBS_PROFILE_STEPS)]
    outside = [secs[s] for s in secs
               if s > 1 and s - 1 not in range(
                   OBS_PROFILE_START, OBS_PROFILE_START + OBS_PROFILE_STEPS)]
    readings = {
        "model": "bench", "updates": OBS_PROFILE_UPDATES,
        "window_steps": [OBS_PROFILE_START,
                         OBS_PROFILE_START + OBS_PROFILE_STEPS],
        "expected_launches_per_kernel": expected,
        "window": window, "launches": prof["launches"],
        "update_s": secs,
        "update_s_profiled": inside, "update_s_unprofiled": outside,
    }
    # The straggler capture.
    with armed(OBS_FAULTS):
        cap = obs_train_run(torch, dev, OBS_CAPTURE_UPDATES, capture=True,
                            workdir=os.path.join(work, "capture"))
    recs = cap["records"]
    stalls = [r for r in recs if r["event"] == "stall"]
    caps = [r for r in recs if r["event"] == "capture_triggered"]
    rep = trace_mod.analyze(recs)
    cap_rec = caps[0] if caps else {}
    if len(caps) != 1 or not stalls \
            or cap_rec.get("trace_id") != stalls[0].get("trace_id"):
        failures.append(f"(b) {len(caps)} captures keyed "
                        f"{cap_rec.get('trace_id')}, stalls "
                        f"{[s.get('trace_id') for s in stalls]}")
    if not cap_rec.get("flight_path") \
            or not os.path.exists(cap_rec["flight_path"]):
        failures.append("(b) no flight dump")
    if rep["orphan_spans"] or (rep["steps"] or {}).get("count", 0) \
            < OBS_CAPTURE_UPDATES:
        failures.append(f"(b) step timelines: {rep['orphan_spans']} orphan "
                        f"spans, {(rep['steps'] or {}).get('count')} steps")
    if cap["capture"] is None or cap["capture"]._prof is not None \
            or profiler_busy():
        failures.append("(b) the capture window was left open")
    cap_window = (window_reading(cap["windows"][0],
                                 tuple(FLASH_DEVICE_KERNELS.values()))
                  if cap["windows"] and "trace_path" in cap["windows"][0]
                  else None)
    readings["capture"] = {
        "faults": OBS_FAULTS, "stall_factor": OBS_STALL_FACTOR,
        "updates": OBS_CAPTURE_UPDATES, "stalls": len(stalls),
        "first_stall": stalls[0]["trace_id"] if stalls else None,
        "record": {k: cap_rec.get(k) for k in (
            "reason", "trace_id", "step", "n_steps")},
        "trigger_s": cap["triggers"][0]["seconds"] if cap["triggers"]
        else None,
        "window": cap_window, "launches": cap["launches"],
        "update_s": update_seconds(recs),
        "steps": {k: rep["steps"][k] for k in ("count", "stalls")},
        "critical_path_p99": rep["steps"]["critical_path"]["p99"],
    }
    launches = {k: {"profile": prof["launches"][k],
                    "profile_window": window["launched"][k]
                    if window else None,
                    "capture": cap["launches"][k]}
                for k in FLASH_DEVICE_KERNELS}
    return readings, failures, launches


def obs_capture_phase(torch, dev, cfg, serve_cfg, paged) -> dict:
    """Phase 12 (``obs_capture``): (a) then (b); every gate's failures
    gathered, the phase line printed, then the phase fails if any gate
    did. Returns the phase's launches by kernel wrapper."""
    import shutil
    from pathlib import Path

    root = Path(__file__).resolve().parent
    t0 = time.perf_counter()
    serve, serve_failures, serve_launches = obs_serve_part(
        torch, dev, cfg, serve_cfg, paged, root)
    train, train_failures, train_launches = obs_train_part(torch, dev, root)
    failures = serve_failures + train_failures
    emit("obs_capture", seconds=time.perf_counter() - t0, serve=serve,
         train=train, failures=failures)
    shutil.rmtree(root / OBS_DIR, ignore_errors=True)
    if failures:
        raise SystemExit(f"obs_capture: {failures}")
    return {**{k: {"serve": n} for k, n in serve_launches.items()},
            **train_launches}


# ---------------------------------------------------------------------
# Phase 13: the operations path -- disaggregated serving, the reshard
# engine, the elastic coordinator
# ---------------------------------------------------------------------

OPS_DIR = "build/chip_smoke_ops"
# (c)'s storm: shrink at update 2, grow back at 4, over 6 updates (one
# update an epoch); on one card both morphs are 1 -> 1.
OPS_STORM = "slice_down_at_step=2,slice_up_at_step=4"
OPS_UPDATES = 6


@contextlib.contextmanager
def recorded_runs():
    """The token streams of every ContinuousBatcher.run inside the
    block, in order (run_replay returns only its summary)."""
    from tpu_hpc_torch.serve.scheduler import ContinuousBatcher

    runs = []
    orig = ContinuousBatcher.run

    def run(self, *args, **kwargs):
        out = orig(self, *args, **kwargs)
        runs.append(dict(out))
        return out

    ContinuousBatcher.run = run
    try:
        yield runs
    finally:
        ContinuousBatcher.run = orig


@contextlib.contextmanager
def recorded_disagg(scatter_at_prefill_ids=False):
    """The DisaggEngines warmed inside the block, each with its tiers'
    paged-kernel launches counted apart (the prefill tier's chunks, the
    decode tier's ticks; counted from the end of warmup) and the bus
    ring's length at that point. ``scatter_at_prefill_ids``: the
    control -- every hop scatters at the PREFILL tier's page ids
    instead of the decode tier's."""
    from tpu_hpc_torch.obs import get_bus
    from tpu_hpc_torch.serve.disagg import DisaggEngine

    engines = []
    orig_warmup, orig_table = DisaggEngine.warmup, DisaggEngine._hop_table
    orig_step = DisaggEngine.prefill_step

    def prefill_step(self, slot):
        """After a prompt's last chunk: the decode tier's pages at ITS
        table's ids hold the prefill tier's pages bit for bit."""
        pe, de = self.prefill_engine, self.decode_engine
        src = pe.slot_table(slot)
        n_pages = -(-len(pe.slot_state(slot).prompt)
                    // self.paged.block_size)
        tok = orig_step(self, slot)
        if tok is not None:
            dst = de.slot_table(slot)
            rec = engines[-1]["hops"]
            rec["checked"] += 1
            s_ids = list(map(int, src[:n_pages]))
            d_ids = list(map(int, dst[:n_pages]))
            pairs = [(pe.ks, de.ks), (pe.vs, de.vs)]
            if pe.k_scales is not None:
                pairs += [(pe.k_scales, de.k_scales),
                          (pe.v_scales, de.v_scales)]
            if not all(a[:, s_ids].equal(b[:, d_ids]) for a, b in pairs):
                rec["mismatched"] += 1
        return tok

    def counted(fn, row):
        def call(*args, **kwargs):
            before = _launch_counts()
            try:
                return fn(*args, **kwargs)
            finally:
                after = _launch_counts()
                for k in after:
                    row[k] += after[k] - before[k]
        return call

    def warmup(self):
        n = orig_warmup(self)
        rec = {"engine": self, "events_from": len(get_bus().ring()),
               "hops": {"checked": 0, "mismatched": 0},
               "tiers": {"prefill": dict.fromkeys(_launch_counts(), 0),
                         "decode": dict.fromkeys(_launch_counts(), 0)}}
        pe, de = self.prefill_engine, self.decode_engine
        tier_fns = (("prefill", pe, "prefill_step"), ("prefill", pe,
                                                      "prefill"),
                    ("decode", de, "decode"))
        for tier, eng, name in tier_fns:
            setattr(eng, name, counted(getattr(eng, name),
                                       rec["tiers"][tier]))
        engines.append(rec)
        return n

    DisaggEngine.warmup = warmup
    DisaggEngine.prefill_step = prefill_step
    if scatter_at_prefill_ids:
        DisaggEngine._hop_table = (
            lambda self, slot: self.prefill_engine.slot_table(slot))
    try:
        yield engines
    finally:
        DisaggEngine.warmup = orig_warmup
        DisaggEngine.prefill_step = orig_step
        DisaggEngine._hop_table = orig_table


def ops_disagg_run(torch, dev, cfg, serve_cfg, paged, n_requests,
                   control=False, prompt_lens=SERVE_PROMPT_LENS,
                   max_new=SERVE_MAX_NEW) -> dict:
    """run_replay with ``disagg=True``, both tiers on ``dev``: its
    summary, tokens, the engine's hop plans and expected hop pieces, the
    reshard_plan events after warmup and the launches by tier."""
    from tpu_hpc_torch.kernels import paged_attention as pa
    from tpu_hpc_torch.obs import get_bus
    from tpu_hpc_torch.serve import replay_requests
    from tpu_hpc_torch.serve.server import run_replay

    _zero_launches()
    with fresh_obs("chip-smoke-ops-disagg"), recorded_runs() as runs, \
            recorded_disagg(scatter_at_prefill_ids=control) as engines:
        summary = run_replay(cfg, serve_cfg, n_requests, prompt_lens,
                             max_new, seed=0, paged=paged, device=dev,
                             disagg=True, disagg_max_inflight_mb="auto",
                             disagg_devices=(dev, dev))
        (rec,) = engines
        events = [r for r in get_bus().ring()[rec["events_from"]:]
                  if r["event"] == "reshard_plan"]
    eng = rec["engine"]
    reqs = replay_requests(n_requests, cfg.vocab_size, prompt_lens,
                           max_new, seed=0)
    out = {
        "summary": summary, "tokens": runs[-1],
        "hop_pieces": sum(len(eng._hop_pieces(len(r.prompt)))
                          for r in reqs),
        "plan_wire_bytes": {b: p.wire_bytes for b, p in eng._plans.items()},
        "events": events, "tiers": rec["tiers"], "hops": rec["hops"],
        "requests": n_requests, "kv_quant": paged.kv_quant,
        "launches": _launch_counts(),
        "prefill_routes": dict(pa.paged_prefill_attention.route_launches),
    }
    del eng, rec, engines
    _release(torch)
    return out


def ops_disagg_failures(run, single_tokens, on_card: bool) -> list:
    """(a)'s gates: tokens equal the single-tier replay's; after each
    prompt's hop the decode tier's pages (and an int8 pool's scales) at
    its own page ids equal the prefill tier's bit for bit; nothing
    rebuilt after warmup; kv_transfers equal the requests' hop pieces;
    kv_transfer_bytes equal the plans' measured bytes and their modeled
    wire bytes; on the card, each tier launched only its kernel and the
    tiers' counts equal the wrappers' (the prefill on its pool's route:
    wgmma, or wgmma_int8 over an int8 pool)."""
    fails = []
    s = run["summary"]
    d = s["disagg"]
    if run["tokens"] != single_tokens:
        differ = sorted(r for r in single_tokens
                        if run["tokens"].get(r) != single_tokens[r])
        fails.append(f"tokens differ from the single tier on {differ}")
    hops = run["hops"]
    if hops["mismatched"] or hops["checked"] != run["requests"]:
        fails.append(f"{hops['mismatched']} of {hops['checked']} hops left "
                     "the decode tier's pages unequal to the prefill "
                     "tier's")
    if s["recompiles"] != 0:
        fails.append(f"{s['recompiles']} plans/buffers/programs made after "
                     "warmup")
    if d["kv_transfers"] != run["hop_pieces"] \
            or len(run["events"]) != run["hop_pieces"]:
        fails.append(f"kv_transfers {d['kv_transfers']}, hop pieces "
                     f"{run['hop_pieces']}, plan executions "
                     f"{len(run['events'])}")
    measured = sum(e["measured_bytes"] for e in run["events"])
    modeled = sum(e["wire_bytes"] for e in run["events"])
    if not d["kv_transfer_bytes"] == measured == modeled:
        fails.append(f"kv_transfer_bytes {d['kv_transfer_bytes']}, measured "
                     f"{measured}, modeled wire {modeled}")
    if on_card:
        pre, dec = run["tiers"]["prefill"], run["tiers"]["decode"]
        total = run["launches"]
        if pre["paged_decode_attention"] or dec["paged_prefill_attention"]:
            fails.append(f"a tier launched the other's kernel: {run['tiers']}")
        if pre["paged_prefill_attention"] < 1 \
                or dec["paged_decode_attention"] < 1:
            fails.append(f"a tier's kernel never launched: {run['tiers']}")
        if pre["paged_prefill_attention"] != total[
                "paged_prefill_attention"] or dec["paged_decode_attention"] \
                != total["paged_decode_attention"] \
                or total != s["kernel_launches"]:
            fails.append(f"tier launches {run['tiers']} vs the wrappers' "
                         f"{total} and the summary's "
                         f"{s['kernel_launches']}")
        route = "wgmma_int8" if run["kv_quant"] == "int8" else "wgmma"
        if run["prefill_routes"].get(route) != \
                total["paged_prefill_attention"]:
            fails.append(f"prefill routes {run['prefill_routes']}, not all "
                         f"{route}")
    return fails


def ops_reshard_part(torch, dev, model_cfg=None) -> tuple:
    """(b): the bench Llama's TrainState (FSDP2 params on a one-rank
    mesh + AdamW moments) moved to plain tensors on a tier of this card
    and back, under max_inflight_bytes = total / 4. Returns (readings,
    failures). A process group must be up."""
    from tpu_hpc_torch import reshard
    from tpu_hpc_torch.elastic.coordinator import (
        build_rank_mesh,
        state_layout,
        state_targets,
    )
    from tpu_hpc_torch.parallel.shard import local
    from tpu_hpc_torch.reshard.execute import _stages
    from tpu_hpc_torch.reshard.plan import (
        TensorSpec,
        tree_flatten_with_path,
        tree_unflatten,
    )
    from tpu_hpc_torch.train.__main__ import bench_model_cfg, build_trainer

    import math

    cuda = dev.type == "cuda"
    mesh = build_rank_mesh({"data": 1}, [0], dev.type)
    trainer, _ = build_trainer(model_cfg or bench_model_cfg(), steps=1,
                               epochs=1, batch=TRAIN_BATCH,
                               grad_accum_steps=TRAIN_ACCUM, device=dev,
                               mesh=mesh, plan="fsdp")
    abstract, local_state = state_layout(trainer)
    leaves, treedef = tree_flatten_with_path(abstract)
    total = sum(math.prod(leaf.shape) * leaf.dtype.itemsize
                for _, leaf in leaves if isinstance(leaf, TensorSpec))
    plain = reshard.Sharding(reshard.Mesh.of_device(dev, "plain"))
    to_plain = reshard.plan_reshard(
        abstract, tree_unflatten(treedef, [plain] * len(leaves)),
        max_inflight_bytes=total // 4, label="state_to_plain")

    def sync():
        if cuda:
            torch.cuda.synchronize(dev)

    def allocs():
        return torch.cuda.memory_stats(dev)["allocation.all.allocated"] \
            if cuda else 0

    def flat(tree):
        return [v for _, v in tree_flatten_with_path(tree)[0]]

    src = [local(t).detach() if isinstance(t, torch.Tensor) else t
           for t in flat(local_state)]
    sync()
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    before = torch.cuda.memory_allocated(dev) if cuda else 0
    t0 = time.perf_counter()
    out = to_plain.execute(local_state)
    sync()
    first_ms = (time.perf_counter() - t0) * 1e3
    rise = (torch.cuda.max_memory_allocated(dev) - before) if cuda else 0
    n_buffers, n_allocs = to_plain.compiled_program_count, allocs()
    t0 = time.perf_counter()
    again = to_plain.execute(local_state)
    sync()
    replay_ms = (time.perf_counter() - t0) * 1e3
    replay_allocs = allocs() - n_allocs
    # And back: the plain tensors onto the trainer's FSDP2 layout.
    back_abstract = tree_unflatten(treedef, [
        TensorSpec(leaf.shape, leaf.dtype, plain)
        if isinstance(leaf, TensorSpec) else leaf for _, leaf in leaves])
    to_fsdp = reshard.plan_reshard(
        back_abstract, state_targets(abstract),
        max_inflight_bytes=total // 4, label="plain_to_state")
    t0 = time.perf_counter()
    home = to_fsdp.execute(again)
    sync()
    back_ms = (time.perf_counter() - t0) * 1e3

    def same(a, b):
        if isinstance(a, torch.Tensor) or isinstance(b, torch.Tensor):
            return torch.equal(torch.as_tensor(a).to(dev),
                               torch.as_tensor(b).to(dev))
        return a == b

    fails = []
    if not all(same(a, b) for a, b in zip(src, flat(out))):
        fails.append("(b) the plain copy is not bit-equal to the state")
    if not all(same(a, b) for a, b in zip(src, flat(home))):
        fails.append("(b) the round trip is not bit-equal to the state")
    modeled = to_plain.peak_device_bytes(dev)
    if cuda and rise > modeled:
        fails.append(f"(b) memory rose {rise} B over the modeled peak "
                     f"{modeled} B")
    if to_plain.compiled_program_count != n_buffers or replay_allocs:
        fails.append(f"(b) the held plan's replay made "
                     f"{to_plain.compiled_program_count - n_buffers} "
                     f"buffers and {replay_allocs} allocations")
    if not to_plain.bound_met:
        fails.append("(b) a step is over the bound")
    readings = {
        "state_bytes": total, "leaves": len(leaves),
        "max_inflight_bytes": total // 4,
        "plan": to_plain.summary(), "stages": len(_stages(to_plain)),
        "plan_ms": None, "execute_ms": first_ms, "replay_ms": replay_ms,
        "back_ms": back_ms,
        "gb_per_s": total / (replay_ms / 1e3) / 1e9 if replay_ms else None,
        "memory_rise_bytes": rise, "modeled_peak_bytes": modeled,
        "replay_allocations": replay_allocs,
    }
    t0 = time.perf_counter()
    reshard.plan_reshard(abstract, tree_unflatten(treedef, [plain]
                                                  * len(leaves)),
                         max_inflight_bytes=total // 4)
    readings["plan_ms"] = (time.perf_counter() - t0) * 1e3
    del trainer, out, again, home, local_state, src
    if cuda:
        _release(torch)
    return readings, fails


def ops_elastic_part(torch, dev, model_cfg=None,
                     updates=OPS_UPDATES) -> tuple:
    """(c): the bench Llama (FSDP2 on a one-rank mesh, the flash
    kernels) through the TopologyCoordinator under OPS_STORM, beside a
    fixed-topology run of the same updates; the flash launches of the
    coordinator's run (set to 0 just before). Returns (readings,
    failures, launches). A process group must be up."""
    import shutil

    from tpu_hpc_torch.elastic import TopologyCoordinator, choose_layout
    from tpu_hpc_torch.elastic.coordinator import build_rank_mesh
    from tpu_hpc_torch.kernels import attention as fa
    from tpu_hpc_torch.models import datasets
    from tpu_hpc_torch.obs.schema import load_records
    from tpu_hpc_torch.train.__main__ import bench_model_cfg, build_trainer

    model_cfg = model_cfg or bench_model_cfg()
    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), OPS_DIR)
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)

    def factory_for(path):
        def factory(mesh):
            return build_trainer(model_cfg, steps=1, epochs=updates,
                                 batch=TRAIN_BATCH,
                                 grad_accum_steps=TRAIN_ACCUM, device=dev,
                                 mesh=mesh, plan="fsdp",
                                 metrics_path=path)[0]
        return factory

    def losses(path):
        return [(r["step"], r["loss"]) for r in load_records(path)
                if r["event"] == "epoch"]

    from tpu_hpc_torch.train.__main__ import SEED

    ds = datasets.TokenStream(vocab_size=model_cfg.vocab_size,
                              seq_len=model_cfg.max_seq_len, seed=SEED)
    fixed_path, storm_path = (os.path.join(root, f"{n}.jsonl")
                              for n in ("fixed", "storm"))
    decision = choose_layout([0], global_batch=TRAIN_BATCH,
                             current_data_extent=1, device_type=dev.type)
    t0 = time.perf_counter()
    factory_for(fixed_path)(build_rank_mesh(decision.axes, [0],
                                            dev.type)).fit(ds)
    fixed_s = time.perf_counter() - t0
    if dev.type == "cuda":
        _release(torch)
    zero_flash_launches()
    t0 = time.perf_counter()
    with armed(OPS_STORM):
        summary = TopologyCoordinator(
            factory_for(storm_path), global_batch=TRAIN_BATCH,
            data_extent=1, device_type=dev.type).run(ds)
    storm_s = time.perf_counter() - t0
    launches = fa.kernel_launches()
    fixed, storm = losses(fixed_path), losses(storm_path)
    expected = model_cfg.n_layers * TRAIN_ACCUM * updates
    fails = []
    if summary["morph_count"] != 2 or len(summary["segments"]) != 3 \
            or summary["restarts"] != 0 or summary["pid"] != os.getpid():
        fails.append(f"(c) {summary['morph_count']} morphs, "
                     f"{len(summary['segments'])} segments, restarts "
                     f"{summary['restarts']}")
    if storm != fixed or len(storm) != updates:
        fails.append(f"(c) loss stream {storm} vs the fixed run's {fixed}")
    if dev.type == "cuda" and any(n != expected for n in launches.values()):
        fails.append(f"(c) flash launches {launches}, expected {expected}")
    readings = {
        "model": "bench", "updates": updates, "faults": OPS_STORM,
        "segments": [s["n_devices"] for s in summary["segments"]],
        "morphs": [{k: m[k] for k in ("step", "kind", "wire_bytes",
                                      "stall_s")}
                   for m in summary["morphs"]],
        "stall_s": summary["stall_s"], "restarts": summary["restarts"],
        "losses": [v for _, v in storm], "loss_bit_identical":
        storm == fixed, "launches": launches,
        "expected_launches": expected, "fixed_s": fixed_s,
        "storm_s": storm_s,
    }
    shutil.rmtree(root, ignore_errors=True)
    return readings, fails, launches


def ops_serve_reading(run, control=None) -> dict:
    """(a)'s readings of one disaggregated run (and its control)."""
    s, d = run["summary"], run["summary"]["disagg"]
    out = {
        "kv_quant": run["kv_quant"], "requests": s["requests"],
        "tokens": s["tokens"],
        **{k: s[k] for k in ("ttft_ms_p50", "ttft_ms_p95", "itl_ms_p50",
                             "itl_ms_p95", "tokens_per_s", "wall_s",
                             "peak_memory_bytes", "recompiles") if k in s},
        **{k: d[k] for k in ("kv_transfers", "kv_transfer_bytes",
                             "kv_transfer_ms_p50", "kv_transfer_ms_p95",
                             "max_inflight_bytes")},
        "kv_plans": d["kv_plans"], "tier_launches": run["tiers"],
        "prefill_routes": run["prefill_routes"], "hop_checks": run["hops"],
    }
    if control is not None:
        out["control"] = control
    return out


def ops_phase(torch, dev, cfg, serve_cfg, paged, single_tokens,
              int8_tokens) -> dict:
    """Phase 13 (``ops``): (a) disaggregated serving of the 7B, both
    tiers on this card, over the bf16 pool with its control and over
    the int8 pool; (b) the reshard engine on the bench Llama's state;
    (c) the coordinator's storm. Every gate's failures gathered, the
    phase line printed, then the phase fails if any gate did (or the
    control passed). Returns the phase's launches by kernel wrapper."""
    import torch.distributed as dist

    from tpu_hpc_torch.runtime.sim import free_port

    t0 = time.perf_counter()
    on_card = dev.type == "cuda"
    run = ops_disagg_run(torch, dev, cfg, serve_cfg, paged, SERVE_REQUESTS)
    failures = ops_disagg_failures(run, single_tokens, on_card)
    control = ops_disagg_run(torch, dev, cfg, serve_cfg, paged,
                             SERVE_REQUESTS, control=True)
    control_fails = ops_disagg_failures(control, single_tokens, False)
    if not control_fails:
        failures.append("(a) the control (scatter at the prefill tier's "
                        "page ids) passed the gates")
    int8 = ops_disagg_run(torch, dev, cfg, serve_cfg,
                          dataclasses.replace(paged, kv_quant="int8"),
                          SERVE_REQUESTS)
    failures += [f"(a int8) {f}" for f in ops_disagg_failures(
        int8, int8_tokens, on_card)]
    serve = {
        "model": "7b", "n_layers": cfg.n_layers, "tiers": [str(dev)] * 2,
        "bf16": ops_serve_reading(run, {
            "rejected": bool(control_fails),
            "tokens_changed": control["tokens"] != single_tokens,
            "failures": control_fails}),
        "int8": ops_serve_reading(int8),
    }
    dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                            init_method=f"tcp://localhost:{free_port()}",
                            world_size=1, rank=0)
    try:
        state, state_fails = ops_reshard_part(torch, dev)
        storm, storm_fails, flash = ops_elastic_part(torch, dev)
    finally:
        dist.destroy_process_group()
    failures += state_fails + storm_fails
    emit("ops", seconds=time.perf_counter() - t0, disagg=serve,
         reshard=state, elastic=storm, failures=failures)
    if failures:
        raise SystemExit(f"ops: {failures}")
    return {
        "paged_decode_attention": {
            "decode_tier": run["tiers"]["decode"]["paged_decode_attention"],
            "decode_tier_int8": int8["tiers"]["decode"][
                "paged_decode_attention"]},
        "paged_prefill_attention": {"prefill_tier": run["tiers"]["prefill"][
            "paged_prefill_attention"]},
        INT8_PREFILL: {"prefill_tier": int8["tiers"]["prefill"][
            "paged_prefill_attention"]},
        **{k: {"elastic": n} for k, n in flash.items()},
    }


NATIVE_DIR = "build/chip_smoke_native"
NATIVE_STEPS, NATIVE_EPOCHS = 3, 2  # 6 updates, the last 3 measured
NATIVE_LOSS_ATOL = 0.5              # the first loss against ln(vocab)


def corpus_files(root) -> list:
    """The repo's own Markdown: *.md at the root, then under docs/."""
    from pathlib import Path

    root = Path(root)
    return [str(p) for p in sorted(root.glob("*.md"))
            + sorted((root / "docs").rglob("*.md"))]


def state_bytes(params, grads, opt_state) -> dict:
    """numel x element_size over an update's params, gradients and
    AdamW state (the moments; the count is a host int or a 0-d tensor)."""
    def total(ts):
        return sum(t.numel() * t.element_size() for t in ts
                   if hasattr(t, "numel"))

    opt = [*opt_state["mu"], *opt_state["nu"], opt_state.get("count")]
    return {"params": total(params), "grads": total(grads),
            "opt": total(opt)}


def batch_crc(x, y) -> int:
    """CRC-32 of a CPU batch's bytes, inputs then targets."""
    import zlib

    return zlib.crc32(y.numpy().tobytes(), zlib.crc32(x.numpy().tobytes()))


@contextlib.contextmanager
def served_batches():
    """Records [step, batch_crc] of every batch a NativeTokenDataset
    hands out inside the block (the token-file run's reader)."""
    from tpu_hpc_torch.native import NativeTokenDataset

    served = []
    own = vars(NativeTokenDataset).get("batch_at")
    batch_at = NativeTokenDataset.batch_at

    def recording(self, step, batch_size):
        x, y = batch_at(self, step, batch_size)
        served.append([int(step), batch_crc(x, y)])
        return x, y

    NativeTokenDataset.batch_at = recording
    try:
        yield served
    finally:
        if own is None:
            del NativeTokenDataset.batch_at  # the inherited method again
        else:
            NativeTokenDataset.batch_at = own


@contextlib.contextmanager
def first_update_state():
    """Records state_bytes of the tensors AdamW.apply receives at the
    first update inside the block (the Trainer's own params, grads and
    moments)."""
    from tpu_hpc_torch.train.trainer import AdamW

    seen = []
    apply = AdamW.apply

    def recording(self, params, grads, state, norm=None):
        if not seen:
            seen.append(state_bytes(params, grads, state))
        return apply(self, params, grads, state, norm)

    AdamW.apply = recording
    try:
        yield seen
    finally:
        AdamW.apply = apply


def native_train_part(torch, dev, train, root, model_cfg=None) -> tuple:
    """(a): the corpus and the token-file run (the bench Llama, or
    ``model_cfg``); returns (row, failures, the state the optimizer
    received)."""
    import math

    from tpu_hpc_torch.kernels import attention as fa
    from tpu_hpc_torch.native import NativeTokenDataset, prepare_corpus
    from tpu_hpc_torch.train.__main__ import bench_model_cfg, run_train

    os.makedirs(root, exist_ok=True)
    corpus = os.path.join(root, "corpus.bin")
    t0 = time.perf_counter()
    files = corpus_files(os.path.dirname(os.path.abspath(__file__)))
    info = prepare_corpus(corpus, files)
    prepare_s = time.perf_counter() - t0
    cfg = model_cfg or bench_model_cfg()
    zero_flash_launches()
    with first_update_state() as seen, served_batches() as served:
        summary = run_train(cfg, steps=NATIVE_STEPS, epochs=NATIVE_EPOCHS,
                            batch=TRAIN_BATCH, grad_accum_steps=TRAIN_ACCUM,
                            device=dev, tokens_file=corpus)
    launches = fa.kernel_launches()
    updates = NATIVE_STEPS * NATIVE_EPOCHS
    # CPU tensors run the kernels' plain versions: no launch.
    expected = (cfg.n_layers * TRAIN_ACCUM * updates
                if dev.type == "cuda" else 0)
    fresh = NativeTokenDataset(corpus, TRAIN_BATCH, cfg.max_seq_len)
    mismatched = [step for step, crc in served
                  if crc != batch_crc(*fresh.batch_at(step, TRAIN_BATCH))]
    fresh.close()
    losses = summary["losses"]
    ln_v = math.log(cfg.vocab_size)
    failures = []
    if any(n != expected for n in launches.values()) \
            or launches != summary["kernel_launches"]:
        failures.append(f"(a) flash launches {launches}, expected {expected}")
    if len(losses) != updates or not all(map(math.isfinite, losses)):
        failures.append(f"(a) losses {losses}")
    elif abs(losses[0] - ln_v) > NATIVE_LOSS_ATOL or losses[-1] >= losses[0]:
        failures.append(f"(a) losses {losses}: the first not within "
                        f"{NATIVE_LOSS_ATOL} of ln({cfg.vocab_size}) = "
                        f"{ln_v:.4f}, or the last not below it")
    if summary["corpus"]["n_windows"] < updates * TRAIN_BATCH:
        failures.append(f"(a) {summary['corpus']['n_windows']} windows: the "
                        f"run wraps an epoch")
    if mismatched or [s for s, _ in served] != list(range(updates)):
        failures.append(f"(a) served batches unlike batch_at at steps "
                        f"{mismatched}")
    if not seen:
        failures.append("(a) no update reached the optimizer")
    row = {
        "corpus": {"files": len(files), "bytes_in": sum(
            os.path.getsize(f) for f in files), "prepare_s": prepare_s,
            **{k: info[k] for k in ("n_tokens", "dtype", "bytes")},
            **{k: summary["corpus"][k] for k in (
                "n_windows", "max_token_id", "windows_served")}},
        "launches": launches, "expected_launches": expected,
        "losses": losses, "ln_vocab": ln_v,
        "tokens_per_s": summary["tokens_per_s"],
        "update_s": summary["update_s"], "mfu": summary["mfu"],
        "token_stream": {k: train[k] for k in ("tokens_per_s", "update_s")},
        "peak_memory_bytes": summary.get("peak_memory_bytes"),
        "state_bytes": seen[0] if seen else None,
    }
    return row, failures, (seen[0] if seen else None)


def native_fit_part(torch, dev, live, model_cfg=None) -> tuple:
    """(b): the fit analyzer for (a)'s configuration on this card."""
    from tpu_hpc_torch.checks import fit
    from tpu_hpc_torch.train.__main__ import bench_model_cfg

    cfg = model_cfg or bench_model_cfg()
    r = fit.analyze(cfg, dp=1, tp_size=1, global_batch=TRAIN_BATCH,
                    seq_len=cfg.max_seq_len, grad_accum=TRAIN_ACCUM,
                    do_compile=True, device=dev.type)
    static = {"params": r.param_bytes, "grads": r.grad_bytes,
              "opt": r.opt_bytes}
    failures = []
    if live is None or static != live:
        failures.append(f"(b) fit's static bytes {static} != the live "
                        f"state's {live}")
    row = {"static_bytes": static, "live_state_bytes": live,
           "act_bytes": r.act_bytes, "total_bytes": r.total_bytes,
           "measured_peak_bytes": r.measured_peak_bytes,
           "measured_baseline_bytes": r.measured_baseline_bytes,
           "update_s": r.compile_seconds, "backend": r.compile_backend,
           "collectives": r.collectives, "fits": r.fits,
           "hbm_gib": r.hbm_gib}
    return row, failures


def native_env_part(torch) -> tuple:
    """(c): the environment checks and the doctor."""
    from tpu_hpc_torch.checks import doctor
    from tpu_hpc_torch.checks.env_check import check_environment

    rep = check_environment(verbose=False, device="cuda")
    failures = [f"(c) {c['name']}: {c['detail']}" for c in rep["checks"]
                if not c["passed"]]
    of_spec = rep.get("microbench_of_spec") or {}
    if not of_spec or max(of_spec.values()) > 1.05:
        failures.append(f"(c) microbench against the data sheet: {of_spec}")
    t0 = time.perf_counter()
    plans = doctor.diagnose("7b", chips=8, chip="h100-sxm")
    row = {"versions": rep["versions"], "checks": rep["checks"],
           "microbench": rep.get("microbench"), "of_spec": of_spec,
           "doctor": {"seconds": time.perf_counter() - t0, "plans": [
               {"mesh": p.mesh, "accum": p.grad_accum, "fits": p.fits,
                "hbm_gib": p.hbm_used_gib, "bound": p.roofline.bound,
                "mfu_upper_bound": p.roofline.mfu_upper_bound,
                "tokens_per_s_per_card_bound":
                    p.roofline.tokens_per_s_per_chip_bound}
               for p in plans]}}
    if not plans or not plans[0].fits:
        failures.append("(c) the doctor found no fitting plan for 7b on 8")
    return row, failures


def native_autotune_part(torch) -> dict:
    """(d): the autotuner's three sweeps; a candidate that disagrees with
    its plain version raises inside autotune."""
    from tpu_hpc_torch.kernels import autotune

    name = torch.cuda.get_device_name()
    out = {}
    for mode, kw in (("decode", dict(iters=50)), ("fwd", dict(iters=20)),
                     ("grad", dict(iters=10, sweep_bwd=True))):
        t0 = time.perf_counter()
        records = autotune.autotune(mode=mode, **kw)
        table = autotune.to_markdown(records, seq_len=2048, batch=4,
                                     n_heads=8, kv_heads=8, head_dim=128,
                                     device_kind=name)
        print(table, file=sys.stderr, flush=True)
        out[mode] = {
            "seconds": time.perf_counter() - t0,
            "library_place": [r.library_pick for r in records].index(True),
            "records": [{"candidate": r.blocks(), "ms": r.ms_per_call,
                         "wall_ms": r.wall_ms,
                         "max_abs_err": r.max_abs_err,
                         "refused": r.reason()}
                        for r in records],
        }
    return out


def native_tools_phase(torch, dev, train) -> dict:
    """Phase 14 (``native_tools``): (a) the token-file run, (b) the fit
    against its live state, (c) the environment and the doctor, (d) the
    autotuner. Every gate's failures gathered, the phase line printed,
    then the phase fails if any gate did. Returns each part's launches
    by kernel wrapper."""
    from pathlib import Path

    from tpu_hpc_torch.kernels import attention as fa
    from tpu_hpc_torch.kernels import paged_attention as pa

    t0 = time.perf_counter()
    root = str(Path(__file__).resolve().parent / NATIVE_DIR)
    trained, failures, live = native_train_part(torch, dev, train, root)
    launched = {"tokens_file": fa.kernel_launches()}
    zero_flash_launches()
    fitted, fails = native_fit_part(torch, dev, live)
    failures += fails
    launched["fit_update"] = fa.kernel_launches()
    _release(torch)
    env, fails = native_env_part(torch)
    failures += fails
    zero_flash_launches()
    pa.paged_decode_attention.launches = 0
    tuned = native_autotune_part(torch)
    launched["autotune"] = {**fa.kernel_launches(),
                            "paged_decode_attention":
                                pa.paged_decode_attention.launches}
    emit("native_tools", seconds=time.perf_counter() - t0, train=trained,
         fit=fitted, env=env, autotune=tuned, failures=failures)
    if failures:
        raise SystemExit(f"native_tools: {failures}")
    out = {k: {part: n[k] for part, n in launched.items() if k in n}
           for k in fa.FLASH_KERNELS}
    out["paged_decode_attention"] = {
        "autotune": launched["autotune"]["paged_decode_attention"]}
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "false); nothing was run", file=sys.stderr)
        return 1
    global CHIP
    from tpu_hpc_torch.checks.roofline import chip_for_kind
    from tpu_hpc_torch.kernels import _build
    from tpu_hpc_torch.models import llama2
    from tpu_hpc_torch.serve import (
        ContinuousBatcher,
        PagedEngine,
        replay_requests,
    )

    t_start = time.perf_counter()
    dev = torch.device("cuda", 0)
    smi = nvidia_smi_line()
    kind = torch.cuda.get_device_name(0)
    CHIP = chip_for_kind(kind)
    emit("device", name=kind, count=torch.cuda.device_count(),
         nvidia_smi=smi, torch=torch.__version__, cuda=torch.version.cuda,
         peaks=None if CHIP is None else dataclasses.asdict(CHIP))
    if CHIP is None:
        raise SystemExit(f"{kind}: no row in tpu_hpc_torch/checks/roofline.py"
                         " -- no peak rates to bound the kernels with")

    build_s = _build.build()
    lib = _build.load_library()
    emit("build", seconds=build_s, library=str(_build.LIBRARY),
         ptxas=ptxas_summary(_build.PTXAS_LOG.read_text()))

    main_rows = kernel_phase(torch, dev, lib)
    flash_rows, vit_rows = flash_phase(torch, dev)
    main_rows.update(flash_rows)

    # -- 5. the serving path: Llama-2-7B paged replay through the kernels
    cfg, serve_cfg, paged = serve_shape()
    with recorded_runs() as serve_runs:
        launches = serve_phase(torch, dev, "serve", cfg, serve_cfg, paged)
        # -- 5b. the same replay over an int8 pool: the prefill's int8
        #        route
        int8_launches = serve_phase(
            torch, dev, "serve_int8", cfg, serve_cfg,
            dataclasses.replace(paged, kv_quant="int8"))
    launches[INT8_PREFILL] = int8_launches["paged_prefill_attention"]
    # -- 5c. speculative decoding and seeded sampling on the paged engine
    spec_launches = serve_spec_phase(torch, dev, cfg, serve_cfg, paged,
                                     launches)
    _release(torch)
    # -- 5d. the host tier, the fleet, restore into the serving layout
    from pathlib import Path

    tier_fleet_launches = serve_tier_fleet_phase(
        torch, dev, cfg, str(Path(__file__).resolve().parent / RESTORE_DIR),
        FLEET_LAYERS)
    _release(torch)

    # -- 6. cross-check: f32, cuda vs gather vs the no-cache forward
    small = dataclasses.replace(cfg, n_layers=2, dtype=torch.float32)
    params = llama2.init_llama(
        torch.Generator(device=dev).manual_seed(1), small, dev
    )
    results = {}
    for kernel in ("cuda", "gather"):
        eng = PagedEngine(params, small, serve_cfg, dev,
                          dataclasses.replace(paged, kernel=kernel))
        eng.warmup()
        reqs = replay_requests(SERVE_REQUESTS, small.vocab_size,
                               SERVE_PROMPT_LENS, SERVE_MAX_NEW, seed=0)
        results[kernel] = ContinuousBatcher(eng).run(reqs)
        del eng
        torch.cuda.empty_cache()
    same = results["cuda"] == results["gather"]
    oracle_ok = []
    with torch.no_grad():
        for r in reqs[:2]:
            toks = list(r.prompt)
            for _ in range(SERVE_MAX_NEW):
                logits = llama2.apply_llama(
                    params, torch.tensor([toks], device=dev), small
                )
                toks.append(int(logits[0, -1].argmax()))
            oracle_ok.append(toks[len(r.prompt):] == results["cuda"][r.rid])
    emit("crosscheck", model="7b-width-2-layers", dtype="float32",
         requests=len(results["cuda"]),
         tokens=sum(len(t) for t in results["cuda"].values()),
         cuda_equals_gather=same, cuda_equals_no_cache_forward=oracle_ok)
    if not same or not all(oracle_ok):
        raise SystemExit("crosscheck: greedy tokens differ")
    del params
    torch.cuda.empty_cache()

    # -- 7. the training path: the bench Llama through the flash kernels
    train_launches, train = train_phase(torch, dev)
    launches.update(train_launches)
    torch.cuda.empty_cache()
    # -- 8. the distributed path on a one-rank NCCL world
    train_hybrid_phase(torch, dev, train)
    torch.cuda.empty_cache()
    # -- 8b. sequence parallelism: the ring schedules on this card, then
    #        run_train with each --sp-mode on a one-rank NCCL world
    sp_launches = train_sp_phase(torch, dev, train)
    torch.cuda.empty_cache()
    # -- 8c. pipeline parallelism: bench.py's five llama-pp rows at S = 1
    #        on a one-rank NCCL world, then at S = 4 on this card
    pp_launches = train_pp_phase(torch, dev, train)
    _release(torch)
    # -- 8c'. the MPMD pipeline runtime: bench.py's MPMD row on one stage,
    #        then 4 stages on this card with its gates and chaos runs
    mpmd_launches = train_mpmd_phase(torch, dev)
    _release(torch)
    # -- 8d. the comm layer: bucketed sync on a one-rank NCCL world,
    #        auto's decision, hierarchical refused, the comm bench
    comm_launches = train_comm_phase(torch, dev, train)
    _release(torch)
    # -- 8e. the vision and weather workloads: bench.py's unet row, the
    #        ViT on the flash kernels without a causal mask, ResNet-18
    vision_launches = train_vision_phase(torch, dev)
    # -- 8f. domain parallelism: the U-Net over 4 latitude bands
    train_domain_phase(torch, dev)
    # -- 8g. llama-long: seq 8192, microbatch 1
    long_launches = train_long_phase(torch, dev, train)
    # -- 9. where an update's device time goes (reports, never gates)
    train_profile_phase(torch, dev)
    # -- 10. training cross-check: flash kernels vs reference attention
    train_crosscheck_phase(torch, dev)
    torch.cuda.empty_cache()
    # -- 11. training that survives: guard, checkpoints, preemption,
    #        non-finite rows of the kernels
    train_resilience_phase(torch, dev)
    _release(torch)
    # -- 12. observability: capture on a stall, torch.profiler windows
    #        that see the kernels by name, the trace analyzer
    obs_launches = obs_capture_phase(torch, dev, cfg, serve_cfg, paged)
    _release(torch)
    # -- 13. the operations path: disaggregated serving (both tiers on
    #        this card), the reshard engine, the elastic coordinator
    ops_launches = ops_phase(torch, dev, cfg, serve_cfg, paged,
                             serve_runs[0], serve_runs[1])
    _release(torch)
    # -- 14. the last modules: the token-file run, the fit against its
    #        live state, the environment checks and the doctor, the
    #        autotuner over the Hopper kernels
    native_launches = native_tools_phase(torch, dev, train)

    kernels = []
    for name, row in main_rows.items():
        kernels.append({
            "name": name, "route": "cuda", "source": SOURCES[name],
            "replaces": REPLACES[name], "launches": launches[name],
            "max_abs_err": row["max_abs_err"], "ms": row["ms"],
            "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": row["library_ms"],
        })
    # The speculative path's launches of the paged kernels (serve_spec).
    for entry in kernels:
        if entry["name"] == "paged_decode_attention":
            entry["serve_spec_launches"] = {
                k: spec_launches[k] for k in ("draft", "verify")}
        if entry["name"] == "paged_prefill_attention":
            entry["serve_spec_launches"] = spec_launches["prefill"]
        # Their launches in serve_tier_fleet: the tiered run, after each
        # refill, and by fleet replica.
        if entry["name"] in tier_fleet_launches:
            entry["serve_tier_fleet_launches"] = tier_fleet_launches[
                entry["name"]]
        # The flash kernels' launches in train_sp (b), by --sp-mode, in
        # train_pp (a), by bench row, and in train_comm (a).
        if entry["name"] in FLASH_KERNEL_NAMES:
            entry["train_sp_launches"] = {
                mode: n[entry["name"]] for mode, n in sp_launches.items()}
            entry["train_pp_launches"] = {
                row: n[entry["name"]] for row, n in pp_launches.items()}
            entry["train_comm_launches"] = comm_launches[entry["name"]]
            entry["train_mpmd_launches"] = {
                model: n[entry["name"]] for model, n in mpmd_launches.items()}
            # The ViT's (train_vision (b)) and llama-long's launches, and
            # the ViT's attention shape timed (flash case vit_noncausal).
            entry["train_vision_launches"] = vision_launches[entry["name"]]
            entry["train_long_launches"] = long_launches[entry["name"]]
            vit = vit_rows[entry["name"]]
            entry["vit_noncausal"] = {k: vit[k] for k in (
                "max_abs_err", "ms", "device_ms", "plain_ms", "bound_ms",
                "bound_by", "library_ms", "library_device_ms")}
        # Their launches in obs_capture: the serving run's (paged, the
        # prefill's by route) and the profiled and capture training
        # runs' and the profile window's (flash).
        entry["obs_capture_launches"] = obs_launches[entry["name"]]
        # Their launches in ops: the disaggregated tiers' (paged, by
        # tier) and the coordinator's storm (flash).
        entry["ops_launches"] = ops_launches[entry["name"]]
        # The flash and decode kernels' launches in native_tools: the
        # token-file run, the fit's update, the autotuner's sweeps.
        if entry["name"] in native_launches:
            entry["native_tools_launches"] = native_launches[entry["name"]]
    emit("done", seconds=time.perf_counter() - t_start)
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
