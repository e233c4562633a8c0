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
                    300), and a float32 case (timed too, its bound at
                    the card's fp32 rate). Controls at the training
                    shape: outputs with their last rows or keys zeroed
                    must be rejected; two forwards that round at the
                    wrong place must be rejected too. dq, dk and dv must
                    come out bit-identical from a second launch on the
                    same inputs (no atomics).
  5. serve       -- run_replay on Llama-2-7B at full width and depth
                    (seeded random weights, bf16, paged pool, the CUDA
                    kernels): 16 requests of 100-500 prompt tokens, 32
                    new tokens each. The paged kernels' launch counts are
                    set to 0 just before and read just after.
     serve_int8  -- the same replay over an int8 pool (kv_quant="int8"):
                    its prefill launches take the wgmma_int8 route.
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
                    the flash forward, dq and dk/dv and the 16-bit
                    prefill give the non-finite rows of their plain
                    versions. Then the update time with the guard off
                    and on skip, in turns.

Then the per-kernel summary line, nvidia-smi's line, and last the
one-line result ``{"ok": true, "device": {...}}``. Without a CUDA device
(or without the rest of the repository beside it) it exits non-zero
before printing any result.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
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
    """A kernel's mangled template arguments, readable: element types and
    integers (``13__nv_bfloat16Li128E`` -> ``bf16, 128``); anything else
    is kept as it stands."""
    out = []
    while mangled:
        for code, name in MANGLED_TYPES:
            if mangled.startswith(code):
                out.append(name)
                mangled = mangled[len(code):]
                break
        else:
            n = re.match(r"Li(\d+)E", mangled)
            if not n:
                out.append(mangled)
                break
            out.append(n.group(1))
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


def decode_case(torch, dev, hkv, g, quant, seed=0):
    """8 slots over a 513-page pool, 64-page views in 96-wide table rows
    (the engine's width at max_seq_len 1024 with a 512 bucket)."""
    slots, d, bs, mb, width, num_blocks = 8, 128, 16, 64, 96, 513
    gen = torch.Generator(device=dev).manual_seed(seed)
    pos = torch.tensor([1023, 517, 64, 15, 300, 811, 0, 700],
                       dtype=torch.int32)
    active = torch.tensor([1, 1, 1, 1, 1, 1, 0, 1], dtype=torch.int32)
    perm = torch.randperm(num_blocks - 1, generator=torch.Generator()
                          .manual_seed(seed)) + 1
    tables = torch.empty((slots, width), dtype=torch.int32)
    live, nxt = set(), 0
    for s in range(slots):
        n_live = int(pos[s]) // bs + 1 if active[s] else 0
        row = perm[nxt:nxt + n_live].tolist()
        nxt += n_live
        live.update(row)
        tables[s, :n_live] = torch.tensor(row, dtype=torch.int32)
    dead_pages = [p for p in range(num_blocks) if p not in live]
    for s in range(slots):  # dead entries and inactive rows: NaN pages
        n_live = int(pos[s]) // bs + 1 if active[s] else 0
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
)
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


# Rows (forward, dq) and keys (dk/dv) from which the controls below
# make a kernel's output wrong: the last 148 of the training shape's
# 2048, where causal attention's values are the smallest.
CONTROL_FROM = 1900


def out_with_rounded_scores(torch, q, k, v):
    """The causal forward with the scores rounded to the input dtype
    before the softmax (the kernels round only P, after exp). Equal q
    and KV heads, no offsets."""
    d = q.shape[-1]
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * d ** -0.5
    s = s.to(q.dtype).float()
    n = s.shape[-1]
    causal = torch.ones(n, n, dtype=torch.bool, device=q.device).tril()
    p = torch.softmax(s.masked_fill(~causal, float("-inf")), dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype).float(), v.float())


def out_with_narrow_accumulator(torch, q, k, v, tile=64):
    """The causal forward walked over 64-key tiles as the kernel walks
    them, but with the running output kept in the input dtype between
    tiles (the kernels keep it in fp32). Equal heads, no offsets."""
    b, n, h, d = q.shape
    qf = q.float() * d ** -0.5
    rows = torch.arange(n, device=q.device)[:, None]
    m = torch.full((b, h, n, 1), float("-inf"), device=q.device)
    l = torch.zeros((b, h, n, 1), device=q.device)
    acc = torch.zeros((b, h, n, d), dtype=q.dtype, device=q.device)
    for j0 in range(0, n, tile):
        kt, vt = k[:, j0:j0 + tile].float(), v[:, j0:j0 + tile]
        s = torch.einsum("bqhd,bkhd->bhqk", qf, kt)
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


def flash_controls(torch, q, k, v, got, want) -> None:
    """Deliberately wrong outputs at the training shape, held to the
    same rule as the kernels', every one of which must be rejected: each
    kernel's output with its last rows (forward, dq) or keys (dk/dv) set
    to zero -- a kernel that misses the end of the causal walk -- and two
    forwards that round to bf16 at the wrong place (the scores before
    the softmax; the running output between KV tiles)."""
    from tpu_hpc_torch.checks.tolerance import compare

    controls = {}
    for name in ("out", "dq", "dk", "dv"):
        bad = got[name].clone()
        bad[:, CONTROL_FROM:] = 0
        controls[f"{name}_from_{CONTROL_FROM}_zeroed"] = (bad, want[name])
    controls["out_scores_rounded"] = (
        out_with_rounded_scores(torch, q, k, v), want["out"])
    controls["out_narrow_accumulator"] = (
        out_with_narrow_accumulator(torch, q, k, v), want["out"])
    for name, (bad, ref) in controls.items():
        r = compare(bad, ref, q.dtype)
        emit("flash_control", control=name, dtype=str(q.dtype)[6:],
             rejected=not r["ok"],
             **{k: v for k, v in r.items() if k != "ok"})
        if r["ok"]:
            raise SystemExit(f"flash control {name}: the tolerance "
                             f"accepts a wrong output ({r})")


def flash_determinism(torch, fa, bargs, kw, got) -> None:
    """dq, dk and dv from a second launch on the same inputs must equal
    the first bit for bit: the backward kernels sum in a fixed order,
    with no atomics."""
    dq = fa.flash_attention_dq(*bargs, **kw)
    dk, dv = fa.flash_attention_dkv(*bargs, **kw)
    torch.cuda.synchronize()
    same = {name: bool(torch.equal(a, got[name]))
            for name, a in (("dq", dq), ("dk", dk), ("dv", dv))}
    emit("flash_determinism", dtype=str(got["dq"].dtype)[6:], **same)
    if not all(same.values()):
        raise SystemExit(f"flash backward not bit-identical across "
                         f"launches: {same}")


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

    main_rows = {}
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
        if name == "train_main":
            flash_controls(torch, q, k, v, got, want)
            flash_determinism(torch, fa, bargs, kw, got)
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
            emit("flash", **row)
            if not all(r["ok"] for r in readings.values()):
                raise SystemExit(
                    f"flash {name} {kname}: outside the tolerance "
                    f"{TOLERANCES[dtype]}: {readings}"
                )
        del q, k, v, dout, out, dq, dk, dv, want_o, want_dq, want_dk, want_dv
        del lib, outputs, bargs, got, want
        torch.cuda.empty_cache()
    return main_rows


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


def kernel_family(name: str) -> str:
    low = name.lower()
    if "flash_" in low:
        return "flash_attention"
    if any(s in low for s in ("gemm", "xmma", "cutlass", "cublas", "wgmma",
                              "nvjet")):
        return "matmul"
    if "elementwise" in low or "vectorized" in low:
        return "elementwise"
    if "reduce" in low or "softmax" in low or "norm" in low:
        return "reduction"
    return "other"


def train_profile_phase(torch, dev) -> None:
    """One bench-Llama update under torch.profiler, after one warm-up
    update: device time by kernel family, the top kernels, and the
    share of the profiled update's wall time the card sat idle (the
    profiler's own overhead counts as idle, so that share is an upper
    bound). A measurement, not a gate: if the profiler records no device
    time it says so and the run goes on."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from tpu_hpc_torch.train.__main__ import bench_model_cfg, build_trainer

    trainer, ds = build_trainer(bench_model_cfg(), batch=TRAIN_BATCH,
                                grad_accum_steps=TRAIN_ACCUM, device=dev)
    trainer.train_step(ds.batch_at(0, TRAIN_BATCH))
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        trainer.train_step(ds.batch_at(1, TRAIN_BATCH))
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    kernels = [(e.key, e.self_device_time_total / 1e3, e.count)
               for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]
    busy_ms = sum(ms for _, ms, _ in kernels)
    families: dict = {}
    for name, ms, count in kernels:
        fam = families.setdefault(kernel_family(name),
                                  {"ms": 0.0, "launches": 0})
        fam["ms"] += ms
        fam["launches"] += count
    top = sorted(kernels, key=lambda k: -k[1])[:12]
    emit("train_profile", model="bench", updates=1,
         microbatches=TRAIN_ACCUM, wall_ms=wall_ms,
         device_time_available=busy_ms > 0, device_busy_ms=busy_ms,
         idle_share=(1.0 - busy_ms / wall_ms) if busy_ms > 0 else None,
         families=families,
         top=[{"kernel": n[:100], "ms": ms, "launches": c}
              for n, ms, c in top])
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


def prefill_nonfinite(torch, dev, cases=NONFINITE_PREFILL):
    """The 16-bit prefill (the 7B chunk of 256 at start 256 over a bf16
    pool, bf16 q) with one element of q or of a live key planted,
    against its plain version."""
    from tpu_hpc_torch.kernels import paged_attention as pa

    out = []
    for name, which, idx, value in cases:
        args, kw, _ = prefill_case(torch, dev, 32, 1, "bfloat16", 256,
                                   torch.bfloat16)
        q, k, v, table, start = args
        if which == "q":
            q[idx] = float(value)
        else:
            k[(int(table[0]),) + idx] = float(value)
        got = pa.paged_prefill_attention(q, k, v, table, start, **kw)
        want = pa.paged_prefill_attention_ref(q, k, v, table, start, **kw)
        r = nonfinite_reading(torch, got, want, torch.bfloat16)
        out.append({"case": name, "planted": which, "at": list(idx),
                    "value": value, **r})
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
    emit(phase, model="7b", n_layers=cfg.n_layers, dim=cfg.dim,
         dtype=str(cfg.dtype)[6:], kv_quant=paged.kv_quant,
         prefill_route=route, launches=launches,
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
        PagedConfig,
        PagedEngine,
        ServeConfig,
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
    main_rows.update(flash_phase(torch, dev))

    # -- 5. the serving path: Llama-2-7B paged replay through the kernels
    serve_cfg = ServeConfig(slots=8, max_seq_len=1024,
                            prefill_buckets=(256, 512))
    paged = PagedConfig(block_size=16, num_blocks=513, prefill_chunk=256,
                        kernel="cuda")
    cfg = llama2.PRESETS["7b"]
    launches = serve_phase(torch, dev, "serve", cfg, serve_cfg, paged)
    # -- 5b. the same replay over an int8 pool: the prefill's int8 route
    int8_launches = serve_phase(torch, dev, "serve_int8", cfg, serve_cfg,
                                dataclasses.replace(paged, kv_quant="int8"))
    launches[INT8_PREFILL] = int8_launches["paged_prefill_attention"]

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
    # -- 9. where an update's device time goes (reports, never gates)
    train_profile_phase(torch, dev)
    # -- 10. training cross-check: flash kernels vs reference attention
    train_crosscheck_phase(torch, dev)
    torch.cuda.empty_cache()
    # -- 11. training that survives: guard, checkpoints, preemption,
    #        non-finite rows of the kernels
    train_resilience_phase(torch, dev)

    kernels = []
    for name, row in main_rows.items():
        kernels.append({
            "name": name, "route": "cuda", "source": SOURCES[name],
            "replaces": REPLACES[name], "launches": launches[name],
            "max_abs_err": row["max_abs_err"], "ms": row["ms"],
            "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": row["library_ms"],
        })
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
