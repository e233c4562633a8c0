#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``tpu_hpc_torch``) on one card.

Run from the root of a checkout, on a machine with one NVIDIA H100:

    python3 chip_smoke.py

Phases, one JSON line each; any failure raises and exits non-zero:

  1. device      -- the card's name and count, and nvidia-smi's name and
                    power limit.
  2. build       -- nvcc builds csrc/paged_attention.cu (seconds, and the
                    -Xptxas -v registers / spills per kernel).
  3. kernels     -- each paged-attention kernel against its plain PyTorch
                    version at the main path's shapes (Llama-2-7B: 32 KV
                    heads, group 1, head_dim 128, 16-token pages, 8 slots,
                    64-page views, ragged positions, one inactive slot)
                    and at a GQA shape (8 KV heads, group 8: the 70B
                    attention dims), with bf16 and int8 pools whose dead
                    and scratch pages are NaN. Times from CUDA events.
  4. serve       -- run_replay on Llama-2-7B at full width and depth
                    (seeded random weights, bf16, paged pool, the CUDA
                    kernels): 16 requests of 100-500 prompt tokens, 32
                    new tokens each. The kernels' launch counts are set
                    to 0 just before and read just after.
  5. crosscheck  -- the same request mix at 7B width with 2 layers in
                    float32, through kernel="cuda" and kernel="gather",
                    and the no-cache forward for two requests: greedy
                    tokens identical.

Then the per-kernel summary line, nvidia-smi's line, and last the
one-line result ``{"ok": true, "device": {...}}``. Without a CUDA device
(or without the rest of the repository beside it) it exits non-zero
before printing any result.
"""
from __future__ import annotations

import dataclasses
import json
import re
import subprocess
import sys
import time

PEAK_BYTES_PER_S = 3.35e12          # H100 SXM HBM3 (data sheet)
PEAK_FLOPS = {"bfloat16": 989e12, "float16": 989e12, "float32": 67e12}
TOL = 2e-2  # bf16 output rounding (2^-8 relative) on O(1) values
SOURCE = "tpu_hpc_torch/csrc/paged_attention.cu"
REPLACES = {
    "paged_decode_attention":
        "tpu_hpc/kernels/paged_attention.py:101",   # _decode_kernel
    "paged_prefill_attention":
        "tpu_hpc/kernels/paged_attention.py:237",   # _prefill_kernel
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


def ptxas_summary(log: str) -> list:
    """Registers, spills and static shared memory per compiled kernel,
    from nvcc's -Xptxas -v report."""
    rows, cur = [], None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            k = re.search(r"(paged_\w+?_kernel)I(\w+?)EEv", m.group(1))
            cur = {"kernel": f"{k.group(1)}<{k.group(2)}>" if k
                   else m.group(1)}
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


def bound(bytes_: int, flops: int, dtype) -> tuple:
    """Least time (ms) for the work on an H100 and which bound sets it."""
    t_bytes = bytes_ / PEAK_BYTES_PER_S
    t_flops = flops / PEAK_FLOPS[str(dtype).replace("torch.", "")]
    return 1e3 * max(t_bytes, t_flops), (
        "bytes" if t_bytes >= t_flops else "operations"
    )


# ---------------------------------------------------------------------
# Phase 3: kernel cases
# ---------------------------------------------------------------------


def _pool(torch, gen, dev, num_blocks, bs, hkv, d, live, quant):
    """Random K/V pools; every page outside ``live`` (scratch page 0
    included) is NaN -- for int8 pools, its scale is NaN."""
    shape = (num_blocks, bs, hkv, d)
    k = torch.randn(shape, generator=gen, device=dev)
    v = torch.randn(shape, generator=gen, device=dev)
    dead = torch.ones(num_blocks, dtype=torch.bool, device=dev)
    dead[torch.as_tensor(sorted(live), device=dev, dtype=torch.long)] = False
    if quant:
        from tpu_hpc_torch.kernels.paged_attention import quantize_pages_int8

        k, ksc = quantize_pages_int8(k)
        v, vsc = quantize_pages_int8(v)
        ksc[dead] = float("nan")
        vsc[dead] = float("nan")
        return k, v, dict(k_scale=ksc, v_scale=vsc)
    k[dead] = float("nan")
    v[dead] = float("nan")
    return k.bfloat16(), v.bfloat16(), {}


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
    k, v, scales = _pool(torch, gen, dev, num_blocks, bs, hkv, d, live, quant)
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


def prefill_case(torch, dev, hkv, g, quant, start, seed=0):
    """A 256-token chunk at ``start`` over one 96-wide table row."""
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
    k, v, scales = _pool(torch, gen, dev, num_blocks, bs, hkv, d, live, quant)
    q = torch.randn((hkv, bucket, g, d), generator=gen, device=dev)
    args = (q.bfloat16(), k, v, table.to(dev), start)
    kw = dict(block_size=bs, max_blocks=mb, **scales)
    page_bytes = bs * hkv * d * k.element_size() + (4 if quant else 0)
    n_bytes = 2 * q.numel() * 2 + 2 * ctx_pages * page_bytes + 4 * ctx_pages
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


def kernel_phase(torch, dev, lib) -> dict:
    from tpu_hpc_torch.kernels import paged_attention as pa

    main_rows = {}
    cases = []
    for name, shape in (("7b", (32, 1)), ("gqa", (8, 8))):
        for quant in (False, True):
            cases.append(("paged_decode_attention", name, shape, quant, None))
            for start in (0, 256):
                cases.append(
                    ("paged_prefill_attention", name, shape, quant, start)
                )
    for kname, shape_name, (hkv, g), quant, start in cases:
        if kname == "paged_decode_attention":
            args, kw, (nb, fl) = decode_case(torch, dev, hkv, g, quant)
            fn, ref = pa.paged_decode_attention, pa.paged_decode_attention_ref
            library = library_decode
        else:
            args, kw, (nb, fl) = prefill_case(torch, dev, hkv, g, quant, start)
            fn, ref = pa.paged_prefill_attention, pa.paged_prefill_attention_ref
            library = library_prefill
        out = fn(*args, **kw)
        torch.cuda.synchronize()
        want = ref(*args, **kw)
        if not torch.isfinite(out).all():
            raise SystemExit(f"{kname} {shape_name}: non-finite output")
        err = float((out.float() - want.float()).abs().max())
        if not torch.allclose(out.float(), want.float(), atol=TOL, rtol=TOL):
            raise SystemExit(
                f"{kname} {shape_name} quant={quant}: max abs err {err} "
                f"over tolerance {TOL}"
            )
        if kname == "paged_decode_attention" and out[args[5] == 0].any():
            raise SystemExit(f"{kname}: inactive slot not exact zeros")
        row = {
            "kernel": kname, "shape": shape_name,
            "pool": "int8" if quant else "bfloat16",
            "max_abs_err": err, "tolerance": TOL,
        }
        if start is not None:
            row["start"] = start
            row["tile_rows"] = lib.tpuhpc_prefill_tile_rows(
                hkv, args[0].shape[1], g, args[0].shape[3], kw["block_size"]
            )
        timed = start in (None, 256)
        if timed:
            bound_ms, bound_by = bound(nb, fl, args[0].dtype)
            row.update(
                ms=time_ms(lambda: fn(*args, **kw), iters=50),
                plain_ms=time_ms(lambda: ref(*args, **kw), iters=5, warmup=1),
                library_ms=time_ms(library(torch, args, kw), iters=50),
                bound_ms=bound_ms, bound_by=bound_by,
                bytes=nb, flops=fl,
            )
            if shape_name == "7b" and not quant:
                main_rows[kname] = row
        emit("kernels", **row)
        del args, kw, out, want
        torch.cuda.empty_cache()
    return main_rows


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "false); nothing was run", file=sys.stderr)
        return 1
    from tpu_hpc_torch.kernels import _build
    from tpu_hpc_torch.kernels import paged_attention as pa
    from tpu_hpc_torch.models import llama2
    from tpu_hpc_torch.serve import (
        ContinuousBatcher,
        PagedConfig,
        PagedEngine,
        ServeConfig,
        replay_requests,
    )
    from tpu_hpc_torch.serve.server import run_replay

    t_start = time.perf_counter()
    dev = torch.device("cuda", 0)
    smi = nvidia_smi_line()
    kind = torch.cuda.get_device_name(0)
    emit("device", name=kind, count=torch.cuda.device_count(),
         nvidia_smi=smi, torch=torch.__version__, cuda=torch.version.cuda)

    build_s = _build.build()
    lib = _build.load_library()
    emit("build", seconds=build_s, library=str(_build.LIBRARY),
         ptxas=ptxas_summary(_build.PTXAS_LOG.read_text()))

    main_rows = kernel_phase(torch, dev, lib)

    # -- 4. the main path: Llama-2-7B paged replay through the kernels
    prompt_lens = (100, 180, 260, 340, 420, 500)
    n_req, max_new = 16, 32
    serve_cfg = ServeConfig(slots=8, max_seq_len=1024,
                            prefill_buckets=(256, 512))
    paged = PagedConfig(block_size=16, num_blocks=513, prefill_chunk=256,
                        kernel="cuda")
    cfg = llama2.PRESETS["7b"]
    pa.paged_decode_attention.launches = 0
    pa.paged_prefill_attention.launches = 0
    summary = run_replay(cfg, serve_cfg, n_req, prompt_lens, max_new,
                         seed=0, paged=paged, device=dev)
    launches = {
        "paged_decode_attention": pa.paged_decode_attention.launches,
        "paged_prefill_attention": pa.paged_prefill_attention.launches,
    }
    emit("serve", model="7b", n_layers=cfg.n_layers, dim=cfg.dim,
         dtype="bfloat16", launches=launches,
         **{k: summary[k] for k in (
             "requests", "tokens", "wall_s", "tokens_per_s",
             "ttft_ms_p50", "ttft_ms_p95", "ttft_ms_p99", "itl_ms_p50",
             "itl_ms_p95", "itl_ms_p99", "recompiles", "compiled_programs",
             "prefill_chunks", "peak_memory_bytes", "cache_bytes",
             "serve_mfu", "batcher",
         ) if k in summary})
    if summary["requests"] != n_req or summary["tokens"] != n_req * max_new:
        raise SystemExit(f"serve: not every request finished: {summary}")
    if summary["recompiles"] != 0:
        raise SystemExit(f"serve: {summary['recompiles']} rebuilds")
    if min(launches.values()) < 1 or launches != summary["kernel_launches"]:
        raise SystemExit(f"serve: kernels not on the main path: {launches}")
    torch.cuda.empty_cache()

    # -- 5. cross-check: f32, cuda vs gather vs the no-cache forward
    small = dataclasses.replace(cfg, n_layers=2, dtype=torch.float32)
    params = llama2.init_llama(
        torch.Generator(device=dev).manual_seed(1), small, dev
    )
    results = {}
    for kernel in ("cuda", "gather"):
        eng = PagedEngine(params, small, serve_cfg, dev,
                          dataclasses.replace(paged, kernel=kernel))
        eng.warmup()
        reqs = replay_requests(n_req, small.vocab_size, prompt_lens,
                               max_new, seed=0)
        results[kernel] = ContinuousBatcher(eng).run(reqs)
        del eng
        torch.cuda.empty_cache()
    same = results["cuda"] == results["gather"]
    oracle_ok = []
    with torch.no_grad():
        for r in reqs[:2]:
            toks = list(r.prompt)
            for _ in range(max_new):
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

    kernels = []
    for name, row in main_rows.items():
        kernels.append({
            "name": name, "route": "cuda", "source": SOURCE,
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
