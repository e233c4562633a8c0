#!/usr/bin/env python3
"""Where a data-parallel update's collectives run on the card: one
bench-Llama update per gradient sync under ``torch.profiler``, on every
rank of a ``torchrun`` world.

For each of ``bucketed_overlap`` (``{"data": N}``), ``hierarchical``
(``{"dcn": 2, "data": N/2}``) and flat FSDP (``{"data": N}``, the
``fsdp`` plan) the script builds the bench row's trainer at one global
batch (``--global-batch`` rows, ``--accum`` microbatches, each rank its
slice of every microbatch), runs two warm-up updates, then profiles one.
From the profiled update's kernels it reports, per rank: the update's
wall ms, the card's busy ms (the union of every kernel's interval) and
idle share, the NCCL kernels' ms, how much of that ran while some other
kernel ran (``nccl_hidden_ms`` and the share), and the NCCL ms after the
last non-NCCL kernel (0 whenever the optimizer's kernels follow the
sync, as they do in every mode here). Rank 0 prints one JSON
line per mode with every rank's numbers, then ``nvidia-smi``'s name and
power limit. From the repository root, on four cards:

    torchrun --nproc-per-node 4 docs/port/comm_profile.py

(and on the CPU, ``--device cpu`` with the model-size flags, e.g.
``--dim 64 --n-layers 2 --n-heads 4 --vocab 128 --multiple-of 16
--seq-len 32 --global-batch 8 --accum 2``; there the profiler sees no
kernels and every number is 0).
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.getcwd())


def union_ms(intervals) -> float:
    """Total length (ms) of the union of ``(start_us, end_us)``."""
    total, end = 0.0, None
    for s, e in sorted(intervals):
        if end is None or s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total / 1e3


def overlap_ms(intervals, cover) -> float:
    """Length (ms) of ``intervals`` that falls inside the union of
    ``cover``."""
    merged = []
    for s, e in sorted(cover):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    total = 0.0
    for s, e in intervals:
        for ms, me in merged:
            lo, hi = max(s, ms), min(e, me)
            if hi > lo:
                total += hi - lo
    return total / 1e3


def profile_update(torch, trainer, ds, batch: int, device) -> dict:
    """Two warm-up updates, then one under the profiler: the numbers of
    the module docstring for this rank."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for i in range(2):
        trainer.train_step(ds.batch_at(i, batch))
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    acts = [ProfilerActivity.CPU] + (
        [ProfilerActivity.CUDA] if device.type == "cuda" else [])
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        trainer.train_step(ds.batch_at(2, batch))
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        wall_ms = 1e3 * (time.perf_counter() - t0)
    kernels = [(e.name, e.time_range.start, e.time_range.end)
               for e in prof.events() if e.device_type == DeviceType.CUDA]
    nccl = [(s, e) for n, s, e in kernels if "nccl" in n.lower()]
    other = [(s, e) for n, s, e in kernels if "nccl" not in n.lower()]
    last = max((e for _, e in other), default=0.0)
    nccl_ms = sum(e - s for s, e in nccl) / 1e3
    hidden = overlap_ms(nccl, other)
    busy = union_ms([(s, e) for _, s, e in kernels])
    return {
        "wall_ms": wall_ms, "busy_ms": busy,
        "idle_share": 1.0 - busy / wall_ms if kernels else None,
        "nccl_kernels": len(nccl), "nccl_ms": nccl_ms,
        "nccl_hidden_ms": hidden,
        "nccl_hidden_share": hidden / nccl_ms if nccl_ms else None,
        "nccl_after_last_compute_ms": sum(
            max(0.0, e - max(s, last)) for s, e in nccl) / 1e3,
    }


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--global-batch", type=int, default=32)
    ap.add_argument("--accum", type=int, default=8)
    ap.add_argument("--modes", nargs="+",
                    default=["bucketed_overlap", "hierarchical", "fsdp"])
    for flag in ("dim", "n-layers", "n-heads", "vocab", "multiple-of",
                 "seq-len"):
        ap.add_argument(f"--{flag}", type=int, default=None)
    args = ap.parse_args()

    import torch
    import torch.distributed as dist

    from tpu_hpc_torch.runtime import (
        MeshSpec,
        build_mesh,
        cleanup_distributed,
        init_distributed,
        resolve_device,
    )
    from tpu_hpc_torch.runtime.mesh import node_groups
    from tpu_hpc_torch.train.__main__ import (
        bench_model_cfg,
        build_trainer,
        comm_mode_mesh,
    )

    device = resolve_device(args.device)
    info = init_distributed(device=device.type, verbose=False)
    if device.type == "cuda":
        from tpu_hpc_torch.kernels import _build

        device = torch.device("cuda", info.local_rank)
        if info.process_id == 0:
            _build.build()
        dist.barrier(device_ids=[info.local_rank])
    n = info.num_processes
    cfg = bench_model_cfg(args.seq_len or 2048, dim=args.dim,
                          n_layers=args.n_layers, n_heads=args.n_heads,
                          vocab_size=args.vocab,
                          multiple_of=args.multiple_of)
    per_rank = args.global_batch // n
    try:
        for mode in args.modes:
            if mode == "fsdp":
                mesh = build_mesh(MeshSpec(axes={"data": n}), device.type)
                kw = dict(plan="fsdp")
            else:
                spec, _, _ = comm_mode_mesh(mode, n, len(node_groups()))
                mesh = build_mesh(spec, device.type)
                kw = dict(comm_mode=mode)
            trainer, ds = build_trainer(cfg, batch=per_rank,
                                        grad_accum_steps=args.accum,
                                        device=device, mesh=mesh, **kw)
            mine = profile_update(torch, trainer, ds, args.global_batch,
                                  device)
            everyone = [None] * n
            dist.all_gather_object(everyone, mine)
            if info.process_id == 0:
                print(json.dumps({"mode": mode, "world_size": n,
                                  "global_batch": args.global_batch,
                                  "accum": args.accum, "ranks": everyone}),
                      flush=True)
            if trainer.grad_sync is not None:
                trainer.grad_sync.remove()
            del trainer
            if device.type == "cuda":
                torch.cuda.empty_cache()
    finally:
        cleanup_distributed()
    if info.process_id == 0 and device.type == "cuda":
        print(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
