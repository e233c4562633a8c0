#!/usr/bin/env python3
"""Where the distributed path's extra update time goes, on one card.

Times bench-Llama updates (dim 1024, 8 layers, seq 2048, microbatch 4 x
accum 8, bf16, the flash kernels) through ``build_trainer`` under three
plans, in turns (none, fsdp, hybrid, hybrid, fsdp, none), on a one-rank
NCCL world with a (data 1, model 1) mesh:

  none   -- the one-device path (no mesh);
  fsdp   -- FSDP2 over ``data``, plain tensors through the model;
  hybrid -- FSDP2 plus DTensor TP params (activations DTensors) and the
            flash kernels under ``local_map``: chip_smoke's train_hybrid.

Each timing is one warm-up update, then UPDATES updates between two
``torch.cuda.synchronize()``. Then one hybrid update under cProfile
(host functions by own time) and under torch.profiler (device busy
time). One JSON line per reading; run from the repository root:

    python3 docs/port/hybrid_overhead.py
"""
from __future__ import annotations

import cProfile
import json
import os
import pstats
import sys
import time

sys.path.insert(0, os.getcwd())

UPDATES = 3


def main() -> int:
    import torch
    import torch.distributed as dist

    from tpu_hpc_torch.runtime import MeshSpec, build_mesh
    from tpu_hpc_torch.runtime.sim import free_port
    from tpu_hpc_torch.train.__main__ import bench_model_cfg, build_trainer

    if not torch.cuda.is_available():
        print("hybrid_overhead: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    dist.init_process_group("nccl", init_method=f"tcp://localhost:"
                            f"{free_port()}", world_size=1, rank=0)
    mesh = build_mesh(MeshSpec(axes={"data": 1, "model": 1}), "cuda")
    cfg = bench_model_cfg()

    def trainer_for(plan):
        return build_trainer(cfg, batch=32, grad_accum_steps=8, device=dev,
                             mesh=None if plan == "none" else mesh,
                             plan=plan)

    def timed(plan):
        trainer, ds = trainer_for(plan)
        trainer.train_step(ds.batch_at(0, 32))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(UPDATES):
            trainer.train_step(ds.batch_at(1 + i, 32))
        torch.cuda.synchronize()
        s = (time.perf_counter() - t0) / UPDATES
        del trainer
        torch.cuda.empty_cache()
        return s

    for plan in ("none", "fsdp", "hybrid", "hybrid", "fsdp", "none"):
        print(json.dumps({"plan": plan, "update_s": timed(plan)}), flush=True)

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    trainer, ds = trainer_for("hybrid")
    trainer.train_step(ds.batch_at(0, 32))
    torch.cuda.synchronize()
    prof = cProfile.Profile()
    t0 = time.perf_counter()
    prof.enable()
    trainer.train_step(ds.batch_at(1, 32))
    torch.cuda.synchronize()
    prof.disable()
    wall = time.perf_counter() - t0
    stats = pstats.Stats(prof)
    rows = sorted(((v[2], v[3], v[1], f"{k[0].split('site-packages/')[-1]}"
                    f":{k[1]}:{k[2]}") for k, v in stats.stats.items()),
                  reverse=True)[:20]
    print(json.dumps({"cprofile_wall_s": wall, "top_tottime": [
        {"tottime_s": t, "cumtime_s": c, "calls": n, "fn": f}
        for t, c, n, f in rows]}), flush=True)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as p:
        t0 = time.perf_counter()
        trainer.train_step(ds.batch_at(2, 32))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    busy = sum(e.self_device_time_total for e in p.key_averages()
               if e.device_type == DeviceType.CUDA) / 1e6
    print(json.dumps({"plan": "hybrid", "profiled_wall_s": wall,
                      "device_busy_s": busy,
                      "idle_share": 1 - busy / wall if busy else None}),
          flush=True)
    dist.destroy_process_group()
    out = os.popen("nvidia-smi --query-gpu=name,power.limit "
                   "--format=csv,noheader").read().strip()
    print(out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
