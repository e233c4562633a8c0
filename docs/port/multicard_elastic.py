#!/usr/bin/env python3
"""Live elastic training across the cards of one host: shrink 4 -> 2
and grow back 2 -> 4 with no process restarting.

  1. ``torchrun --nproc-per-node N -m tpu_hpc_torch.train --workload
     elastic``: bench.py's storm row (its MLP) on N cards over NCCL.
  2. The bench Llama (dim 1024, 8 layers, seq 2048, FSDP2 over the data
     axis, the flash kernels) through the TopologyCoordinator on N
     cards, ``slice_down_at_step=2,slice_up_at_step=4`` over 6 updates,
     the data extent pinned to N/2: the layouts {data: N/2, replica: 2}
     -> {data: N/2} -> back; beside a fixed-topology run on the final
     layout. Rank 0 prints the segments, each morph's step, wire bytes
     and stall seconds, whether the loss stream is bit-identical to the
     fixed run's, every rank's pid before and after (unchanged), and
     the flash launches on rank 0.

Then ``nvidia-smi``'s name and power limit of each card. From the
repository root:

    python3 docs/port/multicard_elastic.py              # 4 cards
    python3 docs/port/multicard_elastic.py --device cpu --nproc 4 \\
        --tiny                                           # gloo rehearsal
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

sys.path.insert(0, os.getcwd())
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from multicard_train import run  # noqa: E402

STORM = "slice_down_at_step=2,slice_up_at_step=4"
UPDATES = 6
BATCH, ACCUM = 32, 8
TINY = dict(dim=64, n_layers=2, n_heads=4, vocab_size=128, multiple_of=16)


def worker(device: str, tiny: bool) -> None:
    """One rank of the bench-Llama storm (run under torchrun)."""
    import tempfile

    import torch
    import torch.distributed as dist

    from tpu_hpc_torch.elastic import TopologyCoordinator, choose_layout
    from tpu_hpc_torch.elastic.coordinator import build_rank_mesh
    from tpu_hpc_torch.kernels import attention as fa
    from tpu_hpc_torch.models import datasets
    from tpu_hpc_torch.obs.schema import load_records
    from tpu_hpc_torch.runtime import cleanup_distributed, init_distributed
    from tpu_hpc_torch.train.__main__ import (
        SEED,
        bench_model_cfg,
        build_trainer,
    )

    info = init_distributed(device=device, verbose=False)
    dev = (torch.device("cuda", info.local_rank) if device == "cuda"
           else torch.device("cpu"))
    n = dist.get_world_size()
    extent = max(n // 2, 1)
    cfg = bench_model_cfg(16, **TINY) if tiny else bench_model_cfg()
    batch, accum = (4, 2) if tiny else (BATCH, ACCUM)
    tmp = tempfile.mkdtemp(prefix="multicard_elastic_")

    def factory_for(path):
        def factory(mesh):
            return build_trainer(cfg, steps=1, epochs=UPDATES, batch=batch,
                                 grad_accum_steps=accum, device=dev,
                                 mesh=mesh, plan="fsdp",
                                 metrics_path=path)[0]
        return factory

    ds = datasets.TokenStream(vocab_size=cfg.vocab_size,
                              seq_len=cfg.max_seq_len, seed=SEED)
    fixed_path = os.path.join(tmp, "fixed.jsonl")
    storm_path = os.path.join(tmp, "storm.jsonl")
    decision = choose_layout(list(range(n)), global_batch=batch * extent,
                             current_data_extent=extent,
                             device_type=dev.type)
    factory_for(fixed_path)(build_rank_mesh(decision.axes, range(n),
                                            dev.type)).fit(ds)
    for fn in (fa.flash_attention_fwd, fa.flash_attention_dq,
               fa.flash_attention_dkv):
        fn.launches = 0
    pid = os.getpid()
    os.environ["TPU_HPC_FAULTS"] = STORM
    summary = TopologyCoordinator(
        factory_for(storm_path), global_batch=batch * extent,
        data_extent=extent, device_type=dev.type).run(ds)
    del os.environ["TPU_HPC_FAULTS"]
    pids = [None] * n
    dist.all_gather_object(pids, (pid, os.getpid()))
    if dist.get_rank() == 0:
        def losses(path):
            return [(r["step"], r["loss"]) for r in load_records(path)
                    if r["event"] == "epoch"]

        fixed, storm = losses(fixed_path), losses(storm_path)
        print(json.dumps({
            "run": "bench_llama_storm", "world": n, "faults": STORM,
            "fixed_axes": decision.axes,
            "segments": [(s["n_devices"], s["axes"])
                         for s in summary["segments"]],
            "morphs": [{k: m[k] for k in ("step", "kind", "src_mesh",
                                          "tgt_mesh", "wire_bytes",
                                          "stall_s")}
                       for m in summary["morphs"]],
            "stall_s": summary["stall_s"], "restarts": summary["restarts"],
            "loss_bit_identical": storm == fixed, "losses": storm,
            "pids_unchanged": all(a == b for a, b in pids),
            "rank0_flash_launches": fa.kernel_launches(),
        }), flush=True)
    cleanup_distributed()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--nproc", type=int, default=4)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--tiny", action="store_true",
                    help="a 2-layer, 64-wide model at seq 16 (rehearsal)")
    ap.add_argument("--timeout", type=float, default=600.0)
    ap.add_argument("--worker", action="store_true",
                    help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.worker:
        worker(args.device, args.tiny)
        return 0

    from tpu_hpc_torch.runtime.sim import free_port

    if args.device == "cuda":
        import torch

        from tpu_hpc_torch.kernels import _build

        if torch.cuda.device_count() < args.nproc:
            raise SystemExit(f"{torch.cuda.device_count()} cards, "
                             f"{args.nproc} asked for")
        _build.build()  # once, before the ranks load it
    launch = [sys.executable, "-m", "torch.distributed.run",
              "--nproc-per-node", str(args.nproc)]
    row = run([*launch, "--master-port", str(free_port()), "-m",
               "tpu_hpc_torch.train", "--workload", "elastic", "--device",
               args.device, "--steps", str(UPDATES)], args.timeout)
    print(json.dumps({"run": "bench_row", **row}), flush=True)
    out = run([*launch, "--master-port", str(free_port()),
               os.path.abspath(__file__), "--worker", "--device",
               args.device, *(["--tiny"] if args.tiny else [])],
              args.timeout)
    print(json.dumps(out), flush=True)
    if args.device == "cuda":
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60)
        print(smi.stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
