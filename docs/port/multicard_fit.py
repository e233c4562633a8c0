#!/usr/bin/env python3
"""checks.fit's update pass across four cards: the bench Llama analyzed
at data 2 x model 2 (hybrid FSDP x TP + SP), data 2 x context 2 (FSDP x
the ring) and data 2 x pipe 2 (DP x 1F1B), each with do_compile=True,
which runs one real update of the port's Trainer at that layout in one
process per card over NCCL.

    python3 docs/port/multicard_fit.py          # from the repo root, 4 cards

Prints one JSON line per layout (the per-card static bytes, the
analytic total, the measured peak of rank 0's card, the collectives the
update issued by kind, the update's seconds with the processes' start)
and nvidia-smi's name and power limit; exits non-zero without four
cards or on any failure.
"""
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

LAYOUTS = (("tp", 2, 2), ("cp", 2, 2), ("pp", 2, 2))


def main() -> int:
    import torch

    if torch.cuda.device_count() < 4:
        print("multicard_fit: needs four cards", file=sys.stderr)
        return 1
    from tpu_hpc_torch.checks import fit
    from tpu_hpc_torch.train.__main__ import bench_model_cfg

    cfg = bench_model_cfg()
    for layout, dp, ax in LAYOUTS:
        r = fit.analyze(cfg, dp=dp, tp_size=ax, global_batch=16,
                        seq_len=cfg.max_seq_len, grad_accum=2,
                        layout=layout, do_compile=True, device="cuda")
        print(json.dumps({
            "layout": layout, "dp": dp, "axis2": ax,
            "static_bytes": r.static_bytes, "total_bytes": r.total_bytes,
            "act_bytes": r.act_bytes,
            "measured_peak_bytes": r.measured_peak_bytes,
            "measured_baseline_bytes": r.measured_baseline_bytes,
            "collectives": r.collectives, "update_s": r.compile_seconds,
            "backend": r.compile_backend, "fits": r.fits}), flush=True)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout)
    return 0


if __name__ == "__main__":
    sys.exit(main())
