#!/usr/bin/env python3
"""Pipeline-parallel training across the cards of one host, against one
card: bench.py's five ``llama-pp`` rows.

Runs ``python -m tpu_hpc_torch.train --pp-*`` for each row (1f1b,
1f1b on the flagship Llama, 1f1b-stash, gpipe, interleaved-1f1b;
microbatches 8 x 4):

  1. on one card: one stage, the degenerate pipeline bench.py runs on
     one chip;
  2. under ``torchrun`` on ``--nproc`` cards: one stage a card, a
     ``{"pipe": nproc}`` mesh (the interleaved schedule at 2 chunks a
     stage when the depth divides), activations and cotangents over
     NCCL point-to-point.

Each run prints the CLI's JSON summary (tokens/s for the job and per
card, MFU, update time, bubble fraction, every update's loss, rank 0's
flash launches and peak memory). For the flagship row, whose init does
not depend on the stage count, this script adds the largest relative
gap between the pipeline's losses and one card's (the stack model draws
its stages per stage count, as the JAX init does, so its losses differ
by init). Ends with ``nvidia-smi``'s name and power limit of each card.
From the repository root:

    python3 docs/port/multicard_pp.py                    # 4 cards
    python3 docs/port/multicard_pp.py --device cpu --nproc 4 \\
        --seq-len 32 --steps 2 --epochs 1 --microbatch-size 2 \\
        -- --dim 64 --n-layers 8 --n-heads 4 --vocab 128 --multiple-of 16

(the second is a CPU rehearsal over gloo; flags after ``--`` go to every
run).
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

# bench.py run_all's llama-pp rows (bench.py:1578-1588).
ROWS = (("1f1b", "stack", "remat"), ("1f1b", "llama", "remat"),
        ("1f1b", "stack", "stash"), ("gpipe", "stack", "remat"),
        ("interleaved-1f1b", "stack", "remat"))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--nproc", type=int, default=4)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--seq-len", type=int, default=2048)
    ap.add_argument("--microbatches", type=int, default=8)
    ap.add_argument("--microbatch-size", type=int, default=4)
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--epochs", type=int, default=2)
    ap.add_argument("--timeout", type=float, default=300.0,
                    help="seconds for each run")
    ap.add_argument("model_flags", nargs="*",
                    help="after --: flags for every run (model size)")
    args = ap.parse_args()

    from tpu_hpc_torch.runtime.sim import free_port

    if args.device == "cuda":
        import torch

        from tpu_hpc_torch.kernels import _build

        if torch.cuda.device_count() < args.nproc:
            raise SystemExit(f"{torch.cuda.device_count()} cards, "
                             f"{args.nproc} asked for")
        _build.build()  # once, before the ranks load it
    common = ["--device", args.device, "--steps", str(args.steps),
              "--epochs", str(args.epochs), "--seq-len", str(args.seq_len),
              "--pp-microbatches", str(args.microbatches),
              "--pp-microbatch-size", str(args.microbatch_size),
              *args.model_flags]
    train = [sys.executable, "-m", "tpu_hpc_torch.train"]
    for schedule, model, backward in ROWS:
        row = ["--pp-schedule", schedule, "--pp-model", model,
               "--pp-backward", backward]
        one = run([*train, *common, *row], args.timeout)
        print(json.dumps({"run": "one_card", **one}), flush=True)
        cmd = [sys.executable, "-m", "torch.distributed.run",
               "--nproc-per-node", str(args.nproc), "--master-port",
               str(free_port()), "-m", "tpu_hpc_torch.train", *common, *row]
        out = run(cmd, args.timeout)
        extra = {}
        if model == "llama":
            extra["loss_max_rel_gap_to_one_card"] = max(
                abs(a - b) / abs(b)
                for a, b in zip(out["losses"], one["losses"]))
        print(json.dumps({"run": f"pipe{args.nproc}", **extra, **out}),
              flush=True)
    if args.device == "cuda":
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60)
        print(smi.stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
