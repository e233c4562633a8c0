#!/usr/bin/env python3
"""Sequence-parallel bench-Llama training across the cards of one host,
against one card.

Runs ``python -m tpu_hpc_torch.train`` at one global batch and a long
sequence (default 8192, bench.py's ``llama-long`` length):

  1. on one card, the one-device path (no mesh, no SP);
  2. under ``torchrun`` on ``--nproc`` cards, once per ``--sp-mode``
     (ring, zigzag, ulysses) at context ``--nproc``, data 1 -- bench.py's
     ``--workload llama-sp`` layout: each card holds 1/nproc of every
     sequence, K/V travel the ring over NCCL point-to-point (Ulysses: two
     all-to-alls a layer), FSDP2 over data x context.

Each run prints the CLI's JSON summary (mesh, tokens/s for the job and
per card, MFU, update time, every update's loss, rank 0's flash
launches and peak memory); this script adds the largest relative gap
between the run's losses and the one-card run's, and ends with
``nvidia-smi``'s name and power limit of each card. From the repository
root:

    python3 docs/port/multicard_sp.py                    # 4 cards
    python3 docs/port/multicard_sp.py --device cpu --nproc 4 \\
        --seq-len 64 --global-batch 2 --accum 1 --steps 2 --epochs 1 \\
        -- --dim 64 --n-layers 2 --n-heads 4 --vocab 128 --multiple-of 16

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

SP_MODES = ("ring", "zigzag", "ulysses")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--nproc", type=int, default=4)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--seq-len", type=int, default=8192)
    ap.add_argument("--global-batch", type=int, default=4)
    ap.add_argument("--accum", type=int, default=4)
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
              "--epochs", str(args.epochs), "--grad-accum-steps",
              str(args.accum), "--seq-len", str(args.seq_len),
              "--batch", str(args.global_batch), *args.model_flags]
    train = [sys.executable, "-m", "tpu_hpc_torch.train"]
    one = run([*train, *common], args.timeout)
    print(json.dumps({"run": "one_card", **one}), flush=True)
    n = args.nproc
    for mode in SP_MODES:
        cmd = [sys.executable, "-m", "torch.distributed.run",
               "--nproc-per-node", str(n), "--master-port",
               str(free_port()), "-m", "tpu_hpc_torch.train", *common,
               "--sp-mode", mode, "--context", str(n)]
        out = run(cmd, args.timeout)
        gap = max(abs(a - b) / abs(b)
                  for a, b in zip(out["losses"], one["losses"]))
        print(json.dumps({"run": f"{mode}_context{n}",
                          "loss_max_rel_gap_to_one_card": gap, **out}),
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
