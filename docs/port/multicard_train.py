#!/usr/bin/env python3
"""Bench-Llama training across the cards of one host, against one card.

Runs ``python -m tpu_hpc_torch.train`` at one global batch:

  1. on one card, the one-device path (no mesh);
  2. under ``torchrun`` on ``--nproc`` cards, once per mesh: (data 1,
     model N), hybrid FSDP x TP + SP with TP N (what ``tp.auto_mesh_axes``
     picks for the bench's 8 heads at N = 4); (data 2, model N/2),
     hybrid; (data N, model 1), FSDP. ``--batch`` is set to the global
     batch over the data axis, so every run trains on the same rows.

Each run prints the CLI's JSON summary (mesh, plan, tokens/s for the job
and per device, MFU against the world's peak, update time, every
update's loss, the flash kernels' launches on rank 0, peak memory on
rank 0); this script adds the largest relative gap between the run's
losses and the one-card run's, and ends with ``nvidia-smi``'s name and
power limit of each card. From the repository root:

    python3 docs/port/multicard_train.py                 # 4 cards
    python3 docs/port/multicard_train.py --device cpu --nproc 4 \\
        --global-batch 8 --accum 2 --steps 2 --epochs 1 -- --dim 64 \\
        --n-layers 2 --n-heads 4 --vocab 128 --multiple-of 16 --seq-len 32

(the second is a CPU rehearsal over gloo; flags after ``--`` go to every
run).
"""
from __future__ import annotations

import argparse
import json
import os
import signal
import subprocess
import sys

sys.path.insert(0, os.getcwd())


def run(cmd, timeout: float) -> dict:
    """Run one training command in its own process group (killed whole,
    ranks included, past ``timeout``); its last JSON line, or an
    error."""
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True,
                            start_new_session=True)
    try:
        out, err = proc.communicate(timeout=timeout)
    finally:
        if proc.poll() is None:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.communicate()
    lines = [ln for ln in out.splitlines() if ln.startswith("{")]
    if proc.returncode != 0 or not lines:
        raise SystemExit(f"{' '.join(cmd)} failed (exit {proc.returncode})"
                         f":\n{err[-4000:]}")
    return json.loads(lines[-1])


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--nproc", type=int, default=4)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--global-batch", type=int, default=32)
    ap.add_argument("--accum", type=int, default=8)
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
              str(args.accum), *args.model_flags]
    train = [sys.executable, "-m", "tpu_hpc_torch.train"]
    one = run([*train, *common, "--batch", str(args.global_batch)],
              args.timeout)
    print(json.dumps({"run": "one_card", **one}), flush=True)
    n = args.nproc
    for data, model in ((1, n), (2, n // 2), (n, 1)):
        cmd = [sys.executable, "-m", "torch.distributed.run",
               "--nproc-per-node", str(n), "--master-port",
               str(free_port()), "-m", "tpu_hpc_torch.train", *common,
               "--data", str(data), "--model", str(model),
               "--batch", str(args.global_batch // data)]
        out = run(cmd, args.timeout)
        gap = max(abs(a - b) / abs(b)
                  for a, b in zip(out["losses"], one["losses"]))
        print(json.dumps({"run": f"data{data}_model{model}",
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
