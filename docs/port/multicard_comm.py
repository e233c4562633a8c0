#!/usr/bin/env python3
"""The comm layer across the cards of one host: the NCCL comm bench, its
cost table, and the bench Llama under each gradient sync, against one
card.

  1. ``torchrun -m tpu_hpc_torch.comm.bench`` on ``--nproc`` cards at
     10^3..10^8 elements: every flat op, the overlap ops, and the
     hierarchical ops on the emulated dcn 2 x ici N/2 mesh of one node;
     ``--emit-table`` writes the measured cost table (the rows and the
     table land under ``--out``);
  2. ``python -m tpu_hpc_torch.train`` on one card (the one-device path,
     no mesh);
  3. under ``torchrun`` on ``--nproc`` cards at the same global batch
     (``--batch`` = global / N, each rank one slice of every
     microbatch): ``--comm-mode bucketed_overlap``, ``hierarchical``
     (dcn 2 x data N/2), ``auto`` (with ``$TPU_HPC_COMM_TABLES`` at
     step 1's table; FSDP over the N cards if it resolves to flat) and
     flat FSDP (``--data N --model 1``).

Each run prints its JSON summary (tokens/s for the job and per card,
update time, every loss, the comm block: buckets, all-reduces per update
and in the run) with the largest relative gap of its losses to the one
card's; the bench rows print one a line; the end is ``nvidia-smi``'s
name and power limit of each card. Each run is a process group of its
own, killed whole past ``--timeout``. From the repository root:

    python3 docs/port/multicard_comm.py                  # 4 cards
    python3 docs/port/multicard_comm.py --device cpu --nproc 4 \\
        --global-batch 8 --accum 2 --steps 2 --epochs 1 \\
        --bench-sizes 1000 100000 -- --dim 64 --n-layers 2 --n-heads 4 \\
        --vocab 128 --multiple-of 16 --seq-len 32

(the second is a CPU rehearsal over gloo; flags after ``--`` go to every
training run).
"""
from __future__ import annotations

import argparse
import json
import os
import signal
import subprocess
import sys

sys.path.insert(0, os.getcwd())


def run(cmd, timeout: float, env=None) -> str:
    """Run one command in its own process group (killed whole, ranks
    included, past ``timeout``); its stdout, or exit with its error."""
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True,
                            start_new_session=True, env=env)
    try:
        out, err = proc.communicate(timeout=timeout)
    finally:
        if proc.poll() is None:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.communicate()
    if proc.returncode != 0:
        raise SystemExit(f"{' '.join(cmd)} failed (exit {proc.returncode})"
                         f":\n{err[-4000:]}")
    return out


def last_json(out: str) -> dict:
    lines = [ln for ln in out.splitlines() if ln.startswith("{")]
    if not lines:
        raise SystemExit(f"no JSON line in:\n{out[-2000:]}")
    return json.loads(lines[-1])


def torchrun(n: int) -> list:
    from tpu_hpc_torch.runtime.sim import free_port

    return [sys.executable, "-m", "torch.distributed.run", "--nproc-per-node",
            str(n), "--master-port", str(free_port())]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--nproc", type=int, default=4)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--global-batch", type=int, default=32)
    ap.add_argument("--accum", type=int, default=8)
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--epochs", type=int, default=2)
    ap.add_argument("--bench-sizes", type=int, nargs="+",
                    default=[10 ** k for k in range(3, 9)])
    ap.add_argument("--bench-iters", type=int, default=20)
    ap.add_argument("--out", default="build/multicard_comm",
                    help="where the bench rows and the cost table go")
    ap.add_argument("--timeout", type=float, default=300.0,
                    help="seconds for each run")
    ap.add_argument("model_flags", nargs="*",
                    help="after --: flags for every training run")
    args = ap.parse_args()
    n = args.nproc
    if args.device == "cuda":
        import torch

        from tpu_hpc_torch.kernels import _build

        if torch.cuda.device_count() < n:
            raise SystemExit(f"{torch.cuda.device_count()} cards, {n} asked "
                             "for")
        _build.build()  # once, before the ranks load it
    os.makedirs(args.out, exist_ok=True)
    tables = os.path.abspath(os.path.join(args.out, "tables"))
    stem = os.path.join(args.out, f"comm_bench_{n}")
    from tpu_hpc_torch.comm import bench

    run([*torchrun(n), "-m", "tpu_hpc_torch.comm.bench", "--device",
         args.device, "--sizes", *map(str, args.bench_sizes), "--iters",
         str(args.bench_iters), "--ops",
         *(bench.OPS + bench.OVERLAP_OPS + bench.HIER_OPS), "--output",
         stem + ".csv", "--emit-table", tables], args.timeout)
    with open(stem + ".jsonl") as f:
        for line in f:
            rec = json.loads(line)
            print(json.dumps({"run": "comm_bench", **rec}), flush=True)
    common = ["--device", args.device, "--steps", str(args.steps),
              "--epochs", str(args.epochs), "--grad-accum-steps",
              str(args.accum), *args.model_flags]
    train = ["-m", "tpu_hpc_torch.train", *common]
    one = last_json(run([sys.executable, *train, "--batch",
                         str(args.global_batch)], args.timeout))
    print(json.dumps({"run": "one_card", **one}), flush=True)
    env = dict(os.environ, TPU_HPC_COMM_TABLES=tables)
    per_rank = str(args.global_batch // n)
    for name, extra in (
            ("bucketed_overlap", ["--comm-mode", "bucketed_overlap"]),
            ("hierarchical", ["--comm-mode", "hierarchical"]),
            # auto resolving to flat trains FSDP over every card, the
            # same global batch.
            ("auto", ["--comm-mode", "auto", "--data", str(n), "--model",
                      "1"]),
            ("fsdp_flat", ["--data", str(n), "--model", "1"])):
        out = last_json(run([*torchrun(n), *train, "--batch", per_rank,
                             *extra], args.timeout, env=env))
        gap = max(abs(a - b) / abs(b)
                  for a, b in zip(out["losses"], one["losses"]))
        print(json.dumps({"run": name, "loss_max_rel_gap_to_one_card": gap,
                          **out}), flush=True)
    if args.device == "cuda":
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60)
        print(smi.stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
