#!/usr/bin/env python3
"""Update time of the bench Llama with the numeric-health guard off and
on (``guard_mode`` skip), for one or more checkouts, in one call.

Each checkout runs in its own process, in turns A, B, B, A (with one
root: A, A). A process builds the kernels (``<root>/build``), then two
trainers of the bench Llama (bench.py:93-103, bf16, microbatch 4 x
accum 8, AdamW, flash attention) from one seed, one with the guard off
and one with it on, and times them in alternating rounds: each round
runs ``--updates`` updates of one trainer between two synchronizations,
then the same of the other, the order flipping every round. The host
clock moves between rounds; a pair of adjacent rounds moves little, so
the per-round ratio skip/off is the reading to trust. From the
repository root:

    python3 docs/port/guard_cost.py .              # this checkout
    python3 docs/port/guard_cost.py OLD_ROOT .     # two, in turns

One JSON line per process (every round's seconds per update), then a
summary line (per root: median off, median skip, median of the per-round
ratios) and ``nvidia-smi``'s name and power limit.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys

CHILD = r"""
import json, sys, time
sys.path.insert(0, sys.argv[1])
rounds, updates = int(sys.argv[2]), int(sys.argv[3])
import torch
from tpu_hpc_torch.kernels import _build
from tpu_hpc_torch.train.__main__ import bench_model_cfg, build_trainer

_build.build()
dev = "cuda"
batch, accum = 32, 8
trainers = {}
for mode in ("off", "skip"):
    tr, ds = build_trainer(bench_model_cfg(), batch=batch,
                           grad_accum_steps=accum, device=dev,
                           guard_mode=mode)
    tr.train_step(ds.batch_at(0, batch))  # warm-up
    trainers[mode] = tr
torch.cuda.synchronize()
times = {"off": [], "skip": []}
step = 1
for r in range(rounds):
    for mode in (("off", "skip") if r % 2 == 0 else ("skip", "off")):
        tr = trainers[mode]
        batches = [ds.batch_at(step + i, batch) for i in range(updates)]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for b in batches:
            tr.train_step(b)
        torch.cuda.synchronize()
        times[mode].append((time.perf_counter() - t0) / updates)
    step += updates
skipped = int(trainers["skip"].state.opt_state["count"])
print(json.dumps({"root": sys.argv[1], "times": times,
                  "skip_count": skipped, "updates": 1 + rounds * updates}))
"""


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("roots", nargs="+")
    ap.add_argument("--rounds", type=int, default=8)
    ap.add_argument("--updates", type=int, default=2)
    args = ap.parse_args()
    roots = [os.path.abspath(r) for r in args.roots]
    order = roots + roots[::-1]
    per_root = {r: [] for r in roots}
    ok = True
    for root in order:
        proc = subprocess.run(
            [sys.executable, "-c", CHILD, root, str(args.rounds),
             str(args.updates)], capture_output=True, text=True, timeout=900,
            cwd=root)
        lines = [ln for ln in proc.stdout.splitlines() if ln.startswith("{")]
        if proc.returncode != 0 or not lines:
            print(json.dumps({"root": root, "rc": proc.returncode,
                              "stderr": proc.stderr[-3000:]}), flush=True)
            ok = False
            continue
        rec = json.loads(lines[-1])
        # The guarded trainer applies every update (no fault is armed).
        rec["ok"] = rec["skip_count"] == rec["updates"]
        ok = ok and rec["ok"]
        print(json.dumps(rec), flush=True)
        per_root[root].append(rec["times"])
    summary = {}
    for root, runs in per_root.items():
        off = [t for run in runs for t in run["off"]]
        skip = [t for run in runs for t in run["skip"]]
        ratios = [s / o for run in runs
                  for s, o in zip(run["skip"], run["off"])]
        if off:
            summary[root] = {"off_median_s": statistics.median(off),
                             "skip_median_s": statistics.median(skip),
                             "ratio_median": statistics.median(ratios),
                             "ratio_min": min(ratios),
                             "ratio_max": max(ratios),
                             "rounds": len(ratios)}
    print(json.dumps({"summary": summary, "ok": ok}), flush=True)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip())
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
