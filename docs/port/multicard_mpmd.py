#!/usr/bin/env python3
"""The MPMD pipeline runtime across the cards of one host: one process,
stage s on cuda:s, activations and cotangents moved card to card
(``Tensor.to``, peer copies over NVLink where the host has them).

For the stack model and the flagship Llama at the bench width, bench.py's
MPMD row (``run_mpmd``) twice: with the stages on cuda:0..N-1, and with
the same N stages all on cuda:0. The two placements run the same
programs on the same card model, so their losses must be equal bit for
bit; the record gives tokens/s, MFU (against N cards' peak for the
spread run), update_s, the per-card peak memory and the wire megabytes
of each. Then the spread stack run again with ``stage_kill_at=1:1``:
one stage-local recovery, its losses equal to the clean spread run's.
Ends with ``nvidia-smi``'s name and power limit of each card. From the
repository root:

    python3 docs/port/multicard_mpmd.py                   # every card
    python3 docs/port/multicard_mpmd.py --device cpu --stages 4 \\
        --steps 2 -- --dim 64 --n-layers 8 --n-heads 4 --vocab 128 \\
        --seq-len 32

(the second rehearses on the CPU, four CPU "stages"; flags after ``--``
size the model as the train CLI's do).
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

sys.path.insert(0, os.getcwd())

SIZE_FLAGS = ("dim", "n-layers", "n-heads", "vocab", "seq-len")


def main(argv=None) -> int:
    import torch

    from tpu_hpc_torch.resilience.faults import fault_plan_from_env
    from tpu_hpc_torch.train.__main__ import (
        PipeArgs,
        bench_model_cfg,
        run_mpmd,
    )

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--stages", type=int, default=None,
                    help="default: every visible card")
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--microbatch-size", type=int, default=4)
    argv = list(sys.argv[1:] if argv is None else argv)
    extra = argv[argv.index("--") + 1:] if "--" in argv else []
    args = ap.parse_args(argv[:argv.index("--")] if "--" in argv else argv)
    sizes = {}
    for flag, value in zip(extra[::2], extra[1::2]):
        name = flag.lstrip("-")
        if name not in SIZE_FLAGS:
            ap.error(f"unknown size flag {flag}")
        sizes[name.replace("-", "_")] = int(value)
    if args.device == "cuda" and not torch.cuda.is_available():
        print("multicard_mpmd: no CUDA device", file=sys.stderr)
        return 1
    n = args.stages or (torch.cuda.device_count() if args.device == "cuda"
                        else 4)
    if args.device == "cuda":
        spread = [torch.device("cuda", i) for i in range(n)]
        if len({d.index for d in spread}) != n or n > \
                torch.cuda.device_count():
            ap.error(f"{n} stages need {n} cards")
        packed = [torch.device("cuda", 0)] * n
    else:
        spread = packed = [torch.device("cpu")] * n
    cfg = bench_model_cfg(sizes.pop("seq_len", 2048),
                          vocab_size=sizes.pop("vocab", None), **sizes)
    bad = []
    runs = {}
    for model in ("stack", "llama"):
        pp = PipeArgs(schedule="gpipe", model=model, microbatches=8,
                      microbatch_size=args.microbatch_size)
        for name, devices in (("spread", spread), ("packed", packed)):
            if args.device == "cuda":
                torch.cuda.empty_cache()
            rec = run_mpmd(cfg, pp, devices, steps=args.steps,
                           fault_plan=None)
            runs[(model, name)] = rec
            print(json.dumps({"run": f"{model}_{name}", **{
                k: rec[k] for k in (
                    "metric", "n_stages", "stage_devices", "tokens_per_s",
                    "value", "mfu", "update_s", "peak_memory_bytes",
                    "wire_mb", "bubble_fraction", "recompiles", "losses",
                    "microbatch_losses", "kernel_launches")
                if k in rec}}), flush=True)
        same = runs[(model, "spread")]["microbatch_losses"] == \
            runs[(model, "packed")]["microbatch_losses"]
        print(json.dumps({"check": f"{model}_spread_equals_packed",
                          "ok": same}), flush=True)
        if not same:
            bad.append(f"{model}: spread losses differ from packed")
    pp = PipeArgs(schedule="gpipe", model="stack", microbatches=8,
                  microbatch_size=args.microbatch_size)
    plan = fault_plan_from_env({"TPU_HPC_FAULTS": "stage_kill_at=1:1"})
    rec = run_mpmd(cfg, pp, spread, steps=args.steps, fault_plan=plan)
    ok = (rec["microbatch_losses"]
          == runs[("stack", "spread")]["microbatch_losses"]
          and rec["stage_restarts"] == 1)
    print(json.dumps({"run": "stack_spread_chaos", "ok": ok, **{
        k: rec[k] for k in ("metric", "recoveries", "redispatched",
                            "recovery_mttr_s", "update_s", "recompiles")}}),
          flush=True)
    if not ok:
        bad.append("the chaos run is not the clean run")
    if args.device == "cuda":
        print(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=False).stdout.strip())
    if bad:
        print("multicard_mpmd: " + "; ".join(bad), file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
