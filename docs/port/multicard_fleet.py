#!/usr/bin/env python3
"""The serving fleet across the cards of one host: one process, replica
r on cuda:r (``split_fleet_devices``, the default placement), against
the same replicas packed on cuda:0.

``run_fleet_loadgen`` over diurnal at Llama-2-7B width (``--layers``
deep, seeded random weights, bf16, 16-token pages, the paged kernels)
four times: spread and packed, each clean and with ``replica_kill_at``
(redispatch onto the survivors). Each record gives the wall seconds and
tokens/s, the virtual TTFT/ITL, the fleet block and each card's peak
memory, and for every redispatched request whether its stream equals
the clean run's, and if not, the first token that differs against the
tokens committed before the replay. The clean runs must be equal, the
kill runs must equal each other, and every request that was not
redispatched must equal the clean stream. Ends with ``nvidia-smi``'s
name and power limit of each card. From the repository root:

    python3 docs/port/multicard_fleet.py                 # every card
    python3 docs/port/multicard_fleet.py --device cpu --replicas 4 \\
        --layers 1 --dim 64    # a rehearsal on the CPU

Exits non-zero if one of those differs, a request is lost or a program
is rebuilt.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys

sys.path.insert(0, os.getcwd())


def main(argv=None) -> int:
    import torch

    import chip_smoke as cs
    from tpu_hpc_torch.models import llama2
    from tpu_hpc_torch.serve import PagedConfig, ServeConfig
    from tpu_hpc_torch.serve.server import run_fleet_loadgen

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--replicas", type=int, default=None,
                    help="default: every visible card")
    ap.add_argument("--layers", type=int, default=cs.FLEET_LAYERS)
    ap.add_argument("--dim", type=int, default=None,
                    help="model width (default 7B's; a CPU rehearsal "
                    "shrinks it, heads 2 at head_dim dim / 2)")
    ap.add_argument("--requests", type=int, default=32)
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        print("multicard_fleet: no CUDA device", file=sys.stderr)
        return 1
    n = args.replicas or (torch.cuda.device_count()
                          if args.device == "cuda" else 4)
    cfg = dataclasses.replace(llama2.PRESETS["7b"], n_layers=args.layers)
    if args.dim:
        cfg = dataclasses.replace(cfg, dim=args.dim, n_heads=2, n_kv_heads=2,
                                  dtype=torch.float32)
    serve_cfg = ServeConfig(slots=8, max_seq_len=1024,
                            prefill_buckets=(256, 512))
    paged = PagedConfig(block_size=16, num_blocks=513, prefill_chunk=256,
                        kernel="cuda")
    spread = ([torch.device("cuda", r) for r in range(n)]
              if args.device == "cuda" else [torch.device("cpu")] * n)
    packed = [spread[0]] * n
    kill_at = max(4, args.requests // 4)
    runs = {}
    kill = f"replica_kill_at={kill_at}"
    for name, devices, faults in (("spread", spread, ""),
                                  ("spread_kill", spread, kill),
                                  ("packed", packed, ""),
                                  ("packed_kill", packed, kill)):
        with cs.loadgen_faults(faults), cs.captured_harnesses() as seen:
            s = run_fleet_loadgen(
                cfg, serve_cfg, "diurnal", args.requests, 16, paged,
                n_replicas=n, min_replicas=n, initial_replicas=n, seed=0,
                devices=devices)
        fleet = seen[-1].fleet
        runs[name] = dict(
            {k: s[k] for k in cs.FLEET_KEYS if k in s},
            fleet=s["fleet"], devices=s["devices"],
            streams=dict(fleet.results),
            committed_at_redispatch={r: len(b) for r, b in
                                     fleet._base.items()},
            peak_memory_by_card=[
                torch.cuda.max_memory_allocated(d) for d in spread
            ] if args.device == "cuda" else None)
        del seen
        if args.device == "cuda":
            cs._release(torch)
        print(json.dumps({"run": name, **{
            k: v for k, v in runs[name].items() if k != "streams"}}),
            flush=True)
    clean = runs["spread"]["streams"]
    kill = runs["spread_kill"]
    replayed = {}
    for rid, committed in kill["committed_at_redispatch"].items():
        got, want = kill["streams"][rid], clean[rid]
        first = next((i for i, (a, b) in enumerate(zip(got, want))
                      if a != b), None)
        replayed[rid] = {"equal": got == want, "committed": committed,
                         "first_difference": first}
    untouched_equal = all(
        kill["streams"][r] == clean[r] for r in clean if r not in replayed)
    ok = (runs["packed"]["streams"] == clean
          and runs["packed_kill"]["streams"] == kill["streams"]
          and untouched_equal and bool(replayed)
          and all(r["lost_requests"] == 0 and r["recompiles"] == 0
                  for r in runs.values()))
    print(json.dumps({"replicas": n, "layers": args.layers,
                      "packed_equals_spread": runs["packed"]["streams"]
                      == clean,
                      "packed_kill_equals_spread_kill":
                      runs["packed_kill"]["streams"] == kill["streams"],
                      "not_redispatched_equal_clean": untouched_equal,
                      "redispatched": replayed, "ok": ok}))
    if args.device == "cuda":
        print(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True).stdout.strip())
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
