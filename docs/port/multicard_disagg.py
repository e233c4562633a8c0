#!/usr/bin/env python3
"""Disaggregated serving across two cards: the KV hop over NVLink.

On one host with two or more cards, replays chip_smoke.py's serve mix
(Llama-2-7B at full width and depth, seeded bf16 weights, 8 slots,
16-token pages, the cuda kernels, 16 requests of 100-500 prompt tokens
x 32 new tokens) three ways through ``serve.server.run_replay``:

  1. single tier on card 0;
  2. disaggregated, both tiers on card 0 (what chip_smoke.py's ops
     phase runs);
  3. disaggregated by ``split_serving_meshes``: prefill on card 0,
     decode on the first card of the second half, the KV pages crossing
     between the cards by the per-bucket reshard plans (bounded by the
     planner's "auto" chunk, as in 2).

Each run prints one JSON line (TTFT/ITL p50/p95, tokens/s, peak memory,
and for the disaggregated runs kv_transfers, kv_transfer_bytes and the
hop's p50/p95 ms), with whether its greedy tokens equal the single
tier's; then ``nvidia-smi``'s name and power limit of each card. From
the repository root:

    python3 docs/port/multicard_disagg.py
"""
from __future__ import annotations

import json
import os
import subprocess
import sys

sys.path.insert(0, os.getcwd())


def main() -> int:
    import torch

    import chip_smoke
    from tpu_hpc_torch.kernels import _build
    from tpu_hpc_torch.serve.disagg import split_serving_meshes
    from tpu_hpc_torch.serve.server import run_replay

    n = torch.cuda.device_count()
    if n < 2:
        raise SystemExit(f"{n} card(s): the two-card hop needs 2")
    _build.build()
    _build.load_library()
    cfg, serve_cfg, paged = chip_smoke.serve_shape()
    card0 = torch.device("cuda", 0)
    runs = [("single_tier", None), ("disagg_one_card", (card0, card0)),
            ("disagg_two_cards", split_serving_meshes(n, cfg))]
    single = None
    for name, tiers in runs:
        with chip_smoke.recorded_runs() as streams:
            summary = run_replay(
                cfg, serve_cfg, chip_smoke.SERVE_REQUESTS,
                chip_smoke.SERVE_PROMPT_LENS, chip_smoke.SERVE_MAX_NEW,
                seed=0, paged=paged, device=card0, disagg=tiers is not None,
                disagg_max_inflight_mb="auto" if tiers else None,
                disagg_devices=tiers)
        tokens = streams[-1]
        single = single if single is not None else tokens
        rec = {"run": name,
               "tiers": [str(d) for d in tiers] if tiers else [str(card0)],
               "tokens_equal_single_tier": tokens == single,
               **{k: summary[k] for k in (
                   "requests", "tokens", "ttft_ms_p50", "ttft_ms_p95",
                   "itl_ms_p50", "itl_ms_p95", "tokens_per_s", "wall_s",
                   "peak_memory_bytes", "recompiles", "kernel_launches")
                  if k in summary}}
        if tiers:
            rec["disagg"] = {k: summary["disagg"][k] for k in (
                "kv_transfers", "kv_transfer_bytes", "kv_transfer_ms_p50",
                "kv_transfer_ms_p95", "max_inflight_bytes")}
        print(json.dumps(rec), flush=True)
        chip_smoke._release(torch)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
