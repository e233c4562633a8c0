#!/usr/bin/env python3
"""How much the draft pool's unwritten position costs a draft model.

The draft program (``serve/spec.py::make_spec_draft_fn``, as in the JAX
package) runs k steps and writes a step's K/V only while ``j <
n_valid``. After a clean sweep (every valid draft accepted) the last
accepted draft, at ``pos + n_valid``, was never written into the draft
pool, and the next draft step reads that position unwritten. The
target drafting for itself shows the cost: its drafts would otherwise
all be accepted.

This script serves chip_smoke's ``serve_spec`` (a) mix (16 requests of
100-500 prompt tokens, 32 new each, 8 slots, 16-token pages, k 4) with
the target as its own draft, at 7B width with 2 layers in float32,
twice: with the draft program as it is, and with one more step that
only writes (k + 1 steps writing while ``j <= n_valid``). Prints one
JSON line per run with the spec counts. CPU by default (~70 s a run);
``--device cuda`` on a card.

    python3 docs/port/spec_draft_hole.py [--device cuda] [--kernel cuda]
"""
import argparse
import dataclasses
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))


def closing_draft_fn(make_draft_fn):
    """The draft program with one more step that closes the hole: k + 1
    steps, writing while ``j <= n_valid``, the last step's draw
    dropped."""
    def make(cfg, k, block_size, max_blocks, table_width, kernel="gather"):
        inner = make_draft_fn(cfg, k + 1, block_size, max_blocks,
                              table_width, kernel)

        def draft(params, ks, vs, tokens, pos, tables, active, n_valid,
                  seeds, temps, top_ps):
            toks, probs = inner(params, ks, vs, tokens, pos, tables, active,
                                n_valid + 1, seeds, temps, top_ps)
            return toks[:, :k], probs[:, :k]
        return draft
    return make


def run(torch, device, kernel, closed):
    from tpu_hpc_torch.models import llama2
    from tpu_hpc_torch.serve import (
        ContinuousBatcher,
        PagedConfig,
        PagedEngine,
        ServeConfig,
        SpecConfig,
        attach_spec,
        replay_requests,
    )
    import tpu_hpc_torch.serve.spec as spec

    original = spec.make_spec_draft_fn
    if closed:
        spec.make_spec_draft_fn = closing_draft_fn(original)
    try:
        cfg = dataclasses.replace(llama2.PRESETS["7b"], n_layers=2,
                                  dtype=torch.float32)
        gen = torch.Generator(device=device).manual_seed(1)
        params = llama2.init_llama(gen, cfg, device)
        eng = PagedEngine(
            params, cfg,
            ServeConfig(slots=8, max_seq_len=1024,
                        prefill_buckets=(256, 512)),
            device,
            PagedConfig(block_size=16, num_blocks=513, prefill_chunk=256,
                        kernel=kernel),
        )
        attach_spec(eng, SpecConfig(mode="draft", k=4),
                    draft_params=params, draft_cfg=cfg)
        eng.warmup()
        reqs = replay_requests(16, cfg.vocab_size,
                               (100, 180, 260, 340, 420, 500), 32, seed=0)
        ContinuousBatcher(eng).run(reqs)
        return dict(eng.spec.stats)
    finally:
        spec.make_spec_draft_fn = original


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cpu", choices=("cpu", "cuda"))
    ap.add_argument("--kernel", default="gather", choices=("gather", "cuda"))
    args = ap.parse_args()
    import torch

    for closed in (False, True):
        stats = run(torch, torch.device(args.device), args.kernel, closed)
        print(json.dumps({
            "draft_program": "k+1 steps, j <= n_valid" if closed
            else "as in the JAX package",
            "device": args.device, "kernel": args.kernel, **stats,
            "acceptance": stats["accepted"] / max(1, stats["drafted"]),
        }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
