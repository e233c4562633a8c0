"""`python -m tpu_hpc_torch.serve` -- local request-replay serving run.

Port of the JAX package's ``serve/server.py`` replay path. Brings up
the engine on one device (``--device cuda``, the default, or ``cpu``),
replays a deterministic synthetic request mix through the continuous
batcher, and prints the serving metrics record -- TTFT/ITL quantiles,
tokens/s, serving MFU on a known card, the device, the paged-attention
kernel launch counts -- as one JSON line on stdout, plus optional JSONL
traces (``--metrics``).

Not ported yet (ROADMAP): ``--loadgen`` scenarios, ``--disagg``,
``--spec``, the fleet, the host KV tier, ``--supervise`` and checkpoint
restore. Weights are a seeded random init.
"""
from __future__ import annotations

import argparse
import json
import sys
from typing import Optional, Sequence

import torch

from tpu_hpc_torch.checks.roofline import peak_flops_for_device
from tpu_hpc_torch.models import llama2


def tiny_config(vocab_size: int = 512) -> llama2.LlamaConfig:
    """The small model the replay server defaults to (the JAX
    package's tiny config)."""
    return llama2.LlamaConfig(
        dim=128, n_layers=2, n_heads=8, n_kv_heads=4,
        vocab_size=vocab_size, multiple_of=32, max_seq_len=512,
        dtype=torch.bfloat16,
    )


def _kernel_launches() -> dict:
    from tpu_hpc_torch.kernels.paged_attention import (
        paged_decode_attention,
        paged_prefill_attention,
    )

    return {
        "paged_decode_attention": paged_decode_attention.launches,
        "paged_prefill_attention": paged_prefill_attention.launches,
    }


def run_replay(
    cfg: llama2.LlamaConfig,
    serve_cfg,
    n_requests: int,
    prompt_lens: Sequence[int],
    max_new_tokens: int,
    metrics_path: Optional[str] = None,
    seed: int = 0,
    paged=None,
    device="cuda",
) -> dict:
    """Engine bring-up + warmup + replay; returns the summary dict.
    ``paged`` (a paging.PagedConfig) swaps the slab KV cache for the
    block-table pool with prefix reuse and chunked prefill. Weights are
    a random init from a ``torch.Generator`` seeded with ``seed`` on
    ``device``."""
    from tpu_hpc_torch import obs
    from tpu_hpc_torch.runtime import resolve_device
    from tpu_hpc_torch.serve.engine import Engine
    from tpu_hpc_torch.serve.metrics import ServeMeter
    from tpu_hpc_torch.serve.paging import PagedEngine
    from tpu_hpc_torch.serve.scheduler import (
        ContinuousBatcher,
        replay_requests,
    )

    device = resolve_device(device)
    with obs.span("restore", sink=metrics_path, hist="serve_restore_s"):
        gen = torch.Generator(device=device).manual_seed(seed)
        params = llama2.init_llama(gen, cfg, device)
        if paged is not None:
            engine = PagedEngine(params, cfg, serve_cfg, device, paged)
        else:
            engine = Engine(params, cfg, serve_cfg, device)
        # The engine holds its own compute-dtype copy; drop the init
        # tree so the float32 master copy does not stay resident.
        del params
    with obs.span("warmup", sink=metrics_path, hist="serve_warmup_s"):
        n_programs = engine.warmup()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)

    meter = ServeMeter(metrics_path=metrics_path)
    batcher = ContinuousBatcher(engine, meter=meter)
    requests = replay_requests(
        n_requests, cfg.vocab_size, prompt_lens, max_new_tokens, seed=seed,
    )
    launches0 = _kernel_launches()
    batcher.run(requests)
    launches = {
        k: v - launches0[k] for k, v in _kernel_launches().items()
    }

    summary = meter.summary(
        n_devices=1,
        n_params=llama2.count_params(cfg),
        peak_flops_per_device=peak_flops_for_device(device),
    )
    summary.update(
        device={
            "type": device.type,
            "name": (
                torch.cuda.get_device_name(device)
                if device.type == "cuda" else "cpu"
            ),
            "count": 1,
        },
        slots=serve_cfg.slots,
        prefill_buckets=list(serve_cfg.prefill_buckets),
        cache_bytes=engine.cache_bytes,
        compiled_programs=n_programs,
        recompiles=engine.compile_count_total - n_programs,
        batcher=dict(batcher.stats),
        kernel_launches=launches,
    )
    if device.type == "cuda":
        summary["peak_memory_bytes"] = torch.cuda.max_memory_allocated(
            device
        )
    # The cache layout is part of every serving record's identity.
    if paged is not None:
        summary.update(engine.paged_summary())
    else:
        summary["kv_layout"] = "slab"
    meter.write_summary(summary)
    obs.get_registry().emit_snapshot(sink=metrics_path)
    return summary


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="tpu_hpc_torch.serve",
        description=__doc__.split("\n")[0],
        allow_abbrev=False,
    )
    ap.add_argument(
        "--model", type=str, default="tiny",
        choices=("tiny", *sorted(llama2.PRESETS)),
        help="model architecture (tiny = the small development config)",
    )
    ap.add_argument("--vocab", type=int, default=512,
                    help="vocab size for --model tiny")
    ap.add_argument("--slots", type=int, default=8,
                    help="fixed decode batch width")
    ap.add_argument("--max-seq-len", type=int, default=None,
                    help="KV-cache capacity per slot "
                    "(default: largest bucket + max-new)")
    ap.add_argument(
        "--buckets", type=str, default="16,32",
        help="comma-separated padded prefill lengths",
    )
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument(
        "--prompt-lens", type=str, default="9,14,27",
        help="comma-separated prompt lengths the replay mix cycles",
    )
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument(
        "--paged", action="store_true",
        help="paged KV cache (serve/paging.py): memory carved into "
        "fixed-size pages with a block table per slot, prefix reuse "
        "over shared prompts, chunked prefill",
    )
    ap.add_argument(
        "--kv-block-size", type=int, default=None, metavar="TOKENS",
        help="tokens per KV page (default 16; must divide every "
        "bucket and the cache capacity); requires --paged",
    )
    ap.add_argument(
        "--kv-blocks", type=int, default=None, metavar="N",
        help="physical pages in the pool incl. the scratch page "
        "(default: slab-equivalent capacity, slots x max-seq-len / "
        "block-size + 1); requires --paged",
    )
    ap.add_argument(
        "--prefill-chunk", type=int, default=None, metavar="TOKENS",
        help="chunked prefill stride: long prompts prefill in "
        "block-aligned chunks interleaved with decode steps (0 = "
        "whole-prompt prefill); requires --paged",
    )
    ap.add_argument(
        "--kv-kernel", choices=("gather", "cuda"), default=None,
        help="paged attention read path "
        "(tpu_hpc_torch.kernels.paged_attention): 'gather' builds each "
        "slot's dense view with an index gather (the reference path), "
        "'cuda' walks the block table inside the hand-written Hopper "
        "kernels (their plain PyTorch versions on --device cpu); "
        "requires --paged",
    )
    ap.add_argument(
        "--kv-quant", choices=("none", "int8"), default=None,
        help="KV page storage: 'int8' stores pages quantized per page "
        "with a float32 scale side array; requires --paged",
    )
    ap.add_argument(
        "--metrics", type=str, default=None,
        help="append per-request + summary JSONL records here",
    )
    ap.add_argument(
        "--device", choices=("cuda", "cpu"), default="cuda",
        help="where to serve (default cuda; a missing card is an "
        "error, never a silent CPU run)",
    )
    args = ap.parse_args(argv)

    if not args.paged:
        for flag, val in (
            ("--kv-block-size", args.kv_block_size),
            ("--kv-blocks", args.kv_blocks),
            ("--prefill-chunk", args.prefill_chunk),
            ("--kv-kernel", args.kv_kernel),
            ("--kv-quant", args.kv_quant),
        ):
            if val is not None:
                ap.error(f"{flag} is only consumed together with --paged")
    from tpu_hpc_torch.runtime import resolve_device

    try:
        device = resolve_device(args.device)
    except RuntimeError as e:
        ap.error(str(e))

    if args.model == "tiny":
        cfg = tiny_config(args.vocab)
    else:
        cfg = llama2.PRESETS[args.model]
    buckets = tuple(int(b) for b in args.buckets.split(","))
    prompt_lens = tuple(int(p) for p in args.prompt_lens.split(","))
    too_long = [p for p in prompt_lens if p > max(buckets)]
    chunked = bool(args.paged and args.prefill_chunk)
    if too_long and not chunked:
        ap.error(
            f"prompt lens {too_long} exceed the largest bucket "
            f"{max(buckets)} (chunked prefill -- --paged "
            "--prefill-chunk N -- lifts this limit)"
        )
    max_seq = (
        args.max_seq_len if args.max_seq_len is not None
        else max(buckets) + args.max_new
    )
    paged = None
    if args.paged:
        from tpu_hpc_torch.serve.paging import derive_paged_config

        try:
            paged, max_seq = derive_paged_config(
                args.slots, max_seq, buckets,
                block_size=args.kv_block_size,
                num_blocks=args.kv_blocks,
                prefill_chunk=args.prefill_chunk,
                align_capacity=args.max_seq_len is None,
                kernel=args.kv_kernel,
                kv_quant=args.kv_quant,
            )
        except ValueError as e:
            ap.error(str(e))
    if max_seq > cfg.max_seq_len:
        ap.error(
            f"cache capacity {max_seq} exceeds the model's "
            f"max_seq_len {cfg.max_seq_len}"
        )
    from tpu_hpc_torch.serve.engine import ServeConfig

    serve_cfg = ServeConfig(
        slots=args.slots, max_seq_len=max_seq, prefill_buckets=buckets
    )
    summary = run_replay(
        cfg, serve_cfg, args.requests, prompt_lens, args.max_new,
        metrics_path=args.metrics, seed=args.seed, paged=paged,
        device=device,
    )
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
