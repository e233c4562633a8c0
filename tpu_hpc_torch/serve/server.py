"""`python -m tpu_hpc_torch.serve` -- local request-replay serving run.

Port of the JAX package's ``serve/server.py``. Brings up the engine on
one device (``--device cuda``, the default, or ``cpu``), replays a
deterministic synthetic request mix through the continuous batcher, and
prints the serving metrics record -- TTFT/ITL quantiles, tokens/s,
serving MFU on a known card, the device, the paged-attention kernel
launch counts -- as one JSON line on stdout, plus optional JSONL traces
(``--metrics``). ``--loadgen SCENARIO`` swaps the plain replay for a
``tpu_hpc_torch.loadgen`` scenario on the deterministic virtual clock;
``--spec ngram|draft`` (with ``--paged``) decodes speculatively, and
``--temperature``/``--top-p`` sample the replay mix under per-request
seeds.

Not ported yet (ROADMAP): ``--disagg``, the fleet, the host KV tier,
``--capture-dir``, ``--supervise``, checkpoint restore and so
``--spec-draft-ckpt`` (a draft is a seeded random init). Weights are a
seeded random init.
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


def build_spec(
    engine,
    cfg: llama2.LlamaConfig,
    spec_cfg,
    draft_cfg: Optional[llama2.LlamaConfig] = None,
    seed: int = 0,
):
    """Attach speculative decoding (serve/spec.py) to a paged engine:
    a seeded random-init draft model (seed + 1, at
    ``default_draft_config`` unless ``draft_cfg`` names one) for
    ``mode="draft"``, nothing extra for prompt lookup. A random draft
    proves the wiring and the greedy oracle but accepts ~1/vocab of its
    guesses; restoring a trained draft waits for checkpoint restore
    into the serving layout (ROADMAP)."""
    from tpu_hpc_torch.serve.spec import attach_spec, default_draft_config

    draft_params = None
    dcfg = None
    if spec_cfg.mode == "draft":
        dcfg = draft_cfg or default_draft_config(cfg)
        gen = torch.Generator(device=engine.device).manual_seed(seed + 1)
        draft_params = llama2.init_llama(gen, dcfg, engine.device)
    return attach_spec(
        engine, spec_cfg, draft_params=draft_params, draft_cfg=dcfg
    )


def _bring_up(cfg, serve_cfg, seed, paged, spec, spec_draft_cfg, device,
              metrics_path):
    """Seeded random weights -> engine (+ spec runner) -> warmup.
    Returns ``(engine, n_programs)``."""
    from tpu_hpc_torch import obs
    from tpu_hpc_torch.serve.engine import Engine
    from tpu_hpc_torch.serve.paging import PagedEngine

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
    if spec is not None:
        build_spec(engine, cfg, spec, draft_cfg=spec_draft_cfg, seed=seed)
    with obs.span("warmup", sink=metrics_path, hist="serve_warmup_s"):
        n_programs = engine.warmup()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
    return engine, n_programs


def _device_record(device) -> dict:
    return {
        "type": device.type,
        "name": (
            torch.cuda.get_device_name(device)
            if device.type == "cuda" else "cpu"
        ),
        "count": 1,
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
    spec=None,
    spec_draft_cfg: Optional[llama2.LlamaConfig] = None,
    temperature: float = 0.0,
    top_p: float = 1.0,
) -> dict:
    """Engine bring-up + warmup + replay; returns the summary dict.
    ``paged`` (a paging.PagedConfig) swaps the slab KV cache for the
    block-table pool with prefix reuse and chunked prefill. ``spec`` (a
    spec.SpecConfig, paged only) turns on speculative decoding;
    ``temperature``/``top_p`` sample the replay mix under per-request
    seeds instead of greedy. Weights are a random init from a
    ``torch.Generator`` seeded with ``seed`` on ``device``."""
    from tpu_hpc_torch import obs
    from tpu_hpc_torch.runtime import resolve_device
    from tpu_hpc_torch.serve.metrics import ServeMeter
    from tpu_hpc_torch.serve.scheduler import (
        ContinuousBatcher,
        replay_requests,
    )

    device = resolve_device(device)
    engine, n_programs = _bring_up(
        cfg, serve_cfg, seed, paged, spec, spec_draft_cfg, device,
        metrics_path,
    )

    meter = ServeMeter(metrics_path=metrics_path)
    batcher = ContinuousBatcher(engine, meter=meter)
    requests = replay_requests(
        n_requests, cfg.vocab_size, prompt_lens, max_new_tokens, seed=seed,
        temperature=temperature, top_p=top_p,
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
        device=_device_record(device),
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
    # So is the speculative mode: acceptance rate + draft cost ride
    # the summary, and spec_mode/spec_k label the record.
    if getattr(engine, "spec", None) is not None:
        summary.update(engine.spec.spec_summary())
        summary["spec_kernel_launches"] = dict(engine.spec.kernel_launches)
    meter.write_summary(summary)
    obs.get_registry().emit_snapshot(sink=metrics_path)
    return summary


def run_loadgen(
    cfg: llama2.LlamaConfig,
    serve_cfg,
    scenario_name: str,
    n_requests: int,
    max_new_tokens: int,
    metrics_path: Optional[str] = None,
    seed: int = 0,
    paged=None,
    device="cuda",
    spec=None,
    spec_draft_cfg: Optional[llama2.LlamaConfig] = None,
) -> dict:
    """Engine bring-up + a ``tpu_hpc_torch.loadgen`` scenario run;
    returns the harness summary (per-tenant quantiles on the virtual
    clock, shed/queued counts, occupancy) plus the drive's wall-clock
    seconds and tokens/s (``wall_clock_s``, ``wall_clock_tokens_per_s``,
    and with ``spec`` the draft and verify seconds,
    ``spec_wall_clock_s``; the summary's own ``wall_s``/``tokens_per_s``
    are virtual). The scenario's lengths are aligned to
    THIS engine's buckets/capacity, so any catalog entry runs against
    any serve shape. ``spec`` (a spec.SpecConfig; needs ``paged``)
    drives the scenario through speculative decoding -- the virtual
    clock charges one target forward per verify step plus the modeled
    draft cost."""
    import time

    from tpu_hpc_torch.loadgen import LoadHarness, build_scenario
    from tpu_hpc_torch.runtime import resolve_device

    # Scenario FIRST: it is cheap and validates the derived sizing
    # (build_scenario rejects max_prompt/max_new < 2), so a bad
    # combination fails before bring-up.
    max_prompt = max(serve_cfg.prefill_buckets)
    max_new = min(max_new_tokens, serve_cfg.max_seq_len - max_prompt)
    scenario = build_scenario(
        scenario_name, seed=seed, n_requests=n_requests,
        vocab_size=cfg.vocab_size, max_prompt=max_prompt,
        max_new=max_new,
    )
    device = resolve_device(device)
    engine, n_programs = _bring_up(
        cfg, serve_cfg, seed, paged, spec, spec_draft_cfg, device,
        metrics_path,
    )
    harness = LoadHarness(engine, scenario, metrics_path=metrics_path)
    launches0 = _kernel_launches()
    t0 = time.perf_counter()
    harness.drive()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    wall_s = time.perf_counter() - t0
    launches = {
        k: v - launches0[k] for k, v in _kernel_launches().items()
    }
    tokens = sum(len(v) for v in harness.batcher.results.values())
    extra = dict(
        device=_device_record(device),
        slots=serve_cfg.slots,
        prefill_buckets=list(serve_cfg.prefill_buckets),
        compiled_programs=n_programs,
        # Evaluated AFTER the drive: rebuilds must count the run (the
        # total includes the spec draft engine's builds).
        recompiles=engine.compile_count_total - n_programs,
        batcher=dict(harness.batcher.stats),
        kernel_launches=launches,
        wall_clock_s=wall_s,
        wall_clock_tokens_per_s=tokens / wall_s if wall_s > 0 else 0.0,
    )
    if getattr(engine, "spec", None) is not None:
        extra["spec_kernel_launches"] = dict(engine.spec.kernel_launches)
        extra["spec_emitted"] = engine.spec.stats["emitted"]
        extra["spec_wall_clock_s"] = {
            "draft": engine.spec.draft_time_s,
            "verify": engine.spec.verify_time_s,
        }
    if device.type == "cuda":
        extra["peak_memory_bytes"] = torch.cuda.max_memory_allocated(device)
    return harness.summarize(
        n_devices=1,
        n_params=llama2.count_params(cfg),
        peak_flops_per_device=peak_flops_for_device(device),
        extra=extra,
    )


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
        "--loadgen", type=str, default=None, metavar="SCENARIO",
        help="run a tpu_hpc_torch.loadgen scenario instead of the plain "
        "replay mix (catalog: steady, bursty, heavy_tail, "
        "multi_tenant, saturating_burst, colocate, shared_prefix, "
        "decode_heavy, diurnal, long_idle_sessions); --requests/"
        "--max-new/--seed size it, latencies run on the virtual "
        "clock (deterministic), wall time and tokens/s beside them",
    )
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
        "--spec", choices=("off", "draft", "ngram"), default="off",
        help="speculative decoding (serve/spec.py; requires --paged): "
        "'draft' drafts k tokens with a small draft model (a seeded "
        "random init), 'ngram' self-speculates via prompt lookup over "
        "each request's own history -- no extra model; greedy streams "
        "stay token-exact, only latency changes",
    )
    ap.add_argument(
        "--spec-k", type=int, default=None, metavar="K",
        help="drafted tokens per verify step (default 4); requires "
        "--spec",
    )
    ap.add_argument(
        "--spec-draft-ckpt", type=str, default=None, metavar="DIR",
        help="restore the draft model from a trainer checkpoint: not "
        "ported yet (checkpoint restore into the serving layout is a "
        "later slice), so the flag is refused",
    )
    ap.add_argument(
        "--spec-draft-model", type=str, default=None,
        choices=("half", *sorted(llama2.PRESETS)),
        help="draft architecture for --spec draft (default 'half': "
        "the target config at half depth)",
    )
    ap.add_argument(
        "--temperature", type=float, default=None,
        help="sample the replay mix at this temperature under "
        "per-request seeds (default: greedy; requires --spec -- "
        "sampling rides the verify program)",
    )
    ap.add_argument(
        "--top-p", type=float, default=None,
        help="nucleus filter for --temperature sampling (default 1.0)",
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
    # Speculative decoding rides the paged engine only; a spec flag
    # that cannot take effect is a parse error, not a silent greedy
    # run wearing a speculative label.
    if args.spec != "off" and not args.paged:
        ap.error(
            "--spec rides the paged engine (serve/paging.py); add "
            "--paged"
        )
    if args.spec != "off" and args.kv_quant == "int8":
        ap.error(
            "--spec is not consumed with --kv-quant int8 (verify "
            "replays drafted positions against pages the draft loop "
            "already requantized -- the accept/reject decision would "
            "drift from the greedy oracle)"
        )
    if args.spec == "off":
        for flag, val in (
            ("--spec-k", args.spec_k),
            ("--spec-draft-ckpt", args.spec_draft_ckpt),
            ("--spec-draft-model", args.spec_draft_model),
            ("--temperature", args.temperature),
            ("--top-p", args.top_p),
        ):
            if val is not None:
                ap.error(
                    f"{flag} is only consumed together with --spec"
                )
    if args.spec != "draft":
        for flag, val in (
            ("--spec-draft-ckpt", args.spec_draft_ckpt),
            ("--spec-draft-model", args.spec_draft_model),
        ):
            if val is not None:
                ap.error(
                    f"{flag} is only consumed together with "
                    "--spec draft"
                )
    if args.spec_draft_ckpt is not None:
        ap.error(
            "--spec-draft-ckpt: restoring a trained draft needs "
            "checkpoint restore into the serving layout, which this "
            "port has not reached yet (ROADMAP); --spec draft runs a "
            "seeded random-init draft without it"
        )
    if args.temperature is not None and args.loadgen:
        ap.error(
            "--temperature is only consumed by the replay workload; "
            "--loadgen scenarios replay their own greedy mixes"
        )
    if args.top_p is not None and args.temperature is None:
        ap.error(
            "--top-p is only consumed together with --temperature"
        )
    if args.temperature is not None and args.temperature < 0:
        ap.error(
            f"--temperature {args.temperature} must be >= 0"
        )
    if args.top_p is not None and not 0.0 < args.top_p <= 1.0:
        ap.error(f"--top-p {args.top_p} must be in (0, 1]")
    if args.spec_k is not None and args.spec_k < 1:
        ap.error(f"--spec-k {args.spec_k} must be >= 1")
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
    # --loadgen sizes its own prompt distribution to the buckets; the
    # replay mix's --prompt-lens is unused there and must not block.
    chunked = bool(args.paged and args.prefill_chunk)
    if too_long and not args.loadgen and not chunked:
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
    spec_cfg = None
    spec_draft_cfg = None
    if args.spec != "off":
        from tpu_hpc_torch.serve.spec import SpecConfig

        try:
            spec_cfg = SpecConfig(mode=args.spec, k=args.spec_k or 4)
        except ValueError as e:
            ap.error(str(e))
        if args.spec_draft_model and args.spec_draft_model != "half":
            spec_draft_cfg = llama2.PRESETS[args.spec_draft_model]
    if args.loadgen:
        from tpu_hpc_torch.loadgen import SCENARIOS

        if args.loadgen not in SCENARIOS:
            ap.error(
                f"--loadgen {args.loadgen!r}: unknown scenario "
                f"(catalog: {', '.join(SCENARIOS)})"
            )
        # The scenario's output-length budget is what the cache has
        # left after the largest bucket; a combination that leaves
        # < 2 tokens is a CLI error, not a post-bring-up traceback.
        if min(args.max_new, max_seq - max(buckets)) < 2:
            ap.error(
                f"--loadgen: cache capacity {max_seq} minus the "
                f"largest bucket {max(buckets)} leaves "
                f"{max_seq - max(buckets)} generate tokens (< 2); "
                "raise --max-seq-len or --max-new"
            )
        summary = run_loadgen(
            cfg, serve_cfg, args.loadgen, args.requests, args.max_new,
            metrics_path=args.metrics, seed=args.seed, paged=paged,
            device=device, spec=spec_cfg, spec_draft_cfg=spec_draft_cfg,
        )
    else:
        summary = run_replay(
            cfg, serve_cfg, args.requests, prompt_lens, args.max_new,
            metrics_path=args.metrics, seed=args.seed, paged=paged,
            device=device, spec=spec_cfg, spec_draft_cfg=spec_draft_cfg,
            temperature=args.temperature or 0.0,
            top_p=args.top_p if args.top_p is not None else 1.0,
        )
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
