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
seeds. ``--kv-host-blocks N`` puts the host-DRAM page tier behind the
paged pool; ``--fleet N`` serves the scenario from N paged replicas
(router, redispatch, autoscale, ``--fleet-swap-at`` weight hot-swap).
Weights are restored from the newest trainer checkpoint under
``--checkpoint-dir`` (``--spec-draft-ckpt`` for the draft), else a
seeded random init.

Resilience: ``--supervise N`` re-launches under
``tpu_hpc_torch.resilience.supervisor`` with N bounded restarts, and the
batcher ticks the supervisor's heartbeat file at decode-step
granularity, so a wedged decode step is detected and the run restarted
instead of hanging the card.

Anomaly-triggered capture: ``--loadgen ... --capture-dir DIR`` arms an
``obs.AnomalyCapture`` on the harness (a stall or an SLO breach files
one bounded torch.profiler window over the next 8 ticks, a flight dump
and a ``device_memory`` record under DIR); ``python -m
tpu_hpc_torch.obs.trace`` reads the run's ``--metrics`` log.

Disaggregated serving: ``--disagg`` runs the replay on two tiers
(serve/disagg.py) -- prefill on the first card, decode on the first
card of the second half (``--device cpu``: both tiers on the CPU) --
the KV hop a bounded
reshard plan per bucket (``--disagg-max-inflight-mb N|auto``); the
summary carries a ``disagg`` block (tier meshes, kv_transfers,
kv_transfer_bytes, kv_transfer_ms_p50/p95, per-bucket kv_plans).
"""
from __future__ import annotations

import argparse
import json
import os
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
    draft_ckpt: Optional[str] = None,
    draft_cfg: Optional[llama2.LlamaConfig] = None,
    seed: int = 0,
):
    """Attach speculative decoding (serve/spec.py) to a paged engine:
    restore the draft model for ``mode="draft"`` from the newest
    trainer checkpoint under ``draft_ckpt`` (at ``default_draft_config``
    unless ``draft_cfg`` names one), or without one a seeded random
    init (seed + 1) -- development mode: a random draft proves the
    wiring and the greedy oracle but accepts ~1/vocab of its guesses.
    Nothing extra for prompt lookup."""
    from tpu_hpc_torch.serve.spec import attach_spec, default_draft_config
    from tpu_hpc_torch.serve.weights import load_serving_params

    draft_params = None
    dcfg = None
    if spec_cfg.mode == "draft":
        dcfg = draft_cfg or default_draft_config(cfg)
        if draft_ckpt:
            draft_params = load_serving_params(draft_ckpt, dcfg,
                                               engine.device)
        else:
            gen = torch.Generator(device=engine.device).manual_seed(
                seed + 1)
            draft_params = llama2.init_llama(gen, dcfg, engine.device)
    return attach_spec(
        engine, spec_cfg, draft_params=draft_params, draft_cfg=dcfg
    )


def serving_weights(cfg, seed, device, checkpoint_dir=None) -> dict:
    """The weights a serving run starts from: the newest trainer
    checkpoint under ``checkpoint_dir``, else a random init from a
    ``torch.Generator`` seeded with ``seed`` on ``device``."""
    from tpu_hpc_torch.serve.weights import load_serving_params

    if checkpoint_dir:
        return load_serving_params(checkpoint_dir, cfg, device)
    gen = torch.Generator(device=device).manual_seed(seed)
    return llama2.init_llama(gen, cfg, device)


def _bring_up(cfg, serve_cfg, seed, paged, spec, spec_draft_cfg, device,
              metrics_path, checkpoint_dir=None, spec_draft_ckpt=None,
              disagg=None):
    """Weights (restored or seeded) -> engine (+ spec runner) ->
    warmup. ``disagg`` ``(prefill device, decode device, max inflight
    bytes)`` builds the two-tier engine. Returns ``(engine,
    n_programs)``."""
    from tpu_hpc_torch import obs
    from tpu_hpc_torch.serve.engine import Engine
    from tpu_hpc_torch.serve.paging import PagedEngine

    with obs.span("restore", sink=metrics_path, hist="serve_restore_s"):
        params = serving_weights(cfg, seed, device, checkpoint_dir)
        if disagg is not None:
            from tpu_hpc_torch.serve.disagg import DisaggEngine

            engine = DisaggEngine(params, cfg, serve_cfg, disagg[0],
                                  disagg[1], max_inflight_bytes=disagg[2],
                                  paged=paged)
        elif paged is not None:
            engine = PagedEngine(params, cfg, serve_cfg, device, paged)
        else:
            engine = Engine(params, cfg, serve_cfg, device)
        # The engine holds its own compute-dtype copy; drop the init
        # tree so the float32 master copy does not stay resident.
        del params
    if spec is not None:
        build_spec(engine, cfg, spec, draft_ckpt=spec_draft_ckpt,
                   draft_cfg=spec_draft_cfg, seed=seed)
    with obs.span("warmup", sink=metrics_path, hist="serve_warmup_s"):
        n_programs = engine.warmup()
    for dev in {device, getattr(engine, "prefill_device", device)}:
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
            torch.cuda.reset_peak_memory_stats(dev)
    return engine, n_programs


def _heartbeat_tick():
    """The supervisor's heartbeat, ticked at most every 2 s of progress
    (decode steps run at millisecond cadence, and a per-step file write
    would turn the liveness signal into I/O on the serving loop); None
    outside a supervised run."""
    import time

    from tpu_hpc_torch.resilience.heartbeat import Heartbeat

    heartbeat = Heartbeat.from_env()
    if heartbeat is None:
        return None
    last = [0.0]

    def tick(step):
        now = time.monotonic()
        if now - last[0] >= 2.0:
            last[0] = now
            heartbeat.tick(step)

    return tick


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
    checkpoint_dir: Optional[str] = None,
    spec_draft_ckpt: Optional[str] = None,
    disagg: bool = False,
    disagg_max_inflight_mb: "Optional[int | str]" = None,
    disagg_devices: Optional[Sequence] = None,
) -> dict:
    """Engine bring-up + warmup + replay; returns the summary dict.
    ``paged`` (a paging.PagedConfig) swaps the slab KV cache for the
    block-table pool with prefix reuse and chunked prefill. ``spec`` (a
    spec.SpecConfig, paged only) turns on speculative decoding;
    ``temperature``/``top_p`` sample the replay mix under per-request
    seeds instead of greedy. Weights come from :func:`serving_weights`
    (``checkpoint_dir``, else a seeded random init). ``disagg=True``
    splits prefill and decode into two tiers (serve/disagg.py), the KV
    crossing by bounded reshard plans (``disagg_max_inflight_mb``: MB
    or "auto"); ``disagg_devices`` ``(prefill, decode)`` places them
    (default: split_serving_meshes over the visible cards on cuda, the
    CPU twice on cpu). Composes with ``paged`` (the hop then ships the
    referenced pages)."""
    from tpu_hpc_torch import obs
    from tpu_hpc_torch.runtime import resolve_device
    from tpu_hpc_torch.serve.metrics import ServeMeter
    from tpu_hpc_torch.serve.scheduler import (
        ContinuousBatcher,
        replay_requests,
    )

    device = resolve_device(device)
    tiers = None
    if disagg:
        if disagg_devices is None:
            if device.type == "cuda":
                from tpu_hpc_torch.serve.disagg import split_serving_meshes

                disagg_devices = split_serving_meshes(
                    torch.cuda.device_count(), cfg)
            else:
                disagg_devices = (device, device)
        prefill_dev, device = (resolve_device(d) for d in disagg_devices)
        tiers = (prefill_dev, device,
                 "auto" if disagg_max_inflight_mb == "auto"
                 else disagg_max_inflight_mb * (1 << 20)
                 if disagg_max_inflight_mb else None)
    engine, n_programs = _bring_up(
        cfg, serve_cfg, seed, paged, spec, spec_draft_cfg, device,
        metrics_path, checkpoint_dir, spec_draft_ckpt, disagg=tiers,
    )

    meter = ServeMeter(metrics_path=metrics_path)
    batcher = ContinuousBatcher(engine, meter=meter)
    requests = replay_requests(
        n_requests, cfg.vocab_size, prompt_lens, max_new_tokens, seed=seed,
        temperature=temperature, top_p=top_p,
    )
    launches0 = _kernel_launches()
    batcher.run(requests, tick=_heartbeat_tick())
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
        summary["peak_memory_bytes"] = max(
            torch.cuda.max_memory_allocated(d)
            for d in {device, getattr(engine, "prefill_device", device)})
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
    if disagg:
        # Per-tier attribution: tier meshes, the cross-tier KV load and
        # THIS run's hop quantiles -- TTFT decomposes into prefill tier
        # + hop on this record.
        summary["disagg"] = engine.describe()
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
    checkpoint_dir: Optional[str] = None,
    spec_draft_ckpt: Optional[str] = None,
    capture_dir: Optional[str] = None,
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
    draft cost. ``capture_dir`` arms anomaly-triggered capture
    (``obs.AnomalyCapture(capture_dir, n_steps=8)`` on the engine's
    device) on the harness."""
    import time

    from tpu_hpc_torch import obs
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
        metrics_path, checkpoint_dir, spec_draft_ckpt,
    )
    capture = None
    if capture_dir:
        # Anomaly-triggered capture (obs/trace.py): a stall-watermark
        # trip or SLO breach files one bounded profiler trace +
        # flight dump under capture_dir, keyed by the triggering
        # trace id.
        capture = obs.AnomalyCapture(capture_dir, n_steps=8,
                                     device=device)
    harness = LoadHarness(engine, scenario, metrics_path=metrics_path,
                          capture=capture)
    launches0 = _kernel_launches()
    t0 = time.perf_counter()
    harness.drive(tick_cb=_heartbeat_tick())
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


def run_fleet_loadgen(
    cfg: llama2.LlamaConfig,
    serve_cfg,
    scenario_name: str,
    n_requests: int,
    max_new_tokens: int,
    paged,
    n_replicas: int,
    min_replicas: int = 1,
    initial_replicas: Optional[int] = None,
    router: str = "affinity",
    swap_at: Optional[int] = None,
    checkpoint_dir: Optional[str] = None,
    metrics_path: Optional[str] = None,
    seed: int = 0,
    devices: Optional[Sequence] = None,
) -> dict:
    """Fleet bring-up + a ``tpu_hpc_torch.loadgen`` scenario over N
    paged replicas (serve/fleet.py): router by tenant class + prefix
    affinity, heartbeat-driven failure handling, autoscale between
    ``min_replicas`` and ``n_replicas``, and -- with ``swap_at`` -- a
    mid-run live weight update (development mode publishes a fresh
    random init at seed+1: a genuinely different model version;
    production publishes a trained checkpoint through the same
    content-checksum gate). ``TPU_HPC_LOADGEN_FAULTS`` fleet keys
    (replica_kill_at, swap_corrupt, slow_replica) inject the chaos
    matrix.

    ``devices`` (one per replica, repeats allowed; default one card a
    replica, serve/fleet.split_fleet_devices) places the replicas. The
    summary is the fleet harness's, on the virtual clock, plus the
    drive's wall-clock seconds and tokens/s, the paged kernels'
    launches over the drive and the peak device memory."""
    import time

    from tpu_hpc_torch import obs
    from tpu_hpc_torch.loadgen import build_scenario, parse_faults
    from tpu_hpc_torch.runtime import resolve_device
    from tpu_hpc_torch.serve.fleet import (
        FleetConfig,
        FleetHarness,
        build_fleet_engines,
        split_fleet_devices,
    )
    from tpu_hpc_torch.serve.weights import place_params

    max_prompt = max(serve_cfg.prefill_buckets)
    max_new = min(max_new_tokens, serve_cfg.max_seq_len - max_prompt)
    scenario = build_scenario(
        scenario_name, seed=seed, n_requests=n_requests,
        vocab_size=cfg.vocab_size, max_prompt=max_prompt,
        max_new=max_new,
    )
    if devices is None:
        devices = split_fleet_devices(torch.cuda.device_count(), n_replicas)
    devices = [resolve_device(d) for d in devices]
    home = devices[0]
    with obs.span("restore", sink=metrics_path, hist="serve_restore_s"):
        # One restore (or init), placed once into the serving layout;
        # each engine places its own copy from it.
        params = place_params(
            serving_weights(cfg, seed, home, checkpoint_dir), cfg, home)
    swap_weights = None
    if swap_at is not None:
        swap_weights = place_params(
            serving_weights(cfg, seed + 1, home), cfg, home)
    with obs.span("warmup", sink=metrics_path, hist="serve_warmup_s"):
        engines = build_fleet_engines(
            params, cfg, serve_cfg, paged, n_replicas, devices=devices,
        )
    del params
    harness = FleetHarness(
        engines, scenario,
        FleetConfig(
            initial_replicas=(
                initial_replicas
                if initial_replicas is not None
                else max(min_replicas, (n_replicas + 1) // 2)
            ),
            min_replicas=min_replicas,
            max_replicas=n_replicas,
            router=router,
        ),
        metrics_path=metrics_path,
        faults=parse_faults(),
        swap_at=swap_at,
        swap_weights=swap_weights,
    )
    n_programs = harness.fleet.compile_count_total()
    for d in {d for d in devices if d.type == "cuda"}:
        torch.cuda.synchronize(d)
        torch.cuda.reset_peak_memory_stats(d)
    launches0 = _kernel_launches()
    t0 = time.perf_counter()
    harness.drive()
    for d in {d for d in devices if d.type == "cuda"}:
        torch.cuda.synchronize(d)
    wall_s = time.perf_counter() - t0
    launches = {
        k: v - launches0[k] for k, v in _kernel_launches().items()
    }
    tokens = sum(len(v) for v in harness.fleet.results.values())
    extra = dict(
        mesh={"replicas": n_replicas},
        devices=[str(d) for d in devices],
        device=_device_record(home),
        slots=serve_cfg.slots,
        prefill_buckets=list(serve_cfg.prefill_buckets),
        compiled_programs=n_programs,
        recompiles=harness.fleet.compile_count_total() - n_programs,
        kernel_launches=launches,
        wall_clock_s=wall_s,
        wall_clock_tokens_per_s=tokens / wall_s if wall_s > 0 else 0.0,
    )
    if home.type == "cuda":
        extra["peak_memory_bytes"] = max(
            torch.cuda.max_memory_allocated(d)
            for d in devices if d.type == "cuda")
    return harness.summarize(n_devices=len(set(devices)), extra=extra)


def _last_json_line(log_dir: str) -> Optional[str]:
    """The newest attempt log's final JSON line (the child's summary
    record), or None when no attempt log holds one."""
    import glob

    logs = sorted(
        glob.glob(os.path.join(log_dir, "run.attempt*.log")),
        key=os.path.getmtime,
    )
    for path in reversed(logs):
        try:
            with open(path) as f:
                lines = f.read().splitlines()
        except OSError:
            continue
        for line in reversed(lines):
            line = line.strip()
            if line.startswith("{"):
                try:
                    json.loads(line)
                except ValueError:
                    continue
                return line
    return None


def _inflight_mb(v: str):
    """--disagg-max-inflight-mb value: an int MB count or 'auto'.
    Range/type errors surface at parse, before any model init -- the
    misplaced-flag discipline."""
    if v == "auto":
        return "auto"
    try:
        return int(v)
    except ValueError:
        raise argparse.ArgumentTypeError(
            f"expected an integer MB count or 'auto', got {v!r}"
        ) from None


def main(argv: Optional[Sequence[str]] = None) -> int:
    # allow_abbrev=False: --supervise is stripped by exact name before
    # the re-launch.
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
        "--capture-dir", type=str, default=None, metavar="DIR",
        help="arm anomaly-triggered capture for the --loadgen run: a "
        "stall-watermark trip or SLO breach files one bounded "
        "profiler trace + flight dump under DIR, keyed by the "
        "triggering trace id (obs/trace.py)",
    )
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
        "--disagg", action="store_true",
        help="disaggregated serving: prefill on one tier, decode on "
        "another (the first card of each half of the visible cards; "
        "the CPU twice with --device cpu), KV blocks moved by bounded "
        "reshard plans",
    )
    ap.add_argument(
        "--disagg-max-inflight-mb", type=_inflight_mb, default=None,
        metavar="MB|auto",
        help="peak transient of a cross-tier KV move (chunked above "
        "it); 'auto' sizes it from the collective planner's cost "
        "model; requires --disagg",
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
        "--kv-host-blocks", type=int, default=None, metavar="N",
        help="host-DRAM page tier (serve/tier.py): N pinned host page "
        "slots incl. the scratch slot behind the device pool -- parked "
        "trie pages spill there under pool pressure and refill on a "
        "returning prompt (prefetch-before-seat); requires --paged",
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
        help="restore the draft model from the newest trainer "
        "checkpoint here (requires --spec draft; without it the draft "
        "is a seeded random init -- wiring proof, ~zero acceptance)",
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
        "--fleet", type=int, default=None, metavar="N",
        help="serve the --loadgen scenario from a fleet of N paged "
        "replicas, one card each (serve/fleet.py; N times --device cpu "
        "with --device cpu): tenant-class + prefix-affinity routing, "
        "heartbeat failure handling with request redispatch, "
        "autoscale, live weight swap; requires --loadgen and --paged "
        "with --prefill-chunk",
    )
    ap.add_argument(
        "--fleet-min", type=int, default=None, metavar="N",
        help="autoscaler's minimum live replicas (default 1); "
        "requires --fleet",
    )
    ap.add_argument(
        "--fleet-router", choices=("affinity", "round_robin"),
        default=None,
        help="request placement policy (default affinity; round_robin "
        "is the degraded control -- it divides every shared prefix "
        "across N cold tries); requires --fleet",
    )
    ap.add_argument(
        "--fleet-swap-at", type=int, default=None, metavar="TICK",
        help="publish a live weight update at this fleet tick "
        "(development mode: a fresh random init at seed+1), rolled out "
        "drain-and-swap one replica at a time behind the content-"
        "checksum gate; requires --fleet",
    )
    ap.add_argument(
        "--checkpoint-dir", type=str, default=None,
        help="restore params from the newest trainer checkpoint here "
        "(serve/weights.py); default: seeded random init",
    )
    ap.add_argument(
        "--metrics", type=str, default=None,
        help="append per-request + summary JSONL records here",
    )
    ap.add_argument(
        "--supervise", type=int, default=0, metavar="N",
        help="re-launch under the resilience supervisor with N bounded "
        "restarts (heartbeat ticked at decode-step granularity; a "
        "stale heartbeat kills and restarts a wedged child)",
    )
    ap.add_argument(
        "--heartbeat-timeout", type=float, default=600.0,
        help="seconds of heartbeat staleness before the supervisor "
        "restarts the child (0 = off); must cover bring-up, checkpoint "
        "restore and engine warmup",
    )
    ap.add_argument(
        "--device", choices=("cuda", "cpu"), default="cuda",
        help="where to serve (default cuda; a missing card is an "
        "error, never a silent CPU run)",
    )
    args = ap.parse_args(argv)

    if args.supervise:
        from tpu_hpc_torch.resilience.supervisor import (
            run_supervised,
            strip_flag,
        )

        child_args = strip_flag(
            list(sys.argv[1:] if argv is None else argv), "--supervise"
        )
        log_dir = os.environ.get("TPU_HPC_SUPERVISE_LOGS", "serve_logs")
        rc = run_supervised(
            [sys.executable, "-m", "tpu_hpc_torch.serve", *child_args],
            max_restarts=args.supervise,
            log_dir=log_dir,
            heartbeat=os.path.join(log_dir, "heartbeat.json"),
            heartbeat_timeout=args.heartbeat_timeout,
        )
        if rc == 0:
            # The supervisor redirected the child's stdout into its
            # attempt log; re-emit the summary so the one-JSON-line-
            # on-stdout contract survives supervision.
            record = _last_json_line(log_dir)
            if record is not None:
                print(record)
        return rc

    # Misplaced-flag discipline: a disagg flag on a workload that
    # cannot consume it is a CLI error, not a silent single-tier run.
    if args.disagg and args.loadgen:
        ap.error(
            "--disagg is only consumed by the replay workload; the "
            "--loadgen harness charges single-tier virtual-clock "
            "costs and would silently ignore the tier split"
        )
    if args.disagg_max_inflight_mb is not None and not args.disagg:
        ap.error(
            "--disagg-max-inflight-mb is only consumed together with "
            "--disagg"
        )
    if args.disagg_max_inflight_mb is not None \
            and args.disagg_max_inflight_mb != "auto" \
            and args.disagg_max_inflight_mb < 1:
        ap.error(
            f"--disagg-max-inflight-mb {args.disagg_max_inflight_mb} "
            "must be >= 1 (or 'auto')"
        )
    # Paged sizing flags only mean something with --paged: a sizing
    # flag on a slab run silently doing nothing is exactly the
    # misplaced-flag failure mode this CLI bans.
    if not args.paged:
        for flag, val in (
            ("--kv-block-size", args.kv_block_size),
            ("--kv-blocks", args.kv_blocks),
            ("--kv-host-blocks", args.kv_host_blocks),
            ("--prefill-chunk", args.prefill_chunk),
            ("--kv-kernel", args.kv_kernel),
            ("--kv-quant", args.kv_quant),
        ):
            if val is not None:
                ap.error(f"{flag} is only consumed together with --paged")
    if args.kv_host_blocks is not None and args.kv_host_blocks < 2:
        ap.error(
            f"--kv-host-blocks {args.kv_host_blocks} must be >= 2 "
            "(one scratch slot plus at least one page)"
        )
    # Speculative decoding rides the paged engine only; a spec flag
    # that cannot take effect is a parse error, not a silent greedy
    # run wearing a speculative label.
    if args.spec != "off" and not args.paged:
        ap.error(
            "--spec rides the paged engine (serve/paging.py); add "
            "--paged"
        )
    if args.spec != "off" and args.disagg:
        ap.error(
            "--spec is not consumed by --disagg (the verify program "
            "is a single-mesh paged program; the decode tier would "
            "silently run greedy)"
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
    # A checkpoint directory that does not exist fails here, before
    # bring-up, not after the model is built.
    for flag, val in (("--checkpoint-dir", args.checkpoint_dir),
                      ("--spec-draft-ckpt", args.spec_draft_ckpt)):
        if val is not None and not os.path.isdir(val):
            ap.error(
                f"{flag} {val!r} is not a directory (checkpoint restore "
                "into the serving layout reads a trainer checkpoint "
                "directory)"
            )
    if args.temperature is not None and args.loadgen:
        ap.error(
            "--temperature is only consumed by the replay workload; "
            "--loadgen scenarios replay their own greedy mixes"
        )
    if args.capture_dir and not args.loadgen:
        ap.error(
            "--capture-dir is only consumed together with --loadgen "
            "(training runs arm capture via "
            "TrainingConfig.capture_on_anomaly)"
        )
    # Fleet flag discipline: the fleet serves loadgen scenarios over
    # paged replicas with chunked prefill (redispatch replays prompt
    # + committed tokens, which can exceed any bucket); every other
    # combination would silently not be a fleet run.
    if args.fleet is not None:
        if args.fleet < 1:
            ap.error(f"--fleet {args.fleet} must be >= 1")
        if not args.loadgen:
            ap.error("--fleet is only consumed together with "
                     "--loadgen (the fleet serves scenarios)")
        if not args.paged or not args.prefill_chunk:
            ap.error(
                "--fleet needs --paged --prefill-chunk N: replicas "
                "are paged engines (prefix affinity is trie state) "
                "and redispatch replays prompt + committed tokens, "
                "which can exceed any single prefill bucket"
            )
        if args.disagg:
            ap.error("--fleet and --disagg are mutually exclusive")
        if args.spec != "off":
            ap.error(
                "--fleet does not consume --spec (reset_pool cannot "
                "flush a mirrored draft pool)"
            )
        if args.capture_dir:
            ap.error(
                "--capture-dir is only consumed by the single-engine "
                "--loadgen harness"
            )
        if args.fleet_min is not None and not \
                1 <= args.fleet_min <= args.fleet:
            ap.error(
                f"--fleet-min {args.fleet_min} must be in "
                f"[1, --fleet {args.fleet}]"
            )
        if args.fleet_swap_at is not None and args.fleet_swap_at < 0:
            ap.error(
                f"--fleet-swap-at {args.fleet_swap_at} must be >= 0"
            )
    else:
        for flag, val in (
            ("--fleet-min", args.fleet_min),
            ("--fleet-router", args.fleet_router),
            ("--fleet-swap-at", args.fleet_swap_at),
        ):
            if val is not None:
                ap.error(
                    f"{flag} is only consumed together with --fleet"
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
                host_blocks=args.kv_host_blocks,
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
        if args.fleet is not None:
            if device.type == "cuda":
                if torch.cuda.device_count() < args.fleet:
                    ap.error(
                        f"--fleet {args.fleet} needs >= {args.fleet} "
                        f"devices (one slice each); only "
                        f"{torch.cuda.device_count()} visible -- use "
                        "--device cpu for development"
                    )
                devices = None
            else:
                devices = [device] * args.fleet
            summary = run_fleet_loadgen(
                cfg, serve_cfg, args.loadgen, args.requests,
                args.max_new, paged,
                n_replicas=args.fleet,
                min_replicas=args.fleet_min or 1,
                router=args.fleet_router or "affinity",
                swap_at=args.fleet_swap_at,
                checkpoint_dir=args.checkpoint_dir,
                metrics_path=args.metrics, seed=args.seed,
                devices=devices,
            )
        else:
            summary = run_loadgen(
                cfg, serve_cfg, args.loadgen, args.requests, args.max_new,
                metrics_path=args.metrics, seed=args.seed, paged=paged,
                device=device, spec=spec_cfg,
                spec_draft_cfg=spec_draft_cfg,
                checkpoint_dir=args.checkpoint_dir,
                spec_draft_ckpt=args.spec_draft_ckpt,
                capture_dir=args.capture_dir,
            )
    else:
        if args.disagg and device.type == "cuda" \
                and torch.cuda.device_count() < 2:
            ap.error(
                "--disagg needs >= 2 devices (one per tier); only "
                f"{torch.cuda.device_count()} visible -- use "
                "--device cpu for development"
            )
        summary = run_replay(
            cfg, serve_cfg, args.requests, prompt_lens, args.max_new,
            disagg=args.disagg,
            disagg_max_inflight_mb=args.disagg_max_inflight_mb,
            metrics_path=args.metrics, seed=args.seed, paged=paged,
            device=device, spec=spec_cfg, spec_draft_cfg=spec_draft_cfg,
            temperature=args.temperature or 0.0,
            top_p=args.top_p if args.top_p is not None else 1.0,
            checkpoint_dir=args.checkpoint_dir,
            spec_draft_ckpt=args.spec_draft_ckpt,
        )
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
