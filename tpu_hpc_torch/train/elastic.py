"""``python -m tpu_hpc_torch.train --workload elastic``: the preemption
storm row.

Port of the JAX package's ``bench.py --workload elastic``
(``bench_elastic``): one training run driven through shrink -> train ->
grow -> train by the topology coordinator (elastic/coordinator.py),
ZERO process restarts, judged against a fixed-topology reference on the
final layout. The model is bench.py's: a two-layer tanh MLP (64 -> 128
-> 16, seeded weights), mean-squared error on seeded random batches of
``4 x extent`` rows, AdamW at lr 1e-2, one update an epoch for
``--steps`` epochs. The data extent is pinned to half the rank pool
(``max(n // 2, 1)``), the extent both halves can carry, so the loss
stream stays bit-identical across the storm.

Every rank of the process group runs it (``torchrun --nproc-per-node 4
-m tpu_hpc_torch.train --workload elastic --device cpu`` rehearses
4 -> 2 -> 4 on the CPU); one process runs a one-rank world (both morphs
1 -> 1). Rank 0 prints the bench record: ``elastic_morph_stall_s``
(mean stall seconds per morph) as the headline, morph count, wire
bytes, segments, restarts and ``loss_parity``.
"""
from __future__ import annotations

import json
import os
import shutil
import sys
import tempfile
import time
from typing import Optional

import torch

SHRINK_AT, GROW_AT = 2, 4
IN_DIM, HIDDEN, OUT_DIM = 64, 128, 16


def init_params(device) -> dict:
    """bench.py's two weight matrices, from a seeded generator."""
    g = torch.Generator().manual_seed(7)
    return {
        "w1": (torch.randn(IN_DIM, HIDDEN, generator=g) * 0.1).to(device),
        "w2": (torch.randn(HIDDEN, OUT_DIM, generator=g) * 0.1).to(device),
    }


def _mlp(params, x):
    return torch.tanh(x @ params["w1"]) @ params["w2"]


def forward(params, model_state, batch, rng):
    """bench.py's loss. On a mesh ``params`` is the laid-out module: the
    MLP runs through its call, where FSDP2 gathers the weights."""
    x, y = batch
    pred = (params(_mlp, x) if isinstance(params, torch.nn.Module)
            else _mlp(params, x))
    return torch.mean((pred - y) ** 2), model_state, {}


class StormData:
    """Seeded batches: ``batch_at(step, gbs)`` draws x and y from a
    generator seeded ``1000 + step`` (bench.py's per-step keys), the
    same on every rank."""

    def batch_at(self, step, gbs):
        g = torch.Generator().manual_seed(1000 + int(step))
        x = torch.randn(gbs, IN_DIM, generator=g)
        y = torch.randn(gbs, OUT_DIM, generator=g)
        return x, y


def _losses(path: str) -> list:
    out = []
    if not os.path.exists(path):
        return out
    with open(path) as f:
        for line in f:
            r = json.loads(line)
            if r.get("event") == "epoch":
                out.append((r["step"], r["loss"]))
    return out


def run_elastic(steps: int, shrink_at: int = SHRINK_AT,
                grow_at: int = GROW_AT, device="cuda") -> dict:
    """The storm on the process group's ranks (a one-rank world when
    none is up); returns bench.py's record (on every rank; rank 0's
    ``loss_parity`` reads the run logs)."""
    import torch.distributed as dist

    from tpu_hpc_torch.config import TrainingConfig
    from tpu_hpc_torch.elastic import TopologyCoordinator, choose_layout
    from tpu_hpc_torch.elastic.coordinator import build_rank_mesh
    from tpu_hpc_torch.parallel.plans import P
    from tpu_hpc_torch.runtime import resolve_device
    from tpu_hpc_torch.train.trainer import Trainer

    device = resolve_device(device)
    n_dev = dist.get_world_size()
    ranks = list(range(n_dev))
    extent = max(n_dev // 2, 1)
    batch = extent * 4
    tmp = tempfile.mkdtemp(prefix="elastic_")

    def cfg_for(path):
        return TrainingConfig(
            epochs=steps, steps_per_epoch=1, global_batch_size=batch,
            learning_rate=1e-2, weight_decay=0.01, metrics_path=path,
        )

    def factory_for(cfg):
        def factory(mesh):
            params = init_params(device)
            return Trainer(cfg, mesh, forward, params,
                           param_pspecs={k: P() for k in params},
                           batch_pspec=P("data"), device=device)
        return factory

    # Fixed-topology reference on the FINAL layout (the full pool, the
    # same layout policy) -- built before the chaos schedule is armed,
    # or the un-managed Trainer would rightly refuse it.
    fixed_path = os.path.join(tmp, "fixed.jsonl")
    decision = choose_layout(ranks, global_batch=batch,
                             current_data_extent=extent,
                             device_type=device.type)
    mesh = build_rank_mesh(decision.axes, ranks, device.type)
    factory_for(cfg_for(fixed_path))(mesh).fit(StormData())

    morph_path = os.path.join(tmp, "morph.jsonl")
    prev = os.environ.get("TPU_HPC_FAULTS")
    os.environ["TPU_HPC_FAULTS"] = (
        f"slice_down_at_step={shrink_at},slice_up_at_step={grow_at}")
    t0 = time.perf_counter()
    try:
        coord = TopologyCoordinator(
            factory_for(cfg_for(morph_path)), global_batch=batch,
            data_extent=extent, device_type=device.type,
        )
        summary = coord.run(StormData())
    finally:
        if prev is None:
            os.environ.pop("TPU_HPC_FAULTS", None)
        else:
            os.environ["TPU_HPC_FAULTS"] = prev
    wall = time.perf_counter() - t0
    parity = _losses(fixed_path) == _losses(morph_path)
    morphs = summary["morph_count"]
    if dist.get_rank() == 0:
        print(
            f"elastic | {n_dev} devices, shrink@{shrink_at} "
            f"grow@{grow_at} | {morphs} morphs, "
            f"{summary['wire_bytes']} wire bytes, "
            f"{summary['stall_s']:.3f}s stall | restarts "
            f"{summary['restarts']} | loss parity {parity} | "
            f"{wall:.1f}s wall", file=sys.stderr)
    shutil.rmtree(tmp, ignore_errors=True)
    return {
        "metric": "elastic_morph_stall_s",
        "value": round(summary["stall_s"] / max(morphs, 1), 6),
        "unit": "s",
        "vs_baseline": None,
        "faults": (f"slice_down_at_step={shrink_at},"
                   f"slice_up_at_step={grow_at}"),
        "morphs": morphs,
        "morph_wire_bytes": summary["wire_bytes"],
        "stall_s": summary["stall_s"],
        "restarts": summary["restarts"],
        "segments": len(summary["segments"]),
        "loss_parity": parity,
        "n_devices": n_dev,
    }


def elastic_flag_error(args) -> Optional[str]:
    """bench.py's discipline for the storm flags, in its words: a morph
    schedule on a workload that never morphs, and one that could never
    fire, are CLI errors. Resolves the defaults into ``args``."""
    if args.workload != "elastic":
        for flag, val in (
            ("--elastic-shrink-at", args.elastic_shrink_at),
            ("--elastic-grow-at", args.elastic_grow_at),
        ):
            if val is not None:
                return (f"{flag} is only consumed by --workload elastic; "
                        f"--workload {args.workload} would silently run "
                        "fixed-topology")
        return None
    shrink = args.elastic_shrink_at if args.elastic_shrink_at is not None \
        else SHRINK_AT
    grow = args.elastic_grow_at if args.elastic_grow_at is not None \
        else GROW_AT
    if not 0 < shrink < grow:
        return (f"--elastic-shrink-at {shrink} must be > 0 and < "
                f"--elastic-grow-at {grow} (the storm is shrink -> "
                "train -> grow -> train)")
    if grow >= args.steps:
        return (f"--elastic-grow-at {grow} needs --steps > {grow}: "
                "the grow morph would never fire and the chaos "
                "schedule would fail its vacuous-pass guard")
    args.elastic_shrink_at, args.elastic_grow_at = shrink, grow
    return None
