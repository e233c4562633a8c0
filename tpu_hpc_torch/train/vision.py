"""The vision and weather workloads of ``python -m tpu_hpc_torch.train``.

``--workload``:

* ``unet`` -- bench.py's "unet ddp" row (``bench_unet``): the SimpleUNet
  (``base_features`` 64, bf16 compute, fp32 params) on ``ERA5Synthetic``
  at the 1-degree grid (181 x 360, 20 channels), 8 samples per data
  rank, lr 1e-3, latitude-weighted MSE, data parallel over a ``{"data":
  n}`` mesh with ``dp.param_pspecs`` (the params replicated in the plan;
  FSDP2 carries them over ``data``, as the port's flat mode does every
  plan) and the BatchNorm moments summed over the data group -- one jit
  over the global batch in the JAX run. One process trains on a
  one-rank world (NCCL on a card, gloo on the CPU), bench.py's shape on
  one chip. Metric ``unet_dp_train_throughput`` (samples/s).
* ``vit`` -- ``examples/03``'s ViT (64 x 128, patch 4, embed 256, depth
  6, 8 heads, bf16) on ``ERA5Synthetic(64, 128)``, attention through
  the three flash kernels without a causal mask (``vit.flash_attn_fn``;
  ``--attn reference`` takes the plain path); ``--model m`` splits it
  tensor-parallel over a ``{"data": d, "model": m}`` mesh by
  ``tp.vit_rules`` (q/k/v_proj and fc1 colwise, out_proj and fc2
  rowwise), the kernels on each rank's local heads.
* ``resnet`` -- ResNet-18 with the CIFAR stem on
  ``CIFARSynthetic``, softmax cross-entropy and accuracy.
* ``domain-unet`` -- ``examples/07``: the U-Net (default 32 x 64, base
  16, 3 channels) over latitude bands. One process runs ``--spatial``
  bands (default 4) through the in-process halo transport on its
  device; a multi-process launch takes a ``{"data": d, "spatial": s}``
  mesh (``--spatial s``, d the rest), the process-group transport over
  ``spatial``, the BatchNorm moments summed over the whole world and
  FSDP2 over data x spatial. The latitude count must divide by
  ``spatial * 4`` (two pool levels of whole windows per band).

The JAX Trainer's contract holds: ``model_state`` carries the BatchNorm
running stats from update to update (and into checkpoints), the
evaluation pass (``--eval-steps``) normalises with the stored stats, and
throughput is counted in samples. Gradient-sync modes, pipeline and
sequence parallelism are refused for these workloads.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import torch

VISION_WORKLOADS = ("unet", "vit", "resnet", "domain-unet")
LEARNING_RATE, SEED = 1e-3, 0  # bench_unet's lr; data and init seed 0


@dataclasses.dataclass(frozen=True)
class VisionArgs:
    """A vision workload and its size; None takes the workload's own
    default (the bench row's or the example's)."""

    workload: str
    batch: Optional[int] = None       # per data rank
    grad_accum_steps: int = 1
    attn: str = "flash"
    lat: Optional[int] = None
    lon: Optional[int] = None
    channels: Optional[int] = None
    base_features: Optional[int] = None
    spatial: Optional[int] = None
    embed_dim: Optional[int] = None
    depth: Optional[int] = None
    n_heads: Optional[int] = None
    eval_steps: int = 0

    def default(self, name: str, value):
        got = getattr(self, name)
        return value if got is None else got


DEFAULT_BATCH = {"unet": 8, "vit": 32, "resnet": 32, "domain-unet": 32}
GRIDS = {"unet": (181, 360, 20), "vit": (64, 128, 20),
         "domain-unet": (32, 64, 3)}


METRICS = {"unet": "unet_dp_train_throughput",
           "vit": "vit_train_samples_per_s",
           "resnet": "resnet18_train_samples_per_s",
           "domain-unet": "domain_unet_train_samples_per_s"}


def check_domain_grid(lat: int, spatial: int) -> None:
    """``examples/07``'s refusal: whole pool windows in every band."""
    if lat % (spatial * 4):
        raise ValueError(
            f"lat({lat}) % (spatial*4) == 0 is needed: {spatial} latitude "
            "bands of whole 2x2 pool windows over two pool levels")


def _dataset(args: VisionArgs, device=None):
    """The workload's stream, drawn on ``device`` when it is a card (as
    the JAX bench draws on the device), else on the CPU."""
    from tpu_hpc_torch.models import datasets

    where = str(device) if device is not None and torch.device(
        device).type == "cuda" else None
    if args.workload == "resnet":
        return datasets.CIFARSynthetic(seed=SEED, device=where)
    lat, lon, ch = GRIDS[args.workload]
    return datasets.ERA5Synthetic(
        lat=args.default("lat", lat), lon=args.default("lon", lon),
        n_vars=args.default("channels", ch), n_levels=1, seed=SEED,
        device=where)


def build_model(args: VisionArgs, ds, device, ring=None, all_sum=None):
    """``(forward, eval_forward, params, model_state, model_cfg)`` of the
    workload, from a seeded init on ``device``."""
    from tpu_hpc_torch.models import resnet, unet, vit
    from tpu_hpc_torch.parallel import domain_unet

    gen = torch.Generator(device=device).manual_seed(SEED)
    dt, pd = torch.bfloat16, torch.float32
    if args.workload in ("unet", "domain-unet"):
        c = ds.channels
        cfg = unet.UNetConfig(
            in_channels=c, out_channels=c,
            base_features=args.default(
                "base_features", 64 if args.workload == "unet" else 16),
            dtype=dt, param_dtype=pd)
        params, state = unet.init_unet(gen, cfg, device)
        if args.workload == "unet":
            forward = unet.make_forward(cfg, all_sum)
        else:
            forward = domain_unet.make_forward(ring, cfg, all_sum)
        return forward, unet.make_eval_forward(cfg), params, state, cfg
    if args.workload == "vit":
        lat, lon, c = ds.lat, ds.lon, ds.channels
        cfg = vit.ViTConfig(
            in_channels=c, out_channels=c,
            patch_size=4, lat=lat, lon=lon,
            embed_dim=args.default("embed_dim", 256),
            depth=args.default("depth", 6),
            n_heads=args.default("n_heads", 8), dtype=dt, param_dtype=pd)
        attn = vit.flash_attn_fn(
            "auto" if args.attn == "flash" else "reference")
        forward = vit.make_forward(cfg, attn)

        def eval_forward(p, ms, batch):
            loss, _, aux = forward(p, ms, batch, None)
            return loss, aux

        return forward, eval_forward, vit.init_vit(gen, cfg, device), {}, cfg
    if args.workload == "resnet":
        cfg = resnet.ResNetConfig(depth=18, num_classes=10,
                                  cifar_stem=True, dtype=dt, param_dtype=pd)
        params, state = resnet.init_resnet(gen, cfg, device,
                                           in_channels=ds.channels)
        return (resnet.make_forward(cfg, all_sum),
                resnet.make_eval_forward(cfg), params, state, cfg)
    raise ValueError(f"unknown vision workload {args.workload!r}; one of "
                     f"{VISION_WORKLOADS}")


def build_vision_trainer(args: VisionArgs, *, steps: int = 20,
                         epochs: int = 2, device="cuda", mesh=None,
                         metrics_path: str = ""):
    """The workload's ``(Trainer, dataset)``. ``mesh``: None (one device;
    ``domain-unet`` then runs its bands in process), or a ``DeviceMesh``
    over the process group -- ``{"data": n}`` (unet, vit, resnet) or
    ``{"data": d, "spatial": s}`` (domain-unet) or ``{"data": d,
    "model": m}`` (vit: tensor parallel by ``tp.vit_rules``, m dividing
    the heads); ``unet`` needs one (a one-rank world on one process)."""
    from tpu_hpc_torch.config import TrainingConfig
    from tpu_hpc_torch.models.resnet import group_sum
    from tpu_hpc_torch.parallel import domain, dp
    from tpu_hpc_torch.parallel.plans import P
    from tpu_hpc_torch.runtime import resolve_device
    from tpu_hpc_torch.runtime.mesh import mesh_axis_size
    from tpu_hpc_torch.train.trainer import Trainer

    if args.workload not in VISION_WORKLOADS:
        raise ValueError(f"unknown vision workload {args.workload!r}; one "
                         f"of {VISION_WORKLOADS}")
    if args.attn not in ("flash", "reference"):
        raise ValueError(f"unknown attn {args.attn!r} (flash|reference)")
    device = resolve_device(device)
    names = tuple(mesh.mesh_dim_names) if mesh is not None else ()
    if args.workload == "unet" and mesh is None:
        raise ValueError(
            "the unet workload is data parallel with synced BatchNorm: it "
            "trains over a process group's {'data': n} mesh (one rank on "
            "one card), never unsynced")
    extra = {"domain-unet": "spatial", "vit": "model"}.get(args.workload)
    if any(a not in ("data", extra) for a in names):
        raise ValueError(
            f"the {args.workload} workload trains over a data axis"
            + (f" and a {extra} one" if extra else "")
            + f" only, not the mesh {names}")
    ds = _dataset(args, device)
    ring, all_sum, batch_pspec = None, None, P("data")
    data = mesh_axis_size(mesh, "data")
    if args.workload == "domain-unet":
        if mesh is None:
            ring = domain.InProcessHalo(args.default("spatial", 4))
        else:
            ring = domain.ProcessGroupHalo(mesh["spatial"].get_group()
                                           if "spatial" in names else None)
            all_sum = group_sum(None)
            batch_pspec = P("data", "spatial")
        check_domain_grid(ds.lat, ring.n)
    elif mesh is not None:
        all_sum = group_sum(mesh["data"].get_group())
    forward, eval_forward, params, state, model_cfg = build_model(
        args, ds, device, ring, all_sum)
    specs = dp.param_pspecs(params)
    if mesh_axis_size(mesh, "model") > 1:
        from tpu_hpc_torch.parallel import tp

        tp.validate_tp_degree(model_cfg.n_heads, model_cfg.n_heads,
                              mesh_axis_size(mesh, "model"))
        specs = tp.param_pspecs(params, tp.vit_rules())
    batch = args.default("batch", DEFAULT_BATCH[args.workload])
    cfg = TrainingConfig(
        epochs=epochs, steps_per_epoch=steps, global_batch_size=batch * data,
        learning_rate=LEARNING_RATE, grad_accum_steps=args.grad_accum_steps,
        seed=SEED, metrics_path=metrics_path)
    trainer = Trainer(cfg, mesh, forward, params, state, param_pspecs=specs,
                      batch_pspec=batch_pspec, eval_forward=eval_forward,
                      device=device)
    trainer.model_cfg, trainer.ring = model_cfg, ring
    return trainer, ds


def run_vision(args: VisionArgs, *, steps: int = 20, epochs: int = 2,
               device="cuda", mesh=None, metrics_path: str = "") -> Dict:
    """Train the workload for ``epochs`` x ``steps`` updates and return
    the summary the CLI prints: samples/s (the job's, per device), the
    update time, every loss, the flash kernels' launches (the ViT's),
    the evaluation pass on the stored stats, peak memory."""
    from tpu_hpc_torch.kernels import attention
    from tpu_hpc_torch.parallel.shard import layout_summary
    from tpu_hpc_torch.runtime.mesh import mesh_shape
    from tpu_hpc_torch.train.trainer import tree_leaves

    trainer, ds = build_vision_trainer(args, steps=steps, epochs=epochs,
                                       device=device, mesh=mesh,
                                       metrics_path=metrics_path)
    device = trainer.device
    world = trainer.n_devices
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
    launches0 = attention.kernel_launches()
    result = trainer.fit(ds)
    launches = {k: v - launches0[k]
                for k, v in attention.kernel_launches().items()}
    losses = [x for e in result["epochs"] for x in e["losses"]]
    summary = result["epochs"][-1]
    out: Dict[str, Any] = {
        "metric": METRICS[args.workload],
        "value": summary["items_per_s"],
        "unit": "samples/s",
        "workload": args.workload,
        "device": {
            "type": device.type,
            "name": (torch.cuda.get_device_name(device)
                     if device.type == "cuda" else "cpu"),
            "count": world,
        },
        "mesh": mesh_shape(trainer.mesh) or None,
        "world_size": world,
        "spatial": trainer.ring.n if trainer.ring is not None else None,
        "layout": layout_summary(trainer.module),
        "samples_per_s": summary["items_per_s"],
        "samples_per_s_per_device": summary["items_per_s"] / world,
        "update_s": summary["total_s"] / len(summary["losses"]),
        "final_loss": result["final_loss"],
        "losses": losses,
        "updates": len(losses),
        "global_batch": trainer.cfg.global_batch_size,
        "grad_accum_steps": trainer.cfg.grad_accum_steps,
        "sample_shape": list(ds.sample_shape),
        "n_params": sum(t.numel() for t in tree_leaves(
            trainer.state.params)),
        "model": {k: (str(v).replace("torch.", "")
                      if isinstance(v, torch.dtype) else v)
                  for k, v in dataclasses.asdict(trainer.model_cfg).items()},
        "attn": args.attn if args.workload == "vit" else None,
        "kernel_launches": launches,
        "batch_stats": bool(trainer.state.model_state),
    }
    if args.eval_steps:
        out["eval"] = trainer.evaluate(ds, args.eval_steps)
    if device.type == "cuda":
        out["peak_memory_bytes"] = torch.cuda.max_memory_allocated(device)
    return out


__all__ = ["VISION_WORKLOADS", "VisionArgs", "build_model",
           "build_vision_trainer", "check_domain_grid", "METRICS",
           "run_vision"]
