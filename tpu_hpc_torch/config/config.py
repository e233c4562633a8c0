"""Unified training configuration: dataclass + YAML + CLI.

Port of the JAX package's ``config/config.py``: the same
``TrainingConfig`` fields, defaults and validation, so one YAML file
configures either package. The knobs whose machinery is not ported yet
(profiling, anomaly capture) keep their fields; the port's ``Trainer``
raises ``NotImplementedError`` when one is set away from its default,
naming the ROADMAP item that ports it.

``torch_dtypes`` replaces the JAX ``jax_dtypes``; ``mesh_axes`` and
``mesh_spec`` give ``runtime.build_mesh`` its axes.
"""
from __future__ import annotations

import argparse
import dataclasses
from typing import Any, Optional, Sequence


@dataclasses.dataclass
class TrainingConfig:
    # Optimization.
    epochs: int = 5
    global_batch_size: int = 32
    learning_rate: float = 1e-3
    weight_decay: float = 0.0
    momentum: float = 0.9
    seed: int = 42
    steps_per_epoch: int = 50
    # Microbatches per optimizer update: the global batch is split into
    # this many sequential forward/backward passes whose gradients are
    # averaged -- the same optimizer trajectory at 1/N the activation
    # memory. 1 = off.
    grad_accum_steps: int = 1
    # "constant" or "cosine" (warmup -> cosine decay over the whole
    # run); warmup_steps applies to both.
    lr_schedule: str = "constant"
    warmup_steps: int = 0
    # Global gradient-norm clip before the optimizer update, applied to
    # the full accumulated gradient. 0 = off.
    max_grad_norm: float = 0.0
    # AdamW moment dtype: "float32" or "bfloat16" (both moments stored
    # in bf16, the update math in fp32). Master params stay fp32.
    adam_moments_dtype: str = "float32"

    # Precision.
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"

    # Mesh (runtime.build_mesh(cfg.mesh_spec())).
    data_parallel: int = -1  # -1 = all remaining devices
    model_parallel: int = 1
    seq_parallel: int = 1
    pipe_parallel: int = 1
    dcn_data_parallel: int = 1

    # Checkpointing (a checkpoint manager saves every save_every epochs
    # into checkpoint_dir; resume restores its newest readable step).
    save_every: int = 0  # epochs; 0 = off
    checkpoint_dir: str = "checkpoints"
    resume: bool = True
    reshard_max_inflight_mb: int = 0

    # Numeric-health guard: "off", "skip", "rollback".
    guard_mode: str = "off"
    guard_spike_factor: float = 10.0
    guard_spike_action: str = "event"
    guard_window: int = 8

    # Profiling and anomaly capture (not ported yet).
    profile: bool = False
    profile_dir: str = "profiles"
    profile_start_step: int = 3
    profile_num_steps: int = 5
    capture_on_anomaly: bool = False
    capture_steps: int = 2

    # Gradient-sync strategy: "flat" (the plan's own collectives),
    # "bucketed_overlap" / "hierarchical" (replicated params, bucketed
    # all-reduces during the backward; comm.overlap) or "auto" (the
    # collective planner picks; comm.planner). comm_bucket_mb caps a
    # bucket (and the planner's bucket ladder under "auto").
    comm_mode: str = "flat"
    comm_bucket_mb: int = 25

    # Run metrics log: when set, one JSON line per epoch chunk plus a
    # run-start and a run-end record. "" = off.
    metrics_path: str = ""
    # Model FLOPs one training step spends per item (per token for
    # LLMs), stamped into the run_start record. 0 = unknown.
    model_flops_per_item: float = 0.0

    @classmethod
    def from_yaml(cls, path: str) -> "TrainingConfig":
        """Load from a YAML mapping; unknown keys rejected."""
        import yaml

        with open(path) as f:
            raw = yaml.safe_load(f) or {}
        fields = {f.name for f in dataclasses.fields(cls)}
        unknown = set(raw) - fields
        if unknown:
            raise ValueError(f"unknown config keys in {path}: {sorted(unknown)}")
        return cls(**raw)

    def to_yaml(self, path: str) -> str:
        """Write the effective config as YAML (round-trips through
        ``from_yaml``), atomically."""
        import os

        import yaml

        tmp = f"{path}.tmp"
        with open(tmp, "w") as f:
            yaml.safe_dump(dataclasses.asdict(self), f, sort_keys=False)
        os.replace(tmp, path)
        return path

    @classmethod
    def from_args(
        cls, argv: Optional[Sequence[str]] = None
    ) -> "TrainingConfig":
        """Build from CLI flags; tolerates extra flags via
        parse_known_args."""
        p = argparse.ArgumentParser(add_help=False)
        p.add_argument("--config", type=str, default=None, help="YAML config path")
        for f in dataclasses.fields(cls):
            flag = "--" + f.name.replace("_", "-")
            if f.type == "bool" or isinstance(f.default, bool):
                p.add_argument(
                    flag,
                    type=lambda s: s.lower() in ("1", "true", "yes"),
                    default=None,
                )
            else:
                p.add_argument(flag, type=type(f.default), default=None)
        ns, _ = p.parse_known_args(argv)
        base = cls.from_yaml(ns.config) if ns.config else cls()
        for f in dataclasses.fields(cls):
            v = getattr(ns, f.name, None)
            if v is not None:
                setattr(base, f.name, v)
        return base

    def torch_dtypes(self) -> "tuple[Any, Any]":
        """(param_dtype, compute_dtype) as torch dtypes: pass into a
        model config as ``SomeConfig(dtype=compute, param_dtype=param)``."""
        import torch

        allowed = {"float32", "bfloat16", "float16"}
        for name in (self.param_dtype, self.compute_dtype):
            if name not in allowed:
                raise ValueError(
                    f"unsupported dtype {name!r}; expected one of "
                    f"{sorted(allowed)}"
                )
        return getattr(torch, self.param_dtype), getattr(torch, self.compute_dtype)

    def mesh_axes(self) -> "dict[str, int]":
        """Ordered mesh axes, dropping degenerate (size-1) ones except
        data. Data first = the bandwidth-tolerant axis outermost."""
        axes: dict[str, int] = {}
        if self.pipe_parallel > 1:
            axes["pipe"] = self.pipe_parallel
        axes["data"] = self.data_parallel
        if self.seq_parallel > 1:
            axes["seq"] = self.seq_parallel
        if self.model_parallel > 1:
            axes["model"] = self.model_parallel
        return axes

    def mesh_spec(self) -> Any:
        """Full ``MeshSpec`` including the across-node extent of the
        data axis (``dcn_data_parallel``)."""
        from tpu_hpc_torch.runtime.mesh import MeshSpec

        if self.dcn_data_parallel < 1:
            raise ValueError(
                f"dcn_data_parallel must be >= 1, got "
                f"{self.dcn_data_parallel}"
            )
        dcn = (
            {"data": self.dcn_data_parallel}
            if self.dcn_data_parallel > 1
            else {}
        )
        return MeshSpec(axes=self.mesh_axes(), dcn_axes=dcn)
