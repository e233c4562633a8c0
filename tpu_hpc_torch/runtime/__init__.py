"""tpu_hpc_torch.runtime: device resolution. The JAX package's mesh,
topology and multi-process bring-up are later slices (ROADMAP)."""
from tpu_hpc_torch.runtime.device import resolve_device  # noqa: F401

__all__ = ["resolve_device"]
