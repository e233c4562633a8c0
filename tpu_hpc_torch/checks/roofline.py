"""Per-card peak rates: the one table every MFU and bound divides by.

Port of the chip-spec half of the JAX package's ``checks/roofline.py``
(``ChipSpec`` / ``CHIPS`` / the device-kind prefix table, a lookup
by name and one by device), keyed on
``torch.cuda.get_device_name`` instead of a TPU ``device_kind``. The
training MFU (``train/__main__.py``), the serving MFU
(``serve/server.py``) and the kernel bounds of ``chip_smoke.py`` all
read it, so they cannot disagree. The step-time estimator itself
(compute / memory / comm bounds of a sharded Llama step) comes with the
distributed slice (ROADMAP).

Rows: NVIDIA's H100 data sheet, dense rates (no sparsity), at the
card's full power limit (700 W SXM, 350 W PCIe). A card set below its
limit runs slower under load; ``nvidia-smi`` reports the limit, and
every measured number the repo keeps carries it.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch


@dataclasses.dataclass(frozen=True)
class ChipSpec:
    """Published per-card numbers. ``peak_fp32_flops`` is the rate
    outside the tensor cores (plain fp32 FMAs)."""

    name: str
    peak_bf16_flops: float
    peak_fp32_flops: float
    hbm_gbps: float

    @property
    def hbm_bytes_per_s(self) -> float:
        return self.hbm_gbps * 1e9

    def peak_flops(self, dtype: torch.dtype) -> float:
        """Peak FLOP/s for operands of ``dtype`` (bf16 and fp16 share
        the tensor-core rate; fp32 runs outside the tensor cores)."""
        if dtype in (torch.bfloat16, torch.float16):
            return self.peak_bf16_flops
        if dtype == torch.float32:
            return self.peak_fp32_flops
        raise ValueError(f"no peak rate for {dtype}")


CHIPS: Dict[str, ChipSpec] = {
    "h100-sxm": ChipSpec("h100-sxm", 989e12, 67e12, 3350),
    "h100-pcie": ChipSpec("h100-pcie", 756e12, 51e12, 2000),
}

# torch.cuda.get_device_name spellings -> CHIPS key, longest prefix
# first. The SXM part names itself by its memory ("NVIDIA H100 80GB
# HBM3"); an H100 this table does not know (NVL, H100 on other memory)
# resolves to nothing rather than to a neighbour's rates.
_DEVICE_KIND_PREFIXES = (
    ("NVIDIA H100 PCIe", "h100-pcie"),
    ("NVIDIA H100 80GB HBM3", "h100-sxm"),
    ("NVIDIA H100 SXM", "h100-sxm"),
)


def chip_for_kind(kind: str) -> Optional[ChipSpec]:
    """The ``ChipSpec`` of a device name (``torch.cuda.get_device_name``),
    by longest-prefix match; None for cards the table does not know."""
    for prefix, key in _DEVICE_KIND_PREFIXES:
        if kind.startswith(prefix):
            return CHIPS[key]
    return None


def peak_flops_for_device(device: torch.device) -> Optional[float]:
    """Peak dense bf16 FLOP/s of a torch device; None for the CPU and for
    cards the table does not know (an MFU against a guessed peak would
    be noise, so callers report none)."""
    device = torch.device(device)
    if device.type != "cuda":
        return None
    chip = chip_for_kind(torch.cuda.get_device_name(device))
    return chip.peak_bf16_flops if chip is not None else None
