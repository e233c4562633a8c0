"""Where the port runs: one explicit ``torch.device``.

The JAX package builds a device mesh (``runtime/mesh.py``); this slice
serves on one card, so its counterpart is a single device. Entry
points default to ``cuda``; tests and CPU runs pass ``"cpu"``
explicitly. Asking for a card on a machine without one is an error,
never a silent CPU run: a number measured on the CPU must not be
reported as the card's.
"""
from __future__ import annotations

from typing import Union

import torch


def resolve_device(name: Union[str, torch.device] = "cuda") -> torch.device:
    """``name`` -> ``torch.device``. Raises ``RuntimeError`` when a
    CUDA device is asked for and ``torch.cuda.is_available()`` is
    false."""
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(device)!r} requested but no CUDA device is "
            "available (pass device='cpu' / --device cpu to run on the "
            "CPU)"
        )
    if device.type not in ("cuda", "cpu"):
        raise ValueError(
            f"unsupported device {str(device)!r} (one of 'cuda', 'cpu')"
        )
    return device
