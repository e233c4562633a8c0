"""The checkpoint topology history the elastic coordinator writes.

Port of the part of the JAX package's ``reshard/elastic.py`` that the
port's checkpoint manager lacks. Restoring a checkpoint onto another
mesh is ``ckpt/checkpoint.py``'s job and stays there:
``torch.distributed.checkpoint`` reshards at load time into whatever
layout the live state has, so the port keeps one restore path. What the
coordinator adds is the audit of in-place morphs: ``<dir>/.tpu_hpc_meta/
topology_history.json``, one entry per transition, so "what shape was
the run in at step N" is answerable after the fact without replaying
the event log.
"""
from __future__ import annotations

import json
import os
from typing import List, Optional

SIDECAR_DIR = ".tpu_hpc_meta"


def _history_path(directory: str) -> str:
    # Not ``<step>.json``-shaped, so the per-step sidecar scan never
    # mistakes it for a checkpoint record.
    return os.path.join(directory, SIDECAR_DIR, "topology_history.json")


def _rank() -> int:
    import torch.distributed as dist

    return dist.get_rank() if dist.is_initialized() else 0


def append_topology_history(
    directory: str, step: int, topology: Optional[dict],
    reason: str = "save",
) -> None:
    """Record that the run was on ``topology`` (``{"mesh": {axis:
    size}, "device_count": n}``) at ``step``; rank 0 only."""
    if _rank() != 0:
        return
    mesh = (topology or {}).get("mesh")
    entry = {
        "step": int(step),
        "mesh": dict(mesh) if mesh else None,
        "device_count": (topology or {}).get("device_count"),
        "reason": str(reason),
    }
    path = _history_path(directory)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    history = read_topology_history(directory)
    history.append(entry)
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(history, f)
    os.replace(tmp, path)


def read_topology_history(directory: str) -> List[dict]:
    """The topology-history entries, in append order (empty when none
    was written)."""
    try:
        with open(_history_path(directory)) as f:
            data = json.load(f)
        return list(data) if isinstance(data, list) else []
    except (OSError, ValueError):
        return []
