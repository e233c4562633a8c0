"""Device and job introspection.

Port of the JAX package's ``runtime/topology.py``: the per-card
properties the reference prints at startup (name, memory, SM count,
compute capability) and a job-level report (torch, CUDA and NCCL
versions, rank and world size, the cards this process sees).
"""
from __future__ import annotations

from typing import Any, Dict, List

import torch


def device_summary() -> List[Dict[str, Any]]:
    """One record per CUDA device this process sees (none on a machine
    without a card)."""
    out = []
    if not torch.cuda.is_available():
        return out
    for i in range(torch.cuda.device_count()):
        props = torch.cuda.get_device_properties(i)
        free, total = torch.cuda.mem_get_info(i)
        out.append({
            "id": i,
            "platform": "gpu",
            "device_kind": props.name,
            "total_memory": props.total_memory,
            "bytes_in_use": total - free,
            "sm_count": props.multi_processor_count,
            "capability": f"{props.major}.{props.minor}",
        })
    return out


def topology_report() -> Dict[str, Any]:
    """Job-level topology: versions, this process's rank, and its
    devices."""
    import torch.distributed as dist

    up = dist.is_available() and dist.is_initialized()
    nccl = None
    if torch.cuda.is_available():
        version = torch.cuda.nccl.version()
        nccl = ".".join(map(str, version)) if isinstance(version, tuple) \
            else str(version)
    return {
        "torch_version": torch.__version__,
        "cuda_version": torch.version.cuda,
        "nccl_version": nccl,
        "backend": dist.get_backend() if up else None,
        "process_index": dist.get_rank() if up else 0,
        "process_count": dist.get_world_size() if up else 1,
        "local_device_count": (torch.cuda.device_count()
                               if torch.cuda.is_available() else 0),
        "devices": device_summary(),
    }
