"""tpu_hpc_torch.runtime: the device, the process group and the mesh.

``resolve_device`` (one explicit ``torch.device``), ``init_distributed``
and the launcher cascade (``distributed.py``), ``MeshSpec`` /
``build_mesh`` (a named ``DeviceMesh``, ``mesh.py``; two tiers through
``two_tier_spec`` / ``build_hybrid_mesh`` over ``node_groups``),
``topology_report`` (``topology.py``) and the NCCL / CUDA knob presets
(``tuning.py``, imported on its own: it must run before CUDA does)."""
from tpu_hpc_torch.runtime.device import resolve_device  # noqa: F401
from tpu_hpc_torch.runtime.distributed import (  # noqa: F401
    HostInfo,
    cleanup_distributed,
    get_host_info,
    init_distributed,
    is_main_host,
    print_host0,
)
from tpu_hpc_torch.runtime.mesh import (  # noqa: F401
    MeshSpec,
    build_hybrid_mesh,
    build_mesh,
    node_groups,
    two_tier_spec,
)

__all__ = [
    "HostInfo",
    "MeshSpec",
    "build_hybrid_mesh",
    "build_mesh",
    "cleanup_distributed",
    "get_host_info",
    "init_distributed",
    "is_main_host",
    "node_groups",
    "print_host0",
    "resolve_device",
    "two_tier_spec",
]
