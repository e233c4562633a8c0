"""tpu_hpc_torch.reshard -- memory-bounded cross-topology resharding.

Port of the JAX package's ``reshard/`` (arXiv:2112.01075): plan any
source -> target layout move -- across meshes of different shapes, or
between two serving tiers -- as an introspectable chain of bounded
steps, then execute it with buffers cached on the plan.

  plan.py     the planner: meshes and shardings of ranks or torch
              devices, the exact wire-byte model, the step taxonomy,
              the chunked decomposition under ``max_inflight_bytes``.
  execute.py  the executor: in process (copies onto a device) and
              across ranks (batched P2P over the plan's boxes); the
              ``reshard`` span, the gauges, ``reshard_plan`` events.
  elastic.py  the checkpoint topology history the elastic coordinator
              appends to. Restoring onto another mesh stays
              ``ckpt/checkpoint.py``'s (DCP reshards at load).

Consumers: serve/weights.py (params onto the serving device),
serve/disagg.py (prefill-tier KV pages -> decode tier),
elastic/coordinator.py (live state onto a new mesh) and the comm
bench's reshard rows.
"""
from tpu_hpc_torch.reshard.elastic import (  # noqa: F401
    append_topology_history,
    read_topology_history,
)
from tpu_hpc_torch.reshard.execute import apply, execute_plan  # noqa: F401
from tpu_hpc_torch.reshard.plan import (  # noqa: F401
    ChunkPlan,
    Mesh,
    ReshardPlan,
    ReshardStep,
    Sharding,
    TensorSpec,
    modeled_wire_bytes,
    plan_reshard,
)

__all__ = [
    "ChunkPlan",
    "ReshardPlan",
    "ReshardStep",
    "apply",
    "execute_plan",
    "modeled_wire_bytes",
    "plan_reshard",
    "Mesh",
    "Sharding",
    "TensorSpec",
    "append_topology_history",
    "read_topology_history",
]
