"""tpu_hpc_torch.elastic -- topology-morphing coordinator.

Port of the JAX package's ``tpu_hpc.elastic``: grow/shrink a training
run's rank set mid-run with no process restart -- quiesce at a step
boundary, reshard the live state onto the cheapest legal layout for the
new rank set, resume. See :mod:`tpu_hpc_torch.elastic.coordinator` for
the transition (and what "no restart" means with one process per card)
and :mod:`tpu_hpc_torch.elastic.layout` for the layout policy.
"""
from tpu_hpc_torch.elastic.coordinator import TopologyCoordinator
from tpu_hpc_torch.elastic.layout import (
    LayoutDecision,
    choose_layout,
    legal_extents,
)

__all__ = [
    "TopologyCoordinator",
    "LayoutDecision",
    "choose_layout",
    "legal_extents",
]
