"""Data parallelism (the DDP recipe) as a plan.

Port of the JAX package's ``parallel/dp.py``: every parameter
replicated across ``data``, the batch sharded on it. In the port the
data axis is FSDP2's or plain replication; the batch rows a data rank
takes are the trainer's (``Trainer`` slices the global batch).
"""
from __future__ import annotations

from tpu_hpc_torch.parallel.plans import P, pspec_tree


def param_pspecs(params, axis: str = "data"):
    """All parameters replicated (DDP keeps a full copy per device)."""
    del axis
    return pspec_tree(params, rules=[], default=P())


def batch_pspec(axis: str = "data") -> P:
    """Batch dim sharded over the data axis (the DistributedSampler
    equivalent)."""
    return P(axis)
