"""Target-layout choice for a topology morph.

Port of the JAX package's ``elastic/layout.py``. Given the ranks that
will survive (or the expanded set a returning slice provides), pick the
cheapest LEGAL mesh layout to morph onto, from two costs measured
elsewhere in the tree:

* the transition: the reshard engine's exact wire-byte model
  (:func:`tpu_hpc_torch.reshard.plan.modeled_wire_bytes`) over the live
  state's shardings, priced by the planner's tier model;
* the steady state after it: the collective planner's grad-sync cost
  (measured table when one exists for the fingerprint, alpha-beta
  otherwise) plus a data-parallel compute term.

``preserve_data_extent`` (default on): the loss stream is bit-identical
across a morph ONLY when the data axis keeps its extent -- the batch
reductions reassociate otherwise. So a shrink from ``{data: 2,
replica: 2}`` on 4 ranks goes to ``{data: 2}`` on 2: surplus ranks ride
a pure ``replica`` axis (each replica group sees the same rows) and the
arithmetic per step is unchanged. A device set the extent no longer
divides falls back to the cheapest legal extent, and the decision
records that continuity was given up. Devices here are ranks of the
process group; every decision equals JAX's for the same device count,
batch and table.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence

# Normalization constants for the steady-state score: only the ordering
# of candidates matters; the horizon says how many future steps a
# transition cost amortizes over.
STEP_ITEM_COST_S = 1e-6
HORIZON_STEPS = 1000


@dataclasses.dataclass(frozen=True)
class LayoutDecision:
    """The chosen layout plus the evidence for the choice (rides the
    ``topology_morph`` event's ``plan`` field)."""

    axes: Dict[str, int]
    n_devices: int
    data_extent: int
    preserved_data_extent: bool
    transition_wire_bytes: int
    predicted_transition_s: float
    predicted_step_s: float
    source: str
    fingerprint: str
    candidates: List[dict]

    def summary(self) -> dict:
        return {
            "axes": dict(self.axes),
            "n_devices": self.n_devices,
            "data_extent": self.data_extent,
            "preserved_data_extent": self.preserved_data_extent,
            "transition_wire_bytes": self.transition_wire_bytes,
            "predicted_transition_s": round(self.predicted_transition_s, 6),
            "predicted_step_s": round(self.predicted_step_s, 6),
            "source": self.source,
            "fingerprint": self.fingerprint,
            "candidates": self.candidates,
        }


def _axes_for(data: int, replica: int) -> Dict[str, int]:
    """Mesh axes for a (data, replica) factorization. A pure-data layout
    stays one-axis, mesh-identical to what a fixed-topology run on that
    device count builds -- the parity pin compares against exactly
    that."""
    if replica == 1:
        return {"data": data}
    return {"data": data, "replica": replica}


def legal_extents(n_devices: int, global_batch: int) -> List[int]:
    """Data-axis extents legal on ``n_devices``: divisors of the device
    count that also divide the global batch."""
    return [
        d for d in range(1, n_devices + 1)
        if n_devices % d == 0 and global_batch % d == 0
    ]


def _transition_wire_bytes(state: Any, mesh) -> int:
    """Modeled wire bytes to land ``state`` replicated on ``mesh`` (a
    reshard ``Mesh``): the reshard engine's per-device model, summed
    over leaves. Leaves without a sharding (host scalars) are skipped,
    negligible either way."""
    from tpu_hpc_torch.parallel.plans import P
    from tpu_hpc_torch.reshard.plan import (
        Sharding,
        _leaf_shape_dtype,
        itemsize_of,
        leaf_sharding,
        modeled_wire_bytes,
        tree_flatten_with_path,
    )

    tgt = Sharding(mesh, P())
    wire = 0
    for _, leaf in tree_flatten_with_path(state)[0]:
        src = leaf_sharding(leaf)
        shape, dtype = _leaf_shape_dtype(leaf)
        if src is None or not shape:
            continue
        wire += modeled_wire_bytes(shape, itemsize_of(dtype), src, tgt)
    return wire


def _payload_bytes(state: Any) -> int:
    from tpu_hpc_torch.reshard.plan import (
        _leaf_shape_dtype,
        itemsize_of,
        tree_flatten_with_path,
    )

    params = state.get("params") if isinstance(state, dict) \
        else getattr(state, "params", None)
    if params is None:
        return 0
    total = 0
    for _, leaf in tree_flatten_with_path(params)[0]:
        shape, dtype = _leaf_shape_dtype(leaf)
        n = 1
        for s in shape:
            n *= s
        total += n * itemsize_of(dtype)
    return total


def choose_layout(
    devices: Sequence[Any],
    *,
    global_batch: int,
    state: Any = None,
    grad_payload_bytes: Optional[int] = None,
    current_data_extent: Optional[int] = None,
    preserve_data_extent: bool = True,
    table_dir: Optional[str] = None,
    device_type: Optional[str] = None,
) -> LayoutDecision:
    """The cheapest legal layout for ``devices`` (ranks).

    ``state``: the live state tree (its shardings feed the transition
    wire-byte model; None skips the transition term). ``grad_payload_
    bytes``: per-step gradient bytes for the planner's steady-state term
    (default: the state's param bytes). ``current_data_extent`` +
    ``preserve_data_extent`` pin the data axis when the new device count
    allows it. ``device_type`` names the planner's fabric (default: cuda
    when a card is visible).
    """
    from tpu_hpc_torch.comm.planner import Planner, tier_cost
    from tpu_hpc_torch.reshard.plan import Mesh

    n = len(devices)
    if n < 1:
        raise ValueError("choose_layout needs a non-empty device set")
    extents = legal_extents(n, global_batch)
    if not extents:
        raise ValueError(
            f"no legal data extent: {n} devices, global batch "
            f"{global_batch} -- no divisor of the device count "
            "divides the batch"
        )
    preserved = False
    if (
        preserve_data_extent
        and current_data_extent is not None
        and current_data_extent in extents
    ):
        extents = [current_data_extent]
        preserved = True
    planner = Planner.for_devices(n_devices=n, table_dir=table_dir,
                                  device_type=device_type)
    payload = grad_payload_bytes
    if payload is None:
        payload = _payload_bytes(state) if state is not None else 0
    tier = "dcn" if planner.fingerprint.n_slices > 1 else "ici"
    scored = []
    for d in extents:
        r = n // d
        axes = _axes_for(d, r)
        wire = 0
        if state is not None:
            wire = _transition_wire_bytes(
                state, Mesh.of_ranks(dict(axes), list(devices)))
        transition_s = tier_cost(tier, wire) if wire else 0.0
        comm_s, source = (0.0, "model")
        if payload:
            comm_s, source = planner.cost("all_reduce", payload)
        compute_s = STEP_ITEM_COST_S * global_batch / d
        step_s = compute_s + comm_s
        scored.append({
            "axes": axes,
            "data": d,
            "replica": r,
            "transition_wire_bytes": int(wire),
            "predicted_transition_s": round(transition_s, 6),
            "predicted_step_s": round(step_s, 6),
            "score": transition_s + HORIZON_STEPS * step_s,
            "source": source,
        })
    scored.sort(key=lambda c: (c["score"], -c["data"]))
    best = scored[0]
    return LayoutDecision(
        axes=best["axes"],
        n_devices=n,
        data_extent=best["data"],
        preserved_data_extent=preserved,
        transition_wire_bytes=best["transition_wire_bytes"],
        predicted_transition_s=best["predicted_transition_s"],
        predicted_step_s=best["predicted_step_s"],
        source=best["source"],
        fingerprint=planner.fingerprint.digest,
        candidates=[
            {k: v for k, v in c.items() if k != "score"} for c in scored
        ],
    )
