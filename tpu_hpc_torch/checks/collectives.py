"""Collective-op counting in a profiled region.

The counterpart of the JAX package's ``checks/hlo.py``. There the
collectives of a program are read from its lowered or compiled HLO
text; a PyTorch program has no such text, so here they are read from
what ``torch.profiler`` recorded while the program ran: a
``torch.profiler.profile`` that has run, a Chrome trace it exported, or
those events already loaded (``obs.trace.load_chrome_events`` is the
one reader). The counts keep the JAX names (``COLLECTIVE_OPS``), so a
test written against the reference's comm signature reads the same
keys.

Spellings: a collective shows up at three levels, and each level is
counted on its own so nothing is counted twice --

* the op a program called: ``c10d::allreduce_``, ``c10d::_allgather_base_``
  (``all_gather_into_tensor``), ``_c10d_functional::reduce_scatter_tensor``
  (DTensor / functional collectives), ...;
* the backend's record of what it ran: ``nccl:all_reduce``,
  ``gloo:all_gather``, ... (gloo implements ``reduce_scatter_tensor`` as
  an all-reduce, so this level can differ from the first);
* the card's kernels: ``ncclDevKernel_AllReduce_Sum_f32_RING_LL``, ...

:func:`collective_counts` reads the first level present (ops, else the
backend's records, else kernels). Point-to-point sends and receives
(``c10d::send`` / ``recv_``, ``nccl:send``, NCCL's ``SendRecv`` kernel)
are the ``collective-permute`` row, the JAX ``ppermute``'s lowering;
each send and each receive counts once.

Not ported: ``lowered_text`` / ``compiled_text`` (there is no lowered
or compiled program text to return) and the HLO / StableHLO parsers;
:func:`max_tensor_bytes` reads the largest allocation the profiler saw
(``profile_memory=True``) instead of the largest tensor in a program.
"""
from __future__ import annotations

import re
from typing import Dict, Iterable, List, Optional, Tuple, Union

from tpu_hpc_torch.obs.trace import load_chrome_events

# Canonical collective kinds, the JAX package's (HLO) names.
COLLECTIVE_OPS = (
    "all-gather",
    "all-reduce",
    "reduce-scatter",
    "collective-permute",
    "all-to-all",
)

# Level 1: the ops a program calls (c10d's dispatcher ops and the
# functional collectives), exact names.
_OP_SPELLINGS: Dict[str, str] = {
    "c10d::allreduce_": "all-reduce",
    "c10d::allreduce_coalesced_": "all-reduce",
    "_c10d_functional::all_reduce": "all-reduce",
    "_c10d_functional::all_reduce_": "all-reduce",
    "_c10d_functional::all_reduce_coalesced": "all-reduce",
    "_c10d_functional::all_reduce_coalesced_": "all-reduce",
    "c10d::allgather_": "all-gather",
    "c10d::_allgather_base_": "all-gather",
    "c10d::allgather_coalesced_": "all-gather",
    "c10d::allgather_into_tensor_coalesced_": "all-gather",
    "_c10d_functional::all_gather_into_tensor": "all-gather",
    "_c10d_functional::all_gather_into_tensor_out": "all-gather",
    "_c10d_functional::all_gather_into_tensor_coalesced": "all-gather",
    "c10d::reduce_scatter_": "reduce-scatter",
    "c10d::_reduce_scatter_base_": "reduce-scatter",
    "c10d::reduce_scatter_tensor_coalesced_": "reduce-scatter",
    "_c10d_functional::reduce_scatter_tensor": "reduce-scatter",
    "_c10d_functional::reduce_scatter_tensor_coalesced": "reduce-scatter",
    "c10d::alltoall_": "all-to-all",
    "c10d::alltoall_base_": "all-to-all",
    "_c10d_functional::all_to_all_single": "all-to-all",
    "c10d::send": "collective-permute",
    "c10d::recv_": "collective-permute",
    "c10d::recv_any_source_": "collective-permute",
}

# Level 2: the backend's own record of each collective it ran
# (``<backend>:<name>``, the same names in NCCL and gloo).
_BACKEND_NAMES: Dict[str, str] = {
    "all_reduce": "all-reduce",
    "allreduce_coalesced": "all-reduce",
    "all_gather": "all-gather",
    "_all_gather_base": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "reduce_scatter": "reduce-scatter",
    "_reduce_scatter_base": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all": "all-to-all",
    "send": "collective-permute",
    "recv": "collective-permute",
}
_BACKENDS = ("nccl", "gloo")

# Level 3: NCCL kernels on the card (ncclDevKernel_AllReduce_Sum_f32_...,
# the older ncclKernel_... spelling too).
_KERNEL = re.compile(
    r"^nccl(?:Dev)?Kernel_(AllReduce|AllGather|ReduceScatter|SendRecv)")
_KERNEL_KINDS = {
    "AllReduce": "all-reduce",
    "AllGather": "all-gather",
    "ReduceScatter": "reduce-scatter",
    "SendRecv": "collective-permute",
}

Source = Union[str, dict, Iterable]


def spelling_kind(name: str) -> Optional[Tuple[int, str]]:
    """``(level, kind)`` of one event name (level 1 = op, 2 = backend
    record, 3 = kernel), or None when it is no collective."""
    if name in _OP_SPELLINGS:
        return 1, _OP_SPELLINGS[name]
    backend, sep, rest = name.partition(":")
    if sep and backend in _BACKENDS and rest in _BACKEND_NAMES:
        return 2, _BACKEND_NAMES[rest]
    m = _KERNEL.match(name)
    if m:
        return 3, _KERNEL_KINDS[m.group(1)]
    return None


def _events(source: Source) -> List[dict]:
    """Chrome-trace events of ``source`` in start order: a profile that
    has run, a trace path or dict, or an iterable of events (dicts with
    a ``name``, or bare names)."""
    if hasattr(source, "export_chrome_trace") or isinstance(
            source, (str, dict)) or hasattr(source, "__fspath__"):
        return load_chrome_events(source)
    return [e if isinstance(e, dict) else {"name": str(e)} for e in source]


def _collectives(source: Source) -> List[Tuple[int, str, dict]]:
    found = []
    for e in _events(source):
        hit = spelling_kind(e.get("name", ""))
        if hit is not None:
            found.append((hit[0], hit[1], e))
    if not found:
        return []
    level = min(lvl for lvl, _, _ in found)
    return [(lvl, kind, e) for lvl, kind, e in found if lvl == level]


def collective_counts(source: Source) -> Dict[str, int]:
    """Per-kind collective counts of a profiled region (see the module
    docstring for the spellings and which level is counted). Every kind
    of ``COLLECTIVE_OPS`` is a key, 0 when absent."""
    counts = dict.fromkeys(COLLECTIVE_OPS, 0)
    for _, kind, _ in _collectives(source):
        counts[kind] += 1
    return counts


def collective_group_shapes(source: Source, op: str,
                            group=None) -> List[Tuple[int, int]]:
    """(n_groups, group_size) of each ``op`` occurrence, in program
    order -- the JAX function's axis-structure fingerprint. The size is
    the event's own (NCCL records ``Group size`` in its events' args)
    or else that of the process group it ran on, ``group`` (default the
    world); n_groups is the world over that size, at least 1 (the
    groups of one mesh axis tile the world)."""
    import torch.distributed as dist

    if op not in COLLECTIVE_OPS:
        raise ValueError(f"unknown collective {op!r}; one of {COLLECTIVE_OPS}")
    world = dist.get_world_size() if dist.is_initialized() else 1
    default = dist.get_world_size(group) if dist.is_initialized() else 1
    shapes = []
    for _, kind, e in _collectives(source):
        if kind != op:
            continue
        size = int((e.get("args") or {}).get("Group size") or default)
        shapes.append((max(world // size, 1), size))
    return shapes


def max_tensor_bytes(source: Source) -> int:
    """The largest single allocation in a profiled region, in bytes:
    the peak single buffer the region demanded on one device (the
    JAX function's reading of a per-device program). Needs a profile
    taken with ``profile_memory=True``; a trace with no allocation
    events raises, so a bound check cannot pass vacuously."""
    sizes = [int((e.get("args") or {}).get("Bytes") or 0)
             for e in _events(source) if e.get("name") == "[memory]"]
    if not sizes:
        raise ValueError(
            "no allocation events in the trace: profile with "
            "torch.profiler.profile(profile_memory=True)")
    return max(sizes)
