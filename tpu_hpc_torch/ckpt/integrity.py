"""Checkpoint content integrity: per-leaf checksums, verified on restore.

Port of the JAX package's ``ckpt/integrity.py``. A torn multi-file
write makes ``torch.distributed.checkpoint`` (DCP) throw on load, and
``restore_latest`` falls back to the next-older step. What nothing
catches without this module is corruption that still deserializes: a
bit flipped in a tensor payload restores garbage with no exception,
and the run trains on it.

The defense is content checksums computed from the IN-MEMORY state at
save time -- before any serialization -- and recomputed from the
RESTORED state at restore time -- after all deserialization:

* :func:`leaf_checksum` -- crc32 over a leaf's C-contiguous bytes.
  numpy has no bfloat16, so a bf16 leaf is hashed through a CPU copy
  viewed as ``int16``: the same bytes, so the checksum of a leaf equals
  the JAX package's ``leaf_checksum`` of the same array, exactly.
* :func:`leaf_checksums` / :func:`verify_tree` -- over a flat
  ``{path: tensor}`` state dict (``ckpt.checkpoint.state_dict``). A
  leaf restored into a DIFFERENT dtype is skipped (DCP casts into the
  template's dtype -- the legal fp32->bf16 moments switch must not read
  as corruption). By default they cover the leaves this process holds
  whole; with ``shards=True``, this process's local shard of each
  DTensor sharded over more than one rank (the manager keys those by
  rank, and compares them only on the mesh they were taken on).
* :class:`CkptIntegrityError` -- raised by the manager on mismatch and
  treated exactly like a torn write: fall back to the older step,
  quarantine the bad one, emit ``ckpt_integrity``/``ckpt_fallback``
  events.

crc32 (stdlib zlib) rather than a cryptographic hash: the adversary is
cosmic rays and disk rot, not forgery.
"""
from __future__ import annotations

import zlib
from typing import Any, Dict, List, Mapping, Optional


class CkptIntegrityError(RuntimeError):
    """A restored checkpoint's content does not match the checksums
    recorded at save time: silent corruption. The restore path treats
    this like a torn write (fall back older, quarantine)."""


def dtype_name(t: Any) -> str:
    """``"float32"``, ``"bfloat16"``, ...: numpy's and JAX's spelling."""
    return str(getattr(t, "dtype", "")).replace("torch.", "")


def whole(t: Any) -> Optional[Any]:
    """The tensor this process holds whole: ``t`` itself, a DTensor's
    local tensor when no placement splits it over more than one rank,
    or None (a real shard)."""
    mesh = getattr(t, "device_mesh", None)
    if mesh is None:
        return t
    for dim, p in enumerate(t.placements):
        if not p.is_replicate() and mesh.size(dim) > 1:
            return None
    return t.to_local()


def _crc(t: Any) -> Dict[str, Any]:
    """``{"crc32": ..., "dtype": ...}`` of a plain tensor's C-contiguous
    bytes (a bf16 tensor as int16: the same bytes)."""
    import torch

    dtype = dtype_name(t)
    t = t.detach().to("cpu").contiguous()
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)
    return {"crc32": zlib.crc32(t.numpy()) & 0xFFFFFFFF, "dtype": dtype}


def leaf_checksum(t: Any) -> Optional[Dict[str, Any]]:
    """The checksum of one leaf, or None when this process does not
    hold it whole."""
    t = whole(t)
    return None if t is None else _crc(t)


def shard_checksum(t: Any) -> Optional[Dict[str, Any]]:
    """The checksum of this process's local shard of a leaf sharded
    over more than one rank, or None when it holds the leaf whole."""
    return _crc(t.to_local()) if whole(t) is None else None


def leaf_checksums(state: Mapping[str, Any],
                   shards: bool = False) -> Dict[str, Dict[str, Any]]:
    """Per-leaf content checksums of a flat state dict: of the leaves
    this process holds whole, or (``shards``) of its local shards of
    the others. The leaves left out are absent -- verify_tree skips
    what was never summed."""
    one = shard_checksum if shards else leaf_checksum
    sums: Dict[str, Dict[str, Any]] = {}
    for path, leaf in state.items():
        rec = one(leaf)
        if rec is not None:
            sums[path] = rec
    return sums


def verify_tree(restored: Mapping[str, Any],
                sums: Dict[str, Dict[str, Any]],
                shards: bool = False) -> List[str]:
    """Recompute checksums over a restored flat state dict (``shards``
    as in :func:`leaf_checksums`) and compare against the save-time
    records; returns the mismatched paths (empty = verified). Skipped
    (never counted as mismatch): paths with no saved sum, leaves
    restored into a different dtype, and leaves not summed this way."""
    one = shard_checksum if shards else leaf_checksum
    bad: List[str] = []
    for path, leaf in restored.items():
        rec = sums.get(path)
        if rec is None or dtype_name(leaf) != rec.get("dtype"):
            continue
        got = one(leaf)
        if got is not None and got["crc32"] != rec["crc32"]:
            bad.append(path)
    return bad
