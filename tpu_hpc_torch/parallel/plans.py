"""Partition-spec plans over the port's param trees.

Port of the JAX package's ``parallel/plans.py``. Every strategy is a
*plan*: a list of ``(path_regex, spec)`` rules mapped over the param
tree -- DP replicates everything, FSDP shards a dim over ``data``, TP
applies the Megatron column/row rules on ``model``, and the hybrid
composes the two (TP rules first, FSDP fills the rest).

A spec is :class:`P`, a tuple with one entry per tensor dim: a mesh
axis name, a tuple of names, or None -- the JAX ``PartitionSpec``'s
shape, with no jax behind it. Trees are the port's nested dicts (the
flax key paths, ``layers_0/attention/wq/kernel``); lists and tuples
inside a tree are indexed by position, as jax's key paths do.
:func:`placements` turns a spec into DTensor placements on a
``DeviceMesh``.
"""
from __future__ import annotations

import re
from typing import Any, Callable, List, Sequence, Tuple


class P(tuple):
    """A partition spec: ``P("data", None)`` shards dim 0 over the
    ``data`` axis and leaves dim 1 whole; ``P()`` replicates."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __getnewargs__(self):  # pickle rebuilds P(*entries)
        return tuple(self)

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


Rule = Tuple[str, P]


def _is_leaf(node) -> bool:
    return not isinstance(node, (dict, list, tuple)) or isinstance(node, P)


def _items(node):
    if isinstance(node, dict):
        return list(node.items())
    return list(enumerate(node))


def map_with_path(fn: Callable, tree: Any, *rest: Any, prefix: str = "") -> Any:
    """``fn(path, leaf, *rest_leaves)`` over a nested dict/list tree
    (and trees of the same structure in ``rest``); paths are
    '/'-joined keys. Specs (:class:`P`) count as leaves."""
    if _is_leaf(tree):
        return fn(prefix, tree, *rest)
    out = []
    for key, child in _items(tree):
        path = f"{prefix}/{key}" if prefix else str(key)
        out.append((key, map_with_path(
            fn, child, *(r[key] for r in rest), prefix=path)))
    values = [v for _, v in out]
    if isinstance(tree, dict):
        return dict(out)
    if hasattr(tree, "_fields"):  # a namedtuple (optax states)
        return type(tree)(*values)
    return type(tree)(values) if isinstance(tree, tuple) else values


def tree_specs(specs: Any) -> List[P]:
    """The specs of a spec tree, in its key order."""
    found: List[P] = []
    map_with_path(lambda _, s: found.append(s), specs)
    return found


def apply_rules(rules: Sequence[Rule], path: str, default: P = P()) -> P:
    """First matching rule wins (re.search semantics)."""
    for pattern, spec in rules:
        if re.search(pattern, path):
            return spec
    return default


def pspec_tree(params: Any, rules: Sequence[Rule], default: P = P()) -> Any:
    """Map a rule list over a param tree -> a tree of specs."""
    return map_with_path(lambda path, _: apply_rules(rules, path, default),
                         params)


def derived_pspecs(derived: Any, params: Any, param_specs: Any) -> Any:
    """Specs for a params-derived tree (optimizer state): each leaf
    whose path ends with a param's path, component-aligned, and whose
    shape equals that param's takes the param's spec; everything else
    (counters, scalars) is replicated."""
    by_path = {}
    map_with_path(
        lambda path, leaf, spec: by_path.__setitem__(
            path, (tuple(leaf.shape), spec)),
        params, param_specs,
    )

    def rule(path, leaf):
        shape = tuple(getattr(leaf, "shape", ()))
        for ppath, (pshape, spec) in by_path.items():
            if (path == ppath or path.endswith("/" + ppath)) \
                    and shape == pshape:
                return spec
        return P()

    return map_with_path(rule, derived)


def describe_plan(params: Any, rules: Sequence[Rule],
                  default: P = P()) -> List[str]:
    """Human-readable rule-plan dump (path -> spec), for logging."""
    return describe_pspecs(params, pspec_tree(params, rules, default))


def describe_pspecs(params: Any, specs: Any) -> List[str]:
    """Human-readable dump of an already-built spec tree."""
    lines: List[str] = []
    map_with_path(
        lambda path, leaf, spec: lines.append(
            f"{path}: {spec} {tuple(leaf.shape)}"),
        params, specs,
    )
    return lines


def placements(spec: P, mesh) -> list:
    """``spec`` -> one DTensor placement per dim of ``mesh`` (a
    ``DeviceMesh`` with dim names): ``Shard(d)`` where the spec names
    that mesh dim at tensor dim ``d``, ``Replicate()`` elsewhere. Axes
    the mesh lacks are skipped: on a sub-mesh (``mesh["model"]``) they
    belong to another one (FSDP2's ``data``)."""
    from torch.distributed.tensor import Replicate, Shard

    names = mesh.mesh_dim_names or ()
    out: list = [Replicate() for _ in names]
    for dim, entry in enumerate(spec):
        for axis in (entry if isinstance(entry, tuple) else (entry,)):
            if axis in names:
                out[names.index(axis)] = Shard(dim)
    return out
