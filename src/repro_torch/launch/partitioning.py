"""Logical axes -> shardings: a parameter's logical axes ("fsdp", "tp",
...) resolve through ``mesh.mesh_axes``' rules to a spec (the reference's
``PartitionSpec`` as a tuple), and a spec to a ``Sharding`` (the mesh and
its DTensor placements, ``models.layers.placements_of``).
"""
from __future__ import annotations

from repro_torch.models.layers import Sharding, placements_of


def resolve_spec(logical: tuple, rules: dict) -> tuple:
    """logical: tuple of logical axis names (or None) per dim -> spec."""
    return tuple(rules.get(a) if a is not None else None for a in logical)


def named_sharding(mesh, spec: tuple) -> Sharding:
    return Sharding(mesh, placements_of(spec, mesh))


def _tree_map(fn, tree, is_leaf):
    if is_leaf(tree):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v, is_leaf) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v, is_leaf) for v in tree)
    return fn(tree)


def resolve_tree(logical_tree, mesh, rules):
    return _tree_map(lambda lg: named_sharding(mesh, resolve_spec(lg, rules)),
                     logical_tree, lambda x: isinstance(x, tuple))


def replicated(mesh) -> Sharding:
    return Sharding(mesh, placements_of((), mesh))


def like_tree(tree, sharding):
    return _tree_map(lambda _: sharding, tree, lambda x: not isinstance(
        x, (dict, list, tuple)))
