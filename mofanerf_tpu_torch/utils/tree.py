"""Nested param trees (dicts, lists) of tensors or arrays: leaves in JAX's
flatten order (dict keys sorted), key paths as `jax.tree_util.keystr`
writes them (`['layers'][0]['w']`), and rebuilding a tree from its leaves."""
from __future__ import annotations

from typing import Any, List, Tuple


def flatten_with_keystr(tree, prefix: str = "") -> List[Tuple[str, Any]]:
    """[(key path, leaf)] in JAX's flatten order."""
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out += flatten_with_keystr(tree[k], f"{prefix}[{k!r}]")
        return out
    if isinstance(tree, (list, tuple)):
        out = []
        for i, v in enumerate(tree):
            out += flatten_with_keystr(v, f"{prefix}[{i}]")
        return out
    return [(prefix, tree)]


def tree_leaves(tree) -> list:
    return [leaf for _, leaf in flatten_with_keystr(tree)]


def tree_unflatten(like, leaves):
    """A tree of `like`'s structure holding `leaves` (in tree_leaves order)."""
    it = iter(leaves)

    def build(node):
        if isinstance(node, dict):
            return {k: build(node[k]) for k in sorted(node)}
        if isinstance(node, (list, tuple)):
            return [build(v) for v in node]
        return next(it)

    return build(like)


def map_tree(fn, tree):
    if isinstance(tree, dict):
        return {k: map_tree(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [map_tree(fn, v) for v in tree]
    return fn(tree)
