"""Nested dict/list trees <-> flat ``//``-joined paths, the key scheme of
the JAX package's checkpoints (``train/checkpoint.py`` there)."""

from __future__ import annotations

from typing import Any, Dict, Iterator, Tuple

SEP = "//"


def keyed_leaves(tree, path: str = "") -> Iterator[Tuple[str, Any]]:
    """(JAX ``keystr`` path, leaf) pairs in ``jax.tree_util``'s order: dict
    keys sorted, list items in order."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from keyed_leaves(tree[k], f"{path}[{k!r}]")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from keyed_leaves(v, f"{path}[{i}]")
    else:
        yield path, tree


def flatten(tree, prefix: str = "") -> Dict[str, Any]:
    """``//`` paths of a nested dict/list tree; list indices as digits."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return {prefix: tree}
    flat: Dict[str, Any] = {}
    for k, v in items:
        flat.update(flatten(v, f"{prefix}{SEP}{k}" if prefix else str(k)))
    return flat


def unflatten(flat: Dict[str, Any]):
    """Nested dicts from ``//`` paths; integer components become list
    indices when they run contiguously from 0."""
    nested: dict = {}
    for key, v in flat.items():
        d = nested
        *parents, last = key.split(SEP)
        for k in parents:
            d = d.setdefault(k, {})
        d[last] = v

    def listify(node):
        if not isinstance(node, dict):
            return node
        node = {k: listify(v) for k, v in node.items()}
        keys = list(node)
        if keys and all(k.isdigit() for k in keys):
            idx = sorted(int(k) for k in keys)
            if idx == list(range(len(idx))):
                return [node[str(i)] for i in idx]
        return node

    return listify(nested)
