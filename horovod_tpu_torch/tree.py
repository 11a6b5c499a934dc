"""Nested dicts, lists and tuples of tensors (counterpart: JAX's pytrees).

The port keeps parameters, gradients and optimizer state as plain nested
containers, like the JAX package's pytrees; these two helpers walk them
in a fixed order (dicts by insertion order).
"""

from __future__ import annotations

from typing import Any, Callable, List


def tree_leaves(tree: Any) -> List[Any]:
    """Every leaf of ``tree``, depth first."""
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in tree_leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def tree_paths(tree: Any, prefix: str = "") -> List[str]:
    """The dotted path of every leaf, in :func:`tree_leaves` order
    (``{"layers": [{"wq": ...}]}`` → ``"layers.0.wq"``)."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return [prefix]
    return [p for k, v in items
            for p in tree_paths(v, f"{prefix}.{k}" if prefix else str(k))]


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """``tree`` with every leaf replaced by ``fn(leaf, *matching leaves)``."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    return fn(tree, *rest)
