"""Parameter trees: nested dicts and lists of tensors, as the JAX package's
pytrees are nested dicts and lists of arrays.

``flatten`` names each leaf by its ``/``-joined key path (``convs/0/self/w``),
the names JAX gives the leaves of a checkpoint; ``unflatten`` rebuilds the
tree, turning a dict whose keys are all decimal indices back into a list.
Leaves come out in one fixed order (dict keys sorted, list items in order), so
the leaves of two trees of one structure line up.
"""

from __future__ import annotations

from typing import Any, Callable


def flatten(tree: Any, prefix: str = "") -> dict[str, Any]:
    """``{key path: leaf}`` in the fixed leaf order."""
    if isinstance(tree, dict):
        items = sorted(tree.items())
    elif isinstance(tree, (list, tuple)):
        items = [(str(i), v) for i, v in enumerate(tree)]
    else:
        return {prefix: tree}
    out: dict[str, Any] = {}
    for key, value in items:
        out.update(flatten(value, f"{prefix}/{key}" if prefix else str(key)))
    return out


def _lists(node: Any) -> Any:
    if not isinstance(node, dict):
        return node
    node = {k: _lists(v) for k, v in node.items()}
    if node and all(k.isdecimal() for k in node):
        return [node[str(i)] for i in range(len(node))]
    return node


def unflatten(flat: dict[str, Any]) -> Any:
    """The tree whose ``flatten`` is ``flat``."""
    root: dict[str, Any] = {}
    for key, leaf in flat.items():
        parts = key.split("/")
        node = root
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = leaf
    return _lists(root)


def leaves(tree: Any) -> list:
    return list(flatten(tree).values())


def map_tree(fn: Callable, tree: Any) -> Any:
    return unflatten({k: fn(v) for k, v in flatten(tree).items()})
