"""Nested-dict trees to and from flat ``a/b/0/c`` path dicts, numpy only (the
port's own copy of ``tree_flatten_paths`` / ``tree_unflatten_paths`` from the
JAX package's ``utils/pytree.py``)."""

from __future__ import annotations

import numpy as np


def tree_flatten_paths(tree, prefix: str = "") -> dict:
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(tree_flatten_paths(v, f"{prefix}{k}/"))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(tree_flatten_paths(v, f"{prefix}{i}/"))
    else:
        out[prefix[:-1]] = np.asarray(tree)
    return out


def tree_unflatten_paths(flat: dict):
    """Inverse of :func:`tree_flatten_paths`; all-digit key levels become lists."""
    root: dict = {}
    for path, v in flat.items():
        parts = path.split("/")
        node = root
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v

    def listify(node):
        if isinstance(node, dict):
            keys = list(node.keys())
            if keys and all(k.isdigit() for k in keys):
                return [listify(node[str(i)]) for i in range(len(keys))]
            return {k: listify(v) for k, v in node.items()}
        return node

    return listify(root)
