"""Maps over the port's parameter trees: nested dicts, tuples and lists
with tensors (or numpy arrays) at the leaves — the reference's pytree
layout, written out for PyTorch."""
from __future__ import annotations


def tree_map(fn, tree, *rest):
    """Apply ``fn`` leaf-wise over one or more trees of the same structure."""
    if isinstance(tree, dict):
        if any(set(r) != set(tree) for r in rest):
            raise ValueError("trees differ in their keys")
        return {key: tree_map(fn, tree[key], *(r[key] for r in rest))
                for key in tree}
    if isinstance(tree, (tuple, list)):
        if any(len(r) != len(tree) for r in rest):
            raise ValueError("trees differ in their lengths")
        return type(tree)(tree_map(fn, *parts) for parts in zip(tree, *rest))
    return fn(tree, *rest)


def tree_leaves(tree) -> list:
    out = []
    tree_map(out.append, tree)
    return out
