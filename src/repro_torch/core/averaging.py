"""Weight averaging — the paper's Reduce step (Alg. 1 line 11, Alg. 2
lines 18-20): Ŵ = 1/k Σ Wᵢ for every parameter (CNN kernels, biases, ELM
β). The port's counterpart of the single-device half of
``repro.core.averaging``; the collectives and gossip come with the
multi-device slice.

* ``average_trees`` / ``weighted_average_trees`` — a list of member trees.
* ``average_member_dim`` — members stacked on a leading dim.

Both forms accumulate in f32 whatever the leaf dtype, and both sum the
members one by one in member order: the sequential and stacked Map paths
therefore reduce to bit-identical averages.
"""
from __future__ import annotations

from typing import Sequence

import torch

from repro_torch.tree import tree_leaves, tree_map


def _scaled_sum(members: Sequence, scales: Sequence[float]):
    out = None
    for m, s in zip(members, scales):
        part = tree_map(lambda a: a.float() if s is None else a.float() * s,
                        m)
        out = part if out is None else tree_map(torch.add, out, part)
    return out


def average_trees(members: Sequence):
    """Uniform mean, accumulated in f32 regardless of leaf dtype: a bf16
    running sum rounds every add (≈7 mantissa bits), which for k members
    drifts O(k·2⁻⁸) off the true mean."""
    k = float(len(members))
    out = _scaled_sum(members, [None] * len(members))
    return tree_map(lambda a, r: (a / k).to(r.dtype), out, members[0])


def weighted_average_trees(members: Sequence, weights: Sequence[float]):
    """Shard-size-weighted mean (the exact expectation when partitions are
    unequal), scaled and summed in f32."""
    if len(weights) != len(members):
        raise ValueError(f"{len(weights)} weights for {len(members)} members")
    total = float(sum(weights))
    out = _scaled_sum(members, [float(w) / total for w in weights])
    return tree_map(lambda a, r: a.to(r.dtype), out, members[0])


def _member(stacked, i: int):
    return tree_map(lambda a: a[i], stacked)


def average_member_dim(stacked_params, weights=None):
    """Mean over the leading member dim of every leaf; optional ``weights``
    (length k, any positive scale) give the weighted mean. The same
    member-by-member f32 sum as ``average_trees``."""
    k = tree_leaves(stacked_params)[0].shape[0]
    members = [_member(stacked_params, i) for i in range(k)]
    if weights is None:
        return average_trees(members)
    return weighted_average_trees(members, weights)


def broadcast_member_dim(params, k: int):
    """Replicate averaged params to all members (a stacked tree)."""
    return tree_map(lambda a: a[None].expand((k,) + tuple(a.shape))
                    .contiguous(), params)
