"""Weight averaging — the paper's Reduce step (Alg. 1 line 11, Alg. 2
lines 18-20): Ŵ = 1/k Σ Wᵢ for every parameter (CNN kernels, biases, ELM
β). The port's counterpart of the single-device half of
``repro.core.averaging``; the collectives come with the multi-device
slice.

* ``average_trees`` / ``weighted_average_trees`` — a list of member trees.
* ``average_member_dim`` — members stacked on a leading dim.
* ``gossip_member_dim`` — ring consensus over the member dim, the
  single-device form of the decentralized Reduce.

Both forms accumulate in f32 whatever the leaf dtype, and both sum the
members one by one in member order: the sequential and stacked Map paths
therefore reduce to bit-identical averages.
"""
from __future__ import annotations

import math
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


# ---------------------------------------------------------------------------
# Gossip (decentralized ring consensus — arXiv:1504.00981)
# ---------------------------------------------------------------------------
#
# The consensus state each node n carries is the pair
# (num_n, den_n) = (w_n · x_n, w_n). One mixing round applies the doubly
# stochastic 3-point ring stencil s_n <- (s_n + s_{n-1} + s_{n+1}) / 3 to
# both; after T rounds node n's estimate is num_n / den_n. The stencil
# leaves the sums over the nodes of num and den unchanged, so their ratio
# is the exact global weighted mean — the published readout — while each
# node's own iterate approaches it at the rate of the mixing matrix's
# second eigenvalue |λ₂| = max_{j≠0} |1 + 2·cos(2πj/p)| / 3 (p nodes).

_GOSSIP_EPS = 1e-30     # guards 0/0 on nodes the mixing has not reached


def gossip_mixing_lambda2(p: int) -> float:
    """|λ₂| of the 3-point ring stencil over ``p`` nodes — the geometric
    consensus rate."""
    if p <= 1:
        return 0.0
    return max(abs(1.0 + 2.0 * math.cos(2.0 * math.pi * j / p)) / 3.0
               for j in range(1, p))


def gossip_member_dim(stacked_params, weights, rounds: int):
    """Ring gossip over the leading member dim (node = member).

    Returns ``(iterates, published)``: ``iterates`` keeps the member-dim
    layout, member i reset to its own consensus estimate after ``rounds``
    mixing rounds (members do not collapse to one shared row);
    ``published`` is the invariant-sum readout ``sum(num) / sum(den)``
    with the member dim reduced away. ``weights=None`` gossips the uniform
    mean. f32 throughout."""
    if rounds < 1:
        raise ValueError(f"gossip needs rounds >= 1, got {rounds}")
    leaves = tree_leaves(stacked_params)
    k = leaves[0].shape[0]
    dev = leaves[0].device
    w = (torch.ones((k,), dtype=torch.float32, device=dev) if weights is None
         else torch.as_tensor(weights, dtype=torch.float32).to(dev))

    def member_col(a, v):
        return v.reshape((k,) + (1,) * (a.dim() - 1))

    num = tree_map(lambda a: a.float() * member_col(a, w), stacked_params)
    den = w

    def mix(a):
        return (a + torch.roll(a, 1, dims=0) + torch.roll(a, -1, dims=0)) / 3.0

    for _ in range(rounds):
        num, den = tree_map(mix, num), mix(den)
    d = torch.clamp(den, min=_GOSSIP_EPS)
    iterates = tree_map(lambda s, ref: (s / member_col(s, d)).to(ref.dtype),
                        num, stacked_params)
    published = tree_map(
        lambda s, ref: (torch.sum(s, dim=0) / torch.sum(den)).to(ref.dtype),
        num, stacked_params)
    return iterates, published
