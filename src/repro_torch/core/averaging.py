"""Weight averaging — the paper's Reduce step (Alg. 1 line 11, Alg. 2
lines 18-20): Ŵ = 1/k Σ Wᵢ for every parameter (CNN kernels, biases, ELM
β). The port's counterpart of ``repro.core.averaging``.

* ``average_trees`` / ``weighted_average_trees`` — a list of member trees.
* ``average_member_dim`` — members stacked on a leading dim.
* ``gossip_member_dim`` — ring consensus over the member dim, the
  single-device form of the decentralized Reduce.
* Over a member mesh (``torch.distributed``, one rank per device, each
  holding a slice of the members): ``psum_weighted_mean_members`` (ONE
  all-reduce), ``hierarchical_psum_weighted_mean_members`` (one per mesh
  level), ``gossip_ring_mix`` (two ring exchanges a mixing round, no
  all-reduce) and ``pmean_members``. Their collectives go through
  ``distributed.collectives``, which counts them.

Every form accumulates in f32 whatever the leaf dtype, and sums the
members one by one in member order: the sequential and stacked Map paths
reduce to bit-identical averages, and so does the mesh on one rank (its
all-reduce of one partial is that partial).
"""
from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.distributed as dist

from repro_torch.distributed import collectives
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


# ---------------------------------------------------------------------------
# Over a member mesh: each rank holds a slice of the members
# ---------------------------------------------------------------------------
#
# A rank's ``stacked`` tree carries only its own real members on the
# leading dim (possibly none). The weights are host floats every rank
# knows: ``weights`` is this rank's slice of the global weight vector and
# ``total`` the global weight sum (the member count k under uniform
# weights, ``weights=None``). Each rank forms the f32 partial of its
# members in member order — the arithmetic of ``weighted_average_trees``
# (each member scaled by w/total, then summed) or ``average_trees`` (summed,
# divided by k after the sum) — and the partials of every leaf go in one
# flat vector into each all-reduce. On one rank the result is therefore
# bitwise the single-device average; on W ranks only the association of
# the W partials differs.


def _unraveler(tree, member_dim: bool = False):
    """The inverse of ``ravel`` for trees shaped as ``tree`` (without its
    leading member dim when ``member_dim``): each leaf in its own shape
    and dtype."""
    leaves = tree_leaves(tree)
    shapes = [tuple(a.shape[1:] if member_dim else a.shape) for a in leaves]
    dtypes = [a.dtype for a in leaves]

    def unravel(v):
        parts, o = [], 0
        for shape, dtype in zip(shapes, dtypes):
            size = math.prod(shape)
            parts.append(v[o:o + size].reshape(shape).to(dtype))
            o += size
        it = iter(parts)
        return tree_map(lambda _: next(it), tree)

    return unravel


def ravel(tree):
    """(one flat f32 vector of every leaf, ``unravel``): ``unravel(flat)``
    rebuilds the tree, each leaf in its own shape and dtype."""
    return (torch.cat([a.reshape(-1).float() for a in tree_leaves(tree)]),
            _unraveler(tree))


def _local_partial(stacked, weights, total: float):
    """The f32 partial of this rank's members (leading dim), in member
    order; zeros of one member's shape when the rank holds none."""
    n = tree_leaves(stacked)[0].shape[0]
    if weights is not None and len(weights) != n:
        raise ValueError(f"{len(weights)} weights for {n} local members")
    if n == 0:
        return tree_map(lambda a: torch.zeros(a.shape[1:],
                                              dtype=torch.float32,
                                              device=a.device), stacked)
    scales = ([None] * n if weights is None
              else [float(w) / float(total) for w in weights])
    return _scaled_sum([_member(stacked, i) for i in range(n)], scales)


def _psum_mean(stacked, weights, total, groups):
    flat, _ = ravel(_local_partial(stacked, weights, total))
    for group, label in groups:             # innermost level first
        collectives.all_reduce(flat, group, label)
    if weights is None:
        flat = flat / float(total)
    return _unraveler(stacked, member_dim=True)(flat)


def psum_weighted_mean_members(stacked, weights, total: float, group=None,
                               label: str = "pod"):
    """The (weighted) mean over the global member dim as ONE all-reduce
    over ``group``: this rank's f32 partial of every leaf, raveled flat,
    summed once. ``weights``: this rank's slice of the member weights, or
    None for the uniform mean; ``total``: their global sum, or the global
    member count k when uniform. Returns the averaged tree (member dim
    reduced away), the same on every rank."""
    return _psum_mean(stacked, weights, total, [(group, label)])


def hierarchical_psum_weighted_mean_members(stacked, weights, total: float,
                                            groups):
    """The same mean staged over a multi-level member mesh: ``groups`` is
    a sequence of ``(group, label)``, innermost first — on a
    ``('host', 'pod')`` mesh, this rank's pod group (the ranks of its
    host), then its host group (one rank per host, its peers across
    hosts). One all-reduce per level, whatever the number of ranks. With
    one group it is ``psum_weighted_mean_members``."""
    return _psum_mean(stacked, weights, total, list(groups))


def pmean_members(params, group=None, label: str = "pod"):
    """Per-leaf mean of ``params`` over the ranks of ``group``: one
    all-reduce per leaf (``psum_weighted_mean_members`` is the one-call
    form)."""
    p = float(dist.get_world_size(group))
    return tree_map(lambda a: collectives.all_reduce(a.float().clone(),
                                                     group, label)
                    .div(p).to(a.dtype), params)


def gossip_ring_mix(stacked, weights, rounds: int, group=None,
                    label: str = "pod"):
    """The mixing loop of the ring over the ranks of ``group``, one node a
    rank: the rank's members pre-aggregate into its node state
    (num, den) = (Σ wᵢ·xᵢ, Σ wᵢ) in f32 (``weights=None``: 1 each), both
    in one flat vector, and each of the ``rounds`` mixing rounds is TWO
    ring exchanges — the state sent right and received from the left, then
    sent left and received from the right — and one stencil step
    (s + left + right) / 3. No all-reduce.

    At two ranks both neighbours are the one peer: the two exchanges run
    one after the other, each one send and one receive, so they match in
    order. At one rank there is no peer: the node is its own neighbour on
    both sides and computes (s + s + s) / 3 locally — the reference's
    self-permute, which is not s bit for bit — with no exchange.

    Returns ``(num, den)``: this node's f32 numerator tree (member dim
    reduced away) and its scalar weight mass. ``num / den`` is the node's
    estimate; the sums of num and den over the nodes are those before the
    mixing (the stencil is doubly stochastic)."""
    if rounds < 1:
        raise ValueError(f"gossip needs rounds >= 1, got {rounds}")
    leaves = tree_leaves(stacked)
    n, dev = leaves[0].shape[0], leaves[0].device
    w = (torch.ones((n,), dtype=torch.float32, device=dev) if weights is None
         else torch.as_tensor(weights, dtype=torch.float32).to(dev))
    if n == 0:
        num = tree_map(lambda a: torch.zeros(a.shape[1:], dtype=torch.float32,
                                             device=dev), stacked)
        den = torch.zeros((), dtype=torch.float32, device=dev)
    else:
        num = None
        for i in range(n):
            part = tree_map(lambda a, i=i: a[i].float() * w[i], stacked)
            num = part if num is None else tree_map(torch.add, num, part)
        den = w[0]
        for i in range(1, n):
            den = den + w[i]
    flat, unravel = ravel((num, den))
    p, r = dist.get_world_size(group), dist.get_rank(group)
    for _ in range(rounds):
        if p == 1:
            left = right = flat
        else:
            left = collectives.ring_exchange(flat, (r + 1) % p, (r - 1) % p,
                                             group, label)
            right = collectives.ring_exchange(flat, (r - 1) % p, (r + 1) % p,
                                              group, label)
        flat = (flat + left + right) / 3.0
    return unravel(flat)
