"""Distributed Averaging CNN-ELM — the paper's Algorithm 2, the MATH of the
Map phase. The port's counterpart of ``repro.core.cnn_elm``.

One member (machine i) at e = 0 epochs (Tables 2/4): one pass accumulates
ΣU = Σ HᵀH and ΣV = Σ HᵀT over the partition's batches (Alg. 2 lines 7-11,
H = CNN features with optimal-tanh) and β = (I/λ + ΣU)⁻¹ ΣV is solved once
— pure CNN-as-random-feature ELM. Reduce (lines 18-20): average every Wᵢ,
bᵢ, βᵢ across the k members.

* ``train_member``  — the faithful sequential reference, one batch at a
  time for one member.
* ``stacked_epoch_pass`` — all k members' batches in one member-batched
  step per batch index (the counterpart of the reference's
  ``stacked_epoch_scan`` at ``solve_each_batch=False``), unequal
  partitions riding through padding + a per-batch validity mask.

SGD epochs (lines 13-14) differentiate through the conv and need its
backward kernel: they come with the next slice, and ``epochs > 0`` raises.

Both paths draw member i's batch order from ``default_rng(seed)``'s next
permutation (``data.partition``) — the reference's rule.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence

import numpy as np
import torch

from repro_torch.core import elm
from repro_torch.core.averaging import (average_member_dim, average_trees,
                                        weighted_average_trees)
from repro_torch.data.partition import Partition, batches
from repro_torch.data.synthetic import one_hot
from repro_torch.models import cnn
from repro_torch.tree import tree_map

SGD_SLICE = "SGD epochs need the conv backward kernel — next slice"


@dataclass
class CNNELMModel:
    cnn_params: dict
    beta: torch.Tensor          # (F, C)


def train_member(cfg, cnn_params, part: Partition, *, epochs: int,
                 batch_size: int, seed=0, return_stats: bool = False):
    """Algorithm 2 inner loop for one machine at epochs=0: stats over the
    partition's batches in ``default_rng(seed)``'s first permutation
    (``seed`` may be a live ``np.random.Generator``, consumed in place),
    then one β solve. ``return_stats`` also returns the ``ELMStats`` β was
    solved from."""
    if epochs != 0:
        raise NotImplementedError(SGD_SLICE)
    F, C = cnn.feature_dim(cfg), cfg.num_classes
    device = cnn_params["stages"][0]["w"].device
    stats = elm.zero_stats(F, C, device=device)
    for x, y in batches(part, batch_size, seed=np.random.default_rng(seed)):
        xd = torch.from_numpy(x).to(device)
        td = torch.from_numpy(one_hot(y, C)).to(device)
        h = cnn.features(cfg, cnn_params, xd)
        stats = elm.add_stats(stats, elm.batch_stats(h, td))
    model = CNNELMModel(cnn_params, elm.solve_beta(stats, cfg.elm_lambda))
    return (model, stats) if return_stats else model


@dataclass
class StackedMembers:
    """All k members with every array stacked on a leading member dim."""
    cnn_params: dict         # leaves: (k, ...)
    beta: torch.Tensor       # (k, F, C)

    @property
    def k(self) -> int:
        return self.beta.shape[0]

    def member(self, i: int) -> CNNELMModel:
        return CNNELMModel(tree_map(lambda a: a[i], self.cnn_params),
                           self.beta[i])

    def unstack(self) -> List[CNNELMModel]:
        return [self.member(i) for i in range(self.k)]

    def averaged(self, weights=None) -> CNNELMModel:
        """Reduce: the (weighted) mean over the member dim."""
        avg_cnn, avg_beta = average_member_dim((self.cnn_params, self.beta),
                                               weights=weights)
        return CNNELMModel(avg_cnn, avg_beta)

    def to(self, device) -> "StackedMembers":
        return StackedMembers(tree_map(lambda a: a.to(device),
                                       self.cnn_params),
                              self.beta.to(device))


def stack_models(models: Sequence[CNNELMModel]) -> StackedMembers:
    """Host-level models -> the stacked member layout (leaves gain a
    leading k dim) so they can ride the batched scoring surface."""
    cnn_k = tree_map(lambda *xs: torch.stack(xs),
                     *[m.cnn_params for m in models])
    beta_k = torch.stack([m.beta for m in models])
    return StackedMembers(cnn_k, beta_k)


def stacked_epoch_pass(cfg, params_k, stats_k, xb, tb, mb=None):
    """One epochs=0 pass for ALL members: for each batch index, member i's
    batch through member i's CNN, its stats added to member i's running
    sums — the member dim written out, the batch loop in Python.

    xb: (nb, k, B, H, W[, C]) batches, tb: (nb, k, B, C) one-hot targets,
    mb: optional (nb, k) per-batch validity (1 = real, 0 = padding). A
    zero-mask batch contributes nothing to U, V or n; ``mb=None`` (all
    shards equal) keeps the mask out of the computation entirely."""
    for b in range(xb.shape[0]):
        h = cnn.features_members(cfg, params_k, xb[b])
        stats_k = elm.add_stats(stats_k, elm.batch_stats(
            h, tb[b], mask=None if mb is None else mb[b]))
    return stats_k


def average_models(models: Sequence[CNNELMModel],
                   weights: Optional[Sequence[float]] = None) -> CNNELMModel:
    """Reduce: lines 18-20 — average CNN weights, biases AND β. Optional
    ``weights`` (e.g. shard sizes) give the exact expectation over unequal
    partitions."""
    trees = [(m.cnn_params, m.beta) for m in models]
    if weights is not None:
        return CNNELMModel(*weighted_average_trees(trees, weights))
    return CNNELMModel(*average_trees(trees))
