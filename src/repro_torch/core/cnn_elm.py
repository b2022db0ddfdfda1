"""Distributed Averaging CNN-ELM — the paper's Algorithm 2, the MATH of the
Map phase. The port's counterpart of ``repro.core.cnn_elm``.

One member (machine i):
  for epoch j in 1..e:
      reset ΣU = 0, ΣV = 0                               (line 7)
      for batch p in partition i:
          H = CNN features of batch (optimal-tanh applied) (line 9)
          ΣU += HᵀH ; ΣV += HᵀT                          (lines 10-11)
          β = (I/λ + ΣU)⁻¹ ΣV                            (line 12)
          backprop ELM error J = ½||Hβ−T||² into CNN      (line 13)
          W ← W − α ∇W J ;  b ← b − α ∇b J               (line 14)

β on line 12 is solved from the running sums of the current epoch (the
reference's faithful quirk). At e = 0 (Tables 2/4) no SGD happens: one
pass accumulates U, V and β is solved once — pure CNN-as-random-feature
ELM. Reduce (lines 18-20): average every Wᵢ, bᵢ, βᵢ across the k members.

* ``member_step`` — lines 9-14 for ALL k members on one batch index, the
  member dim written out (the counterpart of the body of the reference's
  ``stacked_epoch_scan``); ``lr=None`` is the e = 0 pass (lines 9-11).
* ``stacked_epoch_pass`` — one epoch of batch indices through
  ``member_step``; unequal partitions ride through padding + a per-batch
  validity mask (masked batches add nothing to U, V, n and leave the
  params as they are).
* ``train_member`` — the faithful sequential reference, one batch of one
  member at a time (``member_step`` with k = 1).

The conv's gradient runs through the hand kernels on the card
(``kernels.conv2d.ops``). The reference recomputes the features inside
its loss (the same params on the same batch, so the same H); the port
keeps the forward's graph and hands a detached H to the statistics.

Both paths draw member i's batch order from ``default_rng(seed)``'s next
permutation each epoch (``data.partition``) — the reference's rule.
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
from repro_torch.tree import tree_leaves, tree_map


@dataclass
class CNNELMModel:
    cnn_params: dict
    beta: torch.Tensor          # (F, C)


def member_step(cfg, params_k, stats_k, x, t, m=None, *, lr=None,
                infos=None):
    """Algorithm 2 lines 9-14 for all k members on one batch index: member
    i's batch x[i] (B, H, W[, C]) with one-hot targets t[i] (B, C) through
    member i's CNN, its stats added to member i's running sums; then, with
    an ``lr``, β solved from those sums and one SGD step on the ELM loss.

    ``m``: optional (k,) batch validity (1 = real, 0 = padding) — a masked
    batch adds nothing to U, V or n and leaves its member's params as they
    are; ``m=None`` keeps the mask out of the computation. ``infos``
    collects the β solves' Cholesky ``info`` (``elm.solve_beta``). The
    members' losses are summed, so each member's gradient is its own.
    Returns (params_k, stats_k); the params are new tensors."""
    if lr is None:
        with torch.no_grad():
            h = cnn.features_members(cfg, params_k, x)
            return params_k, elm.add_stats(stats_k,
                                           elm.batch_stats(h, t, mask=m))
    leaves = [a.detach().requires_grad_(True) for a in tree_leaves(params_k)]
    it = iter(leaves)
    p = tree_map(lambda _: next(it), params_k)
    with torch.enable_grad():
        h = cnn.features_members(cfg, p, x)
        stats_k = elm.add_stats(stats_k, elm.batch_stats(h.detach(), t,
                                                         mask=m))
        beta = elm.solve_beta(stats_k, cfg.elm_lambda, infos)
        loss = elm.member_losses(h, beta, t).sum()
        grads = iter(torch.autograd.grad(loss, leaves))
    with torch.no_grad():
        if m is None:
            new = [a - lr * next(grads) for a in leaves]
        else:
            keep = m > 0
            new = [torch.where(keep.reshape((-1,) + (1,) * (a.dim() - 1)),
                               a - lr * next(grads), a) for a in leaves]
    it = iter(new)
    return tree_map(lambda _: next(it), params_k), stats_k


def train_member(cfg, cnn_params, part: Partition, *, epochs: int,
                 batch_size: int, lr_schedule=None, seed=0,
                 return_stats: bool = False):
    """Algorithm 2 inner loop for one machine. epochs=0 -> ELM-only pass.
    Epoch e draws the (e+1)-th permutation of ``default_rng(seed)``
    (``seed`` may be a live ``np.random.Generator``, consumed in place)
    and steps at ``lr_schedule(e)``. ``return_stats`` also returns the
    final epoch's ``ELMStats`` β was solved from. The host waits for the
    device once an epoch, for the β solves' factorisation checks."""
    params, stats = member_epochs(cfg, cnn_params, part, epochs=epochs,
                                  batch_size=batch_size,
                                  lr_schedule=lr_schedule, seed=seed)
    model = CNNELMModel(params, elm.solve_beta(stats, cfg.elm_lambda))
    return (model, stats) if return_stats else model


def member_epochs(cfg, cnn_params, part: Partition, *, epochs: int,
                  batch_size: int, lr_schedule=None, seed=0):
    """``train_member`` up to its final β solve: the trained CNN params and
    the final epoch's ``ELMStats``."""
    if epochs < 0:
        raise ValueError(f"epochs must be >= 0, got {epochs}")
    if epochs > 0 and lr_schedule is None:
        raise ValueError("epochs > 0 needs an lr_schedule "
                         "(e.g. optim.schedules.dynamic_paper)")
    F, C = cnn.feature_dim(cfg), cfg.num_classes
    device = cnn_params["stages"][0]["w"].device
    rng = np.random.default_rng(seed)
    params_k = tree_map(lambda a: a[None], cnn_params)
    rates = [None] if epochs == 0 else [float(lr_schedule(e))
                                        for e in range(epochs)]
    for lr in rates:
        stats = elm.zero_stats_stacked(1, F, C, device=device)
        infos = []
        for x, y in batches(part, batch_size, seed=rng):
            xd = torch.from_numpy(x).to(device)[None]
            td = torch.from_numpy(one_hot(y, C)).to(device)[None]
            params_k, stats = member_step(cfg, params_k, stats, xd, td,
                                          lr=lr, infos=infos)
        elm.check_factorisations(infos)
    return (tree_map(lambda a: a[0], params_k),
            elm.ELMStats(*(a[0] for a in stats)))


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


def stacked_epoch_pass(cfg, params_k, stats_k, xb, tb, mb=None, *,
                       lr=None, infos=None):
    """One epoch (or a chunk of one) for ALL members: ``member_step`` per
    batch index. xb: (nb, k, B, H, W[, C]) batches, tb: (nb, k, B, C)
    one-hot targets, mb: optional (nb, k) per-batch validity (``mb=None``:
    all shards equal, no mask in the computation); ``lr``/``infos`` as in
    ``member_step``. Returns (params_k, stats_k)."""
    for b in range(xb.shape[0]):
        params_k, stats_k = member_step(
            cfg, params_k, stats_k, xb[b], tb[b],
            None if mb is None else mb[b], lr=lr, infos=infos)
    return params_k, stats_k


def scores_stacked(cfg, cnn_params_k, beta_k, x):
    """(k, B, C) ELM scores of ONE eval batch x (B, H, W[, C]) under ALL k
    members: the batch is shared, each member's CNN runs on it in one
    member-batched launch per conv stage."""
    k = beta_k.shape[0]
    x = x.float()
    h = cnn.features_members(cfg, cnn_params_k,
                             x[None].expand((k,) + tuple(x.shape)))
    return elm.predict(h, beta_k)


def average_models(models: Sequence[CNNELMModel],
                   weights: Optional[Sequence[float]] = None) -> CNNELMModel:
    """Reduce: lines 18-20 — average CNN weights, biases AND β. Optional
    ``weights`` (e.g. shard sizes) give the exact expectation over unequal
    partitions."""
    trees = [(m.cnn_params, m.beta) for m in models]
    if weights is not None:
        return CNNELMModel(*weighted_average_trees(trees, weights))
    return CNNELMModel(*average_trees(trees))
