"""Backbone-agnostic ELM readout head — the paper's CNN-ELM integration
generalised to any backbone; the port's counterpart of
``repro.core.elm_head``.

Any ``feature_fn(params, batch) -> (B, S, D)`` or ``(B, D)`` (the CNN's
``features``, any LM family's ``hidden_states``: the decoders, the
encoder, RWKV6, Zamba2) can be trained with:
  1. ``accumulate_stats`` — the E²LM Map over batches (U += HᵀH, V += HᵀT);
  2. ``solve``            — the closed-form readout β;
  3. ``finetune_step``    — Alg. 2 lines 13-14 generalised: one SGD step of
     the backbone on J = ½||Hβ−T||², by ``torch.autograd``.

``accumulate_stats`` and ``predict`` differentiate nothing and run under
``torch.no_grad()``, so they run on the card through every kernel of the
backbone. ``finetune_step`` runs through the backward of every kernel its
backbone calls: the CNN's conv (conv2d_dgrad, conv2d_wgrad) and the LMs'
rmsnorm and swa_attention in either mode (rmsnorm_bwd, swa_attention_bwd)
each have one on the card.
"""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch.core import elm
from repro_torch.tree import tree_leaves, tree_map


def _flatten_features(h):
    return h.reshape(-1, h.shape[-1]) if h.dim() == 3 else h


def _flatten_targets(t, num_classes: int, device):
    t = torch.as_tensor(t, device=device).reshape(-1).long()
    return torch.nn.functional.one_hot(t, num_classes).float()


def accumulate_stats(feature_fn: Callable, params, batch, num_classes: int,
                     stats: elm.ELMStats | None = None) -> elm.ELMStats:
    with torch.no_grad():
        h = _flatten_features(feature_fn(params, batch))
        t = _flatten_targets(batch["targets"], num_classes, h.device)
        s = elm.batch_stats(h, t)
        return s if stats is None else elm.add_stats(stats, s)


def solve(stats: elm.ELMStats, lam: float):
    return elm.solve_beta(stats, lam)


def finetune_step(feature_fn: Callable, params, beta, batch,
                  num_classes: int, lr):
    """One SGD step of the backbone on the ELM least-squares error. Returns
    (new params, the loss before the step). Each leaf steps in f32 and is
    cast back to its dtype; a leaf the features do not use (an unembed)
    keeps its value, as under the reference's zero gradient."""
    leaves = [a.detach().requires_grad_(True) for a in tree_leaves(params)]
    it = iter(leaves)
    p = tree_map(lambda _: next(it), params)
    with torch.enable_grad():
        h = _flatten_features(feature_fn(p, batch))
        t = _flatten_targets(batch["targets"], num_classes, h.device)
        loss = elm.elm_loss(h, beta, t)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    with torch.no_grad():
        new = iter([a.detach() if g is None else
                    (a.float() - lr * g.float()).to(a.dtype)
                    for a, g in zip(leaves, grads)])
    return tree_map(lambda _: next(new), params), loss.detach()


def predict(feature_fn: Callable, params, beta, batch):
    with torch.no_grad():
        h = _flatten_features(feature_fn(params, batch))
        return elm.predict(h, beta)
