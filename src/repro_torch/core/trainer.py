"""Train and serve steps — the port's counterpart of
``repro.core.trainer``.

``make_train_step``        — standard CE training (the per-member Map step).
``make_member_train_step`` + ``make_average_step`` — the members on a
                             leading member dim, and the Reduce over it
                             (with a process group: one all-reduce).
``make_prefill_step`` / ``make_serve_step`` — the LM serving steps.

PyTorch runs eagerly, so a step is the plain function the reference would
jit. The gradient is ``torch.autograd.grad`` at the pre-update params; on
the card it runs through the rmsnorm and swa_attention backward kernels.
The update is applied one leaf (and one slice of a large leaf) at a time
(``optim.step_leafwise``), which gives the reference's values without its
whole f32 update tree in memory.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.distributed as dist

from repro_torch.core.averaging import (average_member_dim,
                                        broadcast_member_dim,
                                        psum_weighted_mean_members)
from repro_torch.core.parallel_sgd import make_stacked_train_step
from repro_torch.models import api
from repro_torch.optim.optimizers import (clip_scale, global_norm,
                                          step_leafwise)
from repro_torch.tree import tree_leaves, tree_map


def make_train_step(cfg, optimizer, lr_schedule, clip: float = 1.0,
                    loss_fn: Optional[Callable] = None):
    """``train_step(params, opt_state, step, batch) -> (params, opt_state,
    step + 1, metrics)``: the loss and its gradient at ``params``, the
    gradient clipped to global norm ``clip``, one optimizer update at
    ``lr_schedule(step)``. ``metrics``: ``loss``, ``grad_norm``, ``lr`` and
    the loss function's own (``ce``, ``aux``). The inputs are not
    modified. ``step`` is a Python int."""
    loss_fn = loss_fn or (lambda p, b: api.loss_fn(cfg, p, b))

    def train_step(params, opt_state, step, batch):
        leaves = [a.detach().requires_grad_(True)
                  for a in tree_leaves(params)]
        it = iter(leaves)
        p = tree_map(lambda _: next(it), params)
        with torch.enable_grad():
            loss, metrics = loss_fn(p, batch)
            grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        del p
        # a leaf the loss does not use has the reference's zero gradient
        grads = [torch.zeros_like(a) if g is None else g
                 for a, g in zip(leaves, grads)]
        del leaves
        gnorm = global_norm(grads)
        lr = lr_schedule(step)
        params, opt_state = step_leafwise(
            optimizer, params, grads, opt_state, step, lr,
            grad_scale=clip_scale(gnorm, clip))
        out = {"loss": loss.detach(), "grad_norm": gnorm, "lr": lr}
        out.update({k: v.detach() for k, v in metrics.items()})
        return params, opt_state, step + 1, out

    return train_step


def make_member_train_step(cfg, optimizer, lr_schedule, clip: float = 1.0):
    """The train step over a leading member dim of params, optimizer state,
    steps (a sequence of ints) and batch (the Map phase: members train with
    no communication). The reference vmaps its step; the port's kernels
    are ctypes launches, so this loops over the members in order
    (``parallel_sgd.make_stacked_train_step``)."""
    return make_stacked_train_step(
        make_train_step(cfg, optimizer, lr_schedule, clip))


def make_average_step(weights=None, group=None):
    """The Reduce (Alg. 2 lines 18-20): the mean over the member dim,
    broadcast back as every member's next-round init — the rounds contract,
    weighted by ``weights`` (one per member of the whole run; normalised)
    or uniform.

    ``group=None``: the member-dim mean of one process. With a process
    group (``torch.distributed``, each rank holding an equal slice of the
    members in rank order) the whole tree's mean is ONE all-reduce
    (``averaging.psum_weighted_mean_members``, counted by
    ``distributed.collectives``) — where the reference shard_maps over a
    mesh's 'pod' axis."""
    if group is None:
        def average_step(stacked_params):
            k = tree_leaves(stacked_params)[0].shape[0]
            return broadcast_member_dim(
                average_member_dim(stacked_params, weights=weights), k)

        return average_step

    def average_step(stacked_params):
        k_local = tree_leaves(stacked_params)[0].shape[0]
        world, rank = dist.get_world_size(group), dist.get_rank(group)
        if weights is None:
            w_local, total = None, float(k_local * world)
        else:
            w = [float(x) for x in weights]
            if len(w) != k_local * world:
                raise ValueError(f"{len(w)} weights for {world} ranks of "
                                 f"{k_local} members")
            w_local = w[rank * k_local:(rank + 1) * k_local]
            total = sum(w)
        avg = psum_weighted_mean_members(stacked_params, w_local, total,
                                         group)
        return broadcast_member_dim(avg, k_local)

    return average_step


def make_serve_step(cfg):
    def serve_step(params, cache, token, pos):
        return api.decode_step(cfg, params, cache, token, pos)

    return serve_step


def make_prefill_step(cfg):
    def prefill_step(params, batch):
        return api.prefill(cfg, params, batch)

    return prefill_step


def init_train_state(cfg, optimizer, generator, dtype=torch.bfloat16,
                     device="cuda"):
    """(params, optimizer state, step 0) of a fresh model."""
    params = api.init_params(cfg, generator, dtype, device)
    return params, optimizer.init(params), 0
