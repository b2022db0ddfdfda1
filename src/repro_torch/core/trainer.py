"""Train and serve steps — the port's counterpart of
``repro.core.trainer``.

``make_train_step``        — standard CE training (the per-member Map step).
``make_member_train_step`` + ``make_average_step`` — the members on a
                             leading member dim, and the Reduce over it
                             (with a process group: one all-reduce).
``make_prefill_step`` / ``make_serve_step`` — the LM serving steps; under
                             ``distributed.ctx.use_mesh_rules`` they run
                             this rank's blocks (the context is read when
                             the step runs, as the reference's dry run
                             traces them inside the context).

PyTorch runs eagerly, so a step is the plain function the reference would
jit. The gradient is ``torch.autograd.grad`` at the pre-update params; on
the card it runs through the rmsnorm and swa_attention backward kernels.
The update is applied one leaf (and one slice of a large leaf) at a time
(``optim.step_leafwise``), which gives the reference's values without its
whole f32 update tree in memory.

Under ``distributed.ctx.use_mesh_rules`` the train steps run this rank's
blocks of the params, the optimizer state (AdamW's μ and ν take each
leaf's layout) and the batch, as the reference's steps run under GSPMD:
the loss is the global one (``models/common.py`` ``cross_entropy``), each
gradient block is all-reduced over the axes that shard the batch and not
the leaf (``data``), the global norm adds each leaf's sum of squares once
(``optim.global_norm`` with the leaves' entries), and the clip and AdamW
run on the blocks unchanged. The member step runs each of this rank's
members under the default rules (the reference's ``spmd_axis_name``
lowering leaves ``pod`` to the member dim), and the Reduce is one
all-reduce of the rank's blocks over the ``pod`` axis's group.
"""
from __future__ import annotations

import functools
from typing import Callable, Optional

import torch
import torch.distributed as dist

from repro_torch.core.averaging import (average_member_dim,
                                        broadcast_member_dim,
                                        psum_weighted_mean_members)
from repro_torch.core.parallel_sgd import make_stacked_train_step
from repro_torch.distributed import ctx, sharding
from repro_torch.models import api
from repro_torch.optim.optimizers import (clip_scale, global_norm,
                                          step_leafwise)
from repro_torch.tree import tree_leaves, tree_map


@functools.lru_cache(maxsize=None)
def _param_shapes(cfg):
    """(shape, logical spec) of every leaf of ``cfg``'s params, in tree
    order: the global shapes a rank's blocks are laid out from."""
    shapes = []
    sharding.map_logical(lambda log, s: shapes.append((s.shape, log)),
                         api.logical_axes(cfg), api.param_specs(cfg))
    return tuple(shapes)


def _leaf_entries(cfg, n_leaves: int):
    """Under the active mesh context: the axes each leaf of ``cfg``'s
    params is sharded on (``ctx.leaf_entry``), in tree order."""
    shapes = _param_shapes(cfg)
    if len(shapes) != n_leaves:
        raise ValueError(f"{n_leaves} gradient blocks for the {len(shapes)} "
                         f"leaves of {cfg.name}'s params")
    return [ctx.leaf_entry(ctx.spec(shape, log)) for shape, log in shapes]


def loss_and_grads(cfg, loss_fn: Callable, params, batch):
    """(loss, metrics, gradients, entries) of ``loss_fn(params, batch)``:
    the gradient of every leaf in ``tree_leaves`` order (a leaf the loss
    does not use has the reference's zero gradient). Under a mesh context
    the gradients are this rank's blocks of the whole gradient: each is
    all-reduced over the axes that shard the batch and not its leaf, and
    ``entries`` lists the axes each leaf is sharded on, for
    ``optim.global_norm``; with no context ``entries`` is None."""
    leaves = [a.detach().requires_grad_(True) for a in tree_leaves(params)]
    it = iter(leaves)
    p = tree_map(lambda _: next(it), params)
    with torch.enable_grad():
        loss, metrics = loss_fn(p, batch)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    del p
    grads = [torch.zeros_like(a) if g is None else g
             for a, g in zip(leaves, grads)]
    del leaves
    if ctx.current() is None:
        return loss, metrics, grads, None
    entries = _leaf_entries(cfg, len(grads))
    be = ctx.batch_entry()
    grads = [ctx.reduce_partial(g, ctx.without(be, e))
             for g, e in zip(grads, entries)]
    return loss, metrics, grads, entries


def make_train_step(cfg, optimizer, lr_schedule, clip: float = 1.0,
                    loss_fn: Optional[Callable] = None):
    """``train_step(params, opt_state, step, batch) -> (params, opt_state,
    step + 1, metrics)``: the loss and its gradient at ``params``, the
    gradient clipped to global norm ``clip``, one optimizer update at
    ``lr_schedule(step)``. ``metrics``: ``loss``, ``grad_norm``, ``lr`` and
    the loss function's own (``ce``, ``aux``). The inputs are not
    modified. ``step`` is a Python int.

    Under a mesh context (every LM family) the arguments are this
    rank's blocks, the gradient blocks are all-reduced over the batch's
    axes the leaf is not sharded on, before the global norm (the module's
    docstring); the new params and state are this rank's blocks."""
    loss_fn = loss_fn or (lambda p, b: api.loss_fn(cfg, p, b))
    if getattr(cfg, "family", None) in api.LM_FAMILIES:
        _param_shapes(cfg)     # built here, outside any step's trace

    def train_step(params, opt_state, step, batch):
        loss, metrics, grads, entries = loss_and_grads(cfg, loss_fn, params,
                                                       batch)
        gnorm = global_norm(grads, entries)
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
    (``parallel_sgd.make_stacked_train_step``).

    Under a mesh context the arguments are this rank's blocks, laid out
    with the member dim over ``pod`` (``sharding.with_member_dim`` under
    the dry run's ``MULTIPOD_RULES``): each of this pod slot's members
    steps under the default rules on the same mesh, as the reference's
    ``spmd_axis_name="pod"`` lowering traces its step with no rules of
    its own, so its collectives run over ``data`` and ``model`` within
    the pod and none over ``pod``."""
    stacked = make_stacked_train_step(
        make_train_step(cfg, optimizer, lr_schedule, clip))

    def member_step(params, opt_state, steps, batch):
        frame = ctx.current()
        if frame is None:
            return stacked(params, opt_state, steps, batch)
        with ctx.use_mesh_rules(frame.mesh) as inner:
            inner.sizes.update(frame.sizes)
            return stacked(params, opt_state, steps, batch)

    return member_step


def make_average_step(weights=None, group=None):
    """The Reduce (Alg. 2 lines 18-20): the mean over the member dim,
    broadcast back as every member's next-round init — the rounds contract,
    weighted by ``weights`` (one per member of the whole run; normalised)
    or uniform.

    ``group=None``: the member-dim mean of one process. With a process
    group (``torch.distributed``, each rank holding an equal slice of the
    members in rank order) the whole tree's mean is ONE all-reduce
    (``averaging.psum_weighted_mean_members``, counted by
    ``distributed.collectives`` under ``pod``) — where the reference
    shard_maps over a mesh's 'pod' axis. On an LM mesh the group is the
    ``pod`` axis's (``LMMesh.group("pod")``) and the tree is this rank's
    blocks: the ranks of one (data, model) coordinate hold the same
    blocks of every member, so the mean of the blocks is the block of
    the mean."""
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
    if cfg.is_encoder_only:
        # encoder-only "prefill" = the full encode, logits out, no cache
        def encode_step(params, batch):
            logits, _ = api.module_of(cfg).forward(cfg, params, batch)
            return logits
        return encode_step

    def prefill_step(params, batch):
        return api.prefill(cfg, params, batch)

    return prefill_step


def init_train_state(cfg, optimizer, generator, dtype=torch.bfloat16,
                     device="cuda"):
    """(params, optimizer state, step 0) of a fresh model."""
    params = api.init_params(cfg, generator, dtype, device)
    return params, optimizer.init(params), 0
