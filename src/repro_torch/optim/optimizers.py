"""Minimal functional optimizers over trees of tensors — the port's
counterpart of ``repro.optim.optimizers``.

The API is the reference's (optax's): ``opt.init(params) -> state``;
``opt.update(grads, state, params, step, lr) -> (updates, state)``;
``apply_updates`` adds the updates to the params. Updates and state are
f32 whatever a leaf's dtype, and ``apply_updates`` casts each new leaf back
to its own dtype, as the reference does. ``lr`` is a Python or numpy
scalar (the port's schedules give numpy f32), ``step`` the 0-based step.

``step_leafwise`` runs ``update`` and ``apply_updates`` one leaf at a time,
and a large leaf one slice of its leading dim at a time, freeing each
gradient as it goes: the same values, without the whole f32 update tree in
memory (32.8 GB for the 8.2 B parameters of Qwen3-8B).
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from repro_torch.distributed import ctx
from repro_torch.tree import tree_leaves, tree_map


class Optimizer(NamedTuple):
    init: Callable
    update: Callable


def _zeros_like_f32(params):
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device), params)


def _f32(x):
    """A Python float holding ``x`` rounded to f32 (a schedule's value, a
    bias correction), so that a tensor op sees the reference's f32 scalar."""
    return float(torch.tensor(float(x), dtype=torch.float32))


def sgd() -> Optimizer:
    """Plain SGD — the paper's fine-tuning optimizer (Alg. 1/2 line 8/14)."""

    def init(params):
        return ()

    def update(grads, state, params, step, lr):
        del params, step
        neg = -_f32(lr)
        return tree_map(lambda g: neg * g.float(), grads), state

    return Optimizer(init, update)


def momentum(beta: float = 0.9, nesterov: bool = False) -> Optimizer:
    def init(params):
        return _zeros_like_f32(params)

    def update(grads, state, params, step, lr):
        del params, step
        neg = -_f32(lr)
        new_state = tree_map(lambda m, g: beta * m + g.float(), state, grads)
        if nesterov:
            upd = tree_map(lambda m, g: neg * (beta * m + g.float()),
                           new_state, grads)
        else:
            upd = tree_map(lambda m: neg * m, new_state)
        return upd, new_state

    return Optimizer(init, update)


def adamw(b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
          weight_decay: float = 0.0) -> Optimizer:
    def init(params):
        return {"mu": _zeros_like_f32(params), "nu": _zeros_like_f32(params)}

    def update(grads, state, params, step, lr):
        t = torch.tensor(float(step) + 1.0, dtype=torch.float32)
        bc1 = float(1.0 - torch.pow(torch.tensor(b1, dtype=torch.float32), t))
        bc2 = float(1.0 - torch.pow(torch.tensor(b2, dtype=torch.float32), t))
        neg = -_f32(lr)
        mu = tree_map(lambda m, g: b1 * m + (1 - b1) * g.float(),
                      state["mu"], grads)
        nu = tree_map(lambda v, g: b2 * v + (1 - b2) * torch.square(
            g.float()), state["nu"], grads)

        def upd(m, v, p):
            step_ = m / bc1 / (torch.sqrt(v / bc2) + eps)
            if weight_decay:
                step_ = step_ + weight_decay * p.float()
            return neg * step_

        return tree_map(upd, mu, nu, params), {"mu": mu, "nu": nu}

    return Optimizer(init, update)


def apply_updates(params, updates):
    return tree_map(lambda p, u: (p.float() + u).to(p.dtype), params,
                    updates)


def global_norm(tree, entries=None):
    """sqrt of the sum over leaves of each leaf's f32 sum of squares, the
    leaves added in tree order from 0 as the reference's Python ``sum``.
    A leaf larger than SLICE_ELEMENTS is squared one slice at a time and
    its slices' sums added in order (a fixed order), so that no f32 copy
    of a whole large leaf is made.

    On blocks (under a mesh context): ``entries`` holds, leaf by leaf in
    tree order, the axes the leaf is sharded on (``ctx.leaf_entry``; None
    for a replicated leaf). Each sharded leaf's sum of squares is its
    block's, all-reduced over its axes — the leaves of one entry in one
    all-reduce — before the leaves are added in the same order, so a
    replicated leaf counts once, never once a rank."""
    sums = []
    for g in tree_leaves(tree):
        leaf = 0
        for sl in _slices(g):
            leaf = leaf + torch.sum(torch.square(g[sl].float()))
        sums.append(leaf)
    if entries is not None:
        for entry in dict.fromkeys(e for e in entries if e is not None):
            at = [i for i, e in enumerate(entries) if e == entry]
            summed = ctx.reduce_partial(torch.stack([sums[i] for i in at]),
                                        entry)
            for j, i in enumerate(at):
                sums[i] = summed[j]
    total = 0
    for leaf in sums:
        total = total + leaf
    return torch.sqrt(total)


def clip_scale(norm, max_norm: float):
    """The clip's f32 factor, min(1, max_norm / (norm + 1e-9))."""
    return torch.clamp(max_norm / (norm + 1e-9), max=1.0)


def clip_by_global_norm(grads, max_norm: float):
    """(grads · min(1, max_norm / (norm + 1e-9)), norm). The scale is an
    f32 array in the reference, so a bf16 gradient comes out f32 there, and
    here too."""
    norm = global_norm(grads)
    scale = clip_scale(norm, max_norm)
    return tree_map(lambda g: g.float() * scale, grads), norm


# ---------------------------------------------------------------------------
# one leaf at a time
# ---------------------------------------------------------------------------

SLICE_ELEMENTS = 1 << 26    # a leaf larger than this steps in slices


def _like(a, b) -> bool:
    """Whether tree ``a`` has the structure of tree ``b``."""
    if isinstance(b, dict):
        return isinstance(a, dict) and set(a) == set(b) and all(
            _like(a[k], b[k]) for k in b)
    if isinstance(b, (tuple, list)):
        return isinstance(a, (tuple, list)) and len(a) == len(b) and all(
            _like(x, y) for x, y in zip(a, b))
    return not isinstance(a, (dict, tuple, list))


def _map_slots(state, params, fn, at=()):
    """``state`` with each subtree shaped like ``params`` (momentum's
    trace, adamw's mu and nu; sgd has none) replaced by ``fn(subtree,
    its path in the state)``."""
    if _like(state, params):
        return fn(state, at)
    if isinstance(state, dict):
        return {k: _map_slots(v, params, fn, at + (k,))
                for k, v in state.items()}
    if isinstance(state, (tuple, list)):
        return type(state)(_map_slots(v, params, fn, at + (i,))
                           for i, v in enumerate(state))
    return state


def _paths(tree, at=()):
    if isinstance(tree, dict):
        return [p for k, v in tree.items() for p in _paths(v, at + (k,))]
    if isinstance(tree, (tuple, list)):
        return [p for i, v in enumerate(tree) for p in _paths(v, at + (i,))]
    return [at]


def _get(tree, path):
    for key in path:
        tree = tree[key]
    return tree


def _slices(a):
    """Index expressions cutting ``a`` into pieces of at most
    SLICE_ELEMENTS along its leading dim (one piece for a small leaf)."""
    if a.numel() <= SLICE_ELEMENTS or a.dim() < 2:
        return [slice(None)]
    rows = max(1, SLICE_ELEMENTS // (a.numel() // a.shape[0]))
    return [slice(i, i + rows) for i in range(0, a.shape[0], rows)]


def step_leafwise(optimizer, params, grads, state, step, lr, grad_scale=None):
    """``apply_updates(params, optimizer.update(g, state, params, step,
    lr))`` with ``g = grads · grad_scale`` (the clip's f32 scale; None: f32
    grads as given), computed one leaf at a time and a large leaf one slice
    of its leading dim at a time — the updates are elementwise, so the
    values are those of the whole-tree call. ``grads``: a list in
    ``tree_leaves(params)`` order, emptied as it goes so that each gradient
    is freed once used. Returns (new params, new state); the inputs are not
    modified."""
    paths = _paths(params)
    if len(grads) != len(paths):
        raise ValueError(f"{len(grads)} gradients for {len(paths)} leaves")
    new_leaves, new_slots = [], {}
    for i, path in enumerate(paths):
        p, g = _get(params, path), grads[i]
        grads[i] = None
        sub = _map_slots(state, params, lambda s, at: _get(s, path))
        out_p = torch.empty_like(p)
        out_sub = tree_map(torch.empty_like, sub)
        for sl in _slices(p):
            gs = g[sl].float()
            if grad_scale is not None:
                gs = gs * grad_scale
            upd, s2 = optimizer.update(gs, tree_map(lambda a: a[sl], sub),
                                       p[sl], step, lr)
            out_p[sl] = (p[sl].float() + upd).to(p.dtype)
            tree_map(lambda o, n: o[sl].copy_(n), out_sub, s2)
            del gs, upd, s2
        del g
        new_leaves.append(out_p)
        new_slots[path] = out_sub
    it = iter(new_leaves)
    new_params = tree_map(lambda _: next(it), params)

    def rebuild(slot, at):
        it = iter([_get(new_slots[path], at) for path in paths])
        return tree_map(lambda _: next(it), params)

    return new_params, _map_slots(state, params, rebuild)
