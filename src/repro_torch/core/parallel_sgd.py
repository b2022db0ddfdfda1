"""SimuParallelSGD (Zinkevich et al., the paper's Alg. 1) and its stacked
form — the port's counterpart of ``repro.core.parallel_sgd``.

``simu_parallel_sgd``: k members, disjoint data iterators, no
communication until the final weight average — exactly the paper.
``avg_period`` (τ) generalises it: τ=None is the single final Reduce, τ=1
synchronous data-parallel SGD, intermediate τ local SGD / FedAvg.

``make_stacked_train_step`` / ``stacked_average``: the members on a
leading dim of every leaf. The reference vmaps the member step; the port
loops over the members in order (its kernels are ctypes launches), and
the Reduce is one mean over the member dim, broadcast back.
"""
from __future__ import annotations

from typing import Callable, List, Optional, Sequence

import torch

from repro_torch.core.averaging import (average_member_dim, average_trees,
                                        broadcast_member_dim)
from repro_torch.tree import tree_leaves, tree_map


def simu_parallel_sgd(init_params, train_step: Callable, data_iters: Sequence,
                      num_steps: int, *, avg_period: Optional[int] = None,
                      carry_states: Optional[List] = None):
    """train_step: (params, state, batch) -> (params, state, metrics).
    Returns (averaged params, member params, metrics history)."""
    k = len(data_iters)
    members = [init_params] * k
    states = carry_states if carry_states is not None else [None] * k
    history = []
    for step in range(num_steps):
        outs = [train_step(members[i], states[i], next(data_iters[i]))
                for i in range(k)]
        members = [o[0] for o in outs]
        states = [o[1] for o in outs]
        history.append([o[2] for o in outs])
        if avg_period and (step + 1) % avg_period == 0:
            avg = average_trees(members)
            members = [avg] * k
    return average_trees(members), members, history


def make_stacked_train_step(member_step: Callable):
    """Lift ``(params, opt_state, step, batch) -> (params, opt_state, step,
    metrics)`` over a leading member dim of all four (steps: a sequence),
    member by member in order; metrics come back stacked."""

    def stacked_step(params, opt_state, steps, batch):
        k = tree_leaves(params)[0].shape[0]
        outs = [member_step(*(tree_map(lambda a, i=i: a[i], t)
                              for t in (params, opt_state)), steps[i],
                            tree_map(lambda a, i=i: a[i], batch))
                for i in range(k)]

        def stack(j):
            return tree_map(lambda *xs: torch.stack([torch.as_tensor(x)
                                                     for x in xs]),
                            *[o[j] for o in outs])
        return stack(0), stack(1), [o[2] for o in outs], stack(3)

    return stacked_step


def stacked_average(stacked_params):
    """The Reduce over the member dim, broadcast back so that every member
    starts the next round from the averaged weights."""
    k = tree_leaves(stacked_params)[0].shape[0]
    return broadcast_member_dim(average_member_dim(stacked_params), k)
