"""Polyak-Ruppert averaged SGD (Polyak & Juditsky 1992) — the paper's §2.1
foundation, as an optimizer wrapper; the port's counterpart of
``repro.core.polyak``.

The paper's distributed averaging averages ACROSS machines at the end of
training; Polyak averaging averages ALONG one machine's trajectory. With
both, each member keeps its Polyak average and the Reduce averages those.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.tree import tree_leaves, tree_map


class PolyakState(NamedTuple):
    average: object          # a tree matching the params (f32)
    count: torch.Tensor      # () f32: iterates accumulated


def polyak_init(params, burn_in: int = 0) -> PolyakState:
    del burn_in
    leaf = tree_leaves(params)[0]
    return PolyakState(
        tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                       device=p.device), params),
        torch.zeros((), dtype=torch.float32, device=leaf.device))


def polyak_update(state: PolyakState, params, *, step=None,
                  burn_in: int = 0) -> PolyakState:
    """The running mean of the iterates; before ``burn_in`` steps it only
    tracks the current params (skip the transient)."""
    dev = state.count.device
    active = torch.tensor(1.0, dtype=torch.float32, device=dev)
    if step is not None:
        active = (torch.tensor(float(step), dtype=torch.float32, device=dev)
                  >= burn_in).float()
    new_count = state.count + active
    denom = torch.clamp(new_count, min=1.0)

    def upd(avg, p):
        pf = p.float()
        mean = avg + (pf - avg) * (active / denom)
        # before burn-in: shadow the raw params so early reads are sane
        return torch.where(new_count > 0, mean, pf)

    return PolyakState(tree_map(upd, state.average, params), new_count)


def polyak_params(state: PolyakState, like=None):
    """The averaged weights (cast to the dtypes of ``like``)."""
    if like is None:
        return state.average
    return tree_map(lambda a, p: a.to(p.dtype), state.average, like)
