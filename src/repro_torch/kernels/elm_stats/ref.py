"""Plain PyTorch version of the fused ELM-statistics kernel (paper Eq. 3/4).

The same function as ``csrc/elm_stats.cu``: per member, one (L, L+C) block
``Hmᵀ·[H | T]`` with ``Hm = diag(m)·H`` — U = Hᵀdiag(m)H in the first L
columns, V = Hᵀdiag(m)T in the last C. The row weights scale the left
operand only, so they enter once: binary masks drop rows, fractional
masks weight them, never squared.
"""
from __future__ import annotations

import torch


def elm_stats_ref(h, t, mask=None):
    """h: (k, n, L), t: (k, n, C), mask: optional (k, n) row weights
    -> (k, L, L+C) f32.

    One matrix product per member on freshly built operands, so a member's
    block does not depend on how many members ride beside it."""
    out = []
    for i in range(h.shape[0]):
        hi = h[i].float()
        hm = hi if mask is None else hi * mask[i].float()[:, None]
        out.append(hm.T @ torch.cat([hi, t[i].float()], dim=1))
    return torch.stack(out)
