"""Extreme Learning Machine core (paper §2.2, Eq. 1-5) — the port's
counterpart of ``repro.core.elm``.

The ELM readout solves the ridge-regularised least squares
    β = (I/λ + U)⁻¹ V,   U = HᵀH,  V = HᵀT            (Eq. 2-5)
where H is the hidden-feature matrix (the CNN's last pooled map) after the
paper's optimal-tanh activation 1.7159·tanh(2/3·H).

Every function takes either one member's operands or the member-stacked
form with a leading member dim k (the stacked Map path). U and V come from
the fused ``kernels.elm_stats`` op (hand kernel on CUDA, plain version on
the CPU); the Cholesky solve and ``predict``'s H@β stay library calls.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch import resolve_device
from repro_torch.kernels.elm_stats import ops as stats_ops
from repro_torch.layers.norms import optimal_tanh


class ELMStats(NamedTuple):
    """Sufficient statistics of one (partial) dataset."""
    u: torch.Tensor  # (L, L) f32, or (k, L, L)
    v: torch.Tensor  # (L, C) f32, or (k, L, C)
    n: torch.Tensor  # () f32 row count, or (k,)


def zero_stats(num_features: int, num_classes: int,
               device="cuda") -> ELMStats:
    """Zero stats of one member, on the card unless ``device="cpu"``."""
    device = resolve_device(device)
    return ELMStats(
        torch.zeros((num_features, num_features), device=device),
        torch.zeros((num_features, num_classes), device=device),
        torch.zeros((), device=device))


def zero_stats_stacked(k: int, num_features: int, num_classes: int,
                       device="cuda") -> ELMStats:
    """Zero stats for k members stacked on a leading dim, on the card unless
    ``device="cpu"``."""
    device = resolve_device(device)
    return ELMStats(
        torch.zeros((k, num_features, num_features), device=device),
        torch.zeros((k, num_features, num_classes), device=device),
        torch.zeros((k,), device=device))


def batch_stats(h, t, *, activation: bool = True, mask=None) -> ELMStats:
    """Map step: stats of one batch. h: (n, L) raw features, t: (n, C) — or
    member-stacked h: (k, n, L), t: (k, n, C).

    ``mask`` (broadcastable to the rows, e.g. one validity bit per member)
    weights rows into U, V AND n: a zero entry drops the row entirely, which
    is how the padded stacked Map phase cancels padding batches."""
    if activation:
        h = optimal_tanh(h)
    rows = h.shape[:-1]
    if mask is None:
        u, v = stats_ops.elm_stats(h, t)
        return ELMStats(u, v, torch.full(rows[:-1], float(rows[-1]),
                                         device=h.device))
    mask = torch.as_tensor(mask, dtype=torch.float32, device=h.device)
    mask = mask.reshape(mask.shape + (1,) * (len(rows) - mask.dim()))
    mask = mask.expand(rows).contiguous()
    u, v = stats_ops.elm_stats(h, t, mask=mask)
    return ELMStats(u, v, mask.sum(-1))


def add_stats(a: ELMStats, b: ELMStats) -> ELMStats:
    return ELMStats(a.u + b.u, a.v + b.v, a.n + b.n)


def downdate_stats(a: ELMStats, b: ELMStats) -> ELMStats:
    """Rank-DOWNdate: remove ``b``'s contribution from ``a`` (U and V are
    plain sums over rows, so forgetting a chunk is exact subtraction of its
    recorded stats, up to f32 rounding)."""
    return ELMStats(a.u - b.u, a.v - b.v, a.n - b.n)


def _cho_solve_beta(u, v, lam: float):
    """β = (I/λ + U)⁻¹ V: one Cholesky factorisation, reused for both
    triangular solves. Accepts unbatched (L, L)/(L, C) or member-stacked
    (k, L, L)/(k, L, C) operands, and always solves batched (a unit batch
    dim is added when unbatched), as the reference does, so the sequential
    and stacked paths run one lowering."""
    L = u.shape[-1]
    a = u + torch.eye(L, dtype=torch.float32, device=u.device) / lam
    batched = a.dim() == 3
    if not batched:
        a, v = a[None], v[None]
    f = torch.linalg.cholesky(a)
    y = torch.linalg.solve_triangular(f, v, upper=False)
    b = torch.linalg.solve_triangular(f.mT, y, upper=True)
    return b if batched else b[0]


def solve_beta(stats: ELMStats, lam: float):
    """Reduce step, Eq. 5: β = (I/λ + U)⁻¹ V via Cholesky (SPD for λ>0).
    Member-stacked stats give member-stacked β in one batched solve."""
    return _cho_solve_beta(stats.u, stats.v, lam)


def elm_loss(h, beta, t, *, activation: bool = True):
    """Paper Eq. 16: J = 1/2 ||H(z)β − T||² (mean over batch)."""
    if activation:
        h = optimal_tanh(h)
    r = h.float() @ beta - t.float()
    return 0.5 * torch.mean(torch.sum(r * r, dim=-1))


def predict(h, beta, *, activation: bool = True):
    if activation:
        h = optimal_tanh(h)
    return h.float() @ beta


def accuracy(scores, labels):
    return torch.mean((torch.argmax(scores, dim=-1) == labels).float())
