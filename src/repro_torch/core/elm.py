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
    # the reference rounds the activation to h's dtype, then sums in f32
    h, t = h.float(), t.float()
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


def _cho_solve_beta(u, v, lam: float, infos=None):
    """β = (I/λ + U)⁻¹ V: one Cholesky factorisation, reused for both
    triangular solves. Accepts unbatched (L, L)/(L, C) or member-stacked
    (k, L, L)/(k, L, C) operands.

    Each member is solved on its own, as a batch of one: the library picks
    its batched factorisation by the batch size, and at cond(I/λ + U) ~1e5
    the two roundings put β 2.6e-3 apart (measured on the H100), which the
    SGD epochs carry into the weights. One member at a time, a member's β
    is the same bits whether k members ride beside it (the stacked Map) or
    none (the sequential one).

    The factorisation's ``info`` (nonzero where a matrix is not positive
    definite) is checked at once, which makes the host wait for the
    device; or, where ``infos`` is a list, appended to it for the caller
    to check later with ``check_factorisations``, so the SGD epochs, which
    solve once a batch, wait once an epoch."""
    L = u.shape[-1]
    eye = torch.eye(L, dtype=torch.float32, device=u.device) / lam
    batched = u.dim() == 3
    if not batched:
        u, v = u[None], v[None]
    out, found = [], []
    for i in range(u.shape[0]):
        f, info = torch.linalg.cholesky_ex((u[i] + eye)[None])
        found.append(info)
        y = torch.linalg.solve_triangular(f, v[i:i + 1], upper=False)
        out.append(torch.linalg.solve_triangular(f.mT, y, upper=True))
    if infos is None:
        check_factorisations(found)
    else:
        infos.extend(found)
    b = torch.cat(out)
    return b if batched else b[0]


def check_factorisations(infos):
    """Raise ``torch.linalg.LinAlgError`` if any of the Cholesky ``info``
    tensors is nonzero (one wait for the device for all of them)."""
    if infos and bool(torch.stack([i.reshape(-1) for i in infos]).any()):
        raise torch.linalg.LinAlgError(
            "I/λ + U is not positive definite: its Cholesky factorisation "
            "failed")


def solve_beta(stats: ELMStats, lam: float, infos=None):
    """Reduce step, Eq. 5: β = (I/λ + U)⁻¹ V via Cholesky (SPD for λ>0).
    Member-stacked stats give member-stacked β, one solve per member.
    ``infos``: see ``_cho_solve_beta``."""
    return _cho_solve_beta(stats.u, stats.v, lam, infos)


def elm_loss(h, beta, t, *, activation: bool = True):
    """Paper Eq. 16: J = 1/2 ||H(z)β − T||² (mean over batch)."""
    if activation:
        h = optimal_tanh(h)
    r = h.float() @ beta - t.float()
    return 0.5 * torch.mean(torch.sum(r * r, dim=-1))


def member_losses(h, beta, t, *, activation: bool = True):
    """``elm_loss`` of each member at once: h (k, n, L), β (k, L, C), t (k,
    n, C) -> (k,), member i's mean over its own n rows — so the gradient of
    the sum is each member's own gradient. Hβ is one matrix product per
    member, forward and backward: a batched product may round by the
    batch size, and the SGD epochs amplify one rounding into the weights,
    so a member's gradient is the same bits for any k."""
    if activation:
        h = optimal_tanh(h)
    h = h.float()
    r = torch.stack([h[i] @ beta[i] for i in range(h.shape[0])]) - t.float()
    return 0.5 * torch.mean(torch.sum(r * r, dim=-1), dim=-1)


def predict(h, beta, *, activation: bool = True):
    if activation:
        h = optimal_tanh(h)
    return h.float() @ beta


def accuracy(scores, labels):
    return torch.mean((torch.argmax(scores, dim=-1) == labels).float())
