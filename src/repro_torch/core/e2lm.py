"""E²LM — Elastic ELM via MapReduce (paper §2.2, Eq. 3-5; Xin et al. 2015).
The port's counterpart of ``repro.core.e2lm``.

* ``reduce_stats``    — host-level sum over a list of per-shard stats (the
                        literal MapReduce of the paper), added in list order.
* ``psum_stats``      — the sum over the ranks of a member mesh: each rank
                        holds the stats of its local rows, and U, V and n
                        go in one flat all-reduce (exact, one collective).
                        The mesh Map's global readout is built on it
                        (``executor.MeshExecutor.e2lm_global_beta``).
* ``mapreduce_solve`` — reduce, then one β solve.
* ``OSELMState``      — OS-ELM (Liang et al. 2006): the sequential/streaming
                        alternative the paper cites, by the Sherman-Morrison-
                        Woodbury block update.
"""
from __future__ import annotations

from typing import NamedTuple, Sequence

import torch

from repro_torch import resolve_device
from repro_torch.core.averaging import ravel
from repro_torch.core.elm import (ELMStats, add_stats, check_factorisations,
                                  solve_beta)
from repro_torch.distributed import collectives
from repro_torch.layers.norms import optimal_tanh


def reduce_stats(shards: Sequence[ELMStats]) -> ELMStats:
    out = shards[0]
    for s in shards[1:]:
        out = add_stats(out, s)
    return out


def psum_stats(local: ELMStats, group=None, label: str = "pod") -> ELMStats:
    """The stats sum over the ranks of ``group`` (None: the default group;
    the 2-D member mesh sums over both of its axes at once, the ranks of
    the whole mesh): U, V and n raveled into one f32 vector, ONE
    all-reduce. The result is the same on every rank."""
    flat, unravel = ravel(tuple(local))
    collectives.all_reduce(flat, group, label)
    return ELMStats(*unravel(flat))


def mapreduce_solve(shards: Sequence[ELMStats], lam: float):
    """The full E²LM pipeline at host level: reduce then solve."""
    return solve_beta(reduce_stats(shards), lam)


# ---------------------------------------------------------------------------
# OS-ELM: streaming block updates (the non-MapReduce baseline the paper cites)
# ---------------------------------------------------------------------------

class OSELMState(NamedTuple):
    p: torch.Tensor     # (L, L) running (I/λ + HᵀH)⁻¹
    beta: torch.Tensor  # (L, C)


def oselm_init(num_features: int, num_classes: int, lam: float,
               device="cuda") -> OSELMState:
    """P = λI, β = 0, on the card unless ``device="cpu"``."""
    dev = resolve_device(device)
    return OSELMState(
        lam * torch.eye(num_features, dtype=torch.float32, device=dev),
        torch.zeros((num_features, num_classes), dtype=torch.float32,
                    device=dev))


def oselm_update(state: OSELMState, h, t, *,
                 activation: bool = True) -> OSELMState:
    """Woodbury block update of one block h (n, L), t (n, C):
    P ← P − P Hᵀ (I + H P Hᵀ)⁻¹ H P;  β ← β + P Hᵀ (T − H β).
    The n×n gram is factored by Cholesky; its ``info`` is checked once."""
    if activation:
        h = optimal_tanh(h)
    h = h.float()
    t = t.float()
    ph = state.p @ h.T                                   # (L, n)
    gram = h @ ph + torch.eye(h.shape[0], dtype=torch.float32,
                              device=h.device)
    f, info = torch.linalg.cholesky_ex(gram)
    check_factorisations([info])
    k = torch.cholesky_solve(ph.T, f)                    # (n, L)
    p_new = state.p - ph @ k
    beta_new = state.beta + p_new @ h.T @ (t - h @ state.beta)
    return OSELMState(p_new, beta_new)
