"""Feed-forward layers: SwiGLU (dense archs) and the top-k routed MoE — the
port's counterpart of ``repro.layers.mlp``.

Weights are (in, out), optionally stacked with a leading layer dim, and
applied as ``x @ W``; the MoE's experts are (E, in, out) and its router
(D, E) is f32, as in the reference.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.layers.init import normal


def init_swiglu(d_model: int, d_ff: int, generator, dtype=torch.bfloat16,
                num_layers: int | None = None, device="cuda"):
    lead = () if num_layers is None else (num_layers,)
    return {
        "w_gate": normal(generator, lead + (d_model, d_ff), d_model ** -0.5,
                         dtype, device),
        "w_up": normal(generator, lead + (d_model, d_ff), d_model ** -0.5,
                       dtype, device),
        "w_down": normal(generator, lead + (d_ff, d_model), d_ff ** -0.5,
                         dtype, device),
    }


def swiglu(p, x):
    h = F.silu((x @ p["w_gate"]).float())
    h = h * (x @ p["w_up"]).float()
    return h.to(x.dtype) @ p["w_down"]


# ---------------------------------------------------------------------------
# Mixture of Experts (token-choice top-k router, capacity dispatch)
# ---------------------------------------------------------------------------

def init_moe(d_model: int, d_ff: int, num_experts: int, generator,
             dtype=torch.bfloat16, num_layers: int | None = None,
             device="cuda"):
    lead = () if num_layers is None else (num_layers,)
    E = num_experts
    return {
        "router": normal(generator, lead + (d_model, E), d_model ** -0.5,
                         torch.float32, device),
        "w_gate": normal(generator, lead + (E, d_model, d_ff),
                         d_model ** -0.5, dtype, device),
        "w_up": normal(generator, lead + (E, d_model, d_ff),
                       d_model ** -0.5, dtype, device),
        "w_down": normal(generator, lead + (E, d_ff, d_model),
                         d_ff ** -0.5, dtype, device),
    }


def moe_capacity(S: int, E: int, K: int, capacity_factor: float) -> int:
    """Slots per expert and batch row: max(1, min(int(S·K/E·cf), S·K))."""
    return max(1, min(int(S * K / E * capacity_factor), S * K))


def route(p, x, experts_per_token: int):
    """The router: (probs (B, S, E) f32, top_w (B, S, K) renormalised,
    top_i (B, S, K)). The top K come from a stable descending sort, so ties
    go to the lower expert id, as ``jax.lax.top_k`` breaks them."""
    logits = x.float() @ p["router"].float()
    probs = torch.softmax(logits, dim=-1)
    top_w, top_i = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_w = top_w[..., :experts_per_token]
    top_i = top_i[..., :experts_per_token]
    return probs, top_w / top_w.sum(-1, keepdim=True), top_i


def moe_apply(p, x, experts_per_token: int, capacity_factor: float = 1.25):
    """Token-choice top-k MoE with per-row capacity dispatch, the
    reference's ``moe_apply`` (``layers/mlp.py:69-137``) op by op: each
    batch row's S·K choices are stably sorted by expert, the first C of
    each expert fill its slots and the rest are dropped; the expert
    products run on the (B, E, C, D) buffer; each token sums its kept
    slots' outputs times its router weights in f32. Returns (y in x's
    dtype, the Switch load-balance aux loss).

    Where the reference scatters (its buffer and its combine), this
    gathers, so that a run on the card is bitwise the same run after run:
    the buffer is read from the kept slots, whose indices are unique, and
    each token adds its K contributions in ascending expert id, the order
    of the reference's scatter-add over the stably sorted slots.

    R6 (ROADMAP): the reference's ``.at[sorted_e, pos_in_e].set(vals,
    mode="drop")`` (``mlp.py:96-105``) sends a dropped slot to (e, 0) with
    a zero value, and on the CPU the last duplicate wins, so whenever
    expert e overflows, slot (e, 0) holds zeros and the first token routed
    to e gets 0 from it at its unchanged weight. The port reproduces that
    result, deterministically on both devices.
    """
    B, S, D = x.shape
    E = p["router"].shape[-1]
    K = experts_per_token
    C = moe_capacity(S, E, K, capacity_factor)
    probs, top_w, top_i = route(p, x, K)

    # dispatch: the reference's dispatch_row, over the batch dim
    flat_e = top_i.reshape(B, S * K)
    order = torch.argsort(flat_e, dim=-1, stable=True)
    counts = torch.zeros((B, E), dtype=torch.int64, device=x.device)
    counts.scatter_add_(1, flat_e, torch.ones_like(flat_e))
    starts = torch.cumsum(counts, dim=-1) - counts
    token_idx = order // K
    # slot (b, e, c) holds sorted entry starts[b, e] + c where c < counts
    slot = torch.arange(C, device=x.device)
    filled = slot < counts[..., None]                          # (B, E, C)
    filled[..., 0] &= counts <= C                              # R6
    src = (starts[..., None] + slot).clamp(max=S * K - 1)
    tok = torch.gather(token_idx, 1, src.reshape(B, E * C))
    buf = torch.gather(x, 1, tok[..., None].expand(B, E * C, D))
    buf = torch.where(filled.reshape(B, E * C, 1), buf,
                      torch.zeros((), dtype=x.dtype, device=x.device))

    # the experts: (E, B·C, D) batched products
    buf = buf.reshape(B, E, C, D).transpose(0, 1).reshape(E, B * C, D)
    h = F.silu(torch.bmm(buf, p["w_gate"]).float()).to(x.dtype)
    h = h * torch.bmm(buf, p["w_up"]).to(x.dtype)
    out = torch.bmm(h, p["w_down"]).reshape(E, B, C, D)

    # combine: each choice's slot, from the inverse of the sort
    rank = torch.empty_like(order)
    rank.scatter_(1, order, torch.arange(S * K, device=x.device)
                  .expand(B, S * K).contiguous())
    pos = rank - torch.gather(starts, 1, flat_e)               # (B, S·K)
    keep = (pos < C).reshape(B, S, K)
    pos = torch.where(pos < C, pos, torch.zeros_like(pos)).reshape(B, S, K)
    e_sorted, perm = torch.sort(top_i, dim=-1)                 # ascending e
    pos = torch.gather(pos, -1, perm)
    w = (torch.gather(top_w, -1, perm)
         * torch.gather(keep, -1, perm).float())
    b_idx = torch.arange(B, device=x.device)[:, None, None]
    contrib = out[e_sorted, b_idx, pos].float() * w[..., None]  # (B,S,K,D)
    y = torch.zeros((B, S, D), dtype=torch.float32, device=x.device)
    for j in range(K):
        y = y + contrib[:, :, j]

    # router aux loss (Switch-style load balance)
    frac = counts.float().mean(0) / (S * K)
    mean_prob = probs.mean(dim=(0, 1))
    aux = E * torch.sum(frac * mean_prob)
    return y.to(x.dtype), aux
