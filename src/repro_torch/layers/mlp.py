"""Feed-forward layers: SwiGLU (dense archs) and the top-k routed MoE — the
port's counterpart of ``repro.layers.mlp``.

Weights are (in, out), optionally stacked with a leading layer dim, and
applied as ``x @ W``; the MoE's experts are (E, in, out) and its router
(D, E) is f32, as in the reference.

Under a mesh context (``distributed/ctx.py``) a rank holds its blocks of
the weights as ``swiglu_logical`` / ``moe_logical`` resolve them: SwiGLU's
ff columns (``w_down``'s rows, whose product is then a partial sum,
all-reduced over ``model``), and the MoE's experts (expert parallelism).
The MoE's router logits are all-gathered over the experts before the
softmax and top-k; x is whole on every rank, so each rank builds the
dispatch itself and fills only its own experts' slots — no all-to-all.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.distributed import ctx
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


def swiglu_logical(stacked: bool = False):
    lead = ("layers",) if stacked else ()
    return {"w_gate": lead + ("embed", "ff"),
            "w_up": lead + ("embed", "ff"),
            "w_down": lead + ("ff", "embed")}


def swiglu(p, x, d_ff: int | None = None):
    """SwiGLU. ``d_ff`` is the whole ff width (default ``w_down``'s rows,
    which are the whole with no mesh context); under a context it says
    how the weights are sharded: ``h`` keeps this rank's ff columns and
    ``w_down``'s product is all-reduced over them."""
    d_ff = d_ff or p["w_down"].shape[-2]
    h = F.silu((x @ p["w_gate"]).float())
    h = h * (x @ p["w_up"]).float()
    ff = ctx.spec((d_ff, x.shape[-1]), ("ff", "embed"))[0]
    h = ctx.maybe_constrain(h.to(x.dtype), ("batch", None, "ff"),
                            have=(ctx.batch_entry(), None, ff))
    return ctx.reduce_partial(h @ p["w_down"], ff)


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


def moe_logical(stacked: bool = False):
    lead = ("layers",) if stacked else ()
    return {"router": lead + ("embed", "expert"),
            "w_gate": lead + ("expert", "embed", "ff"),
            "w_up": lead + ("expert", "embed", "ff"),
            "w_down": lead + ("expert", "ff", "embed")}


def route(p, x, experts_per_token: int, num_experts: int | None = None):
    """The router: (probs (B, S, E) f32, top_w (B, S, K) renormalised,
    top_i (B, S, K)). The top K come from a stable descending sort, so ties
    go to the lower expert id, as ``jax.lax.top_k`` breaks them. Under a
    mesh context the router's columns are this rank's experts (of
    ``num_experts``), and the logits are all-gathered over them first."""
    E = num_experts or p["router"].shape[-1]
    cols = ctx.spec((x.shape[-1], E), ("embed", "expert"))[1]
    logits = ctx.relayout(x.float() @ p["router"].float(),
                          (None, None, cols), (None, None, None))
    probs = torch.softmax(logits, dim=-1)
    top_w, top_i = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_w = top_w[..., :experts_per_token]
    top_i = top_i[..., :experts_per_token]
    return probs, top_w / top_w.sum(-1, keepdim=True), top_i


def moe_apply(p, x, experts_per_token: int, capacity_factor: float = 1.25,
              combine_sharding: str = "expert", *,
              num_experts: int | None = None, d_ff: int | None = None):
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

    ``combine_sharding`` is the reference's layout of the expert outputs
    before the combine under a mesh (``cfg.moe_combine_sharding``):
    ``"expert"`` (and ``"none"``, which the reference leaves to GSPMD)
    keeps them sharded over the experts, so each rank combines its own
    experts' outputs and the partial combines are all-reduced; ``"batch"``
    all-gathers them over the experts and every rank combines them whole.
    ``num_experts`` and ``d_ff`` are the whole sizes (default the
    router's columns and ``w_down``'s rows, which are the whole with no
    mesh context); under a mesh they say how the weights are sharded.
    With no mesh context ``combine_sharding`` changes nothing.

    R6 (ROADMAP): the reference's ``.at[sorted_e, pos_in_e].set(vals,
    mode="drop")`` (``mlp.py:96-105``) sends a dropped slot to (e, 0) with
    a zero value, and on the CPU the last duplicate wins, so whenever
    expert e overflows, slot (e, 0) holds zeros and the first token routed
    to e gets 0 from it at its unchanged weight. The port reproduces that
    result, deterministically on both devices.
    """
    if combine_sharding not in ("expert", "batch", "none"):
        raise ValueError(f"combine_sharding must be 'expert', 'batch' or "
                         f"'none', got {combine_sharding!r}")
    B, S, D = x.shape
    K = experts_per_token
    E = num_experts or p["router"].shape[-1]
    d_ff = d_ff or p["w_down"].shape[-2]
    be = ctx.batch_entry()
    ex, _, ff = ctx.spec((E, D, d_ff), ("expert", "embed", "ff"))
    probs, top_w, top_i = route(p, x, K, E)
    El = p["w_gate"].shape[0]
    e0 = ctx.index(ex) * El
    C = moe_capacity(S, E, K, capacity_factor)

    # dispatch: the reference's dispatch_row, over the batch dim; this
    # rank fills the slots of experts [e0, e0 + El)
    flat_e = top_i.reshape(B, S * K)
    order = torch.argsort(flat_e, dim=-1, stable=True)
    counts = torch.zeros((B, E), dtype=torch.int64, device=x.device)
    counts.scatter_add_(1, flat_e, torch.ones_like(flat_e))
    starts = torch.cumsum(counts, dim=-1) - counts
    token_idx = order // K
    # slot (b, e, c) holds sorted entry starts[b, e] + c where c < counts
    slot = torch.arange(C, device=x.device)
    mine = counts[:, e0:e0 + El]
    filled = slot < mine[..., None]                            # (B, El, C)
    filled[..., 0] &= mine <= C                                # R6
    src = (starts[:, e0:e0 + El, None] + slot).clamp(max=S * K - 1)
    tok = torch.gather(token_idx, 1, src.reshape(B, El * C))
    buf = torch.gather(x, 1, tok[..., None].expand(B, El * C, D))
    buf = torch.where(filled.reshape(B, El * C, 1), buf,
                      torch.zeros((), dtype=x.dtype, device=x.device))

    # the experts: (El, B·C, D) batched products
    buf = ctx.maybe_constrain(buf.reshape(B, El, C, D),
                              ("batch", "expert", None, None),
                              have=(be, ex, None, None))
    buf = buf.reshape(B, El, C, D).transpose(0, 1).reshape(El, B * C, D)
    h = F.silu(torch.bmm(buf, p["w_gate"]).float()).to(x.dtype)
    h = h * torch.bmm(buf, p["w_up"]).to(x.dtype)
    out = torch.bmm(h, p["w_down"]).reshape(El, B, C, D)
    out = ctx.reduce_partial(out, ff)
    if combine_sharding == "batch" and El < E:
        out = ctx.relayout(out, (ex, be, None, None), (None, be, None, None))
        e0, El, ex = 0, E, None

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
    if El < E:
        # this rank's experts only; the others' choices weigh 0 here
        here = (e_sorted >= e0) & (e_sorted < e0 + El)
        w = w * here.float()
        e_sorted = torch.where(here, e_sorted - e0,
                               torch.zeros_like(e_sorted))
    contrib = out[e_sorted, b_idx, pos].float() * w[..., None]  # (B,S,K,D)
    y = torch.zeros((B, S, D), dtype=torch.float32, device=x.device)
    for j in range(K):
        y = y + contrib[:, :, j]
    y = ctx.reduce_partial(y, ex)
    y = ctx.maybe_constrain(y, ("batch", None, None), have=(be, None, None))

    # router aux loss (Switch-style load balance)
    frac = counts.float().mean(0) / (S * K)
    mean_prob = probs.mean(dim=(0, 1))
    aux = E * torch.sum(frac * mean_prob)
    return y.to(x.dtype), aux
