"""Mamba2 mixer (SSD — state-space duality, chunked matmul form), the
port's counterpart of ``repro.layers.ssm``.

The sequence is processed in chunks of Q steps: intra-chunk work is
(Q x Q) masked products and inter-chunk work a short loop over chunk
states. Shapes: batch B, seq S, heads H, head_dim P, state N,
d_inner = H*P. A single B/C group (G=1). Decays are scalar per head,
negative in log space, so every exponential here is <= 1.

As in the reference, the short depthwise causal conv is width 4 and
applied to the x branch only (decode carries a 3-step conv state). The
gate norm ``rms_norm(y·silu(z), gate_norm)`` goes through the rmsnorm
kernel on the card; the rest is plain PyTorch, as the reference leaves it
to XLA.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch import resolve_device
from repro_torch.layers.init import normal
from repro_torch.layers.norms import rms_norm

CONV_W = 4


def softplus(x):
    """``jax.nn.softplus``: log1p(exp(−|x|)) + max(x, 0), written out
    (torch's ``F.softplus`` switches to x above a threshold)."""
    return torch.log1p(torch.exp(-torch.abs(x))) + torch.clamp(x, min=0)


def d_inner_of(cfg):
    return cfg.ssm_heads * cfg.ssm_head_dim


def init_mamba2(cfg, generator, dtype=torch.bfloat16,
                num_layers: int | None = None, device="cuda"):
    lead = () if num_layers is None else (num_layers,)
    device = resolve_device(device)
    D, H, P, N = cfg.d_model, cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state
    din = H * P
    in_dim = 2 * din + 2 * N + H  # z, x, B, C, dt
    f32 = dict(dtype=torch.float32, device=device)
    return {
        "in_proj": normal(generator, lead + (D, in_dim), D ** -0.5, dtype,
                          device),
        "conv_w": normal(generator, lead + (CONV_W, din), 0.5, dtype,
                         device),
        "A_log": torch.zeros(lead + (H,), **f32),
        "dt_bias": torch.zeros(lead + (H,), **f32),
        "D_skip": torch.ones(lead + (H,), **f32),
        "gate_norm": torch.ones(lead + (din,), **f32),
        "out_proj": normal(generator, lead + (din, D), din ** -0.5, dtype,
                           device),
    }


def mamba2_logical(stacked: bool = False):
    lead = ("layers",) if stacked else ()
    return {
        "in_proj": lead + ("embed", "ssm_heads"),
        "conv_w": lead + (None, "ssm_heads"),
        "A_log": lead + ("ssm_heads",),
        "dt_bias": lead + ("ssm_heads",),
        "D_skip": lead + ("ssm_heads",),
        "gate_norm": lead + ("ssm_heads",),
        "out_proj": lead + ("ssm_heads", "embed"),
    }


def mamba2_state_logical():
    return {"h": ("batch", "ssm_heads", None, None),
            "conv": ("batch", None, "ssm_heads")}


def _split_proj(cfg, proj):
    H, P, N = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state
    din = H * P
    return torch.split(proj, [din, din, N, N, H], dim=-1)


def _causal_conv(xs, conv_w, conv_state=None):
    """Depthwise causal conv, width CONV_W. xs: (B, S, din). Each product
    and sum rounds in xs's dtype, in the reference's order."""
    if conv_state is None:
        pad = torch.zeros((xs.shape[0], CONV_W - 1, xs.shape[2]),
                          dtype=xs.dtype, device=xs.device)
    else:
        pad = conv_state  # (B, CONV_W-1, din)
    xp = torch.cat([pad, xs], dim=1)
    S = xs.shape[1]
    out = sum(xp[:, i:i + S] * conv_w[i] for i in range(CONV_W))
    new_state = xp[:, -(CONV_W - 1):]
    return F.silu(out.float()).to(xs.dtype), new_state


def _gate(cfg, p, y, z, dtype):
    """rms_norm(y·silu(z), gate_norm), the products in the model's dtype."""
    return rms_norm(y.to(dtype) * F.silu(z.float()).to(dtype),
                    p["gate_norm"], cfg.norm_eps)


def mamba2_forward(cfg, p, x, h0=None):
    """Full-sequence chunked SSD. x: (B, S, D). Returns
    (y, {"h": h_final, "conv": conv_state}), the state that seeds decoding.
    S is padded to a multiple of cfg.ssm_chunk with dt = 0 (decay 1, no
    state contribution), so the final state is exact."""
    B_, S, D = x.shape
    H, P, N, Q = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state, cfg.ssm_chunk
    S_orig = S
    if S % Q:
        pad = Q - S % Q
        x = F.pad(x, (0, 0, 0, pad))
        S = S + pad
    M = S // Q

    proj = x @ p["in_proj"]
    z, xs, Bm, Cm, dt_raw = _split_proj(cfg, proj)
    xs, conv_state = _causal_conv(xs, p["conv_w"])

    dt = softplus(dt_raw.float() + p["dt_bias"])                   # (B,S,H)
    if S != S_orig:
        valid = (torch.arange(S, device=x.device) < S_orig)[None, :, None]
        dt = torch.where(valid, dt, torch.zeros_like(dt))
    a = -torch.exp(p["A_log"])                                     # (H,)
    g = dt * a                                                     # < 0

    xh = xs.reshape(B_, M, Q, H, P).float()
    Bc = Bm.reshape(B_, M, Q, N).float()
    Cc = Cm.reshape(B_, M, Q, N).float()
    dtc = dt.reshape(B_, M, Q, H)
    gc = g.reshape(B_, M, Q, H)
    cum = torch.cumsum(gc, dim=2)                                  # (B,M,Q,H)

    # intra-chunk: scores[i,j] = exp(cum_i - cum_j) (C_i . B_j) dt_j, j <= i
    L = torch.exp(cum[:, :, :, None, :] - cum[:, :, None, :, :])   # (B,M,Q,Q,H)
    idx = torch.arange(Q, device=x.device)
    tri = (idx[None, :] <= idx[:, None])[None, None, :, :, None]
    L = torch.where(tri, L, torch.zeros_like(L))
    CB = torch.einsum("bmin,bmjn->bmij", Cc, Bc)                   # (B,M,Q,Q)
    scores = CB[..., None] * L * dtc[:, :, None, :, :]             # (B,M,Q,Q,H)
    y_intra = torch.einsum("bmijh,bmjhp->bmihp", scores, xh)

    # chunk states: h_chunk = sum_j exp(cum_Q - cum_j) dt_j x_j (x) B_j
    decay_to_end = torch.exp(cum[:, :, -1:, :] - cum)              # (B,M,Q,H)
    w = decay_to_end * dtc
    h_chunk = torch.einsum("bmqh,bmqhp,bmqn->bmhpn", w, xh, Bc)    # (B,M,H,P,N)
    chunk_decay = torch.exp(cum[:, :, -1, :])                      # (B,M,H)

    # inter-chunk scan over M chunks: the state before each chunk
    h = (torch.zeros((B_, H, P, N), dtype=torch.float32, device=x.device)
         if h0 is None else h0)
    h_prevs = []
    for m in range(M):
        h_prevs.append(h)
        h = chunk_decay[:, m, :, None, None] * h + h_chunk[:, m]
    h_final = h
    h_prevs = torch.stack(h_prevs, dim=1)                          # (B,M,H,P,N)

    # inter-chunk contribution: y_inter[i] = exp(cum_i) C_i . h_prev
    y_inter = torch.einsum("bmqh,bmqn,bmhpn->bmqhp", torch.exp(cum), Cc,
                           h_prevs)

    y = (y_intra + y_inter).reshape(B_, S, H, P)
    y = y + p["D_skip"][:, None] * xh.reshape(B_, S, H, P)
    y = _gate(cfg, p, y.reshape(B_, S, H * P), z, x.dtype)
    if S != S_orig:
        y = y[:, :S_orig]
        # the conv state holds the last real (pre-conv) inputs, not padding
        raw = _split_proj(cfg, x[:, :S_orig] @ p["in_proj"])[1]
        lead = torch.zeros((B_, max(CONV_W - 1 - S_orig, 0), raw.shape[-1]),
                           dtype=raw.dtype, device=raw.device)
        conv_state = torch.cat([lead, raw], dim=1)[:, -(CONV_W - 1):]
    return y @ p["out_proj"], {"h": h_final, "conv": conv_state}


def mamba2_init_state(cfg, batch: int, device="cuda"):
    device = resolve_device(device)
    H, P, N = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state
    din = H * P
    return {"h": torch.zeros((batch, H, P, N), dtype=torch.float32,
                             device=device),
            "conv": torch.zeros((batch, CONV_W - 1, din),
                                dtype=torch.bfloat16, device=device)}


def mamba2_decode(cfg, p, x, state):
    """Single-token step. x: (B, 1, D). Returns (y, new_state)."""
    H, P = cfg.ssm_heads, cfg.ssm_head_dim
    proj = x @ p["in_proj"]
    z, xs, Bm, Cm, dt_raw = _split_proj(cfg, proj)
    xs, conv_state = _causal_conv(xs, p["conv_w"], state["conv"])

    dt = softplus(dt_raw.float() + p["dt_bias"])                   # (B,1,H)
    a = -torch.exp(p["A_log"])
    decay = torch.exp(dt * a)[:, 0]                                # (B,H)

    xh = xs.reshape(-1, H, P).float()
    Bv = Bm[:, 0].float()                                          # (B,N)
    Cv = Cm[:, 0].float()
    dx = dt[:, 0, :, None] * xh                                    # (B,H,P)
    h = decay[:, :, None, None] * state["h"] + torch.einsum(
        "bhp,bn->bhpn", dx, Bv)
    y = torch.einsum("bn,bhpn->bhp", Cv, h)
    y = y + p["D_skip"][:, None] * xh
    y = _gate(cfg, p, y.reshape(x.shape[0], 1, H * P), z, x.dtype)
    return y @ p["out_proj"], {"h": h, "conv": conv_state}
