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

Under a mesh context (``distributed/ctx.py``) the mixer runs over
``ssm_heads``, as the reference's constraint on the conv's output lays it
out: each rank runs the SSD of its heads (whole heads, or all of them
where the heads do not divide the axis), with the whole of B and C.
``conv_w``, ``A_log``, ``dt_bias``, ``D_skip``, ``gate_norm`` and the
state (h, the conv's) are this rank's heads' blocks; ``in_proj``'s
columns are gathered and this rank's taken (``_project``); the gate
norm's mean over d_inner all-reduces the blocks' sums of squares
(``_gate``); and ``out_proj``'s rows are sharded, so its partial product
is all-reduced. With no context every move is a no-op and the same lines
run the whole mixer.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch import resolve_device
from repro_torch.distributed import ctx
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


def _spec(cfg, name):
    """The spec of one (unstacked) mixer leaf under the active context."""
    D, H, P, N = cfg.d_model, cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state
    din = H * P
    shape = {"in_proj": (D, 2 * din + 2 * N + H), "conv_w": (CONV_W, din),
             "A_log": (H,), "dt_bias": (H,), "D_skip": (H,),
             "gate_norm": (din,), "out_proj": (din, D)}[name]
    return ctx.spec(shape, mamba2_logical()[name])


def _heads_entry(cfg, x):
    """The entry of the mixer's heads: the reference's constraint on the
    conv's output, ("batch", None, "ssm_heads"), taken at head
    granularity. None where the heads do not divide the axis: every rank
    then runs all of them."""
    B, S = x.shape[:2]
    return ctx.spec((ctx.global_size("batch", B), S, cfg.ssm_heads,
                     cfg.ssm_head_dim), ("batch", None, "ssm_heads", None))[2]


def _conv_entry(cfg, x):
    """The entry of the conv state's channels in the cache's layout (h is
    laid out over the heads as ``_heads_entry``; the channels are cut
    into blocks of d_inner that need not be whole heads)."""
    return ctx.spec((ctx.global_size("batch", x.shape[0]), CONV_W - 1,
                     d_inner_of(cfg)), mamba2_state_logical()["conv"])[2]


def _on_heads(cfg, p, he):
    """conv_w, A_log, dt_bias, D_skip and gate_norm on this rank's heads
    (their last dim moved from the leaf's layout to ``he``)."""
    out = {}
    for name in ("conv_w", "A_log", "dt_bias", "D_skip", "gate_norm"):
        spec = _spec(cfg, name)
        out[name] = ctx.relayout(p[name], spec, spec[:-1] + (he,))
    return out


def _project(cfg, p, x, he):
    """(z, x, B, C, dt) of ``x @ in_proj`` for this rank's heads, B and C
    whole. ``in_proj``'s columns ([z | x | B | C | dt], 2·din + 2N + H)
    are cut into blocks that do not line up with z, x or dt, so under a
    mesh context the weight's columns are gathered (34 MB a layer at
    Zamba2-1.2B's width, where the projection of rank 0's 16 × 4,096
    tokens would be 1.1 GB), and the product is taken with this rank's
    heads' columns of z, x and dt and the whole of B and C. Each rank's
    gradient of the gathered weight (and of x) is then a partial sum:
    both enter through ``ctx.into_sharded``."""
    w = ctx.gather(p["in_proj"], 1, _spec(cfg, "in_proj")[1])
    if ctx.size(he) == 1:
        return _split_proj(cfg, x @ w)
    H, P, N = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state
    din, Hl = H * P, H // ctx.size(he)
    h0 = ctx.index(he) * Hl
    w = ctx.into_sharded(w, he)
    cols = ((h0 * P, (h0 + Hl) * P), (din + h0 * P, din + (h0 + Hl) * P),
            (2 * din, 2 * din + 2 * N),
            (2 * din + 2 * N + h0, 2 * din + 2 * N + h0 + Hl))
    w = torch.cat([w[:, a:b] for a, b in cols], dim=1)
    proj = ctx.into_sharded(x, he) @ w
    return torch.split(proj, [Hl * P, Hl * P, N, N, Hl], dim=-1)


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


def _gate(cfg, p, y, z, dtype, he):
    """rms_norm(y·silu(z), gate_norm), the products in the model's dtype.
    The mean is over the whole d_inner: where this rank holds a block of
    it (``he``), the local sums of squares are all-reduced over ``he``
    and the block scaled by the whole row's factor, in plain PyTorch —
    the rmsnorm kernel normalises whole rows, so this function of a block
    is not its function. The sum is replicated and each rank's gradient
    of it a partial one, so it enters the sharded scale through
    ``ctx.into_sharded``."""
    t = y.to(dtype) * F.silu(z.float()).to(dtype)
    if ctx.size(he) == 1:
        return rms_norm(t, p["gate_norm"], cfg.norm_eps)
    tf = t.float()
    ss = ctx.reduce_partial(torch.sum(tf * tf, dim=-1, keepdim=True), he)
    var = ctx.into_sharded(ss, he) / d_inner_of(cfg)
    out = tf * torch.reciprocal(torch.sqrt(var + cfg.norm_eps)) * \
        p["gate_norm"].float()
    return out.to(dtype)


def _out_proj(cfg, p, y, he):
    """``y`` (this rank's heads, ``he``) through ``out_proj``, whose rows
    are sharded: the partial product all-reduced over them."""
    rows = _spec(cfg, "out_proj")[0]
    y = ctx.relayout(y, (None, None, he), (None, None, rows))
    y = ctx.reduce_partial(y @ p["out_proj"], rows)
    return ctx.maybe_constrain(y, ("batch", None, None),
                               have=(ctx.batch_entry(), None, None))


def mamba2_forward(cfg, p, x, h0=None):
    """Full-sequence chunked SSD. x: (B, S, D). Returns
    (y, {"h": h_final, "conv": conv_state}), the state that seeds decoding.
    S is padded to a multiple of cfg.ssm_chunk with dt = 0 (decay 1, no
    state contribution), so the final state is exact. Under a mesh
    context this rank runs its heads (the module's docstring) and the
    state comes out in the cache's layout."""
    B_, S, D = x.shape
    H, P, N, Q = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state, cfg.ssm_chunk
    he = _heads_entry(cfg, x)
    H = H // ctx.size(he)
    hp = _on_heads(cfg, p, he)
    S_orig = S
    if S % Q:
        pad = Q - S % Q
        x = F.pad(x, (0, 0, 0, pad))
        S = S + pad
    M = S // Q

    z, xs_raw, Bm, Cm, dt_raw = _project(cfg, p, x, he)
    xs, conv_state = _causal_conv(xs_raw, hp["conv_w"])

    dt = softplus(dt_raw.float() + hp["dt_bias"])                  # (B,S,H)
    if S != S_orig:
        valid = (torch.arange(S, device=x.device) < S_orig)[None, :, None]
        dt = torch.where(valid, dt, torch.zeros_like(dt))
    a = -torch.exp(hp["A_log"])                                    # (H,)
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
    y = y + hp["D_skip"][:, None] * xh.reshape(B_, S, H, P)
    y = _gate(cfg, hp, y.reshape(B_, S, H * P), z, x.dtype, he)
    if S != S_orig:
        y = y[:, :S_orig]
        # the conv state holds the last real (pre-conv) inputs, not padding
        raw = xs_raw[:, :S_orig]
        lead = torch.zeros((B_, max(CONV_W - 1 - S_orig, 0), raw.shape[-1]),
                           dtype=raw.dtype, device=raw.device)
        conv_state = torch.cat([lead, raw], dim=1)[:, -(CONV_W - 1):]
    return _out_proj(cfg, p, y, he), {
        "h": h_final, "conv": ctx.relayout(conv_state, (None, None, he),
                                           (None, None, _conv_entry(cfg, x)))}


def mamba2_init_state(cfg, batch: int, device="cuda"):
    device = resolve_device(device)
    H, P, N = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state
    din = H * P
    return {"h": torch.zeros((batch, H, P, N), dtype=torch.float32,
                             device=device),
            "conv": torch.zeros((batch, CONV_W - 1, din),
                                dtype=torch.bfloat16, device=device)}


def mamba2_decode(cfg, p, x, state):
    """Single-token step. x: (B, 1, D). Returns (y, new_state); under a
    mesh context on this rank's heads, the state in the cache's layout."""
    H, P = cfg.ssm_heads, cfg.ssm_head_dim
    he = _heads_entry(cfg, x)
    H = H // ctx.size(he)
    hp = _on_heads(cfg, p, he)
    conv_ent = _conv_entry(cfg, x)
    z, xs, Bm, Cm, dt_raw = _project(cfg, p, x, he)
    xs, conv_state = _causal_conv(
        xs, hp["conv_w"], ctx.relayout(state["conv"], (None, None, conv_ent),
                                       (None, None, he)))

    dt = softplus(dt_raw.float() + hp["dt_bias"])                  # (B,1,H)
    a = -torch.exp(hp["A_log"])
    decay = torch.exp(dt * a)[:, 0]                                # (B,H)

    xh = xs.reshape(-1, H, P).float()
    Bv = Bm[:, 0].float()                                          # (B,N)
    Cv = Cm[:, 0].float()
    dx = dt[:, 0, :, None] * xh                                    # (B,H,P)
    h = decay[:, :, None, None] * state["h"] + torch.einsum(
        "bhp,bn->bhpn", dx, Bv)
    y = torch.einsum("bn,bhpn->bhp", Cv, h)
    y = y + hp["D_skip"][:, None] * xh
    y = _gate(cfg, hp, y.reshape(x.shape[0], 1, H * P), z, x.dtype, he)
    return _out_proj(cfg, p, y, he), {
        "h": h, "conv": ctx.relayout(conv_state, (None, None, he),
                                     (None, None, conv_ent))}
