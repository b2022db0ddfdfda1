"""RWKV6 "Finch" — attention-free linear-attention LM with data-dependent
per-channel decay [arXiv:2404.05892]; the port's counterpart of
``repro.models.rwkv6``.

Two execution modes for the WKV recurrence:
  mode="scan"    — the exact per-step recurrence (a Python loop over steps;
                   decode's path).
  mode="chunked" — the chunk-parallel masked-product form, per-channel
                   decays in log space with a clamped reference point,
                   chunk size cfg.ssm_chunk (the prefill's path).

State per layer: S (B, H, P, P) wkv matrix + token-shift carries. Head dim
P = 64, H = d_model / 64. Every op is plain PyTorch: RWKV6 reaches no TPU
kernel of the reference (its norms are layer norms and a per-head group
norm with a per-channel scale, cast to bf16 after the scale, which is not
the rmsnorm kernel's function), so on the card it runs PyTorch's own
kernels, and only the ELM head over it reaches a hand kernel (elm_stats).

Layers are stacked (a leading L dim on every leaf of ``params["layers"]``)
as in the reference; its ``layer_scan`` becomes a Python loop.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch import resolve_device
from repro_torch.distributed import ctx
from repro_torch.layers.init import normal
from repro_torch.layers.norms import layer_norm
from repro_torch.models import common

HEAD_DIM = 64
DECAY_LORA = 64
CLAMP = 30.0  # max |log-decay| offset inside a chunk (chunked mode)


def _heads(cfg):
    return cfg.d_model // HEAD_DIM


def _heads_padded(cfg):
    """Effective head count. cfg.rwkv_head_pad_to > 0 rounds H up to that
    multiple (e.g. 40 -> 48). Padded projection columns are zero and their
    gradients vanish identically (padded-head k = v = r = g = 0, so y = 0
    and every upstream gradient 0), so the padded model is exactly the
    unpadded one."""
    H = _heads(cfg)
    m = getattr(cfg, "rwkv_head_pad_to", 0)
    if m and H % m:
        return H + (m - H % m)
    return H


def init_params(cfg, generator, dtype=torch.bfloat16, device="cuda"):
    """The reference's distributions from a ``torch.Generator``, drawn on
    the generator's device and stored on ``device``."""
    dev = resolve_device(device)
    L, D, F_, V = cfg.num_layers, cfg.d_model, cfg.d_ff, cfg.vocab_size
    Hp = _heads_padded(cfg)
    Dp = Hp * HEAD_DIM  # padded time-mix width (== D when padding is off)

    def nrm(*sh):
        return normal(generator, (L,) + sh, sh[0] ** -0.5, dtype, dev)

    def pad_cols(a):  # zero the padded output channels
        if Dp != D:
            a[..., D:] = 0
        return a

    def pad_rows(a):
        if Dp != D:
            a[..., D:, :] = 0
        return a

    def full(shape, value):
        return torch.full(shape, value, dtype=torch.float32, device=dev)

    layers = {
        # time mixing
        "mu": full((L, 5, D), 0.5),               # lerp coeffs r,k,v,g,w
        "w_r": pad_cols(nrm(D, Dp)),
        "w_k": pad_cols(nrm(D, Dp)),
        "w_v": pad_cols(nrm(D, Dp)),
        "w_g": pad_cols(nrm(D, Dp)),
        "w_o": pad_rows(nrm(Dp, D)),
        "decay_base": full((L, Dp), -1.0),        # w0
        "decay_A": nrm(D, DECAY_LORA),
        "decay_B": pad_cols(nrm(DECAY_LORA, Dp)),
        "bonus_u": full((L, Hp, HEAD_DIM), 0.0),
        "ln_x": full((L, Dp), 1.0),               # per-head group-norm scale
        # channel mixing
        "mu_cm": full((L, 2, D), 0.5),
        "w_ck": nrm(D, F_),
        "w_cv": nrm(F_, D),
        "w_cr": nrm(D, D),
        # norms
        "ln1_s": full((L, D), 1.0),
        "ln1_b": full((L, D), 0.0),
        "ln2_s": full((L, D), 1.0),
        "ln2_b": full((L, D), 0.0),
    }
    return {
        "embed": normal(generator, (V, D), D ** -0.5, dtype, dev),
        "ln_out": full((D,), 1.0),
        "unembed": normal(generator, (D, V), D ** -0.5, dtype, dev),
        "layers": layers,
    }


def logical_axes(cfg):
    """The logical axes of every leaf of ``init_params(cfg)``, the
    reference's."""
    lead = ("layers",)
    layers = {
        "mu": lead + (None, "embed"),
        "w_r": lead + ("embed", "heads"),
        "w_k": lead + ("embed", "heads"),
        "w_v": lead + ("embed", "heads"),
        "w_g": lead + ("embed", "heads"),
        "w_o": lead + ("heads", "embed"),
        "decay_base": lead + ("embed",),
        "decay_A": lead + ("embed", None),
        "decay_B": lead + (None, "embed"),
        "bonus_u": lead + ("heads", None),
        "ln_x": lead + ("embed",),
        "mu_cm": lead + (None, "embed"),
        "w_ck": lead + ("embed", "ff"),
        "w_cv": lead + ("ff", "embed"),
        "w_cr": lead + ("embed", "heads"),
        "ln1_s": lead + ("embed",),
        "ln1_b": lead + ("embed",),
        "ln2_s": lead + ("embed",),
        "ln2_b": lead + ("embed",),
    }
    return {"embed": ("vocab", "embed"), "ln_out": ("embed",),
            "unembed": ("embed", "vocab"), "layers": layers}


def cache_logical(cfg):
    """The state's logical axes; its stacked layer dim is unnamed, as the
    KV cache's (``layers/attention.py`` ``kv_cache_logical``)."""
    return {"S": (None, "batch", "heads", None, None),
            "x_tm": (None, "batch", "embed"),
            "x_cm": (None, "batch", "embed")}


def _shift(x, prev=None):
    """Token shift: x_{t-1} (zeros / carried state at t=0)."""
    if prev is None:
        prev = torch.zeros_like(x[:, :1])
    return torch.cat([prev.to(x.dtype), x[:, :-1]], dim=1)


def _spec(cfg, name):
    """The spec of one (unstacked) layer leaf under the active context."""
    D, F_, Dp = cfg.d_model, cfg.d_ff, _heads_padded(cfg) * HEAD_DIM
    shape = {"mu": (5, D), "w_r": (D, Dp), "w_k": (D, Dp), "w_v": (D, Dp),
             "w_g": (D, Dp), "w_o": (Dp, D), "w_ck": (D, F_),
             "w_cr": (D, D)}[name]
    return ctx.spec(shape, logical_axes(cfg)["layers"][name][1:])


def _wkv_entry(cfg, x):
    """The entry of the WKV's heads for ``x``'s batch: the layout
    ``ctx.spec`` gives (B, S, Hp, P). None where the heads do not divide
    the axis (RWKV6-3B's 40 over model 16): every rank then runs all of
    them."""
    return ctx.spec((ctx.global_size("batch", x.shape[0]), x.shape[1],
                     _heads_padded(cfg), HEAD_DIM),
                    ("batch", None, "heads", None))[2]


def _head_cols(t, he):
    """This rank's heads' block of the last dim of ``t``, a replicated
    leaf that enters the heads-sharded computation (``ln_x``): each
    rank's gradient of it is a partial one, so it enters through
    ``ctx.into_sharded``."""
    n = ctx.size(he)
    if n == 1:
        return t
    c = t.shape[-1] // n
    i = ctx.index(he)
    return ctx.into_sharded(t, he)[..., i * c:(i + 1) * c]


def _time_mix_projections(cfg, lp, x, x_prev, he):
    """r, k, v (f32), g, and the per-step log-decay lw of this rank's
    heads (``he``); (B, S, local Hp, P). The four projections' columns
    are cut at 160 columns a rank at RWKV6-3B's width on model 16, two
    and a half heads: where the heads do not divide the axis their
    columns are gathered (13 MB a weight, where a projection of rank 0's
    tokens would be 335 MB) and every head computed; where they do, the
    rank's column block is its heads. ``lw`` is computed whole (its
    weights are replicated) and sliced."""
    B, S, D = x.shape
    H = _heads_padded(cfg) // ctx.size(he)
    xs = _shift(x, x_prev)
    mu = lp["mu"].to(x.dtype)                                  # (5, D)

    def lerp(i):
        return x + (xs - x) * mu[i]

    def proj(i, name):
        w = ctx.relayout(lp[name], _spec(cfg, name), (None, he))
        return ctx.into_sharded(lerp(i), he) @ w

    r = proj(0, "w_r")
    k = proj(1, "w_k")
    v = proj(2, "w_v")
    g = proj(3, "w_g")
    xw = lerp(4).float()
    dec = lp["decay_base"] + torch.tanh(xw @ lp["decay_A"].float()) \
        @ lp["decay_B"].float()
    lw = ctx.local_slice(-torch.exp(dec), 2, he)               # < 0
    shp = (B, S, H, HEAD_DIM)
    return (r.reshape(shp).float(), k.reshape(shp).float(),
            v.reshape(shp).float(), g, lw.reshape(shp))


def _wkv_scan(r, k, v, lw, u, s0):
    """The exact recurrence. r, k, v, lw: (B, S, H, P); u: (H, P);
    s0: (B, H, P, P). Returns (y (B, S, H, P), s_final)."""
    w = torch.exp(lw)
    s = s0
    ys = []
    for t in range(r.shape[1]):
        rt, kt, vt, wt = r[:, t], k[:, t], v[:, t], w[:, t]    # (B, H, P)
        kv = torch.einsum("bhp,bhq->bhpq", kt, vt)
        ys.append(torch.einsum("bhp,bhpq->bhq", rt,
                               s + u[None, :, :, None] * kv))
        s = wt[..., None] * s + kv
    return torch.stack(ys, dim=1), s


def _wkv_chunked(r, k, v, lw, u, s0, chunk: int):
    """Chunk-parallel WKV: intra-chunk masked products plus a loop over
    chunks. Log-space per-channel decays, each key's ratio exp(-cum_j)
    clamped at e^CLAMP, as in the reference. Where a chunk's log-decay sum
    passes -CLAMP that clamp cuts every later key's weight by
    exp(-cum_j - CLAMP), however recent the key, so the form then departs
    from the scan (ROADMAP R8; RWKV6-3B's random init reaches -53.5 at full
    depth)."""
    B, S, H, P = r.shape
    Q = chunk
    S_orig = S
    if S % Q:
        # pad to a chunk multiple: zero k/v add nothing to the state and a
        # zero log-decay leaves it untouched — exactly neutral
        pad = Q - S % Q
        r, k, v, lw = (F.pad(t, (0, 0, 0, 0, 0, pad)) for t in (r, k, v, lw))
        S = S + pad
    M = S // Q
    rs = r.reshape(B, M, Q, H, P)
    ks = k.reshape(B, M, Q, H, P)
    vs = v.reshape(B, M, Q, H, P)
    lws = lw.reshape(B, M, Q, H, P)
    cum = torch.cumsum(lws, dim=2)                             # <= 0
    cum_prev = cum - lws                                       # sum over s<t

    # intra-chunk: y_t += sum_{j<t} (r_t . exp(cum_{t-1}-cum_j) k_j) v_j
    r_dec = rs * torch.exp(cum_prev)                           # exp <= 1
    k_dec = ks * torch.exp(torch.clamp(-cum, max=CLAMP))
    att = torch.einsum("bmihp,bmjhp->bmhij", r_dec, k_dec)
    idx = torch.arange(Q, device=r.device)
    strict = (idx[None, :] < idx[:, None])[None, None, None]
    att = torch.where(strict, att, torch.zeros_like(att))
    y = torch.einsum("bmhij,bmjhp->bmihp", att, vs)
    # bonus (diagonal) term: + (r_t . u*k_t) v_t
    diag = torch.einsum("bmqhp,hp,bmqhp->bmqh", rs, u, ks)
    y = y + diag[..., None] * vs

    # chunk states: s' = diag(exp(cum_Q)) s
    #               + sum_j diag(exp(cum_Q - cum_j)) k_j v_j^T
    k_end = ks * torch.exp(cum[:, :, -1:, :, :] - cum)
    s_chunk = torch.einsum("bmqhp,bmqhv->bmhpv", k_end, vs)
    chunk_decay = torch.exp(cum[:, :, -1])                     # (B,M,H,P)

    s = s0
    s_prevs = []
    for m in range(M):
        s_prevs.append(s)
        s = chunk_decay[:, m, ..., None] * s + s_chunk[:, m]
    s_prevs = torch.stack(s_prevs, dim=1)                      # (B,M,H,P,V)

    y_inter = torch.einsum("bmqhp,bmhpv->bmqhv", r_dec, s_prevs)
    y = (y + y_inter).reshape(B, S, H, P)
    return y[:, :S_orig], s


def _group_norm_heads(y, scale, eps):
    """Per-head RMS norm (the reference's stand-in for RWKV's GroupNorm),
    then flatten, scale per channel and cast to bf16."""
    B, S, H, P = y.shape
    var = torch.mean(torch.square(y), dim=-1, keepdim=True)
    y = y * torch.rsqrt(var + eps)
    return (y.reshape(B, S, H * P) * scale).to(torch.bfloat16)


def _channel_mix(cfg, lp, x, x_prev=None):
    """The channel mix: ``w_ck``/``w_cv`` over ``ff`` as
    ``layers/mlp.py``'s SwiGLU, ``w_cv``'s partial product all-reduced;
    ``w_cr``'s columns are sharded (``("embed", "heads")``), so its gate
    is gathered back before it scales ``w_cv``'s replicated output."""
    xs = _shift(x, x_prev)
    mu = lp["mu_cm"].to(x.dtype)
    xk = x + (xs - x) * mu[0]
    xr = x + (xs - x) * mu[1]
    ff = _spec(cfg, "w_ck")[1]
    kk = torch.square(torch.relu((ctx.into_sharded(xk, ff)
                                  @ lp["w_ck"]).float()))
    kk = ctx.maybe_constrain(kk, ("batch", None, "ff"),
                             have=(ctx.batch_entry(), None, ff))
    out = ctx.reduce_partial(kk.to(x.dtype) @ lp["w_cv"], ff)
    cr = _spec(cfg, "w_cr")[1]
    gate = torch.sigmoid((ctx.into_sharded(xr, cr) @ lp["w_cr"]).float())
    return ctx.gather(gate.to(x.dtype), 2, cr) * out


def _layer(cfg, lp, x, mode, chunk, states=None):
    """One RWKV6 block. states=None for training (zero carries); else
    (x, {"S", "x_tm", "x_cm"}) of the block's new state. Under a mesh
    context the WKV runs this rank's heads (``_wkv_entry``), the heads
    ``bonus_u`` and the cache's S are laid out over."""
    he = _wkv_entry(cfg, x)
    H = _heads_padded(cfg) // ctx.size(he)
    xin = layer_norm(x, lp["ln1_s"], lp["ln1_b"], cfg.norm_eps)
    r, k, v, g, lw = _time_mix_projections(
        cfg, lp, xin, None if states is None else states["x_tm"][:, None],
        he)
    s0 = (torch.zeros((x.shape[0], H, HEAD_DIM, HEAD_DIM),
                      dtype=torch.float32, device=x.device)
          if states is None else states["S"])
    u = lp["bonus_u"]
    if mode == "scan":
        y, s_final = _wkv_scan(r, k, v, lw, u, s0)
    else:
        y, s_final = _wkv_chunked(r, k, v, lw, u, s0, chunk)
    y = _group_norm_heads(y, _head_cols(lp["ln_x"], he), cfg.norm_eps)
    y = y * F.silu(g.float()).to(y.dtype)
    # the group norm's output is bf16 in every precision; against an f32
    # w_o the product is f32, as JAX promotes it. w_o's rows are sharded:
    # its partial product is all-reduced
    rows = _spec(cfg, "w_o")[0]
    y = ctx.relayout(y, (None, None, he), (None, None, rows))
    y = ctx.reduce_partial(
        y.to(torch.promote_types(y.dtype, lp["w_o"].dtype)) @ lp["w_o"],
        rows)
    x = ctx.maybe_constrain(x + y, ("batch", None, None),
                            have=(ctx.batch_entry(), None, None))
    xin2 = layer_norm(x, lp["ln2_s"], lp["ln2_b"], cfg.norm_eps)
    cm = _channel_mix(cfg, lp, xin2,
                      None if states is None else states["x_cm"][:, None])
    x = x + cm
    new_states = None
    if states is not None:
        new_states = {"S": s_final, "x_tm": xin[:, -1], "x_cm": xin2[:, -1]}
    return x, new_states


def _final_norm(cfg, p, x):
    scale = common.weights(cfg, p, "ln_out")
    return layer_norm(x, scale, torch.zeros_like(scale), cfg.norm_eps)


def _embed(cfg, p, tokens):
    x = common.embed_tokens(common.weights(cfg, p, "embed"), tokens,
                            cfg.vocab_size)
    return ctx.maybe_constrain(x, ("batch", None, None),
                               have=(ctx.batch_entry(), None, None))


def _vocab_entry(cfg):
    return common.vocab_entry(cfg.vocab_size, cfg.d_model)


def _unembed(cfg, p, x):
    return common.unembed(x, common.weights(cfg, p, "unembed"),
                          _vocab_entry(cfg))


def _layers(cfg, p, x, mode, remat: bool = True):
    """The layers, each under ``torch.utils.checkpoint`` with ``remat``
    and grad enabled (the module's docstring)."""
    stack = common.LayerStack(cfg, p)

    def layer(x, lp, i):
        return _layer(cfg, stack.whole(lp, i), x, mode, cfg.ssm_chunk)[0]

    for i in range(cfg.num_layers):
        if remat and torch.is_grad_enabled():
            x = checkpoint(layer, x, stack[i], i, use_reentrant=False)
        else:
            x = layer(x, stack[i], i)
    return x


def forward(cfg, p, batch, *, mode: str | None = None, remat: bool = True):
    """Full-sequence forward: (logits f32, aux 0); under a mesh context
    this rank's vocab columns."""
    x = _layers(cfg, p, _embed(cfg, p, batch["tokens"]),
                mode or cfg.rwkv_mode, remat)
    logits = _unembed(cfg, p, _final_norm(cfg, p, x))
    return logits, torch.zeros((), device=logits.device)


def loss_fn(cfg, p, batch, mode: str | None = None, *, remat: bool = True):
    """The mean next-token cross-entropy (over the global batch, on this
    rank's vocab columns under a mesh context: ``common.cross_entropy``)."""
    logits, _ = forward(cfg, p, batch, mode=mode, remat=remat)
    ce = common.cross_entropy(logits, batch["targets"], _vocab_entry(cfg))
    return ce, {"ce": ce, "aux": torch.zeros((), device=ce.device)}


def hidden_states(cfg, p, batch, *, mode: str | None = None,
                  remat: bool = True):
    """The final-norm hidden states (B, S, D) — the ELM head's H."""
    x = _layers(cfg, p, _embed(cfg, p, batch["tokens"]),
                mode or cfg.rwkv_mode, remat)
    return _final_norm(cfg, p, x)


# ---------------------------------------------------------------------------
# serving: a state of constant size in the sequence
# ---------------------------------------------------------------------------

def init_cache(cfg, batch: int, seq_len: int, dtype=torch.bfloat16,
               device="cuda"):
    """The zero state of a global ``batch``; under a mesh context this
    rank's blocks of it (and the global batch declared)."""
    del seq_len  # constant-size state
    dev = resolve_device(device)
    L, D, H = cfg.num_layers, cfg.d_model, _heads_padded(cfg)
    ctx.declare(batch=batch)
    shapes = {"S": ((L, batch, H, HEAD_DIM, HEAD_DIM), torch.float32),
              "x_tm": ((L, batch, D), dtype), "x_cm": ((L, batch, D), dtype)}
    logical = cache_logical(cfg)
    return {name: torch.zeros(ctx.block_shape(shape, logical[name]),
                              dtype=dt, device=dev)
            for name, (shape, dt) in shapes.items()}


def prefill(cfg, p, batch, *, mode: str | None = None):
    """Encode a prompt; returns (last-position logits, per-layer state);
    under a mesh context this rank's vocab columns and state blocks."""
    mode = mode or cfg.rwkv_mode
    x = _embed(cfg, p, batch["tokens"])
    B = x.shape[0]
    Hs = _heads_padded(cfg) // ctx.size(_wkv_entry(cfg, x))
    S, x_tm, x_cm = [], [], []
    stack = common.LayerStack(cfg, p)
    for i in range(cfg.num_layers):
        states0 = {"S": torch.zeros((B, Hs, HEAD_DIM, HEAD_DIM),
                                    dtype=torch.float32, device=x.device),
                   "x_tm": torch.zeros((B, cfg.d_model), dtype=x.dtype,
                                       device=x.device),
                   "x_cm": torch.zeros((B, cfg.d_model), dtype=x.dtype,
                                       device=x.device)}
        x, ns = _layer(cfg, stack.layer(i), x, mode,
                       cfg.ssm_chunk, states0)
        S.append(ns["S"])
        x_tm.append(ns["x_tm"])
        x_cm.append(ns["x_cm"])
    logits = _unembed(cfg, p, _final_norm(cfg, p, x[:, -1:]))
    return logits, {"S": torch.stack(S), "x_tm": torch.stack(x_tm),
                    "x_cm": torch.stack(x_cm)}


def decode_step(cfg, p, cache, token, pos):
    """One token through the exact recurrence. Returns (logits, cache); the
    cache's tensors are updated in place (the reference donates its cache
    to the step, so nothing reads the old one) and returned. Under a mesh
    context the cache and the token are this rank's blocks and the logits
    come out whole over the vocab."""
    del pos  # the recurrent state carries position implicitly
    x = _embed(cfg, p, token)  # (B, 1, D)
    stack = common.LayerStack(cfg, p)
    for i in range(cfg.num_layers):
        states = {"S": cache["S"][i], "x_tm": cache["x_tm"][i],
                  "x_cm": cache["x_cm"][i]}
        x, ns = _layer(cfg, stack.layer(i), x, "scan",
                       cfg.ssm_chunk, states)
        for name in ("S", "x_tm", "x_cm"):
            cache[name][i] = ns[name]
    logits = _unembed(cfg, p, _final_norm(cfg, p, x))
    return common.gathered_logits(logits, _vocab_entry(cfg)), cache


def pad_head_params(params, cfg_from, cfg_to):
    """An unpadded tree in the head-padded layout (cfg_to.rwkv_head_pad_to
    > 0): zero columns and rows for the extra heads. The padded model
    computes exactly the same function."""
    Hp = _heads_padded(cfg_to)
    D = cfg_from.d_model
    Dp = Hp * HEAD_DIM
    if Dp == D:
        return params
    lay = dict(params["layers"])
    for k in ("w_r", "w_k", "w_v", "w_g", "decay_B"):
        lay[k] = F.pad(lay[k], (0, Dp - D))
    lay["w_o"] = F.pad(lay["w_o"], (0, 0, 0, Dp - D))
    lay["decay_base"] = F.pad(lay["decay_base"], (0, Dp - D), value=-1.0)
    lay["ln_x"] = F.pad(lay["ln_x"], (0, Dp - D), value=1.0)
    lay["bonus_u"] = F.pad(lay["bonus_u"],
                           (0, 0, 0, Hp - _heads(cfg_from)))
    return {**params, "layers": lay}
