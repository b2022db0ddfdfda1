"""Attention: GQA with RoPE, optional qk-norm, causal / sliding-window
prefill and the encoder's bidirectional attention through the swa_attention
kernel, and single-token decode against a (full or ring-buffer) KV cache —
the port's counterpart of ``repro.layers.attention``.

Parameter layout per layer (optionally with a leading stacked-layer dim):
  wq: (d_model, n_heads*head_dim)    wk/wv: (d_model, n_kv*head_dim)
  wo: (n_heads*head_dim, d_model)    q_norm/k_norm: (head_dim,) if qk_norm
q is (B, S, H, hd) and k, v are (B, T, KV, hd), as in the reference.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.swa_attention import ops as swa_ops
from repro_torch.layers.init import normal
from repro_torch.layers.norms import rms_norm
from repro_torch.layers.rope import apply_rope

NEG_INF = -1e30


def init_attention(cfg, generator, dtype=torch.bfloat16,
                   num_layers: int | None = None, device="cuda"):
    lead = () if num_layers is None else (num_layers,)
    d, qd, kvd = cfg.d_model, cfg.q_dim, cfg.kv_dim
    p = {
        "wq": normal(generator, lead + (d, qd), d ** -0.5, dtype, device),
        "wk": normal(generator, lead + (d, kvd), d ** -0.5, dtype, device),
        "wv": normal(generator, lead + (d, kvd), d ** -0.5, dtype, device),
        "wo": normal(generator, lead + (qd, d), qd ** -0.5, dtype, device),
    }
    if cfg.qk_norm:
        p["q_norm"] = torch.ones(lead + (cfg.head_dim,), dtype=dtype,
                                 device=device)
        p["k_norm"] = torch.ones(lead + (cfg.head_dim,), dtype=dtype,
                                 device=device)
    return p


def _project_qkv(cfg, p, x, positions):
    B, S, _ = x.shape
    q = (x @ p["wq"]).reshape(B, S, cfg.num_heads, cfg.head_dim)
    k = (x @ p["wk"]).reshape(B, S, cfg.num_kv_heads, cfg.head_dim)
    v = (x @ p["wv"]).reshape(B, S, cfg.num_kv_heads, cfg.head_dim)
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"], cfg.norm_eps)
        k = rms_norm(k, p["k_norm"], cfg.norm_eps)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def _sdpa(cfg, q, k, v, mask):
    """Plain attention for decode, as the reference's ``_sdpa``.
    q: (B,S,H,hd)  k,v: (B,T,KV,hd)  mask: (S,T) or (B,S,T) bool."""
    groups = cfg.num_heads // cfg.num_kv_heads
    B, S, H, hd = q.shape
    qg = q.reshape(B, S, cfg.num_kv_heads, groups, hd)
    scores = torch.einsum("bskgh,btkh->bkgst", qg.float(),
                          k.float()) * (hd ** -0.5)
    if mask.dim() == 2:
        mask = mask[None]
    scores = torch.where(mask[:, None, None], scores,
                         torch.full_like(scores, NEG_INF))
    w = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgst,btkh->bskgh", w, v.float())
    return out.reshape(B, S, H, hd).to(q.dtype)


def attn_forward(cfg, p, x, positions, window: int = 0):
    """Full-sequence (prefill) causal attention, windowed when ``window``
    > 0, through the swa_attention kernel. Returns (y, (k, v)) so prefill
    can build the KV cache."""
    q, k, v = _project_qkv(cfg, p, x, positions)
    S = x.shape[1]
    y = swa_ops.swa_attention(q, k, v, window=window or S)
    y = y.reshape(*x.shape[:2], cfg.q_dim) @ p["wo"]
    return y, (k, v)


def attn_forward_bidirectional(cfg, p, x, positions):
    """Encoder-only (HuBERT) attention: every query sees every key, RoPE
    as in the causal form — the reference's all-ones mask, through the
    swa_attention kernel's non-causal mode. Returns (y, (k, v))."""
    q, k, v = _project_qkv(cfg, p, x, positions)
    S = x.shape[1]
    y = swa_ops.swa_attention(q, k, v, window=S, causal=False)
    y = y.reshape(*x.shape[:2], cfg.q_dim) @ p["wo"]
    return y, (k, v)


# ---------------------------------------------------------------------------
# decode paths
# ---------------------------------------------------------------------------

def init_kv_cache(cfg, batch: int, seq_len: int, num_layers: int,
                  dtype=torch.bfloat16, device="cuda"):
    """Cache shape (L, B, T, KV, hd); T = window size for sliding-window."""
    T = min(seq_len, cfg.sliding_window) if cfg.sliding_window else seq_len
    shape = (num_layers, batch, T, cfg.num_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def attn_decode(cfg, p, x, layer_cache, pos: int):
    """One-token decode. x: (B, 1, d); pos: the tokens generated so far.
    Returns (y, layer_cache). The cache tensors (B, T, KV, hd) are updated
    in place — the reference donates its cache to the step, so nothing reads
    the old one — and returned."""
    ck, cv = layer_cache
    T = ck.shape[1]
    pos = int(pos)
    positions = torch.full((x.shape[0], 1), pos, dtype=torch.int64,
                           device=x.device)
    q, k, v = _project_qkv(cfg, p, x, positions)
    # the reference's dynamic_update_slice clamps the start into the cache
    slot = pos % T if cfg.sliding_window else min(pos, T - 1)
    ck[:, slot:slot + 1] = k
    cv[:, slot:slot + 1] = v
    s_idx = torch.arange(T, device=x.device)
    if cfg.sliding_window:
        # ring buffer: slot s holds absolute position pos - ((pos - s) mod T)
        held = pos - ((pos - s_idx) % T)
        mask = held >= 0
    else:
        mask = s_idx <= pos
    y = _sdpa(cfg, q, ck, cv, mask[None, None, :])
    y = y.reshape(x.shape[0], 1, cfg.q_dim) @ p["wo"]
    return y, (ck, cv)
