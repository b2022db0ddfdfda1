"""Plain PyTorch version of the sliding-window flash-attention kernel.

The same function as ``csrc/swa_full_fwd.cu`` and the reference's
``kernels/swa_attention/ref.py``, in the serving path's layouts:
q (B, S, H, hd), k and v (B, S, KV, hd), query head h reading kv head
h // (H / KV). Query i sees keys j with j <= i and i - j < window; the
scores are f32, scaled by hd^-0.5, masked to -1e30, and the output is cast
to q's dtype. The arithmetic is the reference's ``_sdpa``
(``layers/attention.py:65``) under the mask of ``attention.py:89-93``, or,
with ``causal=False``, under the all-ones mask of its encoder's
``attn_forward_bidirectional`` (``attention.py:99-105``): every key.
"""
from __future__ import annotations

import torch

NEG_INF = -1e30


def swa_attention_ref(q, k, v, *, window: int, causal: bool = True):
    """q: (B, S, H, hd); k, v: (B, S, KV, hd) -> (B, S, H, hd)."""
    B, S, H, hd = q.shape
    KV = k.shape[2]
    qg = q.float().reshape(B, S, KV, H // KV, hd)
    s = torch.einsum("bskgh,btkh->bkgst", qg, k.float()) * (hd ** -0.5)
    if causal:
        i = torch.arange(S, device=q.device)[:, None]
        j = torch.arange(S, device=q.device)[None, :]
        mask = (j <= i) & (i - j < window)
        s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    w = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgst,btkh->bskgh", w, v.float())
    return out.reshape(B, S, H, hd).to(q.dtype)


def _wide(q):
    """f32, or f64 for f64 operands (the card tests' f64 truth)."""
    return torch.float64 if q.dtype == torch.float64 else torch.float32


def _scores(q, k, window, causal=True):
    """(B, KV, G, S, S) scaled scores, -1e30 outside the mask, and the
    mask (every key without ``causal``)."""
    B, S, H, hd = q.shape
    KV = k.shape[2]
    w = _wide(q)
    qg = q.to(w).reshape(B, S, KV, H // KV, hd)
    s = torch.einsum("bskgh,btkh->bkgst", qg, k.to(w)) * (hd ** -0.5)
    i = torch.arange(S, device=q.device)[:, None]
    j = torch.arange(S, device=q.device)[None, :]
    mask = ((j <= i) & (i - j < window)) if causal else (j < S)
    return torch.where(mask, s, torch.full_like(s, NEG_INF)), mask


def swa_attention_lse_ref(q, k, *, window: int, causal: bool = True):
    """(B, H, S) f32: each query row's log-sum-exp of its scaled scores
    inside the mask (natural log), what the forward kernel writes for the
    backward."""
    B, S, H, _ = q.shape
    s, _ = _scores(q, k, window, causal)
    return torch.logsumexp(s, dim=-1).reshape(B, H, S)


def swa_attention_bwd_ref(q, k, v, out, lse, dout, *, window: int,
                          causal: bool = True):
    """The backward in plain PyTorch, recomputed from the log-sum-exp as
    ``csrc/swa_full_bwd.cu`` does: P = exp(s − lse) inside the mask,
    D = rowsum(dout ∘ out), dS = P ∘ (dout·vᵀ − D); dq = scale·dS·k,
    dk = scale·dSᵀ·q and dv = Pᵀ·dout summed over each kv head's group;
    with ``causal=False`` over every key. f32 throughout (f64 for f64
    operands); (dq, dk, dv) in q's dtype."""
    B, S, H, hd = q.shape
    KV = k.shape[2]
    G = H // KV
    w = _wide(q)
    s, mask = _scores(q, k, window, causal)
    p = torch.where(mask, torch.exp(s - lse.to(w).reshape(B, KV, G, S, 1)),
                    torch.zeros_like(s))
    dog = dout.to(w).reshape(B, S, KV, G, hd)
    delta = (dog * out.to(w).reshape(B, S, KV, G, hd)).sum(-1)
    dp = torch.einsum("bskgh,btkh->bkgst", dog, v.to(w))
    ds = p * (dp - delta.permute(0, 2, 3, 1)[..., None])
    scale = hd ** -0.5
    qg = q.to(w).reshape(B, S, KV, G, hd)
    dq = torch.einsum("bkgst,btkh->bskgh", ds, k.to(w)) * scale
    dk = torch.einsum("bkgst,bskgh->btkh", ds, qg) * scale
    dv = torch.einsum("bkgst,bskgh->btkh", p, dog)
    return (dq.reshape(B, S, H, hd).to(q.dtype), dk.to(q.dtype),
            dv.to(q.dtype))
