"""Plain PyTorch version of the sliding-window flash-attention kernel.

The same function as ``csrc/swa_attention.cu`` and the reference's
``kernels/swa_attention/ref.py``, in the serving path's layouts:
q (B, S, H, hd), k and v (B, S, KV, hd), query head h reading kv head
h // (H / KV). Query i sees keys j with j <= i and i - j < window; the
scores are f32, scaled by hd^-0.5, masked to -1e30, and the output is cast
to q's dtype. The arithmetic is the reference's ``_sdpa``
(``layers/attention.py:65``) under the mask of ``attention.py:89-93``.
"""
from __future__ import annotations

import torch

NEG_INF = -1e30


def swa_attention_ref(q, k, v, *, window: int):
    """q: (B, S, H, hd); k, v: (B, S, KV, hd) -> (B, S, H, hd)."""
    B, S, H, hd = q.shape
    KV = k.shape[2]
    qg = q.float().reshape(B, S, KV, H // KV, hd)
    s = torch.einsum("bskgh,btkh->bkgst", qg, k.float()) * (hd ** -0.5)
    i = torch.arange(S, device=q.device)[:, None]
    j = torch.arange(S, device=q.device)[None, :]
    mask = (j <= i) & (i - j < window)
    s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    w = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgst,btkh->bskgh", w, v.float())
    return out.reshape(B, S, H, hd).to(q.dtype)
