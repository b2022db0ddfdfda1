"""Rotary position embeddings (half-split, not interleaved) — the port's
counterpart of ``repro.layers.rope``."""
from __future__ import annotations

import torch


def rope_frequencies(head_dim: int, theta: float, device=None):
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x, positions, theta: float = 10_000.0):
    """x: (..., seq, heads, head_dim); positions: (..., seq) integers."""
    inv = rope_frequencies(x.shape[-1], theta, x.device)      # (hd/2,)
    ang = positions[..., :, None].float() * inv               # (..., seq, hd/2)
    cos = torch.cos(ang)[..., :, None, :]                     # over heads
    sin = torch.sin(ang)[..., :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)
