"""Normalisation layers and the ELM activation (f32 math, cast back to the
input dtype) — the port's counterpart of ``repro.layers.norms``."""
from __future__ import annotations

import torch

from repro_torch.kernels.rmsnorm import ops as rms_ops


def rms_norm(x, scale, eps: float = 1e-5):
    """x · 1/sqrt(mean(x²) + eps) · scale over the last dim, in f32, the
    result in x's dtype; through the rmsnorm kernel on the card."""
    return rms_ops.rmsnorm(x, scale, eps=eps)


def layer_norm(x, scale, bias, eps: float = 1e-5):
    """(x − μ) · 1/sqrt(var + eps) · scale + bias over the last dim (the
    biased variance, as ``jnp.var``), in f32, the result in x's dtype; the
    reference's op order. Plain PyTorch: no TPU kernel computes it (RWKV6's
    norms)."""
    xf = x.float()
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.mean(torch.square(xf - mu), dim=-1, keepdim=True)
    out = (xf - mu) * torch.reciprocal(torch.sqrt(var + eps))
    out = out * scale.float() + bias.float()
    return out.to(x.dtype)


def optimal_tanh(h):
    """The paper's ELM feature activation: 1.7159 * tanh(2/3 * H)
    (LeCun, 'Efficient BackProp')."""
    hf = h.float()
    return (1.7159 * torch.tanh(hf * (2.0 / 3.0))).to(h.dtype)
