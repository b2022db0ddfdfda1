"""Plain PyTorch version of the fused RMSNorm kernel — the same math as
the reference's ``layers/norms.py::rms_norm`` and ``csrc/rmsnorm.cu``:
row-wise x · 1/sqrt(mean(x²) + eps) · scale in f32, the result cast back
to x's dtype."""
from __future__ import annotations

import torch


def rmsnorm_ref(x, scale, eps: float = 1e-5):
    """x: (..., D); scale: (D,) -> (..., D) in x's dtype."""
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    out = xf * torch.reciprocal(torch.sqrt(var + eps)) * scale.float()
    return out.to(x.dtype)


def rmsnorm_bwd_ref(x, scale, dy, eps: float = 1e-5):
    """The backward in plain PyTorch, the formulas of ``csrc/rmsnorm_bwd.cu``
    in f32: with r = 1/sqrt(mean(x²) + eps) per row,
    dx = r·(dy·scale) − x·r³·mean(dy·scale·x) in x's dtype and
    dscale = Σ_rows dy·(x·r) in scale's dtype."""
    xf, g, s = x.float(), dy.float(), scale.float()
    D = x.shape[-1]
    r = torch.reciprocal(torch.sqrt(torch.mean(xf * xf, dim=-1,
                                               keepdim=True) + eps))
    gs = g * s
    c3 = r * r * r * torch.mean(gs * xf, dim=-1, keepdim=True)
    dx = r * gs - xf * c3
    dscale = (g * (xf * r)).reshape(-1, D).sum(0)
    return dx.to(x.dtype), dscale.to(scale.dtype)
