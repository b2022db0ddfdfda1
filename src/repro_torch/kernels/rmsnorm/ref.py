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
