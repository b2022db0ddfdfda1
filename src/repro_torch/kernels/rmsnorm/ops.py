"""The rmsnorm wrapper: row-wise x · 1/sqrt(mean(x²) + eps) · scale.

A CPU tensor goes to the plain version (``ref.rmsnorm_ref``), a CUDA
tensor to the hand kernel in ``csrc/rmsnorm.cu``; nothing falls back from
one to the other. x is f32 or bf16 of any leading shape (the kernel reads
a contiguous copy of a strided view), scale (D,) f32 or bf16; the math is
f32 and the output has x's dtype.
"""
from __future__ import annotations

import torch

from repro_torch import kernels
from repro_torch.kernels.rmsnorm import ref

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def rmsnorm(x, scale, *, eps: float = 1e-5):
    """x: (..., D); scale: (D,) -> (..., D) in x's dtype."""
    _check(x, scale)
    if x.device.type == "cpu":
        return ref.rmsnorm_ref(x, scale, eps)
    return _launch(x, scale, eps)


def _check(x, scale):
    if x.dim() < 1 or scale.shape != (x.shape[-1],):
        raise ValueError(f"rmsnorm takes x (..., D) and scale (D,), got "
                         f"{tuple(x.shape)} and {tuple(scale.shape)}")
    for a in (x, scale):
        if a.dtype not in _DTYPES:
            raise TypeError(f"rmsnorm takes float32 or bfloat16, "
                            f"got {a.dtype}")
    if scale.device != x.device:
        raise ValueError(f"operands on {x.device} and {scale.device}")


def _launch(x, scale, eps):
    if not x.is_cuda:
        raise ValueError(f"rmsnorm runs on CPU or CUDA tensors, "
                         f"got {x.device}")
    if not scale.is_contiguous():
        raise ValueError("the rmsnorm kernel takes a contiguous scale")
    x = x.contiguous()      # a view such as x[:, -1:] is copied once
    D = x.shape[-1]
    n = x.numel() // max(D, 1)
    if D < 1 or n < 1:
        raise ValueError(f"empty operand: x {tuple(x.shape)}")
    if n > 2**31 - 1 or D > 2**31 // 2:
        raise ValueError(f"rmsnorm of {n} rows of {D} is too large for "
                         f"one launch")
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        kernels.launch("rmsnorm", x.data_ptr(), scale.data_ptr(),
                       out.data_ptr(), n, D, float(eps), _DTYPES[x.dtype],
                       _DTYPES[scale.dtype])
    return out
