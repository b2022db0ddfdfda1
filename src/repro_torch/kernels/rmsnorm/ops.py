"""The rmsnorm wrapper: row-wise x · 1/sqrt(mean(x²) + eps) · scale.

A CPU tensor goes to the plain version (``ref.rmsnorm_ref``, which
autograd differentiates), any other tensor to the operators
``repro_torch::rmsnorm`` and ``repro_torch::rmsnorm_bwd``: on a CUDA
tensor the hand kernel in ``csrc/rmsnorm.cu``, on a meta tensor shapes
only; nothing falls back from one to the other. x is f32 or
bf16 of any leading shape (the kernel reads a contiguous copy of a strided
view), scale (D,) f32 or bf16; the math is f32 and the output has x's
dtype. On the card the call is a ``torch.autograd.Function`` whose
backward is the kernel in ``csrc/rmsnorm_bwd.cu`` (dx in x's dtype, dscale
in scale's), counted as ``rmsnorm_bwd``.
"""
from __future__ import annotations

import math

import torch

from repro_torch import kernels
from repro_torch.kernels.rmsnorm import ref

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_BWD_DIM = 32 * 256     # columns a backward block holds in registers
_BWD_BLOCKS = 264          # the backward's target: two blocks an SM (132)


def rmsnorm(x, scale, *, eps: float = 1e-5):
    """x: (..., D); scale: (D,) -> (..., D) in x's dtype."""
    _check(x, scale)
    if x.device.type == "cpu":
        return ref.rmsnorm_ref(x, scale, eps)
    if x.device.type not in ("cuda", "meta"):
        raise ValueError(f"rmsnorm runs on CPU, CUDA or meta tensors, "
                         f"got {x.device}")
    if kernels.needs_grad((x, scale)):
        return _RMSNorm.apply(x, scale, eps)
    return _forward(x.contiguous(), scale, eps)


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


def _rows(x):
    D = x.shape[-1]
    n = x.numel() // max(D, 1)
    if D < 1 or n < 1:
        raise ValueError(f"empty operand: x {tuple(x.shape)}")
    if n > 2**31 - 1 or D > 2**31 // 2:
        raise ValueError(f"rmsnorm of {n} rows of {D} is too large for "
                         f"one launch")
    return n, D


def _forward(x, scale, eps):
    """The kernel on a contiguous x."""
    return _FWD(x, scale, float(eps))


def _fwd_checks(x, scale):
    if not (x.is_contiguous() and scale.is_contiguous()):
        raise ValueError("the rmsnorm kernel takes a contiguous x and scale")
    return _rows(x)


def _fwd_cuda(x, scale, eps):
    n, D = _fwd_checks(x, scale)
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        kernels.launch("rmsnorm", x.data_ptr(), scale.data_ptr(),
                       out.data_ptr(), n, D, eps, _DTYPES[x.dtype],
                       _DTYPES[scale.dtype])
    return out


def _fwd_fake(x, scale, eps):
    _fwd_checks(x, scale)
    return torch.empty_like(x)


def rmsnorm_flops(shape) -> int:
    """The forward's work on x of ``shape``: 4 operations an element (the
    square, its sum, the product by the row's reciprocal root and by the
    scale); the per-row eps add, root and reciprocal are not counted."""
    return 4 * math.prod(shape)


def rmsnorm_bwd_flops(shape) -> int:
    """The backward's work on x of ``shape``: 11 operations an element (the
    square and its sum, dy·scale, its product with x and their sum, the two
    products and the difference of dx, x·r, its product with dy and the sum
    over rows of dscale); the per-row terms are not counted."""
    return 11 * math.prod(shape)


_FWD = kernels.register(
    "rmsnorm", "(Tensor x, Tensor scale, float eps) -> Tensor",
    _fwd_cuda, _fwd_fake,
    lambda x, scale, eps, *, out_shape=None: rmsnorm_flops(x))


def bwd_rows_per_chunk(n: int, D: int) -> int:
    """Rows a block of the backward sums dscale over: about two blocks an
    SM. A function of the shape alone, so dscale's order of summation is
    too."""
    return max(1, -(-n // _BWD_BLOCKS))


def rmsnorm_bwd(x, scale, dy, *, eps: float = 1e-5):
    """The backward kernel: (dx in x's dtype, dscale in scale's) of the
    rmsnorm of contiguous x (..., D) with cotangent dy of x's shape and
    dtype. Each row is read once; rows that start on a 16-byte boundary
    (D a multiple of 8 for bf16, of 4 for f32, and an aligned x, dy and
    dx) move in 16-byte vectors, other rows element by element. dscale
    adds per-chunk partial rows in a fixed order, no atomics: bitwise the
    same run to run."""
    if dy.shape != x.shape or dy.dtype != x.dtype:
        raise ValueError(f"dy {tuple(dy.shape)} {dy.dtype} does not match "
                         f"x {tuple(x.shape)} {x.dtype}")
    dx, dscale, _ = _BWD(x.contiguous(), scale, dy.contiguous(), float(eps))
    return dx, dscale


def _bwd_plan(x, scale):
    """(n, D, rows a chunk, the partial sums' shape)."""
    n, D = _fwd_checks(x, scale)
    if D > MAX_BWD_DIM:
        raise ValueError(f"the rmsnorm backward kernel takes D <= "
                         f"{MAX_BWD_DIM}, got {D}")
    rows = bwd_rows_per_chunk(n, D)
    return n, D, rows, (-(-n // rows), D)


def _bwd_outputs(x, scale, partial_shape):
    return (torch.empty_like(x), torch.empty_like(scale),
            torch.empty(partial_shape, dtype=torch.float32,
                        device=x.device))


def _bwd_cuda(x, scale, dy, eps):
    n, D, rows, part = _bwd_plan(x, scale)
    dx, dscale, partial = _bwd_outputs(x, scale, part)
    with torch.cuda.device(x.device):
        kernels.launch("rmsnorm_bwd", x.data_ptr(), scale.data_ptr(),
                       dy.data_ptr(), dx.data_ptr(), partial.data_ptr(),
                       dscale.data_ptr(), n, D, rows, eps,
                       _DTYPES[x.dtype], _DTYPES[scale.dtype])
    return dx, dscale, partial


def _bwd_fake(x, scale, dy, eps):
    return _bwd_outputs(x, scale, _bwd_plan(x, scale)[3])


# outputs (dx, dscale, the per-chunk partial sums of dscale: a workspace)
_BWD = kernels.register(
    "rmsnorm_bwd",
    "(Tensor x, Tensor scale, Tensor dy, float eps) -> (Tensor, Tensor, "
    "Tensor)", _bwd_cuda, _bwd_fake,
    lambda x, scale, dy, eps, *, out_shape=None: rmsnorm_bwd_flops(x))


class _RMSNorm(torch.autograd.Function):
    """The forward and backward kernels under autograd; x is kept as the
    contiguous copy the forward read."""

    @staticmethod
    def forward(ctx, x, scale, eps):
        x = x.contiguous()
        ctx.save_for_backward(x, scale)
        ctx.eps = eps
        return _forward(x, scale, eps)

    @staticmethod
    def backward(ctx, dy):
        x, scale = ctx.saved_tensors
        dx, dscale = rmsnorm_bwd(x, scale, dy, eps=ctx.eps)
        return dx, dscale, None
