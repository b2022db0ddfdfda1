"""Plain PyTorch versions of the conv2d kernels: im2col + matrix products.

The same functions as ``csrc/conv2d.cu`` (and as the reference's im2col +
Pallas GEMM): a valid, stride-1 NHWC convolution with HWIO weights, summed
over the patch in (kh, kw, Cin) order, in f32; and its two gradients, as
``csrc/conv2d_wgrad.cu`` (dW) and the forward kernel on padded dY (dX)
compute them on the card.

Each takes one matrix product per member on freshly built operands, so a
member's result does not depend on how many members ride beside it (the
sequential and stacked Map paths agree bit-for-bit).
"""
from __future__ import annotations

import torch


def im2col(x, kh: int, kw: int):
    """(B, H, W, C) -> (B*OH*OW, kh*kw*C) patch matrix, (kh, kw, C) order."""
    B, H, W, C = x.shape
    OH, OW = H - kh + 1, W - kw + 1
    idx_h = torch.arange(OH)[:, None] + torch.arange(kh)[None, :]
    idx_w = torch.arange(OW)[:, None] + torch.arange(kw)[None, :]
    patches = x[:, idx_h][:, :, :, idx_w]             # (B,OH,kh,OW,kw,C)
    patches = patches.permute(0, 1, 3, 2, 4, 5)        # (B,OH,OW,kh,kw,C)
    return patches.reshape(B * OH * OW, kh * kw * C)


def conv2d_valid_ref(x, w):
    """x: (k, B, H, W, Cin), w: (k, kh, kw, Cin, Cout) -> (k, B, OH, OW, Cout)."""
    k, B, H, W, _ = x.shape
    _, kh, kw, Cin, Cout = w.shape
    OH, OW = H - kh + 1, W - kw + 1
    out = [im2col(x[i].float(), kh, kw)
           @ w[i].float().reshape(kh * kw * Cin, Cout).clone()
           for i in range(k)]
    return torch.stack(out).reshape(k, B, OH, OW, Cout)


def conv2d_weight_grad_ref(x, dy, kh: int, kw: int):
    """dW: x (k, B, H, W, Cin), dy (k, B, OH, OW, Cout) -> (k, kh, kw, Cin,
    Cout), per member the patch matrix's transpose times dY, in the
    operands' dtype (f64 operands give the f64 truth the card's kernel is
    held against)."""
    k, _, _, _, Cin = x.shape
    Cout = dy.shape[-1]
    out = [im2col(x[i], kh, kw).T @ dy[i].reshape(-1, Cout).clone()
           for i in range(k)]
    return torch.stack(out).reshape(k, kh, kw, Cin, Cout)


def conv2d_input_grad_ref(dy, w):
    """dX: dy (k, B, OH, OW, Cout), w (k, kh, kw, Cin, Cout) -> (k, B, H, W,
    Cin), per member col2im of dY times Wᵀ: each patch column added back
    onto the pixels it was read from, taps in (kh, kw) order; in the
    operands' dtype."""
    k, B, OH, OW, Cout = dy.shape
    _, kh, kw, Cin, _ = w.shape
    out = []
    for i in range(k):
        cols = (dy[i].reshape(-1, Cout).clone()
                @ w[i].reshape(kh * kw * Cin, Cout).T.clone())
        cols = cols.reshape(B, OH, OW, kh, kw, Cin)
        dx = torch.zeros((B, OH + kh - 1, OW + kw - 1, Cin),
                         dtype=cols.dtype, device=dy.device)
        for a in range(kh):
            for b in range(kw):
                dx[:, a:a + OH, b:b + OW] += cols[:, :, :, a, b]
        out.append(dx)
    return torch.stack(out)
