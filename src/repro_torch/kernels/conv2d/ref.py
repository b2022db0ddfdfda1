"""Plain PyTorch version of the conv2d kernel: im2col + matrix product.

The same function as ``csrc/conv2d.cu`` (and as the reference's im2col +
Pallas GEMM): a valid, stride-1 NHWC convolution with HWIO weights, summed
over the patch in (kh, kw, Cin) order, in f32.
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
    """x: (k, B, H, W, Cin), w: (k, kh, kw, Cin, Cout) -> (k, B, OH, OW, Cout).

    One matrix product per member, each on freshly built operands, so a
    member's result does not depend on how many members ride beside it
    (the sequential and stacked Map paths agree bit-for-bit)."""
    k, B, H, W, _ = x.shape
    _, kh, kw, Cin, Cout = w.shape
    OH, OW = H - kh + 1, W - kw + 1
    out = [im2col(x[i].float(), kh, kw)
           @ w[i].float().reshape(kh * kw * Cin, Cout).clone()
           for i in range(k)]
    return torch.stack(out).reshape(k, B, OH, OW, Cout)
