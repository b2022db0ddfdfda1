"""The conv2d wrapper: a valid, stride-1 NHWC convolution with HWIO weights.

A CPU tensor goes to the plain version (``ref.conv2d_valid_ref``), a CUDA
tensor to the hand kernel in ``csrc/conv2d.cu``; nothing falls back from one
to the other. Forward only: the backward kernel comes with the SGD slice,
so a tensor that requires grad is refused.
"""
from __future__ import annotations

import torch

from repro_torch import kernels
from repro_torch.kernels.conv2d import ref

# the kernel stages one member's weights in shared memory beside its image
# tile; 48 KB of weights leave room for a tile of one output pixel (whose
# input patch is no larger than the weights) in what a block may take
MAX_WEIGHT_BYTES = 48 * 1024


def conv2d_valid(x, w):
    """x: (B, H, W, Cin) with w: (kh, kw, Cin, Cout) -> (B, OH, OW, Cout), or
    the member-batched form x: (k, B, H, W, Cin) with w: (k, kh, kw, Cin,
    Cout) -> (k, B, OH, OW, Cout), member i convolved with its own w[i]."""
    single = x.dim() == 4
    if single:
        if w.dim() != 4:
            raise ValueError(f"x of shape {tuple(x.shape)} takes a 4-d "
                             f"HWIO w, got shape {tuple(w.shape)}")
        return conv2d_valid(x[None], w[None])[0]
    _check(x, w)
    if x.device.type == "cpu":
        return ref.conv2d_valid_ref(x, w)
    return _launch(x, w)


def _check(x, w):
    if x.dim() != 5 or w.dim() != 5:
        raise ValueError(f"member-batched conv takes x (k,B,H,W,Cin) and w "
                         f"(k,kh,kw,Cin,Cout), got {tuple(x.shape)} and "
                         f"{tuple(w.shape)}")
    k, B, H, W, Cin = x.shape
    km, kh, kw, Cin_w, Cout = w.shape
    if km != k or Cin_w != Cin:
        raise ValueError(f"w {tuple(w.shape)} does not match x "
                         f"{tuple(x.shape)} (members, input channels)")
    if min(k, B, Cin, Cout) < 1 or kh > H or kw > W or kh < 1 or kw < 1:
        raise ValueError(f"no valid output for x {tuple(x.shape)} and w "
                         f"{tuple(w.shape)}")
    if x.dtype != torch.float32 or w.dtype != torch.float32:
        raise TypeError(f"conv2d takes float32, got {x.dtype} and {w.dtype}")
    if x.device != w.device:
        raise ValueError(f"x on {x.device}, w on {w.device}")
    if (x.requires_grad or w.requires_grad) and torch.is_grad_enabled():
        raise NotImplementedError(
            "conv2d is forward-only in this slice: its backward kernel "
            "comes with the SGD-epochs slice")


def _launch(x, w):
    if not x.is_cuda:
        raise ValueError(f"conv2d runs on CPU or CUDA tensors, got {x.device}")
    if not (x.is_contiguous() and w.is_contiguous()):
        raise ValueError("the conv2d kernel takes contiguous x and w")
    k, B, H, W, Cin = x.shape
    _, kh, kw, _, Cout = w.shape
    if kh * kw * Cin * Cout * 4 > MAX_WEIGHT_BYTES:
        raise ValueError(f"w {tuple(w.shape)} exceeds the kernel's "
                         f"{MAX_WEIGHT_BYTES}-byte shared-memory stage")
    if k > 65535:
        raise ValueError(f"at most 65535 members per launch, got {k}")
    if max(B * H * W * Cin, B * (H - kh + 1) * (W - kw + 1) * Cout) > 2**30:
        raise ValueError("one member's x or y exceeds the kernel's 32-bit "
                         "indexing; split the batch")
    y = torch.empty((k, B, H - kh + 1, W - kw + 1, Cout),
                    dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        kernels.launch("conv2d", x.data_ptr(), w.data_ptr(), y.data_ptr(),
                       k, B, H, W, Cin, kh, kw, Cout)
    return y
