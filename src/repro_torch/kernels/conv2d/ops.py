"""The conv2d wrappers: a valid, stride-1 NHWC convolution with HWIO weights,
and its two gradients.

A CPU tensor goes to the plain versions (``ref.py``), a CUDA tensor to the
hand kernels in ``csrc/conv2d.cu`` and ``csrc/conv2d_wgrad.cu``; nothing
falls back from one to the other.

``conv2d_valid`` is differentiable: where autograd records it, it runs as
``Conv2dValid``, whose backward is

* dX (only where the input needs a gradient): the valid convolution of dY
  padded by kh-1 rows and kw-1 columns on each side, with the weights
  turned by 180° and Cin and Cout swapped — the forward kernel again
  (``conv2d_input_grad``);
* dW (always): ``conv2d_weight_grad``, the patch matrix's transpose times
  dY, by its own kernel in two launches (partial sums over chunks of
  images, then their sum in chunk order).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch import kernels
from repro_torch.kernels.conv2d import ref

# the kernel stages one member's weights in shared memory beside its image
# tile; 48 KB of weights leave room for a tile of one output pixel (whose
# input patch is no larger than the weights) in what a block may take
MAX_WEIGHT_BYTES = 48 * 1024
# the weight gradient's launches per call, and the image chunks a member's
# batch is cut into (the chunking is a function of B alone, so dW does not
# depend on k); one band of one output row must fit in 48 KB of shared
# memory beside the block's 4 KB of sums
WGRAD_PASSES = 2
WGRAD_CHUNKS = 48
WGRAD_SMEM_FLOATS = 12 * 1024 - 1024


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
    if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad):
        return Conv2dValid.apply(x, w)
    return _forward(x, w)


class Conv2dValid(torch.autograd.Function):
    """The member-batched conv with its backward through the hand kernels
    (or the plain versions, for CPU tensors)."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        return _forward(x, w)

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        dy = dy.contiguous()
        dx = conv2d_input_grad(dy, w) if ctx.needs_input_grad[0] else None
        return dx, conv2d_weight_grad(x, dy, w.shape[1], w.shape[2])


def conv2d_input_grad(dy, w):
    """dX of the member-batched conv: dy (k, B, OH, OW, Cout), w (k, kh, kw,
    Cin, Cout) -> (k, B, OH+kh-1, OW+kw-1, Cin)."""
    if dy.dim() != 5 or w.dim() != 5 or dy.shape[0] != w.shape[0] or \
            dy.shape[-1] != w.shape[-1]:
        raise ValueError(f"dy {tuple(dy.shape)} and w {tuple(w.shape)} are "
                         f"not a member-batched conv's")
    if dy.device.type == "cpu":
        return ref.conv2d_input_grad_ref(dy, w)
    kh, kw = w.shape[1], w.shape[2]
    padded = F.pad(dy, (0, 0, kw - 1, kw - 1, kh - 1, kh - 1))
    turned = w.flip(1, 2).transpose(3, 4).contiguous()
    _check(padded, turned)
    return _forward(padded, turned)


def conv2d_weight_grad(x, dy, kh: int, kw: int):
    """dW of the member-batched conv: x (k, B, H, W, Cin), dy (k, B, OH, OW,
    Cout) -> (k, kh, kw, Cin, Cout)."""
    if x.dim() != 5 or dy.dim() != 5:
        raise ValueError(f"x {tuple(x.shape)} and dy {tuple(dy.shape)} "
                         f"must be member-batched (5-d)")
    k, B, H, W, Cin = x.shape
    if tuple(dy.shape[:4]) != (k, B, H - kh + 1, W - kw + 1):
        raise ValueError(f"dy {tuple(dy.shape)} is not the output of x "
                         f"{tuple(x.shape)} under a {kh}x{kw} kernel")
    for a in (x, dy):
        if a.dtype != torch.float32:
            raise TypeError(f"conv2d_weight_grad takes float32, got "
                            f"{a.dtype}")
    if x.device != dy.device:
        raise ValueError(f"x on {x.device}, dy on {dy.device}")
    if x.device.type == "cpu":
        return ref.conv2d_weight_grad_ref(x, dy, kh, kw)
    return _launch_wgrad(x, dy, kh, kw)


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


def _forward(x, w):
    if x.device.type == "cpu":
        return ref.conv2d_valid_ref(x, w)
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


def _round4(n: int) -> int:
    return (n + 3) // 4 * 4


def _launch_wgrad(x, dy, kh, kw):
    if not x.is_cuda:
        raise ValueError(f"conv2d_weight_grad runs on CPU or CUDA tensors, "
                         f"got {x.device}")
    if not (x.is_contiguous() and dy.is_contiguous()):
        raise ValueError("the conv2d_wgrad kernel takes contiguous x and dy")
    k, B, H, W, Cin = x.shape
    Cout = dy.shape[-1]
    if k > 65535:
        raise ValueError(f"at most 65535 members per launch, got {k}")
    if _round4(kh * W * Cin) + _round4((W - kw + 1) * Cout) > \
            WGRAD_SMEM_FLOATS:
        raise ValueError(f"one output row of x {tuple(x.shape)} under a "
                         f"{kh}x{kw} kernel exceeds the conv2d_wgrad "
                         f"kernel's shared memory")
    group = -(-B // WGRAD_CHUNKS)              # images a chunk
    chunks = -(-B // group)
    outs = kh * kw * Cin * Cout
    part = torch.empty((k, chunks, outs), dtype=torch.float32,
                       device=x.device)
    dw = torch.empty((k, kh, kw, Cin, Cout), dtype=torch.float32,
                     device=x.device)
    with torch.cuda.device(x.device):
        kernels.launch("conv2d_wgrad", x.data_ptr(), dy.data_ptr(),
                       part.data_ptr(), dw.data_ptr(), k, B, H, W, Cin, kh,
                       kw, Cout, group, passes=WGRAD_PASSES)
    return dw
