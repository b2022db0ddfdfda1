"""The conv2d wrappers: a valid, stride-1 NHWC convolution with HWIO weights,
and its two gradients.

A CPU tensor goes to the plain versions (``ref.py``), any other tensor to
the operators ``repro_torch::conv2d``, ``conv2d_dgrad`` and
``conv2d_wgrad``: on a CUDA tensor the hand kernels in ``csrc/conv2d.cu``,
``csrc/conv2d_dgrad.cu`` and ``csrc/conv2d_wgrad.cu``, on a meta tensor
shapes only; nothing falls back from one to the other.

``conv2d_valid`` is differentiable: where autograd records it, it runs as
``Conv2dValid``, whose backward is

* dX (only where the input needs a gradient): ``conv2d_input_grad``, dY
  against the weights turned by 180°, by its own kernel, which reads dY
  unpadded and the weights in place and sums each output in the order of
  the valid convolution of dY padded by kh-1 rows and kw-1 columns;
* dW (always): ``conv2d_weight_grad``, the patch matrix's transpose times
  dY, by its own kernel in two launches (partial sums over chunks of
  images, then their sum in chunk order).
"""
from __future__ import annotations

import math

import torch

from repro_torch import kernels
from repro_torch.kernels.conv2d import ref

# the kernel stages one member's weights in shared memory beside its image
# tile; 48 KB of weights leave room for a tile of one output pixel (whose
# input patch is no larger than the weights) in what a block may take
MAX_WEIGHT_BYTES = 48 * 1024
# the weight gradient's launches per call, and the most image chunks a
# member's batch is cut into (the chunking is a function of B alone, so dW
# does not depend on k)
WGRAD_PASSES = 2
WGRAD_CHUNKS = 50
# shared memory the gradient kernels may take; dW needs a two-slot ring of
# one output row's band, dX a member's weights beside one dX row's band
GRAD_SMEM_BYTES = 160 * 1024


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
    for a in (dy, w):
        if a.dtype != torch.float32:
            raise TypeError(f"conv2d_input_grad takes float32, got "
                            f"{a.dtype}")
    if dy.device != w.device:
        raise ValueError(f"dy on {dy.device}, w on {w.device}")
    if dy.device.type == "cpu":
        return ref.conv2d_input_grad_ref(dy, w)
    return _launch_dgrad(dy, w)


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


def _device(x, name):
    if x.device.type not in ("cuda", "meta"):
        raise ValueError(f"{name} runs on CPU, CUDA or meta tensors, "
                         f"got {x.device}")


def _forward(x, w):
    if x.device.type == "cpu":
        return ref.conv2d_valid_ref(x, w)
    _device(x, "conv2d")
    return _FWD(x, w)


def _fwd_plan(x, w):
    """The output's shape, for contiguous operands the kernel takes."""
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
    return (k, B, H - kh + 1, W - kw + 1, Cout)


def _fwd_cuda(x, w):
    y = torch.empty(_fwd_plan(x, w), dtype=torch.float32, device=x.device)
    k, B, H, W, Cin = x.shape
    _, kh, kw, _, Cout = w.shape
    with torch.cuda.device(x.device):
        kernels.launch("conv2d", x.data_ptr(), w.data_ptr(), y.data_ptr(),
                       k, B, H, W, Cin, kh, kw, Cout)
    return y


def _fwd_fake(x, w):
    return torch.empty(_fwd_plan(x, w), dtype=torch.float32, device=x.device)


def conv2d_flops(dy_shape, kh: int, kw: int, Cin: int) -> int:
    """The products of the valid convolution whose output (or output
    cotangent) has ``dy_shape``: a multiply and an add for each output,
    tap and input channel. The forward, dW and dX each do this work
    (conv2d_dgrad's kernel also multiplies the zero columns at the edges,
    which are not counted)."""
    return 2 * math.prod(dy_shape) * kh * kw * Cin


_FWD = kernels.register(
    "conv2d", "(Tensor x, Tensor w) -> Tensor", _fwd_cuda, _fwd_fake,
    lambda x, w, *, out_shape=None: conv2d_flops(out_shape, w[1], w[2],
                                                 w[3]))


def _round4(n: int) -> int:
    return (n + 3) // 4 * 4


def _pitch48(n: int) -> int:
    """The kernels' pitch of a shared-memory row: a multiple of 4 floats
    that is 4 mod 8, so neighbouring rows start in other banks."""
    n = _round4(n)
    return n if n % 8 == 4 else n + 4


def wgrad_plan(B: int) -> tuple[int, int]:
    """(images a chunk, chunks a member) of the weight gradient's split of
    a member's batch: a function of B alone — not of k, the shape's other
    sizes or the card — so a member's dW is the same bits however many
    members share the launch."""
    group = -(-B // WGRAD_CHUNKS)
    return group, -(-B // group)


def _launch_wgrad(x, dy, kh, kw):
    _device(x, "conv2d_weight_grad")
    return _WGRAD(x, dy, kh, kw)[0]


def _wgrad_plan(x, dy, kh, kw):
    """(images a chunk, the partial sums' shape, dW's shape)."""
    if not (x.is_contiguous() and dy.is_contiguous()):
        raise ValueError("the conv2d_wgrad kernel takes contiguous x and dy")
    k, B, H, W, Cin = x.shape
    Cout = dy.shape[-1]
    if k > 65535:
        raise ValueError(f"at most 65535 members per launch, got {k}")
    # a ring of two slots, each the x rows and the dY row of one output row
    if 8 * (_round4(kh * _pitch48(W * Cin)) + _pitch48((W - kw + 1) * Cout)) \
            > GRAD_SMEM_BYTES:
        raise ValueError(f"one output row of x {tuple(x.shape)} under a "
                         f"{kh}x{kw} kernel exceeds the conv2d_wgrad "
                         f"kernel's shared memory")
    group, chunks = wgrad_plan(B)
    return (group, (k, chunks, kh * kw * Cin * Cout),
            (k, kh, kw, Cin, Cout))


def _wgrad_outputs(x, part, dw):
    return (torch.empty(dw, dtype=torch.float32, device=x.device),
            torch.empty(part, dtype=torch.float32, device=x.device))


def _wgrad_cuda(x, dy, kh, kw):
    group, part, dw = _wgrad_plan(x, dy, kh, kw)
    dw, part = _wgrad_outputs(x, part, dw)
    k, B, H, W, Cin = x.shape
    with torch.cuda.device(x.device):
        kernels.launch("conv2d_wgrad", x.data_ptr(), dy.data_ptr(),
                       part.data_ptr(), dw.data_ptr(), k, B, H, W, Cin, kh,
                       kw, dy.shape[-1], group, passes=WGRAD_PASSES)
    return dw, part


def _wgrad_fake(x, dy, kh, kw):
    return _wgrad_outputs(x, *_wgrad_plan(x, dy, kh, kw)[1:])


# outputs (dW, the per-chunk partial sums: a workspace)
_WGRAD = kernels.register(
    "conv2d_wgrad", "(Tensor x, Tensor dy, int kh, int kw) -> (Tensor, "
    "Tensor)", _wgrad_cuda, _wgrad_fake,
    lambda x, dy, kh, kw, *, out_shape=None: conv2d_flops(dy, kh, kw, x[4]))


def _launch_dgrad(dy, w):
    _device(dy, "conv2d_input_grad")
    return _DGRAD(dy, w)


def _dgrad_plan(dy, w):
    """dX's shape, for contiguous operands the kernel takes."""
    if not (dy.is_contiguous() and w.is_contiguous()):
        raise ValueError("the conv2d_dgrad kernel takes contiguous dy and w")
    k, B, OH, OW, Cout = dy.shape
    _, kh, kw, Cin, _ = w.shape
    H, W = OH + kh - 1, OW + kw - 1
    if k > 65535:
        raise ValueError(f"at most 65535 members per launch, got {k}")
    if max(B * OH * OW * Cout, B * H * W * Cin) > 2**30:
        raise ValueError("one member's dy or dx exceeds the kernel's 32-bit "
                         "indexing; split the batch")
    # the weights, and the dY rows one dX row reads, padded by kw-1
    # zero columns on each side (and to a group of up to 4 pixels)
    weights = _round4(kh * kw * Cin * Cout)
    band = _pitch48(min(OH, kh) * _round4((W + 3 + kw - 1) * Cout))
    if 4 * (weights + band) > GRAD_SMEM_BYTES:
        raise ValueError(f"w {tuple(w.shape)} and one dX row of "
                         f"{W} x {Cin} exceed the conv2d_dgrad kernel's "
                         f"shared memory")
    return (k, B, H, W, Cin)


def _dgrad_cuda(dy, w):
    dx = torch.empty(_dgrad_plan(dy, w), dtype=torch.float32,
                     device=dy.device)
    k, B, H, W, Cin = dx.shape
    _, kh, kw, _, Cout = w.shape
    with torch.cuda.device(dy.device):
        kernels.launch("conv2d_dgrad", dy.data_ptr(), w.data_ptr(),
                       dx.data_ptr(), k, B, H, W, Cin, kh, kw, Cout)
    return dx


def _dgrad_fake(dy, w):
    return torch.empty(_dgrad_plan(dy, w), dtype=torch.float32,
                       device=dy.device)


_DGRAD = kernels.register(
    "conv2d_dgrad", "(Tensor dy, Tensor w) -> Tensor", _dgrad_cuda,
    _dgrad_fake, lambda dy, w, *, out_shape=None: conv2d_flops(
        dy, w[1], w[2], w[3]))
