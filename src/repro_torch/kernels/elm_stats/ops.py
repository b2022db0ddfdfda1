"""The elm_stats wrapper: U = Hᵀdiag(m)H and V = Hᵀdiag(m)T in one pass.

A CPU tensor goes to the plain version (``ref.elm_stats_ref``), any other
tensor to the operator ``repro_torch::elm_stats``: on a CUDA tensor the
hand kernel in ``csrc/elm_stats.cu``, on a meta tensor shapes only;
nothing falls back from one to the other. Both produce one (L, L+C)
block per member, and U and V are views of it. The kernel has no
backward: on the card, an operand that requires grad is refused while
grad mode is on (the CPU route stays differentiable).
"""
from __future__ import annotations

import torch

from repro_torch import kernels
from repro_torch.kernels.elm_stats import ref


def elm_stats(h, t, *, mask=None):
    """h: (n, L) features, t: (n, C) targets, mask: optional (n,) row weights
    -> (U (L, L), V (L, C)) in f32; or the member-batched form h: (k, n, L),
    t: (k, n, C), mask: (k, n) -> (U (k, L, L), V (k, L, C))."""
    if h.dim() == 2:
        u, v = elm_stats(h[None], t[None],
                         mask=None if mask is None else mask[None])
        return u[0], v[0]
    _check(h, t, mask)
    if h.device.type == "cpu":
        out = ref.elm_stats_ref(h, t, mask)
    else:
        out = _launch(h, t, mask)
    L = h.shape[-1]
    return out[..., :L], out[..., L:]


def _check(h, t, mask):
    if h.dim() != 3 or t.dim() != 3:
        raise ValueError(f"member-batched elm_stats takes h (k,n,L) and t "
                         f"(k,n,C), got {tuple(h.shape)} and {tuple(t.shape)}")
    k, n, L = h.shape
    if t.shape[:2] != (k, n):
        raise ValueError(f"t {tuple(t.shape)} does not match h "
                         f"{tuple(h.shape)}")
    if min(k, n, L, t.shape[2]) < 1:
        raise ValueError(f"empty operand: h {tuple(h.shape)}, "
                         f"t {tuple(t.shape)}")
    tensors = (h, t) if mask is None else (h, t, mask)
    if mask is not None and mask.shape != (k, n):
        raise ValueError(f"mask {tuple(mask.shape)} does not match the "
                         f"({k}, {n}) rows of h")
    for a in tensors:
        if a.dtype != torch.float32:
            raise TypeError(f"elm_stats takes float32, got {a.dtype}")
        if a.device != h.device:
            raise ValueError(f"operands on {h.device} and {a.device}")


def _launch(h, t, mask):
    if h.device.type not in ("cuda", "meta"):
        raise ValueError(f"elm_stats runs on CPU, CUDA or meta tensors, "
                         f"got {h.device}")
    kernels.refuse_grad("elm_stats", (h, t) if mask is None else (h, t, mask))
    return _OP(h, t, mask)


def _plan(h, t, mask):
    """(k, n, L, C) of contiguous operands the kernel takes."""
    tensors = (h, t) if mask is None else (h, t, mask)
    if not all(a.is_contiguous() for a in tensors):
        raise ValueError("the elm_stats kernel takes contiguous operands")
    k, n, L = h.shape
    if k > 65535:
        raise ValueError(f"at most 65535 members per launch, got {k}")
    return k, n, L, t.shape[2]


def _cuda(h, t, mask):
    k, n, L, C = _plan(h, t, mask)
    out = torch.empty((k, L, L + C), dtype=torch.float32, device=h.device)
    with torch.cuda.device(h.device):
        kernels.launch("elm_stats", h.data_ptr(), t.data_ptr(),
                       None if mask is None else mask.data_ptr(),
                       out.data_ptr(), k, n, L, C)
    return out


def _fake(h, t, mask):
    k, n, L, C = _plan(h, t, mask)
    return torch.empty((k, L, L + C), dtype=torch.float32, device=h.device)


def elm_stats_flops(k: int, n: int, L: int, C: int,
                    masked: bool = False) -> int:
    """The work of k members' stats over n rows: U is symmetric, so its
    pairs i <= j (L·(L+1) a row, a multiply and an add each) and all of V
    (2·L·C a row); with a mask, one product a row and feature more."""
    return k * n * (L * (L + 1) + 2 * L * C) + (k * n * L if masked else 0)


_OP = kernels.register(
    "elm_stats", "(Tensor h, Tensor t, Tensor? mask) -> Tensor", _cuda,
    _fake, lambda h, t, mask, *, out_shape=None: elm_stats_flops(
        h[0], h[1], h[2], t[2], mask is not None))
