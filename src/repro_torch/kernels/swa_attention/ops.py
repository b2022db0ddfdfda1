"""The swa_attention wrapper: causal sliding-window attention with GQA.

A CPU tensor goes to the plain version (``ref.swa_attention_ref``), a CUDA
tensor to the hand kernel in ``csrc/swa_attention.cu``; nothing falls back
from one to the other. q is (B, S, H, hd), k and v (B, S, KV, hd), all f32
or all bf16; the softmax and sums are f32 and the output has q's dtype.
The kernel has no backward: on the card, an operand that requires grad is
refused while grad mode is on (the CPU route stays differentiable).
"""
from __future__ import annotations

import torch

from repro_torch import kernels
from repro_torch.kernels.swa_attention import ref

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_HEAD_DIM = 128


def swa_attention(q, k, v, *, window: int):
    """Query i attends to keys j with j <= i and i - j < ``window``.
    q: (B, S, H, hd); k, v: (B, S, KV, hd) -> (B, S, H, hd)."""
    _check(q, k, v, window)
    if q.device.type == "cpu":
        return ref.swa_attention_ref(q, k, v, window=window)
    return _launch(q, k, v, window)


def _check(q, k, v, window):
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"swa_attention takes q (B,S,H,hd) and k, v "
                         f"(B,S,KV,hd), got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    B, S, H, hd = q.shape
    KV = k.shape[2]
    if k.shape != (B, S, KV, hd) or KV < 1 or H % KV:
        raise ValueError(f"k {tuple(k.shape)} does not match q "
                         f"{tuple(q.shape)} (heads must be a multiple of "
                         f"kv heads)")
    if min(B, S, H, hd) < 1:
        raise ValueError(f"empty operand: q {tuple(q.shape)}")
    if window < 1:
        raise ValueError(f"window must be >= 1, got {window}")
    for a in (k, v):
        if a.dtype != q.dtype:
            raise TypeError(f"q, k and v must share a dtype, got {q.dtype} "
                            f"and {a.dtype}")
        if a.device != q.device:
            raise ValueError(f"operands on {q.device} and {a.device}")
    if q.dtype not in _DTYPES:
        raise TypeError(f"swa_attention takes float32 or bfloat16, "
                        f"got {q.dtype}")


def _launch(q, k, v, window):
    if not q.is_cuda:
        raise ValueError(f"swa_attention runs on CPU or CUDA tensors, "
                         f"got {q.device}")
    kernels.refuse_grad("swa_attention", (q, k, v))
    if not all(a.is_contiguous() for a in (q, k, v)):
        raise ValueError("the swa_attention kernel takes contiguous operands")
    B, S, H, hd = q.shape
    if hd > MAX_HEAD_DIM:
        raise ValueError(f"the swa_attention kernel takes head_dim <= "
                         f"{MAX_HEAD_DIM}, got {hd}")
    if B * H > 65535 or q.numel() > 2**31 - 1:
        raise ValueError(f"q {tuple(q.shape)} is too large for one launch")
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        kernels.launch("swa_attention", q.data_ptr(), k.data_ptr(),
                       v.data_ptr(), out.data_ptr(), B, S, H, k.shape[2], hd,
                       min(int(window), S), hd ** -0.5, _DTYPES[q.dtype])
    return out
