"""The swa_attention wrapper: causal sliding-window attention with GQA,
or, with ``causal=False``, attention over every key (the encoder's).

A CPU tensor goes to the plain version (``ref.swa_attention_ref``), any
other tensor to the operators ``repro_torch::swa_attention`` and
``repro_torch::swa_attention_bwd``: on a CUDA tensor the hand kernels
behind the entry points of ``csrc/swa_attention.cu`` and
``csrc/swa_attention_bwd.cu``, on a meta tensor shapes only; nothing
falls back from one to the other. The entry points pick the kernels by
dtype: bf16 on the ``wgmma`` and TMA kernels of ``csrc/swa_full_fwd.cu``
and ``csrc/swa_full_bwd.cu`` (both modes), f32 on the CUDA cores. q is
(B, S, H, hd), k and v (B, S, KV, hd), all f32 or all bf16; the softmax
and sums are f32 and the output has q's dtype.
On the CPU autograd differentiates the plain version. On the card a call
that autograd records is a ``torch.autograd.Function``: its forward also
writes each row's log-sum-exp, and its backward is the kernels of
``csrc/swa_attention_bwd.cu`` (one ``swa_attention_bwd`` launch a call),
in either mode (the non-causal mode's kernels are
``csrc/swa_full_bwd.cu``'s); a call it does not record (serving, under
``torch.no_grad()``) passes the kernel a null log-sum-exp.
"""
from __future__ import annotations

import torch

from repro_torch import kernels
from repro_torch.kernels.swa_attention import ref

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_HEAD_DIM = 128
MAX_GRID_Y = 65535                 # B·H blocks a launch
MAX_LAUNCH_ELEMENTS = 2**31 - 1    # q's elements a launch


def swa_attention(q, k, v, *, window: int, causal: bool = True):
    """Query i attends to keys j with j <= i and i - j < ``window``; with
    ``causal=False`` to every key j < S, and ``window`` must be S.
    q: (B, S, H, hd); k, v: (B, S, KV, hd) -> (B, S, H, hd)."""
    _check(q, k, v, window, causal)
    if q.device.type == "cpu":
        return ref.swa_attention_ref(q, k, v, window=window, causal=causal)
    if q.device.type not in ("cuda", "meta"):
        raise ValueError(f"swa_attention runs on CPU, CUDA or meta tensors, "
                         f"got {q.device}")
    if kernels.needs_grad((q, k, v)):
        return _SWAAttention.apply(q, k, v, window, causal)
    return _launch(q, k, v, window, with_lse=False, causal=causal)[0]


def _check(q, k, v, window, causal=True):
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
    if not causal and window != S:
        raise ValueError(f"non-causal attention sees every key: window must "
                         f"be S = {S}, got {window}")
    for a in (k, v):
        if a.dtype != q.dtype:
            raise TypeError(f"q, k and v must share a dtype, got {q.dtype} "
                            f"and {a.dtype}")
        if a.device != q.device:
            raise ValueError(f"operands on {q.device} and {a.device}")
    if q.dtype not in _DTYPES:
        raise TypeError(f"swa_attention takes float32 or bfloat16, "
                        f"got {q.dtype}")


def _launch_checks(q, k, v):
    if not all(a.is_contiguous() for a in (q, k, v)):
        raise ValueError("the swa_attention kernel takes contiguous operands")
    B, S, H, hd = q.shape
    if hd > MAX_HEAD_DIM:
        raise ValueError(f"the swa_attention kernel takes head_dim <= "
                         f"{MAX_HEAD_DIM}, got {hd}")
    if B * H > MAX_GRID_Y or q.numel() > MAX_LAUNCH_ELEMENTS:
        raise ValueError(f"q {tuple(q.shape)} is too large for one launch")


def _batches(q):
    """Slices of the batch, each within one launch's limits (B·H blocks
    of the grid's y dimension at most 65,535, q's elements below 2^31 for
    the kernels' 32-bit indexing). Every sequence is attended on its own,
    so a split launch writes each output bit as one launch would."""
    B, S, H, hd = q.shape
    step = min(MAX_GRID_Y // H, MAX_LAUNCH_ELEMENTS // (S * H * hd))
    if step < 1:
        raise ValueError(f"one sequence of q {tuple(q.shape)} is too large "
                         f"for one launch")
    return [slice(b, min(b + step, B)) for b in range(0, B, step)]


def _launch(q, k, v, window, *, with_lse: bool, causal: bool = True):
    """(out, lse): the forward kernel, one launch a slice of the batch
    (``_batches``; one for every shape the configs serve up to 4 × 32k);
    lse (B, H, S) f32 when ``with_lse``, else None (the kernel gets a null
    pointer)."""
    outs = [_FWD(q[sl], k[sl], v[sl], int(window), bool(causal), with_lse)
            for sl in _batches(q)]
    out, lse = outs[0] if len(outs) == 1 else (
        torch.cat([o for o, _ in outs]), torch.cat([m for _, m in outs]))
    return out, (lse if with_lse else None)


def _fwd_outputs(q, with_lse):
    B, S, H, _ = q.shape
    return torch.empty_like(q), torch.empty(
        (B, H, S) if with_lse else (0,), dtype=torch.float32,
        device=q.device)


def _fwd_cuda(q, k, v, window, causal, with_lse):
    _launch_checks(q, k, v)
    B, S, H, hd = q.shape
    out, lse = _fwd_outputs(q, with_lse)
    with torch.cuda.device(q.device):
        kernels.launch("swa_attention", q.data_ptr(), k.data_ptr(),
                       v.data_ptr(), out.data_ptr(),
                       lse.data_ptr() if with_lse else None, B, S, H,
                       k.shape[2], hd, min(window, S), int(causal),
                       hd ** -0.5, _DTYPES[q.dtype])
    return out, lse


def _fwd_fake(q, k, v, window, causal, with_lse):
    _launch_checks(q, k, v)
    return _fwd_outputs(q, with_lse)


def pairs_in_mask(B: int, S: int, H: int, window: int,
                  causal: bool = True) -> int:
    """The (query, key) pairs of B·H heads of S queries that the mask
    keeps: Σ_t min(t + 1, W) a head with W = min(window, S), or S² a head
    without ``causal``."""
    if not causal:
        return B * H * S * S
    W = min(window, S)
    return B * H * (W * (W + 1) // 2 + (S - W) * W)


def swa_flops(B: int, S: int, H: int, hd: int, window: int,
              causal: bool = True) -> int:
    """The forward's work: 4·hd a (query, key) pair inside the mask (the
    score q·k and the product by v). Tiles or parts of tiles that the
    causal or window mask skips are not counted, nor the softmax."""
    return 4 * hd * pairs_in_mask(B, S, H, window, causal)


def swa_bwd_flops(B: int, S: int, H: int, hd: int, window: int,
                  causal: bool = True) -> int:
    """The backward's work: 10·hd a (query, key) pair inside the mask (the
    recomputed score, dO·vᵀ, dV, dQ and dK); masked pairs are not
    counted, nor the D pre-pass."""
    return 10 * hd * pairs_in_mask(B, S, H, window, causal)


# outputs (out, lse: (B, H, S) f32 with ``with_lse``, else empty)
_FWD = kernels.register(
    "swa_attention",
    "(Tensor q, Tensor k, Tensor v, int window, bool causal, bool with_lse)"
    " -> (Tensor, Tensor)", _fwd_cuda, _fwd_fake,
    lambda q, k, v, window, causal, with_lse, *, out_shape=None: swa_flops(
        q[0], q[1], q[2], q[3], window, causal))


def swa_attention_fwd(q, k, v, *, window: int, causal: bool = True):
    """The forward kernel with its log-sum-exp: (out, lse (B, H, S) f32),
    what the backward recomputes P from. Contiguous CUDA operands; an
    operand that requires grad is refused while grad mode is on (the
    differentiable call is ``swa_attention``)."""
    _check(q, k, v, window, causal)
    if q.device.type not in ("cuda", "meta"):
        raise ValueError(f"swa_attention_fwd runs on CUDA or meta tensors, "
                         f"got {q.device}")
    kernels.refuse_grad("swa_attention_fwd", (q, k, v))
    return _launch(q, k, v, window, with_lse=True, causal=causal)


def swa_attention_bwd(q, k, v, out, lse, dout, *, window: int,
                      causal: bool = True):
    """The backward kernels: (dq, dk, dv) in q's dtype from the forward's
    operands, its output, its log-sum-exp and the output cotangent (copied
    once if not contiguous). dk and dv sum over the GQA group inside one
    block each, in a fixed order, with no atomics. ``causal=False``: the
    backward of the mode over every key (``window`` must be S), from the
    log-sum-exp of the forward's non-causal mode."""
    _check(q, k, v, window, causal)
    B, S, H, hd = q.shape
    if out.shape != q.shape or dout.shape != q.shape or \
            out.dtype != q.dtype or dout.dtype != q.dtype:
        raise ValueError("out and dout must match q's shape and dtype")
    if lse.shape != (B, H, S) or lse.dtype != torch.float32:
        raise ValueError(f"lse must be (B, H, S) float32, got "
                         f"{tuple(lse.shape)} {lse.dtype}")
    if not (out.is_contiguous() and lse.is_contiguous()):
        raise ValueError("the swa_attention backward takes a contiguous "
                         "out and lse")
    dout = dout.contiguous()
    grads = [_BWD(q[sl], k[sl], v[sl], out[sl], lse[sl], dout[sl],
                  int(window), bool(causal))[:3] for sl in _batches(q)]
    if len(grads) == 1:
        return grads[0]
    return tuple(torch.cat(g) for g in zip(*grads))


def _bwd_outputs(q, k, v):
    B, S, H, _ = q.shape
    return (torch.empty_like(q), torch.empty_like(k), torch.empty_like(v),
            torch.empty((B, H, S), dtype=torch.float32, device=q.device))


def _bwd_cuda(q, k, v, out, lse, dout, window, causal):
    _launch_checks(q, k, v)
    B, S, H, hd = q.shape
    dq, dk, dv, delta = _bwd_outputs(q, k, v)
    with torch.cuda.device(q.device):
        kernels.launch("swa_attention_bwd", q.data_ptr(), k.data_ptr(),
                       v.data_ptr(), out.data_ptr(), dout.data_ptr(),
                       lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
                       dk.data_ptr(), dv.data_ptr(), B, S, H, k.shape[2], hd,
                       min(window, S), int(causal), hd ** -0.5,
                       _DTYPES[q.dtype])
    return dq, dk, dv, delta


def _bwd_fake(q, k, v, out, lse, dout, window, causal):
    _launch_checks(q, k, v)
    return _bwd_outputs(q, k, v)


# outputs (dq, dk, dv, delta = rowsum(dO∘O): the pre-pass's workspace)
_BWD = kernels.register(
    "swa_attention_bwd",
    "(Tensor q, Tensor k, Tensor v, Tensor out, Tensor lse, Tensor dout, "
    "int window, bool causal) -> (Tensor, Tensor, Tensor, Tensor)",
    _bwd_cuda, _bwd_fake,
    lambda q, k, v, out, lse, dout, window, causal, *, out_shape=None:
    swa_bwd_flops(q[0], q[1], q[2], q[3], window, causal))


class _SWAAttention(torch.autograd.Function):
    """The forward kernel (with its log-sum-exp) and the backward kernels
    under autograd, in either mode; saves q, k, v, the output and the
    log-sum-exp."""

    @staticmethod
    def forward(ctx, q, k, v, window, causal):
        out, lse = _launch(q, k, v, window, with_lse=True, causal=causal)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.window, ctx.causal = window, causal
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = swa_attention_bwd(q, k, v, out, lse, dout,
                                       window=ctx.window, causal=ctx.causal)
        return dq, dk, dv, None, None
