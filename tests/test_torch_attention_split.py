"""The arithmetic of the non-causal attention kernels on the card
(``csrc/swa_full_fwd.cu``, ``csrc/swa_full_bwd.cu``), modelled in plain
PyTorch on the CPU and held against the plain versions
(``swa_attention_ref``, ``swa_attention_bwd_ref``) within the card tests'
bars.

The kernels' products are warpgroup products of bf16 operands with f32
sums, 16 columns (a k-step) at a time; the weights P of P.V, and P and dS
of the backward's products into dV, dK and dQ, are f32 and are each split
into bf16 hi + lo, both products added into the one f32 sum. The model
does the same: each k-step's partial product exactly (f64, products of
bf16 values), rounded to f32 and added in k-step order; the online
softmax over 64-key tiles in log2 units, each weight one fused
multiply-add and exp2; hi truncated to bf16, lo rounded to nearest.

A second case pins why the split stays: where V's rows cancel in the
output, P rounded once to bf16 misses the forward's elementwise bar (rtol
2^-7, the card test's) while hi + lo meets it.
"""
from __future__ import annotations

import math

import numpy as np
import pytest
import torch

from repro_torch.kernels.swa_attention import ref

torch.set_num_threads(2)

KSTEP = 16
TILE = 64


def _bf16(x):
    return x.to(torch.bfloat16).float()


def _split(x, split=True):
    """x (f32) -> (hi, lo) as the kernels split it: hi is x truncated to
    bf16 (its top 16 bits), lo the rest rounded to nearest bf16. Without
    ``split``: x rounded once to nearest, lo 0."""
    if not split:
        return _bf16(x), torch.zeros_like(x)
    hi = (x.contiguous().view(torch.int32) & -65536).view(torch.float32)
    return hi, _bf16(x - hi)


def _fma_exp2(s, c, m):
    """exp2 of s * c - m with one rounding (the kernels' fmaf), in f32."""
    return torch.exp2((s.double() * c - m.double()).float())


def _kstep(a, b):
    """a (..., M, K) . b (..., K, N) as the kernels sum it: each 16-wide
    k-step exactly, rounded to f32, added in order into an f32 sum."""
    out = torch.zeros(a.shape[:-1] + b.shape[-1:], dtype=torch.float32)
    for k0 in range(0, a.shape[-1], KSTEP):
        part = (a[..., k0:k0 + KSTEP].double()
                @ b[..., k0:k0 + KSTEP, :].double())
        out = out + part.float()
    return out


def _split_product(x, b, split=True):
    """x (f32 weights) . b, x split into hi + lo: for each k-step, hi's
    product then lo's, into one f32 sum."""
    hi, lo = _split(x, split)
    out = torch.zeros(x.shape[:-1] + b.shape[-1:], dtype=torch.float32)
    for k0 in range(0, x.shape[-1], KSTEP):
        bk = b[..., k0:k0 + KSTEP, :].double()
        out = out + (hi[..., k0:k0 + KSTEP].double() @ bk).float()
        out = out + (lo[..., k0:k0 + KSTEP].double() @ bk).float()
    return out


def model_forward(q, k, v, split=True):
    """The forward kernel's arithmetic: (out in q's dtype, lse)."""
    B, S, H, hd = q.shape
    G = H // k.shape[2]
    scale_log2 = np.float32(hd ** -0.5) * np.float32(math.log2(math.e))
    out = torch.empty(B, S, H, hd, dtype=torch.float32)
    lse = torch.empty(B, H, S, dtype=torch.float32)
    for b in range(B):
        for h in range(H):
            qh, kh, vh = q[b, :, h].float(), k[b, :, h // G].float(), \
                v[b, :, h // G].float()
            m = torch.full((S,), -1e30)
            l = torch.zeros(S)
            acc = torch.zeros(S, hd)
            for k0 in range(0, S, TILE):
                kt, vt = kh[k0:k0 + TILE], vh[k0:k0 + TILE]
                a = _kstep(qh, kt.T)
                m_new = torch.maximum(m, a.max(-1).values * scale_log2)
                alpha = torch.exp2(m - m_new)
                p = _fma_exp2(a, float(scale_log2), m_new[:, None])
                l = l * alpha + p.sum(-1)
                m = m_new
                acc = acc * alpha[:, None] + _split_product(p, vt, split)
            out[b, :, h] = acc / torch.clamp(l, min=1e-30)[:, None]
            lse[b, h] = m * math.log(2) + torch.log(
                torch.clamp(l, min=1e-30))
    return out.to(q.dtype), lse


def model_backward(q, k, v, o, lse, do):
    """The backward kernels' arithmetic: (dq, dk, dv) in q's dtype."""
    B, S, H, hd = q.shape
    KV = k.shape[2]
    G = H // KV
    scale = np.float32(hd ** -0.5)
    log2e = np.float32(math.log2(math.e))
    dq = torch.zeros(B, S, H, hd)
    dk = torch.zeros(B, S, KV, hd)
    dv = torch.zeros(B, S, KV, hd)
    delta = (do.float() * o.float()).sum(-1)            # (B, S, H)
    for b in range(B):
        for kvh in range(KV):
            kh, vh = k[b, :, kvh].float(), v[b, :, kvh].float()
            for g in range(G):
                h = kvh * G + g
                qh, doh = q[b, :, h].float(), do[b, :, h].float()
                s = _kstep(qh, kh.T)
                # P = exp2(s scale log2(e) - lse log2(e))
                p = _fma_exp2(s, float(scale * log2e),
                              lse[b, h][:, None] * log2e)
                dp = _kstep(doh, vh.T)
                ds = p * (dp - delta[b, :, h][:, None])
                # dK/dV: over the group's heads, then query k-steps
                dv[b, :, kvh] += _split_product(p.T, doh)
                dk[b, :, kvh] += _split_product(ds.T, qh)
                dq[b, :, h] = _split_product(ds, kh) * scale
    dk = dk * scale
    return dq.to(q.dtype), dk.to(q.dtype), dv.to(q.dtype)


def _inputs(seed, B, S, H, KV, hd):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal((B, S, n, hd),
                                                 dtype=np.float32))
            .to(torch.bfloat16) for n in (H, KV, KV, H)]


def _fwd_close(got, want):
    """The card test's forward bar: rtol 2^-7, atol 1e-5 · max|ref|."""
    g, w = got.float(), want.float()
    return bool(((g - w).abs() <= 2.0 ** -7 * w.abs()
                 + 1e-5 * float(w.abs().max())).all())


def _bwd_bar(ref_g, truth):
    """The card tests' backward bar: 2 bf16 ulps of max|ref|, or twice the
    plain version's own distance from the f64 truth."""
    top = float(ref_g.float().abs().max())
    ulp = 2.0 ** (math.floor(math.log2(top)) - 7)
    return max(2 * ulp, 2 * float((ref_g.double() - truth).abs().max()))


@pytest.mark.parametrize("KV", [2, 1])     # G = 1 and G = 2
def test_split_model_matches_plain_versions(KV):
    """hd 80 (HuBERT's), S 100 (a ragged second key tile), non-causal: the
    model's forward within the forward bar of the plain version, its
    log-sum-exp within 1e-5, its dq, dk, dv within the backward bars."""
    B, S, H, hd = 1, 100, 2, 80
    q, k, v, do = _inputs(7 + KV, B, S, H, KV, hd)
    out, lse = model_forward(q, k, v)
    want = ref.swa_attention_ref(q, k, v, window=S, causal=False)
    assert _fwd_close(out, want)
    want_lse = ref.swa_attention_lse_ref(q, k, window=S, causal=False)
    np.testing.assert_allclose(lse.numpy(), want_lse.numpy(), rtol=1e-5,
                               atol=1e-5)
    got = model_backward(q, k, v, want, want_lse, do)
    plain = ref.swa_attention_bwd_ref(q, k, v, want, want_lse, do, window=S,
                                      causal=False)
    truth = ref.swa_attention_bwd_ref(
        *(a.double() for a in (q, k, v, want, want_lse, do)), window=S,
        causal=False)
    for g, p, t in zip(got, plain, truth):
        assert g.shape == p.shape and g.dtype == torch.bfloat16
        err = float((g.double() - t).abs().max())
        assert err <= _bwd_bar(p, t), (err, _bwd_bar(p, t))


def test_split_meets_the_forward_bar_where_rounding_once_misses():
    """Keys in pairs with nearly equal scores and opposite values: each
    output but the first column's is a sum of small differences of
    weights. P rounded once to bf16 (2^-8 of each weight) moves those
    outputs past rtol 2^-7; P as hi + lo (2^-15) keeps them within it."""
    B, S, H, KV, hd = 1, 64, 2, 2, 80
    rng = np.random.default_rng(3)
    q = rng.standard_normal((B, S, H, hd), dtype=np.float32)
    k = rng.standard_normal((B, S, KV, hd), dtype=np.float32)
    k[:, 1::2] = k[:, 0::2] + 0.05 * rng.standard_normal(
        (B, S // 2, KV, hd), dtype=np.float32)
    v = rng.standard_normal((B, S, KV, hd), dtype=np.float32)
    # every column but the first cancels (the first sets max|out|, and so
    # the bar's atol, at a size of a plain output)
    v[:, 1::2, :, 1:] = -v[:, 0::2, :, 1:]
    v[:, :, :, 0] = np.abs(v[:, :, :, 0])
    q, k, v = (torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v))
    want = ref.swa_attention_ref(q, k, v, window=S, causal=False)
    split, _ = model_forward(q, k, v, split=True)
    once, _ = model_forward(q, k, v, split=False)
    assert _fwd_close(split, want)
    assert not _fwd_close(once, want)
