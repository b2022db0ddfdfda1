"""The LM training path's gradients in the port against the reference's.

The port's plain backward versions (``rmsnorm_bwd_ref``,
``swa_attention_bwd_ref``, the formulas its CUDA kernels compute, held
against the kernels on the card by ``test_torch_cuda.py``) are held
against ``jax.vjp`` of the reference's jnp functions (``repro.layers.norms
.rms_norm`` and ``repro.kernels.swa_attention.ref``) and against torch
autograd of the port's plain forwards, on the same numpy inputs; then the
reduced qwen3_8b ``loss_fn`` and the gradient of every leaf against
``jax.value_and_grad(repro.models.api.loss_fn)`` from the reference's init.

Tolerances (stated per test): f32 — the same math with sums in another
order — 1e-5 · max|ref| for the kernels' backward, 1e-4 · max|grad| per
leaf through the whole model. bf16 — both sides compute in f32 and round
once — 2 bf16 ulps of max|ref|, except where a test says why it needs
more.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs.base import get_reduced_config as jget_reduced
from repro.configs.base import replace as jreplace
from repro.kernels.swa_attention.ref import swa_attention_ref as jswa_ref
from repro.layers import norms as jnorms
from repro.models import api as japi
from repro_torch import convert
from repro_torch.configs import get_reduced_config, replace
from repro_torch.kernels.rmsnorm import ref as rms_ref
from repro_torch.kernels.swa_attention import ref as swa_ref
from repro_torch.models import api
from repro_torch.tree import tree_leaves, tree_map

# the reference's threaded tests share the CPU with these workers
torch.set_num_threads(2)

DT = {"f32": (jnp.float32, torch.float32),
      "bf16": (jnp.bfloat16, torch.bfloat16)}


def _normal(seed, *shape):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _bf16_ulp(x: float) -> float:
    return 2.0 ** (np.floor(np.log2(max(abs(x), 1e-30))) - 7)


def _close(got, ref, dtype, ulps=2):
    """f32: within 1e-5 · max|ref|; bf16: within ``ulps`` bf16 ulps of
    max|ref|."""
    got = (got.float().numpy() if isinstance(got, torch.Tensor)
           else np.asarray(got, np.float32))
    ref = np.asarray(ref, np.float32)
    assert got.shape == ref.shape
    top = float(np.abs(ref).max())
    bar = ulps * _bf16_ulp(top) if dtype == "bf16" else 1e-5 * top
    assert float(np.abs(got - ref).max()) <= bar, (
        float(np.abs(got - ref).max()), bar)


# ---------------------------------------------------------------------------
# rmsnorm backward
# ---------------------------------------------------------------------------

RMS_CASES = [("f32", "f32"), ("bf16", "f32"), ("bf16", "bf16")]


@pytest.mark.parametrize("x_dt,s_dt", RMS_CASES)
@pytest.mark.parametrize("shape", [(3, 17, 128), (257, 256), (2, 7, 4096)])
def test_rmsnorm_bwd_ref_matches_jax_vjp(shape, x_dt, s_dt):
    """dx and dscale against ``jax.vjp`` of the reference's ``rms_norm``
    (bf16 cotangents of bf16 leaves, as the reference's are); f32 at
    1e-5 · max|ref|, bf16 at 2 ulps of max|ref|."""
    x = _normal(sum(shape), *shape) * 3
    s = _normal(7, shape[-1])
    dy = _normal(8, *shape)
    jx, js = jnp.asarray(x).astype(DT[x_dt][0]), jnp.asarray(s).astype(
        DT[s_dt][0])
    _, vjp = jax.vjp(lambda a, b: jnorms.rms_norm(a, b, 1e-5), jx, js)
    jdx, jds = vjp(jnp.asarray(dy).astype(DT[x_dt][0]))
    tx = torch.from_numpy(x).to(DT[x_dt][1])
    ts = torch.from_numpy(s).to(DT[s_dt][1])
    dx, ds = rms_ref.rmsnorm_bwd_ref(tx, ts, torch.from_numpy(dy).to(
        DT[x_dt][1]), 1e-5)
    assert dx.dtype == DT[x_dt][1] and ds.dtype == DT[s_dt][1]
    _close(dx, jdx, x_dt)
    _close(ds, jds, s_dt)


@pytest.mark.parametrize("x_dt,s_dt", RMS_CASES)
def test_rmsnorm_bwd_ref_matches_torch_autograd(x_dt, s_dt):
    """The same formulas against torch autograd of the plain forward."""
    x = torch.from_numpy(_normal(1, 5, 9, 256) * 3).to(DT[x_dt][1])
    s = torch.from_numpy(_normal(2, 256)).to(DT[s_dt][1])
    dy = torch.from_numpy(_normal(3, 5, 9, 256)).to(DT[x_dt][1])
    xa, sa = x.clone().requires_grad_(True), s.clone().requires_grad_(True)
    gx, gs = torch.autograd.grad(rms_ref.rmsnorm_ref(xa, sa, 1e-6),
                                 (xa, sa), dy)
    dx, ds = rms_ref.rmsnorm_bwd_ref(x, s, dy, 1e-6)
    _close(dx, gx.float().numpy(), x_dt)
    _close(ds, gs.float().numpy(), s_dt)


# ---------------------------------------------------------------------------
# swa_attention backward
# ---------------------------------------------------------------------------

def _swa_data(B, S, H, KV, hd, seed=0):
    return (_normal(seed, B, S, H, hd), _normal(seed + 1, B, S, KV, hd),
            _normal(seed + 2, B, S, KV, hd), _normal(seed + 3, B, S, H, hd))


def _jax_swa_grads(q, k, v, do, window, jdt):
    """(out, lse, dq, dk, dv) of the reference's jnp oracle, which takes
    (BH, S, d) operands: k and v repeated over each kv head's G query
    heads, and the per-head dk, dv summed over the group in f32."""
    B, S, H, hd = q.shape
    KV = k.shape[2]
    G = H // KV

    def bh(a):                      # (B, S, H, hd) -> (B·H, S, hd)
        return jnp.transpose(a, (0, 2, 1, 3)).reshape(B * H, S, hd)

    def rep(a):                     # (B, S, KV, hd) -> (B·H, S, hd)
        return bh(jnp.repeat(a, G, axis=2))

    jq, jk, jv = (jnp.asarray(a).astype(jdt) for a in (q, k, v))
    out, vjp = jax.vjp(lambda a, b, c: jswa_ref(a, b, c, window=window),
                       bh(jq), rep(jk), rep(jv))
    dq, dk, dv = vjp(bh(jnp.asarray(do).astype(jdt)))

    def back(a, heads):             # (B·heads, S, hd) -> (B, S, heads, hd)
        return np.asarray(a, np.float32).reshape(B, heads, S, hd).transpose(
            0, 2, 1, 3)

    def group_sum(a):
        a = back(a, H).reshape(B, S, KV, G, hd)
        return a.sum(axis=3)

    i = np.arange(S)[:, None]
    j = np.arange(S)[None, :]
    qf = np.asarray(bh(jq), np.float32)
    kf = np.asarray(rep(jk), np.float32)
    sc = np.einsum("bqd,bkd->bqk", qf, kf) * hd ** -0.5
    sc = np.where((j <= i) & (i - j < window), sc, -1e30)
    lse = np.asarray(jax.nn.logsumexp(jnp.asarray(sc), axis=-1)).reshape(
        B, H, S)
    return (back(out, H), lse, back(dq, H), group_sum(dk), group_sum(dv))


SWA_SHAPES = [(2, 24, 4, 2, 16), (1, 40, 4, 1, 32), (2, 17, 2, 2, 8)]


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("window", [0, 8, "S"])
@pytest.mark.parametrize("B,S,H,KV,hd", SWA_SHAPES)
def test_swa_bwd_ref_matches_jax_vjp(B, S, H, KV, hd, window, dtype):
    """dq, dk, dv and the log-sum-exp against ``jax.vjp`` of the
    reference's oracle (window 0 is the model's "no window", which the
    attention layer passes as S). f32 at 1e-5 · max|ref|.

    bf16: the reference differentiates in f32 and rounds each gradient
    once (dk, dv per query head, then summed here in f32); the port
    recomputes from the saved bf16 output, so D = rowsum(dO ∘ O) carries
    O's bf16 rounding (2⁻⁹ relative), and a group's dk, dv sum G
    per-head terms before the one rounding: 4 bf16 ulps of max|ref|."""
    w = S if window in (0, "S") else window
    q, k, v, do = _swa_data(B, S, H, KV, hd)
    jdt, tdt = DT[dtype]
    out_j, lse_j, dq_j, dk_j, dv_j = _jax_swa_grads(q, k, v, do, w, jdt)
    tq, tk, tv, tdo = (torch.from_numpy(a).to(tdt) for a in (q, k, v, do))
    out = swa_ref.swa_attention_ref(tq, tk, tv, window=w)
    _close(out, out_j, dtype)
    lse = swa_ref.swa_attention_lse_ref(tq, tk, window=w)
    np.testing.assert_allclose(lse.numpy(), lse_j, rtol=1e-5, atol=1e-5)
    got = swa_ref.swa_attention_bwd_ref(tq, tk, tv, out, lse, tdo, window=w)
    for g, r in zip(got, (dq_j, dk_j, dv_j)):
        assert g.dtype == tdt
        _close(g, r, dtype, ulps=4 if dtype == "bf16" else 2)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("window", [2, 8, 40])
def test_swa_bwd_ref_matches_torch_autograd(window, dtype):
    """The backward recomputed from the log-sum-exp against torch autograd
    of the plain forward, on the same inputs and the forward's own output:
    f32 at 1e-5 · max|ref|; bf16 at 4 ulps (autograd's softmax backward
    takes D from the f32 probabilities, the recomputation from the bf16
    output). Not at window 1: there autograd's dq and dk are exactly 0
    (a softmax of one score has no gradient), while the recomputation's
    dS = P·(dP − D) keeps the f32 rounding of two equal sums (~1.5e-6);
    the card test holds window 1 against the f64 function."""
    q, k, v, do = _swa_data(2, 40, 8, 2, 32, seed=5)
    tdt = DT[dtype][1]
    tq, tk, tv, tdo = (torch.from_numpy(a).to(tdt) for a in (q, k, v, do))
    leaves = [a.clone().requires_grad_(True) for a in (tq, tk, tv)]
    out = swa_ref.swa_attention_ref(*leaves, window=window)
    ref = torch.autograd.grad(out, leaves, tdo)
    lse = swa_ref.swa_attention_lse_ref(tq, tk, window=window)
    got = swa_ref.swa_attention_bwd_ref(tq, tk, tv, out.detach(), lse, tdo,
                                        window=window)
    for g, r in zip(got, ref):
        _close(g, r.float().numpy(), dtype, ulps=4 if dtype == "bf16" else 2)


# ---------------------------------------------------------------------------
# the model's loss and gradient
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("window", [0, 8])
def test_loss_and_every_leaf_gradient_match_reference(window):
    """Reduced qwen3_8b in f32 from the reference's init: ``api.loss_fn``
    (loss, ce, aux) within rtol 1e-5 and the gradient of every leaf within
    1e-4 · max|grad of that leaf| of ``jax.value_and_grad`` of the
    reference's ``loss_fn`` (sums in another order through two layers)."""
    jcfg = jreplace(jget_reduced("qwen3_8b"), sliding_window=window)
    cfg = replace(get_reduced_config("qwen3_8b"), sliding_window=window)
    jp = japi.init_params(jcfg, jax.random.PRNGKey(4), jnp.float32)
    rng = np.random.default_rng(6)
    toks = rng.integers(0, cfg.vocab_size, (2, 24)).astype(np.int32)
    tgt = rng.integers(0, cfg.vocab_size, (2, 24)).astype(np.int32)
    (jloss, jm), jg = jax.value_and_grad(
        lambda p: japi.loss_fn(jcfg, p, {"tokens": jnp.asarray(toks),
                                         "targets": jnp.asarray(tgt)}),
        has_aux=True)(jp)
    tp = convert.lm_tree_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    leaves = [a.requires_grad_(True) for a in tree_leaves(tp)]
    loss, m = api.loss_fn(cfg, tp, {"tokens": torch.from_numpy(toks),
                                    "targets": torch.from_numpy(tgt)})
    grads = torch.autograd.grad(loss, leaves)
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=1e-5)
    np.testing.assert_allclose(float(m["ce"]), float(jm["ce"]), rtol=1e-5)
    assert float(m["aux"]) == float(jm["aux"]) == 0.0
    # the reference's gradient leaf by leaf, in the port tree's order
    ref = []
    tree_map(lambda a, r: ref.append(r), tp, convert.lm_tree_from_numpy(
        jax.tree.map(np.asarray, jg), "cpu"))
    assert len(ref) == len(grads)
    for g, r in zip(grads, ref):
        assert g.shape == r.shape
        top = float(r.abs().max())
        assert float((g - r).abs().max()) <= 1e-4 * top, (tuple(g.shape),
                                                          top)
