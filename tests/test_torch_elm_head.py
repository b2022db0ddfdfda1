"""The port's backbone-agnostic ELM head and the dense decoder's
``hidden_states`` against the reference's ``repro.core.elm_head`` and
``repro.models.transformer.hidden_states``.

Backbones: reduced ``qwen3_8b`` (2 layers, d 256) and reduced
``cnn_elm_6c12c``, the reference's init carried over by
``repro_torch.convert``; tokens, images and targets from numpy seeds; the
reference's CNN at ``use_pallas=False`` (R2: it cannot differentiate its
Pallas conv).

Tolerances:
* f32 hidden states against the reference's scanned form within
  1e-4 · max|h|; bf16 against its unrolled form (R5) at
  ``tests/test_torch_lm.py``'s bf16 bar, 2e-2 · max|h|;
* U, V and scores within 1e-4 · max|ref| (f32 features in another
  summation order), 2e-2 · max|ref| over bf16 states;
* β within the solve bar: 1e-3 · max|β| or twice the reference's own f32
  distance from the f64 solve of its stats, whichever is larger (the LM
  head's I/λ + U has rank-64 U at L = 256);
* ``finetune_step``: 4 steps at λ = 1, losses and every leaf at rtol 1e-4
  (atol 1e-4 · max|leaf|).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs.base import get_reduced_config as jget_r
from repro.configs.base import replace as jreplace
from repro.core import elm_head as jhead
from repro.data.synthetic import make_extended_mnist
from repro.models import api as japi, cnn as jcnn
from repro_torch import convert
from repro_torch.configs import get_reduced_config, replace
from repro_torch.core import elm_head
from repro_torch.models import api, cnn

# the reference's threaded tests share the CPU with these workers
torch.set_num_threads(2)

KEY = jax.random.PRNGKey(0)
C = 16


def _np(a):
    return (a.float().numpy() if isinstance(a, torch.Tensor)
            else np.asarray(a, np.float32))


def _close(got, ref, rel):
    got, ref = _np(got), _np(ref)
    assert got.shape == ref.shape
    assert np.abs(got - ref).max() <= rel * np.abs(ref).max()


def _solve_close(got, ref, ref_stats, lam):
    """β within 1e-3 · max|β| or twice the reference's f32 distance from the
    f64 solve of its own stats."""
    u, v = (np.asarray(a, np.float64) for a in (ref_stats.u, ref_stats.v))
    exact = np.linalg.solve(u + np.eye(len(u)) / lam, v)
    got, ref = _np(got), _np(ref)
    bar = max(1e-3 * np.abs(ref).max(), 2 * np.abs(ref - exact).max())
    assert np.abs(got - ref).max() <= bar


def _lm(dtype):
    jcfg, tcfg = jget_r("qwen3_8b"), get_reduced_config("qwen3_8b")
    jp = japi.init_params(jcfg, KEY, jnp.float32 if dtype == "f32"
                          else jnp.bfloat16)
    if dtype == "bf16":
        jcfg = jreplace(jcfg, unroll_layers=True)
    tp = convert.lm_tree_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    return (jp, tp, lambda p, b: japi.hidden_states(jcfg, p, b),
            lambda p, b: api.hidden_states(tcfg, p, b), jcfg.vocab_size)


def _lm_batch(seed, vocab, shape=(2, 32)):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, vocab, shape).astype(np.int32)
    tgt = rng.integers(0, C, shape).astype(np.int32)
    return ({"tokens": jnp.asarray(toks), "targets": jnp.asarray(tgt)},
            {"tokens": torch.from_numpy(toks), "targets": torch.from_numpy(
                tgt)})


def _cnn():
    jcfg = jreplace(jget_r("cnn_elm_6c12c"), elm_lambda=1.0)
    tcfg = replace(get_reduced_config("cnn_elm_6c12c"), elm_lambda=1.0)
    jp = jcnn.init_params(jcfg, KEY)
    tp = convert.params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    return (jp, tp,
            lambda p, b: jcnn.features(jcfg, p, b["x"], use_pallas=False),
            lambda p, b: cnn.features(tcfg, p, b["x"]))


def _cnn_batch(lo, hi):
    ds = make_extended_mnist(n_per_class=8, seed=0)
    return ({"x": jnp.asarray(ds.x[lo:hi]),
             "targets": jnp.asarray(ds.y[lo:hi])},
            {"x": torch.from_numpy(ds.x[lo:hi]),
             "targets": torch.from_numpy(ds.y[lo:hi])})


@pytest.mark.parametrize("dtype,rel", [("f32", 1e-4), ("bf16", 2e-2)])
def test_hidden_states_match_reference(dtype, rel):
    jp, tp, jf, tf, vocab = _lm(dtype)
    jb, tb = _lm_batch(0, vocab)
    got, ref = tf(tp, tb), jf(jp, jb)
    assert got.shape == (2, 32, 256) and got.dtype == tp["embed"].dtype
    _close(got, ref, rel)


@pytest.mark.parametrize("dtype,rel", [("f32", 1e-4), ("bf16", 2e-2)])
def test_lm_head_stats_solve_predict_match_reference(dtype, rel):
    """Two batches accumulated, β solved at λ 10, a third batch scored. The
    bf16 states are rounded through the activation in bf16, then summed in
    f32, in both packages."""
    jp, tp, jf, tf, vocab = _lm(dtype)
    (jb0, tb0), (jb1, tb1), (jb2, tb2) = (_lm_batch(s, vocab)
                                          for s in range(3))
    js = jhead.accumulate_stats(jf, jp, jb1, C,
                                jhead.accumulate_stats(jf, jp, jb0, C))
    ts = elm_head.accumulate_stats(tf, tp, tb1, C,
                                   elm_head.accumulate_stats(tf, tp, tb0, C))
    _close(ts.u, js.u, rel)
    _close(ts.v, js.v, rel)
    assert float(ts.n) == float(js.n) == 128
    jbeta, tbeta = jhead.solve(js, 10.0), elm_head.solve(ts, 10.0)
    if dtype == "f32":
        _solve_close(tbeta, jbeta, js, 10.0)
    got = elm_head.predict(tf, tp, torch.from_numpy(np.array(jbeta)), tb2)
    assert got.shape == (64, C) and got.dtype == torch.float32
    _close(got, jhead.predict(jf, jp, jbeta, jb2), rel)


def test_cnn_head_stats_solve_predict_match_reference():
    jp, tp, jf, tf = _cnn()
    jb, tb = _cnn_batch(0, 60)
    jt, tt = _cnn_batch(60, 80)
    js = jhead.accumulate_stats(jf, jp, jb, 10)
    ts = elm_head.accumulate_stats(tf, tp, tb, 10)
    _close(ts.u, js.u, 1e-4)
    _close(ts.v, js.v, 1e-4)
    jbeta, tbeta = jhead.solve(js, 1.0), elm_head.solve(ts, 1.0)
    _solve_close(tbeta, jbeta, js, 1.0)
    _close(elm_head.predict(tf, tp, tbeta, tt),
           jhead.predict(jf, jp, jbeta, jt), 1e-4)


@pytest.mark.parametrize("backbone", ["lm", "cnn"])
def test_finetune_step_matches_reference(backbone):
    """Four SGD steps of the backbone on the ELM loss, from the same β
    (solved by the reference on another batch at λ 1), in both packages."""
    if backbone == "lm":
        jp, tp, jf, tf, vocab = _lm("f32")
        (jsb, _), (jb, tb) = _lm_batch(5, vocab), _lm_batch(6, vocab)
        classes, lr = C, 1e-2
    else:
        jp, tp, jf, tf = _cnn()
        (jsb, _), (jb, tb) = _cnn_batch(0, 40), _cnn_batch(40, 80)
        classes, lr = 10, 0.05
    jbeta = jhead.solve(jhead.accumulate_stats(jf, jp, jsb, classes), 1.0)
    tbeta = torch.from_numpy(np.array(jbeta))
    jq, tq = jp, tp
    for _ in range(4):
        jq, jl = jhead.finetune_step(jf, jq, jbeta, jb, classes, lr=lr)
        tq, tl = elm_head.finetune_step(tf, tq, tbeta, tb, classes, lr=lr)
        np.testing.assert_allclose(float(tl), float(jl), rtol=1e-4)
    ref, got = jax.tree.leaves(jq), jax.tree.leaves(convert.to_numpy(tq))
    assert len(ref) == len(got)
    moved = 0.0
    for a, b, a0 in zip(ref, got, jax.tree.leaves(jp)):
        a = np.asarray(a)
        np.testing.assert_allclose(b, a, rtol=1e-4,
                                   atol=1e-4 * np.abs(a).max())
        moved = max(moved, float(np.abs(a - np.asarray(a0)).max()))
    assert moved > 0


def test_finetune_step_reduces_elm_loss():
    """Algorithm 2 lines 13-14 through a bf16 transformer backbone: β on
    held-out stats, four steps, the loss falls."""
    cfg = get_reduced_config("qwen3_8b")
    params = api.init_params(cfg, torch.Generator().manual_seed(0),
                             device="cpu")
    gen = torch.Generator().manual_seed(1)

    def batch():
        return {"tokens": torch.randint(0, cfg.vocab_size, (2, 32),
                                        generator=gen),
                "targets": torch.randint(0, C, (2, 32), generator=gen)}

    def feature_fn(p, b):
        return api.hidden_states(cfg, p, b)

    stats_batch, b = batch(), batch()
    beta = elm_head.solve(elm_head.accumulate_stats(feature_fn, params,
                                                    stats_batch, C), 10.0)
    losses, p = [], params
    for _ in range(4):
        p, loss = elm_head.finetune_step(feature_fn, p, beta, b, C, lr=1e-2)
        losses.append(float(loss))
    assert p["embed"].dtype == torch.bfloat16
    assert losses[-1] < losses[0], losses
