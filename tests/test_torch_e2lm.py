"""The port's E²LM and OS-ELM against the reference's ``repro.core.e2lm``.

Inputs are made with numpy from a seed and fed to both packages on the CPU
(the reference at ``use_pallas=False``).

Tolerances (f32):
* partition invariance — the reference's own bars: merged U and V against
  the whole at rtol 1e-4 / atol 1e-3, β at rtol 1e-3 / atol 1e-4;
* OS-ELM block updates against the batch solve — the reference's rtol 5e-2
  / atol 5e-3;
* the port against the reference on the same inputs — f32 summation
  order: U and V at rtol 1e-5, atol 1e-5 · max|ref|; β within
  1e-4 · max|β_ref| (the ridge system amplifies summation-order
  differences, ``tests/test_torch_cnn_elm.py``); one OS-ELM update from
  the same state within twice the reference's own distance from the f64
  update, or 1e-5 · max|P| and 1e-4 · max|β|, whichever is larger.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.checkpoint import run_state as jrun_state
from repro.configs.base import get_reduced_config as jget_r
from repro.core import e2lm as je2lm, elm as jelm
from repro.core.runner import (AveragingRun as JRun,
                               CheckpointConfig as JCheckpoint,
                               MapConfig as JMap)
from repro.data.partition import partition_iid, partition_unequal
from repro.data.synthetic import make_extended_mnist
from repro.layers.norms import optimal_tanh as joptimal_tanh
from repro.models import cnn as jcnn
from repro_torch import convert
from repro_torch.configs import get_reduced_config
from repro_torch.core import e2lm, elm
from repro_torch.core.runner import AveragingRun, MapConfig
from repro_torch.data.partition import Partition

# the reference's threaded tests share the CPU with these workers
torch.set_num_threads(2)


def _data(seed, n, L, C):
    rng = np.random.default_rng(seed)
    h = rng.normal(size=(n, L)).astype(np.float32)
    w_true = rng.normal(size=(L, C)).astype(np.float32)
    t = (np.asarray(joptimal_tanh(jnp.asarray(h))) @ w_true
         + 0.01 * rng.normal(size=(n, C))).astype(np.float32)
    return h, t


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def _close(got, ref, rtol=1e-5):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=rtol,
                               atol=rtol * float(np.abs(ref).max()))


def _beta_close(got, ref):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape
    assert np.abs(got - ref).max() <= 1e-4 * np.abs(ref).max()


def _cuts(rng, n, k):
    cuts = sorted(rng.choice(np.arange(1, n), size=k - 1, replace=False))
    return [0, *cuts, n]


@pytest.mark.parametrize("k,n", [(2, 40), (3, 97), (5, 120), (7, 200)])
def test_e2lm_partition_invariance(k, n):
    """Eq. 3/4: U and V sums decompose over any partition of the rows."""
    rng = np.random.default_rng(k * 1000 + n)
    h = _t(rng.normal(size=(n, 16)))
    t = _t(rng.normal(size=(n, 3)))
    whole = elm.batch_stats(h, t)
    bounds = _cuts(rng, n, k)
    shards = [elm.batch_stats(h[a:b], t[a:b])
              for a, b in zip(bounds[:-1], bounds[1:])]
    merged = e2lm.reduce_stats(shards)
    np.testing.assert_allclose(merged.u.numpy(), whole.u.numpy(),
                               rtol=1e-4, atol=1e-3)
    np.testing.assert_allclose(merged.v.numpy(), whole.v.numpy(),
                               rtol=1e-4, atol=1e-3)
    assert int(merged.n) == n
    b1 = elm.solve_beta(whole, 100.0)
    b2 = e2lm.mapreduce_solve(shards, 100.0)
    np.testing.assert_allclose(b1.numpy(), b2.numpy(), rtol=1e-3, atol=1e-4)


def test_oselm_matches_batch_solution():
    """OS-ELM block updates of 50 rows reach the batch ridge solution."""
    h, t = _data(42, 400, 12, 2)
    lam = 50.0
    state = e2lm.oselm_init(12, 2, lam, device="cpu")
    for i in range(0, 400, 50):
        state = e2lm.oselm_update(state, _t(h[i:i + 50]), _t(t[i:i + 50]))
    batch_beta = elm.solve_beta(elm.batch_stats(_t(h), _t(t)), lam)
    np.testing.assert_allclose(state.beta.numpy(), batch_beta.numpy(),
                               rtol=5e-2, atol=5e-3)


def _woodbury_f64(p, beta, h, t, activation):
    if activation:
        h = 1.7159 * np.tanh(h.astype(np.float64) * (2.0 / 3.0))
    h, t = h.astype(np.float64), t.astype(np.float64)
    ph = p @ h.T
    p_new = p - ph @ np.linalg.solve(h @ ph + np.eye(len(h)), ph.T)
    return p_new, beta + p_new @ h.T @ (t - h @ beta)


@pytest.mark.parametrize("activation", [True, False])
def test_oselm_update_matches_reference(activation):
    """Each block's update from the reference's state, in both packages:
    P and β within twice the reference's own distance from the f64 update
    of the same state, or 1e-5 · max|P| and 1e-4 · max|β| where those are
    larger. The Woodbury step subtracts nearly equal matrices, so f32
    lands ~1e-4 · max|P| from f64 on the first block (P = λI, λ = 20) in
    either package, and order alone cannot hold it closer."""
    h, t = _data(7, 240, 16, 3)
    ref = je2lm.oselm_init(16, 3, 20.0)
    mine = e2lm.oselm_init(16, 3, 20.0, device="cpu")
    _close(mine.p, ref.p)
    for i in range(0, 240, 60):
        hb, tb = h[i:i + 60], t[i:i + 60]
        p0, b0 = np.asarray(ref.p), np.asarray(ref.beta)
        mine = e2lm.oselm_update(e2lm.OSELMState(_t(p0), _t(b0)), _t(hb),
                                 _t(tb), activation=activation)
        ref = je2lm.oselm_update(ref, jnp.asarray(hb), jnp.asarray(tb),
                                 activation=activation)
        exact = _woodbury_f64(p0.astype(np.float64), b0.astype(np.float64),
                              hb, tb, activation)
        for got, want, x, floor in ((mine.p, ref.p, exact[0], 1e-5),
                                    (mine.beta, ref.beta, exact[1], 1e-4)):
            want = np.asarray(want)
            bar = max(floor * np.abs(want).max(),
                      2 * np.abs(want - x).max())
            assert np.abs(got.numpy() - want).max() <= bar


def test_oselm_refuses_an_indefinite_gram():
    """A P that makes I + H P Hᵀ indefinite fails its checked Cholesky."""
    h, t = _data(3, 8, 4, 2)
    state = e2lm.OSELMState(-10.0 * torch.eye(4), torch.zeros((4, 2)))
    with pytest.raises(torch.linalg.LinAlgError):
        e2lm.oselm_update(state, _t(h), _t(t))


@pytest.mark.parametrize("k,n", [(3, 150), (6, 333)])
def test_reduce_and_mapreduce_solve_match_reference(k, n):
    h, t = _data(k + n, n, 24, 5)
    bounds = _cuts(np.random.default_rng(n), n, k)
    mine = [elm.batch_stats(_t(h[a:b]), _t(t[a:b]))
            for a, b in zip(bounds[:-1], bounds[1:])]
    ref = [jelm.batch_stats(jnp.asarray(h[a:b]), jnp.asarray(t[a:b]),
                            use_pallas=False)
           for a, b in zip(bounds[:-1], bounds[1:])]
    got, want = e2lm.reduce_stats(mine), je2lm.reduce_stats(ref)
    _close(got.u, want.u)
    _close(got.v, want.v)
    assert float(got.n) == float(want.n) == n
    _beta_close(e2lm.mapreduce_solve(mine, 10.0),
                je2lm.mapreduce_solve(ref, 10.0))


def _rows(stats, k):
    return [type(stats)(*(a[i] for a in stats)) for i in range(k)]


@pytest.mark.parametrize("split", ["iid", "unequal"])
@pytest.mark.parametrize("backend", ["sequential", "stacked"])
def test_mapreduce_solve_of_run_stats_matches_reference(tmp_path, backend,
                                                        split):
    """The global β of a finished epochs=0 Map: the port's from
    ``RunResult.stats``, the reference's from the stats its final round
    checkpoint saves, each through ``mapreduce_solve`` of the members'
    rows."""
    jcfg, tcfg = jget_r("cnn_elm_6c12c"), get_reduced_config("cnn_elm_6c12c")
    ds = make_extended_mnist(n_per_class=20, seed=0)
    parts = (partition_iid(ds.x, ds.y, 3, seed=0) if split == "iid" else
             partition_unequal(ds.x, ds.y, (90, 60, 41), seed=1))
    init = jax.tree.map(np.asarray,
                        jcnn.init_params(jcfg, jax.random.PRNGKey(0)))
    JRun(jcfg, JMap(batch_size=20, backend=backend, use_pallas=False)).run(
        parts, jax.random.PRNGKey(0),
        checkpoint=JCheckpoint(dir=str(tmp_path)))
    saved = jrun_state.restore_round(str(tmp_path)).stats
    want = je2lm.mapreduce_solve(
        _rows(jelm.ELMStats(*map(jnp.asarray, saved)), len(parts)),
        jcfg.elm_lambda)
    res = AveragingRun(tcfg, MapConfig(batch_size=20, backend=backend)).run(
        [Partition(p.x, p.y) for p in parts],
        init_params=convert.params_from_numpy(init, "cpu"), device="cpu")
    got = e2lm.mapreduce_solve(_rows(res.stats, len(parts)), tcfg.elm_lambda)
    _close(res.stats.u, saved.u)
    _beta_close(got, want)
