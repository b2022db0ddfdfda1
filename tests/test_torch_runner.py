"""The port's epochs=0 Map → Reduce → scoring against the reference's.

Both packages get the same partitions, the same init tree (the reference's,
through ``repro_torch.convert``) and the same ``MapConfig.seed``; the
reference runs its stacked backend at ``use_pallas=False``, the port both of
its backends on the CPU.

Tolerances (f32): β max|Δ| ≤ 1e-4 · max|β| (the ridge system amplifies
summation-order differences); scores ≤ 5e-5 · max|score|; predictions
equal on ≥ 99.9% of rows; accuracy and kappa within 2/n. The port's
sequential and stacked backends agree bit-for-bit on the CPU.
"""
import numpy as np
import pytest
import torch

import jax

from repro.configs.base import get_config as jget, get_reduced_config as jget_r
from repro.core import elm as jelm, reduce_strategies as jrs
from repro.core.runner import (AveragingRun as JRun, Ensemble as JEnsemble,
                               MapConfig as JMap, ReduceConfig as JReduce)
from repro.data.partition import partition_iid, partition_unequal
from repro.data.synthetic import make_extended_mnist
from repro.models import cnn as jcnn
from repro_torch import convert
from repro_torch.configs import get_config, get_reduced_config
from repro_torch.core import reduce_strategies as trs
from repro_torch.core.runner import (AveragingRun, Ensemble, MapConfig,
                                     ReduceConfig, confusion_matrix,
                                     evaluate_model, kappa_from_confusion,
                                     kappa_model)
from repro_torch.data.partition import Partition

# the reference's threaded tests share the CPU with these workers
torch.set_num_threads(2)

BATCH = 40
SEED = 1000


@pytest.fixture(scope="module")
def data():
    ds = make_extended_mnist(n_per_class=25, seed=0)
    train, test = ds.split(n_test=100, seed=1)
    return train, test


def _parts(train, kind):
    if kind == "iid":
        return partition_iid(train.x, train.y, 3, seed=0)
    return partition_unequal(train.x, train.y, (400, 250, 170), seed=0)


def _strategies(kind):
    weights = (1.0, 2.5, 0.5)
    if kind == "explicit":
        return jrs.ExplicitWeights(weights), trs.ExplicitWeights(weights)
    return kind, kind


def _init(cfg, seed):
    """The reference's init tree for ``PRNGKey(seed)``, as numpy."""
    return jax.tree.map(np.asarray, jcnn.init_params(
        cfg, jax.random.PRNGKey(seed)))


def _reference(cfg, parts, strategy, seed):
    """The reference's stacked run; it draws its init from ``PRNGKey(seed)``
    exactly as ``_init`` does."""
    return JRun(cfg, JMap(epochs=0, batch_size=BATCH, backend="stacked",
                          use_pallas=False, seed=SEED),
                JReduce(strategy=strategy)).run(parts,
                                                jax.random.PRNGKey(seed))


def _port(cfg, parts, strategy, init, backend):
    return AveragingRun(cfg, MapConfig(batch_size=BATCH, backend=backend,
                                       seed=SEED),
                        ReduceConfig(strategy=strategy)).run(
        [Partition(p.x, p.y) for p in parts],
        init_params=convert.params_from_numpy(init, "cpu"), device="cpu")


def _beta_close(got, ref):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape
    assert np.abs(got - ref).max() <= 1e-4 * np.abs(ref).max()


def _leaves_equal(a, b):
    la = jax.tree.leaves(convert.to_numpy(a))
    lb = jax.tree.leaves(convert.to_numpy(b))
    return len(la) == len(lb) and all(np.array_equal(x, y)
                                      for x, y in zip(la, lb))


@pytest.mark.parametrize("strategy", ["uniform", "shard_weighted",
                                      "explicit"])
@pytest.mark.parametrize("kind", ["iid", "unequal"])
def test_epochs0_run_matches_reference(data, kind, strategy):
    train, test = data
    jcfg, tcfg = jget_r("cnn_elm_6c12c"), get_reduced_config("cnn_elm_6c12c")
    parts = _parts(train, kind)
    init = _init(jcfg, 0)
    js, ts = _strategies(strategy)
    ref = _reference(jcfg, parts, js, 0)
    seq = _port(tcfg, parts, ts, init, "sequential")
    stk = _port(tcfg, parts, ts, init, "stacked")
    for res in (seq, stk):
        assert res.stacked.k == 3 and len(res.members) == 3
        _beta_close(res.stacked.beta.numpy(), ref.stacked.beta)
        _beta_close(res.averaged.beta.numpy(), ref.averaged.beta)
        for a, b in zip(jax.tree.leaves(convert.to_numpy(
                res.averaged.cnn_params)),
                jax.tree.leaves(ref.averaged.cnn_params)):
            np.testing.assert_allclose(a, np.asarray(b), rtol=1e-6,
                                       atol=1e-7)
    # the reference's own epochs=0 contract, held by the port on the CPU
    assert _leaves_equal(seq.stacked, stk.stacked)
    assert _leaves_equal(seq.averaged, stk.averaged)
    # scoring the averaged model
    acc = evaluate_model(tcfg, stk.averaged, test.x, test.y, device="cpu")
    from repro.core.runner import evaluate_model as jevaluate
    assert abs(acc - jevaluate(jcfg, ref.averaged, test.x, test.y,
                               use_pallas=False)) <= 2 / len(test.y)


def test_full_width_6c12c_end_to_end(data):
    """The one full-width case: 6c-2s-12c-2s (L = 192) on a few hundred
    images, stacked Map → Reduce → ensemble scores.

    At this width I/λ + U has cond ≈ 9e4, and an f32 Cholesky solve is only
    that accurate: the reference's own β lies ~2e-4 · max|β| from the f64
    solution of its own stats (its Pallas and XLA routes differ by as much),
    and the test scores inherit that. So β and the scores are held at the
    stated bars (1e-4 · max|β|, 5e-5 · max|score|) or at twice the
    reference's own distance from the f64 solution, whichever is larger.
    The stats, which no solve amplifies, are held at rtol 1e-5."""
    from repro.core.executor import ExecutionPlan, StackedExecutor
    train, test = data
    jcfg, tcfg = jget("cnn_elm_6c12c"), get_config("cnn_elm_6c12c")
    parts = partition_iid(train.x, train.y, 2, seed=0)
    init = _init(jcfg, 1)
    ref = StackedExecutor().execute(
        jcfg, jax.tree.map(jax.numpy.asarray, init), parts,
        ExecutionPlan(epochs=0, batch_size=BATCH, seed=SEED,
                      use_pallas=False))
    got = _port(tcfg, parts, "uniform", init, "stacked")
    tparts = [Partition(p.x, p.y) for p in parts]
    from repro_torch.core.executor import (ExecutionPlan as TPlan,
                                           StackedExecutor as TStacked)
    tstats = TStacked().execute(tcfg, convert.params_from_numpy(init, "cpu"),
                                tparts, TPlan(batch_size=BATCH, seed=SEED)
                                ).stats
    ju, jv = np.asarray(ref.stats.u), np.asarray(ref.stats.v)
    for a, b in ((tstats.u, ju), (tstats.v, jv)):
        np.testing.assert_allclose(a.numpy(), b, rtol=1e-5,
                                   atol=1e-5 * np.abs(b).max())
    jb = np.asarray(ref.stacked.beta)
    exact = np.linalg.solve(ju.astype(np.float64)
                            + np.eye(ju.shape[-1]) / jcfg.elm_lambda,
                            jv.astype(np.float64))
    bar = max(1e-4 * np.abs(jb).max(), 2 * np.abs(jb - exact).max())
    assert np.abs(got.stacked.beta.numpy() - jb).max() <= bar
    js = np.asarray(JEnsemble(jcfg, ref.stacked).member_scores(
        test.x, use_pallas=False))
    h = np.stack([np.asarray(jelm.optimal_tanh(jcnn.features(
        jcfg, jax.tree.map(lambda a: a[i], ref.stacked.cnn_params),
        jax.numpy.asarray(test.x), use_pallas=False)))
        for i in range(2)]).astype(np.float64)
    bar = max(5e-5 * np.abs(js).max(), 2 * np.abs(js - h @ exact).max())
    ts = got.ensemble().member_scores(test.x)
    assert np.abs(ts - js).max() <= bar
    assert (ts.argmax(-1) == js.argmax(-1)).mean() >= 0.999


@pytest.fixture(scope="module")
def ensembles(data):
    train, _ = data
    jcfg, tcfg = jget_r("cnn_elm_3c9c"), get_reduced_config("cnn_elm_3c9c")
    parts = partition_iid(train.x, train.y, 3, seed=2)
    init = _init(jcfg, 5)
    ref = _reference(jcfg, parts, "uniform", 5)
    got = _port(tcfg, parts, "uniform", init, "stacked")
    return jcfg, tcfg, ref, got


@pytest.mark.parametrize("combine", ["mean", "vote"])
def test_ensemble_surface_matches_reference(data, ensembles, combine):
    _, test = data
    jcfg, tcfg, ref, got = ensembles
    je = JEnsemble(jcfg, ref.stacked, combine=combine)
    te = Ensemble(tcfg, got.stacked, combine=combine, device="cpu")
    n = len(test.y)
    js = np.asarray(je.member_scores(test.x, batch_size=64, use_pallas=False))
    ts = te.member_scores(test.x, batch_size=64)
    assert ts.shape == js.shape == (3, n, tcfg.num_classes)
    assert np.abs(ts - js).max() <= 5e-5 * np.abs(js).max()
    jp = je.predict(test.x, use_pallas=False)
    tp = te.predict(test.x)
    assert tp.shape == (n,) and (tp == jp).mean() >= 0.999
    assert (te.member_predictions(test.x) ==
            je.member_predictions(test.x, use_pallas=False)).mean() >= 0.999
    np.testing.assert_allclose(te.evaluate(test.x, test.y),
                               je.evaluate(test.x, test.y, use_pallas=False),
                               atol=2 / n)
    np.testing.assert_allclose(te.kappa(test.x, test.y),
                               je.kappa(test.x, test.y, use_pallas=False),
                               atol=2 / n)
    assert abs(te.accuracy(test.x, test.y) -
               je.accuracy(test.x, test.y, use_pallas=False)) <= 2 / n
    assert abs(te.kappa_combined(test.x, test.y) -
               je.kappa_combined(test.x, test.y,
                                 use_pallas=False)) <= 2 / n


def test_reference_members_score_alike_in_the_port(data, ensembles):
    """The reference's trained members and averaged model, carried over
    with ``convert``, score in the port as in the reference — scoring held
    apart from any Map difference."""
    _, test = data
    jcfg, tcfg, ref, _ = ensembles
    sm = convert.stacked_from_numpy(
        jax.tree.map(np.asarray, ref.stacked.cnn_params),
        np.asarray(ref.stacked.beta), "cpu")
    js = np.asarray(JEnsemble(jcfg, ref.stacked).member_scores(
        test.x, use_pallas=False))
    ts = Ensemble(tcfg, sm, device="cpu").member_scores(test.x)
    assert np.abs(ts - js).max() <= 5e-5 * np.abs(js).max()
    avg = convert.model_from_numpy(
        jax.tree.map(np.asarray, ref.averaged.cnn_params),
        np.asarray(ref.averaged.beta), "cpu")
    from repro.core.runner import evaluate_model as jevaluate
    assert abs(evaluate_model(tcfg, avg, test.x, test.y, device="cpu")
               - jevaluate(jcfg, ref.averaged, test.x, test.y,
                           use_pallas=False)) <= 2 / len(test.y)
    back = convert.to_numpy(avg)
    np.testing.assert_array_equal(back[1], np.asarray(ref.averaged.beta))


def test_ensemble_vote_ties_resolve_to_lowest_class(data, ensembles):
    """Two members: every row they disagree on is a 1-1 tie, which the vote
    resolves to the lower of the two labels."""
    _, test = data
    _, tcfg, _, got = ensembles
    members = got.stacked.unstack()
    pair = Ensemble.from_models(tcfg, members[:2], combine="vote",
                                device="cpu")
    preds = pair.member_predictions(test.x)
    assert (preds[0] != preds[1]).any()
    np.testing.assert_array_equal(pair.predict(test.x), preds.min(axis=0))


def test_ensemble_helpers(data, ensembles):
    _, test = data
    _, tcfg, _, got = ensembles
    ens = got.ensemble()
    assert ens.device == torch.device("cpu") and ens.k == 3
    avg = ens.averaged()
    assert torch.equal(avg.beta, got.averaged.beta)
    acc = evaluate_model(tcfg, avg, test.x, test.y, device="cpu")
    kap = kappa_model(tcfg, avg, test.x, test.y, device="cpu")
    assert 0.0 <= acc <= 1.0 and -1.0 <= kap <= 1.0
    preds = ens.member_predictions(test.x)
    np.testing.assert_array_equal(ens.evaluate(test.x, test.y, preds=preds),
                                  ens.evaluate(test.x, test.y))
    with pytest.raises(ValueError):
        ens.accuracy(test.x, test.y, preds=preds)
    cm = confusion_matrix([0, 1, 1, 2], [0, 1, 2, 2], 3)
    assert cm.tolist() == [[1, 0, 0], [0, 1, 1], [0, 0, 1]]
    assert kappa_from_confusion(np.eye(3, dtype=np.int64)) == pytest.approx(
        1.0)


def test_run_needs_init_or_generator(data):
    train, _ = data
    cfg = get_reduced_config("cnn_elm_6c12c")
    parts = [Partition(train.x[:80], train.y[:80])]
    run = AveragingRun(cfg, MapConfig(batch_size=BATCH))
    with pytest.raises(ValueError, match="generator"):
        run.run(parts, device="cpu")
    a = run.run(parts, generator=torch.Generator().manual_seed(3),
                device="cpu")
    b = run.run(parts, generator=torch.Generator().manual_seed(3),
                device="cpu")
    assert torch.equal(a.averaged.beta, b.averaged.beta)
    assert a.backend == "stacked" and a.wall_time_s > 0
