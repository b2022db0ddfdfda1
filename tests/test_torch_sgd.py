"""The port's SGD epochs (Algorithm 2 lines 12-14) against the reference's.

Both packages get the same partitions, the same init tree (the reference's,
through ``repro_torch.convert``) and the same ``MapConfig.seed``; the
reference runs at ``use_pallas=False`` (its SGD path differentiates the
``lax.conv`` route; its Pallas conv has no backward), the port on the CPU.

Tolerances: after SGD epochs rtol 1e-4 (atol 2e-5) on every leaf — the
reference's own bar between its two backends, on reduced configs with
``elm_lambda = 1.0`` as its SGD tests use. The port's two backends agree
bit-for-bit on the CPU (one member step for both, per-member matrix
products), chunked epochs equal the whole epoch bit-for-bit, and the
learning rates equal the reference's f32 values bit-for-bit.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs.base import (get_config as jget,
                                get_reduced_config as jget_r,
                                replace as jreplace)
from repro.core import averaging as javg, cnn_elm as jcnn_elm
from repro.core import executor as jexec, reduce_strategies as jrs
from repro.core.runner import (AveragingRun as JRun, MapConfig as JMap,
                               ReduceConfig as JReduce)
from repro.data.partition import (Partition as JPartition, partition_iid,
                                  partition_unequal)
from repro.data.synthetic import make_extended_mnist
from repro.models import cnn as jcnn
from repro.optim import schedules as jsched
from repro_torch import convert
from repro_torch.configs import get_config, get_reduced_config, replace
from repro_torch.core import averaging as tavg, cnn_elm, elm, executor
from repro_torch.core import reduce_strategies as trs
from repro_torch.core.runner import AveragingRun, MapConfig, ReduceConfig
from repro_torch.data.partition import Partition, chunk_scan_major
from repro_torch.optim import schedules
from repro_torch.tree import tree_leaves

# the reference's threaded tests share the CPU with these workers
torch.set_num_threads(2)

BATCH = 32
JCFG = jreplace(jget_r("cnn_elm_6c12c"), elm_lambda=1.0)
TCFG = replace(get_reduced_config("cnn_elm_6c12c"), elm_lambda=1.0)
KEY = jax.random.PRNGKey(0)
INIT = jax.tree.map(np.asarray, jcnn.init_params(JCFG, KEY))


@pytest.fixture(scope="module")
def shards():
    ds = make_extended_mnist(n_per_class=20, seed=0)
    return {"iid": partition_iid(ds.x, ds.y, k=3, seed=0),
            "unequal": partition_unequal(ds.x, ds.y, [96, 64, 33], seed=1)}


@pytest.fixture(scope="module")
def validation():
    return make_extended_mnist(n_per_class=8, seed=3)


def _port_parts(parts):
    return [Partition(p.x, p.y) for p in parts]


def _port(parts, map_cfg, reduce_cfg=None, cfg=TCFG, init=INIT, **kw):
    return AveragingRun(cfg, map_cfg, reduce_cfg or ReduceConfig()).run(
        _port_parts(parts), init_params=convert.params_from_numpy(init,
                                                                  "cpu"),
        device="cpu", **kw)


def _reference(parts, map_kw, reduce_cfg=None, **kw):
    return JRun(JCFG, JMap(backend="stacked", use_pallas=False, **map_kw),
                reduce_cfg or JReduce()).run(parts, KEY, **kw)


def _leaves(model):
    return jax.tree.leaves(convert.to_numpy(model))


def _ref_leaves(model):
    return [np.asarray(a) for a in jax.tree.leaves((model.cnn_params,
                                                    model.beta))]


def _close(got, ref, rtol=1e-4):
    assert len(got) == len(ref)
    for a, b in zip(got, ref):
        assert a.shape == b.shape
        np.testing.assert_allclose(a, b, rtol=rtol, atol=2e-5)


def _equal(a, b):
    la, lb = _leaves(a), _leaves(b)
    return len(la) == len(lb) and all(np.array_equal(x, y)
                                      for x, y in zip(la, lb))


# ---------------------------------------------------------------------------
# Learning-rate schedules
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("c", [0.05, 0.1, 0.01, 1 / 3])
def test_schedules_equal_reference_f32_bitwise(c):
    for e in range(128):
        for mine, ref in ((schedules.dynamic_paper(c), jsched.dynamic_paper(c)),
                          (schedules.constant(c), jsched.constant(c))):
            got, want = mine(e), np.asarray(ref(e))
            assert got.dtype == np.float32
            assert got.tobytes() == want.tobytes()


# ---------------------------------------------------------------------------
# One member, one step
# ---------------------------------------------------------------------------

def test_train_member_epochs2_matches_reference(shards):
    """``train_member(epochs=2)``: both epochs' permutations, per-batch β
    from the running sums, the f32 rates of ``dynamic_paper``."""
    part = shards["unequal"][0]
    for seed in (1000, 7):
        ref = jcnn_elm.train_member(
            JCFG, jax.tree.map(jnp.asarray, INIT), part, epochs=2,
            lr_schedule=jsched.dynamic_paper(0.05), batch_size=BATCH,
            seed=seed, use_pallas=False)
        got, stats = cnn_elm.train_member(
            TCFG, convert.params_from_numpy(INIT, "cpu"),
            Partition(part.x, part.y), epochs=2,
            lr_schedule=schedules.dynamic_paper(0.05), batch_size=BATCH,
            seed=seed, return_stats=True)
        _close(_leaves(got), _ref_leaves(ref))
        assert float(stats.n) == len(part.x) // BATCH * BATCH


def test_full_width_single_sgd_step_matches_reference():
    """6c-2s-12c-2s at full width (L = 192, λ = 100): one batch of 40
    images is one SGD step, then the β solve (rtol 1e-4)."""
    ds = make_extended_mnist(n_per_class=4, seed=0)
    part = JPartition(ds.x[:40], ds.y[:40])
    jcfg, tcfg = jget("cnn_elm_6c12c"), get_config("cnn_elm_6c12c")
    init = jax.tree.map(np.asarray, jcnn.init_params(jcfg, KEY))
    ref = jcnn_elm.train_member(
        jcfg, jax.tree.map(jnp.asarray, init), part, epochs=1,
        lr_schedule=jsched.constant(0.05), batch_size=40, seed=3,
        use_pallas=False)
    got = cnn_elm.train_member(
        tcfg, convert.params_from_numpy(init, "cpu"),
        Partition(part.x, part.y), epochs=1,
        lr_schedule=schedules.constant(0.05), batch_size=40, seed=3)
    _close(_leaves(got.cnn_params), [np.asarray(a) for a in
                                     jax.tree.leaves(ref.cnn_params)])
    moved = [np.abs(a - b).max() for a, b in zip(
        _leaves(got.cnn_params), jax.tree.leaves(init))]
    assert max(moved) > 0            # the step did move the weights


def test_member_step_masked_batch_keeps_params():
    """A zero-mask batch adds nothing to the stats and leaves its member's
    params bit-for-bit; the other members step."""
    rng = np.random.default_rng(0)
    params = convert.params_from_numpy(INIT, "cpu")
    params_k = {"stages": tuple({n: torch.stack([a, a]) for n, a in
                                 st.items()} for st in params["stages"])}
    x = torch.from_numpy(rng.random((2, 8, 28, 28), dtype=np.float32))
    t = torch.nn.functional.one_hot(torch.arange(16).reshape(2, 8) % 10,
                                    10).float()
    stats = elm.zero_stats_stacked(2, 64, 10, device="cpu")
    infos = []
    new, stats = cnn_elm.member_step(TCFG, params_k, stats, x, t,
                                     torch.tensor([1.0, 0.0]), lr=0.05,
                                     infos=infos)
    elm.check_factorisations(infos)
    for a, b in zip(tree_leaves(new), tree_leaves(params_k)):
        assert torch.equal(a[1], b[1]) and not torch.equal(a[0], b[0])
    assert stats.n.tolist() == [8.0, 0.0]
    assert float(stats.u[1].abs().max()) == 0.0


def test_deferred_factorisation_check_raises():
    u = -torch.eye(4)[None]
    stats = elm.ELMStats(u, torch.zeros((1, 4, 2)), torch.ones(1))
    with pytest.raises(torch.linalg.LinAlgError):
        elm.solve_beta(stats, 1.0)
    infos = []
    elm.solve_beta(stats, 1.0, infos)        # no wait for the device here
    assert len(infos) == 1
    with pytest.raises(torch.linalg.LinAlgError):
        elm.check_factorisations(infos)
    elm.check_factorisations([])


# ---------------------------------------------------------------------------
# The Map: both backends, rounds, chunks
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["iid", "unequal"])
def test_epochs2_run_matches_reference_on_both_backends(shards, kind):
    parts = shards[kind]
    mk = dict(epochs=2, batch_size=BATCH)
    ref = _reference(parts, dict(lr_schedule=jsched.dynamic_paper(0.05), **mk))
    runs = {be: _port(parts, MapConfig(
        lr_schedule=schedules.dynamic_paper(0.05), backend=be, **mk))
        for be in ("sequential", "stacked")}
    for res in runs.values():
        _close(_leaves(res.stacked), _ref_leaves(ref.stacked))
        _close(_leaves(res.averaged), _ref_leaves(ref.averaged))
        assert [r.round for r in res.rounds] == [0]
        assert res.stats.n.tolist() == [len(p.x) // BATCH * BATCH
                                        for p in parts]
    assert _equal(runs["sequential"].stacked, runs["stacked"].stacked)
    assert _equal(runs["sequential"].averaged, runs["stacked"].averaged)


@pytest.mark.parametrize("strategy", ["uniform", "shard_weighted"])
def test_rounds2_matches_reference(shards, strategy):
    parts = shards["unequal"]
    mk = dict(epochs=2, batch_size=BATCH)
    ref = _reference(parts, dict(lr_schedule=jsched.dynamic_paper(0.05), **mk),
                     JReduce(strategy=strategy, rounds=2))
    got = _port(parts, MapConfig(lr_schedule=schedules.dynamic_paper(0.05),
                                 **mk),
                ReduceConfig(strategy=strategy, rounds=2))
    _close(_leaves(got.stacked), _ref_leaves(ref.stacked))
    _close(_leaves(got.averaged), _ref_leaves(ref.averaged))
    assert got.round_syncs == 1
    assert [(r.epoch_start, r.epoch_end) for r in got.rounds] == \
        [(0, 1), (1, 2)]


@pytest.mark.parametrize("strategy", ["uniform", "shard_weighted"])
def test_multi_round_sync_semantics(shards, strategy):
    """rounds=2 with rates [0.05, 0]: round 1's SGD is a no-op, so every
    member's final CNN equals round 0's average, which the hook saw — the
    sync is exactly broadcast(average(.)), weighted like the Reduce."""
    caught = {}
    res = _port(shards["unequal"], MapConfig(
        epochs=2, lr_schedule=lambda e: [0.05, 0.0][e], batch_size=BATCH),
        ReduceConfig(strategy=strategy, rounds=2),
        round_hook=lambda r, m: caught.setdefault(r, m))
    assert [r.hook is caught[r.round] for r in res.rounds] == [True, True]
    for m in res.members:
        for a, b in zip(tree_leaves(m.cnn_params),
                        tree_leaves(caught[0].cnn_params)):
            assert torch.equal(a, b)


@pytest.mark.parametrize("chunk_batches", [1, 2, 3])
@pytest.mark.parametrize("kind", ["iid", "unequal"])
def test_chunk_batches_bit_identical(shards, kind, chunk_batches):
    mk = dict(epochs=2, lr_schedule=schedules.dynamic_paper(0.05),
              batch_size=16)
    mono = _port(shards[kind], MapConfig(**mk))
    chunked = _port(shards[kind], MapConfig(chunk_batches=chunk_batches,
                                            **mk))
    assert _equal(mono.stacked, chunked.stacked)
    assert _equal(mono.averaged, chunked.averaged)
    for a, b in zip(mono.stats, chunked.stats):
        assert torch.equal(a, b)


def test_chunk_scan_major_matches_reference():
    from repro.data.partition import chunk_scan_major as jchunk
    arrays = (np.arange(24).reshape(6, 4), np.arange(6))
    for got, want in zip(chunk_scan_major(arrays, 2), jchunk(arrays, 2)):
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError):
        chunk_scan_major(arrays, 4)


def test_round_records_count_launches_and_hooks(shards):
    """One record per round with its epoch span, wall time and launch
    counts (the CPU route launches no kernel), the hook's return value."""
    res = _port(shards["iid"], MapConfig(
        epochs=2, lr_schedule=schedules.dynamic_paper(0.05),
        batch_size=BATCH), ReduceConfig(rounds=2),
        round_hook=lambda r, m: f"round-{r}")
    assert [r.hook for r in res.rounds] == ["round-0", "round-1"]
    assert all(r.wall_time_s > 0 for r in res.rounds)
    assert all(set(r.launches) >= {"conv2d", "conv2d_wgrad", "elm_stats"}
               and sum(r.launches.values()) == 0 for r in res.rounds)


def test_sgd_epochs_do_not_collapse(shards, validation):
    """Two SGD epochs at dynamic_paper(0.05) keep the averaged model's
    held-out accuracy within 0.05 of the epochs=0 model's."""
    from repro_torch.core.runner import evaluate_model
    parts = shards["iid"]
    acc = {}
    for e in (0, 2):
        res = _port(parts, MapConfig(
            epochs=e, lr_schedule=schedules.dynamic_paper(0.05),
            batch_size=BATCH))
        acc[e] = evaluate_model(TCFG, res.averaged, validation.x,
                                validation.y, device="cpu")
    assert acc[2] > acc[0] - 0.05


# ---------------------------------------------------------------------------
# Boosted and gossip Reduce
# ---------------------------------------------------------------------------

def test_boosted_weights_equal_reference_for_same_members(shards, validation):
    """The reference's trained members, scored on the held-out slice by the
    port's member-batched pass: the same error rates (argmax of scores
    that agree within f32), so the same AdaBoost weights."""
    parts = shards["unequal"]
    ref = _reference(parts, dict(epochs=2, batch_size=BATCH,
                                 lr_schedule=jsched.dynamic_paper(0.05)))
    xv, yv = validation.x, validation.y
    preds = np.concatenate([np.asarray(jexec._member_predictions(
        JCFG, ref.stacked.cnn_params, ref.stacked.beta,
        jnp.asarray(xv[i:i + 512]), use_pallas=False))
        for i in range(0, len(xv), 512)], axis=1)
    want_err = jexec._val_error_rates(preds, yv)
    members = convert.stacked_from_numpy(
        jax.tree.map(np.asarray, ref.stacked.cnn_params),
        np.asarray(ref.stacked.beta), "cpu")
    err = executor.val_error_rates(TCFG, members, (xv, yv))
    np.testing.assert_array_equal(err, want_err)
    assert trs.boosted_weights(err) == jrs.boosted_weights(want_err)


@pytest.mark.parametrize("rounds", [1, 2])
def test_boosted_run_matches_reference(shards, validation, rounds):
    parts = shards["unequal"]
    mk = dict(epochs=2, batch_size=BATCH)
    ref = _reference(parts, dict(lr_schedule=jsched.dynamic_paper(0.05), **mk),
                     JReduce(strategy="boosted", rounds=rounds,
                             validation=JPartition(validation.x,
                                                   validation.y)))
    got = _port(parts, MapConfig(lr_schedule=schedules.dynamic_paper(0.05),
                                 **mk),
                ReduceConfig(strategy="boosted", rounds=rounds,
                             validation=Partition(validation.x,
                                                  validation.y)))
    _close(_leaves(got.stacked), _ref_leaves(ref.stacked))
    _close(_leaves(got.averaged), _ref_leaves(ref.averaged))


@pytest.mark.parametrize("weights", [None, [1.0, 2.5, 0.5, 3.0, 1.5]])
@pytest.mark.parametrize("rounds", [1, 3])
def test_gossip_member_dim_matches_reference(weights, rounds):
    rng = np.random.default_rng(rounds)
    tree = {"a": rng.normal(size=(5, 3, 4)).astype(np.float32),
            "b": (rng.normal(size=(5, 7)).astype(np.float32),)}
    ji, jp = javg.gossip_member_dim(
        jax.tree.map(jnp.asarray, tree),
        None if weights is None else jnp.asarray(weights, jnp.float32),
        rounds)
    ti, tp = tavg.gossip_member_dim(
        jax.tree.map(torch.from_numpy, tree), weights, rounds)
    for a, b in zip(jax.tree.leaves(convert.to_numpy((ti, tp))),
                    jax.tree.leaves((ji, jp))):
        np.testing.assert_allclose(a, np.asarray(b), rtol=1e-6, atol=1e-7)
    # the reference takes the cosines in f32, the port in f64: a few f32 ulps
    for p in (1, 2, 3, 8):
        assert abs(tavg.gossip_mixing_lambda2(p)
                   - javg.gossip_mixing_lambda2(p)) < 1e-6


@pytest.mark.parametrize("rounds", [1, 2])
def test_gossip_reduce(shards, rounds):
    """The gossip combine: the published model is ``gossip_member_dim``'s
    readout of the final members; with rounds=2 the sync leaves each
    member on its own consensus iterate; and the run matches the
    reference's."""
    parts = shards["unequal"]
    mk = dict(epochs=2, batch_size=BATCH)
    got = _port(parts, MapConfig(lr_schedule=schedules.dynamic_paper(0.05),
                                 **mk),
                ReduceConfig(strategy="gossip", rounds=rounds))
    sm = got.stacked
    _, published = tavg.gossip_member_dim((sm.cnn_params, sm.beta), None, 4)
    assert _equal(got.averaged, cnn_elm.CNNELMModel(*published))
    ref = _reference(parts, dict(lr_schedule=jsched.dynamic_paper(0.05), **mk),
                     JReduce(strategy="gossip", rounds=rounds))
    _close(_leaves(got.stacked), _ref_leaves(ref.stacked))
    _close(_leaves(got.averaged), _ref_leaves(ref.averaged))


# ---------------------------------------------------------------------------
# Configuration errors the reference raises too
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("make", [
    lambda: MapConfig(epochs=1),                                 # no rate
    lambda: MapConfig(chunk_batches=0),
    lambda: ReduceConfig(strategy="boosted"),                    # no slice
    lambda: ReduceConfig(validation=Partition(np.zeros((1, 28, 28)),
                                              np.zeros(1))),
    lambda: ReduceConfig(rounds=0),
    lambda: ReduceConfig(sync="never"),
])
def test_config_errors(make):
    with pytest.raises(ValueError):
        make()


@pytest.mark.parametrize("map_kw,reduce_kw", [
    (dict(backend="sequential", epochs=2), dict(rounds=2)),
    (dict(backend="sequential", epochs=2), dict(strategy="gossip")),
    (dict(epochs=0), dict(rounds=2)),
    (dict(epochs=3), dict(rounds=2)),
])
def test_run_errors(shards, map_kw, reduce_kw):
    with pytest.raises(ValueError):
        _port(shards["iid"], MapConfig(
            lr_schedule=schedules.dynamic_paper(0.05), batch_size=BATCH,
            **map_kw), ReduceConfig(**reduce_kw))
