"""The mesh backend on the flat ``('pod',)`` mesh over 4 and over 2 gloo
ranks (``launch.mesh.run_ranks``; the rank side is
``tests/torch_mesh_ranks.py``), against the port's stacked run and the
reference's stacked run on the same inputs (the reference's init tree
passed in; its own multi-device mesh does not run on this toolchain, and
its contract calls the two equivalent).

Each world is spawned once for all its cases. Bars: members bitwise equal
to the port's stacked run after the epochs=0 pass (each rank trains its
members exactly as the stacked run does); averaged models within rtol
1e-5, atol 1e-6 (only the association of the ranks' partials differs);
hook models after a sync within rtol 1e-4, atol 2e-5; every rank's result
the same bits.
"""
import numpy as np
import pytest
import torch

import jax

from repro.configs.base import get_reduced_config as jget_r
from repro.configs.base import replace as jreplace
from repro.core import e2lm as je2lm, elm as jelm
from repro.core.reduce_strategies import Gossip as JGossip
from repro.core.runner import (AveragingRun as JRun, MapConfig as JMap,
                               ReduceConfig as JReduce)
from repro.data.partition import Partition as JPartition
from repro.models import cnn as jcnn
from repro.optim.schedules import dynamic_paper as jdynamic
from repro_torch.core import e2lm, elm
from repro_torch.distributed import collectives
from repro_torch.launch.mesh import run_ranks

import torch_mesh_ranks as ranks

# the reference's threaded tests share the CPU with these workers
torch.set_num_threads(2)

JCFG = jreplace(jget_r("cnn_elm_6c12c"), elm_lambda=1.0)
KEY = jax.random.PRNGKey(0)
INIT = jax.tree.map(np.asarray, jcnn.init_params(JCFG, KEY))
T = 3                                   # gossip mixing rounds

CASES = {
    4: [dict(name="e0_k4", shards=("iid", 4)),
        dict(name="e0_k3", shards=("iid", 3)),              # one pad slot
        dict(name="e0_k6", shards=("iid", 6)),              # two pad slots
        dict(name="shard_weighted", shards=("unequal",),
             strategy="shard_weighted"),
        dict(name="sgd", shards=("iid", 4), epochs=2, rounds=2, hook=True),
        dict(name="gossip_sgd", shards=("iid", 4), epochs=2, rounds=2,
             strategy="gossip", gossip=T, hook=True),
        dict(name="e2lm", shards=("iid", 4), kind="e2lm")],
    2: [dict(name="e0_k4", shards=("iid", 4)),
        dict(name="boosted", shards=("iid", 4), strategy="boosted"),
        dict(name="gossip_e0", shards=("iid", 4), strategy="gossip",
             gossip=T),
        dict(name="gossip_sgd", shards=("iid", 4), epochs=2, rounds=2,
             strategy="gossip", gossip=T),
        dict(name="sgd", shards=("iid", 4), epochs=2, rounds=2, hook=True)],
}


@pytest.fixture(scope="module")
def worlds():
    """{world: {case name: [each rank's result]}}, one spawn a world."""
    out = {}
    for world, cases in CASES.items():
        per_rank = run_ranks(ranks.cases_on_ranks, world, device="cpu",
                             args=(cases, INIT), timeout_s=240)
        out[world] = {c["name"]: [r[i] for r in per_rank]
                      for i, c in enumerate(cases)}
    return out


_stacked_cache: dict = {}


def _stacked(case):
    """The port's stacked run of ``case``, in this process."""
    key = case["name"] + repr(sorted(case.items()))
    if key not in _stacked_cache:
        _stacked_cache[key] = ranks.stacked_case(case, INIT)
    return _stacked_cache[key]


def _reference(case):
    """The reference's stacked run of ``case``: its init from KEY."""
    epochs = case.get("epochs", 0)
    strategy = case.get("strategy", "uniform")
    if strategy == "gossip":
        strategy = JGossip(rounds=case["gossip"])
    hooks = {}
    res = JRun(JCFG, JMap(epochs=epochs,
                          lr_schedule=jdynamic(ranks.LR) if epochs else None,
                          batch_size=ranks.BATCH, backend="stacked",
                          use_pallas=False),
               JReduce(strategy=strategy, rounds=case.get("rounds", 1))).run(
        [JPartition(p.x, p.y) for p in ranks.shards(case["shards"])], KEY,
        round_hook=(lambda r, avg: hooks.__setitem__(r, _jleaves(avg))))
    return res, hooks


def _jleaves(model):
    return [np.asarray(a) for a in jax.tree.leaves((model.cnn_params,
                                                    model.beta))]


def _equal(a, b):
    return len(a) == len(b) and all(np.array_equal(x, y)
                                    for x, y in zip(a, b))


def _close(a, b, rtol=1e-5, atol=1e-6):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        np.testing.assert_allclose(x, y, rtol=rtol, atol=atol)


EPOCHS0 = [(4, "e0_k4"), (4, "e0_k3"), (4, "e0_k6"), (4, "shard_weighted"),
           (2, "e0_k4"), (2, "boosted")]


@pytest.mark.parametrize("world,name", EPOCHS0)
def test_epochs0_members_are_the_stacked_members(worlds, world, name):
    case = next(c for c in CASES[world] if c["name"] == name)
    got, want = worlds[world][name][0], _stacked(case)
    assert len(got["members"]) == len(want["members"])
    assert all(_equal(a, b) for a, b in zip(got["members"],
                                            want["members"]))
    assert _equal(got["stats"], want["stats"])


@pytest.mark.parametrize("world,name", EPOCHS0)
def test_epochs0_average_matches_stacked_and_reference(worlds, world, name):
    case = next(c for c in CASES[world] if c["name"] == name)
    got = worlds[world][name][0]["averaged"]
    _close(got, _stacked(case)["averaged"])
    if case.get("strategy") != "boosted":
        _close(got, _jleaves(_reference(case)[0].averaged))


@pytest.mark.parametrize("world", sorted(CASES))
def test_every_rank_returns_the_same_result(worlds, world):
    for name, per_rank in worlds[world].items():
        for r in per_rank[1:]:
            for key in ("members", "averaged", "stats", "beta", "psum"):
                if key in per_rank[0]:
                    a, b = per_rank[0][key], r[key]
                    if key == "members":
                        assert all(_equal(x, y) for x, y in zip(a, b)), name
                    else:
                        assert _equal(a, b), (name, key)


@pytest.mark.parametrize("world", sorted(CASES))
def test_two_round_sgd_hooks_match_stacked_and_reference(worlds, world):
    """Two SGD epochs in two rounds: one sync; the hook's models (the
    model every member was reset to, then the final Reduce) within rtol
    1e-4, atol 2e-5 of both stacked runs."""
    case = next(c for c in CASES[world] if c["name"] == "sgd")
    got = worlds[world]["sgd"][0]
    st = _stacked(case)
    _, jhooks = _reference(case)
    assert got["syncs"] == 1 and sorted(got["hooks"]) == [0, 1]
    for r in (0, 1):
        _close(got["hooks"][r], st["hooks"][r], rtol=1e-4, atol=2e-5)
        _close(got["hooks"][r], jhooks[r], rtol=1e-4, atol=2e-5)


def _spans(result, label):
    return [counts for name, counts in result["log"] if name == label]


@pytest.mark.parametrize("world", sorted(CASES))
def test_collective_contracts(worlds, world):
    """No collective in any epoch; ONE all-reduce a flat Reduce and sync;
    2·T ring exchanges and no all-reduce a gossip sync; one all-gather a
    snapshot and a boosted weight resolve."""
    for case in CASES[world]:
        res = worlds[world][case["name"]][0]
        if case.get("kind") == "e2lm":
            (e,) = _spans(res, "e2lm")
            assert collectives.check_one_all_reduce(e).ok
            continue
        assert _spans(res, "epoch")
        for counts in _spans(res, "epoch"):
            assert collectives.check_no_collectives(counts).ok
        gossip = case.get("strategy") == "gossip"
        for counts in _spans(res, "sync"):
            check = (collectives.check_gossip_sync(counts, rounds=T,
                                                   ring=world)
                     if gossip else collectives.check_one_all_reduce(counts))
            assert check.ok, (case["name"], check.detail)
        for counts in _spans(res, "reduce"):
            want = ({"ring_exchange": 2 * T, "all_gather": 1} if gossip
                    else {"all_reduce": 1})
            assert collectives.by_kind(counts) == want, case["name"]
        for counts in _spans(res, "gather") + _spans(res, "weights"):
            assert collectives.by_kind(counts) == {"all_gather": 1}
        assert len(_spans(res, "sync")) == case.get("rounds", 1) - 1
        assert len(_spans(res, "weights")) == (
            1 if case.get("strategy") == "boosted" else 0)


def test_gossip_published_matches_stacked_and_reference(worlds):
    """Four ranks of one member each: the ring is the stacked gossip's, so
    the published model after a gossip sync and the final mixing matches
    the port's and the reference's stacked gossip; two ranks of two
    members publish the same Σ num / Σ den at epochs=0."""
    for world, name in ((4, "gossip_sgd"), (2, "gossip_e0")):
        case = next(c for c in CASES[world] if c["name"] == name)
        got = worlds[world][name][0]["averaged"]
        _close(got, _stacked(case)["averaged"])
        _close(got, _jleaves(_reference(case)[0].averaged))
    # the p = 2 ring mixes its one peer on both sides and stays finite
    res = worlds[2]["gossip_sgd"][0]
    assert all(np.isfinite(a).all() for a in res["averaged"])


def test_boosted_weights_are_the_stacked_weights(worlds):
    got = worlds[2]["boosted"][0]
    want = _stacked(next(c for c in CASES[2] if c["name"] == "boosted"))
    assert len(got["weights"]) == 1 and got["weights"] == want["weights"]
    _close(got["averaged"], want["averaged"])


def test_e2lm_psum_stats_and_global_beta(worlds):
    """``psum_stats`` of each rank's members equals ``reduce_stats`` of all
    the members' stats up to the f32 order of the sum; the global β agrees
    with the reference's ``mapreduce_solve`` of the same stats."""
    got = worlds[4]["e2lm"][0]
    k = got["stats"][0].shape[0]
    rows = [elm.ELMStats(*(torch.as_tensor(a[i]) for a in got["stats"]))
            for i in range(k)]
    whole = e2lm.reduce_stats(rows)
    for a, b in zip(got["psum"], whole):
        np.testing.assert_allclose(a, b.numpy(), rtol=1e-5,
                                   atol=1e-6 * float(b.abs().max()))
    jrows = [jelm.ELMStats(*(a[i] for a in got["stats"])) for i in range(k)]
    want = np.asarray(je2lm.mapreduce_solve(jrows, JCFG.elm_lambda))
    assert np.abs(got["beta"] - want).max() <= 1e-4 * np.abs(want).max()
