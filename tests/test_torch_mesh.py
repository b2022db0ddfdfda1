"""The mesh backend (``MapConfig(backend="mesh")``) on one rank, in this
process (a one-rank gloo group): against the port's stacked run, bitwise,
and against the reference's one-pod mesh run on the same inputs (the
reference's init tree passed in); plus the collective contracts, the member
layout, ``run_ranks`` and the refusals. The multi-rank cases are in
``test_torch_mesh_flat.py`` and ``test_torch_mesh_faults.py``.

Bars against the reference: β and scores within 1e-4 · max|β| (max|score|)
after the epochs=0 pass, rtol 1e-4 (atol 2e-5) after SGD epochs at
λ = 1 — the port's existing parity bars.
"""
import os
import re
import time

import numpy as np
import pytest
import torch
import torch.distributed as dist

import jax

from repro.configs.base import get_reduced_config as jget_r
from repro.configs.base import replace as jreplace
from repro.core import e2lm as je2lm, elm as jelm
from repro.core import executor as jexec
from repro.core.runner import (AveragingRun as JRun, Ensemble as JEnsemble,
                               MapConfig as JMap, ReduceConfig as JReduce)
from repro.core.reduce_strategies import Gossip as JGossip
from repro.data.partition import Partition as JPartition
from repro.models import cnn as jcnn
from repro.optim.schedules import dynamic_paper as jdynamic
from repro_torch import convert
from repro_torch.core import e2lm, elm
from repro_torch.core.averaging import gossip_ring_mix, pmean_members
from repro_torch.core.executor import ExecutionPlan, make_executor
from repro_torch.core.runner import MapConfig
from repro_torch.distributed import collectives, sharding
from repro_torch.launch.mesh import (axis_size, make_member_mesh,
                                     process_group, run_ranks)
from repro_torch.stream import StreamingRun

from torch_bounded import bounded
import torch_mesh_ranks as ranks

# the reference's threaded tests share the CPU with these workers
torch.set_num_threads(2)

ROOT = os.path.join(os.path.dirname(__file__), "..")
JCFG = jreplace(jget_r("cnn_elm_6c12c"), elm_lambda=1.0)
KEY = jax.random.PRNGKey(0)
INIT = jax.tree.map(np.asarray, jcnn.init_params(JCFG, KEY))


# ---------------------------------------------------------------------------
# Without a process group (these run before the module's group exists)
# ---------------------------------------------------------------------------

def test_make_member_mesh_needs_a_process_group():
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="process group"):
        make_member_mesh()
    # the config constructs; running it without a group raises
    assert MapConfig(backend="mesh").mesh is None
    with pytest.raises(RuntimeError, match="process group"):
        make_executor("mesh").execute(
            ranks.CFG, convert.params_from_numpy(INIT, "cpu"),
            ranks.shards(("iid", 2)),
            ExecutionPlan(batch_size=16, device="cpu"))


@pytest.mark.parametrize("k,slots,want", [
    (4, 4, [[0], [1], [2], [3]]),
    (3, 4, [[0], [1], [2], []]),
    (6, 4, [[0, 1], [2, 3], [4, 5], []]),
    (4, 2, [[0, 1], [2, 3]]),
    (5, 1, [[0, 1, 2, 3, 4]]),
])
def test_member_layout(k, slots, want):
    assert sharding.k_pad(k, slots) == -(-k // slots) * slots
    got = [list(sharding.member_slice(k, slots, s)) for s in range(slots)]
    assert got == want
    rows = torch.arange(6.0).reshape(2, 3)
    padded = sharding.pad_rows(rows, 4)
    assert padded.shape == (4, 3) and torch.equal(padded[:2], rows)
    assert not padded[2:].any()
    with pytest.raises(ValueError):
        sharding.pad_rows(rows, 1)


def test_collective_checks():
    from collections import Counter
    one = Counter({("all_reduce", "pod"): 1})
    two = Counter({("all_reduce", "pod"): 1, ("all_reduce", "host"): 1})
    ring = Counter({("ring_exchange", "pod"): 6})
    assert collectives.check_one_all_reduce(one).ok
    assert not collectives.check_one_all_reduce(two).ok
    assert collectives.check_two_all_reduces(two).ok
    assert collectives.check_no_collectives(Counter()).ok
    assert not collectives.check_no_collectives(one).ok
    assert collectives.check_gossip_sync(ring, rounds=3, ring=4).ok
    assert not collectives.check_gossip_sync(ring + one, rounds=3,
                                             ring=4).ok
    assert collectives.check_gossip_sync(Counter(), rounds=3, ring=1).ok


def test_no_collective_outside_the_collectives_module():
    """Only ``distributed/collectives.py`` calls torch.distributed's
    collectives; every other module goes through it."""
    calls = re.compile(
        r"\bdist\.(all_reduce|all_gather\w*|reduce_scatter\w*|broadcast\w*"
        r"|barrier|send|recv|isend|irecv|batch_isend_irecv|all_to_all\w*"
        r"|gather\w*|scatter\w*|reduce)\s*\(|torch\.distributed\."
        r"(all_reduce|all_gather|broadcast|barrier|batch_isend_irecv)")
    pkg = os.path.join(ROOT, "src", "repro_torch")
    offenders = []
    for dirpath, _, names in os.walk(pkg):
        for n in names:
            path = os.path.join(dirpath, n)
            if n.endswith(".py") and not path.endswith(
                    os.path.join("distributed", "collectives.py")):
                if calls.search(open(path).read()):
                    offenders.append(path)
    assert offenders == []
    assert calls.search(open(os.path.join(
        pkg, "distributed", "collectives.py")).read())


@bounded(120)
def test_run_ranks_returns_each_rank_and_fails_fast():
    assert run_ranks(ranks.report, 2, device="cpu") == [(0, 2, "gloo"),
                                                        (1, 2, "gloo")]
    # rank 0 waits in an all-reduce rank 1 never joins: the call fails with
    # rank 1's error at once, not at the group's timeout
    with pytest.raises(RuntimeError, match="rank 1 fails on purpose"):
        run_ranks(ranks.fail_on_rank_1, 2, device="cpu",
                  timeout_s=100)


@bounded(150)
def test_run_ranks_fails_fast_with_no_collective_pending():
    """Rank 1 raises after rank 0 has finished its block: rank 0 leaves
    its group at once, not at the group's timeout, and the call fails
    with rank 1's error far under it."""
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="rank 1 fails on purpose"):
        run_ranks(ranks.fail_alone_on_rank_1, 2, device="cpu",
                  timeout_s=300)
    assert time.monotonic() - t0 < 100


# ---------------------------------------------------------------------------
# One rank, in this process
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def group():
    """A one-rank gloo group and its flat and 2-D meshes. Its tests run
    torch on one intra-op thread, as every rank does: the runs they hold
    bitwise to each other then share one summation order whatever the
    machine's load."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        with process_group(device="cpu"):
            yield {"flat": make_member_mesh(),
                   "2d": make_member_mesh(hosts=1)}
    finally:
        torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def test_set():
    from repro_torch.data.synthetic import make_extended_mnist
    return make_extended_mnist(n_per_class=6, seed=5)


def _jparts(parts):
    return [JPartition(p.x, p.y) for p in parts]


def _reference(case):
    """The reference's one-pod mesh run of ``case`` (its init from KEY)."""
    epochs = case.get("epochs", 0)
    return JRun(JCFG, JMap(epochs=epochs,
                           lr_schedule=jdynamic(ranks.LR) if epochs else None,
                           batch_size=ranks.BATCH, backend="mesh",
                           use_pallas=False),
                JReduce(strategy=(JGossip(rounds=case["gossip"])
                                  if "gossip" in case else "uniform"),
                        rounds=case.get("rounds", 1))).run(
        _jparts(ranks.shards(case["shards"])), KEY)


def _equal(a, b):
    return len(a) == len(b) and all(np.array_equal(x, y)
                                    for x, y in zip(a, b))


def _labels(log):
    return [(label, collectives.by_kind(counts)) for label, counts in log]


@pytest.mark.parametrize("mesh", ["flat", "2d"])
def test_one_rank_epochs0_equals_stacked_and_reference(group, test_set,
                                                       mesh):
    case = dict(shards=("iid", 3))
    collectives.reset()
    res = ranks.make_run(case, group[mesh]).run(
        ranks.shards(case["shards"]),
        init_params=convert.params_from_numpy(INIT, "cpu"), device="cpu")
    log = _labels(collectives.LOG)
    st = ranks.run_case(case, INIT)
    # one rank holds every member: the stacked run, bit for bit
    assert all(_equal(ranks.numpy_model(m), w)
               for m, w in zip(res.members, st["members"]))
    assert _equal([a.numpy() for a in res.stats], st["stats"])
    assert _equal(ranks.numpy_model(res.averaged), st["averaged"])
    # against the reference's one-pod mesh
    ref = _reference(case)
    got_beta = res.stacked.beta.numpy()
    want_beta = np.asarray(ref.stacked.beta)
    assert np.abs(got_beta - want_beta).max() <= \
        1e-4 * np.abs(want_beta).max()
    avg = np.asarray(ref.averaged.beta)
    assert np.abs(res.averaged.beta.numpy() - avg).max() <= \
        1e-4 * np.abs(avg).max()
    got = res.ensemble().member_scores(test_set.x)
    want = np.asarray(JEnsemble.from_models(JCFG, ref.members).member_scores(
        test_set.x, use_pallas=False))
    assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max()
    # the collective contract: none in the epoch, one gather of the
    # members when read, one all-reduce (two on the 2-D mesh) per Reduce
    labels = [label for label, _ in collectives.LOG]
    assert labels == ["epoch", "gather", "reduce"], log
    spans = dict(collectives.LOG)
    assert collectives.check_no_collectives(spans["epoch"]).ok
    assert collectives.by_kind(spans["gather"]) == {"all_gather": 1}
    check = (collectives.check_one_all_reduce if mesh == "flat"
             else collectives.check_two_all_reduces)
    assert check(spans["reduce"]).ok, log


def test_one_rank_sgd_rounds_match_reference_and_chunking(group):
    """Two SGD epochs in two rounds at λ = 1: the port's stacked run bit for
    bit, the reference's one-pod mesh within rtol 1e-4; one all-reduce per
    sync, none in an epoch; chunk_batches=2 equals the whole epoch."""
    case = dict(shards=("iid", 3), epochs=2, rounds=2, hook=True)
    collectives.reset()
    mesh = ranks.run_case(case, INIT, group["flat"])
    log = list(collectives.LOG)
    st = ranks.run_case(case, INIT)
    assert all(_equal(a, b) for a, b in zip(mesh["members"], st["members"]))
    assert _equal(mesh["averaged"], st["averaged"])
    assert sorted(mesh["hooks"]) == [0, 1] and mesh["syncs"] == 1
    for r in (0, 1):
        assert _equal(mesh["hooks"][r], st["hooks"][r])
    ref = _reference(case)
    for a, b in zip(mesh["averaged"], jax.tree.leaves(
            (ref.averaged.cnn_params, ref.averaged.beta))):
        np.testing.assert_allclose(a, np.asarray(b), rtol=1e-4, atol=2e-5)
    for m, jm in zip(mesh["members"], ref.members):
        for a, b in zip(m, jax.tree.leaves((jm.cnn_params, jm.beta))):
            np.testing.assert_allclose(a, np.asarray(b), rtol=1e-4,
                                       atol=2e-5)
    # round 0: its epoch, the sync, the hook's Reduce; round 1: its epoch
    # and the hook's Reduce; then the members gathered for the result
    assert [label for label, _ in log] == [
        "epoch", "sync", "reduce", "epoch", "reduce", "gather"]
    for label, counts in log:
        if label == "epoch":
            assert collectives.check_no_collectives(counts).ok
        elif label in ("sync", "reduce"):
            assert collectives.check_one_all_reduce(counts).ok
    chunked = ranks.run_case(dict(case, chunk=2), INIT, group["flat"])
    assert all(_equal(a, b) for a, b in zip(chunked["members"],
                                            mesh["members"]))
    assert _equal(chunked["averaged"], mesh["averaged"])


def test_one_rank_gossip_mixes_with_itself(group):
    """A ring of one node: (s + s + s) / 3 computed locally, no exchange;
    the published model is the uniform mean of the stacked gossip, and the
    sync counts no collective at all."""
    x = {"w": torch.randn(2, 5, 3)}
    collectives.reset()
    num, den = gossip_ring_mix(x, [0.25, 0.75], 2,
                               group["flat"].get_group("pod"), "pod")
    assert not collectives.CALLS
    s = x["w"][0] * torch.tensor(0.25) + x["w"][1] * torch.tensor(0.75)
    d = torch.tensor(0.25) + torch.tensor(0.75)
    for _ in range(2):
        s, d = (s + s + s) / 3.0, (d + d + d) / 3.0
    assert torch.equal(num["w"], s) and torch.equal(den, d)
    case = dict(shards=("iid", 3), epochs=2, rounds=2, strategy="gossip",
                gossip=3)
    collectives.reset()
    mesh = ranks.run_case(case, INIT, group["flat"])
    spans = dict(collectives.LOG)
    assert collectives.check_gossip_sync(spans["sync"], rounds=3,
                                         ring=1).ok
    st = ranks.run_case(case, INIT)
    ref = _reference(case)
    for a, b, c in zip(mesh["averaged"], st["averaged"], jax.tree.leaves(
            (ref.averaged.cnn_params, ref.averaged.beta))):
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=2e-5)
        np.testing.assert_allclose(a, np.asarray(c), rtol=1e-4, atol=2e-5)


def test_one_rank_boosted_and_shard_weighted_equal_stacked(group):
    """The boosted weights come from the rank's own scoring and one
    all-gather of the error rates: on one rank, the stacked run's weights
    and averaged model bit for bit; so is shard_weighted on unequal
    shards."""
    for case in (dict(shards=("iid", 3), strategy="boosted"),
                 dict(shards=("unequal",), strategy="shard_weighted")):
        collectives.reset()
        mesh = ranks.run_case(case, INIT, group["flat"])
        spans = dict(collectives.LOG)
        st = ranks.run_case(case, INIT)
        assert mesh["weights"] == st["weights"]
        assert _equal(mesh["averaged"], st["averaged"])
        if case["strategy"] == "boosted":
            assert len(mesh["weights"]) == 1
            assert collectives.by_kind(spans["weights"]) == \
                {"all_gather": 1}


def test_one_rank_e2lm_global_beta_is_mapreduce_solve(group):
    out = ranks._e2lm(dict(shards=("iid", 3)), INIT, group["flat"])
    rows = [elm.ELMStats(*(torch.as_tensor(a[i]) for a in out["stats"]))
            for i in range(3)]
    assert np.array_equal(out["beta"],
                          e2lm.mapreduce_solve(rows, JCFG.elm_lambda).numpy())
    jrows = [jelm.ELMStats(*(a[i] for a in out["stats"])) for i in range(3)]
    want = np.asarray(je2lm.mapreduce_solve(jrows, JCFG.elm_lambda))
    assert np.abs(out["beta"] - want).max() <= 1e-4 * np.abs(want).max()


def test_one_rank_crash_resume_bitwise(group, tmp_path):
    case = dict(shards=("iid", 3), epochs=4, rounds=4, kind="crash",
                crash=1)
    out = ranks._crash_resume(case, INIT, group["flat"], str(tmp_path))
    ref = ranks.run_case(case, INIT, group["flat"])
    assert out["crashed"] and out["resumed"] and out["writes"] == [0, 1, 2, 3]
    assert all(_equal(a, b) for a, b in zip(out["members"], ref["members"]))
    assert _equal(out["averaged"], ref["averaged"])


def test_one_rank_pmean_and_axis_size(group):
    x = {"a": torch.randn(3, 2), "b": torch.randn(5)}
    collectives.reset()
    got = pmean_members(x, group["flat"].get_group("pod"))
    assert all(torch.equal(got[n], x[n]) for n in x)
    assert collectives.by_kind(collectives.CALLS) == {"all_reduce": 2}
    assert axis_size(group["2d"], "host") == axis_size(group["2d"], "pod") \
        == axis_size(group["flat"], "host") == 1


def test_mesh_refusals(group):
    from torch.distributed.device_mesh import init_device_mesh
    parts = ranks.shards(("iid", 3))
    init = convert.params_from_numpy(INIT, "cpu")
    no_pod = init_device_mesh("cpu", (1,), mesh_dim_names=("data",))
    with pytest.raises(ValueError, match="'pod' axis"):
        make_executor("mesh", no_pod).execute(
            ranks.CFG, init, parts, ExecutionPlan(batch_size=16,
                                                  device="cpu"))
    # gossip on the 2-D mesh, with the reference's own words
    with pytest.raises(ValueError) as err:
        ranks.make_run(dict(strategy="gossip", shards=("iid", 3)),
                       group["2d"]).run(parts, init_params=init,
                                        device="cpu")
    jmesh = jax.make_mesh((1, 1), ("host", "pod"))
    with pytest.raises(ValueError) as jerr:
        jexec.MeshExecutor(mesh=jmesh)._check_gossip()
    assert str(err.value) == str(jerr.value)
    with pytest.raises(ValueError, match="member_init"):
        make_executor("mesh", group["flat"]).execute(
            ranks.CFG, init, parts, ExecutionPlan(
                batch_size=16, device="cpu", member_init=[init] * 3))
    with pytest.raises(ValueError, match="backend 'mesh' only"):
        MapConfig(backend="stacked", mesh=group["flat"])
    with pytest.raises(ValueError, match="backend 'mesh' only"):
        make_executor("stacked", mesh=group["flat"])
    # the streaming Map refuses the mesh, as the reference's does
    with pytest.raises(ValueError, match="backend"):
        StreamingRun(ranks.CFG, MapConfig(epochs=0, batch_size=16,
                                          backend="mesh"))
