"""The mesh backend's fault tolerance and its 2-D ``('host', 'pod')`` mesh,
over gloo ranks (``launch.mesh.run_ranks``; the rank side is
``tests/torch_mesh_ranks.py``), held to the port's stacked run.

* Two ranks: a crash right after a round's checkpoint, then the resume,
  bitwise the uninterrupted mesh run, with every checkpoint written once,
  by rank 0; elastic churn (k 3 → 4 → 3: each round block re-pads, so
  members change ranks) bitwise the stacked elastic run, and its crash and
  resume bitwise the uninterrupted run.
* Four ranks as 2 hosts × 2 pods: the epochs=0 members bitwise, the Reduce
  and every sync TWO all-reduces (within a host, then across), the full
  two-round run within rtol 1e-5 of the flat mesh's, gossip refused in the
  reference's words, and the elastic churn bitwise the stacked run.
"""
import numpy as np
import pytest
import torch

import jax

from repro.configs.base import get_reduced_config as jget_r
from repro.configs.base import replace as jreplace
from repro.core import executor as jexec
from repro.models import cnn as jcnn
from repro_torch.distributed import collectives
from repro_torch.launch.mesh import run_ranks

import torch_mesh_ranks as ranks

# the reference's threaded tests share the CPU with these workers
torch.set_num_threads(2)

JCFG = jreplace(jget_r("cnn_elm_6c12c"), elm_lambda=1.0)
INIT = jax.tree.map(np.asarray, jcnn.init_params(JCFG,
                                                 jax.random.PRNGKey(0)))

SGD4 = dict(shards=("iid", 3), epochs=4, rounds=4)
ELASTIC = dict(shards=("iid", 3), epochs=3, rounds=3, elastic=True)
CASES = {
    "flat2": [dict(SGD4, name="sgd4"),
              dict(SGD4, name="crash", kind="crash", crash=1),
              dict(ELASTIC, name="elastic"),
              dict(ELASTIC, name="elastic_crash", kind="crash", crash=1)],
    "2d4": [dict(name="e0", shards=("iid", 4), mesh="2d"),
            dict(name="sgd_2d", shards=("iid", 4), epochs=2, rounds=2,
                 hook=True, mesh="2d"),
            dict(name="sgd_flat", shards=("iid", 4), epochs=2, rounds=2,
                 hook=True),
            dict(name="gossip_2d", shards=("iid", 4), strategy="gossip",
                 gossip=2, mesh="2d", kind="refused"),
            dict(ELASTIC, name="elastic_2d", mesh="2d")],
}


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    out = {}
    for key, world in (("flat2", 2), ("2d4", 4)):
        ckpt = str(tmp_path_factory.mktemp(key))
        per_rank = run_ranks(ranks.cases_on_ranks, world, device="cpu",
                             args=(CASES[key], INIT, ckpt), timeout_s=240)
        out[key] = {c["name"]: [r[i] for r in per_rank]
                    for i, c in enumerate(CASES[key])}
    return out


def _equal(a, b):
    return len(a) == len(b) and all(np.array_equal(x, y)
                                    for x, y in zip(a, b))


def _runs_equal(a, b):
    if isinstance(a["members"], dict):
        assert sorted(a["members"]) == sorted(b["members"])
        assert all(_equal(a["members"][n], b["members"][n])
                   for n in a["members"])
    else:
        assert all(_equal(x, y) for x, y in zip(a["members"],
                                                b["members"]))
    assert _equal(a["averaged"], b["averaged"])


def test_crash_resume_is_bitwise_and_rank0_writes(worlds):
    runs = worlds["flat2"]
    for rank, res in enumerate(runs["crash"]):
        assert res["crashed"] and res["resumed"]
        _runs_equal(res, runs["sgd4"][rank])
        # rounds 0 and 1 before the crash, 2 and 3 after the resume
        assert res["writes"] == ([0, 1, 2, 3] if rank == 0 else [])
    # a checkpoint's write waits for every rank: one barrier a save
    logs = runs["crash"][0]["log"]
    assert not any(collectives.by_kind(c).get("barrier", 0) > 1
                   for _, c in logs)


def test_elastic_churn_is_the_stacked_run(worlds):
    """k 3 → 4 → 3: each block re-pads, so on two ranks m2 moves to rank 0
    when m1 leaves; members, averaged model and the retired share bitwise
    the stacked elastic run's."""
    want = ranks.stacked_case(dict(ELASTIC, name="elastic"), INIT)
    for key, name in (("flat2", "elastic"), ("2d4", "elastic_2d")):
        got = worlds[key][name][0]
        _runs_equal(got, want)
        assert sorted(got["members"]) == ["m0", "m2", "m3"]
        (rp, rw), = got["retired"]
        (ep, ew), = want["retired"]
        assert rw == ew and _equal(rp, ep)


def test_elastic_crash_resume_is_bitwise(worlds):
    runs = worlds["flat2"]
    for rank, res in enumerate(runs["elastic_crash"]):
        assert res["crashed"] and res["resumed"]
        _runs_equal(res, runs["elastic"][rank])
        assert res["writes"] == ([0, 1, 2] if rank == 0 else [])


def test_2d_mesh_members_and_two_all_reduces(worlds):
    runs = worlds["2d4"]
    got = runs["e0"][0]
    want = ranks.stacked_case(dict(name="e0", shards=("iid", 4)), INIT)
    assert all(_equal(a, b) for a, b in zip(got["members"],
                                            want["members"]))
    for a, b in zip(got["averaged"], want["averaged"]):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6)
    for name in ("e0", "sgd_2d"):
        for label, counts in runs[name][0]["log"]:
            if label in ("reduce", "sync"):
                assert collectives.check_two_all_reduces(counts).ok
                # one within the host (pod group), one across (host group)
                assert counts[("all_reduce", "pod")] == 1
                assert counts[("all_reduce", "host")] == 1
            elif label == "epoch":
                assert collectives.check_no_collectives(counts).ok
    for label, counts in runs["sgd_flat"][0]["log"]:
        if label in ("reduce", "sync"):
            assert collectives.check_one_all_reduce(counts).ok


def test_2d_and_flat_full_runs_agree(worlds):
    runs = worlds["2d4"]
    a, b = runs["sgd_2d"][0], runs["sgd_flat"][0]
    assert a["syncs"] == b["syncs"] == 1
    for x, y in zip(a["averaged"], b["averaged"]):
        np.testing.assert_allclose(x, y, rtol=1e-5, atol=1e-6)
    for r in (0, 1):
        for x, y in zip(a["hooks"][r], b["hooks"][r]):
            np.testing.assert_allclose(x, y, rtol=1e-5, atol=1e-6)
    for rank in range(1, 4):
        assert _equal(runs["sgd_2d"][rank]["averaged"], a["averaged"])


def test_gossip_refused_on_the_2d_mesh(worlds):
    jmesh = jax.make_mesh((1, 1), ("host", "pod"))
    with pytest.raises(ValueError) as jerr:
        jexec.MeshExecutor(mesh=jmesh)._check_gossip()
    for res in worlds["2d4"]["gossip_2d"]:
        assert res["error"] == str(jerr.value)
