"""The port's fault-tolerance layer against the reference's: per-round and
per-member checkpoints with a bit-identical resume, the checkpoint schema
and its atomicity, elastic membership (join from the boundary average,
leave with a weighted contribution), elastic checkpoint/resume, the
failure-injection harness — the counterparts of
``tests/test_fault_tolerance.py`` for the sequential and stacked backends
— and the ``.npz`` files crossing between the two packages.

Both packages start from the reference's init tree (through
``repro_torch.convert``) on the same partitions. Tolerances: a resume, a
checkpoint round trip and the port's sequential-vs-stacked elastic run are
bit-identical (``torch.equal``); the port against the reference after SGD
is held at the SGD parity bar of ``tests/test_torch_sgd.py`` (rtol 1e-4,
atol 2e-5, λ = 1); the empty elastic schedule against plain rounds at the
reference's own rtol 1e-5, atol 1e-6 (a weighted and a plain mean round
differently).
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import ckpt as jckpt
from repro.checkpoint import run_state as jrun_state
from repro.configs.base import get_reduced_config as jget_r
from repro.configs.base import replace as jreplace
from repro.core import faults as jfaults
from repro.core.runner import (AveragingRun as JRun, MapConfig as JMap,
                               ReduceConfig as JReduce)
from repro.data.partition import partition_iid, partition_unequal
from repro.data.synthetic import make_extended_mnist
from repro.models import cnn as jcnn
from repro.optim.schedules import dynamic_paper as jdynamic_paper
from repro_torch import convert
from repro_torch.checkpoint import run_state
from repro_torch.checkpoint.ckpt import (latest_step, list_steps,
                                         restore_checkpoint, save_checkpoint)
from repro_torch.configs import get_reduced_config, replace
from repro_torch.core import elm, executor, faults
from repro_torch.core.averaging import weighted_average_trees
from repro_torch.core.cnn_elm import CNNELMModel
from repro_torch.core.executor import ExecutionPlan, make_executor
from repro_torch.core.runner import (AveragingRun, CheckpointConfig,
                                     ElasticEvent, ElasticSchedule,
                                     MapConfig, ReduceConfig)
from repro_torch.data.partition import Partition
from repro_torch.optim.schedules import dynamic_paper
from repro_torch.tree import tree_leaves

# the reference's threaded tests share the CPU with these workers
torch.set_num_threads(2)

JCFG = jreplace(jget_r("cnn_elm_6c12c"), elm_lambda=1.0)
CFG = replace(get_reduced_config("cnn_elm_6c12c"), elm_lambda=1.0)
KEY = jax.random.PRNGKey(0)
INIT = jax.tree.map(np.asarray, jcnn.init_params(JCFG, KEY))
LR = dynamic_paper(0.05)
CPU = dict(init_params=convert.params_from_numpy(INIT, "cpu"), device="cpu")


@pytest.fixture(scope="module")
def parts():
    ds = make_extended_mnist(n_per_class=12, seed=0)
    return [Partition(p.x, p.y) for p in partition_iid(ds.x, ds.y, k=3,
                                                       seed=0)]


def _models_bit_equal(a, b):
    la, lb = tree_leaves((a.cnn_params, a.beta)), tree_leaves((b.cnn_params,
                                                               b.beta))
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert torch.equal(x, y)


def _runs_bit_equal(ref, res):
    assert len(ref.members) == len(res.members)
    for a, b in zip(ref.members, res.members):
        _models_bit_equal(a, b)
    _models_bit_equal(ref.averaged, res.averaged)


def _stacked_run(rounds=4, epochs=4, backend="stacked", seed=1000):
    return AveragingRun(CFG, MapConfig(epochs=epochs, lr_schedule=LR,
                                       batch_size=16, backend=backend,
                                       seed=seed),
                        ReduceConfig(rounds=rounds))


def _count_trained(monkeypatch):
    """Record the partitions ``member_epochs`` trains on."""
    trained = []
    real = executor.member_epochs

    def spy(cfg, init, part, *, seed, **kw):
        trained.append(part)
        return real(cfg, init, part, seed=seed, **kw)

    monkeypatch.setattr(executor, "member_epochs", spy)
    return trained


# ---------------------------------------------------------------------------
# Checkpoint schema: ELMStats + metadata round-trip, atomicity
# ---------------------------------------------------------------------------

def test_round_state_elmstats_and_meta_roundtrip(tmp_path, parts):
    """save → load of a round checkpoint is bit-exact for every piece, and
    its metadata is the reference's: the same fingerprint fields and
    cursor."""
    res = _stacked_run(rounds=1, epochs=2).run(
        parts, checkpoint=CheckpointConfig(dir=str(tmp_path)), **CPU)
    state = run_state.restore_round(str(tmp_path), device="cpu")
    assert state.final and state.round == 0
    assert state.meta["epochs_done"] == 2 and state.meta["rounds"] == 1
    assert state.meta["backend"] == "stacked" and state.meta["seed"] == 1000
    assert state.meta["sizes"] == [len(p.x) for p in parts]
    jmeta = jrun_state.run_fingerprint("stacked", parts, seed=1000,
                                       epochs=2, rounds=1, batch_size=16)
    assert {k: state.meta[k] for k in jmeta} == jmeta
    for a, b in zip(res.members, state.members.unstack()):
        _models_bit_equal(a, b)
    _models_bit_equal(res.averaged, state.averaged)
    # the stats are the sufficient statistics of the saved β
    assert isinstance(state.stats, elm.ELMStats)
    assert state.stats.u.shape[0] == len(parts)
    assert torch.equal(elm.solve_beta(state.stats, CFG.elm_lambda),
                       state.members.beta)
    assert torch.equal(state.stats.u, res.stats.u)
    assert state.resume_params is None


def test_ckpt_atomicity_crash_mid_save(tmp_path, monkeypatch):
    """An interrupted save leaves no partial file at the target path, no
    tmp file, and the previous checkpoint intact."""
    tree = {"w": torch.arange(8, dtype=torch.float32)}
    save_checkpoint(str(tmp_path), "m", 1, tree, {"ok": True})
    real_savez = np.savez

    def dying_savez(f, **arrs):
        real_savez(f, **{k: v for k, v in list(arrs.items())[:1]})
        raise faults.InjectedCrash("disk died mid-save")

    monkeypatch.setattr(np, "savez", dying_savez)
    with pytest.raises(faults.InjectedCrash):
        save_checkpoint(str(tmp_path), "m", 2,
                        {"w": torch.zeros(8)}, {})
    monkeypatch.undo()
    assert list_steps(str(tmp_path), "m") == [1]
    assert not [f for f in os.listdir(tmp_path) if f.endswith(".tmp")]
    restored, meta = restore_checkpoint(str(tmp_path), "m", device="cpu")
    assert torch.equal(restored["w"], tree["w"])
    assert meta["metadata"] == {"ok": True}


# ---------------------------------------------------------------------------
# Crash → resume is bit-identical
# ---------------------------------------------------------------------------

def test_resume_bit_identical_stacked(tmp_path, parts):
    """Killed right after round 1's checkpoint and resumed: members and the
    averaged model equal the uninterrupted run's bit for bit, and only the
    remaining rounds run."""
    ref = _stacked_run().run(parts, **CPU)
    crashed, res = faults.run_crash_resume(
        _stacked_run(), parts, str(tmp_path), unit="round", index=1, **CPU)
    assert crashed and res.resumed
    assert [r.round for r in res.rounds] == [2, 3]
    _runs_bit_equal(ref, res)
    assert torch.equal(ref.stats.u, res.stats.u)


def test_resume_bit_identical_sequential(tmp_path, parts, monkeypatch):
    """Killed after member 1's checkpoint on the sequential backend: the
    resume trains only member 2, and the result is bit-identical."""
    ref = _stacked_run(rounds=1, epochs=2, backend="sequential").run(
        parts, **CPU)
    trained = _count_trained(monkeypatch)
    crashed = faults.run_to_crash(
        _stacked_run(rounds=1, epochs=2, backend="sequential"), parts,
        str(tmp_path), unit="member", index=1, **CPU)
    assert crashed and len(trained) == 2
    res = _stacked_run(rounds=1, epochs=2, backend="sequential").resume(
        parts, str(tmp_path), **CPU)
    assert res.resumed and len(trained) == 3 and trained[2] is parts[2]
    _runs_bit_equal(ref, res)


def test_resume_with_generator_draws_the_same_init(tmp_path, parts):
    """``run_crash_resume`` with a generator sets it back before the resume,
    so a sequential resume trains its missing members from the run's
    init."""
    gen = torch.Generator().manual_seed(5)
    run = _stacked_run(rounds=1, epochs=2, backend="sequential")
    ref = run.run(parts, generator=torch.Generator().manual_seed(5),
                  device="cpu")
    crashed, res = faults.run_crash_resume(run, parts, str(tmp_path),
                                           unit="member", index=0,
                                           generator=gen, device="cpu")
    assert crashed and res.resumed
    _runs_bit_equal(ref, res)


def test_resume_from_final_checkpoint_rebuilds(tmp_path, parts,
                                               monkeypatch):
    """A run killed after its final checkpoint resumes without recomputing:
    the result rebuilds bit-identically from disk, and a round_hook still
    fires for the restored final round."""
    ref = _stacked_run().run(parts,
                             checkpoint=CheckpointConfig(dir=str(tmp_path)),
                             **CPU)
    trained = []
    monkeypatch.setattr(executor.StackedExecutor, "_epoch",
                        lambda *a, **k: trained.append(1))
    res = _stacked_run().resume(parts, str(tmp_path), device="cpu")
    assert res.resumed and res.rounds == [] and trained == []
    _runs_bit_equal(ref, res)
    caught = {}
    hooked = _stacked_run().resume(
        parts, str(tmp_path), device="cpu",
        round_hook=lambda r, avg: (caught.setdefault(r, avg), f"r{r}")[1])
    assert [rec.round for rec in hooked.rounds] == [3]
    assert hooked.rounds[0].hook == "r3"
    _models_bit_equal(caught[3], ref.averaged)


def test_checkpoint_every_and_cadence(tmp_path, parts):
    """every=2 saves round 1 only before the crash; resume(every=2) keeps
    the cadence (round 2 skips its save, round 3 saves as the final) and
    stays bit-identical."""
    ref = _stacked_run().run(parts, **CPU)
    crashed = faults.run_to_crash(_stacked_run(), parts, str(tmp_path),
                                  unit="round", index=1, every=2, **CPU)
    assert crashed
    assert list_steps(str(tmp_path), run_state.ROUND) == [1]
    res = _stacked_run().resume(parts, str(tmp_path), every=2, device="cpu")
    assert [r.round for r in res.rounds] == [2, 3]
    assert run_state.completed_members(str(tmp_path)) == []
    assert list_steps(str(tmp_path), run_state.ROUND) == [1, 3]
    _runs_bit_equal(ref, res)


def test_resume_rejects_mismatched_run(tmp_path, parts):
    """The fingerprint refuses a resume under another config or other
    partitions."""
    faults.run_to_crash(_stacked_run(), parts, str(tmp_path), unit="round",
                        index=1, **CPU)
    with pytest.raises(ValueError, match="seed"):
        _stacked_run(seed=7).resume(parts, str(tmp_path), device="cpu")
    ds = make_extended_mnist(n_per_class=12, seed=1)
    other = partition_iid(ds.x, ds.y, k=4, seed=0)
    with pytest.raises(ValueError, match="k"):
        _stacked_run().resume(other, str(tmp_path), device="cpu")


def test_resume_empty_dir_raises(tmp_path, parts):
    with pytest.raises(FileNotFoundError, match="no resumable"):
        _stacked_run().resume(parts, str(tmp_path), device="cpu")


def test_checkpoint_does_not_change_numerics(tmp_path, parts):
    """Checkpointing only observes: the members are bit-identical with and
    without it."""
    ref = _stacked_run().run(parts, **CPU)
    ck = _stacked_run().run(parts,
                            checkpoint=CheckpointConfig(dir=str(tmp_path)),
                            **CPU)
    _runs_bit_equal(ref, ck)
    assert list_steps(str(tmp_path), run_state.ROUND) == [0, 1, 2, 3]


def test_torn_round_is_skipped_on_resume(tmp_path, parts):
    """A torn newest round file is skipped: the resume starts from the
    newest readable round, overwrites the wreckage, and is bit-identical."""
    ref = _stacked_run().run(parts, **CPU)
    faults.run_to_crash(_stacked_run(), parts, str(tmp_path), unit="round",
                        index=1, **CPU)
    faults.inject_torn_save(str(tmp_path), run_state.ROUND, 2, crash=False)
    assert run_state.latest_round(str(tmp_path)) == 2
    assert run_state.latest_ready_round(str(tmp_path)) == 1
    res = _stacked_run().resume(parts, str(tmp_path), device="cpu")
    assert [r.round for r in res.rounds] == [2, 3]
    _runs_bit_equal(ref, res)
    assert run_state.latest_ready_round(str(tmp_path)) == 3


@pytest.mark.parametrize("case", ["seq_start_round", "stacked_completed",
                                  "gossip_checkpoint"])
def test_executors_keep_the_reference_refusals(tmp_path, parts, case):
    init = convert.params_from_numpy(INIT, "cpu")
    if case == "seq_start_round":
        ex, plan = make_executor("sequential"), ExecutionPlan(
            batch_size=16, start_round=1, device="cpu")
        match = "start_round"
    elif case == "stacked_completed":
        ex, plan = make_executor("stacked"), ExecutionPlan(
            batch_size=16, completed={0: None}, device="cpu")
        match = "completed"
    else:
        ex, plan = make_executor("stacked"), ExecutionPlan(
            epochs=2, lr_schedule=LR, batch_size=16, rounds=2,
            gossip_rounds=2, checkpoint=CheckpointConfig(dir=str(tmp_path)),
            device="cpu")
        match = "gossip"
    with pytest.raises(ValueError, match=match):
        ex.execute(CFG, init, parts, plan)


def test_member_init_gives_each_member_its_own_params(parts):
    """``plan.member_init``: each member starts from its own tree. The
    stacked and sequential backends agree bitwise on it, and a member whose
    tree is the shared init trains as under the shared init."""
    init = CPU["init_params"]
    other = convert.params_from_numpy(jax.tree.map(
        np.asarray, jcnn.init_params(JCFG, jax.random.PRNGKey(5))), "cpu")
    inits = [init, other, init]
    plan = ExecutionPlan(epochs=2, lr_schedule=LR, batch_size=16,
                         member_init=inits, device="cpu")
    st = make_executor("stacked").execute(CFG, init, parts, plan)
    seq = make_executor("sequential").execute(CFG, init, parts, plan)
    shared = make_executor("stacked").execute(CFG, init, parts, ExecutionPlan(
        epochs=2, lr_schedule=LR, batch_size=16, device="cpu"))
    for a, b in zip(st.members, seq.members):
        _models_bit_equal(a, b)
    for i in (0, 2):
        _models_bit_equal(st.members[i], shared.members[i])
    assert not torch.equal(st.members[1].beta, shared.members[1].beta)
    with pytest.raises(ValueError, match="member_init"):
        make_executor("stacked").execute(CFG, init, parts, ExecutionPlan(
            batch_size=16, member_init=inits[:2], device="cpu"))
    with pytest.raises(ValueError, match="member_seeds"):
        make_executor("sequential").execute(CFG, init, parts, ExecutionPlan(
            batch_size=16, member_seeds=[1], device="cpu"))


# ---------------------------------------------------------------------------
# Cross-loading: the .npz files move between the packages
# ---------------------------------------------------------------------------

def test_reference_round_checkpoint_resumes_in_the_port(tmp_path, parts):
    """The reference crashes after round 0 of a two-round stacked run; the
    port resumes from the reference's ``round-0`` file and lands on the
    reference's uninterrupted run at the SGD parity bar."""
    jrun = JRun(JCFG, JMap(epochs=2, lr_schedule=jdynamic_paper(0.05),
                           batch_size=16, use_pallas=False),
                JReduce(rounds=2))
    ref = jrun.run(parts, KEY)
    assert jfaults.run_to_crash(jrun, parts, KEY, str(tmp_path),
                                unit="round", index=0)
    assert list_steps(str(tmp_path), run_state.ROUND) == [0]
    res = _stacked_run(rounds=2, epochs=2).resume(parts, str(tmp_path),
                                                  device="cpu")
    assert res.resumed and [r.round for r in res.rounds] == [1]
    for got, want in zip(res.members + [res.averaged],
                         ref.members + [ref.averaged]):
        g = jax.tree.leaves(convert.to_numpy(got))
        w = [np.asarray(a) for a in jax.tree.leaves((want.cnn_params,
                                                     want.beta))]
        assert len(g) == len(w)
        for a, b in zip(g, w):
            np.testing.assert_allclose(a, b, rtol=1e-4, atol=2e-5)


def test_port_round_checkpoint_restores_in_the_reference(tmp_path, parts):
    """A port-written round file is restored by the reference's
    ``run_state``, every array equal."""
    res = _stacked_run(rounds=2, epochs=2).run(
        parts, checkpoint=CheckpointConfig(dir=str(tmp_path)), **CPU)
    for r in (0, 1):
        mine = run_state.restore_round(str(tmp_path), r, device="cpu")
        theirs = jrun_state.restore_round(str(tmp_path), r)
        assert theirs.meta == mine.meta and theirs.final == (r == 1)
        pairs = [((mine.members.cnn_params, mine.members.beta,
                   tuple(mine.stats),
                   mine.averaged.cnn_params, mine.averaged.beta),
                  (theirs.members.cnn_params, theirs.members.beta,
                   tuple(theirs.stats), theirs.averaged.cnn_params,
                   theirs.averaged.beta))]
        if r == 0:
            pairs.append((mine.resume_params, theirs.resume_params))
        for a, b in pairs:
            la, lb = tree_leaves(a), jax.tree.leaves(b)
            assert len(la) == len(lb)
            for x, y in zip(la, lb):
                assert x.numpy().dtype == np.asarray(y).dtype
                np.testing.assert_array_equal(x.numpy(), np.asarray(y))
    _models_bit_equal(res.averaged, mine.averaged)


def _bf16_bits(a):
    if isinstance(a, torch.Tensor):
        return a.view(torch.int16).numpy().view(np.uint16)
    return np.asarray(a).view(np.uint16)


def test_bf16_roundtrips_bitwise_both_ways(tmp_path):
    """bf16 leaves cross in both directions bit for bit: the port stores
    their uint16 bits under the reference's ``"bfloat16"`` dtype record."""
    rng = np.random.default_rng(0)
    x = rng.normal(size=(5, 7)).astype(np.float32) * 1e3
    x[0, :3] = [np.inf, -0.0, 1e-40]
    mine = {"layers": ({"w": torch.from_numpy(x).to(torch.bfloat16),
                        "s": torch.from_numpy(x[0]).clone()},),
            "step": torch.tensor(3)}
    save_checkpoint(str(tmp_path), "port", 0, mine, {"who": "port"})
    theirs, meta = jckpt.restore_checkpoint(str(tmp_path), "port", 0)
    assert meta["metadata"] == {"who": "port"}
    w = theirs["layers"][0]["w"]
    assert w.dtype == jnp.bfloat16
    np.testing.assert_array_equal(_bf16_bits(w),
                                  _bf16_bits(mine["layers"][0]["w"]))
    np.testing.assert_array_equal(theirs["layers"][0]["s"], x[0])
    back, _ = restore_checkpoint(str(tmp_path), "port", 0, device="cpu")
    assert back["layers"][0]["w"].dtype == torch.bfloat16
    assert torch.equal(back["layers"][0]["w"].view(torch.int16),
                       mine["layers"][0]["w"].view(torch.int16))
    ref_tree = {"w": jnp.asarray(x, jnp.bfloat16),
                "pair": (jnp.asarray(x[1]), jnp.asarray(x[2],
                                                         jnp.bfloat16))}
    jckpt.save_checkpoint(str(tmp_path), "ref", 4, ref_tree)
    got, meta = restore_checkpoint(str(tmp_path), "ref", device="cpu")
    assert meta["step"] == 4 and isinstance(got["pair"], tuple)
    assert got["w"].dtype == got["pair"][1].dtype == torch.bfloat16
    np.testing.assert_array_equal(_bf16_bits(got["w"]),
                                  _bf16_bits(ref_tree["w"]))
    np.testing.assert_array_equal(_bf16_bits(got["pair"][1]),
                                  _bf16_bits(ref_tree["pair"][1]))
    np.testing.assert_array_equal(got["pair"][0].numpy(), x[1])


# ---------------------------------------------------------------------------
# Elastic membership
# ---------------------------------------------------------------------------

def test_elastic_join_starts_from_round_average(parts):
    """A member joining at the round-0 boundary starts from exactly that
    boundary's average: with lr 0 after round 0 its CNN params never move
    again, so they equal the average the round_hook saw."""
    sched = ElasticSchedule((ElasticEvent(after_round=0,
                                          join=(parts[0],)),))
    caught = {}
    res = AveragingRun(
        CFG, MapConfig(epochs=2, lr_schedule=lambda e: [0.05, 0.0][e],
                       batch_size=16),
        ReduceConfig(rounds=2, elastic=sched)).run(
        parts, round_hook=lambda r, m: caught.setdefault(r, m), **CPU)
    joiner = res.members["m3"]
    for la, lb in zip(tree_leaves(joiner.cnn_params),
                      tree_leaves(caught[0].cnn_params)):
        assert torch.equal(la, lb)
    assert res.rounds[0].joined == ["m3"] and res.rounds[1].members == \
        ["m0", "m1", "m2", "m3"]


def test_elastic_leave_weighted_share_vs_manual_replay(parts):
    """The elastic runner against an independent block-by-block replay
    through the executor and bare ``weighted_average_trees``: the leaver
    contributes exactly its weighted share, frozen at leave time."""
    ds = make_extended_mnist(n_per_class=12, seed=0)
    uneq = [Partition(p.x, p.y)
            for p in partition_unequal(ds.x, ds.y, [96, 48], seed=1)]
    sched = ElasticSchedule((ElasticEvent(after_round=0, leave=("m1",)),))
    res = AveragingRun(
        CFG, MapConfig(epochs=2, lr_schedule=LR, batch_size=16),
        ReduceConfig(strategy="shard_weighted", rounds=2,
                     elastic=sched)).run(uneq, **CPU)

    init = CPU["init_params"]
    out0 = make_executor("stacked").execute(CFG, init, uneq, ExecutionPlan(
        epochs=1, lr_schedule=LR, batch_size=16, device="cpu"))
    m1_final = (out0.members[1].cnn_params, out0.members[1].beta)
    avg0 = weighted_average_trees(
        [(out0.members[0].cnn_params, out0.members[0].beta), m1_final],
        [96.0, 48.0])
    out1 = make_executor("stacked").execute(CFG, avg0[0], uneq[:1],
                                            ExecutionPlan(
        epochs=1, lr_schedule=lambda e: LR(1 + e), batch_size=16,
        member_seeds=[1000], start_epochs=[1], device="cpu"))
    final = weighted_average_trees(
        [(out1.members[0].cnn_params, out1.members[0].beta), m1_final],
        [2 * 96.0, 48.0])
    _models_bit_equal(res.members["m0"], out1.members[0])
    _models_bit_equal(res.averaged, CNNELMModel(*final))
    (ret_params, ret_w), = res.group.retired_params
    assert ret_w == 48.0
    _models_bit_equal(CNNELMModel(*ret_params), CNNELMModel(*m1_final))


def test_elastic_sequential_matches_stacked(parts):
    """One leave and one join: the sequential and stacked backends agree
    bit for bit (the reference holds them at rtol 1e-4)."""
    sched = ElasticSchedule((ElasticEvent(after_round=0, leave=("m2",),
                                          join=(parts[2],)),))

    def mk(b):
        return AveragingRun(
            CFG, MapConfig(epochs=2, lr_schedule=LR, batch_size=16,
                           backend=b),
            ReduceConfig(rounds=2, elastic=sched))

    seq = mk("sequential").run(parts, **CPU)
    st = mk("stacked").run(parts, **CPU)
    assert sorted(seq.members) == sorted(st.members) == ["m0", "m1", "m3"]
    for n in seq.members:
        _models_bit_equal(seq.members[n], st.members[n])
    _models_bit_equal(seq.averaged, st.averaged)


def test_elastic_matches_reference(parts):
    """The same churn on both packages: members and the group average at
    the SGD parity bar, and the same membership records."""
    sched = _churn_sched(parts)
    res = _elastic_run(sched).run(parts, **CPU)
    from repro.core.runner import ElasticEvent as JEvent
    from repro.core.runner import ElasticSchedule as JSchedule
    jsched = JSchedule((JEvent(after_round=0, join=(parts[0],)),
                        JEvent(after_round=1, leave=("m1",))))
    ref = JRun(JCFG, JMap(epochs=3, lr_schedule=jdynamic_paper(0.05),
                          batch_size=16, use_pallas=False),
               JReduce(rounds=3, elastic=jsched)).run(parts, KEY)
    assert [r.members for r in res.rounds] == [r.members for r in ref.rounds]
    assert sorted(res.members) == sorted(ref.members)
    for got, want in [(res.members[n], ref.members[n]) for n in ref.members
                      ] + [(res.averaged, ref.averaged)]:
        g = jax.tree.leaves(convert.to_numpy(got))
        w = [np.asarray(a) for a in jax.tree.leaves((want.cnn_params,
                                                     want.beta))]
        for a, b in zip(g, w):
            np.testing.assert_allclose(a, b, rtol=1e-4, atol=2e-5)


def test_elastic_empty_schedule_matches_plain_rounds(parts):
    """No events and uniform weights: the elastic orchestration is the
    plain rounds contract; with lr 0 in round 1 both end at round 0's
    average."""
    def mk_map():
        return MapConfig(epochs=2, lr_schedule=lambda e: [0.05, 0.0][e],
                         batch_size=16)

    plain = AveragingRun(CFG, mk_map(), ReduceConfig(rounds=2)).run(parts,
                                                                    **CPU)
    ela = AveragingRun(CFG, mk_map(),
                       ReduceConfig(rounds=2, elastic=ElasticSchedule())
                       ).run(parts, **CPU)
    for n, m in zip(("m0", "m1", "m2"), plain.members):
        for la, lb in zip(tree_leaves(ela.members[n].cnn_params),
                          tree_leaves(m.cnn_params)):
            np.testing.assert_allclose(la.numpy(), lb.numpy(), rtol=1e-5,
                                       atol=1e-6)


def test_elastic_validation(parts):
    sched = ElasticSchedule((ElasticEvent(after_round=0, leave=("m0",)),))
    with pytest.raises(ValueError, match="rounds >= 2"):
        ReduceConfig(rounds=1, elastic=sched)
    with pytest.raises(ValueError, match="no following round"):
        ReduceConfig(rounds=2, elastic=ElasticSchedule(
            (ElasticEvent(after_round=1, leave=("m0",)),)))
    with pytest.raises(ValueError, match="explicit weight"):
        ReduceConfig(strategy=[1.0, 2.0], rounds=2, elastic=sched)
    with pytest.raises(ValueError, match="elastic_ok"):
        ReduceConfig(strategy="gossip", rounds=2, elastic=sched)
    with pytest.raises(ValueError, match="ElasticSchedule"):
        ReduceConfig(rounds=2, elastic=object())
    with pytest.raises(ValueError, match="at least one"):
        ElasticEvent(after_round=0)
    mk_map = lambda: MapConfig(epochs=2, lr_schedule=LR,    # noqa: E731
                               batch_size=16)
    with pytest.raises(ValueError, match="not a living member"):
        AveragingRun(CFG, mk_map(), ReduceConfig(
            rounds=2, elastic=ElasticSchedule(
                (ElasticEvent(after_round=0, leave=("m9",)),)))
        ).run(parts, **CPU)
    with pytest.raises(ValueError, match="empty the group"):
        AveragingRun(CFG, mk_map(), ReduceConfig(
            rounds=2, elastic=ElasticSchedule(
                (ElasticEvent(after_round=0,
                              leave=("m0", "m1", "m2")),)))
        ).run(parts, **CPU)
    with pytest.raises(ValueError, match="CheckpointConfig"):
        AveragingRun(CFG, mk_map(), ReduceConfig(rounds=2, elastic=sched)
                     ).run(parts, checkpoint="/tmp/x", **CPU)


# ---------------------------------------------------------------------------
# Elastic checkpoint/resume
# ---------------------------------------------------------------------------

def _elastic_run(sched, backend="stacked", rounds=3, seed=1000):
    return AveragingRun(
        CFG, MapConfig(epochs=rounds, lr_schedule=LR, batch_size=16,
                       backend=backend, seed=seed),
        ReduceConfig(rounds=rounds, elastic=sched))


def _churn_sched(parts):
    # a join at round 0's boundary, a leave at round 1's: the resume point
    # after round 1 holds a retired contribution and a joiner whose
    # partition exists only inside the schedule
    return ElasticSchedule((
        ElasticEvent(after_round=0, join=(parts[0],)),
        ElasticEvent(after_round=1, leave=("m1",))))


def _elastic_results_bit_equal(ref, res):
    assert sorted(ref.members) == sorted(res.members)
    for n in ref.members:
        _models_bit_equal(ref.members[n], res.members[n])
    _models_bit_equal(ref.averaged, res.averaged)


@pytest.mark.parametrize("backend", ["stacked", "sequential"])
def test_elastic_resume_bit_identical(tmp_path, parts, backend):
    """Killed right after elastic round 1's checkpoint, with a joiner
    admitted and a leaver retired: the resumed members, averaged model and
    retired contributions equal the uninterrupted run's bit for bit."""
    sched = _churn_sched(parts)
    ref = _elastic_run(sched, backend).run(parts, **CPU)
    crashed, res = faults.run_crash_resume(
        _elastic_run(sched, backend), parts, str(tmp_path),
        unit="round", index=1, **CPU)
    assert crashed and res.resumed
    _elastic_results_bit_equal(ref, res)
    (rp, rw), = res.group.retired_params
    (ep, ew), = ref.group.retired_params
    assert rw == ew
    _models_bit_equal(CNNELMModel(*rp), CNNELMModel(*ep))
    assert [r.round for r in res.rounds] == [2]
    for a, b in zip(res.group.reduce_stats(), ref.group.reduce_stats()):
        assert torch.equal(a, b)


def test_elastic_resume_from_final_rebuilds(tmp_path, parts):
    """A finished elastic run resumes from its final eround checkpoint with
    no recomputation."""
    sched = _churn_sched(parts)
    ref = _elastic_run(sched).run(
        parts, checkpoint=CheckpointConfig(dir=str(tmp_path)), **CPU)
    res = _elastic_run(sched).resume(parts, str(tmp_path), device="cpu")
    assert res.resumed and res.rounds == []
    _elastic_results_bit_equal(ref, res)


def test_elastic_round_state_roundtrip(tmp_path, parts):
    """The eround schema round-trips the ElasticGroup exactly, and its
    files never collide with plain round files."""
    sched = _churn_sched(parts)
    res = _elastic_run(sched).run(
        parts, checkpoint=CheckpointConfig(dir=str(tmp_path)), **CPU)
    assert list_steps(str(tmp_path), run_state.ELASTIC) == [0, 1, 2]
    assert list_steps(str(tmp_path), run_state.ROUND) == []
    state = run_state.restore_elastic_round(str(tmp_path), device="cpu")
    assert state.final and state.round == 2
    assert state.living == ["m0", "m2", "m3"]
    assert state.member_id == {"m0": 0, "m2": 2, "m3": 3}
    assert state.joined_round == {"m0": 0, "m2": 0, "m3": 1}
    assert state.next_id == 4
    assert state.meta["mode"] == "elastic"
    assert len(state.group.retired_params) == 1
    assert isinstance(state.group.retired_params, list)
    for n in state.living:
        assert state.group.members[n].steps == res.group.members[n].steps
    mid = run_state.restore_elastic_round(str(tmp_path), 0, device="cpu")
    assert not mid.final and mid.group.retired_params == []
    # the reference reads the same file
    theirs = jrun_state.restore_elastic_round(str(tmp_path))
    assert theirs.living == state.living and theirs.next_id == 4
    assert theirs.meta == state.meta


def test_elastic_resume_rejects_mismatched_run(tmp_path, parts):
    """The elastic fingerprint (mode included) refuses another config, and
    a plain run refuses an elastic directory."""
    sched = _churn_sched(parts)
    faults.run_to_crash(_elastic_run(sched), parts, str(tmp_path),
                        unit="round", index=1, **CPU)
    with pytest.raises(ValueError, match="seed"):
        _elastic_run(sched, seed=7).resume(parts, str(tmp_path),
                                           device="cpu")
    with pytest.raises(FileNotFoundError):
        _stacked_run().resume(parts, str(tmp_path), device="cpu")


def test_elastic_checkpoint_every_cadence(tmp_path, parts):
    """every=2 saves round 1 and the final round; the torn-file probe skips
    a corrupted newest file."""
    sched = _churn_sched(parts)
    _elastic_run(sched).run(
        parts, checkpoint=CheckpointConfig(dir=str(tmp_path), every=2),
        **CPU)
    assert list_steps(str(tmp_path), run_state.ELASTIC) == [1, 2]
    assert run_state.latest_ready_elastic_round(str(tmp_path)) == 2
    faults.inject_torn_save(str(tmp_path), run_state.ELASTIC, 3,
                            crash=False)
    assert run_state.latest_ready_elastic_round(str(tmp_path)) == 2


# ---------------------------------------------------------------------------
# Failure-injection harness
# ---------------------------------------------------------------------------

def test_straggler_drop_policy():
    ds = make_extended_mnist(n_per_class=12, seed=0)
    uneq = partition_unequal(ds.x, ds.y, [32, 32, 96], seed=0)
    sched = faults.straggler_drop_schedule(uneq, factor=1.5)
    assert len(sched.events) == 1
    assert sched.events[0].leave == ("m2",)
    jev, = jfaults.straggler_drop_schedule(uneq, factor=1.5).events
    assert (jev.after_round, jev.leave) == (0, ("m2",))
    balanced = partition_iid(ds.x, ds.y, k=3, seed=0)
    assert faults.straggler_drop_schedule(balanced).events == ()
    tiny = partition_unequal(ds.x, ds.y, [8, 96], seed=0)
    sched = faults.straggler_drop_schedule(tiny, factor=0.1)
    assert len(sched.events[0].leave) == 1
    with pytest.raises(ValueError, match="factor"):
        faults.straggler_drop_schedule(uneq, factor=0)


def test_crash_policy_only_fires_at_target(tmp_path, parts):
    """A crash keyed to an index never reached lets the run finish."""
    crashed = faults.run_to_crash(_stacked_run(), parts, str(tmp_path),
                                  unit="round", index=99, **CPU)
    assert not crashed
    assert latest_step(str(tmp_path), run_state.ROUND) == 3
    with pytest.raises(ValueError, match="unit"):
        faults.crash_after("epoch", 0)
    with pytest.raises(faults.InjectedCrash):
        faults.inject_torn_save(str(tmp_path), "x", 0)
