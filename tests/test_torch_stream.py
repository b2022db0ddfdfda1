"""The port's streaming Map phase (``repro_torch.stream``) against the
reference's (``repro.stream``) on the CPU.

Both packages get the same numpy chunks and the same init tree (the
reference's, through ``repro_torch.convert``); the reference runs at
``use_pallas=False``, its own tests' CPU route. Bars:

* the sliding window: bit-equal totals, evictions and recomputes (an
  elementwise f32 add or subtract rounds the same in torch and numpy);
* detectors and sources: the same decisions and the same chunks;
* ``StreamingRun``: the same sync chunks, prequential scores within one
  held-out row of the reference's (an argmax near a tie may flip under
  another f32 summation order), windowed β and the published model within
  1e-4 · max|β| (the ridge solve amplifies summation-order differences;
  ``tests/test_torch_runner.py``'s bar), scores within 5e-5 · max|score|;
* the port's own contracts bit for bit: sequential == stacked on the CPU,
  ``prefetch`` == no prefetch, post-swap serving == direct scoring.

Every test that starts a thread runs under its own wall-clock limit
(``torch_bounded.bounded``), so a hang fails that test instead of the
suite's clock.
"""
import threading

import numpy as np
import pytest
import torch

import jax

from repro.checkpoint import run_state as jrun_state
from repro.configs.base import get_reduced_config as jget_r
from repro.core.executor import CheckpointConfig as JCheckpoint
from repro.core.runner import MapConfig as JMap, ReduceConfig as JReduce
from repro.models import cnn as jcnn
from repro.stream import (ArraySource as JArraySource,
                          FileSource as JFileSource,
                          StreamConfig as JStreamConfig,
                          StreamingRun as JStreamingRun,
                          SyntheticDriftSource as JDriftSource,
                          member_streams as jmember_streams,
                          make_detector as jmake_detector)
from repro.stream.window import SlidingWindowStats as JWindow
from repro.core import elm as jelm
from repro_torch import convert
from repro_torch.checkpoint import run_state
from repro_torch.checkpoint.ckpt import list_steps
from repro_torch.configs import get_reduced_config
from repro_torch.core import elm, faults
from repro_torch.core.cnn_elm import average_models
from repro_torch.core.executor import (CheckpointConfig, ExecutionPlan,
                                       make_executor)
from repro_torch.core.runner import AveragingRun, MapConfig, ReduceConfig
from repro_torch.data.partition import Partition
from repro_torch.data.synthetic import make_extended_mnist
from repro_torch.serve import (BucketedScorer, CheckpointWatcher,
                               EnsembleServer, ServeConfig)
from repro_torch.stream import (ArraySource, DriftDetector, FileSource,
                                PageHinkleyDetector, SlidingWindowStats,
                                StreamConfig, StreamingRun,
                                SyntheticDriftSource, make_detector,
                                member_streams, write_shard_files)
from repro_torch.stream.window import WindowDriftError
from repro_torch.tree import tree_leaves
from torch_bounded import bounded

# the reference's threaded tests share the CPU with these workers
torch.set_num_threads(2)

CFG = get_reduced_config("cnn_elm_6c12c")
JCFG = jget_r("cnn_elm_6c12c")
F_DIM, C_DIM = 6, 4
SEED = 1000


# ---------------------------------------------------------------------------
# The sliding window
# ---------------------------------------------------------------------------

def _np_stats(rng, n):
    h = rng.standard_normal((n, F_DIM)).astype(np.float32)
    t = np.eye(C_DIM, dtype=np.float32)[rng.integers(0, C_DIM, size=n)]
    return h.T @ h, h.T @ t, np.float32(n)


@pytest.mark.parametrize("total,cap", [(1, 1), (5, 2), (12, 3), (7, 8),
                                       (20, 5)])
def test_window_matches_reference_bitwise(total, cap):
    """The same chunk stats through both windows: the running totals, the
    evicted chunks and the recomputes are the same bits at every push,
    and the gate passes with the reference's error."""
    rng = np.random.default_rng(100 * total + cap)
    ours = SlidingWindowStats(cap, F_DIM, C_DIM, device="cpu")
    ref = JWindow(cap, F_DIM, C_DIM)
    for _ in range(total):
        u, v, n = _np_stats(rng, int(rng.integers(4, 24)))
        got = ours.push(elm.ELMStats(torch.from_numpy(u), torch.from_numpy(v),
                                     torch.tensor(n)))
        want = ref.push(jelm.ELMStats(u, v, n))
        assert (got is None) == (want is None)
        if got is not None:
            for a, b in zip(got, want):
                np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        for a, b in zip(ours.total(), ref.total()):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert (len(ours), ours.pushed, ours.evicted, ours.full) == \
        (len(ref), ref.pushed, ref.evicted, ref.full)
    for a, b in zip(ours.recompute(), ref.recompute()):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert ours.verify() == pytest.approx(ref.verify(), rel=0, abs=0)


def test_window_gate_trips_on_corruption():
    """A corrupted running total trips the gate; reset_from_recompute
    re-anchors it."""
    rng = np.random.default_rng(5)
    w = SlidingWindowStats(2, F_DIM, C_DIM, device="cpu")
    for _ in range(4):
        w.push(elm.ELMStats(*(torch.as_tensor(a)
                              for a in _np_stats(rng, 16))))
    w.verify()
    w._total = elm.ELMStats(w._total.u + 1.0, w._total.v, w._total.n)
    with pytest.raises(WindowDriftError, match="'u'"):
        w.verify()
    assert w.reset_from_recompute() >= 1.0
    w.verify()
    with pytest.raises(ValueError, match="capacity"):
        SlidingWindowStats(0, F_DIM, C_DIM, device="cpu")


def test_window_keeps_f32_on_its_device(monkeypatch):
    """Stats of any float dtype are held as f32 on the window's device;
    without a card, the default device raises."""
    rng = np.random.default_rng(6)
    w = SlidingWindowStats(3, F_DIM, C_DIM, device="cpu")
    u, v, n = _np_stats(rng, 8)
    w.push(elm.ELMStats(torch.from_numpy(u).double(),
                        torch.from_numpy(v).bfloat16(), torch.tensor(8.0)))
    assert all(a.dtype == torch.float32 and a.device.type == "cpu"
               for a in w.total())
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        SlidingWindowStats(3, F_DIM, C_DIM)


# ---------------------------------------------------------------------------
# Detectors
# ---------------------------------------------------------------------------

def _trace(seed, n=40):
    """Scores with noise, a collapse, a slow drip and a recovery."""
    rng = np.random.default_rng(seed)
    base = np.concatenate([np.full(10, 0.9), np.full(6, 0.3),
                           np.linspace(0.9, 0.5, 14), np.full(10, 0.88)])
    return np.clip(base[:n] + rng.normal(0, 0.04, n), 0, 1).tolist()


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("kind,kw", [
    ("ewma", dict(threshold=0.2, alpha=0.2, warmup=3)),
    ("ewma", dict(threshold=0.3, alpha=0.5, warmup=1)),
    ("page_hinkley", dict(threshold=0.2, delta=0.005, warmup=3)),
    ("page_hinkley", dict(threshold=0.3, delta=0.01, warmup=2,
                          recovery=0.1))])
def test_detectors_match_reference(kind, kw, seed):
    """The same score trace through both copies: the same drift state at
    every step, the same baselines and histories."""
    ours, ref = make_detector(kind, **kw), jmake_detector(kind, **kw)
    for s in _trace(seed):
        assert ours.update(s) == ref.update(s)
        assert ours.baseline == ref.baseline or \
            (np.isnan(ours.baseline) and np.isnan(ref.baseline))
    assert ours.history == ref.history and ours.seen == ref.seen
    if kind == "page_hinkley":
        assert (ours._cum, ours._cum_min) == (ref._cum, ref._cum_min)


@pytest.mark.parametrize("make", [
    lambda: DriftDetector(alpha=0.0), lambda: DriftDetector(threshold=0.0),
    lambda: DriftDetector(warmup=0), lambda: PageHinkleyDetector(delta=-1),
    lambda: PageHinkleyDetector(recovery=0.0), lambda: make_detector("cusum")])
def test_detector_validation(make):
    with pytest.raises(ValueError):
        make()


# ---------------------------------------------------------------------------
# Sources
# ---------------------------------------------------------------------------

def _same_chunks(ours, ref):
    ours, ref = list(ours), list(ref)
    assert len(ours) == len(ref)
    for (ox, oy), (rx, ry) in zip(ours, ref):
        np.testing.assert_array_equal(ox, rx)
        np.testing.assert_array_equal(oy, ry)


@pytest.mark.parametrize("rows", [1, 4, 7])
def test_array_source_matches_reference(rows):
    x = np.arange(30, dtype=np.float32).reshape(30, 1)
    y = np.arange(30, dtype=np.int32)
    _same_chunks(ArraySource(x, y, rows).chunks(),
                 JArraySource(x, y, rows).chunks())
    with pytest.raises(ValueError, match="mismatch"):
        ArraySource(x, y[:5], chunk_rows=4)


def test_file_source_matches_reference(tmp_path):
    """Ragged shard files re-chunk to the same stream in both copies, and
    the port's writer writes what the reference's reader reads."""
    x = np.arange(50, dtype=np.float32).reshape(50, 1)
    y = (np.arange(50) % 3).astype(np.int32)
    paths = write_shard_files(x, y, str(tmp_path), rows_per_file=7)
    assert len(paths) == 8 and paths == sorted(paths)
    pattern = str(tmp_path / "shard-*.npz")
    _same_chunks(FileSource(pattern, 8).chunks(),
                 JFileSource(pattern, 8).chunks())
    with pytest.raises(FileNotFoundError, match="matched no files"):
        list(FileSource(str(tmp_path / "none-*.npz"), 4).chunks())


@pytest.mark.parametrize("seed", [0, 3, 11])
def test_synthetic_drift_source_matches_reference(seed):
    kw = dict(n_chunks=5, chunk_rows=16, drift_at=2, seed=seed,
              label_shift=5, n_per_class=6)
    _same_chunks(SyntheticDriftSource(**kw).chunks(),
                 JDriftSource(**kw).chunks())
    _same_chunks(SyntheticDriftSource(**kw, class_filter=(0, 1)).chunks(),
                 JDriftSource(**kw, class_filter=(0, 1)).chunks())


@pytest.mark.parametrize("per_member", [False, True])
def test_member_streams_match_reference(per_member):
    """The same per-member Partition chunks, round robin or one source per
    member, under THE seed + i rule."""
    x = np.arange(96, dtype=np.float32).reshape(96, 1)
    y = np.arange(96, dtype=np.int32)
    if per_member:
        ours = member_streams([ArraySource(x[i::3], y[i::3], 4)
                               for i in range(3)], 3, seed=50,
                              per_member=True)
        ref = jmember_streams([JArraySource(x[i::3], y[i::3], 4)
                               for i in range(3)], 3, seed=50,
                              per_member=True)
    else:
        ours = member_streams(ArraySource(x, y, 8), 3, seed=50)
        ref = jmember_streams(JArraySource(x, y, 8), 3, seed=50)
    for so, sr in zip(ours, ref):
        _same_chunks(((p.x, p.y) for p in so), ((p.x, p.y) for p in sr))
    with pytest.raises(ValueError, match="k must be"):
        member_streams(ArraySource(x, y, 8), 0)


# ---------------------------------------------------------------------------
# StreamingRun against the reference
# ---------------------------------------------------------------------------

def _init_np(seed=0):
    return jax.tree.map(np.asarray, jcnn.init_params(
        JCFG, jax.random.PRNGKey(seed)))


def _data(k=2, rows=32, chunks=12, seed=0):
    ds = make_extended_mnist(n_per_class=40, seed=seed)
    idx = np.random.default_rng(seed).permutation(len(ds.x))[:rows * chunks]
    return ds.x[idx], ds.y[idx]


def _streams(pkg, x, y, k=2, rows=32):
    if pkg == "ref":
        return jmember_streams(JArraySource(x, y, rows), k, seed=SEED)
    return member_streams(ArraySource(x, y, rows), k, seed=SEED)


def _drift_streams(pkg, k=2, n_chunks=9, rows=32):
    kw = [dict(n_chunks=n_chunks, chunk_rows=rows, drift_at=4, seed=11 + i,
               label_shift=5, n_per_class=8) for i in range(k)]
    if pkg == "ref":
        return jmember_streams([JDriftSource(**a) for a in kw], k,
                               seed=SEED, per_member=True)
    return member_streams([SyntheticDriftSource(**a) for a in kw], k,
                          seed=SEED, per_member=True)


def _stream_cfg(pkg, **kw):
    kw.setdefault("window_chunks", 3)
    kw.setdefault("holdout_rows", 8)
    return (JStreamConfig if pkg == "ref" else StreamConfig)(**kw)


def _ref_run(streams, sync="rounds", backend="stacked", strategy="uniform",
             checkpoint=None, **kw):
    return JStreamingRun(
        JCFG, JMap(epochs=0, batch_size=16, backend=backend,
                   use_pallas=False, seed=SEED),
        JReduce(sync=sync, strategy=strategy), _stream_cfg("ref", **kw)).run(
            streams, jax.random.PRNGKey(0), checkpoint=checkpoint)


def _port_run(streams, sync="rounds", backend="stacked", strategy="uniform",
              prefetch=0, checkpoint=None, **kw):
    return StreamingRun(
        CFG, MapConfig(epochs=0, batch_size=16, backend=backend, seed=SEED),
        ReduceConfig(sync=sync, strategy=strategy), _stream_cfg("port", **kw),
        prefetch=prefetch).run(
            streams, init_params=convert.params_from_numpy(_init_np(), "cpu"),
            device="cpu", checkpoint=checkpoint)


def _close(got, want, rel):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=rel * float(np.abs(want).max()))


def _agree_with_reference(ours, ref, hold):
    """Same sync chunks and reasons; scores within one held-out row;
    windowed β and the published models within 1e-4 · max|β|."""
    assert ours.chunks == ref.chunks
    assert ours.sync_chunks == ref.sync_chunks
    assert [s.reason for s in ours.syncs] == [s.reason for s in ref.syncs]
    for a, b in zip(ours.records, ref.records):
        assert a.drifting == b.drifting and a.synced == b.synced
        np.testing.assert_allclose(a.scores, b.scores, rtol=0,
                                   atol=1.0 / hold + 1e-12)
    for a, b in zip(ours.members, ref.members):
        _close(a.beta.numpy(), b.beta, 1e-4)
    for a, b in zip(ours.syncs, ref.syncs):
        _close(a.averaged.beta.numpy(), b.averaged.beta, 1e-4)
    _close(ours.last_published.beta.numpy(), ref.last_published.beta, 1e-4)
    _close(ours.averaged.beta.numpy(), ref.averaged.beta, 1e-4)


@pytest.mark.parametrize("backend", ["stacked", "sequential"])
def test_cadence_policy_matches_reference(backend, tmp_path):
    """sync="rounds" at cadence 2: the same sync chunks as the reference,
    the same checkpointed rounds, β within the bar."""
    x, y = _data()
    ref = _ref_run(_streams("ref", x, y), sync_every=2, backend=backend,
                   checkpoint=JCheckpoint(dir=str(tmp_path / "ref")),
                   verify_every=2)
    ours = _port_run(_streams("port", x, y), sync_every=2, backend=backend,
                     checkpoint=CheckpointConfig(dir=str(tmp_path / "port")),
                     verify_every=2)
    assert ours.sync_chunks == [0, 1, 3, 5]
    _agree_with_reference(ours, ref, hold=8)
    assert list_steps(str(tmp_path / "port"), run_state.ROUND) == \
        ours.sync_chunks
    # the port's checkpoint is the reference's format: its reader restores
    # the port's round and finds the same published β
    state = jrun_state.restore_round(str(tmp_path / "port"), 3)
    assert state.meta["reason"] == "cadence" and state.meta["mode"] == \
        "stream"
    np.testing.assert_array_equal(np.asarray(state.averaged.beta),
                                  ours.syncs[2].averaged.beta.numpy())
    assert all(r.window_err is not None for r in ours.records[1::2])


def test_drift_policy_ewma_matches_reference():
    """The label-permutation harness under sync="drift" (EWMA): the syncs
    land at the reference's irregular chunks, after the shift."""
    ref = _ref_run(_drift_streams("ref"), sync="drift", drift_threshold=0.3,
                   drift_warmup=2, verify_every=3)
    ours = _port_run(_drift_streams("port"), sync="drift",
                     drift_threshold=0.3, drift_warmup=2, verify_every=3)
    _agree_with_reference(ours, ref, hold=8)
    drift = [s for s in ours.syncs if s.reason == "drift"]
    assert drift and all(s.chunk >= 4 for s in drift)
    assert any(b - a > 1 for a, b in zip(ours.sync_chunks,
                                         ours.sync_chunks[1:]))


def test_drift_policy_page_hinkley_matches_reference_output():
    """Page-Hinkley on the same harness: the port's sync chunks are the
    reference's actual output on the same scores (which need not equal
    the EWMA run's — ROADMAP R1)."""
    ref = _ref_run(_drift_streams("ref"), sync="drift", drift_threshold=0.3,
                   drift_warmup=2, drift_detector="page_hinkley")
    ours = _port_run(_drift_streams("port"), sync="drift",
                     drift_threshold=0.3, drift_warmup=2,
                     drift_detector="page_hinkley")
    _agree_with_reference(ours, ref, hold=8)


def test_sequential_equals_stacked_bitwise():
    """On the CPU the port's two streaming backends are the same bits:
    windowed β, the published models and the window totals."""
    x, y = _data()
    a = _port_run(_streams("port", x, y), sync_every=2, backend="stacked")
    b = _port_run(_streams("port", x, y), sync_every=2,
                  backend="sequential")
    assert a.sync_chunks == b.sync_chunks
    assert [r.scores for r in a.records] == [r.scores for r in b.records]
    for ma, mb in zip(a.members, b.members):
        assert torch.equal(ma.beta, mb.beta)
    for wa, wb in zip(a.windows, b.windows):
        assert all(torch.equal(p, q) for p, q in zip(wa.total(), wb.total()))
    assert torch.equal(a.last_published.beta, b.last_published.beta)


@pytest.mark.parametrize("backend", ["stacked", "sequential"])
def test_executor_solves_beta_only_when_read(backend, monkeypatch):
    """A ``MapOutcome`` solves its members' β and averages them only when
    read: a streaming run, which solves β from its windows, runs one
    (member-stacked) solve a chunk and no other; an outcome read after
    the fact gives each member the bits of solving its own stats."""
    calls = []
    real = elm.solve_beta

    def spy(stats, lam, infos=None):
        calls.append(stats.u.shape)
        return real(stats, lam, infos)

    monkeypatch.setattr(elm, "solve_beta", spy)
    x, y = _data()
    res = _port_run(_streams("port", x, y), sync_every=2, backend=backend)
    assert len(calls) == res.chunks == 6
    calls.clear()
    parts = [Partition(x[i::2], y[i::2]) for i in range(2)]
    out = make_executor(backend).execute(
        CFG, convert.params_from_numpy(_init_np(), "cpu"), parts,
        ExecutionPlan(batch_size=16, device="cpu"))
    assert calls == [] and len(out.member_params) == 2
    members, averaged = out.members, out.averaged
    out.members, out.averaged, out.stacked       # solved once, then kept
    assert len(calls) == (1 if backend == "stacked" else 2)
    for i, mm in enumerate(members):
        assert torch.equal(mm.beta, real(elm.ELMStats(
            out.stats.u[i], out.stats.v[i], out.stats.n[i]), CFG.elm_lambda))
        assert all(torch.equal(p, q) for p, q in zip(
            tree_leaves(mm.cnn_params), tree_leaves(out.member_params[i])))
    assert torch.equal(averaged.beta, average_models(members).beta)


def test_windowed_beta_is_exact_over_window():
    """epochs=0: each member's β is the solve over its window total, the
    window holds its capacity, and the gate ran every second chunk."""
    x, y = _data()
    res = _port_run(_streams("port", x, y), verify_every=2)
    assert res.chunks == 6 and res.backend == "stacked"
    for m, w in zip(res.members, res.windows):
        assert len(w) == 3 and w.evicted == res.chunks - 3
        w.verify()
        assert torch.equal(m.beta, elm.solve_beta(w.total(),
                                                  CFG.elm_lambda))
    assert [r.window_err is not None for r in res.records] == \
        [t % 2 == 1 for t in range(6)]
    assert res.launches["conv2d"] == 0       # the CPU route runs no kernel


def test_policies_and_publish_flags():
    x, y = _data()
    never = _port_run(_streams("port", x, y))
    assert never.sync_chunks == [0] and never.last_published is not None
    silent = _port_run(_streams("port", x, y), initial_publish=False)
    assert silent.syncs == [] and silent.last_published is None
    capped = _port_run(_streams("port", x, y), max_chunks=2)
    assert capped.chunks == 2


@bounded(120)
def test_prefetch_bit_identical():
    """prefetch=3 against the synchronous pull: the same chunks, syncs and
    bits."""
    x, y = _data()
    ref = _port_run(_streams("port", x, y), sync_every=2)
    pre = _port_run(_streams("port", x, y), sync_every=2, prefetch=3)
    assert pre.chunks == ref.chunks and pre.sync_chunks == ref.sync_chunks
    for a, b in zip(ref.members, pre.members):
        assert torch.equal(a.beta, b.beta)
    assert torch.equal(ref.last_published.beta, pre.last_published.beta)


@bounded(120)
def test_prefetch_retires_on_early_stop_and_propagates_errors():
    """max_chunks stops the consumer before the producer drains: the
    prefetch thread is told to stop and exits; a source that dies on the
    prefetch thread raises its own exception at the chunk loop."""
    x, y = _data()
    before = set(threading.enumerate())
    res = _port_run(_streams("port", x, y), max_chunks=2, prefetch=1)
    assert res.chunks == 2
    started = [t for t in threading.enumerate() if t not in before
               and t.name.startswith("repro-torch-stream-prefetch")]
    for t in started:
        t.join(timeout=5.0)
        assert not t.is_alive(), "prefetch thread leaked past run()"

    def poisoned(it, n):
        for i, v in enumerate(it):
            if i == n:
                raise RuntimeError("stream source died")
            yield v

    with pytest.raises(RuntimeError, match="stream source died"):
        _port_run([poisoned(s, 2) for s in _streams("port", x, y)],
                  prefetch=2)


@bounded(180)
def test_watcher_hot_reloads_irregular_rounds(tmp_path):
    """A live endpoint on round 0 of a streaming run: one poll jumps to
    round 11 past 7, the next to 25 past a torn round 40; the swaps
    recapture nothing, and after them the endpoint's answers equal direct
    scoring of the restored round bit for bit."""
    x, y = _data()
    d = str(tmp_path)
    res = _port_run(_streams("port", x, y), checkpoint=CheckpointConfig(d))
    stats = run_state.stack_stats([w.total() for w in res.windows])
    reversed_members = res.stacked.unstack()[::-1]
    from repro_torch.core.cnn_elm import stack_models
    for r, members in ((7, res.stacked),
                       (11, stack_models(reversed_members))):
        run_state.save_round(d, r, members=members, stats=stats,
                             averaged=res.averaged,
                             meta={"round": r, "final": False})
    scorer = BucketedScorer(CFG, run_state.restore_round(d, 0, "cpu").members,
                            max_batch=8, device="cpu").warmup()
    budget = scorer.compile_count()
    srv = EnsembleServer(scorer, ServeConfig(max_batch=8, max_wait_ms=1.0)
                         ).start(warmup=False)
    try:
        watcher = CheckpointWatcher(d, srv, poll_ms=5, start_round=0)
        assert watcher.poll_once() == 11
        assert watcher.poll_once() is None
        probe = x[:7]
        post = np.stack([f.result(timeout=30).member_scores
                         for f in [srv.submit(img) for img in probe]], axis=1)
        direct = BucketedScorer(CFG, run_state.restore_round(d, 11,
                                                             "cpu").members,
                                max_batch=8, device="cpu").score_block(probe)
        np.testing.assert_array_equal(post, direct)
        run_state.save_round(d, 25, members=res.stacked, stats=stats,
                             averaged=res.averaged,
                             meta={"round": 25, "final": False})
        faults.inject_torn_save(d, run_state.ROUND, 40, crash=False)
        assert watcher.poll_once() == 25
        assert watcher.current_round == 25 and watcher.rejected == []
        assert [s.round for s in watcher.swaps] == [11, 25]
    finally:
        srv.close()
    stats_ = srv.stats()
    assert stats_.failed == 0 and stats_.dropped == 0 and stats_.swaps == 1
    assert scorer.compile_count() == budget


def test_shard_weighted_uses_window_rows():
    x, y = _data()
    run = StreamingRun(CFG, MapConfig(epochs=0, batch_size=16),
                       ReduceConfig(strategy="shard_weighted"),
                       StreamConfig(window_chunks=3, holdout_rows=8))
    res = run.run(_streams("port", x, y),
                  init_params=convert.params_from_numpy(_init_np(), "cpu"),
                  device="cpu")
    assert run._weights(res.windows) == \
        [float(w.total().n) for w in res.windows]
    with pytest.raises(ValueError, match="explicit weights"):
        _port_run(_streams("port", x, y), strategy=[1.0, 2.0, 3.0])


def test_stream_validation():
    with pytest.raises(ValueError, match="rounds=1"):
        StreamingRun(CFG, MapConfig(epochs=2, lr_schedule=lambda e: 0.05,
                                    batch_size=16), ReduceConfig(rounds=2))
    with pytest.raises(ValueError, match="gossip"):
        StreamingRun(CFG, reduce_cfg=ReduceConfig(strategy="gossip"))
    with pytest.raises(ValueError, match="prefetch"):
        StreamingRun(CFG, prefetch=-1)
    for bad in (dict(window_chunks=0), dict(holdout_rows=0),
                dict(sync_every=-1), dict(drift_detector="cusum")):
        with pytest.raises(ValueError):
            StreamConfig(**bad)
    run = StreamingRun(CFG, MapConfig(epochs=0, batch_size=16))
    gen = torch.Generator().manual_seed(0)
    with pytest.raises(ValueError, match="at least one"):
        run.run([], generator=gen, device="cpu")
    with pytest.raises(ValueError, match="no chunks"):
        run.run([[], []], generator=gen, device="cpu")
    with pytest.raises(ValueError, match="CheckpointConfig"):
        run.run([[]], generator=gen, device="cpu", checkpoint="/tmp/x")
    with pytest.raises(ValueError, match="generator"):
        run.run([[]], device="cpu")


def test_reduce_config_drift_constructs_and_batch_runner_refuses():
    """ReduceConfig(sync="drift") is the reference's: it constructs with
    rounds 1 and no elastic schedule, and AveragingRun.run points to
    StreamingRun."""
    rc = ReduceConfig(sync="drift")
    assert rc.sync == "drift" and rc.rounds == 1
    with pytest.raises(ValueError, match="rounds"):
        ReduceConfig(sync="drift", rounds=2)
    with pytest.raises(ValueError, match="sync"):
        ReduceConfig(sync="bogus")
    parts = [Partition(np.zeros((32, 28, 28), np.float32),
                       np.zeros(32, np.int32))]
    with pytest.raises(ValueError, match="StreamingRun"):
        AveragingRun(CFG, MapConfig(epochs=0, batch_size=16), rc).run(
            parts, generator=torch.Generator().manual_seed(0), device="cpu")
    with pytest.raises(ValueError, match="rounds"):
        JReduce(sync="drift", rounds=2)
