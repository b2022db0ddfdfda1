"""The port's serving layer: the bucket ladder copy, bucketed scoring
against the ensemble surface, the padding contract, the vote tie rule,
hot-swap validation, the program-count budget, the continuous-batching
scheduler, the load generator, checkpoint hot-reload and the launcher's
``--ensemble`` endpoint, on the CPU. Scores are compared exactly where the
two sides run the same program on the same rows on the same device.

Every test that starts a thread runs under its own wall-clock limit
(``torch_bounded.bounded``), so a hang fails that test instead of the
suite's clock.
"""
import dataclasses
import threading
import time

import numpy as np
import pytest
import torch

from repro.serve.bucketing import BucketLadder as JLadder
from repro.serve.loadgen import LoadReport as JLoadReport
from repro.serve.scheduler import ServeConfig as JServeConfig
from repro_torch.checkpoint import run_state
from repro_torch.configs import get_reduced_config, replace
from repro_torch.core import faults
from repro_torch.core.cnn_elm import StackedMembers, stack_models
from repro_torch.core.executor import CheckpointConfig
from repro_torch.core.runner import (AveragingRun, Ensemble, MapConfig,
                                     ReduceConfig)
from repro_torch.data.partition import partition_iid
from repro_torch.data.synthetic import make_extended_mnist
from repro_torch.launch import serve as launch_serve
from repro_torch.optim.schedules import dynamic_paper
from repro_torch.serve import (BucketLadder, BucketedScorer,
                               CheckpointWatcher, CompileBudgetExceeded,
                               EnsembleServer, LoadReport, QueueFull,
                               ServeConfig, SwapRejected, combine_block,
                               run_open_loop)
from torch_bounded import bounded

# the reference's threaded tests share the CPU with these workers
torch.set_num_threads(2)

CFG = get_reduced_config("cnn_elm_6c12c")


@pytest.fixture(scope="module")
def workload():
    ds = make_extended_mnist(n_per_class=30, seed=0)
    train, test = ds.split(n_test=60)
    result = AveragingRun(CFG, MapConfig(batch_size=100)).run(
        partition_iid(train.x, train.y, 3),
        generator=torch.Generator().manual_seed(0), device="cpu")
    return result, test


@pytest.mark.parametrize("max_batch,min_bucket", [(64, 1), (48, 1), (1, 1),
                                                  (100, 4)])
def test_bucket_ladder_copy_matches_reference(max_batch, min_bucket):
    ours, ref = BucketLadder(max_batch, min_bucket), JLadder(max_batch,
                                                             min_bucket)
    assert ours.buckets == ref.buckets
    for n in range(1, max_batch + 1):
        assert ours.bucket_for(n) == ref.bucket_for(n)
    x = np.ones((max(1, max_batch // 3), 2, 2), np.float32)
    (pa, na), (pb, nb) = ours.pad_block(x), ref.pad_block(x)
    assert na == nb and np.array_equal(pa, pb)
    with pytest.raises(ValueError):
        ours.bucket_for(max_batch + 1)


@pytest.mark.parametrize("n", [1, 3, 64])
def test_score_block_equals_member_scores(workload, n):
    result, test = workload
    ens = result.ensemble()
    scorer = ens.bucketed_scorer(max_batch=64).warmup()
    x = np.concatenate([test.x, test.x])[:n]
    got = scorer.score_block(x)
    assert got.shape == (3, n, CFG.num_classes)
    # same rows in the same padded program: bit-equal
    np.testing.assert_array_equal(got, ens.member_scores(
        x, batch_size=scorer.ladder.bucket_for(n)))
    # the same rows scored inside a larger batch: equal up to f32 order
    full = ens.member_scores(np.concatenate([test.x, test.x]))[:, :n]
    np.testing.assert_allclose(got, full, rtol=1e-5,
                               atol=1e-6 * np.abs(full).max())
    assert np.array_equal(got.argmax(-1), full.argmax(-1))


def test_padding_rows_never_vote(workload):
    """A padded batch's answers equal each image served alone, for both
    combine rules, and equal the ensemble surface's."""
    result, test = workload
    scorer = result.ensemble().bucketed_scorer(max_batch=8)
    n = 5                                     # pads to bucket 8
    for combine in ("mean", "vote"):
        ens = Ensemble(CFG, result.stacked, combine=combine, device="cpu")
        got = scorer.predict_block(test.x[:n], combine=combine)
        assert np.array_equal(got, ens.predict(test.x[:n])), combine
        solo = np.array([scorer.predict_block(test.x[i:i + 1],
                                              combine=combine)[0]
                         for i in range(n)])
        assert np.array_equal(got, solo), combine


def test_vote_tie_resolves_to_lowest_class_index():
    C = 10
    scores = np.zeros((3, 2, C), np.float32)
    for m, cls in enumerate((7, 2, 5)):
        scores[m, 0, cls] = 1.0
    scores[:, 1, 9] = 1.0
    assert combine_block(scores, "vote", C).tolist() == [2, 9]
    scores3 = np.zeros((2, 1, C), np.float32)
    scores3[:, 0, 3] = 0.5
    scores3[:, 0, 6] = 0.5
    assert combine_block(scores3, "mean", C).tolist() == [3]
    with pytest.raises(ValueError):
        combine_block(scores, "median", C)


def test_swap_members_accepts_same_shape_rejects_others(workload):
    result, test = workload
    scorer = BucketedScorer(CFG, result.stacked, max_batch=4, device="cpu")
    before = scorer.score_block(test.x[:3])
    members = result.stacked.unstack()
    swapped = stack_models(members[::-1])          # same tree, new weights
    scorer.swap_members(swapped)
    after = scorer.score_block(test.x[:3])
    np.testing.assert_array_equal(after, before[::-1])
    with pytest.raises(SwapRejected):
        scorer.swap_members(stack_models(members[:2]))          # wrong k
    with pytest.raises(SwapRejected):
        scorer.swap_members(StackedMembers(result.stacked.cnn_params,
                                           result.stacked.beta[:, :, :5]))
    with pytest.raises(SwapRejected):
        scorer.swap_members(StackedMembers(
            result.stacked.cnn_params, result.stacked.beta.double()))
    assert scorer.k == 3


def test_swap_copies_into_the_serving_weights_in_place(workload):
    """The scorer serves its own copy of the weights; a swap overwrites that
    copy in place (the tensors a captured graph reads) and leaves the
    caller's tensors alone."""
    result, _ = workload
    scorer = BucketedScorer(CFG, result.stacked, max_batch=4, device="cpu")
    beta = scorer.members.beta
    assert beta.data_ptr() != result.stacked.beta.data_ptr()
    original = result.stacked.beta.clone()
    members = result.stacked.unstack()
    scorer.swap_members(stack_models(members[::-1]))
    assert scorer.members.beta.data_ptr() == beta.data_ptr()
    assert torch.equal(scorer.members.beta, result.stacked.beta.flip(0))
    assert torch.equal(result.stacked.beta, original)


# ---------------------------------------------------------------------------
# The program-count budget (captured graphs on the card, shapes on the CPU)
# ---------------------------------------------------------------------------

def test_compile_once_per_bucket(workload):
    result, test = workload
    scorer = result.ensemble().bucketed_scorer(max_batch=8).warmup()
    n_buckets = len(scorer.ladder.buckets)
    assert scorer.compile_count() == n_buckets
    for n in range(1, 9):
        scorer.score_block(test.x[:n])
    assert scorer.compile_count() == n_buckets
    scorer.swap_members(stack_models(list(reversed(result.members))))
    for n in (1, 3, 5, 8):
        scorer.score_block(test.x[:n])
    assert scorer.assert_compile_budget() == n_buckets


def test_compile_count_without_warmup_lazy(workload):
    result, test = workload
    scorer = result.ensemble().bucketed_scorer(max_batch=8)
    assert scorer.compile_count() == 0
    scorer.score_block(test.x[:3])       # bucket 4
    scorer.score_block(test.x[:4])       # bucket 4 again — same program
    assert scorer.compile_count() == 1
    scorer.score_block(test.x[:5])       # bucket 8
    assert scorer.compile_count() == 2
    assert scorer.assert_compile_budget() == 2


def test_compile_budget_guard_raises_an_assertion_error(workload):
    result, _ = workload
    scorer = result.ensemble().bucketed_scorer(max_batch=2)
    scorer._shapes.update({1, 2, 3})     # a shape that escaped the ladder
    with pytest.raises(CompileBudgetExceeded, match="3 programs"):
        scorer.assert_compile_budget()
    assert issubclass(CompileBudgetExceeded, AssertionError)


# ---------------------------------------------------------------------------
# Scheduler: the SLO contract
# ---------------------------------------------------------------------------

@bounded(60)
def test_flush_on_max_batch(workload):
    result, test = workload
    scorer = result.ensemble().bucketed_scorer(max_batch=4)
    # max_wait far beyond the test's limit: only the max-batch trigger can
    # flush a FULL batch
    with EnsembleServer(scorer, ServeConfig(max_batch=4,
                                            max_wait_ms=60_000)) as srv:
        futs = srv.submit_many(test.x[:8])
        for f in futs:
            assert f.result(timeout=30).label >= 0
    stats = srv.stats()
    assert stats.completed == 8 and stats.failed == 0 and stats.dropped == 0
    assert [n for n, _ in srv._batches] == [4, 4]


@bounded(60)
def test_flush_on_slo_deadline(workload):
    result, test = workload
    scorer = result.ensemble().bucketed_scorer(max_batch=8)
    with EnsembleServer(scorer, ServeConfig(max_batch=8,
                                            max_wait_ms=30.0)) as srv:
        t0 = time.monotonic()
        futs = srv.submit_many(test.x[:3])       # never reaches max_batch
        res = [f.result(timeout=30) for f in futs]
        waited = time.monotonic() - t0
    assert waited >= 0.03
    assert [r.label for r in res] == \
        result.ensemble().predict(test.x[:3]).tolist()
    assert all(r.latency_s > 0 and r.member_scores.shape == (3, 10)
               for r in res)
    stats = srv.stats()
    assert stats.completed == 3 and stats.failed == 0


@bounded(120)
def test_served_answers_match_direct_scoring(workload):
    """Whatever batches the scheduler forms, every single-image answer
    equals direct scoring — its label and its member scores, bit for
    bit (a row scores the same bits in every bucket)."""
    result, test = workload
    ens = result.ensemble()
    expected = ens.predict(test.x)
    scorer = ens.bucketed_scorer(max_batch=8)
    direct = np.concatenate([scorer.score_block(test.x[i:i + 8])
                             for i in range(0, len(test.x), 8)], axis=1)
    with EnsembleServer(scorer, ServeConfig(max_batch=8,
                                            max_wait_ms=1.0)) as srv:
        futs = [srv.submit(img) for img in test.x]
        got = [f.result(timeout=60) for f in futs]
    assert np.array_equal([r.label for r in got], expected)
    np.testing.assert_array_equal(
        np.stack([r.member_scores for r in got], axis=1), direct)
    stats = srv.stats()
    assert stats.completed == len(test.x)
    assert stats.failed == 0 and stats.dropped == 0
    assert 1 <= stats.mean_occupancy <= 8
    assert stats.percentile_ms(50) <= stats.percentile_ms(99)
    scorer.assert_compile_budget()


@bounded(60)
def test_queue_depth_backpressure(workload):
    result, test = workload
    scorer = result.ensemble().bucketed_scorer(max_batch=4)
    srv = EnsembleServer(scorer, ServeConfig(max_batch=4, queue_depth=2))
    # worker not started: the queue fills at depth 2
    srv.submit(test.x[0])
    srv.submit(test.x[1])
    with pytest.raises(QueueFull):
        srv.submit(test.x[2])
    assert srv.stats().dropped == 1
    srv.start(warmup=False)
    srv.close()                                  # drains the 2 queued
    assert srv.stats().completed == 2
    with pytest.raises(RuntimeError, match="closed"):
        srv.submit(test.x[0])


@bounded(60)
def test_close_drains_everything(workload):
    result, test = workload
    scorer = result.ensemble().bucketed_scorer(max_batch=4)
    srv = EnsembleServer(scorer, ServeConfig(max_batch=4,
                                             max_wait_ms=50.0)).start()
    futs = srv.submit_many(test.x[:11])          # 2 full + 1 partial batch
    srv.close()
    assert all(f.result(timeout=10).label >= 0 for f in futs)
    assert srv.stats().completed == 11
    assert not srv._thread.is_alive()


@bounded(60)
def test_scoring_errors_answer_every_request(workload):
    """A scoring exception goes onto the batch's futures: nothing is
    dropped, and the failures are counted."""
    result, test = workload
    scorer = result.ensemble().bucketed_scorer(max_batch=4)

    def broken(x):
        raise RuntimeError("scoring failed")

    scorer.score_block = broken
    srv = EnsembleServer(scorer, ServeConfig(max_batch=4, max_wait_ms=1.0))
    srv.start(warmup=False)
    try:
        futs = srv.submit_many(test.x[:5])
        errors = [f.exception(timeout=30) for f in futs]
    finally:
        srv.close()
    assert all(isinstance(e, RuntimeError) for e in errors)
    stats = srv.stats()
    assert stats.failed == 5 and stats.completed == 0 and stats.dropped == 0


@pytest.mark.parametrize("kw", [dict(max_batch=0), dict(combine="product"),
                                dict(max_wait_ms=-1), dict(queue_depth=-1)])
def test_serve_config_validation(kw):
    with pytest.raises(ValueError):
        ServeConfig(**kw)
    with pytest.raises(ValueError):
        JServeConfig(**kw)


def test_server_refuses_a_batch_beyond_the_ladder(workload):
    result, _ = workload
    scorer = result.ensemble().bucketed_scorer(max_batch=4)
    with pytest.raises(ValueError, match="ladder"):
        EnsembleServer(scorer, ServeConfig(max_batch=8))
    assert ServeConfig() == ServeConfig(max_batch=32, max_wait_ms=5.0,
                                        combine="mean", queue_depth=0)
    assert dataclasses.asdict(ServeConfig()) == \
        dataclasses.asdict(JServeConfig())


# ---------------------------------------------------------------------------
# Open-loop load generation
# ---------------------------------------------------------------------------

@bounded(120)
def test_open_loop_report(workload):
    result, test = workload
    scorer = result.ensemble().bucketed_scorer(max_batch=8)
    with EnsembleServer(scorer, ServeConfig(max_batch=8,
                                            max_wait_ms=2.0)) as srv:
        rep = run_open_loop(srv, test.x, rate_per_s=300, n_requests=60,
                            seed=3)
        with pytest.raises(ValueError):
            run_open_loop(srv, test.x, rate_per_s=0, n_requests=1)
        with pytest.raises(ValueError):
            run_open_loop(srv, test.x, rate_per_s=10, n_requests=0)
    assert rep.submitted == rep.completed == 60 and rep.failed == 0
    assert rep.p50_ms <= rep.p95_ms <= rep.p99_ms <= rep.max_ms
    assert rep.achieved_per_s > 0 and rep.duration_s > 0
    # the copy reports what the reference's LoadReport reports
    assert [f.name for f in dataclasses.fields(LoadReport)] == \
        [f.name for f in dataclasses.fields(JLoadReport)]
    assert set(rep.to_json()) == {f.name for f in
                                  dataclasses.fields(JLoadReport)}
    assert srv.stats().completed == 60


# ---------------------------------------------------------------------------
# Checkpoint hot-reload: zero drops, bit-equal post-swap
# ---------------------------------------------------------------------------

def _training_run():
    cfg = replace(CFG, elm_lambda=1.0)
    ds = make_extended_mnist(n_per_class=25, seed=0)
    train, test = ds.split(n_test=40)
    parts = partition_iid(train.x, train.y, 3)
    run = AveragingRun(
        cfg,
        MapConfig(epochs=2, lr_schedule=dynamic_paper(0.05), batch_size=50),
        ReduceConfig(rounds=2))
    return cfg, run, parts, test


@bounded(240)
def test_hot_reload_swaps_with_zero_drops(tmp_path):
    """Serve round 0 of a checkpointed run while the run resumes and writes
    round 1: the watcher swaps the weights mid-traffic with zero failed or
    dropped requests and no new program, and post-swap answers equal
    scoring the new checkpoint directly, bit for bit."""
    cfg, run, parts, test = _training_run()
    d = str(tmp_path)

    def gen():
        return torch.Generator().manual_seed(0)

    assert faults.run_to_crash(run, parts, d, unit="round", index=0,
                               generator=gen(), device="cpu")
    scorer = BucketedScorer(cfg, run_state.restore_round(d, 0, "cpu").members,
                            max_batch=8, device="cpu")
    srv = EnsembleServer(scorer, ServeConfig(max_batch=8,
                                             max_wait_ms=2.0)).start()
    watcher = CheckpointWatcher(d, srv, poll_ms=10, start_round=0).start()
    stop = threading.Event()
    futs = []

    def traffic():
        i = 0
        while not stop.is_set():
            futs.append(srv.submit(test.x[i % len(test.x)]))
            i += 1
            time.sleep(0.002)

    th = threading.Thread(target=traffic)
    th.start()
    try:
        run.resume(parts, d, generator=gen(), device="cpu")   # round 1
        assert watcher.wait_for_round(1, timeout_s=60)
        time.sleep(0.05)
    finally:
        stop.set()
        th.join(timeout=30)
    assert not th.is_alive()
    probe = test.x[:7]
    post = np.stack([f.result(timeout=30).member_scores
                     for f in [srv.submit(img) for img in probe]], axis=1)
    srv.close()
    watcher.stop()
    direct = BucketedScorer(cfg, run_state.restore_round(d, 1, "cpu").members,
                            max_batch=8, device="cpu").score_block(probe)
    np.testing.assert_array_equal(post, direct)
    assert all(f.exception(timeout=10) is None for f in futs)
    stats = srv.stats()
    assert stats.failed == 0 and stats.dropped == 0
    assert stats.swaps == 1 and watcher.rejected == []
    assert [s.round for s in watcher.swaps] == [1]
    scorer.assert_compile_budget()


@bounded(240)
def test_watcher_skips_torn_checkpoint_then_swaps(tmp_path):
    """A torn round-<r>.npz must neither crash nor swap the endpoint; the
    complete save that replaces it must swap."""
    cfg, run, parts, test = _training_run()
    d = str(tmp_path)

    def gen():
        return torch.Generator().manual_seed(0)

    assert faults.run_to_crash(run, parts, d, unit="round", index=0,
                               generator=gen(), device="cpu")
    scorer = BucketedScorer(cfg, run_state.restore_round(d, 0, "cpu").members,
                            max_batch=4, device="cpu")
    srv = EnsembleServer(scorer, ServeConfig(max_batch=4,
                                             max_wait_ms=1.0)).start()
    try:
        watcher = CheckpointWatcher(d, srv, poll_ms=5, start_round=0)
        faults.inject_torn_save(d, "round", 1, crash=False)
        assert watcher.poll_once() is None       # torn: skipped, no swap
        assert watcher.current_round == 0
        assert srv.submit(test.x[0]).result(10).label >= 0
        run.resume(parts, d, generator=gen(), device="cpu")
        assert watcher.poll_once() == 1
        assert watcher.current_round == 1
    finally:
        srv.close()
    assert srv.stats().failed == 0
    with pytest.raises(ValueError, match="poll_ms"):
        CheckpointWatcher(d, srv, poll_ms=0)


@bounded(120)
def test_watcher_records_an_incompatible_round(workload, tmp_path):
    """A round whose members cannot be served (another k) is rejected and
    recorded, and the endpoint keeps its weights."""
    result, test = workload
    d = str(tmp_path)
    scorer = BucketedScorer(CFG, result.stacked, max_batch=4, device="cpu")
    two = stack_models(result.stacked.unstack()[:2])
    run_state.save_round(d, 3, members=two, stats=result.stats,
                         averaged=result.averaged,
                         meta={"round": 3, "final": False})
    with EnsembleServer(scorer, ServeConfig(max_batch=4)) as srv:
        watcher = CheckpointWatcher(d, srv, poll_ms=5)
        assert watcher.poll_once() is None
        assert watcher.rejected == [3] and watcher.current_round == -1
        assert watcher.poll_once() is None and watcher.rejected == [3]
    assert torch.equal(scorer.members.beta, result.stacked.beta)


# ---------------------------------------------------------------------------
# The launcher's --ensemble endpoint
# ---------------------------------------------------------------------------

@bounded(240)
def test_launch_serve_ensemble_end_to_end(tmp_path, monkeypatch):
    """``launch.serve --ensemble --device cpu --reduced``: a freshly trained
    k-member run served under open-loop load, then a checkpoint directory
    served with hot reload on; every request answered. Without
    ``--device cpu`` it needs a card."""
    out = launch_serve.main(["--ensemble", "--reduced", "--device", "cpu",
                             "--k", "3", "--rate", "400", "--requests", "40",
                             "--max-batch", "8"])
    assert out["failed"] == 0 and out["dropped"] == 0
    assert out["completed"] == 40 and out["device"] == "cpu"
    assert 1 <= out["compile_count"] <= 4 and out["swaps"] == 0
    cfg, run, parts, _ = _training_run()
    run.run(parts, generator=torch.Generator().manual_seed(0), device="cpu",
            checkpoint=CheckpointConfig(dir=str(tmp_path)))
    out = launch_serve.main(["--ensemble", "--reduced", "--device", "cpu",
                             "--ckpt-dir", str(tmp_path), "--rate", "400",
                             "--requests", "20", "--max-batch", "8"])
    assert out["failed"] == 0 and out["completed"] == 20
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        launch_serve.main(["--ensemble", "--reduced"])
