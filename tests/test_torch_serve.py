"""The port's serving layer: the bucket ladder copy, bucketed scoring
against the ensemble surface, the padding contract, the vote tie rule and
hot-swap validation. Scores are compared exactly where the two sides run
the same program on the same rows on the same device."""
import numpy as np
import pytest
import torch

from repro.serve.bucketing import BucketLadder as JLadder
from repro_torch.configs import get_reduced_config
from repro_torch.core.cnn_elm import StackedMembers, stack_models
from repro_torch.core.runner import AveragingRun, Ensemble, MapConfig
from repro_torch.data.partition import partition_iid
from repro_torch.data.synthetic import make_extended_mnist
from repro_torch.serve import (BucketLadder, BucketedScorer, SwapRejected,
                               combine_block)

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
