"""The hand-written CUDA kernels on the card, held against their plain
PyTorch versions on the same inputs (rtol 1e-5, atol 1e-5 · max|ref|).

Every test here is marked ``cuda`` and skips where there is no CUDA
device. This file imports neither JAX nor the reference package, so it
runs on a machine that has only the port's dependencies:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from repro_torch import kernels
from repro_torch.configs import get_reduced_config
from repro_torch.core.runner import AveragingRun, MapConfig
from repro_torch.data.partition import partition_iid, partition_unequal
from repro_torch.data.synthetic import make_extended_mnist
from repro_torch.kernels.conv2d import ops as conv_ops, ref as conv_ref
from repro_torch.kernels.elm_stats import ops as stats_ops, ref as stats_ref


def _close(got, ref):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=1e-5,
                               atol=1e-5 * float(np.abs(ref).max()))


def _data(seed, *shapes):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=s).astype(np.float32) for s in shapes]


def _mask(kind, n, seed):
    rng = np.random.default_rng(seed)
    if kind == "binary":
        return (rng.random(n) > 0.4).astype(np.float32)
    return rng.random(n).astype(np.float32)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the hand kernels run only on the card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("k,b,h,w,cin,kk,cout", [
    (4, 200, 28, 28, 1, 5, 6), (4, 200, 12, 12, 6, 5, 12),
    (1, 3, 9, 9, 3, 5, 9), (3, 7, 12, 12, 2, 5, 4)])
def test_conv2d_kernel_matches_plain_on_card(cuda, k, b, h, w, cin, kk, cout):
    x, wt = _data(k * b, (k, b, h, w, cin), (k, kk, kk, cin, cout))
    xd, wd = torch.from_numpy(x).to(cuda), torch.from_numpy(wt).to(cuda)
    before = kernels.LAUNCHES["conv2d"]
    got = conv_ops.conv2d_valid(xd, wd)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["conv2d"] == before + 1
    _close(got.cpu().numpy(), conv_ref.conv2d_valid_ref(xd, wd).cpu().numpy())


@pytest.mark.cuda
@pytest.mark.parametrize("mask_kind", [None, "binary", "fractional"])
@pytest.mark.parametrize("k,n,L,C", [(4, 200, 192, 10), (1, 137, 144, 20),
                                     (3, 17, 7, 2), (2, 64, 64, 10)])
def test_elm_stats_kernel_matches_plain_on_card(cuda, k, n, L, C, mask_kind):
    h, t = _data(n + L, (k, n, L), (k, n, C))
    m = None if mask_kind is None else _mask(mask_kind, k * n, n).reshape(k, n)
    hd, td = torch.from_numpy(h).to(cuda), torch.from_numpy(t).to(cuda)
    md = None if m is None else torch.from_numpy(m).to(cuda)
    before = kernels.LAUNCHES["elm_stats"]
    u, v = stats_ops.elm_stats(hd, td, mask=md)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["elm_stats"] == before + 1
    ref = stats_ref.elm_stats_ref(hd, td, md).cpu().numpy()
    _close(u.cpu().numpy(), ref[..., :L])
    _close(v.cpu().numpy(), ref[..., L:])


@pytest.mark.cuda
def test_kernels_refuse_non_contiguous_on_card(cuda):
    x = torch.zeros((1, 2, 8, 8, 4), device=cuda)
    w = torch.zeros((1, 3, 3, 2, 4), device=cuda).transpose(3, 4)
    assert not w.is_contiguous()
    with pytest.raises(ValueError, match="contiguous"):
        conv_ops.conv2d_valid(x, w)
    h = torch.zeros((1, 4, 10), device=cuda).transpose(1, 2)
    with pytest.raises(ValueError, match="contiguous"):
        stats_ops.elm_stats(h, torch.zeros((1, 10, 2), device=cuda))


@pytest.mark.cuda
@pytest.mark.parametrize("backend", ["stacked", "sequential"])
@pytest.mark.parametrize("split", ["iid", "unequal"])
def test_map_on_card_matches_cpu(cuda, backend, split):
    """The epochs=0 Map → Reduce through the kernels equals the plain CPU
    path (β within 1e-3 · max|β|, scores within 1e-4 · max|score|)."""
    cfg = get_reduced_config("cnn_elm_6c12c")
    ds = make_extended_mnist(n_per_class=30, seed=0)
    train, test = ds.split(n_test=100)
    parts = (partition_iid(train.x, train.y, 3) if split == "iid" else
             partition_unequal(train.x, train.y, (500, 300, 180)))
    run = AveragingRun(cfg, MapConfig(batch_size=50, backend=backend))
    gen_seed = 7
    kernels.reset_launches()
    card = run.run(parts, generator=torch.Generator().manual_seed(gen_seed),
                   device=cuda)
    assert kernels.LAUNCHES["conv2d"] > 0 and kernels.LAUNCHES["elm_stats"] > 0
    cpu = run.run(parts, generator=torch.Generator().manual_seed(gen_seed),
                  device="cpu")
    bc, bp = card.stacked.beta.cpu().numpy(), cpu.stacked.beta.numpy()
    assert np.abs(bc - bp).max() <= 1e-3 * np.abs(bp).max()
    sc = card.ensemble().member_scores(test.x)
    sp = cpu.ensemble().member_scores(test.x)
    assert np.abs(sc - sp).max() <= 1e-4 * np.abs(sp).max()
