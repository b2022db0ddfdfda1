"""The hand-written CUDA kernels on the card, held against their plain
PyTorch versions on the same inputs: f32 at rtol 1e-5, atol 1e-5 · max|ref|;
bf16 outputs (both sides compute in f32 and round once) at one bf16 ulp,
rtol 2⁻⁷, with atol 1e-5 · max|ref| for outputs that cancel to near zero.

Every test here is marked ``cuda`` and skips where there is no CUDA
device. This file imports neither JAX nor the reference package, so it
runs on a machine that has only the port's dependencies:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from repro_torch import kernels
from repro_torch.configs import get_reduced_config, replace
from repro_torch.core.runner import AveragingRun, MapConfig
from repro_torch.data.partition import partition_iid, partition_unequal
from repro_torch.data.synthetic import make_extended_mnist
from repro_torch.kernels.conv2d import ops as conv_ops, ref as conv_ref
from repro_torch.kernels.elm_stats import ops as stats_ops, ref as stats_ref
from repro_torch.kernels.rmsnorm import ops as rms_ops, ref as rms_ref
from repro_torch.kernels.swa_attention import ops as swa_ops, ref as swa_ref
from repro_torch.models import api
from repro_torch.tree import tree_map

# the reference's threaded tests share the CPU with these workers
torch.set_num_threads(2)


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


ELM_SHAPES = [(4, 200, 192, 10), (1, 137, 144, 20), (3, 17, 7, 2),
              (2, 64, 64, 10),
              (2, 50, 40, 3),            # L 40: a ragged 32-wide tile
              (2, 33, 24, 1),            # C 1
              (3, 1, 16, 4),             # one row
              (2, 12_500, 192, 10)]      # a whole shard of the Map


@pytest.mark.cuda
@pytest.mark.parametrize("mask_kind", [None, "binary", "fractional",
                                       "zero_rows"])
@pytest.mark.parametrize("k,n,L,C", ELM_SHAPES)
def test_elm_stats_kernel_matches_plain_on_card(cuda, k, n, L, C, mask_kind):
    h, t = _data(n + L, (k, n, L), (k, n, C))
    if mask_kind == "zero_rows":    # padded shards: the last rows weigh 0
        m = np.tile((np.arange(n) < n - n // 3).astype(np.float32), (k, 1))
    else:
        m = (None if mask_kind is None else
             _mask(mask_kind, k * n, n).reshape(k, n))
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
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("k,n,L,C", ELM_SHAPES)
def test_elm_stats_u_is_symmetric_and_deterministic_on_card(cuda, k, n, L, C,
                                                            masked):
    """U is computed once per pair and written to both halves, so it equals
    its transpose bitwise; every output sums its rows in order, without
    atomics, so two launches agree bitwise."""
    h, t = _data(n + L + 1, (k, n, L), (k, n, C))
    hd, td = torch.from_numpy(h).to(cuda), torch.from_numpy(t).to(cuda)
    md = (torch.from_numpy(_mask("fractional", k * n, n).reshape(k, n)
                           ).to(cuda) if masked else None)
    u, v = stats_ops.elm_stats(hd, td, mask=md)
    u2, v2 = stats_ops.elm_stats(hd, td, mask=md)
    torch.cuda.synchronize()
    assert torch.equal(u, u.transpose(1, 2))
    assert torch.equal(u, u2) and torch.equal(v, v2)


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


def _dt(name):
    return {"f32": torch.float32, "bf16": torch.bfloat16}[name]


@pytest.mark.cuda
@pytest.mark.parametrize("x_dt,s_dt", [("f32", "f32"), ("bf16", "f32"),
                                       ("bf16", "bf16"), ("f32", "bf16")])
@pytest.mark.parametrize("shape", [(512, 4096), (16384, 128), (3, 17, 128),
                                   (1, 96), (5, 3000)])
def test_rmsnorm_kernel_matches_plain_on_card(cuda, shape, x_dt, s_dt):
    x, s = _data(sum(shape), shape, shape[-1:])
    xd = (torch.from_numpy(x) * 3).to(cuda, _dt(x_dt))
    sd = torch.from_numpy(s).to(cuda, _dt(s_dt))
    before = kernels.LAUNCHES["rmsnorm"]
    got = rms_ops.rmsnorm(xd, sd, eps=1e-6)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["rmsnorm"] == before + 1
    ref = rms_ref.rmsnorm_ref(xd, sd, 1e-6)
    assert got.dtype == xd.dtype
    if x_dt == "bf16":
        np.testing.assert_allclose(got.float().cpu().numpy(),
                                   ref.float().cpu().numpy(), rtol=2.0 ** -7,
                                   atol=1e-5 * float(ref.abs().max()))
    else:
        _close(got.cpu().numpy(), ref.cpu().numpy())


@pytest.mark.cuda
@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("B,S,H,KV,hd,window", [
    (4, 128, 32, 8, 128, 128),     # the serving path's prefill
    (1, 1024, 32, 8, 128, 256),    # windowed
    (2, 37, 4, 2, 64, 37),         # ragged
    (2, 200, 4, 1, 64, 33),        # ragged, windowed, 4 heads per kv head
    (1, 70, 2, 2, 16, 8),
    (3, 1, 2, 1, 32, 1),
    (2, 64, 4, 2, 40, 64),         # hd 40 and 72: zero-padded to 48, 80
    (2, 64, 4, 2, 72, 64),
    (2, 15, 4, 2, 64, 15),         # S 15 and 65: ragged 64-row tiles
    (2, 65, 4, 2, 64, 65),
    (1, 200, 4, 2, 64, 1),         # window 1: the diagonal alone
    (1, 200, 4, 2, 64, 17),        # window 17: inside a tile, and across two
    (2, 96, 8, 1, 128, 96),        # G = 8: eight query heads per kv head
    (1, 50, 2, 1, 20, 50)])        # hd 20: rows staged 2 bytes at a time
def test_swa_kernel_matches_plain_on_card(cuda, dt, B, S, H, KV, hd, window):
    q, k, v = _data(S + window, (B, S, H, hd), (B, S, KV, hd),
                    (B, S, KV, hd))
    qd, kd, vd = (torch.from_numpy(a).to(cuda, _dt(dt)) for a in (q, k, v))
    before = kernels.LAUNCHES["swa_attention"]
    got = swa_ops.swa_attention(qd, kd, vd, window=window)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["swa_attention"] == before + 1
    ref = swa_ref.swa_attention_ref(qd, kd, vd, window=window)
    assert got.dtype == qd.dtype
    if dt == "bf16":
        np.testing.assert_allclose(got.float().cpu().numpy(),
                                   ref.float().cpu().numpy(), rtol=2.0 ** -7,
                                   atol=1e-5 * float(ref.abs().max()))
    else:
        _close(got.cpu().numpy(), ref.cpu().numpy())


@pytest.mark.cuda
@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("window", [128, 40])
def test_swa_kernel_large_scores_on_card(cuda, dt, window):
    """q scaled by 8: scores of large magnitude stress the online rescale
    (alpha far from 1) and, in bf16, the hi/lo split of p."""
    q, k, v = _data(7, (2, 128, 8, 128), (2, 128, 2, 128), (2, 128, 2, 128))
    qd, kd, vd = (torch.from_numpy(a).to(cuda, _dt(dt))
                  for a in (q * 8, k, v))
    got = swa_ops.swa_attention(qd, kd, vd, window=window)
    ref = swa_ref.swa_attention_ref(qd, kd, vd, window=window)
    torch.cuda.synchronize()
    if dt == "bf16":
        np.testing.assert_allclose(got.float().cpu().numpy(),
                                   ref.float().cpu().numpy(), rtol=2.0 ** -7,
                                   atol=1e-5 * float(ref.abs().max()))
    else:
        _close(got.cpu().numpy(), ref.cpu().numpy())


@pytest.mark.cuda
def test_lm_kernels_refuse_bad_operands_on_card(cuda):
    with pytest.raises(TypeError):
        rms_ops.rmsnorm(torch.zeros((4, 8), device=cuda, dtype=torch.float16),
                        torch.ones(8, device=cuda))
    with pytest.raises(ValueError):
        rms_ops.rmsnorm(torch.zeros((4, 8), device=cuda),
                        torch.ones(16, device=cuda)[::2])
    q = torch.zeros((1, 8, 2, 256), device=cuda)
    k = torch.zeros((1, 8, 1, 256), device=cuda)
    with pytest.raises(ValueError, match="head_dim"):
        swa_ops.swa_attention(q, k, k, window=8)
    q = torch.zeros((1, 8, 4, 16), device=cuda)
    k = torch.zeros((1, 2, 8, 16), device=cuda).transpose(1, 2)
    with pytest.raises(ValueError, match="contiguous"):
        swa_ops.swa_attention(q, k, k, window=8)
    with pytest.raises(TypeError):
        swa_ops.swa_attention(q.bfloat16(), k.contiguous(), k.contiguous(),
                              window=8)


@pytest.mark.cuda
@pytest.mark.parametrize("window", [0, 8])
def test_lm_serving_on_card_matches_cpu(cuda, window):
    """Reduced qwen3_8b, f32: prefill and three decode steps on the card
    through the kernels equal the port's CPU path (1e-4 · max|logit|)."""
    cfg = replace(get_reduced_config("qwen3_8b"), sliding_window=window)
    params = api.init_params(cfg, torch.Generator().manual_seed(0),
                             torch.float32, device="cpu")
    on_card = tree_map(lambda a: a.to(cuda), params)
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 19)))
    kernels.reset_launches()
    lg_c, cache_c = api.prefill(cfg, on_card,
                                {"tokens": toks[:, :16].to(cuda)}, max_len=20)
    lg_p, cache_p = api.prefill(cfg, params, {"tokens": toks[:, :16]},
                                max_len=20)
    outs = [(lg_c, lg_p)]
    for pos in (16, 17, 18):
        tok = toks[:, pos:pos + 1]
        lg_c, cache_c = api.decode_step(cfg, on_card, cache_c, tok.to(cuda),
                                        pos)
        lg_p, cache_p = api.decode_step(cfg, params, cache_p, tok, pos)
        outs.append((lg_c, lg_p))
    assert kernels.LAUNCHES["swa_attention"] == cfg.num_layers
    assert kernels.LAUNCHES["rmsnorm"] == 4 * (4 * cfg.num_layers + 1)
    for c, p in outs:
        c, p = c.cpu().numpy(), p.numpy()
        assert np.abs(c - p).max() <= 1e-4 * np.abs(p).max()
        assert np.array_equal(c.argmax(-1), p.argmax(-1))
