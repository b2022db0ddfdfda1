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
from repro_torch.tree import tree_leaves, tree_map

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
    (1, 3, 9, 9, 3, 5, 9), (3, 7, 12, 12, 2, 5, 4),
    (4, 200, 28, 28, 1, 5, 3), (4, 200, 12, 12, 3, 5, 9),   # 3c-9c
    (4, 200, 28, 28, 1, 5, 2), (4, 200, 12, 12, 2, 5, 4),   # reduced
    (1, 200, 28, 28, 1, 5, 6), (1, 200, 12, 12, 6, 5, 12),  # sequential Map
    (4, 1, 28, 28, 1, 5, 6), (4, 1, 12, 12, 6, 5, 12),      # one image
    (4, 199, 12, 12, 6, 5, 12),    # 199 images: a ragged last image tile
    (4, 1, 27, 28, 1, 5, 6),       # OH 23: a ragged last row band
    (2, 600, 13, 13, 1, 5, 6),     # OW 9: a ragged group of 4 pixels
    (2, 3, 10, 11, 2, 3, 5),       # generic: a 3x3 kernel
    (1, 1, 30, 300, 40, 3, 2),     # generic, over 48 KB of shared memory
    (1, 2, 40, 700, 16, 5, 3)])    # generic, rows cut into column bands
def test_conv2d_kernel_matches_plain_on_card(cuda, k, b, h, w, cin, kk, cout):
    x, wt = _data(k * b, (k, b, h, w, cin), (k, kk, kk, cin, cout))
    xd, wd = torch.from_numpy(x).to(cuda), torch.from_numpy(wt).to(cuda)
    before = kernels.LAUNCHES["conv2d"]
    got = conv_ops.conv2d_valid(xd, wd)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["conv2d"] == before + 1
    _close(got.cpu().numpy(), conv_ref.conv2d_valid_ref(xd, wd).cpu().numpy())


@pytest.mark.cuda
@pytest.mark.parametrize("h,cin,cout", [(28, 1, 6), (12, 6, 12), (28, 1, 3),
                                        (12, 3, 9)])
def test_conv2d_member_batched_equals_one_member_launches_on_card(
        cuda, h, cin, cout):
    """Every output is one fmaf chain over its patch in (kh, kw, Cin) order,
    whatever the tiling: the Map's member-batched launch, k one-member
    launches and a one-image launch (each tiled differently) agree
    bitwise."""
    k, b = 4, 200
    x, wt = _data(h + cout, (k, b, h, h, cin), (k, 5, 5, cin, cout))
    xd, wd = torch.from_numpy(x).to(cuda), torch.from_numpy(wt).to(cuda)
    batched = conv_ops.conv2d_valid(xd, wd)
    for i in range(k):
        assert torch.equal(batched[i], conv_ops.conv2d_valid(xd[i], wd[i]))
    assert torch.equal(batched[:, :1],
                       conv_ops.conv2d_valid(xd[:, :1].contiguous(), wd))


ELM_SHAPES = [(4, 200, 192, 10), (1, 137, 144, 20), (3, 17, 7, 2),
              (2, 64, 64, 10),
              (2, 50, 40, 3),            # L 40: a ragged 32-wide tile
              (2, 33, 24, 1),            # C 1
              (3, 1, 16, 4),             # one row
              (2, 12_500, 192, 10),      # a whole shard of the Map
              (1, 512, 4096, 16),        # the LM head: B 4 × S 128, d 4096
              (1, 4096, 1280, 6),        # the HuBERT-XLarge head
              (1, 512, 2560, 16),        # the RWKV6-3B head
              (1, 300, 1281, 5)]         # wide tiles by cp.async (L % 4)
# E²LM shards of 200,000 rows (k 1, 2, 4 and 8) and another split of
# rows: sums too long for the 1e-5 bar
LONG_SHAPES = [(2, 100_000, 192, 10), (1, 200_000, 192, 10),
               (4, 50_000, 192, 10), (8, 25_000, 192, 10),
               (2, 50_000, 150, 7)]       # the strip by cp.async (L % 4)


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
    assert kernels.LAUNCHES["elm_stats"] == \
        before + stats_ops._plan(k, n, L, C).passes
    ref = stats_ref.elm_stats_ref(hd, td, md).cpu().numpy()
    _close(u.cpu().numpy(), ref[..., :L])
    _close(v.cpu().numpy(), ref[..., L:])


def _f64_stats(h, t, m, absolute=False):
    out = []
    for i in range(h.shape[0]):
        hi, ti = h[i].double(), t[i].double()
        if absolute:
            hi, ti = hi.abs(), ti.abs()
        hm = hi if m is None else hi * m[i].double()[:, None]
        out.append(hm.T @ torch.cat([hi, ti], dim=1))
    return torch.stack(out)


@pytest.mark.cuda
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("k,n,L,C", LONG_SHAPES)
def test_elm_stats_long_shards_match_f64_on_card(cuda, k, n, L, C, masked):
    """Each output is one f32 sum over the n rows in order; over 100,000 or
    more rows its rounding outgrows the 1e-5 bar against the plain
    version's blocked sums, so it is held against the f64 function within
    the probabilistic bound of an f32 sum of n terms in order,
    7·√n·2⁻²⁴·Σ|terms| per output (Higham and Mary, λ = 7)."""
    h, t = _data(n + L, (k, n, L), (k, n, C))
    hd, td = torch.from_numpy(h).to(cuda), torch.from_numpy(t).to(cuda)
    md = (torch.from_numpy(_mask("fractional", k * n, n).reshape(k, n)
                           ).to(cuda) if masked else None)
    u, v = stats_ops.elm_stats(hd, td, mask=md)
    got = torch.cat([u, v], dim=-1).double()
    bound = 7 * n ** 0.5 * 2.0 ** -24 * _f64_stats(hd, td, md, True)
    assert bool(((got - _f64_stats(hd, td, md)).abs() <= bound).all())


@pytest.mark.cuda
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("k,n,L,C", ELM_SHAPES + LONG_SHAPES)
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
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("n,L,C", [(50_000, 192, 10), (200, 192, 10)])
def test_elm_stats_member_block_is_the_same_bits_whatever_k_on_card(
        cuda, n, L, C, masked):
    """The plan depends on (n, L, C) alone, and a split's chunks are added
    in a fixed order: a member's block from a launch of 4 members is
    bitwise its block from a launch of its own, split (n 50,000) or not
    (the Map's batch)."""
    k = 4
    h, t = _data(n + L + 2, (k, n, L), (k, n, C))
    hd, td = torch.from_numpy(h).to(cuda), torch.from_numpy(t).to(cuda)
    md = (torch.from_numpy(_mask("fractional", k * n, n).reshape(k, n)
                           ).to(cuda) if masked else None)
    u, v = stats_ops.elm_stats(hd, td, mask=md)
    for i in range(k):
        ui, vi = stats_ops.elm_stats(
            hd[i:i + 1].contiguous(), td[i:i + 1].contiguous(),
            mask=None if md is None else md[i:i + 1].contiguous())
        assert torch.equal(ui[0], u[i]) and torch.equal(vi[0], v[i])


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


# the LM zoo's causal heads at the prefill (B 4, S 128): OLMoE-1B-7B (G
# 1), MiniCPM-2B (hd 64), Qwen3-MoE (G 16), Qwen3-32B; one 4,096-token
# sequence of Qwen3-8B (the reference's train_4k shape, W = S) and a
# ragged long windowed one; then the wgmma kernels' causal walk: a
# 128-query block whose second warpgroup holds no row < S (S 129), a
# window whose first key tile differs between a block's warpgroups, and
# 64-key dK/dV blocks whose walks end mid-tile
SWA_ZOO_SHAPES = [
    (4, 128, 16, 16, 128, 128),
    (4, 128, 36, 36, 64, 128),
    (4, 128, 64, 4, 128, 128),
    (4, 128, 64, 8, 128, 128),
    (1, 4096, 32, 8, 128, 4096),
    (1, 4000, 32, 8, 128, 1000),
    (1, 129, 4, 2, 80, 129),
    (2, 320, 4, 2, 64, 70),
    (1, 300, 8, 2, 96, 100)]


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
    (1, 50, 2, 1, 20, 50)] + SWA_ZOO_SHAPES)   # hd 20: 2-byte staging
def test_swa_kernel_matches_plain_on_card(cuda, dt, B, S, H, KV, hd, window):
    """The forward against the plain version, one launch a call, bitwise
    the same on a second call."""
    q, k, v = _data(S + window, (B, S, H, hd), (B, S, KV, hd),
                    (B, S, KV, hd))
    qd, kd, vd = (torch.from_numpy(a).to(cuda, _dt(dt)) for a in (q, k, v))
    before = kernels.LAUNCHES["swa_attention"]
    got = swa_ops.swa_attention(qd, kd, vd, window=window)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["swa_attention"] == before + 1
    assert torch.equal(got, swa_ops.swa_attention(qd, kd, vd, window=window))
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
@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("B,S,H,KV,hd", [
    (2, 64, 4, 4, 64),             # one whole key tile
    (2, 100, 4, 4, 80),            # hd 80 (HuBERT's), a ragged last tile
    (1, 1000, 16, 16, 80),         # HuBERT's heads, S 1000: ragged tail
    (2, 65, 8, 2, 128),            # GQA, one key past a tile
    (1, 15, 4, 1, 64),             # under one tile
    (2, 1, 2, 2, 32),              # a single key
    (1, 50, 2, 1, 20),             # hd 20: rows staged 2 bytes at a time
    (1, 130, 4, 2, 72),            # hd 72: zero-padded to 80
    # the wgmma kernel's edges: 128-query blocks of two 64-row warpgroup
    # tiles, 64-key tiles; hd 96 and 112 (6 and 7 pieces of 16 columns)
    (1, 127, 4, 2, 80), (2, 128, 4, 4, 64), (1, 129, 4, 2, 80),
    (1, 1, 4, 2, 80),
    (1, 200, 4, 2, 96), (1, 200, 4, 2, 112),
    (4, 1024, 16, 16, 80)])        # HuBERT's grid: B·H = 64 at S 1024
def test_swa_non_causal_kernel_matches_plain_on_card(cuda, dt, B, S, H, KV,
                                                     hd):
    """The non-causal mode (the encoder's attention over every key)
    against ``swa_attention_ref(causal=False)``; the ragged tail kj >= S
    of the last key tile is masked, or its zero rows would take weight."""
    q, k, v = _data(S + hd, (B, S, H, hd), (B, S, KV, hd), (B, S, KV, hd))
    qd, kd, vd = (torch.from_numpy(a).to(cuda, _dt(dt)) for a in (q, k, v))
    before = kernels.LAUNCHES["swa_attention"]
    got = swa_ops.swa_attention(qd, kd, vd, window=S, causal=False)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["swa_attention"] == before + 1
    ref = swa_ref.swa_attention_ref(qd, kd, vd, window=S, causal=False)
    assert got.dtype == qd.dtype
    if dt == "bf16":
        np.testing.assert_allclose(got.float().cpu().numpy(),
                                   ref.float().cpu().numpy(), rtol=2.0 ** -7,
                                   atol=1e-5 * float(ref.abs().max()))
    else:
        _close(got.cpu().numpy(), ref.cpu().numpy())
    assert torch.equal(got, swa_ops.swa_attention(qd, kd, vd, window=S,
                                                  causal=False))


@pytest.mark.cuda
@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("B,S,H,KV,hd", [
    (4, 1024, 16, 16, 80),         # HuBERT-XLarge's encoder
    (1, 1000, 4, 4, 80),           # ragged last tile
    (2, 200, 4, 2, 80),            # GQA, ragged
    (2, 37, 4, 2, 64), (1, 33, 4, 2, 20), (3, 1, 2, 1, 32),
    (2, 130, 8, 1, 128),
    # the wgmma kernels' edges: 128-key dK/dV and 128-query dQ blocks of
    # two 64-row warpgroup tiles over 64-row tiles; hd 96 and 112
    (1, 127, 4, 2, 80), (2, 128, 4, 4, 64), (1, 129, 4, 2, 80),
    (1, 1, 4, 2, 80),
    (1, 200, 4, 2, 96), (1, 200, 4, 2, 112)])
def test_swa_non_causal_bwd_matches_plain_on_card(cuda, dt, B, S, H, KV, hd):
    """The non-causal mode under autograd: one forward launch with its
    log-sum-exp (against the plain one) and one ``swa_attention_bwd``
    launch, whose dq, dk, dv hold against the plain non-causal backward
    within ``_grad_close``'s bars (the f64 truth and the f32 rounding of
    each element's sums), bitwise run to run; keys and query rows past S in
    the ragged last tile add nothing."""
    q, k, v, do = _swa_inputs(cuda, dt, B, S, H, KV, hd, seed=11)
    out, lse = swa_ops.swa_attention_fwd(q, k, v, window=S, causal=False)
    ref_lse = swa_ref.swa_attention_lse_ref(q, k, window=S, causal=False)
    np.testing.assert_allclose(lse.cpu().numpy(), ref_lse.cpu().numpy(),
                               rtol=1e-5, atol=1e-5)
    leaves = [a.clone().requires_grad_(True) for a in (q, k, v)]
    fwd = kernels.LAUNCHES["swa_attention"]
    bwd = kernels.LAUNCHES["swa_attention_bwd"]
    y = swa_ops.swa_attention(*leaves, window=S, causal=False)
    got = torch.autograd.grad(y, leaves, do)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["swa_attention"] == fwd + 1
    assert kernels.LAUNCHES["swa_attention_bwd"] == bwd + 1
    assert torch.equal(y.detach(), out)
    ref = swa_ref.swa_attention_bwd_ref(q, k, v, out, lse, do, window=S,
                                        causal=False)
    truth = swa_ref.swa_attention_bwd_ref(
        *(a.double() for a in (q, k, v, out, lse, do)), window=S,
        causal=False)
    terms = _swa_bwd_terms(q, k, v, out, lse, do, S, causal=False)
    for g, r, t, m in zip(got, ref, truth, terms):
        _grad_close(g, r, t, m)
    again = swa_ops.swa_attention_bwd(q, k, v, out, lse, do, window=S,
                                      causal=False)
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    with pytest.raises(ValueError, match="window must be S"):
        swa_ops.swa_attention_bwd(q, k, v, out, lse, do, window=8,
                                  causal=False)


@pytest.mark.cuda
@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_moe_apply_is_bitwise_run_to_run_on_card(cuda, dt):
    """The MoE layer on the card: the same bits run after run (gathers, no
    scatter-add), f32 within 1e-4 · max|y| of the CPU's, and R6's
    overflow (8 identical tokens on 2 experts of C = 2 slots) zeroes token
    0 as on the CPU."""
    from repro_torch.layers import mlp
    p = mlp.init_moe(64, 48, 8, torch.Generator().manual_seed(0), _dt(dt),
                     device="cpu")
    pc = tree_map(lambda a: a.to(cuda), p)
    x = torch.from_numpy(_data(4, (3, 40, 64))[0]).to(_dt(dt))
    y, aux = mlp.moe_apply(pc, x.to(cuda), 2)
    for _ in range(3):
        y2, aux2 = mlp.moe_apply(pc, x.to(cuda), 2)
        assert torch.equal(y, y2) and torch.equal(aux, aux2)
    if dt == "f32":
        yh, auxh = mlp.moe_apply(p, x, 2)
        assert float((y.cpu() - yh).abs().max()) <= 1e-4 * float(
            yh.abs().max())
        assert abs(float(aux) - float(auxh)) <= 1e-5 * float(auxh)
    same = x[:1, :1].expand(1, 8, 64).contiguous()
    C = mlp.moe_capacity(8, 8, 2, 1.0)
    ys, _ = mlp.moe_apply(pc, same.to(cuda), 2, capacity_factor=1.0)
    norms = ys[0].float().abs().sum(-1).cpu()
    assert C == 2 and norms[0] == 0 and (norms[1:C] > 0).all()
    assert (norms[C:] == 0).all()


@pytest.mark.cuda
def test_encoder_and_moe_on_card_match_cpu(cuda):
    """Reduced hubert (the non-causal kernel) and olmoe in f32: the forward
    on the card equals the port's CPU path within 1e-4 · max|logit|, with
    one swa_attention launch and two rmsnorm launches a layer plus the
    final norm."""
    for arch in ("hubert_xlarge", "olmoe_1b_7b"):
        cfg = get_reduced_config(arch)
        params = api.init_params(cfg, torch.Generator().manual_seed(0),
                                 torch.float32, device="cpu")
        on_card = tree_map(lambda a: a.to(cuda), params)
        rng = np.random.default_rng(1)
        batch = ({"frames": torch.from_numpy(rng.normal(size=(2, 70, 512))
                                             .astype(np.float32))}
                 if cfg.frontend == "audio" else
                 {"tokens": torch.from_numpy(rng.integers(
                     0, cfg.vocab_size, (2, 70)))})
        kernels.reset_launches()
        with torch.no_grad():
            got, _ = api.module_of(cfg).forward(
                cfg, on_card, {k: v.to(cuda) for k, v in batch.items()})
        torch.cuda.synchronize()
        assert kernels.LAUNCHES["swa_attention"] == cfg.num_layers
        assert kernels.LAUNCHES["rmsnorm"] == 2 * cfg.num_layers + 1
        want, _ = api.module_of(cfg).forward(cfg, params, batch)
        assert float((got.cpu() - want).abs().max()) <= 1e-4 * float(
            want.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["rwkv6_3b", "zamba2_1p2b"])
def test_recurrent_families_on_card_match_cpu(cuda, arch):
    """Reduced rwkv6 and zamba2 in f32 (chunk 8: 30 tokens pad): the
    forward on the card equals the port's CPU path within 1e-4 ·
    max|logit| (RWKV6's bf16 group-norm cast may flip a rounding under
    another order of sums: then within twice the larger distance of the
    CPU's two one-ulp twins, ``chip_smoke.greedy_parity``'s twin rule);
    Zamba2 launches rmsnorm 2 L + 2 I + 1 times and swa_attention I times
    over its I shared invocations, RWKV6 no kernel. Its loss gradient
    launches each backward kernel as often."""
    from repro_torch.models import zamba2
    cfg = replace(get_reduced_config(arch), ssm_chunk=8)
    params = api.init_params(cfg, torch.Generator().manual_seed(0),
                             torch.float32, device="cpu")
    on_card = tree_map(lambda a: a.to(cuda), params)
    rng = np.random.default_rng(2)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 30)))
    kernels.reset_launches()
    with torch.no_grad():
        got, _ = api.module_of(cfg).forward(cfg, on_card,
                                            {"tokens": toks.to(cuda)})
    torch.cuda.synchronize()
    I = zamba2.num_attn_invocations(cfg) if arch == "zamba2_1p2b" else 0
    n = 2 * cfg.num_layers + 2 * I + 1 if I else 0
    assert kernels.LAUNCHES["rmsnorm"] == n
    assert kernels.LAUNCHES["swa_attention"] == I
    want, _ = api.module_of(cfg).forward(cfg, params, {"tokens": toks})
    err = float((got.cpu() - want).abs().max())
    if err > 1e-4 * float(want.abs().max()):
        assert arch == "rwkv6_3b", err
        own = 0.0
        for toward in (float("inf"), float("-inf")):
            twin = tree_map(lambda a: torch.nextafter(
                a, torch.full_like(a, toward)), params)
            tl, _ = api.module_of(cfg).forward(cfg, twin, {"tokens": toks})
            own = max(own, float((tl - want).abs().max()))
        assert err <= 2 * own, (err, own)
    batch = {"tokens": toks.to(cuda), "targets": toks.roll(1, 1).to(cuda)}
    leaves = [a.requires_grad_(True) for a in tree_leaves(on_card)]
    kernels.reset_launches()
    loss, _ = api.loss_fn(cfg, on_card, batch)
    grads = torch.autograd.grad(loss, leaves)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["rmsnorm_bwd"] == n
    assert kernels.LAUNCHES["swa_attention_bwd"] == I
    assert all(bool(torch.isfinite(g).all()) for g in grads)


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


# ---------------------------------------------------------------------------
# The LM kernels' backward: rmsnorm_bwd.cu, swa_attention_bwd.cu
# ---------------------------------------------------------------------------

def _bf16_ulp(x: float) -> float:
    """One bf16 ulp at |x| (8 significant bits)."""
    return 2.0 ** (np.floor(np.log2(max(abs(x), 1e-30))) - 7)


def _grad_close(got, ref, truth=None, terms=None):
    """The backward kernels against their plain versions on the same
    inputs: f32 within 1e-5 · max|ref| (the same f32 terms summed in
    another order), bf16 within 2 bf16 ulps of max|ref| (both sides sum in
    f32 and round once; the plain version rounds its einsums' sums in
    another order, so a value near a rounding boundary may land one ulp
    away, and the bar takes two). With the f64 ``truth`` of the same
    function, the bar is at least twice the plain version's own distance
    from it. With ``terms`` (per element, in f64, the sum of the
    magnitudes of the terms the element sums, and its sums' length n),
    an element may also differ from the truth by the f32 rounding those
    sums allow, 2 · √n · 2⁻²⁴ · terms (Higham and Mary's probabilistic
    bound at λ = 2): where the exact result cancels to 0 — attention's dq
    and dk for a query row with one key, whose dS = P·(dP − D) subtracts
    two equal dot products — both sides hold only that rounding."""
    assert got.shape == ref.shape and got.dtype == ref.dtype
    g, r = got.double().cpu(), ref.double().cpu()
    top = float(r.abs().max())
    bar = 2 * _bf16_ulp(top) if got.dtype == torch.bfloat16 else 1e-5 * top
    if truth is not None:
        t = truth.double().cpu()
        bar = max(bar, 2 * float((r - t).abs().max()))
        err = (g - t).abs()
        if terms is not None:
            mags, n = terms
            err = err - 2 * n ** 0.5 * 2.0 ** -24 * mags.cpu()
        assert float(err.max()) <= bar, (float(err.max()), bar)
        return
    assert float((g - r).abs().max()) <= bar, (float((g - r).abs().max()),
                                               bar)


def _swa_bwd_terms(q, k, v, out, lse, do, window, causal=True):
    """Per element of (dq, dk, dv), in f64: the sum of the magnitudes of
    the terms it sums — P·(|dO|·|v| + |dO|·|out|) against |k| (dq) or
    |q| (dk, over the group), P against |dO| (dv) — and the length of the
    longest chain of f32 sums behind it (two head-dim dot products, then
    the sum over keys or over the group's queries)."""
    B, S, H, hd = q.shape
    KV = k.shape[2]
    G = H // KV
    q, k, v, out, lse, do = (a.double() for a in (q, k, v, out, lse, do))
    qg = q.reshape(B, S, KV, G, hd)
    dog = do.abs().reshape(B, S, KV, G, hd)
    s = torch.einsum("bskgh,btkh->bkgst", qg, k) * hd ** -0.5
    i = torch.arange(S, device=q.device)
    mask = ((i[None] <= i[:, None]) & (i[:, None] - i[None] < window)
            if causal else torch.ones_like(s, dtype=torch.bool))
    p = torch.where(mask, torch.exp(s - lse.reshape(B, KV, G, S, 1)),
                    torch.zeros_like(s))
    dabs = (dog * out.abs().reshape(B, S, KV, G, hd)).sum(-1)
    e = p * (torch.einsum("bskgh,btkh->bkgst", dog, v.abs())
             + dabs.permute(0, 2, 3, 1)[..., None])
    scale = hd ** -0.5
    m_dq = torch.einsum("bkgst,btkh->bskgh", e, k.abs()) * scale
    m_dk = torch.einsum("bkgst,bskgh->btkh", e, qg.abs()) * scale
    m_dv = torch.einsum("bkgst,bskgh->btkh", p, dog)
    n = 2 * hd + G * (min(window, S) if causal else S)
    return [(m_dq.reshape(B, S, H, hd), n), (m_dk, n), (m_dv, n)]


@pytest.mark.cuda
@pytest.mark.parametrize("x_dt,s_dt", [("f32", "f32"), ("bf16", "f32"),
                                       ("bf16", "bf16"), ("f32", "bf16")])
@pytest.mark.parametrize("shape", [(512, 4096), (16384, 128), (3, 17, 128),
                                   (1, 96), (5, 3000), (2000, 64),
                                   (7, 1025), (9, 8192)])
def test_rmsnorm_bwd_kernel_matches_plain_on_card(cuda, shape, x_dt, s_dt):
    """dx and dscale of the backward kernel against ``rmsnorm_bwd_ref``;
    bitwise the same on a second call (dscale's fixed-order sums)."""
    x, s, dy = _data(sum(shape) + 1, shape, shape[-1:], shape)
    xd = (torch.from_numpy(x) * 3).to(cuda, _dt(x_dt))
    sd = torch.from_numpy(s).to(cuda, _dt(s_dt))
    dyd = torch.from_numpy(dy).to(cuda, _dt(x_dt))
    before = kernels.LAUNCHES["rmsnorm_bwd"]
    dx, ds = rms_ops.rmsnorm_bwd(xd, sd, dyd, eps=1e-6)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["rmsnorm_bwd"] == before + 1
    rdx, rds = rms_ref.rmsnorm_bwd_ref(xd, sd, dyd, 1e-6)
    _grad_close(dx, rdx)
    _grad_close(ds, rds)
    dx2, ds2 = rms_ops.rmsnorm_bwd(xd, sd, dyd, eps=1e-6)
    assert torch.equal(dx, dx2) and torch.equal(ds, ds2)


@pytest.mark.cuda
@pytest.mark.parametrize("x_dt,s_dt", [("bf16", "f32"), ("f32", "bf16")])
@pytest.mark.parametrize("shape", [(512, 4096), (300, 128), (9, 8192)])
def test_rmsnorm_bwd_unaligned_rows_on_card(cuda, shape, x_dt, s_dt):
    """Rows that do not start on a 16-byte boundary (x and dy one element
    past one) are read element by element, not refused: dx and dscale
    within the bars of ``test_rmsnorm_bwd_kernel_matches_plain_on_card``,
    and bitwise run to run."""
    x, s, dy = _data(sum(shape) + 2, shape, shape[-1:], shape)
    xd = _off_by((torch.from_numpy(x) * 3).to(cuda, _dt(x_dt)), 1)
    sd = torch.from_numpy(s).to(cuda, _dt(s_dt))
    dyd = _off_by(torch.from_numpy(dy).to(cuda, _dt(x_dt)), 1)
    assert xd.is_contiguous() and xd.data_ptr() % 16 != 0
    dx, ds = rms_ops.rmsnorm_bwd(xd, sd, dyd, eps=1e-6)
    rdx, rds = rms_ref.rmsnorm_bwd_ref(xd, sd, dyd, 1e-6)
    _grad_close(dx, rdx)
    _grad_close(ds, rds)
    dx2, ds2 = rms_ops.rmsnorm_bwd(xd, sd, dyd, eps=1e-6)
    assert torch.equal(dx, dx2) and torch.equal(ds, ds2)


def _swa_inputs(cuda, dt, B, S, H, KV, hd, seed=0, q_scale=1.0):
    q, k, v, do = _data(seed + S, (B, S, H, hd), (B, S, KV, hd),
                        (B, S, KV, hd), (B, S, H, hd))
    return (torch.from_numpy(a).to(cuda, _dt(dt))
            for a in (q * q_scale, k, v, do))


SWA_BWD_SHAPES = [
    (4, 128, 32, 8, 128, 128),     # the LM prefill and train step
    (1, 1024, 32, 8, 128, 256),    # windowed
    (2, 37, 4, 2, 64, 37),         # ragged
    (2, 200, 4, 1, 64, 33),        # ragged, windowed, 4 heads per kv head
    (1, 70, 2, 2, 16, 8),
    (3, 1, 2, 1, 32, 1),
    (2, 64, 4, 2, 40, 64),
    (2, 65, 4, 2, 72, 65),
    (1, 200, 4, 2, 64, 1),         # the diagonal alone
    (1, 200, 4, 2, 64, 17),
    (2, 96, 8, 1, 128, 96),        # G = 8
    (1, 50, 2, 1, 20, 50),
    # tile edges: 32-key and 64-key dK/dV blocks, 32- and 64-query tiles,
    # 64- and 128-query dQ blocks, 16-row warps
    (2, 20, 4, 2, 16, 20),         # S below one tile, hd 16
    (1, 33, 4, 2, 20, 33),         # one key past a 32-key block, hd 20
    (1, 100, 8, 2, 64, 40),        # key-tile boundaries inside the window
    (2, 130, 4, 1, 128, 48),       # window ending mid-tile, G = 4
    (1, 64, 2, 2, 32, 16)          # S one dQ tile, window half a tile
] + SWA_ZOO_SHAPES


@pytest.mark.cuda
@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("B,S,H,KV,hd,window", SWA_BWD_SHAPES)
def test_swa_bwd_kernel_matches_plain_on_card(cuda, dt, B, S, H, KV, hd,
                                              window):
    """The forward's log-sum-exp against the plain one (rtol and atol
    1e-5), and dq, dk, dv of the backward kernels against
    ``swa_attention_bwd_ref`` on the same q, k, v, output, log-sum-exp and
    cotangent, against the f64 function with the plain version's own
    distance and each element's f32 rounding bound (``_grad_close``);
    bitwise the same on a second call (dk and dv summed over the group in
    one block, in order)."""
    q, k, v, do = _swa_inputs(cuda, dt, B, S, H, KV, hd)
    out, lse = swa_ops.swa_attention_fwd(q, k, v, window=window)
    ref_lse = swa_ref.swa_attention_lse_ref(q, k, window=window)
    np.testing.assert_allclose(lse.cpu().numpy(), ref_lse.cpu().numpy(),
                               rtol=1e-5, atol=1e-5)
    before = kernels.LAUNCHES["swa_attention_bwd"]
    got = swa_ops.swa_attention_bwd(q, k, v, out, lse, do, window=window)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["swa_attention_bwd"] == before + 1
    ref = swa_ref.swa_attention_bwd_ref(q, k, v, out, lse, do, window=window)
    truth = swa_ref.swa_attention_bwd_ref(
        *(a.double() for a in (q, k, v, out, lse, do)), window=window)
    terms = _swa_bwd_terms(q, k, v, out, lse, do, window)
    for g, r, t, m in zip(got, ref, truth, terms):
        _grad_close(g, r, t, m)
    again = swa_ops.swa_attention_bwd(q, k, v, out, lse, do, window=window)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


def _off_by(a, elems):
    """A contiguous copy of ``a`` that starts ``elems`` elements past a
    16-byte boundary."""
    buf = torch.empty(a.numel() + 16, dtype=a.dtype, device=a.device)
    out = buf[elems:elems + a.numel()].view(a.shape)
    out.copy_(a)
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,H,KV,hd,window", [
    (2, 37, 4, 2, 64, 37), (1, 100, 8, 2, 128, 40)])
def test_swa_bwd_unaligned_operands_on_card(cuda, B, S, H, KV, hd, window):
    """bf16 operands 2 bytes past a 16-byte boundary take the 2-byte
    staging of the tensor-core kernels: within the bars of
    ``test_swa_bwd_kernel_matches_plain_on_card``, bitwise run to run."""
    q, k, v, do = (_off_by(a, 1) for a in
                   _swa_inputs(cuda, "bf16", B, S, H, KV, hd, seed=5))
    assert q.is_contiguous() and q.data_ptr() % 16 == 2
    out, lse = swa_ops.swa_attention_fwd(q, k, v, window=window)
    got = swa_ops.swa_attention_bwd(q, k, v, out, lse, do, window=window)
    ref = swa_ref.swa_attention_bwd_ref(q, k, v, out, lse, do, window=window)
    truth = swa_ref.swa_attention_bwd_ref(
        *(a.double() for a in (q, k, v, out, lse, do)), window=window)
    terms = _swa_bwd_terms(q, k, v, out, lse, do, window)
    for g, r, t, m in zip(got, ref, truth, terms):
        _grad_close(g, r, t, m)
    again = swa_ops.swa_attention_bwd(q, k, v, out, lse, do, window=window)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.cuda
@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("window", [128, 40])
def test_swa_bwd_large_scores_on_card(cuda, dt, window):
    """q scaled by 8: peaked softmax rows, P near 0 and 1."""
    q, k, v, do = _swa_inputs(cuda, dt, 2, 128, 8, 2, 128, seed=7,
                              q_scale=8.0)
    out, lse = swa_ops.swa_attention_fwd(q, k, v, window=window)
    got = swa_ops.swa_attention_bwd(q, k, v, out, lse, do, window=window)
    ref = swa_ref.swa_attention_bwd_ref(q, k, v, out, lse, do, window=window)
    truth = swa_ref.swa_attention_bwd_ref(
        *(a.double() for a in (q, k, v, out, lse, do)), window=window)
    for g, r, t in zip(got, ref, truth):
        _grad_close(g, r, t)


@pytest.mark.cuda
@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("B,S,H,KV,hd,window", [
    (4, 128, 32, 8, 128, 128), (2, 200, 4, 1, 64, 33), (2, 65, 4, 2, 72, 65),
    (1, 50, 2, 1, 20, 50)])
def test_swa_forward_is_bitwise_with_and_without_lse_on_card(
        cuda, dt, B, S, H, KV, hd, window):
    """Writing the log-sum-exp changes nothing else: the output with the
    lse pointer is bitwise the output with a null one (the serving path)."""
    q, k, v, _ = _swa_inputs(cuda, dt, B, S, H, KV, hd, seed=3)
    with torch.no_grad():
        plain_call = swa_ops.swa_attention(q, k, v, window=window)
    with_lse, _ = swa_ops.swa_attention_fwd(q, k, v, window=window)
    assert torch.equal(plain_call, with_lse)


@pytest.mark.cuda
@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_lm_kernels_record_autograd_on_card(cuda, dt):
    """Under autograd the two wrappers record their Functions: backward
    launches rmsnorm_bwd and swa_attention_bwd once each (counted in the
    Functions' backward, on autograd's thread), and the gradients are the
    plain kernels' on the same inputs; a non-contiguous cotangent is
    copied once."""
    x, s = _data(11, (6, 40, 64), (64,))
    xd = torch.from_numpy(x).to(cuda, _dt(dt)).requires_grad_(True)
    sd = torch.from_numpy(s).to(cuda, _dt(dt)).requires_grad_(True)
    q, k, v, do = _swa_inputs(cuda, dt, 2, 40, 4, 2, 64, seed=2)
    q, k, v = (a.requires_grad_(True) for a in (q, k, v))
    kernels.reset_launches()
    y = rms_ops.rmsnorm(xd, sd, eps=1e-6)
    o = swa_ops.swa_attention(q, k, v, window=16)
    assert y.grad_fn is not None and o.grad_fn is not None
    dy = torch.ones_like(y)
    torch.autograd.backward((y, o), (dy, do.transpose(1, 2).contiguous()
                                     .transpose(1, 2)))
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["rmsnorm"] == 1
    assert kernels.LAUNCHES["rmsnorm_bwd"] == 1
    assert kernels.LAUNCHES["swa_attention"] == 1
    assert kernels.LAUNCHES["swa_attention_bwd"] == 1
    dx, ds = rms_ops.rmsnorm_bwd(xd.detach(), sd.detach(), dy, eps=1e-6)
    assert torch.equal(xd.grad, dx) and torch.equal(sd.grad, ds)
    out, lse = swa_ops.swa_attention_fwd(q.detach(), k.detach(), v.detach(),
                                         window=16)
    ref = swa_ops.swa_attention_bwd(q.detach(), k.detach(), v.detach(), out,
                                    lse, do, window=16)
    for g, r in zip((q.grad, k.grad, v.grad), ref):
        assert torch.equal(g, r)


def _sgd_run(cfg, params, batches, lr=1e-2):
    from repro_torch import optim
    from repro_torch.core import trainer
    step = trainer.make_train_step(cfg, optim.sgd(), optim.constant(lr))
    opt, s, losses = (), 0, []
    for b in batches:
        params, opt, s, m = step(params, opt, s, b)
        losses.append(float(m["loss"]))
    return params, losses


@pytest.mark.cuda
def test_lm_train_step_on_card_matches_cpu(cuda):
    """Reduced qwen3_8b, f32: three SGD steps at lr 1e-2 through the
    forward and backward kernels against the port's CPU path from the same
    init — every leaf within 1e-4 · max|leaf| (and the loss within 1e-5
    relative) — with the launches of each step exact: rmsnorm forward and
    backward 4 L + 1, swa_attention forward and backward L."""
    cfg = get_reduced_config("qwen3_8b")
    params = api.init_params(cfg, torch.Generator().manual_seed(0),
                             torch.float32, device="cpu")
    rng = np.random.default_rng(4)
    batches = [{"tokens": torch.from_numpy(rng.integers(0, cfg.vocab_size,
                                                        (2, 48))),
                "targets": torch.from_numpy(rng.integers(0, cfg.vocab_size,
                                                         (2, 48)))}
               for _ in range(3)]
    kernels.reset_launches()
    card, card_losses = _sgd_run(
        cfg, tree_map(lambda a: a.to(cuda), params),
        [tree_map(lambda a: a.to(cuda), b) for b in batches])
    torch.cuda.synchronize()
    L = cfg.num_layers
    want = {name: 0 for name in kernels.LAUNCHES}
    want.update(rmsnorm=3 * (4 * L + 1), rmsnorm_bwd=3 * (4 * L + 1),
                swa_attention=3 * L, swa_attention_bwd=3 * L)
    assert kernels.LAUNCHES == want
    host, host_losses = _sgd_run(cfg, params, batches)
    np.testing.assert_allclose(card_losses, host_losses, rtol=1e-5)
    for c, h in zip(tree_leaves(card), tree_leaves(host)):
        c, h = c.cpu(), h
        assert float((c - h).abs().max()) <= 1e-4 * float(h.abs().max())


# ---------------------------------------------------------------------------
# The conv's backward: dW by conv2d_wgrad.cu, dX by conv2d_dgrad.cu
# ---------------------------------------------------------------------------

# (k, B, H, W, Cin, kernel, Cout): the Map's two stages (k 4 and the
# sequential k 1), the other configs' second stages, a ragged chunk of
# images, a 3x3 kernel, and rows cut into bands
GRAD_SHAPES = [(4, 200, 28, 28, 1, 5, 6), (4, 200, 12, 12, 6, 5, 12),
               (1, 200, 28, 28, 1, 5, 6), (1, 200, 12, 12, 6, 5, 12),
               (4, 200, 12, 12, 3, 5, 9), (4, 200, 12, 12, 2, 5, 4),
               (2, 7, 12, 12, 6, 5, 12), (2, 3, 10, 11, 2, 3, 5),
               (1, 2, 40, 90, 16, 5, 3)]


def _grad_data(cuda, seed, k, b, h, w, cin, kk, cout):
    rng = np.random.default_rng(seed)
    x = rng.random((k, b, h, w, cin), dtype=np.float32)
    wt = (rng.normal(size=(k, kk, kk, cin, cout)) * 0.2).astype(np.float32)
    dy = rng.normal(size=(k, b, h - kk + 1, w - kk + 1, cout)
                    ).astype(np.float32)
    return (torch.from_numpy(a).to(cuda) for a in (x, wt, dy))


def _within_f32(got, plain, exact):
    """The f64 plain version is the truth: the kernel lands within twice
    the f32 plain version's own distance from it, or within
    1e-5 · max|truth|, whichever is larger."""
    got, plain, exact = (a.double().cpu() for a in (got, plain, exact))
    bar = max(2 * float((plain - exact).abs().max()),
              1e-5 * float(exact.abs().max()))
    assert float((got - exact).abs().max()) <= bar


@pytest.mark.cuda
@pytest.mark.parametrize("shape", GRAD_SHAPES)
def test_conv2d_weight_grad_kernel_matches_plain_on_card(cuda, shape):
    x, _, dy = _grad_data(cuda, sum(shape), *shape)
    kk = shape[5]
    before = kernels.LAUNCHES["conv2d_wgrad"]
    dw = conv_ops.conv2d_weight_grad(x, dy, kk, kk)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["conv2d_wgrad"] == before + conv_ops.WGRAD_PASSES
    _within_f32(dw, conv_ref.conv2d_weight_grad_ref(x, dy, kk, kk),
                conv_ref.conv2d_weight_grad_ref(x.double(), dy.double(),
                                                kk, kk))


@pytest.mark.cuda
@pytest.mark.parametrize("shape", GRAD_SHAPES)
def test_conv2d_input_grad_kernel_matches_plain_on_card(cuda, shape):
    _, wt, dy = _grad_data(cuda, sum(shape) + 1, *shape)
    before = kernels.LAUNCHES["conv2d_dgrad"]
    dx = conv_ops.conv2d_input_grad(dy, wt)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["conv2d_dgrad"] == before + 1
    _within_f32(dx, conv_ref.conv2d_input_grad_ref(dy, wt),
                conv_ref.conv2d_input_grad_ref(dy.double(), wt.double()))


@pytest.mark.cuda
@pytest.mark.parametrize("shape", GRAD_SHAPES)
def test_conv2d_grads_are_deterministic_and_member_independent_on_card(
        cuda, shape):
    """No float atomics and a chunking that depends on B alone: two
    launches agree bitwise, and member i of a member-batched launch is the
    bits of a one-member launch — the sequential and stacked SGD Maps see
    the same gradient."""
    x, wt, dy = _grad_data(cuda, 3, *shape)
    kk = shape[5]
    dw = conv_ops.conv2d_weight_grad(x, dy, kk, kk)
    dx = conv_ops.conv2d_input_grad(dy, wt)
    assert torch.equal(dw, conv_ops.conv2d_weight_grad(x, dy, kk, kk))
    assert torch.equal(dx, conv_ops.conv2d_input_grad(dy, wt))
    for i in range(shape[0]):
        s = slice(i, i + 1)
        assert torch.equal(dw[s], conv_ops.conv2d_weight_grad(
            x[s].contiguous(), dy[s].contiguous(), kk, kk))
        assert torch.equal(dx[s], conv_ops.conv2d_input_grad(
            dy[s].contiguous(), wt[s].contiguous()))


def _padded_route_dx(dy, w):
    """dX as the conv's backward computed it before it had its own kernel:
    the forward kernel on dY padded by kh-1 rows and kw-1 columns on each
    side, with the weights turned by 180 degrees and Cin, Cout swapped."""
    import torch.nn.functional as F
    kh, kw = w.shape[1], w.shape[2]
    padded = F.pad(dy, (0, 0, kw - 1, kw - 1, kh - 1, kh - 1))
    turned = w.flip(1, 2).transpose(3, 4).contiguous()
    return conv_ops.conv2d_valid(padded, turned)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", GRAD_SHAPES)
def test_conv2d_dgrad_equals_the_padded_route_on_card(cuda, shape):
    """The direct dX kernel skips the padding's products and sums the rest
    in the padded route's order, so it gives that route's dX value for
    value (dY here holds exact zeros of both signs as well)."""
    _, wt, dy = _grad_data(cuda, sum(shape) + 2, *shape)
    dy.view(-1)[::7] = 0.0
    dy.view(-1)[3::7] = -0.0
    dx = conv_ops.conv2d_input_grad(dy, wt)
    assert torch.equal(dx, _padded_route_dx(dy, wt))


@pytest.mark.cuda
def test_conv2d_autograd_launches_backward_kernels_on_card(cuda):
    """Stage 2 of the Map under autograd: the forward through the conv
    kernel, dX through conv2d_dgrad, dW through conv2d_wgrad, both
    gradients within the bar of the plain versions; images that need no
    gradient get no dX launch."""
    x, wt, dy = _grad_data(cuda, 11, 4, 200, 12, 12, 6, 5, 12)
    x.requires_grad_(True)
    wt.requires_grad_(True)
    kernels.reset_launches()
    conv_ops.conv2d_valid(x, wt).backward(dy)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["conv2d"] == 1
    assert kernels.LAUNCHES["conv2d_dgrad"] == 1
    assert kernels.LAUNCHES["conv2d_wgrad"] == conv_ops.WGRAD_PASSES
    xd, wd = x.detach(), wt.detach()
    _within_f32(wt.grad, conv_ref.conv2d_weight_grad_ref(xd, dy, 5, 5),
                conv_ref.conv2d_weight_grad_ref(xd.double(), dy.double(),
                                                5, 5))
    _within_f32(x.grad, conv_ref.conv2d_input_grad_ref(dy, wd),
                conv_ref.conv2d_input_grad_ref(dy.double(), wd.double()))
    images = xd.clone()
    kernels.reset_launches()
    conv_ops.conv2d_valid(images, wt).backward(dy)
    assert kernels.LAUNCHES["conv2d"] == 1 and images.grad is None
    assert kernels.LAUNCHES["conv2d_dgrad"] == 0


@pytest.mark.cuda
def test_conv2d_wgrad_refuses_bad_operands_on_card(cuda):
    x = torch.zeros((1, 2, 12, 12, 6), device=cuda)
    dy = torch.zeros((1, 2, 8, 8, 12), device=cuda)
    with pytest.raises(ValueError, match="contiguous"):
        conv_ops.conv2d_weight_grad(x, dy.transpose(2, 3), 5, 5)
    with pytest.raises(ValueError, match="shared memory"):
        conv_ops.conv2d_weight_grad(
            torch.zeros((1, 1, 8, 4000, 16), device=cuda),
            torch.zeros((1, 1, 4, 3996, 2), device=cuda), 5, 5)


@pytest.mark.cuda
def test_conv2d_dgrad_refuses_bad_operands_on_card(cuda):
    dy = torch.zeros((1, 2, 8, 8, 12), device=cuda)
    w = torch.zeros((1, 5, 5, 6, 12), device=cuda)
    with pytest.raises(ValueError, match="contiguous"):
        conv_ops.conv2d_input_grad(dy.transpose(2, 3), w)
    with pytest.raises(TypeError):
        conv_ops.conv2d_input_grad(dy.double(), w.double())
    with pytest.raises(ValueError, match="shared memory"):
        conv_ops.conv2d_input_grad(
            torch.zeros((1, 1, 4, 20000, 4), device=cuda),
            torch.zeros((1, 5, 5, 2, 4), device=cuda))


def _no_backward_calls(cuda):
    """One small call of each kernel that has no backward, on operands
    that require grad."""
    rng = np.random.default_rng(5)

    def param(*shape, dtype=torch.float32):
        return torch.from_numpy(rng.normal(size=shape).astype(np.float32)
                                ).to(cuda, dtype).requires_grad_(True)
    return {
        "elm_stats": lambda: stats_ops.elm_stats(param(2, 40, 16),
                                                 param(2, 40, 3)),
    }


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["elm_stats"])
def test_kernels_without_backward_refuse_grad_on_card(cuda, name):
    """A kernel without a backward would hand back a buffer with no graph:
    on the card it refuses an operand that requires grad under grad mode,
    and runs the same call under no_grad."""
    call = _no_backward_calls(cuda)[name]
    before = kernels.LAUNCHES[name]
    with pytest.raises(RuntimeError, match="no backward"):
        call()
    assert kernels.LAUNCHES[name] == before
    with torch.no_grad():
        out = call()
    torch.cuda.synchronize()
    assert kernels.LAUNCHES[name] == before + 1
    for o in (out if isinstance(out, tuple) else (out,)):
        assert o.grad_fn is None and bool(torch.isfinite(o).all())


@pytest.mark.cuda
@pytest.mark.parametrize("backend", ["stacked", "sequential"])
@pytest.mark.parametrize("split", ["iid", "unequal"])
def test_sgd_map_on_card_matches_cpu(cuda, backend, split):
    """Two SGD epochs (dynamic_paper(0.05)) through the kernels equal the
    plain CPU path: CNN weights within 1e-4 · max|w| per leaf, β within
    1e-3 · max|β|; per step 2 conv launches (the forwards), stage 2's dX
    on conv2d_dgrad, 2 stages × WGRAD_PASSES of conv2d_wgrad and one
    elm_stats."""
    from repro_torch.optim.schedules import dynamic_paper
    cfg = replace(get_reduced_config("cnn_elm_6c12c"), elm_lambda=1.0)
    ds = make_extended_mnist(n_per_class=30, seed=0)
    train, _ = ds.split(n_test=100)
    parts = (partition_iid(train.x, train.y, 3) if split == "iid" else
             partition_unequal(train.x, train.y, (500, 300, 180)))
    run = AveragingRun(cfg, MapConfig(
        epochs=2, lr_schedule=dynamic_paper(0.05), batch_size=50,
        backend=backend))
    nbs = [len(p.x) // 50 for p in parts]
    steps = 2 * (max(nbs) if backend == "stacked" else sum(nbs))
    kernels.reset_launches()
    card = run.run(parts, generator=torch.Generator().manual_seed(7),
                   device=cuda)
    assert {n: kernels.LAUNCHES[n] for n in
            ("conv2d", "conv2d_dgrad", "conv2d_wgrad", "elm_stats")} == {
        "conv2d": 2 * steps, "conv2d_dgrad": steps,
        "conv2d_wgrad": 2 * conv_ops.WGRAD_PASSES * steps,
        "elm_stats": steps}
    cpu = run.run(parts, generator=torch.Generator().manual_seed(7),
                  device="cpu")
    for a, b in zip(tree_leaves(card.stacked.cnn_params),
                    tree_leaves(cpu.stacked.cnn_params)):
        assert float((a.cpu() - b).abs().max()) <= 1e-4 * float(
            b.abs().max())
    bc, bp = card.stacked.beta.cpu(), cpu.stacked.beta
    assert float((bc - bp).abs().max()) <= 1e-3 * float(bp.abs().max())


def _cnn_run(backend, rounds=2, elastic=None):
    from repro_torch.core.runner import ReduceConfig
    from repro_torch.optim.schedules import dynamic_paper
    cfg = replace(get_reduced_config("cnn_elm_6c12c"), elm_lambda=1.0)
    return AveragingRun(cfg, MapConfig(
        epochs=2 if elastic is None else 3,
        lr_schedule=dynamic_paper(0.05), batch_size=50, backend=backend),
        ReduceConfig(rounds=rounds, elastic=elastic))


def _bit_equal(a, b):
    la = tree_leaves((a.cnn_params, a.beta))
    lb = tree_leaves((b.cnn_params, b.beta))
    return len(la) == len(lb) and all(torch.equal(x, y)
                                      for x, y in zip(la, lb))


@pytest.mark.cuda
@pytest.mark.parametrize("backend,unit,rounds,index", [
    ("stacked", "round", 2, 0), ("sequential", "member", 1, 1)])
def test_crash_resume_is_bitwise_on_card(cuda, tmp_path, backend, unit,
                                         rounds, index):
    """Crashed after round 0 (stacked) or member 1 (sequential) and resumed
    from disk: members, β and the averaged model equal the uninterrupted
    run's under ``torch.equal`` on the card, and the resume launched the
    kernels."""
    from repro_torch.core import faults
    ds = make_extended_mnist(n_per_class=30, seed=0)
    parts = partition_iid(ds.x, ds.y, 3)

    def gen():
        return torch.Generator().manual_seed(7)

    ref = _cnn_run(backend, rounds).run(parts, generator=gen(), device=cuda)
    assert faults.run_to_crash(_cnn_run(backend, rounds), parts,
                               str(tmp_path), unit=unit, index=index,
                               generator=gen(), device=cuda)
    kernels.reset_launches()
    res = _cnn_run(backend, rounds).resume(parts, str(tmp_path),
                                           generator=gen(), device=cuda)
    assert res.resumed and kernels.LAUNCHES["conv2d_wgrad"] > 0
    assert res.stacked.beta.is_cuda
    assert all(_bit_equal(a, b) for a, b in zip(ref.members, res.members))
    assert _bit_equal(ref.averaged, res.averaged)


@pytest.mark.cuda
def test_elastic_backends_and_resume_are_bitwise_on_card(cuda, tmp_path):
    """One leave and one join: the stacked and sequential elastic runs agree
    under ``torch.equal`` on the card, and a crash after round 1 resumes
    to the uninterrupted run."""
    from repro_torch.core import faults
    from repro_torch.core.runner import ElasticEvent, ElasticSchedule
    ds = make_extended_mnist(n_per_class=30, seed=0)
    parts = partition_iid(ds.x, ds.y, 3)
    sched = ElasticSchedule((ElasticEvent(after_round=0, join=(parts[0],)),
                             ElasticEvent(after_round=1, leave=("m1",))))

    def gen():
        return torch.Generator().manual_seed(7)

    st = _cnn_run("stacked", 3, sched).run(parts, generator=gen(),
                                           device=cuda)
    seq = _cnn_run("sequential", 3, sched).run(parts, generator=gen(),
                                               device=cuda)
    assert sorted(st.members) == sorted(seq.members) == ["m0", "m2", "m3"]
    assert all(_bit_equal(st.members[n], seq.members[n]) for n in st.members)
    assert _bit_equal(st.averaged, seq.averaged)
    crashed, res = faults.run_crash_resume(
        _cnn_run("stacked", 3, sched), parts, str(tmp_path), unit="round",
        index=1, generator=gen(), device=cuda)
    assert crashed and res.resumed and [r.round for r in res.rounds] == [2]
    assert all(_bit_equal(st.members[n], res.members[n]) for n in st.members)
    assert _bit_equal(st.averaged, res.averaged)


@pytest.mark.cuda
def test_mesh_on_card_is_the_stacked_run(cuda, tmp_path):
    """The mesh backend over NCCL at world size 1, one rank holding every
    member: the two-round SGD run and the elastic churn equal the stacked
    runs under ``torch.equal`` on the card, with one all-reduce a sync and
    none in an epoch, and a crash after round 0 resumes bitwise."""
    from repro_torch.core import faults
    from repro_torch.core.runner import ElasticEvent, ElasticSchedule
    from repro_torch.distributed import collectives
    from repro_torch.launch.mesh import process_group
    ds = make_extended_mnist(n_per_class=30, seed=0)
    parts = partition_iid(ds.x, ds.y, 3)
    sched = ElasticSchedule((ElasticEvent(after_round=0, join=(parts[0],)),
                             ElasticEvent(after_round=1, leave=("m1",))))

    def gen():
        return torch.Generator().manual_seed(7)

    with process_group(device="cuda"):
        st = _cnn_run("stacked", 2).run(parts, generator=gen(), device=cuda)
        collectives.reset()
        kernels.reset_launches()
        me = _cnn_run("mesh", 2).run(parts, generator=gen(), device=cuda)
        assert kernels.LAUNCHES["conv2d_wgrad"] > 0 and me.stacked.beta.is_cuda
        assert all(_bit_equal(a, b) for a, b in zip(st.members, me.members))
        assert _bit_equal(st.averaged, me.averaged)
        spans = collectives.LOG
        assert [label for label, _ in spans].count("sync") == 1
        for label, counts in spans:
            if label == "epoch":
                assert collectives.check_no_collectives(counts).ok
            if label in ("sync", "reduce"):
                assert collectives.check_one_all_reduce(counts).ok
        crashed, res = faults.run_crash_resume(
            _cnn_run("mesh", 2), parts, str(tmp_path / "rounds"),
            unit="round", index=0, generator=gen(), device=cuda)
        assert crashed and res.resumed
        assert all(_bit_equal(a, b) for a, b in zip(me.members, res.members))
        assert _bit_equal(me.averaged, res.averaged)
        st = _cnn_run("stacked", 3, sched).run(parts, generator=gen(),
                                               device=cuda)
        me = _cnn_run("mesh", 3, sched).run(parts, generator=gen(),
                                            device=cuda)
        assert sorted(me.members) == ["m0", "m2", "m3"]
        assert all(_bit_equal(st.members[n], me.members[n])
                   for n in st.members)
        assert _bit_equal(st.averaged, me.averaged)


@pytest.mark.cuda
def test_lm_finetune_step_on_card_matches_cpu(cuda):
    """``finetune_step`` over the decoder runs on the card through the
    rmsnorm and swa_attention forward and backward kernels, after the
    head's stats, solve and predict under no_grad: reduced qwen3_8b in
    f32, the same params, batch and β on the card and on the CPU; the loss
    within rtol 1e-4 and every new leaf within 1e-4 · max|leaf|."""
    from repro_torch.core import elm_head
    cfg = get_reduced_config("qwen3_8b")
    params = api.init_params(cfg, torch.Generator().manual_seed(0),
                             torch.float32, device="cpu")
    gen = torch.Generator().manual_seed(1)

    def make_batch():
        return {"tokens": torch.randint(0, cfg.vocab_size, (2, 32),
                                        generator=gen),
                "targets": torch.randint(0, 16, (2, 32), generator=gen)}

    def feature_fn(p, b):
        return api.hidden_states(cfg, p, b)

    # β from one batch, the step on another (as the CPU parity test,
    # tests/test_torch_elm_head.py, whose bars these are)
    stats_batch, batch = make_batch(), make_batch()
    on_card = tree_map(lambda a: a.to(cuda), params)
    card_batch = {k: v.to(cuda) for k, v in batch.items()}
    kernels.reset_launches()
    beta = elm_head.solve(elm_head.accumulate_stats(
        feature_fn, on_card, {k: v.to(cuda) for k, v in stats_batch.items()},
        16), 10.0)
    scores = elm_head.predict(feature_fn, on_card, beta, card_batch)
    torch.cuda.synchronize()
    assert scores.is_cuda and bool(torch.isfinite(scores).all())
    assert kernels.LAUNCHES["elm_stats"] == 1
    kernels.reset_launches()
    new_card, loss_card = elm_head.finetune_step(feature_fn, on_card, beta,
                                                 card_batch, 16, lr=1e-2)
    torch.cuda.synchronize()
    L = cfg.num_layers
    assert kernels.LAUNCHES["rmsnorm_bwd"] == 4 * L + 1
    assert kernels.LAUNCHES["swa_attention_bwd"] == L
    new_host, loss_host = elm_head.finetune_step(feature_fn, params,
                                                 beta.cpu(), batch, 16,
                                                 lr=1e-2)
    np.testing.assert_allclose(float(loss_card), float(loss_host), rtol=1e-4)
    for c, h in zip(tree_leaves(new_card), tree_leaves(new_host)):
        assert float((c.cpu() - h).abs().max()) <= 1e-4 * float(
            h.abs().max())


# ---------------------------------------------------------------------------
# Serving through one captured CUDA graph per bucket
# ---------------------------------------------------------------------------

def _serving_members(cuda, k=4, seed=0):
    """k members of the full-width cnn_elm_6c12c with random weights and β
    drawn from ``seed`` (the scorer's programs do not depend on training)."""
    from repro_torch.configs import get_config
    from repro_torch.core.cnn_elm import StackedMembers
    from repro_torch.models import cnn
    cfg = get_config("cnn_elm_6c12c")
    gen = torch.Generator().manual_seed(seed)
    params = [cnn.init_params(cfg, gen, device="cpu") for _ in range(k)]
    cnn_k = tree_map(lambda *xs: torch.stack(xs), *params)
    beta = 0.1 * torch.randn((k, cnn.feature_dim(cfg), cfg.num_classes),
                             generator=gen)
    return cfg, StackedMembers(cnn_k, beta).to(cuda)


def _images(n, seed=0):
    return np.random.default_rng(seed).random((n, 28, 28), dtype=np.float32)


@pytest.mark.cuda
def test_graph_replay_equals_eager_scoring_at_each_bucket(cuda):
    """Every bucket's replay equals the same scoring pass run eagerly on
    the card, bit for bit, and each bucket holds one graph."""
    from repro_torch.serve import BucketedScorer
    cfg, members = _serving_members(cuda)
    scorer = BucketedScorer(cfg, members, max_batch=64, device=cuda)
    x = _images(64)
    for b in scorer.ladder.buckets:
        got = scorer.score_block(x[:b])
        eager = scorer._scores(torch.from_numpy(x[:b]).to(cuda))
        torch.cuda.synchronize()
        assert got.shape == (4, b, cfg.num_classes)
        np.testing.assert_array_equal(got, eager.cpu().numpy())
    assert scorer.compile_count() == len(scorer.ladder.buckets)
    assert scorer.assert_compile_budget() == len(scorer.ladder.buckets)


@pytest.mark.cuda
def test_rows_score_the_same_bits_in_every_bucket_on_card(cuda):
    """The padding contract on the card: 7 rows score the same bits alone
    (bucket 8) and inside every larger bucket."""
    from repro_torch.serve import BucketedScorer
    cfg, members = _serving_members(cuda)
    scorer = BucketedScorer(cfg, members, max_batch=64, device=cuda)
    x = _images(64, seed=1)
    alone = scorer.score_block(x[:7])
    for n in (8, 9, 16, 17, 32, 33, 64):
        np.testing.assert_array_equal(scorer.score_block(x[:n])[:, :7],
                                      alone)


@pytest.mark.cuda
def test_swap_under_graphs_scores_the_new_members(cuda):
    """A swap copies into the captured weights: every bucket's replay then
    scores the new members (bitwise their own eager scores, here the old
    members reversed), with no new capture."""
    from repro_torch.core.cnn_elm import stack_models
    from repro_torch.serve import BucketedScorer, SwapRejected
    cfg, members = _serving_members(cuda)
    scorer = BucketedScorer(cfg, members, max_batch=16, device=cuda).warmup()
    x = _images(16, seed=2)
    before = {b: scorer.score_block(x[:b]) for b in scorer.ladder.buckets}
    scorer.swap_members(stack_models(members.unstack()[::-1]))
    for b in scorer.ladder.buckets:
        np.testing.assert_array_equal(scorer.score_block(x[:b]),
                                      before[b][::-1])
    assert scorer.assert_compile_budget() == len(scorer.ladder.buckets)
    with pytest.raises(SwapRejected):
        scorer.swap_members(stack_models(members.unstack()[:2]))


@pytest.mark.cuda
def test_graph_replays_are_counted_as_launches(cuda):
    """A replay launches no kernel from Python, yet adds its capture's
    launches (one conv2d per stage) to ``kernels.LAUNCHES``; the capture
    itself counts none."""
    from repro_torch.serve import BucketedScorer
    cfg, members = _serving_members(cuda)
    scorer = BucketedScorer(cfg, members, max_batch=8, device=cuda).warmup()
    kernels.reset_launches()
    x = _images(8, seed=3)
    for n in (1, 3, 8, 8, 5):
        scorer.score_block(x[:n])
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["conv2d"] == 2 * 5
    assert kernels.LAUNCHES["elm_stats"] == 0


@pytest.mark.cuda
def test_capture_without_a_launch_record_raises(cuda):
    """A kernel launched into a capture that keeps no launch record would
    be counted as run though it ran nothing: the wrapper refuses."""
    from repro_torch.serve import BucketedScorer
    cfg, members = _serving_members(cuda)
    scorer = BucketedScorer(cfg, members, max_batch=2, device=cuda).warmup()
    graph = torch.cuda.CUDAGraph()
    with pytest.raises(RuntimeError, match="capture_launches"):
        with torch.cuda.graph(graph, capture_error_mode="thread_local"):
            scorer._scores(torch.zeros((2, 28, 28), device=cuda))


# ---------------------------------------------------------------------------
# The streaming Map on the card
# ---------------------------------------------------------------------------

def _stream_run(device, backend="stacked", sync="drift", ckpt=None):
    from repro_torch.core.executor import CheckpointConfig
    from repro_torch.core.runner import ReduceConfig
    from repro_torch.models import cnn
    from repro_torch.stream import (StreamConfig, StreamingRun,
                                    SyntheticDriftSource, member_streams)
    cfg = get_reduced_config("cnn_elm_6c12c")
    srcs = [SyntheticDriftSource(n_chunks=8, chunk_rows=64, drift_at=4,
                                 seed=11 + i, label_shift=5, n_per_class=12)
            for i in range(2)]
    init = cnn.init_params(cfg, torch.Generator().manual_seed(0),
                           device="cpu")
    return StreamingRun(
        cfg, MapConfig(epochs=0, batch_size=16, backend=backend),
        ReduceConfig(sync=sync),
        StreamConfig(window_chunks=3, holdout_rows=16, drift_threshold=0.3,
                     drift_warmup=2, verify_every=3)).run(
        member_streams(srcs, 2, seed=1000, per_member=True),
        init_params=init, device=device,
        checkpoint=None if ckpt is None else CheckpointConfig(dir=ckpt))


def _stream_f64(res, ckpt, lam):
    """The f64 models of a stream's own windows: each member's β solved in
    f64 from its final window totals, and the published β solved in f64
    from the totals its last sync saved, averaged uniformly."""
    from repro_torch.checkpoint import run_state

    def solve(u, v):
        eye = torch.eye(u.shape[-1], dtype=torch.float64)
        return torch.linalg.solve(u.cpu().double() + eye / lam,
                                  v.cpu().double())
    beta = solve(torch.stack([w.total().u for w in res.windows]),
                 torch.stack([w.total().v for w in res.windows]))
    state = run_state.restore_round(ckpt, res.sync_chunks[-1], "cpu")
    return beta, solve(state.stats.u, state.stats.v).mean(0)


@pytest.mark.cuda
def test_stream_on_card_matches_cpu(cuda, tmp_path):
    """A drift-policy stream (reduced cnn_elm_6c12c, 2 members, 8 chunks of
    64 rows) through the kernels (per chunk: one member-batched held-out
    pass, 2 convs, and 2 convs + 1 elm_stats a batch). The card's run
    makes the CPU run's syncs; each member's window totals lie within the
    window gate's tolerance (1e-3 + 1e-5 · max|total|) of the CPU's. Its
    windowed β and published β lie within 1e-3 · max|β| — or twice the
    CPU's own distance from the f64 model of the CPU's windows, where that
    is larger — of the f64 model of the card's OWN windows, and from the
    CPU's within that bar plus the two f64 models' distance (what the
    windows' difference makes of an exact solve). The card's stacked and
    sequential runs are the same bits."""
    from repro_torch.stream import StreamConfig
    cpu = _stream_run("cpu", ckpt=str(tmp_path / "cpu"))
    kernels.reset_launches()
    card = _stream_run(cuda, ckpt=str(tmp_path / "card"))
    assert card.launches == {**{n: 0 for n in kernels.LAUNCHES},
                             "conv2d": 8 * (2 + 2 * 4), "elm_stats": 8 * 4}
    assert card.sync_chunks == cpu.sync_chunks
    assert any(s.reason == "drift" for s in card.syncs)
    sc = StreamConfig()
    for wa, wb in zip(card.windows, cpu.windows):
        for x, y in zip(wa.total()[:2], wb.total()[:2]):
            assert x.is_cuda
            np.testing.assert_allclose(
                x.cpu().numpy(), y.numpy(), rtol=0,
                atol=sc.verify_atol + sc.verify_rtol * float(y.abs().max()))
    lam = get_reduced_config("cnn_elm_6c12c").elm_lambda
    xa, xa_pub = _stream_f64(card, str(tmp_path / "card"), lam)
    xb, xb_pub = _stream_f64(cpu, str(tmp_path / "cpu"), lam)
    for got, ref, xg, xr in (
            (card.stacked.beta, cpu.stacked.beta, xa, xb),
            (card.last_published.beta, cpu.last_published.beta, xa_pub,
             xb_pub)):
        got, ref = got.cpu().double(), ref.cpu().double()
        bar = max(1e-3 * float(ref.abs().max()),
                  2 * float((ref - xr).abs().max()))
        assert float((got - xg).abs().max()) <= bar
        assert float((got - ref).abs().max()) <= \
            bar + float((xg - xr).abs().max())
    seq = _stream_run(cuda, backend="sequential")
    assert seq.sync_chunks == card.sync_chunks
    for a, b in zip(card.members, seq.members):
        assert torch.equal(a.beta, b.beta)
    for wa, wb in zip(card.windows, seq.windows):
        assert all(torch.equal(p, q) for p, q in zip(wa.total(), wb.total()))
