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
        "rmsnorm": lambda: rms_ops.rmsnorm(param(8, 64), param(64)),
        "swa_attention": lambda: swa_ops.swa_attention(
            param(1, 16, 4, 32), param(1, 16, 2, 32), param(1, 16, 2, 32),
            window=8),
    }


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["elm_stats", "rmsnorm", "swa_attention"])
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
