"""The port's conv2d and elm_stats wrappers against the reference's (the LM
kernels' are held in ``test_torch_lm_kernels.py``).

On the CPU each wrapper runs its plain PyTorch version; it is held against
the reference's Pallas kernel (interpret mode) and its jnp oracle on the
same numpy inputs. ``test_torch_cuda.py`` holds the hand-written CUDA
kernels against these plain versions on the card.

Tolerance: f32 sums of the same terms in another order — rtol 1e-5 and
atol 1e-5 · max|ref|.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.kernels.conv2d import ops as jconv
from repro.kernels.elm_stats import ops as jstats
from repro_torch import kernels
from repro_torch.kernels.conv2d import ops as conv_ops, ref as conv_ref
from repro_torch.kernels.elm_stats import ops as stats_ops
from repro_torch.kernels.rmsnorm import ops as rms_ops
from repro_torch.kernels.swa_attention import ops as swa_ops

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


# ---------------------------------------------------------------------------
# conv2d
# ---------------------------------------------------------------------------

CONV_SHAPES = [
    (1, 8, 8, 1, 3, 2),
    (2, 28, 28, 1, 5, 6),     # the paper's input geometry
    (3, 12, 12, 6, 5, 12),    # the paper's second stage
    (2, 9, 9, 3, 5, 9),
    (2, 12, 12, 2, 5, 4),     # the reduced configs' second stage
]


@pytest.mark.parametrize("use_pallas", [True, False])
@pytest.mark.parametrize("b,h,w,cin,kk,cout", CONV_SHAPES)
def test_conv2d_plain_matches_reference(b, h, w, cin, kk, cout, use_pallas):
    x, wt = _data(b * h + cout, (b, h, w, cin), (kk, kk, cin, cout))
    ref = jconv.conv2d_valid(jnp.asarray(x), jnp.asarray(wt),
                             use_pallas=use_pallas)
    got = conv_ops.conv2d_valid(torch.from_numpy(x), torch.from_numpy(wt))
    assert got.dtype == torch.float32
    _close(got.numpy(), ref)


def test_conv2d_member_batched_equals_member_loop():
    """Member i of the batched form is exactly the one-member call on
    member i's images and weights."""
    x, wt = _data(7, (3, 4, 12, 12, 6), (3, 5, 5, 6, 12))
    xt, wtt = torch.from_numpy(x), torch.from_numpy(wt)
    batched = conv_ops.conv2d_valid(xt, wtt)
    assert batched.shape == (3, 4, 8, 8, 12)
    for i in range(3):
        assert torch.equal(batched[i], conv_ops.conv2d_valid(xt[i], wtt[i]))


def test_conv2d_im2col_matches_reference_layout():
    """The patch matrix has the reference's (kh, kw, Cin) column order."""
    from repro.kernels.conv2d import ref as jref
    (x,) = _data(3, (2, 7, 6, 3))
    got = conv_ref.im2col(torch.from_numpy(x), 3, 2).numpy()
    np.testing.assert_array_equal(got, np.asarray(jref.im2col(
        jnp.asarray(x), 3, 2)))


@pytest.mark.parametrize("x_shape,w_shape,exc", [
    ((2, 8, 8, 1), (3, 3, 2, 4), ValueError),          # Cin mismatch
    ((2, 2, 8, 8, 1), (3, 3, 3, 1, 4), ValueError),    # member mismatch
    ((2, 4, 4, 1), (5, 5, 1, 4), ValueError),          # kernel > image
    ((2, 8, 8, 1), (3, 3, 1), ValueError),             # w rank
])
def test_conv2d_rejects_bad_shapes(x_shape, w_shape, exc):
    with pytest.raises(exc):
        conv_ops.conv2d_valid(torch.zeros(x_shape), torch.zeros(w_shape))


def test_conv2d_rejects_other_dtypes_and_grad():
    """Other dtypes are refused, also where autograd records the call: the
    shape and dtype checks come before the gradient's route."""
    x = torch.zeros((1, 8, 8, 1), dtype=torch.float64)
    with pytest.raises(TypeError):
        conv_ops.conv2d_valid(x, torch.zeros((3, 3, 1, 2),
                                             dtype=torch.float64))
    w = torch.zeros((3, 3, 1, 2), dtype=torch.float64, requires_grad=True)
    with pytest.raises(TypeError):
        conv_ops.conv2d_valid(torch.zeros((1, 8, 8, 1),
                                          dtype=torch.float64), w)


def test_conv2d_records_its_gradient():
    """A weight that requires grad goes through ``Conv2dValid``; under
    ``no_grad`` the same call records nothing."""
    w = torch.ones((3, 3, 1, 2), requires_grad=True)
    y = conv_ops.conv2d_valid(torch.ones((1, 8, 8, 1)), w)
    assert y.grad_fn is not None and y.requires_grad
    y.sum().backward()
    assert torch.equal(w.grad, torch.full((3, 3, 1, 2), 36.0))
    with torch.no_grad():
        assert conv_ops.conv2d_valid(torch.ones((1, 8, 8, 1)),
                                     w).grad_fn is None


# ---------------------------------------------------------------------------
# elm_stats
# ---------------------------------------------------------------------------

STATS_SHAPES = [(64, 10, 3), (200, 64, 10), (137, 144, 20), (17, 7, 2)]


def _mask(kind, n, seed):
    rng = np.random.default_rng(seed)
    if kind == "binary":
        return (rng.random(n) > 0.4).astype(np.float32)
    return rng.random(n).astype(np.float32)


@pytest.mark.parametrize("use_pallas", [True, False])
@pytest.mark.parametrize("mask_kind", [None, "binary", "fractional"])
@pytest.mark.parametrize("n,L,C", STATS_SHAPES)
def test_elm_stats_plain_matches_reference(n, L, C, mask_kind, use_pallas):
    h, t = _data(n + L, (n, L), (n, C))
    m = None if mask_kind is None else _mask(mask_kind, n, n)
    ju, jv = jstats.elm_stats(jnp.asarray(h), jnp.asarray(t),
                              mask=None if m is None else jnp.asarray(m),
                              use_pallas=use_pallas)
    u, v = stats_ops.elm_stats(torch.from_numpy(h), torch.from_numpy(t),
                               mask=None if m is None else torch.from_numpy(m))
    assert u.shape == (L, L) and v.shape == (L, C)
    _close(u.numpy(), ju)
    _close(v.numpy(), jv)


def test_elm_stats_fractional_mask_weights_once():
    """Row weights enter U and V exactly ONCE (Hᵀdiag(m)H), never squared."""
    h, t = _data(11, (50, 12), (50, 4))
    m = _mask("fractional", 50, 11)
    u, v = stats_ops.elm_stats(torch.from_numpy(h), torch.from_numpy(t),
                               mask=torch.from_numpy(m))
    hm = h.astype(np.float64) * m[:, None]
    _close(u.numpy(), hm.T @ h)
    _close(v.numpy(), hm.T @ t)


def test_elm_stats_ones_mask_bit_identical():
    """An all-ones mask perturbs no bit of the unmasked result — the
    equal-shard fast path's guarantee."""
    h, t = _data(12, (128, 33), (128, 5))
    u0, v0 = stats_ops.elm_stats(torch.from_numpy(h), torch.from_numpy(t))
    u1, v1 = stats_ops.elm_stats(torch.from_numpy(h), torch.from_numpy(t),
                                 mask=torch.ones(128))
    assert torch.equal(u0, u1) and torch.equal(v0, v1)


@pytest.mark.parametrize("masked", [False, True])
def test_elm_stats_member_batched_equals_member_loop(masked):
    h, t = _data(13, (4, 137, 144), (4, 137, 20))
    m = _mask("fractional", 4 * 137, 13).reshape(4, 137) if masked else None
    ht, tt = torch.from_numpy(h), torch.from_numpy(t)
    mt = None if m is None else torch.from_numpy(m)
    u, v = stats_ops.elm_stats(ht, tt, mask=mt)
    assert u.shape == (4, 144, 144) and v.shape == (4, 144, 20)
    for i in range(4):
        ui, vi = stats_ops.elm_stats(ht[i], tt[i],
                                     mask=None if mt is None else mt[i])
        assert torch.equal(u[i], ui) and torch.equal(v[i], vi)


def test_elm_stats_rejects_bad_operands():
    h, t = torch.zeros((2, 10, 4)), torch.zeros((2, 10, 3))
    with pytest.raises(ValueError):
        stats_ops.elm_stats(h, torch.zeros((2, 9, 3)))
    with pytest.raises(ValueError):
        stats_ops.elm_stats(h, t, mask=torch.zeros((2, 9)))
    with pytest.raises(TypeError):
        stats_ops.elm_stats(h.double(), t.double())


def test_plain_versions_launch_nothing():
    """The launch counters count kernel launches only: the CPU route adds
    nothing."""
    kernels.reset_launches()
    conv_ops.conv2d_valid(torch.zeros((1, 8, 8, 1)), torch.zeros((3, 3, 1, 2)))
    x = torch.zeros((1, 8, 8, 1), requires_grad=True)
    w = torch.zeros((3, 3, 1, 2), requires_grad=True)
    conv_ops.conv2d_valid(x, w).sum().backward()      # the gradients' route
    conv_ops.conv2d_input_grad(torch.zeros((1, 2, 6, 6, 2)),
                               torch.zeros((1, 3, 3, 1, 2)))
    stats_ops.elm_stats(torch.zeros((5, 3)), torch.zeros((5, 2)))
    x = torch.ones((4, 8), requires_grad=True)
    rms_ops.rmsnorm(x, torch.ones(8)).sum().backward()  # autograd's route
    q = torch.zeros((1, 4, 2, 8), requires_grad=True)
    swa_ops.swa_attention(q, q, q, window=2).sum().backward()
    assert kernels.LAUNCHES == {"conv2d": 0, "conv2d_wgrad": 0,
                                "conv2d_dgrad": 0, "elm_stats": 0,
                                "rmsnorm": 0, "rmsnorm_bwd": 0,
                                "swa_attention": 0, "swa_attention_bwd": 0}


def test_elm_stats_cpu_route_is_differentiable():
    """The port's CPU elm_stats under autograd (the card refuses an operand
    that requires grad: its kernel has no backward yet): dH and dT equal
    jax.vjp of the reference's jnp route on the same inputs, with a
    fractional mask."""
    import jax
    h, t, gu, gv = _data(70, (30, 12), (30, 3), (12, 12), (12, 3))
    m = _mask("fractional", 30, 71)
    ht, tt = (torch.from_numpy(a).requires_grad_(True) for a in (h, t))
    u, v = stats_ops.elm_stats(ht, tt, mask=torch.from_numpy(m))
    assert u.grad_fn is not None and v.grad_fn is not None
    torch.autograd.backward((u, v), (torch.from_numpy(gu),
                                     torch.from_numpy(gv)))
    _, vjp = jax.vjp(lambda a, b: jstats.elm_stats(
        a, b, mask=jnp.asarray(m), use_pallas=False),
        jnp.asarray(h), jnp.asarray(t))
    dh, dt = vjp((jnp.asarray(gu), jnp.asarray(gv)))
    _close(ht.grad.numpy(), dh)
    _close(tt.grad.numpy(), dt)


def test_refuse_grad_guards_grad_mode_only():
    """The card's refusal of an operand that requires grad (the wrappers
    call it on CUDA operands only): it raises under grad mode, and lets
    the same operands through under no_grad or detached."""
    a = torch.zeros(3, requires_grad=True)
    with pytest.raises(RuntimeError, match="no backward"):
        kernels.refuse_grad("rmsnorm", (torch.zeros(3), a))
    with torch.no_grad():
        kernels.refuse_grad("rmsnorm", (torch.zeros(3), a))
    kernels.refuse_grad("rmsnorm", (torch.zeros(3), a.detach()))


def test_conv2d_dgrad_is_registered_with_its_c_signature():
    """Each kernel's C entry point, as registered for ctypes, is the one its
    source defines, with as many arguments (the stream last), and has its
    launch counter; conv2d_dgrad among them."""
    import ctypes
    import re
    assert kernels._ENTRIES["conv2d_dgrad"] == (
        "conv2d_dgrad_f32", (ctypes.c_void_p,) * 3 + (ctypes.c_int,) * 8
        + (ctypes.c_void_p,))
    assert "conv2d_dgrad" in kernels.LAUNCHES
    sources = "".join(p.read_text() for p in kernels.CSRC.glob("*.cu"))
    for name, (fn, argtypes) in kernels._ENTRIES.items():
        m = re.search(r'extern "C" int ' + fn + r"\(([^)]*)\)", sources)
        assert m is not None, name
        params = [a.strip() for a in m.group(1).split(",")]
        assert len(params) == len(argtypes), name
        assert params[-1] == "void* stream", name
        for p, t in zip(params, argtypes):
            assert ("*" in p) == (t is ctypes.c_void_p), (name, p)


@pytest.mark.parametrize("B", [1, 7, 49, 50, 51, 199, 200, 12_500])
def test_wgrad_plan_depends_on_the_batch_alone(B):
    """dW's split of a member's batch into chunks of images takes B alone
    (no k, no card), covers every image once and makes at most
    WGRAD_CHUNKS chunks."""
    import inspect
    assert list(inspect.signature(conv_ops.wgrad_plan).parameters) == ["B"]
    group, chunks = conv_ops.wgrad_plan(B)
    assert chunks <= conv_ops.WGRAD_CHUNKS
    assert (chunks - 1) * group < B <= chunks * group
