"""The conv's gradients in the port against the reference's autodiff.

The reference has no Pallas backward: its SGD path differentiates the
``lax.conv`` route (``conv2d_valid(..., use_pallas=False)``). Here the
port's plain dX (col2im of dY·Wᵀ) and dW (patchesᵀ·dY) — what a CPU tensor
takes, and what ``tests/test_torch_cuda.py`` holds the card's kernels
against — are held against ``jax.vjp`` of that route on the same numpy
inputs, at the stages of both configurations, their reduced forms, and a
ragged shape, and the autograd ``Conv2dValid`` around them is checked.

Tolerance: f32 sums of the same terms in another order — rtol 1e-5 and
atol 1e-5 · max|ref|.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.kernels.conv2d import ops as jconv
from repro_torch.kernels.conv2d import ops as conv_ops, ref as conv_ref

# the reference's threaded tests share the CPU with these workers
torch.set_num_threads(2)

# (k, B, H, W, Cin, kernel, Cout)
SHAPES = [
    (2, 3, 28, 28, 1, 5, 6),     # 6c-12c stage 1
    (2, 3, 12, 12, 6, 5, 12),    # 6c-12c stage 2
    (2, 3, 28, 28, 1, 5, 3),     # 3c-9c stage 1
    (2, 3, 12, 12, 3, 5, 9),     # 3c-9c stage 2
    (3, 2, 12, 12, 2, 5, 4),     # the reduced configs' stage 2
    (2, 3, 9, 11, 3, 3, 5),      # ragged: a 3x3 kernel, H != W
]


def _close(got, ref):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=1e-5,
                               atol=1e-5 * float(np.abs(ref).max()))


def _data(seed, k, b, h, w, cin, kk, cout):
    rng = np.random.default_rng(seed)
    x = rng.random((k, b, h, w, cin), dtype=np.float32)
    wt = (rng.normal(size=(k, kk, kk, cin, cout)) * 0.2).astype(np.float32)
    dy = rng.normal(size=(k, b, h - kk + 1, w - kk + 1, cout)
                    ).astype(np.float32)
    return x, wt, dy


def _reference_grads(x, wt, dy):
    """Per member: (dX, dW) of the reference's lax.conv route by jax.vjp."""
    dxs, dws = [], []
    for i in range(x.shape[0]):
        _, vjp = jax.vjp(lambda a, b: jconv.conv2d_valid(a, b,
                                                         use_pallas=False),
                         jnp.asarray(x[i]), jnp.asarray(wt[i]))
        dx, dw = vjp(jnp.asarray(dy[i]))
        dxs.append(np.asarray(dx))
        dws.append(np.asarray(dw))
    return np.stack(dxs), np.stack(dws)


@pytest.mark.parametrize("shape", SHAPES)
def test_plain_grads_match_reference_vjp(shape):
    x, wt, dy = _data(sum(shape), *shape)
    jdx, jdw = _reference_grads(x, wt, dy)
    kk = shape[5]
    dw = conv_ops.conv2d_weight_grad(torch.from_numpy(x),
                                     torch.from_numpy(dy), kk, kk)
    dx = conv_ops.conv2d_input_grad(torch.from_numpy(dy),
                                    torch.from_numpy(wt))
    _close(dw.numpy(), jdw)
    _close(dx.numpy(), jdx)


@pytest.mark.parametrize("shape", SHAPES[:2] + SHAPES[-1:])
def test_autograd_through_conv_matches_reference(shape):
    """Conv2dValid's backward gives the plain versions' gradients exactly,
    and so the reference's within the bar; dX is left out (None) where the
    input needs no gradient, as stage 1's images never do."""
    x, wt, dy = _data(sum(shape) + 1, *shape)
    jdx, jdw = _reference_grads(x, wt, dy)
    xt = torch.from_numpy(x).requires_grad_(True)
    wtt = torch.from_numpy(wt).requires_grad_(True)
    y = conv_ops.conv2d_valid(xt, wtt)
    y.backward(torch.from_numpy(dy))
    kk = shape[5]
    assert torch.equal(wtt.grad, conv_ref.conv2d_weight_grad_ref(
        torch.from_numpy(x), torch.from_numpy(dy), kk, kk))
    assert torch.equal(xt.grad, conv_ref.conv2d_input_grad_ref(
        torch.from_numpy(dy), torch.from_numpy(wt)))
    _close(wtt.grad.numpy(), jdw)
    _close(xt.grad.numpy(), jdx)

    images = torch.from_numpy(x)
    wtt.grad = None
    (conv_ops.conv2d_valid(images, wtt) * torch.from_numpy(dy)).sum(
        ).backward()
    assert images.grad is None and torch.equal(wtt.grad, conv_ref.
                                               conv2d_weight_grad_ref(
                                                   images,
                                                   torch.from_numpy(dy),
                                                   kk, kk))


def test_one_member_form_is_differentiable():
    """The 4-d (one member) call differentiates through the same Function."""
    x, wt, dy = _data(5, 1, 4, 12, 12, 6, 5, 12)
    w1 = torch.from_numpy(wt[0]).requires_grad_(True)
    (conv_ops.conv2d_valid(torch.from_numpy(x[0]), w1)
     * torch.from_numpy(dy[0])).sum().backward()
    assert w1.grad.shape == (5, 5, 6, 12)
    assert torch.equal(w1.grad, conv_ref.conv2d_weight_grad_ref(
        torch.from_numpy(x), torch.from_numpy(dy), 5, 5)[0])


@pytest.mark.parametrize("shape", SHAPES[:2])
def test_member_batched_grads_equal_member_loop(shape):
    """Member i of a batched gradient is exactly the one-member call's."""
    x, wt, dy = _data(9, 3, *shape[1:])
    xt, wtt, dyt = (torch.from_numpy(a) for a in (x, wt, dy))
    kk = shape[5]
    dw = conv_ops.conv2d_weight_grad(xt, dyt, kk, kk)
    dx = conv_ops.conv2d_input_grad(dyt, wtt)
    for i in range(3):
        assert torch.equal(dw[i], conv_ops.conv2d_weight_grad(
            xt[i:i + 1], dyt[i:i + 1], kk, kk)[0])
        assert torch.equal(dx[i], conv_ops.conv2d_input_grad(
            dyt[i:i + 1], wtt[i:i + 1])[0])


@pytest.mark.parametrize("x_shape,dy_shape,kk,exc", [
    ((2, 3, 12, 12, 6), (2, 3, 8, 8), 5, ValueError),        # dy rank
    ((2, 3, 12, 12, 6), (2, 3, 7, 8, 12), 5, ValueError),    # dy rows
    ((2, 3, 12, 12, 6), (1, 3, 8, 8, 12), 5, ValueError),    # members
])
def test_weight_grad_rejects_bad_shapes(x_shape, dy_shape, kk, exc):
    with pytest.raises(exc):
        conv_ops.conv2d_weight_grad(torch.zeros(x_shape),
                                    torch.zeros(dy_shape), kk, kk)


def test_grads_reject_other_dtypes_and_shapes():
    with pytest.raises(TypeError):
        conv_ops.conv2d_weight_grad(
            torch.zeros((1, 2, 8, 8, 1), dtype=torch.float64),
            torch.zeros((1, 2, 4, 4, 3), dtype=torch.float64), 5, 5)
    with pytest.raises(ValueError):
        conv_ops.conv2d_input_grad(torch.zeros((1, 2, 4, 4, 3)),
                                   torch.zeros((1, 5, 5, 1, 2)))
