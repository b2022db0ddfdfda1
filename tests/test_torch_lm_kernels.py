"""The port's rmsnorm and swa_attention wrappers against the reference's.

On the CPU each wrapper runs its plain PyTorch version; it is held against
the reference's Pallas kernel (interpret mode, as ``test_extensions.py`` and
``test_kernels.py`` run it) and its jnp oracle on the same numpy inputs.
``test_torch_cuda.py`` holds the hand-written CUDA kernels against these
plain versions on the card.

Tolerances: f32 — the same terms summed in another order — rtol 1e-5 and
atol 1e-5 · max|ref|. bf16 outputs — both sides compute in f32 and round
once — one bf16 ulp (2⁻⁷ relative).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.kernels.rmsnorm import ops as jrms
from repro.kernels.swa_attention import ops as jswa
from repro.kernels.swa_attention.ref import swa_attention_ref as jswa_ref
from repro_torch import kernels
from repro_torch.kernels.rmsnorm import ops as rms_ops
from repro_torch.kernels.swa_attention import ops as swa_ops

# the reference's threaded tests share the CPU with these workers
torch.set_num_threads(2)

BF16_ULP = 2.0 ** -7


def _close(got, ref, dtype=np.float32):
    got = np.asarray(got, np.float32)
    ref = np.asarray(ref, np.float32)
    assert got.shape == ref.shape
    if dtype == np.float32:
        np.testing.assert_allclose(got, ref, rtol=1e-5,
                                   atol=1e-5 * float(np.abs(ref).max()))
    else:
        np.testing.assert_allclose(got, ref, rtol=BF16_ULP, atol=1e-30)


def _normal(seed, *shape):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _torch(a, dtype):
    t = torch.from_numpy(a)
    return t.to(torch.bfloat16) if dtype == "bf16" else t


def _jax(a, dtype):
    j = jnp.asarray(a)
    return j.astype(jnp.bfloat16) if dtype == "bf16" else j


# ---------------------------------------------------------------------------
# rmsnorm
# ---------------------------------------------------------------------------

RMS_SHAPES = [(3, 17, 128), (300, 128), (2, 5, 256), (257, 256),
              (3, 4096), (2, 7, 4096)]


@pytest.mark.parametrize("use_pallas", [True, False])
@pytest.mark.parametrize("x_dtype,s_dtype", [("f32", "f32"),
                                             ("bf16", "f32"),
                                             ("bf16", "bf16")])
@pytest.mark.parametrize("shape", RMS_SHAPES)
def test_rmsnorm_plain_matches_reference(shape, x_dtype, s_dtype,
                                         use_pallas):
    x = _normal(sum(shape), *shape) * 3.0
    scale = _normal(shape[-1], shape[-1])
    ref = jrms.rmsnorm(_jax(x, x_dtype), _jax(scale, s_dtype),
                       eps=1e-5, use_pallas=use_pallas)
    before = dict(kernels.LAUNCHES)
    got = rms_ops.rmsnorm(_torch(x, x_dtype), _torch(scale, s_dtype),
                          eps=1e-5)
    assert kernels.LAUNCHES == before        # the CPU runs the plain version
    assert got.dtype == (torch.bfloat16 if x_dtype == "bf16"
                         else torch.float32)
    _close(got.float().numpy(), np.asarray(ref, np.float32),
           np.float32 if x_dtype == "f32" else "bf16")


def test_rmsnorm_rejects_bad_operands():
    x = torch.zeros(4, 8)
    with pytest.raises(ValueError):
        rms_ops.rmsnorm(x, torch.ones(7))
    with pytest.raises(TypeError):
        rms_ops.rmsnorm(x.double(), torch.ones(8))
    with pytest.raises(TypeError):
        rms_ops.rmsnorm(x, torch.ones(8, dtype=torch.float16))


# ---------------------------------------------------------------------------
# sliding-window attention
# ---------------------------------------------------------------------------

def _bshd_to_bh(a):
    """(B, S, H, d) -> (B·H, S, d), the Pallas kernel's layout."""
    B, S, H, d = a.shape
    return a.transpose(0, 2, 1, 3).reshape(B * H, S, d)


def _bh_to_bshd(a, B, H):
    BH, S, d = a.shape
    return np.asarray(a, np.float32).reshape(B, H, S, d).transpose(0, 2, 1, 3)


def _swa_inputs(seed, B, S, H, KV, d):
    q = _normal(seed, B, S, H, d)
    k = _normal(seed + 1, B, S, KV, d)
    v = _normal(seed + 2, B, S, KV, d)
    return q, k, v


def _reference_swa(q, k, v, window, dtype, use_pallas):
    """The reference on the same problem: kv heads repeated to the query
    heads (query head h reads kv head h // (H / KV)), layouts flattened."""
    B, S, H, d = q.shape
    rep = H // k.shape[2]
    kr, vr = np.repeat(k, rep, axis=2), np.repeat(v, rep, axis=2)
    args = [_jax(_bshd_to_bh(a), dtype) for a in (q, kr, vr)]
    if use_pallas is None:
        out = jswa_ref(*args, window=window)
    else:
        out = jswa.swa_attention(*args, window=window, use_pallas=use_pallas)
    return _bh_to_bshd(out, B, H)


@pytest.mark.parametrize("use_pallas", [True, False])
@pytest.mark.parametrize("S,window", [(128, 128), (128, 8), (128, 33),
                                      (256, 256), (256, 8), (256, 33)])
@pytest.mark.parametrize("H,KV,d", [(2, 2, 16), (4, 2, 32)])
def test_swa_plain_matches_reference(S, window, H, KV, d, use_pallas):
    q, k, v = _swa_inputs(S + window + H, 1, S, H, KV, d)
    ref = _reference_swa(q, k, v, window, "f32", use_pallas)
    before = dict(kernels.LAUNCHES)
    got = swa_ops.swa_attention(torch.from_numpy(q), torch.from_numpy(k),
                                torch.from_numpy(v), window=window)
    assert kernels.LAUNCHES == before
    _close(got.numpy(), ref)


@pytest.mark.parametrize("S,window", [(37, 37), (37, 8), (1, 1), (70, 33)])
def test_swa_plain_ragged_matches_jnp_oracle(S, window):
    """Prompts of any length: the Pallas kernel needs S % 128 == 0, so a
    ragged S is held against the jnp oracle only."""
    q, k, v = _swa_inputs(S, 2, S, 4, 2, 16)
    ref = _reference_swa(q, k, v, window, "f32", None)
    got = swa_ops.swa_attention(torch.from_numpy(q), torch.from_numpy(k),
                                torch.from_numpy(v), window=window)
    _close(got.numpy(), ref)


def test_swa_plain_bf16_matches_reference():
    q, k, v = _swa_inputs(5, 1, 128, 4, 2, 32)
    ref = _reference_swa(q, k, v, 40, "bf16", True)
    got = swa_ops.swa_attention(*(_torch(a, "bf16") for a in (q, k, v)),
                                window=40)
    assert got.dtype == torch.bfloat16
    # bf16 inputs, f32 softmax and sums on both sides, one rounding of the
    # output each, after sums taken in another order
    np.testing.assert_allclose(got.float().numpy(), ref, rtol=2 * BF16_ULP,
                               atol=2 * BF16_ULP * float(np.abs(ref).max()))


def test_swa_window_actually_limits():
    """Keys and values outside the last query's window do not move it."""
    q, k, v = _swa_inputs(9, 1, 256, 2, 1, 16)
    w = 32
    a = swa_ops.swa_attention(torch.from_numpy(q), torch.from_numpy(k),
                              torch.from_numpy(v), window=w)
    k2, v2 = k.copy(), v.copy()
    k2[:, :128], v2[:, :128] = 9.99, -9.99
    b = swa_ops.swa_attention(torch.from_numpy(q), torch.from_numpy(k2),
                              torch.from_numpy(v2), window=w)
    np.testing.assert_array_equal(a[:, -1].numpy(), b[:, -1].numpy())


def test_swa_rejects_bad_operands():
    q = torch.zeros(1, 8, 4, 16)
    kv = torch.zeros(1, 8, 2, 16)
    with pytest.raises(ValueError):
        swa_ops.swa_attention(q, torch.zeros(1, 8, 3, 16),
                              torch.zeros(1, 8, 3, 16), window=8)
    with pytest.raises(ValueError):
        swa_ops.swa_attention(q, kv, kv, window=0)
    with pytest.raises(TypeError):
        swa_ops.swa_attention(q, kv.bfloat16(), kv.bfloat16(), window=8)
    with pytest.raises(TypeError):
        swa_ops.swa_attention(q.double(), kv.double(), kv.double(), window=8)
