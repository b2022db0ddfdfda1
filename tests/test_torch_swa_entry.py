"""The arguments the swa_attention operators (``kernels/swa_attention/ops.py``)
pass to the C entry points, which pick the kernels by dtype and mode: every
bf16 call, causal or not, goes to the wgmma and TMA kernels of
``csrc/swa_full_fwd.cu`` and ``csrc/swa_full_bwd.cu``; f32 to the CUDA cores.

CPU only: no kernel is built or launched; ``kernels.launch`` is replaced by
a recorder.
"""
import contextlib

import pytest
import torch

from repro_torch import kernels
from repro_torch.kernels.swa_attention import ops

# the reference's threaded tests share the CPU with these workers
torch.set_num_threads(2)


@pytest.fixture
def recorded(monkeypatch):
    """The arguments of every ``kernels.launch`` (nothing launched), with
    ``torch.cuda.device`` made a no-op so the CUDA implementations run on
    CPU tensors."""
    calls = []
    monkeypatch.setattr(kernels, "launch",
                        lambda name, *args, **kw: calls.append((name, args)))
    monkeypatch.setattr(torch.cuda, "device",
                        lambda _d: contextlib.nullcontext())
    return calls


@pytest.mark.parametrize("dt,causal,hd", [
    (torch.bfloat16, True, 128), (torch.bfloat16, True, 20),
    (torch.bfloat16, False, 20), (torch.float32, True, 128),
    (torch.float32, False, 64)])
def test_operators_pass_dtype_and_mode_to_the_entries(recorded, dt, causal,
                                                      hd):
    """The forward's and backward's C entries get the dtype flag (1 =
    bf16, the wgmma kernels) as their last argument (the stream follows
    it, added by the launch), after the scale, and the mode and the window
    clamped to S before it."""
    B, S, H, KV = 2, 40, 4, 2
    W = 16 if causal else S
    q = torch.zeros((B, S, H, hd), dtype=dt)
    k = torch.zeros((B, S, KV, hd), dtype=dt)
    out = torch.zeros_like(q)
    lse = torch.zeros((B, H, S))
    ops._fwd_cuda(q, k, k, W, causal, True)
    ops._bwd_cuda(q, k, k, out, lse, out, W, causal)
    (fname, fargs), (bname, bargs) = recorded
    assert (fname, bname) == ("swa_attention", "swa_attention_bwd")
    assert fargs[-1] == bargs[-1] == (1 if dt == torch.bfloat16 else 0)
    assert fargs[-2] == bargs[-2] == hd ** -0.5
    assert fargs[-3] == bargs[-3] == int(causal)
    assert fargs[-4] == bargs[-4] == W
    assert fargs[-5] == bargs[-5] == hd
