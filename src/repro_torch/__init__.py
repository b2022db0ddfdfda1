"""PyTorch/CUDA port of the distributed averaging CNN-ELM (``repro``'s twin).

The JAX package ``repro`` is the reference; this package computes the same
functions with PyTorch tensors and hand-written CUDA kernels for Hopper
(``repro_torch/csrc``). It imports neither JAX nor ``repro``: where it needs
one of ``repro``'s numpy-only modules it keeps its own copy.

Layouts are the reference's (NHWC images, HWIO conv kernels, (F, C) β,
features flattened in NHWC order), so parameter trees move between the two
packages without transposes (``repro_torch.convert``).

The device decides the route: a CUDA tensor always goes through the hand
kernel, a CPU tensor through its plain PyTorch version. Entry points take
``device=`` and default to ``"cuda"``; without a CUDA device they raise
unless the caller asked for ``device="cpu"``.
"""
from __future__ import annotations

import torch

# f32 throughout: TF32 keeps ~3 decimal digits, far outside the parity
# bounds held against the reference. cuDNN's flag defaults to True.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def resolve_device(device) -> torch.device:
    """``device`` as a ``torch.device``; raise if it names CUDA and there is
    no CUDA device — the port never quietly runs on the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch versions on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"device must be 'cuda' or 'cpu', got {device!r}")
    return dev
