"""Activations of the ELM head (f32 math, cast back to the input dtype).
The port's counterpart of ``repro.layers.norms``; the LM norms come with
the LM slice."""
from __future__ import annotations

import torch


def optimal_tanh(h):
    """The paper's ELM feature activation: 1.7159 * tanh(2/3 * H)
    (LeCun, 'Efficient BackProp')."""
    hf = h.float()
    return (1.7159 * torch.tanh(hf * (2.0 / 3.0))).to(h.dtype)
