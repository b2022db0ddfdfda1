"""The SwiGLU feed-forward of the dense decoders — the port's counterpart
of ``repro.layers.mlp`` (the MoE layer comes with the MoE family).

Weights are (in, out), optionally stacked with a leading layer dim, and
applied as ``x @ W``.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.layers.init import normal


def init_swiglu(d_model: int, d_ff: int, generator, dtype=torch.bfloat16,
                num_layers: int | None = None, device="cuda"):
    lead = () if num_layers is None else (num_layers,)
    return {
        "w_gate": normal(generator, lead + (d_model, d_ff), d_model ** -0.5,
                         dtype, device),
        "w_up": normal(generator, lead + (d_model, d_ff), d_model ** -0.5,
                       dtype, device),
        "w_down": normal(generator, lead + (d_ff, d_model), d_ff ** -0.5,
                         dtype, device),
    }


def swiglu(p, x):
    h = F.silu((x @ p["w_gate"]).float())
    h = h * (x @ p["w_up"]).float()
    return h.to(x.dtype) @ p["w_down"]
