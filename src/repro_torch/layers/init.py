"""Random init of the LM layers from a ``torch.Generator``."""
from __future__ import annotations

import torch


def normal(generator, shape, std, dtype, device):
    """N(0, std²) drawn in f32 on the generator's device, cast to ``dtype``
    and moved to ``device``: the reference's distributions (its
    ``jax.random.normal(...) * std`` then ``astype``), from a torch
    generator, so the numbers differ. A generator on the card draws a
    full-size model there in seconds."""
    w = torch.randn(shape, generator=generator, dtype=torch.float32,
                    device=generator.device)
    return (w * std).to(dtype=dtype, device=device)
