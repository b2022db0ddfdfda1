"""Learning-rate schedules of the CNN-ELM's SGD epochs — the port's
counterpart of ``repro.optim.schedules`` (``constant``, ``dynamic_paper``;
the LM schedules come with LM training).

A schedule maps the 0-based epoch index to the rate as an f32 value, as
the reference computes it in jnp f32: the paper's α = c / e rounds in f32,
and a Python-double ``c / e`` rounded to f32 afterwards can land one ulp
away (c = 0.05, e = 3), which SGD would then compound over every step.
"""
from __future__ import annotations

import numpy as np


def constant(lr: float):
    def f(step):
        return np.float32(lr)
    return f


def dynamic_paper(c: float):
    """The paper's α = c / e (Section 4.3, Tables 3 and 5), e the 1-based
    epoch index, divided in f32."""
    def f(step):
        e = np.maximum(np.float32(step), np.float32(0.0)) + np.float32(1.0)
        return np.float32(c) / e
    return f
