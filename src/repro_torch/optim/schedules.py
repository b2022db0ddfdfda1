"""Learning-rate schedules — the port's counterpart of
``repro.optim.schedules``: the CNN-ELM's ``constant`` and the paper's
``dynamic_paper``, and the LM schedules ``linear_warmup``, ``cosine`` and
``wsd``.

A schedule maps the 0-based step (or epoch) index to the rate as an f32
value, as the reference computes it in jnp f32: every operand is cast to
f32 first, so each operation rounds to f32 as there. The paper's α = c / e
shows why: a Python-double ``c / e`` rounded to f32 afterwards can land
one ulp away (c = 0.05, e = 3), which SGD would then compound over every
step.
"""
from __future__ import annotations

import numpy as np

_f = np.float32


def constant(lr: float):
    def f(step):
        return _f(lr)
    return f


def dynamic_paper(c: float):
    """The paper's α = c / e (Section 4.3, Tables 3 and 5), e the 1-based
    epoch index, divided in f32."""
    def f(step):
        e = np.maximum(_f(step), _f(0.0)) + _f(1.0)
        return _f(c) / e
    return f


def linear_warmup(base_lr: float, warmup_steps: int):
    def f(step):
        s = _f(step)
        return _f(base_lr) * np.minimum(
            _f(1.0), (s + _f(1.0)) / _f(max(warmup_steps, 1)))
    return f


def cosine(base_lr: float, total_steps: int, warmup_steps: int = 0,
           final_frac: float = 0.1):
    def f(step):
        s = _f(step)
        warm = (np.minimum(_f(1.0), (s + _f(1.0)) / _f(max(warmup_steps, 1)))
                if warmup_steps else _f(1.0))
        prog = np.clip((s - _f(warmup_steps))
                       / _f(max(total_steps - warmup_steps, 1)),
                       _f(0.0), _f(1.0))
        cos = _f(final_frac) + _f(1 - final_frac) * _f(0.5) * (
            _f(1.0) + np.cos(_f(np.pi) * prog))
        return _f(base_lr) * warm * cos
    return f


def wsd(base_lr: float, warmup_steps: int, stable_steps: int,
        decay_steps: int, final_frac: float = 0.01):
    """Warmup-Stable-Decay (MiniCPM): linear warmup, a constant rate, then
    an exponential-style decay to ``final_frac`` of it."""
    def f(step):
        s = _f(step)
        if s < warmup_steps:
            return _f(base_lr) * (s + _f(1.0)) / _f(max(warmup_steps, 1))
        if s < warmup_steps + stable_steps:
            return _f(base_lr)
        prog = np.clip((s - _f(warmup_steps) - _f(stable_steps))
                       / _f(max(decay_steps, 1)), _f(0.0), _f(1.0))
        return _f(base_lr) * np.power(_f(final_frac), prog)
    return f
