"""Family dispatch for the LM zoo — the port's counterpart of
``repro.models.api``. The dense decoder is ported; every other family
raises ``NotImplementedError`` naming the ROADMAP item that brings it."""
from __future__ import annotations

import torch

from repro_torch.models import transformer


def module_of(cfg):
    if cfg.family == "dense":
        return transformer
    raise NotImplementedError(transformer.UNPORTED.format(cfg.family))


def init_params(cfg, generator, dtype=torch.bfloat16, device="cuda"):
    return module_of(cfg).init_params(cfg, generator, dtype, device)


def loss_fn(cfg, params, batch):
    return module_of(cfg).loss_fn(cfg, params, batch)


def hidden_states(cfg, params, batch):
    return module_of(cfg).hidden_states(cfg, params, batch)


def init_cache(cfg, batch: int, seq_len: int, dtype=torch.bfloat16,
               device="cuda"):
    return module_of(cfg).init_cache(cfg, batch, seq_len, dtype, device)


def prefill(cfg, params, batch, max_len: int | None = None):
    return module_of(cfg).prefill(cfg, params, batch, max_len=max_len)


def decode_step(cfg, params, cache, token, pos):
    return module_of(cfg).decode_step(cfg, params, cache, token, pos)
