"""Family dispatch for the LM zoo — the port's counterpart of
``repro.models.api``. The transformer families (dense, moe, encoder, vlm)
are ``models.transformer``, RWKV6 is ``models.rwkv6`` and the Zamba2
hybrid ``models.zamba2``; any other family (``ssm_mamba2`` included, which
the reference's dispatch does not carry either) raises ``ValueError``."""
from __future__ import annotations

import torch

from repro_torch.models import rwkv6, transformer, zamba2


def module_of(cfg):
    if cfg.family in transformer.FAMILIES:
        return transformer
    if cfg.family == "ssm_rwkv6":
        return rwkv6
    if cfg.family == "hybrid_zamba2":
        return zamba2
    raise ValueError(f"unknown family {cfg.family}")


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
    mod = module_of(cfg)
    if cfg.family in transformer.FAMILIES:
        return mod.prefill(cfg, params, batch, max_len=max_len)
    return mod.prefill(cfg, params, batch)  # the recurrent state has no length


def decode_step(cfg, params, cache, token, pos):
    return module_of(cfg).decode_step(cfg, params, cache, token, pos)
