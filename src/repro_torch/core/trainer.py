"""The LM serving steps — the port's counterpart of the serving half of
``repro.core.trainer`` (``make_prefill_step``, ``make_serve_step``); the
training steps come with the LM training slice. PyTorch runs eagerly, so
a step is the plain function the reference would jit."""
from __future__ import annotations

from repro_torch.models import api


def make_serve_step(cfg):
    def serve_step(params, cache, token, pos):
        return api.decode_step(cfg, params, cache, token, pos)

    return serve_step


def make_prefill_step(cfg):
    def prefill_step(params, batch):
        return api.prefill(cfg, params, batch)

    return prefill_step
