"""The dense GQA decoder (qwen3-style): init, full forward, the final
hidden states (the ELM head's H), prefill and one-token decode — the
port's counterpart of ``repro.models.transformer`` for family ``dense``
(MoE, encoder and VLM come with their families).

Layers are stacked (a leading L dim on every leaf of ``params["layers"]``)
as in the reference, so trees convert leaf by leaf; the reference's
``layer_scan`` becomes a Python loop over views of the stacked leaves.
Every rms_norm goes through the rmsnorm kernel and every prefill attention
through the swa_attention kernel on the card.
"""
from __future__ import annotations

import torch

from repro_torch import resolve_device
from repro_torch.layers import attention as attn
from repro_torch.layers import mlp as mlp_lib
from repro_torch.layers.init import normal
from repro_torch.layers.norms import rms_norm
from repro_torch.tree import tree_map

NEG_INF = -1e30
UNPORTED = ("family {!r} is not ported yet (ROADMAP queue 1 item 13, the "
            "LM model zoo: only the dense decoder is ported)")


def _require_dense(cfg):
    if cfg.family != "dense" or cfg.is_encoder_only or cfg.frontend:
        raise NotImplementedError(UNPORTED.format(cfg.family))


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def init_params(cfg, generator, dtype=torch.bfloat16, device="cuda"):
    """The reference's distributions from a ``torch.Generator``, drawn on
    the generator's device (a CUDA generator draws a full-size model on the
    card) and stored on ``device``. Padded vocab rows are zero."""
    _require_dense(cfg)
    dev = resolve_device(device)
    L, D, V = cfg.num_layers, cfg.d_model, cfg.padded_vocab
    layers = {
        "attn": attn.init_attention(cfg, generator, dtype, num_layers=L,
                                    device=dev),
        "ln1": torch.ones((L, D), dtype=torch.float32, device=dev),
        "ln2": torch.ones((L, D), dtype=torch.float32, device=dev),
        "mlp": mlp_lib.init_swiglu(D, cfg.d_ff, generator, dtype,
                                   num_layers=L, device=dev),
    }
    embed = normal(generator, (V, D), D ** -0.5, dtype, dev)
    if V > cfg.vocab_size:
        embed[cfg.vocab_size:] = 0
    p = {
        "embed": embed,
        "final_norm": torch.ones((D,), dtype=torch.float32, device=dev),
        "layers": layers,
    }
    if not cfg.tie_embeddings:
        p["unembed"] = normal(generator, (D, V), D ** -0.5, dtype, dev)
    return p


def _mask_padded_logits(cfg, logits):
    """-1e30 on padded vocab slots."""
    if cfg.padded_vocab == cfg.vocab_size:
        return logits
    idx = torch.arange(logits.shape[-1], device=logits.device)
    return torch.where(idx < cfg.vocab_size, logits,
                       torch.full_like(logits, NEG_INF))


def _layer(layers, i):
    return tree_map(lambda a: a[i], layers)


def _unembed(cfg, p, x):
    unembed = p["embed"].T if cfg.tie_embeddings else p["unembed"]
    return _mask_padded_logits(cfg, (x @ unembed).float())


# ---------------------------------------------------------------------------
# blocks
# ---------------------------------------------------------------------------

def _block(cfg, lp, x, positions, window):
    """One decoder block; returns (x, (k, v))."""
    h, kv = attn.attn_forward(cfg, lp["attn"],
                              rms_norm(x, lp["ln1"], cfg.norm_eps),
                              positions, window=window)
    x = x + h
    h = mlp_lib.swiglu(lp["mlp"], rms_norm(x, lp["ln2"], cfg.norm_eps))
    return x + h, kv


def _embed_inputs(cfg, p, batch):
    """Token embedding. Returns (x, positions, text_offset)."""
    _require_dense(cfg)
    tokens = batch["tokens"]
    x = p["embed"][tokens]
    B, S = x.shape[:2]
    pos = torch.arange(S, device=x.device).expand(B, S)
    return x, pos, 0


def forward(cfg, p, batch, *, window: int | None = None):
    """Full-sequence forward. Returns (logits f32, aux_loss)."""
    x = hidden_states(cfg, p, batch, window=window)
    return _unembed(cfg, p, x), torch.zeros((), device=x.device)


def hidden_states(cfg, p, batch, *, window: int | None = None):
    """Final-norm hidden states (B, S, D), no unembed — the ELM head's H.
    The reference's remat is a memory policy of its autodiff and has no
    counterpart here."""
    window = cfg.sliding_window if window is None else window
    x, positions, _ = _embed_inputs(cfg, p, batch)
    for i in range(cfg.num_layers):
        x, _ = _block(cfg, _layer(p["layers"], i), x, positions, window)
    return rms_norm(x, p["final_norm"], cfg.norm_eps)


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------

def init_cache(cfg, batch: int, seq_len: int, dtype=torch.bfloat16,
               device="cuda"):
    _require_dense(cfg)
    return attn.init_kv_cache(cfg, batch, seq_len, cfg.num_layers, dtype,
                              resolve_device(device))


def prefill(cfg, p, batch, max_len: int | None = None):
    """Encode a prompt, returning last-position logits + the KV cache.
    ``max_len`` pads the cache so decoding can continue past the prompt."""
    x, positions, _ = _embed_inputs(cfg, p, batch)
    window = cfg.sliding_window
    ks, vs = [], []
    for i in range(cfg.num_layers):
        x, (k, v) = _block(cfg, _layer(p["layers"], i), x, positions, window)
        ks.append(k)
        vs.append(v)
    ks, vs = torch.stack(ks), torch.stack(vs)
    x = rms_norm(x[:, -1:], p["final_norm"], cfg.norm_eps)
    logits = _unembed(cfg, p, x)
    if cfg.sliding_window and ks.shape[2] > cfg.sliding_window:
        ks = ks[:, :, -cfg.sliding_window:].contiguous()
        vs = vs[:, :, -cfg.sliding_window:].contiguous()
    if max_len is not None and not cfg.sliding_window:
        pad = max_len - ks.shape[2]
        if pad > 0:  # decode headroom beyond the prompt
            ks = torch.nn.functional.pad(ks, (0, 0, 0, 0, 0, pad))
            vs = torch.nn.functional.pad(vs, (0, 0, 0, 0, 0, pad))
    return logits, {"k": ks, "v": vs}


def decode_step(cfg, p, cache, token, pos: int):
    """One new token against the KV cache. token: (B, 1) integers; pos: the
    tokens so far. Returns (logits, cache); the cache is updated in place
    (see ``attention.attn_decode``)."""
    _require_dense(cfg)
    x = p["embed"][token]
    for i in range(cfg.num_layers):
        lp = _layer(p["layers"], i)
        h, _ = attn.attn_decode(cfg, lp["attn"],
                                rms_norm(x, lp["ln1"], cfg.norm_eps),
                                (cache["k"][i], cache["v"][i]), pos)
        x = x + h
        x = x + mlp_lib.swiglu(lp["mlp"], rms_norm(x, lp["ln2"],
                                                   cfg.norm_eps))
    x = rms_norm(x, p["final_norm"], cfg.norm_eps)
    return _unembed(cfg, p, x), cache
