"""Zamba2-style hybrid: a Mamba2 backbone with ONE shared attention+MLP
block invoked every ``cfg.shared_attn_every`` layers [arXiv:2411.15242];
the port's counterpart of ``repro.models.zamba2``.

The shared block's weights are one tree used at every invocation, but each
invocation keeps its own KV cache slot during decoding. The shared
attention is the causal sliding-window attention (cfg.sliding_window)
through the swa_attention kernel on the card; every rms_norm, the Mamba2
gate norm included, goes through the rmsnorm kernel (and, under autograd,
both through their backward kernels).

Layer plan for L layers, every=k:  [k mamba] [shared] [k mamba] [shared] ...
with the remainder (L mod k) mamba layers at the end.

As in the reference, ``prefill`` sizes each invocation's KV slot to
W = min(S, sliding_window), the prompt's length, and decoding continues
from that cache: each decode step then overwrites slot pos % S, so after a
prefill the shared attention sees the last S positions, not the window
(ROADMAP R7; both packages compute it, and a test pins it).
"""
from __future__ import annotations

import torch

from repro_torch import resolve_device
from repro_torch.distributed import ctx
from repro_torch.layers import attention as attn
from repro_torch.layers import mlp as mlp_lib
from repro_torch.layers import ssm
from repro_torch.layers.init import normal
from repro_torch.layers.norms import rms_norm
from repro_torch.models.transformer import _unbound_layers


def _plan(cfg):
    """Stage sizes (mamba layers per stage); a shared-attn invocation
    follows every stage of the full size."""
    k, L = cfg.shared_attn_every, cfg.num_layers
    sizes, rem = [], L
    while rem > 0:
        sizes.append(min(k, rem))
        rem -= min(k, rem)
    return sizes


def num_attn_invocations(cfg):
    return sum(1 for s in _plan(cfg) if s == cfg.shared_attn_every)


def init_params(cfg, generator, dtype=torch.bfloat16, device="cuda"):
    """The reference's distributions from a ``torch.Generator``, drawn on
    the generator's device and stored on ``device``."""
    dev = resolve_device(device)
    L, D, V = cfg.num_layers, cfg.d_model, cfg.vocab_size

    def ones(*shape):
        return torch.ones(shape, dtype=torch.float32, device=dev)

    return {
        "embed": normal(generator, (V, D), D ** -0.5, dtype, dev),
        "unembed": normal(generator, (D, V), D ** -0.5, dtype, dev),
        "final_norm": ones(D),
        "mamba": {
            "mix": ssm.init_mamba2(cfg, generator, dtype, num_layers=L,
                                   device=dev),
            "ln": ones(L, D),
        },
        "shared": {
            "attn": attn.init_attention(cfg, generator, dtype, device=dev),
            "ln1": ones(D),
            "mlp": mlp_lib.init_swiglu(D, cfg.d_ff, generator, dtype,
                                       device=dev),
            "ln2": ones(D),
        },
    }


def logical_axes(cfg):
    """The logical axes of every leaf of ``init_params(cfg)``, the
    reference's. Under a mesh context the forward paths refuse: Zamba2's
    sharded execution is a later slice."""
    return {
        "embed": ("vocab", "embed"),
        "unembed": ("embed", "vocab"),
        "final_norm": ("embed",),
        "mamba": {
            "mix": ssm.mamba2_logical(stacked=True),
            "ln": ("layers", "embed"),
        },
        "shared": {
            "attn": attn.attention_logical(cfg, stacked=False),
            "ln1": ("embed",),
            "mlp": mlp_lib.swiglu_logical(stacked=False),
            "ln2": ("embed",),
        },
    }


def cache_logical(cfg):
    return {"h": ("layers", "batch", "ssm_heads", None, None),
            "conv": ("layers", "batch", None, "ssm_heads"),
            "k": (None, "batch", "kv_seq", "kv_heads", "head_dim"),
            "v": (None, "batch", "kv_seq", "kv_heads", "head_dim")}


def _stages(cfg, p):
    """(start, size, the stage's per-layer trees) for each stage."""
    layers = _unbound_layers(p["mamba"], cfg.num_layers)
    start, out = 0, []
    for size in _plan(cfg):
        out.append((start, size, layers[start:start + size]))
        start += size
    return out


def _positions(x):
    B, S = x.shape[:2]
    return torch.arange(S, device=x.device).expand(B, S)


def _shared_block(cfg, sp, x, positions):
    """The shared attention + SwiGLU block: (x, (k, v))."""
    h, kv = attn.attn_forward(cfg, sp["attn"],
                              rms_norm(x, sp["ln1"], cfg.norm_eps),
                              positions, window=cfg.sliding_window)
    x = x + h
    h = mlp_lib.swiglu(sp["mlp"], rms_norm(x, sp["ln2"], cfg.norm_eps))
    return x + h, kv


def _encode(cfg, p, batch):
    """The layers over the embedded tokens, before the final norm."""
    x = p["embed"][batch["tokens"]]
    positions = _positions(x)
    for _, size, stage in _stages(cfg, p):
        for lp in stage:
            h, _ = ssm.mamba2_forward(cfg, lp["mix"],
                                      rms_norm(x, lp["ln"], cfg.norm_eps))
            x = x + h
        if size == cfg.shared_attn_every:
            x, _ = _shared_block(cfg, p["shared"], x, positions)
    return x


def _unembed(p, x):
    return (x @ p["unembed"]).float()


def forward(cfg, p, batch):
    """Full-sequence forward: (logits f32, aux 0)."""
    ctx.refuse("Zamba2")
    x = rms_norm(_encode(cfg, p, batch), p["final_norm"], cfg.norm_eps)
    logits = _unembed(p, x)
    return logits, torch.zeros((), device=logits.device)


def hidden_states(cfg, p, batch):
    """The final-norm hidden states (B, S, D) — the ELM head's H."""
    ctx.refuse("Zamba2")
    return rms_norm(_encode(cfg, p, batch), p["final_norm"], cfg.norm_eps)


def loss_fn(cfg, p, batch):
    ctx.refuse("Zamba2")
    logits, _ = forward(cfg, p, batch)
    tgt = batch["targets"].long()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, tgt[..., None])[..., 0]
    ce = torch.mean(logz - gold)
    return ce, {"ce": ce, "aux": torch.zeros((), device=ce.device)}


def prefill(cfg, p, batch):
    """Encode a prompt; returns (last-position logits, decode cache). Each
    invocation's KV slot holds the last W = min(S, sliding_window)
    positions (the reference's sizing: R7)."""
    ctx.refuse("Zamba2")
    x = p["embed"][batch["tokens"]]
    B, S = x.shape[:2]
    positions = _positions(x)
    W = min(S, cfg.sliding_window) if cfg.sliding_window else S
    hs, convs, kss, vss = [], [], [], []
    for _, size, stage in _stages(cfg, p):
        for lp in stage:
            y, st = ssm.mamba2_forward(cfg, lp["mix"],
                                       rms_norm(x, lp["ln"], cfg.norm_eps))
            x = x + y
            hs.append(st["h"])
            convs.append(st["conv"])
        if size == cfg.shared_attn_every:
            x, (k, v) = _shared_block(cfg, p["shared"], x, positions)
            kss.append(k[:, -W:])
            vss.append(v[:, -W:])
    x = rms_norm(x[:, -1:], p["final_norm"], cfg.norm_eps)
    logits = _unembed(p, x)
    if kss:
        k_cache, v_cache = torch.stack(kss), torch.stack(vss)
    else:  # tiny configs may have no shared-attn invocation at all
        k_cache = torch.zeros((0, B, W, cfg.num_kv_heads, cfg.head_dim),
                              dtype=x.dtype, device=x.device)
        v_cache = k_cache
    return logits, {"h": torch.stack(hs), "conv": torch.stack(convs),
                    "k": k_cache, "v": v_cache}


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------

def init_cache(cfg, batch: int, seq_len: int, dtype=torch.bfloat16,
               device="cuda"):
    ctx.refuse("Zamba2")
    dev = resolve_device(device)
    L = cfg.num_layers
    H, P, N = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state
    din = H * P
    I = num_attn_invocations(cfg)
    W = min(seq_len, cfg.sliding_window) if cfg.sliding_window else seq_len
    kv = (I, batch, W, cfg.num_kv_heads, cfg.head_dim)
    return {
        "h": torch.zeros((L, batch, H, P, N), dtype=torch.float32,
                         device=dev),
        "conv": torch.zeros((L, batch, ssm.CONV_W - 1, din), dtype=dtype,
                            device=dev),
        "k": torch.zeros(kv, dtype=dtype, device=dev),
        "v": torch.zeros(kv, dtype=dtype, device=dev),
    }


def decode_step(cfg, p, cache, token, pos):
    """One new token. Returns (logits, cache); the cache's tensors are
    updated in place (the reference donates its cache to the step, so
    nothing reads the old one) and returned."""
    ctx.refuse("Zamba2")
    x = p["embed"][token]  # (B, 1, D)
    inv = 0
    for start, size, stage in _stages(cfg, p):
        for j, lp in enumerate(stage):
            i = start + j
            y, ns = ssm.mamba2_decode(cfg, lp["mix"],
                                      rms_norm(x, lp["ln"], cfg.norm_eps),
                                      {"h": cache["h"][i],
                                       "conv": cache["conv"][i]})
            x = x + y
            cache["h"][i] = ns["h"]
            cache["conv"][i] = ns["conv"]
        if size == cfg.shared_attn_every:
            sp = p["shared"]
            y, _ = attn.attn_decode(cfg, sp["attn"],
                                    rms_norm(x, sp["ln1"], cfg.norm_eps),
                                    (cache["k"][inv], cache["v"][inv]), pos)
            x = x + y
            y = mlp_lib.swiglu(sp["mlp"], rms_norm(x, sp["ln2"],
                                                   cfg.norm_eps))
            x = x + y
            inv += 1
    x = rms_norm(x, p["final_norm"], cfg.norm_eps)
    return _unembed(p, x), cache
