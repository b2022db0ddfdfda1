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
from torch.utils.checkpoint import checkpoint

from repro_torch import resolve_device
from repro_torch.distributed import ctx
from repro_torch.layers import attention as attn
from repro_torch.layers import mlp as mlp_lib
from repro_torch.layers import ssm
from repro_torch.layers.init import normal
from repro_torch.layers.norms import rms_norm
from repro_torch.models import common


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
    reference's."""
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
    """The cache's logical axes; its stacked layer and invocation dims
    are unnamed, as the KV cache's (``layers/attention.py``
    ``kv_cache_logical``)."""
    return {"h": (None, "batch", "ssm_heads", None, None),
            "conv": (None, "batch", None, "ssm_heads"),
            "k": (None, "batch", "kv_seq", "kv_heads", "head_dim"),
            "v": (None, "batch", "kv_seq", "kv_heads", "head_dim")}


def _stages(cfg):
    """(the stage's layer indices, whether the shared block follows it)
    for each stage."""
    start, out = 0, []
    for size in _plan(cfg):
        out.append((range(start, start + size),
                    size == cfg.shared_attn_every))
        start += size
    return out


def _positions(x):
    B, S = x.shape[:2]
    return torch.arange(S, device=x.device).expand(B, S)


def _embed(cfg, p, tokens):
    x = common.embed_tokens(common.weights(cfg, p, "embed"), tokens,
                            cfg.vocab_size)
    return ctx.maybe_constrain(x, ("batch", None, None),
                               have=(ctx.batch_entry(), None, None))


def _mamba_block(cfg, lp, x):
    """One mamba layer: (x, its state)."""
    h, state = ssm.mamba2_forward(cfg, lp["mix"],
                                  rms_norm(x, lp["ln"], cfg.norm_eps))
    return x + h, state


def _shared_block(cfg, p, x, positions):
    """The shared attention + SwiGLU block: (x, (k, v)); its weights made
    whole where it is applied (``common.weights``: a rule override's
    FSDP), and dropped after, but for what autograd keeps."""
    sp = common.weights(cfg, p, "shared")
    h, kv = attn.attn_forward(cfg, sp["attn"],
                              rms_norm(x, sp["ln1"], cfg.norm_eps),
                              positions, window=cfg.sliding_window)
    x = x + h
    h = mlp_lib.swiglu(sp["mlp"], rms_norm(x, sp["ln2"], cfg.norm_eps),
                       d_ff=cfg.d_ff)
    return x + h, kv


def _encode(cfg, p, batch, remat: bool = True):
    """The layers over the embedded tokens, then the final norm. With
    ``remat`` and grad enabled each mamba block runs under
    ``torch.utils.checkpoint`` (the module's docstring); the shared block
    does not, as in the reference."""
    x = _embed(cfg, p, batch["tokens"])
    positions = _positions(x)

    stack = common.LayerStack(cfg, p, "mamba")

    def mamba(x, lp, i):
        return _mamba_block(cfg, stack.whole(lp, i), x)[0]

    for stage, shared in _stages(cfg):
        for i in stage:
            if remat and torch.is_grad_enabled():
                x = checkpoint(mamba, x, stack[i], i, use_reentrant=False)
            else:
                x = mamba(x, stack[i], i)
        if shared:
            x, _ = _shared_block(cfg, p, x, positions)
    return rms_norm(x, common.weights(cfg, p, "final_norm"), cfg.norm_eps)


def _vocab_entry(cfg):
    return common.vocab_entry(cfg.vocab_size, cfg.d_model)


def _unembed(cfg, p, x):
    return common.unembed(x, common.weights(cfg, p, "unembed"),
                          _vocab_entry(cfg))


def forward(cfg, p, batch, *, remat: bool = True):
    """Full-sequence forward: (logits f32, aux 0); under a mesh context
    this rank's vocab columns."""
    logits = _unembed(cfg, p, _encode(cfg, p, batch, remat))
    return logits, torch.zeros((), device=logits.device)


def hidden_states(cfg, p, batch, *, remat: bool = True):
    """The final-norm hidden states (B, S, D) — the ELM head's H."""
    return _encode(cfg, p, batch, remat)


def loss_fn(cfg, p, batch, *, remat: bool = True):
    """The mean next-token cross-entropy (over the global batch, on this
    rank's vocab columns under a mesh context: ``common.cross_entropy``)."""
    logits, _ = forward(cfg, p, batch, remat=remat)
    ce = common.cross_entropy(logits, batch["targets"], _vocab_entry(cfg))
    return ce, {"ce": ce, "aux": torch.zeros((), device=ce.device)}


def prefill(cfg, p, batch):
    """Encode a prompt; returns (last-position logits, decode cache). Each
    invocation's KV slot holds the last W = min(S, sliding_window)
    positions (the reference's sizing: R7); under a mesh context the
    cache is this rank's blocks and W the declared cache length."""
    x = _embed(cfg, p, batch["tokens"])
    B, S = x.shape[:2]
    positions = _positions(x)
    W = min(S, cfg.sliding_window) if cfg.sliding_window else S
    ctx.declare(cache_len=W)
    hs, convs, kss, vss = [], [], [], []
    stack = common.LayerStack(cfg, p, "mamba")
    for stage, shared in _stages(cfg):
        for i in stage:
            x, st = _mamba_block(cfg, stack.layer(i), x)
            hs.append(st["h"])
            convs.append(st["conv"])
        if shared:
            x, (k, v) = _shared_block(cfg, p, x, positions)
            kss.append(attn.cache_block(cfg, k, W))
            vss.append(attn.cache_block(cfg, v, W))
    x = rms_norm(x[:, -1:], common.weights(cfg, p, "final_norm"),
                 cfg.norm_eps)
    logits = _unembed(cfg, p, x)
    if kss:
        k_cache, v_cache = torch.stack(kss), torch.stack(vss)
    else:  # tiny configs may have no shared-attn invocation at all
        k_cache = torch.zeros(
            (0,) + ctx.block_shape((ctx.global_size("batch", B), W,
                                    cfg.num_kv_heads, cfg.head_dim),
                                   cache_logical(cfg)["k"][1:]),
            dtype=x.dtype, device=x.device)
        v_cache = k_cache
    return logits, {"h": torch.stack(hs), "conv": torch.stack(convs),
                    "k": k_cache, "v": v_cache}


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------

def init_cache(cfg, batch: int, seq_len: int, dtype=torch.bfloat16,
               device="cuda"):
    """The zero cache of a global ``batch`` and ``seq_len``; under a mesh
    context this rank's blocks of it (and the global batch and KV length
    declared)."""
    dev = resolve_device(device)
    L = cfg.num_layers
    H, P, N = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state
    din = H * P
    I = num_attn_invocations(cfg)
    W = min(seq_len, cfg.sliding_window) if cfg.sliding_window else seq_len
    ctx.declare(batch=batch, cache_len=W)
    kv = (I, batch, W, cfg.num_kv_heads, cfg.head_dim)
    shapes = {"h": ((L, batch, H, P, N), torch.float32),
              "conv": ((L, batch, ssm.CONV_W - 1, din), dtype),
              "k": (kv, dtype), "v": (kv, dtype)}
    logical = cache_logical(cfg)
    return {name: torch.zeros(ctx.block_shape(shape, logical[name]),
                              dtype=dt, device=dev)
            for name, (shape, dt) in shapes.items()}


def decode_step(cfg, p, cache, token, pos):
    """One new token. Returns (logits, cache); the cache's tensors are
    updated in place (the reference donates its cache to the step, so
    nothing reads the old one) and returned. Under a mesh context the
    cache and the token are this rank's blocks and the logits come out
    whole over the vocab."""
    x = _embed(cfg, p, token)  # (B, 1, D)
    inv = 0
    stack = common.LayerStack(cfg, p, "mamba")
    for stage, shared in _stages(cfg):
        for i in stage:
            lp = stack.layer(i)
            y, ns = ssm.mamba2_decode(cfg, lp["mix"],
                                      rms_norm(x, lp["ln"], cfg.norm_eps),
                                      {"h": cache["h"][i],
                                       "conv": cache["conv"][i]})
            x = x + y
            cache["h"][i] = ns["h"]
            cache["conv"][i] = ns["conv"]
        if shared:
            sp = common.weights(cfg, p, "shared")
            y, _ = attn.attn_decode(cfg, sp["attn"],
                                    rms_norm(x, sp["ln1"], cfg.norm_eps),
                                    (cache["k"][inv], cache["v"][inv]), pos)
            x = x + y
            y = mlp_lib.swiglu(sp["mlp"], rms_norm(x, sp["ln2"],
                                                   cfg.norm_eps),
                               d_ff=cfg.d_ff)
            x = x + y
            inv += 1
    x = rms_norm(x, common.weights(cfg, p, "final_norm"), cfg.norm_eps)
    return common.gathered_logits(_unembed(cfg, p, x),
                                  _vocab_entry(cfg)), cache
