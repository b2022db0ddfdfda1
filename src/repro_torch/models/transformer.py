"""The transformer backbone: dense GQA decoders (qwen3*, internlm2,
minicpm), MoE decoders (olmoe, qwen3-moe), the encoder-only HuBERT and the
VLM (internvl2: a patch-embedding prefix, then the decoder) — init, full
forward, the training loss, the final hidden states (the ELM head's H),
prefill and one-token decode; the port's counterpart of
``repro.models.transformer``.

Layers are stacked (a leading L dim on every leaf of ``params["layers"]``)
as in the reference, so trees convert leaf by leaf; the reference's
``layer_scan`` becomes a Python loop over views of the stacked leaves.
Every rms_norm goes through the rmsnorm kernel and every full-sequence
attention through the swa_attention kernel on the card (the encoder's
bidirectional attention through its non-causal mode), forward and, under
autograd, backward (rmsnorm_bwd, swa_attention_bwd in either mode).
The MoE's dispatch, expert products and combine are plain PyTorch, as the
reference leaves them to XLA (``layers/mlp.py``).

Stub frontends, as in the reference: audio frame embeddings
(``batch["frames"]``) and vision patch embeddings (``batch["patches"]``)
arrive precomputed, and a learned projection maps them into d_model.

Under a mesh context (``distributed/ctx.py``, the reference's
``use_mesh_rules``) every rank runs the same code on its blocks of the
parameters (``logical_axes``), the batch and the cache
(``cache_logical``): the vocab-sharded embedding is a masked lookup whose
partial sums are all-reduced over ``model``, the unembedding gives this
rank's vocab columns (prefill's and the forward's logits stay sharded as
``("batch", None, "vocab")``; decode's are all-gathered, as the reference
returns them replicated), and the layers shard as ``layers/attention.py``
and ``layers/mlp.py`` say. Serving sends nothing over ``data``. Training
under a mesh (its collectives' backward) is the next slice:
``loss_fn`` refuses a context.

The reference wraps each layer of the forward in ``jax.checkpoint``, a
memory policy of its autodiff (recompute a layer's activations in the
backward rather than keep them). PyTorch's autograd keeps them: at the
sizes the port trains (Qwen3-8B at batch 4 × 128 tokens) they are a few GB
beside the weights, gradients and optimizer state, so nothing stands in
for it; the values are the same either way.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch import resolve_device
from repro_torch.distributed import ctx
from repro_torch.layers import attention as attn
from repro_torch.layers import mlp as mlp_lib
from repro_torch.layers.init import normal
from repro_torch.layers.norms import rms_norm
from repro_torch.tree import tree_leaves, tree_map

NEG_INF = -1e30
AUDIO_FRONTEND_DIM = 512    # wav2vec2/HuBERT conv-extractor output dim
VISION_FRONTEND_DIM = 1024  # InternViT patch-embedding dim (stub)
FAMILIES = ("dense", "moe", "encoder", "vlm")


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def init_params(cfg, generator, dtype=torch.bfloat16, device="cuda"):
    """The reference's distributions from a ``torch.Generator``, drawn on
    the generator's device (a CUDA generator draws a full-size model on the
    card) and stored on ``device``. Padded vocab rows are zero."""
    dev = resolve_device(device)
    L, D, V = cfg.num_layers, cfg.d_model, cfg.padded_vocab
    layers = {
        "attn": attn.init_attention(cfg, generator, dtype, num_layers=L,
                                    device=dev),
        "ln1": torch.ones((L, D), dtype=torch.float32, device=dev),
        "ln2": torch.ones((L, D), dtype=torch.float32, device=dev),
    }
    if cfg.family == "moe":
        layers["moe"] = mlp_lib.init_moe(D, cfg.moe_d_ff or cfg.d_ff,
                                         cfg.num_experts, generator, dtype,
                                         num_layers=L, device=dev)
    else:
        layers["mlp"] = mlp_lib.init_swiglu(D, cfg.d_ff, generator, dtype,
                                            num_layers=L, device=dev)
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
    if cfg.frontend == "audio":
        p["frontend_proj"] = normal(generator, (AUDIO_FRONTEND_DIM, D),
                                    AUDIO_FRONTEND_DIM ** -0.5, dtype, dev)
    if cfg.frontend == "vision":
        p["projector"] = {
            "w1": normal(generator, (VISION_FRONTEND_DIM, D),
                         VISION_FRONTEND_DIM ** -0.5, dtype, dev),
            "w2": normal(generator, (D, D), D ** -0.5, dtype, dev),
        }
    return p


def logical_axes(cfg):
    """The logical axes of every leaf of ``init_params(cfg)``."""
    layers = {
        "attn": attn.attention_logical(cfg, stacked=True),
        "ln1": ("layers", "embed"),
        "ln2": ("layers", "embed"),
    }
    if cfg.family == "moe":
        layers["moe"] = mlp_lib.moe_logical(stacked=True)
    else:
        layers["mlp"] = mlp_lib.swiglu_logical(stacked=True)
    p = {
        "embed": ("vocab", "embed"),
        "final_norm": ("embed",),
        "layers": layers,
    }
    if not cfg.tie_embeddings:
        p["unembed"] = ("embed", "vocab")
    if cfg.frontend == "audio":
        p["frontend_proj"] = ("feature", "embed")
    if cfg.frontend == "vision":
        p["projector"] = {"w1": ("feature", "embed"), "w2": ("embed", "embed")}
    return p


def _mask_padded_logits(cfg, logits, offset: int = 0):
    """-1e30 on padded vocab slots (``offset``: the first column's vocab
    id)."""
    if cfg.padded_vocab == cfg.vocab_size:
        return logits
    idx = torch.arange(offset, offset + logits.shape[-1],
                       device=logits.device)
    return torch.where(idx < cfg.vocab_size, logits,
                       torch.full_like(logits, NEG_INF))


def _unbound_layers(layers, num_layers: int):
    """The per-layer trees of the stacked ``layers``: views from one
    ``unbind`` of each leaf. Under autograd each leaf's gradient is then
    stacked once, where a view ``a[i]`` per layer would hand every layer a
    zero tensor of the whole leaf's size to add into it."""
    leaves = tree_leaves(layers)
    parts = [a.unbind(0) for a in leaves]
    out = []
    for i in range(num_layers):
        it = iter([part[i] for part in parts])
        out.append(tree_map(lambda _: next(it), layers))
    return out


def _vocab_entry(cfg):
    """The entry of the vocab dim of the (un)embedding under the active
    context."""
    V, D = cfg.padded_vocab, cfg.d_model
    if cfg.tie_embeddings:
        return ctx.spec((V, D), ("vocab", "embed"))[0]
    return ctx.spec((D, V), ("embed", "vocab"))[1]


def _embed_tokens(cfg, p, tokens):
    """The embedding rows of ``tokens``. Under a mesh context with the
    vocab sharded: this rank's rows where the token is its own, zero
    elsewhere, all-reduced over the vocab's axis (one term is nonzero, so
    the sum is exact)."""
    ve = ctx.spec((cfg.padded_vocab, cfg.d_model), ("vocab", "embed"))[0]
    if ctx.size(ve) == 1:
        return p["embed"][tokens]
    Vl = p["embed"].shape[0]
    idx = tokens.long() - ctx.index(ve) * Vl
    here = (idx >= 0) & (idx < Vl)
    x = p["embed"][idx.clamp(0, Vl - 1)]
    x = torch.where(here[..., None], x, torch.zeros((), dtype=x.dtype,
                                                    device=x.device))
    return ctx.reduce_partial(x, ve)


def _unembed(cfg, p, x):
    unembed = p["embed"].T if cfg.tie_embeddings else p["unembed"]
    ve = _vocab_entry(cfg)
    off = ctx.index(ve) * unembed.shape[1]
    logits = _mask_padded_logits(cfg, (x @ unembed).float(), off)
    return ctx.maybe_constrain(logits, ("batch", None, "vocab"),
                               have=(ctx.batch_entry(), None, ve))


def _gathered_logits(cfg, logits):
    """Decode's logits whole over the vocab (replicated over ``model``)."""
    return ctx.relayout(logits, (None, None, _vocab_entry(cfg)),
                        (None, None, None))


# ---------------------------------------------------------------------------
# blocks
# ---------------------------------------------------------------------------

def _ffn(cfg, lp, x):
    """The block's feed-forward: (y, aux); aux is None but for the MoE."""
    if cfg.family == "moe":
        return mlp_lib.moe_apply(lp["moe"], x, cfg.experts_per_token,
                                 capacity_factor=cfg.moe_capacity_factor,
                                 combine_sharding=cfg.moe_combine_sharding,
                                 num_experts=cfg.num_experts,
                                 d_ff=cfg.moe_d_ff or cfg.d_ff)
    return mlp_lib.swiglu(lp["mlp"], x, d_ff=cfg.d_ff), None


def _block(cfg, lp, x, positions, window, bidirectional=False):
    """One block; returns (x, (k, v), aux). ``bidirectional``: the
    encoder's attention over every position (the reference's forward and
    hidden states of an encoder-only config)."""
    h = rms_norm(x, lp["ln1"], cfg.norm_eps)
    if bidirectional:
        h, kv = attn.attn_forward_bidirectional(cfg, lp["attn"], h,
                                                positions)
    else:
        h, kv = attn.attn_forward(cfg, lp["attn"], h, positions,
                                  window=window)
    x = x + h
    h, aux = _ffn(cfg, lp, rms_norm(x, lp["ln2"], cfg.norm_eps))
    return x + h, kv, aux


def _embed_inputs(cfg, p, batch):
    """Token / frame / patch embedding (+ the VLM prefix ahead of the
    tokens). Returns (x, positions, text_offset): where the loss-bearing
    text starts in the sequence."""
    if cfg.frontend == "audio":
        proj = p["frontend_proj"]
        x = batch["frames"].to(proj.dtype) @ proj
        B, S = x.shape[:2]
        return x, torch.arange(S, device=x.device).expand(B, S), 0
    tok = _embed_tokens(cfg, p, batch["tokens"])
    if cfg.frontend == "vision":
        w1, w2 = p["projector"]["w1"], p["projector"]["w2"]
        patches = batch["patches"].to(w1.dtype)
        # jax.nn.gelu's default is the tanh form
        pref = F.gelu((patches @ w1).float(), approximate="tanh")
        x = torch.cat([pref.to(tok.dtype) @ w2, tok], dim=1)
        offset = patches.shape[1]
    else:
        x, offset = tok, 0
    B, S = x.shape[:2]
    return x, torch.arange(S, device=x.device).expand(B, S), offset


def _encode(cfg, p, batch, window):
    """The layers and the final norm over the text positions: (x, the
    per-layer aux losses of the MoE, else [])."""
    window = cfg.sliding_window if window is None else window
    x, positions, offset = _embed_inputs(cfg, p, batch)
    x = ctx.maybe_constrain(x, ("batch", None, None),
                            have=(ctx.batch_entry(), None, None))
    auxes = []
    for lp in _unbound_layers(p["layers"], cfg.num_layers):
        x, _, aux = _block(cfg, lp, x, positions, window,
                           bidirectional=cfg.is_encoder_only)
        if aux is not None:
            auxes.append(aux)
    x = rms_norm(x, p["final_norm"], cfg.norm_eps)
    return (x[:, offset:] if offset else x), auxes


def forward(cfg, p, batch, *, window: int | None = None):
    """Full-sequence forward. Returns (logits f32, aux_loss): the mean of
    the layers' router aux losses (0 but for the MoE)."""
    x, auxes = _encode(cfg, p, batch, window)
    aux = (torch.stack(auxes).mean() if auxes
           else torch.zeros((), device=x.device))
    return _unembed(cfg, p, x), aux


def hidden_states(cfg, p, batch, *, window: int | None = None):
    """Final-norm hidden states (B, S, D) of the text positions, no
    unembed — the ELM head's H."""
    return _encode(cfg, p, batch, window)[0]


def loss_fn(cfg, p, batch):
    """Next-token cross-entropy: (loss, {"ce", "aux"}), as the reference's
    ``loss_fn`` (transformer.py:215) — the mean over tokens of
    logsumexp(logits) minus the gold logit, padded vocab slots masked to
    -1e30 in the logits; the MoE adds ``router_aux_coef`` times the aux
    loss. Not under a mesh context: sharded training (the collectives'
    backward) is the next slice of the port."""
    if ctx.current() is not None:
        raise NotImplementedError(
            "training under a mesh context (the collectives' backward) "
            "comes with the sharded-training slice; serve (prefill, "
            "decode_step) or run forward under the mesh")
    logits, aux = forward(cfg, p, batch)
    tgt = batch["targets"].long()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, tgt[..., None])[..., 0]
    ce = torch.mean(logz - gold)
    loss = ce + cfg.router_aux_coef * aux if cfg.family == "moe" else ce
    return loss, {"ce": ce, "aux": aux}


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------

def cache_logical(cfg):
    return attn.kv_cache_logical(cfg)


def init_cache(cfg, batch: int, seq_len: int, dtype=torch.bfloat16,
               device="cuda"):
    """The zero KV cache of a global ``batch`` and ``seq_len``; under a
    mesh context this rank's block of it (and the sizes declared)."""
    return attn.init_kv_cache(cfg, batch, seq_len, cfg.num_layers, dtype,
                              resolve_device(device))


def prefill(cfg, p, batch, max_len: int | None = None):
    """Encode a prompt, returning last-position logits + the KV cache.
    ``max_len`` pads the cache so decoding can continue past the prompt.
    Every family runs the causal attention here, the encoder too, as the
    reference's ``prefill`` does. Each layer's k and v, in the layout the
    attention's constraint gave them, are cut to the window or padded to
    ``max_len`` and moved to the cache's layout: under a mesh context
    gathered over the heads, then this rank's positions kept, so the
    logits are this rank's vocab columns and the cache its blocks."""
    x, positions, _ = _embed_inputs(cfg, p, batch)
    B, S = x.shape[:2]
    W = cfg.sliding_window
    T = W if W and S > W else S
    if max_len is not None and not W:
        T = max(T, max_len)
    ctx.declare(cache_len=T)
    Bg, be = ctx.global_size("batch", B), ctx.batch_entry()
    kv_have = (be, None, ctx.spec((Bg, S, cfg.num_kv_heads, cfg.head_dim),
                                  ("batch", None, "kv_heads", None))[2],
               None)
    kv_want = attn.cache_entries(cfg, T, B) + (None,)

    def place(t):
        if T < S:
            t = t[:, -T:]
        elif T > S:
            t = F.pad(t, (0, 0, 0, 0, 0, T - S))
        return ctx.compact(ctx.relayout(t, kv_have, kv_want))

    ks, vs = [], []
    for lp in _unbound_layers(p["layers"], cfg.num_layers):
        x, (k, v), _ = _block(cfg, lp, x, positions, W)
        ks.append(place(k))
        vs.append(place(v))
    ks, vs = torch.stack(ks), torch.stack(vs)
    x = rms_norm(x[:, -1:], p["final_norm"], cfg.norm_eps)
    return _unembed(cfg, p, x), {"k": ks, "v": vs}


def decode_step(cfg, p, cache, token, pos: int):
    """One new token against the KV cache. token: (B, 1) integers; pos: the
    tokens so far. Returns (logits, cache); the cache is updated in place
    (see ``attention.attn_decode``). Under a mesh context the cache and
    the token are this rank's blocks and the logits come out whole over
    the vocab."""
    x = _embed_tokens(cfg, p, token)
    for i, lp in enumerate(_unbound_layers(p["layers"], cfg.num_layers)):
        h, _ = attn.attn_decode(cfg, lp["attn"],
                                rms_norm(x, lp["ln1"], cfg.norm_eps),
                                (cache["k"][i], cache["v"][i]), pos)
        x = x + h
        h, _ = _ffn(cfg, lp, rms_norm(x, lp["ln2"], cfg.norm_eps))
        x = x + h
    x = rms_norm(x, p["final_norm"], cfg.norm_eps)
    return _gathered_logits(cfg, _unembed(cfg, p, x)), cache
