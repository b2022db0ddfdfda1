"""Attention: GQA with RoPE, optional qk-norm, causal / sliding-window
prefill and the encoder's bidirectional attention through the swa_attention
kernel, and single-token decode against a (full or ring-buffer) KV cache —
the port's counterpart of ``repro.layers.attention``.

Parameter layout per layer (optionally with a leading stacked-layer dim):
  wq: (d_model, n_heads*head_dim)    wk/wv: (d_model, n_kv*head_dim)
  wo: (n_heads*head_dim, d_model)    q_norm/k_norm: (head_dim,) if qk_norm
q is (B, S, H, hd) and k, v are (B, T, KV, hd), as in the reference.

Under a mesh context (``distributed/ctx.py``) each rank holds its blocks of
the weights and the cache, as ``attention_logical`` and
``kv_cache_logical`` resolve them, and q, k and v move to the layouts the
reference's constraints give them (heads over ``model`` where they divide,
else all-gathered). The kernel is handed this rank's q heads beside the KV
heads they pair with (Qwen3-8B at model 16: 2 q heads and their one KV
head), ``wo``'s product is a partial sum over ``model``, all-reduced, and
the decode cache sharded by sequence is scored rank by rank and combined
exactly: an all-reduce max, then all-reduce sums of the exp-weighted values
and of the exp sums.

Under autograd (``distributed/ctx.py``'s convention: a replicated tensor's
gradient is replicated) the replicated input of a projection whose
columns are sharded enters it through ``ctx.into_sharded``, whose backward
all-reduces its gradient; so do ``q_norm`` and ``k_norm``, replicated
(head_dim,) leaves applied to this rank's heads only, and replicated KV
heads read by this rank's q heads. ``wo``'s partial product keeps
``reduce_partial`` (identity backward).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.distributed import ctx
from repro_torch.kernels.swa_attention import ops as swa_ops
from repro_torch.layers.init import normal
from repro_torch.layers.norms import rms_norm
from repro_torch.layers.rope import apply_rope

NEG_INF = -1e30


def init_attention(cfg, generator, dtype=torch.bfloat16,
                   num_layers: int | None = None, device="cuda"):
    lead = () if num_layers is None else (num_layers,)
    d, qd, kvd = cfg.d_model, cfg.q_dim, cfg.kv_dim
    p = {
        "wq": normal(generator, lead + (d, qd), d ** -0.5, dtype, device),
        "wk": normal(generator, lead + (d, kvd), d ** -0.5, dtype, device),
        "wv": normal(generator, lead + (d, kvd), d ** -0.5, dtype, device),
        "wo": normal(generator, lead + (qd, d), qd ** -0.5, dtype, device),
    }
    if cfg.qk_norm:
        p["q_norm"] = torch.ones(lead + (cfg.head_dim,), dtype=dtype,
                                 device=device)
        p["k_norm"] = torch.ones(lead + (cfg.head_dim,), dtype=dtype,
                                 device=device)
    return p


def attention_logical(cfg, stacked: bool = False):
    lead = ("layers",) if stacked else ()
    p = {
        "wq": lead + ("embed", "heads"),
        "wk": lead + ("embed", "kv_heads"),
        "wv": lead + ("embed", "kv_heads"),
        "wo": lead + ("heads", "embed"),
    }
    if cfg.qk_norm:
        p["q_norm"] = lead + ("head_dim",)
        p["k_norm"] = lead + ("head_dim",)
    return p


def _sdpa(cfg, q, k, v, mask):
    """Plain attention for decode, as the reference's ``_sdpa``.
    q: (B,S,H,hd)  k,v: (B,T,KV,hd)  mask: (S,T) or (B,S,T) bool."""
    B, S, H, hd = q.shape
    KV = k.shape[2]
    qg = q.reshape(B, S, KV, H // KV, hd)
    scores = torch.einsum("bskgh,btkh->bkgst", qg.float(),
                          k.float()) * (hd ** -0.5)
    if mask.dim() == 2:
        mask = mask[None]
    scores = torch.where(mask[:, None, None], scores,
                         torch.full_like(scores, NEG_INF))
    w = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgst,btkh->bskgh", w, v.float())
    return out.reshape(B, S, H, hd).to(q.dtype)


def _cols(cfg, x, n, logical):
    """The entry of the columns of a projection to ``n`` heads."""
    return ctx.spec((x.shape[-1], n * cfg.head_dim), ("embed", logical))[1]


def _heads(cfg, w, x, n, logical, want):
    """``x @ w`` of a projection whose columns are sharded as
    ``(embed, logical)`` resolves, moved to the heads layout ``want`` (an
    entry), as (B, S, local heads, hd) and the first local head. ``x``
    has entered the product already (``ctx.into_sharded`` over the
    columns' entry)."""
    cols = _cols(cfg, x, n, logical)
    y = ctx.relayout(x @ w, (None, None, cols), (None, None, want))
    B, S = x.shape[:2]
    return (y.reshape(B, S, -1, cfg.head_dim),
            ctx.index(want) * (n // ctx.size(want)))


def _kv_for(cfg, q0, n_q, k0, n_k):
    """The KV heads (from ``k0``'s block of ``n_k``) that q heads
    [q0, q0 + n_q) attend with, as a slice, such that the kernel's pairing
    of local q head h with local KV head h // (n_q / kv) holds."""
    G = cfg.num_heads // cfg.num_kv_heads
    lo, hi = q0 // G, (q0 + n_q - 1) // G + 1
    kv = hi - lo
    if lo < k0 or hi > k0 + n_k or n_q % kv or any(
            (q0 + h) // G - lo != h // (n_q // kv) for h in range(n_q)):
        raise ValueError(f"q heads [{q0}, {q0 + n_q}) do not pair with "
                         f"whole KV heads of [{k0}, {k0 + n_k}) "
                         f"(group {G})")
    return slice(lo - k0, hi - k0)


def _select(t, sl):
    """``t``'s heads ``sl`` (dim 2), contiguous as the kernel takes them;
    ``t`` itself where that is all."""
    if (sl.start, sl.stop) == (0, t.shape[2]):
        return t
    return t[:, :, sl].contiguous()


def _project_qkv(cfg, p, x, positions, q_want=None, kv_want=None):
    """q, k, v of this rank: q's heads laid out by ``q_want``, k's and v's
    by ``kv_want`` (entries; None: all heads), each normed and rotated per
    head. Returns (q, q0, k, v, k0): q0 and k0 are the first local q and
    KV heads."""
    entered = {}

    def into(entry):
        # one entry of x a columns' entry: its backward one all-reduce
        if entry not in entered:
            entered[entry] = ctx.into_sharded(x, entry)
        return entered[entry]

    q_cols = _cols(cfg, x, cfg.num_heads, "heads")
    kv_cols = _cols(cfg, x, cfg.num_kv_heads, "kv_heads")
    q, q0 = _heads(cfg, p["wq"], into(q_cols), cfg.num_heads, "heads",
                   q_want)
    k, k0 = _heads(cfg, p["wk"], into(kv_cols), cfg.num_kv_heads,
                   "kv_heads", kv_want)
    v, _ = _heads(cfg, p["wv"], into(kv_cols), cfg.num_kv_heads,
                  "kv_heads", kv_want)
    if cfg.qk_norm:
        q = rms_norm(q, ctx.into_sharded(p["q_norm"], q_want),
                     cfg.norm_eps)
        k = rms_norm(k, ctx.into_sharded(p["k_norm"], kv_want),
                     cfg.norm_eps)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    return q, q0, k, v, k0


def _out_proj(cfg, p, y, y_entry):
    """``y`` (B, S, local heads · hd, laid out by ``y_entry``) through
    ``wo``: its columns moved to ``wo``'s rows, the partial product
    all-reduced over them, the result constrained to (batch, -, -)."""
    rows = ctx.spec((cfg.q_dim, cfg.d_model), ("heads", "embed"))[0]
    y = ctx.relayout(y, (None, None, y_entry), (None, None, rows))
    y = ctx.reduce_partial(y @ p["wo"], rows)
    return ctx.maybe_constrain(y, ("batch", None, None),
                               have=(ctx.batch_entry(), None, None))


def _q_layout(q_want, kv_want):
    """The entry of q's heads: the rule's, or where it leaves them whole
    and the KV heads are sharded (a rule override's ``{"heads": ()}``, or
    the q heads on the batch's axis), the KV heads' entry: each rank then
    scores the q heads of its own KV heads, and ``wo``'s input is
    gathered back. Under the default rules q is sharded wherever the KV
    heads are."""
    return kv_want if q_want is None else q_want


def _attention(cfg, p, x, positions, window, causal):
    """q, k and v constrained as the reference's ``attn_forward``
    constrains them, the kernel on this rank's q heads and the KV heads
    they need, then ``wo``. Returns (y, (k, v)), k and v in their
    constrained layout (the cache's source)."""
    B, S = x.shape[:2]
    Bg, hd = ctx.global_size("batch", B), cfg.head_dim
    q_want = ctx.spec((Bg, S, cfg.num_heads, hd),
                      ("batch", None, "heads", None))[2]
    kv_want = ctx.spec((Bg, S, cfg.num_kv_heads, hd),
                       ("batch", None, "kv_heads", None))[2]
    q_want = _q_layout(q_want, kv_want)
    q, q0, k, v, k0 = _project_qkv(cfg, p, x, positions, q_want, kv_want)
    sl = _kv_for(cfg, q0, q.shape[2], k0, k.shape[2])
    if kv_want is None:
        # replicated KV heads, read by this rank's q heads only
        k, v = ctx.into_sharded(k, q_want), ctx.into_sharded(v, q_want)
    y = swa_ops.swa_attention(q, _select(k, sl), _select(v, sl),
                              window=window or S, causal=causal)
    y = _out_proj(cfg, p, y.reshape(B, S, -1), q_want)
    return y, (k, v)


def attn_forward(cfg, p, x, positions, window: int = 0):
    """Full-sequence (prefill) causal attention, windowed when ``window``
    > 0, through the swa_attention kernel. Returns (y, (k, v)) so prefill
    can build the KV cache; under a mesh context, this rank's part (see
    the module's docstring)."""
    return _attention(cfg, p, x, positions, window, True)


def attn_forward_bidirectional(cfg, p, x, positions):
    """Encoder-only (HuBERT) attention: every query sees every key, RoPE
    as in the causal form — the reference's all-ones mask, through the
    swa_attention kernel's non-causal mode. Returns (y, (k, v))."""
    return _attention(cfg, p, x, positions, x.shape[1], False)


# ---------------------------------------------------------------------------
# decode paths
# ---------------------------------------------------------------------------

def init_kv_cache(cfg, batch: int, seq_len: int, num_layers: int,
                  dtype=torch.bfloat16, device="cuda"):
    """Cache shape (L, B, T, KV, hd); T = window size for sliding-window.
    Under a mesh context: this rank's block of it (and the global batch
    and T declared)."""
    T = min(seq_len, cfg.sliding_window) if cfg.sliding_window else seq_len
    ctx.declare(batch=batch, cache_len=T)
    shape = ctx.block_shape(
        (num_layers, batch, T, cfg.num_kv_heads, cfg.head_dim),
        kv_cache_logical(cfg)["k"])
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def kv_cache_logical(cfg):
    # resolve_spec walks the dims in order, so kv_seq takes 'model' before
    # kv_heads is reached: the cache is sharded by sequence where it
    # divides. The stacked layer dim is unnamed (the reference's "layers",
    # replicated by its rules): a cache is its batch rows' state, and a
    # rule override that puts the weights' layer dim on the batch's axis
    # leaves it sharded by batch
    spec = (None, "batch", "kv_seq", "kv_heads", "head_dim")
    return {"k": spec, "v": spec}


def cache_entries(cfg, T: int, batch: int | None = None):
    """(batch, kv_seq, kv_heads) entries of a (·, B, T, KV, hd) cache of
    the declared global batch under the active context (with none, of
    ``batch``: all None)."""
    spec = ctx.spec((1, ctx.global_size("batch", batch), T,
                     cfg.num_kv_heads, cfg.head_dim),
                    kv_cache_logical(cfg)["k"])
    return spec[1], spec[2], spec[3]


def cache_block(cfg, t, T: int):
    """A prefill's k or v (B, S, KV, hd), in the layout ``attn_forward``
    returns it, as this rank's block of one layer of a (B, T, KV, hd)
    cache: its last T positions, or zero-padded to T, moved to the
    cache's layout (under a mesh context gathered over the heads, then
    this rank's positions kept) in a storage of its own."""
    B, S = t.shape[:2]
    if T < S:
        t = t[:, -T:]
    elif T > S:
        t = F.pad(t, (0, 0, 0, 0, 0, T - S))
    Bg = ctx.global_size("batch", B)
    have = (ctx.batch_entry(), None,
            ctx.spec((Bg, S, cfg.num_kv_heads, cfg.head_dim),
                     ("batch", None, "kv_heads", None))[2], None)
    want = cache_entries(cfg, T, B) + (None,)
    return ctx.compact(ctx.relayout(t, have, want))


def _slot(cfg, pos: int, T: int) -> int:
    # the reference's dynamic_update_slice clamps the start into the cache
    return pos % T if cfg.sliding_window else min(pos, T - 1)


def _visible(cfg, s_idx, pos: int, T: int):
    if cfg.sliding_window:
        # ring buffer: slot s holds absolute position pos - ((pos - s) mod T)
        return (pos - ((pos - s_idx) % T)) >= 0
    return s_idx <= pos


def attn_decode(cfg, p, x, layer_cache, pos: int):
    """One-token decode. x: (B, 1, d); pos: the tokens generated so far.
    Returns (y, layer_cache). The cache tensors (B, T, KV, hd) are updated
    in place — the reference donates its cache to the step, so nothing reads
    the old one — and returned.

    Under a mesh context they are this rank's blocks. A cache sharded by
    sequence over more than one rank: q, k and v whole (the step's one
    token all-gathered), the new k and v written by the rank holding the
    slot, every head scored over this rank's positions and the softmax
    combined exactly over the sequence's ranks. Otherwise the plain step
    on this rank's heads. Then ``wo`` as in prefill."""
    ck, cv = layer_cache
    B, pos = x.shape[0], int(pos)
    Tl = ck.shape[1]
    T = ctx.global_size("cache_len", Tl)
    _, seq, kvh = cache_entries(cfg, T, B)
    split = ctx.size(seq) > 1
    if split:
        q_want = None
    else:
        q_want = _q_layout(ctx.spec(
            (ctx.global_size("batch", B), 1, cfg.num_heads, cfg.head_dim),
            ("batch", None, "heads", None))[2], kvh)
    positions = torch.full((B, 1), pos, dtype=torch.int64, device=x.device)
    q, q0, k, v, k0 = _project_qkv(cfg, p, x, positions, q_want, kvh)
    slot, t0 = _slot(cfg, pos, T), ctx.index(seq) * Tl
    if t0 <= slot < t0 + Tl:
        ck[:, slot - t0:slot - t0 + 1] = k
        cv[:, slot - t0:slot - t0 + 1] = v
    mask = _visible(cfg, torch.arange(t0, t0 + Tl, device=x.device), pos,
                    T)[None, None, :]
    if not split:
        sl = _kv_for(cfg, q0, q.shape[2], k0, ck.shape[2])
        y = _sdpa(cfg, q, _select(ck, sl), _select(cv, sl), mask)
        return _out_proj(cfg, p, y.reshape(B, 1, -1), q_want), (ck, cv)
    # kv heads k0.. of the cache pair with q heads k0·G..
    G = cfg.num_heads // cfg.num_kv_heads
    KV, hd = ck.shape[2], cfg.head_dim
    q = q[:, :, k0 * G:(k0 + KV) * G]
    qg = q.reshape(B, 1, KV, G, hd)
    scores = torch.einsum("bskgh,btkh->bkgst", qg.float(),
                          ck.float()) * (hd ** -0.5)
    scores = torch.where(mask[:, None, None], scores,
                         torch.full_like(scores, NEG_INF))
    m = ctx.reduce_max(scores.amax(-1, keepdim=True), seq)
    e = torch.exp(scores - m)
    num = ctx.reduce_partial(torch.einsum("bkgst,btkh->bskgh", e,
                                          cv.float()), seq)
    den = ctx.reduce_partial(e.sum(-1), seq)          # (B, KV, G, 1)
    y = num / den.permute(0, 3, 1, 2)[..., None]
    y = y.reshape(B, 1, KV * G * hd).to(q.dtype)
    return _out_proj(cfg, p, y, kvh), (ck, cv)
