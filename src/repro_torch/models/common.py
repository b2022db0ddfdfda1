"""What the LM families share — the port's counterpart of
``repro.models.common``: the per-layer views of stacked leaves (the
reference's ``layer_scan`` becomes a Python loop over them) and the
vocab-sharded ends of a model, one copy for the transformers, RWKV6 and
Zamba2.

Under a mesh context (``distributed/ctx.py``) the (un)embedding's vocab is
sharded over ``model`` wherever it divides (RWKV6's 65,536 and Zamba2's
32,000 over 16 both do): the embedding is a masked lookup of this rank's
rows whose partial sums are all-reduced, the unembedding gives this
rank's vocab columns, and the cross-entropy is computed on those columns
without gathering them (a plain ``logsumexp`` over a block would be
wrong). With no context the vocab is whole, every reduction is the
identity and the same lines compute the whole model's.

Under a rule override that shards weights over the batch's axes (FSDP,
``distributed/ctx.py``) each family makes a weight whole where it is
used: a layer's inside the function the backward recomputes
(``LayerStack.whole``), so that autograd keeps no gathered layer and the
recomputation gathers it again, and the ends' (the embedding, the
unembedding, the final norm, a frontend's projection) where they are
applied (``weights``).
"""
from __future__ import annotations

import functools

import torch
from torch.utils._python_dispatch import _disable_current_modes

from repro_torch.distributed import ctx, sharding
from repro_torch.tree import tree_leaves, tree_map

NEG_INF = -1e30


@functools.lru_cache(maxsize=None)
def param_layout(cfg):
    """(logical axes, global shapes) of ``cfg``'s params, two trees of
    the params' structure: what a block's layout is resolved from. Built
    with the dispatch modes set aside, so that a dry run's trace counts
    none of it, whenever it is first asked for."""
    from repro_torch.models import api     # api imports the families
    with _disable_current_modes():
        shapes = tree_map(lambda s: tuple(s.shape), api.param_specs(cfg))
    return api.logical_axes(cfg), shapes


def _layouts(logical, shapes):
    """The spec of each leaf's blocks under the active context."""
    return sharding.map_logical(lambda log, s: ctx.layout(s, log), logical,
                                shapes)


def weights(cfg, p, *path):
    """``p``'s subtree (or leaf) at ``path``, whole over the batch's axes
    under a rule override that shards it over them (``ctx.gather_weights``);
    as it is otherwise."""
    tree = p
    for key in path:
        tree = tree[key]
    if not ctx.gathers():
        return tree
    logical, shapes = param_layout(cfg)
    for key in path:
        logical, shapes = logical[key], shapes[key]
    return ctx.gather_weights(tree, logical, _layouts(logical, shapes))


class LayerStack:
    """The stacked layers ``p[key]`` as this rank holds them, layer by
    layer. ``stack[i]`` is this rank's per-layer tree for layer i (a view
    of one ``unbind``); ``stack.whole(lp, i)`` makes it layer i, whole,
    and belongs inside the function ``checkpoint`` recomputes
    (``stack.layer(i)`` where nothing is recomputed). Under a
    rule override that puts the layer dim on the batch's axes
    (``{"layers": ("data",)}``) each rank holds L / n layers, layer i on
    the rank of index i // (L / n), and every rank passes its own of the
    same local index, which ``ctx.fetch`` replaces by the owner's; the
    weights sharded over the batch's axes are then gathered
    (``ctx.gather_weights``). Otherwise both are the identity."""

    def __init__(self, cfg, p, key: str = "layers"):
        n = cfg.num_layers
        self.entry = ctx.layout((n,), ("layers",))[0]
        self.local = n // ctx.size(self.entry)
        self.views = unbound_layers(p[key], self.local)
        self.layer_layout = None
        if ctx.gathers():
            logical, shapes = param_layout(cfg)
            logical, shapes = logical[key], shapes[key]
            # one layer's: the stacked leaf's, its layer dim dropped (a
            # layer's own spec resolved again could put a dim on the axes
            # the layer dim takes in the stack)
            self.layer_layout = (
                sharding.map_logical(lambda log: log[1:], logical),
                sharding.map_logical(lambda log, lay: lay[1:], logical,
                                     _layouts(logical, shapes)))

    def __getitem__(self, i: int):
        return self.views[i % self.local]

    def whole(self, lp, i: int):
        lp = ctx.fetch(lp, i // self.local, self.entry)
        if self.layer_layout is None:
            return lp
        return ctx.gather_weights(lp, *self.layer_layout)

    def layer(self, i: int):
        """Layer i, whole, where no ``checkpoint`` recomputes it."""
        return self.whole(self[i], i)


def unbound_layers(layers, num_layers: int):
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


def vocab_entry(vocab: int, d_model: int, tied: bool = False):
    """The entry of the vocab dim of a (D, ``vocab``) unembedding (or,
    ``tied``, of the (``vocab``, D) embedding it is the transpose of)
    under the active context."""
    if tied:
        return ctx.spec((vocab, d_model), ("vocab", "embed"))[0]
    return ctx.spec((d_model, vocab), ("embed", "vocab"))[1]


def embed_tokens(embed, tokens, vocab: int):
    """The rows of ``embed`` (this rank's block of a (``vocab``, D) table)
    for ``tokens``. Under a mesh context with the vocab sharded: this
    rank's rows where the token is its own, zero elsewhere, all-reduced
    over the vocab's axis (one term is nonzero, so the sum is exact)."""
    ve = ctx.spec((vocab, embed.shape[-1]), ("vocab", "embed"))[0]
    if ctx.size(ve) == 1:
        return embed[tokens]
    Vl = embed.shape[0]
    idx = tokens.long() - ctx.index(ve) * Vl
    here = (idx >= 0) & (idx < Vl)
    x = embed[idx.clamp(0, Vl - 1)]
    x = torch.where(here[..., None], x, torch.zeros((), dtype=x.dtype,
                                                    device=x.device))
    return ctx.reduce_partial(x, ve)


def mask_padded(logits, vocab_size: int, offset: int = 0):
    """-1e30 on the vocab slots at or past ``vocab_size`` (``offset``: the
    first column's vocab id)."""
    idx = torch.arange(offset, offset + logits.shape[-1],
                       device=logits.device)
    return torch.where(idx < vocab_size, logits,
                       torch.full_like(logits, NEG_INF))


def unembed(x, w, ve, vocab_size: int | None = None):
    """This rank's vocab columns of the logits, f32, laid out as
    ``("batch", None, "vocab")``: ``w`` is this rank's (D, V / n) block,
    sharded by ``ve``, and x (replicated) enters the vocab-sharded
    product. ``vocab_size``: the real vocab of a padded one, whose padded
    slots are masked to -1e30."""
    off = ctx.index(ve) * w.shape[1]
    x = ctx.into_sharded(x, ve)
    logits = (x @ w).float()
    if vocab_size is not None:
        logits = mask_padded(logits, vocab_size, off)
    return ctx.maybe_constrain(logits, ("batch", None, "vocab"),
                               have=(ctx.batch_entry(), None, ve))


def gathered_logits(logits, ve):
    """Decode's logits whole over the vocab (replicated over ``model``),
    as the reference returns them."""
    return ctx.relayout(logits, (None, None, ve), (None, None, None))


def cross_entropy(logits, targets, ve):
    """The mean over the global batch's tokens of logsumexp(logits) minus
    the gold logit. ``logits``: this rank's vocab columns (sharded by
    ``ve``) of its batch rows, never gathered (rank 0's f32 block of
    Qwen3-8B at train_4k on the 16 × 16 mesh is 65,536 × 9,496, 2.49 GB):
    the log-sum-exp is the global maximum (``reduce_max``, a shift with no
    gradient) plus the log of the all-reduced local exp sums, the gold
    logit a masked local gather, all-reduced, and the mean's sum the
    ranks' partial sums all-reduced over the batch's axis."""
    be = ctx.batch_entry()
    tgt = targets.long()
    m = ctx.reduce_max(logits.detach().amax(-1, keepdim=True), ve)
    sumexp = ctx.reduce_partial(torch.sum(torch.exp(logits - m), dim=-1),
                                ve)
    logz = torch.log(sumexp) + m[..., 0]
    Vl = logits.shape[-1]
    idx = tgt - ctx.index(ve) * Vl
    here = (idx >= 0) & (idx < Vl)
    gold = torch.gather(logits, -1, idx.clamp(0, Vl - 1)[..., None])[..., 0]
    gold = ctx.reduce_partial(torch.where(here, gold,
                                          torch.zeros_like(gold)), ve)
    B, S = tgt.shape
    n = ctx.global_size("batch", B) * S
    return ctx.reduce_partial(torch.sum(logz - gold), be) / n
