"""The mesh context: a model run on an LM mesh, rank by rank — the port's
counterpart of ``repro.distributed.ctx``.

The reference wraps tracing in ``use_mesh_rules(mesh, rules)``, and its
models call ``maybe_constrain(x, logical)`` at the points where an
activation's layout matters; GSPMD then places every array and inserts the
collectives. The port runs eagerly on one rank's blocks, so it does
GSPMD's placement by hand, under the same two calls:

1. Parameters and caches are the blocks ``sharding.resolve_spec`` gives
   this rank's coordinate (``shard_params``, ``place``, or the model's own
   ``init_cache``), so a rank holds the reference's per-chip bytes.
2. At each of the reference's ``maybe_constrain`` points the activation
   moves from the layout it has to the one its logical spec resolves to,
   by nothing, a local slice, or an all-gather along one dimension over
   one axis (``maybe_constrain(x, logical, have)``).
3. A product that contracts a dimension sharded over an axis gives a
   partial sum, which ``reduce_partial`` all-reduces over that axis.

Every collective goes through ``distributed.collectives`` under its axis's
label. An axis of size 1 moves nothing, so over it every call here
returns its input and sends nothing, in either direction.

**Gradients.** Every move here is differentiable, under one convention:
the gradient of a replicated activation (or leaf) is itself replicated,
the same on every rank of the axis, and the gradient of a sharded one is
this rank's block of the whole gradient. Under it:

* ``reduce_partial`` (the all-reduce of a partial product) has the
  identity as its backward: each rank's partial term takes the whole,
  replicated gradient of the sum;
* ``gather`` (sharded -> replicated) keeps this rank's block of the
  gradient: a local slice, nothing sent;
* ``local_slice`` (replicated -> sharded) all-gathers the blocks'
  gradients into the whole one;
* ``reduce_max`` is a shift only (the log-sum-exp's), and carries no
  gradient: its input is detached;
* ``into_sharded`` is the identity forward whose backward all-reduces the
  gradient over the axis, the conjugate of ``reduce_partial``. It goes
  wherever a replicated activation or leaf enters a computation sharded
  over that axis (a product with column-sharded weights, a norm's scale
  applied to this rank's heads only, a replicated KV head read by this
  rank's q heads): there each rank's gradient of it is a partial sum.

A parameter's gradient is then whole on its block, but for one sum the
model cannot see: over the axes that shard the batch and not the leaf
(``data``), each rank holds its tokens' share, which the train step
all-reduces (``core/trainer.py``). A loss is a ``reduce_partial`` of the
ranks' partial sums, so its gradient is 1 on every rank. With no context every spec entry is
None and every call here is a no-op, so one code path serves a model run
whole and one run on a mesh. A step's inputs are local blocks, so the
context also holds the global sizes their layout depends on — the batch
and the cache's length — which ``place``, ``init_cache`` and prefill
record (``declare``); with no context a block is the whole, and
``global_size`` returns the local size it is given.
"""
from __future__ import annotations

from contextlib import contextmanager
from typing import Optional, Sequence

import torch

from repro_torch.distributed import collectives, sharding


class Frame:
    """One active context: the mesh (a ``launch.mesh.LMMesh``), the rules
    laid over ``sharding.DEFAULT_RULES`` and the declared global sizes.
    With no mesh it stands for no context: every entry None."""

    def __init__(self, mesh, rules=None):
        self.mesh = mesh
        self.rules = rules
        self.sizes = {}
        self._specs = {}

    def spec(self, shape: Sequence[int], logical) -> tuple:
        if self.mesh is None:
            return (None,) * len(logical)
        # a decode step resolves ~400 specs, most of them again and again
        key = (tuple(shape), tuple(logical))
        if key not in self._specs:
            self._specs[key] = sharding.resolve_spec(shape, logical,
                                                     self.mesh, self.rules)
        return self._specs[key]


_STACK = []
_NONE = Frame(None)


@contextmanager
def use_mesh_rules(mesh, rules=None):
    """Run the models on ``mesh`` (this rank's blocks) under ``rules``."""
    frame = Frame(mesh, rules)
    _STACK.append(frame)
    try:
        yield frame
    finally:
        _STACK.pop()


@contextmanager
def suspended():
    """No context inside the block (whole-model shapes, plain runs)."""
    saved = _STACK[:]
    _STACK.clear()
    try:
        yield
    finally:
        _STACK[:] = saved


def current() -> Optional[Frame]:
    return _STACK[-1] if _STACK else None


def _frame() -> Frame:
    return _STACK[-1] if _STACK else _NONE


def declare(**sizes):
    """Record global sizes of the step's inputs (``batch``, ``cache_len``)
    in the active context."""
    frame = current()
    if frame is not None:
        frame.sizes.update({k: int(v) for k, v in sizes.items()
                            if v is not None})


def global_size(name: str, local: Optional[int] = None) -> Optional[int]:
    """The declared global size ``name``; with no context the block is
    the whole, so ``local``."""
    frame = current()
    if frame is None:
        return local
    if name not in frame.sizes:
        raise RuntimeError(f"the mesh context has no global {name!r}: "
                           f"place the inputs (ctx.place, init_cache) or "
                           f"declare it")
    return frame.sizes[name]


def spec(shape: Sequence[int], logical) -> tuple:
    """The active context's spec of a global ``shape``."""
    return _frame().spec(shape, logical)


def batch_entry():
    """The spec entry of the declared global batch."""
    return spec((global_size("batch"),), ("batch",))[0]


def size(entry) -> int:
    """How many blocks ``entry`` cuts a dimension into (1 for None)."""
    return 1 if entry is None else _frame().mesh.size(entry)


def index(entry) -> int:
    """This rank's block along a dimension sharded by ``entry``."""
    return 0 if entry is None else _frame().mesh.index(entry)


def block_shape(shape: Sequence[int], logical) -> tuple:
    """This rank's block of a global ``shape`` laid out by ``logical``."""
    return tuple(d // size(e) for d, e in zip(shape, spec(shape, logical)))


def global_shape(local_shape: Sequence[int], have: Sequence) -> tuple:
    """The global shape of a block laid out by ``have``."""
    return tuple(d * size(e) for d, e in zip(local_shape, have))


def _group(entry):
    mesh = _frame().mesh
    return mesh.group(entry), mesh.label(entry)


def gather(x: torch.Tensor, dim: int, entry) -> torch.Tensor:
    """The whole of ``x``'s dimension ``dim``, sharded over ``entry``;
    the backward keeps this rank's block of the gradient."""
    if size(entry) == 1:
        return x
    group, label = _group(entry)
    return collectives.all_gather(x, group, label=label, dim=dim)


def local_slice(x: torch.Tensor, dim: int, entry) -> torch.Tensor:
    """This rank's block of ``x``'s whole dimension ``dim`` under
    ``entry``; the backward all-gathers the gradient over ``entry``."""
    if size(entry) == 1:
        return x
    group, label = _group(entry)
    return collectives.local_block(x, dim, index(entry), size(entry),
                                   group, label)


def relayout(x: torch.Tensor, have: Sequence, want: Sequence
             ) -> torch.Tensor:
    """``x`` moved from layout ``have`` to ``want``, dimension by
    dimension: nothing, a local slice (replicated -> sharded) or an
    all-gather (sharded -> replicated). The gathers come first, so a
    dimension sliced over the axis another one is gathered over is cut
    from the whole."""
    for dim, (h, w) in enumerate(zip(have, want)):
        if h is not None and w is not None and h != w:
            raise ValueError(f"dimension {dim} moves from {h!r} to {w!r}: "
                             f"not a slice or an all-gather")
    for dim, (h, w) in enumerate(zip(have, want)):
        if h is not None and w is None:
            x = gather(x, dim, h)
    for dim, (h, w) in enumerate(zip(have, want)):
        if h is None and w is not None:
            x = local_slice(x, dim, w)
    return x


def maybe_constrain(x: torch.Tensor, logical, have=None) -> torch.Tensor:
    """``x`` (laid out by ``have``, default replicated) moved to the
    layout ``logical`` resolves to on its global shape; with no context,
    ``x``."""
    have = tuple(have) if have is not None else (None,) * x.dim()
    return relayout(x, have, spec(global_shape(x.shape, have), logical))


def reduce_partial(x: torch.Tensor, entry) -> torch.Tensor:
    """The sum over ``entry``'s ranks of a partial product (a contraction
    over a dimension sharded by ``entry``); ``x`` itself for None. The
    backward is the identity (the module's convention)."""
    if size(entry) == 1:
        return x
    group, label = _group(entry)
    return collectives.all_reduce(x.contiguous(), group, label=label)


def reduce_max(x: torch.Tensor, entry) -> torch.Tensor:
    """The element-wise maximum over ``entry``'s ranks, of ``x``
    detached: a shift that carries no gradient."""
    x = x.detach()
    if size(entry) == 1:
        return x
    group, label = _group(entry)
    return collectives.all_reduce(x.contiguous(), group, label=label,
                                  op="max")


def into_sharded(x: torch.Tensor, entry) -> torch.Tensor:
    """``x`` (replicated over ``entry``) as it enters a computation
    sharded over ``entry``: the identity, whose backward all-reduces the
    gradient over ``entry`` (each rank's is a partial sum); ``x`` itself
    for None."""
    if size(entry) == 1:
        return x
    group, label = _group(entry)
    return collectives.grad_all_reduce(x, group, label)


def leaf_entry(spec_: Sequence):
    """The axes a leaf of spec ``spec_`` is sharded on, as one entry in
    the mesh's order (None: replicated)."""
    axes = {a for e in spec_ for a in sharding.entry_axes(e)}
    order = tuple(a for a in _frame().mesh.shape if a in axes)
    return None if not order else order[0] if len(order) == 1 else order


def without(entry, axes) -> Optional[tuple]:
    """``entry``'s axes other than ``axes``, as an entry (None: none)."""
    drop = set(sharding.entry_axes(axes))
    rest = tuple(a for a in sharding.entry_axes(entry) if a not in drop)
    return None if not rest else rest[0] if len(rest) == 1 else rest


def compact(t: torch.Tensor) -> torch.Tensor:
    """``t`` contiguous in a storage of its own size: a block cut from a
    larger tensor is copied (even where it is contiguous already, as a
    block of the first dimension is), so it does not keep the whole
    alive."""
    if t.is_contiguous() and t.untyped_storage().nbytes() == \
            t.numel() * t.element_size():
        return t
    return t.clone(memory_format=torch.contiguous_format)


def shard_params(tree, logical_tree):
    """Full parameters -> this rank's blocks (copies of their own), by
    the active context's rules; with no context, ``tree``."""
    frame = current()
    if frame is None:
        return tree
    return sharding.map_logical(
        lambda log, a: compact(sharding.shard_tensor(
            a, frame.spec(tuple(a.shape), log), frame.mesh,
            frame.mesh.coord)), logical_tree, tree)


def place(tree, logical_tree):
    """Full step inputs (a batch, or a cache) -> this rank's blocks, and
    the global batch (and a cache's length) recorded for the step; with
    no context, ``tree``."""
    out = shard_params(tree, logical_tree)

    def note(log, a):
        for name, n in zip(log, a.shape):
            if name == "batch":
                declare(batch=n)
            elif name == "kv_seq":
                declare(cache_len=n)

    sharding.map_logical(note, logical_tree, tree)
    return out
