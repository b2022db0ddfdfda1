"""Sharding rules for the port's meshes — the counterpart of
``repro.distributed.sharding``, in two halves.

**The LM's logical axes.** Models name every dimension of a parameter,
input or cache with a *logical* axis ("vocab", "heads", "ff", "expert",
"batch", "kv_seq", ...), and ``resolve_spec`` maps the names to mesh axes
by ``DEFAULT_RULES`` (or rules laid over them, such as the dry run's
``MULTIPOD_RULES``): the first candidate axis (or tuple of axes) that is
free in this array and divides the dimension wins, else the dimension is
replicated (MiniCPM's vocab of 122,753 over model 16). A mesh is anything
with ``.shape``, a dict of axis sizes, and a spec is the tuple of the
entries of the reference's ``PartitionSpec``: None, an axis name, or a
tuple of names. ``shard_tensor`` / ``shard_tree`` cut a full tensor into
the block a mesh coordinate holds, which is how the port places a model on
its (data, model) mesh (``distributed/ctx.py`` runs it there).

**The member dim over a member mesh** (``member_dim_specs``,
``stacked_batch_specs`` of the reference): k members over ``slots`` ranks
(the pods of a 1-D mesh, hosts × pods of a 2-D one) pad to ``k_pad =
ceil(k / slots) · slots``; the rank in slot s holds the global members
``[s · k_local, (s + 1) · k_local)``, with ``k_local = k_pad / slots``, of
which those ≥ k are padding. A rank holds data, params and stats only for
its real members: the padding exists as zero rows where every rank must
send rows of one shape (``pad_rows``, the gathers) and as zero weights.
Slots and ranks follow the mesh's row-major order.
"""
from __future__ import annotations

from typing import Mapping, Optional, Sequence, Tuple

import torch

# logical axis -> ordered candidate mesh axes (the first that divides and
# is free in the array wins); the reference's table
DEFAULT_RULES = {
    "member": (("host", "pod"), "pod"),
    "batch": ("data",),
    "vocab": ("model",),
    "heads": ("model",),
    "kv_heads": ("model",),
    "ff": ("model",),
    "expert": ("model",),
    "kv_seq": ("model",),   # the decode cache's sequence
    "ssm_heads": ("model",),
    "embed": (),            # d_model stays replicated
    "layers": (),
    "seq": (),
    "head_dim": (),
    "state": (),
    "classes": (),
    "feature": (),
}


def entry_axes(entry) -> Tuple[str, ...]:
    """The mesh axes of one spec entry (None: none)."""
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


def entry_size(entry, mesh_shape: Mapping[str, int]) -> int:
    """How many blocks a dimension splits into under one spec entry."""
    n = 1
    for a in entry_axes(entry):
        n *= mesh_shape[a]
    return n


def resolve_spec(shape: Sequence[int], logical: Sequence[Optional[str]],
                 mesh, rules=None) -> tuple:
    """One logical spec -> the spec of ``shape`` on ``mesh``, entry by
    entry as the reference's ``resolve_spec``: a rule's candidate is an
    axis name or a tuple of names; the first whose axes all exist, are
    unused in this array and whose size divides the dimension wins, else
    the dimension is replicated (None)."""
    rules = {**DEFAULT_RULES, **(rules or {})}
    if len(logical) != len(shape):
        raise ValueError(f"logical {logical} does not match shape {shape}")
    used, out = set(), []
    for dim, name in zip(shape, logical):
        axis = None
        if name is not None:
            for cand in rules.get(name, ()):
                axes = entry_axes(cand)
                size = 1
                for a in axes:
                    size *= mesh.shape.get(a, 0) or 0
                if size and not (set(axes) & used) and dim % size == 0:
                    axis = cand
                    used.update(axes)
                    break
        out.append(axis)
    return tuple(out)


def is_logical_leaf(x) -> bool:
    """A logical spec: a tuple of axis names and Nones (``()`` included)."""
    return isinstance(x, tuple) and all(e is None or isinstance(e, str)
                                        for e in x)


def map_logical(fn, logical_tree, *trees):
    """``fn(logical_spec, *leaves)`` over a logical tree and trees of the
    same structure (nested dicts, tuples and lists), the logical specs
    taken as leaves."""
    if isinstance(logical_tree, dict):
        return {k: map_logical(fn, v, *(t[k] for t in trees))
                for k, v in logical_tree.items()}
    if is_logical_leaf(logical_tree):
        return fn(logical_tree, *trees)
    return type(logical_tree)(map_logical(fn, v, *parts) for v, *parts in
                              zip(logical_tree, *trees))


def _shape(leaf) -> Tuple[int, ...]:
    return tuple(leaf) if isinstance(leaf, (tuple, list)) else \
        tuple(leaf.shape)


def resolve_tree(shapes_tree, logical_tree, mesh, rules=None):
    """The spec of every leaf: ``shapes_tree`` holds shapes, or anything
    with ``.shape`` (tensors, numpy arrays, ``TensorSpec``)."""
    return map_logical(lambda log, s: resolve_spec(_shape(s), log, mesh,
                                                   rules),
                       logical_tree, shapes_tree)


def opt_logical(optimizer_name: str, p_logical):
    """The logical axes of an optimizer's state, as the reference's dry run
    lays it out (its ``_opt_logical``): AdamW's μ and ν and momentum's
    trace take each leaf's layout; SGD has no state."""
    if optimizer_name == "adamw":
        return {"mu": p_logical, "nu": p_logical}
    if optimizer_name == "momentum":
        return p_logical
    return ()


def with_member_dim(logical_tree):
    """Prepend the 'member' logical axis (the distributed-averaging dim)."""
    return map_logical(lambda log: ("member",) + tuple(log), logical_tree)


def block_shape(shape: Sequence[int], spec: Sequence, mesh_shape
                ) -> Tuple[int, ...]:
    """The shape of one coordinate's block of a ``shape`` array."""
    return tuple(d // entry_size(e, mesh_shape) for d, e in zip(shape, spec))


def entry_index(entry, coord: Mapping[str, int],
                mesh_shape: Mapping[str, int]) -> int:
    """Which block of a dimension a coordinate holds: row-major over the
    entry's axes (the first axis major), as GSPMD lays a tuple out."""
    i = 0
    for a in entry_axes(entry):
        i = i * mesh_shape[a] + coord[a]
    return i


def shard_tensor(x, spec: Sequence, mesh, coord: Mapping[str, int]):
    """The block of ``x`` (a full tensor or numpy array) that mesh
    coordinate ``coord`` holds under ``spec``, as a view."""
    for dim, entry in enumerate(spec):
        n = entry_size(entry, mesh.shape)
        if n == 1:
            continue
        size = x.shape[dim] // n
        i = entry_index(entry, coord, mesh.shape)
        index = (slice(None),) * dim + (slice(i * size, (i + 1) * size),)
        x = x[index]
    return x


def shard_tree(tree, logical_tree, mesh, coord: Mapping[str, int],
               rules=None):
    """Every leaf of ``tree`` cut to ``coord``'s block by its resolved
    spec (views of the full leaves)."""
    return map_logical(
        lambda log, a: shard_tensor(a, resolve_spec(_shape(a), log, mesh,
                                                    rules), mesh, coord),
        logical_tree, tree)


def bytes_of_tree(tree) -> int:
    """The bytes of a tree's leaves (tensors, numpy arrays, ``TensorSpec``)."""
    from repro_torch.tree import tree_leaves
    return sum(int(a.nbytes) for a in tree_leaves(tree))


def member_axes(mesh) -> Tuple[str, ...]:
    """The mesh axes that carry the member dim: ``('host', 'pod')`` on the
    2-D mesh, ``('pod',)`` on the flat one."""
    names = tuple(mesh.mesh_dim_names or ())
    if "pod" not in names:
        raise ValueError(f"the member mesh needs a 'pod' axis, got axes "
                         f"{names}")
    return ("host", "pod") if "host" in names else ("pod",)


def member_slots(mesh) -> int:
    """Ranks holding members: the mesh's size along its member axes."""
    names = tuple(mesh.mesh_dim_names)
    n = 1
    for a in member_axes(mesh):
        n *= mesh.size(names.index(a))
    return n


def k_pad(k: int, slots: int) -> int:
    """k rounded up to a multiple of the slot count."""
    if k < 1 or slots < 1:
        raise ValueError(f"need k >= 1 and slots >= 1, got {k}, {slots}")
    return -(-k // slots) * slots


def member_slice(k: int, slots: int, slot: int) -> range:
    """The global indices of the real members slot ``slot`` holds (empty
    for a slot of padding only)."""
    k_local = k_pad(k, slots) // slots
    return range(min(slot * k_local, k), min((slot + 1) * k_local, k))


def pad_rows(rows: torch.Tensor, n: int) -> torch.Tensor:
    """``rows`` (m, ...) with zero rows appended up to (n, ...)."""
    if rows.shape[0] > n:
        raise ValueError(f"{rows.shape[0]} rows do not fit in {n}")
    if rows.shape[0] == n:
        return rows
    pad = torch.zeros((n - rows.shape[0],) + tuple(rows.shape[1:]),
                      dtype=rows.dtype, device=rows.device)
    return torch.cat([rows, pad])
