"""Every ``torch.distributed`` collective of the port, counted.

The port's counterpart of the collective contracts of
``repro.analysis.hlo``: where the reference counts the collectives in a
compiled program (``check_one_all_reduce``, ``check_two_all_reduces``,
``check_no_collectives``, ``check_gossip_sync``), the port counts its calls
as they are made. No other module of ``repro_torch`` calls a
``torch.distributed`` collective.

Kinds:

* ``all_reduce``    — an in-place sum (or max) over a group;
* ``all_gather``    — every rank's tensor, stacked in group-rank order
  (with ``dim``: concatenated along one dimension);
* ``reduce_scatter`` — the sum over a group, of which each rank keeps
  its block along one dimension;
* ``broadcast`` / ``reduce`` — one rank's tensor to every rank of a
  group, and the sum over the group to one rank (a layer held by one
  rank fetched where it is used, and its gradient summed back to it);
* ``ring_exchange`` — one ``batch_isend_irecv`` of one send to a
  neighbour and one receive from the other (half a gossip mixing round);
* ``barrier``       — a one-element sum that only orders the ranks (a
  checkpoint written by rank 0 is on disk before any rank goes on).

``CALLS`` counts calls by ``(kind, group label)`` since ``reset``, as
``kernels.LAUNCHES`` counts launches, and ``BYTES`` adds up what each call
sends, by the same key: an all-reduce's tensor, an all-gather's result
(every rank's tensor), a reduce-scatter's input (every rank's block), a
broadcast's or a reduce's tensor, a ring exchange's one send, a
barrier's one element — the bytes the reference's ``hlo_analysis.collective_stats``
reads off a collective's shape, before its ring multiplier. ``span(label)`` isolates the calls
made inside it and appends ``(label, counts)`` to ``LOG`` when it closes,
so a run's log reads epoch by epoch and sync by sync; the ``check_*``
functions hold one span's counts to a contract, over all kinds at once.
On an LM mesh (``launch.mesh.LMMesh``) a call's label is the mesh axis
it runs over (``"model"``, ``"data"``, or ``"pod+model"`` for a tuple of
axes), so a step's traffic reads axis by axis.

**Under autograd.** ``all_reduce`` (a sum), ``all_gather`` and
``reduce_scatter`` are differentiable where their input requires grad
and grad mode is on, and two more moves send a collective only in the
backward (``grad_all_reduce``, ``local_block``). Their backward follows
one convention, the one ``distributed/ctx.py`` writes down: the gradient
of a replicated tensor is itself replicated, the same on every rank of
the group. So an all-reduce's backward is the gradient as it is, an
all-gather's is this rank's block of it, a reduce-scatter's all-gathers
the blocks' gradients, ``grad_all_reduce`` (identity forward) all-reduces
the gradient, and ``local_block`` (this rank's block of a replicated
tensor) all-gathers it. Two moves of a weight break the convention on
purpose, since the weight's gradient is not replicated but each rank's
share of it, over tokens of its own: ``gather_weight`` (a block of a
weight sharded over the batch's axes, all-gathered where it is used)
reduce-scatters its gradient, so each rank keeps its block of the sum,
and ``broadcast`` (a layer fetched from the rank that holds it) reduces
its gradient to that rank. A collective sent in a backward
is counted in ``CALLS`` and ``BYTES`` as a forward one is, and also in
``BACKWARD_CALLS`` / ``BACKWARD_BYTES`` by the same key, so a step's
traffic reads by direction too. A forward recomputed in the backward
(a checkpointed layer) sends its forward collectives again, counted as
forward ones.
"""
from __future__ import annotations

from collections import Counter
from contextlib import contextmanager
from typing import Dict, Iterator, List, NamedTuple, Optional, Tuple

import torch
import torch.distributed as dist

CALLS: Counter = Counter()                  # (kind, group label) -> calls
BYTES: Counter = Counter()                  # (kind, group label) -> bytes
BACKWARD_CALLS: Counter = Counter()         # the part sent in a backward
BACKWARD_BYTES: Counter = Counter()
LOG: List[Tuple[str, Counter]] = []         # closed spans, in order
_open: List[Counter] = []


def reset():
    """Set ``CALLS``, ``BYTES`` and their backward parts to zero and
    empty ``LOG``."""
    CALLS.clear()
    BYTES.clear()
    BACKWARD_CALLS.clear()
    BACKWARD_BYTES.clear()
    LOG.clear()


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _count(kind: str, label: str, nbytes: int, backward: bool = False):
    CALLS[(kind, label)] += 1
    BYTES[(kind, label)] += nbytes
    if backward:
        BACKWARD_CALLS[(kind, label)] += 1
        BACKWARD_BYTES[(kind, label)] += nbytes
    for counts in _open:
        counts[(kind, label)] += 1


@contextmanager
def span(label: str) -> Iterator[Counter]:
    """Count the collectives called inside the block; on exit the counts
    are appended to ``LOG`` under ``label``. Spans nest: an outer span
    counts its inner spans' calls too."""
    counts: Counter = Counter()
    _open.append(counts)
    try:
        yield counts
    finally:
        _open.remove(counts)
        LOG.append((label, counts))


_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}


def _tracked(t: torch.Tensor) -> bool:
    """Whether autograd records an op on ``t``."""
    return t.requires_grad and torch.is_grad_enabled()


def _sum(t: torch.Tensor, group, label: str, backward: bool = False):
    _count("all_reduce", label, _nbytes(t), backward)
    dist.all_reduce(t, op=dist.ReduceOp.SUM, group=group)
    return t


def _gather(t: torch.Tensor, group, label: str, dim: Optional[int],
            backward: bool = False) -> torch.Tensor:
    t = t.contiguous()
    out = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
    _count("all_gather", label, _nbytes(t) * len(out), backward)
    dist.all_gather(out, t, group=group)
    return torch.stack(out) if dim is None else torch.cat(out, dim=dim)


def _scatter_sum(t: torch.Tensor, group, label: str, dim: int,
                 backward: bool = False) -> torch.Tensor:
    """This rank's block along ``dim`` of the sum of ``t`` over the
    group (one reduce-scatter; ``t``'s dimension divides by the group's
    size)."""
    parts = [c.contiguous() for c in
             t.chunk(dist.get_world_size(group), dim=dim)]
    out = torch.empty_like(parts[0])
    _count("reduce_scatter", label, _nbytes(t), backward)
    dist.reduce_scatter(out, parts, group=group)
    return out


def _block(g: torch.Tensor, dim: Optional[int], index: int,
           n: int) -> torch.Tensor:
    """Block ``index`` (of ``n`` rows along ``dim``; None: the stacked
    dim) of ``g``."""
    return g[index] if dim is None else g.narrow(dim, index * n, n)


class _AllReduce(torch.autograd.Function):
    """The sum over the group, out of place; the backward passes the
    (replicated) gradient on as it is."""

    @staticmethod
    def forward(fctx, t, group, label):
        return _sum(t.clone(memory_format=torch.contiguous_format), group,
                    label)

    @staticmethod
    def backward(fctx, g):
        return g, None, None


class _AllGather(torch.autograd.Function):
    """Every rank's block; the backward keeps this rank's block of the
    (replicated) gradient."""

    @staticmethod
    def forward(fctx, t, group, label, dim):
        fctx.dim, fctx.n = dim, (None if dim is None else t.shape[dim])
        fctx.index = dist.get_rank(group)
        return _gather(t, group, label, dim)

    @staticmethod
    def backward(fctx, g):
        return _block(g, fctx.dim, fctx.index, fctx.n), None, None, None


class _ReduceScatter(torch.autograd.Function):
    """This rank's block of the sum; the backward all-gathers the blocks'
    gradients into the whole (replicated) one."""

    @staticmethod
    def forward(fctx, t, group, label, dim):
        fctx.group, fctx.label, fctx.dim = group, label, dim
        return _scatter_sum(t, group, label, dim)

    @staticmethod
    def backward(fctx, g):
        return (_gather(g, fctx.group, fctx.label, fctx.dim, backward=True),
                None, None, None)


class _GatherWeight(torch.autograd.Function):
    """Every rank's block of a weight; the backward reduce-scatters the
    gradient, each rank's being its own tokens' share of the whole."""

    @staticmethod
    def forward(fctx, t, group, label, dim):
        fctx.group, fctx.label, fctx.dim = group, label, dim
        return _gather(t, group, label, dim)

    @staticmethod
    def backward(fctx, g):
        return (_scatter_sum(g, fctx.group, fctx.label, fctx.dim,
                             backward=True), None, None, None)


def _bcast(t: torch.Tensor, src: int, group, label: str) -> torch.Tensor:
    """Group rank ``src``'s ``t`` in a tensor of its own on every rank
    (the others' ``t`` gives only the shape)."""
    out = t.clone(memory_format=torch.contiguous_format) \
        if dist.get_rank(group) == src \
        else torch.empty_like(t, memory_format=torch.contiguous_format)
    _count("broadcast", label, _nbytes(out))
    dist.broadcast(out, src=dist.get_global_rank(group, src), group=group)
    return out


class _Broadcast(torch.autograd.Function):
    """Group rank ``src``'s tensor on every rank; the backward sums the
    ranks' gradients onto ``src`` (the others' inputs get none)."""

    @staticmethod
    def forward(fctx, t, src, group, label):
        fctx.src, fctx.group, fctx.label = src, group, label
        fctx.mine = dist.get_rank(group) == src
        return _bcast(t, src, group, label)

    @staticmethod
    def backward(fctx, g):
        g = g.clone(memory_format=torch.contiguous_format)
        _count("reduce", fctx.label, _nbytes(g), backward=True)
        dist.reduce(g, dst=dist.get_global_rank(fctx.group, fctx.src),
                    group=fctx.group)
        return (g if fctx.mine else None), None, None, None


class _GradAllReduce(torch.autograd.Function):
    """The identity; the backward sums the gradient over the group."""

    @staticmethod
    def forward(fctx, t, group, label):
        fctx.group, fctx.label = group, label
        return t.view_as(t)

    @staticmethod
    def backward(fctx, g):
        g = g.clone(memory_format=torch.contiguous_format)
        return _sum(g, fctx.group, fctx.label, backward=True), None, None


class _LocalBlock(torch.autograd.Function):
    """This rank's block of a replicated tensor; the backward all-gathers
    the blocks' gradients into the whole (replicated) one."""

    @staticmethod
    def forward(fctx, t, group, label, dim, index, n):
        fctx.group, fctx.label, fctx.dim = group, label, dim
        return t.narrow(dim, index * n, n)

    @staticmethod
    def backward(fctx, g):
        return (_gather(g, fctx.group, fctx.label, fctx.dim, backward=True),
                None, None, None, None, None)


def all_reduce(t: torch.Tensor, group=None, label: str = "world",
               op: str = "sum") -> torch.Tensor:
    """Sum (``op="max"``: the maximum of) ``t`` in place over ``group``
    (None: the default group). Where autograd records ``t``: the sum out
    of place, its backward the gradient as it is (the module's
    convention); a maximum carries no gradient and refuses such a
    ``t``."""
    if _tracked(t):
        if op != "sum":
            raise ValueError(f"all_reduce {op!r} carries no gradient: "
                             f"pass a detached tensor")
        return _AllReduce.apply(t, group, label)
    _count("all_reduce", label, _nbytes(t))
    dist.all_reduce(t, op=_OPS[op], group=group)
    return t


def all_gather(t: torch.Tensor, group=None, label: str = "world",
               dim: Optional[int] = None) -> torch.Tensor:
    """(group size, *t.shape): every rank's ``t`` in group-rank order;
    with ``dim``, concatenated along ``dim`` instead (the whole of a
    dimension sharded over ``group``). Where autograd records ``t``, its
    backward is this rank's block of the gradient."""
    if _tracked(t):
        return _AllGather.apply(t, group, label, dim)
    return _gather(t, group, label, dim)


def reduce_scatter(t: torch.Tensor, group=None, label: str = "world",
                   dim: int = 0) -> torch.Tensor:
    """This rank's block along ``dim`` of the sum of ``t`` over ``group``
    (the dimension divides by the group's size). Where autograd records
    ``t``, its backward all-gathers the gradient."""
    if _tracked(t):
        return _ReduceScatter.apply(t, group, label, dim)
    return _scatter_sum(t, group, label, dim)


def gather_weight(t: torch.Tensor, group=None, label: str = "world",
                  dim: int = 0) -> torch.Tensor:
    """The whole of a weight's dimension ``dim``, of which each rank of
    ``group`` holds a block (an all-gather). Where autograd records
    ``t``, its backward is one reduce-scatter: each rank's gradient of
    the whole weight is its own tokens' share, and their sum's block is
    the gradient of its block."""
    if _tracked(t):
        return _GatherWeight.apply(t, group, label, dim)
    return _gather(t, group, label, dim)


def broadcast(t: torch.Tensor, src: int, group=None,
              label: str = "world") -> torch.Tensor:
    """Group rank ``src``'s ``t`` on every rank of ``group``, in a
    tensor of its own (the others' ``t`` gives only the shape). Where
    autograd records ``t``, the backward reduces the gradients onto
    ``src``."""
    if _tracked(t):
        return _Broadcast.apply(t, src, group, label)
    return _bcast(t, src, group, label)


def grad_all_reduce(t: torch.Tensor, group=None,
                    label: str = "world") -> torch.Tensor:
    """``t`` itself, whose gradient the backward sums over ``group``:
    where a replicated tensor enters a computation sharded over the
    group, each rank's gradient of it is a partial sum. Sends nothing
    where autograd does not record ``t``."""
    if not _tracked(t):
        return t
    return _GradAllReduce.apply(t, group, label)


def local_block(t: torch.Tensor, dim: int, index: int, parts: int,
                group=None, label: str = "world") -> torch.Tensor:
    """Block ``index`` of ``parts`` equal blocks of ``t``'s dimension
    ``dim`` (a view; ``parts`` is ``group``'s size); where autograd
    records ``t``, the backward all-gathers the blocks' gradients over
    ``group``."""
    n = t.shape[dim] // parts
    if not _tracked(t):
        return t.narrow(dim, index * n, n)
    return _LocalBlock.apply(t, group, label, dim, index, n)


def ring_exchange(send: torch.Tensor, to_rank: int, from_rank: int,
                  group=None, label: str = "world") -> torch.Tensor:
    """Send ``send`` to group rank ``to_rank`` and receive a tensor of its
    shape from group rank ``from_rank``, as one ``batch_isend_irecv`` of
    one send and one receive; both ends may be the same peer."""
    recv = torch.empty_like(send)
    send = send.contiguous()
    g = dist.group.WORLD if group is None else group
    _count("ring_exchange", label, _nbytes(send))
    reqs = dist.batch_isend_irecv([
        dist.P2POp(dist.isend, send, dist.get_global_rank(g, to_rank), g),
        dist.P2POp(dist.irecv, recv, dist.get_global_rank(g, from_rank), g),
    ])
    for req in reqs:
        req.wait()
    return recv


def barrier(device, group=None, label: str = "world"):
    """Return only once every rank of ``group`` has called it."""
    flag = torch.zeros(1, device=device)
    _count("barrier", label, _nbytes(flag))
    dist.all_reduce(flag, op=dist.ReduceOp.SUM, group=group)


# ---------------------------------------------------------------------------
# The contracts (``repro.analysis.hlo``'s, on counted calls)
# ---------------------------------------------------------------------------

class Check(NamedTuple):
    """One contract check: its name, whether it held, and what was seen
    (``repro_torch.analysis.audit`` reports these too)."""
    name: str
    ok: bool
    detail: str

    def __str__(self):
        mark = "ok " if self.ok else "FAIL"
        return f"[{mark}] {self.name}" + (f": {self.detail}"
                                          if self.detail else "")


def by_kind(counts: Counter) -> Dict[str, int]:
    """A span's counts summed over groups, by kind (zero kinds left out)."""
    out: Dict[str, int] = {}
    for (kind, _), n in counts.items():
        if n:
            out[kind] = out.get(kind, 0) + n
    return out


def check_collectives(counts: Counter, *, expect: Dict[str, int],
                      name: str = "collectives") -> Check:
    """The span's counts by kind must EQUAL ``expect`` (``{}``: none)."""
    got = by_kind(counts)
    ok = got == dict(expect)
    return Check(name, ok, f"{got or 'none'}" if ok else
                 f"expected {dict(expect) or 'none'}, counted "
                 f"{got or 'none'}")


def check_one_all_reduce(counts: Counter, *,
                         name: str = "one-all-reduce") -> Check:
    """Exactly one all-reduce, nothing else: the flat mesh's Reduce and
    sync."""
    return check_collectives(counts, expect={"all_reduce": 1}, name=name)


def check_two_all_reduces(counts: Counter, *,
                          name: str = "two-all-reduces") -> Check:
    """Exactly two all-reduces, nothing else: the hierarchical
    ``('host', 'pod')`` Reduce and sync, one within a host and one
    across hosts."""
    return check_collectives(counts, expect={"all_reduce": 2}, name=name)


def check_no_collectives(counts: Counter, *,
                         name: str = "zero-collectives") -> Check:
    """No collective at all: the contract of every epoch."""
    return check_collectives(counts, expect={}, name=name)


def check_gossip_sync(counts: Counter, *, rounds: int, ring: int,
                      name: str = "gossip-ring") -> Check:
    """The gossip sync: exactly ``2·rounds`` ring exchanges and nothing
    else (no all-reduce). A ring of one node exchanges nothing: it mixes
    with itself locally."""
    expect = {"ring_exchange": 2 * rounds} if ring > 1 else {}
    return check_collectives(counts, expect=expect, name=name)
