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
* ``ring_exchange`` — one ``batch_isend_irecv`` of one send to a
  neighbour and one receive from the other (half a gossip mixing round);
* ``barrier``       — a one-element sum that only orders the ranks (a
  checkpoint written by rank 0 is on disk before any rank goes on).

``CALLS`` counts calls by ``(kind, group label)`` since ``reset``, as
``kernels.LAUNCHES`` counts launches, and ``BYTES`` adds up what each call
sends, by the same key: an all-reduce's tensor, an all-gather's result
(every rank's tensor), a ring exchange's one send, a barrier's one
element — the bytes the reference's ``hlo_analysis.collective_stats``
reads off a collective's shape, before its ring multiplier. ``span(label)`` isolates the calls
made inside it and appends ``(label, counts)`` to ``LOG`` when it closes,
so a run's log reads epoch by epoch and sync by sync; the ``check_*``
functions hold one span's counts to a contract, over all kinds at once.
On an LM mesh (``launch.mesh.LMMesh``) a call's label is the mesh axis
it runs over (``"model"``, ``"data"``, or ``"pod+model"`` for a tuple of
axes), so a step's traffic reads axis by axis.
"""
from __future__ import annotations

from collections import Counter
from contextlib import contextmanager
from typing import Dict, Iterator, List, NamedTuple, Optional, Tuple

import torch
import torch.distributed as dist

CALLS: Counter = Counter()                  # (kind, group label) -> calls
BYTES: Counter = Counter()                  # (kind, group label) -> bytes
LOG: List[Tuple[str, Counter]] = []         # closed spans, in order
_open: List[Counter] = []


def reset():
    """Set ``CALLS`` and ``BYTES`` to zero and empty ``LOG``."""
    CALLS.clear()
    BYTES.clear()
    LOG.clear()


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _count(kind: str, label: str, nbytes: int):
    CALLS[(kind, label)] += 1
    BYTES[(kind, label)] += nbytes
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


def all_reduce(t: torch.Tensor, group=None, label: str = "world",
               op: str = "sum") -> torch.Tensor:
    """Sum (``op="max"``: the maximum of) ``t`` in place over ``group``
    (None: the default group)."""
    _count("all_reduce", label, _nbytes(t))
    dist.all_reduce(t, op=_OPS[op], group=group)
    return t


def all_gather(t: torch.Tensor, group=None, label: str = "world",
               dim: Optional[int] = None) -> torch.Tensor:
    """(group size, *t.shape): every rank's ``t`` in group-rank order;
    with ``dim``, concatenated along ``dim`` instead (the whole of a
    dimension sharded over ``group``)."""
    t = t.contiguous()
    out = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
    _count("all_gather", label, _nbytes(t) * len(out))
    dist.all_gather(out, t, group=group)
    return torch.stack(out) if dim is None else torch.cat(out, dim=dim)


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
