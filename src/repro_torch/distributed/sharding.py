"""The member-dim layout over a member mesh — the port's counterpart of
the member-dim half of ``repro.distributed.sharding`` (``member_dim_specs``,
``stacked_batch_specs``); the LM's logical-axis rules come with the LM
training slice.

k members over ``slots`` ranks (the pods of a 1-D mesh, hosts × pods of a
2-D one) pad to ``k_pad = ceil(k / slots) · slots``; the rank in slot s
holds the global members ``[s · k_local, (s + 1) · k_local)``, with
``k_local = k_pad / slots``, of which those ≥ k are padding. A rank holds
data, params and stats only for its real members: the padding exists as
zero rows where every rank must send rows of one shape (``pad_rows``, the
gathers) and as zero weights. Slots and ranks follow the mesh's row-major
order.
"""
from __future__ import annotations

from typing import Tuple

import torch

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
