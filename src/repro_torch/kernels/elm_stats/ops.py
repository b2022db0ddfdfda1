"""The elm_stats wrapper: U = Hᵀdiag(m)H and V = Hᵀdiag(m)T in one call.

A CPU tensor goes to the plain version (``ref.elm_stats_ref``), any other
tensor to the operator ``repro_torch::elm_stats``: on a CUDA tensor the
hand kernel in ``csrc/elm_stats.cu``, on a meta tensor shapes only;
nothing falls back from one to the other. Both produce one (L, L+C)
block per member, and U and V are views of it. The kernel has no
backward: on the card, an operand that requires grad is refused while
grad mode is on (the CPU route stays differentiable).

``plan`` picks the kernel's instantiation and its row split from
(n, L, C) alone, never from k or the card, so a member's block is the
same bits whatever the number of members beside it. A split launch is
two passes (a block per chunk of rows, then the chunks' partial sums
added in order); its workspace of partial sums is an output
of the operator, so the dry run's peak counts it.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from repro_torch import kernels
from repro_torch.kernels.elm_stats import ref

NARROW_TILE = 32       # the narrow instantiation's output tile
WIDE_TILE = 64         # the wide instantiation's output tile
WIDE_MIN_L = 1280      # L from which an unsplit shape takes the wide tiles:
                       # the narrow ones were faster through L 1,024 (n 200
                       # and 512), the wide ones at every head (PERF.md §6)
STAGE_ROWS = 32        # rows of a strip's stage: a chunk's multiple
SPLIT_TILES = 132      # a member with this many 64 x 64 tiles is not split
SPLIT_MIN_ROWS = 2048  # nor a member of fewer rows
SUB = 8                # the strip's sub-block a thread: 8 x 8 outputs
STRIP_MAX_SUBS = 416   # the strip's sub-blocks, at most (a thread each)
STRIP_MAX_COLS = 256   # the strip's rows of [H | T], at most (4 groups)
STRIP_ROWS = 1536      # a strip split's chunk rows, where n gives 32 such
STRIP_MIN_CHUNKS = 32  # a strip split's chunks, at least (n permitting)
STRIP_MIN_ROWS = 384   # a strip split's chunk rows, at least
KINDS = {"narrow": 0, "wide": 1, "strip": 2}


class Plan(NamedTuple):
    instantiation: str     # "narrow", "wide" or "strip"
    tiles: int             # blocks a member and chunk: tiles, or 1 (strip)
    rows: int              # rows a chunk (n where there is one chunk)
    chunks: int
    passes: int            # launches: 2 where the rows are split
    workspace: Tuple[int, ...]   # the partial sums' shape, (0,) if none

    @property
    def kind(self) -> int:
        """The kernel's instantiation argument."""
        return KINDS[self.instantiation]


def narrow_tiles(L: int, C: int) -> int:
    """32 x 32 tiles on or above U's diagonal, V's included."""
    rows, cols = -(-L // NARROW_TILE), -(-(L + C) // NARROW_TILE)
    return sum(cols - i for i in range(rows))


def wide_tiles(L: int, C: int) -> int:
    """64 x 64 tiles: row tile i from its diagonal, 64 i, past L + C."""
    return sum(-(-(L + C - WIDE_TILE * i) // WIDE_TILE)
               for i in range(-(-L // WIDE_TILE)))


def strip_subs(L: int, C: int) -> int:
    """The strip's 8 x 8 sub-blocks: row group a from its diagonal, a, to
    the last column group of [H | T]."""
    cols = -(-(L + C) // SUB)
    return sum(cols - a for a in range(-(-L // SUB)))


def _rows(n: int, chunks: int) -> int:
    """Rows a chunk for about ``chunks`` chunks: a multiple of 32."""
    return -(-n // (chunks * STAGE_ROWS)) * STAGE_ROWS


def plan(n: int, L: int, C: int) -> Plan:
    """The instantiation and row split of one member's n x (L, C) stats.

    A member of ``SPLIT_MIN_ROWS`` rows or more with fewer than
    ``SPLIT_TILES`` tiles of 64 x 64 leaves most of the card idle, so,
    where the strip can hold its rows and sub-blocks, its rows are split
    into chunks of a multiple of ``STAGE_ROWS`` rows, a block a chunk: of
    about ``STRIP_ROWS`` rows, or ``STRIP_MIN_CHUNKS`` of at least
    ``STRIP_MIN_ROWS`` where that gives fewer. Every other shape is one
    chunk, each output one ordered sum over all n rows: the narrow tiles
    below ``WIDE_MIN_L`` (the Map's batches), the wide ones from it (the
    heads)."""
    if wide_tiles(L, C) < SPLIT_TILES and n >= SPLIT_MIN_ROWS and \
            strip_subs(L, C) <= STRIP_MAX_SUBS and \
            -(-(L + C) // SUB) * SUB <= STRIP_MAX_COLS:
        rows = _rows(n, min(max(-(-n // STRIP_ROWS), STRIP_MIN_CHUNKS),
                            n // STRIP_MIN_ROWS))
        return Plan("strip", 1, rows, -(-n // rows), 2, (0,))
    if L < WIDE_MIN_L:
        return Plan("narrow", narrow_tiles(L, C), n, 1, 1, (0,))
    return Plan("wide", wide_tiles(L, C), n, 1, 1, (0,))


def _plan(k: int, n: int, L: int, C: int) -> Plan:
    """``plan`` for k members, with the workspace of a split launch: the
    partial sums, (k, chunks, 64, sub-blocks)."""
    p = plan(n, L, C)
    if p.chunks == 1:
        return p
    return p._replace(workspace=(k, p.chunks, SUB * SUB, strip_subs(L, C)))


def elm_stats(h, t, *, mask=None):
    """h: (n, L) features, t: (n, C) targets, mask: optional (n,) row weights
    -> (U (L, L), V (L, C)) in f32; or the member-batched form h: (k, n, L),
    t: (k, n, C), mask: (k, n) -> (U (k, L, L), V (k, L, C))."""
    if h.dim() == 2:
        u, v = elm_stats(h[None], t[None],
                         mask=None if mask is None else mask[None])
        return u[0], v[0]
    _check(h, t, mask)
    if h.device.type == "cpu":
        out = ref.elm_stats_ref(h, t, mask)
    else:
        out = _launch(h, t, mask)
    L = h.shape[-1]
    return out[..., :L], out[..., L:]


def _check(h, t, mask):
    if h.dim() != 3 or t.dim() != 3:
        raise ValueError(f"member-batched elm_stats takes h (k,n,L) and t "
                         f"(k,n,C), got {tuple(h.shape)} and {tuple(t.shape)}")
    k, n, L = h.shape
    if t.shape[:2] != (k, n):
        raise ValueError(f"t {tuple(t.shape)} does not match h "
                         f"{tuple(h.shape)}")
    if min(k, n, L, t.shape[2]) < 1:
        raise ValueError(f"empty operand: h {tuple(h.shape)}, "
                         f"t {tuple(t.shape)}")
    tensors = (h, t) if mask is None else (h, t, mask)
    if mask is not None and mask.shape != (k, n):
        raise ValueError(f"mask {tuple(mask.shape)} does not match the "
                         f"({k}, {n}) rows of h")
    for a in tensors:
        if a.dtype != torch.float32:
            raise TypeError(f"elm_stats takes float32, got {a.dtype}")
        if a.device != h.device:
            raise ValueError(f"operands on {h.device} and {a.device}")


def _launch(h, t, mask):
    if h.device.type not in ("cuda", "meta"):
        raise ValueError(f"elm_stats runs on CPU, CUDA or meta tensors, "
                         f"got {h.device}")
    kernels.refuse_grad("elm_stats", (h, t) if mask is None else (h, t, mask))
    return _OP(h, t, mask)[0]


def _kernel_plan(h, t, mask):
    """(k, n, L, C) of contiguous operands the kernel takes, and its plan."""
    tensors = (h, t) if mask is None else (h, t, mask)
    if not all(a.is_contiguous() for a in tensors):
        raise ValueError("the elm_stats kernel takes contiguous operands")
    k, n, L = h.shape
    if k > 65535:
        raise ValueError(f"at most 65535 members per launch, got {k}")
    C = t.shape[2]
    return (k, n, L, C), _plan(k, n, L, C)


def _outputs(h, shape, p):
    k, n, L, C = shape
    return (torch.empty((k, L, L + C), dtype=torch.float32, device=h.device),
            torch.empty(p.workspace, dtype=torch.float32, device=h.device))


def _cuda(h, t, mask):
    shape, p = _kernel_plan(h, t, mask)
    out, part = _outputs(h, shape, p)
    with torch.cuda.device(h.device):
        kernels.launch("elm_stats", h.data_ptr(), t.data_ptr(),
                       None if mask is None else mask.data_ptr(),
                       part.data_ptr() if p.chunks > 1 else None,
                       part.numel(), out.data_ptr(), *shape, p.kind, p.rows,
                       passes=p.passes)
    return out, part


def _fake(h, t, mask):
    return _outputs(h, *_kernel_plan(h, t, mask))


def elm_stats_flops(k: int, n: int, L: int, C: int,
                    masked: bool = False) -> int:
    """The work of k members' stats over n rows: U is symmetric, so its
    pairs i <= j (L·(L+1) a row, a multiply and an add each) and all of V
    (2·L·C a row); with a mask, one product a row and feature more."""
    return k * n * (L * (L + 1) + 2 * L * C) + (k * n * L if masked else 0)


# outputs (the (k, L, L+C) stats, the partial sums of a split: a workspace,
# empty where the plan has one chunk)
_OP = kernels.register(
    "elm_stats", "(Tensor h, Tensor t, Tensor? mask) -> (Tensor, Tensor)",
    _cuda, _fake, lambda h, t, mask, *, out_shape=None: elm_stats_flops(
        h[0], h[1], h[2], t[2], mask is not None))
