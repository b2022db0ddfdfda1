"""Data partitioning for distributed-averaging training (Alg. 1 line 1-2).

``partition_iid``     — shuffle then split: every machine sees the full
                        distribution (the extended-MNIST regime, Table 4/5).
``partition_by_class``— contiguous/class-sorted split: machines see skewed
                        distributions (the not-MNIST regime, Table 2/3).
``partition_unequal`` — shuffle then split into explicit shard sizes: the
                        'training data distribution needs to be carefully
                        selected' regime the paper flags as its drawback.
``partition_dirichlet``—Dirichlet(α) label-skew split: per-class member
                        proportions drawn from Dir(α·1_k) — the tunable
                        non-IID regime the pluggable Reduce strategies
                        (boosted/gossip) are benchmarked on.

The port's copy of ``repro.data.partition``: batch order is part of the
parity contract with the reference, so every function here draws exactly
the reference's permutations.

``batches`` is the streaming iterator (host loop, the faithful path);
``epoch_batch_arrays``/``stacked_epoch_batches`` materialise the SAME batch
order as fixed-shape arrays so the stacked Map phase walks every member's
epoch in one member-batched loop.

Epoch rng contract (shared by every batch function): one ``default_rng(seed)``
stream yields one permutation per epoch, so epoch e's batch order is the
(e+1)-th draw. ``start_epoch``/``epoch`` advance the stream without
consuming data — the stacked per-epoch arrays and the streaming iterator
replay identical orders at every epoch, not just the first. ``seed`` may
also be a ``np.random.Generator``, consumed IN PLACE
(``default_rng(gen)`` passes it through): the training loops keep one
stream per member across their epoch loop so epoch e costs one draw
instead of replaying e+1 permutations from scratch.

``padded_stacked_epoch_batches`` lifts the equal-batch-count restriction:
every member's epoch is padded to the max batch count and a per-batch
validity mask (1 = real, 0 = padding) rides along; masked batches
contribute zero to the ELM stats and skip the SGD update (see
``core.cnn_elm``/``core.elm``).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np


@dataclass
class Partition:
    x: np.ndarray
    y: np.ndarray


def partition_iid(x: np.ndarray, y: np.ndarray, k: int, seed: int = 0) -> List[Partition]:
    rng = np.random.default_rng(seed)
    idx = rng.permutation(len(x))
    p = len(x) // k  # P = floor(m/k), paper line 1
    return [Partition(x[idx[i * p:(i + 1) * p]], y[idx[i * p:(i + 1) * p]])
            for i in range(k)]


def partition_by_class(x: np.ndarray, y: np.ndarray, k: int) -> List[Partition]:
    order = np.argsort(y, kind="stable")
    x, y = x[order], y[order]
    p = len(x) // k
    return [Partition(x[i * p:(i + 1) * p], y[i * p:(i + 1) * p]) for i in range(k)]


def partition_contiguous(x: np.ndarray, y: np.ndarray, k: int) -> List[Partition]:
    """Split the stream as-stored (non-IID iff the source is class-blocked,
    which is exactly how make_not_mnist lays data out)."""
    p = len(x) // k
    return [Partition(x[i * p:(i + 1) * p], y[i * p:(i + 1) * p]) for i in range(k)]


def partition_unequal(x: np.ndarray, y: np.ndarray, sizes: Sequence[int],
                      seed: int = 0) -> List[Partition]:
    """Shuffle then split into shards of the given row counts — the unequal
    regime both Map paths must now handle (masked-stacked or sequential +
    ``average_models(weights=sizes)``). When ``sum(sizes) < len(x)`` the
    leftover rows are deliberately DROPPED (a subsample, like the paper's
    floor(m/k) truncation); oversubscribing raises."""
    if sum(sizes) > len(x):
        raise ValueError(f"sizes {list(sizes)} sum past {len(x)} rows")
    rng = np.random.default_rng(seed)
    idx = rng.permutation(len(x))
    out, at = [], 0
    for s in sizes:
        out.append(Partition(x[idx[at:at + s]], y[idx[at:at + s]]))
        at += s
    return out


def partition_dirichlet(x: np.ndarray, y: np.ndarray, k: int,
                        alpha: float, seed: int = 0,
                        min_rows: int = 0) -> List[Partition]:
    """Dirichlet(α) label-skew split — the standard non-IID benchmark
    partitioner: for each class c, draw member proportions
    ``p_c ~ Dirichlet(α·1_k)`` and scatter class c's rows over the k
    members by those proportions. Every row lands in exactly ONE member
    (rows conserved by construction); ``α → ∞`` recovers an IID-like
    split while ``α → 0`` approaches one-class-per-member — the regime
    where uniform averaging degrades most (see
    ``benchmarks/reduce_strategies.py``).

    Deterministic per ``seed``. ``min_rows > 0`` re-draws the whole
    assignment under ``seed+1, seed+2, ...`` until every member holds at
    least that many rows (α near 0 can starve a member) — still
    deterministic, and the accepted attempt is a pure Dirichlet draw."""
    if k < 1:
        raise ValueError(f"k must be >= 1, got {k}")
    if not alpha > 0.0:
        raise ValueError(f"alpha must be > 0, got {alpha}")
    y = np.asarray(y)
    if len(x) != len(y):
        raise ValueError(f"{len(x)} rows of x for {len(y)} labels")
    for attempt in range(100):
        rng = np.random.default_rng(seed + attempt)
        member_rows: List[List[int]] = [[] for _ in range(k)]
        for c in np.unique(y):
            rows = np.flatnonzero(y == c)
            rng.shuffle(rows)
            p = rng.dirichlet(np.full(k, float(alpha)))
            cuts = np.round(np.cumsum(p)[:-1] * len(rows)).astype(int)
            for m, part in enumerate(np.split(rows, cuts)):
                member_rows[m].extend(part.tolist())
        if all(len(r) >= min_rows for r in member_rows):
            out = []
            for r in member_rows:
                idx = np.asarray(r, np.int64)
                rng.shuffle(idx)       # no class-blocked row runs
                out.append(Partition(x[idx], y[idx]))
            return out
    raise ValueError(
        f"no Dirichlet(alpha={alpha}) draw in 100 attempts gave every "
        f"member >= {min_rows} rows over {len(x)} rows / k={k} — lower "
        f"min_rows or raise alpha")


def batches(part: Partition, batch_size: int, seed: int = 0, epochs: int = 1,
            start_epoch: int = 0):
    """Shuffled minibatch iterator over one partition (paper line 4).

    ``start_epoch`` skips that many permutations of the rng stream first, so
    ``batches(p, B, seed, start_epoch=e)`` yields exactly epoch e of
    ``batches(p, B, seed, epochs=e+1)`` — the per-epoch-reshuffle contract
    shared with ``epoch_batch_arrays``. Pass an in-place Generator as
    ``seed`` (with ``start_epoch=0``) to draw from a live stream instead."""
    rng = np.random.default_rng(seed)
    n = (len(part.x) // batch_size) * batch_size
    for _ in range(start_epoch):
        rng.permutation(len(part.x))
    for _ in range(epochs):
        idx = rng.permutation(len(part.x))[:n]
        for i in range(0, n, batch_size):
            j = idx[i:i + batch_size]
            yield part.x[j], part.y[j]


def epoch_batch_arrays(part: Partition, batch_size: int, seed: int = 0,
                       epoch: int = 0) -> Tuple[np.ndarray, np.ndarray]:
    """Epoch ``epoch`` of ``batches(part, batch_size, seed)`` as fixed-shape
    arrays: x (nb, B, ...) and y (nb, B). Bit-identical batch order to the
    iterator (same rng stream advanced ``epoch`` permutations, same
    floor(n/B)*B truncation), so the scan-based fast path consumes exactly
    the data the sequential reference would at that epoch."""
    rng = np.random.default_rng(seed)
    n = (len(part.x) // batch_size) * batch_size
    if n == 0:
        raise ValueError(
            f"partition of {len(part.x)} rows yields no batch of {batch_size}")
    for _ in range(epoch):
        rng.permutation(len(part.x))
    idx = rng.permutation(len(part.x))[:n]
    nb = n // batch_size
    x = part.x[idx].reshape(nb, batch_size, *part.x.shape[1:])
    y = part.y[idx].reshape(nb, batch_size)
    return x, y


def stacked_epoch_batches(partitions: Sequence[Partition], batch_size: int,
                          seeds: Sequence[int],
                          epoch: int = 0) -> Tuple[np.ndarray, np.ndarray]:
    """All k members' epoch batches stacked member-major: x (k, nb, B, ...)
    and y (k, nb, B). This is the STRICT variant: every partition must yield
    the same batch count (the paper's P = floor(m/k) split guarantees it).
    Unequal shards take ``padded_stacked_epoch_batches`` instead, which pads
    to the max count and returns a validity mask."""
    per = [epoch_batch_arrays(p, batch_size, seed=s, epoch=epoch)
           for p, s in zip(partitions, seeds)]
    counts = {x.shape[0] for x, _ in per}
    if len(counts) != 1:
        raise ValueError(
            f"stacked Map phase needs equal batch counts per member, got "
            f"{sorted(x.shape[0] for x, _ in per)}; use "
            f"padded_stacked_epoch_batches for unequal shards")
    return (np.stack([x for x, _ in per]), np.stack([y for _, y in per]))


def padded_stacked_epoch_batches(
        partitions: Sequence[Partition], batch_size: int,
        seeds: Sequence[int], epoch: int = 0,
        num_batches: Optional[int] = None,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Member-major epoch batches padded to a common batch count, plus the
    per-batch validity mask: x (k, nb, B, ...), y (k, nb, B),
    mask (k, nb) f32 with 1.0 on real batches and 0.0 on padding.

    Each member's prefix is bit-identical to its ``epoch_batch_arrays``;
    padding rows are zeros (their contribution is cancelled by the mask, not
    by the data). ``num_batches`` rounds the common count further up — the
    chunked scan uses it to make every chunk the same fixed shape."""
    per = [epoch_batch_arrays(p, batch_size, seed=s, epoch=epoch)
           for p, s in zip(partitions, seeds)]
    nb = max(x.shape[0] for x, _ in per)
    if num_batches is not None:
        if num_batches < nb:
            raise ValueError(f"num_batches {num_batches} < max count {nb}")
        nb = num_batches
    k = len(per)
    x0, y0 = per[0]
    xs = np.zeros((k, nb) + x0.shape[1:], x0.dtype)
    ys = np.zeros((k, nb) + y0.shape[1:], y0.dtype)
    mask = np.zeros((k, nb), np.float32)
    for i, (x, y) in enumerate(per):
        xs[i, :x.shape[0]] = x
        ys[i, :y.shape[0]] = y
        mask[i, :x.shape[0]] = 1.0
    return xs, ys, mask



def chunk_scan_major(arrays: Sequence[np.ndarray], chunk_batches: int
                     ) -> List[Tuple[np.ndarray, ...]]:
    """Split scan-major arrays (leading dim = batch steps) into equal-size
    chunks of ``chunk_batches`` steps. The leading dim must already be a
    multiple of ``chunk_batches`` (pad via ``num_batches`` upstream); the
    returned chunks are views, so nothing is copied until they are staged
    for the device."""
    nb = arrays[0].shape[0]
    if nb % chunk_batches:
        raise ValueError(f"{nb} steps do not split into chunks of "
                         f"{chunk_batches}; pad with num_batches first")
    return [tuple(a[i:i + chunk_batches] for a in arrays)
            for i in range(0, nb, chunk_batches)]
