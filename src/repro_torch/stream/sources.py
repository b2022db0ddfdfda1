"""Streaming sources — where the unbounded shard streams come from. The
port's copy of ``repro.stream.sources`` (numpy only), over the port's own
``data.partition`` and ``data.synthetic``.

A ``StreamSource`` produces a bounded-memory iterator of fixed-size data
chunks; ``member_streams`` fans one source out into k per-member shard
streams whose rng streams follow THE seed rule (member i shuffles with
``default_rng(seed + i)`` — the same contract as ``MapConfig.member_seed``,
so a streaming member's data order is as pinned-down as a batch member's).

Chunks feed ``StreamingRun``'s chunk loop, which hands each one to an
executor block as a one-block partition. Fixed ``chunk_rows`` means fixed
device shapes for the whole stream, however long it runs.

Sources:

* ``ArraySource``          — in-memory arrays sliced into chunks (tests,
  benchmarks, and any dataset that already fits in host RAM).
* ``FileSource``           — a glob pattern over ``.npz`` shard files
  (keys ``x``/``y``), read lazily file by file in sorted order; the
  on-disk idiom of a Map member tailing its shard directory.
* ``SyntheticDriftSource`` — the drift harness: synthetic glyph chunks
  with an injected distribution shift (label permutation — real concept
  drift, p(y|x) changes) at a chosen chunk index.
"""
from __future__ import annotations

import glob as globlib
import os
from dataclasses import dataclass, field
from typing import Iterator, List, Optional, Protocol, Sequence, Tuple

import numpy as np

from repro_torch.data.partition import Partition
from repro_torch.data.synthetic import make_extended_mnist


class StreamSource(Protocol):
    """The source protocol: ``chunks()`` yields ``(x, y)`` chunk arrays of
    ``chunk_rows`` rows each (the final short chunk of a finite source is
    DROPPED so every chunk shares one device shape), and ``chunk_rows``
    names that fixed size."""

    chunk_rows: int

    def chunks(self) -> Iterator[Tuple[np.ndarray, np.ndarray]]: ...


@dataclass
class ArraySource:
    """Slice in-memory arrays into fixed-size chunks, in storage order
    (shuffle upstream if the storage order is not the stream order)."""
    x: np.ndarray
    y: np.ndarray
    chunk_rows: int

    def __post_init__(self):
        if self.chunk_rows < 1:
            raise ValueError(f"chunk_rows must be >= 1, "
                             f"got {self.chunk_rows}")
        if len(self.x) != len(self.y):
            raise ValueError(f"x/y row mismatch: {len(self.x)} vs "
                             f"{len(self.y)}")

    def chunks(self) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        n = (len(self.x) // self.chunk_rows) * self.chunk_rows
        for i in range(0, n, self.chunk_rows):
            yield self.x[i:i + self.chunk_rows], self.y[i:i + self.chunk_rows]


@dataclass
class FileSource:
    """Glob-pattern file iterator: every match of ``pattern`` is an
    ``.npz`` shard file with ``x``/``y`` arrays, consumed in sorted-path
    order (the stable on-disk stream order), each file re-sliced into
    ``chunk_rows`` chunks. Rows left over at a file boundary carry into
    the next file, so the stream loses at most the final short chunk —
    not one per file. Files are opened lazily one at a time: host memory
    is bounded by one file plus one chunk, never the stream."""
    pattern: str
    chunk_rows: int

    def __post_init__(self):
        if self.chunk_rows < 1:
            raise ValueError(f"chunk_rows must be >= 1, "
                             f"got {self.chunk_rows}")

    def paths(self) -> List[str]:
        return sorted(globlib.glob(self.pattern))

    def chunks(self) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        paths = self.paths()
        if not paths:
            raise FileNotFoundError(
                f"FileSource pattern {self.pattern!r} matched no files")
        carry_x: Optional[np.ndarray] = None
        carry_y: Optional[np.ndarray] = None
        for path in paths:
            with np.load(path) as f:
                x, y = f["x"], f["y"]
            if carry_x is not None:
                x = np.concatenate([carry_x, x])
                y = np.concatenate([carry_y, y])
            n = (len(x) // self.chunk_rows) * self.chunk_rows
            for i in range(0, n, self.chunk_rows):
                yield x[i:i + self.chunk_rows], y[i:i + self.chunk_rows]
            carry_x, carry_y = x[n:], y[n:]


def write_shard_files(x: np.ndarray, y: np.ndarray, out_dir: str, *,
                      rows_per_file: int, prefix: str = "shard") -> List[str]:
    """Materialise arrays as the ``.npz`` shard files ``FileSource``
    consumes (``<prefix>-<i>.npz``, zero-padded so sorted-path order is
    write order). The benchmark and tests use it to stage an on-disk
    stream; the final short file is written too — ``FileSource``'s
    carry-over chunking handles ragged file sizes."""
    os.makedirs(out_dir, exist_ok=True)
    paths = []
    for fi, at in enumerate(range(0, len(x), rows_per_file)):
        path = os.path.join(out_dir, f"{prefix}-{fi:06d}.npz")
        np.savez(path, x=x[at:at + rows_per_file], y=y[at:at + rows_per_file])
        paths.append(path)
    return paths


@dataclass
class SyntheticDriftSource:
    """The drift harness: ``n_chunks`` glyph chunks; from chunk
    ``drift_at`` on, labels are permuted by ``label_shift`` classes —
    REAL concept drift (p(y|x) changes, the features stay valid), the
    regime where windowed forgetting + re-synchronization pay off.

    ``class_filter`` restricts the stream to a class subset (the
    class-skewed shard regime: each member's stream covers only part of
    the label space, so only the Reduce sees everything). The label
    permutation applies over the FULL class space before filtering, so
    post-drift chunks keep the same classes with shifted labels.
    Deterministic given ``seed``; rows within a chunk are drawn i.i.d.
    from the chunk's distribution."""
    n_chunks: int
    chunk_rows: int
    drift_at: int                    # first drifted chunk index
    seed: int = 0
    label_shift: int = 5
    class_filter: Optional[Sequence[int]] = None
    n_per_class: int = 40            # pool size per class for the glyph set
    _pool: tuple = field(default=None, repr=False, compare=False)

    def __post_init__(self):
        if self.n_chunks < 1 or self.chunk_rows < 1:
            raise ValueError("n_chunks and chunk_rows must be >= 1")

    def _class_pool(self):
        """Per-class row pools, built once per source (deterministic)."""
        if self._pool is None:
            ds = make_extended_mnist(n_per_class=self.n_per_class,
                                     seed=self.seed)
            pool = {c: ds.x[ds.y == c] for c in range(ds.num_classes)}
            object.__setattr__(self, "_pool", (pool, ds.num_classes))
        return self._pool

    @property
    def num_classes(self) -> int:
        return self._class_pool()[1]

    def chunks(self) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        pool, C = self._class_pool()
        classes = (list(range(C)) if self.class_filter is None
                   else list(self.class_filter))
        rng = np.random.default_rng(self.seed)
        for t in range(self.n_chunks):
            cs = rng.choice(classes, size=self.chunk_rows)
            rows = np.stack([pool[c][rng.integers(len(pool[c]))]
                             for c in cs])
            ys = np.asarray(cs, np.int32)
            if t >= self.drift_at:
                ys = ((ys + self.label_shift) % C).astype(np.int32)
            yield rows, ys


@dataclass
class _MemberStream:
    """One member's shard stream: the member's slice of the source's
    chunk sequence, rows shuffled within each chunk from the member's own
    rng stream (``default_rng(seed + i)`` — THE seed rule), delivered as
    ``Partition`` chunks ready for an executor block."""
    source: StreamSource
    member: int
    k: int
    seed: int

    def __iter__(self) -> Iterator[Partition]:
        rng = np.random.default_rng(self.seed + self.member)
        for t, (x, y) in enumerate(self.source.chunks()):
            if t % self.k != self.member:
                rng.permutation(len(x))     # keep streams draw-aligned
                continue
            idx = rng.permutation(len(x))
            yield Partition(x[idx], y[idx])


def member_streams(source, k: int, *, seed: int = 1000,
                   per_member: bool = False) -> List[_MemberStream]:
    """Fan a source (or k sources) out into k per-member shard streams.

    One shared source deals chunks round-robin (chunk t goes to member
    ``t % k`` — disjoint shards of one stream, the MapReduce regime);
    ``per_member=True`` takes a sequence of k sources instead, one whole
    stream per member (the class-skewed / per-site regime). Either way
    member i's within-chunk shuffle comes from ``default_rng(seed + i)``."""
    if k < 1:
        raise ValueError(f"k must be >= 1, got {k}")
    if per_member:
        sources = list(source)
        if len(sources) != k:
            raise ValueError(f"{len(sources)} sources for {k} members")
        return [_MemberStream(s, 0, 1, seed + i)
                for i, s in enumerate(sources)]
    return [_MemberStream(source, i, k, seed) for i in range(k)]
