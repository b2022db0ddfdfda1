"""Bucketed batch shapes — the pad ladder of the serving path. The port's
copy of ``repro.serve.bucketing``.

A continuous-batching server forms batches of every size from 1 to
``max_batch``. Scoring only at a fixed set of shapes keeps the set of
programs a server runs bounded — the reference compiles one program per
shape, and the port captures one CUDA graph per shape on the card.

``BucketLadder`` fixes the shape set up front: powers of two
(1, 2, 4, 8, …) capped by ``max_batch`` (which is always the top rung,
even when it is not a power of two). A batch of n rows pads up to
``bucket_for(n)`` — at most 2× the rows, in exchange for a set of batch
shapes bounded by ``len(ladder.buckets)`` for the lifetime of the server.
The padding contract lives in ``repro_torch.serve.engine``: padded rows are
sliced off the score block before ANY combine, so they can never vote.
"""
from __future__ import annotations

import bisect
from typing import Tuple

import numpy as np


class BucketLadder:
    """The fixed set of batch shapes a serving endpoint may dispatch.

    ``buckets`` — ascending tuple of legal padded sizes: every power of
    two below ``max_batch`` (starting at ``min_bucket``) plus
    ``max_batch`` itself. ``bucket_for(n)`` — the smallest legal size
    ≥ n (the shape n rows pad to). ``pad_block(x)`` — x padded with zero
    rows up to its bucket."""

    def __init__(self, max_batch: int, min_bucket: int = 1):
        if max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {max_batch}")
        if min_bucket < 1 or min_bucket > max_batch:
            raise ValueError(f"min_bucket must be in [1, {max_batch}], "
                             f"got {min_bucket}")
        rungs = []
        b = 1
        while b < max_batch:
            if b >= min_bucket:
                rungs.append(b)
            b *= 2
        rungs.append(max_batch)
        self.max_batch = max_batch
        self.min_bucket = min_bucket
        self.buckets: Tuple[int, ...] = tuple(rungs)

    def bucket_for(self, n: int) -> int:
        """The padded size n rows dispatch at (smallest bucket >= n)."""
        if n < 1:
            raise ValueError(f"a batch needs >= 1 row, got {n}")
        if n > self.max_batch:
            raise ValueError(f"batch of {n} exceeds max_batch "
                             f"{self.max_batch} — the scheduler must "
                             f"never form one")
        return self.buckets[bisect.bisect_left(self.buckets, n)]

    def pad_block(self, x: np.ndarray) -> Tuple[np.ndarray, int]:
        """(padded, n): x zero-padded on axis 0 up to its bucket. The n
        real rows come first; callers slice ``[:n]`` off every score
        block BEFORE combining — padded rows never vote."""
        n = len(x)
        b = self.bucket_for(n)
        if b == n:
            return np.asarray(x, np.float32), n
        padded = np.zeros((b,) + x.shape[1:], np.float32)
        padded[:n] = x
        return padded, n

    def __repr__(self):
        return f"BucketLadder(max_batch={self.max_batch}, " \
               f"buckets={self.buckets})"
