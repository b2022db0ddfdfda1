"""Sliding-window ELM sufficient statistics — bounded-memory forgetting. The
port's counterpart of ``repro.stream.window``.

ELM's (U, V, n) are plain sums over rows of H, which makes them exactly
rank-UPdatable (add a chunk's stats) **and** rank-DOWNdatable (subtract
an evicted chunk's stats — ``elm.downdate_stats``). A sliding window over
an unbounded stream therefore costs one add and at most one subtract per
chunk, O(window) memory, and never replays data.

The catch is floating point: ``(a + b) - b`` is not bit-equal to ``a``
in f32, so a long-running window's downdated total can drift from the
sum a fresh accumulation over the retained chunks would produce. The
drift is bounded (each evict contributes O(eps·|chunk stats|)) but NOT
zero, so the window carries its own **equivalence gate**:
``recompute()`` re-sums the retained deque entries from scratch, one
chunk at a time in deque order (never one reduction over a stacked dim,
whose order the library picks), and ``verify()`` asserts the running
total matches within f32 tolerance — the streaming run
(``StreamConfig.verify_every``) runs it periodically.

The stats stay on the run's device in f32 (the reference keeps them on
the host in numpy f32): an elementwise f32 add or subtract rounds the
same on the card, the CPU and in numpy, so the totals are the
reference's bits, and the chunk loop copies no U back to the host.
Chunks whose features were computed in bf16 still carry f32 stats, so the
window never downgrades the accumulator dtype.
"""
from __future__ import annotations

from collections import deque
from typing import Deque, Optional

import torch

from repro_torch import resolve_device
from repro_torch.core import elm


class WindowDriftError(AssertionError):
    """The equivalence gate tripped: the downdated running total no
    longer matches a fresh recompute over the retained chunks."""


class SlidingWindowStats:
    """A bounded deque of per-chunk ``ELMStats`` deltas + their running
    total, downdated on eviction, on ``device`` (the card unless
    ``device="cpu"``).

    ``push(stats)`` appends a chunk's stats and adds them to the total;
    once more than ``capacity`` chunks are held, the oldest is popped and
    its stats SUBTRACTED (the downdate) — the evicted stats are returned
    so callers can account for them. ``total()`` is the windowed (U, V, n)
    to solve β from; ``recompute()``/``verify()`` are the equivalence
    gate against from-scratch accumulation."""

    def __init__(self, capacity: int, num_features: int, num_classes: int,
                 device="cuda"):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.capacity = capacity
        self.device = resolve_device(device)
        self._chunks: Deque[elm.ELMStats] = deque()
        self._total = elm.zero_stats(num_features, num_classes, self.device)
        self.pushed = 0          # lifetime chunks seen
        self.evicted = 0         # lifetime chunks downdated out

    def __len__(self) -> int:
        return len(self._chunks)

    @property
    def full(self) -> bool:
        return len(self._chunks) == self.capacity

    def _f32(self, stats: elm.ELMStats) -> elm.ELMStats:
        """Stats as f32 tensors on the window's device (the accumulator
        never drops below f32)."""
        return elm.ELMStats(*(torch.as_tensor(a).to(self.device,
                                                    torch.float32)
                              for a in stats))

    def push(self, stats: elm.ELMStats) -> Optional[elm.ELMStats]:
        """Add one chunk's stats; returns the evicted chunk's stats when
        the window slides (None while still filling)."""
        stats = self._f32(stats)
        self._chunks.append(stats)
        self._total = elm.add_stats(self._total, stats)
        self.pushed += 1
        if len(self._chunks) <= self.capacity:
            return None
        old = self._chunks.popleft()
        self._total = elm.downdate_stats(self._total, old)
        self.evicted += 1
        return old

    def total(self) -> elm.ELMStats:
        """The windowed sufficient statistics (running, downdated)."""
        return self._total

    def recompute(self) -> elm.ELMStats:
        """From-scratch sum over the retained chunks, one chunk at a time
        in deque order — what the running total SHOULD be, modulo f32
        rounding of the downdates."""
        fresh = elm.ELMStats(*(torch.zeros_like(a) for a in self._total))
        for s in self._chunks:
            fresh = elm.add_stats(fresh, s)
        return fresh

    @staticmethod
    def _max_abs(a) -> float:
        return float(a.abs().max()) if a.numel() else 0.0

    def max_abs_error(self) -> float:
        """max |running − recompute| over U, V and n."""
        fresh = self.recompute()
        return max(self._max_abs(run - ref)
                   for run, ref in zip(self._total, fresh))

    def verify(self, *, rtol: float = 1e-5, atol: float = 1e-3):
        """THE equivalence gate: raise ``WindowDriftError`` unless the
        downdated running total matches ``recompute()`` within f32
        tolerance (scaled to the stats' magnitude via ``rtol``). Returns
        the max absolute error so callers can log/persist it."""
        fresh = self.recompute()
        for name, run, ref in zip(("u", "v", "n"), self._total, fresh):
            err = self._max_abs(run - ref)
            bound = atol + rtol * self._max_abs(ref)
            if err > bound:
                raise WindowDriftError(
                    f"window stats drifted on {name!r}: downdated running "
                    f"total differs from recompute-from-scratch by {err:g} "
                    f"(bound {bound:g}) after {self.evicted} evictions — "
                    f"the downdate path is corrupting the accumulator")
        return self.max_abs_error()

    def reset_from_recompute(self) -> float:
        """Re-anchor the running total to ``recompute()`` (drop any
        accumulated rounding drift); returns the error that was dropped.
        Long-running streams can call this at verify points so drift
        never compounds past the gate's tolerance."""
        err = self.max_abs_error()
        self._total = self.recompute()
        return err
