"""Continuous-batching request scheduler — the latency-SLO front door. The
port's counterpart of ``repro.serve.scheduler``.

``EnsembleServer`` turns single-image requests into bucket-shaped
batches for a ``BucketedScorer``:

* ``submit(image)`` enqueues a request and returns a
  ``concurrent.futures.Future`` resolving to a ``ServeResult`` — the
  open-loop surface a load generator (or an RPC handler) drives.
* A single scoring worker coalesces the queue into batches under the
  SLO contract: flush when ``max_batch`` requests are waiting OR when
  the OLDEST waiting request has been queued ``max_wait_ms`` — whichever
  comes first. ``max_wait_ms`` is therefore the queueing-delay budget;
  end-to-end latency adds one bucket-shaped scoring dispatch.
* Between batches (never mid-batch) the worker applies the newest
  pending weight swap (``swap_members``, fed by
  ``repro.serve.hot_reload.CheckpointWatcher``): in-flight requests
  finish on the weights they were batched with, queued requests score on
  the new ones, and nothing is ever dropped or re-queued. The swap's copy
  into the captured graphs' weights runs on the worker's current stream,
  the stream its replays run on, so it lands between two replays.

Every flush dispatches at a ``BucketLadder`` shape, so the server's
program count (captured graphs on the card) stays bounded by the ladder —
``stats().compile_count`` exposes it and
``BucketedScorer.assert_compile_budget`` guards it.
"""
from __future__ import annotations

import queue
import threading
import time
from concurrent.futures import Future
from dataclasses import dataclass, field
from typing import List, Optional, Tuple

import numpy as np

from repro_torch.core.runner import COMBINES
from repro_torch.serve.engine import BucketedScorer, combine_block

_SHUTDOWN = object()


class QueueFull(RuntimeError):
    """Backpressure: the request queue is at ``ServeConfig.queue_depth``."""


@dataclass(frozen=True)
class ServeConfig:
    """The SLO contract. ``max_batch`` — flush threshold (must fit the
    scorer's ladder). ``max_wait_ms`` — the oldest request's queueing
    budget before a partial batch flushes anyway. ``combine`` — the
    ensemble decision rule (``runner.Ensemble`` semantics, ties to the
    lowest class index). ``queue_depth`` — bound on waiting requests
    (0 = unbounded); past it ``submit`` raises ``QueueFull``."""
    max_batch: int = 32
    max_wait_ms: float = 5.0
    combine: str = "mean"
    queue_depth: int = 0

    def __post_init__(self):
        if self.max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {self.max_batch}")
        if self.max_wait_ms < 0:
            raise ValueError(f"max_wait_ms must be >= 0, "
                             f"got {self.max_wait_ms}")
        if self.combine not in COMBINES:
            raise ValueError(f"combine must be one of {COMBINES}, "
                             f"got {self.combine!r}")
        if self.queue_depth < 0:
            raise ValueError(f"queue_depth must be >= 0, "
                             f"got {self.queue_depth}")


@dataclass
class ServeResult:
    """One answered request: the combined label, the (k, C) member score
    column it was decided from, and the end-to-end latency."""
    label: int
    member_scores: np.ndarray
    latency_s: float


@dataclass
class ServerStats:
    """A consistent snapshot of the server's counters."""
    completed: int
    failed: int
    dropped: int
    swaps: int
    batches: int
    mean_occupancy: float
    compile_count: int
    latencies_ms: np.ndarray = field(repr=False)

    def percentile_ms(self, q: float) -> float:
        if len(self.latencies_ms) == 0:
            return float("nan")
        return float(np.percentile(self.latencies_ms, q))


@dataclass
class _Request:
    image: np.ndarray
    future: Future
    t_submit: float


class EnsembleServer:
    """The continuous-batching endpoint over one ``BucketedScorer``."""

    def __init__(self, scorer: BucketedScorer,
                 config: Optional[ServeConfig] = None):
        self.config = config or ServeConfig()
        if self.config.max_batch > scorer.ladder.max_batch:
            raise ValueError(
                f"ServeConfig.max_batch {self.config.max_batch} exceeds "
                f"the scorer ladder's max_batch {scorer.ladder.max_batch}")
        self.scorer = scorer
        self._q: "queue.Queue" = queue.Queue(self.config.queue_depth)
        self._lock = threading.Lock()          # swap + counters
        self._pending_members = None
        self._completed = 0
        self._failed = 0
        self._dropped = 0
        self._swaps = 0
        self._batches: List[Tuple[int, int]] = []      # (n, bucket)
        self._latencies: List[float] = []
        self._closed = False
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="repro-torch-serve-worker")
        self._started = False

    # -- lifecycle ----------------------------------------------------

    def start(self, warmup: bool = True) -> "EnsembleServer":
        """Spin up the scoring worker; ``warmup`` captures every bucket's
        graph first so no request ever waits on a capture."""
        if self._started:
            return self
        if warmup:
            self.scorer.warmup()
        self._started = True
        self._thread.start()
        return self

    def close(self):
        """Drain: every already-submitted request is answered before the
        worker exits (zero drops on shutdown)."""
        if not self._started or self._closed:
            self._closed = True
            return
        self._closed = True
        self._q.put(_SHUTDOWN)
        self._thread.join()

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.close()

    # -- request path -------------------------------------------------

    def submit(self, image) -> Future:
        """Enqueue one image; the Future resolves to a ``ServeResult``."""
        if self._closed:
            raise RuntimeError("server is closed")
        req = _Request(np.asarray(image, np.float32), Future(),
                       time.monotonic())
        try:
            self._q.put_nowait(req)
        except queue.Full:
            with self._lock:
                self._dropped += 1
            raise QueueFull(
                f"request queue at queue_depth={self.config.queue_depth}")
        return req.future

    def submit_many(self, images) -> List[Future]:
        return [self.submit(img) for img in images]

    # -- hot swap -----------------------------------------------------

    def swap_members(self, members):
        """Stage new weights; the worker applies them BETWEEN batches
        (the hot-reload contract: zero dropped requests, in-flight
        batches finish on their weights). Shape mismatches are refused
        immediately (``SwapRejected``), not at flush time."""
        # validate on the caller's thread so a bad checkpoint surfaces
        # in the watcher, never on the scoring path
        self.scorer.validate_members(members)   # raises SwapRejected
        with self._lock:
            self._pending_members = members

    # -- telemetry ----------------------------------------------------

    def stats(self) -> ServerStats:
        with self._lock:
            batches = list(self._batches)
            occ = (float(np.mean([n for n, _ in batches]))
                   if batches else 0.0)
            return ServerStats(
                completed=self._completed, failed=self._failed,
                dropped=self._dropped, swaps=self._swaps,
                batches=len(batches), mean_occupancy=occ,
                compile_count=self.scorer.compile_count(),
                latencies_ms=np.asarray(self._latencies) * 1e3)

    # -- the worker ---------------------------------------------------

    def _loop(self):
        max_wait = self.config.max_wait_ms / 1e3
        shutdown = False
        while not shutdown:
            req = self._q.get()
            if req is _SHUTDOWN:
                break
            batch = [req]
            deadline = req.t_submit + max_wait
            while len(batch) < self.config.max_batch:
                timeout = deadline - time.monotonic()
                if timeout <= 0:
                    break
                try:
                    nxt = self._q.get(timeout=timeout)
                except queue.Empty:
                    break
                if nxt is _SHUTDOWN:
                    shutdown = True
                    break
                batch.append(nxt)
            self._flush(batch)
        # drain whatever was submitted before close()
        rest: List[_Request] = []
        while True:
            try:
                item = self._q.get_nowait()
            except queue.Empty:
                break
            if item is not _SHUTDOWN:
                rest.append(item)
        while rest:
            self._flush(rest[:self.config.max_batch])
            rest = rest[self.config.max_batch:]

    def _flush(self, batch: List[_Request]):
        with self._lock:
            if self._pending_members is not None:
                self.scorer.swap_members(self._pending_members)
                self._pending_members = None
                self._swaps += 1
        x = np.stack([r.image for r in batch])
        try:
            scores = self.scorer.score_block(x)          # (k, n, C)
            labels = combine_block(scores, self.config.combine,
                                   self.scorer.cfg.num_classes)
        except Exception as e:                # answer, never drop
            with self._lock:
                self._failed += len(batch)
            for r in batch:
                r.future.set_exception(e)
            return
        t_done = time.monotonic()
        lats = [t_done - r.t_submit for r in batch]
        with self._lock:
            self._batches.append((len(batch),
                                  self.scorer.ladder.bucket_for(len(batch))))
            self._latencies.extend(lats)
            self._completed += len(batch)
        for i, r in enumerate(batch):
            r.future.set_result(ServeResult(
                label=int(labels[i]), member_scores=scores[:, i],
                latency_s=lats[i]))
