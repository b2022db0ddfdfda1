"""The streaming Map phase — chunk loop, sync policies, checkpoint publish.
The port's counterpart of ``repro.stream.run``.

``StreamingRun`` is the unbounded-stream sibling of
``runner.AveragingRun``: k members consume per-member shard streams
(``sources.member_streams``) instead of fixed partitions, and the Reduce
fires on a POLICY (``ReduceConfig.sync``) instead of a round count.

Per chunk ``t`` each member:

1. **scores** the chunk's held-out slice with its CURRENT model
   (prequential / test-then-train: the score is out-of-sample by
   construction) — member i's slice through member i's CNN, one
   member-batched conv launch per stage — and feeds it to its drift
   detector. The hit counts come to the host in one copy per chunk, the
   one wait for the device a chunk needs (it also carries the previous
   chunk's β factorisation checks);
2. **trains** one executor block on the chunk — the SAME
   ``repro_torch.core.executor`` engine the batch runner uses (sequential
   or stacked backend), resumed from the member's own params via
   ``ExecutionPlan.member_init`` and its one rng stream via
   ``member_seeds``/``start_epochs``;
3. **pushes** the block's ``ELMStats`` into its ``SlidingWindowStats``
   (on the run's device; the evicted chunk is DOWNdated out) and
   re-solves the windowed β one member at a time (``elm.solve_beta``: a
   member's β is the same bits whatever k);
4. under the sync policy, the members' models are (weighted-)averaged —
   the paper's Reduce — members reset to the average, and the sync is
   CHECKPOINTED as ``run_state`` round ``t`` so a live
   ``repro_torch.serve`` endpoint hot-reloads it. Round numbers are chunk
   indices: drift-triggered syncs land at IRREGULAR rounds, which
   ``CheckpointWatcher``/``latest_ready_round`` handle by construction.

Sync policies (``ReduceConfig.sync``):

* ``"rounds"`` — fixed cadence: every ``StreamConfig.sync_every`` chunks
  (0 = never after the initial publish);
* ``"drift"``  — fire while ANY member's detector is in the drifting
  state. Drifting is a level, so a concept shift produces a CLUSTER of
  syncs until the windowed model scores well again.

With ``epochs=0`` (the closed-form regime) the backbone is frozen and
the windowed β is the member's entire learning state — windowed ELM
training is then EXACT for the data in the window. With SGD epochs the
β window is the standard online approximation (each chunk's stats were
computed under the params of their time).
"""
from __future__ import annotations

import queue
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch import kernels, resolve_device
from repro_torch.checkpoint import run_state
from repro_torch.core import elm
from repro_torch.core.cnn_elm import (CNNELMModel, StackedMembers,
                                      average_models, stack_models)
from repro_torch.core.executor import (CheckpointConfig, ExecutionPlan,
                                       make_executor)
from repro_torch.core.reduce_strategies import ReduceContext
from repro_torch.core.runner import MapConfig, ReduceConfig
from repro_torch.data.partition import Partition
from repro_torch.models import cnn
from repro_torch.stream.drift import DETECTORS, DriftDetector, make_detector
from repro_torch.stream.window import SlidingWindowStats
from repro_torch.tree import tree_map

STREAM_BACKENDS = ("sequential", "stacked")


# ---------------------------------------------------------------------------
# Chunk ingestion: synchronous pull, or a bounded-queue prefetch thread
# ---------------------------------------------------------------------------

def _iter_chunks(streams: Sequence):
    """Pull one ``Partition`` per member stream per step; stop when ANY
    stream runs dry (a ragged tail chunk is dropped for every member —
    the synchronous-loop contract the prefetcher must reproduce)."""
    its = [iter(s) for s in streams]
    while True:
        parts: List[Partition] = []
        for it in its:
            p = next(it, None)
            if p is None:
                return
            parts.append(p)
        yield parts


def _iter_chunks_prefetched(streams: Sequence, depth: int):
    """``_iter_chunks`` staged by a bounded-queue background thread: the
    producer reads up to ``depth`` chunk groups ahead while the consumer
    trains, overlapping source I/O with compute. Only the HOST-side pull
    moves off-thread — chunk order, the stop-on-dry contract and every
    downstream byte are identical to the synchronous loop. A source
    exception is re-raised at the consuming chunk, where the synchronous
    loop would have hit it."""
    q: "queue.Queue" = queue.Queue(maxsize=depth)
    done = object()
    stop = threading.Event()

    def produce():
        try:
            for parts in _iter_chunks(streams):
                while not stop.is_set():
                    try:
                        q.put(parts, timeout=0.1)
                        break
                    except queue.Full:
                        continue
                if stop.is_set():
                    return
            item = done
        except BaseException as e:      # surfaced at the consumer
            item = e
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return
            except queue.Full:
                continue

    thread = threading.Thread(target=produce, daemon=True,
                              name="repro-torch-stream-prefetch")
    thread.start()
    try:
        while True:
            item = q.get()
            if item is done:
                return
            if isinstance(item, BaseException):
                raise item
            yield item
    finally:
        # consumer stopped early (max_chunks / an error): unblock and
        # retire the producer so abandoned runs don't pin the sources
        stop.set()


def _holdout_hits(cfg, cnn_params_k, beta_k, x_k, y_k):
    """(k,) count of member i's held-out rows its own model labels right:
    member i's slice x_k[i] through member i's CNN (one member-batched
    launch per conv stage), argmax of its ELM scores against y_k[i]."""
    with torch.no_grad():
        scores = elm.predict(cnn.features_members(cfg, cnn_params_k, x_k),
                             beta_k)
        return (scores.argmax(-1) == y_k).sum(-1)


@dataclass(frozen=True)
class StreamConfig:
    """Streaming-phase knobs (the Map/Reduce knobs stay on
    ``MapConfig``/``ReduceConfig``).

    ``window_chunks`` — sliding-window capacity in chunks per member.
    ``holdout_rows`` — leading rows of each chunk scored prequentially
    (they ARE still trained on afterwards — test-then-train).
    ``sync_every`` — the ``sync="rounds"`` cadence in chunks (0 = only
    the initial publish). ``initial_publish`` — publish chunk 0's average
    so a serving endpoint has a model under EVERY policy (including
    never-sync baselines). ``drift_detector`` — which per-member
    detector (``"ewma"`` or ``"page_hinkley"``, ``drift.make_detector``)
    the ``drift_*`` parameters configure (``drift_alpha`` is EWMA-only,
    ``drift_delta`` Page-Hinkley-only). ``verify_every`` — run each
    window's equivalence gate (``SlidingWindowStats.verify``) every N
    chunks (0 = off); ``max_chunks`` stops an infinite stream."""
    window_chunks: int = 8
    holdout_rows: int = 32
    sync_every: int = 0
    initial_publish: bool = True
    drift_detector: str = "ewma"
    drift_threshold: float = 0.2
    drift_alpha: float = 0.2
    drift_warmup: int = 3
    drift_delta: float = 0.005
    verify_every: int = 0
    verify_rtol: float = 1e-5
    verify_atol: float = 1e-3
    max_chunks: Optional[int] = None

    def __post_init__(self):
        if self.window_chunks < 1:
            raise ValueError(f"window_chunks must be >= 1, "
                             f"got {self.window_chunks}")
        if self.holdout_rows < 1:
            raise ValueError(f"holdout_rows must be >= 1, "
                             f"got {self.holdout_rows}")
        if self.sync_every < 0 or self.verify_every < 0:
            raise ValueError("sync_every/verify_every must be >= 0")
        if self.drift_detector not in DETECTORS:
            raise ValueError(f"drift_detector must be one of {DETECTORS}, "
                             f"got {self.drift_detector!r}")


@dataclass
class StreamRecord:
    """One chunk's telemetry: the prequential scores fed to the
    detectors, who was drifting AFTER the update, whether this chunk
    synced and why, and the window gate's error when it ran."""
    chunk: int
    scores: List[float]
    drifting: List[bool]
    synced: bool
    reason: Optional[str] = None          # "initial" | "cadence" | "drift"
    window_err: Optional[float] = None


@dataclass
class SyncEvent:
    """One fired Reduce: the chunk (= checkpoint round) it landed on,
    why it fired, which members were drifting, the published averaged
    model and the durable checkpoint path (None without checkpointing)."""
    chunk: int
    reason: str
    drifting: List[int]
    averaged: CNNELMModel
    path: Optional[str] = None


@dataclass
class StreamResult:
    """What a streaming run produced. ``members``/``stacked`` are the
    final per-member models (block params + windowed β); ``averaged`` is
    a fresh Reduce over them at stream end; ``last_published`` is what a
    serving endpoint tracking the checkpoint dir is left running —
    under ``sync_every=0`` baselines the two differ by design.
    ``launches`` is the change of ``kernels.LAUNCHES`` over the run, by
    kernel (the port's counterpart of the reference's dispatch count).
    The counts are process-wide: launches made meanwhile by another thread
    of the process (a serving worker's replays) are in it too."""
    cfg: Any
    members: List[CNNELMModel]
    stacked: StackedMembers
    averaged: CNNELMModel
    last_published: Optional[CNNELMModel]
    records: List[StreamRecord]
    syncs: List[SyncEvent]
    windows: List[SlidingWindowStats]
    detectors: List[DriftDetector]
    chunks: int
    wall_time_s: float
    launches: Dict[str, int]
    backend: str
    device: torch.device

    @property
    def sync_chunks(self) -> List[int]:
        return [s.chunk for s in self.syncs]


@dataclass
class StreamingRun:
    """One streaming distributed-averaging experiment: model config +
    Map config + Reduce config (its ``sync`` policy) + stream config.
    ``run(streams, ...)`` drives the chunk loop over k per-member
    ``Partition`` iterables (``sources.member_streams``).

    ``prefetch=N`` stages up to N chunk groups ahead on a bounded-queue
    background ingestion thread (``_iter_chunks_prefetched``), so source
    reads overlap training; 0 keeps the synchronous pull. The results
    are bit-identical either way — only WHEN the host reads the sources
    moves, never what it reads."""
    cfg: Any
    map_cfg: MapConfig = field(default_factory=MapConfig)
    reduce_cfg: ReduceConfig = field(default_factory=ReduceConfig)
    stream_cfg: StreamConfig = field(default_factory=StreamConfig)
    prefetch: int = 0

    def __post_init__(self):
        m, rc = self.map_cfg, self.reduce_cfg
        if self.prefetch < 0:
            raise ValueError(f"prefetch must be >= 0, got {self.prefetch}")
        if m.backend not in STREAM_BACKENDS:
            raise ValueError(
                f"streaming runs on backend {STREAM_BACKENDS} (re-stacked "
                f"per chunk block), got {m.backend!r}")
        if rc.rounds != 1:
            raise ValueError(
                "ReduceConfig.rounds is the BATCH runner's cadence; a "
                "streaming run syncs per chunk under ReduceConfig.sync "
                "('rounds' cadence = StreamConfig.sync_every) — leave "
                "rounds=1")
        if rc.elastic is not None:
            raise ValueError("elastic membership under streaming is not "
                             "supported — run fixed members")
        strat = rc.strategy_obj
        if strat.combine != "mean":
            raise ValueError(
                f"strategy {strat.name!r} is a batch-runner combine — "
                f"streaming syncs publish one average per event "
                f"(average_models), not a ring program")
        if strat.requires_validation:
            raise ValueError(
                f"strategy {strat.name!r} weighs members by a FIXED "
                f"held-out slice, which a drifting stream does not have — "
                f"streaming already weighs by window rows "
                f"('shard_weighted') and scores prequentially")

    def run(self, streams: Sequence, *,
            generator: Optional[torch.Generator] = None,
            init_params=None, device="cuda",
            checkpoint: Optional[CheckpointConfig] = None,
            sync_hook: Optional[Callable[[SyncEvent], Any]] = None
            ) -> StreamResult:
        """Consume the k member streams until exhaustion (or
        ``StreamConfig.max_chunks``) on ``device`` (default the card). The
        members start from ``init_params`` (moved to ``device``) or from
        ``cnn.init_params(cfg, generator, device)``. ``checkpoint``
        publishes every sync as ``run_state`` round ``t`` (t = chunk index
        — IRREGULAR round numbers under the drift policy);
        ``sync_hook(event)`` fires after each published sync."""
        m, rc, sc = self.map_cfg, self.reduce_cfg, self.stream_cfg
        dev = resolve_device(device)
        k = len(streams)
        if k < 1:
            raise ValueError("need at least one member stream")
        if checkpoint is not None and \
                not isinstance(checkpoint, CheckpointConfig):
            raise ValueError("checkpoint must be a CheckpointConfig")
        if init_params is None:
            if generator is None:
                raise ValueError("pass generator= (a seeded "
                                 "torch.Generator) or init_params=")
            init_params = cnn.init_params(self.cfg, generator, dev)
        init = tree_map(lambda a: a.to(dev, torch.float32), init_params)
        executor = make_executor(m.backend)
        F, C = cnn.feature_dim(self.cfg), self.cfg.num_classes
        windows = [SlidingWindowStats(sc.window_chunks, F, C, dev)
                   for _ in range(k)]
        detectors = [make_detector(sc.drift_detector,
                                   threshold=sc.drift_threshold,
                                   alpha=sc.drift_alpha,
                                   warmup=sc.drift_warmup,
                                   delta=sc.drift_delta)
                     for _ in range(k)]
        # every chunk block draws this many permutations per member stream
        # (one per epoch; the closed-form pass draws exactly one) — the
        # cursor that keeps member i on ONE rng stream across blocks
        draws_per_block = max(m.epochs, 1)
        member_params = [init] * k
        beta0 = torch.zeros((F, C), device=dev)      # pre-chunk-0 readout
        models: List[CNNELMModel] = [CNNELMModel(init, beta0)
                                     for _ in range(k)]
        ck_meta = {"backend": m.backend, "seed": m.seed, "epochs": m.epochs,
                   "rounds": 1, "batch_size": m.batch_size, "k": k,
                   "mode": "stream", "sync": rc.sync}
        records: List[StreamRecord] = []
        syncs: List[SyncEvent] = []
        last_published: Optional[CNNELMModel] = None
        infos: list = []         # the last β solves' factorisation checks
        launches0 = dict(kernels.LAUNCHES)
        chunk_iter = (_iter_chunks_prefetched(streams, self.prefetch)
                      if self.prefetch > 0 else _iter_chunks(streams))
        t0 = time.perf_counter()
        t = 0
        try:
            for parts in chunk_iter:      # stops when a stream runs dry
                if sc.max_chunks is not None and t >= sc.max_chunks:
                    break
                # 1) prequential score of each member's held-out slice under
                #    its CURRENT model (pre-training — out-of-sample)
                hold = min(sc.holdout_rows, min(len(p.x) for p in parts))
                x_k = torch.from_numpy(np.stack(
                    [np.asarray(p.x[:hold], np.float32) for p in parts]))
                y_k = torch.from_numpy(np.stack(
                    [np.asarray(p.y[:hold], np.int64) for p in parts]))
                current = stack_models(models)
                hits = _holdout_hits(self.cfg, current.cnn_params,
                                     current.beta, x_k.to(dev), y_k.to(dev))
                host = torch.cat([hits] + [i.reshape(-1).to(hits.dtype)
                                           for i in infos]).tolist()
                if any(host[k:]):
                    raise torch.linalg.LinAlgError(
                        "I/λ + U of a window is not positive definite: "
                        "its Cholesky factorisation failed")
                infos = []
                scores = [c / hold for c in host[:k]]
                for d, s in zip(detectors, scores):
                    d.update(s)
                # 2) one executor block over the chunk, resumed from each
                #    member's own params and rng cursor
                plan = ExecutionPlan(
                    epochs=m.epochs,
                    lr_schedule=(None if m.epochs == 0 else
                                 (lambda e, off=t * m.epochs:
                                  m.lr_schedule(off + e))),
                    batch_size=m.batch_size, seed=m.seed,
                    chunk_batches=m.chunk_batches, rounds=1, device=dev,
                    member_seeds=[m.seed + i for i in range(k)],
                    start_epochs=[t * draws_per_block] * k,
                    member_init=member_params if t > 0 else None)
                outcome = executor.execute(self.cfg, init, parts, plan)
                member_params = outcome.member_params
                # 3) window push (+ downdate on evict) and the windowed β,
                #    solved one member at a time
                for i, w in enumerate(windows):
                    w.push(elm.ELMStats(outcome.stats.u[i],
                                        outcome.stats.v[i],
                                        outcome.stats.n[i]))
                win_err = None
                if sc.verify_every and (t + 1) % sc.verify_every == 0:
                    win_err = max(w.verify(rtol=sc.verify_rtol,
                                           atol=sc.verify_atol)
                                  for w in windows)
                totals = run_state.stack_stats([w.total() for w in windows])
                beta_k = elm.solve_beta(totals, self.cfg.elm_lambda, infos)
                models = [CNNELMModel(member_params[i], beta_k[i])
                          for i in range(k)]
                # 4) the sync policy
                drifting = [d.drifting for d in detectors]
                if t == 0 and sc.initial_publish:
                    reason = "initial"
                elif rc.sync == "drift" and any(drifting):
                    reason = "drift"
                elif rc.sync == "rounds" and sc.sync_every and \
                        (t + 1) % sc.sync_every == 0:
                    reason = "cadence"
                else:
                    reason = None
                if reason is not None:
                    averaged = average_models(models,
                                              weights=self._weights(windows))
                    # members reset to the averaged backbone (the
                    # parallel-SGD sync; a frozen epochs=0 backbone makes
                    # this the identity) — the windowed stats stay
                    # member-local: they are each member's shard memory,
                    # and the next chunk's β re-solves from them
                    member_params = [averaged.cnn_params] * k
                    path = None
                    if checkpoint is not None:
                        path = run_state.save_round(
                            checkpoint.dir, t, members=stack_models(models),
                            stats=totals, averaged=averaged,
                            meta={**ck_meta, "round": t, "reason": reason,
                                  "final": False})
                        if checkpoint.after_save is not None:
                            checkpoint.after_save("round", t, path)
                    event = SyncEvent(
                        chunk=t, reason=reason,
                        drifting=[i for i, d in enumerate(drifting) if d],
                        averaged=averaged, path=path)
                    syncs.append(event)
                    last_published = averaged
                    if sync_hook is not None:
                        sync_hook(event)
                records.append(StreamRecord(t, scores, drifting,
                                            reason is not None, reason,
                                            win_err))
                t += 1
        finally:
            if hasattr(chunk_iter, "close"):
                chunk_iter.close()      # retires the prefetch thread
        if t == 0:
            raise ValueError("the member streams yielded no chunks")
        elm.check_factorisations(infos)
        averaged = average_models(models, weights=self._weights(windows))
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        return StreamResult(
            cfg=self.cfg, members=models, stacked=stack_models(models),
            averaged=averaged, last_published=last_published,
            records=records, syncs=syncs, windows=windows,
            detectors=detectors, chunks=t,
            wall_time_s=time.perf_counter() - t0,
            launches={name: n - launches0[name]
                      for name, n in kernels.LAUNCHES.items()},
            backend=m.backend, device=dev)

    def _weights(self, windows) -> Optional[List[float]]:
        """Reduce weights under streaming, through the strategy registry:
        ``shard_weighted`` weighs by the rows currently IN each member's
        window (the streaming twin of shard row counts — the window
        totals ride ``ReduceContext.rows``, read in one copy); explicit
        weight instances pass through (length-checked against the member
        count)."""
        rows = torch.stack([w.total().n for w in windows]).tolist()
        return self.reduce_cfg.strategy_obj.weights(ReduceContext(
            num_members=len(windows), rows=tuple(int(r) for r in rows),
            unit="members"))
