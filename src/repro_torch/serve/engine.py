"""The bucket-shaped ensemble scoring engine — the port's counterpart of
``repro.serve.engine``.

``BucketedScorer`` scores k stacked CNN-ELM members only at
``BucketLadder`` shapes. On the card each bucket is one captured CUDA
graph of ``cnn_elm.scores_stacked`` over a static input buffer and static
weight tensors, captured at the bucket's first use (or in ``warmup()``)
after warm-up runs on the scorer's capture stream: a request copies its
padded block into the bucket's input and replays the graph. That is the
counterpart of the reference's one ``jax.jit`` with a bounded cache, so
the programs a scorer runs are bounded by the ladder for the lifetime of
the process: ``compile_count()`` counts the captured graphs (on the CPU,
which has no graphs, the distinct bucket shapes scored), and
``assert_compile_budget()`` raises ``CompileBudgetExceeded`` if it ever
exceeds the ladder's length. A failed capture or replay raises; nothing
falls back to eager scoring.

Weight hot-swap: ``swap_members`` takes a SHAPE-IDENTICAL tree (anything
else is refused with ``SwapRejected``) and copies it into the static
weight tensors in place — every captured graph reads those tensors, so
the swap needs no recapture. The copy runs on the calling thread's
current stream, in order with the replays a serving worker issues on the
same stream.

Padding contract: a batch of n rows pads with zero rows up to
``bucket_for(n)``; every CNN-ELM score is row-independent (per-image
features, row-wise ELM readout), and the padded rows are sliced off the
(k, bucket, C) score block BEFORE any combine — padding can never vote.
A row scores the same bits in every bucket: the conv kernel's sums do not
depend on the batch, and the readout Hβ runs at one row count, the
ladder's largest bucket, whatever the bucket (``_readout``).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional

import numpy as np
import torch

from repro_torch import kernels, resolve_device
from repro_torch.core import elm
from repro_torch.core.cnn_elm import StackedMembers
from repro_torch.core.runner import COMBINES
from repro_torch.models import cnn
from repro_torch.serve.bucketing import BucketLadder
from repro_torch.tree import tree_leaves, tree_map

WARMUP_RUNS = 2     # eager runs on the capture stream before a capture


def combine_block(scores: np.ndarray, combine: str,
                  num_classes: int) -> np.ndarray:
    """(k, n, C) member scores -> (n,) ensemble labels.

    ``"mean"`` — argmax of the mean member score. ``"vote"`` — majority
    vote over member argmaxes. BOTH resolve ties to the LOWEST class
    index (np.argmax convention) — the ``runner.Ensemble`` rule."""
    if combine == "mean":
        return scores.mean(axis=0).argmax(-1)
    if combine != "vote":
        raise ValueError(f"combine must be one of {COMBINES}, "
                         f"got {combine!r}")
    preds = scores.argmax(-1)                       # (k, n)
    k, n = preds.shape
    votes = np.zeros((n, num_classes), np.int64)
    np.add.at(votes, (np.tile(np.arange(n), k), preds.reshape(-1)), 1)
    return votes.argmax(-1)


@dataclass
class SwapRejected(ValueError):
    """A hot-swap candidate whose tree/shapes/dtypes differ from the
    serving weights — the scorer refuses it."""
    reason: str

    def __str__(self):
        return self.reason


class CompileBudgetExceeded(AssertionError):
    """The scorer holds more programs (captured graphs) than its ladder
    has buckets: some dispatch escaped the pad ladder."""


def _readout(h, beta_k, rows: int):
    """(k, B, C) scores of features h (k, B, F) under β (k, F, C), the
    product taken at ``rows`` >= B rows (zero rows appended, then sliced
    off): the library may pick its product kernel, and with it the order
    of a row's sums, by the row count, so a fixed count makes a row's
    scores the same bits in every bucket."""
    k, B, F = h.shape
    if B < rows:
        h = torch.cat([h, h.new_zeros((k, rows - B, F))], dim=1)
    return elm.predict(h, beta_k)[:, :B]


@dataclass
class _BucketGraph:
    """One bucket's captured program: its static input, its static output
    and the launches its capture recorded (added back per replay)."""
    graph: "torch.cuda.CUDAGraph"
    x: torch.Tensor
    out: torch.Tensor
    launches: Dict[str, int]


class BucketedScorer:
    """k stacked CNN-ELM members behind a bucket-shaped scoring entry on
    ``device``. Build via ``runner.Ensemble.bucketed_scorer(...)`` (or
    directly from a ``StackedMembers``); ``warmup()`` captures every
    bucket's graph off the serving path (and builds the kernels)."""

    def __init__(self, cfg, members: StackedMembers, *,
                 max_batch: int = 64, ladder: Optional[BucketLadder] = None,
                 device="cuda"):
        self.cfg = cfg
        self.ladder = ladder if ladder is not None \
            else BucketLadder(max_batch)
        self.device = resolve_device(device)
        live = members.to(self.device)
        self._struct = self._signature(live)
        # the serving weights: this scorer's own contiguous copies, which
        # every captured graph reads and every swap overwrites in place
        own = lambda a: a.detach().clone(  # noqa: E731
            memory_format=torch.contiguous_format)
        self._members = StackedMembers(tree_map(own, live.cnn_params),
                                       own(live.beta))
        c = cfg.image_channels
        self._image_shape = ((cfg.image_size, cfg.image_size) if c == 1 else
                             (cfg.image_size, cfg.image_size, c))
        self._graphs: Dict[int, _BucketGraph] = {}
        self._shapes = set()            # buckets scored, on the CPU
        self._stream = None             # the card's capture stream

    # -- weights ------------------------------------------------------

    @staticmethod
    def _signature(members: StackedMembers):
        tree = (members.cnn_params, members.beta)
        shapes = tree_map(lambda a: (tuple(a.shape), a.dtype), tree)
        return repr(shapes), len(tree_leaves(tree))

    @property
    def members(self) -> StackedMembers:
        """The serving weights (overwritten in place by each swap)."""
        return self._members

    @property
    def k(self) -> int:
        return self._members.k

    def validate_members(self, members: StackedMembers):
        """Raise ``SwapRejected`` unless ``members`` is shape/dtype/tree
        identical to the serving weights."""
        if self._signature(members) != self._struct:
            raise SwapRejected(
                "hot-swap refused: candidate weights do not match the "
                "serving tree (arch/k/shape/dtype change) — deploy a new "
                "scorer instead")

    def swap_members(self, members: StackedMembers):
        """Copy a shape/dtype-identical tree into the serving weights in
        place, so the captured graphs score with it; anything else raises
        ``SwapRejected`` (a different arch or k is a new endpoint, not a
        hot swap)."""
        self.validate_members(members)
        new = (members.cnn_params, members.beta)
        cur = (self._members.cnn_params, self._members.beta)
        with torch.no_grad():
            for dst, src in zip(tree_leaves(cur), tree_leaves(new)):
                dst.copy_(src)

    # -- scoring ------------------------------------------------------

    def warmup(self):
        """Capture (on the card) or score once (on the CPU) every bucket
        now, off the serving path."""
        for b in self.ladder.buckets:
            self.score_block(np.zeros((b,) + self._image_shape, np.float32))
        return self

    def _scores(self, x):
        """(k, B, C) scores of a padded block x (B, H, W[, C]) under the
        serving weights."""
        m = self._members
        with torch.no_grad():
            h = cnn.features_members(
                self.cfg, m.cnn_params,
                x[None].expand((m.k,) + tuple(x.shape)))
            return _readout(h, m.beta, self.ladder.max_batch)

    def _capture(self, b: int) -> _BucketGraph:
        """Capture bucket b's graph: warm-up runs on the capture stream
        (the kernel library, the library product's workspace), then one
        capture of the scoring pass in thread-local error mode, so another
        thread's allocations cannot invalidate it."""
        dev = self.device
        if self._stream is None:
            self._stream = torch.cuda.Stream(dev)
        side = self._stream
        x = torch.zeros((b,) + self._image_shape, device=dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            for _ in range(WARMUP_RUNS):
                self._scores(x)
        graph = torch.cuda.CUDAGraph()
        with kernels.capture_launches() as record:
            with torch.cuda.graph(graph, stream=side,
                                  capture_error_mode="thread_local"):
                out = self._scores(x)
        torch.cuda.current_stream(dev).wait_stream(side)
        self._graphs[b] = _BucketGraph(graph, x, out, record)
        return self._graphs[b]

    def score_block(self, x) -> np.ndarray:
        """(k, n, C) member scores of n <= max_batch images — one scoring
        pass at the bucket shape (a graph replay on the card), padded rows
        already sliced off."""
        padded, n = self.ladder.pad_block(np.asarray(x, np.float32))
        b = len(padded)
        if self.device.type == "cpu":
            self._shapes.add(b)
            return self._scores(torch.from_numpy(padded))[:, :n].numpy()
        g = self._graphs.get(b)
        if g is None:
            g = self._capture(b)
        g.x.copy_(torch.from_numpy(padded))
        g.graph.replay()
        kernels.count_replay(g.launches)
        return g.out[:, :n].cpu().numpy()

    def predict_block(self, x, combine: str = "mean") -> np.ndarray:
        """(n,) combined ensemble labels of one batch."""
        return combine_block(self.score_block(x), combine,
                             self.cfg.num_classes)

    # -- the program-count guarantee ----------------------------------

    def compile_count(self) -> int:
        """Programs behind this scorer: its captured graphs on the card,
        the distinct bucket shapes it scored on the CPU."""
        return len(self._graphs) if self.device.type == "cuda" \
            else len(self._shapes)

    def assert_compile_budget(self) -> int:
        """The regression guard: raise ``CompileBudgetExceeded`` (an
        ``AssertionError``) if the scorer holds more programs than the
        ladder has buckets; else return the count."""
        n, budget = self.compile_count(), len(self.ladder.buckets)
        if n > budget:
            raise CompileBudgetExceeded(
                f"bucketed scoring holds {n} programs for {budget} "
                f"buckets {self.ladder.buckets}")
        return n
