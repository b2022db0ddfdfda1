"""The bucket-shaped ensemble scoring engine — the port's counterpart of
``repro.serve.engine``.

``BucketedScorer`` scores k stacked CNN-ELM members only at
``BucketLadder`` shapes. (The reference's compile-count guarantee reads
JAX's jit cache; its counterpart here waits for CUDA-graph capture of one
graph per bucket, in a later slice.)

Weight hot-swap: ``swap_members`` replaces the stacked params with a
SHAPE-IDENTICAL tree (anything else is refused with ``SwapRejected``).

Padding contract: a batch of n rows pads with zero rows up to
``bucket_for(n)``; every CNN-ELM score is row-independent (per-image
features, row-wise ELM readout), and the padded rows are sliced off the
(k, bucket, C) score block BEFORE any combine — padding can never vote.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core.cnn_elm import StackedMembers
from repro_torch.core.runner import COMBINES, scores_stacked
from repro_torch.serve.bucketing import BucketLadder
from repro_torch.tree import tree_leaves, tree_map


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


class BucketedScorer:
    """k stacked CNN-ELM members behind a bucket-shaped scoring entry on
    ``device``. Build via ``runner.Ensemble.bucketed_scorer(...)`` (or
    directly from a ``StackedMembers``); ``warmup()`` runs every bucket
    once off the serving path (and builds the kernels on a card)."""

    def __init__(self, cfg, members: StackedMembers, *,
                 max_batch: int = 64, ladder: Optional[BucketLadder] = None,
                 device="cuda"):
        self.cfg = cfg
        self.ladder = ladder if ladder is not None \
            else BucketLadder(max_batch)
        self.device = resolve_device(device)
        self._members = members.to(self.device)
        self._struct = self._signature(self._members)

    # -- weights ------------------------------------------------------

    @staticmethod
    def _signature(members: StackedMembers):
        tree = (members.cnn_params, members.beta)
        shapes = tree_map(lambda a: (tuple(a.shape), a.dtype), tree)
        return repr(shapes), len(tree_leaves(tree))

    @property
    def members(self) -> StackedMembers:
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
        """Replace the serving weights with a shape/dtype-identical tree;
        anything else raises ``SwapRejected`` (a different arch or k is a
        new endpoint, not a hot swap)."""
        self.validate_members(members)
        self._members = members.to(self.device)

    # -- scoring ------------------------------------------------------

    def warmup(self):
        """Score every bucket shape once now, off the serving path."""
        h, w, c = (self.cfg.image_size, self.cfg.image_size,
                   self.cfg.image_channels)
        shape = (h, w) if c == 1 else (h, w, c)
        for b in self.ladder.buckets:
            self.score_block(np.zeros((b,) + shape, np.float32))
        return self

    def score_block(self, x) -> np.ndarray:
        """(k, n, C) member scores of n <= max_batch images — one scoring
        pass at the bucket shape, padded rows already sliced off."""
        padded, n = self.ladder.pad_block(np.asarray(x, np.float32))
        s = scores_stacked(self.cfg, self._members.cnn_params,
                           self._members.beta,
                           torch.from_numpy(padded).to(self.device))
        return s[:, :n].cpu().numpy()

    def predict_block(self, x, combine: str = "mean") -> np.ndarray:
        """(n,) combined ensemble labels of one batch."""
        return combine_block(self.score_block(x), combine,
                             self.cfg.num_classes)
