"""Composable MapReduce runner — the paper's Algorithm 2 as config objects.
The port's counterpart of ``repro.core.runner``.

* ``MapConfig``    — epochs, batch size, backend (``"sequential"`` or
                     ``"stacked"``, see ``core.executor``) and THE member
                     seed rule. There is no kernel switch: the device
                     decides (hand kernels on CUDA, plain versions on the
                     CPU).
* ``ReduceConfig`` — the Reduce strategy: ``uniform``, ``shard_weighted``
                     or explicit weights (``core.reduce_strategies``).
* ``AveragingRun`` — binds a model config to the two phase configs;
                     ``.run(partitions, ...)`` returns a ``RunResult``.
* ``Ensemble``     — the k members behind one batched scoring surface:
                     every eval slice is one member-batched pass.

Seed rule (shared by both backends): member ``i`` draws its batch
permutations from ``np.random.default_rng(MapConfig.seed + i)``.

This slice runs the epochs=0 closed-form Map. SGD epochs, ``rounds > 1``,
the mesh backend, chunked epochs, checkpoints, elastic membership and the
``boosted``/``gossip`` strategies come with later slices and raise
``NotImplementedError`` here.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, List, Optional, Sequence, Union

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core import elm, reduce_strategies
from repro_torch.core.cnn_elm import (SGD_SLICE, CNNELMModel, StackedMembers,
                                      stack_models)
from repro_torch.core.executor import (BACKENDS, MESH_SLICE, ExecutionPlan,
                                       make_executor)
from repro_torch.core.reduce_strategies import ReduceContext, ReduceStrategy
from repro_torch.data.partition import Partition
from repro_torch.models import cnn

COMBINES = ("mean", "vote")


@dataclass(frozen=True)
class MapConfig:
    """Map-phase configuration (Alg. 2 lines 4-17, one member per shard)."""
    epochs: int = 0
    batch_size: int = 32
    backend: str = "stacked"
    seed: int = 1000

    def __post_init__(self):
        if self.backend == "mesh":
            raise NotImplementedError(MESH_SLICE)
        if self.backend not in BACKENDS:
            raise ValueError(f"backend must be one of {BACKENDS}, "
                             f"got {self.backend!r}")
        if self.epochs < 0:
            raise ValueError(f"epochs must be >= 0, got {self.epochs}")
        if self.epochs > 0:
            raise NotImplementedError(SGD_SLICE)
        if self.batch_size < 1:
            raise ValueError(f"batch_size must be >= 1, "
                             f"got {self.batch_size}")

    def member_seed(self, i: int) -> int:
        """THE seed rule: member i's stream is ``default_rng(seed + i)``."""
        return self.seed + i


@dataclass(frozen=True)
class ReduceConfig:
    """Reduce-phase configuration (Alg. 2 lines 18-20).

    ``strategy`` — a registered name (``"uniform"``, ``"shard_weighted"``),
    a ``ReduceStrategy`` instance (``ExplicitWeights((...,))``), or —
    deprecated — a bare weight sequence. ``rounds`` is the number of
    averaging events; this slice runs the paper's single final average."""
    strategy: Union[str, Sequence[float], ReduceStrategy] = "uniform"
    rounds: int = 1

    def __post_init__(self):
        strat = reduce_strategies.resolve(self.strategy, _warn_stacklevel=4)
        object.__setattr__(self, "_strategy_obj", strat)
        if strat.requires_validation or strat.combine != "mean":
            raise NotImplementedError(
                f"strategy {strat.name!r} scores members or mixes a ring; "
                f"it comes with a later slice of the port")
        if self.rounds < 1:
            raise ValueError(f"rounds must be >= 1, got {self.rounds}")
        if self.rounds > 1:
            raise NotImplementedError(
                "rounds > 1 interleaves SGD epochs with averaging — it "
                "comes with the SGD-epochs slice")

    @property
    def strategy_obj(self) -> ReduceStrategy:
        return self._strategy_obj

    def resolve_weights(self, partitions: Sequence[Partition]
                        ) -> Optional[List[float]]:
        """Per-member weights for these partitions (None = uniform)."""
        return self._strategy_obj.weights(ReduceContext(
            num_members=len(partitions),
            rows=tuple(len(p.x) for p in partitions)))


@dataclass
class RunResult:
    """Everything a Map/Reduce run produced: the k members (also stacked),
    the averaged model, and the member-stacked ``ELMStats`` every β was
    solved from, on the run's device."""
    cfg: Any
    members: List[CNNELMModel]
    averaged: CNNELMModel
    stacked: StackedMembers
    stats: elm.ELMStats
    wall_time_s: float
    backend: str
    device: torch.device

    def ensemble(self, combine: str = "mean") -> "Ensemble":
        """The k members as a batched scoring surface on the run's device."""
        return Ensemble(self.cfg, self.stacked, combine=combine,
                        device=self.device)


@dataclass
class AveragingRun:
    """One distributed-averaging experiment: model config + Map config +
    Reduce config. ``run`` executes Algorithm 2: init once, Map every
    shard, Reduce by averaging."""
    cfg: Any
    map_cfg: MapConfig = field(default_factory=MapConfig)
    reduce_cfg: ReduceConfig = field(default_factory=ReduceConfig)

    def run(self, partitions: Sequence[Partition], *,
            generator: Optional[torch.Generator] = None,
            init_params=None, device="cuda") -> RunResult:
        """Run on ``device`` (default the card). The members start from
        ``init_params`` (a parameter tree, e.g. the reference's init through
        ``convert.params_from_numpy``; moved to ``device``) or, without one,
        from ``cnn.init_params(cfg, generator, device)``."""
        dev = resolve_device(device)
        if init_params is None:
            if generator is None:
                raise ValueError("pass generator= (a seeded torch.Generator) "
                                 "or init_params=")
            init_params = cnn.init_params(self.cfg, generator, dev)
        m = self.map_cfg
        plan = ExecutionPlan(
            batch_size=m.batch_size, seed=m.seed,
            reduce_weights=self.reduce_cfg.resolve_weights(partitions),
            device=dev)
        t0 = time.perf_counter()
        out = make_executor(m.backend).execute(self.cfg, init_params,
                                               partitions, plan)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        return RunResult(self.cfg, out.members, out.averaged, out.stacked,
                         out.stats, time.perf_counter() - t0, m.backend, dev)


# ---------------------------------------------------------------------------
# Batched ensemble scoring
# ---------------------------------------------------------------------------

def scores_stacked(cfg, cnn_params_k, beta_k, x):
    """(k, B, C) ELM scores of ONE eval batch x (B, H, W[, C]) under ALL k
    members: the batch is shared, each member's CNN runs on it in one
    member-batched launch per conv stage."""
    k = beta_k.shape[0]
    x = x.float()
    h = cnn.features_members(cfg, cnn_params_k,
                             x[None].expand((k,) + tuple(x.shape)))
    return elm.predict(h, beta_k)


def confusion_matrix(y, preds, num_classes: int) -> np.ndarray:
    """(C, C) confusion matrix via one ``np.add.at`` scatter. Rows = true
    label, cols = predicted."""
    cm = np.zeros((num_classes, num_classes), np.int64)
    np.add.at(cm, (np.asarray(y, np.int64), np.asarray(preds, np.int64)), 1)
    return cm


def kappa_from_confusion(cm: np.ndarray) -> float:
    """Cohen's kappa from a confusion matrix (paper Table 1c's metric)."""
    cm = cm.astype(np.float64)
    n = cm.sum()
    po = np.trace(cm) / n
    pe = float((cm.sum(0) * cm.sum(1)).sum()) / (n * n)
    return float((po - pe) / (1 - pe + 1e-12))


@dataclass
class Ensemble:
    """k CNN-ELM models behind one batched scoring surface, on ``device``.

    Every public method walks the eval set once in ``batch_size`` slices,
    each slice one member-batched scoring pass (``scores_stacked``).

    ``combine`` picks the ensemble decision rule for ``predict``/
    ``accuracy``/``kappa_combined``: ``"mean"`` — argmax of the mean member
    score; ``"vote"`` — majority vote over member argmaxes, ties resolving
    to the LOWEST class index (np.argmax convention — the reference's
    pinned rule, kept through the bucketed serving path too)."""
    cfg: Any
    members: StackedMembers
    combine: str = "mean"
    device: Any = "cuda"

    def __post_init__(self):
        if self.combine not in COMBINES:
            raise ValueError(f"combine must be one of {COMBINES}, "
                             f"got {self.combine!r}")
        self.device = resolve_device(self.device)
        self.members = self.members.to(self.device)

    @classmethod
    def from_models(cls, cfg, models: Sequence[CNNELMModel],
                    combine: str = "mean", device="cuda") -> "Ensemble":
        return cls(cfg, stack_models(models), combine=combine, device=device)

    @property
    def k(self) -> int:
        return self.members.k

    def _batched_scores(self, x, batch_size: int):
        """Yield (k, B, C) numpy score blocks, one scoring pass per block."""
        for i in range(0, len(x), batch_size):
            xb = torch.as_tensor(np.asarray(x[i:i + batch_size], np.float32))
            yield scores_stacked(self.cfg, self.members.cnn_params,
                                 self.members.beta,
                                 xb.to(self.device)).cpu().numpy()

    def member_scores(self, x, batch_size: int = 512) -> np.ndarray:
        """(k, n, C) raw ELM scores for every member."""
        return np.concatenate(list(self._batched_scores(x, batch_size)),
                              axis=1)

    def member_predictions(self, x, batch_size: int = 512) -> np.ndarray:
        """(k, n) argmax labels for every member."""
        return np.concatenate(
            [s.argmax(-1) for s in self._batched_scores(x, batch_size)],
            axis=1)

    def predict(self, x, batch_size: int = 512) -> np.ndarray:
        """(n,) combined ensemble labels under the ``combine`` rule."""
        if self.combine == "mean":
            return np.concatenate(
                [s.mean(axis=0) for s in self._batched_scores(x, batch_size)],
                axis=0).argmax(-1)
        preds = self.member_predictions(x, batch_size)
        C = self.cfg.num_classes
        n = preds.shape[1]
        votes = np.zeros((n, C), np.int64)
        np.add.at(votes, (np.tile(np.arange(n), self.k), preds.reshape(-1)), 1)
        return votes.argmax(-1)

    def evaluate(self, x, y, batch_size: int = 512,
                 preds: Optional[np.ndarray] = None) -> np.ndarray:
        """(k,) per-member accuracy. Pass ``preds`` (a
        ``member_predictions`` result) to reuse one scoring pass."""
        if preds is None:
            preds = self.member_predictions(x, batch_size)
        elif preds.ndim != 2:
            raise ValueError("evaluate takes member_predictions-shaped "
                             f"(k, n) preds, got shape {preds.shape}")
        return (preds == np.asarray(y)[None, :]).mean(axis=1)

    def kappa(self, x, y, batch_size: int = 512,
              preds: Optional[np.ndarray] = None) -> np.ndarray:
        """(k,) per-member Cohen's kappa."""
        if preds is None:
            preds = self.member_predictions(x, batch_size)
        elif preds.ndim != 2:
            raise ValueError("kappa takes member_predictions-shaped "
                             f"(k, n) preds, got shape {preds.shape}")
        C = self.cfg.num_classes
        return np.array([kappa_from_confusion(confusion_matrix(y, p, C))
                         for p in preds])

    def accuracy(self, x, y, batch_size: int = 512,
                 preds: Optional[np.ndarray] = None) -> float:
        """Combined-decision accuracy under the ``combine`` rule."""
        if preds is None:
            preds = self.predict(x, batch_size)
        elif preds.ndim != 1:
            raise ValueError("accuracy takes predict-shaped (n,) preds, "
                             f"got shape {preds.shape}")
        return float((preds == np.asarray(y)).mean())

    def kappa_combined(self, x, y, batch_size: int = 512,
                       preds: Optional[np.ndarray] = None) -> float:
        """Combined-decision Cohen's kappa under the ``combine`` rule."""
        if preds is None:
            preds = self.predict(x, batch_size)
        elif preds.ndim != 1:
            raise ValueError("kappa_combined takes predict-shaped (n,) "
                             f"preds, got shape {preds.shape}")
        return kappa_from_confusion(
            confusion_matrix(y, preds, self.cfg.num_classes))

    def averaged(self) -> CNNELMModel:
        """The paper's Reduce over these members (uniform mean)."""
        return self.members.averaged()

    def bucketed_scorer(self, max_batch: int = 64):
        """The serving entry over these members: a
        ``serve.engine.BucketedScorer`` that only ever scores at
        power-of-two bucket shapes, on this ensemble's device."""
        from repro_torch.serve.engine import BucketedScorer
        return BucketedScorer(self.cfg, self.members, max_batch=max_batch,
                              device=self.device)


def evaluate_model(cfg, model: CNNELMModel, x, y, batch_size: int = 512,
                   device="cuda") -> float:
    """Accuracy of one model (a k=1 ensemble)."""
    ens = Ensemble.from_models(cfg, [model], device=device)
    return float(ens.evaluate(x, y, batch_size=batch_size)[0])


def kappa_model(cfg, model: CNNELMModel, x, y, batch_size: int = 512,
                device="cuda") -> float:
    """Cohen's kappa of one model."""
    ens = Ensemble.from_models(cfg, [model], device=device)
    return float(ens.kappa(x, y, batch_size=batch_size)[0])
