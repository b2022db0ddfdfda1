"""The pluggable Reduce-strategy registry — ``ReduceConfig.strategy``'s
open surface.

The paper's Reduce is plain weight averaging, and it admits the weakness
itself: "training data distribution ... need[s] to be carefully
selected". This module turns the former 3-way enum (uniform /
shard_weighted / explicit) into a registry of ``ReduceStrategy`` objects
so the related work's fixes plug in next to the paper's mean:

* ``uniform``        — the paper's mean (weights=None downstream).
* ``shard_weighted`` — weights = shard row counts (the exact expectation
                       over unequal partitions).
* ``ExplicitWeights``— a fixed per-member weight vector. Bare sequences
                       passed as ``strategy=[...]`` still work through a
                       ``DeprecationWarning`` shim that normalises them
                       to this class.
* ``boosted``        — AdaBoost-style member weighting from per-member
                       validation error ("Classification with Boosting
                       of ELM Over Arbitrarily Partitioned Data",
                       arXiv:1602.02887): each member scores a held-out
                       slice after Map and averages with weight
                       ``log((1-err)/err)`` (floored, normalised).
* ``gossip``         — decentralized ring-neighbor consensus averaging
                       ("ELM-Based Distributed Cooperative Learning
                       Over Networks", arXiv:1504.00981): a ``combine``
                       override rather than a weight rule — syncs mix
                       neighbor state over a ring (``lax.ppermute`` on
                       the mesh backend) instead of one global
                       all-reduce.

A strategy resolves **member weights + combine**: ``weights(ctx)``
returns the per-member weight vector (None = uniform) and ``combine``
names the averaging program the executors run (``"mean"`` — the
weighted-average path; ``"gossip"`` — the ring). Strategies that weigh
by trained-member quality (``boosted``) set ``requires_validation`` and
read ``ReduceContext.val_errors`` — a lazy callable the execution layer
wires to the backend-native scoring program (host loop / vmap / in-mesh
shard_map), so the weights themselves stay backend-agnostic.

This is the port's copy of ``repro.core.reduce_strategies`` (numpy
only). The port's runner takes every strategy here: ``uniform``,
``shard_weighted``, explicit weights, ``boosted`` (which scores the
members on a held-out validation slice) and ``gossip`` (the ring on the
member dimension, stacked backend only).

Register a custom strategy::

    @register("trimmed")
    @dataclass(frozen=True)
    class Trimmed(ReduceStrategy):
        name = "trimmed"
        def weights(self, ctx):
            ...

String names in ``ReduceConfig(strategy="...")`` resolve through this
registry, and the config's ``ValueError`` lists ``registry_keys()``
dynamically — a registered strategy is immediately constructible by
name.
"""
from __future__ import annotations

import warnings
from dataclasses import dataclass
from typing import (Callable, ClassVar, Dict, List, Optional, Sequence,
                    Tuple, Union)

import numpy as np

# name -> zero-arg factory (usually the strategy class itself)
REGISTRY: Dict[str, Callable[[], "ReduceStrategy"]] = {}


def register(name: str):
    """Decorator: register a ``ReduceStrategy`` class (or zero-arg
    factory) under ``name`` — the string ``ReduceConfig(strategy=name)``
    resolves through."""
    if not name or not isinstance(name, str):
        raise ValueError(f"strategy names are non-empty strings, "
                         f"got {name!r}")

    def wrap(factory):
        if name in REGISTRY:
            raise ValueError(f"duplicate Reduce strategy {name!r}")
        REGISTRY[name] = factory
        return factory

    return wrap


def registry_keys() -> Tuple[str, ...]:
    """The registered strategy names, sorted — the dynamic half of the
    ``ReduceConfig`` validation message and the lint rule's whitelist."""
    return tuple(sorted(REGISTRY))


@dataclass(frozen=True)
class ReduceContext:
    """What a strategy may weigh by: the member count, per-member shard
    row counts (``rows``; None when the caller has no notion of shard
    size), the averaging round index, and ``val_errors`` — a LAZY
    zero-arg callable returning the (k,) per-member misclassification
    rate on the run's held-out validation slice (None when no slice was
    configured; only strategies with ``requires_validation`` ever call
    it, so the scoring program runs at most once per round). ``unit``
    names what a member is in error messages ("partitions" for the batch
    runner, "members" for streaming windows)."""
    num_members: int
    rows: Optional[Tuple[int, ...]] = None
    round: int = 0
    val_errors: Optional[Callable[[], np.ndarray]] = None
    unit: str = "partitions"


class ReduceStrategy:
    """Protocol for one pluggable Reduce: ``weights(ctx)`` resolves the
    per-member weight vector (None = uniform — downstream programs keep
    their weight-free fast path), ``combine`` names the averaging
    program (``"mean"`` weighted average, ``"gossip"`` ring consensus).
    ``requires_validation`` marks strategies whose weights come from
    held-out scoring (the runner then demands
    ``ReduceConfig(validation=...)``); ``elastic_ok`` marks strategies
    whose weights extend to membership churn (a joiner/leaver changes
    k mid-run, so fixed-length weight vectors and ring topologies
    don't)."""

    name: ClassVar[str] = "?"
    combine: ClassVar[str] = "mean"
    requires_validation: ClassVar[bool] = False
    elastic_ok: ClassVar[bool] = False

    def weights(self, ctx: ReduceContext) -> Optional[List[float]]:
        raise NotImplementedError


@register("uniform")
@dataclass(frozen=True)
class Uniform(ReduceStrategy):
    """The paper's Reduce: the plain mean (Alg. 2 lines 18-20)."""

    name: ClassVar[str] = "uniform"
    elastic_ok: ClassVar[bool] = True

    def weights(self, ctx: ReduceContext) -> Optional[List[float]]:
        return None


@register("shard_weighted")
@dataclass(frozen=True)
class ShardWeighted(ReduceStrategy):
    """Weights = shard row counts — the exact expectation over unequal
    partitions (streaming weighs by the rows currently in each member's
    window instead)."""

    name: ClassVar[str] = "shard_weighted"
    elastic_ok: ClassVar[bool] = True

    def weights(self, ctx: ReduceContext) -> Optional[List[float]]:
        if ctx.rows is None:
            raise ValueError("'shard_weighted' needs per-member row "
                             "counts (ReduceContext.rows)")
        return [float(r) for r in ctx.rows]


@dataclass(frozen=True)
class ExplicitWeights(ReduceStrategy):
    """A fixed per-member weight vector. Not in the registry (there is
    no data-free way to construct it by name) — build it directly, or
    keep passing a bare sequence as ``strategy=[...]`` through the
    deprecation shim."""

    w: Tuple[float, ...] = ()
    name: ClassVar[str] = "explicit"

    def __post_init__(self):
        object.__setattr__(self, "w",
                           tuple(float(v) for v in self.w))

    def weights(self, ctx: ReduceContext) -> List[float]:
        if len(self.w) != ctx.num_members:
            raise ValueError(f"{len(self.w)} explicit weights for "
                             f"{ctx.num_members} {ctx.unit}")
        return list(self.w)


def boosted_weights(errors, *, floor: float = 1e-3) -> List[float]:
    """AdaBoost-style member weights from per-member validation error:
    ``alpha_i = log((1 - err_i) / err_i)`` with ``err`` clipped into
    ``[floor, 1 - floor]`` and ``alpha`` floored at ``floor`` (so a
    member at or past chance — err >= 0.5, where the raw log turns zero
    or negative — keeps a small positive vote instead of flipping the
    average's sign), normalised to sum to 1. Uniform error therefore
    gives exactly uniform weights. Float64 on the host: the (k,) error
    vector is tiny; only the averaged params ride the device."""
    if not 0.0 < floor < 0.5:
        raise ValueError(f"floor must be in (0, 0.5), got {floor}")
    err = np.clip(np.asarray(errors, np.float64).reshape(-1),
                  floor, 1.0 - floor)
    alpha = np.maximum(np.log((1.0 - err) / err), floor)
    return [float(a) for a in alpha / alpha.sum()]


@register("boosted")
@dataclass(frozen=True)
class Boosted(ReduceStrategy):
    """AdaBoost-style weighting (arXiv:1602.02887): members that score
    well on the held-out validation slice dominate the average — the
    direct attack on uniform averaging's non-IID degradation. The
    weights feed the EXISTING weighted-average path (one-psum /
    two-psum collectives on the mesh); only the (k,) error vector is
    new, computed by the backend-native scoring program the execution
    layer hands in via ``ReduceContext.val_errors``."""

    floor: float = 1e-3
    name: ClassVar[str] = "boosted"
    requires_validation: ClassVar[bool] = True
    elastic_ok: ClassVar[bool] = True

    def __post_init__(self):
        if not 0.0 < self.floor < 0.5:
            raise ValueError(f"floor must be in (0, 0.5), "
                             f"got {self.floor}")

    def weights(self, ctx: ReduceContext) -> List[float]:
        if ctx.val_errors is None:
            raise ValueError(
                "'boosted' weighs members by held-out validation error — "
                "run it through AveragingRun with "
                "ReduceConfig(validation=Partition(xv, yv)) so the "
                "execution layer can score the slice after Map")
        err = np.asarray(ctx.val_errors(), np.float64).reshape(-1)
        if err.shape[0] != ctx.num_members:
            raise ValueError(f"{err.shape[0]} validation errors for "
                             f"{ctx.num_members} {ctx.unit}")
        return boosted_weights(err, floor=self.floor)


@register("gossip")
@dataclass(frozen=True)
class Gossip(ReduceStrategy):
    """Decentralized ring consensus (arXiv:1504.00981): every sync, each
    node mixes its state with its two ring neighbors
    (``x <- (x + left + right) / 3``) for ``rounds`` mixing rounds —
    neighbor-only communication, ZERO global all-reduces (on the mesh
    backend each mixing round is two ``lax.ppermute`` collectives on the
    flat 'pod' ring). Nodes keep their OWN consensus iterate between
    averaging events (the decentralized regime); iterates approach the
    one-psum average geometrically in ``rounds`` (mixing-matrix spectral
    gap), and the published model reads the ratio of the mixing-invariant
    numerator/weight sums — see docs/perf.md §Gossip ring."""

    rounds: int = 4
    name: ClassVar[str] = "gossip"
    combine: ClassVar[str] = "gossip"

    def __post_init__(self):
        if self.rounds < 1:
            raise ValueError(f"gossip needs rounds >= 1, "
                             f"got {self.rounds}")

    def weights(self, ctx: ReduceContext) -> Optional[List[float]]:
        return None          # the ring carries uniform base weights


def resolve(spec: Union[str, Sequence[float], ReduceStrategy],
            *, _warn_stacklevel: int = 3) -> ReduceStrategy:
    """``ReduceConfig.strategy`` -> a ``ReduceStrategy``: instances pass
    through, strings resolve through the registry (the ``ValueError``
    lists ``registry_keys()`` dynamically), and bare weight sequences —
    the pre-registry surface — normalise to ``ExplicitWeights`` under a
    ``DeprecationWarning``."""
    if isinstance(spec, ReduceStrategy):
        return spec
    if isinstance(spec, type) and issubclass(spec, ReduceStrategy):
        raise ValueError(f"strategy takes a ReduceStrategy INSTANCE "
                         f"(or a registered name), got the class "
                         f"{spec.__name__} — did you mean "
                         f"{spec.__name__}()?")
    if isinstance(spec, str):
        if spec not in REGISTRY:
            raise ValueError(
                f"strategy must be one of the registered names "
                f"{registry_keys()}, an explicit weight sequence, or a "
                f"ReduceStrategy instance; got {spec!r}")
        return REGISTRY[spec]()
    try:
        w = tuple(float(v) for v in spec)
    except (TypeError, ValueError):
        raise ValueError(f"strategy must be one of the registered names "
                         f"{registry_keys()}, an explicit weight "
                         f"sequence, or a ReduceStrategy instance; got "
                         f"{spec!r}") from None
    warnings.warn(
        "passing a bare weight sequence as ReduceConfig.strategy is "
        "deprecated — use reduce_strategies.ExplicitWeights"
        f"({list(w)}) (docs/api.md has the migration table)",
        DeprecationWarning, stacklevel=_warn_stacklevel)
    return ExplicitWeights(w)
