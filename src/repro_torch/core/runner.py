"""Composable MapReduce runner — the paper's Algorithm 2 as config objects.
The port's counterpart of ``repro.core.runner``.

* ``MapConfig``    — epochs, lr schedule, batch size, backend
                     (``"sequential"``, ``"stacked"`` or ``"mesh"`` with its
                     member ``mesh``, see ``core.executor``), epoch chunking
                     and THE member seed rule. There is no kernel switch:
                     the device decides (hand kernels on CUDA, plain
                     versions on the CPU).
* ``ReduceConfig`` — the Reduce strategy (``uniform``, ``shard_weighted``,
                     explicit weights, ``boosted`` with a held-out
                     ``validation`` slice, ``gossip``;
                     ``core.reduce_strategies``), ``rounds``: ``r > 1``
                     splits the epochs into r blocks with a sync between
                     blocks, the parallel-SGD regime (stacked and mesh),
                     and ``elastic``: an ``ElasticSchedule`` of joins and
                     leaves at round boundaries.
* ``AveragingRun`` — binds a model config to the two phase configs;
                     ``.run(partitions, ...)`` returns a ``RunResult`` with
                     one ``RoundRecord`` per round (an ``ElasticRunResult``
                     under an elastic schedule); ``.resume(partitions,
                     ckpt_dir, ...)`` continues a checkpointed run.
* ``Ensemble``     — the k members behind one batched scoring surface:
                     every eval slice is one member-batched pass.

Seed rule (shared by every backend): member ``i`` draws its batch
permutations from ``np.random.default_rng(MapConfig.seed + i)``; epoch e's
batch order is that stream's (e+1)-th permutation.

Fault tolerance: ``CheckpointConfig`` turns on atomic per-round (stacked)
or per-member (sequential) checkpoints (``checkpoint.run_state``), and
``AveragingRun.resume`` continues a killed run bit for bit as the
uninterrupted one. Under ``ReduceConfig.elastic`` members join at a round
boundary from that boundary's average and leave with their weighted
contribution kept in every later average (``core.elastic.ElasticGroup``),
each round one executor block over the current members.
``core.faults`` injects crashes and torn saves.

``ReduceConfig(sync="drift")`` is the streaming policy: it constructs
(rounds 1, no elastic schedule), and ``AveragingRun.run`` refuses it,
pointing to ``repro_torch.stream.StreamingRun``.

On the mesh backend every rank of the group calls ``run`` (or ``resume``)
with the same arguments and gets the same result; each rank trains only
its own members (``core.executor.MeshExecutor``).
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import (Any, Callable, Dict, List, Optional, Sequence, Tuple,
                    Union)

import numpy as np
import torch

from repro_torch import kernels, resolve_device
from repro_torch.checkpoint import run_state
from repro_torch.checkpoint.ckpt import checkpoint_path
from repro_torch.core import elastic, elm, reduce_strategies
from repro_torch.core.cnn_elm import (CNNELMModel, StackedMembers,
                                      scores_stacked, stack_models)
from repro_torch.core.executor import (BACKENDS, CheckpointConfig,
                                       ExecutionPlan, make_executor)
from repro_torch.core.reduce_strategies import ReduceContext, ReduceStrategy
from repro_torch.data.partition import Partition
from repro_torch.models import cnn
from repro_torch.tree import tree_map

COMBINES = ("mean", "vote")
SYNCS = ("rounds", "drift")


@dataclass(frozen=True)
class MapConfig:
    """Map-phase configuration (Alg. 2 lines 4-17, one member per shard).
    ``chunk_batches`` stages each epoch on the stacked layouts in chunks of
    that many batch indices (pinned host memory, copied one chunk ahead);
    the result is bit-identical to the whole-epoch copy. ``mesh`` is the
    member mesh of ``backend="mesh"`` (``launch.mesh.make_member_mesh``;
    None: the flat mesh over every rank of the initialised group)."""
    epochs: int = 0
    lr_schedule: Optional[Callable[[int], float]] = None
    batch_size: int = 32
    backend: str = "stacked"
    mesh: Any = None
    chunk_batches: Optional[int] = None
    seed: int = 1000

    def __post_init__(self):
        if self.backend not in BACKENDS:
            raise ValueError(f"backend must be one of {BACKENDS}, "
                             f"got {self.backend!r}")
        if self.mesh is not None and self.backend != "mesh":
            raise ValueError(f"MapConfig.mesh is read by backend 'mesh' "
                             f"only, got backend {self.backend!r}")
        if self.epochs < 0:
            raise ValueError(f"epochs must be >= 0, got {self.epochs}")
        if self.epochs > 0 and self.lr_schedule is None:
            raise ValueError("epochs > 0 needs an lr_schedule "
                             "(e.g. optim.schedules.dynamic_paper)")
        if self.batch_size < 1:
            raise ValueError(f"batch_size must be >= 1, "
                             f"got {self.batch_size}")
        if self.chunk_batches is not None and self.chunk_batches < 1:
            raise ValueError(f"chunk_batches must be >= 1, "
                             f"got {self.chunk_batches}")

    def member_seed(self, i: int) -> int:
        """THE seed rule: member i's stream is ``default_rng(seed + i)``."""
        return self.seed + i


@dataclass(frozen=True)
class ElasticEvent:
    """One membership change, applied at the boundary after round
    ``after_round``'s sync: ``leave`` names depart first (their final params
    and stats stay in the group as a retired weighted contribution), then
    the boundary average is taken, then each ``join`` partition enters as a
    new member starting from exactly that average."""
    after_round: int
    join: Tuple[Partition, ...] = ()
    leave: Tuple[str, ...] = ()

    def __post_init__(self):
        if self.after_round < 0:
            raise ValueError(f"after_round must be >= 0, "
                             f"got {self.after_round}")
        if not (self.join or self.leave):
            raise ValueError("an ElasticEvent needs at least one join "
                             "partition or leave name")


@dataclass(frozen=True)
class ElasticSchedule:
    """The membership timeline of an elastic run: ``ElasticEvent``s in any
    order (events at one boundary merge). Members are named ``m<id>`` in
    join order — the initial k partitions are ``m0..m<k-1>`` and every
    joiner takes the next id, which also pins its rng stream
    (``MapConfig.seed + id``), so churn never reshuffles anyone's data."""
    events: Tuple[ElasticEvent, ...] = ()

    def __post_init__(self):
        for ev in self.events:
            if not isinstance(ev, ElasticEvent):
                raise ValueError(f"events must be ElasticEvent, got "
                                 f"{type(ev).__name__}")

    def at(self, boundary: int) -> Tuple[List[Partition], List[str]]:
        """(joins, leaves) at the boundary after round ``boundary``."""
        joins: List[Partition] = []
        leaves: List[str] = []
        for ev in self.events:
            if ev.after_round == boundary:
                joins.extend(ev.join)
                leaves.extend(ev.leave)
        return joins, leaves

    @property
    def last_boundary(self) -> int:
        return max((ev.after_round for ev in self.events), default=-1)


@dataclass(frozen=True)
class ReduceConfig:
    """Reduce-phase configuration (Alg. 2 lines 18-20).

    ``strategy`` — a registered name (``"uniform"``, ``"shard_weighted"``,
    ``"boosted"``, ``"gossip"``), a ``ReduceStrategy`` instance
    (``ExplicitWeights((...,))``, ``Boosted(floor=...)``,
    ``Gossip(rounds=...)``), or — deprecated — a bare weight sequence.
    ``validation`` — the held-out ``Partition`` that ``boosted`` scores
    every member on after each round; required by such strategies and
    refused by the others. ``rounds`` — how many averaging events the
    epochs split into (``1``: the paper's single final average).
    ``elastic`` — an ``ElasticSchedule`` of joins and leaves at round
    boundaries; the averaging weights are then cumulative work
    (``uniform``: rounds survived, ``shard_weighted``: rows processed,
    ``boosted``: validation-quality alphas per block), so strategies
    without ``elastic_ok`` (explicit weights, gossip) are refused; it needs
    ``rounds >= 2``. ``sync`` — WHEN the averaging events fire:
    ``"rounds"`` (default) is everything above, a fixed count of evenly
    spaced syncs; ``"drift"`` fires whenever a member's drift detector
    signals — the STREAMING policy, which needs the per-chunk detectors of
    ``repro_torch.stream.StreamingRun``, so the batch runner refuses it."""
    strategy: Union[str, Sequence[float], ReduceStrategy] = "uniform"
    rounds: int = 1
    validation: Optional[Partition] = None
    sync: str = "rounds"
    elastic: Optional[ElasticSchedule] = None

    def __post_init__(self):
        strat = reduce_strategies.resolve(self.strategy, _warn_stacklevel=4)
        object.__setattr__(self, "_strategy_obj", strat)
        if self.sync not in SYNCS:
            raise ValueError(f"sync must be one of {SYNCS}, "
                             f"got {self.sync!r}")
        if self.rounds < 1:
            raise ValueError(f"rounds must be >= 1, got {self.rounds}")
        if strat.requires_validation and self.validation is None:
            raise ValueError(
                f"strategy {strat.name!r} weighs members by held-out "
                f"validation error — pass "
                f"ReduceConfig(validation=Partition(xv, yv))")
        if self.validation is not None and not strat.requires_validation:
            raise ValueError(
                f"strategy {strat.name!r} does not score a validation "
                f"slice — drop ReduceConfig.validation (it would be "
                f"silently ignored)")
        if self.sync == "drift" and self.rounds != 1:
            raise ValueError(
                "sync='drift' replaces the rounds cadence — leave rounds=1 "
                "(drift-triggered syncs fire per chunk, not per round)")
        if self.sync == "drift" and self.elastic is not None:
            raise ValueError("sync='drift' does not combine with an elastic "
                             "schedule")
        if self.elastic is not None:
            if not isinstance(self.elastic, ElasticSchedule):
                raise ValueError("elastic must be an ElasticSchedule")
            if not strat.elastic_ok:
                if strat.name == "explicit":
                    raise ValueError(
                        "explicit weight sequences cannot follow membership "
                        "changes — use 'uniform', 'shard_weighted' or "
                        "'boosted' with an elastic schedule")
                raise ValueError(
                    f"strategy {strat.name!r} does not extend to "
                    f"membership churn (elastic_ok=False) — use "
                    f"'uniform', 'shard_weighted' or 'boosted' with an "
                    f"elastic schedule")
            if self.rounds < 2:
                raise ValueError("an elastic schedule needs rounds >= 2 — "
                                 "events apply between rounds")
            if self.elastic.last_boundary > self.rounds - 2:
                raise ValueError(
                    f"elastic event after round "
                    f"{self.elastic.last_boundary} has no following round "
                    f"(rounds={self.rounds}; boundaries are "
                    f"0..{self.rounds - 2})")

    @property
    def strategy_obj(self) -> ReduceStrategy:
        return self._strategy_obj

    def resolve_weights(self, partitions: Sequence[Partition]
                        ) -> Optional[List[float]]:
        """The static per-member weights for these partitions (None =
        uniform); strategies that weigh trained members (``boosted``)
        resolve per round instead."""
        return self._strategy_obj.weights(ReduceContext(
            num_members=len(partitions),
            rows=tuple(len(p.x) for p in partitions)))


@dataclass
class RoundRecord:
    """One averaging round: the global epoch span it covered, its wall
    time (host clock to a synchronise), the kernel launches it made (the
    change of ``kernels.LAUNCHES`` by kernel — the port's counterpart of the
    reference's jit dispatch count), and what the caller's
    ``round_hook(round, averaged)`` returned (None without one)."""
    round: int
    epoch_start: int
    epoch_end: int
    wall_time_s: float
    launches: Dict[str, int]
    hook: Any = None


@dataclass
class RunResult:
    """Everything a Map/Reduce run produced: the k members (also stacked),
    the averaged model, the member-stacked ``ELMStats`` every β was solved
    from (the final epoch's), on the run's device; one ``RoundRecord`` per
    round run, the number of inter-round syncs, and whether the run was
    rebuilt or continued from a checkpoint."""
    cfg: Any
    members: List[CNNELMModel]
    averaged: CNNELMModel
    stacked: StackedMembers
    stats: elm.ELMStats
    wall_time_s: float
    backend: str
    device: torch.device
    rounds: List[RoundRecord] = field(default_factory=list)
    round_syncs: int = 0
    resumed: bool = False

    def ensemble(self, combine: str = "mean") -> "Ensemble":
        """The k members as a batched scoring surface on the run's device."""
        return Ensemble(self.cfg, self.stacked, combine=combine,
                        device=self.device)


@dataclass
class ElasticRoundRecord:
    """One round of an elastic run: who was in it, who changed at its
    boundary, its wall time and kernel launches, and the round_hook result
    (hooks see the boundary average — leavers' contributions in, joiners
    not yet trained)."""
    round: int
    members: List[str]
    joined: List[str]
    left: List[str]
    wall_time_s: float
    launches: Dict[str, int]
    hook: Any = None


@dataclass
class ElasticRunResult:
    """An elastic run's output: the surviving ``members`` by name; the
    ``averaged`` model, the ``ElasticGroup`` Reduce over the survivors'
    final models and every retired member's weighted contribution; the
    ``group`` itself (retired params and stats, cumulative weights), e.g.
    for ``group.solve_head(lam)``, the E²LM readout over every member's
    recorded stats."""
    cfg: Any
    members: Dict[str, CNNELMModel]
    averaged: CNNELMModel
    group: elastic.ElasticGroup
    rounds: List[ElasticRoundRecord]
    wall_time_s: float
    backend: str
    device: torch.device
    resumed: bool = False

    def ensemble(self, combine: str = "mean") -> "Ensemble":
        """The surviving members as a batched scoring surface."""
        return Ensemble.from_models(self.cfg, list(self.members.values()),
                                    combine=combine, device=self.device)


class _RoundClock:
    """Wall time (host clock to a synchronise) and kernel launches since the
    last ``tick``."""

    def __init__(self, dev: torch.device):
        self.dev = dev
        self.t = time.perf_counter()
        self.launches = dict(kernels.LAUNCHES)

    def tick(self):
        if self.dev.type == "cuda":
            torch.cuda.synchronize(self.dev)
        now = time.perf_counter()
        launches = {name: n - self.launches[name]
                    for name, n in kernels.LAUNCHES.items()}
        wall = now - self.t
        self.t, self.launches = now, dict(kernels.LAUNCHES)
        return wall, launches


@dataclass
class AveragingRun:
    """One distributed-averaging experiment: model config + Map config +
    Reduce config. ``run`` executes Algorithm 2: init once, Map every
    shard, Reduce by averaging — ``rounds`` times (with
    ``ReduceConfig.elastic``, membership changes between rounds).
    ``resume`` continues a checkpointed run bit for bit."""
    cfg: Any
    map_cfg: MapConfig = field(default_factory=MapConfig)
    reduce_cfg: ReduceConfig = field(default_factory=ReduceConfig)

    def run(self, partitions: Sequence[Partition], *,
            generator: Optional[torch.Generator] = None,
            init_params=None, device="cuda",
            round_hook: Optional[Callable[[int, CNNELMModel], Any]] = None,
            checkpoint: Optional[CheckpointConfig] = None):
        """Run on ``device`` (default the card). The members start from
        ``init_params`` (a parameter tree, e.g. the reference's init through
        ``convert.params_from_numpy``; moved to ``device``) or, without one,
        from ``cnn.init_params(cfg, generator, device)``.

        ``round_hook(r, averaged)`` (optional) runs after every round's
        Reduce with that round's averaged model — the model the members
        were reset to; its return value lands in ``RunResult.rounds[r]``.
        Rounds without a hook or a checkpoint skip their β solve and
        Reduce. ``checkpoint`` turns on atomic per-round (stacked) or
        per-member (sequential) checkpoints. Under
        ``ReduceConfig.elastic`` the result is an ``ElasticRunResult``.
        ``ReduceConfig(sync="drift")`` is refused: it needs
        ``repro_torch.stream.StreamingRun``."""
        if self.reduce_cfg.sync == "drift":
            raise ValueError(
                "ReduceConfig(sync='drift') is the streaming policy — it "
                "needs per-chunk drift detectors, so drive it through "
                "repro_torch.stream.StreamingRun; this batch runner syncs on "
                "the rounds cadence")
        dev = resolve_device(device)
        if checkpoint is not None and \
                not isinstance(checkpoint, CheckpointConfig):
            raise ValueError("checkpoint must be a CheckpointConfig")
        init = self._init(generator, init_params, dev)
        if self.reduce_cfg.elastic is not None:
            return self._run_elastic(partitions, dev, round_hook, init=init,
                                     checkpoint=checkpoint)
        return self._run(partitions, dev, init, round_hook=round_hook,
                         checkpoint=checkpoint)

    def resume(self, partitions: Sequence[Partition], ckpt_dir: str, *,
               generator: Optional[torch.Generator] = None,
               init_params=None, device="cuda",
               round_hook: Optional[Callable] = None, every: int = 1):
        """Continue a checkpointed run from ``ckpt_dir``, bit for bit as the
        uninterrupted run. Pass the same partitions the original run got
        (the checkpoint's fingerprint refuses others) and, for a sequential
        run with members still to train, its ``generator`` or
        ``init_params``; the stacked and elastic layouts restart from the
        saved post-sync params and ignore them. A finished run's final
        checkpoint rebuilds the result without recomputation; otherwise the
        remaining rounds (stacked, elastic) or members (sequential) run,
        checkpointing into the same directory every ``every`` rounds (pass
        the original cadence), and ``rounds`` lists only those."""
        dev = resolve_device(device)
        m, rc = self.map_cfg, self.reduce_cfg
        if rc.elastic is not None:
            return self._resume_elastic(partitions, ckpt_dir, dev,
                                        round_hook, every)
        expected = self._fingerprint(partitions)
        # the newest readable round: a torn round-<r>.npz never completed,
        # and the re-run of that round overwrites it
        latest = run_state.latest_ready_round(ckpt_dir)
        if latest is not None:
            state = run_state.restore_round(ckpt_dir, latest, dev)
            run_state.check_fingerprint(state.meta, expected)
            if state.final:
                # the run completed: its checkpoint is the result. A hook
                # sees the restored final round; earlier rounds stay silent
                records: List[RoundRecord] = []
                if round_hook is not None:
                    per_round = m.epochs // rc.rounds
                    records.append(RoundRecord(
                        state.round, state.round * per_round,
                        (state.round + 1) * per_round if m.epochs else 0,
                        0.0, {name: 0 for name in kernels.LAUNCHES},
                        round_hook(state.round, state.averaged)))
                return RunResult(self.cfg, state.members.unstack(),
                                 state.averaged, state.members, state.stats,
                                 0.0, m.backend, dev, records, resumed=True)
            return self._run(
                partitions, dev, state.resume_params, round_hook=round_hook,
                checkpoint=CheckpointConfig(dir=ckpt_dir, every=every),
                start_round=state.round + 1, resumed=True)
        if m.backend == "sequential":
            done = {}
            for i in run_state.completed_members(ckpt_dir):
                model, stats, meta = run_state.restore_member(ckpt_dir, i,
                                                              dev)
                run_state.check_fingerprint(meta, expected)
                done[i] = (model, stats)
            if done:
                return self._run(
                    partitions, dev,
                    self._init(generator, init_params, dev),
                    round_hook=round_hook,
                    checkpoint=CheckpointConfig(dir=ckpt_dir, every=every),
                    completed=done, resumed=True)
        raise FileNotFoundError(f"no resumable checkpoint in {ckpt_dir}")

    def _init(self, generator, init_params, dev):
        if init_params is not None:
            return init_params
        if generator is None:
            raise ValueError("pass generator= (a seeded torch.Generator) "
                             "or init_params=")
        return cnn.init_params(self.cfg, generator, dev)

    def _fingerprint(self, partitions) -> dict:
        m, rc = self.map_cfg, self.reduce_cfg
        return run_state.run_fingerprint(
            m.backend, partitions, seed=m.seed, epochs=m.epochs,
            rounds=rc.rounds, batch_size=m.batch_size)

    def _run(self, partitions: Sequence[Partition], dev, init_params, *,
             round_hook: Optional[Callable] = None,
             checkpoint: Optional[CheckpointConfig] = None,
             start_round: int = 0, completed: Optional[dict] = None,
             resumed: bool = False) -> RunResult:
        m, rc = self.map_cfg, self.reduce_cfg
        executor = make_executor(m.backend, mesh=m.mesh)
        if rc.rounds > 1 and not executor.supports_rounds:
            raise ValueError("rounds > 1 requires MapConfig(backend="
                             "'stacked') or 'mesh' — the sequential "
                             "reference has no sync point between members")
        strat = rc.strategy_obj
        weights = weight_fn = None
        if strat.requires_validation:
            # weights from the trained members, resolved per round
            k, rows = len(partitions), tuple(len(p.x) for p in partitions)

            def weight_fn(r, snapshot, val_errors):
                return strat.weights(ReduceContext(
                    num_members=k, rows=rows, round=r,
                    val_errors=val_errors))
        else:
            weights = rc.resolve_weights(partitions)
        records: List[RoundRecord] = []
        per_round = m.epochs // rc.rounds
        t0 = time.perf_counter()
        clock = _RoundClock(dev)

        def on_round(r: int, snapshot, averaged):
            hooked = None if round_hook is None else round_hook(r, averaged())
            wall, launches = clock.tick()
            records.append(RoundRecord(
                r, r * per_round, (r + 1) * per_round if m.epochs else 0,
                wall, launches, hooked))

        plan = ExecutionPlan(
            epochs=m.epochs, lr_schedule=m.lr_schedule,
            batch_size=m.batch_size, seed=m.seed,
            chunk_batches=m.chunk_batches, rounds=rc.rounds,
            reduce_weights=weights, on_round=on_round, weight_fn=weight_fn,
            validation=(None if rc.validation is None
                        else (rc.validation.x, rc.validation.y)),
            gossip_rounds=(strat.rounds if strat.combine == "gossip"
                           else None),
            device=dev, checkpoint=checkpoint, start_round=start_round,
            completed=completed)
        out = executor.execute(self.cfg, init_params, partitions, plan)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        return RunResult(self.cfg, out.members, out.averaged, out.stacked,
                         out.stats, time.perf_counter() - t0, m.backend, dev,
                         records, out.round_syncs, resumed=resumed)

    def _resume_elastic(self, partitions, ckpt_dir: str, dev, round_hook,
                        every: int) -> ElasticRunResult:
        """Continue a checkpointed elastic run, bit for bit as the
        uninterrupted one. The checkpoint holds the whole post-boundary
        ``ElasticGroup`` and the membership maps; joiners' partitions are
        not saved but found again by replaying the caller's
        ``ElasticSchedule``."""
        expected = {**self._fingerprint(partitions), "mode": "elastic"}
        latest = run_state.latest_ready_elastic_round(ckpt_dir)
        if latest is None:
            raise FileNotFoundError(
                f"no resumable elastic checkpoint in {ckpt_dir}")
        state = run_state.restore_elastic_round(ckpt_dir, latest, dev)
        run_state.check_fingerprint(state.meta, expected)
        if state.final:
            # finished before the kill: the group is the result
            group = state.group
            boundary_model = CNNELMModel(*group.reduce_params())
            members = {n: CNNELMModel(*group.members[n].params)
                       for n in state.living}
            records: List[ElasticRoundRecord] = []
            if round_hook is not None:
                records.append(ElasticRoundRecord(
                    state.round, state.living, [], [], 0.0,
                    {name: 0 for name in kernels.LAUNCHES},
                    round_hook(state.round, boundary_model)))
            return ElasticRunResult(self.cfg, members, boundary_model, group,
                                    records, 0.0, self.map_cfg.backend, dev,
                                    resumed=True)
        return self._run_elastic(
            partitions, dev, round_hook,
            checkpoint=CheckpointConfig(dir=ckpt_dir, every=every),
            restored=state, resumed=True)

    def _run_elastic(self, partitions: Sequence[Partition], dev,
                     round_hook: Optional[Callable], *, init=None,
                     checkpoint: Optional[CheckpointConfig] = None,
                     restored: Optional[run_state.ElasticRoundState] = None,
                     resumed: bool = False) -> ElasticRunResult:
        """The rounds contract under membership churn: each round is one
        executor block over the current members, and every boundary an
        ``ElasticGroup`` event — record each member's block output with its
        round weight, retire the leavers, ``sync()`` everyone to the
        boundary average, admit the joiners from exactly that average.
        Member ``m<id>`` draws from ``default_rng(MapConfig.seed + id)``,
        fast-forwarded by the epochs it has consumed, and every block sees
        the global epoch's learning rate: a member's data order and rates
        are the same whoever else churned."""
        m, rc = self.map_cfg, self.reduce_cfg
        sched = rc.elastic
        if m.epochs <= 0:
            raise ValueError("elastic membership needs SGD epochs "
                             "(epochs > 0) to split into rounds")
        if m.epochs % rc.rounds:
            raise ValueError(f"epochs ({m.epochs}) must split evenly into "
                             f"rounds ({rc.rounds})")
        per_round = m.epochs // rc.rounds
        # on the mesh each round block re-pads to the current k: joiners
        # and leavers change only k_pad and the weight vector
        executor = make_executor(m.backend, mesh=m.mesh)
        t0 = time.perf_counter()
        strat = rc.strategy_obj

        def block_weights(names, outcome) -> List[float]:
            """Each member's weight for this round block — the increment of
            its cumulative ``ElasticGroup`` mass."""
            rows = tuple(len(living[n].x) for n in names)
            if strat.requires_validation:
                errs = 1.0 - Ensemble.from_models(
                    self.cfg, outcome.members, device=dev).evaluate(
                        rc.validation.x, rc.validation.y)
                return strat.weights(ReduceContext(
                    num_members=len(names), rows=rows,
                    val_errors=lambda: np.asarray(errs, np.float64)))
            w = strat.weights(ReduceContext(num_members=len(names),
                                            rows=rows))
            return [1.0] * len(names) if w is None else list(w)

        # id -> partition, the schedule replayed in boundary order: ids go
        # by join order, so the replay gives every joiner the id it had in
        # the original run (how a resume finds joiners' partitions)
        parts_by_id: Dict[int, Partition] = dict(enumerate(partitions))
        nid = len(partitions)
        for b in range(rc.rounds - 1):
            for p_new in sched.at(b)[0]:
                parts_by_id[nid] = p_new
                nid += 1
        ck = checkpoint
        ck_meta = {**self._fingerprint(partitions), "mode": "elastic"}
        if restored is None:
            cur_init = tree_map(lambda a: a.to(dev, torch.float32), init)
            group = elastic.ElasticGroup()
            living: Dict[str, Partition] = {}
            joined_round: Dict[str, int] = {}
            member_id: Dict[str, int] = {}
            beta0 = torch.zeros((cnn.feature_dim(self.cfg),
                                 self.cfg.num_classes), device=dev)
            for i, p in enumerate(partitions):
                name = f"m{i}"
                group.join(name, init_params=(cur_init, beta0))
                living[name], joined_round[name], member_id[name] = p, 0, i
            next_id = len(partitions)
            start_round = 0
        else:
            group = restored.group
            joined_round = dict(restored.joined_round)
            member_id = dict(restored.member_id)
            living = {n: parts_by_id[member_id[n]] for n in restored.living}
            next_id = restored.next_id
            cur_init = restored.cur_init
            start_round = restored.round + 1
        last_stats: Dict[str, elm.ELMStats] = {}
        records: List[ElasticRoundRecord] = []
        clock = _RoundClock(dev)
        for r in range(start_round, rc.rounds):
            names = sorted(living, key=member_id.get)      # join order
            plan = ExecutionPlan(
                epochs=per_round,
                lr_schedule=(lambda e, off=r * per_round:
                             m.lr_schedule(off + e)),
                batch_size=m.batch_size, seed=m.seed,
                chunk_batches=m.chunk_batches, rounds=1, device=dev,
                member_seeds=[m.seed + member_id[n] for n in names],
                start_epochs=[(r - joined_round[n]) * per_round
                              for n in names])
            outcome = executor.execute(self.cfg, cur_init,
                                       [living[n] for n in names], plan)
            bw = block_weights(names, outcome)
            for i, n in enumerate(names):
                model = outcome.members[i]
                group.record_step(n, (model.cnn_params, model.beta),
                                  n=bw[i])
                last_stats[n] = elm.ELMStats(
                    outcome.stats.u[i], outcome.stats.v[i],
                    outcome.stats.n[i])
            joined_names: List[str] = []
            left_names: List[str] = []
            last = r == rc.rounds - 1
            if not last:
                joins, leaves = sched.at(r)
                for n in dict.fromkeys(leaves):            # dedup, in order
                    if n not in living:
                        raise ValueError(
                            f"elastic leave {n!r} at boundary {r} is not a "
                            f"living member (living: {sorted(living)})")
                    group.record_stats(n, last_stats.pop(n))
                    group.leave(n)
                    del living[n]
                    left_names.append(n)
                if not living:
                    raise ValueError(
                        f"the leaves at boundary {r} would empty the group")
                # the boundary sync: every survivor restarts from the
                # group average (leavers' contributions retired in)
                avg = group.sync()
                boundary_model = CNNELMModel(*avg)
                for p_new in joins:
                    n = f"m{next_id}"
                    group.join(n, init_params=avg)
                    living[n], joined_round[n] = p_new, r + 1
                    member_id[n] = next_id
                    next_id += 1
                    joined_names.append(n)
                cur_init = avg[0]
            else:
                for n in names:
                    group.record_stats(n, last_stats[n])
                boundary_model = CNNELMModel(*group.reduce_params())
            if ck is not None and (last or (r + 1) % ck.every == 0):
                # the post-boundary state: exactly what round r+1 starts
                # from
                path = executor.commit(
                    lambda: run_state.save_elastic_round(
                        ck.dir, r, group=group, cur_init=cur_init,
                        joined_round=joined_round, member_id=member_id,
                        next_id=next_id,
                        meta={**ck_meta, "round": r, "final": last}),
                    checkpoint_path(ck.dir, run_state.ELASTIC, r))
                if ck.after_save is not None:
                    ck.after_save("round", r, path)
            hooked = (round_hook(r, boundary_model)
                      if round_hook is not None else None)
            wall, launches = clock.tick()
            records.append(ElasticRoundRecord(
                r, names, joined_names, left_names, wall, launches, hooked))
        members = {n: CNNELMModel(*group.members[n].params)
                   for n in sorted(living, key=member_id.get)}
        return ElasticRunResult(self.cfg, members, boundary_model, group,
                                records, time.perf_counter() - t0,
                                m.backend, dev, resumed=resumed)


# ---------------------------------------------------------------------------
# Batched ensemble scoring
# ---------------------------------------------------------------------------

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
