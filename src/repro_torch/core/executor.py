"""The Map-phase execution layer — how Algorithm 2's k members run. The
port's counterpart of ``repro.core.executor``.

``core.cnn_elm`` owns the math; this module owns the orchestration: the
epoch/round loop, host→device staging of the epochs, inter-round syncs and
the Reduce.

* ``SequentialExecutor`` (``backend="sequential"``) — the faithful
  reference: one ``cnn_elm.member_epochs`` loop per member, one batch of
  one member per kernel launch. No sync point between members, so no
  ``rounds > 1`` and no gossip.
* ``StackedExecutor`` (``backend="stacked"``) — all k members on a leading
  member dim: each batch index is one member-batched launch per kernel.
  Unequal shards pad to the longest member's batch count with a per-batch
  validity mask (``data.partition.padded_stacked_epoch_batches``).
  ``rounds = r > 1`` splits the epochs into r blocks with an average +
  broadcast sync (or, under the gossip combine, a ring-mixing sync) after
  each block but the last. An epoch reaches the device in one copy, or,
  with ``chunk_batches``, in chunks staged in pinned host memory and
  copied on a side stream one chunk ahead of the one being computed.

* ``MeshExecutor`` (``backend="mesh"``) — the scale-out: one rank per
  device (``torch.distributed``, SPMD: every rank runs the same
  ``execute``), the members laid over the ranks of a member mesh
  (``launch.mesh.make_member_mesh``; ``distributed.sharding``). Each rank
  builds, stages and trains only its own members, from their own streams,
  with the stacked epoch on its slice and no collective inside an epoch;
  solves its own members' β; and every Reduce and every ``rounds`` sync is
  ONE all-reduce of one flat f32 vector on the flat ``('pod',)`` mesh, TWO
  (within a host, then across hosts) on the ``('host', 'pod')`` mesh, and
  ``2·T`` ring exchanges with no all-reduce under gossip. The members
  leave their ranks only when read: one all-gather of their flat rows.
  Collectives go through ``distributed.collectives``, which counts them
  per span (``"epoch"``, ``"sync"``, ``"reduce"``, ``"gather"``,
  ``"weights"``, ``"e2lm"``).

All hand back a ``MapOutcome`` whose β solves and averaged model run
only when read, and resolve the Reduce weights lazily per round: the static
``plan.reduce_weights``, or ``plan.weight_fn`` over the round's trained
members, whose ``val_errors()`` scores the held-out ``plan.validation``
with the member-batched scoring pass (argmax on the device, the error
rates on the host in f64).

Fault tolerance (``plan.checkpoint``, ``checkpoint.run_state``): the
stacked backend saves per round, with the post-sync params on non-final
rounds, and resumes at ``plan.start_round`` from them; the sequential
backend saves per member and skips the ``plan.completed`` ones; on the
mesh rank 0 writes each checkpoint, every rank waits until it is on disk,
and every rank restores it. Each member stream is ``default_rng(member
seed)`` fast-forwarded by the epochs already consumed, so a continuation
draws the batch orders the uninterrupted run drew.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, List, Optional, Sequence, Union

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import resolve_device
from repro_torch.checkpoint import run_state
from repro_torch.checkpoint.ckpt import checkpoint_path
from repro_torch.core import elm
from repro_torch.core import averaging
from repro_torch.core.averaging import (_GOSSIP_EPS, _unraveler,
                                        average_member_dim,
                                        broadcast_member_dim,
                                        gossip_member_dim, gossip_ring_mix,
                                        psum_weighted_mean_members, ravel)
from repro_torch.core.e2lm import psum_stats, reduce_stats
from repro_torch.core.cnn_elm import (CNNELMModel, StackedMembers,
                                      average_models, member_epochs,
                                      scores_stacked, stack_models,
                                      stacked_epoch_pass)
from repro_torch.data.partition import (Partition, chunk_scan_major,
                                        padded_stacked_epoch_batches)
from repro_torch.data.synthetic import one_hot
from repro_torch.distributed import collectives, sharding
from repro_torch.models import cnn
from repro_torch.tree import tree_leaves, tree_map

BACKENDS = ("sequential", "stacked", "mesh")
_VAL_BATCH = 512       # validation slices score in bounded device batches


@dataclass(frozen=True)
class CheckpointConfig:
    """Per-round checkpoint policy (``checkpoint.run_state`` files).

    ``dir`` — where the atomic ``round-<r>.npz`` (and, on the sequential
    backend, ``member-<i>.npz``) files land. ``every`` — save round r when
    ``(r + 1) % every == 0``; the final round always saves. ``after_save``
    — a hook ``(unit, index, path)`` called the moment a checkpoint is
    renamed into place (``unit`` is ``"round"`` or ``"member"``);
    ``core.faults`` raises from it to stand in for a preemption."""
    dir: str
    every: int = 1
    after_save: Optional[Callable] = None

    def __post_init__(self):
        if self.every < 1:
            raise ValueError(f"every must be >= 1, got {self.every}")


@dataclass(frozen=True)
class ExecutionPlan:
    """Everything one Map/Reduce execution needs.

    ``epochs``/``lr_schedule`` (rate of global epoch e), ``batch_size``,
    the member seed rule (member i's stream = ``default_rng(seed + i)``),
    ``chunk_batches`` (stacked: stage each epoch in chunks of that many
    batch indices), ``rounds`` (stacked: averaging events),
    ``reduce_weights`` (static Reduce weights, None = uniform) or
    ``weight_fn(r, snapshot, val_errors)`` (weights from round r's trained
    members; ``validation`` is the (x, y) slice ``val_errors()`` scores),
    ``gossip_rounds`` (the ring-mixing combine in every sync and Reduce),
    and the device — the card unless the caller asks for ``"cpu"``.

    Fault tolerance: ``checkpoint`` turns on per-round (stacked) or
    per-member (sequential) saves; ``start_round`` resumes a stacked run
    at that round (``init_params`` are then the restored post-sync params,
    and the skipped rounds' permutation draws are burned); ``completed``
    hands the sequential backend trained members ``{i: (model, stats)}``
    to skip. ``member_seeds`` replaces the ``seed + i`` rule,
    ``start_epochs`` fast-forwards each member's stream by that many
    permutation draws (the elastic runner's stream continuation), and
    ``member_init`` gives each member its own initial params (a k-list of
    trees) in place of the shared ``init_params``.

    ``on_round(r, snapshot, averaged)`` fires after each round's epochs and
    its sync with two lazy, cached zero-arg closures: ``snapshot()`` → the
    round's pre-sync ``StackedMembers`` (β solved on first call),
    ``averaged()`` → the round's averaged ``CNNELMModel``."""
    epochs: int = 0
    lr_schedule: Optional[Callable[[int], float]] = None
    batch_size: int = 32
    seed: int = 1000
    chunk_batches: Optional[int] = None
    rounds: int = 1
    reduce_weights: Optional[Sequence[float]] = None
    on_round: Optional[Callable] = None
    weight_fn: Optional[Callable] = None
    validation: Optional[tuple] = None      # (x, y) held-out slice
    gossip_rounds: Optional[int] = None
    device: Union[str, torch.device] = "cuda"
    checkpoint: Optional[CheckpointConfig] = None
    start_round: int = 0
    completed: Optional[dict] = None
    member_seeds: Optional[Sequence[int]] = None
    start_epochs: Optional[Sequence[int]] = None
    member_init: Optional[Sequence] = None


class MapOutcome:
    """What an executor hands back: every member's trained CNN params, every
    member's final-epoch ``ELMStats`` (member-stacked) β is solved from,
    and the number of inter-round syncs run. The members' β (``stacked``,
    ``members``) and the final round's ``averaged`` model are solved on
    first read and kept: a caller that reads only ``member_params`` and
    ``stats`` — the streaming Map, which solves β from its windows — runs
    no solve and no average. ``member_params`` and ``stats`` may be given
    as zero-arg callables, called on first read (the mesh gathers them).

    On the mesh a first read is a collective: every rank reads the same
    fields in the same order."""

    def __init__(self, member_params, stats,
                 snapshot: Callable[[], StackedMembers],
                 averaged: Callable[[], CNNELMModel], round_syncs: int = 0):
        self._params, self._stats = member_params, stats
        self.round_syncs = round_syncs
        self._snapshot, self._averaged = snapshot, averaged

    @property
    def member_params(self) -> List[dict]:
        if callable(self._params):
            self._params = self._params()
        return self._params

    @property
    def stats(self) -> elm.ELMStats:
        if callable(self._stats):
            self._stats = self._stats()
        return self._stats

    @property
    def stacked(self) -> StackedMembers:
        return self._snapshot()

    @property
    def members(self) -> List[CNNELMModel]:
        return self.stacked.unstack()

    @property
    def averaged(self) -> CNNELMModel:
        return self._averaged()


def _on_device(init_params, plan: ExecutionPlan):
    """(the plan's device, ``init_params`` as f32 on it)."""
    dev = resolve_device(plan.device)
    return dev, tree_map(lambda a: a.to(dev, torch.float32), init_params)


def _member_seeds(plan: ExecutionPlan, k: int) -> List[int]:
    if plan.member_seeds is None:
        return [plan.seed + i for i in range(k)]
    seeds = list(plan.member_seeds)
    if len(seeds) != k:
        raise ValueError(f"{len(seeds)} member_seeds for {k} partitions")
    return seeds


def _member_inits(plan: ExecutionPlan, k: int) -> Optional[List]:
    """Validated per-member init trees, or None for the shared init."""
    if plan.member_init is None:
        return None
    inits = list(plan.member_init)
    if len(inits) != k:
        raise ValueError(f"{len(inits)} member_init trees for "
                         f"{k} partitions")
    return inits


def _stream_burns(plan: ExecutionPlan, k: int, per_round: int) -> List[int]:
    """Permutation draws to fast-forward each member stream by before its
    first epoch: the explicit per-member ``start_epochs`` (elastic
    continuation), else the skipped ``start_round`` rounds (resume)."""
    if plan.start_epochs is None:
        return [plan.start_round * per_round] * k
    burns = list(plan.start_epochs)
    if len(burns) != k:
        raise ValueError(f"{len(burns)} start_epochs for {k} partitions")
    return burns


def _member_streams(plan: ExecutionPlan, partitions, per_round: int,
                    members: Optional[Sequence[int]] = None):
    """One live ``default_rng`` per member (of ``members``, default all),
    each fast-forwarded by the permutations its earlier epochs drew (one
    per epoch)."""
    k = len(partitions)
    seeds, burns = _member_seeds(plan, k), _stream_burns(plan, k, per_round)
    rngs = []
    for i in (range(k) if members is None else members):
        rng = np.random.default_rng(seeds[i])
        for _ in range(burns[i]):
            rng.permutation(len(partitions[i].x))
        rngs.append(rng)
    return rngs


def _fingerprint(name: str, partitions, plan: ExecutionPlan) -> dict:
    return run_state.run_fingerprint(
        name, partitions, seed=plan.seed, epochs=plan.epochs,
        rounds=plan.rounds, batch_size=plan.batch_size)


def make_executor(backend: str, mesh=None):
    """Executor registry: ``backend`` ∈ ``BACKENDS``. ``mesh`` is the member
    mesh of ``"mesh"`` (None: the flat mesh over the initialised group's
    ranks); the other backends take none."""
    if mesh is not None and backend != "mesh":
        raise ValueError(f"a member mesh is read by backend 'mesh' only, "
                         f"got backend {backend!r}")
    if backend == "sequential":
        return SequentialExecutor()
    if backend == "stacked":
        return StackedExecutor()
    if backend == "mesh":
        return MeshExecutor(mesh)
    raise ValueError(f"backend must be one of {BACKENDS}, got {backend!r}")


def val_error_rates(cfg, members: StackedMembers, validation) -> np.ndarray:
    """(k,) misclassification rates of every member on the held-out
    ``validation = (x, y)``: member-batched scoring passes of ``_VAL_BATCH``
    images, argmax on the device, the means on the host in f64."""
    xv, yv = validation
    dev = members.beta.device
    preds = []
    with torch.no_grad():
        for i in range(0, len(xv), _VAL_BATCH):
            x = torch.from_numpy(np.asarray(xv[i:i + _VAL_BATCH],
                                            np.float32)).to(dev)
            preds.append(scores_stacked(cfg, members.cnn_params, members.beta,
                                        x).argmax(-1).cpu().numpy())
    return np.asarray(np.concatenate(preds, axis=1) != np.asarray(yv)[None],
                      np.float64).mean(axis=1)


def _round_closures(cfg, plan: ExecutionPlan, r: int, snapshot, reduce,
                    score=None):
    """Lazy, cached ``averaged`` and ``weights`` over round r's
    ``snapshot``: ``weights()`` is the static ``plan.reduce_weights`` or
    ``plan.weight_fn``'s answer (scoring ``plan.validation`` at most once,
    by ``score()`` where given, else over the whole snapshot),
    ``averaged()`` is ``reduce(weights())``."""
    cache: dict = {}

    def val_errors():
        if "err" not in cache:
            if plan.validation is None:
                raise ValueError(
                    "per-member validation errors need a held-out slice — "
                    "set plan.validation (the runner wires "
                    "ReduceConfig.validation through)")
            cache["err"] = (score() if score is not None else
                            val_error_rates(cfg, snapshot(), plan.validation))
        return cache["err"]

    def weights():
        if "w" not in cache:
            cache["w"] = (plan.weight_fn(r, snapshot, val_errors)
                          if plan.weight_fn is not None
                          else plan.reduce_weights)
        return cache["w"]

    def averaged():
        if "avg" not in cache:
            cache["avg"] = reduce(weights())
        return cache["avg"]

    return averaged, weights


class _Executor:
    supports_rounds = True

    def commit(self, write: Callable[[], str], path: str) -> str:
        """Write a checkpoint (``write()`` saves it and returns its path,
        ``path``): here the one process writes it."""
        return write()


class SequentialExecutor(_Executor):
    """One ``cnn_elm.member_epochs`` loop per member — the Algorithm 2
    reference every fast path is held against; each member's β is solved
    by itself (``elm.solve_beta`` of its own stats), when first read or
    when its checkpoint is saved."""

    name = "sequential"
    supports_rounds = False

    def execute(self, cfg, init_params, partitions: Sequence[Partition],
                plan: ExecutionPlan) -> MapOutcome:
        if plan.rounds > 1:
            raise ValueError(
                "rounds > 1 needs the stacked layout — the sequential "
                "reference has no sync point between members")
        if plan.start_round:
            raise ValueError(
                "start_round resume is the stacked layout's contract; the "
                "sequential backend resumes from plan.completed member "
                "checkpoints")
        if plan.gossip_rounds is not None:
            raise ValueError(
                "the gossip combine mixes a member ring — the sequential "
                "reference has no stacked member dim to mix over; use "
                "backend='stacked'")
        dev, init_params = _on_device(init_params, plan)
        k = len(partitions)
        rngs = _member_streams(plan, partitions, 0)
        inits = _member_inits(plan, k)
        ck = plan.checkpoint
        done = dict(plan.completed or {})
        meta = _fingerprint(self.name, partitions, plan)
        params, stats, betas = [], [], {}
        for i, p in enumerate(partitions):
            if i in done:
                model, s = done[i]
                q, betas[i] = model.cnn_params, model.beta
            else:
                init = (init_params if inits is None
                        else _on_device(inits[i], plan)[1])
                q, s = member_epochs(
                    cfg, init, p, epochs=plan.epochs,
                    lr_schedule=plan.lr_schedule, batch_size=plan.batch_size,
                    seed=rngs[i])
                if ck is not None:
                    betas[i] = elm.solve_beta(s, cfg.elm_lambda)
                    path = run_state.save_member(
                        ck.dir, i, CNNELMModel(q, betas[i]), s,
                        {**meta, "member": i})
                    if ck.after_save is not None:
                        ck.after_save("member", i, path)
            params.append(q)
            stats.append(s)
        stats_k = run_state.stack_stats(stats)
        cache: dict = {}

        def snapshot():
            if "sm" not in cache:
                for i, s in enumerate(stats):
                    if i not in betas:
                        betas[i] = elm.solve_beta(s, cfg.elm_lambda)
                cache["sm"] = stack_models([CNNELMModel(q, betas[i])
                                            for i, q in enumerate(params)])
            return cache["sm"]

        averaged, _ = _round_closures(
            cfg, plan, 0, snapshot,
            lambda w: average_models(snapshot().unstack(), w))
        if ck is not None:
            path = run_state.save_round(
                ck.dir, 0, members=snapshot(), stats=stats_k,
                averaged=averaged(),
                meta={**meta, "round": 0, "epochs_done": plan.epochs,
                      "final": True})
            if ck.after_save is not None:
                ck.after_save("round", 0, path)
        if plan.on_round is not None:
            plan.on_round(0, snapshot, averaged)
        return MapOutcome(params, stats_k, snapshot, averaged)


class StackedExecutor(_Executor):
    """All k members stacked on a leading member dim: per batch index, one
    member-batched conv launch per stage and one elm_stats launch (and,
    with SGD, the conv's backward launches), the β solves batched over the
    members; rounds of epochs between syncs."""

    name = "stacked"

    def execute(self, cfg, init_params, partitions: Sequence[Partition],
                plan: ExecutionPlan) -> MapOutcome:
        if plan.chunk_batches is not None and plan.chunk_batches < 1:
            raise ValueError(
                f"chunk_batches must be >= 1, got {plan.chunk_batches}")
        if plan.rounds < 1:
            raise ValueError(f"rounds must be >= 1, got {plan.rounds}")
        if plan.rounds > 1 and plan.epochs == 0:
            raise ValueError(
                "rounds > 1 needs SGD epochs to interleave with averaging; "
                "epochs=0 is the single closed-form pass")
        if plan.rounds > 1 and plan.epochs % plan.rounds:
            raise ValueError(f"epochs ({plan.epochs}) must split evenly "
                             f"into rounds ({plan.rounds})")
        if plan.gossip_rounds is not None and plan.gossip_rounds < 1:
            raise ValueError(f"gossip_rounds must be >= 1, "
                             f"got {plan.gossip_rounds}")
        if plan.gossip_rounds is not None and plan.checkpoint is not None:
            raise ValueError(
                "gossip syncs leave each member on its OWN consensus "
                "iterate; the per-round checkpoint/resume contract assumes "
                "one shared post-sync row — run gossip without "
                "checkpointing")
        if plan.epochs > 0 and plan.lr_schedule is None:
            raise ValueError("epochs > 0 needs an lr_schedule")
        if plan.start_round and not 0 < plan.start_round < plan.rounds:
            raise ValueError(
                f"start_round {plan.start_round} outside this plan's "
                f"resumable rounds (1..{plan.rounds - 1}); a finished run "
                f"resumes from its final checkpoint, not through execute")
        if plan.completed:
            raise ValueError("plan.completed is the sequential backend's "
                             "resume contract; the stacked layout resumes "
                             "via start_round")
        k = len(partitions)
        dev, init_params = _on_device(init_params, plan)
        self._begin(cfg, k, plan, dev)
        mine = self._local(k)               # the members this process trains
        per_round = plan.epochs // plan.rounds
        # one live stream per member: each epoch draws its next permutation
        rngs = _member_streams(plan, partitions, per_round, mine)
        inits = _member_inits(plan, k)
        params_k = (broadcast_member_dim(init_params, len(mine))
                    if inits is None else
                    tree_map(lambda *xs: torch.stack(xs),
                             *[_on_device(inits[i], plan)[1] for i in mine]))
        local = [partitions[i] for i in mine]
        round_rates = [[None]] if plan.epochs == 0 else [
            [float(plan.lr_schedule(r * per_round + e))
             for e in range(per_round)] for r in range(plan.rounds)]
        ck = plan.checkpoint
        meta = _fingerprint(self.name, partitions, plan)
        syncs = 0
        for r, rates in enumerate(round_rates):
            if r < plan.start_round:
                continue        # done before the resume point; its draws
                                # were burned above
            for lr in rates:
                params_k, stats_k = self._epoch(cfg, params_k, local, plan,
                                                rngs, dev, lr)
            snapshot, stats, averaged, weights = self._closures(
                cfg, plan, r, params_k, stats_k, dev)
            last = r == len(round_rates) - 1
            if not last:
                params_k = self._sync(params_k, weights(), plan.gossip_rounds)
                syncs += 1
            if ck is not None and (last or (r + 1) % ck.every == 0):
                # the sync broadcast one row into every member slot: row 0
                # of the post-sync params is the resume point
                saved = (snapshot(), stats(), averaged())
                path = self.commit(lambda: run_state.save_round(
                    ck.dir, r, members=saved[0], stats=saved[1],
                    averaged=saved[2],
                    resume_params=(None if last else
                                   tree_map(lambda a: a[0], params_k)),
                    meta={**meta, "round": r,
                          "epochs_done": (r + 1) * per_round,
                          "final": last}),
                    checkpoint_path(ck.dir, run_state.ROUND, r))
                if ck.after_save is not None:
                    ck.after_save("round", r, path)
            if plan.on_round is not None:
                plan.on_round(r, snapshot, averaged)
        return self._outcome(params_k, stats_k, snapshot, stats, averaged,
                             syncs)

    def _begin(self, cfg, k: int, plan: ExecutionPlan, dev):
        """Per-run set-up (the mesh's layout and checks)."""

    def _local(self, k: int) -> Sequence[int]:
        """The global indices of the members this process trains."""
        return range(k)

    def _outcome(self, params_k, stats_k, snapshot, stats, averaged, syncs):
        return MapOutcome([tree_map(lambda a, i=i: a[i], params_k)
                           for i in range(stats_k.u.shape[0])], stats_k,
                          snapshot, averaged, syncs)

    def _epoch(self, cfg, params_k, partitions, plan, rngs, dev, lr):
        """One epoch of all members (``lr=None``: the epochs=0 pass). The
        host builds the epoch's padded batch-major arrays (each member's
        stream draws one permutation), stages them on the device whole or
        chunk by chunk, and the batch indices run in order; the β solves'
        factorisations are checked once, at the end."""
        k = len(partitions)
        F, C = cnn.feature_dim(cfg), cfg.num_classes
        nb = max(len(p.x) // plan.batch_size for p in partitions)
        chunk = nb
        if plan.chunk_batches is not None and plan.chunk_batches < nb:
            chunk = plan.chunk_batches
        xs, ys, mk = padded_stacked_epoch_batches(
            partitions, plan.batch_size, rngs,
            num_batches=-(-nb // chunk) * chunk)
        tb = one_hot(ys.reshape(-1), C).reshape(*ys.shape, C)
        arrays = tuple(np.swapaxes(a, 0, 1) for a in (xs, tb, mk))
        masked = bool(np.any(mk == 0.0))
        stats_k = elm.zero_stats_stacked(k, F, C, device=dev)
        infos = []
        for xb, tb_, mb in _staged(chunk_scan_major(arrays, chunk), dev):
            params_k, stats_k = stacked_epoch_pass(
                cfg, params_k, stats_k, xb, tb_, mb if masked else None,
                lr=lr, infos=infos)
        elm.check_factorisations(infos)
        return params_k, stats_k

    def _closures(self, cfg, plan, r, params_k, stats_k, dev):
        """Round r's lazy snapshot/stats/averaged/weights over its pre-sync
        state; the β solve is shared and runs only if asked for."""
        cache: dict = {}

        def snapshot():
            if "sm" not in cache:
                cache["sm"] = StackedMembers(
                    params_k, elm.solve_beta(stats_k, cfg.elm_lambda))
            return cache["sm"]

        def reduce(w):
            sm = snapshot()
            if plan.gossip_rounds is not None:
                avg_cnn, avg_beta = gossip_member_dim(
                    (sm.cnn_params, sm.beta), w, plan.gossip_rounds)[1]
            else:
                avg_cnn, avg_beta = average_member_dim(
                    (sm.cnn_params, sm.beta), weights=w)
            return CNNELMModel(avg_cnn, avg_beta)

        averaged, weights = _round_closures(cfg, plan, r, snapshot, reduce)
        return snapshot, lambda: stats_k, averaged, weights

    def _sync(self, params_k, weights, gossip_rounds):
        """The inter-round sync: every member reset to the (weighted)
        average, or, under gossip, to its own consensus iterate."""
        if gossip_rounds is not None:
            return gossip_member_dim(params_k, weights, gossip_rounds)[0]
        k = params_k["stages"][0]["w"].shape[0]
        return broadcast_member_dim(
            average_member_dim(params_k, weights=weights), k)


class MeshExecutor(StackedExecutor):
    """The scale-out Map: one rank per device, the members over the ranks
    of a member mesh (``launch.mesh.make_member_mesh``; ``None``: the flat
    mesh over every rank of the initialised group). Every rank calls
    ``execute`` with the same arguments.

    The mesh needs a ``'pod'`` axis; with a ``'host'`` axis as well, the
    members lie over ``('host', 'pod')`` jointly and every Reduce and sync
    stages: an all-reduce within each host (its pod group), then one
    across hosts (its host group). k members pad to a multiple of the
    ranks (``distributed.sharding``): rank s holds the members
    ``[s · k_local, (s + 1) · k_local)``, and the padding slots hold
    nothing — no data, no params, weight 0 — and appear only as zero rows
    of the gathers, which strip them.

    Per round: the epochs on this rank's members with no collective
    (``stacked_epoch_pass`` on the slice, its kernel launches the stacked
    path's when one rank holds every member); then the sync or, when the
    round's average is read, the Reduce: ONE all-reduce flat, TWO
    hierarchical, ``2·T`` ring exchanges and no all-reduce under gossip.
    β is solved per member on the member's rank. The snapshot (members,
    β and stats) leaves the ranks only when read: one all-gather of the
    members' flat rows. Boosted weights score the held-out slice on each
    rank under its own members and all-gather the error rates (one
    all-gather a weight resolve). Checkpoints are written by rank 0, and
    every rank waits for the file."""

    name = "mesh"

    def __init__(self, mesh=None):
        self.mesh = mesh

    def _begin(self, cfg, k, plan, dev):
        if self.mesh is None:
            from repro_torch.launch.mesh import make_member_mesh
            self.mesh = make_member_mesh()
        axes = sharding.member_axes(self.mesh)     # refuses a mesh w/o 'pod'
        names = tuple(self.mesh.mesh_dim_names)
        world = dist.get_world_size()
        if self.mesh.mesh.flatten().tolist() != list(range(world)) or \
                set(names) != set(axes):
            raise ValueError(
                f"the member mesh must lay the group's {world} ranks out in "
                f"order over its member axes {axes} alone, got axes {names} "
                f"over ranks {self.mesh.mesh.tolist()}")
        if plan.member_init is not None:
            raise ValueError(
                "plan.member_init is not supported on backend 'mesh' — the "
                "mesh layout would re-pad and re-shard per-member trees "
                "mid-run; streaming blocks run on 'sequential' or "
                "'stacked'")
        if plan.gossip_rounds is not None and len(axes) > 1:
            raise ValueError(
                "gossip rides the flat 1-D 'pod' ring — the hierarchical "
                "('host', 'pod') mesh has no single ring axis; build the "
                "flat member mesh (make_member_mesh()) for gossip syncs")
        coord = self.mesh.get_coordinate()
        slot = 0
        for a in axes:                  # row-major over the member axes
            slot = slot * self.mesh.size(names.index(a)) + \
                coord[names.index(a)]
        slots = sharding.member_slots(self.mesh)
        self._cfg, self._k, self._dev = cfg, k, dev
        self._k_local = sharding.k_pad(k, slots) // slots
        self._mine = sharding.member_slice(k, slots, slot)
        # the Reduce's all-reduces, innermost level first; the ring; and
        # the group of every member rank (the whole group on a 2-D mesh)
        self._levels = [(self.mesh.get_group(a), a) for a in reversed(axes)]
        self._ring = (self.mesh.get_group("pod"), "pod")
        self._all = (self._ring if len(axes) == 1
                     else (None, "+".join(axes)))

    def _local(self, k):
        return self._mine

    def _epoch(self, cfg, params_k, partitions, plan, rngs, dev, lr):
        with collectives.span("epoch"):
            if not partitions:          # a rank of padding only
                return params_k, elm.zero_stats_stacked(
                    0, cnn.feature_dim(cfg), cfg.num_classes, device=dev)
            return super()._epoch(cfg, params_k, partitions, plan, rngs, dev,
                                  lr)

    def _local_weights(self, weights):
        """(this rank's slice of the weights, their global total): the
        member count k for the uniform mean (``weights=None``)."""
        if weights is None:
            return None, float(self._k)
        return [weights[i] for i in self._mine], float(sum(weights))

    def _mean(self, tree, weights):
        local, total = self._local_weights(weights)
        if len(self._levels) == 1:
            return psum_weighted_mean_members(tree, local, total,
                                              *self._levels[0])
        return averaging.hierarchical_psum_weighted_mean_members(
            tree, local, total, self._levels)

    def _gather(self, tree):
        """Every member's rows of ``tree`` (leaves of one dtype with this
        rank's members on the leading dim) on every rank: one all-gather of
        the flat rows, padding slots zero, then stripped; leaves (k, ...)."""
        leaves = tree_leaves(tree)
        n = len(self._mine)
        rows = torch.cat([a.reshape(n, math.prod(a.shape[1:]))
                          for a in leaves], dim=1)
        rows = collectives.all_gather(
            sharding.pad_rows(rows, self._k_local), *self._all)
        rows = rows.reshape(-1, rows.shape[-1])[:self._k]
        parts, o = [], 0
        for a in leaves:
            size = math.prod(a.shape[1:])
            parts.append(rows[:, o:o + size].reshape(
                (self._k,) + tuple(a.shape[1:])).to(a.dtype).contiguous())
            o += size
        it = iter(parts)
        return tree_map(lambda _: next(it), tree)

    def _closures(self, cfg, plan, r, params_k, stats_k, dev):
        cache: dict = {}
        F, C = cnn.feature_dim(cfg), cfg.num_classes

        def beta():                     # this rank's members' β
            if "beta" not in cache:
                cache["beta"] = (
                    elm.solve_beta(stats_k, cfg.elm_lambda) if self._mine
                    else torch.zeros((0, F, C), device=dev))
            return cache["beta"]

        def gathered():
            if "all" not in cache:
                with collectives.span("gather"):
                    cnn_k, beta_k, st = self._gather(
                        (params_k, beta(), tuple(stats_k)))
                cache["all"] = (StackedMembers(cnn_k, beta_k),
                                elm.ELMStats(*st))
            return cache["all"]

        def score():
            with collectives.span("weights"):
                err = (val_error_rates(cfg, StackedMembers(params_k, beta()),
                                       plan.validation) if self._mine
                       else np.zeros(0))
                got = self._gather(torch.from_numpy(
                    np.asarray(err, np.float64)).to(dev))
            return got.cpu().numpy()

        def reduce(w):
            tree = (params_k, beta())
            with collectives.span("reduce"):
                avg_cnn, avg_beta = (
                    self._mean(tree, w) if plan.gossip_rounds is None
                    else self._published(tree, w, plan.gossip_rounds))
            return CNNELMModel(avg_cnn, avg_beta)

        snapshot = lambda: gathered()[0]                    # noqa: E731
        averaged, weights = _round_closures(cfg, plan, r, snapshot, reduce,
                                            score)
        return snapshot, lambda: gathered()[1], averaged, weights

    def _published(self, tree, weights, rounds):
        """The gossip Reduce's published model: every node's (num, den)
        after the ring's mixing rounds, all-gathered, read as
        Σ num / Σ den — sums the mixing leaves unchanged."""
        flat, _ = ravel(gossip_ring_mix(tree, self._local_weights(weights)[0],
                                        rounds, *self._ring))
        nodes = collectives.all_gather(flat, *self._all)
        return _unraveler(tree, member_dim=True)(
            torch.sum(nodes[:, :-1], dim=0) / torch.sum(nodes[:, -1]))

    def _sync(self, params_k, weights, gossip_rounds):
        """Every local member reset to the (weighted) average — one
        all-reduce, or one per mesh level — or, under gossip, to this
        rank's own consensus estimate after the ring's mixing rounds."""
        n = len(self._mine)
        with collectives.span("sync"):
            if gossip_rounds is None:
                return broadcast_member_dim(self._mean(params_k, weights), n)
            num, den = gossip_ring_mix(params_k,
                                       self._local_weights(weights)[0],
                                       gossip_rounds, *self._ring)
            d = torch.clamp(den, min=_GOSSIP_EPS)
            est = tree_map(lambda s, a: (s / d).to(a.dtype), num, params_k)
            return broadcast_member_dim(est, n)

    def _outcome(self, params_k, stats_k, snapshot, stats, averaged, syncs):
        self._last_stats = stats_k      # for e2lm_global_beta
        k = self._k
        return MapOutcome(
            lambda: [tree_map(lambda a, i=i: a[i], snapshot().cnn_params)
                     for i in range(k)], stats, snapshot, averaged, syncs)

    def commit(self, write, path):
        """Rank 0 writes the checkpoint; every rank returns once it is on
        disk (one barrier), so every rank can restore it."""
        out = write() if dist.get_rank() == 0 else path
        collectives.barrier(self._dev, *self._all)
        return out

    def e2lm_global_beta(self):
        """After ``execute``: the E²LM global readout — this rank's
        members' final-epoch stats summed in member order, ONE
        ``e2lm.psum_stats`` all-reduce over every member rank, one solve:
        the β a no-partition ELM would produce, the same on every rank."""
        if not hasattr(self, "_last_stats"):
            raise RuntimeError("e2lm_global_beta needs a completed execute()"
                               " (the final round records the stats)")
        s = self._last_stats
        cfg = self._cfg
        with collectives.span("e2lm"):
            local = (reduce_stats([elm.ELMStats(s.u[i], s.v[i], s.n[i])
                                   for i in range(len(self._mine))])
                     if self._mine else
                     elm.zero_stats(cnn.feature_dim(cfg), cfg.num_classes,
                                    device=self._dev))
            total = psum_stats(local, *self._all)
        return elm.solve_beta(total, cfg.elm_lambda)


def _staged(chunks, dev):
    """Yield each chunk of host arrays as tensors on ``dev``. One chunk goes
    in one pageable copy. Several go through pinned host memory, each
    copied on a side stream while the chunk before it is computed; the
    compute stream waits for a chunk's copy before its first use."""
    if dev.type != "cuda" or len(chunks) == 1:
        for chunk in chunks:
            yield tuple(torch.from_numpy(np.ascontiguousarray(a)).to(dev)
                        for a in chunk)
        return
    side = torch.cuda.Stream(dev)
    compute = torch.cuda.current_stream(dev)

    def put(chunk):
        host = [torch.from_numpy(np.ascontiguousarray(a)).pin_memory()
                for a in chunk]
        with torch.cuda.stream(side):
            out = tuple(h.to(dev, non_blocking=True) for h in host)
        done = torch.cuda.Event()
        done.record(side)
        return out, done

    nxt = put(chunks[0])
    for i in range(len(chunks)):
        (cur, done), nxt = nxt, (put(chunks[i + 1]) if i + 1 < len(chunks)
                                 else None)
        compute.wait_event(done)
        for t in cur:
            t.record_stream(compute)
        yield cur
