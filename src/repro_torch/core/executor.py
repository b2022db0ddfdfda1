"""The Map-phase execution layer — how Algorithm 2's k members run. The
port's counterpart of ``repro.core.executor``.

``core.cnn_elm`` owns the math; this module owns the orchestration:

* ``SequentialExecutor`` (``backend="sequential"``) — the faithful
  reference: one ``cnn_elm.train_member`` loop per member, one batch of
  one member per kernel launch.
* ``StackedExecutor`` (``backend="stacked"``) — all k members on a leading
  member dim: each batch index is one member-batched launch per kernel,
  the epoch's batches moved to the device in one copy. Unequal shards pad
  to the longest member's batch count with a per-batch validity mask
  (``data.partition.padded_stacked_epoch_batches``).

This slice runs the epochs=0 closed-form pass. The mesh backend, chunked
epochs, multi-round syncs, checkpoints, gossip and validation scoring come
with later slices of the port and raise here.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence, Union

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core import elm
from repro_torch.core.averaging import broadcast_member_dim
from repro_torch.core.cnn_elm import (CNNELMModel, StackedMembers,
                                      average_models, stack_models,
                                      stacked_epoch_pass, train_member)
from repro_torch.data.partition import Partition, padded_stacked_epoch_batches
from repro_torch.data.synthetic import one_hot
from repro_torch.models import cnn
from repro_torch.tree import tree_map

BACKENDS = ("sequential", "stacked")
MESH_SLICE = ("backend 'mesh' runs on torch.distributed and comes with the "
              "multi-device slice of the port")


@dataclass(frozen=True)
class ExecutionPlan:
    """What one epochs=0 Map execution needs: batch size, the member seed
    rule (member i's stream = ``default_rng(seed + i)``), the static
    Reduce weights (None = uniform), and the device the members run on —
    the card unless the caller asks for ``"cpu"``; both executors resolve
    it through ``repro_torch.resolve_device`` and move ``init_params``
    onto it."""
    batch_size: int = 32
    seed: int = 1000
    reduce_weights: Optional[Sequence[float]] = None
    device: Union[str, torch.device] = "cuda"


@dataclass
class MapOutcome:
    """What an executor hands back: the k trained members, the live
    ``StackedMembers``, the averaged model under the plan's Reduce weights,
    and every member's ``ELMStats`` (member-stacked) β was solved from."""
    members: List[CNNELMModel]
    stacked: StackedMembers
    averaged: CNNELMModel
    stats: elm.ELMStats


def _on_device(init_params, plan: ExecutionPlan):
    """(the plan's device, ``init_params`` as f32 on it)."""
    dev = resolve_device(plan.device)
    return dev, tree_map(lambda a: a.to(dev, torch.float32), init_params)


def make_executor(backend: str):
    """Executor registry: ``backend`` ∈ ``BACKENDS``."""
    if backend == "sequential":
        return SequentialExecutor()
    if backend == "stacked":
        return StackedExecutor()
    if backend == "mesh":
        raise NotImplementedError(MESH_SLICE)
    raise ValueError(f"backend must be one of {BACKENDS}, got {backend!r}")


class SequentialExecutor:
    """One ``cnn_elm.train_member`` loop per member — the Algorithm 2
    reference every fast path is held against."""

    name = "sequential"

    def execute(self, cfg, init_params, partitions: Sequence[Partition],
                plan: ExecutionPlan) -> MapOutcome:
        _, init_params = _on_device(init_params, plan)
        members, stats = [], []
        for i, p in enumerate(partitions):
            model, s = train_member(cfg, init_params, p, epochs=0,
                                    batch_size=plan.batch_size,
                                    seed=plan.seed + i, return_stats=True)
            members.append(model)
            stats.append(s)
        stats_k = elm.ELMStats(*(torch.stack(a) for a in zip(*stats)))
        return MapOutcome(members, stack_models(members),
                          average_models(members, plan.reduce_weights),
                          stats_k)


class StackedExecutor:
    """All k members stacked on a leading member dim: per batch index, one
    member-batched conv launch per stage and one elm_stats launch, then one
    batched β solve for all members."""

    name = "stacked"

    def execute(self, cfg, init_params, partitions: Sequence[Partition],
                plan: ExecutionPlan) -> MapOutcome:
        k = len(partitions)
        F, C = cnn.feature_dim(cfg), cfg.num_classes
        dev, init_params = _on_device(init_params, plan)
        rngs = [np.random.default_rng(plan.seed + i) for i in range(k)]
        xs, ys, mk = padded_stacked_epoch_batches(partitions,
                                                  plan.batch_size, rngs)
        tb = one_hot(ys.reshape(-1), C).reshape(*ys.shape, C)
        # batch-major on the host, one copy to the device for the epoch
        xb, tb, mb = (torch.from_numpy(np.ascontiguousarray(
            np.swapaxes(a, 0, 1))).to(dev) for a in (xs, tb, mk))
        masked = bool(np.any(mk == 0.0))
        params_k = broadcast_member_dim(init_params, k)
        stats_k = stacked_epoch_pass(
            cfg, params_k, elm.zero_stats_stacked(k, F, C, device=dev),
            xb, tb, mb if masked else None)
        sm = StackedMembers(params_k, elm.solve_beta(stats_k,
                                                     cfg.elm_lambda))
        return MapOutcome(sm.unstack(), sm,
                          sm.averaged(plan.reduce_weights), stats_k)
