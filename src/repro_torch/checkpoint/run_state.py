"""Round-granular run state — the checkpoint schema behind the
fault-tolerant ``AveragingRun`` (``repro_torch.core.runner``); the port's
counterpart of ``repro.checkpoint.run_state``, with the same files, keys
and fingerprint, so either package resumes from the other's files.

One ``round-<r>.npz`` per averaging round (atomic, ``ckpt``):

* ``members``  — the round's pre-sync members (stacked CNN params + β);
* ``stats``    — every member's final-epoch ``ELMStats`` (what β was solved
  from, so a checkpoint can re-solve or E²LM-merge without the data);
* ``averaged`` — the round's (weighted) averaged model;
* ``resume``   — on non-final rounds, the post-sync params every member was
  reset to: broadcast, it reproduces the uninterrupted run's state bit for
  bit, since the sync itself broadcasts one row to every member.

Metadata carries the rng/round cursor (``round``, ``epochs_done``: the
batch permutations each member stream has consumed) and the run
fingerprint that ``AveragingRun.resume`` checks before it continues.

Sequential runs also save per member (``member-<i>.npz``: params, β,
stats), so a crash while member j trains resumes with members j..k-1.
Elastic runs save ``eround-<r>.npz``: the whole ``ElasticGroup`` and the
membership bookkeeping.

Restores put the tensors on an explicit device: the card unless
``device="cpu"``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.checkpoint.ckpt import (latest_step, latest_valid_step,
                                         list_steps, restore_checkpoint,
                                         save_checkpoint)
from repro_torch.core import elastic, elm
from repro_torch.core.cnn_elm import CNNELMModel, StackedMembers

ROUND = "round"
MEMBER = "member"
ELASTIC = "eround"


def run_fingerprint(backend: str, partitions, *, seed: int, epochs: int,
                    rounds: int, batch_size: int) -> dict:
    """The identity of a run, embedded in every checkpoint so that resume
    refuses a mismatched continuation. The one definition of its fields:
    the executors' save side and ``AveragingRun.resume``'s expected side
    both build it here."""
    return {
        "backend": backend,
        "seed": seed,
        "epochs": epochs,
        "rounds": rounds,
        "batch_size": batch_size,
        "k": len(partitions),
        "sizes": [int(len(p.x)) for p in partitions],
    }


def check_fingerprint(meta: dict, expected: dict):
    """Raise with every differing field named (not just the first)."""
    bad = {k: (meta.get(k), v) for k, v in expected.items()
           if meta.get(k) != v}
    if bad:
        raise ValueError(
            "checkpoint does not match this run — refusing to resume: " +
            "; ".join(f"{k}: saved {s!r} vs run {e!r}"
                      for k, (s, e) in bad.items()))


def _stats_tree(stats: elm.ELMStats) -> dict:
    return {"u": stats.u, "v": stats.v, "n": stats.n}


def _tree_stats(tree: dict) -> elm.ELMStats:
    return elm.ELMStats(tree["u"], tree["v"], tree["n"])


@dataclass
class RoundState:
    """One restored ``round-<r>`` checkpoint."""
    round: int
    members: StackedMembers
    stats: elm.ELMStats
    averaged: CNNELMModel
    resume_params: Optional[dict]     # post-sync CNN params; None on final
    meta: dict

    @property
    def final(self) -> bool:
        return bool(self.meta.get("final"))


def save_round(ckpt_dir: str, round_idx: int, *, members: StackedMembers,
               stats: elm.ELMStats, averaged: CNNELMModel,
               resume_params=None, meta: dict) -> str:
    tree = {
        "members": {"cnn": members.cnn_params, "beta": members.beta},
        "stats": _stats_tree(stats),
        "averaged": {"cnn": averaged.cnn_params, "beta": averaged.beta},
    }
    if resume_params is not None:
        tree["resume"] = resume_params
    return save_checkpoint(ckpt_dir, ROUND, round_idx, tree, meta)


def restore_round(ckpt_dir: str, round_idx: Optional[int] = None,
                  device="cuda") -> RoundState:
    if round_idx is None:
        round_idx = latest_step(ckpt_dir, ROUND)
        if round_idx is None:
            raise FileNotFoundError(f"no '{ROUND}' checkpoint in {ckpt_dir}")
    tree, meta = restore_checkpoint(ckpt_dir, ROUND, round_idx, device)
    return RoundState(
        round=round_idx,
        members=StackedMembers(tree["members"]["cnn"],
                               tree["members"]["beta"]),
        stats=_tree_stats(tree["stats"]),
        averaged=CNNELMModel(tree["averaged"]["cnn"],
                             tree["averaged"]["beta"]),
        resume_params=tree.get("resume"),
        meta=meta["metadata"])


def latest_round(ckpt_dir: str) -> Optional[int]:
    return latest_step(ckpt_dir, ROUND)


def latest_ready_round(ckpt_dir: str) -> Optional[int]:
    """Newest fully written round (``ckpt.latest_valid_step``): stray
    ``*.tmp`` files and torn ``round-<r>.npz`` are skipped."""
    return latest_valid_step(ckpt_dir, ROUND)


# ---------------------------------------------------------------------------
# Elastic rounds — checkpointing a run under membership churn
# ---------------------------------------------------------------------------

@dataclass
class ElasticRoundState:
    """One restored ``eround-<r>`` checkpoint: the whole ``ElasticGroup``
    (living members' params, steps and stats; the retired weighted
    contributions) and the membership bookkeeping the elastic runner needs
    to continue bit for bit — who lives (in join order), each member's id
    (its ``seed + id`` rng stream), the round it joined at (its stream's
    fast-forward), the next joiner's id, and the boundary average every
    member was reset to (``cur_init``)."""
    round: int
    group: elastic.ElasticGroup
    cur_init: object
    living: List[str]
    joined_round: Dict[str, int]
    member_id: Dict[str, int]
    next_id: int
    meta: dict

    @property
    def final(self) -> bool:
        return bool(self.meta.get("final"))


def save_elastic_round(ckpt_dir: str, round_idx: int, *,
                       group: elastic.ElasticGroup, cur_init,
                       joined_round: Dict[str, int],
                       member_id: Dict[str, int], next_id: int,
                       meta: dict) -> str:
    """Snapshot the post-boundary state of elastic round ``round_idx``:
    leavers retired, the sync applied, joiners admitted. Member names
    (``m<id>``) become tree keys."""
    members_tree = {}
    for name, mm in group.members.items():
        sub = {"params": mm.params,
               "steps": np.asarray(mm.steps, np.float64)}
        if mm.stats is not None:
            sub["stats"] = _stats_tree(mm.stats)
        members_tree[name] = sub
    tree = {
        "members": members_tree,
        "retired_params": [(p, np.asarray(w, np.float64))
                           for p, w in group.retired_params],
        "retired_stats": [_stats_tree(s) for s in group.retired_stats],
        "cur_init": cur_init,
    }
    living = sorted(group.members, key=member_id.get)     # join order
    meta = {**meta,
            "living": living,
            "joined_round": {n: int(joined_round[n]) for n in living},
            "member_id": {n: int(member_id[n]) for n in living},
            "next_id": int(next_id)}
    return save_checkpoint(ckpt_dir, ELASTIC, round_idx, tree, meta)


def restore_elastic_round(ckpt_dir: str, round_idx: Optional[int] = None,
                          device="cuda") -> ElasticRoundState:
    """Rebuild the ``ElasticGroup`` exactly: members re-inserted in join
    order (``reduce_params`` sums in dict order, so the order is part of
    the bit-identity contract), retired entries in append order (``ckpt``
    restores lists as tuples; they become lists again)."""
    if round_idx is None:
        round_idx = latest_step(ckpt_dir, ELASTIC)
        if round_idx is None:
            raise FileNotFoundError(
                f"no '{ELASTIC}' checkpoint in {ckpt_dir}")
    tree, meta = restore_checkpoint(ckpt_dir, ELASTIC, round_idx, device)
    md = meta["metadata"]
    member_id = {n: int(i) for n, i in md["member_id"].items()}
    group = elastic.ElasticGroup()
    for name in sorted(tree["members"], key=member_id.get):
        sub = tree["members"][name]
        group.members[name] = elastic.Member(
            params=sub["params"], steps=float(sub["steps"]),
            stats=_tree_stats(sub["stats"]) if "stats" in sub else None)
    # empty lists are saved as no keys at all
    group.retired_params = [(p, float(w))
                            for p, w in tree.get("retired_params", ())]
    group.retired_stats = [_tree_stats(s)
                           for s in tree.get("retired_stats", ())]
    return ElasticRoundState(
        round=round_idx, group=group, cur_init=tree["cur_init"],
        living=list(md["living"]),
        joined_round={n: int(r) for n, r in md["joined_round"].items()},
        member_id=member_id, next_id=int(md["next_id"]), meta=md)


def latest_elastic_round(ckpt_dir: str) -> Optional[int]:
    return latest_step(ckpt_dir, ELASTIC)


def latest_ready_elastic_round(ckpt_dir: str) -> Optional[int]:
    """Newest fully written elastic round (torn files skipped)."""
    return latest_valid_step(ckpt_dir, ELASTIC)


def save_member(ckpt_dir: str, i: int, model: CNNELMModel,
                stats: elm.ELMStats, meta: dict) -> str:
    tree = {"cnn": model.cnn_params, "beta": model.beta,
            "stats": _stats_tree(stats)}
    return save_checkpoint(ckpt_dir, MEMBER, i, tree, meta)


def restore_member(ckpt_dir: str, i: int, device="cuda"):
    tree, meta = restore_checkpoint(ckpt_dir, MEMBER, i, device)
    return (CNNELMModel(tree["cnn"], tree["beta"]),
            _tree_stats(tree["stats"]), meta["metadata"])


def completed_members(ckpt_dir: str):
    """Member indices with a durable checkpoint (ascending)."""
    return list_steps(ckpt_dir, MEMBER)


def stack_stats(per_member) -> elm.ELMStats:
    """k single-member ``ELMStats`` -> one member-stacked ``ELMStats``."""
    return elm.ELMStats(*(torch.stack(list(a)) for a in zip(*per_member)))
