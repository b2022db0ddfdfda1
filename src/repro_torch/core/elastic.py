"""Elastic membership — the 'Elastic' in E²LM, applied at classifier level.
The port's counterpart of ``repro.core.elastic``.

* ``join``   — a new member starts from the current average (Alg. 2 line
  3's shared init, applied mid-training); its ELM stats start at zero and
  add to the reduce (E²LM decomposes exactly, so late stats are exact).
* ``leave``  — a departing member keeps its weights in every later
  weighted average and its accumulated (U, V) in the head's stats.
* ``reduce`` — cumulative-work-weighted weight average and the exact
  stats merge.

The work each ``record_step`` adds comes from the runner's Reduce strategy
(any ``elastic_ok`` entry of ``core.reduce_strategies``): ``uniform`` 1
per block survived, ``shard_weighted`` the rows the block processed,
``boosted`` the block output's validation-quality alpha.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Optional

from repro_torch.core import elm
from repro_torch.core.averaging import weighted_average_trees


@dataclass
class Member:
    params: object
    steps: float = 0.0                      # local work — averaging weight
    stats: Optional[elm.ELMStats] = None    # E²LM sufficient statistics


@dataclass
class ElasticGroup:
    members: Dict[str, Member] = field(default_factory=dict)
    retired_params: list = field(default_factory=list)   # (params, weight)
    retired_stats: list = field(default_factory=list)

    def join(self, name: str, init_params=None):
        """A new member starts from the current group average; an explicit
        ``init_params`` overrides it (the runner passes the boundary sync's
        output, so a joiner and the reset members share one tree); an empty
        group requires it."""
        if name in self.members:
            raise ValueError(f"member {name!r} already in the group")
        if init_params is None:
            if not self.members:
                raise ValueError("first member needs init_params")
            init_params = self.reduce_params()
        self.members[name] = Member(params=init_params)
        return self.members[name]

    def leave(self, name: str):
        m = self.members.pop(name)
        if m.steps > 0:
            self.retired_params.append((m.params, m.steps))
        if m.stats is not None:
            self.retired_stats.append(m.stats)
        return m

    def record_step(self, name: str, params, n: float = 1.0):
        m = self.members[name]
        m.params = params
        m.steps += n

    def record_stats(self, name: str, stats: elm.ELMStats):
        m = self.members[name]
        m.stats = stats if m.stats is None else elm.add_stats(m.stats, stats)

    def reduce_params(self):
        """Work-weighted average over living and retired members, summed
        in member order, then retired order."""
        entries = [(m.params, max(m.steps, 1e-9))
                   for m in self.members.values()]
        entries += self.retired_params
        trees, weights = zip(*entries)
        return weighted_average_trees(list(trees), list(weights))

    def sync(self):
        """One averaging event over the whole group: every living member
        restarts from the same ``reduce_params()`` average. Returns it."""
        avg = self.reduce_params()
        for m in self.members.values():
            m.params = avg
        return avg

    def reduce_stats(self) -> Optional[elm.ELMStats]:
        all_stats = [m.stats for m in self.members.values()
                     if m.stats is not None] + self.retired_stats
        if not all_stats:
            return None
        out = all_stats[0]
        for s in all_stats[1:]:
            out = elm.add_stats(out, s)
        return out

    def solve_head(self, lam: float):
        stats = self.reduce_stats()
        if stats is None:
            raise ValueError("no ELM stats recorded")
        return elm.solve_beta(stats, lam)
