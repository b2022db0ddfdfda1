"""Synthetic token streams for the LM — the port's own copy of
``repro.data.lm_data`` (numpy only, so its batches are bitwise the
reference's).

Deterministic, seekable, shardable: batch ``i`` for member ``m`` is a pure
function of (spec, m, i), so k asynchronous members never need
coordination — the MapReduce property the paper relies on.

The stream is a mixture of order-2 Markov chains (one transition table per
"domain"); non-IID partitioning assigns disjoint domain subsets to
members, the paper's distribution-mismatch regime at LM scale.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass(frozen=True)
class TokenDatasetSpec:
    vocab_size: int
    seq_len: int
    batch_size: int
    num_domains: int = 8
    seed: int = 0


def _domain_table(spec: TokenDatasetSpec, domain: int, width: int = 16):
    """Sparse per-domain successor table: token t -> ``width`` candidates."""
    rng = np.random.default_rng(spec.seed * 1000 + domain)
    return rng.integers(0, spec.vocab_size,
                        size=(min(spec.vocab_size, 4096), width),
                        dtype=np.int32)


def synthetic_token_batches(spec: TokenDatasetSpec, member: int = 0,
                            domains=None, start_batch: int = 0):
    """Yields (tokens, targets) int32 arrays of (batch, seq)."""
    if domains is None:
        domains = list(range(spec.num_domains))
    tables = {d: _domain_table(spec, d) for d in domains}
    i = start_batch
    while True:
        rng = np.random.default_rng(
            hash((spec.seed, member, i)) % (2 ** 63 - 1))
        dom = domains[int(rng.integers(len(domains)))]
        tab = tables[dom]
        n_states, width = tab.shape
        toks = np.empty((spec.batch_size, spec.seq_len + 1), np.int32)
        toks[:, 0] = rng.integers(0, spec.vocab_size, spec.batch_size)
        choice = rng.integers(0, width, size=(spec.batch_size, spec.seq_len))
        for t in range(spec.seq_len):
            toks[:, t + 1] = tab[toks[:, t] % n_states, choice[:, t]]
        yield toks[:, :-1], toks[:, 1:]
        i += 1
