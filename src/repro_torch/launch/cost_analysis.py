"""The card's peak rates, collective bytes and roofline terms — the port's
counterpart of ``repro.launch.hlo_analysis``.

The reference reads FLOPs and bytes off XLA's ``cost_analysis()`` and
collective bytes off the compiled HLO's text, and prices them at a TPU's
rates. The port's dry run (``launch/dryrun.py``) counts the same three
things in a step traced on the meta device — FLOPs by dtype, the bytes
each op reads and writes, and the bytes each ``distributed.collectives``
call sends — and this module prices them at a card's rates.

``CARDS`` holds NVIDIA's data-sheet figures per card: dense (no sparsity)
bf16 tensor-core FLOP/s, f32 FLOP/s on the CUDA cores, device-memory
bytes/s, device memory, and NVLink bytes/s in one direction. The dry run
uses ``CARD = "H100"``: the NVIDIA H100 80GB HBM3 (SXM5) at its 700 W
limit — 989 TFLOP/s bf16, 67 TFLOP/s f32, 3.35 TB/s, 80 GB, 450 GB/s. A
card held below 700 W runs slower under load, so a roofline time at these
rates is a floor. ``chip_smoke.py`` times its kernels against the same
table.

The collective multipliers are the reference's ring-algorithm traffic
factors (all-reduce 2x: a reduce-scatter and an all-gather; the others
1x), applied to the port's kinds: a ring exchange is a
collective-permute, a barrier a one-element all-reduce, and the port's
broadcast and reduce, which the reference's programs do not emit, are
priced 1x. On an LM mesh
each call's group label is its mesh axis (``"model"``, ``"data"``,
``"pod+model"``), so ``CollectiveStats`` also splits the bytes and calls
per chip by axis; the reference prices the sum (its per-chip link time).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Mapping, NamedTuple


class CardRates(NamedTuple):
    """One card's data-sheet peaks."""
    name: str
    f32_flops: float          # FLOP/s on the CUDA cores
    bf16_flops: float         # dense FLOP/s on the tensor cores
    hbm_bytes_per_s: float    # device memory
    memory_bytes: float       # device memory size
    link_bytes_per_s: float   # NVLink, one direction


# matched against the card's name in this order (the SXM5 part unless the
# name says PCIe or NVL)
CARDS: Dict[str, CardRates] = {
    "H100 PCIe": CardRates("NVIDIA H100 PCIe 80GB", 51.2e12, 756e12,
                           2.0e12, 80e9, 300e9),
    "H100 NVL": CardRates("NVIDIA H100 NVL 94GB", 60e12, 835e12,
                          3.9e12, 94e9, 300e9),
    "H100": CardRates("NVIDIA H100 80GB HBM3 (SXM5, 700 W)", 67e12, 989e12,
                      3.35e12, 80e9, 450e9),
}
CARD = "H100"

# the reference's ring-algorithm traffic multipliers, by HLO kind; and the
# port's broadcast and reduce (a layer fetched from the rank that holds
# it, its gradient summed back), 1x: a pipelined ring passes the tensor
# once over each link, as an all-gather passes its result
_MULT = {
    "all-reduce": 2.0,
    "all-gather": 1.0,
    "reduce-scatter": 1.0,
    "all-to-all": 1.0,
    "collective-permute": 1.0,
    "broadcast": 1.0,
    "reduce": 1.0,
}
# the port's collective kinds (``distributed.collectives``) as HLO kinds
HLO_KIND = {"all_reduce": "all-reduce", "all_gather": "all-gather",
            "reduce_scatter": "reduce-scatter", "broadcast": "broadcast",
            "reduce": "reduce", "ring_exchange": "collective-permute",
            "barrier": "all-reduce"}
_TENSOR_CORE_DTYPES = ("bfloat16", "float16")


def card_key(name: str) -> str:
    """The first ``CARDS`` key found in ``name`` (a key, or the card's
    name as nvidia-smi or ``torch.cuda.get_device_name`` gives it)."""
    for key in CARDS:
        if key in name:
            return key
    raise KeyError(f"no peak rates on record for {name!r}")


@dataclass
class CollectiveStats:
    """Collective traffic of one card: ``per_card_bytes`` weighted by the
    ring multipliers, and the raw bytes and calls by HLO kind."""
    per_card_bytes: float = 0.0
    raw_bytes_by_kind: Dict[str, int] = field(default_factory=dict)
    count_by_kind: Dict[str, int] = field(default_factory=dict)
    per_card_bytes_by_axis: Dict[str, float] = field(default_factory=dict)
    count_by_axis: Dict[str, int] = field(default_factory=dict)

    def as_dict(self):
        return {"per_card_bytes": self.per_card_bytes,
                "raw_bytes_by_kind": self.raw_bytes_by_kind,
                "count_by_kind": self.count_by_kind,
                "per_card_bytes_by_axis": self.per_card_bytes_by_axis,
                "count_by_axis": self.count_by_axis}


def collective_stats(calls: Mapping, nbytes: Mapping) -> CollectiveStats:
    """``CollectiveStats`` of the calls ``distributed.collectives`` counted:
    ``calls`` and ``nbytes`` keyed by ``(kind, group label)`` (the growth of
    ``collectives.CALLS`` and ``collectives.BYTES`` over a step)."""
    st = CollectiveStats()
    for key, n in calls.items():
        if not n:
            continue
        hlo, axis = HLO_KIND[key[0]], key[1]
        b = nbytes.get(key, 0)
        st.per_card_bytes += _MULT[hlo] * b
        st.raw_bytes_by_kind[hlo] = st.raw_bytes_by_kind.get(hlo, 0) + b
        st.count_by_kind[hlo] = st.count_by_kind.get(hlo, 0) + n
        st.per_card_bytes_by_axis[axis] = (
            st.per_card_bytes_by_axis.get(axis, 0.0) + _MULT[hlo] * b)
        st.count_by_axis[axis] = st.count_by_axis.get(axis, 0) + n
    return st


def roofline_terms(flops_by_dtype: Mapping[str, float], hbm_bytes: float,
                   per_card_coll_bytes: float, cards: int,
                   card: str = CARD) -> dict:
    """The three roofline times in seconds of a step over ``cards`` cards:
    its FLOPs (by operand dtype: bf16 and f16 at the tensor-core rate, any
    other at the f32 rate) and device-memory bytes are whole-step totals,
    its collective bytes per card (multiplier-weighted), as in
    ``hlo_analysis.roofline_terms``."""
    rates = CARDS[card]
    tensor = sum(v for k, v in flops_by_dtype.items()
                 if k in _TENSOR_CORE_DTYPES)
    other = sum(v for k, v in flops_by_dtype.items()
                if k not in _TENSOR_CORE_DTYPES)
    t_compute = (tensor / rates.bf16_flops + other / rates.f32_flops) / cards
    t_memory = hbm_bytes / (cards * rates.hbm_bytes_per_s)
    t_coll = per_card_coll_bytes / rates.link_bytes_per_s
    dominant = max((("compute", t_compute), ("memory", t_memory),
                    ("collective", t_coll)), key=lambda kv: kv[1])[0]
    return {"t_compute_s": t_compute, "t_memory_s": t_memory,
            "t_collective_s": t_coll, "dominant": dominant}
