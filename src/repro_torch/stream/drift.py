"""Drift detection — the per-member signal that triggers a Reduce. The
port's copy of ``repro.stream.drift`` (standard library only).

Each member scores the held-out slice of every incoming chunk BEFORE
training on it (prequential / test-then-train evaluation, the standard
stream-learning protocol: the score is always an out-of-sample estimate
because the model has never seen the chunk). Two detectors share the
``update(score) -> bool`` surface, selected by
``StreamConfig.drift_detector`` via ``make_detector``:

* ``DriftDetector`` (``"ewma"``) tracks the score against an EWMA
  baseline; a drop beyond ``threshold`` flags drift.
* ``PageHinkleyDetector`` (``"page_hinkley"``) runs the Page-Hinkley
  test: it accumulates deviations below the running mean and flags
  drift when the cumulative statistic exceeds ``threshold`` — sensitive
  to slow degradations a single-score threshold misses, while a
  one-chunk score collapse still fires immediately.

Drifting is a LEVEL, not an edge: the detector stays in the drifting
state — and the ``sync="drift"`` policy keeps firing Reduces — until the
score recovers to within ``threshold`` of the frozen baseline. That is
deliberate: right after a concept shift the sliding window still holds
pre-drift chunks, so the first few re-solved β's are contaminated;
repeated syncs while drifting keep publishing fresher averages as the
window flushes, and the detector disarms on its own once the windowed
model scores well again. The baseline is FROZEN during drift (updating
it would chase the degraded scores and disarm the detector on a still-
broken model).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List


@dataclass
class DriftDetector:
    """EWMA score tracker with a drop threshold.

    ``update(score)`` feeds one prequential score (higher is better —
    accuracy, or -loss) and returns whether the member is currently
    drifting. The first ``warmup`` scores only seed the baseline and can
    never signal (a cold model's noisy early scores are not drift)."""

    threshold: float = 0.2    # baseline − score that flags drift
    alpha: float = 0.2        # EWMA weight of the newest score
    warmup: int = 3           # scores consumed before arming

    baseline: float = field(default=float("nan"), init=False)
    drifting: bool = field(default=False, init=False)
    seen: int = field(default=0, init=False)
    history: List[float] = field(default_factory=list, init=False)

    def __post_init__(self):
        if not 0.0 < self.alpha <= 1.0:
            raise ValueError(f"alpha must be in (0, 1], got {self.alpha}")
        if self.threshold <= 0.0:
            raise ValueError(f"threshold must be > 0, got {self.threshold}")
        if self.warmup < 1:
            raise ValueError(f"warmup must be >= 1, got {self.warmup}")

    def update(self, score: float) -> bool:
        """Feed one held-out score; returns the (level) drift state."""
        score = float(score)
        self.seen += 1
        self.history.append(score)
        if self.seen <= self.warmup:
            # Seed phase: plain running mean, detector disarmed.
            if self.seen == 1:
                self.baseline = score
            else:
                self.baseline += (score - self.baseline) / self.seen
            return False
        if self.drifting:
            # Baseline frozen; disarm only on recovery.
            if self.baseline - score <= self.threshold:
                self.drifting = False
                # Recovery re-seeds the baseline at the recovered level —
                # post-drift "normal" may be a different score regime.
                self.baseline = score
            return self.drifting
        if self.baseline - score > self.threshold:
            self.drifting = True
            return True
        self.baseline += self.alpha * (score - self.baseline)
        return False


@dataclass
class PageHinkleyDetector:
    """Page-Hinkley test on the prequential score stream.

    Tracks the running mean x̄ of the scores and the cumulative
    deviation ``m_t = Σ (x̄ − score − delta)``; drift fires when
    ``m_t − min(m_s)`` exceeds ``threshold`` (the classic PH statistic
    for a downward mean shift). ``delta`` is the per-step tolerance —
    noise smaller than it never accumulates.

    Warmup/recovery semantics match ``DriftDetector`` exactly: the first
    ``warmup`` scores only seed the running mean and can never signal;
    drifting is a LEVEL with the baseline (the running mean) FROZEN at
    drift entry; the detector disarms when the score recovers to within
    ``recovery`` of that frozen baseline, which re-seeds the mean at the
    recovered level and resets the PH statistic."""

    threshold: float = 0.2    # λ: cumulative deviation that flags drift
    delta: float = 0.005      # per-step tolerance of the PH statistic
    recovery: float = 0.2     # baseline − score margin that disarms
    warmup: int = 3           # scores consumed before arming

    baseline: float = field(default=float("nan"), init=False)
    drifting: bool = field(default=False, init=False)
    seen: int = field(default=0, init=False)
    history: List[float] = field(default_factory=list, init=False)
    _n: int = field(default=0, init=False)        # scores in current mean
    _cum: float = field(default=0.0, init=False)  # m_t
    _cum_min: float = field(default=0.0, init=False)

    def __post_init__(self):
        if self.threshold <= 0.0:
            raise ValueError(f"threshold must be > 0, got {self.threshold}")
        if self.delta < 0.0:
            raise ValueError(f"delta must be >= 0, got {self.delta}")
        if self.recovery <= 0.0:
            raise ValueError(f"recovery must be > 0, got {self.recovery}")
        if self.warmup < 1:
            raise ValueError(f"warmup must be >= 1, got {self.warmup}")

    def _absorb(self, score: float):
        self._n += 1
        if self._n == 1:
            self.baseline = score
        else:
            self.baseline += (score - self.baseline) / self._n

    def update(self, score: float) -> bool:
        """Feed one held-out score; returns the (level) drift state."""
        score = float(score)
        self.seen += 1
        self.history.append(score)
        if self.seen <= self.warmup:
            # Seed phase: plain running mean, detector disarmed.
            self._absorb(score)
            return False
        if self.drifting:
            # Baseline and statistic frozen; disarm only on recovery.
            if self.baseline - score <= self.recovery:
                self.drifting = False
                # Recovery re-seeds mean AND statistic at the recovered
                # level — post-drift "normal" may be a new score regime.
                self.baseline = score
                self._n = 1
                self._cum = self._cum_min = 0.0
            return self.drifting
        self._absorb(score)
        self._cum += self.baseline - score - self.delta
        self._cum_min = min(self._cum_min, self._cum)
        if self._cum - self._cum_min > self.threshold:
            self.drifting = True
        return self.drifting


DETECTORS = ("ewma", "page_hinkley")


def make_detector(kind: str = "ewma", *, threshold: float = 0.2,
                  alpha: float = 0.2, warmup: int = 3,
                  delta: float = 0.005, recovery: float | None = None):
    """Detector factory behind ``StreamConfig.drift_detector``. ``alpha``
    only reaches the EWMA detector and ``delta`` only Page-Hinkley;
    ``recovery`` (PH) defaults to ``threshold``, mirroring the EWMA
    detector's disarm margin."""
    if kind == "ewma":
        return DriftDetector(threshold=threshold, alpha=alpha,
                             warmup=warmup)
    if kind == "page_hinkley":
        return PageHinkleyDetector(
            threshold=threshold, delta=delta,
            recovery=threshold if recovery is None else recovery,
            warmup=warmup)
    raise ValueError(f"drift detector must be one of {DETECTORS}, "
                     f"got {kind!r}")
