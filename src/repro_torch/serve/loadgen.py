"""Synthetic open-loop load generation + tail-latency reporting — the
port's copy of ``repro.serve.loadgen`` (numpy only).

Open-loop means arrivals follow their own clock — a request is submitted
at its scheduled arrival time whether or not earlier ones have finished
(the load a million independent users actually offers), so queueing
delay shows up IN the measured latency instead of silently throttling
the generator, and saturation appears as the achieved rate falling below
the offered rate while tail latency grows.

``run_open_loop`` drives an ``EnsembleServer`` at one offered rate
(Poisson or uniform arrivals, seeded) and returns a ``LoadReport``
with p50/p95/p99 latency and achieved images/s;
``chip_smoke.py`` sweeps it across offered loads on the card.
"""
from __future__ import annotations

import time
from dataclasses import asdict, dataclass
from typing import Optional

import numpy as np


@dataclass
class LoadReport:
    """One offered-load point of the sweep."""
    offered_per_s: float
    submitted: int
    completed: int
    failed: int
    duration_s: float
    achieved_per_s: float
    p50_ms: float
    p95_ms: float
    p99_ms: float
    mean_ms: float
    max_ms: float

    def to_json(self) -> dict:
        return asdict(self)


def run_open_loop(server, images, *, rate_per_s: float, n_requests: int,
                  seed: int = 0, poisson: bool = True,
                  timeout_s: float = 60.0,
                  probe: Optional[np.ndarray] = None) -> LoadReport:
    """Offer ``n_requests`` single-image requests at ``rate_per_s``.

    ``images`` is the request pool (cycled). Arrival gaps are
    exponential (Poisson process) or uniform ``1/rate``. The generator
    never waits on results mid-stream (open loop); it gathers every
    Future at the end — a Future that errors counts as ``failed``, so
    "zero failed" in the report means zero dropped/errored requests."""
    if rate_per_s <= 0:
        raise ValueError(f"rate_per_s must be > 0, got {rate_per_s}")
    if n_requests < 1:
        raise ValueError(f"n_requests must be >= 1, got {n_requests}")
    rng = np.random.default_rng(seed)
    gaps = (rng.exponential(1.0 / rate_per_s, n_requests) if poisson
            else np.full(n_requests, 1.0 / rate_per_s))
    t0 = time.monotonic()
    arrivals = t0 + np.cumsum(gaps)
    futures = []
    for i in range(n_requests):
        delay = arrivals[i] - time.monotonic()
        if delay > 0:
            time.sleep(delay)
        futures.append(server.submit(images[i % len(images)]))
    lats, failed = [], 0
    for f in futures:
        try:
            lats.append(f.result(timeout=timeout_s).latency_s)
        except Exception:
            failed += 1
    duration = time.monotonic() - t0
    lat_ms = np.asarray(lats) * 1e3 if lats else np.asarray([np.nan])
    return LoadReport(
        offered_per_s=rate_per_s, submitted=n_requests,
        completed=len(lats), failed=failed, duration_s=duration,
        achieved_per_s=len(lats) / max(duration, 1e-9),
        p50_ms=float(np.percentile(lat_ms, 50)),
        p95_ms=float(np.percentile(lat_ms, 95)),
        p99_ms=float(np.percentile(lat_ms, 99)),
        mean_ms=float(np.mean(lat_ms)),
        max_ms=float(np.max(lat_ms)))
