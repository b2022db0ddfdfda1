"""Checkpoint hot-reload — a live endpoint tracking an in-progress
``AveragingRun`` or ``StreamingRun``. The port's counterpart of
``repro.serve.hot_reload``.

``CheckpointWatcher`` polls a ``CheckpointConfig.dir`` for the newest
fully-written ``round-<r>.npz`` (``run_state.latest_ready_round``, which
is ``ckpt.latest_valid_step`` under the hood: stray ``*.tmp`` files and
partially written checkpoints are SKIPPED and retried on the next poll,
never crashed on — the training run and the server race on the same
directory by design). When a newer round appears, the watcher restores
it OFF the hot path (on its own thread, straight onto the scorer's
device), then stages the round's member snapshot with
``EnsembleServer.swap_members`` — the scoring worker copies it into the
captured graphs' weights between batches, so zero requests are dropped
and post-swap predictions are bit-equal to scoring the new checkpoint
directly (same captured programs, same weights).

The swap reuses the captured bucket graphs because a training run's
rounds share one arch and k (``BucketedScorer.validate_members`` enforces
it); a checkpoint that fails to restore or validate is recorded in
``rejected`` and retried/skipped rather than taking the endpoint down.
"""
from __future__ import annotations

import threading
import time
from dataclasses import dataclass
from typing import List, Optional

from repro_torch.checkpoint import run_state


@dataclass
class SwapEvent:
    """One applied hot swap: which round, when the watcher staged it."""
    round: int
    t_staged: float          # time.monotonic() at stage time


class CheckpointWatcher:
    """Poll ``ckpt_dir`` and feed newer rounds to a server.

    ``start_round`` — the round the server is currently serving (swaps
    apply only for strictly newer rounds; default -1 serves the first
    round that appears). ``poll_ms`` — poll cadence; restores happen on
    the watcher thread, so a slow disk stalls only the swap, never the
    scoring worker."""

    def __init__(self, ckpt_dir: str, server, *, poll_ms: float = 50.0,
                 start_round: int = -1):
        if poll_ms <= 0:
            raise ValueError(f"poll_ms must be > 0, got {poll_ms}")
        self.ckpt_dir = ckpt_dir
        self.server = server
        self.poll_s = poll_ms / 1e3
        self.swaps: List[SwapEvent] = []
        self.rejected: List[int] = []      # rounds that failed to load/apply
        self._last = start_round
        self._stop = threading.Event()
        self._woke = threading.Event()     # set after every poll (for tests)
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="repro-torch-serve-watcher")
        self._started = False

    @property
    def current_round(self) -> int:
        return self._last

    def start(self) -> "CheckpointWatcher":
        if not self._started:
            self._started = True
            self._thread.start()
        return self

    def stop(self):
        self._stop.set()
        if self._started:
            self._thread.join()

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()

    def poll_once(self) -> Optional[int]:
        """One poll step (also the loop body): stage the newest ready
        round if it is newer than what the server runs. Returns the round
        staged, or None."""
        r = run_state.latest_ready_round(self.ckpt_dir)
        if r is None or r <= self._last:
            return None
        try:
            state = run_state.restore_round(
                self.ckpt_dir, r, device=self.server.scorer.device)
            # the round's pre-sync member snapshot IS the ensemble: the
            # k models the Reduce would average, in the stacked layout
            # the scorer dispatches
            self.server.swap_members(state.members)
        except Exception:
            # torn mid-poll or an incompatible checkpoint: skip + retry
            # (latest_ready_round will keep offering it until a complete
            # file replaces it; record so operators can see the skip)
            if r not in self.rejected:
                self.rejected.append(r)
            return None
        self._last = r
        self.swaps.append(SwapEvent(round=r, t_staged=time.monotonic()))
        return r

    def wait_for_round(self, round_idx: int, timeout_s: float = 30.0) -> bool:
        """Block until a swap for ``round_idx`` (or newer) has been
        STAGED (the scoring worker applies it at its next flush)."""
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            if self._last >= round_idx:
                return True
            self._woke.clear()
            self._woke.wait(timeout=self.poll_s * 2)
        return self._last >= round_idx

    def _loop(self):
        while not self._stop.is_set():
            self.poll_once()
            self._woke.set()
            self._stop.wait(timeout=self.poll_s)
        self._woke.set()
