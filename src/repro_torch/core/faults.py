"""Failure injection — the harness that exercises the fault-tolerance
layer end to end; the port's counterpart of ``repro.core.faults``.

* **Crash policies** — ``crash_after(unit, index)`` raises
  ``InjectedCrash`` from ``CheckpointConfig.after_save`` the moment the
  named checkpoint is renamed into place: state on disk, process gone.
  ``run_to_crash`` drives an ``AveragingRun`` into it and
  ``run_crash_resume`` closes the loop (crash, then resume).
* **Torn saves** — ``inject_torn_save`` leaves what a writer killed
  mid-save leaves behind (a truncated final ``.npz`` and a stray
  ``*.tmp``), which ``ckpt.latest_valid_step`` must skip.
* **Straggler drops** — ``straggler_drop_schedule`` turns shard sizes into
  an ``ElasticSchedule``: members whose shard exceeds ``factor`` × the
  median row count leave at a round boundary, their contribution kept. At
  least one member always survives.
"""
from __future__ import annotations

import io
import os
import tempfile
from typing import Optional, Sequence

import numpy as np

from repro_torch.core.runner import (AveragingRun, CheckpointConfig,
                                     ElasticEvent, ElasticSchedule)
from repro_torch.data.partition import Partition


class InjectedCrash(RuntimeError):
    """The stand-in for a worker preemption, OOM kill or spot reclaim."""


def crash_after(unit: str, index: int):
    """A ``CheckpointConfig.after_save`` hook raising ``InjectedCrash``
    right after checkpoint ``unit`` (``"round"`` on the stacked and elastic
    layouts, ``"member"`` on sequential) number ``index`` is on disk."""
    if unit not in ("round", "member"):
        raise ValueError(f"unit must be 'round' or 'member', got {unit!r}")

    def hook(u: str, i: int, path: str):
        if u == unit and i == index:
            raise InjectedCrash(
                f"injected crash after {unit} {index} checkpoint ({path})")
    return hook


def run_to_crash(run: AveragingRun, partitions: Sequence[Partition],
                 ckpt_dir: str, *, unit: str = "round", index: int = 0,
                 every: int = 1, **run_kw) -> bool:
    """Run until the injected preemption fires (``run_kw``: ``run``'s
    ``generator``, ``init_params``, ``device``). True when the crash hit,
    False when the run finished first."""
    ck = CheckpointConfig(dir=ckpt_dir, every=every,
                          after_save=crash_after(unit, index))
    try:
        run.run(partitions, checkpoint=ck, **run_kw)
        return False
    except InjectedCrash:
        return True


def run_crash_resume(run: AveragingRun, partitions: Sequence[Partition],
                     ckpt_dir: str, *, unit: str = "round", index: int = 0,
                     every: int = 1, **run_kw):
    """Crash the run after the named checkpoint, resume it from disk with
    the same ``run_kw``, and return ``(crashed, resumed_result)``. A
    ``generator`` is set back to its state before the run, so the resume
    draws the same init. The caller compares the result with an
    uninterrupted run: they must be bit-identical."""
    gen = run_kw.get("generator")
    state = None if gen is None else gen.get_state()
    crashed = run_to_crash(run, partitions, ckpt_dir, unit=unit,
                           index=index, every=every, **run_kw)
    if gen is not None:
        gen.set_state(state)
    return crashed, run.resume(partitions, ckpt_dir, **run_kw)


def inject_torn_save(ckpt_dir: str, name: str, step: int, *,
                     keep_fraction: float = 0.5, crash: bool = True):
    """Leave the on-disk wreckage of a writer killed mid-save: a truncated
    ``<name>-<step>.npz`` at the final path (genuine npz bytes cut at
    ``keep_fraction``; the zip's central directory is at the end, so every
    reader fails cleanly) and a stray ``*.tmp``. With ``crash=True`` it
    then raises ``InjectedCrash``; else returns ``(partial_path,
    tmp_path)``."""
    if not 0 < keep_fraction < 1:
        raise ValueError(f"keep_fraction must be in (0, 1), "
                         f"got {keep_fraction}")
    os.makedirs(ckpt_dir, exist_ok=True)
    buf = io.BytesIO()
    np.savez(buf, payload=np.arange(4096, dtype=np.float32),
             __meta__=np.frombuffer(b'{"step": %d}' % step, np.uint8))
    torn = buf.getvalue()[:max(1, int(len(buf.getvalue()) * keep_fraction))]
    partial_path = os.path.join(ckpt_dir, f"{name}-{step:08d}.npz")
    with open(partial_path, "wb") as f:
        f.write(torn)
    fd, tmp_path = tempfile.mkstemp(dir=ckpt_dir, suffix=".tmp")
    with os.fdopen(fd, "wb") as f:
        f.write(torn)
    if crash:
        raise InjectedCrash(
            f"injected mid-save crash writing {name} step {step} "
            f"(torn file at {partial_path}, stray tmp {tmp_path})")
    return partial_path, tmp_path


def straggler_drop_schedule(partitions: Sequence[Partition], *,
                            factor: float = 1.5, after_round: int = 0,
                            max_drop: Optional[int] = None
                            ) -> ElasticSchedule:
    """Leave events for every member whose shard exceeds ``factor`` × the
    median row count, at the ``after_round`` boundary; ``max_drop`` caps
    the departures, and one member always survives. An empty schedule when
    the shards are balanced."""
    if factor <= 0:
        raise ValueError(f"factor must be > 0, got {factor}")
    rows = np.array([len(p.x) for p in partitions], np.float64)
    cut = factor * float(np.median(rows))
    drop = [f"m{i}" for i in np.argsort(-rows) if rows[i] > cut]
    limit = len(partitions) - 1 if max_drop is None \
        else min(max_drop, len(partitions) - 1)
    drop = drop[:limit]
    if not drop:
        return ElasticSchedule(())
    return ElasticSchedule((ElasticEvent(after_round=after_round,
                                         leave=tuple(drop)),))
