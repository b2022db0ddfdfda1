"""Live ensemble serving over a training run on the PyTorch/CUDA port — the
train → crash → serve → hot-swap pipeline, the port's counterpart of
``examples/serve_ensemble.py``.

1. **Train with checkpoints** — an ``AveragingRun`` (rounds=2, SGD epochs)
   starts with a ``CheckpointConfig`` and is preempted right after its
   round-0 checkpoint is durable (``core.faults.run_to_crash``, the
   injected stand-in for a spot reclaim).
2. **Serve the checkpoint** — a ``BucketedScorer`` over round 0's members
   (on the card, one captured CUDA graph per bucket, ever) goes behind an
   ``EnsembleServer`` (continuous batching under a latency bound) with a
   ``CheckpointWatcher`` polling the same directory; an open-loop traffic
   thread keeps single-image requests flowing.
3. **Training resumes, the endpoint hot-swaps** — ``AveragingRun.resume``
   finishes round 1 (bit-identical to the uninterrupted run) and writes its
   checkpoint; the watcher swaps the serving weights between batches: zero
   dropped and zero failed requests, no new program, and post-swap scores
   bit-equal to scoring the round-1 checkpoint directly (asserted).

  PYTHONPATH=src python examples/serve_ensemble_torch.py            # card
  PYTHONPATH=src python examples/serve_ensemble_torch.py --device cpu
  PYTHONPATH=src python examples/serve_ensemble_torch.py --smoke --device cpu
"""
import argparse
import shutil
import tempfile
import threading
import time

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.checkpoint import run_state
from repro_torch.configs import get_reduced_config, replace
from repro_torch.core import faults
from repro_torch.core.runner import AveragingRun, MapConfig, ReduceConfig
from repro_torch.data.partition import partition_iid
from repro_torch.data.synthetic import make_extended_mnist
from repro_torch.optim.schedules import dynamic_paper
from repro_torch.serve import (BucketedScorer, CheckpointWatcher,
                               EnsembleServer, ServeConfig)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--smoke", action="store_true", help="tiny CI config")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu, the plain PyTorch path")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    cfg = replace(get_reduced_config("cnn_elm_6c12c"), elm_lambda=1.0)
    ds = make_extended_mnist(n_per_class=30 if args.smoke else 80, seed=0)
    train, test = ds.split(n_test=60 if args.smoke else 200)
    parts = partition_iid(train.x, train.y, 3)
    run = AveragingRun(
        cfg,
        MapConfig(epochs=2, lr_schedule=dynamic_paper(0.05), batch_size=50),
        ReduceConfig(rounds=2))
    ckpt_dir = tempfile.mkdtemp(prefix="serve_ensemble_torch_")
    try:
        return _pipeline(cfg, run, parts, test, ckpt_dir, dev)
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)


def _pipeline(cfg, run, parts, test, ckpt_dir, dev):
    def generator():
        return torch.Generator().manual_seed(0)

    # -- 1. train until the round-0 checkpoint is durable, then lose the
    #       worker (a spot reclaim) -----------------------------------
    crashed = faults.run_to_crash(run, parts, ckpt_dir, unit="round",
                                  index=0, generator=generator(), device=dev)
    assert crashed and run_state.latest_ready_round(ckpt_dir) == 0
    print(f"train: preempted after round 0 (checkpoint in {ckpt_dir})")

    # -- 2. bring the endpoint up on what is on disk --------------------
    state0 = run_state.restore_round(ckpt_dir, 0, device=dev)
    scorer = BucketedScorer(cfg, state0.members, max_batch=8, device=dev)
    server = EnsembleServer(scorer, ServeConfig(max_batch=8,
                                                max_wait_ms=2.0)).start()
    watcher = CheckpointWatcher(ckpt_dir, server, poll_ms=10,
                                start_round=0).start()
    print(f"serve: k={scorer.k} ensemble up on {dev}, buckets "
          f"{scorer.ladder.buckets}")

    stop = threading.Event()
    traffic = []

    def offer_load():                      # open-loop background traffic
        i = 0
        while not stop.is_set():
            traffic.append(server.submit(test.x[i % len(test.x)]))
            i += 1
            time.sleep(0.002)

    th = threading.Thread(target=offer_load)
    th.start()

    # -- 3. training resumes on the same directory; the endpoint follows
    try:
        t0 = time.perf_counter()
        run.resume(parts, ckpt_dir, generator=generator(), device=dev)
        swapped = watcher.wait_for_round(1, timeout_s=60)
        t_swap = time.perf_counter() - t0
        time.sleep(0.05)                   # a few post-swap batches
    finally:
        stop.set()
        th.join(timeout=30)
    assert swapped, "the watcher never saw round 1"

    # post-swap scores must be bit-equal to scoring the new checkpoint
    # directly (the same programs, the same weights)
    probe = test.x[:7]
    via_server = np.stack(
        [f.result(timeout=30).member_scores for f in
         [server.submit(img) for img in probe]], axis=1)
    server.close()
    watcher.stop()
    direct = BucketedScorer(
        cfg, run_state.restore_round(ckpt_dir, 1, device=dev).members,
        max_batch=8, device=dev).score_block(probe)
    assert np.array_equal(via_server, direct), \
        "post-swap serving diverged from the round-1 checkpoint"

    stats = server.stats()
    failed = sum(1 for f in traffic if f.exception(timeout=10) is not None)
    assert failed == 0 and stats.failed == 0 and stats.dropped == 0
    programs = scorer.assert_compile_budget()
    print(f"serve: resumed training wrote round 1; hot swap staged "
          f"{t_swap * 1e3:.0f} ms after the resume started")
    print(f"serve: {stats.completed} requests answered across the swap — "
          f"0 dropped, 0 failed, {programs} programs for "
          f"{len(scorer.ladder.buckets)} buckets, "
          f"p50 {stats.percentile_ms(50):.1f} ms / "
          f"p99 {stats.percentile_ms(99):.1f} ms")
    print("serve: post-swap scores bit-equal to the round-1 checkpoint — "
          "the endpoint now serves the resumed run's Reduce")
    return {"completed": stats.completed, "failed": failed + stats.failed,
            "dropped": stats.dropped, "swaps": stats.swaps,
            "programs": programs, "bitwise": True}


if __name__ == "__main__":
    main()
