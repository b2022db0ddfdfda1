#!/usr/bin/env python3
"""The LM train step of two checkouts of the port, timed in turns on one
card.

    python3 tools/train_step_turns.py OTHER [--turns 4] [--steps 8]

OTHER is the root of another checkout (for example the parent commit
unpacked by ``git archive`` into a directory under ``build/``). Both
checkouts' kernels are built first, side by side. Then ``--turns``
processes run one after another in the order this, OTHER, OTHER, this,
this, OTHER, ...; each imports ``repro_torch`` from its own checkout's
``src/`` and times, on the host clock with the card synchronised after
every step:

1. the member step of ``chip_smoke.py``'s phase ``train``: qwen3_8b at full
   width cut to 4 layers, bf16, AdamW, cosine, batch 4 × 128 on one
   repeated batch: one warm step, then ``--steps`` steps, then one more
   under torch.profiler: the device's busy time and idle share, and the
   ten host operations with the most self CPU time;
2. the full-depth step of that phase: all 36 layers, SGD at lr 1e-2: the
   first (cold) step, as ``chip_smoke.py`` times it, then ``--steps``
   steps.

Prints one JSON line per process, one line of medians, least and most by
checkout, then the card's name and power limit. Needs a CUDA card, nvcc and
the memory of an 80 GB card.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LAYERS, BATCH, SEQ = 4, 4, 128
HORIZON = 4     # the cosine schedule's steps, as in chip_smoke.py


def worker(root, steps):
    """Time the steps with ``root``'s port; print one JSON line."""
    sys.path.insert(0, os.path.join(root, "src"))
    import torch
    from torch.profiler import ProfilerActivity, profile
    import repro_torch
    from repro_torch import kernels, optim
    from repro_torch.configs import get_config, replace
    from repro_torch.core import trainer
    from repro_torch.launch import train as launch
    from repro_torch.models import api

    if not repro_torch.__file__.startswith(os.path.join(root, "src")):
        raise RuntimeError(f"repro_torch came from {repro_torch.__file__}")
    dev = torch.device("cuda")
    kernels.library()

    def batch(cfg, gen):
        toks = torch.randint(0, cfg.vocab_size, (BATCH, SEQ + 1),
                             generator=gen, device=dev)
        return {"tokens": toks[:, :-1], "targets": toks[:, 1:]}

    def timed(step, state, b):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state = step(*state, b)
        torch.cuda.synchronize()
        return state, (time.perf_counter() - t0) * 1e3

    # (1) the member step
    cfg = replace(get_config("qwen3_8b"), num_layers=LAYERS)
    opt = optim.adamw()
    step = trainer.make_train_step(cfg, opt, launch.make_schedule(
        launch.parse_args(["--optimizer", "adamw", "--schedule", "cosine",
                           "--batch", str(BATCH), "--seq", str(SEQ),
                           "--steps", str(HORIZON), "--device", "cuda"])))
    gen = torch.Generator(device=dev).manual_seed(0)
    p = api.init_params(cfg, gen, device=dev)
    b = batch(cfg, gen)
    state, _ = timed(step, (p, opt.init(p), 0), b)
    member_ms = []
    for _ in range(steps):
        state, ms = timed(step, state[:3], b)
        member_ms.append(ms)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        state, prof_ms = timed(step, state[:3], b)
    events = prof.key_averages()
    busy = sum(e.self_device_time_total for e in events
               if e.device_type == torch.autograd.DeviceType.CUDA) / 1e3
    host = sorted(((e.self_cpu_time_total / 1e3, e.key, e.count)
                   for e in events
                   if e.device_type == torch.autograd.DeviceType.CPU),
                  reverse=True)[:10]
    del p, b, state, prof, events
    torch.cuda.empty_cache()

    # (2) the full-depth step
    dcfg = get_config("qwen3_8b")
    gen = torch.Generator(device=dev).manual_seed(1)
    p = api.init_params(dcfg, gen, device=dev)
    b = batch(dcfg, gen)
    step = trainer.make_train_step(dcfg, optim.sgd(), optim.constant(1e-2))
    state, cold_ms = timed(step, (p, (), 0), b)
    deep_ms = []
    for _ in range(steps):
        state, ms = timed(step, state[:3], b)
        deep_ms.append(ms)
    print(json.dumps({
        "root": root, "member_step_ms": member_ms,
        "member_step_profiled_ms": prof_ms, "device_busy_ms": busy,
        "idle_share_profiled": 1 - busy / prof_ms,
        "idle_share_unprofiled": 1 - min(busy / statistics.median(member_ms),
                                         1.0),
        "host_top_self_cpu": [{"name": name[:60], "ms": ms, "count": n}
                              for ms, name, n in host],
        "full_depth_cold_ms": cold_ms, "full_depth_step_ms": deep_ms}),
        flush=True)


def spread(values):
    return {"median": statistics.median(values), "min": min(values),
            "max": max(values), "n": len(values)}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("other", help="root of the other checkout")
    ap.add_argument("--turns", type=int, default=4)
    ap.add_argument("--steps", type=int, default=8)
    ap.add_argument("--worker", action="store_true", help=argparse.SUPPRESS)
    ap.add_argument("--build", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    root = os.path.abspath(args.other)
    if args.build:
        sys.path.insert(0, os.path.join(root, "src"))
        from repro_torch import kernels
        kernels.library()
        return
    if args.worker:
        worker(root, args.steps)
        return
    import torch
    if not torch.cuda.is_available():
        sys.exit("train_step_turns needs a CUDA card")
    roots = {"this": ROOT, "other": root}
    builds = [subprocess.Popen([sys.executable, __file__, r, "--build"])
              for r in roots.values()]
    if any(proc.wait() for proc in builds):
        sys.exit("a build failed")
    runs = {tag: [] for tag in roots}
    for turn in range(args.turns):
        tag = ("this", "other", "other", "this")[turn % 4]
        out = subprocess.run(
            [sys.executable, __file__, roots[tag], "--worker", "--steps",
             str(args.steps)], stdout=subprocess.PIPE, text=True, check=True)
        rec = dict(json.loads(out.stdout.strip().splitlines()[-1]),
                   checkout=tag, turn=turn)
        runs[tag].append(rec)
        print(json.dumps(rec), flush=True)
    print(json.dumps({tag: {
        "member_step_ms": spread([ms for r in recs
                                  for ms in r["member_step_ms"]]),
        "full_depth_step_ms": spread([ms for r in recs
                                      for ms in r["full_depth_step_ms"]]),
        "full_depth_cold_ms": [r["full_depth_cold_ms"] for r in recs],
        "device_busy_ms": [r["device_busy_ms"] for r in recs],
        "idle_share_profiled": [r["idle_share_profiled"] for r in recs],
        "idle_share_unprofiled": [r["idle_share_unprofiled"] for r in recs]}
        for tag, recs in runs.items()}), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)


if __name__ == "__main__":
    main()
