#!/usr/bin/env python3
"""The host cost of the mesh context on one card: Qwen3-8B's prefill and
decode steps, plain and under a world-1 mesh, in turns.

    python3 tools/mesh_overhead.py [--rounds 4] [--steps 20]

The LM decode is host-bound, so what the mesh context adds to a step's
host time shows in tokens/s (``chip_smoke.py`` phase ``lm_mesh`` against
phase ``lm``). This serves the full qwen3_8b in bf16 at batch 4 (a
128-token prompt, a cache of 160): one prefill, then ``--steps`` decode
steps after two warm ones, first with no process group (``no_group``),
then with a world-1 NCCL group and its (data 1 × model 1) mesh up, in
turns within each of ``--rounds`` rounds: ``plain`` (no context) and
``mesh`` (under ``use_mesh_rules``; its axes of size 1 send nothing),
the first of the two alternating from round to round. Prints one JSON
line: the median prefill ms and decode-step ms of each (host clock, each
ending in a synchronise), whether every run's prefill and last logits
are bitwise the first's, the collectives the mesh runs called (none
expected), and the card's name and power limit. Needs a CUDA card and
nvcc.
"""
import argparse
import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--rounds", type=int, default=4)
    ap.add_argument("--steps", type=int, default=20)
    args = ap.parse_args(argv)

    import torch
    from repro_torch import kernels
    from repro_torch.configs import get_config
    from repro_torch.distributed import collectives, ctx
    from repro_torch.launch.mesh import make_lm_mesh, process_group
    from repro_torch.models import api

    if not torch.cuda.is_available():
        raise SystemExit("mesh_overhead needs a CUDA card")
    dev = torch.device("cuda")
    kernels.library()
    cfg = get_config("qwen3_8b")
    gen = torch.Generator(device=dev).manual_seed(0)
    params = api.init_params(cfg, gen, device=dev)
    prompts = torch.randint(0, cfg.vocab_size, (4, 128), generator=gen,
                            device=dev)

    def serve():
        """(prefill ms, decode ms a step, prefill logits, last logits)."""
        p = ctx.shard_params(params, api.logical_axes(cfg))
        batch = ctx.place({"tokens": prompts}, {"tokens": ("batch", "seq")})
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        first, _ = api.prefill(cfg, p, batch)
        torch.cuda.synchronize()
        prefill_ms = (time.perf_counter() - t0) * 1e3
        cache = api.init_cache(cfg, 4, 160, device=dev)
        tok = batch["tokens"][:, :1]
        for t in range(2):
            api.decode_step(cfg, p, cache, tok, t)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for t in range(2, 2 + args.steps):
            logits, cache = api.decode_step(cfg, p, cache, tok, t)
        torch.cuda.synchronize()
        step_ms = (time.perf_counter() - t0) * 1e3 / args.steps
        return prefill_ms, step_ms, first, logits

    times = {"no_group": [], "plain": [], "mesh": []}
    ref = None
    bitwise = True

    def record(name, out):
        nonlocal ref, bitwise
        times[name].append(out[:2])
        if ref is None:
            ref = out[2:]
        bitwise &= all(torch.equal(a, b) for a, b in zip(out[2:], ref))

    record("no_group", serve())
    with process_group(device=dev):
        mesh = make_lm_mesh({"data": 1, "model": 1})
        collectives.reset()
        for r in range(args.rounds):
            for name in (("plain", "mesh") if r % 2 == 0
                         else ("mesh", "plain")):
                if name == "mesh":
                    with ctx.use_mesh_rules(mesh):
                        record(name, serve())
                else:
                    record(name, serve())
        calls = {f"{k}/{label}": n for (k, label), n in
                 collectives.CALLS.items()}

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip().splitlines()[0]
    print(card)
    print(json.dumps({
        "arch": cfg.name, "batch": 4, "prompt": 128, "steps": args.steps,
        "rounds": args.rounds,
        **{f"{name}_prefill_ms": statistics.median(t[0] for t in ts)
           for name, ts in times.items()},
        **{f"{name}_step_ms": statistics.median(t[1] for t in ts)
           for name, ts in times.items()},
        "runs": {name: ts for name, ts in times.items()},
        "logits_bitwise": bitwise, "mesh_collectives": calls,
        "card": card}))


if __name__ == "__main__":
    main()
