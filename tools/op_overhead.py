#!/usr/bin/env python3
"""The host cost of one rmsnorm call on the card, four ways, in one process.

    python3 tools/op_overhead.py [--rounds 7] [--calls 3000] [--decode]

The hand kernels are reached through ``torch.library`` operators
(``kernels.register``: ``Library.define``, ``impl(..., "CUDA")`` and
``register_fake``). The LM decode is host-bound (145 rmsnorm calls in one
qwen3_8b forward), so each call's host cost counts. At the decode's shape
(x 4 × 1 × 4096 bf16, scale f32) this times, in turns within each round:

* ``direct``: the route before the operators — ``torch.empty_like``, then
  the ctypes launch under ``torch.cuda.device`` (``kernels.launch``);
* ``library_op``: the registered operator (``rmsnorm.ops._FWD``);
* ``custom_op``: the same body behind ``torch.library.custom_op`` (with a
  ``register_fake``), the other registration the port could use;
* ``wrapper``: ``rmsnorm.ops.rmsnorm``, the public call the model makes
  (checks, routing and the operator).

Each round calls each way ``--calls`` times and synchronises the card;
prints the median µs per call over the rounds (host clock) for each way,
the operator's cost over the direct call, whether all four outputs are
bitwise equal, and the card's name and power limit. With ``--decode``,
also one decode step of the full qwen3_8b in bf16 (batch 4, a cache of
160, as phase ``lm`` serves it), with rmsnorm's forward through the
operator and through the direct call in turns (``--rounds`` rounds of 20
steps each): the median ms a step, and whether the two routes' logits
are bitwise equal. Needs a CUDA card and nvcc.
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
    ap.add_argument("--rounds", type=int, default=7)
    ap.add_argument("--calls", type=int, default=3000)
    ap.add_argument("--decode", action="store_true")
    args = ap.parse_args(argv)

    import torch
    from repro_torch import kernels
    from repro_torch.kernels.rmsnorm import ops as rms_ops

    if not torch.cuda.is_available():
        raise SystemExit("op_overhead needs a CUDA card")
    dev = torch.device("cuda")
    kernels.library()
    gen = torch.Generator().manual_seed(0)
    x = torch.randn((4, 1, 4096), generator=gen).to(dev, torch.bfloat16)
    scale = (1 + 0.1 * torch.randn(4096, generator=gen)).to(dev)
    eps = 1e-6
    n, D = 4, 4096
    dt = rms_ops._DTYPES

    def direct():
        out = torch.empty_like(x)
        with torch.cuda.device(x.device):
            kernels.launch("rmsnorm", x.data_ptr(), scale.data_ptr(),
                           out.data_ptr(), n, D, eps, dt[x.dtype],
                           dt[scale.dtype])
        return out

    @torch.library.custom_op("repro_overhead_probe::rmsnorm",
                             mutates_args=(), device_types="cuda")
    def probe(a: torch.Tensor, s: torch.Tensor, e: float) -> torch.Tensor:
        out = torch.empty_like(a)
        with torch.cuda.device(a.device):
            kernels.launch("rmsnorm", a.data_ptr(), s.data_ptr(),
                           out.data_ptr(), n, D, e, dt[a.dtype],
                           dt[s.dtype])
        return out

    @probe.register_fake
    def _(a, s, e):
        return torch.empty_like(a)

    ways = {"direct": direct,
            "library_op": lambda: rms_ops._FWD(x, scale, eps),
            "custom_op": lambda: probe(x, scale, eps),
            "wrapper": lambda: rms_ops.rmsnorm(x, scale, eps=eps)}
    outs = {name: fn() for name, fn in ways.items()}
    torch.cuda.synchronize()
    bitwise = all(torch.equal(o, outs["direct"]) for o in outs.values())
    times = {name: [] for name in ways}
    for _ in range(args.rounds):
        for name, fn in ways.items():
            for _ in range(100):
                fn()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(args.calls):
                fn()
            torch.cuda.synchronize()
            times[name].append((time.perf_counter() - t0) * 1e6 / args.calls)
    med = {name: statistics.median(v) for name, v in times.items()}
    decode = decode_steps(torch, rms_ops, args.rounds) if args.decode \
        else None
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(json.dumps({
        "shape": "x (4, 1, 4096) bf16, scale f32",
        "rounds": args.rounds, "calls": args.calls,
        "us_per_call_median": med,
        "us_per_call_rounds": times,
        "library_op_minus_direct_us": med["library_op"] - med["direct"],
        "custom_op_minus_direct_us": med["custom_op"] - med["direct"],
        "bitwise_equal": bitwise, "decode_step": decode, "card": card}))
    if not bitwise or (decode and not decode["bitwise_equal"]):
        raise SystemExit("the routes disagree")


def decode_steps(torch, rms_ops, rounds, steps=20, batch=4, cache=160):
    """Median ms a decode step of the full qwen3_8b, rmsnorm's forward
    through the operator and through the direct ctypes call, in turns."""
    from repro_torch import kernels
    from repro_torch.configs import get_config
    from repro_torch.models import api

    dev = torch.device("cuda")
    cfg = get_config("qwen3_8b")
    g = torch.Generator(device=dev).manual_seed(0)
    params = api.init_params(cfg, g, device=dev)
    kv = api.init_cache(cfg, batch, cache, device=dev)
    tok = torch.randint(0, cfg.vocab_size, (batch, 1), generator=g,
                        device=dev)
    operator = rms_ops._forward

    def direct(x, scale, eps):
        n, D = rms_ops._fwd_checks(x, scale)
        out = torch.empty_like(x)
        with torch.cuda.device(x.device):
            kernels.launch("rmsnorm", x.data_ptr(), scale.data_ptr(),
                           out.data_ptr(), n, D, float(eps),
                           rms_ops._DTYPES[x.dtype],
                           rms_ops._DTYPES[scale.dtype])
        return out

    times = {"operator": [], "direct": []}
    logits = {}
    try:
        for _ in range(rounds):
            for name, fwd in (("operator", operator), ("direct", direct)):
                rms_ops._forward = fwd
                for t in range(3):
                    api.decode_step(cfg, params, kv, tok, t)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for t in range(steps):
                    out, _ = api.decode_step(cfg, params, kv, tok, 100)
                torch.cuda.synchronize()
                times[name].append((time.perf_counter() - t0) * 1e3 / steps)
                logits[name] = out
    finally:
        rms_ops._forward = operator
    med = {k: statistics.median(v) for k, v in times.items()}
    return {"ms_per_step_median": med, "ms_per_step_rounds": times,
            "operator_minus_direct_ms": med["operator"] - med["direct"],
            "bitwise_equal": bool(torch.equal(logits["operator"],
                                              logits["direct"]))}


if __name__ == "__main__":
    main()
