"""Serving launcher, LM decode path: batched prefill of a batch of prompts,
then greedy decode of N tokens against the KV cache, reporting prefill
time and tokens/s — the port's counterpart of ``repro.launch.serve``.

  PYTHONPATH=src python -m repro_torch.launch.serve --reduced --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3_8b \\
      --batch 4 --prompt-len 128 --gen 32          # on the card

Weights are random, drawn from ``--seed`` on the chosen device. As in the
reference, the prompt is prefilled once (timed), then replayed token by
token into a fresh cache sized for prompt + generation, and decoding
continues from the replay's last logits. The CNN-ELM ensemble endpoint
(``--ensemble``: continuous batching, the scheduler, hot reload) is not
ported yet.
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch import resolve_device
from repro_torch.configs import get_config, get_reduced_config
from repro_torch.core import trainer
from repro_torch.models import api


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def run_lm(args) -> dict:
    dev = resolve_device(args.device)
    cfg = get_reduced_config(args.arch) if args.reduced else get_config(args.arch)

    gen = torch.Generator(device=dev).manual_seed(args.seed)
    params = api.init_params(cfg, gen, device=dev)
    prompts = torch.randint(0, cfg.vocab_size, (args.batch, args.prompt_len),
                            generator=gen, device=dev)

    prefill_fn = trainer.make_prefill_step(cfg)
    serve_fn = trainer.make_serve_step(cfg)

    _sync(dev)
    t0 = time.perf_counter()
    prefill_logits, cache = prefill_fn(params, {"tokens": prompts})
    _sync(dev)
    t_prefill = time.perf_counter() - t0
    logits = prefill_logits

    # the prefill cache covers the prompt only; as the reference does, a
    # fresh cache sized for prompt + generation is filled by replaying the
    # prompt one token at a time
    total = args.prompt_len + args.gen
    cache = api.init_cache(cfg, args.batch, total, device=dev)
    for t in range(args.prompt_len):
        logits, cache = serve_fn(params, cache, prompts[:, t:t + 1], t)
    replay_gap = float((logits - prefill_logits).abs().max())

    tok = torch.argmax(logits[:, -1:], dim=-1)
    generated = [tok]
    _sync(dev)
    t0 = time.perf_counter()
    for t in range(args.gen - 1):
        logits, cache = serve_fn(params, cache, tok, args.prompt_len + t)
        tok = torch.argmax(logits[:, -1:], dim=-1)
        generated.append(tok)
    _sync(dev)
    t_decode = time.perf_counter() - t0

    out = torch.cat(generated, dim=1).cpu().numpy()
    tps = args.batch * (args.gen - 1) / max(t_decode, 1e-9)
    print(f"# arch={cfg.name} batch={args.batch} prompt={args.prompt_len} "
          f"gen={args.gen} device={dev}")
    print(f"# prefill: {t_prefill*1e3:.1f} ms   decode: {tps:.1f} tok/s")
    print("# sample token ids:", out[0, :16].tolist())
    assert (out >= 0).all()
    return {"prefill_ms": t_prefill * 1e3, "tokens_per_s": tps,
            "tokens": out, "vocab_size": cfg.vocab_size,
            "prefill_replay_gap": replay_gap,
            "max_abs_logit": float(prefill_logits.abs().max()),
            "logits_finite": bool(torch.isfinite(prefill_logits).all()
                                  and torch.isfinite(logits).all())}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3_8b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu, the plain PyTorch path")
    # LM decode path
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--greedy", action="store_true", default=True)
    ap.add_argument("--ensemble", action="store_true",
                    help="the CNN-ELM ensemble endpoint (not ported yet)")
    args = ap.parse_args(argv)
    if args.ensemble:
        raise NotImplementedError(
            "--ensemble: EnsembleServer, the scheduler and hot reload are not "
            "ported yet (ROADMAP queue 1 item 9); BucketedScorer is "
            "(repro_torch.serve)")
    return run_lm(args)


if __name__ == "__main__":
    main()
