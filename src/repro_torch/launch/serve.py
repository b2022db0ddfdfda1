"""Serving launcher — two paths behind one CLI, the port's counterpart of
``repro.launch.serve``.

**LM decode** (the default): batched prefill of a batch of prompts, then
greedy decode of N tokens against the KV cache, reporting prefill time and
tokens/s.

  PYTHONPATH=src python -m repro_torch.launch.serve --reduced --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3_8b \\
      --batch 4 --prompt-len 128 --gen 32          # on the card

Weights are random, drawn from ``--seed`` on the chosen device. Under a
mesh context (``distributed.ctx.use_mesh_rules`` on a
``launch.mesh.make_lm_mesh`` mesh, one process a rank) ``run_lm`` serves
this rank's blocks of the model, the prompts and the cache (the
transformer families). It draws the whole model on each rank first and
then keeps the rank's blocks, so it serves only a model that fits one
card: the same model as without a mesh, from the same seed. A model
larger than a card is served from its blocks alone, drawn per rank
(``launch.dryrun.mesh_step_args``) or cut from its whole tree on the
host (``convert.lm_shard_from_numpy``); a launcher that serves it so
is queued (ROADMAP queue 1). As in the
reference, the prompt is prefilled once (timed); for the transformer
decoders it is then replayed token by token into a fresh cache sized for
prompt + generation, and decoding continues from the replay's last
logits, while the recurrent families (``rwkv6_3b``, ``zamba2_1p2b``)
decode straight from the prefill's state, with no replay (Zamba2's shared
attention then sees the prompt's length of positions: ROADMAP R7). A
config whose ``ssm_chunk`` exceeds the prompt runs with chunks of
max(8, prompt // 4), as the reference shrinks them. ``--arch`` takes the
decoders (dense, MoE, RWKV6, Zamba2); as in the reference, an
encoder-only config (``hubert_xlarge``) is refused and the launcher feeds
tokens only, so the VLM (``internvl2_26b``) is served through
``models.api`` with its patches. For the MoE the replay's last logits
need not equal the prefill's: a slot dropped at the prompt's capacity is
kept at one token's.

**CNN-ELM ensemble** (``--ensemble``): the ``repro_torch.serve`` endpoint —
continuous batching under a latency SLO over a ``BucketedScorer`` (one
captured CUDA graph per bucket on the card), driven by the open-loop load
generator; with ``--ckpt-dir`` it serves a training run's newest
``round-<r>.npz`` and hot-reloads newer rounds live.

  # train k members, then serve synthetic open-loop load
  PYTHONPATH=src python -m repro_torch.launch.serve --ensemble --k 4 \\
      --rate 200 --requests 400
  # track a live training run's checkpoints
  PYTHONPATH=src python -m repro_torch.launch.serve --ensemble \\
      --ckpt-dir /path/to/run --rate 200 --requests 400
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch import resolve_device
from repro_torch.configs import get_config, get_reduced_config, replace
from repro_torch.core import trainer
from repro_torch.distributed import ctx
from repro_torch.models import api


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def run_lm(args) -> dict:
    dev = resolve_device(args.device)
    cfg = get_reduced_config(args.arch) if args.reduced else get_config(args.arch)
    if cfg.is_encoder_only:
        raise SystemExit(f"{cfg.name} is encoder-only: no decode step")
    if cfg.ssm_chunk > args.prompt_len:
        cfg = replace(cfg, ssm_chunk=max(8, args.prompt_len // 4))

    gen = torch.Generator(device=dev).manual_seed(args.seed)
    params = api.init_params(cfg, gen, device=dev)
    prompts = torch.randint(0, cfg.vocab_size, (args.batch, args.prompt_len),
                            generator=gen, device=dev)
    # under a mesh context, this rank's blocks of the model and the prompts
    params = ctx.shard_params(params, api.logical_axes(cfg))
    prompts = ctx.place({"tokens": prompts},
                        {"tokens": ("batch", "seq")})["tokens"]

    prefill_fn = trainer.make_prefill_step(cfg)
    serve_fn = trainer.make_serve_step(cfg)

    _sync(dev)
    t0 = time.perf_counter()
    prefill_logits, cache = prefill_fn(params, {"tokens": prompts})
    _sync(dev)
    t_prefill = time.perf_counter() - t0
    logits = prefill_logits

    # a transformer's prefill cache covers the prompt only; as the
    # reference does, a fresh cache sized for prompt + generation is filled
    # by replaying the prompt one token at a time. The recurrent families
    # decode from the prefill's state.
    replay_gap = None
    if cfg.family in ("dense", "moe", "vlm"):
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
            "prefill_logits": prefill_logits, "last_logits": logits,
            "prefill_replay_gap": replay_gap,
            "max_abs_logit": float(prefill_logits.abs().max()),
            "logits_finite": bool(torch.isfinite(prefill_logits).all()
                                  and torch.isfinite(logits).all())}


def run_ensemble(args) -> dict:
    """The CNN-ELM ensemble endpoint: serve from ``--ckpt-dir`` (hot-
    reloading newer rounds) or from a freshly trained k-member stacked run,
    then offer open-loop load and report tail latency."""
    from repro_torch.checkpoint import run_state
    from repro_torch.core.runner import AveragingRun, MapConfig, ReduceConfig
    from repro_torch.data.partition import partition_iid
    from repro_torch.data.synthetic import make_extended_mnist
    from repro_torch.serve import (BucketedScorer, CheckpointWatcher,
                                   EnsembleServer, ServeConfig,
                                   run_open_loop)

    dev = resolve_device(args.device)
    cfg = get_reduced_config(args.arch) if args.reduced else get_config(args.arch)
    if cfg.family != "cnn":
        raise SystemExit(f"--ensemble serves CNN-ELM archs; {cfg.name} is "
                         f"family {cfg.family!r} (drop --ensemble for the "
                         "LM decode path)")
    ds = make_extended_mnist(n_per_class=60, seed=args.seed)
    train, test = ds.split(n_test=200)

    watcher = None
    if args.ckpt_dir:
        r = run_state.latest_ready_round(args.ckpt_dir)
        if r is None:
            raise SystemExit(f"no fully-written round-<r>.npz in "
                             f"{args.ckpt_dir}")
        members = run_state.restore_round(args.ckpt_dir, r, dev).members
        print(f"# serving round {r} from {args.ckpt_dir} "
              f"(k={members.k}, hot-reload on)")
    else:
        result = AveragingRun(
            cfg, MapConfig(epochs=0, batch_size=200, backend="stacked"),
            ReduceConfig()).run(
                partition_iid(train.x, train.y, args.k),
                generator=torch.Generator().manual_seed(args.seed),
                device=dev)
        members = result.stacked
        print(f"# trained k={args.k} members in {result.wall_time_s:.1f}s")

    scorer = BucketedScorer(cfg, members, max_batch=args.max_batch,
                            device=dev)
    server = EnsembleServer(scorer, ServeConfig(
        max_batch=args.max_batch, max_wait_ms=args.max_wait_ms,
        combine=args.combine)).start()
    try:
        if args.ckpt_dir:
            watcher = CheckpointWatcher(args.ckpt_dir, server,
                                        poll_ms=args.poll_ms,
                                        start_round=r).start()
        print(f"# buckets {scorer.ladder.buckets} — "
              f"{scorer.compile_count()} programs (one per bucket, pinned)")
        rep = run_open_loop(server, test.x, rate_per_s=args.rate,
                            n_requests=args.requests, seed=args.seed)
    finally:
        if watcher is not None:
            watcher.stop()
        server.close()
    stats = server.stats()
    scorer.assert_compile_budget()
    swaps = len(watcher.swaps) if watcher is not None else 0
    print(f"# device={dev} offered {rep.offered_per_s:.0f}/s → achieved "
          f"{rep.achieved_per_s:.0f} imgs/s   p50 {rep.p50_ms:.2f} ms  "
          f"p95 {rep.p95_ms:.2f} ms  p99 {rep.p99_ms:.2f} ms")
    print(f"# {stats.completed} answered, {stats.failed} failed, "
          f"{stats.dropped} dropped, {swaps} hot swaps, "
          f"mean batch occupancy {stats.mean_occupancy:.1f}")
    return {"images_per_s": rep.achieved_per_s, "p50_ms": rep.p50_ms,
            "p95_ms": rep.p95_ms, "p99_ms": rep.p99_ms,
            "completed": stats.completed, "failed": stats.failed,
            "dropped": stats.dropped, "mean_occupancy": stats.mean_occupancy,
            "compile_count": stats.compile_count, "swaps": swaps,
            "device": str(dev)}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None,
                    help="default: qwen3_8b (LM) / cnn_elm_6c12c "
                         "(--ensemble)")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu, the plain PyTorch path")
    # LM decode path
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--greedy", action="store_true", default=True)
    # CNN-ELM ensemble path
    ap.add_argument("--ensemble", action="store_true",
                    help="serve a CNN-ELM ensemble (repro_torch.serve) "
                         "instead of LM decode")
    ap.add_argument("--k", type=int, default=4,
                    help="members to train when no --ckpt-dir is given")
    ap.add_argument("--ckpt-dir", default=None,
                    help="serve (and hot-reload) a training run's "
                         "round-<r>.npz checkpoints")
    ap.add_argument("--max-batch", type=int, default=32)
    ap.add_argument("--max-wait-ms", type=float, default=5.0)
    ap.add_argument("--combine", default="mean", choices=("mean", "vote"))
    ap.add_argument("--poll-ms", type=float, default=50.0)
    ap.add_argument("--rate", type=float, default=200.0,
                    help="offered open-loop load, images/s")
    ap.add_argument("--requests", type=int, default=400)
    args = ap.parse_args(argv)
    if args.arch is None:
        args.arch = "cnn_elm_6c12c" if args.ensemble else "qwen3_8b"
    return run_ensemble(args) if args.ensemble else run_lm(args)


if __name__ == "__main__":
    main()
