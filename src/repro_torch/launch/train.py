"""Training launcher — distributed averaging (the paper's Alg. 1/2) over the
LM, the port's counterpart of ``repro.launch.train``, flag for flag, plus
``--device`` (default ``cuda``; without a card it raises unless
``--device cpu`` is given).

k members train on disjoint token streams with no communication between
averaging events; the weights are averaged every ``--avg-period`` steps
(``--rounds R``: R events spread over ``--steps``), or once at the end.
In one process the members take their steps in turn; the algorithm is the
same. Each step runs forward and backward through the hand kernels on the
card (rmsnorm and swa_attention, both directions).

Sync policies (``--sync-policy``): ``cadence`` is the fixed
``--avg-period``/``--rounds`` contract; ``drift`` averages while ANY
member's ``DriftDetector`` (fed -loss at the pre-update params, i.e.
prequentially) signals drift. ``--drift-at N`` injects a distribution
shift at step N (every member's stream switches domains).
``--ckpt-dir``/``--ckpt-every``/``--resume`` write and read every member's
params and optimizer state in the reference's ``.npz`` format, so a run
either package checkpointed, the other resumes. At the end the average is
evaluated against every member on a held-out IID stream.

Examples:
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3_8b \\
      --reduced --device cpu --steps 20 --members 2 --avg-period 10
  PYTHONPATH=src python -m repro_torch.launch.train --preset lm100m \\
      --steps 200                                   # on the card
"""
from __future__ import annotations

import argparse
import copy
import time

import numpy as np
import torch

from repro_torch import optim, resolve_device
from repro_torch.checkpoint.ckpt import (list_steps, restore_checkpoint,
                                         save_checkpoint)
from repro_torch.configs.base import (ArchConfig, get_config,
                                      get_reduced_config, replace)
from repro_torch.core import trainer
from repro_torch.core.averaging import average_trees
from repro_torch.data.lm_data import TokenDatasetSpec, synthetic_token_batches
from repro_torch.models import api
from repro_torch.stream.drift import DriftDetector

# a ~100M-param dense config for the end-to-end example driver
LM100M = dict(name="lm100m", family="dense", num_layers=12, d_model=768,
              num_heads=12, num_kv_heads=4, head_dim=64, d_ff=2048,
              vocab_size=32768)


def make_cfg(args):
    if args.preset == "lm100m":
        return ArchConfig(**LM100M)
    cfg = get_reduced_config(args.arch) if args.reduced else get_config(
        args.arch)
    if args.seq and cfg.ssm_chunk > args.seq:
        cfg = replace(cfg, ssm_chunk=max(8, args.seq // 4))
    return cfg


def make_optimizer(args):
    return {"adamw": optim.adamw, "sgd": optim.sgd,
            "momentum": optim.momentum}[args.optimizer]()


def make_schedule(args):
    return {
        "constant": lambda: optim.constant(args.lr),
        "cosine": lambda: optim.cosine(args.lr, args.steps,
                                       warmup_steps=max(1, args.steps // 20)),
        "wsd": lambda: optim.wsd(args.lr, max(1, args.steps // 10),
                                 int(args.steps * 0.7),
                                 max(1, args.steps // 5)),
        "dynamic": lambda: optim.dynamic_paper(args.lr),
    }[args.schedule]()


def make_batch_fn(cfg, args, member: int, seed_offset: int = 0):
    """Member-partitioned data stream: disjoint domains when --non-iid
    (the paper's not-MNIST regime), all domains otherwise. A non-zero
    ``seed_offset`` re-seeds the domain mixtures — the --drift-at injected
    distribution shift. Batches land on ``args.device``."""
    spec = TokenDatasetSpec(vocab_size=cfg.vocab_size, seq_len=args.seq,
                            batch_size=args.batch,
                            num_domains=2 * args.members,
                            seed=args.seed + seed_offset)
    domains = [2 * member, 2 * member + 1] if args.non_iid else None
    gen = synthetic_token_batches(spec, member=member, domains=domains)
    dev = resolve_device(args.device)

    def next_batch():
        toks, tgt = next(gen)
        return {"tokens": torch.from_numpy(toks).to(dev),
                "targets": torch.from_numpy(tgt).to(dev)}

    return next_batch


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="qwen3_8b")
    ap.add_argument("--preset", choices=["", "lm100m"], default="")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the hand kernels) or cpu (their plain "
                         "versions)")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--members", type=int, default=2)
    ap.add_argument("--avg-period", type=int, default=0,
                    help="0 = single final average (paper-faithful)")
    ap.add_argument("--rounds", type=int, default=0,
                    help="spread R averaging events over --steps (the "
                         "parallel-SGD rounds contract, same as "
                         "runner.ReduceConfig(rounds=R)); overrides "
                         "--avg-period; 0 = use --avg-period")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--optimizer", choices=["adamw", "sgd", "momentum"],
                    default="adamw")
    ap.add_argument("--schedule", choices=["constant", "cosine", "wsd",
                                           "dynamic"], default="cosine")
    ap.add_argument("--non-iid", action="store_true")
    ap.add_argument("--sync-policy", choices=["cadence", "drift"],
                    default="cadence",
                    help="cadence = --avg-period/--rounds; drift = fire an "
                         "averaging event while any member's DriftDetector "
                         "(fed -loss prequentially) signals concept drift")
    ap.add_argument("--drift-threshold", type=float, default=0.5,
                    help="score drop below the EWMA baseline that flags "
                         "drift (loss units under --sync-policy drift)")
    ap.add_argument("--drift-alpha", type=float, default=0.2)
    ap.add_argument("--drift-warmup", type=int, default=5)
    ap.add_argument("--drift-at", type=int, default=0,
                    help="inject a distribution shift at this step (every "
                         "member's stream re-seeds its domain mixtures); "
                         "0 = no injected shift")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=0,
                    help="checkpoint every N steps (full member train "
                         "state: params + optimizer state, atomic "
                         "tmp-rename into --ckpt-dir; 0 = final save only)")
    ap.add_argument("--resume", action="store_true",
                    help="continue from the latest step checkpoint in "
                         "--ckpt-dir: restores every member's params + "
                         "optimizer state and fast-forwards each data "
                         "stream, so the continuation matches the "
                         "uninterrupted run")
    ap.add_argument("--log-every", type=int, default=5)
    args = ap.parse_args(argv)
    if args.ckpt_every and not args.ckpt_dir:
        raise SystemExit("--ckpt-every needs --ckpt-dir")
    if args.resume and not args.ckpt_dir:
        raise SystemExit("--resume needs --ckpt-dir")
    if args.resume and args.drift_at:
        raise SystemExit("--resume does not replay an injected --drift-at "
                         "shift's stream switch — rerun without --resume")
    if args.drift_at < 0:
        raise SystemExit(f"--drift-at must be >= 0, got {args.drift_at}")
    return args


def _avg_period(args) -> int:
    if not args.rounds:
        return args.avg_period
    if args.rounds < 1:
        raise SystemExit(f"--rounds must be >= 1, got {args.rounds}")
    if args.steps % args.rounds:
        raise SystemExit(f"--steps {args.steps} must split evenly into "
                         f"--rounds {args.rounds}")
    return args.steps // args.rounds


def _restore_member(ckpt_dir, member, step, opt, dev):
    """(params, optimizer state, step) of one member's ``state-<m>`` file;
    nothing else of the file stays referenced."""
    tree, meta = restore_checkpoint(ckpt_dir, f"state-{member}", step,
                                    device=dev)
    p = tree["params"]
    # sgd's state is the empty tuple, which saves nothing: a missing key
    # restores as a fresh (equally empty) init
    o = tree["opt"] if "opt" in tree else opt.init(p)
    return p, o, int(meta["step"])


def run(cfg, args) -> dict:
    """The training loop of ``main`` for a given config (a caller may cut
    one to size with ``configs.base.replace``). Returns ``eval_averaged``,
    ``eval_members``, ``history`` (each step's member losses),
    ``sync_steps`` and ``step_s`` (each step's wall, host clock; a step
    ends by reading every member's loss, so the card has finished it)."""
    dev = resolve_device(args.device)
    opt = make_optimizer(args)
    step_fn = trainer.make_train_step(cfg, opt, make_schedule(args))
    avg_period = _avg_period(args)

    gen = torch.Generator(device=dev).manual_seed(args.seed)
    # one init for every member (Alg. 2 line 3)
    init_params = api.init_params(cfg, gen, device=dev)
    members = [(init_params, opt.init(init_params), 0)
               for _ in range(args.members)]
    del init_params
    batch_fns = [make_batch_fn(cfg, args, m) for m in range(args.members)]

    def save_states(step):
        """Every member's train state (params + optimizer state; the step
        rides the file name and metadata), each file atomic."""
        for m_i, (p, o, _) in enumerate(members):
            save_checkpoint(args.ckpt_dir, f"state-{m_i}", step,
                            {"params": p, "opt": o},
                            {"arch": cfg.name, "members": args.members})

    start_step = 0
    if args.resume:
        # the newest step EVERY member has: the per-member saves are each
        # atomic but not as a set
        common = set(list_steps(args.ckpt_dir, "state-0"))
        for m_i in range(1, args.members):
            common &= set(list_steps(args.ckpt_dir, f"state-{m_i}"))
        if not common:
            raise SystemExit(
                f"--resume: no complete 'state-*' step for all "
                f"{args.members} members in {args.ckpt_dir}")
        last = max(common)
        members = [None] * args.members         # the fresh init lets go
        for m_i in range(args.members):
            members[m_i] = _restore_member(args.ckpt_dir, m_i, last, opt,
                                           dev)
        start_step = last
        # each consumed step drew one batch a member: replay the order
        for fn in batch_fns:
            for _ in range(start_step):
                fn()
        print(f"# resumed from step {start_step} in {args.ckpt_dir}")

    print(f"# arch={cfg.name} params={cfg.param_count() / 1e6:.1f}M "
          f"members={args.members} avg_period={avg_period or 'final'} "
          f"non_iid={args.non_iid} device={dev}")

    def apply_sync(members):
        """One averaging event: the f32 mean, shared by every member."""
        avg = average_trees([m[0] for m in members])
        return [(avg, o, s) for (_, o, s) in members]

    detectors = None
    if args.sync_policy == "drift":
        detectors = [DriftDetector(threshold=args.drift_threshold,
                                   alpha=args.drift_alpha,
                                   warmup=args.drift_warmup)
                     for _ in range(args.members)]

    history, sync_steps, step_s = [], [], []
    t0 = time.time()
    for step in range(start_step, args.steps):
        if args.drift_at and step == args.drift_at:
            batch_fns = [make_batch_fn(cfg, args, m, seed_offset=9973)
                         for m in range(args.members)]
            print(f"# drift injected at step {step}", flush=True)
        t_step = time.perf_counter()
        losses = []
        for m in range(args.members):
            # the list lets go of a member's old state before its step
            # returns the new one: one member's two states at a time
            p, o, s = members[m]
            members[m] = None
            p, o, s, metrics = step_fn(p, o, s, batch_fns[m]())
            members[m] = (p, o, s)
            losses.append(float(metrics["loss"]))
        del p, o
        step_s.append(time.perf_counter() - t_step)
        if detectors is not None:
            # the loss at the PRE-update params on the incoming batch: the
            # prequential score, negated so higher is better
            if any([d.update(-l) for d, l in zip(detectors, losses)]):
                members = apply_sync(members)
                sync_steps.append(step + 1)
        elif avg_period and (step + 1) % avg_period == 0:
            members = apply_sync(members)
            sync_steps.append(step + 1)
        if args.ckpt_every and (step + 1) % args.ckpt_every == 0:
            save_states(step + 1)        # post-update AND post-sync state
        history.append(losses)
        if (step + 1) % args.log_every == 0:
            print(f"step {step + 1:5d} losses=" +
                  " ".join(f"{l:.4f}" for l in losses) +
                  f" ({time.time() - t0:.1f}s)", flush=True)
    if args.sync_policy == "drift":
        print(f"# drift policy fired {len(sync_steps)} syncs at steps "
              f"{sync_steps}")

    averaged = average_trees([m[0] for m in members])
    # the average against the members on a held-out IID stream
    eval_args = copy.copy(args)
    eval_args.non_iid = False
    eval_batch_fn = make_batch_fn(cfg, eval_args, member=10_000)
    eval_batches = [eval_batch_fn() for _ in range(4)]

    def eval_loss(p):
        with torch.no_grad():
            return float(np.mean([float(api.loss_fn(cfg, p, b)[0])
                                  for b in eval_batches]))

    avg_loss = eval_loss(averaged)
    member_losses = [eval_loss(p) for (p, _, _) in members]
    print(f"# eval: averaged={avg_loss:.4f} members=" +
          " ".join(f"{l:.4f}" for l in member_losses))

    if args.ckpt_dir:
        save_checkpoint(args.ckpt_dir, "averaged", args.steps, averaged,
                        {"arch": cfg.name, "eval_loss": avg_loss})
        for i, (p, _, _) in enumerate(members):
            save_checkpoint(args.ckpt_dir, f"member-{i}", args.steps, p)
        print(f"# checkpoints written to {args.ckpt_dir}")

    return {"eval_averaged": avg_loss, "eval_members": member_losses,
            "history": history, "sync_steps": sync_steps, "step_s": step_s}


def main(argv=None):
    args = parse_args(argv)
    return run(make_cfg(args), args)


if __name__ == "__main__":
    main()
