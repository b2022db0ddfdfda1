#!/usr/bin/env python3
"""How sensitive the CNN-ELM's f32 SGD epochs are, on the card and on the
CPU — the measurements behind the SGD bars of ``chip_smoke.py``.

    python3 tools/sgd_sensitivity.py [--rows 2500]

At full width (cnn_elm_6c12c, L = 192, λ = 100; k = 4 shards of the
synthetic extended MNIST, batch 200, dynamic_paper(0.05)) it prints one
JSON line each for:

* ``solve``   — a member-batched Cholesky β solve of k = 4 members against
  the same members solved one at a time (what the port's
  ``core/elm.py`` does): how far apart the library's two roundings land.
* ``step``    — one SGD step from a shared state, all k members at once
  against each member alone: which pieces (H, U, V, β, the loss, the
  gradients) are bitwise the same.
* ``divergence`` — by epochs, on all the data: the card's sequential
  against its stacked Map, the stacked Map against itself, and against
  itself from initial weights one f32 ulp up.
* ``cut``     — by steps, on the first ``--rows`` rows of each shard: the
  card against the CPU, and the CPU against itself from initial weights
  one f32 ulp up (the measure ``chip_smoke.py`` takes its bars from).

Distances are max|a − b| / max|b| over each CNN leaf, the largest leaf's.
Needs a card; builds the kernels like ``chip_smoke.py``.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rows", type=int, default=2500)
    args = ap.parse_args(argv)

    import numpy as np
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: this tool measures the card")
    import repro_torch  # noqa: F401  (TF32 off)
    from repro_torch.configs import get_config
    from repro_torch.core import elm
    from repro_torch.core.runner import AveragingRun, MapConfig
    from repro_torch.data.partition import (Partition, partition_iid,
                                            padded_stacked_epoch_batches)
    from repro_torch.data.synthetic import make_extended_mnist, one_hot
    from repro_torch.models import cnn
    from repro_torch.optim.schedules import dynamic_paper
    from repro_torch.tree import tree_leaves, tree_map

    def emit(what, **fields):
        print(json.dumps({"what": what, **fields}), flush=True)

    dev = torch.device("cuda")
    cfg = get_config("cnn_elm_6c12c")
    train, _ = make_extended_mnist(n_per_class=1500, seed=0).split(10_000)
    k, batch = 4, 200
    parts = partition_iid(train.x, train.y, k)
    init = cnn.init_params(cfg, torch.Generator().manual_seed(0),
                           device="cpu")
    twin = tree_map(lambda a: torch.nextafter(
        a, torch.full_like(a, float("inf"))), init)
    emit("card", name=torch.cuda.get_device_name(0))

    # one step from a shared state: the first batch of every member
    xs, ys, _ = padded_stacked_epoch_batches(
        parts, batch, [np.random.default_rng(1000 + i) for i in range(k)])
    x = torch.from_numpy(xs[:, 0]).to(dev)
    t = torch.from_numpy(one_hot(ys[:, 0].reshape(-1), 10)
                         .reshape(k, batch, 10)).to(dev)
    params_k = tree_map(lambda a: a.to(dev)[None].expand(
        (k,) + tuple(a.shape)).contiguous(), init)

    def pieces(p_k, xb, tb):
        p = tree_map(lambda a: a.detach().requires_grad_(True), p_k)
        h = cnn.features_members(cfg, p, xb)
        st = elm.batch_stats(h.detach(), tb)
        beta = elm.solve_beta(st, cfg.elm_lambda)
        loss = elm.member_losses(h, beta, tb)
        grads = torch.autograd.grad(loss.sum(), tree_leaves(p))
        return dict(h=h.detach(), u=st.u, v=st.v, beta=beta,
                    loss=loss.detach(),
                    **{f"grad{i}": g for i, g in enumerate(grads)}), st

    full, st = pieces(params_k, x, t)
    a = st.u + torch.eye(st.u.shape[-1], device=dev) / cfg.elm_lambda
    f, _ = torch.linalg.cholesky_ex(a)
    batched = torch.linalg.solve_triangular(
        f.mT, torch.linalg.solve_triangular(f, st.v, upper=False),
        upper=True)
    emit("solve", batched_vs_one_at_a_time=float(
        (batched - full["beta"]).abs().max() / full["beta"].abs().max()),
        cond=float(torch.linalg.cond(a.double()).max()))
    same = {}
    for i in range(k):
        one, _ = pieces(tree_map(lambda a: a[i:i + 1].contiguous(),
                                 params_k),
                        x[i:i + 1].contiguous(), t[i:i + 1].contiguous())
        for name, val in one.items():
            same.setdefault(name, []).append(
                bool(torch.equal(val, full[name][i:i + 1])))
    emit("step", bitwise_k4_vs_alone=same)

    def run(backend, epochs, init_params, device, shards):
        return AveragingRun(cfg, MapConfig(
            epochs=epochs, lr_schedule=dynamic_paper(0.05),
            batch_size=batch, backend=backend)).run(
            shards, init_params=init_params, device=device)

    def dist(a, b):
        return max(float((p.cpu() - q.cpu()).abs().max())
                   / float(q.abs().max())
                   for p, q in zip(tree_leaves(a.stacked.cnn_params),
                                   tree_leaves(b.stacked.cnn_params)))

    for epochs in (1, 2):
        s = run("stacked", epochs, init, dev, parts)
        emit("divergence", epochs=epochs,
             sequential_vs_stacked=dist(run("sequential", epochs, init,
                                            dev, parts), s),
             stacked_again=dist(run("stacked", epochs, init, dev, parts), s),
             stacked_from_one_ulp_up=dist(run("stacked", epochs, twin, dev,
                                              parts), s))

    cut = [Partition(p.x[:args.rows], p.y[:args.rows]) for p in parts]
    for rows in sorted({batch, args.rows}):
        shards = [Partition(p.x[:rows], p.y[:rows]) for p in cut]
        for epochs in (1, 2):
            cpu = run("stacked", epochs, init, "cpu", shards)
            emit("cut", rows=rows, steps=epochs * (rows // batch),
                 card_vs_cpu=dist(run("stacked", epochs, init, dev, shards),
                                  cpu),
                 cpu_from_one_ulp_up=dist(run("stacked", epochs, twin, "cpu",
                                              shards), cpu))


if __name__ == "__main__":
    main()
