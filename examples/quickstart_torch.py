"""Quickstart on the PyTorch/CUDA port — the paper in one script.

Distributed Averaging CNN-ELM (Algorithm 2) on the synthetic extended-MNIST
analogue: partition the data onto k 'machines', train a CNN-ELM on each
with one SGD epoch at the paper's dynamic rate α = 0.05 / e (the Map, all
members stacked), average every weight (the Reduce), and compare against
the monolithic model. The members are scored through the batched
``Ensemble`` surface. On the card every convolution, its gradient and the
ELM statistics go through the port's hand-written CUDA kernels; on the CPU
through their plain PyTorch versions.

  PYTHONPATH=src python examples/quickstart_torch.py               # the card
  PYTHONPATH=src python examples/quickstart_torch.py --device cpu
"""
import argparse

import torch

from repro_torch import kernels
from repro_torch.configs import get_config
from repro_torch.core import cnn_elm
from repro_torch.core.runner import (AveragingRun, MapConfig, ReduceConfig,
                                     evaluate_model)
from repro_torch.data.partition import partition_iid
from repro_torch.data.synthetic import make_extended_mnist
from repro_torch.models import cnn
from repro_torch.optim.schedules import dynamic_paper
from repro_torch.tree import tree_map


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (the default) or 'cpu'")
    ap.add_argument("--n-per-class", type=int, default=100)
    args = ap.parse_args(argv)
    dev = args.device

    cfg = get_config("cnn_elm_6c12c")          # the paper's Table-4 model
    ds = make_extended_mnist(n_per_class=args.n_per_class)
    train, test = ds.split(n_test=500)

    k = 4
    parts = partition_iid(train.x, train.y, k)
    print(f"{len(train.x)} training examples -> {k} machines "
          f"x {len(parts[0].x)} examples")

    init = cnn.init_params(cfg, torch.Generator().manual_seed(0),
                           device="cpu")
    lr = dynamic_paper(0.05)
    kernels.reset_launches()
    result = AveragingRun(
        cfg,
        MapConfig(epochs=1, lr_schedule=lr, batch_size=200,
                  backend="stacked"),
        ReduceConfig(),                        # uniform mean, rounds=1
    ).run(parts, init_params=init, device=dev)
    launches = dict(kernels.LAUNCHES)

    mono = cnn_elm.train_member(
        cfg, tree_map(lambda a: a.to(result.device), init),
        partition_iid(train.x, train.y, 1)[0],
        epochs=1, lr_schedule=lr, batch_size=200)

    print(f"monolithic (1 machine):  "
          f"{evaluate_model(cfg, mono, test.x, test.y, device=dev):.4f}")
    member_accs = result.ensemble().evaluate(test.x, test.y)
    for i, acc in enumerate(member_accs):
        print(f"member {i+1}/{k}:            {acc:.4f}")
    avg = evaluate_model(cfg, result.averaged, test.x, test.y, device=dev)
    print(f"weight-averaged ({k}):     {avg:.4f}  <- the paper's claim: "
          f"~= monolithic, at 1/k the wall time per machine")
    print(f"Map+Reduce on {result.device}: {result.wall_time_s:.2f}s wall, "
          f"kernel launches {launches}")


if __name__ == "__main__":
    main()
