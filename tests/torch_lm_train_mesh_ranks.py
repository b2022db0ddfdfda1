"""The rank side of the port's sharded-training tests
(``tests/test_torch_lm_train_mesh.py``).

``launch.mesh.run_ranks`` starts each rank as a fresh process that imports
this module, so it imports torch and ``repro_torch`` only; the reference's
unsharded gradients and steps run in the pytest process. Each case comes
in as the reference's whole f32 parameter tree, AdamW state and batches
(numpy; with ``members``, stacked on a leading member dim). The rank takes
its blocks (``convert.lm_shard_from_numpy``, ``ctx.place``), computes the
loss and its gradient blocks (``trainer.loss_and_grads``), takes two
AdamW steps (``make_train_step``, or ``make_member_train_step`` with the
member dim over ``pod``) and, on a member mesh, the Reduce over ``pod``
(``make_average_step(group=...)``), and returns each block with the
global offsets it lies at, and the collectives it counted, forward and
backward, phase by phase.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import convert, optim
from repro_torch.configs import get_reduced_config, replace
from repro_torch.core import trainer
from repro_torch.distributed import collectives, ctx, sharding
from repro_torch.launch.mesh import make_lm_mesh
from repro_torch.models import api
from repro_torch.tree import tree_leaves, tree_map

LR = 3e-3


def config(case):
    return replace(get_reduced_config(case["arch"]), **case.get("replace",
                                                                  {}))


class _Shape:
    """The ``InputShape`` fields ``api.input_specs`` reads."""

    def __init__(self, tokens):
        self.global_batch, self.seq_len = tokens.shape[-2:]
        self.kind = "train"


def _shapes_and_specs(tree, logical):
    """[(global shape, spec under the active context)] of a numpy tree, in
    tree order."""
    out = []
    sharding.map_logical(lambda log, a: out.append(
        (a.shape, ctx.spec(a.shape, log))), logical, tree)
    return out


def _offsets(mesh, shape, spec):
    return tuple(mesh.index(e) * (d // mesh.size(e))
                 for d, e in zip(shape, spec))


def _blocks(mesh, tensors, layout):
    """[(block as numpy, its global offsets)] in tree order."""
    return [(t.detach().float().numpy(), _offsets(mesh, shape, spec))
            for t, (shape, spec) in zip(tensors, layout)]


def _counts():
    def by(c):
        return {f"{k}/{label}": n for (k, label), n in c.items() if n}
    return {"forward": by(collectives.CALLS - collectives.BACKWARD_CALLS),
            "backward": by(collectives.BACKWARD_CALLS)}


def train_case(mesh, case, rules=None):
    """One case on this rank: the loss, the gradient blocks, the params'
    blocks after two AdamW steps (and the Reduce's blocks), with the
    collectives of each phase."""
    cfg = config(case)
    k = case.get("members")
    p_log = api.logical_axes(cfg)
    o_log = sharding.opt_logical("adamw", p_log)
    _, b_log = api.input_specs(cfg, _Shape(case["batches"][0]["tokens"]),
                               with_logical=True)
    if k:
        p_log, o_log, b_log = (sharding.with_member_dim(t)
                               for t in (p_log, o_log, b_log))
    out = {}
    with ctx.use_mesh_rules(mesh, rules) as frame:
        params = convert.lm_shard_from_numpy(
            case["params"], p_log, mesh, mesh.coord, rules, device="cpu")
        opt = convert.lm_shard_from_numpy(
            case["opt"], o_log, mesh, mesh.coord, rules, device="cpu")
        batches = [ctx.place({n: torch.from_numpy(v) for n, v in b.items()},
                             b_log) for b in case["batches"]]
        layout = _shapes_and_specs(case["params"], p_log)

        def loss_fn(p, b):
            return api.loss_fn(cfg, p, b)

        collectives.reset()
        if k:
            # each local member's gradient, as the member step takes it
            k_local = tree_leaves(params)[0].shape[0]
            m0 = mesh.index(ctx.spec((k,), ("member",))[0]) * k_local
            losses, grads = [], []
            with ctx.use_mesh_rules(mesh) as inner:
                inner.sizes.update(frame.sizes)
                inner_layout = _shapes_and_specs(
                    tree_map(lambda a: a[0], case["params"]),
                    api.logical_axes(cfg))
                for i in range(k_local):
                    loss, _, g, _ = trainer.loss_and_grads(
                        cfg, loss_fn, _member(params, i),
                        _member(batches[0], i))
                    losses.append((m0 + i, float(loss)))
                    grads.append((m0 + i, _blocks(mesh, g, inner_layout)))
            out["loss"], out["grads"] = losses, grads
        else:
            loss, _, g, _ = trainer.loss_and_grads(cfg, loss_fn, params,
                                                   batches[0])
            out["loss"] = float(loss)
            out["grads"] = _blocks(mesh, g, layout)
        out["grad_calls"] = _counts()

        collectives.reset()
        make = trainer.make_member_train_step if k else \
            trainer.make_train_step
        step = make(cfg, optim.adamw(), optim.constant(LR))
        s = [0] * tree_leaves(params)[0].shape[0] if k else 0
        for b in batches:
            params, opt, s, metrics = step(params, opt, s, b)
        out["step_losses"] = np.asarray(metrics["loss"]).tolist()
        out["params"] = _blocks(mesh, tree_leaves(params), layout)
        out["step_calls"] = _counts()
        if k:
            collectives.reset()
            avg = trainer.make_average_step(group=mesh.group("pod"))(params)
            out["average"] = _blocks(mesh, tree_leaves(avg), layout)
            out["average_calls"] = _counts()
    return out


def _member(tree, i):
    return tree_map(lambda a: a[i], tree)


def train_cases(rank, world, mesh_shape, cases, rules=None):
    """Every case on this rank of a ``mesh_shape`` mesh."""
    torch.set_num_threads(1)
    mesh = make_lm_mesh(mesh_shape)
    return {"coord": mesh.coord,
            "cases": [train_case(mesh, c, rules) for c in cases]}
