"""The rank side of the port's rule-override tests
(``tests/test_torch_mesh_overrides.py``).

``launch.mesh.run_ranks`` starts each rank as a fresh process that imports
this module, so it imports torch and ``repro_torch`` (and the other mesh
tests' rank modules, which import nothing else) only; the reference's
unsharded runs happen in the pytest process. One group of four ranks
runs every case: on data 2 × model 2 the serving and training cases,
each under its rule override (``torch_lm_mesh_ranks.serve_case``,
``torch_lm_train_mesh_ranks.train_case``: the blocks are laid out under
the override, and the model gathers them), then on pod 2 × data 2 the
member step under ``MULTIPOD_RULES`` and the override, and the
collectives' own checks on the data axis's group.
"""
from __future__ import annotations

import torch

import torch_lm_mesh_ranks as serve_ranks
import torch_lm_train_mesh_ranks as train_ranks
from repro_torch.distributed import collectives
from repro_torch.launch.mesh import make_lm_mesh


def primitives(mesh):
    """The reduce-scatter, the weight gather and the broadcast over the
    ``data`` axis's group, forward and backward, on tensors made from the
    rank's coordinate: (name, values as lists, the calls by kind)."""
    group, d = mesh.group("data"), mesh.coord["data"]
    out = {}
    t = (torch.arange(8.0).reshape(4, 2) + 10 * d).requires_grad_(True)
    collectives.reset()
    y = collectives.reduce_scatter(t, group, "data", dim=0)
    (g,) = torch.autograd.grad((y * (d + 1)).sum(), t)
    out["reduce_scatter"] = (y.tolist(), g.tolist())
    w = (torch.arange(4.0).reshape(2, 2) + 10 * d).requires_grad_(True)
    whole = collectives.gather_weight(w, group, "data", dim=1)
    (g,) = torch.autograd.grad((whole * (d + 1)).sum(), w)
    out["gather_weight"] = (whole.tolist(), g.tolist())
    b = (torch.ones(3) * (d + 1)).requires_grad_(True)
    got = collectives.broadcast(b, 1, group, "data")
    # the rank that is not the source gets no gradient (zeros here)
    (g,) = torch.autograd.grad((got * (d + 2)).sum(), b, allow_unused=True,
                               materialize_grads=True)
    out["broadcast"] = (got.tolist(), g.tolist())
    out["calls"] = {f"{k}/{label}": n for (k, label), n in
                    collectives.CALLS.items() if n}
    out["backward"] = {f"{k}/{label}": n for (k, label), n in
                       collectives.BACKWARD_CALLS.items() if n}
    return out


def override_cases(rank, world, serve, train, member):
    """Every case on this rank: ``serve`` and ``train`` are lists of
    (case, rules) on data 2 × model 2, ``member`` one (case, rules) on
    pod 2 × data 2 × model 1."""
    torch.set_num_threads(1)
    mesh = make_lm_mesh({"data": 2, "model": 2})
    out = {"coord": mesh.coord, "primitives": primitives(mesh),
           "serve": [serve_ranks.serve_case(mesh, c, r) for c, r in serve],
           "train": [train_ranks.train_case(mesh, c, r) for c, r in train]}
    pods = make_lm_mesh({"pod": 2, "data": 2, "model": 1})
    case, rules = member
    out["member_coord"] = pods.coord
    out["member"] = train_ranks.train_case(pods, case, rules)
    return out
