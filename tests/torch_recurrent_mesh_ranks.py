"""The rank side of the port's recurrent-family mesh tests
(``tests/test_torch_recurrent_mesh.py``).

``launch.mesh.run_ranks`` starts each rank as a fresh process that imports
this module, so it imports torch and ``repro_torch`` (and the transformer
mesh tests' rank modules, which import nothing else) only; the
reference's unsharded runs happen in the pytest process. A rank runs the
serving cases as ``torch_lm_mesh_ranks.serve_case`` does (its blocks of
the reference's params and prompt, the port's prefill and greedy decode
steps under ``use_mesh_rules``) and the training cases as
``torch_lm_train_mesh_ranks.train_case`` does (the loss, its gradient
blocks, two AdamW steps and, on a member mesh, the Reduce over ``pod``):
both are family-blind, and RWKV6 and Zamba2 run through them unchanged.
"""
from __future__ import annotations

import torch

import torch_lm_mesh_ranks as serve_ranks
import torch_lm_train_mesh_ranks as train_ranks
from repro_torch.launch.mesh import make_lm_mesh

LR = train_ranks.LR


def mesh_cases(rank, world, mesh_shape, serve, train, rules=None):
    """Every serving and training case on this rank of a ``mesh_shape``
    mesh; serving runs under the default rules."""
    torch.set_num_threads(1)
    mesh = make_lm_mesh(mesh_shape)
    return {"coord": mesh.coord,
            "serve": [serve_ranks.serve_case(mesh, c) for c in serve],
            "train": [train_ranks.train_case(mesh, c, rules)
                      for c in train]}
