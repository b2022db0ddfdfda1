"""Parameter trees between the reference and the port, through numpy.

The reference's CNN tree is ``{"stages": ({"w", "b"}, ...)}`` with HWIO
kernels and an (F, C) β — the port keeps the same layout, so converting is
a leaf-wise copy, never a transpose. This module takes and returns numpy
arrays only (e.g. ``jax.tree.map(np.asarray, tree)`` on the reference's
side) and never imports JAX.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core.cnn_elm import CNNELMModel, StackedMembers
from repro_torch.tree import tree_map


def params_from_numpy(tree, device="cuda"):
    """A tree of numpy arrays -> the same tree of f32 tensors on ``device``."""
    dev = resolve_device(device)
    return tree_map(lambda a: torch.tensor(np.asarray(a, np.float32),
                                           device=dev), tree)


def model_from_numpy(cnn_params, beta, device="cuda") -> CNNELMModel:
    """One reference model's (cnn_params, β) -> a ``CNNELMModel``."""
    return CNNELMModel(params_from_numpy(cnn_params, device),
                       params_from_numpy(beta, device))


def stacked_from_numpy(cnn_params_k, beta_k, device="cuda") -> StackedMembers:
    """Member-stacked (cnn_params, β) -> ``StackedMembers``."""
    return StackedMembers(params_from_numpy(cnn_params_k, device),
                          params_from_numpy(beta_k, device))


def to_numpy(tree):
    """A tree of tensors (or a ``CNNELMModel``/``StackedMembers``, as its
    ``(cnn_params, beta)`` pair) -> the same tree of numpy arrays."""
    if isinstance(tree, (CNNELMModel, StackedMembers)):
        tree = (tree.cnn_params, tree.beta)
    return tree_map(lambda a: a.detach().cpu().numpy(), tree)
