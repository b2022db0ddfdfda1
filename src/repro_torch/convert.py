"""Parameter trees between the reference and the port, through numpy.

The reference's CNN tree is ``{"stages": ({"w", "b"}, ...)}`` with HWIO
kernels and an (F, C) β, and its LM tree has (in, out) weights stacked
with a leading layer dim and a (L, B, T, KV, hd) KV cache — the port keeps
the same layouts, so converting is a leaf-wise copy, never a transpose.
CNN trees become f32 (``params_from_numpy``); LM trees keep each leaf's
dtype (``lm_tree_from_numpy``), whole or cut to one rank's blocks of a
mesh (``lm_shard_from_numpy``). This module takes and returns numpy arrays
only (e.g. ``jax.tree.map(np.asarray, tree)`` on the reference's side) and
never imports JAX.
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


def _keep_dtype(a, dev):
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        # ml_dtypes' bfloat16 (what JAX hands numpy) has no torch twin;
        # widening to f32 and narrowing back is exact
        return torch.from_numpy(a.astype(np.float32)).to(
            device=dev, dtype=torch.bfloat16)
    return torch.tensor(a, device=dev)


def lm_tree_from_numpy(tree, device="cuda"):
    """A tree of numpy arrays (an LM's params or KV cache) -> the same tree
    of tensors on ``device``, each leaf in its own dtype (bf16 stays bf16)."""
    dev = resolve_device(device)
    return tree_map(lambda a: _keep_dtype(a, dev), tree)


def lm_shard_from_numpy(tree, logical_tree, mesh, coord, rules=None,
                        device="cuda"):
    """The block of a whole LM tree (numpy: params, or a cache) that mesh
    coordinate ``coord`` (axis -> index) holds on ``mesh`` (anything with
    ``.shape``, a dict of axis sizes) under ``rules``, as
    ``sharding.resolve_spec`` lays out ``logical_tree`` (``api.logical_axes``
    or ``api.cache_logical``): the port's tensors on ``device``, each leaf in
    its own dtype. Only the block is copied."""
    from repro_torch.distributed import sharding
    return lm_tree_from_numpy(sharding.shard_tree(
        tree, logical_tree, mesh, coord, rules), device)


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
    ``(cnn_params, beta)`` pair) -> the same tree of numpy arrays; bf16
    leaves come back as f32 (numpy has no bfloat16 of its own)."""
    if isinstance(tree, (CNNELMModel, StackedMembers)):
        tree = (tree.cnn_params, tree.beta)

    def leaf(a):
        a = a.detach().cpu()
        return (a.float() if a.dtype == torch.bfloat16 else a).numpy()

    return tree_map(leaf, tree)
