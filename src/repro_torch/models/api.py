"""Family dispatch for the LM zoo — the port's counterpart of
``repro.models.api``. The transformer families (dense, moe, encoder, vlm)
are ``models.transformer``, RWKV6 is ``models.rwkv6`` and the Zamba2
hybrid ``models.zamba2``; any other family (``ssm_mamba2`` included, which
the reference's dispatch does not carry either) raises ``ValueError``.

``param_specs``, ``input_specs`` and ``cache_specs`` give the shapes and
dtypes of a model's parameters, a step's inputs and the decode cache
(``TensorSpec`` leaves) without allocating them: the dry run's contract
(``launch/dryrun.py``). ``logical_axes`` and ``cache_logical`` name every
dimension of the parameters and the cache with a logical axis, and
``input_specs`` / ``cache_specs`` give the inputs' and the cache's with
``with_logical=True``, as the reference's return them:
``distributed.sharding.resolve_spec`` turns them into a mesh's layout and
``distributed/ctx.py`` runs a model on it.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import torch

from repro_torch.distributed import ctx
from repro_torch.models import rwkv6, transformer, zamba2
from repro_torch.tree import tree_map


def module_of(cfg):
    if cfg.family in transformer.FAMILIES:
        return transformer
    if cfg.family == "ssm_rwkv6":
        return rwkv6
    if cfg.family == "hybrid_zamba2":
        return zamba2
    raise ValueError(f"unknown family {cfg.family}")


def init_params(cfg, generator, dtype=torch.bfloat16, device="cuda"):
    return module_of(cfg).init_params(cfg, generator, dtype, device)


def logical_axes(cfg):
    return module_of(cfg).logical_axes(cfg)


def cache_logical(cfg):
    return module_of(cfg).cache_logical(cfg)


def loss_fn(cfg, params, batch):
    return module_of(cfg).loss_fn(cfg, params, batch)


def hidden_states(cfg, params, batch):
    return module_of(cfg).hidden_states(cfg, params, batch)


def init_cache(cfg, batch: int, seq_len: int, dtype=torch.bfloat16,
               device="cuda"):
    return module_of(cfg).init_cache(cfg, batch, seq_len, dtype, device)


def prefill(cfg, params, batch, max_len: int | None = None):
    mod = module_of(cfg)
    if cfg.family in transformer.FAMILIES:
        return mod.prefill(cfg, params, batch, max_len=max_len)
    return mod.prefill(cfg, params, batch)  # the recurrent state has no length


def decode_step(cfg, params, cache, token, pos):
    return module_of(cfg).decode_step(cfg, params, cache, token, pos)


# ---------------------------------------------------------------------------
# specs (shapes and dtypes, nothing allocated)
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class TensorSpec:
    """The shape and dtype of one tensor (a leaf of a spec tree)."""
    shape: Tuple[int, ...]
    dtype: torch.dtype

    @property
    def nbytes(self) -> int:
        n = 1
        for d in self.shape:
            n *= d
        return n * self.dtype.itemsize

    def empty(self, device) -> torch.Tensor:
        return torch.empty(self.shape, dtype=self.dtype, device=device)


def _specs_of(make):
    """The spec tree of what ``make()`` builds on the CPU, built under
    ``FakeTensorMode``: the init's draws run on fake tensors, so nothing of
    the model's size is allocated (a Qwen3-MoE-235B included)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    with FakeTensorMode():
        tree = make()
    return tree_map(lambda t: TensorSpec(tuple(t.shape), t.dtype), tree)


def param_specs(cfg, dtype=torch.bfloat16):
    """The shapes and dtypes of ``init_params(cfg, ..., dtype)``: the
    counterpart of the reference's ``jax.eval_shape(api.init_params)``."""
    return _specs_of(lambda: init_params(
        cfg, torch.Generator().manual_seed(0), dtype, device="cpu"))


def input_specs(cfg, shape, with_logical: bool = False):
    """The batch of a train or prefill step of ``shape`` (an
    ``InputShape``): ``tokens`` (B, S) int32, or an audio encoder's
    ``frames`` (B, S, 512) bf16, or a VLM's ``tokens`` (B, S - P) behind
    ``patches`` (B, P, 1024) bf16; a train step adds ``targets`` of the
    tokens' (frames') (B, S). A decode step's inputs: ``token`` (B, 1)
    int32 and ``pos`` () int32 (the port's decode takes ``pos`` as a
    Python int; the dry run passes S - 1). The reference's shapes and
    dtypes; with ``with_logical``, (specs, their logical axes)."""
    B, S = shape.global_batch, shape.seq_len
    i32, bf16 = torch.int32, torch.bfloat16
    if shape.kind in ("train", "prefill"):
        if cfg.frontend == "audio":
            specs = {"frames": TensorSpec(
                (B, S, transformer.AUDIO_FRONTEND_DIM), bf16)}
            logical = {"frames": ("batch", "seq", "feature")}
        elif cfg.frontend == "vision":
            P = cfg.num_prefix_tokens
            specs = {"tokens": TensorSpec((B, S - P), i32),
                     "patches": TensorSpec(
                         (B, P, transformer.VISION_FRONTEND_DIM), bf16)}
            logical = {"tokens": ("batch", "seq"),
                       "patches": ("batch", "seq", "feature")}
        else:
            specs = {"tokens": TensorSpec((B, S), i32)}
            logical = {"tokens": ("batch", "seq")}
        if shape.kind == "train":
            lead = specs.get("tokens", specs.get("frames")).shape[:2]
            specs["targets"] = TensorSpec(lead, i32)
            logical["targets"] = ("batch", "seq")
    else:
        specs = {"token": TensorSpec((B, 1), i32),
                 "pos": TensorSpec((), i32)}
        logical = {"token": ("batch", None), "pos": ()}
    return (specs, logical) if with_logical else specs


def cache_specs(cfg, shape, dtype=torch.bfloat16,
                with_logical: bool = False):
    """The decode cache (or recurrent state) of ``shape``'s batch and
    length: ``init_cache``'s shapes and dtypes, nothing allocated (the
    whole cache, also under a mesh context); with ``with_logical``,
    (specs, ``cache_logical``)."""
    with ctx.suspended():
        specs = _specs_of(lambda: init_cache(
            cfg, shape.global_batch, shape.seq_len, dtype, device="cpu"))
    return (specs, cache_logical(cfg)) if with_logical else specs
