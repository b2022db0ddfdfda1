"""The rank side of the port's LM mesh tests
(``tests/test_torch_lm_mesh.py``).

``launch.mesh.run_ranks`` starts each rank as a fresh process that imports
this module, so it imports torch and ``repro_torch`` only; the reference's
unsharded runs happen in the pytest process. Each case comes in as the
reference's whole parameter tree and batch (numpy); the rank takes its
blocks (``convert.lm_shard_from_numpy``, ``ctx.place``), runs the port's
prefill and decode steps (or the encoder's encode) under
``use_mesh_rules`` and returns its logits with the global rows and
columns they cover, and the collectives it counted.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import convert
from repro_torch.configs import get_reduced_config, replace
from repro_torch.core import trainer
from repro_torch.distributed import collectives, ctx
from repro_torch.launch.mesh import make_lm_mesh
from repro_torch.models import api
from repro_torch.models.transformer import _vocab_entry


def config(case):
    cfg = get_reduced_config(case["arch"])
    return replace(cfg, **case.get("replace", {}))


def _np(x):
    return x.detach().float().numpy()


def _block(logits, mesh, batch_entry, vocab_entry):
    """(logits, first global row, first global vocab column) of a rank's
    block of logits."""
    B_l, V_l = logits.shape[0], logits.shape[-1]
    b0 = 0 if batch_entry is None else mesh.index(batch_entry) * B_l
    v0 = 0 if vocab_entry is None else mesh.index(vocab_entry) * V_l
    return _np(logits), b0, v0


def serve_case(mesh, case, rules=None):
    """One case on this rank: {"steps": [(logits, b0, v0)], ...}."""
    cfg = config(case)
    with ctx.use_mesh_rules(mesh, rules):
        params = convert.lm_shard_from_numpy(
            case["params"], api.logical_axes(cfg), mesh, mesh.coord, rules,
            device="cpu")
        _, logical = api.input_specs(
            cfg, _Shape(case), with_logical=True)
        batch = ctx.place({k: torch.from_numpy(v) for k, v in
                           case["batch"].items()},
                          {k: logical[k] for k in case["batch"]})
        be, ve = ctx.batch_entry(), _vocab_entry(cfg)
        steps = []
        collectives.reset()
        if cfg.is_encoder_only:
            logits = trainer.make_prefill_step(cfg)(params, batch)
            steps.append(_block(logits, mesh, be, ve))
            return {"steps": steps, "calls": dict(collectives.CALLS)}
        logits, cache = api.prefill(cfg, params, batch,
                                    max_len=case["pos0"] + len(case["feed"]))
        steps.append(_block(logits, mesh, be, ve))
        serve = trainer.make_serve_step(cfg)
        cache_shapes = {k: tuple(v.shape) for k, v in cache.items()}
        for t, tok in enumerate(case["feed"]):
            tok = ctx.place({"token": torch.from_numpy(tok)},
                            {"token": ("batch", None)})["token"]
            logits, cache = serve(params, cache, tok, case["pos0"] + t)
            steps.append(_block(logits, mesh, be, None))
        return {"steps": steps, "calls": dict(collectives.CALLS),
                "cache_shapes": cache_shapes}


class _Shape:
    """The ``InputShape`` fields ``api.input_specs`` reads."""

    def __init__(self, case):
        b = case["batch"]
        first = b.get("tokens", b.get("frames"))
        self.global_batch, self.seq_len = first.shape[:2]
        self.kind = "prefill"


def serve_cases(rank, world, mesh_shape, cases, rules=None):
    """Every case on this rank of a ``mesh_shape`` mesh."""
    torch.set_num_threads(1)
    mesh = make_lm_mesh(mesh_shape)
    return {"coord": mesh.coord,
            "cases": [serve_case(mesh, c, rules) for c in cases]}


def assemble(results, case_index, step):
    """The global logits of one step from every rank's block (each block
    written where it lies; blocks held by several ranks must agree)."""
    blocks = [r["cases"][case_index]["steps"][step] for r in results]
    B = max(b0 + a.shape[0] for a, b0, _ in blocks)
    V = max(v0 + a.shape[-1] for a, _, v0 in blocks)
    out = np.full((B,) + blocks[0][0].shape[1:-1] + (V,), np.nan,
                  np.float32)
    for a, b0, v0 in blocks:
        cell = out[b0:b0 + a.shape[0], ..., v0:v0 + a.shape[-1]]
        seen = ~np.isnan(cell)
        assert np.array_equal(cell[seen], a[seen]), "replicas disagree"
        out[b0:b0 + a.shape[0], ..., v0:v0 + a.shape[-1]] = a
    assert not np.isnan(out).any()
    return out
