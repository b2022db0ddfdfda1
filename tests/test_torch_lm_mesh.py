"""Sharded serving of the LM zoo's transformer families on gloo CPU ranks
(``launch.mesh.run_ranks``), held against the reference's unsharded
prefill and decode.

On model 2, model 4 and data 2 × model 2, every rank takes its blocks of
the reference's whole parameter tree (``convert.lm_shard_from_numpy``)
and of the batch (``ctx.place``), and runs the port's prefill and 8
greedy decode steps (the encoder: its encode) under ``use_mesh_rules``;
the ranks' logits, put back together, must equal the reference's
unsharded ones within 1e-4 · max|logit| in f32 (the port's 2-layer f32 LM
bar) with equal greedy tokens. Sharding leaves the function as it is, so
only the f32 sum order moves: the all-reduced partial products (wo,
w_down, the MoE's partial combines), and at decode the softmax combined
over the cache's sequence shards. The reduced configs of qwen3_8b (at
model 4 its 2 KV heads replicate and wk splits a head), minicpm_2b (its
vocab of 513 takes the fallback), olmoe_1b_7b and qwen3_moe_235b_a22b
(experts sharded), internvl2_26b (the prefix) and hubert_xlarge (encode);
a sliding-window qwen3_8b whose prompt outruns the window (its cache a
ring, sharded by sequence) and a batch of one (replicated over data).
The decode caches are sharded by sequence wherever their length divides.
The reference runs in this process, the ranks import no JAX
(``tests/torch_lm_mesh_ranks.py``).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_reduced_config as jget
from repro.configs.base import replace as jreplace
from repro.models import api as japi
from repro.models import transformer as jtransformer
from repro_torch.launch.mesh import run_ranks

import torch_lm_mesh_ranks as ranks

torch.set_num_threads(2)

KEY = jax.random.PRNGKey(3)
PROMPT, STEPS = 12, 8
CASES = [
    ("qwen3_8b", 2, {}),
    ("minicpm_2b", 2, {}),
    ("olmoe_1b_7b", 2, {}),
    ("qwen3_moe_235b_a22b", 2, {}),
    ("internvl2_26b", 2, {}),
    ("hubert_xlarge", 2, {}),
    ("qwen3_8b", 2, {"sliding_window": 8}),
    ("olmoe_1b_7b", 1, {}),
]
MESHES = {"model2": {"data": 1, "model": 2},
          "model4": {"data": 1, "model": 4},
          "data2_model2": {"data": 2, "model": 2}}


@functools.lru_cache(maxsize=None)
def _reference(i):
    """(the case for the ranks, the reference's logits step by step)."""
    arch, B, rep = CASES[i]
    jcfg = jreplace(jget(arch), **rep) if rep else jget(arch)
    jp = japi.init_params(jcfg, KEY, jnp.float32)
    rng = np.random.default_rng(i)
    if jcfg.frontend == "audio":
        b = {"frames": rng.normal(size=(B, PROMPT, 512)).astype(np.float32)}
    else:
        b = {"tokens": rng.integers(0, jcfg.vocab_size, (B, PROMPT))
             .astype(np.int32)}
    if jcfg.frontend == "vision":
        b["patches"] = rng.normal(
            size=(B, jcfg.num_prefix_tokens, 1024)).astype(np.float32)
    jb = {k: jnp.asarray(v) for k, v in b.items()}
    case = {"arch": arch, "replace": rep, "batch": b, "feed": [],
            "pos0": 0, "params": jax.tree.map(np.asarray, jp)}
    if jcfg.is_encoder_only:
        return case, [np.asarray(jtransformer.forward(jcfg, jp, jb)[0])]
    S = PROMPT + (jcfg.num_prefix_tokens if jcfg.frontend == "vision"
                  else 0)
    logits, cache = japi.prefill(jcfg, jp, jb, max_len=S + STEPS)
    refs = [np.asarray(logits)]
    step = jax.jit(lambda c, t, pos: japi.decode_step(jcfg, jp, c, t, pos))
    for t in range(STEPS):
        tok = np.asarray(jnp.argmax(logits[:, -1:], -1)).astype(np.int32)
        case["feed"].append(tok)
        logits, cache = step(cache, jnp.asarray(tok), S + t)
        refs.append(np.asarray(logits))
    case["pos0"] = S
    return case, refs


@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_sharded_serving_matches_the_unsharded_reference(mesh_name):
    mesh = MESHES[mesh_name]
    cases, refs = zip(*[_reference(i) for i in range(len(CASES))])
    world = int(np.prod(list(mesh.values())))
    results = run_ranks(ranks.serve_cases, world, device="cpu",
                        args=(mesh, list(cases)), timeout_s=240)
    for i, (arch, B, rep) in enumerate(CASES):
        what = f"{arch} B{B} {rep or ''} on {mesh}"
        for s, ref in enumerate(refs[i]):
            got = ranks.assemble(results, i, s)
            assert got.shape == ref.shape, what
            err, top = float(np.abs(got - ref).max()), float(
                np.abs(ref).max())
            assert err <= 1e-4 * top, f"{what} step {s}: {err} > 1e-4*{top}"
            np.testing.assert_array_equal(got.argmax(-1), ref.argmax(-1),
                                          err_msg=f"{what} step {s}")
        for r in results:
            calls = r["cases"][i]["calls"]
            # serving sends nothing over data
            assert all(label == "model" for _, label in calls), calls
            assert calls, what
    # the decode caches: sharded by sequence wherever the length divides
    M = mesh["model"]
    for i, (arch, B, rep) in enumerate(CASES):
        shapes = results[0]["cases"][i].get("cache_shapes")
        if not shapes:
            continue
        T = rep.get("sliding_window") or (
            PROMPT + STEPS + (16 if arch == "internvl2_26b" else 0))
        Bl = B // mesh["data"] if B % mesh["data"] == 0 else B
        cfg = ranks.config(cases[i])
        assert shapes["k"] == (cfg.num_layers, Bl, T // M,
                               cfg.num_kv_heads, cfg.head_dim), (arch,
                                                                 shapes)
