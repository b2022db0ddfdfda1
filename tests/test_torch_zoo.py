"""The LM zoo's transformer families in the port against the reference's
``repro.models.transformer``: MoE (olmoe, qwen3-moe), the other dense
configs (minicpm, internlm2, qwen3-32b), the encoder (hubert) and the VLM
(internvl2), with the MoE layer alone, the encoder's non-causal attention
and the ELM head over HuBERT.

Reduced configs (2 layers, d 256, 4 experts); the reference initialises
the parameters and ``repro_torch.convert`` hands them over leaf by leaf;
tokens, frames and patches come from numpy seeds. On the CPU the port's
wrappers run their kernels' plain versions.

Tolerances are ``tests/test_torch_lm.py``'s: f32 — the same math with sums
in another order — rtol 1e-4, atol 1e-4; bf16 — sums in another order
before each bf16 rounding — rtol 2e-2, atol 2e-2, against the reference's
unrolled layer loop (``unroll_layers=True``, R5). Through a whole bf16
model that elementwise bar is a matter of luck at some elements (the
VLM's 40 positions, the MoE's decode against its forward: 1–2 of ~20,000
logits miss it by up to 18 %, while the reference's own scanned form
misses it at 26 of the VLM's), so a whole-model bf16 output that misses
it is held to the repo's twin rule instead: within twice the compared-to
side's own distance from the same function in f32 on the same (upcast)
weights — no farther from the reference than the reference's own bf16
rounding puts it. A router's top-k choice is compared exactly where the
inputs are the same; through the whole model one ulp upstream could flip
a choice near a tie, and a test says so where it counts the choices that
agree.
"""
import dataclasses
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs.base import get_config as jget_config
from repro.configs.base import get_reduced_config as jget_reduced
from repro.configs.base import replace as jreplace
from repro.core import elm_head as jhead
from repro.layers import attention as jattn
from repro.layers import mlp as jmlp
from repro.layers import norms as jnorms
from repro.models import api as japi
from repro.models import transformer as jtf
from repro_torch import convert, kernels, optim
from repro_torch.configs import (ARCH_IDS, get_config, get_reduced_config,
                                 replace)
from repro_torch.core import elm_head, trainer
from repro_torch.kernels.swa_attention import ops as swa_ops
from repro_torch.kernels.swa_attention import ref as swa_ref
from repro_torch.launch import serve
from repro_torch.layers import attention, mlp, norms
from repro_torch.models import api, transformer
from repro_torch.tree import tree_leaves, tree_map

# the reference's threaded tests share the CPU with these workers
torch.set_num_threads(2)

KEY = jax.random.PRNGKey(3)
DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}
TOL = {"f32": 1e-4, "bf16": 2e-2}
NEW = ["olmoe_1b_7b", "qwen3_moe_235b_a22b", "minicpm_2b", "internlm2_20b",
       "qwen3_32b", "hubert_xlarge", "internvl2_26b"]
DECODERS = [a for a in NEW if a != "hubert_xlarge"]
LM_ARCHS = [a for a in ARCH_IDS if not a.startswith("cnn_elm")]
TRANSFORMER_ARCHS = [a for a in LM_ARCHS
                     if get_config(a).family in transformer.FAMILIES]


def _np(x):
    return (x.detach().float().numpy() if isinstance(x, torch.Tensor)
            else np.asarray(x, np.float32))


def _close(got, ref, dtype):
    got, ref = _np(got), _np(ref)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=TOL[dtype], atol=TOL[dtype])


def _close_model(got, ref, dtype, f32_fn):
    """A whole model's output: ``_close``'s bar, or, in bf16 where an
    element misses it, max|got - ref| within twice max|ref - f32_fn()|,
    the compared-to side's own distance from the same function computed
    in f32 (the module docstring's twin rule)."""
    got, ref = _np(got), _np(ref)
    assert got.shape == ref.shape
    if dtype == "f32" or np.all(np.abs(got - ref) <= TOL[dtype] * (
            1 + np.abs(ref))):
        return _close(got, ref, dtype)
    own = float(np.abs(ref - _np(f32_fn())).max())
    assert float(np.abs(got - ref).max()) <= 2 * own, (
        float(np.abs(got - ref).max()), own)


def _f32(tree):
    """A port tree or batch with its floating leaves upcast to f32."""
    return tree_map(lambda a: a.float() if a.is_floating_point() else a,
                    tree)


@functools.lru_cache(maxsize=None)
def _model(arch, dtype):
    """(reference cfg, port cfg, reference params, port params); the bf16
    reference runs its layers unrolled (R5)."""
    jdt, _ = DTYPES[dtype]
    jcfg, tcfg = jget_reduced(arch), get_reduced_config(arch)
    jp = japi.init_params(jcfg, KEY, jdt)
    if dtype == "bf16":
        jcfg = jreplace(jcfg, unroll_layers=True)
    tp = convert.lm_tree_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    return jcfg, tcfg, jp, tp


def _batch(cfg, seed, B=2, S=24, targets=False):
    """(reference batch, port batch) with the arch's inputs: frames for
    the encoder, S text tokens after the patch slots for the VLM."""
    rng = np.random.default_rng(seed)
    if cfg.frontend == "audio":
        b = {"frames": rng.normal(size=(B, S, 512)).astype(np.float32)}
    else:
        b = {"tokens": rng.integers(0, cfg.vocab_size, (B, S)).astype(
            np.int32)}
    if cfg.frontend == "vision":
        b["patches"] = rng.normal(
            size=(B, cfg.num_prefix_tokens, 1024)).astype(np.float32)
    if targets:
        b["targets"] = rng.integers(0, cfg.vocab_size, (B, S)).astype(
            np.int32)
    return ({k: jnp.asarray(v) for k, v in b.items()},
            {k: torch.from_numpy(v) for k, v in b.items()})


# ---------------------------------------------------------------------------
# configs and trees
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", NEW)
def test_configs_equal_the_reference(arch):
    """The port's full and reduced configs are the reference's, field by
    field, and registered under their ids and aliases."""
    assert arch in ARCH_IDS
    assert dataclasses.asdict(get_config(arch)) == dataclasses.asdict(
        jget_config(arch))
    assert dataclasses.asdict(get_reduced_config(arch)) == \
        dataclasses.asdict(jget_reduced(arch))
    assert get_config(arch.replace("_", "-")) == get_config(arch)


def test_full_configs_match_assignment():
    spec = {
        "internlm2_20b": (48, 6144, 48, 8, 16384, 92544),
        "qwen3_moe_235b_a22b": (94, 4096, 64, 4, 1536, 151936),
        "olmoe_1b_7b": (16, 2048, 16, 16, 1024, 50304),
        "qwen3_32b": (64, 5120, 64, 8, 25600, 151936),
        "minicpm_2b": (40, 2304, 36, 36, 5760, 122753),
        "qwen3_8b": (36, 4096, 32, 8, 12288, 151936),
        "hubert_xlarge": (48, 1280, 16, 16, 5120, 504),
        "internvl2_26b": (48, 6144, 48, 8, 16384, 92553),
        "zamba2_1p2b": (38, 2048, 32, 32, 8192, 32000),
        "rwkv6_3b": (32, 2560, 0, 0, 8960, 65536),
    }
    assert sorted(spec) == sorted(LM_ARCHS)
    for arch, (L, D, H, KV, F, V) in spec.items():
        c = get_config(arch)
        assert (c.num_layers, c.d_model, c.num_heads, c.num_kv_heads,
                c.d_ff if c.family != "moe" else c.moe_d_ff,
                c.vocab_size) == (L, D, H, KV, F, V), arch


def test_reduced_configs_respect_limits():
    for arch in LM_ARCHS:
        cfg = get_reduced_config(arch)
        assert cfg.num_layers <= 2, arch
        assert cfg.d_model <= 512, arch
        if cfg.family == "moe":
            assert cfg.num_experts <= 4, arch


def test_param_count_close_to_assignment():
    approx = {"internlm2_20b": 20e9, "qwen3_32b": 32e9, "qwen3_8b": 8e9,
              "minicpm_2b": 2.7e9, "olmoe_1b_7b": 7e9,
              "hubert_xlarge": 1e9}
    for arch, expect in approx.items():
        n = get_config(arch).param_count()
        assert 0.4 * expect < n < 2.6 * expect, (arch, n, expect)
    olmoe = get_config("olmoe_1b_7b")
    assert olmoe.active_param_count() < olmoe.param_count() / 4


@pytest.mark.parametrize("arch", NEW)
def test_init_params_mirror_the_reference_tree(arch):
    """The same keys, shapes and dtypes as the reference's init (the MoE's
    f32 router and (L, E, D, F) experts, the frontends), padded vocab rows
    zero, and ``convert`` carries the reference's tree across exactly."""
    jcfg = jreplace(jget_reduced(arch), vocab_pad_to=96)
    cfg = replace(get_reduced_config(arch), vocab_pad_to=96)
    jp = jax.tree.map(np.asarray, japi.init_params(jcfg, KEY))
    tp = api.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    jleaves = jax.tree_util.tree_leaves_with_path(jp)
    tleaves = {jax.tree_util.keystr(path): leaf for path, leaf in
               jax.tree_util.tree_leaves_with_path(tp)}
    assert len(jleaves) == len(tleaves)
    for path, leaf in jleaves:
        t = tleaves[jax.tree_util.keystr(path)]
        assert tuple(t.shape) == leaf.shape, jax.tree_util.keystr(path)
        assert str(t.dtype).split(".")[-1] == leaf.dtype.name
    assert (tp["embed"][cfg.vocab_size:] == 0).all()
    back = convert.to_numpy(convert.lm_tree_from_numpy(jp, "cpu"))
    for a, b in zip(jax.tree.leaves(jp), jax.tree.leaves(back)):
        np.testing.assert_array_equal(np.asarray(a, np.float32), b)


# ---------------------------------------------------------------------------
# the MoE layer
# ---------------------------------------------------------------------------

def _moe(dtype, E=8, D=64, F=48, seed=1):
    jdt, _ = DTYPES[dtype]
    jp = jmlp.init_moe(D, F, E, jax.random.PRNGKey(seed), jdt)
    return jp, convert.lm_tree_from_numpy(jax.tree.map(np.asarray, jp), "cpu")


def _jax_top_i(jp, x, K):
    probs = jax.nn.softmax(x.astype(jnp.float32) @ jp["router"], axis=-1)
    return np.asarray(jax.lax.top_k(probs, K)[1])


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("K,cf", [(2, 1.25), (2, 0.5), (3, 8.0)])
def test_moe_apply_matches_reference(dtype, K, cf):
    """y, aux and the top-k choices against the reference's ``moe_apply``
    on the same input; cf 0.5 drops most slots, 8.0 none."""
    jdt, tdt = DTYPES[dtype]
    jp, tp = _moe(dtype)
    x = np.random.default_rng(2).normal(size=(3, 24, 64)).astype(np.float32)
    jx, tx = jnp.asarray(x).astype(jdt), torch.from_numpy(x).to(tdt)
    jy, jaux = jmlp.moe_apply(jp, jx, K, capacity_factor=cf)
    ty, taux = mlp.moe_apply(tp, tx, K, capacity_factor=cf)
    assert ty.dtype == tdt and taux.dtype == torch.float32
    _close(ty, jy, dtype)
    np.testing.assert_allclose(float(taux), float(jaux), rtol=1e-5)
    _, _, top_i = mlp.route(tp, tx, K)
    np.testing.assert_array_equal(top_i.numpy(), _jax_top_i(jp, jx, K))


def test_moe_overflow_zeroes_the_first_token_as_the_reference_does():
    """R6: eight identical tokens at E 4, K 2, cf 1.0 (C = 4 slots) send
    all 16 choices to two experts; both overflow, so slot (e, 0) holds
    zeros and token 0 gets 0 from both, in both packages. With cf 100 all
    eight get the same output."""
    jp, tp = _moe("f32", E=4, D=16, F=32, seed=0)
    x = np.tile(np.random.default_rng(0).normal(size=(1, 1, 16)).astype(
        np.float32), (1, 8, 1))
    for cf, zero in ((1.0, [0, 4, 5, 6, 7]), (100.0, [])):
        jy, _ = jmlp.moe_apply(jp, jnp.asarray(x), 2, capacity_factor=cf)
        ty, _ = mlp.moe_apply(tp, torch.from_numpy(x), 2, capacity_factor=cf)
        _close(ty, jy, "f32")
        norms = ty[0].abs().sum(-1)
        assert [i for i in range(8) if norms[i] == 0] == zero
        assert (norms[norms > 0] == norms.max()).all()


def test_moe_decode_capacity_floor():
    """Decode (S = 1) keeps one slot an expert (C = max(1, int(8/64 ·
    1.25)) at OLMoE's shape), so every token routes somewhere; the reduced
    olmoe's decode step against the reference's."""
    assert mlp.moe_capacity(1, 64, 8, 1.25) == 1
    assert mlp.moe_capacity(128, 64, 8, 1.25) == 20
    jcfg, tcfg, jp, tp = _model("olmoe_1b_7b", "f32")
    jcache = japi.init_cache(jcfg, 2, 8, jnp.float32)
    cache = api.init_cache(tcfg, 2, 8, torch.float32, device="cpu")
    ref, _ = japi.decode_step(jcfg, jp, jcache, jnp.zeros((2, 1), jnp.int32),
                              jnp.asarray(0))
    got, _ = api.decode_step(tcfg, tp, cache,
                             torch.zeros((2, 1), dtype=torch.int64), 0)
    assert bool(torch.isfinite(got).all())
    _close(got, ref, "f32")


def test_moe_combine_sharding_modes_agree():
    """The combine-sharding knob is a layout hint: every mode gives the
    same bits (``tests/test_elm_head.py``'s check)."""
    base = get_reduced_config("olmoe_1b_7b")
    params = api.init_params(base, torch.Generator().manual_seed(0),
                             device="cpu")
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, base.vocab_size, (2, 16)))
    outs = [transformer.forward(replace(base, moe_combine_sharding=m),
                                params, {"tokens": toks})[0]
            for m in ("expert", "batch", "none")]
    assert torch.equal(outs[0], outs[1]) and torch.equal(outs[0], outs[2])


def test_moe_top_k_ties_go_to_the_lower_expert():
    """Equal router probabilities pick the lower expert ids first, as
    ``jax.lax.top_k`` does: a zero router makes every expert tie."""
    jp, tp = _moe("f32", E=6)
    jp = {**jp, "router": jnp.zeros_like(jp["router"])}
    tp = {**tp, "router": torch.zeros_like(tp["router"])}
    x = np.random.default_rng(3).normal(size=(2, 5, 64)).astype(np.float32)
    _, w, top_i = mlp.route(tp, torch.from_numpy(x), 3)
    assert (top_i == torch.tensor([0, 1, 2])).all()
    np.testing.assert_array_equal(top_i.numpy(),
                                  _jax_top_i(jp, jnp.asarray(x), 3))
    assert torch.allclose(w, torch.full_like(w, 1 / 3))


# ---------------------------------------------------------------------------
# family by family against the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("arch", NEW)
def test_forward_matches_reference(arch, dtype):
    """Logits and the aux loss (the MoE's mean router loss, else 0)."""
    jcfg, tcfg, jp, tp = _model(arch, dtype)
    jb, tb = _batch(tcfg, 10)
    ref, jaux = jtf.forward(jcfg, jp, jb)
    got, aux = transformer.forward(tcfg, tp, tb)
    assert got.dtype == torch.float32
    assert got.shape == (2, 24, tcfg.padded_vocab)
    _close_model(got, ref, dtype, lambda: transformer.forward(
        tcfg, _f32(tp), _f32(tb))[0])
    np.testing.assert_allclose(float(aux), float(jaux),
                               rtol=TOL[dtype], atol=1e-7)
    assert (float(aux) > 0) == (tcfg.family == "moe")


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("arch", NEW)
def test_hidden_states_match_reference(arch, dtype):
    """The ELM head's H: text positions only (the VLM's patch slots cut),
    the encoder's through its bidirectional attention."""
    jcfg, tcfg, jp, tp = _model(arch, dtype)
    jb, tb = _batch(tcfg, 11)
    ref = jtf.hidden_states(jcfg, jp, jb)
    got = api.hidden_states(tcfg, tp, tb)
    assert got.shape == (2, 24, tcfg.d_model)
    assert got.dtype == DTYPES[dtype][1]
    _close_model(got, ref, dtype, lambda: api.hidden_states(
        tcfg, _f32(tp), _f32(tb)))


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("arch", NEW)
def test_prefill_matches_reference(arch, dtype):
    """Last-position logits and the KV cache padded to max_len. The
    encoder's prefill is the reference's causal one (no bidirectional
    attention there), and the VLM's cache holds its patch slots."""
    jcfg, tcfg, jp, tp = _model(arch, dtype)
    jb, tb = _batch(tcfg, 12, S=16)
    P = tcfg.num_prefix_tokens if tcfg.frontend == "vision" else 0
    ref, jcache = japi.prefill(jcfg, jp, jb, max_len=P + 20)
    got, cache = api.prefill(tcfg, tp, tb, max_len=P + 20)
    _close_model(got, ref, dtype, lambda: api.prefill(
        tcfg, _f32(tp), _f32(tb))[0])
    for name in ("k", "v"):
        assert cache[name].shape == (2, 2, P + 20, tcfg.num_kv_heads, 64)
        assert cache[name].dtype == DTYPES[dtype][1]
        _close(cache[name], jcache[name], dtype)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("arch", DECODERS)
def test_decode_step_matches_reference(arch, dtype):
    """Three decode steps from the reference's own prefill cache: logits
    and cache after each (the VLM's positions after its patch slots)."""
    jcfg, tcfg, jp, tp = _model(arch, dtype)
    jb, tb = _batch(tcfg, 13, S=19)
    P = tcfg.num_prefix_tokens if tcfg.frontend == "vision" else 0
    jb16 = {k: (v[:, :16] if k == "tokens" else v) for k, v in jb.items()}
    _, jcache = japi.prefill(jcfg, jp, jb16, max_len=P + 20)
    cache = convert.lm_tree_from_numpy(jax.tree.map(np.asarray, jcache),
                                       "cpu")
    toks = np.asarray(jb["tokens"])
    for t in (16, 17, 18):
        tok = toks[:, t:t + 1]
        ref, jcache = japi.decode_step(jcfg, jp, jcache, jnp.asarray(tok),
                                       jnp.asarray(P + t, jnp.int32))
        got, cache = api.decode_step(tcfg, tp, cache, torch.from_numpy(tok),
                                     P + t)
        _close(got, ref, dtype)
        for name in ("k", "v"):
            _close(cache[name], jcache[name], dtype)


def test_vlm_prefix_is_the_reference_embedding():
    """The VLM's embedded sequence: gelu's tanh form over the projected
    patches (``jax.nn.gelu``'s default; torch's default, the exact erf,
    misses by more than the bar), the patch slots ahead of the tokens,
    positions 0 .. P + S - 1, and the text offset P."""
    jcfg, tcfg, jp, tp = _model("internvl2_26b", "f32")
    jb, tb = _batch(tcfg, 14, S=8)
    jx, jpos, joff = jtf._embed_inputs(jcfg, jp, jb)
    x, pos, off = transformer._embed_inputs(tcfg, tp, tb)
    assert off == joff == 16 and x.shape == (2, 24, 256)
    _close(x, jx, "f32")
    np.testing.assert_array_equal(pos.numpy(), np.asarray(jpos))
    w1, w2 = tp["projector"]["w1"], tp["projector"]["w2"]
    erf = torch.nn.functional.gelu(tb["patches"] @ w1) @ w2
    assert float((erf - x[:, :16]).abs().max()) > 1e-4


def test_decoder_routing_agrees_with_the_reference_layer_by_layer():
    """Through the whole reduced olmoe in f32, each layer's router on the
    port's own stream against the reference's on its stream: the count of
    top-k choices that agree (a flip near a tie would show as a count
    below the total), and the layer outputs within the f32 bar."""
    jcfg, tcfg, jp, tp = _model("olmoe_1b_7b", "f32")
    jb, tb = _batch(tcfg, 15)
    jx, jpos, _ = jtf._embed_inputs(jcfg, jp, jb)
    x, pos, _ = transformer._embed_inputs(tcfg, tp, tb)
    K, eps = tcfg.experts_per_token, tcfg.norm_eps
    agree = total = 0
    for i, lp in enumerate(transformer._unbound_layers(tp["layers"], 2)):
        jl = jax.tree.map(lambda a: a[i], jp["layers"])
        h, _ = jattn.attn_forward(jcfg, jl["attn"],
                                  jnorms.rms_norm(jx, jl["ln1"], eps), jpos)
        jin = jnorms.rms_norm(jx + h, jl["ln2"], eps)
        h, _ = attention.attn_forward(tcfg, lp["attn"],
                                      norms.rms_norm(x, lp["ln1"], eps), pos)
        tin = norms.rms_norm(x + h, lp["ln2"], eps)
        got = mlp.route(lp["moe"], tin, K)[2].numpy()
        want = _jax_top_i(jl["moe"], jin, K)
        agree += int((got == want).sum())
        total += got.size
        jx = jtf._block(jcfg, jl, jx, jpos, 0)[0]
        x = transformer._block(tcfg, lp, x, pos, 0)[0]
        _close(x, jx, "f32")
    assert agree == total == 2 * 2 * 24 * K


# ---------------------------------------------------------------------------
# the port against itself, the loss, the smoke checks
# ---------------------------------------------------------------------------

def _greedy_decode_all(cfg, params, toks, dtype):
    B, S = toks.shape
    cache = api.init_cache(cfg, B, S, dtype=dtype, device="cpu")
    step = trainer.make_serve_step(cfg)
    outs = []
    for t in range(S):
        lg, cache = step(params, cache, toks[:, t:t + 1], t)
        outs.append(lg)
    return torch.cat(outs, dim=1)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("arch", ["minicpm_2b", "olmoe_1b_7b"])
def test_decode_matches_forward(arch, dtype):
    """Token-by-token decode equals the full forward
    (``tests/test_decode.py``'s check); olmoe at capacity_factor 8.0, where
    no slot drops in either composition."""
    cfg = get_reduced_config(arch)
    if cfg.family == "moe":
        cfg = replace(cfg, moe_capacity_factor=8.0)
    tdt = DTYPES[dtype][1]
    params = api.init_params(cfg, torch.Generator().manual_seed(0), tdt,
                             device="cpu")
    toks = torch.from_numpy(np.random.default_rng(16).integers(
        0, cfg.vocab_size, (2, 16)))
    full, _ = transformer.forward(cfg, params, {"tokens": toks})
    dec = _greedy_decode_all(cfg, params, toks, tdt)
    _close_model(dec, full, dtype, lambda: transformer.forward(
        cfg, _f32(params), {"tokens": toks})[0])


def test_loss_and_every_leaf_gradient_match_reference():
    """Reduced olmoe in f32 from the reference's init: ``loss_fn`` (ce +
    router_aux_coef · aux) within rtol 1e-5, and the gradient of every
    leaf within 1e-4 · max|grad of that leaf| of ``jax.value_and_grad`` of
    the reference's ``loss_fn`` (the router's through softmax, top-k and
    the aux loss; R6's zeroed slots carry no gradient in either)."""
    jcfg, tcfg, jp, tp = _model("olmoe_1b_7b", "f32")
    jb, tb = _batch(tcfg, 17, targets=True)
    (jloss, jm), jg = jax.value_and_grad(
        lambda p: japi.loss_fn(jcfg, p, jb), has_aux=True)(jp)
    tp = tree_map(lambda a: a.clone(), tp)
    leaves = [a.requires_grad_(True) for a in tree_leaves(tp)]
    loss, m = api.loss_fn(tcfg, tp, tb)
    grads = torch.autograd.grad(loss, leaves)
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=1e-5)
    np.testing.assert_allclose(float(m["ce"]), float(jm["ce"]), rtol=1e-5)
    np.testing.assert_allclose(float(m["aux"]), float(jm["aux"]), rtol=1e-5)
    assert float(loss) != float(m["ce"])
    ref = []
    tree_map(lambda a, r: ref.append(r), tp, convert.lm_tree_from_numpy(
        jax.tree.map(np.asarray, jg), "cpu"))
    assert len(ref) == len(grads)
    for g, r in zip(grads, ref):
        assert g.shape == r.shape
        top = float(r.abs().max())
        assert top > 0
        assert float((g - r).abs().max()) <= 1e-4 * top, (tuple(g.shape),
                                                          top)


def _smoke_batch(cfg, B=2, S=64, targets=True):
    """``tests/test_models_smoke.py``'s batch: S positions in all, the
    VLM's first num_prefix_tokens of them patch slots."""
    if cfg.frontend == "audio":
        b = {"frames": torch.ones((B, S, 512), dtype=torch.bfloat16)}
        tshape = (B, S)
    elif cfg.frontend == "vision":
        P = cfg.num_prefix_tokens
        b = {"tokens": torch.full((B, S - P), 3),
             "patches": torch.ones((B, P, 1024), dtype=torch.bfloat16)}
        tshape = (B, S - P)
    else:
        b = {"tokens": torch.full((B, S), 3)}
        tshape = (B, S)
    if targets:
        b["targets"] = torch.ones(tshape, dtype=torch.int64)
    return b, tshape


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_forward_shapes_and_finite(arch):
    cfg = get_reduced_config(arch)
    params = api.init_params(cfg, torch.Generator().manual_seed(0),
                             device="cpu")
    batch, tshape = _smoke_batch(cfg, targets=False)
    logits, _ = api.module_of(cfg).forward(cfg, params, batch)
    assert logits.shape == (*tshape, cfg.vocab_size)
    assert bool(torch.isfinite(logits).all())


@pytest.mark.parametrize("arch", TRANSFORMER_ARCHS)
def test_router_aux_only_for_the_moe(arch):
    """Only the MoE's feed-forward gives an aux loss: the other transformer
    families' blocks make no aux tensor, and their forward's aux is a
    single 0 (the recurrent families' is 0 too,
    ``tests/test_torch_recurrent.py``)."""
    cfg = get_reduced_config(arch)
    params = api.init_params(cfg, torch.Generator().manual_seed(0),
                             device="cpu")
    batch, _ = _smoke_batch(cfg, targets=False)
    lp = transformer._unbound_layers(params["layers"], cfg.num_layers)[0]
    x = torch.ones((2, 4, cfg.d_model), dtype=torch.bfloat16)
    _, layer_aux = transformer._ffn(cfg, lp, x)
    _, aux = transformer.forward(cfg, params, batch)
    if cfg.family == "moe":
        assert layer_aux.shape == () and float(aux) > 0
    else:
        assert layer_aux is None and float(aux) == 0.0


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_one_train_step_no_nans(arch):
    """One AdamW step of ``trainer.make_train_step``: finite loss and
    params, and the params move (the encoder's too: autograd runs through
    the plain non-causal attention on the CPU)."""
    cfg = get_reduced_config(arch)
    params = api.init_params(cfg, torch.Generator().manual_seed(0),
                             device="cpu")
    batch, _ = _smoke_batch(cfg)
    opt = optim.adamw()
    step = trainer.make_train_step(cfg, opt, optim.constant(1e-3))
    p2, _, s2, metrics = step(params, opt.init(params), 0, batch)
    assert s2 == 1 and np.isfinite(float(metrics["loss"]))
    for leaf in tree_leaves(p2):
        assert bool(torch.isfinite(leaf).all())
    assert any(not torch.equal(a, b) for a, b in
               zip(tree_leaves(params), tree_leaves(p2)))


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_hidden_states_for_elm_head(arch):
    cfg = get_reduced_config(arch)
    params = api.init_params(cfg, torch.Generator().manual_seed(0),
                             device="cpu")
    batch, tshape = _smoke_batch(cfg, targets=False)
    h = api.hidden_states(cfg, params, batch)
    assert h.shape == (*tshape, cfg.d_model)
    assert bool(torch.isfinite(h).all())


def test_vocab_padding_is_exact():
    """minicpm's odd vocab (513) padded to 528: the logits on real slots
    and the CE loss are bit-identical (``tests/test_extensions.py``)."""
    cfg = get_reduced_config("minicpm_2b")
    cfgp = replace(cfg, vocab_pad_to=16)
    assert cfgp.padded_vocab == 528 and cfg.tie_embeddings
    params = api.init_params(cfg, torch.Generator().manual_seed(0),
                             device="cpu")
    emb = torch.nn.functional.pad(params["embed"],
                                  (0, 0, 0, cfgp.padded_vocab - 513))
    paramsp = {**params, "embed": emb}
    toks = torch.from_numpy(np.random.default_rng(0).integers(0, 513,
                                                              (2, 16)))
    l1, _ = transformer.forward(cfg, params, {"tokens": toks})
    l2, _ = transformer.forward(cfgp, paramsp, {"tokens": toks})
    assert torch.equal(l1, l2[..., :513])
    assert (l2[..., 513:] == -1e30).all()
    batch = {"tokens": toks, "targets": torch.ones((2, 16),
                                                   dtype=torch.int64)}
    assert float(api.loss_fn(cfg, params, batch)[0]) == float(
        api.loss_fn(cfgp, paramsp, batch)[0])


# ---------------------------------------------------------------------------
# the encoder
# ---------------------------------------------------------------------------

def test_encoder_prefill_step_encodes():
    """``make_prefill_step`` of an encoder-only config is the full encode:
    logits at every frame, no cache (the reference's trainer.py:120-126)."""
    jcfg, tcfg, jp, tp = _model("hubert_xlarge", "f32")
    jb, tb = _batch(tcfg, 18)
    got = trainer.make_prefill_step(tcfg)(tp, tb)
    assert isinstance(got, torch.Tensor) and got.shape == (2, 24, 64)
    from repro.core import trainer as jtrainer
    _close(got, jtrainer.make_prefill_step(jcfg)(jp, jb), "f32")
    assert torch.equal(got, transformer.forward(tcfg, tp, tb)[0])


def test_run_lm_refuses_an_encoder_only_config():
    with pytest.raises(SystemExit, match="encoder-only"):
        serve.main(["--arch", "hubert_xlarge", "--reduced", "--device",
                    "cpu"])


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("B,S,H,KV,hd", [(2, 24, 4, 4, 64), (1, 37, 8, 2, 80),
                                         (2, 5, 4, 1, 32)])
def test_non_causal_plain_version_matches_reference_sdpa(B, S, H, KV, hd,
                                                         dtype):
    """``swa_attention_ref(causal=False)`` against the reference's
    ``_sdpa`` under the all-ones mask of ``attn_forward_bidirectional``,
    and the wrapper's CPU route through it."""
    jdt, tdt = DTYPES[dtype]
    rng = np.random.default_rng(S)
    q, k, v = (rng.normal(size=(B, S, n, hd)).astype(np.float32)
               for n in (H, KV, KV))
    jcfg = jreplace(jget_reduced("hubert_xlarge"), num_heads=H,
                    num_kv_heads=KV, head_dim=hd)
    ref = jattn._sdpa(jcfg, *(jnp.asarray(a).astype(jdt) for a in (q, k, v)),
                      jnp.ones((S, S), bool))
    tq, tk, tv = (torch.from_numpy(a).to(tdt) for a in (q, k, v))
    got = swa_ref.swa_attention_ref(tq, tk, tv, window=S, causal=False)
    _close(got, ref, dtype)
    assert torch.equal(got, swa_ops.swa_attention(tq, tk, tv, window=S,
                                                  causal=False))
    with pytest.raises(ValueError, match="window must be S"):
        swa_ops.swa_attention(tq, tk, tv, window=S - 1, causal=False)


def test_attn_forward_bidirectional_matches_reference():
    jcfg, tcfg, jp, tp = _model("hubert_xlarge", "f32")
    jl = jax.tree.map(lambda a: a[0], jp["layers"]["attn"])
    tl = {k: v[0] for k, v in tp["layers"]["attn"].items()}
    x = np.random.default_rng(19).normal(size=(2, 30, 256)).astype(
        np.float32)
    pos = np.tile(np.arange(30), (2, 1)).astype(np.int32)
    jy, (jk, jv) = jattn.attn_forward_bidirectional(
        jcfg, jl, jnp.asarray(x), jnp.asarray(pos))
    ty, (tk, tv) = attention.attn_forward_bidirectional(
        tcfg, tl, torch.from_numpy(x), torch.from_numpy(pos))
    for got, ref in ((ty, jy), (tk, jk), (tv, jv)):
        _close(got, ref, "f32")
    before = dict(kernels.LAUNCHES)
    attention.attn_forward_bidirectional(tcfg, tl, torch.from_numpy(x),
                                         torch.from_numpy(pos))
    assert kernels.LAUNCHES == before      # the CPU route launches nothing


# ---------------------------------------------------------------------------
# the ELM head over HuBERT
# ---------------------------------------------------------------------------

def _frame_task(C=6, F=512, seed=0):
    """``tests/test_elm_head.py``'s task: frames are class embeddings plus
    0.4 noise; (reference batch, port batch) per seed."""
    rng = np.random.default_rng(seed)
    class_emb = rng.normal(size=(C, F)).astype(np.float32)

    def make_batch(s):
        r = np.random.default_rng(1000 + s)
        y = r.integers(0, C, size=(2, 32))
        frames = (class_emb[y] + 0.4 * r.normal(size=(2, 32, F))).astype(
            np.float32)
        return ({"frames": jnp.asarray(frames, jnp.bfloat16),
                 "targets": jnp.asarray(y, jnp.int32)},
                {"frames": torch.from_numpy(frames).to(torch.bfloat16),
                 "targets": torch.from_numpy(y)})

    return make_batch, C


def test_elm_head_learns_frame_classification():
    """The port alone, as the reference's test: a random bf16 HuBERT, the
    head accumulated over 6 batches at λ 100, a held-out batch above 0.5
    accuracy (chance is 1/6)."""
    cfg = get_reduced_config("hubert_xlarge")
    params = api.init_params(cfg, torch.Generator().manual_seed(0),
                             device="cpu")
    make_batch, C = _frame_task()

    def feature_fn(p, b):
        return api.hidden_states(cfg, p, b)

    stats = None
    for i in range(6):
        stats = elm_head.accumulate_stats(feature_fn, params,
                                          make_batch(i)[1], C, stats)
    beta = elm_head.solve(stats, lam=100.0)
    b = make_batch(99)[1]
    pred = elm_head.predict(feature_fn, params, beta, b).argmax(-1)
    acc = float((pred.reshape(b["targets"].shape) == b["targets"]).float()
                .mean())
    assert acc > 0.5, acc


def test_hubert_head_matches_reference():
    """From the reference's f32 init: H within 1e-4 · max|h|, U and V
    after 3 batches within 1e-4 · max|ref|, β at λ 100 within 1e-3 ·
    max|β| (or twice the reference's f32 distance from the f64 solve), and
    the held-out scores from the reference's β within 1e-4 · max|score|
    (``tests/test_torch_elm_head.py``'s split: 192 frames leave U of rank
    192 < L 256, so a held-out batch sees β's solve error along
    directions the stats never held)."""
    jcfg, tcfg, jp, tp = _model("hubert_xlarge", "f32")
    make_batch, C = _frame_task(seed=1)

    def jf(p, b):
        return japi.hidden_states(jcfg, p, b)

    def tf(p, b):
        return api.hidden_states(tcfg, p, b)

    jb, tb = make_batch(0)
    h, jh = tf(tp, tb), jf(jp, jb)
    assert h.dtype == torch.float32
    np.testing.assert_array_less(np.abs(_np(h) - _np(jh)).max(),
                                 1e-4 * np.abs(_np(jh)).max())
    js = ts = None
    for i in range(3):
        jb, tb = make_batch(i)
        js = jhead.accumulate_stats(jf, jp, jb, C, js)
        ts = elm_head.accumulate_stats(tf, tp, tb, C, ts)
    for got, ref in ((ts.u, js.u), (ts.v, js.v)):
        assert np.abs(_np(got) - _np(ref)).max() <= 1e-4 * np.abs(
            _np(ref)).max()
    jbeta, beta = jhead.solve(js, 100.0), elm_head.solve(ts, 100.0)
    u, v = (np.asarray(a, np.float64) for a in (js.u, js.v))
    exact = np.linalg.solve(u + np.eye(len(u)) / 100.0, v)
    bar = max(1e-3 * np.abs(_np(jbeta)).max(),
              2 * np.abs(_np(jbeta) - exact).max())
    assert np.abs(_np(beta) - _np(jbeta)).max() <= bar
    jb, tb = make_batch(99)
    ref = jhead.predict(jf, jp, jbeta, jb)
    got = elm_head.predict(tf, tp, torch.from_numpy(np.array(jbeta)), tb)
    assert got.shape == (64, C)
    assert np.abs(_np(got) - _np(ref)).max() <= 1e-4 * np.abs(
        _np(ref)).max()
