"""The LM zoo's recurrent families in the port against the reference:
RWKV6 (``models/rwkv6.py``) and the Zamba2 hybrid (``models/zamba2.py``,
over the Mamba2 mixer of ``layers/ssm.py``), with ``layers/norms.py``
``layer_norm`` and the dispatch: configs, trees, layers, forward, hidden
states, prefill and decode, and the reference's decode tests
(``tests/test_decode.py``) and head-padding tests on the port. Their
training, ELM-head and serving paths are
``tests/test_torch_recurrent_paths.py``'s.

Every case starts from the reference's own init (``japi.init_params``),
handed over through ``convert.lm_tree_from_numpy``, and from tokens drawn
with numpy. The reference runs its layers unrolled (``unroll_layers=True``,
R5) in both precisions: its scanned form, compiled by XLA, keeps bf16
intermediates in f32, and RWKV6 has one in every precision (below), which
moves its f32 logits by 0.03 at max|logit| 4.4. Tolerances: f32 — the same
math with sums in another order — rtol/atol 1e-4; bf16 — 2e-2. Two rules
for whole-model outputs that miss those bars:

- bf16 (the twin rule of ``tests/test_torch_zoo.py``): the port within
  twice the reference's own distance from the same function in f32.
- f32 RWKV6: the model casts the per-head group norm's output to bf16 in
  every precision (the reference's ``_group_norm_heads``), so an f32
  difference of one ulp before that cast can flip a bf16 rounding and move
  a logit by ~1e-2. The port is then held within twice the distance of the
  reference from its one-ulp twin (the same function on parameters moved
  by one f32 ulp), the ill-conditioning the reference itself has there.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as jget_config
from repro.configs.base import get_reduced_config as jget_reduced
from repro.configs.base import replace as jreplace
from repro.layers import norms as jnorms
from repro.layers import ssm as jssm
from repro.models import api as japi
from repro.models import rwkv6 as jrwkv
from repro.models import zamba2 as jzamba
from repro_torch import convert
from repro_torch.configs import (ARCH_IDS, get_config, get_reduced_config,
                                 replace)
from repro_torch.core import trainer
from repro_torch.layers import norms, ssm
from repro_torch.models import api, rwkv6, zamba2
from repro_torch.tree import tree_leaves, tree_map

# the reference's threaded tests share the CPU with these workers
torch.set_num_threads(2)

KEY = jax.random.PRNGKey(3)
DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}
TOL = {"f32": 1e-4, "bf16": 2e-2}
ARCHS = ["rwkv6_3b", "zamba2_1p2b"]


def _np(x):
    return (x.detach().float().numpy() if isinstance(x, torch.Tensor)
            else np.asarray(x, np.float32))


def _close(got, ref, dtype):
    got, ref = _np(got), _np(ref)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    np.testing.assert_allclose(got, ref, rtol=TOL[dtype], atol=TOL[dtype])


def _within(got, ref, dtype):
    return bool(np.all(np.abs(got - ref) <= TOL[dtype] * (1 + np.abs(ref))))


def _close_model(got, ref, dtype, other):
    """A whole model's output: ``_close``'s bar, or, where an element
    misses it, max|got - ref| within twice max|ref - other()|: in bf16
    ``other`` is the reference's function in f32, in f32 its one-ulp twin
    (the module docstring's rules)."""
    got, ref = _np(got), _np(ref)
    assert got.shape == ref.shape
    if _within(got, ref, dtype):
        return
    own = float(np.abs(ref - _np(other())).max())
    assert float(np.abs(got - ref).max()) <= 2 * own, (
        float(np.abs(got - ref).max()), own)


def _nudged(tree):
    """A reference tree with every f32 leaf moved one ulp up."""
    def up(a):
        a = np.asarray(a)
        if a.dtype == np.float32:
            return jnp.asarray(np.nextafter(a, np.float32(np.inf)))
        return jnp.asarray(a)
    return jax.tree.map(up, tree)


def _f32_tree(tree):
    return jax.tree.map(
        lambda a: a.astype(jnp.float32)
        if jnp.issubdtype(a.dtype, jnp.floating) else a, tree)


def _cfgs(arch, chunk=None):
    jcfg, cfg = jget_reduced(arch), get_reduced_config(arch)
    if chunk is not None:
        jcfg, cfg = (jreplace(jcfg, ssm_chunk=chunk),
                     replace(cfg, ssm_chunk=chunk))
    return jcfg, cfg


def _model(arch, dtype, chunk=8):
    """(reference cfg, port cfg, reference params, port params); the
    reference runs its layers unrolled (R5, the module docstring). A chunk
    of 8 divides no prompt here, so every chunked form pads; ``chunk=None``
    keeps the config's."""
    jdt, _ = DTYPES[dtype]
    jcfg, cfg = _cfgs(arch, chunk)
    jp = japi.init_params(jcfg, KEY, jdt)
    jcfg = jreplace(jcfg, unroll_layers=True)
    return jcfg, cfg, jp, convert.lm_tree_from_numpy(
        jax.tree.map(np.asarray, jp), "cpu")


def _tokens(cfg, seed, B=2, S=21):
    t = np.random.default_rng(seed).integers(0, cfg.vocab_size, (B, S))
    return t.astype(np.int32)


def _batches(toks, targets=None):
    jb = {"tokens": jnp.asarray(toks)}
    tb = {"tokens": torch.from_numpy(toks).long()}
    if targets is not None:
        jb["targets"] = jnp.asarray(targets)
        tb["targets"] = torch.from_numpy(targets).long()
    return jb, tb


def _other(jcfg, jp, dtype, fn):
    """The reference function the rules of ``_close_model`` compare with:
    f32 on f32 parameters (bf16), or on parameters one ulp up (f32)."""
    if dtype == "bf16":
        return lambda: fn(jcfg, _f32_tree(jp))
    return lambda: fn(jcfg, _nudged(jp))


# ---------------------------------------------------------------------------
# configs, trees and dispatch
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_configs_equal_the_reference(arch):
    """The port's full and reduced configs are the reference's, field by
    field, and registered under their ids and aliases."""
    assert arch in ARCH_IDS
    assert dataclasses.asdict(get_config(arch)) == dataclasses.asdict(
        jget_config(arch))
    assert dataclasses.asdict(get_reduced_config(arch)) == \
        dataclasses.asdict(jget_reduced(arch))
    name = jget_config(arch).name
    assert get_config(name) == get_config(arch)


@pytest.mark.parametrize("arch,pad", [("rwkv6_3b", 0), ("rwkv6_3b", 4),
                                      ("zamba2_1p2b", 0)])
def test_init_params_mirror_the_reference_tree(arch, pad):
    """The same keys, shapes and dtypes as the reference's init (RWKV6's
    padded heads too, their columns zero), and ``convert`` carries the
    reference's tree across exactly."""
    jcfg, cfg = _cfgs(arch)
    if pad:
        jcfg, cfg = (jreplace(jcfg, rwkv_head_pad_to=pad),
                     replace(cfg, rwkv_head_pad_to=pad))
    jp = jax.tree.map(np.asarray, japi.init_params(jcfg, KEY))
    tp = api.init_params(cfg, torch.Generator().manual_seed(0),
                         device="cpu")
    jleaves = jax.tree_util.tree_leaves_with_path(jp)
    tflat = jax.tree_util.tree_leaves_with_path(
        tree_map(lambda a: a, tp), is_leaf=lambda a: isinstance(
            a, torch.Tensor))
    tleaves = {jax.tree_util.keystr(path): leaf for path, leaf in tflat}
    assert sorted(tleaves) == sorted(jax.tree_util.keystr(p)
                                     for p, _ in jleaves)
    for path, a in jleaves:
        t = tleaves[jax.tree_util.keystr(path)]
        assert tuple(t.shape) == a.shape, path
        assert str(t.dtype).split(".")[-1] == a.dtype.name, path
    if pad:
        D = cfg.d_model
        assert not tp["layers"]["w_k"][..., D:].any()
        assert not tp["layers"]["w_o"][:, D:].any()
    back = convert.to_numpy(convert.lm_tree_from_numpy(jp, "cpu"))
    for a, b in zip(jax.tree.leaves(jp), jax.tree.leaves(back)):
        np.testing.assert_array_equal(np.asarray(a, np.float32), b)


@pytest.mark.parametrize("family", ["ssm_mamba2", "no_such_family"])
def test_unknown_family_raises_value_error_in_both_packages(family):
    """The dispatch of both packages carries the transformer families,
    rwkv6 and zamba2; anything else, the reference's unused
    ``ssm_mamba2`` included, is a ``ValueError``."""
    jcfg, cfg = (jreplace(jget_reduced("qwen3_8b"), family=family),
                 replace(get_reduced_config("qwen3_8b"), family=family))
    with pytest.raises(ValueError, match="unknown family"):
        japi.module_of(jcfg)
    for call in (lambda: api.module_of(cfg),
                 lambda: api.init_params(cfg, None, device="cpu"),
                 lambda: trainer.make_prefill_step(cfg)(None, {})):
        with pytest.raises(ValueError, match="unknown family"):
            call()
    assert api.module_of(get_reduced_config("rwkv6_3b")) is rwkv6
    assert api.module_of(get_reduced_config("zamba2_1p2b")) is zamba2


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_layer_norm_matches_reference(dtype):
    jdt, tdt = DTYPES[dtype]
    rng = np.random.default_rng(0)
    x = (3 * rng.normal(size=(3, 5, 96)) + 1).astype(np.float32)
    s, b = (rng.normal(size=(96,)).astype(np.float32) for _ in range(2))
    want = jnorms.layer_norm(jnp.asarray(x, jdt), jnp.asarray(s),
                             jnp.asarray(b), 1e-5)
    got = norms.layer_norm(torch.from_numpy(x).to(tdt), torch.from_numpy(s),
                           torch.from_numpy(b), 1e-5)
    assert got.dtype == tdt
    if dtype == "f32":
        _close(got, want, dtype)
    else:   # both round one f32 result once: one bf16 ulp at most
        np.testing.assert_allclose(_np(got), _np(want), rtol=2 ** -8,
                                   atol=1e-6)


def test_softplus_is_jax_softplus():
    x = np.concatenate([np.linspace(-40, 40, 801),
                        np.random.default_rng(1).normal(size=200) * 30])
    x = x.astype(np.float32)
    got = ssm.softplus(torch.from_numpy(x)).numpy()
    want = np.asarray(jax.nn.softplus(jnp.asarray(x)))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)


def _wkv_inputs(S, B=2, H=3, P=64, seed=0):
    """r, k, v, lw, u, s0 at the model's scales: log-decays
    -exp(N(-1, 0.5)) (the decay LoRA around w0 = -1), a nonzero state."""
    rng = np.random.default_rng(seed)
    r, k, v = (rng.normal(size=(B, S, H, P)).astype(np.float32)
               for _ in range(3))
    lw = -np.exp(rng.normal(-1, 0.5, size=(B, S, H, P))).astype(np.float32)
    u = (0.5 * rng.normal(size=(H, P))).astype(np.float32)
    s0 = (0.1 * rng.normal(size=(B, H, P, P))).astype(np.float32)
    return r, k, v, lw, u, s0


@pytest.mark.parametrize("mode", ["scan", "chunked"])
@pytest.mark.parametrize("S", [32, 37])
def test_wkv_matches_reference(mode, S):
    """``_wkv_scan`` and ``_wkv_chunked`` (chunk 16; S = 37 pads) against
    the reference's on the same inputs: y and the final state, f32."""
    args = _wkv_inputs(S)
    jargs = [jnp.asarray(a) for a in args]
    targs = [torch.from_numpy(a) for a in args]
    if mode == "scan":
        jy, js = jrwkv._wkv_scan(*jargs)
        ty, ts = rwkv6._wkv_scan(*targs)
    else:
        jy, js = jrwkv._wkv_chunked(*jargs, 16)
        ty, ts = rwkv6._wkv_chunked(*targs, 16)
    assert ty.shape == (2, S, 3, 64)
    top = float(np.abs(np.asarray(jy)).max())
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=1e-4,
                               atol=1e-4 * top)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-4,
                               atol=1e-4 * float(np.abs(np.asarray(js)).max()))


def test_r8_chunked_wkv_clamp_drops_recent_keys():
    """ROADMAP R8, pinned in both packages: the chunked WKV clamps each
    key's ratio exp(-cum_j) at e^CLAMP, so once a chunk's log-decay sum
    passes -30 every later key's weight is cut by exp(-cum_j - 30),
    however recent the key. At a constant log-decay of -1.7 a step (the
    sum reaches -54.4 in a chunk of 32; RWKV6-3B's random init reaches
    -53.5 at full depth on the card, PERF.md) the reference's chunked
    output is exact through step 17 and departs from its scan from step
    18 on, by up to the size of the output itself; the port's chunked
    output is the reference's."""
    rng = np.random.default_rng(13)
    r, k, v = (rng.normal(size=(1, 32, 1, 64)).astype(np.float32)
               for _ in range(3))
    lw = np.full((1, 32, 1, 64), -1.7, np.float32)
    u = np.zeros((1, 64), np.float32)
    s0 = np.zeros((1, 1, 64, 64), np.float32)
    jargs = [jnp.asarray(a) for a in (r, k, v, lw, u, s0)]
    jscan, _ = jrwkv._wkv_scan(*jargs)
    jchunk, _ = jrwkv._wkv_chunked(*jargs, 32)
    gap = np.abs(np.asarray(jscan) - np.asarray(jchunk)).max(axis=(0, 2, 3))
    top = float(np.abs(np.asarray(jscan)).max())
    assert gap[:18].max() < 1e-3, gap          # cum_j >= -28.9: exact
    assert gap[18:].min() > 0.1 and gap.max() > 0.5 * top, (gap, top)
    tchunk, _ = rwkv6._wkv_chunked(*[torch.from_numpy(a) for a in
                                     (r, k, v, lw, u, s0)], 32)
    np.testing.assert_allclose(tchunk.numpy(), np.asarray(jchunk),
                               rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("S", [32, 37])
def test_wkv_chunked_equals_scan(S):
    """The port's two forms of the recurrence agree (the reference's
    ``test_rwkv_chunked_equals_scan`` at the operator): no log-decay sum
    inside a chunk of 16 reaches the clamp here."""
    args = [torch.from_numpy(a) for a in _wkv_inputs(S, seed=2)]
    ys, ss = rwkv6._wkv_scan(*args)
    yc, sc = rwkv6._wkv_chunked(*args, 16)
    np.testing.assert_allclose(yc.numpy(), ys.numpy(), rtol=1e-4,
                               atol=1e-4 * float(ys.abs().max()))
    np.testing.assert_allclose(sc.numpy(), ss.numpy(), rtol=1e-4,
                               atol=1e-4 * float(ss.abs().max()))


def _mamba_layer(dtype, chunk):
    jdt, _ = DTYPES[dtype]
    jcfg, cfg = _cfgs("zamba2_1p2b", chunk)
    jp = jssm.init_mamba2(jcfg, KEY, jdt)
    # A_log and dt_bias away from their zero init, so decays vary by head
    rng = np.random.default_rng(4)
    jp = {**jp, "A_log": jnp.asarray(rng.normal(size=4).astype(np.float32)),
          "dt_bias": jnp.asarray(rng.normal(size=4).astype(np.float32))}
    return jcfg, cfg, jp, convert.lm_tree_from_numpy(
        jax.tree.map(np.asarray, jp), "cpu")


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("S", [32, 45, 2])
def test_mamba2_forward_matches_reference(dtype, S):
    """``mamba2_forward`` (chunk 16: S = 45 pads with dt = 0, S = 2 is
    shorter than the conv's 3-step state) against the reference's: the
    output, the final state h and the conv state rebuilt from the last
    real inputs."""
    jdt, tdt = DTYPES[dtype]
    jcfg, cfg, jp, tp = _mamba_layer(dtype, 16)
    x = np.random.default_rng(S).normal(size=(2, S, 128)).astype(np.float32)
    jy, jst = jssm.mamba2_forward(jcfg, jp, jnp.asarray(x, jdt))
    ty, tst = ssm.mamba2_forward(cfg, tp, torch.from_numpy(x).to(tdt))
    assert ty.dtype == tdt and tst["conv"].shape == (2, 3, 256)
    _close(ty, jy, dtype)
    _close(tst["h"], jst["h"], dtype)
    _close(tst["conv"], jst["conv"], dtype)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_mamba2_decode_matches_reference(dtype):
    """Three ``mamba2_decode`` steps from a prefilled state, and the
    reference's zero ``mamba2_init_state``, against the reference's."""
    jdt, tdt = DTYPES[dtype]
    jcfg, cfg, jp, tp = _mamba_layer(dtype, 16)
    rng = np.random.default_rng(7)
    x = rng.normal(size=(2, 19, 128)).astype(np.float32)
    _, jst = jssm.mamba2_forward(jcfg, jp, jnp.asarray(x[:, :16], jdt))
    tst = convert.lm_tree_from_numpy(jax.tree.map(np.asarray, jst), "cpu")
    for t in range(16, 19):
        jy, jst = jssm.mamba2_decode(jcfg, jp, jnp.asarray(x[:, t:t + 1],
                                                           jdt), jst)
        ty, tst = ssm.mamba2_decode(cfg, tp, torch.from_numpy(
            x[:, t:t + 1]).to(tdt), tst)
        _close(ty, jy, dtype)
        _close(tst["h"], jst["h"], dtype)
    z = ssm.mamba2_init_state(cfg, 2, device="cpu")
    jz = jssm.mamba2_init_state(jcfg, 2)
    for name in ("h", "conv"):
        assert tuple(z[name].shape) == jz[name].shape
        assert str(z[name].dtype).split(".")[-1] == jz[name].dtype.name


# ---------------------------------------------------------------------------
# the models
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_matches_reference(arch, dtype):
    jcfg, cfg, jp, tp = _model(arch, dtype)
    toks = _tokens(cfg, 0)
    jb, tb = _batches(toks)
    want, _ = japi.module_of(jcfg).forward(jcfg, jp, jb)
    got, aux = api.module_of(cfg).forward(cfg, tp, tb)
    assert got.dtype == torch.float32 and float(aux) == 0.0
    _close_model(got, want, dtype, _other(
        jcfg, jp, dtype,
        lambda c, p: japi.module_of(c).forward(c, p, jb)[0]))


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_hidden_states_match_reference(arch, dtype):
    """The ELM head's H, (B, S, D) in the model's dtype."""
    jcfg, cfg, jp, tp = _model(arch, dtype)
    toks = _tokens(cfg, 1)
    jb, tb = _batches(toks)
    want = japi.hidden_states(jcfg, jp, jb)
    got = api.hidden_states(cfg, tp, tb)
    assert got.shape == (2, 21, cfg.d_model)
    assert got.dtype == DTYPES[dtype][1]
    _close_model(got, want, dtype, _other(
        jcfg, jp, dtype, lambda c, p: japi.hidden_states(c, p, jb)))


def _prefill(jcfg, cfg, jp, tp, toks):
    jb, tb = _batches(toks)
    return japi.prefill(jcfg, jp, jb), api.prefill(cfg, tp, tb)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_matches_reference(arch, dtype):
    """The last position's logits and every leaf of the decode cache (the
    RWKV6 states, Zamba2's h, conv and per-invocation k, v) against the
    reference's prefill."""
    jcfg, cfg, jp, tp = _model(arch, dtype)
    toks = _tokens(cfg, 2, S=19)
    (jl, jc), (tl, tc) = _prefill(jcfg, cfg, jp, tp, toks)
    assert tl.shape == (2, 1, cfg.vocab_size)
    other = _other(jcfg, jp, dtype, lambda c, p: japi.prefill(
        c, p, {"tokens": jnp.asarray(toks)}))
    _close_model(tl, jl, dtype, lambda: other()[0])
    assert sorted(tc) == sorted(jc)
    for name in jc:
        assert tuple(tc[name].shape) == jc[name].shape, name
        assert str(tc[name].dtype).split(".")[-1] == jc[name].dtype.name
        _close_model(tc[name], jc[name], dtype,
                     lambda name=name: other()[1][name])
    if arch == "zamba2_1p2b":
        assert tc["k"].shape[2] == 19       # W = min(S, window): R7


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_reference(arch, dtype):
    """Four decode steps from the reference's own prefill cache (converted
    once), each step's logits against the reference's decode_step."""
    jcfg, cfg, jp, tp = _model(arch, dtype)
    toks = _tokens(cfg, 3, S=20)
    jl, jc = japi.prefill(jcfg, jp, {"tokens": jnp.asarray(toks[:, :16])})
    tc = convert.lm_tree_from_numpy(jax.tree.map(np.asarray, jc), "cpu")
    for t in range(16, 20):
        jl, jc = japi.decode_step(jcfg, jp, jc, jnp.asarray(toks[:, t:t + 1]),
                                  jnp.asarray(t, jnp.int32))
        tl, tc = api.decode_step(cfg, tp, tc,
                                 torch.from_numpy(toks[:, t:t + 1]).long(), t)
        _close(tl, jl, dtype)


def _greedy_decode_all(cfg, params, toks):
    B, S = toks.shape
    cache = api.init_cache(cfg, B, S, device="cpu")
    outs = []
    for t in range(S):
        lg, cache = api.decode_step(cfg, params, cache, toks[:, t:t + 1], t)
        outs.append(lg)
    return torch.cat(outs, dim=1)


def _reference_tokens(cfg, shape):
    """The tokens the reference's ``tests/test_decode.py`` draws from its
    KEY, so its cases run on the port with their own inputs."""
    return torch.from_numpy(np.asarray(jax.random.randint(
        KEY, shape, 0, cfg.vocab_size))).long()


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_forward(arch):
    """The reference's ``tests/test_decode.py::test_decode_matches_forward``
    on the port, on its inputs (its init and tokens from KEY): bf16, Zamba2
    at chunk 8, 16 tokens decoded from a zero cache against the forward, at
    its bars (rtol/atol 2e-2), or by the module docstring's bf16 twin rule:
    the decode within twice the forward's distance from the reference's
    function in f32. (The reference's unrolled form decodes RWKV6 bitwise
    its forward on these inputs; the port's chunked forward rounds one
    group-norm output to the other bf16 neighbour, and its decode, bitwise
    the reference's decode, misses the bar there by 6 %.)"""
    jcfg, cfg, jp, tp = _model(arch, "bf16",
                               chunk=8 if arch == "zamba2_1p2b" else None)
    toks = _reference_tokens(cfg, (2, 16))
    full, _ = api.module_of(cfg).forward(cfg, tp, {"tokens": toks})
    dec = _greedy_decode_all(cfg, tp, toks)
    _close_model(dec, full, "bf16", lambda: japi.module_of(jcfg).forward(
        jcfg, _f32_tree(jp), {"tokens": jnp.asarray(toks.numpy())})[0])


def test_rwkv_state_is_constant_size():
    cfg = get_reduced_config("rwkv6_3b")
    c1 = api.init_cache(cfg, 2, 64, device="cpu")
    c2 = api.init_cache(cfg, 2, 524288, device="cpu")
    assert {k: tuple(v.shape) for k, v in c1.items()} == \
        {k: tuple(v.shape) for k, v in c2.items()}


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_then_decode_continues_correctly(arch):
    """The reference's ``test_prefill_then_decode_continues_correctly``:
    prefill(prompt) against forward(prompt + next) at the prompt's last
    position, and for RWKV6 one decode step against the next position
    (its bar 6e-2: chunked prefill vs scan decode in bf16), on its inputs.
    Zamba2's step after the prefill is R7's (``test_r7_...``)."""
    _, cfg, _, tp = _model(arch, "bf16",
                           chunk=8 if arch == "zamba2_1p2b" else None)
    S = 16
    toks = _reference_tokens(cfg, (2, S + 1))
    full, _ = api.module_of(cfg).forward(cfg, tp, {"tokens": toks})
    lg_pre, cache = api.prefill(cfg, tp, {"tokens": toks[:, :S]},
                                max_len=S + 4)
    np.testing.assert_allclose(_np(lg_pre[:, 0]), _np(full[:, S - 1]),
                               rtol=2e-2, atol=2e-2)
    if arch == "rwkv6_3b":
        lg, _ = api.decode_step(cfg, tp, cache, toks[:, S:S + 1], S)
        np.testing.assert_allclose(_np(lg[:, 0]), _np(full[:, S]),
                                   rtol=6e-2, atol=6e-2)


def test_rwkv_chunked_equals_scan():
    """The reference's ``test_rwkv_chunked_equals_scan`` on the port: the
    whole model in bf16, 64 tokens, at its bar 5e-2, on its inputs."""
    _, cfg, _, tp = _model("rwkv6_3b", "bf16", chunk=None)
    toks = _reference_tokens(cfg, (2, 64))
    l1, _ = rwkv6.forward(cfg, tp, {"tokens": toks}, mode="scan")
    l2, _ = rwkv6.forward(cfg, tp, {"tokens": toks}, mode="chunked")
    np.testing.assert_allclose(_np(l1), _np(l2), rtol=5e-2, atol=5e-2)


def test_zamba_shared_block_weight_reuse():
    """One shared attention block (unstacked weights), one KV slot per
    invocation in the cache, and the port's plan the reference's."""
    cfg = get_reduced_config("zamba2_1p2b")
    params = zamba2.init_params(cfg, torch.Generator().manual_seed(0),
                                device="cpu")
    assert params["shared"]["attn"]["wq"].dim() == 2
    assert zamba2.num_attn_invocations(cfg) >= 1
    cache = api.init_cache(cfg, 2, 32, device="cpu")
    assert cache["k"].shape[0] == zamba2.num_attn_invocations(cfg)
    for L, every in [(38, 6), (2, 2), (5, 2), (3, 4)]:
        c = replace(cfg, num_layers=L, shared_attn_every=every)
        jc = jreplace(jget_reduced("zamba2_1p2b"), num_layers=L,
                      shared_attn_every=every)
        assert zamba2._plan(c) == jzamba._plan(jc)
        assert zamba2.num_attn_invocations(c) == \
            jzamba.num_attn_invocations(jc)
    assert zamba2.num_attn_invocations(get_config("zamba2_1p2b")) == 6


def test_zamba_kv_slots_match_reference():
    """Two shared invocations (4 layers, every 2): the cache holds two KV
    slots, each the reference's, and decode writes each invocation's slot
    with that invocation's keys."""
    jcfg = jreplace(jget_reduced("zamba2_1p2b"), num_layers=4, ssm_chunk=8)
    cfg = replace(get_reduced_config("zamba2_1p2b"), num_layers=4,
                  ssm_chunk=8)
    jp = japi.init_params(jcfg, KEY, jnp.float32)
    tp = convert.lm_tree_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    toks = _tokens(cfg, 8, S=12)
    jl, jc = japi.prefill(jcfg, jp, {"tokens": jnp.asarray(toks[:, :10])})
    tl, tc = api.prefill(cfg, tp, {"tokens": torch.from_numpy(
        toks[:, :10]).long()})
    assert tc["k"].shape[0] == 2
    for name in ("k", "v"):
        _close(tc[name], jc[name], "f32")
    assert not torch.equal(tc["k"][0], tc["k"][1])
    tcj = convert.lm_tree_from_numpy(jax.tree.map(np.asarray, jc), "cpu")
    _, jc2 = japi.decode_step(jcfg, jp, jc, jnp.asarray(toks[:, 10:11]),
                              jnp.asarray(10, jnp.int32))
    _, tc2 = api.decode_step(cfg, tp, tcj, torch.from_numpy(
        toks[:, 10:11]).long(), 10)
    for name in ("k", "v", "h", "conv"):
        _close(tc2[name], jc2[name], "f32")


def test_r7_zamba2_decode_after_prefill_departs_from_forward():
    """ROADMAP R7, pinned in both packages: the reference's prefill sizes
    the shared block's KV slot to the prompt (W = min(S, window)), so
    decoding from it overwrites the oldest position. At f32, chunk 8,
    prompt 16, its decode logits depart from ``forward`` of the longer
    sequence by more than 1e-2, while the same cache padded by 4 empty
    slots agrees; the port reproduces the reference's decode, departure
    included."""
    jcfg, cfg, jp, tp = _model("zamba2_1p2b", "f32")
    S, n = 16, 4
    toks = _tokens(cfg, 9, S=S + n)
    full, _ = jzamba.forward(jcfg, jp, {"tokens": jnp.asarray(toks)})
    _, jc = japi.prefill(jcfg, jp, {"tokens": jnp.asarray(toks[:, :S])})
    _, tc = api.prefill(cfg, tp, {"tokens": torch.from_numpy(
        toks[:, :S]).long()})
    pad = {k: (jnp.pad(a, ((0, 0), (0, 0), (0, n), (0, 0), (0, 0)))
               if k in ("k", "v") else a) for k, a in jc.items()}
    gaps, padded_gaps = [], []
    for t in range(S, S + n):
        tok = toks[:, t:t + 1]
        jl, jc = japi.decode_step(jcfg, jp, jc, jnp.asarray(tok),
                                  jnp.asarray(t, jnp.int32))
        pl, pad = japi.decode_step(jcfg, jp, pad, jnp.asarray(tok),
                                   jnp.asarray(t, jnp.int32))
        tl, tc = api.decode_step(cfg, tp, tc, torch.from_numpy(tok).long(), t)
        ref_full = np.asarray(full[:, t])
        gaps.append(float(np.abs(np.asarray(jl[:, 0]) - ref_full).max()))
        padded_gaps.append(float(np.abs(np.asarray(pl[:, 0])
                                        - ref_full).max()))
        _close(tl, jl, "f32")
    assert max(gaps) > 1e-2, gaps
    assert max(padded_gaps) < 1e-4, padded_gaps


def test_rwkv_head_padding_is_exact():
    """``pad_head_params`` (2 heads padded to 4): the padded model's logits
    are bitwise the unpadded one's."""
    cfg = get_reduced_config("rwkv6_3b")
    cfgp = replace(cfg, rwkv_head_pad_to=4)
    params = rwkv6.init_params(cfg, torch.Generator().manual_seed(0),
                               device="cpu")
    padded = rwkv6.pad_head_params(params, cfg, cfgp)
    assert padded["layers"]["w_k"].shape[-1] == 4 * 64
    toks = torch.from_numpy(_tokens(cfg, 10, S=32)).long()
    l1, _ = rwkv6.forward(cfg, params, {"tokens": toks})
    l2, _ = rwkv6.forward(cfgp, padded, {"tokens": toks})
    assert torch.equal(l1, l2)


def test_rwkv_head_padding_grads_stay_zero():
    cfg = replace(get_reduced_config("rwkv6_3b"), rwkv_head_pad_to=4)
    params = rwkv6.init_params(cfg, torch.Generator().manual_seed(0),
                               device="cpu")
    leaves = [a.requires_grad_(True) for a in tree_leaves(params)]
    toks = torch.from_numpy(_tokens(cfg, 11, S=16)).long()
    lg, _ = rwkv6.forward(cfg, params, {"tokens": toks})
    torch.mean(lg.float() ** 2).backward()
    D = cfg.d_model
    assert float(params["layers"]["w_k"].grad[:, :, D:].abs().max()) == 0.0
    assert float(params["layers"]["w_o"].grad[:, D:, :].abs().max()) == 0.0
    assert all(a.grad is not None for a in leaves)
