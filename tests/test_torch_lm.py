"""The port's dense-decoder serving path against the reference's.

Reduced ``qwen3_8b`` (2 layers, d 256, 4 heads over 2 KV heads, hd 64,
vocab 512): the reference initialises the parameters, ``repro_torch.convert``
hands them over leaf by leaf, and both packages run the same tokens (numpy,
from a seed) through ``forward``, ``prefill`` and ``decode_step`` on the CPU,
where the port's wrappers run their kernels' plain versions.

Tolerances: f32 parameters — the same math with sums in another order —
rtol 1e-4, atol 1e-4 on logits of size ~4; bf16 parameters — sums in
another order before each bf16 rounding — ``tests/test_decode.py``'s own
bars, rtol 2e-2 and atol 2e-2.

With bf16 parameters the reference runs its layers unrolled
(``unroll_layers=True``, its Python-loop form of ``layer_scan``, which is
the form the port's layer loop takes). XLA compiles a scanned layer body as
one fusion that may keep bf16 intermediates in f32 (excess precision), so
the scanned reference differs from the same reference run op by op by as
much as 0.043 on these logits, over the 2e-2 bar; the unrolled reference
rounds every bf16 value as the code is written, as the port does.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs.base import get_reduced_config as jget_reduced
from repro.configs.base import replace as jreplace
from repro.layers import attention as jattn
from repro.layers import mlp as jmlp
from repro.layers import norms as jnorms
from repro.layers import rope as jrope
from repro.models import api as japi
from repro.models import transformer as jtf
from repro_torch import convert, kernels
from repro_torch.configs import get_reduced_config, replace
from repro_torch.core import trainer
from repro_torch.launch import serve
from repro_torch.layers import attention, mlp, norms, rope
from repro_torch.models import api, transformer

# the reference's threaded tests share the CPU with these workers
torch.set_num_threads(2)

KEY = jax.random.PRNGKey(3)
DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}
TOL = {"f32": 1e-4, "bf16": 2e-2}


def _cfgs(window=0):
    return (jreplace(jget_reduced("qwen3_8b"), sliding_window=window),
            replace(get_reduced_config("qwen3_8b"), sliding_window=window))


def _np(x):
    return np.asarray(x, np.float32)


def _close(got, ref, dtype):
    got = got.float().numpy() if isinstance(got, torch.Tensor) else _np(got)
    ref = _np(ref)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=TOL[dtype], atol=TOL[dtype])


def _tokens(seed, shape, vocab):
    return np.random.default_rng(seed).integers(0, vocab, shape).astype(
        np.int32)


@pytest.fixture(scope="module")
def models():
    """Reference params per (sliding window, dtype), with their port copies."""
    out = {}
    for window in (0, 8):
        jcfg, tcfg = _cfgs(window)
        for dtype, (jdt, _) in DTYPES.items():
            jp = japi.init_params(jcfg, KEY, jdt)
            if dtype == "bf16":
                jcfg = jreplace(jcfg, unroll_layers=True)
            tp = convert.lm_tree_from_numpy(jax.tree.map(np.asarray, jp),
                                            "cpu")
            out[window, dtype] = (jcfg, tcfg, jp, tp)
    return out


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("shape", [(2, 16, 4, 64), (1, 5, 2, 128)])
def test_rope_matches_reference(shape, dtype):
    x = np.random.default_rng(0).normal(size=shape).astype(np.float32)
    pos = np.tile(np.arange(shape[1]) * 37, (shape[0], 1)).astype(np.int32)
    jdt, tdt = DTYPES[dtype]
    ref = jrope.apply_rope(jnp.asarray(x).astype(jdt), jnp.asarray(pos),
                           1_000_000.0)
    got = rope.apply_rope(torch.from_numpy(x).to(tdt),
                          torch.from_numpy(pos), 1_000_000.0)
    assert got.dtype == tdt
    _close(got, ref, dtype)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_rms_norm_layer_matches_reference(dtype):
    x = np.random.default_rng(1).normal(size=(2, 9, 256)).astype(np.float32)
    s = np.random.default_rng(2).normal(size=256).astype(np.float32)
    jdt, tdt = DTYPES[dtype]
    ref = jnorms.rms_norm(jnp.asarray(x).astype(jdt), jnp.asarray(s), 1e-6)
    got = norms.rms_norm(torch.from_numpy(x).to(tdt), torch.from_numpy(s),
                         1e-6)
    assert got.dtype == tdt
    _close(got, ref, dtype)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_swiglu_matches_reference(dtype):
    jdt, tdt = DTYPES[dtype]
    jp = jmlp.init_swiglu(64, 96, KEY, jdt)
    tp = convert.lm_tree_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    x = np.random.default_rng(3).normal(size=(2, 7, 64)).astype(np.float32)
    ref = jmlp.swiglu(jp, jnp.asarray(x).astype(jdt))
    got = mlp.swiglu(tp, torch.from_numpy(x).to(tdt))
    _close(got, ref, dtype)


@pytest.mark.parametrize("window", [0, 8, 33])
def test_attn_forward_matches_reference(models, window):
    jcfg, tcfg, jp, tp = models[0, "f32"]
    jl = jax.tree.map(lambda a: a[0], jp["layers"]["attn"])
    tl = {k: v[0] for k, v in tp["layers"]["attn"].items()}
    x = np.random.default_rng(4).normal(size=(2, 40, 256)).astype(np.float32)
    pos = np.tile(np.arange(40), (2, 1)).astype(np.int32)
    jy, (jk, jv) = jattn.attn_forward(jcfg, jl, jnp.asarray(x),
                                      jnp.asarray(pos), window=window)
    ty, (tk, tv) = attention.attn_forward(tcfg, tl, torch.from_numpy(x),
                                          torch.from_numpy(pos),
                                          window=window)
    _close(ty, jy, "f32")
    _close(tk, jk, "f32")
    _close(tv, jv, "f32")


@pytest.mark.parametrize("window", [0, 8])
def test_attn_decode_matches_reference(models, window):
    """One decode step into a half-full cache (the ring buffer wraps for
    window 8): output and updated cache."""
    jcfg, tcfg, jp, tp = models[window, "f32"]
    jl = jax.tree.map(lambda a: a[1], jp["layers"]["attn"])
    tl = {k: v[1] for k, v in tp["layers"]["attn"].items()}
    rng = np.random.default_rng(5)
    T = 8 if window else 24
    ck, cv = (rng.normal(size=(2, T, 2, 64)).astype(np.float32)
              for _ in range(2))
    x = rng.normal(size=(2, 1, 256)).astype(np.float32)
    for pos in (3, 11):
        jy, (jk, jv) = jattn.attn_decode(jcfg, jl, jnp.asarray(x),
                                         (jnp.asarray(ck), jnp.asarray(cv)),
                                         jnp.asarray(pos, jnp.int32))
        ty, (tk, tv) = attention.attn_decode(
            tcfg, tl, torch.from_numpy(x),
            (torch.from_numpy(ck.copy()), torch.from_numpy(cv.copy())), pos)
        _close(ty, jy, "f32")
        _close(tk, jk, "f32")
        _close(tv, jv, "f32")


# ---------------------------------------------------------------------------
# the model: forward, prefill, decode_step against the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("window", [0, 8])
def test_forward_matches_reference(models, window, dtype):
    jcfg, tcfg, jp, tp = models[window, dtype]
    toks = _tokens(10, (2, 24), jcfg.vocab_size)
    ref, _ = jtf.forward(jcfg, jp, {"tokens": jnp.asarray(toks)})
    got, aux = transformer.forward(tcfg, tp,
                                   {"tokens": torch.from_numpy(toks)})
    assert got.dtype == torch.float32 and float(aux) == 0.0
    _close(got, ref, dtype)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("window", [0, 8])
def test_prefill_matches_reference(models, window, dtype):
    """Last-position logits and the KV cache, padded to max_len (full
    attention) or cut to the window (sliding window)."""
    jcfg, tcfg, jp, tp = models[window, dtype]
    toks = _tokens(11, (2, 16), jcfg.vocab_size)
    ref, jcache = japi.prefill(jcfg, jp, {"tokens": jnp.asarray(toks)},
                               max_len=20)
    got, cache = api.prefill(tcfg, tp, {"tokens": torch.from_numpy(toks)},
                             max_len=20)
    _close(got, ref, dtype)
    for name in ("k", "v"):
        assert cache[name].dtype == DTYPES[dtype][1]
        _close(cache[name], jcache[name], dtype)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("window", [0, 8])
def test_decode_step_matches_reference(models, window, dtype):
    """Three decode steps from the reference's own prefill cache: logits
    and cache after each (the ring buffer wraps for window 8)."""
    jcfg, tcfg, jp, tp = models[window, dtype]
    toks = _tokens(12, (2, 19), jcfg.vocab_size)
    _, jcache = japi.prefill(jcfg, jp, {"tokens": jnp.asarray(toks[:, :16])},
                             max_len=20)
    cache = convert.lm_tree_from_numpy(jax.tree.map(np.asarray, jcache),
                                       "cpu")
    for pos in (16, 17, 18):
        tok = toks[:, pos:pos + 1]
        ref, jcache = japi.decode_step(jcfg, jp, jcache, jnp.asarray(tok),
                                       jnp.asarray(pos, jnp.int32))
        got, cache = api.decode_step(tcfg, tp, cache, torch.from_numpy(tok),
                                     pos)
        _close(got, ref, dtype)
        for name in ("k", "v"):
            _close(cache[name], jcache[name], dtype)


# ---------------------------------------------------------------------------
# the port against itself
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
@pytest.mark.parametrize("window", [0, 8])
def test_decode_matches_forward(window, dtype):
    """Token-by-token decode equals the full forward (test_decode.py's
    check, inside the port)."""
    _, cfg = _cfgs(window)
    tdt = DTYPES[dtype][1]
    params = api.init_params(cfg, torch.Generator().manual_seed(0), tdt,
                             device="cpu")
    toks = torch.from_numpy(_tokens(13, (2, 24), cfg.vocab_size))
    full, _ = transformer.forward(cfg, params, {"tokens": toks})
    dec = _greedy_decode_all(cfg, params, toks, tdt)
    np.testing.assert_allclose(dec.numpy(), full.numpy(), rtol=TOL[dtype],
                               atol=TOL[dtype])


def test_prefill_then_decode_continues_correctly():
    _, cfg = _cfgs()
    params = api.init_params(cfg, torch.Generator().manual_seed(1),
                             torch.float32, device="cpu")
    toks = torch.from_numpy(_tokens(14, (2, 17), cfg.vocab_size))
    full, _ = transformer.forward(cfg, params, {"tokens": toks})
    lg, cache = trainer.make_prefill_step(cfg)(params,
                                               {"tokens": toks[:, :16]})
    np.testing.assert_allclose(lg[:, 0].numpy(), full[:, 15].numpy(),
                               rtol=1e-4, atol=1e-4)
    _, cache = api.prefill(cfg, params, {"tokens": toks[:, :16]}, max_len=20)
    assert cache["k"].shape == (2, 2, 20, 2, 64)
    lg, _ = api.decode_step(cfg, params, cache, toks[:, 16:17], 16)
    np.testing.assert_allclose(lg[:, 0].numpy(), full[:, 16].numpy(),
                               rtol=1e-4, atol=1e-4)


def test_init_params_mirror_the_reference_tree():
    """Same leaves, shapes and dtypes as the reference's init; padded vocab
    rows zero; the reference's scales."""
    jcfg = jreplace(jget_reduced("qwen3_8b"), vocab_pad_to=96)
    cfg = replace(get_reduced_config("qwen3_8b"), vocab_pad_to=96)
    jp = jax.tree.map(np.asarray, japi.init_params(jcfg, KEY))
    tp = api.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    jleaves = jax.tree_util.tree_leaves_with_path(jp)
    tleaves = {jax.tree_util.keystr(path): leaf for path, leaf in
               jax.tree_util.tree_leaves_with_path(tp)}
    assert len(jleaves) == len(tleaves)
    for path, leaf in jleaves:
        t = tleaves[jax.tree_util.keystr(path)]
        assert tuple(t.shape) == leaf.shape
        assert str(t.dtype).split(".")[-1] == leaf.dtype.name
    assert cfg.padded_vocab == 576 > cfg.vocab_size
    assert (tp["embed"][cfg.vocab_size:] == 0).all()
    assert abs(float(tp["unembed"].float().std()) - 256 ** -0.5) < 2e-3
    logits, _ = transformer.forward(cfg, tp, {"tokens": torch.zeros(
        (1, 4), dtype=torch.int64)})
    assert (logits[..., cfg.vocab_size:] == -1e30).all()


def test_ring_buffer_cache_is_constant_size():
    _, cfg = _cfgs(8)
    cache = api.init_cache(cfg, 2, 1024, device="cpu")
    assert cache["k"].shape == (2, 2, 8, 2, 64)
    assert cache["k"].dtype == torch.bfloat16


def test_bf16_trees_convert_exactly():
    jcfg, _ = _cfgs()
    jp = jax.tree.map(np.asarray, japi.init_params(jcfg, KEY))
    tp = convert.lm_tree_from_numpy(jp, "cpu")
    assert tp["layers"]["attn"]["wq"].dtype == torch.bfloat16
    assert tp["layers"]["ln1"].dtype == torch.float32
    back = convert.to_numpy(tp)
    for a, b in zip(jax.tree.leaves(jp), jax.tree.leaves(back)):
        np.testing.assert_array_equal(np.asarray(a, np.float32), b)


@pytest.mark.parametrize("argv", [
    ["--reduced", "--device", "cpu", "--batch", "2", "--prompt-len", "12",
     "--gen", "6"],
    ["--reduced", "--device", "cpu", "--batch", "1", "--prompt-len", "7",
     "--gen", "3", "--seed", "5"],
])
def test_serve_main_runs_on_cpu(argv, capsys):
    before = dict(kernels.LAUNCHES)
    out = serve.main(argv)
    assert kernels.LAUNCHES == before   # the CPU path launches no kernel
    batch, gen = int(argv[argv.index("--batch") + 1]), int(
        argv[argv.index("--gen") + 1])
    assert out["prefill_ms"] > 0 and out["tokens_per_s"] > 0
    assert out["tokens"].shape == (batch, gen)
    assert ((out["tokens"] >= 0) & (out["tokens"] < 512)).all()
    assert out["logits_finite"]
    # the replayed prompt ends where the prefill ended (bf16 weights)
    assert out["prefill_replay_gap"] <= 2e-2 * (1 + out["max_abs_logit"])
    assert "tok/s" in capsys.readouterr().out
