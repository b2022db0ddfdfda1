"""The dry run (``repro_torch.launch.dryrun``) and its cost table
(``launch.cost_analysis``), held against the reference on the CPU.

* the shape contract — ``INPUT_SHAPES``, ``supported_shapes``, the
  long_500k window, ``input_specs`` and ``cache_specs`` — against
  ``repro.configs.base``, ``repro.models.api`` and ``jax.eval_shape`` of
  the reference's ``init_cache``, for every arch × supported shape;
* parameter and AdamW-state shapes, dtypes and bytes at full size against
  ``jax.eval_shape`` of the reference's init trees (the port's AdamW
  moments are f32, as the reference's);
* a meta trace of reduced models: the kernel operators it calls, by the
  formulas ``chip_smoke.py`` holds the card's launches to, and its FLOPs
  outside the kernel operators against ``FlopCounterMode``'s count of the
  same step on real CPU tensors with the plain versions hidden from it;
* each kernel's FLOP formula against its plain version's count;
* the roofline terms and ring multipliers, the Reduce's all-reduce bytes
  as ``distributed.collectives`` counts them, and the launcher in
  subprocesses that must not import JAX.

The reference's dry run itself (``repro.launch.dryrun.lower_combo``) does
not run on this toolchain (ROADMAP R1), so the parity is held on what
needs no mesh. Importing its module appends a forced device count to
``XLA_FLAGS``; the import runs under a patched environment that is
restored at once.
"""
import json
import os
import subprocess
import sys
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import (TorchDispatchMode,
                                          _disable_current_modes)
from torch.utils.flop_counter import FlopCounterMode

from repro import optim as joptim
from repro.configs import base as jbase
from repro.models import api as japi
from repro_torch import kernels, optim
from repro_torch.configs import base as tbase
from repro_torch.configs import get_reduced_config
from repro_torch.core import trainer
from repro_torch.distributed import collectives
from repro_torch.kernels.conv2d import ops as conv_ops, ref as conv_ref
from repro_torch.kernels.elm_stats import ops as st_ops, ref as st_ref
from repro_torch.kernels.rmsnorm import ops as rms_ops, ref as rms_ref
from repro_torch.kernels.swa_attention import ops as swa_ops
from repro_torch.kernels.swa_attention import ref as swa_ref
from repro_torch.launch import cost_analysis, dryrun
from repro_torch.models import api, zamba2
from repro_torch.tree import tree_leaves, tree_map

with mock.patch.dict(os.environ):
    from repro.launch import dryrun as jdryrun

torch.set_num_threads(2)

ROOT = os.path.join(os.path.dirname(__file__), "..")
LM_ARCHS = [a for a in tbase.ARCH_IDS if not a.startswith("cnn_elm")]
_JDT = {jnp.dtype(jnp.int32): torch.int32,
        jnp.dtype(jnp.bfloat16): torch.bfloat16,
        jnp.dtype(jnp.float32): torch.float32}


def _flat(tree, pre=""):
    """{path: leaf} of a nested dict / tuple / list tree."""
    if isinstance(tree, dict):
        return {k: v for key, sub in tree.items()
                for k, v in _flat(sub, f"{pre}/{key}").items()}
    if isinstance(tree, (list, tuple)):
        return {k: v for i, sub in enumerate(tree)
                for k, v in _flat(sub, f"{pre}/{i}").items()}
    return {pre: tree}


def _jspecs(tree):
    return {k: (tuple(v.shape), _JDT[jnp.dtype(v.dtype)])
            for k, v in _flat(tree).items()}


def _tspecs(tree):
    return {k: (tuple(v.shape), v.dtype) for k, v in _flat(tree).items()}


def _nbytes(specs):
    return sum(int(np.prod(s)) * d.itemsize for s, d in specs.values())


# ---------------------------------------------------------------------------
# The shape contract
# ---------------------------------------------------------------------------

def test_input_shapes_supported_shapes_and_window_match_reference():
    assert list(tbase.INPUT_SHAPES) == list(jbase.INPUT_SHAPES)
    for name, shp in tbase.INPUT_SHAPES.items():
        j = jbase.INPUT_SHAPES[name]
        assert (shp.name, shp.seq_len, shp.global_batch, shp.kind) == \
            (j.name, j.seq_len, j.global_batch, j.kind)
    assert sorted(tbase.ARCH_IDS) == sorted(jbase.ARCH_IDS)
    for arch in tbase.ARCH_IDS:
        tc, jc = tbase.get_config(arch), jbase.get_config(arch)
        assert tbase.supported_shapes(tc) == jbase.supported_shapes(jc)
        for name in tbase.INPUT_SHAPES:
            assert dryrun.shape_cfg(tc, tbase.INPUT_SHAPES[name]) \
                .sliding_window == jdryrun._shape_cfg(
                    jc, jbase.INPUT_SHAPES[name]).sliding_window, \
                (arch, name)
    assert dryrun.shape_cfg(tbase.get_config("qwen3_8b"),
                            tbase.INPUT_SHAPES["long_500k"]) \
        .sliding_window == 4096


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_input_and_cache_specs_match_reference(arch):
    """Every supported shape: the batch (or token and pos) specs equal the
    reference's ``api.input_specs``, and a decode's cache specs equal
    ``jax.eval_shape`` of its ``init_cache`` — after each side's long_500k
    window."""
    ok = tbase.supported_shapes(tbase.get_config(arch))
    for name, shape in tbase.INPUT_SHAPES.items():
        if not ok[name]:
            continue
        tc = dryrun.shape_cfg(tbase.get_config(arch), shape)
        jc = jdryrun._shape_cfg(jbase.get_config(arch),
                                jbase.INPUT_SHAPES[name])
        jin, _ = japi.input_specs(jc, jbase.INPUT_SHAPES[name])
        assert _tspecs(api.input_specs(tc, shape)) == _jspecs(jin), name
        if shape.kind == "decode":
            jcache = jax.eval_shape(lambda: japi.init_cache(
                jc, shape.global_batch, shape.seq_len, jnp.bfloat16))
            assert _tspecs(api.cache_specs(tc, shape)) == _jspecs(jcache)


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_param_and_adamw_bytes_match_reference(arch):
    """Full size, nothing allocated on either side: the parameter tree and
    the AdamW state (mu, nu: f32 in both packages) leaf for leaf, and
    their bytes."""
    tc, jc = tbase.get_config(arch), jbase.get_config(arch)
    jparams = jax.eval_shape(lambda: japi.init_params(
        jc, jax.random.PRNGKey(0)))
    tparams = api.param_specs(tc)
    assert _tspecs(tparams) == _jspecs(jparams)
    assert sum(s.nbytes for s in tree_leaves(tparams)) == \
        _nbytes(_jspecs(jparams))
    jstate = jax.eval_shape(joptim.adamw().init, jparams)
    tstate = optim.adamw().init(dryrun._meta(tparams))
    assert _tspecs(tstate) == _jspecs(jstate)
    assert sum(t.numel() * t.element_size() for t in tree_leaves(tstate)) \
        == _nbytes(_jspecs(jstate))


def test_specs_allocate_nothing():
    """Qwen3-MoE-235B's 470 GB of bf16 parameters come back as specs."""
    specs = api.param_specs(tbase.get_config("qwen3_moe_235b_a22b"))
    assert all(isinstance(s, api.TensorSpec) for s in tree_leaves(specs))
    assert sum(s.nbytes for s in tree_leaves(specs)) > 4e11


# ---------------------------------------------------------------------------
# Meta traces of reduced models
# ---------------------------------------------------------------------------

TRACED = ["qwen3_8b", "olmoe_1b_7b", "hubert_xlarge", "zamba2_1p2b"]


def _forward_calls(cfg):
    """The kernel operator calls of one forward: chip_smoke.py's launch
    formulas."""
    L = cfg.num_layers
    if cfg.family == "hybrid_zamba2":
        I = zamba2.num_attn_invocations(cfg)
        return {"rmsnorm": 2 * L + 2 * I + 1, "swa_attention": I}
    return {"rmsnorm": (4 if cfg.qk_norm else 2) * L + 1,
            "swa_attention": L}


def _recomputed_calls(cfg):
    """The kernel operator calls the backward's recomputed forwards add:
    the transformers' layers run under ``torch.utils.checkpoint``
    (``remat``), so each layer's norms and attention run again (they all
    come before the layer's last saved tensor, where the recomputation
    stops); the final norm is outside the layers. Zamba2 recomputes its
    mamba blocks (their ln and gate norm, before ``out_proj``'s product)
    and keeps its shared block's activations, as the reference does."""
    if cfg.family == "hybrid_zamba2":
        return {"rmsnorm": 2 * cfg.num_layers}
    fwd = _forward_calls(cfg)
    return {"rmsnorm": fwd["rmsnorm"] - 1,
            "swa_attention": fwd["swa_attention"]}


@pytest.mark.parametrize("kind", ["train", "prefill"])
@pytest.mark.parametrize("arch", TRACED)
def test_meta_trace_calls_the_kernels_by_the_launch_formulas(arch, kind):
    cfg = get_reduced_config(arch)
    rep = dryrun.trace_combo(cfg, tbase.InputShape("t", 32, 2, kind))
    want = _forward_calls(cfg)
    if kind == "train":
        want.update({f"{k}_bwd": n for k, n in want.items()})
        for k, n in _recomputed_calls(cfg).items():
            want[k] += n
    assert rep["kernels"] == want
    assert rep["memory"]["argument_bytes_per_card"] > 0
    assert rep["memory"]["peak_bytes_per_card"] >= \
        rep["memory"]["argument_bytes_per_card"]
    assert rep["cost"]["kernel_flops_per_card"] > 0


def _hidden(fn):
    """``fn`` as an autograd Function whose forward and backward run with
    every dispatch mode switched off: a counter does not see it."""
    class Hidden(torch.autograd.Function):
        @staticmethod
        def forward(ctx, *args):
            ctx.args = args
            with _disable_current_modes():
                return fn(*args)

        @staticmethod
        def backward(ctx, g):
            with _disable_current_modes(), torch.enable_grad():
                args = [a.detach().requires_grad_(a.requires_grad)
                        if torch.is_tensor(a) else a for a in ctx.args]
                want = [a for a in args
                        if torch.is_tensor(a) and a.requires_grad]
                grads = iter(torch.autograd.grad(fn(*args), want, g,
                                                 allow_unused=True))
                return tuple(next(grads) if torch.is_tensor(a) and
                             a.requires_grad else None for a in args)
    return Hidden.apply


@pytest.mark.parametrize("arch", TRACED)
def test_meta_flops_outside_kernels_equal_cpu_route(arch, monkeypatch):
    """A reduced train step: the meta trace's FLOPs less its kernel
    operators' equal ``FlopCounterMode``'s count of the same step on real
    CPU tensors, the plain versions hidden from the counter, exactly."""
    cfg = get_reduced_config(arch)
    shape = tbase.InputShape("t", 32, 2, "train")
    rep = dryrun.trace_combo(cfg, shape)
    outside = rep["cost"]["flops_per_card"] - \
        rep["cost"]["kernel_flops_per_card"]

    rms, swa = rms_ref.rmsnorm_ref, swa_ref.swa_attention_ref
    monkeypatch.setattr(rms_ref, "rmsnorm_ref", _hidden(rms))
    hidden_swa = _hidden(lambda q, k, v, w, c: swa(q, k, v, window=w,
                                                   causal=c))
    monkeypatch.setattr(swa_ref, "swa_attention_ref",
                        lambda q, k, v, *, window, causal=True:
                        hidden_swa(q, k, v, window, causal))
    params = api.init_params(cfg, torch.Generator().manual_seed(0),
                             device="cpu")
    batch = tree_map(lambda s: torch.zeros(s.shape, dtype=s.dtype),
                     api.input_specs(cfg, shape))
    step = trainer.make_train_step(cfg, optim.adamw(), optim.constant(1e-3))
    state = optim.adamw().init(params)
    with FlopCounterMode(display=False) as fc:
        step(params, state, 0, batch)
    assert fc.get_total_flops() == outside > 0


def test_meta_trace_splits_a_batch_too_large_for_one_launch(monkeypatch):
    """swa_attention launches once a slice of the batch that one launch
    takes; the output has the whole batch's shape."""
    monkeypatch.setattr(swa_ops, "MAX_LAUNCH_ELEMENTS", 2 * 16 * 4 * 8)
    q = torch.empty(5, 16, 4, 8, device="meta")
    k = torch.empty(5, 16, 2, 8, device="meta")
    tr = dryrun.Tracer()
    with tr:
        out = swa_ops.swa_attention(q, k, k, window=16)
    assert out.shape == q.shape and tr.kernels == {"swa_attention": 3}


def test_importing_kernels_registers_ops_without_building():
    code = ("import torch, repro_torch.kernels as k\n"
            "ops = sorted(n for n in k.OPS "
            "if hasattr(torch.ops.repro_torch, n))\n"
            "print(ops == sorted(k._ENTRIES), k._lib is None)")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120,
                         env={**os.environ, "PYTHONPATH": os.path.join(
                             ROOT, "src")})
    assert out.stdout.split() == ["True", "True"], out.stderr


# ---------------------------------------------------------------------------
# The FLOP formulas against the plain versions
# ---------------------------------------------------------------------------

def _counted(fn, *args, **kw):
    with FlopCounterMode(display=False) as fc:
        fn(*args, **kw)
    return fc.get_total_flops()


_POINTWISE = {"mul", "add", "sub", "div", "sqrt", "rsqrt", "reciprocal",
              "neg", "exp", "pow"}
_REDUCE = {"sum", "mean"}


class _Elementwise(TorchDispatchMode):
    """Arithmetic by element: one per output element of a pointwise
    arithmetic op, one per input element of a sum or mean."""

    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        name = func.overloadpacket.__name__.rstrip("_")
        if name in _POINTWISE:
            self.n += out.numel()
        elif name in _REDUCE:
            self.n += args[0].numel()
        return out


def _elementwise(fn, *args):
    with _Elementwise() as m:
        fn(*args)
    return m.n


def test_conv_formulas_equal_the_plain_versions():
    g = torch.Generator().manual_seed(0)
    x = torch.rand((2, 3, 12, 12, 6), generator=g)
    w = torch.rand((2, 5, 5, 6, 4), generator=g)
    dy = torch.rand((2, 3, 8, 8, 4), generator=g)
    f = conv_ops.conv2d_flops(dy.shape, 5, 5, 6)
    assert _counted(conv_ref.conv2d_valid_ref, x, w) == f
    assert _counted(conv_ref.conv2d_weight_grad_ref, x, dy, 5, 5) == f
    assert _counted(conv_ref.conv2d_input_grad_ref, dy, w) == f


@pytest.mark.parametrize("masked", [False, True])
def test_elm_stats_formula_counts_u_upper_triangle(masked):
    """The plain version computes all of U = HᵀmH; the formula counts its
    pairs i <= j (k·n·L·(L−1) fewer) and, with a mask, the k·n·L products
    that weight the rows."""
    k, n, L, C = 2, 10, 6, 3
    h, t = torch.rand(k, n, L), torch.rand(k, n, C)
    m = torch.rand(k, n) if masked else None
    plain = _counted(st_ref.elm_stats_ref, h, t, m)
    assert st_ops.elm_stats_flops(k, n, L, C, masked) == \
        plain - k * n * L * (L - 1) + (k * n * L if masked else 0)


@pytest.mark.parametrize("B,S,H,KV,hd,W,causal", [
    (2, 16, 4, 2, 8, 16, True), (1, 24, 2, 1, 8, 5, True),
    (2, 12, 4, 4, 8, 12, False)])
def test_swa_formulas_count_the_pairs_in_the_mask(B, S, H, KV, hd, W,
                                                  causal):
    """The plain versions score all S² pairs a head; the formulas count
    the pairs the mask keeps: formula · S² = plain · (pairs a head)."""
    g = torch.Generator().manual_seed(0)
    q = torch.randn((B, S, H, hd), generator=g)
    k = torch.randn((B, S, KV, hd), generator=g)
    v = torch.randn((B, S, KV, hd), generator=g)
    pairs = swa_ops.pairs_in_mask(B, S, H, W, causal)
    assert pairs == B * H * sum(min(t + 1, W) if causal else S
                                for t in range(S))
    plain = _counted(swa_ref.swa_attention_ref, q, k, v, window=W,
                     causal=causal)
    assert swa_ops.swa_flops(B, S, H, hd, W, causal) * B * H * S * S == \
        plain * pairs
    out = swa_ref.swa_attention_ref(q, k, v, window=W, causal=causal)
    lse = swa_ref.swa_attention_lse_ref(q, k, window=W, causal=causal)
    plain = _counted(swa_ref.swa_attention_bwd_ref, q, k, v, out, lse,
                     torch.randn_like(q), window=W, causal=causal)
    assert swa_ops.swa_bwd_flops(B, S, H, hd, W, causal) * B * H * S * S \
        == plain * pairs


def test_rmsnorm_formulas_leave_out_the_per_row_terms():
    """By element: the forward's 4 and the backward's 11 operations an
    element; the plain versions also do 3 and 6 per row."""
    g = torch.Generator().manual_seed(0)
    x = torch.randn((6, 5, 16), generator=g)
    scale, dy = torch.rand(16, generator=g), torch.randn_like(x)
    rows = 30
    assert _elementwise(rms_ref.rmsnorm_ref, x, scale) == \
        rms_ops.rmsnorm_flops(x.shape) + 3 * rows
    assert _elementwise(rms_ref.rmsnorm_bwd_ref, x, scale, dy) == \
        rms_ops.rmsnorm_bwd_flops(x.shape) + 6 * rows


def test_kernel_ops_count_their_formulas_under_flop_counter():
    """On meta tensors, each operator counts its own formula."""
    m = torch.device("meta")
    x, s = torch.empty(3, 8, device=m), torch.empty(8, device=m)
    assert _counted(kernels.OPS["rmsnorm"], x, s, 1e-5) == \
        rms_ops.rmsnorm_flops(x.shape)
    q = torch.empty(1, 16, 2, 8, device=m)
    assert _counted(kernels.OPS["swa_attention"], q, q, q, 4, True,
                    False) == swa_ops.swa_flops(1, 16, 2, 8, 4)
    h, t = torch.empty(2, 5, 4, device=m), torch.empty(2, 5, 3, device=m)
    assert _counted(kernels.OPS["elm_stats"], h, t, None) == \
        st_ops.elm_stats_flops(2, 5, 4, 3)


# ---------------------------------------------------------------------------
# The cost table and the collectives
# ---------------------------------------------------------------------------

def test_roofline_terms_dominance_and_rates():
    t = cost_analysis.roofline_terms({"bfloat16": 1e18}, 1e12, 1e9, 256)
    assert t["dominant"] == "compute"
    t = cost_analysis.roofline_terms({"bfloat16": 1e12}, 1e12, 5e12, 256)
    assert t["dominant"] == "collective"
    t = cost_analysis.roofline_terms({"float32": 1e9}, 1e15, 0.0, 1)
    assert t["dominant"] == "memory"
    h100 = cost_analysis.CARDS[cost_analysis.CARD]
    assert (h100.bf16_flops, h100.f32_flops, h100.hbm_bytes_per_s,
            h100.memory_bytes, h100.link_bytes_per_s) == \
        (989e12, 67e12, 3.35e12, 80e9, 450e9)
    t = cost_analysis.roofline_terms({"bfloat16": 989e12,
                                      "float32": 67e12}, 3.35e12, 450e9, 1)
    np.testing.assert_allclose([t["t_compute_s"], t["t_memory_s"],
                                t["t_collective_s"]], [2.0, 1.0, 1.0])
    assert cost_analysis.card_key("NVIDIA H100 80GB HBM3, 700.00 W") == \
        "H100"
    assert cost_analysis.card_key("NVIDIA H100 PCIe") == "H100 PCIe"
    with pytest.raises(KeyError):
        cost_analysis.card_key("NVIDIA A100-SXM4-80GB")


def test_collective_stats_ring_multipliers():
    calls = {("all_reduce", "pod"): 2, ("all_gather", "world"): 1,
             ("ring_exchange", "pod"): 4, ("barrier", "world"): 1}
    nbytes = {("all_reduce", "pod"): 800, ("all_gather", "world"): 64,
              ("ring_exchange", "pod"): 40, ("barrier", "world"): 4}
    st = cost_analysis.collective_stats(calls, nbytes)
    assert st.count_by_kind == {"all-reduce": 3, "all-gather": 1,
                                "collective-permute": 4}
    assert st.raw_bytes_by_kind == {"all-reduce": 804, "all-gather": 64,
                                    "collective-permute": 40}
    assert st.per_card_bytes == 2 * 804 + 64 + 40


def test_average_step_all_reduce_bytes_from_collectives():
    """The multi mesh's Reduce: one all-reduce of the member tree raveled
    to f32, as ``collectives.py`` counted it, over a fake 2-rank group."""
    cfg = get_reduced_config("qwen3_8b")
    collectives.reset()
    tr = dryrun.trace_average(cfg)
    n = sum(int(np.prod(s.shape)) for s in tree_leaves(api.param_specs(cfg)))
    assert tr.coll.count_by_kind == {"all-reduce": 1}
    assert tr.coll.raw_bytes_by_kind == {"all-reduce": 4 * n}
    assert tr.coll.per_card_bytes == 8 * n
    assert collectives.BYTES[("all_reduce", "pod")] == 4 * n
    rep = dryrun.trace_combo(cfg, tbase.InputShape("t", 16, 2, "train"),
                             "multi")
    assert rep["cards"] == dryrun.MEMBERS
    assert rep["average_step"]["collectives"]["raw_bytes_by_kind"] == \
        {"all-reduce": 4 * n}
    assert rep["collectives"]["count_by_kind"] == {}


# ---------------------------------------------------------------------------
# The launcher
# ---------------------------------------------------------------------------

_RUN = ("import runpy, sys\n"
        "sys.argv = ['dryrun'] + sys.argv[1:]\n"
        "try:\n"
        "    runpy.run_module('repro_torch.launch.dryrun',"
        " run_name='__main__')\n"
        "    rc = 0\n"
        "except SystemExit as e:\n"
        "    rc = e.code\n"
        "print('JAX_IMPORTED', 'jax' in sys.modules or 'repro' in "
        "sys.modules)\n"
        "sys.exit(rc)\n")


def _launch(tmp_path, *argv):
    out = subprocess.run(
        [sys.executable, "-c", _RUN, *argv, "--out", str(tmp_path)],
        capture_output=True, text=True, timeout=120, cwd=ROOT,
        env={**os.environ, "PYTHONPATH": os.path.join(ROOT, "src")})
    assert out.returncode == 0, out.stdout + out.stderr
    assert "JAX_IMPORTED False" in out.stdout
    return out.stdout


def test_launcher_rwkv6_long_500k_both_meshes(tmp_path):
    out = _launch(tmp_path, "--arch", "rwkv6_3b", "--shape", "long_500k",
                  "--mesh", "both")
    assert "done: ok=2 skip=0 fail=0" in out
    for mesh in ("single", "multi"):
        rep = json.load(open(tmp_path / f"rwkv6_3b__long_500k__{mesh}.json"))
        assert rep["n_probes"] == 0 and rep["kernels"] == {}
        assert rep["cost"]["accounting"] == "every layer traced"
        assert rep["memory"]["fits"] and rep["roofline"]["dominant"] == \
            "memory"


def test_launcher_full_size_train_combo(tmp_path):
    out = _launch(tmp_path, "--arch", "qwen3_8b", "--shape", "train_4k",
                  "--mesh", "single")
    assert "done: ok=1 skip=0 fail=0" in out
    rep = json.load(open(tmp_path / "qwen3_8b__train_4k__single.json"))
    cfg = tbase.get_config("qwen3_8b")
    L = cfg.num_layers
    # q of a batch of 256 x 4,096 tokens exceeds one launch's 2^31
    # elements: the kernels run on 127 sequences a launch, 3 a layer;
    # each layer's forward runs twice (remat: again in the backward)
    per = -(-256 // ((2**31 - 1) // (4096 * cfg.num_heads * cfg.head_dim)))
    assert per == 3
    assert rep["kernels"] == {"rmsnorm": 2 * 4 * L + 1,
                              "rmsnorm_bwd": 4 * L + 1,
                              "swa_attention": 2 * per * L,
                              "swa_attention_bwd": per * L}
    specs = tree_leaves(api.param_specs(cfg))
    n = sum(int(np.prod(s.shape)) for s in specs)
    # the params, AdamW's f32 mu and nu, int32 tokens and targets
    assert rep["memory"]["argument_bytes_per_card"] == \
        sum(s.nbytes for s in specs) + 8 * n + 2 * 256 * 4096 * 4
    assert not rep["memory"]["fits"]
    assert rep["card"] == cost_analysis.CARDS["H100"].name
    # the model's 6 N T FLOPs against what the step computes: each
    # layer's forward twice (remat), 8 FLOPs a layer parameter a token,
    # and the unembedding's 6 (the embedding's lookup is no product)
    N, VD = cfg.active_param_count(), cfg.padded_vocab * cfg.d_model
    T = 256 * 4096
    steps_flops = 8 * (N - 2 * VD) * T + 6 * VD * T
    assert 0.9 < rep["useful_flops_ratio"] / (6 * N * T / steps_flops) \
        <= 1.0


def test_launcher_writes_the_encoder_only_skip_note(tmp_path):
    out = _launch(tmp_path, "--arch", "hubert_xlarge", "--shape",
                  "decode_32k", "--mesh", "single")
    assert "done: ok=0 skip=1 fail=0" in out
    rep = json.load(open(tmp_path /
                         "hubert_xlarge__decode_32k__single.json"))
    assert rep["skipped"] and rep["reason"] == "encoder-only: no decode step"
