"""Sharded training of the LM zoo's transformer families on gloo CPU ranks
(``launch.mesh.run_ranks``), held against the reference's unsharded
``jax.value_and_grad(loss_fn)``, ``make_train_step`` and
``make_average_step``.

On data 2 × model 2, model 4 and pod 2 × model 2 (the member dim over
``pod``, the reference's ``MULTIPOD_RULES``), every rank takes its blocks
of the reference's f32 init tree, its AdamW state and the batches
(``convert.lm_shard_from_numpy``, ``ctx.place``), computes the loss and
its gradient blocks as the train step takes them
(``trainer.loss_and_grads``), takes two AdamW steps and, on the member
mesh, the Reduce over ``pod``. Bars:

* the loss within 1e-5 relative;
* each gradient block within 1e-4 · max|g| of the reference's leaf;
* the params after two steps within the port's AdamW bar
  (``tests/test_torch_train.py::test_make_train_step_matches_reference``:
  rtol 1e-4 + 1e-6 · max|leaf| + 1 % of lr a step, and 2 · lr a step
  where a step's gradient lies within the gradient bar of 0, counted
  under 1 % of the model);
* on the member mesh, the Reduce's blocks equal to the reference's
  ``make_average_step`` of the ranks' stacked params within rtol 1e-6.

Sharding moves only the f32 sum order; a bar missed by a factor near an
axis's size is a fault of ``distributed/ctx.py``'s gradient convention.
The collectives of each direction are held to counts written down from
the code (``_expected``), and ``q_norm``'s gradient at model 4 (a
replicated leaf applied to one q head a rank) to the reference's. The
reduced configs: qwen3_8b (qk_norm; at model 4 its 2 KV heads replicate
and its KV columns are gathered), olmoe_1b_7b (experts over ``model``,
the aux loss over the global batch) and minicpm_2b (its vocab of 513
replicated, tied embeddings). The reference runs in this process; the
ranks import no JAX (``tests/torch_lm_train_mesh_ranks.py``).
"""
import functools
import os
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import optim as joptim
from repro.configs.base import get_reduced_config as jget
from repro.core import trainer as jtrainer
from repro.models import api as japi
from repro_torch.configs import get_reduced_config
from repro_torch.distributed import sharding
from repro_torch.launch.mesh import run_ranks
from repro_torch.models import api

import torch_lm_train_mesh_ranks as ranks

with mock.patch.dict(os.environ):
    from repro.launch import dryrun as jdryrun

torch.set_num_threads(2)

ARCHS = ["qwen3_8b", "olmoe_1b_7b", "minicpm_2b"]
ARCH_OF = {jget(a).name: a for a in ARCHS}
B, S, MEMBERS = 4, 16, 2
MESHES = {"data2_model2": ({"data": 2, "model": 2}, None),
          "model4": ({"data": 1, "model": 4}, None),
          "pod2_model2": ({"pod": 2, "data": 1, "model": 2},
                          jdryrun.MULTIPOD_RULES)}


def _np(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float32), tree)


def _batches(cfg, rng):
    return [{"tokens": rng.integers(0, cfg.vocab_size, (B, S))
             .astype(np.int32),
             "targets": rng.integers(0, cfg.vocab_size, (B, S))
             .astype(np.int32)} for _ in range(2)]


def _leaves(jcfg, tree):
    """The leaves of a reference tree in the port's order (its logical
    tree's, the order of its ``tree_leaves``)."""
    out = []
    sharding.map_logical(lambda log, a: out.append(a), api.logical_axes(
        get_reduced_config(ARCH_OF[jcfg.name])), tree)
    return out


def _jb(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


@functools.lru_cache(maxsize=None)
def _jitted(arch):
    """The reference's value_and_grad of its loss and its train step,
    jitted once an arch."""
    jcfg = jget(arch)

    def loss(p, b):
        return japi.loss_fn(jcfg, p, b)[0]

    step = jtrainer.make_train_step(jcfg, joptim.adamw(),
                                    joptim.constant(ranks.LR))
    return jax.jit(jax.value_and_grad(loss)), jax.jit(step)


def _member_reference(arch, jp, batches):
    """One member's reference: loss and gradient at batch 0, the gradient
    of each step (for the AdamW bar's near-zero elements), the params
    after the two steps."""
    jcfg = jget(arch)
    value_and_grad, step = _jitted(arch)
    p, o, s = jp, joptim.adamw().init(jp), jnp.zeros((), jnp.int32)
    step_grads = []
    for b in batches:
        value, g = value_and_grad(p, _jb(b))
        if not step_grads:
            first = (float(value), g)
        step_grads.append(_leaves(jcfg, _np(g)))
        p, o, s, _ = step(p, o, s, _jb(b))
    # the twin: the same two steps from the init one f32 ulp up
    t, o = jax.tree.map(lambda a: jnp.nextafter(a, jnp.inf), jp), \
        joptim.adamw().init(jp)
    s = jnp.zeros((), jnp.int32)
    for b in batches:
        t, o, s, _ = step(t, o, s, _jb(b))
    return {"loss": first[0], "grads": step_grads[0],
            "step_grads": step_grads, "params": _leaves(jcfg, _np(p)),
            "twin": _leaves(jcfg, _np(t))}


@functools.lru_cache(maxsize=None)
def _reference(arch, members):
    """(the case for the ranks, the reference's figures)."""
    jcfg = jget(arch)
    opt = joptim.adamw()
    rng = np.random.default_rng(ARCHS.index(arch))
    if not members:
        jp = japi.init_params(jcfg, jax.random.PRNGKey(3), jnp.float32)
        batches = _batches(jcfg, rng)
        case = {"arch": arch, "params": _np(jp), "opt": _np(opt.init(jp)),
                "batches": batches}
        return case, [_member_reference(arch, jp, batches)]
    inits = [japi.init_params(jcfg, jax.random.PRNGKey(3 + m), jnp.float32)
             for m in range(members)]
    per = [_batches(jcfg, rng) for _ in range(members)]
    refs = [_member_reference(arch, jp, b) for jp, b in zip(inits, per)]
    stack = lambda *xs: np.stack(xs)  # noqa: E731
    case = {"arch": arch, "members": members,
            "params": jax.tree.map(stack, *[_np(jp) for jp in inits]),
            "opt": jax.tree.map(stack, *[_np(opt.init(jp))
                                         for jp in inits]),
            "batches": [{k: np.stack([b[t][k] for b in per]) for k in
                         ("tokens", "targets")} for t in range(2)]}
    return case, refs


def _cut(ref, block, at):
    return ref[tuple(slice(o, o + n) for o, n in zip(at, block.shape))]


def _grads_hold(got, ref, what):
    for i, ((block, at), whole) in enumerate(zip(got, ref)):
        top = float(np.abs(whole).max())
        err = float(np.abs(block - _cut(whole, block, at)).max())
        assert err <= 1e-4 * top, f"{what} leaf {i}: {err} > 1e-4*{top}"


def _params_hold(got, ref, step_grads, what, missed, total):
    """The AdamW bar of tests/test_torch_train.py, block by block; an
    element the reference's own one-ulp twin moves further than that bar
    is held within twice the twin's distance instead (the twin rule of
    ``chip_smoke.py`` phase ``train``), and counted with the near-zero
    ones."""
    steps, lr = len(step_grads), ranks.LR
    for i, ((block, at), whole) in enumerate(zip(got, ref["params"])):
        want = _cut(whole, block, at)
        twin = np.abs(_cut(ref["twin"][i], block, at) - want)
        top = float(np.abs(whole).max())
        near = np.zeros(block.shape, bool)
        for g_all in step_grads:
            gn = float(np.sqrt(sum(np.sum(np.square(g)) for g in g_all)))
            g = _cut(g_all[i], block, at)
            near |= (g != 0) & (
                (np.abs(g) * min(1.0, 1.0 / (gn + 1e-9)) < 100 * 1e-8)
                | (np.abs(g) < 1e-4 * np.abs(g_all[i]).max()))
        diff = np.abs(block - want)
        bar = 1e-4 * np.abs(want) + 1e-6 * top + 1e-2 * lr * steps
        ok = diff <= np.maximum(bar, 2 * twin)
        if near.any():
            assert float(diff[near].max()) <= 2 * lr * steps, (what, i)
        missed[0] += int((near | (twin > bar)).sum())
        total[0] += near.size
        assert bool((ok | near).all()), (what, i, float(diff[~(ok | near)]
                                                        .max()))


def _expected(arch, mesh):
    """The collectives of the gradient and of the two steps, by direction
    and kind/axis, from the code. A layer's forward sends over model the
    all-reduces of its partial products (wo's, then w_down's or the MoE's
    partial combine) and the all-gathers of KV columns cut mid-head and
    of the router's logits; the backward recomputes each layer up to its
    last saved tensor (``torch.utils.checkpoint`` stops there), which is
    before a dense block's last all-reduce and after the MoE's, whose aux
    loss comes last. Once a step: the embedding's partial rows and the
    vocab-sharded cross-entropy's max, exp sum and gold logit over model,
    the mean over data; the MoE's aux sums over data in every layer. The
    backward sends one all-reduce over model each time a replicated tensor
    enters a model-sharded computation: the attention's input (q, k and v
    share one), q_norm where the q heads are sharded, k_norm where the KV
    heads are, the replicated K and V heads read by sharded q heads, the
    MLP's input (the MoE: the router's, the dispatch's and the combine's
    weights), and the unembedding's input. The gradient blocks then sum
    over data, one all-reduce a leaf, and each step's global norm adds the
    model-sharded leaves' squares in one all-reduce."""
    cfg = get_reduced_config(arch)
    M, D = mesh["model"], mesh["data"]
    L = cfg.num_layers
    vocab = cfg.padded_vocab % M == 0
    q_sh = cfg.num_heads % M == 0
    kv_sh = cfg.num_kv_heads % M == 0
    kv_gathered = (cfg.num_kv_heads * cfg.head_dim) % M == 0 and not kv_sh
    moe = cfg.family == "moe"
    fwd = {"all_reduce/model": L * (2 + (2 if moe else 1)) + 4 * vocab,
           "all_gather/model": 2 * L * (2 * kv_gathered + moe)}
    bwd = {"all_reduce/model": L * (1 + (cfg.qk_norm and q_sh)
                                    + (cfg.qk_norm and kv_sh)
                                    + 2 * (q_sh and not kv_sh)
                                    + (3 if moe else 1)) + vocab}
    if D > 1:
        leaves = 14 - 2 * (not cfg.qk_norm) - cfg.tie_embeddings + moe
        fwd["all_reduce/data"] = 1 + 2 * L * moe + leaves
    grad = {"forward": {k: v for k, v in fwd.items() if v},
            "backward": bwd}
    step = {"forward": {k: 2 * v + 2 * (k == "all_reduce/model")
                        for k, v in grad["forward"].items()},
            "backward": {k: 2 * v for k, v in bwd.items()}}
    return grad, step


@functools.lru_cache(maxsize=None)
def _run(mesh_name):
    """Every case on the ranks of one mesh, with the reference's."""
    mesh, rules = MESHES[mesh_name]
    members = MEMBERS if "pod" in mesh else 0
    cases, refs = zip(*[_reference(a, members) for a in ARCHS])
    world = int(np.prod(list(mesh.values())))
    results = run_ranks(ranks.train_cases, world, device="cpu",
                        args=(mesh, list(cases), rules), timeout_s=240)
    return mesh, members, refs, results


def _each(mesh_name):
    """(arch, what, the reference's members, a rank's case) of a mesh."""
    mesh, members, refs, results = _run(mesh_name)
    for c, arch in enumerate(ARCHS):
        for r in results:
            yield arch, f"{arch} on {mesh} at {r['coord']}", refs[c], \
                r["cases"][c]


@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_sharded_loss_and_gradients_match_the_reference(mesh_name):
    for arch, what, refs, got in _each(mesh_name):
        if "members" in _reference(arch, MEMBERS if "pod" in mesh_name
                                   else 0)[0]:
            for (m, loss), (m2, grads) in zip(got["loss"], got["grads"]):
                np.testing.assert_allclose(loss, refs[m]["loss"],
                                           rtol=1e-5, err_msg=what)
                _grads_hold(grads, refs[m2]["grads"], f"{what} member {m}")
        else:
            np.testing.assert_allclose(got["loss"], refs[0]["loss"],
                                       rtol=1e-5, err_msg=what)
            _grads_hold(got["grads"], refs[0]["grads"], what)


@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_two_sharded_adamw_steps_match_the_reference(mesh_name):
    missed, total = [0], [0]
    for arch, what, refs, got in _each(mesh_name):
        k = len(refs) if len(refs) > 1 else 0
        if k:
            for m, ref in enumerate(refs):
                blocks = [(b[m - at[0]], at[1:]) for b, at in got["params"]
                          if at[0] <= m < at[0] + b.shape[0]]
                if blocks:
                    _params_hold(blocks, ref, ref["step_grads"],
                                 f"{what} member {m}", missed, total)
        else:
            _params_hold(got["params"], refs[0], refs[0]["step_grads"],
                         what, missed, total)
        assert np.all(np.isfinite(got["step_losses"])), what
    assert missed[0] < 1e-2 * total[0], (missed, total)


def test_the_reduce_over_pod_is_the_reference_average():
    """The ranks' Reduce over ``pod`` equals the reference's
    ``make_average_step`` of the stacked params the ranks stepped to."""
    mesh, _, refs, results = _run("pod2_model2")
    for c, arch in enumerate(ARCHS):
        shapes = [p.shape for p in refs[c][0]["params"]]
        stacked = [np.full((MEMBERS,) + s, np.nan, np.float32)
                   for s in shapes]
        for r in results:
            for i, (block, at) in enumerate(r["cases"][c]["params"]):
                stacked[i][tuple(slice(o, o + n) for o, n in
                                 zip(at, block.shape))] = block
        assert not any(np.isnan(a).any() for a in stacked), arch
        tree = dict(enumerate(stacked))
        want = jax.tree.leaves(_np(jtrainer.make_average_step()(tree)))
        for r in results:
            for i, (block, at) in enumerate(r["cases"][c]["average"]):
                np.testing.assert_allclose(block, _cut(want[i], block, at),
                                           rtol=1e-6, err_msg=arch)


@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_collectives_by_direction_are_the_code_s(mesh_name):
    mesh = MESHES[mesh_name][0]
    for arch, what, _, got in _each(mesh_name):
        grad, step = _expected(arch, mesh)
        assert got["grad_calls"] == grad, what
        assert got["step_calls"] == step, what
        if "pod" in mesh:
            # the Reduce: one all-reduce of the rank's blocks over pod
            assert got["average_calls"] == {
                "forward": {"all_reduce/pod": 1}, "backward": {}}, what
            # the member step sends nothing over pod
            assert not any("pod" in k for d in got["step_calls"].values()
                           for k in d), what


def test_q_norm_gradient_at_model_4():
    """At model 4 each rank holds one q head of qwen3_8b's four, so its
    gradient of the replicated q_norm is a quarter of the sum: the
    all-reduce of ``ctx.into_sharded`` makes it the whole on every rank
    (held in ``_grads_hold`` with every leaf; here by name, and against
    the rank's quarter share too)."""
    cfg = get_reduced_config("qwen3_8b")
    paths = []
    sharding.map_logical(lambda log: paths.append(log), {
        k: v if k != "layers" else {
            kk: (vv if kk != "attn" else {n: (n,) + l for n, l in
                                          vv.items()})
            for kk, vv in v.items()}
        for k, v in api.logical_axes(cfg).items()})
    i = next(j for j, log in enumerate(paths) if log[0] == "q_norm")
    _, _, refs, results = _run("model4")
    ref = refs[0][0]["grads"][i]
    top = float(np.abs(ref).max())
    for r in results:
        got, at = r["cases"][0]["grads"][i]
        assert at == (0, 0) and got.shape == ref.shape
        assert float(np.abs(got - ref).max()) <= 1e-4 * top
        assert float(np.abs(got - ref).max()) < 0.1 * float(
            np.abs(ref).max()), "a rank's partial share"
