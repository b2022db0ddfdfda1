"""Sharded serving and training of the LM zoo's recurrent families (RWKV6,
the Zamba2 hybrid) on gloo CPU ranks (``launch.mesh.run_ranks``), held
against the reference's unsharded runs, and their dry run on the
reference's pod meshes.

Every rank takes its blocks of the reference's f32 init tree and of the
batches (``convert.lm_shard_from_numpy``, ``ctx.place``) and runs the
port under ``use_mesh_rules`` (``tests/torch_recurrent_mesh_ranks.py``):

* serving on model 2, model 4 and data 2 × model 2: prefill and 8 greedy
  decode steps, the ranks' logits put back together within 1e-4 ·
  max|logit| of the reference's with equal greedy tokens
  (``tests/test_torch_lm_mesh.py``'s bar); RWKV6, where that bar is
  missed, within twice the reference's distance from its one-ulp twin
  (``tests/test_torch_recurrent.py``'s rule: the group norm's bf16 cast
  turns an ulp into ~1e-2). The cases: RWKV6 in both WKV modes (its two
  heads sharded on model 2, replicated on model 4, where its projection
  columns are gathered), RWKV6 padded to 4 heads (``rwkv_head_pad_to``,
  sharded on model 4 too) and Zamba2 (its ``in_proj`` of 548 columns cut
  into blocks of 274 or 137 that cross z, x and B; the shared block's
  attention and the decode cache split by sequence);
* training on data 2 × model 2, model 4 and pod 2 × model 2 (the member
  dim over ``pod``, ``MULTIPOD_RULES``): the loss, the gradient blocks and
  two AdamW steps with ``tests/test_torch_lm_train_mesh.py``'s bars (the
  gradients, for RWKV6, with the twin rule too), the Reduce over ``pod``,
  the collectives of each direction against counts written down from the
  code, and by name the gradients of Zamba2's ``in_proj`` B/C columns and
  of RWKV6's ``ln_x`` at model 4, which each rank's share would miss by
  the axis's size without ``ctx.into_sharded``.

The reference runs unrolled (``unroll_layers=True``, R5) in this process;
the ranks import no JAX.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import optim as joptim
from repro.configs.base import get_reduced_config as jget
from repro.configs.base import replace as jreplace
from repro.core import trainer as jtrainer
from repro.models import api as japi
from repro_torch import convert
from repro_torch.configs import InputShape, get_config, get_reduced_config
from repro_torch.configs import replace
from repro_torch.distributed import collectives, ctx, sharding
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import LMMesh, run_ranks
from repro_torch.models import api, rwkv6
from repro_torch.tree import tree_leaves

import torch_lm_mesh_ranks as serve_ranks
import torch_recurrent_mesh_ranks as ranks

torch.set_num_threads(2)

KEY = jax.random.PRNGKey(3)
PROMPT, STEPS = 12, 8
B_TRAIN, S_TRAIN, MEMBERS = 4, 16, 2
SERVE = [("rwkv6_3b", {"rwkv_mode": "scan"}),
         ("rwkv6_3b", {"rwkv_mode": "chunked"}),
         ("rwkv6_3b", {"rwkv_head_pad_to": 4}),
         ("zamba2_1p2b", {})]
TRAIN = [("rwkv6_3b", {}), ("rwkv6_3b", {"rwkv_head_pad_to": 4}),
         ("zamba2_1p2b", {})]
SERVE_MESHES = {"model2": {"data": 1, "model": 2},
                "model4": {"data": 1, "model": 4},
                "data2_model2": {"data": 2, "model": 2}}
TRAIN_MESHES = {"data2_model2": {"data": 2, "model": 2},
                "model4": {"data": 1, "model": 4},
                "pod2_model2": {"pod": 2, "data": 1, "model": 2}}


def _np(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float32), tree)


def _jcfg(arch, rep):
    return jreplace(jget(arch), unroll_layers=True, **rep)


def _cfg(arch, rep):
    return replace(get_reduced_config(arch), **rep)


# ---------------------------------------------------------------------------
# the reference
# ---------------------------------------------------------------------------

def _jit(fn, exact=True):
    """``jax.jit`` with XLA's excess precision off (``exact``), so the
    compiled step computes the reference's own function, its eager one;
    with it on, XLA keeps RWKV6's bf16 group-norm output in f32 inside a
    fusion (the twin of the module's docstring)."""
    return jax.jit(fn, compiler_options={"xla_allow_excess_precision":
                                         not exact})


@functools.lru_cache(maxsize=None)
def _serve_fns(arch, rep, exact=True):
    """The reference's prefill and decode step."""
    jcfg = _jcfg(arch, dict(rep))
    return (_jit(lambda p, b: japi.prefill(jcfg, p, b), exact),
            _jit(lambda p, c, t, pos: japi.decode_step(jcfg, p, c, t,
                                                       pos), exact))


def _greedy(arch, rep, jp, b, feed=None, exact=True):
    """The reference's logits of the prefill and STEPS decode steps, fed
    its own greedy tokens (or ``feed``), and the tokens fed."""
    prefill, step = _serve_fns(arch, tuple(sorted(rep.items())), exact)
    logits, cache = prefill(jp, {"tokens": jnp.asarray(b)})
    out, fed = [np.asarray(logits)], []
    for t in range(STEPS):
        tok = (feed[t] if feed is not None else
               np.asarray(jnp.argmax(logits[:, -1:], -1)).astype(np.int32))
        fed.append(tok)
        logits, cache = step(jp, cache, jnp.asarray(tok), PROMPT + t)
        out.append(np.asarray(logits))
    return out, fed


@functools.lru_cache(maxsize=None)
def _serve_reference(i):
    """(the case for the ranks, the reference's logits step by step, its
    twin's on the same tokens: RWKV6 only)."""
    arch, rep = SERVE[i]
    jp = japi.init_params(_jcfg(arch, rep), KEY, jnp.float32)
    b = np.random.default_rng(i).integers(
        0, jget(arch).vocab_size, (2, PROMPT)).astype(np.int32)
    refs, feed = _greedy(arch, rep, jp, b)
    twin = (_greedy(arch, rep, jp, b, feed, exact=False)[0]
            if arch == "rwkv6_3b" else None)
    case = {"arch": arch, "replace": rep, "batch": {"tokens": b},
            "feed": feed, "pos0": PROMPT, "params": _np(jp)}
    return case, refs, twin


def _leaves(arch, rep, tree):
    """A reference tree's leaves in the port's order."""
    out = []
    sharding.map_logical(lambda log, a: out.append(a),
                         api.logical_axes(_cfg(arch, rep)), tree)
    return out


@functools.lru_cache(maxsize=None)
def _train_fns(arch, rep, exact=True):
    """The reference's value_and_grad of its loss and its train step."""
    jcfg = _jcfg(arch, dict(rep))

    def loss(p, b):
        return japi.loss_fn(jcfg, p, b)[0]

    step = jtrainer.make_train_step(jcfg, joptim.adamw(),
                                    joptim.constant(ranks.LR))
    return _jit(jax.value_and_grad(loss), exact), _jit(step, exact)


def _member_reference(arch, rep, jp, batches):
    """One member's reference: loss and gradient at batch 0 and its
    twin's (the excess-precision form: the module's docstring), each
    step's gradient, the params after two AdamW steps and the share of
    the model its one-ulp twin (every f32 leaf one ulp up) moves beyond
    ``_params_hold``'s bar in those two steps."""
    key = tuple(sorted(rep.items()))
    value_and_grad, step = _train_fns(arch, key)
    jb = [{k: jnp.asarray(v) for k, v in b.items()} for b in batches]

    def two_steps(p):
        o, s = joptim.adamw().init(jp), jnp.zeros((), jnp.int32)
        for b in jb:
            p, o, s, _ = step(p, o, s, b)
        return _leaves(arch, rep, _np(p))

    value, g = value_and_grad(jp, jb[0])
    params = two_steps(jp)
    ref = {"loss": float(value), "grads": _leaves(arch, rep, _np(g)),
           "step_grads": [_leaves(arch, rep, _np(g))], "params": params}
    o, s = joptim.adamw().init(jp), jnp.zeros((), jnp.int32)
    p1, _, _, _ = step(jp, o, s, jb[0])
    ref["step_grads"].append(_leaves(arch, rep, _np(
        value_and_grad(p1, jb[1])[1])))
    missed, total = [0], [0]
    _params_hold([(a, (0,) * a.ndim) for a in two_steps(
        jax.tree.map(lambda a: jnp.nextafter(a, jnp.inf), jp))], ref,
        "the one-ulp twin", missed, total)
    ref["twin_missed"] = missed[0] / total[0]
    twin_value_and_grad, _ = _train_fns(arch, key, exact=False)
    ref["twin_grads"] = _leaves(arch, rep, _np(
        twin_value_and_grad(jp, jb[0])[1]))
    return ref


def _batches(vocab, rng):
    return [{"tokens": rng.integers(0, vocab, (B_TRAIN, S_TRAIN))
             .astype(np.int32),
             "targets": rng.integers(0, vocab, (B_TRAIN, S_TRAIN))
             .astype(np.int32)} for _ in range(2)]


@functools.lru_cache(maxsize=None)
def _train_reference(i, members):
    arch, rep = TRAIN[i]
    jcfg, opt = _jcfg(arch, rep), joptim.adamw()
    rng = np.random.default_rng(100 + i)
    inits = [japi.init_params(jcfg, jax.random.PRNGKey(3 + m), jnp.float32)
             for m in range(max(members, 1))]
    per = [_batches(jcfg.vocab_size, rng) for _ in inits]
    refs = [_member_reference(arch, rep, jp, b) for jp, b in zip(inits,
                                                                 per)]
    case = {"arch": arch, "replace": rep}
    if not members:
        case.update(params=_np(inits[0]), opt=_np(opt.init(inits[0])),
                    batches=per[0])
        return case, refs
    stack = lambda *xs: np.stack(xs)  # noqa: E731
    case.update(members=members,
                params=jax.tree.map(stack, *[_np(jp) for jp in inits]),
                opt=jax.tree.map(stack, *[_np(opt.init(jp))
                                          for jp in inits]),
                batches=[{k: np.stack([b[t][k] for b in per])
                          for k in ("tokens", "targets")}
                         for t in range(2)])
    return case, refs


@functools.lru_cache(maxsize=None)
def _run(mesh_name):
    """The ranks' results on one mesh: its serving cases (on a serving
    mesh) and its training cases (on a training mesh)."""
    mesh = SERVE_MESHES.get(mesh_name) or TRAIN_MESHES[mesh_name]
    members = MEMBERS if "pod" in mesh else 0
    serve = ([_serve_reference(i)[0] for i in range(len(SERVE))]
             if mesh_name in SERVE_MESHES else [])
    train = ([_train_reference(i, members)[0] for i in range(len(TRAIN))]
             if mesh_name in TRAIN_MESHES else [])
    rules = dryrun.MULTIPOD_RULES if members else None
    return run_ranks(ranks.mesh_cases, int(np.prod(list(mesh.values()))),
                     device="cpu", args=(mesh, serve, train, rules),
                     timeout_s=300)


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mesh_name", list(SERVE_MESHES))
def test_sharded_serving_matches_the_unsharded_reference(mesh_name):
    results = _run(mesh_name)
    served = [{"cases": r["serve"]} for r in results]
    for i, (arch, rep) in enumerate(SERVE):
        _, refs, twin = _serve_reference(i)
        what = f"{arch} {rep} on {mesh_name}"
        for s, ref in enumerate(refs):
            got = serve_ranks.assemble(served, i, s)
            assert got.shape == ref.shape, what
            err, top = float(np.abs(got - ref).max()), float(
                np.abs(ref).max())
            if err > 1e-4 * top:
                assert twin is not None, f"{what} step {s}: {err}"
                own = float(np.abs(ref - twin[s]).max())
                assert err <= 2 * own, f"{what} step {s}: {err} > 2*{own}"
            np.testing.assert_array_equal(got.argmax(-1), ref.argmax(-1),
                                          err_msg=f"{what} step {s}")
        for r in results:
            calls = r["serve"][i]["calls"]
            # serving sends nothing over data
            assert calls and all(label == "model" for _, label in calls), \
                (what, calls)


@pytest.mark.parametrize("mesh_name", list(SERVE_MESHES))
def test_sharded_caches_are_the_blocks_of_the_reference_s(mesh_name):
    """The prefill's cache blocks: RWKV6's S over its heads where they
    divide (replicated where they do not), Zamba2's h and conv over the
    SSM heads and its KV slots (W = the prompt's 12, R7) by sequence."""
    mesh = SERVE_MESHES[mesh_name]
    D, M = mesh["data"], mesh["model"]
    for i, (arch, rep) in enumerate(SERVE):
        cfg = _cfg(arch, rep)
        shapes = _run(mesh_name)[0]["serve"][i]["cache_shapes"]
        Bl, L = 2 // D, cfg.num_layers
        if arch == "rwkv6_3b":
            H = rwkv6._heads_padded(cfg)
            Hl = H // M if H % M == 0 else H
            assert shapes == {"S": (L, Bl, Hl, 64, 64),
                              "x_tm": (L, Bl, cfg.d_model),
                              "x_cm": (L, Bl, cfg.d_model)}, (rep, shapes)
        else:
            H, P = cfg.ssm_heads, cfg.ssm_head_dim
            assert shapes == {
                "h": (L, Bl, H // M, P, cfg.ssm_state),
                "conv": (L, Bl, 3, H * P // M),
                "k": (1, Bl, PROMPT // M, cfg.num_kv_heads, cfg.head_dim),
                "v": (1, Bl, PROMPT // M, cfg.num_kv_heads, cfg.head_dim)}, \
                shapes


def test_the_wkv_runs_over_heads_or_whole():
    """RWKV6's reduced config has two heads: over model 2 a rank runs one,
    over model 4 every rank runs both (their projection columns, 32 a
    rank, gathered); padded to 4 heads it runs one a rank there too."""
    x = torch.zeros(2, 4, 128)
    for M, rep, want in ((2, {}, "model"), (4, {}, None),
                         (4, {"rwkv_head_pad_to": 4}, "model")):
        cfg = _cfg("rwkv6_3b", rep)
        with ctx.use_mesh_rules(_FakeMesh(data=1, model=M)):
            ctx.declare(batch=2)
            assert rwkv6._wkv_entry(cfg, x) == want, (M, rep)
            assert rwkv6._spec(cfg, "w_r") == (None, "model")


class _FakeMesh:
    def __init__(self, **axes):
        self.shape = axes


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------

def _cut(ref, block, at):
    return ref[tuple(slice(o, o + n) for o, n in zip(at, block.shape))]


def _grads_hold(got, ref, what):
    """Each gradient block within 1e-4 · max|g| of the reference's leaf,
    or within twice the reference's distance from its twin's (the
    module's docstring)."""
    for i, ((block, at), whole) in enumerate(zip(got, ref["grads"])):
        top = float(np.abs(whole).max())
        want = _cut(whole, block, at)
        err = float(np.abs(block - want).max())
        if err <= 1e-4 * top:
            continue
        own = float(np.abs(_cut(ref["twin_grads"][i], block, at)
                           - want).max())
        assert err <= 2 * own, f"{what} leaf {i}: {err} > 1e-4*{top}, " \
                               f"2*{own}"


def _params_hold(got, ref, what, missed, total):
    """The params after two AdamW steps, block by block: each element
    within ``tests/test_torch_lm_train_mesh.py``'s bar of the reference
    (rtol 1e-4 + 1e-6 · max|leaf| + 1 % of lr a step), or, counted in
    ``missed``, within 2 · lr a step (an update's whole swing). A
    near-zero first-step gradient whose sign differs moves its element
    by 2 · lr, which moves the second step's gradients elsewhere; in
    RWKV6 and Zamba2 the elements so moved are more than that bar's
    allowance for near-zero gradients covers, sharded or not (the
    unsharded port misses it too), so they are counted instead: the
    caller holds them under 1 % of the model."""
    steps, lr = len(ref["step_grads"]), ranks.LR
    for i, ((block, at), whole) in enumerate(zip(got, ref["params"])):
        want = _cut(whole, block, at)
        diff = np.abs(block - want)
        bar = 1e-4 * np.abs(want) + 1e-6 * float(np.abs(whole).max()) \
            + 1e-2 * lr * steps
        assert float(diff.max()) <= 2 * lr * steps, (what, i,
                                                     float(diff.max()))
        missed[0] += int((diff > bar).sum())
        total[0] += diff.size


def _each(mesh_name):
    """(case index, what, the reference's members, a rank's case)."""
    members = MEMBERS if "pod" in TRAIN_MESHES[mesh_name] else 0
    for c, (arch, rep) in enumerate(TRAIN):
        refs = _train_reference(c, members)[1]
        for r in _run(mesh_name):
            yield c, f"{arch} {rep} on {mesh_name} at {r['coord']}", refs, \
                r["train"][c]


@pytest.mark.parametrize("mesh_name", list(TRAIN_MESHES))
def test_sharded_loss_and_gradients_match_the_reference(mesh_name):
    for c, what, refs, got in _each(mesh_name):
        if len(refs) > 1 or "members" in _train_reference(
                c, MEMBERS if "pod" in mesh_name else 0)[0]:
            for (m, loss), (_, grads) in zip(got["loss"], got["grads"]):
                np.testing.assert_allclose(loss, refs[m]["loss"], rtol=1e-5,
                                           err_msg=what)
                _grads_hold(grads, refs[m], f"{what} member {m}")
        else:
            np.testing.assert_allclose(got["loss"], refs[0]["loss"],
                                       rtol=1e-5, err_msg=what)
            _grads_hold(got["grads"], refs[0], what)


@pytest.mark.parametrize("mesh_name", list(TRAIN_MESHES))
def test_two_sharded_adamw_steps_match_the_reference(mesh_name):
    """``_params_hold`` on every block; the elements beyond its bar under
    1 % of the case's model, or twice the share the reference's own
    one-ulp twin moves beyond it (RWKV6's: 3.6 % and 4.8 % here)."""
    for c, what, refs, got in _each(mesh_name):
        missed, total = [0], [0]
        if len(refs) > 1:
            for m, ref in enumerate(refs):
                blocks = [(b[m - at[0]], at[1:]) for b, at in got["params"]
                          if at[0] <= m < at[0] + b.shape[0]]
                if blocks:
                    _params_hold(blocks, ref, f"{what} member {m}", missed,
                                 total)
        else:
            _params_hold(got["params"], refs[0], what, missed, total)
        assert np.all(np.isfinite(got["step_losses"])), what
        share = max(1e-2, 2 * max(r["twin_missed"] for r in refs))
        assert missed[0] <= share * total[0], (what, missed, total, share)


def test_the_reduce_over_pod_is_the_reference_average():
    """The ranks' Reduce over ``pod`` equals the reference's
    ``make_average_step`` of the stacked params the ranks stepped to."""
    results = _run("pod2_model2")
    for c, (arch, rep) in enumerate(TRAIN):
        refs = _train_reference(c, MEMBERS)[1]
        stacked = [np.full((MEMBERS,) + p.shape, np.nan, np.float32)
                   for p in refs[0]["params"]]
        for r in results:
            for i, (block, at) in enumerate(r["train"][c]["params"]):
                stacked[i][tuple(slice(o, o + n) for o, n in
                                 zip(at, block.shape))] = block
        assert not any(np.isnan(a).any() for a in stacked), arch
        want = jax.tree.leaves(_np(jtrainer.make_average_step()(
            dict(enumerate(stacked)))))
        for r in results:
            for i, (block, at) in enumerate(r["train"][c]["average"]):
                np.testing.assert_allclose(block, _cut(want[i], block, at),
                                           rtol=1e-6, err_msg=arch)
            assert r["train"][c]["average_calls"] == {
                "forward": {"all_reduce/pod": 1}, "backward": {}}, arch


def _expected(arch, rep, mesh):
    """The collectives of the gradient and of the two steps, by direction
    and kind/axis, from the code (the reduced configs: 2 layers, the vocab
    of 512 sharded over model). A recomputed forward sends as a forward.

    Once a step, over model: forward the embedding's partial rows and the
    cross-entropy's max, exp sum and gold logit (all-reduce); backward the
    unembedding's input (all-reduce). An RWKV6 layer, forward: ``w_o``'s
    and ``w_cv``'s partial products (all-reduce), ``w_cr``'s gate gathered
    back (all-gather) and, where its heads do not divide the axis, the
    four projections' columns (all-gather); the backward recomputes the
    whole layer (the gate's gather is its last op before the residual
    sum); backward, the four lerps entering the projections and ``ln_x``
    where the heads are sharded (all-reduce), ``lw``'s slice there, or
    ``w_o``'s input slice where they are not (all-gather), and ``w_ck``'s
    and ``w_cr``'s inputs (all-reduce). A Zamba2 mamba layer, forward:
    ``in_proj``'s columns (all-gather), the gate norm's sums and
    ``out_proj``'s partial product (all-reduce); recomputed up to
    ``out_proj``'s product, its last saved tensor (an all-gather and an
    all-reduce); backward, the gathered weight, x and the gate norm's sum
    entering the sharded heads (all-reduce). Its shared block, not
    recomputed, as the transformers': ``wo``'s and ``w_down``'s partial
    products; at model 4 its 2 heads' q, k and v columns gathered, and in
    the backward ``wo``'s input slice; its attention's and SwiGLU's
    inputs. The gradient blocks then sum over data, one all-reduce a
    leaf, after the mean's; each step's global norm adds the
    model-sharded leaves' squares in one all-reduce."""
    cfg = _cfg(arch, rep)
    M, D, L = mesh["model"], mesh["data"], cfg.num_layers
    fwd = {"all_reduce/model": 4, "all_gather/model": 0}
    bwd = {"all_reduce/model": 1, "all_gather/model": 0}
    if arch == "rwkv6_3b":
        sharded = rwkv6._heads_padded(cfg) % M == 0
        fwd["all_reduce/model"] += 2 * 2 * L
        fwd["all_gather/model"] += 2 * (1 + 4 * (not sharded)) * L
        bwd["all_reduce/model"] += (2 + 5 * sharded) * L
        bwd["all_gather/model"] += L
        leaves = 3 + 19
    else:
        whole = cfg.num_heads % M != 0
        fwd["all_reduce/model"] += (2 + 1) * L + 2
        fwd["all_gather/model"] += (1 + 1) * L + 3 * whole
        bwd["all_reduce/model"] += 3 * L + 2
        bwd["all_gather/model"] += whole
        leaves = 3 + 8 + 9
    if D > 1:
        fwd["all_reduce/data"] = 1 + leaves
    grad = {"forward": {k: v for k, v in fwd.items() if v},
            "backward": {k: v for k, v in bwd.items() if v}}
    step = {"forward": {k: 2 * v + 2 * (k == "all_reduce/model")
                        for k, v in grad["forward"].items()},
            "backward": {k: 2 * v for k, v in grad["backward"].items()}}
    return grad, step


@pytest.mark.parametrize("mesh_name", list(TRAIN_MESHES))
def test_collectives_by_direction_are_the_code_s(mesh_name):
    mesh = TRAIN_MESHES[mesh_name]
    for c, what, _, got in _each(mesh_name):
        grad, step = _expected(*TRAIN[c], mesh)
        assert got["grad_calls"] == grad, what
        assert got["step_calls"] == step, what
        # the member step sends nothing over pod
        assert not any("pod" in k for d in got["step_calls"].values()
                       for k in d), what


def _leaf_index(arch, rep, path):
    """The index in tree order of the layer leaf named by ``path``."""
    names = []
    cfg = _cfg(arch, rep)

    def walk(tree, prefix):
        for k, v in tree.items():
            if isinstance(v, dict):
                walk(v, prefix + (k,))
            else:
                names.append(prefix + (k,))

    walk(api.logical_axes(cfg), ())
    return names.index(path)


@pytest.mark.parametrize("case,path", [
    (1, ("layers", "ln_x")), (2, ("mamba", "mix", "in_proj"))])
def test_replicated_and_gathered_leaves_gradients_at_model_4(case, path):
    """At model 4 a rank's share of the gradient of RWKV6's ``ln_x`` (a
    replicated leaf of which each rank scales one head of the padded
    four) and of Zamba2's ``in_proj`` B/C columns (gathered whole on
    every rank and used by its one SSM head) is a partial sum:
    ``ctx.into_sharded`` makes it the whole on every rank. Held by
    ``_grads_hold``'s bar on those columns."""
    arch, rep = TRAIN[case]
    i = _leaf_index(arch, rep, path)
    ref = _train_reference(case, 0)[1][0]
    cfg = _cfg(arch, rep)
    din, N = cfg.ssm_heads * cfg.ssm_head_dim, cfg.ssm_state
    top = float(np.abs(ref["grads"][i]).max())
    seen = 0
    for r in _run("model4"):
        got, at = r["train"][case]["grads"][i]
        cols = np.arange(at[-1], at[-1] + got.shape[-1])
        keep = (cols >= 0 if arch == "rwkv6_3b"
                else (cols >= 2 * din) & (cols < 2 * din + 2 * N))
        want = _cut(ref["grads"][i], got, at)[..., keep]
        twin = _cut(ref["twin_grads"][i], got, at)[..., keep]
        if not keep.any():
            continue
        seen += int(keep.sum())
        err = float(np.abs(got[..., keep] - want).max())
        assert err <= max(1e-4 * top, 2 * float(np.abs(twin - want).max())), \
            (path, at, err, top)
    assert seen >= (cfg.d_model if arch == "rwkv6_3b" else 2 * N)


# ---------------------------------------------------------------------------
# no context, the trees, the dry run
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["rwkv6_3b", "zamba2_1p2b"])
def test_a_world_one_context_is_the_plain_run_bitwise(arch):
    """Under a context whose axes are all of size 1 every move is a no-op:
    the loss, the gradients, the prefill and a decode step are the plain
    ones bit for bit, and nothing is sent."""
    from repro_torch.core import trainer
    cfg = get_reduced_config(arch)
    params = api.init_params(cfg, torch.Generator().manual_seed(0),
                             torch.float32, device="cpu")
    gen = torch.Generator().manual_seed(1)
    batch = {k: torch.randint(0, cfg.vocab_size, (2, 12), generator=gen)
             for k in ("tokens", "targets")}

    def loss_fn(p, b):
        return api.loss_fn(cfg, p, b)

    def serve():
        logits, cache = api.prefill(cfg, params, {"tokens":
                                                  batch["tokens"]})
        step, _ = api.decode_step(cfg, params, cache,
                                  logits[:, -1:].argmax(-1), 12)
        return logits, step

    plain = trainer.loss_and_grads(cfg, loss_fn, params, batch), serve()
    collectives.reset()
    with ctx.use_mesh_rules(LMMesh({"data": 1, "model": 1}, rank=0)):
        ctx.declare(batch=2)
        ranked = trainer.loss_and_grads(cfg, loss_fn, params, batch), serve()
    assert not collectives.CALLS
    assert torch.equal(plain[0][0], ranked[0][0])
    assert all(torch.equal(a, b) for a, b in zip(plain[0][2], ranked[0][2]))
    assert all(torch.equal(a, b) for a, b in zip(plain[1], ranked[1]))


@pytest.mark.parametrize("arch,rep", [("rwkv6_3b", {}),
                                      ("rwkv6_3b", {"rwkv_head_pad_to": 4}),
                                      ("zamba2_1p2b", {})])
def test_lm_shard_from_numpy_cuts_the_recurrent_trees(arch, rep):
    """``convert.lm_shard_from_numpy`` takes RWKV6's (the head-padded
    tree included, as ``pad_head_params`` makes it from the unpadded one)
    and Zamba2's reference trees: every coordinate's blocks of model 4 ×
    data 2, put back together, are the whole tree bit for bit."""
    jcfg = jget(arch)
    jp = _np(japi.init_params(jcfg, KEY, jnp.float32))
    cfg = _cfg(arch, rep)
    if rep:
        from repro.models import rwkv6 as jrwkv
        jp = _np(jrwkv.pad_head_params(jax.tree.map(jnp.asarray, jp), jcfg,
                                       jreplace(jcfg, **rep)))
        tp = rwkv6.pad_head_params(convert.lm_tree_from_numpy(
            _np(japi.init_params(jcfg, KEY, jnp.float32)), "cpu"),
            get_reduced_config(arch), cfg)
        assert all(np.array_equal(a, b) for a, b in
                   zip(_leaves(arch, rep, convert.to_numpy(tp)),
                       _leaves(arch, rep, jp)))
    mesh = {"data": 2, "model": 4}
    logical = api.logical_axes(cfg)
    whole = [np.full(a.shape, np.nan, np.float32)
             for a in _leaves(arch, rep, jp)]
    specs = []
    sharding.map_logical(lambda log, a: specs.append(
        sharding.resolve_spec(a.shape, log, _FakeMesh(**mesh))), logical, jp)
    for d in range(2):
        for m in range(4):
            coord = {"data": d, "model": m}
            blocks = tree_leaves(convert.lm_shard_from_numpy(
                jp, logical, _FakeMesh(**mesh), coord, device="cpu"))
            for w, b, spec in zip(whole, blocks, specs):
                at = [coord[e] * n if e else 0
                      for e, n in zip(spec, b.shape)]
                w[tuple(slice(o, o + n) for o, n in zip(at, b.shape))] = \
                    b.numpy()
    assert all(np.array_equal(w, a) for w, a in
               zip(whole, _leaves(arch, rep, jp)))
    assert any(s != (None,) * len(s) for s in specs)


@pytest.mark.parametrize("mesh_name", ["pod", "multipod"])
def test_dryrun_traces_both_families_on_the_pod_meshes(mesh_name, tmp_path,
                                                       capsys):
    """``python -m repro_torch.launch.dryrun --mesh pod|multipod`` traces
    RWKV6-3B's and Zamba2-1.2B's decode_32k with no skip note, and their
    train_4k step traces at full width (cut to 2 layers of RWKV6-3B and
    one stage and a layer of Zamba2-1.2B to keep the test short): the
    train step on pod, the member step and the Reduce over pod on
    multipod, with the backward's collectives over model only and the
    hand kernels of Zamba2's path on its trace."""
    for arch in ("rwkv6_3b", "zamba2_1p2b"):
        rc = dryrun.main(["--arch", arch, "--shape", "decode_32k",
                          "--mesh", mesh_name, "--out", str(tmp_path)])
        out = capsys.readouterr().out
        assert rc == 0 and "skip=0 fail=0" in out, out
        assert "[skip]" not in out
    shape = dryrun.INPUT_SHAPES["train_4k"]
    for arch, layers in (("rwkv6_3b", 2), ("zamba2_1p2b", 7)):
        cfg = replace(get_config(arch), num_layers=layers)
        rep = dryrun.trace_mesh_combo(cfg, shape, mesh_name)
        assert rep["cards"] == (512 if mesh_name == "multipod" else 256)
        by_axis = rep["collectives"]["count_by_axis"]
        assert by_axis["model"] and by_axis["data"] and "pod" not in by_axis
        assert set(rep["collectives_backward"]["count_by_axis"]) == \
            {"model"}
        if arch == "zamba2_1p2b":
            assert rep["kernels"]["swa_attention_bwd"] == 1
            assert rep["kernels"]["rmsnorm_bwd"] > 0
        if mesh_name == "multipod":
            assert rep["average_step"]["collectives"]["count_by_axis"] == \
                {"pod": 1}
