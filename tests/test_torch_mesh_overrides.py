"""The reference's sharding-rule overrides on the port's (data, model)
mesh — weights sharded over ``data`` and gathered at use (FSDP), the layer
dim over ``data``, tensor parallelism off — on gloo CPU ranks
(``launch.mesh.run_ranks``), held against the reference's unsharded runs.

One group of four ranks runs every case (``tests/
torch_mesh_overrides_ranks.py``), on data 2 × model 2:

* ``{"ff": ("data",)}`` (the hillclimb's C1 and A1) on qwen3_8b and
  olmoe_1b_7b, and with ``moe_combine_sharding="batch"`` on olmoe_1b_7b
  (A2);
* ``{"heads": (), "layers": ("data",)}`` (B2) on qwen3_8b and rwkv6_3b;
* ``{"ff": ("data",), "layers": ("data",)}`` on qwen3_8b, whose layers
  are fetched with their ff whole (the stack took ``data``);
* ``{"expert": ("data",), "vocab": ("data",)}`` on olmoe_1b_7b,
  ``{"ssm_heads", "ff"}`` over ``("data",)`` on zamba2_1p2b (its
  shared block gathered where applied) and ``{"embed", "heads",
  "kv_heads"}`` over ``("data",)`` on qwen3_8b;
* ``{"embed": ("data",)}`` on internvl2_26b and hubert_xlarge, served
  only (their frontends' projections are gathered in the prefill);

each served (prefill and 8 greedy decode steps: the logits within 1e-4 ·
max|logit| with equal tokens, RWKV6 by its twin rule,
``tests/test_torch_recurrent_mesh.py``; an encoder's one forward) and
trained (the loss within
1e-5, the gradient blocks within 1e-4 · max|g|, two AdamW steps within
the AdamW bar: ``tests/test_torch_lm_train_mesh.py``'s bars, RWKV6's and
Zamba2's with their twin rule); then on pod 2 × data 2 the member step
of qwen3_8b under ``MULTIPOD_RULES`` and ``{"ff": ("data",)}``, and the
Reduce over ``pod``. The collectives over ``data`` are held to counts written down
from the code: each gathered leaf's all-gather in the forward and again
in the recomputation, its reduce-scatter in the backward; each fetched
layer leaf's broadcast twice and its reduce once. Beside them, with no
ranks: the refusals of the overrides the port does not run, the specs a
model reads, ``convert.lm_shard_from_numpy`` under the overrides, the
dry run's argument bytes under an override and the hillclimb registry.
"""
import ast
import functools
import importlib.util
import os
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as jbase
from repro.models import api as japi
from repro_torch import convert
from repro_torch.configs import INPUT_SHAPES, get_config, get_reduced_config
from repro_torch.configs import replace
from repro_torch.distributed import ctx, sharding
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import run_ranks
from repro_torch.models import api, zamba2

import test_torch_lm_mesh as lm_mesh
import test_torch_lm_sharding as lm_sharding
import test_torch_lm_train_mesh as train_mesh
import test_torch_recurrent_mesh as recurrent_mesh
import torch_lm_mesh_ranks as serve_ranks
import torch_mesh_overrides_ranks as ranks

torch.set_num_threads(2)

ROOT = os.path.join(os.path.dirname(__file__), "..")
FF = {"ff": ("data",)}
B2 = {"heads": (), "layers": ("data",)}
# (arch, rules, configuration fields)
CASES = [("qwen3_8b", FF, {}),
         ("olmoe_1b_7b", FF, {}),
         ("olmoe_1b_7b", FF, {"moe_combine_sharding": "batch"}),
         ("qwen3_8b", B2, {}),
         ("rwkv6_3b", B2, {}),
         ("qwen3_8b", {**FF, "layers": ("data",)}, {}),
         ("olmoe_1b_7b", {"expert": ("data",), "vocab": ("data",)}, {}),
         ("zamba2_1p2b", {"ssm_heads": ("data",), "ff": ("data",)}, {}),
         ("qwen3_8b", {"embed": ("data",), "heads": ("data",),
                       "kv_heads": ("data",)}, {})]
IDS = ["qwen3_ff", "olmoe_ff", "olmoe_ff_combine_batch", "qwen3_b2",
       "rwkv6_b2", "qwen3_ff_layers", "olmoe_expert_vocab",
       "zamba2_ssm_heads_ff", "qwen3_embed_heads"]
# served only: the frontends' projections, gathered in the prefill
SERVE_CASES = CASES + [("internvl2_26b", {"embed": ("data",)}, {}),
                       ("hubert_xlarge", {"embed": ("data",)}, {})]
SERVE_IDS = IDS + ["internvl2_embed", "hubert_embed"]
FRONTENDS = ("projector", "frontend_proj")
MESH = {"data": 2, "model": 2}
MEMBER_RULES = {**sharding.MULTIPOD_RULES, **FF}


class FakeMesh:
    def __init__(self, **axes):
        self.shape = axes


def _cfg(i):
    arch, _, rep = SERVE_CASES[i]
    return replace(get_reduced_config(arch), **rep)


def _serve_reference(i):
    """(the case, the reference's logits step by step, RWKV6's twin's)."""
    arch, _, rep = SERVE_CASES[i]
    if arch == "rwkv6_3b":
        return recurrent_mesh._serve_reference(1)    # chunked, the default
    if arch == "zamba2_1p2b":
        return recurrent_mesh._serve_reference(3)
    case, refs = lm_mesh._reference(
        [c[0] for c in lm_mesh.CASES].index(arch))
    return {**case, "replace": rep}, refs, None


def _train_reference(i):
    """(the case, the reference's figures); the unsharded reference is
    one for every rule and combine layout."""
    arch, _, rep = CASES[i]
    if arch in ("rwkv6_3b", "zamba2_1p2b"):
        case, refs = recurrent_mesh._train_reference(
            [a for a, _ in recurrent_mesh.TRAIN].index(arch), 0)
        return case, refs[0]
    case, refs = train_mesh._reference(arch, 0)
    return {**case, "replace": rep}, refs[0]


@functools.lru_cache(maxsize=None)
def _run():
    """Every case on the four ranks. The reference's jitted runs come
    first, an arch a thread (XLA compiles and runs with the GIL
    released)."""
    def one_arch(arch):
        for i, case in enumerate(SERVE_CASES):
            if case[0] == arch:
                _serve_reference(i)
                if i < len(CASES):
                    _train_reference(i)
        if arch == "qwen3_8b":
            train_mesh._reference(arch, train_mesh.MEMBERS)

    with ThreadPoolExecutor(4) as pool:
        list(pool.map(one_arch, dict.fromkeys(c[0] for c in SERVE_CASES)))
    serve = [(_serve_reference(i)[0], rules)
             for i, (_, rules, _) in enumerate(SERVE_CASES)]
    train = [(_train_reference(i)[0], CASES[i][1]) for i in range(len(CASES))]
    member = (train_mesh._reference("qwen3_8b", train_mesh.MEMBERS)[0],
              MEMBER_RULES)
    return run_ranks(ranks.override_cases, 4, device="cpu",
                     args=(serve, train, member), timeout_s=300)


# ---------------------------------------------------------------------------
# the collectives' moves
# ---------------------------------------------------------------------------

def test_reduce_scatter_weight_gather_and_broadcast_forward_and_backward():
    """On the data axis's group of two: the reduce-scatter keeps this
    rank's rows of the sum and all-gathers its gradient; a weight's
    gather concatenates the blocks and reduce-scatters its gradient (each
    rank's share summed: 1 + 2); the broadcast gives the source's tensor
    everywhere and reduces the gradients (2 + 3) onto the source only."""
    for r in _run():
        d, got = r["coord"]["data"], r["primitives"]
        whole = (2 * np.arange(8.0) + 10).reshape(4, 2)
        y, g = got["reduce_scatter"]
        np.testing.assert_array_equal(y, whole[2 * d:2 * d + 2])
        np.testing.assert_array_equal(g, [[1, 1], [1, 1], [2, 2], [2, 2]])
        w, g = got["gather_weight"]
        np.testing.assert_array_equal(w, [[0, 1, 10, 11], [2, 3, 12, 13]])
        np.testing.assert_array_equal(g, np.full((2, 2), 3.0))
        b, g = got["broadcast"]
        np.testing.assert_array_equal(b, [2.0] * 3)
        np.testing.assert_array_equal(g, [5.0 * d] * 3)
        assert got["calls"] == {"reduce_scatter/data": 2,
                                "all_gather/data": 2, "broadcast/data": 1,
                                "reduce/data": 1}
        assert got["backward"] == {"all_gather/data": 1,
                                   "reduce_scatter/data": 1,
                                   "reduce/data": 1}


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------

def _leaf_layouts(i):
    """[(path, logical, spec of its blocks on data 2 × model 2)] of every
    leaf of case ``i``'s params under its rules."""
    cfg, rules = _cfg(i), SERVE_CASES[i][1]
    shapes = api.param_specs(cfg)
    out = []

    def walk(log, shp, path):
        if isinstance(log, dict):
            for k in log:
                walk(log[k], shp[k], path + (k,))
            return
        out.append((path, log, sharding.resolve_spec(
            shp.shape, log, FakeMesh(**MESH), rules)))

    walk(api.logical_axes(cfg), shapes, ())
    return out


def _data_moves(i, layer_passes: int, end_passes: int):
    """(all-gathers, broadcasts) over ``data``: each gathered leaf's
    gather and each fetched layer leaf's broadcast, a layer's leaves
    ``layer_passes`` times a layer, the ends' ``end_passes`` times (a
    frontend's projection once at most: the prefill's; Zamba2's shared
    block's once an application; an audio encoder's untied embedding
    table never: it reads frames)."""
    cfg = _cfg(i)
    L = cfg.num_layers
    gathers = broadcasts = 0
    for path, log, spec in _leaf_layouts(i):
        if path == ("embed",) and cfg.frontend == "audio" and \
                not cfg.tie_embeddings:
            continue
        stacked = log[0] == "layers"
        n = L * layer_passes if stacked else \
            min(end_passes, 1) if path[0] in FRONTENDS else end_passes
        if path[0] == "shared":
            n *= sum(shared for _, shared in zamba2._stages(cfg))
        if stacked and spec[0] == "data":
            broadcasts += n
        if any(e == "data" for e in spec[stacked:]):
            gathers += n
    return gathers, broadcasts


@pytest.mark.parametrize("i", range(len(SERVE_CASES)), ids=SERVE_IDS)
def test_serving_under_an_override_matches_the_unsharded_reference(i):
    """The ranks' prefill and 8 greedy decode steps (an encoder's one
    forward), put back together,
    within 1e-4 · max|logit| of the reference's with equal tokens (RWKV6
    within twice its twin's distance where it misses that bar); over
    ``data`` only the gathers (or fetches) of the weights, once a step."""
    _, refs, twin = _serve_reference(i)
    results = _run()
    served = [{"cases": r["serve"]} for r in results]
    what = SERVE_IDS[i]
    for s, ref in enumerate(refs):
        got = serve_ranks.assemble(served, i, s)
        assert got.shape == ref.shape, what
        err, top = float(np.abs(got - ref).max()), float(np.abs(ref).max())
        if err > 1e-4 * top:
            assert twin is not None, f"{what} step {s}: {err} > 1e-4*{top}"
            own = float(np.abs(ref - twin[s]).max())
            assert err <= 2 * own, f"{what} step {s}: {err} > 2*{own}"
        np.testing.assert_array_equal(got.argmax(-1), ref.argmax(-1),
                                      err_msg=f"{what} step {s}")
    steps = len(refs)
    gathers, broadcasts = _data_moves(i, steps, steps)
    want = {k: n for k, n in (("all_gather", gathers),
                              ("broadcast", broadcasts)) if n}
    for r in results:
        calls = r["serve"][i]["calls"]
        assert {k: n for (k, label), n in calls.items()
                if label == "data"} == want, (what, calls)


def test_caches_stay_sharded_by_batch_with_the_layers_over_data():
    """Where the weights' layer dim is over ``data`` the caches keep
    every layer and their batch rows over ``data``."""
    for i in (3, 4, 5):
        assert CASES[i][1]["layers"] == ("data",)
        cfg = _cfg(i)
        shapes = _run()[0]["serve"][i]["cache_shapes"]
        L = cfg.num_layers
        if CASES[i][0] == "rwkv6_3b":
            assert shapes["S"][:2] == (L, 1) and shapes["x_tm"] == \
                (L, 1, cfg.d_model), shapes
        else:
            assert shapes["k"][:2] == (L, 1), shapes


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------

def _recurrent(i):
    return CASES[i][0] in ("rwkv6_3b", "zamba2_1p2b")


def _grads_hold(i, got, ref, what):
    if _recurrent(i):
        recurrent_mesh._grads_hold(got, ref, what)
    else:
        train_mesh._grads_hold(got, ref["grads"], what)


@pytest.mark.parametrize("i", range(len(CASES)), ids=IDS)
def test_loss_and_gradients_under_an_override_match_the_reference(i):
    """The loss within 1e-5 and every gradient block within 1e-4 · max|g|
    (RWKV6 and Zamba2 by their twin rule). ``olmoe_ff`` is the repaired
    fault: with ``ff`` over ``data`` the MoE's expert products ran on
    each data rank's own tokens with its ff block and their partial sums
    were all-reduced over ``data``, adding other ranks' tokens into every
    token's output; now the expert weights are gathered."""
    _, ref = _train_reference(i)
    for r in _run():
        got, what = r["train"][i], f"{IDS[i]} at {r['coord']}"
        np.testing.assert_allclose(got["loss"], ref["loss"], rtol=1e-5,
                                   err_msg=what)
        _grads_hold(i, got["grads"], ref, what)


@pytest.mark.parametrize("i", range(len(CASES)), ids=IDS)
def test_two_adamw_steps_under_an_override_match_the_reference(i):
    _, ref = _train_reference(i)
    missed, total = [0], [0]
    for r in _run():
        got, what = r["train"][i], f"{IDS[i]} at {r['coord']}"
        if _recurrent(i):
            recurrent_mesh._params_hold(got["params"], ref, what, missed,
                                        total)
        else:
            train_mesh._params_hold(got["params"], ref, ref["step_grads"],
                                    what, missed, total)
        assert np.all(np.isfinite(got["step_losses"])), what
    share = max(1e-2, 2 * ref.get("twin_missed", 0))
    assert missed[0] <= share * total[0], (missed, total, share)


def _expected_data(i):
    """The collectives over ``data`` (and ``data+model``) of the
    gradient and of the two steps, by direction, from the code. Forward:
    each gathered leaf's all-gather and each fetched leaf's broadcast,
    sent again where the backward recomputes the layer; the mean's
    all-reduce, the MoE's aux sums in every layer (recomputed too), and
    one all-reduce of each gradient block whose leaf is not sharded over
    ``data``. Backward: each gathered leaf's reduce-scatter and each
    fetched leaf's reduce, once. A step adds its global norm: one
    all-reduce of the squares of the leaves of each sharded entry."""
    cfg, L = _cfg(i), _cfg(i).num_layers
    gathers, broadcasts = _data_moves(i, 2, 1)
    back = _data_moves(i, 1, 1)
    reduced = sum(not any("data" in sharding.entry_axes(e) for e in spec)
                  for _, _, spec in _leaf_layouts(i))
    fwd = {"all_gather/data": gathers, "broadcast/data": broadcasts,
           "all_reduce/data": 1 + 2 * L * (cfg.family == "moe") + reduced}
    bwd = {"reduce_scatter/data": back[0], "reduce/data": back[1]}
    grad = {"forward": {k: n for k, n in fwd.items() if n},
            "backward": {k: n for k, n in bwd.items() if n}}
    entries = set()
    for _, _, spec in _leaf_layouts(i):
        axes = {a for e in spec for a in sharding.entry_axes(e)}
        entries.add("+".join(a for a in MESH if a in axes))
    norm = {f"all_reduce/{e}": 2 for e in entries if "data" in e}
    step = {"forward": {k: 2 * n for k, n in grad["forward"].items()},
            "backward": {k: 2 * n for k, n in grad["backward"].items()}}
    for k, n in norm.items():
        step["forward"][k] = step["forward"].get(k, 0) + n
    return grad, step


def _over_data(calls):
    return {d: {k: n for k, n in c.items() if "data" in k.split("/")[1]}
            for d, c in calls.items()}


@pytest.mark.parametrize("i", range(len(CASES)), ids=IDS)
def test_collectives_over_data_are_the_code_s(i):
    grad, step = _expected_data(i)
    for r in _run():
        got, what = r["train"][i], f"{IDS[i]} at {r['coord']}"
        assert _over_data(got["grad_calls"]) == grad, what
        assert _over_data(got["step_calls"]) == step, what
        # a gathered or fetched layer goes twice forward, once back: the
        # forward's excess over the backward is the recomputation's
        fwd, bwd = got["grad_calls"]["forward"], got["grad_calls"]["backward"]
        assert (fwd.get("all_gather/data", 0)
                - bwd.get("reduce_scatter/data", 0),
                fwd.get("broadcast/data", 0)
                - bwd.get("reduce/data", 0)) == _data_moves(i, 1, 0), what
    assert any(grad["backward"].values())


# ---------------------------------------------------------------------------
# the member step
# ---------------------------------------------------------------------------

def test_member_step_with_ff_over_data_matches_the_reference():
    """Two qwen3_8b members over ``pod`` on pod 2 × data 2, each's ff
    over ``data`` gathered at use: each member's loss and gradient blocks
    and its params after two member steps are the reference's; the member
    step sends nothing over ``pod``, and the Reduce is one all-reduce
    over it, the reference's average of the stacked params."""
    _, refs = train_mesh._reference("qwen3_8b", train_mesh.MEMBERS)
    missed, total = [0], [0]
    results = _run()
    for r in results:
        got, what = r["member"], f"member step at {r['member_coord']}"
        for (m, loss), (_, grads) in zip(got["loss"], got["grads"]):
            np.testing.assert_allclose(loss, refs[m]["loss"], rtol=1e-5,
                                       err_msg=what)
            train_mesh._grads_hold(grads, refs[m]["grads"],
                                   f"{what} member {m}")
        for m, ref in enumerate(refs):
            blocks = [(b[m - at[0]], at[1:]) for b, at in got["params"]
                      if at[0] <= m < at[0] + b.shape[0]]
            if blocks:
                train_mesh._params_hold(blocks, ref, ref["step_grads"],
                                        f"{what} member {m}", missed, total)
        assert not any("pod" in k for d in got["step_calls"].values()
                       for k in d), what
        assert got["step_calls"]["backward"]["reduce_scatter/data"] > 0
        assert got["average_calls"] == {"forward": {"all_reduce/pod": 1},
                                        "backward": {}}, what
    assert missed[0] < 1e-2 * total[0], (missed, total)
    stacked = [np.full((train_mesh.MEMBERS,) + p.shape, np.nan, np.float32)
               for p in refs[0]["params"]]
    for r in results:
        for k, (block, at) in enumerate(r["member"]["params"]):
            stacked[k][tuple(slice(o, o + n) for o, n in
                             zip(at, block.shape))] = block
    assert not any(np.isnan(a).any() for a in stacked)
    from repro.core import trainer as jtrainer
    want = jax.tree.leaves(train_mesh._np(jtrainer.make_average_step()(
        dict(enumerate(stacked)))))
    for r in results:
        for k, (block, at) in enumerate(r["member"]["average"]):
            np.testing.assert_allclose(block, train_mesh._cut(want[k], block,
                                                              at), rtol=1e-6)


# ---------------------------------------------------------------------------
# the rules, the specs, the trees
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("rules,entry", [
    ({"seq": ("model",)}, "seq"),
    ({"embed": ("model",)}, "embed"),
    ({"kv_seq": ("data",)}, "kv_seq"),
    ({"batch": ("model",)}, "batch"),
    ({"ff": (("data", "model"),)}, "ff"),
    ({"heads": ("pod",)}, "heads"),
    ({"ff": ("data", "model"), "layers": ("data",)}, "ff"),
    ({"fff": ("data",)}, "fff")])
def test_an_override_the_port_does_not_run_is_refused(rules, entry):
    with pytest.raises(ValueError, match=f"rule {entry!r}"):
        with ctx.use_mesh_rules(FakeMesh(data=2, model=2), rules):
            pass


@pytest.mark.parametrize("rules", [
    FF, B2, {"heads": ()}, {"expert": ("data",), "vocab": ("data",)},
    {"embed": ("data",)}, {"ff": ("model", "data")},
    {**sharding.MULTIPOD_RULES, "ff": (("pod", "data"),)},
    {**sharding.MULTIPOD_RULES, "layers": ("data",)},
    {"ff": ("model", "data"), "layers": ("data",)}])
def test_the_overrides_the_port_runs_are_accepted(rules):
    pods = FakeMesh(pod=2, data=2, model=2)
    with ctx.use_mesh_rules(pods, {k: list(v) for k, v in rules.items()}) \
            as frame:
        assert frame.rules == sharding.normalize_rules(rules)


def test_a_model_reads_a_gathered_weight_s_spec():
    """``layout`` gives a leaf's blocks as they are held, ``spec`` as the
    model sees the leaf once gathered: no entry on the batch's axis; an
    activation's is the same either way."""
    with ctx.use_mesh_rules(FakeMesh(data=2, model=2),
                            {**FF, "layers": ("data",)}) as frame:
        ctx.declare(batch=4)
        assert frame.gathers and ctx.gathers()
        assert ctx.layout((256, 512), ("embed", "ff")) == (None, "data")
        assert ctx.spec((256, 512), ("embed", "ff")) == (None, None)
        assert ctx.layout((2, 256, 512), ("layers", "embed", "heads")) == \
            ("data", None, "model")
        assert ctx.spec((2, 256, 512), ("layers", "embed", "heads")) == \
            (None, None, "model")
        act = ((4, 16, 512), ("batch", None, "ff"))
        assert ctx.spec(*act) == ctx.layout(*act) == ("data", None, None)
    with ctx.use_mesh_rules(FakeMesh(data=2, model=2)) as frame:
        assert not frame.gathers
        assert ctx.spec((256, 512), ("embed", "ff")) == (None, "model")


TREES = [("qwen3_8b", {}), ("olmoe_1b_7b", {}), ("hubert_xlarge", {}),
         ("internvl2_26b", {}), ("minicpm_2b", {}), ("rwkv6_3b", {}),
         ("rwkv6_3b", {"rwkv_head_pad_to": 4}), ("zamba2_1p2b", {})]


@functools.lru_cache(maxsize=None)
def _tree(arch, rep):
    """The reference's f32 init tree (RWKV6's head-padded as
    ``pad_head_params`` makes it) and its leaves in the port's order."""
    jcfg = jbase.get_reduced_config(arch)
    jp = japi.init_params(jcfg, jax.random.PRNGKey(3), jnp.float32)
    if rep:
        from repro.models import rwkv6 as jrwkv
        jp = jrwkv.pad_head_params(jp, jcfg, jbase.replace(jcfg, **dict(rep)))
    jp = train_mesh._np(jp)
    cfg = replace(get_reduced_config(arch), **dict(rep))
    leaves = []
    sharding.map_logical(lambda log, a: leaves.append(a),
                         api.logical_axes(cfg), jp)
    return jp, leaves


@pytest.mark.parametrize("rules", [FF, B2, {"embed": ("data",),
                                            "vocab": ("data",),
                                            "ssm_heads": ("data",)}],
                         ids=["ff", "b2", "embed_vocab_ssm"])
@pytest.mark.parametrize("arch,rep", TREES)
def test_lm_shard_from_numpy_under_an_override_gives_back_the_tree(
        arch, rep, rules):
    """Every coordinate's blocks of data 2 × model 4 under the override,
    put back together, are the reference's whole tree bit for bit."""
    jp, want = _tree(arch, tuple(sorted(rep.items())))
    cfg = replace(get_reduced_config(arch), **rep)
    mesh = FakeMesh(data=2, model=4)
    logical = api.logical_axes(cfg)
    specs = []
    sharding.map_logical(lambda log, a: specs.append(
        sharding.resolve_spec(a.shape, log, mesh, rules)), logical, jp)
    whole = [np.full(a.shape, np.nan, np.float32) for a in want]
    for d in range(2):
        for m in range(4):
            coord = {"data": d, "model": m}
            blocks = convert.lm_shard_from_numpy(jp, logical, mesh, coord,
                                                 rules, device="cpu")
            for w, b, spec in zip(whole, api_leaves(blocks, logical), specs):
                at = [coord[e] * n if e else 0
                      for e, n in zip(spec, b.shape)]
                w[tuple(slice(o, o + n) for o, n in zip(at, b.shape))] = \
                    b.numpy()
    assert all(np.array_equal(w, a) for w, a in zip(whole, want))
    assert any("data" in s for s in specs), "the override shards nothing"


def api_leaves(tree, logical):
    out = []
    sharding.map_logical(lambda log, a: out.append(a), logical, tree)
    return out


# ---------------------------------------------------------------------------
# the dry run and the hillclimb registry
# ---------------------------------------------------------------------------

def test_dryrun_argument_bytes_under_an_override_are_the_blocks(tmp_path,
                                                                capsys):
    """Rank 0 of ``pod`` under A2 (Qwen3-MoE-235B-A22B cut to 2 layers at
    full width): its argument bytes are the sum of the reference layout's
    per-chip blocks under ``{"ff": ("data",)}`` — params, AdamW's μ and ν
    and the batch; the weights' gathers go over ``data`` both ways, and
    the report's rules are the merged set. The CLI takes the same
    override as JSON."""
    shape = INPUT_SHAPES["train_4k"]
    cfg = replace(dryrun.shape_cfg(get_config("qwen3_moe_235b_a22b"), shape),
                  num_layers=2)
    rep = dryrun.trace_mesh_combo(cfg, shape, "pod", rules_override=FF,
                                  cfg_override={"moe_combine_sharding":
                                                "batch"})
    jcfg = jbase.replace(jbase.get_config("qwen3_moe_235b_a22b"),
                         num_layers=2)
    params = jax.eval_shape(lambda: japi.init_params(
        jcfg, jax.random.PRNGKey(0)))
    p_log = japi.logical_axes(jcfg)
    f32 = jax.tree.map(lambda s: jax.ShapeDtypeStruct(s.shape, np.float32),
                       params)
    io, iolog = japi.input_specs(jcfg, jbase.INPUT_SHAPES["train_4k"])
    mesh = lm_sharding.MESH
    want = (lm_sharding._per_chip(params, p_log, mesh, FF)
            + 2 * lm_sharding._per_chip(f32, p_log, mesh, FF)
            + lm_sharding._per_chip(io, iolog, mesh, FF))
    assert rep["memory"]["argument_bytes_per_card"] == want
    assert rep["rules"] == {"ff": ["data"]}
    coll, back = rep["collectives"], rep["collectives_backward"]
    assert coll["count_by_kind"]["reduce-scatter"] == \
        back["count_by_kind"]["reduce-scatter"] == 2 * 3
    assert coll["count_by_kind"]["all-gather"] >= 2 * 2 * 3
    rc = dryrun.main(["--arch", "olmoe_1b_7b", "--shape", "decode_32k",
                      "--mesh", "pod", "--rules", '{"ff": ["data"]}',
                      "--set", "moe_combine_sharding=batch",
                      "--out", str(tmp_path)])
    out = capsys.readouterr().out
    assert rc == 0 and "fail=0" in out, out
    assert dryrun.parse_set(["a=16", "b=batch", "c=true"]) == \
        {"a": 16, "b": "batch", "c": True}


def _hillclimb_torch():
    spec = importlib.util.spec_from_file_location(
        "hillclimb_torch", os.path.join(ROOT, "scripts", "hillclimb_torch.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_the_hillclimb_registry_is_the_reference_s():
    """``scripts/hillclimb_torch.py``'s variants are the reference's
    (read from ``scripts/hillclimb.py`` with ``ast``, since importing it
    sets XLA flags): the same names, arches, shapes, rule overrides and
    configuration overrides; each rule override is one the port runs."""
    tree = ast.parse(open(os.path.join(ROOT, "scripts",
                                       "hillclimb.py")).read())
    node = next(n.value for n in tree.body if isinstance(n, ast.Assign)
                and any(getattr(t, "id", None) == "VARIANTS"
                        for t in n.targets))
    ref = ast.literal_eval(node)
    got = _hillclimb_torch().VARIANTS
    assert list(got) == list(ref)
    for name, (arch, shape, rules, cfg_over, _) in ref.items():
        assert got[name][:4] == (arch, shape, rules, cfg_over), name
        assert arch in jbase.ARCH_IDS and shape in INPUT_SHAPES
        ctx.check_rules(sharding.normalize_rules(rules))
    assert len(got) == 19
