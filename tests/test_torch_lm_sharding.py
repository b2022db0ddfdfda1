"""The LM half of the port's sharding (``repro_torch.distributed.sharding``,
``distributed/ctx.py``, the models' ``logical_axes`` / ``cache_logical``)
held against the reference's on the CPU, with no card and nothing
allocated at full size.

* resolution parity: every parameter, cache and input leaf of every LM
  arch at full size resolves on the reference's 16 × 16 (data, model)
  mesh, and on its 2 × 16 × 16 (pod, data, model) mesh under its
  ``MULTIPOD_RULES``, to the reference's ``resolve_spec`` entry for entry
  (both through a ``FakeMesh``: shapes from ``api.param_specs`` /
  ``jax.eval_shape``);
* the cases of the reference's ``tests/test_sharding.py``: divisibility
  fallback, no axis reused, tuple candidates, member prepend;
* ``convert.lm_shard_from_numpy``: a reference tree cut into every
  coordinate's blocks and put back together is bitwise the whole tree;
* the dry run's ``pod`` and ``multipod`` meshes: rank 0's argument bytes
  are the sum of the reference layout's per-chip blocks, the collectives
  are counted by axis, and nothing is sent over ``data``;
* with no mesh context ``maybe_constrain`` and the models are as before.
"""
import os
from unittest import mock

import jax
import numpy as np
import pytest
import torch

from repro.configs import base as jbase
from repro.distributed import sharding as jsharding
from repro.models import api as japi
from repro_torch import convert
from repro_torch.configs import InputShape, get_config, get_reduced_config
from repro_torch.configs import base as tbase
from repro_torch.distributed import ctx, sharding
from repro_torch.launch import dryrun
from repro_torch.models import api, transformer

with mock.patch.dict(os.environ):
    from repro.launch import dryrun as jdryrun

torch.set_num_threads(2)

LM_ARCHS = [a for a in tbase.ARCH_IDS if not a.startswith("cnn_elm")]


class FakeMesh:
    """Stand-in with just .shape — resolve_spec only reads mesh.shape."""

    def __init__(self, **axes):
        self.shape = axes


MESH = FakeMesh(data=16, model=16)
PODMESH = FakeMesh(pod=2, data=16, model=16)
MESHES = {"pod": (MESH, None), "multipod": (PODMESH, jdryrun.MULTIPOD_RULES)}


def _is_logical(x):
    return isinstance(x, tuple) and all(e is None or isinstance(e, str)
                                        for e in x)


def _flat(tree, pre="", leaf=lambda x: False):
    """{path: leaf} of a nested dict / tuple / list tree."""
    if leaf(tree):
        return {pre: tree}
    if isinstance(tree, dict):
        return {k: v for key, sub in tree.items()
                for k, v in _flat(sub, f"{pre}/{key}", leaf).items()}
    if isinstance(tree, (list, tuple)):
        return {k: v for i, sub in enumerate(tree)
                for k, v in _flat(sub, f"{pre}/{i}", leaf).items()}
    return {pre: tree}


def _ref_specs(shapes, logical, mesh, rules):
    """{path: the reference's spec entries} of a shape tree."""
    shp = _flat(jax.tree.map(lambda s: tuple(s.shape), shapes),
                leaf=lambda x: isinstance(x, tuple) and all(
                    isinstance(e, int) for e in x))
    log = _flat(logical, leaf=_is_logical)
    assert shp.keys() == log.keys()
    return {k: tuple(jsharding.resolve_spec(shp[k], log[k], mesh, rules))
            for k in shp}


def _per_chip(shapes, logical, mesh, rules):
    """The reference layout's per-chip bytes of a shape tree."""
    specs = _ref_specs(shapes, logical, mesh, rules)
    sizes = _flat(jax.tree.map(lambda s: (int(np.prod(s.shape)),
                                          s.dtype.itemsize), shapes),
                  leaf=lambda x: isinstance(x, tuple) and len(x) == 2
                  and all(isinstance(e, int) for e in x))
    total = 0
    for k, (n, item) in sizes.items():
        blocks = 1
        for e in specs[k]:
            for a in (e if isinstance(e, tuple) else (e,)):
                blocks *= mesh.shape[a] if a else 1
        total += n // blocks * item
    return total


def _port_specs(specs, logical, mesh, rules):
    return _flat(sharding.resolve_tree(specs, logical, mesh, rules),
                 leaf=lambda x: isinstance(x, tuple))


@pytest.mark.parametrize("mesh_name", ["pod", "multipod"])
@pytest.mark.parametrize("arch", LM_ARCHS)
def test_param_specs_equal_the_reference(arch, mesh_name):
    mesh, rules = MESHES[mesh_name]
    jcfg, tcfg = jbase.get_config(arch), get_config(arch)
    jshapes = jax.eval_shape(lambda: japi.init_params(
        jcfg, jax.random.PRNGKey(0)))
    ref = _ref_specs(jshapes, japi.logical_axes(jcfg), mesh, rules)
    got = _port_specs(api.param_specs(tcfg), api.logical_axes(tcfg), mesh,
                      rules)
    assert got == ref
    # and the port's logical spec has the rank of each leaf
    shapes = _flat(api.param_specs(tcfg))
    logs = _flat(api.logical_axes(tcfg), leaf=_is_logical)
    assert shapes.keys() == logs.keys()
    assert all(len(logs[k]) == len(shapes[k].shape) for k in shapes)


@pytest.mark.parametrize("mesh_name", ["pod", "multipod"])
@pytest.mark.parametrize("arch", LM_ARCHS)
def test_cache_and_input_specs_equal_the_reference(arch, mesh_name):
    mesh, rules = MESHES[mesh_name]
    jcfg0, tcfg0 = jbase.get_config(arch), get_config(arch)
    ok = tbase.supported_shapes(tcfg0)
    for name, shape in tbase.INPUT_SHAPES.items():
        if not ok[name]:
            continue
        jcfg = jdryrun._shape_cfg(jcfg0, jbase.INPUT_SHAPES[name])
        tcfg = dryrun.shape_cfg(tcfg0, shape)
        jin, jlog = japi.input_specs(jcfg, jbase.INPUT_SHAPES[name])
        tin, tlog = api.input_specs(tcfg, shape, with_logical=True)
        assert tlog == jlog
        assert _port_specs(tin, tlog, mesh, rules) == _ref_specs(
            jin, jlog, mesh, rules), name
        if shape.kind != "decode":
            continue
        jcache, jclog = japi.cache_specs(jcfg, jbase.INPUT_SHAPES[name])
        tcache, tclog = api.cache_specs(tcfg, shape, with_logical=True)
        assert _port_specs(tcache, tclog, mesh, rules) == _ref_specs(
            jcache, jclog, mesh, rules), name


def test_cache_is_sharded_by_sequence_at_decode():
    """``kv_seq`` takes 'model' before ``kv_heads`` is reached."""
    cfg = get_config("qwen3_8b")
    cache, log = api.cache_specs(cfg, tbase.INPUT_SHAPES["decode_32k"],
                                 with_logical=True)
    assert sharding.resolve_spec(cache["k"].shape, log["k"], MESH) == \
        (None, "data", "model", None, None)
    assert sharding.block_shape(cache["k"].shape, sharding.resolve_spec(
        cache["k"].shape, log["k"], MESH), MESH.shape) == (36, 8, 2048, 8,
                                                           128)


# the cases of the reference's tests/test_sharding.py

def test_basic_resolution():
    assert sharding.resolve_spec((1024, 4096), ("vocab", "embed"), MESH) \
        == ("model", None)


def test_divisibility_fallback():
    # 122753 (minicpm vocab) % 16 != 0 -> replicate
    assert sharding.resolve_spec((122753, 2304), ("vocab", "embed"),
                                 MESH) == (None, None)


def test_no_axis_reuse_within_array():
    assert sharding.resolve_spec((128, 256), ("expert", "ff"), MESH) == \
        ("model", None)


def test_tuple_axis_candidates():
    rules = {"batch": (("pod", "data"), "data")}
    assert sharding.resolve_spec((128, 1), ("batch", None), PODMESH,
                                 rules) == (("pod", "data"), None)
    assert sharding.resolve_spec((16, 1), ("batch", None), PODMESH,
                                 rules) == ("data", None)


def test_member_dim_prepend():
    assert sharding.with_member_dim({"w": ("embed", "ff")}) == \
        {"w": ("member", "embed", "ff")}
    assert sharding.with_member_dim(api.logical_axes(
        get_reduced_config("qwen3_8b")))["layers"]["attn"]["wq"] == \
        ("member", "layers", "embed", "heads")


def test_member_resolve_rules():
    pod8 = FakeMesh(pod=8)
    assert sharding.resolve_spec((8, 5), ("member", None), pod8) == \
        ("pod", None)
    assert sharding.resolve_spec((6, 5), ("member", None), pod8) == \
        (None, None)
    assert sharding.resolve_spec((32, 5), ("member", None), MESH,
                                 rules={"member": ("data",)}) == \
        ("data", None)


def test_bytes_of_tree_equals_the_reference_count():
    cfg = get_config("qwen3_8b")
    jshapes = jax.eval_shape(lambda: japi.init_params(
        jbase.get_config("qwen3_8b"), jax.random.PRNGKey(0)))
    assert sharding.bytes_of_tree(api.param_specs(cfg)) == \
        jsharding.bytes_of_tree(jshapes)


# convert

@pytest.mark.parametrize("arch,mesh", [
    ("qwen3_8b", {"data": 2, "model": 4}),
    ("olmoe_1b_7b", {"pod": 2, "data": 1, "model": 2}),
    ("minicpm_2b", {"data": 1, "model": 4})])
def test_convert_shards_gather_back_bitwise(arch, mesh):
    """Every coordinate's blocks, put back where their specs place them,
    are bitwise the reference's whole tree, each leaf in its dtype."""
    tree = jax.tree.map(np.asarray, japi.init_params(
        jbase.get_reduced_config(arch), jax.random.PRNGKey(1)))
    logical = api.logical_axes(get_reduced_config(arch))
    fake = FakeMesh(**mesh)
    rules = jdryrun.MULTIPOD_RULES if "pod" in mesh else None
    whole = _flat(convert.lm_tree_from_numpy(tree, "cpu"))
    flat_log = _flat(logical, leaf=_is_logical)
    back = {k: torch.full_like(v, float("nan")) for k, v in whole.items()}
    for idx in np.ndindex(*mesh.values()):
        coord = dict(zip(mesh, idx))
        part = _flat(convert.lm_shard_from_numpy(tree, logical, fake, coord,
                                                 rules, device="cpu"))
        for k, t in part.items():
            spec = sharding.resolve_spec(whole[k].shape, flat_log[k], fake,
                                         rules)
            at = tuple(slice(sharding.entry_index(e, coord, mesh) * n,
                             (sharding.entry_index(e, coord, mesh) + 1) * n)
                       for e, n in zip(spec, t.shape))
            back[k][at] = t
    for k, v in whole.items():
        assert back[k].dtype == v.dtype and torch.equal(back[k], v), k


# the dry run on the reference's meshes

@pytest.mark.parametrize("mesh_name,arch,shape_name", [
    ("pod", "qwen3_8b", "decode_32k"),
    ("multipod", "olmoe_1b_7b", "long_500k")])
def test_dryrun_mesh_argument_bytes_are_the_reference_blocks(
        mesh_name, arch, shape_name):
    """Rank 0's argument bytes equal the sum of the reference layout's
    per-chip blocks of the params, the cache and the token; collectives
    by axis, none over 'data'."""
    mesh, rules = MESHES[mesh_name]
    jshape = jbase.INPUT_SHAPES[shape_name]
    jcfg = jdryrun._shape_cfg(jbase.get_config(arch), jshape)
    chips = int(np.prod(list(mesh.shape.values())))

    def per_chip(shapes, logical):
        return _per_chip(shapes, logical, mesh, rules)

    params = jax.eval_shape(lambda: japi.init_params(
        jcfg, jax.random.PRNGKey(0)))
    cache, clog = japi.cache_specs(jcfg, jshape)
    io, iolog = japi.input_specs(jcfg, jshape)
    want = (per_chip(params, japi.logical_axes(jcfg))
            + per_chip(cache, clog)
            + per_chip({"token": io["token"]}, {"token": iolog["token"]}))
    rep = dryrun.lower_combo(arch, shape_name, mesh_name)
    assert rep["memory"]["argument_bytes_per_card"] == want
    assert rep["cards"] == chips
    assert "data" not in rep["collectives"]["count_by_axis"]
    assert rep["collectives"]["count_by_axis"]
    assert rep["kernels"]["rmsnorm"] > 0


def test_dryrun_mesh_skips_training_and_the_recurrent_families():
    """No LM combo is skipped on the pod meshes any more: the dry run has
    no family skip note (the recurrent families run sharded, training
    included), and its only skip is the encoder-only note, which holds
    on every mesh."""
    assert not hasattr(dryrun, "mesh_skip")
    assert not hasattr(dryrun, "MESH_FAMILY_NOTE")
    assert not hasattr(dryrun, "MESH_TRAIN_NOTE")
    skipped = {(a, s) for a, s, ok in dryrun.combos() if not ok}
    assert skipped and all(get_config(a).is_encoder_only
                           for a, _ in skipped)


@pytest.mark.parametrize("mesh_name", ["pod", "multipod"])
def test_dryrun_traces_train_4k_for_every_transformer_family(mesh_name):
    """train_4k on both meshes: no skip note for any arch of the
    transformer families, and the step a user runs there (the member
    step on multipod)."""
    archs = [a for a in LM_ARCHS
             if get_config(a).family in transformer.FAMILIES]
    assert {get_config(a).family for a in archs} == \
        set(transformer.FAMILIES)
    shape = tbase.INPUT_SHAPES["train_4k"]
    assert all(supported for a, s, supported in dryrun.combos()
               if a in archs and s == "train_4k")
    from repro_torch.core import trainer
    member = dryrun.step_fn(get_config("qwen3_8b"), shape, multi=True)
    plain = dryrun.step_fn(get_config("qwen3_8b"), shape)
    assert member.__qualname__.startswith(
        trainer.make_member_train_step.__name__)
    assert plain.__qualname__.startswith(trainer.make_train_step.__name__)


def _per_chip_train_bytes(arch, mesh_name, members):
    """The reference layout's per-chip bytes of a train_4k step's
    arguments (``resolve_spec`` on full-size trees, nothing allocated):
    params, AdamW's μ and ν (f32, the params' layout: the reference's
    ``_opt_logical``), the steps and the batch, on a member dim over
    ``pod`` for ``members``; and the argument bytes of the Reduce
    (the params alone)."""
    mesh, rules = MESHES[mesh_name]
    jshape = jbase.INPUT_SHAPES["train_4k"]
    jcfg = jbase.get_config(arch)

    def stack(tree):
        return jax.tree.map(lambda s: jax.ShapeDtypeStruct(
            (members,) + s.shape, s.dtype), tree) if members else tree

    def log(tree):
        return jsharding.with_member_dim(tree) if members else tree

    def per_chip(shapes, logical):
        return _per_chip(shapes, logical, mesh, rules)

    params = jax.eval_shape(lambda: japi.init_params(
        jcfg, jax.random.PRNGKey(0)))
    p_log = japi.logical_axes(jcfg)
    f32 = jax.tree.map(lambda s: jax.ShapeDtypeStruct(s.shape, np.float32),
                       params)
    io, iolog = japi.input_specs(jcfg, jshape)
    p_bytes = per_chip(stack(params), log(p_log))
    opt = 2 * per_chip(stack(f32), log(p_log))
    batch = per_chip(stack(io), log(iolog))
    return p_bytes, opt, batch


@pytest.mark.parametrize("mesh_name,arch", [
    ("pod", "qwen3_8b"), ("multipod", "qwen3_8b"),
    ("multipod", "olmoe_1b_7b")])
def test_dryrun_mesh_train_argument_bytes_are_the_reference_blocks(
        mesh_name, arch):
    """Rank 0's train_4k argument bytes equal the reference layout's
    per-chip blocks of the params, AdamW's μ and ν and the batch (on
    multipod with the member dim over 'pod': one member a card); the
    collectives go both ways by axis, the backward's over 'model' only,
    and on multipod the member step sends nothing over 'pod', while the
    Reduce beside it is one all-reduce over 'pod' of the params' blocks
    in f32."""
    members = dryrun.MEMBERS if mesh_name == "multipod" else 0
    p_bytes, opt, batch = _per_chip_train_bytes(arch, mesh_name, members)
    rep = dryrun.lower_combo(arch, "train_4k", mesh_name)
    assert rep["memory"]["argument_bytes_per_card"] == p_bytes + opt + batch
    by_axis = rep["collectives"]["count_by_axis"]
    assert by_axis["model"] and by_axis["data"] and "pod" not in by_axis
    assert set(rep["collectives_backward"]["count_by_axis"]) == {"model"}
    assert rep["kernels"]["swa_attention_bwd"] > 0
    if members:
        avg = rep["average_step"]
        assert avg["collectives"]["count_by_axis"] == {"pod": 1}
        assert avg["argument_bytes_per_card"] == p_bytes
        # the blocks raveled into one f32 vector: μ's size
        assert avg["collectives"]["raw_bytes_by_kind"] == \
            {"all-reduce": opt // 2}
    else:
        assert "average_step" not in rep


# no context

def test_no_context_is_a_no_op():
    x = torch.arange(6.0).reshape(2, 3)
    assert ctx.current() is None
    assert ctx.maybe_constrain(x, ("batch", None)) is x


def test_transformer_loss_under_a_world_one_context_is_the_plain_one():
    """Under a context whose axes are all of size 1 the vocab-sharded
    cross-entropy and the remat'd layers compute the plain loss and
    gradient bit for bit, sending nothing."""
    from repro_torch.core import trainer
    from repro_torch.distributed import collectives
    cfg = get_reduced_config("olmoe_1b_7b")
    params = api.init_params(cfg, torch.Generator().manual_seed(0),
                             torch.float32, device="cpu")
    gen = torch.Generator().manual_seed(1)
    batch = {k: torch.randint(0, cfg.vocab_size, (2, 12), generator=gen)
             for k in ("tokens", "targets")}

    def loss_fn(p, b):
        return api.loss_fn(cfg, p, b)

    from repro_torch.launch.mesh import LMMesh
    plain = trainer.loss_and_grads(cfg, loss_fn, params, batch)
    collectives.reset()
    with ctx.use_mesh_rules(LMMesh({"data": 1, "model": 1}, rank=0)):
        ctx.declare(batch=2)
        ranked = trainer.loss_and_grads(cfg, loss_fn, params, batch)
    assert not collectives.CALLS
    assert torch.equal(plain[0], ranked[0])
    assert all(torch.equal(a, b) for a, b in zip(plain[2], ranked[2]))
    # the leaves' entries name the axes, which at size 1 send nothing
    assert plain[3] is None and set(ranked[3]) == {None, "model"}
