"""The port's CNN features, ELM core and Reduce against the reference's.

Inputs are made with numpy from a seed and fed to both packages; the
reference runs at ``use_pallas=False``. The CNN tree is the reference's own
init, carried over with ``repro_torch.convert``.

Tolerances (f32): features, U and V rtol 1e-5 (summation order); β
max|Δ| ≤ 1e-4 · max|β_ref| — the ridge system I/λ + U is ill-conditioned
(cond ~4e5 at full width), which amplifies summation-order differences.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs.base import get_config as jget, get_reduced_config as jget_r
from repro.core import averaging as javg, elm as jelm
from repro.models import cnn as jcnn
from repro_torch import convert
from repro_torch.configs import get_config, get_reduced_config
from repro_torch.core import averaging, elm
from repro_torch.layers.norms import optimal_tanh
from repro_torch.models import cnn

# the reference's threaded tests share the CPU with these workers
torch.set_num_threads(2)

ARCHS = ["cnn_elm_6c12c", "cnn_elm_3c9c"]


def _close(got, ref, rtol=1e-5):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=rtol,
                               atol=rtol * float(np.abs(ref).max()))


def _beta_close(got, ref):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape
    assert np.abs(got - ref).max() <= 1e-4 * np.abs(ref).max()


def _configs(arch, reduced):
    if reduced:
        return jget_r(arch), get_reduced_config(arch)
    return jget(arch), get_config(arch)


def _images(n, seed=0):
    return np.random.default_rng(seed).random((n, 28, 28)).astype(np.float32)


@pytest.mark.parametrize("reduced", [True, False])
@pytest.mark.parametrize("arch", ARCHS)
def test_config_copy_matches_reference(arch, reduced):
    jcfg, tcfg = _configs(arch, reduced)
    assert tcfg == type(tcfg)(**{f: getattr(jcfg, f)
                                 for f in jcfg.__dataclass_fields__})
    assert cnn.feature_dim(tcfg) == jcnn.feature_dim(jcfg)


@pytest.mark.parametrize("reduced", [True, False])
@pytest.mark.parametrize("arch", ARCHS)
def test_features_match_reference(arch, reduced):
    jcfg, tcfg = _configs(arch, reduced)
    init = jax.tree.map(np.asarray, jcnn.init_params(jcfg,
                                                     jax.random.PRNGKey(3)))
    x = _images(16)
    ref = jcnn.features(jcfg, jax.tree.map(jnp.asarray, init),
                        jnp.asarray(x), use_pallas=False)
    got = cnn.features(tcfg, convert.params_from_numpy(init, "cpu"),
                       torch.from_numpy(x))
    assert got.shape == (16, cnn.feature_dim(tcfg))
    _close(got.numpy(), ref)


def test_features_members_equal_per_member_calls():
    """The member-batched form is the one-member form, member by member."""
    cfg = get_reduced_config("cnn_elm_6c12c")
    params = [cnn.init_params(cfg, torch.Generator().manual_seed(s), "cpu")
              for s in range(3)]
    params_k = {"stages": tuple(
        {n: torch.stack([p["stages"][i][n] for p in params]) for n in "wb"}
        for i in range(len(cfg.cnn_channels)))}
    x = torch.from_numpy(_images(3 * 5).reshape(3, 5, 28, 28))
    batched = cnn.features_members(cfg, params_k, x)
    for i in range(3):
        assert torch.equal(batched[i], cnn.features(cfg, params[i], x[i]))


def test_init_params_distribution_and_device():
    cfg = get_config("cnn_elm_6c12c")
    p = cnn.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    again = cnn.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    shapes = [tuple(st["w"].shape) for st in p["stages"]]
    assert shapes == [(5, 5, 1, 6), (5, 5, 6, 12)]
    for st, st2, fan_in in zip(p["stages"], again["stages"], (25, 150)):
        assert torch.equal(st["w"], st2["w"])
        assert not st["b"].any()
        std = float(st["w"].std())
        assert 0.6 * (2 / fan_in) ** 0.5 < std < 1.4 * (2 / fan_in) ** 0.5


def test_optimal_tanh_matches_reference():
    from repro.layers.norms import optimal_tanh as jtanh
    x = np.random.default_rng(1).normal(size=(7, 9)).astype(np.float32) * 3
    _close(optimal_tanh(torch.from_numpy(x)).numpy(), jtanh(jnp.asarray(x)))


@pytest.mark.parametrize("mask_kind", [None, "binary", "scalar"])
def test_batch_stats_match_reference(mask_kind):
    rng = np.random.default_rng(4)
    h = rng.normal(size=(60, 64)).astype(np.float32)
    t = np.eye(10, dtype=np.float32)[rng.integers(0, 10, 60)]
    mask = {None: None, "scalar": np.float32(0.0),
            "binary": (rng.random(60) > 0.3).astype(np.float32)}[mask_kind]
    ref = jelm.batch_stats(jnp.asarray(h), jnp.asarray(t), use_pallas=False,
                           mask=None if mask is None else jnp.asarray(mask))
    got = elm.batch_stats(torch.from_numpy(h), torch.from_numpy(t),
                          mask=None if mask is None else torch.tensor(mask))
    _close(got.u.numpy(), ref.u)
    _close(got.v.numpy(), ref.v)
    assert float(got.n) == float(ref.n)
    if mask_kind == "scalar":          # a zero mask drops every row
        assert not got.u.any() and not got.v.any() and float(got.n) == 0.0


def test_batch_stats_member_mask_drops_whole_batches():
    """Member-stacked stats with one validity bit per member: a 0 member
    contributes nothing, a 1 member equals its unmasked stats."""
    rng = np.random.default_rng(5)
    h = torch.from_numpy(rng.normal(size=(3, 20, 8)).astype(np.float32))
    t = torch.from_numpy(rng.normal(size=(3, 20, 2)).astype(np.float32))
    s = elm.batch_stats(h, t, mask=torch.tensor([1.0, 0.0, 1.0]))
    full = elm.batch_stats(h, t)
    assert s.n.tolist() == [20.0, 0.0, 20.0] and full.n.tolist() == [20.0] * 3
    assert not s.u[1].any() and not s.v[1].any()
    for i in (0, 2):
        assert torch.equal(s.u[i], full.u[i]) and torch.equal(s.v[i],
                                                              full.v[i])


def _spd_stats(seed, k=None, L=24, C=5, n=80):
    rng = np.random.default_rng(seed)
    shape = (n, L) if k is None else (k, n, L)
    h = rng.normal(size=shape).astype(np.float32)
    t = rng.normal(size=shape[:-1] + (C,)).astype(np.float32)
    hm = np.swapaxes(h, -1, -2)
    return (hm @ h).astype(np.float32), (hm @ t).astype(np.float32)


@pytest.mark.parametrize("k", [None, 3])
def test_solve_beta_matches_reference(k):
    u, v = _spd_stats(6, k)
    n = np.float32(80.0)
    ref = jelm.solve_beta(jelm.ELMStats(jnp.asarray(u), jnp.asarray(v), n),
                          100.0)
    got = elm.solve_beta(elm.ELMStats(torch.from_numpy(u),
                                      torch.from_numpy(v), torch.tensor(n)),
                         100.0)
    _beta_close(got.numpy(), ref)


def test_solve_beta_stacked_equals_unbatched():
    u, v = _spd_stats(7, 3)
    stacked = elm.solve_beta(elm.ELMStats(torch.from_numpy(u),
                                          torch.from_numpy(v), None), 100.0)
    for i in range(3):
        one = elm.solve_beta(elm.ELMStats(torch.from_numpy(u[i]),
                                          torch.from_numpy(v[i]), None), 100.0)
        assert torch.equal(stacked[i], one)


def test_add_and_downdate_stats():
    a = elm.ELMStats(torch.ones(2, 2), torch.ones(2, 1), torch.tensor(3.0))
    b = elm.ELMStats(torch.full((2, 2), 2.0), torch.zeros(2, 1),
                     torch.tensor(1.0))
    s = elm.add_stats(a, b)
    assert s.u.tolist() == [[3.0, 3.0], [3.0, 3.0]] and float(s.n) == 4.0
    back = elm.downdate_stats(s, b)
    assert torch.equal(back.u, a.u) and float(back.n) == 3.0
    z = elm.zero_stats_stacked(4, 6, 3, device="cpu")
    assert z.u.shape == (4, 6, 6) and z.v.shape == (4, 6, 3)
    assert z.n.shape == (4,)


def test_predict_loss_accuracy_match_reference():
    rng = np.random.default_rng(8)
    h = rng.normal(size=(30, 16)).astype(np.float32)
    beta = rng.normal(size=(16, 4)).astype(np.float32)
    t = np.eye(4, dtype=np.float32)[rng.integers(0, 4, 30)]
    s = elm.predict(torch.from_numpy(h), torch.from_numpy(beta))
    _close(s.numpy(), jelm.predict(jnp.asarray(h), jnp.asarray(beta)))
    loss = elm.elm_loss(torch.from_numpy(h), torch.from_numpy(beta),
                        torch.from_numpy(t))
    ref = jelm.elm_loss(jnp.asarray(h), jnp.asarray(beta), jnp.asarray(t))
    assert abs(float(loss) - float(ref)) <= 1e-5 * abs(float(ref))
    y = t.argmax(-1)
    assert float(elm.accuracy(s, torch.from_numpy(y))) == pytest.approx(
        float(jelm.accuracy(jnp.asarray(s.numpy()), jnp.asarray(y))))


def _trees(k, seed, dtype=np.float32):
    rng = np.random.default_rng(seed)
    return [{"stages": ({"w": rng.normal(size=(3, 3, 1, 2)).astype(dtype),
                         "b": rng.normal(size=(2,)).astype(dtype)},),
             "beta": rng.normal(size=(8, 3)).astype(dtype)}
            for _ in range(k)]


@pytest.mark.parametrize("weights", [None, [1.0, 3.0, 0.5, 2.0]])
def test_average_trees_match_reference(weights):
    trees = _trees(4, 9)
    jt = [jax.tree.map(jnp.asarray, t) for t in trees]
    tt = [convert.params_from_numpy(t, "cpu") for t in trees]
    if weights is None:
        ref, got = javg.average_trees(jt), averaging.average_trees(tt)
    else:
        ref = javg.weighted_average_trees(jt, weights)
        got = averaging.weighted_average_trees(tt, weights)
    for g, r in zip(jax.tree.leaves(convert.to_numpy(got)),
                    jax.tree.leaves(ref)):
        _close(g, r)


@pytest.mark.parametrize("weights", [None, [2.0, 1.0, 1.0, 4.0]])
def test_average_member_dim_equals_list_average_bitwise(weights):
    """The stacked and list forms sum members in the same order: the two
    Map backends reduce to bit-identical averages."""
    tt = [convert.params_from_numpy(t, "cpu") for t in _trees(4, 10)]
    stacked = {"stages": ({n: torch.stack([t["stages"][0][n] for t in tt])
                           for n in "wb"},),
               "beta": torch.stack([t["beta"] for t in tt])}
    a = averaging.average_member_dim(stacked, weights=weights)
    b = (averaging.average_trees(tt) if weights is None
         else averaging.weighted_average_trees(tt, weights))
    assert torch.equal(a["beta"], b["beta"])
    assert torch.equal(a["stages"][0]["w"], b["stages"][0]["w"])
    back = averaging.broadcast_member_dim(a, 4)
    assert back["beta"].shape == (4, 8, 3)
    assert torch.equal(back["beta"][2], a["beta"])


def test_average_bf16_accumulates_in_f32():
    """bf16 leaves average in f32 and land within one bf16 ulp of the
    f32-exact mean (the reference's regression contract)."""
    k = 8
    rng = np.random.default_rng(11)
    base = (1.0 + rng.random((64,)) * 0.01).astype(np.float32)
    members = [{"w": torch.from_numpy(base + 1e-3 * i).to(torch.bfloat16)}
               for i in range(k)]
    avg = averaging.average_trees(members)
    assert avg["w"].dtype == torch.bfloat16
    exact = np.mean([m["w"].float().numpy() for m in members], axis=0)
    assert np.abs(avg["w"].float().numpy() - exact).max() <= 2.0 ** -8
    ref = javg.average_trees([{"w": jnp.asarray(m["w"].float().numpy(),
                                                jnp.bfloat16)}
                              for m in members])
    np.testing.assert_array_equal(avg["w"].float().numpy(),
                                  np.asarray(ref["w"], np.float32))
