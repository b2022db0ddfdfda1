"""The port's LM training path against the reference's, on the CPU.

Optimizers, schedules and the clip against ``repro.optim``; the token
streams bitwise ``repro.data.lm_data``'s; Polyak averaging and
SimuParallelSGD against ``repro.core``'s; the train steps against
``repro.core.trainer``'s jitted ones from the reference's init (reduced
qwen3_8b, f32, passed across by ``convert.lm_tree_from_numpy``); the
average step in one process and over two gloo ranks; and the launcher
(``repro_torch.launch.train --device cpu``): training, resume bitwise, and
``state-<m>`` checkpoints crossing between the two launchers both ways.

Tolerances are stated per test. f32 values that went through the same
arithmetic in another order: rtol 1e-6 for a handful of elementwise ops,
rtol 1e-4 after three model steps (atol 1e-6 · max|leaf| for elements
that cancel to near 0).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro import optim as joptim
from repro.checkpoint import restore_checkpoint as jrestore
from repro.configs.base import get_reduced_config as jget_reduced
from repro.core import parallel_sgd as jpsgd
from repro.core import polyak as jpolyak
from repro.core import trainer as jtrainer
from repro.data import lm_data as jlm_data
from repro.launch import train as jlaunch
from repro.models import api as japi
from repro_torch import convert, optim
from repro_torch.checkpoint.ckpt import restore_checkpoint
from repro_torch.configs import get_reduced_config
from repro_torch.core import parallel_sgd, polyak, trainer
from repro_torch.data import lm_data
from repro_torch.launch import mesh as mesh_launch
from repro_torch.launch import train as launch
from repro_torch.tree import tree_leaves, tree_map

import torch_mesh_ranks as ranks
from torch_bounded import bounded

# the reference's threaded tests share the CPU with these workers
torch.set_num_threads(2)


def _pairs(port_tree, ref_tree):
    """(port leaf, reference leaf as a tensor) in the port tree's order."""
    out = []
    tree_map(lambda a, r: out.append((a, r)), port_tree,
             convert.lm_tree_from_numpy(jax.tree.map(np.asarray, ref_tree),
                                        "cpu"))
    return out


def _tree(seed):
    """A small tree with f32 and bf16 leaves, and a stacked one."""
    rng = np.random.default_rng(seed)
    return {"a": rng.normal(size=(3, 5)).astype(np.float32),
            "b": {"c": rng.normal(size=(4,)).astype(np.float32),
                  "d": rng.normal(size=(2, 3, 4)).astype(np.float32)}}


def _both(tree_np, bf16=True):
    """The same tree for both packages, the leaf ("b", "c") in bf16."""
    j = jax.tree.map(jnp.asarray, tree_np)
    t = tree_map(torch.from_numpy, tree_np)
    if bf16:
        j["b"]["c"] = j["b"]["c"].astype(jnp.bfloat16)
        t["b"]["c"] = t["b"]["c"].to(torch.bfloat16)
    return j, t


# ---------------------------------------------------------------------------
# optimizers, schedules, clip
# ---------------------------------------------------------------------------

OPTIMIZERS = {
    "sgd": (lambda m: m.sgd()),
    "momentum": (lambda m: m.momentum(0.9)),
    "nesterov": (lambda m: m.momentum(0.9, nesterov=True)),
    "adamw": (lambda m: m.adamw()),
    "adamw_wd": (lambda m: m.adamw(weight_decay=0.1)),
}


@pytest.mark.parametrize("name", sorted(OPTIMIZERS))
def test_optimizers_match_reference(name):
    """Three updates of random gradients at three rates: updates, state and
    new params within rtol 1e-6 (f32 elementwise ops; a bf16 leaf's new
    value within one bf16 ulp, rtol 2⁻⁷)."""
    jopt, topt = OPTIMIZERS[name](joptim), OPTIMIZERS[name](optim)
    jp, tp = _both(_tree(0))
    js, ts = jopt.init(jp), topt.init(tp)
    for step, lr in enumerate((0.1, 0.05, 0.02)):
        jg, tg = _both(_tree(10 + step))
        ju, js = jopt.update(jg, js, jp, jnp.asarray(step, jnp.int32),
                             jnp.asarray(lr, jnp.float32))
        tu, ts = topt.update(tg, ts, tp, step, np.float32(lr))
        jp, tp = joptim.apply_updates(jp, ju), optim.apply_updates(tp, tu)
        for a, r in _pairs(tu, ju) + _pairs(ts, js):
            assert a.dtype == torch.float32 == r.dtype
            np.testing.assert_allclose(a.numpy(), r.numpy(), rtol=1e-6,
                                       atol=1e-7)
        for a, r in _pairs(tp, jp):
            assert a.dtype == r.dtype
            rtol = 2.0 ** -7 if a.dtype == torch.bfloat16 else 1e-6
            np.testing.assert_allclose(a.float().numpy(), r.float().numpy(),
                                       rtol=rtol, atol=1e-7)


@pytest.mark.parametrize("name", sorted(OPTIMIZERS))
def test_step_leafwise_equals_the_whole_tree_update(name, monkeypatch):
    """``step_leafwise`` (one leaf, and a large leaf one slice, at a time)
    gives bitwise the values of ``apply_updates(update(...))`` on the
    clipped gradient tree, and empties the gradient list."""
    monkeypatch.setattr(optim.optimizers, "SLICE_ELEMENTS", 8)
    opt = OPTIMIZERS[name](optim)
    _, p = _both(_tree(1))
    state = opt.init(p)
    for step in range(3):
        _, g = _both(_tree(20 + step))
        clipped, norm = optim.clip_by_global_norm(g, 1.0)
        upd, want_state = opt.update(clipped, state, p, step, 0.05)
        want = optim.apply_updates(p, upd)
        grads = tree_leaves(g)
        got, got_state = optim.step_leafwise(
            opt, p, grads, state, step, 0.05,
            grad_scale=optim.clip_scale(norm, 1.0))
        assert grads == [None] * len(grads)
        for a, b in zip(tree_leaves((got, got_state)),
                        tree_leaves((want, want_state))):
            assert a.dtype == b.dtype and torch.equal(a, b)
        p, state = got, got_state


def test_schedules_match_reference():
    """Every schedule over steps 0..59 within rtol 1e-6 (the same f32
    operations; numpy's and XLA's cos and pow may differ by an ulp)."""
    pairs = [
        (joptim.constant(3e-4), optim.constant(3e-4)),
        (joptim.dynamic_paper(0.05), optim.dynamic_paper(0.05)),
        (joptim.linear_warmup(1e-3, 10), optim.linear_warmup(1e-3, 10)),
        (joptim.cosine(1e-3, 50), optim.cosine(1e-3, 50)),
        (joptim.cosine(3e-4, 40, warmup_steps=2),
         optim.cosine(3e-4, 40, warmup_steps=2)),
        (joptim.wsd(1e-3, 5, 28, 8), optim.wsd(1e-3, 5, 28, 8)),
    ]
    for jf, tf in pairs:
        for step in range(60):
            got, want = tf(step), float(jf(jnp.asarray(step, jnp.int32)))
            assert isinstance(got, np.float32)
            np.testing.assert_allclose(float(got), want, rtol=1e-6)


@pytest.mark.parametrize("max_norm", [0.5, 100.0])
def test_clip_and_global_norm_match_reference(max_norm):
    """The norm within rtol 1e-6 and the clipped tree f32 (as the
    reference's, whose scale is an f32 array) within rtol 1e-6."""
    jg, tg = _both(_tree(3))
    jc, jn = joptim.clip_by_global_norm(jg, max_norm)
    tc, tn = optim.clip_by_global_norm(tg, max_norm)
    np.testing.assert_allclose(float(tn), float(jn), rtol=1e-6)
    np.testing.assert_allclose(float(optim.global_norm(tg)),
                               float(joptim.global_norm(jg)), rtol=1e-6)
    for a, r in _pairs(tc, jc):
        assert a.dtype == torch.float32 == r.dtype
        np.testing.assert_allclose(a.numpy(), r.numpy(), rtol=1e-6)


# ---------------------------------------------------------------------------
# data, Polyak, SimuParallelSGD
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("member,domains,start", [(0, None, 0),
                                                  (3, [2, 5], 0),
                                                  (1, None, 7)])
def test_token_batches_are_the_references_bit_for_bit(member, domains,
                                                      start):
    spec = dict(vocab_size=151_936, seq_len=33, batch_size=3, num_domains=6,
                seed=2)
    jgen = jlm_data.synthetic_token_batches(
        jlm_data.TokenDatasetSpec(**spec), member, domains, start)
    tgen = lm_data.synthetic_token_batches(
        lm_data.TokenDatasetSpec(**spec), member, domains, start)
    for _ in range(4):
        (jt, jy), (tt, ty) = next(jgen), next(tgen)
        assert tt.dtype == jt.dtype == np.int32
        assert np.array_equal(tt, jt) and np.array_equal(ty, jy)


def test_polyak_matches_reference():
    """Five iterates with burn-in 2: the running mean and count within
    rtol 1e-6, before and after the burn-in; ``polyak_params`` casts to
    the dtypes of ``like``."""
    jp, tp = _both(_tree(4))
    js, ts = jpolyak.polyak_init(jp), polyak.polyak_init(tp)
    for step in range(5):
        jp, tp = _both(_tree(30 + step))
        js = jpolyak.polyak_update(js, jp, step=step, burn_in=2)
        ts = polyak.polyak_update(ts, tp, step=step, burn_in=2)
        assert float(ts.count) == float(js.count)
        for a, r in _pairs(ts.average, js.average):
            np.testing.assert_allclose(a.numpy(), r.numpy(), rtol=1e-6,
                                       atol=1e-7)
    out = polyak.polyak_params(ts, like=tp)
    assert out["b"]["c"].dtype == torch.bfloat16
    assert polyak.polyak_params(ts) is ts.average


def _lstsq_steps():
    """The same toy train step in both packages: one gradient step on
    ½‖Xw − y‖²/n at rate 0.1, and the per-member batches from seeds."""
    def jstep(p, s, b):
        x, y = b
        g = x.T @ (x @ p["w"] - y) / x.shape[0]
        return {"w": p["w"] - 0.1 * g}, s, jnp.mean((x @ p["w"] - y) ** 2)

    def tstep(p, s, b):
        x, y = b
        g = x.T @ (x @ p["w"] - y) / x.shape[0]
        return {"w": p["w"] - 0.1 * g}, s, torch.mean((x @ p["w"] - y) ** 2)

    def batches(member, wrap):
        rng = np.random.default_rng(member)
        w = np.arange(1.0, 5.0, dtype=np.float32)
        while True:
            x = rng.normal(size=(8, 4)).astype(np.float32)
            yield wrap(x), wrap((x @ w + 0.1 * member).astype(np.float32))

    return jstep, tstep, batches


@pytest.mark.parametrize("avg_period", [None, 1, 3])
def test_simu_parallel_sgd_matches_reference(avg_period):
    """k 3 members, 6 steps: the average, the members and the per-step
    losses within rtol 1e-6."""
    jstep, tstep, batches = _lstsq_steps()
    w0 = np.zeros(4, np.float32)
    javg, jmem, jhist = jpsgd.simu_parallel_sgd(
        {"w": jnp.asarray(w0)}, jstep,
        [batches(m, jnp.asarray) for m in range(3)], 6,
        avg_period=avg_period)
    tavg, tmem, thist = parallel_sgd.simu_parallel_sgd(
        {"w": torch.from_numpy(w0)}, tstep,
        [batches(m, torch.from_numpy) for m in range(3)], 6,
        avg_period=avg_period)
    for a, r in zip(tree_leaves((tavg, tmem)), jax.tree.leaves((javg, jmem))):
        np.testing.assert_allclose(a.numpy(), np.asarray(r), rtol=1e-6)
    np.testing.assert_allclose(np.array(thist, np.float32),
                               np.array(jhist, np.float32), rtol=1e-6)


def test_stacked_train_step_and_average_match_reference():
    """``make_stacked_train_step`` (a loop over the member dim) against
    the reference's vmap of the same toy step, then ``stacked_average``:
    within rtol 1e-6, every member equal to the average after it."""
    jstep, tstep, batches = _lstsq_steps()
    w = np.stack([np.full(4, m, np.float32) for m in range(3)])
    xs, ys = zip(*[next(batches(m, np.asarray)) for m in range(3)])
    x, y = np.stack(xs), np.stack(ys)

    def jmember(p, s, step, b):
        p, s, loss = jstep(p, s, b)
        return p, s, step + 1, loss

    def tmember(p, s, step, b):
        p, s, loss = tstep(p, s, b)
        return p, s, step + 1, loss

    jp, _, jsteps, jl = jpsgd.make_stacked_train_step(jmember)(
        {"w": jnp.asarray(w)}, {"s": jnp.zeros(3)}, jnp.zeros(3, jnp.int32),
        (jnp.asarray(x), jnp.asarray(y)))
    tp, _, tsteps, tl = parallel_sgd.make_stacked_train_step(tmember)(
        {"w": torch.from_numpy(w)}, {"s": torch.zeros(3)}, [0, 0, 0],
        (torch.from_numpy(x), torch.from_numpy(y)))
    assert tsteps == [1, 1, 1]
    np.testing.assert_allclose(tp["w"].numpy(), np.asarray(jp["w"]),
                               rtol=1e-6)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-6)
    javg = jpsgd.stacked_average(jp)
    tavg = parallel_sgd.stacked_average(tp)
    np.testing.assert_allclose(tavg["w"].numpy(), np.asarray(javg["w"]),
                               rtol=1e-6)
    assert all(torch.equal(tavg["w"][i], tavg["w"][0]) for i in range(3))


# ---------------------------------------------------------------------------
# the train steps on the reduced model
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def lm():
    """The reference's reduced qwen3_8b in f32, its port copy, and three
    batches of token ids from a seed."""
    jcfg = jget_reduced("qwen3_8b")
    cfg = get_reduced_config("qwen3_8b")
    jp = japi.init_params(jcfg, jax.random.PRNGKey(4), jnp.float32)
    tp = convert.lm_tree_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    rng = np.random.default_rng(0)
    batches = [(rng.integers(0, cfg.vocab_size, (2, 24)).astype(np.int32),
                rng.integers(0, cfg.vocab_size, (2, 24)).astype(np.int32))
               for _ in range(3)]
    return jcfg, cfg, jp, tp, batches


def _jbatch(x, y):
    return {"tokens": jnp.asarray(x), "targets": jnp.asarray(y)}


def _tbatch(x, y):
    return {"tokens": torch.from_numpy(x), "targets": torch.from_numpy(y)}


@pytest.mark.parametrize("name,lr", [("sgd", 1e-1), ("momentum", 1e-1),
                                     ("adamw", 3e-3)])
def test_make_train_step_matches_reference(lm, name, lr):
    """Three steps of ``make_train_step`` (clip 1.0, constant rate) against
    the reference's jitted step from the same init: loss and grad norm
    within rtol 1e-5, every leaf of the params within rtol 1e-4 and atol
    1e-6 · max|leaf| (elements that cancel to near 0), and of the momentum
    trace (a sum of gradients) within 1e-4 · max|leaf|, the per-leaf
    gradient bar of ``tests/test_torch_lm_grad.py``.

    AdamW moves an element by lr · m̂/(√v̂ + eps) a step, about lr
    whatever the gradient's scale, so an element's gradient difference
    (the f32 sums' ~4e-6 · max|grad of the leaf|) reaches the params
    relative to that element's own gradient, amplified where m̂ nearly
    cancels between steps: AdamW's params are held within rtol 1e-4 plus
    atol 1e-6 · max|leaf| + 1 % of lr per step taken (the largest seen:
    0.34 %). Two kinds of
    element are held only to the most such steps can differ, 2 · lr per
    step taken, and counted (under 1 % of the model): where some step's
    gradient lies within the per-leaf gradient bar of
    ``tests/test_torch_lm_grad.py`` (1e-4 · max|grad of the leaf|) of 0,
    the packages' gradients may differ in sign, and the normalised step
    with it; and where the clipped gradient ĝ sits within 100 · eps (1e-6)
    of 0, lr · ĝ/(|ĝ| + eps) turns ĝ's relative difference into a step
    of another size."""
    jcfg, cfg, jp, tp, batches = lm
    jopt, topt = OPTIMIZERS[name](joptim), OPTIMIZERS[name](optim)
    jstep = jax.jit(jtrainer.make_train_step(jcfg, jopt, joptim.constant(lr)))
    tstep = trainer.make_train_step(cfg, topt, optim.constant(lr))
    a, ao, astep = jp, jopt.init(jp), jnp.zeros((), jnp.int32)
    b, bo, bstep = tp, topt.init(tp), 0
    near_eps = None
    for t, (x, y) in enumerate(batches):
        if name == "adamw":
            jg = jax.grad(lambda p: japi.loss_fn(jcfg, p, _jbatch(x, y))[0])(a)
            gn = float(joptim.global_norm(jg))
            # (an exactly-0 gradient, an embedding row no token of the
            # batch uses, moves nothing in either package)
            small = [(r != 0) & (
                (r.abs() * min(1.0, 1.0 / (gn + 1e-9)) < 100 * 1e-8)
                | (r.abs() < 1e-4 * r.abs().max()))
                for _, r in _pairs(b, jg)]
            near_eps = small if near_eps is None else [
                m | s for m, s in zip(near_eps, small)]
        a, ao, astep, am = jstep(a, ao, astep, _jbatch(x, y))
        b, bo, bstep, bm = tstep(b, bo, bstep, _tbatch(x, y))
        assert bstep == t + 1 == int(astep)
        np.testing.assert_allclose(float(bm["loss"]), float(am["loss"]),
                                   rtol=1e-5)
        np.testing.assert_allclose(float(bm["grad_norm"]),
                                   float(am["grad_norm"]), rtol=1e-5)
        assert float(bm["lr"]) == float(am["lr"])
        assert float(bm["aux"]) == float(am["aux"]) == 0.0
    missed, total = {}, 0
    params = _pairs(b, a)
    for i, (got, ref) in enumerate(params):
        total += ref.numel()
        top = float(ref.abs().max())
        atol = 1e-6 * top
        if near_eps is not None:
            atol += 1e-2 * lr * len(batches)
        ok = (got - ref).abs() <= 1e-4 * ref.abs() + atol
        if near_eps is not None:
            mask = near_eps[i]
            if bool(mask.any()):
                assert float((got - ref)[mask].abs().max()) <= \
                    2 * lr * len(batches)
            ok = ok | mask
            if int(mask.sum()):
                missed[tuple(got.shape)] = int(mask.sum())
        assert bool(ok.all()), (tuple(got.shape), float(
            (got - ref)[~ok].abs().max()))
    if name == "adamw":
        assert sum(missed.values()) < 1e-2 * total, missed
    else:
        # the momentum trace is a sum of gradients: the per-leaf gradient
        # bar of tests/test_torch_lm_grad.py, 1e-4 · max|leaf|
        for got, ref in _pairs(bo, ao):
            top = float(ref.abs().max())
            np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=1e-4,
                                       atol=1e-4 * top)


def test_make_member_train_step_matches_reference_vmap(lm):
    """Two members (the same init, their own batches) on a leading member
    dim, two momentum steps: the port's loop over members against the
    reference's ``jax.vmap`` of its step: params within rtol 1e-4 and atol
    1e-6 · max|leaf|, the momentum trace within 1e-4 · max|leaf|; then
    ``make_average_step`` against the reference's (rtol 1e-6)."""
    jcfg, cfg, jp, tp, batches = lm
    jopt, topt = joptim.momentum(0.9), optim.momentum(0.9)
    sched_j, sched_t = joptim.constant(0.05), optim.constant(0.05)
    jstep = jax.jit(jtrainer.make_member_train_step(jcfg, jopt, sched_j))
    tstep = trainer.make_member_train_step(cfg, topt, sched_t)
    ja = jax.tree.map(lambda v: jnp.stack([v, v]), jp)
    ta = tree_map(lambda v: torch.stack([v, v]), tp)
    jo, to = jopt.init(ja), topt.init(ta)
    js, ts = jnp.zeros(2, jnp.int32), [0, 0]
    for t in range(2):
        x = np.stack([batches[t][0], batches[t + 1][0]])
        y = np.stack([batches[t][1], batches[t + 1][1]])
        ja, jo, js, jm = jstep(ja, jo, js, _jbatch(x, y))
        ta, to, ts, tm = tstep(ta, to, ts, _tbatch(x, y))
        np.testing.assert_allclose(tm["loss"].numpy(), np.asarray(jm["loss"]),
                                   rtol=1e-5)
    assert ts == [2, 2]
    for got, ref in _pairs(ta, ja):
        top = float(ref.abs().max())
        np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=1e-4,
                                   atol=1e-6 * top)
    for got, ref in _pairs(to, jo):     # the trace: the gradient bar
        top = float(ref.abs().max())
        np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=1e-4,
                                   atol=1e-4 * top)
    for weights in (None, [1.0, 3.0]):
        javg = jtrainer.make_average_step(weights)(ja)
        tavg = trainer.make_average_step(weights)(ta)
        for got, ref in _pairs(tavg, javg):
            np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=1e-6,
                                       atol=1e-7)
            assert torch.equal(got[0], got[1])


@bounded(180)
@pytest.mark.parametrize("weights", [None, [1.0, 2.0, 3.0, 4.0]])
def test_make_average_step_over_two_gloo_ranks_is_one_all_reduce(weights):
    """Four members of the reduced qwen3_8b (bf16 weights, f32 norms) over
    two gloo ranks, two each: the average step is exactly one all-reduce
    on each rank (``check_one_all_reduce``), both ranks hold the same
    average, and it equals the one-process step's — f32 leaves within
    rtol 1e-6 (the two ranks' partials associate the sum differently) and
    bf16 leaves within one bf16 ulp (rtol 2⁻⁷) for the same reason."""
    cfg = get_reduced_config("qwen3_8b")
    members = [trainer.init_train_state(
        cfg, optim.sgd(), torch.Generator().manual_seed(m), device="cpu")[0]
        for m in range(4)]
    stacked = tree_map(lambda *xs: torch.stack(xs), *members)
    want = trainer.make_average_step(weights)(stacked)
    out = mesh_launch.run_ranks(ranks.lm_average_step, 2, device="cpu",
                                args=(stacked, weights), timeout_s=150)
    for avg, counts_ok, detail in out:
        assert counts_ok, detail
        for g, w in zip(tree_leaves(avg), tree_leaves(want)):
            assert g.shape == w[:2].shape and g.dtype == w.dtype
            rtol = 2.0 ** -7 if g.dtype == torch.bfloat16 else 1e-6
            np.testing.assert_allclose(g.float().numpy(),
                                       w[:2].float().numpy(), rtol=rtol,
                                       atol=1e-7)
    assert _equal_trees(out[0][0], out[1][0])


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------

def test_launcher_trains_and_averages_on_cpu():
    """``tests/test_system.py``'s end-to-end assertions on the port's
    launcher: 2 members, IID token streams, an average every 10 steps;
    the loss falls and the averaged model is competitive with the
    members."""
    res = launch.main([
        "--arch", "qwen3_8b", "--reduced", "--steps", "30", "--members", "2",
        "--batch", "4", "--seq", "64", "--avg-period", "10", "--lr", "3e-3",
        "--log-every", "100", "--device", "cpu"])
    first = np.mean(res["history"][0])
    last = np.mean([np.mean(h) for h in res["history"][-3:]])
    assert last < first, (first, last)
    assert res["eval_averaged"] < min(res["eval_members"]) + 0.5
    assert res["sync_steps"] == [10, 20, 30] and len(res["step_s"]) == 30


def test_distributed_averaging_non_iid_still_trains():
    """``tests/test_system.py::test_distributed_averaging_non_iid_still_trains``
    on the port's launcher: minicpm's odd vocab, 2 members on disjoint
    data domains (``--non-iid``), 10 steps; the loss still falls."""
    res = launch.main([
        "--arch", "minicpm_2b", "--reduced", "--steps", "10", "--members",
        "2", "--batch", "2", "--seq", "64", "--non-iid",
        "--log-every", "100", "--device", "cpu"])
    assert np.mean(res["history"][-1]) < np.mean(res["history"][0])


def test_launcher_drift_policy_and_checkpoints(tmp_path):
    """``--sync-policy drift --drift-at``: the launcher averages exactly at
    the steps where a ``DriftDetector`` per member, fed the losses it
    recorded (negated), flags any member; and the final checkpoints carry
    the reference's names and metadata (``tests/test_system.py``'s round
    trip)."""
    from repro_torch.stream.drift import DriftDetector
    res = launch.main([
        "--arch", "qwen3_8b", "--reduced", "--steps", "10", "--members",
        "2", "--batch", "2", "--seq", "32", "--sync-policy", "drift",
        "--drift-at", "5", "--drift-warmup", "2", "--drift-threshold",
        "0.05", "--lr", "3e-3", "--ckpt-dir", str(tmp_path),
        "--log-every", "100", "--device", "cpu"])
    detectors = [DriftDetector(threshold=0.05, alpha=0.2, warmup=2)
                 for _ in range(2)]
    replayed = [step + 1 for step, losses in enumerate(res["history"])
                if any([d.update(-l) for d, l in zip(detectors, losses)])]
    assert res["sync_steps"] == replayed and replayed
    tree, meta = restore_checkpoint(str(tmp_path), "averaged", device="cpu")
    assert meta["step"] == 10 and "eval_loss" in meta["metadata"]
    assert tree["embed"].dtype == torch.bfloat16
    with pytest.raises(SystemExit, match="drift-at"):
        launch.main(["--resume", "--ckpt-dir", str(tmp_path),
                     "--drift-at", "2", "--device", "cpu"])


BASE = ["--arch", "qwen3_8b", "--reduced", "--members", "2", "--batch", "2",
        "--seq", "32", "--avg-period", "2", "--log-every", "100"]


def _equal_trees(a, b):
    la, lb = tree_leaves(a), tree_leaves(b)
    return len(la) == len(lb) and all(
        x.dtype == y.dtype and torch.equal(x, y) for x, y in zip(la, lb))


def test_launcher_resume_matches_uninterrupted(tmp_path):
    """``tests/test_fault_tolerance.py``'s launcher test on the port:
    killed after step 2 of 4 (``--ckpt-every 2``), resumed; the final
    averaged checkpoint equals the uninterrupted run's bitwise."""
    cpu = ["--device", "cpu"]
    d_full, d_cut = str(tmp_path / "full"), str(tmp_path / "cut")
    launch.main(BASE + cpu + ["--steps", "4", "--ckpt-dir", d_full])
    launch.main(BASE + cpu + ["--steps", "2", "--ckpt-dir", d_cut,
                              "--ckpt-every", "2"])
    launch.main(BASE + cpu + ["--steps", "4", "--ckpt-dir", d_cut,
                              "--resume"])
    full, _ = restore_checkpoint(d_full, "averaged", device="cpu")
    cut, _ = restore_checkpoint(d_cut, "averaged", device="cpu")
    assert _equal_trees(full, cut)


def test_reference_state_checkpoint_resumes_in_port(tmp_path):
    """The reference launcher writes ``state-<m>`` at step 2; the port's
    ``--resume`` restores it: resumed at the last step, the port's
    averaged and member checkpoints are the reference's bit for bit."""
    d = str(tmp_path)
    jlaunch.main(BASE + ["--steps", "2", "--ckpt-dir", d, "--ckpt-every",
                         "2"])
    ref = {name: jax.tree.map(np.asarray, jrestore(d, name, 2)[0])
           for name in ("averaged", "member-0", "member-1")}
    res = launch.main(BASE + ["--steps", "2", "--ckpt-dir", d, "--resume",
                              "--device", "cpu"])
    assert res["history"] == []
    for name, tree in ref.items():
        mine, _ = restore_checkpoint(d, name, device="cpu")
        for a, r in _pairs(mine, tree):
            assert a.dtype == r.dtype and torch.equal(a, r), name


def test_port_state_checkpoint_resumes_in_reference(tmp_path):
    """The other way round: the port writes ``state-<m>`` at step 2 and
    the reference's ``--resume`` restores it; resumed at the last step,
    its averaged checkpoint is the port's bit for bit, and its continuation
    to step 4 trains from it."""
    d = str(tmp_path)
    launch.main(BASE + ["--steps", "2", "--ckpt-dir", d, "--ckpt-every", "2",
                        "--device", "cpu"])
    mine, _ = restore_checkpoint(d, "averaged", device="cpu")
    res = jlaunch.main(BASE + ["--steps", "2", "--ckpt-dir", d, "--resume"])
    assert res["history"] == []
    for a, r in _pairs(mine, jrestore(d, "averaged", 2)[0]):
        assert a.dtype == r.dtype and torch.equal(a, r)
    res = jlaunch.main(BASE + ["--steps", "4", "--ckpt-dir", d, "--resume"])
    assert len(res["history"]) == 2
    assert all(np.isfinite(h).all() for h in res["history"])


def test_training_entry_points_default_to_the_card(monkeypatch):
    """Without a CUDA device the launcher and ``init_train_state``, called
    without a device, raise instead of quietly training on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        launch.main(["--arch", "qwen3_8b", "--reduced", "--steps", "1"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        trainer.init_train_state(get_reduced_config("qwen3_8b"), optim.sgd(),
                                 torch.Generator().manual_seed(0))
    params, state, step = trainer.init_train_state(
        get_reduced_config("qwen3_8b"), optim.adamw(),
        torch.Generator().manual_seed(0), device="cpu")
    assert step == 0 and set(state) == {"mu", "nu"}
    assert params["embed"].dtype == torch.bfloat16
    assert state["mu"]["embed"].dtype == torch.float32
