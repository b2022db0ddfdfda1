"""The recurrent families' training, ELM-head and serving paths in the
port against the reference, and the swa_attention backward's non-causal
mode: ``loss_fn`` and every leaf's gradient of RWKV6 and Zamba2, the ELM
head over their hidden states, ``launch.serve`` and ``launch.train`` on
both, and the plain non-causal attention under autograd against
``jax.vjp`` of the reference's bidirectional attention. The inputs, the
reference's init and the tolerance rules are ``tests/test_torch_recurrent.py``'s
(its module docstring), whose helpers this module shares.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_reduced_config as jget_reduced
from repro.core import elm_head as jhead
from repro.launch import serve as jserve
from repro.layers import attention as jattn
from repro.models import api as japi
from repro_torch import convert
from repro_torch.configs import get_reduced_config
from repro_torch.core import elm_head
from repro_torch.launch import serve
from repro_torch.launch import train as launch
from repro_torch.layers import attention
from repro_torch.models import api
from repro_torch.tree import tree_leaves
from test_torch_recurrent import (ARCHS, KEY, _batches, _model, _np,
                                  _nudged, _tokens)

# the reference's threaded tests share the CPU with these workers
torch.set_num_threads(2)


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_leaf_gradients_match_reference(arch):
    """``loss_fn`` and the gradient of every leaf, f32, against
    ``jax.value_and_grad`` of the reference's, each leaf within 1e-4 ·
    max|its gradient|, or (RWKV6, module docstring) within twice the
    reference's distance from its one-ulp twin's gradient."""
    jcfg, cfg, jp, tp = _model(arch, "f32")
    rng = np.random.default_rng(12)
    toks = _tokens(cfg, 12, S=17)
    tgt = rng.integers(0, cfg.vocab_size, toks.shape).astype(np.int32)
    jb, tb = _batches(toks, tgt)

    def jloss(p):
        return japi.loss_fn(jcfg, p, jb)[0]

    jl, jg = jax.value_and_grad(jloss)(jp)
    twin_g = jax.grad(jloss)(_nudged(jp)) if arch == "rwkv6_3b" else None
    leaves = [a.requires_grad_(True) for a in tree_leaves(tp)]
    loss, metrics = api.loss_fn(cfg, tp, tb)
    grads = torch.autograd.grad(loss, leaves)
    np.testing.assert_allclose(float(loss), float(jl), rtol=1e-4)
    assert float(metrics["aux"]) == 0.0
    twins = (jax.tree.leaves(twin_g) if twin_g is not None
             else [None] * len(grads))
    for g, r, tw in zip(grads, jax.tree.leaves(jg), twins):
        g, r = g.numpy(), np.asarray(r)
        top = float(np.abs(r).max())
        err = float(np.abs(g - r).max())
        if err <= 1e-4 * top:
            continue
        assert tw is not None, (err, top)
        assert err <= 2 * float(np.abs(np.asarray(tw) - r).max()), (err, top)


# ---------------------------------------------------------------------------
# the ELM head, the serving launcher and the training launcher
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_elm_head_over_hidden_states_matches_reference(arch):
    """``accumulate_stats`` over ``hidden_states`` (f32, two batches of
    4 × 40 tokens: more rows than the 128 features; U and V within 1e-4 ·
    max, or RWKV6 by the one-ulp twin rule), the solve against the
    reference's ``elm_head``; then one ``finetune_step`` on a third batch,
    whose loss is the reference's."""
    jcfg, cfg, jp, tp = _model(arch, "f32")
    C = 6

    def batch(seed):
        toks = _tokens(cfg, 20 + seed, B=4, S=40)
        y = np.random.default_rng(seed).integers(0, C, toks.shape)
        return ({"tokens": jnp.asarray(toks), "targets": jnp.asarray(y)},
                {"tokens": torch.from_numpy(toks).long(),
                 "targets": torch.from_numpy(y)})

    def jfeat(p, b):
        return japi.hidden_states(jcfg, p, b)

    def tfeat(p, b):
        return api.hidden_states(cfg, p, b)

    (jb0, tb0), (jb1, tb1) = batch(0), batch(1)
    js = jhead.accumulate_stats(jfeat, jp, jb1, C,
                                jhead.accumulate_stats(jfeat, jp, jb0, C))
    ts = elm_head.accumulate_stats(tfeat, tp, tb1, C,
                                   elm_head.accumulate_stats(tfeat, tp, tb0,
                                                             C))
    twin = None
    for i, (got, want) in enumerate(((ts.u, js.u), (ts.v, js.v))):
        got, want = _np(got), _np(want)
        err, top = float(np.abs(got - want).max()), float(np.abs(want).max())
        if err <= 1e-4 * top:
            continue
        # RWKV6's f32 states move with its bf16 group-norm roundings: the
        # one-ulp twin rule (``tests/test_torch_recurrent.py``'s docstring)
        if twin is None:
            jn = _nudged(jp)
            twin = jhead.accumulate_stats(
                jfeat, jn, jb1, C, jhead.accumulate_stats(jfeat, jn, jb0, C))
        assert err <= 2 * float(np.abs(_np(twin[i]) - want).max()), (err,
                                                                     top)
    # β within 1e-3 · max|β| or twice the reference's f32 distance from
    # the f64 solve of its own statistics (``tests/test_torch_elm_head.py``)
    jbeta, tbeta = jhead.solve(js, 10.0), elm_head.solve(ts, 10.0)
    u, v = (np.asarray(a, np.float64) for a in (js.u, js.v))
    exact = np.linalg.solve(u + np.eye(len(u)) / 10.0, v)
    ref = _np(jbeta)
    bar = max(1e-3 * np.abs(ref).max(), 2 * np.abs(ref - exact).max())
    assert np.abs(_np(tbeta) - ref).max() <= bar
    jb2, tb2 = batch(2)
    _, jloss = jhead.finetune_step(jfeat, jp, jbeta, jb2, C, lr=1e-3)
    _, tloss = elm_head.finetune_step(
        tfeat, tp, torch.from_numpy(np.asarray(jbeta)), tb2, C, lr=1e-3)
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-4)


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_launcher_decodes(arch):
    """``tests/test_system.py::test_serve_launcher_decodes`` on the port's
    launcher for both families (batch 2, prompt 32, 8 tokens: the chunk
    shrinks to 8 for Zamba2's 32), decoding from the prefill's state
    with no replay; and the reference's launcher on the same arguments."""
    argv = ["--arch", arch, "--reduced", "--batch", "2", "--prompt-len",
            "32", "--gen", "8"]
    out = serve.main(argv + ["--device", "cpu"])
    assert out["tokens_per_s"] > 0 and out["logits_finite"]
    assert out["tokens"].shape == (2, 8)
    assert ((out["tokens"] >= 0) & (out["tokens"] < out["vocab_size"])).all()
    assert out["prefill_replay_gap"] is None
    assert jserve.main(argv)["tokens_per_s"] > 0


def test_serve_launcher_shrinks_the_chunk_to_the_prompt(monkeypatch):
    """A chunk longer than the prompt runs at max(8, prompt // 4), as the
    reference's launcher shrinks it (Zamba2's 32 against a 20-token
    prompt: 8)."""
    seen = []
    real = api.prefill

    def spy(cfg, params, batch, max_len=None):
        seen.append(cfg.ssm_chunk)
        return real(cfg, params, batch, max_len)

    monkeypatch.setattr(api, "prefill", spy)
    serve.main(["--arch", "zamba2_1p2b", "--reduced", "--batch", "1",
                "--prompt-len", "20", "--gen", "2", "--device", "cpu"])
    assert seen == [8]


@pytest.mark.parametrize("arch", ARCHS)
def test_training_launcher_runs_both_families(arch):
    """``launch.train`` on the reduced configs (2 members, 6 steps, an
    average every 3, seq 32: Zamba2's chunk shrinks to 8): finite losses,
    two syncs, and an averaged model scored."""
    res = launch.main(["--arch", arch, "--reduced", "--steps", "6",
                       "--members", "2", "--batch", "2", "--seq", "32",
                       "--avg-period", "3", "--lr", "3e-3",
                       "--log-every", "100", "--device", "cpu"])
    assert res["sync_steps"] == [3, 6]
    assert all(np.isfinite(h).all() for h in res["history"])
    assert np.isfinite(res["eval_averaged"])


# ---------------------------------------------------------------------------
# the swa_attention backward's non-causal mode (Part of the encoder's
# training path)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("S", [24, 37])
def test_non_causal_attention_grad_matches_jax_vjp(S):
    """HuBERT's bidirectional attention in f32: autograd of the port's
    plain non-causal route (``attn_forward_bidirectional`` through
    ``swa_attention(causal=False)``'s plain version, what the card's
    non-causal backward kernel is held against) against ``jax.vjp`` of the
    reference's ``attn_forward_bidirectional`` (its ``_sdpa`` under an
    all-ones mask): the output and the gradients of x and every attention
    weight within 1e-4 · max|ref|."""
    jcfg, cfg = jget_reduced("hubert_xlarge"), get_reduced_config(
        "hubert_xlarge")
    jp = jax.tree.map(lambda a: a[0], japi.init_params(
        jcfg, KEY, jnp.float32)["layers"]["attn"])
    tp = convert.lm_tree_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    rng = np.random.default_rng(S)
    x = rng.normal(size=(2, S, cfg.d_model)).astype(np.float32)
    dy = rng.normal(size=(2, S, cfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(S), (2, S))
    (jy, jkv), vjp = jax.vjp(
        lambda p, a: jattn.attn_forward_bidirectional(jcfg, p, a,
                                                      jnp.asarray(pos)),
        jp, jnp.asarray(x))
    jgp, jgx = vjp((jnp.asarray(dy), jax.tree.map(jnp.zeros_like, jkv)))
    leaves = {k: v.requires_grad_(True) for k, v in tp.items()}
    tx = torch.from_numpy(x).requires_grad_(True)
    ty, _ = attention.attn_forward_bidirectional(cfg, leaves, tx,
                                                 torch.from_numpy(pos))
    names = sorted(leaves)
    grads = torch.autograd.grad(ty, [leaves[k] for k in names] + [tx],
                                torch.from_numpy(dy))
    for got, want in [(ty, jy)] + [(g, jgp[k]) for g, k in
                                   zip(grads, names)] + [(grads[-1], jgx)]:
        want = np.asarray(want)
        np.testing.assert_allclose(_np(got), want, rtol=1e-4,
                                   atol=1e-4 * float(np.abs(want).max()))


@pytest.mark.parametrize("name", ["serve_batched_torch",
                                  "elm_head_backbone_torch"])
def test_examples_run_on_cpu(name):
    """The two examples at their reduced sizes on the CPU: both recurrent
    families served (tokens in the vocab), and HuBERT's closed-form head
    then five fine-tune steps of finite loss."""
    import importlib
    import os
    import sys
    root = os.path.join(os.path.dirname(__file__), "..", "examples")
    sys.path.insert(0, root)
    try:
        example = importlib.import_module(name)
    finally:
        sys.path.remove(root)
    out = example.main(["--device", "cpu"])
    if name == "serve_batched_torch":
        for res in out.values():
            assert res["tokens_per_s"] > 0 and res["logits_finite"]
            assert (res["tokens"] < res["vocab_size"]).all()
    else:
        assert len(out["losses"]) == 5 and np.isfinite(out["losses"]).all()
        assert 0.0 <= out["acc_after"] <= 1.0
