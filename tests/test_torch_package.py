"""The port stands alone: ``repro_torch`` imports neither JAX nor ``repro``
and runs on the card unless asked for the CPU."""
import glob
import os
import pkgutil
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

import repro_torch
from repro_torch.checkpoint.ckpt import restore_checkpoint
from repro_torch.configs import get_reduced_config
from repro_torch.core import e2lm, elm, executor
from repro_torch.core.runner import (AveragingRun, Ensemble, MapConfig,
                                     ReduceConfig)
from repro_torch.data.partition import Partition
from repro_torch.launch import serve
from repro_torch.models import api, cnn
from repro_torch.tree import tree_leaves

# the reference's threaded tests share the CPU with these workers
torch.set_num_threads(2)

ROOT = os.path.join(os.path.dirname(__file__), "..")
PKG = os.path.join(ROOT, "src", "repro_torch")
CFG = get_reduced_config("cnn_elm_6c12c")
LM = get_reduced_config("qwen3_8b")


def _modules():
    return sorted(m.name for m in pkgutil.walk_packages(
        repro_torch.__path__, "repro_torch."))


def test_every_module_imports_without_jax_or_repro():
    mods = _modules()
    assert "repro_torch.kernels.conv2d.ops" in mods
    assert "repro_torch.serve.engine" in mods
    assert "repro_torch.kernels.swa_attention.ops" in mods
    assert "repro_torch.launch.serve" in mods
    assert "repro_torch.optim.schedules" in mods
    for name in ("checkpoint.ckpt", "checkpoint.run_state", "core.e2lm",
                 "core.elm_head", "core.elastic", "core.faults",
                 "distributed.collectives", "distributed.sharding",
                 "launch.mesh", "launch.dryrun", "launch.cost_analysis",
                 "serve.scheduler", "serve.hot_reload", "serve.loadgen",
                 "stream", "stream.drift", "stream.sources", "stream.window",
                 "stream.run", "layers.mlp", "configs.olmoe_1b_7b",
                 "configs.qwen3_moe_235b_a22b", "configs.hubert_xlarge",
                 "configs.internvl2_26b", "configs.minicpm_2b",
                 "configs.internlm2_20b", "configs.qwen3_32b"):
        assert f"repro_torch.{name}" in mods
    # the mesh tests' rank module runs in processes of its own
    code = ("import importlib, sys\n"
            f"sys.path.insert(0, {os.path.join(ROOT, 'tests')!r})\n"
            f"for m in {mods + ['torch_mesh_ranks']!r}:\n"
            "    importlib.import_module(m)\n"
            "bad = sorted(m for m in sys.modules\n"
            "             if m.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
            "print(bad)\n")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_no_source_imports_jax_or_repro():
    pattern = re.compile(r"^\s*(import\s+(jax|jaxlib|repro)\b"
                         r"|from\s+(jax|jaxlib|repro)(\.|\s))", re.M)
    files = [os.path.join(ROOT, "chip_smoke.py"),
             os.path.join(ROOT, "tools", "kernel_variants.py"),
             os.path.join(ROOT, "tools", "sgd_sensitivity.py"),
             os.path.join(ROOT, "tools", "train_step_turns.py"),
             os.path.join(ROOT, "tests", "torch_mesh_ranks.py"),
             os.path.join(ROOT, "tests", "torch_mesh_overrides_ranks.py"),
             os.path.join(ROOT, "scripts", "hillclimb_torch.py")]
    files += glob.glob(os.path.join(ROOT, "examples", "*_torch.py"))
    for dirpath, _, names in os.walk(PKG):
        files += [os.path.join(dirpath, n) for n in names
                  if n.endswith(".py")]
    assert len(files) > 20
    offenders = [f for f in files if pattern.search(open(f).read())]
    assert offenders == []


def test_kernel_variants_patch_the_shipped_sources():
    """Every variant of tools/kernel_variants.py applies to the kernel
    source as it stands: each of its edits matches exactly once."""
    sys.path.insert(0, os.path.join(ROOT, "tools"))
    try:
        import kernel_variants
    finally:
        sys.path.remove(os.path.join(ROOT, "tools"))
    for name, variants in kernel_variants.VARIANTS.items():
        built = kernel_variants.variants_of(name, None)
        assert [tag for tag, _ in built] == [tag for tag, _ in variants]
        shipped = dict(built)["shipped"]
        for tag, text in built:
            assert (text == shipped) == (tag == "shipped"), (name, tag)


def test_kernel_variants_call_the_entries_as_the_operators_do():
    """tools/kernel_variants.py binds each C entry point with the same
    function name and argument types as ``repro_torch.kernels``."""
    sys.path.insert(0, os.path.join(ROOT, "tools"))
    try:
        import kernel_variants
    finally:
        sys.path.remove(os.path.join(ROOT, "tools"))
    from repro_torch import kernels
    for name, (_files, fn_name, argtypes) in kernel_variants.ENTRIES.items():
        assert kernels._ENTRIES[name][0] == fn_name, name
        assert tuple(kernels._ENTRIES[name][1]) == tuple(argtypes), name


def test_tf32_is_off():
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False


def test_entry_points_default_to_the_card(monkeypatch):
    """Without a CUDA device, an entry point called without device= raises
    instead of quietly running on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    gen = torch.Generator().manual_seed(0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cnn.init_params(CFG, gen)
    params = cnn.init_params(CFG, gen, device="cpu")
    x = np.zeros((80, 28, 28), np.float32)
    parts = [Partition(x, np.zeros(80, np.int32))]
    with pytest.raises(RuntimeError, match="device='cpu'"):
        AveragingRun(CFG, MapConfig(batch_size=40)).run(parts,
                                                        init_params=params)
    res = AveragingRun(CFG, MapConfig(batch_size=40)).run(
        parts, init_params=params, device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Ensemble(CFG, res.stacked)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        from repro_torch.serve import BucketedScorer
        BucketedScorer(CFG, res.stacked)
    with pytest.raises(ValueError):
        repro_torch.resolve_device("meta")
    # the Map's zero statistics
    with pytest.raises(RuntimeError, match="device='cpu'"):
        elm.zero_stats(6, 3)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        elm.zero_stats_stacked(4, 6, 3)
    assert elm.zero_stats(6, 3, device="cpu").u.device.type == "cpu"
    # E²LM's streaming state and the checkpoint restores
    with pytest.raises(RuntimeError, match="device='cpu'"):
        e2lm.oselm_init(6, 3, 1.0)
    assert e2lm.oselm_init(6, 3, 1.0, device="cpu").p.device.type == "cpu"
    with pytest.raises(RuntimeError, match="device='cpu'"):
        restore_checkpoint("no-such-dir", "round")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        AveragingRun(CFG, MapConfig(batch_size=40)).resume(parts,
                                                           "no-such-dir")
    assert elm.zero_stats_stacked(4, 6, 3, device="cpu").n.shape == (4,)
    # the LM serving path
    with pytest.raises(RuntimeError, match="device='cpu'"):
        api.init_params(LM, gen)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        api.init_cache(LM, 1, 8)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve.main(["--reduced", "--prompt-len", "4", "--gen", "2"])
    # the ensemble endpoint and the streaming Map
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve.main(["--ensemble", "--reduced"])
    from repro_torch.stream import StreamingRun
    with pytest.raises(RuntimeError, match="device='cpu'"):
        StreamingRun(CFG, MapConfig(batch_size=40)).run(
            [[parts[0]]], init_params=params)
    lm = api.init_params(LM, gen, device="cpu")
    assert lm["embed"].device.type == "cpu"


def test_mesh_launchers_default_to_the_card(monkeypatch):
    """``process_group`` and ``run_ranks`` default to the card like every
    other entry point: without one they raise at once, naming
    ``device='cpu'``, before any group is made or rank spawned."""
    from repro_torch.launch import mesh
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        with mesh.process_group():
            pass
    with pytest.raises(RuntimeError, match="device='cpu'"):
        mesh.run_ranks(print, 1)
    with pytest.raises(ValueError, match="device must be"):
        mesh.run_ranks(print, 1, device="meta")


@pytest.mark.parametrize("backend", ["sequential", "stacked"])
def test_executors_run_on_the_plan_device(monkeypatch, backend):
    """An executor called directly runs on ``plan.device``, which defaults
    to the card: without one it raises with the ``device='cpu'`` hint, and
    a CPU plan gives the β of the runner's CPU run."""
    x = np.random.default_rng(0).random((160, 28, 28), dtype=np.float32)
    parts = [Partition(x[:80], np.arange(80) % 10),
             Partition(x[80:], np.arange(80) % 10)]
    params = cnn.init_params(CFG, torch.Generator().manual_seed(0),
                             device="cpu")
    ex = executor.make_executor(backend)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ex.execute(CFG, params, parts, executor.ExecutionPlan(batch_size=40))
    got = ex.execute(CFG, params, parts, executor.ExecutionPlan(
        batch_size=40, device=torch.device("cpu")))
    want = AveragingRun(CFG, MapConfig(batch_size=40, backend=backend)).run(
        parts, init_params=params, device="cpu")
    assert got.stacked.beta.device.type == "cpu"
    assert torch.equal(got.stacked.beta, want.stacked.beta)


@pytest.mark.parametrize("arch", ["rwkv6_3b", "zamba2_1p2b"])
def test_recurrent_entry_points_default_to_the_card(monkeypatch, arch):
    """The recurrent families' entry points and the examples that drive
    them default to the card: without one they raise, naming
    ``device='cpu'``, and with it they run."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_reduced_config(arch)
    gen = torch.Generator().manual_seed(0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        api.init_params(cfg, gen)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        api.init_cache(cfg, 1, 8)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve.main(["--arch", arch, "--reduced", "--prompt-len", "8",
                    "--gen", "2"])
    sys.path.insert(0, os.path.join(ROOT, "examples"))
    try:
        import elm_head_backbone_torch
        import serve_batched_torch
    finally:
        sys.path.remove(os.path.join(ROOT, "examples"))
    for example in (serve_batched_torch, elm_head_backbone_torch):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            example.main([])
    params = api.init_params(cfg, gen, device="cpu")
    cache = api.init_cache(cfg, 1, 8, device="cpu")
    assert {a.device.type for a in tree_leaves((params, cache))} == {"cpu"}


def test_unknown_backend_and_strategy_are_value_errors():
    with pytest.raises(ValueError):
        MapConfig(backend="tpu")
    with pytest.raises(ValueError):
        ReduceConfig(strategy="median")
    with pytest.raises(ValueError, match="ElasticSchedule"):
        ReduceConfig(elastic=object())
    with pytest.raises(ValueError):
        executor.make_executor("tpu")
