"""The port stands alone: ``repro_torch`` imports neither JAX nor ``repro``,
runs on the card unless asked for the CPU, and refuses what later slices
of the port will bring instead of doing it wrongly."""
import os
import pkgutil
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

import repro_torch
from repro_torch.configs import get_reduced_config, replace
from repro_torch.core import cnn_elm, executor
from repro_torch.core.runner import (AveragingRun, Ensemble, MapConfig,
                                     ReduceConfig)
from repro_torch.data.partition import Partition
from repro_torch.core import trainer
from repro_torch.launch import serve
from repro_torch.models import api, cnn

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
    code = ("import importlib, sys\n"
            f"for m in {mods!r}:\n"
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
             os.path.join(ROOT, "tools", "kernel_variants.py")]
    for dirpath, _, names in os.walk(PKG):
        files += [os.path.join(dirpath, n) for n in names
                  if n.endswith(".py")]
    assert len(files) > 20
    offenders = [f for f in files if pattern.search(open(f).read())]
    assert offenders == []


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
    # the LM serving path
    with pytest.raises(RuntimeError, match="device='cpu'"):
        api.init_params(LM, gen)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        api.init_cache(LM, 1, 8)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve.main(["--reduced", "--prompt-len", "4", "--gen", "2"])
    lm = api.init_params(LM, gen, device="cpu")
    assert lm["embed"].device.type == "cpu"


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


@pytest.mark.parametrize("make", [
    lambda: MapConfig(epochs=1),
    lambda: MapConfig(backend="mesh"),
    lambda: ReduceConfig(strategy="gossip"),
    lambda: ReduceConfig(rounds=2),
    lambda: executor.make_executor("mesh"),
    lambda: cnn_elm.train_member(CFG, None, None, epochs=2, batch_size=8),
    lambda: api.module_of(replace(LM, family="moe")),
    lambda: api.module_of(replace(LM, family="ssm_rwkv6")),
    lambda: api.init_params(replace(LM, family="encoder",
                                    is_encoder_only=True), None),
    lambda: trainer.make_prefill_step(replace(LM, is_encoder_only=True))(
        None, {"tokens": torch.zeros((1, 4), dtype=torch.int64)}),
    lambda: serve.main(["--ensemble"]),
])
def test_later_slices_raise_not_implemented(make):
    with pytest.raises(NotImplementedError):
        make()


def test_boosted_raises_not_implemented():
    from repro_torch.core.reduce_strategies import Boosted
    with pytest.raises(NotImplementedError, match="later slice"):
        ReduceConfig(strategy=Boosted())


def test_unknown_backend_and_strategy_are_value_errors():
    with pytest.raises(ValueError):
        MapConfig(backend="tpu")
    with pytest.raises(ValueError):
        ReduceConfig(strategy="median")
    with pytest.raises(ValueError):
        executor.make_executor("tpu")
