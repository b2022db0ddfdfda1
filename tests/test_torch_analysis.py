"""The port's static lint (``repro_torch.analysis``), case for case after
``tests/test_analysis.py``: every rule fires on its fixture and stays
clean on its clean twin, the captured-function index, the suppression
syntax (the port's own marker, not the reference's), the baseline's
fail-on-new split, the CLI, and the acceptance bar — the port lints clean
against its EMPTY checked-in baseline. Parity: the rules the two linters
share by name give the same findings and baseline keys on the same
sources.
"""
import ast
import json
import textwrap
from pathlib import Path

import pytest
import torch

from repro.analysis.lint import lint_paths as ref_lint_paths
from repro.analysis.lint import write_baseline as ref_write_baseline
from repro.analysis.rules import get_rules as ref_get_rules
from repro_torch.analysis import (DEFAULT_ROOTS, default_paths, get_rules,
                                  lint_file, lint_paths, load_baseline,
                                  write_baseline)
from repro_torch.analysis import rules as rules_mod
from repro_torch.analysis.__main__ import main as cli_main
from repro_torch.analysis.astutil import CapturedIndex
from repro_torch.analysis.lint import BASELINE_PATH
from repro_torch.analysis.rules.torch_rules import RUNTIME_ONLY

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parent.parent
MOD = "src/repro_torch/mod.py"


def _lint(tmp_path, src, rel=MOD):
    p = tmp_path / rel
    p.parent.mkdir(parents=True, exist_ok=True)
    p.write_text(textwrap.dedent(src))
    return lint_file(p, get_rules(), root=tmp_path)


def _rules_of(findings):
    return sorted({f.rule for f in findings})


# ---------------------------------------------------------------------------
# Every rule: a fixture it fires on (with its finding count) and a clean twin
# ---------------------------------------------------------------------------

FIXTURES = {
    "np-in-captured": ("""\
        import numpy as np
        import torch

        def helper(x):
            return np.square(x)        # captured through _inner

        class Scorer:
            def _scores(self, x):
                return self._inner(x) + np.abs(x)

            def _inner(self, x):
                return helper(x)

            def capture(self, g, x):
                with torch.cuda.graph(g):
                    self.out = self._scores(x)
        """, 2, """\
        import numpy as np
        import torch

        def host_prep(x):              # never captured: numpy is fine
            return np.square(x)

        class Scorer:
            def _scores(self, x):
                return torch.square(x) * np.float32(2.0)   # dtype ctor

            def capture(self, g, x):
                y = host_prep(x)
                with torch.cuda.graph(g):
                    self.out = self._scores(y)
        """),
    "host-sync-in-captured": ("""\
        import torch

        def step(x):
            if torch.any(x > 0):            # branch on a tensor
                x = x * float(x.sum())      # float() of a tensor
            n = x.item()                    # .item()
            torch.cuda.synchronize()
            return x.cpu(), n               # .cpu()

        def capture(g, x):
            with torch.cuda.graph(g):
                step(x)
                y = x.numpy()               # in the block itself
        """, 6, """\
        import torch

        def step(x, rows):
            B = int(x.shape[0])             # a host size: no sync
            if B < rows:
                x = torch.cat([x, x.new_zeros((rows - B,))])
            return x

        def capture(g, x):
            with torch.cuda.graph(g):
                out = step(x, 8)
            return out.cpu().numpy(), float(out.sum())   # after capture
        """),
    "host-rng-or-clock": ("""\
        import random
        import time
        import numpy as np
        import torch

        def body(x):
            t0 = time.perf_counter()
            return x + np.random.normal() + random.random()

        graphed = torch.cuda.make_graphed_callables(body, (torch.zeros(2),))
        """, 3, """\
        import time
        import numpy as np
        import torch

        def body(x):
            return x * 2.0

        def timed(g, x):
            t0 = time.perf_counter()
            g.replay()
            return time.perf_counter() - t0, np.random.normal()
        """),
    "sub-f32-accum": ("""\
        import torch
        from repro_torch.distributed import collectives

        def reduce_members(trees, acc, x):
            s = torch.sum(trees, dim=0, dtype=torch.bfloat16)
            acc = acc + x.to(torch.bfloat16)
            acc += x.bfloat16()
            t = torch.add(acc, x.half())
            collectives.all_reduce(x.to(dtype=torch.float16))
            return s, acc, t
        """, 5, """\
        import torch
        from repro_torch.distributed import collectives

        def reduce_members(trees, x):
            mean = torch.sum(trees.float(), dim=0) / len(trees)
            collectives.all_reduce(x.float())
            return mean.to(torch.bfloat16)   # cast AFTER is the contract
        """),
    "hardcoded-member-seed": ("""\
        import numpy as np
        import torch

        def bad(i):
            a = np.random.default_rng(1000 + i)
            b = torch.Generator().manual_seed(1000 + i)
            torch.manual_seed(i + 7)
            return a, b
        """, 3, """\
        import numpy as np
        import torch

        def good(plan, i):
            return (np.random.default_rng(plan.seed + i),
                    torch.Generator().manual_seed(plan.seed + i))
        """),
    "graph-outside-scorer": ("""\
        import torch

        def build(f, x):
            g = torch.cuda.CUDAGraph()
            with torch.cuda.graph(g):
                f(x)
            return g, torch.compile(f)
        """, 3, None),
    "unregistered-reduce-strategy": ("""\
        from repro_torch.core.runner import ReduceConfig

        cfg = ReduceConfig(strategy="median")
        """, 1, """\
        from repro_torch.core.runner import ReduceConfig

        cfg = ReduceConfig(strategy="shard_weighted")
        """),
    "no-tf32": ("""\
        import torch
        import triton.language as tl

        torch.backends.cuda.matmul.allow_tf32 = True
        torch.backends.cudnn.allow_tf32 = True
        torch.set_float32_matmul_precision("high")
        torch.backends.cuda.matmul.fp32_precision = "tf32"

        def kernel(a, b):
            return tl.dot(a, b)
        """, 5, """\
        import torch
        import triton.language as tl

        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        torch.set_float32_matmul_precision("highest")
        torch.backends.cuda.matmul.fp32_precision = "ieee"

        def kernel(a, b):
            return tl.dot(a, b, input_precision="ieee")
        """),
    "kernel-wrapper-grad": ("""\
        import torch
        from repro_torch import kernels

        def _launch(x):
            out = torch.empty_like(x)
            kernels.launch("rmsnorm", x.data_ptr(), out.data_ptr())
            return out

        def fast_op(x):             # no Function, no refusal
            return _launch(x)

        def late(x):                # refuses only after the launch
            out = _launch(x)
            kernels.refuse_grad("rmsnorm", (x,))
            return out
        """, 2, """\
        import torch
        from repro_torch import kernels

        def _launch(x):
            out = torch.empty_like(x)
            kernels.launch("rmsnorm", x.data_ptr(), out.data_ptr())
            return out

        class _Op(torch.autograd.Function):
            @staticmethod
            def forward(ctx, x):
                return _launch(x)

            @staticmethod
            def backward(ctx, dy):
                return _launch(dy)

        def op(x):
            if kernels.needs_grad((x,)):
                return _Op.apply(x)
            return _launch(x)

        def refused(x):
            kernels.refuse_grad("rmsnorm", (x,))
            return _launch(x)
        """),
    "collective-outside-module": ("""\
        import torch
        import torch.distributed as dist
        from torch.distributed import barrier

        def sync(t):
            dist.all_reduce(t)
            barrier()
            torch.distributed.broadcast(t, 0)
        """, 3, """\
        from repro_torch.distributed import collectives

        def sync(t, group):
            collectives.all_reduce(t, group)
            return collectives.all_gather(t, group)
        """),
    "entry-point-cpu-default": ("""\
        import torch

        def run(x, device="cpu"):
            return x

        def run2(x, *, device=torch.device("cpu")):
            return x

        pick = lambda device="cpu": device
        """, 3, """\
        import torch

        def run(x, device="cuda"):
            return x

        def run2(x, *, device=None):
            return torch.device("cpu") if device is None else device
        """),
}
# where a rule is scoped by path, its clean twin is the same source at a
# path it does not cover
CLEAN_PATHS = {"graph-outside-scorer": ["src/repro_torch/serve/engine.py",
                                        "src/repro_torch/core/other.py"],
               "collective-outside-module": [
                   "src/repro_torch/distributed/collectives.py"]}
FIRE_PATHS = {"graph-outside-scorer": "src/repro_torch/serve/other.py"}


def test_every_rule_has_a_firing_and_a_clean_fixture():
    assert set(FIXTURES) == set(get_rules())
    assert len(FIXTURES) == 11


@pytest.mark.parametrize("name", sorted(FIXTURES))
def test_rule_fires_on_its_fixture(tmp_path, name):
    src, n, _ = FIXTURES[name]
    found = _lint(tmp_path, src, FIRE_PATHS.get(name, MOD))
    assert _rules_of(found) == [name], "\n".join(map(str, found))
    assert len(found) == n, "\n".join(map(str, found))


@pytest.mark.parametrize("name", sorted(FIXTURES))
def test_rule_clean_on_its_twin(tmp_path, name):
    src, _, clean = FIXTURES[name]
    cases = [(clean, MOD)] if clean is not None else []
    cases += [(src, rel) for rel in CLEAN_PATHS.get(name, [])]
    assert cases
    for text, rel in cases:
        found = _lint(tmp_path, text, rel)
        assert name not in _rules_of(found), "\n".join(map(str, found))


def test_kernel_wrapper_grad_reports_the_unguarded_entry(tmp_path):
    """The finding sits where the guard is missing: at each public
    function's launching call, not in the shared launcher they reach."""
    found = _lint(tmp_path, FIXTURES["kernel-wrapper-grad"][0])
    assert [(f.line, f.col) for f in found] == [(10, 11), (13, 10)]
    assert "fast_op" in found[0].message and "late" in found[1].message


def test_kernel_wrapper_grad_follows_kernel_operators(tmp_path):
    """A launch inside a kernel operator's CUDA implementation
    (``kernels.register``) is reached by every call of the operator: the
    wrapper that calls it without a guard is the finding, the one that
    refuses first is not, and the implementation itself is not reported."""
    found = _lint(tmp_path, """\
        import torch
        from repro_torch import kernels

        def _cuda(x):
            out = torch.empty_like(x)
            kernels.launch("rmsnorm", x.data_ptr(), out.data_ptr())
            return out

        _OP = kernels.register("rmsnorm", "(Tensor x) -> Tensor", _cuda,
                               torch.empty_like, lambda x, **kw: 0)

        def fast_op(x):
            return _OP(x)

        def refused(x):
            kernels.refuse_grad("rmsnorm", (x,))
            return _OP(x)
        """)
    assert [(f.rule, f.line) for f in found] == [("kernel-wrapper-grad", 13)]
    assert "fast_op" in found[0].message


def test_no_tf32_flags_allow_tf32_keyword(tmp_path):
    found = _lint(tmp_path, """\
        import triton.language as tl

        def kernel(a, b):
            return tl.dot(a, b, allow_tf32=True, input_precision="ieee")
        """)
    assert [(f.rule, f.line) for f in found] == [("no-tf32", 4)]


# ---------------------------------------------------------------------------
# The captured-function index
# ---------------------------------------------------------------------------

def _captured_names(src):
    idx = CapturedIndex(ast.parse(textwrap.dedent(src)))
    return sorted(f.name for f in idx.captured_functions())


def test_captured_index_fixpoint_through_self_calls():
    """Seeded by the ``self.<method>`` call in a graph block, closed over
    ``self.`` calls (into a base class of the same module), bare-name
    calls and nested defs; a same-named method of another class and the
    uncaptured methods stay out."""
    names = _captured_names("""\
        import torch

        def helper(x):
            return x

        def unused(x):
            return x

        class Base:
            def _deep(self, x):
                def inner(y):
                    return y
                return inner(helper(x))

        class Scorer(Base):
            def _scores(self, x):
                return self._mid(x)

            def _mid(self, x):
                return self._deep(x)

            def warmup(self, x):
                return self._scores(x)

            def capture(self, g, x):
                with torch.cuda.graph(g):
                    out = self._scores(x)
                return out

        class Other:
            def _mid(self, x):
                return x
        """)
    assert names == ["_deep", "_mid", "_scores", "helper", "inner"]


def test_captured_index_make_graphed_callables():
    names = _captured_names("""\
        import torch

        def f(x):
            return g(x)

        def g(x):
            return x

        def h(x):
            return x

        class M:
            def step(self, x):
                return x

            def build(self, xs):
                return torch.cuda.make_graphed_callables((self.step, f), xs)
        """)
    assert names == ["f", "g", "step"]


def test_captured_index_finds_the_scorers_capture():
    """The tree's one capture: ``BucketedScorer._capture`` records
    ``self._scores``, which calls ``_readout``."""
    src = (ROOT / "src" / "repro_torch" / "serve" / "engine.py").read_text()
    idx = CapturedIndex(ast.parse(src))
    assert sorted(f.name for f in idx.captured) == ["_readout", "_scores"]


# ---------------------------------------------------------------------------
# The registry
# ---------------------------------------------------------------------------

def test_rule_names_kebab_case_and_unique():
    get_rules()
    with pytest.raises(ValueError, match="kebab-case"):
        rules_mod.rule("Bad_Name", "x")
    with pytest.raises(ValueError, match="duplicate"):
        rules_mod.rule("np-in-captured", "x")(lambda ctx: iter(()))
    with pytest.raises(KeyError, match="unknown rule"):
        get_rules(["no-such-rule"])
    assert set(get_rules(["no-tf32"])) == {"no-tf32"}


# ---------------------------------------------------------------------------
# Suppression syntax
# ---------------------------------------------------------------------------

CAPTURE = """
def capture(g, x):
    with torch.cuda.graph(g):
        f(x)
"""


def test_suppression_same_line_and_line_above(tmp_path):
    found = _lint(tmp_path, textwrap.dedent("""\
        import numpy as np
        import torch

        def f(x):
            a = np.square(x)  # repro_torch: allow(np-in-captured)  a table
            # a constant table  # repro_torch: allow(np-in-captured)
            b = np.square(x)
            return a + b
        """) + CAPTURE)
    assert found == []


def test_suppression_multi_rule_and_wrong_rule(tmp_path):
    found = _lint(tmp_path, textwrap.dedent("""\
        import numpy as np
        import torch

        def f(x):
            # repro_torch: allow(np-in-captured, host-rng-or-clock)  fixed
            a = x + np.random.normal() + np.square(2.0)
            b = np.square(x)    # repro_torch: allow(host-rng-or-clock)
            return a + b
        """) + CAPTURE)
    # the wrong-rule allow on line 7 suppresses NOTHING
    assert [(f.rule, f.line) for f in found] == [("np-in-captured", 7)]


def test_suppression_counted(tmp_path):
    p = tmp_path / "m.py"
    p.write_text("import numpy as np\nimport torch\n\n"
                 "def f(x):\n"
                 "    return np.square(x)  # repro_torch: allow("
                 "np-in-captured)  ok\n" + CAPTURE)
    report = lint_paths([p], root=tmp_path)
    assert report.findings == [] and report.suppressed == 1


def test_each_linter_keeps_its_own_suppressions(tmp_path):
    """The reference's ``# repro: allow(...)`` does not silence the port's
    linter, and the port's marker does not silence the reference's."""
    port = _lint(tmp_path, textwrap.dedent("""\
        import numpy as np
        import torch

        def f(x):
            return np.square(x)  # repro: allow(np-in-captured)
        """) + CAPTURE)
    assert _rules_of(port) == ["np-in-captured"]
    p = tmp_path / "ref.py"
    p.write_text("import jax\nimport numpy as np\n\n@jax.jit\n"
                 "def f(x):\n"
                 "    return np.square(x)  # repro_torch: allow(np-in-traced)"
                 "\n")
    ref = ref_lint_paths([p], root=tmp_path)
    assert [f.rule for f in ref.findings] == ["np-in-traced"]


# ---------------------------------------------------------------------------
# Baseline: fail-on-new split + drift
# ---------------------------------------------------------------------------

BAD_SRC = ("import numpy as np\nimport torch\n\n"
           "def f(x):\n    return np.square(x)\n" + CAPTURE)


def test_baseline_roundtrip_and_split(tmp_path):
    p = tmp_path / "legacy.py"
    p.write_text(BAD_SRC)
    first = lint_paths([p], root=tmp_path)
    assert len(first.findings) == 1
    bpath = tmp_path / "baseline.json"
    write_baseline(first.findings, bpath)
    again = lint_paths([p], root=tmp_path, baseline=load_baseline(bpath))
    assert again.findings == [] and len(again.baselined) == 1


def test_baseline_drift_new_finding_stays_new(tmp_path):
    p = tmp_path / "legacy.py"
    p.write_text(BAD_SRC)
    assert load_baseline(tmp_path / "missing.json") == {}
    write_baseline(lint_paths([p], root=tmp_path).findings,
                   tmp_path / "baseline.json")
    # the file grows a NEW violation on a different line
    p.write_text(BAD_SRC + "\n\ndef g(x):\n    with torch.cuda.graph(x):\n"
                 "        return np.abs(x)\n")
    drift = lint_paths([p], root=tmp_path,
                       baseline=load_baseline(tmp_path / "baseline.json"))
    assert len(drift.baselined) == 1       # the old one stays baselined
    assert len(drift.findings) == 1        # the drift is NEW -> gate fails
    assert drift.findings[0].line == 14


def test_baseline_unknown_version_rejected(tmp_path):
    b = tmp_path / "b.json"
    b.write_text(json.dumps({"version": 99, "findings": []}))
    with pytest.raises(ValueError, match="unknown baseline version"):
        load_baseline(b)


def test_port_lints_clean_against_its_checked_in_baseline(monkeypatch):
    """THE acceptance bar: ``python -m repro_torch.analysis`` over the
    default roots reports zero findings, and the checked-in baseline is
    EMPTY."""
    assert load_baseline(BASELINE_PATH) == {}
    monkeypatch.chdir(ROOT)
    paths = default_paths(ROOT)
    assert ROOT / "chip_smoke.py" in paths
    assert ROOT / "examples" / "quickstart_torch.py" in paths
    report = lint_paths(paths, root=ROOT)
    assert report.parse_errors == []
    assert report.findings == [], "\n".join(str(f) for f in report.findings)
    assert report.files_checked > 60       # it actually walked the tree
    assert cli_main(["--fail-on-new"]) == 0


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------

def test_cli_clean_exit_and_report(tmp_path, capsys):
    d = tmp_path / "pkg"
    d.mkdir()
    (d / "ok.py").write_text("import torch\n\n"
                             "def f(x):\n    return torch.square(x)\n")
    rep = tmp_path / "report.json"
    assert cli_main([str(d), "--fail-on-new", "--report", str(rep)]) == 0
    data = json.loads(rep.read_text())
    assert data["new"] == [] and data["files_checked"] == 1
    assert "clean" in capsys.readouterr().out


def test_cli_fail_on_new_and_write_baseline(tmp_path, capsys):
    d = tmp_path / "pkg"
    d.mkdir()
    (d / "bad.py").write_text(BAD_SRC)
    bpath = tmp_path / "b.json"
    assert cli_main([str(d), "--baseline", str(bpath),
                     "--fail-on-new"]) == 1
    # snapshot the debt, then the same tree gates green
    assert cli_main([str(d), "--baseline", str(bpath),
                     "--write-baseline"]) == 0
    assert cli_main([str(d), "--baseline", str(bpath),
                     "--fail-on-new"]) == 0
    # and --no-baseline sees it again
    assert cli_main([str(d), "--baseline", str(bpath), "--no-baseline",
                     "--fail-on-new"]) == 1
    out = capsys.readouterr().out
    assert "(baselined)" in out and "1 baselined" in out


@pytest.mark.parametrize("files", [{"broken.py": "def f(:\n"}, None])
def test_cli_exit_2_on_parse_error_or_missing_path(tmp_path, files):
    d = tmp_path / "pkg"
    if files is not None:
        d.mkdir()
        for name, text in files.items():
            (d / name).write_text(text)
    assert cli_main([str(d)]) == 2


def test_cli_list_rules(capsys):
    assert cli_main(["--list-rules"]) == 0
    out = capsys.readouterr().out
    for name in list(FIXTURES) + list(RUNTIME_ONLY):
        assert name in out
    assert "check_carry_released" in out      # missing-donate's run time
    assert cli_main(["--list-rules", "--rules", "no-tf32"]) == 0
    assert "np-in-captured" not in capsys.readouterr().out.split(
        "missing-donate")[0]


# ---------------------------------------------------------------------------
# Parity with the reference linter
# ---------------------------------------------------------------------------

PARITY_SRC = """\
import numpy as np
from repro_torch.core.runner import ReduceConfig


def member_rngs(k):
    return [np.random.default_rng(1000 + i) for i in range(k)]


def legacy(i):
    np.random.seed(i + 42)
    return np.random.default_rng(seed=7 + i)


a = ReduceConfig(strategy="median")
b = ReduceConfig(strategy="uniform", rounds=2)
c = dict(strategy="trimmed", other=np.random.RandomState(3 + 4))
"""
SHARED = ["hardcoded-member-seed", "unregistered-reduce-strategy"]


def test_shared_rules_match_the_reference_finding_for_finding(tmp_path):
    p = tmp_path / "src" / "mod.py"
    p.parent.mkdir(parents=True)
    p.write_text(PARITY_SRC)
    ref = ref_lint_paths([p], rules=ref_get_rules(SHARED), root=tmp_path)
    port = lint_paths([p], rules=get_rules(SHARED), root=tmp_path)
    got = [(f.rule, f.line, f.col) for f in port.findings]
    assert got == [(f.rule, f.line, f.col) for f in ref.findings]
    assert sorted({r for r, _, _ in got}) == SHARED and len(got) == 5
    ref_write_baseline(ref.findings, tmp_path / "ref.json")
    write_baseline(port.findings, tmp_path / "port.json")
    ref_keys = [f["key"] for f in json.loads(
        (tmp_path / "ref.json").read_text())["findings"]]
    port_keys = [f["key"] for f in json.loads(
        (tmp_path / "port.json").read_text())["findings"]]
    assert port_keys == ref_keys and port_keys[0].startswith("src/mod.py::")


def test_default_roots_are_the_ports():
    assert DEFAULT_ROOTS == ("src/repro_torch", "chip_smoke.py",
                             "examples/*_torch.py")


ANALYSIS_MODULES = ["repro_torch.analysis", "repro_torch.analysis.__main__",
                    "repro_torch.analysis.astutil",
                    "repro_torch.analysis.audit",
                    "repro_torch.analysis.lint",
                    "repro_torch.analysis.rules",
                    "repro_torch.analysis.rules.torch_rules"]


def test_package_walk_covers_the_analysis_modules():
    """``tests/test_torch_package.py`` imports every module
    ``pkgutil.walk_packages`` finds and holds them to loading neither JAX
    nor ``repro``: the walk finds every analysis module, the rule modules
    and ``__main__`` included, and importing them alone loads neither."""
    import os
    import pkgutil
    import subprocess
    import sys

    import repro_torch
    walked = {m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                                     "repro_torch.")}
    assert set(ANALYSIS_MODULES) <= walked
    code = ("import importlib, sys\n"
            f"for m in {ANALYSIS_MODULES!r}:\n"
            "    importlib.import_module(m)\n"
            "print(sorted(m for m in sys.modules\n"
            "             if m.split('.')[0] in ('jax', 'jaxlib', 'repro')))\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
