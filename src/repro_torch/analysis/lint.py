"""The lint engine — the port's counterpart of ``repro.analysis.lint``:
walk Python sources, run the rule registry over each module's AST and
captured-function index, apply inline suppressions and the checked-in
baseline, and report.

Suppression syntax: a finding on line L is suppressed by
``# repro_torch: allow(rule-name)`` — trailing on line L itself, or alone
on the comment line directly above. Multiple rules:
``# repro_torch: allow(rule-a, rule-b)``. Every suppression must carry a
one-line reason in the same comment (reviewed by eye, not by the tool).
The reference's ``# repro: allow(...)`` marker does not suppress a
finding of this linter, and this linter's marker does not suppress one
of the reference's: each linter's suppressions stay its own.

Baseline (``repro_torch/analysis/baseline.json``): known findings keyed by
``path::rule::line``. ``--fail-on-new`` fails only on findings NOT in the
baseline. The port's own baseline is EMPTY, and
``tests/test_torch_analysis.py`` holds it so.
"""
from __future__ import annotations

import ast
import json
import os
import re
from dataclasses import asdict, dataclass, field
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Sequence, Set

from repro_torch.analysis.astutil import CapturedIndex
from repro_torch.analysis.rules import Rule, get_rules

# the port's package, its smoke script and its examples; an entry with a
# glob pattern is expanded under the root (``default_paths``)
DEFAULT_ROOTS = ("src/repro_torch", "chip_smoke.py", "examples/*_torch.py")
BASELINE_PATH = Path(__file__).with_name("baseline.json")
_ALLOW_RE = re.compile(r"#\s*repro_torch:\s*allow\(([a-zA-Z0-9_\-, ]+)\)")
_SKIP_DIRS = {"__pycache__", ".git", ".venv", "node_modules"}


@dataclass(frozen=True)
class Finding:
    """One rule violation at a source location."""
    path: str            # repo-relative posix path
    line: int
    col: int
    rule: str
    message: str

    @property
    def key(self) -> str:
        return f"{self.path}::{self.rule}::{self.line}"

    def __str__(self):
        return f"{self.path}:{self.line}:{self.col}: [{self.rule}] " \
               f"{self.message}"


@dataclass
class LintReport:
    """Everything one lint run produced, pre- and post-baseline."""
    findings: List[Finding] = field(default_factory=list)
    suppressed: int = 0
    baselined: List[Finding] = field(default_factory=list)
    files_checked: int = 0
    parse_errors: List[str] = field(default_factory=list)

    def as_dict(self) -> dict:
        return {
            "files_checked": self.files_checked,
            "suppressed": self.suppressed,
            "parse_errors": self.parse_errors,
            "new": [asdict(f) for f in self.findings],
            "baselined": [asdict(f) for f in self.baselined],
        }


@dataclass
class _ModuleContext:
    """What every rule sees for one file."""
    path: str                       # repo-relative posix
    source: str
    lines: List[str]
    tree: ast.Module
    captured: CapturedIndex


def default_paths(root: Optional[Path] = None) -> List[Path]:
    """``DEFAULT_ROOTS`` under ``root`` (default: the working directory),
    glob entries expanded."""
    base = Path.cwd() if root is None else Path(root)
    out: List[Path] = []
    for entry in DEFAULT_ROOTS:
        if any(c in entry for c in "*?["):
            out += sorted(base.glob(entry))
        else:
            out.append(base / entry)
    return out


def _suppressions(lines: Sequence[str]) -> Dict[int, Set[str]]:
    """line number (1-based) -> rule names allowed on that line."""
    out: Dict[int, Set[str]] = {}
    for i, text in enumerate(lines, start=1):
        m = _ALLOW_RE.search(text)
        if m:
            out[i] = {r.strip() for r in m.group(1).split(",") if r.strip()}
    return out


def _is_suppressed(f: Finding, allows: Dict[int, Set[str]],
                   lines: Sequence[str]) -> bool:
    if f.rule in allows.get(f.line, ()):
        return True
    # a pure-comment line directly above the finding
    prev = f.line - 1
    if f.rule in allows.get(prev, ()) and prev >= 1 and \
            lines[prev - 1].lstrip().startswith("#"):
        return True
    return False


def lint_file(path: Path, rules: Dict[str, Rule], *,
              root: Optional[Path] = None) -> List[Finding]:
    """All non-suppressed findings in one file. ``root`` anchors the
    repo-relative path used in reports and baseline keys."""
    findings, _ = _lint_file_counted(path, rules, root=root)
    return findings


def _lint_file_counted(path: Path, rules: Dict[str, Rule], *,
                       root: Optional[Path] = None):
    rel = _relpath(path, root)
    source = path.read_text(encoding="utf-8")
    tree = ast.parse(source, filename=str(path))
    lines = source.splitlines()
    ctx = _ModuleContext(rel, source, lines, tree, CapturedIndex(tree))
    allows = _suppressions(lines)
    out: List[Finding] = []
    suppressed = 0
    for r in rules.values():
        if not r.applies_to(rel):
            continue
        for line, col, message in r.check(ctx):
            f = Finding(rel, line, col, r.name, message)
            if _is_suppressed(f, allows, lines):
                suppressed += 1
            else:
                out.append(f)
    out.sort(key=lambda f: (f.path, f.line, f.col, f.rule))
    return out, suppressed


def _relpath(path: Path, root: Optional[Path]) -> str:
    p = path.resolve()
    base = (root or Path.cwd()).resolve()
    try:
        return p.relative_to(base).as_posix()
    except ValueError:
        return path.as_posix()


def iter_python_files(paths: Iterable[Path]):
    for p in paths:
        p = Path(p)
        if p.is_file() and p.suffix == ".py":
            yield p
        elif p.is_dir():
            for dirpath, dirnames, filenames in os.walk(p):
                dirnames[:] = sorted(d for d in dirnames
                                     if d not in _SKIP_DIRS)
                for fn in sorted(filenames):
                    if fn.endswith(".py"):
                        yield Path(dirpath) / fn


def lint_paths(paths: Sequence[Path], *,
               rules: Optional[Dict[str, Rule]] = None,
               baseline: Optional[Dict[str, dict]] = None,
               root: Optional[Path] = None) -> LintReport:
    """Lint every .py under ``paths``; findings whose key is in
    ``baseline`` land in ``report.baselined`` instead of
    ``report.findings`` (the fail-on-new split)."""
    rules = rules if rules is not None else get_rules()
    baseline = baseline or {}
    report = LintReport()
    for f in iter_python_files(paths):
        report.files_checked += 1
        try:
            found, suppressed = _lint_file_counted(f, rules, root=root)
        except SyntaxError as e:
            report.parse_errors.append(f"{f}: {e}")
            continue
        report.suppressed += suppressed
        for fd in found:
            (report.baselined if fd.key in baseline
             else report.findings).append(fd)
    return report


# ---------------------------------------------------------------------------
# Baseline IO
# ---------------------------------------------------------------------------

def load_baseline(path: Path = BASELINE_PATH) -> Dict[str, dict]:
    """key -> finding dict. Missing file = empty baseline."""
    if not Path(path).exists():
        return {}
    data = json.loads(Path(path).read_text())
    if data.get("version") != 1:
        raise ValueError(f"unknown baseline version in {path}: "
                         f"{data.get('version')!r}")
    return {f["key"]: f for f in data.get("findings", [])}


def write_baseline(findings: Sequence[Finding],
                   path: Path = BASELINE_PATH) -> None:
    data = {
        "version": 1,
        "comment": "known lint findings of the port; new code must not add "
                   "to this file - fix or suppress inline with a reason "
                   "(# repro_torch: allow(rule)  <reason>)",
        "findings": [{"key": f.key, **asdict(f)} for f in
                     sorted(findings, key=lambda f: f.key)],
    }
    Path(path).write_text(json.dumps(data, indent=1) + "\n")
