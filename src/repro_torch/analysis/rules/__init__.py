"""The pluggable lint-rule registry — the port's counterpart of
``repro.analysis.rules``.

A rule is a named check over one parsed module. The engine
(``repro_torch.analysis.lint``) hands every rule a module context — the
path, source, AST, and the set of CAPTURED function nodes (functions that
run under CUDA-graph capture, ``astutil.CapturedIndex``, where host-side
Python runs once at capture and never again at replay) — and collects
``(line, col, message)`` findings.

Register a rule with the ``@rule`` decorator::

    @rule("my-rule", "one-line summary of the contract it enforces")
    def my_rule(ctx):
        for node in ast.walk(ctx.tree):
            ...
            yield node.lineno, node.col_offset, "what went wrong"

``paths=`` scopes a rule to files whose repo-relative posix path matches
the given regex (e.g. the serve-only graph rule). Rules are discovered by
importing the modules in ``_RULE_MODULES`` on first use.
"""
from __future__ import annotations

import importlib
import re
from dataclasses import dataclass
from typing import Callable, Dict, Iterable, Optional

RULES: Dict[str, "Rule"] = {}

_RULE_MODULES = ("repro_torch.analysis.rules.torch_rules",)
_LOADED = False


@dataclass(frozen=True)
class Rule:
    """One registered lint rule: ``check(ctx)`` yields
    ``(line, col, message)`` tuples for every violation in the module."""
    name: str
    summary: str
    check: Callable
    paths: Optional[str] = None            # repo-relative path regex scope

    def applies_to(self, relpath: str) -> bool:
        if self.paths is None:
            return True
        return re.search(self.paths, relpath) is not None


def rule(name: str, summary: str, *, paths: Optional[str] = None):
    """Decorator: register ``fn`` as lint rule ``name``."""
    if not re.fullmatch(r"[a-z0-9][a-z0-9-]*", name):
        raise ValueError(f"rule names are kebab-case, got {name!r}")

    def wrap(fn):
        if name in RULES:
            raise ValueError(f"duplicate rule {name!r}")
        RULES[name] = Rule(name, summary, fn, paths=paths)
        return fn

    return wrap


def get_rules(names: Optional[Iterable[str]] = None) -> Dict[str, Rule]:
    """The registry (loading rule modules on first use); ``names``
    restricts to a subset and raises on unknown names."""
    global _LOADED
    if not _LOADED:
        _LOADED = True
        for mod in _RULE_MODULES:
            importlib.import_module(mod)
    if names is None:
        return dict(RULES)
    unknown = [n for n in names if n not in RULES]
    if unknown:
        raise KeyError(f"unknown rule(s) {unknown}; known: {sorted(RULES)}")
    return {n: RULES[n] for n in names}
