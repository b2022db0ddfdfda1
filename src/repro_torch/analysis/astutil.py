"""Shared AST helpers for the port's lint layer: dotted-name resolution,
the sub-f32 dtype and cast tests, and the captured-function index (which
functions in a module run under CUDA-graph capture).

A captured CUDA graph records the device work its Python issued once;
a replay runs that work again and none of the Python. Host-side code in
a captured function therefore either breaks the capture (a device sync,
a copy to the host) or freezes one value into every replay (a clock, a
host RNG draw, a numpy result). The index is the counterpart of the
reference's traced-function index (``repro.analysis.astutil``), and as
there it is *syntactic*: no import is executed. A function counts as
captured when it is:

1. called inside a ``with torch.cuda.graph(...)`` block — by bare name
   (a module-level function) or as ``self.<method>`` (a method of the
   class around the block, or of one of its bases defined in the same
   module);
2. passed to ``torch.cuda.make_graphed_callables`` (by name, as
   ``self.<method>``, or in a tuple or list of those);
3. defined INSIDE a captured function; or
4. called by bare name or as ``self.<method>`` from another captured
   function in the same module (a fixpoint — the "code path" closure).

The statements of a ``torch.cuda.graph`` block count as captured too.
Cross-module calls are not followed.
"""
from __future__ import annotations

import ast
from typing import Dict, List, Optional, Set

GRAPH_CONTEXTS = {"cuda.graph"}                 # matched by dotted suffix
GRAPHED_CALLABLES = {"make_graphed_callables"}
SUB_F32 = {"bfloat16", "float16", "half", "bf16", "f16"}
_FUNCS = (ast.FunctionDef, ast.AsyncFunctionDef)


def dotted(node: ast.AST) -> Optional[str]:
    """``a.b.c`` for a Name/Attribute chain, else None."""
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def suffix_in(name: Optional[str], names: Set[str]) -> bool:
    """Whether dotted ``name`` is one of ``names`` or ends with
    ``.<one of names>``."""
    if name is None:
        return False
    return name in names or any(name.endswith("." + n) for n in names)


def is_sub_f32(node: ast.AST) -> bool:
    """``torch.bfloat16`` / ``torch.float16`` / ``torch.half`` /
    ``"bfloat16"`` / ... — a dtype expression below f32 precision."""
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value in SUB_F32
    name = dotted(node)
    return name is not None and name.split(".")[-1] in SUB_F32


def is_sub_f32_cast(node: ast.AST) -> bool:
    """``x.bfloat16()`` / ``x.half()`` / ``x.to(<sub-f32>)`` (positional or
    ``dtype=``) / ``x.type(<sub-f32>)`` / ``x.astype(<sub-f32>)``."""
    if not (isinstance(node, ast.Call)
            and isinstance(node.func, ast.Attribute)):
        return False
    attr = node.func.attr
    if attr in ("bfloat16", "half"):
        return not node.args
    if attr in ("to", "type", "astype"):
        return (any(is_sub_f32(a) for a in node.args)
                or any(kw.arg == "dtype" and is_sub_f32(kw.value)
                       for kw in node.keywords))
    return False


class CapturedIndex:
    """The set of function nodes in one module that run under CUDA-graph
    capture."""

    def __init__(self, tree: ast.Module):
        self.tree = tree
        self._parents: Dict[ast.AST, ast.AST] = {}
        self._defs: Dict[str, ast.AST] = {}
        self._classes: Dict[str, ast.ClassDef] = {}
        self._graph_blocks: List[ast.AST] = []
        for node in ast.walk(tree):     # parents are visited first
            for child in ast.iter_child_nodes(node):
                self._parents[child] = node
            if isinstance(node, _FUNCS) and \
                    not isinstance(self._parents.get(node), ast.ClassDef):
                # last def wins on shadowing — matches runtime binding
                self._defs[node.name] = node
            elif isinstance(node, ast.ClassDef):
                self._classes[node.name] = node
        self.captured: Set[ast.AST] = set()
        self._seed()
        self._fixpoint()

    # -- resolution -------------------------------------------------------

    def _enclosing_class(self, node: ast.AST) -> Optional[ast.ClassDef]:
        cur = self._parents.get(node)
        while cur is not None:
            if isinstance(cur, ast.ClassDef):
                return cur
            cur = self._parents.get(cur)
        return None

    def _methods(self, cls: ast.ClassDef, name: str, seen=None):
        """``name``'s defs in ``cls`` and its bases defined in this
        module."""
        seen = set() if seen is None else seen
        if id(cls) in seen:
            return []
        seen.add(id(cls))
        out = [n for n in cls.body if isinstance(n, _FUNCS)
               and n.name == name]
        for base in cls.bases:
            b = self._classes.get(dotted(base) or "")
            if b is not None:
                out += self._methods(b, name, seen)
        return out

    def _resolve(self, target: ast.AST, where: ast.AST) -> List[ast.AST]:
        """The module's function defs a callee expression names: a bare
        name, or ``self.<method>`` seen from ``where``."""
        if isinstance(target, ast.Name):
            fn = self._defs.get(target.id)
            return [fn] if fn is not None else []
        if isinstance(target, ast.Attribute) and \
                isinstance(target.value, ast.Name) and \
                target.value.id == "self":
            cls = self._enclosing_class(where)
            return self._methods(cls, target.attr) if cls else []
        return []

    # -- seeding ----------------------------------------------------------

    def _seed(self):
        for node in ast.walk(self.tree):
            if isinstance(node, (ast.With, ast.AsyncWith)) and any(
                    isinstance(item.context_expr, ast.Call)
                    and suffix_in(dotted(item.context_expr.func),
                                  GRAPH_CONTEXTS)
                    for item in node.items):
                self._graph_blocks.append(node)
                for stmt in node.body:
                    for sub in ast.walk(stmt):
                        if isinstance(sub, ast.Call):
                            self.captured.update(self._resolve(sub.func, sub))
            elif isinstance(node, ast.Call) and \
                    suffix_in(dotted(node.func), GRAPHED_CALLABLES) and \
                    node.args:
                first = node.args[0]
                targets = (first.elts if isinstance(first, (ast.Tuple,
                                                            ast.List))
                           else [first])
                for t in targets:
                    self.captured.update(self._resolve(t, node))

    # -- closure ----------------------------------------------------------

    def _fixpoint(self):
        changed = True
        while changed:
            changed = False
            for fn in list(self.captured):
                for node in ast.walk(fn):
                    new = []
                    if isinstance(node, _FUNCS) and node is not fn:
                        new = [node]                # nested defs run too
                    elif isinstance(node, ast.Call):
                        new = self._resolve(node.func, node)
                    for f in new:
                        if f not in self.captured:
                            self.captured.add(f)
                            changed = True

    # -- queries -----------------------------------------------------------

    def in_captured(self, node: ast.AST) -> bool:
        """Whether ``node`` runs under capture: inside a captured function
        (at any depth of nesting) or in a ``torch.cuda.graph`` block's
        body."""
        prev, cur = node, self._parents.get(node)
        while cur is not None:
            if cur in self.captured:
                return True
            if cur in self._graph_blocks and prev in cur.body:
                return True
            prev, cur = cur, self._parents.get(cur)
        return False

    @property
    def empty(self) -> bool:
        """No captured function and no graph block in the module."""
        return not self.captured and not self._graph_blocks

    def captured_functions(self):
        return iter(self.captured)
