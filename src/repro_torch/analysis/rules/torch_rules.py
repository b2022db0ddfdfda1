"""The port's lint rules. Each rule's summary is its catalog entry
(``python -m repro_torch.analysis --list-rules``).

Seven are the counterparts of the reference's JAX rules
(``repro.analysis.rules.jax_rules``), with "captured" (run under CUDA-graph
capture, ``astutil.CapturedIndex``) where the reference says "traced".
Four hold the port's own ground rules: no TF32, no kernel wrapper that
cuts autograd, every ``torch.distributed`` collective through
``distributed/collectives.py``, and no entry point that defaults to the
CPU. The reference's ``missing-donate`` has no static counterpart
(``RUNTIME_ONLY``).
"""
from __future__ import annotations

import ast
from typing import Dict, List

from repro_torch.analysis.astutil import (dotted, is_sub_f32,
                                          is_sub_f32_cast, suffix_in)
from repro_torch.analysis.rules import rule

# reference rules whose contract the port holds at run time, not in source
RUNTIME_ONLY = {
    "missing-donate":
        "no static rule: eager torch has nothing to donate; the contract "
        "(one live copy of an epoch's carry) is held at run time by "
        "repro_torch.analysis.audit.check_carry_released",
}

_NP_PREFIXES = ("np.", "numpy.")
# np.float32(...)-style dtype constructors build host constants
_NP_DTYPE_CTORS = {"float32", "float64", "float16", "bfloat16", "int8",
                   "int16", "int32", "int64", "uint8", "uint32", "uint64",
                   "bool_"}
_SYNC_METHODS = {"item", "tolist", "cpu", "numpy"}
_CONCRETIZING_METHODS = {"any", "all", "sum", "max", "min", "item",
                         "tolist", "equal", "allclose"}
# torch.* calls that return host values, not tensors
_HOST_TORCH_PREFIXES = ("torch.is_", "torch.cuda.", "torch.backends.",
                        "torch.distributed.", "torch.jit.")
_HOST_SIZE_ATTRS = {"shape", "ndim"}
_HOST_SIZE_CALLS = {"len", "size", "dim", "numel", "element_size",
                    "stride"}
_ACCUM_CALLS = {"sum", "mean", "add", "matmul", "einsum", "cumsum",
                "tensordot", "dot", "mm", "bmm", "addmm", "baddbmm",
                "nansum"}
_SEED_CTORS = {"default_rng", "PRNGKey", "RandomState", "seed",
               "manual_seed", "manual_seed_all"}
_GRAPH_NAMES = {"cuda.CUDAGraph", "CUDAGraph", "cuda.graph",
                "make_graphed_callables", "torch.compile"}
_COLLECTIVES = {"all_reduce", "all_gather", "all_gather_into_tensor",
                "all_gather_object", "reduce_scatter",
                "reduce_scatter_tensor", "broadcast", "broadcast_object_list",
                "barrier", "monitored_barrier", "send", "recv", "isend",
                "irecv", "batch_isend_irecv", "all_to_all",
                "all_to_all_single", "gather", "gather_object", "scatter",
                "scatter_object_list", "reduce"}
_FUNCS = (ast.FunctionDef, ast.AsyncFunctionDef)


def _is_np_call(name):
    return name is not None and name.startswith(_NP_PREFIXES)


# ---------------------------------------------------------------------------
# Under CUDA-graph capture
# ---------------------------------------------------------------------------

@rule("np-in-captured",
      "no numpy calls inside CUDA-graph-captured code — a capture records "
      "device work only, so the numpy result is computed once and frozen "
      "into every replay")
def np_in_captured(ctx):
    if ctx.captured.empty:
        return
    for node in ast.walk(ctx.tree):
        if not isinstance(node, ast.Call) or \
                not ctx.captured.in_captured(node):
            continue
        name = dotted(node.func)
        if not _is_np_call(name):
            continue
        tail = name.split(".")[-1]
        if tail in _NP_DTYPE_CTORS:
            continue                      # host dtype constant
        if name.startswith(("np.random.", "numpy.random.")):
            continue                      # host-rng-or-clock's finding
        yield (node.lineno, node.col_offset,
               f"numpy call `{name}(...)` inside a captured function — it "
               f"runs once, at capture; compute on the device or hoist it "
               f"out of the captured path")


def _host_size(node: ast.AST) -> bool:
    """An expression of sizes the host already knows (``x.shape[0]``,
    ``len(xs)``, ``x.size(1)``): converting it needs no sync."""
    for sub in ast.walk(node):
        if isinstance(sub, ast.Attribute) and sub.attr in _HOST_SIZE_ATTRS:
            return True
        if isinstance(sub, ast.Call):
            f = sub.func
            name = f.attr if isinstance(f, ast.Attribute) else dotted(f)
            if name in _HOST_SIZE_CALLS:
                return True
    return False


def _concretizing_expr(test: ast.AST):
    """A subexpression of ``test`` that turns a device value into a
    Python bool (a torch call, or an .any()/.sum()-style reduction)."""
    for sub in ast.walk(test):
        if isinstance(sub, ast.Call):
            name = dotted(sub.func)
            if name is not None and name.startswith("torch.") and \
                    not name.startswith(_HOST_TORCH_PREFIXES):
                return name
            if isinstance(sub.func, ast.Attribute) and \
                    sub.func.attr in _CONCRETIZING_METHODS:
                return f".{sub.func.attr}()"
    return None


def _to_cpu(node: ast.Call) -> bool:
    """``x.to("cpu")`` / ``x.to(device="cpu")`` / ``x.to(torch.device(
    "cpu"))``: a copy to the host."""
    if not (isinstance(node.func, ast.Attribute) and node.func.attr == "to"):
        return False
    vals = list(node.args) + [kw.value for kw in node.keywords
                              if kw.arg == "device"]
    return any(_is_cpu(v) for v in vals)


def _is_cpu(node: ast.AST) -> bool:
    if isinstance(node, ast.Constant):
        return node.value == "cpu"
    return (isinstance(node, ast.Call)
            and suffix_in(dotted(node.func), {"torch.device"})
            and bool(node.args) and isinstance(node.args[0], ast.Constant)
            and node.args[0].value == "cpu")


@rule("host-sync-in-captured",
      "no .item()/.tolist()/.cpu()/.numpy(), float()/int()/bool() of a "
      "tensor, torch.cuda.synchronize() or Python branching on a tensor "
      "inside CUDA-graph-captured code — each waits for the device, which "
      "a capture cannot do (and a replay would not repeat)")
def host_sync_in_captured(ctx):
    if ctx.captured.empty:
        return
    for node in ast.walk(ctx.tree):
        if not ctx.captured.in_captured(node):
            continue
        if isinstance(node, ast.Call):
            fname = dotted(node.func)
            if fname in ("float", "int", "bool") and node.args and \
                    not isinstance(node.args[0], ast.Constant) and \
                    not _host_size(node.args[0]):
                yield (node.lineno, node.col_offset,
                       f"`{fname}(...)` of a tensor inside a captured "
                       f"function waits for the device — keep it a tensor")
            elif isinstance(node.func, ast.Attribute) and \
                    node.func.attr in _SYNC_METHODS and not node.args:
                yield (node.lineno, node.col_offset,
                       f"`.{node.func.attr}()` inside a captured function "
                       f"copies to the host — return the tensor and read it "
                       f"after the replay")
            elif isinstance(node.func, ast.Attribute) and \
                    node.func.attr == "synchronize":
                yield (node.lineno, node.col_offset,
                       f"`{fname or '.synchronize'}()` inside a captured "
                       f"function — a capture cannot wait for the device")
            elif _to_cpu(node):
                yield (node.lineno, node.col_offset,
                       "`.to('cpu')` inside a captured function copies to "
                       "the host — read the result after the replay")
        elif isinstance(node, (ast.If, ast.While, ast.IfExp, ast.Assert)):
            bad = _concretizing_expr(node.test)
            if bad is not None:
                yield (node.lineno, node.col_offset,
                       f"Python `{type(node).__name__.lower()}` on `{bad}` "
                       f"inside a captured function branches on a tensor — "
                       f"the capture records one branch; use torch.where")


@rule("host-rng-or-clock",
      "no wall-clock or host-RNG calls inside CUDA-graph-captured code — "
      "the value freezes into the graph at capture, and every replay "
      "reuses it")
def host_rng_or_clock(ctx):
    if ctx.captured.empty:
        return
    for node in ast.walk(ctx.tree):
        if not isinstance(node, ast.Call) or \
                not ctx.captured.in_captured(node):
            continue
        name = dotted(node.func)
        if name is None:
            continue
        if name.startswith(("time.", "datetime.")) or name in (
                "perf_counter", "monotonic"):
            yield (node.lineno, node.col_offset,
                   f"wall-clock call `{name}(...)` inside a captured "
                   f"function is read once, at capture — time on the host, "
                   f"around the replay")
        elif name.startswith(("random.", "np.random.", "numpy.random.")):
            yield (node.lineno, node.col_offset,
                   f"host RNG `{name}(...)` inside a captured function "
                   f"freezes one draw into the graph — draw on the device "
                   f"from a generator seeded by the seed + i rule")


# ---------------------------------------------------------------------------
# Anywhere
# ---------------------------------------------------------------------------

@rule("sub-f32-accum",
      "averaged/reduced trees must accumulate in f32 or wider — a bf16 "
      "running sum drifts O(k·2^-8) off the true mean (held at run time "
      "by audit.check_accum_dtype)")
def sub_f32_accum(ctx):
    for node in ast.walk(ctx.tree):
        if isinstance(node, ast.Call):
            name = dotted(node.func)
            f = node.func
            tail = f.attr if isinstance(f, ast.Attribute) else (name or "")
            if tail in _ACCUM_CALLS:
                for kw in node.keywords:
                    if kw.arg in ("dtype", "out_dtype") and \
                            is_sub_f32(kw.value):
                        yield (node.lineno, node.col_offset,
                               f"`{name or tail}(..., {kw.arg}=<sub-f32>)`"
                               f" accumulates below f32 — average/reduce "
                               f"in f32, cast the RESULT back")
            if tail == "add" and any(is_sub_f32_cast(a) for a in node.args):
                yield (node.lineno, node.col_offset,
                       f"`{name or tail}` of a sub-f32 cast — sum in f32 "
                       f"and cast the final mean back")
            if tail == "all_reduce" and node.args and \
                    is_sub_f32_cast(node.args[0]):
                yield (node.lineno, node.col_offset,
                       "`all_reduce` of a sub-f32 operand — the "
                       "cross-member reduction must ride in f32 (cast "
                       "after, not before)")
        elif isinstance(node, ast.BinOp) and isinstance(node.op, ast.Add):
            for side in (node.left, node.right):
                if is_sub_f32_cast(side):
                    yield (node.lineno, node.col_offset,
                           "accumulating a sub-f32 cast operand — sum in f32 "
                           "and cast the final mean back")
        elif isinstance(node, ast.AugAssign) and \
                isinstance(node.op, ast.Add) and \
                is_sub_f32_cast(node.value):
            yield (node.lineno, node.col_offset,
                   "`+=` of a sub-f32 cast operand — sum in f32 and cast "
                   "the final mean back")


@rule("hardcoded-member-seed",
      "member rng streams derive from MapConfig.seed + member id — a "
      "literal base seed (`default_rng(1000 + i)`, "
      "`Generator().manual_seed(1000 + i)`) silently diverges from the "
      "runner's streams the day the config seed changes")
def hardcoded_member_seed(ctx):
    for node in ast.walk(ctx.tree):
        if not isinstance(node, ast.Call) or not node.args:
            continue
        f = node.func
        tail = f.attr if isinstance(f, ast.Attribute) else \
            (f.id if isinstance(f, ast.Name) else "")
        if tail not in _SEED_CTORS:
            continue
        arg = node.args[0]
        if isinstance(arg, ast.BinOp) and isinstance(arg.op, ast.Add) and \
                any(isinstance(s, ast.Constant) and isinstance(s.value, int)
                    for s in (arg.left, arg.right)):
            yield (node.lineno, node.col_offset,
                   f"`{tail}(<literal> + ...)` hardcodes a member seed "
                   f"base — derive it from MapConfig.member_seed(i) / "
                   f"plan.seed + i so every backend shares one rule")


@rule("graph-outside-scorer",
      "the serving path captures CUDA graphs through BucketedScorer's pad "
      "ladder only — a CUDA graph or torch.compile elsewhere in "
      "repro_torch.serve dodges the compile budget (one graph per bucket, "
      "assert_compile_budget)",
      paths=r"(^|/)repro_torch/serve/(?!engine\.py$)")
def graph_outside_scorer(ctx):
    for node in ast.walk(ctx.tree):
        if not isinstance(node, (ast.Attribute, ast.Name)):
            continue
        name = dotted(node)
        if name in _GRAPH_NAMES or (
                name is not None and suffix_in(name, _GRAPH_NAMES - {
                    "CUDAGraph", "torch.compile"})):
            yield (node.lineno, node.col_offset,
                   f"`{name}` in repro_torch.serve outside serve/engine.py "
                   f"— every serving program must be a BucketedScorer "
                   f"bucket so compile_count()/assert_compile_budget() see "
                   f"it")


@rule("unregistered-reduce-strategy",
      "`strategy=<string>` must name a registered ReduceStrategy — an "
      "unregistered literal fails at ReduceConfig construction, and the "
      "registry (not a frozen tuple) is the single source of truth")
def unregistered_reduce_strategy(ctx):
    # resolved lazily, so a broken registry cannot take down every rule
    from repro_torch.core.reduce_strategies import registry_keys
    keys = registry_keys()
    for node in ast.walk(ctx.tree):
        if not isinstance(node, ast.Call):
            continue
        for kw in node.keywords:
            if kw.arg != "strategy":
                continue
            if isinstance(kw.value, ast.Constant) and \
                    isinstance(kw.value.value, str) and \
                    kw.value.value not in keys:
                yield (kw.value.lineno, kw.value.col_offset,
                       f"strategy={kw.value.value!r} is not a registered "
                       f"reduce strategy — registry keys are "
                       f"{', '.join(keys)} (register(...) a new one or "
                       f"fix the literal)")


# ---------------------------------------------------------------------------
# The port's ground rules
# ---------------------------------------------------------------------------

def _const(node, *values) -> bool:
    return isinstance(node, ast.Constant) and node.value in values and \
        type(node.value) is type(values[0])


@rule("no-tf32",
      "no TF32 anywhere in the port — it keeps ~3 decimal digits, far "
      "outside the parity bars held against the reference (allow_tf32 = "
      "True, set_float32_matmul_precision('high'|'medium'), "
      "fp32_precision = 'tf32', tl.dot without input_precision='ieee')")
def no_tf32(ctx):
    for node in ast.walk(ctx.tree):
        if isinstance(node, (ast.Assign, ast.AnnAssign)):
            targets = node.targets if isinstance(node, ast.Assign) \
                else [node.target]
            for t in targets:
                if not isinstance(t, ast.Attribute) or node.value is None:
                    continue
                if t.attr == "allow_tf32" and _const(node.value, True):
                    yield (node.lineno, node.col_offset,
                           "`allow_tf32 = True` turns TF32 on — the port "
                           "runs f32 as f32")
                elif t.attr == "fp32_precision" and \
                        _const(node.value, "tf32"):
                    yield (node.lineno, node.col_offset,
                           "`fp32_precision = 'tf32'` turns TF32 on — the "
                           "port runs f32 as f32")
        elif isinstance(node, ast.Call):
            name = dotted(node.func)
            f = node.func
            tail = f.attr if isinstance(f, ast.Attribute) else (name or "")
            for kw in node.keywords:
                if kw.arg == "allow_tf32" and _const(kw.value, True):
                    yield (kw.value.lineno, kw.value.col_offset,
                           "`allow_tf32=True` turns TF32 on — the port "
                           "runs f32 as f32")
            if tail == "set_float32_matmul_precision":
                vals = list(node.args[:1]) + [kw.value for kw in
                                              node.keywords
                                              if kw.arg == "precision"]
                if any(_const(v, "high", "medium") for v in vals):
                    yield (node.lineno, node.col_offset,
                           "`set_float32_matmul_precision('high'|'medium')` "
                           "lets f32 products run in TF32 — leave it "
                           "'highest'")
            if suffix_in(name, {"tl.dot", "triton.language.dot"}) and \
                    not any(kw.arg == "input_precision"
                            and _const(kw.value, "ieee")
                            for kw in node.keywords):
                yield (node.lineno, node.col_offset,
                       f"`{name}(...)` without input_precision='ieee' "
                       f"multiplies f32 operands in TF32 — pass "
                       f"input_precision='ieee'")


def _parents(tree) -> Dict[ast.AST, ast.AST]:
    out = {}
    for node in ast.walk(tree):
        for child in ast.iter_child_nodes(node):
            out[child] = node
    return out


def _own_calls(fn) -> List[ast.Call]:
    """The calls in ``fn``'s own body (not those of nested defs or
    classes), in source order."""
    out, stack = [], list(ast.iter_child_nodes(fn))
    while stack:
        node = stack.pop()
        if isinstance(node, _FUNCS + (ast.ClassDef,)):
            continue
        if isinstance(node, ast.Call):
            out.append(node)
        stack.extend(ast.iter_child_nodes(node))
    return sorted(out, key=lambda c: (c.lineno, c.col_offset))


def _operator_impls(tree, plain):
    """Module-level names bound to a kernel's operator, ``NAME =
    kernels.register(name, schema, cuda_impl, ...)``, mapped to the
    function ``cuda_impl``: a call of NAME on a CUDA tensor runs it."""
    out = {}
    for node in tree.body:
        if isinstance(node, ast.Assign) and isinstance(node.value, ast.Call) \
                and suffix_in(dotted(node.value.func), {"kernels.register"}) \
                and len(node.value.args) > 2 \
                and isinstance(node.value.args[2], ast.Name) \
                and node.value.args[2].id in plain:
            for target in node.targets:
                if isinstance(target, ast.Name):
                    out[target.id] = plain[node.value.args[2].id]
    return out


@rule("kernel-wrapper-grad",
      "a function that reaches kernels.launch(...) — directly or through a "
      "kernel's operator (kernels.register) — must run inside a "
      "torch.autograd.Function or call kernels.refuse_grad(...) before its "
      "launch — a kernel's output is a buffer it fills, which silently "
      "cuts the autograd graph of an operand that requires grad (F1)")
def kernel_wrapper_grad(ctx):
    if "launch" not in ctx.source:
        return
    parents = _parents(ctx.tree)
    classes = {n.name: n for n in ast.walk(ctx.tree)
               if isinstance(n, ast.ClassDef)}
    fn_classes = {c for c in classes.values() if any(
        suffix_in(dotted(b), {"autograd.Function"}) or dotted(b) == "Function"
        for b in c.bases)}
    funcs = [n for n in ast.walk(ctx.tree) if isinstance(n, _FUNCS)]
    plain = {f.name: f for f in funcs
             if not isinstance(parents.get(f), ast.ClassDef)}
    operators = _operator_impls(ctx.tree, plain)

    def enclosing_class(node):
        cur = parents.get(node)
        while cur is not None and not isinstance(cur, ast.ClassDef):
            cur = parents.get(cur)
        return cur

    def callees(call):
        f = call.func
        if isinstance(f, ast.Name):
            if f.id in operators:
                return [operators[f.id]]
            return [plain[f.id]] if f.id in plain else []
        if isinstance(f, ast.Attribute) and isinstance(f.value, ast.Name):
            owner = (enclosing_class(call) if f.value.id in ("self", "cls")
                     else classes.get(f.value.id))
            if owner is not None:
                return [m for m in owner.body if isinstance(m, _FUNCS)
                        and m.name == f.attr]
        return []

    calls = {f: _own_calls(f) for f in funcs}
    launches = {f for f in funcs if any(
        suffix_in(dotted(c.func), {"kernels.launch"}) for c in calls[f])}
    reach = set(launches)
    changed = True
    while changed:
        changed = False
        for f in funcs:
            if f not in reach and any(g in reach for c in calls[f]
                                      for g in callees(c)):
                reach.add(f)
                changed = True

    def reaching_call(f):
        for c in calls[f]:
            if suffix_in(dotted(c.func), {"kernels.launch"}) or \
                    any(g in reach for g in callees(c)):
                return c
        return None

    def guarded(f):
        cls = enclosing_class(f)
        while cls is not None:
            if cls in fn_classes:
                return True
            cls = enclosing_class(cls)
        first = reaching_call(f)
        for c in calls[f]:
            if suffix_in(dotted(c.func), {"refuse_grad"}) and \
                    (c.lineno, c.col_offset) < (first.lineno,
                                                first.col_offset):
                return True
            # routes the case autograd records to a Function
            fc = c.func
            if isinstance(fc, ast.Attribute) and fc.attr == "apply" and \
                    classes.get(dotted(fc.value) or "") in fn_classes:
                return True
        return False

    # exposed: launches with no guard of its own on the way — directly, or
    # through a callee that is exposed itself
    exposed: set = set()
    changed = True
    while changed:
        changed = False
        for f in reach - exposed:
            if not guarded(f) and (f in launches or any(
                    g in exposed for c in calls[f] for g in callees(c))):
                exposed.add(f)
                changed = True
    callers = {f: [g for g in funcs if any(f in callees(c)
                                           for c in calls[g])]
               for f in exposed}
    # an exposed function is safe where every caller guards it
    ok: set = set()
    changed = True
    while changed:
        changed = False
        for f in exposed - ok:
            if callers[f] and all(guarded(g) or g in ok
                                  for g in callers[f]):
                ok.add(f)
                changed = True
    bad = exposed - ok
    # report where the guard is missing: the unguarded entry points
    roots = [f for f in bad if not callers[f]] or list(bad)
    for f in sorted(roots, key=lambda f: f.lineno):
        c = reaching_call(f)
        yield (c.lineno, c.col_offset,
               f"`{f.name}` reaches kernels.launch(...) outside a "
               f"torch.autograd.Function and without kernels.refuse_grad"
               f"(...) before it — on an operand that requires grad the "
               f"kernel's output silently cuts the autograd graph")


def _dist_names(tree):
    """(prefixes naming the torch.distributed module, bare collective
    names imported from it)."""
    prefixes, bare = {"torch.distributed"}, set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                if a.name == "torch.distributed" and a.asname:
                    prefixes.add(a.asname)
        elif isinstance(node, ast.ImportFrom):
            for a in node.names:
                if node.module == "torch" and a.name == "distributed":
                    prefixes.add(a.asname or a.name)
                elif node.module == "torch.distributed" and \
                        a.name in _COLLECTIVES:
                    bare.add(a.asname or a.name)
    return prefixes, bare


@rule("collective-outside-module",
      "every torch.distributed collective goes through "
      "repro_torch/distributed/collectives.py, which counts it per span — "
      "a collective called elsewhere escapes the one-all-reduce and "
      "zero-in-an-epoch checks",
      paths=r"^(?!(.*/)?repro_torch/distributed/collectives\.py$)")
def collective_outside_module(ctx):
    if "distributed" not in ctx.source:
        return
    prefixes, bare = _dist_names(ctx.tree)
    for node in ast.walk(ctx.tree):
        if not isinstance(node, ast.Call):
            continue
        name = dotted(node.func)
        if name is None:
            continue
        head, _, tail = name.rpartition(".")
        if (head in prefixes and tail in _COLLECTIVES) or \
                (not head and tail in bare):
            yield (node.lineno, node.col_offset,
                   f"`{name}(...)` outside distributed/collectives.py — "
                   f"call the counted wrapper in repro_torch.distributed."
                   f"collectives instead")


@rule("entry-point-cpu-default",
      "a `device` parameter defaults to the card ('cuda'), never to 'cpu' "
      "— a CPU default quietly runs the plain versions instead of the "
      "kernels (F7)")
def entry_point_cpu_default(ctx):
    for node in ast.walk(ctx.tree):
        if not isinstance(node, _FUNCS + (ast.Lambda,)):
            continue
        a = node.args
        positional = a.posonlyargs + a.args
        pairs = list(zip(positional[len(positional) - len(a.defaults):],
                         a.defaults))
        pairs += [(arg, d) for arg, d in zip(a.kwonlyargs, a.kw_defaults)
                  if d is not None]
        for arg, default in pairs:
            if arg.arg == "device" and _is_cpu(default):
                yield (default.lineno, default.col_offset,
                       "`device` defaults to the CPU — default to 'cuda' "
                       "and let the caller ask for device='cpu'")
