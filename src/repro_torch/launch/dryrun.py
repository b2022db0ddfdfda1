"""The dry run: trace every (arch x input shape x mesh) step on the meta
device and report what one card would hold and do — the port's
counterpart of ``repro.launch.dryrun``.

    PYTHONPATH=src python -m repro_torch.launch.dryrun [--arch A]
        [--shape S] [--mesh single|multi|both|pod|multipod] [--out DIR]
        [--optimizer adamw|sgd|momentum] [--rules JSON] [--set KEY=VALUE]

The reference lowers and compiles each step on shape stand-ins and reads
XLA's memory and cost analyses. The port runs eagerly, so it runs the
step itself — the trainer's, prefill's or decode's own code, as a user
calls it — on tensors of the meta device, which carry shapes and dtypes
and no data: nothing is allocated, nothing is launched, and no card is
needed. Each hand kernel is a ``torch.ops.repro_torch`` operator whose
meta implementation gives its outputs' shapes, so the trace follows the
card's route kernel for kernel. A ``TorchDispatchMode`` (``Tracer``)
counts, per op:

* FLOPs by ``torch.utils.flop_counter``'s formulas (the kernels' own
  included), by the dtype the op computes in;
* bytes: each non-view op's input and output tensors (an in-place op's
  operand is read and written: counted twice);
* the live storage bytes after each op (the step's arguments, its
  temporaries and autograd's saved tensors) and their peak. The caching
  allocator's rounding and fragmentation are not modelled;
* the calls of each kernel operator.

Every layer runs in the trace (the port's layer loop is Python), so
there are no probes to extrapolate from: ``"n_probes": 0``.

Meshes: ``single`` is one member on one card. ``multi`` is ``MEMBERS``
members, one a card — the mesh backend's layout — and the figures are per
card: a train step is one member's step on its own batch, then
``average_step`` is ``trainer.make_average_step(group=...)`` over a fake
process group of ``MEMBERS`` ranks, whose collectives are read from
``distributed.collectives`` as the code sends them; a prefill or decode
batch is split evenly over the cards (a batch of one is replicated) —
a split of the batch only, not the reference's layout.

``pod`` and ``multipod`` are the reference's own meshes and layout: its
16 × 16 (data, model) ``single`` mesh under ``DEFAULT_RULES``, and its
2 × 16 × 16 (pod, data, model) ``multi`` mesh under ``MULTIPOD_RULES``.
The step runs as rank 0 of a fake process group of the mesh's size, under
``distributed.ctx.use_mesh_rules``, on rank 0's blocks of the parameters,
inputs and cache (``sharding.resolve_spec``'s layout, so its argument
bytes are the reference's per-chip bytes); the collectives it sends are
counted by mesh axis, and those sent in the backward also apart
(``collectives_backward``). Every LM family's train, prefill and decode
steps: on ``pod`` the train step on the (data, model) blocks
of the params, AdamW's μ and ν and the batch; on ``multipod`` the member
step (``make_member_train_step``) on blocks stacked on a member dim over
``pod`` (``MEMBERS`` members, ``MULTIPOD_RULES``), whose step runs under
the default rules as the reference's ``spmd_axis_name="pod"`` lowering
does, and beside it the Reduce over ``pod``
(``make_average_step(group=...)``, ``average_step`` in the report).
``--rules`` lays a rule override over them, as the reference's
``build_lowered(..., rules_override=)`` does (its hillclimb's lever:
``'{"ff": ["data"]}'`` is FSDP of the ff dim, ``'{"heads": []}'`` turns
tensor parallelism off; ``distributed/ctx.py`` says which the port
runs), and ``--set`` a configuration field (``moe_combine_sharding=batch``);
the report's ``rules`` is the merged set.
RWKV6's chunked WKV loops over S / 32 chunks a layer in Python, so its
prefill_32k traces take longest. The roofline is priced at
``cost_analysis.CARD``'s data-sheet rates: the figures are build-host
estimates from the trace, not card readings.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import time
import traceback
import weakref
from collections import Counter
from contextlib import contextmanager
from dataclasses import dataclass

import torch
import torch.distributed as dist
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import FlopCounterMode
from torch.utils.weak import WeakIdKeyDictionary

from repro_torch import kernels, optim
from repro_torch.configs.base import (ARCH_IDS, INPUT_SHAPES, InputShape,
                                      get_config, replace, supported_shapes)
from repro_torch.core import trainer
from repro_torch.distributed import collectives, ctx, sharding
from repro_torch.launch import cost_analysis
from repro_torch.launch.mesh import PRODUCTION_MESHES, make_production_mesh
from repro_torch.models import api
from repro_torch.tree import tree_map

MEMBERS = 2          # multi: one distributed-averaging member a card
LM_RULES = {"pod": None, "multipod": sharding.MULTIPOD_RULES}
META = torch.device("meta")
_OPTS = {"adamw": optim.adamw, "sgd": optim.sgd, "momentum": optim.momentum}
# kernels whose arithmetic is f32 on the CUDA cores whatever x's dtype
_F32_MATH = ("rmsnorm", "rmsnorm_bwd", "elm_stats", "conv2d", "conv2d_wgrad",
             "conv2d_dgrad")
MEMORY_NOTE = ("live storage bytes through the step on the meta device: "
               "arguments, temporaries and autograd's saved tensors; the "
               "caching allocator's rounding and fragmentation are not "
               "modelled")


def shape_cfg(cfg, shape):
    """Per-shape config adjustments: dense, MoE and VLM archs take the
    sliding-window attention variant (window 4096) at long_500k, as the
    reference's dry run does."""
    if (shape.name == "long_500k" and not cfg.sliding_window
            and cfg.family in ("dense", "moe", "vlm")):
        return replace(cfg, sliding_window=4096)
    return cfg


# ---------------------------------------------------------------------------
# The tracer
# ---------------------------------------------------------------------------

def _tensors(tree):
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


def _nbytes(t) -> int:
    return t.numel() * t.element_size()


class Tracer(TorchDispatchMode):
    """Counts every op dispatched while it is active, over tensors of
    ``device`` (see the module's docstring): ``flops`` by dtype name,
    ``kernel_flops`` (the part in kernel operators), ``bytes``,
    ``kernels`` (operator calls by kernel name), ``live`` and ``peak``
    storage bytes. The FLOPs are ``FlopCounterMode``'s own count (it runs
    beneath the tracer), split by the dtype each op computes in.
    ``hold(tree)`` counts tensors made before the trace (the step's
    arguments) as live."""

    def __init__(self, device=META):
        super().__init__()
        self.device = torch.device(device)
        self.flop_counter = FlopCounterMode(display=False)
        self.flops: Counter = Counter()
        self.kernel_flops = 0
        self.bytes = 0
        self.kernels: Counter = Counter()
        self.live = self.peak = 0
        self._known = WeakIdKeyDictionary()

    def __enter__(self):
        self.flop_counter.__enter__()
        return super().__enter__()

    def __exit__(self, *exc):
        super().__exit__(*exc)
        self.flop_counter.__exit__(*exc)

    def _release(self, n):
        self.live -= n

    def _track(self, t):
        if t.device != self.device:
            return
        st = t.untyped_storage()
        if st in self._known:
            return
        n = st.nbytes()
        self._known[st] = n
        weakref.finalize(st, self._release, n)
        self.live += n
        self.peak = max(self.peak, self.live)

    def hold(self, tree) -> int:
        """Count ``tree``'s tensors as live; returns their storages'
        bytes (each storage once)."""
        before = self.live
        for t in _tensors(tree):
            self._track(t)
        return self.live - before

    def _counted(self) -> int:
        return sum(self.flop_counter.flop_counts["Global"].values())

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        before = self._counted()
        out = func(*args, **kwargs)
        n = self._counted() - before
        ins, outs = _tensors((args, kwargs)), _tensors(out)
        kernel = func.namespace == kernels.NAMESPACE
        if n:
            dt = torch.float32 if kernel and func._opname in _F32_MATH \
                else next((t.dtype for t in ins if t.is_floating_point()),
                          torch.float32)
            self.flops[str(dt).replace("torch.", "")] += n
            if kernel:
                self.kernel_flops += n
        if kernel:
            self.kernels[func._opname] += 1
        mine = [t for t in ins + outs if t.device == self.device]
        if mine and not _is_view(func, ins, outs):
            self.bytes += sum(_nbytes(t) for t in mine)
        for t in outs:
            self._track(t)
        return out


def _is_view(func, ins, outs) -> bool:
    """A view, or a view by another name (``_unsafe_view``): an op that
    writes nothing and whose every output shares an input's storage."""
    if func.is_view:
        return True
    if not outs or any(a.alias_info is not None and a.alias_info.is_write
                       for a in func._schema.arguments):
        return False
    held = [t.untyped_storage() for t in ins]
    return all(any(t.untyped_storage() is s for s in held) for t in outs)


def _meta(specs):
    """Meta tensors of a spec tree."""
    return tree_map(lambda s: s.empty(META), specs)


def _stack(tree, k):
    return tree_map(lambda t: t.unsqueeze(0).expand((k,) + t.shape)
                    .contiguous(), tree)


def _stack_specs(specs, k):
    """A spec tree with a leading member dim of ``k``."""
    return tree_map(lambda s: api.TensorSpec((k,) + tuple(s.shape),
                                             s.dtype), specs)


@contextmanager
def fake_process_group(world: int):
    """A process group of ``world`` ranks that sends nothing (this process
    is rank 0), for tracing the Reduce's collectives on meta tensors."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)
    try:
        yield dist.group.WORLD
    finally:
        dist.destroy_process_group()


def _coll_growth(before_calls, before_bytes, calls=collectives.CALLS,
                 nbytes=collectives.BYTES):
    """The collectives counted in ``calls`` / ``nbytes`` since the copies
    ``before_calls`` / ``before_bytes`` were taken."""
    grown = Counter(calls)
    grown.subtract(before_calls)
    sent = Counter(nbytes)
    sent.subtract(before_bytes)
    return cost_analysis.collective_stats(grown, sent)


@dataclass
class Traced:
    """One traced call: its ``Tracer``, argument and output bytes, its
    collectives (and the part sent in a backward) and its host wall."""
    tracer: Tracer
    arg_bytes: int
    out_bytes: int
    coll: cost_analysis.CollectiveStats
    wall_s: float
    coll_backward: cost_analysis.CollectiveStats = None


def trace(fn, *args) -> Traced:
    """Run ``fn(*args)`` (meta tensors) under a ``Tracer``; the arguments
    count as live from the start."""
    tracer = Tracer()
    arg_bytes = tracer.hold(args)
    calls, nbytes = Counter(collectives.CALLS), Counter(collectives.BYTES)
    bwd_calls = Counter(collectives.BACKWARD_CALLS)
    bwd_bytes = Counter(collectives.BACKWARD_BYTES)
    t0 = time.perf_counter()
    with tracer:
        out = fn(*args)
    wall = time.perf_counter() - t0
    before = set(id(t.untyped_storage()) for t in _tensors(args))
    out_bytes = sum({id(t.untyped_storage()): t.untyped_storage().nbytes()
                     for t in _tensors(out)
                     if t.device == META
                     and id(t.untyped_storage()) not in before}.values())
    del out
    return Traced(tracer, arg_bytes, out_bytes,
                  _coll_growth(calls, nbytes), wall,
                  _coll_growth(bwd_calls, bwd_bytes,
                               collectives.BACKWARD_CALLS,
                               collectives.BACKWARD_BYTES))


# ---------------------------------------------------------------------------
# The steps
# ---------------------------------------------------------------------------

def step_fn(cfg, shape, *, multi: bool = False,
            optimizer_name: str = "adamw"):
    """The step a user runs for ``shape``'s kind: the trainer's train step
    (under ``multi`` one member's ``make_member_train_step``) at a
    constant lr, the prefill step or the serve (decode) step."""
    if shape.kind == "train":
        make = trainer.make_member_train_step if multi \
            else trainer.make_train_step
        return make(cfg, _OPTS[optimizer_name](), optim.constant(1e-3))
    if shape.kind == "prefill":
        return trainer.make_prefill_step(cfg)
    return trainer.make_serve_step(cfg)


def step_args(cfg, shape, *, multi: bool = False,
              optimizer_name: str = "adamw", dtype=torch.bfloat16):
    """The meta arguments of ``step_fn``'s step on one card: params with
    the optimizer state and batch (under ``multi`` over a member dim of
    1), params and a prefill batch, or params, the decode cache, the token
    and ``pos = S - 1`` (for ``multi``, the serving batch split over the
    cards)."""
    params = _meta(api.param_specs(cfg, dtype))
    if shape.kind == "train":
        opt_state = _OPTS[optimizer_name]().init(params)
        batch = _meta(api.input_specs(cfg, shape))
        if multi:
            return (_stack(params, 1), _stack(opt_state, 1), [0],
                    _stack(batch, 1))
        return params, opt_state, 0, batch
    if multi and shape.global_batch % MEMBERS == 0:
        shape = InputShape(shape.name, shape.seq_len,
                           shape.global_batch // MEMBERS, shape.kind)
    if shape.kind == "prefill":
        return params, _meta(api.input_specs(cfg, shape))
    cache = _meta(api.cache_specs(cfg, shape, dtype))
    token = _meta(api.input_specs(cfg, shape))["token"]
    return params, cache, token, shape.seq_len - 1


def trace_average(cfg, dtype=torch.bfloat16) -> Traced:
    """The Reduce of ``MEMBERS`` members, one a card: this card's member
    averaged with the others' by ``make_average_step(group=...)`` over a
    fake process group of ``MEMBERS`` ranks."""
    params = _stack(_meta(api.param_specs(cfg, dtype)), 1)
    with fake_process_group(MEMBERS) as group:
        return trace(trainer.make_average_step(group=group), params)


def _blocks(specs, logical, device=META, generator=None, high=1):
    """This rank's blocks of a spec tree under the active mesh context:
    meta tensors, or on a real ``device`` drawn from ``generator``
    (floating leaves N(0, 0.02²), integer leaves in [0, ``high``))."""
    frame = ctx.current()

    def block(log, s):
        shape = sharding.block_shape(s.shape, frame.layout(s.shape, log),
                                     frame.mesh.shape)
        if device == META:
            return torch.empty(shape, dtype=s.dtype, device=META)
        if s.dtype.is_floating_point:
            return (0.02 * torch.randn(shape, generator=generator,
                                       device=device)).to(s.dtype)
        return torch.randint(0, high, shape, generator=generator,
                             device=device, dtype=s.dtype)

    return sharding.map_logical(block, logical, specs)


def mesh_step_args(cfg, shape, dtype=torch.bfloat16, device=META,
                   generator=None, optimizer_name: str = "adamw",
                   members: int = 0):
    """The arguments of ``step_fn``'s step on this rank of the active mesh
    context: its blocks of the params with the optimizer's state (zero, as
    ``init`` makes it: AdamW's μ and ν take each leaf's layout), the step
    and the train batch; or of the params and the prefill batch; or of
    the params, the cache and the token (``pos = S - 1``); the global
    batch and cache length declared. ``members``: the train step's
    arguments stacked on a member dim of that many members (params,
    state and batch; the steps one a local member), laid out by the
    context's rules (``MULTIPOD_RULES``: over ``pod``). Meta tensors, or
    drawn on a real ``device`` from ``generator``, token ids below the
    vocab size."""
    def blocks(specs, logical):
        return _blocks(specs, logical, device, generator, cfg.vocab_size)

    p_specs, p_log = api.param_specs(cfg, dtype), api.logical_axes(cfg)
    specs, logical = api.input_specs(cfg, shape, with_logical=True)
    ctx.declare(batch=shape.global_batch)
    if shape.kind == "train":
        if members:
            p_specs, specs = (_stack_specs(t, members)
                              for t in (p_specs, specs))
            p_log, logical = (sharding.with_member_dim(t)
                              for t in (p_log, logical))
        params = blocks(p_specs, p_log)
        opt_state = _OPTS[optimizer_name]().init(params)
        batch = blocks(specs, logical)
        lead = next(iter(tree_map(lambda t: t.shape[0], batch).values()))
        return params, opt_state, [0] * lead if members else 0, batch
    params = blocks(p_specs, p_log)
    if shape.kind == "prefill":
        return params, blocks(specs, logical)
    cache, c_logical = api.cache_specs(cfg, shape, dtype, with_logical=True)
    for name, log in c_logical.items():
        if "kv_seq" in log:
            ctx.declare(cache_len=cache[name].shape[log.index("kv_seq")])
    token = blocks({"token": specs["token"]},
                   {"token": logical["token"]})["token"]
    return params, blocks(cache, c_logical), token, shape.seq_len - 1


def mesh_rules(name: str, rules_override=None):
    """The rules of the ``pod`` or ``multipod`` mesh with
    ``rules_override`` laid over them (None: none), as the reference's
    ``build_lowered`` merges them."""
    rules = dict(LM_RULES[name] or {})
    rules.update(sharding.normalize_rules(rules_override) or {})
    return rules or None


@contextmanager
def lm_mesh(name: str, rules_override=None):
    """Rank 0 of the reference's ``pod`` or ``multipod`` mesh under a fake
    process group of its size, with its rules (and ``rules_override``
    over them) in force; yields the context's frame."""
    with fake_process_group(math.prod(PRODUCTION_MESHES[name].values())):
        mesh = make_production_mesh(multi_pod=name == "multipod")
        with ctx.use_mesh_rules(mesh, mesh_rules(name, rules_override)) \
                as frame:
            yield frame


def trace_mesh_combo(cfg, shape, mesh: str = "pod",
                     optimizer_name: str = "adamw", rules_override=None,
                     cfg_override=None) -> dict:
    """Trace rank 0's step of ``cfg`` at ``shape`` on the ``pod`` or
    ``multipod`` mesh and return the report (per-chip figures); a train
    step on ``multipod`` is the member step, its Reduce over ``pod``
    traced beside it. ``rules_override`` and ``cfg_override`` are the
    reference's ``build_lowered`` and hillclimb arguments: logical axes
    remapped over the mesh's rules, and configuration fields replaced."""
    if cfg_override:
        cfg = replace(cfg, **cfg_override)
    members = MEMBERS if mesh == "multipod" and shape.kind == "train" \
        else 0
    with lm_mesh(mesh, rules_override) as frame:
        args = mesh_step_args(cfg, shape, optimizer_name=optimizer_name,
                              members=members)
        traced = trace(step_fn(cfg, shape, multi=bool(members),
                               optimizer_name=optimizer_name), *args)
        average = None
        if members:
            average = trace(trainer.make_average_step(
                group=frame.mesh.group("pod")), args[0])
        del args
        report = report_of(cfg, shape, traced,
                           cards=math.prod(frame.mesh.shape.values()),
                           mesh=mesh, average=average)
        report["mesh_shape"] = dict(frame.mesh.shape)
        report["rules"] = {k: list(v) for k, v in
                           (frame.rules or {}).items()}
        report["coord"] = dict(frame.mesh.coord)
    return report


def report_of(cfg, shape, traced: Traced, *, cards: int, mesh: str,
              average: Traced = None) -> dict:
    """The report of one traced step on ``cards`` cards (per-card figures
    are one card's trace)."""
    tr = traced.tracer
    flops = float(sum(tr.flops.values()))
    rates = cost_analysis.CARDS[cost_analysis.CARD]
    terms = cost_analysis.roofline_terms(
        {k: v * cards for k, v in tr.flops.items()}, tr.bytes * cards,
        traced.coll.per_card_bytes, cards)
    if shape.kind in ("train", "prefill"):
        n_tokens = shape.global_batch * shape.seq_len
    else:
        n_tokens = shape.global_batch     # decode: one token a sequence
    n_active = cfg.active_param_count()
    model_flops = (6 if shape.kind == "train" else 2) * n_active * n_tokens
    if mesh in ("multi", "multipod") and shape.kind == "train":
        model_flops *= MEMBERS            # each member its own batch
    report = {
        "arch": cfg.name, "shape": shape.name, "mesh": mesh,
        "cards": cards, "kind": shape.kind,
        "trace_s": traced.wall_s, "n_probes": 0,
        "memory": {
            "argument_bytes_per_card": traced.arg_bytes,
            "output_bytes_per_card": traced.out_bytes,
            "peak_bytes_per_card": tr.peak,
            "card_memory_bytes": rates.memory_bytes,
            "fits": tr.peak <= rates.memory_bytes,
            "note": MEMORY_NOTE,
        },
        "cost": {
            "flops_per_card": flops,
            "flops_by_dtype_per_card": dict(tr.flops),
            "kernel_flops_per_card": float(tr.kernel_flops),
            "bytes_per_card": float(tr.bytes),
            "flops_global": flops * cards,
            "bytes_global": float(tr.bytes) * cards,
            "accounting": "every layer traced",
        },
        "collectives": traced.coll.as_dict(),
        "collectives_backward": traced.coll_backward.as_dict(),
        "roofline": terms,
        "model_flops": model_flops,
        "useful_flops_ratio": model_flops / (flops * cards) if flops
        else None,
        "params": cfg.param_count(),
        "active_params": n_active,
        "kernels": dict(sorted(tr.kernels.items())),
        "card": rates.name,
    }
    if average is not None:
        report["average_step"] = {
            "collective_per_card_bytes": average.coll.per_card_bytes,
            "collectives": average.coll.as_dict(),
            "t_collective_s": average.coll.per_card_bytes
            / rates.link_bytes_per_s,
            "argument_bytes_per_card": average.arg_bytes,
            "peak_bytes_per_card": average.tracer.peak,
            "note": "one all-reduce of the flat f32 member tree (on a "
                    "mesh: of this card's blocks, over 'pod') per "
                    "averaging event — the paper's entire communication "
                    "cost",
        }
    return report


def trace_combo(cfg, shape, mesh: str = "single",
                optimizer_name: str = "adamw") -> dict:
    """Trace ``cfg`` (an ``ArchConfig``, its shape adjustments applied by
    the caller) at ``shape`` (an ``InputShape``) on ``mesh`` and return
    the report."""
    multi = mesh == "multi"
    traced = trace(step_fn(cfg, shape, multi=multi,
                           optimizer_name=optimizer_name),
                   *step_args(cfg, shape, multi=multi,
                              optimizer_name=optimizer_name))
    average = trace_average(cfg) if multi and shape.kind == "train" \
        else None
    return report_of(cfg, shape, traced, cards=MEMBERS if multi else 1,
                     mesh=mesh, average=average)


def lower_combo(arch: str, shape_name: str, mesh: str,
                optimizer_name: str = "adamw", rules_override=None,
                cfg_override=None) -> dict:
    """The report of one (arch, shape, mesh) combo of the sweep; the
    overrides on the ``pod`` and ``multipod`` meshes only."""
    shape = INPUT_SHAPES[shape_name]
    cfg = shape_cfg(get_config(arch), shape)
    if mesh in LM_RULES:
        return trace_mesh_combo(cfg, shape, mesh, optimizer_name,
                                rules_override, cfg_override)
    if rules_override or cfg_override:
        raise ValueError(f"overrides run on the pod meshes, not {mesh!r}")
    return trace_combo(cfg, shape, mesh, optimizer_name)


def parse_set(items) -> dict:
    """``KEY=VALUE`` strings -> configuration fields, each value read as
    JSON where it parses (numbers, true/false) and as a string where it
    does not."""
    out = {}
    for item in items or ():
        key, sep, value = item.partition("=")
        if not sep:
            raise ValueError(f"--set takes KEY=VALUE, got {item!r}")
        try:
            out[key] = json.loads(value)
        except json.JSONDecodeError:
            out[key] = value
    return out


def combos():
    """(arch, shape name, supported) of every LM config x input shape; the
    paper's CNN-ELM is measured natively, not dry-run."""
    for arch in ARCH_IDS:
        if arch.startswith("cnn_elm"):
            continue
        ok = supported_shapes(get_config(arch))
        for shape_name in INPUT_SHAPES:
            yield arch, shape_name, ok[shape_name]


def summary(report: dict) -> str:
    """One line of a report: argument and peak bytes a card, FLOPs a card,
    the dominant roofline term and whether it fits the card."""
    mem, cost, roof = report["memory"], report["cost"], report["roofline"]
    t = max(roof["t_compute_s"], roof["t_memory_s"], roof["t_collective_s"])
    return (f"args/card={mem['argument_bytes_per_card'] / 1e9:.3f}GB "
            f"peak/card={mem['peak_bytes_per_card'] / 1e9:.3f}GB "
            f"flops/card={cost['flops_per_card']:.4g} "
            f"dominant={roof['dominant']} t={t:.4g}s fits={mem['fits']} "
            f"trace={report['trace_s']:.2f}s")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--mesh", choices=["single", "multi", "both", "pod",
                                       "multipod"], default="both")
    ap.add_argument("--out", default="experiments/dryrun_torch")
    ap.add_argument("--optimizer", choices=sorted(_OPTS), default="adamw")
    ap.add_argument("--rules", type=json.loads, default=None,
                    help="a rule override on the pod meshes, JSON: "
                         "logical axis -> candidate mesh axes, e.g. "
                         "'{\"ff\": [\"data\"]}'")
    ap.add_argument("--set", action="append", default=[],
                    metavar="KEY=VALUE",
                    help="a configuration field on the pod meshes, e.g. "
                         "moe_combine_sharding=batch (repeatable)")
    args = ap.parse_args(argv)
    cfg_override = parse_set(args.set)

    os.makedirs(args.out, exist_ok=True)
    meshes = {"single": ["single"], "multi": ["multi"],
              "both": ["single", "multi"], "pod": ["pod"],
              "multipod": ["multipod"]}[args.mesh]
    n_ok = n_skip = n_fail = 0
    t_all = time.perf_counter()
    for arch, shape_name, supported in combos():
        if args.arch and arch != args.arch:
            continue
        if args.shape and shape_name != args.shape:
            continue
        for mesh in meshes:
            tag = f"{arch}__{shape_name}__{mesh}"
            path = os.path.join(args.out, tag + ".json")
            if not supported:
                with open(path, "w") as f:
                    json.dump({"arch": arch, "shape": shape_name,
                               "mesh": mesh, "skipped": True,
                               "reason": "encoder-only: no decode step"},
                              f, indent=1)
                print(f"[skip] {tag} (encoder-only, documented)",
                      flush=True)
                n_skip += 1
                continue
            try:
                report = lower_combo(arch, shape_name, mesh, args.optimizer,
                                     args.rules, cfg_override)
                with open(path, "w") as f:
                    json.dump(report, f, indent=1)
                print(f"[ok] {tag} {summary(report)}", flush=True)
                n_ok += 1
            except Exception as e:
                n_fail += 1
                print(f"[FAIL] {tag}: {type(e).__name__}: {e}", flush=True)
                traceback.print_exc()
    print(f"done: ok={n_ok} skip={n_skip} fail={n_fail} "
          f"wall={time.perf_counter() - t_all:.1f}s")
    return 1 if n_fail else 0


if __name__ == "__main__":
    raise SystemExit(main())
