"""The runtime contract audit — the port's counterpart of
``repro.analysis.hlo``.

The reference lowers its programs and reads the compiled HLO. PyTorch runs
eagerly, so the port runs each program once and records what it did:

* every aten (and c10d) op the call dispatched — its output dtypes,
  whether it wrote an operand in place, and the storages it wrote —
  through ``OpRecorder``, a ``TorchDispatchMode`` (the mode
  ``torch.utils.flop_counter`` uses). Hand kernels reached through
  ``ctypes`` do not dispatch: their launches are the growth of
  ``kernels.LAUNCHES`` over the call (autograd's backward threads and the
  replays of graphs captured inside the call count there too);
* every ``torch.distributed`` collective, by ``collectives.span``.

Then it holds the record to the reference's contracts:

* **collective count** — the collective half is
  ``distributed.collectives``'s checks (one all-reduce a Reduce and a sync
  on the flat member mesh, two on the ``('host', 'pod')`` mesh, none in
  an epoch, ``2·T`` ring exchanges and no all-reduce under gossip);
* **accumulator dtype** (``check_accum_dtype``) — no add / multiply /
  reduction / product / all-reduce writes a bf16 or f16 result, even
  where the members are bf16; casts and copies may carry any dtype;
* **one live copy of a carry** (``check_carry_released``, in place of the
  reference's donation aliasing) — after the call returns and the caller
  drops its own reference, every tensor of the input carry was written
  in place or has been freed: the old state is gone before the next
  round needs the memory;
* **compile budget** (``check_compile_budget``) — a scorer holds at most
  one program (captured graph) per ladder bucket;
* **the hand-kernel route** (``check_hand_kernel_route``, on the card
  only) — the call launched each named hand kernel, and no library op
  computed the same function (cuDNN's convolution, SDPA, ``rms_norm``).
  On the CPU, where the plain versions run, it is reported as skipped.

``audit_executor(cfg, backend)``, ``audit_average_step()`` and
``audit_scorer(scorer)`` run the contract set of one surface each, on the
card unless the caller passes ``device="cpu"``. None raises on a broken
contract: each returns ``AuditReport``s, and ``raise_if_failed()`` turns
failures into ``ContractViolation``.
"""
from __future__ import annotations

import re
from collections import Counter
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Dict, Iterator, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch
from torch.multiprocessing.reductions import StorageWeakRef
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from repro_torch import kernels, resolve_device
from repro_torch.distributed import collectives
from repro_torch.distributed.collectives import (Check, check_gossip_sync,
                                                 check_no_collectives,
                                                 check_one_all_reduce,
                                                 check_two_all_reduces)
from repro_torch.tree import tree_leaves, tree_map

# ops that accumulate (the f32 floor applies to their results; casts,
# copies and views may carry any dtype), by overload packet without its
# in-place underscore; c10d's all-reduce is the cross-member sum
ACCUM_OPS = {"add", "sub", "rsub", "mul", "div", "sum", "mean", "mm", "bmm",
             "addmm", "baddbmm", "cumsum", "addmv", "mv", "dot", "allreduce"}
SUB_F32 = {torch.bfloat16, torch.float16}
# the library ops that compute what a hand kernel computes (by overload
# packet); elm_stats's U, V products have no library op of their own
_CONV = r"(convolution|(^|_)conv\d?d|conv_transpose|conv_depthwise|slow_conv)"
_SDPA = r"^_?scaled_dot_product"
_RMS = r"^(rms_norm|_fused_rms_norm)"
LIBRARY_OPS = {"conv2d": _CONV, "conv2d_wgrad": _CONV, "conv2d_dgrad": _CONV,
               "elm_stats": None, "rmsnorm": _RMS, "rmsnorm_bwd": _RMS,
               "swa_attention": _SDPA, "swa_attention_bwd": _SDPA}
# the hand kernels one SGD epoch of the CNN-ELM Map launches
EPOCH_KERNELS = ("conv2d", "conv2d_dgrad", "conv2d_wgrad", "elm_stats")
# the audited epoch's learning rate, and the seed of its init and data
LR, SEED = 0.05, 0


class ContractViolation(AssertionError):
    """A program broke one of the averaging contracts."""


@dataclass
class AuditReport:
    """The checks run against one program (or one surface's programs);
    ``skipped`` holds ``(check, reason)`` for checks that do not apply
    where the program ran (the hand-kernel route on the CPU)."""
    program: str
    checks: List[Check] = field(default_factory=list)
    skipped: List[Tuple[str, str]] = field(default_factory=list)

    @property
    def ok(self) -> bool:
        return all(c.ok for c in self.checks)

    @property
    def failures(self) -> List[Check]:
        return [c for c in self.checks if not c.ok]

    def raise_if_failed(self) -> "AuditReport":
        if not self.ok:
            raise ContractViolation(
                f"{self.program}: "
                + "; ".join(str(c) for c in self.failures))
        return self

    def __str__(self):
        lines = [f"audit {self.program}:"]
        lines += [f"  {c}" for c in self.checks]
        lines += [f"  [skip] {name}: {why}" for name, why in self.skipped]
        return "\n".join(lines)


# ---------------------------------------------------------------------------
# The record of one run
# ---------------------------------------------------------------------------

def _storage_key(t: torch.Tensor):
    return (t.device.type, t.device.index, t.untyped_storage().data_ptr())


class OpRecord(NamedTuple):
    """One dispatched op: ``name`` (``aten.add_.Tensor``), ``base`` (its
    overload packet without the in-place underscore: ``add``), its output
    tensors' dtypes, whether it wrote an operand, and the storages it
    wrote (as ``(device type, index, data pointer)``)."""
    name: str
    base: str
    dtypes: Tuple[torch.dtype, ...]
    inplace: bool
    written: frozenset


def op_record(func, args, kwargs, out) -> OpRecord:
    """The ``OpRecord`` of one call of ``func`` (an ``OpOverload``). Holds
    no tensor."""
    written = set()
    for i, a in enumerate(func._schema.arguments):
        if a.alias_info is None or not a.alias_info.is_write:
            continue
        val = kwargs[a.name] if a.name in kwargs else (
            args[i] if i < len(args) else None)
        written.update(_storage_key(t) for t in tree_flatten(val)[0]
                       if isinstance(t, torch.Tensor))
    packet = func.overloadpacket.__name__
    base = packet[:-1] if packet.endswith("_") and \
        not packet.endswith("__") else packet
    dtypes = tuple(t.dtype for t in tree_flatten(out)[0]
                   if isinstance(t, torch.Tensor))
    return OpRecord(str(func), base, dtypes, bool(written),
                    frozenset(written))


class OpRecorder(TorchDispatchMode):
    """Records every op dispatched while it is active (``ops``); the ops
    run as they would without it."""

    def __init__(self):
        super().__init__()
        self.ops: List[OpRecord] = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        self.ops.append(op_record(func, args, kwargs, out))
        return out


@contextmanager
def launch_counts() -> Iterator[Dict[str, int]]:
    """Yield a dict that holds, once the block closes, each hand kernel's
    launches inside it: the growth of ``kernels.LAUNCHES``."""
    before = dict(kernels.LAUNCHES)
    counts: Dict[str, int] = {}
    try:
        yield counts
    finally:
        counts.update({name: kernels.LAUNCHES[name] - before[name]
                       for name in before})


@dataclass
class Recording:
    """What one audited call did: its ops, its collectives (one span's
    counts) and its hand kernels' launches."""
    ops: List[OpRecord]
    collectives: Counter
    launches: Dict[str, int]


@contextmanager
def record(label: str = "audit") -> Iterator[Recording]:
    """Record the block: the ops it dispatches, the collectives it calls
    (a ``collectives.span(label)``) and the kernels it launches; the
    fields are complete once the block closes."""
    mode = OpRecorder()
    with collectives.span(label) as counts, launch_counts() as launches:
        rec = Recording(mode.ops, counts, launches)
        with mode:
            yield rec


# ---------------------------------------------------------------------------
# Check primitives
# ---------------------------------------------------------------------------

def check_accum_dtype(ops: Sequence[OpRecord], *,
                      name: str = "f32-accumulation") -> Check:
    """No accumulating op (add/sub/mul/div/sum/mean/mm/bmm/addmm/baddbmm/
    cumsum/all-reduce/..., in place or not) may write a bf16 or f16
    result: a bf16 running sum rounds every add and drifts O(k·2^-8) off
    the true mean across k members."""
    bad = sorted({f"{str(d).replace('torch.', '')} {op.name}" for op in ops
                  if op.base in ACCUM_OPS for d in op.dtypes
                  if d in SUB_F32})
    ok = not bad
    n = sum(op.base in ACCUM_OPS for op in ops)
    return Check(name, ok,
                 f"all {n} accumulating ops are f32+" if ok else
                 f"sub-f32 accumulating ops: {bad}")


class CarryRef(NamedTuple):
    """A weak reference to one tensor of an input carry: its leaf index,
    its storage (``expired()`` once freed) and the storage's key."""
    leaf: int
    storage: StorageWeakRef
    key: tuple


def carry_refs(tree) -> List[CarryRef]:
    """Weak references to every tensor of ``tree``, taken before the
    audited call; they keep nothing alive."""
    return [CarryRef(i, StorageWeakRef(t.untyped_storage()),
                     _storage_key(t))
            for i, t in enumerate(tree_leaves(tree))]


def check_carry_released(refs: Sequence[CarryRef], ops: Sequence[OpRecord],
                         *, name: str = "carry-released") -> Check:
    """After the audited call returned and its caller dropped the carry,
    every carry tensor was written in place (its storage is among those an
    op wrote) or freed: one live copy of the state, never two (the
    reference's ``check_donation``)."""
    written = set().union(*(op.written for op in ops)) if ops else set()
    in_place = [r for r in refs if r.key in written]
    alive = [r.leaf for r in refs
             if r.key not in written and not r.storage.expired()]
    ok = not alive
    return Check(name, ok,
                 f"{len(refs)} carry tensors: {len(in_place)} written in "
                 f"place, {len(refs) - len(in_place)} freed" if ok else
                 f"carry leaves {alive} still alive and never written in "
                 f"place — a second copy of the state outlived the call")


def check_compile_budget(scorer, *, name: str = "compile-budget") -> Check:
    """A serving scorer holds at most one program (captured graph) per
    ladder bucket (duck-typed on ``compile_count()`` + ``ladder``, so it
    audits ``BucketedScorer`` without importing repro_torch.serve)."""
    n = scorer.compile_count()
    budget = len(scorer.ladder.buckets)
    ok = n <= budget
    return Check(name, ok,
                 f"{n} captured programs for {budget} buckets "
                 f"{tuple(scorer.ladder.buckets)}"
                 + ("" if ok else " — a dispatch escaped the pad ladder"))


def check_hand_kernel_route(launches: Dict[str, int],
                            ops: Sequence[OpRecord],
                            names: Sequence[str], *,
                            name: str = "hand-kernel-route") -> Check:
    """Each kernel of ``names`` was launched at least once, and no
    recorded op is the library's version of the same function — the
    ground rule "the device decides": a CUDA tensor goes through the hand
    kernel, never a library call."""
    missing = [k for k in names if launches.get(k, 0) < 1]
    library = sorted({op.name for op in ops for k in names
                      if LIBRARY_OPS[k] is not None
                      and re.search(LIBRARY_OPS[k], op.base)})
    ok = not missing and not library
    got = {k: launches.get(k, 0) for k in names}
    detail = f"launches {got}, no library op"
    if missing:
        detail = f"no launch of {missing} (launches {got})"
    if library:
        detail += f"; library ops ran: {library}"
    return Check(name, ok, detail)


def _route(rep: AuditReport, rec: Recording, names, dev):
    if dev.type == "cuda":
        rep.checks.append(check_hand_kernel_route(rec.launches, rec.ops,
                                                  names))
    else:
        rep.skipped.append(("hand-kernel-route",
                            "the CPU runs the plain versions"))


# ---------------------------------------------------------------------------
# The audits: one call per surface
# ---------------------------------------------------------------------------

def _bf16(tree):
    return tree_map(lambda a: a.to(torch.bfloat16), tree)


def _shards(cfg, k: int, rows: int, seed: int):
    """k shards of ``rows`` random images and labels, from ``seed``."""
    from repro_torch.data.partition import Partition
    rng = np.random.default_rng(seed)
    c = cfg.image_channels
    img = ((cfg.image_size, cfg.image_size) if c == 1 else
           (cfg.image_size, cfg.image_size, c))
    return [Partition(rng.random((rows,) + img, dtype=np.float32),
                      rng.integers(0, cfg.num_classes, rows))
            for _ in range(k)]


def _audit_epoch(program, ex, cfg, params, parts, mine, plan, dev):
    """One SGD epoch of ``ex`` on the members ``mine``: the carry (the
    members' f32 params) released, no collective, the hand-kernel route."""
    from repro_torch.core.averaging import broadcast_member_dim
    # a carry of its own storage (one member's broadcast is a view of the
    # init, which this function keeps)
    params_k = tree_map(torch.clone, broadcast_member_dim(params, len(mine)))
    refs = carry_refs(params_k)
    rngs = [np.random.default_rng(plan.seed + i) for i in mine]
    with record(program) as rec:
        out = ex._epoch(cfg, params_k, [parts[i] for i in mine], plan, rngs,
                        dev, LR)
    del params_k                      # the caller lets go of the old state
    rep = AuditReport(program)
    rep.checks += [check_carry_released(refs, rec.ops),
                   check_no_collectives(rec.collectives)]
    _route(rep, rec, EPOCH_KERNELS, dev)
    del out
    return rep


def audit_executor(cfg, backend: str, *, mesh=None, k: int = 4,
                   batch_size: int = 8, num_batches: int = 2,
                   gossip_rounds: Optional[int] = None,
                   device="cuda") -> List[AuditReport]:
    """Run the named backend's programs once on bf16 (the syncs and the
    Reduce) and f32 (the epoch) members of ``cfg`` and hold them to their
    contract set. Returns one ``AuditReport`` per program; none raises.

    * ``"sequential"`` — the host Reduce behind ``average_models``
      (``average_trees``): f32 accumulation, zero collectives.
    * ``"stacked"`` — ``StackedExecutor._sync`` (f32 accumulation, zero
      collectives) and one SGD epoch ``_epoch`` (the carry released, zero
      collectives; on the card the conv2d, its dX and dW, and elm_stats
      kernels, and no library convolution).
    * ``"mesh"`` — over the initialised process group (``mesh``: the
      member mesh, None for the flat one): ``MeshExecutor._sync`` and the
      Reduce ``_mean`` (ONE all-reduce on the flat mesh, TWO on the
      ``('host', 'pod')`` mesh; f32 accumulation) and ``_epoch`` (zero
      collectives, the carry released, the route). With
      ``gossip_rounds=T`` also the gossip sync: exactly ``2·T`` ring
      exchanges (none on a ring of one) and no all-reduce.

    ``k`` members (the mesh: over all ranks), each epoch ``num_batches``
    batches of ``batch_size`` random images from ``SEED``, SGD at ``LR``.
    """
    from repro_torch.core import executor
    from repro_torch.core.averaging import average_trees, broadcast_member_dim
    from repro_torch.models import cnn

    if backend not in executor.BACKENDS:
        raise ValueError(f"backend must be one of {executor.BACKENDS}, "
                         f"got {backend!r}")
    dev = resolve_device(device)
    F, C = cnn.feature_dim(cfg), cfg.num_classes
    params = cnn.init_params(cfg, torch.Generator().manual_seed(SEED),
                             device=dev)
    parts = _shards(cfg, k, batch_size * num_batches, SEED)
    plan = executor.ExecutionPlan(epochs=1, lr_schedule=lambda e: LR,
                                  batch_size=batch_size, seed=SEED,
                                  gossip_rounds=gossip_rounds, device=dev)
    reports: List[AuditReport] = []

    if backend == "sequential":
        members = [(_bf16(params),
                    torch.zeros((F, C), dtype=torch.bfloat16, device=dev))
                   for _ in range(k)]
        program = "sequential/average_trees"
        with record(program) as rec:
            average_trees(members)
        rep = AuditReport(program)
        rep.checks += [check_accum_dtype(rec.ops),
                       check_no_collectives(rec.collectives)]
        return [rep]

    if backend == "stacked":
        ex = executor.StackedExecutor()
        program = "stacked/_sync"
        bf16_k = broadcast_member_dim(_bf16(params), k)
        with record(program) as rec:
            ex._sync(bf16_k, None, None)
        rep = AuditReport(program)
        rep.checks += [check_accum_dtype(rec.ops),
                       check_no_collectives(rec.collectives)]
        reports.append(rep)
        reports.append(_audit_epoch("stacked/_epoch", ex, cfg, params, parts,
                                    range(k), plan, dev))
        return reports

    import torch.distributed as dist
    ex = executor.MeshExecutor(mesh)
    ex._begin(cfg, k, plan, dev)
    # the per-sync collective budget is a function of the member-mesh
    # topology: one all-reduce flat, one per level on ('host', 'pod')
    sync_check = (check_two_all_reduces if len(ex._levels) > 1
                  else check_one_all_reduce)
    n = len(ex._mine)
    bf16_k = broadcast_member_dim(_bf16(params), n)

    program = "mesh/_sync"
    with record(program) as rec:
        ex._sync(bf16_k, None, None)
    rep = AuditReport(program)
    rep.checks += [sync_check(rec.collectives), check_accum_dtype(rec.ops)]
    reports.append(rep)

    program = "mesh/_mean"
    beta_k = torch.zeros((n, F, C), dtype=torch.bfloat16, device=dev)
    with record(program) as rec:
        ex._mean((bf16_k, beta_k), None)
    rep = AuditReport(program)
    rep.checks += [sync_check(rec.collectives), check_accum_dtype(rec.ops)]
    reports.append(rep)

    reports.append(_audit_epoch("mesh/_epoch", ex, cfg, params, parts,
                                ex._mine, plan, dev))

    if gossip_rounds is not None:
        program = "mesh/_sync[gossip]"
        with record(program) as rec:
            ex._sync(bf16_k, None, gossip_rounds)
        rep = AuditReport(program)
        rep.checks += [check_gossip_sync(
            rec.collectives, rounds=gossip_rounds,
            ring=dist.get_world_size(ex._ring[0])),
            check_accum_dtype(rec.ops)]
        reports.append(rep)
    return reports


def audit_average_step(*, weights: Optional[Sequence] = None, group=None,
                       params=None, k: int = 8, leaf_shape=(4, 3),
                       device="cuda") -> AuditReport:
    """Run ``trainer.make_average_step`` once — the launcher's averaging
    event — on a bf16 member tree (``params``, members on the leading dim
    of every leaf; default ``{"w": zeros((k, *leaf_shape)) bf16}``): f32
    accumulation, and with a process group ``group`` ONE all-reduce,
    without one none."""
    from repro_torch.core import trainer
    dev = resolve_device(device)
    if params is None:
        params = {"w": torch.zeros((k,) + tuple(leaf_shape),
                                   dtype=torch.bfloat16, device=dev)}
    if any(a.device.type != dev.type for a in tree_leaves(params)):
        raise ValueError(f"the member tree is not on {dev}")
    program = "trainer/make_average_step" + (
        "@group" if group is not None else "")
    step = trainer.make_average_step(weights=weights, group=group)
    with record(program) as rec:
        step(params)
    rep = AuditReport(program)
    rep.checks.append(check_accum_dtype(rec.ops))
    rep.checks.append(check_one_all_reduce(rec.collectives)
                      if group is not None
                      else check_no_collectives(rec.collectives))
    return rep


def audit_scorer(scorer, *, warm: bool = False,
                 device="cuda") -> AuditReport:
    """The serving contract on a live ``BucketedScorer``-like object on
    ``device``: its program count stays within the ladder's budget.
    ``warm=True`` first warms every bucket (on the card: captures every
    graph), so the audit covers the full ladder rather than whatever
    traffic happened to arrive."""
    dev = resolve_device(device)
    on = getattr(scorer, "device", None)
    if on is not None and torch.device(on).type != dev.type:
        raise ValueError(f"the scorer runs on {on}, the audit on {dev}")
    if warm:
        scorer.warmup()
    rep = AuditReport("serve/BucketedScorer")
    rep.checks.append(check_compile_budget(scorer))
    return rep

