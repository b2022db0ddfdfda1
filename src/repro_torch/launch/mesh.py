"""Member meshes over ``torch.distributed``, and ranks to run them on. The
port's counterpart of ``repro.launch.mesh``.

One rank per device, SPMD: every rank runs the same program, and the
member mesh says which members each rank holds
(``core.executor.MeshExecutor``).

* ``make_member_mesh`` — the flat 1-D ``('pod',)`` mesh, or the 2-D
  ``('host', 'pod')`` mesh, over an initialised process group. It never
  creates the group: the caller initialises it (``process_group``,
  ``run_ranks``, or ``torchrun`` and ``init_process_group``) and the
  mesh covers its ranks.
* ``make_lm_mesh`` — the LM's named (data, model) mesh, or (pod, data,
  model), over an initialised group (``LMMesh``: its axis sizes, this
  rank's coordinate and a sub-group per axis and per tuple of axes):
  NCCL on the card, gloo on CPU ranks, or the dry run's fake group;
  ``make_production_mesh`` builds the reference's 16 × 16 and 2 × 16 × 16
  shapes on it, ``make_host_mesh`` its (n, 1). ``distributed/ctx.py``
  runs a model on it.
* ``process_group`` — init and destroy one rank's group: gloo for
  ``device="cpu"``, NCCL for ``"cuda"``, a ``file://`` store, a timeout;
  the ranks leave together unless one raises.
* ``run_ranks`` — the counterpart of the reference's simulated host
  devices (``force_host_device_count``): ``world`` fresh processes, one
  rank each, started with the ``spawn`` method; each rank's result comes
  back, and a rank that raises fails the call once the others have
  reported or exited (or at the deadline), those still running killed
  rather than left waiting in a collective.
"""
from __future__ import annotations

import itertools
import math
import os
import pickle
import queue
import shutil
import tempfile
import time
import traceback
from contextlib import contextmanager
from datetime import timedelta
from typing import Callable, Dict, List, Mapping, Optional, Tuple

import torch
import torch.distributed as dist

from repro_torch import resolve_device
from repro_torch.distributed import sharding

DEFAULT_TIMEOUT_S = 300.0
# the reference's production meshes (its make_production_mesh)
PRODUCTION_MESHES = {"pod": {"data": 16, "model": 16},
                     "multipod": {"pod": 2, "data": 16, "model": 16}}
_BACKENDS = {"cpu": "gloo", "cuda": "nccl"}


def _backend(device) -> str:
    """gloo or NCCL for ``device``; raise for CUDA without a card, naming
    ``device='cpu'``, as every entry point of the port does."""
    return _BACKENDS[resolve_device(device).type]


def make_member_mesh(num_pods: Optional[int] = None, *,
                     hosts: Optional[int] = None, pods: Optional[int] = None):
    """The member mesh of ``MapConfig(backend="mesh")``: one slot of
    members per rank.

    Default: the flat 1-D ``('pod',)`` mesh over every rank of the
    initialised process group (``num_pods``, if given, must be its size),
    under which every Reduce and sync is ONE all-reduce. ``hosts=``
    builds the 2-D ``('host', 'pod')`` mesh instead: ``hosts`` machines of
    ``pods`` ranks each (``pods`` defaults to world // hosts), under which
    every Reduce and sync is an all-reduce within a host, then one across
    hosts. Raises without an initialised process group."""
    if not dist.is_available() or not dist.is_initialized():
        raise RuntimeError(
            "make_member_mesh needs an initialised torch.distributed "
            "process group (launch.mesh.process_group, run_ranks, or "
            "init_process_group under torchrun)")
    from torch.distributed.device_mesh import init_device_mesh
    world = dist.get_world_size()
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    if hosts is not None:
        if pods is None:
            if world % hosts:
                raise ValueError(
                    f"make_member_mesh: {world} ranks do not split over "
                    f"hosts={hosts}; pass pods= explicitly")
            pods = world // hosts
        if hosts * pods != world:
            raise ValueError(f"make_member_mesh: a ({hosts}, {pods}) mesh "
                             f"needs {hosts * pods} ranks, the group has "
                             f"{world}")
        return init_device_mesh(device_type, (hosts, pods),
                                mesh_dim_names=("host", "pod"))
    if pods is not None:
        raise ValueError("make_member_mesh: pods= requires hosts= "
                         "(use num_pods for the flat 1-D mesh)")
    n = world if num_pods is None else num_pods
    if n != world:
        raise ValueError(f"make_member_mesh: {n} pods, the group has "
                         f"{world} ranks (one rank per pod)")
    return init_device_mesh(device_type, (n,), mesh_dim_names=("pod",))


class LMMesh:
    """A named mesh of an LM over the ranks of an initialised process
    group, the counterpart of the reference's ``jax.make_mesh(shape,
    axes)``: ``shape`` maps axis names to sizes in the mesh's order
    (``sharding.resolve_spec`` reads it), ranks lie on it row-major, and
    ``coord`` is this rank's coordinate. ``group(entry)`` is the sub-group
    of the ranks that differ from this one only along an axis or a tuple
    of axes (a spec entry), in rank order, which is the order of the
    entry's blocks; ``label(entry)`` names it for
    ``distributed.collectives``."""

    def __init__(self, shape: Mapping[str, int], rank: int):
        self.shape = dict(shape)
        self.rank = rank
        self.coord, rest = {}, rank
        for axis in reversed(self.shape):
            self.coord[axis] = rest % self.shape[axis]
            rest //= self.shape[axis]
        self.coord = {a: self.coord[a] for a in self.shape}
        self._groups: Dict[Tuple[str, ...], object] = {}

    def group(self, entry):
        axes = sharding.entry_axes(entry)
        return self._groups[tuple(a for a in self.shape if a in axes)]

    def label(self, entry) -> str:
        return "+".join(sharding.entry_axes(entry))

    def size(self, entry) -> int:
        return sharding.entry_size(entry, self.shape)

    def index(self, entry) -> int:
        """This rank's block along a dimension sharded by ``entry``."""
        return sharding.entry_index(entry, self.coord, self.shape)

    def __repr__(self):
        return f"LMMesh({self.shape}, rank={self.rank}, coord={self.coord})"


def make_lm_mesh(shape: Mapping[str, int]) -> LMMesh:
    """An ``LMMesh`` of ``shape`` (axis name -> size, e.g. ``{"data": 2,
    "model": 2}``) over every rank of the initialised process group, whose
    size must be the mesh's. Each rank makes the sub-groups it belongs to
    (one per non-empty set of axes; the whole group where a set spans
    every rank), with local synchronisation, so no rank waits on groups
    it is not in."""
    if not dist.is_available() or not dist.is_initialized():
        raise RuntimeError(
            "make_lm_mesh needs an initialised torch.distributed process "
            "group (launch.mesh.process_group, run_ranks, "
            "init_process_group under torchrun, or the dry run's fake "
            "group)")
    world, rank = dist.get_world_size(), dist.get_rank()
    n = math.prod(shape.values())
    if n != world:
        raise ValueError(f"make_lm_mesh: a {dict(shape)} mesh needs {n} "
                         f"ranks, the group has {world}")
    mesh = LMMesh(shape, rank)
    strides, stride = {}, 1
    for a in reversed(list(shape)):
        strides[a] = stride
        stride *= shape[a]
    for r in range(1, len(shape) + 1):
        for subset in itertools.combinations(shape, r):
            base = rank - sum(mesh.coord[a] * strides[a] for a in subset)
            ranks = sorted(base + sum(i * strides[a] for a, i in
                                      zip(subset, idx))
                           for idx in itertools.product(
                               *(range(shape[a]) for a in subset)))
            mesh._groups[subset] = dist.group.WORLD if len(ranks) == world \
                else dist.new_group(ranks, use_local_synchronization=True)
    return mesh


def make_production_mesh(*, multi_pod: bool = False) -> LMMesh:
    """The reference's 16 × 16 (data, model) mesh, or its 2 × 16 × 16
    (pod, data, model) one, over a group of 256 (512) ranks — on this
    port, the dry run's fake group (``launch.dryrun``)."""
    return make_lm_mesh(PRODUCTION_MESHES["multipod" if multi_pod
                                          else "pod"])


def make_host_mesh() -> LMMesh:
    """An (n, 1) (data, model) mesh over the group's n ranks."""
    return make_lm_mesh({"data": dist.get_world_size(), "model": 1})


def axis_size(mesh, name: str) -> int:
    """The size of mesh axis ``name`` (1 for an axis the mesh lacks)."""
    names = tuple(mesh.mesh_dim_names or ())
    return mesh.size(names.index(name)) if name in names else 1


@contextmanager
def process_group(rank: int = 0, world: int = 1, *, device="cuda",
                  store: Optional[str] = None,
                  timeout_s: float = DEFAULT_TIMEOUT_S):
    """Initialise this process's rank of a ``world``-rank group (gloo on
    the CPU, NCCL on the card, which also makes card ``rank`` current),
    yield, and destroy the group: once every rank has finished its block,
    or at once if the block raises (its peers waiting to leave then leave
    too). ``store`` is the path of the file store every rank names
    (default: a fresh temporary file, which only a one-rank group can
    share)."""
    backend = _backend(device)
    tmp = None
    if store is None:
        if world != 1:
            raise ValueError("a group of several ranks needs the store "
                             "path they share")
        tmp = tempfile.mkdtemp(prefix="repro_torch_pg_")
        store = os.path.join(tmp, "store")
    if backend == "nccl":
        torch.cuda.set_device(rank)
    timeout = timedelta(seconds=timeout_s)
    group_store = dist.FileStore(store, world)
    group_store.set_timeout(timeout)
    dist.init_process_group(backend, store=group_store, rank=rank,
                            world_size=world, timeout=timeout)
    leave = dist.PrefixStore("leave/", group_store)
    try:
        yield
    except BaseException:
        if world > 1:
            leave.set("all", "1")     # the peers waiting to leave go now
        raise
    else:
        if world > 1:
            _leave_together(leave, world, timeout)
    finally:
        dist.destroy_process_group()
        if tmp is not None:
            shutil.rmtree(tmp, ignore_errors=True)


def _leave_together(leave, world: int, timeout: timedelta):
    """Return once every rank of the group has called it, or a rank's
    block has raised: counted in ``leave``, a prefix of the group's own
    store. A rank that tore its group down and exited while a peer still
    connected to it, or still waited for its last message of a collective,
    failed the peer with "Connection closed by peer"; a rank whose block
    raised leaves at once instead, so its peers' collectives fail rather
    than wait, and a peer already here leaves with it."""
    if leave.add("ranks", 1) == world:
        leave.set("all", "1")
    leave.wait(["all"], timeout)


def _rank_main(rank, world, device, store, timeout_s, fn, args, out):
    torch.set_num_threads(1)
    reported = False
    try:
        with process_group(rank, world, device=device, store=store,
                           timeout_s=timeout_s):
            try:
                result = fn(rank, world, *args)
            except BaseException:
                # reported before the group is torn down: the peers' lost
                # connections follow this error, they do not precede it
                out.put((rank, False, traceback.format_exc()))
                reported = True
                raise
        out.put((rank, True, pickle.dumps(result)))
    except BaseException:
        if not reported:
            out.put((rank, False, traceback.format_exc()))  # for the parent
        raise


def run_ranks(fn: Callable, world: int, *, device="cuda", args=(),
              timeout_s: float = DEFAULT_TIMEOUT_S) -> List:
    """Run ``fn(rank, world, *args)`` on ``world`` fresh processes, one rank
    of one group each (gloo for ``device="cpu"``, NCCL for ``"cuda"``,
    rank r on card r), and return the results in rank order. ``fn`` and
    ``args`` must be picklable (``fn`` a module-level function) and the
    results are pickled back, tensors copied.

    A rank that raises reports its traceback before its group is torn
    down, and fails the call once every other rank has reported (a peer's
    lost connection) or exited, or at ``timeout_s``; the ranks still
    running are then killed. So does a rank that dies without reporting,
    and a rank still running after ``timeout_s`` (which also bounds each
    rank's collectives)."""
    if world < 1:
        raise ValueError(f"world must be >= 1, got {world}")
    _backend(device)
    import multiprocessing as mp
    ctx = mp.get_context("spawn")
    tmp = tempfile.mkdtemp(prefix="repro_torch_ranks_")
    out = ctx.Queue()
    procs = [ctx.Process(target=_rank_main, daemon=True, args=(
        rank, world, device, os.path.join(tmp, "store"), timeout_s, fn,
        args, out)) for rank in range(world)]
    results, errors = {}, {}
    deadline = time.monotonic() + timeout_s

    def take(item):
        rank, ok, payload = item
        if ok:
            results[rank] = pickle.loads(payload)
        else:
            errors[rank] = payload

    def silent():
        """Ranks that exited without a report."""
        return [r for r, p in enumerate(procs) if r not in results
                and r not in errors and p.exitcode is not None]

    try:
        for p in procs:
            p.start()
        while len(results) + len(errors) < world:
            left = deadline - time.monotonic()
            if left <= 0:
                break
            try:
                take(out.get(timeout=min(left, 1.0)))
                continue
            except queue.Empty:
                pass
            if not silent():
                continue
            # a report sent just before its rank exited is still read
            while True:
                try:
                    take(out.get(timeout=0.1))
                except queue.Empty:
                    break
            if silent() and not errors:
                raise RuntimeError(f"run_ranks: rank(s) {silent()} exited "
                                   f"without a result")
            # after an error, wait until each other rank has reported (a
            # peer's lost connection) or exited
            if errors and len(silent()) + len(results) + len(errors) == world:
                break
        if errors:
            raise RuntimeError("run_ranks: " + "\n".join(
                f"rank {r} raised:\n{errors[r]}" for r in sorted(errors)))
        if len(results) < world:
            raise TimeoutError(
                f"run_ranks: ranks {sorted(set(range(world)) - set(results))}"
                f" did not finish in {timeout_s} s")
        for p in procs:
            p.join(timeout=max(1.0, deadline - time.monotonic()))
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
            if p.pid is not None:
                p.join()
        out.close()
        shutil.rmtree(tmp, ignore_errors=True)
    return [results[r] for r in range(world)]
