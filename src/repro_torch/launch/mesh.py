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
* ``process_group`` — init and destroy one rank's group: gloo for
  ``device="cpu"``, NCCL for ``"cuda"``, a ``file://`` store, a timeout.
* ``run_ranks`` — the counterpart of the reference's simulated host
  devices (``force_host_device_count``): ``world`` fresh processes, one
  rank each, started with the ``spawn`` method; each rank's result comes
  back, and a rank that raises fails the call at once, the other ranks
  killed rather than left waiting in a collective.
"""
from __future__ import annotations

import os
import pickle
import queue
import shutil
import tempfile
import time
import traceback
from contextlib import contextmanager
from datetime import timedelta
from typing import Callable, List, Optional

import torch
import torch.distributed as dist

DEFAULT_TIMEOUT_S = 300.0
_ERROR_GRACE_S = 2.0     # after a rank's error, how long to collect others'
_BACKENDS = {"cpu": "gloo", "cuda": "nccl"}


def _backend(device) -> str:
    kind = torch.device(device).type
    if kind not in _BACKENDS:
        raise ValueError(f"device must be 'cpu' or 'cuda', got {device!r}")
    return _BACKENDS[kind]


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


def axis_size(mesh, name: str) -> int:
    """The size of mesh axis ``name`` (1 for an axis the mesh lacks)."""
    names = tuple(mesh.mesh_dim_names or ())
    return mesh.size(names.index(name)) if name in names else 1


@contextmanager
def process_group(rank: int = 0, world: int = 1, *, device="cpu",
                  store: Optional[str] = None,
                  timeout_s: float = DEFAULT_TIMEOUT_S):
    """Initialise this process's rank of a ``world``-rank group (gloo on
    the CPU, NCCL on the card, which also makes card ``rank`` current),
    yield, and destroy the group. ``store`` is the path of the ``file://``
    rendezvous every rank names (default: a fresh temporary file, which
    only a one-rank group can share)."""
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
    dist.init_process_group(backend, init_method=f"file://{store}",
                            rank=rank, world_size=world,
                            timeout=timedelta(seconds=timeout_s))
    try:
        yield
    finally:
        dist.destroy_process_group()
        if tmp is not None:
            shutil.rmtree(tmp, ignore_errors=True)


def _rank_main(rank, world, device, store, timeout_s, fn, args, out):
    torch.set_num_threads(1)
    try:
        with process_group(rank, world, device=device, store=store,
                           timeout_s=timeout_s):
            result = fn(rank, world, *args)
        out.put((rank, True, pickle.dumps(result)))
    except BaseException:
        out.put((rank, False, traceback.format_exc()))  # for the parent
        raise


def run_ranks(fn: Callable, world: int, *, device="cpu", args=(),
              timeout_s: float = DEFAULT_TIMEOUT_S) -> List:
    """Run ``fn(rank, world, *args)`` on ``world`` fresh processes, one rank
    of one group each (gloo for ``device="cpu"``, NCCL for ``"cuda"``,
    rank r on card r), and return the results in rank order. ``fn`` and
    ``args`` must be picklable (``fn`` a module-level function) and the
    results are pickled back, tensors copied.

    A rank that raises fails the call as soon as it reports, with its
    traceback and those the other ranks report within a moment (a peer's
    lost connection), and the other ranks are killed. So does a rank that
    dies without reporting, and a rank still running after ``timeout_s``
    (which also bounds each rank's collectives)."""
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
    try:
        for p in procs:
            p.start()
        while len(results) + len(errors) < world:
            left = deadline - time.monotonic()
            if errors:          # the others' reports follow within moments
                left = min(left, grace - time.monotonic())
            if left <= 0:
                break
            try:
                rank, ok, payload = out.get(timeout=min(left, 1.0))
            except queue.Empty:
                dead = [r for r, p in enumerate(procs) if r not in results
                        and r not in errors and p.exitcode is not None]
                if dead and not errors:
                    raise RuntimeError(f"run_ranks: rank(s) {dead} exited "
                                       f"without a result")
                continue
            if ok:
                results[rank] = pickle.loads(payload)
            else:
                if not errors:
                    grace = time.monotonic() + _ERROR_GRACE_S
                errors[rank] = payload
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
