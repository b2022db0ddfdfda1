"""The rank side of the port's mesh tests (``tests/test_torch_mesh*.py``).

``launch.mesh.run_ranks`` starts each rank as a fresh process that imports
this module, so it imports torch and ``repro_torch`` only; the JAX
side of every comparison runs in the pytest process. The data is made here
and there from the same seeds with the port's own numpy code, and the
initial weights come in as a numpy tree.

A case is a dict (``run_case``): the shards, the Map and Reduce settings,
and the mesh (``"flat"`` or ``"2d"``); ``cases_on_ranks`` runs a list of
them on every rank and returns, per case, the members, stats, averaged
model, hook models and the collectives' log as numpy.
"""
from __future__ import annotations

import torch

from repro_torch import convert
from repro_torch.checkpoint import run_state
from repro_torch.configs import get_reduced_config, replace
from repro_torch.core import e2lm, elm, faults
from repro_torch.core.executor import ExecutionPlan, make_executor
from repro_torch.core.reduce_strategies import Boosted, Gossip
from repro_torch.core.runner import (AveragingRun, ElasticEvent,
                                     ElasticSchedule, MapConfig,
                                     ReduceConfig)
from repro_torch.data.partition import (Partition, partition_iid,
                                        partition_unequal)
from repro_torch.data.synthetic import make_extended_mnist
from repro_torch.distributed import collectives
from repro_torch.launch.mesh import make_member_mesh
from repro_torch.optim.schedules import dynamic_paper
from repro_torch.tree import tree_leaves

CFG = replace(get_reduced_config("cnn_elm_6c12c"), elm_lambda=1.0)
BATCH = 16
LR = 0.05
UNEQUAL = (96, 64, 33)
WEIGHTS_SEEN: list = []         # the boosted weights each resolve returned


class RecordingBoosted(Boosted):
    """``Boosted`` that keeps every weight vector it hands the Reduce."""

    def weights(self, ctx):
        w = super().weights(ctx)
        WEIGHTS_SEEN.append([float(x) for x in w])
        return w


def shards(spec):
    """``("iid", k)`` or ``("unequal",)``: the shards of the test set."""
    ds = make_extended_mnist(n_per_class=20, seed=0)
    if spec[0] == "iid":
        return partition_iid(ds.x, ds.y, k=spec[1], seed=0)
    return partition_unequal(ds.x, ds.y, list(UNEQUAL), seed=1)


def validation() -> Partition:
    ds = make_extended_mnist(n_per_class=8, seed=3)
    return Partition(ds.x, ds.y)


def churn(parts, leave="m1"):
    """Join (a copy of shard 0) at round 0's boundary, a leave at round
    1's: k goes 3 → 4 → 3 across the blocks."""
    return ElasticSchedule((ElasticEvent(after_round=0, join=(parts[0],)),
                            ElasticEvent(after_round=1, leave=(leave,))))


def make_run(case, mesh=None) -> AveragingRun:
    """The case's ``AveragingRun``, on the mesh when one is given."""
    epochs = case.get("epochs", 0)
    strategy = case.get("strategy", "uniform")
    if strategy == "boosted":
        strategy = RecordingBoosted()
    elif strategy == "gossip":
        strategy = Gossip(rounds=case.get("gossip", 3))
    elastic = churn(shards(case["shards"])) if case.get("elastic") else None
    return AveragingRun(
        CFG, MapConfig(epochs=epochs,
                       lr_schedule=dynamic_paper(LR) if epochs else None,
                       batch_size=BATCH, chunk_batches=case.get("chunk"),
                       backend="stacked" if mesh is None else "mesh",
                       mesh=mesh),
        ReduceConfig(strategy=strategy, rounds=case.get("rounds", 1),
                     validation=(validation() if case.get("strategy")
                                 == "boosted" else None),
                     elastic=elastic))


def numpy_model(model):
    return [a.numpy().copy() for a in tree_leaves((model.cnn_params,
                                                   model.beta))]


def _result(res, hooks):
    if isinstance(res.members, dict):           # an elastic run
        return dict(members={n: numpy_model(m) for n, m in
                             res.members.items()},
                    averaged=numpy_model(res.averaged),
                    retired=[([a.numpy().copy() for a in tree_leaves(p)], w)
                             for p, w in res.group.retired_params],
                    hooks=hooks)
    return dict(members=[numpy_model(m) for m in res.members],
                averaged=numpy_model(res.averaged),
                stats=[a.numpy().copy() for a in res.stats],
                hooks=hooks, syncs=res.round_syncs)


def run_case(case, init_np, mesh=None):
    """Run one case on the CPU (stacked without a mesh, else the mesh)."""
    hooks = {}

    def hook(r, avg):
        hooks[r] = numpy_model(avg)

    del WEIGHTS_SEEN[:]
    res = make_run(case, mesh).run(
        shards(case["shards"]),
        init_params=convert.params_from_numpy(init_np, "cpu"), device="cpu",
        round_hook=hook if case.get("hook") else None)
    out = _result(res, hooks)
    out["weights"] = [list(w) for w in WEIGHTS_SEEN]
    return out


def stacked_case(case, init_np):
    """``run_case`` on the stacked backend with one intra-op thread, as
    every rank runs: torch's CPU kernels split their sums by the thread
    count, and SGD carries one ulp into every later step."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        return run_case(case, init_np)
    finally:
        torch.set_num_threads(threads)


def _log():
    return [(label, dict(counts)) for label, counts in collectives.LOG]


def _e2lm(case, init_np, mesh):
    """An epochs=0 Map on the mesh, then the E²LM readouts: its
    ``e2lm_global_beta``, this rank's members' stats through
    ``psum_stats``, and the gathered per-member stats."""
    ex = make_executor("mesh", mesh=mesh)
    out = ex.execute(CFG, convert.params_from_numpy(init_np, "cpu"),
                     shards(case["shards"]),
                     ExecutionPlan(batch_size=BATCH, device="cpu"))
    beta = ex.e2lm_global_beta()
    s = ex._last_stats
    local = (e2lm.reduce_stats([elm.ELMStats(s.u[i], s.v[i], s.n[i])
                                for i in range(s.u.shape[0])])
             if s.u.shape[0] else elm.zero_stats(s.u.shape[-1],
                                                 s.v.shape[-1], "cpu"))
    summed = e2lm.psum_stats(local, *ex._all)
    return dict(beta=beta.numpy().copy(),
                psum=[a.numpy().copy() for a in summed],
                stats=[a.numpy().copy() for a in out.stats])


def _crash_resume(case, init_np, mesh, ckpt_dir):
    """Crash right after round ``case["crash"]``'s checkpoint and resume
    from ``ckpt_dir`` (shared by the ranks), counting the checkpoint
    files this rank wrote."""
    writes = []
    save_round, save_elastic = (run_state.save_round,
                                run_state.save_elastic_round)

    def counted(save):
        def wrapper(*args, **kwargs):
            writes.append(args[1])
            return save(*args, **kwargs)
        return wrapper

    run_state.save_round = counted(save_round)
    run_state.save_elastic_round = counted(save_elastic)
    try:
        crashed, res = faults.run_crash_resume(
            make_run(case, mesh), shards(case["shards"]), ckpt_dir,
            unit="round", index=case["crash"],
            init_params=convert.params_from_numpy(init_np, "cpu"),
            device="cpu")
    finally:
        run_state.save_round = save_round
        run_state.save_elastic_round = save_elastic
    out = _result(res, {})
    out.update(crashed=crashed, resumed=res.resumed, writes=writes)
    return out


def cases_on_ranks(rank, world, cases, init_np, ckpt_dir=None):
    """Every case on this rank, in order (the same on every rank), each
    with the collectives' log of its run."""
    torch.manual_seed(0)
    meshes = {}

    def mesh(kind):
        if kind not in meshes:      # every rank builds the same meshes
            meshes[kind] = (make_member_mesh() if kind == "flat" else
                            make_member_mesh(hosts=2))
        return meshes[kind]

    out = []
    for case in cases:
        collectives.reset()
        m = mesh(case.get("mesh", "flat"))
        if case.get("kind") == "e2lm":
            r = _e2lm(case, init_np, m)
        elif case.get("kind") == "crash":
            r = _crash_resume(case, init_np, m,
                              f"{ckpt_dir}/{case['name']}")
        elif case.get("kind") == "refused":
            try:
                run_case(case, init_np, m)
                r = dict(error=None)
            except ValueError as e:
                r = dict(error=str(e))
        else:
            r = run_case(case, init_np, m)
        r["log"] = _log()
        out.append(r)
    return out


def report(rank, world):
    """(rank, world, backend) as this rank's group sees them."""
    import torch.distributed as dist
    return rank, world, dist.get_backend()


def fail_on_rank_1(rank, world):
    """Rank 1 raises; the others wait in an all-reduce it never joins."""
    if rank == 1:
        raise ValueError("rank 1 fails on purpose")
    collectives.all_reduce(torch.zeros(1))
    return rank


def lm_average_step(rank, world, stacked, weights):
    """``trainer.make_average_step`` over the default group on this rank's
    equal slice of the stacked LM members: (its averaged stack, whether
    the step made exactly one all-reduce, the count's detail)."""
    import torch.distributed as dist
    from repro_torch.core import trainer
    from repro_torch.tree import tree_map
    k_local = tree_leaves(stacked)[0].shape[0] // world
    local = tree_map(lambda a: a[rank * k_local:(rank + 1) * k_local]
                     .clone(), stacked)
    collectives.reset()
    with collectives.span("sync") as counts:
        out = trainer.make_average_step(weights, group=dist.group.WORLD)(
            local)
    check = collectives.check_one_all_reduce(counts)
    return out, check.ok, check.detail
