"""The port's runtime contract audit (``repro_torch.analysis.audit``), case
for case after the compiled-artifact half of ``tests/test_analysis.py``:
every audit green on the port's real programs on the CPU (the sequential,
stacked and mesh backends — the mesh over 2 and 4 gloo ranks, flat,
hierarchical and gossip — the average step with and without a group, and
the scorer), every check failing on a violation built for it (a gate that
cannot fail gates nothing), and the same program order, verdicts and
collective counts as ``repro.analysis.hlo`` on the same reduced config.
"""
import pytest
import torch
import torch.distributed as dist
import torch.nn.functional as F

from repro.analysis import hlo
from repro.configs.base import get_reduced_config as jget_reduced
from repro_torch import kernels
from repro_torch.analysis import audit
from repro_torch.configs import get_reduced_config
from repro_torch.core.averaging import broadcast_member_dim
from repro_torch.core.cnn_elm import StackedMembers
from repro_torch.distributed import collectives
from repro_torch.launch.mesh import make_member_mesh, process_group, run_ranks
from repro_torch.models import cnn
from repro_torch.serve import BucketedScorer
from repro_torch.serve.engine import CompileBudgetExceeded

import torch_mesh_ranks as ranks
from torch_bounded import bounded

torch.set_num_threads(2)

CFG = get_reduced_config("cnn_elm_6c12c")


def _ok(reports):
    for r in reports:
        assert r.ok, str(r)
        r.raise_if_failed()              # and the raising path is a no-op


def _checks(report):
    return {c.name: c for c in report.checks}


# ---------------------------------------------------------------------------
# Green on the port's programs
# ---------------------------------------------------------------------------

def test_audit_sequential_backend_green():
    reports = audit.audit_executor(CFG, "sequential", k=3, device="cpu")
    assert [r.program for r in reports] == ["sequential/average_trees"]
    _ok(reports)
    assert set(_checks(reports[0])) == {"f32-accumulation",
                                        "zero-collectives"}


def test_audit_stacked_backend_green():
    reports = audit.audit_executor(CFG, "stacked", k=3, device="cpu")
    assert [r.program for r in reports] == ["stacked/_sync",
                                            "stacked/_epoch"]
    _ok(reports)
    epoch = reports[1]
    assert set(_checks(epoch)) == {"carry-released", "zero-collectives"}
    # the route is skipped on the CPU, and says so: not a pass
    assert [name for name, _ in epoch.skipped] == ["hand-kernel-route"]
    assert "[skip] hand-kernel-route" in str(epoch)
    assert "freed" in _checks(epoch)["carry-released"].detail


@pytest.mark.parametrize("with_group", [False, True])
def test_audit_average_step_green(with_group):
    if not with_group:
        rep = audit.audit_average_step(device="cpu")
        assert rep.program == "trainer/make_average_step"
        assert set(_checks(rep)) == {"f32-accumulation", "zero-collectives"}
    else:
        with process_group(device="cpu"):
            rep = audit.audit_average_step(group=dist.group.WORLD,
                                           weights=[1.0] * 8, device="cpu")
        assert rep.program == "trainer/make_average_step@group"
        assert _checks(rep)["one-all-reduce"].detail == "{'all_reduce': 1}"
    _ok([rep])


def test_audit_mesh_one_rank_in_process():
    """NCCL's world-1 layout on gloo: the flat mesh (one all-reduce a sync
    and a Reduce, none in an epoch, a gossip ring of one exchanging
    nothing), the 2-D (1, 1) mesh (two all-reduces), and the 2-D mesh
    refusing gossip as the executor does."""
    with process_group(device="cpu"):
        flat = audit.audit_executor(CFG, "mesh", k=3, gossip_rounds=2,
                                    device="cpu")
        assert [r.program for r in flat] == [
            "mesh/_sync", "mesh/_mean", "mesh/_epoch", "mesh/_sync[gossip]"]
        _ok(flat)
        assert _checks(flat[3])["gossip-ring"].detail == "none"
        two = audit.audit_executor(CFG, "mesh", k=3, device="cpu",
                                   mesh=make_member_mesh(hosts=1))
        _ok(two)
        assert "two-all-reduces" in _checks(two[0])
        with pytest.raises(ValueError, match="gossip"):
            audit.audit_executor(CFG, "mesh", k=3, gossip_rounds=2,
                                 device="cpu",
                                 mesh=make_member_mesh(hosts=1))


@bounded(120)
def test_audit_mesh_flat_two_ranks_and_gossip():
    """Two gloo ranks on the flat mesh: one all-reduce a sync and a
    Reduce, none in an epoch, and T = 2 gossip rounds as exactly four ring
    exchanges with no all-reduce — on every rank."""
    per_rank = run_ranks(ranks.audit_mesh, 2, device="cpu",
                         args=(None, dict(k=4, gossip_rounds=2)))
    assert len(per_rank) == 2
    for reports in per_rank:
        _ok(reports)
        sync, mean, epoch, gossip = reports
        assert _checks(sync)["one-all-reduce"].detail == "{'all_reduce': 1}"
        assert _checks(mean)["one-all-reduce"].ok
        assert _checks(epoch)["zero-collectives"].detail == "none"
        assert _checks(gossip)["gossip-ring"].detail == \
            "{'ring_exchange': 4}"


@bounded(120)
def test_audit_mesh_hierarchical_four_ranks():
    """Four gloo ranks on the ('host', 'pod') = (2, 2) mesh: two
    all-reduces a sync and a Reduce (within a host, then across), none in
    an epoch."""
    per_rank = run_ranks(ranks.audit_mesh, 4, device="cpu",
                         args=(2, dict(k=4)))
    assert len(per_rank) == 4
    for reports in per_rank:
        _ok(reports)
        assert [r.program for r in reports] == ["mesh/_sync", "mesh/_mean",
                                                "mesh/_epoch"]
        for r in reports[:2]:
            assert _checks(r)["two-all-reduces"].detail == \
                "{'all_reduce': 2}"


def _tiny_scorer(max_batch=4):
    params_k = broadcast_member_dim(
        cnn.init_params(CFG, torch.Generator().manual_seed(0),
                        device="cpu"), 2)
    beta_k = torch.zeros((2, cnn.feature_dim(CFG), CFG.num_classes))
    return BucketedScorer(CFG, StackedMembers(params_k, beta_k),
                          max_batch=max_batch, device="cpu")


def test_audit_scorer_green_and_budget_violation_fails():
    scorer = _tiny_scorer()
    report = audit.audit_scorer(scorer, warm=True, device="cpu")
    assert report.ok, str(report)
    assert scorer.assert_compile_budget() == len(scorer.ladder.buckets)
    assert "serve/BucketedScorer" in str(report)
    # a program outside the pad ladder: one rogue shape scored
    scorer._shapes.add(3)
    assert not audit.audit_scorer(scorer, device="cpu").ok
    with pytest.raises(CompileBudgetExceeded):
        scorer.assert_compile_budget()


# ---------------------------------------------------------------------------
# Every check fails on a violation built for it
# ---------------------------------------------------------------------------

B = torch.ones((4, 4), dtype=torch.bfloat16)


@pytest.mark.parametrize("violation", [
    lambda: torch.add(B, B),
    lambda: B.clone().add_(B),              # in place
    lambda: B.sum(),
    lambda: torch.mm(B, B),
    lambda: B * 0.5,
    lambda: torch.cumsum(B, 0),
], ids=["add", "add_", "sum", "mm", "mul", "cumsum"])
def test_check_accum_dtype_fails_on_bf16_accumulation(violation):
    with audit.record() as rec:
        violation()
    check = audit.check_accum_dtype(rec.ops)
    assert not check.ok and "bfloat16 aten." in check.detail


def test_check_accum_dtype_passes_f32_sums_and_casts():
    with audit.record() as rec:
        s = B.float() + B.float()
        m = (s.sum(0) / 2).to(torch.bfloat16)      # cast AFTER the sum
        m.clone()
    check = audit.check_accum_dtype(rec.ops)
    assert check.ok, check
    assert any(op.base == "_to_copy" and op.dtypes == (torch.bfloat16,)
               for op in rec.ops)


def test_check_carry_released_fails_on_a_kept_carry():
    kept = []

    def step(carry):
        kept.append(carry)                 # a second live copy
        return {"w": carry["w"] * 2.0}

    carry = {"w": torch.ones(8), "b": torch.zeros(2)}
    refs = audit.carry_refs(carry)
    with audit.record() as rec:
        out = step(carry)
    del carry
    check = audit.check_carry_released(refs, rec.ops)
    assert not check.ok and "still alive" in check.detail
    kept.clear()                           # the copy goes: the check holds
    assert audit.check_carry_released(refs, rec.ops).ok
    assert out["w"].sum() == 16.0


def test_check_carry_released_passes_a_carry_written_in_place():
    def step(carry):
        carry["w"].mul_(0.5)
        carry["b"].zero_()
        return carry

    carry = {"w": torch.ones(8), "b": torch.ones(2)}
    refs = audit.carry_refs(carry)
    with audit.record() as rec:
        out = step(carry)
    check = audit.check_carry_released(refs, rec.ops)
    assert check.ok and "2 written in place" in check.detail
    assert [op.base for op in rec.ops if op.inplace] == ["mul", "zero"]
    assert out is carry


def test_check_one_all_reduce_fails_on_two_in_a_flat_span():
    with process_group(device="cpu"):
        x = torch.ones(4)
        with audit.record() as rec:
            collectives.all_reduce(x)
            collectives.all_reduce(x)
        assert not collectives.check_one_all_reduce(rec.collectives).ok
        assert collectives.check_two_all_reduces(rec.collectives).ok
        assert not collectives.check_no_collectives(rec.collectives).ok
        with audit.record() as rec:
            collectives.all_reduce(x)
        assert collectives.check_one_all_reduce(rec.collectives).ok
    # c10d's all-reduce is recorded as an op too
    assert [op.base for op in rec.ops] == ["allreduce"]


def test_check_hand_kernel_route_fails_on_a_library_op():
    x = torch.ones((1, 1, 6, 6))
    w = torch.ones((2, 1, 3, 3))
    with audit.record() as rec:
        F.conv2d(x, w)
    assert any(op.name.startswith("aten.convolution") for op in rec.ops)
    check = audit.check_hand_kernel_route({"conv2d": 1}, rec.ops,
                                          ["conv2d"])
    assert not check.ok and "library ops ran" in check.detail
    # a kernel that never launched fails too
    check = audit.check_hand_kernel_route({"conv2d": 1, "elm_stats": 0},
                                          [], ["conv2d", "elm_stats"])
    assert not check.ok and "no launch of ['elm_stats']" in check.detail
    with audit.record() as rec:
        torch.ones(3) + 1.0
    assert audit.check_hand_kernel_route(
        {"conv2d": 2, "elm_stats": 1}, rec.ops, ["conv2d", "elm_stats"]).ok


def test_check_compile_budget_fails_on_escaped_dispatch():
    class FakeLadder:
        buckets = (1, 2)

    class FakeScorer:
        ladder = FakeLadder()

        def compile_count(self):
            return 5

    check = audit.check_compile_budget(FakeScorer())
    assert not check.ok and "escaped the pad ladder" in check.detail
    assert not audit.audit_scorer(FakeScorer(), device="cpu").ok


def test_audit_report_raise_if_failed():
    rep = audit.AuditReport("fixture/broken")
    rep.checks.append(collectives.Check("one-all-reduce", False,
                                        "expected {'all_reduce': 1}"))
    rep.skipped.append(("hand-kernel-route", "the CPU"))
    assert not rep.ok and rep.failures
    assert "[FAIL] one-all-reduce" in str(rep) and "[skip]" in str(rep)
    with pytest.raises(audit.ContractViolation, match="fixture/broken"):
        rep.raise_if_failed()
    assert issubclass(audit.ContractViolation, AssertionError)
    assert audit.Check is collectives.Check       # one Check type


def test_audits_default_to_the_card(monkeypatch):
    """Every audit runs on the card unless the caller passes
    ``device="cpu"``: without one it raises, naming ``device='cpu'``."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (lambda: audit.audit_executor(CFG, "stacked"),
                 lambda: audit.audit_average_step(),
                 lambda: audit.audit_scorer(_tiny_scorer())):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
    with pytest.raises(ValueError, match="backend"):
        audit.audit_executor(CFG, "tpu", device="cpu")

    class CardScorer:
        device = torch.device("cuda")

    with pytest.raises(ValueError, match="runs on cuda"):
        audit.audit_scorer(CardScorer(), device="cpu")


def test_capture_guard_holds_under_the_audit(monkeypatch):
    """A hand-kernel launch into a CUDA graph capture that keeps no launch
    record raises inside ``audit.record()`` as it does outside it: the
    audit counts launches without a record of its own, so it takes no
    launch that the guard would refuse."""
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: True)
    for name in ("conv2d", "elm_stats"):
        with pytest.raises(RuntimeError, match="keeps no launch record"):
            kernels.launch(name)
        with audit.record() as rec:
            with pytest.raises(RuntimeError, match="keeps no launch record"):
                kernels.launch(name)
        assert rec.launches == {n: 0 for n in kernels.LAUNCHES}


# ---------------------------------------------------------------------------
# Parity with repro.analysis.hlo on the same reduced config
# ---------------------------------------------------------------------------

# the port's names of the reference's programs and checks
PROGRAMS = {"stacked/_round_sync": "stacked/_sync",
            "stacked/_stacked_epoch": "stacked/_epoch"}
CHECKS = {"donation-aliased": "carry-released"}
COLLECTIVE_CHECKS = {"zero-collectives", "one-all-reduce",
                     "two-all-reduces", "gossip-ring"}


def _summary(reports, programs=None, checks=None):
    programs, checks = programs or {}, checks or {}
    return [(programs.get(r.program, r.program),
             [(checks.get(c.name, c.name), c.ok) for c in r.checks],
             [c.detail for c in r.checks if c.name in COLLECTIVE_CHECKS])
            for r in reports]


@pytest.mark.parametrize("backend", ["sequential", "stacked"])
def test_audit_executor_matches_the_reference(backend):
    ref = hlo.audit_executor(jget_reduced("cnn_elm_6c12c"), backend, k=3)
    port = audit.audit_executor(CFG, backend, k=3, device="cpu")
    assert _summary(port) == _summary(ref, PROGRAMS, CHECKS)


def test_audit_average_step_matches_the_reference():
    ref = hlo.audit_average_step()
    port = audit.audit_average_step(device="cpu")
    assert _summary([port]) == _summary([ref])
    assert _summary([port])[0][2] == ["none"]
