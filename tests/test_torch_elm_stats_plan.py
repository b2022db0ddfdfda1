"""The elm_stats kernel's plan (``kernels/elm_stats/ops.py``): which
instantiation a shape takes and how its rows split, a function of
(n, L, C) alone; and its operator's outputs on the meta device, where the
dry run counts the split's workspace. The kernel itself runs only on the
card (``tests/test_torch_cuda.py``)."""
import pytest
import torch

from repro_torch import kernels
from repro_torch.kernels.elm_stats import ops
from repro_torch.launch import dryrun

from test_torch_cuda import ELM_SHAPES, LONG_SHAPES

META = torch.device("meta")

# (n, L, C) of a member: E²LM's shards of 200,000 rows (k 1, 2, 4, 8), a
# whole shard of the Map, the heads over HuBERT-XLarge, the LM and RWKV6-3B,
# and the Map's batches (unmasked and ragged)
TABLE = [(200_000, 192, 10), (100_000, 192, 10), (50_000, 192, 10),
         (25_000, 192, 10), (12_500, 192, 10), (4096, 1280, 6),
         (512, 4096, 16), (512, 2560, 16), (200, 192, 10), (137, 144, 20)]
# one chunk, no workspace: the Map's and the mesh's batches, the stream's
# chunks, the CNN head's batches and the three heads
ONE_CHUNK = [(200, 192, 10), (137, 144, 20), (128, 192, 10),
             (500, 192, 10), (4096, 1280, 6), (512, 4096, 16),
             (512, 2560, 16)]


@pytest.mark.parametrize("n,L,C", TABLE)
def test_plan_is_the_same_whatever_k(n, L, C):
    """A member's instantiation and chunks do not depend on how
    many members share the launch: its block is the same bits at any k."""
    plans = [ops._plan(k, n, L, C) for k in (1, 2, 4, 8)]
    for k, p in zip((1, 2, 4, 8), plans):
        assert p._replace(workspace=None) == \
            plans[0]._replace(workspace=None) == \
            ops.plan(n, L, C)._replace(workspace=None)
        if p.chunks > 1:
            assert p.workspace[0] == k and p.workspace[1:] == \
                plans[0].workspace[1:]


@pytest.mark.parametrize("n,L,C", ONE_CHUNK)
def test_plan_keeps_one_chunk_where_the_grid_is_full_or_the_sum_short(
        n, L, C):
    for k in (1, 4):
        p = ops._plan(k, n, L, C)
        assert (p.chunks, p.passes, p.rows, p.workspace) == (1, 1, n, (0,))
    assert ops.plan(n, L, C).instantiation == \
        ("wide" if L >= ops.WIDE_MIN_L else "narrow")


def test_plan_splits_the_long_shards():
    """E²LM's shards and the Map's whole shard are cut into chunks of the
    strip: 200,000 rows into 131 of 1,536 (a block a chunk fills the card
    at k 1), 12,500 into 31 of 416."""
    p = ops.plan(200_000, 192, 10)
    assert (p.instantiation, p.tiles, p.chunks, p.rows,
            p.passes) == ("strip", 1, 131, 1536, 2)
    assert (ops.plan(12_500, 192, 10).rows,
            ops.plan(12_500, 192, 10).chunks) == (416, 31)
    for n in (100_000, 50_000, 25_000):
        assert ops.plan(n, 192, 10).chunks >= ops.STRIP_MIN_CHUNKS
    # rows too wide for the strip stay one chunk
    p = ops.plan(100_000, 300, 5)
    assert (p.instantiation, p.chunks, p.passes) == ("narrow", 1, 1)


def _valid(k, n, L, C):
    p = ops._plan(k, n, L, C)
    assert p.instantiation in ops.KINDS
    assert p.passes == (2 if p.chunks > 1 else 1)
    if p.instantiation == "narrow":
        assert p.chunks == 1 and p.tiles == ops.narrow_tiles(L, C)
    elif p.instantiation == "wide":
        assert p.chunks == 1 and p.tiles == ops.wide_tiles(L, C)
    else:
        assert p.chunks > 1 and p.tiles == 1
        assert ops.strip_subs(L, C) <= ops.STRIP_MAX_SUBS
        assert -(-(L + C) // ops.SUB) * ops.SUB <= ops.STRIP_MAX_COLS
    if p.chunks > 1:
        assert p.rows % ops.STAGE_ROWS == 0
        assert (p.chunks - 1) * p.rows < n <= p.chunks * p.rows
        assert p.workspace == (k, p.chunks, ops.SUB ** 2,
                               ops.strip_subs(L, C))
    else:
        assert p.rows == n and p.workspace == (0,)
    return p


@pytest.mark.parametrize("k,n,L,C", ELM_SHAPES + LONG_SHAPES)
def test_every_card_test_shape_has_a_valid_plan(k, n, L, C):
    _valid(k, n, L, C)


@pytest.mark.parametrize("k,n,L,C", [(1, 1, 1, 1), (1, 31, 5, 3),
                                     (3, 2047, 193, 1), (1, 2048, 192, 10),
                                     (2, 60_000, 7, 2), (1, 10**6, 64, 64),
                                     (1, 4000, 900, 4), (1, 40, 300, 5)])
def test_edge_shapes_have_a_valid_plan(k, n, L, C):
    _valid(k, n, L, C)


@pytest.mark.parametrize("n,L,C", [(50_000, 192, 10), (4096, 1280, 6),
                                   (200, 192, 10)])
def test_fake_returns_the_plans_workspace(n, L, C):
    """On the meta device the operator gives the stats and the partial
    sums' workspace in the plan's shape (empty where there is one
    chunk), so a trace holds the workspace as the card does."""
    k = 2
    h = torch.empty(k, n, L, device=META)
    t = torch.empty(k, n, C, device=META)
    out, part = kernels.OPS["elm_stats"](h, t, None)
    assert out.shape == (k, L, L + C) and out.dtype == torch.float32
    assert tuple(part.shape) == ops._plan(k, n, L, C).workspace
    assert part.dtype == torch.float32 and part.device == META


def test_dry_run_counts_the_workspace_and_the_formula():
    """The dry run's trace of a split launch: one operator call, the
    formula's FLOPs, and a peak that holds the stats and the workspace
    beside the operands."""
    k, n, L, C = 4, 50_000, 192, 10
    h = torch.empty(k, n, L, device=META)
    t = torch.empty(k, n, C, device=META)
    m = torch.empty(k, n, device=META)
    traced = dryrun.trace(lambda h, t, m: ops.elm_stats(h, t, mask=m),
                          h, t, m)
    tr = traced.tracer
    assert dict(tr.kernels) == {"elm_stats": 1}
    assert tr.kernel_flops == ops.elm_stats_flops(k, n, L, C, True)
    p = ops._plan(k, n, L, C)
    work = 4 * k * p.chunks * ops.SUB ** 2 * ops.strip_subs(L, C)
    assert p.instantiation == "strip" and p.chunks > 1
    assert tr.peak >= traced.arg_bytes + 4 * k * L * (L + C) + work
