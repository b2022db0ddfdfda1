#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each printing one JSON line; any failure raises, so the exit code
is non-zero and no result line is printed:

1. env     — the card (``nvidia-smi`` name and power limit), torch and CUDA
             versions, the TF32 flags (both must be off).
2. build   — compiles ``src/repro_torch/csrc/*.cu`` with nvcc into build/;
             ptxas's registers, shared memory and spills per kernel.
3. kernels — every kernel against its plain PyTorch version on the card
             at its path's shapes (conv2d also at a one-image scoring
             request) (f32: rtol 1e-5, atol 1e-5 · max|ref|;
             bf16 outputs: one bf16 ulp, rtol 2⁻⁷, atol 1e-5 · max|ref|),
             with kernel, plain-version and library device times
             (torch.profiler over 100 calls after warm-up), their per-call
             times with host overhead (CUDA events), the card's bound for
             the same work, and ``vs_library`` = kernel ms / library ms;
             elm_stats's U must equal its transpose bitwise. The conv's
             backward at the SGD Map's shapes — dW (conv2d_wgrad) at both
             stages and at stage 1 of cnn_elm_3c9c, dX (conv2d_dgrad) at
             stage 2 — is held against the f64 plain version: within twice
             the f32 plain version's own distance from it, or
             1e-5 · max|ref|, whichever is larger; dX must also equal the
             forward kernel on padded dY with turned weights value for
             value; its library is cuDNN's grouped backward. The LM
             kernels' backward at the train step's shapes — rmsnorm_bwd at
             ln 512 × 4096, q_norm 16384 × 128 and Zamba2's ln 512 × 2048,
             swa_attention_bwd at the
             prefill shape, at S 1024, window 256, at OLMoE-1B-7B's prefill
             (H 16/16) and at one 4,096-token sequence of Qwen3-8B (B 1,
             H 32/8, the reference's train_4k shape), bf16 — against their
             plain versions (2 bf16 ulps of max|ref|, or twice the plain
             version's own distance from the f64 function) and bitwise the
             same run to run; plain = torch autograd of the plain forward,
             library = the backward of ``F.rms_norm`` and of SDPA. The
             causal swa_attention forward at the prefill, S 1024 W 256, q
             scaled by 8, Zamba2's shared block, OLMoE-1B-7B's prefill and
             the 4,096-token sequence, each bitwise the same run to run;
             the causal f32 route (the parity path's), forward and
             backward, at phase lm_parity's B 2, S 16 and phase elm_head's
             B 4, S 128 (H 32/8, hd 128), under the same bars. Also
             swa_attention's non-causal mode (the encoder's) at
             HuBERT-XLarge's B 4, S 1024, H 16, hd 80 in bf16, a ragged S
             1000 and a small f32 case (library: SDPA with
             is_causal=False), its backward (swa_attention_bwd's
             non-causal mode, the same three cases, under the backward's
             rule; library: SDPA's backward with is_causal=False), and
             elm_stats at the HuBERT head (k 1, n 4,096, L 1,280, C 6) and
             the RWKV6-3B head (k 1, n 512, L 2,560, C 16). Zamba2-1.2B's
             serving shapes: rmsnorm at 512 × 2048 (f32 scale) and
             swa_attention at B 4, S 128, H 32/32, hd 64, bf16.
4. map     — the epochs=0 Map → Reduce at full width (cnn_elm_6c12c, 60,000
             synthetic extended-MNIST images, 10,000 held out, k = 4, batch
             200) on the card, stacked and sequential, held against the
             same run on the port's CPU path; then the held-out set scored.
5. sgd     — the paper's Table 5 setting on the same shards: two SGD
             epochs at dynamic_paper(0.05), batch 200, stacked with one
             round, sequential, and stacked with two rounds: wall,
             images/s (epochs × images / wall) and launches (per step: 2
             conv2d, 1 conv2d_dgrad, 2 stages × WGRAD_PASSES of
             conv2d_wgrad, 1 elm_stats);
             card sequential vs card stacked (CNN weights within
             1e-4 · max|w| per leaf, and β, scores and predictions as in
             ``map``); card vs the port's CPU path on the first 2,500 rows
             of each shard at full width, one epoch and the two-round run,
             under the same gates; the averaged model's accuracy must stay
             above the epochs=0 model's less 0.05.
6. mesh    — the scale-out Map (``MapConfig(backend="mesh")``) over
             NCCL at world size 1, in this process, on the flat and the
             2-D (1, 1) member meshes, on ``map``'s shards at full width:
             the epochs=0 Map → Reduce and ``sgd``'s two-epoch two-round
             run, each bitwise the card's stacked run (members, stats, β,
             averaged model; held-out scores at epochs=0) with its
             launches; the collectives counted per span (none in an
             epoch, one all-reduce a Reduce and a sync, two on the 2-D
             mesh, one all-gather a snapshot and a boosted weight
             resolve); shard_weighted and boosted Reduces bitwise the
             stacked ones (the same weights); ``e2lm_global_beta``
             bitwise ``e2lm.mapreduce_solve`` of the same stats; the
             two-round run crashed after round 0 and resumed, bitwise;
             walls and images/s beside the stacked run's, taken in turns,
             and one all-reduce of the flat 3,888-float vector (CUDA
             events); and two gloo ranks sharing the card
             (``run_ranks``), the epochs=0 Map's members bitwise the
             stacked run's and its average within rtol 1e-5.
7. serve   — a bucketed scorer, one captured CUDA graph per bucket,
             answering requests of 1, 3, 17 and 64 images, checked against
             the ensemble surface; launches counted over the replays; the
             graph count after warm-up and after one hot swap; whether a
             row scores the same bits in every bucket (the plain eager pass
             and the graphs: rows 0 and 0..6 alone against the same rows
             in every larger bucket); an ``EnsembleServer`` under
             ``run_open_loop`` in ``benchmarks/serve_ensemble.py``'s
             settings (max_batch 32, max_wait 4 ms, 600 requests at 100,
             200, 400 and 800 /s, a swap mid-sweep): zero failed and zero
             dropped, p50/p95/p99, images/s and mean occupancy per rate;
             the same endpoint once through ``python -m
             repro_torch.launch.serve --ensemble`` at 200 /s.
8. stream  — the streaming Map at full width in
             ``benchmarks/stream_map.py``'s settings (3 class-skewed
             members, 48 chunks of 128 rows, a label permutation at chunk
             24, window 8, cadence 12, held-out 16, epochs 0, batch 32):
             the never, cadence and drift policies, stacked and
             sequential, wall and launches per chunk; card sequential vs
             card stacked and the card vs the port's CPU path (the same
             syncs; β, the published β and its held-out scores within the
             solve bars of ``map``, the published backbone within
             1e-4 · max|w|); the window gate after evictions;
             ``prefetch=2`` bitwise; drift syncs after chunk 24 and a
             published model that beats the never-sync one; one run under
             torch.profiler (device idle share of a chunk); the drift run
             again with a live ``EnsembleServer`` and
             ``CheckpointWatcher`` on its checkpoints under traffic: the
             newest round staged, zero failed and dropped, post-swap
             scores bitwise those of direct scoring, no new graph.
9. profile — one stacked Map and one stacked SGD epoch under
             torch.profiler: device busy, wall, idle share, top operations.
10. e2lm   — E²LM at ``benchmarks/e2lm_scaling.py``'s shape (200,000 rows,
             L 192, C 10, λ 100, from a seed): per-shard stats for k 2, 4
             and 8 through ``e2lm.mapreduce_solve`` within the solve bar of
             the monolithic β (1e-3 · max|β|, or twice its own f32 distance
             from the f64 solution, whichever is larger); the ``map``
             phase's global β from its ``RunResult.stats``, card vs CPU,
             within the same bar; OS-ELM in 50-row blocks against the batch
             solve (rtol 5e-2, atol 5e-3); elm_stats timed at 25k, 50k,
             100k and 200k rows a member (each record prints its plan;
             the path's launches are the plans' passes).
11. elm_head — the ELM head: over the CNN (the Map's init, its 50,000
             images, the held-out set scored, 4 ``finetune_step``s whose
             loss must fall), over the full qwen3_8b in bf16
             (``hidden_states`` of 4 × 128 tokens, C 16, λ 10; elm_stats
             timed at that shape), and the 2-layer full-width f32 LM's
             states and head β, card vs CPU (1e-4 · max|h|; the solve
             bar), then one ``finetune_step`` of it through the backward
             kernels, card vs CPU (loss rtol 1e-4, leaves 1e-4 · max|leaf|).
12. resume — crash and resume at full width with the ``sgd`` phase's
             settings: the stacked two-round run after round 0 (a torn
             round-1 file must be skipped), the sequential run after
             member 1, and an elastic run with one leave and one join
             (stacked vs sequential, and its resume): each equal to its
             uninterrupted run under ``torch.equal``.
13. lm     — the LM serving path (``repro_torch.launch.serve``): (a) qwen3_8b
             at full width cut to 2 layers, f32, the card against the port's
             CPU path on the same params (prefill and 4 greedy decode steps
             within 1e-4 · max|logit|, equal tokens); (b) the full 36-layer
             qwen3_8b in bf16 through ``run_lm`` at batch 4, prompt 128,
             gen 32: prefill ms, decode tokens/s, peak device memory, the
             gap between the prefill's and the replay's last logits, and the
             device-idle share of a decode step: its device busy time
             (torch.profiler, one step) over the mean step of 10 unprofiled
             steps and over the mean step of run_lm's own decode loop.
13a. lm_mesh — (b) again under ``distributed.ctx.use_mesh_rules`` on a
             (data 1 × model 1) ``make_lm_mesh`` mesh over NCCL at world
             size 1 in this process: the same tokens, the prefill's and
             the last step's logits bitwise equal to (b)'s, the same
             launches, and no collective (an axis of size 1 moves
             nothing); its prefill ms and tokens/s beside (b)'s first
             run's.
13b. pod   — rank 0 of the reference's 16 × 16 (data, model) mesh at its
             own local shapes, under a fake process group of 256 ranks
             (``launch.dryrun.lm_mesh``): Qwen3-8B's prefill_32k (B 2 of
             32, S 32,768, 2 q heads and their one KV head), its
             decode_32k (B 8 of 128, 2,048 cache positions) and
             OLMoE-1B-7B's prefill_32k (4 of 64 experts, 1 head), each on
             random blocks and held against the dry run's trace of the
             same combo: operator calls, argument bytes (the reference
             layout's per-chip bytes), FLOPs, and the collectives' calls
             and bytes by axis, all exactly; printed, not held: the peak
             over the trace's and the busy time over the roofline.
14. zoo    — the LM zoo's transformer families: (a) f32, full
             width cut to 2 layers, the card against the port's CPU path
             within 1e-4 · max|logit|: olmoe_1b_7b's prefill and 4 greedy
             decode steps (equal tokens; the routers' top-k sets counted
             on both sides, with the smallest top-k margin), hubert_xlarge's
             encode logits and hidden states, internvl2_26b's prefill with
             1,024 patch slots and 16 text tokens; (b) olmoe_1b_7b (64
             experts, top 8) and minicpm_2b at full size in bf16 through
             ``run_lm`` as phase ``lm`` runs qwen3_8b (launches exact:
             rmsnorm (2 L + 1) a forward, swa_attention L); (c)
             hubert_xlarge at full size in bf16: the encode of 4 × 1,024
             frames (one non-causal swa_attention a layer, 2 L + 1
             rmsnorm), then the ELM head on ``tests/test_elm_head.py``'s
             frame task over 6 batches at λ 100, held-out accuracy above
             0.5 (elm_stats launches counted), then one
             ``finetune_step`` at lr 1e-2 on the held-out batch through
             the non-causal swa_attention_bwd (launches exact; the loss
             falls); and in (a), one ``finetune_step`` of the 2-layer f32
             encoder's head, card vs CPU (loss rtol 1e-4; the gradient of
             its ELM loss leaf by leaf within 1e-4 · max|leaf|, or twice
             the CPU's distance from its one-ulp twin's); (d)
             internvl2_26b at full
             width cut to 8 of 48 layers: ``api.prefill`` of 4 × 128
             tokens behind 1,024 patch slots and 32 greedy decode steps
             (launches exact, logits finite, prefill ms, tokens/s).
15. recurrent — the LM zoo's recurrent families: (a) f32, full width cut
             to 2 layers (Zamba2 with one shared invocation), batch 2, 32
             prompt tokens, card vs the port's CPU path: RWKV6's chunked
             prefill and Zamba2's, then 4 greedy decode steps (logits
             within 1e-4 · max|logit| or twice the CPU's one-ulp twins'
             distance; tokens equal but on a row whose two largest CPU
             logits lie within twice that distance), and one ``loss_fn``
             gradient of each
             (Zamba2's through swa_attention_bwd and rmsnorm_bwd; launches
             exact; leaves by the same rule); (b) rwkv6_3b and zamba2_1p2b
             at full size in bf16 through ``run_lm`` as phase ``lm``
             (launches exact: none for RWKV6; rmsnorm 2 L + 2 I + 1 a
             forward and swa_attention I in the prefill for Zamba2, over
             its I shared invocations); (c) the ELM head over the full
             RWKV6-3B (4 × 128 tokens, C 16, λ 10; one elm_stats launch);
             (d) recorded: the full-depth RWKV6's chunked forward against
             its scan (bf16, the deepest log-decay sum inside a chunk) and
             ROADMAP R7 at full size (Zamba2's decode after a prefill
             against its forward, and from a cache padded by 4 slots).
16. train  — the LM training path (``repro_torch.launch.train``): qwen3_8b
             at full width cut to 4 layers, 2 members, AdamW, cosine, 4
             steps of 4 × 128 tokens, --rounds 2: losses finite, the
             average's held-out loss beside the members', launches exact
             (the layers recomputed in the backward), peak memory, step
             walls; remat bitwise the kept activations (gradients and an
             SGD step's params); member steps on one repeated batch
             (the loss falls step by step), one of them profiled; killed
             after step 2 and resumed, bitwise; reduced f32 SGD card vs
             CPU (1e-4 · max|leaf|, or twice the CPU's one-ulp twin's
             distance where the run is ill-conditioned); one SGD step of
             the whole 36-layer model (wall, peak memory).
17. audit  — the runtime contract audit (``repro_torch.analysis.audit``)
             on the card, one line per audited program (each check's name,
             verdict and detail; checks that do not apply listed as
             skipped), then its wall: ``audit_executor`` on cnn_elm_6c12c
             at full width (k 4, the ``map`` phase's batch) for the
             sequential backend (``average_trees`` of bf16 members: f32
             accumulation, no collective), the stacked one (``_sync`` of
             bf16 members; one SGD epoch ``_epoch``: the carry released,
             no collective, and the conv2d, conv2d_dgrad, conv2d_wgrad
             and elm_stats kernels launched with no library convolution)
             and the mesh over NCCL at world size 1 in this process (the
             flat mesh with 2 gossip rounds, the 2-D (1, 1) mesh: one /
             two all-reduces a sync and a Reduce, none in an epoch, a ring
             of one exchanging nothing, the epoch's route);
             ``audit_scorer`` on the ``serve`` phase's scorer, which that
             phase warmed (no more graphs than buckets);
             ``audit_average_step`` on a bf16 two-member tree of qwen3_8b
             at full width cut to 4 layers (f32 accumulation, no
             collective). Any failed check fails the run.
18. dryrun — the dry run (``repro_torch.launch.dryrun``) held against
             the card: the full 36-layer qwen3_8b's bf16 prefill of 4 ×
             128 and one decode step against a cache of 160 (on phase
             ``train``'s full-depth params), and ``train``'s member step
             (4 layers, AdamW, 4 × 128), each traced on the meta device
             and then run once on the card under ``FlopCounterMode``: the
             kernel operators' calls by name equal the step's launches,
             the argument bytes the storages the card's step takes, the
             FLOPs the card's count, all exactly; printed: the estimated
             peak over the card's and the device's busy time over the
             roofline time (data-sheet rates of
             ``launch.cost_analysis``); then the phase's wall.
19. the kernels line (after a line of swa_attention_bwd's launches by
   mode), the card line, and the last line
   ``{"ok": true, "device": {...}}``.

The launch counters are set to 0 just before each path runs and read just
after it: the CNN main path (stacked Map → Reduce → scoring of the
held-out set), the sequential Map, each SGD Map (the stacked one-round run
is the SGD main path, whose conv2d_dgrad and conv2d_wgrad counts the
kernels line reports), each mesh Map (the flat mesh's epochs=0 and SGD
runs add to the kernels line's counts), serving (the replays of its captured graphs,
which the kernels line adds to conv2d's count), the open-loop sweep, each
streaming run (the stacked drift run's conv2d and elm_stats counts are
added to the kernels line's), the E²LM path, the CNN and LM heads, the
LM head's finetune step, the crash/resume runs, the LM path (b), the zoo's
paths (b)–(d) and the recurrent paths (a)–(c) (whose rmsnorm,
swa_attention, elm_stats and backward counts the kernels line adds), and
the train path's full-width run (whose rmsnorm_bwd and swa_attention_bwd
counts the kernels line reports, and whose forwards it adds to the
serving path's rmsnorm and swa_attention counts), the LM path under the
world-1 mesh and each of the pod phase's three steps (whose rmsnorm and
swa_attention counts the kernels line adds), and each of the
dryrun phase's three steps (held against the trace, not added to the
kernels line).
"""
from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

SERVE_MAX_BATCH = 64    # the bucketed scorer's largest request
TOL = 1e-5          # kernel vs plain version: rtol, and atol · max|ref|
BF16_RTOL = 2.0 ** -7   # one bf16 ulp, for bf16 outputs
REPS = 100


def emit(phase, **fields):
    print(json.dumps({"phase": phase, **fields}), flush=True)


def check(ok, what):
    if not ok:
        raise RuntimeError(f"chip_smoke check failed: {what}")


def card_line():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def peaks(name):
    """(the table's key, (f32 FLOP/s on CUDA cores, device-memory bytes/s,
    dense bf16 tensor-core FLOP/s)) of the card named ``name``, from
    NVIDIA's data sheets in ``repro_torch.launch.cost_analysis.CARDS`` (the
    SXM part unless nvidia-smi names another)."""
    from repro_torch.launch.cost_analysis import CARDS, card_key
    key = card_key(name)
    card = CARDS[key]
    return key, (card.f32_flops, card.hbm_bytes_per_s, card.bf16_flops)


def call_ms(torch, fn, reps=REPS):
    """Mean ms per call of ``fn`` over ``reps`` calls after warm-up, by CUDA
    events: host overhead included wherever it outlasts the device work."""
    for _ in range(10):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def device_activity(torch, prof):
    """(device µs, name, count) of every device activity (kernels, copies)
    a profiler saw; the CPU ops that launched them are left out, since they
    carry the same device time again."""
    return [(evt.self_device_time_total, evt.key, evt.count)
            for evt in prof.key_averages()
            if evt.device_type == torch.autograd.DeviceType.CUDA
            and evt.self_device_time_total > 0]


def device_ms(torch, fn, reps=REPS, attempts=5):
    """Mean device time per call of ``fn`` (all its kernels and copies) over
    ``reps`` calls after warm-up, from torch.profiler's device trace: the
    kernel's own time, whatever the host spends launching it. Now and then
    a profiled window comes back with its launches but none or only some of
    its kernels (the profiler asked for a new activity buffer inside it,
    and those records were not delivered before it closed): a window in
    which some kernel ran other than a whole multiple of ``reps`` times is
    profiled again after a pause, up to ``attempts`` windows in all (if
    none is whole, the largest total is taken, since a lost record only
    ever lowers it, and a line on stderr says so)."""
    from torch.profiler import ProfilerActivity, profile
    for _ in range(10):
        fn()
    torch.cuda.synchronize()
    for attempt in range(attempts):
        if attempt:
            time.sleep(0.5)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        rows = device_activity(torch, prof)
        total_us = sum(us for us, _, _ in rows)
        if rows and all(count % reps == 0 for _, _, count in rows):
            return total_us / reps / 1e3
        best = max(best, total_us) if attempt else total_us
    check(best > 0, f"the profiler saw no device time in {attempts} windows")
    print(f"device_ms: no whole window of {reps} calls in {attempts}; "
          f"took the largest", file=sys.stderr, flush=True)
    return best / reps / 1e3


def bound_ms(nbytes, flops, rates, bf16=False):
    """The least time for the work: bytes over the memory rate, or the
    operations over the peak rate of their type (bf16 tensor cores for bf16
    operands, the f32 CUDA cores otherwise), whichever is larger."""
    flop_rate, byte_rate, bf16_rate = rates
    t_bytes = nbytes / byte_rate
    t_ops = flops / (bf16_rate if bf16 else flop_rate)
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def compare(torch, got, ref):
    """(max|err|, max|ref|, within the kernel tolerance)."""
    rtol = BF16_RTOL if got.dtype == torch.bfloat16 else TOL
    got, ref = got.float(), ref.float()
    err = float((got - ref).abs().max())
    top = float(ref.abs().max())
    ok = bool(((got - ref).abs() <= TOL * top + rtol * ref.abs()).all())
    return err, top, ok


def same_function(lib, ref, rel=1e-3):
    """A layout check on the library yardstick, which may pick an algorithm
    (Winograd, split-K) with other rounding than ours."""
    return float((lib - ref).abs().max()) <= rel * float(ref.abs().max())


def f64_stats(torch, h, t, m, absolute=False):
    """The elm_stats function in f64, member by member; ``absolute`` sums
    the terms' magnitudes instead."""
    out = []
    for i in range(h.shape[0]):
        hi, ti = h[i].double(), t[i].double()
        if absolute:
            hi, ti = hi.abs(), ti.abs()
        hm = hi if m is None else hi * m[i].double()[:, None]
        out.append(hm.T @ torch.cat([hi, ti], dim=1))
    return torch.stack(out)


def elm_stats_record(torch, rates, h, t, m, tag, plain_reps=20,
                     long_sum=False):
    """elm_stats on (k, n, L) h, (k, n, C) t and an optional (k, n) mask,
    held against its plain version (and U against its transpose, bitwise),
    timed beside its plain version, cuBLAS's bmm and its bound. The
    launches made here are comparisons and timings, not a path's.

    ``long_sum``: each output of the kernel is an f32 sum over the n rows
    in order (or over chunks of them, then the chunks' sums in order:
    the record's ``plan``), and over 25,000 or more rows its rounding can
    outgrow the plain version's blocked sums (one sum of 200,000 rows:
    5.5e-5 · max|ref|, over the 1e-5 bar). There the kernel is held
    against the f64 function, each output within the probabilistic bound
    of an f32 sum of n terms in order, 7·√n·2⁻²⁴·Σ|terms| (Higham and
    Mary's bound at λ = 7: an output exceeds it with probability below
    5e-11)."""
    from repro_torch.kernels.elm_stats import ops as st_ops, ref as st_ref
    k, n, L = h.shape
    C = t.shape[-1]
    plan = st_ops._plan(k, n, L, C)
    u, v = st_ops.elm_stats(h, t, mask=m)
    ref = st_ref.elm_stats_ref(h, t, m)
    got = torch.cat([u, v], dim=-1)
    extra = {}
    if long_sum:
        truth = f64_stats(torch, h, t, m)
        bound = 7 * n ** 0.5 * 2.0 ** -24 * f64_stats(torch, h, t, m, True)
        dev = (got.double() - truth).abs()
        err, top = float(dev.max()), float(truth.abs().max())
        ratio = float((dev / bound).max())
        extra = dict(f64_rule=True, max_err_over_bound=ratio,
                     plain_max_abs_err_f64=float(
                         (ref.double() - truth).abs().max()))
        check(ratio <= 1.0, f"elm_stats {tag}: max|err| {err} from f64, "
              f"{ratio} of the f32 summation bound")
        del truth, bound, dev
    else:
        err, top, ok = compare(torch, got, ref)
        check(ok, f"elm_stats {tag}: max|err| {err} at max|ref| {top}")
    check(torch.equal(u, u.transpose(1, 2)),
          f"elm_stats {tag}: U is not bitwise symmetric")
    hm = h if m is None else h * m[..., None]
    hmt = hm.transpose(1, 2).contiguous()
    ht = torch.cat([h, t], dim=-1).contiguous()
    check(same_function(torch.matmul(hmt, ht), ref),
          "the cuBLAS yardstick computes another function")
    del u, v, ref, got
    nbytes = 4 * (h.numel() + t.numel() + k * L * (L + C)
                  + (m.numel() if m is not None else 0))
    # U is symmetric: the function needs its pairs i <= j and all of V
    flops = st_ops.elm_stats_flops(k, n, L, C, m is not None)
    b_ms, b_by = bound_ms(nbytes, flops, rates)
    kernel = lambda: st_ops.elm_stats(h, t, mask=m)       # noqa: E731
    plain = lambda: st_ref.elm_stats_ref(h, t, m)         # noqa: E731
    library = lambda: torch.matmul(hmt, ht)               # noqa: E731
    return dict(shape=f"k{k} n{n} L{L} C{C}",
                plan=dict(instantiation=plan.instantiation,
                          chunks=plan.chunks, rows=plan.rows,
                          passes=plan.passes),
                max_abs_err=err, max_abs_ref=top, **extra,
                ms=device_ms(torch, kernel),
                plain_ms=device_ms(torch, plain, reps=plain_reps),
                library_ms=device_ms(torch, library),
                call_ms=call_ms(torch, kernel),
                plain_call_ms=call_ms(torch, plain, reps=plain_reps),
                library_call_ms=call_ms(torch, library),
                bound_ms=b_ms, bound_by=b_by, bytes=nbytes, flops=flops)


def phase_kernels(torch, dev, rates):
    """Each kernel vs its plain version at the main path's shapes; returns
    per-kernel measurements for the kernels line."""
    import torch.nn.functional as F
    from repro_torch.kernels.conv2d import ops as conv_ops, ref as conv_ref
    from repro_torch.kernels.rmsnorm import ops as rms_ops, ref as rms_ref
    from repro_torch.kernels.swa_attention import ops as swa_ops
    from repro_torch.kernels.swa_attention import ref as swa_ref
    from repro_torch.serve import BucketLadder

    gen = torch.Generator().manual_seed(0)

    def rand(*shape):
        return torch.rand(shape, generator=gen).to(dev)

    def randn(*shape):
        return torch.randn(shape, generator=gen).to(dev)

    out = {}

    last = [time.perf_counter()]

    def keep(name, tag, rec):
        # host seconds since the previous case was kept: what the case
        # adds to the run
        now = time.perf_counter()
        rec["case_s_host_clock"], last[0] = now - last[0], now
        rec["vs_library"] = rec["ms"] / rec["library_ms"]
        emit("kernel", name=name, case=tag, **rec)
        out[(name, tag)] = rec

    # the stacked Map's batch (k 4, B 200), and a scoring request of one
    # image at its bucket
    b1 = BucketLadder(SERVE_MAX_BATCH).bucket_for(1)
    conv_cases = [("stage1", (4, 200, 28, 28, 1), (4, 5, 5, 1, 6)),
                  ("stage2", (4, 200, 12, 12, 6), (4, 5, 5, 6, 12)),
                  ("score1_stage1", (4, b1, 28, 28, 1), (4, 5, 5, 1, 6)),
                  ("score1_stage2", (4, b1, 12, 12, 6), (4, 5, 5, 6, 12))]
    for tag, xs, ws in conv_cases:
        x, w = rand(*xs), randn(*ws) * 0.2
        k, B, H, W, Cin = xs
        _, kh, kw, _, Cout = ws
        y = conv_ops.conv2d_valid(x, w)
        err, top, ok = compare(torch, y, conv_ref.conv2d_valid_ref(x, w))
        check(ok, f"conv2d {tag}: max|err| {err} at max|ref| {top}")
        # the library yardstick: cuDNN's grouped conv on NCHW copies made
        # outside the timed region (TF32 off at package import)
        xn = x.permute(1, 0, 4, 2, 3).reshape(B, k * Cin, H, W).contiguous()
        wn = w.permute(0, 4, 3, 1, 2).reshape(k * Cout, Cin, kh, kw
                                              ).contiguous()
        lib = F.conv2d(xn, wn, groups=k)
        check(same_function(lib.reshape(B, k, Cout, *lib.shape[2:])
                            .permute(1, 0, 3, 4, 2), y),
              "the cuDNN yardstick computes another function")
        nbytes = 4 * (x.numel() + w.numel() + y.numel())
        flops = conv_ops.conv2d_flops(y.shape, kh, kw, Cin)
        b_ms, b_by = bound_ms(nbytes, flops, rates)
        kernel = lambda: conv_ops.conv2d_valid(x, w)          # noqa: E731
        plain = lambda: conv_ref.conv2d_valid_ref(x, w)       # noqa: E731
        library = lambda: F.conv2d(xn, wn, groups=k)          # noqa: E731
        rec = dict(shape=f"x{xs} w{ws}", max_abs_err=err, max_abs_ref=top,
                   ms=device_ms(torch, kernel),
                   plain_ms=device_ms(torch, plain, reps=20),
                   library_ms=device_ms(torch, library),
                   call_ms=call_ms(torch, kernel),
                   plain_call_ms=call_ms(torch, plain, reps=20),
                   library_call_ms=call_ms(torch, library),
                   bound_ms=b_ms, bound_by=b_by, bytes=nbytes, flops=flops)
        keep("conv2d", tag, rec)

    # the conv's backward at the stacked SGD Map's shapes: dW at both
    # stages (and at stage 1 of cnn_elm_3c9c, 1 -> 3), dX at stage 2
    # (stage 1's input is the images). Held against
    # the f64 plain version: within twice the f32 plain version's own
    # distance from it, or 1e-5 · max|ref|, whichever is larger (dW sums
    # 115,200 terms of mixed sign at stage 1). The library yardstick: cuDNN's
    # grouped backward on NCHW copies made outside the timed region.
    from torch.nn import grad as nn_grad
    grad_cases = [("dw_stage1", (4, 200, 28, 28, 1), (4, 5, 5, 1, 6)),
                  ("dw_stage2", (4, 200, 12, 12, 6), (4, 5, 5, 6, 12)),
                  ("dw_stage1_3c9c", (4, 200, 28, 28, 1), (4, 5, 5, 1, 3)),
                  ("dx_stage2", (4, 200, 12, 12, 6), (4, 5, 5, 6, 12))]
    for tag, xs, ws in grad_cases:
        k, B, H, W, Cin = xs
        _, kh, kw, _, Cout = ws
        OH, OW = H - kh + 1, W - kw + 1
        x, w, dy = rand(*xs), randn(*ws) * 0.2, randn(k, B, OH, OW, Cout)
        xn = x.permute(1, 0, 4, 2, 3).reshape(B, k * Cin, H, W).contiguous()
        wn = w.permute(0, 4, 3, 1, 2).reshape(k * Cout, Cin, kh, kw
                                              ).contiguous()
        dyn = dy.permute(1, 0, 4, 2, 3).reshape(B, k * Cout, OH, OW
                                                ).contiguous()
        if tag.startswith("dw"):
            name = "conv2d_wgrad"
            kernel = lambda: conv_ops.conv2d_weight_grad(      # noqa: E731
                x, dy, kh, kw)
            plain = lambda: conv_ref.conv2d_weight_grad_ref(    # noqa: E731
                x, dy, kh, kw)
            truth = conv_ref.conv2d_weight_grad_ref(x.double(), dy.double(),
                                                    kh, kw)
            library = lambda: nn_grad.conv2d_weight(            # noqa: E731
                xn, wn.shape, dyn, groups=k)
            as_port = lambda a: a.reshape(k, Cout, Cin, kh, kw).permute(
                0, 3, 4, 2, 1)                                  # noqa: E731
            nbytes = 4 * (x.numel() + dy.numel() + w.numel())
        else:
            name = "conv2d_dgrad"
            kernel = lambda: conv_ops.conv2d_input_grad(dy, w)  # noqa: E731
            plain = lambda: conv_ref.conv2d_input_grad_ref(dy, w)  # noqa
            truth = conv_ref.conv2d_input_grad_ref(dy.double(), w.double())
            library = lambda: nn_grad.conv2d_input(             # noqa: E731
                xn.shape, wn, dyn, groups=k)
            as_port = lambda a: a.reshape(B, k, Cin, H, W).permute(
                1, 0, 3, 4, 2)                                  # noqa: E731
            nbytes = 4 * (dy.numel() + w.numel() + x.numel())
        got, ref = kernel(), plain()
        if name == "conv2d_dgrad":
            # dX as it was computed before it had its own kernel: the
            # forward kernel on padded dY with the turned weights
            padded = F.pad(dy, (0, 0, kw - 1, kw - 1, kh - 1, kh - 1))
            turned = w.flip(1, 2).transpose(3, 4).contiguous()
            check(torch.equal(got, conv_ops.conv2d_valid(padded, turned)),
                  f"{tag}: dX differs from the padded route's")
        err = float((got.double() - truth).abs().max())
        top = float(truth.abs().max())
        bar = max(2 * float((ref.double() - truth).abs().max()), TOL * top)
        check(err <= bar, f"{tag}: max|err| {err} > {bar} (f64 rule)")
        check(same_function(as_port(library()), ref),
              "the cuDNN backward yardstick computes another function")
        flops = conv_ops.conv2d_flops(dy.shape, kh, kw, Cin)  # true products
        b_ms, b_by = bound_ms(nbytes, flops, rates)
        rec = dict(shape=f"x{xs} w{ws}", max_abs_err=err, max_abs_ref=top,
                   bar_f64_rule=bar,
                   ms=device_ms(torch, kernel),
                   plain_ms=device_ms(torch, plain, reps=20),
                   library_ms=device_ms(torch, library),
                   call_ms=call_ms(torch, kernel),
                   plain_call_ms=call_ms(torch, plain, reps=20),
                   library_call_ms=call_ms(torch, library),
                   bound_ms=b_ms, bound_by=b_by, bytes=nbytes, flops=flops)
        if name == "conv2d_dgrad":
            # the products the kernel does: out-of-range kernel rows are
            # skipped, columns are not; the padded route did them all
            rows = sum(min(kh - 1, OH + kh - 2 - h) - max(0, kh - 1 - h) + 1
                       for h in range(H))
            rec["kernel_flops"] = 2 * k * B * rows * W * kw * Cout * Cin
            rec["padded_route_flops"] = 2 * x.numel() * kh * kw * Cout
        keep(name, tag, rec)

    # the stacked Map's batch (k 4, n 200), masked, ragged, and one whole
    # shard of 12,500 rows
    stats_cases = [("unmasked", 4, 200, 192, 10, False),
                   ("fractional_mask", 4, 200, 192, 10, True),
                   ("ragged", 4, 137, 144, 20, True),
                   ("shard", 4, 12_500, 192, 10, False)]
    for tag, k, n, L, C, masked in stats_cases:
        h = torch.tanh(randn(k, n, L))
        t = F.one_hot(torch.randint(0, C, (k, n), generator=gen),
                      C).float().to(dev)
        m = rand(k, n) if masked else None
        keep("elm_stats", tag, elm_stats_record(torch, rates, h, t, m, tag))

    # the LM serving path's shapes, bf16: ln1/ln2/final norm over the B·S
    # rows of a batch-4, prompt-128 prefill (f32 scale; at 4,096 also
    # Zamba2-1.2B's gate norm), q_norm over its B·S·32 heads (bf16 scale),
    # and Zamba2-1.2B's norms at its width 2,048 (f32 scale)
    rms_cases = [("ln_d4096", (512, 4096), torch.float32),
                 ("qk_norm_d128", (16384, 128), torch.bfloat16),
                 ("zamba2_ln_d2048", (512, 2048), torch.float32),
                 # rank 0's ln1/ln2/final norm on phase pod's train_4k
                 # step: 16 × 4,096 local tokens
                 ("pod_train4k_ln_d4096", (65536, 4096), torch.float32),
                 # and Zamba2-1.2B's mamba ln, shared ln1/ln2 and final
                 # norm on its train_4k step there
                 ("pod_zamba2_train4k_ln_d2048", (65536, 2048),
                  torch.float32)]
    for tag, shape, scale_dtype in rms_cases:
        x = (randn(*shape) * 3).to(torch.bfloat16)
        scale = (1 + 0.1 * randn(shape[-1])).to(scale_dtype)
        y = rms_ops.rmsnorm(x, scale, eps=1e-6)
        err, top, ok = compare(torch, y,
                               rms_ref.rmsnorm_ref(x, scale, 1e-6))
        check(ok, f"rmsnorm {tag}: max|err| {err} at max|ref| {top}")
        w_lib = scale.to(x.dtype)
        check(same_function(F.rms_norm(x, (shape[-1],), w_lib, 1e-6).float(),
                            y.float(), 1e-2),
              "the rms_norm yardstick computes another function")
        nbytes = 2 * x.element_size() * x.numel() + scale.element_size() * \
            scale.numel()
        flops = rms_ops.rmsnorm_flops(x.shape)
        b_ms, b_by = bound_ms(nbytes, flops, rates)
        kernel = lambda: rms_ops.rmsnorm(x, scale, eps=1e-6)        # noqa
        plain = lambda: rms_ref.rmsnorm_ref(x, scale, 1e-6)         # noqa
        library = lambda: F.rms_norm(x, (shape[-1],), w_lib, 1e-6)  # noqa
        rec = dict(shape=f"x{shape} bf16, scale {str(scale_dtype)[6:]}",
                   max_abs_err=err, max_abs_ref=top,
                   ms=device_ms(torch, kernel),
                   plain_ms=device_ms(torch, plain),
                   library_ms=device_ms(torch, library),
                   call_ms=call_ms(torch, kernel),
                   plain_call_ms=call_ms(torch, plain),
                   library_call_ms=call_ms(torch, library),
                   bound_ms=b_ms, bound_by=b_by, bytes=nbytes, flops=flops)
        keep("rmsnorm", tag, rec)

    # the prefill's attention (B 4, S 128, 32 heads over 8 kv heads, hd 128,
    # window = S), one windowed case, the prefill with q scaled by 8 (scores
    # of large magnitude stress the online rescale and the hi/lo split of
    # p), Zamba2-1.2B's shared block over a batch-4, prompt-128 prefill
    # (32 heads over 32 kv heads, hd 64, its window 4,096 clamped to S),
    # OLMoE-1B-7B's prefill (16 heads of 128, no GQA) and one 4,096-token
    # sequence of Qwen3-8B (the reference's train_4k shape, window = S)
    # (B 4, S 128, 32 heads over 8 kv heads, hd 128, window = S), one
    # sequence of Qwen3-8B (the reference's train_4k shape, window = S),
    # rank 0's local heads of Qwen3-8B's prefill_32k on the 16 × 16 mesh
    # (B 2 of 32, 2 q heads and their one KV head) and the causal f32
    # route of phase lm_parity's 2-layer f32 path (B 2, S 16) and of phase
    # elm_head's (B 4, S 128)
    bf16 = torch.bfloat16
    swa_cases = [("prefill_causal", 4, 128, 32, 8, 128, 128, 1.0, bf16),
                 ("window256_s1024", 1, 1024, 32, 8, 128, 256, 1.0, bf16),
                 ("prefill_large_scores", 4, 128, 32, 8, 128, 128, 8.0,
                  bf16),
                 ("zamba2_shared", 4, 128, 32, 32, 64, 128, 1.0, bf16),
                 ("olmoe_prefill", 4, 128, 16, 16, 128, 128, 1.0, bf16),
                 ("train4k_seq", 1, 4096, 32, 8, 128, 4096, 1.0, bf16),
                 ("pod_local_heads_s32k", 2, 32768, 2, 1, 128, 32768, 1.0,
                  bf16),
                 # rank 0's local heads on phase pod's train_4k step
                 ("pod_train4k_local_heads", 16, 4096, 2, 1, 128, 4096, 1.0,
                  bf16),
                 # and Zamba2-1.2B's shared block there (2 of 32 heads)
                 ("pod_zamba2_train4k_local_heads", 16, 4096, 2, 2, 64,
                  4096, 1.0, bf16),
                 ("lm_parity_causal_f32", 2, 16, 32, 8, 128, 16, 1.0,
                  torch.float32),
                 ("elm_head_parity_causal_f32", 4, 128, 32, 8, 128, 128,
                  1.0, torch.float32)]
    for tag, B, S, H, KV, hd, W, q_scale, dt in swa_cases:
        q = (randn(B, S, H, hd) * q_scale).to(dt)
        k = randn(B, S, KV, hd).to(dt)
        v = randn(B, S, KV, hd).to(dt)
        y = swa_ops.swa_attention(q, k, v, window=W)
        err, top, ok = compare(torch, y, swa_ref.swa_attention_ref(
            q, k, v, window=W))
        check(ok, f"swa_attention {tag}: max|err| {err} at max|ref| {top}")
        check(torch.equal(y, swa_ops.swa_attention(q, k, v, window=W)),
              f"swa_attention {tag}: not bitwise the same run to run")
        # the library yardstick: SDPA on (B, H, S, hd) copies made outside
        # the timed region, causal or with the window's boolean mask
        qt, kt, vt = (a.transpose(1, 2).contiguous() for a in (q, k, v))
        i = torch.arange(S, device=dev)
        mask = None if W >= S else ((i[None] <= i[:, None])
                                    & (i[:, None] - i[None] < W))

        def library(qt=qt, kt=kt, vt=vt, mask=mask):
            return F.scaled_dot_product_attention(
                qt, kt, vt, attn_mask=mask, is_causal=mask is None,
                enable_gqa=True)
        check(same_function(library().transpose(1, 2).float(), y.float(),
                            2e-2),
              "the SDPA yardstick computes another function")
        pairs = swa_ops.pairs_in_mask(B, S, H, W)
        nbytes = q.element_size() * (2 * q.numel() + k.numel() + v.numel())
        flops = swa_ops.swa_flops(B, S, H, hd, W)
        b_ms, b_by = bound_ms(nbytes, flops, rates, bf16=dt == bf16)
        kernel = lambda: swa_ops.swa_attention(q, k, v, window=W)  # noqa
        plain = lambda: swa_ref.swa_attention_ref(q, k, v,           # noqa
                                                  window=W)
        # the plain version of a 32k sequence holds its (S, S) scores:
        # 17 GB a copy, so few calls
        plain_reps = 3 if S > 8192 else 20
        rec = dict(shape=f"B{B} S{S} H{H} KV{KV} hd{hd} W{W} "
                   f"{str(dt)[6:]}"
                   + (f", q x {q_scale:g}" if q_scale != 1.0 else ""),
                   max_abs_err=err, max_abs_ref=top,
                   ms=device_ms(torch, kernel),
                   plain_ms=device_ms(torch, plain, reps=plain_reps),
                   library_ms=device_ms(torch, library),
                   call_ms=call_ms(torch, kernel),
                   plain_call_ms=call_ms(torch, plain, reps=plain_reps),
                   library_call_ms=call_ms(torch, library),
                   bound_ms=b_ms, bound_by=b_by, bytes=nbytes, flops=flops,
                   pairs_in_mask=pairs)
        keep("swa_attention", tag, rec)
        del q, k, v, qt, kt, vt, y, library, kernel, plain
        torch.cuda.empty_cache()

    # the encoder's non-causal attention (HuBERT-XLarge: 16 heads of 80 over
    # 4 × 1,024 frames), a ragged S 1000, and a small f32 case (the f32
    # parity route). The library: SDPA with is_causal=False; the bound by
    # operations, every (query, key) pair of each head.
    enc_cases = [("encoder_bidirectional", 4, 1024, 16, 16, 80,
                  torch.bfloat16),
                 ("encoder_ragged_s1000", 4, 1000, 16, 16, 80,
                  torch.bfloat16),
                 ("encoder_f32_small", 2, 200, 4, 2, 80, torch.float32)]
    for tag, B, S, H, KV, hd, dt in enc_cases:
        q, k, v = (randn(B, S, n, hd).to(dt) for n in (H, KV, KV))
        y = swa_ops.swa_attention(q, k, v, window=S, causal=False)
        err, top, ok = compare(torch, y, swa_ref.swa_attention_ref(
            q, k, v, window=S, causal=False))
        check(ok, f"swa_attention {tag}: max|err| {err} at max|ref| {top}")
        check(torch.equal(y, swa_ops.swa_attention(q, k, v, window=S,
                                                   causal=False)),
              f"swa_attention {tag}: not bitwise the same run to run")
        qt, kt, vt = (a.transpose(1, 2).contiguous() for a in (q, k, v))

        def library(qt=qt, kt=kt, vt=vt):
            return F.scaled_dot_product_attention(qt, kt, vt,
                                                  is_causal=False,
                                                  enable_gqa=True)
        check(same_function(library().transpose(1, 2).float(), y.float(),
                            2e-2),
              "the SDPA yardstick computes another function")
        pairs = swa_ops.pairs_in_mask(B, S, H, S, causal=False)
        nbytes = q.element_size() * (2 * q.numel() + k.numel() + v.numel())
        flops = swa_ops.swa_flops(B, S, H, hd, S, causal=False)
        b_ms, b_by = bound_ms(nbytes, flops, rates,
                              bf16=dt == torch.bfloat16)
        kernel = lambda: swa_ops.swa_attention(                   # noqa
            q, k, v, window=S, causal=False)
        plain = lambda: swa_ref.swa_attention_ref(                # noqa
            q, k, v, window=S, causal=False)
        rec = dict(shape=f"B{B} S{S} H{H} KV{KV} hd{hd} non-causal "
                   f"{str(dt)[6:]}",
                   max_abs_err=err, max_abs_ref=top,
                   ms=device_ms(torch, kernel),
                   plain_ms=device_ms(torch, plain, reps=20),
                   library_ms=device_ms(torch, library),
                   call_ms=call_ms(torch, kernel),
                   plain_call_ms=call_ms(torch, plain, reps=20),
                   library_call_ms=call_ms(torch, library),
                   bound_ms=b_ms, bound_by=b_by, bytes=nbytes, flops=flops,
                   pairs_in_mask=pairs)
        keep("swa_attention", tag, rec)
        del q, k, v, qt, kt, vt, y

    # the ELM head over HuBERT-XLarge: one batch of 4 × 1,024 frames of
    # 1,280 states, 6 classes
    h = torch.tanh(randn(1, 4096, 1280))
    t = F.one_hot(torch.randint(0, 6, (1, 4096), generator=gen),
                  6).float().to(dev)
    keep("elm_stats", "hubert_head",
         elm_stats_record(torch, rates, h, t, None, "hubert_head"))
    del h, t
    # the ELM head over RWKV6-3B: 4 × 128 tokens of 2,560 states, 16
    # classes
    h = torch.tanh(randn(1, 512, 2560))
    t = F.one_hot(torch.randint(0, 16, (1, 512), generator=gen),
                  16).float().to(dev)
    keep("elm_stats", "rwkv6_head",
         elm_stats_record(torch, rates, h, t, None, "rwkv6_head"))
    del h, t

    # the backward kernels at the LM train step's shapes (batch 4 × 128
    # tokens): rmsnorm's ln, q_norm and Zamba2's ln, swa at the prefill
    # shape and one windowed case. Plain: torch autograd of the plain
    # forward on the card, the graph built outside the timed region
    # (retain_graph);
    # library: the backward of F.rms_norm and of SDPA with enable_gqa, the
    # same way. Held against the plain backward (rmsnorm_bwd_ref,
    # swa_attention_bwd_ref) on the same inputs: bf16 outputs within 2 bf16
    # ulps of max|ref|, or twice the plain version's own distance from the
    # f64 function where that is larger.
    def bwd_rec(tag, got, ref, truth, timed, nbytes, flops, bf16, extra):
        err, bar, top = 0.0, 0.0, 0.0
        for g, r, t in zip(got, ref, truth):
            r64 = r.double()
            mx = float(r64.abs().max())
            ulp = 2.0 ** (math.floor(math.log2(max(mx, 1e-30))) - 7)
            b = max(2 * ulp if g.dtype == torch.bfloat16 else TOL * mx,
                    2 * float((r64 - t).abs().max()))
            e = float((g.double() - t).abs().max())
            check(e <= b, f"{tag}: max|err| {e} from f64 > {b}")
            err, bar, top = max(err, e), max(bar, b), max(top, mx)
        b_ms, b_by = bound_ms(nbytes, flops, rates, bf16=bf16)
        kernel, plain, library = timed
        return dict(max_abs_err=err, max_abs_ref=top, bar=bar,
                    ms=device_ms(torch, kernel),
                    plain_ms=device_ms(torch, plain, reps=20),
                    library_ms=device_ms(torch, library),
                    call_ms=call_ms(torch, kernel),
                    plain_call_ms=call_ms(torch, plain, reps=20),
                    library_call_ms=call_ms(torch, library),
                    bound_ms=b_ms, bound_by=b_by, bytes=nbytes, flops=flops,
                    **extra)

    for tag, shape, scale_dtype in rms_cases:
        x = (randn(*shape) * 3).to(torch.bfloat16)
        scale = (1 + 0.1 * randn(shape[-1])).to(scale_dtype)
        dy = randn(*shape).to(torch.bfloat16)
        got = rms_ops.rmsnorm_bwd(x, scale, dy, eps=1e-6)
        ref = rms_ref.rmsnorm_bwd_ref(x, scale, dy, 1e-6)
        truth = rms_ref.rmsnorm_bwd_ref(x.double(), scale.double(),
                                        dy.double(), 1e-6)
        check(all(torch.equal(a, b) for a, b in zip(
            got, rms_ops.rmsnorm_bwd(x, scale, dy, eps=1e-6))),
            f"rmsnorm_bwd {tag}: not bitwise the same run to run")
        xr, sr = x.clone().requires_grad_(True), scale.clone(
            ).requires_grad_(True)
        y_plain = rms_ref.rmsnorm_ref(xr, sr, 1e-6)
        w_lib = scale.to(x.dtype).clone().requires_grad_(True)
        y_lib = F.rms_norm(xr, (shape[-1],), w_lib, 1e-6)
        check(same_function(torch.autograd.grad(
            y_lib, xr, dy, retain_graph=True)[0].float(), ref[0].float(),
            2e-2), "the rms_norm backward yardstick computes another "
            "function")
        timed = (lambda: rms_ops.rmsnorm_bwd(x, scale, dy, eps=1e-6),
                 lambda: torch.autograd.grad(y_plain, (xr, sr), dy,
                                             retain_graph=True),
                 lambda: torch.autograd.grad(y_lib, (xr, w_lib), dy,
                                             retain_graph=True))
        n, D = shape
        nbytes = 3 * x.element_size() * x.numel() + \
            2 * scale.element_size() * D
        keep("rmsnorm_bwd", tag, bwd_rec(
            f"rmsnorm_bwd {tag}", got, ref, truth, timed, nbytes,
            rms_ops.rmsnorm_bwd_flops(x.shape), False,
            dict(shape=f"x{shape} bf16, scale {str(scale_dtype)[6:]}")))

    # the causal cases at the train step's shapes; the non-causal mode (the
    # encoder's, HuBERT-XLarge's fine-tune) at B 4, S 1024, H 16, hd 80, a
    # ragged S 1000 and the small f32 case (library: SDPA's backward with
    # is_causal=False)
    swa_bwd_cases = [
        ("prefill_causal", 4, 128, 32, 8, 128, 128, True, torch.bfloat16),
        ("window256_s1024", 1, 1024, 32, 8, 128, 256, True, torch.bfloat16),
        ("olmoe_prefill", 4, 128, 16, 16, 128, 128, True, torch.bfloat16),
        ("train4k_seq", 1, 4096, 32, 8, 128, 4096, True, torch.bfloat16),
        # rank 0's local heads on phase pod's train_4k steps
        ("pod_train4k_local_heads", 16, 4096, 2, 1, 128, 4096, True,
         torch.bfloat16),
        ("pod_zamba2_train4k_local_heads", 16, 4096, 2, 2, 64, 4096, True,
         torch.bfloat16),
        ("encoder_bidirectional", 4, 1024, 16, 16, 80, 1024, False,
         torch.bfloat16),
        ("encoder_ragged_s1000", 4, 1000, 16, 16, 80, 1000, False,
         torch.bfloat16),
        ("encoder_f32_small", 2, 200, 4, 2, 80, 200, False, torch.float32),
        # the causal f32 route at phase lm_parity's and phase elm_head's
        # shapes
        ("lm_parity_causal_f32", 2, 16, 32, 8, 128, 16, True,
         torch.float32),
        ("elm_head_parity_causal_f32", 4, 128, 32, 8, 128, 128, True,
         torch.float32)]
    for tag, B, S, H, KV, hd, W, causal, dt in swa_bwd_cases:
        q = randn(B, S, H, hd).to(dt)
        k = randn(B, S, KV, hd).to(dt)
        v = randn(B, S, KV, hd).to(dt)
        do = randn(B, S, H, hd).to(dt)
        o, lse = swa_ops.swa_attention_fwd(q, k, v, window=W, causal=causal)
        got = swa_ops.swa_attention_bwd(q, k, v, o, lse, do, window=W,
                                        causal=causal)
        ref = swa_ref.swa_attention_bwd_ref(q, k, v, o, lse, do, window=W,
                                            causal=causal)
        truth = swa_ref.swa_attention_bwd_ref(
            *(a.double() for a in (q, k, v, o, lse, do)), window=W,
            causal=causal)
        check(all(torch.equal(a, b) for a, b in zip(
            got, swa_ops.swa_attention_bwd(q, k, v, o, lse, do, window=W,
                                           causal=causal))),
            f"swa_attention_bwd {tag}: not bitwise the same run to run")
        qr, kr, vr = (a.clone().requires_grad_(True) for a in (q, k, v))
        y_plain = swa_ref.swa_attention_ref(qr, kr, vr, window=W,
                                            causal=causal)
        qt, kt, vt = (a.transpose(1, 2).contiguous().requires_grad_(True)
                      for a in (q, k, v))
        i = torch.arange(S, device=dev)
        mask = None if W >= S or not causal else (
            (i[None] <= i[:, None]) & (i[:, None] - i[None] < W))
        y_lib = F.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=mask, is_causal=causal and mask is None,
            enable_gqa=True)
        dot = do.transpose(1, 2).contiguous()
        lib_dq = torch.autograd.grad(y_lib, qt, dot, retain_graph=True)[0]
        check(same_function(lib_dq.transpose(1, 2).float(), ref[0].float(),
                            5e-2),
              "the SDPA backward yardstick computes another function")
        timed = (lambda: swa_ops.swa_attention_bwd(q, k, v, o, lse, do,
                                                   window=W, causal=causal),
                 lambda: torch.autograd.grad(y_plain, (qr, kr, vr), do,
                                             retain_graph=True),
                 lambda: torch.autograd.grad(y_lib, (qt, kt, vt), dot,
                                             retain_graph=True))
        pairs = swa_ops.pairs_in_mask(B, S, H, W, causal)
        nbytes = q.element_size() * (4 * q.numel() + 2 * k.numel()
                                     + 2 * v.numel()) + 4 * lse.numel()
        keep("swa_attention_bwd", tag, bwd_rec(
            f"swa_attention_bwd {tag}", got, ref, truth, timed, nbytes,
            swa_ops.swa_bwd_flops(B, S, H, hd, W, causal),
            dt == torch.bfloat16,
            dict(shape=f"B{B} S{S} H{H} KV{KV} hd{hd} "
                 + (f"W{W}" if causal else "non-causal")
                 + f" {str(dt)[6:]}", pairs_in_mask=pairs)))
        del y_plain, y_lib, qr, kr, vr, qt, kt, vt, truth
    return out


def want_launches(**counts):
    """A launch record with ``counts`` and every other kernel at 0."""
    from repro_torch import kernels
    return {name: counts.get(name, 0) for name in kernels.LAUNCHES}


def expected_launches(parts, batch):
    """Launches the epochs=0 Map must make: per batch index, one conv per
    stage and one elm_stats — member-batched on the stacked path, per member
    on the sequential one."""
    nbs = [len(p.x) // batch for p in parts]
    return (want_launches(conv2d=2 * max(nbs), elm_stats=max(nbs)),
            want_launches(conv2d=2 * sum(nbs), elm_stats=sum(nbs)))


def expected_sgd_launches(parts, batch, epochs, backend):
    """Launches an SGD Map must make: per step (a batch index on the
    stacked path, a member's batch on the sequential one) the two conv
    forwards, stage 2's dX, dW of both stages (each ``WGRAD_PASSES``
    launches) and one elm_stats."""
    from repro_torch.kernels.conv2d.ops import WGRAD_PASSES
    nbs = [len(p.x) // batch for p in parts]
    steps = epochs * (max(nbs) if backend == "stacked" else sum(nbs))
    return want_launches(conv2d=2 * steps, conv2d_dgrad=steps,
                         conv2d_wgrad=2 * WGRAD_PASSES * steps,
                         elm_stats=steps)


def exact(torch, cfg, test, res):
    """The f64 solution of ``res``'s own ridge systems and its f64 held-out
    scores: how far an f32 solve of these ill-conditioned systems (cond
    ~1e5) lands from exact."""
    from repro_torch.layers.norms import optimal_tanh
    from repro_torch.models import cnn
    k = res.stacked.k
    u, v = res.stats.u.cpu().double(), res.stats.v.cpu().double()
    eye = torch.eye(u.shape[-1], dtype=torch.float64)
    beta = torch.linalg.solve(u + eye / cfg.elm_lambda, v)
    params = {"stages": tuple({n: a.cpu() for n, a in st.items()}
                              for st in res.stacked.cnn_params["stages"])}
    scores = []
    with torch.no_grad():
        for i in range(0, len(test.x), 512):
            xb = torch.from_numpy(test.x[i:i + 512])
            h = cnn.features_members(cfg, params,
                                     xb[None].expand(k, *xb.shape))
            scores.append(optimal_tanh(h).double() @ beta)
    return beta.numpy(), torch.cat(scores, dim=1).numpy()


def agree(torch, cfg, test, a, b, what, twin=None):
    """``a`` against ``b``: β within 1e-3 · max|β|, scores within
    1e-4 · max|score| — or within twice ``b``'s own f32 distance from
    the f64 solution of its systems, where that is larger — and
    predictions equal on >= 99.9% of the held-out rows.

    ``twin``: ``b``'s path run again from initial weights one f32 ulp away
    (SGD runs, whose f32 trajectories no two implementations can share):
    the bars then also accept twice ``b``'s distance from its twin, and the
    predictions as many equal rows as ``b`` shares with its twin, less
    0.1 %."""
    import numpy as np
    k = b.stacked.k
    ba, bb = a.stacked.beta.cpu().numpy(), b.stacked.beta.cpu().numpy()
    check(np.isfinite(ba).all() and ba.shape == (k, 192, 10),
          f"{what}: beta {ba.shape} finite={np.isfinite(ba).all()}")
    sa = a.ensemble().member_scores(test.x)
    sb = b.ensemble().member_scores(test.x)
    check(np.isfinite(sa).all() and sa.shape == sb.shape,
          f"{what}: scores {sa.shape}")
    beta_x, scores_x = exact(torch, cfg, test, b)
    d_beta, d_score = np.abs(ba - bb).max(), np.abs(sa - sb).max()
    bar_beta = max(1e-3 * np.abs(bb).max(), 2 * np.abs(bb - beta_x).max())
    bar_score = max(1e-4 * np.abs(sb).max(),
                    2 * np.abs(sb - scores_x).max())
    same = float((sa.mean(0).argmax(-1) == sb.mean(0).argmax(-1)).mean())
    need_same, extra = 0.999, {}
    if twin is not None:
        st = twin.ensemble().member_scores(test.x)
        bt = twin.stacked.beta.cpu().numpy()
        extra = dict(
            twin_dbeta=float(np.abs(bt - bb).max()),
            twin_dscore=float(np.abs(st - sb).max()),
            twin_agreement=float((st.mean(0).argmax(-1)
                                  == sb.mean(0).argmax(-1)).mean()))
        bar_beta = max(bar_beta, 2 * extra["twin_dbeta"])
        bar_score = max(bar_score, 2 * extra["twin_dscore"])
        need_same = min(need_same, extra["twin_agreement"] - 0.001)
    emit("agree", pair=what, max_abs_dbeta=float(d_beta),
         max_abs_beta=float(np.abs(bb).max()), bar_beta=float(bar_beta),
         f32_solve_err_beta=float(np.abs(bb - beta_x).max()),
         max_abs_dscore=float(d_score),
         max_abs_score=float(np.abs(sb).max()),
         bar_score=float(bar_score),
         f32_solve_err_score=float(np.abs(sb - scores_x).max()),
         prediction_agreement=same, bar_agreement=need_same, **extra)
    check(d_beta <= bar_beta, f"{what}: beta {d_beta} > {bar_beta}")
    check(d_score <= bar_score, f"{what}: scores {d_score} > {bar_score}")
    check(same >= need_same, f"{what}: predictions agree on {same}")


def phase_map(torch, dev, n_per_class=1500, n_test=10_000, k=4, batch=200):
    """Map → Reduce at full width on ``dev`` and on the CPU; the held-out
    set scored. Returns what the serve phase and the kernels line need."""
    import numpy as np
    from repro_torch import kernels
    from repro_torch.configs import get_config
    from repro_torch.core.runner import AveragingRun, MapConfig, ReduceConfig
    from repro_torch.data.partition import partition_iid
    from repro_torch.data.synthetic import make_extended_mnist
    from repro_torch.models import cnn

    cfg = get_config("cnn_elm_6c12c")
    t0 = time.perf_counter()
    ds = make_extended_mnist(n_per_class=n_per_class, seed=0)
    train, test = ds.split(n_test)
    parts = partition_iid(train.x, train.y, k)
    init = cnn.init_params(cfg, torch.Generator().manual_seed(0),
                           device="cpu")
    emit("data", images=len(ds.x), train=len(train.x), test=len(test.x),
         members=k, rows_per_member=len(parts[0].x), batch=batch,
         seconds=time.perf_counter() - t0)

    def run(backend, device):
        return AveragingRun(cfg, MapConfig(batch_size=batch,
                                           backend=backend),
                            ReduceConfig()).run(parts, init_params=init,
                                                device=device)

    want_stacked, want_seq = expected_launches(parts, batch)
    # the main path: stacked Map → Reduce → scoring of the held-out set
    kernels.reset_launches()
    stacked = run("stacked", dev)
    map_launches = dict(kernels.LAUNCHES)
    ens = stacked.ensemble()
    scores = ens.member_scores(test.x)
    main_launches = dict(kernels.LAUNCHES)
    check(map_launches == want_stacked,
          f"stacked Map launches {map_launches} != {want_stacked}")
    blocks = -(-len(test.x) // 512)
    check(main_launches["conv2d"] == want_stacked["conv2d"] + 2 * blocks
          and main_launches["elm_stats"] == want_stacked["elm_stats"],
          f"main-path launches {main_launches}")

    kernels.reset_launches()
    seq = run("sequential", dev)
    seq_launches = dict(kernels.LAUNCHES)
    check(seq_launches == want_seq,
          f"sequential Map launches {seq_launches} != {want_seq}")

    n_images = sum(len(p.x) // batch * batch for p in parts)
    walls = {}
    for backend in ("stacked", "sequential"):
        first = stacked if backend == "stacked" else seq
        again = [run(backend, dev).wall_time_s for _ in range(3)]
        walls[backend] = again
        emit("map", backend=backend, device=str(dev),
             wall_s_first=first.wall_time_s, wall_s=again,
             images_per_s=n_images / sorted(again)[1],
             launches=map_launches if backend == "stacked" else seq_launches)

    cpu = run("stacked", "cpu")
    emit("map", backend="stacked", device="cpu (the port's plain path, "
         "host clock)", wall_s=cpu.wall_time_s)

    agree(torch, cfg, test, stacked, cpu, "card stacked vs CPU stacked")
    agree(torch, cfg, test, seq, stacked, "card sequential vs card stacked")
    check(np.isfinite(scores).all() and scores.shape == (k, len(test.x), 10),
          "held-out scores")

    from repro_torch.core.runner import evaluate_model, kappa_model
    preds = ens.member_predictions(test.x)
    emit("accuracy", averaged=evaluate_model(cfg, stacked.averaged, test.x,
                                             test.y, device=dev),
         averaged_kappa=kappa_model(cfg, stacked.averaged, test.x, test.y,
                                    device=dev),
         members=ens.evaluate(test.x, test.y, preds=preds).tolist(),
         ensemble_mean=ens.accuracy(test.x, test.y))
    return dict(cfg=cfg, test=test, parts=parts, batch=batch, init=init,
                data_args=(n_per_class, n_test, k), stacked=stacked,
                seq=seq, cpu=cpu, ens=ens, scores=scores,
                launches=main_launches, seq_launches=seq_launches)


def phase_sgd(torch, dev, m, epochs=2, lr_c=0.05, cut=2500):
    """The paper's Table 5 SGD setting on the card: ``epochs`` epochs at
    dynamic_paper(lr_c), batch 200, on the Map's shards — stacked with one
    round (the SGD main path), sequential, and stacked with two rounds;
    launches checked per run, the backends held against each other, the
    card against the port's CPU path on a cut of ``cut`` rows a member, and
    the averaged model's accuracy against the epochs=0 model's."""
    import numpy as np
    from repro_torch import kernels
    from repro_torch.core.runner import (AveragingRun, MapConfig,
                                         ReduceConfig, evaluate_model)
    from repro_torch.data.partition import Partition
    from repro_torch.optim.schedules import dynamic_paper
    from repro_torch.tree import tree_leaves, tree_map

    cfg, parts, test, init = m["cfg"], m["parts"], m["test"], m["init"]
    batch = m["batch"]

    def run(backend, device, rounds=1, shards=parts, n_epochs=epochs,
            init_params=init):
        return AveragingRun(cfg, MapConfig(
            epochs=n_epochs, lr_schedule=dynamic_paper(lr_c),
            batch_size=batch, backend=backend),
            ReduceConfig(rounds=rounds)).run(shards, init_params=init_params,
                                             device=device)

    def weights_agree(a, b, what, twin=None):
        """CNN weights of ``a`` within 1e-4 · max|w| of ``b``'s, per leaf —
        or, with ``twin`` (``b``'s path from initial weights one f32 ulp
        away), within twice ``b``'s distance from its twin, where that is
        larger."""
        worst, report = 0.0, []
        leaves_t = (tree_leaves(twin.stacked.cnn_params) if twin is not None
                    else [None] * len(tree_leaves(a.stacked.cnn_params)))
        for la, lb, lt in zip(tree_leaves(a.stacked.cnn_params),
                              tree_leaves(b.stacked.cnn_params), leaves_t):
            la, lb = la.cpu(), lb.cpu()
            check(bool(torch.isfinite(la).all()), f"{what}: weights finite")
            top = float(lb.abs().max())
            d = float((la - lb).abs().max())
            bar = 1e-4 * top
            if lt is not None:
                bar = max(bar, 2 * float((lt.cpu() - lb).abs().max()))
            worst = max(worst, d / top)
            report.append({"max_abs_dw": d, "max_abs_w": top, "bar": bar})
            check(d <= bar, f"{what}: weights {d} > {bar}")
        emit("agree_weights", pair=what, max_rel_dw=worst,
             bitwise=all(torch.equal(x.cpu(), y.cpu()) for x, y in zip(
                 tree_leaves(a.stacked.cnn_params),
                 tree_leaves(b.stacked.cnn_params))),
             leaves=report)

    n_images = sum(len(p.x) // batch * batch for p in parts)
    out = {}
    for backend, rounds in (("stacked", 1), ("sequential", 1),
                            ("stacked", 2)):
        want = expected_sgd_launches(parts, batch, epochs, backend)
        kernels.reset_launches()
        first = run(backend, dev, rounds)
        launches = dict(kernels.LAUNCHES)
        check(launches == want, f"SGD {backend} rounds={rounds} launches "
              f"{launches} != {want}")
        check(sum(r.launches["conv2d_wgrad"] for r in first.rounds)
              == want["conv2d_wgrad"], "round records' launches")
        again = [run(backend, dev, rounds).wall_time_s
                 for _ in range(2 if backend == "stacked" else 1)]
        out[(backend, rounds)] = first
        if (backend, rounds) == ("stacked", 1):
            main_launches = launches        # the SGD main path
        emit("sgd", backend=backend, rounds=rounds, epochs=epochs,
             lr=f"dynamic_paper({lr_c})", batch=batch, device=str(dev),
             wall_s_first=first.wall_time_s, wall_s=again,
             images_per_s=epochs * n_images / min(again),
             launches=launches,
             round_wall_s=[r.wall_time_s for r in first.rounds],
             round_syncs=first.round_syncs)
    stacked, seq = out[("stacked", 1)], out[("sequential", 1)]
    weights_agree(seq, stacked, "SGD card sequential vs card stacked")
    agree(torch, cfg, test, seq, stacked,
          "SGD card sequential vs card stacked")

    # the card against the port's CPU path, on the first `cut` rows of each
    # shard at full width: one epoch, and the two-round run. These f32 SGD
    # trajectories are ill-conditioned (I/λ + U from a few batches): one
    # ulp of the initial weights moves the CPU's own weights by 10-50 %
    # within an epoch, so the bars take the CPU's twin, run from initial
    # weights one ulp up, as the measure of what f32 can hold
    cut_parts = [Partition(p.x[:cut], p.y[:cut]) for p in parts]
    twin_init = tree_map(lambda a: torch.nextafter(
        a, torch.full_like(a, float("inf"))), init)
    for rounds, n_epochs in ((1, 1), (2, 2)):
        t0 = time.perf_counter()
        cpu = run("stacked", "cpu", rounds, cut_parts, n_epochs)
        cpu_s = time.perf_counter() - t0
        twin = run("stacked", "cpu", rounds, cut_parts, n_epochs, twin_init)
        card = run("stacked", dev, rounds, cut_parts, n_epochs)
        what = (f"SGD card vs CPU, {cut} rows a member, epochs={n_epochs}, "
                f"rounds={rounds}")
        weights_agree(card, cpu, what, twin)
        agree(torch, cfg, test, card, cpu, what, twin)
        emit("sgd_cpu", rounds=rounds, epochs=n_epochs, rows=cut,
             cpu_wall_s_host_clock=cpu_s)

    a_0 = evaluate_model(cfg, m["stacked"].averaged, test.x, test.y,
                         device=dev)
    a_sgd = evaluate_model(cfg, stacked.averaged, test.x, test.y, device=dev)
    a_r2 = evaluate_model(cfg, out[("stacked", 2)].averaged, test.x, test.y,
                          device=dev)
    emit("sgd_accuracy", epochs0=a_0, sgd=a_sgd, sgd_rounds2=a_r2,
         members=stacked.ensemble().evaluate(test.x, test.y).tolist())
    check(np.isfinite(a_sgd) and a_sgd > a_0 - 0.05,
          f"SGD accuracy {a_sgd} collapsed against epochs=0's {a_0}")
    return dict(stacked=stacked, seq=seq, rounds2=out[("stacked", 2)],
                launches=main_launches, lr_c=lr_c, epochs=epochs)


def mesh_probe_rank(rank, world, dev_name, cfg, data_args, init, batch):
    """One rank of the two-rank gloo group sharing the card (``run_ranks``
    starts it): the ``map`` phase's shards made again from their seed, the
    epochs=0 Map on the flat mesh; its members, stats, averaged model and
    collectives' log back to the parent."""
    from repro_torch.core.runner import AveragingRun, MapConfig
    from repro_torch.data.partition import partition_iid
    from repro_torch.data.synthetic import make_extended_mnist
    from repro_torch.distributed import collectives
    from repro_torch.launch.mesh import make_member_mesh
    from repro_torch.tree import tree_leaves
    n_per_class, n_test, k = data_args
    train, _ = make_extended_mnist(n_per_class=n_per_class,
                                   seed=0).split(n_test)
    parts = partition_iid(train.x, train.y, k)
    res = AveragingRun(cfg, MapConfig(
        batch_size=batch, backend="mesh", mesh=make_member_mesh())).run(
            parts, init_params=init, device=dev_name)
    cpu = lambda t: [a.cpu() for a in tree_leaves(t)]    # noqa: E731
    return dict(members=cpu((res.stacked.cnn_params, res.stacked.beta)),
                stats=cpu(tuple(res.stats)),
                averaged=cpu((res.averaged.cnn_params, res.averaged.beta)),
                log=[(label, dict(c)) for label, c in collectives.LOG])


def phase_mesh(torch, dev, m, sgd, probe_world2=True):
    """The scale-out Map (``MapConfig(backend="mesh")``) on the card over
    NCCL at world size 1, in this process: the flat 1-D and the 2-D (1, 1)
    member meshes, on the ``map`` phase's shards at full width.

    Runs: the epochs=0 Map → Reduce (flat and 2-D); the ``sgd`` phase's
    two-epoch, two-round run (flat and 2-D); shard_weighted and boosted
    Reduces of the epochs=0 Map; ``e2lm_global_beta`` of an epochs=0 Map;
    the two-round run crashed after round 0's checkpoint and resumed.
    Gates: members, stats, β, averaged model and held-out scores bitwise
    those of the card's stacked runs (one rank holds every member, and
    its all-reduce of one partial is that partial); the kernels' launches
    the stacked path's; the collectives per span — none in an epoch, one
    all-reduce a Reduce and a sync (two on the 2-D mesh), one all-gather a
    snapshot and a boosted weight resolve; the global β bitwise
    ``e2lm.mapreduce_solve`` of the same stats; the resumed run bitwise
    the uninterrupted one. Printed: walls, images/s, and one all-reduce
    of the flat f32 vector of the CNN and β (3,888 floats) timed by CUDA
    events. Then, where ``probe_world2``: two gloo ranks sharing the card
    (NCCL refuses two ranks on one card), the epochs=0 flat Map against
    the stacked run."""
    import tempfile
    import numpy as np
    from repro_torch import kernels
    from repro_torch.core import e2lm, elm, faults
    from repro_torch.core.averaging import ravel
    from repro_torch.core.executor import ExecutionPlan, make_executor
    from repro_torch.core.reduce_strategies import Boosted
    from repro_torch.core.runner import AveragingRun, MapConfig, ReduceConfig
    from repro_torch.data.partition import Partition
    from repro_torch.distributed import collectives
    from repro_torch.launch.mesh import (make_member_mesh, process_group,
                                         run_ranks)
    from repro_torch.optim.schedules import dynamic_paper
    from repro_torch.tree import tree_leaves

    cfg, parts, test, init = m["cfg"], m["parts"], m["test"], m["init"]
    batch, epochs, lr_c = m["batch"], sgd["epochs"], sgd["lr_c"]
    n_images = sum(len(p.x) // batch * batch for p in parts)
    validation = Partition(test.x[:2000], test.y[:2000])
    seen = []

    class RecordingBoosted(Boosted):
        def weights(self, ctx):
            w = super().weights(ctx)
            seen.append([float(x) for x in w])
            return w

    def leaves_equal(a, b):
        la, lb = tree_leaves(a), tree_leaves(b)
        return len(la) == len(lb) and all(torch.equal(x, y)
                                          for x, y in zip(la, lb))

    def same_run(a, b):
        return (leaves_equal((a.stacked.cnn_params, a.stacked.beta),
                             (b.stacked.cnn_params, b.stacked.beta))
                and leaves_equal(tuple(a.stats), tuple(b.stats))
                and leaves_equal((a.averaged.cnn_params, a.averaged.beta),
                                 (b.averaged.cnn_params, b.averaged.beta)))

    def log_holds(log, two):
        """The collective contract over one run's spans."""
        reduce_check = (collectives.check_two_all_reduces if two
                        else collectives.check_one_all_reduce)
        for label, counts in log:
            if label == "epoch":
                ok = collectives.check_no_collectives(counts).ok
            elif label in ("sync", "reduce"):
                ok = reduce_check(counts).ok
            elif label in ("gather", "weights"):
                ok = collectives.by_kind(counts) == {"all_gather": 1}
            else:
                ok = label == "e2lm" and \
                    collectives.check_one_all_reduce(counts).ok
            if not ok:
                return False
        return True

    def summary(log):
        return [[label, collectives.by_kind(c)] for label, c in log]

    out, mesh_launches = {}, {}
    backend = "nccl" if dev.type == "cuda" else "gloo"
    with process_group(device=dev.type, timeout_s=120):
        meshes = {"flat": make_member_mesh(), "2d": make_member_mesh(hosts=1)}

        def run(mesh, n_epochs=0, rounds=1, strategy="uniform", val=None,
                backend="mesh", **kw):
            return AveragingRun(cfg, MapConfig(
                epochs=n_epochs,
                lr_schedule=dynamic_paper(lr_c) if n_epochs else None,
                batch_size=batch, backend=backend,
                mesh=meshes[mesh] if backend == "mesh" else None),
                ReduceConfig(strategy=strategy, rounds=rounds,
                             validation=val)).run(
                parts, init_params=init, device=dev, **kw)

        want_map = expected_launches(parts, batch)[0]
        want_sgd = expected_sgd_launches(parts, batch, epochs, "stacked")
        for mesh in ("flat", "2d"):
            for n_epochs, rounds, stacked, want in (
                    (0, 1, m["stacked"], want_map),
                    (epochs, 2, sgd["rounds2"], want_sgd)):
                kernels.reset_launches()
                collectives.reset()
                res = run(mesh, n_epochs, rounds)
                launches, log = dict(kernels.LAUNCHES), list(collectives.LOG)
                what = f"mesh {mesh} epochs={n_epochs} rounds={rounds}"
                check(launches == want, f"{what}: launches {launches} != "
                      f"{want}")
                check(same_run(res, stacked),
                      f"{what}: not bitwise the card's stacked run")
                check(log_holds(log, mesh == "2d"),
                      f"{what}: collectives {summary(log)}")
                check(sum(1 for label, _ in log if label == "sync")
                      == rounds - 1 and res.round_syncs == rounds - 1,
                      f"{what}: syncs")
                if n_epochs == 0:
                    scores = res.ensemble().member_scores(test.x)
                    check(np.array_equal(scores, m["scores"]),
                          f"{what}: held-out scores not bitwise")
                if mesh == "flat":
                    for name, n in launches.items():
                        mesh_launches[name] = mesh_launches.get(name, 0) + n
                # the stacked run beside it in turns (stacked first on even
                # turns): the walls of one moment of the host
                again, beside = [], []
                for turn in range(4 if n_epochs == 0 else 2):
                    order = ("stacked", "mesh")[::1 if turn % 2 == 0 else -1]
                    for backend_now in order:
                        wall = run(mesh, n_epochs, rounds,
                                   backend=backend_now).wall_time_s
                        (again if backend_now == "mesh" else
                         beside).append(wall)
                emit("mesh", mesh=mesh, world=1, backend=backend,
                     epochs=n_epochs, rounds=rounds, device=str(dev),
                     wall_s_first=res.wall_time_s, wall_s=again,
                     stacked_wall_s=beside,
                     images_per_s=max(1, n_epochs) * n_images / min(again),
                     stacked_images_per_s=max(1, n_epochs) * n_images
                     / min(beside),
                     launches=launches, collectives=summary(log),
                     bitwise_stacked=True)

        # shard_weighted and boosted Reduces of the epochs=0 Map
        for strategy in ("shard_weighted", "boosted"):
            val = validation if strategy == "boosted" else None
            strat = (RecordingBoosted() if strategy == "boosted"
                     else strategy)
            del seen[:]
            st = run("flat", strategy=strat, val=val, backend="stacked")
            st_w = list(seen)
            del seen[:]
            collectives.reset()
            me = run("flat", strategy=strat, val=val)
            log = list(collectives.LOG)
            check(same_run(me, st) and seen == st_w,
                  f"mesh {strategy}: not bitwise the stacked run")
            check(log_holds(log, False)
                  and sum(1 for label, _ in log if label == "weights")
                  == (1 if strategy == "boosted" else 0),
                  f"mesh {strategy}: collectives {summary(log)}")
            out[strategy] = dict(bitwise_stacked=True, weights=seen[:1],
                                 collectives=summary(log))

        # E²LM's global readout from the Map's stats
        collectives.reset()
        ex = make_executor("mesh", meshes["flat"])
        res = ex.execute(cfg, init, parts, ExecutionPlan(batch_size=batch,
                                                         device=dev))
        beta = ex.e2lm_global_beta()
        rows = [elm.ELMStats(res.stats.u[i], res.stats.v[i], res.stats.n[i])
                for i in range(len(parts))]
        want_beta = e2lm.mapreduce_solve(rows, cfg.elm_lambda)
        log = list(collectives.LOG)
        check(torch.equal(beta, want_beta),
              "mesh e2lm_global_beta is not mapreduce_solve's β")
        check(log_holds(log, False), f"mesh e2lm: {summary(log)}")
        out["e2lm"] = dict(bitwise_mapreduce_solve=True,
                           max_abs_beta=float(beta.abs().max()),
                           collectives=summary(log))

        # crash after round 0's checkpoint, resume
        with tempfile.TemporaryDirectory() as d:
            t0 = time.perf_counter()
            crashed, resumed = faults.run_crash_resume(
                AveragingRun(cfg, MapConfig(
                    epochs=epochs, lr_schedule=dynamic_paper(lr_c),
                    batch_size=batch, backend="mesh",
                    mesh=meshes["flat"]), ReduceConfig(rounds=2)),
                parts, d, unit="round", index=0, init_params=init,
                device=dev)
            check(crashed and resumed.resumed
                  and [r.round for r in resumed.rounds] == [1]
                  and same_run(resumed, sgd["rounds2"]),
                  "mesh crash/resume differs from the uninterrupted run")
            out["resume"] = dict(crashed_after="round 0", bitwise=True,
                                 seconds=time.perf_counter() - t0)

        # one all-reduce of the flat vector a Reduce sends
        flat, _ = ravel((m["stacked"].averaged.cnn_params,
                         m["stacked"].averaged.beta))
        group = meshes["flat"].get_group("pod")
        out["all_reduce"] = dict(
            floats=flat.numel(), bytes=flat.numel() * 4,
            ms=call_ms(torch, lambda: collectives.all_reduce(flat, group),
                       reps=200))
        collectives.reset()

    if probe_world2:
        # two gloo ranks on the one card: the members split 2 + 2
        t0 = time.perf_counter()
        per_rank = run_ranks(mesh_probe_rank, 2, device="cpu",
                             args=(str(dev), cfg, m["data_args"], init,
                                   batch),
                             timeout_s=300)
        st = m["stacked"]
        want = [a.cpu() for a in tree_leaves((st.stacked.cnn_params,
                                              st.stacked.beta))]
        want_avg = [a.cpu() for a in tree_leaves((st.averaged.cnn_params,
                                                  st.averaged.beta))]
        got = per_rank[0]
        check(all(torch.equal(a, b) for a, b in zip(got["members"], want)),
              "world 2 on one card: members not bitwise the stacked run")
        gap = max(float((a - b).abs().max() / b.abs().max().clamp(min=1e-30))
                  for a, b in zip(got["averaged"], want_avg))
        check(gap <= 1e-5, f"world 2 on one card: averaged {gap}")
        check(all(torch.equal(a, b) for r in per_rank[1:]
                  for a, b in zip(r["averaged"], got["averaged"])),
              "world 2 on one card: ranks disagree")
        check(log_holds(got["log"], False),
              f"world 2 on one card: {summary(got['log'])}")
        out["world2_gloo_one_card"] = dict(
            members_bitwise=True, averaged_max_rel_gap=gap,
            collectives=summary(got["log"]),
            seconds_with_spawn=time.perf_counter() - t0)
    emit("mesh_checks", **out)
    return mesh_launches


def phase_serve(torch, m):
    """The bucketed scorer over the Map's k = 4 members at full width, one
    captured CUDA graph per bucket: requests of 1, 3, 17 and 64 images
    against the ensemble surface, launches counted over the replays, the
    graph count after warm-up and after a swap, whether a row scores the
    same bits in every bucket (the plain eager pass and the graphs), then
    an ``EnsembleServer`` under open-loop load in
    ``benchmarks/serve_ensemble.py``'s settings with a hot swap mid-sweep,
    and the same endpoint once through ``python -m
    repro_torch.launch.serve --ensemble``. Returns the serving path's
    launches."""
    import re
    import numpy as np
    from repro_torch import kernels
    from repro_torch.core.cnn_elm import scores_stacked, stack_models
    from repro_torch.serve import EnsembleServer, ServeConfig, run_open_loop

    ens, test = m["ens"], m["test"]
    sizes = (1, 3, 17, 64)
    want = {n: ens.predict(test.x[:n]) for n in sizes}
    scorer = ens.bucketed_scorer(max_batch=SERVE_MAX_BATCH)
    t0 = time.perf_counter()
    scorer.warmup()
    capture_s = time.perf_counter() - t0
    n_buckets = len(scorer.ladder.buckets)
    check(scorer.compile_count() == n_buckets,
          f"{scorer.compile_count()} graphs after warm-up for {n_buckets} "
          f"buckets")
    m["scorer"] = scorer            # audited by phase audit
    reps = 30
    kernels.reset_launches()
    lat = {}
    for n in sizes:
        x = test.x[:n]
        got = scorer.score_block(x)
        ref = m["scores"][:, :n]
        check(np.allclose(got, ref, rtol=1e-5, atol=1e-6 * np.abs(ref).max())
              and np.array_equal(got.argmax(-1), ref.argmax(-1)),
              f"served scores for {n} images")
        check(np.array_equal(scorer.predict_block(x), want[n]),
              f"served predictions for {n} images")
        times = []
        for _ in range(reps):
            t0 = time.perf_counter()
            scorer.score_block(x)
            times.append((time.perf_counter() - t0) * 1e3)
        times.sort()
        lat[n] = {"p50_ms": times[reps // 2], "p90_ms": times[reps * 9 // 10],
                  "bucket": scorer.ladder.bucket_for(n)}
    serve_launches = dict(kernels.LAUNCHES)
    # per request size: one checked score, one prediction, the timed reps;
    # each scoring pass is one graph replay holding one conv launch per stage
    check(serve_launches["conv2d"] == 2 * len(sizes) * (reps + 2) and
          serve_launches["elm_stats"] == 0 and
          serve_launches["rmsnorm"] == serve_launches["swa_attention"] == 0,
          f"serve launches {serve_launches}")
    scorer.swap_members(m["seq"].stacked)
    swapped = scorer.score_block(test.x[:17])
    ref = m["seq"].ensemble().member_scores(test.x[:17])
    check(np.allclose(swapped, ref, rtol=1e-5,
                      atol=1e-6 * np.abs(ref).max()), "scores after swap")
    check(scorer.compile_count() == n_buckets, "a swap recaptured")

    # a row's bits in every bucket: rows 0..r-1 scored alone (at their own
    # bucket) against the same rows at the head of every larger bucket,
    # through the plain eager pass and through the graphs
    dev = scorer.device
    members = scorer.members
    xs = torch.from_numpy(test.x[:SERVE_MAX_BATCH]).to(dev)
    invariance = {}
    for r in (1, 7):
        alone_plain = scores_stacked(m["cfg"], members.cnn_params,
                                     members.beta, xs[:r])
        alone_graph = scorer.score_block(test.x[:r])
        plain, graph = {}, {}
        for b in scorer.ladder.buckets:
            if b < r:
                continue
            s = scores_stacked(m["cfg"], members.cnn_params, members.beta,
                               xs[:b])[:, :r]
            plain[b] = float((s - alone_plain).abs().max())
            graph[b] = float(np.abs(scorer.score_block(test.x[:b])[:, :r]
                                    - alone_graph).max())
        invariance[f"rows{r}"] = {"plain_max_abs_diff": plain,
                                  "graph_max_abs_diff": graph}
        check(all(d == 0.0 for d in graph.values()),
              f"rows 0..{r - 1} score other bits in another bucket: {graph}")
    emit("serve", latency_ms=lat, launches=serve_launches, swap="ok",
         requests=list(sizes), graphs=scorer.compile_count(),
         buckets=list(scorer.ladder.buckets), capture_s=capture_s,
         bucket_invariance=invariance)

    # continuous batching under open-loop load (benchmarks/serve_ensemble.py
    # without --smoke: max_batch 32, max_wait 4 ms, 600 requests a rate)
    max_batch, wait_ms, n_req = 32, 4.0, 600
    scorer = ens.bucketed_scorer(max_batch=max_batch).warmup()
    n_buckets = len(scorer.ladder.buckets)
    server = EnsembleServer(scorer, ServeConfig(
        max_batch=max_batch, max_wait_ms=wait_ms)).start(warmup=False)
    loads = []
    kernels.reset_launches()
    try:
        for i, rate in enumerate((100.0, 200.0, 400.0, 800.0)):
            before = server.stats()
            rep = run_open_loop(server, test.x, rate_per_s=rate,
                                n_requests=n_req, seed=17 + i)
            after = server.stats()
            batches = after.batches - before.batches
            occupancy = (after.mean_occupancy * after.batches
                         - before.mean_occupancy * before.batches) / batches
            loads.append({**rep.to_json(), "batches": batches,
                          "mean_occupancy": occupancy})
            check(rep.failed == 0 and rep.completed == n_req,
                  f"{rep.failed} failed requests at {rate}/s")
            if i == 0:
                # a live swap mid-sweep: the members reversed, the
                # checkpoint watcher's payload without the disk
                server.swap_members(stack_models(ens.members.unstack()[::-1]))
    finally:
        server.close()
    stats = server.stats()
    load_launches = dict(kernels.LAUNCHES)
    check(stats.failed == 0 and stats.dropped == 0 and stats.swaps == 1
          and stats.completed == 4 * n_req,
          f"open loop: completed {stats.completed}, failed {stats.failed}, "
          f"dropped {stats.dropped}, swaps {stats.swaps}")
    check(scorer.assert_compile_budget() == n_buckets,
          "the open-loop sweep recaptured")
    check(load_launches["conv2d"] == 2 * stats.batches
          and load_launches["elm_stats"] == 0,
          f"open-loop launches {load_launches} for {stats.batches} batches")
    emit("serve_load", max_batch=max_batch, max_wait_ms=wait_ms,
         requests_per_rate=n_req, loads=loads, swaps=stats.swaps,
         failed=stats.failed, dropped=stats.dropped, batches=stats.batches,
         graphs=scorer.compile_count(), launches=load_launches)

    # the launcher's endpoint, in its own process, once at 200/s
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--ensemble",
         "--rate", "200", "--requests", str(n_req), "--max-batch",
         str(max_batch), "--max-wait-ms", str(wait_ms)],
        capture_output=True, text=True, timeout=600,
        env=dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src")))
    check(proc.returncode == 0, f"launch.serve --ensemble exited "
          f"{proc.returncode}: {proc.stderr[-2000:]}")
    done = re.search(r"# (\d+) answered, (\d+) failed, (\d+) dropped",
                     proc.stdout)
    rates = re.search(r"achieved (\d+) imgs/s\s+p50 ([\d.]+) ms\s+p95 "
                      r"([\d.]+) ms\s+p99 ([\d.]+) ms", proc.stdout)
    check(done is not None and rates is not None
          and done.groups() == (str(n_req), "0", "0"),
          f"launch.serve --ensemble output: {proc.stdout[-2000:]}")
    emit("serve_launcher", offered_per_s=200.0, requests=n_req,
         answered=int(done.group(1)), failed=0, dropped=0,
         images_per_s=float(rates.group(1)), p50_ms=float(rates.group(2)),
         p95_ms=float(rates.group(3)), p99_ms=float(rates.group(4)),
         process_s=time.perf_counter() - t0)
    return {name: serve_launches[name] + load_launches[name]
            for name in serve_launches}


def window_f64(torch, windows, lam):
    """The f64 solution of each member's ridge system from its window's
    running totals (what the run's f32 β was solved from)."""
    u = torch.stack([w.total().u for w in windows]).cpu().double()
    v = torch.stack([w.total().v for w in windows]).cpu().double()
    eye = torch.eye(u.shape[-1], dtype=torch.float64)
    return torch.linalg.solve(u + eye / lam, v)


def window_gap(torch, a, b, rtol, atol):
    """Two runs' windows member by member: max |a's totals − b's| over U
    and V, the window gate's tolerance for it (``atol + rtol ·
    max|b's total|``, the bar a running total is held to against its
    recompute), max |a's recompute − b's| (the chunks' own stats apart)
    and each run's max |running total − recompute| (its downdates'
    drift)."""
    def gap(x, y):
        return float((x.cpu() - y.cpu()).abs().max())
    out = dict(d_total=0.0, tol=0.0, d_recompute=0.0, drift_a=0.0,
               drift_b=0.0)
    for wa, wb in zip(a.windows, b.windows):
        ta, tb, ra, rb = wa.total(), wb.total(), wa.recompute(), \
            wb.recompute()
        for name in ("u", "v"):
            ya = getattr(tb, name)
            out["d_total"] = max(out["d_total"], gap(getattr(ta, name), ya))
            out["tol"] = max(out["tol"],
                             atol + rtol * float(ya.abs().max()))
            out["d_recompute"] = max(out["d_recompute"],
                                     gap(getattr(ra, name), getattr(rb, name)))
            out["drift_a"] = max(out["drift_a"],
                                 gap(getattr(ta, name), getattr(ra, name)))
            out["drift_b"] = max(out["drift_b"],
                                 gap(getattr(tb, name), getattr(rb, name)))
    return out


def phase_stream(torch, dev, m, n_chunks=48, chunk_rows=128,
                 drift_at=24, window=8, cadence=12, holdout=16, batch=32):
    """The streaming Map at full width (cnn_elm_6c12c) in
    ``benchmarks/stream_map.py``'s settings without --smoke: three
    class-skewed member streams of 48 chunks of 128 rows, a label
    permutation at chunk 24, window 8, cadence 12, held-out 16, epochs 0,
    batch 32, the window gate every 8 chunks. The never, cadence and
    drift policies on the stacked and sequential backends; the card
    against the port's CPU path on the drift run; ``prefetch=2`` against
    none; the drift run's launches per chunk; one run under the profiler
    (device idle share of a chunk); then the drift run once more with a
    live ``EnsembleServer`` and ``CheckpointWatcher`` on its checkpoint
    directory under traffic. Returns the drift run's launches."""
    import tempfile
    import threading
    import numpy as np
    from torch.profiler import ProfilerActivity, profile
    from repro_torch import kernels
    from repro_torch.checkpoint import run_state
    from repro_torch.core.executor import CheckpointConfig
    from repro_torch.core.runner import (Ensemble, MapConfig, ReduceConfig,
                                         evaluate_model)
    from repro_torch.data.synthetic import make_extended_mnist
    from repro_torch.layers.norms import optimal_tanh
    from repro_torch.models import cnn
    from repro_torch.serve import (BucketedScorer, CheckpointWatcher,
                                   EnsembleServer, ServeConfig)
    from repro_torch.stream import (StreamConfig, StreamingRun,
                                    SyntheticDriftSource, member_streams)
    from repro_torch.tree import tree_leaves, tree_map

    cfg, init = m["cfg"], m["init"]
    shift, class_sets = 5, ((0, 1, 2, 3), (3, 4, 5, 6), (6, 7, 8, 9))
    k = len(class_sets)
    ev = make_extended_mnist(n_per_class=40, seed=999)
    ey_post = (ev.y + shift) % ev.num_classes

    def streams():
        return member_streams([SyntheticDriftSource(
            n_chunks=n_chunks, chunk_rows=chunk_rows, drift_at=drift_at,
            seed=11 + i, label_shift=shift, class_filter=class_sets[i],
            n_per_class=48) for i in range(k)], k, seed=1000,
            per_member=True)

    def make(policy, backend="stacked", prefetch=0):
        return StreamingRun(
            cfg, MapConfig(epochs=0, batch_size=batch, backend=backend),
            ReduceConfig(sync="drift" if policy == "drift" else "rounds"),
            StreamConfig(window_chunks=window, holdout_rows=holdout,
                         sync_every=0 if policy == "never" else cadence,
                         drift_threshold=0.25, drift_warmup=3,
                         verify_every=window), prefetch=prefetch)

    def run(policy, backend="stacked", device=dev, prefetch=0, ckpt=None):
        return make(policy, backend, prefetch).run(
            streams(), init_params=init, device=device,
            checkpoint=None if ckpt is None else CheckpointConfig(dir=ckpt))

    def bitwise(a, b):
        return all(torch.equal(x.cpu(), y.cpu()) for x, y in zip(
            tree_leaves([(mm.cnn_params, mm.beta) for mm in a.members]
                        + [a.last_published.beta]),
            tree_leaves([(mm.cnn_params, mm.beta) for mm in b.members]
                        + [b.last_published.beta])))

    def f64_side(r, r_dir):
        """``r``'s f64 counterparts: each member's β solved in f64 from its
        window's final totals; the published β solved in f64 from the
        totals its last sync saved, averaged uniformly (the phase's
        Reduce); and that model's held-out scores under ``r``'s published
        backbone (the CPU's f32 features)."""
        state = run_state.restore_round(r_dir, r.sync_chunks[-1], "cpu")
        u, v = state.stats.u.double(), state.stats.v.double()
        eye = torch.eye(u.shape[-1], dtype=torch.float64)
        pub = torch.linalg.solve(u + eye / cfg.elm_lambda, v).mean(0)
        params = tree_map(lambda a: a.cpu(), r.last_published.cnn_params)
        with torch.no_grad():
            h = torch.cat([cnn.features(cfg, params, torch.from_numpy(
                ev.x[i:i + 512])) for i in range(0, len(ev.x), 512)])
        return (window_f64(torch, r.windows, cfg.elm_lambda), pub,
                (optimal_tanh(h).double() @ pub).numpy())

    def agree(a, a_dir, b, b_dir, what):
        """``a`` against ``b`` (their checkpoints in ``a_dir``, ``b_dir``),
        by the gates of PERF.md §2 for a stream. The same syncs. The
        windows: every member's totals within the window gate's tolerance
        of ``b``'s. Each side against the f64 model of its OWN windows:
        ``a``'s windowed β, published β and the published model's
        held-out scores within 1e-3 · max|β| (scores: 1e-4 · max|score|)
        or twice ``b``'s own distance from its f64 model, whichever is
        larger. ``a`` against ``b``: within those bars plus the distance
        of the two sides' f64 models (what the windows' difference alone
        makes of an exact solve). The published backbone within 1e-4 ·
        max|w| per leaf (epochs 0 leave it at the init up to the
        averages' rounding). Predictions are reported, not gated: the
        post-drift published model is right on about a third of the rows,
        and its near-ties flip under f32 rounding."""
        check(a.sync_chunks == b.sync_chunks,
              f"{what}: syncs {a.sync_chunks} != {b.sync_chunks}")
        sc = StreamConfig()
        win = window_gap(torch, a, b, sc.verify_rtol, sc.verify_atol)
        (xa_beta, xa_pub, xa_s), (xb_beta, xb_pub, xb_s) = (
            f64_side(a, a_dir), f64_side(b, b_dir))
        ba, bb = a.stacked.beta.cpu().double(), b.stacked.beta.cpu().double()
        pa = a.last_published.beta.cpu().double()
        pb = b.last_published.beta.cpu().double()
        sa, sb = [Ensemble.from_models(cfg, [r.last_published],
                                       device=r.device).member_scores(
                      ev.x)[0].astype(np.float64) for r in (a, b)]

        def d(x, y):
            return float(np.abs(np.asarray(x) - np.asarray(y)).max())

        rows = {}
        for name, ya, yb, xa, xb, rel in (
                ("beta", ba, bb, xa_beta, xb_beta, 1e-3),
                ("published", pa, pb, xa_pub, xb_pub, 1e-3),
                ("score", sa, sb, xa_s, xb_s, 1e-4)):
            own_b = d(yb, xb)
            bar = max(rel * float(np.abs(np.asarray(yb)).max()), 2 * own_b)
            rows[name] = dict(d=d(ya, yb), own_a=d(ya, xa), own_b=own_b,
                              bar=bar, d_f64=d(xa, xb))
        preds = {n: (x.argmax(-1), y.argmax(-1)) for n, x, y in (
            ("a_b", sa, sb), ("a_own_f64", sa, xa_s), ("b_own_f64", sb, xb_s),
            ("f64_f64", xa_s, xb_s))}
        dw = [(float((x.cpu() - y.cpu()).abs().max()),
               1e-4 * float(y.abs().max())) for x, y in zip(
            tree_leaves(a.last_published.cnn_params),
            tree_leaves(b.last_published.cnn_params))]
        emit("stream_agree", pair=what, windows=win,
             **{f"{n}_{k}": v for n, r in rows.items() for k, v in r.items()},
             max_abs_score=float(np.abs(sb).max()),
             prediction_agreement={n: float((p == q).mean())
                                   for n, (p, q) in preds.items()},
             backbone_max_abs_dw=[x for x, _ in dw], bitwise=bitwise(a, b))
        check(win["d_total"] <= win["tol"],
              f"{what}: window totals {win['d_total']} apart > {win['tol']}")
        for name, r in rows.items():
            check(r["own_a"] <= r["bar"], f"{what}: {name} {r['own_a']} from "
                  f"the f64 model of its own windows > {r['bar']}")
            check(r["d"] <= r["bar"] + r["d_f64"],
                  f"{what}: {name} {r['d']} > {r['bar']} + {r['d_f64']}")
        check(all(x <= lim for x, lim in dw),
              f"{what}: published backbones {dw}")

    dirs, results = {}, {}
    tmp = tempfile.TemporaryDirectory()
    try:
        for policy in ("never", "cadence", "drift"):
            for backend in ("stacked", "sequential"):
                d = os.path.join(tmp.name, f"{policy}-{backend}")
                kernels.reset_launches()
                res = run(policy, backend, ckpt=d)
                launches = dict(kernels.LAUNCHES)
                results[(policy, backend)], dirs[(policy, backend)] = res, d
                check(res.chunks == n_chunks and
                      run_state.latest_ready_round(d) == res.sync_chunks[-1],
                      f"{policy} {backend}: {res.chunks} chunks, rounds")
                acc = evaluate_model(cfg, res.last_published, ev.x, ey_post,
                                     device=dev)
                emit("stream", policy=policy, backend=backend,
                     chunks=res.chunks, sync_chunks=res.sync_chunks,
                     wall_s=res.wall_time_s,
                     wall_ms_per_chunk=res.wall_time_s / res.chunks * 1e3,
                     launches=launches,
                     launches_per_chunk={n: c / res.chunks
                                         for n, c in launches.items()},
                     published_acc_post_drift=acc,
                     window_gate_max_err=max(w.verify()
                                             for w in res.windows),
                     evicted=res.windows[0].evicted)
                results[(policy, backend, "acc")] = acc
        drift = results[("drift", "stacked")]
        # the path's launches: per chunk one member-batched held-out pass
        # (a conv a stage) and chunk_rows / batch Map steps (2 convs and
        # one elm_stats each)
        steps = chunk_rows // batch
        want = {name: 0 for name in kernels.LAUNCHES}
        want.update(conv2d=n_chunks * (2 + 2 * steps),
                    elm_stats=n_chunks * steps)
        check(drift.launches == want,
              f"stream launches {drift.launches} != {want}")
        check(results[("never", "stacked")].sync_chunks == [0],
              "never-sync published more than once")
        check(any(c > drift_at for c in drift.sync_chunks),
              f"drift policy never fired after chunk {drift_at}: "
              f"{drift.sync_chunks}")
        check(results[("drift", "stacked", "acc")]
              > results[("never", "stacked", "acc")],
              "drift-triggered syncs did not beat the never-sync endpoint")
        check(all(w.evicted > 0 for w in drift.windows),
              "the windows never slid")
        for policy in ("never", "cadence", "drift"):
            agree(results[(policy, "sequential")],
                  dirs[(policy, "sequential")],
                  results[(policy, "stacked")], dirs[(policy, "stacked")],
                  f"stream {policy}: card sequential vs card stacked")
        cpu_dir = os.path.join(tmp.name, "drift-cpu")
        t0 = time.perf_counter()
        cpu = run("drift", device="cpu", ckpt=cpu_dir)
        cpu_s = time.perf_counter() - t0
        agree(drift, dirs[("drift", "stacked")], cpu, cpu_dir,
              "stream drift: card stacked vs CPU stacked")
        pre = run("drift", prefetch=2)
        check(pre.sync_chunks == drift.sync_chunks and bitwise(pre, drift),
              "prefetch=2 differs from prefetch=0")
        score_end = float(np.mean(drift.records[-1].scores))
        score_at = float(np.mean(drift.records[drift_at].scores))
        emit("stream_checks", cpu_wall_s_host_clock=cpu_s,
             prefetch2_bitwise=True, window_gate="ok",
             drift_sync_chunks=drift.sync_chunks,
             prequential_score_at_drift=score_at,
             prequential_score_end=score_end)

        # the device's share of a chunk, never policy, stacked
        make("never").run(streams(), init_params=init, device=dev)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            res = make("never").run(streams(), init_params=init, device=dev)
        rows = sorted(device_activity(torch, prof), reverse=True)
        busy = sum(us for us, _, _ in rows) / 1e3
        wall = res.wall_time_s * 1e3
        emit("stream_profile", what=f"stream never, stacked, {n_chunks} "
             f"chunks of {k} x {chunk_rows} rows",
             wall_ms=wall, wall_ms_per_chunk=wall / res.chunks,
             device_busy_ms=busy if rows else "not measured",
             idle_share=1 - busy / wall if rows else "not measured",
             top=[{"name": name[:60], "ms": us / 1e3, "count": count}
                  for us, name, count in rows[:10]])

        # the drift run again, published into a directory that a live
        # endpoint watches under traffic
        live = os.path.join(tmp.name, "live")
        scorer = BucketedScorer(
            cfg, run_state.restore_round(dirs[("drift", "stacked")], 0,
                                         dev).members,
            max_batch=32, device=dev).warmup()
        n_buckets = len(scorer.ladder.buckets)
        server = EnsembleServer(scorer, ServeConfig(
            max_batch=32, max_wait_ms=4.0)).start(warmup=False)
        watcher = CheckpointWatcher(live, server, poll_ms=10).start()
        stop = threading.Event()
        futs = []

        def traffic():
            i = 0
            while not stop.is_set():
                futs.append(server.submit(ev.x[i % len(ev.x)]))
                i += 1
                time.sleep(0.0025)

        th = threading.Thread(target=traffic, daemon=True)
        th.start()
        try:
            again = run("drift", ckpt=live)
            last = again.sync_chunks[-1]
            staged = watcher.wait_for_round(last, timeout_s=60)
        finally:
            stop.set()
            th.join(timeout=60)
            watcher.stop()
        probe = ev.x[:7]
        post = np.stack([f.result(timeout=60).member_scores
                         for f in server.submit_many(probe)], axis=1)
        server.close()
        stats = server.stats()
        direct = BucketedScorer(
            cfg, run_state.restore_round(live, last, dev).members,
            max_batch=32, device=dev).score_block(probe)
        failed = sum(f.exception(timeout=60) is not None for f in futs)
        check(staged and watcher.current_round == last,
              f"watcher at round {watcher.current_round}, newest {last}")
        check(failed == 0 and stats.failed == 0 and stats.dropped == 0,
              f"live stream endpoint: {failed} failed futures, "
              f"{stats.failed} failed, {stats.dropped} dropped")
        check(np.array_equal(post, direct),
              "post-swap scores differ from direct scoring of the round")
        check(scorer.compile_count() == n_buckets,
              "hot reloads recaptured")
        check(again.sync_chunks == drift.sync_chunks, "live drift run syncs")
        emit("stream_serve", rounds=again.sync_chunks,
             staged=[s.round for s in watcher.swaps], rejected=watcher.rejected,
             swaps_applied=stats.swaps, requests=len(futs) + len(probe),
             completed=stats.completed, failed=stats.failed,
             dropped=stats.dropped, p50_ms=stats.percentile_ms(50),
             p99_ms=stats.percentile_ms(99), graphs=scorer.compile_count(),
             post_swap_bitwise=True, stream_wall_s=again.wall_time_s)
    finally:
        tmp.cleanup()
    return drift.launches


def phase_profile(torch, m):
    """One stacked Map, epochs=0, and one stacked SGD epoch under
    torch.profiler: device time by kernel against the wall, so the host's
    share of each shows."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core.runner import AveragingRun, MapConfig
    from repro_torch.optim.schedules import dynamic_paper

    dev = m["stacked"].device
    images = sum(len(p.x) for p in m["parts"])
    for what, map_cfg in (
            (f"stacked Map, {images} images",
             MapConfig(batch_size=m["batch"])),
            (f"stacked SGD epoch, dynamic_paper(0.05), {images} images",
             MapConfig(epochs=1, lr_schedule=dynamic_paper(0.05),
                       batch_size=m["batch"]))):
        run = AveragingRun(m["cfg"], map_cfg)
        run.run(m["parts"], init_params=m["init"], device=dev)   # warm
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            res = run.run(m["parts"], init_params=m["init"], device=dev)
        rows = sorted(device_activity(torch, prof), reverse=True)
        device_ms = sum(us for us, _, _ in rows) / 1e3
        wall_ms = res.wall_time_s * 1e3
        emit("profile", what=what,
             wall_ms=wall_ms, device_busy_ms=device_ms if rows else
             "not measured",
             idle_share=1 - device_ms / wall_ms if rows else "not measured",
             top=[{"name": name[:60], "ms": us / 1e3, "count": count}
                  for us, name, count in rows[:12]])


def solve_bar(torch, beta, exact):
    """The full-width f32 solve bar around ``beta``: 1e-3 · max|β| or twice
    ``beta``'s own distance from the f64 solution ``exact``, whichever is
    larger. Returns (bar, that distance)."""
    own = float((beta.double().cpu() - exact.cpu()).abs().max())
    return max(1e-3 * float(beta.abs().max()), 2 * own), own


def member_rows(stats):
    """Member-stacked ``ELMStats`` -> one ``ELMStats`` per member."""
    return [type(stats)(*(a[i] for a in stats))
            for i in range(stats.n.shape[0])]


def f64_solve(torch, u, v, lam):
    eye = torch.eye(u.shape[-1], dtype=torch.float64, device=u.device)
    return torch.linalg.solve(u.double() + eye / lam, v.double())


def phase_e2lm(torch, dev, rates, m, n=200_000, L=192, C=10, lam=100.0,
               oselm_rows=5_000):
    """E²LM at ``benchmarks/e2lm_scaling.py``'s shape (n 200,000 rows,
    L 192, C 10, λ 100; H and T normal from a seed, drawn on the card):
    the monolithic stats and the per-shard stats of k 2, 4 and 8 (one
    member-batched launch each), each shard set reduced and solved by
    ``e2lm.mapreduce_solve`` and held within the solve bar of the
    monolithic β (``solve_bar``, around its f64 solution); the global β
    of the ``map`` phase's card run, from its ``RunResult.stats``, against
    the CPU run's; OS-ELM in 50-row blocks over the first ``oselm_rows``
    rows against the batch solve (``tests/test_elm.py``'s bar, rtol 5e-2,
    atol 5e-3); elm_stats timed at each shard shape. Returns the timing
    records."""
    from repro_torch import kernels
    from repro_torch.core import e2lm, elm
    from repro_torch.kernels.elm_stats import ops as st_ops
    from repro_torch.layers.norms import optimal_tanh

    gen = torch.Generator(device=dev).manual_seed(0)
    h = torch.randn((n, L), generator=gen, device=dev)
    t = torch.randn((n, C), generator=gen, device=dev)
    h64 = 1.7159 * torch.tanh(h.double() * (2.0 / 3.0))
    exact = f64_solve(torch, h64.T @ h64, h64.T @ t.double(), lam)
    del h64

    kernels.reset_launches()
    t0 = time.perf_counter()
    beta_mono = elm.solve_beta(elm.batch_stats(h, t), lam)
    torch.cuda.synchronize()
    mono_ms = (time.perf_counter() - t0) * 1e3
    bar, own = solve_bar(torch, beta_mono, exact)
    shards = {}
    for k in (2, 4, 8):
        t0 = time.perf_counter()
        stats = elm.batch_stats(h.reshape(k, n // k, L),
                                t.reshape(k, n // k, C))
        beta_k = e2lm.mapreduce_solve(member_rows(stats), lam)
        torch.cuda.synchronize()
        d = float((beta_k - beta_mono).abs().max())
        check(bool(torch.isfinite(beta_k).all()) and d <= bar,
              f"e2lm k={k}: beta {d} from the monolithic, bar {bar}")
        shards[k] = dict(rows_per_shard=n // k, max_abs_dbeta=d,
                         map_reduce_solve_ms_host_clock=(
                             time.perf_counter() - t0) * 1e3)
    launches = dict(kernels.LAUNCHES)
    # one launch of the monolithic stats and one a k, each in its plan's
    # passes (two where the rows are split)
    want = sum(st_ops.plan(n // k, L, C).passes for k in (1, 2, 4, 8))
    check(launches["elm_stats"] == want,
          f"e2lm path launched elm_stats {launches['elm_stats']} times, "
          f"its plans {want}")

    # the Map's global β: the card run's member stats against the CPU run's
    cfg, card, cpu = m["cfg"], m["stacked"], m["cpu"]
    beta_card = e2lm.mapreduce_solve(member_rows(card.stats),
                                     cfg.elm_lambda)
    beta_cpu = e2lm.mapreduce_solve(member_rows(cpu.stats), cfg.elm_lambda)
    map_bar, map_own = solve_bar(torch, beta_cpu, f64_solve(
        torch, cpu.stats.u.double().sum(0), cpu.stats.v.double().sum(0),
        cfg.elm_lambda))
    map_d = float((beta_card.cpu() - beta_cpu).abs().max())
    check(map_d <= map_bar,
          f"e2lm: the Map's global beta, card vs CPU {map_d} > {map_bar}")

    state = e2lm.oselm_init(L, C, lam, device=dev)
    for i in range(0, oselm_rows, 50):
        state = e2lm.oselm_update(state, h[i:i + 50], t[i:i + 50])
    batch_beta = elm.solve_beta(elm.batch_stats(h[:oselm_rows],
                                                t[:oselm_rows]), lam)
    os_d = (state.beta - batch_beta).abs()
    check(bool((os_d <= 5e-3 + 5e-2 * batch_beta.abs()).all()),
          f"OS-ELM vs the batch solve: max|d| {float(os_d.max())}")

    ha = optimal_tanh(h)
    records = {}
    for k in (1, 2, 4, 8):
        records[f"e2lm_k{k}"] = rec = elm_stats_record(
            torch, rates, ha.reshape(k, n // k, L), t.reshape(k, n // k, C),
            None, f"e2lm k={k}", plain_reps=10, long_sum=True)
        emit("kernel", name="elm_stats", case=f"e2lm_k{k}",
             vs_library=rec["ms"] / rec["library_ms"], **rec)
    emit("e2lm", rows=n, L=L, C=C, lam=lam, launches=launches,
         monolithic_ms_host_clock=mono_ms,
         max_abs_beta=float(beta_mono.abs().max()), bar_beta=bar,
         f32_solve_err_beta=own, shards=shards,
         map_global_beta=dict(max_abs_dbeta=map_d, bar_beta=map_bar,
                              f32_solve_err_beta=map_own,
                              max_abs_beta=float(beta_cpu.abs().max())),
         oselm=dict(rows=oselm_rows, block=50,
                    max_abs_dbeta=float(os_d.max()),
                    max_abs_beta=float(batch_beta.abs().max())))
    return records


def phase_elm_head(torch, dev, rates, m, lm_layers=None, batch=500,
                   ft_batch=200, ft_lr=1e-3, lm_batch=4, lm_seq=128,
                   lm_classes=16, lm_lam=10.0, parity_layers=2):
    """The ELM head (``core.elm_head``) over both backbones on the card.
    CNN: the ``map`` phase's init as the backbone, ``accumulate_stats``
    over its 50,000 training images in batches of ``batch``, ``solve`` at
    the config's λ, ``predict`` over the held-out set, then 4
    ``finetune_step``s on one batch (the loss must fall). LM: the full
    qwen3_8b in bf16 (``lm_layers`` cuts the depth for a rehearsal),
    ``hidden_states`` of a batch of ``lm_batch`` × ``lm_seq`` tokens, the
    head at ``lm_classes`` classes and λ ``lm_lam``, elm_stats timed at
    its shape. Parity: the same model at full width, ``parity_layers``
    layers, f32, card against the port's CPU path — states within
    1e-4 · max|h|, head β within the solve bar; then one
    ``finetune_step`` of it on a second batch, through the rmsnorm and
    swa_attention backward kernels on the card (launches exact): the loss
    within rtol 1e-4 and every new leaf within 1e-4 · max|leaf| of the
    CPU's (``tests/test_torch_elm_head.py``'s bars)."""
    import numpy as np
    from repro_torch import kernels
    from repro_torch.configs import get_config, replace
    from repro_torch.core import elm_head
    from repro_torch.kernels.conv2d.ops import WGRAD_PASSES
    from repro_torch.layers.norms import optimal_tanh
    from repro_torch.models import api, cnn
    from repro_torch.tree import tree_leaves, tree_map

    cfg, parts, test = m["cfg"], m["parts"], m["test"]
    C = cfg.num_classes
    x = np.concatenate([p.x for p in parts])
    y = np.concatenate([p.y for p in parts])
    params = tree_map(lambda a: a.to(dev), m["init"])

    def cnn_fn(p, b):
        return cnn.features(cfg, p, b["x"])

    def batches(xs, ys, size):
        for i in range(0, len(xs), size):
            yield {"x": torch.from_numpy(xs[i:i + size]).to(dev),
                   "targets": torch.from_numpy(ys[i:i + size]).to(dev)}

    kernels.reset_launches()
    t0 = time.perf_counter()
    stats = None
    for b in batches(x, y, batch):
        stats = elm_head.accumulate_stats(cnn_fn, params, b, C, stats)
    beta = elm_head.solve(stats, cfg.elm_lambda)
    preds = np.concatenate([
        elm_head.predict(cnn_fn, params, beta, b).argmax(-1).cpu().numpy()
        for b in batches(test.x, test.y, 512)])
    head_s = time.perf_counter() - t0
    fb = next(batches(x[:ft_batch], y[:ft_batch], ft_batch))
    losses, p = [], params
    t0 = time.perf_counter()
    for _ in range(4):
        p, loss = elm_head.finetune_step(cnn_fn, p, beta, fb, C, ft_lr)
        losses.append(float(loss))
    ft_s = time.perf_counter() - t0
    cnn_launches = dict(kernels.LAUNCHES)
    n_batches = -(-len(x) // batch)
    blocks = -(-len(test.x) // 512)
    want = want_launches(conv2d=2 * (n_batches + blocks + 4),
                         elm_stats=n_batches, conv2d_dgrad=4,
                         conv2d_wgrad=4 * 2 * WGRAD_PASSES)
    check(cnn_launches == want, f"CNN head launches {cnn_launches} != {want}")
    check(bool(torch.isfinite(beta).all()) and beta.shape == (
        cnn.feature_dim(cfg), C), "CNN head beta")
    check(losses[-1] < losses[0], f"CNN finetune losses {losses}")
    cnn_acc = float((preds == test.y).mean())

    # the LM backbone: the full model in bf16, drawn on the card
    lm_cfg = get_config("qwen3_8b")
    if lm_layers is not None:
        lm_cfg = replace(lm_cfg, num_layers=lm_layers)
    gen = torch.Generator(device=dev).manual_seed(0)
    lm = api.init_params(lm_cfg, gen, device=dev)
    lb = {"tokens": torch.randint(0, lm_cfg.vocab_size, (lm_batch, lm_seq),
                                  generator=gen, device=dev),
          "targets": torch.randint(0, lm_classes, (lm_batch, lm_seq),
                                   generator=gen, device=dev)}

    def lm_fn(q, b):
        return api.hidden_states(lm_cfg, q, b)

    torch.cuda.synchronize()
    kernels.reset_launches()
    t0 = time.perf_counter()
    with torch.no_grad():
        hs = lm_fn(lm, lb)
    torch.cuda.synchronize()
    states_ms = (time.perf_counter() - t0) * 1e3
    check(hs.shape == (lm_batch, lm_seq, lm_cfg.d_model)
          and hs.dtype == torch.bfloat16 and bool(torch.isfinite(hs).all()),
          f"LM hidden states {tuple(hs.shape)} {hs.dtype}")
    t0 = time.perf_counter()
    lm_stats = elm_head.accumulate_stats(lm_fn, lm, lb, lm_classes)
    lm_beta = elm_head.solve(lm_stats, lm_lam)
    scores = elm_head.predict(lm_fn, lm, lm_beta, lb)
    torch.cuda.synchronize()
    lm_head_ms = (time.perf_counter() - t0) * 1e3
    lm_launches = dict(kernels.LAUNCHES)
    L = lm_cfg.num_layers
    want = want_launches(rmsnorm=3 * (4 * L + 1), swa_attention=3 * L,
                         elm_stats=1)
    check(lm_launches == want, f"LM head launches {lm_launches} != {want}")
    check(bool(torch.isfinite(scores).all()) and scores.shape == (
        lm_batch * lm_seq, lm_classes), "LM head scores")
    lm_bar, lm_own = solve_bar(torch, lm_beta, f64_solve(
        torch, lm_stats.u, lm_stats.v, lm_lam))
    ha = optimal_tanh(hs.reshape(1, lm_batch * lm_seq, -1)).float()
    ta = torch.nn.functional.one_hot(lb["targets"].reshape(1, -1),
                                     lm_classes).float()
    lm_rec = elm_stats_record(torch, rates, ha, ta, None, "LM head")
    emit("kernel", name="elm_stats", case="lm_head",
         vs_library=lm_rec["ms"] / lm_rec["library_ms"], **lm_rec)
    del lm, hs, ha, lm_stats
    torch.cuda.empty_cache()

    # parity: full width, cut to parity_layers layers, f32, card vs CPU
    pcfg = replace(get_config("qwen3_8b"), num_layers=parity_layers)
    pgen = torch.Generator(device=dev).manual_seed(1)
    card = api.init_params(pcfg, pgen, torch.float32, device=dev)
    host = tree_map(lambda a: a.cpu(), card)
    pb = {"tokens": torch.randint(0, pcfg.vocab_size, (lm_batch, lm_seq),
                                  generator=pgen, device=dev),
          "targets": torch.randint(0, lm_classes, (lm_batch, lm_seq),
                                   generator=pgen, device=dev)}
    pb_host = {k: v.cpu() for k, v in pb.items()}
    with torch.no_grad():
        hc = api.hidden_states(pcfg, card, pb)
        hh = api.hidden_states(pcfg, host, pb_host)
    h_err = float((hc.cpu() - hh).abs().max())
    h_top = float(hh.abs().max())
    check(h_err <= 1e-4 * h_top,
          f"LM states card vs CPU {h_err} > 1e-4 * {h_top}")
    # the head over the states just computed (any feature_fn)
    bc = elm_head.solve(elm_head.accumulate_stats(
        lambda q, b: hc, None, pb, lm_classes), lm_lam)
    sh = elm_head.accumulate_stats(lambda q, b: hh, None, pb_host,
                                   lm_classes)
    bh = elm_head.solve(sh, lm_lam)
    p_bar, p_own = solve_bar(torch, bh, f64_solve(torch, sh.u, sh.v,
                                                  lm_lam))
    p_d = float((bc.cpu() - bh).abs().max())
    check(p_d <= p_bar, f"LM head beta card vs CPU {p_d} > {p_bar}")
    # one finetune_step of the decoder on the ELM loss, card vs CPU, from
    # the CPU's β (solved on this batch) on a second batch: through the
    # rmsnorm and swa_attention backward kernels on the card
    fb = {"tokens": torch.randint(0, pcfg.vocab_size, (lm_batch, lm_seq),
                                  generator=pgen, device=dev),
          "targets": torch.randint(0, lm_classes, (lm_batch, lm_seq),
                                   generator=pgen, device=dev)}
    fb_host = {k: v.cpu() for k, v in fb.items()}

    def pfn(q, b):
        return api.hidden_states(pcfg, q, b)

    kernels.reset_launches()
    t0 = time.perf_counter()
    new_c, ft_loss_c = elm_head.finetune_step(pfn, card, bh.to(dev), fb,
                                              lm_classes, ft_lr)
    torch.cuda.synchronize()
    lm_ft_ms = (time.perf_counter() - t0) * 1e3
    ft_launches = dict(kernels.LAUNCHES)
    pl = parity_layers
    # remat: each layer's forward runs again in the backward
    want = want_launches(rmsnorm=2 * 4 * pl + 1, rmsnorm_bwd=4 * pl + 1,
                         swa_attention=2 * pl, swa_attention_bwd=pl)
    check(ft_launches == want,
          f"LM finetune launches {ft_launches} != {want}")
    new_h, ft_loss_h = elm_head.finetune_step(pfn, host, bh, fb_host,
                                              lm_classes, ft_lr)
    ft_loss_err = abs(float(ft_loss_c) - float(ft_loss_h))
    check(ft_loss_err <= 1e-4 * abs(float(ft_loss_h)),
          f"LM finetune loss card {float(ft_loss_c)} vs CPU "
          f"{float(ft_loss_h)}")
    ft_leaf = 0.0
    for a, b in zip(tree_leaves(new_c), tree_leaves(new_h)):
        rel = float((a.cpu() - b).abs().max()) / float(b.abs().max())
        ft_leaf = max(ft_leaf, rel)
    check(ft_leaf <= 1e-4, f"LM finetune leaves card vs CPU {ft_leaf} of "
          f"max|leaf| > 1e-4")
    del card, host, hc, new_c, new_h
    torch.cuda.empty_cache()
    emit("elm_head",
         cnn=dict(images=len(x), batch=batch, head_s_host_clock=head_s,
                  held_out_accuracy=cnn_acc, finetune_losses=losses,
                  finetune_lr=ft_lr, finetune_s_host_clock=ft_s,
                  launches=cnn_launches),
         lm=dict(arch=lm_cfg.name, layers=L, dtype="bfloat16",
                 batch=lm_batch, seq=lm_seq, classes=lm_classes, lam=lm_lam,
                 hidden_states_ms_host_clock=states_ms,
                 head_ms_host_clock=lm_head_ms, launches=lm_launches,
                 max_abs_beta=float(lm_beta.abs().max()),
                 f32_solve_err_beta=lm_own),
         lm_parity=dict(layers=parity_layers, dtype="float32",
                        max_abs_dh=h_err, max_abs_h=h_top,
                        bar_h=1e-4 * h_top, max_abs_dbeta=p_d,
                        bar_beta=p_bar, f32_solve_err_beta=p_own,
                        max_abs_beta=float(bh.abs().max()),
                        finetune=dict(lr=ft_lr, loss_card=float(ft_loss_c),
                                      loss_cpu=float(ft_loss_h),
                                      max_leaf_err_over_max=ft_leaf,
                                      bar=1e-4, launches=ft_launches,
                                      ms_host_clock=lm_ft_ms)))
    return lm_rec


def phase_resume(torch, dev, m, sgd):
    """Crash and resume on the card, on the ``map`` phase's shards at full
    width with the ``sgd`` phase's settings: the stacked two-round run
    crashed after round 0 by ``faults.crash_after`` (a torn round-1 file
    then left beside it must be skipped) and resumed; the sequential run
    crashed after member 1 and resumed; an elastic schedule with one
    leave and one join at boundary 0, stacked and sequential, and its
    stacked run crashed after round 0 and resumed. Each resumed run must
    equal its uninterrupted one (the ``sgd`` phase's runs, or the elastic
    run) under ``torch.equal``, and the stacked elastic run the
    sequential one."""
    import tempfile
    from repro_torch import kernels
    from repro_torch.checkpoint import run_state
    from repro_torch.core import faults
    from repro_torch.core.runner import (AveragingRun, ElasticEvent,
                                         ElasticSchedule, MapConfig,
                                         ReduceConfig)
    from repro_torch.optim.schedules import dynamic_paper
    from repro_torch.tree import tree_leaves

    cfg, parts = m["cfg"], m["parts"]
    kw = dict(init_params=m["init"], device=dev)

    def make(backend, rounds, elastic=None):
        return AveragingRun(cfg, MapConfig(
            epochs=sgd["epochs"], lr_schedule=dynamic_paper(sgd["lr_c"]),
            batch_size=m["batch"], backend=backend),
            ReduceConfig(rounds=rounds, elastic=elastic))

    def equal(a, b):
        return all(torch.equal(x, y) for x, y in zip(
            tree_leaves((a.cnn_params, a.beta)),
            tree_leaves((b.cnn_params, b.beta))))

    def runs_equal(a, b, names=None):
        pairs = (zip(a.members, b.members) if names is None else
                 ((a.members[n], b.members[n]) for n in names))
        return all(equal(x, y) for x, y in pairs) and equal(a.averaged,
                                                            b.averaged)

    out = {}
    with tempfile.TemporaryDirectory() as d:
        kernels.reset_launches()
        t0 = time.perf_counter()
        crashed = faults.run_to_crash(make("stacked", 2), parts, d,
                                      unit="round", index=0, **kw)
        crash_s = time.perf_counter() - t0
        faults.inject_torn_save(d, run_state.ROUND, 1, crash=False)
        check(crashed and run_state.latest_round(d) == 1
              and run_state.latest_ready_round(d) == 0,
              "stacked crash: round 0 saved, the torn round 1 skipped")
        t0 = time.perf_counter()
        res = make("stacked", 2).resume(parts, d, **kw)
        resume_s = time.perf_counter() - t0
        launches = dict(kernels.LAUNCHES)
        check(res.resumed and [r.round for r in res.rounds] == [1]
              and run_state.latest_ready_round(d) == 1,
              "stacked resume ran round 1 over the torn file")
        check(runs_equal(sgd["rounds2"], res),
              "stacked resume differs from the uninterrupted run")
        check(all(launches[n] > 0 for n in ("conv2d", "conv2d_dgrad",
                                            "conv2d_wgrad", "elm_stats")),
              f"stacked crash/resume launches {launches}")
        out["stacked"] = dict(rounds=2, crashed_after="round 0",
                              crash_s=crash_s, resume_s=resume_s,
                              torn_round_skipped=True, bitwise=True,
                              launches=launches)
    with tempfile.TemporaryDirectory() as d:
        t0 = time.perf_counter()
        crashed = faults.run_to_crash(make("sequential", 1), parts, d,
                                      unit="member", index=1, **kw)
        crash_s = time.perf_counter() - t0
        check(crashed and run_state.completed_members(d) == [0, 1],
              "sequential crash after member 1")
        t0 = time.perf_counter()
        res = make("sequential", 1).resume(parts, d, **kw)
        resume_s = time.perf_counter() - t0
        check(res.resumed and runs_equal(sgd["seq"], res),
              "sequential resume differs from the uninterrupted run")
        out["sequential"] = dict(crashed_after="member 1", crash_s=crash_s,
                                 resume_s=resume_s, bitwise=True)
    sched = ElasticSchedule((ElasticEvent(after_round=0, leave=("m3",),
                                          join=(parts[3],)),))
    t0 = time.perf_counter()
    ela = make("stacked", 2, sched).run(parts, **kw)
    ela_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    ela_seq = make("sequential", 2, sched).run(parts, **kw)
    ela_seq_s = time.perf_counter() - t0
    names = ["m0", "m1", "m2", "m4"]
    check(sorted(ela.members) == sorted(ela_seq.members) == names,
          f"elastic members {sorted(ela.members)}")
    check(runs_equal(ela, ela_seq, names),
          "elastic stacked differs from elastic sequential")
    with tempfile.TemporaryDirectory() as d:
        crashed, res = faults.run_crash_resume(make("stacked", 2, sched),
                                               parts, d, unit="round",
                                               index=0, **kw)
        check(crashed and res.resumed and runs_equal(ela, res, names),
              "elastic resume differs from the uninterrupted run")
    out["elastic"] = dict(schedule="m3 leaves and a joiner (m4) enters at "
                          "boundary 0", members=names, stacked_s=ela_s,
                          sequential_s=ela_seq_s,
                          stacked_equals_sequential=True,
                          resume_bitwise=True)
    emit("resume", **out)


def greedy_parity(torch, dev, cfg, card, host, batch, steps, what,
                  max_len, twin_rule=False):
    """Prefill ``batch`` and ``steps`` greedy decode steps on the card and
    on the port's CPU path from the same params (``host`` is ``card`` on
    the CPU), each step fed the CPU's tokens: each step's logits within
    1e-4 · max|logit| and its greedy tokens equal. With ``twin_rule`` a
    step that misses 1e-4 is held within twice the larger distance of the
    CPU's two one-ulp twins (the same run on params one ulp up and one ulp
    down, replayed from the prefill on first need): RWKV6 casts its group
    norm's output to bf16 in every precision, so a sum taken in another
    order can flip a bf16 rounding there and move a logit by ~1e-3; and a
    token may then differ only on a row whose two largest CPU logits lie
    within twice that step's card-vs-CPU distance (a tie within the
    rounding, recorded). ``api.prefill`` ignores ``max_len`` for the
    recurrent families; decode starts at ``max_len - steps``. Returns one
    record a step."""
    from repro_torch.models import api
    hb = {k: v.cpu() for k, v in batch.items()}
    lg_c, cache_c = api.prefill(cfg, card, batch, max_len)
    lg_h, cache_h = api.prefill(cfg, host, hb, max_len)
    pos0 = max_len - steps
    fed, twins, recs = [], None, []
    for t in range(steps + 1):
        c, h = lg_c.float().cpu(), lg_h.float()
        check(bool(torch.isfinite(c).all()), f"{what}: card logits at {t}")
        err, top = float((c - h).abs().max()), float(h.abs().max())
        own = None
        if err > 1e-4 * top:
            check(twin_rule, f"{what} step {t}: card vs CPU logits {err} > "
                  f"1e-4 * {top}")
            if twins is None:
                twins = []
                for d in (math.inf, -math.inf):
                    tp = nudged(torch, host, d)
                    lg, cache = api.prefill(cfg, tp, hb, max_len)
                    for i, tok in enumerate(fed):
                        lg, cache = api.decode_step(cfg, tp, cache, tok,
                                                    pos0 + i)
                    twins.append((tp, lg, cache))
            own = max(float((lg.float() - h).abs().max())
                      for _, lg, _ in twins)
            check(err <= 2 * own, f"{what} step {t}: card vs CPU logits "
                  f"{err} > 1e-4 * {top} and > twice the one-ulp twins' "
                  f"{own}")
        tc, th = c.argmax(-1), h.argmax(-1)
        miss = tc != th
        margin = None
        if bool(miss.any()):
            top2 = torch.topk(h, 2, dim=-1).values
            margin = float((top2[..., 0] - top2[..., 1])[miss].max())
            check(twin_rule and margin <= 2 * err, f"{what} step {t}: "
                  f"greedy tokens {tc.tolist()} (card) != {th.tolist()} "
                  f"(CPU), the largest top-2 margin of those rows {margin}")
        recs.append(dict(max_abs_err=err, max_abs_logit=top,
                         twins_max_abs_err=own, tokens=th[:, 0].tolist(),
                         token_ties=int(miss.sum()),
                         largest_top2_margin_of_ties=margin))
        if t == steps:
            break
        fed.append(th)
        lg_c, cache_c = api.decode_step(cfg, card, cache_c, th.to(dev),
                                        pos0 + t)
        lg_h, cache_h = api.decode_step(cfg, host, cache_h, th, pos0 + t)
        if twins is not None:
            twins = [(tp, *api.decode_step(cfg, tp, cache, th, pos0 + t))
                     for tp, _, cache in twins]
    return recs


def nudged(torch, tree, toward=math.inf):
    """``tree`` with every floating leaf moved one ulp toward ``toward``
    (up by default): a one-ulp twin of a CPU run, whose distance from the
    run measures how far the function's rounding alone can move it
    (``tools/sgd_sensitivity.py``)."""
    from repro_torch.tree import tree_map
    return tree_map(lambda a: torch.nextafter(a, torch.full_like(
        a, toward)) if a.is_floating_point() else a, tree)


def leaves_agree(torch, card, host, twin, what):
    """Leaf by leaf (gradients or steps of a tree), the card against the
    CPU: within 1e-4 · max|leaf|, or, where a leaf misses that and the
    function is ill-conditioned there, within twice the CPU's distance from
    its one-ulp twins' leaf (``twin``: a callable giving the twins' leaf
    lists, computed once, on first need; the largest distance counts).
    Returns the worst err / max|leaf| and the leaves held by the twin
    rule."""
    worst, by_twin, twins = 0.0, 0, None
    for i, (c, h) in enumerate(zip(card, host)):
        c, h = c.detach().float().cpu(), h.detach().float()
        err, top = float((c - h).abs().max()), float(h.abs().max())
        worst = max(worst, err / top if top else err)
        if err <= 1e-4 * top:
            continue
        if twins is None:
            twins = [[t.detach().float() for t in leaves]
                     for leaves in twin()]
        own = max(float((tw[i] - h).abs().max()) for tw in twins)
        check(err <= 2 * own, f"{what} leaf {i}: card vs CPU {err} > "
              f"1e-4 * {top} and > twice the one-ulp twins' {own}")
        by_twin += 1
    return worst, by_twin


def grads_of(torch, loss_of, params):
    """(the loss, the gradient of every leaf of ``params``) by autograd; a
    leaf the loss does not use gets zeros."""
    from repro_torch.tree import tree_leaves, tree_map
    leaves = [a.detach().requires_grad_(True) for a in tree_leaves(params)]
    it = iter(leaves)
    p = tree_map(lambda _: next(it), params)
    loss = loss_of(p)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    return loss.detach(), [torch.zeros_like(a) if g is None else g
                           for a, g in zip(leaves, grads)]


def phase_lm_parity(torch, dev, batch=2, prompt=16, steps=4):
    """(a) qwen3_8b at full width cut to 2 layers, f32: prefill and greedy
    decode on the card against the port's CPU path on the same params."""
    from repro_torch.configs import get_config, replace
    from repro_torch.models import api
    from repro_torch.tree import tree_map

    cfg = replace(get_config("qwen3_8b"), num_layers=2)
    gen = torch.Generator(device=dev).manual_seed(0)
    card = api.init_params(cfg, gen, torch.float32, device=dev)
    host = tree_map(lambda a: a.cpu(), card)
    prompts = torch.randint(0, cfg.vocab_size, (batch, prompt),
                            generator=gen, device=dev)
    recs = greedy_parity(torch, dev, cfg, card, host, {"tokens": prompts},
                         steps, "lm (a)", prompt + steps)
    errs, tops, tokens = ([r[k] for r in recs] for k in (
        "max_abs_err", "max_abs_logit", "tokens"))
    emit("lm_parity", arch=f"{cfg.name}, 2 of 36 layers, full width, f32",
         batch=batch, prompt=prompt, decode_steps=steps,
         max_abs_err=errs, max_abs_logit=tops,
         bar=[1e-4 * top for top in tops], tokens=tokens)
    del card, host
    torch.cuda.empty_cache()
    return max(errs)


def profile_once(torch, fn, groups=None):
    """One call of ``fn`` under torch.profiler: wall, device busy, idle
    share and the 8 largest device activities; with ``groups`` (label ->
    substrings of kernel names), each group's device ms and share of the
    busy time."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    rows = sorted(device_activity(torch, prof), reverse=True)
    busy = sum(us for us, _, _ in rows) / 1e3
    out = dict(wall_ms=wall, device_busy_ms=busy if rows else
               "not measured",
               idle_share=1 - busy / wall if rows else "not measured",
               top=[{"name": name[:60], "ms": us / 1e3, "count": count}
                    for us, name, count in rows[:8]])
    for label, keys in (groups or {}).items():
        ms = sum(us for us, name, _ in rows
                 if any(key in name for key in keys)) / 1e3
        out[f"{label}_ms"] = ms if rows else "not measured"
        out[f"{label}_share"] = ms / busy if rows else "not measured"
    return out


def lm_serving(torch, dev, arch, batch=4, prompt=128, gen=32):
    """An LM config at full size in bf16 through the port's
    ``launch.serve.run_lm``, as a user calls it (launches exact: the
    prefill's and every decode step's rmsnorm, the prefill's
    swa_attention; the transformers replay the prompt, the recurrent
    families decode from the prefill's state: Zamba2's forward launches
    rmsnorm 2 L + 2 I + 1 times over its I shared invocations, RWKV6 no
    kernel), then a warm run and one profiled prefill and decode step.
    Returns (the fields of its line, its launches)."""
    import argparse
    import numpy as np
    from repro_torch import kernels
    from repro_torch.configs import get_config
    from repro_torch.launch import serve
    from repro_torch.models import api, zamba2

    args = argparse.Namespace(arch=arch, reduced=False, seed=0,
                              device=str(dev), batch=batch, prompt_len=prompt,
                              gen=gen, greedy=True)
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    first = serve.run_lm(args)
    torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    cfg = get_config(arch)
    L = cfg.num_layers
    if cfg.family == "ssm_rwkv6":
        want = want_launches()
    elif cfg.family == "hybrid_zamba2":
        I = zamba2.num_attn_invocations(cfg)
        steps = 1 + gen - 1            # the prefill, then the decode
        want = want_launches(rmsnorm=steps * (2 * L + 2 * I + 1),
                             swa_attention=I)
    else:
        steps = 1 + prompt + gen - 1   # the prefill, the replay, the decode
        per_forward = (4 if cfg.qk_norm else 2) * L + 1
        want = want_launches(rmsnorm=steps * per_forward, swa_attention=L)
    check(launches == want, f"{arch} launches {launches} != {want}")
    toks = first["tokens"]
    check(first["logits_finite"], f"{arch}: logits are not finite")
    check(toks.shape == (batch, gen) and (toks >= 0).all()
          and (toks < cfg.vocab_size).all(), f"{arch}: token ids "
          f"{toks.shape}")
    warm = serve.run_lm(args)

    # one prefill and one decode step of the same model under the profiler
    gen_ = torch.Generator(device=dev).manual_seed(args.seed)
    params = api.init_params(cfg, gen_, device=dev)
    prompts = torch.randint(0, cfg.vocab_size, (batch, prompt),
                            generator=gen_, device=dev)
    api.prefill(cfg, params, {"tokens": prompts})                 # warm
    cache = api.init_cache(cfg, batch, prompt + gen, device=dev)
    tok = prompts[:, :1]
    for t in range(3):
        _, cache = api.decode_step(cfg, params, cache, tok, t)     # warm
    torch.cuda.synchronize()
    prof_prefill = profile_once(torch, lambda: api.prefill(
        cfg, params, {"tokens": prompts}))
    prof_decode = profile_once(torch, lambda: api.decode_step(
        cfg, params, cache, tok, 3))
    # the same step without the profiler's own host cost: host clock over
    # 10 steps that end in a synchronise
    t0 = time.perf_counter()
    for t in range(4, 14):
        api.decode_step(cfg, params, cache, tok, t)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3 / 10
    prof_decode["step_ms_unprofiled"] = step_ms
    # and the mean step of the warm run_lm's own decode loop
    loop_ms = 1e3 * batch / warm["tokens_per_s"]
    prof_decode["step_ms_run_lm_loop"] = loop_ms
    if isinstance(prof_decode["device_busy_ms"], float):
        busy = prof_decode["device_busy_ms"]
        prof_decode["idle_share_unprofiled"] = 1 - min(busy / step_ms, 1.0)
        prof_decode["idle_share_run_lm_loop"] = 1 - min(busy / loop_ms, 1.0)
    del params, cache
    torch.cuda.empty_cache()
    return (dict(arch=cfg.name, dtype="bfloat16", batch=batch, prompt=prompt,
                gen=gen, launches=launches, peak_memory_bytes=peak,
                prefill_ms_first=first["prefill_ms"],
                tokens_per_s_first=first["tokens_per_s"],
                prefill_ms=warm["prefill_ms"],
                tokens_per_s=warm["tokens_per_s"],
                prefill_replay_gap=first["prefill_replay_gap"],
                max_abs_logit=first["max_abs_logit"],
                tokens=toks[0, :16].tolist(),
                same_tokens_warm=bool(np.array_equal(toks, warm["tokens"])),
                profile_prefill=prof_prefill,
                profile_decode_step=prof_decode), launches, first)


def phase_lm(torch, dev, batch=4, prompt=128, gen=32):
    """(b) the slice itself: the full qwen3_8b in bf16 through the port's
    ``launch.serve.run_lm``, as a user calls it; then a warm run and one
    profiled prefill and decode step."""
    fields, launches, first = lm_serving(torch, dev, "qwen3_8b", batch,
                                         prompt, gen)
    emit("lm", **fields)
    return launches, first


def phase_lm_mesh(torch, dev, lm_first, lm_launches, batch=4, prompt=128,
                  gen=32):
    """(b) under the mesh context at world size 1 over NCCL: the same
    ``run_lm`` on a (data 1 × model 1) mesh, whose axes of size 1 move
    nothing, so the tokens and logits must be phase ``lm``'s bit for bit,
    the launches its own and no collective called; its prefill ms and
    tokens/s beside phase ``lm``'s first run. Returns the launches."""
    import argparse
    import numpy as np
    from repro_torch import kernels
    from repro_torch.distributed import collectives, ctx
    from repro_torch.launch import serve
    from repro_torch.launch.mesh import make_lm_mesh, process_group

    args = argparse.Namespace(arch="qwen3_8b", reduced=False, seed=0,
                              device=str(dev), batch=batch, prompt_len=prompt,
                              gen=gen, greedy=True)
    t0 = time.perf_counter()
    with process_group(device=dev):
        mesh = make_lm_mesh({"data": 1, "model": 1})
        collectives.reset()
        kernels.reset_launches()
        with ctx.use_mesh_rules(mesh):
            out = serve.run_lm(args)
        torch.cuda.synchronize()
        launches = dict(kernels.LAUNCHES)
        calls = {f"{kind}/{label}": n for (kind, label), n in
                 collectives.CALLS.items()}
    wall = time.perf_counter() - t0
    check(np.array_equal(out["tokens"], lm_first["tokens"]),
          "lm_mesh: tokens differ from phase lm's")
    check(torch.equal(out["prefill_logits"], lm_first["prefill_logits"]),
          "lm_mesh: prefill logits not bitwise phase lm's")
    check(torch.equal(out["last_logits"], lm_first["last_logits"]),
          "lm_mesh: last decode logits not bitwise phase lm's")
    check(launches == lm_launches, f"lm_mesh: launches {launches} != "
          f"phase lm's {lm_launches}")
    check(not calls, f"lm_mesh: collectives over axes of size 1 {calls}")
    emit("lm_mesh", mesh=dict(mesh.shape), world=1,
         tokens_equal=True, logits_bitwise=True, launches=launches,
         collectives=calls, prefill_ms_first=out["prefill_ms"],
         tokens_per_s_first=out["tokens_per_s"],
         lm_prefill_ms_first=lm_first["prefill_ms"],
         lm_tokens_per_s_first=lm_first["tokens_per_s"], wall_s=wall)
    del out
    torch.cuda.empty_cache()
    return launches


POD_PEAK_LIMIT = 70e9     # a train combo deeper than fits is cut
# kernel-name substrings of the hand kernels on phase pod's train step
# (the attention's kernels live in namespace swa_full)
POD_GROUPS = {"attention": ("swa_full::",), "norms": ("rmsnorm",)}


def phase_pod(torch, dev):
    """Rank 0 of the reference's 16 × 16 (data, model) mesh on the card,
    under a fake process group of 256 ranks (its collectives send nothing;
    what they leave in the gathered blocks is not checked, so the values
    are not compared: the sharded step's values are the gloo CPU tests'),
    at seven combos — Qwen3-8B's prefill and decode, OLMoE-1B-7B's
    prefill, the train_4k steps of Qwen3-8B, RWKV6-3B and Zamba2-1.2B
    (their blocks of the params, AdamW's μ and ν and 16 × 4,096 tokens;
    the layers recomputed in the backward, Zamba2's shared block not;
    full depth where the trace's peak is within ``POD_PEAK_LIMIT``, else
    the fewest layers cut that fit, printed as a cut) and Zamba2-1.2B's
    decode (its KV slots split by sequence) — each held against
    the dry run's trace of the same combo exactly: the kernel operators'
    calls against the launches, the argument bytes against the storages
    the card's step takes, the FLOPs against ``FlopCounterMode``'s count,
    and the collectives' calls and bytes by axis. Printed: the trace's
    peak over the card's, the step's wall, the device's busy time (one
    profiled step) over the roofline, and (the train step) the
    attention's and the norms' share of the busy time. Returns the
    launches."""
    from collections import Counter
    from torch.utils.flop_counter import FlopCounterMode
    from repro_torch import kernels
    from repro_torch.configs import INPUT_SHAPES, get_config, replace
    from repro_torch.distributed import collectives
    from repro_torch.launch import dryrun
    from repro_torch.tree import tree_leaves

    t_phase = time.perf_counter()
    g = torch.Generator(device=dev).manual_seed(4)
    total = Counter()
    for arch, shape_name in (("qwen3_8b", "prefill_32k"),
                             ("qwen3_8b", "decode_32k"),
                             ("olmoe_1b_7b", "prefill_32k"),
                             ("qwen3_8b", "train_4k"),
                             ("rwkv6_3b", "train_4k"),
                             ("zamba2_1p2b", "train_4k"),
                             ("zamba2_1p2b", "decode_32k")):
        shape = INPUT_SHAPES[shape_name]
        cfg = dryrun.shape_cfg(get_config(arch), shape)
        t0 = time.perf_counter()
        dry = dryrun.trace_mesh_combo(cfg, shape, "pod")
        cut = None
        while dry["memory"]["peak_bytes_per_card"] > POD_PEAK_LIMIT:
            cfg = replace(cfg, num_layers=cfg.num_layers - 4)
            cut = f"{cfg.num_layers} of {get_config(arch).num_layers} layers"
            dry = dryrun.trace_mesh_combo(cfg, shape, "pod")
        trace_s = time.perf_counter() - t0
        train = shape.kind == "train"
        with dryrun.lm_mesh("pod") as frame:
            args = dryrun.mesh_step_args(cfg, shape, device=dev,
                                         generator=g)
            fn = dryrun.step_fn(cfg, shape)
            arg_bytes = sum({t.untyped_storage().data_ptr():
                             t.untyped_storage().nbytes()
                             for t in tree_leaves(list(args))
                             if isinstance(t, torch.Tensor)}.values())
            torch.cuda.synchronize()
            resident = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            kernels.reset_launches()
            calls0 = Counter(collectives.CALLS)
            bytes0 = Counter(collectives.BYTES)
            t0 = time.perf_counter()
            with FlopCounterMode(display=False) as fc:
                out = fn(*args)
            torch.cuda.synchronize()
            card_s = time.perf_counter() - t0
            launches = {k: n for k, n in kernels.LAUNCHES.items() if n}
            coll = dryrun._coll_growth(calls0, bytes0).as_dict()
            step_peak = torch.cuda.max_memory_allocated() - (resident
                                                             - arg_bytes)
            flops = fc.get_total_flops()
            del out
            prof = profile_once(torch, lambda: fn(*args),
                                POD_GROUPS if train else None)
            coord = dict(frame.mesh.coord)
        tag = f"{arch} {shape_name}"
        check(launches == dry["kernels"], f"pod {tag}: kernel operator "
              f"calls {dry['kernels']} != the card's launches {launches}")
        check(arg_bytes == dry["memory"]["argument_bytes_per_card"],
              f"pod {tag}: argument bytes {dry['memory']} != the card's "
              f"{arg_bytes}")
        check(flops == dry["cost"]["flops_per_card"], f"pod {tag}: FLOPs "
              f"{dry['cost']['flops_per_card']} != the card's {flops}")
        check(coll == dry["collectives"], f"pod {tag}: collectives "
              f"{dry['collectives']} != the card's {coll}")
        total.update(launches)
        roof = dry["roofline"]
        roof_ms = 1e3 * max(roof["t_compute_s"], roof["t_memory_s"],
                            roof["t_collective_s"])
        busy = prof["device_busy_ms"]
        extra = {}
        if train:
            extra = dict(
                layers=cfg.num_layers, cut=cut or "none",
                collectives_backward=dry["collectives_backward"],
                step_wall_ms_profiled=prof["wall_ms"],
                idle_share=prof["idle_share"],
                attention_ms=prof["attention_ms"],
                attention_share_of_busy=prof["attention_share"],
                norms_ms=prof["norms_ms"],
                norms_share_of_busy=prof["norms_share"], top=prof["top"])
        emit("pod", case=tag, mesh=dry["mesh_shape"], rank=0, coord=coord,
             arch=cfg.name, shape=[shape.global_batch, shape.seq_len],
             kind=shape.kind, kernels=dry["kernels"], launches=launches,
             argument_bytes=arg_bytes, flops=flops,
             collectives=dry["collectives"],
             peak_estimate_bytes=dry["memory"]["peak_bytes_per_card"],
             card_step_peak_bytes=step_peak,
             peak_estimate_over_card=dry["memory"]["peak_bytes_per_card"]
             / step_peak,
             roofline_ms=roof_ms, dominant=roof["dominant"],
             roofline_terms_ms={k: 1e3 * v for k, v in roof.items()
                                if k.startswith("t_")},
             device_busy_ms=busy,
             busy_over_roofline=busy / roof_ms if isinstance(busy, float)
             else "not measured",
             card_step_s_host_clock=card_s, trace_s_host_clock=trace_s,
             card=dry["card"], **extra)
        del args
        torch.cuda.empty_cache()
    emit("pod_wall", seconds=time.perf_counter() - t_phase)
    return dict(total)


def phase_zoo(torch, dev, parity_layers=2, vlm_layers=8, vlm_patches=1024,
              batch=4, prompt=128, gen=32, frames=1024, head_batches=6,
              ft_lr=1e-2):
    """The LM zoo's transformer families on the card.
    (a) parity, f32, full width cut to ``parity_layers`` layers, card vs
    the port's CPU path on the same params within 1e-4 · max|logit|:
    olmoe_1b_7b's prefill and 4 greedy decode steps (equal tokens; the
    routers' top-k choices counted on both sides), hubert_xlarge's encode
    logits and hidden states, internvl2_26b's prefill with
    ``vlm_patches`` patch slots and 16 text tokens at batch 1.
    (b) olmoe_1b_7b and minicpm_2b at full size in bf16 through
    ``run_lm`` (``lm_serving``).
    (c) hubert_xlarge at full size in bf16: ``trainer.make_prefill_step``
    (the encode) on ``batch`` × ``frames`` frames (launches exact: one
    non-causal swa_attention a layer, 2 L + 1 rmsnorm), then the ELM head
    on ``tests/test_elm_head.py``'s frame task (6 classes, class embeddings
    plus 0.4 noise) over ``head_batches`` batches at λ 100, a held-out
    batch above 0.5 accuracy, then a ``finetune_step`` on that batch
    through the backward kernels (launches exact) whose step at learning
    rate ``ft_lr`` lowers its ELM loss.
    (d) internvl2_26b at full width cut to ``vlm_layers`` layers:
    ``api.prefill`` of ``batch`` × ``prompt`` tokens behind ``vlm_patches``
    patch slots, then ``gen`` greedy ``api.decode_step``s (launches
    exact). Returns the launches of (b)–(d) summed."""
    import torch.nn.functional as F
    from repro_torch import kernels
    from repro_torch.configs import get_config, replace
    from repro_torch.core import elm, elm_head, trainer
    from repro_torch.layers import mlp
    from repro_torch.models import api
    from repro_torch.tree import tree_leaves, tree_map

    t_phase = time.perf_counter()
    total = want_launches()

    def add(launches):
        for name, n in launches.items():
            total[name] += n

    def close(tag, c, h):
        c, h = c.float().cpu(), h.float()
        err, top = float((c - h).abs().max()), float(h.abs().max())
        check(bool(torch.isfinite(c).all()), f"zoo (a) {tag}: not finite")
        check(err <= 1e-4 * top,
              f"zoo (a) {tag}: card vs CPU {err} > 1e-4 * {top}")
        return dict(max_abs_err=err, max_abs_ref=top, bar=1e-4 * top)

    # (a) parity
    t0 = time.perf_counter()
    parity = {}
    cfg = replace(get_config("olmoe_1b_7b"), num_layers=parity_layers)
    g = torch.Generator(device=dev).manual_seed(10)
    card = api.init_params(cfg, g, torch.float32, device=dev)
    host = tree_map(lambda a: a.cpu(), card)
    prompts = torch.randint(0, cfg.vocab_size, (2, 16), generator=g,
                            device=dev)
    routes, route = [], mlp.route

    def recording(p, x, k, *rest):
        out = route(p, x, k, *rest)
        routes.append((x.is_cuda, out[0].detach().cpu(),
                       out[2].detach().cpu()))
        return out

    mlp.route = recording
    try:
        recs = greedy_parity(torch, dev, cfg, card, host,
                             {"tokens": prompts}, 4, "zoo (a) olmoe", 20)
    finally:
        mlp.route = route
    # each router call on the card against the same call on the CPU
    card_r = [r[1:] for r in routes if r[0]]
    host_r = [r[1:] for r in routes if not r[0]]
    check(len(card_r) == len(host_r) == 5 * parity_layers,
          "zoo (a): router calls")
    agree, choices, margin = 0, 0, float("inf")
    for (_, ic), (ph, ih) in zip(card_r, host_r):
        # the chosen sets (the order inside the top k changes nothing)
        agree += int((ic.sort(-1).values == ih.sort(-1).values).sum())
        choices += ic.numel()
        top = torch.sort(ph, dim=-1, descending=True).values
        k = ic.shape[-1]
        margin = min(margin, float((top[..., k - 1] - top[..., k]).min()))
    errs, tops, tokens = ([r[k] for r in recs] for k in (
        "max_abs_err", "max_abs_logit", "tokens"))
    parity["olmoe_1b_7b"] = dict(
        max_abs_err=errs, max_abs_logit=tops,
        bar=[1e-4 * t for t in tops], tokens=tokens,
        route_choices_agree=agree, route_choices=choices,
        smallest_top_k_margin=margin)
    del card, host
    torch.cuda.empty_cache()

    cfg = replace(get_config("hubert_xlarge"), num_layers=parity_layers)
    g = torch.Generator(device=dev).manual_seed(11)
    card = api.init_params(cfg, g, torch.float32, device=dev)
    host = tree_map(lambda a: a.cpu(), card)
    fb = {"frames": torch.randn((2, 256, 512), generator=g, device=dev)}
    fh = {"frames": fb["frames"].cpu()}
    encode = trainer.make_prefill_step(cfg)
    with torch.no_grad():
        parity["hubert_xlarge"] = dict(
            logits=close("hubert logits", encode(card, fb),
                         encode(host, fh)),
            hidden_states=close("hubert states",
                                api.hidden_states(cfg, card, fb),
                                api.hidden_states(cfg, host, fh)))
    # one finetune_step of its ELM head (6 classes, β solved on the CPU's
    # states of this batch) on a second batch, through the non-causal
    # swa_attention_bwd and rmsnorm_bwd (launches exact): its loss within
    # rtol 1e-4 of the CPU's, and the gradient it steps by, taken on both
    # sides through the same ELM loss, leaf by leaf within 1e-4 · max|leaf|
    # or twice the CPU's distance from its one-ulp twin's leaf. (On the
    # batch β was solved on, 512 rows of 1,280 states, the fit is exact
    # and the loss ~5e-8: rounding alone.)
    fh["targets"] = torch.randint(0, 6, (2, 256), generator=g,
                                  device=dev).cpu()

    def hfn(p, b):
        return api.hidden_states(cfg, p, b)

    hbeta = elm_head.solve(elm_head.accumulate_stats(hfn, host, fh, 6), 10.0)
    fb = {"frames": torch.randn((2, 256, 512), generator=g, device=dev),
          "targets": torch.randint(0, 6, (2, 256), generator=g,
                                   device=dev)}
    fh = {k: v.cpu() for k, v in fb.items()}
    kernels.reset_launches()
    new_c, loss_c = elm_head.finetune_step(hfn, card, hbeta.to(dev), fb, 6,
                                           1e-3)
    torch.cuda.synchronize()
    ft_launches = dict(kernels.LAUNCHES)
    pl = parity_layers
    # remat: each layer's forward runs again in the backward
    want = want_launches(rmsnorm=2 * 2 * pl + 1, rmsnorm_bwd=2 * pl + 1,
                         swa_attention=2 * pl, swa_attention_bwd=pl)
    check(ft_launches == want,
          f"zoo (a) hubert finetune launches {ft_launches} != {want}")
    add(ft_launches)

    def elm_loss_of(beta, b):
        def loss_of(p):
            h = hfn(p, b)
            t = F.one_hot(b["targets"].reshape(-1), 6).float()
            return elm.elm_loss(h.reshape(-1, h.shape[-1]), beta, t)
        return loss_of

    loss_h, g_h = grads_of(torch, elm_loss_of(hbeta, fh), host)
    check(abs(float(loss_c) - float(loss_h)) <= 1e-4 * abs(float(loss_h)),
          f"zoo (a) hubert finetune loss card {float(loss_c)} vs CPU "
          f"{float(loss_h)}")
    _, g_c = grads_of(torch, elm_loss_of(hbeta.to(dev), fb), card)
    worst, by_twin = leaves_agree(
        torch, g_c, g_h,
        lambda: [grads_of(torch, elm_loss_of(hbeta, fh),
                          nudged(torch, host))[1]],
        "zoo (a) hubert finetune gradient")
    parity["hubert_xlarge"]["finetune"] = dict(
        lr=1e-3, loss_card=float(loss_c), loss_cpu=float(loss_h),
        max_grad_err_over_max=worst, leaves_by_twin_rule=by_twin,
        max_abs_grad=max(float(g.abs().max()) for g in g_h),
        launches=ft_launches)
    del card, host, new_c, g_c, g_h
    torch.cuda.empty_cache()

    cfg = replace(get_config("internvl2_26b"), num_layers=parity_layers)
    g = torch.Generator(device=dev).manual_seed(12)
    card = api.init_params(cfg, g, torch.float32, device=dev)
    host = tree_map(lambda a: a.cpu(), card)
    vb = {"tokens": torch.randint(0, cfg.vocab_size, (1, 16), generator=g,
                                  device=dev),
          "patches": torch.randn((1, vlm_patches, 1024), generator=g,
                                 device=dev)}
    t1 = time.perf_counter()
    lg_h, _ = api.prefill(cfg, host, {k: v.cpu() for k, v in vb.items()})
    cpu_s = time.perf_counter() - t1
    lg_c, _ = api.prefill(cfg, card, vb)
    parity["internvl2_26b"] = dict(
        patch_slots=vlm_patches, text_tokens=16, cpu_prefill_s=cpu_s,
        **close("internvl2 prefill", lg_c, lg_h))
    check(torch.equal(lg_c.cpu().argmax(-1), lg_h.argmax(-1)),
          "zoo (a) internvl2: greedy token")
    del card, host, lg_c, lg_h
    torch.cuda.empty_cache()
    emit("zoo_parity", layers=parity_layers, dtype="float32",
         cut=f"depth {parity_layers} layers a config, full width",
         wall_s=time.perf_counter() - t0, **parity)

    # (b) OLMoE-1B-7B and MiniCPM-2B at full size through run_lm
    for arch in ("olmoe_1b_7b", "minicpm_2b"):
        fields, launches, _ = lm_serving(torch, dev, arch, batch, prompt,
                                         gen)
        add(launches)
        emit(f"zoo_{arch}", cut="none", **fields)

    # (c) HuBERT-XLarge at full size, bf16: the encode and the ELM head
    cfg = get_config("hubert_xlarge")
    L, C = cfg.num_layers, 6
    g = torch.Generator(device=dev).manual_seed(13)
    torch.cuda.reset_peak_memory_stats()
    params = api.init_params(cfg, g, device=dev)
    class_emb = torch.randn((C, 512), generator=g, device=dev)

    def frame_batch():
        y = torch.randint(0, C, (batch, frames), generator=g, device=dev)
        x = class_emb[y] + 0.4 * torch.randn((batch, frames, 512),
                                             generator=g, device=dev)
        return {"frames": x.to(torch.bfloat16), "targets": y}

    encode = trainer.make_prefill_step(cfg)
    fb = frame_batch()
    with torch.no_grad():
        encode(params, fb)                                      # warm
        torch.cuda.synchronize()
        kernels.reset_launches()
        t0 = time.perf_counter()
        logits = encode(params, fb)
        torch.cuda.synchronize()
        encode_ms = (time.perf_counter() - t0) * 1e3
        enc_launches = dict(kernels.LAUNCHES)
        want = want_launches(rmsnorm=2 * L + 1, swa_attention=L)
        check(enc_launches == want,
              f"hubert encode launches {enc_launches} != {want}")
        check(logits.shape == (batch, frames, cfg.vocab_size)
              and bool(torch.isfinite(logits).all()), "hubert logits")
        add(enc_launches)
        prof_encode = profile_once(torch, lambda: encode(params, fb))

    def feature_fn(p, b):
        return api.hidden_states(cfg, p, b)

    kernels.reset_launches()
    t0 = time.perf_counter()
    stats = None
    for _ in range(head_batches):
        stats = elm_head.accumulate_stats(feature_fn, params, frame_batch(),
                                          C, stats)
    beta = elm_head.solve(stats, 100.0)
    held = frame_batch()
    pred = elm_head.predict(feature_fn, params, beta, held).argmax(-1)
    torch.cuda.synchronize()
    head_ms = (time.perf_counter() - t0) * 1e3
    head_launches = dict(kernels.LAUNCHES)
    acc = float((pred.reshape(held["targets"].shape) == held["targets"])
                .float().mean())
    n_enc = head_batches + 1
    want = want_launches(rmsnorm=n_enc * (2 * L + 1),
                         swa_attention=n_enc * L, elm_stats=head_batches)
    check(head_launches == want,
          f"hubert head launches {head_launches} != {want}")
    check(acc > 0.5, f"hubert head held-out accuracy {acc} <= 0.5")
    add(head_launches)
    # a fine-tune step of the backbone on the ELM loss (Alg. 2 lines
    # 13-14), on the card through the non-causal swa_attention_bwd, on the
    # held-out batch: the loss at the stepped weights below the loss before.
    # The weights are bf16, so a step below half a bf16 ulp of a weight is
    # lost in the cast: ``ft_lr`` is large enough to move them
    kernels.reset_launches()
    t0 = time.perf_counter()
    tuned, ft_loss0 = elm_head.finetune_step(feature_fn, params, beta, held,
                                             C, ft_lr)
    torch.cuda.synchronize()
    ft_ms = (time.perf_counter() - t0) * 1e3
    ft_launches = dict(kernels.LAUNCHES)
    want = want_launches(rmsnorm=2 * 2 * L + 1, rmsnorm_bwd=2 * L + 1,
                         swa_attention=2 * L, swa_attention_bwd=L)
    check(ft_launches == want,
          f"hubert finetune launches {ft_launches} != {want}")
    add(ft_launches)
    with torch.no_grad():
        scores = elm_head.predict(feature_fn, tuned, beta, held)
        t_ = F.one_hot(held["targets"].reshape(-1), C).float()
        ft_loss1 = float(0.5 * ((scores - t_) ** 2).sum(-1).mean())
    check(math.isfinite(float(ft_loss0)) and ft_loss1 < float(ft_loss0),
          f"hubert finetune loss {float(ft_loss0)} -> {ft_loss1} at lr "
          f"{ft_lr}: does not fall")
    emit("zoo_hubert_xlarge", arch=cfg.name, dtype="bfloat16", cut="none",
         batch=batch, frames=frames, encode_ms=encode_ms,
         encode_launches=enc_launches, profile_encode=prof_encode,
         head=dict(classes=C, lam=100.0, batches=head_batches,
                   rows=head_batches * batch * frames, held_out_accuracy=acc,
                   launches=head_launches, ms_host_clock=head_ms,
                   max_abs_beta=float(beta.abs().max())),
         finetune=dict(loss_before=float(ft_loss0), lr=ft_lr,
                       loss_after=ft_loss1,
                       launches_a_step=ft_launches,
                       step_ms_host_clock=ft_ms),
         peak_memory_bytes=torch.cuda.max_memory_allocated())
    del params, tuned, logits, stats, beta
    torch.cuda.empty_cache()

    # (d) InternVL2-26B at full width cut to vlm_layers layers
    cfg = replace(get_config("internvl2_26b"), num_layers=vlm_layers)
    L = cfg.num_layers
    g = torch.Generator(device=dev).manual_seed(14)
    torch.cuda.reset_peak_memory_stats()
    params = api.init_params(cfg, g, device=dev)
    vb = {"tokens": torch.randint(0, cfg.vocab_size, (batch, prompt),
                                  generator=g, device=dev),
          "patches": torch.randn((batch, vlm_patches, 1024), generator=g,
                                 device=dev).to(torch.bfloat16)}
    pos0 = vlm_patches + prompt
    api.prefill(cfg, params, vb, max_len=pos0 + gen)              # warm
    torch.cuda.synchronize()
    kernels.reset_launches()
    t0 = time.perf_counter()
    logits, cache = api.prefill(cfg, params, vb, max_len=pos0 + gen)
    torch.cuda.synchronize()
    prefill_ms = (time.perf_counter() - t0) * 1e3
    finite = bool(torch.isfinite(logits).all())
    tok = torch.argmax(logits[:, -1:], dim=-1)
    out = [tok]
    t0 = time.perf_counter()
    for t in range(gen):
        logits, cache = api.decode_step(cfg, params, cache, tok, pos0 + t)
        tok = torch.argmax(logits[:, -1:], dim=-1)
        out.append(tok)
    torch.cuda.synchronize()
    decode_s = time.perf_counter() - t0
    vlm_launches = dict(kernels.LAUNCHES)
    want = want_launches(rmsnorm=(1 + gen) * (2 * L + 1), swa_attention=L)
    check(vlm_launches == want,
          f"internvl2 launches {vlm_launches} != {want}")
    finite = finite and bool(torch.isfinite(logits).all())
    check(finite, "internvl2: logits are not finite")
    toks = torch.cat(out, dim=1).cpu()
    check(bool(((toks >= 0) & (toks < cfg.vocab_size)).all()),
          "internvl2: token ids")
    add(vlm_launches)
    emit("zoo_internvl2_26b", arch=cfg.name, dtype="bfloat16",
         cut=f"depth {L} of 48 layers, full width", batch=batch,
         patch_slots=vlm_patches, prompt=prompt, gen=gen,
         launches=vlm_launches, prefill_ms=prefill_ms,
         tokens_per_s=batch * gen / decode_s,
         tokens=toks[0, :16].tolist(),
         peak_memory_bytes=torch.cuda.max_memory_allocated())
    del params, cache, logits
    torch.cuda.empty_cache()
    emit("zoo", wall_s=time.perf_counter() - t_phase, launches=total)
    return total


def phase_recurrent(torch, dev, parity_layers=2, parity_prompt=32,
                    parity_steps=4, batch=4, prompt=128, gen=32,
                    head_classes=16, head_lam=10.0):
    """The LM zoo's recurrent families on the card.
    (a) f32, full width cut to ``parity_layers`` layers (Zamba2 with
    ``shared_attn_every`` = 2, so one shared invocation runs; chunks shrunk
    to the prompt as ``run_lm`` does), batch 2, ``parity_prompt`` tokens:
    RWKV6's prefill (chunked) and Zamba2's, then ``parity_steps`` greedy
    decode steps, card vs the port's CPU path (``greedy_parity`` with
    its twin rule); one
    ``loss_fn`` gradient of each (launches exact: Zamba2's through
    swa_attention_bwd at hd 64, H 32/32 and rmsnorm_bwd at 2,048 and
    4,096), every leaf within 1e-4 · max|leaf| or twice the larger distance
    of the CPU's two one-ulp twins' leaf.
    (b) rwkv6_3b and zamba2_1p2b at full size in bf16 through ``run_lm``
    (``lm_serving``; launches exact).
    (c) the ELM head over the full RWKV6-3B in bf16: ``hidden_states`` of
    ``batch`` × ``prompt`` tokens, ``head_classes`` classes, λ
    ``head_lam`` (one elm_stats launch).
    (d) two recorded numbers, with no gate: the full-depth RWKV6's
    chunked forward against its scan, bf16 and f32, on (c)'s tokens, with
    the deepest log-decay sum inside a chunk (the chunked form clamps at
    -30); and ROADMAP R7 at full size, bf16 and f32: Zamba2's decode of
    the next token after ``api.prefill`` of ``batch`` × ``prompt`` tokens
    against ``forward`` of the prompt plus that token, beside the same
    decode from a cache padded by 4 empty slots. Returns the launches of
    (a)–(c)."""
    from repro_torch import kernels
    from repro_torch.configs import get_config, replace
    from repro_torch.core import elm_head
    from repro_torch.models import api, rwkv6, zamba2
    from repro_torch.tree import tree_map

    t_phase = time.perf_counter()
    total = want_launches()

    def add(launches):
        for name, n in launches.items():
            total[name] += n

    # (a) parity, f32
    t0 = time.perf_counter()
    parity = {}
    for arch, seed in (("rwkv6_3b", 20), ("zamba2_1p2b", 21)):
        cfg = replace(get_config(arch), num_layers=parity_layers)
        if cfg.family == "hybrid_zamba2":
            cfg = replace(cfg, shared_attn_every=2)
        if cfg.ssm_chunk > parity_prompt:
            cfg = replace(cfg, ssm_chunk=max(8, parity_prompt // 4))
        g = torch.Generator(device=dev).manual_seed(seed)
        card = api.init_params(cfg, g, torch.float32, device=dev)
        host = tree_map(lambda a: a.cpu(), card)
        prompts = torch.randint(0, cfg.vocab_size, (2, parity_prompt),
                                generator=g, device=dev)
        steps = greedy_parity(torch, dev, cfg, card, host,
                              {"tokens": prompts}, parity_steps,
                              f"recurrent (a) {arch}",
                              parity_prompt + parity_steps, twin_rule=True)
        b = {"tokens": prompts,
             "targets": torch.randint(0, cfg.vocab_size, prompts.shape,
                                      generator=g, device=dev)}
        bh = {k: v.cpu() for k, v in b.items()}
        kernels.reset_launches()
        loss_c, g_c = grads_of(torch, lambda p: api.loss_fn(cfg, p, b)[0],
                               card)
        torch.cuda.synchronize()
        launches = dict(kernels.LAUNCHES)
        if cfg.family == "hybrid_zamba2":
            # each mamba block is recomputed in the backward (remat): its
            # ln and gate norm launch a second time; the shared block is not
            L, I = cfg.num_layers, zamba2.num_attn_invocations(cfg)
            n = 2 * L + 2 * I + 1
            want = want_launches(rmsnorm=n + 2 * L, rmsnorm_bwd=n,
                                 swa_attention=I, swa_attention_bwd=I)
        else:
            want = want_launches()
        check(launches == want, f"recurrent (a) {arch} gradient launches "
              f"{launches} != {want}")
        add(launches)
        loss_h, g_h = grads_of(torch, lambda p: api.loss_fn(cfg, p, bh)[0],
                               host)
        twin_losses = []

        def twin_grads():
            out = []
            for d in (math.inf, -math.inf):
                loss, grads = grads_of(
                    torch, lambda p: api.loss_fn(cfg, p, bh)[0],
                    nudged(torch, host, d))
                twin_losses.append(float(loss))
                out.append(grads)
            return out

        worst, by_twin = leaves_agree(torch, g_c, g_h, twin_grads,
                                      f"recurrent (a) {arch} gradient")
        loss_err = abs(float(loss_c) - float(loss_h))
        check(loss_err <= 1e-4 * abs(float(loss_h)) or any(
            loss_err <= 2 * abs(t - float(loss_h)) for t in twin_losses),
            f"recurrent (a) {arch} loss card {float(loss_c)} vs CPU "
            f"{float(loss_h)}")
        parity[arch] = dict(
            layers=parity_layers, chunk=cfg.ssm_chunk, prompt=parity_prompt,
            steps=steps, loss_card=float(loss_c), loss_cpu=float(loss_h),
            max_grad_err_over_max=worst, leaves_by_twin_rule=by_twin,
            gradient_launches=launches)
        del card, host, g_c, g_h
        torch.cuda.empty_cache()
    emit("recurrent_parity", dtype="float32",
         cut=f"depth {parity_layers} layers a config, full width",
         wall_s=time.perf_counter() - t0, **parity)

    # (b) both at full size through run_lm
    for arch in ("rwkv6_3b", "zamba2_1p2b"):
        fields, launches, _ = lm_serving(torch, dev, arch, batch, prompt,
                                         gen)
        add(launches)
        emit(f"recurrent_{arch}", cut="none", **fields)

    # (c) the ELM head over the full RWKV6-3B, and (d) its chunked form
    # against its scan at full depth
    cfg = get_config("rwkv6_3b")
    g = torch.Generator(device=dev).manual_seed(22)
    torch.cuda.reset_peak_memory_stats()
    params = api.init_params(cfg, g, device=dev)
    hb = {"tokens": torch.randint(0, cfg.vocab_size, (batch, prompt),
                                  generator=g, device=dev),
          "targets": torch.randint(0, head_classes, (batch, prompt),
                                   generator=g, device=dev)}

    def feature_fn(p, b):
        return api.hidden_states(cfg, p, b)

    torch.cuda.synchronize()
    kernels.reset_launches()
    t0 = time.perf_counter()
    stats = elm_head.accumulate_stats(feature_fn, params, hb, head_classes)
    beta = elm_head.solve(stats, head_lam)
    scores = elm_head.predict(feature_fn, params, beta, hb)
    torch.cuda.synchronize()
    head_ms = (time.perf_counter() - t0) * 1e3
    head_launches = dict(kernels.LAUNCHES)
    want = want_launches(elm_stats=1)
    check(head_launches == want,
          f"rwkv6 head launches {head_launches} != {want}")
    check(scores.shape == (batch * prompt, head_classes)
          and bool(torch.isfinite(scores).all()), "rwkv6 head scores")
    add(head_launches)
    _, own = solve_bar(torch, beta, f64_solve(torch, stats.u, stats.v,
                                              head_lam))

    def chunk_vs_scan(p, dtype):
        """Full-depth chunked logits against the scan's on (c)'s tokens,
        and the deepest log-decay sum inside a chunk the chunked form met
        (below -CLAMP its clamp engages)."""
        deepest, chunked = [], rwkv6._wkv_chunked

        def recording(r, k, v, lw, u, s0, chunk):
            B_, S_, H_, P_ = lw.shape
            lwp = torch.nn.functional.pad(lw, (0, 0, 0, 0, 0, (-S_) % chunk))
            deepest.append(float(lwp.reshape(B_, -1, chunk, H_, P_)
                                 .cumsum(2).min()))
            return chunked(r, k, v, lw, u, s0, chunk)

        with torch.no_grad():
            rwkv6._wkv_chunked = recording
            try:
                lc, _ = rwkv6.forward(cfg, p, hb, mode="chunked")
            finally:
                rwkv6._wkv_chunked = chunked
            ls, _ = rwkv6.forward(cfg, p, hb, mode="scan")
        check(bool(torch.isfinite(lc).all()) and bool(
            torch.isfinite(ls).all()), f"rwkv6 (d) {dtype} logits")
        return dict(dtype=dtype, max_abs_diff=float((lc - ls).abs().max()),
                    max_abs_logit=float(ls.abs().max()),
                    deepest_log_decay_sum_in_a_chunk=min(deepest))

    cvs = dict(layers=cfg.num_layers, batch=batch, tokens=prompt,
               chunk=cfg.ssm_chunk, clamp=-rwkv6.CLAMP,
               bf16=chunk_vs_scan(params, "bfloat16"))
    head_peak = torch.cuda.max_memory_allocated()
    del params, stats, beta, scores
    torch.cuda.empty_cache()
    # the same in f32 (the same draws, uncast), apart from bf16's own noise
    g = torch.Generator(device=dev).manual_seed(22)
    params = api.init_params(cfg, g, torch.float32, device=dev)
    cvs["f32"] = chunk_vs_scan(params, "float32")
    emit("recurrent_rwkv6_head", arch=cfg.name, dtype="bfloat16",
         batch=batch, seq=prompt, classes=head_classes, lam=head_lam,
         launches=head_launches, head_ms_host_clock=head_ms,
         f32_solve_err_beta=own, chunked_vs_scan=cvs,
         peak_memory_bytes=head_peak)
    del params
    torch.cuda.empty_cache()

    # (d) R7 at full size: decode after the prefill against the forward,
    # in bf16 and in f32 (the same draws, uncast), where the decode-vs-
    # forward noise of bf16 is out of the way
    cfg = get_config("zamba2_1p2b")
    r7 = {}
    for dtype in (torch.bfloat16, torch.float32):
        g = torch.Generator(device=dev).manual_seed(23)
        params = api.init_params(cfg, g, dtype, device=dev)
        toks = torch.randint(0, cfg.vocab_size, (batch, prompt + 1),
                             generator=g, device=dev)
        with torch.no_grad():
            full, _ = zamba2.forward(cfg, params, {"tokens": toks})
            _, cache = api.prefill(cfg, params, {"tokens": toks[:, :prompt]})
            padded = {k: (torch.nn.functional.pad(a, (0, 0, 0, 0, 0, 4))
                          if k in ("k", "v") else a.clone())
                      for k, a in cache.items()}
            after, _ = api.decode_step(cfg, params, cache,
                                       toks[:, prompt:prompt + 1], prompt)
            after_pad, _ = api.decode_step(cfg, params, padded,
                                           toks[:, prompt:prompt + 1],
                                           prompt)
        ref = full[:, prompt].float()
        r7[str(dtype)[6:]] = dict(
            kv_slot_rows=int(cache["k"].shape[2]),
            max_abs_gap=float((after[:, 0] - ref).abs().max()),
            max_abs_gap_padded_cache=float((after_pad[:, 0] - ref).abs()
                                           .max()),
            max_abs_logit=float(ref.abs().max()))
        del params, cache, padded, full
        torch.cuda.empty_cache()
    emit("recurrent_r7", arch=cfg.name, batch=batch, prompt=prompt, **r7)
    emit("recurrent", wall_s=time.perf_counter() - t_phase, launches=total)
    return total


def phase_train(torch, dev, layers=4, members=2, steps=4, batch=4, seq=128,
                parity_steps=4, full_depth=True):
    """The LM training path (``repro_torch.launch.train``) on the card.
    (1) qwen3_8b at full width cut to ``layers`` layers, bf16 weights and
    f32 norms as ``init_params`` makes them: ``members`` members, AdamW,
    cosine, ``batch`` × ``seq`` tokens, ``steps`` steps, ``--rounds 2``,
    IID, through ``launch.train.run``: losses finite (each is scored on
    a fresh batch before the step trains on it, and over 151,936 tokens
    the synthetic streams hold nothing four steps can learn: they are
    reported, not held to fall), the average's held-out loss beside the
    members', launches exact (per member step: rmsnorm forward 2 · 4 L + 1
    and backward 4 L + 1, swa_attention forward 2 L and backward L — each
    layer's forward runs again in the backward, the reference's remat; the
    held-out evaluation adds forwards), the peak device memory, each
    step's wall; then, from a fresh state, the gradients and one SGD
    step's params with remat bitwise those without, and member steps on
    one repeated batch, whose loss must fall step by step, one of them under
    torch.profiler (device busy, idle share) beside unprofiled ones.
    (2) Resume, on the reduced qwen3_8b in bf16 (the fewest bytes that
    run the same launcher, checkpoint and kernel code; the full-width
    4-layer run wrote 40.3 GB of state files): the run of (1)'s flags
    uninterrupted, then with ``--ckpt-every 2`` killed right after its
    step-2 state files are written and resumed to step 4
    (``--resume``): its final averaged model bitwise the uninterrupted
    run's (both taken as the launcher hands them to ``save_checkpoint``;
    see ``run``). (3) Reduced qwen3_8b in f32, ``parity_steps`` SGD steps at lr
    1e-2 on the card against the same run on the CPU from one init tree:
    every leaf within 1e-4 · max|leaf|, or — where the CPU run from the
    init one f32 ulp up lands further than that from the CPU run, the
    rule of ``tools/sgd_sensitivity.py`` for an ill-conditioned run —
    within twice that distance. (4) ``full_depth``: one SGD step of the
    whole 36-layer qwen3_8b, one member, ``batch`` × ``seq``: wall and
    peak memory. Checkpoints go under build/ and are removed after.
    Returns (the launches, the 36-layer params after that step, or None
    without ``full_depth``), the params for phase ``dryrun``."""
    import contextlib
    import shutil
    import numpy as np
    from torch.profiler import ProfilerActivity, profile
    from repro_torch import kernels, optim
    from repro_torch.configs import get_config, get_reduced_config, replace
    from repro_torch.core import trainer
    from repro_torch.data.lm_data import (TokenDatasetSpec,
                                          synthetic_token_batches)
    from repro_torch.launch import train as launch
    from repro_torch.models import api
    from repro_torch.tree import tree_leaves, tree_map

    cfg = replace(get_config("qwen3_8b"), num_layers=layers)
    L = cfg.num_layers
    root = os.path.join(ROOT, "build", "chip_smoke_train")
    shutil.rmtree(root, ignore_errors=True)
    d_full, d_cut = os.path.join(root, "full"), os.path.join(root, "cut")
    common = ["--members", str(members), "--optimizer", "adamw",
              "--schedule", "cosine", "--batch", str(batch), "--seq",
              str(seq), "--log-every", "1", "--device", str(dev)]

    class Killed(Exception):
        """The cut run's end: raised right after its step-2 state files."""

    averaged = {}

    def run(argv, tag, kill_at=None, run_cfg=cfg):
        """``launch.run`` with its checkpoint writes intercepted: the
        ``state-<m>`` files are written as the launcher writes them (and
        with ``kill_at`` the run is killed right after the last member's
        file of that step); the final ``averaged`` tree is kept in host
        memory under ``tag``, the bits its file would hold, and the final
        member files are not written. The chip machine allows 45 GiB of
        disk writes a call: two members' AdamW state at this width is
        40.3 GB, all the final files another 12 GB a run."""
        def save(ckpt_dir, name, step, tree, metadata=None):
            if name.startswith("state-"):
                written = real_save(ckpt_dir, name, step, tree, metadata)
                if step == kill_at and name == f"state-{members - 1}":
                    raise Killed()
                return written
            if name == "averaged":
                averaged[tag] = tree_map(lambda a: a.detach().cpu(), tree)
            return None

        real_save = launch.save_checkpoint
        launch.save_checkpoint = save
        try:
            # the launcher's log lines go to stderr: stdout keeps the JSON
            with contextlib.redirect_stdout(sys.stderr):
                return launch.run(run_cfg, launch.parse_args(common + argv))
        finally:
            launch.save_checkpoint = real_save

    # (1) the full-width run
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    t0 = time.perf_counter()
    res = run(["--steps", str(steps), "--rounds", "2", "--ckpt-dir", d_full],
              "full")
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    member_steps, evals = steps * members, 4 * (members + 1)
    # a member step runs each layer's forward twice (remat: again in the
    # backward); the held-out evaluations once
    want = want_launches(
        rmsnorm=(2 * 4 * L + 1) * member_steps + (4 * L + 1) * evals,
        rmsnorm_bwd=(4 * L + 1) * member_steps,
        swa_attention=2 * L * member_steps + L * evals,
        swa_attention_bwd=L * member_steps)
    check(launches == want, f"train launches {launches} != {want}")
    hist = np.array(res["history"])
    check(hist.shape == (steps, members) and bool(np.isfinite(hist).all()),
          f"train losses {hist.tolist()}")
    check(np.isfinite(res["eval_averaged"])
          and bool(np.isfinite(res["eval_members"]).all()),
          "held-out losses are not finite")
    check(res["sync_steps"] == [steps // 2, steps],
          f"sync steps {res['sync_steps']}")

    # one member step profiled, beside unprofiled ones, from a fresh state
    opt = optim.adamw()
    step_fn = trainer.make_train_step(cfg, opt, launch.make_schedule(
        launch.parse_args(common + ["--steps", str(steps)])))
    gen = torch.Generator(device=dev).manual_seed(0)
    p = api.init_params(cfg, gen, device=dev)
    o, st = opt.init(p), 0
    toks = torch.randint(0, cfg.vocab_size, (batch, seq + 1), generator=gen,
                         device=dev)
    b = {"tokens": toks[:, :-1], "targets": toks[:, 1:]}
    # remat (each layer recomputed in the backward) against the kept
    # activations: the gradients and an SGD step's params bit for bit
    remat = {}
    for keep in (True, False):
        def loss_of(q, bb, keep=keep):
            return api.loss_fn(cfg, q, bb, remat=keep)
        _, _, grads, _ = trainer.loss_and_grads(cfg, loss_of, p, b)
        sgd_step = trainer.make_train_step(cfg, optim.sgd(),
                                           optim.constant(1e-2),
                                           loss_fn=loss_of)
        remat[keep] = (grads, tree_leaves(sgd_step(p, (), 0, b)[0]))
    check(all(torch.equal(x, y) for x, y in zip(remat[True][0],
                                                remat[False][0])),
          "train: the remat gradients differ from the kept activations'")
    check(all(torch.equal(x, y) for x, y in zip(remat[True][1],
                                                remat[False][1])),
          "train: the remat step's params differ from the kept "
          "activations'")
    del remat, grads
    p, o, st, m_ = step_fn(p, o, st, b)                     # warm
    same_batch = [float(m_["loss"])]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(3):
        p, o, st, m_ = step_fn(p, o, st, b)
        same_batch.append(float(m_["loss"]))
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3 / 3
    # the steps train on the batch they are scored on: the loss must fall
    check(all(np.isfinite(same_batch)) and all(
        b2 < b1 for b1, b2 in zip(same_batch, same_batch[1:])),
        f"train losses on one repeated batch did not fall: {same_batch}")
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        p, o, st, m_ = step_fn(p, o, st, b)
        torch.cuda.synchronize()
        prof_wall = (time.perf_counter() - t0) * 1e3
    rows = sorted(device_activity(torch, prof), reverse=True)
    busy = sum(us for us, _, _ in rows) / 1e3
    profiled = dict(
        same_batch_losses=same_batch,
        wall_ms=prof_wall, step_ms_unprofiled=step_ms,
        device_busy_ms=busy if rows else "not measured",
        idle_share=1 - busy / prof_wall if rows else "not measured",
        idle_share_unprofiled=(1 - min(busy / step_ms, 1.0) if rows
                               else "not measured"),
        top=[{"name": name[:60], "ms": us / 1e3, "count": count}
             for us, name, count in rows[:10]])
    del p, o, m_, b, prof
    torch.cuda.empty_cache()

    # (2) killed after step 2 and resumed: bitwise the uninterrupted run,
    # on the reduced config
    small = get_reduced_config("qwen3_8b")
    t0 = time.perf_counter()
    run(["--steps", str(steps), "--rounds", "2", "--ckpt-dir",
         os.path.join(root, "small")], "uninterrupted", run_cfg=small)
    try:
        run(["--steps", str(steps), "--rounds", "2", "--ckpt-every", "2",
             "--ckpt-dir", d_cut], "cut", kill_at=2, run_cfg=small)
        check(False, "the cut run was not killed at step 2")
    except Killed:
        pass
    torch.cuda.empty_cache()
    cut_s = time.perf_counter() - t0
    state_bytes = sum(os.path.getsize(os.path.join(d_cut, f))
                      for f in os.listdir(d_cut))
    t0 = time.perf_counter()
    run(["--steps", str(steps), "--rounds", "2", "--resume", "--ckpt-dir",
         d_cut], "resumed", run_cfg=small)
    resume_s = time.perf_counter() - t0
    full_avg, cut_avg = averaged["uninterrupted"], averaged["resumed"]
    check(len(tree_leaves(full_avg)) == len(tree_leaves(cut_avg)) and all(
        a.dtype == b.dtype and torch.equal(a, b) for a, b in zip(
            tree_leaves(full_avg), tree_leaves(cut_avg))),
          "resumed averaged model differs from the uninterrupted run's")
    shutil.rmtree(root, ignore_errors=True)
    del full_avg, cut_avg, averaged

    # (3) card vs CPU: reduced, f32, SGD
    rcfg = get_reduced_config("qwen3_8b")
    init = api.init_params(rcfg, torch.Generator().manual_seed(0),
                           torch.float32, device="cpu")
    stream = synthetic_token_batches(TokenDatasetSpec(
        vocab_size=rcfg.vocab_size, seq_len=64, batch_size=2, seed=0))
    batches = [{"tokens": torch.from_numpy(t), "targets": torch.from_numpy(y)}
               for t, y in (next(stream) for _ in range(parity_steps))]

    def sgd_run(params, device):
        step = trainer.make_train_step(rcfg, optim.sgd(), optim.constant(1e-2))
        o, s = (), 0
        for bb in batches:
            params, o, s, _ = step(params, o, s, tree_map(
                lambda a: a.to(device), bb))
        return tree_map(lambda a: a.cpu(), params)

    card = sgd_run(tree_map(lambda a: a.to(dev), init), dev)
    host = sgd_run(init, torch.device("cpu"))
    twin = sgd_run(tree_map(lambda a: torch.nextafter(
        a, torch.full_like(a, float("inf"))), init), torch.device("cpu"))
    leaves = []
    for c, h, t in zip(tree_leaves(card), tree_leaves(host),
                       tree_leaves(twin)):
        top = float(h.abs().max())
        d, d_twin = float((c - h).abs().max()), float((t - h).abs().max())
        ill = d_twin > 1e-4 * top
        bar = 2 * d_twin if ill else 1e-4 * top
        check(d <= bar, f"train card vs CPU: {d} > {bar} (max|leaf| {top})")
        leaves.append(dict(shape=list(c.shape), max_abs_err=d,
                           max_abs_leaf=top, twin=d_twin, bar=bar,
                           rule="one-ulp twin" if ill else "1e-4 max|leaf|"))
    parity = dict(arch=rcfg.name, dtype="float32", steps=parity_steps,
                  lr=1e-2, leaves=leaves,
                  rules=sorted({x["rule"] for x in leaves}))

    # (4) the whole model: one SGD step
    deep = deep_params = None
    if full_depth:
        dcfg = get_config("qwen3_8b")
        gen = torch.Generator(device=dev).manual_seed(1)
        params = api.init_params(dcfg, gen, device=dev)
        toks = torch.randint(0, dcfg.vocab_size, (batch, seq + 1),
                             generator=gen, device=dev)
        b = {"tokens": toks[:, :-1], "targets": toks[:, 1:]}
        step = trainer.make_train_step(dcfg, optim.sgd(),
                                       optim.constant(1e-2))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launches()
        t0 = time.perf_counter()
        params, _, _, dm = step(params, (), 0, b)
        loss = float(dm["loss"])
        torch.cuda.synchronize()
        deep_s = time.perf_counter() - t0
        dl = dict(kernels.LAUNCHES)
        DL = dcfg.num_layers
        check(dl == want_launches(rmsnorm=2 * 4 * DL + 1,
                                  rmsnorm_bwd=4 * DL + 1,
                                  swa_attention=2 * DL,
                                  swa_attention_bwd=DL),
              f"full-depth step launches {dl}")
        check(np.isfinite(loss), f"full-depth loss {loss}")
        deep = dict(arch=dcfg.name, layers=DL, dtype="bfloat16",
                    batch=batch, seq=seq, loss=loss,
                    grad_norm=float(dm["grad_norm"]),
                    step_s_host_clock=deep_s,
                    peak_memory_bytes=torch.cuda.max_memory_allocated(),
                    launches=dl)
        deep_params = params
        del params, dm, b
        torch.cuda.empty_cache()

    emit("train", arch=f"{cfg.name}, {L} of 36 layers, full width",
         params=cfg.param_count(), members=members, optimizer="adamw",
         schedule="cosine", batch=batch, seq=seq, steps=steps, rounds=2,
         losses=hist.tolist(), eval_averaged=res["eval_averaged"],
         eval_members=res["eval_members"], sync_steps=res["sync_steps"],
         step_s_host_clock=res["step_s"], run_s_host_clock=run_s,
         launches=launches,
         launches_per_member_step={
             "rmsnorm_bwd": launches["rmsnorm_bwd"] // member_steps,
             "swa_attention_bwd": launches["swa_attention_bwd"]
             // member_steps},
         peak_memory_bytes=peak, profile_member_step=profiled,
         remat_bitwise_kept_activations=True,
         resume=dict(bitwise=True, killed_after_step=2, arch=small.name,
                     state_files_bytes=state_bytes,
                     cut_s_host_clock=cut_s, resume_s_host_clock=resume_s),
         card_vs_cpu=parity, full_depth=deep)
    return launches, deep_params


def phase_dryrun(torch, dev, deep=None, train_layers=4, batch=4, seq=128,
                 gen=32):
    """The dry run (``repro_torch.launch.dryrun``) held against the card:
    three steps traced on the meta device, then run once each on the card
    under ``FlopCounterMode`` — phase ``lm``'s 36-layer bf16 qwen3_8b
    prefill of ``batch`` × ``seq`` and one decode step against a cache of
    ``seq + gen`` (on ``deep["params"]``, phase ``train``'s full-depth
    params, which this phase takes and lets go of), then phase ``train``'s
    member step (qwen3_8b at full width cut to ``train_layers`` layers,
    bf16, AdamW, ``batch`` × ``seq``). Each must match exactly: the kernel
    operator calls by name against the step's launches, the argument
    bytes against the storages of the tensors the card's step takes, and
    the FLOPs against ``FlopCounterMode``'s count of the card's step.
    Printed, not held: the estimated peak over the card's
    (``max_memory_allocated`` less what was resident besides the step's
    arguments) and the device's busy time (torch.profiler, one step) over
    the roofline time. Then the phase's wall."""
    from torch.utils.flop_counter import FlopCounterMode
    from repro_torch import kernels, optim
    from repro_torch.configs import InputShape, get_config, replace
    from repro_torch.launch import dryrun
    from repro_torch.models import api
    from repro_torch.tree import tree_leaves

    t_phase = time.perf_counter()
    cfg36 = get_config("qwen3_8b")
    cfg_t = replace(cfg36, num_layers=train_layers)
    g = torch.Generator(device=dev).manual_seed(2)

    def tokens(shape):
        return torch.randint(0, cfg36.vocab_size, shape, generator=g,
                             device=dev, dtype=torch.int32)

    def held(args):
        """The bytes of the storages of ``args``'s tensors, each once."""
        return sum({t.untyped_storage().data_ptr(): t.untyped_storage()
                    .nbytes() for t in tree_leaves(list(args))
                    if isinstance(t, torch.Tensor)}.values())

    def hold_to(tag, cfg, shape, args):
        t0 = time.perf_counter()
        dry = dryrun.trace_combo(cfg, shape, "single")
        trace_s = time.perf_counter() - t0
        fn = dryrun.step_fn(cfg, shape)
        arg_bytes = held(args)
        torch.cuda.synchronize()
        resident = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launches()
        t0 = time.perf_counter()
        with FlopCounterMode(display=False) as fc:
            out = fn(*args)
        torch.cuda.synchronize()
        card_s = time.perf_counter() - t0
        launches = {k: n for k, n in kernels.LAUNCHES.items() if n}
        step_peak = torch.cuda.max_memory_allocated() - (resident
                                                         - arg_bytes)
        flops = fc.get_total_flops()
        del out
        prof = profile_once(torch, lambda: fn(*args))
        check(launches == dry["kernels"], f"dryrun {tag}: kernel operator "
              f"calls {dry['kernels']} != the card's launches {launches}")
        check(arg_bytes == dry["memory"]["argument_bytes_per_card"],
              f"dryrun {tag}: argument bytes {dry['memory']} != the card's "
              f"{arg_bytes}")
        check(flops == dry["cost"]["flops_per_card"], f"dryrun {tag}: "
              f"FLOPs {dry['cost']['flops_per_card']} != the card's {flops}")
        roof = dry["roofline"]
        roof_ms = 1e3 * max(roof["t_compute_s"], roof["t_memory_s"],
                            roof["t_collective_s"])
        busy = prof["device_busy_ms"]
        emit("dryrun", case=tag, arch=f"{cfg.name}, {cfg.num_layers} layers",
             shape=[shape.global_batch, shape.seq_len], kind=shape.kind,
             kernels=dry["kernels"], launches=launches,
             argument_bytes=arg_bytes, flops=flops,
             flops_by_dtype=dry["cost"]["flops_by_dtype_per_card"],
             bytes_estimate=dry["cost"]["bytes_per_card"],
             peak_estimate_bytes=dry["memory"]["peak_bytes_per_card"],
             card_step_peak_bytes=step_peak,
             peak_estimate_over_card=dry["memory"]["peak_bytes_per_card"]
             / step_peak,
             roofline_ms=roof_ms, dominant=roof["dominant"],
             device_busy_ms=busy,
             busy_over_roofline=busy / roof_ms if isinstance(busy, float)
             else "not measured",
             card_step_s_host_clock=card_s, trace_s_host_clock=trace_s,
             card=dry["card"])

    params36 = (deep or {}).pop("params", None)
    if params36 is None:
        params36 = api.init_params(cfg36, g, device=dev)
    hold_to("prefill", cfg36, InputShape("chip_prefill", seq, batch,
                                         "prefill"),
            (params36, {"tokens": tokens((batch, seq))}))
    hold_to("decode_step", cfg36, InputShape("chip_decode", seq + gen,
                                             batch, "decode"),
            (params36, api.init_cache(cfg36, batch, seq + gen, device=dev),
             tokens((batch, 1)), seq + gen - 1))
    del params36
    torch.cuda.empty_cache()
    params = api.init_params(cfg_t, g, device=dev)
    toks = tokens((batch, seq + 1))
    hold_to("member_train_step", cfg_t, InputShape("chip_train", seq,
                                                   batch, "train"),
            (params, optim.adamw().init(params), 0,
             {"tokens": toks[:, :-1].contiguous(),
              "targets": toks[:, 1:].contiguous()}))
    del params, toks
    torch.cuda.empty_cache()
    emit("dryrun_wall", seconds=time.perf_counter() - t_phase)


def phase_audit(torch, dev, m, lm_layers=4, k=4):
    """The runtime contract audit on ``dev``: every audited program's
    report on a line of its own, then the phase's wall; a failed check
    fails the run, and on the card each epoch's report must hold the
    hand-kernel route (not skip it)."""
    from repro_torch.analysis import audit
    from repro_torch.configs import get_config, replace
    from repro_torch.launch.mesh import make_member_mesh, process_group
    from repro_torch.models import api
    from repro_torch.tree import tree_leaves, tree_map

    cfg, batch = m["cfg"], m["batch"]
    t0 = time.perf_counter()
    surfaces = [
        ("sequential", audit.audit_executor(cfg, "sequential", k=k,
                                            device=dev)),
        ("stacked", audit.audit_executor(cfg, "stacked", k=k,
                                         batch_size=batch, device=dev))]
    with process_group(device=dev):
        surfaces += [
            ("mesh flat", audit.audit_executor(
                cfg, "mesh", k=k, batch_size=batch, gossip_rounds=2,
                device=dev)),
            ("mesh (1, 1)", audit.audit_executor(
                cfg, "mesh", mesh=make_member_mesh(hosts=1), k=k,
                batch_size=batch, device=dev))]
    # phase serve warmed every bucket and held graphs == buckets; this
    # re-reads the same budget through the audit's report
    surfaces.append(("scorer", [audit.audit_scorer(m["scorer"],
                                                   device=dev)]))
    lm = replace(get_config("qwen3_8b"), num_layers=lm_layers)
    gen = torch.Generator(device=dev).manual_seed(0)
    members = [api.init_params(lm, gen, torch.bfloat16, dev)
               for _ in range(2)]
    stacked = tree_map(lambda *xs: torch.stack(xs), *members)
    del members
    lm_bytes = sum(a.numel() * a.element_size()
                   for a in tree_leaves(stacked))
    surfaces.append(("lm average", [audit.audit_average_step(
        params=stacked, device=dev)]))
    del stacked
    if dev.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
    seconds = time.perf_counter() - t0
    reports = [r for _, rs in surfaces for r in rs]
    for surface, rs in surfaces:
        for r in rs:
            emit("audit", surface=surface, program=r.program,
                 checks=[{"name": c.name, "ok": c.ok, "detail": c.detail}
                         for c in r.checks],
                 skipped=[{"name": n, "why": why} for n, why in r.skipped])
    failed = [f"{r.program}: {c}" for r in reports for c in r.failures]
    epochs = [r for r in reports if r.program.endswith("/_epoch")]
    emit("audit_summary", seconds=seconds, programs=len(reports),
         checks=sum(len(r.checks) for r in reports),
         skipped=sum(len(r.skipped) for r in reports), failed=failed,
         lm_tree_bytes=lm_bytes)
    check(not failed, f"audit: {failed}")
    if dev.type == "cuda":
        check(all(any(c.name == "hand-kernel-route" for c in r.checks)
                  for r in epochs) and len(epochs) == 3,
              "audit: an epoch's hand-kernel route was not checked")


def main():
    import torch
    check(torch.cuda.is_available(), "torch.cuda.is_available() is False")
    import repro_torch  # noqa: F401  (sets the TF32 flags)
    from repro_torch import kernels

    card = card_line()
    peak_name, rates = peaks(card)
    emit("env", card=card, peaks_from=peak_name, f32_flops=rates[0],
         mem_bytes_per_s=rates[1], torch=torch.__version__,
         cuda=torch.version.cuda, device=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count(),
         tf32_matmul=torch.backends.cuda.matmul.allow_tf32,
         tf32_cudnn=torch.backends.cudnn.allow_tf32)
    check(not torch.backends.cuda.matmul.allow_tf32
          and not torch.backends.cudnn.allow_tf32, "TF32 must be off")
    dev = torch.device("cuda")

    t0 = time.perf_counter()
    kernels.library()
    emit("build", seconds=time.perf_counter() - t0,
         ptxas=[line.strip() for line in kernels.build_log.splitlines()
                if "registers" in line or "Compiling entry" in line
                or "spill" in line])

    per_case = phase_kernels(torch, dev, rates)
    m = phase_map(torch, dev)
    sgd = phase_sgd(torch, dev, m)
    mesh_launches = phase_mesh(torch, dev, m, sgd)
    serve_launches = phase_serve(torch, m)
    stream_launches = phase_stream(torch, dev, m)
    phase_profile(torch, m)
    phase_e2lm(torch, dev, rates, m)
    phase_elm_head(torch, dev, rates, m)
    phase_resume(torch, dev, m, sgd)
    phase_lm_parity(torch, dev)
    lm_launches, lm_first = phase_lm(torch, dev)
    mesh_lm_launches = phase_lm_mesh(torch, dev, lm_first, lm_launches)
    del lm_first
    pod_launches = phase_pod(torch, dev)
    zoo_launches = phase_zoo(torch, dev)
    rec_launches = phase_recurrent(torch, dev)
    train_launches, params36 = phase_train(torch, dev)
    deep = {"params": params36}
    del params36
    phase_audit(torch, dev, m)
    phase_dryrun(torch, dev, deep)

    main_launches = m["launches"]
    check(all(main_launches[name] > 0 for name in ("conv2d", "elm_stats")),
          f"main path did not launch every kernel: {main_launches}")
    sgd_launches = sgd["launches"]
    check(all(sgd_launches[name] > 0 for name in
              ("conv2d", "conv2d_dgrad", "conv2d_wgrad", "elm_stats")),
          f"SGD main path did not launch every kernel: {sgd_launches}")
    conv = [per_case[("conv2d", "stage1")], per_case[("conv2d", "stage2")]]
    conv_err = max(per_case[("conv2d", c)]["max_abs_err"]
                   for c in ("stage1", "stage2", "score1_stage1",
                             "score1_stage2"))
    stats = per_case[("elm_stats", "unmasked")]
    stats_err = max(per_case[("elm_stats", c)]["max_abs_err"]
                    for c in ("unmasked", "fractional_mask", "ragged",
                              "shard", "hubert_head", "rwkv6_head"))
    line = {"kernels": [
        {"name": "conv2d", "route": "cuda",
         "source": "src/repro_torch/csrc/conv2d.cu",
         "replaces": "src/repro/kernels/conv2d/kernel.py:28",
         # the CNN main path, serving (graph replays), the stream and the
         # mesh (its epochs=0 and SGD runs on the flat mesh)
         "launches": sum(p["conv2d"] for p in (main_launches, serve_launches,
                                              stream_launches,
                                              mesh_launches)),
         "max_abs_err": conv_err,
         # one stacked Map step runs stage 1 and stage 2 once each
         "ms": sum(c["ms"] for c in conv),
         "plain_ms": sum(c["plain_ms"] for c in conv),
         "bound_ms": sum(c["bound_ms"] for c in conv),
         "bound_by": "bytes" if sum(c["bytes"] for c in conv) / rates[1]
         >= sum(c["flops"] for c in conv) / rates[0] else "operations",
         "library_ms": sum(c["library_ms"] for c in conv)},
        {"name": "elm_stats", "route": "cuda",
         "source": "src/repro_torch/csrc/elm_stats.cu",
         "replaces": "src/repro/kernels/elm_stats/kernel.py:36",
         "launches": main_launches["elm_stats"]
         + stream_launches["elm_stats"] + mesh_launches["elm_stats"]
         + zoo_launches["elm_stats"] + rec_launches["elm_stats"],
         "max_abs_err": stats_err, "ms": stats["ms"],
         "plain_ms": stats["plain_ms"], "bound_ms": stats["bound_ms"],
         "bound_by": stats["bound_by"], "library_ms": stats["library_ms"]},
    ]}
    # conv2d_wgrad: one SGD step's dW of both stages; conv2d_dgrad: its dX
    # of stage 2; their launches from the SGD main path (the stacked
    # two-epoch Map) and the mesh's two-round SGD run
    dx = per_case[("conv2d_dgrad", "dx_stage2")]
    line["kernels"].append(
        {"name": "conv2d_dgrad", "route": "cuda",
         "source": "src/repro_torch/csrc/conv2d_dgrad.cu",
         "replaces": "src/repro/kernels/conv2d/kernel.py:28 (the conv2d "
                     "TPU kernel; it has no Pallas backward)",
         "launches": sgd_launches["conv2d_dgrad"]
         + mesh_launches["conv2d_dgrad"],
         "max_abs_err": dx["max_abs_err"], "ms": dx["ms"],
         "plain_ms": dx["plain_ms"], "bound_ms": dx["bound_ms"],
         "bound_by": dx["bound_by"], "library_ms": dx["library_ms"]})
    dw = [per_case[("conv2d_wgrad", c)] for c in ("dw_stage1", "dw_stage2")]
    line["kernels"].append(
        {"name": "conv2d_wgrad", "route": "cuda",
         "source": "src/repro_torch/csrc/conv2d_wgrad.cu",
         "replaces": "src/repro/kernels/conv2d/kernel.py:28 (the conv2d "
                     "TPU kernel; it has no Pallas backward)",
         "launches": sgd_launches["conv2d_wgrad"]
         + mesh_launches["conv2d_wgrad"],
         "max_abs_err": max(c["max_abs_err"] for c in dw),
         "ms": sum(c["ms"] for c in dw),
         "plain_ms": sum(c["plain_ms"] for c in dw),
         "bound_ms": sum(c["bound_ms"] for c in dw),
         "bound_by": "bytes" if sum(c["bytes"] for c in dw) / rates[1]
         >= sum(c["flops"] for c in dw) / rates[0] else "operations",
         "library_ms": sum(c["library_ms"] for c in dw)})
    # rmsnorm: one ln (512 x 4096) and one q_norm (16384 x 128) launch of
    # the prefill; swa_attention: one layer's prefill attention; their
    # launches from the LM serving path, the zoo's paths (the encoder's
    # non-causal attention among them), the recurrent paths (Zamba2's) and
    # the train path's forwards
    rms = [per_case[("rmsnorm", c)] for c in ("ln_d4096", "qk_norm_d128")]
    rms_err = max(per_case[("rmsnorm", c)]["max_abs_err"]
                  for c in ("ln_d4096", "qk_norm_d128", "zamba2_ln_d2048",
                            "pod_train4k_ln_d4096",
                            "pod_zamba2_train4k_ln_d2048"))
    swa = per_case[("swa_attention", "prefill_causal")]
    line["kernels"] += [
        {"name": "rmsnorm", "route": "cuda",
         "source": "src/repro_torch/csrc/rmsnorm.cu",
         "replaces": "src/repro/kernels/rmsnorm/kernel.py:23",
         "launches": lm_launches["rmsnorm"] + zoo_launches["rmsnorm"]
         + rec_launches["rmsnorm"] + train_launches["rmsnorm"]
         + mesh_lm_launches["rmsnorm"] + pod_launches.get("rmsnorm", 0),
         "max_abs_err": rms_err,
         "ms": sum(c["ms"] for c in rms),
         "plain_ms": sum(c["plain_ms"] for c in rms),
         "bound_ms": sum(c["bound_ms"] for c in rms),
         "bound_by": "bytes" if sum(c["bytes"] for c in rms) / rates[1]
         >= sum(c["flops"] for c in rms) / rates[0] else "operations",
         "library_ms": sum(c["library_ms"] for c in rms)},
        {"name": "swa_attention", "route": "cuda",
         "source": "src/repro_torch/csrc/swa_full_fwd.cu",
         "replaces": "src/repro/kernels/swa_attention/kernel.py:28",
         "launches": lm_launches["swa_attention"]
         + zoo_launches["swa_attention"] + rec_launches["swa_attention"]
         + train_launches["swa_attention"]
         + mesh_lm_launches["swa_attention"]
         + pod_launches.get("swa_attention", 0),
         "max_abs_err": max(per_case[("swa_attention", c)]["max_abs_err"]
                            for c in ("prefill_causal", "window256_s1024",
                                      "prefill_large_scores", "zamba2_shared",
                                      "olmoe_prefill", "train4k_seq",
                                      "pod_local_heads_s32k",
                                      "pod_train4k_local_heads",
                                      "pod_zamba2_train4k_local_heads",
                                      "lm_parity_causal_f32",
                                      "elm_head_parity_causal_f32",
                                      "encoder_bidirectional",
                                      "encoder_ragged_s1000",
                                      "encoder_f32_small")),
         "ms": swa["ms"], "plain_ms": swa["plain_ms"],
         "bound_ms": swa["bound_ms"], "bound_by": swa["bound_by"],
         "library_ms": swa["library_ms"]},
    ]
    # the backward kernels: one ln and one q_norm backward, one layer's
    # attention backward at the prefill shape; launches from the train
    # path, the zoo's HuBERT fine-tune steps (swa_attention_bwd's non-causal
    # mode, reported on a line of its own) and Zamba2's gradient
    rb = [per_case[("rmsnorm_bwd", c)] for c in ("ln_d4096", "qk_norm_d128")]
    rb_err = max(per_case[("rmsnorm_bwd", c)]["max_abs_err"]
                 for c in ("ln_d4096", "qk_norm_d128", "zamba2_ln_d2048",
                           "pod_train4k_ln_d4096",
                           "pod_zamba2_train4k_ln_d2048"))
    sb = per_case[("swa_attention_bwd", "prefill_causal")]
    emit("launches_by_mode", swa_attention_bwd_non_causal=zoo_launches[
        "swa_attention_bwd"], swa_attention_bwd_causal=train_launches[
        "swa_attention_bwd"] + rec_launches["swa_attention_bwd"]
        + pod_launches.get("swa_attention_bwd", 0))
    line["kernels"] += [
        {"name": "rmsnorm_bwd", "route": "cuda",
         "source": "src/repro_torch/csrc/rmsnorm_bwd.cu",
         "replaces": "src/repro/kernels/rmsnorm/kernel.py:23 (the rmsnorm "
                     "TPU kernel; it has no Pallas backward)",
         "launches": train_launches["rmsnorm_bwd"]
         + zoo_launches["rmsnorm_bwd"] + rec_launches["rmsnorm_bwd"]
         + pod_launches.get("rmsnorm_bwd", 0),
         "max_abs_err": rb_err,
         "ms": sum(c["ms"] for c in rb),
         "plain_ms": sum(c["plain_ms"] for c in rb),
         "bound_ms": sum(c["bound_ms"] for c in rb),
         "bound_by": "bytes" if sum(c["bytes"] for c in rb) / rates[1]
         >= sum(c["flops"] for c in rb) / rates[0] else "operations",
         "library_ms": sum(c["library_ms"] for c in rb)},
        {"name": "swa_attention_bwd", "route": "cuda",
         "source": "src/repro_torch/csrc/swa_full_bwd.cu",
         "replaces": "src/repro/kernels/swa_attention/kernel.py:28 (the "
                     "swa_attention TPU kernel; it has no Pallas backward)",
         "launches": train_launches["swa_attention_bwd"]
         + zoo_launches["swa_attention_bwd"]
         + rec_launches["swa_attention_bwd"]
         + pod_launches.get("swa_attention_bwd", 0),
         "max_abs_err": max(per_case[("swa_attention_bwd", c)]["max_abs_err"]
                            for c in ("prefill_causal", "window256_s1024",
                                      "olmoe_prefill", "train4k_seq",
                                      "pod_train4k_local_heads",
                                      "pod_zamba2_train4k_local_heads",
                                      "lm_parity_causal_f32",
                                      "elm_head_parity_causal_f32",
                                      "encoder_bidirectional",
                                      "encoder_ragged_s1000",
                                      "encoder_f32_small")),
         "ms": sb["ms"], "plain_ms": sb["plain_ms"],
         "bound_ms": sb["bound_ms"], "bound_by": sb["bound_by"],
         "library_ms": sb["library_ms"]},
    ]
    print(json.dumps(line), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
