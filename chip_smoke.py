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
             value; its library is cuDNN's grouped backward.
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
6. serve   — a bucketed scorer answering requests of 1, 3, 17 and 64
             images, checked against the ensemble surface; one hot swap.
7. profile — one stacked Map and one stacked SGD epoch under
             torch.profiler: device busy, wall, idle share, top operations.
8. lm      — the LM serving path (``repro_torch.launch.serve``): (a) qwen3_8b
             at full width cut to 2 layers, f32, the card against the port's
             CPU path on the same params (prefill and 4 greedy decode steps
             within 1e-4 · max|logit|, equal tokens); (b) the full 36-layer
             qwen3_8b in bf16 through ``run_lm`` at batch 4, prompt 128,
             gen 32: prefill ms, decode tokens/s, peak device memory, the
             gap between the prefill's and the replay's last logits, and the
             device-idle share of a decode step: its device busy time
             (torch.profiler, one step) over the mean step of 10 unprofiled
             steps and over the mean step of run_lm's own decode loop.
9. the kernels line, the card line, and the last line
   ``{"ok": true, "device": {...}}``.

The launch counters are set to 0 just before each path runs and read just
after it: the CNN main path (stacked Map → Reduce → scoring of the
held-out set), the sequential Map, each SGD Map (the stacked one-round run
is the SGD main path, whose conv2d_dgrad and conv2d_wgrad counts the
kernels line reports),
serving, and the LM path (b).
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

# per-card peaks from NVIDIA's data sheets: (f32 FLOP/s on CUDA cores,
# device-memory bytes/s, dense bf16 tensor-core FLOP/s); the SXM part
# unless nvidia-smi names another
PEAKS = {"H100 PCIe": (51.2e12, 2.0e12, 756e12),
         "H100 NVL": (60e12, 3.9e12, 835e12),
         "H100": (67e12, 3.35e12, 989e12)}
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
    for key, val in PEAKS.items():
        if key in name:
            return key, val
    raise RuntimeError(f"no peak rates on record for {name!r}")


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


def phase_kernels(torch, dev, rates):
    """Each kernel vs its plain version at the main path's shapes; returns
    per-kernel measurements for the kernels line."""
    import torch.nn.functional as F
    from repro_torch.kernels.conv2d import ops as conv_ops, ref as conv_ref
    from repro_torch.kernels.elm_stats import ops as st_ops, ref as st_ref
    from repro_torch.kernels.rmsnorm import ops as rms_ops, ref as rms_ref
    from repro_torch.kernels.swa_attention import ops as swa_ops
    from repro_torch.kernels.swa_attention import ref as swa_ref
    from repro_torch.serve import BucketLadder

    gen = torch.Generator().manual_seed(0)

    def rand(*shape):
        return torch.rand(shape, generator=gen).to(dev)

    def randn(*shape):
        return torch.randn(shape, generator=gen).to(dev)

    def compare(got, ref):
        rtol = BF16_RTOL if got.dtype == torch.bfloat16 else TOL
        got, ref = got.float(), ref.float()
        err = float((got - ref).abs().max())
        top = float(ref.abs().max())
        ok = bool(((got - ref).abs() <= TOL * top + rtol * ref.abs()).all())
        return err, top, ok

    def same_function(lib, ref, rel=1e-3):
        # a layout check on the library yardstick, which may pick an
        # algorithm (Winograd, split-K) with other rounding than ours
        return float((lib - ref).abs().max()) <= rel * float(
            ref.abs().max())

    out = {}

    def keep(name, tag, rec):
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
        err, top, ok = compare(y, conv_ref.conv2d_valid_ref(x, w))
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
        flops = 2 * y.numel() * kh * kw * Cin
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
        flops = 2 * dy.numel() * kh * kw * Cin        # the true products
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
        u, v = st_ops.elm_stats(h, t, mask=m)
        ref = st_ref.elm_stats_ref(h, t, m)
        got = torch.cat([u, v], dim=-1)
        err, top, ok = compare(got, ref)
        check(ok, f"elm_stats {tag}: max|err| {err} at max|ref| {top}")
        check(torch.equal(u, u.transpose(1, 2)),
              f"elm_stats {tag}: U is not bitwise symmetric")
        hm = h if m is None else h * m[..., None]
        hmt = hm.transpose(1, 2).contiguous()
        ht = torch.cat([h, t], dim=-1).contiguous()
        check(same_function(torch.matmul(hmt, ht), ref),
              "the cuBLAS yardstick computes another function")
        nbytes = 4 * (h.numel() + t.numel() + ref.numel()
                      + (m.numel() if masked else 0))
        # U is symmetric: the function needs its pairs i <= j and all of V
        flops = k * n * (L * (L + 1) + 2 * L * C) + (k * n * L if masked
                                                       else 0)
        b_ms, b_by = bound_ms(nbytes, flops, rates)
        kernel = lambda: st_ops.elm_stats(h, t, mask=m)       # noqa: E731
        plain = lambda: st_ref.elm_stats_ref(h, t, m)         # noqa: E731
        library = lambda: torch.matmul(hmt, ht)               # noqa: E731
        rec = dict(shape=f"k{k} n{n} L{L} C{C}", max_abs_err=err,
                   max_abs_ref=top,
                   ms=device_ms(torch, kernel),
                   plain_ms=device_ms(torch, plain, reps=20),
                   library_ms=device_ms(torch, library),
                   call_ms=call_ms(torch, kernel),
                   plain_call_ms=call_ms(torch, plain, reps=20),
                   library_call_ms=call_ms(torch, library),
                   bound_ms=b_ms, bound_by=b_by, bytes=nbytes, flops=flops)
        keep("elm_stats", tag, rec)

    # the LM serving path's shapes, bf16: ln1/ln2/final norm over the B·S
    # rows of a batch-4, prompt-128 prefill (f32 scale), and q_norm over its
    # B·S·32 heads (bf16 scale)
    rms_cases = [("ln_d4096", (512, 4096), torch.float32),
                 ("qk_norm_d128", (16384, 128), torch.bfloat16)]
    for tag, shape, scale_dtype in rms_cases:
        x = (randn(*shape) * 3).to(torch.bfloat16)
        scale = (1 + 0.1 * randn(shape[-1])).to(scale_dtype)
        y = rms_ops.rmsnorm(x, scale, eps=1e-6)
        err, top, ok = compare(y, rms_ref.rmsnorm_ref(x, scale, 1e-6))
        check(ok, f"rmsnorm {tag}: max|err| {err} at max|ref| {top}")
        w_lib = scale.to(x.dtype)
        check(same_function(F.rms_norm(x, (shape[-1],), w_lib, 1e-6).float(),
                            y.float(), 1e-2),
              "the rms_norm yardstick computes another function")
        nbytes = 2 * x.element_size() * x.numel() + scale.element_size() * \
            scale.numel()
        flops = 4 * x.numel()
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
    # window = S), one windowed case, and the prefill with q scaled by 8:
    # scores of large magnitude stress the online rescale and the hi/lo
    # split of p
    swa_cases = [("prefill_causal", 4, 128, 32, 8, 128, 128, 1.0),
                 ("window256_s1024", 1, 1024, 32, 8, 128, 256, 1.0),
                 ("prefill_large_scores", 4, 128, 32, 8, 128, 128, 8.0)]
    for tag, B, S, H, KV, hd, W, q_scale in swa_cases:
        q = (randn(B, S, H, hd) * q_scale).to(torch.bfloat16)
        k = randn(B, S, KV, hd).to(torch.bfloat16)
        v = randn(B, S, KV, hd).to(torch.bfloat16)
        y = swa_ops.swa_attention(q, k, v, window=W)
        err, top, ok = compare(y, swa_ref.swa_attention_ref(q, k, v,
                                                            window=W))
        check(ok, f"swa_attention {tag}: max|err| {err} at max|ref| {top}")
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
        pairs = B * H * sum(min(t + 1, W) for t in range(S))
        nbytes = 2 * (2 * q.numel() + k.numel() + v.numel())
        flops = 4 * hd * pairs
        b_ms, b_by = bound_ms(nbytes, flops, rates, bf16=True)
        kernel = lambda: swa_ops.swa_attention(q, k, v, window=W)  # noqa
        plain = lambda: swa_ref.swa_attention_ref(q, k, v,           # noqa
                                                  window=W)
        rec = dict(shape=f"B{B} S{S} H{H} KV{KV} hd{hd} W{W} bf16"
                   + (f", q x {q_scale:g}" if q_scale != 1.0 else ""),
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
    return out


def expected_launches(parts, batch):
    """Launches the epochs=0 Map must make: per batch index, one conv per
    stage and one elm_stats — member-batched on the stacked path, per member
    on the sequential one."""
    nbs = [len(p.x) // batch for p in parts]
    lm = {"rmsnorm": 0, "swa_attention": 0, "conv2d_wgrad": 0,
          "conv2d_dgrad": 0}
    return ({"conv2d": 2 * max(nbs), "elm_stats": max(nbs), **lm},
            {"conv2d": 2 * sum(nbs), "elm_stats": sum(nbs), **lm})


def expected_sgd_launches(parts, batch, epochs, backend):
    """Launches an SGD Map must make: per step (a batch index on the
    stacked path, a member's batch on the sequential one) the two conv
    forwards, stage 2's dX, dW of both stages (each ``WGRAD_PASSES``
    launches) and one elm_stats."""
    from repro_torch.kernels.conv2d.ops import WGRAD_PASSES
    nbs = [len(p.x) // batch for p in parts]
    steps = epochs * (max(nbs) if backend == "stacked" else sum(nbs))
    return {"conv2d": 2 * steps, "conv2d_dgrad": steps,
            "conv2d_wgrad": 2 * WGRAD_PASSES * steps,
            "elm_stats": steps, "rmsnorm": 0, "swa_attention": 0}


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
                stacked=stacked, seq=seq, ens=ens,
                scores=scores, launches=main_launches,
                seq_launches=seq_launches)


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
    return dict(stacked=stacked, launches=main_launches)


def phase_serve(torch, m):
    import numpy as np
    from repro_torch import kernels

    ens, test = m["ens"], m["test"]
    sizes = (1, 3, 17, 64)
    want = {n: ens.predict(test.x[:n]) for n in sizes}
    scorer = ens.bucketed_scorer(max_batch=SERVE_MAX_BATCH).warmup()
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
    # each scoring pass is one conv launch per stage
    check(serve_launches["conv2d"] == 2 * len(sizes) * (reps + 2) and
          serve_launches["elm_stats"] == 0 and
          serve_launches["rmsnorm"] == serve_launches["swa_attention"] == 0,
          f"serve launches {serve_launches}")
    scorer.swap_members(m["seq"].stacked)
    swapped = scorer.score_block(test.x[:17])
    ref = m["seq"].ensemble().member_scores(test.x[:17])
    check(np.allclose(swapped, ref, rtol=1e-5,
                      atol=1e-6 * np.abs(ref).max()), "scores after swap")
    emit("serve", latency_ms=lat, launches=serve_launches,
         swap="ok", requests=list(sizes))


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
    max_len = prompt + steps
    lg_c, cache_c = api.prefill(cfg, card, {"tokens": prompts}, max_len)
    lg_h, cache_h = api.prefill(cfg, host, {"tokens": prompts.cpu()},
                                max_len)
    errs, tops, tokens = [], [], []
    for t in range(steps + 1):
        c, h = lg_c.cpu(), lg_h
        check(bool(torch.isfinite(c).all()), f"lm (a): card logits at {t}")
        errs.append(float((c - h).abs().max()))
        tops.append(float(h.abs().max()))
        check(errs[-1] <= 1e-4 * tops[-1],
              f"lm (a) step {t}: card vs CPU logits {errs[-1]} > "
              f"1e-4 * {tops[-1]}")
        tc, th = c.argmax(-1), h.argmax(-1)
        check(torch.equal(tc, th), f"lm (a) step {t}: greedy tokens "
              f"{tc.tolist()} (card) != {th.tolist()} (CPU)")
        tokens.append(tc[:, 0].tolist())
        if t == steps:
            break
        pos = prompt + t
        lg_c, cache_c = api.decode_step(cfg, card, cache_c, tc.to(dev), pos)
        lg_h, cache_h = api.decode_step(cfg, host, cache_h, th, pos)
    emit("lm_parity", arch=f"{cfg.name}, 2 of 36 layers, full width, f32",
         batch=batch, prompt=prompt, decode_steps=steps,
         max_abs_err=errs, max_abs_logit=tops,
         bar=[1e-4 * top for top in tops], tokens=tokens)
    del card, host, cache_c, cache_h
    torch.cuda.empty_cache()
    return max(errs)


def phase_lm(torch, dev, batch=4, prompt=128, gen=32):
    """(b) the slice itself: the full qwen3_8b in bf16 through the port's
    ``launch.serve.run_lm``, as a user calls it; then a warm run and one
    profiled prefill and decode step."""
    import argparse
    import numpy as np
    from torch.profiler import ProfilerActivity, profile
    from repro_torch import kernels
    from repro_torch.configs import get_config
    from repro_torch.launch import serve
    from repro_torch.models import api

    args = argparse.Namespace(arch="qwen3_8b", reduced=False, seed=0,
                              device=str(dev), batch=batch, prompt_len=prompt,
                              gen=gen, greedy=True)
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    first = serve.run_lm(args)
    torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    cfg = get_config("qwen3_8b")
    L = cfg.num_layers
    steps = 1 + prompt + gen - 1       # the prefill, the replay, the decode
    want = {"rmsnorm": steps * (4 * L + 1), "swa_attention": L,
            "conv2d": 0, "elm_stats": 0, "conv2d_wgrad": 0,
            "conv2d_dgrad": 0}
    check(launches == want, f"lm launches {launches} != {want}")
    toks = first["tokens"]
    check(first["logits_finite"], "lm: logits are not finite")
    check(toks.shape == (batch, gen) and (toks >= 0).all()
          and (toks < cfg.vocab_size).all(), f"lm: token ids {toks.shape}")
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

    def profiled(fn):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
        rows = sorted(device_activity(torch, prof), reverse=True)
        busy = sum(us for us, _, _ in rows) / 1e3
        return dict(wall_ms=wall, device_busy_ms=busy if rows else
                    "not measured",
                    idle_share=1 - busy / wall if rows else "not measured",
                    top=[{"name": name[:60], "ms": us / 1e3, "count": count}
                         for us, name, count in rows[:8]])

    prof_prefill = profiled(lambda: api.prefill(cfg, params,
                                                {"tokens": prompts}))
    prof_decode = profiled(lambda: api.decode_step(cfg, params, cache, tok,
                                                   3))
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
    emit("lm", arch=cfg.name, dtype="bfloat16", batch=batch, prompt=prompt,
         gen=gen, launches=launches, peak_memory_bytes=peak,
         prefill_ms_first=first["prefill_ms"],
         tokens_per_s_first=first["tokens_per_s"],
         prefill_ms=warm["prefill_ms"], tokens_per_s=warm["tokens_per_s"],
         prefill_replay_gap=first["prefill_replay_gap"],
         max_abs_logit=first["max_abs_logit"],
         tokens=toks[0, :16].tolist(),
         same_tokens_warm=bool(np.array_equal(toks, warm["tokens"])),
         profile_prefill=prof_prefill, profile_decode_step=prof_decode)
    del params, cache
    torch.cuda.empty_cache()
    return launches


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
    phase_serve(torch, m)
    phase_profile(torch, m)
    phase_lm_parity(torch, dev)
    lm_launches = phase_lm(torch, dev)

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
                              "shard"))
    line = {"kernels": [
        {"name": "conv2d", "route": "cuda",
         "source": "src/repro_torch/csrc/conv2d.cu",
         "replaces": "src/repro/kernels/conv2d/kernel.py:28",
         "launches": main_launches["conv2d"],
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
         "launches": main_launches["elm_stats"],
         "max_abs_err": stats_err, "ms": stats["ms"],
         "plain_ms": stats["plain_ms"], "bound_ms": stats["bound_ms"],
         "bound_by": stats["bound_by"], "library_ms": stats["library_ms"]},
    ]}
    # conv2d_wgrad: one SGD step's dW of both stages; conv2d_dgrad: its dX
    # of stage 2; their launches from the SGD main path (the stacked
    # two-epoch Map)
    dx = per_case[("conv2d_dgrad", "dx_stage2")]
    line["kernels"].append(
        {"name": "conv2d_dgrad", "route": "cuda",
         "source": "src/repro_torch/csrc/conv2d_dgrad.cu",
         "replaces": "src/repro/kernels/conv2d/kernel.py:28 (the conv2d "
                     "TPU kernel; it has no Pallas backward)",
         "launches": sgd_launches["conv2d_dgrad"],
         "max_abs_err": dx["max_abs_err"], "ms": dx["ms"],
         "plain_ms": dx["plain_ms"], "bound_ms": dx["bound_ms"],
         "bound_by": dx["bound_by"], "library_ms": dx["library_ms"]})
    dw = [per_case[("conv2d_wgrad", c)] for c in ("dw_stage1", "dw_stage2")]
    line["kernels"].append(
        {"name": "conv2d_wgrad", "route": "cuda",
         "source": "src/repro_torch/csrc/conv2d_wgrad.cu",
         "replaces": "src/repro/kernels/conv2d/kernel.py:28 (the conv2d "
                     "TPU kernel; it has no Pallas backward)",
         "launches": sgd_launches["conv2d_wgrad"],
         "max_abs_err": max(c["max_abs_err"] for c in dw),
         "ms": sum(c["ms"] for c in dw),
         "plain_ms": sum(c["plain_ms"] for c in dw),
         "bound_ms": sum(c["bound_ms"] for c in dw),
         "bound_by": "bytes" if sum(c["bytes"] for c in dw) / rates[1]
         >= sum(c["flops"] for c in dw) / rates[0] else "operations",
         "library_ms": sum(c["library_ms"] for c in dw)})
    # rmsnorm: one ln (512 x 4096) and one q_norm (16384 x 128) launch of
    # the prefill; swa_attention: one layer's prefill attention
    rms = [per_case[("rmsnorm", c)] for c in ("ln_d4096", "qk_norm_d128")]
    swa = per_case[("swa_attention", "prefill_causal")]
    line["kernels"] += [
        {"name": "rmsnorm", "route": "cuda",
         "source": "src/repro_torch/csrc/rmsnorm.cu",
         "replaces": "src/repro/kernels/rmsnorm/kernel.py:23",
         "launches": lm_launches["rmsnorm"],
         "max_abs_err": max(c["max_abs_err"] for c in rms),
         "ms": sum(c["ms"] for c in rms),
         "plain_ms": sum(c["plain_ms"] for c in rms),
         "bound_ms": sum(c["bound_ms"] for c in rms),
         "bound_by": "bytes" if sum(c["bytes"] for c in rms) / rates[1]
         >= sum(c["flops"] for c in rms) / rates[0] else "operations",
         "library_ms": sum(c["library_ms"] for c in rms)},
        {"name": "swa_attention", "route": "cuda",
         "source": "src/repro_torch/csrc/swa_attention.cu",
         "replaces": "src/repro/kernels/swa_attention/kernel.py:28",
         "launches": lm_launches["swa_attention"],
         "max_abs_err": max(per_case[("swa_attention", c)]["max_abs_err"]
                            for c in ("prefill_causal", "window256_s1024",
                                      "prefill_large_scores")),
         "ms": swa["ms"], "plain_ms": swa["plain_ms"],
         "bound_ms": swa["bound_ms"], "bound_by": swa["bound_by"],
         "library_ms": swa["library_ms"]},
    ]
    print(json.dumps(line), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
