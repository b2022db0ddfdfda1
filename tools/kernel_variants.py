#!/usr/bin/env python3
"""Variants of the port's CUDA kernels, timed beside the shipped ones.

    python3 tools/kernel_variants.py [--kernels conv2d ...] [--baseline DIR]

Each variant is a copy of one source in ``src/repro_torch/csrc/`` with one
edit - a tile constant of elm_stats, swa_attention's copy loop for
hd == HDP switched off, conv2d's pixels per thread, tile size,
instantiation or stores, the conv backward's splits, tiles and bands, or
one phase of a block run twice - built alone with nvcc into
``build/variants/``. A variant tagged ``probe_`` leaves a phase out (its
output is wrong by design): it is timed, and its disagreement with the
plain version is reported but not a failure.
``--baseline DIR`` adds, for each kernel, a build of the same-named source in
DIR as it stands (an earlier checkout's ``src/repro_torch/csrc``: the same C
entry point; swa_attention's gained its log-sum-exp argument with the backward
kernels, so a baseline of that kernel must have it). swa_attention_bwd's
variants change its dK/dV key or query tile, the warp groups that share a
block's tiles, dQ's key tile or the tiles' copy loop, or leave one kernel out;
rmsnorm_bwd's change its chunks or leave out its dscale pass; its baseline
(the first design) is called with the chunks it chose. The shipped source is
built the same way beside them, and all the nvcc processes run together; the
port's own build is not touched. Every build is called through its C entry
point on the same inputs, checked against the kernel's plain version at
``chip_smoke.py``'s bars (and elm_stats's U for bitwise symmetry), and timed
by torch.profiler's device trace over 100 launches after warm-up, in two
rounds (the variants in order, then in reverse). The library call (cuBLAS bmm,
SDPA, cuDNN's grouped conv) is timed once per shape.

Prints one JSON line per build with its ptxas lines and its times per
shape, one line of library times per kernel, then the card's name and
power limit. Exits non-zero if a build fails or disagrees with the plain
version. Needs a CUDA card and nvcc.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import shutil
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402  (puts src/ on the path)

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# kernel -> (source, C entry point, argument types)
ENTRIES = {
    "conv2d": ("conv2d.cu", "conv2d_valid_f32",
               (_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P)),
    "elm_stats": ("elm_stats.cu", "elm_stats_f32",
                  (_P, _P, _P, _P, _I, _I, _I, _I, _P)),
    "swa_attention": ("swa_attention.cu", "swa_attention_fwd",
                      (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F, _I,
                       _P)),
    "rmsnorm_bwd": ("rmsnorm_bwd.cu", "rmsnorm_bwd",
                    (_P,) * 6 + (_I, _I, _I, _F, _I, _I, _P)),
    "swa_attention_bwd": ("swa_attention_bwd.cu", "swa_attention_bwd",
                          (_P,) * 10 + (_I,) * 6 + (_F, _I, _P)),
    "conv2d_wgrad": ("conv2d_wgrad.cu", "conv2d_wgrad_f32",
                     (_P, _P, _P, _P) + (_I,) * 9 + (_P,)),
    "conv2d_dgrad": ("conv2d_dgrad.cu", "conv2d_dgrad_f32",
                     (_P, _P, _P) + (_I,) * 8 + (_P,)),
}
_WALK = (r"walk<TJ, NCI, TC, COUT, SEGW, FIXED>\(\s*a, xrow, drow, ow0, "
         r"min\(OW, ow0 \+ a\.SEGW\), j0, c0, acc\);")
_ITEM = (r"item_fixed<KH, KW, CIN, COUT, P>\(a, ws, ys \+ g \* a\.IP, h, "
         r"ylo, w0, out\);")
# kernel -> [(variant, [(pattern, replacement), ...])]; every pattern must
# match the shipped source exactly once
VARIANTS = {
    "conv2d": [
        ("shipped", []),
        # one pixel an item at every launch: no reuse along the row
        ("pixels1", [(r"kWide = \d+;", "kWide = 1;")]),
        # four (or two) pixels and all channels an item at every launch
        ("pixels4_always", [(r"kWideItemsPerSm = \d+;",
                             "kWideItemsPerSm = 0;")]),
        ("pixels2_always", [(r"kWide = \d+;", "kWide = 2;"),
                            (r"kWideItemsPerSm = \d+;",
                             "kWideItemsPerSm = 0;")]),
        # eight pixels an item on large launches
        ("pixels8", [(r"kWide = \d+;", "kWide = 8;")]),
        # four channels an item on large launches too
        ("channels4", [(r"a\.CQ = a\.Cout;", "a.CQ = split;")]),
        # every shape through the generic instantiation (runtime loops)
        ("generic_only", [(r"if \(KH == 5 && KW == 5\) \{",
                           "if (false) {")]),
        # the output tile leaves in 4-byte stores
        ("scalar_stores", [(r"(void store_rows\([^{]*\{\s*const int n = "
                            r"nrows \* seg;\s*if \()", r"\1false && ")]),
        # tiles cut until there are 4 blocks an SM: one image a block at
        # stage 2
        ("blocks4", [(r"kMinBlocksPerSm = \d+;", "kMinBlocksPerSm = 4;")]),
        # one phase of the block run twice (the same values written again):
        # the time over the shipped kernel's is what that phase costs
        ("stage_twice", [(r"(?s)(  const int taps = .*?cp_async_wait\(\);)",
                          r"{\1}\n{\1}")]),
        ("compute_twice", [(r"(compute_fixed<KH, KW, CIN, COUT, P, CQ>"
                            r"\(t, ws, xs, ys\);)", r"{ \1 \1 }")]),
        ("store_twice", [(r"(  store_rows\(a\.y \+ t\.yoff[^;]*;)",
                          r"\1\n\1")]),
    ],
    "elm_stats": [
        ("shipped", []),
        ("tile32_kc64_st2", [(r"kKC = \d+;", "kKC = 64;"),
                             (r"kST = \d+;", "kST = 2;")]),
        ("tile32_kc32_st2", [(r"kST = \d+;", "kST = 2;")]),
        ("tile16_kc32_st3", [(r"kTile = \d+;", "kTile = 16;")]),
        ("tile16_kc64_st2", [(r"kTile = \d+;", "kTile = 16;"),
                             (r"kKC = \d+;", "kKC = 64;"),
                             (r"kST = \d+;", "kST = 2;")]),
    ],
    "swa_attention": [
        ("shipped", []),
        ("one_copy_loop", [(r"if \(vec16 && hd == HDP\) \{",
                            "if (false) {")]),
    ],
    "rmsnorm_bwd": [
        ("shipped", []),
        # twice the rows a chunk: half the blocks and partial rows
        ("chunks_half", [(r"(  const long long chunks =)",
                          r"  rows_per_chunk *= 2;\n\1")]),
        # pass 1 alone: the time over it is what the dscale pass costs
        ("probe_rows_only", [(r"  const int units = D % 4 == 0 \? D / 4 : D;",
                              r"  return 0;\n\g<0>")]),
    ],
    "swa_attention_bwd": [
        ("shipped", []),
        # 64 keys (4 warps) a dK/dV block: 64 blocks at the prefill shape
        # against the shipped 128
        ("keys64", [(r"kKvWarps = \d+;", "kKvWarps = 4;")]),
        # the query tiles of a dK/dV block walked by 2 or 4 warp groups
        # at every shape (summed in group order at the end)
        ("kv_split2", [(r"kKvFewBlocks = \d+;", "kKvFewBlocks = 0;")]),
        ("kv_split4", [(r"kKvFewBlocks = \d+;",
                        "kKvFewBlocks = 1 << 30;")]),
        # 16-query tiles in the dK/dV block: half the S^T and dP^T
        # registers of the shipped 32 (which spills at hd 112 and 128)
        ("kv_q16", [(r"kKvQ = \d+;", "kKvQ = 16;")]),
        # 32-key tiles in the dQ block
        ("dq_keys32", [(r"kQK = \d+;", "kQK = 32;")]),
        # the tiles' copy loop for hd == HDP switched off (the general
        # 16-byte loop at every hd)
        ("one_copy_loop", [(r"if \(vec16 && hd == HDP\) \{",
                            "if (false) {")]),
        # one main kernel left out (D's pre-pass and the other run)
        ("probe_dkdv_off", [(r"(\n  )(swa_bwd_dkdv_tc<HDP, SPLIT>"
                             r"\s*<<<)", r"\1if (false) \2")]),
        ("probe_dq_off", [(r"(\n  )(swa_bwd_dq_tc<HDP>\s*<<<)",
                           r"\1if (false) \2")]),
    ],
    "conv2d_wgrad": [
        ("shipped", []),
        # one phase run twice: the time over the shipped kernel's is what
        # it costs (staging twice leaves the results right)
        ("stage_twice", [(r"(stage\(a, m, chunk, t \+ 1, ring \+ \(\(t \+ 1\)"
                          r" & 1\) \* a\.ring\);)", r"\1 \1")]),
        ("probe_reduce_twice", [(r"for \(; h >= 1; h /= 2\) \{",
                                 "for (int h0 = h, rep = 0; rep < 2; "
                                 "++rep, h = h0) for (; h >= 1; h /= 2) {")]),
        ("probe_compute_twice", [(f"({_WALK})", r"\1 \1")]),
        ("probe_no_compute", [(_WALK, ";")]),
        ("probe_no_sum_pass", [(r"wgrad_sum_kernel<<<", "if (0) "
                                "wgrad_sum_kernel<<<")]),
        # the items, splits and tiles of the Map's two stages:
        # (Cin, Cout, side, channels an item, S, GI, NSEG)
        ("stage2_tc1_s4", [(r"run_fixed<6, 12, 12, 2, 8, 4, 1>",
                            "run_fixed<6, 12, 12, 1, 4, 4, 1>")]),
        ("stage2_tc4", [(r"run_fixed<6, 12, 12, 2, 8, 4, 1>",
                         "run_fixed<6, 12, 12, 4, 8, 4, 1>")]),
        ("stage2_s4", [(r"run_fixed<6, 12, 12, 2, 8, 4, 1>",
                        "run_fixed<6, 12, 12, 2, 4, 4, 1>")]),
        ("stage2_gi2", [(r"run_fixed<6, 12, 12, 2, 8, 4, 1>",
                         "run_fixed<6, 12, 12, 2, 8, 2, 1>")]),
        ("stage1_s32", [(r"run_fixed<1, 6, 28, 6, 48, 2, 2>",
                         "run_fixed<1, 6, 28, 6, 32, 2, 2>")]),
        ("stage1_nseg1", [(r"run_fixed<1, 6, 28, 6, 48, 2, 2>",
                           "run_fixed<1, 6, 28, 6, 48, 2, 1>")]),
        ("stage1_gi1", [(r"run_fixed<1, 6, 28, 6, 48, 2, 2>",
                         "run_fixed<1, 6, 28, 6, 48, 1, 2>")]),
        ("stage1_nseg4", [(r"run_fixed<1, 6, 28, 6, 48, 2, 2>",
                           "run_fixed<1, 6, 28, 6, 48, 2, 4>")]),
    ],
    "conv2d_dgrad": [
        ("shipped", []),
        ("stage_twice", [(r"(?s)(  const int nw = .*?cp_async_wait_all\(\);"
                          r"\s*__syncthreads\(\);)", r"{\1}\n{\1}")]),
        ("compute_twice", [(f"({_ITEM})", r"{ \1 \1 }")]),
        ("probe_no_compute", [(_ITEM, ";")]),
        ("band12", [(r"kBandRows = \d+;", "kBandRows = 12;")]),
        ("band4", [(r"kBandRows = \d+;", "kBandRows = 4;")]),
        ("pixels3", [(r"run<5, 5, 6, 12, 2>", "run<5, 5, 6, 12, 3>")]),
        ("pixels4", [(r"run<5, 5, 6, 12, 2>", "run<5, 5, 6, 12, 4>")]),
        # at most 85 (64) registers a thread, for three (four) blocks an SM
        ("min_blocks3", [(r"__launch_bounds__\(kMaxWarps \* kLanes\)",
                          "__launch_bounds__(kMaxWarps * kLanes, 3)")]),
        ("pixels4_min_blocks3", [
            (r"run<5, 5, 6, 12, 2>", "run<5, 5, 6, 12, 4>"),
            (r"__launch_bounds__\(kMaxWarps \* kLanes\)",
             "__launch_bounds__(kMaxWarps * kLanes, 3)")]),
        ("pixels4_min_blocks4", [
            (r"run<5, 5, 6, 12, 2>", "run<5, 5, 6, 12, 4>"),
            (r"__launch_bounds__\(kMaxWarps \* kLanes\)",
             "__launch_bounds__(kMaxWarps * kLanes, 4)")]),
        ("generic_only", [(r"if \(KH == 5 && KW == 5\) \{",
                           "if (false) {")]),
    ],
}
# (case, k, B, H, Cin, Cout, images a chunk of dW or None for the port's
# plan): the conv backward at the SGD Map's shapes (5x5 kernels)
GRAD_SHAPES = [("stage1", 4, 200, 28, 1, 6, None),
               ("stage2", 4, 200, 12, 6, 12, None),
               ("stage1_chunk1", 4, 200, 28, 1, 6, 1),
               ("stage1_chunk2", 4, 200, 28, 1, 6, 2),
               ("stage1_chunk8", 4, 200, 28, 1, 6, 8),
               ("stage1_3c9c", 4, 200, 28, 1, 3, None),
               ("seq_stage2", 1, 200, 12, 6, 12, None),
               ("stage2_chunk2", 4, 200, 12, 6, 12, 2),
               ("stage2_chunk8", 4, 200, 12, 6, 12, 8),
               ("stage2_3c9c", 4, 200, 12, 3, 9, None),
               ("stage2_reduced", 4, 200, 12, 2, 4, None)]
# (case, k, B, H, Cin, Cout): the stacked and sequential Maps' batches and
# a scoring request of one image, 5x5 kernels
CONV_SHAPES = [("stage1", 4, 200, 28, 1, 6), ("stage2", 4, 200, 12, 6, 12),
               ("seq_stage1", 1, 200, 28, 1, 6),
               ("seq_stage2", 1, 200, 12, 6, 12),
               ("score1_stage1", 4, 1, 28, 1, 6),
               ("score1_stage2", 4, 1, 12, 6, 12)]
# (case, k, n, L, C, masked)
ELM_SHAPES = [("unmasked", 4, 200, 192, 10, False),
              ("fractional_mask", 4, 200, 192, 10, True),
              ("shard", 4, 12_500, 192, 10, False)]
# (case, B, S, H, KV, hd, window)
SWA_SHAPES = [("prefill_causal", 4, 128, 32, 8, 128, 128),
              ("window256_s1024", 1, 1024, 32, 8, 128, 256),
              ("prefill_hd40", 4, 128, 32, 8, 40, 128)]


def nvcc():
    found = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(found):
        raise RuntimeError("nvcc not found")
    return found


def patched(text, edits):
    for pattern, repl in edits:
        text, hits = re.subn(pattern, repl, text)
        if hits != 1:
            raise RuntimeError(f"{pattern!r} matched {hits} times")
    return text


def variants_of(name, baseline):
    """[(tag, source text)] of kernel ``name``: the shipped source patched
    by each variant's edits, then the baseline directory's source."""
    from repro_torch import kernels
    src_name = ENTRIES[name][0]
    with open(kernels.CSRC / src_name) as f:
        text = f.read()
    out = [(tag, patched(text, edits)) for tag, edits in VARIANTS[name]]
    if baseline:
        with open(os.path.join(baseline, src_name)) as f:
            out.append(("baseline", f.read()))
    return out


def build_all(names, baseline):
    """{(kernel, variant): (ctypes function, ptxas lines)}, built in
    parallel."""
    from repro_torch import kernels
    out = os.path.join(ROOT, "build", "variants")
    os.makedirs(out, exist_ok=True)
    procs = {}
    for name in names:
        for tag, text in variants_of(name, baseline):
            cu = os.path.join(out, f"{name}_{tag}.cu")
            so = cu[:-3] + ".so"
            with open(cu, "w") as f:
                f.write(text)
            procs[(name, tag)] = (so, subprocess.Popen(
                [nvcc(), *kernels.NVCC_FLAGS, "-shared", cu, "-o", so],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    built = {}
    for key, (so, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {key}:\n{log}")
        _, fn_name, argtypes = ENTRIES[key[0]]
        fn = getattr(ctypes.CDLL(so), fn_name)
        fn.argtypes, fn.restype = list(argtypes), ctypes.c_int
        fn.variant = key[1]
        built[key] = (fn, [ln.strip() for ln in log.splitlines()
                           if "registers" in ln or "spill" in ln])
    return built


def launcher(fn, *args):
    import torch
    stream = torch.cuda.current_stream().cuda_stream

    def run():
        err = fn(*args, stream)
        if err:
            raise RuntimeError(f"launch failed: CUDA error {err}")
    return run


def close(got, ref, rtol):
    got, ref = got.float(), ref.float()
    top = float(ref.abs().max())
    return (bool(((got - ref).abs() <= chip_smoke.TOL * top
                  + rtol * ref.abs()).all()),
            float((got - ref).abs().max()))


def conv_cases(torch, dev, gen):
    import torch.nn.functional as F
    from repro_torch.kernels.conv2d import ref
    cases = {}
    for case, k, B, H, Cin, Cout in CONV_SHAPES:
        x = torch.rand((k, B, H, H, Cin), generator=gen).to(dev)
        w = (torch.randn((k, 5, 5, Cin, Cout), generator=gen) * 0.2).to(dev)
        want = ref.conv2d_valid_ref(x, w)
        out = torch.empty_like(want)
        xn = x.permute(1, 0, 4, 2, 3).reshape(B, k * Cin, H, H).contiguous()
        wn = w.permute(0, 4, 3, 1, 2).reshape(k * Cout, Cin, 5, 5
                                              ).contiguous()

        def call(fn, x=x, w=w, out=out, k=k, B=B, H=H, Cin=Cin,
                 Cout=Cout):
            return launcher(fn, x.data_ptr(), w.data_ptr(), out.data_ptr(),
                            k, B, H, H, Cin, 5, 5, Cout)

        def verdict(out=out, want=want):
            return close(out, want, chip_smoke.TOL)
        cases[case] = (call, verdict,
                       lambda xn=xn, wn=wn, k=k: F.conv2d(xn, wn, groups=k))
    return cases


def elm_cases(torch, dev, gen):
    import torch.nn.functional as F
    from repro_torch.kernels.elm_stats import ref
    cases = {}
    for case, k, n, L, C, masked in ELM_SHAPES:
        h = torch.tanh(torch.randn((k, n, L), generator=gen)).to(dev)
        t = F.one_hot(torch.randint(0, C, (k, n), generator=gen),
                      C).float().to(dev)
        m = torch.rand((k, n), generator=gen).to(dev) if masked else None
        want = ref.elm_stats_ref(h, t, m)
        out = torch.empty_like(want)
        hm = h if m is None else h * m[..., None]
        a = hm.transpose(1, 2).contiguous()
        b = torch.cat([h, t], dim=-1).contiguous()

        # the closure holds m itself, not its address: the mask must stay
        # alive while later cases allocate
        def call(fn, h=h, t=t, m=m, out=out, k=k, n=n, L=L, C=C):
            return launcher(fn, h.data_ptr(), t.data_ptr(),
                            None if m is None else m.data_ptr(),
                            out.data_ptr(), k, n, L, C)

        def verdict(out=out, want=want, L=L):
            ok, err = close(out, want, chip_smoke.TOL)
            u = out[..., :L]
            return ok and torch.equal(u, u.transpose(1, 2)), err
        cases[case] = (call, verdict, lambda a=a, b=b: torch.matmul(a, b))
    return cases


def _f64_rule(got, plain, truth):
    """chip_smoke's bar for the conv backward: within twice the f32 plain
    version's own distance from the f64 truth, or 1e-5 · max|truth|."""
    err = float((got.double() - truth).abs().max())
    bar = max(2 * float((plain.double() - truth).abs().max()),
              chip_smoke.TOL * float(truth.abs().max()))
    return err <= bar, err


def wgrad_cases(torch, dev, gen):
    from torch.nn import grad as nn_grad
    from repro_torch.kernels.conv2d import ops, ref
    cases = {}
    for case, k, B, H, Cin, Cout, group in GRAD_SHAPES:
        OH = H - 4
        x = torch.rand((k, B, H, H, Cin), generator=gen).to(dev)
        dy = torch.randn((k, B, OH, OH, Cout), generator=gen).to(dev)
        plain = ref.conv2d_weight_grad_ref(x, dy, 5, 5)
        truth = ref.conv2d_weight_grad_ref(x.double(), dy.double(), 5, 5)
        group = group or ops.wgrad_plan(B)[0]
        part = torch.empty(k * -(-B // group) * 25 * Cin * Cout, device=dev)
        out = torch.empty_like(plain)
        xn = x.permute(1, 0, 4, 2, 3).reshape(B, k * Cin, H, H).contiguous()
        dyn = dy.permute(1, 0, 4, 2, 3).reshape(B, k * Cout, OH, OH
                                                ).contiguous()

        def call(fn, x=x, dy=dy, part=part, out=out, k=k, B=B, H=H,
                 Cin=Cin, Cout=Cout, group=group):
            return launcher(fn, x.data_ptr(), dy.data_ptr(), part.data_ptr(),
                            out.data_ptr(), k, B, H, H, Cin, 5, 5, Cout,
                            group)

        def verdict(out=out, plain=plain, truth=truth):
            return _f64_rule(out, plain, truth)

        def library(xn=xn, dyn=dyn, k=k, Cin=Cin, Cout=Cout):
            return nn_grad.conv2d_weight(xn, (k * Cout, Cin, 5, 5), dyn,
                                         groups=k)
        cases[case] = (call, verdict, library)
    return cases


def dgrad_cases(torch, dev, gen):
    import torch.nn.functional as F
    from torch.nn import grad as nn_grad
    from repro_torch.kernels.conv2d import ops
    cases = {}
    for case, k, B, H, Cin, Cout, group in GRAD_SHAPES:
        if H != 12 or group:      # dX runs at the second stages only
            continue
        OH = H - 4
        w = (torch.randn((k, 5, 5, Cin, Cout), generator=gen) * 0.2).to(dev)
        dy = torch.randn((k, B, OH, OH, Cout), generator=gen).to(dev)
        # the padded route's values: the forward kernel on padded dY
        want = ops.conv2d_valid(F.pad(dy, (0, 0, 4, 4, 4, 4)),
                                w.flip(1, 2).transpose(3, 4).contiguous())
        out = torch.empty_like(want)
        wn = w.permute(0, 4, 3, 1, 2).reshape(k * Cout, Cin, 5, 5
                                              ).contiguous()
        dyn = dy.permute(1, 0, 4, 2, 3).reshape(B, k * Cout, OH, OH
                                                ).contiguous()

        def call(fn, dy=dy, w=w, out=out, k=k, B=B, H=H, Cin=Cin,
                 Cout=Cout):
            return launcher(fn, dy.data_ptr(), w.data_ptr(), out.data_ptr(),
                            k, B, H, H, Cin, 5, 5, Cout)

        def verdict(out=out, want=want):
            return (torch.equal(out, want),
                    float((out - want).abs().max()))

        def library(wn=wn, dyn=dyn, k=k, B=B, H=H, Cin=Cin):
            return nn_grad.conv2d_input((B, k * Cin, H, H), wn, dyn,
                                        groups=k)
        cases[case] = (call, verdict, library)
    return cases


def swa_cases(torch, dev, gen):
    import torch.nn.functional as F
    from repro_torch.kernels.swa_attention import ref
    cases = {}
    for case, B, S, H, KV, hd, W in SWA_SHAPES:
        q, k, v = (torch.randn((B, S, heads, hd), generator=gen)
                   .to(torch.bfloat16).to(dev) for heads in (H, KV, KV))
        want = ref.swa_attention_ref(q, k, v, window=W)
        out = torch.empty_like(q)
        qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
        i = torch.arange(S, device=dev)
        mask = None if W >= S else ((i[None] <= i[:, None])
                                    & (i[:, None] - i[None] < W))

        def call(fn, q=q, k=k, v=v, out=out, B=B, S=S, H=H, KV=KV,
                 hd=hd, W=W):
            return launcher(fn, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                            out.data_ptr(), None, B, S, H, KV, hd, W,
                            hd ** -0.5, 1)

        def verdict(out=out, want=want):
            return close(out, want, chip_smoke.BF16_RTOL)

        def library(qt=qt, kt=kt, vt=vt, mask=mask):
            return F.scaled_dot_product_attention(
                qt, kt, vt, attn_mask=mask, is_causal=mask is None,
                enable_gqa=True)
        cases[case] = (call, verdict, library)
    return cases


def _two_ulps(got, ref):
    """(within 2 bf16 ulps of max|ref| for every output, max|err|) — the
    bar of chip_smoke.py's backward cases on bf16 outputs."""
    import math
    ok, worst = True, 0.0
    for g, r in zip(got, ref):
        top = float(r.float().abs().max())
        ulp = 2.0 ** (math.floor(math.log2(max(top, 1e-30))) - 7)
        err = float((g.float() - r.float()).abs().max())
        ok, worst = ok and err <= 2 * ulp, max(worst, err)
    return ok, worst


def rms_bwd_cases(torch, dev, gen):
    import torch.nn.functional as F
    from repro_torch.kernels.rmsnorm import ops, ref
    cases = {}
    for case, (n, D), s_dt in [("ln_d4096", (512, 4096), torch.float32),
                               ("qk_norm_d128", (16384, 128),
                                torch.bfloat16)]:
        x = (torch.randn((n, D), generator=gen) * 3).to(torch.bfloat16).to(
            dev)
        scale = (1 + 0.1 * torch.randn((D,), generator=gen)).to(s_dt).to(dev)
        dy = torch.randn((n, D), generator=gen).to(torch.bfloat16).to(dev)
        want = ref.rmsnorm_bwd_ref(x, scale, dy, 1e-6)
        # rows a chunk and the partial rows' scratch: the shipped rule, and
        # the first design's (a baseline's) own
        rows = {"shipped": ops.bwd_rows_per_chunk(n, D),
                "baseline": max(8 if D <= 1024 else 4, -(-n // 264))}
        part = {tag: torch.empty(-(-n // r) * D, device=dev)
                for tag, r in rows.items()}
        dx, ds = torch.empty_like(x), torch.empty_like(scale)
        xr = x.clone().requires_grad_(True)
        w = scale.to(x.dtype).requires_grad_(True)
        y = F.rms_norm(xr, (D,), w, 1e-6)

        def call(fn, x=x, scale=scale, dy=dy, dx=dx, part=part, ds=ds, n=n,
                 D=D, rows=rows, sb=int(s_dt == torch.bfloat16)):
            tag = "baseline" if fn.variant == "baseline" else "shipped"
            return launcher(fn, x.data_ptr(), scale.data_ptr(), dy.data_ptr(),
                            dx.data_ptr(), part[tag].data_ptr(), ds.data_ptr(),
                            n, D, rows[tag], 1e-6, 1, sb)

        def verdict(dx=dx, ds=ds, want=want):
            return _two_ulps((dx, ds), want)

        def library(y=y, xr=xr, w=w, dy=dy):
            return torch.autograd.grad(y, (xr, w), dy, retain_graph=True)
        cases[case] = (call, verdict, library)
    return cases


def swa_bwd_cases(torch, dev, gen):
    import torch.nn.functional as F
    from repro_torch.kernels.swa_attention import ops, ref
    cases = {}
    for case, B, S, H, KV, hd, W in SWA_SHAPES:
        q, k, v, do = (torch.randn((B, S, heads, hd), generator=gen)
                       .to(torch.bfloat16).to(dev)
                       for heads in (H, KV, KV, H))
        o, lse = ops.swa_attention_fwd(q, k, v, window=W)
        want = ref.swa_attention_bwd_ref(q, k, v, o, lse, do, window=W)
        delta = torch.empty_like(lse)
        dq, dk, dv = (torch.empty_like(a) for a in (q, k, v))
        qt, kt, vt = (x.transpose(1, 2).contiguous().requires_grad_(True)
                      for x in (q, k, v))
        i = torch.arange(S, device=dev)
        mask = None if W >= S else ((i[None] <= i[:, None])
                                    & (i[:, None] - i[None] < W))
        y = F.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=mask, is_causal=mask is None,
            enable_gqa=True)
        dot = do.transpose(1, 2).contiguous()

        def call(fn, q=q, k=k, v=v, o=o, do=do, lse=lse,
                 delta=delta, dq=dq, dk=dk, dv=dv, B=B, S=S, H=H, KV=KV,
                 hd=hd, W=W):
            return launcher(fn, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                            o.data_ptr(), do.data_ptr(), lse.data_ptr(),
                            delta.data_ptr(), dq.data_ptr(), dk.data_ptr(),
                            dv.data_ptr(), B, S, H, KV, hd, W, hd ** -0.5, 1)

        def verdict(dq=dq, dk=dk, dv=dv, want=want):
            return _two_ulps((dq, dk, dv), want)

        def library(y=y, qt=qt, kt=kt, vt=vt, dot=dot):
            return torch.autograd.grad(y, (qt, kt, vt), dot,
                                       retain_graph=True)
        cases[case] = (call, verdict, library)
    return cases


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--kernels", nargs="+", choices=sorted(VARIANTS),
                        default=sorted(VARIANTS))
    parser.add_argument("--baseline", metavar="DIR",
                        help="also build each kernel's source from DIR")
    args = parser.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        sys.exit("kernel_variants needs a CUDA card")
    import repro_torch  # noqa: F401  (sets the TF32 flags)
    dev = torch.device("cuda")
    card = chip_smoke.card_line()
    built = build_all(args.kernels, args.baseline)
    gen = torch.Generator().manual_seed(0)
    make = {"conv2d": conv_cases, "elm_stats": elm_cases,
            "swa_attention": swa_cases, "conv2d_wgrad": wgrad_cases,
            "conv2d_dgrad": dgrad_cases, "rmsnorm_bwd": rms_bwd_cases,
            "swa_attention_bwd": swa_bwd_cases}
    shapes = {name: make[name](torch, dev, gen) for name in args.kernels}
    failed = []
    for name, cases in shapes.items():
        tags = [tag for tag, _ in variants_of(name, args.baseline)]
        recs = {tag: {"kernel": name, "variant": tag,
                      "ptxas": built[(name, tag)][1]} for tag in tags}
        for case, (call, verdict, _) in cases.items():
            for tag in tags:
                call(built[(name, tag)][0])()
                torch.cuda.synchronize()
                ok, err = verdict()
                recs[tag][case] = {"ok": ok, "max_abs_err": err, "ms": []}
                if not ok and not tag.startswith("probe_"):
                    failed.append((name, tag, case))
            for tag in tags + tags[::-1]:
                recs[tag][case]["ms"].append(chip_smoke.device_ms(
                    torch, call(built[(name, tag)][0])))
        for tag in tags:
            print(json.dumps(recs[tag]), flush=True)
        print(json.dumps({"kernel": name, "library_ms": {
            case: chip_smoke.device_ms(torch, lib)
            for case, (_, _, lib) in cases.items()}}), flush=True)
    print(card, flush=True)
    if failed:
        sys.exit(f"variants that disagree with the plain version: {failed}")


if __name__ == "__main__":
    main()
