#!/usr/bin/env python3
"""Variants of the port's CUDA kernels, timed beside the shipped ones.

    python3 tools/kernel_variants.py [--kernels conv2d ...] [--baseline DIR]
                                     [--variants TAG ...]

Each variant is a copy of a kernel's sources in ``src/repro_torch/csrc/``
(swa_attention and swa_attention_bwd: the entry's file with the causal f32
kernels, the wgmma ``swa_full_*.cu`` file and their header) with one edit
- elm_stats's stages or unrolls, the attention kernels' stages, copies,
split or block order, conv2d's pixels per thread,
tile size, instantiation or stores, the conv backward's splits, tiles and
bands, or one phase of a block run twice - built alone with nvcc into
``build/variants/``. A variant tagged ``probe_`` leaves a phase out (its
output is wrong by design): it is timed, and its disagreement with the
plain version is reported but not a failure.
``--baseline DIR`` adds, for each kernel, a build of the same-named sources
in DIR as they stand (an earlier checkout's ``src/repro_torch/csrc``: the
same C entry point; those of the kernel's files that DIR lacks are left out,
as a checkout from before the non-causal files kept that mode in the causal
file; swa_attention's gained its log-sum-exp argument with the backward
kernels, so a baseline of that kernel must have it; a swa_attention or
swa_attention_bwd source without the later causal argument is called without
it and runs the causal shapes alone; the parent of the causal wgmma
kernels, whose causal bf16 kernels were its mma.sync ones, takes the same
arguments as the shipped build). Each
swa_attention build's output, and each swa_attention_bwd build's dq, dk
and dv, are also compared bit for bit with the shipped source's
(``bitwise_shipped``); both run the causal cases of chip_smoke.py's phase
kernel (the prefill, a window of 256 at S 1024, q scaled by 8, Zamba2's
shared block, OLMoE's prefill, a 4,096-token sequence; the backward
without the scaled q), hd 40 and its non-causal ones (HuBERT's encoder,
S 1000, a small f32 case). The attention variants copy tiles by threads,
not TMA, round the hi part of the split weights to nearest, not down,
run the causal blocks in the grid's order, not the longest walks first,
or leave out (``probe_``) the lo products, the exponentials, the
forward's output stores, a kernel, or the causal launch's dK/dV or dQ
blocks; the backward's take the IEEE exp2f, the forward's the
hardware's exp2, and the forward's also change its stages, keep Q in
shared memory for S or truncate lo too;
rmsnorm_bwd's change its chunks or leave out its dscale pass; its baseline
(the first design) is called with the chunks it chose. elm_stats's builds
run the Map's and the stream's batches, a whole shard, E²LM's shards, the
three heads and one-chunk shapes between them, each called with its plan
(``kernels/elm_stats/ops.py``), and the shipped build again under the
tags of ``CALLS``: a split with other rows a chunk, a one-chunk shape
through the other of the narrow and wide tiles; over 25,000 rows a member
they are held against f64 within the f32 summation bound, and a shape
whose plan has one chunk must come out bit for bit the shipped build's in
every build and call but a ``probe_`` one, the baseline's included (a
baseline from before the row split is called with its old arguments). The
shipped source is
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
_L = ctypes.c_longlong
# kernel -> (source, C entry point, argument types)
ENTRIES = {
    "conv2d": (("conv2d.cu",), "conv2d_valid_f32",
               (_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P)),
    "elm_stats": (("elm_stats.cu",), "elm_stats_f32",
                  (_P, _P, _P, _P, _L, _P, _I, _I, _I, _I, _I, _I, _P)),
    "swa_attention": (("swa_attention.cu", "swa_full_fwd.cu",
                       "swa_full.cuh"), "swa_attention_fwd",
                      (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _F,
                       _I, _P)),
    "rmsnorm_bwd": (("rmsnorm_bwd.cu",), "rmsnorm_bwd",
                    (_P,) * 6 + (_I, _I, _I, _F, _I, _I, _P)),
    "swa_attention_bwd": (("swa_attention_bwd.cu", "swa_full_bwd.cu",
                           "swa_full.cuh"), "swa_attention_bwd",
                          (_P,) * 10 + (_I,) * 7 + (_F, _I, _P)),
    "conv2d_wgrad": (("conv2d_wgrad.cu",), "conv2d_wgrad_f32",
                     (_P, _P, _P, _P) + (_I,) * 9 + (_P,)),
    "conv2d_dgrad": (("conv2d_dgrad.cu",), "conv2d_dgrad_f32",
                     (_P, _P, _P) + (_I,) * 8 + (_P,)),
}
# the non-causal kernels' hi + lo split: the shipped hi (truncated), hi
# rounded to nearest by the bf16x2 conversion
_SPLIT = (r"  const uint32_t h0 = __float_as_uint\(x0\) & 0xFFFF0000u;\n"
          r"  const uint32_t h1 = __float_as_uint\(x1\) & 0xFFFF0000u;\n"
          r"  hi = \(h0 >> 16\) \| h1;\n"
          r"  lo = as_u32\(__floats2bfloat162_rn\(x0 - __uint_as_float\(h0\),"
          r"\s*x1 - __uint_as_float\(h1\)\)\);")
# lo truncated too: no conversion instruction at all (2^-14 of P kept)
_SPLIT_TRUNC2 = """  const uint32_t h0 = __float_as_uint(x0) & 0xFFFF0000u;
  const uint32_t h1 = __float_as_uint(x1) & 0xFFFF0000u;
  hi = (h0 >> 16) | h1;
  lo = ((__float_as_uint(x0 - __uint_as_float(h0)) >> 16) |
        (__float_as_uint(x1 - __uint_as_float(h1)) & 0xFFFF0000u));"""
_SPLIT_RN = """  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float2 hf = __bfloat1622float2(h);
  hi = as_u32(h);
  lo = as_u32(__floats2bfloat162_rn(x0 - hf.x, x1 - hf.y));"""
_WALK = (r"walk<TJ, NCI, TC, COUT, SEGW, FIXED>\(\s*a, xrow, drow, ow0, "
         r"min\(OW, ow0 \+ a\.SEGW\), j0, c0, acc\);")
_ITEM = (r"item_fixed<KH, KW, CIN, COUT, P>\(a, ws, ys \+ g \* a\.IP, h, "
         r"ylo, w0, out\);")
# elm_stats's wide kernel without copies or waits: the producer issues no
# stage, the consumers wait for none
_ELM_NO_COPIES = [
    (r"for \(int s = 0; s < stages; \+\+s\) \{\n(\s*)const int st = "
     r"s % kWST, round", r"for (int s = 0; s < 0; ++s) {\n\1const int st = "
     r"s % kWST, round"),
    (r"\n\s*bar_wait\(full\(st\), \(s / kWST\) & 1\);", "")]
# the FMA loops' unroll pragmas: the wide kernel's, the strip's
_ELM_WIDE_LOOP = (r"#pragma unroll 8\n(\s*for \(int rr = 0; rr < kWKC; "
                  r"\+\+rr\) \{\n\s*float av\[kWTM\])")
_ELM_STRIP_LOOP = (r"#pragma unroll 8\n(\s*for \(int rr = 0; rr < kWKC; "
                   r"\+\+rr\) \{\n\s*float av\[kSub\])")
# kernel -> [(variant, [(pattern, replacement), ...])]; every pattern must
# match the shipped source exactly once (the kernel's first file, or the
# file named first in a (file, pattern, replacement) edit)
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
        # the wide ring's stages: 2 or 4 where it ships 3; its FMA loop's
        # rows unrolled by 4, where it ships 8
        ("wide_st2", [(r"kWST = \d+;", "kWST = 2;")]),
        ("wide_st4", [(r"kWST = \d+;", "kWST = 4;")]),
        ("wide_unroll4", [(_ELM_WIDE_LOOP, r"#pragma unroll 4\n\1")]),
        # the strip's stages: 2 or 4 where it ships 3; its FMA loop's rows
        # unrolled by 4, where it ships 8
        ("strip_st2", [(r"kSST = \d+;", "kSST = 2;")]),
        ("strip_st4", [(r"kSST = \d+;", "kSST = 4;")]),
        ("strip_unroll4", [(_ELM_STRIP_LOOP, r"#pragma unroll 4\n\1")]),
        # every tile by the producer warp's cp.async, not TMA
        ("cp_async", [(r"const bool tma = L % 4 == 0",
                       "const bool tma = false && L")]),
        # the wide kernel's consumers skip every stage's loads and FMAs
        # (what its copies and barriers alone take), or it issues no copy
        # and waits for none (what its loads and FMAs alone take)
        ("probe_copies_only", [(r"const bool active = ",
                                "const bool active = false && ")]),
        ("probe_compute_only", _ELM_NO_COPIES),
    ],
    "swa_attention": [
        ("shipped", []),
        # the wgmma kernel (both modes): 4 or 2 k/v stages where it ships 3
        ("full_stages4", [("swa_full_fwd.cu", r"kFwdStages = \d+;",
                           "kFwdStages = 4;")]),
        ("full_stages2", [("swa_full_fwd.cu", r"kFwdStages = \d+;",
                           "kFwdStages = 2;")]),
        # the warpgroups issue their products as they come, not in turns
        ("fwd_no_turns", [
            ("swa_full_fwd.cu", r"const auto my_turn = \[&\]\(\) \{ "
             r"named_sync\(1 \+ wg, kThreads\); \};",
             "const auto my_turn = [&]() {};"),
            ("swa_full_fwd.cu", r"if \(!\(last && wg == 1\)\) "
             r"named_arrive\(2 - wg, kThreads\);", "(void)last;"),
            ("swa_full_fwd.cu", r"if \(wg == 1\) named_arrive\(1, kThreads\);",
             "")]),
        # no output stores (the lse's stay): what the epilogue's stores
        # take
        ("probe_fwd_no_store", [("swa_full_fwd.cu",
                                 r"\n    if \(a\.tma_o\) \{",
                                 "\n    if (qi0 >= 0) return;\n"
                                 "    if (a.tma_o) {")]),
        # its causal query tiles in the grid's order, not the last (the
        # longest walks) first
        ("causal_first_tiles_first", [
            ("swa_full_fwd.cu", r"CAUSAL \? gridDim\.y - 1 - blockIdx\.y",
             "CAUSAL ? blockIdx.y")]),
        # tiles copied by warpgroup 0's threads, not TMA
        ("full_thread_copies", [("swa_full_fwd.cu", r"a\.tma = hd % 8 == 0",
                                 "a.tma = false && hd % 8 == 0")]),
        # S = Q.K^T with Q read from shared memory (SS form), not from
        # registers
        ("full_q_smem", [("swa_full_fwd.cu", r"kQRegsMax = \d+;",
                          "kQRegsMax = 0;")]),
        # P's hi rounded to nearest by a conversion, not truncated
        ("full_split_rn", [("swa_full.cuh", _SPLIT, _SPLIT_RN)]),
        ("full_split_trunc2", [("swa_full.cuh", _SPLIT, _SPLIT_TRUNC2)]),
        # the softmax's exp2f replaced by a product: what the exponentials
        # cost (wrong weights)
        ("probe_full_no_exp", [
            ("swa_full_fwd.cu", r"exp2f\(fmaf\(s\[4 \* n \+ e\], "
             r"scale_log2, -mn0\)\)", "fmaf(s[4 * n + e], 1e-3f, 0.5f)"),
            ("swa_full_fwd.cu",
             r"exp2f\(fmaf\(s\[4 \* n \+ 2 \+ e\], scale_log2, -mn1\)\)",
             "fmaf(s[4 * n + 2 + e], 1e-3f, 0.5f)")]),
        # the hardware's exp2 (denormal results flushed) in place of the
        # IEEE exp2f the forward keeps: what exp2f's handling costs there
        ("full_ex2_ftz", [
            ("swa_full_fwd.cu", r"exp2f\(fmaf\(s\[4 \* n \+ e\], "
             r"scale_log2, -mn0\)\)",
             "exp2_ftz(fmaf(s[4 * n + e], scale_log2, -mn0))"),
            ("swa_full_fwd.cu",
             r"exp2f\(fmaf\(s\[4 \* n \+ 2 \+ e\], scale_log2, -mn1\)\)",
             "exp2_ftz(fmaf(s[4 * n + 2 + e], scale_log2, -mn1))")]),
        # P.V with P's hi alone: what the lo products cost
        ("probe_full_hi_only", [("swa_full_fwd.cu",
                                 r"\n *wgmma_rs<HDP>\(o, pl \+ 4 \* kk, d\);",
                                 "")]),
        # the f32 route with 4 warps (rows) a block, not 8
        ("full_f32_warps4", [("swa_full.cuh", r"kF32Warps = \d+;",
                              "kF32Warps = 4;")]),
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
        # the non-causal kernels: copies by warpgroup 0's threads, one
        # main kernel left out, P's and dS's hi rounded to nearest, the lo
        # products left out (5 stages do not fit at hd 128)
        ("full_thread_copies", [("swa_full_bwd.cu", r"a\.tma = hd % 8 == 0",
                                 "a.tma = false && hd % 8 == 0")]),
        ("probe_full_dkdv_off", [("swa_full_bwd.cu",
                                  r"(\n  )(dkdv<<<)", r"\1if (false) \2")]),
        ("probe_full_dq_off", [("swa_full_bwd.cu",
                                r"(\n  )(dq<<<)", r"\1if (false) \2")]),
        # the exponentials of P replaced by a product: what they cost
        ("probe_full_no_exp", [
            ("swa_full_bwd.cu", r"(?<=in \? )exp2_ftz\(fmaf\(s\[4 \* n "
             r"\+ e\], scale_log2, -ls\[c\]\)\)",
             "fmaf(s[4 * n + e], 1e-3f, 0.5f)"),
            ("swa_full_bwd.cu", r"(?<=in \? )exp2_ftz\(fmaf\(s\[4 \* n "
             r"\+ 2 \+ e\], scale_log2, -ls\[c\]\)\)",
             "fmaf(s[4 * n + 2 + e], 1e-3f, 0.5f)"),
            ("swa_full_bwd.cu", r"exp2_ftz\(fmaf\(s\[4 \* n \+ e\], "
             r"scale_log2, -l0\)\)", "fmaf(s[4 * n + e], 1e-3f, 0.5f)"),
            ("swa_full_bwd.cu", r"exp2_ftz\(fmaf\(s\[4 \* n \+ 2 \+ e\], "
             r"scale_log2, -l1\)\)", "fmaf(s[4 * n + 2 + e], 1e-3f, 0.5f)")]),
        # P by the IEEE exp2f, not the hardware's exp2 (denormal results
        # flushed): what exp2f's denormal handling costs
        ("full_exp2f", [
            ("swa_full_bwd.cu", r"in \? exp2_ftz\(fmaf\(s\[4 \* n \+ e\], "
             r"scale_log2, -ls\[c\]\)\)",
             "in ? exp2f(fmaf(s[4 * n + e], scale_log2, -ls[c]))"),
            ("swa_full_bwd.cu",
             r"in \? exp2_ftz\(fmaf\(s\[4 \* n \+ 2 \+ e\], "
             r"scale_log2, -ls\[c\]\)\)",
             "in ? exp2f(fmaf(s[4 * n + 2 + e], scale_log2, -ls[c]))"),
            ("swa_full_bwd.cu", r"in0 \? exp2_ftz\(fmaf\(s\[4 \* n \+ e\], "
             r"scale_log2, -l0\)\)",
             "in0 ? exp2f(fmaf(s[4 * n + e], scale_log2, -l0))"),
            ("swa_full_bwd.cu",
             r"in1 \? exp2_ftz\(fmaf\(s\[4 \* n \+ 2 \+ e\], "
             r"scale_log2, -l1\)\)",
             "in1 ? exp2f(fmaf(s[4 * n + 2 + e], scale_log2, -l1))"),
            ("swa_full_bwd.cu", r"in0 \? exp2_ftz\(fmaf\(s\[4 \* n \+ e\], "
             r"scale_log2, -lc\)\)",
             "in0 ? exp2f(fmaf(s[4 * n + e], scale_log2, -lc))"),
            ("swa_full_bwd.cu",
             r"in1 \? exp2_ftz\(fmaf\(s\[4 \* n \+ 2 \+ e\], "
             r"scale_log2, -lc\)\)",
             "in1 ? exp2f(fmaf(s[4 * n + 2 + e], scale_log2, -lc))")]),
        ("probe_full_delta_only", [
            ("swa_full_bwd.cu", r"(\n  )(dkdv<<<)", r"\1if (false) \2"),
            ("swa_full_bwd.cu", r"(\n  )(dq<<<)", r"\1if (false) \2"),
            ("swa_full_bwd.cu", r"(\n    )(kernel<<<)", r"\1if (false) \2")]),
        # the causal launch's dK/dV or dQ blocks return at once: what the
        # other role's blocks and the D pre-pass take
        ("probe_causal_dkdv_off", [
            ("swa_full_bwd.cu", r"causal_dkdv_block<HDP, STAGES>\(a, smem_raw, "
             r"x % n_bkv, x / n_bkv\);", ";")]),
        ("probe_causal_dq_off", [
            ("swa_full_bwd.cu", r"dq_block<HDP, STAGES, true>\(a, smem_raw, "
             r"y % n_bh,\s*\(nqt - 1 - y / n_bh\) \* 2 \* kRows\);",
             "(void)y;")]),
        ("full_split_rn", [("swa_full.cuh", _SPLIT, _SPLIT_RN)]),
        ("probe_full_hi_only", [
            ("swa_full_bwd.cu", r"\n *wgmma_rs<HDP>\(dv, pl \+ 4 \* kk, d\);",
             "", 2),
            ("swa_full_bwd.cu", r"\n *wgmma_rs<HDP>\(dk, dl \+ 4 \* kk, d\);",
             "", 2),
            ("swa_full_bwd.cu", r"\n *wgmma_rs<HDP>\(dq, dl \+ 4 \* kk, d\);",
             "")]),
        ("full_f32_warps4", [("swa_full.cuh", r"kF32Warps = \d+;",
                              "kF32Warps = 4;")]),
        ("probe_f32_dkdv_off", [("swa_full_bwd.cu",
                                 r"(\n  )(f32_dkdv_kernel<<<)",
                                 r"\1if (false) \2")]),
        ("probe_f32_dq_off", [("swa_full_bwd.cu", r"(\n  )(f32_dq_kernel<<<)",
                               r"\1if (false) \2")]),
        # the causal wgmma kernels' grid order: dQ's query tiles first to
        # last, not the last (the longest walks) first; dK/dV's key tiles
        # last to first, not the first (the longest walks) first
        ("causal_dq_first_tiles_first", [
            ("swa_full_bwd.cu", r"\(nqt - 1 - y / n_bh\) \* 2 \* kRows",
             "(y / n_bh) * 2 * kRows")]),
        ("causal_dkdv_last_keys_first", [
            ("swa_full_bwd.cu", r"x % n_bkv, x / n_bkv\);",
             "x % n_bkv, n_kv / n_bkv - 1 - x / n_bkv);")]),
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
# (case, k, n, L, C, masked): the Map's batches, the stream's, a whole
# shard, E²LM's shards of 200,000 rows, the ELM heads over the LM zoo, and
# one-chunk shapes between the Map's L and the heads' (the narrow tiles
# against the wide ones, which set ``WIDE_MIN_L``)
ELM_SHAPES = [("unmasked", 4, 200, 192, 10, False),
              ("fractional_mask", 4, 200, 192, 10, True),
              ("ragged", 4, 137, 144, 20, True),
              ("stream_batch", 4, 32, 192, 10, False),
              ("k4_n200_l256", 4, 200, 256, 10, False),
              ("k4_n200_l384", 4, 200, 384, 10, False),
              ("k1_n512_l256", 1, 512, 256, 16, False),
              ("k1_n512_l512", 1, 512, 512, 16, False),
              ("k1_n512_l1024", 1, 512, 1024, 16, False),
              ("shard", 4, 12_500, 192, 10, False),
              ("e2lm_k1", 1, 200_000, 192, 10, False),
              ("e2lm_k2", 2, 100_000, 192, 10, False),
              ("e2lm_k4", 4, 50_000, 192, 10, False),
              ("e2lm_k8", 8, 25_000, 192, 10, False),
              ("hubert_head", 1, 4096, 1280, 6, False),
              ("lm_head", 1, 512, 4096, 16, False),
              ("rwkv6_head", 1, 512, 2560, 16, False)]
# the shipped build called with another plan, timed beside the variants
# (elm_stats: the split's chunks twice as many, half the rows, or half as
# many; a one-chunk shape through the other of the narrow and wide tiles)
CALLS = {"elm_stats": ["chunks_x2", "chunks_half", "as_wide", "as_narrow"]}
ELM_CHUNKS = {"chunks_x2": 2.0, "chunks_half": 0.5}


class ShippedCall:
    """The shipped build of a kernel under the tag of a call in ``CALLS``,
    which its cases' ``call`` reads to pick the arguments."""

    def __init__(self, fn, tag):
        self.fn, self.variant, self.legacy = fn, tag, False

    def __call__(self, *args):
        return self.fn(*args)
# (case, B, S, H, KV, hd, window, causal, bf16, q's scale): the causal
# cases of chip_smoke.py's phase kernel, hd 40 and 36, then its non-causal
# ones (window = S)
SWA_SHAPES = [("prefill_causal", 4, 128, 32, 8, 128, 128, 1, 1, 1.0),
              ("window256_s1024", 1, 1024, 32, 8, 128, 256, 1, 1, 1.0),
              ("prefill_large_scores", 4, 128, 32, 8, 128, 128, 1, 1, 8.0),
              ("zamba2_shared", 4, 128, 32, 32, 64, 128, 1, 1, 1.0),
              ("olmoe_prefill", 4, 128, 16, 16, 128, 128, 1, 1, 1.0),
              ("train4k_seq", 1, 4096, 32, 8, 128, 4096, 1, 1, 1.0),
              ("prefill_hd40", 4, 128, 32, 8, 40, 128, 1, 1, 1.0),
              # rows TMA cannot copy: the tiles by threads, 2 bytes at a
              # time
              ("prefill_hd36", 4, 128, 32, 8, 36, 128, 1, 1, 1.0),
              ("encoder_bidirectional", 4, 1024, 16, 16, 80, 1024, 0, 1, 1.0),
              ("encoder_ragged_s1000", 4, 1000, 16, 16, 80, 1000, 0, 1, 1.0),
              ("encoder_f32_small", 2, 200, 4, 2, 80, 200, 0, 0, 1.0)]


def nvcc():
    found = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(found):
        raise RuntimeError("nvcc not found")
    return found


def patched(texts, edits):
    """{file: text} with each edit applied: (pattern, replacement) to the
    first file, (file, pattern, replacement) to the file named, (file,
    pattern, replacement, n) where it must match n times, not once."""
    texts = dict(texts)
    first = next(iter(texts))
    for edit in edits:
        name, pattern, repl, want = ((first, *edit, 1) if len(edit) == 2
                                     else (*edit, 1) if len(edit) == 3
                                     else edit)
        texts[name], hits = re.subn(pattern, repl, texts[name])
        if hits != want:
            raise RuntimeError(f"{pattern!r} matched {hits} times in {name}")
    return texts


def variants_of(name, baseline, only=None):
    """[(tag, {file: source text})] of kernel ``name``: the shipped sources
    patched by each variant's edits (those tagged in ``only``, if given,
    beside the shipped ones), then the baseline directory's sources (those
    of the kernel's files it has)."""
    from repro_torch import kernels
    texts = {}
    for src_name in ENTRIES[name][0]:
        with open(kernels.CSRC / src_name) as f:
            texts[src_name] = f.read()
    out = [(tag, patched(texts, edits)) for tag, edits in VARIANTS[name]
           if only is None or tag == "shipped" or tag in only]
    if baseline:
        base = {}
        for src_name in ENTRIES[name][0]:
            path = os.path.join(baseline, src_name)
            if os.path.exists(path):
                with open(path) as f:
                    base[src_name] = f.read()
        out.append(("baseline", base))
    return out


def build_all(names, baseline, only=None):
    """{(kernel, variant): (ctypes function, ptxas lines)}, built in
    parallel."""
    from repro_torch import kernels
    out = os.path.join(ROOT, "build", "variants")
    os.makedirs(out, exist_ok=True)
    procs, texts = {}, {}
    for name in names:
        for tag, files in variants_of(name, baseline, only):
            texts[(name, tag)] = files[ENTRIES[name][0][0]]
            where = os.path.join(out, f"{name}_{tag}")
            shutil.rmtree(where, ignore_errors=True)
            os.makedirs(where)
            for src_name, text in files.items():
                with open(os.path.join(where, src_name), "w") as f:
                    f.write(text)
            cus = [os.path.join(where, n) for n in files if n.endswith(".cu")]
            so = where + ".so"
            procs[(name, tag)] = (so, subprocess.Popen(
                [nvcc(), *kernels.NVCC_FLAGS, "-shared", *cus, "-o", so],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    built = {}
    for key, (so, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {key}:\n{log}")
        _, fn_name, argtypes = ENTRIES[key[0]]
        # a baseline swa_attention or swa_attention_bwd source from before
        # its non-causal mode has no causal argument (the one after window);
        # this branch serves only such baselines, as every later source has
        # the argument
        at = {"swa_attention": 11, "swa_attention_bwd": 16}.get(key[0])
        legacy = at is not None and "int causal" not in texts[key]
        if legacy:
            argtypes = argtypes[:at] + argtypes[at + 1:]
        # a baseline elm_stats source from before the row split takes no
        # partial sums, instantiation or rows a chunk
        if key[0] == "elm_stats" and "float* part" not in texts[key]:
            legacy = True
            argtypes = argtypes[:3] + argtypes[5:10] + argtypes[-1:]
        fn = getattr(ctypes.CDLL(so), fn_name)
        fn.argtypes, fn.restype = list(argtypes), ctypes.c_int
        fn.variant, fn.legacy = key[1], legacy
        built[key] = (fn, [ln.strip() for ln in log.splitlines()
                           if "registers" in ln or "spill" in ln
                           or "serialized" in ln])
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
    """The elm_stats shapes: each build called with the plan's
    instantiation and rows a chunk (a ``chunks_`` call with its factor on
    the chunks, an ``as_`` call of a one-chunk shape with the other of the
    narrow and wide tiles; a baseline from before the row split with the
    old arguments). Held against the plain version at the 1e-5 bar, or, at
    25,000 rows or more a member, against f64 within the f32 summation
    bound (chip_smoke's ``long_sum``); U bitwise symmetric. A shape the
    plan gives one chunk must come out bitwise the shipped build's in
    every build, the baseline's included (each output one ordered sum)."""
    import torch.nn.functional as F
    from repro_torch.kernels.elm_stats import ops, ref
    cases = {}
    for case, k, n, L, C, masked in ELM_SHAPES:
        h = torch.tanh(torch.randn((k, n, L), generator=gen)).to(dev)
        t = F.one_hot(torch.randint(0, C, (k, n), generator=gen),
                      C).float().to(dev)
        m = torch.rand((k, n), generator=gen).to(dev) if masked else None
        want = ref.elm_stats_ref(h, t, m)
        long_sum = n >= 25_000
        if long_sum:
            truth = chip_smoke.f64_stats(torch, h, t, m)
            bound = 7 * n ** 0.5 * 2.0 ** -24 * chip_smoke.f64_stats(
                torch, h, t, m, True)
        out = torch.empty_like(want)
        plan = ops._plan(k, n, L, C)
        subs = ops.strip_subs(L, C)

        def split(rows, k=k, n=n, subs=subs):
            return (ops.KINDS["strip"], rows,
                    k * -(-n // rows) * ops.SUB ** 2 * subs)
        # (instantiation, rows a chunk, the workspace's floats) by call
        # tag; the shipped build and the variants take the plan's (None)
        args = {}
        if plan.chunks > 1:
            args[None] = split(plan.rows)
            for tag, f in ELM_CHUNKS.items():
                c = max(2, round(plan.chunks * f))
                args[tag] = split(-(-n // (c * ops.STAGE_ROWS))
                                  * ops.STAGE_ROWS)
        else:
            args[None] = (plan.kind, n, 0)
            other = "wide" if plan.instantiation == "narrow" else "narrow"
            args[f"as_{other}"] = (ops.KINDS[other], n, 0)
        part = torch.empty(max(e for _, _, e in args.values()), device=dev)
        hm = h if m is None else h * m[..., None]
        a = hm.transpose(1, 2).contiguous()
        b = torch.cat([h, t], dim=-1).contiguous()

        # the closure holds m itself, not its address: the mask must stay
        # alive while later cases allocate
        def call(fn, h=h, t=t, m=m, out=out, part=part, k=k, n=n, L=L, C=C,
                 args=args):
            mp = None if m is None else m.data_ptr()
            if fn.legacy:
                return launcher(fn, h.data_ptr(), t.data_ptr(), mp,
                                out.data_ptr(), k, n, L, C)
            kind, rows, elems = args.get(fn.variant, args[None])
            return launcher(fn, h.data_ptr(), t.data_ptr(), mp,
                            part.data_ptr() if elems else None, elems,
                            out.data_ptr(), k, n, L, C, kind, rows)

        def verdict(out=out, want=want, L=L, long_sum=long_sum,
                    truth=truth if long_sum else None,
                    bound=bound if long_sum else None):
            if long_sum:
                dev64 = (out.double() - truth).abs()
                ok = bool((dev64 <= bound).all())
                err = float(dev64.max())
            else:
                ok, err = close(out, want, chip_smoke.TOL)
            u = out[..., :L]
            return ok and torch.equal(u, u.transpose(1, 2)), err
        cases[case] = (call, verdict, lambda a=a, b=b: torch.matmul(a, b),
                       out)
        cases[case][1].one_pass = plan.chunks == 1
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


def _swa_operands(torch, dev, gen, B, S, heads, hd, bf16, q_scale=1.0):
    dt = torch.bfloat16 if bf16 else torch.float32
    return [(torch.randn((B, S, n, hd), generator=gen)
             * (q_scale if i == 0 else 1.0)).to(dt).to(dev)
            for i, n in enumerate(heads)]


def swa_cases(torch, dev, gen):
    import torch.nn.functional as F
    from repro_torch.kernels.swa_attention import ref
    cases = {}
    for case, B, S, H, KV, hd, W, causal, bf16, q_scale in SWA_SHAPES:
        q, k, v = _swa_operands(torch, dev, gen, B, S, (H, KV, KV), hd, bf16,
                                q_scale)
        want = ref.swa_attention_ref(q, k, v, window=W, causal=bool(causal))
        out = torch.empty_like(q)
        qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
        i = torch.arange(S, device=dev)
        mask = None if W >= S else ((i[None] <= i[:, None])
                                    & (i[:, None] - i[None] < W))

        # a legacy build (no causal argument) has no non-causal mode: None
        def call(fn, q=q, k=k, v=v, out=out, B=B, S=S, H=H, KV=KV,
                 hd=hd, W=W, causal=causal, bf16=bf16):
            if fn.legacy and not causal:
                return None
            flag = () if fn.legacy else (causal,)
            return launcher(fn, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                            out.data_ptr(), None, B, S, H, KV, hd, W,
                            *flag, hd ** -0.5, bf16)

        def verdict(out=out, want=want, bf16=bf16):
            return close(out, want,
                         chip_smoke.BF16_RTOL if bf16 else chip_smoke.TOL)

        def library(qt=qt, kt=kt, vt=vt, mask=mask, causal=causal):
            return F.scaled_dot_product_attention(
                qt, kt, vt, attn_mask=mask,
                is_causal=bool(causal) and mask is None, enable_gqa=True)
        cases[case] = (call, verdict, library, out)
    return cases


def _two_ulps(got, ref):
    """(within 2 bf16 ulps of max|ref| for every bf16 output, within
    1e-5 · max|ref| for an f32 one, max|err|) — the bars of chip_smoke.py's
    backward cases."""
    import math
    ok, worst = True, 0.0
    for g, r in zip(got, ref):
        top = float(r.float().abs().max())
        ulp = 2.0 ** (math.floor(math.log2(max(top, 1e-30))) - 7)
        bar = 2 * ulp if g.dtype.itemsize == 2 else chip_smoke.TOL * top
        err = float((g.float() - r.float()).abs().max())
        ok, worst = ok and err <= bar, max(worst, err)
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
    for case, B, S, H, KV, hd, W, causal, bf16, q_scale in SWA_SHAPES:
        if q_scale != 1.0:
            continue      # chip_smoke.py's backward cases have none
        q, k, v, do = _swa_operands(torch, dev, gen, B, S, (H, KV, KV, H),
                                    hd, bf16)
        o, lse = ops.swa_attention_fwd(q, k, v, window=W,
                                       causal=bool(causal))
        want = ref.swa_attention_bwd_ref(q, k, v, o, lse, do, window=W,
                                         causal=bool(causal))
        delta = torch.empty_like(lse)
        dq, dk, dv = (torch.empty_like(a) for a in (q, k, v))
        qt, kt, vt = (x.transpose(1, 2).contiguous().requires_grad_(True)
                      for x in (q, k, v))
        i = torch.arange(S, device=dev)
        mask = None if W >= S else ((i[None] <= i[:, None])
                                    & (i[:, None] - i[None] < W))
        y = F.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=mask,
            is_causal=bool(causal) and mask is None, enable_gqa=True)
        dot = do.transpose(1, 2).contiguous()

        def call(fn, q=q, k=k, v=v, o=o, do=do, lse=lse,
                 delta=delta, dq=dq, dk=dk, dv=dv, B=B, S=S, H=H, KV=KV,
                 hd=hd, W=W, causal=causal, bf16=bf16):
            if fn.legacy and not causal:
                return None
            flag = () if fn.legacy else (causal,)
            return launcher(fn, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                            o.data_ptr(), do.data_ptr(), lse.data_ptr(),
                            delta.data_ptr(), dq.data_ptr(), dk.data_ptr(),
                            dv.data_ptr(), B, S, H, KV, hd, W, *flag,
                            hd ** -0.5, bf16)

        def verdict(dq=dq, dk=dk, dv=dv, want=want):
            return _two_ulps((dq, dk, dv), want)

        def library(y=y, qt=qt, kt=kt, vt=vt, dot=dot):
            return torch.autograd.grad(y, (qt, kt, vt), dot,
                                       retain_graph=True)
        cases[case] = (call, verdict, library, dq, dk, dv)
    return cases


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--kernels", nargs="+", choices=sorted(VARIANTS),
                        default=sorted(VARIANTS))
    parser.add_argument("--baseline", metavar="DIR",
                        help="also build each kernel's source from DIR")
    parser.add_argument("--variants", nargs="+", metavar="TAG",
                        help="only these variants beside the shipped build "
                             "('none': the shipped build alone)")
    args = parser.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        sys.exit("kernel_variants needs a CUDA card")
    import repro_torch  # noqa: F401  (sets the TF32 flags)
    dev = torch.device("cuda")
    card = chip_smoke.card_line()
    built = build_all(args.kernels, args.baseline, args.variants)
    for name in args.kernels:
        for tag in CALLS.get(name, []):
            if args.variants is None or tag in args.variants:
                fn, ptxas = built[(name, "shipped")]
                built[(name, tag)] = (ShippedCall(fn, tag), ptxas)
    gen = torch.Generator().manual_seed(0)
    make = {"conv2d": conv_cases, "elm_stats": elm_cases,
            "swa_attention": swa_cases, "conv2d_wgrad": wgrad_cases,
            "conv2d_dgrad": dgrad_cases, "rmsnorm_bwd": rms_bwd_cases,
            "swa_attention_bwd": swa_bwd_cases}
    shapes = {name: make[name](torch, dev, gen) for name in args.kernels}
    failed = []
    for name, cases in shapes.items():
        tags = [tag for tag, _ in variants_of(name, args.baseline,
                                              args.variants)]
        tags += [tag for tag in CALLS.get(name, []) if (name, tag) in built]
        assert tags[0] == "shipped"
        recs = {tag: {"kernel": name, "variant": tag,
                      "ptxas": built[(name, tag)][1]} for tag in tags}
        for case, (call, verdict, _, *out) in cases.items():
            shipped = None
            runs = [tag for tag in tags
                    if call(built[(name, tag)][0]) is not None]
            for tag in tags:
                if tag not in runs:
                    recs[tag][case] = {"skipped": "no causal argument"}
            for tag in runs:
                # outputs filled with NaN first, so a build that leaves one
                # unwritten fails its verdict and its bits
                for o in out:
                    o.fill_(float("nan"))
                call(built[(name, tag)][0])()
                torch.cuda.synchronize()
                ok, err = verdict()
                recs[tag][case] = {"ok": ok, "max_abs_err": err, "ms": []}
                if out:
                    # the outputs' bits against the shipped source's
                    if shipped is None:
                        shipped = [o.clone() for o in out]
                    recs[tag][case]["bitwise_shipped"] = all(
                        torch.equal(o, s_) for o, s_ in zip(out, shipped))
                if not ok and not tag.startswith("probe_"):
                    failed.append((name, tag, case))
                # elm_stats: a one-chunk shape is the same bits in every
                # build (each output one ordered sum over its rows)
                if getattr(verdict, "one_pass", False) and \
                        not tag.startswith("probe_") and \
                        not recs[tag][case]["bitwise_shipped"]:
                    failed.append((name, tag, case, "bits"))
            for tag in runs + runs[::-1]:
                recs[tag][case]["ms"].append(chip_smoke.device_ms(
                    torch, call(built[(name, tag)][0])))
        for tag in tags:
            print(json.dumps(recs[tag]), flush=True)
        print(json.dumps({"kernel": name, "library_ms": {
            case: chip_smoke.device_ms(torch, lib)
            for case, (_, _, lib, *_) in cases.items()}}), flush=True)
    print(card, flush=True)
    if failed:
        sys.exit(f"variants that disagree with the plain version: {failed}")


if __name__ == "__main__":
    main()
