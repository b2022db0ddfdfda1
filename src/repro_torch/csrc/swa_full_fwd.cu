// Flash attention with GQA, f32 softmax and sums, in two modes:
//   o[b, i, h] = sum_j softmax_j(q[b, i, h] . k[b, j, h / G] * scale) v[b, j, h / G]
// - non-causal: every query sees every key j < S (the encoder's
//   bidirectional attention, the reference's `_sdpa` under an all-ones
//   mask, layers/attention.py:99-105);
// - causal: query i sees keys j <= i with i - j < window (the decoders'
//   sliding window, layers/attention.py:89-93).
// The C entry point `swa_attention_fwd` (end of file) takes every call
// and picks the kernel by dtype and mode: bf16 operands on the H100's
// warpgroup products (below), f32 on the CUDA cores (the tensor cores take
// f32 only as TF32, which the port keeps off): the causal mode in
// GQA-packed register tiles, the non-causal mode a warp a row. Scores are f32,
// scaled by hd^-0.5; the output is acc / max(l, 1e-30) with the Pallas
// kernel's guard (src/repro/kernels/swa_attention/kernel.py:60); with a
// non-null lse it also writes each row's log-sum-exp, (B, H, S) f32 in
// natural-log units, which the backward (swa_full_bwd.cu) recomputes P
// from; a null lse (the serving path) changes no other bit.
//
// Replaces: src/repro/kernels/swa_attention/kernel.py:28 `_swa_kernel`
// (pallas_call at :84); the non-causal mode drops its mask.
//
// Shapes: q, o (B, S, H, hd), k, v (B, S, KV, hd), contiguous; hd <= 128.
// Grid: (ceil(S / 128) query tiles, B * H), or in the causal mode (B * H,
// query tiles) with the last query tiles (the longest walks) first; 288
// threads: two warpgroups of 64 queries each and a producer warp.
//
// What bounds it on an H100: 4 hd FLOP a (query, key) pair inside the
// mask. HuBERT-XLarge's encoder (B 4, S 1024, H 16, hd 80) does 21.5 GFLOP
// over 42 MB, ~510 FLOP a byte, above the bf16 balance (~295): the tensor
// cores, 21.7 us at 989 TFLOP/s. A 4,096-token causal sequence of Qwen3-8B
// (B 1, H 32/8, hd 128) does 137 GFLOP over 84 MB, ~1,640 FLOP a byte:
// 0.139 ms. The LM prefill (B 4, S 128, H 32/8, hd 128) does 0.54 GFLOP
// over 10.5 MB, ~52 FLOP a byte: its bytes bound it at 3.1 us, but a
// kernel that waits on each tile's copy, product and softmax in turn runs
// at 3.3x that bound (an mma.sync kernel, since removed). So the
// products run as wgmma, the only route to the tensor-core rate, and the
// copies as TMA under them.
//
// The bf16 design (building blocks in swa_full.cuh):
// - A block owns (batch, head, 128 queries): each warpgroup's 64
//   queries are one wgmma M tile, and the two share every k and v tile
//   (HuBERT: 512 blocks). Blocks of 64 queries, two an SM, were slower
//   at every causal shape measured, the LM prefill's 128 blocks included
//   (PERF.md).
// - q arrives once; k and v tiles of 64 keys stream through kFwdStages
//   stages by TMA, issued by a producer warp of the block's own (or
//   copied by its threads where TMA cannot take the operands), so the
//   copies of later tiles run under this tile's products.
// - The causal walk: the block's key tiles run from the one holding
//   max(0, q0 - W + 1) to the one holding its last query. A warpgroup
//   walks the part its own 64 rows can see: on the diagonal warpgroup 0
//   sees one tile fewer than warpgroup 1, and at the window's start
//   warpgroup 1 may see one fewer than warpgroup 0. A tile it cannot see
//   it skips whole: it waits for the tile, releases its stage (`empty`)
//   and takes its turn without a product, so the loop that issues the
//   products stays free of branches (one wgmma under a branch serializes
//   every wgmma of the kernel: PERF.md).
// - S = Q.K^T: SS-form wgmma m64n64k16, Q and K K-major, hd/16 k-steps.
// - Masks go on S in registers after the product: the ragged tail kj >= S
//   (the TMA's zero fill would score 0 and take weight) to -1e30, and, in
//   the causal mode, pairs outside the window to -inf in the tiles that
//   hold some (the diagonal and the window's first): exp2f(-inf) is 0, and
//   a row none of whose keys a tile holds keeps its max and sum.
// - The online softmax runs on the accumulator in registers (a thread
//   holds 16 scores of each of 2 rows; a quad meets by shuffles), in log2
//   units with the IEEE exp2f, no fast math, each weight one fmaf of the
//   raw score and the exp2f; O's rescale is skipped where both of a
//   thread's rows keep their max.
// - P.V: RS-form wgmma, P from the score registers as the A operand, V
//   MN-major (the transpose bit), N = HDP in one product a k-step. P is
//   split into bf16 hi + lo and both products accumulate into the one f32
//   output: rounding P once to bf16 errs by up to 2^-9 of a weight, more
//   than a bf16 ulp of an output that cancels (the card test's
//   elementwise bar); hi (P truncated) + lo keeps 15 bits of P. That costs
//   1.5x the bound's tensor work.
// - Overlap inside a warpgroup: tile t's S product is issued together with
//   tile t-1's P.V products; the softmax of tile t waits only for the
//   first and runs while P.V of t-1 is in flight; then O is rescaled, the
//   stage of t-1 released and P of t split. Across the two warpgroups:
//   they take turns to issue their products (named barriers 1 and 2), so
//   one's softmax runs under the other's products (measured 1.5-4 %
//   faster than issuing as they come; PERF.md). Both take one turn a tile
//   of the block's walk and one more.
// - The output leaves through shared memory (each warpgroup's rows of q's
//   tile, free once its products are done) by TMA stores, which write no
//   row >= S (else by 4-byte stores, rows >= S skipped): the stores
//   themselves took ~3 us of the prefill's ~10 (PERF.md).
// - Every sum is in one fixed order: the output is the same bits run to run.
#include "swa_full.cuh"

namespace swa_full {
namespace {

constexpr int kFwdStages = 3;   // k and v stages
// Q kept in registers as S's A operand up to this head dim (beyond it the
// registers spill: 168 a thread)
constexpr int kQRegsMax = 96;
// two warpgroups and a producer warp (threads 256 ..; swa_full.cuh)
constexpr int kFwdThreads = kThreads + 32;

template <int HDP, int STAGES>
struct FwdLayout {
  static constexpr int kTile = kRows * HDP * 2;      // 64 rows
  static constexpr int kQ = 0;                       // 128 rows
  static constexpr int kK = kQ + 2 * kTile;          // [STAGES] tiles
  static constexpr int kV = kK + STAGES * kTile;     // [STAGES] tiles
  static constexpr int kBar = kV + STAGES * kTile;
  // q_full, full[STAGES], empty[STAGES]
  static constexpr int kBytes = kBar + 8 * (1 + 2 * STAGES) + 1024;
};

static_assert(FwdLayout<128, kFwdStages>::kBytes <= 232448, "smem");

struct FwdArgs {
  CUtensorMap q, k, v, o_map;
  const bf16* qp;
  const bf16* kp;
  const bf16* vp;
  bf16* o;
  float* lse;
  int S, H, KV, hd;
  int window;  // the causal mode's window (keys j <= i, i - j < window)
  float scale;
  int tma;    // copies by TMA (else the producer warp's threads)
  int tma_o;  // the output by TMA (else 4-byte or 2-byte stores)
  int pair;   // 4-byte output stores
};

template <int HDP, int STAGES, bool CAUSAL>
__global__ void __launch_bounds__(kFwdThreads, 1)
    swa_full_fwd_kernel(const __grid_constant__ FwdArgs a) {
  using L = FwdLayout<HDP, STAGES>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm = align1024(smem_raw);
  const uint32_t sa = smem_addr(sm);
  const uint32_t q_full = sa + L::kBar;
  const auto full = [&](int st) { return sa + L::kBar + 8 * (1 + st); };
  const auto empty = [&](int st) {
    return sa + L::kBar + 8 * (1 + STAGES + st);
  };
  const int wg = threadIdx.x / 128;
  const int S = a.S;
  // (batch, head) and query tile: the causal grid runs the last query
  // tiles, the longest walks, first
  const int bh = CAUSAL ? blockIdx.x : blockIdx.y;
  const int q0 = (CAUSAL ? gridDim.y - 1 - blockIdx.y : blockIdx.x) * 2 *
                 kRows;
  const int b = bh / a.H, h = bh % a.H;
  const int kvh = h / (a.H / a.KV);
  // the block's walk: key tiles kb .. kb + nkt - 1, tile i of the walk in
  // stage i % STAGES
  const int kb = CAUSAL ? max(0, q0 - a.window + 1) / kRows : 0;
  const int nkt =
      (CAUSAL ? min(q0 + 2 * kRows, S) - 1 : S - 1) / kRows - kb + 1;

  if (threadIdx.x == 0) {
    const int fill = a.tma ? 1 : 32;
    bar_init(q_full, fill);
    for (int st = 0; st < STAGES; ++st) {
      bar_init(full(st), fill);
      bar_init(empty(st), kThreads);
    }
    bar_init_fence();
  }
  __syncthreads();

  if (wg == 2) {
    // ---- the producer warp: q once, then k and v tile by tile
    const int t = threadIdx.x - kThreads;
    if (a.tma) {
      if (t == 0) {
        bar_expect(q_full, 2 * L::kTile);
        for (int w = 0; w < 2; ++w)
          tma_rows<HDP>(sa + L::kQ, 2 * kRows, w * kRows, a.q, q_full,
                        q0 + w * kRows, h, b);
        for (int i = 0; i < nkt; ++i) {
          const int st = i % STAGES, n = i / STAGES;
          if (n > 0) bar_wait(empty(st), (n - 1) & 1);
          bar_expect(full(st), 2 * L::kTile);
          tma_rows<HDP>(sa + L::kK + st * L::kTile, kRows, 0, a.k, full(st),
                        (kb + i) * kRows, kvh, b);
          tma_rows<HDP>(sa + L::kV + st * L::kTile, kRows, 0, a.v, full(st),
                        (kb + i) * kRows, kvh, b);
        }
      }
    } else {
      const long long q_stride = static_cast<long long>(a.H) * a.hd;
      const long long kv_stride = static_cast<long long>(a.KV) * a.hd;
      const bf16* qb = a.qp + static_cast<long long>(b) * S * q_stride +
                       static_cast<long long>(h) * a.hd;
      const long long kv_off = static_cast<long long>(b) * S * kv_stride +
                               static_cast<long long>(kvh) * a.hd;
      for (int w = 0; w < 2; ++w)
        copy_rows<HDP>(sm + L::kQ, 2 * kRows, w * kRows, qb, q_stride,
                       q0 + w * kRows, S, a.hd, t, 32);
      proxy_fence();
      bar_arrive(q_full);
      for (int i = 0; i < nkt; ++i) {
        const int st = i % STAGES, n = i / STAGES;
        if (n > 0) bar_wait(empty(st), (n - 1) & 1);
        copy_rows<HDP>(sm + L::kK + st * L::kTile, kRows, 0, a.kp + kv_off,
                       kv_stride, (kb + i) * kRows, S, a.hd, t, 32);
        copy_rows<HDP>(sm + L::kV + st * L::kTile, kRows, 0, a.vp + kv_off,
                       kv_stride, (kb + i) * kRows, S, a.hd, t, 32);
        proxy_fence();
        bar_arrive(full(st));
      }
    }
  } else {
    // ---- warpgroup wg: queries q0 + 64 wg .. + 63
    const int warp = (threadIdx.x % 128) / 32, lane = threadIdx.x % 32;
    const int g = lane / 4, tig = lane % 4;
    const int qi0 = q0 + wg * kRows + warp * 16 + g;  // this thread's rows
    const int qi1 = qi0 + 8;
    // scores in log2 units: p = exp2(s log2(e) - m) = exp(s - m / log2(e))
    const float scale_log2 = a.scale * 1.4426950408889634f;
    float o[HDP / 2], s[32];
    uint32_t ph[16], pl[16];  // P's fragments, hi and lo
#pragma unroll
    for (int i = 0; i < HDP / 2; ++i) o[i] = 0.0f;
    float m0 = kNegInf, m1 = kNegInf, l0 = 0.0f, l1 = 0.0f;
    float alpha0 = 0.0f, alpha1 = 0.0f;

    const uint64_t q_desc = make_desc(sa + L::kQ + wg * kRows * 32, 16);
    const uint64_t k_desc = make_desc(sa + L::kK, 16);
    const uint64_t v_desc = make_desc(sa + L::kV, kRows * 32);
    // Q's A-fragments in registers, read once from shared memory where
    // they fit (kQRegs): S = Q.K^T then reads only K from shared memory
    constexpr bool kQRegs = HDP <= kQRegsMax;
    uint32_t qf[kQRegs ? HDP / 16 : 1][4];
    // S = Q.K^T of stage st (issued, not waited for): a k-step a piece
    const auto s_product = [&](int st) {
#pragma unroll
      for (int ks = 0; ks < HDP / kPiece; ++ks) {
        const uint64_t kd = desc_at(k_desc, st * L::kTile + kRows * 32 * ks);
        if (kQRegs)
          wgmma_rs64_kmajor(s, qf[kQRegs ? ks : 0], kd, ks > 0);
        else
          wgmma_ss64(s, desc_at(q_desc, 2 * kRows * 32 * ks), kd, ks > 0);
      }
    };
    // O += P.V of stage st, P's hi then lo a k-step of 16 keys, N = HDP
    const auto pv_product = [&](int st) {
#pragma unroll
      for (int kk = 0; kk < kRows / 16; ++kk) {
        const uint64_t d = desc_at(v_desc, st * L::kTile + 16 * kk * 32);
        wgmma_rs<HDP>(o, ph + 4 * kk, d);
        wgmma_rs<HDP>(o, pl + 4 * kk, d);
      }
    };
    // the online softmax of tile kt's scores in s: p in place, the running
    // max and sum, alpha for the output's rescale. The max is taken over
    // the raw scores (scale_log2 > 0), and each p = exp2f(s scale_log2 -
    // m) is one fmaf and the IEEE exp2f; a masked score (-1e30, or -inf)
    // gives exp2f(-huge) = 0, so no select. A row whose keys the tile
    // holds none of (-inf throughout) keeps m: alpha = 1, p = 0.
    const auto softmax = [&](int kt) {
      const int k0 = kt * kRows;
      if (CAUSAL) {
        // the tile holds a key past some row of this warpgroup (the
        // diagonal) or one that some row's window has left behind; keys
        // kj >= S lie past every row < S
        const int x0 = q0 + wg * kRows;
        if (k0 + kRows - 1 > x0 || x0 + kRows - 1 - k0 >= a.window) {
          const float out = __uint_as_float(0xff800000u);  // -inf
#pragma unroll
          for (int n = 0; n < 8; ++n)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int kj = k0 + n * 8 + 2 * tig + e;
              if (kj > qi0 || qi0 - kj >= a.window) s[4 * n + e] = out;
              if (kj > qi1 || qi1 - kj >= a.window) s[4 * n + 2 + e] = out;
            }
        }
      } else if (k0 + kRows > S) {
#pragma unroll
        for (int n = 0; n < 8; ++n)
#pragma unroll
          for (int e = 0; e < 2; ++e)
            if (k0 + n * 8 + 2 * tig + e >= S) {
              s[4 * n + e] = kNegInf;
              s[4 * n + 2 + e] = kNegInf;
            }
      }
      float mx0 = kNegInf, mx1 = kNegInf;
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        mx0 = fmaxf(mx0, fmaxf(s[4 * n], s[4 * n + 1]));
        mx1 = fmaxf(mx1, fmaxf(s[4 * n + 2], s[4 * n + 3]));
      }
      const float mn0 = fmaxf(m0, quad_max(mx0) * scale_log2);
      const float mn1 = fmaxf(m1, quad_max(mx1) * scale_log2);
      alpha0 = exp2f(m0 - mn0);
      alpha1 = exp2f(m1 - mn1);
      float ps0 = 0.0f, ps1 = 0.0f;
#pragma unroll
      for (int n = 0; n < 8; ++n) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float p0 = exp2f(fmaf(s[4 * n + e], scale_log2, -mn0));
          const float p1 = exp2f(fmaf(s[4 * n + 2 + e], scale_log2, -mn1));
          s[4 * n + e] = p0;
          s[4 * n + 2 + e] = p1;
          ps0 += p0;
          ps1 += p1;
        }
      }
      l0 = l0 * alpha0 + quad_sum(ps0);
      l1 = l1 * alpha1 + quad_sum(ps1);
      m0 = mn0;
      m1 = mn1;
    };
    // O *= alpha, skipped where both of the thread's rows keep their max
    // (alpha == 1: the product would be O itself)
    const auto rescale = [&]() {
      if (alpha0 == 1.0f && alpha1 == 1.0f) return;
#pragma unroll
      for (int i = 0; i < HDP / 8; ++i) {
        o[4 * i] *= alpha0;
        o[4 * i + 1] *= alpha0;
        o[4 * i + 2] *= alpha1;
        o[4 * i + 3] *= alpha1;
      }
    };

    // the turns: warpgroup wg issues after named barrier 1 + wg, then
    // lets the other go; warpgroup 0 goes first, and the last turn of all
    // (warpgroup 1's final one) passes to nobody
    const auto my_turn = [&]() { named_sync(1 + wg, kThreads); };
    const auto their_turn = [&](bool last) {
      if (!(last && wg == 1)) named_arrive(2 - wg, kThreads);
    };
    if (wg == 1) named_arrive(1, kThreads);

    // this warpgroup's part of the walk: tiles i0 .. i1 (the causal mode:
    // those its rows, clamped to S - 1, can see; i0 <= 1 and i1 >= nkt - 2)
    int i0 = 0, i1 = nkt - 1;
    if (CAUSAL) {
      const int r0 = min(q0 + wg * kRows, S - 1);
      const int r1 = min(q0 + wg * kRows + kRows - 1, S - 1);
      i0 = max(0, r0 - a.window + 1) / kRows - kb;
      i1 = r1 / kRows - kb;
    }
    // a tile of the walk this warpgroup cannot see: wait until it is in
    // its stage, release the stage, and take the turn without a product
    const auto skip = [&](int i, bool last) {
      bar_wait(full(i % STAGES), (i / STAGES) & 1);
      bar_arrive(empty(i % STAGES));
      my_turn();
      their_turn(last);
    };
    for (int i = 0; i < i0; ++i) skip(i, false);

    bar_wait(q_full, 0);
    if (kQRegs) {
      // rows g, g + 8 of this warp's 16, columns 2 tig (+ 8) of each
      // k-step: the A-fragment layout
      const int r0 = wg * kRows + warp * 16 + g;
#pragma unroll
      for (int ks = 0; ks < (kQRegs ? HDP / 16 : 0); ++ks)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          qf[kQRegs ? ks : 0][j] = *reinterpret_cast<const uint32_t*>(
              sm + L::kQ +
              tile_offset(2 * kRows, r0 + 8 * (j % 2), 16 * ks + 2 * tig +
                                                       8 * (j / 2)));
    }
    bar_wait(full(i0 % STAGES), (i0 / STAGES) & 1);
    my_turn();
    wgmma_fence();
    s_product(i0 % STAGES);
    wgmma_commit();
    their_turn(false);
    wgmma_wait<0>();
    fence_regs(s);
    softmax(kb + i0);
    split_acc(s, ph, pl);
    for (int i = i0 + 1; i <= i1; ++i) {
      const int st = i % STAGES, prev = (i - 1) % STAGES;
      bar_wait(full(st), (i / STAGES) & 1);
      fence_regs(o);
      fence_regs(ph);
      fence_regs(pl);
      my_turn();
      wgmma_fence();
      s_product(st);
      wgmma_commit();
      pv_product(prev);
      wgmma_commit();
      their_turn(false);
      wgmma_wait<1>();  // S of tile i
      fence_regs(s);
      softmax(kb + i);
      wgmma_wait<0>();  // P.V of tile i - 1
      fence_regs(o);
      fence_regs(ph);
      fence_regs(pl);
      bar_arrive(empty(prev));
      rescale();
      split_acc(s, ph, pl);
    }
    fence_regs(o);
    fence_regs(ph);
    fence_regs(pl);
    my_turn();
    wgmma_fence();
    pv_product(i1 % STAGES);
    wgmma_commit();
    their_turn(i1 == nkt - 1);
    wgmma_wait<0>();
    fence_regs(o);
    for (int i = i1 + 1; i < nkt; ++i) skip(i, i == nkt - 1);

    const float inv0 = 1.0f / fmaxf(l0, 1e-30f);
    const float inv1 = 1.0f / fmaxf(l1, 1e-30f);
    if (a.lse != nullptr && tig == 0) {
      // m is in log2 units: lse = m ln 2 + log(l); a quad shares m and l
      float* lse_bh = a.lse + static_cast<long long>(bh) * S;
      if (qi0 < S)
        lse_bh[qi0] = m0 * 0.6931471805599453f + logf(fmaxf(l0, 1e-30f));
      if (qi1 < S)
        lse_bh[qi1] = m1 * 0.6931471805599453f + logf(fmaxf(l1, 1e-30f));
    }
    if (a.tma_o) {
      // O through this warpgroup's 64 rows of q's tile (which only its
      // own products, all done, read), then out by TMA
      const int r = wg * kRows + warp * 16 + g;
#pragma unroll
      for (int i = 0; i < HDP / 8; ++i) {
        const int c = 8 * i + 2 * tig;
        put_pair(sm + L::kQ, 2 * kRows, r, c, o[4 * i] * inv0,
                 o[4 * i + 1] * inv0);
        put_pair(sm + L::kQ, 2 * kRows, r + 8, c, o[4 * i + 2] * inv1,
                 o[4 * i + 3] * inv1);
      }
      proxy_fence();
      named_sync(3 + wg, 128);
      if (threadIdx.x % 128 == 0) {
        tma_store_rows<HDP>(sa + L::kQ, 2 * kRows, wg * kRows, a.o_map,
                            q0 + wg * kRows, h, b);
        tma_store_wait();
      }
      return;
    }
    const long long q_stride = static_cast<long long>(a.H) * a.hd;
    bf16* ob = a.o + static_cast<long long>(b) * S * q_stride +
               static_cast<long long>(h) * a.hd;
    const bool pair = a.pair != 0;
#pragma unroll
    for (int i = 0; i < HDP / 8; ++i) {
      const int c = 8 * i + 2 * tig;
      if (qi0 < S)
        store_pair(ob + qi0 * q_stride, c, a.hd, o[4 * i] * inv0,
                   o[4 * i + 1] * inv0, pair);
      if (qi1 < S)
        store_pair(ob + qi1 * q_stride, c, a.hd, o[4 * i + 2] * inv1,
                   o[4 * i + 3] * inv1, pair);
    }
  }
}

template <int HDP, bool CAUSAL>
int launch_fwd(const void* q, const void* k, const void* v, void* o,
               float* lse, int B, int S, int H, int KV, int hd, int window,
               float scale, cudaStream_t stream) {
  FwdArgs a;
  a.qp = static_cast<const bf16*>(q);
  a.kp = static_cast<const bf16*>(k);
  a.vp = static_cast<const bf16*>(v);
  a.o = static_cast<bf16*>(o);
  a.lse = lse;
  a.S = S;
  a.H = H;
  a.KV = KV;
  a.hd = hd;
  a.window = window;
  a.scale = scale;
  a.tma = hd % 8 == 0 && aligned16(q) && aligned16(k) && aligned16(v);
  a.pair = hd % 2 == 0 && reinterpret_cast<uintptr_t>(o) % 4 == 0;
  a.tma_o = a.tma && aligned16(o);
  if (a.tma && !(make_map(&a.q, q, B, S, H, hd) &&
                 make_map(&a.k, k, B, S, KV, hd) &&
                 make_map(&a.v, v, B, S, KV, hd)))
    return static_cast<int>(cudaErrorNotSupported);
  if (a.tma_o && !make_map(&a.o_map, o, B, S, H, hd))
    return static_cast<int>(cudaErrorNotSupported);
  using L = FwdLayout<HDP, kFwdStages>;
  const auto kernel = swa_full_fwd_kernel<HDP, kFwdStages, CAUSAL>;
  static unsigned attr_set = 0;
  const cudaError_t err = smem_attr_once(kernel, L::kBytes, attr_set);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int tiles = (S + 2 * kRows - 1) / (2 * kRows);
  const dim3 grid = CAUSAL ? dim3(B * H, tiles) : dim3(tiles, B * H);
  kernel<<<grid, kFwdThreads, L::kBytes, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// f32, the causal mode: CUDA cores, GQA-packed register tiles
// (swa_full.cuh; the non-causal mode takes the warp-a-row kernel below,
// faster there: PERF.md). A block owns R packed rows of one (batch, kv head)
// (R 64, 32 or 16: the rule below), R / G queries of each of the group's G
// heads, and walks the key tiles they see, CK keys a tile: from the one
// holding max(0, i0 - W + 1) (i0 its first query) to its last query's. The
// query tile arrives with the first
// key tile; each next k and v tile is copied by cp.async into the other of two
// stages while this one is computed. 128 threads: thread (tr, tc) scores rows
// tr + TR i (i < TM) against keys tc + TC j (j < 4) of the tile (TC = CK / 4
// lanes a row, neighbours in one warp, which meet by shuffles for the rows'
// running max and sum), then adds the tile's P.V into its rows' output chunks
// tc + TC u (16-byte column groups), P passing through shared memory within
// the warp.
// The tiles:
// - CK 16 up to S 16 (the whole sequence of the parity path's B2 S16),
//   TR 32 rows a tile of keys, else CK 32, TR 16;
// - TM rows a thread, R = TR TM a block: R 64 (TM 2 or 4, scores 2 x 4 or
//   4 x 4 a thread, 64 output floats at hd 128) where that grid has a
//   block for every SM, else R 32, else the smallest R (1 x 4 scores a
//   thread): a grid too small to fill the card waits on each thread's
//   chain of products, which fewer rows a thread shorten. (The rule fixed
//   before the first card reading took R 64 at every shape; B2 S16 H32/8
//   then ran 16 blocks, 0.0085 ms against 0.0066 at R 32: PERF.md.)
// What bounds it: 4 hd FLOP a pair inside the mask at the f32 CUDA-core
// rate (67 TFLOP/s): at B4 S128 H32/8 (0.54 GFLOP) 8.1 us; at B2 S16 its
// bytes (0.4 us), below a launch's latency.
// The footprint (q, two stages of k and v, P) is at most 110 KB at hd
// 128, so two or more blocks share an SM. The grid: a block per (batch,
// kv head, R rows), the last rows (the longest causal walks) first: B2
// S16 H32/8 runs 32 blocks of one step, B4 S128 H32/8 256 of 1-4 steps.
// Staging advances (query, head) cursors, with no division a row
// (F32Cursor, swa_full.cuh); the P.V loop clamps a chunk past the row
// instead of branching; the output is scaled by 1 / max(l, 1e-30).
// (It replaces the first causal kernel, 64-query x 64-key tiles of one head
// at 113 KB a block: at S 16 48 of each tile's 64 rows and keys were
// padding, the G heads of a group staged the same k and v tile G times,
// and each tile's copy waited on a barrier before its products: PERF.md.)
// ---------------------------------------------------------------------------

struct F32FwdArgs {
  const float* q;
  const float* k;
  const float* v;
  float* o;
  float* lse;
  int B, S, H, KV, hd, window;
  float scale;
  int vec;  // 16-byte copies and stores
};

template <int TM, int CK>
struct F32Fwd {
  static constexpr int kTC = CK / 4;               // lanes a row
  static constexpr int kTR = kF32Threads / kTC;    // row groups
  static constexpr int kR = kTR * TM;              // rows a block
  static constexpr int kNCH = kF32Chunks / kTC;    // output chunks a thread
  // bytes of shared memory at row pitch P: q, two stages of k and v, P
  static int bytes(int P) {
    return 4 * (kR * P + 4 * CK * P + kR * (CK + 1));
  }
};

template <int TM, int CK>
__global__ void __launch_bounds__(kF32Threads)
    f32_fwd_kernel(const F32FwdArgs a) {
  using L = F32Fwd<TM, CK>;
  constexpr int TC = L::kTC, TR = L::kTR, R = L::kR, NCH = L::kNCH;
  extern __shared__ float fsm[];
  const int P = f32_pitch(a.hd);
  float* q_s = fsm;                  // R x P
  float* kv_s = q_s + R * P;         // stage st: k at st 2 CK P, v CK P on
  float* p_s = kv_s + 4 * CK * P;    // R x (CK + 1)
  const int S = a.S, G = a.H / a.KV, n = S * G;
  const bool vec = a.vec != 0;
  const int nbkv = a.B * a.KV;
  const int bkv = blockIdx.x % nbkv;
  const int p0 = ((n + R - 1) / R - 1 - static_cast<int>(blockIdx.x / nbkv)) *
                 R;
  const int b = bkv / a.KV, kvh = bkv % a.KV;
  const F32Rows qrows = f32_rows(b, S, a.H, a.hd, kvh * G, G);
  const F32Rows krows = f32_rows(b, S, a.KV, a.hd, kvh, 1);
  // the keys the block's queries i0 .. i1 see
  const int i0 = p0 / G, i1 = (min(p0 + R, n) - 1) / G;
  const int kbeg = max(0, i0 - a.window + 1), kend = i1 + 1;
  const int steps = (kend - kbeg + CK - 1) / CK;

  const uint32_t skv = smem_addr(kv_s);
  const auto stage = [&](int it) {
    const uint32_t st = skv + 4 * ((it & 1) * 2 * CK * P);
    f32_stage<CK, kF32Threads>(st, a.k, krows, kbeg + it * CK, P, vec);
    f32_stage<CK, kF32Threads>(st + 4 * CK * P, a.v, krows, kbeg + it * CK,
                               P, vec);
  };
  f32_stage<R, kF32Threads>(smem_addr(q_s), a.q, qrows, p0, P, vec);
  stage(0);
  cp_async_commit();

  const int tc = threadIdx.x % TC, tr = threadIdx.x / TC;
  const int nch = (a.hd + 3) / 4, hd4 = 4 * nch;
  // this thread's output chunks tc + TC u, clamped to the row: a chunk
  // past it repeats the last one's products and is never stored, so the
  // product loop has no branch
  int chs[NCH];
#pragma unroll
  for (int u = 0; u < NCH; ++u) chs[u] = min(tc + TC * u, nch - 1);
  int qi[TM];
  bool live[TM];
  float m[TM], l[TM];
  float4 acc[TM][NCH];
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int p = p0 + tr + TR * i;
    live[i] = p < n;
    qi[i] = p / G;
    m[i] = kNegInf;
    l[i] = 0.0f;
#pragma unroll
    for (int u = 0; u < NCH; ++u) acc[i][u] = make_float4(0.f, 0.f, 0.f, 0.f);
  }

  for (int it = 0; it < steps; ++it) {
    if (it + 1 < steps) {
      stage(it + 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // tile it (and q) is in every thread's view
    const float* k_s = kv_s + (it & 1) * 2 * CK * P;
    const float* v_s = k_s + CK * P;
    const int k0 = kbeg + it * CK;

    float s[TM][4];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.0f;
#pragma unroll 2
    for (int d = 0; d < hd4; d += 4) {
      float4 qa[TM], kb[4];
#pragma unroll
      for (int i = 0; i < TM; ++i) qa[i] = ld4(q_s + (tr + TR * i) * P + d);
#pragma unroll
      for (int j = 0; j < 4; ++j) kb[j] = ld4(k_s + (tc + TC * j) * P + d);
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = dot4(qa[i], kb[j], s[i][j]);
    }

    // the online softmax: masked scores -1e30 and weight exactly 0; a
    // row's TC lanes meet by shuffles (xor 1 .. TC / 2) in a fixed order
    float alpha[TM];
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kj = k0 + tc + TC * j;
        const bool in = live[i] && kj < S &&
                        f32_sees(qi[i], kj, S, a.window, true);
        s[i][j] = in ? s[i][j] * a.scale : kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 1; off < TC; off *= 2)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float mn = fmaxf(m[i], mx);
      alpha[i] = expf(m[i] - mn);
      float ps = 0.0f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float pj = s[i][j] > kNegInf ? expf(s[i][j] - mn) : 0.0f;
        p_s[(tr + TR * i) * (CK + 1) + tc + TC * j] = pj;
        ps += pj;
      }
#pragma unroll
      for (int off = 1; off < TC; off *= 2)
        ps += __shfl_xor_sync(0xffffffffu, ps, off);
      l[i] = l[i] * alpha[i] + ps;
      m[i] = mn;
    }
    __syncwarp();  // a row's P is written and read by its TC lanes

#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int u = 0; u < NCH; ++u) acc[i][u] = scale4(acc[i][u], alpha[i]);
    const int keys = min(CK, kend - k0);  // keys past the walk weigh 0
    for (int c = 0; c < keys; ++c) {
      float pv[TM];
#pragma unroll
      for (int i = 0; i < TM; ++i) pv[i] = p_s[(tr + TR * i) * (CK + 1) + c];
#pragma unroll
      for (int u = 0; u < NCH; ++u) {
        const float4 vb = ld4(v_s + c * P + 4 * chs[u]);
#pragma unroll
        for (int i = 0; i < TM; ++i) axpy4(pv[i], vb, acc[i][u]);
      }
    }
    __syncthreads();  // this stage and P are read: the next copy may land
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int p = p0 + tr + TR * i;
    if (p >= n) continue;
    const float ls = fmaxf(l[i], 1e-30f), inv = 1.0f / ls;
    float* orow = a.o + qrows.off(p);
#pragma unroll
    for (int u = 0; u < NCH; ++u)
      if (tc + TC * u < nch)
        f32_put(orow, tc + TC * u, a.hd, scale4(acc[i][u], inv), vec);
    if (a.lse != nullptr && tc == 0)
      a.lse[(static_cast<long long>(b) * a.H + kvh * G + p % G) * S + p / G] =
          m[i] + logf(ls);
  }
}

template <int TM, int CK>
int launch_f32_fwd(const F32FwdArgs& a, int dev, cudaStream_t stream) {
  using L = F32Fwd<TM, CK>;
  static unsigned attr_set = 0;
  const auto kernel = f32_fwd_kernel<TM, CK>;
  const cudaError_t err =
      smem_attr_once(kernel, L::bytes(f32_pitch(128)), attr_set, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long n = static_cast<long long>(a.S) * (a.H / a.KV);
  const long long blocks =
      static_cast<long long>(a.B) * a.KV * ((n + L::kR - 1) / L::kR);
  if (n > 2147483647LL || blocks > 2147483647LL)
    return static_cast<int>(cudaErrorInvalidValue);
  kernel<<<static_cast<unsigned>(blocks), kF32Threads,
           L::bytes(f32_pitch(a.hd)), stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

int launch_f32(const void* q, const void* k, const void* v, void* o,
               float* lse, int B, int S, int H, int KV, int hd, int window,
               float scale, cudaStream_t stream) {
  F32FwdArgs a;
  a.q = static_cast<const float*>(q);
  a.k = static_cast<const float*>(k);
  a.v = static_cast<const float*>(v);
  a.o = static_cast<float*>(o);
  a.lse = lse;
  a.B = B;
  a.S = S;
  a.H = H;
  a.KV = KV;
  a.hd = hd;
  a.window = window;
  a.scale = scale;
  a.vec = hd % 4 == 0 && aligned16(q) && aligned16(k) && aligned16(v) &&
          aligned16(o);
  // the tiles: 16 keys up to S 16, else 32; 64 rows a block where that
  // grid has a block for every SM, else 32, else 16 (fewer rows a thread:
  // a shorter chain of products on a grid that leaves SMs idle)
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = sm_count(dev, sms);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long n = static_cast<long long>(S) * (H / KV);
  const auto fills = [&](int rows) {
    return static_cast<long long>(B) * KV * ((n + rows - 1) / rows) >= sms;
  };
  if (S <= 16)
    return fills(64) ? launch_f32_fwd<2, 16>(a, dev, stream)
                     : launch_f32_fwd<1, 16>(a, dev, stream);
  return fills(64)   ? launch_f32_fwd<4, 32>(a, dev, stream)
         : fills(32) ? launch_f32_fwd<2, 32>(a, dev, stream)
                     : launch_f32_fwd<1, 32>(a, dev, stream);
}

// ---------------------------------------------------------------------------
// f32, the non-causal mode: CUDA cores, a warp a query row (the tensor
// cores take f32 only as TF32, which the port keeps off). A
// block's 8 warps share 32-key tiles of k and v staged in shared memory,
// the next tile loaded into registers while this one is computed; a lane
// scores one key of a tile (four fmaf chains over hd), the warp meets by
// shuffles for the row's max and sum, then each lane adds the tile's 32
// p v terms, in key order, into its output columns lane + 32 u. The grid
// has a block per 8 rows (B 2, S 200, H 4: 200 blocks, against 32 of the
// 64-row tiles this replaced, which left most of the 132 SMs idle and
// waited on each row's loads to stage a tile: PERF.md).
// ---------------------------------------------------------------------------

constexpr int kRowWarps = 8;    // rows a block
constexpr int kRowTile = 32;    // keys (dQ) or queries (dK/dV) a tile
constexpr int kRowCols = 4;     // output columns a lane: hd <= 128

// the staged tiles' row pitch: odd, so 32 lanes reading 32 rows at one
// column hit 32 banks
__host__ __device__ inline int row_pitch(int hd) { return hd | 1; }

__device__ __forceinline__ float warp_sum(float v) {
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// rows row0 .. row0 + 31 of a (S, stride) f32 operand in registers, on
// their way to a tile in shared memory: warp w holds rows w + kRowWarps i,
// a lane columns lane + 32 u. Every load of a tile is issued before the
// first is used, and a walk loads its next tile before it computes on
// this one: one memory latency a tile, hidden under the tile before
struct RowTile {
  float x[kRowTile / kRowWarps][kRowCols];
};

// rows >= S are zeros
__device__ __forceinline__ void row_load(RowTile& t, const float* src,
                                         long long stride, int row0, int S,
                                         int hd) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
#pragma unroll
  for (int i = 0; i < kRowTile / kRowWarps; ++i) {
    const int gr = row0 + warp + kRowWarps * i;
#pragma unroll
    for (int u = 0; u < kRowCols; ++u) {
      const int c = lane + 32 * u;
      t.x[i][u] = gr < S && c < hd ? src[gr * stride + c] : 0.0f;
    }
  }
}

// -> a tile of pitch row_pitch(hd)
__device__ __forceinline__ void row_store(float* dst, const RowTile& t,
                                          int hd) {
  const int pitch = row_pitch(hd);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
#pragma unroll
  for (int i = 0; i < kRowTile / kRowWarps; ++i) {
    const int r = warp + kRowWarps * i;
#pragma unroll
    for (int u = 0; u < kRowCols; ++u) {
      const int c = lane + 32 * u;
      if (c < hd) dst[r * pitch + c] = t.x[i][u];
    }
  }
}

// a . b over hd (a row of the warp's own, b a staged row): four fmaf
// chains over d mod 4, added in a fixed order
__device__ __forceinline__ float row_dot(const float* a, const float* b,
                                         int hd) {
  float s0 = 0.0f, s1 = 0.0f, s2 = 0.0f, s3 = 0.0f;
  int d = 0;
  for (; d + 3 < hd; d += 4) {
    s0 = fmaf(a[d], b[d], s0);
    s1 = fmaf(a[d + 1], b[d + 1], s1);
    s2 = fmaf(a[d + 2], b[d + 2], s2);
    s3 = fmaf(a[d + 3], b[d + 3], s3);
  }
  for (; d < hd; ++d) s0 = fmaf(a[d], b[d], s0);
  return (s0 + s1) + (s2 + s3);
}

__device__ __forceinline__ float warp_max(float v) {
  for (int off = 16; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

__global__ void __launch_bounds__(32 * kRowWarps)
    rows_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                   const float* __restrict__ v, float* __restrict__ o,
                   float* __restrict__ lse, int S, int H, int KV, int hd,
                   float scale) {
  extern __shared__ float fsm[];
  const int pitch = row_pitch(hd);
  float* k_s = fsm;                       // [32][pitch]
  float* v_s = k_s + kRowTile * pitch;    // [32][pitch]
  float* qr = v_s + kRowTile * pitch + (threadIdx.x / 32) * hd;
  const int lane = threadIdx.x % 32;
  const int b = blockIdx.y / H, h = blockIdx.y % H;
  const int kvh = h / (H / KV);
  const int qi = blockIdx.x * kRowWarps + threadIdx.x / 32;
  const long long q_stride = static_cast<long long>(H) * hd;
  const long long kv_stride = static_cast<long long>(KV) * hd;
  const long long q_off = static_cast<long long>(b) * S * q_stride +
                          static_cast<long long>(h) * hd;
  const long long kv_off = static_cast<long long>(b) * S * kv_stride +
                           static_cast<long long>(kvh) * hd;
  for (int c = lane; c < hd; c += 32)
    qr[c] = qi < S ? q[q_off + qi * q_stride + c] : 0.0f;
  float m = kNegInf, l = 0.0f;
  float acc[kRowCols];
#pragma unroll
  for (int u = 0; u < kRowCols; ++u) acc[u] = 0.0f;

  RowTile nk, nv;  // the next tile of k and v
  row_load(nk, k + kv_off, kv_stride, 0, S, hd);
  row_load(nv, v + kv_off, kv_stride, 0, S, hd);
  for (int k0 = 0; k0 < S; k0 += kRowTile) {
    __syncthreads();  // the last tile is read (and the rows are in)
    row_store(k_s, nk, hd);
    row_store(v_s, nv, hd);
    __syncthreads();
    if (k0 + kRowTile < S) {
      row_load(nk, k + kv_off, kv_stride, k0 + kRowTile, S, hd);
      row_load(nv, v + kv_off, kv_stride, k0 + kRowTile, S, hd);
    }
    const float dot = row_dot(qr, k_s + lane * pitch, hd);
    const float s = k0 + lane < S ? dot * scale : kNegInf;
    const float m_new = fmaxf(m, warp_max(s));
    const float alpha = expf(m - m_new);
    const float p = s > kNegInf ? expf(s - m_new) : 0.0f;
    l = l * alpha + warp_sum(p);
    m = m_new;
#pragma unroll
    for (int u = 0; u < kRowCols; ++u) acc[u] *= alpha;
    for (int j = 0; j < kRowTile; ++j) {
      const float pj = __shfl_sync(0xffffffffu, p, j);
#pragma unroll
      for (int u = 0; u < kRowCols; ++u) {
        const int c = lane + 32 * u;
        if (c < hd) acc[u] = fmaf(pj, v_s[j * pitch + c], acc[u]);
      }
    }
  }
  if (qi < S) {
    const float l_safe = fmaxf(l, 1e-30f);
#pragma unroll
    for (int u = 0; u < kRowCols; ++u) {
      const int c = lane + 32 * u;
      if (c < hd) o[q_off + qi * q_stride + c] = acc[u] / l_safe;
    }
    if (lse != nullptr && lane == 0)
      lse[static_cast<long long>(blockIdx.y) * S + qi] = m + logf(l_safe);
  }
}

int launch_rows(const void* q, const void* k, const void* v, void* o,
                float* lse, int B, int S, int H, int KV, int hd, float scale,
                cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * (2 * kRowTile * row_pitch(hd) + kRowWarps * hd);
  static unsigned attr_set = 0;
  const cudaError_t err = smem_attr_once(
      rows_fwd_kernel,
      static_cast<int>(sizeof(float) *
                       (2 * kRowTile * row_pitch(128) + kRowWarps * 128)),
      attr_set);
  if (err != cudaSuccess) return static_cast<int>(err);
  rows_fwd_kernel<<<dim3((S + kRowWarps - 1) / kRowWarps, B * H),
                   32 * kRowWarps, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), lse, S, H, KV, hd,
      scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace swa_full

// The forward's C entry point, every call (kernels/__init__.py).
// q, k, v, o: (B, S, H or KV, hd), contiguous; lse: (B, H, S) f32
// log-sum-exp of each row's scaled scores, or null. causal: 1 = the
// causal sliding window, 0 = every key (window unused). bf16: 0 =
// float32 operands (the CUDA cores: packed tiles causal, a warp a row
// non-causal), 1 = bfloat16 (the tensor cores).
extern "C" int swa_attention_fwd(const void* q, const void* k, const void* v,
                                 void* o, void* lse, int B, int S, int H,
                                 int KV, int hd, int window, int causal,
                                 float scale, int bf16, void* stream) {
  using namespace swa_full;
  if (hd < 1 || hd > 128 || KV < 1 || H % KV != 0 || window < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* lse_f = static_cast<float*>(lse);
  if (!bf16)
    return causal ? launch_f32(q, k, v, o, lse_f, B, S, H, KV, hd, window,
                               scale, s)
                  : launch_rows(q, k, v, o, lse_f, B, S, H, KV, hd, scale, s);
  using Launch = int (*)(const void*, const void*, const void*, void*, float*,
                         int, int, int, int, int, int, float, cudaStream_t);
  constexpr Launch by_hdp[2][8] = {
      {launch_fwd<16, false>, launch_fwd<32, false>, launch_fwd<48, false>,
       launch_fwd<64, false>, launch_fwd<80, false>, launch_fwd<96, false>,
       launch_fwd<112, false>, launch_fwd<128, false>},
      {launch_fwd<16, true>, launch_fwd<32, true>, launch_fwd<48, true>,
       launch_fwd<64, true>, launch_fwd<80, true>, launch_fwd<96, true>,
       launch_fwd<112, true>, launch_fwd<128, true>}};
  return by_hdp[causal ? 1 : 0][(hd + 15) / 16 - 1](
      q, k, v, o, lse_f, B, S, H, KV, hd, window, scale, s);
}
