// Non-causal flash attention (every query sees every key j < S) with GQA,
// bf16 operands, f32 softmax and sums, on the H100's warpgroup products:
//   o[b, i, h] = sum_j softmax_j(q[b, i, h] . k[b, j, h / G] * scale) v[b, j, h / G]
// The encoder's bidirectional attention (the reference's `_sdpa` under an
// all-ones mask, layers/attention.py:99-105); swa_attention.cu's entry point
// `swa_attention_fwd` sends its bf16 non-causal calls here. Scores are f32,
// scaled by hd^-0.5 and masked to -1e30 past S; the output is
// acc / max(l, 1e-30) with the Pallas kernel's guard
// (src/repro/kernels/swa_attention/kernel.py:60); with a non-null lse it
// also writes each row's log-sum-exp, (B, H, S) f32 in natural-log units,
// which the backward (swa_full_bwd.cu) recomputes P from.
//
// Replaces, for the non-causal mode: src/repro/kernels/swa_attention/
// kernel.py:28 `_swa_kernel` (pallas_call at :84), whose mask it drops.
//
// Shapes: q, o (B, S, H, hd), k, v (B, S, KV, hd), contiguous; hd <= 128.
// Grid (ceil(S / 128) query tiles, B * H); 288 threads: two warpgroups of
// 64 queries each and a producer warp.
//
// What bounds it on an H100: 4 hd FLOP a (query, key) pair; HuBERT-XLarge's
// encoder (B 4, S 1024, H 16, hd 80) does 21.5 GFLOP over 42 MB, ~510 FLOP
// a byte, above the bf16 balance (~295): the tensor cores, 21.7 us at 989
// TFLOP/s. So the products run as wgmma, the only route to that rate.
//
// Design (building blocks in swa_full.cuh):
// - A block owns (batch, head, 128 queries): each warpgroup's 64
//   queries are one wgmma M tile, and the two share every k and v tile
//   (HuBERT: 512 blocks).
// - q arrives once; k and v tiles of 64 keys stream through kFwdStages
//   stages by TMA, issued by a producer warp of the block's own (or
//   copied by its threads where TMA cannot take the operands), so the
//   copies of later tiles run under this tile's products.
// - S = Q.K^T: SS-form wgmma m64n64k16, Q and K K-major, hd/16 k-steps.
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
//   faster than issuing as they come; PERF.md).
// - The ragged tail kj >= S of the last tile is masked to -1e30 (the TMA's
//   zero fill would score 0 and take weight); rows >= S are never written.
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
  CUtensorMap q, k, v;
  const bf16* qp;
  const bf16* kp;
  const bf16* vp;
  bf16* o;
  float* lse;
  int S, H, KV, hd;
  float scale;
  int tma;    // copies by TMA (else the producer warp's threads)
  int pair;   // 4-byte output stores
};

template <int HDP, int STAGES>
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
  const int q0 = blockIdx.x * 2 * kRows;
  const int b = blockIdx.y / a.H, h = blockIdx.y % a.H;
  const int kvh = h / (a.H / a.KV);
  const int nkt = (S + kRows - 1) / kRows;

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
        tma_rows<HDP>(sa + L::kQ, 2 * kRows, 0, a.q, q_full, q0, h, b);
        tma_rows<HDP>(sa + L::kQ, 2 * kRows, kRows, a.q, q_full, q0 + kRows,
                      h, b);
        for (int kt = 0; kt < nkt; ++kt) {
          const int st = kt % STAGES, n = kt / STAGES;
          if (n > 0) bar_wait(empty(st), (n - 1) & 1);
          bar_expect(full(st), 2 * L::kTile);
          tma_rows<HDP>(sa + L::kK + st * L::kTile, kRows, 0, a.k, full(st),
                        kt * kRows, kvh, b);
          tma_rows<HDP>(sa + L::kV + st * L::kTile, kRows, 0, a.v, full(st),
                        kt * kRows, kvh, b);
        }
      }
    } else {
      const long long q_stride = static_cast<long long>(a.H) * a.hd;
      const long long kv_stride = static_cast<long long>(a.KV) * a.hd;
      const bf16* qb = a.qp + static_cast<long long>(b) * S * q_stride +
                       static_cast<long long>(h) * a.hd;
      const long long kv_off = static_cast<long long>(b) * S * kv_stride +
                               static_cast<long long>(kvh) * a.hd;
      copy_rows<HDP>(sm + L::kQ, 2 * kRows, 0, qb, q_stride, q0, S, a.hd, t,
                     32);
      copy_rows<HDP>(sm + L::kQ, 2 * kRows, kRows, qb, q_stride, q0 + kRows,
                     S, a.hd, t, 32);
      proxy_fence();
      bar_arrive(q_full);
      for (int kt = 0; kt < nkt; ++kt) {
        const int st = kt % STAGES, n = kt / STAGES;
        if (n > 0) bar_wait(empty(st), (n - 1) & 1);
        copy_rows<HDP>(sm + L::kK + st * L::kTile, kRows, 0, a.kp + kv_off,
                       kv_stride, kt * kRows, S, a.hd, t, 32);
        copy_rows<HDP>(sm + L::kV + st * L::kTile, kRows, 0, a.vp + kv_off,
                       kv_stride, kt * kRows, S, a.hd, t, 32);
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
    // m) is one fmaf and the IEEE exp2f; a masked score (-1e30) gives
    // exp2f(-huge) = 0, so no select.
    const auto softmax = [&](int kt) {
      const int k0 = kt * kRows;
      if (k0 + kRows > S) {
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
    bar_wait(full(0), 0);
    my_turn();
    wgmma_fence();
    s_product(0);
    wgmma_commit();
    their_turn(false);
    wgmma_wait<0>();
    fence_regs(s);
    softmax(0);
    split_acc(s, ph, pl);
    for (int kt = 1; kt < nkt; ++kt) {
      const int st = kt % STAGES, prev = (kt - 1) % STAGES;
      bar_wait(full(st), (kt / STAGES) & 1);
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
      wgmma_wait<1>();  // S of tile kt
      fence_regs(s);
      softmax(kt);
      wgmma_wait<0>();  // P.V of tile kt - 1
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
    pv_product((nkt - 1) % STAGES);
    wgmma_commit();
    their_turn(true);
    wgmma_wait<0>();
    fence_regs(o);

    const float inv0 = 1.0f / fmaxf(l0, 1e-30f);
    const float inv1 = 1.0f / fmaxf(l1, 1e-30f);
    if (a.lse != nullptr && tig == 0) {
      // m is in log2 units: lse = m ln 2 + log(l); a quad shares m and l
      float* lse_bh = a.lse + static_cast<long long>(blockIdx.y) * S;
      if (qi0 < S)
        lse_bh[qi0] = m0 * 0.6931471805599453f + logf(fmaxf(l0, 1e-30f));
      if (qi1 < S)
        lse_bh[qi1] = m1 * 0.6931471805599453f + logf(fmaxf(l1, 1e-30f));
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

template <int HDP>
int launch_fwd(const void* q, const void* k, const void* v, void* o,
               float* lse, int B, int S, int H, int KV, int hd, float scale,
               cudaStream_t stream) {
  using L = FwdLayout<HDP, kFwdStages>;
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
  a.scale = scale;
  a.tma = hd % 8 == 0 && aligned16(q) && aligned16(k) && aligned16(v);
  a.pair = hd % 2 == 0 && reinterpret_cast<uintptr_t>(o) % 4 == 0;
  if (a.tma && !(make_map(&a.q, q, B, S, H, hd) &&
                 make_map(&a.k, k, B, S, KV, hd) &&
                 make_map(&a.v, v, B, S, KV, hd)))
    return static_cast<int>(cudaErrorNotSupported);
  const auto kernel = swa_full_fwd_kernel<HDP, kFwdStages>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L::kBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((S + 2 * kRows - 1) / (2 * kRows), B * H);
  kernel<<<grid, kFwdThreads, L::kBytes, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// f32: CUDA cores, a warp a query row (the f32 card-vs-CPU parity route;
// the tensor cores take f32 only as TF32, which the port keeps off). A
// block's 8 warps share 32-key tiles of k and v staged in shared memory,
// the next tile loaded into registers while this one is computed; a lane
// scores one key of a tile (four fmaf chains over hd), the warp meets by
// shuffles for the row's max and sum, then each lane adds the tile's 32
// p v terms, in key order, into its output columns lane + 32 u. The grid
// has a block per 8 rows (B 2, S 200, H 4: 200 blocks, against 32 of the
// 64-row tiles this replaced, which left most of the 132 SMs idle and
// waited on each row's loads to stage a tile: PERF.md).
// ---------------------------------------------------------------------------

__device__ __forceinline__ float warp_max(float v) {
  for (int off = 16; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

__global__ void __launch_bounds__(32 * kF32Warps)
    f32_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                   const float* __restrict__ v, float* __restrict__ o,
                   float* __restrict__ lse, int S, int H, int KV, int hd,
                   float scale) {
  extern __shared__ float fsm[];
  const int pitch = f32_pitch(hd);
  float* k_s = fsm;                       // [32][pitch]
  float* v_s = k_s + kF32Tile * pitch;    // [32][pitch]
  float* qr = v_s + kF32Tile * pitch + (threadIdx.x / 32) * hd;
  const int lane = threadIdx.x % 32;
  const int b = blockIdx.y / H, h = blockIdx.y % H;
  const int kvh = h / (H / KV);
  const int qi = blockIdx.x * kF32Warps + threadIdx.x / 32;
  const long long q_stride = static_cast<long long>(H) * hd;
  const long long kv_stride = static_cast<long long>(KV) * hd;
  const long long q_off = static_cast<long long>(b) * S * q_stride +
                          static_cast<long long>(h) * hd;
  const long long kv_off = static_cast<long long>(b) * S * kv_stride +
                           static_cast<long long>(kvh) * hd;
  for (int c = lane; c < hd; c += 32)
    qr[c] = qi < S ? q[q_off + qi * q_stride + c] : 0.0f;
  float m = kNegInf, l = 0.0f;
  float acc[kF32Cols];
#pragma unroll
  for (int u = 0; u < kF32Cols; ++u) acc[u] = 0.0f;

  F32Rows nk, nv;  // the next tile of k and v
  f32_load(nk, k + kv_off, kv_stride, 0, S, hd);
  f32_load(nv, v + kv_off, kv_stride, 0, S, hd);
  for (int k0 = 0; k0 < S; k0 += kF32Tile) {
    __syncthreads();  // the last tile is read (and the rows are in)
    f32_store(k_s, nk, hd);
    f32_store(v_s, nv, hd);
    __syncthreads();
    if (k0 + kF32Tile < S) {
      f32_load(nk, k + kv_off, kv_stride, k0 + kF32Tile, S, hd);
      f32_load(nv, v + kv_off, kv_stride, k0 + kF32Tile, S, hd);
    }
    const float dot = f32_dot(qr, k_s + lane * pitch, hd);
    const float s = k0 + lane < S ? dot * scale : kNegInf;
    const float m_new = fmaxf(m, warp_max(s));
    const float alpha = expf(m - m_new);
    const float p = s > kNegInf ? expf(s - m_new) : 0.0f;
    l = l * alpha + warp_sum(p);
    m = m_new;
#pragma unroll
    for (int u = 0; u < kF32Cols; ++u) acc[u] *= alpha;
    for (int j = 0; j < kF32Tile; ++j) {
      const float pj = __shfl_sync(0xffffffffu, p, j);
#pragma unroll
      for (int u = 0; u < kF32Cols; ++u) {
        const int c = lane + 32 * u;
        if (c < hd) acc[u] = fmaf(pj, v_s[j * pitch + c], acc[u]);
      }
    }
  }
  if (qi < S) {
    const float l_safe = fmaxf(l, 1e-30f);
#pragma unroll
    for (int u = 0; u < kF32Cols; ++u) {
      const int c = lane + 32 * u;
      if (c < hd) o[q_off + qi * q_stride + c] = acc[u] / l_safe;
    }
    if (lse != nullptr && lane == 0)
      lse[static_cast<long long>(blockIdx.y) * S + qi] = m + logf(l_safe);
  }
}

int launch_f32(const void* q, const void* k, const void* v, void* o,
               float* lse, int B, int S, int H, int KV, int hd, float scale,
               cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * (2 * kF32Tile * f32_pitch(hd) + kF32Warps * hd);
  const cudaError_t err = cudaFuncSetAttribute(
      f32_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  f32_fwd_kernel<<<dim3((S + kF32Warps - 1) / kF32Warps, B * H),
                   32 * kF32Warps, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), lse, S, H, KV, hd,
      scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace swa_full

// The non-causal forward: q, k, v, o as swa_attention_fwd takes them, lse
// (B, H, S) f32 or null; is_bf16: 0 = float32 operands, 1 = bfloat16.
extern "C" int swa_full_fwd(const void* q, const void* k, const void* v,
                            void* o, void* lse, int B, int S, int H, int KV,
                            int hd, float scale, int is_bf16, void* stream) {
  using namespace swa_full;
  if (hd < 1 || hd > 128 || KV < 1 || H % KV != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* lse_f = static_cast<float*>(lse);
  if (!is_bf16) return launch_f32(q, k, v, o, lse_f, B, S, H, KV, hd, scale, s);
  using Launch = int (*)(const void*, const void*, const void*, void*, float*,
                         int, int, int, int, int, float, cudaStream_t);
  constexpr Launch by_hdp[] = {launch_fwd<16>, launch_fwd<32>,  launch_fwd<48>,
                               launch_fwd<64>, launch_fwd<80>,  launch_fwd<96>,
                               launch_fwd<112>, launch_fwd<128>};
  return by_hdp[(hd + 15) / 16 - 1](q, k, v, o, lse_f, B, S, H, KV, hd, scale,
                                    s);
}
