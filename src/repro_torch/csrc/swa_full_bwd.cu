// Backward of non-causal attention (every query sees every key j < S) with
// GQA; swa_attention_bwd.cu's entry point `swa_attention_bwd` sends its
// non-causal calls here. Given q, k, v, the forward's output o, its per-row
// log-sum-exp lse (natural log) and the output cotangent do:
//   P_ij  = exp(scale * q_i . k_j - lse_i)
//   D_i   = sum_d do_i,d o_i,d
//   dP_ij = do_i . v_j,    dS_ij = P_ij (dP_ij - D_i)
//   dq_i  = scale sum_j dS_ij k_j
//   dk_j  = scale sum_{h in the group} sum_i dS_ij q_i
//   dv_j  = sum_{h in the group} sum_i P_ij do_i
// over i, j < S; G = H / KV query heads share a kv head. Every product and
// sum is f32; dq, dk and dv come out in q's dtype.
//
// Replaces, for the non-causal mode: the backward of src/repro/kernels/
// swa_attention/kernel.py:28 `_swa_kernel`, which has no Pallas backward
// (the reference differentiates the encoder's `_sdpa`, layers/
// attention.py:99-105).
//
// Shapes: q, o, do, dq (B, S, H, hd); k, v, dk, dv (B, S, KV, hd); lse and
// the scratch delta (B, H, S) f32; all contiguous; hd <= 128.
//
// What bounds it on an H100: 10 hd FLOP a (query, key) pair (q.k again,
// do.v, and the products into dq, dk, dv): HuBERT-XLarge's encoder (B 4,
// S 1024, H 16, hd 80, bf16) does 53.7 GFLOP, 54 us at the bf16 tensor-core
// rate, over 63 MB.
//
// Three launches: the D pre-pass (a thread a row), dK/dV, dQ. Each output
// element is one sum in one fixed order, with no atomics: the result is the
// same bits run to run.
//
// bf16: wgmma and TMA (building blocks in swa_full.cuh), 256 threads a
// block, two warpgroups; warpgroup 0 also issues the loads.
// - dK/dV: a block per (batch, kv head, 128 keys), each warpgroup's 64
//   keys one wgmma M tile; k and v of the block arrive once. It walks the
//   G heads of its group and, for each, every 64-query tile, in that
//   order: q, dO, lse and D of a tile arrive by TMA (lse, in log2 units,
//   and D by warp 0's loads) in a ring of kBwdStages stages.
//   S^T = K.Q^T and dP^T = V.dO^T are SS-form wgmma (the keys as rows), so
//   P^T and dS^T come out in the accumulator layout that is the A operand
//   of dV += P^T.dO and dK += dS^T.Q, RS-form wgmma with dO and Q
//   MN-major. P^T and dS^T are f32: each is split into bf16 hi + lo and
//   both products accumulate into the one f32 sum (rounding them once to
//   bf16 errs by up to 2^-8 of every weight, more than a bf16 ulp of an
//   output that cancels; hi + lo keeps 15 bits). No warp-group split of the
//   walk: the non-causal walk is the same length for every key tile.
//   Tile it's dV and dK products run while P^T and dS^T of tile it + 1
//   are computed (its S^T and dP^T are issued first and waited for alone).
// - dQ: a block per (batch, head, 128 queries), each warpgroup's 64
//   queries one M tile; q and dO arrive once, k and v tiles of 64 keys
//   stream through the stages. S and dP are recomputed (SS-form), then
//   dQ += dS.K (RS-form, dS split hi + lo, K MN-major); a tile's dQ
//   products run while the next tile's dS is computed.
// - P = 2^(s scale log2(e) - lse log2(e)), one fmaf and the hardware's
//   exp2 (exp2_ftz, swa_full.cuh: exp2f's handling of denormal results,
//   which no f32 sum here keeps, cost 22 % of the backward).
// - Masks: query columns qi >= S of a ragged query tile take P = 0 in the
//   dK/dV block, keys kj >= S of a ragged key tile P = 0 in the dQ block
//   (the TMA's zero rows would score 0); rows >= S are never written.
//
// f32 (the f32 card-vs-CPU parity runs; the tensor cores take f32 only as
// TF32, which the port keeps off): CUDA-core kernels, a warp a row: a dQ
// warp walks its query's keys 32 at a time, a lane a key for S and dP
// (four fmaf chains), then the warp's 32 dS times k, a lane an output
// column; a dK/dV warp walks its key's queries (over the group) likewise.
// 8 warps a block share the staged tiles, the next tile loaded into
// registers while this one is computed. The grid has a block per 8 rows
// (B 2, S 200, H 4/2: 200 dQ and 100 dK/dV blocks against 32 and 16 of
// the 64-row tiles this replaced, which left most of the 132 SMs idle and
// walked 64 x 64 tiles through one block's 256 threads, a tile's copy
// waiting on each row's loads: PERF.md).
#include "swa_full.cuh"

namespace swa_full {
namespace {

constexpr int kBwdStages = 4;   // q/dO (dK/dV) and k/v (dQ) stages
// a stage is refilled at the end of the tile kLag after the one it held
constexpr int kLag = 1;

template <typename T>
__device__ __forceinline__ float to_f32(T v);
template <>
__device__ __forceinline__ float to_f32<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ float to_f32<bf16>(bf16 v) {
  return __bfloat162float(v);
}

// D_i = do_i . o_i, one fmaf chain over d, a thread a row (16-byte loads
// where vec16: rows of a multiple of 16 bytes, 16-byte aligned), into
// (B, H, S). (A warp a row, lanes striding the row, left each warp one
// or two loads in flight: PERF.md.)
template <typename T>
__global__ void __launch_bounds__(256)
    full_bwd_delta(const T* __restrict__ o, const T* __restrict__ dout,
                   float* __restrict__ delta, int S, int H, int hd,
                   long long rows, int vec16) {
  constexpr int kVec = 16 / sizeof(T);
  const long long row = static_cast<long long>(blockIdx.x) * 256 +
                        threadIdx.x;
  if (row >= rows) return;
  const T* orow = o + row * hd;
  const T* drow = dout + row * hd;
  float s = 0.0f;
  if (vec16) {
    for (int c = 0; c < hd; c += kVec) {
      const uint4 ov = *reinterpret_cast<const uint4*>(orow + c);
      const uint4 dv = *reinterpret_cast<const uint4*>(drow + c);
      const T* op = reinterpret_cast<const T*>(&ov);
      const T* dp = reinterpret_cast<const T*>(&dv);
#pragma unroll
      for (int j = 0; j < kVec; ++j) s = fmaf(to_f32(dp[j]), to_f32(op[j]), s);
    }
  } else {
    for (int d = 0; d < hd; ++d) s = fmaf(to_f32(drow[d]), to_f32(orow[d]), s);
  }
  // row = (b * S + i) * H + h  ->  delta[(b * H + h) * S + i]
  const long long h = row % H;
  const long long bi = row / H;
  const long long b = bi / S, i = bi % S;
  delta[(b * H + h) * S + i] = s;
}

struct BwdArgs {
  CUtensorMap q, k, v, dout;
  const bf16* qp;
  const bf16* kp;
  const bf16* vp;
  const bf16* dop;
  const float* lse;
  const float* delta;
  bf16* dq;
  bf16* dk;
  bf16* dv;
  int S, H, KV, hd;
  float scale;
  int tma;    // copies by TMA (else warpgroup 0's threads)
  int pair;   // 4-byte output stores
};

// ---------------------------------------------------------------------------
// bf16 dK/dV
// ---------------------------------------------------------------------------

template <int HDP, int STAGES>
struct DkdvLayout {
  static constexpr int kTile = kRows * HDP * 2;      // 64 rows
  static constexpr int kK = 0;                       // 128 rows
  static constexpr int kV = kK + 2 * kTile;          // 128 rows
  static constexpr int kQ = kV + 2 * kTile;          // [STAGES] tiles
  static constexpr int kDo = kQ + STAGES * kTile;    // [STAGES] tiles
  static constexpr int kLse = kDo + STAGES * kTile;  // [STAGES][64] f32
  static constexpr int kDl = kLse + STAGES * kRows * 4;
  static constexpr int kBar = kDl + STAGES * kRows * 4;
  // kv_full, full[STAGES], empty[STAGES]
  static constexpr int kBytes = kBar + 8 * (1 + 2 * STAGES) + 1024;
};

template <int HDP, int STAGES>
__global__ void __launch_bounds__(kThreads, 1)
    full_dkdv_kernel(const __grid_constant__ BwdArgs a) {
  using L = DkdvLayout<HDP, STAGES>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm = align1024(smem_raw);
  const uint32_t sa = smem_addr(sm);
  const uint32_t kv_full = sa + L::kBar;
  const auto full = [&](int st) { return sa + L::kBar + 8 * (1 + st); };
  const auto empty = [&](int st) {
    return sa + L::kBar + 8 * (1 + STAGES + st);
  };
  float* lse_s = reinterpret_cast<float*>(sm + L::kLse);
  float* dl_s = reinterpret_cast<float*>(sm + L::kDl);
  const int wg = threadIdx.x / 128;
  const int S = a.S, H = a.H;
  const int G = H / a.KV;
  const int k0 = blockIdx.x * 2 * kRows;
  const int b = blockIdx.y / a.KV, kvh = blockIdx.y % a.KV;
  const int nqt = (S + kRows - 1) / kRows;
  const int n_it = G * nqt;  // tile it: head kvh G + it / nqt, query tile
                             // it % nqt

  if (threadIdx.x == 0) {
    bar_init(kv_full, a.tma ? 1 : 128);
    for (int st = 0; st < STAGES; ++st) {
      bar_init(full(st), a.tma ? 33 : 128);
      bar_init(empty(st), kThreads);
    }
    bar_init_fence();
  }
  __syncthreads();

  // ---- loads, by warpgroup 0: k and v and the first STAGES walk tiles
  // now; tile it + STAGES - kLag at the end of its tile it (refill)
  const int t = threadIdx.x;
  const long long q_stride = static_cast<long long>(H) * a.hd;
  // walk tile it's q, dO (TMA: thread 0; else warpgroup 0's threads), lse
  // (in log2 units: P = exp2(s scale log2(e) - lse log2(e))) and D (warp
  // 0's lanes, or warpgroup 0's threads), into its (free) stage
  const auto load_q = [&](int it) {
    const int st = it % STAGES;
    const int hh = kvh * G + it / nqt, q0 = (it % nqt) * kRows;
    if (a.tma) {
      if (t >= 32) return;
      if (t == 0) {
        bar_expect(full(st), 2 * L::kTile);
        tma_rows<HDP>(sa + L::kQ + st * L::kTile, kRows, 0, a.q, full(st),
                      q0, hh, b);
        tma_rows<HDP>(sa + L::kDo + st * L::kTile, kRows, 0, a.dout,
                      full(st), q0, hh, b);
      }
    } else {
      const long long q_off = static_cast<long long>(b) * S * q_stride +
                              static_cast<long long>(hh) * a.hd;
      copy_rows<HDP>(sm + L::kQ + st * L::kTile, kRows, 0, a.qp + q_off,
                     q_stride, q0, S, a.hd, t, 128);
      copy_rows<HDP>(sm + L::kDo + st * L::kTile, kRows, 0, a.dop + q_off,
                     q_stride, q0, S, a.hd, t, 128);
    }
    const long long row = (static_cast<long long>(b) * H + hh) * S;
    for (int e = t; e < kRows; e += a.tma ? 32 : 128) {
      const int qi = q0 + e;
      lse_s[st * kRows + e] = qi < S ? a.lse[row + qi] * kLog2e : 0.0f;
      dl_s[st * kRows + e] = qi < S ? a.delta[row + qi] : 0.0f;
    }
    if (!a.tma) proxy_fence();
    bar_arrive(full(st));
  };
  const auto refill = [&](int it) {
    const int tile = it + STAGES - kLag;
    if (wg != 0 || it < kLag || tile >= n_it) return;
    if (!a.tma || t < 32)
      bar_wait(empty(tile % STAGES), (tile / STAGES - 1) & 1);
    load_q(tile);
  };
  if (wg == 0) {
    if (a.tma) {
      if (t == 0) {
        bar_expect(kv_full, 4 * L::kTile);
        for (int half = 0; half < 2; ++half) {
          tma_rows<HDP>(sa + L::kK, 2 * kRows, half * kRows, a.k, kv_full,
                        k0 + half * kRows, kvh, b);
          tma_rows<HDP>(sa + L::kV, 2 * kRows, half * kRows, a.v, kv_full,
                        k0 + half * kRows, kvh, b);
        }
      }
    } else {
      const long long kv_stride = static_cast<long long>(a.KV) * a.hd;
      const long long kv_off = static_cast<long long>(b) * S * kv_stride +
                               static_cast<long long>(kvh) * a.hd;
      for (int half = 0; half < 2; ++half) {
        copy_rows<HDP>(sm + L::kK, 2 * kRows, half * kRows, a.kp + kv_off,
                       kv_stride, k0 + half * kRows, S, a.hd, t, 128);
        copy_rows<HDP>(sm + L::kV, 2 * kRows, half * kRows, a.vp + kv_off,
                       kv_stride, k0 + half * kRows, S, a.hd, t, 128);
      }
      proxy_fence();
      bar_arrive(kv_full);
    }
    for (int it = 0; it < STAGES && it < n_it; ++it) load_q(it);
  }

  // ---- warpgroup wg: keys k0 + 64 wg .. + 63 as rows
  const int warp = (t % 128) / 32, lane = t % 32;
  const int g = lane / 4, tig = lane % 4;
  const int kj0 = k0 + wg * kRows + warp * 16 + g;  // this thread's keys
  const int kj1 = kj0 + 8;
  const float scale = a.scale, scale_log2 = a.scale * kLog2e;
  float dk[HDP / 2], dv[HDP / 2], s[32], dp[32];
  uint32_t ph[16], pl[16], dh[16], dl[16];
#pragma unroll
  for (int i = 0; i < HDP / 2; ++i) dk[i] = dv[i] = 0.0f;

  const uint64_t k_desc = make_desc(sa + L::kK + wg * kRows * 32, 16);
  const uint64_t v_desc = make_desc(sa + L::kV + wg * kRows * 32, 16);
  const uint64_t q_desc = make_desc(sa + L::kQ, 16);
  const uint64_t do_desc = make_desc(sa + L::kDo, 16);
  const uint64_t q_mn = make_desc(sa + L::kQ, kRows * 32);
  const uint64_t do_mn = make_desc(sa + L::kDo, kRows * 32);
  // S^T = K.Q^T, dP^T = V.dO^T of walk tile it: 64 keys x 64 queries
  // (issued, not waited for)
  const auto sdp_product = [&](int it) {
    const int st = it % STAGES;
    bar_wait(full(st), (it / STAGES) & 1);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < HDP / kPiece; ++ks) {
      // this warpgroup's keys in k and v; the tile's queries
      const uint32_t rows = 2 * kRows * 32 * ks;
      const uint32_t cols = st * L::kTile + kRows * 32 * ks;
      wgmma_ss64(s, desc_at(k_desc, rows), desc_at(q_desc, cols), ks > 0);
      wgmma_ss64(dp, desc_at(v_desc, rows), desc_at(do_desc, cols),
                 ks > 0);
    }
    wgmma_commit();
  };
  // P^T in s, dS^T in dp: rows kj0, kj1, query column 8n + 2tig + e
  const auto p_ds = [&](int it) {
    const int st = it % STAGES;
    const int q0 = (it % nqt) * kRows;
    const bool ragged = q0 + kRows > S;
    const float* ls = lse_s + st * kRows;
    const float* dls = dl_s + st * kRows;
    fence_regs(s);
    fence_regs(dp);
#pragma unroll
    for (int n = 0; n < 8; ++n) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = n * 8 + 2 * tig + e;
        const bool in = !ragged || q0 + c < S;
        const float p0 =
            in ? exp2_ftz(fmaf(s[4 * n + e], scale_log2, -ls[c])) : 0.0f;
        const float p1 =
            in ? exp2_ftz(fmaf(s[4 * n + 2 + e], scale_log2, -ls[c])) : 0.0f;
        s[4 * n + e] = p0;
        s[4 * n + 2 + e] = p1;
        dp[4 * n + e] = p0 * (dp[4 * n + e] - dls[c]);
        dp[4 * n + 2 + e] = p1 * (dp[4 * n + 2 + e] - dls[c]);
      }
    }
  };
  // dV += P^T.dO, then dK += dS^T.Q of walk tile it, a k-step of 16
  // queries at a time (issued, not waited for)
  const auto dkdv_products = [&](int it) {
    const int st = it % STAGES;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kRows / 16; ++kk) {
      const uint64_t d = desc_at(do_mn, st * L::kTile + 16 * kk * 32);
      wgmma_rs<HDP>(dv, ph + 4 * kk, d);
      wgmma_rs<HDP>(dv, pl + 4 * kk, d);
    }
#pragma unroll
    for (int kk = 0; kk < kRows / 16; ++kk) {
      const uint64_t d = desc_at(q_mn, st * L::kTile + 16 * kk * 32);
      wgmma_rs<HDP>(dk, dh + 4 * kk, d);
      wgmma_rs<HDP>(dk, dl + 4 * kk, d);
    }
    wgmma_commit();
  };

  // Tile it's products run while the next tile's P^T and dS^T are
  // computed: S^T, dP^T of it + 1 are issued first, then the dV, dK
  // products of it; P^T and dS^T of it + 1 wait only for the first
  // (The loop issues its products unconditionally and the last tile's
  // come after it: a product issued under a branch let ptxas serialize
  // every wgmma of the kernel.)
  const auto retire = [&](int it) {  // after tile it's products complete
    wgmma_wait<0>();
    fence_regs(dk);
    fence_regs(dv);
    fence_regs(ph);
    fence_regs(pl);
    fence_regs(dh);
    fence_regs(dl);
    bar_arrive(empty(it % STAGES));
  };
  bar_wait(kv_full, 0);
  sdp_product(0);
  wgmma_wait<0>();
  p_ds(0);
  split_acc(s, ph, pl);
  split_acc(dp, dh, dl);
  for (int it = 0; it + 1 < n_it; ++it) {
    // dk and dv are read by no other instruction while products are in
    // flight
    fence_regs(dk);
    fence_regs(dv);
    sdp_product(it + 1);
    dkdv_products(it);
    wgmma_wait<1>();
    p_ds(it + 1);
    retire(it);
    refill(it);
    split_acc(s, ph, pl);
    split_acc(dp, dh, dl);
  }
  fence_regs(dk);
  fence_regs(dv);
  dkdv_products(n_it - 1);
  retire(n_it - 1);

  const long long kv_stride = static_cast<long long>(a.KV) * a.hd;
  const long long kv_off = static_cast<long long>(b) * S * kv_stride +
                           static_cast<long long>(kvh) * a.hd;
  const bool pair = a.pair != 0;
#pragma unroll
  for (int i = 0; i < HDP / 8; ++i) {
    const int c = 8 * i + 2 * tig;
    if (kj0 < S) {
      store_pair(a.dk + kv_off + kj0 * kv_stride, c, a.hd,
                 dk[4 * i] * scale, dk[4 * i + 1] * scale, pair);
      store_pair(a.dv + kv_off + kj0 * kv_stride, c, a.hd, dv[4 * i],
                 dv[4 * i + 1], pair);
    }
    if (kj1 < S) {
      store_pair(a.dk + kv_off + kj1 * kv_stride, c, a.hd,
                 dk[4 * i + 2] * scale, dk[4 * i + 3] * scale, pair);
      store_pair(a.dv + kv_off + kj1 * kv_stride, c, a.hd, dv[4 * i + 2],
                 dv[4 * i + 3], pair);
    }
  }
}

// ---------------------------------------------------------------------------
// bf16 dQ
// ---------------------------------------------------------------------------

template <int HDP, int STAGES>
struct DqLayout {
  static constexpr int kTile = kRows * HDP * 2;      // 64 rows
  static constexpr int kQ = 0;                       // 128 rows
  static constexpr int kDo = kQ + 2 * kTile;         // 128 rows
  static constexpr int kK = kDo + 2 * kTile;         // [STAGES] tiles
  static constexpr int kV = kK + STAGES * kTile;     // [STAGES] tiles
  static constexpr int kBar = kV + STAGES * kTile;
  // q_full, full[STAGES], empty[STAGES]
  static constexpr int kBytes = kBar + 8 * (1 + 2 * STAGES) + 1024;
};

// a tile's first products are issued an iteration early: its stage must
// be refilled two iterations before
static_assert(kBwdStages >= kLag + 2, "a stage is refilled before its tile");
static_assert(DkdvLayout<128, kBwdStages>::kBytes <= 232448, "smem");
static_assert(DqLayout<128, kBwdStages>::kBytes <= 232448, "smem");

template <int HDP, int STAGES>
__global__ void __launch_bounds__(kThreads, 1)
    full_dq_kernel(const __grid_constant__ BwdArgs a) {
  using L = DqLayout<HDP, STAGES>;
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
    const int fill = a.tma ? 1 : 128;
    bar_init(q_full, fill);
    for (int st = 0; st < STAGES; ++st) {
      bar_init(full(st), fill);
      bar_init(empty(st), kThreads);
    }
    bar_init_fence();
  }
  __syncthreads();

  // ---- loads, by warpgroup 0: q, dO and the first STAGES k, v tiles now;
  // tile kt + STAGES - kLag at the end of its tile kt (refill)
  const int t = threadIdx.x;
  const long long kv_stride = static_cast<long long>(a.KV) * a.hd;
  const long long kv_off = static_cast<long long>(b) * S * kv_stride +
                           static_cast<long long>(kvh) * a.hd;
  const auto load_kv = [&](int kt) {  // tile kt into its (free) stage
    const int st = kt % STAGES;
    if (a.tma) {
      if (t == 0) {
        bar_expect(full(st), 2 * L::kTile);
        tma_rows<HDP>(sa + L::kK + st * L::kTile, kRows, 0, a.k, full(st),
                      kt * kRows, kvh, b);
        tma_rows<HDP>(sa + L::kV + st * L::kTile, kRows, 0, a.v, full(st),
                      kt * kRows, kvh, b);
      }
    } else {
      copy_rows<HDP>(sm + L::kK + st * L::kTile, kRows, 0, a.kp + kv_off,
                     kv_stride, kt * kRows, S, a.hd, t, 128);
      copy_rows<HDP>(sm + L::kV + st * L::kTile, kRows, 0, a.vp + kv_off,
                     kv_stride, kt * kRows, S, a.hd, t, 128);
      proxy_fence();
      bar_arrive(full(st));
    }
  };
  const auto refill = [&](int kt) {
    const int tile = kt + STAGES - kLag;
    if (wg != 0 || kt < kLag || tile >= nkt) return;
    if (!a.tma || t == 0)
      bar_wait(empty(tile % STAGES), (tile / STAGES - 1) & 1);
    load_kv(tile);
  };
  if (wg == 0) {
    if (a.tma) {
      if (t == 0) {
        bar_expect(q_full, 4 * L::kTile);
        for (int half = 0; half < 2; ++half) {
          tma_rows<HDP>(sa + L::kQ, 2 * kRows, half * kRows, a.q, q_full,
                        q0 + half * kRows, h, b);
          tma_rows<HDP>(sa + L::kDo, 2 * kRows, half * kRows, a.dout, q_full,
                        q0 + half * kRows, h, b);
        }
      }
    } else {
      const long long q_stride = static_cast<long long>(a.H) * a.hd;
      const long long q_off = static_cast<long long>(b) * S * q_stride +
                              static_cast<long long>(h) * a.hd;
      for (int half = 0; half < 2; ++half) {
        copy_rows<HDP>(sm + L::kQ, 2 * kRows, half * kRows, a.qp + q_off,
                       q_stride, q0 + half * kRows, S, a.hd, t, 128);
        copy_rows<HDP>(sm + L::kDo, 2 * kRows, half * kRows, a.dop + q_off,
                       q_stride, q0 + half * kRows, S, a.hd, t, 128);
      }
      proxy_fence();
      bar_arrive(q_full);
    }
    for (int kt = 0; kt < STAGES && kt < nkt; ++kt) load_kv(kt);
  }

  // ---- warpgroup wg: queries q0 + 64 wg .. + 63
  const int warp = (t % 128) / 32, lane = t % 32;
  const int g = lane / 4, tig = lane % 4;
  const int qi0 = q0 + wg * kRows + warp * 16 + g;  // this thread's rows
  const int qi1 = qi0 + 8;
  const float scale = a.scale, scale_log2 = a.scale * kLog2e;
  const float* lse_bh = a.lse + static_cast<long long>(blockIdx.y) * S;
  const float* dl_bh = a.delta + static_cast<long long>(blockIdx.y) * S;
  // lse in log2 units: P = exp2(s scale log2(e) - lse log2(e))
  const float l0 = qi0 < S ? lse_bh[qi0] * kLog2e : 0.0f;
  const float l1 = qi1 < S ? lse_bh[qi1] * kLog2e : 0.0f;
  const float d0 = qi0 < S ? dl_bh[qi0] : 0.0f;
  const float d1 = qi1 < S ? dl_bh[qi1] : 0.0f;
  float dq[HDP / 2], s[32], dp[32];
  uint32_t dh[16], dl[16];  // dS's fragments, hi and lo
#pragma unroll
  for (int i = 0; i < HDP / 2; ++i) dq[i] = 0.0f;

  const uint64_t q_desc = make_desc(sa + L::kQ + wg * kRows * 32, 16);
  const uint64_t do_desc = make_desc(sa + L::kDo + wg * kRows * 32, 16);
  const uint64_t k_desc = make_desc(sa + L::kK, 16);
  const uint64_t v_desc = make_desc(sa + L::kV, 16);
  const uint64_t k_mn = make_desc(sa + L::kK, kRows * 32);
  // S = Q.K^T, dP = dO.V^T of key tile kt: 64 queries x 64 keys
  // (issued, not waited for)
  const auto sdp_product = [&](int kt) {
    const int st = kt % STAGES;
    bar_wait(full(st), (kt / STAGES) & 1);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < HDP / kPiece; ++ks) {
      // this warpgroup's queries in q and dO; the tile's keys
      const uint32_t rows = 2 * kRows * 32 * ks;
      const uint32_t cols = st * L::kTile + kRows * 32 * ks;
      wgmma_ss64(s, desc_at(q_desc, rows), desc_at(k_desc, cols), ks > 0);
      wgmma_ss64(dp, desc_at(do_desc, rows), desc_at(v_desc, cols),
                 ks > 0);
    }
    wgmma_commit();
  };
  // dS of key tile kt in dp (rows qi0, qi1, key column 8n + 2tig + e)
  const auto ds = [&](int kt) {
    const int k0 = kt * kRows;
    const bool ragged = k0 + kRows > S;
    fence_regs(s);
    fence_regs(dp);
#pragma unroll
    for (int n = 0; n < 8; ++n) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const bool in = !ragged || k0 + n * 8 + 2 * tig + e < S;
        const float p0 =
            in ? exp2_ftz(fmaf(s[4 * n + e], scale_log2, -l0)) : 0.0f;
        const float p1 =
            in ? exp2_ftz(fmaf(s[4 * n + 2 + e], scale_log2, -l1)) : 0.0f;
        dp[4 * n + e] = p0 * (dp[4 * n + e] - d0);
        dp[4 * n + 2 + e] = p1 * (dp[4 * n + 2 + e] - d1);
      }
    }
  };
  // dQ += dS.K of key tile kt, a k-step of 16 keys at a time (issued,
  // not waited for)
  const auto dq_product = [&](int kt) {
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kRows / 16; ++kk) {
      const uint64_t d =
          desc_at(k_mn, (kt % STAGES) * L::kTile + 16 * kk * 32);
      wgmma_rs<HDP>(dq, dh + 4 * kk, d);
      wgmma_rs<HDP>(dq, dl + 4 * kk, d);
    }
    wgmma_commit();
  };
  const auto retire = [&](int kt) {  // after tile kt's products complete
    wgmma_wait<0>();
    fence_regs(dq);
    fence_regs(dh);
    fence_regs(dl);
    bar_arrive(empty(kt % STAGES));
  };

  // Tile kt's dQ products run while the next tile's dS is computed (its
  // S and dP are issued first and waited for alone); the loop issues
  // unconditionally, the last tile's products after it
  bar_wait(q_full, 0);
  sdp_product(0);
  wgmma_wait<0>();
  ds(0);
  split_acc(dp, dh, dl);
  for (int kt = 0; kt + 1 < nkt; ++kt) {
    fence_regs(dq);  // read by no other instruction while in flight
    sdp_product(kt + 1);
    dq_product(kt);
    wgmma_wait<1>();
    ds(kt + 1);
    retire(kt);
    refill(kt);
    split_acc(dp, dh, dl);
  }
  fence_regs(dq);
  dq_product(nkt - 1);
  retire(nkt - 1);

  const long long q_stride = static_cast<long long>(a.H) * a.hd;
  bf16* dqb = a.dq + static_cast<long long>(b) * S * q_stride +
              static_cast<long long>(h) * a.hd;
  const bool pair = a.pair != 0;
#pragma unroll
  for (int i = 0; i < HDP / 8; ++i) {
    const int c = 8 * i + 2 * tig;
    if (qi0 < S)
      store_pair(dqb + qi0 * q_stride, c, a.hd, dq[4 * i] * scale,
                 dq[4 * i + 1] * scale, pair);
    if (qi1 < S)
      store_pair(dqb + qi1 * q_stride, c, a.hd, dq[4 * i + 2] * scale,
                 dq[4 * i + 3] * scale, pair);
  }
}

template <int HDP>
int launch_bf16(BwdArgs& a, int B, int S, int H, int KV, int hd,
                cudaStream_t stream) {
  if (a.tma && !(make_map(&a.q, a.qp, B, S, H, hd) &&
                 make_map(&a.dout, a.dop, B, S, H, hd) &&
                 make_map(&a.k, a.kp, B, S, KV, hd) &&
                 make_map(&a.v, a.vp, B, S, KV, hd)))
    return static_cast<int>(cudaErrorNotSupported);
  using LK = DkdvLayout<HDP, kBwdStages>;
  using LQ = DqLayout<HDP, kBwdStages>;
  const auto dkdv = full_dkdv_kernel<HDP, kBwdStages>;
  const auto dq = full_dq_kernel<HDP, kBwdStages>;
  cudaError_t err = cudaFuncSetAttribute(
      dkdv, cudaFuncAttributeMaxDynamicSharedMemorySize, LK::kBytes);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(
        dq, cudaFuncAttributeMaxDynamicSharedMemorySize, LQ::kBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int tiles = (S + 2 * kRows - 1) / (2 * kRows);
  dkdv<<<dim3(tiles, B * KV), kThreads, LK::kBytes, stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  dq<<<dim3(tiles, B * H), kThreads, LQ::kBytes, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// f32: CUDA cores, a warp a row
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(32 * kF32Warps)
    f32_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ v, const float* __restrict__ dout,
                  const float* __restrict__ lse,
                  const float* __restrict__ delta, float* __restrict__ dq,
                  int S, int H, int KV, int hd, float scale) {
  extern __shared__ float fsm[];
  const int pitch = f32_pitch(hd);
  float* k_s = fsm;                       // [32][pitch]
  float* v_s = k_s + kF32Tile * pitch;    // [32][pitch]
  float* row_s = v_s + kF32Tile * pitch;  // [8][2][hd]: q, do of each warp
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int b = blockIdx.y / H, h = blockIdx.y % H;
  const int kvh = h / (H / KV);
  const int qi = blockIdx.x * kF32Warps + warp;
  const long long q_stride = static_cast<long long>(H) * hd;
  const long long kv_stride = static_cast<long long>(KV) * hd;
  const long long q_off = static_cast<long long>(b) * S * q_stride +
                          static_cast<long long>(h) * hd;
  const long long kv_off = static_cast<long long>(b) * S * kv_stride +
                           static_cast<long long>(kvh) * hd;
  float* qr = row_s + warp * 2 * hd;
  float* dor = qr + hd;
  for (int c = lane; c < hd; c += 32) {
    qr[c] = qi < S ? q[q_off + qi * q_stride + c] : 0.0f;
    dor[c] = qi < S ? dout[q_off + qi * q_stride + c] : 0.0f;
  }
  const long long bh = static_cast<long long>(blockIdx.y) * S;
  const float l = qi < S ? lse[bh + qi] : 0.0f;
  const float dl = qi < S ? delta[bh + qi] : 0.0f;
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
    const int kj = k0 + lane;
    const float s = f32_dot(qr, k_s + lane * pitch, hd);
    const float dp = f32_dot(dor, v_s + lane * pitch, hd);
    const float p = qi < S && kj < S ? expf(s * scale - l) : 0.0f;
    const float ds = p * (dp - dl);
    for (int j = 0; j < kF32Tile; ++j) {
      const float dsj = __shfl_sync(0xffffffffu, ds, j);
#pragma unroll
      for (int u = 0; u < kF32Cols; ++u) {
        const int c = lane + 32 * u;
        if (c < hd) acc[u] = fmaf(dsj, k_s[j * pitch + c], acc[u]);
      }
    }
  }
  if (qi < S) {
#pragma unroll
    for (int u = 0; u < kF32Cols; ++u) {
      const int c = lane + 32 * u;
      if (c < hd) dq[q_off + qi * q_stride + c] = acc[u] * scale;
    }
  }
}

__global__ void __launch_bounds__(32 * kF32Warps)
    f32_dkdv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v,
                    const float* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, float* __restrict__ dk,
                    float* __restrict__ dv, int S, int H, int KV, int hd,
                    float scale) {
  extern __shared__ float fsm[];
  const int pitch = f32_pitch(hd);
  float* q_s = fsm;                          // [32][pitch]
  float* do_s = q_s + kF32Tile * pitch;      // [32][pitch]
  float* lse_s = do_s + kF32Tile * pitch;    // [32]
  float* dl_s = lse_s + kF32Tile;            // [32]
  float* row_s = dl_s + kF32Tile;            // [8][2][hd]: k, v a warp
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int b = blockIdx.y / KV, kvh = blockIdx.y % KV;
  const int G = H / KV;
  const int kj = blockIdx.x * kF32Warps + warp;
  const long long q_stride = static_cast<long long>(H) * hd;
  const long long kv_stride = static_cast<long long>(KV) * hd;
  const long long kv_off = static_cast<long long>(b) * S * kv_stride +
                           static_cast<long long>(kvh) * hd;
  float* kr = row_s + warp * 2 * hd;
  float* vr = kr + hd;
  for (int c = lane; c < hd; c += 32) {
    kr[c] = kj < S ? k[kv_off + kj * kv_stride + c] : 0.0f;
    vr[c] = kj < S ? v[kv_off + kj * kv_stride + c] : 0.0f;
  }
  float acc_k[kF32Cols], acc_v[kF32Cols];
#pragma unroll
  for (int u = 0; u < kF32Cols; ++u) acc_k[u] = acc_v[u] = 0.0f;

  // the walk: tile it is head kvh G + it / nq, queries (it % nq) 32 ..
  const int nq = (S + kF32Tile - 1) / kF32Tile;
  F32Rows nxq, nxdo;  // the next tile's q and dO, and its lse and D (the
  float nl = 0.0f, nd = 0.0f;  // block's first 32 threads, a row each)
  const auto load = [&](int it) {
    const int h = kvh * G + it / nq, q0 = (it % nq) * kF32Tile;
    const long long q_off = static_cast<long long>(b) * S * q_stride +
                            static_cast<long long>(h) * hd;
    f32_load(nxq, q + q_off, q_stride, q0, S, hd);
    f32_load(nxdo, dout + q_off, q_stride, q0, S, hd);
    if (threadIdx.x < kF32Tile) {
      const long long bh = (static_cast<long long>(b) * H + h) * S;
      const int qi = q0 + threadIdx.x;
      nl = qi < S ? lse[bh + qi] : 0.0f;
      nd = qi < S ? delta[bh + qi] : 0.0f;
    }
  };
  load(0);
  for (int it = 0; it < G * nq; ++it) {
    const int q0 = (it % nq) * kF32Tile;
    __syncthreads();  // the last tile is read (and the rows are in)
    f32_store(q_s, nxq, hd);
    f32_store(do_s, nxdo, hd);
    if (threadIdx.x < kF32Tile) {
      lse_s[threadIdx.x] = nl;
      dl_s[threadIdx.x] = nd;
    }
    __syncthreads();
    if (it + 1 < G * nq) load(it + 1);
    const int qi = q0 + lane;
    const float s = f32_dot(kr, q_s + lane * pitch, hd);
    const float dp = f32_dot(vr, do_s + lane * pitch, hd);
    const float p = qi < S && kj < S ? expf(s * scale - lse_s[lane]) : 0.0f;
    const float ds = p * (dp - dl_s[lane]);
    for (int i = 0; i < kF32Tile; ++i) {
      const float pi = __shfl_sync(0xffffffffu, p, i);
      const float dsi = __shfl_sync(0xffffffffu, ds, i);
#pragma unroll
      for (int u = 0; u < kF32Cols; ++u) {
        const int c = lane + 32 * u;
        if (c < hd) {
          acc_v[u] = fmaf(pi, do_s[i * pitch + c], acc_v[u]);
          acc_k[u] = fmaf(dsi, q_s[i * pitch + c], acc_k[u]);
        }
      }
    }
  }
  if (kj < S) {
#pragma unroll
    for (int u = 0; u < kF32Cols; ++u) {
      const int c = lane + 32 * u;
      if (c < hd) {
        dk[kv_off + kj * kv_stride + c] = acc_k[u] * scale;
        dv[kv_off + kj * kv_stride + c] = acc_v[u];
      }
    }
  }
}

int launch_f32(const BwdArgs& a, const void* q, const void* k, const void* v,
               const void* dout, void* dq, void* dk, void* dv, int B,
               cudaStream_t stream) {
  const int S = a.S, H = a.H, KV = a.KV, hd = a.hd;
  const size_t tiles = sizeof(float) * 2 * kF32Tile * f32_pitch(hd);
  const size_t rows = sizeof(float) * kF32Warps * 2 * hd;
  const size_t dq_smem = tiles + rows;
  const size_t kv_smem = tiles + rows + sizeof(float) * 2 * kF32Tile;
  cudaError_t err = cudaFuncSetAttribute(
      f32_dq_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(dq_smem));
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(f32_dkdv_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(kv_smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = (S + kF32Warps - 1) / kF32Warps;
  const float* qf = static_cast<const float*>(q);
  const float* kf = static_cast<const float*>(k);
  const float* vf = static_cast<const float*>(v);
  const float* df = static_cast<const float*>(dout);
  f32_dkdv_kernel<<<dim3(blocks, B * KV), 32 * kF32Warps, kv_smem, stream>>>(
      qf, kf, vf, df, a.lse, a.delta, static_cast<float*>(dk),
      static_cast<float*>(dv), S, H, KV, hd, a.scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  f32_dq_kernel<<<dim3(blocks, B * H), 32 * kF32Warps, dq_smem, stream>>>(
      qf, kf, vf, df, a.lse, a.delta, static_cast<float*>(dq), S, H, KV, hd,
      a.scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace swa_full

// The non-causal backward: arguments as swa_attention_bwd takes them
// (without window and causal); is_bf16: 0 = float32 operands, 1 =
// bfloat16.
extern "C" int swa_full_bwd(const void* q, const void* k, const void* v,
                            const void* o, const void* dout, const void* lse,
                            void* delta, void* dq, void* dk, void* dv, int B,
                            int S, int H, int KV, int hd, float scale,
                            int is_bf16, void* stream) {
  using namespace swa_full;
  if (hd < 1 || hd > 128 || KV < 1 || H % KV != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long rows = static_cast<long long>(B) * S * H;
  const long long delta_blocks = (rows + 255) / 256;
  if (delta_blocks > 2147483647LL)
    return static_cast<int>(cudaErrorInvalidValue);
  float* dl = static_cast<float*>(delta);
  const int vec16 = hd * (is_bf16 ? 2 : 4) % 16 == 0 && aligned16(o) &&
                    aligned16(dout);
  if (is_bf16)
    full_bwd_delta<bf16><<<static_cast<unsigned>(delta_blocks), 256, 0, s>>>(
        static_cast<const bf16*>(o), static_cast<const bf16*>(dout), dl, S, H,
        hd, rows, vec16);
  else
    full_bwd_delta<float><<<static_cast<unsigned>(delta_blocks), 256, 0, s>>>(
        static_cast<const float*>(o), static_cast<const float*>(dout), dl, S,
        H, hd, rows, vec16);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  BwdArgs a;
  a.qp = static_cast<const bf16*>(q);
  a.kp = static_cast<const bf16*>(k);
  a.vp = static_cast<const bf16*>(v);
  a.dop = static_cast<const bf16*>(dout);
  a.lse = static_cast<const float*>(lse);
  a.delta = dl;
  a.dq = static_cast<bf16*>(dq);
  a.dk = static_cast<bf16*>(dk);
  a.dv = static_cast<bf16*>(dv);
  a.S = S;
  a.H = H;
  a.KV = KV;
  a.hd = hd;
  a.scale = scale;
  if (!is_bf16) return launch_f32(a, q, k, v, dout, dq, dk, dv, B, s);
  a.tma = hd % 8 == 0 && aligned16(q) && aligned16(k) && aligned16(v) &&
          aligned16(dout);
  a.pair = hd % 2 == 0 && reinterpret_cast<uintptr_t>(dq) % 4 == 0 &&
           reinterpret_cast<uintptr_t>(dk) % 4 == 0 &&
           reinterpret_cast<uintptr_t>(dv) % 4 == 0;
  using Launch = int (*)(BwdArgs&, int, int, int, int, int, cudaStream_t);
  constexpr Launch by_hdp[] = {launch_bf16<16>, launch_bf16<32>,
                               launch_bf16<48>, launch_bf16<64>,
                               launch_bf16<80>, launch_bf16<96>,
                               launch_bf16<112>, launch_bf16<128>};
  return by_hdp[(hd + 15) / 16 - 1](a, B, S, H, KV, hd, s);
}
