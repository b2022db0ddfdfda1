// Backward of flash attention with GQA, in the two modes of
// swa_full_fwd.cu: non-causal (every query sees every key j < S) and
// causal (keys j <= i with i - j < window). The C entry point
// `swa_attention_bwd` (end of file) takes every call: the D pre-pass,
// then the kernels of its dtype, bf16 on the tensor cores, f32 on the CUDA
// cores.
// Given q, k, v, the forward's output o, its per-row log-sum-exp lse
// (natural log) and the output cotangent do:
//   P_ij  = exp(scale * q_i . k_j - lse_i)        (0 outside the mask)
//   D_i   = sum_d do_i,d o_i,d
//   dP_ij = do_i . v_j,    dS_ij = P_ij (dP_ij - D_i)
//   dq_i  = scale sum_j dS_ij k_j
//   dk_j  = scale sum_{h in the group} sum_i dS_ij q_i
//   dv_j  = sum_{h in the group} sum_i P_ij do_i
// over the pairs (i, j) of the mask, i, j < S; G = H / KV query heads share
// a kv head. Every product and sum is f32; dq, dk and dv come out in q's
// dtype.
//
// Replaces: the backward of src/repro/kernels/swa_attention/kernel.py:28
// `_swa_kernel`, which has no Pallas backward (the reference
// differentiates its plain `_sdpa`, layers/attention.py:65, and under an
// all-ones mask the encoder's, :99-105).
//
// Shapes: q, o, do, dq (B, S, H, hd); k, v, dk, dv (B, S, KV, hd); lse and
// the scratch delta (B, H, S) f32; all contiguous; hd <= 128.
//
// What bounds it on an H100: 10 hd FLOP a (query, key) pair inside the
// mask (q.k again, do.v, and the products into dq, dk, dv): HuBERT-XLarge's
// encoder (B 4, S 1024, H 16, hd 80, bf16) does 53.7 GFLOP, 54 us at the
// bf16 tensor-core rate, over 63 MB; a causal 4,096-token sequence of
// Qwen3-8B (B 1, H 32/8, hd 128) 344 GFLOP, 0.35 ms.
//
// Launches: the D pre-pass (8 lanes a row), then dK/dV and dQ (the causal bf16
// mode and f32: one launch of both, dK/dV's blocks first). Each output element
// is one sum in one fixed order, with no atomics: the result is the same bits
// run to run.
//
// bf16: wgmma and TMA (building blocks in swa_full.cuh), 256 threads a
// block, two warpgroups that also issue the loads.
// - dK/dV, non-causal: a block per (batch, kv head, 128 keys), each
//   warpgroup's 64 keys one wgmma M tile; k and v of the block arrive
//   once. It walks the G heads of its group and, for each, every 64-query
//   tile, in that order: q, dO, lse and D of a tile arrive by TMA (lse, in
//   log2 units, and D by warp 0's loads) in a ring of kBwdStages stages
//   that warpgroup 0 fills.
//   S^T = K.Q^T and dP^T = V.dO^T are SS-form wgmma (the keys as rows), so
//   P^T and dS^T come out in the accumulator layout that is the A operand
//   of dV += P^T.dO and dK += dS^T.Q, RS-form wgmma with dO and Q
//   MN-major. P^T and dS^T are f32: each is split into bf16 hi + lo and
//   both products accumulate into the one f32 sum (rounding them once to
//   bf16 errs by up to 2^-8 of every weight, more than a bf16 ulp of an
//   output that cancels; hi + lo keeps 15 bits). Tile it's dV and dK
//   products run while P^T and dS^T of tile it + 1 are computed (its S^T
//   and dP^T are issued first and waited for alone).
// - dK/dV, causal: a block per (batch, kv head, 64 keys), so the LM
//   prefill (B 4, S 128, KV 8) has 64 blocks, not 32, and a 4,096-token
//   sequence 512. The block walks, for each head of its group, the query
//   tiles from its own to the one holding its last key + window - 1 (all
//   of which see some key of the block, so no tile is skipped). Both
//   warpgroups hold the block's 64 keys and take every other tile of the
//   walk (warpgroup it % 2 takes tile it, each loading its own tiles into
//   its own half of the ring, so neither waits on the other); at the end
//   warpgroup 1's dK and dV pass through shared memory and warpgroup 0 adds
//   them to its own, in that order. lse and D of a tile come by cp.async
//   from the loading warp's lanes, which arrive on the stage's `full` as
//   the copies land, so no warp waits on them. A tile's products run one
//   after the other inside a warpgroup (S^T and dP^T, then P^T and dS^T,
//   then dV and dK), while the other warpgroup's run: dk and dv (64 f32
//   registers a thread each at hd 128), S^T, dP^T and the split fragments
//   of one tile fit in 245 registers (ptxas -v, no spills), where the
//   non-causal kernel's overlap of two tiles spills at hd 112 and 128.
// - dQ: a block per (batch, head, 128 queries), each warpgroup's 64
//   queries one M tile; q and dO arrive once, k and v tiles of 64 keys
//   stream through the stages. S and dP are recomputed (SS-form), then
//   dQ += dS.K (RS-form, dS split hi + lo, K MN-major); a tile's dQ
//   products run while the next tile's dS is computed. The causal walk is
//   the forward's: the block's key tiles from the one holding max(0, q0 -
//   window + 1) to its last query's, each warpgroup the part its rows can
//   see (a tile it cannot see it waits for and releases, without a
//   product); the last query tiles run first.
// - P = 2^(s scale log2(e) - lse log2(e)), one fmaf and the hardware's
//   exp2 (exp2_ftz, swa_full.cuh: exp2f's handling of denormal results,
//   which no f32 sum here keeps, cost 22 % of the backward).
// - Masks, P = 0 on the accumulators after the product, only in the tiles
//   that hold a masked pair: query columns qi >= S of a ragged query tile
//   (dK/dV), keys kj >= S of a ragged key tile (dQ; in the causal mode
//   they lie past every row < S), and, in the causal mode, pairs past the
//   diagonal or outside the window (the TMA's zero rows would score 0);
//   rows >= S are never written.
//
// f32 (the f32 card-vs-CPU parity runs; the tensor cores take f32 only as
// TF32, which the port keeps off), on the CUDA cores: both modes one
// kernel of GQA-packed register tiles, dK/dV and dQ blocks in one launch
// (the f32 section below).
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

// D_i = do_i . o_i into (B, H, S): a row per 8 lanes. Lane j of a row's
// 8 reads the row's 16-byte pieces j, j + 8, ... of both operands (where
// vec16: rows of a multiple of 16 bytes, 16-byte aligned; else elements j,
// j + 8, ...), every load issued before the first product, one fmaf chain
// each; the 8 chains meet by shuffles in a fixed order (xor 4, 2, 1).
// (A thread a row left each warp's loads half-used 32-byte sectors and 5.7
// us at the LM prefill's 16,384 rows; a warp a row, one or two loads in
// flight a warp: PERF.md.)
constexpr int kDeltaLanes = 8;   // lanes a row
template <typename T>
__global__ void __launch_bounds__(256)
    full_bwd_delta(const T* __restrict__ o, const T* __restrict__ dout,
                   float* __restrict__ delta, int S, int H, int hd,
                   long long rows, int vec16) {
  constexpr int kVec = 16 / sizeof(T);              // elements a piece
  constexpr int kPieces = 128 / kVec / kDeltaLanes;  // a lane's, hd <= 128
  const long long row =
      (static_cast<long long>(blockIdx.x) * 256 + threadIdx.x) / kDeltaLanes;
  const int j = threadIdx.x % kDeltaLanes;
  float s = 0.0f;
  if (row < rows) {
    const T* orow = o + row * hd;
    const T* drow = dout + row * hd;
    if (vec16) {
      uint4 ov[kPieces], dv[kPieces];
#pragma unroll
      for (int u = 0; u < kPieces; ++u) {
        const int c = (j + kDeltaLanes * u) * kVec;
        if (c < hd) {
          ov[u] = *reinterpret_cast<const uint4*>(orow + c);
          dv[u] = *reinterpret_cast<const uint4*>(drow + c);
        }
      }
#pragma unroll
      for (int u = 0; u < kPieces; ++u) {
        if ((j + kDeltaLanes * u) * kVec >= hd) break;
        const T* op = reinterpret_cast<const T*>(&ov[u]);
        const T* dp = reinterpret_cast<const T*>(&dv[u]);
#pragma unroll
        for (int e = 0; e < kVec; ++e)
          s = fmaf(to_f32(dp[e]), to_f32(op[e]), s);
      }
    } else {
      for (int d = j; d < hd; d += kDeltaLanes)
        s = fmaf(to_f32(drow[d]), to_f32(orow[d]), s);
    }
  }
#pragma unroll
  for (int off = kDeltaLanes / 2; off > 0; off /= 2)
    s += __shfl_xor_sync(0xffffffffu, s, off);
  if (row >= rows || j != 0) return;
  // row = (b * S + i) * H + h  ->  delta[(b * H + h) * S + i]
  const long long h = row % H;
  const long long bi = row / H;
  const long long b = bi / S, i = bi % S;
  delta[(b * H + h) * S + i] = s;
}

struct BwdArgs {
  CUtensorMap q, k, v, dout;
  CUtensorMap dq_map, dk_map, dv_map;
  const bf16* qp;
  const bf16* kp;
  const bf16* vp;
  const bf16* dop;
  const float* lse;
  const float* delta;
  bf16* dq;
  bf16* dk;
  bf16* dv;
  int B, S, H, KV, hd;
  int window;  // the causal mode's window (keys j <= i, i - j < window)
  float scale;
  int tma;      // copies by TMA (else the loading warpgroup's threads)
  int tma_out;  // the causal mode's outputs by TMA (else 4-byte stores)
  int pair;     // 4-byte output stores
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
// bf16 dK/dV, causal
// ---------------------------------------------------------------------------

template <int HDP, int STAGES>
struct CausalDkdvLayout {
  static constexpr int kTile = kRows * HDP * 2;      // 64 rows
  static constexpr int kK = 0;                       // 64 rows
  static constexpr int kV = kK + kTile;              // 64 rows
  static constexpr int kQ = kV + kTile;              // [STAGES] tiles
  static constexpr int kDo = kQ + STAGES * kTile;    // [STAGES] tiles
  static constexpr int kLse = kDo + STAGES * kTile;  // [STAGES][64] f32
  static constexpr int kDl = kLse + STAGES * kRows * 4;
  static constexpr int kBar = kDl + STAGES * kRows * 4;
  // kv_full, full[STAGES]
  static constexpr int kBytes = kBar + 8 * (1 + STAGES) + 1024;
  // warpgroup 1's dK and dV at the end (f32, HDP a thread), over the q
  // and dO stages once the walk is done
  static constexpr int kPart = kQ;
  static_assert(kThreads / 2 * HDP * 4 <= 2 * STAGES * kTile, "partials");
};

// the block of (batch, kv head) bkv and the 64 keys from key tile kt's
// first
template <int HDP, int STAGES>
__device__ __forceinline__ void causal_dkdv_block(const BwdArgs& a,
                                                  unsigned char* smem_raw,
                                                  int bkv, int kt) {
  // warpgroup w takes the walk's tiles w, w + 2, ...: tile it + STAGES
  // is its own again, loaded into the stage it has just read
  static_assert(STAGES % 2 == 0, "a stage serves one warpgroup");
  using L = CausalDkdvLayout<HDP, STAGES>;
  unsigned char* sm = align1024(smem_raw);
  const uint32_t sa = smem_addr(sm);
  const uint32_t kv_full = sa + L::kBar;
  const auto full = [&](int st) { return sa + L::kBar + 8 * (1 + st); };
  float* lse_s = reinterpret_cast<float*>(sm + L::kLse);
  float* dl_s = reinterpret_cast<float*>(sm + L::kDl);
  const int t = threadIdx.x, wg = t / 128, tl = t % 128;
  const int S = a.S, H = a.H, W = a.window;
  const int G = H / a.KV;
  const int b = bkv / a.KV, kvh = bkv % a.KV;
  const int k0 = kt * kRows;
  // the walk: for each head of the group, the query tiles qa .. qa + nq - 1
  // that see a key of the block; tile it is head kvh G + it / nq, query
  // tile qa + it % nq
  const int qa = kt;
  const int nq = min(k0 + kRows - 1 + W - 1, S - 1) / kRows - qa + 1;
  const int n_it = G * nq;

  if (t == 0) {
    bar_init(kv_full, a.tma ? 1 : 128);
    for (int st = 0; st < STAGES; ++st) bar_init(full(st), a.tma ? 33 : 128);
    bar_init_fence();
  }
  __syncthreads();

  const long long q_stride = static_cast<long long>(H) * a.hd;
  // walk tile it's q, dO (TMA: the warpgroup's thread 0; else its 128
  // threads), lse and D (by cp.async from its warp 0's lanes, which
  // arrive on `full` as their copies land instead of waiting for them,
  // so warp 0 does not hold its warpgroup's next products back; or by
  // its 128 threads) into its stage, by warpgroup it % 2
  const auto load_q = [&](int it) {
    const int st = it % STAGES;
    const int hh = kvh * G + it / nq, q0 = (qa + it % nq) * kRows;
    if (a.tma) {
      if (tl >= 32) return;
      if (tl == 0) {
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
                     q_stride, q0, S, a.hd, tl, 128);
      copy_rows<HDP>(sm + L::kDo + st * L::kTile, kRows, 0, a.dop + q_off,
                     q_stride, q0, S, a.hd, tl, 128);
    }
    const long long row = (static_cast<long long>(b) * H + hh) * S;
    if (a.tma) {
      for (int e = tl; e < kRows; e += 32) {
        const int qi = q0 + e;
        const long long at = row + (qi < S ? qi : 0);
        cp_async4(sa + L::kLse + 4 * (st * kRows + e), a.lse + at, qi < S);
        cp_async4(sa + L::kDl + 4 * (st * kRows + e), a.delta + at, qi < S);
      }
      cp_async_arrive(full(st));
      return;
    }
    for (int e = tl; e < kRows; e += 128) {
      const int qi = q0 + e;
      lse_s[st * kRows + e] = qi < S ? a.lse[row + qi] : 0.0f;
      dl_s[st * kRows + e] = qi < S ? a.delta[row + qi] : 0.0f;
    }
    proxy_fence();
    bar_arrive(full(st));
  };
  if (wg == 0) {
    if (a.tma) {
      if (t == 0) {
        bar_expect(kv_full, 2 * L::kTile);
        tma_rows<HDP>(sa + L::kK, kRows, 0, a.k, kv_full, k0, kvh, b);
        tma_rows<HDP>(sa + L::kV, kRows, 0, a.v, kv_full, k0, kvh, b);
      }
    } else {
      const long long kv_stride = static_cast<long long>(a.KV) * a.hd;
      const long long kv_off = static_cast<long long>(b) * S * kv_stride +
                               static_cast<long long>(kvh) * a.hd;
      copy_rows<HDP>(sm + L::kK, kRows, 0, a.kp + kv_off, kv_stride, k0, S,
                     a.hd, t, 128);
      copy_rows<HDP>(sm + L::kV, kRows, 0, a.vp + kv_off, kv_stride, k0, S,
                     a.hd, t, 128);
      proxy_fence();
      bar_arrive(kv_full);
    }
  }
  for (int it = wg; it < STAGES && it < n_it; it += 2) load_q(it);

  // ---- both warpgroups: the block's keys k0 .. k0 + 63 as rows
  const int warp = tl / 32, lane = t % 32;
  const int g = lane / 4, tig = lane % 4;
  const int r0 = warp * 16 + g;  // this thread's rows of the key tile
  const int kj0 = k0 + r0;       // and its keys
  const int kj1 = kj0 + 8;
  const float scale = a.scale, scale_log2 = a.scale * kLog2e;
  float dk[HDP / 2], dv[HDP / 2], s[32], dp[32];
  uint32_t ph[16], pl[16], dh[16], dl[16];
#pragma unroll
  for (int i = 0; i < HDP / 2; ++i) dk[i] = dv[i] = 0.0f;

  const uint64_t k_desc = make_desc(sa + L::kK, 16);
  const uint64_t v_desc = make_desc(sa + L::kV, 16);
  const uint64_t q_desc = make_desc(sa + L::kQ, 16);
  const uint64_t do_desc = make_desc(sa + L::kDo, 16);
  const uint64_t q_mn = make_desc(sa + L::kQ, kRows * 32);
  const uint64_t do_mn = make_desc(sa + L::kDo, kRows * 32);
  // P^T in s, dS^T in dp of walk tile it: rows kj0, kj1, query column
  // 8n + 2tig + e; P = 0 outside the mask, in the tiles that hold a pair
  // outside it (the diagonal, the window's end, rows past S)
  const auto p_ds = [&](int it) {
    const int st = it % STAGES;
    const int q0 = (qa + it % nq) * kRows;
    const bool masked = q0 < k0 + kRows - 1 || q0 + kRows - 1 - k0 >= W ||
                        q0 + kRows > S;
    const float* ls = lse_s + st * kRows;
    const float* dls = dl_s + st * kRows;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = n * 8 + 2 * tig + e;
        const int qi = q0 + c;
        const bool in0 = !masked || (qi >= kj0 && qi - kj0 < W && qi < S);
        const bool in1 = !masked || (qi >= kj1 && qi - kj1 < W && qi < S);
        const float lc = ls[c] * kLog2e;  // lse in log2 units
        const float p0 =
            in0 ? exp2_ftz(fmaf(s[4 * n + e], scale_log2, -lc)) : 0.0f;
        const float p1 =
            in1 ? exp2_ftz(fmaf(s[4 * n + 2 + e], scale_log2, -lc)) : 0.0f;
        s[4 * n + e] = p0;
        s[4 * n + 2 + e] = p1;
        dp[4 * n + e] = p0 * (dp[4 * n + e] - dls[c]);
        dp[4 * n + 2 + e] = p1 * (dp[4 * n + 2 + e] - dls[c]);
      }
    }
  };

  bar_wait(kv_full, 0);
  for (int it = wg; it < n_it; it += 2) {
    const int st = it % STAGES;
    bar_wait(full(st), (it / STAGES) & 1);
    // S^T = K.Q^T, dP^T = V.dO^T: 64 keys x 64 queries
    fence_regs(dk);
    fence_regs(dv);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < HDP / kPiece; ++ks) {
      const uint32_t rows = kRows * 32 * ks;
      const uint32_t cols = st * L::kTile + kRows * 32 * ks;
      wgmma_ss64(s, desc_at(k_desc, rows), desc_at(q_desc, cols), ks > 0);
      wgmma_ss64(dp, desc_at(v_desc, rows), desc_at(do_desc, cols),
                 ks > 0);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(s);
    fence_regs(dp);
    p_ds(it);
    split_acc(s, ph, pl);
    split_acc(dp, dh, dl);
    // dV += P^T.dO, then dK += dS^T.Q, a k-step of 16 queries at a time
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
    wgmma_wait<0>();
    fence_regs(dk);
    fence_regs(dv);
    fence_regs(ph);
    fence_regs(pl);
    fence_regs(dh);
    fence_regs(dl);
    if (it + STAGES < n_it) {
      // every warp of the warpgroup is done with the stage (its products
      // and its lse and D reads): refill it with this warpgroup's next
      named_sync(1 + wg, 128);
      load_q(it + STAGES);
    }
  }

  // warpgroup 1's sums through shared memory (every tile's copy has been
  // waited for, every product read), added to warpgroup 0's in that order
  __syncthreads();
  float* part = reinterpret_cast<float*>(sm + L::kPart);
  if (wg == 1) {
#pragma unroll
    for (int i = 0; i < HDP / 2; ++i) {
      part[i * 128 + tl] = dk[i];
      part[(HDP / 2 + i) * 128 + tl] = dv[i];
    }
  }
  __syncthreads();
  if (wg == 1) return;
#pragma unroll
  for (int i = 0; i < HDP / 2; ++i) {
    dk[i] += part[i * 128 + tl];
    dv[i] += part[(HDP / 2 + i) * 128 + tl];
  }
  if (a.tma_out) {
    // dK and dV through k's and v's tiles (every product is done), then
    // out by TMA
#pragma unroll
    for (int i = 0; i < HDP / 8; ++i) {
      const int c = 8 * i + 2 * tig;
      put_pair(sm + L::kK, kRows, r0, c, dk[4 * i] * scale,
               dk[4 * i + 1] * scale);
      put_pair(sm + L::kK, kRows, r0 + 8, c, dk[4 * i + 2] * scale,
               dk[4 * i + 3] * scale);
      put_pair(sm + L::kV, kRows, r0, c, dv[4 * i], dv[4 * i + 1]);
      put_pair(sm + L::kV, kRows, r0 + 8, c, dv[4 * i + 2], dv[4 * i + 3]);
    }
    proxy_fence();
    named_sync(3, 128);
    if (t == 0) {
      tma_store_rows<HDP>(sa + L::kK, kRows, 0, a.dk_map, k0, kvh, b);
      tma_store_rows<HDP>(sa + L::kV, kRows, 0, a.dv_map, k0, kvh, b);
      tma_store_wait();
    }
    return;
  }
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
static_assert(CausalDkdvLayout<128, kBwdStages>::kBytes <= 232448, "smem");

// the block of (batch, head) bh and 128 queries from q0
template <int HDP, int STAGES, bool CAUSAL>
__device__ __forceinline__ void dq_block(const BwdArgs& a,
                                         unsigned char* smem_raw, int bh,
                                         int q0) {
  using L = DqLayout<HDP, STAGES>;
  unsigned char* sm = align1024(smem_raw);
  const uint32_t sa = smem_addr(sm);
  const uint32_t q_full = sa + L::kBar;
  const auto full = [&](int st) { return sa + L::kBar + 8 * (1 + st); };
  const auto empty = [&](int st) {
    return sa + L::kBar + 8 * (1 + STAGES + st);
  };
  const int wg = threadIdx.x / 128;
  const int S = a.S;
  const int b = bh / a.H, h = bh % a.H;
  const int kvh = h / (a.H / a.KV);
  // the block's walk: key tiles kb .. kb + nkt - 1, tile i of the walk in
  // stage i % STAGES (block indices i throughout below)
  const int kb = CAUSAL ? max(0, q0 - a.window + 1) / kRows : 0;
  const int nkt =
      (CAUSAL ? min(q0 + 2 * kRows, S) - 1 : S - 1) / kRows - kb + 1;

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
    const int st = kt % STAGES, row0 = (kb + kt) * kRows;
    if (a.tma) {
      if (t == 0) {
        bar_expect(full(st), 2 * L::kTile);
        tma_rows<HDP>(sa + L::kK + st * L::kTile, kRows, 0, a.k, full(st),
                      row0, kvh, b);
        tma_rows<HDP>(sa + L::kV + st * L::kTile, kRows, 0, a.v, full(st),
                      row0, kvh, b);
      }
    } else {
      copy_rows<HDP>(sm + L::kK + st * L::kTile, kRows, 0, a.kp + kv_off,
                     kv_stride, row0, S, a.hd, t, 128);
      copy_rows<HDP>(sm + L::kV + st * L::kTile, kRows, 0, a.vp + kv_off,
                     kv_stride, row0, S, a.hd, t, 128);
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
  const float* lse_bh = a.lse + static_cast<long long>(bh) * S;
  const float* dl_bh = a.delta + static_cast<long long>(bh) * S;
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
  // dS of walk tile kt in dp (rows qi0, qi1, key column 8n + 2tig + e);
  // P = 0 outside the mask, in the tiles that hold a pair outside it: the
  // ragged tail kj >= S, or, in the causal mode, keys past some row of
  // this warpgroup (the diagonal) or behind its window
  const auto ds = [&](int kt) {
    const int k0 = (kb + kt) * kRows, x0 = q0 + wg * kRows;
    const bool masked =
        CAUSAL ? k0 + kRows - 1 > x0 || x0 + kRows - 1 - k0 >= a.window
               : k0 + kRows > S;
    fence_regs(s);
    fence_regs(dp);
#pragma unroll
    for (int n = 0; n < 8; ++n) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int kj = k0 + n * 8 + 2 * tig + e;
        const bool in0 = !masked || (CAUSAL ? kj <= qi0 && qi0 - kj < a.window
                                            : kj < S);
        const bool in1 = !masked || (CAUSAL ? kj <= qi1 && qi1 - kj < a.window
                                            : kj < S);
        const float p0 =
            in0 ? exp2_ftz(fmaf(s[4 * n + e], scale_log2, -l0)) : 0.0f;
        const float p1 =
            in1 ? exp2_ftz(fmaf(s[4 * n + 2 + e], scale_log2, -l1)) : 0.0f;
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

  // this warpgroup's part of the walk: tiles i0 .. i1 (the causal mode:
  // those its rows, clamped to S - 1, can see; i0 <= 1 and i1 >= nkt - 2,
  // and warpgroup 0's i0 is 0, so it refills every stage in time). A tile
  // it cannot see it waits for and releases.
  int i0 = 0, i1 = nkt - 1;
  if (CAUSAL) {
    const int r0 = min(q0 + wg * kRows, S - 1);
    const int r1 = min(q0 + wg * kRows + kRows - 1, S - 1);
    i0 = max(0, r0 - a.window + 1) / kRows - kb;
    i1 = r1 / kRows - kb;
  }
  const auto skip = [&](int i) {
    bar_wait(full(i % STAGES), (i / STAGES) & 1);
    bar_arrive(empty(i % STAGES));
  };
  for (int i = 0; i < i0; ++i) skip(i);

  // Tile kt's dQ products run while the next tile's dS is computed (its
  // S and dP are issued first and waited for alone); the loop issues
  // unconditionally, the last tile's products after it
  bar_wait(q_full, 0);
  sdp_product(i0);
  wgmma_wait<0>();
  ds(i0);
  split_acc(dp, dh, dl);
  for (int kt = i0; kt < i1; ++kt) {
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
  dq_product(i1);
  retire(i1);
  for (int i = i1 + 1; i < nkt; ++i) skip(i);

  if (CAUSAL && a.tma_out) {
    // dQ through this warpgroup's 64 rows of q's tile (which only its own
    // products, all done, read), then out by TMA
    const int r = wg * kRows + warp * 16 + g;
#pragma unroll
    for (int i = 0; i < HDP / 8; ++i) {
      const int c = 8 * i + 2 * tig;
      put_pair(sm + L::kQ, 2 * kRows, r, c, dq[4 * i] * scale,
               dq[4 * i + 1] * scale);
      put_pair(sm + L::kQ, 2 * kRows, r + 8, c, dq[4 * i + 2] * scale,
               dq[4 * i + 3] * scale);
    }
    proxy_fence();
    named_sync(1 + wg, 128);
    if (threadIdx.x % 128 == 0) {
      tma_store_rows<HDP>(sa + L::kQ, 2 * kRows, wg * kRows, a.dq_map,
                          q0 + wg * kRows, h, b);
      tma_store_wait();
    }
    return;
  }
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

template <int HDP, int STAGES>
__global__ void __launch_bounds__(kThreads, 1)
    full_dq_kernel(const __grid_constant__ BwdArgs a) {
  extern __shared__ unsigned char smem_raw[];
  dq_block<HDP, STAGES, false>(a, smem_raw, blockIdx.y,
                               blockIdx.x * 2 * kRows);
}

// The causal mode's dK/dV and dQ blocks in one launch (both read D, which
// the pre-pass writes, and nothing the other writes): the dK/dV blocks
// first, key tile by key tile from the first (the longest walks), then the
// dQ blocks from the last query tile (the longest walks). At the LM
// prefill the 64 dK/dV blocks alone left half the card idle, and in a
// launch before dQ's took 22 of the backward's 44 us (PERF.md).
template <int HDP, int STAGES>
__global__ void __launch_bounds__(kThreads, 1)
    causal_bwd_kernel(const __grid_constant__ BwdArgs a) {
  extern __shared__ unsigned char smem_raw[];
  const int n_bkv = a.B * a.KV, n_bh = a.B * a.H;
  const int n_kv = n_bkv * ((a.S + kRows - 1) / kRows);
  const int nqt = (a.S + 2 * kRows - 1) / (2 * kRows);
  const int x = blockIdx.x;
  if (x < n_kv) {
    causal_dkdv_block<HDP, STAGES>(a, smem_raw, x % n_bkv, x / n_bkv);
  } else {
    const int y = x - n_kv;
    dq_block<HDP, STAGES, true>(a, smem_raw, y % n_bh,
                                (nqt - 1 - y / n_bh) * 2 * kRows);
  }
}

template <int HDP, bool CAUSAL>
int launch_bf16(BwdArgs& a, int B, int S, int H, int KV, int hd,
                cudaStream_t stream) {
  if (a.tma && !(make_map(&a.q, a.qp, B, S, H, hd) &&
                 make_map(&a.dout, a.dop, B, S, H, hd) &&
                 make_map(&a.k, a.kp, B, S, KV, hd) &&
                 make_map(&a.v, a.vp, B, S, KV, hd)))
    return static_cast<int>(cudaErrorNotSupported);
  a.tma_out = CAUSAL && a.tma && aligned16(a.dq) && aligned16(a.dk) &&
              aligned16(a.dv);
  if (a.tma_out && !(make_map(&a.dq_map, a.dq, B, S, H, hd) &&
                     make_map(&a.dk_map, a.dk, B, S, KV, hd) &&
                     make_map(&a.dv_map, a.dv, B, S, KV, hd)))
    return static_cast<int>(cudaErrorNotSupported);
  using LK = DkdvLayout<HDP, kBwdStages>;
  using LC = CausalDkdvLayout<HDP, kBwdStages>;
  using LQ = DqLayout<HDP, kBwdStages>;
  const int tiles = (S + 2 * kRows - 1) / (2 * kRows);
  if (CAUSAL) {
    const auto kernel = causal_bwd_kernel<HDP, kBwdStages>;
    const int bytes = LC::kBytes > LQ::kBytes ? LC::kBytes : LQ::kBytes;
    static unsigned attr_set = 0;
    const cudaError_t err = smem_attr_once(kernel, bytes, attr_set);
    if (err != cudaSuccess) return static_cast<int>(err);
    const long long blocks =
        static_cast<long long>(B) * KV * ((S + kRows - 1) / kRows) +
        static_cast<long long>(B) * H * tiles;
    if (blocks > 2147483647LL) return static_cast<int>(cudaErrorInvalidValue);
    kernel<<<static_cast<unsigned>(blocks), kThreads, bytes, stream>>>(a);
    return static_cast<int>(cudaGetLastError());
  }
  const auto dkdv = full_dkdv_kernel<HDP, kBwdStages>;
  const auto dq = full_dq_kernel<HDP, kBwdStages>;
  static unsigned dkdv_set = 0, dq_set = 0;
  cudaError_t err = smem_attr_once(dkdv, LK::kBytes, dkdv_set);
  if (err == cudaSuccess) err = smem_attr_once(dq, LQ::kBytes, dq_set);
  if (err != cudaSuccess) return static_cast<int>(err);
  dkdv<<<dim3(tiles, B * KV), kThreads, LK::kBytes, stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  dq<<<dim3(tiles, B * H), kThreads, LQ::kBytes, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// f32, both modes: CUDA cores, GQA-packed register tiles (swa_full.cuh),
// in one launch after the D pre-pass:
// the dK/dV blocks first (key tile 0, the longest causal walk, first),
// then the dQ blocks (the last query rows first; the two roles taken in
// turns measured the same, PERF.md). No atomics: each output is one fmaf
// chain in a fixed order, so the result is the same bits run to run. 128
// threads a block.
// - dK/dV: a block per (batch, kv head, CK keys) holds k and v of its
//   keys and walks the packed query rows that see them (the causal mode:
//   rows k0 G .. min(S, k_last + W) G - 1; every row otherwise), RQ rows
//   a step: q, dO, lse and D of a step by cp.async. The G heads of the
//   group are rows of the walk: the sum over the group and the queries is
//   one chain a key and column.
// - dQ: a block per (batch, kv head, RQ packed rows) holds q, dO, lse and
//   D of its rows and walks the key tiles they see (as the forward), k
//   and v of a tile by cp.async into one of two stages.
// Scores (S^T and dP^T, or S and dP) are 4 x 4 register tiles of a lane
// pair, neighbouring pairs on neighbouring keys of one row group: each
// lane sums half the head dim (columns 32 m + 16 h .. + 15, h its
// parity), then the pair trades the half of the tile the other keeps by
// one shuffle a value (the two halves added in one order), so 16 float4
// loads feed 64 FMAs of each lane. P and dS go through shared memory to
// the products into dv and dk (a thread: 4 keys, chunks tr + TRo u) and
// into dq (a thread: 4 rows, chunks cg + CGq u: a float4 of dS and one of
// k a key feed 16 FMAs a chunk).
// The tiles: CK 16 keys and RQ 64 rows at every S. (The rule fixed before
// the first card reading took CK 32, RQ 32 above S 16; at B4 S128 H32/8
// that reading put 195 of the backward's 210 us in the dK/dV blocks,
// whose longest walk, key tile 0's, was 16 steps: 16-key tiles halve it,
// PERF.md.) At B2 S16 H32/8 the 16 dK/dV blocks take the whole sequence,
// 64 rows, in one step and 16 dQ blocks one key tile each; at B4 S128
// H32/8 256 dK/dV blocks walk 1-8 steps and 256 dQ blocks 1-8. The dK/dV
// walk keeps one stage of q and dO (the next step's copies start when
// this step's products are done), so the footprint is 106 KB at hd 128
// and two blocks share an SM, one's copies under the other's products
// (two stages, 163 KB, one block an SM, were slower: PERF.md). Staging
// and the walk's rows advance (query, head) cursors, with no division a
// row (F32Cursor, swa_full.cuh), and the product loops clamp a chunk past
// the row instead of branching.
// What bounds it: 10 hd FLOP a pair inside the mask at the f32 CUDA-core
// rate: at B4 S128 H32/8 (1.35 GFLOP) 20 us; the dQ blocks recompute S and
// dP, 14 hd a pair in all. At B2 S16 its bytes (0.8 us), below two
// launches' latency.
// (It replaces the first causal kernels, three launches of 64 x 64 tiles
// whose dK/dV blocks walked the group's heads one after another, and the
// non-causal warp-a-row kernels, slower at the encoder's f32 shape B2 S200
// H4/2 hd80: PERF.md.)
// ---------------------------------------------------------------------------

struct F32BwdArgs {
  const float* q;
  const float* k;
  const float* v;
  const float* dout;
  const float* lse;
  const float* delta;
  float* dq;
  float* dk;
  float* dv;
  int B, S, H, KV, hd, window;
  int causal;
  float scale;
  int vec;  // 16-byte copies and stores
};

// stages of the dK/dV walk's q, dO, lse and D (1: a step's copies start
// when the step before is done; the dQ blocks' k and v take two)
constexpr int kF32DkdvStages = 1;

template <int CK, int RQ>
struct F32Bwd {
  static_assert(CK * RQ == 8 * kF32Threads, "64 lane pairs of 4 x 4 tiles");
  // dK/dV products: thread (tro, tko), keys 4 tko + j, chunks tro + TRo u
  static constexpr int kTRo = 4 * kF32Threads / CK;
  static constexpr int kNCHk = (kF32Chunks + kTRo - 1) / kTRo;
  // dQ products: thread (cg, rg), rows 4 rg + i, chunks cg + CGq u
  static constexpr int kCGq = 4 * kF32Threads / RQ;
  static constexpr int kNCHq = (kF32Chunks + kCGq - 1) / kCGq;
  // floats of a dK/dV stage: q, dO, lse, D
  static __host__ __device__ int stage(int P) { return 2 * RQ * P + 2 * RQ; }
  // bytes of shared memory at row pitch P, the larger of the two roles'
  static int bytes(int P) {
    const int dkdv =
        2 * CK * P + kF32DkdvStages * stage(P) + 2 * RQ * (CK + 4);
    const int dq = 2 * RQ * P + 4 * CK * P + CK * (RQ + 4);
    return 4 * (dkdv > dq ? dkdv : dq);
  }
};

// a lane's half of the head dim in a score product: columns 32 m + 16 h
// .. + 15 (h the lane's parity), four at a time; f(d) adds column d .. d
// + 3. Halves 16 columns apart start 4 bank groups apart, so a quarter
// warp's 8 lanes read 8 distinct groups from 4 rows
template <typename F>
__device__ __forceinline__ void f32_half_cols(int hd4, F f) {
  const int h = threadIdx.x & 1;
  for (int d0 = 16 * h; d0 < hd4; d0 += 32)
#pragma unroll
    for (int e = 0; e < 16; e += 4)
      if (d0 + e < hd4) f(d0 + e);
}

// the lane pair's trade: x[a][i] are this lane's partial sums over its
// half; afterwards y[a][i'] is the whole sum of x[a][2 h + i'], the half
// of the tile this lane keeps
__device__ __forceinline__ void f32_pair_sum(const float (&x)[4][4],
                                             float (&y)[4][2]) {
  const bool h = threadIdx.x & 1;
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float give = h ? x[a][i] : x[a][i + 2];
      const float keep = h ? x[a][i + 2] : x[a][i];
      y[a][i] = keep + __shfl_xor_sync(0xffffffffu, give, 1);
    }
}

template <int CK, int RQ>
__device__ __forceinline__ void f32_dkdv_block(const F32BwdArgs& a,
                                               float* fsm, int bkv, int kt) {
  using L = F32Bwd<CK, RQ>;
  constexpr int TRo = L::kTRo, NCH = L::kNCHk, PS = CK + 4, RG = RQ / 4;
  constexpr int KG = CK / 4;
  const int P = f32_pitch(a.hd);
  const int S = a.S, G = a.H / a.KV, n = S * G;
  const bool causal = a.causal != 0, vec = a.vec != 0;
  const int b = bkv / a.KV, kvh = bkv % a.KV;
  const F32Rows qrows = f32_rows(b, S, a.H, a.hd, kvh * G, G);
  const F32Rows krows = f32_rows(b, S, a.KV, a.hd, kvh, 1);
  float* k_s = fsm;                      // CK x P
  float* v_s = k_s + CK * P;             // CK x P
  float* st_s = v_s + CK * P;            // stages: q, dO, lse, D
  float* p_s = st_s + kF32DkdvStages * L::stage(P);  // P^T: RQ x PS
  float* ds_s = p_s + RQ * PS;           // dS^T: RQ rows x PS
  // the packed rows that see keys k0 .. klast
  const int k0 = kt * CK, klast = min(k0 + CK, S) - 1;
  const int pbeg = causal ? k0 * G : 0;
  const int pend =
      causal ? (a.window >= S - klast ? S : klast + a.window) * G : n;
  const int steps = (pend - pbeg + RQ - 1) / RQ;

  // lse (threads t < RQ) and D (t - RQ) of row t % RQ of each step: its
  // (query, head) by a cursor, one step of RQ rows at a time
  const int t = threadIdx.x;
  F32Cursor lrow;
  lrow.init(pbeg + t % RQ, RQ, G);
  const uint32_t sst = smem_addr(st_s);
  const auto stage = [&](int it) {
    const int pb = pbeg + it * RQ;
    const uint32_t base = sst + 4 * ((it % kF32DkdvStages) * L::stage(P));
    f32_stage<RQ, kF32Threads>(base, a.q, qrows, pb, P, vec);
    f32_stage<RQ, kF32Threads>(base + 4 * RQ * P, a.dout, qrows, pb, P,
                               vec);
    if (t < 2 * RQ) {
      const bool in = pb + t % RQ < n;
      const long long at =
          in ? (static_cast<long long>(b) * a.H + kvh * G + lrow.g) * S +
                   lrow.q
             : 0;
      cp_async4(base + 4 * (2 * RQ * P + t),
                (t < RQ ? a.lse : a.delta) + at, in);
      lrow.next(G);
    }
  };
  f32_stage<CK, kF32Threads>(smem_addr(k_s), a.k, krows, k0, P, vec);
  f32_stage<CK, kF32Threads>(smem_addr(v_s), a.v, krows, k0, P, vec);
  stage(0);
  cp_async_commit();

  const int nch = (a.hd + 3) / 4, hd4 = 4 * nch;
  // scores: lane pair (tk, tr) of tile t / 2, keys tk + KG j, rows tr + RG
  // i; this lane keeps rows i = 2 h + i'. Neighbouring pairs take
  // neighbouring keys of one row group: a warp's loads touch 4 rows and 4
  // keys of each half (8 distinct 16-byte pieces), where 32 rows a warp
  // made the score products wait on shared memory (PERF.md)
  const int h = t & 1, tk = (t >> 1) % KG, tr = (t >> 1) / KG;
  F32Cursor qrow[2];  // the queries of the kept rows, a step at a time
#pragma unroll
  for (int i = 0; i < 2; ++i)
    qrow[i].init(pbeg + tr + RG * (2 * h + i), RQ, G);
  // products: keys 4 tko + j, chunks tro + TRo u, clamped to the row (a
  // chunk past it repeats the last one's products and is never stored)
  const int tro = t % TRo, tko = t / TRo;
  int chs[NCH];
#pragma unroll
  for (int u = 0; u < NCH; ++u) chs[u] = min(tro + TRo * u, nch - 1);
  float4 dk[4][NCH], dv[4][NCH];
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int u = 0; u < NCH; ++u)
      dk[j][u] = dv[j][u] = make_float4(0.f, 0.f, 0.f, 0.f);

  for (int it = 0; it < steps; ++it) {
    if (kF32DkdvStages > 1 && it + 1 < steps) {
      stage(it + 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // step it (and k, v) is in every thread's view
    const float* q_s = st_s + (it % kF32DkdvStages) * L::stage(P);
    const float* do_s = q_s + RQ * P;
    const float* lse_s = do_s + RQ * P;
    const float* dl_s = lse_s + RQ;
    const int pb = pbeg + it * RQ;

    float s[4][4], dp[4][4];  // [key j][row i], this lane's half
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) s[j][i] = dp[j][i] = 0.0f;
    f32_half_cols(hd4, [&](int d) {
      float4 kb[4], vb[4], qa[4], da[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        kb[j] = ld4(k_s + (tk + KG * j) * P + d);
        vb[j] = ld4(v_s + (tk + KG * j) * P + d);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        qa[i] = ld4(q_s + (tr + RG * i) * P + d);
        da[i] = ld4(do_s + (tr + RG * i) * P + d);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          s[j][i] = dot4(kb[j], qa[i], s[j][i]);
          dp[j][i] = dot4(vb[j], da[i], dp[j][i]);
        }
    });
    float sk[4][2], dpk[4][2];
    f32_pair_sum(s, sk);
    f32_pair_sum(dp, dpk);
    // P = exp(s scale - lse) inside the mask (0 outside it and on rows
    // past S G), dS = P (dP - D)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = tr + RG * (2 * h + i), qi = qrow[i].q;
      const bool live = pb + r < n;
      qrow[i].next(G);
      const float ls = lse_s[r], dl = dl_s[r];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tk + KG * j, kj = k0 + c;
        const bool in =
            live && kj < S && f32_sees(qi, kj, S, a.window, causal);
        const float pr = in ? expf(sk[j][i] * a.scale - ls) : 0.0f;
        p_s[r * PS + c] = pr;
        ds_s[r * PS + c] = pr * (dpk[j][i] - dl);
      }
    }
    __syncthreads();  // every row's P^T and dS^T are in

    const int rows = min(RQ, pend - pb);  // rows past the walk add 0
    for (int r = 0; r < rows; ++r) {
      const float4 pv = ld4(p_s + r * PS + 4 * tko);
      const float4 dsv = ld4(ds_s + r * PS + 4 * tko);
#pragma unroll
      for (int u = 0; u < NCH; ++u) {
        const float4 dov = ld4(do_s + r * P + 4 * chs[u]);
        const float4 qv = ld4(q_s + r * P + 4 * chs[u]);
        axpy4(pv.x, dov, dv[0][u]);
        axpy4(pv.y, dov, dv[1][u]);
        axpy4(pv.z, dov, dv[2][u]);
        axpy4(pv.w, dov, dv[3][u]);
        axpy4(dsv.x, qv, dk[0][u]);
        axpy4(dsv.y, qv, dk[1][u]);
        axpy4(dsv.z, qv, dk[2][u]);
        axpy4(dsv.w, qv, dk[3][u]);
      }
    }
    __syncthreads();  // this stage, P^T and dS^T are read
    if (kF32DkdvStages == 1 && it + 1 < steps) {
      stage(it + 1);
      cp_async_commit();
    }
  }

#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int kj = k0 + 4 * tko + j;
    if (kj >= S) continue;
    float* dkr = a.dk + krows.off(kj);
    float* dvr = a.dv + krows.off(kj);
#pragma unroll
    for (int u = 0; u < NCH; ++u) {
      const int ch = tro + TRo * u;
      if (ch < nch) {
        f32_put(dkr, ch, a.hd, scale4(dk[j][u], a.scale), vec);
        f32_put(dvr, ch, a.hd, dv[j][u], vec);
      }
    }
  }
}

template <int CK, int RQ>
__device__ __forceinline__ void f32_dq_block(const F32BwdArgs& a, float* fsm,
                                             int bkv, int p0) {
  using L = F32Bwd<CK, RQ>;
  constexpr int CGq = L::kCGq, NCH = L::kNCHq, KG = CK / 4, RG = RQ / 4;
  constexpr int DS = RQ + 4;  // dS: CK keys x DS
  const int P = f32_pitch(a.hd);
  const int S = a.S, G = a.H / a.KV, n = S * G;
  const bool causal = a.causal != 0, vec = a.vec != 0;
  const int b = bkv / a.KV, kvh = bkv % a.KV;
  const F32Rows qrows = f32_rows(b, S, a.H, a.hd, kvh * G, G);
  const F32Rows krows = f32_rows(b, S, a.KV, a.hd, kvh, 1);
  float* q_s = fsm;                  // RQ x P
  float* do_s = q_s + RQ * P;        // RQ x P
  float* kv_s = do_s + RQ * P;       // stage st: k at st 2 CK P, v CK P on
  float* ds_s = kv_s + 4 * CK * P;   // CK x DS
  // the keys the block's queries i0 .. i1 see
  const int i0 = p0 / G, i1 = (min(p0 + RQ, n) - 1) / G;
  const int kbeg = causal ? max(0, i0 - a.window + 1) : 0;
  const int kend = causal ? i1 + 1 : S;
  const int steps = (kend - kbeg + CK - 1) / CK;

  const uint32_t skv = smem_addr(kv_s);
  const auto stage = [&](int it) {
    const uint32_t st = skv + 4 * ((it & 1) * 2 * CK * P);
    f32_stage<CK, kF32Threads>(st, a.k, krows, kbeg + it * CK, P, vec);
    f32_stage<CK, kF32Threads>(st + 4 * CK * P, a.v, krows, kbeg + it * CK,
                               P, vec);
  };
  f32_stage<RQ, kF32Threads>(smem_addr(q_s), a.q, qrows, p0, P, vec);
  f32_stage<RQ, kF32Threads>(smem_addr(do_s), a.dout, qrows, p0, P, vec);
  stage(0);
  cp_async_commit();

  const int t = threadIdx.x;
  const int nch = (a.hd + 3) / 4, hd4 = 4 * nch;
  // scores: lane pair (tr, tc) of tile t / 2, rows tr + RG i, keys tc + KG
  // j; this lane keeps rows i = 2 h + i'
  const int h = t & 1, tc = (t >> 1) % KG, tr = (t >> 1) / KG;
  int qi[2];
  bool live[2];
  float ls[2], dl[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int p = p0 + tr + RG * (2 * h + i);
    live[i] = p < n;
    qi[i] = p / G;
    const long long at =
        (static_cast<long long>(b) * a.H + kvh * G + p % G) * S + p / G;
    ls[i] = live[i] ? a.lse[at] : 0.0f;
    dl[i] = live[i] ? a.delta[at] : 0.0f;
  }
  // products: rows 4 rg + i, chunks cg + CGq u, clamped to the row
  const int cg = t % CGq, rg = t / CGq;
  int chs[NCH];
#pragma unroll
  for (int u = 0; u < NCH; ++u) chs[u] = min(cg + CGq * u, nch - 1);
  float4 acc[4][NCH];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int u = 0; u < NCH; ++u) acc[i][u] = make_float4(0.f, 0.f, 0.f, 0.f);

  for (int it = 0; it < steps; ++it) {
    if (it + 1 < steps) {
      stage(it + 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // tile it (and q, dO) is in every thread's view
    const float* k_s = kv_s + (it & 1) * 2 * CK * P;
    const float* v_s = k_s + CK * P;
    const int k0 = kbeg + it * CK;

    float s[4][4], dp[4][4];  // [row i][key j], this lane's half
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.0f;
    f32_half_cols(hd4, [&](int d) {
      float4 qa[4], da[4], kb[4], vb[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        qa[i] = ld4(q_s + (tr + RG * i) * P + d);
        da[i] = ld4(do_s + (tr + RG * i) * P + d);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        kb[j] = ld4(k_s + (tc + KG * j) * P + d);
        vb[j] = ld4(v_s + (tc + KG * j) * P + d);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = dot4(qa[i], kb[j], s[i][j]);
          dp[i][j] = dot4(da[i], vb[j], dp[i][j]);
        }
    });
    // this lane keeps rows 2 h + i': [key j][row i'] after the trade
    float sT[4][4], dpT[4][4], sk[4][2], dpk[4][2];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        sT[j][i] = s[i][j];
        dpT[j][i] = dp[i][j];
      }
    f32_pair_sum(sT, sk);
    f32_pair_sum(dpT, dpk);
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kj = k0 + tc + KG * j;
        const bool in =
            live[i] && kj < S && f32_sees(qi[i], kj, S, a.window, causal);
        const float pr = in ? expf(sk[j][i] * a.scale - ls[i]) : 0.0f;
        ds_s[(tc + KG * j) * DS + tr + RG * (2 * h + i)] =
            pr * (dpk[j][i] - dl[i]);
      }
    __syncthreads();  // every row's dS is in

    const int keys = min(CK, kend - k0);  // keys past the walk add 0
    for (int c = 0; c < keys; ++c) {
      const float4 dsv = ld4(ds_s + c * DS + 4 * rg);  // rows 4 rg ..
#pragma unroll
      for (int u = 0; u < NCH; ++u) {
        const float4 kb = ld4(k_s + c * P + 4 * chs[u]);
        axpy4(dsv.x, kb, acc[0][u]);
        axpy4(dsv.y, kb, acc[1][u]);
        axpy4(dsv.z, kb, acc[2][u]);
        axpy4(dsv.w, kb, acc[3][u]);
      }
    }
    __syncthreads();  // this stage and dS are read: the next copy may land
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int p = p0 + 4 * rg + i;
    if (p >= n) continue;
    float* dqr = a.dq + qrows.off(p);
#pragma unroll
    for (int u = 0; u < NCH; ++u)
      if (cg + CGq * u < nch)
        f32_put(dqr, cg + CGq * u, a.hd, scale4(acc[i][u], a.scale), vec);
  }
}

template <int CK, int RQ>
__global__ void __launch_bounds__(kF32Threads)
    f32_bwd_kernel(const F32BwdArgs a) {
  extern __shared__ float fsm[];
  const int nbkv = a.B * a.KV;
  const int nkv = nbkv * ((a.S + CK - 1) / CK);
  const int x = blockIdx.x;
  if (x < nkv) {
    f32_dkdv_block<CK, RQ>(a, fsm, x % nbkv, x / nbkv);
  } else {
    const int y = x - nkv;
    const int nqt = (a.S * (a.H / a.KV) + RQ - 1) / RQ;
    f32_dq_block<CK, RQ>(a, fsm, y % nbkv, (nqt - 1 - y / nbkv) * RQ);
  }
}

template <int CK, int RQ>
int launch_f32_bwd(const F32BwdArgs& a, cudaStream_t stream) {
  using L = F32Bwd<CK, RQ>;
  static unsigned attr_set = 0;
  const auto kernel = f32_bwd_kernel<CK, RQ>;
  const cudaError_t err =
      smem_attr_once(kernel, L::bytes(f32_pitch(128)), attr_set);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long nbkv = static_cast<long long>(a.B) * a.KV;
  const long long n = static_cast<long long>(a.S) * (a.H / a.KV);
  const long long blocks =
      nbkv * ((a.S + CK - 1) / CK) + nbkv * ((n + RQ - 1) / RQ);
  if (n > 2147483647LL || blocks > 2147483647LL)
    return static_cast<int>(cudaErrorInvalidValue);
  kernel<<<static_cast<unsigned>(blocks), kF32Threads,
           L::bytes(f32_pitch(a.hd)), stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace swa_full

// The backward's C entry point, every call (kernels/__init__.py): the D
// pre-pass, then the kernels of the dtype and mode (f32: the packed-tile
// kernel, both modes; bf16: the wgmma ones). q,
// k, v, o, dout and dq, dk, dv: (B, S, H or KV, hd), contiguous; lse: the
// forward's (B, H, S) f32 log-sum-exp; delta: (B, H, S) f32 scratch. causal: 1
// = the causal sliding window, 0 = every key (window unused). bf16: 0 =
// float32 operands (the CUDA cores), 1 = bfloat16 (the tensor cores).
extern "C" int swa_attention_bwd(const void* q, const void* k, const void* v,
                                 const void* o, const void* dout,
                                 const void* lse, void* delta, void* dq,
                                 void* dk, void* dv, int B, int S, int H,
                                 int KV, int hd, int window, int causal,
                                 float scale, int is_bf16, void* stream) {
  using namespace swa_full;
  if (hd < 1 || hd > 128 || KV < 1 || H % KV != 0 || window < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long rows = static_cast<long long>(B) * S * H;
  const long long delta_blocks =
      (rows * kDeltaLanes + 255) / 256;  // 32 rows a block
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

  if (!is_bf16) {
    F32BwdArgs f;
    f.q = static_cast<const float*>(q);
    f.k = static_cast<const float*>(k);
    f.v = static_cast<const float*>(v);
    f.dout = static_cast<const float*>(dout);
    f.lse = static_cast<const float*>(lse);
    f.delta = dl;
    f.dq = static_cast<float*>(dq);
    f.dk = static_cast<float*>(dk);
    f.dv = static_cast<float*>(dv);
    f.B = B;
    f.S = S;
    f.H = H;
    f.KV = KV;
    f.hd = hd;
    f.window = window;
    f.causal = causal;
    f.scale = scale;
    f.vec = hd % 4 == 0 && aligned16(q) && aligned16(k) && aligned16(v) &&
            aligned16(dout) && aligned16(dq) && aligned16(dk) &&
            aligned16(dv);
    return launch_f32_bwd<16, 64>(f, s);
  }
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
  a.B = B;
  a.S = S;
  a.H = H;
  a.KV = KV;
  a.hd = hd;
  a.window = window;
  a.scale = scale;
  a.tma = hd % 8 == 0 && aligned16(q) && aligned16(k) && aligned16(v) &&
          aligned16(dout);
  a.pair = hd % 2 == 0 && reinterpret_cast<uintptr_t>(dq) % 4 == 0 &&
           reinterpret_cast<uintptr_t>(dk) % 4 == 0 &&
           reinterpret_cast<uintptr_t>(dv) % 4 == 0;
  using Launch = int (*)(BwdArgs&, int, int, int, int, int, cudaStream_t);
  constexpr Launch by_hdp[2][8] = {
      {launch_bf16<16, false>, launch_bf16<32, false>,
       launch_bf16<48, false>, launch_bf16<64, false>,
       launch_bf16<80, false>, launch_bf16<96, false>,
       launch_bf16<112, false>, launch_bf16<128, false>},
      {launch_bf16<16, true>, launch_bf16<32, true>, launch_bf16<48, true>,
       launch_bf16<64, true>, launch_bf16<80, true>, launch_bf16<96, true>,
       launch_bf16<112, true>, launch_bf16<128, true>}};
  return by_hdp[causal ? 1 : 0][(hd + 15) / 16 - 1](a, B, S, H, KV, hd, s);
}
