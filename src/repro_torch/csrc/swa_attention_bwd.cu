// Backward of causal sliding-window flash attention with GQA (its
// non-causal mode, the encoder's attention over every key, is
// swa_full_bwd.cu's, where the entry point below sends it). Given q, k, v,
// the forward's output o, its per-row log-sum-exp lse (natural log, of the
// scaled masked scores) and the output cotangent do:
//   P_ij  = exp(scale * q_i . k_j - lse_i)        (0 outside the mask)
//   D_i   = sum_d do_i,d o_i,d
//   dP_ij = do_i . v_j,    dS_ij = P_ij (dP_ij - D_i)
//   dq_i  = scale sum_j dS_ij k_j
//   dk_j  = scale sum_{h in the group} sum_i dS_ij q_i
//   dv_j  = sum_{h in the group} sum_i P_ij do_i
// over keys j <= i with i - j < window; G = H / KV query heads share a kv
// head.
// Every product and sum is f32; dq, dk and dv come out in q's dtype.
//
// Replaces: the backward of src/repro/kernels/swa_attention/kernel.py:28
// `_swa_kernel`, which has no Pallas backward: the reference's models
// differentiate the plain jnp `_sdpa` (layers/attention.py:65). The port
// sends every CUDA tensor through the forward kernel, so LM training on the
// card needs this one.
//
// Shapes: q, o, do, dq (B, S, H, hd); k, v, dk, dv (B, S, KV, hd); lse and
// the scratch delta (B, H, S) f32; all contiguous; hd <= 128.
//
// What bounds it on an H100: q, k, v, o, do and lse are read once and dq,
// dk, dv written once, 21 MB at the LM's prefill shape (B 4, S 128, H 32,
// KV 8, hd 128, window = S, bf16): 6.3 us at 3.35 TB/s; the 10 hd FLOP of a
// (q, k) pair inside the mask (q.k again, do.v, and the three products into
// dq, dk, dv) come to 1.35 GFLOP there, 1.4 us at the bf16 tensor-core rate.
//
// Two routes, by dtype, as in the forward (swa_attention.cu):
// - float32 operands (the f32 card-vs-CPU parity runs): the CUDA-core
//   kernels below. The tensor cores take f32 only as TF32, which the port
//   keeps off.
// - bfloat16 operands (LM training): the tensor-core kernels at the end.
//
// Both routes: three launches behind one entry point.
// 1. swa_bwd_delta: D per row, one warp a row.
// 2. dK/dV: one block per (batch, kv head, key tile). It walks the G query
//    heads of its group in order and, for each, the query tiles its keys
//    can reach (from its own tile up to the one holding its last key +
//    window - 1), recomputes P and dS tile by tile, and keeps dk and dv of
//    its keys in registers: the sum over the group and over the queries
//    stays inside the block, in one fixed order, with no atomics, so the
//    result is bitwise the same run to run.
// 3. dQ: one block per (batch, head, 64-query tile) over the key tiles of
//    its window, dq in registers.
//
// f32 route: tiles staged in shared memory as f32, rows padded by one
// word, 64-key and 64-query tiles, 256 threads a block, products on the
// CUDA cores from register tiles: a thread holds the scores of 4 queries
// x 4 keys (8 shared loads feed 16 FMAs of s and 16 of dp) and 32
// outputs, 4 rows x 8 columns. A thread's rows and columns lie 16 apart,
// so a warp's 16 distinct rows or columns fall in 16 banks. Each output is
// one fmaf chain in a fixed order; the products of f32 operands round
// only in their f32 sums.
//
// bf16 route: every product on the tensor cores, mma.sync m16n8k16 bf16 x
// bf16 -> f32, with the forward's building blocks (16-byte cp.async,
// ldmatrix and ldmatrix.trans, rows padded to HDP + 8 elements, hd
// zero-padded to HDP, a multiple of 16).
// - S = Q.K^T and dP = dO.V^T take bf16 operands: their products are exact
//   in f32. dV = P^T.dO, dK = dS^T.Q and dQ = dS.K take an f32 P or dS,
//   split in registers into hi = bf16(x) and lo = bf16(x - hi), both
//   products accumulated into one f32 sum, as the forward does for P.V
//   (after src/repro/kernels/swa_attention/kernel.py:53-54): rounding P or
//   dS once to bf16 would err by up to 2^-8 of every weight, more than a
//   bf16 ulp of an output that cancels; hi + lo keeps 16 bits.
// - dK/dV block: 32 keys, 2 warps of 16 keys each in each of SPLIT warp
//   groups, so the prefill shape (B 4, S 128, KV 8) has 4 x 32 = 128
//   blocks for the 132 SMs (64 with 64-key tiles, measured slower). In the
//   causal mode the first key tile's blocks walk the most query tiles (the
//   causal triangle: 4 heads x 4 tiles at the prefill shape), so the SPLIT
//   groups
//   take every SPLIT-th tile of the walk, and at the end group 0 adds the
//   others' dK and dV in group order: the block's sum stays in one fixed
//   order. SPLIT is 4 when the grid has at most 132 blocks, else 2 (two
//   blocks an SM), from the shape alone.
//   A warp computes S^T = K.Q^T and dP^T = V.dO^T with its keys as rows,
//   so P^T and dS^T come out in the accumulator layout that is the
//   A-fragment of dV += P^T.dO and dK += dS^T.Q: they never go through
//   shared memory. K's and V's A-fragments come from shared memory by
//   ldmatrix; q and dO arrive in 32-query tiles by cp.async in two stages
//   (the next round's copies in flight while this round's tiles are
//   computed), with their rows' lse and D, as B-fragments by ldmatrix
//   (.trans for dV, dK). A thread holds dK and dV of its 2 key rows x HDP
//   / 4 columns (128 f32 registers at hd 128) and 16 scores each of S^T
//   and dP^T: 32-query tiles keep it at the 255-register cap (ptxas -v:
//   at hd 112 and 128, 28 to 204 bytes of spill loads a thread remain).
//   16-query tiles end the spills but were measured ~10 % slower (twice
//   the rounds and barriers for the same products; PERF.md).
// - dQ block: 4 warps, 16 queries each; k and v in 64-key tiles by
//   cp.async in two stages; q and dO stay in shared memory for the block.
// - Only the tiles that need it are masked (the diagonal, the window's
//   first key, rows past S); a warp skips a tile none of its rows can see.
// - D stays a pre-pass, so both main kernels read it.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kB = 64;          // query and key tile rows
constexpr int kThreads = 256;
constexpr int kHdMax = 128;
constexpr int kStride = 16;     // a thread's rows and columns lie 16 apart
constexpr int kR = kB / kStride;       // 4 query and 4 key rows a thread
constexpr int kC = kHdMax / kStride;   // 8 output columns a thread

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }

// rows row0 .. row0 + 63 of a (S, stride) operand -> a 64 x hd f32 tile of
// pitch hd + 1, a warp a row at a time; rows >= S are zeros
template <typename T>
__device__ __forceinline__ void stage(float* dst, const T* src,
                                      long long stride, int row0, int S,
                                      int hd) {
  const int hdp = hd + 1;
  for (int r = threadIdx.x / 32; r < kB; r += kThreads / 32) {
    const int gr = row0 + r;
    for (int d = threadIdx.x % 32; d < hd; d += 32)
      dst[r * hdp + d] = gr < S ? to_f32(src[gr * stride + d]) : 0.0f;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    swa_bwd_delta(const T* __restrict__ o, const T* __restrict__ dout,
                  float* __restrict__ delta, int S, int H, int hd,
                  long long rows) {
  const long long row =
      static_cast<long long>(blockIdx.x) * (kThreads / 32) + threadIdx.x / 32;
  if (row >= rows) return;
  const int lane = threadIdx.x % 32;
  const T* orow = o + row * hd;
  const T* drow = dout + row * hd;
  float s = 0.0f;
  for (int d = lane; d < hd; d += 32)
    s = fmaf(to_f32(drow[d]), to_f32(orow[d]), s);
  for (int off = 16; off > 0; off >>= 1)
    s += __shfl_xor_sync(0xffffffffu, s, off);
  if (lane == 0) {
    // row = (b * S + i) * H + h  ->  delta[(b * H + h) * S + i]
    const long long h = row % H;
    const long long bi = row / H;
    const long long b = bi / S, i = bi % S;
    delta[(b * H + h) * S + i] = s;
  }
}

size_t bwd_smem_bytes(int hd) {
  // four 64 x (hd + 1) tiles, two 64 x 65 score tiles, lse and delta
  return sizeof(float) * (4 * static_cast<size_t>(kB) * (hd + 1) +
                          2 * kB * (kB + 1) + 2 * kB);
}

// The 64 x 64 tile of scores s = q . k and dp = do . v of a thread:
// queries tq + 16 ii and keys tk + 16 jj (ii, jj < 4), each one fmaf chain
// over d in order. Rows 16 apart keep a warp's 16 key rows in 16 banks.
__device__ __forceinline__ void score_tiles(
    const float* q_s, const float* do_s, const float* k_s, const float* v_s,
    int hdp, int hd, int tq, int tk, float (&s)[kR][kR],
    float (&dp)[kR][kR]) {
#pragma unroll
  for (int ii = 0; ii < kR; ++ii)
#pragma unroll
    for (int jj = 0; jj < kR; ++jj) s[ii][jj] = dp[ii][jj] = 0.0f;
  for (int d = 0; d < hd; ++d) {
    float qv[kR], dov[kR], kv[kR], vv[kR];
#pragma unroll
    for (int i = 0; i < kR; ++i) {
      qv[i] = q_s[(tq + kStride * i) * hdp + d];
      dov[i] = do_s[(tq + kStride * i) * hdp + d];
      kv[i] = k_s[(tk + kStride * i) * hdp + d];
      vv[i] = v_s[(tk + kStride * i) * hdp + d];
    }
#pragma unroll
    for (int ii = 0; ii < kR; ++ii)
#pragma unroll
      for (int jj = 0; jj < kR; ++jj) {
        s[ii][jj] = fmaf(qv[ii], kv[jj], s[ii][jj]);
        dp[ii][jj] = fmaf(dov[ii], vv[jj], dp[ii][jj]);
      }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    swa_bwd_dkdv(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const T* __restrict__ dout,
                 const float* __restrict__ lse,
                 const float* __restrict__ delta, T* __restrict__ dk,
                 T* __restrict__ dv, int S, int H, int KV, int hd, int window,
                 float scale) {
  extern __shared__ float smem[];
  const int hdp = hd + 1;
  float* k_s = smem;                 // kB x hdp
  float* v_s = k_s + kB * hdp;       // kB x hdp
  float* q_s = v_s + kB * hdp;       // kB x hdp
  float* do_s = q_s + kB * hdp;      // kB x hdp
  float* p_s = do_s + kB * hdp;      // kB (queries) x (kB + 1)
  float* ds_s = p_s + kB * (kB + 1);  // kB x (kB + 1)
  float* lse_s = ds_s + kB * (kB + 1);
  float* dl_s = lse_s + kB;

  const int G = H / KV;
  const int k0 = blockIdx.x * kB;
  const int b = blockIdx.y / KV;
  const int kvh = blockIdx.y % KV;
  const long long q_stride = static_cast<long long>(H) * hd;
  const long long kv_stride = static_cast<long long>(KV) * hd;
  const long long kv_off = static_cast<long long>(b) * S * kv_stride +
                           static_cast<long long>(kvh) * hd;
  stage(k_s, k + kv_off, kv_stride, k0, S, hd);
  stage(v_s, v + kv_off, kv_stride, k0, S, hd);

  // scores: queries tq + 16 ii, keys tk + 16 jj; outputs: key rows
  // tk + 16 jj, columns tq + 16 cc
  const int tq = threadIdx.x / kStride;
  const int tk = threadIdx.x % kStride;
  float acc_k[kR][kC], acc_v[kR][kC];
#pragma unroll
  for (int jj = 0; jj < kR; ++jj)
#pragma unroll
    for (int cc = 0; cc < kC; ++cc) acc_k[jj][cc] = acc_v[jj][cc] = 0.0f;

  const int k_last = min(k0 + kB, S) - 1;
  const int qt_begin = k0 / kB;
  const int qt_end = min(S - 1, k_last + window - 1) / kB;
  for (int g = 0; g < G; ++g) {
    const int h = kvh * G + g;
    const long long q_off = static_cast<long long>(b) * S * q_stride +
                            static_cast<long long>(h) * hd;
    const float* lse_bh = lse + (static_cast<long long>(b) * H + h) * S;
    const float* dl_bh = delta + (static_cast<long long>(b) * H + h) * S;
    for (int qt = qt_begin; qt <= qt_end; ++qt) {
      const int q0 = qt * kB;
      __syncthreads();  // the last tile's q, do, P and dS are read
      stage(q_s, q + q_off, q_stride, q0, S, hd);
      stage(do_s, dout + q_off, q_stride, q0, S, hd);
      if (threadIdx.x < kB) {
        const int qi = q0 + threadIdx.x;
        lse_s[threadIdx.x] = qi < S ? lse_bh[qi] : 0.0f;
        dl_s[threadIdx.x] = qi < S ? dl_bh[qi] : 0.0f;
      }
      __syncthreads();

      float s[kR][kR], dp[kR][kR];
      score_tiles(q_s, do_s, k_s, v_s, hdp, hd, tq, tk, s, dp);
#pragma unroll
      for (int ii = 0; ii < kR; ++ii) {
        const int il = tq + kStride * ii;
        const int qi = q0 + il;
#pragma unroll
        for (int jj = 0; jj < kR; ++jj) {
          const int jl = tk + kStride * jj;
          const int kj = k0 + jl;
          const bool valid = qi < S && kj <= qi && qi - kj < window;
          const float p = valid ? expf(s[ii][jj] * scale - lse_s[il]) : 0.0f;
          p_s[il * (kB + 1) + jl] = p;
          ds_s[il * (kB + 1) + jl] = p * (dp[ii][jj] - dl_s[il]);
        }
      }
      __syncthreads();

      for (int il = 0; il < kB; ++il) {
        float pv[kR], dsv[kR], qv[kC], dov[kC];
#pragma unroll
        for (int jj = 0; jj < kR; ++jj) {
          pv[jj] = p_s[il * (kB + 1) + tk + kStride * jj];
          dsv[jj] = ds_s[il * (kB + 1) + tk + kStride * jj];
        }
#pragma unroll
        for (int cc = 0; cc < kC; ++cc) {
          const int c = tq + kStride * cc;
          qv[cc] = c < hd ? q_s[il * hdp + c] : 0.0f;
          dov[cc] = c < hd ? do_s[il * hdp + c] : 0.0f;
        }
#pragma unroll
        for (int jj = 0; jj < kR; ++jj)
#pragma unroll
          for (int cc = 0; cc < kC; ++cc) {
            acc_v[jj][cc] = fmaf(pv[jj], dov[cc], acc_v[jj][cc]);
            acc_k[jj][cc] = fmaf(dsv[jj], qv[cc], acc_k[jj][cc]);
          }
      }
    }
  }

#pragma unroll
  for (int jj = 0; jj < kR; ++jj) {
    const int kj = k0 + tk + kStride * jj;
    if (kj >= S) continue;
    T* dkr = dk + kv_off + static_cast<long long>(kj) * kv_stride;
    T* dvr = dv + kv_off + static_cast<long long>(kj) * kv_stride;
#pragma unroll
    for (int cc = 0; cc < kC; ++cc) {
      const int c = tq + kStride * cc;
      if (c < hd) {
        dkr[c] = from_f32<T>(acc_k[jj][cc] * scale);
        dvr[c] = from_f32<T>(acc_v[jj][cc]);
      }
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    swa_bwd_dq(const T* __restrict__ q, const T* __restrict__ k,
               const T* __restrict__ v, const T* __restrict__ dout,
               const float* __restrict__ lse, const float* __restrict__ delta,
               T* __restrict__ dq, int S, int H, int KV, int hd, int window,
               float scale) {
  extern __shared__ float smem[];
  const int hdp = hd + 1;
  float* q_s = smem;
  float* do_s = q_s + kB * hdp;
  float* k_s = do_s + kB * hdp;
  float* v_s = k_s + kB * hdp;
  float* ds_s = v_s + kB * hdp;      // kB (queries) x (kB + 1)
  float* lse_s = ds_s + 2 * kB * (kB + 1);
  float* dl_s = lse_s + kB;

  const int q0 = blockIdx.x * kB;
  const int b = blockIdx.y / H;
  const int h = blockIdx.y % H;
  const int kvh = h / (H / KV);
  const long long q_stride = static_cast<long long>(H) * hd;
  const long long kv_stride = static_cast<long long>(KV) * hd;
  const long long q_off = static_cast<long long>(b) * S * q_stride +
                          static_cast<long long>(h) * hd;
  const long long kv_off = static_cast<long long>(b) * S * kv_stride +
                           static_cast<long long>(kvh) * hd;
  stage(q_s, q + q_off, q_stride, q0, S, hd);
  stage(do_s, dout + q_off, q_stride, q0, S, hd);
  if (threadIdx.x < kB) {
    const int qi = q0 + threadIdx.x;
    const long long bh = static_cast<long long>(blockIdx.y) * S;
    lse_s[threadIdx.x] = qi < S ? lse[bh + qi] : 0.0f;
    dl_s[threadIdx.x] = qi < S ? delta[bh + qi] : 0.0f;
  }

  // scores: queries tq + 16 ii, keys tk + 16 jj; outputs: query rows
  // tq + 16 ii, columns tk + 16 cc
  const int tq = threadIdx.x / kStride;
  const int tk = threadIdx.x % kStride;
  float acc[kR][kC];
#pragma unroll
  for (int ii = 0; ii < kR; ++ii)
#pragma unroll
    for (int cc = 0; cc < kC; ++cc) acc[ii][cc] = 0.0f;

  const int q_last = min(q0 + kB, S) - 1;
  const int kt_begin = max(0, q0 - window + 1) / kB;
  const int kt_end = q_last / kB;
  for (int kt = kt_begin; kt <= kt_end; ++kt) {
    const int k0 = kt * kB;
    __syncthreads();  // q, do, lse, delta are in; the last tile is read
    stage(k_s, k + kv_off, kv_stride, k0, S, hd);
    stage(v_s, v + kv_off, kv_stride, k0, S, hd);
    __syncthreads();

    float s[kR][kR], dp[kR][kR];
    score_tiles(q_s, do_s, k_s, v_s, hdp, hd, tq, tk, s, dp);
#pragma unroll
    for (int ii = 0; ii < kR; ++ii) {
      const int il = tq + kStride * ii;
      const int qi = q0 + il;
#pragma unroll
      for (int jj = 0; jj < kR; ++jj) {
        const int jl = tk + kStride * jj;
        const int kj = k0 + jl;
        const bool valid = qi < S && kj <= qi && qi - kj < window;
        const float p = valid ? expf(s[ii][jj] * scale - lse_s[il]) : 0.0f;
        ds_s[il * (kB + 1) + jl] = p * (dp[ii][jj] - dl_s[il]);
      }
    }
    // a query row's dS is written and read by the 16 threads of one tq,
    // which share a warp
    __syncwarp();
    for (int jl = 0; jl < kB; ++jl) {
      float dsv[kR], kv[kC];
#pragma unroll
      for (int ii = 0; ii < kR; ++ii)
        dsv[ii] = ds_s[(tq + kStride * ii) * (kB + 1) + jl];
#pragma unroll
      for (int cc = 0; cc < kC; ++cc) {
        const int c = tk + kStride * cc;
        kv[cc] = c < hd ? k_s[jl * hdp + c] : 0.0f;
      }
#pragma unroll
      for (int ii = 0; ii < kR; ++ii)
#pragma unroll
        for (int cc = 0; cc < kC; ++cc)
          acc[ii][cc] = fmaf(dsv[ii], kv[cc], acc[ii][cc]);
    }
  }

#pragma unroll
  for (int ii = 0; ii < kR; ++ii) {
    const int qi = q0 + tq + kStride * ii;
    if (qi >= S) continue;
    T* dqr = dq + q_off + static_cast<long long>(qi) * q_stride;
#pragma unroll
    for (int cc = 0; cc < kC; ++cc) {
      const int c = tk + kStride * cc;
      if (c < hd) dqr[c] = from_f32<T>(acc[ii][cc] * scale);
    }
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const void* o,
           const void* dout, const float* lse, float* delta, void* dq,
           void* dk, void* dv, int B, int S, int H, int KV, int hd,
           int window, float scale, cudaStream_t stream) {
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  const T* dot = static_cast<const T*>(dout);
  const long long rows = static_cast<long long>(B) * S * H;
  const long long delta_blocks = (rows + kThreads / 32 - 1) / (kThreads / 32);
  if (delta_blocks > 2147483647LL)
    return static_cast<int>(cudaErrorInvalidValue);
  swa_bwd_delta<T><<<static_cast<unsigned>(delta_blocks), kThreads, 0,
                     stream>>>(static_cast<const T*>(o), dot, delta, S, H, hd,
                               rows);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  const size_t smem = bwd_smem_bytes(hd);
  err = cudaFuncSetAttribute(swa_bwd_dkdv<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(swa_bwd_dq<T>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int tiles = (S + kB - 1) / kB;
  swa_bwd_dkdv<T><<<dim3(tiles, B * KV), kThreads, smem, stream>>>(
      qt, kt, vt, dot, lse, delta, static_cast<T*>(dk), static_cast<T*>(dv),
      S, H, KV, hd, window, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  swa_bwd_dq<T><<<dim3(tiles, B * H), kThreads, smem, stream>>>(
      qt, kt, vt, dot, lse, delta, static_cast<T*>(dq), S, H, KV, hd, window,
      scale);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// bf16: tensor cores
// ---------------------------------------------------------------------------

constexpr int kKvWarps = 2;              // dK/dV block: 16 keys a warp
constexpr int kKvKeys = 16 * kKvWarps;   // keys a dK/dV block
// warp groups sharing a dK/dV block's query tiles, from the shape: 4 when
// the grid has at most one block for each of an H100's 132 SMs (the
// prefill's 128), else 2
constexpr int kKvFewBlocks = 132;
constexpr int kKvQ = 32;                 // queries a tile of the dK/dV block
constexpr int kQWarps = 4;               // dQ block: 16 queries a warp
constexpr int kQRows = 16 * kQWarps;     // queries a dQ block
constexpr int kQThreads = 32 * kQWarps;
constexpr int kQK = 64;                  // keys a tile of the dQ block

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 (or 4) bytes global -> shared; with in == false nothing is read and
// the bytes are written as zeros
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool in) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(in ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool in) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(in ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_prev() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p))
      : "memory");
}
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4],
                                              const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p))
      : "memory");
}

// c (16 x 8, f32) += a (16 x 16, bf16, row) . b (16 x 8, bf16, col)
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t as_u32(__nv_bfloat162 v) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(v.x)) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(v.y)) << 16);
}

// (x0, x1) -> the packed bf16 pairs of their high and low parts:
// |x - hi| <= 2^-8 |x| and |x - hi - lo| <= 2^-8 |x - hi| <= 2^-16 |x|
__device__ __forceinline__ void split_pair(float x0, float x1, uint32_t& hi,
                                           uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float2 hf = __bfloat1622float2(h);
  hi = as_u32(h);
  lo = as_u32(__floats2bfloat162_rn(x0 - hf.x, x1 - hf.y));
}

// The A-fragments (hi and lo) of a 16 x 16 slice whose two 8-wide column
// tiles are accumulators c0 and c1: the layout mma.sync leaves its sums in
// is the one it takes its row-major A in.
__device__ __forceinline__ void split_fragment(const float (&c0)[4],
                                               const float (&c1)[4],
                                               uint32_t (&hi)[4],
                                               uint32_t (&lo)[4]) {
  split_pair(c0[0], c0[1], hi[0], lo[0]);
  split_pair(c0[2], c0[3], hi[1], lo[1]);
  split_pair(c1[0], c1[1], hi[2], lo[2]);
  split_pair(c1[2], c1[3], hi[3], lo[3]);
}

template <int HDP>
__host__ __device__ constexpr int tc_pitch() {  // elements per shared row
  return HDP + 8;
}

// rows row0 .. row0 + ROWS - 1 of a (S, stride) bf16 operand -> a tile of
// pitch HDP + 8; rows >= S are zeros. vec16: 16-byte cp.async (hd == HDP
// with constant bounds, as in the forward: measured 12-16 % faster at hd
// 128 than the general loop alone); else 2-byte loads and stores, for hd
// not a multiple of 8 or an operand not 16-byte aligned.
template <int HDP, int ROWS, int THREADS>
__device__ __forceinline__ void tc_load_tile(bf16* dst, const bf16* src,
                                             long long stride, int row0,
                                             int S, int hd, bool vec16) {
  constexpr int pitch = tc_pitch<HDP>();
  if (vec16 && hd == HDP) {
    constexpr int kChunks = HDP / 8;  // 16-byte copies per row
#pragma unroll
    for (int i = 0; i < (ROWS * kChunks + THREADS - 1) / THREADS; ++i) {
      const int e = threadIdx.x + i * THREADS;
      if (ROWS * kChunks % THREADS == 0 || e < ROWS * kChunks) {
        const int r = e / kChunks, c = (e % kChunks) * 8;
        const int gr = row0 + r;
        const bool in = gr < S;
        cp_async16(dst + r * pitch + c, src + (in ? gr : 0) * stride + c,
                   in);
      }
    }
  } else if (vec16) {
    const int chunks = hd / 8;
    for (int e = threadIdx.x; e < ROWS * chunks; e += THREADS) {
      const int r = e / chunks, c = (e % chunks) * 8;
      const int gr = row0 + r;
      const bool in = gr < S;
      cp_async16(dst + r * pitch + c, src + (in ? gr : 0) * stride + c, in);
    }
  } else {
    for (int e = threadIdx.x; e < ROWS * hd; e += THREADS) {
      const int r = e / hd, c = e % hd;
      const int gr = row0 + r;
      dst[r * pitch + c] = gr < S ? src[gr * stride + c]
                                  : __float2bfloat16(0.0f);
    }
  }
}

// a warp's 16 rows of a shared tile -> rows row0 .. of a (S, stride)
// output, those < S only
template <int HDP>
__device__ __forceinline__ void tc_store_rows(bf16* dst, long long stride,
                                              int row0, int S, int hd,
                                              const bf16* src, bool vec16) {
  constexpr int pitch = tc_pitch<HDP>();
  const int lane = threadIdx.x % 32;
  if (vec16) {
    const int chunks = hd / 8;
    for (int e = lane; e < 16 * chunks; e += 32) {
      const int r = e / chunks, c = (e % chunks) * 8;
      if (row0 + r < S)
        *reinterpret_cast<uint4*>(dst + (row0 + r) * stride + c) =
            *reinterpret_cast<const uint4*>(src + r * pitch + c);
    }
  } else {
    for (int e = lane; e < 16 * hd; e += 32) {
      const int r = e / hd, c = e % hd;
      if (row0 + r < S) dst[(row0 + r) * stride + c] = src[r * pitch + c];
    }
  }
}

// 16 rows x HDP columns of f32 accumulators, times mul -> a warp's rows of
// a shared tile (the layout of mma.sync's C: rows g and g + 8, columns
// 8 d + 2 tig and + 1)
template <int HDP>
__device__ __forceinline__ void tc_put_rows(bf16* dst,
                                            const float (&acc)[HDP / 8][4],
                                            float mul) {
  constexpr int pitch = tc_pitch<HDP>();
  const int g = (threadIdx.x % 32) / 4, tig = threadIdx.x % 4;
#pragma unroll
  for (int d = 0; d < HDP / 8; ++d) {
    const int c = d * 8 + 2 * tig;
    *reinterpret_cast<__nv_bfloat162*>(dst + g * pitch + c) =
        __floats2bfloat162_rn(acc[d][0] * mul, acc[d][1] * mul);
    *reinterpret_cast<__nv_bfloat162*>(dst + (g + 8) * pitch + c) =
        __floats2bfloat162_rn(acc[d][2] * mul, acc[d][3] * mul);
  }
}

// acc (16 rows x HDP) += X . T over U 16-row k-steps: X's fragments are
// the f32 accumulators x (16 rows x 16U columns), split into bf16 hi and
// lo; T (16U rows x HDP, a shared tile of pitch HDP + 8) comes by
// ldmatrix.trans
template <int HDP, int U>
__device__ __forceinline__ void tc_accumulate(float (&acc)[HDP / 8][4],
                                              const float (&x)[2 * U][4],
                                              const bf16* t) {
  constexpr int kPitch = tc_pitch<HDP>();
  const int lane = threadIdx.x % 32;
  const int mi = lane / 8, mr = lane % 8;
#pragma unroll
  for (int u = 0; u < U; ++u) {
    uint32_t hi[4], lo[4];
    split_fragment(x[2 * u], x[2 * u + 1], hi, lo);
#pragma unroll
    for (int dd = 0; dd < HDP / 16; ++dd) {
      // matrices (transposed): (rows 16u.., d 16dd), (16u+8.., 16dd),
      // (16u.., 16dd+8), (16u+8.., 16dd+8)
      uint32_t b[4];
      ldsm_x4_trans(b, t + (u * 16 + (mi % 2) * 8 + mr) * kPitch + dd * 16 +
                           (mi / 2) * 8);
      mma_bf16(acc[2 * dd], hi, b[0], b[1]);
      mma_bf16(acc[2 * dd], lo, b[0], b[1]);
      mma_bf16(acc[2 * dd + 1], hi, b[2], b[3]);
      mma_bf16(acc[2 * dd + 1], lo, b[2], b[3]);
    }
  }
}

// The NS warp groups of a block hold partial sums of the same outputs in
// the same thread layout; group 0 adds the others' in group order
// (acc = ((acc_0 + acc_1) + acc_2) ...), through buf, (NS - 1) * NW * HDP
// * 16 floats of shared memory no longer read. sp: this warp's group, wl:
// its warp within the group.
template <int HDP, int NS, int NW>
__device__ __forceinline__ void sum_splits(float (&acc)[HDP / 8][4],
                                           float* buf, int sp, int wl) {
  constexpr int kN = HDP / 2;  // floats a thread
  const int lane = threadIdx.x % 32;
  if (sp > 0) {
    float* b = buf + ((sp - 1) * NW + wl) * kN * 32 + lane;
#pragma unroll
    for (int d = 0; d < HDP / 8; ++d)
#pragma unroll
      for (int e = 0; e < 4; ++e) b[(d * 4 + e) * 32] = acc[d][e];
  }
  __syncthreads();
  if (sp == 0) {
    for (int g = 1; g < NS; ++g) {
      const float* b = buf + ((g - 1) * NW + wl) * kN * 32 + lane;
#pragma unroll
      for (int d = 0; d < HDP / 8; ++d)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[d][e] += b[(d * 4 + e) * 32];
    }
  }
  __syncthreads();  // buf is read before it is written again
}

template <int HDP, int SPLIT>
constexpr size_t dkdv_smem_bytes() {
  // k and v (kKvKeys rows each), q and do (two stages of SPLIT tiles of
  // kKvQ rows each), then lse and D of both stages
  return sizeof(bf16) * (2 * kKvKeys + 4 * SPLIT * kKvQ) * tc_pitch<HDP>() +
         sizeof(float) * 4 * SPLIT * kKvQ;
}

template <int HDP>
constexpr size_t dq_smem_bytes() {
  // q and do (kQRows rows each), k and v (two stages of kQK rows each)
  return sizeof(bf16) * (2 * kQRows + 4 * kQK) * tc_pitch<HDP>();
}

template <int HDP, int SPLIT>
__global__ void __launch_bounds__(32 * kKvWarps * SPLIT)
    swa_bwd_dkdv_tc(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, const bf16* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, bf16* __restrict__ dk,
                    bf16* __restrict__ dv, int S, int H, int KV, int hd,
                    int window, float scale, int vec16) {
  constexpr int kPitch = tc_pitch<HDP>();
  constexpr int kKSteps = HDP / 16;  // k-steps of S^T and dP^T over hd
  constexpr int kDTiles = HDP / 8;   // 8-wide column tiles of dK, dV
  constexpr int kNTiles = kKvQ / 8;  // 8-query column tiles of S^T, dP^T
  constexpr int kTile = kKvQ * kPitch;
  constexpr int kKvThreads = 32 * kKvWarps * SPLIT;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* k_s = reinterpret_cast<bf16*>(smem_raw);  // [kKvKeys][kPitch]
  bf16* v_s = k_s + kKvKeys * kPitch;             // [kKvKeys][kPitch]
  bf16* q_s = v_s + kKvKeys * kPitch;   // [2][SPLIT][kKvQ][kPitch]
  bf16* do_s = q_s + 2 * SPLIT * kTile;        // the same
  float* lse_s = reinterpret_cast<float*>(do_s + 2 * SPLIT * kTile);
  float* dl_s = lse_s + 2 * SPLIT * kKvQ;      // [2][SPLIT][kKvQ]

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int kwi = warp % kKvWarps;  // this warp's 16 keys of the block
  const int sp = warp / kKvWarps;   // its group: every SPLIT-th tile
  const int g = lane / 4, tig = lane % 4;  // fragment row, column pair
  const int mi = lane / 8, mr = lane % 8;  // ldmatrix: matrix, row
  const int G = H / KV;
  const int k0 = blockIdx.x * kKvKeys;
  const int b = blockIdx.y / KV;
  const int kvh = blockIdx.y % KV;
  const long long q_stride = static_cast<long long>(H) * hd;
  const long long kv_stride = static_cast<long long>(KV) * hd;
  const long long kv_off = static_cast<long long>(b) * S * kv_stride +
                           static_cast<long long>(kvh) * hd;
  const bf16* qb = q + static_cast<long long>(b) * S * q_stride;
  const bf16* dob = dout + static_cast<long long>(b) * S * q_stride;
  const bool vec = vec16 != 0;

  // columns hd .. HDP-1 of every row are zero; no copy ever writes them
  if (hd < HDP) {
    const int pad = HDP - hd;
    for (int e = threadIdx.x;
         e < (2 * kKvKeys + 4 * SPLIT * kKvQ) * pad; e += kKvThreads)
      k_s[(e / pad) * kPitch + hd + e % pad] = __float2bfloat16(0.0f);
  }

  // the walk: tile `it` is head kvh * G + it / nq, query tile qt_begin +
  // it % nq; round r gives group sp tile r * SPLIT + sp
  const int k_last = min(k0 + kKvKeys, S) - 1;
  const int qt_begin = k0 / kKvQ;
  const int nq = min(S - 1, k_last + window - 1) / kKvQ - qt_begin + 1;
  const int n_it = G * nq;
  const int rounds = (n_it + SPLIT - 1) / SPLIT;
  auto stage_in = [&](int r, int st) {
    for (int j = 0; j < SPLIT; ++j) {
      const int it = r * SPLIT + j;
      if (it >= n_it) break;
      const int h = kvh * G + it / nq;
      const int q0 = (qt_begin + it % nq) * kKvQ;
      const int at = st * SPLIT + j;
      tc_load_tile<HDP, kKvQ, kKvThreads>(q_s + at * kTile, qb + h * hd,
                                          q_stride, q0, S, hd, vec);
      tc_load_tile<HDP, kKvQ, kKvThreads>(do_s + at * kTile, dob + h * hd,
                                          q_stride, q0, S, hd, vec);
      for (int e = threadIdx.x; e < kKvQ; e += kKvThreads) {
        const int qi = q0 + e;
        const bool in = qi < S;
        const long long row =
            (static_cast<long long>(b) * H + h) * S + (in ? qi : 0);
        cp_async4(lse_s + at * kKvQ + e, lse + row, in);
        cp_async4(dl_s + at * kKvQ + e, delta + row, in);
      }
    }
  };
  tc_load_tile<HDP, kKvKeys, kKvThreads>(k_s, k + kv_off, kv_stride, k0, S,
                                         hd, vec);
  tc_load_tile<HDP, kKvKeys, kKvThreads>(v_s, v + kv_off, kv_stride, k0, S,
                                         hd, vec);
  stage_in(0, 0);
  cp_async_commit();

  const int kw0 = k0 + kwi * 16;  // this warp's first key
  const int kj0 = kw0 + g;        // this thread's two key rows
  const int kj1 = kj0 + 8;
  bf16* kw_s = k_s + kwi * 16 * kPitch;
  bf16* vw_s = v_s + kwi * 16 * kPitch;
  float acc_k[kDTiles][4], acc_v[kDTiles][4];
#pragma unroll
  for (int d = 0; d < kDTiles; ++d)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc_k[d][e] = acc_v[d][e] = 0.0f;

  for (int r = 0; r < rounds; ++r) {
    const int st = r & 1;
    if (r + 1 < rounds) stage_in(r + 1, st ^ 1);
    cp_async_commit();
    cp_async_wait_prev();  // round r's tiles (and k, v) are in
    __syncthreads();
    const int it = r * SPLIT + sp;
    const int q0 = (qt_begin + it % nq) * kKvQ;
    // does any of this warp's keys see a query of the tile, and do all of
    // them see all of its queries?
    const bool live = it < n_it && kw0 < S && q0 + kKvQ - 1 >= kw0 &&
                      q0 - (kw0 + 15) < window;
    const bool masked = !(q0 >= kw0 + 15 && q0 + kKvQ - 1 - kw0 < window &&
                          q0 + kKvQ - 1 < S);
    if (live) {
      const int at = st * SPLIT + sp;
      const bf16* qs_ = q_s + at * kTile;
      const bf16* dos_ = do_s + at * kTile;
      const float* ls_ = lse_s + at * kKvQ;
      const float* dls_ = dl_s + at * kKvQ;
      // S^T = K.Q^T and dP^T = V.dO^T: this warp's 16 keys x 32 queries
      float s[kNTiles][4], dp[kNTiles][4];
#pragma unroll
      for (int n = 0; n < kNTiles; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.0f;
#pragma unroll
      for (int ks = 0; ks < kKSteps; ++ks) {
        uint32_t ka[4], va[4];
        ldsm_x4(ka, kw_s + (lane % 16) * kPitch + ks * 16 + (lane / 16) * 8);
        ldsm_x4(va, vw_s + (lane % 16) * kPitch + ks * 16 + (lane / 16) * 8);
#pragma unroll
        for (int np = 0; np < kNTiles / 2; ++np) {
          // matrices: (queries 16np.., d 16ks), (16np.., 16ks+8),
          // (16np+8.., 16ks), (16np+8.., 16ks+8)
          const int at2 = (np * 16 + (mi / 2) * 8 + mr) * kPitch + ks * 16 +
                          (mi % 2) * 8;
          uint32_t bq[4], bd[4];
          ldsm_x4(bq, qs_ + at2);
          ldsm_x4(bd, dos_ + at2);
          mma_bf16(s[2 * np], ka, bq[0], bq[1]);
          mma_bf16(s[2 * np + 1], ka, bq[2], bq[3]);
          mma_bf16(dp[2 * np], va, bd[0], bd[1]);
          mma_bf16(dp[2 * np + 1], va, bd[2], bd[3]);
        }
      }
      // P^T and dS^T in place: rows kj0, kj1, column 8n + 2tig + e
#pragma unroll
      for (int n = 0; n < kNTiles; ++n) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = n * 8 + 2 * tig + e;
          const int qi = q0 + c;
          const bool in0 =
              !masked || (qi < S && kj0 <= qi && qi - kj0 < window);
          const bool in1 =
              !masked || (qi < S && kj1 <= qi && qi - kj1 < window);
          const float p0 = in0 ? expf(s[n][e] * scale - ls_[c]) : 0.0f;
          const float p1 = in1 ? expf(s[n][2 + e] * scale - ls_[c]) : 0.0f;
          s[n][e] = p0;
          s[n][2 + e] = p1;
          dp[n][e] = p0 * (dp[n][e] - dls_[c]);
          dp[n][2 + e] = p1 * (dp[n][2 + e] - dls_[c]);
        }
      }
      // dV += P^T.dO, then dK += dS^T.Q, over the tile's queries (two
      // loops: one product's fragments live at a time)
      tc_accumulate<HDP, kKvQ / 16>(acc_v, s, dos_);
      tc_accumulate<HDP, kKvQ / 16>(acc_k, dp, qs_);
    }
    __syncthreads();  // round r's stage is read; it is refilled next
  }

  // the groups' sums in group order, through the stages' memory
  float* red = reinterpret_cast<float*>(q_s);
  sum_splits<HDP, SPLIT, kKvWarps>(acc_k, red, sp, kwi);
  sum_splits<HDP, SPLIT, kKvWarps>(acc_v, red, sp, kwi);
  if (sp != 0) return;
  // a warp's rows of k_s and v_s are no longer read: they take its dk and
  // dv for 16-byte stores
  tc_put_rows<HDP>(kw_s, acc_k, scale);
  tc_put_rows<HDP>(vw_s, acc_v, 1.0f);
  __syncwarp();
  tc_store_rows<HDP>(dk + kv_off, kv_stride, kw0, S, hd, kw_s, vec);
  tc_store_rows<HDP>(dv + kv_off, kv_stride, kw0, S, hd, vw_s, vec);
}

template <int HDP>
__global__ void __launch_bounds__(kQThreads)
    swa_bwd_dq_tc(const bf16* __restrict__ q, const bf16* __restrict__ k,
                  const bf16* __restrict__ v, const bf16* __restrict__ dout,
                  const float* __restrict__ lse,
                  const float* __restrict__ delta, bf16* __restrict__ dq,
                  int S, int H, int KV, int hd, int window, float scale,
                  int vec16) {
  constexpr int kPitch = tc_pitch<HDP>();
  constexpr int kKSteps = HDP / 16;  // k-steps of S and dP over hd
  constexpr int kDTiles = HDP / 8;   // 8-wide column tiles of dQ
  constexpr int kNTiles = kQK / 8;   // 8-key column tiles of S, dP
  constexpr int kTile = kQK * kPitch;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* q_s = reinterpret_cast<bf16*>(smem_raw);  // [kQRows][kPitch]
  bf16* do_s = q_s + kQRows * kPitch;             // [kQRows][kPitch]
  bf16* k_s = do_s + kQRows * kPitch;             // [2][kQK][kPitch]
  bf16* v_s = k_s + 2 * kTile;                    // [2][kQK][kPitch]

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, tig = lane % 4;
  const int mi = lane / 8, mr = lane % 8;
  const int q0 = blockIdx.x * kQRows;
  const int b = blockIdx.y / H;
  const int h = blockIdx.y % H;
  const int kvh = h / (H / KV);
  const long long q_stride = static_cast<long long>(H) * hd;
  const long long kv_stride = static_cast<long long>(KV) * hd;
  const long long q_off = static_cast<long long>(b) * S * q_stride +
                          static_cast<long long>(h) * hd;
  const long long kv_off = static_cast<long long>(b) * S * kv_stride +
                           static_cast<long long>(kvh) * hd;
  const bool vec = vec16 != 0;

  if (hd < HDP) {
    const int pad = HDP - hd;
    for (int e = threadIdx.x; e < (2 * kQRows + 4 * kQK) * pad;
         e += kQThreads)
      q_s[(e / pad) * kPitch + hd + e % pad] = __float2bfloat16(0.0f);
  }

  const int q_last = min(q0 + kQRows, S) - 1;
  const int kt_begin = max(0, q0 - window + 1) / kQK;
  const int kt_end = q_last / kQK;
  auto stage_in = [&](int kt, int st) {
    tc_load_tile<HDP, kQK, kQThreads>(k_s + st * kTile, k + kv_off,
                                      kv_stride, kt * kQK, S, hd, vec);
    tc_load_tile<HDP, kQK, kQThreads>(v_s + st * kTile, v + kv_off,
                                      kv_stride, kt * kQK, S, hd, vec);
  };
  tc_load_tile<HDP, kQRows, kQThreads>(q_s, q + q_off, q_stride, q0, S, hd,
                                       vec);
  tc_load_tile<HDP, kQRows, kQThreads>(do_s, dout + q_off, q_stride, q0, S,
                                       hd, vec);
  stage_in(kt_begin, 0);
  cp_async_commit();

  const int qw0 = q0 + warp * 16;  // this warp's first query
  const int qi0 = qw0 + g;        // this thread's two query rows
  const int qi1 = qi0 + 8;
  const float* lse_bh = lse + static_cast<long long>(blockIdx.y) * S;
  const float* dl_bh = delta + static_cast<long long>(blockIdx.y) * S;
  const float l0 = qi0 < S ? lse_bh[qi0] : 0.0f;
  const float l1 = qi1 < S ? lse_bh[qi1] : 0.0f;
  const float d0 = qi0 < S ? dl_bh[qi0] : 0.0f;
  const float d1 = qi1 < S ? dl_bh[qi1] : 0.0f;
  const bf16* qw_s = q_s + warp * 16 * kPitch;
  const bf16* dow_s = do_s + warp * 16 * kPitch;
  float acc[kDTiles][4];
#pragma unroll
  for (int d = 0; d < kDTiles; ++d)
    acc[d][0] = acc[d][1] = acc[d][2] = acc[d][3] = 0.0f;

  for (int kt = kt_begin; kt <= kt_end; ++kt) {
    const int st = (kt - kt_begin) & 1;
    if (kt < kt_end) stage_in(kt + 1, st ^ 1);
    cp_async_commit();
    cp_async_wait_prev();  // tile kt (and q, do) are in
    __syncthreads();
    const int k0 = kt * kQK;
    const bool live =
        qw0 < S && k0 <= qw0 + 15 && qw0 - (k0 + kQK - 1) < window;
    const bool masked =
        k0 + kQK - 1 > qw0 || qw0 + 15 - k0 >= window || qw0 + 15 >= S;
    if (live) {
      const bf16* ks_ = k_s + st * kTile;
      const bf16* vs_ = v_s + st * kTile;
      // S = Q.K^T and dP = dO.V^T: this warp's 16 queries x 64 keys
      float s[kNTiles][4], dp[kNTiles][4];
#pragma unroll
      for (int n = 0; n < kNTiles; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.0f;
#pragma unroll
      for (int ks = 0; ks < kKSteps; ++ks) {
        uint32_t qa[4], da[4];
        ldsm_x4(qa, qw_s + (lane % 16) * kPitch + ks * 16 + (lane / 16) * 8);
        ldsm_x4(da, dow_s + (lane % 16) * kPitch + ks * 16 + (lane / 16) * 8);
#pragma unroll
        for (int np = 0; np < kNTiles / 2; ++np) {
          const int at2 = (np * 16 + (mi / 2) * 8 + mr) * kPitch + ks * 16 +
                          (mi % 2) * 8;
          uint32_t bk[4], bv[4];
          ldsm_x4(bk, ks_ + at2);
          ldsm_x4(bv, vs_ + at2);
          mma_bf16(s[2 * np], qa, bk[0], bk[1]);
          mma_bf16(s[2 * np + 1], qa, bk[2], bk[3]);
          mma_bf16(dp[2 * np], da, bv[0], bv[1]);
          mma_bf16(dp[2 * np + 1], da, bv[2], bv[3]);
        }
      }
      // dS in place of S: rows qi0, qi1, key 8n + 2tig + e
#pragma unroll
      for (int n = 0; n < kNTiles; ++n) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int kj = k0 + n * 8 + 2 * tig + e;
          const bool in0 =
              !masked || (qi0 < S && kj <= qi0 && qi0 - kj < window);
          const bool in1 =
              !masked || (qi1 < S && kj <= qi1 && qi1 - kj < window);
          const float p0 = in0 ? expf(s[n][e] * scale - l0) : 0.0f;
          const float p1 = in1 ? expf(s[n][2 + e] * scale - l1) : 0.0f;
          s[n][e] = p0 * (dp[n][e] - d0);
          s[n][2 + e] = p1 * (dp[n][2 + e] - d1);
        }
      }
      // dQ += dS.K over the tile's keys
      tc_accumulate<HDP, kQK / 16>(acc, s, ks_);
    }
    __syncthreads();  // tile kt is read; its stage is refilled next
  }

  // a warp's rows of q_s are read by that warp alone: they take its dq
  bf16* out_s = q_s + warp * 16 * kPitch;
  tc_put_rows<HDP>(out_s, acc, scale);
  __syncwarp();
  tc_store_rows<HDP>(dq + q_off, q_stride, qw0, S, hd, out_s, vec);
}

template <int HDP, int SPLIT>
cudaError_t launch_dkdv(const bf16* q, const bf16* k, const bf16* v,
                        const bf16* dout, const float* lse,
                        const float* delta, void* dk, void* dv, int B, int S,
                        int H, int KV, int hd, int window, float scale,
                        int vec16, cudaStream_t stream) {
  constexpr size_t smem = dkdv_smem_bytes<HDP, SPLIT>();
  const cudaError_t err = cudaFuncSetAttribute(
      swa_bwd_dkdv_tc<HDP, SPLIT>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  swa_bwd_dkdv_tc<HDP, SPLIT>
      <<<dim3((S + kKvKeys - 1) / kKvKeys, B * KV), 32 * kKvWarps * SPLIT,
         smem, stream>>>(q, k, v, dout, lse, delta, static_cast<bf16*>(dk),
                         static_cast<bf16*>(dv), S, H, KV, hd, window, scale,
                         vec16);
  return cudaGetLastError();
}

template <int HDP>
int launch_tc(const void* q, const void* k, const void* v, const void* o,
              const void* dout, const float* lse, float* delta, void* dq,
              void* dk, void* dv, int B, int S, int H, int KV, int hd,
              int window, float scale, cudaStream_t stream) {
  const auto aligned = [](const void* p) {
    return reinterpret_cast<uintptr_t>(p) % 16 == 0;
  };
  const int vec16 = hd % 8 == 0 && aligned(q) && aligned(k) && aligned(v) &&
                    aligned(o) && aligned(dout) && aligned(dq) &&
                    aligned(dk) && aligned(dv);
  const bf16* qt = static_cast<const bf16*>(q);
  const bf16* kt = static_cast<const bf16*>(k);
  const bf16* vt = static_cast<const bf16*>(v);
  const bf16* dot = static_cast<const bf16*>(dout);
  const long long rows = static_cast<long long>(B) * S * H;
  const long long delta_blocks = (rows + kThreads / 32 - 1) / (kThreads / 32);
  if (delta_blocks > 2147483647LL)
    return static_cast<int>(cudaErrorInvalidValue);
  swa_bwd_delta<bf16><<<static_cast<unsigned>(delta_blocks), kThreads, 0,
                        stream>>>(static_cast<const bf16*>(o), dot, delta, S,
                                  H, hd, rows);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  const long long kv_blocks =
      static_cast<long long>((S + kKvKeys - 1) / kKvKeys) * B * KV;
  err = kv_blocks <= kKvFewBlocks
            ? launch_dkdv<HDP, 4>(qt, kt, vt, dot, lse, delta, dk, dv, B, S,
                                  H, KV, hd, window, scale, vec16, stream)
            : launch_dkdv<HDP, 2>(qt, kt, vt, dot, lse, delta, dk, dv, B, S,
                                  H, KV, hd, window, scale, vec16, stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  constexpr size_t q_smem = dq_smem_bytes<HDP>();
  err = cudaFuncSetAttribute(swa_bwd_dq_tc<HDP>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(q_smem));
  // the most shared memory the SM can give, so two dQ blocks fit at hd 128
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(swa_bwd_dq_tc<HDP>,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return static_cast<int>(err);
  swa_bwd_dq_tc<HDP>
      <<<dim3((S + kQRows - 1) / kQRows, B * H), kQThreads, q_smem, stream>>>(
          qt, kt, vt, dot, lse, delta, static_cast<bf16*>(dq), S, H, KV, hd,
          window, scale, vec16);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// swa_full_bwd.cu: the non-causal mode
extern "C" int swa_full_bwd(const void* q, const void* k, const void* v,
                            const void* o, const void* dout, const void* lse,
                            void* delta, void* dq, void* dk, void* dv, int B,
                            int S, int H, int KV, int hd, float scale,
                            int bf16, void* stream);

// bf16: 0 = float32 operands (CUDA cores), 1 = bfloat16 (tensor cores).
// delta: (B, H, S) f32 scratch. causal: 1 = the causal sliding window,
// 0 = every key (window unused), as the forward's entry takes it.
extern "C" int swa_attention_bwd(const void* q, const void* k, const void* v,
                                 const void* o, const void* dout,
                                 const void* lse, void* delta, void* dq,
                                 void* dk, void* dv, int B, int S, int H,
                                 int KV, int hd, int window, int causal,
                                 float scale, int bf16, void* stream) {
  if (hd < 1 || hd > kHdMax || KV < 1 || H % KV != 0 || window < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (!causal)
    return swa_full_bwd(q, k, v, o, dout, lse, delta, dq, dk, dv, B, S, H,
                        KV, hd, scale, bf16, stream);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  float* dl = static_cast<float*>(delta);
  if (!bf16)
    return launch<float>(q, k, v, o, dout, l, dl, dq, dk, dv, B, S, H, KV, hd,
                         window, scale, s);
  using Launch = int (*)(const void*, const void*, const void*, const void*,
                         const void*, const float*, float*, void*, void*,
                         void*, int, int, int, int, int, int, float,
                         cudaStream_t);
  constexpr Launch by_hdp[] = {launch_tc<16>, launch_tc<32>,  launch_tc<48>,
                               launch_tc<64>, launch_tc<80>,  launch_tc<96>,
                               launch_tc<112>, launch_tc<128>};
  return by_hdp[(hd + 15) / 16 - 1](q, k, v, o, dout, l, dl, dq, dk, dv, B, S,
                                    H, KV, hd, window, scale, s);
}
