// Backward of causal sliding-window flash attention with GQA. Given q, k, v,
// the forward's output o, its per-row log-sum-exp lse (natural log, of the
// scaled masked scores) and the output cotangent do:
//   P_ij  = exp(scale * q_i . k_j - lse_i)        (0 outside the mask)
//   D_i   = sum_d do_i,d o_i,d
//   dP_ij = do_i . v_j,    dS_ij = P_ij (dP_ij - D_i)
//   dq_i  = scale sum_j dS_ij k_j
//   dk_j  = scale sum_{h in the group} sum_i dS_ij q_i
//   dv_j  = sum_{h in the group} sum_i P_ij do_i
// over keys j <= i with i - j < window; G = H / KV query heads share a kv
// head. Every product and sum is f32; dq, dk and dv come out in q's dtype.
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
// Design: a simple kernel that is right first. Three launches:
// 1. swa_bwd_delta: D per row, one warp a row.
// 2. swa_bwd_dkdv: one block per (batch, kv head, 64-key tile). It walks the
//    G query heads of its group in order and, for each, the 64-query tiles
//    its keys can reach (from its own tile up to the one holding its last
//    key + window - 1), recomputes P and dS tile by tile, and keeps dk and
//    dv of its 64 keys in registers: the sum over the group and over the
//    queries stays inside the block, in one fixed order, with no atomics.
// 3. swa_bwd_dq: one block per (batch, head, 64-query tile) over the key
//    tiles of its window, dq in registers.
// Both main kernels stage their tiles in shared memory as f32 (bf16 loads
// widened), rows padded by one word, and multiply on the CUDA cores, 256
// threads a block, from register tiles: a thread holds the scores of 4
// queries x 4 keys (8 shared loads feed 16 FMAs of s and 16 of dp) and 32
// outputs, 4 rows x 8 columns (12 or 24 loads feed 32 or 64 FMAs). A
// thread's rows and columns lie 16 apart, so a warp's 16 distinct rows or
// columns fall in 16 banks. Each output is one fmaf chain in a fixed order
// (d, then the group's heads, query tiles and queries, or the key tiles
// and keys, ascending). The tensor cores (mma.sync, wgmma) are later work;
// this route's f32 products of bf16 operands are exact, so the kernel
// rounds only in its f32 sums.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

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
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

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
          const bool valid =
              qi < S && kj < S && kj <= qi && qi - kj < window;
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
        const bool valid = qi < S && kj < S && kj <= qi && qi - kj < window;
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

}  // namespace

// bf16: 0 = float32 operands, 1 = bfloat16. delta: (B, H, S) f32 scratch.
extern "C" int swa_attention_bwd(const void* q, const void* k, const void* v,
                                 const void* o, const void* dout,
                                 const void* lse, void* delta, void* dq,
                                 void* dk, void* dv, int B, int S, int H,
                                 int KV, int hd, int window, float scale,
                                 int bf16, void* stream) {
  if (hd < 1 || hd > kHdMax || KV < 1 || H % KV != 0 || window < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  float* dl = static_cast<float*>(delta);
  if (bf16)
    return launch<__nv_bfloat16>(q, k, v, o, dout, l, dl, dq, dk, dv, B, S,
                                 H, KV, hd, window, scale, s);
  return launch<float>(q, k, v, o, dout, l, dl, dq, dk, dv, B, S, H, KV, hd,
                       window, scale, s);
}
