// RMSNorm backward, row-wise, given x, scale and dy (the forward's output
// cotangent): with r = 1 / sqrt(mean(x^2) + eps) recomputed per row,
//   dx     = r * (dy * scale) - x * r^3 * mean(dy * scale * x)
//   dscale = sum over rows of dy * (x * r)
// all in f32; dx comes out in x's dtype (f32 or bf16) and dscale in scale's.
//
// Replaces: the backward of src/repro/kernels/rmsnorm/kernel.py:23
// `_rmsnorm_kernel`, which has no Pallas backward: the reference's models
// differentiate the plain jnp `rms_norm` (layers/norms.py:7). The port sends
// every CUDA tensor through the hand kernel, so LM training on the card
// needs this one.
//
// Shapes: x, dy, dx (n, D) contiguous; scale, dscale (D,); partial
// (ceil(n / rows_per_chunk), D) f32 scratch.
//
// What bounds it on an H100: x and dy are read once and dx written once
// (plus D-sized scale and dscale), ~10 FLOP an element: the memory rate
// bounds it, 12.6 MB -> 3.8 us at the LM's ln (512 x 4096 bf16) and at its
// q_norm (16384 x 128 bf16).
//
// Design. dx is row-local: a row belongs to one warp (D <= 1024) or to one
// block of 8 warps (D > 1024), which reduce sum(x^2) and sum(dy*s*x) in one
// read of the row (warp shuffles; across warps through shared memory in a
// fixed order) and then read the row again, from L1/L2, to write dx.
// dscale is a sum across rows: pass 1 gives each block a fixed chunk of
// rows_per_chunk rows and each thread fixed columns, whose sums stay in
// registers over the chunk's rows in row order (the warps of a block then
// add theirs in warp order), and writes one partial row per chunk; pass 2
// adds the chunks' partials column by column, 32 warps a column each over
// every 32nd chunk, then the warps in order. No atomics: the result is
// bitwise the same run to run. The chunking is chosen by the caller from
// the shape alone.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;  // 8 warps
constexpr int kWarps = kThreads / 32;
constexpr int kMaxCols = 32;   // columns a thread owns: D <= 32 * 32 (warp
                               // rows) or D <= 32 * 256 (block rows)

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

__device__ __forceinline__ float warp_sum(float v) {
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// Pass 1, one warp per row: warp w of block b takes rows
// b * rows_per_chunk + w, + w + 8, ... of the block's chunk; lane l owns
// columns l, l + 32, ...
template <typename T, typename TS>
__global__ void __launch_bounds__(kThreads)
    rmsnorm_bwd_warp_rows(const T* __restrict__ x,
                          const TS* __restrict__ scale,
                          const T* __restrict__ dy, T* __restrict__ dx,
                          float* __restrict__ partial, int n, int D,
                          int rows_per_chunk, float eps) {
  __shared__ float warp_part[kWarps][kMaxCols * 32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long row0 = static_cast<long long>(blockIdx.x) * rows_per_chunk;
  const long long row_end = min(row0 + rows_per_chunk,
                                static_cast<long long>(n));
  float ds[kMaxCols];
#pragma unroll
  for (int c = 0; c < kMaxCols; ++c) ds[c] = 0.0f;
  for (long long row = row0 + warp; row < row_end; row += kWarps) {
    const T* xr = x + row * D;
    const T* dyr = dy + row * D;
    T* dxr = dx + row * D;
    float ss = 0.0f, sdx = 0.0f;
    for (int i = lane; i < D; i += 32) {
      const float v = to_f32(xr[i]);
      ss = fmaf(v, v, ss);
      sdx = fmaf(to_f32(dyr[i]) * to_f32(scale[i]), v, sdx);
    }
    ss = warp_sum(ss);
    sdx = warp_sum(sdx);
    const float r = 1.0f / sqrtf(ss / static_cast<float>(D) + eps);
    const float c3 = r * r * r * (sdx / static_cast<float>(D));
#pragma unroll
    for (int c = 0; c < kMaxCols; ++c) {
      const int i = lane + 32 * c;
      if (i < D) {
        const float v = to_f32(xr[i]);
        const float g = to_f32(dyr[i]);
        dxr[i] = from_f32<T>(r * (g * to_f32(scale[i])) - v * c3);
        ds[c] = fmaf(g, v * r, ds[c]);
      }
    }
  }
  // the warps' sums, added in warp order
#pragma unroll
  for (int c = 0; c < kMaxCols; ++c) {
    const int i = lane + 32 * c;
    if (i < D) warp_part[warp][i] = ds[c];
  }
  __syncthreads();
  for (int i = threadIdx.x; i < D; i += kThreads) {
    float s = warp_part[0][i];
    for (int w = 1; w < kWarps; ++w) s += warp_part[w][i];
    partial[static_cast<long long>(blockIdx.x) * D + i] = s;
  }
}

// Pass 1, one block per row: the block walks the rows of its chunk in
// order; thread t owns columns t, t + 256, ...
template <typename T, typename TS>
__global__ void __launch_bounds__(kThreads)
    rmsnorm_bwd_block_rows(const T* __restrict__ x,
                           const TS* __restrict__ scale,
                           const T* __restrict__ dy, T* __restrict__ dx,
                           float* __restrict__ partial, int n, int D,
                           int rows_per_chunk, float eps) {
  __shared__ float red[2][kWarps];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long row0 = static_cast<long long>(blockIdx.x) * rows_per_chunk;
  const long long row_end = min(row0 + rows_per_chunk,
                                static_cast<long long>(n));
  float ds[kMaxCols];
#pragma unroll
  for (int c = 0; c < kMaxCols; ++c) ds[c] = 0.0f;
  for (long long row = row0; row < row_end; ++row) {
    const T* xr = x + row * D;
    const T* dyr = dy + row * D;
    T* dxr = dx + row * D;
    float ss = 0.0f, sdx = 0.0f;
    for (int i = threadIdx.x; i < D; i += kThreads) {
      const float v = to_f32(xr[i]);
      ss = fmaf(v, v, ss);
      sdx = fmaf(to_f32(dyr[i]) * to_f32(scale[i]), v, sdx);
    }
    ss = warp_sum(ss);
    sdx = warp_sum(sdx);
    if (lane == 0) {
      red[0][warp] = ss;
      red[1][warp] = sdx;
    }
    __syncthreads();
    ss = red[0][0];
    sdx = red[1][0];
    for (int w = 1; w < kWarps; ++w) {
      ss += red[0][w];
      sdx += red[1][w];
    }
    __syncthreads();  // red is read before the next row writes it
    const float r = 1.0f / sqrtf(ss / static_cast<float>(D) + eps);
    const float c3 = r * r * r * (sdx / static_cast<float>(D));
#pragma unroll
    for (int c = 0; c < kMaxCols; ++c) {
      const int i = threadIdx.x + kThreads * c;
      if (i < D) {
        const float v = to_f32(xr[i]);
        const float g = to_f32(dyr[i]);
        dxr[i] = from_f32<T>(r * (g * to_f32(scale[i])) - v * c3);
        ds[c] = fmaf(g, v * r, ds[c]);
      }
    }
  }
#pragma unroll
  for (int c = 0; c < kMaxCols; ++c) {
    const int i = threadIdx.x + kThreads * c;
    if (i < D) partial[static_cast<long long>(blockIdx.x) * D + i] = ds[c];
  }
}

// Pass 2: dscale[i] = the chunks' partials of column i. A block takes 32
// columns (a lane each, so a warp's loads are one row's 32 neighbours);
// warp w adds chunks w, w + 32, ... in order, then the 32 warps' sums are
// added in warp order.
constexpr int kP2Warps = 32;

template <typename TS>
__global__ void __launch_bounds__(32 * kP2Warps)
    rmsnorm_bwd_dscale(const float* __restrict__ partial,
                       TS* __restrict__ dscale, int chunks, int D) {
  __shared__ float part[kP2Warps][33];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int i = blockIdx.x * 32 + lane;
  float s = 0.0f;
  if (i < D)
    for (int c = warp; c < chunks; c += kP2Warps)
      s += partial[static_cast<long long>(c) * D + i];
  part[warp][lane] = s;
  __syncthreads();
  if (warp == 0 && i < D) {
    float t = part[0][lane];
    for (int w = 1; w < kP2Warps; ++w) t += part[w][lane];
    dscale[i] = from_f32<TS>(t);
  }
}

template <typename T, typename TS>
int launch(const void* x, const void* scale, const void* dy, void* dx,
           float* partial, void* dscale, int n, int D, int rows_per_chunk,
           float eps, cudaStream_t stream) {
  if (D > kMaxCols * kThreads || rows_per_chunk < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const T* xt = static_cast<const T*>(x);
  const TS* st = static_cast<const TS*>(scale);
  const T* dyt = static_cast<const T*>(dy);
  T* dxt = static_cast<T*>(dx);
  const int chunks = (n + rows_per_chunk - 1) / rows_per_chunk;
  if (D <= 32 * kMaxCols) {
    rmsnorm_bwd_warp_rows<T, TS><<<chunks, kThreads, 0, stream>>>(
        xt, st, dyt, dxt, partial, n, D, rows_per_chunk, eps);
  } else {
    rmsnorm_bwd_block_rows<T, TS><<<chunks, kThreads, 0, stream>>>(
        xt, st, dyt, dxt, partial, n, D, rows_per_chunk, eps);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  rmsnorm_bwd_dscale<TS><<<(D + 31) / 32, 32 * kP2Warps, 0, stream>>>(
      partial, static_cast<TS*>(dscale), chunks, D);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x_bf16 / scale_bf16: 0 = float32, 1 = bfloat16 (dy and dx have x's dtype,
// dscale scale's). partial: ceil(n / rows_per_chunk) * D floats of scratch.
extern "C" int rmsnorm_bwd(const void* x, const void* scale, const void* dy,
                           void* dx, void* partial, void* dscale, int n,
                           int D, int rows_per_chunk, float eps, int x_bf16,
                           int scale_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* p = static_cast<float*>(partial);
  if (x_bf16) {
    return scale_bf16
               ? launch<__nv_bfloat16, __nv_bfloat16>(
                     x, scale, dy, dx, p, dscale, n, D, rows_per_chunk, eps, s)
               : launch<__nv_bfloat16, float>(x, scale, dy, dx, p, dscale, n,
                                              D, rows_per_chunk, eps, s);
  }
  return scale_bf16
             ? launch<float, __nv_bfloat16>(x, scale, dy, dx, p, dscale, n, D,
                                            rows_per_chunk, eps, s)
             : launch<float, float>(x, scale, dy, dx, p, dscale, n, D,
                                    rows_per_chunk, eps, s);
}
