// Fused RMSNorm, row-wise:  out = x * (1 / sqrt(mean(x^2) + eps)) * scale,
// the math in f32 and the result in x's dtype (f32 or bf16); scale is f32 or
// bf16.
//
// Replaces: src/repro/kernels/rmsnorm/kernel.py:23 `_rmsnorm_kernel`,
// launched by `rmsnorm` (:31, pallas_call at :43). The Pallas kernel keeps
// blocks of 256 rows x the whole D in VMEM. Rows are independent, so nothing
// of that tiling carries over: here a row belongs to one warp (D <= 1024) or
// to one block of 8 warps (D > 1024), and its sum of squares is reduced with
// warp shuffles (and, across warps, through shared memory).
//
// Shapes: x (n, D) contiguous, scale (D,), out (n, D).
//
// What bounds it on an H100: each element is read once and written once and
// costs ~4 FLOP, so the card's memory rate bounds it (3.35 TB/s). On the LM
// serving path x is bf16: (B*S, 4096) for ln1, ln2 and the final norm (f32
// scale) and (B*S*heads, 128) for q_norm and k_norm (bf16 scale).
//
// Design: pass 1 sums x^2 in f32 over the thread's strided elements
// (neighbouring threads on neighbouring addresses); pass 2 reads the row
// again - from L1/L2, a row is at most a few KB - scales it and stores it.
// The reciprocal is 1.0f / sqrtf(var + eps), both IEEE-rounded (no fast
// math), as `jnp.reciprocal(jnp.sqrt(...))` in the reference's
// layers/norms.py:10; the products keep the reference's order (x * inv) *
// scale. Only the order of the sum of squares differs from the plain
// version.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;  // 8 warps
constexpr int kWarps = kThreads / 32;

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
  return __float2bfloat16(v);  // round to nearest even, as torch's cast
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// One warp per row, 8 rows per block.
template <typename T, typename TS>
__global__ void rmsnorm_warp_rows(const T* __restrict__ x,
                                  const TS* __restrict__ scale,
                                  T* __restrict__ out, int n, int D,
                                  float eps) {
  const int lane = threadIdx.x & 31;
  const long long row =
      static_cast<long long>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  if (row >= n) return;
  const T* xr = x + row * D;
  T* outr = out + row * D;
  float ss = 0.0f;
  for (int i = lane; i < D; i += 32) {
    const float v = to_f32(xr[i]);
    ss = fmaf(v, v, ss);
  }
  ss = warp_sum(ss);
  const float inv = 1.0f / sqrtf(ss / static_cast<float>(D) + eps);
  for (int i = lane; i < D; i += 32)
    outr[i] = from_f32<T>(to_f32(xr[i]) * inv * to_f32(scale[i]));
}

// One block of 8 warps per row.
template <typename T, typename TS>
__global__ void rmsnorm_block_rows(const T* __restrict__ x,
                                   const TS* __restrict__ scale,
                                   T* __restrict__ out, int D, float eps) {
  __shared__ float partial[kWarps];
  __shared__ float inv_s;
  const long long row = blockIdx.x;
  const T* xr = x + row * D;
  T* outr = out + row * D;
  float ss = 0.0f;
  for (int i = threadIdx.x; i < D; i += kThreads) {
    const float v = to_f32(xr[i]);
    ss = fmaf(v, v, ss);
  }
  ss = warp_sum(ss);
  if ((threadIdx.x & 31) == 0) partial[threadIdx.x >> 5] = ss;
  __syncthreads();
  if (threadIdx.x < 32) {
    float v = threadIdx.x < kWarps ? partial[threadIdx.x] : 0.0f;
    v = warp_sum(v);
    if (threadIdx.x == 0)
      inv_s = 1.0f / sqrtf(v / static_cast<float>(D) + eps);
  }
  __syncthreads();
  const float inv = inv_s;
  for (int i = threadIdx.x; i < D; i += kThreads)
    outr[i] = from_f32<T>(to_f32(xr[i]) * inv * to_f32(scale[i]));
}

template <typename T, typename TS>
int launch(const void* x, const void* scale, void* out, int n, int D,
           float eps, cudaStream_t stream) {
  const T* xt = static_cast<const T*>(x);
  const TS* st = static_cast<const TS*>(scale);
  T* ot = static_cast<T*>(out);
  if (D <= 1024) {
    const int blocks = (n + kWarps - 1) / kWarps;
    rmsnorm_warp_rows<T, TS><<<blocks, kThreads, 0, stream>>>(xt, st, ot, n,
                                                              D, eps);
  } else {
    rmsnorm_block_rows<T, TS><<<n, kThreads, 0, stream>>>(xt, st, ot, D, eps);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x_bf16 / scale_bf16: 0 = float32, 1 = bfloat16.
extern "C" int rmsnorm_fwd(const void* x, const void* scale, void* out, int n,
                           int D, float eps, int x_bf16, int scale_bf16,
                           void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_bf16) {
    return scale_bf16
               ? launch<__nv_bfloat16, __nv_bfloat16>(x, scale, out, n, D,
                                                      eps, s)
               : launch<__nv_bfloat16, float>(x, scale, out, n, D, eps, s);
  }
  return scale_bf16 ? launch<float, __nv_bfloat16>(x, scale, out, n, D, eps, s)
                    : launch<float, float>(x, scale, out, n, D, eps, s);
}
