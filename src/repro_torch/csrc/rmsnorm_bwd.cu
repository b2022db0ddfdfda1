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
// Shapes: x, dy, dx (n, D) contiguous, D <= 8192; scale, dscale (D,);
// partial (ceil(n / rows_per_chunk), D) f32 scratch.
//
// What bounds it on an H100: x and dy are read once and dx written once
// (plus D-sized scale and dscale), ~10 FLOP an element: the memory rate
// bounds it, 12.6 MB -> 3.8 us at the LM's ln (512 x 4096 bf16) and at its
// q_norm (16384 x 128 bf16).
//
// Design: two launches.
// 1. Rows. A row belongs to tpr threads (a power of two up to a warp, or
//    the whole block of 256), which load it once, as 16-byte vectors where
//    the row is 16-byte aligned (else element by element), keep its x and
//    dy in registers, reduce sum(x^2) and sum(dy*s*x) (shuffles; across
//    warps through shared memory in warp order) and write dx from the
//    registers; the next row's loads are issued before this row's sums.
//    At ln that is 16 bf16 values each of x and dy a thread; at q_norm 16
//    threads a row, one vector each. Block b takes the rows_per_chunk rows
//    of chunk b (a function of the shape alone); a thread keeps its
//    columns' dscale sums in registers over its rows in order, the row
//    groups of the block are added in group order, and the block writes
//    one partial row.
// 2. dscale[c]: the chunks' partial rows added in a fixed order, 16-byte
//    loads where D allows, each of 32 warps of a block over a contiguous
//    run of chunks (8 loads in flight), then the runs in run order.
// No float atomics: dscale is bitwise the same run to run. Folding pass 2
// into pass 1 (a cluster of 8 blocks adding its rows through distributed
// shared memory, the last block of each column slice adding the clusters'
// rows) was measured slower: a cluster launch and its barriers cost more
// than the second launch saves (PERF.md).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;  // 8 warps
constexpr int kWarps = kThreads / 32;
constexpr int kMaxD = 8192;

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

// A unit of a row: 16 bytes (VEC) or one element, as floats.
template <typename T, bool VEC>
struct Unit {
  static constexpr int E = 1;
  static __device__ __forceinline__ void load(const T* p, float (&v)[E]) {
    v[0] = to_f32(*p);
  }
  static __device__ __forceinline__ void store(T* p, const float (&v)[E]) {
    *p = from_f32<T>(v[0]);
  }
};
template <>
struct Unit<__nv_bfloat16, true> {
  static constexpr int E = 8;
  static __device__ __forceinline__ void load(const __nv_bfloat16* p,
                                              float (&v)[E]) {
    const uint4 u = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      v[2 * i] = f.x;
      v[2 * i + 1] = f.y;
    }
  }
  static __device__ __forceinline__ void store(__nv_bfloat16* p,
                                               const float (&v)[E]) {
    uint4 u;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
    for (int i = 0; i < 4; ++i)
      h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
    *reinterpret_cast<uint4*>(p) = u;
  }
};
template <>
struct Unit<float, true> {
  static constexpr int E = 4;
  static __device__ __forceinline__ void load(const float* p, float (&v)[E]) {
    const float4 f = *reinterpret_cast<const float4*>(p);
    v[0] = f.x;
    v[1] = f.y;
    v[2] = f.z;
    v[3] = f.w;
  }
  static __device__ __forceinline__ void store(float* p, const float (&v)[E]) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  }
};

__device__ __forceinline__ float scale_at(const void* s, int i, bool bf16) {
  return bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(s)[i])
              : static_cast<const float*>(s)[i];
}

// W consecutive floats (W = 4: one 16-byte access) of a partial row
template <int W>
struct Floats {
  float v[W];
};
template <int W>
__device__ __forceinline__ Floats<W> load_floats(const float* p) {
  Floats<W> f;
  if constexpr (W == 4) {
    const float4 q = *reinterpret_cast<const float4*>(p);
    f.v[0] = q.x;
    f.v[1] = q.y;
    f.v[2] = q.z;
    f.v[3] = q.w;
  } else {
    f.v[0] = *p;
  }
  return f;
}
template <int W>
__device__ __forceinline__ void add_floats(Floats<W>& a, const Floats<W>& b) {
#pragma unroll
  for (int i = 0; i < W; ++i) a.v[i] += b.v[i];
}

// Pass 2: dscale[c] = the chunks' partial rows at c, W columns a thread:
// warp w of the block adds the contiguous run of chunks
// [w * per, (w + 1) * per) in order, then the runs are added in run order.
constexpr int kP2Warps = 32;

template <int W>
__global__ void __launch_bounds__(32 * kP2Warps)
    rmsnorm_bwd_dscale(const float* __restrict__ partial,
                       void* __restrict__ dscale, int chunks, int D,
                       int scale_bf16) {
  __shared__ Floats<W> run_s[kP2Warps][32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int u = blockIdx.x * 32 + lane;  // this lane's W columns
  const int c = u * W;
  const int per = (chunks + kP2Warps - 1) / kP2Warps;
  Floats<W> t;
#pragma unroll
  for (int j = 0; j < W; ++j) t.v[j] = 0.0f;
  if (c < D) {
    const int k1 = min(chunks, (warp + 1) * per);
    int k = warp * per;
    for (; k + 8 <= k1; k += 8) {  // 8 loads in flight, added in order
      Floats<W> f[8];
#pragma unroll
      for (int j = 0; j < 8; ++j)
        f[j] =
            load_floats<W>(partial + static_cast<long long>(k + j) * D + c);
#pragma unroll
      for (int j = 0; j < 8; ++j) add_floats(t, f[j]);
    }
    for (; k < k1; ++k)
      add_floats(t,
                 load_floats<W>(partial + static_cast<long long>(k) * D + c));
  }
  run_s[warp][lane] = t;
  __syncthreads();
  if (warp == 0 && c < D) {
    for (int w = 1; w < kP2Warps; ++w) add_floats(t, run_s[w][lane]);
#pragma unroll
    for (int j = 0; j < W; ++j) {
      if (scale_bf16)
        static_cast<__nv_bfloat16*>(dscale)[c + j] = __float2bfloat16(t.v[j]);
      else
        static_cast<float*>(dscale)[c + j] = t.v[j];
    }
  }
}

// Thread t owns units lr + tpr * v (v < NV) of the rows of its group
// gi = t / tpr, lr = t % tpr; groups = 256 / tpr rows run side by side,
// rows r, r + groups, ... of the block's chunk.
template <typename T, bool VEC, int NV>
__global__ void __launch_bounds__(kThreads)
    rmsnorm_bwd_rows(const T* __restrict__ x, const void* __restrict__ scale,
                     const T* __restrict__ dy, T* __restrict__ dx,
                     float* __restrict__ partial, int n, int D, int tpr,
                     int rows_per_chunk, float eps, int scale_bf16) {
  using U = Unit<T, VEC>;
  constexpr int E = U::E;
  extern __shared__ float part_s[];  // [groups][D]: the groups' column sums
  __shared__ float red[2][kWarps];
  const int groups = kThreads / tpr;
  const int gi = threadIdx.x / tpr, lr = threadIdx.x % tpr;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int units = (D + E - 1) / E;
  const bool sbf = scale_bf16 != 0;

  float sc[NV][E], ds[NV][E];
#pragma unroll
  for (int v = 0; v < NV; ++v) {
    const int u = lr + tpr * v;
#pragma unroll
    for (int e = 0; e < E; ++e) {
      sc[v][e] = u < units ? scale_at(scale, u * E + e, sbf) : 0.0f;
      ds[v][e] = 0.0f;
    }
  }

  const long long row0 = static_cast<long long>(blockIdx.x) * rows_per_chunk;
  const int rows = static_cast<int>(
      max(0LL, min(static_cast<long long>(rows_per_chunk), n - row0)));
  // every thread takes the same number of steps: the shuffles and
  // barriers of a row see all their threads
  // a row's x and dy -> xv, gv (zeros past the row or the chunk)
  auto load_row = [&](int base, float (&xv)[NV][E], float (&gv)[NV][E]) {
    const bool act = base + gi < rows;
    const long long off = (row0 + base + gi) * D;
#pragma unroll
    for (int v = 0; v < NV; ++v) {
      const int u = lr + tpr * v;
      if (act && u < units) {
        U::load(x + off + u * E, xv[v]);
        U::load(dy + off + u * E, gv[v]);
      } else {
#pragma unroll
        for (int e = 0; e < E; ++e) xv[v][e] = gv[v][e] = 0.0f;
      }
    }
  };
  float xv[NV][E], gv[NV][E];
  load_row(0, xv, gv);
  for (int base = 0; base < rows; base += groups) {
    const bool act = base + gi < rows;
    const long long off = (row0 + base + gi) * D;
    // the next row's loads are in flight while this row is reduced
    float xn[NV][E], gn[NV][E];
    load_row(base + groups, xn, gn);
    float ss = 0.0f, sdx = 0.0f;
#pragma unroll
    for (int v = 0; v < NV; ++v)
#pragma unroll
      for (int e = 0; e < E; ++e) {
        ss = fmaf(xv[v][e], xv[v][e], ss);
        sdx = fmaf(gv[v][e] * sc[v][e], xv[v][e], sdx);
      }
    if (tpr <= 32) {
      for (int o = tpr / 2; o > 0; o >>= 1) {
        ss += __shfl_xor_sync(0xffffffffu, ss, o);
        sdx += __shfl_xor_sync(0xffffffffu, sdx, o);
      }
    } else {  // tpr == 256: the block is one row
      for (int o = 16; o > 0; o >>= 1) {
        ss += __shfl_xor_sync(0xffffffffu, ss, o);
        sdx += __shfl_xor_sync(0xffffffffu, sdx, o);
      }
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
    }
    if (act) {
      const float r = 1.0f / sqrtf(ss / static_cast<float>(D) + eps);
      const float c3 = r * r * r * (sdx / static_cast<float>(D));
#pragma unroll
      for (int v = 0; v < NV; ++v) {
        const int u = lr + tpr * v;
        if (u < units) {
          float o[E];
#pragma unroll
          for (int e = 0; e < E; ++e) {
            o[e] = r * (gv[v][e] * sc[v][e]) - xv[v][e] * c3;
            ds[v][e] = fmaf(gv[v][e], xv[v][e] * r, ds[v][e]);
          }
          U::store(dx + off + u * E, o);
        }
      }
    }
#pragma unroll
    for (int v = 0; v < NV; ++v)
#pragma unroll
      for (int e = 0; e < E; ++e) {
        xv[v][e] = xn[v][e];
        gv[v][e] = gn[v][e];
      }
  }

  // the block's column sums by row group; every (group, column) is written
#pragma unroll
  for (int v = 0; v < NV; ++v) {
    const int u = lr + tpr * v;
    if (u < units)
#pragma unroll
      for (int e = 0; e < E; ++e)
        if (u * E + e < D) part_s[gi * D + u * E + e] = ds[v][e];
  }
  __syncthreads();
  // the block's partial row: its row groups added in group order
  float* out = partial + static_cast<long long>(blockIdx.x) * D;
  for (int c = threadIdx.x; c < D; c += kThreads) {
    float t = part_s[c];
    for (int g = 1; g < groups; ++g) t += part_s[g * D + c];
    out[c] = t;
  }
}

template <typename T, bool VEC, int NV>
int launch_rows(const T* x, const void* scale, const T* dy, T* dx,
                float* partial, void* dscale, int n, int D, int tpr,
                int rows_per_chunk, float eps, int scale_bf16,
                cudaStream_t stream) {
  const long long chunks =
      (static_cast<long long>(n) + rows_per_chunk - 1) / rows_per_chunk;
  if (chunks > 2147483647LL) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = sizeof(float) * (kThreads / tpr) * D;  // <= 32 KB
  rmsnorm_bwd_rows<T, VEC, NV>
      <<<static_cast<unsigned>(chunks), kThreads, smem, stream>>>(
          x, scale, dy, dx, partial, n, D, tpr, rows_per_chunk, eps,
          scale_bf16);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int units = D % 4 == 0 ? D / 4 : D;
  const unsigned blocks = (units + 31) / 32;
  if (D % 4 == 0)
    rmsnorm_bwd_dscale<4><<<blocks, 32 * kP2Warps, 0, stream>>>(
        partial, dscale, static_cast<int>(chunks), D, scale_bf16);
  else
    rmsnorm_bwd_dscale<1><<<blocks, 32 * kP2Warps, 0, stream>>>(
        partial, dscale, static_cast<int>(chunks), D, scale_bf16);
  return static_cast<int>(cudaGetLastError());
}

// tpr threads a row and NV units a thread from the row's units: a run of
// threads within a warp when the row has at most 32 units, a warp with 2
// or 4 units each up to 128, else the block with 1 .. 32 units each.
template <typename T, bool VEC>
int launch(const T* x, const void* scale, const T* dy, T* dx, float* partial,
           void* dscale, int n, int D, int rows_per_chunk, float eps,
           int scale_bf16, cudaStream_t stream) {
  const int units = VEC ? D / Unit<T, VEC>::E : D;
  int tpr = 1, nv = 1;
  if (units <= 32) {
    while (tpr < units) tpr *= 2;
  } else if (units <= 128) {
    tpr = 32;
    nv = units <= 64 ? 2 : 4;
  } else {
    tpr = kThreads;
    while (tpr * nv < units) nv *= 2;
  }
  // the most units a thread takes at D <= 8192: 32 elements, or 8 (f32)
  // and 4 (bf16) 16-byte vectors; no larger NV is built
  constexpr int kMaxNv = kMaxD / (kThreads * Unit<T, VEC>::E);
#define RMS_BWD_NV(N)                                                        \
  if constexpr (N <= kMaxNv)                                                 \
    if (nv == N)                                                             \
      return launch_rows<T, VEC, N>(x, scale, dy, dx, partial, dscale, n, D, \
                                    tpr, rows_per_chunk, eps, scale_bf16,    \
                                    stream);
  RMS_BWD_NV(1)
  RMS_BWD_NV(2)
  RMS_BWD_NV(4)
  RMS_BWD_NV(8)
  RMS_BWD_NV(16)
  RMS_BWD_NV(32)
#undef RMS_BWD_NV
  return static_cast<int>(cudaErrorInvalidValue);
}

template <typename T>
int launch_dtype(const void* x, const void* scale, const void* dy, void* dx,
                 float* partial, void* dscale, int n, int D,
                 int rows_per_chunk, float eps, int scale_bf16,
                 cudaStream_t stream) {
  const auto aligned = [](const void* p) {
    return reinterpret_cast<uintptr_t>(p) % 16 == 0;
  };
  const T* xt = static_cast<const T*>(x);
  const T* dyt = static_cast<const T*>(dy);
  T* dxt = static_cast<T*>(dx);
  // 16-byte units where every row starts on a 16-byte boundary
  if (D * sizeof(T) % 16 == 0 && aligned(x) && aligned(dy) && aligned(dx))
    return launch<T, true>(xt, scale, dyt, dxt, partial, dscale, n, D,
                           rows_per_chunk, eps, scale_bf16, stream);
  return launch<T, false>(xt, scale, dyt, dxt, partial, dscale, n, D,
                          rows_per_chunk, eps, scale_bf16, stream);
}

}  // namespace

// x_bf16 / scale_bf16: 0 = float32, 1 = bfloat16 (dy and dx have x's dtype,
// dscale scale's). partial: ceil(n / rows_per_chunk) * D floats of scratch.
extern "C" int rmsnorm_bwd(const void* x, const void* scale, const void* dy,
                           void* dx, void* partial, void* dscale, int n,
                           int D, int rows_per_chunk, float eps, int x_bf16,
                           int scale_bf16, void* stream) {
  if (n < 1 || D < 1 || D > kMaxD || rows_per_chunk < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* p = static_cast<float*>(partial);
  if (x_bf16)
    return launch_dtype<__nv_bfloat16>(x, scale, dy, dx, p, dscale, n, D,
                                       rows_per_chunk, eps, scale_bf16, s);
  return launch_dtype<float>(x, scale, dy, dx, p, dscale, n, D,
                             rows_per_chunk, eps, scale_bf16, s);
}
