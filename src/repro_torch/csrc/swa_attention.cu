// Causal sliding-window flash attention with GQA, f32 softmax and sums:
//   o[b, i, h] = sum_j softmax_j(q[b, i, h] . k[b, j, h / G] * scale) v[b, j, h / G]
// over keys j <= i with i - j < window (G = H / KV query heads per kv head),
// the output in the inputs' dtype (f32 or bf16).
//
// Replaces: src/repro/kernels/swa_attention/kernel.py:28 `_swa_kernel`,
// launched by `swa_attention` (:66, pallas_call at :84). The Pallas kernel
// runs a sequential grid axis over the nw = (W-1)//bk + 2 kv blocks that can
// meet a query block and carries the online-softmax state (m, l, acc) in VMEM
// scratch across it. Blocks on this card run in parallel and in no order, so
// one block here owns one (batch, head, 64-query tile) and walks the kv tiles
// of its window itself - from the tile holding max(0, q0 - W + 1) to the one
// holding its last query, never more than nw - with (m, l, acc) in registers.
// The TPU kernel needs S % 128 == 0; prompts have any length, so positions
// past S are masked here by absolute index at load and store. GQA is an index
// (kv head = h / G): k and v are never repeated in memory.
//
// Shapes: q, o (B, S, H, hd), k, v (B, S, KV, hd), all contiguous; hd <= 128.
// Grid (ceil(S / 64) query tiles, B * H); 256 threads.
//
// What bounds it on an H100: a (q, k) pair inside the mask costs 4 hd FLOP
// (q.k and p.v). On the serving path's prefill (B 4, S 128, H 32, KV 8,
// hd 128, window = S, bf16) that is 0.54 GFLOP over 10.5 MB of q, k, v and o,
// ~52 FLOP per byte: below the bf16 tensor-core balance (~295), so the bytes
// bound it at the card's peak. This first kernel runs the products on the f32
// CUDA cores (67 TFLOP/s), which makes the FLOPs its real limit; wgmma tiles
// are the optimisation after parity.
//
// Design: a 64 x hd tile of q and 64 x hd tiles of k and v are staged in
// shared memory as f32 (rows padded by one word against bank conflicts;
// 113 KB at hd 128, dynamic shared memory). Thread t owns query row t / 4 and
// the columns t % 4 + 4 i: 16 scores of the kv tile, then 32 (hd / 4) output
// columns. The row's max and sum meet over the 4 threads by warp shuffles;
// p goes through shared memory to the p.v product. Masked scores are -1e30,
// as in the TPU kernel, and a masked p is exactly 0; the output is
// acc / max(l, 1e-30), the guard of kernel.py:60.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kBQ = 64;
constexpr int kBK = 64;
constexpr int kThreads = 256;
constexpr int kSub = kThreads / kBQ;  // threads per query row
constexpr int kHdMax = 128;
constexpr float kNegInf = -1e30f;

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

__device__ __forceinline__ float row_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}
__device__ __forceinline__ float row_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

size_t smem_bytes(int hd) {
  return sizeof(float) *
         (static_cast<size_t>(kBQ + 2 * kBK) * (hd + 1) + kBQ * (kBK + 1));
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    swa_kernel(const T* __restrict__ q, const T* __restrict__ k,
               const T* __restrict__ v, T* __restrict__ o, int S, int H,
               int KV, int hd, int window, float scale) {
  extern __shared__ float smem[];
  const int hdp = hd + 1;
  float* q_s = smem;               // kBQ x hdp
  float* k_s = q_s + kBQ * hdp;    // kBK x hdp
  float* v_s = k_s + kBK * hdp;    // kBK x hdp
  float* p_s = v_s + kBK * hdp;    // kBQ x (kBK + 1)

  const int q0 = blockIdx.x * kBQ;
  const int b = blockIdx.y / H;
  const int h = blockIdx.y % H;
  const int kvh = h / (H / KV);
  const long long q_stride = static_cast<long long>(H) * hd;
  const long long kv_stride = static_cast<long long>(KV) * hd;
  const T* qb = q + static_cast<long long>(b) * S * q_stride +
                static_cast<long long>(h) * hd;
  const T* kb = k + static_cast<long long>(b) * S * kv_stride +
                static_cast<long long>(kvh) * hd;
  const T* vb = v + static_cast<long long>(b) * S * kv_stride +
                static_cast<long long>(kvh) * hd;
  T* ob = o + static_cast<long long>(b) * S * q_stride +
          static_cast<long long>(h) * hd;

  for (int e = threadIdx.x; e < kBQ * hd; e += kThreads) {
    const int rr = e / hd, d = e % hd;
    const int qi = q0 + rr;
    q_s[rr * hdp + d] = qi < S ? to_f32(qb[qi * q_stride + d]) : 0.0f;
  }

  const int r = threadIdx.x / kSub;
  const int sub = threadIdx.x % kSub;
  const int qi = q0 + r;
  float m = kNegInf;
  float l = 0.0f;
  float acc[kHdMax / kSub];
#pragma unroll
  for (int j = 0; j < kHdMax / kSub; ++j) acc[j] = 0.0f;

  const int q_last = min(q0 + kBQ, S) - 1;
  const int kt_begin = max(0, q0 - window + 1) / kBK;
  const int kt_end = q_last / kBK;
  for (int kt = kt_begin; kt <= kt_end; ++kt) {
    const int k0 = kt * kBK;
    __syncthreads();  // the q tile is in; the last kv tile is read
    for (int e = threadIdx.x; e < kBK * hd; e += kThreads) {
      const int rr = e / hd, d = e % hd;
      const int kj = k0 + rr;
      const bool in = kj < S;
      k_s[rr * hdp + d] = in ? to_f32(kb[kj * kv_stride + d]) : 0.0f;
      v_s[rr * hdp + d] = in ? to_f32(vb[kj * kv_stride + d]) : 0.0f;
    }
    __syncthreads();

    float s[kBK / kSub];
#pragma unroll
    for (int i = 0; i < kBK / kSub; ++i) s[i] = 0.0f;
    for (int d = 0; d < hd; ++d) {
      const float qv = q_s[r * hdp + d];
#pragma unroll
      for (int i = 0; i < kBK / kSub; ++i)
        s[i] = fmaf(qv, k_s[(sub + kSub * i) * hdp + d], s[i]);
    }
    float tile_max = kNegInf;
#pragma unroll
    for (int i = 0; i < kBK / kSub; ++i) {
      const int kj = k0 + sub + kSub * i;
      const bool valid = qi < S && kj <= qi && qi - kj < window;
      s[i] = valid ? s[i] * scale : kNegInf;
      tile_max = fmaxf(tile_max, s[i]);
    }
    const float m_new = fmaxf(m, row_max(tile_max));
    const float alpha = expf(m - m_new);
    float psum = 0.0f;
#pragma unroll
    for (int i = 0; i < kBK / kSub; ++i) {
      const float p = s[i] > kNegInf ? expf(s[i] - m_new) : 0.0f;
      p_s[r * (kBK + 1) + sub + kSub * i] = p;
      psum += p;
    }
    l = l * alpha + row_sum(psum);
    m = m_new;
    __syncwarp();  // a row's p is written by the 4 lanes that read it

#pragma unroll
    for (int j = 0; j < kHdMax / kSub; ++j) acc[j] *= alpha;
    for (int c = 0; c < kBK; ++c) {
      const float p = p_s[r * (kBK + 1) + c];
      const float* vr = v_s + c * hdp + sub;
#pragma unroll
      for (int j = 0; j < kHdMax / kSub; ++j)
        if (sub + kSub * j < hd) acc[j] = fmaf(p, vr[kSub * j], acc[j]);
    }
  }

  if (qi < S) {
    const float l_safe = fmaxf(l, 1e-30f);
    T* orow = ob + qi * q_stride;
#pragma unroll
    for (int j = 0; j < kHdMax / kSub; ++j) {
      const int d = sub + kSub * j;
      if (d < hd) orow[d] = from_f32<T>(acc[j] / l_safe);
    }
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* o, int B, int S,
           int H, int KV, int hd, int window, float scale,
           cudaStream_t stream) {
  const size_t smem = smem_bytes(hd);
  cudaError_t err = cudaFuncSetAttribute(
      swa_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((S + kBQ - 1) / kBQ, B * H);
  swa_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), S, H, KV, hd, window,
      scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// bf16: 0 = float32 operands, 1 = bfloat16 operands.
extern "C" int swa_attention_fwd(const void* q, const void* k, const void* v,
                                 void* o, int B, int S, int H, int KV, int hd,
                                 int window, float scale, int bf16,
                                 void* stream) {
  if (hd < 1 || hd > kHdMax || KV < 1 || H % KV != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bf16 ? launch<__nv_bfloat16>(q, k, v, o, B, S, H, KV, hd, window,
                                      scale, s)
              : launch<float>(q, k, v, o, B, S, H, KV, hd, window, scale, s);
}
