// Causal sliding-window flash attention with GQA, f32 softmax and sums:
//   o[b, i, h] = sum_j softmax_j(q[b, i, h] . k[b, j, h / G] * scale) v[b, j, h / G]
// over keys j <= i with i - j < window (G = H / KV query heads per kv head),
// the output in the inputs' dtype. With causal == 0 (the encoder's
// bidirectional attention, the reference's `_sdpa` under an all-ones mask,
// layers/attention.py:99-105) query i sees every key j < S; window is then
// S and unused. Scores are f32, scaled by hd^-0.5 and masked to -1e30; a
// masked p is exactly 0; the output is acc / max(l, 1e-30) with the guard
// of the Pallas kernel (kernel.py:60). With a non-null lse pointer the
// kernel also writes each row's log-sum-exp of its scaled scores, lse = m +
// log(max(l, 1e-30)) in natural-log units, (B, H, S) f32, which the
// backward (swa_attention_bwd.cu) recomputes P from; a null lse (the
// serving path) writes nothing else and leaves o as it was.
//
// Replaces: src/repro/kernels/swa_attention/kernel.py:28 `_swa_kernel`,
// launched by `swa_attention` (:66, pallas_call at :84). The Pallas kernel
// runs a sequential grid axis over the nw = (W-1)//bk + 2 kv blocks that can
// meet a query block and carries (m, l, acc) in VMEM scratch across it.
// Blocks on this card run in parallel and in no order, so one block here
// owns one (batch, head, query tile) and walks the kv tiles of its window
// itself - from the tile holding max(0, q0 - W + 1) to the one holding its
// last query - with (m, l, acc) in registers. Positions past S are masked
// by absolute index, so any prompt length runs (the TPU kernel needs S %
// 128 == 0). GQA is an index (kv head = h / G): k and v are never repeated
// in memory.
//
// Shapes: q, o (B, S, H, hd), k, v (B, S, KV, hd), all contiguous; hd <= 128.
//
// The entry point below takes every call and picks the kernel from the
// dtype and the mode:
// - bfloat16 operands, either mode: the wgmma and TMA kernels of
//   swa_full_fwd.cu.
// - float32 operands (the f32 card-vs-CPU parity runs): the causal
//   CUDA-core kernel of this file, or swa_full_fwd.cu's non-causal one.
//   The tensor cores take f32 only as TF32, which keeps ~3 decimal digits;
//   the port keeps TF32 off.
//
// What bounds it on an H100: a (q, k) pair inside the mask costs 4 hd FLOP
// (q.k and p.v). The LM prefill (B 4, S 128, H 32, KV 8, hd 128, window =
// S) does 0.54 GFLOP over 10.5 MB of q, k, v and o, ~52 FLOP per byte,
// below the bf16 tensor-core balance (989 TFLOP/s over 3.35 TB/s, ~295):
// the bytes bound it, at 3.1 us. The earlier bf16 kernel (mma.sync with
// cp.async copies, 64-query blocks of 4 warps) was written on the
// argument that mma.sync reaches that byte bound long before its own
// peak. The card said otherwise: it ran at 3.3x the bound there and 1.5x
// SDPA, each block waiting on a chain of copy, product, softmax and split
// per tile, and at 3.5x SDPA on a 4,096-token sequence (~1,640 FLOP per
// byte: the tensor cores', whose full rate only wgmma reaches). The wgmma
// kernels took every causal shape measured, and it was removed (PERF.md).
#include <cuda_runtime.h>

namespace {

constexpr int kBQ = 64;
constexpr int kBK = 64;
constexpr int kHdMax = 128;
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// ---------------------------------------------------------------------------
// f32: CUDA cores. A 64 x hd tile of q and 64 x hd tiles of k and v are
// staged in shared memory (rows padded by one word against bank conflicts;
// 113 KB at hd 128). Thread t owns query row t / 4 and the columns
// t % 4 + 4 i: 16 scores of the kv tile, then hd / 4 output columns; p goes
// through shared memory to the p.v product.
// ---------------------------------------------------------------------------

constexpr int kF32Threads = 256;
constexpr int kSub = kF32Threads / kBQ;  // threads per query row

size_t f32_smem_bytes(int hd) {
  return sizeof(float) *
         (static_cast<size_t>(kBQ + 2 * kBK) * (hd + 1) + kBQ * (kBK + 1));
}

__global__ void __launch_bounds__(kF32Threads)
    swa_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                   const float* __restrict__ v, float* __restrict__ o,
                   float* __restrict__ lse, int S, int H, int KV, int hd,
                   int window, float scale) {
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
  const float* qb = q + static_cast<long long>(b) * S * q_stride +
                    static_cast<long long>(h) * hd;
  const float* kb = k + static_cast<long long>(b) * S * kv_stride +
                    static_cast<long long>(kvh) * hd;
  const float* vb = v + static_cast<long long>(b) * S * kv_stride +
                    static_cast<long long>(kvh) * hd;
  float* ob = o + static_cast<long long>(b) * S * q_stride +
              static_cast<long long>(h) * hd;

  for (int e = threadIdx.x; e < kBQ * hd; e += kF32Threads) {
    const int rr = e / hd, d = e % hd;
    const int qi = q0 + rr;
    q_s[rr * hdp + d] = qi < S ? qb[qi * q_stride + d] : 0.0f;
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
    for (int e = threadIdx.x; e < kBK * hd; e += kF32Threads) {
      const int rr = e / hd, d = e % hd;
      const int kj = k0 + rr;
      const bool in = kj < S;
      k_s[rr * hdp + d] = in ? kb[kj * kv_stride + d] : 0.0f;
      v_s[rr * hdp + d] = in ? vb[kj * kv_stride + d] : 0.0f;
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
    const float m_new = fmaxf(m, quad_max(tile_max));
    const float alpha = expf(m - m_new);
    float psum = 0.0f;
#pragma unroll
    for (int i = 0; i < kBK / kSub; ++i) {
      const float p = s[i] > kNegInf ? expf(s[i] - m_new) : 0.0f;
      p_s[r * (kBK + 1) + sub + kSub * i] = p;
      psum += p;
    }
    l = l * alpha + quad_sum(psum);
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
    float* orow = ob + qi * q_stride;
#pragma unroll
    for (int j = 0; j < kHdMax / kSub; ++j) {
      const int d = sub + kSub * j;
      if (d < hd) orow[d] = acc[j] / l_safe;
    }
    if (lse != nullptr && sub == 0)
      lse[static_cast<long long>(blockIdx.y) * S + qi] = m + logf(l_safe);
  }
}

int launch_f32(const void* q, const void* k, const void* v, void* o,
               float* lse, int B, int S, int H, int KV, int hd, int window,
               float scale, cudaStream_t stream) {
  const size_t smem = f32_smem_bytes(hd);
  cudaError_t err = cudaFuncSetAttribute(
      swa_f32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((S + kBQ - 1) / kBQ, B * H);
  swa_f32_kernel<<<grid, kF32Threads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), lse, S, H, KV,
      hd, window, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// swa_full_fwd.cu: the wgmma kernels (both modes) and the non-causal f32
extern "C" int swa_full_fwd(const void* q, const void* k, const void* v,
                            void* o, void* lse, int B, int S, int H, int KV,
                            int hd, int window, int causal, float scale,
                            int bf16, void* stream);

// bf16: 0 = float32 operands (CUDA cores), 1 = bfloat16 (tensor cores).
// lse: (B, H, S) f32 log-sum-exp of each row's scores, or null.
// causal: 1 = the causal sliding window, 0 = every key (window unused).
extern "C" int swa_attention_fwd(const void* q, const void* k, const void* v,
                                 void* o, void* lse, int B, int S, int H,
                                 int KV, int hd, int window, int causal,
                                 float scale, int bf16, void* stream) {
  if (hd < 1 || hd > kHdMax || KV < 1 || H % KV != 0 || window < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (!causal || bf16)
    return swa_full_fwd(q, k, v, o, lse, B, S, H, KV, hd, window, causal,
                        scale, bf16, stream);
  return launch_f32(q, k, v, o, static_cast<float*>(lse), B, S, H, KV, hd,
                    window, scale, static_cast<cudaStream_t>(stream));
}
