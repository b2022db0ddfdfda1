// Causal sliding-window flash attention with GQA, f32 softmax and sums:
//   o[b, i, h] = sum_j softmax_j(q[b, i, h] . k[b, j, h / G] * scale) v[b, j, h / G]
// over keys j <= i with i - j < window (G = H / KV query heads per kv head),
// the output in the inputs' dtype. With causal == 0 (the encoder's
// bidirectional attention, the reference's `_sdpa` under an all-ones mask,
// layers/attention.py:99-105) query i sees every key j < S; window is then
// S and unused. Scores are f32, scaled by hd^-0.5 and
// masked to -1e30; a masked p is exactly 0; the output is acc / max(l, 1e-30)
// with the guard of the Pallas kernel (kernel.py:60). With a non-null lse
// pointer the kernel also writes each row's log-sum-exp of its scaled
// scores, lse = m + log(max(l, 1e-30)) in natural-log units, (B, H, S) f32,
// which the backward (swa_attention_bwd.cu) recomputes P from; a null lse
// (the serving path) writes nothing else and leaves o as it was.
//
// Replaces: src/repro/kernels/swa_attention/kernel.py:28 `_swa_kernel`,
// launched by `swa_attention` (:66, pallas_call at :84). The Pallas kernel
// runs a sequential grid axis over the nw = (W-1)//bk + 2 kv blocks that can
// meet a query block and carries (m, l, acc) in VMEM scratch across it.
// Blocks on this card run in parallel and in no order, so one block here
// owns one (batch, head, 64-query tile) and walks the kv tiles of its window
// itself - from the tile holding max(0, q0 - W + 1) to the one holding its
// last query, never more than nw - with (m, l, acc) in registers. Positions
// past S are masked by absolute index, so any prompt length runs (the TPU
// kernel needs S % 128 == 0). GQA is an index (kv head = h / G): k and v are
// never repeated in memory.
//
// Shapes: q, o (B, S, H, hd), k, v (B, S, KV, hd), all contiguous; hd <= 128.
// Grid (ceil(S / 64) query tiles, B * H).
//
// Which dtype takes which route:
// - bfloat16 operands (the serving path): the tensor-core kernel below.
// - float32 operands (the f32 card-vs-CPU parity runs): the CUDA-core kernel
//   at the end of this file. The tensor cores take f32 only as TF32, which
//   keeps ~3 decimal digits; the port keeps TF32 off.
//
// What bounds it on an H100: a (q, k) pair inside the mask costs 4 hd FLOP
// (q.k and p.v). The prefill (B 4, S 128, H 32, KV 8, hd 128, window = S)
// does 0.54 GFLOP over 10.5 MB of q, k, v and o, ~52 FLOP per byte, below
// the bf16 tensor-core balance (989 TFLOP/s over 3.35 TB/s, ~295): the
// bytes bound it, at 3.1 us. mma.sync reaches that byte bound long before
// its own peak, so this kernel uses mma.sync with cp.async copies, not
// wgmma and TMA; those wait for a later PR if the numbers ask for them.
// The encoder's non-causal shape (B 4, S 1024, H 16, hd 80, HuBERT-XLarge)
// does 4 hd S^2 B H = 21.5 GFLOP over 42 MB: ~510 FLOP per byte, above the
// balance, so the tensor cores bound it, at 21.7 us.
//
// bf16 design: 4 warps, 16 query rows each.
// - Why the G query heads of one kv head are not packed into one block: at
//   the prefill shape that would cut the grid from 256 blocks to 64, under
//   half the 132 SMs. k and v (2 MB together) stay in the 50 MB L2, so the
//   G blocks of a kv head read them from L2, not from device memory.
// - Shared memory holds bf16 tiles: q (64 x hd) once, and k and v (64 x hd
//   each) in two stages, so that tile t+1's copy is in flight while tile t
//   is computed. Rows are copied by 16-byte cp.async (zero-fill form for
//   rows >= S); hd that is not a multiple of 8, or an operand that is not
//   16-byte aligned, is staged by 2-byte loads instead. hd is zero-padded
//   to HDP, a multiple of 16, and each row to HDP + 8 elements, an odd
//   number of 16-byte units, so the 8 rows of an ldmatrix land in 8
//   distinct bank groups. At hd 128: (64 + 2 * 2 * 64) rows * 272 B = 85 KB,
//   so with the carveout set to the most shared memory two blocks fit on an
//   SM; 128 threads of at most 255 registers leave room for two in the
//   register file too.
// - Q.K^T: mma.sync m16n8k16 bf16 x bf16 -> f32. q's A-fragments are taken
//   from shared memory once per block and kept in registers; k's
//   B-fragments come by ldmatrix. A bf16 x bf16 product is exact in f32 and
//   the sums are f32, so the scores are the reference's up to summation
//   order.
// - The online softmax runs on the accumulator fragments in registers: a
//   thread holds 16 scores of each of its two rows, and the 4 lanes of a
//   quad meet by shuffles for the row max and sum. The scores are scaled
//   by hd^-0.5 log2(e) and p = exp2f(s - m): the IEEE exp2f, not __expf,
//   and no --use_fast_math. exp(x) = exp2(x log2 e); rounding the product
//   moves p by ~|x| 2^-24 relative.
// - P.V: the TPU kernel multiplies an f32 p by v (kernel.py:53-54).
//   Rounding p once to bf16 would err by up to 2^-9 p on every weight, more
//   than one bf16 ulp of an output that cancels towards 0. So p is split in
//   registers, p_hi = bf16(p) and p_lo = bf16(p - p_hi), and both products
//   with v (B-fragments by ldmatrix.trans) accumulate into the same f32 acc:
//   |p - p_hi - p_lo| <= 2^-9 |p - p_hi| <= 2^-18 p, about 16 bits of p's
//   mantissa. The A-fragment of P.V is the score accumulator's own layout,
//   so p never goes through shared memory. The second product makes 192
//   mma.sync a warp and tile instead of 128; at ~52 FLOP per byte the
//   tensor cores have that room.
// - Only the tiles that need a mask get one: the diagonal tile and the
//   tile holding the window's first key (decided per warp); interior tiles
//   skip the per-element test, and a warp skips a tile none of its rows
//   can see. The output is staged through q's tile for 16-byte stores.
// - Non-causal: a block walks every key tile, 0 .. ceil(S / 64) - 1, and the
//   only mask is the ragged tail kj >= S of the last tile. That mask is
//   needed there and not in the causal mode (where kj <= qi < S): a partial
//   tile's zero-filled key rows would score 0, not -1e30, and take softmax
//   weight. The mode is a template flag of the bf16 kernel (kCausal), so
//   the causal instance compiles to the code it had before the mode.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

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
// bf16: tensor cores
// ---------------------------------------------------------------------------

constexpr int kTcWarps = 4;
constexpr int kTcThreads = 32 * kTcWarps;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; with in == false nothing is read and the 16
// bytes are written as zeros
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool in) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(in ? 16 : 0)
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

__device__ __forceinline__ uint32_t pack_bf16(__nv_bfloat16 lo,
                                              __nv_bfloat16 hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(lo)) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(hi)) << 16);
}

__device__ __forceinline__ uint32_t as_u32(__nv_bfloat162 v) {
  return pack_bf16(v.x, v.y);
}

// (x0, x1) -> the packed bf16 pairs of their high and low parts
__device__ __forceinline__ void split_pair(float x0, float x1, uint32_t& hi,
                                           uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float2 hf = __bfloat1622float2(h);
  hi = as_u32(h);
  lo = as_u32(__floats2bfloat162_rn(x0 - hf.x, x1 - hf.y));
}

template <int HDP>
__host__ __device__ constexpr int tc_pitch() {  // elements per shared row
  return HDP + 8;
}

template <int HDP>
constexpr size_t tc_smem_bytes() {
  return sizeof(__nv_bfloat16) * (kBQ + 4 * kBK) * tc_pitch<HDP>();
}

// rows row0 .. row0 + 63 of a (S, stride) bf16 operand -> a 64-row tile.
// hd == HDP (the serving path's 128) has its own loop, unrolled with
// constant bounds: one loop for every hd ran slower on the card at the
// serving shapes (PERF.md).
template <int HDP>
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst,
                                          const __nv_bfloat16* src,
                                          long long stride, int row0, int S,
                                          int hd, bool vec16) {
  constexpr int pitch = tc_pitch<HDP>();
  if (vec16 && hd == HDP) {
    constexpr int kChunks = HDP / 8;  // 16-byte copies per row
#pragma unroll
    for (int i = 0; i < kBK * kChunks / kTcThreads; ++i) {
      const int e = threadIdx.x + i * kTcThreads;
      const int r = e / kChunks, c = (e % kChunks) * 8;
      const int gr = row0 + r;
      const bool in = gr < S;
      cp_async16(dst + r * pitch + c, src + (in ? gr : 0) * stride + c, in);
    }
  } else if (vec16) {
    const int chunks = hd / 8;
    for (int e = threadIdx.x; e < kBK * chunks; e += kTcThreads) {
      const int r = e / chunks, c = (e % chunks) * 8;
      const int gr = row0 + r;
      const bool in = gr < S;
      cp_async16(dst + r * pitch + c, src + (in ? gr : 0) * stride + c, in);
    }
  } else {
    for (int e = threadIdx.x; e < kBK * hd; e += kTcThreads) {
      const int r = e / hd, c = e % hd;
      const int gr = row0 + r;
      dst[r * pitch + c] =
          gr < S ? src[gr * stride + c] : __float2bfloat16(0.0f);
    }
  }
}

template <int HDP, bool kCausal>
__global__ void __launch_bounds__(kTcThreads)
    swa_bf16_kernel(const __nv_bfloat16* __restrict__ q,
                    const __nv_bfloat16* __restrict__ k,
                    const __nv_bfloat16* __restrict__ v,
                    __nv_bfloat16* __restrict__ o,
                    float* __restrict__ lse, int S, int H, int KV,
                    int hd, int window, float scale, int vec16) {
  constexpr int kPitch = tc_pitch<HDP>();
  constexpr int kKSteps = HDP / 16;  // k-steps of Q.K^T over hd
  constexpr int kDTiles = HDP / 8;   // 8-wide column tiles of the output
  constexpr int kNTiles = kBK / 8;   // 8-key column tiles of the scores
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* q_s = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* k_s = q_s + kBQ * kPitch;      // [2][kBK][kPitch]
  __nv_bfloat16* v_s = k_s + 2 * kBK * kPitch;  // [2][kBK][kPitch]

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, tig = lane % 4;  // fragment row, column pair
  const int q0 = blockIdx.x * kBQ;
  const int b = blockIdx.y / H;
  const int h = blockIdx.y % H;
  const int kvh = h / (H / KV);
  const long long q_stride = static_cast<long long>(H) * hd;
  const long long kv_stride = static_cast<long long>(KV) * hd;
  const __nv_bfloat16* qb = q + static_cast<long long>(b) * S * q_stride +
                            static_cast<long long>(h) * hd;
  const __nv_bfloat16* kb = k + static_cast<long long>(b) * S * kv_stride +
                            static_cast<long long>(kvh) * hd;
  const __nv_bfloat16* vb = v + static_cast<long long>(b) * S * kv_stride +
                            static_cast<long long>(kvh) * hd;
  __nv_bfloat16* ob = o + static_cast<long long>(b) * S * q_stride +
                      static_cast<long long>(h) * hd;
  const bool vec = vec16 != 0;
  // scores in log2 units: p = exp2(s log2(e) - m) = exp(s - m / log2(e))
  const float scale_log2 = scale * 1.4426950408889634f;

  // columns hd .. HDP-1 of every row are zero; no copy ever writes them
  if (hd < HDP) {
    const int pad = HDP - hd;
    for (int e = threadIdx.x; e < (kBQ + 4 * kBK) * pad; e += kTcThreads)
      q_s[(e / pad) * kPitch + hd + e % pad] = __float2bfloat16(0.0f);
  }

  const int q_last = min(q0 + kBQ, S) - 1;
  const int kt_begin = kCausal ? max(0, q0 - window + 1) / kBK : 0;
  const int kt_end = (kCausal ? q_last : S - 1) / kBK;
  load_tile<HDP>(q_s, qb, q_stride, q0, S, hd, vec);
  load_tile<HDP>(k_s, kb, kv_stride, kt_begin * kBK, S, hd, vec);
  load_tile<HDP>(v_s, vb, kv_stride, kt_begin * kBK, S, hd, vec);
  cp_async_commit();

  const int qw0 = q0 + warp * 16;  // this warp's first query
  const int qi0 = qw0 + g;         // this thread's two query rows
  const int qi1 = qi0 + 8;
  uint32_t qf[kKSteps][4];
  float acc[kDTiles][4];
#pragma unroll
  for (int d = 0; d < kDTiles; ++d)
    acc[d][0] = acc[d][1] = acc[d][2] = acc[d][3] = 0.0f;
  float m0 = kNegInf, m1 = kNegInf, l0 = 0.0f, l1 = 0.0f;
  const int mi = lane / 8, mr = lane % 8;  // ldmatrix: matrix, row

  for (int kt = kt_begin; kt <= kt_end; ++kt) {
    const int st = (kt - kt_begin) & 1;
    if (kt < kt_end) {
      const int nst = st ^ 1;
      load_tile<HDP>(k_s + nst * kBK * kPitch, kb, kv_stride, (kt + 1) * kBK,
                     S, hd, vec);
      load_tile<HDP>(v_s + nst * kBK * kPitch, vb, kv_stride, (kt + 1) * kBK,
                     S, hd, vec);
    }
    cp_async_commit();
    cp_async_wait_prev();  // tile kt (and q) are in
    __syncthreads();
    if (kt == kt_begin) {
#pragma unroll
      for (int ks = 0; ks < kKSteps; ++ks)
        ldsm_x4(qf[ks], q_s + (warp * 16 + (lane % 16)) * kPitch + ks * 16 +
                            (lane / 16) * 8);
    }
    const int k0 = kt * kBK;
    // does any of this warp's rows see a key of the tile, and do all of
    // them see all of its keys? (non-causal: every row sees every key
    // below S)
    const bool live =
        !kCausal || (k0 <= qw0 + 15 && qw0 - (k0 + kBK - 1) < window);
    const bool masked = kCausal
                            ? k0 + kBK - 1 > qw0 || qw0 + 15 - k0 >= window
                            : k0 + kBK > S;
    if (live) {
      const __nv_bfloat16* ks_ = k_s + st * kBK * kPitch;
      const __nv_bfloat16* vs_ = v_s + st * kBK * kPitch;
      float s[kNTiles][4];
#pragma unroll
      for (int n = 0; n < kNTiles; ++n)
        s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.0f;
#pragma unroll
      for (int ks = 0; ks < kKSteps; ++ks) {
#pragma unroll
        for (int np = 0; np < kNTiles / 2; ++np) {
          // matrices: (keys 16np.., d 16ks), (16np.., 16ks+8),
          // (16np+8.., 16ks), (16np+8.., 16ks+8)
          uint32_t bf[4];
          ldsm_x4(bf, ks_ + (np * 16 + (mi / 2) * 8 + mr) * kPitch +
                          ks * 16 + (mi % 2) * 8);
          mma_bf16(s[2 * np], qf[ks], bf[0], bf[1]);
          mma_bf16(s[2 * np + 1], qf[ks], bf[2], bf[3]);
        }
      }

      float mx0 = kNegInf, mx1 = kNegInf;
#pragma unroll
      for (int n = 0; n < kNTiles; ++n) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float a0 = s[n][e] * scale_log2;
          float a1 = s[n][2 + e] * scale_log2;
          if (masked) {
            const int kj = k0 + n * 8 + 2 * tig + e;
            if (kCausal) {
              if (!(kj <= qi0 && qi0 - kj < window)) a0 = kNegInf;
              if (!(kj <= qi1 && qi1 - kj < window)) a1 = kNegInf;
            } else if (kj >= S) {
              a0 = kNegInf;
              a1 = kNegInf;
            }
          }
          s[n][e] = a0;
          s[n][2 + e] = a1;
          mx0 = fmaxf(mx0, a0);
          mx1 = fmaxf(mx1, a1);
        }
      }
      const float mn0 = fmaxf(m0, quad_max(mx0));
      const float mn1 = fmaxf(m1, quad_max(mx1));
      const float alpha0 = exp2f(m0 - mn0);
      const float alpha1 = exp2f(m1 - mn1);
      float ps0 = 0.0f, ps1 = 0.0f;
#pragma unroll
      for (int n = 0; n < kNTiles; ++n) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float p0 = s[n][e] > kNegInf ? exp2f(s[n][e] - mn0) : 0.0f;
          const float p1 =
              s[n][2 + e] > kNegInf ? exp2f(s[n][2 + e] - mn1) : 0.0f;
          s[n][e] = p0;
          s[n][2 + e] = p1;
          ps0 += p0;
          ps1 += p1;
        }
      }
      l0 = l0 * alpha0 + quad_sum(ps0);
      l1 = l1 * alpha1 + quad_sum(ps1);
      m0 = mn0;
      m1 = mn1;
#pragma unroll
      for (int d = 0; d < kDTiles; ++d) {
        acc[d][0] *= alpha0;
        acc[d][1] *= alpha0;
        acc[d][2] *= alpha1;
        acc[d][3] *= alpha1;
      }

#pragma unroll
      for (int t = 0; t < kBK / 16; ++t) {
        // the A-fragment of keys 16t .. 16t+15 is score tiles 2t, 2t+1
        uint32_t ph[4], pl[4];
        split_pair(s[2 * t][0], s[2 * t][1], ph[0], pl[0]);
        split_pair(s[2 * t][2], s[2 * t][3], ph[1], pl[1]);
        split_pair(s[2 * t + 1][0], s[2 * t + 1][1], ph[2], pl[2]);
        split_pair(s[2 * t + 1][2], s[2 * t + 1][3], ph[3], pl[3]);
#pragma unroll
        for (int dp = 0; dp < kDTiles / 2; ++dp) {
          // matrices (transposed): (keys 16t.., d 16dp), (16t+8.., 16dp),
          // (16t.., 16dp+8), (16t+8.., 16dp+8)
          uint32_t bf[4];
          ldsm_x4_trans(bf, vs_ + (t * 16 + (mi % 2) * 8 + mr) * kPitch +
                                dp * 16 + (mi / 2) * 8);
          mma_bf16(acc[2 * dp], ph, bf[0], bf[1]);
          mma_bf16(acc[2 * dp], pl, bf[0], bf[1]);
          mma_bf16(acc[2 * dp + 1], ph, bf[2], bf[3]);
          mma_bf16(acc[2 * dp + 1], pl, bf[2], bf[3]);
        }
      }
    }
    __syncthreads();  // tile kt is read; its stage is refilled next
  }

  // normalise into this warp's 16 rows of q's tile, then store the rows;
  // one IEEE division a row, then products: within 1.5 f32 ulp of
  // acc / l, far below the bf16 rounding that follows
  const float inv0 = 1.0f / fmaxf(l0, 1e-30f);
  const float inv1 = 1.0f / fmaxf(l1, 1e-30f);
  if (lse != nullptr && tig == 0) {
    // m is in log2 units: lse = m ln 2 + log(l); a quad shares m and l
    float* lse_bh = lse + static_cast<long long>(blockIdx.y) * S;
    if (qi0 < S)
      lse_bh[qi0] = m0 * 0.6931471805599453f + logf(fmaxf(l0, 1e-30f));
    if (qi1 < S)
      lse_bh[qi1] = m1 * 0.6931471805599453f + logf(fmaxf(l1, 1e-30f));
  }
  __nv_bfloat16* ow = q_s + warp * 16 * kPitch;
#pragma unroll
  for (int d = 0; d < kDTiles; ++d) {
    const int c = d * 8 + 2 * tig;
    *reinterpret_cast<__nv_bfloat162*>(ow + g * kPitch + c) =
        __floats2bfloat162_rn(acc[d][0] * inv0, acc[d][1] * inv0);
    *reinterpret_cast<__nv_bfloat162*>(ow + (g + 8) * kPitch + c) =
        __floats2bfloat162_rn(acc[d][2] * inv1, acc[d][3] * inv1);
  }
  __syncwarp();
  if (vec && hd == HDP) {
    constexpr int kChunks = HDP / 8;
#pragma unroll
    for (int i = 0; i < 16 * kChunks / 32; ++i) {
      const int e = lane + 32 * i;
      const int r = e / kChunks, c = (e % kChunks) * 8;
      if (qw0 + r < S)
        *reinterpret_cast<uint4*>(ob + (qw0 + r) * q_stride + c) =
            *reinterpret_cast<const uint4*>(ow + r * kPitch + c);
    }
  } else if (vec) {
    const int chunks = hd / 8;
    for (int e = lane; e < 16 * chunks; e += 32) {
      const int r = e / chunks, c = (e % chunks) * 8;
      if (qw0 + r < S)
        *reinterpret_cast<uint4*>(ob + (qw0 + r) * q_stride + c) =
            *reinterpret_cast<const uint4*>(ow + r * kPitch + c);
    }
  } else {
    for (int e = lane; e < 16 * hd; e += 32) {
      const int r = e / hd, c = e % hd;
      if (qw0 + r < S) ob[(qw0 + r) * q_stride + c] = ow[r * kPitch + c];
    }
  }
}

template <int HDP>
int launch_bf16(const void* q, const void* k, const void* v, void* o,
                float* lse, int B, int S, int H, int KV, int hd, int window,
                int causal, float scale, cudaStream_t stream) {
  constexpr size_t smem = tc_smem_bytes<HDP>();
  const auto kernel =
      causal ? swa_bf16_kernel<HDP, true> : swa_bf16_kernel<HDP, false>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  // the most shared memory the SM can give, so two blocks fit at hd 128
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return static_cast<int>(err);
  const auto aligned = [](const void* p) {
    return reinterpret_cast<uintptr_t>(p) % 16 == 0;
  };
  const int vec16 = hd % 8 == 0 && aligned(q) && aligned(k) && aligned(v) &&
                    aligned(o);
  dim3 grid((S + kBQ - 1) / kBQ, B * H);
  kernel<<<grid, kTcThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o),
      lse, S, H, KV, hd, window, scale, vec16);
  return static_cast<int>(cudaGetLastError());
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
                   int window, int causal, float scale) {
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
  const int kt_begin = causal ? max(0, q0 - window + 1) / kBK : 0;
  const int kt_end = (causal ? q_last : S - 1) / kBK;
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
      const bool valid =
          qi < S && (causal ? kj <= qi && qi - kj < window : kj < S);
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
               int causal, float scale, cudaStream_t stream) {
  const size_t smem = f32_smem_bytes(hd);
  cudaError_t err = cudaFuncSetAttribute(
      swa_f32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((S + kBQ - 1) / kBQ, B * H);
  swa_f32_kernel<<<grid, kF32Threads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), lse, S, H, KV,
      hd, window, causal, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// bf16: 0 = float32 operands (CUDA cores), 1 = bfloat16 (tensor cores).
// lse: (B, H, S) f32 log-sum-exp of each row's scores, or null.
// causal: 1 = the causal sliding window, 0 = every key (window unused).
extern "C" int swa_attention_fwd(const void* q, const void* k, const void* v,
                                 void* o, void* lse, int B, int S, int H,
                                 int KV, int hd, int window, int causal,
                                 float scale, int bf16, void* stream) {
  if (hd < 1 || hd > kHdMax || KV < 1 || H % KV != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* lse_f = static_cast<float*>(lse);
  if (!bf16)
    return launch_f32(q, k, v, o, lse_f, B, S, H, KV, hd, window, causal,
                      scale, s);
  using Launch = int (*)(const void*, const void*, const void*, void*, float*,
                         int, int, int, int, int, int, int, float,
                         cudaStream_t);
  constexpr Launch by_hdp[] = {launch_bf16<16>, launch_bf16<32>,
                               launch_bf16<48>, launch_bf16<64>,
                               launch_bf16<80>, launch_bf16<96>,
                               launch_bf16<112>, launch_bf16<128>};
  return by_hdp[(hd + 15) / 16 - 1](q, k, v, o, lse_f, B, S, H, KV, hd,
                                    window, causal, scale, s);
}
