// Fused ELM sufficient statistics, member-batched, f32:
//   out[m] = Hm^T [H | T]  with Hm = diag(mask) H   ->  (L, L+C) per member,
// whose first L columns are U = H^T diag(m) H and last C columns are
// V = H^T diag(m) T (paper Eq. 3/4).
//
// Replaces: src/repro/kernels/elm_stats/kernel.py:36 `_elm_stats_kernel`,
// launched by `_elm_stats` (:75, pallas_call at :97). The Pallas kernel walks
// a sequential grid over row tiles and carries U and V in VMEM scratch from
// one step to the next; blocks on this card run in parallel and in no order,
// so each block here owns one output tile and loops over ALL n rows itself.
// Nothing is carried between blocks and there are no atomics: every output
// sums its rows in order 0 .. n-1, and the result is the same run to run.
//
// Shapes: h (k, n, L), t (k, n, C), mask (k, n) or NULL, out (k, L, L+C).
// Grid (tiles on or above U's diagonal and every tile of V, k members); the
// grid never depends on n.
//
// What bounds it on an H100: U is symmetric, so the function needs the
// pairs i <= j of U and all of V: n (L (L+1) + 2 L C) FLOP per member (plus
// n L for the mask). At the Map path's shapes (n = 200 rows, L = 192,
// C = 10) that is 8.2 MFLOP per member on about 0.3 MB, ~26 FLOP per byte:
// above the f32 balance of the card (67 TFLOP/s over 3.35 TB/s, about 20),
// so the f32 CUDA-core rate bounds it, at 0.49 us for 4 members. The
// operations are f32 and TF32 stays off, so the tensor cores are not used.
//
// Design:
// - Each block owns a kTile x kTile output tile (32 x 32) and each thread
//   a 2 x 2 register tile of it: 256 threads, 4 independent f32
//   accumulators a thread, so no row sum is one dependent chain. At the Map
//   shape that is 27 blocks per member, 108 in all. The sizes come from a
//   sweep on the card (tools/kernel_variants.py, PERF.md): they are the
//   fastest of the sweep on the Map's unmasked 200-row batches, and have no
//   spill; 2 chunks of 64 rows are faster on a whole 12,500-row shard,
//   which no path of the port sends.
// - Rows stream through a ring of kST chunks of kKC rows in shared memory
//   (3 of 32): two chunks are copied by cp.async while one is summed. A
//   group of 4 columns goes as one 16-byte copy where it lies in one source
//   and is 16-byte aligned; a ragged edge (L or C not a multiple of 4, the
//   H | T seam, the end of a row) goes as 4-byte copies, and rows past n
//   and columns past L+C are zeros stored into the ring - nothing is padded
//   or copied in device memory. The zero rows add +0 to every sum.
// - The mask enters once: a = h[r, i] * m[r] in registers, then
//   acc = fma(a, h[r, j], acc) - the rounding of the plain version, so a
//   fractional mask weights a row and is never squared.
// - U is symmetric, so each pair (i, j) is computed once: only the tiles on
//   or above U's diagonal are launched, and an element above it is written
//   at (i, j) and (j, i) from the same register, so U is bitwise symmetric.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 32;  // output rows and columns of a block
constexpr int kKC = 32;    // rows of H per chunk
constexpr int kST = 3;     // chunks in the ring
constexpr int kThreads = (kTile / 2) * (kTile / 2);  // a 2 x 2 tile each
static_assert(kTile % 4 == 0, "tiles are copied 4 wide");
static_assert(kKC * kTile / 4 % kThreads == 0,
              "every thread copies the same number of groups");

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src)
               : "memory");
}

// columns j .. j+3 of one row of [H | T] (hr, tr: the row in h and t; cols
// >= lc are zero, so lc = L stages H alone) -> 16 bytes of shared memory,
// whatever their alignment. Zeros are plain stores: like the copies, they
// land before the barrier that ends the chunk's wait.
__device__ __forceinline__ void stage4(float* dst, const float* hr,
                                       const float* tr, int L, int lc, int j,
                                       bool row_in) {
  if (!row_in) {
    *reinterpret_cast<float4*>(dst) = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    return;
  }
  const float* src = j + 3 < L                  ? hr + j
                     : j >= L && j + 3 < lc ? tr + (j - L)
                                                : nullptr;
  if (src && reinterpret_cast<uintptr_t>(src) % 16 == 0) {
    cp_async16(dst, src);
    return;
  }
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int col = j + e;
    if (col < L)
      cp_async4(dst + e, hr + col);
    else if (col < lc)
      cp_async4(dst + e, tr + (col - L));
    else
      dst[e] = 0.0f;
  }
}

template <bool kMasked>
__global__ void __launch_bounds__(kThreads)
    elm_stats_kernel(const float* __restrict__ h, const float* __restrict__ t,
                     const float* __restrict__ mask, float* __restrict__ out,
                     int n, int L, int C, int col_tiles) {
  __shared__ __align__(16) float a_s[kST][kKC][kTile];  // Hm, row tile
  __shared__ __align__(16) float b_s[kST][kKC][kTile];  // [H | T], col tile
  __shared__ __align__(16) float m_s[kST][kKC];       // the chunk's weights

  // this block's tile: row tile bi holds the column tiles from the one on
  // U's diagonal, bi, to the last
  int bi = 0, rest = blockIdx.x;
  while (rest >= col_tiles - bi) {
    rest -= col_tiles - bi;
    ++bi;
  }
  const int i0 = bi * kTile;
  const int j0 = (bi + rest) * kTile;
  const int m = blockIdx.y;
  const int LC = L + C;
  const float* hm = h + static_cast<long long>(m) * n * L;
  const float* tm = t + static_cast<long long>(m) * n * C;
  const float* mm = kMasked ? mask + static_cast<long long>(m) * n : nullptr;

  // a thread copies the same 4-column groups in every chunk, one chunk
  // further down: a group that lies in one source, 16-byte aligned in
  // every row, goes as one copy; stage4 sorts out the rest row by row.
  const bool h16 = L % 4 == 0 && reinterpret_cast<uintptr_t>(hm) % 16 == 0;
  const bool t16 = C % 4 == 0 && reinterpret_cast<uintptr_t>(tm) % 16 == 0;
  const auto stage = [&](int chunk, int st) {
    const int r0 = chunk * kKC;
#pragma unroll
    for (int g = 0; g < kKC * kTile / 4; g += kThreads) {
      const int e = g + threadIdx.x;
      const int rr = e / (kTile / 4), c = (e % (kTile / 4)) * 4;
      const int r = r0 + rr, j = i0 + c;
      const long long row = r < n ? r : 0;
      if (r < n && h16 && j + 3 < L)
        cp_async16(&a_s[st][rr][c], hm + row * L + j);
      else
        stage4(&a_s[st][rr][c], hm + row * L, nullptr, L, L, j, r < n);
    }
#pragma unroll
    for (int g = 0; g < kKC * kTile / 4; g += kThreads) {
      const int e = g + threadIdx.x;
      const int rr = e / (kTile / 4), c = (e % (kTile / 4)) * 4;
      const int r = r0 + rr, j = j0 + c;
      const long long row = r < n ? r : 0;
      if (r < n && h16 && j + 3 < L)
        cp_async16(&b_s[st][rr][c], hm + row * L + j);
      else if (r < n && t16 && j >= L && j + 3 < LC)
        cp_async16(&b_s[st][rr][c], tm + row * C + (j - L));
      else
        stage4(&b_s[st][rr][c], hm + row * L, tm + row * C, L, LC, j, r < n);
    }
    if (kMasked) {
      for (int e = threadIdx.x; e < kKC; e += kThreads) {
        if (r0 + e < n)
          cp_async4(&m_s[st][e], mm + r0 + e);
        else
          m_s[st][e] = 0.0f;
      }
    }
  };

  const int tx = threadIdx.x % (kTile / 2);
  const int ty = threadIdx.x / (kTile / 2);
  float acc[2][2] = {{0.0f, 0.0f}, {0.0f, 0.0f}};

  // the ring: chunks c+1 .. c+kST-1 are in flight while chunk c is summed
  const int chunks = (n + kKC - 1) / kKC;
#pragma unroll
  for (int c = 0; c < kST - 1; ++c) {
    if (c < chunks) stage(c, c);
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  }
  for (int c = 0; c < chunks; ++c) {
    const int st = c % kST;
    if (c + kST - 1 < chunks) stage(c + kST - 1, (c + kST - 1) % kST);
    asm volatile("cp.async.commit_group;\n" ::: "memory");
    // all but the kST - 1 newest groups are done: chunk c is in
    asm volatile("cp.async.wait_group %0;\n" ::"n"(kST - 1) : "memory");
    __syncthreads();
#pragma unroll
    for (int rr = 0; rr < kKC; ++rr) {
      float2 a = *reinterpret_cast<const float2*>(&a_s[st][rr][ty * 2]);
      const float2 b = *reinterpret_cast<const float2*>(&b_s[st][rr][tx * 2]);
      if (kMasked) {
        const float w = m_s[st][rr];
        a.x *= w;
        a.y *= w;
      }
      acc[0][0] = fmaf(a.x, b.x, acc[0][0]);
      acc[0][1] = fmaf(a.x, b.y, acc[0][1]);
      acc[1][0] = fmaf(a.y, b.x, acc[1][0]);
      acc[1][1] = fmaf(a.y, b.y, acc[1][1]);
    }
    __syncthreads();  // chunk c is read; its stage is refilled next
  }

  float* om = out + static_cast<long long>(m) * L * LC;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = i0 + ty * 2 + i;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int c = j0 + tx * 2 + j;
      if (r >= L || c >= LC || (c < L && c < r)) continue;  // (c, r) has it
      om[static_cast<long long>(r) * LC + c] = acc[i][j];
      if (c < L && c > r) om[static_cast<long long>(c) * LC + r] = acc[i][j];
    }
  }
}

}  // namespace

extern "C" int elm_stats_f32(const float* h, const float* t, const float* mask,
                             float* out, int k, int n, int L, int C,
                             void* stream) {
  const int row_tiles = (L + kTile - 1) / kTile;
  const int col_tiles = (L + C + kTile - 1) / kTile;
  int tiles = 0;
  for (int bi = 0; bi < row_tiles; ++bi) tiles += col_tiles - bi;
  dim3 grid(tiles, k);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (mask)
    elm_stats_kernel<true><<<grid, kThreads, 0, s>>>(h, t, mask, out, n, L,
                                                      C, col_tiles);
  else
    elm_stats_kernel<false><<<grid, kThreads, 0, s>>>(h, t, mask, out, n, L,
                                                       C, col_tiles);
  return static_cast<int>(cudaGetLastError());
}
