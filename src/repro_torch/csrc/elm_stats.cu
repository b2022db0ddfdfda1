// Fused ELM sufficient statistics, member-batched, f32:
//   out[m] = Hm^T [H | T]  with Hm = diag(mask) H   ->  (L, L+C) per member,
// whose first L columns are U = H^T diag(m) H and last C columns are
// V = H^T diag(m) T (paper Eq. 3/4).
//
// Replaces: src/repro/kernels/elm_stats/kernel.py:36 `_elm_stats_kernel`,
// launched by `_elm_stats` (:75, pallas_call at :97). The Pallas kernel walks
// a sequential grid over row tiles and carries U and V in VMEM scratch from
// one step to the next; blocks on this card run in parallel and in no order,
// so nothing is carried between blocks and there are no float atomics.
//
// Shapes: h (k, n, L), t (k, n, C), mask (k, n) or NULL, out (k, L, L+C);
// part: the partial sums of a strip's split of rows.
//
// What bounds it on an H100: U is symmetric, so the function needs the
// pairs i <= j of U and all of V: n (L (L+1) + 2 L C) FLOP per member (plus
// n L for the mask), on (n (L + C) + L (L + C)) 4-byte words. At every
// shape the port sends that is above the card's f32 balance (67 TFLOP/s
// over 3.35 TB/s, about 20 FLOP a byte), so the f32 CUDA-core rate bounds
// it: 0.49 us for the Map's 4 x 200 rows (L 192, C 10), 0.1221 ms for
// E2LM's 200,000 rows, 0.1012 ms for the HuBERT-XLarge head (n 4,096,
// L 1,280, C 6), 0.1292 ms for the LM head (n 512, L 4,096, C 16). The
// operations are f32 and TF32 stays off, so the tensor cores are not used.
// A thread's FMAs are fed from shared memory, which gives 128 bytes a clock
// to the SM's 128 FMAs a clock: a register tile of a x b outputs loads
// a + b floats a row for a b FMAs, so 8 x 8 keeps up with the FMAs, 8 x 4
// reaches two thirds of them and PR 13's 2 x 2 a quarter.
//
// Three instantiations, chosen by the caller from (n, L, C) alone
// (kernels/elm_stats/ops.py `plan`), never from k or the card:
//
// - narrow, the Map's batches, the stream's windows and every other
//   unsplit shape at L < 1,280 (PR 13's design, unchanged): a block owns a
//   32 x 32 output tile and each of its 256 threads a 2 x 2 register tile,
//   over all n rows; rows stream through a ring of 3 chunks of 32 rows
//   copied by cp.async (16 bytes where a group of 4 columns lies in one
//   source and is 16-byte aligned, else 4 bytes; rows past n and columns
//   past L+C are zeros stored into the ring).
//
// - wide, the heads (L >= 1,280, one pass over all n rows): a block owns
//   a 64 x 64 output tile from U's diagonal on; 4 consumer warps of 64
//   rows x 16 columns, a thread 8 x 4 (two 16-byte shared loads for its
//   rows and one for its columns, 32 FMAs, a row), and a producer warp
//   that fills a ring of 3 stages of 32 rows.
//   Where L is a multiple of 4 (h's rows 16-byte strided) and h is 16-byte
//   aligned, it issues one TMA box (64 columns x 32 rows of one member;
//   rows past n and columns past L are zero-filled) for the row tile and
//   one for a column tile inside H; the diagonal tile reads its one box as
//   both. A column tile of T (T's rows, 40 bytes at C 10, are no TMA
//   stride) copies its C columns element by element by cp.async, its zero
//   columns stored once; every tile of an unaligned h goes by cp.async too,
//   4 columns at a time: all tracked by the stage's `full` mbarrier. A warp
//   whose columns all lie past L+C skips its FMAs, so a V tile at C 10
//   costs one warp. U's mirrored half goes out through shared memory, so
//   both of a tile's stores are coalesced. 64 x 128 tiles (8 x 8 a
//   thread, in two slices) and deeper or shallower rings were slower on
//   the card at every head; at HuBERT's head (230 tiles, under two blocks
//   an SM) the copies and the FMAs overlap poorly (PERF.md §6). Below the
//   heads a block's 32-row stages take ~3 us each whatever the tiles,
//   so the narrow tiles were faster at every one-chunk shape through
//   L 1,024 at n 200 and 512 (3.1x at the Map's batch).
//
// - strip, a split of rows at L + C <= 256 (E2LM's and the Map's whole
//   shards): a block takes one chunk of rows of one member and holds whole
//   rows of [H | T] in each stage (4 groups of 64 columns at L 192: three
//   TMA boxes of H, T by cp.async); each consumer thread owns one 8 x 8
//   sub-block of U's upper part or of V (348 threads at L 192, C 10), so
//   U's diagonal wastes only its 8 x 8 blocks' lower halves, a row is read
//   from L2 once a chunk, and 8 x 8 register tiles keep shared memory up
//   with the FMAs. A thread whose column group is odd in its quarter-warp
//   reads its columns' halves the other way round, so the 8 threads of a
//   quarter-warp load from 8 different 16-byte bank groups.
//
// The row split: where a member of 2,048 rows or more has too few 64 x 64
// tiles to fill the card (fewer than 132) and its rows fit the strip, its
// rows are cut into chunks of a multiple of 32 rows, a function of
// (n, L, C) alone (at L 192: 1,536 rows, or 32 chunks where that is fewer
// rows). Pass 1 gives each block one chunk of one member and writes its
// partial sums to `part`; pass 2 adds each output's partials in chunk
// order, 0, 1, 2, ..., and writes U (both halves from the same value) and
// V. A member's result is then the same bits whatever k is, and two
// launches agree bitwise. A shape the strip cannot hold runs unsplit.
//
// In every instantiation the mask enters once, a = h[r, i] * m[r] in
// registers, then acc = fma(a, h[r, j], acc) - the rounding of the plain
// version, so a fractional mask weights a row and is never squared; each
// output (or each chunk's partial) is one fma chain over its rows in
// order from +0, and rows of zeros add +0: an unsplit launch gives PR 13's
// bits in either instantiation. U is computed once per pair i <= j and
// written to (i, j) and (j, i) from the same register or value, so it is
// bitwise symmetric.
//
// The stages, unrolls, register tiles, the split's chunk rows and the L at
// which the wide tiles take over were chosen on the card with
// tools/kernel_variants.py (PERF.md §6).
#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__host__ __device__ constexpr int cdiv(int a, int b) { return (a + b - 1) / b; }

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

// tile index -> (row tile, column tile) of a narrow launch's tiles on or
// above U's diagonal: row tile bi holds the column tiles from bi to the last
__device__ __forceinline__ void tile_of(int tile, int col_tiles, int* bi,
                                        int* bj) {
  int i = 0;
  while (tile >= col_tiles - i) {
    tile -= col_tiles - i;
    ++i;
  }
  *bi = i;
  *bj = i + tile;
}

// ---------------------------------------------------------------------------
// narrow: 32 x 32 tiles of 2 x 2 register tiles, all n rows a block

constexpr int kNTile = 32;  // output rows and columns of a block
constexpr int kNKC = 32;    // rows of H per chunk
constexpr int kNST = 3;     // chunks in the ring
constexpr int kNThreads = (kNTile / 2) * (kNTile / 2);  // a 2 x 2 tile each
static_assert(kNTile % 4 == 0, "tiles are copied 4 wide");
static_assert(kNKC * kNTile / 4 % kNThreads == 0,
              "every thread copies the same number of groups");

template <bool kMasked>
__global__ void __launch_bounds__(kNThreads)
    narrow_kernel(const float* __restrict__ h, const float* __restrict__ t,
                  const float* __restrict__ mask, float* __restrict__ out,
                  int n, int L, int C, int col_tiles) {
  __shared__ __align__(16) float a_s[kNST][kNKC][kNTile];  // Hm, row tile
  __shared__ __align__(16) float b_s[kNST][kNKC][kNTile];  // [H | T], col
  __shared__ __align__(16) float m_s[kNST][kNKC];  // the chunk's weights

  int bi, bj;
  tile_of(blockIdx.x, col_tiles, &bi, &bj);
  const int i0 = bi * kNTile;
  const int j0 = bj * kNTile;
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
    const int r0 = chunk * kNKC;
#pragma unroll
    for (int g = 0; g < kNKC * kNTile / 4; g += kNThreads) {
      const int e = g + threadIdx.x;
      const int rr = e / (kNTile / 4), c = (e % (kNTile / 4)) * 4;
      const int r = r0 + rr, j = i0 + c;
      const long long row = r < n ? r : 0;
      if (r < n && h16 && j + 3 < L)
        cp_async16(&a_s[st][rr][c], hm + row * L + j);
      else
        stage4(&a_s[st][rr][c], hm + row * L, nullptr, L, L, j, r < n);
    }
#pragma unroll
    for (int g = 0; g < kNKC * kNTile / 4; g += kNThreads) {
      const int e = g + threadIdx.x;
      const int rr = e / (kNTile / 4), c = (e % (kNTile / 4)) * 4;
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
      for (int e = threadIdx.x; e < kNKC; e += kNThreads) {
        if (r0 + e < n)
          cp_async4(&m_s[st][e], mm + r0 + e);
        else
          m_s[st][e] = 0.0f;
      }
    }
  };

  const int tx = threadIdx.x % (kNTile / 2);
  const int ty = threadIdx.x / (kNTile / 2);
  float acc[2][2] = {{0.0f, 0.0f}, {0.0f, 0.0f}};

  // the ring: chunks c+1 .. c+kNST-1 are in flight while chunk c is summed
  const int chunks = (n + kNKC - 1) / kNKC;
#pragma unroll
  for (int c = 0; c < kNST - 1; ++c) {
    if (c < chunks) stage(c, c);
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  }
  for (int c = 0; c < chunks; ++c) {
    const int st = c % kNST;
    if (c + kNST - 1 < chunks) stage(c + kNST - 1, (c + kNST - 1) % kNST);
    asm volatile("cp.async.commit_group;\n" ::: "memory");
    // all but the kNST - 1 newest groups are done: chunk c is in
    asm volatile("cp.async.wait_group %0;\n" ::"n"(kNST - 1) : "memory");
    __syncthreads();
#pragma unroll
    for (int rr = 0; rr < kNKC; ++rr) {
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

// ---------------------------------------------------------------------------
// wide: 64 x 64 tiles, 8 x 4 register tiles, a producer warp, TMA

constexpr int kWRows = 64;       // output rows of a tile
constexpr int kWGroup = 64;      // its columns: one TMA box wide
constexpr int kWTM = 8;          // a thread's register tile: rows
constexpr int kWTN = 4;          //   and columns
constexpr int kWKC = 32;         // rows of H a stage (a TMA box's rows)
constexpr int kWST = 3;          // stages in the ring
constexpr int kLanesY = 8, kLanesX = 4;   // a warp's threads: 8 x 4
constexpr int kSlice = kLanesX * kWTN;    // columns a warp: 16
constexpr int kWWarps = kWGroup / kSlice; // consumer warps: 4
constexpr int kWConsumers = 32 * kWWarps;
constexpr int kWThreads = kWConsumers + 32;   // + the producer warp
static_assert(kLanesY * kWTM == kWRows, "a warp spans the tile's rows");
static_assert(kWTM % 4 == 0 && kWTN % 4 == 0, "16-byte shared loads");

// the dynamic shared memory of a wide block, from a 1024-byte boundary:
// the ring's row tiles and column tiles (32 rows of 64 columns each, as
// one TMA box lays them down) and weights, then the mbarriers; the
// epilogue's tile reuses the ring
struct Wide {
  static constexpr int kBox = kWKC * kWGroup;  // floats of a tile a stage
  static constexpr int kA = 0;
  static constexpr int kB = kA + kWST * kBox * 4;
  static constexpr int kM = kB + kWST * kBox * 4;
  static constexpr int kBar = kM + kWST * kWKC * 4;
  static constexpr int kBytes = kBar + 2 * kWST * 8 + 1024;
  static constexpr int kPitch = kWGroup + 1;  // the epilogue's tile rows
  static_assert(kWRows * kPitch * 4 <= kM, "the epilogue fits the ring");
};

struct WideArgs {
  CUtensorMap hmap;  // (L, n, k) f32, boxes of 64 columns x 32 rows
  const float* h;
  const float* t;
  const float* mask;
  float* out;
  int n, L, C, tma;
};

// ---- mbarriers (addresses in shared memory)
__device__ __forceinline__ void bar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}
__device__ __forceinline__ void bar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}
// the phase also waits for `bytes` of TMA copies (no arrival)
__device__ __forceinline__ void bar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.expect_tx.relaxed.cta.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}
// the phase also waits for this thread's cp.async copies so far
__device__ __forceinline__ void bar_track_copies(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.shared::cta.b64 [%0];\n" ::"r"(bar)
               : "memory");
}
// wait for the completion of the barrier's phase of this parity; a wait
// past kWaitCycles (seconds: no stage takes that long) traps, so a barrier
// that can never complete ends the launch with an error, not a hung card
constexpr long long kWaitCycles = 1ll << 34;
__device__ __forceinline__ bool bar_try(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred P1;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%1], %2;\n"
      "selp.u32 %0, 1, 0, P1;\n}\n"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done != 0;
}
__device__ __forceinline__ void bar_wait(uint32_t bar, uint32_t parity) {
  if (bar_try(bar, parity)) return;
  const long long t0 = clock64();
  while (!bar_try(bar, parity))
    if (clock64() - t0 > kWaitCycles) __trap();
}
// one TMA box: columns col .. col+63, rows row .. row+31 of member m
__device__ __forceinline__ void tma_box(uint32_t dst, const CUtensorMap* map,
                                        uint32_t bar, int col, int row,
                                        int m) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(col), "r"(row),
      "r"(m)
      : "memory");
}
// named barrier 1 over the consumer warps
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(kWConsumers) : "memory");
}

// tile index -> (row tile, column tile) of a wide launch: row tile bi
// (rows 64 bi ..) holds the column tiles from its diagonal, 64 bi, past
// L + C
__device__ __forceinline__ void wide_tile_of(int tile, int LC, int* i0,
                                             int* j0) {
  int bi = 0;
  for (;;) {
    const int here = cdiv(LC - bi * kWRows, kWGroup);
    if (tile < here) break;
    tile -= here;
    ++bi;
  }
  *i0 = bi * kWRows;
  *j0 = *i0 + tile * kWGroup;
}

// the copies of one group tile of 64 columns from column j, rows r0 ..
// r0+31, by the producer warp's thread `lane` (lc: the columns that exist,
// L for H alone, L + C for [H | T]): a group of T alone element by element
// (its columns past lc were zeroed once), any other group 4 columns at a
// time through stage4
__device__ __forceinline__ void copy_group(float* dst, const float* hm,
                                           const float* tm, int n, int L,
                                           int C, int lc, int j, int r0,
                                           int lane) {
  if (j >= L) {
    const int w = min(kWGroup, lc - j);
    for (int e = lane; e < kWKC * w; e += 32) {
      const int rr = e / w, c = e % w, r = r0 + rr;
      if (r < n)
        cp_async4(dst + rr * kWGroup + c,
                  tm + static_cast<long long>(r) * C + (j - L + c));
      else
        dst[rr * kWGroup + c] = 0.0f;
    }
    return;
  }
  for (int g = lane; g < kWKC * kWGroup / 4; g += 32) {
    const int rr = g / (kWGroup / 4), c = (g % (kWGroup / 4)) * 4;
    const int r = r0 + rr;
    const long long row = r < n ? r : 0;
    stage4(dst + rr * kWGroup + c, hm + row * L, tm + row * C, L, lc, j + c,
           r < n);
  }
}

// the FMAs of one stage: as, the row tile's rows at this thread's 8 rows;
// bs, the column tile's rows at its 4 columns; w, the stage's weights
template <bool kMasked>
__device__ __forceinline__ void stage_fmas(const float* as, const float* bs,
                                           const float* w,
                                           float (&acc)[kWTM][kWTN]) {
#pragma unroll 8
  for (int rr = 0; rr < kWKC; ++rr) {
    float av[kWTM], bv[kWTN];
#pragma unroll
    for (int q = 0; q < kWTM / 4; ++q)
      *reinterpret_cast<float4*>(av + 4 * q) =
          *reinterpret_cast<const float4*>(as + rr * kWGroup + 4 * q);
    *reinterpret_cast<float4*>(bv) =
        *reinterpret_cast<const float4*>(bs + rr * kWGroup);
    if (kMasked) {
      const float m = w[rr];
#pragma unroll
      for (int i = 0; i < kWTM; ++i) av[i] *= m;
    }
#pragma unroll
    for (int i = 0; i < kWTM; ++i)
#pragma unroll
      for (int j = 0; j < kWTN; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
  }
}

// the weights of rows r0 .. r0+31 of member m, by the producer warp's
// thread `lane` (zeros past n)
__device__ __forceinline__ void copy_weights(float* dst, const float* mask,
                                             int m, int n, int r0, int lane) {
  for (int e = lane; e < kWKC; e += 32) {
    if (r0 + e < n)
      cp_async4(dst + e, mask + static_cast<long long>(m) * n + r0 + e);
    else
      dst[e] = 0.0f;
  }
}

template <bool kMasked>
__global__ void __launch_bounds__(kWThreads, 2)
    wide_kernel(const __grid_constant__ WideArgs a) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm =
      smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  const uint32_t sa = smem_addr(sm);
  float* const a_s = reinterpret_cast<float*>(sm + Wide::kA);
  float* const b_s = reinterpret_cast<float*>(sm + Wide::kB);
  float* const m_s = reinterpret_cast<float*>(sm + Wide::kM);
  const auto full = [&](int st) { return sa + Wide::kBar + 8 * st; };
  const auto empty = [&](int st) {
    return sa + Wide::kBar + 8 * (kWST + st);
  };

  const int n = a.n, L = a.L, C = a.C, LC = L + C;
  int i0, j0;
  wide_tile_of(blockIdx.x, LC, &i0, &j0);
  const int m = blockIdx.y;
  const int stages = cdiv(n, kWKC);
  // the tile on U's diagonal reads its column tile as its row tile too,
  // where that tile lies in H
  const bool alias = j0 == i0 && j0 + kWGroup <= L;

  if (threadIdx.x == 0) {
    for (int st = 0; st < kWST; ++st) {
      bar_init(full(st), 32);
      bar_init(empty(st), kWWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= kWConsumers) {
    // ---- the producer warp: stage s holds rows 32 s .. 32 s + 31;
    // the column tile by TMA inside H (with a tensor map), else by copies;
    // the row tile by TMA (with a tensor map) unless aliased, else copies
    const int lane = threadIdx.x - kWConsumers;
    const float* hm = a.h + static_cast<long long>(m) * n * L;
    const float* tm = a.t + static_cast<long long>(m) * n * C;
    const bool b_tma = a.tma && j0 + kWGroup <= L;
    const bool a_tma = a.tma && !alias;
    const bool a_copy = !a.tma && !alias;
    const int tx_bytes = 4 * Wide::kBox * (a_tma + b_tma);
    // a column tile of T alone has zeros past L + C, stored once into every
    // stage
    const int w = min(kWGroup, LC - j0);
    if (j0 >= L && w < kWGroup) {
      for (int e = lane; e < kWST * kWKC * (kWGroup - w); e += 32) {
        const int row = e / (kWGroup - w);
        b_s[row * kWGroup + w + e % (kWGroup - w)] = 0.0f;
      }
    }
    for (int s = 0; s < stages; ++s) {
      const int st = s % kWST, round = s / kWST;
      if (round > 0) bar_wait(empty(st), (round - 1) & 1);
      const int r0 = s * kWKC;
      float* as = a_s + st * Wide::kBox;
      float* bs = b_s + st * Wide::kBox;
      if (tx_bytes && lane == 0) {
        bar_expect_tx(full(st), tx_bytes);
        if (a_tma) tma_box(smem_addr(as), &a.hmap, full(st), i0, r0, m);
        if (b_tma) tma_box(smem_addr(bs), &a.hmap, full(st), j0, r0, m);
      }
      if (a_copy) copy_group(as, hm, tm, n, L, C, L, i0, r0, lane);
      if (!b_tma) copy_group(bs, hm, tm, n, L, C, LC, j0, r0, lane);
      if (kMasked) copy_weights(m_s + st * kWKC, a.mask, m, n, r0, lane);
      bar_track_copies(full(st));
      bar_arrive(full(st));
    }
    return;
  }

  // ---- the consumer warps: warp w owns columns 16 w .. 16 w + 15 of the
  // tile, all 64 rows; a thread 8 rows x 4 columns
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int row_l = (lane / kLanesX) * kWTM;
  const int col_l = warp * kSlice + (lane % kLanesX) * kWTN;
  // a warp whose columns all lie past L + C computes nothing kept (a tile
  // starts on or after the diagonal: no warp lies wholly below it)
  const bool active = j0 + warp * kSlice < LC;

  float acc[kWTM][kWTN];
#pragma unroll
  for (int i = 0; i < kWTM; ++i)
#pragma unroll
    for (int j = 0; j < kWTN; ++j) acc[i][j] = 0.0f;

  for (int s = 0; s < stages; ++s) {
    const int st = s % kWST;
    bar_wait(full(st), (s / kWST) & 1);
    if (active)
      stage_fmas<kMasked>((alias ? b_s : a_s) + st * Wide::kBox + row_l,
                          b_s + st * Wide::kBox + col_l, m_s + st * kWKC,
                          acc);
    __syncwarp();
    if (lane == 0) bar_arrive(empty(st));
  }

  // the tile through shared memory (the ring, every stage read), then U's
  // upper part and V by rows, U's mirrored part by columns
  float* tile_s = a_s;
  consumers_sync();
#pragma unroll
  for (int i = 0; i < kWTM; ++i)
#pragma unroll
    for (int j = 0; j < kWTN; ++j)
      tile_s[(row_l + i) * Wide::kPitch + col_l + j] = acc[i][j];
  consumers_sync();
  float* om = a.out + static_cast<long long>(m) * L * LC;
  for (int e = threadIdx.x; e < kWRows * kWGroup; e += kWConsumers) {
    const int rr = e / kWGroup, cc = e % kWGroup;
    const int r = i0 + rr, c = j0 + cc;
    if (r < L && c < LC && (c >= L || c >= r))
      om[static_cast<long long>(r) * LC + c] = tile_s[rr * Wide::kPitch + cc];
  }
  if (j0 < L) {
    for (int e = threadIdx.x; e < kWRows * kWGroup; e += kWConsumers) {
      const int cc = e / kWRows, rr = e % kWRows;
      const int r = i0 + rr, c = j0 + cc;
      if (c < L && c > r)
        om[static_cast<long long>(c) * LC + r] = tile_s[rr * Wide::kPitch + cc];
    }
  }
}

// strip: a split's block holds whole rows of [H | T] and each consumer
// thread one 8 x 8 sub-block of U's upper part or of V

constexpr int kSub = 8;              // a thread's sub-block: 8 x 8 outputs
constexpr int kSST = 3;              // stages in the strip's ring
constexpr int kStripMaxGroups = 4;   // row width: up to 4 groups of 64
constexpr int kStripMaxThreads = 448;   // consumers (<= 416) + the producer

// the dynamic shared memory of a strip block of G groups
struct Strip {
  static constexpr int kBox = kWKC * kWGroup;   // floats of a group tile
  static int bytes(int G) {
    return kSST * (G * kBox + kWKC) * 4 + 2 * kSST * 8 + 1024;
  }
};

// sub-block t -> (row group a, column group b), b >= a: row group a holds
// the column groups from a to ncg - 1
__device__ __forceinline__ void sub_of(int t, int ncg, int* a, int* b) {
  int i = 0;
  while (t >= ncg - i) {
    t -= ncg - i;
    ++i;
  }
  *a = i;
  *b = i + t;
}

struct StripArgs {
  CUtensorMap hmap;  // (L, n, k) f32, boxes of 64 columns x 32 rows
  const float* h;
  const float* t;
  const float* mask;
  float* part;  // (k, chunks, 64, subs): sub-block t's element e at
                //   e * subs + t
  int n, L, C, rows, tma, groups, ncg, subs;
};

template <bool kMasked>
__global__ void __launch_bounds__(kStripMaxThreads, 1)
    strip_kernel(const __grid_constant__ StripArgs a) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm =
      smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  const uint32_t sa = smem_addr(sm);
  const int G = a.groups;
  float* const ring = reinterpret_cast<float*>(sm);
  float* const m_s = ring + kSST * G * Strip::kBox;
  const uint32_t bars = sa + kSST * (G * Strip::kBox + kWKC) * 4;
  const auto full = [&](int st) { return bars + 8 * st; };
  const auto empty = [&](int st) { return bars + 8 * (kSST + st); };
  // group g of stage st
  const auto at = [&](int st, int g) {
    return ring + (st * G + g) * Strip::kBox;
  };
  const int consumers = blockDim.x - 32;
  const int warps = consumers / 32;

  const int chunk = blockIdx.x, m = blockIdx.y;
  const int n = a.n, L = a.L, C = a.C, LC = L + C;
  const int r_begin = chunk * a.rows;
  const int r_end = min(n, r_begin + a.rows);
  const int stages = cdiv(r_end - r_begin, kWKC);

  if (threadIdx.x == 0) {
    for (int st = 0; st < kSST; ++st) {
      bar_init(full(st), 32);
      bar_init(empty(st), warps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= consumers) {
    // ---- the producer warp: stage s holds rows r_begin + 32 s .. + 31 of
    // every group: by TMA inside H, by copies at T's columns
    const int lane = threadIdx.x - consumers;
    const float* hm = a.h + static_cast<long long>(m) * n * L;
    const float* tm = a.t + static_cast<long long>(m) * n * C;
    int tma_groups = 0;
    for (int g = 0; g < G; ++g)
      if (a.tma && kWGroup * (g + 1) <= L) tma_groups |= 1 << g;
    // a group of T alone has zeros past L + C, stored once into every stage
    for (int g = 0; g < G; ++g) {
      const int j = kWGroup * g, w = min(kWGroup, LC - j);
      if (j < L || w == kWGroup) continue;
      for (int e = lane; e < kSST * kWKC * (kWGroup - w); e += 32) {
        const int st = e / (kWKC * (kWGroup - w));
        const int rest = e % (kWKC * (kWGroup - w));
        at(st, g)[(rest / (kWGroup - w)) * kWGroup + w +
                  rest % (kWGroup - w)] = 0.0f;
      }
    }
    for (int s = 0; s < stages; ++s) {
      const int st = s % kSST, round = s / kSST;
      if (round > 0) bar_wait(empty(st), (round - 1) & 1);
      const int r0 = r_begin + s * kWKC;
      if (tma_groups && lane == 0) {
        bar_expect_tx(full(st), 4 * Strip::kBox * __popc(tma_groups));
        for (int g = 0; g < G; ++g)
          if (tma_groups >> g & 1)
            tma_box(smem_addr(at(st, g)), &a.hmap, full(st), kWGroup * g, r0,
                    m);
      }
      for (int g = 0; g < G; ++g)
        if (!(tma_groups >> g & 1))
          copy_group(at(st, g), hm, tm, n, L, C, LC, kWGroup * g, r0, lane);
      if (kMasked) copy_weights(m_s + st * kWKC, a.mask, m, n, r0, lane);
      bar_track_copies(full(st));
      bar_arrive(full(st));
    }
    return;
  }

  // ---- the consumers: sub-block t, rows 8 sb_a .., columns 8 sb_b ..;
  // consecutive threads take consecutive column groups of a row group, and
  // a thread reads its columns' second half first where (b / 4) is odd,
  // so the 8 threads of a quarter-warp hit 8 different 16-byte bank groups
  const int t = threadIdx.x, lane = threadIdx.x % 32;
  const bool mine = t < a.subs;
  int sb_a = 0, sb_b = 0;
  if (mine) sub_of(t, a.ncg, &sb_a, &sb_b);
  const int half = ((sb_b >> 2) & 1) * 4;
  const int a_off = (sb_a * kSub / kWGroup) * Strip::kBox +
                    (sb_a * kSub) % kWGroup;
  const int b_off = (sb_b * kSub / kWGroup) * Strip::kBox +
                    (sb_b * kSub) % kWGroup;

  float acc[kSub][kSub];  // acc[i][j]: row 8 a + i, column 8 b + (half+j)%8
#pragma unroll
  for (int i = 0; i < kSub; ++i)
#pragma unroll
    for (int j = 0; j < kSub; ++j) acc[i][j] = 0.0f;

  for (int s = 0; s < stages; ++s) {
    const int st = s % kSST;
    bar_wait(full(st), (s / kSST) & 1);
    if (mine) {
      const float* as = at(st, 0) + a_off;
      const float* bs = at(st, 0) + b_off;
      const float* w = m_s + st * kWKC;
#pragma unroll 8
      for (int rr = 0; rr < kWKC; ++rr) {
        float av[kSub], bv[kSub];
        *reinterpret_cast<float4*>(av) =
            *reinterpret_cast<const float4*>(as + rr * kWGroup);
        *reinterpret_cast<float4*>(av + 4) =
            *reinterpret_cast<const float4*>(as + rr * kWGroup + 4);
        *reinterpret_cast<float4*>(bv) =
            *reinterpret_cast<const float4*>(bs + rr * kWGroup + half);
        *reinterpret_cast<float4*>(bv + 4) =
            *reinterpret_cast<const float4*>(bs + rr * kWGroup + 4 - half);
        if (kMasked) {
          const float mw = w[rr];
#pragma unroll
          for (int i = 0; i < kSub; ++i) av[i] *= mw;
        }
#pragma unroll
        for (int i = 0; i < kSub; ++i)
#pragma unroll
          for (int j = 0; j < kSub; ++j)
            acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
      }
    }
    __syncwarp();
    if (lane == 0) bar_arrive(empty(st));
  }

  if (!mine) return;
  // this chunk's partial sums, element e = 8 i + column of the sub-block
  float* p = a.part + (static_cast<long long>(m) * gridDim.x + chunk) *
                          kSub * kSub * a.subs + t;
#pragma unroll
  for (int i = 0; i < kSub; ++i)
#pragma unroll
    for (int j = 0; j < kSub; ++j)
      p[static_cast<long long>(i * kSub + (half + j) % kSub) * a.subs] =
          acc[i][j];
}

// pass 2 of a strip split: a thread adds one output's partials in chunk
// order and writes it, and its mirror in U
__global__ void __launch_bounds__(256)
    strip_sum_kernel(const float* __restrict__ part, float* __restrict__ out,
                     int L, int C, int ncg, int subs, int chunks) {
  const int m = blockIdx.y;
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  if (x >= kSub * kSub * subs) return;
  const int e = x / subs, t = x % subs;
  int sa, sb;
  sub_of(t, ncg, &sa, &sb);
  const int r = sa * kSub + e / kSub, c = sb * kSub + e % kSub;
  const int LC = L + C;
  if (r >= L || c >= LC || (c < L && c < r)) return;
  const long long step = static_cast<long long>(kSub) * kSub * subs;
  const float* p = part + static_cast<long long>(m) * chunks * step + x;
  float s = p[0];
#pragma unroll 8
  for (int q = 1; q < chunks; ++q) s += p[q * step];
  float* om = out + static_cast<long long>(m) * L * LC;
  om[static_cast<long long>(r) * LC + c] = s;
  if (c < L && c > r) om[static_cast<long long>(c) * LC + r] = s;
}

// ---- host: the tensor map of h, (L, n, k) f32, boxes of 64 x 32
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

bool make_map(CUtensorMap* map, const float* h, int k, int n, int L) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(L),
                              static_cast<cuuint64_t>(n),
                              static_cast<cuuint64_t>(k)};
  const cuuint64_t strides[2] = {4ull * L, 4ull * L * n};
  const cuuint32_t box[3] = {kWGroup, kWKC, 1};
  const cuuint32_t ones[3] = {1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3,
                const_cast<float*>(h), dims, strides, box, ones,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

int narrow_tiles(int L, int C, int* col_tiles) {
  *col_tiles = cdiv(L + C, kNTile);
  int tiles = 0;
  for (int bi = 0; bi < cdiv(L, kNTile); ++bi) tiles += *col_tiles - bi;
  return tiles;
}

int wide_tiles(int L, int C) {
  int tiles = 0;
  for (int bi = 0; bi < cdiv(L, kWRows); ++bi)
    tiles += cdiv(L + C - bi * kWRows, kWGroup);
  return tiles;
}

int launch_wide(const WideArgs& a, int k, bool masked, cudaStream_t s) {
  const auto kernel = masked ? wide_kernel<true> : wide_kernel<false>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, Wide::kBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<dim3(wide_tiles(a.L, a.C), k), kWThreads, Wide::kBytes, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

int strip_subs(int L, int C, int* ncg) {
  *ncg = cdiv(L + C, kSub);
  int subs = 0;
  for (int i = 0; i < cdiv(L, kSub); ++i) subs += *ncg - i;
  return subs;
}

// the strip's two passes; part_elems, the workspace's floats, must be the
// partial sums' (k, chunks, 64, sub-blocks)
int launch_strip(StripArgs& a, int k, int chunks, long long part_elems,
                 float* out, bool masked, cudaStream_t s) {
  a.subs = strip_subs(a.L, a.C, &a.ncg);
  a.groups = cdiv(a.ncg * kSub, kWGroup);
  const int threads = cdiv(a.subs, 32) * 32 + 32;
  if (a.groups > kStripMaxGroups || threads > kStripMaxThreads ||
      part_elems != static_cast<long long>(k) * chunks * kSub * kSub * a.subs)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto kernel = masked ? strip_kernel<true> : strip_kernel<false>;
  const int bytes = Strip::bytes(a.groups);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<dim3(chunks, k), threads, bytes, s>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  strip_sum_kernel<<<dim3(cdiv(kSub * kSub * a.subs, 256), k), 256, 0, s>>>(
      a.part, out, a.L, a.C, a.ncg, a.subs, chunks);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// kind: the instantiation, 0 narrow, 1 wide (one pass over all n rows),
// 2 strip (a split: two passes); rows: the rows of a strip's chunk, a
// multiple of 32 below n (n for the others); part: the strip's partial
// sums, part_elems floats, (k, chunks, 64, sub-blocks) (NULL and 0 for the
// others). Anything else is refused with cudaErrorInvalidValue.
extern "C" int elm_stats_f32(const float* h, const float* t, const float* mask,
                             float* part, long long part_elems, float* out,
                             int k, int n, int L, int C, int kind, int rows,
                             void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int chunks = rows >= n ? 1 : cdiv(n, rows);
  if (rows < 1 || kind < 0 || kind > 2 || (kind == 2) != (chunks > 1) ||
      (chunks > 1 && (!part || rows % kWKC != 0)) ||
      (chunks == 1 && (part || part_elems)))
    return static_cast<int>(cudaErrorInvalidValue);
  if (!kind) {
    int col_tiles;
    dim3 grid(narrow_tiles(L, C, &col_tiles), k);
    if (mask)
      narrow_kernel<true><<<grid, kNThreads, 0, s>>>(h, t, mask, out, n, L,
                                                     C, col_tiles);
    else
      narrow_kernel<false><<<grid, kNThreads, 0, s>>>(h, t, mask, out, n, L,
                                                      C, col_tiles);
    return static_cast<int>(cudaGetLastError());
  }
  // TMA: rows 16-byte strided, a 16-byte aligned base, and at least one
  // box of columns and rows (a smaller operand goes by cp.async)
  const bool tma = L % 4 == 0 && L >= kWGroup && n >= kWKC &&
                   reinterpret_cast<uintptr_t>(h) % 16 == 0;
  CUtensorMap map;
  if (tma && !make_map(&map, h, k, n, L))
    return static_cast<int>(cudaErrorNotSupported);
  if (kind == 2) {
    StripArgs a;
    a.hmap = map;
    a.h = h;
    a.t = t;
    a.mask = mask;
    a.part = part;
    a.n = n;
    a.L = L;
    a.C = C;
    a.rows = rows;
    a.tma = tma;
    return launch_strip(a, k, chunks, part_elems, out, mask, s);
  }
  WideArgs a;
  a.hmap = map;
  a.h = h;
  a.t = t;
  a.mask = mask;
  a.out = out;
  a.n = n;
  a.L = L;
  a.C = C;
  a.tma = tma;
  return launch_wide(a, k, mask, s);
}
