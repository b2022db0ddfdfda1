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
// Nothing is carried between blocks and there are no atomics: the result is
// deterministic.
//
// Shapes: h (k, n, L), t (k, n, C), mask (k, n) or NULL, out (k, L, L+C).
// Grid (L/16 tiles of rows, (L+C)/16 tiles of columns, k members).
//
// What bounds it on an H100: at the Map path's shapes (n = 200 rows,
// L = 192, C = 10) one launch does 2 n L (L+C) = 15.5 MFLOP per member on
// about 0.3 MB, ~50 FLOP per byte: above the f32 balance of the card
// (67 TFLOP/s over 3.35 TB/s, about 20), so the f32 CUDA-core rate bounds it
// - and at under a microsecond of ideal work, launch latency dominates.
//
// Design: 16x16 threads per block, one output element each, f32 accumulator.
// Rows stream through shared memory in chunks of 32: the block stages the
// 32x16 slice of Hm for its row tile (the mask multiplied in as the slice is
// loaded, so a row weight enters exactly once) and the 32x16 slice of [H | T]
// for its column tile (columns < L read H, the rest read T - the two are
// never concatenated in memory). Ragged edges - n not a multiple of 32, L
// and L+C not multiples of 16 - are masked at the load and at the store, not
// padded by copies; padded rows of a chunk are never summed. Each output
// sums its rows in order 0..n-1. Skipping U's lower triangle and tensor-core
// tiles are later optimisations.
#include <cuda_runtime.h>

namespace {

constexpr int kTile = 16;
constexpr int kChunk = 32;

__global__ void elm_stats_kernel(const float* __restrict__ h,
                                 const float* __restrict__ t,
                                 const float* __restrict__ mask,
                                 float* __restrict__ out,
                                 int n, int L, int C) {
  __shared__ float a_s[kChunk][kTile];  // Hm rows, this block's row tile
  __shared__ float b_s[kChunk][kTile];  // [H | T] rows, its column tile

  const int m = blockIdx.z;
  const int LC = L + C;
  const int i0 = blockIdx.x * kTile;
  const int j0 = blockIdx.y * kTile;
  const int tx = threadIdx.x;  // column within the tile
  const int ty = threadIdx.y;  // row within the tile
  const int tid = ty * kTile + tx;

  const float* hm = h + static_cast<long long>(m) * n * L;
  const float* tm = t + static_cast<long long>(m) * n * C;
  const float* mm = mask ? mask + static_cast<long long>(m) * n : nullptr;

  float acc = 0.0f;
  for (int r0 = 0; r0 < n; r0 += kChunk) {
    for (int e = tid; e < kChunk * kTile; e += kTile * kTile) {
      const int rr = e / kTile;
      const int cc = e % kTile;
      const int r = r0 + rr;
      float a = 0.0f;
      float b = 0.0f;
      if (r < n) {
        const long long row = static_cast<long long>(r);
        const int gi = i0 + cc;
        if (gi < L) {
          a = hm[row * L + gi];
          if (mm) a *= mm[r];
        }
        const int gj = j0 + cc;
        if (gj < L) {
          b = hm[row * L + gj];
        } else if (gj < LC) {
          b = tm[row * C + (gj - L)];
        }
      }
      a_s[rr][cc] = a;
      b_s[rr][cc] = b;
    }
    __syncthreads();
    const int rows = min(kChunk, n - r0);
    for (int rr = 0; rr < rows; ++rr) acc = fmaf(a_s[rr][ty], b_s[rr][tx], acc);
    __syncthreads();
  }

  const int gi = i0 + ty;
  const int gj = j0 + tx;
  if (gi < L && gj < LC) {
    out[static_cast<long long>(m) * L * LC + static_cast<long long>(gi) * LC +
        gj] = acc;
  }
}

}  // namespace

extern "C" int elm_stats_f32(const float* h, const float* t, const float* mask,
                             float* out, int k, int n, int L, int C,
                             void* stream) {
  dim3 block(kTile, kTile);
  dim3 grid((L + kTile - 1) / kTile, (L + C + kTile - 1) / kTile, k);
  elm_stats_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      h, t, mask, out, n, L, C);
  return static_cast<int>(cudaGetLastError());
}
