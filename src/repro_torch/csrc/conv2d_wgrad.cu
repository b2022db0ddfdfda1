// Weight gradient of the valid, stride-1 NHWC convolution, member-batched,
// f32: dW[m,i,j,ci,co] = sum over (b, oh, ow) of
// x[m,b,oh+i,ow+j,ci] * dY[m,b,oh,ow,co].
//
// Replaces: the TPU kernel src/repro/kernels/conv2d/kernel.py:28
// `_matmul_kernel` has no backward (no Pallas backward exists; the
// reference's SGD path differentiates `lax.conv`, its CPU route). This is
// the gradient of conv2d.cu's forward, the patch matrix's transpose times
// dY, without putting the patch matrix in device memory.
//
// Shapes: x (k, B, H, W, Cin), dY (k, B, OH, OW, Cout) -> dW (k, KH, KW,
// Cin, Cout), OH = H-KH+1, OW = W-KW+1.
//
// What bounds it on an H100: per member dW is a skinny product, M = the
// KH*KW*Cin taps by N = Cout, over a long K of B*OH*OW pixels. At the Map's
// shapes (k 4, B 200) stage 1 (28x28x1 -> 6) is bound by its bytes (x 2.5
// MB + dY 11.1 MB: 4.05 us) and stage 2 (12x12x6 -> 12) by its f32
// operations (184 MFLOP: 2.75 us). Neither is a tensor-core problem, and
// TF32 stays off: the FMAs are f32 on the CUDA cores.
//
// Design. An item is one kernel row i of the taps and TC of the output
// channels, over all Cin input channels: its KW x Cin x TC sums live in
// registers (30 at stage 1: Cin 1, TC 6; 60 at stage 2: Cin 6, TC 2). A
// thread walks the pixels of an output row (or of a segment of one) with
// a sliding window of KW pixels' Cin x values in registers, so a pixel
// costs Cin x values and TC dY values, 8-byte loads where they align, for
// KW * Cin * TC FMAs; the item varies fastest across a warp, so a warp's
// threads read a few rows and share those loads.
//
// A block takes one member and a chunk of images, and walks the chunk in
// tiles of GI images (or, for rows too wide for shared memory, bands of
// R output rows of one image): x rows and dY rows come into shared memory
// by cp.async, in a two-slot ring where a chunk has several tiles (the
// next tile's copies in flight while the threads compute on this one).
// Shared rows lie 4 mod 8 floats apart, so the rows a warp reads start in
// different banks. S threads share an item, each taking the tile's output
// rows (or segments) s, s+S, ... At the end the block adds its S sums of
// each output by a fixed tree in shared memory (the ring, reused) and
// writes one partial per output for its chunk; pass 2 adds each output's
// partials in a fixed order: a block takes 16 outputs, 16 threads each
// summing every 16th chunk, then those 16 in order, so the partials are
// read by coalesced loads from across the card, a few a thread.
//
// The configurations' shapes (5x5 kernels; Cin -> Cout of 1 -> 6 and
// 6 -> 12, 1 -> 3 and 3 -> 9, 1 -> 2 and 2 -> 4, on 28x28 and 12x12 inputs)
// are compile-time instantiations, so the pixel walk unrolls and the
// window rotates through registers; their S, GI and segments were chosen
// on the H100 with `tools/kernel_variants.py`. Every other shape goes
// through one generic instantiation: an item is (i, 4 taps, ci, 4
// channels), shapes from the arguments, loads guarded. The chunk (from
// the caller, a function of B alone), the tiles, the items and S follow
// from the shape alone, never from k or the card, and there are no float
// atomics: dW is the same bits from run to run and whatever the number of
// members beside it (the sequential and the stacked SGD Maps see the same
// gradient).
#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>

namespace {

constexpr int kGenericThreads = 256;     // the largest block
constexpr int kGenericRingFloats = 8 * 1024;   // a ring slot it aims at
constexpr int kMaxSmemBytes = 160 * 1024;
constexpr int kSumOuts = 16;             // pass 2: outputs a block
constexpr int kSumLanes = 16;            // pass 2: threads an output

__host__ __device__ constexpr int cdiv(int a, int b) { return (a + b - 1) / b; }
__host__ __device__ constexpr int round4(int a) { return (a + 3) & ~3; }
// the least multiple of 4 that is >= n and 4 mod 8: rows this far apart
// start in different groups of 4 banks, 8 rows in 8 groups
__host__ __device__ constexpr int pitch48(int n) {
  return round4(n) % 8 == 4 ? round4(n) : round4(n) + 4;
}

struct Args {
  const float* x;
  const float* dy;
  float* part;              // (k, chunks, outs) partial sums
  int B, H, W, Cin, KH, KW, Cout;
  int CB, chunks;           // images a chunk; chunks a member
  int GI, R, NSEG, SEGW;    // a tile: GI images x R output rows, a row in
                            // NSEG segments of SEGW pixels
  int S;                    // threads an item
  int IT, items;            // items a block (a tile of items); all items
  int JG, CG;               // tap groups and channel groups an item row
  int XP, DP;               // shared pitch of an x row, of a dY row
  int ring;                 // floats of one ring slot
};

__host__ __device__ inline int x_floats(const Args& a) {
  return round4(a.GI * (a.R + a.KH - 1) * a.XP);
}

__device__ inline bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}
__device__ inline unsigned shared_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
__device__ inline void cp_async4(float* s, const float* g) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
               ::"r"(shared_addr(s)), "l"(g));
}
__device__ inline void cp_async16(float* s, const float* g) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               ::"r"(shared_addr(s)), "l"(g));
}
__device__ inline void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// all but the newest group complete
__device__ inline void cp_async_wait_prior() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}
__device__ inline void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// nrows rows of seg floats, gstride apart in device memory and spitch apart
// in shared memory: a team of (up to) 32 threads a row, 16 bytes a thread
// where every row start is aligned (one flat run where the rows are
// contiguous on both sides), else float by float.
__device__ inline void copy_rows(float* s, int spitch, const float* g,
                                 int gstride, int nrows, int seg) {
  const int size = min(32, static_cast<int>(blockDim.x));
  const int teams = blockDim.x / size, team = threadIdx.x / size;
  const int lane = threadIdx.x % size;
  if (seg % 4 == 0 && spitch % 4 == 0 && gstride % 4 == 0 && aligned16(g)) {
    if (seg == spitch && seg == gstride) {
      for (int i = 4 * threadIdx.x; i < nrows * seg; i += 4 * blockDim.x)
        cp_async16(s + i, g + i);
      return;
    }
    for (int r = team; team < teams && r < nrows; r += teams)
      for (int c = 4 * lane; c < seg; c += 4 * size)
        cp_async16(s + r * spitch + c,
                   g + static_cast<long long>(r) * gstride + c);
  } else {
    for (int r = team; team < teams && r < nrows; r += teams)
      for (int c = lane; c < seg; c += size)
        cp_async4(s + r * spitch + c,
                  g + static_cast<long long>(r) * gstride + c);
  }
}

// One tile of a chunk: its first image, images, first output row, rows.
struct Tile {
  int b0, imgs, r0, rows;
};

__device__ inline Tile tile_of(const Args& a, int chunk, int t) {
  const int OH = a.H - a.KH + 1;
  const int bands = cdiv(OH, a.R);
  const int c0 = chunk * a.CB, c1 = min(a.B, c0 + a.CB);
  Tile s;
  s.b0 = c0 + (t / bands) * a.GI;
  s.imgs = min(a.GI, c1 - s.b0);
  s.r0 = (t % bands) * a.R;
  s.rows = min(a.R, OH - s.r0);
  return s;
}

// Queue the copies of tile t of the block's chunk into ring slot `slot`:
// its x rows (with several images a tile holds whole images, whose rows
// follow one another) and its dY rows.
__device__ inline void stage(const Args& a, int m, int chunk, int t,
                             float* slot) {
  const int OH = a.H - a.KH + 1, OW = a.W - a.KW + 1;
  const Tile s = tile_of(a, chunk, t);
  const long long img = static_cast<long long>(m) * a.B + s.b0;
  copy_rows(slot, a.XP, a.x + (img * a.H + s.r0) * a.W * a.Cin,
            a.W * a.Cin, s.imgs * (s.rows + a.KH - 1), a.W * a.Cin);
  copy_rows(slot + x_floats(a), a.DP, a.dy + (img * OH + s.r0) * OW * a.Cout,
            OW * a.Cout, s.imgs * s.rows, OW * a.Cout);
}

// The sums of an item: TJ taps x NCI input channels x TC output channels.
// FIXED: the shape is compile-time (TJ = KW, all NCI = Cin channels, TC of
// the COUT channels from c0), a segment is SEGW pixels and the walk
// unrolls; else the generic item (4 taps from j0, the channel of `xrow`, 4
// channels from c0) with guarded loads.
template <int TJ, int NCI, int TC, int COUT, int SEGW, bool FIXED>
__device__ inline void walk(const Args& a, const float* xrow,
                            const float* drow, int ow0, int ow1, int j0,
                            int c0, float (&acc)[TJ][NCI][TC]) {
  const int cin = FIXED ? NCI : a.Cin;
  const int cout = FIXED ? COUT : a.Cout;
  constexpr int VX = !FIXED ? 1 : NCI % 4 == 0 ? 4 : NCI % 2 == 0 ? 2 : 1;
  constexpr int VD = !FIXED ? 1
                     : TC % 4 == 0 && COUT % 4 == 0 ? 4
                     : TC % 2 == 0 && COUT % 2 == 0 ? 2 : 1;
  // the window holds x[ow + j0 + jj], jj < TJ, at pixel ow; a generic
  // item's taps past KW read what lies in the row (or 0 past its end) into
  // sums that are never written
  float xw[TJ][NCI];
  auto load_x = [&](float (&v)[NCI], int pos) {
    const float* p = xrow + pos * cin;
#pragma unroll
    for (int c = 0; c < NCI; c += VX) {
      if constexpr (VX == 4) {
        const float4 t = *reinterpret_cast<const float4*>(p + c);
        v[c] = t.x; v[c + 1] = t.y; v[c + 2] = t.z; v[c + 3] = t.w;
      } else if constexpr (VX == 2) {
        const float2 t = *reinterpret_cast<const float2*>(p + c);
        v[c] = t.x; v[c + 1] = t.y;
      } else {
        v[c] = (FIXED || pos < a.W) ? p[c] : 0.0f;
      }
    }
  };
#pragma unroll
  for (int jj = 0; jj + 1 < TJ; ++jj) load_x(xw[jj + 1], ow0 + j0 + jj);
  auto pixel = [&](int ow) {
#pragma unroll
    for (int jj = 0; jj + 1 < TJ; ++jj)
#pragma unroll
      for (int c = 0; c < NCI; ++c) xw[jj][c] = xw[jj + 1][c];
    load_x(xw[TJ - 1], ow + j0 + TJ - 1);
    const float* d = drow + ow * cout + c0;
    float dv[TC];
#pragma unroll
    for (int q = 0; q < TC; q += VD) {
      if constexpr (VD == 4) {
        const float4 v = *reinterpret_cast<const float4*>(d + q);
        dv[q] = v.x; dv[q + 1] = v.y; dv[q + 2] = v.z; dv[q + 3] = v.w;
      } else if constexpr (VD == 2) {
        const float2 v = *reinterpret_cast<const float2*>(d + q);
        dv[q] = v.x; dv[q + 1] = v.y;
      } else {
        dv[q] = (FIXED || c0 + q < cout) ? d[q] : 0.0f;
      }
    }
#pragma unroll
    for (int jj = 0; jj < TJ; ++jj)
#pragma unroll
      for (int c = 0; c < NCI; ++c)
#pragma unroll
        for (int q = 0; q < TC; ++q)
          acc[jj][c][q] = fmaf(xw[jj][c], dv[q], acc[jj][c][q]);
  };
  if constexpr (FIXED) {
#pragma unroll
    for (int t = 0; t < SEGW; ++t) pixel(ow0 + t);
  } else {
    for (int ow = ow0; ow < ow1; ++ow) pixel(ow);
  }
}

// KH == 0 is the generic instantiation. A compile-time shape is square,
// its tiles whole images of OH = SEGW * NSEG output rows.
template <int KH, int KW, int CIN, int COUT, int TC_, int SEGW, int NSEG>
__global__ void __launch_bounds__(kGenericThreads)
    wgrad_partial_kernel(const Args a) {
  constexpr bool FIXED = KH > 0;
  constexpr int TJ = FIXED ? KW : 4;
  constexpr int NCI = FIXED ? CIN : 1;
  constexpr int TC = FIXED ? TC_ : 4;
  constexpr int NQ = TJ * NCI * TC;
  extern __shared__ float4 smem4[];
  float* ring = reinterpret_cast<float*>(smem4);
  const int chunk = blockIdx.x, m = blockIdx.y;
  const int OH = a.H - a.KH + 1, OW = a.W - a.KW + 1;

  // this thread's item and split; the item varies fastest, so a warp's
  // threads walk the same few rows and share their loads
  const int local = threadIdx.x % a.IT, s = threadIdx.x / a.IT;
  const int item = blockIdx.z * a.IT + local;
  const bool active = s < a.S && item < a.items;
  int i, ci0 = 0, j0 = 0, c0;
  if constexpr (FIXED) {
    i = item / (COUT / TC);
    c0 = item % (COUT / TC) * TC;
  } else {
    c0 = 4 * (item % a.CG);
    ci0 = (item / a.CG) % a.Cin;
    j0 = 4 * ((item / (a.CG * a.Cin)) % a.JG);
    i = item / (a.CG * a.Cin * a.JG);
  }

  float acc[TJ][NCI][TC];
#pragma unroll
  for (int jj = 0; jj < TJ; ++jj)
#pragma unroll
    for (int c = 0; c < NCI; ++c)
#pragma unroll
      for (int q = 0; q < TC; ++q) acc[jj][c][q] = 0.0f;

  const int c_imgs = min(a.B, (chunk + 1) * a.CB) - chunk * a.CB;
  const int tiles = cdiv(c_imgs, a.GI) * cdiv(OH, a.R);
  stage(a, m, chunk, 0, ring);
  cp_async_commit();
  for (int t = 0; t < tiles; ++t) {
    float* slot = ring + (t & 1) * a.ring;
    if (t + 1 < tiles) {
      stage(a, m, chunk, t + 1, ring + ((t + 1) & 1) * a.ring);
      cp_async_commit();
      cp_async_wait_prior();
    } else {
      cp_async_wait_all();
    }
    __syncthreads();
    if (active) {
      const Tile tl = tile_of(a, chunk, t);
      const float* xs = slot + ci0;
      const float* ds = slot + x_floats(a);
      // compile-time divisors where the shape is
      const int rows = FIXED ? SEGW * NSEG : tl.rows;
      const int nseg = FIXED ? NSEG : a.NSEG;
      const int units = tl.imgs * nseg * rows;
      // a unit: image g, segment sg, output row r (fastest)
      for (int u = s; u < units; u += a.S) {
        const int r = u % rows, rest = u / rows;
        const int sg = rest % nseg, g = rest / nseg;
        const float* xrow = xs + (g * (a.R + a.KH - 1) + r + i) * a.XP;
        const float* drow = ds + (g * a.R + r) * a.DP;
        const int ow0 = sg * a.SEGW;
        walk<TJ, NCI, TC, COUT, SEGW, FIXED>(
            a, xrow, drow, ow0, min(OW, ow0 + a.SEGW), j0, c0, acc);
      }
    }
    __syncthreads();    // this slot is free for the copies of tile t + 2
  }

  // The S sums of each output, added by a fixed tree through shared memory
  // (the ring, reused): at each level the splits [h, 2h) hand their sums to
  // the splits [0, h), which add them to their own.
  int h = 1;
  while (2 * h < a.S) h *= 2;
  for (; h >= 1; h /= 2) {
    if (active && s >= h && s < 2 * h) {
      float* red = ring + ((s - h) * a.IT + local) * NQ;
#pragma unroll
      for (int jj = 0; jj < TJ; ++jj)
#pragma unroll
        for (int c = 0; c < NCI; ++c)
#pragma unroll
          for (int q = 0; q < TC; ++q)
            red[(jj * NCI + c) * TC + q] = acc[jj][c][q];
    }
    __syncthreads();
    if (active && s < h && s + h < a.S) {
      const float* red = ring + (s * a.IT + local) * NQ;
#pragma unroll
      for (int jj = 0; jj < TJ; ++jj)
#pragma unroll
        for (int c = 0; c < NCI; ++c)
#pragma unroll
          for (int q = 0; q < TC; ++q)
            acc[jj][c][q] += red[(jj * NCI + c) * TC + q];
    }
    __syncthreads();
  }
  if (!active || s != 0) return;
  // split 0 holds the block's sums: one partial per output for its chunk
  const int outs = a.KH * a.KW * a.Cin * a.Cout;
  float* out = a.part + (static_cast<long long>(m) * a.chunks + chunk) * outs;
#pragma unroll
  for (int jj = 0; jj < TJ; ++jj)
#pragma unroll
    for (int c = 0; c < NCI; ++c)
#pragma unroll
      for (int q = 0; q < TC; ++q)
        if (FIXED || (j0 + jj < a.KW && c0 + q < a.Cout))
          out[((i * a.KW + j0 + jj) * a.Cin + ci0 + c) * a.Cout + c0 + q] =
              acc[jj][c][q];
}

// dW[m, o] = the sum of part[m, c, o] over the chunks c: thread (o, l)
// adds the chunks l, l + 16, ... in order (their loads issued together),
// then thread (o, 0) adds those 16 sums in order.
__global__ void __launch_bounds__(kSumOuts * kSumLanes)
    wgrad_sum_kernel(const float* part, float* dw, int outs, int chunks) {
  __shared__ float red[kSumLanes][kSumOuts];
  const int ol = threadIdx.x % kSumOuts, l = threadIdx.x / kSumOuts;
  const int o = blockIdx.x * kSumOuts + ol, m = blockIdx.y;
  float v = 0.0f;
  if (o < outs) {
    const float* p = part + static_cast<long long>(m) * chunks * outs + o;
#pragma unroll 4
    for (int c = l; c < chunks; c += kSumLanes)
      v += p[static_cast<long long>(c) * outs];
  }
  red[l][ol] = v;
  __syncthreads();
  if (l == 0 && o < outs) {
    float sum = red[0][ol];
#pragma unroll
    for (int t = 1; t < kSumLanes; ++t) sum += red[t][ol];
    dw[static_cast<long long>(m) * outs + o] = sum;
  }
}

// The plan of a compile-time shape: an item is a kernel row i and TC
// output channels, over all Cin; S threads an item; tiles of GI whole
// images; rows in NSEG segments.
template <int KH, int CIN, int COUT, int TC>
void plan_fixed(Args& a, int S, int GI, int NSEG) {
  const int OH = a.H - a.KH + 1, OW = a.W - a.KW + 1;
  a.JG = 1;
  a.CG = COUT / TC;
  a.items = a.IT = KH * a.CG;
  a.S = S;
  a.GI = std::min(GI, a.CB);
  a.R = OH;
  a.NSEG = NSEG;
  a.SEGW = OW / NSEG;
}

// The generic plan: items of 4 taps x one input channel x 4 output
// channels, tiles of up to 256; one segment a row; whole images while a
// slot holds at least one, else bands of rows halved until they fit.
void plan_generic(Args& a) {
  const int OH = a.H - a.KH + 1, OW = a.W - a.KW + 1;
  a.JG = cdiv(a.KW, 4);
  a.CG = cdiv(a.Cout, 4);
  a.items = a.KH * a.JG * a.Cin * a.CG;
  a.IT = std::min(a.items, kGenericThreads);
  a.NSEG = 1;
  a.SEGW = OW;
  a.GI = 1;
  a.R = OH;
  auto slot = [&] {
    return x_floats(a) + round4(a.GI * a.R * a.DP);
  };
  while (a.R > 1 && slot() > kGenericRingFloats) a.R = cdiv(a.R, 2);
  if (a.R == OH)
    a.GI = std::max(1, std::min(a.CB, kGenericRingFloats / slot()));
  a.S = std::max(1, std::min(kGenericThreads / a.IT, a.GI * a.R));
}

template <int KH, int KW, int CIN, int COUT, int TC, int SEGW, int NSEG>
int run(Args a, int k, cudaStream_t stream) {
  constexpr int NQ = KH > 0 ? KW * CIN * TC : 16;
  a.ring = x_floats(a) + round4(a.GI * a.R * a.DP);
  int h = 1;
  while (2 * h < a.S) h *= 2;
  // the ring's slots (one where a chunk is one tile), or the first level
  // of the final sums
  const int slots = cdiv(a.CB, a.GI) * cdiv(a.H - a.KH + 1, a.R) > 1 ? 2 : 1;
  const int smem = 4 * std::max(slots * a.ring, h * a.IT * NQ);
  if (smem > kMaxSmemBytes) return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = wgrad_partial_kernel<KH, KW, CIN, COUT, TC, SEGW, NSEG>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid(a.chunks, k, cdiv(a.items, a.IT));
  kernel<<<grid, a.IT * a.S, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// (Cin, Cout, input side, channels an item, S, GI, NSEG)
template <int CIN, int COUT, int HW, int TC, int S, int GI, int NSEG>
int run_fixed(Args a, int k, cudaStream_t stream) {
  plan_fixed<5, CIN, COUT, TC>(a, S, GI, NSEG);
  return run<5, 5, CIN, COUT, TC, (HW - 4) / NSEG, NSEG>(a, k, stream);
}

}  // namespace

// Both passes on `stream`, for chunks of G images (the caller's choice, a
// function of B alone; `part` holds k * cdiv(B, G) * KH*KW*Cin*Cout
// floats); returns cudaGetLastError(), or cudaErrorInvalidValue when one
// band of one output row of the shape does not fit in shared memory.
extern "C" int conv2d_wgrad_f32(const float* x, const float* dy, float* part,
                                float* dw, int k, int B, int H, int W, int Cin,
                                int KH, int KW, int Cout, int G,
                                void* stream) {
  Args a{};
  a.x = x;
  a.dy = dy;
  a.part = part;
  a.B = B; a.H = H; a.W = W; a.Cin = Cin; a.KH = KH; a.KW = KW; a.Cout = Cout;
  a.CB = G;
  a.chunks = cdiv(B, G);
  a.XP = pitch48(W * Cin);
  a.DP = pitch48((W - KW + 1) * Cout);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int err;
  // stage 1 of each configuration (28x28: tiles of 2 images, output rows
  // in two segments of 12 pixels) and stage 2 (12x12: a tile of 4 images,
  // the chunk of the Map's batch, so the block stages once)
  const bool k5 = KH == 5 && KW == 5;
  if (k5 && H == 28 && W == 28 && Cin == 1 && Cout == 6)
    err = run_fixed<1, 6, 28, 6, 48, 2, 2>(a, k, s);
  else if (k5 && H == 12 && W == 12 && Cin == 6 && Cout == 12)
    err = run_fixed<6, 12, 12, 2, 8, 4, 1>(a, k, s);
  else if (k5 && H == 28 && W == 28 && Cin == 1 && Cout == 3)
    err = run_fixed<1, 3, 28, 3, 32, 2, 2>(a, k, s);
  else if (k5 && H == 12 && W == 12 && Cin == 3 && Cout == 9)
    err = run_fixed<3, 9, 12, 3, 16, 4, 1>(a, k, s);
  else if (k5 && H == 28 && W == 28 && Cin == 1 && Cout == 2)
    err = run_fixed<1, 2, 28, 2, 32, 2, 2>(a, k, s);
  else if (k5 && H == 12 && W == 12 && Cin == 2 && Cout == 4)
    err = run_fixed<2, 4, 12, 2, 16, 4, 1>(a, k, s);
  else {
    plan_generic(a);
    err = run<0, 0, 0, 0, 0, 0, 0>(a, k, s);
  }
  if (err != cudaSuccess) return err;
  const int outs = KH * KW * Cin * Cout;
  wgrad_sum_kernel<<<dim3(cdiv(outs, kSumOuts), k), kSumOuts * kSumLanes, 0,
                     s>>>(part, dw, outs, a.chunks);
  return static_cast<int>(cudaGetLastError());
}
