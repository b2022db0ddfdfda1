// Valid, stride-1 NHWC convolution with HWIO weights, member-batched, f32.
//
// Replaces: src/repro/kernels/conv2d/kernel.py:28 `_matmul_kernel`, launched
// by `_blocked_matmul` (:44, pallas_call at :53) on the patch matrix that
// conv2d/ops.py:24 `_conv2d_valid` builds with `ref.im2col`. It computes the
// same function without putting the patch matrix in device memory: a direct
// (implicit-GEMM) convolution that reads each patch from an image tile in
// shared memory.
//
// Shapes: x (k, B, H, W, Cin), w (k, kh, kw, Cin, Cout) -> y (k, B, OH, OW,
// Cout) with OH = H-kh+1, OW = W-kw+1. Grid axis y runs over the k members;
// the sequential Map path passes k = 1.
//
// What bounds it on an H100: at the CNN-ELM's shapes a conv does 2-3 FLOP
// per byte it must move, against the card's f32 balance of 67 TFLOP/s over
// 3.35 TB/s (about 20). The first stage (k 4, B 200, 28x28x1 -> 24x24x6) is
// bound by its bytes, mostly y's: 13.6 MB, 4.05 us. The second (12x12x6 ->
// 8x8x12, a patch of 150) is bound by its f32 operations: 184 MFLOP,
// 2.75 us.
//
// Design. A block takes one member and a tile of its output: a few whole
// images, or, when there are too few images to fill the SMs, a band of
// output rows of one image (and, for shapes whose rows do not fit in shared
// memory, a band of columns). It copies the member's weights and the tile's
// input rows into shared memory by cp.async, 16 bytes at a time where the
// rows are contiguous and aligned. Each thread then computes an item: P
// adjacent output pixels of one row and CQ of the channels, in registers.
// A weight (read as a broadcast: the threads of a warp read the same
// address) serves P FMAs, and an x value, read once per kernel row, serves
// CQ FMAs at each of up to KW window positions. The outputs go back through
// shared memory, where the tile is laid out as in y, and leave with
// coalesced 16-byte stores.
//
// The shapes of the repo's configurations (5x5 kernels; Cin -> Cout of
// 1 -> 6, 6 -> 12, 1 -> 3, 3 -> 9 and the reduced configs' 1 -> 2, 2 -> 4)
// are compile-time instantiations, so the patch loops unroll. The host
// picks the item by the launch's size: 4 pixels and all channels where that
// gives enough items to fill the SMs (the Map's first stage); else 4 pixels
// and 4 channels (the Map's second stage: on the H100 a 16-byte weight load
// holds the SM's shared-memory pipe about as long as 4 FMA issues, so an
// item needs 4 pixels, and with all 12 channels there would be 3 warps an
// SM); else, on small launches (a scoring request of one image), 1 pixel
// and 4 channels, for the most threads (PERF.md has the measurements).
// Every other shape goes through one generic instantiation with runtime
// loops, an item being one pixel and four channels. The host also picks
// the tiling from the shape.
//
// Every output is one thread's fmaf chain over its patch in (kh, kw, Cin)
// order from 0 - the im2col column order of the reference - whatever the
// instantiation, the item or the tiling, so a member's result does not
// depend on k, B or the band split (the stacked and sequential Maps agree
// bitwise). No atomics, no split over the patch. Bias, ReLU and the
// mean-pool stay outside.
#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>

namespace {

constexpr int kThreads = 256;         // most threads a block runs
constexpr int kItemsPerBlock = 256;   // the work items a block aims at
constexpr int kMinBlocksPerSm = 2;    // tiles are cut until this many blocks
constexpr int kWide = 4;              // pixels an item on large launches
constexpr int kWideItemsPerSm = 128;  // items per SM that make a launch large
                                      // enough for kWide pixels an item
constexpr int kMaxSmemBytes = 200 * 1024;

__host__ __device__ constexpr int cdiv(int a, int b) { return (a + b - 1) / b; }
__host__ __device__ constexpr int round4(int a) { return (a + 3) & ~3; }

// The launch's arguments: the operands, the runtime shapes, and the tiling
// (images per tile G, output rows R, output columns C; tiles per image
// group along rows and columns).
struct Args {
  const float* x;
  const float* w;
  float* y;
  int B, H, W, Cin, KH, KW, Cout;
  int P;                   // pixels an item: 1, or kWide
  int CQ;                  // channels an item: all Cout, or 4
  int G, R, C;
  int row_tiles, col_tiles;
};

// Shared memory of a block, in floats: the member's weights (Cout padded to
// a multiple of 4 in the compile-time instantiations), the input tile (rows
// padded to a multiple of 4 floats, then room for the reads of a ragged
// last item: up to P-1 pixels and a vector's width past the last row), and
// the output tile.
struct Layout {
  int w, x, y;
};

__host__ __device__ inline Layout layout(const Args& a, bool fixed) {
  const int cout_pad = fixed ? round4(a.Cout) : a.Cout;
  const int in_rows = a.R + a.KH - 1;
  const int xpitch = round4((a.C + a.KW - 1) * a.Cin);
  Layout l;
  l.w = round4(a.KH * a.KW * a.Cin * cout_pad);
  l.x = round4(a.G * in_rows * xpitch + a.P * a.Cin + 4);
  l.y = a.G * a.R * round4(a.C * a.Cout);
  return l;
}

// One block's tile: which images, rows and columns, and where they lie.
struct Tile {
  int imgs, rows, cols;   // images, output rows per image, output columns
  int in_rows;            // input rows per image: rows + KH - 1
  int in_seg, xpitch;     // floats of an input row of the tile; its pitch
  int out_seg, ypitch;    // floats of an output row of the tile; its pitch
  long long xoff, yoff;   // offsets of the tile's first input / output float
};

__device__ inline Tile tile_of(const Args& a, int t, int m) {
  const int OH = a.H - a.KH + 1, OW = a.W - a.KW + 1;
  const int tc = t % a.col_tiles;
  t /= a.col_tiles;
  const int tr = t % a.row_tiles;
  const int b0 = (t / a.row_tiles) * a.G;
  const int oh0 = tr * a.R, ow0 = tc * a.C;
  Tile s;
  s.imgs = min(a.G, a.B - b0);
  s.rows = min(a.R, OH - oh0);
  s.cols = min(a.C, OW - ow0);
  s.in_rows = s.rows + a.KH - 1;
  s.in_seg = (s.cols + a.KW - 1) * a.Cin;
  s.xpitch = round4(s.in_seg);
  s.out_seg = s.cols * a.Cout;
  s.ypitch = round4(s.out_seg);
  // with several images a tile holds them whole (R = OH, C = OW), so its
  // input rows and its output rows each follow one another in memory
  s.xoff = ((static_cast<long long>(m) * a.B + b0) * a.H + oh0) * a.W * a.Cin +
           ow0 * a.Cin;
  s.yoff = ((static_cast<long long>(m) * a.B + b0) * OH + oh0) * OW * a.Cout +
           ow0 * a.Cout;
  return s;
}

__device__ inline bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// Copies from device memory into shared memory that stay in flight until
// cp_async_wait(): a thread issues all of its share before any completes,
// so a block of few threads does not wait out one load's latency per
// element it stages.
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
__device__ inline void cp_async_wait() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// nrows rows of seg floats, gstride apart in device memory and spitch apart
// in shared memory (whose base is 16-byte aligned). One 16-byte run when
// both sides are contiguous and aligned, else float by float.
__device__ inline void load_rows(float* s, int spitch, const float* g,
                                 int gstride, int nrows, int seg) {
  const int n = nrows * seg;
  if (seg == gstride && seg == spitch && aligned16(g)) {
    for (int i = 4 * threadIdx.x; i < n / 4 * 4; i += 4 * blockDim.x)
      cp_async16(s + i, g + i);
    for (int i = n / 4 * 4 + threadIdx.x; i < n; i += blockDim.x)
      cp_async4(s + i, g + i);
  } else {
    for (int i = threadIdx.x; i < n; i += blockDim.x) {
      const int r = i / seg, c = i - r * seg;
      cp_async4(s + r * spitch + c,
                g + static_cast<long long>(r) * gstride + c);
    }
  }
}

__device__ inline void store_rows(float* g, int gstride, const float* s,
                                  int spitch, int nrows, int seg) {
  const int n = nrows * seg;
  if (seg == gstride && seg == spitch && aligned16(g)) {
    float4* g4 = reinterpret_cast<float4*>(g);
    const float4* s4 = reinterpret_cast<const float4*>(s);
    for (int i = threadIdx.x; i < n / 4; i += blockDim.x) g4[i] = s4[i];
    for (int i = n / 4 * 4 + threadIdx.x; i < n; i += blockDim.x) g[i] = s[i];
  } else {
    for (int i = threadIdx.x; i < n; i += blockDim.x) {
      const int r = i / seg, c = i - r * seg;
      g[static_cast<long long>(r) * gstride + c] = s[r * spitch + c];
    }
  }
}

// Channel groups an item of CQ channels splits Cout into.
__host__ __device__ constexpr int channel_groups(int cout, int cq) {
  return cq >= cout ? 1 : cdiv(cout, cq);
}

// Items of the compile-time instantiations: P pixels of one output row and
// CQ channels, all COUT or a group of 4. The window's input row is read once
// per kernel row, with the widest loads its alignment allows (P*CIN floats
// apart); a weight is read once per tap for P pixels. The channel group
// varies slowest, so the threads of a warp read the same weights.
template <int KH, int KW, int CIN, int COUT, int P, int CQ>
__device__ inline void compute_fixed(const Tile& t, const float* ws,
                                     const float* xs, float* ys) {
  static_assert(CQ == COUT || CQ == 4, "an item takes all channels or 4");
  constexpr int COUTP = round4(COUT);
  constexpr int NG = channel_groups(COUT, CQ);
  constexpr int VX = (P * CIN) % 4 == 0 ? 4 : (P * CIN) % 2 == 0 ? 2 : 1;
  constexpr int SEG = cdiv((P + KW - 1) * CIN, VX) * VX;
  const int groups = cdiv(t.cols, P);
  const int per_group = t.imgs * t.rows * groups;
  for (int it = threadIdx.x; it < per_group * NG; it += blockDim.x) {
    const int c0 = it / per_group * CQ;       // first channel
    const int px = it % per_group;
    const int cg = px % groups;
    const int row = px / groups;              // image * rows + output row
    const int g = row / t.rows;
    const float* xw = xs + (row + g * (KH - 1)) * t.xpitch + cg * P * CIN;
    float acc[P][CQ];
#pragma unroll
    for (int p = 0; p < P; ++p)
#pragma unroll
      for (int co = 0; co < CQ; ++co) acc[p][co] = 0.0f;
#pragma unroll 1
    for (int kh = 0; kh < KH; ++kh) {
      float xv[SEG];
      const float* xr = xw + kh * t.xpitch;
#pragma unroll
      for (int j = 0; j < SEG; j += VX) {
        if constexpr (VX == 4) {
          const float4 v = *reinterpret_cast<const float4*>(xr + j);
          xv[j] = v.x; xv[j + 1] = v.y; xv[j + 2] = v.z; xv[j + 3] = v.w;
        } else if constexpr (VX == 2) {
          const float2 v = *reinterpret_cast<const float2*>(xr + j);
          xv[j] = v.x; xv[j + 1] = v.y;
        } else {
          xv[j] = xr[j];
        }
      }
      const float4* wk =
          reinterpret_cast<const float4*>(ws + kh * KW * CIN * COUTP + c0);
#pragma unroll
      for (int kw = 0; kw < KW; ++kw) {
#pragma unroll
        for (int ci = 0; ci < CIN; ++ci) {
          float wv[round4(CQ)];
#pragma unroll
          for (int q = 0; q < round4(CQ) / 4; ++q) {
            const float4 v = wk[(kw * CIN + ci) * (COUTP / 4) + q];
            wv[4 * q] = v.x; wv[4 * q + 1] = v.y;
            wv[4 * q + 2] = v.z; wv[4 * q + 3] = v.w;
          }
#pragma unroll
          for (int p = 0; p < P; ++p) {
            const float xval = xv[(p + kw) * CIN + ci];
#pragma unroll
            for (int co = 0; co < CQ; ++co)
              acc[p][co] = fmaf(xval, wv[co], acc[p][co]);
          }
        }
      }
    }
    // 16-byte stores where P pixels of all channels, or one pixel's group
    // of 4, are whole and aligned
    float* yo = ys + row * t.ypitch + cg * P * COUT + c0;
    const bool whole = (cg + 1) * P <= t.cols;
    if constexpr (NG == 1 && (P * COUT) % 4 == 0) {
      if (whole) {
#pragma unroll
        for (int j = 0; j < P * COUT; j += 4)
          *reinterpret_cast<float4*>(yo + j) = make_float4(
              acc[j / COUT][j % COUT], acc[(j + 1) / COUT][(j + 1) % COUT],
              acc[(j + 2) / COUT][(j + 2) % COUT],
              acc[(j + 3) / COUT][(j + 3) % COUT]);
        continue;
      }
    } else if constexpr (NG > 1 && COUT % 4 == 0) {
#pragma unroll
      for (int p = 0; p < P; ++p)
        if (cg * P + p < t.cols)
          *reinterpret_cast<float4*>(yo + p * COUT) = make_float4(
              acc[p][0], acc[p][1], acc[p][2], acc[p][3]);
      continue;
    }
#pragma unroll
    for (int p = 0; p < P; ++p)
      if (cg * P + p < t.cols)
#pragma unroll
        for (int co = 0; co < CQ; ++co)
          if (NG == 1 || c0 + co < COUT) yo[p * COUT + co] = acc[p][co];
  }
}

// Items of the generic instantiation: one pixel, four channels.
__device__ inline void compute_generic(const Args& a, const Tile& t,
                                       const float* ws, const float* xs,
                                       float* ys) {
  const int quads = cdiv(a.Cout, 4);
  const int items = t.imgs * t.rows * t.cols * quads;
  for (int it = threadIdx.x; it < items; it += blockDim.x) {
    const int cq = it % quads;
    const int px = it / quads;
    const int c = px % t.cols;
    const int row = px / t.cols;
    const int g = row / t.rows;
    const float* xw = xs + (row + g * (a.KH - 1)) * t.xpitch + c * a.Cin;
    const int co0 = 4 * cq;
    const int nco = min(4, a.Cout - co0);
    float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    for (int kh = 0; kh < a.KH; ++kh)
      for (int kw = 0; kw < a.KW; ++kw)
        for (int ci = 0; ci < a.Cin; ++ci) {
          const float xval = xw[kh * t.xpitch + kw * a.Cin + ci];
          const float* wr = ws + ((kh * a.KW + kw) * a.Cin + ci) * a.Cout + co0;
#pragma unroll
          for (int j = 0; j < 4; ++j)
            if (j < nco) acc[j] = fmaf(xval, wr[j], acc[j]);
        }
    float* yo = ys + row * t.ypitch + c * a.Cout + co0;
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (j < nco) yo[j] = acc[j];
  }
}

// KH == 0 is the generic instantiation: shapes from Args, P = 1, CQ = 4.
template <int KH, int KW, int CIN, int COUT, int P, int CQ>
__global__ void __launch_bounds__(kThreads)
    conv2d_tile_kernel(const Args a) {
  constexpr bool kFixed = KH > 0;
  extern __shared__ float4 smem4[];
  float* ws = reinterpret_cast<float*>(smem4);
  const Layout l = layout(a, kFixed);
  float* xs = ws + l.w;
  float* ys = xs + l.x;
  const int m = blockIdx.y;
  const Tile t = tile_of(a, blockIdx.x, m);

  const int taps = a.KH * a.KW * a.Cin;
  const float* wm = a.w + static_cast<long long>(m) * taps * a.Cout;
  if constexpr (kFixed) {
    constexpr int COUTP = round4(COUT);
    for (int i = threadIdx.x; i < KH * KW * CIN * COUTP; i += blockDim.x) {
      const int j = i / COUTP, co = i - j * COUTP;
      if (co < COUT)
        cp_async4(ws + i, wm + j * COUT + co);
      else
        ws[i] = 0.0f;
    }
  } else {
    load_rows(ws, l.w, wm, l.w, 1, taps * a.Cout);
  }
  load_rows(xs, t.xpitch, a.x + t.xoff, a.W * a.Cin, t.imgs * t.in_rows,
            t.in_seg);
  cp_async_wait();
  __syncthreads();
  if constexpr (kFixed)
    compute_fixed<KH, KW, CIN, COUT, P, CQ>(t, ws, xs, ys);
  else
    compute_generic(a, t, ws, xs, ys);
  __syncthreads();
  const int OW = a.W - a.KW + 1;
  store_rows(a.y + t.yoff, OW * a.Cout, ys, t.ypitch, t.imgs * t.rows,
             t.out_seg);
}

// Work items of one tile of G images x R rows x C columns.
int tile_items(const Args& a) {
  return a.G * a.R * cdiv(a.C, a.P) * channel_groups(a.Cout, a.CQ);
}

// The items: kWide pixels and all channels where the launch has enough of
// them (a weight read from shared memory then serves kWide pixels and an x
// value Cout channels); else kWide pixels and 4 channels; else, on small
// launches, one pixel and 4 channels, for the most threads. The generic
// instantiation takes one pixel and 4 channels. The tiling: whole images,
// as many a block as kItemsPerBlock allows while the launch keeps
// kMinBlocksPerSm blocks an SM; with fewer images than that, bands of
// output rows of one image, each at least a warp of items; then rows (and
// columns) cut until the tile fits in shared memory.
void plan(Args& a, int k, int sms, bool fixed) {
  const int OH = a.H - a.KH + 1, OW = a.W - a.KW + 1;
  const int want = kMinBlocksPerSm * sms;
  const long long pixels = static_cast<long long>(k) * a.B * OH;  // rows
  auto large = [&] {
    return pixels * cdiv(OW, a.P) * channel_groups(a.Cout, a.CQ) >=
           static_cast<long long>(kWideItemsPerSm) * sms;
  };
  const int split = std::min(a.Cout, 4);
  a.P = kWide;
  a.CQ = a.Cout;
  if (!fixed || !large()) a.CQ = split;
  if (!fixed || !large()) a.P = 1;
  a.R = OH;
  a.C = OW;
  a.G = 1;
  const int per_image = tile_items(a);
  const long long images = static_cast<long long>(k) * a.B;
  a.G = static_cast<int>(std::max(1LL, std::min<long long>(
      {kItemsPerBlock / per_image, a.B, images / want})));
  if (a.G == 1 && images < want) {
    const int per_row = tile_items(a) / OH;
    const int bands = static_cast<int>(cdiv(want, static_cast<int>(images)));
    a.R = std::min(OH, std::max(cdiv(OH, bands), cdiv(32, per_row)));
  }
  auto bytes = [&] {
    const Layout l = layout(a, fixed);
    return 4LL * (l.w + l.x + l.y);
  };
  // weights under the wrapper's 48 KB fit beside a one-pixel tile, so this
  // ends with a tile that fits
  while (bytes() > kMaxSmemBytes && (a.G > 1 || a.R > 1 || a.C > 1)) {
    if (a.G > 1)
      a.G = cdiv(a.G, 2);
    else if (a.R > 1)
      a.R = cdiv(a.R, 2);
    else
      a.C = cdiv(a.C, 2);
  }
  a.row_tiles = cdiv(OH, a.R);
  a.col_tiles = cdiv(OW, a.C);
}

template <int KH, int KW, int CIN, int COUT, int P, int CQ>
int run(const Args& a, int k, cudaStream_t stream) {
  constexpr bool kFixed = KH > 0;
  const Layout l = layout(a, kFixed);
  const int smem = 4 * (l.w + l.x + l.y);
  auto kernel = conv2d_tile_kernel<KH, KW, CIN, COUT, P, CQ>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int threads =
      std::min(kThreads, cdiv(tile_items(a), 32) * 32);
  const dim3 grid(cdiv(a.B, a.G) * a.row_tiles * a.col_tiles, k);
  kernel<<<grid, threads, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <int KH, int KW, int CIN, int COUT>
int run_fixed(Args a, int k, int sms, cudaStream_t stream) {
  constexpr int kSplit = COUT < 4 ? COUT : 4;
  plan(a, k, sms, true);
  if (a.P == kWide && a.CQ == COUT)
    return run<KH, KW, CIN, COUT, kWide, COUT>(a, k, stream);
  if (a.P == kWide) return run<KH, KW, CIN, COUT, kWide, kSplit>(a, k, stream);
  return run<KH, KW, CIN, COUT, 1, kSplit>(a, k, stream);
}

}  // namespace

extern "C" int conv2d_valid_f32(const float* x, const float* w, float* y,
                                int k, int B, int H, int W, int Cin, int KH,
                                int KW, int Cout, void* stream) {
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  Args a{x, w, y, B, H, W, Cin, KH, KW, Cout, 1, 1, 1, 1, 1, 1, 1};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (KH == 5 && KW == 5) {
    if (Cin == 1 && Cout == 6) return run_fixed<5, 5, 1, 6>(a, k, sms, s);
    if (Cin == 6 && Cout == 12) return run_fixed<5, 5, 6, 12>(a, k, sms, s);
    if (Cin == 1 && Cout == 3) return run_fixed<5, 5, 1, 3>(a, k, sms, s);
    if (Cin == 3 && Cout == 9) return run_fixed<5, 5, 3, 9>(a, k, sms, s);
    if (Cin == 1 && Cout == 2) return run_fixed<5, 5, 1, 2>(a, k, sms, s);
    if (Cin == 2 && Cout == 4) return run_fixed<5, 5, 2, 4>(a, k, sms, s);
  }
  plan(a, k, sms, false);
  return run<0, 0, 0, 0, 1, 4>(a, k, s);
}
