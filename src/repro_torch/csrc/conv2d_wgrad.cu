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
// What bounds it on an H100: few outputs, each a long sum. At the Map's
// shapes (k 4, B 200) stage 1 has 150 outputs a member of 115,200 terms
// each and is bound by its bytes (x 2.5 MB + dY 11.1 MB: 4.05 us); stage 2
// has 1,800 outputs of 12,800 terms and is bound by its f32 operations
// (184 MFLOP: 2.75 us).
//
// Design, simple before fast. Pass 1: a block takes one member, one chunk
// of G images and a tile of at most 256 items; an item is one tap (i, j,
// ci) and a group of 4 output channels. For each image of the chunk, and
// each band of R output rows of it, the block copies the band's x rows and
// dY rows into shared memory; S threads share an item, thread s summing
// the band's pixels s, s+S, s+2S, ... in registers. At the end the block
// adds its S sums in the order s = 0, 1, ... and writes one partial an
// output for its chunk. Pass 2 sums each output's partials in chunk order.
// G, R, S and the tiles follow from the shape alone, never from k or the
// card, and there are no float atomics: dW is the same bits from run to
// run and whatever the number of members beside it (the sequential and the
// stacked SGD Maps see the same gradient).
#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>

namespace {

constexpr int kThreads = 256;            // most threads a block runs
constexpr int kCQ = 4;                   // output channels an item
constexpr int kSmemFloats = 12 * 1024;   // 48 KB: no opt-in needed
constexpr int kRedFloats = kThreads * kCQ;

__host__ __device__ constexpr int cdiv(int a, int b) { return (a + b - 1) / b; }
__host__ __device__ constexpr int round4(int a) { return (a + 3) & ~3; }

struct Args {
  const float* x;
  const float* dy;
  float* part;             // (k, chunks, outs) partial sums
  int B, H, W, Cin, KH, KW, Cout;
  int G, chunks;           // images a chunk; chunks a member
  int R;                   // output rows a band
  int IT, S;               // items a block (a tile); threads an item
  int items;               // taps * channel groups
};

// Floats of shared memory a band of r output rows takes: its x rows, its
// dY rows, and the block's sums for the final reduction.
__host__ __device__ inline int band_floats(const Args& a, int r) {
  const int OW = a.W - a.KW + 1;
  return round4((r + a.KH - 1) * a.W * a.Cin) + round4(r * OW * a.Cout) +
         kRedFloats;
}

__device__ inline void copy_in(float* s, const float* g, int n) {
  if ((reinterpret_cast<uintptr_t>(g) & 15) == 0) {
    const float4* g4 = reinterpret_cast<const float4*>(g);
    float4* s4 = reinterpret_cast<float4*>(s);
    for (int i = threadIdx.x; i < n / 4; i += blockDim.x) s4[i] = g4[i];
    for (int i = n / 4 * 4 + threadIdx.x; i < n; i += blockDim.x) s[i] = g[i];
  } else {
    for (int i = threadIdx.x; i < n; i += blockDim.x) s[i] = g[i];
  }
}

__global__ void __launch_bounds__(kThreads)
    wgrad_partial_kernel(const Args a) {
  extern __shared__ float4 smem4[];
  float* xs = reinterpret_cast<float*>(smem4);
  const int OH = a.H - a.KH + 1, OW = a.W - a.KW + 1;
  float* ds = xs + round4((a.R + a.KH - 1) * a.W * a.Cin);
  float* red = ds + round4(a.R * OW * a.Cout);
  const int chunk = blockIdx.x, m = blockIdx.y;
  const int groups = cdiv(a.Cout, kCQ);

  // this thread's item and split; the channel group varies fastest, so
  // the threads of a warp read one x value and neighbouring dY values
  const int u = threadIdx.x;
  const int local = u % a.IT, s = u / a.IT;
  const int item = blockIdx.z * a.IT + local;
  const bool active = s < a.S && item < a.items;
  const int g = item % groups, tap = item / groups;
  const int ci = tap % a.Cin, jj = (tap / a.Cin) % a.KW,
            ii = tap / (a.Cin * a.KW);
  const int co0 = g * kCQ;
  const bool vec = a.Cout % 4 == 0;

  float acc[kCQ] = {0.0f, 0.0f, 0.0f, 0.0f};
  const int b0 = chunk * a.G, b1 = min(a.B, b0 + a.G);
  for (int b = b0; b < b1; ++b) {
    const long long img = static_cast<long long>(m) * a.B + b;
    for (int r0 = 0; r0 < OH; r0 += a.R) {
      const int rows = min(a.R, OH - r0);
      __syncthreads();    // the last band's reads are done
      copy_in(xs, a.x + (img * a.H + r0) * a.W * a.Cin,
              (rows + a.KH - 1) * a.W * a.Cin);
      copy_in(ds, a.dy + (img * OH + r0) * OW * a.Cout, rows * OW * a.Cout);
      __syncthreads();
      if (!active) continue;
      const int npx = rows * OW;
      int oh = s / OW, ow = s - (s / OW) * OW;
      for (int p = s; p < npx; p += a.S) {
        const float xv = xs[((oh + ii) * a.W + ow + jj) * a.Cin + ci];
        const float* d = ds + p * a.Cout + co0;
        if (vec) {
          const float4 dv = *reinterpret_cast<const float4*>(d);
          acc[0] = fmaf(xv, dv.x, acc[0]);
          acc[1] = fmaf(xv, dv.y, acc[1]);
          acc[2] = fmaf(xv, dv.z, acc[2]);
          acc[3] = fmaf(xv, dv.w, acc[3]);
        } else {
#pragma unroll
          for (int q = 0; q < kCQ; ++q)
            if (co0 + q < a.Cout) acc[q] = fmaf(xv, d[q], acc[q]);
        }
        ow += a.S;
        while (ow >= OW) {
          ow -= OW;
          ++oh;
        }
      }
    }
  }

  // the S sums of an item, added in split order
  if (active) {
#pragma unroll
    for (int q = 0; q < kCQ; ++q) red[(s * a.IT + local) * kCQ + q] = acc[q];
  }
  __syncthreads();
  if (active && s == 0) {
    const int outs = a.KH * a.KW * a.Cin * a.Cout;
    float* out = a.part + (static_cast<long long>(m) * a.chunks + chunk) * outs +
                 tap * a.Cout + co0;
#pragma unroll
    for (int q = 0; q < kCQ; ++q) {
      if (co0 + q >= a.Cout) break;
      float v = red[local * kCQ + q];
      for (int t = 1; t < a.S; ++t) v += red[(t * a.IT + local) * kCQ + q];
      out[q] = v;
    }
  }
}

// dW[m, o] = the sum of part[m, c, o] over the chunks c, in chunk order.
__global__ void wgrad_sum_kernel(const float* part, float* dw, int k, int outs,
                                 int chunks) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= k * outs) return;
  const int m = i / outs, o = i - m * outs;
  const float* p = part + static_cast<long long>(m) * chunks * outs + o;
  float acc = 0.0f;
#pragma unroll 8
  for (int c = 0; c < chunks; ++c) acc += p[static_cast<long long>(c) * outs];
  dw[i] = acc;
}

}  // namespace

// Both passes on `stream`, for chunks of G images (the caller's choice, a
// function of B alone; `part` holds k * cdiv(B, G) * KH*KW*Cin*Cout
// floats); returns cudaGetLastError(), or cudaErrorInvalidValue when one
// output row of the shape does not fit in shared memory.
extern "C" int conv2d_wgrad_f32(const float* x, const float* dy, float* part,
                                float* dw, int k, int B, int H, int W, int Cin,
                                int KH, int KW, int Cout, int G,
                                void* stream) {
  Args a{x, dy, part, B, H, W, Cin, KH, KW, Cout, G, 1, 1, 1, 1, 1};
  const int OH = H - KH + 1, OW = W - KW + 1;
  a.chunks = cdiv(B, G);
  a.items = KH * KW * Cin * cdiv(Cout, kCQ);
  a.IT = std::min(a.items, kThreads);
  a.S = std::max(1, std::min(kThreads / a.IT, OH * OW));
  a.R = OH;
  while (a.R > 1 && band_floats(a, a.R) > kSmemFloats) a.R = cdiv(a.R, 2);
  if (band_floats(a, a.R) > kSmemFloats)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int threads = std::min(kThreads, cdiv(a.IT * a.S, 32) * 32);
  const dim3 grid(a.chunks, k, cdiv(a.items, a.IT));
  const int smem = 4 * band_floats(a, a.R);
  wgrad_partial_kernel<<<grid, threads, smem, s>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int outs = KH * KW * Cin * Cout;
  wgrad_sum_kernel<<<cdiv(k * outs, 256), 256, 0, s>>>(part, dw, k, outs,
                                                        a.chunks);
  return static_cast<int>(cudaGetLastError());
}
