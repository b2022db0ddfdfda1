// Input gradient of the valid, stride-1 NHWC convolution, member-batched,
// f32: dX[m,b,h,w,ci] = sum over (i, j, co) of
// dY[m,b,h-i,w-j,co] * W[m,i,j,ci,co], over the (h-i, w-j) inside dY.
//
// Replaces: the TPU kernel src/repro/kernels/conv2d/kernel.py:28
// `_matmul_kernel` has no backward (no Pallas backward exists; the
// reference's SGD path differentiates `lax.conv`, its CPU route). This is
// the gradient of conv2d.cu's forward with respect to its input.
//
// Shapes: dY (k, B, OH, OW, Cout), W (k, KH, KW, Cin, Cout) -> dX (k, B, H,
// W, Cin), H = OH+KH-1, W = OW+KW-1.
//
// What bounds it on an H100: at the SGD Map's stage 2 (k 4, B 200, dY 8x8x12
// -> dX 12x12x6) its f32 operations, 184 MFLOP of true products: 2.75 us.
//
// The order of the sums. Each output is one fmaf chain from 0 over the
// weights turned by 180 degrees: turned kernel rows a = KH-1-i, then turned
// columns, then Cout — the order in which conv2d.cu's forward sums dY
// padded by KH-1 rows and KW-1 columns on each side against the turned
// weights. A product of a padding zero leaves the chain's value as it was
// (fmaf(0, w, s) = s; a chain started at +0 never holds -0), so this kernel
// gives dX value for value as that route did, without the padded dY and
// the turned weights in device memory.
//
// Design. A block takes one member, a tile of GI images and a band of RB
// rows of dX. It copies the member's weights into shared memory as they lie
// (the turned order is only an index), and the dY rows the band reads into
// rows padded by KW-1 zero columns on each side: the halo exists in shared
// memory only. A warp takes one dX row at a time, its threads the images
// and the groups of P pixels of that row, so the kernel rows whose dY row
// lies outside dY are skipped for the whole warp: at stage 2 that is 1.5x
// the true products, against the padded route's 2.25x. An item is P
// pixels x all Cin channels in registers; along a turned kernel row a
// window of the P dY positions (x Cout) it reads slides through
// registers, one new position a turned column, and each weight (read as a
// broadcast: the warp's threads read the same address) serves P FMAs.
// What holds it on the H100: those weight loads (at P = 2 a broadcast per
// 2 FMAs a thread) and, at larger P, registers. The outputs of an item
// lie together in dX and leave by 16-byte stores where they align.
//
// The second stages of the configurations (5x5 kernels; dX Cin 6, 3 and 2
// from Cout 12, 9 and 4) are compile-time instantiations, with P = 2 at
// 6 <- 12 (fewer registers, more warps to hide the loads' latency: faster
// than 4 on the H100, `tools/kernel_variants.py`) and P = 4 else; every
// other shape goes through one generic instantiation (P = 1, 4 channels an
// item, shapes from the arguments). Tiles, bands and items follow from the
// shape alone, and every output is one thread's chain, so a member's dX
// does not depend on k, B or the tiling.
#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>

namespace {

constexpr int kLanes = 32;
constexpr int kMaxWarps = 8;
constexpr int kMaxSmemBytes = 160 * 1024;
constexpr int kBandRows = 6;        // dX rows a block of a compile-time shape

__host__ __device__ constexpr int cdiv(int a, int b) { return (a + b - 1) / b; }
__host__ __device__ constexpr int round4(int a) { return (a + 3) & ~3; }
__host__ __device__ constexpr int pitch48(int n) {
  return round4(n) % 8 == 4 ? round4(n) : round4(n) + 4;
}

struct Args {
  const float* dy;
  const float* w;
  float* dx;
  int B, H, W, Cin, KH, KW, Cout;    // H, W, Cin: dX's
  int P, CQ;                         // pixels and channels an item
  int GI, RB;                        // images and dX rows a tile
  int groups, cgroups;               // pixel groups of a row; channel groups
  int wr;                            // warps a row: GI * groups * cgroups
                                     // items in rows of 32
  int YR, YP, IP;                    // dY rows a band, their pitch, the
                                     // pitch of an image's rows
  int bands;
};

// The padded dY row: KW-1 zero columns, OW columns of dY, then zeros to
// the last column a group of P pixels reads.
__host__ __device__ inline int padded_cols(const Args& a) {
  return a.groups * a.P + a.KW - 1;
}
__host__ __device__ inline int weight_floats(const Args& a) {
  return round4(a.KH * a.KW * a.Cin * a.Cout);
}
__host__ __device__ inline int smem_floats(const Args& a) {
  return weight_floats(a) + a.GI * a.IP;
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
__device__ inline void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// The generic item's sums: one pixel, channels c0.. c0+3, guarded.
__device__ inline void item_generic(const Args& a, const float* ws,
                                    const float* ys, int h, int ylo, int w0,
                                    int c0, float* out) {
  const int OH = a.H - a.KH + 1;
  const int a_lo = max(0, a.KH - 1 - h);
  const int a_hi = min(a.KH - 1, OH + a.KH - 2 - h);
  float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  for (int t = a_lo; t <= a_hi; ++t) {
    const float* yr = ys + (h + t - (a.KH - 1) - ylo) * a.YP + w0 * a.Cout;
    for (int b = 0; b < a.KW; ++b)
      for (int co = 0; co < a.Cout; ++co) {
        const float yv = yr[b * a.Cout + co];
        // W[KH-1-t, KW-1-b, c0 + q, co]
        const float* wr = ws + (((a.KH - 1 - t) * a.KW + a.KW - 1 - b) *
                                a.Cin + c0) * a.Cout + co;
#pragma unroll
        for (int q = 0; q < 4; ++q)
          acc[q] = fmaf(yv, c0 + q < a.Cin ? wr[q * a.Cout] : 0.0f, acc[q]);
      }
  }
#pragma unroll
  for (int q = 0; q < 4; ++q)
    if (c0 + q < a.Cin) out[q] = acc[q];
}

// A compile-time item: P pixels of row h from w0, all CIN channels.
template <int KH, int KW, int CIN, int COUT, int P>
__device__ inline void item_fixed(const Args& a, const float* ws,
                                  const float* ys, int h, int ylo, int w0,
                                  float* out) {
  constexpr int VY = COUT % 4 == 0 ? 4 : COUT % 2 == 0 ? 2 : 1;
  const int OH = a.H - KH + 1;
  const int a_lo = max(0, KH - 1 - h), a_hi = min(KH - 1, OH + KH - 2 - h);
  float acc[P][CIN];
#pragma unroll
  for (int p = 0; p < P; ++p)
#pragma unroll
    for (int c = 0; c < CIN; ++c) acc[p][c] = 0.0f;
#pragma unroll 1
  for (int t = a_lo; t <= a_hi; ++t) {
    // the row of dY that the turned kernel row t reads, from the padded
    // position w0 (the dY column w0-KW+1)
    const float* yr = ys + (h + t - (KH - 1) - ylo) * a.YP + w0 * COUT;
    auto load_pos = [&](float (&v)[COUT], int pos) {
      const float* y = yr + pos * COUT;
#pragma unroll
      for (int j = 0; j < COUT; j += VY) {
        if constexpr (VY == 4) {
          const float4 u = *reinterpret_cast<const float4*>(y + j);
          v[j] = u.x; v[j + 1] = u.y; v[j + 2] = u.z; v[j + 3] = u.w;
        } else if constexpr (VY == 2) {
          const float2 u = *reinterpret_cast<const float2*>(y + j);
          v[j] = u.x; v[j + 1] = u.y;
        } else {
          v[j] = y[j];
        }
      }
    };
    // a window of P positions slides along the turned columns b: it holds
    // the positions b .. b+P-1, one new position a column
    float win[P][COUT];
#pragma unroll
    for (int p = 0; p + 1 < P; ++p) load_pos(win[p + 1], p);
    // the kernel row KH-1-t of the weights, read from its last column
    const float* wk = ws + (KH - 1 - t) * KW * CIN * COUT;
#pragma unroll
    for (int b = 0; b < KW; ++b) {
#pragma unroll
      for (int p = 0; p + 1 < P; ++p)
#pragma unroll
        for (int co = 0; co < COUT; ++co) win[p][co] = win[p + 1][co];
      load_pos(win[P - 1], b + P - 1);
#pragma unroll
      for (int co = 0; co < COUT; ++co) {
        float wv[CIN];
#pragma unroll
        for (int c = 0; c < CIN; ++c)
          wv[c] = wk[((KW - 1 - b) * CIN + c) * COUT + co];
#pragma unroll
        for (int p = 0; p < P; ++p)
#pragma unroll
          for (int c = 0; c < CIN; ++c)
            acc[p][c] = fmaf(win[p][co], wv[c], acc[p][c]);
      }
    }
  }
  // P pixels x CIN channels lie together in dX
  const int n = min(P, a.W - w0);
  if constexpr ((P * CIN) % 4 == 0) {
    if (n == P && aligned16(out)) {
#pragma unroll
      for (int j = 0; j < P * CIN; j += 4)
        *reinterpret_cast<float4*>(out + j) = make_float4(
            acc[j / CIN][j % CIN], acc[(j + 1) / CIN][(j + 1) % CIN],
            acc[(j + 2) / CIN][(j + 2) % CIN],
            acc[(j + 3) / CIN][(j + 3) % CIN]);
      return;
    }
  }
#pragma unroll
  for (int p = 0; p < P; ++p)
    if (p < n)
#pragma unroll
      for (int c = 0; c < CIN; ++c) out[p * CIN + c] = acc[p][c];
}

// KH == 0 is the generic instantiation.
template <int KH, int KW, int CIN, int COUT, int P>
__global__ void __launch_bounds__(kMaxWarps * kLanes)
    conv2d_dgrad_kernel(const Args a) {
  constexpr bool kFixed = KH > 0;
  extern __shared__ float4 smem4[];
  float* ws = reinterpret_cast<float*>(smem4);
  float* ys = ws + weight_floats(a);
  const int m = blockIdx.y;
  const int tile = blockIdx.x / a.bands, band = blockIdx.x % a.bands;
  const int b0 = tile * a.GI, imgs = min(a.GI, a.B - b0);
  const int h0 = band * a.RB, h1 = min(a.H, h0 + a.RB);
  const int OH = a.H - a.KH + 1, OW = a.W - a.KW + 1;
  const int ylo = max(0, h0 - (a.KH - 1)), yhi = min(OH, h1);

  const int warp = threadIdx.x / kLanes, lane = threadIdx.x % kLanes;
  const int nwarps = blockDim.x / kLanes;

  // the member's weights as they lie; the dY region zeroed, then the
  // band's dY rows copied in at column KW-1 of their padded rows, a team
  // of 32 threads a row
  const int nw = a.KH * a.KW * a.Cin * a.Cout;
  const float* wm = a.w + static_cast<long long>(m) * nw;
  if (nw % 4 == 0 && aligned16(wm)) {
    for (int e = 4 * threadIdx.x; e < nw; e += 4 * blockDim.x)
      cp_async16(ws + e, wm + e);
  } else {
    for (int e = threadIdx.x; e < nw; e += blockDim.x)
      cp_async4(ws + e, wm + e);
  }
  float4* z = reinterpret_cast<float4*>(ys);
  for (int e = threadIdx.x; e < a.GI * a.IP / 4; e += blockDim.x)
    z[e] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  __syncthreads();
  const int seg = OW * a.Cout, lead = (a.KW - 1) * a.Cout;
  const int rows = yhi - ylo;
  const float* ym = a.dy + ((static_cast<long long>(m) * a.B + b0) * OH + ylo)
                    * seg;
  const bool vec = seg % 4 == 0 && lead % 4 == 0 && a.YP % 4 == 0 &&
                   a.IP % 4 == 0 && aligned16(ym) && (OH * seg) % 4 == 0;
  for (int gr = warp; gr < imgs * rows; gr += nwarps) {
    const int g = gr / rows, r = gr - g * rows;
    float* dst = ys + g * a.IP + r * a.YP + lead;
    const float* src = ym + (static_cast<long long>(g) * OH + r) * seg;
    if (vec) {
      for (int c = 4 * lane; c < seg; c += 4 * kLanes)
        cp_async16(dst + c, src + c);
    } else {
      for (int c = lane; c < seg; c += kLanes) cp_async4(dst + c, src + c);
    }
  }
  cp_async_wait_all();
  __syncthreads();

  // a warp per (dX row, run of 32 items), its lanes over (image, pixel
  // group, channel group) with the image slowest
  const int per_img = a.groups * a.cgroups;
  for (int task = warp; task < (h1 - h0) * a.wr; task += nwarps) {
    const int h = h0 + task / a.wr;
    const int slot = (task % a.wr) * kLanes + lane;
    const int g = slot / per_img;
    if (g >= imgs) continue;
    const int pg = (slot % per_img) / a.cgroups, cg = slot % a.cgroups;
    const int w0 = pg * a.P;
    float* out = a.dx + (((static_cast<long long>(m) * a.B + b0 + g) * a.H +
                          h) * a.W + w0) * a.Cin + cg * a.CQ;
    if constexpr (kFixed)
      item_fixed<KH, KW, CIN, COUT, P>(a, ws, ys + g * a.IP, h, ylo, w0, out);
    else
      item_generic(a, ws, ys + g * a.IP, h, ylo, w0, cg * a.CQ, out);
  }
}

// The tiling: a block takes GI images, as many as one warp's 32 items
// cover along a row (at least one), and a band of RB dX rows with a warp
// each (compile-time shapes) or up to 8 warps over all rows (generic), bands
// halved until the tile fits in shared memory.
void plan(Args& a, bool fixed, int P) {
  const int OH = a.H - a.KH + 1;
  a.P = P;
  a.CQ = fixed ? a.Cin : 4;
  a.groups = cdiv(a.W, P);
  a.cgroups = cdiv(a.Cin, a.CQ);
  const int per_img = a.groups * a.cgroups;
  a.GI = std::max(1, std::min(a.B, kLanes / per_img));
  a.wr = cdiv(a.GI * per_img, kLanes);
  a.RB = fixed ? std::min(a.H, kBandRows) : a.H;
  a.YP = round4(padded_cols(a) * a.Cout);
  auto fit = [&] {    // the most dY rows a band reads
    a.YR = 0;
    for (int h0 = 0; h0 < a.H; h0 += a.RB)
      a.YR = std::max(a.YR, std::min(OH, h0 + a.RB) -
                                std::max(0, h0 - (a.KH - 1)));
    a.IP = pitch48(a.YR * a.YP);
  };
  fit();
  while (4 * smem_floats(a) > kMaxSmemBytes && (a.GI > 1 || a.RB > 1)) {
    if (a.GI > 1)
      a.GI = cdiv(a.GI, 2);
    else
      a.RB = cdiv(a.RB, 2);
    a.wr = cdiv(a.GI * per_img, kLanes);
    fit();
  }
  a.bands = cdiv(a.H, a.RB);
}

template <int KH, int KW, int CIN, int COUT, int P>
int run(Args a, int k, cudaStream_t stream) {
  plan(a, KH > 0, P);
  const int smem = 4 * smem_floats(a);
  if (smem > kMaxSmemBytes) return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = conv2d_dgrad_kernel<KH, KW, CIN, COUT, P>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int warps = std::min(a.RB * a.wr, kMaxWarps);
  const dim3 grid(cdiv(a.B, a.GI) * a.bands, k);
  kernel<<<grid, warps * kLanes, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dX on `stream`; returns cudaGetLastError(), or cudaErrorInvalidValue when
// one dX row's band does not fit in shared memory beside the weights.
extern "C" int conv2d_dgrad_f32(const float* dy, const float* w, float* dx,
                                int k, int B, int H, int W, int Cin, int KH,
                                int KW, int Cout, void* stream) {
  Args a{};
  a.dy = dy;
  a.w = w;
  a.dx = dx;
  a.B = B; a.H = H; a.W = W; a.Cin = Cin; a.KH = KH; a.KW = KW; a.Cout = Cout;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (KH == 5 && KW == 5) {
    if (Cin == 6 && Cout == 12) return run<5, 5, 6, 12, 2>(a, k, s);
    if (Cin == 3 && Cout == 9) return run<5, 5, 3, 9, 4>(a, k, s);
    if (Cin == 2 && Cout == 4) return run<5, 5, 2, 4, 4>(a, k, s);
  }
  return run<0, 0, 0, 0, 1>(a, k, s);
}
