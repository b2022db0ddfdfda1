// Valid, stride-1 NHWC convolution with HWIO weights, member-batched, f32.
//
// Replaces: src/repro/kernels/conv2d/kernel.py:28 `_matmul_kernel`, launched
// by `_blocked_matmul` (:44, pallas_call at :53) on the patch matrix that
// conv2d/ops.py:24 `_conv2d_valid` builds with `ref.im2col`. It computes the
// same function without putting the patch matrix in device memory: a direct
// (implicit-GEMM) convolution that reads each patch straight from x.
//
// Shapes: x (k, B, H, W, Cin), w (k, kh, kw, Cin, Cout) -> y (k, B, OH, OW,
// Cout) with OH = H-kh+1, OW = W-kw+1. Grid axis y runs over the k members;
// the sequential Map path passes k = 1.
//
// What bounds it on an H100: at the CNN-ELM's shapes (Cout of 6 or 12, a
// patch of 25 or 150 values) a conv is 2-3 FLOP per byte it must move, far
// below the card's f32 balance of 67 TFLOP/s over 3.35 TB/s (about 20), so
// it is bound by the bytes of y and x. At batch 200 and k = 4 a launch is a
// few microseconds of work, so launch latency is of the same order.
//
// Design: one thread per output element, f32 accumulator, the patch summed
// in (kh, kw, Cin) order - the im2col column order of the reference. The
// member's weights (at most a few KB) are staged in shared memory once per
// block; neighbouring threads take neighbouring output channels and columns,
// so their x reads hit the same or adjacent cache lines and y is written
// coalesced. No atomics: every output is written once by one thread, so the
// result is deterministic. Bias, ReLU and the mean-pool stay outside (fusing
// them into the epilogue is a later optimisation).
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void conv2d_valid_kernel(const float* __restrict__ x,
                                    const float* __restrict__ w,
                                    float* __restrict__ y,
                                    int B, int H, int W, int Cin,
                                    int KH, int KW, int Cout) {
  extern __shared__ float ws[];
  const int m = blockIdx.y;
  const int wsize = KH * KW * Cin * Cout;
  const float* wm = w + static_cast<long long>(m) * wsize;
  for (int i = threadIdx.x; i < wsize; i += blockDim.x) ws[i] = wm[i];
  __syncthreads();

  // 32-bit index arithmetic (the wrapper keeps one member's x and y under
  // 2^31 elements): 64-bit division costs tens of instructions per thread
  const int OH = H - KH + 1;
  const int OW = W - KW + 1;
  const int per_member = B * OH * OW * Cout;
  const int o = blockIdx.x * blockDim.x + threadIdx.x;
  if (o >= per_member) return;

  const int co = o % Cout;
  int r = o / Cout;
  const int ow = r % OW;
  r /= OW;
  const int oh = r % OH;
  const int b = r / OH;

  const float* xb = x + static_cast<long long>(m) * B * H * W * Cin +
                    static_cast<long long>(b) * H * W * Cin;
  float acc = 0.0f;
  for (int i = 0; i < KH; ++i) {
    for (int j = 0; j < KW; ++j) {
      const float* xp = xb + ((oh + i) * W + (ow + j)) * Cin;
      const float* wp = ws + (i * KW + j) * Cin * Cout + co;
      for (int c = 0; c < Cin; ++c) acc = fmaf(xp[c], wp[c * Cout], acc);
    }
  }
  y[static_cast<long long>(m) * per_member + o] = acc;
}

}  // namespace

extern "C" int conv2d_valid_f32(const float* x, const float* w, float* y,
                                int k, int B, int H, int W, int Cin, int KH,
                                int KW, int Cout, void* stream) {
  const int per_member = B * (H - KH + 1) * (W - KW + 1) * Cout;
  const int blocks = (per_member + kThreads - 1) / kThreads;
  const size_t smem = sizeof(float) * KH * KW * Cin * Cout;
  dim3 grid(blocks, k);
  conv2d_valid_kernel<<<grid, kThreads, smem,
                        static_cast<cudaStream_t>(stream)>>>(
      x, w, y, B, H, W, Cin, KH, KW, Cout);
  return static_cast<int>(cudaGetLastError());
}
