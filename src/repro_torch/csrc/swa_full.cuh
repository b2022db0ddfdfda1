// Building blocks of the attention kernels written for the H100's tensor
// cores and copy engine (swa_full_fwd.cu, swa_full_bwd.cu), which serve
// both modes: non-causal (the encoder's) and the causal
// sliding window (the decoders', every bf16 call): warpgroup products (wgmma), tiles copied by the Tensor
// Memory Accelerator (TMA) into a ring of shared-memory stages, mbarriers
// between the loading threads and the two warpgroups whose products read
// the stages.
//
// Tiles in shared memory. A tile of R rows (R a multiple of 64) of a bf16
// operand with hd columns, zero-padded to HDP (a multiple of 16), is kept
// as HDP / 16 pieces of 16 columns: piece i holds columns 16 i .. 16 i + 15
// of every row, rows of 32 bytes, 32-byte swizzled, at byte R * 32 * i of
// the tile. A row of 80 bf16 values (HuBERT's head dim) is 160 bytes,
// which is no swizzle width; 16-column pieces fit any hd up to 128. Each
// piece is what one TMA box of 16 columns x 64 rows writes with the
// 32-byte swizzle, and what a wgmma descriptor of that swizzle reads:
// - K-major (the operand's rows are the product's M or N, its columns K):
//   a 16-column k-step is one piece, 8-row groups SBO = 256 bytes apart;
// - MN-major (rows are K, columns N, the descriptor's transpose bit): the
//   same 8-row groups, a 16-row k-step 512 bytes further, and the N =
//   HDP columns as HDP / 16 swizzle atoms LBO = R * 32 bytes apart: one
//   wgmma of N = HDP a k-step. (Pieces of 64 columns, 128-byte swizzled,
//   with a 16-column piece for hd 80 took two products a k-step, N = 64
//   and N = 16, and the N = 16 one cost nearly as much as the other:
//   PERF.md.)
// Every tile starts at a multiple of 1024 bytes, so the swizzle, which
// acts on address bits, is the same in the TMA's writes and the wgmma's
// reads. One tile layout serves both majors: q, k, v and dO are each read
// both ways by the backward.
//
// Copies. A block's two warpgroups each own 64 rows. k and v tiles (the
// forward, dQ) or q and dO tiles (dK/dV) stream through a ring of stages;
// a warpgroup releases a stage through its `empty` mbarrier when its
// products on it have completed, and a stage is refilled once both have.
// - The forward: a producer warp of its own issues the copies (288
//   threads). Its products need no more than the 168 registers a thread
//   that 9 warps leave: an SM's register file is 4 quarters, and 3 warps
//   share one.
// - The backward: dK/dV holds dk and dv, S^T and dP^T and their split
//   fragments at once, more than 168 registers. Its blocks are the two
//   warpgroups alone (256 threads, 2 warps a quarter: up to 255 registers
//   a thread), and warpgroup 0 loads: the first stages as the block
//   starts, then, at the end of its tile t, tile t - 1 + stages into the
//   stage that held tile t - 1 (the other warpgroup, a little behind, may
//   hold warpgroup 0 there a moment, and nothing it waits for waits on
//   warpgroup 0). The causal dK/dV blocks differ: each warpgroup reads
//   every other stage and refills the stage it has just read itself, so
//   no `empty` barrier is needed there. A producer warpgroup handing its registers to the
//   others by setmaxnreg (384 threads) left ptxas at 168 registers for
//   them: the dK/dV kernel spilled and ptxas serialized its wgmma; 288
//   threads at 201 registers failed to launch (PERF.md).
// Where the operands allow TMA (hd a multiple of 8, so rows are 16-byte
// strided, and 16-byte aligned pointers) one thread issues a 4-D TMA load
// a piece (columns, rows, heads, batches of the (B, S, heads, hd)
// operand; rows >= S and columns >= hd are zero-filled) and the `full`
// mbarrier counts its bytes. Otherwise the loading threads copy 2 bytes at
// a time into the same swizzled places, write the zeros themselves, and
// arrive on `full` after a proxy fence (the wgmma reads shared memory
// through the async proxy). The tensor maps are encoded on the host by
// cuTensorMapEncodeTiled, reached through cudaGetDriverEntryPoint so that
// the library links no -lcuda, and passed as __grid_constant__ kernel
// parameters.
#pragma once
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace swa_full {

typedef __nv_bfloat16 bf16;

constexpr int kRows = 64;        // rows of a wgmma M tile, of a TMA box
constexpr int kThreads = 256;    // the two warpgroups of a block
constexpr int kPiece = 16;       // columns a piece of a tile
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

// byte offset of element (r, c) in a tile of R rows: piece c / 16, its
// 32-byte row r, the row's two 16-byte halves swapped on rows 4..7 of
// every 8 (the 32-byte swizzle: address bit 4 ^= bit 7)
__device__ __forceinline__ int tile_offset(int R, int r, int c) {
  int off = r * 32 + (c % kPiece) * 2;
  off ^= ((off >> 7) & 1) << 4;
  return R * 32 * (c / kPiece) + off;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// the dynamic shared memory rounded up to 1024 bytes (the launch asks for
// 1024 more than it uses)
__device__ __forceinline__ unsigned char* align1024(unsigned char* p) {
  return p + ((1024 - (smem_addr(p) & 1023)) & 1023);
}

// a wgmma descriptor of 32-byte-swizzled pieces at shared address addr:
// 8-row groups 256 bytes apart (SBO), pieces lbo bytes apart (LBO: the
// MN-major operand's swizzle atoms along N)
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo) {
  constexpr uint64_t kSwizzle32 = 3, kSbo = 256;
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo & 0x3FFFF) >> 4) << 16) |
         ((kSbo >> 4) << 32) | (kSwizzle32 << 62);
}

// the descriptor `bytes` further on: the address field is the shared
// address >> 4 in bits 0..13 (addresses below 256 KB), so the offset adds
// to the descriptor without a carry into the next field
__device__ __forceinline__ uint64_t desc_at(uint64_t desc, uint32_t bytes) {
  return desc + (bytes >> 4);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// registers an asynchronous wgmma reads or writes: the compiler may not
// move their other uses across this point
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

// d (64 x 64, f32) = A (64 x 16) . B (16 x 64), both K-major in shared
// memory, + d where accumulate != 0
__device__ __forceinline__ void wgmma_ss64(float* d, uint64_t a, uint64_t b,
                                          int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(accumulate));
}

// d (64 x 64, f32) = A (64 x 16, bf16 fragments in registers) . B (16 x
// 64, K-major in shared memory), + d where accumulate != 0
__device__ __forceinline__ void wgmma_rs64_kmajor(float* d, const uint32_t* a,
                                                  uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate));
}

// d (64 x N, f32) += A (64 x 16, bf16 fragments in registers) . B (16 x N,
// MN-major in shared memory, the descriptor's transpose bit), N = 16 .. 128
template <int N>
__device__ __forceinline__ void wgmma_rs(float* d, const uint32_t* a,
                                         uint64_t b);

template <>
__device__ __forceinline__ void wgmma_rs<16>(float* d, const uint32_t* a,
                                              uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, {%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<32>(float* d, const uint32_t* a,
                                              uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<48>(float* d, const uint32_t* a,
                                              uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %29, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n48k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23"
      "}, {%24, %25, %26, %27}, %28, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<64>(float* d, const uint32_t* a,
                                              uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<80>(float* d, const uint32_t* a,
                                              uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %45, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n80k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39"
      "}, {%40, %41, %42, %43}, %44, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<96>(float* d, const uint32_t* a,
                                              uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %53, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47"
      "}, {%48, %49, %50, %51}, %52, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<112>(float* d, const uint32_t* a,
                                              uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %61, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n112k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55"
      "}, {%56, %57, %58, %59}, %60, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<128>(float* d, const uint32_t* a,
                                              uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}


// named barrier `id` (1..15; 0 is __syncthreads') over n threads
__device__ __forceinline__ void named_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}
__device__ __forceinline__ void named_arrive(int id, int n) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

// ---- mbarriers (addresses in shared memory)
__device__ __forceinline__ void bar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}
__device__ __forceinline__ void bar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
__device__ __forceinline__ void bar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}
__device__ __forceinline__ void bar_expect(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}
// wait for the completion of the barrier's phase of this parity; a wait
// past kWaitCycles (seconds: no tile takes that long) traps, so a barrier
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
// generic-proxy writes to shared memory made visible to the async proxy
// (the wgmma's operand reads)
__device__ __forceinline__ void proxy_fence() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// 4 bytes global -> shared address dst by cp.async; where in is false
// nothing is read and the 4 bytes are written as zeros
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          bool in) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(in ? 4 : 0)
               : "memory");
}
// an arrival on bar (one of its expected arrivals) once this thread's
// earlier cp.async copies have landed: the thread does not wait for them
__device__ __forceinline__ void cp_async_arrive(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::
                   "r"(bar)
               : "memory");
}

// one TMA box (16 columns x 64 rows of head h, batch b from column col,
// row row) -> shared address dst,
// its bytes counted on bar
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int col, int row,
                                         int h, int b) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(col), "r"(row),
      "r"(h), "r"(b)
      : "memory");
}

// rows row0 .. row0 + 63 of head h, batch b -> rows r0 .. r0 + 63 of a
// tile of R rows at shared address tile, by TMA (one box a piece)
template <int HDP>
__device__ __forceinline__ void tma_rows(uint32_t tile, int R, int r0,
                                         const CUtensorMap& map, uint32_t bar,
                                         int row0, int h, int b) {
#pragma unroll
  for (int p = 0; p < HDP / kPiece; ++p)
    tma_load(tile + R * 32 * p + r0 * 32, &map, bar, kPiece * p, row0, h, b);
}

// one TMA box (16 columns x 64 rows) from shared address src to head h,
// batch b, column col, row row of the operand: rows >= S and columns >=
// hd are not written
__device__ __forceinline__ void tma_store(const CUtensorMap* map,
                                          uint32_t src, int col, int row,
                                          int h, int b) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group"
      " [%0, {%2, %3, %4, %5}], [%1];\n" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(col), "r"(row), "r"(h), "r"(b)
      : "memory");
}

// rows r0 .. r0 + 63 of a tile of R rows at shared address tile -> rows
// row0 .. row0 + 63 of head h, batch b, by TMA (one box a piece)
template <int HDP>
__device__ __forceinline__ void tma_store_rows(uint32_t tile, int R, int r0,
                                               const CUtensorMap& map,
                                               int row0, int h, int b) {
#pragma unroll
  for (int p = 0; p < HDP / kPiece; ++p)
    tma_store(&map, tile + R * 32 * p + r0 * 32, kPiece * p, row0, h, b);
}
// until the thread's TMA stores have read their boxes out of shared memory
__device__ __forceinline__ void tma_store_wait() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

// an output pair (x0, x1) at row r, column c (even) of a tile of R rows
// in shared memory, as bf16
__device__ __forceinline__ void put_pair(unsigned char* tile, int R, int r,
                                         int c, float x0, float x1) {
  *reinterpret_cast<__nv_bfloat162*>(tile + tile_offset(R, r, c)) =
      __floats2bfloat162_rn(x0, x1);
}

// the same by n threads (t = 0 .. n - 1), 2 bytes at a time; src: the
// operand's row 0 of this head and batch, rows `stride` elements apart
template <int HDP>
__device__ __forceinline__ void copy_rows(unsigned char* tile, int R, int r0,
                                          const bf16* src, long long stride,
                                          int row0, int S, int hd, int t,
                                          int n) {
  for (int e = t; e < kRows * HDP; e += n) {
    const int r = e / HDP, c = e % HDP;
    const int gr = row0 + r;
    const bf16 val = gr < S && c < hd ? src[gr * stride + c]
                                      : __float2bfloat16(0.0f);
    *reinterpret_cast<bf16*>(tile + tile_offset(R, r0 + r, c)) = val;
  }
}

// ---- host: tensor maps
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

inline EncodeTiled encode_tiled() {
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

// the tensor map of a (B, S, NH, hd) bf16 operand at base: boxes of 16
// columns x 64 rows, 32-byte swizzled; false if the driver refuses it
inline bool make_map(CUtensorMap* map, const void* base, int B, int S,
                     int NH, int hd) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(hd),
                              static_cast<cuuint64_t>(S),
                              static_cast<cuuint64_t>(NH),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t row = 2ull * NH * hd;
  const cuuint64_t strides[3] = {row, 2ull * hd, row * S};
  const cuuint32_t ones[4] = {1, 1, 1, 1};
  const cuuint32_t box[4] = {kPiece, kRows, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                const_cast<void*>(base), dims, strides, box, ones,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_32B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

inline bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

// ---- the online softmax and the hi + lo split (as in swa_attention.cu)
// 2^x by the hardware's approximation, ex2.approx.ftz (2 ulps, as exp2f
// in the normal range; a result below 2^-126 flushes to 0): the
// backward's P. exp2f's handling of denormal results cost 22 % of the
// backward at HuBERT's shape, where the outputs came out bitwise the same
// (PERF.md); P is normalized by its row's log-sum-exp, so a weight under
// 2^-126 is below an f32 sum's resolution. The forward keeps exp2f.
__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}
__device__ __forceinline__ uint32_t as_u32(__nv_bfloat162 v) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(v.x)) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(v.y)) << 16);
}
// (x0, x1) -> the packed bf16 pairs of their high and low parts: hi is x
// truncated to bf16 (its top 16 bits, |x - hi| < 2^-7 |x|), lo the rest
// rounded to nearest, |x - hi - lo| <= 2^-8 |x - hi| < 2^-15 |x|. Measured
// faster than hi rounded to nearest by a conversion (PERF.md): one
// conversion a pair, where that took two
__device__ __forceinline__ void split_pair(float x0, float x1, uint32_t& hi,
                                           uint32_t& lo) {
  const uint32_t h0 = __float_as_uint(x0) & 0xFFFF0000u;
  const uint32_t h1 = __float_as_uint(x1) & 0xFFFF0000u;
  hi = (h0 >> 16) | h1;
  lo = as_u32(__floats2bfloat162_rn(x0 - __uint_as_float(h0),
                                    x1 - __uint_as_float(h1)));
}
// A 64 x 64 f32 accumulator (a warpgroup's; a thread holds rows g and g + 8
// of its warp's 16, columns 8 n + 2 tig and + 1 in x[4 n .. 4 n + 3]) ->
// the bf16 A-fragments, hi and lo, of its 4 k-steps of 16 columns: the
// accumulator's layout is the one a register A operand takes
__device__ __forceinline__ void split_acc(const float (&x)[32],
                                          uint32_t (&hi)[16],
                                          uint32_t (&lo)[16]) {
#pragma unroll
  for (int i = 0; i < 16; ++i) split_pair(x[2 * i], x[2 * i + 1], hi[i], lo[i]);
}

// out (a row of hd elements) <- the pair (x0, x1) at column c, c even;
// pair: the row and hd allow one 4-byte store
__device__ __forceinline__ void store_pair(bf16* out, int c, int hd, float x0,
                                           float x1, bool pair) {
  if (pair) {
    if (c < hd)
      *reinterpret_cast<__nv_bfloat162*>(out + c) =
          __floats2bfloat162_rn(x0, x1);
  } else {
    if (c < hd) out[c] = __float2bfloat16(x0);
    if (c + 1 < hd) out[c + 1] = __float2bfloat16(x1);
  }
}

// ---- f32: CUDA cores, a warp a row (the f32 card-vs-CPU parity route)

constexpr int kF32Warps = 8;    // rows a block
constexpr int kF32Tile = 32;    // keys (dQ) or queries (dK/dV) a tile
constexpr int kF32Cols = 4;     // output columns a lane: hd <= 128

// the staged tiles' row pitch: odd, so 32 lanes reading 32 rows at one
// column hit 32 banks
__host__ __device__ inline int f32_pitch(int hd) { return hd | 1; }

__device__ __forceinline__ float warp_sum(float v) {
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// rows row0 .. row0 + 31 of a (S, stride) f32 operand in registers, on
// their way to a tile in shared memory: warp w holds rows w + kF32Warps i,
// a lane columns lane + 32 u. Every load of a tile is issued before the
// first is used, and a walk loads its next tile before it computes on
// this one: one memory latency a tile, hidden under the tile before
struct F32Rows {
  float x[kF32Tile / kF32Warps][kF32Cols];
};

// rows >= S are zeros
__device__ __forceinline__ void f32_load(F32Rows& t, const float* src,
                                         long long stride, int row0, int S,
                                         int hd) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
#pragma unroll
  for (int i = 0; i < kF32Tile / kF32Warps; ++i) {
    const int gr = row0 + warp + kF32Warps * i;
#pragma unroll
    for (int u = 0; u < kF32Cols; ++u) {
      const int c = lane + 32 * u;
      t.x[i][u] = gr < S && c < hd ? src[gr * stride + c] : 0.0f;
    }
  }
}

// -> a tile of pitch f32_pitch(hd)
__device__ __forceinline__ void f32_store(float* dst, const F32Rows& t,
                                          int hd) {
  const int pitch = f32_pitch(hd);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
#pragma unroll
  for (int i = 0; i < kF32Tile / kF32Warps; ++i) {
    const int r = warp + kF32Warps * i;
#pragma unroll
    for (int u = 0; u < kF32Cols; ++u) {
      const int c = lane + 32 * u;
      if (c < hd) dst[r * pitch + c] = t.x[i][u];
    }
  }
}

// a . b over hd (a row of the warp's own, b a staged row): four fmaf
// chains over d mod 4, added in a fixed order
__device__ __forceinline__ float f32_dot(const float* a, const float* b,
                                         int hd) {
  float s0 = 0.0f, s1 = 0.0f, s2 = 0.0f, s3 = 0.0f;
  int d = 0;
  for (; d + 3 < hd; d += 4) {
    s0 = fmaf(a[d], b[d], s0);
    s1 = fmaf(a[d + 1], b[d + 1], s1);
    s2 = fmaf(a[d + 2], b[d + 2], s2);
    s3 = fmaf(a[d + 3], b[d + 3], s3);
  }
  for (; d < hd; ++d) s0 = fmaf(a[d], b[d], s0);
  return (s0 + s1) + (s2 + s3);
}

}  // namespace swa_full
