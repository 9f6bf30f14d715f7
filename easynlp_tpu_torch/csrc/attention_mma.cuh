// The tensor-core building blocks shared by the port's bf16 attention
// kernels on Hopper (sm_90a): attention_fwd_mma.cuh (the flash forward, the
// LSE pass of the short backward, and the tile walk of
// short_attention_fwd.cu), attention_bwd_mma.cuh (the flash backward's dK/dV
// and dQ passes) and short_attention_bwd.cu's one-block backward.
//
// cp.async copies global -> shared (16 bytes a thread, zero fill through the
// src-size 0 form), ldmatrix reads 8x8 bf16 matrices from shared memory into
// the fragments of mma.sync.aligned.m16n8k16 (bf16 operands, f32
// accumulators), and the helpers below name the addresses each lane gives.
// Tiles in shared memory are row-major bf16 with rows padded to width + 8
// elements, so the eight rows an ldmatrix reads fall in disjoint banks.
//
// Accumulator layout of one m16n8 tile (g = lane / 4, t = lane % 4):
// c[0], c[1] at row g, columns 2t, 2t + 1; c[2], c[3] at row g + 8, the same
// columns.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMmaThreads = 128;  // 4 warps of 16 rows
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ uint32_t smem_addr(const void* ptr) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(ptr));
}

// 16 bytes global -> shared, or 16 zero bytes when !fill.
__device__ __forceinline__ void cp_async_16(void* dst, const void* src, bool fill) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(fill ? 16 : 0)
               : "memory");
}

// 4 bytes global -> shared, or 4 zero bytes when !fill.
__device__ __forceinline__ void cp_async_4(void* dst, const void* src, bool fill) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(fill ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Waits until at most N of this thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Four 8x8 bf16 matrices from shared memory; lane i gives the address of
// row i % 8 of matrix i / 8.
__device__ __forceinline__ void ldsm_x4(uint32_t r[4], const bf16* ptr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(ptr)));
}

// The same, each matrix transposed.
__device__ __forceinline__ void ldsm_x4_t(uint32_t r[4], const bf16* ptr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(ptr)));
}

// c (16x8 f32) += a (16x16 bf16, row) * b (16x8 bf16, col).
__device__ __forceinline__ void mma_bf16(float c[4], const uint32_t a[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ void store_bf16x2(bf16* dst, float lo, float hi) {
  *reinterpret_cast<__nv_bfloat162*>(dst) = __floats2bfloat162_rn(lo, hi);
}

// Shared-memory address of this lane's row for an ldmatrix.x4 that reads
// the A fragment of a 16x16 tile at (row0, col0) of a row-major tile, or,
// with .trans, the B fragments of two n8 tiles of a tile stored k-major
// (rows = k): lanes 0-15 rows 0-15 at col0, lanes 16-31 rows 0-15 at
// col0 + 8.
__device__ __forceinline__ const bf16* frag_a(const bf16* tile, int ld, int row0,
                                              int col0, int lane) {
  return tile + (row0 + (lane & 15)) * ld + col0 + (lane >> 4) * 8;
}

// This lane's row for an ldmatrix.x4 (no .trans) that reads the B
// fragments of two n8 tiles (n0.., n0+8..) at depth k0..k0+15 of a tile
// stored n-major (rows = n, contiguous k): r[0], r[1] are b0, b1 of the
// first n8 tile, r[2], r[3] of the second. With .trans and the roles
// renamed (rows = k at k0.., columns = m at m0..), the same address reads
// the A fragment of a 16x16 tile stored k-major: frag_b(tile, ld, k0, m0).
__device__ __forceinline__ const bf16* frag_b(const bf16* tile, int ld, int n0, int k0,
                                              int lane) {
  return tile + (n0 + (lane & 7) + (lane >> 4) * 8) * ld + k0 + ((lane >> 3) & 1) * 8;
}

// Starts the copy of `rows` rows (row stride `stride` elements, D
// contiguous bf16) into a [rows][kDPad + 8] shared tile, zeros at or past
// `valid` rows and at or past D columns; `threads` threads of the block
// share it.
template <int kDPad>
__device__ __forceinline__ void load_rows_async(bf16* dst, const bf16* src, int64_t stride,
                                                int rows, int valid, int D, int threads) {
  constexpr int kChunks = kDPad / 8;
  for (int i = threadIdx.x; i < rows * kChunks; i += threads) {
    const int r = i / kChunks;
    const int c = (i % kChunks) * 8;
    const bool fill = r < valid && c < D;
    cp_async_16(dst + r * (kDPad + 8) + c, fill ? src + r * stride + c : src, fill);
  }
}

// The same for a tile of kRows rows shared by the block's kThreads threads.
template <int kRows, int kDPad, int kThreads = kMmaThreads>
__device__ __forceinline__ void load_tile_async(bf16* dst, const bf16* src, int64_t stride,
                                                int valid, int D) {
  load_rows_async<kDPad>(dst, src, stride, kRows, valid, D, kThreads);
}

// A fragments (k = the 16 columns of chunk j / 2) from the f32 m16n8
// accumulator of n8 tile j: rows g and g + 8, columns 2t and 2t + 1.
__device__ __forceinline__ void to_a_frag(uint32_t a[][4], int j, const float c[4]) {
  a[j >> 1][2 * (j & 1)] = pack_bf16(c[0], c[1]);
  a[j >> 1][2 * (j & 1) + 1] = pack_bf16(c[2], c[3]);
}

// Max and sum over the four lanes of a quad (the lanes that share rows g
// and g + 8 of an m16n8 accumulator).
__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// Sets the kernel's dynamic shared memory (above 48 KB needs the opt-in),
// then launches it on the caller's stream; the launch's cudaError_t.
template <typename Kernel, typename P>
cudaError_t launch_mma(Kernel kernel, dim3 grid, size_t smem, const P& p,
                       cudaStream_t stream, int threads = kMmaThreads) {
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  kernel<<<grid, threads, smem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace
