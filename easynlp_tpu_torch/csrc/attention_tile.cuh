// Device helpers shared by the port's attention kernels
// (short_attention_fwd.cu, short_attention_bwd.cu, flash_attention_fwd.cu):
// element conversion to and from f32, and the 16-byte row loads that bring
// a tile of q/k/v/o/dO rows into shared memory as f32.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;  // easynlp_tpu/ops/attention.py NEG_INF

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* dst, float x) { *dst = x; }
__device__ __forceinline__ void store(__nv_bfloat16* dst, float x) {
  *dst = __float2bfloat16(x);
}

// Copies `rows` rows of D contiguous elements (row stride `stride` elements)
// into shared memory as f32 with leading dimension `ld`, the block's
// kThreads threads sharing the work. Rows at or past `valid` are written as
// zeros. Each thread moves 16 bytes at a time: the wrapper guarantees
// 16-byte aligned rows and D a multiple of 8.
template <int kThreads, typename T>
__device__ __forceinline__ void load_rows(float* dst, int ld, const T* src,
                                          int64_t stride, int rows, int valid,
                                          int D) {
  constexpr int kVec = 16 / sizeof(T);
  const int per_row = D / kVec;
  for (int i = threadIdx.x; i < rows * per_row; i += kThreads) {
    const int r = i / per_row;
    const int c = (i - r * per_row) * kVec;
    float* out = dst + r * ld + c;
    if (r < valid) {
      const uint4 raw = __ldg(reinterpret_cast<const uint4*>(src + r * stride + c));
      const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
      for (int j = 0; j < kVec; ++j) out[j] = to_float(e[j]);
    } else {
#pragma unroll
      for (int j = 0; j < kVec; ++j) out[j] = 0.f;
    }
  }
}

}  // namespace
