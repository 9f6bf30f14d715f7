// The forward kernels' shared tile walk (short_attention_fwd.cu,
// flash_attention_fwd.cu): one block owns one (batch, head, 32-query tile)
// and walks K/V in 64-key tiles through shared memory with an online softmax
// (a running max and sum per query row). Scores, probabilities and the
// accumulator stay f32; only O is rounded to the input dtype. Each thread
// keeps a 4x4 register tile of scores and a 4 x D/16 tile of the output, so
// each shared-memory read feeds four FMAs. q/k/v/o are read and written
// through (batch, seq, head) element strides, and the ragged edge is masked
// here: keys past Skv take weight exactly 0, masked or causally hidden keys
// the JAX package's finite NEG_INF (-1e30), so a query row whose keys are all
// masked averages V over the real Skv keys, as attention_reference does.
//
// A kernel calls begin(), then tile() for each key tile it visits, then
// store_out(); which tiles it visits is its own (the short kernel walks all
// of Skv <= 512, the flash kernel skips tiles past the causal diagonal).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "attention_tile.cuh"

namespace {
namespace fwd {

constexpr int kThreads = 128;      // 4 warps
constexpr int kBlockQ = 32;        // query rows per block
constexpr int kBlockK = 64;        // keys per shared-memory tile
// Score-tile row stride: the two row groups of a warp sit 4 rows apart, and
// 4 * 68 = 272 = 16 (mod 32 banks), so their writes land in disjoint banks.
constexpr int kLdP = kBlockK + 4;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const int32_t* mask;
  void* o;
  float* lse;  // [B,H,Sq], contiguous (the flash kernel's; unused by short)
  int B, H, Sq, Skv, D;
  int64_t q_sb, q_ss, q_sh;
  int64_t k_sb, k_ss, k_sh;
  int64_t v_sb, v_ss, v_sh;
  int64_t o_sb, o_ss, o_sh;
  int64_t m_sb;
  int causal;
  int q_offset;
  float scale;
};

// The launchers' common argument check and Params: dtype 0 = float32,
// 1 = bfloat16; strides in elements with a contiguous D; m_sb the mask's
// batch stride (0 broadcasts one row). False for what the kernels do not
// take.
inline bool make_params(Params* p, const void* q, const void* k,
                        const void* v, const int32_t* mask, void* o,
                        float* lse, int B, int H, int Sq, int Skv, int D,
                        const int64_t* strides, int64_t m_sb, int causal,
                        float scale) {
  if (B < 1 || H < 1 || Sq < 1 || Skv < 1 || D < 8 || D > kMaxHeadDim ||
      D % 8 != 0 || B > 65535 || H > 65535) {
    return false;
  }
  *p = Params{q, k, v, mask, o, lse, B, H, Sq, Skv, D,
              strides[0], strides[1], strides[2],
              strides[3], strides[4], strides[5],
              strides[6], strides[7], strides[8],
              strides[9], strides[10], strides[11],
              m_sb, causal, causal ? Skv - Sq : 0, scale};
  return true;
}

template <int kDPad>
constexpr size_t smem_bytes() {
  return sizeof(float) * (kBlockQ * (kDPad + 1) + kBlockK * (kDPad + 1) +
                          kBlockK * kDPad + kBlockQ * kLdP + 3 * kBlockQ);
}

// kDPad is D rounded up to 32, 64 or 128: it sizes the shared tiles and the
// per-thread output tile. Columns at or past D are computed from whatever the
// V tile holds there and never stored.
template <int kDPad>
struct Tiles {
  static constexpr int kLdQK = kDPad + 1;  // odd: column walks are conflict-free
  static constexpr int kOutCols = kDPad / 16;
  float* qs;         // [kBlockQ][kLdQK]
  float* ks;         // [kBlockK][kLdQK]
  float* vs;         // [kBlockK][kDPad]
  float* ps;         // [kBlockQ][kLdP]
  float* row_max;    // running max per query row
  float* row_sum;    // running sum of exp per row
  float* row_scale;  // exp(old max - new max) per row

  __device__ __forceinline__ explicit Tiles(float* smem)
      : qs(smem),
        ks(qs + kBlockQ * kLdQK),
        vs(ks + kBlockK * kLdQK),
        ps(vs + kBlockK * kDPad),
        row_max(ps + kBlockQ * kLdP),
        row_sum(row_max + kBlockQ),
        row_scale(row_sum + kBlockQ) {}
};

// This block's first query row and its row count (< kBlockQ in the last
// query tile).
__device__ __forceinline__ int first_row() { return blockIdx.x * kBlockQ; }
__device__ __forceinline__ int rows(const Params& p) {
  return min(kBlockQ, p.Sq - first_row());
}

// Loads the block's Q tile, starts each row's max at -inf and sum at 0, and
// zeroes the thread's accumulator.
template <typename T, int kDPad>
__device__ __forceinline__ void begin(const Params& p, const Tiles<kDPad>& t,
                                      float (&acc)[4][kDPad / 16]) {
  const T* q = static_cast<const T*>(p.q) + blockIdx.z * p.q_sb +
               blockIdx.y * p.q_sh + first_row() * p.q_ss;
  load_rows<kThreads>(t.qs, Tiles<kDPad>::kLdQK, q, p.q_ss, kBlockQ, rows(p),
                      p.D);
  if (threadIdx.x < kBlockQ) {
    t.row_max[threadIdx.x] = -INFINITY;
    t.row_sum[threadIdx.x] = 0.f;
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < kDPad / 16; ++c) acc[i][c] = 0.f;
}

// One key tile [k0, k0 + 64): S = Q K^T * scale, masked; the online softmax
// update of each row's max and sum; acc = acc * exp(old max - new max) + P V.
// The thread's tiles: query rows r0..r0+3; keys (and output columns)
// c0 + 16*j.
template <typename T, int kDPad>
__device__ __forceinline__ void tile(const Params& p, const Tiles<kDPad>& t,
                                     int k0, float (&acc)[4][kDPad / 16]) {
  constexpr int kLdQK = Tiles<kDPad>::kLdQK;
  constexpr int kOutCols = Tiles<kDPad>::kOutCols;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int c0 = tid % 16;
  const int r0 = (tid / 16) * 4;
  const int q0 = first_row();
  const int D = p.D;
  const T* k = static_cast<const T*>(p.k) + blockIdx.z * p.k_sb +
               blockIdx.y * p.k_sh + k0 * p.k_ss;
  const T* v = static_cast<const T*>(p.v) + blockIdx.z * p.v_sb +
               blockIdx.y * p.v_sh + k0 * p.v_ss;
  const int32_t* mask = p.mask + blockIdx.z * p.m_sb;
  const int kv_valid = min(kBlockK, p.Skv - k0);

  __syncthreads();  // the previous tile's readers are done
  load_rows<kThreads>(t.ks, kLdQK, k, p.k_ss, kBlockK, kv_valid, D);
  load_rows<kThreads>(t.vs, kDPad, v, p.v_ss, kBlockK, kv_valid, D);
  __syncthreads();

  float s[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
  for (int d = 0; d < D; ++d) {
    float qv[4], kv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) qv[i] = t.qs[(r0 + i) * kLdQK + d];
#pragma unroll
    for (int j = 0; j < 4; ++j) kv[j] = t.ks[(c0 + 16 * j) * kLdQK + d];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int key = k0 + c0 + 16 * j;
    const bool in_range = key < p.Skv;
    const bool kept = in_range && mask[key] != 0;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float x;
      if (!in_range) {
        x = -INFINITY;  // past the sequence: not a key, weight exactly 0
      } else if (!kept || (p.causal && key > q0 + r0 + i + p.q_offset)) {
        x = kNegInf;
      } else {
        x = s[i][j] * p.scale;
      }
      t.ps[(r0 + i) * kLdP + c0 + 16 * j] = x;
    }
  }
  __syncthreads();

  // Online softmax: warp w owns rows 8w..8w+7, each lane two keys of a row.
  for (int r = warp * 8; r < warp * 8 + 8; ++r) {
    float* row = t.ps + r * kLdP;
    const float x0 = row[lane];
    const float x1 = row[lane + 32];
    float mx = fmaxf(x0, x1);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
    const float m_old = t.row_max[r];
    // Key k0 is in range and scores at least NEG_INF, so m_new is finite.
    const float m_new = fmaxf(m_old, mx);
    const float e0 = expf(x0 - m_new);
    const float e1 = expf(x1 - m_new);
    float sum = e0 + e1;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      sum += __shfl_xor_sync(0xffffffffu, sum, o);
    row[lane] = e0;
    row[lane + 32] = e1;
    if (lane == 0) {
      const float alpha = expf(m_old - m_new);
      t.row_scale[r] = alpha;
      t.row_sum[r] = t.row_sum[r] * alpha + sum;
      t.row_max[r] = m_new;
    }
  }
  __syncthreads();

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float alpha = t.row_scale[r0 + i];
#pragma unroll
    for (int c = 0; c < kOutCols; ++c) acc[i][c] *= alpha;
  }
  for (int kk = 0; kk < kv_valid; ++kk) {
    float pv[4], vv[kOutCols];
#pragma unroll
    for (int i = 0; i < 4; ++i) pv[i] = t.ps[(r0 + i) * kLdP + kk];
#pragma unroll
    for (int c = 0; c < kOutCols; ++c) vv[c] = t.vs[kk * kDPad + c0 + 16 * c];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < kOutCols; ++c) acc[i][c] = fmaf(pv[i], vv[c], acc[i][c]);
  }
}

// O = acc / row sum, in T. Each stored row visited at least one tile, so its
// sum is >= 1 (its max adds exp(0)).
template <typename T, int kDPad>
__device__ __forceinline__ void store_out(const Params& p,
                                          const Tiles<kDPad>& t,
                                          const float (&acc)[4][kDPad / 16]) {
  const int c0 = threadIdx.x % 16;
  const int r0 = (threadIdx.x / 16) * 4;
  T* o = static_cast<T*>(p.o) + blockIdx.z * p.o_sb + blockIdx.y * p.o_sh;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = first_row() + r0 + i;
    if (row >= p.Sq) continue;
    const float inv = 1.f / t.row_sum[r0 + i];
    T* orow = o + row * p.o_ss;
#pragma unroll
    for (int c = 0; c < kDPad / 16; ++c) {
      const int d = c0 + 16 * c;
      if (d < p.D) store(orow + d, acc[i][c] * inv);
    }
  }
}

// Sets the dynamic shared memory and launches `kernel` on a (query tiles,
// H, B) grid; the launch's cudaError_t.
template <int kDPad, typename Kernel>
cudaError_t launch(Kernel kernel, const Params& p, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<kDPad>();
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((p.Sq + kBlockQ - 1) / kBlockQ, p.H, p.B);
  kernel<<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace fwd
}  // namespace
