// Whole-sequence attention forward for Hopper (sm_90a), plain CUDA C++.
//
// Replaces: easynlp_tpu/ops/attention.py::_short_fwd_kernel, the Pallas TPU
// kernel behind attention(impl='short'). It computes the same function:
//   O = softmax(Q K^T * scale, masked by kv_mask, optionally causal with
//       q_offset = Skv - Sq) V
// for Skv <= 512, with f32 scores, f32 probabilities and f32 accumulation,
// and the output in the input dtype (f32 or bf16). Masked scores take the
// JAX package's finite NEG_INF (-1e30), so a query row whose keys are all
// masked averages V over the real Skv keys, as attention_reference does.
//
// What bounds it on this card: at the main path's shape (B=32, S=128, H=12,
// D=64, bf16) one call does 4*B*H*S*S*D = 1.6 GFLOP over about 25 MB of
// q/k/v/o, about 64 FLOP per byte. That is below the ~295 FLOP/B ridge of
// the H100's bf16 tensor cores, so a tensor-core kernel is bound by device
// memory. This first version multiplies with f32 FMAs on the CUDA cores
// (67 TFLOP/s peak, a ridge near 20 FLOP/B), so it is bound by FMA issue and
// shared-memory reads instead.
//
// What the design does about it: device-memory traffic is held to the
// minimum. No score or probability leaves shared memory (no [B,H,S,S]
// tensor in device memory), q/k/v are read in place through element
// strides (BERT's [B,S,H,D] projection views need no transpose copy), and
// the ragged edge is masked here (no padding copy). One block owns one
// (batch, head, 32-query tile) and walks K/V in 64-key tiles with an online
// softmax. Each thread keeps a 4x4 register tile of scores and a 4 x D/16
// tile of the output, so each shared-memory read feeds four FMAs. Moving the
// two products onto the tensor cores (mma.sync, then wgmma with TMA) is the
// next step.
//
// Built by easynlp_tpu_torch/kernels with
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// and called through ctypes (easynlp_tpu_torch/ops/attention.py).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;      // 4 warps
constexpr int kBlockQ = 32;        // query rows per block
constexpr int kBlockK = 64;        // keys per shared-memory tile
// Score-tile row stride: the two row groups of a warp sit 4 rows apart, and
// 4 * 68 = 272 = 16 (mod 32 banks), so their writes land in disjoint banks.
constexpr int kLdP = kBlockK + 4;
constexpr float kNegInf = -1e30f;  // easynlp_tpu/ops/attention.py NEG_INF

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const int32_t* mask;
  void* o;
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

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* dst, float x) { *dst = x; }
__device__ __forceinline__ void store(__nv_bfloat16* dst, float x) {
  *dst = __float2bfloat16(x);
}

// Copies `rows` rows of D contiguous elements (row stride `stride` elements)
// into shared memory as f32 with leading dimension `ld`. Rows at or past
// `valid` are written as zeros. Each thread moves 16 bytes at a time: the
// wrapper guarantees 16-byte aligned rows and D a multiple of 8.
template <typename T>
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

template <int kDPad>
constexpr size_t smem_bytes() {
  return sizeof(float) * (kBlockQ * (kDPad + 1) + kBlockK * (kDPad + 1) +
                          kBlockK * kDPad + kBlockQ * kLdP + 3 * kBlockQ);
}

// kDPad is D rounded up to 32, 64 or 128: it sizes the shared tiles and the
// per-thread output tile. Columns at or past D are computed from whatever the
// V tile holds there and never stored.
template <typename T, int kDPad>
__global__ void __launch_bounds__(kThreads)
short_attention_fwd_kernel(const Params p) {
  constexpr int kLdQK = kDPad + 1;  // odd: column walks are conflict-free
  constexpr int kOutCols = kDPad / 16;
  extern __shared__ float smem[];
  float* qs = smem;                       // [kBlockQ][kLdQK]
  float* ks = qs + kBlockQ * kLdQK;       // [kBlockK][kLdQK]
  float* vs = ks + kBlockK * kLdQK;       // [kBlockK][kDPad]
  float* ps = vs + kBlockK * kDPad;       // [kBlockQ][kLdP]
  float* row_max = ps + kBlockQ * kLdP;   // running max per query row
  float* row_sum = row_max + kBlockQ;     // running sum of exp per row
  float* row_scale = row_sum + kBlockQ;   // exp(old max - new max) per row

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int q0 = blockIdx.x * kBlockQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int D = p.D;

  const T* q = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh + q0 * p.q_ss;
  const T* k = static_cast<const T*>(p.k) + b * p.k_sb + h * p.k_sh;
  const T* v = static_cast<const T*>(p.v) + b * p.v_sb + h * p.v_sh;
  const int32_t* mask = p.mask + b * p.m_sb;

  load_rows(qs, kLdQK, q, p.q_ss, kBlockQ, min(kBlockQ, p.Sq - q0), D);
  if (tid < kBlockQ) {
    row_max[tid] = -INFINITY;
    row_sum[tid] = 0.f;
  }

  // This thread's tiles: query rows r0..r0+3; keys (and output columns)
  // c0 + 16*j.
  const int c0 = tid % 16;
  const int r0 = (tid / 16) * 4;
  float acc[4][kOutCols];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < kOutCols; ++c) acc[i][c] = 0.f;

  for (int k0 = 0; k0 < p.Skv; k0 += kBlockK) {
    const int kv_valid = min(kBlockK, p.Skv - k0);
    __syncthreads();  // the previous tile's readers are done
    load_rows(ks, kLdQK, k + k0 * p.k_ss, p.k_ss, kBlockK, kv_valid, D);
    load_rows(vs, kDPad, v + k0 * p.v_ss, p.v_ss, kBlockK, kv_valid, D);
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
      for (int i = 0; i < 4; ++i) qv[i] = qs[(r0 + i) * kLdQK + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = ks[(c0 + 16 * j) * kLdQK + d];
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
        } else if (!kept ||
                   (p.causal && key > q0 + r0 + i + p.q_offset)) {
          x = kNegInf;
        } else {
          x = s[i][j] * p.scale;
        }
        ps[(r0 + i) * kLdP + c0 + 16 * j] = x;
      }
    }
    __syncthreads();

    // Online softmax: warp w owns rows 8w..8w+7, each lane two keys of a row.
    for (int r = warp * 8; r < warp * 8 + 8; ++r) {
      float* row = ps + r * kLdP;
      const float x0 = row[lane];
      const float x1 = row[lane + 32];
      float mx = fmaxf(x0, x1);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_old = row_max[r];
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
        row_scale[r] = alpha;
        row_sum[r] = row_sum[r] * alpha + sum;
        row_max[r] = m_new;
      }
    }
    __syncthreads();

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float alpha = row_scale[r0 + i];
#pragma unroll
      for (int c = 0; c < kOutCols; ++c) acc[i][c] *= alpha;
    }
    for (int kk = 0; kk < kv_valid; ++kk) {
      float pv[4], vv[kOutCols];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = ps[(r0 + i) * kLdP + kk];
#pragma unroll
      for (int c = 0; c < kOutCols; ++c) vv[c] = vs[kk * kDPad + c0 + 16 * c];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < kOutCols; ++c) acc[i][c] = fmaf(pv[i], vv[c], acc[i][c]);
    }
  }

  T* o = static_cast<T*>(p.o) + b * p.o_sb + h * p.o_sh;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + r0 + i;
    if (row >= p.Sq) continue;
    const float inv = 1.f / row_sum[r0 + i];  // >= 1: the row max adds exp(0)
    T* orow = o + row * p.o_ss;
#pragma unroll
    for (int c = 0; c < kOutCols; ++c) {
      const int d = c0 + 16 * c;
      if (d < D) store(orow + d, acc[i][c] * inv);
    }
  }
}

template <typename T, int kDPad>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<kDPad>();
  auto kernel = short_attention_fwd_kernel<T, kDPad>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((p.Sq + kBlockQ - 1) / kBlockQ, p.H, p.B);
  kernel<<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_for_head_dim(const Params& p, cudaStream_t stream) {
  if (p.D <= 32) return launch<T, 32>(p, stream);
  if (p.D <= 64) return launch<T, 64>(p, stream);
  return launch<T, 128>(p, stream);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Strides are in elements; the last (D)
// dimension is contiguous. m_sb is the mask's batch stride (0 broadcasts one
// row over the batch). Returns a cudaError_t: 0 when the launch was accepted.
extern "C" int easynlp_short_attention_fwd(
    const void* q, const void* k, const void* v, const int32_t* mask, void* o,
    int dtype, int B, int H, int Sq, int Skv, int D,
    int64_t q_sb, int64_t q_ss, int64_t q_sh,
    int64_t k_sb, int64_t k_ss, int64_t k_sh,
    int64_t v_sb, int64_t v_ss, int64_t v_sh,
    int64_t o_sb, int64_t o_ss, int64_t o_sh,
    int64_t m_sb, int causal, float scale, void* stream) {
  if (B < 1 || H < 1 || Sq < 1 || Skv < 1 || Skv > 512 || D < 8 || D > 128 ||
      D % 8 != 0 || B > 65535 || H > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Params p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.mask = mask;
  p.o = o;
  p.B = B;
  p.H = H;
  p.Sq = Sq;
  p.Skv = Skv;
  p.D = D;
  p.q_sb = q_sb;
  p.q_ss = q_ss;
  p.q_sh = q_sh;
  p.k_sb = k_sb;
  p.k_ss = k_ss;
  p.k_sh = k_sh;
  p.v_sb = v_sb;
  p.v_ss = v_ss;
  p.v_sh = v_sh;
  p.o_sb = o_sb;
  p.o_ss = o_ss;
  p.o_sh = o_sh;
  p.m_sb = m_sb;
  p.causal = causal;
  p.q_offset = causal ? Skv - Sq : 0;
  p.scale = scale;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0) {
    err = launch_for_head_dim<float>(p, s);
  } else if (dtype == 1) {
    err = launch_for_head_dim<__nv_bfloat16>(p, s);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
