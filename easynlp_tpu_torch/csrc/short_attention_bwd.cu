// Whole-sequence attention backward for Hopper (sm_90a), plain CUDA C++.
//
// Replaces: easynlp_tpu/ops/attention.py::_short_bwd_kernel, the Pallas TPU
// kernel behind the custom VJP of attention(impl='short'). It computes the
// gradients of
//   O = softmax(Q K^T * scale, masked by kv_mask, optionally causal with
//       q_offset = Skv - Sq) V
// for Skv <= 512, with f32 arithmetic throughout and dq/dk/dv in the input
// dtype (f32 or bf16):
//   P  = the forward's probabilities, recomputed from Q and K (masked keys
//        at the finite -1e30, keys past Skv at weight exactly 0)
//   dV = P^T dO,  dP = dO V^T,  delta = rowsum(dO * O)
//   dS = P * (dP - delta) * scale, ZEROED at every masked or causally hidden
//        key (the TPU kernel does not zero it, so a fully masked row gets a
//        nonzero dq/dk there; ROADMAP C7)
//   dQ = dS K,  dK = dS^T Q.
// That is jax.grad of attention_reference: a fully masked row gets dq = 0,
// gives no dk, and its dv is P^T dO with P uniform over the real keys.
//
// What bounds it on this card: at the training path's shape (B=32, S=128,
// H=12, D=64, bf16) the gradients need 10*B*H*S*S*D = 4.0 GFLOP over about
// 50 MB of q/k/v/o/dO/dq/dk/dv. This first version multiplies with f32 FMAs
// on the CUDA cores (67 TFLOP/s peak), and it recomputes Q K^T in each of
// its three passes (about 6.4 GFLOP of FMA work in all), so it is bound by
// FMA issue and shared-memory reads, as the forward is; device memory is
// far from the limit.
//
// What the design does about it. The TPU kernel holds a whole
// (batch-block x head-block) sequence in VMEM and emits all three gradients
// in one grid step. A Hopper block has 227 KB of shared memory and blocks
// run in no order, so the work is split into three launches, none of which
// uses atomics (two runs give bit-identical gradients):
//   pass 1, one block per (b, h, 32-query tile): the row max m and
//     1/l = 1/sum(exp(s - m)) over all keys, and delta = rowsum(dO * O).
//     Keeping m and 1/l apart (not LSE = m + log l) keeps a fully masked
//     row right: there m = -1e30 and m + log l rounds back to -1e30 in f32.
//   pass 2, one block per (b, h, 64-key tile): K and V stay in shared
//     memory; the block walks the query tiles and accumulates dK and dV in
//     registers (each thread a 4-key x D/16 tile of each).
//   pass 3, one block per (b, h, 32-query tile): Q and dO stay in shared
//     memory; the block walks the key tiles and accumulates dQ.
// q/k/v/o/dO are read in place through (batch, seq, head) element strides
// (BERT's [B,S,H,D] projection views need no transpose copy) and dq/dk/dv
// are written with their own strides; the ragged edge is masked here, so
// nothing is padded. Moving the products onto the tensor cores (mma.sync,
// then wgmma with TMA) is the next step.
//
// Built by easynlp_tpu_torch/kernels with
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// and called through ctypes (easynlp_tpu_torch/ops/attention.py).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "attention_tile.cuh"

namespace {

constexpr int kThreads = 256;      // 8 warps
constexpr int kBlockQ = 32;        // query rows per tile
constexpr int kBlockK = 64;        // keys per tile
constexpr int kLdP = kBlockK + 4;  // row stride of the P and dS tiles

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const int32_t* mask;
  const void* o;
  const void* dout;
  void* dq;
  void* dk;
  void* dv;
  float* row_max;    // [B,H,Sq]
  float* row_inv;    // [B,H,Sq]: 1 / sum(exp(s - row_max))
  float* row_delta;  // [B,H,Sq]: rowsum(dO * O)
  int B, H, Sq, Skv, D;
  int64_t q_sb, q_ss, q_sh;
  int64_t k_sb, k_ss, k_sh;
  int64_t v_sb, v_ss, v_sh;
  int64_t o_sb, o_ss, o_sh;
  int64_t do_sb, do_ss, do_sh;
  int64_t dq_sb, dq_ss, dq_sh;
  int64_t dk_sb, dk_ss, dk_sh;
  int64_t dv_sb, dv_ss, dv_sh;
  int64_t m_sb;
  int causal;
  int q_offset;
  float scale;
};

// The score of (query row, key) as the forward kernel forms it: -inf past
// Skv (weight exactly 0), the finite -1e30 where masked or causally hidden.
__device__ __forceinline__ bool key_hidden(const Params& p, const int32_t* mask,
                                           int row, int key) {
  return mask[key] == 0 || (p.causal && key > row + p.q_offset);
}

// This thread's 2 x 4 piece of the 32 x 64 tiles S = Q K^T and dP = dO V^T
// (rows r0, r0+1; keys c0 + 16 j), from f32 tiles in shared memory with
// leading dimension ld. With kDP false only S is formed.
template <bool kDP>
__device__ __forceinline__ void score_tiles(const float* qs, const float* dos,
                                            const float* ks, const float* vs,
                                            int ld, int D, int r0, int c0,
                                            float s[2][4], float dp[2][4]) {
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      s[i][j] = 0.f;
      dp[i][j] = 0.f;
    }
#pragma unroll 4
  for (int d = 0; d < D; ++d) {
    float qv[2], kv[4];
#pragma unroll
    for (int i = 0; i < 2; ++i) qv[i] = qs[(r0 + i) * ld + d];
#pragma unroll
    for (int j = 0; j < 4; ++j) kv[j] = ks[(c0 + 16 * j) * ld + d];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    if (kDP) {
      float ov[2], vv[4];
#pragma unroll
      for (int i = 0; i < 2; ++i) ov[i] = dos[(r0 + i) * ld + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) vv[j] = vs[(c0 + 16 * j) * ld + d];
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) dp[i][j] = fmaf(ov[i], vv[j], dp[i][j]);
    }
  }
}

// P and dS of the (q0.., k0..) tile into shared memory (ps may be null),
// from the row statistics of pass 1 (rm, ri, rd: this tile's 32 rows).
template <int kDPad>
__device__ __forceinline__ void p_ds_tile(const Params& p, const int32_t* mask,
                                          const float* qs, const float* dos,
                                          const float* ks, const float* vs,
                                          const float* rm, const float* ri,
                                          const float* rd, int q0, int k0,
                                          float* ps, float* dss) {
  constexpr int ld = kDPad + 1;
  const int c0 = threadIdx.x % 16;
  const int r0 = (threadIdx.x / 16) * 2;
  float s[2][4], dp[2][4];
  score_tiles<true>(qs, dos, ks, vs, ld, p.D, r0, c0, s, dp);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int key = k0 + c0 + 16 * j;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = r0 + i;
      const int row = q0 + r;
      float pr = 0.f, ds = 0.f;
      if (row < p.Sq && key < p.Skv) {
        const bool hidden = key_hidden(p, mask, row, key);
        const float x = hidden ? kNegInf : s[i][j] * p.scale;
        // f32 before exp: in a fully masked row x - m is 0, not -1e30 + 1e30
        pr = expf(x - rm[r]) * ri[r];
        if (!hidden) ds = pr * (dp[i][j] - rd[r]) * p.scale;
      }
      if (ps != nullptr) ps[r * kLdP + c0 + 16 * j] = pr;
      dss[r * kLdP + c0 + 16 * j] = ds;
    }
  }
}

// Pass 1: row max, 1/sum of exp and delta for one (b, h, 32-query tile).
template <typename T, int kDPad>
__global__ void __launch_bounds__(kThreads)
short_attention_bwd_stats_kernel(const Params p) {
  constexpr int ld = kDPad + 1;
  extern __shared__ float smem[];
  float* qs = smem;               // [kBlockQ][ld]
  float* ks = qs + kBlockQ * ld;  // [kBlockK][ld]
  float* ps = ks + kBlockK * ld;  // [kBlockQ][kLdP]

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int q0 = blockIdx.x * kBlockQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int D = p.D;
  const T* q = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
  const T* k = static_cast<const T*>(p.k) + b * p.k_sb + h * p.k_sh;
  const T* o = static_cast<const T*>(p.o) + b * p.o_sb + h * p.o_sh;
  const T* dout = static_cast<const T*>(p.dout) + b * p.do_sb + h * p.do_sh;
  const int32_t* mask = p.mask + b * p.m_sb;
  const int64_t stat0 = (static_cast<int64_t>(b) * p.H + h) * p.Sq;

  load_rows<kThreads>(qs, ld, q + q0 * p.q_ss, p.q_ss, kBlockQ, min(kBlockQ, p.Sq - q0), D);

  // Warp w owns rows 4w..4w+3: their delta now, their softmax stats below.
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + warp * 4 + i;
    if (row >= p.Sq) continue;  // warp-uniform
    float acc = 0.f;
    for (int d = lane; d < D; d += 32)
      acc = fmaf(to_float(dout[row * p.do_ss + d]), to_float(o[row * p.o_ss + d]), acc);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
    if (lane == 0) p.row_delta[stat0 + row] = acc;
  }

  const int c0 = tid % 16;
  const int r0 = (tid / 16) * 2;
  float m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
  }
  for (int k0 = 0; k0 < p.Skv; k0 += kBlockK) {
    __syncthreads();  // the previous tile's readers are done
    load_rows<kThreads>(ks, ld, k + k0 * p.k_ss, p.k_ss, kBlockK, min(kBlockK, p.Skv - k0), D);
    __syncthreads();
    float s[2][4], unused[2][4];
    score_tiles<false>(qs, nullptr, ks, nullptr, ld, D, r0, c0, s, unused);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int key = k0 + c0 + 16 * j;
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        float x;
        if (key >= p.Skv) {
          x = -INFINITY;  // past the sequence: not a key, weight exactly 0
        } else if (key_hidden(p, mask, q0 + r0 + i, key)) {
          x = kNegInf;
        } else {
          x = s[i][j] * p.scale;
        }
        ps[(r0 + i) * kLdP + c0 + 16 * j] = x;
      }
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float* row = ps + (warp * 4 + i) * kLdP;
      const float x0 = row[lane];
      const float x1 = row[lane + 32];
      float mx = fmaxf(x0, x1);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      // Key k0 is in range and scores at least NEG_INF, so m_new is finite.
      const float m_new = fmaxf(m[i], mx);
      float sum = expf(x0 - m_new) + expf(x1 - m_new);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l[i] = l[i] * expf(m[i] - m_new) + sum;
      m[i] = m_new;
    }
  }
  if (lane == 0) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + warp * 4 + i;
      if (row < p.Sq) {
        p.row_max[stat0 + row] = m[i];
        p.row_inv[stat0 + row] = 1.f / l[i];  // l >= 1: the max adds exp(0)
      }
    }
  }
}

// Loads the row statistics of query rows q0..q0+31 into shared memory
// (zeros past Sq, where p_ds_tile writes zeros anyway).
__device__ __forceinline__ void load_stats(const Params& p, int64_t stat0,
                                           int q0, float* rm, float* ri,
                                           float* rd) {
  const int tid = threadIdx.x;
  if (tid < kBlockQ) {
    const int row = q0 + tid;
    const bool ok = row < p.Sq;
    rm[tid] = ok ? p.row_max[stat0 + row] : 0.f;
    ri[tid] = ok ? p.row_inv[stat0 + row] : 0.f;
    rd[tid] = ok ? p.row_delta[stat0 + row] : 0.f;
  }
}

template <int kDPad>
constexpr size_t smem_stats() {
  return sizeof(float) * ((kBlockQ + kBlockK) * (kDPad + 1) + kBlockQ * kLdP);
}

template <int kDPad>
constexpr size_t smem_grads() {
  return sizeof(float) * ((2 * kBlockQ + 2 * kBlockK) * (kDPad + 1) +
                          2 * kBlockQ * kLdP + 3 * kBlockQ);
}

// Pass 2: dK and dV of one (b, h, 64-key tile), over every query tile.
template <typename T, int kDPad>
__global__ void __launch_bounds__(kThreads)
short_attention_bwd_dkdv_kernel(const Params p) {
  constexpr int ld = kDPad + 1;
  constexpr int kCols = kDPad / 16;
  extern __shared__ float smem[];
  float* ks = smem;                  // [kBlockK][ld]
  float* vs = ks + kBlockK * ld;     // [kBlockK][ld]
  float* qs = vs + kBlockK * ld;     // [kBlockQ][ld]
  float* dos = qs + kBlockQ * ld;    // [kBlockQ][ld]
  float* ps = dos + kBlockQ * ld;    // [kBlockQ][kLdP]
  float* dss = ps + kBlockQ * kLdP;  // [kBlockQ][kLdP]
  float* rm = dss + kBlockQ * kLdP;  // [kBlockQ] x 3
  float* ri = rm + kBlockQ;
  float* rd = ri + kBlockQ;

  const int tid = threadIdx.x;
  const int k0 = blockIdx.x * kBlockK;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int D = p.D;
  const T* q = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
  const T* k = static_cast<const T*>(p.k) + b * p.k_sb + h * p.k_sh;
  const T* v = static_cast<const T*>(p.v) + b * p.v_sb + h * p.v_sh;
  const T* dout = static_cast<const T*>(p.dout) + b * p.do_sb + h * p.do_sh;
  const int32_t* mask = p.mask + b * p.m_sb;
  const int64_t stat0 = (static_cast<int64_t>(b) * p.H + h) * p.Sq;

  const int kv_valid = min(kBlockK, p.Skv - k0);
  load_rows<kThreads>(ks, ld, k + k0 * p.k_ss, p.k_ss, kBlockK, kv_valid, D);
  load_rows<kThreads>(vs, ld, v + k0 * p.v_ss, p.v_ss, kBlockK, kv_valid, D);

  // This thread's accumulator tiles: keys kr0..kr0+3, columns c0 + 16 c.
  const int c0 = tid % 16;
  const int kr0 = (tid / 16) * 4;
  float dk_acc[4][kCols], dv_acc[4][kCols];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      dk_acc[i][c] = 0.f;
      dv_acc[i][c] = 0.f;
    }

  for (int q0 = 0; q0 < p.Sq; q0 += kBlockQ) {
    const int q_valid = min(kBlockQ, p.Sq - q0);
    __syncthreads();  // the previous tile's readers are done
    load_rows<kThreads>(qs, ld, q + q0 * p.q_ss, p.q_ss, kBlockQ, q_valid, D);
    load_rows<kThreads>(dos, ld, dout + q0 * p.do_ss, p.do_ss, kBlockQ, q_valid, D);
    load_stats(p, stat0, q0, rm, ri, rd);
    __syncthreads();
    p_ds_tile<kDPad>(p, mask, qs, dos, ks, vs, rm, ri, rd, q0, k0, ps, dss);
    __syncthreads();
    for (int r = 0; r < q_valid; ++r) {
      float pv[4], dsv[4], ov[kCols], qv[kCols];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        pv[i] = ps[r * kLdP + kr0 + i];
        dsv[i] = dss[r * kLdP + kr0 + i];
      }
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        ov[c] = dos[r * ld + c0 + 16 * c];
        qv[c] = qs[r * ld + c0 + 16 * c];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < kCols; ++c) {
          dv_acc[i][c] = fmaf(pv[i], ov[c], dv_acc[i][c]);
          dk_acc[i][c] = fmaf(dsv[i], qv[c], dk_acc[i][c]);
        }
    }
  }

  T* dk = static_cast<T*>(p.dk) + b * p.dk_sb + h * p.dk_sh;
  T* dv = static_cast<T*>(p.dv) + b * p.dv_sb + h * p.dv_sh;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int key = k0 + kr0 + i;
    if (key >= p.Skv) continue;
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      const int d = c0 + 16 * c;
      if (d < D) {
        store(dk + key * p.dk_ss + d, dk_acc[i][c]);
        store(dv + key * p.dv_ss + d, dv_acc[i][c]);
      }
    }
  }
}

// Pass 3: dQ of one (b, h, 32-query tile), over every key tile.
template <typename T, int kDPad>
__global__ void __launch_bounds__(kThreads)
short_attention_bwd_dq_kernel(const Params p) {
  constexpr int ld = kDPad + 1;
  constexpr int kCols = kDPad / 16;
  extern __shared__ float smem[];
  float* ks = smem;                  // [kBlockK][ld]
  float* vs = ks + kBlockK * ld;     // [kBlockK][ld]
  float* qs = vs + kBlockK * ld;     // [kBlockQ][ld]
  float* dos = qs + kBlockQ * ld;    // [kBlockQ][ld]
  float* dss = dos + kBlockQ * ld;   // [kBlockQ][kLdP]
  // smem_grads sizes two P-sized tiles; this pass needs only dS
  float* rm = dss + 2 * kBlockQ * kLdP;  // [kBlockQ] x 3
  float* ri = rm + kBlockQ;
  float* rd = ri + kBlockQ;

  const int tid = threadIdx.x;
  const int q0 = blockIdx.x * kBlockQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int D = p.D;
  const T* q = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
  const T* k = static_cast<const T*>(p.k) + b * p.k_sb + h * p.k_sh;
  const T* v = static_cast<const T*>(p.v) + b * p.v_sb + h * p.v_sh;
  const T* dout = static_cast<const T*>(p.dout) + b * p.do_sb + h * p.do_sh;
  const int32_t* mask = p.mask + b * p.m_sb;
  const int64_t stat0 = (static_cast<int64_t>(b) * p.H + h) * p.Sq;

  const int q_valid = min(kBlockQ, p.Sq - q0);
  load_rows<kThreads>(qs, ld, q + q0 * p.q_ss, p.q_ss, kBlockQ, q_valid, D);
  load_rows<kThreads>(dos, ld, dout + q0 * p.do_ss, p.do_ss, kBlockQ, q_valid, D);
  load_stats(p, stat0, q0, rm, ri, rd);

  // This thread's accumulator tile: rows r0, r0+1 (the rows of its dS
  // piece), columns c0 + 16 c.
  const int c0 = tid % 16;
  const int r0 = (tid / 16) * 2;
  float acc[2][kCols];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[i][c] = 0.f;

  for (int k0 = 0; k0 < p.Skv; k0 += kBlockK) {
    const int kv_valid = min(kBlockK, p.Skv - k0);
    __syncthreads();  // the previous tile's readers are done
    load_rows<kThreads>(ks, ld, k + k0 * p.k_ss, p.k_ss, kBlockK, kv_valid, D);
    load_rows<kThreads>(vs, ld, v + k0 * p.v_ss, p.v_ss, kBlockK, kv_valid, D);
    __syncthreads();
    p_ds_tile<kDPad>(p, mask, qs, dos, ks, vs, rm, ri, rd, q0, k0, nullptr, dss);
    __syncthreads();
    for (int kk = 0; kk < kv_valid; ++kk) {
      float dsv[2], kv[kCols];
#pragma unroll
      for (int i = 0; i < 2; ++i) dsv[i] = dss[(r0 + i) * kLdP + kk];
#pragma unroll
      for (int c = 0; c < kCols; ++c) kv[c] = ks[kk * ld + c0 + 16 * c];
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int c = 0; c < kCols; ++c) acc[i][c] = fmaf(dsv[i], kv[c], acc[i][c]);
    }
  }

  T* dq = static_cast<T*>(p.dq) + b * p.dq_sb + h * p.dq_sh;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = q0 + r0 + i;
    if (row >= p.Sq) continue;
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      const int d = c0 + 16 * c;
      if (d < D) store(dq + row * p.dq_ss + d, acc[i][c]);
    }
  }
}

template <typename Kernel>
cudaError_t launch_one(Kernel kernel, dim3 grid, size_t smem, const Params& p,
                       cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  kernel<<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename T, int kDPad>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  const dim3 q_grid((p.Sq + kBlockQ - 1) / kBlockQ, p.H, p.B);
  const dim3 k_grid((p.Skv + kBlockK - 1) / kBlockK, p.H, p.B);
  cudaError_t err = launch_one(short_attention_bwd_stats_kernel<T, kDPad>,
                               q_grid, smem_stats<kDPad>(), p, stream);
  if (err != cudaSuccess) return err;
  err = launch_one(short_attention_bwd_dkdv_kernel<T, kDPad>, k_grid,
                   smem_grads<kDPad>(), p, stream);
  if (err != cudaSuccess) return err;
  return launch_one(short_attention_bwd_dq_kernel<T, kDPad>, q_grid,
                    smem_grads<kDPad>(), p, stream);
}

template <typename T>
cudaError_t launch_for_head_dim(const Params& p, cudaStream_t stream) {
  if (p.D <= 32) return launch<T, 32>(p, stream);
  if (p.D <= 64) return launch<T, 64>(p, stream);
  return launch<T, 128>(p, stream);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Strides are in elements; the last (D)
// dimension of every tensor is contiguous. m_sb is the mask's batch stride
// (0 broadcasts one row over the batch). stats is f32 scratch of
// 3 * B * H * Sq floats. Returns a cudaError_t: 0 when all three launches
// were accepted.
extern "C" int easynlp_short_attention_bwd(
    const void* q, const void* k, const void* v, const int32_t* mask,
    const void* o, const void* dout, void* dq, void* dk, void* dv,
    float* stats, int dtype, int B, int H, int Sq, int Skv, int D,
    int64_t q_sb, int64_t q_ss, int64_t q_sh,
    int64_t k_sb, int64_t k_ss, int64_t k_sh,
    int64_t v_sb, int64_t v_ss, int64_t v_sh,
    int64_t o_sb, int64_t o_ss, int64_t o_sh,
    int64_t do_sb, int64_t do_ss, int64_t do_sh,
    int64_t dq_sb, int64_t dq_ss, int64_t dq_sh,
    int64_t dk_sb, int64_t dk_ss, int64_t dk_sh,
    int64_t dv_sb, int64_t dv_ss, int64_t dv_sh,
    int64_t m_sb, int causal, float scale, void* stream) {
  if (B < 1 || H < 1 || Sq < 1 || Skv < 1 || Skv > 512 || D < 8 || D > 128 ||
      D % 8 != 0 || B > 65535 || H > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int64_t n_rows = static_cast<int64_t>(B) * H * Sq;
  Params p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.mask = mask;
  p.o = o;
  p.dout = dout;
  p.dq = dq;
  p.dk = dk;
  p.dv = dv;
  p.row_max = stats;
  p.row_inv = stats + n_rows;
  p.row_delta = stats + 2 * n_rows;
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
  p.do_sb = do_sb;
  p.do_ss = do_ss;
  p.do_sh = do_sh;
  p.dq_sb = dq_sb;
  p.dq_ss = dq_ss;
  p.dq_sh = dq_sh;
  p.dk_sb = dk_sb;
  p.dk_ss = dk_ss;
  p.dk_sh = dk_sh;
  p.dv_sb = dv_sb;
  p.dv_ss = dv_ss;
  p.dv_sh = dv_sh;
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
