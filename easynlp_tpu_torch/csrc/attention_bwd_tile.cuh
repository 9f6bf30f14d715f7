// The tile walks shared by the port's two attention backward kernels for
// f32 inputs (short_attention_bwd.cu, flash_attention_bwd.cu; bf16 inputs
// take the tensor cores: attention_bwd_mma.cuh and short_attention_bwd.cu's
// one-block kernel): plain CUDA C++ for Hopper (sm_90a), f32 FMAs on the
// CUDA cores.
//
// Both compute the gradients of
//   O = softmax(Q K^T * scale, masked by kv_mask, optionally causal with
//       q_offset = Skv - Sq) V
// from per-row softmax statistics and delta = rowsum(dO * O), with no
// atomics:
//   dK/dV pass, one block per (b, h, 64-key tile): K and V stay in shared
//     memory; the block walks the query tiles and accumulates dK and dV in
//     registers (each thread a 4-key x D/16 tile of each);
//   dQ pass, one block per (b, h, 32-query tile): Q and dO stay in shared
//     memory; the block walks the key tiles up to its last row's diagonal
//     (past it dS is 0) and accumulates dQ.
// In both, P = exp(s - m) / l for the tile's rows, dV += P^T dO,
// dP = dO V^T, dS = P * (dP - delta) * scale ZEROED at every masked or
// causally hidden key (as jax.grad of attention_reference: no gradient
// reaches a masked logit), dK += dS^T Q, dQ += dS K.
//
// The two kernels differ in their row statistics (kFlash):
//   short: pass 1 of short_attention_bwd.cu writes m and 1/l per row, kept
//     apart so that a fully masked row (every score -1e30) gets P = 1/Skv
//     at every key; the dK/dV pass must then walk every query tile;
//   flash: m = the forward's LSE and 1/l = 1. A fully masked row's LSE is
//     -1e30 + log(Skv), which f32 rounds to -1e30, so exp(s - LSE) would
//     weigh each of its keys 1, not 1/Skv; such a row takes P = 0 here
//     (so dq = 0 and no dk) and its dv term, dO/Skv at every key, comes
//     from the sum of dO over those rows that flash_attention_bwd.cu's
//     pre-pass writes. With that, the dK/dV pass may start at the first
//     query tile that sees the key tile under causal masking.
// q/k/v/o/dO are read through (batch, seq, head) element strides and
// dq/dk/dv written with their own; the ragged edges are masked here. The
// flash backward's pre-pass (delta and the masked rows' dO sums) is here
// too: the bf16 short backward past 128 keys runs it as well.

#pragma once

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
// A row whose LSE is below this saw no visible key (its LSE is -1e30).
constexpr float kMaskedRowLse = 0.5f * kNegInf;

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
  float* row_max;          // short: [B,H,Sq] row max
  float* row_inv;          // short: [B,H,Sq] 1 / sum(exp(s - row_max))
  float* row_delta;        // [B,H,Sq]: rowsum(dO * O)
  const float* lse;        // flash: [B,H,Sq], the forward's LSE
  float* masked_dout_sum;  // flash: [B,H,n_chunks,D], sum of dO over the
                           // fully masked rows of each pre-pass chunk
  int n_chunks;
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

// Fills p's shapes, strides (q, k, v, o, dO, dq, dk, dv: batch, seq, head
// each), mask batch stride and flags. Returns false for shapes the kernels
// do not take.
inline bool set_shapes(Params* p, int B, int H, int Sq, int Skv, int D,
                       const int64_t s[24], int64_t m_sb, int causal,
                       float scale) {
  if (B < 1 || H < 1 || Sq < 1 || Skv < 1 || D < 8 || D > 128 || D % 8 != 0 ||
      B > 65535 || H > 65535) {
    return false;
  }
  p->B = B;
  p->H = H;
  p->Sq = Sq;
  p->Skv = Skv;
  p->D = D;
  int64_t* dst[24] = {&p->q_sb,  &p->q_ss,  &p->q_sh,  &p->k_sb,  &p->k_ss,
                      &p->k_sh,  &p->v_sb,  &p->v_ss,  &p->v_sh,  &p->o_sb,
                      &p->o_ss,  &p->o_sh,  &p->do_sb, &p->do_ss, &p->do_sh,
                      &p->dq_sb, &p->dq_ss, &p->dq_sh, &p->dk_sb, &p->dk_ss,
                      &p->dk_sh, &p->dv_sb, &p->dv_ss, &p->dv_sh};
  for (int i = 0; i < 24; ++i) *dst[i] = s[i];
  p->m_sb = m_sb;
  p->causal = causal;
  p->q_offset = causal ? Skv - Sq : 0;
  p->scale = scale;
  return true;
}

// The score of (query row, key) as the forward kernels form it: -inf past
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
// from the tile's row statistics (rm, ri, rd: its 32 rows).
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

// Loads the row statistics of query rows q0..q0+31 into shared memory
// (zeros past Sq, where p_ds_tile writes zeros anyway). flash: m = LSE,
// 1/l = 1, and m = +inf for a fully masked row, so its P is exactly 0.
template <bool kFlash>
__device__ __forceinline__ void load_stats(const Params& p, int64_t stat0,
                                           int q0, float* rm, float* ri,
                                           float* rd) {
  const int tid = threadIdx.x;
  if (tid < kBlockQ) {
    const int row = q0 + tid;
    const bool ok = row < p.Sq;
    if (kFlash) {
      const float lse = ok ? p.lse[stat0 + row] : 0.f;
      rm[tid] = lse < kMaskedRowLse ? INFINITY : lse;
      ri[tid] = 1.f;
    } else {
      rm[tid] = ok ? p.row_max[stat0 + row] : 0.f;
      ri[tid] = ok ? p.row_inv[stat0 + row] : 0.f;
    }
    rd[tid] = ok ? p.row_delta[stat0 + row] : 0.f;
  }
}

// Shared memory of the dK/dV and dQ passes: K, V, Q, dO tiles, two P-sized
// tiles, the row statistics and the flash pass's masked-row dv term.
template <int kDPad>
constexpr size_t smem_grads() {
  return sizeof(float) * ((2 * kBlockQ + 2 * kBlockK) * (kDPad + 1) +
                          2 * kBlockQ * kLdP + 3 * kBlockQ + kDPad);
}

// dK and dV of one (b, h, 64-key tile), over the query tiles.
template <typename T, int kDPad, bool kFlash>
__global__ void __launch_bounds__(kThreads)
attention_bwd_dkdv_kernel(const Params p) {
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
  float* masked_dv = rd + kBlockQ;   // [kDPad] (flash)

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

  // flash: under causal masking, rows before k0 - q_offset see none of
  // these keys (and, not being fully masked, give them P = 0), so the walk
  // starts at the tile holding that row.
  int q_begin = 0;
  if (kFlash && p.causal) q_begin = max(0, k0 - p.q_offset) / kBlockQ * kBlockQ;
  for (int q0 = q_begin; q0 < p.Sq; q0 += kBlockQ) {
    const int q_valid = min(kBlockQ, p.Sq - q0);
    __syncthreads();  // the previous tile's readers are done
    load_rows<kThreads>(qs, ld, q + q0 * p.q_ss, p.q_ss, kBlockQ, q_valid, D);
    load_rows<kThreads>(dos, ld, dout + q0 * p.do_ss, p.do_ss, kBlockQ, q_valid, D);
    load_stats<kFlash>(p, stat0, q0, rm, ri, rd);
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

  if (kFlash) {
    // Each fully masked row adds dO / Skv to the dv of every real key,
    // causally hidden ones included (its P is 1/Skv everywhere).
    if (tid < kDPad) {
      float sum = 0.f;
      if (tid < D) {
        const float* part = p.masked_dout_sum +
                            (static_cast<int64_t>(b) * p.H + h) * p.n_chunks * D + tid;
        for (int c = 0; c < p.n_chunks; ++c) sum += part[c * D];
      }
      masked_dv[tid] = sum / p.Skv;
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < kCols; ++c) dv_acc[i][c] += masked_dv[c0 + 16 * c];
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

// dQ of one (b, h, 32-query tile), over the key tiles up to its last row's
// diagonal: past it every key is causally hidden and dS is 0.
template <typename T, int kDPad, bool kFlash>
__global__ void __launch_bounds__(kThreads)
attention_bwd_dq_kernel(const Params p) {
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
  load_stats<kFlash>(p, stat0, q0, rm, ri, rd);

  // This thread's accumulator tile: rows r0, r0+1 (the rows of its dS
  // piece), columns c0 + 16 c.
  const int c0 = tid % 16;
  const int r0 = (tid / 16) * 2;
  float acc[2][kCols];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[i][c] = 0.f;

  const int kv_end = p.causal ? max(0, min(p.Skv, q0 + q_valid + p.q_offset)) : p.Skv;
  for (int k0 = 0; k0 < kv_end; k0 += kBlockK) {
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

// The dK/dV pass, then the dQ pass, on the caller's stream.
template <typename T, int kDPad, bool kFlash>
cudaError_t launch_grads(const Params& p, cudaStream_t stream) {
  const dim3 q_grid((p.Sq + kBlockQ - 1) / kBlockQ, p.H, p.B);
  const dim3 k_grid((p.Skv + kBlockK - 1) / kBlockK, p.H, p.B);
  cudaError_t err = launch_one(attention_bwd_dkdv_kernel<T, kDPad, kFlash>, k_grid,
                               smem_grads<kDPad>(), p, stream);
  if (err != cudaSuccess) return err;
  return launch_one(attention_bwd_dq_kernel<T, kDPad, kFlash>, q_grid,
                    smem_grads<kDPad>(), p, stream);
}

constexpr int kPreRows = 128;  // query rows per pre-pass block

// The flash backward's pre-pass (flash_attention_bwd.cu, and the bf16
// short backward past 128 keys): delta of each row of one (b, h, 128-row
// chunk), and the sum of dO over its fully masked rows (LSE below
// kMaskedRowLse; D floats per chunk), which the dK/dV pass turns into their
// dv term.
template <typename T>
__global__ void __launch_bounds__(kThreads)
flash_attention_bwd_pre_kernel(const Params p) {
  __shared__ float part[kThreads / 32][128];
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int r0 = blockIdx.x * kPreRows;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int D = p.D;
  const T* o = static_cast<const T*>(p.o) + b * p.o_sb + h * p.o_sh;
  const T* dout = static_cast<const T*>(p.dout) + b * p.do_sb + h * p.do_sh;
  const int64_t stat0 = (static_cast<int64_t>(b) * p.H + h) * p.Sq;

  // lane owns columns lane + 32 j of every row its warp visits
  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  for (int i = warp; i < kPreRows; i += kThreads / 32) {
    const int row = r0 + i;
    if (row >= p.Sq) break;  // warp-uniform
    float dov[4], delta = 0.f;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int d = lane + 32 * j;
      dov[j] = 0.f;
      if (d < D) {
        dov[j] = to_float(dout[row * p.do_ss + d]);
        delta = fmaf(dov[j], to_float(o[row * p.o_ss + d]), delta);
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) delta += __shfl_xor_sync(0xffffffffu, delta, off);
    if (lane == 0) p.row_delta[stat0 + row] = delta;
    if (p.lse[stat0 + row] < kMaskedRowLse) {
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[j] += dov[j];
    }
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) part[warp][lane + 32 * j] = acc[j];
  __syncthreads();
  if (tid < D) {
    float sum = 0.f;
#pragma unroll
    for (int w = 0; w < kThreads / 32; ++w) sum += part[w][tid];
    p.masked_dout_sum[((static_cast<int64_t>(b) * p.H + h) * p.n_chunks + blockIdx.x) * D +
                      tid] = sum;
  }
}

template <typename T>
cudaError_t launch_pre_pass(const Params& p, cudaStream_t stream) {
  flash_attention_bwd_pre_kernel<T>
      <<<dim3(p.n_chunks, p.H, p.B), kThreads, 0, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace
