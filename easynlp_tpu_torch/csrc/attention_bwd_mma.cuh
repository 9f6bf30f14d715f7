// The bf16 flash attention backward on Hopper's tensor cores (sm_90a):
// the dK/dV pass and the dQ pass that flash_attention_bwd.cu launches for
// bf16 inputs after its pre-pass, and short_attention_bwd.cu for bf16
// inputs past 128 keys or queries after its LSE pass and the same
// pre-pass. f32 inputs keep attention_bwd_tile.cuh's CUDA-core walk.
//
// Replaces: easynlp_tpu/ops/attention.py::_bwd_dkdv_kernel (:232) and
// ::_bwd_dq_kernel (:286), the Pallas TPU kernels of _flash_bwd. The
// function is the one attention_bwd_tile.cuh states for kFlash:
// P = exp(s * scale - LSE) from the forward's LSE, P = 0 on a fully masked
// row (its dv term comes from the pre-pass), dS = P * (dP - delta) * scale
// zeroed at every masked or causally hidden key, keys past Skv weigh 0,
// q_offset = Skv - Sq applied directly, no atomics.
//
// What bounds it on this card: at BART-base's encoder (B=8, S=1024, H=12,
// D=64) the backward needs 10 * B*H*S*S*D = 64.4 GFLOP against ~100 MB of
// q/k/v/o/dO/dq/dk/dv, about 640 FLOP per byte: above the bf16 tensor
// cores' ridge (~295), so bound by operations, 0.04-0.07 ms at 989 TFLOP/s.
// The two passes recompute Q K^T and dO V^T (14 products where 10 are
// needed) to stay free of atomics and bit-reproducible.
//
// What the design does about it:
//  - Every product is mma.sync.m16n8k16 with bf16 operands and f32
//    accumulators (the helpers of attention_mma.cuh, which the forward and
//    the short backward share). Operands come from shared memory through ldmatrix
//    (ldmatrix.trans where the product needs the tile transposed), in
//    bf16 tiles whose rows are padded to D + 8 elements, so the eight rows
//    an ldmatrix reads fall in disjoint banks.
//  - dK/dV pass, one block per (b, h, 64-key tile), 4 warps of 16 keys:
//    keys are the rows, S^T = K Q^T and dP^T = V dO^T, so the m16n8
//    accumulators of P^T and dS^T, rounded to bf16, are directly the A
//    fragments of dV += P^T dO and dK += dS^T Q (FlashAttention-2's
//    register reuse): P and dS never touch shared memory.
//  - dQ pass, one block per (b, h, 64-query tile), 4 warps of 16 rows:
//    S = Q K^T and dP = dO V^T, dS in registers, dQ += dS K with K read
//    through ldmatrix.trans.
//  - The streamed side (Q/dO tiles and their LSE and delta in the dK/dV
//    pass, K/V tiles and their key flags in the dQ pass) goes through a
//    two-stage ring in shared memory filled by cp.async: the next tile
//    loads while this one computes. Rows past Sq or Skv and columns past D
//    (D = 8, 24, 40, ... padded to the MMA depth) are zero-filled by the
//    copy's src-size 0 form.
//  - S, dP, delta, LSE and all accumulators stay f32; P and dS are rounded
//    to bf16 once, as A operands. The dK/dV pass works through each query
//    tile 16 queries at a time, so that S^T and dP^T take few registers
//    beside the dK and dV accumulators; at D = 128 and 160 it walks
//    32-query tiles.
//  - What remains: every warp reads the streamed tile through ldmatrix for
//    its own 16 rows, about one ldmatrix.x4 (512 bytes, four cycles of an
//    SM's shared-memory port) per one or two MMAs of one cycle each, so
//    shared memory rather than the tensor cores bounds both passes. wgmma,
//    which reads a B operand once per 4-warp group, is the next step.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "attention_bwd_tile.cuh"
#include "attention_mma.cuh"

namespace {

constexpr int kMmaRows = 64;      // keys (dK/dV) or queries (dQ) per block
constexpr int kMmaBlockK = 64;    // keys per streamed tile of the dQ pass

// LSE in log2 units for exp2f, with +inf for a fully masked row (whose LSE
// is -1e30) so that its P is exactly 0.
__device__ __forceinline__ float lse_log2(float lse) {
  return lse < kMaskedRowLse ? INFINITY : lse * kLog2e;
}

template <int kDPad, int kBlockQ>
constexpr size_t smem_dkdv_mma() {
  return sizeof(bf16) * (2 * kMmaRows + 4 * kBlockQ) * (kDPad + 8) +
         sizeof(float) * (4 * kBlockQ + kDPad);
}

template <int kDPad>
constexpr size_t smem_dq_mma() {
  return sizeof(bf16) * (2 * kMmaRows + 4 * kMmaBlockK) * (kDPad + 8) +
         sizeof(int) * 2 * kMmaBlockK;
}

// dK and dV of one (b, h, 64-key tile), over the query tiles of kBlockQ
// rows from the first one that sees the key tile under causal masking.
template <int kDPad, int kBlockQ>
__global__ void __launch_bounds__(kMmaThreads)
flash_attention_bwd_dkdv_mma_kernel(const Params p) {
  constexpr int ld = kDPad + 8;
  // queries per sub-step: S^T and dP^T of 16 keys x kSubQ queries live in
  // registers beside the dK and dV accumulators; 16 keeps the pass at three
  // blocks per SM at D = 64, where wider sub-steps held more registers and
  // ran slower
  constexpr int kSubQ = 16;
  constexpr int kNQ = kSubQ / 8;    // n8 tiles of S^T per warp and sub-step
  constexpr int kND = kDPad / 8;    // n8 tiles of dK, dV per warp
  extern __shared__ __align__(16) unsigned char mma_smem[];
  bf16* ks = reinterpret_cast<bf16*>(mma_smem);  // [64][ld]
  bf16* vs = ks + kMmaRows * ld;                 // [64][ld]
  bf16* qs = vs + kMmaRows * ld;                 // [2][kBlockQ][ld]
  bf16* dos = qs + 2 * kBlockQ * ld;             // [2][kBlockQ][ld]
  float* lse_s = reinterpret_cast<float*>(dos + 2 * kBlockQ * ld);  // [2][kBlockQ]
  float* delta_s = lse_s + 2 * kBlockQ;                             // [2][kBlockQ]
  float* masked_dv = delta_s + 2 * kBlockQ;                         // [kDPad]

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int k0 = blockIdx.x * kMmaRows;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int D = p.D;
  const bf16* q = static_cast<const bf16*>(p.q) + b * p.q_sb + h * p.q_sh;
  const bf16* k = static_cast<const bf16*>(p.k) + b * p.k_sb + h * p.k_sh;
  const bf16* v = static_cast<const bf16*>(p.v) + b * p.v_sb + h * p.v_sh;
  const bf16* dout = static_cast<const bf16*>(p.dout) + b * p.do_sb + h * p.do_sh;
  const int32_t* mask = p.mask + b * p.m_sb;
  const int64_t stat0 = (static_cast<int64_t>(b) * p.H + h) * p.Sq;

  const int kv_valid = min(kMmaRows, p.Skv - k0);
  load_tile_async<kMmaRows, kDPad>(ks, k + k0 * p.k_ss, p.k_ss, kv_valid, D);
  load_tile_async<kMmaRows, kDPad>(vs, v + k0 * p.v_ss, p.v_ss, kv_valid, D);

  // The two keys of this thread's accumulator rows (g and g + 8 of its
  // warp's 16), and whether the mask and Skv let any row see them.
  const int key_lo = k0 + warp * 16 + (lane >> 2);
  const int key_hi = key_lo + 8;
  const bool vis_lo = key_lo < p.Skv && mask[key_lo] != 0;
  const bool vis_hi = key_hi < p.Skv && mask[key_hi] != 0;

  // Rows before k0 - q_offset see none of these keys under causal masking
  // (and give them P = 0), so the walk starts at the tile holding that row.
  const int q_begin = p.causal ? max(0, k0 - p.q_offset) / kBlockQ * kBlockQ : 0;
  const int n_tiles = q_begin < p.Sq ? (p.Sq - q_begin + kBlockQ - 1) / kBlockQ : 0;

  // Starts the loads of query tile q0 (Q, dO, LSE, delta) into `stage`.
  auto load_q_tile = [&](int q0, int stage) {
    const int q_valid = min(kBlockQ, p.Sq - q0);
    load_tile_async<kBlockQ, kDPad>(qs + stage * kBlockQ * ld, q + q0 * p.q_ss, p.q_ss,
                                    q_valid, D);
    load_tile_async<kBlockQ, kDPad>(dos + stage * kBlockQ * ld, dout + q0 * p.do_ss,
                                    p.do_ss, q_valid, D);
    if (tid < kBlockQ) {
      const bool ok = tid < q_valid;
      const int64_t at = stat0 + (ok ? q0 + tid : 0);
      cp_async_4(lse_s + stage * kBlockQ + tid, p.lse + at, ok);
      cp_async_4(delta_s + stage * kBlockQ + tid, p.row_delta + at, ok);
    }
  };

  if (n_tiles > 0) load_q_tile(q_begin, 0);
  cp_async_commit();

  float dk_acc[kND][4], dv_acc[kND][4];
#pragma unroll
  for (int j = 0; j < kND; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      dk_acc[j][e] = 0.f;
      dv_acc[j][e] = 0.f;
    }
  const float scale_log2 = p.scale * kLog2e;

  for (int it = 0; it < n_tiles; ++it) {
    const int q0 = q_begin + it * kBlockQ;
    const int stage = it & 1;
    if (it + 1 < n_tiles) load_q_tile(q0 + kBlockQ, stage ^ 1);
    cp_async_commit();
    cp_async_wait<1>();  // this tile (and K/V) has landed
    __syncthreads();
    const bf16* qt = qs + stage * kBlockQ * ld;
    const bf16* dot = dos + stage * kBlockQ * ld;
    const float* lt = lse_s + stage * kBlockQ;
    const float* dt = delta_s + stage * kBlockQ;

    // kSubQ queries at a time: S^T = K Q^T and dP^T = V dO^T for this
    // warp's 16 keys, then P^T and dS^T, then their dV and dK products.
#pragma unroll
    for (int q_sub = 0; q_sub < kBlockQ; q_sub += kSubQ) {
      float s[kNQ][4], dp[kNQ][4];
#pragma unroll
      for (int j = 0; j < kNQ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s[j][e] = 0.f;
          dp[j][e] = 0.f;
        }
#pragma unroll
      for (int kk = 0; kk < kDPad / 16; ++kk) {
        uint32_t ak[4], av[4];
        ldsm_x4(ak, frag_a(ks, ld, warp * 16, kk * 16, lane));
        ldsm_x4(av, frag_a(vs, ld, warp * 16, kk * 16, lane));
#pragma unroll
        for (int nj = 0; nj < kSubQ / 16; ++nj) {
          uint32_t bq[4], bo[4];
          ldsm_x4(bq, frag_b(qt, ld, q_sub + nj * 16, kk * 16, lane));
          ldsm_x4(bo, frag_b(dot, ld, q_sub + nj * 16, kk * 16, lane));
          mma_bf16(s[2 * nj], ak, bq[0], bq[1]);
          mma_bf16(s[2 * nj + 1], ak, bq[2], bq[3]);
          mma_bf16(dp[2 * nj], av, bo[0], bo[1]);
          mma_bf16(dp[2 * nj + 1], av, bo[2], bo[3]);
        }
      }

      // P^T and dS^T in registers, rounded to bf16 as A fragments.
      uint32_t pa[kSubQ / 16][4], dsa[kSubQ / 16][4];
#pragma unroll
      for (int j = 0; j < kNQ; ++j) {
        float pv[4], dsv[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int qi = q_sub + 8 * j + 2 * (lane & 3) + (e & 1);
          const int row = q0 + qi;
          const int key = e < 2 ? key_lo : key_hi;
          const bool vis = (e < 2 ? vis_lo : vis_hi) && row < p.Sq &&
                           !(p.causal && key > row + p.q_offset);
          pv[e] = vis ? exp2f(s[j][e] * scale_log2 - lse_log2(lt[qi])) : 0.f;
          dsv[e] = pv[e] * (dp[j][e] - dt[qi]) * p.scale;
        }
        to_a_frag(pa, j, pv);
        to_a_frag(dsa, j, dsv);
      }

      // dV += P^T dO and dK += dS^T Q: dO and Q read k-major, transposed.
#pragma unroll
      for (int kc = 0; kc < kSubQ / 16; ++kc)
#pragma unroll
        for (int nd = 0; nd < kDPad / 16; ++nd) {
          uint32_t bo[4], bq[4];
          ldsm_x4_t(bo, frag_a(dot, ld, q_sub + kc * 16, nd * 16, lane));
          ldsm_x4_t(bq, frag_a(qt, ld, q_sub + kc * 16, nd * 16, lane));
          mma_bf16(dv_acc[2 * nd], pa[kc], bo[0], bo[1]);
          mma_bf16(dv_acc[2 * nd + 1], pa[kc], bo[2], bo[3]);
          mma_bf16(dk_acc[2 * nd], dsa[kc], bq[0], bq[1]);
          mma_bf16(dk_acc[2 * nd + 1], dsa[kc], bq[2], bq[3]);
        }
    }
    __syncthreads();  // this stage is read; the next prefetch reuses it
  }
  cp_async_wait<0>();

  // Each fully masked row adds dO / Skv to the dv of every real key,
  // causally hidden ones included (its P is 1/Skv everywhere). Past
  // D = 128 a thread sums two columns.
  for (int col = tid; col < kDPad; col += kMmaThreads) {
    float sum = 0.f;
    if (col < D) {
      const float* part =
          p.masked_dout_sum + (static_cast<int64_t>(b) * p.H + h) * p.n_chunks * D + col;
      for (int c = 0; c < p.n_chunks; ++c) sum += part[c * D];
    }
    masked_dv[col] = sum / p.Skv;
  }
  __syncthreads();

  bf16* dk = static_cast<bf16*>(p.dk) + b * p.dk_sb + h * p.dk_sh;
  bf16* dv = static_cast<bf16*>(p.dv) + b * p.dv_sb + h * p.dv_sh;
#pragma unroll
  for (int j = 0; j < kND; ++j) {
    const int d = 8 * j + 2 * (lane & 3);
    if (d >= D) continue;
    const float m0 = masked_dv[d], m1 = masked_dv[d + 1];
    if (key_lo < p.Skv) {
      store_bf16x2(dk + key_lo * p.dk_ss + d, dk_acc[j][0], dk_acc[j][1]);
      store_bf16x2(dv + key_lo * p.dv_ss + d, dv_acc[j][0] + m0, dv_acc[j][1] + m1);
    }
    if (key_hi < p.Skv) {
      store_bf16x2(dk + key_hi * p.dk_ss + d, dk_acc[j][2], dk_acc[j][3]);
      store_bf16x2(dv + key_hi * p.dv_ss + d, dv_acc[j][2] + m0, dv_acc[j][3] + m1);
    }
  }
}

// dQ of one (b, h, 64-query tile), over the 64-key tiles up to its last
// row's diagonal: past it every key is causally hidden and dS is 0.
template <int kDPad>
__global__ void __launch_bounds__(kMmaThreads)
flash_attention_bwd_dq_mma_kernel(const Params p) {
  constexpr int ld = kDPad + 8;
  constexpr int kNK = kMmaBlockK / 8;  // n8 tiles of S per warp
  constexpr int kND = kDPad / 8;       // n8 tiles of dQ per warp
  extern __shared__ __align__(16) unsigned char mma_smem[];
  bf16* qs = reinterpret_cast<bf16*>(mma_smem);  // [64][ld]
  bf16* dos = qs + kMmaRows * ld;                // [64][ld]
  bf16* ks = dos + kMmaRows * ld;                // [2][64][ld]
  bf16* vs = ks + 2 * kMmaBlockK * ld;           // [2][64][ld]
  int* key_ok = reinterpret_cast<int*>(vs + 2 * kMmaBlockK * ld);  // [2][64]

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int q0 = blockIdx.x * kMmaRows;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int D = p.D;
  const bf16* q = static_cast<const bf16*>(p.q) + b * p.q_sb + h * p.q_sh;
  const bf16* k = static_cast<const bf16*>(p.k) + b * p.k_sb + h * p.k_sh;
  const bf16* v = static_cast<const bf16*>(p.v) + b * p.v_sb + h * p.v_sh;
  const bf16* dout = static_cast<const bf16*>(p.dout) + b * p.do_sb + h * p.do_sh;
  const int32_t* mask = p.mask + b * p.m_sb;
  const int64_t stat0 = (static_cast<int64_t>(b) * p.H + h) * p.Sq;

  const int q_valid = min(kMmaRows, p.Sq - q0);
  load_tile_async<kMmaRows, kDPad>(qs, q + q0 * p.q_ss, p.q_ss, q_valid, D);
  load_tile_async<kMmaRows, kDPad>(dos, dout + q0 * p.do_ss, p.do_ss, q_valid, D);

  // The two rows of this thread's accumulators: LSE (log2 units, +inf for
  // a fully masked row or one past Sq, so P = 0) and delta.
  const int row_lo = q0 + warp * 16 + (lane >> 2);
  const int row_hi = row_lo + 8;
  const float lse_lo = row_lo < p.Sq ? lse_log2(p.lse[stat0 + row_lo]) : INFINITY;
  const float lse_hi = row_hi < p.Sq ? lse_log2(p.lse[stat0 + row_hi]) : INFINITY;
  const float delta_lo = row_lo < p.Sq ? p.row_delta[stat0 + row_lo] : 0.f;
  const float delta_hi = row_hi < p.Sq ? p.row_delta[stat0 + row_hi] : 0.f;

  const int kv_end = p.causal ? max(0, min(p.Skv, q0 + q_valid + p.q_offset)) : p.Skv;
  const int n_tiles = (kv_end + kMmaBlockK - 1) / kMmaBlockK;

  // Starts the loads of key tile k0 (K, V) into `stage` and writes its key
  // flags (1 where the mask keeps a key below Skv).
  auto load_k_tile = [&](int k0, int stage) {
    const int kv_valid = min(kMmaBlockK, p.Skv - k0);
    load_tile_async<kMmaBlockK, kDPad>(ks + stage * kMmaBlockK * ld, k + k0 * p.k_ss,
                                       p.k_ss, kv_valid, D);
    load_tile_async<kMmaBlockK, kDPad>(vs + stage * kMmaBlockK * ld, v + k0 * p.v_ss,
                                       p.v_ss, kv_valid, D);
    if (tid < kMmaBlockK) {
      key_ok[stage * kMmaBlockK + tid] = tid < kv_valid && mask[k0 + tid] != 0;
    }
  };

  if (n_tiles > 0) load_k_tile(0, 0);
  cp_async_commit();

  float dq_acc[kND][4];
#pragma unroll
  for (int j = 0; j < kND; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dq_acc[j][e] = 0.f;
  const float scale_log2 = p.scale * kLog2e;

  for (int it = 0; it < n_tiles; ++it) {
    const int k0 = it * kMmaBlockK;
    const int stage = it & 1;
    if (it + 1 < n_tiles) load_k_tile(k0 + kMmaBlockK, stage ^ 1);
    cp_async_commit();
    cp_async_wait<1>();  // this tile (and Q/dO) has landed
    __syncthreads();
    const bf16* kt = ks + stage * kMmaBlockK * ld;
    const bf16* vt = vs + stage * kMmaBlockK * ld;
    const int* ok = key_ok + stage * kMmaBlockK;

    // S = Q K^T and dP = dO V^T for this warp's 16 rows.
    float s[kNK][4], dp[kNK][4];
#pragma unroll
    for (int j = 0; j < kNK; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[j][e] = 0.f;
        dp[j][e] = 0.f;
      }
#pragma unroll
    for (int kk = 0; kk < kDPad / 16; ++kk) {
      uint32_t aq[4], ao[4];
      ldsm_x4(aq, frag_a(qs, ld, warp * 16, kk * 16, lane));
      ldsm_x4(ao, frag_a(dos, ld, warp * 16, kk * 16, lane));
#pragma unroll
      for (int nj = 0; nj < kMmaBlockK / 16; ++nj) {
        uint32_t bk[4], bv[4];
        ldsm_x4(bk, frag_b(kt, ld, nj * 16, kk * 16, lane));
        ldsm_x4(bv, frag_b(vt, ld, nj * 16, kk * 16, lane));
        mma_bf16(s[2 * nj], aq, bk[0], bk[1]);
        mma_bf16(s[2 * nj + 1], aq, bk[2], bk[3]);
        mma_bf16(dp[2 * nj], ao, bv[0], bv[1]);
        mma_bf16(dp[2 * nj + 1], ao, bv[2], bv[3]);
      }
    }

    // dS in registers, rounded to bf16 as A fragments.
    uint32_t dsa[kMmaBlockK / 16][4];
#pragma unroll
    for (int j = 0; j < kNK; ++j) {
      float dsv[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int ki = 8 * j + 2 * (lane & 3) + (e & 1);
        const int key = k0 + ki;
        const int row = e < 2 ? row_lo : row_hi;
        const bool vis = ok[ki] && !(p.causal && key > row + p.q_offset);
        const float pv =
            vis ? exp2f(s[j][e] * scale_log2 - (e < 2 ? lse_lo : lse_hi)) : 0.f;
        dsv[e] = pv * (dp[j][e] - (e < 2 ? delta_lo : delta_hi)) * p.scale;
      }
      to_a_frag(dsa, j, dsv);
    }

    // dQ += dS K: K read k-major (rows = keys), transposed.
#pragma unroll
    for (int kc = 0; kc < kMmaBlockK / 16; ++kc)
#pragma unroll
      for (int nd = 0; nd < kDPad / 16; ++nd) {
        uint32_t bk[4];
        ldsm_x4_t(bk, frag_a(kt, ld, kc * 16, nd * 16, lane));
        mma_bf16(dq_acc[2 * nd], dsa[kc], bk[0], bk[1]);
        mma_bf16(dq_acc[2 * nd + 1], dsa[kc], bk[2], bk[3]);
      }
    __syncthreads();  // this stage is read; the next prefetch reuses it
  }
  cp_async_wait<0>();

  bf16* dq = static_cast<bf16*>(p.dq) + b * p.dq_sb + h * p.dq_sh;
#pragma unroll
  for (int j = 0; j < kND; ++j) {
    const int d = 8 * j + 2 * (lane & 3);
    if (d >= D) continue;
    if (row_lo < p.Sq) store_bf16x2(dq + row_lo * p.dq_ss + d, dq_acc[j][0], dq_acc[j][1]);
    if (row_hi < p.Sq) store_bf16x2(dq + row_hi * p.dq_ss + d, dq_acc[j][2], dq_acc[j][3]);
  }
}

// The dK/dV pass, then the dQ pass, for bf16 q/k/v/o/dO whose head dim D
// is at most kDPad (a multiple of 16), on the caller's stream.
template <int kDPad>
cudaError_t launch_grads_mma(const Params& p, cudaStream_t stream) {
  constexpr int kBlockQ = kDPad > 64 ? 32 : 64;
  const dim3 k_grid((p.Skv + kMmaRows - 1) / kMmaRows, p.H, p.B);
  const dim3 q_grid((p.Sq + kMmaRows - 1) / kMmaRows, p.H, p.B);
  const cudaError_t err = launch_mma(flash_attention_bwd_dkdv_mma_kernel<kDPad, kBlockQ>,
                                     k_grid, smem_dkdv_mma<kDPad, kBlockQ>(), p, stream);
  if (err != cudaSuccess) return err;
  return launch_mma(flash_attention_bwd_dq_mma_kernel<kDPad>, q_grid, smem_dq_mma<kDPad>(),
                    p, stream);
}

}  // namespace
