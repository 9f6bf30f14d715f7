// The bf16 flash attention forward on Hopper's tensor cores (sm_90a), which
// flash_attention_fwd.cu launches for every bf16 call, and
// short_attention_bwd.cu launches without O as the LSE pass of its bf16
// route past 128 keys. f32 inputs keep attention_fwd_tile.cuh's CUDA-core
// walk. Its per-warp tile step (MmaRows) and its ring walk (walk_keys) also
// carry short_attention_fwd.cu's bf16 kernel, so the two forwards give the
// same bits on the tiles both visit.
//
// Replaces: easynlp_tpu/ops/attention.py::_fwd_kernel (:127), the Pallas TPU
// kernel of _flash_fwd. The function is flash_attention_fwd.cu's: O and the
// f32 natural-log LSE of softmax(Q K^T * scale) V, masked keys at the finite
// -1e30 (a fully masked row averages V over the real Skv keys, LSE -1e30),
// keys past Skv at weight 0, q_offset = Skv - Sq applied directly. Like
// _fwd_kernel (attention.py:153-155) it sums the row's f32 probabilities
// into l and rounds P to V's dtype (bf16) before P V.
//
// What bounds it on this card: at BART-base's encoder (B=8, S=1024, H=12,
// D=64) the forward needs 4 * B*H*S*S*D = 25.8 GFLOP against ~50 MB of
// q/k/v/o, about 500 FLOP per byte: above the bf16 tensor cores' ridge
// (~295), so operations bound it, 0.026 ms at 989 TFLOP/s.
//
// What the design does about it (FlashAttention-2's forward on mma.sync):
//  - One block per (b, h, 64-query tile), 4 warps of 16 query rows. Q's A
//    fragments are read once through ldmatrix and stay in registers.
//  - K and V stream in 64-key tiles through a two-stage cp.async ring with
//    their key flags beside them: the next tile loads while this one
//    computes. Rows past Skv and columns past D (D = 8, 24, 40, ... padded
//    to the MMA depth, 16) are zero-filled by the copy's src-size 0 form.
//  - S = Q K^T takes K as the n-major B operand; the scores, scaled to log2
//    units, stay in the m16n8 accumulators. Each thread holds rows g and
//    g + 8 of its warp's 16, so the online softmax's row max and sum reduce
//    over the quad with two __shfl_xor_sync each; exp2f, no shared memory.
//  - P is rounded to bf16 straight into the A fragments of O += P V
//    (to_a_frag), and V is read through ldmatrix.trans. O, l and the max
//    stay f32 in registers; O is rounded to bf16 once, at the store.
//  - Causal masking: a block stops after its last row's diagonal, unless a
//    row (past Sq excluded) has seen no visible key; then the block walks on
//    over all Skv keys, so that row averages them as attention_reference
//    does. The rows' test is in registers, joined with __syncthreads_or.
//  - What remains: every warp reads each K and V tile through ldmatrix for
//    its own 16 rows, one ldmatrix.x4 per two MMAs; wgmma with TMA, which
//    reads a B operand once per warpgroup, is the next step.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "attention_fwd_tile.cuh"
#include "attention_mma.cuh"

namespace {
namespace fwd {

constexpr int kMmaRowsQ = 64;  // query rows per flash block, 16 per warp
constexpr int kMmaKeys = 64;   // keys per streamed tile

// Q, two stages of K and V (V only with O), two stages of key flags.
template <int kDPad, bool kWithOut>
constexpr size_t smem_fwd_mma() {
  return sizeof(bf16) * (kMmaRowsQ + (kWithOut ? 4 : 2) * kMmaKeys) * (kDPad + 8) +
         sizeof(int) * 2 * kMmaKeys;
}

// One warp's 16 query rows: the thread holds rows row_lo (16 w + lane / 4
// past the block's first row) and row_hi = row_lo + 8, Q's A fragments, its
// part of O (f32 m16n8 accumulators), each row's running max (log2 units;
// -inf before the first tile, -1e30 while the row has seen only masked
// keys) and the thread's part of the running sum.
template <int kDPad>
struct MmaRows {
  static constexpr int kKC = kDPad / 16;    // k16 chunks of Q K^T
  static constexpr int kND = kDPad / 8;     // n8 tiles of O
  static constexpr int kNK = kMmaKeys / 8;  // n8 tiles of S
  int row_lo, row_hi;
  uint32_t aq[kKC][4];
  float o[kND][4];
  float m_lo = -INFINITY, m_hi = -INFINITY, l_lo = 0.f, l_hi = 0.f;

  // qs: the block's Q tile [rows][kDPad + 8] in shared memory, row q0 first.
  __device__ __forceinline__ MmaRows(const bf16* qs, int q0, int warp, int lane)
      : row_lo(q0 + warp * 16 + (lane >> 2)), row_hi(row_lo + 8) {
#pragma unroll
    for (int kk = 0; kk < kKC; ++kk)
      ldsm_x4(aq[kk], frag_a(qs, kDPad + 8, warp * 16, kk * 16, lane));
#pragma unroll
    for (int j = 0; j < kND; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[j][e] = 0.f;
  }

  // Whether one of the thread's rows below Sq has seen no visible key.
  __device__ __forceinline__ bool unseen(int Sq) const {
    return (row_lo < Sq && m_lo <= kNegInf) || (row_hi < Sq && m_hi <= kNegInf);
  }

  // Key tile [k0, k0 + 64): kt, vt its K and V [64][kDPad + 8] in shared
  // memory, ok its key flags. S = Q K^T, masked, the online softmax update,
  // and (kWithOut) O += P V.
  template <bool kWithOut>
  __device__ __forceinline__ void tile(const Params& p, const bf16* kt, const bf16* vt,
                                       const int* ok, int k0, float scale_log2, int lane) {
    constexpr int ld = kDPad + 8;
    // S = Q K^T for this warp's 16 rows.
    float s[kNK][4];
#pragma unroll
    for (int j = 0; j < kNK; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < kKC; ++kk)
#pragma unroll
      for (int nj = 0; nj < kMmaKeys / 16; ++nj) {
        uint32_t bk[4];
        ldsm_x4(bk, frag_b(kt, ld, nj * 16, kk * 16, lane));
        mma_bf16(s[2 * nj], aq[kk], bk[0], bk[1]);
        mma_bf16(s[2 * nj + 1], aq[kk], bk[2], bk[3]);
      }

    // Masked scores in log2 units: -inf past Skv (weight exactly 0), the
    // finite -1e30 where masked or causally hidden; then the row max.
    float mx_lo = -INFINITY, mx_hi = -INFINITY;
#pragma unroll
    for (int j = 0; j < kNK; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int ki = 8 * j + 2 * (lane & 3) + (e & 1);
        const int key = k0 + ki;
        const int row = e < 2 ? row_lo : row_hi;
        float x;
        if (key >= p.Skv) {
          x = -INFINITY;
        } else if (!ok[ki] || (p.causal && key > row + p.q_offset)) {
          x = kNegInf;
        } else {
          x = s[j][e] * scale_log2;
        }
        s[j][e] = x;
        if (e < 2) {
          mx_lo = fmaxf(mx_lo, x);
        } else {
          mx_hi = fmaxf(mx_hi, x);
        }
      }
    // Key k0 is below Skv and scores at least -1e30, so the new max is
    // finite and exp2f(m_old - m_new) is 0 on the first tile.
    const float mn_lo = fmaxf(m_lo, quad_max(mx_lo));
    const float mn_hi = fmaxf(m_hi, quad_max(mx_hi));
    const float alpha_lo = exp2f(m_lo - mn_lo);
    const float alpha_hi = exp2f(m_hi - mn_hi);
    m_lo = mn_lo;
    m_hi = mn_hi;

    // P = exp2(x - m) in f32 for l, rounded to bf16 as A fragments of P V.
    uint32_t pa[kMmaKeys / 16][4];
    float sum_lo = 0.f, sum_hi = 0.f;
#pragma unroll
    for (int j = 0; j < kNK; ++j) {
      float pv[4];
      pv[0] = exp2f(s[j][0] - mn_lo);
      pv[1] = exp2f(s[j][1] - mn_lo);
      pv[2] = exp2f(s[j][2] - mn_hi);
      pv[3] = exp2f(s[j][3] - mn_hi);
      sum_lo += pv[0] + pv[1];
      sum_hi += pv[2] + pv[3];
      to_a_frag(pa, j, pv);
    }
    l_lo = l_lo * alpha_lo + sum_lo;
    l_hi = l_hi * alpha_hi + sum_hi;

    if (kWithOut) {
#pragma unroll
      for (int j = 0; j < kND; ++j) {
        o[j][0] *= alpha_lo;
        o[j][1] *= alpha_lo;
        o[j][2] *= alpha_hi;
        o[j][3] *= alpha_hi;
      }
      // O += P V: V read k-major (rows = keys), transposed.
#pragma unroll
      for (int kc = 0; kc < kMmaKeys / 16; ++kc)
#pragma unroll
        for (int nd = 0; nd < kDPad / 16; ++nd) {
          uint32_t bv[4];
          ldsm_x4_t(bv, frag_a(vt, ld, kc * 16, nd * 16, lane));
          mma_bf16(o[2 * nd], pa[kc], bv[0], bv[1]);
          mma_bf16(o[2 * nd + 1], pa[kc], bv[2], bv[3]);
        }
    }
  }

  // O = o / l in bf16 at the rows below Sq and the columns below D; l_lo,
  // l_hi are the rows' sums over the quad. Every stored row visited at
  // least one tile, so its l is >= 1 (its max adds exp2(0)).
  __device__ __forceinline__ void store_o(const Params& p, int b, int h, int lane,
                                          float l_lo_row, float l_hi_row) const {
    const float inv_lo = 1.f / l_lo_row;
    const float inv_hi = 1.f / l_hi_row;
    bf16* out = static_cast<bf16*>(p.o) + b * p.o_sb + h * p.o_sh;
#pragma unroll
    for (int j = 0; j < kND; ++j) {
      const int d = 8 * j + 2 * (lane & 3);
      if (d >= p.D) continue;
      if (row_lo < p.Sq) {
        store_bf16x2(out + row_lo * p.o_ss + d, o[j][0] * inv_lo, o[j][1] * inv_lo);
      }
      if (row_hi < p.Sq) {
        store_bf16x2(out + row_hi * p.o_ss + d, o[j][2] * inv_hi, o[j][3] * inv_hi);
      }
    }
  }
};

// A block's walk over its key tiles through a two-stage cp.async ring: K
// (and, kWithOut, V) tiles at ks and vs, [2][64][kDPad + 8] each. It visits
// the tiles below kv_end, past which no row of the block sees a key; then it
// walks on over the rest of Skv only while a row (past Sq excluded) has seen
// no visible key: attention_reference gives such a row the mean of V over
// all Skv keys, and for the other rows those keys score -1e30 and add
// exactly 0 (exp2(-1e30 - m) is 0, the rescale exp2(0) is 1). The rows'
// test is in registers, joined with __syncthreads_or. load(k0, stage)
// starts a tile's copies into `stage`; flags(k0, stage) gives its key flags
// (1 where the mask keeps a key below Skv); `loaded` says whether tile 0 is
// in flight already. Every thread of the block calls it.
template <int kDPad, bool kWithOut, typename Load, typename Flags>
__device__ __forceinline__ void walk_keys(const Params& p, MmaRows<kDPad>& r, const bf16* ks,
                                          const bf16* vs, int kv_end, bool loaded, Load load,
                                          Flags flags, int lane) {
  constexpr int kStage = kMmaKeys * (kDPad + 8);
  const float scale_log2 = p.scale * kLog2e;
  for (int it = 0, k0 = 0; k0 < p.Skv; ++it, k0 += kMmaKeys) {
    const int stage = it & 1;
    if (k0 >= kv_end) {
      if (!__syncthreads_or(r.unseen(p.Sq))) break;
      if (!loaded) {
        load(k0, stage);
        cp_async_commit();
      }
    }
    // Prefetch the next tile when it will be visited: before kv_end, or
    // anywhere once the block walks on past it.
    const int next = k0 + kMmaKeys;
    const bool prefetch = next < p.Skv && (next < kv_end || k0 >= kv_end);
    if (prefetch) load(next, stage ^ 1);
    cp_async_commit();
    cp_async_wait<1>();  // this tile has landed
    __syncthreads();
    r.template tile<kWithOut>(p, ks + stage * kStage, vs + stage * kStage, flags(k0, stage),
                              k0, scale_log2, lane);
    __syncthreads();  // this stage is read; the next prefetch reuses it
    loaded = prefetch;
  }
  cp_async_wait<0>();
}

// O (when kWithOut) and LSE of one (b, h, 64-query tile). p.q/k/v are bf16;
// p.o is bf16 and written only when kWithOut; p.lse is always written.
template <int kDPad, bool kWithOut>
__global__ void __launch_bounds__(kMmaThreads)
flash_attention_fwd_mma_kernel(const Params p) {
  constexpr int ld = kDPad + 8;
  extern __shared__ __align__(16) unsigned char fwd_mma_smem[];
  bf16* qs = reinterpret_cast<bf16*>(fwd_mma_smem);  // [64][ld]
  bf16* ks = qs + kMmaRowsQ * ld;                    // [2][64][ld]
  bf16* vs = ks + 2 * kMmaKeys * ld;                 // [2][64][ld] (kWithOut)
  int* key_ok = reinterpret_cast<int*>(vs + (kWithOut ? 2 * kMmaKeys * ld : 0));

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int q0 = blockIdx.x * kMmaRowsQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int D = p.D;
  const bf16* q = static_cast<const bf16*>(p.q) + b * p.q_sb + h * p.q_sh;
  const bf16* k = static_cast<const bf16*>(p.k) + b * p.k_sb + h * p.k_sh;
  const bf16* v = static_cast<const bf16*>(p.v) + b * p.v_sb + h * p.v_sh;
  const int32_t* mask = p.mask + b * p.m_sb;

  const int q_valid = min(kMmaRowsQ, p.Sq - q0);
  // Keys the block's rows can see: under causal masking, up to the last
  // row's diagonal (0 when every row has q + q_offset < 0).
  const int kv_end = p.causal ? max(0, min(p.Skv, q0 + q_valid + p.q_offset)) : p.Skv;

  // Starts the loads of key tile k0 (K, V) into `stage` and writes its key
  // flags (1 where the mask keeps a key below Skv).
  auto load_k_tile = [&](int k0, int stage) {
    const int kv_valid = min(kMmaKeys, p.Skv - k0);
    load_tile_async<kMmaKeys, kDPad>(ks + stage * kMmaKeys * ld, k + k0 * p.k_ss, p.k_ss,
                                     kv_valid, D);
    if (kWithOut) {
      load_tile_async<kMmaKeys, kDPad>(vs + stage * kMmaKeys * ld, v + k0 * p.v_ss,
                                       p.v_ss, kv_valid, D);
    }
    if (tid < kMmaKeys) key_ok[stage * kMmaKeys + tid] = tid < kv_valid && mask[k0 + tid] != 0;
  };

  load_tile_async<kMmaRowsQ, kDPad>(qs, q + q0 * p.q_ss, p.q_ss, q_valid, D);
  cp_async_commit();
  if (kv_end > 0) load_k_tile(0, 0);
  cp_async_commit();
  cp_async_wait<1>();  // Q has landed
  __syncthreads();
  MmaRows<kDPad> r(qs, q0, warp, lane);
  walk_keys<kDPad, kWithOut>(p, r, ks, vs, kv_end, kv_end > 0, load_k_tile,
                             [&](int, int stage) { return key_ok + stage * kMmaKeys; }, lane);

  // LSE = m ln 2 + log l; a row that saw only masked keys keeps -1e30
  // (-1e30 + log l rounds to it), the backward's sentinel.
  const float l_lo_row = quad_sum(r.l_lo);
  const float l_hi_row = quad_sum(r.l_hi);
  if (kWithOut) r.store_o(p, b, h, lane, l_lo_row, l_hi_row);
  if ((lane & 3) == 0) {
    const int64_t stat0 = (static_cast<int64_t>(b) * p.H + h) * p.Sq;
    if (r.row_lo < p.Sq) {
      p.lse[stat0 + r.row_lo] =
          (r.m_lo <= kNegInf ? kNegInf : r.m_lo * kLn2) + logf(l_lo_row);
    }
    if (r.row_hi < p.Sq) {
      p.lse[stat0 + r.row_hi] =
          (r.m_hi <= kNegInf ? kNegInf : r.m_hi * kLn2) + logf(l_hi_row);
    }
  }
}

// O (when kWithOut) and LSE for bf16 q/k/v whose head dim D is at most
// kDPad (a multiple of 16), on the caller's stream.
template <int kDPad, bool kWithOut>
cudaError_t launch_fwd_mma(const Params& p, cudaStream_t stream) {
  const dim3 grid((p.Sq + kMmaRowsQ - 1) / kMmaRowsQ, p.H, p.B);
  return launch_mma(flash_attention_fwd_mma_kernel<kDPad, kWithOut>, grid,
                    smem_fwd_mma<kDPad, kWithOut>(), p, stream);
}

template <bool kWithOut>
cudaError_t launch_fwd_mma_for_head_dim(const Params& p, cudaStream_t stream) {
  if (p.D <= 16) return launch_fwd_mma<16, kWithOut>(p, stream);
  if (p.D <= 32) return launch_fwd_mma<32, kWithOut>(p, stream);
  if (p.D <= 64) return launch_fwd_mma<64, kWithOut>(p, stream);
  return launch_fwd_mma<128, kWithOut>(p, stream);
}

}  // namespace fwd
}  // namespace
