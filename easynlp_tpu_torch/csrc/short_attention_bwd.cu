// Whole-sequence attention backward for Hopper (sm_90a), plain CUDA C++.
//
// Replaces: easynlp_tpu/ops/attention.py::_short_bwd_kernel, the Pallas TPU
// kernel behind the custom VJP of attention(impl='short'). It computes the
// gradients of
//   O = softmax(Q K^T * scale, masked by kv_mask, optionally causal with
//       q_offset = Skv - Sq) V
// for Skv <= 512, with f32 scores, statistics and sums and dq/dk/dv in the
// input dtype (f32 or bf16):
//   P  = the forward's probabilities, recomputed from Q and K (masked keys
//        at the finite -1e30, keys past Skv at weight exactly 0)
//   dV = P^T dO,  dP = dO V^T,  delta = rowsum(dO * O)
//   dS = P * (dP - delta) * scale, ZEROED at every masked or causally hidden
//        key (the TPU kernel does not zero it, so a fully masked row gets a
//        nonzero dq/dk there; ROADMAP C7)
//   dQ = dS K,  dK = dS^T Q.
// That is jax.grad of attention_reference: a fully masked row gets dq = 0,
// gives no dk, and its dv is P^T dO with P uniform over the real keys. No
// route uses atomics: two runs give bit-identical gradients.
//
// What bounds it on this card: at the training path's shape (B=32, S=128,
// H=12, D=64, bf16) the gradients need 10*B*H*S*S*D = 4.0 GFLOP over about
// 50 MB of q/k/v/o/dO/dq/dk/dv, 80 FLOP per byte: below the bf16 tensor
// cores' ridge (~295), so device memory bounds it (0.015 ms at 3.35 TB/s).
//
// Three routes, chosen by the caller (ops/attention.py, by a rule on dtype
// and shape) through the dtype code:
//   1: bf16 with Sq, Skv <= 128 (BERT at S=128, BART's decoder): ONE launch,
//      one block of 8 warps per (b, h). Q, K, V and dO sit whole in shared
//      memory as bf16 tiles padded to D + 8 (cp.async, rows past Sq/Skv and
//      columns past D zero-filled), and delta is summed while they load,
//      two threads per row.
//      Each warp owns 16 keys: S^T = K Q^T on mma.sync m16n8k16 stays in its
//      accumulators; each query's max and sum over all keys come from the
//      warps' partial max and sum, exchanged through shared memory. Then,
//      16 queries at a time, dP^T = V dO^T, P^T and dS^T in registers, P^T
//      rounded to bf16 straight into the A fragments of dV += P^T dO, dS^T
//      rounded to bf16 into shared memory; dK = dS^T Q reads the warp's own
//      rows of it, and after one barrier each warp forms dQ = dS K for 16
//      queries, dS read through ldmatrix.trans. Nothing is recomputed and
//      each gradient is written once.
//   2: bf16 past 128 keys or queries (BERT at S=512): the flash backward's
//      tensor-core passes, which compute the same function: the tensor-core
//      forward (attention_fwd_mma.cuh) without O writes each row's LSE (a
//      fully masked row's -1e30 sentinel included), the flash pre-pass
//      writes delta and the masked rows' dO sums, then attention_bwd_mma.cuh's
//      dK/dV and dQ passes.
//   0: f32, any shape up to 512 keys: three launches on the CUDA cores,
//      f32 FMAs. Pass 1 (here), one block per (b, h, 32-query tile): the
//      row max m and 1/l = 1/sum(exp(s - m)) over all keys, and delta, m
//      and 1/l kept apart (not LSE = m + log l) so a fully masked row stays
//      right; passes 2 and 3 are attention_bwd_tile.cuh's dK/dV and dQ
//      walks, which the flash backward shares. It alone meets the f32
//      twin's 2e-5 bound.
// The bf16 routes round P and dS to bf16 before their products, as
// _short_bwd_kernel does (attention.py:539, :546). q/k/v/o/dO are read in
// place through (batch, seq, head) element strides (BERT's [B,S,H,D]
// projection views need no transpose copy) and dq/dk/dv are written with
// their own strides; the ragged edge is masked here, so nothing is padded.
//
// Built by easynlp_tpu_torch/kernels with
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// and called through ctypes (easynlp_tpu_torch/ops/attention.py).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "attention_bwd_mma.cuh"
#include "attention_bwd_tile.cuh"
#include "attention_fwd_mma.cuh"
#include "attention_mma.cuh"

namespace {

template <int kDPad>
constexpr size_t smem_stats() {
  return sizeof(float) * ((kBlockQ + kBlockK) * (kDPad + 1) + kBlockQ * kLdP);
}

// Pass 1 of the f32 route: row max, 1/sum of exp and delta for one
// (b, h, 32-query tile).
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

template <int kDPad>
cudaError_t launch_f32(const Params& p, cudaStream_t stream) {
  const dim3 q_grid((p.Sq + kBlockQ - 1) / kBlockQ, p.H, p.B);
  cudaError_t err = launch_one(short_attention_bwd_stats_kernel<float, kDPad>,
                               q_grid, smem_stats<kDPad>(), p, stream);
  if (err != cudaSuccess) return err;
  return launch_grads<float, kDPad, false>(p, stream);
}

// ---------------------------------------------------------------------------
// Route 1: bf16, Sq and Skv at most 128, one block per (b, h).

constexpr int kOneLen = 128;                  // query and key rows per block
constexpr int kOneWarps = kOneLen / 16;       // 8 warps of 16 keys (queries)
constexpr int kOneThreads = 32 * kOneWarps;   // 256
constexpr int kLdT = kOneLen + 8;             // row stride of the dS^T tile

// Q, K, V, dO [128][kDPad + 8] and dS^T [128][136] bf16 (the warps' partial
// row max and sum share dS^T's space before it is written), then the row
// max, 1/sum and delta per query and the key flags.
template <int kDPad>
constexpr size_t smem_one_block() {
  return sizeof(bf16) * (4 * kOneLen * (kDPad + 8) + kOneLen * kLdT) +
         sizeof(float) * 3 * kOneLen + sizeof(int) * kOneLen;
}
static_assert(sizeof(bf16) * kOneLen * kLdT >= sizeof(float) * 2 * kOneWarps * kOneLen,
              "the partial row statistics fit in the dS^T tile");

// Two blocks per SM where the head dim allows (at most 128 registers a
// thread): one block's loads overlap the other's products.
template <int kDPad>
__global__ void __launch_bounds__(kOneThreads, kDPad <= 64 ? 2 : 1)
short_attention_bwd_mma_kernel(const Params p) {
  constexpr int ld = kDPad + 8;
  constexpr int kNQ = kOneLen / 8;  // n8 tiles of S^T per warp (queries)
  constexpr int kND = kDPad / 8;    // n8 tiles of dK, dV, dQ per warp
  constexpr int kKC = kDPad / 16;   // k16 chunks over the head dim
  // V's A fragments stay in registers where the head dim leaves room
  constexpr bool kHoldV = kDPad <= 64;
  extern __shared__ __align__(16) unsigned char one_smem[];
  bf16* qs = reinterpret_cast<bf16*>(one_smem);  // [128][ld]
  bf16* ks = qs + kOneLen * ld;                  // [128][ld]
  bf16* vs = ks + kOneLen * ld;                  // [128][ld]
  bf16* dos = vs + kOneLen * ld;                 // [128][ld]
  bf16* dst = dos + kOneLen * ld;                // dS^T [128 keys][kLdT]
  float* part_m = reinterpret_cast<float*>(dst);       // [8 warps][128]
  float* part_l = part_m + kOneWarps * kOneLen;        // [8 warps][128]
  float* row_m = reinterpret_cast<float*>(dst + kOneLen * kLdT);  // [128]
  float* row_inv = row_m + kOneLen;                               // [128]
  float* delta_s = row_inv + kOneLen;                             // [128]
  int* key_ok = reinterpret_cast<int*>(delta_s + kOneLen);        // [128]

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int D = p.D;
  const bf16* q = static_cast<const bf16*>(p.q) + b * p.q_sb + h * p.q_sh;
  const bf16* k = static_cast<const bf16*>(p.k) + b * p.k_sb + h * p.k_sh;
  const bf16* v = static_cast<const bf16*>(p.v) + b * p.v_sb + h * p.v_sh;
  const bf16* o = static_cast<const bf16*>(p.o) + b * p.o_sb + h * p.o_sh;
  const bf16* dout = static_cast<const bf16*>(p.dout) + b * p.do_sb + h * p.do_sh;
  const int32_t* mask = p.mask + b * p.m_sb;

  load_tile_async<kOneLen, kDPad, kOneThreads>(qs, q, p.q_ss, p.Sq, D);
  load_tile_async<kOneLen, kDPad, kOneThreads>(ks, k, p.k_ss, p.Skv, D);
  load_tile_async<kOneLen, kDPad, kOneThreads>(vs, v, p.v_ss, p.Skv, D);
  load_tile_async<kOneLen, kDPad, kOneThreads>(dos, dout, p.do_ss, p.Sq, D);
  cp_async_commit();
  // While the copies fly: delta = rowsum(dO * O) in f32, two threads per
  // query row and 16 bytes a load, so every load of the block is in flight
  // at once; and the key flags (1 where the mask keeps a key below Skv).
  static_assert(kOneThreads == 2 * kOneLen, "two threads per query row");
  {
    const int row = tid >> 1;
    float acc = 0.f;
    if (row < p.Sq) {
#pragma unroll 4
      for (int c = (tid & 1) * 8; c < D; c += 16) {
        const uint4 x = *reinterpret_cast<const uint4*>(dout + row * p.do_ss + c);
        const uint4 y = *reinterpret_cast<const uint4*>(o + row * p.o_ss + c);
        const __nv_bfloat162* x2 = reinterpret_cast<const __nv_bfloat162*>(&x);
        const __nv_bfloat162* y2 = reinterpret_cast<const __nv_bfloat162*>(&y);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float2 xf = __bfloat1622float2(x2[e]);
          const float2 yf = __bfloat1622float2(y2[e]);
          acc = fmaf(xf.x, yf.x, acc);
          acc = fmaf(xf.y, yf.y, acc);
        }
      }
    }
    acc += __shfl_xor_sync(0xffffffffu, acc, 1);
    if ((tid & 1) == 0 && row < p.Sq) delta_s[row] = acc;
  }
  if (tid < kOneLen) key_ok[tid] = tid < p.Skv && mask[tid] != 0;
  cp_async_wait<0>();
  __syncthreads();

  const int n_kw = (p.Skv + 15) / 16;  // warps that own keys
  const int n_qc = (p.Sq + 15) / 16;   // 16-query chunks
  const bool has_keys = warp < n_kw;   // warp-uniform
  // the two keys of this thread's S^T accumulator rows
  const int key_lo = warp * 16 + (lane >> 2);
  const int key_hi = key_lo + 8;
  const float scale_log2 = p.scale * kLog2e;

  // S^T = K Q^T for this warp's 16 keys, masked, in log2 units: -inf past
  // Skv (weight exactly 0), the finite -1e30 where masked or causally
  // hidden. Each query's max and sum over the warp's keys go to part_m and
  // part_l.
  float s[kNQ][4];
  if (has_keys) {
#pragma unroll
    for (int j = 0; j < kNQ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < kKC; ++kk) {
      uint32_t ak[4];
      ldsm_x4(ak, frag_a(ks, ld, warp * 16, kk * 16, lane));
#pragma unroll
      for (int nj = 0; nj < kOneLen / 16; ++nj) {
        if (nj < n_qc) {  // a guard, not a break: the loop stays unrolled
          uint32_t bq[4];
          ldsm_x4(bq, frag_b(qs, ld, nj * 16, kk * 16, lane));
          mma_bf16(s[2 * nj], ak, bq[0], bq[1]);
          mma_bf16(s[2 * nj + 1], ak, bq[2], bq[3]);
        }
      }
    }
#pragma unroll
    for (int j = 0; j < kNQ; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qi = 8 * j + 2 * (lane & 3) + (e & 1);
        const int key = e < 2 ? key_lo : key_hi;
        float x;
        if (key >= p.Skv) {
          x = -INFINITY;
        } else if (!key_ok[key] || (p.causal && key > qi + p.q_offset)) {
          x = kNegInf;
        } else {
          x = s[j][e] * scale_log2;
        }
        s[j][e] = x;
      }
      // per query column c: keys g and g + 8 here, the warp's 16 across the
      // lanes that share lane & 3. The warp's first key is below Skv, so the
      // max is at least -1e30.
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        float mx = fmaxf(s[j][c], s[j][c + 2]);
#pragma unroll
        for (int off = 4; off < 32; off <<= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
        float sum = exp2f(s[j][c] - mx) + exp2f(s[j][c + 2] - mx);
#pragma unroll
        for (int off = 4; off < 32; off <<= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
        const int qi = 8 * j + 2 * (lane & 3) + c;
        if (lane < 4 && qi < p.Sq) {
          part_m[warp * kOneLen + qi] = mx;
          part_l[warp * kOneLen + qi] = sum;
        }
      }
    }
  }
  __syncthreads();
  // Each query's max and 1/sum over all keys. A fully masked query has max
  // -1e30 and weight 1 at each real key, so its P is 1/Skv there.
  if (tid < p.Sq) {
    float m = -INFINITY;
    for (int w = 0; w < n_kw; ++w) m = fmaxf(m, part_m[w * kOneLen + tid]);
    float l = 0.f;
    for (int w = 0; w < n_kw; ++w)
      l += part_l[w * kOneLen + tid] * exp2f(part_m[w * kOneLen + tid] - m);
    row_m[tid] = m;
    row_inv[tid] = 1.f / l;  // l >= 1: the max adds exp2(0)
  }
  __syncthreads();  // the partial statistics are read; dS^T may overwrite them

  bf16* dk = static_cast<bf16*>(p.dk) + b * p.dk_sb + h * p.dk_sh;
  bf16* dv = static_cast<bf16*>(p.dv) + b * p.dv_sb + h * p.dv_sh;
  if (has_keys) {
    uint32_t av[kHoldV ? kKC : 1][4];
    if (kHoldV) {
#pragma unroll
      for (int kk = 0; kk < kKC; ++kk) ldsm_x4(av[kk], frag_a(vs, ld, warp * 16, kk * 16, lane));
    }
    float dv_acc[kND][4];
#pragma unroll
    for (int j = 0; j < kND; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) dv_acc[j][e] = 0.f;

    // 16 queries at a time: dP^T = V dO^T, then P^T and dS^T, then dV.
#pragma unroll
    for (int c = 0; c < kOneLen / 16; ++c) {
      if (c >= n_qc) continue;
      float dp[2][4];
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) dp[j][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < kKC; ++kk) {
        if (!kHoldV) ldsm_x4(av[0], frag_a(vs, ld, warp * 16, kk * 16, lane));
        uint32_t bo[4];
        ldsm_x4(bo, frag_b(dos, ld, c * 16, kk * 16, lane));
        mma_bf16(dp[0], av[kHoldV ? kk : 0], bo[0], bo[1]);
        mma_bf16(dp[1], av[kHoldV ? kk : 0], bo[2], bo[3]);
      }
      uint32_t pa[1][4];
#pragma unroll
      for (int j2 = 0; j2 < 2; ++j2) {
        const int j = 2 * c + j2;
        float pv[4], dsv[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int qi = 8 * j + 2 * (lane & 3) + (e & 1);
          const int key = e < 2 ? key_lo : key_hi;
          const bool real = qi < p.Sq && key < p.Skv;
          pv[e] = real ? exp2f(s[j][e] - row_m[qi]) * row_inv[qi] : 0.f;
          const bool vis = real && key_ok[key] && !(p.causal && key > qi + p.q_offset);
          dsv[e] = vis ? pv[e] * (dp[j2][e] - delta_s[qi]) * p.scale : 0.f;
        }
        to_a_frag(pa, j2, pv);
        const int q_even = 8 * j + 2 * (lane & 3);
        store_bf16x2(dst + key_lo * kLdT + q_even, dsv[0], dsv[1]);
        store_bf16x2(dst + key_hi * kLdT + q_even, dsv[2], dsv[3]);
      }
      // dV += P^T dO: dO read k-major (rows = queries), transposed.
#pragma unroll
      for (int nd = 0; nd < kDPad / 16; ++nd) {
        uint32_t bo[4];
        ldsm_x4_t(bo, frag_a(dos, ld, c * 16, nd * 16, lane));
        mma_bf16(dv_acc[2 * nd], pa[0], bo[0], bo[1]);
        mma_bf16(dv_acc[2 * nd + 1], pa[0], bo[2], bo[3]);
      }
    }
#pragma unroll
    for (int j = 0; j < kND; ++j) {
      const int d = 8 * j + 2 * (lane & 3);
      if (d >= D) continue;
      if (key_lo < p.Skv) store_bf16x2(dv + key_lo * p.dv_ss + d, dv_acc[j][0], dv_acc[j][1]);
      if (key_hi < p.Skv) store_bf16x2(dv + key_hi * p.dv_ss + d, dv_acc[j][2], dv_acc[j][3]);
    }

    // dK = dS^T Q from this warp's own rows of dS^T; Q read k-major
    // (rows = queries), transposed.
    __syncwarp();
    float dk_acc[kND][4];
#pragma unroll
    for (int j = 0; j < kND; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) dk_acc[j][e] = 0.f;
#pragma unroll
    for (int kc = 0; kc < kOneLen / 16; ++kc) {
      if (kc >= n_qc) continue;
      uint32_t a[4];
      ldsm_x4(a, frag_a(dst, kLdT, warp * 16, kc * 16, lane));
#pragma unroll
      for (int nd = 0; nd < kDPad / 16; ++nd) {
        uint32_t bq[4];
        ldsm_x4_t(bq, frag_a(qs, ld, kc * 16, nd * 16, lane));
        mma_bf16(dk_acc[2 * nd], a, bq[0], bq[1]);
        mma_bf16(dk_acc[2 * nd + 1], a, bq[2], bq[3]);
      }
    }
#pragma unroll
    for (int j = 0; j < kND; ++j) {
      const int d = 8 * j + 2 * (lane & 3);
      if (d >= D) continue;
      if (key_lo < p.Skv) store_bf16x2(dk + key_lo * p.dk_ss + d, dk_acc[j][0], dk_acc[j][1]);
      if (key_hi < p.Skv) store_bf16x2(dk + key_hi * p.dk_ss + d, dk_acc[j][2], dk_acc[j][3]);
    }
  }
  __syncthreads();  // every warp's rows of dS^T are written

  // dQ = dS K for this warp's 16 queries: dS read from dS^T through
  // ldmatrix.trans, K k-major (rows = keys), transposed.
  if (warp < n_qc) {
    float dq_acc[kND][4];
#pragma unroll
    for (int j = 0; j < kND; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) dq_acc[j][e] = 0.f;
#pragma unroll
    for (int kc = 0; kc < kOneLen / 16; ++kc) {
      if (kc >= n_kw) continue;
      uint32_t a[4];
      ldsm_x4_t(a, frag_b(dst, kLdT, kc * 16, warp * 16, lane));
#pragma unroll
      for (int nd = 0; nd < kDPad / 16; ++nd) {
        uint32_t bk[4];
        ldsm_x4_t(bk, frag_a(ks, ld, kc * 16, nd * 16, lane));
        mma_bf16(dq_acc[2 * nd], a, bk[0], bk[1]);
        mma_bf16(dq_acc[2 * nd + 1], a, bk[2], bk[3]);
      }
    }
    bf16* dq = static_cast<bf16*>(p.dq) + b * p.dq_sb + h * p.dq_sh;
    const int row_lo = warp * 16 + (lane >> 2);
    const int row_hi = row_lo + 8;
#pragma unroll
    for (int j = 0; j < kND; ++j) {
      const int d = 8 * j + 2 * (lane & 3);
      if (d >= D) continue;
      if (row_lo < p.Sq) store_bf16x2(dq + row_lo * p.dq_ss + d, dq_acc[j][0], dq_acc[j][1]);
      if (row_hi < p.Sq) store_bf16x2(dq + row_hi * p.dq_ss + d, dq_acc[j][2], dq_acc[j][3]);
    }
  }
}

// Route 2: bf16 past 128 keys or queries. The LSE pass (the tensor-core
// forward without O), the flash pre-pass, then the flash backward's
// tensor-core dK/dV and dQ passes.
template <int kDPad>
cudaError_t launch_bf16(const Params& p, const fwd::Params& lse_pass, int route,
                        cudaStream_t stream) {
  if (route == 1) {
    return launch_mma(short_attention_bwd_mma_kernel<kDPad>, dim3(p.H, p.B),
                      smem_one_block<kDPad>(), p, stream, kOneThreads);
  }
  cudaError_t err = fwd::launch_fwd_mma<kDPad, false>(lse_pass, stream);
  if (err != cudaSuccess) return err;
  err = launch_pre_pass<bf16>(p, stream);
  if (err != cudaSuccess) return err;
  return launch_grads_mma<kDPad>(p, stream);
}

cudaError_t launch_for_head_dim(const Params& p, const fwd::Params& lse_pass, int route,
                                cudaStream_t stream) {
  if (route == 0) {
    if (p.D <= 32) return launch_f32<32>(p, stream);
    if (p.D <= 64) return launch_f32<64>(p, stream);
    return launch_f32<128>(p, stream);
  }
  if (p.D <= 16) return launch_bf16<16>(p, lse_pass, route, stream);
  if (p.D <= 32) return launch_bf16<32>(p, lse_pass, route, stream);
  if (p.D <= 64) return launch_bf16<64>(p, lse_pass, route, stream);
  return launch_bf16<128>(p, lse_pass, route, stream);
}

}  // namespace

// dtype (the route): 0 = float32 on the CUDA cores; 1 = bfloat16, one
// tensor-core block per (b, h), Sq and Skv at most 128; 2 = bfloat16 through
// the flash backward's tensor-core passes. Strides are in elements; the
// last (D) dimension of every tensor is contiguous. m_sb is the mask's
// batch stride (0 broadcasts one row over the batch). stats is f32 scratch:
// route 0, 3 * B*H*Sq floats (row max, 1/sum, delta); route 2,
// B*H*(2*Sq + ceil(Sq/128)*D) (LSE, delta, the masked rows' dO sums);
// route 1 uses none.
// Returns a cudaError_t: 0 when every launch was accepted.
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
  const int64_t strides[24] = {q_sb,  q_ss,  q_sh,  k_sb,  k_ss,  k_sh,
                               v_sb,  v_ss,  v_sh,  o_sb,  o_ss,  o_sh,
                               do_sb, do_ss, do_sh, dq_sb, dq_ss, dq_sh,
                               dk_sb, dk_ss, dk_sh, dv_sb, dv_ss, dv_sh};
  Params p = {};
  if (Skv > 512 || dtype < 0 || dtype > 2 ||
      (dtype == 1 && (Sq > kOneLen || Skv > kOneLen)) ||
      !set_shapes(&p, B, H, Sq, Skv, D, strides, m_sb, causal, scale)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int64_t n_rows = static_cast<int64_t>(B) * H * Sq;
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
  fwd::Params lse_pass = {};
  if (dtype == 2) {
    // LSE, delta, then the masked rows' dO sums
    p.lse = stats;
    p.row_delta = stats + n_rows;
    p.n_chunks = (Sq + kPreRows - 1) / kPreRows;
    p.masked_dout_sum = stats + 2 * n_rows;
    fwd::make_params(&lse_pass, q, k, v, mask, nullptr, stats, B, H, Sq, Skv, D, strides,
                     m_sb, causal, scale);
  }
  return static_cast<int>(launch_for_head_dim(p, lse_pass, dtype, static_cast<cudaStream_t>(stream)));
}
