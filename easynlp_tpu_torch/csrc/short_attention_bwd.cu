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
//   pass 1 (here), one block per (b, h, 32-query tile): the row max m and
//     1/l = 1/sum(exp(s - m)) over all keys, and delta = rowsum(dO * O).
//     Keeping m and 1/l apart (not LSE = m + log l) keeps a fully masked
//     row right: there m = -1e30 and m + log l rounds back to -1e30 in f32.
//   pass 2, one block per (b, h, 64-key tile), dK and dV, and pass 3, one
//     block per (b, h, 32-query tile), dQ: the tile walks of
//     attention_bwd_tile.cuh, which the flash backward shares.
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

#include "attention_bwd_tile.cuh"

namespace {

template <int kDPad>
constexpr size_t smem_stats() {
  return sizeof(float) * ((kBlockQ + kBlockK) * (kDPad + 1) + kBlockQ * kLdP);
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

template <typename T, int kDPad>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  const dim3 q_grid((p.Sq + kBlockQ - 1) / kBlockQ, p.H, p.B);
  cudaError_t err = launch_one(short_attention_bwd_stats_kernel<T, kDPad>,
                               q_grid, smem_stats<kDPad>(), p, stream);
  if (err != cudaSuccess) return err;
  return launch_grads<T, kDPad, false>(p, stream);
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
  const int64_t strides[24] = {q_sb,  q_ss,  q_sh,  k_sb,  k_ss,  k_sh,
                               v_sb,  v_ss,  v_sh,  o_sb,  o_ss,  o_sh,
                               do_sb, do_ss, do_sh, dq_sb, dq_ss, dq_sh,
                               dk_sb, dk_ss, dk_sh, dv_sb, dv_ss, dv_sh};
  Params p = {};
  if (Skv > 512 ||
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
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return static_cast<int>(launch_for_head_dim<float>(p, s));
  if (dtype == 1) {
    return static_cast<int>(launch_for_head_dim<__nv_bfloat16>(p, s));
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
