// Blocked ("flash") attention forward for Hopper (sm_90a), plain CUDA C++.
//
// Replaces: easynlp_tpu/ops/attention.py::_fwd_kernel, the Pallas TPU kernel
// that _flash_fwd launches behind attention(impl='flash'). It computes the
// same function:
//   O   = softmax(Q K^T * scale, masked by kv_mask, optionally causal with
//         q_offset = Skv - Sq) V
//   LSE = log(sum(exp(masked scores)))  (f32, [B,H,Sq]; read by the flash
//         backward kernels, ROADMAP B4/B5)
// for any Skv, with f32 scores, statistics and accumulation and O in the
// input dtype (f32 or bf16; the bf16 tensor-core route rounds P to bf16
// before P V, as _fwd_kernel does). Masked scores take the JAX package's
// finite NEG_INF (-1e30); keys past Skv take weight exactly 0, so a query
// row whose keys are all masked averages V over the real Skv keys, as
// attention_reference does. (JAX pads K/V to the block size first and its
// padded zero keys join that average, ROADMAP C1; here nothing is padded.)
// In such a row every score is -1e30, so its LSE is -1e30 + log(Skv), which
// rounds to -1e30 in f32.
//
// What bounds it on this card: at BART-base's encoder (B=8, S=1024, H=12,
// D=64, bf16) it needs 4*B*H*S*S*D = 25.8 GFLOP over ~50 MB of q/k/v/o,
// about 500 FLOP per byte, above the H100's bf16 tensor-core ridge (~295):
// operations bound it. GPT-2 small's prefill (8 x 768, causal) is near the
// ridge. Its decode step (one query against a 896-slot cache) does 2 FLOP
// per byte of K/V read: device memory bounds it.
//
// Two routes, a rule on dtype:
//   bf16: attention_fwd_mma.cuh's tensor-core kernel (mma.sync m16n8k16,
//     64-query tiles, K/V streamed through a cp.async ring, the online
//     softmax in registers, P rounded to bf16 before P V as _fwd_kernel
//     rounds it; its head comment has the design), at every Sq: at GPT-2's
//     decode shape (8 x 1 x 896), where a 64-query tile holds one real row,
//     it still takes less time than the walk below did (PERF.md);
//   f32: the CUDA-core walk below (f32 FMAs over 32-query tiles, P kept
//     f32). It alone meets the f32 twin's 2e-5 bound.
// Both keep no score or probability outside the block, stream K/V in 64-key
// tiles with an online softmax (running max and sum per row), so Skv is
// unbounded. Under causal masking a block stops after the tile holding its
// last row's diagonal (as _fwd_kernel's loop bound does), unless one of its
// rows has seen no visible key by then (a fully masked row, or a row with
// q + q_offset < 0): such a row averages all Skv keys, so the block walks
// on. q_offset is applied directly, for Sq != Skv too (JAX falls back to
// XLA there, ROADMAP C2). q/k/v/o are read and written through (batch,
// seq, head) element strides, so GPT-2's fused-projection views and a
// per-layer [B,T,H,D] KV cache are read in place; the ragged edge is masked
// here, with no padding copy. A split-KV decode kernel is the next step.
//
// Built by easynlp_tpu_torch/kernels with
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// and called through ctypes (easynlp_tpu_torch/ops/attention.py).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "attention_fwd_mma.cuh"
#include "attention_fwd_tile.cuh"

namespace {

template <typename T, int kDPad>
__global__ void __launch_bounds__(fwd::kThreads)
flash_attention_fwd_kernel(const fwd::Params p) {
  extern __shared__ float smem[];
  const fwd::Tiles<kDPad> t(smem);
  float acc[4][kDPad / 16];
  const int q_rows = fwd::rows(p);
  fwd::begin<T>(p, t, acc);
  // Keys this block's rows can see: under causal masking, up to the last
  // row's diagonal (0 when every row has q + q_offset < 0).
  const int kv_end = p.causal
      ? max(0, min(p.Skv, fwd::first_row() + q_rows + p.q_offset))
      : p.Skv;
  for (int k0 = 0; k0 < p.Skv; k0 += fwd::kBlockK) {
    if (k0 >= kv_end) {
      // Every key from here on is causally hidden from every row. Walk on
      // only for a row that has seen no visible key yet (its max is still
      // -1e30, or -inf before the first tile): attention_reference gives it
      // the mean of V over all Skv keys. For the other rows these keys score
      // -1e30 and add exactly 0. The barrier also makes the last tile's
      // row maxima visible.
      const bool unseen = threadIdx.x < q_rows && t.row_max[threadIdx.x] <= kNegInf;
      if (!__syncthreads_or(unseen)) break;
    }
    fwd::tile<T>(p, t, k0, acc);
  }
  // Every row saw at least one tile: a row with a visible key sees it before
  // kv_end, and any other row walks all of Skv.
  fwd::store_out<T>(p, t, acc);
  if (threadIdx.x < q_rows) {
    const int64_t at = (static_cast<int64_t>(blockIdx.z) * p.H + blockIdx.y) * p.Sq +
                       fwd::first_row() + threadIdx.x;
    p.lse[at] = t.row_max[threadIdx.x] + logf(t.row_sum[threadIdx.x]);
  }
}

// f32: the CUDA-core walk, per padded head dim.
cudaError_t launch_f32(const fwd::Params& p, cudaStream_t stream) {
  if (p.D <= 32) return fwd::launch<32>(flash_attention_fwd_kernel<float, 32>, p, stream);
  if (p.D <= 64) return fwd::launch<64>(flash_attention_fwd_kernel<float, 64>, p, stream);
  return fwd::launch<128>(flash_attention_fwd_kernel<float, 128>, p, stream);
}

}  // namespace

// dtype: 0 = float32 (the CUDA-core walk), 1 = bfloat16 (the tensor
// cores). Strides are in elements; the last (D) dimension is contiguous.
// m_sb is the mask's batch stride (0 broadcasts one row over the batch).
// lse is a contiguous f32 [B,H,Sq]. Returns a cudaError_t: 0 when the
// launch was accepted.
extern "C" int easynlp_flash_attention_fwd(
    const void* q, const void* k, const void* v, const int32_t* mask, void* o,
    float* lse, int dtype, int B, int H, int Sq, int Skv, int D,
    int64_t q_sb, int64_t q_ss, int64_t q_sh,
    int64_t k_sb, int64_t k_ss, int64_t k_sh,
    int64_t v_sb, int64_t v_ss, int64_t v_sh,
    int64_t o_sb, int64_t o_ss, int64_t o_sh,
    int64_t m_sb, int causal, float scale, void* stream) {
  const int64_t strides[12] = {q_sb, q_ss, q_sh, k_sb, k_ss, k_sh,
                               v_sb, v_ss, v_sh, o_sb, o_ss, o_sh};
  fwd::Params p;
  if (!fwd::make_params(&p, q, k, v, mask, o, lse, B, H, Sq, Skv, D, strides,
                        m_sb, causal, scale)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return static_cast<int>(launch_f32(p, s));
  if (dtype == 1) {
    return static_cast<int>(fwd::launch_fwd_mma_for_head_dim<true>(p, s));
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
