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
// (batch, head, 32-query tile) and walks all of K/V in 64-key tiles with an
// online softmax (attention_fwd_tile.cuh, shared with the flash forward).
// Moving the two products onto the tensor cores (mma.sync, then wgmma with
// TMA) is the next step.
//
// Built by easynlp_tpu_torch/kernels with
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// and called through ctypes (easynlp_tpu_torch/ops/attention.py).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "attention_fwd_tile.cuh"

namespace {

template <typename T, int kDPad>
__global__ void __launch_bounds__(fwd::kThreads)
short_attention_fwd_kernel(const fwd::Params p) {
  extern __shared__ float smem[];
  const fwd::Tiles<kDPad> t(smem);
  float acc[4][kDPad / 16];
  fwd::begin<T>(p, t, acc);
  for (int k0 = 0; k0 < p.Skv; k0 += fwd::kBlockK) fwd::tile<T>(p, t, k0, acc);
  fwd::store_out<T>(p, t, acc);
}

template <typename T>
cudaError_t launch_for_head_dim(const fwd::Params& p, cudaStream_t stream) {
  if (p.D <= 32) return fwd::launch<32>(short_attention_fwd_kernel<T, 32>, p, stream);
  if (p.D <= 64) return fwd::launch<64>(short_attention_fwd_kernel<T, 64>, p, stream);
  return fwd::launch<128>(short_attention_fwd_kernel<T, 128>, p, stream);
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
  const int64_t strides[12] = {q_sb, q_ss, q_sh, k_sb, k_ss, k_sh,
                               v_sb, v_ss, v_sh, o_sb, o_ss, o_sh};
  fwd::Params p;
  if (Skv > 512 || !fwd::make_params(&p, q, k, v, mask, o, nullptr, B, H, Sq,
                                     Skv, D, strides, m_sb, causal, scale)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return static_cast<int>(launch_for_head_dim<float>(p, s));
  if (dtype == 1) {
    return static_cast<int>(launch_for_head_dim<__nv_bfloat16>(p, s));
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
