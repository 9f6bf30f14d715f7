// Blocked ("flash") attention backward for Hopper (sm_90a), plain CUDA C++.
//
// Replaces: easynlp_tpu/ops/attention.py::_bwd_dkdv_kernel and
// ::_bwd_dq_kernel, the two Pallas TPU kernels that _flash_bwd launches
// behind the custom VJP of attention(impl='flash'). It computes the
// gradients of
//   O = softmax(Q K^T * scale, masked by kv_mask, optionally causal with
//       q_offset = Skv - Sq) V
// for any Skv, from q, k, v, the forward's O and its f32 LSE [B,H,Sq]
// (flash_attention_fwd.cu), with f32 scores, statistics and sums and
// dq/dk/dv in the input dtype (f32 or bf16; from bf16 inputs P and dS are
// rounded to bf16 once, as tensor-core operands):
//   P  = exp(s - LSE), masked keys at the finite -1e30, keys past Skv at 0
//   dV = P^T dO,  dP = dO V^T,  delta = rowsum(dO * O)
//   dS = P * (dP - delta) * scale, zeroed at every masked or causally
//        hidden key
//   dQ = dS K,  dK = dS^T Q.
// That is jax.grad of attention_reference, fully masked rows included: such
// a row (every key masked or causally hidden: a left pad, a padded encoder
// row, or a row with q + q_offset < 0) gets dq = 0, gives no dk, and adds
// dO / Skv to the dv of every real key. The TPU kernels form exp(s - LSE)
// there too, and with LSE = -1e30 that weighs every key 1 (ROADMAP C10);
// JAX also pads K/V to the block size first and falls back to XLA for
// causal Sq != Skv. Here nothing is padded and q_offset is applied directly.
//
// What bounds it on this card: BART-base's encoder self-attention backward
// (B=8, S=1024, H=12, D=64, bf16) needs 10*B*H*S*S*D = 64.4 GFLOP (Q K^T,
// dO V^T, dS^T Q, P^T dO and dS K, counted once each) over about 100 MB of
// q/k/v/o/dO/dq/dk/dv: ~640 FLOP per byte, above the bf16 tensor cores'
// ridge, so it is bound by operations.
//
// What the design does about it. On the TPU the grid runs in order, and
// each kernel keeps one block's accumulators in VMEM across a sequential
// grid dimension. Blocks on Hopper run in no order and nothing carries over
// between them, so the two kernels become loops inside blocks, with no
// atomics (two runs give the same bits), in three launches:
//   pre-pass (attention_bwd_tile.cuh, which the bf16 short backward past
//     128 keys runs too), one block per (b, h, 128-query chunk):
//     delta = rowsum(dO * O) per row, and the sum of dO over the chunk's
//     fully masked rows (LSE < -5e29), which the dK/dV pass turns into
//     their dv term;
//   dK/dV (the port of _bwd_dkdv_kernel), one block per (b, h, 64-key
//     tile), walking the query tiles from the first one that sees the key
//     tile under causal masking;
//   dQ (the port of _bwd_dq_kernel), one block per (b, h, query tile),
//     walking the key tiles up to its last row's diagonal.
// bf16 inputs take attention_bwd_mma.cuh's passes: mma.sync tensor-core
// products on bf16 tiles that cp.async streams through a two-stage ring,
// with P and dS kept in registers (its head comment has the design). f32
// inputs take attention_bwd_tile.cuh's f32-FMA walks on the CUDA cores,
// which short_attention_bwd.cu shares: they hold the f32 twin to 2e-5,
// which bf16 or TF32 tensor-core products cannot.
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

namespace {

// f32: the CUDA-core walks, per padded head dim.
template <int kDPad>
cudaError_t launch_f32(const Params& p, cudaStream_t stream) {
  const cudaError_t err = launch_pre_pass<float>(p, stream);
  if (err != cudaSuccess) return err;
  return launch_grads<float, kDPad, true>(p, stream);
}

// bf16: the tensor-core passes, the head dim zero-filled up to a multiple
// of the MMA depth (16).
template <int kDPad>
cudaError_t launch_bf16(const Params& p, cudaStream_t stream) {
  const cudaError_t err = launch_pre_pass<__nv_bfloat16>(p, stream);
  if (err != cudaSuccess) return err;
  return launch_grads_mma<kDPad>(p, stream);
}

cudaError_t launch_for_head_dim_f32(const Params& p, cudaStream_t stream) {
  if (p.D <= 32) return launch_f32<32>(p, stream);
  if (p.D <= 64) return launch_f32<64>(p, stream);
  return launch_f32<128>(p, stream);
}

cudaError_t launch_for_head_dim_bf16(const Params& p, cudaStream_t stream) {
  if (p.D <= 16) return launch_bf16<16>(p, stream);
  if (p.D <= 32) return launch_bf16<32>(p, stream);
  if (p.D <= 64) return launch_bf16<64>(p, stream);
  return launch_bf16<128>(p, stream);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Strides are in elements; the last (D)
// dimension of every tensor is contiguous. m_sb is the mask's batch stride
// (0 broadcasts one row over the batch). lse is the forward's contiguous f32
// [B,H,Sq]. scratch is f32 of B*H*Sq + B*H*ceil(Sq/128)*D floats (delta,
// then the masked rows' dO sums). Returns a cudaError_t: 0 when all three
// launches were accepted.
extern "C" int easynlp_flash_attention_bwd(
    const void* q, const void* k, const void* v, const int32_t* mask,
    const void* o, const void* dout, const float* lse, void* dq, void* dk,
    void* dv, float* scratch, int dtype, int B, int H, int Sq, int Skv, int D,
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
  if (!set_shapes(&p, B, H, Sq, Skv, D, strides, m_sb, causal, scale)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  p.q = q;
  p.k = k;
  p.v = v;
  p.mask = mask;
  p.o = o;
  p.dout = dout;
  p.dq = dq;
  p.dk = dk;
  p.dv = dv;
  p.lse = lse;
  p.n_chunks = (Sq + kPreRows - 1) / kPreRows;
  p.row_delta = scratch;
  p.masked_dout_sum = scratch + static_cast<int64_t>(B) * H * Sq;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return static_cast<int>(launch_for_head_dim_f32(p, s));
  if (dtype == 1) return static_cast<int>(launch_for_head_dim_bf16(p, s));
  return static_cast<int>(cudaErrorInvalidValue);
}
