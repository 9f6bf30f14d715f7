// Whole-sequence attention forward for Hopper (sm_90a), plain CUDA C++.
//
// Replaces: easynlp_tpu/ops/attention.py::_short_fwd_kernel, the Pallas TPU
// kernel behind attention(impl='short'). It computes the same function:
//   O = softmax(Q K^T * scale, masked by kv_mask, optionally causal with
//       q_offset = Skv - Sq) V
// for Skv <= 512, with f32 scores and f32 accumulation, and the output in
// the input dtype (f32 or bf16). Masked scores take the JAX package's finite
// NEG_INF (-1e30), so a query row whose keys are all masked averages V over
// the real Skv keys, as attention_reference does. No atomics: two runs give
// the same bits.
//
// What bounds it on this card: at the main path's shape (B=32, S=128, H=12,
// D=64, bf16) one call does 4*B*H*S*S*D = 1.6 GFLOP over about 25 MB of
// q/k/v/o, about 64 FLOP per byte: below the ~295 FLOP/B ridge of the
// H100's bf16 tensor cores, so device memory bounds it (0.0075 ms at
// 3.35 TB/s). With half the keys padding, as BERT's batches have, the work
// that is needed is about half that.
//
// Two kernels, chosen by the caller (ops/attention.py::_short_fwd_route, a
// rule on dtype) through the dtype code:
//   1: bf16, short_attention_fwd_mma_kernel, on the tensor cores (mma.sync
//      m16n8k16). It takes the flash forward's tile step and ring walk
//      (attention_fwd_mma.cuh: Q's A fragments in registers, S in the m16n8
//      accumulators in log2 units, the row max and sum reduced over the
//      quad, P rounded to bf16 straight into the A fragments of P V, V read
//      through ldmatrix.trans, O rounded to bf16 once at the store), so it
//      rounds where that kernel does and gives its bits on every tile it
//      visits. What is its own, for short sequences:
//      - Up to 64 query rows a block, 4 warps of 16, sized to Sq: Sq = 1 (a
//        decode step) launches one warp, not four. B=32 S=128 runs 768
//        blocks and B=8 S=512 also 768, four blocks per SM. Blocks of 128
//        rows (8 warps, two per SM), which read a (b, h)'s K/V from device
//        memory once at S <= 128, were slower at ragged lengths and no
//        faster at full ones on an H100 (PERF.md): the kernel is bound by
//        latency, not bytes, and smaller blocks balance rows of unequal
//        length and keep more loads in flight; the second read of K/V is an
//        L2 hit.
//      - bf16 tiles go from device memory to shared memory with cp.async, 16
//        bytes a thread, rows padded to D + 8 so ldmatrix is conflict-free,
//        the ragged edge zero-filled by the src-size 0 form; no f32 staging.
//        K and V stream in 64-key tiles through a two-stage ring: at Skv <=
//        128 both tiles are in flight at once, before the first product.
//      - Trailing padding is skipped. While Q and the first key tile load,
//        the block reads the mask once, keeps every key's flag in shared
//        memory, and finds the last key the mask keeps (a warp max, then one
//        pass over the warps' results). It walks only up to that key's tile
//        (and, under causal masking, up to its last row's diagonal): a key
//        tile past it is neither loaded nor multiplied. That is exact: a
//        hidden key's weight exp2(-1e30 - m) is 0 and the rescale exp2(0) is
//        1, so the flash forward, which walks every tile, gives the same
//        bits. A batch row whose keys are all masked, or a row that sees
//        none of them, walks on over every key (the walk's C1 rule).
//      - At most 128 registers a thread (four blocks per SM) up to D = 64.
//      What limits it now (PERF.md §6, an H100 at 700 W): at B=32 S=128 a
//      block's loads, products and store follow one another, and four
//      blocks an SM overlap them only in part, so it moves about two fifths
//      of the card's bytes rate; at B=8 S=512 it reaches about 100 TFLOP/s
//      on the needed work, where every warp reads each K and V tile through
//      ldmatrix for its own 16 rows (wgmma, ROADMAP queue B item 5).
//      Rounding: like the flash forward (and its f32 twin's algebra), the
//      unnormalised p = exp(s - m) is rounded to bf16 before P V, l sums the
//      f32 p, and O = P V / l. JAX's _short_fwd_kernel rounds the normalised
//      P instead (attention.py:527); the port follows its own f32 twin
//      (ROADMAP C3), and the bf16 bound is the flash forward's, 1e-5 +
//      2^-8 |o| + 2.5 x 2^-8 R (chip_smoke.py, FLASH_FWD_RSS_BF16).
//   0: f32, short_attention_fwd_kernel, on the CUDA cores: one block per
//      (b, h, 32-query tile) walks all of K/V in 64-key tiles with f32 FMAs
//      and an online softmax (attention_fwd_tile.cuh, shared with the flash
//      forward's f32 route). It alone meets the f32 twin's 2e-5 bound.
// Both read q/k/v in place through (batch, seq, head) element strides
// (BERT's [B,S,H,D] projection views need no transpose copy) and mask the
// ragged edge themselves (no padding copy).
//
// Built by easynlp_tpu_torch/kernels with
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// and called through ctypes (easynlp_tpu_torch/ops/attention.py).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "attention_fwd_mma.cuh"
#include "attention_fwd_tile.cuh"
#include "attention_mma.cuh"

namespace {

template <int kDPad>
__global__ void __launch_bounds__(fwd::kThreads)
short_attention_fwd_kernel(const fwd::Params p) {
  extern __shared__ float smem[];
  const fwd::Tiles<kDPad> t(smem);
  float acc[4][kDPad / 16];
  fwd::begin<float>(p, t, acc);
  for (int k0 = 0; k0 < p.Skv; k0 += fwd::kBlockK) fwd::tile<float>(p, t, k0, acc);
  fwd::store_out<float>(p, t, acc);
}

constexpr int kShortWarps = 4;  // 16 query rows each: 64 rows a block at most

// One (b, h, query block) of bf16 q/k/v; the block's 16 * blockDim.x / 32
// rows. Shared memory: Q [rows][kDPad + 8], two stages of K and V
// [64][kDPad + 8], every key's flag (Skv rounded up to 64).
template <int kDPad>
__global__ void __launch_bounds__(32 * kShortWarps, kDPad <= 64 ? 4 : 1)
short_attention_fwd_mma_kernel(const fwd::Params p) {
  constexpr int ld = kDPad + 8;
  constexpr int kKeys = fwd::kMmaKeys;
  extern __shared__ __align__(16) unsigned char short_fwd_smem[];
  __shared__ int warp_last[kShortWarps];
  const int threads = blockDim.x;
  const int rows = threads / 2;
  bf16* qs = reinterpret_cast<bf16*>(short_fwd_smem);           // [rows][ld]
  bf16* ks = qs + rows * ld;                                    // [2][64][ld]
  bf16* vs = ks + 2 * kKeys * ld;                               // [2][64][ld]
  int* key_ok = reinterpret_cast<int*>(vs + 2 * kKeys * ld);  // [Skv up to 64]

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int q0 = blockIdx.x * rows;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int D = p.D;
  const bf16* q = static_cast<const bf16*>(p.q) + b * p.q_sb + h * p.q_sh;
  const bf16* k = static_cast<const bf16*>(p.k) + b * p.k_sb + h * p.k_sh;
  const bf16* v = static_cast<const bf16*>(p.v) + b * p.v_sb + h * p.v_sh;
  const int32_t* mask = p.mask + b * p.m_sb;
  const int q_valid = min(rows, p.Sq - q0);

  auto load_k_tile = [&](int k0, int stage) {
    const int kv_valid = min(kKeys, p.Skv - k0);
    load_rows_async<kDPad>(ks + stage * kKeys * ld, k + k0 * p.k_ss, p.k_ss, kKeys, kv_valid,
                           D, threads);
    load_rows_async<kDPad>(vs + stage * kKeys * ld, v + k0 * p.v_ss, p.v_ss, kKeys, kv_valid,
                           D, threads);
  };
  load_rows_async<kDPad>(qs, q + q0 * p.q_ss, p.q_ss, rows, q_valid, D, threads);
  cp_async_commit();
  load_k_tile(0, 0);  // every block visits key tile 0 (walk_keys)
  cp_async_commit();

  // While the copies fly: every key's flag (1 where the mask keeps a key
  // below Skv) and the last key the mask keeps (-1 for none).
  const int n_keys = (p.Skv + kKeys - 1) / kKeys * kKeys;
  int last = -1;
  for (int i = tid; i < n_keys; i += threads) {
    const bool kept = i < p.Skv && mask[i] != 0;
    key_ok[i] = kept;
    if (kept) last = i;
  }
  last = __reduce_max_sync(0xffffffffu, last);
  if (lane == 0) warp_last[warp] = last;
  cp_async_wait<1>();  // Q has landed
  __syncthreads();
  for (int w = 0; w < threads / 32; ++w) last = max(last, warp_last[w]);
  // No row of the block sees a key at or past kv_end.
  int kv_end = last + 1;
  if (p.causal) kv_end = min(kv_end, max(0, q0 + q_valid + p.q_offset));

  fwd::MmaRows<kDPad> r(qs, q0, warp, lane);
  fwd::walk_keys<kDPad, true>(p, r, ks, vs, kv_end, true, load_k_tile,
                              [&](int k0, int) { return key_ok + k0; }, lane);
  r.store_o(p, b, h, lane, quad_sum(r.l_lo), quad_sum(r.l_hi));
}

template <int kDPad>
cudaError_t launch_f32(const fwd::Params& p, cudaStream_t stream) {
  return fwd::launch<kDPad>(short_attention_fwd_kernel<kDPad>, p, stream);
}

template <int kDPad>
cudaError_t launch_bf16(const fwd::Params& p, cudaStream_t stream) {
  const int warps = p.Sq > 16 * kShortWarps ? kShortWarps : (p.Sq + 15) / 16;
  const int rows = 16 * warps;
  const int n_keys = (p.Skv + fwd::kMmaKeys - 1) / fwd::kMmaKeys * fwd::kMmaKeys;
  const size_t smem =
      sizeof(bf16) * (rows + 4 * fwd::kMmaKeys) * (kDPad + 8) + sizeof(int) * n_keys;
  const dim3 grid((p.Sq + rows - 1) / rows, p.H, p.B);
  return launch_mma(short_attention_fwd_mma_kernel<kDPad>, grid, smem, p, stream, 32 * warps);
}

cudaError_t launch_for_head_dim(const fwd::Params& p, int dtype, cudaStream_t stream) {
  if (dtype == 0) {
    if (p.D <= 32) return launch_f32<32>(p, stream);
    if (p.D <= 64) return launch_f32<64>(p, stream);
    return launch_f32<128>(p, stream);
  }
  if (p.D <= 16) return launch_bf16<16>(p, stream);
  if (p.D <= 32) return launch_bf16<32>(p, stream);
  if (p.D <= 64) return launch_bf16<64>(p, stream);
  return launch_bf16<128>(p, stream);
}

}  // namespace

// dtype (the route): 0 = float32 on the CUDA cores, 1 = bfloat16 on the
// tensor cores. Strides are in elements; the last (D) dimension is
// contiguous. m_sb is the mask's batch stride (0 broadcasts one row over
// the batch). Returns a cudaError_t: 0 when the launch was accepted.
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
  if (Skv > 512 || dtype < 0 || dtype > 1 ||
      !fwd::make_params(&p, q, k, v, mask, o, nullptr, B, H, Sq, Skv, D, strides, m_sb,
                        causal, scale)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(launch_for_head_dim(p, dtype, static_cast<cudaStream_t>(stream)));
}
