// The attention block with frozen weights, forward and dx backward, for
// Hopper (sm_90a), on already-normed x [B, N, D] with H heads of dh:
//
//   forward:  [q|k|v] = x [Wq|Wk|Wv] + [bq|bk|bv] -> T
//             cat = concat_h softmax(q_h k_h^T / sqrt(dh) + bias [+ causal]) v_h -> T
//             out = cat Wo + bo -> T
//   backward: q, k, v recomputed; the attention forward again for its
//             output o and each row's log-sum-exp; doh = g Wo^T -> T;
//             dq, dk, dv by the flash-attention backward;
//             dx = [dq|dk|dv] [Wq|Wk|Wv]^T -> T
//
// Replaces nextgen_uia_tpu/ops/fused_attention.py: the Pallas kernels
// _fwd_kernel (pallas_call in _fwd_impl, the forward of fused_attn_block)
// and _bwd_kernel (pallas_call in _bwd_rule, the backward that
// fused_attn_block and hybrid_attn_block share). Weights and biases are
// frozen: no weight gradients, as on the TPU. The key bias is added after
// the scale, the causal mask (-1e30 above the diagonal) after the bias.
//
// What bounds it on the H100: at the bench's shape ([64, 197, 768], 12
// heads) the forward is 4 projections (2 * 12608 * 768^2 * 4 = 59.5 GFLOP)
// plus attention (4 * 64 * 12 * 197^2 * 64 = 7.6 GFLOP), 0.068 ms at the
// bf16 peak against 0.012 ms for x, the weights and the output; the
// backward's dx needs 7 projections' and 2.5 attentions' worth (123 GFLOP,
// 0.125 ms). So operations bound both, the projections 85-89% of them.
//
// Design. The TPU kernel keeps a chunk of 8 images' q, k, v and one head's
// [N, N] scores in VMEM and loops the heads in the kernel, so q, k and v
// never reach HBM. Here every bf16 projection is one flat product on
// hopper_gemm.cuh's core (TMA ring, wgmma, W multicast over a cluster of
// two, persistent grid, TMA-store epilogue), and the attention is K7's
// wgmma kernels (nx_flash_attention, nx_flash_attention_bwd), which read
// their operands through strides. So every operand stays row-major, with
// no head-major layout anywhere:
// - q|k|v is one [B*N, 3D] buffer, token n of sequence b on row b*N + n,
//   head h of q, k, v at columns h*dh, D + h*dh, 2D + h*dh: K7 reads q, k
//   and v as views at element strides (sb, sh, sn) = (N*3D, dh, 3D),
//   offsets 0, D, 2D (ops/fused_attention.py::_packed_layout says the same
//   and the CPU tests hold it to the plain version's head split).
// - K7's backward takes one stride set for o, g, dq, dk and dv, so dq|dk|dv
//   is a second such buffer and o|doh a third (o at column 0, doh written
//   at column D by the GEMM with a leading dimension of 3D; columns 2D..
//   unused).
// - Every product runs flat over M = B*N rows (tiles cross sequences; at
//   the bench's 197 tokens 99 tiles of 128 rows for 12,608 rows, where a
//   per-sequence tile needed 128 for the same rows). The 3D-wide q/k/v
//   product takes 256-column tiles and a 3-stage ring, the D-wide ones
//   (o, doh, dx) 192 and 4, as K5 raw-x's forward and dx backward.
// Each output element is one thread's sum in a fixed order (no atomics, no
// split of K), so two calls are bitwise equal.
// q, k, v, o, doh and dq, dk, dv cross device memory (~58 MB per buffer at
// the bench's shape); keeping them on chip between the projection and the
// attention, as the TPU kernel does, is a later step. The recomputed
// forward in the backward costs a projection and an attention forward
// more than saving them, which is what the TPU kernel's structure does too.
// float32 runs the same layout on block_kernels.cuh's SIMT GEMM and K7's
// float32 kernels: the exact float32 check of the algorithm.

#include "block_products.cuh"

using namespace nx;

extern "C" {

// x, out [B*N, D] in `dtype`; wqkv_t [3D, D] = [Wq|Wk|Wv]^T and wo_t [D, D]
// = Wo^T in `dtype`; bqkv [3D] and bo [D] float32; key_bias [B, N] float32
// or null; scratch qkv [B*N, 3D] and cat [B*N, D] in `dtype`.
int nx_fused_attn_fwd(const void* x, const void* wqkv_t, const float* bqkv, const void* wo_t,
                      const float* bo, const float* key_bias, void* qkv, void* cat, void* out,
                      int dtype, int b, int n, int heads, int dh, int causal, float scale,
                      void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int m = b * n, d = heads * dh, ld = 3 * d;
  int err = project<256, 3>(x, d, wqkv_t, bqkv, qkv, ld, m, ld, d, dtype, s);
  if (err) return err;
  // the head concat [B, N, H, dh] is row-major [B*N, D]
  err = nx_flash_attention(qkv, col(qkv, d, dtype), col(qkv, 2 * d, dtype), cat, key_bias,
                           nullptr, dtype, b, heads, n, dh, n * ld, dh, ld, n * d, dh, d, causal,
                           scale, stream);
  if (err) return err;
  return project<192, 4>(cat, d, wo_t, bo, out, d, m, d, d, dtype, s);
}

// g, dx [B*N, D] in `dtype`; wqkv_t [3D, D], wqkv [D, 3D] and wo [D, D] (as
// stored) in `dtype`; scratch qkv, od (o | doh | unused) and dqkv [B*N, 3D]
// in `dtype`, lse and delta [B, H, N] float32.
int nx_fused_attn_bwd(const void* x, const void* wqkv_t, const float* bqkv, const void* wqkv,
                      const void* wo, const float* key_bias, const void* g, void* qkv, void* od,
                      float* lse, float* delta, void* dqkv, void* dx, int dtype, int b, int n,
                      int heads, int dh, int causal, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int m = b * n, d = heads * dh, ld = 3 * d;
  const int sb = n * ld, sh = dh, sn = ld;  // every [B*N, 3D] buffer's head strides
  int err = project<256, 3>(x, d, wqkv_t, bqkv, qkv, ld, m, ld, d, dtype, s);
  if (err) return err;
  const void* q = qkv;
  const void* k = col(qkv, d, dtype);
  const void* v = col(qkv, 2 * d, dtype);
  void* doh = col(od, d, dtype);
  err = nx_flash_attention(q, k, v, od, key_bias, lse, dtype, b, heads, n, dh, sb, sh, sn, sb, sh,
                           sn, causal, scale, stream);
  if (err) return err;
  if ((err = project<192, 4>(g, d, wo, nullptr, doh, ld, m, d, d, dtype, s))) return err;
  err = nx_flash_attention_bwd(q, k, v, od, doh, lse, key_bias, dqkv, col(dqkv, d, dtype),
                               col(dqkv, 2 * d, dtype), nullptr, delta, dtype, b, heads, n, dh,
                               sb, sh, sn, sb, sh, sn, causal, scale, stream);
  if (err) return err;
  return project<192, 4>(dqkv, ld, wqkv, nullptr, dx, d, m, d, ld, dtype, s);
}

}  // extern "C"
