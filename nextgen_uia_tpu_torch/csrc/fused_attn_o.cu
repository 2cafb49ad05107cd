// Attention + o-projection + residual, forward and dq/dk/dv backward, for
// Hopper (sm_90a), pre-norm (no post-LN epilogue), on head-major q, k, v
// [B, H, N, dh]:
//
//   forward:  cat = concat_h softmax(q k^T / sqrt(dh) + bias [+ causal]) v -> T;
//             out = x + cat @ Wo + bo -> T
//   backward: the attention forward again for its output o and each row's
//             log-sum-exp; doh = g @ Wo^T -> T; dq, dk, dv by the
//             flash-attention backward; d(x) = g (the wrapper passes g
//             through)
//
// Replaces nextgen_uia_tpu/ops/fused_attn_o.py::fused_attn_o_residual with
// post_ln=None: the Pallas kernels _fwd_kernel and _bwd_kernel. Wo and bo
// are frozen (no weight gradients, as on the TPU). Rounding points are that
// kernel's: P rounded to T before P v and P^T doh, ds rounded before ds k
// and ds^T q, the head concat and doh rounded to T, the sum x + cat Wo + bo
// in float32 rounded once. Keys >= n_real carry -1e30 in the float32 key
// bias the wrapper hands over (the JAX kernel's mask, added before the
// caller's bias there and beside it here: either sum is -1e30 in float32).
// With causal != 0 the keys after each query row are masked too (the JAX
// kernel's causal=True, the frozen CLIP text tower): K7's causal mode, in
// the forward, in the backward's recomputed forward and in its backward.
//
// What bounds it on the H100: at the bench step's shape ([64, 12, 197, 64],
// D = 768) the forward is the o-projection (2 * 12608 * 768^2 = 14.9 GFLOP)
// plus attention (4 * 64 * 12 * 197^2 * 64 = 7.6 GFLOP), 0.023 ms at the
// bf16 peak, against 0.029 ms for q, k, v, x and out (97 MB) at 3.35 TB/s;
// the backward is doh plus the attention forward and backward (~34 GFLOP,
// 0.034 ms) against q, k, v, g, dq, dk, dv (137 MB, 0.041 ms). So bytes
// bound both on paper, with operations close behind.
//
// Design. The TPU kernel keeps one image's heads, scores and the head
// concat in VMEM and runs the o-projection at full lane width. Here the
// attention is K7's wgmma kernels (nx_flash_attention,
// nx_flash_attention_bwd), which read every operand through element
// strides, and each bf16 product one call of hopper_gemm.cuh's core (TMA
// ring, wgmma, W multicast over a cluster of two, persistent grid):
// - forward: K7 reads the head-major q, k, v (strides H*N*dh, N*dh, dh) and
//   writes the head concat row-major [B*N, D] (strides N*D, dh, D), so the
//   o-projection is one flat product over the B*N tokens (tiles cross
//   sequences; 99 tiles of 128 rows at the bench's shape) whose staged
//   epilogue (hopper_gemm.cuh) adds bo and the bf16 residual x at the
//   output's own row and rounds once, on 128-column tiles in a 4-deep ring.
// - backward: K7's backward takes one stride set for o, g, dq, dk and dv,
//   and dq, dk, dv are head-major, so o (K7's forward again) and doh are
//   head-major too: the doh product reads g row-major and stores through
//   heads_matrix, which needs a tile per sequence (128 tiles at the bench's
//   shape, 29% more than flat; the product took 0.0355 ms against 0.0315
//   flat, tools/epilogue_bench.cu on an H100 80GB HBM3 at 700 W), at 192 x 4 as K11's
//   D-wide products. The recomputed forward (~0.065 ms) is what
//   the TPU kernel's structure costs too; saving o and the lse from the
//   forward would trade it for ~19 MB of memory per layer.
// Each output element is one thread's sum in a fixed order (no atomics), so
// two calls are bitwise equal. bf16 needs dh = 64 (K7's wgmma kernels) and
// D % 64 == 0 (the core); the wrapper refuses anything else. float32 runs
// the same dataflow on K7's float32 kernels and block_kernels.cuh's SIMT
// GEMM: the exact float32 check of the algorithm.
//
// Post-LN variant (nx_attn_o_postln_fwd), forward only: out = LN(x + cat @
// Wo + bo) -> T, eps 1e-12 for BERT. It replaces the same Pallas kernel with
// post_ln given (the epilogue of _fwd_kernel), which the frozen PubMedBERT
// text tower runs. It is K1 post-norm's attention half
// (block_products.cuh::attn_o_f32): K7 into the row-major concat, then the
// o-product whose staged epilogue adds bo and x and stores the pre-LN sum in
// float32 (never rounded to T), then layernorm_rows writes the output in T.
// The TPU kernel keeps that sum in VMEM; here it makes one [M, D] float32
// round trip (~200 MB at the text cache's [256, 256, 768] chunk, which L2
// does not hold) in place of a fused row-LayerNorm epilogue, which a GEMM
// tile of 128 columns cannot do alone. The caller's key-padding bias (-1e9
// for padded keys) reaches K7 with the -1e30 of keys >= n_real folded in, as
// the pre-norm variant's; a row whose keys are all padding gets equal scores
// and comes out finite. The TPU variant's backward is an XLA recomposition
// and is not ported: autograd reaching it on the card raises.

#include "block_products.cuh"

using namespace nx;

extern "C" {

// q, k, v [B, H, N, dh] at element strides (sb, sh, sn); x, out [B*N, D];
// key_bias [B, N] f32 (n_real folded in) or null; wo_t [D, D] = Wo^T and
// cat scratch [B*N, D], read by K7 at strides (csb, csh, csn), in x's
// dtype; bo [D] f32; causal 0 or 1
int nx_attn_o_fwd(const void* q, const void* k, const void* v, const void* x,
                  const float* key_bias, const void* wo_t, const float* bo, void* cat, void* out,
                  int dtype, int b, int n, int heads, int dh, int sb, int sh, int sn, int csb,
                  int csh, int csn, int causal, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int m = b * n, d = heads * dh;
  int err = nx_flash_attention(q, k, v, cat, key_bias, nullptr, dtype, b, heads, n, dh, sb, sh,
                               sn, csb, csh, csn, causal, scale, stream);
  if (err) return err;
  if (dtype == F32) {
    const Epilogue epi{bo, x, F32, nullptr, ACT_NONE, row_major(out), F32};
    return (int)launch_gemm(row_major(cat), wo_t, F32, true, epi, m, d, d, s);
  }
  if (dtype != BF16) return (int)cudaErrorInvalidValue;
  hopper::TmaMatrix ta, to;
  cudaError_t e = hopper::rows_matrix(ta, cat, 1, m, d, hopper::BM);
  if (e == cudaSuccess) e = hopper::rows_matrix(to, out, 1, m, d, 64);
  if (e != cudaSuccess) return (int)e;
  const hopper::BiasResidualEpilogue epi{bo, static_cast<const __nv_bfloat16*>(x), d};
  return (int)hopper::gemm<128, 4>(ta, wo_t, to, epi, 1, m, d, d, s);
}

// q, k, v as nx_attn_o_fwd; wo [D, D] (as stored) and g [B*N, D] in q's
// dtype; scratch o and doh [B, H, N, dh] (q's strides) in q's dtype, lse and
// delta [B, H, N] f32; dq, dk, dv [B, H, N, dh] at q's strides; causal as
// the forward's
int nx_attn_o_bwd(const void* q, const void* k, const void* v, const float* key_bias,
                  const void* wo, const void* g, void* o, void* doh, float* lse, float* delta,
                  void* dq, void* dk, void* dv, int dtype, int b, int n, int heads, int dh,
                  int sb, int sh, int sn, int causal, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int m = b * n, d = heads * dh;
  // o and doh take q's strides, and heads_matrix writes doh as a dense [B, H, N, dh]
  if (sb != heads * n * dh || sh != n * dh || sn != dh) return (int)cudaErrorInvalidValue;
  int err = nx_flash_attention(q, k, v, o, key_bias, lse, dtype, b, heads, n, dh, sb, sh, sn, sb,
                               sh, sn, causal, scale, stream);
  if (err) return err;
  if (dtype == F32) {
    const Epilogue epi{nullptr, nullptr, 0, nullptr, ACT_NONE,
                       head_major(doh, doh, doh, n, heads, dh), F32};
    err = (int)launch_gemm(row_major(g), wo, F32, true, epi, m, d, d, s);
  } else if (dtype == BF16) {
    // a tile per sequence: the head-major store's TMA box is one sequence's
    hopper::TmaMatrix ta, to;
    cudaError_t e = hopper::rows_matrix(ta, g, b, n, d, hopper::BM);
    if (e == cudaSuccess) e = hopper::heads_matrix(to, doh, doh, doh, b, n, heads, dh, 64);
    if (e == cudaSuccess) e = hopper::gemm<192, 4>(ta, wo, to, hopper::NoEpilogue{}, b, n, d, d, s);
    err = (int)e;
  } else {
    err = (int)cudaErrorInvalidValue;
  }
  if (err) return err;
  return nx_flash_attention_bwd(q, k, v, o, doh, lse, key_bias, dq, dk, dv, nullptr, delta, dtype,
                                b, heads, n, dh, sb, sh, sn, sb, sh, sn, causal, scale, stream);
}

// as nx_attn_o_fwd (q, k, v at strides (sb, sh, sn)), then out = LN(x +
// cat @ Wo + bo) -> T: gamma, beta [D] f32; y32 scratch [B*N, D] f32
int nx_attn_o_postln_fwd(const void* q, const void* k, const void* v, const void* x,
                         const float* key_bias, const void* wo_t, const float* bo,
                         const float* gamma, const float* beta, void* cat, float* y32,
                         void* out, int dtype, int b, int n, int heads, int dh, int sb, int sh,
                         int sn, float scale, float eps, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int err = attn_o_f32(q, k, v, sb, sh, sn, key_bias, 0, x, wo_t, bo, cat, y32, dtype, b,
                             n, heads, dh, scale, s);
  if (err) return err;
  return (int)layernorm_f32(y32, gamma, beta, out, b * n, heads * dh, eps, dtype, s);
}

}  // extern "C"
