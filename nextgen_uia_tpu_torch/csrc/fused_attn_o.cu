// Attention + o-projection + residual, forward and dq/dk/dv backward, for
// Hopper (sm_90a), pre-norm (no post-LN epilogue):
//
//   forward:  cat = concat_h softmax(q k^T / sqrt(dh) + bias) v -> T;
//             out = x + cat @ Wo + bo -> T
//   backward: doh = g @ Wo^T -> T; dq, dk, dv from the two attention
//             backward passes of block_kernels.cuh; d(x) = g (the wrapper
//             passes g through)
//
// Replaces nextgen_uia_tpu/ops/fused_attn_o.py::fused_attn_o_residual with
// post_ln=None: the Pallas kernels _fwd_kernel and _bwd_kernel. Wo and bo
// are frozen (no weight gradients, as on the TPU). Rounding points are that
// kernel's: P rounded to T before P v and P^T doh, ds rounded before ds k
// and ds^T q, doh and the head concat rounded to T.
//
// What bounds it on the H100: at the training shape ([32, 12, 197, 64],
// D = 768) the forward is 11.3 GFLOP (the o-projection 7.6, attention 3.8)
// and the backward ~17 GFLOP with the score recompute, against 50-70 MB of
// activations, so on paper both are memory-bound at ~15-21 us. The TPU
// kernel keeps a whole group of heads' [N, N] f32 scores in 32 MB of VMEM;
// one head's [197, 197] f32 P alone is 155 KB of the 227 KB a Hopper block
// may use. So nothing [N, N] is held: the forward computes each query row's
// scores and softmax in shared memory (as the whole-block kernel does), and
// the backward runs a dq pass over query tiles (which also writes each row's
// max, exp-sum and rowsum(dp * P)) and a dk/dv pass over key tiles that
// recomputes its columns of P from q, k and those statistics. Both passes
// run on SIMT cores in float32 with the head's K/V (or Q/doh) transposed in
// shared memory in T; this, not memory, is what bounds them today (a
// tensor-core attention backward is a later step). Tokens run unpadded
// (N = 197); keys >= n_real and the ragged query/key tiles are masked in
// the kernels, so padded keys get zero dk/dv and leak into no dq.
//
// Post-LN variant (nx_attn_o_postln_fwd), forward only: out = LN(x + cat @
// Wo + bo) -> T, eps 1e-12 for BERT. It replaces the same Pallas kernel with
// post_ln given (the epilogue of _fwd_kernel), which the frozen PubMedBERT
// text tower runs. The TPU kernel keeps the pre-LN sum in VMEM; here the
// o-projection's epilogue writes it to a float32 scratch (never rounded to
// T), and layernorm_rows reads it back and writes the output in T: one
// [M, D] float32 round trip (~200 MB at the text cache's [256, 256, 768]
// chunk, which L2 does not hold) in place of a fused row-LayerNorm epilogue,
// which a GEMM tile of 128 columns cannot do alone. The key-padding bias
// (-1e9 for padded keys) is added after the -1e30 of keys >= n_real, as on
// the TPU; a row whose keys are all padding gets equal scores and comes out
// finite. The TPU variant's backward is an XLA recomposition and is not
// ported: autograd reaching it on the card raises.

#include "block_kernels.cuh"

using namespace nx;

namespace {

QKV head_major_qkv(const void* q, const void* k, const void* v, int n, int heads, int dh) {
  return QKV{q, k, v, heads * n * dh, n * dh, dh};
}

}  // namespace

extern "C" {

// q, k, v [B, H, N, dh]; x, out [B*N, D]; key_bias [B, N] f32 or null;
// wo [D, D] (x's dtype); bo [D] f32; cat scratch [B*N, D]
int nx_attn_o_fwd(const void* q, const void* k, const void* v, const void* x,
                  const float* key_bias, const void* wo, const float* bo, void* cat, void* out,
                  int dtype, int b, int n, int heads, int dh, int n_real, float scale,
                  void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int m = b * n, d = heads * dh;
  const QKV in = head_major_qkv(q, k, v, n, heads, dh);
  cudaError_t err =
      dtype == BF16
          ? launch_attention<__nv_bfloat16>(in, key_bias, cat, b, n, heads, dh, n_real, scale, s)
          : launch_attention<float>(in, key_bias, cat, b, n, heads, dh, n_real, scale, s);
  if (err != cudaSuccess) return (int)err;
  const Epilogue epi{bo, x, dtype, nullptr, ACT_NONE, row_major(out), dtype};
  return (int)launch_gemm(row_major(cat), wo, dtype, false, epi, m, d, d, s);
}

// g [B*N, D] (x's dtype); doh scratch [B*N, D]; stats scratch [B, H, N, 3]
// f32; dq, dk, dv [B, H, N, dh]
int nx_attn_o_bwd(const void* q, const void* k, const void* v, const float* key_bias,
                  const void* wo, const void* g, void* doh, float* stats, void* dq, void* dk,
                  void* dv, int dtype, int b, int n, int heads, int dh, int n_real,
                  float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int m = b * n, d = heads * dh;
  const Epilogue epi{nullptr, nullptr, 0, nullptr, ACT_NONE, row_major(doh), dtype};
  cudaError_t err = launch_gemm(row_major(g), wo, dtype, true, epi, m, d, d, s);
  if (err != cudaSuccess) return (int)err;
  const QKV in = head_major_qkv(q, k, v, n, heads, dh);
  return (int)(dtype == BF16
                   ? launch_attention_bwd<__nv_bfloat16>(in, key_bias, doh, dq, dk, dv, stats,
                                                         b, n, heads, dh, n_real, scale, s)
                   : launch_attention_bwd<float>(in, key_bias, doh, dq, dk, dv, stats, b, n,
                                                 heads, dh, n_real, scale, s));
}

// as nx_attn_o_fwd, then out = LN(y32) -> T: gamma, beta [D] f32; y32
// scratch [B*N, D] f32
int nx_attn_o_postln_fwd(const void* q, const void* k, const void* v, const void* x,
                         const float* key_bias, const void* wo, const float* bo,
                         const float* gamma, const float* beta, void* cat, float* y32,
                         void* out, int dtype, int b, int n, int heads, int dh, int n_real,
                         float scale, float eps, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int m = b * n, d = heads * dh;
  const QKV in = head_major_qkv(q, k, v, n, heads, dh);
  cudaError_t err =
      dtype == BF16
          ? launch_attention<__nv_bfloat16>(in, key_bias, cat, b, n, heads, dh, n_real, scale, s)
          : launch_attention<float>(in, key_bias, cat, b, n, heads, dh, n_real, scale, s);
  if (err != cudaSuccess) return (int)err;
  const Epilogue epi{bo, x, dtype, nullptr, ACT_NONE, row_major(y32), F32};
  err = launch_gemm(row_major(cat), wo, dtype, false, epi, m, d, d, s);
  if (err != cudaSuccess) return (int)err;
  return (int)(dtype == BF16
                   ? launch_layernorm<float, __nv_bfloat16>(y32, gamma, beta, out, m, d, eps, s)
                   : launch_layernorm<float, float>(y32, gamma, beta, out, m, d, eps, s));
}

}  // extern "C"
