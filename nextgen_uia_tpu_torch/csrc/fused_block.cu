// Pre-norm transformer block forward for Hopper (sm_90a), as a small family
// of kernels driven in order by ops/fused_block.py::fused_block_infer:
//
//   z   = LN1(x)                       layernorm_rows     (f32 stats) -> T
//   qkv = z @ [Wq|Wk|Wv] + b           gemm               -> T
//   cat = softmax(q k^T / sqrt(dh)) v  attention_kernel   (f32 scores) -> T
//   y32 = cat @ Wo + bo + x            gemm               -> f32 scratch
//   z2  = LN2(y32)                     layernorm_rows     -> T
//   h   = act(z2 @ W1 + b1)            gemm               -> T
//   out = h @ W2 + b2 + y32            gemm               -> T
//
// Replaces nextgen_uia_tpu/ops/fused_block.py::fused_block_infer (the Pallas
// kernel _fwd_kernel), pre-norm, with or without the causal mask (the CLIP
// text tower: 77 tokens, width 512, 8 heads, quick_gelu, run unpadded). The rounding points are
// that kernel's: z, q/k/v, the probabilities, the head concat, z2 and h are
// rounded to the storage type T; y32 and the fc2 accumulation stay float32
// and the output is rounded once.
//
// What bounds it on the H100: at the serving shape (B*N = 32*197 rows,
// D = 768, hidden 3072) the four products hold ~99% of the block's
// 2*M*12*D^2 + 4*B*H*N^2*dh operations, so the block is compute-bound. The
// TPU kernel keeps every weight matrix resident in 64 MB of VMEM; a Hopper
// block has 227 KB of shared memory (one [768,768] bf16 matrix is 1.2 MB),
// so the port streams weight tiles through shared memory per output tile and
// passes activations between launches through device memory (the 50 MB L2
// holds most of them at this size).
//
// Design: the kernels are block_kernels.cuh's, shared with the train path's
// split kernels. The bf16 product is a 128x128x32-tiled WMMA (mma.sync
// 16x16x16, float32 accumulation) kernel fed by a 3-stage cp.async ring, with
// the bias, exact-erf GELU or quick_gelu and an optional residual fused into
// its epilogue; float32 inputs take a 64x64 SIMT tile, so the float32 path
// stays exact float32 (no TF32). Attention runs one CTA per (image, head,
// 32-query tile) with that head's K (transposed) and V in shared memory in
// the storage type; each warp owns 4 query rows, so every K/V read feeds 4
// multiply-adds: scores and softmax in float32, keys >= n_real masked,
// key_bias added, attention on SIMT cores. The ragged edges (N = 197,
// M = 6304) are masked in the kernels; nothing is padded. Still simple: no
// TMA, no wgmma, no warp specialisation, attention off the tensor cores.
//
// Post-norm layout (BERT, layout="postnorm"), the same kernels in another
// order:
//
//   qkv = x @ [Wq|Wk|Wv] + b           gemm (raw x, no LayerNorm) -> T
//   cat = softmax(q k^T / sqrt(dh) + key bias) v                   -> T
//   s32 = cat @ Wo + bo + x            gemm               -> f32 scratch
//   y32 = LN_a(s32), z2 = y32 -> T     layernorm_rows_dual (f32 and T)
//   h   = act(z2 @ W1 + b1)            gemm               -> T
//   s32 = h @ W2 + b2 + y32            gemm               -> f32 scratch
//   out = LN_b(s32)                    layernorm_rows     -> T
//
// Rounding points are the Pallas kernel's post-norm branch, which differ
// from the three-kernel chain's: y32 stays float32 as the MLP's residual,
// and only its copy z2 that feeds fc1 is rounded. At the text cache's chunk
// ([256, 256, 768], 12 heads, hidden 3072) the block is ~0.98 TFLOP:
// compute-bound (~0.99 ms at the bf16 peak).

#include "block_kernels.cuh"

using namespace nx;

extern "C" {

const char* nx_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

// out[rows, cols] = LN(x) * gamma + beta; (x, out) dtypes: (bf16, bf16),
// (f32, bf16) or (f32, f32)
int nx_layernorm(const void* x, int x_dtype, const float* gamma, const float* beta,
                 void* out, int out_dtype, int rows, int cols, float eps, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_dtype == BF16 && out_dtype == BF16)
    return (int)launch_layernorm<__nv_bfloat16, __nv_bfloat16>(x, gamma, beta, out, rows,
                                                               cols, eps, s);
  if (x_dtype == F32 && out_dtype == BF16)
    return (int)launch_layernorm<float, __nv_bfloat16>(x, gamma, beta, out, rows, cols, eps,
                                                       s);
  if (x_dtype == F32 && out_dtype == F32)
    return (int)launch_layernorm<float, float>(x, gamma, beta, out, rows, cols, eps, s);
  return (int)cudaErrorInvalidValue;
}

// out32[rows, cols] = LN(x) * gamma + beta from float32 x, and (out_t not
// null) the same rounded to `dtype` in out_t
int nx_layernorm_dual(const float* x, const float* gamma, const float* beta, float* out32,
                      void* out_t, int dtype, int rows, int cols, float eps, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == BF16)
    return (int)launch_layernorm_dual<__nv_bfloat16>(x, gamma, beta, out32, out_t, rows, cols,
                                                     eps, s);
  if (dtype == F32)
    return (int)launch_layernorm_dual<float>(x, gamma, beta, out32, out_t, rows, cols, eps, s);
  return (int)cudaErrorInvalidValue;
}

// out[M, N] = act(a[M, K] @ w[K, N] + bias) (+ res); a and w share `dtype`;
// needs N % 64 == 0, K % 32 == 0, 16-byte aligned a and w
int nx_gemm(const void* a, const void* w, int dtype, const float* bias, const void* res,
            int res_dtype, void* out, int out_dtype, int act, int M, int N, int K,
            void* stream) {
  const Epilogue epi{bias, res, res_dtype, nullptr, act, row_major(out), out_dtype};
  return (int)launch_gemm(row_major(a), w, dtype, false, epi, M, N, K,
                          static_cast<cudaStream_t>(stream));
}

// out[B*N, H*dh] = per-head softmax(q k^T * scale + mask + key_bias) v over
// qkv[B*N, 3*H*dh] (q | k | v); key_bias [B, N] float32 or null; causal:
// keys after the query row masked (the CLIP text tower)
int nx_attention(const void* qkv, const float* key_bias, void* out, int dtype, int b,
                 int n, int heads, int dh, int n_real, int causal, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int d = heads * dh;
  const size_t t_size = dtype == BF16 ? 2 : 4;
  const char* base = static_cast<const char*>(qkv);
  const QKV in{base, base + d * t_size, base + 2 * d * t_size, n * 3 * d, dh, 3 * d};
  if (dtype == BF16)
    return (int)launch_attention<__nv_bfloat16>(in, key_bias, out, b, n, heads, dh, n_real,
                                                scale, s, causal);
  if (dtype == F32)
    return (int)launch_attention<float>(in, key_bias, out, b, n, heads, dh, n_real, scale, s,
                                        causal);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
