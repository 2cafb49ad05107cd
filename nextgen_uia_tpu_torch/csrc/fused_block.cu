// Whole transformer block forward for Hopper (sm_90a), pre-norm (ViT, the
// CLIP text tower with the causal mask) or post-norm (BERT), as one entry
// (nx_block_fwd) that launches, in order:
//
//   pre-norm:
//     z   = LN1(x)                                   layernorm_rows   -> T
//     qkv = z @ [Wq|Wk|Wv] + b                       core             -> T
//     cat = softmax(q k^T / sqrt(dh) + key bias) v   K7               -> T
//     y32 = x + cat @ Wo + bo                        core, epilogue A -> f32
//     z2  = LN2(y32)                                 layernorm_rows   -> T
//     h   = act(z2 @ W1 + b1)                        core             -> T
//     out = y32 + h @ W2 + b2                        core, epilogue B -> T
//   post-norm:
//     qkv = x @ [Wq|Wk|Wv] + b                       core             -> T
//     cat = softmax(q k^T / sqrt(dh) + key bias) v   K7               -> T
//     s32 = x + cat @ Wo + bo                        core, epilogue A -> f32
//     y32 = LN_a(s32), z2 = y32 -> T                 layernorm_rows_dual
//     h   = act(z2 @ W1 + b1)                        core             -> T
//     s32 = y32 + h @ W2 + b2                        core, epilogue B -> f32
//     out = LN_b(s32)                                layernorm_rows   -> T
//
// Replaces nextgen_uia_tpu/ops/fused_block.py::fused_block_infer (the Pallas
// kernel _fwd_kernel) in both layouts. The rounding points are that
// kernel's: z, q/k/v, the probabilities, the head concat, z2 and h are
// rounded to the storage type T; the residual stream (y32, s32) and every
// product's sum stay float32 and the output is rounded once. Post-norm's y32
// stays float32 as the MLP's residual, and only its copy z2 that feeds fc1
// is rounded. Keys >= n_real reach K7 folded into its float32 key bias
// (-1e30, added before the caller's bias there and beside it here: either
// sum is -1e30 in float32); the causal mask (the CLIP text tower: 77
// tokens, width 512, 8 heads, quick_gelu) is K7's.
//
// What bounds it on the H100: at the serving shape (B*N = 32*197 rows, D =
// 768, hidden 3072) the four products hold ~99% of the block's 2*M*12*D^2 +
// 4*B*H*N^2*dh = 93 GFLOP, 0.094 ms at the bf16 peak, against ~50 MB of x,
// out and the weights: compute-bound. The text cache's [256, 77, 512]
// causal block is 0.127 ms of operations, BERT's [256, 256, 768] 0.99 ms.
//
// Design. The TPU kernel keeps every weight matrix resident in 64 MB of
// VMEM and one image's activations on chip. A Hopper block has 227 KB of
// shared memory, so here the block is a short sequence of launches of the
// port's other kernels, the activations crossing device memory between
// them (the 50 MB L2 holds most of them at the serving size):
// - every bf16 product is one flat call of hopper_gemm.cuh's core over the
//   B*N tokens (TMA ring, wgmma, W multicast over a cluster of two,
//   persistent grid; tiles cross sequences), reading its weight as W^T
//   [cols, K], which the wrapper builds in its one copy of the weights;
// - q|k|v is one row-major [B*N, 3D] buffer (K11's layout), which K7's
//   wgmma forward reads through strides, writing the head concat row-major
//   [B*N, D] (block_products.cuh::attn_o_f32, shared with K6 post-LN);
// - the two residual sums are staged epilogues (hopper_gemm.cuh's
//   ResidualEpilogue): A adds bo and the bf16 x and stores float32, B adds
//   b2 and the float32 residual stream and stores bf16 (pre-norm) or
//   float32 (post-norm, for the last LayerNorm); fc1's bias + activation is
//   K8's staged BiasActEpilogue; the MLP's two products are
//   block_products.cuh::mlp, shared with K8, K9 and K10;
// - LN1 writes z into the concat's buffer, which the q|k|v product has read
//   before K7 overwrites it.
// Each output element is one thread's sum in a fixed order (no atomics), so
// two calls are bitwise equal. bf16 needs dh = 64 (K7's wgmma kernels),
// D % 64 == 0 and hidden % 64 == 0 (the core); the wrapper refuses anything
// else. float32 runs the same dataflow on K7's float32 kernels and
// block_kernels.cuh's SIMT GEMM: the exact float32 check of the algorithm.

#include "block_products.cuh"

using namespace nx;

extern "C" {

const char* nx_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

// out[M, N] = act(a[M, K] @ w[K, N] + bias) (+ res) on block_kernels.cuh's
// WMMA GEMM (bf16) or SIMT GEMM (float32); a and w share `dtype`; needs
// N % 64 == 0, K % 32 == 0, 16-byte aligned a and w. No path of the port
// runs the bf16 WMMA GEMM: chip_smoke.py times it here as the yardstick
// beside the Hopper core; float32 products still run the SIMT GEMM.
int nx_gemm(const void* a, const void* w, int dtype, const float* bias, const void* res,
            int res_dtype, void* out, int out_dtype, int act, int M, int N, int K,
            void* stream) {
  const Epilogue epi{bias, res, res_dtype, nullptr, act, row_major(out), out_dtype};
  return (int)launch_gemm(row_major(a), w, dtype, false, epi, M, N, K,
                          static_cast<cudaStream_t>(stream));
}

// x, out [B*N, D] in `dtype`; ga, ba (LN1, or post-norm LN_a), gb, bb (LN2,
// or LN_b) [D] f32; wqkv_t [3D, D] = [Wq|Wk|Wv]^T, wo_t [D, D] = Wo^T, w1_t
// [hidden, D] = W1^T, w2_t [D, hidden] = W2^T in `dtype`; bqkv [3D], bo,
// b1 [hidden], b2 f32; key_bias [B, N] f32 (n_real folded in) or null;
// scratch qkv [B*N, 3D], cat, z2 (post-norm float32: unused) [B*N, D] and
// h [B*N, hidden] in `dtype`, y32 and (post-norm) s32 [B*N, D] f32
int nx_block_fwd(const void* x, const float* ga, const float* ba, const void* wqkv_t,
                 const float* bqkv, const void* wo_t, const float* bo, const float* gb,
                 const float* bb, const void* w1_t, const float* b1, const void* w2_t,
                 const float* b2, const float* key_bias, void* qkv, void* cat, float* y32,
                 float* s32, void* z2, void* h, void* out, int dtype, int b, int n, int heads,
                 int dh, int hidden, int act, int causal, int postnorm, float scale, float eps,
                 void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype != F32 && dtype != BF16) return (int)cudaErrorInvalidValue;
  const int m = b * n, d = heads * dh, ld = 3 * d;
  int err = 0;
  if (!postnorm && (err = (int)layernorm(x, ga, ba, cat, m, d, eps, dtype, s))) return err;
  // 192-column tiles in a 4-deep ring: 0.0406 ms against 0.0435 at 256 x 3
  // (K11's) at serving's shape, within 2% at the text caches'
  // (tools/epilogue_bench.cu, H100 80GB HBM3 at 700 W)
  err = project<192, 4>(postnorm ? x : cat, d, wqkv_t, bqkv, qkv, ld, m, ld, d, dtype, s);
  if (err) return err;
  float* sum = postnorm ? s32 : y32;  // the attention sublayer's float32 sum
  err = attn_o_f32(qkv, col(qkv, d, dtype), col(qkv, 2 * d, dtype), n * ld, dh, ld, key_bias,
                   causal, x, wo_t, bo, cat, sum, dtype, b, n, heads, dh, scale, s);
  if (err) return err;
  // fc2 on 128-column tiles in a 4-deep ring, the fastest of 128 x 4,
  // 192 x 3 and 256 x 2 at all three path shapes (tools/epilogue_bench.cu,
  // H100 80GB HBM3 at 700 W)
  if (!postnorm) {
    if ((err = (int)layernorm_f32(y32, gb, bb, z2, m, d, eps, dtype, s))) return err;
    return mlp<128, 4>(z2, w1_t, b1, w2_t, b2, y32,
                       hopper::ResidualEpilogue<float, false>{b2, y32, d, nullptr}, h, out,
                       dtype, m, d, hidden, act, s);
  }
  // float32 feeds fc1 the float32 y32 itself: its rounded copy is it
  if (dtype == F32) z2 = y32;
  err = (int)(dtype == BF16
                  ? launch_layernorm_dual<__nv_bfloat16>(s32, ga, ba, y32, z2, m, d, eps, s)
                  : launch_layernorm_dual<float>(s32, ga, ba, y32, nullptr, m, d, eps, s));
  if (err) return err;
  err = mlp<128, 4>(z2, w1_t, b1, w2_t, b2, y32,
                    hopper::ResidualEpilogue<float, true>{b2, y32, d, s32}, h, s32, dtype, m, d,
                    hidden, act, s);
  if (err) return err;
  return (int)layernorm_f32(s32, gb, bb, out, m, d, eps, dtype, s);
}

}  // extern "C"
