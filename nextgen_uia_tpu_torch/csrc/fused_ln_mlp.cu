// LayerNorm + MLP + residual, forward and dx backward, for Hopper (sm_90a):
//
//   forward:  z = LN(x) -> T;  h = act(z @ W1 + b1) -> T;
//             out = x + h @ W2 + b2 -> T
//   backward: z = LN(x) -> T;  a = z @ W1 + b1 (float32, recomputed);
//             dpre = (g @ W2^T) * act'(a) -> T;  dz = dpre @ W1^T (float32);
//             dx = g + LN_bwd(dz) -> T
//
// Replaces nextgen_uia_tpu/ops/fused_ln_mlp.py::fused_ln_mlp_residual: the
// Pallas kernels _fwd_kernel and _bwd_kernel. Weights are frozen (dx only,
// as on the TPU). Rounding points are that kernel's: z, h and dpre rounded
// to T; a, the products' sums, the residual sum, dz and the LayerNorm
// backward in float32. GELU and its derivative are the exact erf forms
// (common.cuh's act_fwd / act_grad, with quick_gelu).
//
// What bounds it on the H100: at the bench step's shape (M = B*N = 12,608
// rows, D = 768, hidden 3072) the forward is two products of 59.5 GFLOP
// each (0.120 ms at the bf16 peak) and the backward three (fc1 recomputed,
// dpre, dz: 0.180 ms), against 48 MB of x, out and the weights (0.014 ms)
// and 68 MB of x, g, dx and the weights (0.020 ms). So operations bound
// both.
//
// Design. The TPU kernel streams row tiles with the hidden chunk in VMEM.
// Here every bf16 product is one flat call of hopper_gemm.cuh's core over
// the M rows (TMA ring, wgmma, W multicast over a cluster of two,
// persistent grid), and the [M, 3072] hidden tensor crosses device memory
// between them; the LayerNorm and its backward are block_kernels.cuh's row
// kernels. The products are block_products.cuh's mlp and mlp_bwd, shared
// with K1 and K10:
// - forward: z = LN(x); h = act(z W1 + b1) (BiasActEpilogue); out = h W2 +
//   b2 + x (BiasResidualEpilogue, the residual read at the output's own
//   row, one rounding). Both epilogues are staged (hopper_gemm.cuh): the
//   sums pass through a float32 stage in shared memory, so the products
//   run on 128-column tiles in a 4-deep ring.
// - backward: z again; a = z W1 + b1 written in float32 from registers
//   (StoreF32Epilogue, 155 MB at the bench's shape; 256-column tiles, a
//   3-deep ring); dpre = (g W2^T) * act'(a) (ActGradEpilogue, staged, which
//   reads a back in row order) -> T; dz = dpre W1^T in float32
//   (StoreF32Epilogue, 192 x 4); then the LayerNorm backward adds g.
// The core reads W as [cols, K]: the forward takes W1^T [3072, D] and W2^T
// [D, 3072], which the wrapper builds once per call, and the backward's
// g W2^T and dpre W1^T read W2 and W1 as stored. Each output element is
// one thread's sum in a fixed order (no atomics), so two calls are bitwise
// equal. a's float32 round trip (~0.1 ms of the backward's traffic at the
// bench's shape) is what a product with two accumulators over the shared K
// = D (z W1 and g W2^T) would save. float32 runs the same dataflow on
// block_kernels.cuh's SIMT GEMM: the exact float32 check of the algorithm.
//
// Post-norm variant (nx_postnorm_mlp_ln_fwd, K9), forward only:
//
//   h = act(x @ W1 + b1) -> T;  y32 = x + h @ W2 + b2 (float32 scratch);
//   out = LN(y32) -> T
//
// Replaces nextgen_uia_tpu/ops/fused_ln_mlp.py::fused_postnorm_mlp_ln (the
// Pallas kernel _postnorm_fwd_kernel): BERT's feed-forward sublayer, exact
// erf GELU, eps 1e-12. Rounding points are that kernel's: h rounded to T,
// the residual sum float32 until the LayerNorm, the output rounded once. At
// the text cache's chunk (M = 65536 rows, D = 768, hidden 3072) it is 619
// GFLOP (0.625 ms at the bf16 peak) against 210 MB of x, out and the
// weights (0.063 ms): compute-bound. It is K1 post-norm's MLP half with x
// as a bf16 residual, as K6 post-LN is its attention half: the same
// block_products.cuh::mlp, three launches. fc1 with bias + GELU
// (BiasActEpilogue, 128 x 4); fc2 adding b2 and the bf16 x at the output's
// own row and storing the sum in float32 (ResidualEpilogue<bf16, true>,
// staged); layernorm_rows from the float32 sum into the output. The TPU
// kernel keeps the hidden chunk and the sum in VMEM; here both go through
// device memory ([M, 3072] in T and [M, 768] in float32). Its backward is
// autograd through the plain recomposition (ops/fused_ln_mlp.py), as the
// JAX package differentiates its XLA recomposition: no kernel of its own.

#include "block_products.cuh"

using namespace nx;

extern "C" {

// x, out [M, D]; gamma, beta [D] f32; w1_t [Hd, D] = W1^T, w2_t [D, Hd] =
// W2^T (x's dtype); b1 [Hd], b2 [D] f32; z scratch [M, D]; h scratch [M, Hd]
int nx_ln_mlp_fwd(const void* x, const float* gamma, const float* beta, const void* w1_t,
                  const float* b1, const void* w2_t, const float* b2, void* z, void* h,
                  void* out, int dtype, int m, int d, int hidden, int act, float eps,
                  void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype != F32 && dtype != BF16) return (int)cudaErrorInvalidValue;
  const cudaError_t err = layernorm(x, gamma, beta, z, m, d, eps, dtype, s);
  if (err != cudaSuccess) return (int)err;
  return mlp<128, 4>(z, w1_t, b1, w2_t, b2, x,
                     hopper::BiasResidualEpilogue{b2, static_cast<const __nv_bfloat16*>(x), d},
                     h, out, dtype, m, d, hidden, act, s);
}

// g, dx [M, D] (x's dtype); w1_t [Hd, D] = W1^T, w1 [D, Hd] and w2 [Hd, D]
// (as stored) in x's dtype; scratch: z [M, D] (x's dtype), a [M, Hd] f32,
// dpre [M, Hd] (x's dtype), dz [M, D] f32
int nx_ln_mlp_bwd(const void* x, const float* gamma, const float* beta, const void* w1_t,
                  const float* b1, const void* w1, const void* w2, const void* g, void* z,
                  float* a, void* dpre, float* dz, void* dx, int dtype, int m, int d, int hidden,
                  int act, float eps, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype != F32 && dtype != BF16) return (int)cudaErrorInvalidValue;
  int err = (int)layernorm(x, gamma, beta, z, m, d, eps, dtype, s);
  if (err) return err;
  err = mlp_bwd<192, 4>(z, w1_t, b1, w1, w2, g, a, dpre, hopper::StoreF32Epilogue{nullptr, dz, d},
                        dz, dtype, m, d, hidden, act, s);
  if (err) return err;
  return (int)(dtype == BF16
                   ? launch_layernorm_bwd<__nv_bfloat16>(x, gamma, dz, g, dx, m, d, eps, s)
                   : launch_layernorm_bwd<float>(x, gamma, dz, g, dx, m, d, eps, s));
}

// x, out [M, D]; w1_t [Hd, D] = W1^T, w2_t [D, Hd] = W2^T (x's dtype); b1
// [Hd], b2, gamma, beta [D] f32; scratch: h [M, Hd] (x's dtype), y32 [M, D]
// f32
int nx_postnorm_mlp_ln_fwd(const void* x, const void* w1_t, const float* b1, const void* w2_t,
                           const float* b2, const float* gamma, const float* beta, void* h,
                           float* y32, void* out, int dtype, int m, int d, int hidden, int act,
                           float eps, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype != F32 && dtype != BF16) return (int)cudaErrorInvalidValue;
  // fc2 stores x + h W2 + b2 in float32 on 128-column tiles in a 4-deep
  // ring: at [256 * 256, 768] x 3072 0.6314-0.6440 ms against 0.6617-0.6737
  // at 192 x 3 and 0.8958-0.9073 at 256 x 2 (tools/epilogue_bench.cu, H100
  // 80GB HBM3 at 700 W)
  const int err = mlp<128, 4>(
      x, w1_t, b1, w2_t, b2, x,
      hopper::ResidualEpilogue<__nv_bfloat16, true>{b2, static_cast<const __nv_bfloat16*>(x),
                                                    d, y32},
      h, y32, dtype, m, d, hidden, act, s);
  if (err) return err;
  return (int)layernorm_f32(y32, gamma, beta, out, m, d, eps, dtype, s);
}

}  // extern "C"
