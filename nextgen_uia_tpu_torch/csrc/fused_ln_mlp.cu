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
// kernels:
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
// Post-norm variant (nx_postnorm_mlp_ln_fwd), forward only:
//
//   h = act(x @ W1 + b1) -> T;  y32 = x + h @ W2 + b2 (float32 scratch);
//   out = LN(y32) -> T
//
// Replaces nextgen_uia_tpu/ops/fused_ln_mlp.py::fused_postnorm_mlp_ln (the
// Pallas kernel _postnorm_fwd_kernel): BERT's feed-forward sublayer, exact
// erf GELU, eps 1e-12. Rounding points are that kernel's: h rounded to T,
// the residual sum float32 until the LayerNorm, the output rounded once. At
// the text cache's chunk (M = 65536 rows, D = 768, hidden 3072) it is 619
// GFLOP against ~0.6 GB of x, out and the float32 sum: compute-bound (~0.63
// ms at the bf16 peak). Three launches: the two WMMA GEMMs (bias and GELU in
// the first epilogue, bias and residual in the second, which writes the
// float32 sum) and layernorm_rows. The TPU kernel keeps the hidden chunk
// and the sum in VMEM; here both go through device memory ([M, 3072] in T
// and [M, 768] in float32). Its backward is XLA on the TPU and is not
// ported: autograd reaching it on the card raises.

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
  cudaError_t err = layernorm(x, gamma, beta, z, m, d, eps, dtype, s);
  if (err != cudaSuccess) return (int)err;
  if (dtype == F32) {
    const Epilogue up{b1, nullptr, 0, nullptr, act, row_major(h), F32};
    err = launch_gemm(row_major(z), w1_t, F32, true, up, m, hidden, d, s);
    if (err != cudaSuccess) return (int)err;
    const Epilogue down{b2, x, F32, nullptr, ACT_NONE, row_major(out), F32};
    return (int)launch_gemm(row_major(h), w2_t, F32, true, down, m, d, hidden, s);
  }
  hopper::TmaMatrix ta, to;
  if ((err = flat(ta, z, d, to, h, hidden, m)) != cudaSuccess) return (int)err;
  err = hidden_product<hopper::BiasActEpilogue>(ta, w1_t, to, act, m, hidden, d, s, b1);
  if (err != cudaSuccess) return (int)err;
  if ((err = flat(ta, h, hidden, to, out, d, m)) != cudaSuccess) return (int)err;
  const hopper::BiasResidualEpilogue down{b2, static_cast<const __nv_bfloat16*>(x), d};
  return (int)hopper::gemm<128, 4>(ta, w2_t, to, down, 1, m, d, hidden, s);
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
  cudaError_t err = layernorm(x, gamma, beta, z, m, d, eps, dtype, s);
  if (err != cudaSuccess) return (int)err;
  if (dtype == F32) {
    const Epilogue pre{b1, nullptr, 0, nullptr, ACT_NONE, row_major(a), F32};
    err = launch_gemm(row_major(z), w1_t, F32, true, pre, m, hidden, d, s);
    if (err != cudaSuccess) return (int)err;
    const Epilogue dact{nullptr, nullptr, 0, a, act, row_major(dpre), F32};
    err = launch_gemm(row_major(g), w2, F32, true, dact, m, hidden, d, s);
    if (err != cudaSuccess) return (int)err;
    const Epilogue back{nullptr, nullptr, 0, nullptr, ACT_NONE, row_major(dz), F32};
    err = launch_gemm(row_major(dpre), w1, F32, true, back, m, d, hidden, s);
    if (err != cudaSuccess) return (int)err;
    return (int)launch_layernorm_bwd<float>(x, gamma, dz, g, dx, m, d, eps, s);
  }
  const hopper::TmaMatrix none{};
  hopper::TmaMatrix ta, to;
  if ((err = flat(ta, z, d, to, nullptr, 0, m)) != cudaSuccess) return (int)err;
  err = hopper::gemm<256, 3>(ta, w1_t, none, hopper::StoreF32Epilogue{b1, a, hidden}, 1, m,
                             hidden, d, s);
  if (err != cudaSuccess) return (int)err;
  if ((err = flat(ta, g, d, to, dpre, hidden, m)) != cudaSuccess) return (int)err;
  err = hidden_product<hopper::ActGradEpilogue>(ta, w2, to, act, m, hidden, d, s,
                                                 static_cast<const float*>(a), hidden);
  if (err != cudaSuccess) return (int)err;
  if ((err = flat(ta, dpre, hidden, to, nullptr, 0, m)) != cudaSuccess) return (int)err;
  err = hopper::gemm<192, 4>(ta, w1, none, hopper::StoreF32Epilogue{nullptr, dz, d}, 1, m, d,
                             hidden, s);
  if (err != cudaSuccess) return (int)err;
  return (int)launch_layernorm_bwd<__nv_bfloat16>(x, gamma, dz, g, dx, m, d, eps, s);
}

// x, out [M, D]; w1 [D, Hd], w2 [Hd, D] (x's dtype); b1 [Hd], b2, gamma,
// beta [D] f32; scratch: h [M, Hd] (x's dtype), y32 [M, D] f32
int nx_postnorm_mlp_ln_fwd(const void* x, const void* w1, const float* b1, const void* w2,
                           const float* b2, const float* gamma, const float* beta, void* h,
                           float* y32, void* out, int dtype, int m, int d, int hidden, int act,
                           float eps, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Epilogue up{b1, nullptr, 0, nullptr, act, row_major(h), dtype};
  cudaError_t err = launch_gemm(row_major(x), w1, dtype, false, up, m, hidden, d, s);
  if (err != cudaSuccess) return (int)err;
  const Epilogue down{b2, x, dtype, nullptr, ACT_NONE, row_major(y32), F32};
  err = launch_gemm(row_major(h), w2, dtype, false, down, m, d, hidden, s);
  if (err != cudaSuccess) return (int)err;
  return (int)layernorm_f32(y32, gamma, beta, out, m, d, eps, dtype, s);
}

}  // extern "C"
