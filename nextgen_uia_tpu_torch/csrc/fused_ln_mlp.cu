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
// to T; a, the products' sums and the LayerNorm backward in float32. GELU
// and its derivative are the exact erf forms.
//
// What bounds it on the H100: at the training shape (B*N = 6304 rows,
// D = 768, hidden 3072) the forward is two products of 29.7 GFLOP each and
// the backward three (fc1 recompute, dh, dz): ~60 and ~89 GFLOP against
// ~30 MB of activations and weights, so both are compute-bound (~60 and
// ~90 us at the bf16 peak). The TPU kernel streams row tiles with the hidden
// chunk held in VMEM; here the [6304, 3072] hidden tensor (h forward; a and
// dpre backward) goes through device memory between the WMMA GEMMs of
// block_kernels.cuh, which fuse bias, activation, its derivative and the
// residual into their epilogues. The hidden round trip (~40-120 MB) is what
// a later, fused kernel would save.
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

#include "block_kernels.cuh"

using namespace nx;

extern "C" {

// x, out [M, D]; gamma, beta [D] f32; w1 [D, Hd], w2 [Hd, D] (x's dtype);
// b1 [Hd], b2 [D] f32; z scratch [M, D]; h scratch [M, Hd]
int nx_ln_mlp_fwd(const void* x, const float* gamma, const float* beta, const void* w1,
                  const float* b1, const void* w2, const float* b2, void* z, void* h,
                  void* out, int dtype, int m, int d, int hidden, int act, float eps,
                  void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err =
      dtype == BF16
          ? launch_layernorm<__nv_bfloat16, __nv_bfloat16>(x, gamma, beta, z, m, d, eps, s)
          : launch_layernorm<float, float>(x, gamma, beta, z, m, d, eps, s);
  if (err != cudaSuccess) return (int)err;
  const Epilogue up{b1, nullptr, 0, nullptr, act, row_major(h), dtype};
  err = launch_gemm(row_major(z), w1, dtype, false, up, m, hidden, d, s);
  if (err != cudaSuccess) return (int)err;
  const Epilogue down{b2, x, dtype, nullptr, ACT_NONE, row_major(out), dtype};
  return (int)launch_gemm(row_major(h), w2, dtype, false, down, m, d, hidden, s);
}

// g, dx [M, D] (x's dtype); scratch: z [M, D] (x's dtype), a [M, Hd] f32,
// dpre [M, Hd] (x's dtype), dz [M, D] f32
int nx_ln_mlp_bwd(const void* x, const float* gamma, const float* beta, const void* w1,
                  const float* b1, const void* w2, const void* g, void* z, float* a,
                  void* dpre, float* dz, void* dx, int dtype, int m, int d, int hidden,
                  int act, float eps, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err =
      dtype == BF16
          ? launch_layernorm<__nv_bfloat16, __nv_bfloat16>(x, gamma, beta, z, m, d, eps, s)
          : launch_layernorm<float, float>(x, gamma, beta, z, m, d, eps, s);
  if (err != cudaSuccess) return (int)err;
  const Epilogue pre{b1, nullptr, 0, nullptr, ACT_NONE, row_major(a), F32};
  err = launch_gemm(row_major(z), w1, dtype, false, pre, m, hidden, d, s);
  if (err != cudaSuccess) return (int)err;
  const Epilogue dact{nullptr, nullptr, 0, a, act, row_major(dpre), dtype};
  err = launch_gemm(row_major(g), w2, dtype, true, dact, m, hidden, d, s);
  if (err != cudaSuccess) return (int)err;
  const Epilogue back{nullptr, nullptr, 0, nullptr, ACT_NONE, row_major(dz), F32};
  err = launch_gemm(row_major(dpre), w1, dtype, true, back, m, d, hidden, s);
  if (err != cudaSuccess) return (int)err;
  return (int)(dtype == BF16
                   ? launch_layernorm_bwd<__nv_bfloat16>(x, gamma, dz, g, dx, m, d, eps, s)
                   : launch_layernorm_bwd<float>(x, gamma, dz, g, dx, m, d, eps, s));
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
  return (int)(dtype == BF16
                   ? launch_layernorm<float, __nv_bfloat16>(y32, gamma, beta, out, m, d, eps, s)
                   : launch_layernorm<float, float>(y32, gamma, beta, out, m, d, eps, s));
}

}  // extern "C"
