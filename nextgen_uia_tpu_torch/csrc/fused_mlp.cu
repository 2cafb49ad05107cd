// MLP with frozen weights, forward and dx backward, for Hopper (sm_90a):
//
//   forward:  h = act(x @ W1 + b1) -> T;  out = h @ W2 + b2 -> T
//   backward: a = x @ W1 + b1 (float32, recomputed);
//             dpre = (g @ W2^T) * act'(a) -> T;  dx = dpre @ W1^T -> T
//
// Replaces nextgen_uia_tpu/ops/fused_mlp.py::fused_mlp: the Pallas kernels
// _fwd_kernel (pallas_call in _fused_fwd_impl) and _bwd_kernel (pallas_call
// in _fused_bwd_rule). It is the LN + MLP +
// residual kernel (fused_ln_mlp.cu) without the LayerNorm and the residual:
// two launches of block_kernels.cuh's GEMM, bias and the exact erf GELU (or
// quick_gelu) fused into the first epilogue, the bias into the second. Sums
// are float32 and the hidden activation is rounded to T, as on the TPU. The
// TPU kernel's polynomial erf and its row-tile fallback for M % 8 != 0 are
// not copied: erff is exact and the GEMM masks any M.
//
// What bounds it on the H100: DINOv2-B/14 at 518 px, batch 24, is M = 32880
// rows of D = 768 with hidden 3072: 4 * M * D * hidden = 310.3 GFLOP, 0.314
// ms at the bf16 peak, against ~110 MB of x, out and weights: operations.
// The TPU kernel keeps the hidden chunk in VMEM; here the [M, 3072] hidden
// tensor (202 MB in bf16) makes one round trip through device memory, which
// a later fused kernel would save.
//
// Backward: the LN + MLP backward of fused_ln_mlp.cu (nx_ln_mlp_bwd)
// without the LayerNorm and its backward: three launches of the same GEMM,
// the fc1 recompute into a float32 scratch a, g @ W2^T with the
// activation-derivative epilogue rounding dpre to T (the TPU kernel's
// rounding point, where bf16 gradients drift if it moves), and dpre @ W1^T
// written straight to dx, its float32 sums rounded once. The weights are
// frozen: dx only, as on the TPU. At the BERT fine-tune's shape (M = 16 x
// 256 = 4096 rows, D = 768, hidden 3072) it is three products, 58.0 GFLOP,
// 0.059 ms at the bf16 peak against ~75 MB of x, g, dx, weights and the
// [M, 3072] a and dpre round trips: operations.

#include "block_kernels.cuh"

using namespace nx;

extern "C" {

// x, out [M, D]; w1 [D, Hd], w2 [Hd, D] (x's dtype); b1 [Hd], b2 [D] f32;
// h scratch [M, Hd]
int nx_mlp_fwd(const void* x, const void* w1, const float* b1, const void* w2, const float* b2,
               void* h, void* out, int dtype, int m, int d, int hidden, int act, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Epilogue up{b1, nullptr, 0, nullptr, act, row_major(h), dtype};
  cudaError_t err = launch_gemm(row_major(x), w1, dtype, false, up, m, hidden, d, s);
  if (err != cudaSuccess) return (int)err;
  const Epilogue down{b2, nullptr, 0, nullptr, ACT_NONE, row_major(out), dtype};
  return (int)launch_gemm(row_major(h), w2, dtype, false, down, m, d, hidden, s);
}

// x, g, dx [M, D]; w1 [D, Hd], w2 [Hd, D] (x's dtype); b1 [Hd] f32;
// scratch: a [M, Hd] f32, dpre [M, Hd] (x's dtype)
int nx_mlp_bwd(const void* x, const void* w1, const float* b1, const void* w2, const void* g,
               float* a, void* dpre, void* dx, int dtype, int m, int d, int hidden, int act,
               void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Epilogue pre{b1, nullptr, 0, nullptr, ACT_NONE, row_major(a), F32};
  cudaError_t err = launch_gemm(row_major(x), w1, dtype, false, pre, m, hidden, d, s);
  if (err != cudaSuccess) return (int)err;
  const Epilogue dact{nullptr, nullptr, 0, a, act, row_major(dpre), dtype};
  err = launch_gemm(row_major(g), w2, dtype, true, dact, m, hidden, d, s);
  if (err != cudaSuccess) return (int)err;
  const Epilogue back{nullptr, nullptr, 0, nullptr, ACT_NONE, row_major(dx), dtype};
  return (int)launch_gemm(row_major(dpre), w1, dtype, true, back, m, d, hidden, s);
}

}  // extern "C"
