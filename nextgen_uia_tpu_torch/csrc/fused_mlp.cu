// MLP with frozen weights, forward, for Hopper (sm_90a):
//
//   h = act(x @ W1 + b1) -> T;  out = h @ W2 + b2 -> T
//
// Replaces nextgen_uia_tpu/ops/fused_mlp.py::fused_mlp, forward: the Pallas
// kernel _fwd_kernel (pallas_call in _fused_fwd_impl). It is the LN + MLP +
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

}  // extern "C"
