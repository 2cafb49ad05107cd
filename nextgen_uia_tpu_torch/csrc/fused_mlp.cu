// MLP with frozen weights, forward and dx backward, for Hopper (sm_90a):
//
//   forward:  h = act(x @ W1 + b1) -> T;  out = h @ W2 + b2 -> T
//   backward: a = x @ W1 + b1 (float32, recomputed);
//             dpre = (g @ W2^T) * act'(a) -> T;  dx = dpre @ W1^T -> T
//
// Replaces nextgen_uia_tpu/ops/fused_mlp.py::fused_mlp: the Pallas kernels
// _fwd_kernel (pallas_call in _fused_fwd_impl) and _bwd_kernel (pallas_call
// in _fused_bwd_rule). Sums are float32, the hidden activation and dpre are
// rounded to T (the TPU kernel's rounding points, where bf16 gradients
// drift if they move), GELU is the exact erf form (or quick_gelu). The
// TPU kernel's polynomial erf and its row-tile fallback for M % 8 != 0 are
// not copied: erff is exact and the core takes any M.
//
// What bounds it on the H100: DINOv2-B/14 at 518 px, batch 24, is M = 32880
// rows of D = 768 with hidden 3072: 4 * M * D * hidden = 310.3 GFLOP, 0.314
// ms at the bf16 peak, against ~110 MB of x, out and weights: operations.
// The backward at the BERT fine-tune's microbatch (M = 16 x 256 = 4096
// rows) is three products, 58.0 GFLOP, 0.059 ms at the bf16 peak against
// ~30 MB of x, g, dx and the weights: operations.
//
// Design. It is the LN + MLP + residual kernel (fused_ln_mlp.cu) without
// the LayerNorm and the residual, on the same code: every bf16 product is
// one flat call of hopper_gemm.cuh's core over the M rows (TMA ring, wgmma,
// W multicast over a cluster of two, persistent grid); the last row tile
// is ragged at M = 32880 (TMA zero-fills its loads and clips its stores).
// - forward (block_products.cuh::mlp): fc1 with bias + activation
//   (BiasActEpilogue, staged, 128 x 4) into h [M, 3072] in T; fc2 with the
//   bias in registers (BiasEpilogue) and a bf16 TMA store.
// - backward (block_products.cuh::mlp_bwd, K8's products): a = x W1 + b1
//   in float32 from registers (StoreF32Epilogue, 256 x 3); dpre = (g W2^T)
//   * act'(a) (ActGradEpilogue, staged) -> T; dx = dpre W1^T with no
//   epilogue and a bf16 TMA store.
// The core reads W as [cols, K]: the forward takes W1^T [3072, D] and W2^T
// [D, 3072], which the wrapper builds once per forward, the backward W1^T
// for the recomputed fc1 and W2, W1 as stored for g W2^T and dpre W1^T.
// The TPU kernel keeps the hidden chunk in VMEM; here the [M, 3072] hidden
// tensor (202 MB in bf16 at DINOv2's shape) and, backward, a (float32) and
// dpre make round trips through device memory. Each output element is one
// thread's sum in a fixed order (no atomics): two calls are bitwise equal.
// float32 runs the same dataflow on block_kernels.cuh's SIMT GEMM: the
// exact float32 check of the algorithm.

#include "block_products.cuh"

using namespace nx;

extern "C" {

// x, out [M, D]; w1_t [Hd, D] = W1^T, w2_t [D, Hd] = W2^T (x's dtype); b1
// [Hd], b2 [D] f32; h scratch [M, Hd] (x's dtype)
int nx_mlp_fwd(const void* x, const void* w1_t, const float* b1, const void* w2_t,
               const float* b2, void* h, void* out, int dtype, int m, int d, int hidden, int act,
               void* stream) {
  // fc2 on 192-column tiles in a 4-deep ring: the fastest of 128 x 4,
  // 192 x 3, 192 x 4 and 256 x 3 at DINOv2's [24 * 1370, 768] (0.2159-0.2214
  // ms against 0.2302-0.2411 at 256 x 3) and the BERT LoRA layers' [16 *
  // 256, 768] (0.0337-0.0350 against 0.0409-0.0435 at 192 x 3)
  // (tools/epilogue_bench.cu, H100 80GB HBM3 at 700 W)
  return mlp<192, 4>(x, w1_t, b1, w2_t, b2, nullptr, hopper::BiasEpilogue{b2}, h, out, dtype, m,
                     d, hidden, act, static_cast<cudaStream_t>(stream));
}

// x, g, dx [M, D] (x's dtype); w1_t [Hd, D] = W1^T, w1 [D, Hd] and w2 [Hd,
// D] (as stored) in x's dtype; b1 [Hd] f32; scratch: a [M, Hd] f32, dpre
// [M, Hd] (x's dtype)
int nx_mlp_bwd(const void* x, const void* w1_t, const float* b1, const void* w1, const void* w2,
               const void* g, float* a, void* dpre, void* dx, int dtype, int m, int d, int hidden,
               int act, void* stream) {
  // dx on 192-column tiles in a 4-deep ring, K8's dz: at [16 * 256, 768]
  // 0.0334-0.0348 ms against 0.0451-0.0469 at 256 x 3 and 0.0460-0.0477 at
  // 128 x 4 (tools/epilogue_bench.cu, H100 80GB HBM3 at 700 W)
  return mlp_bwd<192, 4>(x, w1_t, b1, w1, w2, g, a, dpre, hopper::NoEpilogue{}, dx, dtype, m, d,
                         hidden, act, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
