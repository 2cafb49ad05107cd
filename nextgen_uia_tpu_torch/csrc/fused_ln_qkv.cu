// LayerNorm + q/k/v projection, forward and dx backward, for Hopper (sm_90a):
//
//   forward:  z = LN(x) -> T;  [q|k|v] = z @ [Wq|Wk|Wv] + b -> T, written
//             head-major [B, H, N, dh] by the GEMM's epilogue
//   backward: dz = [dq|dk|dv] @ [Wq|Wk|Wv]^T (float32, the A operand read
//             head-major by the GEMM's loader); dx = LN_bwd(dz), statistics
//             recomputed from x
//
// Replaces nextgen_uia_tpu/ops/fused_ln_qkv.py::fused_ln_qkv, pre-norm
// (ln_params given): the Pallas kernels _fwd_kernel and _bwd_kernel. The
// weights are frozen: the backward gives dx only, as the TPU kernel does.
// Rounding points are that kernel's: z and q/k/v rounded to T, dz and the
// LayerNorm backward in float32, dx rounded once.
//
// What bounds it on the H100: at the training shape (B*N = 32*197 rows,
// D = 768) each direction is one [6304, 768] x [768, 2304] product, 22.3
// GFLOP against ~45 MB of activations and weights, so it is compute-bound
// (about 23 us at the bf16 tensor-core peak). The TPU kernel holds a whole
// image's rows and all three weights in VMEM; here the weights stream
// through shared memory per 128x128 output tile (block_kernels.cuh's WMMA
// GEMM) and the head-major relayout is folded into the GEMM's store
// (forward) and load (backward), so no transpose pass touches device memory.
// The ragged edge (N = 197) is masked by the GEMM; nothing is padded.
//
// Raw-x variant (nx_qkv_rawx_fwd, nx_qkv_rawx_bwd): [q|k|v] = x @
// [Wq|Wk|Wv] + b, float32 sums plus the float32 bias rounded once to T and
// written head-major, with no LayerNorm; backward dx = [dq|dk|dv] @ [Wq|Wk|
// Wv]^T, float32 sums rounded once to T. It replaces the same Pallas
// kernels with ln_params=None (_fwd_kernel, and _bwd_kernel with
// has_ln=False), which post-norm towers run: the PubMedBERT text tower of
// BiomedCLIP, whose q/k/v project the raw residual stream (models/bert.py).
// The backward runs where the text tower is differentiated
// (--tune_text_encoder with --lora_layers below the depth).
//
// What bounds it on the H100: at the text cache's chunk (B*N = 256*256
// rows, D = 768) the forward is one [65536, 768] x [768, 2304] product, 232
// GFLOP, ~0.234 ms at the bf16 peak, against ~0.40 GB of x, q, k, v and
// weights (~0.12 ms at 3.35 TB/s, the q/k/v write alone ~0.09 ms): compute-
// bound, but the output write is ~40% of it. At the fine-tune's microbatch
// ([16, 256, 768]) the backward is 14.5 GFLOP, ~0.015 ms.
//
// Design: in bf16 both run on hopper_gemm.cuh's core (TMA loads into a
// ring of mbarrier-guarded stages, wgmma.mma_async on two consumer
// warpgroups, a persistent CTA per SM, clusters of two CTAs sharing each W
// tile by TMA multicast, the output staged in shared memory and written by
// TMA stores under the next tile's products). The M tile is (sequence, 128
// tokens), so TMA's zero fill covers any token count.
// - Forward: A is x, a 3-D box of [B, N, D]; B is W_qkv^T [3D, D], built
//   contiguous once per forward by the wrapper (so both operands are
//   K-major, wgmma's plain layout, rather than reading W through the
//   transposed-B mode); 128 x 256 tiles (four heads), 3 stages; the
//   epilogue adds the bias and writes each head's 64 x 64 box of q, k or v
//   by TMA.
// - Backward: A is dq|dk|dv, each K step of 64 one head's dh, a 4-D box of
//   [B, H, N, dh]; B is W_qkv [D, 3D] as stored (already K-major for dx =
//   dy @ W^T); 128 x 192 tiles (at [4096, 768]: 128 CTAs, one wave on 132
//   SMs, 36 K steps each), 4 stages; no split of K, no atomics: two calls
//   are bitwise equal.
// bf16 needs dh % 64 == 0 (a K step or an output box never straddles two
// heads); the wrapper raises on the rest. float32 keeps block_kernels.cuh's
// SIMT GEMM (W^T read transposed), the exact float32 check of the
// algorithm.

#include "block_kernels.cuh"
#include "hopper_gemm.cuh"

using namespace nx;

extern "C" {

// x [B*N, D]; gamma, beta [D] f32; w_qkv [D, 3D] (x's dtype); b_qkv [3D]
// f32; z scratch [B*N, D]; q, k, v [B, H, N, dh]
int nx_ln_qkv_fwd(const void* x, const float* gamma, const float* beta, const void* w_qkv,
                  const float* b_qkv, void* z, void* q, void* k, void* v, int dtype, int b,
                  int n, int heads, int dh, float eps, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int m = b * n, d = heads * dh;
  cudaError_t err =
      dtype == BF16
          ? launch_layernorm<__nv_bfloat16, __nv_bfloat16>(x, gamma, beta, z, m, d, eps, s)
          : launch_layernorm<float, float>(x, gamma, beta, z, m, d, eps, s);
  if (err != cudaSuccess) return (int)err;
  const Epilogue epi{b_qkv, nullptr, 0, nullptr, ACT_NONE, head_major(q, k, v, n, heads, dh),
                     dtype};
  return (int)launch_gemm(row_major(z), w_qkv, dtype, false, epi, m, 3 * d, d, s);
}

// dq, dk, dv [B, H, N, dh] (x's dtype); dz scratch [B*N, D] f32;
// dx [B*N, D]
int nx_ln_qkv_bwd(const void* x, const float* gamma, const void* w_qkv, const void* dq,
                  const void* dk, const void* dv, float* dz, void* dx, int dtype, int b, int n,
                  int heads, int dh, float eps, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int m = b * n, d = heads * dh;
  const Epilogue epi{nullptr, nullptr, 0, nullptr, ACT_NONE, row_major(dz), F32};
  cudaError_t err = launch_gemm(head_major(dq, dk, dv, n, heads, dh), w_qkv, dtype, true, epi,
                                m, d, 3 * d, s);
  if (err != cudaSuccess) return (int)err;
  return (int)(dtype == BF16
                   ? launch_layernorm_bwd<__nv_bfloat16>(x, gamma, dz, nullptr, dx, m, d, eps, s)
                   : launch_layernorm_bwd<float>(x, gamma, dz, nullptr, dx, m, d, eps, s));
}

// x [B*N, D]; w_qkv_t [3D, D] = [Wq|Wk|Wv]^T (x's dtype); b_qkv [3D] f32;
// q, k, v [B, H, N, dh]
int nx_qkv_rawx_fwd(const void* x, const void* w_qkv_t, const float* b_qkv, void* q, void* k,
                    void* v, int dtype, int b, int n, int heads, int dh, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int d = heads * dh;
  if (dtype == BF16) {
    hopper::TmaMatrix a, out;
    cudaError_t err = hopper::rows_matrix(a, x, b, n, d, hopper::BM);
    if (err == cudaSuccess) err = hopper::heads_matrix(out, q, k, v, b, n, heads, dh, 64);
    if (err != cudaSuccess) return (int)err;
    return (int)hopper::gemm<256, 3>(a, w_qkv_t, out, hopper::BiasEpilogue{b_qkv}, b, n, 3 * d,
                                     d, s);
  }
  const Epilogue epi{b_qkv, nullptr, 0, nullptr, ACT_NONE, head_major(q, k, v, n, heads, dh),
                     dtype};
  return (int)launch_gemm(row_major(x), w_qkv_t, dtype, true, epi, b * n, 3 * d, d, s);
}

// dq, dk, dv [B, H, N, dh]; w_qkv [D, 3D] (x's dtype); dx [B*N, D]
int nx_qkv_rawx_bwd(const void* w_qkv, const void* dq, const void* dk, const void* dv, void* dx,
                    int dtype, int b, int n, int heads, int dh, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int d = heads * dh;
  if (dtype == BF16) {
    hopper::TmaMatrix a, out;
    cudaError_t err = hopper::heads_matrix(a, dq, dk, dv, b, n, heads, dh, hopper::BM);
    if (err == cudaSuccess) err = hopper::rows_matrix(out, dx, b, n, d, 64);
    if (err != cudaSuccess) return (int)err;
    return (int)hopper::gemm<192, 4>(a, w_qkv, out, hopper::NoEpilogue{}, b, n, d, 3 * d, s);
  }
  const Epilogue epi{nullptr, nullptr, 0, nullptr, ACT_NONE, row_major(dx), dtype};
  return (int)launch_gemm(head_major(dq, dk, dv, n, heads, dh), w_qkv, dtype, true, epi, b * n,
                          d, 3 * d, s);
}

}  // extern "C"
