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
// What bounds it on the H100: at the bench step's shape (B*N = 64*197
// rows, D = 768) each direction is one [12608, 768] x [768, 2304] product,
// 44.6 GFLOP against ~90 MB of activations and weights, so it is
// compute-bound (about 45 us at the bf16 tensor-core peak). The TPU kernel
// holds a whole image's rows and all three weights in VMEM; here the
// LayerNorm is its own pass (one warp per row, z written once in T) and
// the product runs on hopper_gemm.cuh's core, the head-major relayout
// folded into its TMA store (forward) and TMA load (backward), so no
// transpose pass touches device memory. N = 197 leaves each sequence's
// second 128-row tile ragged: TMA zero-fills its loads and clips its
// stores, the float32 store masks its rows; nothing is padded.
//
// Design: in bf16 both directions run on the core (TMA loads into a ring
// of mbarrier-guarded stages, wgmma.mma_async on two consumer warpgroups, a
// persistent CTA per SM, clusters of two CTAs sharing each W tile by TMA
// multicast). The M tile is (sequence, 128 tokens), so TMA's zero fill
// covers any token count.
// - Pre-norm forward (nx_ln_qkv_fwd): the LayerNorm into z (T), then
//   nx_qkv_rawx_fwd's product on z: A is z, a 3-D box of [B, N, D]; B is
//   W_qkv^T [3D, D], built contiguous once per forward by the wrapper (both
//   operands K-major, wgmma's plain layout); 128 x 256 tiles (four heads),
//   3 stages; the epilogue adds the bias and writes each head's 64 x 64 box
//   of q, k or v by TMA.
// - Pre-norm backward (nx_ln_qkv_bwd): A is dq|dk|dv, each K step of 64
//   one head's dh, a 4-D box of [B, H, N, dh]; B is W_qkv [D, 3D] as stored
//   (K-major for dz = dy @ W^T); the float32 dz is stored straight from the
//   accumulator registers (StoreF32Epilogue, 32 contiguous bytes per quad,
//   rows past the sequence masked), 128 x 192 tiles, 4 stages
//   (tools/epilogue_bench.cu); then the LayerNorm backward, one warp per
//   row. No split of K, no atomics: two calls are bitwise equal.
//
// Raw-x variant (nx_qkv_rawx_fwd, nx_qkv_rawx_bwd): [q|k|v] = x @
// [Wq|Wk|Wv] + b, float32 sums plus the float32 bias rounded once to T and
// written head-major, with no LayerNorm; backward dx = [dq|dk|dv] @ [Wq|Wk|
// Wv]^T, float32 sums rounded once to T. It replaces the same Pallas
// kernels with ln_params=None (_fwd_kernel, and _bwd_kernel with
// has_ln=False), which post-norm towers run: the PubMedBERT text tower of
// BiomedCLIP, whose q/k/v project the raw residual stream (models/bert.py).
// The backward runs where the text tower is differentiated
// (--tune_text_encoder with --lora_layers below the depth). Its products
// are the pre-norm ones on x: the forward at 256 x 3, the backward at 192 x
// 4 with the dx rounded to T and written by TMA.
//
// What bounds it on the H100: at the text cache's chunk (B*N = 256*256
// rows, D = 768) the forward is one [65536, 768] x [768, 2304] product, 232
// GFLOP, ~0.234 ms at the bf16 peak, against ~0.40 GB of x, q, k, v and
// weights (~0.12 ms at 3.35 TB/s, the q/k/v write alone ~0.09 ms): compute-
// bound, but the output write is ~40% of it. At the fine-tune's microbatch
// ([16, 256, 768]) the backward is 14.5 GFLOP, ~0.015 ms.
//
// bf16 needs dh % 64 == 0 (a K step or an output box never straddles two
// heads); the wrappers raise on the rest. float32 keeps block_kernels.cuh's
// SIMT GEMM (W^T read transposed where the product wants it), the exact
// float32 check of the algorithm.

#include "block_kernels.cuh"
#include "hopper_gemm.cuh"

using namespace nx;

extern "C" {

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

// the pre-norm backward's dz product: dq|dk|dv (head-major) @ W_qkv^T,
// stored float32 from the registers at 128 x 192, 4 stages
constexpr int DZ_BN = 192, DZ_STAGES = 4;

// x [B*N, D]; gamma, beta [D] f32; w_qkv_t [3D, D] = [Wq|Wk|Wv]^T (x's
// dtype); b_qkv [3D] f32; z scratch [B*N, D]; q, k, v [B, H, N, dh]
int nx_ln_qkv_fwd(const void* x, const float* gamma, const float* beta, const void* w_qkv_t,
                  const float* b_qkv, void* z, void* q, void* k, void* v, int dtype, int b,
                  int n, int heads, int dh, float eps, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int m = b * n, d = heads * dh;
  cudaError_t err =
      dtype == BF16
          ? launch_layernorm<__nv_bfloat16, __nv_bfloat16>(x, gamma, beta, z, m, d, eps, s)
          : launch_layernorm<float, float>(x, gamma, beta, z, m, d, eps, s);
  if (err != cudaSuccess) return (int)err;
  return nx_qkv_rawx_fwd(z, w_qkv_t, b_qkv, q, k, v, dtype, b, n, heads, dh, stream);
}

// dq, dk, dv [B, H, N, dh]; w_qkv [D, 3D] (x's dtype); dz scratch [B*N, D]
// f32; dx [B*N, D]
int nx_ln_qkv_bwd(const void* x, const float* gamma, const void* w_qkv, const void* dq,
                  const void* dk, const void* dv, float* dz, void* dx, int dtype, int b, int n,
                  int heads, int dh, float eps, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int m = b * n, d = heads * dh;
  cudaError_t err;
  if (dtype == BF16) {
    hopper::TmaMatrix a, unused = hopper::TmaMatrix{};
    err = hopper::heads_matrix(a, dq, dk, dv, b, n, heads, dh, hopper::BM);
    if (err == cudaSuccess)
      err = hopper::gemm<DZ_BN, DZ_STAGES>(a, w_qkv, unused,
                                           hopper::StoreF32Epilogue{nullptr, dz, d}, b, n, d,
                                           3 * d, s);
  } else {
    const Epilogue epi{nullptr, nullptr, 0, nullptr, ACT_NONE, row_major(dz), F32};
    err = launch_gemm(head_major(dq, dk, dv, n, heads, dh), w_qkv, dtype, true, epi, m, d,
                      3 * d, s);
  }
  if (err != cudaSuccess) return (int)err;
  return (int)(dtype == BF16
                   ? launch_layernorm_bwd<__nv_bfloat16>(x, gamma, dz, nullptr, dx, m, d, eps, s)
                   : launch_layernorm_bwd<float>(x, gamma, dz, nullptr, dx, m, d, eps, s));
}

}  // extern "C"
