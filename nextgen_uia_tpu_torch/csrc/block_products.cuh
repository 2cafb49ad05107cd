// The steps the block kernels compose (K1's whole block, K6, K8, K9, K10,
// K11): each
// bf16 product one flat call of hopper_gemm.cuh's core over the B*N tokens
// (tiles cross sequences), each float32 one the SIMT GEMM of
// block_kernels.cuh, the attention K7's kernels (flash_attention.cu), which
// read q, k and v through element strides. Everything here is a template or
// `static`, so each .cu that includes the header builds on its own.

#pragma once

#include "block_kernels.cuh"
#include "hopper_gemm.cuh"

extern "C" int nx_flash_attention(const void* q, const void* k, const void* v, void* o,
                                  const float* bias, float* lse, int dtype, int b, int heads,
                                  int n, int dh, int sb, int sh, int sn, int osb, int osh,
                                  int osn, int causal, float scale, void* stream);
extern "C" int nx_flash_attention_bwd(const void* q, const void* k, const void* v,
                                      const void* o, const void* g, const float* lse,
                                      const float* bias, void* dq, void* dk, void* dv,
                                      float* dbias, float* delta, int dtype, int b, int heads,
                                      int n, int dh, int sb, int sh, int sn, int osb, int osh,
                                      int osn, int causal, float scale, void* stream);

namespace nx {

// the element `cols` columns into a row of `dtype`
static inline void* col(void* p, int cols, int dtype) {
  return static_cast<char*>(p) + (size_t)cols * (dtype == BF16 ? 2 : 4);
}

// out[m, cols] (rows ldo apart) = a[m, k] (rows lda apart) @ w^T + bias
// (float32 [cols] or null), w stored [cols, k]: bf16 as one flat product
// (batch 1) on the Hopper core with BN-column tiles in a STAGES-deep ring,
// float32 on the SIMT GEMM; no other dtype
template <int BN, int STAGES>
static int project(const void* a, int lda, const void* w, const float* bias, void* out, int ldo,
                   int m, int cols, int k, int dtype, cudaStream_t s) {
  if (dtype == F32) {
    const Epilogue epi{bias, nullptr, 0, nullptr, ACT_NONE, row_major(out, ldo), dtype};
    return (int)launch_gemm(row_major(a, lda), w, dtype, true, epi, m, cols, k, s);
  }
  if (dtype != BF16) return (int)cudaErrorInvalidValue;
  hopper::TmaMatrix ta, to;
  cudaError_t err = hopper::rows_matrix(ta, a, 1, m, k, hopper::BM, lda);
  if (err == cudaSuccess) err = hopper::rows_matrix(to, out, 1, m, cols, 64, ldo);
  if (err != cudaSuccess) return (int)err;
  return (int)hopper::gemm<BN, STAGES>(ta, w, to, hopper::BiasEpilogue{bias}, 1, m, cols, k, s);
}

// z[m, d] = LN(x) in `dtype` from x in the same dtype
static inline cudaError_t layernorm(const void* x, const float* gamma, const float* beta,
                                    void* z, int m, int d, float eps, int dtype,
                                    cudaStream_t s) {
  return dtype == BF16
             ? launch_layernorm<__nv_bfloat16, __nv_bfloat16>(x, gamma, beta, z, m, d, eps, s)
             : launch_layernorm<float, float>(x, gamma, beta, z, m, d, eps, s);
}

// out[m, d] = LN(x32) in `dtype` from float32 rows (a residual stream)
static inline cudaError_t layernorm_f32(const float* x32, const float* gamma,
                                        const float* beta, void* out, int m, int d, float eps,
                                        int dtype, cudaStream_t s) {
  return dtype == BF16
             ? launch_layernorm<float, __nv_bfloat16>(x32, gamma, beta, out, m, d, eps, s)
             : launch_layernorm<float, float>(x32, gamma, beta, out, m, d, eps, s);
}

// a [m, k] and (unless null) out [m, cols], bf16, as the core's flat
// row-major operands
static inline cudaError_t flat(hopper::TmaMatrix& ta, const void* a, int k,
                               hopper::TmaMatrix& to, const void* out, int cols, int m) {
  const cudaError_t err = hopper::rows_matrix(ta, a, 1, m, k, hopper::BM);
  return err != cudaSuccess || !out ? err : hopper::rows_matrix(to, out, 1, m, cols, 64);
}

// a hidden-wide product with an activation epilogue, Epi<ACT>{args...}
// (the activation a template argument, so each instantiation holds one
// activation's code): 128-column tiles in a 4-deep ring, as the staged
// epilogues' products run (a 4-deep ring of wider tiles leaves no room for
// their float32 stage)
template <template <int> class Epi, class... Args>
static cudaError_t hidden_product(const hopper::TmaMatrix& ta, const void* w,
                                  const hopper::TmaMatrix& to, int act, int m, int hidden, int d,
                                  cudaStream_t s, Args... args) {
  if (act == ACT_GELU)
    return hopper::gemm<128, 4>(ta, w, to, Epi<ACT_GELU>{args...}, 1, m, hidden, d, s);
  if (act == ACT_QUICK_GELU)
    return hopper::gemm<128, 4>(ta, w, to, Epi<ACT_QUICK_GELU>{args...}, 1, m, hidden, d, s);
  return cudaErrorInvalidValue;
}

// The MLP's two products, written once for K1 (both layouts), K8, K9 and
// K10:
//   h   = act(z @ W1 + b1) -> T                       [m, hidden]
//   out = h @ W2 + b2 (+ the residual)                 [m, d]
// bf16: fc1 is hidden_product's BiasActEpilogue (128 x 4), fc2 one flat
// product on BN-column tiles in a STAGES-deep ring (each caller's pair fixed
// by tools/epilogue_bench.cu at its path shapes) through the caller's
// epilogue `down`, which adds b2 and the residual (none: K10; bf16 x: K8,
// K9; the float32 stream: K1) and either rounds to bf16 for the TMA store
// into out, or, DIRECT, stores the float32 sum itself (K9, K1 post-norm:
// the LayerNorm that follows reads it; out is then that buffer). The last
// row tile may be ragged: TMA zero-fills its loads and clips its stores,
// the staged epilogues mask its rows. w1_t [hidden, d] = W1^T, w2_t [d,
// hidden] = W2^T in `dtype`. float32: the SIMT GEMM, res float32 [m, d] or
// null, out float32 (the exact check of the same dataflow).
template <int BN, int STAGES, class Down>
static int mlp(const void* z, const void* w1_t, const float* b1, const void* w2_t,
               const float* b2, const void* res, Down down, void* h, void* out, int dtype,
               int m, int d, int hidden, int act, cudaStream_t s) {
  if (dtype == F32) {
    const Epilogue up{b1, nullptr, 0, nullptr, act, row_major(h), F32};
    cudaError_t err = launch_gemm(row_major(z), w1_t, F32, true, up, m, hidden, d, s);
    if (err != cudaSuccess) return (int)err;
    const Epilogue fc2{b2, res, F32, nullptr, ACT_NONE, row_major(out), F32};
    return (int)launch_gemm(row_major(h), w2_t, F32, true, fc2, m, d, hidden, s);
  }
  if (dtype != BF16) return (int)cudaErrorInvalidValue;
  hopper::TmaMatrix ta, to;
  cudaError_t err = flat(ta, z, d, to, h, hidden, m);
  if (err == cudaSuccess)
    err = hidden_product<hopper::BiasActEpilogue>(ta, w1_t, to, act, m, hidden, d, s, b1);
  if (err == cudaSuccess) err = flat(ta, h, hidden, to, Down::DIRECT ? nullptr : out, d, m);
  if (err != cudaSuccess) return (int)err;
  return (int)hopper::gemm<BN, STAGES>(ta, w2_t, Down::DIRECT ? hopper::TmaMatrix{} : to, down,
                                       1, m, d, hidden, s);
}

// The MLP's dx products, written once for K8's and K10's backward:
//   a    = z @ W1 + b1 (float32, recomputed)           [m, hidden]
//   dpre = (g @ W2^T) * act'(a) -> T                   [m, hidden]
//   out  = dpre @ W1^T                                 [m, d]
// bf16: a from registers (StoreF32Epilogue, 256 x 3), dpre by
// hidden_product's staged ActGradEpilogue (reading a back in row order),
// the last product on BN x STAGES through the caller's epilogue `back`:
// float32 dz for K8's LayerNorm backward (StoreF32Epilogue, DIRECT) or bf16
// dx by TMA store into out (K10, NoEpilogue). w1_t [hidden, d] = W1^T, w1
// [d, hidden] and w2 [hidden, d] as stored (each read as [cols, K]), in
// `dtype`. Each output element is one thread's sum in a fixed order (no
// atomics): two calls are bitwise equal. float32: the SIMT GEMM, out
// float32.
template <int BN, int STAGES, class Back>
static int mlp_bwd(const void* z, const void* w1_t, const float* b1, const void* w1,
                   const void* w2, const void* g, float* a, void* dpre, Back back, void* out,
                   int dtype, int m, int d, int hidden, int act, cudaStream_t s) {
  cudaError_t err;
  if (dtype == F32) {
    const Epilogue pre{b1, nullptr, 0, nullptr, ACT_NONE, row_major(a), F32};
    err = launch_gemm(row_major(z), w1_t, F32, true, pre, m, hidden, d, s);
    if (err != cudaSuccess) return (int)err;
    const Epilogue dact{nullptr, nullptr, 0, a, act, row_major(dpre), F32};
    err = launch_gemm(row_major(g), w2, F32, true, dact, m, hidden, d, s);
    if (err != cudaSuccess) return (int)err;
    const Epilogue dx{nullptr, nullptr, 0, nullptr, ACT_NONE, row_major(out), F32};
    return (int)launch_gemm(row_major(dpre), w1, F32, true, dx, m, d, hidden, s);
  }
  if (dtype != BF16) return (int)cudaErrorInvalidValue;
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
  if ((err = flat(ta, dpre, hidden, to, Back::DIRECT ? nullptr : out, d, m)) != cudaSuccess)
    return (int)err;
  return (int)hopper::gemm<BN, STAGES>(ta, w1, Back::DIRECT ? none : to, back, 1, m, d, hidden,
                                       s);
}

// The attention sublayer's float32 sum, K1's and K6 post-LN's:
//   cat = concat_h softmax(q k^T * scale + key_bias [+ causal]) v -> T
//   y32 = x + cat @ Wo + bo (float32, not rounded)
// K7 reads q, k, v [B, H, N, dh] at element strides (sb, sh, sn) and writes
// the head concat row-major into cat [B*N, D]; the o-product's staged
// epilogue (ResidualEpilogue<bf16, true>) adds bo and the residual x [B*N,
// D] at the output's own row and stores the sum in float32, on 192-column
// tiles in a 3-deep ring (tools/epilogue_bench.cu, H100 80GB HBM3 at 700 W:
// 0.2667 ms against 0.2758 at 128 x 4 for BERT's [256 * 256, 768], a tie at
// serving's [32 * 197, 768], 0.0570 against 0.0522 for the CLIP text
// cache's [256 * 77, 512]). wo_t [D, D] = Wo^T in `dtype`; key_bias [B, N]
// float32 (keys >= n_real folded in) or null. float32: K7's float32 kernel and
// the SIMT GEMM.
static inline int attn_o_f32(const void* q, const void* k, const void* v, int sb, int sh,
                             int sn, const float* key_bias, int causal, const void* x,
                             const void* wo_t, const float* bo, void* cat, float* y32, int dtype,
                             int b, int n, int heads, int dh, float scale, cudaStream_t s) {
  const int m = b * n, d = heads * dh;
  int err = nx_flash_attention(q, k, v, cat, key_bias, nullptr, dtype, b, heads, n, dh, sb, sh,
                               sn, n * d, dh, d, causal, scale, s);
  if (err) return err;
  if (dtype == F32) {
    const Epilogue epi{bo, x, F32, nullptr, ACT_NONE, row_major(y32), F32};
    return (int)launch_gemm(row_major(cat), wo_t, F32, true, epi, m, d, d, s);
  }
  if (dtype != BF16) return (int)cudaErrorInvalidValue;
  hopper::TmaMatrix ta;
  const cudaError_t e = hopper::rows_matrix(ta, cat, 1, m, d, hopper::BM);
  if (e != cudaSuccess) return (int)e;
  const hopper::ResidualEpilogue<__nv_bfloat16, true> epi{
      bo, static_cast<const __nv_bfloat16*>(x), d, y32};
  return (int)hopper::gemm<192, 3>(ta, wo_t, hopper::TmaMatrix{}, epi, 1, m, d, d, s);
}

}  // namespace nx
