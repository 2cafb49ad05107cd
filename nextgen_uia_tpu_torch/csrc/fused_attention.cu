// The attention block with frozen weights, forward and dx backward, for
// Hopper (sm_90a), on already-normed x [B, N, D] with H heads of dh:
//
//   forward:  q, k, v = x Wq + bq, x Wk + bk, x Wv + bv -> T (head-major)
//             cat = concat_h softmax(q_h k_h^T / sqrt(dh) + bias [+ causal]) v_h -> T
//             out = cat Wo + bo -> T
//   backward: q, k, v recomputed; the attention forward again for its
//             output and each row's log-sum-exp; doh = g Wo^T -> T
//             (head-major); dq, dk, dv by the flash-attention backward;
//             dx = [dq | dk | dv] [Wq | Wk | Wv]^T -> T
//
// Replaces nextgen_uia_tpu/ops/fused_attention.py: the Pallas kernels
// _fwd_kernel (pallas_call in _fwd_impl, the forward of fused_attn_block)
// and _bwd_kernel (pallas_call in _bwd_rule, the backward that
// fused_attn_block and hybrid_attn_block share). Weights and biases are
// frozen: no weight gradients, as on the TPU. The key bias is added after
// the scale, the causal mask (-1e30 above the diagonal) after the bias.
//
// What bounds it on the H100: at the bench's shape ([64, 197, 768], 12
// heads) the forward is 4 projections (2 * 12608 * 768^2 * 4 = 59.5 GFLOP)
// plus attention (4 * 64 * 12 * 197^2 * 64 = 7.6 GFLOP), 0.068 ms at the
// bf16 peak against 0.012 ms for x, the weights and the output; the
// backward ~127 GFLOP with the recompute (0.128 ms). So operations bound
// both.
//
// Design. The TPU kernel keeps a chunk of 8 images' q, k, v and one head's
// [N, N] scores in VMEM and loops the heads in the kernel, so q, k and v
// never reach HBM. This first version is built from the port's existing
// device code under C entries of its own: the WMMA GEMM of
// block_kernels.cuh with its head-major store (q, k, v and doh), the
// mma.sync flash-attention forward and backward of flash_attention.cu
// (nx_flash_attention, nx_flash_attention_bwd), and the GEMM with a
// head-major A operand for dx. q, k, v, the head concat and their
// gradients cross device memory (~58 MB each way at the bench's shape);
// keeping them on chip, as the TPU kernel does, is a later step. The
// recomputed forward in the backward costs an attention forward more than
// saving its output, which is what the TPU kernel's structure does too.

#include "block_kernels.cuh"

using namespace nx;

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

namespace {

// q, k, v [B, H, N, dh] = x @ [Wq | Wk | Wv] + [bq | bk | bv]
int qkv_proj(const void* x, const void* wqkv, const float* bqkv, void* q, void* k, void* v,
             int dtype, int b, int n, int heads, int dh, cudaStream_t s) {
  const int m = b * n, d = heads * dh;
  const Epilogue epi{bqkv, nullptr, 0, nullptr, ACT_NONE, head_major(q, k, v, n, heads, dh),
                     dtype};
  return (int)launch_gemm(row_major(x), wqkv, dtype, false, epi, m, 3 * d, d, s);
}

}  // namespace

extern "C" {

// x, out [B*N, D] in `dtype`; wqkv [D, 3D] and wo [D, D] in `dtype`; bqkv
// [3D] and bo [D] float32; key_bias [B, N] float32 or null; scratch q, k, v
// [B, H, N, dh] and cat [B*N, D] in `dtype`.
int nx_fused_attn_fwd(const void* x, const void* wqkv, const float* bqkv, const void* wo,
                      const float* bo, const float* key_bias, void* q, void* k, void* v,
                      void* cat, void* out, int dtype, int b, int n, int heads, int dh,
                      int causal, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int m = b * n, d = heads * dh;
  int err = qkv_proj(x, wqkv, bqkv, q, k, v, dtype, b, n, heads, dh, s);
  if (err) return err;
  // the head concat [B, N, H, dh] is row-major [B*N, D]
  err = nx_flash_attention(q, k, v, cat, key_bias, nullptr, dtype, b, heads, n, dh, heads * n * dh,
                           n * dh, dh, n * d, dh, d, causal, scale, stream);
  if (err) return err;
  const Epilogue epi{bo, nullptr, 0, nullptr, ACT_NONE, row_major(out), dtype};
  return (int)launch_gemm(row_major(cat), wo, dtype, false, epi, m, d, d, s);
}

// g, dx [B*N, D] in `dtype`; scratch q, k, v, o, doh, dq, dk, dv [B, H, N,
// dh] in `dtype`, lse and delta [B, H, N] float32.
int nx_fused_attn_bwd(const void* x, const void* wqkv, const float* bqkv, const void* wo,
                      const float* key_bias, const void* g, void* q, void* k, void* v, void* o,
                      float* lse, void* doh, float* delta, void* dq, void* dk, void* dv,
                      void* dx, int dtype, int b, int n, int heads, int dh, int causal,
                      float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int m = b * n, d = heads * dh;
  const int sb = heads * n * dh, sh = n * dh, sn = dh;  // head-major strides
  int err = qkv_proj(x, wqkv, bqkv, q, k, v, dtype, b, n, heads, dh, s);
  if (err) return err;
  err = nx_flash_attention(q, k, v, o, key_bias, lse, dtype, b, heads, n, dh, sb, sh, sn, sb, sh,
                           sn, causal, scale, stream);
  if (err) return err;
  // doh [B, H, N, dh] = g @ Wo^T
  const Epilogue dohe{nullptr, nullptr, 0, nullptr, ACT_NONE, head_major(doh, nullptr, nullptr, n,
                                                                         heads, dh), dtype};
  if ((err = (int)launch_gemm(row_major(g), wo, dtype, true, dohe, m, d, d, s))) return err;
  err = nx_flash_attention_bwd(q, k, v, o, doh, lse, key_bias, dq, dk, dv, nullptr, delta, dtype,
                               b, heads, n, dh, sb, sh, sn, sb, sh, sn, causal, scale, stream);
  if (err) return err;
  // dx = [dq | dk | dv] @ [Wq | Wk | Wv]^T
  const Epilogue dxe{nullptr, nullptr, 0, nullptr, ACT_NONE, row_major(dx), dtype};
  return (int)launch_gemm(head_major(dq, dk, dv, n, heads, dh), wqkv, dtype, true, dxe, m, d,
                          3 * d, s);
}

}  // extern "C"
