// Pre-norm transformer block forward for Hopper (sm_90a), as a small family
// of kernels driven in order by ops/fused_block.py::fused_block_infer:
//
//   z   = LN1(x)                       layernorm_rows     (f32 stats) -> T
//   qkv = z @ [Wq|Wk|Wv] + b           gemm               -> T
//   cat = softmax(q k^T / sqrt(dh)) v  attention_kernel   (f32 scores) -> T
//   y32 = cat @ Wo + bo + x            gemm               -> f32 scratch
//   z2  = LN2(y32)                     layernorm_rows     -> T
//   h   = act(z2 @ W1 + b1)            gemm               -> T
//   out = h @ W2 + b2 + y32            gemm               -> T
//
// Replaces nextgen_uia_tpu/ops/fused_block.py::fused_block_infer (the Pallas
// kernel _fwd_kernel), pre-norm and non-causal only. The rounding points are
// that kernel's: z, q/k/v, the probabilities, the head concat, z2 and h are
// rounded to the storage type T; y32 and the fc2 accumulation stay float32
// and the output is rounded once.
//
// What bounds it on the H100: at the serving shape (B*N = 32*197 rows,
// D = 768, hidden 3072) the four products hold ~99% of the block's
// 2*M*12*D^2 + 4*B*H*N^2*dh operations, so the block is compute-bound. The
// TPU kernel keeps every weight matrix resident in 64 MB of VMEM; a Hopper
// block has 227 KB of shared memory (one [768,768] bf16 matrix is 1.2 MB),
// so the port streams weight tiles through shared memory per output tile and
// passes activations between launches through device memory (the 50 MB L2
// holds most of them at this size).
//
// Design: the bf16 product is a 128x128x32-tiled WMMA (mma.sync 16x16x16,
// float32 accumulation) kernel fed by a 3-stage cp.async ring, with the
// bias, exact-erf GELU or quick_gelu and an optional residual fused into its
// epilogue; float32 inputs take a 64x64 SIMT tile, so the float32 path stays
// exact float32 (no TF32). Attention runs one CTA per (image, head, 32-query
// tile) with that head's K (transposed) and V in shared memory in the
// storage type; each warp owns 4 query rows, so every K/V read feeds 4
// multiply-adds: scores and softmax in float32, keys >= n_real masked,
// key_bias added, attention on SIMT cores. The ragged edges (N = 197,
// M = 6304) are masked in the kernels; nothing is padded. Still simple: no
// TMA, no wgmma, no warp specialisation, attention off the tensor cores.

#include <cfloat>

#include <mma.h>

#include "common.cuh"

namespace nx {

enum Act : int { ACT_NONE = 0, ACT_GELU = 1, ACT_QUICK_GELU = 2 };

// ---------------------------------------------------------------------------
// LayerNorm over rows, float32 statistics: one warp per row
// ---------------------------------------------------------------------------

template <typename TI, typename TO>
__global__ void layernorm_rows(const TI* __restrict__ x, const float* __restrict__ g,
                               const float* __restrict__ b, TO* __restrict__ out,
                               int rows, int cols, float eps) {
  const int row = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;
  const TI* xr = x + (size_t)row * cols;
  float s = 0.f;
  for (int c = lane; c < cols; c += 32) s += to_f32(xr[c]);
  const float mean = warp_sum(s) / cols;
  float v = 0.f;
  for (int c = lane; c < cols; c += 32) {
    const float d = to_f32(xr[c]) - mean;
    v += d * d;
  }
  const float rstd = rsqrtf(warp_sum(v) / cols + eps);
  TO* orow = out + (size_t)row * cols;
  for (int c = lane; c < cols; c += 32)
    orow[c] = from_f32<TO>((to_f32(xr[c]) - mean) * rstd * g[c] + b[c]);
}

// ---------------------------------------------------------------------------
// GEMM: out[M,N] = epilogue(A[M,K] @ W[K,N]); W row-major [in, out]
// ---------------------------------------------------------------------------

struct Epilogue {
  const float* bias;  // [N] float32
  const void* res;    // [M,N] or null
  int res_dtype;
  void* out;          // [M,N]
  int out_dtype;
  int act;

  __device__ __forceinline__ void apply(float v, int r, int c, int n) const {
    v += bias[c];
    if (act == ACT_GELU) v = 0.5f * v * (1.f + erff(v * 0.7071067811865476f));
    else if (act == ACT_QUICK_GELU) v = v / (1.f + expf(-1.702f * v));
    const size_t i = (size_t)r * n + c;
    if (res) v += load_f32(res, res_dtype, i);
    store_f32(out, out_dtype, i, v);
  }
};

// float32 SIMT tile: 64x64 outputs per CTA, 16x16 threads x 4x4 each
constexpr int SBM = 64, SBN = 64, SBK = 16;

__global__ void __launch_bounds__(256)
gemm_f32(const float* __restrict__ A, const float* __restrict__ W, Epilogue epi,
         int M, int N, int K) {
  __shared__ float As[SBK][SBM + 4];  // A tile, transposed: As[k][row]
  __shared__ float Ws[SBK][SBN];
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int row0 = blockIdx.y * SBM, col0 = blockIdx.x * SBN;
  float acc[4][4] = {};
  for (int k0 = 0; k0 < K; k0 += SBK) {
    for (int i = tid; i < SBM * SBK; i += 256) {
      const int r = i / SBK, c = i % SBK, gr = row0 + r;
      As[c][r] = gr < M ? A[(size_t)gr * K + k0 + c] : 0.f;
    }
    for (int i = tid; i < SBK * SBN; i += 256) {
      const int r = i / SBN, c = i % SBN;
      Ws[r][c] = W[(size_t)(k0 + r) * N + col0 + c];
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < SBK; ++kk) {
      float a[4], w[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = As[kk][ty * 4 + i];
#pragma unroll
      for (int j = 0; j < 4; ++j) w[j] = Ws[kk][tx * 4 + j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], w[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = row0 + ty * 4 + i;
    if (r >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) epi.apply(acc[i][j], r, col0 + tx * 4 + j, N);
  }
}

// bf16 tensor-core tile: 128x128 outputs per CTA, 8 warps as 2 (rows) x 4
// (cols), each warp 64x32 = 4x2 WMMA 16x16x16 fragments, K step 32. The A
// and W tiles stream through a 3-stage cp.async ring in dynamic shared
// memory, so the copies of the next two K steps overlap this step's MMAs.
constexpr int WBM = 128, WBN = 128, WBK = 32, WSTAGES = 3;
constexpr int A_LD = WBK + 8, W_LD = WBN + 8;  // padded strides (bf16 elements)
constexpr int A_STAGE = WBM * A_LD, W_STAGE = WBK * W_LD;
constexpr int GEMM_SMEM = WSTAGES * (A_STAGE + W_STAGE) * 2;

__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int bytes = valid ? 16 : 0;  // 0: zero-fill, nothing read
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__global__ void __launch_bounds__(256)
gemm_bf16(const __nv_bfloat16* __restrict__ A, const __nv_bfloat16* __restrict__ W,
          Epilogue epi, int M, int N, int K) {
  using namespace nvcuda;
  extern __shared__ __align__(128) unsigned char gemm_smem[];
  __nv_bfloat16* As = reinterpret_cast<__nv_bfloat16*>(gemm_smem);  // [stage][WBM][A_LD]
  __nv_bfloat16* Ws = As + WSTAGES * A_STAGE;                         // [stage][WBK][W_LD]

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int wm = warp / 4, wn = warp % 4;
  const int row0 = blockIdx.y * WBM, col0 = blockIdx.x * WBN;
  const int k_tiles = K / WBK;

  // one K step: A 128x32 and W 32x128, 512 16-byte chunks each, 2 + 2 per
  // thread; rows >= M and columns >= N are zero-filled
  auto load_tile = [&](int stage, int kt) {
    const int k0 = kt * WBK;
    __nv_bfloat16* as = As + stage * A_STAGE;
    __nv_bfloat16* ws = Ws + stage * W_STAGE;
#pragma unroll
    for (int v = tid; v < WBM * WBK / 8; v += 256) {
      const int r = v / (WBK / 8), c = (v % (WBK / 8)) * 8, gr = row0 + r;
      cp_async16(as + r * A_LD + c, A + (size_t)(gr < M ? gr : 0) * K + k0 + c, gr < M);
    }
#pragma unroll
    for (int v = tid; v < WBK * WBN / 8; v += 256) {
      const int r = v / (WBN / 8), c = (v % (WBN / 8)) * 8, gc = col0 + c;
      cp_async16(ws + r * W_LD + c, W + (size_t)(k0 + r) * N + (gc < N ? gc : 0), gc < N);
    }
  };

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[4][2];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);

#pragma unroll
  for (int s = 0; s < WSTAGES - 1; ++s) {
    if (s < k_tiles) load_tile(s, s);
    cp_async_commit();
  }
  for (int kt = 0; kt < k_tiles; ++kt) {
    cp_async_wait<WSTAGES - 2>();  // this thread's copies of step kt have landed
    __syncthreads();               // everyone's have; step kt-1's buffer is free
    const int next = kt + WSTAGES - 1;
    if (next < k_tiles) load_tile(next % WSTAGES, next);
    cp_async_commit();
    const __nv_bfloat16* as = As + (kt % WSTAGES) * A_STAGE;
    const __nv_bfloat16* ws = Ws + (kt % WSTAGES) * W_STAGE;
#pragma unroll
    for (int kk = 0; kk < WBK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a[4];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> b[2];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        wmma::load_matrix_sync(a[i], as + (wm * 64 + i * 16) * A_LD + kk, A_LD);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(b[j], ws + kk * W_LD + wn * 32 + j * 16, W_LD);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], a[i], b[j], acc[i][j]);
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring is free: each warp stages its fragments in 1 KB of it

  float* wbuf = reinterpret_cast<float*>(gemm_smem) + warp * 256;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      wmma::store_matrix_sync(wbuf, acc[i][j], 16, wmma::mem_row_major);
      __syncwarp();
      const int r0 = row0 + wm * 64 + i * 16, c0 = col0 + wn * 32 + j * 16;
      for (int e = lane; e < 256; e += 32) {
        const int r = r0 + e / 16, c = c0 + e % 16;
        if (r < M && c < N) epi.apply(wbuf[e], r, c, N);
      }
      __syncwarp();
    }
}

// ---------------------------------------------------------------------------
// Attention: one CTA per (query tile, head, image); K^T and V in shared memory
// ---------------------------------------------------------------------------

// Each warp owns ATT_ROWS query rows at once, so every K and V element read
// from shared memory feeds ATT_ROWS multiply-adds; 8 warps x 4 rows = one
// 32-row query tile per CTA. Needs dh % 4 == 0 and dh <= 64.
constexpr int ATT_THREADS = 256, ATT_ROWS = 4, ATT_WARPS = ATT_THREADS / 32;
constexpr int ATT_QTILE = ATT_WARPS * ATT_ROWS;

// shared memory: Qs [warps][rows][dh] f32 | Ps [warps][rows][n] f32 |
// Kt [dh][n | 1] T | Vs [n][dh] T
inline size_t attention_smem(int n, int dh, size_t t_size) {
  const int nk = n | 1;  // odd stride: the transposed K stores hit distinct banks
  return sizeof(float) * ATT_WARPS * ATT_ROWS * ((size_t)dh + n) +
         t_size * ((size_t)dh * nk + (size_t)n * dh);
}

template <typename T>
__global__ void __launch_bounds__(ATT_THREADS)
attention_kernel(const T* __restrict__ qkv, const float* __restrict__ key_bias,
                 T* __restrict__ out, int n, int heads, int dh, int n_real, float scale) {
  extern __shared__ __align__(16) float sm[];
  const int nk = n | 1;
  float* Qs = sm;
  float* Ps = Qs + ATT_WARPS * ATT_ROWS * dh;
  T* Kt = reinterpret_cast<T*>(Ps + ATT_WARPS * ATT_ROWS * n);
  T* Vs = Kt + dh * nk;

  const int b = blockIdx.z, h = blockIdx.y;
  const int d_model = heads * dh, ld = 3 * d_model;
  const T* base = qkv + (size_t)b * n * ld;
  for (int i = threadIdx.x; i < n * dh; i += ATT_THREADS) {
    const int k = i / dh, d = i % dh;
    Kt[d * nk + k] = base[(size_t)k * ld + d_model + h * dh + d];
    Vs[k * dh + d] = base[(size_t)k * ld + 2 * d_model + h * dh + d];
  }
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int i0 = blockIdx.x * ATT_QTILE + warp * ATT_ROWS;
  if (i0 >= n) return;  // no block-wide barrier follows
  const int rows = min(ATT_ROWS, n - i0);
  float* q = Qs + warp * ATT_ROWS * dh;  // [rows][dh]; rows past n are zero
  float* p = Ps + warp * ATT_ROWS * n;   // [rows][n]
  for (int e = lane; e < ATT_ROWS * dh; e += 32) {
    const int r = e / dh, d = e % dh;
    q[e] = r < rows ? to_f32(base[(size_t)(i0 + r) * ld + h * dh + d]) : 0.f;
  }
  __syncwarp();

  const float* kb = key_bias ? key_bias + (size_t)b * n : nullptr;
  float mx[ATT_ROWS], sum[ATT_ROWS];
#pragma unroll
  for (int r = 0; r < ATT_ROWS; ++r) mx[r] = -FLT_MAX, sum[r] = 0.f;
  for (int k = lane; k < n; k += 32) {
    float s[ATT_ROWS] = {};
    for (int d = 0; d < dh; d += 4) {
      const float k0 = to_f32(Kt[d * nk + k]), k1 = to_f32(Kt[(d + 1) * nk + k]);
      const float k2 = to_f32(Kt[(d + 2) * nk + k]), k3 = to_f32(Kt[(d + 3) * nk + k]);
#pragma unroll
      for (int r = 0; r < ATT_ROWS; ++r) {
        const float4 qv = *reinterpret_cast<const float4*>(q + r * dh + d);
        s[r] = fmaf(qv.x, k0, s[r]);
        s[r] = fmaf(qv.y, k1, s[r]);
        s[r] = fmaf(qv.z, k2, s[r]);
        s[r] = fmaf(qv.w, k3, s[r]);
      }
    }
#pragma unroll
    for (int r = 0; r < ATT_ROWS; ++r) {
      float v = s[r] * scale;
      if (k >= n_real) v = -1e30f;
      if (kb) v += kb[k];
      p[r * n + k] = v;
      mx[r] = fmaxf(mx[r], v);
    }
  }
#pragma unroll
  for (int r = 0; r < ATT_ROWS; ++r) mx[r] = warp_max(mx[r]);
  for (int k = lane; k < n; k += 32) {
#pragma unroll
    for (int r = 0; r < ATT_ROWS; ++r) {
      const float e = expf(p[r * n + k] - mx[r]);
      p[r * n + k] = e;
      sum[r] += e;
    }
  }
#pragma unroll
  for (int r = 0; r < ATT_ROWS; ++r) sum[r] = warp_sum(sum[r]);
  for (int k = lane; k < n; k += 32) {
#pragma unroll
    for (int r = 0; r < ATT_ROWS; ++r) p[r * n + k] = round_to<T>(p[r * n + k] / sum[r]);
  }
  __syncwarp();

  // lane owns output columns d = lane and lane + 32
  const int d0 = lane, d1 = lane + 32;
  const bool has1 = d1 < dh;
  float o0[ATT_ROWS] = {}, o1[ATT_ROWS] = {};
  for (int k = 0; k < n; ++k) {
    const float v0 = to_f32(Vs[k * dh + d0]);
    const float v1 = has1 ? to_f32(Vs[k * dh + d1]) : 0.f;
#pragma unroll
    for (int r = 0; r < ATT_ROWS; ++r) {
      const float pk = p[r * n + k];
      o0[r] = fmaf(pk, v0, o0[r]);
      o1[r] = fmaf(pk, v1, o1[r]);
    }
  }
#pragma unroll
  for (int r = 0; r < ATT_ROWS; ++r) {
    if (r >= rows) break;
    T* orow = out + ((size_t)b * n + i0 + r) * d_model + h * dh;
    orow[d0] = from_f32<T>(o0[r]);
    if (has1) orow[d1] = from_f32<T>(o1[r]);
  }
}

template <typename T>
cudaError_t launch_attention(const void* qkv, const float* key_bias, void* out, int b,
                             int n, int heads, int dh, int n_real, float scale,
                             cudaStream_t stream) {
  if (dh % 4 || dh > 64 || dh < 32) return cudaErrorInvalidValue;
  const size_t smem = attention_smem(n, dh, sizeof(T));
  cudaError_t err = cudaFuncSetAttribute(attention_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((n + ATT_QTILE - 1) / ATT_QTILE, heads, b);
  attention_kernel<T><<<grid, ATT_THREADS, smem, stream>>>(
      static_cast<const T*>(qkv), key_bias, static_cast<T*>(out), n, heads, dh, n_real,
      scale);
  return cudaGetLastError();
}

}  // namespace nx

using namespace nx;

extern "C" {

const char* nx_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

// out[rows, cols] = LN(x) * gamma + beta; (x, out) dtypes: (bf16, bf16),
// (f32, bf16) or (f32, f32)
int nx_layernorm(const void* x, int x_dtype, const float* gamma, const float* beta,
                 void* out, int out_dtype, int rows, int cols, float eps, void* stream) {
  const int threads = 256, rows_per_block = threads / 32;
  const dim3 grid((rows + rows_per_block - 1) / rows_per_block);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_dtype == BF16 && out_dtype == BF16)
    layernorm_rows<<<grid, threads, 0, s>>>(static_cast<const __nv_bfloat16*>(x), gamma,
                                            beta, static_cast<__nv_bfloat16*>(out), rows,
                                            cols, eps);
  else if (x_dtype == F32 && out_dtype == BF16)
    layernorm_rows<<<grid, threads, 0, s>>>(static_cast<const float*>(x), gamma, beta,
                                            static_cast<__nv_bfloat16*>(out), rows, cols,
                                            eps);
  else if (x_dtype == F32 && out_dtype == F32)
    layernorm_rows<<<grid, threads, 0, s>>>(static_cast<const float*>(x), gamma, beta,
                                            static_cast<float*>(out), rows, cols, eps);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

// out[M, N] = act(a[M, K] @ w[K, N] + bias) (+ res); a and w share `dtype`;
// needs N % 64 == 0, K % 32 == 0, 16-byte aligned a and w
int nx_gemm(const void* a, const void* w, int dtype, const float* bias, const void* res,
            int res_dtype, void* out, int out_dtype, int act, int M, int N, int K,
            void* stream) {
  const Epilogue epi{bias, res, res_dtype, out, out_dtype, act};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == BF16) {
    const cudaError_t err = cudaFuncSetAttribute(
        gemm_bf16, cudaFuncAttributeMaxDynamicSharedMemorySize, GEMM_SMEM);
    if (err != cudaSuccess) return (int)err;
    const dim3 grid((N + WBN - 1) / WBN, (M + WBM - 1) / WBM);
    gemm_bf16<<<grid, 256, GEMM_SMEM, s>>>(static_cast<const __nv_bfloat16*>(a),
                                           static_cast<const __nv_bfloat16*>(w), epi, M,
                                           N, K);
  } else if (dtype == F32) {
    const dim3 grid(N / SBN, (M + SBM - 1) / SBM);
    gemm_f32<<<grid, 256, 0, s>>>(static_cast<const float*>(a),
                                  static_cast<const float*>(w), epi, M, N, K);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// out[B*N, H*dh] = per-head softmax(q k^T * scale + mask + key_bias) v over
// qkv[B*N, 3*H*dh] (q | k | v); key_bias [B, N] float32 or null
int nx_attention(const void* qkv, const float* key_bias, void* out, int dtype, int b,
                 int n, int heads, int dh, int n_real, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == BF16)
    return (int)launch_attention<__nv_bfloat16>(qkv, key_bias, out, b, n, heads, dh,
                                                n_real, scale, s);
  if (dtype == F32)
    return (int)launch_attention<float>(qkv, key_bias, out, b, n, heads, dh, n_real,
                                        scale, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
