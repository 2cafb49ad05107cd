// The transformer-block building blocks every block kernel of the port is cut
// from: LayerNorm forward and backward over rows and a GEMM with a fused
// epilogue (bf16 tensor cores, or float32 SIMT so the float32 path stays
// exact). The LayerNorms serve K1, K5, K6, K8 and K9 in both dtypes; the
// float32 paths of every block kernel (and of K12's up and dgd products)
// run the SIMT GEMM, so they share one implementation. The bf16 products
// all run on hopper_gemm.cuh (and K12's weight gradients on its own wgmma
// kernel), their attention on flash_attention.cu's K7: no path of the port
// runs the bf16 WMMA GEMM, which nx_gemm keeps as chip_smoke.py's
// yardstick. Everything here is a template or `static`, so each .cu that includes
// the header builds on its own (the sources compile in parallel) and the
// objects link without clashes.
//
// Layouts: activations are row-major [rows, cols]; weights are the JAX
// package's [in, out] row-major. A GEMM reads its weight either as stored
// (out = A @ W) or transposed (out = A @ W^T, the backward's products), and
// its A operand and output either row-major or "head-major": the logical
// column c of a [B*N, S*H*dh] matrix lives in segment t = c / (H*dh) at
// ptr[t][((b*H + h)*N + n)*dh + e], the [B, H, N, dh] layout the attention
// kernels exchange (q, k, v and their gradients).

#pragma once

#include <cfloat>
#include <type_traits>

#include <mma.h>

#include "common.cuh"

namespace nx {

// ---------------------------------------------------------------------------
// LayerNorm over rows, float32 statistics: one warp per row
// ---------------------------------------------------------------------------

template <typename TI>
__device__ __forceinline__ void row_stats(const TI* xr, int cols, int lane, float eps,
                                          float& mean, float& rstd) {
  float s = 0.f;
  for (int c = lane; c < cols; c += 32) s += to_f32(xr[c]);
  mean = warp_sum(s) / cols;
  float v = 0.f;
  for (int c = lane; c < cols; c += 32) {
    const float d = to_f32(xr[c]) - mean;
    v += d * d;
  }
  rstd = rsqrtf(warp_sum(v) / cols + eps);
}

template <typename TI, typename TO>
__global__ void layernorm_rows(const TI* __restrict__ x, const float* __restrict__ g,
                               const float* __restrict__ b, TO* __restrict__ out,
                               int rows, int cols, float eps) {
  const int row = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;
  const TI* xr = x + (size_t)row * cols;
  float mean, rstd;
  row_stats(xr, cols, lane, eps, mean, rstd);
  TO* orow = out + (size_t)row * cols;
  for (int c = lane; c < cols; c += 32)
    orow[c] = from_f32<TO>((to_f32(xr[c]) - mean) * rstd * g[c] + b[c]);
}

// The post-norm residual stream: LN of float32 rows into float32 `out32` and,
// when `out_t` is given, the same values rounded to T (the next product's
// operand) in the same pass
template <typename T>
__global__ void layernorm_rows_dual(const float* __restrict__ x, const float* __restrict__ g,
                                    const float* __restrict__ b, float* __restrict__ out32,
                                    T* __restrict__ out_t, int rows, int cols, float eps) {
  const int row = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;
  const float* xr = x + (size_t)row * cols;
  float mean, rstd;
  row_stats(xr, cols, lane, eps, mean, rstd);
  for (int c = lane; c < cols; c += 32) {
    const float v = (xr[c] - mean) * rstd * g[c] + b[c];
    out32[(size_t)row * cols + c] = v;
    if (out_t) out_t[(size_t)row * cols + c] = from_f32<T>(v);
  }
}

// dx = (dxhat - mean(dxhat) - xhat * mean(dxhat * xhat)) * rstd (+ res),
// dxhat = dz * gamma, statistics recomputed in float32 from x
template <typename T>
__global__ void layernorm_bwd_rows(const T* __restrict__ x, const float* __restrict__ g,
                                   const float* __restrict__ dz, const T* __restrict__ res,
                                   T* __restrict__ dx, int rows, int cols, float eps) {
  const int row = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;
  const T* xr = x + (size_t)row * cols;
  const float* dzr = dz + (size_t)row * cols;
  float mean, rstd;
  row_stats(xr, cols, lane, eps, mean, rstd);
  float m1 = 0.f, m2 = 0.f;
  for (int c = lane; c < cols; c += 32) {
    const float dxh = dzr[c] * g[c];
    m1 += dxh;
    m2 += dxh * (to_f32(xr[c]) - mean) * rstd;
  }
  m1 = warp_sum(m1) / cols;
  m2 = warp_sum(m2) / cols;
  T* orow = dx + (size_t)row * cols;
  const T* rr = res ? res + (size_t)row * cols : nullptr;
  for (int c = lane; c < cols; c += 32) {
    const float xhat = (to_f32(xr[c]) - mean) * rstd;
    float v = (dzr[c] * g[c] - m1 - xhat * m2) * rstd;
    if (rr) v += to_f32(rr[c]);
    orow[c] = from_f32<T>(v);
  }
}

template <typename TI, typename TO>
static cudaError_t launch_layernorm(const void* x, const float* g, const float* b, void* out,
                                    int rows, int cols, float eps, cudaStream_t s) {
  const int threads = 256, per_block = threads / 32;
  layernorm_rows<<<(rows + per_block - 1) / per_block, threads, 0, s>>>(
      static_cast<const TI*>(x), g, b, static_cast<TO*>(out), rows, cols, eps);
  return cudaGetLastError();
}

template <typename T>
static cudaError_t launch_layernorm_dual(const float* x, const float* g, const float* b,
                                         float* out32, void* out_t, int rows, int cols,
                                         float eps, cudaStream_t s) {
  const int threads = 256, per_block = threads / 32;
  layernorm_rows_dual<T><<<(rows + per_block - 1) / per_block, threads, 0, s>>>(
      x, g, b, out32, static_cast<T*>(out_t), rows, cols, eps);
  return cudaGetLastError();
}

template <typename T>
static cudaError_t launch_layernorm_bwd(const void* x, const float* g, const float* dz,
                                        const void* res, void* dx, int rows, int cols,
                                        float eps, cudaStream_t s) {
  const int threads = 256, per_block = threads / 32;
  layernorm_bwd_rows<<<(rows + per_block - 1) / per_block, threads, 0, s>>>(
      static_cast<const T*>(x), g, dz, static_cast<const T*>(res), static_cast<T*>(dx), rows,
      cols, eps);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// GEMM operands and epilogue
// ---------------------------------------------------------------------------

// A logical [rows, cols] matrix: row-major at p0 (rows ld elements apart;
// launch_gemm sets a row_major operand's ld of 0 to its cols), or
// head-major segments (see the top of the file): seg = H * dh columns per
// pointer p0, p1, p2. The layout is a template flag of the kernels (HM), so
// the row-major path carries no index arithmetic; head_major here only
// selects the kernel.
struct Operand {
  const void* p0;
  const void* p1;
  const void* p2;
  int head_major;
  int seg, n_tok, heads, dh;
  int ld;

  // element offset of (r, c) in the pointer `base` it lives in
  template <bool HM>
  __device__ __forceinline__ size_t index(int r, int c, const void*& base) const {
    if (!HM) {
      base = p0;
      return (size_t)r * ld + c;
    }
    const int t = c / seg;
    const int cc = c - t * seg, h = cc / dh, e = cc - h * dh;
    const int b = r / n_tok, n = r - b * n_tok;
    base = t == 0 ? p0 : (t == 1 ? p1 : p2);
    return ((size_t)(b * heads + h) * n_tok + n) * dh + e;
  }
  template <bool HM, typename T>
  __device__ __forceinline__ const T* ptr(int r, int c) const {
    const void* base;
    const size_t i = index<HM>(r, c, base);
    return static_cast<const T*>(base) + i;
  }
};

// out = epilogue(acc): v += bias[c]; v *= act'(act_in) (backward, when
// act_in is given) or v = act(v) (forward); with round_mid, v rounded to
// out_dtype; v += res; stored to `out` in out_dtype
struct Epilogue {
  const float* bias;    // [N] float32 or null
  const void* res;      // [M, N] row-major or null
  int res_dtype;
  const float* act_in;  // [M, N] float32 pre-activation or null
  int act;
  Operand out;          // written through its pointers (const cast away)
  int out_dtype;
  int round_mid = 0;    // round to out_dtype before the residual (two rounding points)

  // OHM: head-major output; DACT: multiply by act'(act_in) (backward) in
  // place of applying act (forward)
  template <bool OHM, bool DACT>
  __device__ __forceinline__ void apply(float v, int r, int c, int n) const {
    if (bias) v += bias[c];
    const size_t i = (size_t)r * n + c;
    if (DACT) v *= act_grad(act, act_in[i]);
    else v = act_fwd(act, v);
    if (round_mid && out_dtype == BF16) v = round_to<__nv_bfloat16>(v);
    if (res) v += load_f32(res, res_dtype, i);
    const void* base;
    const size_t o = out.index<OHM>(r, c, base);
    store_f32(const_cast<void*>(base), out_dtype, o, v);
  }
};

// ---------------------------------------------------------------------------
// float32 SIMT GEMM: 64x64 outputs per CTA, 16x16 threads x 4x4 each.
// out[M, N] = A[M, K] @ B, B = W [K, N] or (BT) W^T with W stored [N, K].
// Needs N % 64 == 0 and K % 16 == 0.
// ---------------------------------------------------------------------------

constexpr int SBM = 64, SBN = 64, SBK = 16;

template <bool BT, bool AHM, bool OHM, bool DACT>
__global__ void __launch_bounds__(256)
gemm_f32(Operand A, const float* __restrict__ W, Epilogue epi, int M, int N, int K) {
  __shared__ float As[SBK][SBM + 4];  // A tile, transposed: As[k][row]
  __shared__ float Ws[SBK][SBN + 4];
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int row0 = blockIdx.y * SBM, col0 = blockIdx.x * SBN;
  float acc[4][4] = {};
  for (int k0 = 0; k0 < K; k0 += SBK) {
    for (int i = tid; i < SBM * SBK; i += 256) {
      const int r = i / SBK, c = i % SBK, gr = row0 + r;
      As[c][r] = gr < M ? *A.ptr<AHM, float>(gr, k0 + c) : 0.f;
    }
    for (int i = tid; i < SBK * SBN; i += 256) {
      if (BT) {  // consecutive threads walk W's rows (contiguous in k)
        const int c = i / SBK, r = i % SBK;
        Ws[r][c] = W[(size_t)(col0 + c) * K + k0 + r];
      } else {
        const int r = i / SBN, c = i % SBN;
        Ws[r][c] = W[(size_t)(k0 + r) * N + col0 + c];
      }
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
    for (int j = 0; j < 4; ++j) epi.apply<OHM, DACT>(acc[i][j], r, col0 + tx * 4 + j, N);
  }
}

// ---------------------------------------------------------------------------
// bf16 tensor-core GEMM: 128x128 outputs per CTA, 8 warps as 2 (rows) x 4
// (cols), each warp 64x32 = 4x2 WMMA 16x16x16 fragments, K step 32. The A
// and W tiles stream through a 3-stage cp.async ring in dynamic shared
// memory, so the copies of the next two K steps overlap this step's MMAs.
// BT reads W^T: the tile is staged as W's rows [n][k] and fed to the MMA as
// a column-major B fragment. Needs K % 32 == 0, N % 8 == 0 and 16-byte
// aligned operands (head-major A: dh % 8 == 0).
// ---------------------------------------------------------------------------

constexpr int WBM = 128, WBN = 128, WBK = 32, WSTAGES = 3;
constexpr int A_LD = WBK + 8, W_LD = WBN + 8, WT_LD = WBK + 8;  // padded (bf16 elements)
constexpr int A_STAGE = WBM * A_LD;
constexpr int W_STAGE_MAX = WBN * WT_LD > WBK * W_LD ? WBN * WT_LD : WBK * W_LD;
constexpr int GEMM_SMEM = WSTAGES * (A_STAGE + W_STAGE_MAX) * 2;

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

template <bool BT, bool AHM, bool OHM, bool DACT>
__global__ void __launch_bounds__(256)
gemm_bf16(Operand A, const __nv_bfloat16* __restrict__ W, Epilogue epi, int M, int N, int K) {
  using namespace nvcuda;
  using BLayout = typename std::conditional<BT, wmma::col_major, wmma::row_major>::type;
  constexpr int W_STAGE = BT ? WBN * WT_LD : WBK * W_LD;
  extern __shared__ __align__(128) unsigned char gemm_smem[];
  __nv_bfloat16* As = reinterpret_cast<__nv_bfloat16*>(gemm_smem);  // [stage][WBM][A_LD]
  __nv_bfloat16* Ws = As + WSTAGES * A_STAGE;                         // [stage][W tile]

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
      cp_async16(as + r * A_LD + c, A.ptr<AHM, __nv_bfloat16>(gr < M ? gr : 0, k0 + c),
                 gr < M);
    }
#pragma unroll
    for (int v = tid; v < WBK * WBN / 8; v += 256) {
      if (BT) {
        const int r = v / (WBK / 8), c = (v % (WBK / 8)) * 8, gn = col0 + r;
        cp_async16(ws + r * WT_LD + c, W + (size_t)(gn < N ? gn : 0) * K + k0 + c, gn < N);
      } else {
        const int r = v / (WBN / 8), c = (v % (WBN / 8)) * 8, gc = col0 + c;
        cp_async16(ws + r * W_LD + c, W + (size_t)(k0 + r) * N + (gc < N ? gc : 0), gc < N);
      }
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
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, BLayout> b[2];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        wmma::load_matrix_sync(a[i], as + (wm * 64 + i * 16) * A_LD + kk, A_LD);
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        if (BT) wmma::load_matrix_sync(b[j], ws + (wn * 32 + j * 16) * WT_LD + kk, WT_LD);
        else wmma::load_matrix_sync(b[j], ws + kk * W_LD + wn * 32 + j * 16, W_LD);
      }
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
        if (r < M && c < N) epi.apply<OHM, DACT>(wbuf[e], r, c, N);
      }
      __syncwarp();
    }
}

static inline Operand row_major(const void* p, int ld = 0) {
  return Operand{p, nullptr, nullptr, 0, 0, 0, 0, 0, ld};
}

static inline Operand head_major(const void* p0, const void* p1, const void* p2, int n_tok,
                                 int heads, int dh) {
  return Operand{p0, p1, p2, 1, heads * dh, n_tok, heads, dh, 0};
}

template <bool BT, bool AHM, bool OHM, bool DACT>
static cudaError_t launch_gemm_t(const Operand& a, const void* w, int dtype,
                                 const Epilogue& epi, int M, int N, int K, cudaStream_t s) {
  if (dtype == BF16) {
    if (K % WBK || N % 8) return cudaErrorInvalidValue;
    const cudaError_t err = cudaFuncSetAttribute(
        gemm_bf16<BT, AHM, OHM, DACT>, cudaFuncAttributeMaxDynamicSharedMemorySize, GEMM_SMEM);
    if (err != cudaSuccess) return err;
    const dim3 grid((N + WBN - 1) / WBN, (M + WBM - 1) / WBM);
    gemm_bf16<BT, AHM, OHM, DACT><<<grid, 256, GEMM_SMEM, s>>>(
        a, static_cast<const __nv_bfloat16*>(w), epi, M, N, K);
  } else if (dtype == F32) {
    if (K % SBK || N % SBN) return cudaErrorInvalidValue;
    const dim3 grid(N / SBN, (M + SBM - 1) / SBM);
    gemm_f32<BT, AHM, OHM, DACT><<<grid, 256, 0, s>>>(a, static_cast<const float*>(w), epi, M,
                                                      N, K);
  } else {
    return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

// out[M, N] = epilogue(A @ W) (bt: A @ W^T, W stored [N, K]); A and W in
// `dtype` (float32 or bf16). The layouts the block kernels use, each its
// own instantiation: row-major in and out, a head-major output (q/k/v
// forward), W^T with a head-major A (their backward), W^T with a head-major
// output (the raw-x q/k/v forward in float32), and W^T with or without the
// activation-derivative epilogue; other combinations are refused.
static cudaError_t launch_gemm(Operand a, const void* w, int dtype, bool bt, Epilogue epi,
                               int M, int N, int K, cudaStream_t s) {
  if (!a.ld) a.ld = K;  // a dense row-major A: rows K apart
  if (!epi.out.ld) epi.out.ld = N;
  const bool ahm = a.head_major, ohm = epi.out.head_major, dact = epi.act_in != nullptr;
  if (!bt && !ahm && !ohm && !dact)
    return launch_gemm_t<false, false, false, false>(a, w, dtype, epi, M, N, K, s);
  if (!bt && !ahm && ohm && !dact)
    return launch_gemm_t<false, false, true, false>(a, w, dtype, epi, M, N, K, s);
  if (bt && !ahm && !ohm)
    return dact ? launch_gemm_t<true, false, false, true>(a, w, dtype, epi, M, N, K, s)
                : launch_gemm_t<true, false, false, false>(a, w, dtype, epi, M, N, K, s);
  if (bt && ahm && !ohm && !dact)
    return launch_gemm_t<true, true, false, false>(a, w, dtype, epi, M, N, K, s);
  if (bt && !ahm && ohm && !dact)
    return launch_gemm_t<true, false, true, false>(a, w, dtype, epi, M, N, K, s);
  return cudaErrorInvalidValue;
}

}  // namespace nx
