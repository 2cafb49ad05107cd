// The whole MONA adapter, forward and full-gradient backward, for Hopper
// (sm_90a):
//
//   z1  = LN(x) * gamma + x * gammax                  (rows of width D)
//   zd  = z1 @ W_down + b_down                        (D -> C = 64)
//   f   = s * freq on the h*w spatial rows s of zd
//   wts = softmax(MLP(GAP(f))) or 1/3 each
//   y   = s + sum_t wts_t b_t + 7x7 stencil of f with sum_t wts_t K_t
//   o   = y + pw(y);  out = x + (gelu([cls | o | tail]) * mask) @ W_up + b_up
//
// and, for the output gradient g, dx and the gradient of every parameter.
//
// Replaces nextgen_uia_tpu/ops/fused_mona.py::mona_block_fused: the Pallas
// kernels _fwd_kernel (pallas_call in _mb_fwd) and _bwd_kernel (pallas_call
// in _mb_bwd). Rounding points are that kernel's: z0 = LN(x) * scale + bias
// and z1 in the storage type T, zd, the stencil, pw and the GELU in float32,
// the products' operands rounded to T, the up projection's bias-add and the
// residual rounded to T. GELU is the exact erf form.
//
// What bounds it on the H100: at the bench's shape (x [64, 197, 768] bf16,
// C = 64) the forward moves x, the float32 mask and the output (~42 MB,
// 12.5 us at 3.35 TB/s) for ~2.7 GFLOP; the backward x, g, dx and the mask
// (~61 MB, 18 us). So bytes bound both; today the SIMT products and the
// per-image stencil, not memory, are what the kernels spend their time on.
//
// Design. The TPU kernel runs one image (or two) per grid cell with every
// intermediate of the image in VMEM; one image's [197, 768] float32
// intermediates are 605 KB, beyond the 227 KB a Hopper block may use. So the
// adapter is cut where it is narrow: the [rows, 64] bottleneck (1/12 of a
// row) crosses device memory, the wide [rows, 768] chain does not.
//   forward: (a) one block per 32 rows: LayerNorm statistics, z1 staged in
//   shared memory chunk by chunk, the down product on SIMT cores, zd in
//   float32; (b) one block per image: GAP, the noise MLP and its softmax,
//   the mixed per-sample 7x7 kernel, the stencil on the zero-haloed [h+6,
//   w+6, 64] map in shared memory, pw, the GELU and the mask, writing the
//   pre-GELU rows (float32) and the masked GELU rows (T); (c) the up product
//   with the bias, one rounding, the residual and a second rounding, on the
//   shared WMMA GEMM of block_kernels.cuh.
//   backward: the up product's transpose (dgd = g W_up^T, the shared GEMM);
//   one block per image for the GELU', pw, stencil and noise-MLP backward,
//   writing d(zd) and per-image partial parameter gradients; one block per
//   32 rows for d(z1) = d(zd) W_down^T, the LayerNorm backward and dx, and
//   per-tile partial column sums (LN scale and bias, gamma, gammax, b_up,
//   b_down); split-K products over the rows for dW_up = gd^T g and
//   dW_down = z1^T d(zd) (z1 recomputed from x and the saved row
//   statistics), each split writing its own partial.
// Determinism: on the TPU the grid runs in order and accumulates parameter
// gradients in place; here blocks run in no order, so every cross-block sum
// is a partial per image, tile or split, summed by a second pass in a fixed
// order. No float atomics: two backward calls give bitwise-equal gradients.

#include "block_kernels.cuh"

using namespace nx;

namespace {

constexpr int MC = 64, MC4 = 16, MK = 7, MT = 49, MH = 3;
constexpr int IMG_WTS = 0, IMG_POOL = 4, IMG_A1 = 4 + MC, IMG_LEN = 4 + MC + MC4;

template <typename T> constexpr int dtype_of() {
  return std::is_same<T, float>::value ? F32 : BF16;
}

// offsets (floats) into the packed parameter buffer (fused_mona.py::_pack)
struct Off {
  int lns, lnb, g, gx, ub, dw, db, freq, taps, tapb, pw, pb, f1w, f1b, f2w, f2b;
  __host__ __device__ explicit Off(int d) {
    lns = 0;
    lnb = d;
    g = 2 * d;
    gx = 3 * d;
    ub = 4 * d;
    dw = 5 * d;
    db = dw + d * MC;
    freq = db + MC;
    taps = freq + MC;
    tapb = taps + 3 * MT * MC;
    pw = tapb + 3 * MC;
    pb = pw + MC * MC;
    f1w = pb + MC;
    f1b = f1w + MC * MC4;
    f2w = f1b + MC4;
    f2b = f2w + MC4 * 3;
  }
};

// per-image partial gradients of the spatial block (fused_mona.py::_unpack)
constexpr int P2_PW = 0, P2_PB = P2_PW + MC * MC, P2_TAPS = P2_PB + MC,
              P2_TAPB = P2_TAPS + 3 * MT * MC, P2_FREQ = P2_TAPB + 3 * MC,
              P2_F1W = P2_FREQ + MC, P2_F1B = P2_F1W + MC * MC4, P2_F2W = P2_F1B + MC4,
              P2_F2B = P2_F2W + MC4 * 3, P2_LEN = P2_F2B + 3;

// xhat, z0 = round(xhat * scale + bias), z1 = round(round(z0 * gamma) +
// round(x * gammax)) with gamma and gammax rounded to T: the forward's wide
// chain, recomputed the same way wherever it is needed
template <typename T>
__device__ __forceinline__ float ln_z(float xv, float mean, float rstd, const float* prm,
                                      const Off& o, int j, float& xhat, float& z0) {
  xhat = (xv - mean) * rstd;
  z0 = round_to<T>(__fadd_rn(__fmul_rn(xhat, prm[o.lns + j]), prm[o.lnb + j]));
  const float a = round_to<T>(__fmul_rn(z0, round_to<T>(prm[o.g + j])));
  const float b = round_to<T>(__fmul_rn(xv, round_to<T>(prm[o.gx + j])));
  return round_to<T>(__fadd_rn(a, b));
}

// ---------------------------------------------------------------------------
// forward (a): LayerNorm, scaled skip, down product -> zd float32
// ---------------------------------------------------------------------------

constexpr int DN_TM = 32, DN_KC = 32, DN_THREADS = 256;

template <typename T>
__global__ void __launch_bounds__(DN_THREADS)
mona_down_kernel(const T* __restrict__ x, const float* __restrict__ prm,
                 float* __restrict__ stats, float* __restrict__ zd, int m, int d) {
  __shared__ float Zs[DN_KC][DN_TM + 1];
  __shared__ float Ws[DN_KC][MC];
  __shared__ float st[DN_TM][2];
  const Off o(d);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, row0 = blockIdx.x * DN_TM;
  for (int rr = warp; rr < DN_TM; rr += DN_THREADS / 32) {
    const int r = row0 + rr;
    float mean = 0.f, rstd = 0.f;
    if (r < m) row_stats(x + (size_t)r * d, d, lane, 1e-5f, mean, rstd);
    if (lane == 0) {
      st[rr][0] = mean;
      st[rr][1] = rstd;
      if (r < m) stats[2 * (size_t)r] = mean, stats[2 * (size_t)r + 1] = rstd;
    }
  }
  __syncthreads();
  const int tx = tid % 16, ty = tid / 16;
  float acc[2][4] = {};
  for (int k0 = 0; k0 < d; k0 += DN_KC) {
    for (int i = tid; i < DN_TM * DN_KC; i += DN_THREADS) {
      const int r = i / DN_KC, kk = i % DN_KC, gr = row0 + r;
      float z1 = 0.f;
      if (gr < m) {
        float xh, z0;
        z1 = ln_z<T>(to_f32(x[(size_t)gr * d + k0 + kk]), st[r][0], st[r][1], prm, o, k0 + kk,
                     xh, z0);
      }
      Zs[kk][r] = z1;
    }
    for (int i = tid; i < DN_KC * MC; i += DN_THREADS)
      Ws[i / MC][i % MC] = prm[o.dw + (size_t)(k0 + i / MC) * MC + i % MC];
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < DN_KC; ++kk) {
      const float a0 = Zs[kk][ty * 2], a1 = Zs[kk][ty * 2 + 1];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float wv = Ws[kk][tx * 4 + j];
        acc[0][j] = fmaf(a0, wv, acc[0][j]);
        acc[1][j] = fmaf(a1, wv, acc[1][j]);
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = row0 + ty * 2 + i;
    if (r >= m) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = tx * 4 + j;
      zd[(size_t)r * MC + c] = acc[i][j] + prm[o.db + c];
    }
  }
}

// ---------------------------------------------------------------------------
// forward (b): one block per image, the spatial op through the masked GELU
// ---------------------------------------------------------------------------

constexpr int SP_THREADS = 512;  // a multiple of MC: a thread's channel is tid % MC

// kern[tap][c] = sum_t wts[t] * taps[t][tap][c], in the JAX kernel's order
__device__ __forceinline__ void mix_taps(const float* wts, const float* prm, const Off& o,
                                         float* kern) {
  for (int i = threadIdx.x; i < MT * MC; i += blockDim.x)
    kern[i] = wts[0] * prm[o.taps + i] + wts[1] * prm[o.taps + MT * MC + i] +
              wts[2] * prm[o.taps + 2 * MT * MC + i];
}

static inline size_t spatial_fwd_smem(int h, int w) {
  return sizeof(float) * ((size_t)((h + 2 * MH) * (w + 2 * MH) + h * w + MT) * MC +
                          2 * MC + 2 * MC4 + 4);
}

template <typename T>
__global__ void __launch_bounds__(SP_THREADS)
mona_spatial_fwd_kernel(const float* __restrict__ zd, const float* __restrict__ mask,
                        const float* __restrict__ prm, float* __restrict__ zcat,
                        T* __restrict__ gd, float* __restrict__ y2, float* __restrict__ img,
                        int n, int d, int h, int w, int has_noise) {
  extern __shared__ __align__(16) float sm[];
  const Off o(d);
  const int hp = h + 2 * MH, wp = w + 2 * MH, hw = h * w;
  float* fp = sm;                   // [hp * wp][MC]  f = s * freq, zero halo
  float* ys = fp + hp * wp * MC;    // [hw][MC]       y
  float* kern = ys + hw * MC;       // [MT][MC]       the mixed kernel
  float* pooled = kern + MT * MC;   // [MC]
  float* biasw = pooled + MC;       // [MC]
  float* a1p = biasw + MC;          // [MC4]
  float* a1 = a1p + MC4;            // [MC4]
  float* wts = a1 + MC4;            // [4]
  const int b = blockIdx.x, tid = threadIdx.x;
  const float* zb = zd + (size_t)b * n * MC;

  for (int i = tid; i < hp * wp * MC; i += SP_THREADS) {
    const int c = i % MC, pix = i / MC, yy = pix / wp - MH, xx = pix % wp - MH;
    float v = 0.f;
    if (yy >= 0 && yy < h && xx >= 0 && xx < w)
      v = zb[(size_t)(1 + yy * w + xx) * MC + c] * prm[o.freq + c];
    fp[i] = v;
  }
  __syncthreads();
  if (has_noise) {
    if (tid < MC) {
      float s = 0.f;
      for (int y = 0; y < h; ++y)
        for (int x = 0; x < w; ++x) s += fp[((y + MH) * wp + x + MH) * MC + tid];
      pooled[tid] = s / hw;
    }
    __syncthreads();
    if (tid < MC4) {
      float a = 0.f;
      for (int c = 0; c < MC; ++c) a = fmaf(pooled[c], prm[o.f1w + c * MC4 + tid], a);
      a += prm[o.f1b + tid];
      a1p[tid] = a;
      a1[tid] = fmaxf(a, 0.f);
    }
    __syncthreads();
    if (tid == 0) {
      float lg[3], mx = -FLT_MAX, sum = 0.f;
      for (int t = 0; t < 3; ++t) {
        float a = 0.f;
        for (int j = 0; j < MC4; ++j) a = fmaf(a1[j], prm[o.f2w + j * 3 + t], a);
        lg[t] = a + prm[o.f2b + t];
        mx = fmaxf(mx, lg[t]);
      }
      for (int t = 0; t < 3; ++t) lg[t] = expf(lg[t] - mx), sum += lg[t];
      for (int t = 0; t < 3; ++t) wts[t] = lg[t] / sum;
    }
  } else if (tid == 0) {
    wts[0] = wts[1] = wts[2] = 1.f / 3.f;
  }
  __syncthreads();
  float* ib = img + (size_t)b * IMG_LEN;
  if (tid < 4) ib[IMG_WTS + tid] = tid < 3 ? wts[tid] : 0.f;
  if (tid < MC) ib[IMG_POOL + tid] = has_noise ? pooled[tid] : 0.f;
  if (tid < MC4) ib[IMG_A1 + tid] = has_noise ? a1p[tid] : 0.f;
  mix_taps(wts, prm, o, kern);
  if (tid < MC)
    biasw[tid] = wts[0] * prm[o.tapb + tid] + wts[1] * prm[o.tapb + MC + tid] +
                 wts[2] * prm[o.tapb + 2 * MC + tid];
  __syncthreads();

  for (int i = tid; i < hw * MC; i += SP_THREADS) {
    const int c = i % MC, pix = i / MC, y = pix / w, x = pix % w;
    float acc = zb[(size_t)(1 + pix) * MC + c] + biasw[c];
#pragma unroll
    for (int di = 0; di < MK; ++di)
#pragma unroll
      for (int dj = 0; dj < MK; ++dj)
        acc = fmaf(fp[((y + di) * wp + x + dj) * MC + c], kern[(di * MK + dj) * MC + c], acc);
    ys[i] = acc;
    y2[((size_t)b * hw + pix) * MC + c] = acc;
  }
  __syncthreads();

  // o = y + round(y) @ round(pw) + b_pw, then gelu(o) * mask: spatial rows
  for (int i = tid; i < hw * MC; i += SP_THREADS) {
    const int co = i % MC, pix = i / MC;
    float pwp = 0.f;
#pragma unroll 8
    for (int k = 0; k < MC; ++k)
      pwp = fmaf(round_to<T>(ys[pix * MC + k]), prm[o.pw + k * MC + co], pwp);
    const float zc = ys[i] + pwp + prm[o.pb + co];
    const size_t gi = ((size_t)b * n + 1 + pix) * MC + co;
    zcat[gi] = zc;
    gd[gi] = from_f32<T>(act_fwd(ACT_GELU, zc) * mask[gi]);
  }
  // the CLS row and the tail rows take zd as it is
  for (int i = tid; i < (n - hw) * MC; i += SP_THREADS) {
    const int c = i % MC, r = i / MC, row = r == 0 ? 0 : hw + r;
    const size_t gi = ((size_t)b * n + row) * MC + c;
    const float zc = zb[(size_t)row * MC + c];
    zcat[gi] = zc;
    gd[gi] = from_f32<T>(act_fwd(ACT_GELU, zc) * mask[gi]);
  }
}

// ---------------------------------------------------------------------------
// backward: one block per image, GELU' through the stencil and noise MLP
// ---------------------------------------------------------------------------

// the backward's first region holds the zero-haloed map, or d(o) beside
// round(y) or round(pw)^T
__host__ __device__ inline int spatial_bwd_rows(int h, int w) {
  const int pad = (h + 2 * MH) * (w + 2 * MH), hw = h * w;
  return max(pad, max(2 * hw, hw + MC));
}

static inline size_t spatial_bwd_smem(int h, int w) {
  return sizeof(float) * ((size_t)(spatial_bwd_rows(h, w) + (h + 2 * MH) * (w + 2 * MH)) * MC +
                          MT * MC + 5 * MC + MC4 + 8 + SP_THREADS);
}

template <typename T>
__global__ void __launch_bounds__(SP_THREADS)
mona_spatial_bwd_kernel(const float* __restrict__ dgd, const float* __restrict__ mask,
                        const float* __restrict__ zcat, const float* __restrict__ zd,
                        const float* __restrict__ y2, const float* __restrict__ img,
                        const float* __restrict__ prm, float* __restrict__ dzd,
                        float* __restrict__ part, int n, int d, int h, int w, int has_freq,
                        int has_noise) {
  extern __shared__ __align__(16) float sm[];
  const Off o(d);
  const int hp = h + 2 * MH, wp = w + 2 * MH, hw = h * w;
  float* X = sm;                  // [hp * wp][MC]: d(o) as [hw][MC], then f padded
  float* S = X + hw * MC;         // beside d(o): round(y) [hw][MC], then round(pw)^T [MC][MC]
  float* Y = X + spatial_bwd_rows(h, w) * MC;  // [hp * wp][MC]: dy, zero halo
  float* K = Y + hp * wp * MC;    // [MT][MC]: dk, then the mixed kernel
  float* dbiasw = K + MT * MC;    // [MC]
  float* dpool = dbiasw + MC;     // [MC]
  float* tmp = dpool + MC;        // [3][MC]
  float* da1 = tmp + 3 * MC;      // [MC4]
  float* dl = da1 + MC4;          // [4]
  float* wts = dl + 4;            // [4]
  float* red = wts + 4;           // [SP_THREADS]
  const int b = blockIdx.x, tid = threadIdx.x;
  const float* ib = img + (size_t)b * IMG_LEN;
  float* pt = part + (size_t)b * P2_LEN;
  const size_t rb = (size_t)b * n;
  if (tid < 4) wts[tid] = ib[IMG_WTS + tid];

  // d(zcat) = dgd * mask * gelu'(zcat): CLS and tail rows are d(zd) as they are
  for (int i = tid; i < n * MC; i += SP_THREADS) {
    const int c = i % MC, r = i / MC;
    const size_t gi = (rb + r) * MC + c;
    const float v = dgd[gi] * mask[gi] * act_grad(ACT_GELU, zcat[gi]);
    if (r >= 1 && r <= hw) X[(r - 1) * MC + c] = v;
    else dzd[gi] = v;
  }
  for (int i = tid; i < hp * wp * MC; i += SP_THREADS) Y[i] = 0.f;
  for (int i = tid; i < hw * MC; i += SP_THREADS) S[i] = round_to<T>(y2[(size_t)b * hw * MC + i]);
  __syncthreads();

  // pw's bias and weight: sums over the map of d(o) and round(y)^T round(d(o));
  // a thread's output channel is co = tid % MC, its rows k = tid / MC + 8j
  constexpr int KJ = MC / (SP_THREADS / MC);
  if (tid < MC) {
    float s = 0.f;
    for (int pix = 0; pix < hw; ++pix) s += X[pix * MC + tid];
    pt[P2_PB + tid] = s;
  }
  {
    const int co = tid % MC, k0 = tid / MC;
    float acc[KJ] = {};
    for (int pix = 0; pix < hw; ++pix) {
      const float dv = round_to<T>(X[pix * MC + co]);
#pragma unroll
      for (int j = 0; j < KJ; ++j)
        acc[j] = fmaf(S[pix * MC + k0 + j * (SP_THREADS / MC)], dv, acc[j]);
    }
#pragma unroll
    for (int j = 0; j < KJ; ++j) pt[P2_PW + (k0 + j * (SP_THREADS / MC)) * MC + co] = acc[j];
  }
  __syncthreads();
  for (int i = tid; i < MC * MC; i += SP_THREADS)  // S <- round(pw)^T
    S[(i / MC) * MC + i % MC] = prm[o.pw + (i % MC) * MC + i / MC];
  __syncthreads();
  // dy = d(o) + round(d(o)) @ round(pw)^T into Y's interior
  for (int i = tid; i < hw * MC; i += SP_THREADS) {
    const int ci = i % MC, pix = i / MC, y = pix / w, x = pix % w;
    float a = 0.f;
#pragma unroll 8
    for (int co = 0; co < MC; ++co) a = fmaf(round_to<T>(X[pix * MC + co]), S[co * MC + ci], a);
    Y[((y + MH) * wp + x + MH) * MC + ci] = X[i] + a;
  }
  __syncthreads();

  // X <- f = s * freq with a zero halo
  for (int i = tid; i < hp * wp * MC; i += SP_THREADS) {
    const int c = i % MC, pix = i / MC, yy = pix / wp - MH, xx = pix % wp - MH;
    float v = 0.f;
    if (yy >= 0 && yy < h && xx >= 0 && xx < w)
      v = zd[(rb + 1 + yy * w + xx) * MC + c] * prm[o.freq + c];
    X[i] = v;
  }
  __syncthreads();

  // dk[tap][c] = sum over the map of dy * the tap-shifted f; dbias = sum of
  // dy. A thread's channel is c = tid % MC, its taps t = tid / MC + 8j
  {
    constexpr int TJ = (MT * MC + SP_THREADS - 1) / SP_THREADS;
    const int c = tid % MC, t0 = tid / MC;
    float acc[TJ] = {};
    for (int y = 0; y < h; ++y)
      for (int x = 0; x < w; ++x) {
        const float dv = Y[((y + MH) * wp + x + MH) * MC + c];
#pragma unroll
        for (int j = 0; j < TJ; ++j) {
          const int t = min(t0 + j * (SP_THREADS / MC), MT - 1);
          acc[j] = fmaf(dv, X[((y + t / MK) * wp + x + t % MK) * MC + c], acc[j]);
        }
      }
#pragma unroll
    for (int j = 0; j < TJ; ++j) {
      const int t = t0 + j * (SP_THREADS / MC);
      if (t >= MT) break;
      K[t * MC + c] = acc[j];
      for (int tt = 0; tt < 3; ++tt) pt[P2_TAPS + (tt * MT + t) * MC + c] = wts[tt] * acc[j];
    }
  }
  if (tid < MC) {
    float s = 0.f;
    for (int y = 0; y < h; ++y)
      for (int x = 0; x < w; ++x) s += Y[((y + MH) * wp + x + MH) * MC + tid];
    dbiasw[tid] = s;
    for (int tt = 0; tt < 3; ++tt) pt[P2_TAPB + tt * MC + tid] = wts[tt] * s;
  }
  __syncthreads();

  // the noise MLP's backward
  if (has_noise) {
    const float* a1p = ib + IMG_A1;
    const float* pooled = ib + IMG_POOL;
    if (tid < 3 * MC) {
      const int t = tid / MC, c = tid % MC;
      float a = 0.f;
      for (int tap = 0; tap < MT; ++tap)
        a = fmaf(K[tap * MC + c], prm[o.taps + (t * MT + tap) * MC + c], a);
      tmp[tid] = a + dbiasw[c] * prm[o.tapb + t * MC + c];
    }
    __syncthreads();
    if (tid == 0) {
      float dw3[3], dot = 0.f;
      for (int t = 0; t < 3; ++t) {
        float s = 0.f;
        for (int c = 0; c < MC; ++c) s += tmp[t * MC + c];
        dw3[t] = s;
        dot += s * wts[t];
      }
      for (int t = 0; t < 3; ++t) dl[t] = wts[t] * (dw3[t] - dot);
    }
    __syncthreads();
    if (tid < MC4) {
      float a = 0.f;
      for (int t = 0; t < 3; ++t) a = fmaf(dl[t], prm[o.f2w + tid * 3 + t], a);
      da1[tid] = a1p[tid] > 0.f ? a : 0.f;
    }
    if (tid < MC4 * 3) pt[P2_F2W + tid] = fmaxf(a1p[tid / 3], 0.f) * dl[tid % 3];
    if (tid < 3) pt[P2_F2B + tid] = dl[tid];
    __syncthreads();
    for (int i = tid; i < MC * MC4; i += SP_THREADS)
      pt[P2_F1W + i] = pooled[i / MC4] * da1[i % MC4];
    if (tid < MC4) pt[P2_F1B + tid] = da1[tid];
    if (tid < MC) {
      float a = 0.f;
      for (int j = 0; j < MC4; ++j) a = fmaf(da1[j], prm[o.f1w + tid * MC4 + j], a);
      dpool[tid] = a / hw;
    }
  } else {
    for (int i = tid; i < MC * MC4 + MC4 + MC4 * 3 + 3; i += SP_THREADS) pt[P2_F1W + i] = 0.f;
    if (tid < MC) dpool[tid] = 0.f;
  }
  __syncthreads();
  mix_taps(wts, prm, o, K);
  __syncthreads();

  // df = (dy correlated with the flipped kernel) + dpool; d(s) = dy + df * freq
  float pf = 0.f;
  for (int i = tid; i < hw * MC; i += SP_THREADS) {
    const int c = i % MC, pix = i / MC, y = pix / w, x = pix % w;
    float a = 0.f;
#pragma unroll
    for (int di = 0; di < MK; ++di)
#pragma unroll
      for (int dj = 0; dj < MK; ++dj)
        a = fmaf(Y[((y + 2 * MH - di) * wp + x + 2 * MH - dj) * MC + c],
                 K[(di * MK + dj) * MC + c], a);
    const float df = a + dpool[c];
    const float dy = Y[((y + MH) * wp + x + MH) * MC + c];
    const size_t gi = (rb + 1 + pix) * MC + c;
    if (has_freq) {
      dzd[gi] = dy + df * prm[o.freq + c];
      pf = fmaf(zd[gi], df, pf);
    } else {
      dzd[gi] = dy + df;
    }
  }
  red[tid] = pf;
  __syncthreads();
  if (tid < MC) {
    float s = 0.f;
    for (int t = tid; t < SP_THREADS; t += MC) s += red[t];
    pt[P2_FREQ + tid] = s;
  }
}

// ---------------------------------------------------------------------------
// backward: one block per 32 rows, d(z1), the LayerNorm backward, dx and the
// per-tile column sums [LN scale | LN bias | gamma | gammax | b_up | b_down]
// ---------------------------------------------------------------------------

constexpr int LB_TM = 32, LB_JC = 64, LB_THREADS = 256;

static inline size_t ln_bwd_smem(int d) {
  return sizeof(float) * ((size_t)LB_TM * d + LB_TM * (MC + 1) + MC * (LB_JC + 1));
}

template <typename T>
__global__ void __launch_bounds__(LB_THREADS)
mona_ln_bwd_kernel(const T* __restrict__ x, const T* __restrict__ g,
                   const float* __restrict__ stats, const float* __restrict__ dzd,
                   const float* __restrict__ prm, T* __restrict__ dx, float* __restrict__ part,
                   int m, int d) {
  extern __shared__ __align__(16) float sm[];
  const Off o(d);
  float* dz1 = sm;                        // [LB_TM][d]
  float* dzs = dz1 + LB_TM * d;           // [LB_TM][MC + 1]  round(d(zd))
  float* Wt = dzs + LB_TM * (MC + 1);     // [MC][LB_JC + 1]  a chunk of round(W_down)^T
  const int tid = threadIdx.x, row0 = blockIdx.x * LB_TM;
  for (int i = tid; i < LB_TM * MC; i += LB_THREADS) {
    const int r = i / MC, k = i % MC;
    dzs[r * (MC + 1) + k] = row0 + r < m ? round_to<T>(dzd[(size_t)(row0 + r) * MC + k]) : 0.f;
  }
  const int tx = tid % 16, ty = tid / 16;
  for (int j0 = 0; j0 < d; j0 += LB_JC) {
    __syncthreads();
    for (int i = tid; i < LB_JC * MC; i += LB_THREADS) {
      const int jj = i / MC, k = i % MC;
      Wt[k * (LB_JC + 1) + jj] = prm[o.dw + (size_t)(j0 + jj) * MC + k];
    }
    __syncthreads();
    float acc[2][4] = {};
#pragma unroll 8
    for (int k = 0; k < MC; ++k) {
      const float a0 = dzs[(ty * 2) * (MC + 1) + k], a1 = dzs[(ty * 2 + 1) * (MC + 1) + k];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float wv = Wt[k * (LB_JC + 1) + tx * 4 + j];
        acc[0][j] = fmaf(a0, wv, acc[0][j]);
        acc[1][j] = fmaf(a1, wv, acc[1][j]);
      }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) dz1[(ty * 2 + i) * d + j0 + tx * 4 + j] = acc[i][j];
  }
  __syncthreads();

  float* pt = part + (size_t)blockIdx.x * (5 * d + MC);
  for (int j = tid; j < d; j += LB_THREADS) {
    float s_lns = 0.f, s_lnb = 0.f, s_g = 0.f, s_gx = 0.f, s_ub = 0.f;
    const float gam = prm[o.g + j];
    for (int r = 0; r < LB_TM && row0 + r < m; ++r) {
      const size_t gr = row0 + r;
      const float xv = to_f32(x[gr * d + j]);
      float xh, z0;
      ln_z<T>(xv, stats[2 * gr], stats[2 * gr + 1], prm, o, j, xh, z0);
      const float v = dz1[r * d + j], dz0 = v * gam;
      s_lns += dz0 * xh;
      s_lnb += dz0;
      s_g += v * z0;
      s_gx += v * xv;
      s_ub += to_f32(g[gr * d + j]);
    }
    pt[j] = s_lns;
    pt[d + j] = s_lnb;
    pt[2 * d + j] = s_g;
    pt[3 * d + j] = s_gx;
    pt[4 * d + j] = s_ub;
  }
  if (tid < MC) {
    float s = 0.f;
    for (int r = 0; r < LB_TM && row0 + r < m; ++r) s += dzd[(size_t)(row0 + r) * MC + tid];
    pt[5 * d + tid] = s;
  }
  if (!dx) return;

  // dx = g + (dxhat - mean(dxhat) - xhat mean(dxhat xhat)) rstd + d(z1) gammax,
  // dxhat = d(z1) gamma scale; one warp per row
  const int warp = tid / 32, lane = tid % 32;
  for (int rr = warp; rr < LB_TM; rr += LB_THREADS / 32) {
    const size_t gr = row0 + rr;
    if (gr >= (size_t)m) break;
    const float mean = stats[2 * gr], rstd = stats[2 * gr + 1];
    float m1 = 0.f, m2 = 0.f;
    for (int j = lane; j < d; j += 32) {
      const float xh = (to_f32(x[gr * d + j]) - mean) * rstd;
      const float dxh = dz1[rr * d + j] * prm[o.g + j] * prm[o.lns + j];
      m1 += dxh;
      m2 += dxh * xh;
    }
    m1 = warp_sum(m1) / d;
    m2 = warp_sum(m2) / d;
    for (int j = lane; j < d; j += 32) {
      const float xh = (to_f32(x[gr * d + j]) - mean) * rstd;
      const float v = dz1[rr * d + j];
      const float dxh = v * prm[o.g + j] * prm[o.lns + j];
      const float out = to_f32(g[gr * d + j]) + (dxh - m1 - xh * m2) * rstd + v * prm[o.gx + j];
      dx[gr * d + j] = from_f32<T>(out);
    }
  }
}

// ---------------------------------------------------------------------------
// backward: split-K products over the rows, out[p][q] = sum_r A[r][p] B[r][q],
// one float32 partial per split; sum_splits adds the partials in order
// ---------------------------------------------------------------------------

template <typename T> struct LdT {
  const T* p;
  int ld;
  __device__ float operator()(int r, int c) const { return to_f32(p[(size_t)r * ld + c]); }
};

template <typename T> struct LdRounded {
  const float* p;
  int ld;
  __device__ float operator()(int r, int c) const { return round_to<T>(p[(size_t)r * ld + c]); }
};

template <typename T> struct LdZ1 {
  const T* x;
  const float* stats;
  const float* prm;
  int d;
  __device__ float operator()(int r, int j) const {
    const Off o(d);
    float xh, z0;
    return ln_z<T>(to_f32(x[(size_t)r * d + j]), stats[2 * (size_t)r], stats[2 * (size_t)r + 1],
                   prm, o, j, xh, z0);
  }
};

constexpr int CG = 64, CG_R = 16;

template <class LA, class LB>
__global__ void __launch_bounds__(256)
colgemm_kernel(LA la, LB lb, float* __restrict__ part, int m, int pdim, int qdim, int rows_per) {
  __shared__ float As[CG_R][CG];
  __shared__ float Bs[CG_R][CG];
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int p0 = blockIdx.y * CG, q0 = blockIdx.x * CG, s = blockIdx.z;
  const int r_begin = s * rows_per, r_end = min(m, r_begin + rows_per);
  float acc[4][4] = {};
  for (int r0 = r_begin; r0 < r_end; r0 += CG_R) {
    for (int i = tid; i < CG_R * CG; i += 256) {
      const int rr = i / CG, cc = i % CG, r = r0 + rr;
      const bool ok = r < r_end;
      As[rr][cc] = ok ? la(r, p0 + cc) : 0.f;
      Bs[rr][cc] = ok ? lb(r, q0 + cc) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int rr = 0; rr < CG_R; ++rr) {
      float a[4], bv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = As[rr][ty * 4 + i];
#pragma unroll
      for (int j = 0; j < 4; ++j) bv[j] = Bs[rr][tx * 4 + j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      part[((size_t)s * pdim + p0 + ty * 4 + i) * qdim + q0 + tx * 4 + j] = acc[i][j];
}

__global__ void sum_splits_kernel(const float* __restrict__ part, float* __restrict__ out,
                                  int splits, int len) {
  const int l = blockIdx.x * blockDim.x + threadIdx.x;
  if (l >= len) return;
  float a = 0.f;
  for (int s = 0; s < splits; ++s) a += part[(size_t)s * len + l];
  out[l] = a;
}

cudaError_t sum_splits(const float* part, float* out, int splits, int len, cudaStream_t st) {
  sum_splits_kernel<<<(len + 255) / 256, 256, 0, st>>>(part, out, splits, len);
  return cudaGetLastError();
}

bool shape_ok(int b, int n, int d, int h, int w) {
  return b >= 1 && h >= 1 && w >= 1 && n >= h * w + 1 && d % 64 == 0 && d >= 64 &&
         spatial_bwd_smem(h, w) <= 232448;
}

template <typename T>
cudaError_t mona_fwd(const void* x, const float* mask, const float* prm, const void* uw,
                     void* out, float* stats, float* zd, float* zcat, void* gd, float* y2,
                     float* img, int b, int n, int d, int h, int w, int has_noise,
                     cudaStream_t st) {
  const int m = b * n;
  mona_down_kernel<T><<<(m + DN_TM - 1) / DN_TM, DN_THREADS, 0, st>>>(
      static_cast<const T*>(x), prm, stats, zd, m, d);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const size_t smem = spatial_fwd_smem(h, w);
  err = cudaFuncSetAttribute(mona_spatial_fwd_kernel<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  mona_spatial_fwd_kernel<T><<<b, SP_THREADS, smem, st>>>(
      zd, mask, prm, zcat, static_cast<T*>(gd), y2, img, n, d, h, w, has_noise);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  // out = round(x + round(gd @ W_up + b_up))
  Epilogue epi{prm + Off(d).ub, x, dtype_of<T>(), nullptr, ACT_NONE, row_major(out),
               dtype_of<T>()};
  epi.round_mid = 1;
  return launch_gemm(row_major(gd), uw, dtype_of<T>(), false, epi, m, d, MC, st);
}

template <typename T>
cudaError_t mona_bwd(const void* x, const float* mask, const float* prm, const void* uw,
                     const void* g, const float* stats, const float* zd, const float* zcat,
                     const void* gd, const float* y2, const float* img, void* dx, float* dgd,
                     float* dzd, float* part_img, float* part_row, float* part_up,
                     float* part_down, float* grads, int b, int n, int d, int h, int w,
                     int has_freq, int has_noise, int splits, cudaStream_t st) {
  const int m = b * n, tiles = (m + LB_TM - 1) / LB_TM;
  // dgd = round(g) @ round(W_up)^T
  const Epilogue epi{nullptr, nullptr, 0, nullptr, ACT_NONE, row_major(dgd), F32};
  cudaError_t err = launch_gemm(row_major(g), uw, dtype_of<T>(), true, epi, m, MC, d, st);
  if (err != cudaSuccess) return err;
  const size_t smem = spatial_bwd_smem(h, w);
  if ((err = cudaFuncSetAttribute(mona_spatial_bwd_kernel<T>,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem)) !=
      cudaSuccess)
    return err;
  mona_spatial_bwd_kernel<T><<<b, SP_THREADS, smem, st>>>(dgd, mask, zcat, zd, y2, img, prm,
                                                          dzd, part_img, n, d, h, w, has_freq,
                                                          has_noise);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const size_t lsmem = ln_bwd_smem(d);
  if ((err = cudaFuncSetAttribute(mona_ln_bwd_kernel<T>,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize, (int)lsmem)) !=
      cudaSuccess)
    return err;
  mona_ln_bwd_kernel<T><<<tiles, LB_THREADS, lsmem, st>>>(
      static_cast<const T*>(x), static_cast<const T*>(g), stats, dzd, prm,
      static_cast<T*>(dx), part_row, m, d);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const int rows_per = (((m + splits - 1) / splits) + CG_R - 1) / CG_R * CG_R;
  // dW_up [MC, d] = round(gd)^T round(g);  dW_down [d, MC] = round(z1)^T round(d(zd))
  colgemm_kernel<<<dim3(d / CG, 1, splits), 256, 0, st>>>(
      LdT<T>{static_cast<const T*>(gd), MC}, LdT<T>{static_cast<const T*>(g), d}, part_up, m,
      MC, d, rows_per);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  colgemm_kernel<<<dim3(1, d / CG, splits), 256, 0, st>>>(
      LdZ1<T>{static_cast<const T*>(x), stats, prm, d}, LdRounded<T>{dzd, MC}, part_down, m, d,
      MC, rows_per);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  float* g_up = grads;
  float* g_down = g_up + MC * d;
  float* g_row = g_down + MC * d;
  float* g_img = g_row + 5 * d + MC;
  if ((err = sum_splits(part_up, g_up, splits, MC * d, st)) != cudaSuccess) return err;
  if ((err = sum_splits(part_down, g_down, splits, MC * d, st)) != cudaSuccess) return err;
  if ((err = sum_splits(part_row, g_row, tiles, 5 * d + MC, st)) != cudaSuccess) return err;
  return sum_splits(part_img, g_img, b, P2_LEN, st);
}

}  // namespace

extern "C" {

// x, out [B*N, D] in `dtype`; mask [B*N, 64] float32; prm the packed float32
// parameters (fused_mona.py::_pack); uw = W_up [64, D] in `dtype`. Saved for
// the backward: stats [B*N, 2] (mean, rstd), zd and zcat [B*N, 64] float32,
// gd [B*N, 64] in `dtype`, y2 [B*h*w, 64] float32, img [B, 84] float32.
int nx_mona_fused_fwd(const void* x, const float* mask, const float* prm, const void* uw,
                      void* out, float* stats, float* zd, float* zcat, void* gd, float* y2,
                      float* img, int dtype, int b, int n, int d, int h, int w, int has_noise,
                      void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (!shape_ok(b, n, d, h, w)) return (int)cudaErrorInvalidValue;
  if (dtype == BF16)
    return (int)mona_fwd<__nv_bfloat16>(x, mask, prm, uw, out, stats, zd, zcat, gd, y2, img, b,
                                        n, d, h, w, has_noise, st);
  if (dtype == F32)
    return (int)mona_fwd<float>(x, mask, prm, uw, out, stats, zd, zcat, gd, y2, img, b, n, d,
                                h, w, has_noise, st);
  return (int)cudaErrorInvalidValue;
}

// g, dx [B*N, D] in `dtype` (dx null: not computed); the forward's inputs and
// saved tensors; scratch dgd, dzd [B*N, 64], part_img [B, P2_LEN], part_row
// [ceil(B*N / 32), 5D + 64], part_up and part_down [splits, 64 * D], all
// float32. grads (float32): dW_up [64, D] | dW_down [D, 64] | LN scale,
// LN bias, gamma, gammax, b_up [D each] | b_down [64] | the spatial
// block's P2_LEN (pw, pw bias, taps, tap biases, freq, noise MLP).
int nx_mona_fused_bwd(const void* x, const float* mask, const float* prm, const void* uw,
                      const void* g, const float* stats, const float* zd, const float* zcat,
                      const void* gd, const float* y2, const float* img, void* dx, float* dgd,
                      float* dzd, float* part_img, float* part_row, float* part_up,
                      float* part_down, float* grads, int dtype, int b, int n, int d, int h,
                      int w, int has_freq, int has_noise, int splits, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (!shape_ok(b, n, d, h, w) || splits < 1 || splits > 65535)
    return (int)cudaErrorInvalidValue;
  if (dtype == BF16)
    return (int)mona_bwd<__nv_bfloat16>(x, mask, prm, uw, g, stats, zd, zcat, gd, y2, img, dx,
                                        dgd, dzd, part_img, part_row, part_up, part_down, grads,
                                        b, n, d, h, w, has_freq, has_noise, splits, st);
  if (dtype == F32)
    return (int)mona_bwd<float>(x, mask, prm, uw, g, stats, zd, zcat, gd, y2, img, dx, dgd, dzd,
                                part_img, part_row, part_up, part_down, grads, b, n, d, h, w,
                                has_freq, has_noise, splits, st);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
