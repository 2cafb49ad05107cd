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
// (~61 MB, 18 us). So bytes bound both.
//
// Design. The TPU kernel runs one image (or two) per grid cell with every
// intermediate of the image in VMEM; one image's [197, 768] float32
// intermediates are 605 KB, beyond the 227 KB a Hopper block may use. So the
// adapter is cut where it is narrow: the [rows, 64] bottleneck (1/12 of a
// row) crosses device memory between the stages, and in bf16 z1 too (saved
// for dW_down, 1.0x the size of x).
//   forward (bf16): (a) one warp per row: the LayerNorm statistics (saved)
//   and z1 in bf16; zd = z1 W_down + b_down on hopper_gemm.cuh's core (TMA,
//   wgmma; W_down^T [64, D] K-major, a 128 x 64 tile, the float32 zd stored
//   from the registers); (b) the spatial kernel, one CTA per (image, strip
//   of grid rows), two strips an image: GAP over the whole image (each
//   strip sums it in the same order), the noise MLP and its softmax, the
//   mixed per-sample 7x7 kernel (a thread's 49 taps in registers), the
//   stencil over the strip's rows and their 3-row halo in shared memory, pw
//   (a thread's column in registers), the GELU and the mask, writing the
//   pre-GELU rows (float32) and the masked GELU rows gd (T); (c) the up
//   product gd W_up + b_up on the core (one K step, 128 x 128 tiles) with a
//   staged epilogue that rounds twice, round(x + round(v + b_up))
//   (hopper_gemm.cuh::RoundResidualEpilogue).
//   backward (bf16): dgd = g W_up^T on the core (W_up [64, D] as stored,
//   float32 out); the spatial backward, the image's two strips one cluster:
//   GELU', pw, the stencil's transpose over the strip and its halo rows (d(o)
//   and dy recomputed on the halo), the tap gradients of the strip's pixels,
//   and the noise MLP's d(wts), which is linear in the tap gradients: each
//   strip's share is read by both strips through distributed shared memory
//   and summed in rank order; it writes d(zd) in float32 and in bf16 and a
//   partial parameter gradient per strip; d(z1) = round(d(zd)) W_down^T on
//   the core (K = 64, float32 out); the LayerNorm backward, one CTA per tile
//   of rows (a multiple of 16 rows, one tile per SM), 16 rows at a time
//   staged in shared memory: a warp per row writes dx, then every thread
//   adds the staged rows into its columns' sums (LN scale and bias, gamma,
//   gammax, b_up; b_down from d(zd)); the weight gradients dW_up = gd^T g
//   and dW_down^T = d(zd)^T z1 in one launch of mona_wgrad_kernel: the rows
//   are the products' K, 64 at a time by TMA, both operands MN-major for
//   wgmma (the transpose bits), each CTA a 64 x 128 tile of one split of
//   the rows, stored as its partial.
//   float32 keeps the SIMT dataflow, the exact float32 check of the
//   algorithm: (a) one block per 32 rows with z1 staged in shared memory
//   chunk by chunk and the down product on SIMT cores; (c) and dgd on
//   block_kernels.cuh's SIMT GEMM; one block per 32 rows for d(z1), the
//   LayerNorm backward and its column sums; split-K SIMT products for dW_up
//   and dW_down (z1 recomputed from x and the saved statistics). The spatial
//   kernels are shared.
// Determinism: on the TPU the grid runs in order and accumulates parameter
// gradients in place; here blocks run in no order, so every cross-block sum
// is a partial per strip, tile or split, summed by a second pass in a fixed
// order. No float atomics: two backward calls give bitwise-equal gradients.

#include "block_kernels.cuh"
#include "hopper_gemm.cuh"

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
// forward (b) and backward (e): the spatial op, one CTA per (image, strip of
// grid rows). A CTA holds its strip's rows and MH halo rows on each side
// (the 7x7 stencil's reach) in shared memory; what needs the whole image is
// small: the pooled vector (forward, each strip sums all of the image's
// rows itself, in one fixed order, so every strip mixes the same kernel)
// and the noise MLP's d(wts) (backward, linear in the tap gradients: each
// strip's share is read by every strip of the image's cluster through
// distributed shared memory and summed in rank order)
// ---------------------------------------------------------------------------

constexpr int SP_THREADS = 512;  // a multiple of MC: a thread's channel is tid % MC

// kern[tap][c] = sum_t wts[t] * taps[t][tap][c], in the JAX kernel's order
__device__ __forceinline__ void mix_taps(const float* wts, const float* prm, const Off& o,
                                         float* kern) {
  for (int i = threadIdx.x; i < MT * MC; i += blockDim.x)
    kern[i] = wts[0] * prm[o.taps + i] + wts[1] * prm[o.taps + MT * MC + i] +
              wts[2] * prm[o.taps + 2 * MT * MC + i];
}

// rows of a strip: strips of ceil(h / strips) rows, the last one shorter
__host__ __device__ inline int strip_rows(int h, int strips) { return (h + strips - 1) / strips; }

static inline size_t spatial_fwd_smem(int h, int w, int strips) {
  const int r = strip_rows(h, strips);
  return sizeof(float) * ((size_t)((r + 2 * MH) * (w + 2 * MH) + r * w + MT) * MC + 2 * MC +
                          2 * MC4 + 4 + SP_THREADS);
}

template <typename T>
__global__ void __launch_bounds__(SP_THREADS)
mona_spatial_fwd_kernel(const float* __restrict__ zd, const float* __restrict__ mask,
                        const float* __restrict__ prm, float* __restrict__ zcat,
                        T* __restrict__ gd, float* __restrict__ y2, float* __restrict__ img,
                        int n, int d, int h, int w, int has_noise) {
  extern __shared__ __align__(16) float sm[];
  const Off o(d);
  const int b = blockIdx.x, s = blockIdx.y, tid = threadIdx.x, c = tid % MC;
  const int sr = strip_rows(h, gridDim.y), y0 = s * sr, rows = min(h, y0 + sr) - y0;
  const int rp = rows + 2 * MH, wp = w + 2 * MH, hw = h * w;
  float* fp = sm;                   // [rp * wp][MC]  f = s * freq, the strip and its halo
  float* ys = fp + rp * wp * MC;    // [rows * w][MC] y
  float* kern = ys + rows * w * MC;  // [MT][MC]      the mixed kernel
  float* pooled = kern + MT * MC;   // [MC]
  float* biasw = pooled + MC;       // [MC]
  float* a1p = biasw + MC;          // [MC4]
  float* a1 = a1p + MC4;            // [MC4]
  float* wts = a1 + MC4;            // [4]
  float* red = wts + 4;             // [SP_THREADS]
  const float* zb = zd + (size_t)b * n * MC;
  const float fr = prm[o.freq + c];

  for (int i = tid; i < rp * wp * MC; i += SP_THREADS) {
    const int pix = i / MC, yy = y0 - MH + pix / wp, xx = pix % wp - MH;
    float v = 0.f;
    if (yy >= 0 && yy < h && xx >= 0 && xx < w) v = zb[(size_t)(1 + yy * w + xx) * MC + c] * fr;
    fp[i] = v;
  }
  if (has_noise) {
    // GAP over the whole image: pixel groups tid / MC, then the groups in order
    float acc = 0.f;
    for (int pix = tid / MC; pix < hw; pix += SP_THREADS / MC)
      acc += zb[(size_t)(1 + pix) * MC + c] * fr;
    red[tid] = acc;
    __syncthreads();
    if (tid < MC) {
      float sum = 0.f;
      for (int gi = 0; gi < SP_THREADS / MC; ++gi) sum += red[gi * MC + tid];
      pooled[tid] = sum / hw;
    }
    __syncthreads();
    if (tid < MC4) {
      float a = 0.f;
      for (int k = 0; k < MC; ++k) a = fmaf(pooled[k], prm[o.f1w + k * MC4 + tid], a);
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
  if (s == 0) {  // the image's saved state, once
    float* ib = img + (size_t)b * IMG_LEN;
    if (tid < 4) ib[IMG_WTS + tid] = tid < 3 ? wts[tid] : 0.f;
    if (tid < MC) ib[IMG_POOL + tid] = has_noise ? pooled[tid] : 0.f;
    if (tid < MC4) ib[IMG_A1 + tid] = has_noise ? a1p[tid] : 0.f;
  }
  mix_taps(wts, prm, o, kern);
  if (tid < MC)
    biasw[tid] = wts[0] * prm[o.tapb + tid] + wts[1] * prm[o.tapb + MC + tid] +
                 wts[2] * prm[o.tapb + 2 * MC + tid];
  __syncthreads();

  // the stencil over the strip's pixels; a thread's channel is fixed, its
  // 49 taps in registers
  {
    float kr[MT];
#pragma unroll
    for (int t = 0; t < MT; ++t) kr[t] = kern[t * MC + c];
    const float bc = biasw[c];
    for (int i = tid; i < rows * w * MC; i += SP_THREADS) {
      const int pix = i / MC, yl = pix / w, x = pix % w, gp = y0 * w + pix;
      float acc = zb[(size_t)(1 + gp) * MC + c] + bc;
#pragma unroll
      for (int di = 0; di < MK; ++di)
#pragma unroll
        for (int dj = 0; dj < MK; ++dj)
          acc = fmaf(fp[((yl + di) * wp + x + dj) * MC + c], kr[di * MK + dj], acc);
      ys[i] = acc;
      y2[((size_t)b * hw + gp) * MC + c] = acc;
    }
  }
  __syncthreads();

  // o = y + round(y) @ round(pw) + b_pw, then gelu(o) * mask: the strip's
  // rows; a thread's output channel is fixed, its column of pw in registers
  {
    float pc[MC];
#pragma unroll
    for (int k = 0; k < MC; ++k) pc[k] = prm[o.pw + k * MC + c];
    const float pb = prm[o.pb + c];
    for (int i = tid; i < rows * w * MC; i += SP_THREADS) {
      const int pix = i / MC;
      float pwp = 0.f;
#pragma unroll
      for (int k = 0; k < MC; ++k) pwp = fmaf(round_to<T>(ys[pix * MC + k]), pc[k], pwp);
      const float zc = ys[i] + pwp + pb;
      const size_t gi = ((size_t)b * n + 1 + y0 * w + pix) * MC + c;
      zcat[gi] = zc;
      gd[gi] = from_f32<T>(act_fwd(ACT_GELU, zc) * mask[gi]);
    }
  }
  // the CLS row and the tail rows take zd as it is (the first strip)
  if (s == 0)
    for (int i = tid; i < (n - hw) * MC; i += SP_THREADS) {
      const int r = i / MC, row = r == 0 ? 0 : hw + r;
      const size_t gi = ((size_t)b * n + row) * MC + c;
      const float zc = zb[(size_t)row * MC + c];
      zcat[gi] = zc;
      gd[gi] = from_f32<T>(act_fwd(ACT_GELU, zc) * mask[gi]);
    }
}

// a float of CTA `cta` of the cluster at the shared-memory offset of p
__device__ __forceinline__ float ld_cluster(const float* p, uint32_t cta) {
  uint32_t remote;
  float v;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(remote)
               : "r"(static_cast<uint32_t>(__cvta_generic_to_shared(p))), "r"(cta));
  asm volatile("ld.shared::cluster.f32 %0, [%1];\n" : "=f"(v) : "r"(remote) : "memory");
  return v;
}

__device__ __forceinline__ void cluster_barrier() {
  asm volatile(
      "barrier.cluster.arrive.release.aligned;\n"
      "barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// the backward's regions: X holds d(o) over the strip and its halo rows,
// then f padded; S round(y) of the strip's pixels, then round(pw)^T; Y dy
// padded; K the strip's tap gradients, then the mixed kernel
static inline size_t spatial_bwd_smem(int h, int w, int strips) {
  const int r = strip_rows(h, strips), pad = (r + 2 * MH) * (w + 2 * MH);
  return sizeof(float) * ((size_t)(2 * pad + max(r * w, MC) + MT) * MC + 5 * MC + MC4 + 12 +
                          SP_THREADS);
}

template <typename T>
__global__ void __launch_bounds__(SP_THREADS)
mona_spatial_bwd_kernel(const float* __restrict__ dgd, const float* __restrict__ mask,
                        const float* __restrict__ zcat, const float* __restrict__ zd,
                        const float* __restrict__ y2, const float* __restrict__ img,
                        const float* __restrict__ prm, float* __restrict__ dzd,
                        T* __restrict__ dzd_t, float* __restrict__ part, int n, int d, int h,
                        int w, int has_freq, int has_noise) {
  extern __shared__ __align__(16) float sm[];
  const Off o(d);
  const int b = blockIdx.x, s = blockIdx.y, strips = gridDim.y, tid = threadIdx.x;
  const int sr = strip_rows(h, strips), y0 = s * sr, rows = min(h, y0 + sr) - y0;
  const int rp = rows + 2 * MH, wp = w + 2 * MH, hw = h * w, np = rows * w;
  // laid out for the longest strip, so every strip of the cluster holds dw3
  // at the same offset
  const int pad_max = (sr + 2 * MH) * wp;
  float* X = sm;                               // [rp * wp][MC]
  float* S = X + pad_max * MC;                 // [max(np, MC)][MC]
  float* Y = S + max(sr * w, MC) * MC;         // [rp * wp][MC], zero outside the image
  float* K = Y + pad_max * MC;                 // [MT][MC]
  float* dbiasw = K + MT * MC;                 // [MC]
  float* dpool = dbiasw + MC;                  // [MC]
  float* tmp = dpool + MC;                     // [3][MC]
  float* da1 = tmp + 3 * MC;                   // [MC4]
  float* dl = da1 + MC4;                       // [4]
  float* wts = dl + 4;                         // [4]
  float* dw3 = wts + 4;                        // [4] this strip's share of d(wts)
  float* red = dw3 + 4;                        // [SP_THREADS]
  const float* ib = img + (size_t)b * IMG_LEN;
  float* pt = part + ((size_t)b * strips + s) * P2_LEN;
  const size_t rb = (size_t)b * n;
  if (tid < 4) wts[tid] = ib[IMG_WTS + tid];

  // d(zcat) = dgd * mask * gelu'(zcat): the strip's rows and MH halo rows
  // each side (zero outside the image) into X as [rp * w]; the CLS and tail
  // rows (the first strip) are d(zd) as they are
  for (int i = tid; i < rp * w * MC; i += SP_THREADS) {
    const int pix = i / MC, yy = y0 - MH + pix / w, x = pix % w;
    float v = 0.f;
    if (yy >= 0 && yy < h) {
      const size_t gi = (rb + 1 + yy * w + x) * MC + i % MC;
      v = dgd[gi] * mask[gi] * act_grad(ACT_GELU, zcat[gi]);
    }
    X[i] = v;
  }
  if (s == 0)
    for (int i = tid; i < (n - hw) * MC; i += SP_THREADS) {
      const int r = i / MC, row = r == 0 ? 0 : hw + r;
      const size_t gi = (rb + row) * MC + i % MC;
      const float v = dgd[gi] * mask[gi] * act_grad(ACT_GELU, zcat[gi]);
      dzd[gi] = v;
      if (dzd_t) dzd_t[gi] = from_f32<T>(v);
    }
  for (int i = tid; i < rp * wp * MC; i += SP_THREADS) Y[i] = 0.f;
  for (int i = tid; i < np * MC; i += SP_THREADS)
    S[i] = round_to<T>(y2[((size_t)b * hw + y0 * w) * MC + i]);
  __syncthreads();

  // pw's bias and weight over the strip's pixels: sums of d(o) and
  // round(y)^T round(d(o)); a thread's output channel is co = tid % MC,
  // its rows k = tid / MC + 8j
  const float* Xs = X + MH * w * MC;  // the strip's own rows of d(o)
  constexpr int KJ = MC / (SP_THREADS / MC);
  if (tid < MC) {
    float sum = 0.f;
    for (int pix = 0; pix < np; ++pix) sum += Xs[pix * MC + tid];
    pt[P2_PB + tid] = sum;
  }
  {
    const int co = tid % MC, k0 = tid / MC;
    float acc[KJ] = {};
    for (int pix = 0; pix < np; ++pix) {
      const float dv = round_to<T>(Xs[pix * MC + co]);
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
  // dy = d(o) + round(d(o)) @ round(pw)^T over the strip and its halo rows
  // inside the image, into Y's interior
  for (int i = tid; i < rp * w * MC; i += SP_THREADS) {
    const int ci = i % MC, pix = i / MC, lr = pix / w, x = pix % w, yy = y0 - MH + lr;
    if (yy < 0 || yy >= h) continue;
    float a = 0.f;
#pragma unroll 8
    for (int co = 0; co < MC; ++co) a = fmaf(round_to<T>(X[pix * MC + co]), S[co * MC + ci], a);
    Y[(lr * wp + x + MH) * MC + ci] = X[i] + a;
  }
  __syncthreads();

  // X <- f = s * freq over the strip and its halo rows, zero outside the image
  for (int i = tid; i < rp * wp * MC; i += SP_THREADS) {
    const int c = i % MC, pix = i / MC, yy = y0 - MH + pix / wp, xx = pix % wp - MH;
    float v = 0.f;
    if (yy >= 0 && yy < h && xx >= 0 && xx < w)
      v = zd[(rb + 1 + yy * w + xx) * MC + c] * prm[o.freq + c];
    X[i] = v;
  }
  __syncthreads();

  // the strip's dk[tap][c] = sum over its pixels of dy * the tap-shifted f;
  // dbias = sum of dy. A thread's channel is c = tid % MC, its taps t =
  // tid / MC + 8j
  {
    constexpr int TJ = (MT * MC + SP_THREADS - 1) / SP_THREADS;
    const int c = tid % MC, t0 = tid / MC;
    float acc[TJ] = {};
    for (int yl = 0; yl < rows; ++yl)
      for (int x = 0; x < w; ++x) {
        const float dv = Y[((yl + MH) * wp + x + MH) * MC + c];
#pragma unroll
        for (int j = 0; j < TJ; ++j) {
          const int t = min(t0 + j * (SP_THREADS / MC), MT - 1);
          acc[j] = fmaf(dv, X[((yl + t / MK) * wp + x + t % MK) * MC + c], acc[j]);
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
    float sum = 0.f;
    for (int yl = 0; yl < rows; ++yl)
      for (int x = 0; x < w; ++x) sum += Y[((yl + MH) * wp + x + MH) * MC + tid];
    dbiasw[tid] = sum;
    for (int tt = 0; tt < 3; ++tt) pt[P2_TAPB + tt * MC + tid] = wts[tt] * sum;
  }
  __syncthreads();

  // the noise MLP's backward: d(wts)[t] = sum over c of (sum over taps of
  // dk taps_t + dbias tapb_t), each strip's share summed over the cluster
  // in rank order, so every strip of the image holds the same d(wts)
  const bool lead = s == 0;
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
    if (tid < 3) {
      float sum = 0.f;
      for (int c = 0; c < MC; ++c) sum += tmp[tid * MC + c];
      dw3[tid] = sum;
    }
    cluster_barrier();  // every strip's share is in its shared memory
    if (tid == 0) {
      float dw[3] = {0.f, 0.f, 0.f}, dot = 0.f;
      for (int r = 0; r < strips; ++r)
        for (int t = 0; t < 3; ++t) dw[t] += ld_cluster(&dw3[t], r);
      for (int t = 0; t < 3; ++t) dot += dw[t] * wts[t];
      for (int t = 0; t < 3; ++t) dl[t] = wts[t] * (dw[t] - dot);
    }
    cluster_barrier();  // every strip has read the others' shares
    if (tid < MC4) {
      float a = 0.f;
      for (int t = 0; t < 3; ++t) a = fmaf(dl[t], prm[o.f2w + tid * 3 + t], a);
      da1[tid] = a1p[tid] > 0.f ? a : 0.f;
    }
    if (tid < MC4 * 3) pt[P2_F2W + tid] = lead ? fmaxf(a1p[tid / 3], 0.f) * dl[tid % 3] : 0.f;
    if (tid < 3) pt[P2_F2B + tid] = lead ? dl[tid] : 0.f;
    __syncthreads();
    for (int i = tid; i < MC * MC4; i += SP_THREADS)
      pt[P2_F1W + i] = lead ? pooled[i / MC4] * da1[i % MC4] : 0.f;
    if (tid < MC4) pt[P2_F1B + tid] = lead ? da1[tid] : 0.f;
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
  for (int i = tid; i < np * MC; i += SP_THREADS) {
    const int c = i % MC, pix = i / MC, yl = pix / w, x = pix % w;
    float a = 0.f;
#pragma unroll
    for (int di = 0; di < MK; ++di)
#pragma unroll
      for (int dj = 0; dj < MK; ++dj)
        a = fmaf(Y[((yl + 2 * MH - di) * wp + x + 2 * MH - dj) * MC + c],
                 K[(di * MK + dj) * MC + c], a);
    const float df = a + dpool[c];
    const float dy = Y[((yl + MH) * wp + x + MH) * MC + c];
    const size_t gi = (rb + 1 + y0 * w + pix) * MC + c;
    const float v = has_freq ? dy + df * prm[o.freq + c] : dy + df;
    if (has_freq) pf = fmaf(zd[gi], df, pf);
    dzd[gi] = v;
    if (dzd_t) dzd_t[gi] = from_f32<T>(v);
  }
  red[tid] = pf;
  __syncthreads();
  if (tid < MC) {
    float sum = 0.f;
    for (int t = tid; t < SP_THREADS; t += MC) sum += red[t];
    pt[P2_FREQ + tid] = sum;
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

// out[l] = the sum over s of part[s][l]: a block takes 32 outputs, its warp
// w the splits w, w + 8, ... in order (each lane one output, the loads of a
// warp 128 contiguous bytes), then the eight warps' sums are added in warp
// order: a fixed order, the same in every call
constexpr int SUM_WARPS = 8;

__global__ void __launch_bounds__(32 * SUM_WARPS)
sum_splits_kernel(const float* __restrict__ part, float* __restrict__ out, int splits, int rows,
                  int cols, int transpose) {
  __shared__ float red[SUM_WARPS][32];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int len = rows * cols, l = blockIdx.x * 32 + lane;
  float a = 0.f;
  if (l < len)
    for (int s = warp; s < splits; s += SUM_WARPS) a += part[(size_t)s * len + l];
  red[warp][lane] = a;
  __syncthreads();
  if (warp || l >= len) return;
  float sum = 0.f;
#pragma unroll
  for (int w = 0; w < SUM_WARPS; ++w) sum += red[w][lane];
  out[transpose ? (size_t)(l % cols) * rows + l / cols : (size_t)l] = sum;
}

// out [len] = the partials [splits, len] summed; with transpose the
// partials are [splits, rows, cols] and out [cols, rows] (dW_down from its
// transposed partials)
cudaError_t sum_splits(const float* part, float* out, int splits, int len, cudaStream_t st,
                       int rows = 1, bool transpose = false) {
  const int cols = transpose ? len / rows : len;
  sum_splits_kernel<<<(len + 31) / 32, 32 * SUM_WARPS, 0, st>>>(part, out, splits,
                                                                transpose ? rows : 1, cols,
                                                                transpose);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bf16: the products on wgmma (hopper_gemm.cuh's core and the weight-gradient
// kernel below), the LayerNorm backward over row tiles
// ---------------------------------------------------------------------------

// forward (a), bf16: the row statistics and z1, one warp per row, each lane
// 8 contiguous values (16 bytes) of every 256 held in registers; z1 is the
// down product's A operand and is kept for the dW_down product
constexpr int Z1_IT = 6;  // 256-column steps of a row: d <= 1536 (LR_MAX_D)

__global__ void __launch_bounds__(256)
mona_z1_kernel(const __nv_bfloat16* __restrict__ x, const float* __restrict__ prm,
               float* __restrict__ stats, __nv_bfloat16* __restrict__ z1, int m, int d) {
  const int row = (blockIdx.x * blockDim.x + threadIdx.x) >> 5, lane = threadIdx.x & 31;
  if (row >= m) return;
  const size_t at = (size_t)row * d;
  float v[Z1_IT][8];
  float sum = 0.f;
#pragma unroll
  for (int i = 0; i < Z1_IT; ++i) {
    const int j = 8 * lane + 256 * i;
    if (j < d) {
      const uint4 raw = *reinterpret_cast<const uint4*>(x + at + j);
      const __nv_bfloat162* p2 = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 f = __bfloat1622float2(p2[e]);
        v[i][2 * e] = f.x, v[i][2 * e + 1] = f.y;
        sum += f.x + f.y;
      }
    }
  }
  const float mean = warp_sum(sum) / d;
  float var = 0.f;
#pragma unroll
  for (int i = 0; i < Z1_IT; ++i)
    if (8 * lane + 256 * i < d)
#pragma unroll
      for (int e = 0; e < 8; ++e) var += (v[i][e] - mean) * (v[i][e] - mean);
  const float rstd = rsqrtf(warp_sum(var) / d + 1e-5f);
  if (lane == 0) stats[2 * (size_t)row] = mean, stats[2 * (size_t)row + 1] = rstd;
#pragma unroll
  for (int i = 0; i < Z1_IT; ++i) {
    const int j = 8 * lane + 256 * i;
    if (j >= d) continue;
    // LN scale, LN bias, gamma, gammax at columns j..j+7 (ln_z's arithmetic)
    float pc[4][8];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float4* src = reinterpret_cast<const float4*>(prm + k * d + j);  // lns, lnb, g, gx
      const float4 lo = __ldg(src), hi = __ldg(src + 1);
      pc[k][0] = lo.x, pc[k][1] = lo.y, pc[k][2] = lo.z, pc[k][3] = lo.w;
      pc[k][4] = hi.x, pc[k][5] = hi.y, pc[k][6] = hi.z, pc[k][7] = hi.w;
    }
    float out[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const float xh = (v[i][e] - mean) * rstd;
      const float z0 = round_to<__nv_bfloat16>(__fadd_rn(__fmul_rn(xh, pc[0][e]), pc[1][e]));
      const float a = round_to<__nv_bfloat16>(__fmul_rn(z0, round_to<__nv_bfloat16>(pc[2][e])));
      const float c = round_to<__nv_bfloat16>(
          __fmul_rn(v[i][e], round_to<__nv_bfloat16>(pc[3][e])));
      out[e] = __fadd_rn(a, c);
    }
    uint4 raw;
    __nv_bfloat162* p2 = reinterpret_cast<__nv_bfloat162*>(&raw);
#pragma unroll
    for (int e = 0; e < 4; ++e) p2[e] = __floats2bfloat162_rn(out[2 * e], out[2 * e + 1]);
    *reinterpret_cast<uint4*>(z1 + at + j) = raw;
  }
}

// backward (f): the LayerNorm backward with d(z1) given (float32, the wgmma
// product round(d(zd)) @ round(W_down)^T). A CTA takes `rows_per` rows (two
// CTAs fit an SM), 16 at a time staged in shared memory (x, g in bf16, d(z1)
// in float32), 16 bytes of d(z1) a lane per load: one
// warp per row writes dx, then every thread adds the staged rows into its
// columns' sums [LN scale | LN bias | gamma | gammax | b_up], in row order;
// the CTA's partial row of 5D + 64 (b_down: d(zd) summed over its rows) is
// summed with the other CTAs' in order by sum_splits
constexpr int LR_THREADS = 512, LR_ROWS = LR_THREADS / 32, LR_KC = 3;
constexpr int LR_MAX_D = LR_KC * LR_THREADS;  // 1536: the staged rows fit in shared memory

static inline size_t ln_rows_smem(int d) {
  return (size_t)LR_ROWS * d * (4 + 2 + 2) + LR_ROWS * (2 + MC) * sizeof(float);
}

__global__ void __launch_bounds__(LR_THREADS)
mona_ln_bwd_rows_kernel(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ g,
                        const float* __restrict__ stats, const float* __restrict__ dz1,
                        const float* __restrict__ dzd, const float* __restrict__ prm,
                        __nv_bfloat16* __restrict__ dx, float* __restrict__ part, int m, int d,
                        int rows_per) {
  using bf16 = __nv_bfloat16;
  using bf162 = __nv_bfloat162;
  extern __shared__ __align__(16) unsigned char lsm[];
  float* zs = reinterpret_cast<float*>(lsm);            // [LR_ROWS][d]  d(z1)
  bf16* xs = reinterpret_cast<bf16*>(zs + LR_ROWS * d);  // [LR_ROWS][d]  x
  bf16* gs = xs + LR_ROWS * d;                           // [LR_ROWS][d]  g
  float* st = reinterpret_cast<float*>(gs + LR_ROWS * d);  // [LR_ROWS][2] mean, rstd
  float* ds = st + 2 * LR_ROWS;                            // [LR_ROWS][MC] d(zd)
  const Off o(d);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int row0 = blockIdx.x * rows_per, row1 = min(m, row0 + rows_per);
  float s_lns[LR_KC] = {}, s_lnb[LR_KC] = {}, s_g[LR_KC] = {}, s_gx[LR_KC] = {},
        s_ub[LR_KC] = {}, s_db = 0.f;
  float c_lns[LR_KC], c_lnb[LR_KC], c_gam[LR_KC];
#pragma unroll
  for (int k = 0; k < LR_KC; ++k) {
    const int j = min(tid + k * LR_THREADS, d - 1);
    c_lns[k] = prm[o.lns + j], c_lnb[k] = prm[o.lnb + j], c_gam[k] = prm[o.g + j];
  }
  for (int r0 = row0; r0 < row1; r0 += LR_ROWS) {
    const int r = r0 + warp;
    if (r < row1) {
      const float mean = stats[2 * (size_t)r], rstd = stats[2 * (size_t)r + 1];
      if (lane == 0) st[2 * warp] = mean, st[2 * warp + 1] = rstd;
      const size_t at = (size_t)r * d;
      *reinterpret_cast<float2*>(ds + warp * MC + 2 * lane) =
          *reinterpret_cast<const float2*>(dzd + (size_t)r * MC + 2 * lane);
      float m1 = 0.f, m2 = 0.f;
#pragma unroll 3
      for (int j = 4 * lane; j < d; j += 128) {  // 16 bytes of d(z1), 8 of x and g a lane
        const float4 v = *reinterpret_cast<const float4*>(dz1 + at + j);
        const uint2 xv = *reinterpret_cast<const uint2*>(x + at + j);
        *reinterpret_cast<float4*>(zs + warp * d + j) = v;
        *reinterpret_cast<uint2*>(xs + warp * d + j) = xv;
        *reinterpret_cast<uint2*>(gs + warp * d + j) = *reinterpret_cast<const uint2*>(g + at + j);
        const float2 x01 = __bfloat1622float2(reinterpret_cast<const bf162*>(&xv)[0]);
        const float2 x23 = __bfloat1622float2(reinterpret_cast<const bf162*>(&xv)[1]);
        const float4 gq = __ldg(reinterpret_cast<const float4*>(prm + o.g + j));
        const float4 lq = __ldg(reinterpret_cast<const float4*>(prm + o.lns + j));
        const float vv[4] = {v.x, v.y, v.z, v.w}, xf[4] = {x01.x, x01.y, x23.x, x23.y};
        const float gg[4] = {gq.x, gq.y, gq.z, gq.w}, ll[4] = {lq.x, lq.y, lq.z, lq.w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float dxh = vv[e] * gg[e] * ll[e];
          m1 += dxh;
          m2 += dxh * ((xf[e] - mean) * rstd);
        }
      }
      if (dx) {
        // dx = g + (dxhat - mean(dxhat) - xhat mean(dxhat xhat)) rstd + d(z1) gammax,
        // dxhat = d(z1) gamma scale, from this warp's own staged row
        m1 = warp_sum(m1) / d;
        m2 = warp_sum(m2) / d;
        __syncwarp();
#pragma unroll 3
        for (int j = 4 * lane; j < d; j += 128) {
          const float4 v = *reinterpret_cast<const float4*>(zs + warp * d + j);
          const uint2 xv = *reinterpret_cast<const uint2*>(xs + warp * d + j);
          const uint2 gv = *reinterpret_cast<const uint2*>(gs + warp * d + j);
          const float2 x01 = __bfloat1622float2(reinterpret_cast<const bf162*>(&xv)[0]);
          const float2 x23 = __bfloat1622float2(reinterpret_cast<const bf162*>(&xv)[1]);
          const float2 g01 = __bfloat1622float2(reinterpret_cast<const bf162*>(&gv)[0]);
          const float2 g23 = __bfloat1622float2(reinterpret_cast<const bf162*>(&gv)[1]);
          const float vv[4] = {v.x, v.y, v.z, v.w}, xf[4] = {x01.x, x01.y, x23.x, x23.y};
          const float gf[4] = {g01.x, g01.y, g23.x, g23.y};
          const float4 gq = __ldg(reinterpret_cast<const float4*>(prm + o.g + j));
          const float4 lq = __ldg(reinterpret_cast<const float4*>(prm + o.lns + j));
          const float4 xq = __ldg(reinterpret_cast<const float4*>(prm + o.gx + j));
          const float gg[4] = {gq.x, gq.y, gq.z, gq.w}, ll[4] = {lq.x, lq.y, lq.z, lq.w};
          const float gx[4] = {xq.x, xq.y, xq.z, xq.w};
          float out[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float dxh = vv[e] * gg[e] * ll[e];
            out[e] = gf[e] + (dxh - m1 - (xf[e] - mean) * rstd * m2) * rstd + vv[e] * gx[e];
          }
          uint2 ov;
          reinterpret_cast<bf162*>(&ov)[0] = __floats2bfloat162_rn(out[0], out[1]);
          reinterpret_cast<bf162*>(&ov)[1] = __floats2bfloat162_rn(out[2], out[3]);
          *reinterpret_cast<uint2*>(dx + at + j) = ov;
        }
      }
    }
    __syncthreads();
    const int nr = min(LR_ROWS, row1 - r0);
#pragma unroll
    for (int k = 0; k < LR_KC; ++k) {
      const int j = tid + k * LR_THREADS;
      if (j >= d) break;
      for (int rr = 0; rr < nr; ++rr) {
        const float xv = __bfloat162float(xs[rr * d + j]), v = zs[rr * d + j];
        const float xh = (xv - st[2 * rr]) * st[2 * rr + 1];
        const float z0 = round_to<bf16>(__fadd_rn(__fmul_rn(xh, c_lns[k]), c_lnb[k]));
        const float dz0 = v * c_gam[k];
        s_lns[k] += dz0 * xh;
        s_lnb[k] += dz0;
        s_g[k] += v * z0;
        s_gx[k] += v * xv;
        s_ub[k] += __bfloat162float(gs[rr * d + j]);
      }
    }
    if (tid < MC)
      for (int rr = 0; rr < nr; ++rr) s_db += ds[rr * MC + tid];
    __syncthreads();
  }
  float* pt = part + (size_t)blockIdx.x * (5 * d + MC);
#pragma unroll
  for (int k = 0; k < LR_KC; ++k) {
    const int j = tid + k * LR_THREADS;
    if (j >= d) break;
    pt[j] = s_lns[k];
    pt[d + j] = s_lnb[k];
    pt[2 * d + j] = s_g[k];
    pt[3 * d + j] = s_gx[k];
    pt[4 * d + j] = s_ub[k];
  }
  if (tid < MC) pt[5 * d + tid] = s_db;
}

// backward (g): the two weight gradients on wgmma, one launch. Product z of
// CTA (q tile, split, z): part[z][split] [64, d] = A_z^T B_z over the
// split's rows, A_z [m, 64] and B_z [m, d] bf16 row-major: z = 0 is dW_up
// = round(gd)^T round(g), z = 1 is dW_down^T = round(d(zd))^T round(z1).
// The rows are the product's K: TMA brings 64 of them at a time (a 64 x
// 64 box of A, WG_J boxes of B) into a ring of WG_STAGES stages, and one
// warpgroup issues m64n64k16 products with both operands MN-major (the
// transpose bits), 4 per box; the rows past m are zero-filled. Each CTA
// stores its float32 partial from the registers; sum_splits adds the
// splits in order (no atomics)
constexpr int WG_STAGES = 4, WG_BOX = 64 * 64 * 2;  // 64 rows x 64 bf16 columns, 8 KB

// WG_J B boxes per stage: 128 columns a CTA where 128 divides d, else 64
template <int WG_J> constexpr int wgrad_smem() {
  return WG_STAGES * (1 + WG_J) * WG_BOX + WG_STAGES * 8 + 1024;
}

struct WgradParams {
  hopper::TmaMatrix a[2], b[2];  // boxes of 64 columns x 64 rows
  float* part[2];                // [splits][64][d]
  int m, d, chunks_per;          // rows, B's columns, 64-row chunks per split
};

template <int WG_J>
__global__ void __launch_bounds__(128) mona_wgrad_kernel(const __grid_constant__ WgradParams p) {
  using namespace hopper;
  constexpr int STAGE = (1 + WG_J) * WG_BOX;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(base + WG_STAGES * STAGE);
  const int t = threadIdx.x, z = blockIdx.z, q0 = blockIdx.x * WG_J * 64;
  const int c0 = blockIdx.y * p.chunks_per;
  const int n_ch = max(0, min((p.m + 63) / 64 - c0, p.chunks_per));
  if (t == 0) {
    for (int s = 0; s < WG_STAGES; ++s) mbar_init(&full[s], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  auto load = [&](int i) {  // chunk i of the split into stage i % WG_STAGES
    unsigned char* st = base + (i % WG_STAGES) * STAGE;
    uint64_t* bar = &full[i % WG_STAGES];
    mbar_expect_tx(bar, STAGE);
    const int ca[4] = {0, (c0 + i) * 64, 0, 0};
    tma_load(st, &p.a[z].map[0], bar, 3, ca);
    for (int jb = 0; jb < WG_J; ++jb) {
      const int cb[4] = {q0 + jb * 64, (c0 + i) * 64, 0, 0};
      tma_load(st + (1 + jb) * WG_BOX, &p.b[z].map[0], bar, 3, cb);
    }
  };
  if (t == 0)
    for (int i = 0; i < min(n_ch, WG_STAGES); ++i) load(i);
  float acc[WG_J][32];
#pragma unroll
  for (int jb = 0; jb < WG_J; ++jb)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[jb][i] = 0.f;
  for (int i = 0; i < n_ch; ++i) {
    mbar_wait(&full[i % WG_STAGES], (i / WG_STAGES) & 1);
    const unsigned char* st = base + (i % WG_STAGES) * STAGE;
    const uint64_t da = smem_desc(st);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)  // 16 rows = two 8-row groups = 2048 bytes on
#pragma unroll
      for (int jb = 0; jb < WG_J; ++jb)
        wgmma_bf16_tt64(acc[jb], da + kk * (2048 >> 4),
                        smem_desc(st + (1 + jb) * WG_BOX) + kk * (2048 >> 4), 1);
    wgmma_commit();
    wgmma_wait<0>();
#pragma unroll
    for (int jb = 0; jb < WG_J; ++jb) fence_regs(acc[jb]);
    if (t == 0 && i + WG_STAGES < n_ch) load(i + WG_STAGES);  // the stage's products retired
  }
  const int warp = t / 32, lane = t % 32, r = warp * 16 + lane / 4, quad = lane % 4;
  float* out = p.part[z] + (size_t)blockIdx.y * 64 * p.d;
#pragma unroll
  for (int jb = 0; jb < WG_J; ++jb)
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int c = q0 + jb * 64 + j * 8 + 2 * quad;
      *reinterpret_cast<float2*>(out + (size_t)r * p.d + c) =
          make_float2(acc[jb][4 * j], acc[jb][4 * j + 1]);
      *reinterpret_cast<float2*>(out + (size_t)(r + 8) * p.d + c) =
          make_float2(acc[jb][4 * j + 2], acc[jb][4 * j + 3]);
    }
}

template <int WG_J>
cudaError_t launch_wgrad(const WgradParams& p, int splits, cudaStream_t st) {
  cudaError_t err = cudaFuncSetAttribute(mona_wgrad_kernel<WG_J>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         wgrad_smem<WG_J>());
  if (err != cudaSuccess) return err;
  mona_wgrad_kernel<WG_J><<<dim3(p.d / (WG_J * 64), splits, 2), 128, wgrad_smem<WG_J>(), st>>>(p);
  return cudaGetLastError();
}

// the products' tiles, fixed from tools/epilogue_bench.cu: the down and dgd
// products ([m, d] x [d, 64], float32 out) at 128 x 64 and 4 stages, the up
// product ([m, 64] x [64, d], one K step, the staged two-rounding epilogue)
// at 128 x 128 and 3, d(z1) ([m, 64] x [64, d], float32 out) at 128 x 128
// and 4
constexpr int NARROW_STAGES = 4, UP_BN = 128, UP_STAGES = 3, DZ1_BN = 128, DZ1_STAGES = 4;

// strips: 1 to 4 strips of rows, none empty, whose kernels fit in shared memory
bool shape_ok(int b, int n, int d, int h, int w, int strips) {
  return b >= 1 && h >= 1 && w >= 1 && n >= h * w + 1 && d % 64 == 0 && d >= 64 &&
         strips >= 1 && strips <= 4 && (strips - 1) * strip_rows(h, strips) < h &&
         spatial_fwd_smem(h, w, strips) <= 232448 && spatial_bwd_smem(h, w, strips) <= 232448;
}

// the image's strips are one cluster (their shares of d(wts) are exchanged)
template <typename T>
cudaError_t spatial_bwd(const float* dgd, const float* mask, const float* zcat, const float* zd,
                        const float* y2, const float* img, const float* prm, float* dzd, T* dzd_t,
                        float* part, int b, int n, int d, int h, int w, int has_freq,
                        int has_noise, int strips, cudaStream_t st) {
  const size_t smem = spatial_bwd_smem(h, w, strips);
  cudaError_t err = cudaFuncSetAttribute(mona_spatial_bwd_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1, attr[0].val.clusterDim.y = strips, attr[0].val.clusterDim.z = 1;
  cfg.gridDim = dim3(b, strips), cfg.blockDim = dim3(SP_THREADS);
  cfg.dynamicSmemBytes = smem, cfg.stream = st, cfg.attrs = attr, cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, mona_spatial_bwd_kernel<T>, dgd, mask, zcat, zd, y2, img, prm,
                           dzd, dzd_t, part, n, d, h, w, has_freq, has_noise);
  return err != cudaSuccess ? err : cudaGetLastError();
}

template <typename T>
cudaError_t mona_fwd(const void* x, const float* mask, const float* prm, const void* uw,
                     const void* uw_t, const void* wd_t, void* out, float* stats, float* zd,
                     float* zcat, void* gd, float* y2, float* img, void* z1, int b, int n, int d,
                     int h, int w, int has_noise, int strips, cudaStream_t st) {
  const int m = b * n;
  const Off o(d);
  cudaError_t err;
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    // (a) z1 in bf16, then zd = z1 @ W_down + b_down on the core (W_down^T
    // [64, d], K-major), stored float32 from the registers
    mona_z1_kernel<<<(m + 7) / 8, 256, 0, st>>>(static_cast<const T*>(x), prm, stats,
                                               static_cast<T*>(z1), m, d);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    hopper::TmaMatrix a, unused = hopper::TmaMatrix{};
    if ((err = hopper::rows_matrix(a, z1, 1, m, d, hopper::BM)) != cudaSuccess) return err;
    err = hopper::gemm<64, NARROW_STAGES>(a, wd_t, unused,
                                          hopper::StoreF32Epilogue{prm + o.db, zd, MC}, 1, m,
                                          MC, d, st);
  } else {
    mona_down_kernel<T><<<(m + DN_TM - 1) / DN_TM, DN_THREADS, 0, st>>>(
        static_cast<const T*>(x), prm, stats, zd, m, d);
    err = cudaGetLastError();
  }
  if (err != cudaSuccess) return err;
  const size_t smem = spatial_fwd_smem(h, w, strips);
  if ((err = cudaFuncSetAttribute(mona_spatial_fwd_kernel<T>,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem)) !=
      cudaSuccess)
    return err;
  mona_spatial_fwd_kernel<T><<<dim3(b, strips), SP_THREADS, smem, st>>>(
      zd, mask, prm, zcat, static_cast<T*>(gd), y2, img, n, d, h, w, has_noise);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  // (c) out = round(x + round(gd @ W_up + b_up))
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    hopper::TmaMatrix a, dst;
    if ((err = hopper::rows_matrix(a, gd, 1, m, MC, hopper::BM)) != cudaSuccess) return err;
    if ((err = hopper::rows_matrix(dst, out, 1, m, d, 64)) != cudaSuccess) return err;
    return hopper::gemm<UP_BN, UP_STAGES>(
        a, uw_t, dst,
        hopper::RoundResidualEpilogue{prm + o.ub, static_cast<const __nv_bfloat16*>(x), d}, 1,
        m, d, MC, st);
  } else {
    Epilogue epi{prm + o.ub, x, dtype_of<T>(), nullptr, ACT_NONE, row_major(out), dtype_of<T>()};
    epi.round_mid = 1;
    return launch_gemm(row_major(gd), uw, dtype_of<T>(), false, epi, m, d, MC, st);
  }
}

template <typename T>
cudaError_t mona_bwd(const void* x, const float* mask, const float* prm, const void* uw,
                     const void* wd, const void* g, const float* stats, const float* zd,
                     const float* zcat, const void* gd, const float* y2, const float* img,
                     const void* z1, void* dx, float* dgd, float* dzd, void* dzd_t, float* dz1,
                     float* part_img, float* part_row, float* part_up, float* part_down,
                     float* grads, int b, int n, int d, int h, int w, int has_freq,
                     int has_noise, int strips, int splits, int rows_per, cudaStream_t st) {
  constexpr bool BF = std::is_same<T, __nv_bfloat16>::value;
  const int m = b * n;
  const int tiles = BF ? (m + rows_per - 1) / rows_per : (m + LB_TM - 1) / LB_TM;
  cudaError_t err;
  if constexpr (BF) {
    // dgd = round(g) @ round(W_up)^T: W_up [64, d] as stored is K-major
    hopper::TmaMatrix a, unused = hopper::TmaMatrix{};
    if ((err = hopper::rows_matrix(a, g, 1, m, d, hopper::BM)) != cudaSuccess) return err;
    err = hopper::gemm<64, NARROW_STAGES>(a, uw, unused,
                                          hopper::StoreF32Epilogue{nullptr, dgd, MC}, 1, m, MC,
                                          d, st);
  } else {
    // dgd = round(g) @ round(W_up)^T
    const Epilogue epi{nullptr, nullptr, 0, nullptr, ACT_NONE, row_major(dgd), F32};
    err = launch_gemm(row_major(g), uw, dtype_of<T>(), true, epi, m, MC, d, st);
  }
  if (err != cudaSuccess) return err;
  err = spatial_bwd<T>(dgd, mask, zcat, zd, y2, img, prm, dzd, static_cast<T*>(dzd_t), part_img,
                       b, n, d, h, w, has_freq, has_noise, strips, st);
  if (err != cudaSuccess) return err;
  if constexpr (BF) {
    // (f) d(z1) = round(d(zd)) @ round(W_down)^T: W_down [d, 64] as stored
    hopper::TmaMatrix a, unused = hopper::TmaMatrix{};
    if ((err = hopper::rows_matrix(a, dzd_t, 1, m, MC, hopper::BM)) != cudaSuccess) return err;
    err = hopper::gemm<DZ1_BN, DZ1_STAGES>(a, wd, unused,
                                           hopper::StoreF32Epilogue{nullptr, dz1, d}, 1, m, d,
                                           MC, st);
    if (err != cudaSuccess) return err;
    const size_t lsmem = ln_rows_smem(d);
    if ((err = cudaFuncSetAttribute(mona_ln_bwd_rows_kernel,
                                    cudaFuncAttributeMaxDynamicSharedMemorySize, (int)lsmem)) !=
        cudaSuccess)
      return err;
    mona_ln_bwd_rows_kernel<<<tiles, LR_THREADS, lsmem, st>>>(
        static_cast<const T*>(x), static_cast<const T*>(g), stats, dz1, dzd, prm,
        static_cast<T*>(dx), part_row, m, d, rows_per);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    // (g) dW_up and dW_down^T, split over the rows
    WgradParams p;
    p.m = m, p.d = d, p.part[0] = part_up, p.part[1] = part_down;
    p.chunks_per = ((m + 63) / 64 + splits - 1) / splits;
    const void* as[2] = {gd, dzd_t};
    const void* bs[2] = {g, z1};
    for (int z = 0; z < 2; ++z) {
      if ((err = hopper::rows_matrix(p.a[z], as[z], 1, m, MC, 64)) != cudaSuccess) return err;
      if ((err = hopper::rows_matrix(p.b[z], bs[z], 1, m, d, 64)) != cudaSuccess) return err;
    }
    err = d % 128 == 0 ? launch_wgrad<2>(p, splits, st) : launch_wgrad<1>(p, splits, st);
    if (err != cudaSuccess) return err;
  } else {
    const size_t lsmem = ln_bwd_smem(d);
    if ((err = cudaFuncSetAttribute(mona_ln_bwd_kernel<T>,
                                    cudaFuncAttributeMaxDynamicSharedMemorySize, (int)lsmem)) !=
        cudaSuccess)
      return err;
    mona_ln_bwd_kernel<T><<<tiles, LB_THREADS, lsmem, st>>>(
        static_cast<const T*>(x), static_cast<const T*>(g), stats, dzd, prm,
        static_cast<T*>(dx), part_row, m, d);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    const int rows_split = (((m + splits - 1) / splits) + CG_R - 1) / CG_R * CG_R;
    // dW_up [MC, d] = round(gd)^T round(g);  dW_down [d, MC] = round(z1)^T round(d(zd))
    colgemm_kernel<<<dim3(d / CG, 1, splits), 256, 0, st>>>(
        LdT<T>{static_cast<const T*>(gd), MC}, LdT<T>{static_cast<const T*>(g), d}, part_up, m,
        MC, d, rows_split);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    colgemm_kernel<<<dim3(1, d / CG, splits), 256, 0, st>>>(
        LdZ1<T>{static_cast<const T*>(x), stats, prm, d}, LdRounded<T>{dzd, MC}, part_down, m, d,
        MC, rows_split);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  float* g_up = grads;
  float* g_down = g_up + MC * d;
  float* g_row = g_down + MC * d;
  float* g_img = g_row + 5 * d + MC;
  if ((err = sum_splits(part_up, g_up, splits, MC * d, st)) != cudaSuccess) return err;
  // bf16: dW_down^T's partials [splits, 64, d], summed into dW_down [d, 64]
  if ((err = sum_splits(part_down, g_down, splits, MC * d, st, MC, BF)) != cudaSuccess)
    return err;
  if ((err = sum_splits(part_row, g_row, tiles, 5 * d + MC, st)) != cudaSuccess) return err;
  return sum_splits(part_img, g_img, b * strips, P2_LEN, st);
}

}  // namespace

extern "C" {

// x, out [B*N, D] in `dtype`; mask [B*N, 64] float32; prm the packed float32
// parameters (fused_mona.py::_pack); uw = W_up [64, D] in `dtype` (float32:
// the up product's weight); bf16 only: uw_t = W_up^T [D, 64] and wd_t =
// W_down^T [64, D] (the products' K-major weights), z1 [B*N, D] written
// (null in float32); strips: the spatial kernels' strips of grid rows per
// image (shape_ok). Saved for the backward: stats [B*N, 2] (mean, rstd),
// zd and zcat [B*N, 64] float32, gd [B*N, 64] in `dtype`, y2 [B*h*w, 64]
// float32, img [B, 84] float32, z1 (bf16).
int nx_mona_fused_fwd(const void* x, const float* mask, const float* prm, const void* uw,
                      const void* uw_t, const void* wd_t, void* out, float* stats, float* zd,
                      float* zcat, void* gd, float* y2, float* img, void* z1, int dtype, int b,
                      int n, int d, int h, int w, int has_noise, int strips, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (!shape_ok(b, n, d, h, w, strips)) return (int)cudaErrorInvalidValue;
  if (dtype == BF16) {
    if (d > LR_MAX_D || !uw_t || !wd_t || !z1) return (int)cudaErrorInvalidValue;
    return (int)mona_fwd<__nv_bfloat16>(x, mask, prm, uw, uw_t, wd_t, out, stats, zd, zcat, gd,
                                        y2, img, z1, b, n, d, h, w, has_noise, strips, st);
  }
  if (dtype == F32)
    return (int)mona_fwd<float>(x, mask, prm, uw, uw_t, wd_t, out, stats, zd, zcat, gd, y2, img,
                                z1, b, n, d, h, w, has_noise, strips, st);
  return (int)cudaErrorInvalidValue;
}

// g, dx [B*N, D] in `dtype` (dx null: not computed); the forward's inputs and
// saved tensors; scratch dgd, dzd [B*N, 64], part_img [B * strips, P2_LEN],
// part_row [tiles, 5D + 64] (float32: tiles of 32 rows; bf16: of rows_per),
// part_up and part_down [splits, 64 * D], all float32; bf16 only: wd =
// W_down [D, 64], z1 from the forward, scratch dzd_t [B*N, 64] bf16 and dz1
// [B*N, D] float32 (null in float32). grads (float32): dW_up [64, D] |
// dW_down [D, 64] | LN scale, LN bias, gamma, gammax, b_up [D each] | b_down
// [64] | the spatial block's P2_LEN (pw, pw bias, taps, tap biases, freq,
// noise MLP).
int nx_mona_fused_bwd(const void* x, const float* mask, const float* prm, const void* uw,
                      const void* wd, const void* g, const float* stats, const float* zd,
                      const float* zcat, const void* gd, const float* y2, const float* img,
                      const void* z1, void* dx, float* dgd, float* dzd, void* dzd_t, float* dz1,
                      float* part_img, float* part_row, float* part_up, float* part_down,
                      float* grads, int dtype, int b, int n, int d, int h, int w, int has_freq,
                      int has_noise, int strips, int splits, int rows_per, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (!shape_ok(b, n, d, h, w, strips) || splits < 1 || splits > 65535)
    return (int)cudaErrorInvalidValue;
  if (dtype == BF16) {
    if (d > LR_MAX_D || rows_per < 1 || !wd || !z1 || !dzd_t || !dz1)
      return (int)cudaErrorInvalidValue;
    return (int)mona_bwd<__nv_bfloat16>(x, mask, prm, uw, wd, g, stats, zd, zcat, gd, y2, img,
                                        z1, dx, dgd, dzd, dzd_t, dz1, part_img, part_row, part_up,
                                        part_down, grads, b, n, d, h, w, has_freq, has_noise,
                                        strips, splits, rows_per, st);
  }
  if (dtype == F32)
    return (int)mona_bwd<float>(x, mask, prm, uw, wd, g, stats, zd, zcat, gd, y2, img, z1, dx,
                                dgd, dzd, nullptr, dz1, part_img, part_row, part_up, part_down,
                                grads, b, n, d, h, w, has_freq, has_noise, strips, splits,
                                rows_per, st);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
