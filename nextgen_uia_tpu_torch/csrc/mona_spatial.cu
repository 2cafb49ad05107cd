// MONA spatial op, forward and backward, for Hopper (sm_90a):
//
//   y[b, i, j, c] = s + bias[b, c]
//                 + sum_{di, dj < 7} u[b, i + di - 3, j + dj - 3, c] * k[b, di, dj, c]
//   u = s * freq[c]   (zero outside the map: 'SAME' padding)
//
// with per-sample 7x7 depthwise kernels k [B, 7, 7, C] and per-sample bias
// [B, C]; s and y are [B, h, w, C] (NHWC). Float32 accumulation, taps added
// in (di, dj) row-major order after s + bias, one rounding to the storage
// type at the end.
//
// Backward, with g = dL/dy:
//
//   du = 7x7 correlation of g with the flipped kernels (d(conv)/du)
//   ds = freq * du + g
//   dk[b, di, dj, c]     = sum_{i, j} g[b, i, j, c] * u[b, i + di - 3, j + dj - 3, c]
//   dfreq_part[b, c]     = sum_{i, j} s * du   (summed over B by the wrapper)
//   dbias[b, c]          = sum_{i, j} g
//
// Replaces nextgen_uia_tpu/ops/dwconv.py::mona_spatial, forward (the Pallas
// kernel _mona_fwd_kernel) and backward (_mona_bwd_kernel). The TPU kernel's
// MIN_HW zero-padding was a lowering workaround and is not carried over.
//
// What bounds it on the H100: 49 multiply-adds per output element against
// one read of s and one write of y, so it is bound by memory traffic and
// latency; at the serving shape ([32, 14, 14, 64] bf16, 0.8 MB in and out)
// the whole op is a few microseconds of device-memory time and launch
// overhead dominates.
//
// Design (forward): one CTA per (channel group of up to 16, sample). The CTA stages
// the zero-padded (h+6) x (w+6) tile of u for its channels in shared memory
// in float32 (20 x 20 x 16 x 4 B = 25.6 KB at 14 x 14) and the sample's 49
// taps, so every input element is read from device memory once; consecutive
// threads take consecutive channels, so the global reads and writes of a
// pixel's channel group are contiguous and the shared-memory reads are
// conflict-free.
//
// Design (backward): the same grid and the same staged (h+6) x (w+6) tile
// of u, plus the zero-haloed tile of g, both float32 in shared memory
// (51 KB at 14 x 14). On the TPU the grid runs in order and could carry a
// reduction from one step to the next; Hopper runs blocks in parallel in no
// order, so every per-sample reduction over h x w (the 49 taps of dk, dfreq
// and dbias) is finished inside the one CTA that owns that (sample, channel
// group): a thread's channel is fixed by its index (256 % cg == 0), so ds's
// grid-stride loop keeps per-thread partials of s*du and g that a
// deterministic shared-memory pass sums, and each dk output (tap, channel)
// is one thread's float32 sum over the tile. The sum over the batch of
// dfreq is left to the wrapper, as the TPU kernel leaves it outside. Bound
// by latency and launch overhead at this size, like the forward.
//
// Per-sample 7x7 depthwise convolution (nx_dwconv7, nx_dwconv7_bwd):
//
//   y[b, i, j, c] = sum_{di, dj < 7} x[b, i + di - 3, j + dj - 3, c] * k[b, di, dj, c]
//   dx = 7x7 correlation of g with the flipped kernels;
//   dk[b, di, dj, c] = sum_{i, j} g[b, i, j, c] * x[b, i + di - 3, j + dj - 3, c]
//
// Replaces nextgen_uia_tpu/ops/dwconv.py::dwconv7_per_sample, forward (the
// Pallas kernel _fwd_kernel) and backward (_bwd_kernel). It is the MONA
// stencil above with freq = 1, no bias and no residual: the same kernels,
// instantiated with MONA = false, so u = x, y is the taps' sum alone, dx =
// du, and no dfreq or dbias is reduced. dk is float32, cast to the kernels'
// dtype by the wrapper, as the TPU kernel returns it. No TPU or GPU product
// path calls it (MONA's adapter runs through mona_spatial). At the MONA
// bottleneck on the ViT-B/16 grid ([64, 14, 14, 64], bf16) it moves ~3.6 MB
// (x, y and the kernels: 0.001 ms at the memory rate) for 2 x 49 flops per output: bound
// by bytes, in practice by latency and launch overhead.

#include "common.cuh"

namespace nx {

constexpr int MS_THREADS = 256, MS_K = 7, MS_HALO = 3;

// MONA: u = s * freq and y = s + bias + taps (mona_spatial); otherwise u = s
// and y = taps alone (dwconv7_per_sample, freq and bias null)
template <typename T, bool MONA>
__global__ void __launch_bounds__(MS_THREADS)
mona_spatial_kernel(const T* __restrict__ s, const T* __restrict__ freq,
                    const T* __restrict__ kern, const T* __restrict__ bias,
                    T* __restrict__ out, int h, int w, int c_total, int cg) {
  extern __shared__ float sm[];
  const int hp = h + 2 * MS_HALO, wp = w + 2 * MS_HALO;
  float* u = sm;                   // [hp * wp][cg]
  float* taps = u + hp * wp * cg;  // [49][cg]
  const int b = blockIdx.y, c0 = blockIdx.x * cg;
  const T* sb = s + (size_t)b * h * w * c_total;

  for (int i = threadIdx.x; i < hp * wp * cg; i += MS_THREADS) {
    const int c = i % cg, pix = i / cg;
    const int y = pix / wp - MS_HALO, x = pix % wp - MS_HALO;
    float v = 0.f;
    if (y >= 0 && y < h && x >= 0 && x < w) {
      v = to_f32(sb[((size_t)y * w + x) * c_total + c0 + c]);
      if (MONA) v *= to_f32(freq[c0 + c]);
    }
    u[i] = v;
  }
  for (int i = threadIdx.x; i < MS_K * MS_K * cg; i += MS_THREADS) {
    const int c = i % cg, t = i / cg;
    taps[i] = to_f32(kern[((size_t)b * MS_K * MS_K + t) * c_total + c0 + c]);
  }
  __syncthreads();

  T* ob = out + (size_t)b * h * w * c_total;
  for (int i = threadIdx.x; i < h * w * cg; i += MS_THREADS) {
    const int c = i % cg, pix = i / cg;
    const int y = pix / w, x = pix % w;
    const size_t gi = (size_t)pix * c_total + c0 + c;
    float acc = MONA ? to_f32(sb[gi]) + to_f32(bias[(size_t)b * c_total + c0 + c]) : 0.f;
#pragma unroll
    for (int di = 0; di < MS_K; ++di)
#pragma unroll
      for (int dj = 0; dj < MS_K; ++dj)
        acc += u[((y + di) * wp + x + dj) * cg + c] * taps[(di * MS_K + dj) * cg + c];
    ob[gi] = from_f32<T>(acc);
  }
}

template <typename T, bool MONA>
cudaError_t launch_mona_spatial(const void* s, const void* freq, const void* kern,
                                const void* bias, void* out, int b, int h, int w, int c,
                                cudaStream_t stream) {
  int cg = 16;
  while (c % cg) cg /= 2;
  const size_t smem =
      sizeof(float) * ((size_t)(h + 2 * MS_HALO) * (w + 2 * MS_HALO) + MS_K * MS_K) * cg;
  cudaError_t err = cudaFuncSetAttribute(mona_spatial_kernel<T, MONA>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(c / cg, b);
  mona_spatial_kernel<T, MONA><<<grid, MS_THREADS, smem, stream>>>(
      static_cast<const T*>(s), static_cast<const T*>(freq), static_cast<const T*>(kern),
      static_cast<const T*>(bias), static_cast<T*>(out), h, w, c, cg);
  return cudaGetLastError();
}

// MONA as in the forward; without it ds = du (dx) and dfreq_part, dbias are
// null and not reduced
template <typename T, bool MONA>
__global__ void __launch_bounds__(MS_THREADS)
mona_spatial_bwd_kernel(const T* __restrict__ s, const T* __restrict__ freq,
                        const T* __restrict__ kern, const T* __restrict__ g,
                        T* __restrict__ ds, float* __restrict__ dk,
                        float* __restrict__ dfreq_part, float* __restrict__ dbias, int h,
                        int w, int c_total, int cg) {
  extern __shared__ float sm[];
  const int hp = h + 2 * MS_HALO, wp = w + 2 * MS_HALO;
  float* u = sm;                     // [hp * wp][cg]  s * freq, zero halo
  float* gp = u + hp * wp * cg;      // [hp * wp][cg]  g, zero halo
  float* taps = gp + hp * wp * cg;   // [49][cg]
  float* red = taps + MS_K * MS_K * cg;  // [2][MS_THREADS] partial sums
  const int b = blockIdx.y, c0 = blockIdx.x * cg, tid = threadIdx.x;
  const size_t base = (size_t)b * h * w * c_total;

  for (int i = tid; i < hp * wp * cg; i += MS_THREADS) {
    const int c = i % cg, pix = i / cg;
    const int y = pix / wp - MS_HALO, x = pix % wp - MS_HALO;
    float uv = 0.f, gv = 0.f;
    if (y >= 0 && y < h && x >= 0 && x < w) {
      const size_t gi = base + ((size_t)y * w + x) * c_total + c0 + c;
      uv = MONA ? to_f32(s[gi]) * to_f32(freq[c0 + c]) : to_f32(s[gi]);
      gv = to_f32(g[gi]);
    }
    u[i] = uv;
    gp[i] = gv;
  }
  for (int i = tid; i < MS_K * MS_K * cg; i += MS_THREADS) {
    const int c = i % cg, t = i / cg;
    taps[i] = to_f32(kern[((size_t)b * MS_K * MS_K + t) * c_total + c0 + c]);
  }
  __syncthreads();

  // ds = freq * du + g, with this thread's partials of s * du and g (its
  // channel is c = tid % cg throughout the loop)
  float part_f = 0.f, part_b = 0.f;
  for (int i = tid; i < h * w * cg; i += MS_THREADS) {
    const int c = i % cg, pix = i / cg;
    const int y = pix / w, x = pix % w;
    float du = 0.f;
#pragma unroll
    for (int di = 0; di < MS_K; ++di)
#pragma unroll
      for (int dj = 0; dj < MS_K; ++dj)
        du += gp[((y + 2 * MS_HALO - di) * wp + x + 2 * MS_HALO - dj) * cg + c] *
              taps[(di * MS_K + dj) * cg + c];
    const size_t gi = base + (size_t)pix * c_total + c0 + c;
    if (!MONA) {
      ds[gi] = from_f32<T>(du);
      continue;
    }
    const float gv = gp[((y + MS_HALO) * wp + x + MS_HALO) * cg + c];
    const float f = to_f32(freq[c0 + c]);
    ds[gi] = from_f32<T>(f * du + gv);
    part_f += to_f32(s[gi]) * du;
    part_b += gv;
  }
  red[tid] = part_f;
  red[MS_THREADS + tid] = part_b;
  __syncthreads();
  if (MONA && tid < cg) {
    float sf = 0.f, sb = 0.f;
    for (int t = tid; t < MS_THREADS; t += cg) sf += red[t], sb += red[MS_THREADS + t];
    dfreq_part[(size_t)b * c_total + c0 + tid] = sf;
    dbias[(size_t)b * c_total + c0 + tid] = sb;
  }

  // dk: one (tap, channel) output per thread and step, summed over the map
  for (int i = tid; i < MS_K * MS_K * cg; i += MS_THREADS) {
    const int c = i % cg, t = i / cg, di = t / MS_K, dj = t % MS_K;
    float acc = 0.f;
    for (int y = 0; y < h; ++y)
      for (int x = 0; x < w; ++x)
        acc += gp[((y + MS_HALO) * wp + x + MS_HALO) * cg + c] *
               u[((y + di) * wp + x + dj) * cg + c];
    dk[((size_t)b * MS_K * MS_K + t) * c_total + c0 + c] = acc;
  }
}

template <typename T, bool MONA>
cudaError_t launch_mona_spatial_bwd(const void* s, const void* freq, const void* kern,
                                    const void* g, void* ds, float* dk, float* dfreq_part,
                                    float* dbias, int b, int h, int w, int c,
                                    cudaStream_t stream) {
  int cg = 16;
  while (c % cg) cg /= 2;
  const size_t smem = sizeof(float) * (2 * (size_t)(h + 2 * MS_HALO) * (w + 2 * MS_HALO) * cg +
                                       MS_K * MS_K * cg + 2 * MS_THREADS);
  cudaError_t err = cudaFuncSetAttribute(mona_spatial_bwd_kernel<T, MONA>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(c / cg, b);
  mona_spatial_bwd_kernel<T, MONA><<<grid, MS_THREADS, smem, stream>>>(
      static_cast<const T*>(s), static_cast<const T*>(freq), static_cast<const T*>(kern),
      static_cast<const T*>(g), static_cast<T*>(ds), dk, dfreq_part, dbias, h, w, c, cg);
  return cudaGetLastError();
}

}  // namespace nx

extern "C" {

// all tensors share `dtype` (float32 or bf16), contiguous:
// s, out [B, H, W, C]; freq [C]; kernels [B, 7, 7, C]; bias [B, C]
int nx_mona_spatial(const void* s, const void* freq, const void* kernels, const void* bias,
                    void* out, int dtype, int b, int h, int w, int c, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == nx::BF16)
    return (int)nx::launch_mona_spatial<__nv_bfloat16, true>(s, freq, kernels, bias, out, b,
                                                             h, w, c, st);
  if (dtype == nx::F32)
    return (int)nx::launch_mona_spatial<float, true>(s, freq, kernels, bias, out, b, h, w, c,
                                                     st);
  return (int)cudaErrorInvalidValue;
}

// s, g, ds [B, H, W, C] and freq [C], kernels [B, 7, 7, C] in `dtype`;
// dk [B, 7, 7, C], dfreq_part [B, C] and dbias [B, C] float32
int nx_mona_spatial_bwd(const void* s, const void* freq, const void* kernels, const void* g,
                        void* ds, float* dk, float* dfreq_part, float* dbias, int dtype,
                        int b, int h, int w, int c, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == nx::BF16)
    return (int)nx::launch_mona_spatial_bwd<__nv_bfloat16, true>(
        s, freq, kernels, g, ds, dk, dfreq_part, dbias, b, h, w, c, st);
  if (dtype == nx::F32)
    return (int)nx::launch_mona_spatial_bwd<float, true>(s, freq, kernels, g, ds, dk,
                                                         dfreq_part, dbias, b, h, w, c, st);
  return (int)cudaErrorInvalidValue;
}

// x, out [B, H, W, C] and kernels [B, 7, 7, C] in `dtype`
int nx_dwconv7(const void* x, const void* kernels, void* out, int dtype, int b, int h, int w,
               int c, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == nx::BF16)
    return (int)nx::launch_mona_spatial<__nv_bfloat16, false>(x, nullptr, kernels, nullptr,
                                                              out, b, h, w, c, st);
  if (dtype == nx::F32)
    return (int)nx::launch_mona_spatial<float, false>(x, nullptr, kernels, nullptr, out, b, h,
                                                      w, c, st);
  return (int)cudaErrorInvalidValue;
}

// x, g, dx [B, H, W, C] and kernels [B, 7, 7, C] in `dtype`; dk [B, 7, 7, C]
// float32
int nx_dwconv7_bwd(const void* x, const void* kernels, const void* g, void* dx, float* dk,
                   int dtype, int b, int h, int w, int c, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == nx::BF16)
    return (int)nx::launch_mona_spatial_bwd<__nv_bfloat16, false>(
        x, nullptr, kernels, g, dx, dk, nullptr, nullptr, b, h, w, c, st);
  if (dtype == nx::F32)
    return (int)nx::launch_mona_spatial_bwd<float, false>(x, nullptr, kernels, g, dx, dk,
                                                          nullptr, nullptr, b, h, w, c, st);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
