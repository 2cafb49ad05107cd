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
//   dk[b, di, dj, c] = sum_{i, j} g[b, i, j, c] * u[b, i + di - 3, j + dj - 3, c]
//   dfreq[c]         = sum_{b, i, j} s * du
//   dbias[b, c]      = sum_{i, j} g
//
// Replaces nextgen_uia_tpu/ops/dwconv.py::mona_spatial, forward (the Pallas
// kernel _mona_fwd_kernel) and backward (_mona_bwd_kernel). The TPU kernel's
// MIN_HW zero-padding was a lowering workaround and is not carried over.
//
// Per-sample 7x7 depthwise convolution (nx_dwconv7, nx_dwconv7_bwd), the
// same stencil with freq = 1, no bias and no residual (MONA = false: u = x,
// y the taps' sum alone, dx = du, no dfreq or dbias):
//
//   y[b, i, j, c] = sum_{di, dj < 7} x[b, i + di - 3, j + dj - 3, c] * k[b, di, dj, c]
//
// replaces nextgen_uia_tpu/ops/dwconv.py::dwconv7_per_sample, forward (the
// Pallas kernel _fwd_kernel) and backward (_bwd_kernel). No TPU or GPU
// product path calls it (MONA's adapter runs through mona_spatial).
//
// What bounds it on the H100: a depthwise stencil sums over no channel, so
// it has no matrix product for the tensor cores; its 49 multiply-adds per
// output run on the CUDA cores (67 TFLOP/s in float32). At the bench shape
// ([64, 14, 14, 64] bf16) the forward moves ~3.6 MB (1.1 us at 3.35 TB/s)
// and does 79 MFLOP (1.2 us), the backward twice the arithmetic on ~6 MB:
// a few microseconds, so the design is about latency: many small CTAs,
// every load issued before any math, no second launch.
//
// Design. One CTA per (channel group, sample, strip of rows); a thread owns
// one channel of the group and one output row of the strip. The wrapper
// (ops/dwconv.py::_grid) takes 32-byte groups and one strip a sample where
// the rows fit in 256 threads: at the path shapes ([64 | 32, 14, 14, 64]
// bf16, 256 or 128 CTAs of 224 threads) more strips timed slower, since
// each adds a cross-CTA sum to the backward. The CTA stages its strip's
// rows and the 3-row halo of s (and of g in the backward) in shared memory
// in the storage type, by 16-byte cp.async copies (8-, 4- or 2-byte where
// C * element size is not a multiple of 16, a template parameter the
// wrapper picks), the halo and the columns past the map zero-filled by the
// copy itself (src-size 0). A thread keeps its channel's 49 taps in
// registers and runs along its row in runs of SR outputs: for each tap row
// it loads SR + 6 values of u = s * freq into registers (formed in
// float32) and does 7 * SR multiply-adds. The group's width is a template
// constant on the path's configurations (16 bf16 or 8 float32 channels,
// else read at run time): a window's loads then take immediate offsets,
// where a run-time width cost an add and a register for each of its 20
// columns (the kernels ran 18-19% slower). Outputs go through a
// shared-memory stage and leave by vector stores. At the path shapes a
// CTA's own latency (load, stencil, store) sets the time while one CTA
// holds an SM (batch 32); with two (batch 64) the SM's shared-memory loads
// and issue slots do. Two rows a thread (fewer loads an output, but 186
// registers) and a float32 tile laid out by column (one conversion pass
// more) both timed slower than one row.
//
// Backward. du as the forward, with the flipped taps, on g's window; ds =
// freq * du + g is staged and stored before the tap gradients. Each thread
// then keeps 49 float32 partial tap sums for its (channel, row), from its g
// row and u's 7 window rows in registers, with its partials of s * du
// (dfreq) and g (dbias), each summed over its row's columns in order; a
// shared-memory pass adds them over the strip's rows in row order.
// Cross-CTA sums stay in the one launch, in a fixed order, so two calls are
// bitwise equal: when a sample's rows span several strips, each strip
// writes its partial to scratch and the last strip CTA of (sample, group)
// to finish, counted by a ticket it resets, adds them in strip order; the
// last CTA of a group over all samples adds dfreq's per-sample partials in
// sample order. dk is written in the kernels' dtype, dfreq in freq's, each
// by one rounding of the float32 sum; dbias float32 (or s's dtype, for the
// autograd's bias gradient).

#include "common.cuh"

namespace nx {
namespace {

constexpr int SK = 7, SH = 3, ST = SK * SK;  // taps per side, halo, taps
constexpr int SR = 14;           // outputs a thread runs along its row at a time
constexpr int SW = SR + 2 * SH;  // the window of u (or g) those outputs read
constexpr int S_THREADS = 256;   // most threads a CTA: channels x strip rows
constexpr int DCH = 64;          // samples gathered at a time for dfreq's sum

__host__ __device__ inline int strip_rows(int h, int strips) { return (h + strips - 1) / strips; }

// columns held per staged row: whole runs of SR outputs and the halo
__host__ __device__ inline int padded_width(int w) { return (w + SR - 1) / SR * SR + 2 * SH; }

// elements between two staged rows of `cols` pixels: rounded up to 128 bytes,
// plus one group's width, so the rows one warp reads sit in other banks
__host__ __device__ inline int row_pitch(int cols, int cg, int elem) {
  return ((cols * cg * elem + 127) / 128 * 128 + cg * elem) / elem;
}

__host__ __device__ inline size_t align16(size_t n) { return (n + 15) / 16 * 16; }

// byte offsets of a CTA's shared memory: the staged rows at 0 (s, then g in
// the backward), the taps, in the backward the partial sums in their place
// once they are read; then the output stage
struct Smem {
  size_t taps, stage, total;
};

__host__ __device__ inline Smem smem_layout(bool bwd, bool mona, int h, int w, int cg,
                                            int strips, int e) {
  const int sr = strip_rows(h, strips);
  const size_t raw = (size_t)(sr + 2 * SH) * row_pitch(padded_width(w), cg, e) * e;
  Smem m;
  m.taps = (bwd ? 2 : 1) * raw;
  size_t end = m.taps + (size_t)ST * cg * e;
  if (bwd) {
    const int most = (sr > strips ? sr : strips) * (mona ? ST + 2 : ST);
    const size_t sums = sizeof(float) * (size_t)cg * (most > DCH ? most : DCH);
    end = end > sums ? end : sums;
  }
  m.stage = align16(end);
  m.total = m.stage + (size_t)sr * row_pitch(w, cg, e) * e;
  return m;
}

template <int VB> struct VecOf;
template <> struct VecOf<16> { using type = uint4; };
template <> struct VecOf<8> { using type = uint2; };
template <> struct VecOf<4> { using type = uint32_t; };
template <> struct VecOf<2> { using type = unsigned short; };

// VB bytes from global to shared memory, zeros where `in` is false (the
// source is then not read): cp.async with a src-size of VB or 0, or, for 2
// bytes, a plain load and store
template <int VB>
__device__ __forceinline__ void copy_in(void* dst, const void* src, bool in) {
  if constexpr (VB >= 4) {
    const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
    const int n = in ? VB : 0;
    if constexpr (VB == 16)
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                   :: "r"(d), "l"(src), "r"(n) : "memory");
    else
      asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n"
                   :: "r"(d), "l"(src), "n"(VB), "r"(n) : "memory");
  } else {
    *static_cast<unsigned short*>(dst) = in ? *static_cast<const unsigned short*>(src) : 0;
  }
}

__device__ __forceinline__ void copy_wait() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

template <int VB>
__device__ __forceinline__ void copy_vec(void* dst, const void* src) {
  using V = typename VecOf<VB>::type;
  *static_cast<V*>(dst) = *static_cast<const V*>(src);
}

// the CTA's rows y0 - 3 .. y0 + rows + 2 of a [B, h, w, C] tensor (sample
// base `src`, channel offset applied), columns -3 .. wp - 4, into `tile`
// [rows + 6][pitch]; zeros outside the map
template <typename T, int VB>
__device__ __forceinline__ void stage_rows(T* tile, const T* src, int y0, int rows, int h,
                                           int w, int C, int cg, int pitch) {
  constexpr int VE = VB / (int)sizeof(T);
  const int nv = cg / VE, wp = padded_width(w), n = (rows + 2 * SH) * wp * nv;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const int v = i % nv, pix = i / nv, r = pix / wp, col = pix % wp;
    const int y = y0 - SH + r, x = col - SH;
    const bool in = y >= 0 && y < h && x >= 0 && x < w;
    copy_in<VB>(tile + r * pitch + col * cg + v * VE,
                in ? src + ((size_t)y * w + x) * C + v * VE : src, in);
  }
}

// the sample's 49 taps of the group's channels into taps [49][cg]
template <typename T, int VB>
__device__ __forceinline__ void stage_taps(T* taps, const T* src, int C, int cg) {
  constexpr int VE = VB / (int)sizeof(T);
  const int nv = cg / VE;
  for (int i = threadIdx.x; i < ST * nv; i += blockDim.x) {
    const int v = i % nv, t = i / nv;
    copy_in<VB>(taps + t * cg + v * VE, src + (size_t)t * C + v * VE, true);
  }
}

// the staged [rows][pitch] outputs to a [B, h, w, C] tensor by vectors
template <typename T, int VB>
__device__ __forceinline__ void store_rows(T* dst, const T* stage, int rows, int w, int C,
                                           int cg, int pitch) {
  constexpr int VE = VB / (int)sizeof(T);
  const int nv = cg / VE;
  for (int i = threadIdx.x; i < rows * w * nv; i += blockDim.x) {
    const int v = i % nv, pix = i / nv, r = pix / w, x = pix % w;
    copy_vec<VB>(dst + ((size_t)r * w + x) * C + v * VE, stage + r * pitch + x * cg + v * VE);
  }
}

// SW values of a staged row (`p` at its run's first column, a channel's
// elements cg apart) into u in float32, times f
template <typename T>
__device__ __forceinline__ void load_window(float (&u)[SW], const T* p, int cg, float f) {
#pragma unroll
  for (int j = 0; j < SW; ++j) u[j] = to_f32(p[j * cg]) * f;
}

// MONA: u = s * freq and y = s + bias + taps (mona_spatial); otherwise u = s
// and y = taps alone (dwconv7_per_sample, freq and bias null). CG: the
// group's width, or 0 to read it from cg_rt
template <typename T, int VB, bool MONA, int CG>
__global__ void __launch_bounds__(S_THREADS)
spatial_stencil_fwd(const T* __restrict__ s, const T* __restrict__ freq,
                    const T* __restrict__ kern, const T* __restrict__ bias,
                    T* __restrict__ out, int h, int w, int C, int cg_rt) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int cg = CG ? CG : cg_rt;
  const int e = sizeof(T), b = blockIdx.y, c0 = blockIdx.x * cg, tid = threadIdx.x;
  const int sr = strip_rows(h, gridDim.z), y0 = blockIdx.z * sr, rows = min(h, y0 + sr) - y0;
  const int pitch = row_pitch(padded_width(w), cg, e), opitch = row_pitch(w, cg, e);
  const Smem m = smem_layout(false, MONA, h, w, cg, gridDim.z, e);
  T* tile = reinterpret_cast<T*>(smem);             // [rows + 6][pitch]  s, zero outside
  T* taps = reinterpret_cast<T*>(smem + m.taps);    // [49][cg]
  T* stage = reinterpret_cast<T*>(smem + m.stage);  // [rows][opitch]     y
  stage_rows<T, VB>(tile, s + (size_t)b * h * w * C + c0, y0, rows, h, w, C, cg, pitch);
  stage_taps<T, VB>(taps, kern + (size_t)b * ST * C + c0, C, cg);
  copy_wait();
  __syncthreads();

  const int c = tid % cg, yl = tid / cg;
  if (yl < rows) {
    float k[ST];
#pragma unroll
    for (int t = 0; t < ST; ++t) k[t] = to_f32(taps[t * cg + c]);
    const float f = MONA ? to_f32(freq[c0 + c]) : 1.f;
    const float bv = MONA ? to_f32(bias[(size_t)b * C + c0 + c]) : 0.f;
    const T* row = tile + yl * pitch + c;  // staged row yl is map row y0 + yl - 3
    for (int x0 = 0; x0 < w; x0 += SR) {
      float acc[SR];
#pragma unroll
      for (int x = 0; x < SR; ++x)
        acc[x] = MONA ? to_f32(row[SH * pitch + (x0 + x + SH) * cg]) + bv : 0.f;
#pragma unroll
      for (int di = 0; di < SK; ++di) {
        float u[SW];
        load_window(u, row + di * pitch + x0 * cg, cg, f);
#pragma unroll
        for (int dj = 0; dj < SK; ++dj)
#pragma unroll
          for (int x = 0; x < SR; ++x) acc[x] = fmaf(u[x + dj], k[di * SK + dj], acc[x]);
      }
#pragma unroll
      for (int x = 0; x < SR; ++x)
        if (x0 + x < w) stage[yl * opitch + (x0 + x) * cg + c] = from_f32<T>(acc[x]);
    }
  }
  __syncthreads();
  store_rows<T, VB>(out + ((size_t)b * h + y0) * w * C + c0, stage, rows, w, C, cg, opitch);
}

// true in every thread of the CTA that arrives last of n at *ticket, which
// it resets to 0; the CTA's global writes before it are visible to that CTA
__device__ __forceinline__ bool arrive_last(int* ticket, int n, int* flag) {
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    const bool last = atomicAdd(ticket, 1) == n - 1;
    if (last) atomicExch(ticket, 0);
    *flag = last;
  }
  __syncthreads();
  const bool last = *flag;
  if (last) __threadfence();
  return last;
}

// MONA as in the forward; without it ds = du (dx), and dfreq, dbias are
// null and not reduced. part: float32 scratch, [B][C] per-sample dfreq
// partials (MONA), then [B][G][strips][rl][cg] strip partials (strips > 1);
// tickets: [G] per group, then [B][G] per (sample, group), zero on entry
// and on exit
template <typename T, int VB, bool MONA, int CG>
__global__ void __launch_bounds__(S_THREADS)
spatial_stencil_bwd(const T* __restrict__ s, const T* __restrict__ freq,
                    const T* __restrict__ kern, const T* __restrict__ g, T* __restrict__ ds,
                    T* __restrict__ dk, T* __restrict__ dfreq, void* __restrict__ dbias,
                    int dbias_dtype, float* __restrict__ part, int* __restrict__ tickets,
                    int h, int w, int C, int cg_rt) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int last_flag;
  constexpr int RL = MONA ? ST + 2 : ST;  // the 49 taps, then s * du and g
  const int cg = CG ? CG : cg_rt;
  const int e = sizeof(T), b = blockIdx.y, grp = blockIdx.x, c0 = grp * cg, tid = threadIdx.x;
  const int B = gridDim.y, G = gridDim.x, strips = gridDim.z, strip = blockIdx.z;
  const int sr = strip_rows(h, strips), y0 = strip * sr, rows = min(h, y0 + sr) - y0;
  const int pitch = row_pitch(padded_width(w), cg, e), opitch = row_pitch(w, cg, e);
  const Smem m = smem_layout(true, MONA, h, w, cg, strips, e);
  T* ts = reinterpret_cast<T*>(smem);               // [rows + 6][pitch]  s, zero outside
  T* tg = ts + (sr + 2 * SH) * pitch;               // [rows + 6][pitch]  g, zero outside
  T* taps = reinterpret_cast<T*>(smem + m.taps);    // [49][cg]
  float* red = reinterpret_cast<float*>(smem);      // once the tiles are read: [rows][RL][cg]
  T* stage = reinterpret_cast<T*>(smem + m.stage);  // [rows][opitch]  ds
  const size_t sample = (size_t)b * h * w * C + c0;
  stage_rows<T, VB>(ts, s + sample, y0, rows, h, w, C, cg, pitch);
  stage_rows<T, VB>(tg, g + sample, y0, rows, h, w, C, cg, pitch);
  stage_taps<T, VB>(taps, kern + (size_t)b * ST * C + c0, C, cg);
  copy_wait();
  __syncthreads();

  const int c = tid % cg, yl = tid / cg;
  const bool active = yl < rows;
  const float f = MONA ? to_f32(freq[c0 + c]) : 1.f;
  const T* rs = ts + yl * pitch + c;  // staged row yl is map row y0 + yl - 3
  const T* rg = tg + yl * pitch + c;
  float pf = 0.f, pb = 0.f;  // this row's s * du and g
  if (active) {
    float k[ST];
#pragma unroll
    for (int t = 0; t < ST; ++t) k[t] = to_f32(taps[t * cg + c]);
    for (int x0 = 0; x0 < w; x0 += SR) {
      float du[SR];
#pragma unroll
      for (int x = 0; x < SR; ++x) du[x] = 0.f;
#pragma unroll
      for (int di = 0; di < SK; ++di) {
        float gw[SW];  // map row y + 3 - di
        load_window(gw, rg + (2 * SH - di) * pitch + x0 * cg, cg, 1.f);
#pragma unroll
        for (int dj = 0; dj < SK; ++dj)
#pragma unroll
          for (int x = 0; x < SR; ++x)
            du[x] = fmaf(gw[x + 2 * SH - dj], k[di * SK + dj], du[x]);
      }
#pragma unroll
      for (int x = 0; x < SR; ++x) {
        float v = du[x];
        if (MONA) {
          const int at = SH * pitch + (x0 + x + SH) * cg;
          const float gv = to_f32(rg[at]);
          v = f * du[x] + gv;
          pf = fmaf(to_f32(rs[at]), du[x], pf);
          pb += gv;
        }
        if (x0 + x < w) stage[yl * opitch + (x0 + x) * cg + c] = from_f32<T>(v);
      }
    }
  }
  __syncthreads();
  store_rows<T, VB>(ds + ((size_t)b * h + y0) * w * C + c0, stage, rows, w, C, cg, opitch);

  // this row's tap gradients: g's row against u's 7 window rows
  float pk[ST];
#pragma unroll
  for (int t = 0; t < ST; ++t) pk[t] = 0.f;
  if (active) {
    for (int x0 = 0; x0 < w; x0 += SR) {
      float gr[SR];
#pragma unroll
      for (int x = 0; x < SR; ++x) gr[x] = to_f32(rg[SH * pitch + (x0 + x + SH) * cg]);
#pragma unroll
      for (int di = 0; di < SK; ++di) {
        float u[SW];  // map row y + di - 3
        load_window(u, rs + di * pitch + x0 * cg, cg, f);
#pragma unroll
        for (int dj = 0; dj < SK; ++dj)
#pragma unroll
          for (int x = 0; x < SR; ++x) pk[di * SK + dj] = fmaf(gr[x], u[x + dj], pk[di * SK + dj]);
      }
    }
  }
  __syncthreads();  // the tiles are read: red takes their place
  if (active) {
#pragma unroll
    for (int t = 0; t < ST; ++t) red[(yl * RL + t) * cg + c] = pk[t];
    if (MONA) {
      red[(yl * RL + ST) * cg + c] = pf;
      red[(yl * RL + ST + 1) * cg + c] = pb;
    }
  }
  __syncthreads();

  // the sample's sums, i = (t, c): dk, then (MONA) dfreq's partial and dbias
  auto finish = [&](int i, float v) {
    const int t = i / cg, ch = c0 + i % cg;
    if (t < ST) dk[((size_t)b * ST + t) * C + ch] = from_f32<T>(v);
    else if (t == ST) part[(size_t)b * C + ch] = v;
    else store_f32(dbias, dbias_dtype, (size_t)b * C + ch, v);
  };
  // the strip's rows in order
  float* mine = part + (MONA ? (size_t)B * C : 0) + (((size_t)b * G + grp) * strips) * RL * cg;
  for (int i = tid; i < RL * cg; i += blockDim.x) {
    float acc = 0.f;
#pragma unroll 8
    for (int r = 0; r < rows; ++r) acc += red[r * RL * cg + i];
    if (strips == 1) finish(i, acc);
    else mine[strip * RL * cg + i] = acc;
  }
  if (strips > 1) {
    // the last strip of (sample, group) to finish adds the strips in order
    if (!arrive_last(&tickets[G + b * G + grp], strips, &last_flag)) return;
    float* gat = reinterpret_cast<float*>(smem);
#pragma unroll 8
    for (int i = tid; i < strips * RL * cg; i += blockDim.x) gat[i] = __ldcg(mine + i);
    __syncthreads();
    for (int i = tid; i < RL * cg; i += blockDim.x) {
      float acc = 0.f;
      for (int r = 0; r < strips; ++r) acc += gat[r * RL * cg + i];
      finish(i, acc);
    }
  }
  if (!MONA) return;
  // the last of the group's samples to finish adds dfreq's partials in order
  if (!arrive_last(&tickets[grp], B, &last_flag)) return;
  float* gat = reinterpret_cast<float*>(smem);
  float acc = 0.f;
  for (int b0 = 0; b0 < B; b0 += DCH) {
    const int nb = min(DCH, B - b0);
    __syncthreads();
#pragma unroll 8
    for (int i = tid; i < nb * cg; i += blockDim.x)
      gat[i] = __ldcg(part + (size_t)(b0 + i / cg) * C + c0 + i % cg);
    __syncthreads();
    if (tid < cg) {
#pragma unroll 16
      for (int j = 0; j < nb; ++j) acc += gat[j * cg + tid];
    }
  }
  if (tid < cg) dfreq[c0 + tid] = from_f32<T>(acc);
}

// the geometry the wrapper picked: access width, whole groups, whole
// vectors, at most S_THREADS threads, no empty strip
bool geometry_ok(int elem, int access, int h, int c, int cg, int strips) {
  if (access < elem || access % elem || !(access == 16 || access == 8 || access == 4 ||
                                          access == 2))
    return false;
  if (cg <= 0 || c % cg || cg % (access / elem) || strips < 1 || strips > h) return false;
  const int sr = strip_rows(h, strips);
  return cg * sr <= S_THREADS && (strips - 1) * sr < h;
}

template <typename T, int VB, bool MONA, int CG>
cudaError_t launch_fwd(const void* s, const void* freq, const void* kern, const void* bias,
                       void* out, int b, int h, int w, int c, int cg, int strips,
                       cudaStream_t st) {
  const size_t smem = smem_layout(false, MONA, h, w, cg, strips, sizeof(T)).total;
  const auto kernel = spatial_stencil_fwd<T, VB, MONA, CG>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(c / cg, b, strips), cg * strip_rows(h, strips), smem, st>>>(
      static_cast<const T*>(s), static_cast<const T*>(freq), static_cast<const T*>(kern),
      static_cast<const T*>(bias), static_cast<T*>(out), h, w, c, cg);
  return cudaGetLastError();
}

template <typename T, int VB, bool MONA, int CG>
cudaError_t launch_bwd(const void* s, const void* freq, const void* kern, const void* g,
                       void* ds, void* dk, void* dfreq, void* dbias, int dbias_dtype,
                       float* part, int* tickets, int b, int h, int w, int c, int cg,
                       int strips, cudaStream_t st) {
  const size_t smem = smem_layout(true, MONA, h, w, cg, strips, sizeof(T)).total;
  const auto kernel = spatial_stencil_bwd<T, VB, MONA, CG>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(c / cg, b, strips), cg * strip_rows(h, strips), smem, st>>>(
      static_cast<const T*>(s), static_cast<const T*>(freq), static_cast<const T*>(kern),
      static_cast<const T*>(g), static_cast<T*>(ds), static_cast<T*>(dk),
      static_cast<T*>(dfreq), dbias, dbias_dtype, part, tickets, h, w, c, cg);
  return cudaGetLastError();
}

// the instantiation for the dtype, access width and group: the path's
// configurations (16-byte copies, 16 bf16 or 8 float32 channels, the
// wrapper's choice at C = 64) with the group's width fixed
template <bool MONA>
cudaError_t fwd(int dtype, int access, const void* s, const void* freq, const void* kern,
                const void* bias, void* out, int b, int h, int w, int c, int cg, int strips,
                cudaStream_t st) {
  const int elem = dtype == BF16 ? 2 : 4;
  if ((dtype != BF16 && dtype != F32) || !geometry_ok(elem, access, h, c, cg, strips))
    return cudaErrorInvalidValue;
#define NX_FWD(T, VB, CG) \
  launch_fwd<T, VB, MONA, CG>(s, freq, kern, bias, out, b, h, w, c, cg, strips, st)
  if (dtype == BF16) {
    switch (access) {
      case 16: return cg == 16 ? NX_FWD(__nv_bfloat16, 16, 16) : NX_FWD(__nv_bfloat16, 16, 0);
      case 8: return NX_FWD(__nv_bfloat16, 8, 0);
      case 4: return NX_FWD(__nv_bfloat16, 4, 0);
      default: return NX_FWD(__nv_bfloat16, 2, 0);
    }
  }
  switch (access) {
    case 16: return cg == 8 ? NX_FWD(float, 16, 8) : NX_FWD(float, 16, 0);
    case 8: return NX_FWD(float, 8, 0);
    default: return NX_FWD(float, 4, 0);
  }
#undef NX_FWD
}

template <bool MONA>
cudaError_t bwd(int dtype, int access, const void* s, const void* freq, const void* kern,
                const void* g, void* ds, void* dk, void* dfreq, void* dbias, int dbias_dtype,
                float* part, int* tickets, int b, int h, int w, int c, int cg, int strips,
                cudaStream_t st) {
  const int elem = dtype == BF16 ? 2 : 4;
  if ((dtype != BF16 && dtype != F32) || !geometry_ok(elem, access, h, c, cg, strips))
    return cudaErrorInvalidValue;
#define NX_BWD(T, VB, CG)                                                                      \
  launch_bwd<T, VB, MONA, CG>(s, freq, kern, g, ds, dk, dfreq, dbias, dbias_dtype, part,      \
                              tickets, b, h, w, c, cg, strips, st)
  if (dtype == BF16) {
    switch (access) {
      case 16: return cg == 16 ? NX_BWD(__nv_bfloat16, 16, 16) : NX_BWD(__nv_bfloat16, 16, 0);
      case 8: return NX_BWD(__nv_bfloat16, 8, 0);
      case 4: return NX_BWD(__nv_bfloat16, 4, 0);
      default: return NX_BWD(__nv_bfloat16, 2, 0);
    }
  }
  switch (access) {
    case 16: return cg == 8 ? NX_BWD(float, 16, 8) : NX_BWD(float, 16, 0);
    case 8: return NX_BWD(float, 8, 0);
    default: return NX_BWD(float, 4, 0);
  }
#undef NX_BWD
}

}  // namespace
}  // namespace nx

extern "C" {

// all tensors share `dtype` (float32 or bf16), contiguous: s, out [B, H, W,
// C]; freq [C]; kernels [B, 7, 7, C]; bias [B, C]. access: bytes a vector
// copy moves (16, 8, 4 or 2); cg: channels a CTA (a multiple of access /
// element size, dividing C); strips: CTAs of rows a sample
int nx_mona_spatial(const void* s, const void* freq, const void* kernels, const void* bias,
                    void* out, int dtype, int b, int h, int w, int c, int access, int cg,
                    int strips, void* stream) {
  return (int)nx::fwd<true>(dtype, access, s, freq, kernels, bias, out, b, h, w, c, cg, strips,
                            static_cast<cudaStream_t>(stream));
}

// s, g, ds [B, H, W, C], freq and dfreq [C], kernels and dk [B, 7, 7, C] in
// `dtype`; dbias [B, C] in `dbias_dtype`; part float32 scratch of B * C +
// (strips > 1 ? B * C * strips * 51 : 0); tickets int32, zero, of C / cg +
// (strips > 1 ? B * C / cg : 0); access, cg, strips as nx_mona_spatial's
int nx_mona_spatial_bwd(const void* s, const void* freq, const void* kernels, const void* g,
                        void* ds, void* dk, void* dfreq, void* dbias, int dbias_dtype,
                        float* part, int* tickets, int dtype, int b, int h, int w, int c,
                        int access, int cg, int strips, void* stream) {
  return (int)nx::bwd<true>(dtype, access, s, freq, kernels, g, ds, dk, dfreq, dbias,
                            dbias_dtype, part, tickets, b, h, w, c, cg, strips,
                            static_cast<cudaStream_t>(stream));
}

// x, out [B, H, W, C] and kernels [B, 7, 7, C] in `dtype`; access, cg,
// strips as nx_mona_spatial's
int nx_dwconv7(const void* x, const void* kernels, void* out, int dtype, int b, int h, int w,
               int c, int access, int cg, int strips, void* stream) {
  return (int)nx::fwd<false>(dtype, access, x, nullptr, kernels, nullptr, out, b, h, w, c, cg,
                             strips, static_cast<cudaStream_t>(stream));
}

// x, g, dx [B, H, W, C] and kernels, dk [B, 7, 7, C] in `dtype`; part
// float32 scratch of (strips > 1 ? B * C * strips * 49 : 0), tickets int32,
// zero, of (strips > 1 ? C / cg + B * C / cg : 0)
int nx_dwconv7_bwd(const void* x, const void* kernels, const void* g, void* dx, void* dk,
                   float* part, int* tickets, int dtype, int b, int h, int w, int c,
                   int access, int cg, int strips, void* stream) {
  return (int)nx::bwd<false>(dtype, access, x, nullptr, kernels, g, dx, dk, nullptr, nullptr,
                             0, part, tickets, b, h, w, c, cg, strips,
                             static_cast<cudaStream_t>(stream));
}

}  // extern "C"
