// The augmentation's equalize op for Hopper (sm_90a), and the per-image
// table lookup it was composed of:
//
//   equalize:  x[i] = grid[lut_i[u8(x[i])]] in place for each image i of
//              the list idx, lut_i PIL ImageOps.equalize's table from the
//              256-bin histogram of u8(x[i]); grid[v] is byte v on the
//              port's unit grid (v / 255 as the plain path rounds it)
//   hist256:   hist[b, v] = #{p : u8(img[b, p]) == v}   (equalize's first half)
//   lut_apply: out[b, p] = lut[b, u8(img[b, p])] (f32)
//
// with u8(v) = clip(rint(v * 255), 0, 255) (rint: half to even, as
// jnp.round and torch.round).
//
// Replaces nextgen_uia_tpu/ops/lut.py::lut_apply (the Pallas kernel _kernel)
// and hist256_fact (plain XLA), and with them the table that
// nextgen_uia_tpu/data/augment.py::_equalize builds between the two. The
// TPU versions factor the byte as 16 * hi + lo and turn the lookup and the
// histogram into 16 x 16 one-hot contractions on the MXU, because gathers
// and scatter-adds serialize there. On Hopper a shared-memory gather and a
// shared-memory atomic are cheap, so neither workaround is copied.
//
// equalize_kernel: one image per thread-block cluster of C CTAs (C <= 16:
// 16 is above the portable size, which Hopper takes), each CTA a
// contiguous slice of the image (ops/lut.py::_eq_grid picks C):
// - the histogram counts the slice's bytes, read with 16-byte loads, into
//   one shared-memory sub-histogram per warp with plain shared atomics
//   (warp-aggregated increments by __match_any_sync timed slower, also on
//   images that are one value);
// - the warps' counts are summed, then the cluster's, each CTA reading the
//   others' through distributed shared memory after a cluster barrier;
// - every CTA builds PIL's table from the 256 counts in integers (the last
//   non-zero bin, step = (total - count[last]) // 255, an exclusive scan by
//   warp shuffles, (shifted + step // 2) // step, the identity where step
//   is 0, a clip to [0, 255]) and maps it through `grid`, so the apply
//   stores the unit-grid value directly: the plain path's quantize to the
//   uint8 grid is the identity on it (tests/test_torch_hopper_lut.py);
// - the apply reads the slice a second time, now from L2, and writes it in
//   place with 16-byte stores. Staging the slice in shared memory instead
//   timed slower: DINOv2's [24, 518, 518] batch is 25.7 MB, more than the
//   SMs' shared memory holds at once, so staged clusters run in two waves,
//   while a slice read microseconds earlier is still in the 50 MB L2.
// The list idx folds in the index_select and index_copy around the old op;
// the integer counts are the same in any order, so the output is bitwise
// the plain path's. A compile-time mode (HIST) writes the [B, 256] counts
// (the first CTA of each cluster; no zero fill, no global atomics) and
// stops: that is hist256.
//
// What bounds them on the H100: bytes. equalize must read and write each
// selected pixel once: at [24, 518, 518] 51.5 MB, 15.4 us at 3.35 TB/s;
// hist256 reads them once (25.8 MB, 7.7 us); lut_apply reads and writes
// them (51.5 MB, 15.4 us).

#include "hopper.cuh"

using namespace nx;

namespace {

constexpr int THREADS = 256, PIX_PER_THREAD = 16;
constexpr int EQ_THREADS = 512, EQ_WARPS = EQ_THREADS / 32, MAX_CLUSTER = 16;

__device__ __forceinline__ int to_byte(float v) {
  return (int)rintf(fminf(fmaxf(v * 255.f, 0.f), 255.f));
}

// grid (pixel tiles, images); float4 loads when the row length allows
__global__ void __launch_bounds__(THREADS)
lut_apply_kernel(const float* __restrict__ img, const int* __restrict__ lut,
                 float* __restrict__ out, int hw) {
  __shared__ float table[256];
  const int b = blockIdx.y;
  table[threadIdx.x] = (float)lut[(size_t)b * 256 + threadIdx.x];
  __syncthreads();
  const float* src = img + (size_t)b * hw;
  float* dst = out + (size_t)b * hw;
  const int stride = gridDim.x * THREADS;
  if (hw % 4 == 0) {
    const float4* s4 = reinterpret_cast<const float4*>(src);
    float4* d4 = reinterpret_cast<float4*>(dst);
    for (int i = blockIdx.x * THREADS + threadIdx.x; i < hw / 4; i += stride) {
      const float4 v = s4[i];
      d4[i] = make_float4(table[to_byte(v.x)], table[to_byte(v.y)], table[to_byte(v.z)],
                          table[to_byte(v.w)]);
    }
  } else {
    for (int i = blockIdx.x * THREADS + threadIdx.x; i < hw; i += stride)
      dst[i] = table[to_byte(src[i])];
  }
}

dim3 grid_for(int b, int hw) {
  const int per_block = THREADS * PIX_PER_THREAD;
  return dim3((hw + per_block - 1) / per_block, b);
}

// equalize_kernel's shared memory (19,520 bytes)
struct EqShared {
  int sub[EQ_WARPS][256];  // one histogram per warp
  int cta[256];            // this CTA's counts, read by the cluster
  int counts[256];         // the image's counts
  float table[256];        // each byte's value after equalizing, on the unit grid
  int wsum[8], wlast[8];   // per warp of the scan: its sum, its last non-zero bin
};

// A slice of `len` floats at g is walked as `head` floats up to its first
// 16-byte boundary, `body4` float4s, and the rest (head and rest together
// at most 6, taken by the first threads).
struct Walk {
  int head, body4, extra;
  __device__ Walk(const float* g, int len) {
    const int mis = (int)((reinterpret_cast<uintptr_t>(g) / 4) & 3);  // floats past a boundary
    head = min((4 - mis) & 3, len);
    body4 = (len - head) / 4;
    extra = len - 4 * body4;
  }
  // the slice index of edge float e (0 <= e < extra): the head, then the rest
  __device__ int edge(int e) const { return e < head ? e : 4 * body4 + e; }
};

// counts of the slice g into the warp's histogram h (one float4 a thread
// in flight: deeper unrolling timed no faster)
__device__ void histogram(const float* g, const Walk& w, int* h) {
  const float4* g4 = reinterpret_cast<const float4*>(g + w.head);
  for (int k = threadIdx.x; k < w.body4; k += EQ_THREADS) {
    const float4 v = __ldg(g4 + k);
    atomicAdd(&h[to_byte(v.x)], 1);
    atomicAdd(&h[to_byte(v.y)], 1);
    atomicAdd(&h[to_byte(v.z)], 1);
    atomicAdd(&h[to_byte(v.w)], 1);
  }
  if (threadIdx.x < w.extra) atomicAdd(&h[to_byte(g[w.edge(threadIdx.x)])], 1);
}

// g[j] = table[u8(g[j])] over the slice, in place: the slice's second read,
// from L2
__device__ void apply(float* g, const Walk& w, const float* table) {
  float4* g4 = reinterpret_cast<float4*>(g + w.head);
  for (int k = threadIdx.x; k < w.body4; k += EQ_THREADS) {
    const float4 v = g4[k];
    g4[k] = make_float4(table[to_byte(v.x)], table[to_byte(v.y)], table[to_byte(v.z)],
                        table[to_byte(v.w)]);
  }
  if (threadIdx.x < w.extra) {
    const int j = w.edge(threadIdx.x);
    g[j] = table[to_byte(g[j])];
  }
}

// PIL's table from sh.counts, mapped through grid into sh.table (the 256
// threads of warps 0-7; every thread of the block calls it)
__device__ void build_table(EqShared& sh, const float* __restrict__ grid) {
  const int t = threadIdx.x, warp = t / 32, lane = t % 32;
  int c = 0, incl = 0;
  if (t < 256) {
    c = sh.counts[t];
    incl = c;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int up = __shfl_up_sync(0xffffffffu, incl, o);
      if (lane >= o) incl += up;
    }
    const unsigned nz = __ballot_sync(0xffffffffu, c > 0);
    if (lane == 31) sh.wsum[warp] = incl;
    if (lane == 0) sh.wlast[warp] = nz ? warp * 32 + 31 - __clz(nz) : -1;
  }
  __syncthreads();
  if (t < 256) {
    long long before = 0, total = 0;
    int last = 0;
#pragma unroll
    for (int w = 0; w < 8; ++w) {
      before += w < warp ? sh.wsum[w] : 0;
      total += sh.wsum[w];
      last = max(last, sh.wlast[w]);
    }
    const long long shifted = before + incl - c;  // the exclusive scan
    const long long step = (total - sh.counts[last]) / 255;
    long long v = step > 0 ? (shifted + step / 2) / step : t;
    v = min(max(v, 0LL), 255LL);
    sh.table[t] = grid[v];
  }
  __syncthreads();
}

// grid (C, n) in clusters of (C, 1, 1): image idx[y] (or y, idx null) of x
// [images, hw], the slice of `slice` floats (a multiple of 4) from r *
// slice for cluster rank r. HIST: write the counts to hist[y] and leave x
// alone.
template <bool HIST>
__global__ void __launch_bounds__(EQ_THREADS)
equalize_kernel(float* __restrict__ x, const int* __restrict__ idx, int* __restrict__ hist,
                const float* __restrict__ grid, int images, int hw, int slice) {
  __shared__ EqShared sh;
  const int t = threadIdx.x;
  const uint32_t rank = hopper::cluster_rank();
  const int b = idx ? idx[blockIdx.y] : blockIdx.y;
  if (b < 0 || b >= images) __trap();  // an index the wrapper could not check
  const int lo = (int)rank * slice;
  float* g = x + (size_t)b * hw + min(lo, hw);
  const Walk w(g, max(0, min(slice, hw - lo)));
  for (int i = t; i < EQ_WARPS * 256; i += EQ_THREADS) (&sh.sub[0][0])[i] = 0;
  __syncthreads();
  histogram(g, w, sh.sub[t / 32]);
  __syncthreads();
  if (t < 256) {
    int c = 0;
#pragma unroll
    for (int k = 0; k < EQ_WARPS; ++k) c += sh.sub[k][t];
    sh.cta[t] = c;
  }
  hopper::cluster_sync();  // every CTA's counts are in its shared memory
  if (t < 256 && (!HIST || rank == 0)) {
    int c = 0;
    for (uint32_t q = 0; q < gridDim.x; ++q) c += hopper::ld_cluster_s32(&sh.cta[t], q);
    sh.counts[t] = c;
    if (HIST) hist[(size_t)blockIdx.y * 256 + t] = c;
  }
  hopper::cluster_arrive();  // this CTA has read the others' counts
  if (!HIST) {
    __syncthreads();
    build_table(sh, grid);
    apply(g, w, sh.table);
  }
  hopper::cluster_wait();  // no CTA leaves while another may still read its counts
}

template <bool HIST>
cudaError_t launch_equalize(float* x, const int* idx, int* hist, const float* grid, int n,
                            int images, int hw, int cluster, int slice, cudaStream_t s) {
  if (n < 1 || n > 65535 || images < 1 || hw < 1 || cluster < 1 || cluster > MAX_CLUSTER ||
      (cluster & (cluster - 1)) || slice < 4 || slice % 4 || (long long)slice * cluster < hw)
    return cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster, attr[0].val.clusterDim.y = 1, attr[0].val.clusterDim.z = 1;
  cfg.gridDim = dim3(cluster, n), cfg.blockDim = dim3(EQ_THREADS);
  cfg.stream = s, cfg.attrs = attr, cfg.numAttrs = 1;
  cudaError_t err = cudaSuccess;
  if (cluster > 8)  // above the portable cluster size: Hopper takes 16
    err = cudaFuncSetAttribute(equalize_kernel<HIST>,
                               cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err == cudaSuccess)
    err = cudaLaunchKernelEx(&cfg, equalize_kernel<HIST>, x, idx, hist, grid, images, hw, slice);
  return err != cudaSuccess ? err : cudaGetLastError();
}

}  // namespace

extern "C" {

// img, out [B, HW] f32 (16-byte aligned); lut [B, 256] int32
int nx_lut_apply(const float* img, const int* lut, float* out, int b, int hw, void* stream) {
  if (b < 1 || hw < 1 || b > 65535) return (int)cudaErrorInvalidValue;
  lut_apply_kernel<<<grid_for(b, hw), THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      img, lut, out, hw);
  return (int)cudaGetLastError();
}

// img [B, HW] f32; hist [B, 256] int32 (written whole); `cluster` CTAs of
// `slice` floats an image (ops/lut.py::_eq_grid)
int nx_hist256(const float* img, int* hist, int b, int hw, int cluster, int slice,
               void* stream) {
  return (int)launch_equalize<true>(const_cast<float*>(img), nullptr, hist, nullptr, b, b, hw,
                                    cluster, slice, static_cast<cudaStream_t>(stream));
}

// x [images, HW] f32, equalized in place at the n distinct images of idx
// [n] int32 (device); grid [256] f32 the unit-grid value of each byte;
// `cluster` CTAs of `slice` floats an image (ops/lut.py::_eq_grid)
int nx_equalize(float* x, const int* idx, const float* grid, int n, int images, int hw,
                int cluster, int slice, void* stream) {
  if (!idx || !grid) return (int)cudaErrorInvalidValue;
  return (int)launch_equalize<false>(x, idx, nullptr, grid, n, images, hw, cluster, slice,
                                     static_cast<cudaStream_t>(stream));
}

}  // extern "C"
