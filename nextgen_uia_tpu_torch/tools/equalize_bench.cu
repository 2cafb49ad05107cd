// Equalize's two design choices timed alone on one card, each against the
// kernel the port ships (csrc/lut.cu::equalize_kernel: plain shared-memory
// atomics, the slice read a second time from L2):
//
//   match   the histogram's increments aggregated in each warp: lanes that
//           hold one byte (__match_any_sync) add their number with one
//           atomic, so an image that is mostly one value does not
//           serialise its shared-memory atomics;
//   staged  the CTA's slice copied once into shared memory (16-byte
//           cp.async), counted and equalized from there, and written back.
//
// and both together, on DINOv2's [24, 518, 518] batch and the trainer's
// [32, 224, 224], every image selected, three kinds of image (noise: every
// byte as likely; dark70: 70% of the pixels one dark value, the rest noise;
// constant: one value, PIL's step 0), at clusters of 4, 8 and 16 CTAs an
// image (ops/lut.py::_eq_grid picks 8 at both shapes):
//
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 \
//        -o build/equalize_bench nextgen_uia_tpu_torch/tools/equalize_bench.cu
//   build/equalize_bench
//
// Each line is the CUDA-event mean of 20 launches after 3, each equalizing
// the last one's output in place (an equalized image keeps its kind), the
// whole list twice, beside the byte bound (one read and one write of every
// pixel at 3.35 TB/s). A variant's output is held bitwise against the
// shipped kernel's on the same input, and the line says whether it is
// equal. A staged slice that does not fit in one CTA's shared memory is
// not timed.

#include <algorithm>
#include <cstdio>

#include "../csrc/lut.cu"

namespace {

constexpr double HBM_BYTES_PER_MS = 3.35e9;
constexpr int SMEM_MAX = 227 * 1024;  // one CTA's shared memory on the H100

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(hopper::smem_u32(dst)),
               "l"(src));
}

// every lane of the warp calls it (byte -1: nothing to count)
__device__ __forceinline__ void add_match(int* h, int byte) {
  const unsigned peers = __match_any_sync(0xffffffffu, byte);
  if (byte >= 0 && (int)(threadIdx.x % 32) == __ffs(peers) - 1)
    atomicAdd(&h[byte], __popc(peers));
}

// counts of the slice's body (global or staged) and its edge floats (g)
template <bool MATCH>
__device__ void count(const float4* body, const float* g, const Walk& w, int* h) {
  if (MATCH) {  // a trip count the whole warp shares
    for (int k0 = threadIdx.x - threadIdx.x % 32; k0 < w.body4; k0 += EQ_THREADS) {
      const int k = k0 + threadIdx.x % 32;
      const float4 v = k < w.body4 ? body[k] : make_float4(0.f, 0.f, 0.f, 0.f);
      add_match(h, k < w.body4 ? to_byte(v.x) : -1);
      add_match(h, k < w.body4 ? to_byte(v.y) : -1);
      add_match(h, k < w.body4 ? to_byte(v.z) : -1);
      add_match(h, k < w.body4 ? to_byte(v.w) : -1);
    }
  } else {
    for (int k = threadIdx.x; k < w.body4; k += EQ_THREADS) {
      const float4 v = body[k];
      atomicAdd(&h[to_byte(v.x)], 1);
      atomicAdd(&h[to_byte(v.y)], 1);
      atomicAdd(&h[to_byte(v.z)], 1);
      atomicAdd(&h[to_byte(v.w)], 1);
    }
  }
  if (threadIdx.x < w.extra) atomicAdd(&h[to_byte(g[w.edge(threadIdx.x)])], 1);
}

// equalize_kernel<false> with the histogram aggregated (MATCH) and/or the
// slice's body staged in dynamic shared memory (STAGE)
template <bool STAGE, bool MATCH>
__global__ void __launch_bounds__(EQ_THREADS)
variant_kernel(float* __restrict__ x, const int* __restrict__ idx,
               const float* __restrict__ grid, int hw, int slice) {
  __shared__ EqShared sh;
  extern __shared__ float4 stage[];
  const int t = threadIdx.x;
  const uint32_t rank = hopper::cluster_rank();
  const int lo = (int)rank * slice;
  float* g = x + (size_t)idx[blockIdx.y] * hw + min(lo, hw);
  const Walk w(g, max(0, min(slice, hw - lo)));
  float4* g4 = reinterpret_cast<float4*>(g + w.head);
  if (STAGE) {
    for (int k = t; k < w.body4; k += EQ_THREADS) cp_async16(stage + k, g4 + k);
    asm volatile("cp.async.commit_group;\n" ::);
  }
  for (int i = t; i < EQ_WARPS * 256; i += EQ_THREADS) (&sh.sub[0][0])[i] = 0;
  if (STAGE) asm volatile("cp.async.wait_group 0;\n" ::);
  __syncthreads();
  count<MATCH>(STAGE ? stage : g4, g, w, sh.sub[t / 32]);
  __syncthreads();
  if (t < 256) {
    int c = 0;
#pragma unroll
    for (int k = 0; k < EQ_WARPS; ++k) c += sh.sub[k][t];
    sh.cta[t] = c;
  }
  hopper::cluster_sync();
  if (t < 256) {
    int c = 0;
    for (uint32_t q = 0; q < gridDim.x; ++q) c += hopper::ld_cluster_s32(&sh.cta[t], q);
    sh.counts[t] = c;
  }
  hopper::cluster_arrive();
  __syncthreads();
  build_table(sh, grid);
  const float4* src = STAGE ? stage : g4;
  for (int k = t; k < w.body4; k += EQ_THREADS) {
    const float4 v = src[k];
    g4[k] = make_float4(sh.table[to_byte(v.x)], sh.table[to_byte(v.y)], sh.table[to_byte(v.z)],
                        sh.table[to_byte(v.w)]);
  }
  if (t < w.extra) {
    const int j = w.edge(t);
    g[j] = sh.table[to_byte(g[j])];
  }
  hopper::cluster_wait();
}

template <bool STAGE, bool MATCH>
cudaError_t launch_variant(float* x, const int* idx, const float* grid, int n, int hw,
                           int cluster, int slice) {
  const int smem = STAGE ? slice * 4 : 0;
  if (smem + (int)sizeof(EqShared) > SMEM_MAX) return cudaErrorInvalidConfiguration;
  auto* fn = variant_kernel<STAGE, MATCH>;
  cudaError_t err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         SMEM_MAX - (int)sizeof(EqShared));
  if (err == cudaSuccess && cluster > 8)
    err = cudaFuncSetAttribute(fn, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster, attr[0].val.clusterDim.y = 1, attr[0].val.clusterDim.z = 1;
  cfg.gridDim = dim3(cluster, n), cfg.blockDim = dim3(EQ_THREADS);
  cfg.dynamicSmemBytes = smem, cfg.attrs = attr, cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, fn, x, idx, grid, hw, slice);
  return err != cudaSuccess ? err : cudaGetLastError();
}

// byte / 255 of a hashed byte: 0 noise, 1 dark70 (70% byte 5), 2 constant
__global__ void fill_images(float* x, size_t n, int kind) {
  const size_t step = (size_t)gridDim.x * blockDim.x;
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < n; i += step) {
    unsigned h = (unsigned)i * 2654435761u ^ 0x9e3779b9u;
    h ^= h >> 13, h *= 0x5bd1e995, h ^= h >> 15;
    const int byte = kind == 2 ? 37 : kind == 1 && (h >> 8) % 100 < 70 ? 5 : (int)(h & 255);
    x[i] = byte / 255.f;
  }
}

__global__ void count_differences(const float* a, const float* b, size_t n, int* diff) {
  const size_t step = (size_t)gridDim.x * blockDim.x;
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < n; i += step)
    if (__float_as_uint(a[i]) != __float_as_uint(b[i])) atomicAdd(diff, 1);
}

const char* const VARIANTS[] = {"shipped", "match", "staged", "staged+match"};
const char* const KINDS[] = {"noise", "dark70", "constant"};

cudaError_t run(int variant, float* x, const int* idx, const float* grid, int n, int hw,
                int cluster, int slice) {
  switch (variant) {
    case 0: return launch_equalize<false>(x, idx, nullptr, grid, n, n, hw, cluster, slice, 0);
    case 1: return launch_variant<false, true>(x, idx, grid, n, hw, cluster, slice);
    case 2: return launch_variant<true, false>(x, idx, grid, n, hw, cluster, slice);
    default: return launch_variant<true, true>(x, idx, grid, n, hw, cluster, slice);
  }
}

void bench(int n, int side, float* x, float* ref, const int* idx, const float* grid, int* diff,
           cudaEvent_t start, cudaEvent_t end) {
  const int hw = side * side;
  const size_t total = (size_t)n * hw;
  const double bound_ms = 2.0 * total * 4 / HBM_BYTES_PER_MS;
  for (int kind = 0; kind < 3; ++kind) {
    for (int cluster = 4; cluster <= 16; cluster *= 2) {
      const int slice = 4 * ((hw + 4 * cluster - 1) / (4 * cluster));
      fill_images<<<1024, 256>>>(ref, total, kind);
      run(0, ref, idx, grid, n, hw, cluster, slice);
      for (int variant = 0; variant < 4; ++variant) {
        fill_images<<<1024, 256>>>(x, total, kind);
        cudaError_t err = run(variant, x, idx, grid, n, hw, cluster, slice);
        printf("equalize_bench [%d, %d, %d] %-8s %-12s cluster %2d: ", n, side, side,
               KINDS[kind], VARIANTS[variant], cluster);
        if (err != cudaSuccess) {
          printf("not timed (%s)\n", cudaGetErrorString(err));
          cudaGetLastError();
          continue;
        }
        cudaMemset(diff, 0, sizeof(int));
        count_differences<<<1024, 256>>>(x, ref, total, diff);
        int differ = 0;
        cudaMemcpy(&differ, diff, sizeof(int), cudaMemcpyDeviceToHost);
        for (int i = 0; i < 3; ++i) run(variant, x, idx, grid, n, hw, cluster, slice);
        cudaEventRecord(start);
        for (int i = 0; i < 20; ++i) run(variant, x, idx, grid, n, hw, cluster, slice);
        cudaEventRecord(end);
        cudaEventSynchronize(end);
        float ms = 0.f;
        cudaEventElapsedTime(&ms, start, end);
        printf("%.4f ms (bound %.4f ms), %s\n", ms / 20, bound_ms,
               differ ? "DIFFERS from the shipped kernel" : "equal to the shipped kernel");
      }
    }
  }
}

}  // namespace

int main() {
  const int shapes[2][2] = {{24, 518}, {32, 224}};
  size_t most = 0;
  for (const auto& s : shapes) most = std::max(most, (size_t)s[0] * s[1] * s[1]);
  float *x, *ref, *grid;
  int *idx, *diff;
  cudaMalloc(&x, most * 4), cudaMalloc(&ref, most * 4), cudaMalloc(&grid, 256 * 4);
  cudaMalloc(&idx, 32 * 4), cudaMalloc(&diff, 4);
  float host_grid[256];
  int host_idx[32];
  for (int v = 0; v < 256; ++v) host_grid[v] = v / 255.f;
  for (int i = 0; i < 32; ++i) host_idx[i] = i;
  cudaMemcpy(grid, host_grid, sizeof host_grid, cudaMemcpyHostToDevice);
  cudaMemcpy(idx, host_idx, sizeof host_idx, cudaMemcpyHostToDevice);
  cudaEvent_t start, end;
  cudaEventCreate(&start), cudaEventCreate(&end);
  for (int pass = 0; pass < 2; ++pass)
    for (const auto& s : shapes) bench(s[0], s[1], x, ref, idx, grid, diff, start, end);
  const cudaError_t err = cudaDeviceSynchronize();
  if (err != cudaSuccess) {
    printf("equalize_bench: %s\n", cudaGetErrorString(err));
    return 1;
  }
  return 0;
}
