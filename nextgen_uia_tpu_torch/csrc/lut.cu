// Per-image 256-entry table lookup and 256-bin histogram of the byte grid,
// for Hopper (sm_90a): the two halves of the augmentation's equalize op.
//
//   lut_apply: out[b, p] = lut[b, clip(rint(img[b, p] * 255), 0, 255)] (f32)
//   hist256:   hist[b, v] = #{p : clip(rint(img[b, p] * 255), 0, 255) == v}
//
// Replaces nextgen_uia_tpu/ops/lut.py::lut_apply (the Pallas kernel _kernel)
// and its histogram twin hist256_fact (plain XLA). The TPU versions factor
// the byte as 16 * hi + lo and turn both the lookup and the histogram into
// 16 x 16 one-hot contractions on the MXU, because gathers and scatter-adds
// serialize there. On Hopper a gather from shared memory and a shared-memory
// atomic are cheap, so neither workaround is copied: the apply stages each
// image's table in shared memory and reads it once per pixel; the histogram
// counts into one shared-memory histogram per warp (fewer collisions on the
// flat regions equalize sees) and merges them into [B, 256] with integer
// atomicAdd, so the counts are the same in any order. Rounding is rintf
// (half to even), as jnp.round and torch.round.
//
// What bounds them on the H100: both read each f32 pixel once (the apply
// also writes one), a few integer operations per pixel, so bytes: at
// [24, 518, 518] 51.5 MB for the apply (~15 us at 3.35 TB/s) and 25.8 MB
// for the histogram (~8 us).

#include "common.cuh"

using namespace nx;

namespace {

constexpr int THREADS = 256, WARPS = THREADS / 32, PIX_PER_THREAD = 16;

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

__global__ void __launch_bounds__(THREADS)
hist256_kernel(const float* __restrict__ img, int* __restrict__ hist, int hw) {
  __shared__ int part[WARPS][256];
  for (int i = threadIdx.x; i < WARPS * 256; i += THREADS) (&part[0][0])[i] = 0;
  __syncthreads();
  const int b = blockIdx.y, warp = threadIdx.x / 32;
  const float* src = img + (size_t)b * hw;
  const int stride = gridDim.x * THREADS;
  if (hw % 4 == 0) {
    const float4* s4 = reinterpret_cast<const float4*>(src);
    for (int i = blockIdx.x * THREADS + threadIdx.x; i < hw / 4; i += stride) {
      const float4 v = s4[i];
      atomicAdd(&part[warp][to_byte(v.x)], 1);
      atomicAdd(&part[warp][to_byte(v.y)], 1);
      atomicAdd(&part[warp][to_byte(v.z)], 1);
      atomicAdd(&part[warp][to_byte(v.w)], 1);
    }
  } else {
    for (int i = blockIdx.x * THREADS + threadIdx.x; i < hw; i += stride)
      atomicAdd(&part[warp][to_byte(src[i])], 1);
  }
  __syncthreads();
  int c = 0;
#pragma unroll
  for (int w = 0; w < WARPS; ++w) c += part[w][threadIdx.x];
  if (c) atomicAdd(&hist[(size_t)b * 256 + threadIdx.x], c);
}

dim3 grid_for(int b, int hw) {
  const int per_block = THREADS * PIX_PER_THREAD;
  return dim3((hw + per_block - 1) / per_block, b);
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

// img [B, HW] f32 (16-byte aligned); hist [B, 256] int32, zeroed by the caller
int nx_hist256(const float* img, int* hist, int b, int hw, void* stream) {
  if (b < 1 || hw < 1 || b > 65535) return (int)cudaErrorInvalidValue;
  hist256_kernel<<<grid_for(b, hw), THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      img, hist, hw);
  return (int)cudaGetLastError();
}

}  // extern "C"
