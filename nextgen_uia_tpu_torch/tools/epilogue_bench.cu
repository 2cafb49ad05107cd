// The Hopper GEMM core's epilogues timed alone on one card, at the bench
// step's K8 and K6 products (M = 64 * 197 = 12,608 rows, D = 768, hidden
// 3072, bf16, seeded data):
//
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 \
//        -o build/epilogue_bench nextgen_uia_tpu_torch/tools/epilogue_bench.cu
//   build/epilogue_bench
//
// Each line is the CUDA-event mean of 20 launches after 3, the whole list
// twice: the products with no epilogue and with a bias (the tensor cores'
// time), the staged epilogues at the tile configs their shared memory
// allows, the float32 outputs, the same bias + GELU applied per register
// with a runtime activation code (the first design, kept as the
// yardstick), and K6's doh product flat into a row-major buffer against
// per sequence into a head-major one. It times and checks nothing: the GPU
// tests and chip_smoke.py hold the kernels to their plain versions.

#include <cstdio>

#include "../csrc/hopper_gemm.cuh"

using namespace nx;
using namespace nx::hopper;

namespace {

// the first design: act(v + bias) per register with a runtime activation
// code, the whole GELU and quick_gelu code unrolled for every register pair
struct RegBiasAct {
  const float* bias;
  int act;
  static constexpr bool DIRECT = false, STAGED = false;
  __device__ __forceinline__ float2 fetch(int c) const { return fetch_bias(bias, c); }
  __device__ __forceinline__ float2 apply(float2 v, float2 b) const {
    return make_float2(act_fwd(act, v.x + b.x), act_fwd(act, v.y + b.y));
  }
};

__global__ void fill(__nv_bfloat16* p, size_t n, unsigned seed) {
  const size_t step = (size_t)gridDim.x * blockDim.x;
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < n; i += step) {
    unsigned h = (unsigned)i * 2654435761u ^ seed;
    h ^= h >> 13, h *= 0x5bd1e995, h ^= h >> 15;
    p[i] = __float2bfloat16(((h & 0xffff) / 65536.f - 0.5f) * 0.2f);
  }
}

__global__ void fill_f32(float* p, size_t n) {
  const size_t step = (size_t)gridDim.x * blockDim.x;
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < n; i += step)
    p[i] = ((i * 7919) % 1000) / 500.f - 1.f;
}

template <int BN, int STAGES, class Epi>
void time_product(const char* name, const TmaMatrix& ta, const void* w, const TmaMatrix& to,
                  int batch, int n_tok, int cols, int k, Epi epi, double flops) {
  cudaEvent_t start, end;
  cudaEventCreate(&start), cudaEventCreate(&end);
  cudaError_t err = cudaSuccess;
  for (int i = 0; i < 3; ++i) err = gemm<BN, STAGES>(ta, w, to, epi, batch, n_tok, cols, k, 0);
  cudaEventRecord(start);
  for (int i = 0; i < 20; ++i) gemm<BN, STAGES>(ta, w, to, epi, batch, n_tok, cols, k, 0);
  cudaEventRecord(end);
  cudaEventSynchronize(end);
  float ms = 0.f;
  cudaEventElapsedTime(&ms, start, end);
  ms /= 20;
  if (err == cudaSuccess) err = cudaGetLastError();
  printf("epilogue_bench %-40s BN %3d x %d: %.4f ms, %.0f TFLOP/s (%s)\n", name, BN, STAGES, ms,
         flops / ms / 1e9, cudaGetErrorString(err));
}

// a flat product: A [m, k] and out [m, cols] row-major (out null: a DIRECT
// epilogue writes its own)
template <int BN, int STAGES, class Epi>
void flat(const char* name, const void* a, int k, const void* w, void* out, int cols, int m,
          Epi epi, double flops) {
  TmaMatrix ta, to = TmaMatrix{};
  rows_matrix(ta, a, 1, m, k, BM);
  if (out) rows_matrix(to, out, 1, m, cols, 64);
  time_product<BN, STAGES>(name, ta, w, to, 1, m, cols, k, epi, flops);
}

}  // namespace

int main() {
  const int b = 64, n = 197, m = b * n, d = 768, hd = 3072;
  __nv_bfloat16 *z, *x, *o, *w1_t, *w2_t, *h;
  float *a, *b1, *b2;
  cudaMalloc(&z, (size_t)m * d * 2), cudaMalloc(&x, (size_t)m * d * 2);
  cudaMalloc(&o, (size_t)m * d * 2), cudaMalloc(&h, (size_t)m * hd * 2);
  cudaMalloc(&w1_t, (size_t)hd * d * 2), cudaMalloc(&w2_t, (size_t)hd * d * 2);
  cudaMalloc(&a, (size_t)m * hd * 4), cudaMalloc(&b1, hd * 4), cudaMalloc(&b2, d * 4);
  fill<<<1024, 256>>>(z, (size_t)m * d, 1), fill<<<1024, 256>>>(x, (size_t)m * d, 2);
  fill<<<1024, 256>>>(w1_t, (size_t)hd * d, 3), fill<<<1024, 256>>>(w2_t, (size_t)hd * d, 4);
  fill<<<1024, 256>>>(h, (size_t)m * hd, 5);
  fill_f32<<<1024, 256>>>(a, (size_t)m * hd);
  fill_f32<<<64, 256>>>(b1, hd), fill_f32<<<64, 256>>>(b2, d);
  cudaDeviceSynchronize();
  const double wide = 2.0 * m * d * hd, square = 2.0 * m * d * d;
  for (int rep = 0; rep < 2; ++rep) {
    // z W1^T: [m, 768] x [768, 3072]
    flat<256, 3>("fc1 NoEpilogue", z, d, w1_t, h, hd, m, NoEpilogue{}, wide);
    flat<128, 4>("fc1 NoEpilogue", z, d, w1_t, h, hd, m, NoEpilogue{}, wide);
    flat<256, 3>("fc1 BiasEpilogue", z, d, w1_t, h, hd, m, BiasEpilogue{b1}, wide);
    flat<256, 3>("fc1 bias + GELU per register", z, d, w1_t, h, hd, m, RegBiasAct{b1, ACT_GELU},
                 wide);
    flat<128, 4>("fc1 BiasActEpilogue<GELU>", z, d, w1_t, h, hd, m,
                 BiasActEpilogue<ACT_GELU>{b1}, wide);
    flat<192, 3>("fc1 BiasActEpilogue<GELU>", z, d, w1_t, h, hd, m,
                 BiasActEpilogue<ACT_GELU>{b1}, wide);
    flat<256, 2>("fc1 BiasActEpilogue<GELU>", z, d, w1_t, h, hd, m,
                 BiasActEpilogue<ACT_GELU>{b1}, wide);
    flat<128, 4>("fc1 BiasActEpilogue<QUICK_GELU>", z, d, w1_t, h, hd, m,
                 BiasActEpilogue<ACT_QUICK_GELU>{b1}, wide);
    flat<256, 3>("fc1 StoreF32Epilogue (a)", z, d, w1_t, nullptr, hd, m,
                 StoreF32Epilogue{b1, a, hd}, wide);
    // g W2: [m, 768] x [768, 3072], reading a back
    flat<128, 4>("dpre ActGradEpilogue<GELU>", z, d, w1_t, h, hd, m,
                 ActGradEpilogue<ACT_GELU>{a, hd}, wide);
    flat<192, 3>("dpre ActGradEpilogue<GELU>", z, d, w1_t, h, hd, m,
                 ActGradEpilogue<ACT_GELU>{a, hd}, wide);
    flat<256, 2>("dpre ActGradEpilogue<GELU>", z, d, w1_t, h, hd, m,
                 ActGradEpilogue<ACT_GELU>{a, hd}, wide);
    flat<128, 4>("dpre ActGradEpilogue<QUICK_GELU>", z, d, w1_t, h, hd, m,
                 ActGradEpilogue<ACT_QUICK_GELU>{a, hd}, wide);
    // h W2^T and dpre W1: [m, 3072] x [3072, 768]
    flat<192, 4>("fc2 BiasEpilogue", h, hd, w2_t, o, d, m, BiasEpilogue{b2}, wide);
    flat<128, 4>("fc2 BiasResidualEpilogue", h, hd, w2_t, o, d, m,
                 BiasResidualEpilogue{b2, x, d}, wide);
    flat<192, 3>("fc2 BiasResidualEpilogue", h, hd, w2_t, o, d, m,
                 BiasResidualEpilogue{b2, x, d}, wide);
    flat<192, 4>("dz StoreF32Epilogue", h, hd, w2_t, nullptr, d, m,
                 StoreF32Epilogue{nullptr, a, d}, wide);
    // cat Wo^T and g Wo: [m, 768] x [768, 768]
    flat<192, 4>("o BiasEpilogue", z, d, w2_t, o, d, m, BiasEpilogue{b2}, square);
    flat<128, 4>("o BiasResidualEpilogue", z, d, w2_t, o, d, m, BiasResidualEpilogue{b2, x, d},
                 square);
    flat<192, 3>("o BiasResidualEpilogue", z, d, w2_t, o, d, m, BiasResidualEpilogue{b2, x, d},
                 square);
    flat<192, 4>("doh flat, row-major", z, d, w2_t, o, d, m, NoEpilogue{}, square);
    TmaMatrix ta, to;
    rows_matrix(ta, z, b, n, d, BM);
    heads_matrix(to, o, o, o, b, n, 12, 64, 64);
    time_product<192, 4>("doh per sequence, head-major", ta, w2_t, to, b, n, d, d, NoEpilogue{},
                         square);
  }
  return 0;
}
