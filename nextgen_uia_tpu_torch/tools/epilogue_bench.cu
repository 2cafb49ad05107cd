// The Hopper GEMM core's epilogues timed alone on one card, at the bench
// step's K8 and K6 products (M = 64 * 197 = 12,608 rows, D = 768, hidden
// 3072, bf16, seeded data), then K1's four products at its three path
// shapes (serving [32 * 197, 768] x 3072, the CLIP text cache's [256 * 77,
// 512] x 2048, BERT's [256 * 256, 768] x 3072), then the fc2 of K9 (BERT's
// [256 * 256, 768] x 3072) and of K10 (DINOv2's [24 * 1370, 768], the BERT
// LoRA layers' [16 * 256, 768]) and K10's backward dx product ([16 * 256,
// 768]) at the tile configs their shared memory allows:
//
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 \
//        -o build/epilogue_bench nextgen_uia_tpu_torch/tools/epilogue_bench.cu
//   build/epilogue_bench
//
// Each line is the CUDA-event mean of 20 launches after 3, the whole list
// twice: the products with no epilogue and with a bias (the tensor cores'
// time), the staged epilogues (K1's float32 residual stream among them) at
// the tile configs their shared memory allows, the float32 outputs, the same bias + GELU applied per register
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

// K1's products at rows m, width d, hidden hd: q|k|v with its bias,
// o with bo + x stored float32 (epilogue A), fc1 with bias + GELU, fc2 with
// b2 + the float32 stream stored bf16 or float32 (epilogue B)
void k1_products(const char* tag, int m, int d, int hd) {
  __nv_bfloat16 *a, *x, *w, *out;
  float *y32, *s32, *bias;
  cudaMalloc(&a, (size_t)m * hd * 2), cudaMalloc(&x, (size_t)m * d * 2);
  cudaMalloc(&w, (size_t)hd * d * 2), cudaMalloc(&out, (size_t)m * hd * 2);
  cudaMalloc(&y32, (size_t)m * d * 4), cudaMalloc(&s32, (size_t)m * d * 4);
  cudaMalloc(&bias, hd * 4);
  fill<<<1024, 256>>>(a, (size_t)m * hd, 6), fill<<<1024, 256>>>(x, (size_t)m * d, 7);
  fill<<<1024, 256>>>(w, (size_t)hd * d, 8), fill_f32<<<1024, 256>>>(y32, (size_t)m * d);
  fill_f32<<<64, 256>>>(bias, hd);
  cudaDeviceSynchronize();
  const double qkv = 6.0 * m * d * d, sq = 2.0 * m * d * d, wide = 2.0 * m * d * hd;
  char name[64];
  auto at = [&](const char* what) {
    snprintf(name, sizeof name, "%s %s", tag, what);
    return name;
  };
  const BiasEpilogue b{bias};
  flat<256, 3>(at("qkv BiasEpilogue"), a, d, w, out, 3 * d, m, b, qkv);
  flat<192, 4>(at("qkv BiasEpilogue"), a, d, w, out, 3 * d, m, b, qkv);
  flat<128, 4>(at("qkv BiasEpilogue"), a, d, w, out, 3 * d, m, b, qkv);
  const ResidualEpilogue<__nv_bfloat16, true> ea{bias, x, d, y32};
  flat<128, 4>(at("o ResidualEpilogue<bf16, f32 out>"), a, d, w, nullptr, d, m, ea, sq);
  flat<192, 3>(at("o ResidualEpilogue<bf16, f32 out>"), a, d, w, nullptr, d, m, ea, sq);
  flat<256, 2>(at("o ResidualEpilogue<bf16, f32 out>"), a, d, w, nullptr, d, m, ea, sq);
  flat<128, 4>(at("o BiasResidualEpilogue (bf16 out)"), a, d, w, out, d, m,
               BiasResidualEpilogue{bias, x, d}, sq);
  flat<128, 4>(at("fc1 BiasActEpilogue<GELU>"), a, d, w, out, hd, m,
               BiasActEpilogue<ACT_GELU>{bias}, wide);
  flat<192, 3>(at("fc1 BiasActEpilogue<GELU>"), a, d, w, out, hd, m,
               BiasActEpilogue<ACT_GELU>{bias}, wide);
  const ResidualEpilogue<float, false> eb{bias, y32, d, nullptr};
  flat<128, 4>(at("fc2 ResidualEpilogue<f32>"), a, hd, w, out, d, m, eb, wide);
  flat<192, 3>(at("fc2 ResidualEpilogue<f32>"), a, hd, w, out, d, m, eb, wide);
  flat<256, 2>(at("fc2 ResidualEpilogue<f32>"), a, hd, w, out, d, m, eb, wide);
  const ResidualEpilogue<float, true> eb32{bias, y32, d, s32};
  flat<128, 4>(at("fc2 ResidualEpilogue<f32, f32 out>"), a, hd, w, nullptr, d, m, eb32, wide);
  flat<192, 3>(at("fc2 ResidualEpilogue<f32, f32 out>"), a, hd, w, nullptr, d, m, eb32, wide);
  flat<256, 2>(at("fc2 ResidualEpilogue<f32, f32 out>"), a, hd, w, nullptr, d, m, eb32, wide);
  flat<128, 4>(at("fc2 BiasEpilogue"), a, hd, w, out, d, m, b, wide);
  cudaDeviceSynchronize();
  cudaFree(a), cudaFree(x), cudaFree(w), cudaFree(out), cudaFree(y32), cudaFree(s32);
  cudaFree(bias);
}

// the last product of an MLP at rows m, K = hd: K9's fc2 (b2 + the bf16 x,
// the sum stored float32 for its LayerNorm), K10's fc2 (b2 alone, bf16 TMA
// store) and K10's backward dx = dpre W1^T (no epilogue, bf16 TMA store)
void mlp_products(const char* tag, int m, int d, int hd) {
  __nv_bfloat16 *a, *x, *w, *out;
  float *y32, *bias;
  cudaMalloc(&a, (size_t)m * hd * 2), cudaMalloc(&x, (size_t)m * d * 2);
  cudaMalloc(&w, (size_t)hd * d * 2), cudaMalloc(&out, (size_t)m * d * 2);
  cudaMalloc(&y32, (size_t)m * d * 4), cudaMalloc(&bias, d * 4);
  fill<<<1024, 256>>>(a, (size_t)m * hd, 9), fill<<<1024, 256>>>(x, (size_t)m * d, 10);
  fill<<<1024, 256>>>(w, (size_t)hd * d, 11), fill_f32<<<64, 256>>>(bias, d);
  cudaDeviceSynchronize();
  const double wide = 2.0 * m * d * hd;
  char name[64];
  auto at = [&](const char* what) {
    snprintf(name, sizeof name, "%s %s", tag, what);
    return name;
  };
  const ResidualEpilogue<__nv_bfloat16, true> k9{bias, x, d, y32};
  flat<128, 4>(at("K9 fc2 ResidualEpilogue<bf16, f32 out>"), a, hd, w, nullptr, d, m, k9, wide);
  flat<192, 3>(at("K9 fc2 ResidualEpilogue<bf16, f32 out>"), a, hd, w, nullptr, d, m, k9, wide);
  flat<256, 2>(at("K9 fc2 ResidualEpilogue<bf16, f32 out>"), a, hd, w, nullptr, d, m, k9, wide);
  const BiasEpilogue k10{bias};
  flat<128, 4>(at("K10 fc2 BiasEpilogue"), a, hd, w, out, d, m, k10, wide);
  flat<192, 3>(at("K10 fc2 BiasEpilogue"), a, hd, w, out, d, m, k10, wide);
  flat<192, 4>(at("K10 fc2 BiasEpilogue"), a, hd, w, out, d, m, k10, wide);
  flat<256, 3>(at("K10 fc2 BiasEpilogue"), a, hd, w, out, d, m, k10, wide);
  flat<128, 4>(at("K10 dx NoEpilogue"), a, hd, w, out, d, m, NoEpilogue{}, wide);
  flat<192, 4>(at("K10 dx NoEpilogue"), a, hd, w, out, d, m, NoEpilogue{}, wide);
  flat<256, 3>(at("K10 dx NoEpilogue"), a, hd, w, out, d, m, NoEpilogue{}, wide);
  cudaDeviceSynchronize();
  cudaFree(a), cudaFree(x), cudaFree(w), cudaFree(out), cudaFree(y32), cudaFree(bias);
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
  for (int rep = 0; rep < 2; ++rep) {
    k1_products("K1 serving", 32 * 197, 768, 3072);
    k1_products("K1 text", 256 * 77, 512, 2048);
    k1_products("K1 BERT", 256 * 256, 768, 3072);
  }
  for (int rep = 0; rep < 2; ++rep) {
    mlp_products("BERT chunk", 256 * 256, 768, 3072);
    mlp_products("DINOv2", 24 * 1370, 768, 3072);
    mlp_products("BERT LoRA", 16 * 256, 768, 3072);
  }
  return 0;
}
