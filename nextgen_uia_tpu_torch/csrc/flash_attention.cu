// Attention for any sequence length, forward and backward, for Hopper
// (sm_90a):
//
//   o = softmax(q k^T * scale + bias[b, key] (+ causal mask)) v
//
// with float32 scores, softmax statistics and output sums, the output
// rounded to the input type. q, k, v and o are addressed through element
// strides (batch, head, token; the head dim is contiguous), so one kernel
// reads the [B, H, N, dh] and the [B, N, H, dh] layouts, and the q|k|v
// columns of a packed [B, N, 3, H, dh] projection, without a copy.
//
// Replaces nextgen_uia_tpu/ops/flash_attention.py::flash_attention: the
// Pallas kernels _fwd_kernel (pallas_call in _flash_fwd_impl) and
// _bwd_kernel (pallas_call in _flash_bwd_impl). The TPU kernels hold one
// head's whole [Np, Np] f32 score block in VMEM (7.6 MB at DINOv2's 1370
// tokens); a Hopper block has 227 KB, and the 1370-token K and V of one
// head alone are 351 KB in bf16. So these are tiled online-softmax (flash)
// kernels. Masking follows the JAX kernel: masked scores are -1e30 (-inf in
// the bf16 kernels: every row keeps its first key, so no row is wholly
// masked and the two give the same probabilities), the key bias is added
// after the padding mask, the causal mask after the bias; the row
// log-sum-exp is saved in natural log for the backward.
//
// What bounds it on the H100: at DINOv2-B/14's 518 px shape [24, 12, 1370,
// 64] the forward's two products are 4 * B * H * N^2 * dh = 138.4 GFLOP,
// 0.140 ms at the 989 TFLOP/s bf16 peak, against 202 MB of q, k, v and o
// (0.060 ms); the backward's five products 0.350 ms. Operations bound both;
// at the short path shapes (197 and 256 tokens) the bytes do.
//
// bf16, head dim 64 (the FlashAttention-3 shape). A block has consumer
// warpgroups of 64 rows each and one producer warpgroup, which gives up
// registers (setmaxnreg); one producer thread issues TMA loads of 64-row
// boxes of 4-D tensor maps ([B, H, N, 64] from the element strides, 128-byte
// swizzle, rows past N zero-filled) into a ring of 4 stages, each with a
// `full` mbarrier (transaction bytes, plus one arrival per lane of the
// producer warp that copies the tile's key bias, lse or D into shared
// memory: their rows are not 16 bytes apart, so not TMA's) and an `empty`
// one (one arrival per consumer). Every product is a wgmma.
//
// Forward: S = Q K^T with both operands in shared memory (m64n128k16, 128
// keys a tile); the softmax on the accumulator registers (the SFU's exp2;
// without a bias the scale and log2 e fold into one FMA, with one the
// biased score's difference to the row's max or lse is taken first, which
// is exact where both sit at a padding bias of -1e9 and a folded FMA is
// not); P rounded to bf16 and repacked in registers as the A operand of
// O += P V (m64n64k16; the accumulator layout is the A layout), V read
// MN-major through the descriptor's transpose bit. Each consumer issues
// tile j's Q K^T and tile j - 1's P V together and runs tile j's softmax
// under the P V. Three consumers (192 queries a block) above 512 tokens
// (mha's N > 512 route's split; no length between 256 and 1370 was timed);
// two (128 queries, fewer padded rows at the path's 197 and 256) below,
// taking turns at issuing their products (named barriers) so that one's
// softmax runs under the other's. The bias add and the padding and causal
// masks are passes of their own behind one uniform branch each (only the
// last and diagonal tiles mask): inside the per-element loop the compiler
// predicated the mask test on every element of every tile, and that, more
// than the exponentials, was where the forward's time went. Each consumer
// stages its 64 output rows in its share of the Q tile and writes them
// with one TMA store (rows past N clipped).
//
// Backward (a D pass with 16-byte loads, then two kernels, no atomics on dq, dk,
// dv: two calls are bitwise equal): the dK/dV kernel takes 128 keys per
// block (K and V loaded once), streams 64-query tiles of Q and dO with their
// lse and D, and per tile forms S^T = K Q^T and dP^T = V dO^T (shared-memory
// operands), P^T and dS^T in registers, then dV += P^T dO and dK += dS^T Q
// (register A, MN-major B); the dQ kernel takes 128 queries per block (Q and
// dO loaded once), streams 64-key tiles of K and V, and forms S, dP, then
// dQ += dS K. Each issues the next tile's S and dP right behind this tile's
// register-A products, and each kernel's two warpgroups take turns at
// issuing. Seven products against the minimum of five: S and dP
// are formed in both kernels, which keeps dQ free of a cross-block
// reduction. Queries past N need no mask: their Q and dO rows are
// zero-filled, their lse is +inf (P = 0), and their outputs are clipped.
// Keys past N are zero-filled too, but a zero score still gives P =
// exp(-lse), which overflows in a row whose every key carries the padding
// bias (lse ~ -1e9) and would make dQ = inf * 0; so the dQ kernel masks them
// on its last tile. In the dK/dV kernel a key's row of P^T touches only its
// own dK, dV and dbias, which are clipped.
//
// float32 (the CLIPSeg decoder's attention at head dim 16, every float32
// check): kernels of their own on the CUDA cores, the head dim specialised
// at compile time; see "float32" below.

#include <cfloat>
#include <initializer_list>
#include <type_traits>

#include "block_kernels.cuh"
#include "hopper.cuh"

using namespace nx;
namespace hw = nx::hopper;

namespace {

constexpr float NEG = -1e30f;
constexpr float L2E = 1.4426950408889634f;  // log2(e)

struct Out {
  void* o;
  int sb, sh, sn;
};

// ---------------------------------------------------------------------------
// bf16, head dim 64: TMA, mbarriers and wgmma
// ---------------------------------------------------------------------------

constexpr int D = 64;                    // head dim: one 128-byte swizzled row a token
constexpr int ROWS = 64;                 // rows of every TMA box and of a consumer's tile
constexpr int BOX = ROWS * D * 2;        // bytes of one box
constexpr int WG = 128, THREADS = 3 * WG;  // the backward: two consumer warpgroups, a producer
constexpr int FWD_BN = 128;              // keys per forward tile
constexpr int STAGES = 4;                // K/V (forward) or Q/dO (dK/dV) tiles in flight

// q, k, v, o (forward) or q, k, v, dO, dq, dk, dv (backward): each [B, H,
// N, 64] as one 4-D tensor map
struct FwdParams {
  CUtensorMap q, k, v, o;
  const float* bias;  // [B, N] float32 or null
  float* lse;         // [B, H, N] float32 or null
  int n, causal;
  float scale;
};

struct BwdParams {
  CUtensorMap q, k, v, g, dq, dk, dv;
  const float* lse;    // [B, H, N]
  const float* delta;  // [B, H, N]: rowsum(dO * O)
  const float* bias;   // [B, N] or null
  float* dbias;        // [B, N], zeroed, or null
  int n, causal;
  float scale;
};

// 2^x by the SFU (relative error ~2^-22; 2^-inf = 0)
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// The float32 accumulators of a 64 x (16 K) slice, rounded to bf16, as the
// register A operand of the next product: a K step of 16 is 8 accumulators
template <int K>
__device__ __forceinline__ void pack_a(uint32_t (&a)[K / 16][4], const float (&d)[K / 2]) {
#pragma unroll
  for (int kk = 0; kk < K / 16; ++kk)
#pragma unroll
    for (int i = 0; i < 4; ++i) a[kk][i] = pack_bf16(d[8 * kk + 2 * i], d[8 * kk + 2 * i + 1]);
}

// Accumulator-layout scores of a 64 x N tile (this thread: rows ra and
// ra + 8, columns c0 + 8j + {0, 1}, c0 = 2 * (lane % 4) plus the tile's first
// column) set to `fill` where the column is >= n or exceeds the row plus
// `past` (0: the causal mask; a huge value: none). Kept apart from the
// per-element arithmetic, behind one uniform branch, so that tiles needing
// no mask pay nothing for it.
template <int N>
__device__ __forceinline__ void mask_tile(float (&d)[N / 2], int c0, int ra, int n, int past,
                                          float fill) {
#pragma unroll
  for (int i = 0; i < N / 2; ++i) {
    const int col = c0 + 8 * (i / 4) + (i & 1), row = ra + 8 * ((i / 2) % 2);
    if (col >= n || col > row + past) d[i] = fill;
  }
}

// d = d * scale + bias[column] for a tile whose N columns' bias is at `bias`
template <int N>
__device__ __forceinline__ void add_bias(float (&d)[N / 2], const float* bias, float scale,
                                         int quad) {
#pragma unroll
  for (int j = 0; j < N / 8; ++j) {
    const float2 bj = *reinterpret_cast<const float2*>(bias + 8 * j + 2 * quad);
    d[4 * j] = fmaf(d[4 * j], scale, bj.x), d[4 * j + 1] = fmaf(d[4 * j + 1], scale, bj.y);
    d[4 * j + 2] = fmaf(d[4 * j + 2], scale, bj.x), d[4 * j + 3] = fmaf(d[4 * j + 3], scale, bj.y);
  }
}

// d (+)= A[64, 64] @ B[64, N], both K-major in shared memory (64 columns of
// K = one 128-byte row; a K step of 16 is 32 bytes along it)
template <int N>
__device__ __forceinline__ void mma_ss(float (&d)[N / 2], uint64_t da, uint64_t db) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) hw::wgmma_bf16<N>(d, da + 2 * kk, db + 2 * kk, kk);
}

// d += A[64, K] @ B[K, 64], A in registers, B MN-major in shared memory (K
// rows of 128 bytes; a K step of 16 rows is 2048 bytes)
template <int K>
__device__ __forceinline__ void mma_rs(float (&d)[32], const uint32_t (&a)[K / 16][4],
                                       uint64_t db) {
#pragma unroll
  for (int kk = 0; kk < K / 16; ++kk) hw::wgmma_bf16_rs<64>(d, a[kk], db + kk * (2048 >> 4), 1);
}

// Write a consumer's 64 x 64 bf16 tile (accumulator layout, times `mul` per
// row half) into shared memory `st` in the TMA box's 128-byte swizzle, then
// one thread stores it at rows row0.. of (b, h) of `map` (rows past N
// clipped). The warpgroup's products reading `st` must have retired.
__device__ __forceinline__ void store_tile(unsigned char* st, const float (&d)[32], float mul0,
                                           float mul1, const CUtensorMap* map, int row0, int h,
                                           int b, int wg, int t) {
  const int lane = t % 32, r = (t / 32) * 16 + lane / 4, swz = (lane / 4) & 7, quad = lane % 4;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    unsigned char* at = st + ((j ^ swz) << 4) + quad * 4;
    *reinterpret_cast<__nv_bfloat162*>(at + r * 128) =
        __floats2bfloat162_rn(d[4 * j] * mul0, d[4 * j + 1] * mul0);
    *reinterpret_cast<__nv_bfloat162*>(at + (r + 8) * 128) =
        __floats2bfloat162_rn(d[4 * j + 2] * mul1, d[4 * j + 3] * mul1);
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // visible to TMA
  hw::warpgroup_sync(wg);
  if (t == 0) {
    const int c[4] = {0, row0, h, b};
    hw::tma_store(map, st, 4, c);
    hw::bulk_commit();
    hw::bulk_wait();
  }
}

// Consumer warpgroups taking turns at issuing their products, a round robin
// of named barriers (8 + w: warpgroup w's turn), so that one's elementwise
// work runs under another's products. Every warpgroup waits for and passes
// its turn equally often; the last warpgroup's last pass is not awaited.
struct Turns {
  int wg, nc;
  __device__ __forceinline__ void first() const {  // warpgroup 0 goes first
    if (wg == nc - 1) pass(false);
  }
  __device__ __forceinline__ void wait() const {
    asm volatile("bar.sync %0, %1;\n" ::"r"(8 + wg), "n"(2 * WG) : "memory");
  }
  __device__ __forceinline__ void pass(bool last) const {
    if (!(last && wg == nc - 1))
      asm volatile("bar.arrive %0, %1;\n" ::"r"(8 + (wg + 1) % nc), "n"(2 * WG) : "memory");
  }
};

__device__ __forceinline__ void init_barriers(uint64_t* bars, int n, int count) {
  for (int i = 0; i < n; ++i) hw::mbar_init(&bars[i], count);
}

__device__ __forceinline__ unsigned char* aligned_smem(unsigned char* raw) {
  return raw + ((1024 - (hw::smem_u32(raw) & 1023)) & 1023);
}

// ---- forward ----

// shared memory (from a 1024-byte aligned base): Q (64 rows per consumer),
// the ring of K and V tiles (128 keys each) and bias tiles, the barriers
template <int NC>
struct FwdSmem {
  static constexpr int Q = 0, K = NC * BOX, V = K + STAGES * 2 * BOX;
  static constexpr int BIAS = V + STAGES * 2 * BOX;
  static constexpr int BAR = BIAS + STAGES * FWD_BN * 4;  // q, full[S], empty[S]
  static constexpr int BYTES = BAR + (1 + 2 * STAGES) * 8 + 1024;  // + alignment slack
  static_assert(BYTES <= 232448, "over the 227 KB a block may use");
};

// NC consumer warpgroups (64 queries each) and a producer. Two consumers
// take turns issuing their products (named barriers 8 + w), so one's
// softmax runs under the other's products; three gained nothing from it.
template <bool BIAS, int NC>
__global__ void __launch_bounds__((NC + 1) * WG, 1)
flash_fwd_wgmma(const __grid_constant__ FwdParams p) {
  using L = FwdSmem<NC>;
  constexpr int S = STAGES, BN = FWD_BN;
  constexpr bool PP = NC == 2;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = aligned_smem(smem_raw);
  float* sbias = reinterpret_cast<float*>(base + L::BIAS);
  uint64_t* qbar = reinterpret_cast<uint64_t*>(base + L::BAR);
  uint64_t* full = qbar + 1;
  uint64_t* empty = full + S;
  const int wg = threadIdx.x / WG, t = threadIdx.x % WG;
  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * NC * ROWS, n = p.n;
  int tiles = (n + BN - 1) / BN;
  if (p.causal) tiles = min(tiles, (q0 + NC * ROWS - 1) / BN + 1);  // the query tile's diagonal
  if (threadIdx.x == 0) {
    init_barriers(qbar, 1, 1);
    init_barriers(full, S, 1 + (BIAS ? 32 : 0));
    init_barriers(empty, S, NC);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == NC) {
    // producer: one thread issues the TMA loads, one warp copies the bias
    hw::reg_dealloc<NC == 2 ? 40 : 24>();
    const int warp = t / 32, lane = t % 32;
    if (t == 0) {
      hw::mbar_expect_tx(qbar, NC * BOX);
      for (int i = 0; i < NC; ++i) {
        const int c[4] = {0, q0 + i * ROWS, h, b};
        hw::tma_load(base + L::Q + i * BOX, &p.q, qbar, 4, c);
      }
      for (int it = 0; it < tiles; ++it) {
        const int s = it % S;
        hw::mbar_wait(&empty[s], ((it / S) & 1) ^ 1);
        hw::mbar_expect_tx(&full[s], 4 * BOX);
        for (int i = 0; i < 2; ++i) {
          const int c[4] = {0, it * BN + i * ROWS, h, b};
          hw::tma_load(base + L::K + (2 * s + i) * BOX, &p.k, &full[s], 4, c);
          hw::tma_load(base + L::V + (2 * s + i) * BOX, &p.v, &full[s], 4, c);
        }
      }
    } else if (BIAS && warp == 1) {
      const float* brow = p.bias + (size_t)b * n;
      for (int it = 0; it < tiles; ++it) {
        const int s = it % S;
        hw::mbar_wait(&empty[s], ((it / S) & 1) ^ 1);
        for (int j = lane; j < BN; j += 32) {
          const int key = it * BN + j;
          sbias[s * BN + j] = key < n ? __ldg(brow + key) : 0.f;
        }
        hw::mbar_arrive(&full[s]);
      }
    }
  } else {
    // consumers: 64 query rows each
    hw::reg_alloc<NC == 2 ? 232 : 160>();
    const int warp = t / 32, lane = t % 32, quad = lane % 4;
    const int r0 = q0 + wg * ROWS;             // this warpgroup's first query
    const int ra = r0 + warp * 16 + lane / 4;  // this thread's rows: ra and ra + 8
    // exp(x - m): without a bias x is the raw score and exp2(x * c - m * c)
    // one FMA (the scale folded into c); with one, x is the scaled, biased
    // score and exp2((x - m) * log2 e)
    const float c = BIAS ? L2E : p.scale * L2E;
    unsigned char* sq = base + L::Q + wg * BOX;
    const uint64_t qd = hw::smem_desc(sq);
    float o[32], sc[BN / 2], m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
    uint32_t pf[BN / 16][4];  // the previous tile's P, bf16 A fragments
#pragma unroll
    for (int i = 0; i < 32; ++i) o[i] = 0.f;
    auto release = [&](int s) {
      if (t == 0) hw::mbar_arrive(&empty[s]);
    };
    auto v_desc = [&](int s) { return hw::smem_desc(base + L::V + 2 * s * BOX); };

    // scores of tile `it` (in stage s) -> probabilities in place, the running
    // max and sum updated; alpha rescales what O holds
    auto softmax = [&](int it, int s, float (&alpha)[2]) {
      const int k0 = it * BN;
      if (BIAS) add_bias<BN>(sc, sbias + s * BN, p.scale, quad);
      // keys past N, and the causal mask, only on the last and diagonal tiles
      if (k0 + BN > n || (p.causal && k0 + BN - 1 > r0))
        mask_tile<BN>(sc, k0 + 2 * quad, ra, n, p.causal ? 0 : 1 << 30, -INFINITY);
      // four partial maxima and sums a row: short dependency chains
      float mp[2][4], sp[2][4], mx[2], nm[2];
#pragma unroll
      for (int i = 0; i < 4; ++i) mp[0][i] = mp[1][i] = -INFINITY, sp[0][i] = sp[1][i] = 0.f;
#pragma unroll
      for (int i = 0; i < BN / 2; ++i)
        mp[(i / 2) % 2][(i / 4) % 2 * 2 + i % 2] = fmaxf(mp[(i / 2) % 2][(i / 4) % 2 * 2 + i % 2], sc[i]);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(fmaxf(mp[r][0], mp[r][1]), fmaxf(mp[r][2], mp[r][3]));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        const float mn = fmaxf(m[r], mx[r]);    // finite: every row keeps key 0 of tile 0
        alpha[r] = exp2_approx((m[r] - mn) * c);  // 0 on the first tile
        m[r] = mn;
        nm[r] = BIAS ? mn : -mn * c;
        l[r] *= alpha[r];
      }
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) {
        sc[i] = exp2_approx(BIAS ? (sc[i] - nm[(i / 2) % 2]) * L2E
                                 : fmaf(sc[i], c, nm[(i / 2) % 2]));
        sp[(i / 2) % 2][(i / 4) % 2 * 2 + i % 2] += sc[i];
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) l[r] += (sp[r][0] + sp[r][1]) + (sp[r][2] + sp[r][3]);
    };
    float alpha[2];

    // tile 0: S, then the softmax
    const Turns turns{wg, NC};
    auto turn = [&]() {
      if (PP) turns.wait();
    };
    auto pass = [&](bool last) {
      if (PP) turns.pass(last);
    };
    if (PP) turns.first();

    hw::mbar_wait(qbar, 0);
    hw::mbar_wait(&full[0], 0);
    turn();
    hw::wgmma_fence();
    mma_ss<BN>(sc, qd, hw::smem_desc(base + L::K));
    hw::wgmma_commit();
    pass(false);
    hw::wgmma_wait<0>();
    hw::fence_regs(sc);
    softmax(0, 0, alpha);
    pack_a<BN>(pf, sc);  // P rounded to bf16, as the JAX kernel rounds P before P v
    // tile it: S = Q K^T issued, then O += P V of tile it - 1 under its softmax
    for (int it = 1; it < tiles; ++it) {
      const int s = it % S, sp = (it - 1) % S;
      hw::mbar_wait(&full[s], (it / S) & 1);
      hw::fence_regs(o);
      hw::fence_regs(pf);
      turn();
      hw::wgmma_fence();
      mma_ss<BN>(sc, qd, hw::smem_desc(base + L::K + 2 * s * BOX));
      hw::wgmma_commit();
      mma_rs<BN>(o, pf, v_desc(sp));
      hw::wgmma_commit();
      pass(false);
      hw::wgmma_wait<1>();  // S has retired
      hw::fence_regs(sc);
      softmax(it, s, alpha);
      hw::wgmma_wait<0>();  // P V has retired
      hw::fence_regs(o);
      hw::fence_regs(pf);
      release(sp);
#pragma unroll
      for (int i = 0; i < 32; ++i) o[i] *= alpha[(i / 2) % 2];
      pack_a<BN>(pf, sc);
    }
    hw::fence_regs(o);
    hw::fence_regs(pf);
    turn();
    hw::wgmma_fence();
    mma_rs<BN>(o, pf, v_desc((tiles - 1) % S));
    hw::wgmma_commit();
    pass(true);
    hw::wgmma_wait<0>();
    hw::fence_regs(o);
    release((tiles - 1) % S);

#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
      const int row = ra + r * 8;
      if (p.lse && quad == 0 && row < n)
        p.lse[((size_t)b * gridDim.y + h) * n + row] = (BIAS ? m[r] : m[r] * p.scale) + logf(l[r]);
    }
    if (r0 < n) store_tile(sq, o, 1.f / l[0], 1.f / l[1], &p.o, r0, h, b, wg, t);
  }
}

// ---- backward ----

// D = rowsum(dO * O) in bf16, head dim 64: 8 lanes a row, 16 bytes each (the
// D pass reads o and g once; 32 rows a block)
__global__ void __launch_bounds__(256)
flash_bwd_delta_bf16(Out og, const __nv_bfloat16* __restrict__ g, float* __restrict__ delta,
                     int n) {
  const int lane8 = threadIdx.x % 8, row = blockIdx.x * 32 + threadIdx.x / 8;
  const int b = blockIdx.z, h = blockIdx.y;
  float s = 0.f;
  if (row < n) {
    const size_t off = (size_t)b * og.sb + (size_t)h * og.sh + (size_t)row * og.sn + lane8 * 8;
    const uint4 ov = __ldg(reinterpret_cast<const uint4*>(static_cast<const __nv_bfloat16*>(og.o) + off));
    const uint4 gv = __ldg(reinterpret_cast<const uint4*>(g + off));
    const __nv_bfloat162* o2 = reinterpret_cast<const __nv_bfloat162*>(&ov);
    const __nv_bfloat162* g2 = reinterpret_cast<const __nv_bfloat162*>(&gv);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 a = __bfloat1622float2(o2[i]), c = __bfloat1622float2(g2[i]);
      s = fmaf(a.x, c.x, s);
      s = fmaf(a.y, c.y, s);
    }
  }
  s += __shfl_xor_sync(0xffffffffu, s, 1);
  s += __shfl_xor_sync(0xffffffffu, s, 2);
  s += __shfl_xor_sync(0xffffffffu, s, 4);
  if (row < n && lane8 == 0) delta[((size_t)b * gridDim.y + h) * n + row] = s;
}

// the per-row operands of a 64-row tile, copied by one producer warp into
// shared memory (32 lanes x 2 rows); then every lane arrives on `full`
template <class F>
__device__ __forceinline__ void copy_rows(float* dst, int row0, int n, int lane, F value) {
#pragma unroll
  for (int i = 0; i < ROWS / 32; ++i) {
    const int j = lane + 32 * i;
    dst[j] = value(row0 + j, row0 + j < n);
  }
}

// dK/dV: shared memory of K and V (128 keys, loaded once), the ring of Q
// and dO tiles (64 queries) with their lse (times log2 e without a bias)
// and D, barriers
struct DkdvSmem {
  static constexpr int K = 0, V = 2 * BOX, Q = 4 * BOX, G = Q + STAGES * BOX;
  static constexpr int LSE = G + STAGES * BOX, DEL = LSE + STAGES * ROWS * 4;
  static constexpr int BAR = DEL + STAGES * ROWS * 4;  // kv, full[S], empty[S]
  static constexpr int BYTES = BAR + (1 + 2 * STAGES) * 8 + 1024;
  static_assert(BYTES <= 232448, "over the 227 KB a block may use");
};

template <bool BIAS>
__global__ void __launch_bounds__(THREADS, 1)
flash_bwd_dkdv_wgmma(const __grid_constant__ BwdParams p) {
  using L = DkdvSmem;
  constexpr int S = STAGES;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = aligned_smem(smem_raw);
  float* slse = reinterpret_cast<float*>(base + L::LSE);
  float* sdel = reinterpret_cast<float*>(base + L::DEL);
  uint64_t* kvbar = reinterpret_cast<uint64_t*>(base + L::BAR);
  uint64_t* full = kvbar + 1;
  uint64_t* empty = full + S;
  const int wg = threadIdx.x / WG, t = threadIdx.x % WG;
  const int b = blockIdx.z, h = blockIdx.y, k0 = blockIdx.x * 2 * ROWS, n = p.n;
  const size_t rows_off = ((size_t)b * gridDim.y + h) * n;
  // query tiles wholly above the diagonal see none of these keys
  const int first = p.causal ? k0 / ROWS : 0, tiles = (n + ROWS - 1) / ROWS - first;
  if (threadIdx.x == 0) {
    init_barriers(kvbar, 1, 1);
    init_barriers(full, S, 1 + 32);
    init_barriers(empty, S, 2);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 2) {
    hw::reg_dealloc<40>();
    const int warp = t / 32, lane = t % 32;
    if (t == 0) {
      hw::mbar_expect_tx(kvbar, 4 * BOX);
      for (int i = 0; i < 2; ++i) {
        const int c[4] = {0, k0 + i * ROWS, h, b};
        hw::tma_load(base + L::K + i * BOX, &p.k, kvbar, 4, c);
        hw::tma_load(base + L::V + i * BOX, &p.v, kvbar, 4, c);
      }
      for (int it = 0; it < tiles; ++it) {
        const int s = it % S;
        hw::mbar_wait(&empty[s], ((it / S) & 1) ^ 1);
        hw::mbar_expect_tx(&full[s], 2 * BOX);
        const int c[4] = {0, (first + it) * ROWS, h, b};
        hw::tma_load(base + L::Q + s * BOX, &p.q, &full[s], 4, c);
        hw::tma_load(base + L::G + s * BOX, &p.g, &full[s], 4, c);
      }
    } else if (warp == 1) {
      for (int it = 0; it < tiles; ++it) {
        const int s = it % S, row0 = (first + it) * ROWS;
        hw::mbar_wait(&empty[s], ((it / S) & 1) ^ 1);
        // queries past N: lse +inf gives P = 0
        copy_rows(slse + s * ROWS, row0, n, lane, [&](int row, bool ok) {
          return ok ? __ldg(p.lse + rows_off + row) * (BIAS ? 1.f : L2E) : INFINITY;
        });
        copy_rows(sdel + s * ROWS, row0, n, lane, [&](int row, bool ok) {
          return ok ? __ldg(p.delta + rows_off + row) : 0.f;
        });
        hw::mbar_arrive(&full[s]);
      }
    }
  } else {
    hw::reg_alloc<232>();
    const int warp = t / 32, lane = t % 32, quad = lane % 4;
    const int kw0 = k0 + wg * ROWS;              // this warpgroup's first key
    const int ka = kw0 + warp * 16 + lane / 4;   // this thread's keys: ka and ka + 8
    const float c = p.scale * L2E;
    float kb[2] = {0.f, 0.f};
    if (BIAS)
#pragma unroll
      for (int r = 0; r < 2; ++r)
        if (ka + 8 * r < n) kb[r] = __ldg(p.bias + (size_t)b * n + ka + 8 * r);
    unsigned char* sk = base + L::K + wg * BOX;
    unsigned char* sv = base + L::V + wg * BOX;
    const uint64_t kd = hw::smem_desc(sk), vd = hw::smem_desc(sv);
    float dk[32], dv[32], st[32], dpt[32], db[2] = {0.f, 0.f};
    uint32_t pf[4][4], sf[4][4];
#pragma unroll
    for (int i = 0; i < 32; ++i) dk[i] = dv[i] = 0.f;

    auto q_desc = [&](int s) { return hw::smem_desc(base + L::Q + s * BOX); };
    auto g_desc = [&](int s) { return hw::smem_desc(base + L::G + s * BOX); };
    // S^T = K Q^T, dP^T = V dO^T of query tile `it` (keys are the rows)
    auto issue_ss = [&](int it) {
      const int s = it % S;
      hw::mbar_wait(&full[s], (it / S) & 1);
      hw::fence_regs(st);
      hw::fence_regs(dpt);
      hw::wgmma_fence();
      mma_ss<ROWS>(st, kd, q_desc(s));
      mma_ss<ROWS>(dpt, vd, g_desc(s));
      hw::wgmma_commit();
    };
    // P^T and dS^T of tile `it` from its retired S^T and dP^T, rounded to
    // bf16 as the A operands of dV += P^T dO and dK += dS^T Q
    auto elementwise = [&](int it) {
      const int s = it % S, qt0 = (first + it) * ROWS;
      const float* ls = slse + s * ROWS;
      const float* ds_ = sdel + s * ROWS;
#pragma unroll
      for (int j = 0; j < ROWS / 8; ++j) {
        const float2 lj = *reinterpret_cast<const float2*>(ls + 8 * j + 2 * quad);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = 4 * j + e;
          const float lse = (e & 1) ? lj.y : lj.x;
          st[i] = exp2_approx(BIAS ? (fmaf(st[i], p.scale, kb[e / 2]) - lse) * L2E
                                   : fmaf(st[i], c, -lse));
        }
      }
      // the causal mask (P^T = 0 where the key follows the query), only on
      // the tiles that hold such pairs
      if (p.causal && qt0 < kw0 + ROWS - 1) {
#pragma unroll
        for (int i = 0; i < ROWS / 2; ++i)
          if (ka + 8 * ((i / 2) % 2) > qt0 + 2 * quad + 8 * (i / 4) + (i & 1)) st[i] = 0.f;
      }
#pragma unroll
      for (int j = 0; j < ROWS / 8; ++j) {
        const float2 dj = *reinterpret_cast<const float2*>(ds_ + 8 * j + 2 * quad);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = 4 * j + e;
          const float ds = st[i] * (dpt[i] - ((e & 1) ? dj.y : dj.x));
          db[e / 2] += ds;
          dpt[i] = ds * p.scale;
        }
      }
      pack_a<ROWS>(pf, st);   // round(P)^T
      pack_a<ROWS>(sf, dpt);  // round(dS)^T
    };
    // dV += P^T dO, dK += dS^T Q (queries are the K dim: dO and Q MN-major)
    auto issue_rs = [&](int it) {
      const int s = it % S;
      hw::fence_regs(pf);
      hw::fence_regs(sf);
      hw::fence_regs(dv);
      hw::fence_regs(dk);
      hw::wgmma_fence();
      mma_rs<ROWS>(dv, pf, g_desc(s));
      mma_rs<ROWS>(dk, sf, q_desc(s));
      hw::wgmma_commit();
    };
    auto retire_rs = [&](int it) {
      hw::fence_regs(dv);
      hw::fence_regs(dk);
      hw::fence_regs(pf);
      hw::fence_regs(sf);
      if (t == 0) hw::mbar_arrive(&empty[it % S]);
    };

    const Turns turns{wg, 2};
    turns.first();

    hw::mbar_wait(kvbar, 0);
    // the next tile's S^T and dP^T are issued right behind this tile's
    // dV and dK products, so the tensor cores do not wait for the round trip
    turns.wait();
    issue_ss(0);
    turns.pass(false);
    hw::wgmma_wait<0>();
    for (int it = 0; it + 1 < tiles; ++it) {
      hw::fence_regs(st);
      hw::fence_regs(dpt);
      elementwise(it);
      turns.wait();
      issue_rs(it);
      issue_ss(it + 1);
      turns.pass(false);
      hw::wgmma_wait<1>();
      retire_rs(it);
      hw::wgmma_wait<0>();
    }
    hw::fence_regs(st);
    hw::fence_regs(dpt);
    elementwise(tiles - 1);
    turns.wait();
    issue_rs(tiles - 1);
    turns.pass(true);
    hw::wgmma_wait<0>();
    retire_rs(tiles - 1);

#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float d = db[r];
      d += __shfl_xor_sync(0xffffffffu, d, 1);
      d += __shfl_xor_sync(0xffffffffu, d, 2);
      const int key = ka + 8 * r;
      if (p.dbias && quad == 0 && key < n) atomicAdd(p.dbias + (size_t)b * n + key, d);
    }
    if (kw0 < n) {
      store_tile(sk, dk, 1.f, 1.f, &p.dk, kw0, h, b, wg, t);
      store_tile(sv, dv, 1.f, 1.f, &p.dv, kw0, h, b, wg, t);
    }
  }
}

// dQ: shared memory of Q and dO (128 queries, loaded once), the ring of K
// and V tiles (64 keys; 128 keys, or three consumers, measured slower) with
// their bias, barriers
struct DqSmem {
  static constexpr int NC = 2;  // consumers
  static constexpr int Q = 0, G = NC * BOX, K = 2 * NC * BOX, V = K + STAGES * BOX;
  static constexpr int BIAS = V + STAGES * BOX;
  static constexpr int BAR = BIAS + STAGES * ROWS * 4;  // qg, full[S], empty[S]
  static constexpr int BYTES = BAR + (1 + 2 * STAGES) * 8 + 1024;
  static_assert(BYTES <= 232448, "over the 227 KB a block may use");
};

template <bool BIAS>
__global__ void __launch_bounds__(THREADS, 1)
flash_bwd_dq_wgmma(const __grid_constant__ BwdParams p) {
  using L = DqSmem;
  constexpr int S = STAGES, BK = ROWS, NC = L::NC;  // keys per tile, consumers
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = aligned_smem(smem_raw);
  float* sbias = reinterpret_cast<float*>(base + L::BIAS);
  uint64_t* qbar = reinterpret_cast<uint64_t*>(base + L::BAR);
  uint64_t* full = qbar + 1;
  uint64_t* empty = full + S;
  const int wg = threadIdx.x / WG, t = threadIdx.x % WG;
  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * NC * ROWS, n = p.n;
  int tiles = (n + BK - 1) / BK;
  if (p.causal) tiles = min(tiles, (q0 + NC * ROWS - 1) / BK + 1);
  if (threadIdx.x == 0) {
    init_barriers(qbar, 1, 1);
    init_barriers(full, S, 1 + (BIAS ? 32 : 0));
    init_barriers(empty, S, NC);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == NC) {
    hw::reg_dealloc<40>();
    const int warp = t / 32, lane = t % 32;
    if (t == 0) {
      hw::mbar_expect_tx(qbar, 2 * NC * BOX);
      for (int i = 0; i < NC; ++i) {
        const int c[4] = {0, q0 + i * ROWS, h, b};
        hw::tma_load(base + L::Q + i * BOX, &p.q, qbar, 4, c);
        hw::tma_load(base + L::G + i * BOX, &p.g, qbar, 4, c);
      }
      for (int it = 0; it < tiles; ++it) {
        const int s = it % S;
        hw::mbar_wait(&empty[s], ((it / S) & 1) ^ 1);
        hw::mbar_expect_tx(&full[s], 2 * BOX);
        const int c[4] = {0, it * BK, h, b};
        hw::tma_load(base + L::K + s * BOX, &p.k, &full[s], 4, c);
        hw::tma_load(base + L::V + s * BOX, &p.v, &full[s], 4, c);
      }
    } else if (BIAS && warp == 1) {
      const float* brow = p.bias + (size_t)b * n;
      for (int it = 0; it < tiles; ++it) {
        const int s = it % S;
        hw::mbar_wait(&empty[s], ((it / S) & 1) ^ 1);
        copy_rows(sbias + s * BK, it * BK, n, lane,
                  [&](int key, bool ok) { return ok ? __ldg(brow + key) : 0.f; });
        hw::mbar_arrive(&full[s]);
      }
    }
  } else {
    hw::reg_alloc<232>();
    const int warp = t / 32, lane = t % 32, quad = lane % 4;
    const int qw0 = q0 + wg * ROWS;              // this warpgroup's first query
    const int ra = qw0 + warp * 16 + lane / 4;   // this thread's rows: ra and ra + 8
    const float c = p.scale * L2E;
    const size_t rows_off = ((size_t)b * gridDim.y + h) * n;
    // the two rows' lse with a bias, else -lse * log2 e (past N +inf, else
    // -inf: P = 0), and their D
    float nl[2], dl[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = ra + 8 * r;
      const float lse = row < n ? __ldg(p.lse + rows_off + row) : INFINITY;
      nl[r] = BIAS ? lse : -lse * L2E;
      dl[r] = row < n ? __ldg(p.delta + rows_off + row) : 0.f;
    }
    unsigned char* sq = base + L::Q + wg * BOX;
    const uint64_t qd = hw::smem_desc(sq), gd = hw::smem_desc(base + L::G + wg * BOX);
    float dq[32], sc[BK / 2], dp[BK / 2];
    uint32_t sf[BK / 16][4];
#pragma unroll
    for (int i = 0; i < 32; ++i) dq[i] = 0.f;

    auto k_desc = [&](int s) { return hw::smem_desc(base + L::K + s * BOX); };
    // S = Q K^T, dP = dO V^T of key tile `it`
    auto issue_ss = [&](int it) {
      const int s = it % S;
      hw::mbar_wait(&full[s], (it / S) & 1);
      hw::fence_regs(sc);
      hw::fence_regs(dp);
      hw::wgmma_fence();
      mma_ss<BK>(sc, qd, k_desc(s));
      mma_ss<BK>(dp, gd, hw::smem_desc(base + L::V + s * BOX));
      hw::wgmma_commit();
    };
    // dS of tile `it` from its retired S and dP, rounded to bf16 as the A
    // operand of dQ += dS K
    auto elementwise = [&](int it) {
      const int s = it % S, k0 = it * BK;
      if (BIAS) add_bias<BK>(sc, sbias + s * BK, p.scale, quad);
#pragma unroll
      for (int i = 0; i < BK / 2; ++i)
        sc[i] = exp2_approx(BIAS ? (sc[i] - nl[(i / 2) % 2]) * L2E
                                 : fmaf(sc[i], c, nl[(i / 2) % 2]));
      // P = 0 for keys past N and, causal, where the key follows the query:
      // only on the last tile and the tiles that hold such pairs
      if (k0 + BK > n || (p.causal && k0 + BK - 1 > qw0))
        mask_tile<BK>(sc, k0 + 2 * quad, ra, n, p.causal ? 0 : 1 << 30, 0.f);
#pragma unroll
      for (int i = 0; i < BK / 2; ++i) sc[i] = sc[i] * (dp[i] - dl[(i / 2) % 2]) * p.scale;
      pack_a<BK>(sf, sc);  // round(dS)
    };
    // dQ += dS K (keys are the K dim: K MN-major)
    auto issue_rs = [&](int it) {
      hw::fence_regs(sf);
      hw::fence_regs(dq);
      hw::wgmma_fence();
      mma_rs<BK>(dq, sf, k_desc(it % S));
      hw::wgmma_commit();
    };
    auto retire_rs = [&](int it) {
      hw::fence_regs(dq);
      hw::fence_regs(sf);
      if (t == 0) hw::mbar_arrive(&empty[it % S]);
    };

    const Turns turns{wg, NC};
    turns.first();
    hw::mbar_wait(qbar, 0);
    turns.wait();
    issue_ss(0);
    turns.pass(false);
    hw::wgmma_wait<0>();
    for (int it = 0; it + 1 < tiles; ++it) {
      hw::fence_regs(sc);
      hw::fence_regs(dp);
      elementwise(it);
      turns.wait();
      issue_rs(it);
      issue_ss(it + 1);
      turns.pass(false);
      hw::wgmma_wait<1>();
      retire_rs(it);
      hw::wgmma_wait<0>();
    }
    hw::fence_regs(sc);
    hw::fence_regs(dp);
    elementwise(tiles - 1);
    turns.wait();
    issue_rs(tiles - 1);
    turns.pass(true);
    hw::wgmma_wait<0>();
    retire_rs(tiles - 1);
    if (qw0 < n) store_tile(sq, dq, 1.f, 1.f, &p.dq, qw0, h, b, wg, t);
  }
}

// A [B, H, N, 64] bf16 tensor at element strides (sb, sh, sn) as a tensor
// map of 64 x 64-row boxes, encoded on every call; TMA needs the base and
// the strides 16-byte aligned.
cudaError_t head_map(CUtensorMap& m, const void* ptr, int b, int heads, int n, int sb, int sh,
                     int sn) {
  if (reinterpret_cast<uintptr_t>(ptr) % 16 || sb % 8 || sh % 8 || sn % 8)
    return cudaErrorInvalidValue;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)n, (cuuint64_t)heads, (cuuint64_t)b};
  const cuuint64_t strides[3] = {(cuuint64_t)sn * 2, (cuuint64_t)sh * 2, (cuuint64_t)sb * 2};
  const cuuint32_t box[4] = {D, ROWS, 1, 1};
  return hw::encode(m, ptr, 4, dims, strides, box);
}

// launch KERNEL (3 warpgroups) with `smem` bytes of dynamic shared memory,
// opting in once per device to `most` bytes (a kernel whose shared memory
// depends on the call), or to `smem`
template <auto KERNEL, class P>
cudaError_t launch(dim3 grid, int smem, cudaStream_t s, const P& p, int threads = THREADS,
                   int most = 0) {
  static bool opted[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= 64) return cudaErrorInvalidDevice;
  if (!opted[dev]) {
    err = cudaFuncSetAttribute(KERNEL, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               most > smem ? most : smem);
    if (err != cudaSuccess) return err;
    opted[dev] = true;
  }
  void* args[] = {const_cast<P*>(&p)};
  err = cudaLaunchKernel(reinterpret_cast<const void*>(KERNEL), grid, dim3(threads), args,
                         smem, s);
  return err != cudaSuccess ? err : cudaGetLastError();
}

// ---------------------------------------------------------------------------
// float32: exact FFMA on the CUDA cores, the head dim a template parameter
// ---------------------------------------------------------------------------
//
// The tensor cores take no float32 operand, and TF32's 10-bit mantissa
// (~5e-4 relative) misses the float32 checks' 1e-4 * max|ref|, so every
// product is float32 FFMA. At the CLIPSeg decoder's [32, 197, 4, 16] the
// forward's 318 MFLOP take 4.7 us at the CUDA cores' 67 TFLOP/s and its
// 1.7 MB 0.5 us at 3.35 TB/s: these kernels are bound by the issue of their
// instructions, and their layout keeps the FFMA share of those high.
//
// - The head dim is a compile-time DH (16, 32, 64); a head dim below it
//   runs with its missing dims zero-filled, which gives the same dot
//   products. Each row is spread over S = DH / 16 lanes, 16 dims a lane
//   (float4 chunks h, h + S, ... of lane part h), so every DH has the
//   registers of DH 16; a score's S partial sums meet by xor shuffles,
//   which leave the same bits in all S lanes.
// - A CTA of four warps takes one (b, h) and 32 R / S rows of the operand
//   it holds (queries in the forward and the dQ kernel, keys in the dK/dV
//   kernel); each thread owns R of them, those rows and their accumulators
//   in registers.
// - The other operand (K and V, or Q and dO) streams through shared memory
//   in chunks of 4096 / DH rows (two [rows, DH] tiles, 32 KB), copied by
//   cp.async, 16 bytes a copy where every row is 16-byte aligned and 4
//   otherwise; two chunks are in flight when the head needs more than one,
//   else one buffer holds it whole (197 keys at DH 16: 25 KB). The warps
//   split each chunk in groups of G rows, group j to warp j % 4. The lanes
//   of a warp read the same streamed row (S neighbouring chunks of it), so
//   every shared-memory read is a broadcast, four floats at a time.
// - The forward's online softmax runs per thread on its own rows, with no
//   shuffles, and rescales once per group of G keys. Without a key bias the
//   scale and log2(e) fold into one FFMA before the SFU's exp2; with one,
//   the difference to the row's max (or lse) is taken first, as in bf16.
// - Masks cost nothing where they cannot apply: a group that holds keys at
//   or past N, or (causal) keys past its first row, takes masked passes of
//   its own behind one warp-uniform branch. Streamed rows past N are
//   zero-filled; the dK/dV kernel's queries past N carry lse = +inf (P = 0).
// - At the end the warps' partials meet in shared memory, and each thread
//   sums one float4 chunk of its rows over them in a fixed order: no
//   atomics on o, dq, dk or dv, so two calls are bitwise equal.
//
// The backward, as the TPU kernel (_bwd_kernel), recomputes P from the row
// log-sum-exp the forward saved, P = exp(s - lse), in the forward's masking
// order (-1e30 past N, then the key bias, then causal). With D = rowsum(dO
// * O) from a pass of its own:
//
//   dV = P^T dO,  dP = dO V^T,  ds_raw = P * (dP - D),  dS = ds_raw * scale,
//   dQ = dS K,  dK = dS^T Q,  dbias[b, key] = sum over heads and queries of
//   ds_raw.
//
// D equals the TPU kernel's rowsum(dP * P) up to the rounding of O (2^-24
// relative in float32). The dQ kernel holds queries and streams K and V
// (with `causal` it stops at its last query); the dK/dV kernel holds keys
// and streams Q, dO, lse and D (with `causal` it starts at its first key),
// and adds each key's column sum of ds_raw into dbias with float32 atomics
// over heads, as the bf16 kernel does.

namespace f32 {

constexpr int WARPS = 4, THREADS = 32 * WARPS;
constexpr int DL = 16, CL = DL / 4;  // dims of a row a lane holds, in float4 chunks
static_assert(CL == WARPS, "the combine gives each warp one chunk of a row");

// Rows a thread holds (R), streamed rows a group (G) and CTAs an SM the
// registers must leave room for (B: 255 registers a thread at 2, 168 at 3,
// 128 at 4) of each kernel, the same at every DH. Timed on an H100 at [32,
// 197, 4, 16] against one row a thread (each kernel slower), other groups,
// and B 3 or 4 in the backward (spills); the forward's B 4 keeps 4 CTAs an
// SM, so its 512 CTAs there run in one wave.
constexpr int FWD_R = 2, FWD_G = 8, FWD_B = 4;
constexpr int DQ_R = 2, DQ_G = 4, DQ_B = 2;
constexpr int DKDV_R = 2, DKDV_G = 2, DKDV_B = 2;

struct Params {
  const float* q;
  const float* k;
  const float* v;
  const float* o;      // backward: the forward's output
  const float* g;      // backward: its gradient
  float* out;          // forward: o
  float* dq;
  float* dk;
  float* dv;
  const float* bias;   // [B, N] or null
  float* lse;          // [B, H, N], natural log: the forward's (or null), the backward's input
  float* delta;        // [B, H, N]: D
  float* dbias;        // [B, N], zeroed, or null
  int sb, sh, sn;      // q, k, v
  int osb, osh, osn;   // o, g, dq, dk, dv
  int n, dh, causal;
  int vec;             // every row 16-byte aligned and dh % 4 == 0: 16-byte copies
  float scale;
};

// streamed rows a chunk holds at head dim DH (two [rows, DH] tiles, 32 KB)
__host__ __device__ constexpr int chunk_rows(int dh) { return 4096 / dh; }

// A kernel's layout: 32 R / S held rows a CTA, groups of G streamed rows,
// PER_ROW floats of shared memory a streamed row, PART floats of the warps'
// partials. One buffer of cap() rows (two when the head needs more than one
// chunk); the partials reuse it from the start after the last chunk.
template <int DH, int R, int G, int PER_ROW_EXTRA, int PART_ROW>
struct Shape {
  static constexpr int S = DH / DL, ROWS = 32 * R / S, PER_ROW = 2 * DH + PER_ROW_EXTRA,
                       PART = WARPS * R * PART_ROW * 32;
  // rows a buffer is given: the whole head, a multiple of G, when it fits
  // in one chunk, else a chunk
  static __host__ __device__ constexpr int cap(int n) {
    return n <= chunk_rows(DH) ? (n + G - 1) / G * G : chunk_rows(DH);
  }
  static constexpr int smem_bytes(int n) {
    const int bufs = (n > chunk_rows(DH) ? 2 : 1) * cap(n) * PER_ROW;
    return 4 * (bufs > PART ? bufs : PART);
  }
};
// the forward's partials: o, m, l; dQ's: dq; dK/dV's: dk, dv, dbias
template <int DH, bool BIAS> using FwdShape = Shape<DH, FWD_R, FWD_G, BIAS, DL + 2>;
template <int DH, bool BIAS> using DqShape = Shape<DH, DQ_R, DQ_G, BIAS, DL>;
template <int DH> using DkdvShape = Shape<DH, DKDV_R, DKDV_G, 2, 2 * DL + 1>;

__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src),
               "r"(valid ? 4 : 0));
}

// rows [0, rows) of a tile at `src` (`stride` elements between rows) into
// dst[rows][DH], rows from `valid` on and dims from dh on zero-filled
template <int DH>
__device__ __forceinline__ void stage_tile(float* dst, const float* src, size_t stride, int rows,
                                           int valid, int dh, bool vec) {
  if (vec) {
    for (int i = threadIdx.x; i < rows * (DH / 4); i += THREADS) {
      const int r = i / (DH / 4), c = 4 * (i % (DH / 4));
      const bool ok = r < valid && c < dh;
      cp_async16(dst + r * DH + c, ok ? src + r * stride + c : src, ok);
    }
  } else {
    for (int i = threadIdx.x; i < rows * DH; i += THREADS) {
      const int r = i / DH, c = i % DH;
      const bool ok = r < valid && c < dh;
      cp_async4(dst + i, ok ? src + r * stride + c : src, ok);
    }
  }
}

// `rows` values of a per-row array, `fill` from `valid` on
__device__ __forceinline__ void stage_values(float* dst, const float* src, int rows, int valid,
                                             float fill) {
  for (int i = threadIdx.x; i < rows; i += THREADS) {
    if (i < valid) cp_async4(dst + i, src + i, true);
    else dst[i] = fill;
  }
}

// this lane's 16 dims of a held row (chunks h, h + S, ...; `src` at chunk
// h), zero where !ok and from dh on
template <int S>
__device__ __forceinline__ void load_row(float (&x)[DL], const float* src, int h, bool ok, int dh,
                                         bool vec) {
#pragma unroll
  for (int i = 0; i < CL; ++i) {
    const int c = 4 * (h + S * i);
    const float* p = src + 4 * S * i;
    float4 t = make_float4(0.f, 0.f, 0.f, 0.f);
    if (ok && c < dh) {
      if (vec) {
        t = __ldg(reinterpret_cast<const float4*>(p));
      } else {
        t.x = __ldg(p);
        t.y = c + 1 < dh ? __ldg(p + 1) : 0.f;
        t.z = c + 2 < dh ? __ldg(p + 2) : 0.f;
        t.w = c + 3 < dh ? __ldg(p + 3) : 0.f;
      }
    }
    x[4 * i] = t.x, x[4 * i + 1] = t.y, x[4 * i + 2] = t.z, x[4 * i + 3] = t.w;
  }
}

// the sum of v over the S lanes of a row, the same bits in each
template <int S>
__device__ __forceinline__ float row_sum(float v) {
#pragma unroll
  for (int o = 1; o < S; o <<= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// s[r][j] = a_r . X[j] and t[r][j] = b_r . Y[j] over whole rows, for this
// thread's R held rows a, b (its 16 dims) and G streamed rows X[j], Y[j]
// ([G][DH] in shared memory, X and Y at this lane's chunk h)
template <int DH, int R, int G>
__device__ __forceinline__ void dots(float (&s)[R][G], float (&t)[R][G], const float (&a)[R][DL],
                                     const float (&b)[R][DL], const float* X, const float* Y) {
  constexpr int S = DH / DL;
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int j = 0; j < G; ++j) s[r][j] = t[r][j] = 0.f;
#pragma unroll
  for (int i = 0; i < CL; ++i)
#pragma unroll
    for (int j = 0; j < G; ++j) {
      const float4 x = *reinterpret_cast<const float4*>(X + j * DH + 4 * S * i);
      const float4 y = *reinterpret_cast<const float4*>(Y + j * DH + 4 * S * i);
#pragma unroll
      for (int r = 0; r < R; ++r) {
        s[r][j] = fmaf(a[r][4 * i], x.x, s[r][j]);
        s[r][j] = fmaf(a[r][4 * i + 1], x.y, s[r][j]);
        s[r][j] = fmaf(a[r][4 * i + 2], x.z, s[r][j]);
        s[r][j] = fmaf(a[r][4 * i + 3], x.w, s[r][j]);
        t[r][j] = fmaf(b[r][4 * i], y.x, t[r][j]);
        t[r][j] = fmaf(b[r][4 * i + 1], y.y, t[r][j]);
        t[r][j] = fmaf(b[r][4 * i + 2], y.z, t[r][j]);
        t[r][j] = fmaf(b[r][4 * i + 3], y.w, t[r][j]);
      }
    }
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int j = 0; j < G; ++j) s[r][j] = row_sum<S>(s[r][j]), t[r][j] = row_sum<S>(t[r][j]);
  // the callers read X or Y again (dq += dS K, dk += dS^T Q, dv += P^T dO):
  // reloading them costs less than the registers that keeping every value
  // read here would take through the softmax
  asm volatile("" ::: "memory");
}

// acc[r][d] += w[r][j] * X[j][d] over the G streamed rows X ([G][DH], at
// this lane's chunk h), this lane's 16 dims
template <int DH, int R, int G>
__device__ __forceinline__ void accumulate(float (&acc)[R][DL], const float (&w)[R][G],
                                           const float* X) {
  constexpr int S = DH / DL;
#pragma unroll
  for (int j = 0; j < G; ++j)
#pragma unroll
    for (int i = 0; i < CL; ++i) {
      const float4 x = *reinterpret_cast<const float4*>(X + j * DH + 4 * S * i);
#pragma unroll
      for (int r = 0; r < R; ++r) {
        acc[r][4 * i] = fmaf(w[r][j], x.x, acc[r][4 * i]);
        acc[r][4 * i + 1] = fmaf(w[r][j], x.y, acc[r][4 * i + 1]);
        acc[r][4 * i + 2] = fmaf(w[r][j], x.z, acc[r][4 * i + 2]);
        acc[r][4 * i + 3] = fmaf(w[r][j], x.w, acc[r][4 * i + 3]);
      }
    }
}

// float4 y into global chunk `chunk` of a row (the dims below dh)
__device__ __forceinline__ void store_chunk(float* row, float4 y, int chunk, int dh, bool vec) {
  const int c = 4 * chunk;
  if (c >= dh) return;
  if (vec) {
    *reinterpret_cast<float4*>(row + c) = y;
  } else {
    row[c] = y.x;
    if (c + 1 < dh) row[c + 1] = y.y;
    if (c + 2 < dh) row[c + 2] = y.z;
    if (c + 3 < dh) row[c + 3] = y.w;
  }
}

// the four warps' float4 chunk `i` (of DL / 4) of row r, as put_part left
// them in part[warp][r][ROW][lane], each weighted by w[warp], summed in order
template <int R, int ROW>
__device__ __forceinline__ float4 sum_chunk(const float* part, int r, int i,
                                            const float (&w)[WARPS], int lane) {
  float4 y = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
  for (int wp = 0; wp < WARPS; ++wp) {
    const float* pr = part + ((wp * R + r) * ROW + 4 * i) * 32 + lane;
    y.x = fmaf(w[wp], pr[0], y.x);
    y.y = fmaf(w[wp], pr[32], y.y);
    y.z = fmaf(w[wp], pr[64], y.z);
    y.w = fmaf(w[wp], pr[96], y.w);
  }
  return y;
}

// Runs `body(c, buf)` for each of `chunks` chunks of streamed rows, `buf`
// the shared-memory buffer that `stage(c, buf)` filled with cp.async:
// chunk c + 1's copies are in flight while chunk c is read.
template <class Stage, class Body>
__device__ __forceinline__ void for_chunks(float* bufs, int buf_floats, int chunks, Stage stage,
                                           Body body) {
  for (int c = 0; c <= chunks; ++c) {
    if (c < chunks) stage(c, bufs + (c & 1) * buf_floats);
    cp_async_commit();  // empty after the last chunk
    if (c == 0) continue;
    cp_async_wait<1>();  // chunk c - 1 has landed
    __syncthreads();
    body(c - 1, bufs + ((c - 1) & 1) * buf_floats);
    __syncthreads();  // its buffer is free for chunk c + 1
  }
}

// Forward. Held: R query rows a thread; streamed: K, V (and the key bias).
template <int DH, bool BIAS>
__global__ void __launch_bounds__(THREADS, FWD_B)
flash_fwd_f32(Params p) {
  using Sh = FwdShape<DH, BIAS>;
  constexpr int S = Sh::S, R = FWD_R, G = FWD_G, CH = chunk_rows(DH);
  extern __shared__ __align__(16) float sm[];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, part_h = lane % S;
  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * Sh::ROWS, n = p.n;
  const int row0 = q0 + lane / S;  // this thread's rows: row0 + r * 32 / S
  const size_t off = (size_t)b * p.sb + (size_t)h * p.sh;
  const float* brow = BIAS ? p.bias + (size_t)b * n : nullptr;
  const int cap = Sh::cap(n), nk = p.causal ? min(n, q0 + Sh::ROWS) : n;
  const float c2 = BIAS ? L2E : p.scale * L2E;  // exp2 units of a score (BIAS: of a biased one)

  float q[R][DL], o[R][DL], m[R], l[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int row = row0 + r * 32 / S;
    load_row<S>(q[r], p.q + off + (size_t)row * p.sn + 4 * part_h, part_h, row < n, p.dh,
                p.vec);
    m[r] = -INFINITY, l[r] = 0.f;
#pragma unroll
    for (int d = 0; d < DL; ++d) o[r][d] = 0.f;
  }

  auto stage = [&](int c, float* buf) {
    const int c0 = c * CH, len = min(CH, nk - c0), rows = (len + G - 1) / G * G;
    stage_tile<DH>(buf, p.k + off + (size_t)c0 * p.sn, p.sn, rows, len, p.dh, p.vec);
    stage_tile<DH>(buf + cap * DH, p.v + off + (size_t)c0 * p.sn, p.sn, rows, len, p.dh, p.vec);
    if (BIAS) stage_values(buf + 2 * cap * DH, brow + c0, rows, len, 0.f);
  };
  for_chunks(sm, cap * Sh::PER_ROW, (nk + CH - 1) / CH, stage, [&](int c, const float* buf) {
    const int c0 = c * CH, groups = (min(CH, nk - c0) + G - 1) / G;
    for (int j = warp; j < groups; j += WARPS) {
      // one group of G keys from key0: scores, online softmax, o += P V
      const int key0 = c0 + j * G;
      const float* K = buf + j * G * DH + 4 * part_h;
      const float* V = K + cap * DH;
      const float* kbias = buf + 2 * cap * DH + j * G;
      const bool edge = key0 + G > n || (p.causal && key0 + G - 1 > q0);
      auto masked = [&](int r, int jj) {
        return key0 + jj >= n || (p.causal && key0 + jj > row0 + r * 32 / S);
      };
      float s[R][G];
#pragma unroll
      for (int r = 0; r < R; ++r)
#pragma unroll
        for (int jj = 0; jj < G; ++jj) s[r][jj] = 0.f;
#pragma unroll
      for (int i = 0; i < CL; ++i)
#pragma unroll
        for (int jj = 0; jj < G; ++jj) {
          const float4 x = *reinterpret_cast<const float4*>(K + jj * DH + 4 * S * i);
#pragma unroll
          for (int r = 0; r < R; ++r) {
            s[r][jj] = fmaf(q[r][4 * i], x.x, s[r][jj]);
            s[r][jj] = fmaf(q[r][4 * i + 1], x.y, s[r][jj]);
            s[r][jj] = fmaf(q[r][4 * i + 2], x.z, s[r][jj]);
            s[r][jj] = fmaf(q[r][4 * i + 3], x.w, s[r][jj]);
          }
        }
#pragma unroll
      for (int r = 0; r < R; ++r)
#pragma unroll
        for (int jj = 0; jj < G; ++jj) {
          s[r][jj] = row_sum<S>(s[r][jj]);
          if (BIAS) s[r][jj] = fmaf(s[r][jj], p.scale, kbias[jj]);
        }
      if (edge) {
#pragma unroll
        for (int r = 0; r < R; ++r)
#pragma unroll
          for (int jj = 0; jj < G; ++jj)
            if (masked(r, jj)) s[r][jj] = NEG;
      }
      float alpha[R];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        float mx = m[r];
#pragma unroll
        for (int jj = 0; jj < G; ++jj) mx = fmaxf(mx, s[r][jj]);
        alpha[r] = exp2_approx((m[r] - mx) * c2);
        const float mc = mx * c2;
#pragma unroll
        for (int jj = 0; jj < G; ++jj)
          s[r][jj] = BIAS ? exp2_approx((s[r][jj] - mx) * L2E)
                          : exp2_approx(fmaf(s[r][jj], c2, -mc));
        m[r] = mx;
      }
      // a masked key's P is 0, also where every key so far was masked (the
      // folded FFMA of -1e30 against itself leaves the product's rounding)
      if (edge) {
#pragma unroll
        for (int r = 0; r < R; ++r)
#pragma unroll
          for (int jj = 0; jj < G; ++jj)
            if (masked(r, jj)) s[r][jj] = 0.f;
      }
#pragma unroll
      for (int r = 0; r < R; ++r) {
        float sum = 0.f;
#pragma unroll
        for (int jj = 0; jj < G; ++jj) sum += s[r][jj];
        l[r] = fmaf(l[r], alpha[r], sum);
#pragma unroll
        for (int d = 0; d < DL; ++d) o[r][d] *= alpha[r];
      }
      accumulate<DH, R, G>(o, s, V);
    }
  });

  // the warps' (o, m, l) as part[warp][r][DL + 2][lane]; then thread (warp
  // w) rescales and sums chunk w of its rows over the warps in order. Warp
  // 0 saw key 0, which no row masks, so every row's max is real.
  float* part = sm;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    float* pr = part + (warp * R + r) * (DL + 2) * 32 + lane;
#pragma unroll
    for (int d = 0; d < DL; ++d) pr[d * 32] = o[r][d];
    pr[DL * 32] = m[r];
    pr[(DL + 1) * 32] = l[r];
  }
  __syncthreads();
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int row = row0 + r * 32 / S;
    float mw[WARPS], mx = -INFINITY, sum = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      mw[w] = part[((w * R + r) * (DL + 2) + DL) * 32 + lane];
      mx = fmaxf(mx, mw[w]);
    }
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      mw[w] = exp2_approx((mw[w] - mx) * c2);
      sum = fmaf(mw[w], part[((w * R + r) * (DL + 2) + DL + 1) * 32 + lane], sum);
    }
    float4 y = sum_chunk<R, DL + 2>(part, r, warp, mw, lane);
    if (row >= n) continue;
    y.x /= sum, y.y /= sum, y.z /= sum, y.w /= sum;
    store_chunk(p.out + (size_t)b * p.osb + (size_t)h * p.osh + (size_t)row * p.osn, y,
                part_h + S * warp, p.dh, p.vec);
    if (p.lse && warp == 0 && part_h == 0)
      p.lse[((size_t)b * gridDim.y + h) * n + row] = (BIAS ? mx : mx * p.scale) + logf(sum);
  }
}

// D = rowsum(dO * O): a thread a row
__global__ void __launch_bounds__(256)
flash_bwd_delta_f32(Params p) {
  const int row = blockIdx.x * 256 + threadIdx.x, b = blockIdx.z, h = blockIdx.y;
  if (row >= p.n) return;
  const size_t off = (size_t)b * p.osb + (size_t)h * p.osh + (size_t)row * p.osn;
  const float* o = p.o + off;
  const float* g = p.g + off;
  float s = 0.f;
  if (p.vec) {
    for (int d = 0; d < p.dh; d += 4) {
      const float4 a = __ldg(reinterpret_cast<const float4*>(o + d));
      const float4 c = __ldg(reinterpret_cast<const float4*>(g + d));
      s = fmaf(a.x, c.x, s);
      s = fmaf(a.y, c.y, s);
      s = fmaf(a.z, c.z, s);
      s = fmaf(a.w, c.w, s);
    }
  } else {
    for (int d = 0; d < p.dh; ++d) s = fmaf(__ldg(o + d), __ldg(g + d), s);
  }
  p.delta[((size_t)b * gridDim.y + h) * p.n + row] = s;
}

// dQ. Held: R query rows a thread (q and dO, with their lse and D);
// streamed: K, V (and the key bias).
template <int DH, bool BIAS>
__global__ void __launch_bounds__(THREADS, DQ_B)
flash_bwd_dq_f32(Params p) {
  using Sh = DqShape<DH, BIAS>;
  constexpr int S = Sh::S, R = DQ_R, G = DQ_G, CH = chunk_rows(DH);
  extern __shared__ __align__(16) float sm[];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, part_h = lane % S;
  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * Sh::ROWS, n = p.n;
  const int row0 = q0 + lane / S;
  const size_t off = (size_t)b * p.sb + (size_t)h * p.sh;
  const size_t goff = (size_t)b * p.osb + (size_t)h * p.osh;
  const size_t rows_off = ((size_t)b * gridDim.y + h) * n;
  const float* brow = BIAS ? p.bias + (size_t)b * n : nullptr;
  const int cap = Sh::cap(n), nk = p.causal ? min(n, q0 + Sh::ROWS) : n;
  const float c2 = p.scale * L2E;

  float q[R][DL], go[R][DL], dq[R][DL], lse[R], dd[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int row = row0 + r * 32 / S;
    const bool ok = row < n;
    load_row<S>(q[r], p.q + off + (size_t)row * p.sn + 4 * part_h, part_h, ok, p.dh, p.vec);
    load_row<S>(go[r], p.g + goff + (size_t)row * p.osn + 4 * part_h, part_h, ok, p.dh, p.vec);
    // lse in exp2 units without a bias; +inf past N (P = 0)
    lse[r] = ok ? p.lse[rows_off + row] * (BIAS ? 1.f : L2E) : INFINITY;
    dd[r] = ok ? p.delta[rows_off + row] : 0.f;
#pragma unroll
    for (int d = 0; d < DL; ++d) dq[r][d] = 0.f;
  }

  auto stage = [&](int c, float* buf) {
    const int c0 = c * CH, len = min(CH, nk - c0), rows = (len + G - 1) / G * G;
    stage_tile<DH>(buf, p.k + off + (size_t)c0 * p.sn, p.sn, rows, len, p.dh, p.vec);
    stage_tile<DH>(buf + cap * DH, p.v + off + (size_t)c0 * p.sn, p.sn, rows, len, p.dh, p.vec);
    if (BIAS) stage_values(buf + 2 * cap * DH, brow + c0, rows, len, 0.f);
  };
  for_chunks(sm, cap * Sh::PER_ROW, (nk + CH - 1) / CH, stage, [&](int c, const float* buf) {
    const int c0 = c * CH, groups = (min(CH, nk - c0) + G - 1) / G;
    for (int j = warp; j < groups; j += WARPS) {
      // one group of G keys from key0: S, dP, dS, then dq += dS K
      const int key0 = c0 + j * G;
      const float* K = buf + j * G * DH + 4 * part_h;
      const float* V = K + cap * DH;
      const float* kbias = buf + 2 * cap * DH + j * G;
      float s[R][G], dp[R][G];
      dots<DH, R, G>(s, dp, q, go, K, V);
#pragma unroll
      for (int r = 0; r < R; ++r)
#pragma unroll
        for (int jj = 0; jj < G; ++jj) {
          const float pv = BIAS ? exp2_approx((fmaf(s[r][jj], p.scale, kbias[jj]) - lse[r]) * L2E)
                                : exp2_approx(fmaf(s[r][jj], c2, -lse[r]));
          s[r][jj] = pv * (dp[r][jj] - dd[r]) * p.scale;
        }
      if (key0 + G > n || (p.causal && key0 + G - 1 > q0)) {
#pragma unroll
        for (int r = 0; r < R; ++r)
#pragma unroll
          for (int jj = 0; jj < G; ++jj)
            if (key0 + jj >= n || (p.causal && key0 + jj > row0 + r * 32 / S)) s[r][jj] = 0.f;
      }
      accumulate<DH, R, G>(dq, s, K);
    }
  });

  // the warps' dq as part[warp][r][DL][lane], summed in order
  float* part = sm;
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int d = 0; d < DL; ++d) part[((warp * R + r) * DL + d) * 32 + lane] = dq[r][d];
  __syncthreads();
  const float ones[WARPS] = {1.f, 1.f, 1.f, 1.f};
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int row = row0 + r * 32 / S;
    const float4 y = sum_chunk<R, DL>(part, r, warp, ones, lane);
    if (row < n)
      store_chunk(p.dq + goff + (size_t)row * p.osn, y, part_h + S * warp, p.dh, p.vec);
  }
}

// dK and dV. Held: R key rows a thread (k and v, with their key bias);
// streamed: Q, dO, lse and D.
template <int DH, bool BIAS>
__global__ void __launch_bounds__(THREADS, DKDV_B)
flash_bwd_dkdv_f32(Params p) {
  using Sh = DkdvShape<DH>;
  constexpr int S = Sh::S, R = DKDV_R, G = DKDV_G, CH = chunk_rows(DH);
  extern __shared__ __align__(16) float sm[];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, part_h = lane % S;
  const int b = blockIdx.z, h = blockIdx.y, k0 = blockIdx.x * Sh::ROWS, n = p.n;
  const int key0 = k0 + lane / S;  // this thread's keys: key0 + r * 32 / S
  const size_t off = (size_t)b * p.sb + (size_t)h * p.sh;
  const size_t goff = (size_t)b * p.osb + (size_t)h * p.osh;
  const size_t rows_off = ((size_t)b * gridDim.y + h) * n;
  const int cap = Sh::cap(n), qs = p.causal ? k0 : 0;  // the first query that counts
  const float c2 = p.scale * L2E;

  float k[R][DL], v[R][DL], dk[R][DL], dv[R][DL], kb[R], db[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int key = key0 + r * 32 / S;
    const bool ok = key < n;
    load_row<S>(k[r], p.k + off + (size_t)key * p.sn + 4 * part_h, part_h, ok, p.dh, p.vec);
    load_row<S>(v[r], p.v + off + (size_t)key * p.sn + 4 * part_h, part_h, ok, p.dh, p.vec);
    kb[r] = BIAS && ok ? p.bias[(size_t)b * n + key] : 0.f;
    db[r] = 0.f;
#pragma unroll
    for (int d = 0; d < DL; ++d) dk[r][d] = dv[r][d] = 0.f;
  }

  auto stage = [&](int c, float* buf) {
    const int c0 = qs + c * CH, len = min(CH, n - c0), rows = (len + G - 1) / G * G;
    stage_tile<DH>(buf, p.q + off + (size_t)c0 * p.sn, p.sn, rows, len, p.dh, p.vec);
    stage_tile<DH>(buf + cap * DH, p.g + goff + (size_t)c0 * p.osn, p.osn, rows, len, p.dh,
                   p.vec);
    stage_values(buf + 2 * cap * DH, p.lse + rows_off + c0, rows, len, INFINITY);
    stage_values(buf + 2 * cap * DH + cap, p.delta + rows_off + c0, rows, len, 0.f);
  };
  for_chunks(sm, cap * Sh::PER_ROW, (n - qs + CH - 1) / CH, stage, [&](int c, const float* buf) {
    const int c0 = qs + c * CH, groups = (min(CH, n - c0) + G - 1) / G;
    for (int j = warp; j < groups; j += WARPS) {
      // one group of G queries from i0: S^T, dP^T, then dv += P^T dO, dk += dS^T Q
      const int i0 = c0 + j * G;
      const float* Q = buf + j * G * DH + 4 * part_h;
      const float* GO = Q + cap * DH;
      const float* L = buf + 2 * cap * DH + j * G;
      const float* Dq = L + cap;
      float s[R][G], dp[R][G];
      dots<DH, R, G>(s, dp, k, v, Q, GO);
#pragma unroll
      for (int jj = 0; jj < G; ++jj) {
        const float lj = BIAS ? L[jj] : L[jj] * L2E, dj = Dq[jj];
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const float pv = BIAS ? exp2_approx((fmaf(s[r][jj], p.scale, kb[r]) - lj) * L2E)
                                : exp2_approx(fmaf(s[r][jj], c2, -lj));
          s[r][jj] = pv;
          dp[r][jj] = pv * (dp[r][jj] - dj);
        }
      }
      if (p.causal && k0 + Sh::ROWS - 1 > i0) {
#pragma unroll
        for (int r = 0; r < R; ++r)
#pragma unroll
          for (int jj = 0; jj < G; ++jj)
            if (key0 + r * 32 / S > i0 + jj) s[r][jj] = dp[r][jj] = 0.f;
      }
#pragma unroll
      for (int r = 0; r < R; ++r)
#pragma unroll
        for (int jj = 0; jj < G; ++jj) {
          if (BIAS) db[r] += dp[r][jj];
          dp[r][jj] *= p.scale;
        }
      accumulate<DH, R, G>(dv, s, GO);
      accumulate<DH, R, G>(dk, dp, Q);
    }
  });

  // the warps' (dk, dv, dbias) as part[warp][r][2 DL + 1][lane], summed in order
  float* part = sm;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    float* pr = part + (warp * R + r) * (2 * DL + 1) * 32 + lane;
#pragma unroll
    for (int d = 0; d < DL; ++d) pr[d * 32] = dk[r][d], pr[(DL + d) * 32] = dv[r][d];
    pr[2 * DL * 32] = db[r];
  }
  __syncthreads();
  const float ones[WARPS] = {1.f, 1.f, 1.f, 1.f};
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int key = key0 + r * 32 / S;
    const float4 yk = sum_chunk<R, 2 * DL + 1>(part, r, warp, ones, lane);
    const float4 yv = sum_chunk<R, 2 * DL + 1>(part + DL * 32, r, warp, ones, lane);
    if (key >= n) continue;
    const size_t o = goff + (size_t)key * p.osn;
    store_chunk(p.dk + o, yk, part_h + S * warp, p.dh, p.vec);
    store_chunk(p.dv + o, yv, part_h + S * warp, p.dh, p.vec);
    if (BIAS && p.dbias && warp == 0 && part_h == 0) {
      float sum = 0.f;
#pragma unroll
      for (int w = 0; w < WARPS; ++w)
        sum += part[((w * R + r) * (2 * DL + 1) + 2 * DL) * 32 + lane];
      atomicAdd(p.dbias + (size_t)b * n + key, sum);
    }
  }
}

// every base 16-byte aligned, every stride and dh a multiple of 4 floats
inline bool rows_aligned(std::initializer_list<const void*> ptrs,
                         std::initializer_list<int> strides, int dh) {
  if (dh % 4) return false;
  for (const void* ptr : ptrs)
    if (reinterpret_cast<uintptr_t>(ptr) % 16) return false;
  for (int s : strides)
    if (s % 4) return false;
  return true;
}

}  // namespace f32

template <int NC>
cudaError_t fwd(const float* bias, int n, int heads, int b, cudaStream_t s, const FwdParams& p) {
  const dim3 grid((n + NC * ROWS - 1) / (NC * ROWS), heads, b);
  constexpr int smem = FwdSmem<NC>::BYTES, threads = (NC + 1) * WG;
  return bias ? launch<flash_fwd_wgmma<true, NC>>(grid, smem, s, p, threads)
              : launch<flash_fwd_wgmma<false, NC>>(grid, smem, s, p, threads);
}

// float32 at head dim DH: the forward, or the backward's three launches
template <int DH, bool BIAS>
cudaError_t fwd_f32(const f32::Params& p, int heads, int b, cudaStream_t s) {
  using S = f32::FwdShape<DH, BIAS>;
  return launch<f32::flash_fwd_f32<DH, BIAS>>(dim3((p.n + S::ROWS - 1) / S::ROWS, heads, b),
                                              S::smem_bytes(p.n), s, p, f32::THREADS,
                                              S::smem_bytes(1 << 30));
}

template <int DH, bool BIAS>
cudaError_t bwd_f32(const f32::Params& p, int heads, int b, cudaStream_t s) {
  using K = f32::DkdvShape<DH>;
  using Q = f32::DqShape<DH, BIAS>;
  f32::flash_bwd_delta_f32<<<dim3((p.n + 255) / 256, heads, b), 256, 0, s>>>(p);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  err = launch<f32::flash_bwd_dkdv_f32<DH, BIAS>>(dim3((p.n + K::ROWS - 1) / K::ROWS, heads, b),
                                                 K::smem_bytes(p.n), s, p, f32::THREADS,
                                                 K::smem_bytes(1 << 30));
  if (err != cudaSuccess) return err;
  return launch<f32::flash_bwd_dq_f32<DH, BIAS>>(dim3((p.n + Q::ROWS - 1) / Q::ROWS, heads, b),
                                                Q::smem_bytes(p.n), s, p, f32::THREADS,
                                                Q::smem_bytes(1 << 30));
}

// the float32 forward, or backward, at head dim DH
template <int DH>
cudaError_t run_f32(bool backward, const f32::Params& p, int heads, int b, cudaStream_t s) {
  if (backward)
    return p.bias ? bwd_f32<DH, true>(p, heads, b, s) : bwd_f32<DH, false>(p, heads, b, s);
  return p.bias ? fwd_f32<DH, true>(p, heads, b, s) : fwd_f32<DH, false>(p, heads, b, s);
}

// ... at the DH of dh: the next of 16, 32 and 64
cudaError_t run_f32(bool backward, const f32::Params& p, int heads, int b, cudaStream_t s) {
  return p.dh <= 16   ? run_f32<16>(backward, p, heads, b, s)
         : p.dh <= 32 ? run_f32<32>(backward, p, heads, b, s)
                      : run_f32<64>(backward, p, heads, b, s);
}

}  // namespace

extern "C" {

// q, k, v at base + b*sb + h*sh + n*sn + d (element strides, d contiguous),
// o at its own strides; bias [B, N] f32 or null; lse [B, H, N] f32 (each
// row's log-sum-exp of its masked, scaled scores, for the backward) or null;
// dtype 0 float32, 1 bf16.
// bf16 needs dh == 64, 16-byte aligned bases and strides % 8 == 0 (TMA);
// float32 needs dh <= 64.
int nx_flash_attention(const void* q, const void* k, const void* v, void* o, const float* bias,
                       float* lse, int dtype, int b, int heads, int n, int dh, int sb, int sh,
                       int sn, int osb, int osh, int osn, int causal, float scale,
                       void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (b < 1 || heads < 1 || n < 1 || b > 65535 || heads > 65535)
    return (int)cudaErrorInvalidValue;
  if (dtype == BF16) {
    if (dh != D) return (int)cudaErrorInvalidValue;
    FwdParams p;
    cudaError_t err = head_map(p.q, q, b, heads, n, sb, sh, sn);
    if (err == cudaSuccess) err = head_map(p.k, k, b, heads, n, sb, sh, sn);
    if (err == cudaSuccess) err = head_map(p.v, v, b, heads, n, sb, sh, sn);
    if (err == cudaSuccess) err = head_map(p.o, o, b, heads, n, osb, osh, osn);
    if (err != cudaSuccess) return (int)err;
    p.bias = bias, p.lse = lse, p.n = n, p.causal = causal, p.scale = scale;
    // three consumers (192 queries) per block at DINOv2's 1370 tokens; at
    // the path's 197 and 256 two (128 queries) pad fewer rows, and take
    // turns. The split at 512 is mha's N > 512 route's, not a measured
    // crossover: no length between 256 and 1370 was timed.
    return (int)(n > 512 ? fwd<3>(bias, n, heads, b, s, p) : fwd<2>(bias, n, heads, b, s, p));
  }
  if (dtype != F32 || dh < 1 || dh > 64) return (int)cudaErrorInvalidValue;
  f32::Params p = {};
  p.q = static_cast<const float*>(q), p.k = static_cast<const float*>(k);
  p.v = static_cast<const float*>(v), p.out = static_cast<float*>(o);
  p.bias = bias, p.lse = lse;
  p.sb = sb, p.sh = sh, p.sn = sn, p.osb = osb, p.osh = osh, p.osn = osn;
  p.n = n, p.dh = dh, p.causal = causal, p.scale = scale;
  p.vec = f32::rows_aligned({q, k, v, o}, {sb, sh, sn, osb, osh, osn}, dh);
  return (int)run_f32(false, p, heads, b, s);
}

// Backward of nx_flash_attention: q, k, v at their strides (as the
// forward); o (the forward's output), g (its gradient), dq, dk, dv at the
// strides osb/osh/osn; lse [B, H, N] from the forward; delta [B, H, N]
// float32 scratch; dbias [B, N] float32, zeroed, or null. Three launches:
// D = rowsum(g * o), the dK/dV kernel, the dQ kernel.
int nx_flash_attention_bwd(const void* q, const void* k, const void* v, const void* o,
                           const void* g, const float* lse, const float* bias, void* dq,
                           void* dk, void* dv, float* dbias, float* delta, int dtype, int b,
                           int heads, int n, int dh, int sb, int sh, int sn, int osb, int osh,
                           int osn, int causal, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (b < 1 || heads < 1 || n < 1 || b > 65535 || heads > 65535)
    return (int)cudaErrorInvalidValue;
  cudaError_t err;
  if (dtype == BF16) {
    if (dh != D) return (int)cudaErrorInvalidValue;
    BwdParams p;
    err = head_map(p.q, q, b, heads, n, sb, sh, sn);
    if (err == cudaSuccess) err = head_map(p.k, k, b, heads, n, sb, sh, sn);
    if (err == cudaSuccess) err = head_map(p.v, v, b, heads, n, sb, sh, sn);
    if (err == cudaSuccess) err = head_map(p.g, g, b, heads, n, osb, osh, osn);
    if (err == cudaSuccess) err = head_map(p.dq, dq, b, heads, n, osb, osh, osn);
    if (err == cudaSuccess) err = head_map(p.dk, dk, b, heads, n, osb, osh, osn);
    if (err == cudaSuccess) err = head_map(p.dv, dv, b, heads, n, osb, osh, osn);
    if (err != cudaSuccess) return (int)err;
    p.lse = lse, p.delta = delta, p.bias = bias, p.dbias = dbias;
    p.n = n, p.causal = causal, p.scale = scale;
    if (reinterpret_cast<uintptr_t>(o) % 16) return (int)cudaErrorInvalidValue;
    const Out og{const_cast<void*>(o), osb, osh, osn};
    flash_bwd_delta_bf16<<<dim3((n + 31) / 32, heads, b), 256, 0, s>>>(
        og, static_cast<const __nv_bfloat16*>(g), delta, n);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    const dim3 grid((n + 2 * ROWS - 1) / (2 * ROWS), heads, b);
    err = bias ? launch<flash_bwd_dkdv_wgmma<true>>(grid, DkdvSmem::BYTES, s, p)
               : launch<flash_bwd_dkdv_wgmma<false>>(grid, DkdvSmem::BYTES, s, p);
    if (err != cudaSuccess) return (int)err;
    return (int)(bias ? launch<flash_bwd_dq_wgmma<true>>(grid, DqSmem::BYTES, s, p)
                      : launch<flash_bwd_dq_wgmma<false>>(grid, DqSmem::BYTES, s, p));
  }
  if (dtype != F32 || dh < 1 || dh > 64) return (int)cudaErrorInvalidValue;
  f32::Params p = {};
  p.q = static_cast<const float*>(q), p.k = static_cast<const float*>(k);
  p.v = static_cast<const float*>(v), p.o = static_cast<const float*>(o);
  p.g = static_cast<const float*>(g), p.dq = static_cast<float*>(dq);
  p.dk = static_cast<float*>(dk), p.dv = static_cast<float*>(dv);
  p.bias = bias, p.lse = const_cast<float*>(lse), p.delta = delta, p.dbias = dbias;
  p.sb = sb, p.sh = sh, p.sn = sn, p.osb = osb, p.osh = osh, p.osn = osn;
  p.n = n, p.dh = dh, p.causal = causal, p.scale = scale;
  p.vec = f32::rows_aligned({q, k, v, o, g, dq, dk, dv}, {sb, sh, sn, osb, osh, osn}, dh);
  return (int)run_f32(true, p, heads, b, s);
}

}  // extern "C"
