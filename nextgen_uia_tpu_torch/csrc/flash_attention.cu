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
// float32: the tensor cores have no f32 product, so SIMT variants (8 warps
// x 4 rows, 64-wide tiles) keep the f32 path exact for the checks.

#include <cfloat>

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
// opting in to them once per device
template <auto KERNEL, class P>
cudaError_t launch(dim3 grid, int smem, cudaStream_t s, const P& p, int threads = THREADS) {
  static bool opted[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= 64) return cudaErrorInvalidDevice;
  if (!opted[dev]) {
    err = cudaFuncSetAttribute(KERNEL, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    opted[dev] = true;
  }
  void* args[] = {const_cast<P*>(&p)};
  err = cudaLaunchKernel(reinterpret_cast<const void*>(KERNEL), grid, dim3(threads), args,
                         smem, s);
  return err != cudaSuccess ? err : cudaGetLastError();
}

// ---------------------------------------------------------------------------
// float32 SIMT path: 8 warps x 4 query rows, 64-key tiles, dh <= 64
// ---------------------------------------------------------------------------

constexpr int SQ_ROWS = 4, S_THREADS = 256, S_WARPS = S_THREADS / 32;
constexpr int S_QTILE = S_WARPS * SQ_ROWS, S_KTILE = 64, S_KLD = S_KTILE + 1;

static inline size_t simt_smem(int dh) {
  return sizeof(float) * ((size_t)S_WARPS * SQ_ROWS * dh + (size_t)dh * S_KLD +
                          (size_t)S_KTILE * dh + (size_t)S_WARPS * SQ_ROWS * S_KTILE);
}

template <typename T>
__global__ void __launch_bounds__(S_THREADS)
flash_fwd_simt(QKV in, Out out, const float* __restrict__ bias, float* __restrict__ lse, int n,
               int dh, int causal, float scale) {
  extern __shared__ __align__(16) float sm[];
  float* Qs = sm;                                  // [warps][rows][dh]
  float* Kt = Qs + S_WARPS * SQ_ROWS * dh;         // [dh][S_KLD], transposed
  float* Vs = Kt + dh * S_KLD;                     // [S_KTILE][dh]
  float* Ps = Vs + S_KTILE * dh;                   // [warps][rows][S_KTILE]

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int b = blockIdx.z, h = blockIdx.y;
  const size_t off = (size_t)b * in.sb + (size_t)h * in.sh;
  const T* qb = static_cast<const T*>(in.q) + off;
  const T* kb = static_cast<const T*>(in.k) + off;
  const T* vb = static_cast<const T*>(in.v) + off;
  const float* brow = bias ? bias + (size_t)b * n : nullptr;
  const int i0 = blockIdx.x * S_QTILE + warp * SQ_ROWS;
  float* q = Qs + warp * SQ_ROWS * dh;
  float* p = Ps + warp * SQ_ROWS * S_KTILE;
  for (int e = lane; e < SQ_ROWS * dh; e += 32) {
    const int rr = e / dh, d = e % dh;
    q[e] = i0 + rr < n ? to_f32(qb[(size_t)(i0 + rr) * in.sn + d]) : 0.f;
  }
  const int d0 = lane, d1 = lane + 32;
  const bool has0 = d0 < dh, has1 = d1 < dh;
  float m_run[SQ_ROWS], l_run[SQ_ROWS], o0[SQ_ROWS], o1[SQ_ROWS];
#pragma unroll
  for (int rr = 0; rr < SQ_ROWS; ++rr) m_run[rr] = -INFINITY, l_run[rr] = o0[rr] = o1[rr] = 0.f;

  int n_tiles = (n + S_KTILE - 1) / S_KTILE;
  if (causal) n_tiles = min(n_tiles, (blockIdx.x * S_QTILE + S_QTILE - 1) / S_KTILE + 1);
  for (int t = 0; t < n_tiles; ++t) {
    __syncthreads();  // the previous tile's K and V are no longer read
    for (int i = threadIdx.x; i < S_KTILE * dh; i += S_THREADS) {
      const int k = i / dh, d = i % dh, key = t * S_KTILE + k;
      const bool ok = key < n;
      Kt[d * S_KLD + k] = ok ? to_f32(kb[(size_t)key * in.sn + d]) : 0.f;
      Vs[k * dh + d] = ok ? to_f32(vb[(size_t)key * in.sn + d]) : 0.f;
    }
    __syncthreads();
    float s[2][SQ_ROWS];
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int c = lane + 32 * half, key = t * S_KTILE + c;
#pragma unroll
      for (int rr = 0; rr < SQ_ROWS; ++rr) s[half][rr] = 0.f;
      for (int d = 0; d < dh; ++d) {
        const float kd = Kt[d * S_KLD + c];
#pragma unroll
        for (int rr = 0; rr < SQ_ROWS; ++rr) s[half][rr] = fmaf(q[rr * dh + d], kd, s[half][rr]);
      }
#pragma unroll
      for (int rr = 0; rr < SQ_ROWS; ++rr) {
        float v = s[half][rr] * scale;
        if (key >= n) v = NEG;
        else if (brow) v += brow[key];
        if (causal && key > i0 + rr) v = NEG;
        s[half][rr] = v;
      }
    }
#pragma unroll
    for (int rr = 0; rr < SQ_ROWS; ++rr) {
      const float mx = warp_max(fmaxf(s[0][rr], s[1][rr]));
      const float m_new = fmaxf(m_run[rr], mx);
      const float alpha = expf(m_run[rr] - m_new);
      const float e0 = expf(s[0][rr] - m_new), e1 = expf(s[1][rr] - m_new);
      p[rr * S_KTILE + lane] = round_to<T>(e0);
      p[rr * S_KTILE + lane + 32] = round_to<T>(e1);
      l_run[rr] = l_run[rr] * alpha + warp_sum(e0 + e1);
      m_run[rr] = m_new;
      o0[rr] *= alpha;
      o1[rr] *= alpha;
    }
    __syncwarp();
    for (int k = 0; k < S_KTILE; ++k) {
      const float v0 = has0 ? Vs[k * dh + d0] : 0.f, v1 = has1 ? Vs[k * dh + d1] : 0.f;
#pragma unroll
      for (int rr = 0; rr < SQ_ROWS; ++rr) {
        const float pk = p[rr * S_KTILE + k];
        o0[rr] = fmaf(pk, v0, o0[rr]);
        o1[rr] = fmaf(pk, v1, o1[rr]);
      }
    }
    __syncwarp();
  }
#pragma unroll
  for (int rr = 0; rr < SQ_ROWS; ++rr) {
    if (i0 + rr >= n) break;
    T* orow = static_cast<T*>(out.o) + (size_t)b * out.sb + (size_t)h * out.sh +
              (size_t)(i0 + rr) * out.sn;
    if (has0) orow[d0] = from_f32<T>(o0[rr] / l_run[rr]);
    if (has1) orow[d1] = from_f32<T>(o1[rr] / l_run[rr]);
    if (lse && lane == 0)
      lse[((size_t)b * gridDim.y + h) * n + i0 + rr] = m_run[rr] + logf(l_run[rr]);
  }
}

// ---------------------------------------------------------------------------
// float32 backward. The TPU kernel (_bwd_kernel) recomputes one head's whole
// score block in VMEM; here P is recomputed tile by tile from the row
// log-sum-exp the forward saved, P = exp(s - lse), with the forward's
// masking order (-1e30 past N, then the key bias, then causal). With
// D = rowsum(dO * O) (one small pass, `flash_bwd_delta`, shared with bf16):
//
//   dV = round(P)^T dO,  dP = dO V^T,  ds_raw = P * (dP - D),
//   dS = round(ds_raw * scale),  dQ = dS K,  dK = dS^T Q,
//   dbias[b, key] = sum over heads and queries of ds_raw.
//
// D equals the TPU kernel's rowsum(dP * P) up to the rounding of O to the
// input type (O = P V is stored rounded), a relative difference of about
// one rounding step of O (2^-9 in bf16, 2^-24 in float32). Two kernels and
// no atomics on dQ/dK/dV, so the result is deterministic: the dK/dV kernel
// loops over the query tiles accumulating dK and dV in registers (with
// `causal` it starts at the diagonal), the dQ kernel loops over the key
// tiles accumulating dQ (with `causal` it stops at the diagonal). dbias,
// when asked for, is each key's column sum of ds_raw, added over heads into
// a float32 [B, N] with atomics (in bf16 too).
// ---------------------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(256)
flash_bwd_delta(Out og, const void* __restrict__ g, float* __restrict__ delta, int n, int dh) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int b = blockIdx.z, h = blockIdx.y, row = blockIdx.x * 8 + warp;
  if (row >= n) return;
  const size_t off = (size_t)b * og.sb + (size_t)h * og.sh + (size_t)row * og.sn;
  const T* orow = static_cast<const T*>(og.o) + off;
  const T* grow = static_cast<const T*>(g) + off;
  float s = 0.f;
  for (int d = lane; d < dh; d += 32) s = fmaf(to_f32(orow[d]), to_f32(grow[d]), s);
  s = warp_sum(s);
  if (lane == 0) delta[((size_t)b * gridDim.y + h) * n + row] = s;
}

struct Grads {
  void* dq;
  void* dk;
  void* dv;
  float* dbias;  // [B, N] float32, zeroed by the caller, or null
};

// a masked, scaled score of (key, row), the forward's order
__device__ __forceinline__ float masked_score(float s, float scale, int key, int row, int n,
                                              const float* brow, int causal) {
  float v = s * scale;
  if (key >= n) v = NEG;
  else if (brow) v += brow[key];
  if (causal && key > row) v = NEG;
  return v;
}

// float32 SIMT backward, dh <= 64, exact float32 for the checks. dK/dV: 8
// warps x 4 keys per CTA, 64-query tiles (Q and dO transposed in shared
// memory, one query per lane and half); dQ: 8 warps x 4 queries, 64-key
// tiles (K and V transposed), as the forward's SIMT kernel.
constexpr int B_KLD = 64 + 1;

static inline size_t simt_bwd_smem(int dh) {
  // per-warp rows (2 x [4][dh]), two transposed tiles [dh][65], per-warp
  // [4][64] P and dS, and (dK/dV) the tile's lse and D
  return sizeof(float) * (2 * (size_t)S_WARPS * SQ_ROWS * dh + 2 * (size_t)dh * B_KLD +
                          2 * (size_t)S_WARPS * SQ_ROWS * 64 + 2 * 64);
}

template <typename T>
__global__ void __launch_bounds__(S_THREADS)
flash_bwd_dkdv_simt(QKV in, Out og, const T* __restrict__ g, const float* __restrict__ lse,
                    const float* __restrict__ delta, const float* __restrict__ bias, Grads out,
                    int n, int dh, int causal, float scale) {
  extern __shared__ __align__(16) float sm[];
  float* Kr = sm;                                  // [warps][rows][dh]
  float* Vr = Kr + S_WARPS * SQ_ROWS * dh;         // [warps][rows][dh]
  float* Qt = Vr + S_WARPS * SQ_ROWS * dh;         // [dh][65]
  float* Gt = Qt + dh * B_KLD;                     // [dh][65]
  float* Ps = Gt + dh * B_KLD;                     // [warps][rows][64]
  float* Ss = Ps + S_WARPS * SQ_ROWS * 64;         // [warps][rows][64]
  float* Lt = Ss + S_WARPS * SQ_ROWS * 64;         // [64]
  float* Dt = Lt + 64;                             // [64]

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int b = blockIdx.z, h = blockIdx.y;
  const size_t off = (size_t)b * in.sb + (size_t)h * in.sh;
  const size_t goff = (size_t)b * og.sb + (size_t)h * og.sh;
  const T* qb = static_cast<const T*>(in.q) + off;
  const T* kb = static_cast<const T*>(in.k) + off;
  const T* vb = static_cast<const T*>(in.v) + off;
  const T* gb = g + goff;
  const size_t rows_off = ((size_t)b * gridDim.y + h) * n;
  const float* brow = bias ? bias + (size_t)b * n : nullptr;
  const int cta_key0 = blockIdx.x * S_QTILE, j0 = cta_key0 + warp * SQ_ROWS;
  float* kr = Kr + warp * SQ_ROWS * dh;
  float* vr = Vr + warp * SQ_ROWS * dh;
  float* p = Ps + warp * SQ_ROWS * 64;
  float* ds = Ss + warp * SQ_ROWS * 64;
  for (int e = lane; e < SQ_ROWS * dh; e += 32) {
    const int rr = e / dh, d = e % dh;
    const bool ok = j0 + rr < n;
    kr[e] = ok ? to_f32(kb[(size_t)(j0 + rr) * in.sn + d]) : 0.f;
    vr[e] = ok ? to_f32(vb[(size_t)(j0 + rr) * in.sn + d]) : 0.f;
  }
  const int d0 = lane, d1 = lane + 32;
  const bool has0 = d0 < dh, has1 = d1 < dh;
  float ak0[SQ_ROWS] = {}, ak1[SQ_ROWS] = {}, av0[SQ_ROWS] = {}, av1[SQ_ROWS] = {};
  float db[SQ_ROWS] = {};

  const int n_tiles = (n + 63) / 64;
  for (int t = causal ? cta_key0 / 64 : 0; t < n_tiles; ++t) {
    __syncthreads();  // the previous tile is no longer read
    for (int i = threadIdx.x; i < 64 * dh; i += S_THREADS) {
      const int c = i / dh, d = i % dh, row = t * 64 + c;
      const bool ok = row < n;
      Qt[d * B_KLD + c] = ok ? to_f32(qb[(size_t)row * in.sn + d]) : 0.f;
      Gt[d * B_KLD + c] = ok ? to_f32(gb[(size_t)row * og.sn + d]) : 0.f;
    }
    if (threadIdx.x < 64) {
      const int row = t * 64 + threadIdx.x;
      Lt[threadIdx.x] = row < n ? lse[rows_off + row] : 0.f;
      Dt[threadIdx.x] = row < n ? delta[rows_off + row] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int c = lane + 32 * half, row = t * 64 + c;
      float s[SQ_ROWS] = {}, dp[SQ_ROWS] = {};
      for (int d = 0; d < dh; ++d) {
        const float qd = Qt[d * B_KLD + c], gd = Gt[d * B_KLD + c];
#pragma unroll
        for (int rr = 0; rr < SQ_ROWS; ++rr) {
          s[rr] = fmaf(kr[rr * dh + d], qd, s[rr]);
          dp[rr] = fmaf(vr[rr * dh + d], gd, dp[rr]);
        }
      }
#pragma unroll
      for (int rr = 0; rr < SQ_ROWS; ++rr) {
        const float v = masked_score(s[rr], scale, j0 + rr, row, n, brow, causal);
        const float pij = row < n ? expf(v - Lt[c]) : 0.f;
        const float ds_raw = pij * (dp[rr] - Dt[c]);
        db[rr] += ds_raw;
        p[rr * 64 + c] = round_to<T>(pij);
        ds[rr * 64 + c] = round_to<T>(ds_raw * scale);
      }
    }
    __syncwarp();
    for (int c = 0; c < 64; ++c) {
      const float g0 = has0 ? Gt[d0 * B_KLD + c] : 0.f, g1 = has1 ? Gt[d1 * B_KLD + c] : 0.f;
      const float q0 = has0 ? Qt[d0 * B_KLD + c] : 0.f, q1 = has1 ? Qt[d1 * B_KLD + c] : 0.f;
#pragma unroll
      for (int rr = 0; rr < SQ_ROWS; ++rr) {
        const float pr = p[rr * 64 + c], sr = ds[rr * 64 + c];
        av0[rr] = fmaf(pr, g0, av0[rr]);
        av1[rr] = fmaf(pr, g1, av1[rr]);
        ak0[rr] = fmaf(sr, q0, ak0[rr]);
        ak1[rr] = fmaf(sr, q1, ak1[rr]);
      }
    }
    __syncwarp();
  }
#pragma unroll
  for (int rr = 0; rr < SQ_ROWS; ++rr) {
    const float dsum = warp_sum(db[rr]);
    const int key = j0 + rr;
    if (key >= n) continue;
    if (out.dbias && lane == 0) atomicAdd(out.dbias + (size_t)b * n + key, dsum);
    const size_t o = goff + (size_t)key * og.sn;
    T* dkr = static_cast<T*>(out.dk) + o;
    T* dvr = static_cast<T*>(out.dv) + o;
    if (has0) dkr[d0] = from_f32<T>(ak0[rr]), dvr[d0] = from_f32<T>(av0[rr]);
    if (has1) dkr[d1] = from_f32<T>(ak1[rr]), dvr[d1] = from_f32<T>(av1[rr]);
  }
}

template <typename T>
__global__ void __launch_bounds__(S_THREADS)
flash_bwd_dq_simt(QKV in, Out og, const T* __restrict__ g, const float* __restrict__ lse,
                  const float* __restrict__ delta, const float* __restrict__ bias, Grads out,
                  int n, int dh, int causal, float scale) {
  extern __shared__ __align__(16) float sm[];
  float* Qr = sm;                                  // [warps][rows][dh]
  float* Gr = Qr + S_WARPS * SQ_ROWS * dh;         // [warps][rows][dh]
  float* Kt = Gr + S_WARPS * SQ_ROWS * dh;         // [dh][65]
  float* Vt = Kt + dh * B_KLD;                     // [dh][65]
  float* Ss = Vt + dh * B_KLD;                     // [warps][rows][64]

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int b = blockIdx.z, h = blockIdx.y;
  const size_t off = (size_t)b * in.sb + (size_t)h * in.sh;
  const size_t goff = (size_t)b * og.sb + (size_t)h * og.sh;
  const T* qb = static_cast<const T*>(in.q) + off;
  const T* kb = static_cast<const T*>(in.k) + off;
  const T* vb = static_cast<const T*>(in.v) + off;
  const T* gb = g + goff;
  const size_t rows_off = ((size_t)b * gridDim.y + h) * n;
  const float* brow = bias ? bias + (size_t)b * n : nullptr;
  const int i0 = blockIdx.x * S_QTILE + warp * SQ_ROWS;
  float* qr = Qr + warp * SQ_ROWS * dh;
  float* gr = Gr + warp * SQ_ROWS * dh;
  float* ds = Ss + warp * SQ_ROWS * 64;
  for (int e = lane; e < SQ_ROWS * dh; e += 32) {
    const int rr = e / dh, d = e % dh;
    const bool ok = i0 + rr < n;
    qr[e] = ok ? to_f32(qb[(size_t)(i0 + rr) * in.sn + d]) : 0.f;
    gr[e] = ok ? to_f32(gb[(size_t)(i0 + rr) * og.sn + d]) : 0.f;
  }
  float l_row[SQ_ROWS], d_row[SQ_ROWS];
#pragma unroll
  for (int rr = 0; rr < SQ_ROWS; ++rr) {
    const bool ok = i0 + rr < n;
    l_row[rr] = ok ? lse[rows_off + i0 + rr] : 0.f;
    d_row[rr] = ok ? delta[rows_off + i0 + rr] : 0.f;
  }
  const int d0 = lane, d1 = lane + 32;
  const bool has0 = d0 < dh, has1 = d1 < dh;
  float a0[SQ_ROWS] = {}, a1[SQ_ROWS] = {};

  int n_tiles = (n + 63) / 64;
  if (causal) n_tiles = min(n_tiles, (blockIdx.x * S_QTILE + S_QTILE - 1) / 64 + 1);
  for (int t = 0; t < n_tiles; ++t) {
    __syncthreads();
    for (int i = threadIdx.x; i < 64 * dh; i += S_THREADS) {
      const int c = i / dh, d = i % dh, key = t * 64 + c;
      const bool ok = key < n;
      Kt[d * B_KLD + c] = ok ? to_f32(kb[(size_t)key * in.sn + d]) : 0.f;
      Vt[d * B_KLD + c] = ok ? to_f32(vb[(size_t)key * in.sn + d]) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int c = lane + 32 * half, key = t * 64 + c;
      float s[SQ_ROWS] = {}, dp[SQ_ROWS] = {};
      for (int d = 0; d < dh; ++d) {
        const float kd = Kt[d * B_KLD + c], vd = Vt[d * B_KLD + c];
#pragma unroll
        for (int rr = 0; rr < SQ_ROWS; ++rr) {
          s[rr] = fmaf(qr[rr * dh + d], kd, s[rr]);
          dp[rr] = fmaf(gr[rr * dh + d], vd, dp[rr]);
        }
      }
#pragma unroll
      for (int rr = 0; rr < SQ_ROWS; ++rr) {
        const int row = i0 + rr;
        const float v = masked_score(s[rr], scale, key, row, n, brow, causal);
        const float pij = row < n ? expf(v - l_row[rr]) : 0.f;
        ds[rr * 64 + c] = round_to<T>(pij * (dp[rr] - d_row[rr]) * scale);
      }
    }
    __syncwarp();
    for (int c = 0; c < 64; ++c) {
      const float k0 = has0 ? Kt[d0 * B_KLD + c] : 0.f, k1 = has1 ? Kt[d1 * B_KLD + c] : 0.f;
#pragma unroll
      for (int rr = 0; rr < SQ_ROWS; ++rr) {
        a0[rr] = fmaf(ds[rr * 64 + c], k0, a0[rr]);
        a1[rr] = fmaf(ds[rr * 64 + c], k1, a1[rr]);
      }
    }
    __syncwarp();
  }
#pragma unroll
  for (int rr = 0; rr < SQ_ROWS; ++rr) {
    if (i0 + rr >= n) break;
    T* dqr = static_cast<T*>(out.dq) + goff + (size_t)(i0 + rr) * og.sn;
    if (has0) dqr[d0] = from_f32<T>(a0[rr]);
    if (has1) dqr[d1] = from_f32<T>(a1[rr]);
  }
}

template <int NC>
cudaError_t fwd(const float* bias, int n, int heads, int b, cudaStream_t s, const FwdParams& p) {
  const dim3 grid((n + NC * ROWS - 1) / (NC * ROWS), heads, b);
  constexpr int smem = FwdSmem<NC>::BYTES, threads = (NC + 1) * WG;
  return bias ? launch<flash_fwd_wgmma<true, NC>>(grid, smem, s, p, threads)
              : launch<flash_fwd_wgmma<false, NC>>(grid, smem, s, p, threads);
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
  const QKV in{q, k, v, sb, sh, sn};
  const Out out{o, osb, osh, osn};
  const size_t smem = simt_smem(dh);
  const cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_simt<float>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((n + S_QTILE - 1) / S_QTILE, heads, b);
  flash_fwd_simt<float><<<grid, S_THREADS, smem, s>>>(in, out, bias, lse, n, dh, causal, scale);
  return (int)cudaGetLastError();
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
  const QKV in{q, k, v, sb, sh, sn};
  const Out og{const_cast<void*>(o), osb, osh, osn};
  const Grads out{dq, dk, dv, dbias};
  const dim3 rows_grid((n + 7) / 8, heads, b);
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
  flash_bwd_delta<float><<<rows_grid, 256, 0, s>>>(og, g, delta, n, dh);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  const auto* gg = static_cast<const float*>(g);
  const size_t smem = simt_bwd_smem(dh);
  const dim3 grid((n + S_QTILE - 1) / S_QTILE, heads, b);
  if ((err = cudaFuncSetAttribute(flash_bwd_dkdv_simt<float>,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem)) !=
      cudaSuccess)
    return (int)err;
  flash_bwd_dkdv_simt<float><<<grid, S_THREADS, smem, s>>>(in, og, gg, lse, delta, bias, out, n,
                                                           dh, causal, scale);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  if ((err = cudaFuncSetAttribute(flash_bwd_dq_simt<float>,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem)) !=
      cudaSuccess)
    return (int)err;
  flash_bwd_dq_simt<float><<<grid, S_THREADS, smem, s>>>(in, og, gg, lse, delta, bias, out, n, dh,
                                                         causal, scale);
  return (int)cudaGetLastError();
}

}  // extern "C"
