// A bf16 GEMM core for Hopper (sm_90a): TMA, mbarriers and wgmma.
//
//   out[B*N, cols] = epilogue(A[B*N, K] @ W^T), W stored [cols, K] (K-major),
//   float32 accumulation, the output rounded once to bf16 (or float32)
//
// The rows are a batch of sequences, B of N tokens each, and every operand
// with rows is one of two layouts (TmaMatrix), as block_kernels.cuh's
// Operand: row-major [B, N, cols] with rows `ld` elements apart (a column
// slice of a wider buffer when ld > cols), or head-major, the logical column
// c = t*H*dh + h*dh + e living at ptr[t][b, h, n, e] ([B, H, N, dh]: q, k, v
// and their gradients). The M tile is (one sequence, 128 tokens), so a tile
// never crosses a sequence: TMA reads a row-major operand as a 3-D box of
// [B, N, cols] and a head-major one as a 4-D box of [B, H, N, dh] (one
// head's 64 columns per K step, hence dh % 64 == 0), and its out-of-bounds
// zero fill covers a token count the tile does not divide; the TMA stores
// clip the same rows. Only a head-major operand needs the per-sequence
// tile: a product whose operands are all row-major is run flat, as one
// sequence of B*N tokens (batch 1), so its tiles cross sequences and only
// the last one is ragged.
//
// Design (persistent: one CTA per SM walks its share of the tiles in a
// fixed order; CTAs in clusters of two):
// - Warpgroup 2 is the producer: it gives up registers (setmaxnreg) and one
//   thread issues the TMA loads of A (128 x 64) and W (BN x 64) into a ring
//   of STAGES shared-memory stages, 128-byte swizzled, each stage with a
//   `full` mbarrier (transaction bytes) and an `empty` one (one arrival per
//   consumer of the cluster). It runs ahead across tiles, so the next
//   tile's operands load while the consumers finish this one. The CTAs of a
//   cluster take M tiles side by side with the same columns: each loads its
//   own A box and 1/CLUSTER of the W tile, multicast to all of them, so W,
//   the larger operand, crosses L2 once per cluster.
// - Warpgroups 0 and 1 are the consumers: each owns 64 rows of the tile and
//   issues wgmma.mma_async m64nBNk16 (A and W from shared memory, float32
//   accumulators in registers), keeping one K step in flight, and frees a
//   stage (in every CTA of the cluster) as soon as the products reading it
//   have retired.
// - The epilogue (Epi: a float32 bias, fetched into registers while the
//   tile's products run; a bf16 residual or a float32 pre-activation read
//   at the output's own flat row; GELU / quick_gelu or its derivative) acts
//   on the float32 sums, rounds once to bf16 and stages the tile in shared
//   memory in the 128-byte swizzle, one 64 x 64 box per head or 64 columns
//   (no bank conflicts, no per-element address arithmetic); one thread
//   then writes each box with a TMA store (128 contiguous bytes per row),
//   one box per K step of the warpgroup's next tile, so the stores run
//   under its products. A float32 output (DIRECT epilogue) is written from
//   the registers instead, 32 contiguous bytes per quad of a warp, or, by a
//   staged one, from its row-order pass, 256 contiguous bytes per warp.
// Each output element is one thread's sum in a fixed order: no atomics, so
// two calls are bitwise equal.
//
// The tensor maps are encoded on the host by cuTensorMapEncodeTiled, reached
// through the runtime's cudaGetDriverEntryPointByVersion, so the library links
// against no libcuda; they reach the kernel as a __grid_constant__ parameter.

#pragma once

#include <type_traits>

#include "hopper.cuh"  // mbarriers, TMA, wgmma, the tensor-map encoder

namespace nx {
namespace hopper {

constexpr int BM = 128;  // tile rows: two consumer warpgroups of 64
constexpr int BK = 64;   // K step: 64 bf16 = 128 bytes, one swizzle row
constexpr int BOX = 64;  // output columns per TMA store box
constexpr int CONSUMERS = 2, THREADS = 128 * (CONSUMERS + 1);
constexpr int CLUSTER = 2;  // CTAs sharing one W tile

// A logical [B*N, cols] bf16 matrix as TMA sees it: map[0] = [B, N, cols]
// (row-major), or map[t] = [B, H, N, dh] for column segment t of H*dh
// (head-major)
struct TmaMatrix {
  CUtensorMap map[3];
  int head_major;
  int seg, dh;
};

// An epilogue on a pair of float32 sums at columns c, c + 1. The result is
// rounded once to bf16 and goes out through the TMA-store path, or, for a
// DIRECT epilogue, store(row, c, v) writes it itself to flat output row
// `row` (b * n_tok + n; a float32 output). Two kinds:
// - in registers (STAGED false): each thread applies apply(v, fetch(c)) to
//   its own sums, fully unrolled; fetch(c) runs at the start of the tile so
//   its loads land while the products run. For the cheap ones: a bias.
// - staged (STAGED true): the sums go, 64 columns at a time, through a
//   float32 stage in shared memory, and the warpgroup takes the box in row
//   order, 32 column pairs of a row per warp: first x = load(row, c) for
//   all 16 pairs a thread, row the flat output row or -1 past the sequence
//   (not to be read at; the loads of a row operand coalesce and are all in
//   flight together), then finish(v, x, c), which a DIRECT staged epilogue
//   then stores itself (a float32 output). Applied per register, with the
//   activation's code unrolled for every register pair, a bias + GELU
//   epilogue tripled the product's time (tools/epilogue_bench.cu, H100 80GB
//   HBM3 at 700 W).
struct NoEpilogue {
  static constexpr bool DIRECT = false, STAGED = false;
  __device__ __forceinline__ float2 fetch(int) const { return make_float2(0.f, 0.f); }
  __device__ __forceinline__ float2 apply(float2 v, float2) const { return v; }
};

__device__ __forceinline__ float2 fetch_bias(const float* bias, int c) {
  return bias ? __ldg(reinterpret_cast<const float2*>(bias + c)) : make_float2(0.f, 0.f);
}

// v += bias[c], bias[c + 1] (float32, [cols], 8-byte aligned; null: no bias)
struct BiasEpilogue {
  const float* bias;
  static constexpr bool DIRECT = false, STAGED = false;
  __device__ __forceinline__ float2 fetch(int c) const {
    return bias ? __ldg(reinterpret_cast<const float2*>(bias + c)) : make_float2(0.f, 0.f);
  }
  __device__ __forceinline__ float2 apply(float2 v, float2 b) const {
    return make_float2(v.x + b.x, v.y + b.y);
  }
};

__device__ __forceinline__ float2 pair_f32(float2 v) { return v; }
__device__ __forceinline__ float2 pair_f32(__nv_bfloat162 v) { return __bfloat1622float2(v); }

// v + bias[c] + res[row, c]: a residual [rows, ld] of type R (bf16, or
// float32: K1's residual stream) read at the output's own row, the sum
// float32 until its one rounding to bf16; staged. F32_OUT: the sum is not
// rounded but stored in float32 to out [rows, ld] from the staged pass
// (DIRECT), each warp writing 256 contiguous bytes of a row, in place of
// the bf16 TMA store
template <class R, bool F32_OUT>
struct ResidualEpilogue {
  const float* bias;
  const R* res;
  int ld;
  float* out;
  static constexpr bool DIRECT = F32_OUT, STAGED = true;
  using Row = typename std::conditional<std::is_same<R, float>::value, float2,
                                        __nv_bfloat162>::type;
  __device__ __forceinline__ Row load(long row, int c) const {
    return row < 0 ? Row{} : __ldg(reinterpret_cast<const Row*>(res + row * ld + c));
  }
  __device__ __forceinline__ float2 finish(float2 v, Row x, int c) const {
    const float2 b = fetch_bias(bias, c), r = pair_f32(x);
    return make_float2(v.x + b.x + r.x, v.y + b.y + r.y);
  }
  __device__ __forceinline__ void store(long row, int c, float2 v) const {
    *reinterpret_cast<float2*>(out + row * ld + c) = v;
  }
};

// K6's and K8's: a bf16 residual, the sum rounded to bf16
using BiasResidualEpilogue = ResidualEpilogue<__nv_bfloat16, false>;

// round(res[row, c] + round(v + bias[c])) for a bf16 residual res [rows,
// ld]: the bias-add rounded to bf16 before the residual is added, the sum
// rounded again by the bf16 store (MONA's up projection, K12, whose two
// rounding points ResidualEpilogue's one would not keep); staged
struct RoundResidualEpilogue {
  const float* bias;
  const __nv_bfloat16* res;
  int ld;
  static constexpr bool DIRECT = false, STAGED = true;
  using Row = __nv_bfloat162;
  __device__ __forceinline__ Row load(long row, int c) const {
    return row < 0 ? Row{} : __ldg(reinterpret_cast<const Row*>(res + row * ld + c));
  }
  __device__ __forceinline__ float2 finish(float2 v, Row x, int c) const {
    const float2 b = fetch_bias(bias, c);
    const float2 u = __bfloat1622float2(__float22bfloat162_rn(make_float2(v.x + b.x, v.y + b.y)));
    const float2 r = __bfloat1622float2(x);
    return make_float2(r.x + u.x, r.y + u.y);
  }
};

// act(v + bias[c]), ACT one of common.cuh's codes (GELU in its exact erf
// form, quick_gelu); staged
template <int ACT>
struct BiasActEpilogue {
  const float* bias;
  static constexpr bool DIRECT = false, STAGED = true;
  struct Row {};
  __device__ __forceinline__ Row load(long, int) const { return Row{}; }
  __device__ __forceinline__ float2 finish(float2 v, Row, int c) const {
    const float2 b = fetch_bias(bias, c);
    return make_float2(act_fwd(ACT, v.x + b.x), act_fwd(ACT, v.y + b.y));
  }
};

// v * act'(a[row, c]): the activation's derivative at a float32
// pre-activation a [rows, ld] (the backward's dpre); staged
template <int ACT>
struct ActGradEpilogue {
  const float* a;
  int ld;
  static constexpr bool DIRECT = false, STAGED = true;
  using Row = float2;
  __device__ __forceinline__ Row load(long row, int c) const {
    return row < 0 ? make_float2(0.f, 0.f)
                   : __ldg(reinterpret_cast<const float2*>(a + row * ld + c));
  }
  __device__ __forceinline__ float2 finish(float2 v, Row x, int) const {
    return make_float2(v.x * act_grad(ACT, x.x), v.y * act_grad(ACT, x.y));
  }
};

// v + bias[c] (null: none) stored in float32 to out [rows, ld] straight
// from registers: each quad of a warp writes 32 contiguous bytes of a row
struct StoreF32Epilogue {
  const float* bias;
  float* out;
  int ld;
  static constexpr bool DIRECT = true, STAGED = false;
  __device__ __forceinline__ float2 fetch(int c) const { return fetch_bias(bias, c); }
  __device__ __forceinline__ float2 apply(float2 v, float2 b) const {
    return make_float2(v.x + b.x, v.y + b.y);
  }
  __device__ __forceinline__ void store(long row, int c, float2 v) const {
    *reinterpret_cast<float2*>(out + row * ld + c) = v;
  }
};

template <class Epi>
struct Params {
  TmaMatrix a;    // A [B*N, K]: boxes of BK columns x BM rows
  CUtensorMap w;  // W [cols, K]: boxes of BK x BN / CLUSTER
  TmaMatrix out;  // out [B*N, cols]: boxes of BOX x 64 rows
  Epi epi;
  int n_tok, cols, k_steps, m_per_seq, m_tiles, n_tiles;
  int units;  // CLUSTER M tiles side by side x n_tiles
};

// The box holding the 64 logical columns from c (c % 64 == 0) of tokens
// n.. of sequence b: its map, number of dimensions and coordinates
__device__ __forceinline__ const CUtensorMap* locate(const TmaMatrix& t, int b, int n, int c,
                                                     int& dims, int (&co)[4]) {
  if (!t.head_major) {
    dims = 3;
    co[0] = c, co[1] = n, co[2] = b, co[3] = 0;
    return &t.map[0];
  }
  const int s = c / t.seg, cc = c - s * t.seg, h = cc / t.dh;
  dims = 4;
  co[0] = cc - h * t.dh, co[1] = n, co[2] = h, co[3] = b;
  return &t.map[s];
}

// the float32 stage of a staged epilogue: one 64 x 64 box of a consumer's
// sums, rows SLD floats apart (SLD % 32 == 8: a warp's eight rows of float2
// stores hit distinct banks, two wavefronts for its 256 bytes)
constexpr int SLD = 72;

// shared memory of one CTA (from a 1024-byte aligned base): the ring of A
// and W stages, each consumer's staged output tile, each consumer's float32
// stage (a staged epilogue only), the barriers
template <int BN, int STAGES, bool STAGED = false>
struct Layout {
  static constexpr int A_BYTES = BM * BK * 2, W_BYTES = BN * BK * 2, OUT_BYTES = 64 * BN * 2;
  static constexpr int STAGE_BYTES = STAGED ? 64 * SLD * 4 : 0;
  static constexpr int W_OFF = STAGES * A_BYTES;
  static constexpr int OUT_OFF = W_OFF + STAGES * W_BYTES;
  static constexpr int STAGE_OFF = OUT_OFF + CONSUMERS * OUT_BYTES;
  static constexpr int BAR_OFF = STAGE_OFF + CONSUMERS * STAGE_BYTES;
  static constexpr int BYTES = BAR_OFF + 2 * STAGES * 8 + 1024;  // + the alignment slack
  static_assert(BYTES <= 232448, "over the 227 KB a block may use");
};

template <int BN, int STAGES, class Epi>
__global__ void __launch_bounds__(THREADS, 1) gemm_kernel(const __grid_constant__ Params<Epi> p) {
  using L = Layout<BN, STAGES, Epi::STAGED>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* sa = base;
  unsigned char* sw = base + L::W_OFF;
  uint64_t* full = reinterpret_cast<uint64_t*>(base + L::BAR_OFF);
  uint64_t* empty = full + STAGES;
  const int wg = threadIdx.x / 128, t = threadIdx.x % 128;
  // the CTAs of a cluster take M tiles side by side with the same columns:
  // each loads its own A and 1/CLUSTER of the W tile, multicast to all
  const int rank = cluster_rank();
  const int first = blockIdx.x / CLUSTER, stride = gridDim.x / CLUSTER;
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], CONSUMERS * CLUSTER);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  cluster_sync();

  if (wg == CONSUMERS) {
    // producer: one thread keeps the ring full, tile after tile
    reg_dealloc<40>();
    if (t == 0) {
      int it = 0;
      for (int u = first; u < p.units; u += stride) {
        const int mt = (u / p.n_tiles) * CLUSTER + rank, col0 = (u % p.n_tiles) * BN;
        const int b = mt / p.m_per_seq, n0 = (mt - b * p.m_per_seq) * BM;  // b == B: zero fill
        for (int kt = 0; kt < p.k_steps; ++kt, ++it) {
          const int s = it % STAGES;
          mbar_wait(&empty[s], ((it / STAGES) & 1) ^ 1);
          mbar_expect_tx(&full[s], L::A_BYTES + L::W_BYTES);
          int dims, co[4];
          const CUtensorMap* am = locate(p.a, b, n0, kt * BK, dims, co);
          tma_load(sa + s * L::A_BYTES, am, &full[s], dims, co);
          tma_load_multicast(sw + s * L::W_BYTES + rank * (L::W_BYTES / CLUSTER), &p.w,
                             &full[s], (1 << CLUSTER) - 1, kt * BK, col0 + rank * (BN / CLUSTER));
        }
      }
      // before exiting, see every stage released by every consumer of the
      // cluster: no arrival or multicast then still targets this CTA
      for (int i = 0; i < STAGES; ++i, ++it)
        mbar_wait(&empty[it % STAGES], ((it / STAGES) & 1) ^ 1);
    }
  } else {
    // consumers: 64 rows of the tile each
    reg_alloc<232>();
    unsigned char* so = base + L::OUT_OFF + wg * L::OUT_BYTES;
    const int warp = t / 32, lane = t % 32;
    const int r = warp * 16 + lane / 4, swz = (lane / 4) & 7, quad = lane % 4;
    auto release = [&](int s) {
      if (t != 0) return;
      for (int c = 0; c < CLUSTER; ++c) mbar_arrive_cluster(&empty[s], c);
    };
    // the last tile's output boxes not yet stored (thread 0): one goes out
    // per K step of the next tile, so the stores spread over its products
    int out_b = 0, out_row = 0, out_col = 0, out_next = 0, out_end = 0;
    auto store_next = [&]() {
      int dims, co[4];
      const CUtensorMap* om = locate(p.out, out_b, out_row, out_col + out_next * BOX, dims, co);
      tma_store(om, so + out_next * (64 * 128), dims, co);
      bulk_commit();
      ++out_next;
    };
    float acc[BN / 2];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
    int it = 0;
    for (int u = first; u < p.units; u += stride) {
      const int mt = (u / p.n_tiles) * CLUSTER + rank, col0 = (u % p.n_tiles) * BN;
      const int b = mt / p.m_per_seq, n0 = (mt - b * p.m_per_seq) * BM;
      float2 pre[BN / 8];  // the epilogue's operands for columns col0 + 8j + 2 quad
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        const int c = col0 + j * 8 + 2 * quad;
        if constexpr (Epi::STAGED) pre[j] = make_float2(0.f, 0.f);  // unused
        else pre[j] = c < p.cols ? p.epi.fetch(c) : make_float2(0.f, 0.f);
      }
      for (int kt = 0; kt < p.k_steps; ++kt, ++it) {
        const int s = it % STAGES;
        mbar_wait(&full[s], (it / STAGES) & 1);
        const uint64_t da = smem_desc(sa + s * L::A_BYTES + wg * (64 * BK * 2));
        const uint64_t db = smem_desc(sw + s * L::W_BYTES);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk)  // +32 bytes along K inside the swizzled row
          wgmma_bf16<BN>(acc, da + 2 * kk, db + 2 * kk, (kt | kk) != 0);
        wgmma_commit();
        if (kt > 0) {  // the previous step's products have retired: free its stage
          wgmma_wait<1>();
          release((it - 1) % STAGES);
        }
        if (t == 0 && out_next < out_end) store_next();
      }
      wgmma_wait<0>();
      fence_regs(acc);
      release((it - 1) % STAGES);

      const int row0 = n0 + wg * 64;
      // uniform per warpgroup: a tile past the last one, or 64 rows past the sequence
      if (mt >= p.m_tiles || row0 >= p.n_tok) continue;
      const long seq0 = (long)b * p.n_tok;  // the sequence's first flat row
      if constexpr (Epi::DIRECT && !Epi::STAGED) {
        const bool lo = row0 + r < p.n_tok, hi = row0 + r + 8 < p.n_tok;
#pragma unroll
        for (int j = 0; j < BN / 8; ++j) {
          const int c = col0 + j * 8 + 2 * quad;
          if (c >= p.cols) continue;
          if (lo)
            p.epi.store(seq0 + row0 + r, c,
                        p.epi.apply(make_float2(acc[4 * j], acc[4 * j + 1]), pre[j]));
          if (hi)
            p.epi.store(seq0 + row0 + r + 8, c,
                        p.epi.apply(make_float2(acc[4 * j + 2], acc[4 * j + 3]), pre[j]));
        }
        continue;
      }
      if (t == 0) {
        while (out_next < out_end) store_next();
        bulk_wait_read();  // the last tile's stores have left the staging buffer
      }
      warpgroup_sync(wg);
      if constexpr (Epi::STAGED) {
        float* st = reinterpret_cast<float*>(base + L::STAGE_OFF + wg * L::STAGE_BYTES);
#pragma unroll
        for (int jb = 0; jb < BN / 64; ++jb) {
          const int c0 = col0 + jb * 64;
          if (c0 >= p.cols) break;  // uniform: a box past the last column
          // this thread's sums of box jb into the stage
#pragma unroll
          for (int jj = 0; jj < 8; ++jj) {
            const int j = jb * 8 + jj, cl = jj * 8 + 2 * quad;
            *reinterpret_cast<float2*>(st + r * SLD + cl) = make_float2(acc[4 * j], acc[4 * j + 1]);
            *reinterpret_cast<float2*>(st + (r + 8) * SLD + cl) =
                make_float2(acc[4 * j + 2], acc[4 * j + 3]);
          }
          warpgroup_sync(wg);
          // the box in row order: warp w takes rows w, w + 4, ..., its lane
          // column pair 2 * lane of each; every row operand's load first
          constexpr int PAIRS = 64 * 32 / 128;
          const int cp = 2 * (t & 31), c = c0 + cp;
          typename Epi::Row x[PAIRS];
#pragma unroll
          for (int i = 0; i < PAIRS; ++i) {
            const int rr = (t >> 5) + 4 * i;
            x[i] = p.epi.load(row0 + rr < p.n_tok ? seq0 + row0 + rr : -1, c);
          }
#pragma unroll
          for (int i = 0; i < PAIRS; ++i) {
            const int rr = (t >> 5) + 4 * i;
            const float2 v =
                p.epi.finish(*reinterpret_cast<const float2*>(st + rr * SLD + cp), x[i], c);
            if constexpr (Epi::DIRECT) {
              if (row0 + rr < p.n_tok) p.epi.store(seq0 + row0 + rr, c, v);
            } else {
              unsigned char* at =
                  so + jb * (64 * 128) + rr * 128 + (((cp >> 3) ^ (rr & 7)) << 4) + (cp & 7) * 2;
              *reinterpret_cast<__nv_bfloat162*>(at) = __float22bfloat162_rn(v);
            }
          }
          if constexpr (!Epi::DIRECT)
            asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // visible to TMA
          warpgroup_sync(wg);  // the stage is free, the box staged
        }
      } else {
#pragma unroll
        for (int j = 0; j < BN / 8; ++j) {
          const float2 lo = p.epi.apply(make_float2(acc[4 * j], acc[4 * j + 1]), pre[j]);
          const float2 hi = p.epi.apply(make_float2(acc[4 * j + 2], acc[4 * j + 3]), pre[j]);
          // box j / 8 (64 x 64), 16-byte chunk j % 8 of the row, swizzled by row % 8
          unsigned char* at = so + (j / 8) * (64 * 128) + (((j % 8) ^ swz) << 4) + quad * 4;
          *reinterpret_cast<__nv_bfloat162*>(at + r * 128) = __float22bfloat162_rn(lo);
          *reinterpret_cast<__nv_bfloat162*>(at + (r + 8) * 128) = __float22bfloat162_rn(hi);
        }
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // visible to TMA
        warpgroup_sync(wg);
      }
      if (t == 0 && !Epi::DIRECT) {  // a staged DIRECT epilogue has stored its tile
        out_b = b, out_row = row0, out_col = col0, out_next = 0;
        out_end = min(BN, p.cols - col0) / BOX;
      }
    }
    if (t == 0) {
      while (out_next < out_end) store_next();
      bulk_wait();
    }
  }
}

// ---------------------------------------------------------------------------
// Host side: tensor maps and the launch
// ---------------------------------------------------------------------------

// row-major [batch, n_tok, cols], rows ld elements apart (0: cols; TMA
// needs ld % 8 == 0 and p 16-byte aligned), read or written in boxes of 64
// columns x box_rows tokens
static cudaError_t rows_matrix(TmaMatrix& t, const void* p, int batch, int n_tok, int cols,
                               int box_rows, int ld = 0) {
  t = TmaMatrix{};
  t.head_major = 0, t.seg = cols, t.dh = cols;
  const cuuint64_t row = (cuuint64_t)(ld ? ld : cols) * 2;
  const cuuint64_t dims[3] = {(cuuint64_t)cols, (cuuint64_t)n_tok, (cuuint64_t)batch};
  const cuuint64_t strides[2] = {row, (cuuint64_t)n_tok * row};
  const cuuint32_t box[3] = {BOX, (cuuint32_t)box_rows, 1};
  return encode(t.map[0], p, 3, dims, strides, box);
}

// head-major: column segment s of H*dh at p[s] = [batch, heads, n_tok, dh],
// in boxes of 64 of a head's dh x box_rows tokens (dh % 64 == 0)
static cudaError_t heads_matrix(TmaMatrix& t, const void* p0, const void* p1, const void* p2,
                                int batch, int n_tok, int heads, int dh, int box_rows) {
  t = TmaMatrix{};
  t.head_major = 1, t.seg = heads * dh, t.dh = dh;
  const cuuint64_t dims[4] = {(cuuint64_t)dh, (cuuint64_t)n_tok, (cuuint64_t)heads,
                              (cuuint64_t)batch};
  const cuuint64_t strides[3] = {(cuuint64_t)dh * 2, (cuuint64_t)n_tok * dh * 2,
                                 (cuuint64_t)heads * n_tok * dh * 2};
  const cuuint32_t box[4] = {BOX, (cuuint32_t)box_rows, 1, 1};
  const void* ptrs[3] = {p0, p1, p2};
  for (int s = 0; s < 3; ++s) {
    const cudaError_t err = encode(t.map[s], ptrs[s], 4, dims, strides, box);
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

// out[B*N, cols] = epi(A @ W^T) in bf16: A and out as TmaMatrix (A's boxes
// BM tokens, out's 64; a DIRECT epilogue writes its own output and `out` is
// unused), W [cols, K] bf16 row-major (K-major for the product); needs
// K % 64 == 0, cols % 64 == 0 and, head-major, dh % 64 == 0. BN columns per
// tile, STAGES in the ring.
template <int BN, int STAGES, class Epi>
static cudaError_t gemm(const TmaMatrix& a, const void* w, const TmaMatrix& out, Epi epi,
                        int batch, int n_tok, int cols, int k, cudaStream_t s) {
  static_assert(BN % (8 * CLUSTER) == 0 && (BN / CLUSTER) * BK * 2 % 1024 == 0,
                "each CTA's share of the W tile is whole swizzle atoms");
  if (k % BK || cols % BOX || (a.head_major && a.dh % BOX) || (out.head_major && out.dh % BOX))
    return cudaErrorInvalidValue;
  Params<Epi> p;
  p.a = a, p.out = out, p.epi = epi;
  const cuuint64_t dims[2] = {(cuuint64_t)k, (cuuint64_t)cols};
  const cuuint64_t strides[1] = {(cuuint64_t)k * 2};
  const cuuint32_t box[2] = {BK, BN / CLUSTER};
  cudaError_t err = encode(p.w, w, 2, dims, strides, box);
  if (err != cudaSuccess) return err;
  p.n_tok = n_tok, p.cols = cols, p.k_steps = k / BK;
  p.m_per_seq = (n_tok + BM - 1) / BM, p.m_tiles = batch * p.m_per_seq;
  p.n_tiles = (cols + BN - 1) / BN;
  p.units = (p.m_tiles + CLUSTER - 1) / CLUSTER * p.n_tiles;
  if (p.units == 0) return cudaSuccess;

  // once per device: the shared-memory opt-in and how many clusters fit at
  // once (the persistent grid)
  constexpr int smem = Layout<BN, STAGES, Epi::STAGED>::BYTES;
  const void* kernel = reinterpret_cast<const void*>(gemm_kernel<BN, STAGES, Epi>);
  static int resident[64] = {};
  int dev = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = CLUSTER, attr[0].val.clusterDim.y = 1, attr[0].val.clusterDim.z = 1;
  cfg.blockDim = dim3(THREADS), cfg.dynamicSmemBytes = smem, cfg.stream = s;
  cfg.attrs = attr, cfg.numAttrs = 1;
  if (dev >= 64) return cudaErrorInvalidDevice;
  if (!resident[dev]) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    cfg.gridDim = dim3(CLUSTER * 1024);
    int clusters = 0;
    err = cudaOccupancyMaxActiveClusters(&clusters, kernel, &cfg);
    if (err != cudaSuccess) return err;
    if (clusters < 1) return cudaErrorInvalidConfiguration;
    resident[dev] = clusters;
  }
  cfg.gridDim = dim3(CLUSTER * (p.units < resident[dev] ? p.units : resident[dev]));
  void* args[] = {&p};
  err = cudaLaunchKernelExC(&cfg, kernel, args);
  return err != cudaSuccess ? err : cudaGetLastError();
}

}  // namespace hopper
}  // namespace nx
