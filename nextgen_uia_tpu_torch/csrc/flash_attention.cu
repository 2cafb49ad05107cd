// Attention forward for long sequences, for Hopper (sm_90a):
//
//   o = softmax(q k^T * scale + bias[b, key] (+ causal mask)) v
//
// with float32 scores, softmax statistics and output sums, the output
// rounded to the input type. q, k, v and o are addressed through element
// strides (batch, head, token; the head dim is contiguous), so one kernel
// reads the [B, H, N, dh] and the [B, N, H, dh] layouts, and the q|k|v
// columns of a packed [B, N, 3, H, dh] projection, without a copy.
//
// Replaces nextgen_uia_tpu/ops/flash_attention.py::flash_attention, forward:
// the Pallas kernel _fwd_kernel (pallas_call in _flash_fwd_impl). The TPU
// kernel holds one head's whole [Np, Np] f32 score block in VMEM (7.6 MB at
// DINOv2's 1370 tokens); a Hopper block has 227 KB, and the 1370-token K and
// V of one head alone are 351 KB in bf16. So this is a KV-tiled
// online-softmax (flash) kernel: a CTA takes 64 queries of one (b, h) and
// streams 64-key K/V tiles through a double-buffered cp.async ring, keeping
// each row's running max, exp-sum and f32 output accumulator. Keys past N
// are zero-filled and masked in-kernel (the JAX wrapper pads N to a multiple
// of 16 instead); with `causal` the tiles wholly above a CTA's diagonal are
// skipped. Masking follows the JAX kernel: masked scores are -1e30, the key
// bias is added after the padding mask, the causal mask after the bias.
//
// bf16: both products on tensor cores (mma.sync m16n8k16, f32 accumulate,
// operands from shared memory by ldmatrix); 4 warps, each owning 16 query
// rows, with S, P (rounded to bf16, as the JAX kernel rounds P before P v)
// and the f32 output accumulator in registers. float32: the tensor cores
// have no f32 product, so a SIMT variant (8 warps x 4 query rows, keys per
// lane) keeps the f32 path exact for the checks.
//
// What bounds it on the H100: at DINOv2-B/14's 518 px shape [24, 12, 1370,
// 64] the two products are 4 * B * H * N^2 * dh = 138.4 GFLOP per call, 0.140
// ms at the 989 TFLOP/s bf16 peak; the bytes (q, k, v, o once: 202 MB) would
// take 0.060 ms. So operations bound it. A first version with WMMA fragments
// sent S, P and O through shared memory each tile and ran at ~40 TFLOP/s;
// keeping them in registers is this version; wgmma and a producer warp
// feeding TMA loads are the later steps.

#include <cfloat>


#include "block_kernels.cuh"

using namespace nx;

namespace {

constexpr float NEG = -1e30f;

struct Out {
  void* o;
  int sb, sh, sn;
};

// ---------------------------------------------------------------------------
// bf16 tensor-core path, head dim 64: mma.sync m16n8k16 with the score,
// probability and output tiles in registers (the FlashAttention-2 layout)
// ---------------------------------------------------------------------------

constexpr int FQ = 64, FK = 64, FD = 64, FWARPS = 4, FTHREADS = FWARPS * 32;
constexpr int TLD = FD + 8;  // bf16 row stride of the Q, K and V tiles: 144 B, so the
                             // 8 rows an ldmatrix reads fall in distinct banks
constexpr int TILE = 64 * TLD;  // elements of one tile
constexpr int FLASH_SMEM = 5 * TILE * 2;  // Q, and K and V double-buffered

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldmatrix_x4(unsigned (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(unsigned (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

// d[16x8] += a[16x16] b[16x8], bf16 inputs, f32 accumulators
__device__ __forceinline__ void mma_bf16(float (&d)[4], const unsigned (&a)[4], unsigned b0,
                                         unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<unsigned*>(&v);
}

// one [64, 64] bf16 tile of rows row0.. of q, k or v into shared memory
// (row stride TLD); rows >= n are zero-filled
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst, const __nv_bfloat16* base,
                                          int sn, int row0, int n, int tid) {
#pragma unroll
  for (int c = tid; c < 64 * 8; c += FTHREADS) {
    const int r = c / 8, col = (c % 8) * 8, gr = row0 + r;
    cp_async16(dst + r * TLD + col, base + (size_t)(gr < n ? gr : 0) * sn + col, gr < n);
  }
}

// Each warp owns 16 query rows. In the m16n8k16 fragments a lane holds rows
// g = lane / 4 and g + 8 and, of each 8-column tile, columns 2 * (lane % 4)
// and +1: so a lane keeps the running max and exp-sum of two rows (the sum
// as its own partial, reduced over the lane quad at the end), and the score
// tile's accumulators are, repacked to bf16, the A operand of P V.
__global__ void __launch_bounds__(FTHREADS)
flash_fwd_bf16(QKV in, Out out, const float* __restrict__ bias, float* __restrict__ lse, int n,
               int causal, float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* Ks = Qs + TILE;      // [2][64][TLD]
  __nv_bfloat16* Vs = Ks + 2 * TILE;  // [2][64][TLD]

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t4 = lane % 4;
  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * FQ;
  const size_t off = (size_t)b * in.sb + (size_t)h * in.sh;
  const __nv_bfloat16* qb = static_cast<const __nv_bfloat16*>(in.q) + off;
  const __nv_bfloat16* kb = static_cast<const __nv_bfloat16*>(in.k) + off;
  const __nv_bfloat16* vb = static_cast<const __nv_bfloat16*>(in.v) + off;
  const float* brow = bias ? bias + (size_t)b * n : nullptr;
  const int row0 = q0 + warp * 16 + g;  // this lane's rows: row0 and row0 + 8

  int n_tiles = (n + FK - 1) / FK;
  if (causal) n_tiles = min(n_tiles, (q0 + FQ - 1) / FK + 1);

  load_tile(Qs, qb, in.sn, q0, n, tid);
  load_tile(Ks, kb, in.sn, 0, n, tid);
  load_tile(Vs, vb, in.sn, 0, n, tid);
  cp_async_commit();

  unsigned qa[FD / 16][4];
  float o[FD / 8][4];
#pragma unroll
  for (int j = 0; j < FD / 8; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
  float m_run[2] = {-INFINITY, -INFINITY}, l_part[2] = {0.f, 0.f};

  for (int t = 0; t < n_tiles; ++t) {
    const int buf = t % 2;
    if (t + 1 < n_tiles) {  // the other buffer was freed by the barrier ending t - 1
      load_tile(Ks + (1 - buf) * TILE, kb, in.sn, (t + 1) * FK, n, tid);
      load_tile(Vs + (1 - buf) * TILE, vb, in.sn, (t + 1) * FK, n, tid);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (t == 0) {
#pragma unroll
      for (int kk = 0; kk < FD / 16; ++kk)
        ldmatrix_x4(qa[kk], Qs + (warp * 16 + lane % 16) * TLD + kk * 16 + (lane / 16) * 8);
    }
    const __nv_bfloat16* Kt = Ks + buf * TILE;
    const __nv_bfloat16* Vt = Vs + buf * TILE;

    // S = Q K^T: 8 column tiles of 8 keys; K's rows are the B operand's
    // columns, so a plain ldmatrix of K rows gives the "col" fragment
    float s[FK / 8][4];
#pragma unroll
    for (int j = 0; j < FK / 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < FD / 16; ++kk) {
#pragma unroll
      for (int np = 0; np < FK / 16; ++np) {
        unsigned kf[4];  // keys np*16 + 0..7 (d lo, d hi), then + 8..15
        ldmatrix_x4(kf, Kt + (np * 16 + (lane / 16) * 8 + lane % 8) * TLD + kk * 16 +
                            ((lane / 8) % 2) * 8);
        mma_bf16(s[2 * np], qa[kk], kf[0], kf[1]);
        mma_bf16(s[2 * np + 1], qa[kk], kf[2], kf[3]);
      }
    }

    // scale and mask, then the online softmax of rows row0 (e = 0, 1) and
    // row0 + 8 (e = 2, 3)
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < FK / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = t * FK + j * 8 + 2 * t4 + (e & 1), row = row0 + (e / 2) * 8;
        float v = s[j][e] * scale;
        if (key >= n) v = NEG;
        else if (brow) v += brow[key];
        if (causal && key > row) v = NEG;
        s[j][e] = v;
        mx[e / 2] = fmaxf(mx[e / 2], v);
      }
    }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m_run[r], mx[r]);
      alpha[r] = expf(m_run[r] - m_new);
      m_run[r] = m_new;
      l_part[r] *= alpha[r];
    }
#pragma unroll
    for (int j = 0; j < FK / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[j][e] = expf(s[j][e] - m_run[e / 2]);
        l_part[e / 2] += s[j][e];
      }
    }
#pragma unroll
    for (int j = 0; j < FD / 8; ++j) {
      o[j][0] *= alpha[0];
      o[j][1] *= alpha[0];
      o[j][2] *= alpha[1];
      o[j][3] *= alpha[1];
    }

    // O += P V: P from the score accumulators (bf16, as the JAX kernel rounds
    // P before P v); V's rows are keys, so ldmatrix.trans gives its fragment
#pragma unroll
    for (int kk = 0; kk < FK / 16; ++kk) {
      const unsigned pa[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                              pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                              pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                              pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int dp = 0; dp < FD / 16; ++dp) {
        unsigned vf[4];  // d dp*16 + 0..7 (keys lo, keys hi), then + 8..15
        ldmatrix_x4_trans(vf, Vt + (kk * 16 + ((lane / 8) % 2) * 8 + lane % 8) * TLD +
                                  dp * 16 + (lane / 16) * 8);
        mma_bf16(o[2 * dp], pa, vf[0], vf[1]);
        mma_bf16(o[2 * dp + 1], pa, vf[2], vf[3]);
      }
    }
    __syncthreads();  // every warp is done with this K/V buffer
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float l = l_part[r];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const int row = row0 + r * 8;
    if (row >= n) continue;
    if (lse && t4 == 0) lse[((size_t)b * gridDim.y + h) * n + row] = m_run[r] + logf(l);
    const float inv = 1.f / l;
    __nv_bfloat16* orow = static_cast<__nv_bfloat16*>(out.o) + (size_t)b * out.sb +
                          (size_t)h * out.sh + (size_t)row * out.sn;
#pragma unroll
    for (int j = 0; j < FD / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(orow + j * 8 + 2 * t4) =
          __floats2bfloat162_rn(o[j][2 * r] * inv, o[j][2 * r + 1] * inv);
  }
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
// Backward. The TPU kernel (_bwd_kernel) recomputes one head's whole score
// block in VMEM; here P is recomputed tile by tile from the row
// log-sum-exp the forward saved, P = exp(s - lse), with the forward's
// masking order (-1e30 past N, then the key bias, then causal). With
// D = rowsum(dO * O) (one small pass, `flash_bwd_delta`):
//
//   dV = round(P)^T dO,  dP = dO V^T,  ds_raw = P * (dP - D),
//   dS = round(ds_raw * scale),  dQ = dS K,  dK = dS^T Q,
//   dbias[b, key] = sum over heads and queries of ds_raw.
//
// D equals the TPU kernel's rowsum(dP * P) up to the rounding of O to the
// input type (O = P V is stored rounded), a relative difference of about
// one rounding step of O (2^-9 in bf16, 2^-24 in float32). Two kernels and
// no atomics on dQ/dK/dV, so the result is deterministic: one CTA per
// 64-key tile loops over the query tiles accumulating dK and dV in
// registers (with `causal` it starts at the diagonal), one CTA per 64-query
// tile loops over the key tiles accumulating dQ (with `causal` it stops at
// the diagonal). dbias, when asked for, is each key's column sum of ds_raw,
// added over heads into a float32 [B, N] with atomics.
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

// bf16: one CTA per 64-key tile, 4 warps of 16 keys; K and V of the tile in
// registers as A fragments, Q and dO tiles (queries) streamed through a
// double-buffered cp.async ring with their lse and D. S^T = K Q^T and
// dP^T = V dO^T come out in the accumulator layout, which repacked to bf16
// is the A fragment of dV += P^T dO and dK += dS^T Q.
__global__ void __launch_bounds__(FTHREADS)
flash_bwd_dkdv_bf16(QKV in, Out og, const __nv_bfloat16* __restrict__ g,
                    const float* __restrict__ lse, const float* __restrict__ delta,
                    const float* __restrict__ bias, Grads out, int n, int causal, float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* Ks = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* Vs = Ks + TILE;
  __nv_bfloat16* Qs = Vs + TILE;      // [2][64][TLD]
  __nv_bfloat16* Gs = Qs + 2 * TILE;  // [2][64][TLD]
  float* Ls = reinterpret_cast<float*>(Gs + 2 * TILE);  // [2][64]
  float* Ds = Ls + 2 * FQ;                                // [2][64]

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g8 = lane / 4, t4 = lane % 4;
  const int b = blockIdx.z, h = blockIdx.y, k0 = blockIdx.x * FK;
  const size_t off = (size_t)b * in.sb + (size_t)h * in.sh;
  const size_t goff = (size_t)b * og.sb + (size_t)h * og.sh;
  const __nv_bfloat16* qb = static_cast<const __nv_bfloat16*>(in.q) + off;
  const __nv_bfloat16* kb = static_cast<const __nv_bfloat16*>(in.k) + off;
  const __nv_bfloat16* vb = static_cast<const __nv_bfloat16*>(in.v) + off;
  const __nv_bfloat16* gb = g + goff;
  const size_t rows_off = ((size_t)b * gridDim.y + h) * n;
  const float* brow = bias ? bias + (size_t)b * n : nullptr;
  const int key0 = k0 + warp * 16 + g8;  // this lane's keys: key0 and key0 + 8

  const int t_begin = causal ? blockIdx.x : 0;  // query tiles wholly above the diagonal
  const int n_tiles = (n + FQ - 1) / FQ;

  auto stage = [&](int t, int buf) {
    load_tile(Qs + buf * TILE, qb, in.sn, t * FQ, n, tid);
    load_tile(Gs + buf * TILE, gb, og.sn, t * FQ, n, tid);
    if (tid < FQ) {
      const int r = t * FQ + tid;
      Ls[buf * FQ + tid] = r < n ? lse[rows_off + r] : 0.f;
      Ds[buf * FQ + tid] = r < n ? delta[rows_off + r] : 0.f;
    }
  };

  load_tile(Ks, kb, in.sn, k0, n, tid);
  load_tile(Vs, vb, in.sn, k0, n, tid);
  if (t_begin < n_tiles) stage(t_begin, 0);
  cp_async_commit();

  unsigned ka[FD / 16][4], va[FD / 16][4];
  float dk[FD / 8][4], dv[FD / 8][4], db[2] = {0.f, 0.f};
#pragma unroll
  for (int j = 0; j < FD / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[j][e] = dv[j][e] = 0.f;

  for (int t = t_begin; t < n_tiles; ++t) {
    const int buf = (t - t_begin) % 2;
    if (t + 1 < n_tiles) {  // the other buffer was freed by the barrier ending t - 1
      stage(t + 1, 1 - buf);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (t == t_begin) {
#pragma unroll
      for (int kk = 0; kk < FD / 16; ++kk) {
        ldmatrix_x4(ka[kk], Ks + (warp * 16 + lane % 16) * TLD + kk * 16 + (lane / 16) * 8);
        ldmatrix_x4(va[kk], Vs + (warp * 16 + lane % 16) * TLD + kk * 16 + (lane / 16) * 8);
      }
    }
    const __nv_bfloat16* Qt = Qs + buf * TILE;
    const __nv_bfloat16* Gt = Gs + buf * TILE;
    const float* lt = Ls + buf * FQ;
    const float* dt = Ds + buf * FQ;

    // S^T = K Q^T and dP^T = V dO^T: 8 column tiles of 8 queries each
    float s[FQ / 8][4], dp[FQ / 8][4];
#pragma unroll
    for (int j = 0; j < FQ / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < FD / 16; ++kk) {
#pragma unroll
      for (int np = 0; np < FQ / 16; ++np) {
        const int r = (np * 16 + (lane / 16) * 8 + lane % 8) * TLD + kk * 16 + ((lane / 8) % 2) * 8;
        unsigned qf[4], gf[4];
        ldmatrix_x4(qf, Qt + r);
        ldmatrix_x4(gf, Gt + r);
        mma_bf16(s[2 * np], ka[kk], qf[0], qf[1]);
        mma_bf16(s[2 * np + 1], ka[kk], qf[2], qf[3]);
        mma_bf16(dp[2 * np], va[kk], gf[0], gf[1]);
        mma_bf16(dp[2 * np + 1], va[kk], gf[2], gf[3]);
      }
    }
    // P^T and dS^T of this lane's keys (e / 2) and queries (column)
#pragma unroll
    for (int j = 0; j < FQ / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = j * 8 + 2 * t4 + (e & 1), row = t * FQ + col, key = key0 + (e / 2) * 8;
        const float v = masked_score(s[j][e], scale, key, row, n, brow, causal);
        const float p = row < n ? expf(v - lt[col]) : 0.f;
        const float ds_raw = p * (dp[j][e] - dt[col]);
        db[e / 2] += ds_raw;
        s[j][e] = p;
        dp[j][e] = ds_raw * scale;
      }
    }
    // dV += round(P)^T dO and dK += round(dS)^T Q; queries are the k dim,
    // so ldmatrix.trans of the dO and Q rows gives the B fragments
#pragma unroll
    for (int kk = 0; kk < FQ / 16; ++kk) {
      const unsigned pa[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                              pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                              pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                              pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
      const unsigned sa[4] = {pack_bf16(dp[2 * kk][0], dp[2 * kk][1]),
                              pack_bf16(dp[2 * kk][2], dp[2 * kk][3]),
                              pack_bf16(dp[2 * kk + 1][0], dp[2 * kk + 1][1]),
                              pack_bf16(dp[2 * kk + 1][2], dp[2 * kk + 1][3])};
#pragma unroll
      for (int dq = 0; dq < FD / 16; ++dq) {
        const int r = (kk * 16 + ((lane / 8) % 2) * 8 + lane % 8) * TLD + dq * 16 + (lane / 16) * 8;
        unsigned gf[4], qf[4];
        ldmatrix_x4_trans(gf, Gt + r);
        ldmatrix_x4_trans(qf, Qt + r);
        mma_bf16(dv[2 * dq], pa, gf[0], gf[1]);
        mma_bf16(dv[2 * dq + 1], pa, gf[2], gf[3]);
        mma_bf16(dk[2 * dq], sa, qf[0], qf[1]);
        mma_bf16(dk[2 * dq + 1], sa, qf[2], qf[3]);
      }
    }
    __syncthreads();  // every warp is done with this Q/dO buffer
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = key0 + r * 8;
    float d = db[r];
    d += __shfl_xor_sync(0xffffffffu, d, 1);
    d += __shfl_xor_sync(0xffffffffu, d, 2);
    if (key >= n) continue;
    if (out.dbias && t4 == 0) atomicAdd(out.dbias + (size_t)b * n + key, d);
    const size_t o = goff + (size_t)key * og.sn;
    __nv_bfloat16* dkr = static_cast<__nv_bfloat16*>(out.dk) + o;
    __nv_bfloat16* dvr = static_cast<__nv_bfloat16*>(out.dv) + o;
#pragma unroll
    for (int j = 0; j < FD / 8; ++j) {
      *reinterpret_cast<__nv_bfloat162*>(dkr + j * 8 + 2 * t4) =
          __floats2bfloat162_rn(dk[j][2 * r], dk[j][2 * r + 1]);
      *reinterpret_cast<__nv_bfloat162*>(dvr + j * 8 + 2 * t4) =
          __floats2bfloat162_rn(dv[j][2 * r], dv[j][2 * r + 1]);
    }
  }
}

// bf16: one CTA per 64-query tile, 4 warps of 16 queries; Q and dO in
// registers, K and V tiles streamed as in the forward. S = Q K^T and
// dP = dO V^T; dS repacked to bf16 is the A fragment of dQ += dS K.
__global__ void __launch_bounds__(FTHREADS)
flash_bwd_dq_bf16(QKV in, Out og, const __nv_bfloat16* __restrict__ g,
                  const float* __restrict__ lse, const float* __restrict__ delta,
                  const float* __restrict__ bias, Grads out, int n, int causal, float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* Gs = Qs + TILE;
  __nv_bfloat16* Ks = Gs + TILE;      // [2][64][TLD]
  __nv_bfloat16* Vs = Ks + 2 * TILE;  // [2][64][TLD]

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g8 = lane / 4, t4 = lane % 4;
  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * FQ;
  const size_t off = (size_t)b * in.sb + (size_t)h * in.sh;
  const size_t goff = (size_t)b * og.sb + (size_t)h * og.sh;
  const __nv_bfloat16* qb = static_cast<const __nv_bfloat16*>(in.q) + off;
  const __nv_bfloat16* kb = static_cast<const __nv_bfloat16*>(in.k) + off;
  const __nv_bfloat16* vb = static_cast<const __nv_bfloat16*>(in.v) + off;
  const __nv_bfloat16* gb = g + goff;
  const size_t rows_off = ((size_t)b * gridDim.y + h) * n;
  const float* brow = bias ? bias + (size_t)b * n : nullptr;
  const int row0 = q0 + warp * 16 + g8;  // this lane's rows: row0 and row0 + 8
  float l_row[2], d_row[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + r * 8;
    l_row[r] = row < n ? lse[rows_off + row] : 0.f;
    d_row[r] = row < n ? delta[rows_off + row] : 0.f;
  }

  int n_tiles = (n + FK - 1) / FK;
  if (causal) n_tiles = min(n_tiles, (q0 + FQ - 1) / FK + 1);

  load_tile(Qs, qb, in.sn, q0, n, tid);
  load_tile(Gs, gb, og.sn, q0, n, tid);
  load_tile(Ks, kb, in.sn, 0, n, tid);
  load_tile(Vs, vb, in.sn, 0, n, tid);
  cp_async_commit();

  unsigned qa[FD / 16][4], ga[FD / 16][4];
  float dq[FD / 8][4];
#pragma unroll
  for (int j = 0; j < FD / 8; ++j) dq[j][0] = dq[j][1] = dq[j][2] = dq[j][3] = 0.f;

  for (int t = 0; t < n_tiles; ++t) {
    const int buf = t % 2;
    if (t + 1 < n_tiles) {
      load_tile(Ks + (1 - buf) * TILE, kb, in.sn, (t + 1) * FK, n, tid);
      load_tile(Vs + (1 - buf) * TILE, vb, in.sn, (t + 1) * FK, n, tid);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (t == 0) {
#pragma unroll
      for (int kk = 0; kk < FD / 16; ++kk) {
        ldmatrix_x4(qa[kk], Qs + (warp * 16 + lane % 16) * TLD + kk * 16 + (lane / 16) * 8);
        ldmatrix_x4(ga[kk], Gs + (warp * 16 + lane % 16) * TLD + kk * 16 + (lane / 16) * 8);
      }
    }
    const __nv_bfloat16* Kt = Ks + buf * TILE;
    const __nv_bfloat16* Vt = Vs + buf * TILE;

    float s[FK / 8][4], dp[FK / 8][4];
#pragma unroll
    for (int j = 0; j < FK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < FD / 16; ++kk) {
#pragma unroll
      for (int np = 0; np < FK / 16; ++np) {
        const int r = (np * 16 + (lane / 16) * 8 + lane % 8) * TLD + kk * 16 + ((lane / 8) % 2) * 8;
        unsigned kf[4], vf[4];
        ldmatrix_x4(kf, Kt + r);
        ldmatrix_x4(vf, Vt + r);
        mma_bf16(s[2 * np], qa[kk], kf[0], kf[1]);
        mma_bf16(s[2 * np + 1], qa[kk], kf[2], kf[3]);
        mma_bf16(dp[2 * np], ga[kk], vf[0], vf[1]);
        mma_bf16(dp[2 * np + 1], ga[kk], vf[2], vf[3]);
      }
    }
#pragma unroll
    for (int j = 0; j < FK / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = t * FK + j * 8 + 2 * t4 + (e & 1), row = row0 + (e / 2) * 8;
        const float v = masked_score(s[j][e], scale, key, row, n, brow, causal);
        const float p = row < n ? expf(v - l_row[e / 2]) : 0.f;
        dp[j][e] = p * (dp[j][e] - d_row[e / 2]) * scale;
      }
    }
    // dQ += round(dS) K; keys are the k dim: ldmatrix.trans of the K rows
#pragma unroll
    for (int kk = 0; kk < FK / 16; ++kk) {
      const unsigned sa[4] = {pack_bf16(dp[2 * kk][0], dp[2 * kk][1]),
                              pack_bf16(dp[2 * kk][2], dp[2 * kk][3]),
                              pack_bf16(dp[2 * kk + 1][0], dp[2 * kk + 1][1]),
                              pack_bf16(dp[2 * kk + 1][2], dp[2 * kk + 1][3])};
#pragma unroll
      for (int dd = 0; dd < FD / 16; ++dd) {
        unsigned kf[4];
        ldmatrix_x4_trans(kf, Kt + (kk * 16 + ((lane / 8) % 2) * 8 + lane % 8) * TLD +
                                  dd * 16 + (lane / 16) * 8);
        mma_bf16(dq[2 * dd], sa, kf[0], kf[1]);
        mma_bf16(dq[2 * dd + 1], sa, kf[2], kf[3]);
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + r * 8;
    if (row >= n) continue;
    __nv_bfloat16* dqr = static_cast<__nv_bfloat16*>(out.dq) + goff + (size_t)row * og.sn;
#pragma unroll
    for (int j = 0; j < FD / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(dqr + j * 8 + 2 * t4) =
          __floats2bfloat162_rn(dq[j][2 * r], dq[j][2 * r + 1]);
  }
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

constexpr int BWD_BF16_SMEM = 6 * TILE * 2 + 4 * FQ * (int)sizeof(float);
}  // namespace

extern "C" {

// q, k, v at base + b*sb + h*sh + n*sn + d (element strides, d contiguous),
// o at its own strides; bias [B, N] f32 or null; lse [B, H, N] f32 (each
// row's log-sum-exp of its masked, scaled scores, for the backward) or null;
// dtype 0 float32, 1 bf16.
// bf16 needs dh == 64 and 16-byte aligned rows (strides % 8 == 0); float32
// needs dh <= 64.
int nx_flash_attention(const void* q, const void* k, const void* v, void* o, const float* bias,
                       float* lse, int dtype, int b, int heads, int n, int dh, int sb, int sh,
                       int sn, int osb, int osh, int osn, int causal, float scale,
                       void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (b < 1 || heads < 1 || n < 1 || b > 65535 || heads > 65535)
    return (int)cudaErrorInvalidValue;
  const QKV in{q, k, v, sb, sh, sn};
  const Out out{o, osb, osh, osn};
  if (dtype == BF16) {
    if (dh != FD || sb % 8 || sh % 8 || sn % 8) return (int)cudaErrorInvalidValue;
    const cudaError_t err = cudaFuncSetAttribute(
        flash_fwd_bf16, cudaFuncAttributeMaxDynamicSharedMemorySize, FLASH_SMEM);
    if (err != cudaSuccess) return (int)err;
    const dim3 grid((n + FQ - 1) / FQ, heads, b);
    flash_fwd_bf16<<<grid, FTHREADS, FLASH_SMEM, s>>>(in, out, bias, lse, n, causal, scale);
  } else if (dtype == F32) {
    if (dh < 1 || dh > 64) return (int)cudaErrorInvalidValue;
    const size_t smem = simt_smem(dh);
    const cudaError_t err = cudaFuncSetAttribute(
        flash_fwd_simt<float>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    const dim3 grid((n + S_QTILE - 1) / S_QTILE, heads, b);
    flash_fwd_simt<float><<<grid, S_THREADS, smem, s>>>(in, out, bias, lse, n, dh, causal,
                                                         scale);
  } else {
    return (int)cudaErrorInvalidValue;
  }
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
    if (dh != FD || sb % 8 || sh % 8 || sn % 8 || osb % 8 || osh % 8 || osn % 8)
      return (int)cudaErrorInvalidValue;
    flash_bwd_delta<__nv_bfloat16><<<rows_grid, 256, 0, s>>>(og, g, delta, n, dh);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    const auto* gg = static_cast<const __nv_bfloat16*>(g);
    const dim3 grid((n + FQ - 1) / FQ, heads, b);
    if ((err = cudaFuncSetAttribute(flash_bwd_dkdv_bf16,
                                    cudaFuncAttributeMaxDynamicSharedMemorySize,
                                    BWD_BF16_SMEM)) != cudaSuccess)
      return (int)err;
    flash_bwd_dkdv_bf16<<<grid, FTHREADS, BWD_BF16_SMEM, s>>>(in, og, gg, lse, delta, bias,
                                                              out, n, causal, scale);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    if ((err = cudaFuncSetAttribute(flash_bwd_dq_bf16,
                                    cudaFuncAttributeMaxDynamicSharedMemorySize,
                                    BWD_BF16_SMEM)) != cudaSuccess)
      return (int)err;
    flash_bwd_dq_bf16<<<grid, FTHREADS, BWD_BF16_SMEM, s>>>(in, og, gg, lse, delta, bias, out,
                                                            n, causal, scale);
  } else if (dtype == F32) {
    if (dh < 1 || dh > 64) return (int)cudaErrorInvalidValue;
    flash_bwd_delta<float><<<rows_grid, 256, 0, s>>>(og, g, delta, n, dh);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    const auto* gg = static_cast<const float*>(g);
    const size_t smem = simt_bwd_smem(dh);
    const dim3 grid((n + S_QTILE - 1) / S_QTILE, heads, b);
    if ((err = cudaFuncSetAttribute(flash_bwd_dkdv_simt<float>,
                                    cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem)) !=
        cudaSuccess)
      return (int)err;
    flash_bwd_dkdv_simt<float><<<grid, S_THREADS, smem, s>>>(in, og, gg, lse, delta, bias, out,
                                                             n, dh, causal, scale);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    if ((err = cudaFuncSetAttribute(flash_bwd_dq_simt<float>,
                                    cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem)) !=
        cudaSuccess)
      return (int)err;
    flash_bwd_dq_simt<float><<<grid, S_THREADS, smem, s>>>(in, og, gg, lse, delta, bias, out,
                                                           n, dh, causal, scale);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
