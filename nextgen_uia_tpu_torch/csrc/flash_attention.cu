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
flash_fwd_bf16(QKV in, Out out, const float* __restrict__ bias, int n, int causal,
               float scale) {
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
flash_fwd_simt(QKV in, Out out, const float* __restrict__ bias, int n, int dh, int causal,
               float scale) {
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
  }
}

}  // namespace

extern "C" {

// q, k, v at base + b*sb + h*sh + n*sn + d (element strides, d contiguous),
// o at its own strides; bias [B, N] f32 or null; dtype 0 float32, 1 bf16.
// bf16 needs dh == 64 and 16-byte aligned rows (strides % 8 == 0); float32
// needs dh <= 64.
int nx_flash_attention(const void* q, const void* k, const void* v, void* o, const float* bias,
                       int dtype, int b, int heads, int n, int dh, int sb, int sh, int sn,
                       int osb, int osh, int osn, int causal, float scale, void* stream) {
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
    flash_fwd_bf16<<<grid, FTHREADS, FLASH_SMEM, s>>>(in, out, bias, n, causal, scale);
  } else if (dtype == F32) {
    if (dh < 1 || dh > 64) return (int)cudaErrorInvalidValue;
    const size_t smem = simt_smem(dh);
    const cudaError_t err = cudaFuncSetAttribute(
        flash_fwd_simt<float>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    const dim3 grid((n + S_QTILE - 1) / S_QTILE, heads, b);
    flash_fwd_simt<float><<<grid, S_THREADS, smem, s>>>(in, out, bias, n, dh, causal, scale);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
