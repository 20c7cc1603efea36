// Flash attention, forward and backward, for training on Hopper (sm_90a).
// Bound by a plain C interface and ctypes (kernel.py).
//
// Replaces the Pallas TPU kernel flash_attention_bhsd (_flash_kernel) in
// src/repro/kernels/flash_attention/kernel.py, which is forward only. The
// backward has no TPU counterpart: the training path needs a gradient
// through the forward, so it is hand-written too (FlashAttention-2's
// recomputation from the saved row log-sum-exp).
//
// Layout: q (B, Sq, Hq, D), k and v (B, Sk, Hkv, D), all of one type (f32
// or bf16), contiguous; query head h reads KV head h / (Hq / Hkv) (GQA, no
// repeated K/V). Query i sits at position i + Sk - Sq (right-aligned);
// causal keeps keys at or before it, a sliding window of W keeps the W
// keys ending at it. A row with no visible key gets an output of zeros and
// a log-sum-exp of -inf, as the TPU kernel's max(l, 1e-30) guard gives.
//
// Two routes, by dtype; a bf16 tensor reaches only the first.
//
// bf16 (the training path; namespace tc). At the training shape (B 4,
// S 513, 16/2 heads, D 128, causal) the forward does ~4.3 GFLOP of products
// (~4.4 us at the tensor cores' 989 TFLOP/s) and moves ~19 MB (~5.7 us at
// 3.35 TB/s): bound by bytes only if the products run on the tensor cores
// and the softmax keeps up with them. The backward does ~4x the products.
//   - Products: every one is a wgmma. S = Q K^T and dP = dO V^T (and their
//     transposes in dK/dV) take both operands K-major from shared memory
//     (m64n64k16); P V, P^T dO, dS^T Q and dS K take P or dS as register
//     fragments and the other operand MN-major (m64n128k16 for D = 128,
//     and for D = 80, zamba2's shared attention, whose rows TMA pads with
//     zeros to two 64-column sub-tiles: see subtiles()).
//   - Tiles stay bf16 in shared memory, 128-byte swizzled, and arrive by TMA
//     (cp.async.bulk.tensor) with an mbarrier per slot: a block's own tile
//     once, the streamed tiles through rings of two slots, so the next
//     tile's copy overlaps this one's math. A 128-byte swizzle holds 64 bf16,
//     so a D = 128 row is two 64-column sub-tiles. TMA fills rows outside the
//     tensor with zeros.
//   - One warpgroup (128 threads) per block owns a 64-row tile (queries in
//     the forward and dQ, keys in dK/dV); two blocks share an SM, so one
//     block's softmax overlaps the other's products. In the forward a
//     producer warp keeps the copies in flight, and each iteration issues
//     S_t and P_{t-1} V_{t-1} together and runs the softmax of S_t while the
//     second runs.
//   - The softmax is what bounds the forward on this card: with two warps a
//     scheduler, its instructions (not the tensor cores) set the pace. So
//     the scale is folded into the exponent's FMA, exp2 is ex2.approx, and a
//     mask costs two compares a score against the row's visible interval,
//     only on tiles that straddle the diagonal, the window edge or row 0.
//   - Query and key tiles are right-aligned to the ends of Sq and Sk (the
//     first tile may start before row 0), so under a causal mask the ragged
//     tile holds the first query and sees one key tile, not the last query
//     and every key tile. Blocks are launched longest first.
// Precision. P and dS must keep about 16 bits: bf16(P) V reads 14.1 times
// chip_smoke's one-ulp forward allowance at the training shape (fp16 P
// 2.2), and the backward with bf16 P and dS reads dQ 1.08, dK 1.63, dV 0.80
// of its allowance (simulated on the CPU). So P and dS are split in
// registers into hi = bf16(x) and lo = bf16(x - hi), and two wgmmas
// accumulate hi B + lo B into one f32 sum (simulated: 0.94 forward; 0.41,
// 0.38, 0.19 backward). The row sum l is taken from f32 P.
// The backward, with no atomics, so that gradients are the same bit for
// bit from run to run:
//   stats:  (lse log2 e, Di = rowsum(dO O)) per query row, one warp a row;
//   dK, dV: one block per (batch x query head, 64-key tile) walks the query
//           tiles that see its keys: S^T = K Q^T, P^T = exp(S^T - lse),
//           dP^T = V dO^T, dS^T = P^T (dP^T - Di), dV_h += P^T dO,
//           dK_h += dS^T Q, and writes its head's dK_h and dV_h in f32 to a
//           scratch (B, Hq, Sk, D) that the caller allocates. Blocks per
//           query head, not per KV head, give the card 576 blocks at the
//           training shape instead of 72;
//   reduce: sums each group's heads in a fixed order into dK and dV, so the
//           sum is the same bits on every run, as atomics would not be;
//   dQ:     one block per (batch x query head, 64-query tile): dQ += dS K.
//
// f32 (the card-against-CPU check at 1e-4, which TF32 or bf16 products
// would break). Products with f32 FMAs on the CUDA cores, so bound by those
// operations. The TPU kernel walks a sequential key-block grid axis and
// keeps the running max, sum and output in VMEM scratch. Blocks on this
// card run in no order, so one block of 256 threads takes a (batch x query
// head, 64-query tile) and loops over its 64-key tiles itself, keeping the
// output accumulator, the running max and the running sum in registers.
// Key tiles wholly past the causal or window edge are skipped, not masked;
// the ragged edge of any S is masked. Tiles are staged through shared
// memory (rows padded by 4 floats, so that the 16-byte reads of 8
// neighbouring rows fall on distinct banks). A thread owns a 4 x 4 block of
// each 64 x 64 score tile (rows ty + 16 i, columns tx + 16 j) and 4 rows x
// D/16 columns of the output. Its backward:
//   delta:  Di = rowsum(dO * O), one warp per row;
//   dK, dV: one block per (batch x KV head, 64-key tile) accumulates over the
//           group's query heads and every query tile that sees the keys;
//   dQ:     one block per (batch x query head, 64-query tile).
#include <cuda.h>  // CUtensorMap and its enums only: cuTensorMapEncodeTiled is fetched at run time
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 64;               // queries per query tile, keys per key tile
constexpr int kPStride = kTile + 4;     // row stride of a 64 x 64 f32 tile in shared memory
constexpr float kNegInf = -1.0e30f;     // the TPU kernel's NEG_INF

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const void* o;      // backward: the forward's output
  const void* d_o;    // backward: the output's gradient
  void* out;          // forward: the output
  float* lse;         // (B, Hq, Sq): written by the forward, read by the backward
  float* delta;       // (B, Hq, Sq): rowsum(dO * O)
  void* dq;
  void* dk;
  void* dv;
  int b, sq, sk, hq, hkv;
  int causal;
  int window;         // <= 0: none
  float scale;
};

// Rows [row0, row0 + 64) of a (.., S, H, D) operand, starting at ``base``
// (the first row of one (batch, head)), into ``sm`` as f32 with row stride
// D + 4; rows at or past ``rows`` are zero.
template <int D>
__device__ void load_tile(float* sm, const float* base, int row0, int rows, int row_stride) {
  constexpr int kPer = 4;  // floats per 16-byte load
  constexpr int kChunks = D / kPer;
  for (int i = threadIdx.x; i < kTile * kChunks; i += kThreads) {
    const int r = i / kChunks, c = (i % kChunks) * kPer;
    float* dst = sm + r * (D + 4) + c;
    if (row0 + r < rows) {
      *reinterpret_cast<float4*>(dst) =
          *reinterpret_cast<const float4*>(base + (size_t)(row0 + r) * row_stride + c);
    } else {
#pragma unroll
      for (int j = 0; j < kPer; ++j) dst[j] = 0.f;
    }
  }
}

__device__ __forceinline__ bool visible(const Params& p, int qi, int kpos) {
  const int qpos = qi + p.sk - p.sq;
  return qi < p.sq && kpos < p.sk && (!p.causal || kpos <= qpos) &&
         (p.window <= 0 || kpos > qpos - p.window);
}

// The key tiles [lo, hi) that queries [q0, q0 + 64) may see.
__device__ __forceinline__ void key_range(const Params& p, int q0, int* lo, int* hi) {
  const int off = p.sk - p.sq;
  const int qpos_lo = q0 + off, qpos_hi = min(q0 + kTile, p.sq) - 1 + off;
  int k_lo = 0, k_hi = p.sk;
  if (p.causal) k_hi = min(k_hi, qpos_hi + 1);
  if (p.window > 0) k_lo = max(k_lo, qpos_lo - p.window + 1);
  *lo = k_lo / kTile;
  *hi = k_hi > k_lo ? (k_hi + kTile - 1) / kTile : *lo;
}

// The query tiles [lo, hi) that may see keys [k0, k0 + 64).
__device__ __forceinline__ void query_range(const Params& p, int k0, int* lo, int* hi) {
  const int off = p.sk - p.sq;
  const int k_last = min(k0 + kTile, p.sk) - 1;
  int q_lo = 0, q_hi = p.sq;
  if (p.causal) q_lo = max(q_lo, k0 - off);
  if (p.window > 0) q_hi = min(q_hi, k_last + p.window - off);
  *lo = q_lo / kTile;
  *hi = q_hi > q_lo ? (q_hi + kTile - 1) / kTile : *lo;
}

// acc[i][j] += sum_d A[ty + 16 i][d] * B[tx + 16 j][d] over shared-memory
// tiles of row stride D + 4.
template <int D>
__device__ __forceinline__ void dot_tile(float (&acc)[4][4], const float* A, const float* B,
                                         int ty, int tx) {
  constexpr int S = D + 4;
#pragma unroll 4
  for (int d = 0; d < D; d += 4) {
    float4 a[4], b[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = *reinterpret_cast<const float4*>(A + (ty + 16 * i) * S + d);
#pragma unroll
    for (int j = 0; j < 4; ++j) b[j] = *reinterpret_cast<const float4*>(B + (tx + 16 * j) * S + d);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        acc[i][j] = fmaf(a[i].x, b[j].x, acc[i][j]);
        acc[i][j] = fmaf(a[i].y, b[j].y, acc[i][j]);
        acc[i][j] = fmaf(a[i].z, b[j].z, acc[i][j]);
        acc[i][j] = fmaf(a[i].w, b[j].w, acc[i][j]);
      }
  }
}

// out[i][c] += sum_k W[ty + 16 i][k] * X[k][4 tx + 64 c .. + 4] for a 64 x 64
// weight tile W (stride kPStride) and a 64 x D tile X (stride D + 4).
template <int D>
__device__ __forceinline__ void mul_tile(float (&out)[4][D / 64][4], const float* W, const float* X,
                                         int ty, int tx) {
  constexpr int S = D + 4;
#pragma unroll 4
  for (int k = 0; k < kTile; ++k) {
    float w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) w[i] = W[(ty + 16 * i) * kPStride + k];
#pragma unroll
    for (int c = 0; c < D / 64; ++c) {
      const float4 x = *reinterpret_cast<const float4*>(X + k * S + 4 * tx + 64 * c);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        out[i][c][0] = fmaf(w[i], x.x, out[i][c][0]);
        out[i][c][1] = fmaf(w[i], x.y, out[i][c][1]);
        out[i][c][2] = fmaf(w[i], x.z, out[i][c][2]);
        out[i][c][3] = fmaf(w[i], x.w, out[i][c][3]);
      }
    }
  }
}

// reductions over the 16 lanes that share a ty (lanes 0-15 or 16-31 of a warp)
__device__ __forceinline__ float max16(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float sum16(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// Writes rows [row0, row0 + 64) of a (.., S, H, D) operand from per-thread
// accumulators (rows ty + 16 i, columns 4 tx + 64 c), times ``mul``.
template <int D>
__device__ void store_rows(float* base, int row0, int rows, int row_stride, const float (&acc)[4][D / 64][4],
                           float mul, int ty, int tx) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = row0 + ty + 16 * i;
    if (r >= rows) continue;
    float* dst = base + (size_t)r * row_stride;
#pragma unroll
    for (int c = 0; c < D / 64; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) dst[4 * tx + 64 * c + e] = __fmul_rn(acc[i][c][e], mul);
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads) flash_fwd_kernel(Params p) {
  extern __shared__ __align__(16) float smem[];
  constexpr int S = D + 4;
  float* Qs = smem;
  float* Ks = Qs + kTile * S;
  float* Vs = Ks + kTile * S;
  float* Ps = Vs + kTile * S;
  const int q0 = blockIdx.x * kTile, bh = blockIdx.y;
  const int b = bh / p.hq, h = bh % p.hq, hk = h / (p.hq / p.hkv);
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const float* qb = static_cast<const float*>(p.q) + ((size_t)b * p.sq * p.hq + h) * D;
  const float* kb = static_cast<const float*>(p.k) + ((size_t)b * p.sk * p.hkv + hk) * D;
  const float* vb = static_cast<const float*>(p.v) + ((size_t)b * p.sk * p.hkv + hk) * D;
  load_tile<D>(Qs, qb, q0, p.sq, p.hq * D);

  float acc[4][D / 64][4] = {};
  float m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
  }
  int t_lo, t_hi;
  key_range(p, q0, &t_lo, &t_hi);
  for (int t = t_lo; t < t_hi; ++t) {
    const int k0 = t * kTile;
    __syncthreads();  // the previous tile's K, V and P are no longer read
    load_tile<D>(Ks, kb, k0, p.sk, p.hkv * D);
    load_tile<D>(Vs, vb, k0, p.sk, p.hkv * D);
    __syncthreads();
    float s[4][4] = {};
    dot_tile<D>(s, Qs, Ks, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qi = q0 + ty + 16 * i;
      bool ok[4];
      float row_max = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        ok[j] = visible(p, qi, k0 + tx + 16 * j);
        s[i][j] = ok[j] ? s[i][j] * p.scale : kNegInf;
        row_max = fmaxf(row_max, s[i][j]);
      }
      const float m_new = fmaxf(m[i], max16(row_max));
      const float alpha = expf(m[i] - m_new);
      float row_sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float pj = ok[j] ? expf(s[i][j] - m_new) : 0.f;
        Ps[(ty + 16 * i) * kPStride + tx + 16 * j] = pj;
        row_sum += pj;
      }
      l[i] = l[i] * alpha + sum16(row_sum);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < D / 64; ++c)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][c][e] *= alpha;
    }
    __syncthreads();
    mul_tile<D>(acc, Ps, Vs, ty, tx);
  }

  float* ob = static_cast<float*>(p.out) + ((size_t)b * p.sq * p.hq + h) * D;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = q0 + ty + 16 * i;
    if (qi >= p.sq) continue;
    const float denom = fmaxf(l[i], 1e-30f);
    float* dst = ob + (size_t)qi * p.hq * D;
#pragma unroll
    for (int c = 0; c < D / 64; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) dst[4 * tx + 64 * c + e] = __fdiv_rn(acc[i][c][e], denom);
    if (tx == 0) p.lse[(size_t)bh * p.sq + qi] = l[i] > 0.f ? m[i] + logf(l[i]) : -INFINITY;
  }
}

// Di = rowsum(dO * O) in f32, one warp per (batch, query, head) row.
template <int D>
__global__ void __launch_bounds__(kThreads) flash_bwd_delta_kernel(Params p) {
  const int row = blockIdx.x * (kThreads / 32) + threadIdx.x / 32, lane = threadIdx.x % 32;
  if (row >= p.b * p.sq * p.hq) return;
  const float* o = static_cast<const float*>(p.o) + (size_t)row * D;
  const float* d_o = static_cast<const float*>(p.d_o) + (size_t)row * D;
  float acc = 0.f;
  for (int d = lane; d < D; d += 32) acc = fmaf(o[d], d_o[d], acc);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) {
    const int h = row % p.hq, qi = (row / p.hq) % p.sq, b = row / (p.hq * p.sq);
    p.delta[((size_t)b * p.hq + h) * p.sq + qi] = acc;
  }
}

// Loads the per-row log-sum-exp and Di of query rows [q0, q0 + 64).
__device__ __forceinline__ void load_rows_stats(const Params& p, int bh, int q0, float* lse_s, float* delta_s) {
  if (threadIdx.x < kTile) {
    const int qi = q0 + threadIdx.x;
    const bool in = qi < p.sq;
    lse_s[threadIdx.x] = in ? p.lse[(size_t)bh * p.sq + qi] : 0.f;
    delta_s[threadIdx.x] = in ? p.delta[(size_t)bh * p.sq + qi] : 0.f;
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads) flash_bwd_dkdv_kernel(Params p) {
  extern __shared__ __align__(16) float smem[];
  constexpr int S = D + 4;
  float* Ks = smem;
  float* Vs = Ks + kTile * S;
  float* Qs = Vs + kTile * S;
  float* dOs = Qs + kTile * S;
  float* Pt = dOs + kTile * S;       // P^T: keys x queries
  float* dSt = Pt + kTile * kPStride;  // dS^T
  float* lse_s = dSt + kTile * kPStride;
  float* delta_s = lse_s + kTile;
  const int k0 = blockIdx.x * kTile, bhk = blockIdx.y;
  const int b = bhk / p.hkv, hk = bhk % p.hkv, group = p.hq / p.hkv;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const size_t kv_off = ((size_t)b * p.sk * p.hkv + hk) * D;
  load_tile<D>(Ks, static_cast<const float*>(p.k) + kv_off, k0, p.sk, p.hkv * D);
  load_tile<D>(Vs, static_cast<const float*>(p.v) + kv_off, k0, p.sk, p.hkv * D);

  float dk[4][D / 64][4] = {}, dv[4][D / 64][4] = {};
  int t_lo, t_hi;
  query_range(p, k0, &t_lo, &t_hi);
  for (int g = 0; g < group; ++g) {
    const int h = hk * group + g, bh = b * p.hq + h;
    const size_t q_off = ((size_t)b * p.sq * p.hq + h) * D;
    for (int t = t_lo; t < t_hi; ++t) {
      const int q0 = t * kTile;
      __syncthreads();  // the previous tile's Q, dO, P^T and dS^T are no longer read
      load_tile<D>(Qs, static_cast<const float*>(p.q) + q_off, q0, p.sq, p.hq * D);
      load_tile<D>(dOs, static_cast<const float*>(p.d_o) + q_off, q0, p.sq, p.hq * D);
      load_rows_stats(p, bh, q0, lse_s, delta_s);
      __syncthreads();
      float s[4][4] = {}, dp[4][4] = {};
      dot_tile<D>(s, Ks, Qs, ty, tx);   // S^T[key][query]
      dot_tile<D>(dp, Vs, dOs, ty, tx); // dP^T[key][query]
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int qc = tx + 16 * j;
          const float pij = visible(p, q0 + qc, k0 + ty + 16 * i)
                                ? expf(s[i][j] * p.scale - lse_s[qc]) : 0.f;
          Pt[(ty + 16 * i) * kPStride + qc] = pij;
          dSt[(ty + 16 * i) * kPStride + qc] = pij * (dp[i][j] - delta_s[qc]);
        }
      __syncthreads();
      mul_tile<D>(dv, Pt, dOs, ty, tx);
      mul_tile<D>(dk, dSt, Qs, ty, tx);
    }
  }
  store_rows<D>(static_cast<float*>(p.dk) + kv_off, k0, p.sk, p.hkv * D, dk, p.scale, ty, tx);
  store_rows<D>(static_cast<float*>(p.dv) + kv_off, k0, p.sk, p.hkv * D, dv, 1.f, ty, tx);
}

template <int D>
__global__ void __launch_bounds__(kThreads) flash_bwd_dq_kernel(Params p) {
  extern __shared__ __align__(16) float smem[];
  constexpr int S = D + 4;
  float* Qs = smem;
  float* dOs = Qs + kTile * S;
  float* Ks = dOs + kTile * S;
  float* Vs = Ks + kTile * S;
  float* dSs = Vs + kTile * S;
  float* lse_s = dSs + kTile * kPStride;
  float* delta_s = lse_s + kTile;
  const int q0 = blockIdx.x * kTile, bh = blockIdx.y;
  const int b = bh / p.hq, h = bh % p.hq, hk = h / (p.hq / p.hkv);
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const size_t q_off = ((size_t)b * p.sq * p.hq + h) * D;
  const size_t kv_off = ((size_t)b * p.sk * p.hkv + hk) * D;
  load_tile<D>(Qs, static_cast<const float*>(p.q) + q_off, q0, p.sq, p.hq * D);
  load_tile<D>(dOs, static_cast<const float*>(p.d_o) + q_off, q0, p.sq, p.hq * D);
  load_rows_stats(p, bh, q0, lse_s, delta_s);

  float dq[4][D / 64][4] = {};
  int t_lo, t_hi;
  key_range(p, q0, &t_lo, &t_hi);
  for (int t = t_lo; t < t_hi; ++t) {
    const int k0 = t * kTile;
    __syncthreads();
    load_tile<D>(Ks, static_cast<const float*>(p.k) + kv_off, k0, p.sk, p.hkv * D);
    load_tile<D>(Vs, static_cast<const float*>(p.v) + kv_off, k0, p.sk, p.hkv * D);
    __syncthreads();
    float s[4][4] = {}, dp[4][4] = {};
    dot_tile<D>(s, Qs, Ks, ty, tx);
    dot_tile<D>(dp, dOs, Vs, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qr = ty + 16 * i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float pij = visible(p, q0 + qr, k0 + tx + 16 * j)
                              ? expf(s[i][j] * p.scale - lse_s[qr]) : 0.f;
        dSs[qr * kPStride + tx + 16 * j] = pij * (dp[i][j] - delta_s[qr]);
      }
    }
    __syncthreads();
    mul_tile<D>(dq, dSs, Ks, ty, tx);
  }
  store_rows<D>(static_cast<float*>(p.dq) + q_off, q0, p.sq, p.hq * D, dq, p.scale, ty, tx);
}

constexpr size_t tile_bytes(int d) { return (size_t)kTile * (d + 4) * sizeof(float); }
constexpr size_t fwd_smem(int d) { return 3 * tile_bytes(d) + (size_t)kTile * kPStride * sizeof(float); }
constexpr size_t dkdv_smem(int d) {
  return 4 * tile_bytes(d) + 2 * (size_t)kTile * kPStride * sizeof(float) + 2 * kTile * sizeof(float);
}
constexpr size_t dq_smem(int d) {
  return 4 * tile_bytes(d) + (size_t)kTile * kPStride * sizeof(float) + 2 * kTile * sizeof(float);
}

template <typename Kernel>
cudaError_t launch(Kernel kernel, dim3 grid, size_t smem, cudaStream_t stream, const Params& p) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <int D>
cudaError_t forward(const Params& p, cudaStream_t stream) {
  const dim3 grid((p.sq + kTile - 1) / kTile, p.b * p.hq);
  return launch(flash_fwd_kernel<D>, grid, fwd_smem(D), stream, p);
}

template <int D>
cudaError_t backward(const Params& p, cudaStream_t stream) {
  const int rows = p.b * p.sq * p.hq, warps = kThreads / 32;
  flash_bwd_delta_kernel<D><<<(rows + warps - 1) / warps, kThreads, 0, stream>>>(p);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  err = launch(flash_bwd_dkdv_kernel<D>, dim3((p.sk + kTile - 1) / kTile, p.b * p.hkv),
               dkdv_smem(D), stream, p);
  if (err != cudaSuccess) return err;
  return launch(flash_bwd_dq_kernel<D>, dim3((p.sq + kTile - 1) / kTile, p.b * p.hq),
                dq_smem(D), stream, p);
}

Params make_params(const void* q, const void* k, const void* v, int b, int sq, int sk, int hq,
                   int hkv, int causal, int window, float scale) {
  Params p = {};
  p.q = q;
  p.k = k;
  p.v = v;
  p.b = b;
  p.sq = sq;
  p.sk = sk;
  p.hq = hq;
  p.hkv = hkv;
  p.causal = causal;
  p.window = window;
  p.scale = scale;
  return p;
}


// ---------------------------------------------------------------------------
// The bf16 route: tensor cores (wgmma), TMA loads, one warpgroup per block.
// ---------------------------------------------------------------------------
namespace tc {

constexpr int kThreads = 128;               // one warpgroup
constexpr int kRows = 64;                   // rows of a tile: queries, or keys
constexpr int kStages = 2;                  // slots of each ring of streamed tiles
constexpr int kFwdThreads = kThreads + 32;  // forward: a consumer warpgroup and a producer warp
constexpr int kSubBytes = kRows * 64 * 2;   // a 64-row x 64-column bf16 sub-tile, 128-byte swizzled
constexpr int kStatsBytes = kRows * 16;     // (lse log2 e, Di, 0, 0) of 64 query rows
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// 64-column sub-tiles of a D-wide row. D = 80 (zamba2's shared attention)
// takes two, as D = 128 does: TMA fills columns 80-127 of the second with
// zeros, the products over D run 5 k-steps, the 128-wide products (P V and
// the backward's) carry 48 zero columns, and the stores write 80.
__host__ __device__ constexpr int subtiles(int d) { return (d + 63) / 64; }

struct Params {
  int b, sq, sk, hq, hkv;
  int causal;
  int window;         // <= 0: none
  float scale;        // softmax scale
  float scale_log2;   // scale * log2(e): scores go to exp2
  __nv_bfloat16* out;           // forward: the output
  float* lse;                   // (B, Hq, Sq): written by the forward, read by the backward
  const __nv_bfloat16* o;       // backward: the forward's output
  const __nv_bfloat16* d_o;     // backward: the output's gradient
  float* stats;                 // (B, Hq, Sq, 4): (lse log2 e, Di, 0, 0) per query row
  float* dk_part;               // (B, Hq, Sk, D) f32: each query head's dK (unscaled)
  float* dv_part;               // (B, Hq, Sk, D) f32: each query head's dV
  __nv_bfloat16* dq;
  __nv_bfloat16* dk;
  __nv_bfloat16* dv;
};

__host__ __device__ __forceinline__ int cdiv(int a, int b) { return (a + b - 1) / b; }

// The first row of the tiles over s rows, right-aligned to the end: in (-64, 0].
__host__ __device__ __forceinline__ int tile_base(int s) { return s - kRows * cdiv(s, kRows); }

// The columns [lo, hi] of a score tile whose columns are keys k0.. that
// query qi sees (empty when lo > hi).
__device__ __forceinline__ void seen_keys(const Params& p, int qi, int k0, int* lo, int* hi) {
  const int qpos = qi + p.sk - p.sq;
  *lo = -k0;  // keys before 0 lie outside the tensor
  *hi = qi >= 0 ? kRows - 1 : -1;
  if (p.causal) *hi = min(*hi, qpos - k0);
  if (p.window > 0) *lo = max(*lo, qpos - p.window + 1 - k0);
}

// The columns [lo, hi] of a transposed score tile whose columns are queries
// q0.. that see key kj.
__device__ __forceinline__ void seeing_queries(const Params& p, int kj, int q0, int* lo, int* hi) {
  const int off = p.sk - p.sq;
  *lo = -q0;
  *hi = kj >= 0 ? kRows - 1 : -1;
  if (p.causal) *lo = max(*lo, kj - off - q0);
  if (p.window > 0) *hi = min(*hi, kj - off + p.window - 1 - q0);
}

// 2^x, flushing results below 2^-126 to zero (they are probabilities far
// below what bf16 P V can carry).
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// Whether every query of [q0, q0 + 64) sees every key of [k0, k0 + 64): then
// the tile needs no mask.
__device__ __forceinline__ bool tile_full(const Params& p, int q0, int k0) {
  const int off = p.sk - p.sq;
  return q0 >= 0 && k0 >= 0 && (!p.causal || k0 + kRows - 1 <= q0 + off) &&
         (p.window <= 0 || k0 > q0 + kRows - 1 + off - p.window);
}

// The key tiles [lo, hi) that queries [q_first, q_last] see.
__device__ __forceinline__ void key_tiles(const Params& p, int q_first, int q_last, int* lo, int* hi) {
  const int off = p.sk - p.sq, kbase = tile_base(p.sk);
  int k_lo = 0, k_hi = q_last >= 0 ? p.sk - 1 : -1;
  if (p.causal) k_hi = min(k_hi, q_last + off);
  if (p.window > 0) k_lo = max(k_lo, max(q_first, 0) + off - p.window + 1);
  *lo = k_lo <= k_hi ? (k_lo - kbase) / kRows : 0;
  *hi = k_lo <= k_hi ? (k_hi - kbase) / kRows + 1 : 0;
}

// The query tiles [lo, hi) that see keys [k0, k0 + 64).
__device__ __forceinline__ void query_tiles(const Params& p, int k0, int* lo, int* hi) {
  const int off = p.sk - p.sq, qbase = tile_base(p.sq);
  int q_lo = 0, q_hi = p.sq - 1;
  if (p.causal) q_lo = max(q_lo, max(k0, 0) - off);
  if (p.window > 0) q_hi = min(q_hi, k0 + kRows - 1 + p.window - 1 - off);
  *lo = q_lo <= q_hi ? (q_lo - qbase) / kRows : 0;
  *hi = q_lo <= q_hi ? (q_hi - qbase) / kRows + 1 : 0;
}

__device__ __forceinline__ uint32_t smem_addr(const void* ptr) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(ptr));
}

// The dynamic shared memory, from its first 1 KB boundary (a 128-byte swizzle
// repeats every 1 KB, and TMA and wgmma assume tiles that start on one).
__device__ __forceinline__ uint8_t* align_1k(uint8_t* base) {
  return base + ((1024 - (smem_addr(base) & 1023)) & 1023);
}

// -- mbarriers and TMA --

__device__ __forceinline__ void bar_init(uint64_t* bar, uint32_t arrivals = 1) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(arrivals) : "memory");
}

__device__ __forceinline__ void bar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// The one arrival of a phase, expecting ``bytes`` from TMA.
__device__ __forceinline__ void bar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(bytes)
               : "memory");
}

// One arrival on a barrier that counts arrivals only.
__device__ __forceinline__ void bar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_addr(bar)) : "memory");
}

__device__ __forceinline__ void bar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n.reg .pred done;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra WAIT;\n"
      "}\n" ::"r"(smem_addr(bar)),
      "r"(parity)
      : "memory");
}

// Orders this block's generic reads of shared memory before a TMA write to it.
__device__ __forceinline__ void async_proxy_fence() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Rows [row, row + 64) and columns [col, col + 64) of head h of batch b of a
// (B, S, H, D) bf16 tensor (tensor map from rows_map); rows outside [0, S)
// arrive as zeros.
__device__ __forceinline__ void tma_rows(void* dst, const CUtensorMap& map, int col, int h, int row, int b,
                                         uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, {%2, %3, %4, %5}], "
      "[%6];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(&map)), "r"(col), "r"(h), "r"(row), "r"(b), "r"(smem_addr(bar))
      : "memory");
}

// The stats of query rows [row, row + 64) of (batch x head) bh (tensor map
// from stats_map); rows before 0 arrive as zeros.
__device__ __forceinline__ void tma_stats(void* dst, const CUtensorMap& map, int row, int bh, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, {%2, %3, %4}], "
      "[%5];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(&map)), "r"(0), "r"(row), "r"(bh), "r"(smem_addr(bar))
      : "memory");
}

// -- wgmma --

// The descriptor of a 128-byte-swizzled operand at ``ptr``: rows of 128
// bytes (64 bf16), 8-row groups 1 KB apart (the stride byte offset). The one
// layout serves K-major operands (a k-step of 16 moves 32 bytes along the
// row; the leading byte offset is unused) and MN-major ones (a k-step moves
// 16 rows; the leading byte offset steps between 64-column sub-tiles).
__device__ __forceinline__ uint64_t desc(const void* ptr) {
  const uint64_t addr = smem_addr(ptr);
  return ((addr & 0x3FFFF) >> 4) | (uint64_t(kSubBytes >> 4) << 16) | (uint64_t(1024 >> 4) << 32) |
         (uint64_t(1) << 62);
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }
// Waits until at most N committed groups of this warpgroup's wgmmas are pending.
template <int N = 0>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Tells the compiler that ``d`` changes here: code that reads a wgmma's
// accumulator stays after the wait that completes it, and code that writes
// an operand stays before the fence that precedes its wgmma.
__device__ __forceinline__ void fence_regs(float (&d)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

__device__ __forceinline__ void fence_regs(uint32_t (&a)[4][4]) {
#pragma unroll
  for (int i = 0; i < 16; ++i) asm volatile("" : "+r"(a[i / 4][i % 4])::"memory");
}

// d (64 x 64, f32) += A (64 x 16) B (16 x 64) with both operands K-major in
// shared memory; scale_d == 0 overwrites d instead.
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t desc_a, uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// d (64 x 64, f32) += A (64 x 16, bf16 fragments in registers) B (16 x 64),
// B in shared memory MN-major (its 64 columns contiguous).
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4], uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

// d0|d1 (64 x 128, f32: columns 0-63 and 64-127) += A (64 x 16, bf16
// fragments in registers) B (16 x 128), B in shared memory MN-major as two
// 64-column sub-tiles kSubBytes apart.
__device__ __forceinline__ void wgmma_rs_n128(float (&d0)[32], float (&d1)[32], const uint32_t (&a)[4],
                                              uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d0[0]), "+f"(d0[1]), "+f"(d0[2]), "+f"(d0[3]), "+f"(d0[4]), "+f"(d0[5]), "+f"(d0[6]), "+f"(d0[7]),
        "+f"(d0[8]), "+f"(d0[9]), "+f"(d0[10]), "+f"(d0[11]), "+f"(d0[12]), "+f"(d0[13]), "+f"(d0[14]), "+f"(d0[15]),
        "+f"(d0[16]), "+f"(d0[17]), "+f"(d0[18]), "+f"(d0[19]), "+f"(d0[20]), "+f"(d0[21]), "+f"(d0[22]), "+f"(d0[23]),
        "+f"(d0[24]), "+f"(d0[25]), "+f"(d0[26]), "+f"(d0[27]), "+f"(d0[28]), "+f"(d0[29]), "+f"(d0[30]), "+f"(d0[31]),
        "+f"(d1[0]), "+f"(d1[1]), "+f"(d1[2]), "+f"(d1[3]), "+f"(d1[4]), "+f"(d1[5]), "+f"(d1[6]), "+f"(d1[7]),
        "+f"(d1[8]), "+f"(d1[9]), "+f"(d1[10]), "+f"(d1[11]), "+f"(d1[12]), "+f"(d1[13]), "+f"(d1[14]), "+f"(d1[15]),
        "+f"(d1[16]), "+f"(d1[17]), "+f"(d1[18]), "+f"(d1[19]), "+f"(d1[20]), "+f"(d1[21]), "+f"(d1[22]), "+f"(d1[23]),
        "+f"(d1[24]), "+f"(d1[25]), "+f"(d1[26]), "+f"(d1[27]), "+f"(d1[28]), "+f"(d1[29]), "+f"(d1[30]), "+f"(d1[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

// The accumulator of a 64 x 64 wgmma gives thread t of warp w of the
// warpgroup element e at row 16 w + t / 4 + 8 ((e >> 1) & 1) and column
// 8 (e >> 2) + 2 (t % 4) + (e & 1).
__device__ __forceinline__ int acc_col(int e) { return 8 * (e >> 2) + (e & 1); }

__device__ __forceinline__ uint32_t bf16x2(float lo_col, float hi_col) {
  const __nv_bfloat162 x = __floats2bfloat162_rn(lo_col, hi_col);
  return *reinterpret_cast<const uint32_t*>(&x);
}

// The A fragments of a 64 x 64 accumulator x for the four k-steps of 16
// columns, as hi = bf16(x) and lo = bf16(x - hi): hi V + lo V carries x to
// about 16 bits, where bf16(x) V alone would carry 8.
__device__ __forceinline__ void split(const float (&x)[32], uint32_t (&hi)[4][4], uint32_t (&lo)[4][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const float a = x[8 * kk + 2 * r], b = x[8 * kk + 2 * r + 1];
      const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
      const float2 hf = __bfloat1622float2(h);
      hi[kk][r] = *reinterpret_cast<const uint32_t*>(&h);
      lo[kk][r] = bf16x2(a - hf.x, b - hf.y);
    }
}

// acc[c] += A B for the 64 x 64 operand A (split hi/lo) and the 64 x D tile
// B at ``tile`` (sub-tiles of 64 columns, read MN-major).
template <int D>
__device__ __forceinline__ void mma_split(float (&acc)[subtiles(D)][32], const uint32_t (&hi)[4][4],
                                          const uint32_t (&lo)[4][4], const uint8_t* tile) {
  const uint64_t b0 = desc(tile);
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const uint64_t b = b0 + ((kk * 16 * 128) >> 4);  // the address field counts 16 bytes
    if constexpr (subtiles(D) == 2) {
      wgmma_rs_n128(acc[0], acc[1], hi[kk], b);
      wgmma_rs_n128(acc[0], acc[1], lo[kk], b);
    } else {
      wgmma_rs(acc[0], hi[kk], b);
      wgmma_rs(acc[0], lo[kk], b);
    }
  }
}

// d = A B^T for the 64 x D tiles A and B (both K-major).
template <int D>
__device__ __forceinline__ void mma_nt(float (&d)[32], const uint8_t* a, const uint8_t* b) {
  const uint64_t a0 = desc(a), b0 = desc(b);
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const int off = ((kk / 4) * kSubBytes + (kk % 4) * 32) >> 4;
    wgmma_ss(d, a0 + off, b0 + off, kk);
  }
}

// Loads the 64 x D tile of rows [row, row + 64) of head h of batch b.
template <int D>
__device__ __forceinline__ void load_tile(uint8_t* dst, const CUtensorMap& map, int h, int row, int b,
                                          uint64_t* bar) {
#pragma unroll
  for (int c = 0; c < subtiles(D); ++c) tma_rows(dst + c * kSubBytes, map, 64 * c, h, row, b, bar);
}

// -- the kernels --

// Forward: one block per (batch x query head, 64-query tile), the last
// tiles (which see the most keys) first. A producer warp loads Q once and
// streams K and V through rings of their own, waiting for the consumer
// warpgroup to release each slot; the warpgroup never waits on a copy it has
// to issue. The output, running max and running sum stay in registers. The
// products are pipelined: iteration t issues S_t = Q K_t^T and then
// P_{t-1} V_{t-1}, and runs the softmax of S_t while the second product is on
// the tensor cores; only the rescale of O and the split of P_t wait for it.
template <int D>
__global__ void __launch_bounds__(kFwdThreads, 2)
    flash_fwd_tc_kernel(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
                        const __grid_constant__ CUtensorMap tm_v, const Params p) {
  constexpr int kSub = subtiles(D), kTile = kSub * kSubBytes;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sQ = align_1k(smem_raw);
  uint8_t* sK = sQ + kTile;
  uint8_t* sV = sK + kStages * kTile;
  // [0] Q; K slot s full, empty; V slot s full, empty
  uint64_t* bar = reinterpret_cast<uint64_t*>(sV + kStages * kTile);
  uint64_t* k_full = bar + 1;
  uint64_t* k_empty = k_full + kStages;
  uint64_t* v_full = k_empty + kStages;
  uint64_t* v_empty = v_full + kStages;

  const int nbh = p.b * p.hq;
  const int qt = cdiv(p.sq, kRows) - 1 - (int)blockIdx.x / nbh, bh = (int)blockIdx.x % nbh;
  const int b = bh / p.hq, h = bh % p.hq, hk = h / (p.hq / p.hkv);
  const int q0 = tile_base(p.sq) + kRows * qt, kbase = tile_base(p.sk);
  int t_lo, t_hi;
  key_tiles(p, q0, q0 + kRows - 1, &t_lo, &t_hi);
  const int tid = threadIdx.x, lane = tid % 32;
  if (tid == 0) {
    bar_init(bar);
    for (int i = 0; i < kStages; ++i) {
      bar_init(k_full + i);
      bar_init(k_empty + i, kThreads / 32);
      bar_init(v_full + i);
      bar_init(v_empty + i, kThreads / 32);
    }
    bar_init_fence();
  }
  __syncthreads();

  if (tid >= kThreads) {  // the producer warp
    if (lane == 0) {
      bar_expect(bar, kTile);
      load_tile<D>(sQ, tm_q, h, q0, b, bar);
      for (int t = t_lo; t < t_hi; ++t) {  // tile t goes to slot (t - t_lo) % kStages
        const int it = t - t_lo, slot = it % kStages, round = it / kStages;
        if (round > 0) bar_wait(k_empty + slot, (round - 1) & 1);
        bar_expect(k_full + slot, kTile);
        load_tile<D>(sK + slot * kTile, tm_k, hk, kbase + kRows * t, b, k_full + slot);
        if (round > 0) bar_wait(v_empty + slot, (round - 1) & 1);
        bar_expect(v_full + slot, kTile);
        load_tile<D>(sV + slot * kTile, tm_v, hk, kbase + kRows * t, b, v_full + slot);
      }
    }
    return;
  }
  // a consumer warp frees a slot once its wgmmas that read the slot are complete
  auto release = [&](uint64_t* empty) {
    __syncwarp();
    if (lane == 0) bar_arrive(empty);
  };
  const int r0 = 16 * (tid / 32) + lane / 4, c0 = 2 * (lane % 4);
  float o[kSub][32];
#pragma unroll
  for (int c = 0; c < kSub; ++c)
#pragma unroll
    for (int e = 0; e < 32; ++e) o[c][e] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};  // rows r0 and r0 + 8, in log2 units
  float s[32], alpha[2];
  uint32_t hi[4][4], lo[4][4];  // P of the tile before, split

  // The scores s of the key tile at k0 become P, relative to the new running
  // max (in log2 units, the scale folded into the exponent); l is rescaled
  // and summed, and alpha is the factor for O.
  auto softmax = [&](int k0) {
    if (!tile_full(p, q0, k0)) {
      int lo_col[2], hi_col[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        seen_keys(p, q0 + r0 + 8 * r, k0, &lo_col[r], &hi_col[r]);
        lo_col[r] -= c0;
        hi_col[r] -= c0;
      }
#pragma unroll
      for (int e = 0; e < 32; ++e) {
        const int r = (e >> 1) & 1, col = acc_col(e);
        if (col < lo_col[r] || col > hi_col[r]) s[e] = -INFINITY;
      }
    }
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int e = 0; e < 32; ++e) mx[(e >> 1) & 1] = fmaxf(mx[(e >> 1) & 1], s[e]);
    float base[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m[r], mx[r] * p.scale_log2);
      base[r] = m_new == -INFINITY ? 0.f : m_new;  // a row with no visible key yet keeps p = 0
      alpha[r] = ex2(m[r] - base[r]);
      m[r] = m_new;
      l[r] *= alpha[r];
    }
#pragma unroll
    for (int e = 0; e < 32; ++e) {
      s[e] = ex2(fmaf(s[e], p.scale_log2, -base[(e >> 1) & 1]));
      l[(e >> 1) & 1] += s[e];
    }
  };
  bar_wait(bar, 0);

  if (t_lo < t_hi) {  // the first tile: S alone (O is still zero)
    bar_wait(k_full, 0);
    wgmma_fence();
    mma_nt<D>(s, sQ, sK);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(s);
    softmax(kbase + kRows * t_lo);
    split(s, hi, lo);
    release(k_empty);
  }
  for (int t = t_lo + 1; t < t_hi; ++t) {
    const int it = t - t_lo;
    bar_wait(k_full + it % kStages, (it / kStages) & 1);
    bar_wait(v_full + (it - 1) % kStages, ((it - 1) / kStages) & 1);
#pragma unroll
    for (int c = 0; c < kSub; ++c) fence_regs(o[c]);
    fence_regs(hi);
    fence_regs(lo);
    wgmma_fence();
    mma_nt<D>(s, sQ, sK + (it % kStages) * kTile);  // S_t = Q K_t^T
    wgmma_commit();
    mma_split<D>(o, hi, lo, sV + ((it - 1) % kStages) * kTile);  // O += P_{t-1} V_{t-1}
    wgmma_commit();
    wgmma_wait<1>();
    fence_regs(s);
    softmax(kbase + kRows * t);
    wgmma_wait<0>();
#pragma unroll
    for (int c = 0; c < kSub; ++c) fence_regs(o[c]);
    if (__any_sync(0xffffffffu, alpha[0] != 1.f || alpha[1] != 1.f)) {  // a row's max moved
#pragma unroll
      for (int c = 0; c < kSub; ++c)
#pragma unroll
        for (int e = 0; e < 32; ++e) o[c][e] *= alpha[(e >> 1) & 1];
    }
    split(s, hi, lo);
    release(k_empty + it % kStages);
    release(v_empty + (it - 1) % kStages);
  }
  if (t_lo < t_hi) {  // the last tile's P V
    const int it = t_hi - 1 - t_lo;
    bar_wait(v_full + it % kStages, (it / kStages) & 1);
#pragma unroll
    for (int c = 0; c < kSub; ++c) fence_regs(o[c]);
    fence_regs(hi);
    fence_regs(lo);
    wgmma_fence();
    mma_split<D>(o, hi, lo, sV + (it % kStages) * kTile);
    wgmma_commit();
    wgmma_wait<0>();
#pragma unroll
    for (int c = 0; c < kSub; ++c) fence_regs(o[c]);
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    const int qi = q0 + r0 + 8 * r;
    if (qi < 0) continue;
    const float denom = fmaxf(l[r], 1e-30f);
    __nv_bfloat16* dst = p.out + ((size_t)(b * p.sq + qi) * p.hq + h) * D;
#pragma unroll
    for (int c = 0; c < kSub; ++c)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int e = 4 * j + 2 * r;
        if (64 * c + 8 * j < D)
          *reinterpret_cast<uint32_t*>(dst + 64 * c + 8 * j + c0) =
              bf16x2(__fdiv_rn(o[c][e], denom), __fdiv_rn(o[c][e + 1], denom));
      }
    if (lane % 4 == 0) p.lse[(size_t)bh * p.sq + qi] = l[r] > 0.f ? (m[r] + log2f(l[r])) * kLn2 : -INFINITY;
  }
}

// (lse log2 e, Di = rowsum(dO * O), 0, 0) of each (batch, query, head) row,
// one warp per row, into the stats scratch. (Rows of 16 bytes: TMA starts a
// box only on a 16-byte boundary of the innermost dimension, and a
// right-aligned tile may start at any row.)
template <int D>
__global__ void __launch_bounds__(256) flash_bwd_stats_kernel(const Params p) {
  const int row = blockIdx.x * 8 + threadIdx.x / 32, lane = threadIdx.x % 32;
  if (row >= p.b * p.sq * p.hq) return;
  const __nv_bfloat162* o = reinterpret_cast<const __nv_bfloat162*>(p.o + (size_t)row * D);
  const __nv_bfloat162* d_o = reinterpret_cast<const __nv_bfloat162*>(p.d_o + (size_t)row * D);
  float acc = 0.f;
#pragma unroll
  for (int i = lane; i < D / 2; i += 32) {
    const float2 x = __bfloat1622float2(o[i]), y = __bfloat1622float2(d_o[i]);
    acc = fmaf(x.x, y.x, acc);
    acc = fmaf(x.y, y.y, acc);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) {
    const int h = row % p.hq, qi = (row / p.hq) % p.sq, b = row / (p.hq * p.sq);
    const size_t bh = (size_t)b * p.hq + h;
    reinterpret_cast<float4*>(p.stats)[bh * p.sq + qi] = make_float4(p.lse[bh * p.sq + qi] * kLog2e, acc, 0.f, 0.f);
  }
}

// dK and dV of one query head: one block per (batch x query head, 64-key
// tile), the first tiles (which the most queries see) first. K and V are
// loaded once; Q, dO and the stats stream through the ring. The block
// writes its head's dK and dV in f32 to the scratch; flash_bwd_reduce_kernel
// sums the heads of each group.
template <int D>
__global__ void __launch_bounds__(kThreads, 2)
    flash_bwd_dkdv_tc_kernel(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
                             const __grid_constant__ CUtensorMap tm_v, const __grid_constant__ CUtensorMap tm_do,
                             const __grid_constant__ CUtensorMap tm_stats, const Params p) {
  constexpr int kSub = subtiles(D), kTile = kSub * kSubBytes;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sK = align_1k(smem_raw);
  uint8_t* sV = sK + kTile;
  uint8_t* sQ = sV + kTile;
  uint8_t* sdO = sQ + kStages * kTile;
  uint8_t* sStats = sdO + kStages * kTile;
  uint64_t* bar = reinterpret_cast<uint64_t*>(sStats + kStages * kStatsBytes);  // [0] K, V; [1 + s] stage s

  const int nbh = p.b * p.hq;
  const int kt = (int)blockIdx.x / nbh, bh = (int)blockIdx.x % nbh;
  const int b = bh / p.hq, h = bh % p.hq, hk = h / (p.hq / p.hkv);
  const int k0 = tile_base(p.sk) + kRows * kt, qbase = tile_base(p.sq);
  int t_lo, t_hi;
  query_tiles(p, k0, &t_lo, &t_hi);
  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int i = 0; i <= kStages; ++i) bar_init(bar + i);
    bar_init_fence();
  }
  __syncthreads();
  if (tid == 0) {
    bar_expect(bar, 2 * kTile);
    load_tile<D>(sK, tm_k, hk, k0, b, bar);
    load_tile<D>(sV, tm_v, hk, k0, b, bar);
    for (int s = 0; s < kStages && t_lo + s < t_hi; ++s) {
      const int q0 = qbase + kRows * (t_lo + s);
      bar_expect(bar + 1 + s, 2 * kTile + kStatsBytes);
      load_tile<D>(sQ + s * kTile, tm_q, h, q0, b, bar + 1 + s);
      load_tile<D>(sdO + s * kTile, tm_do, h, q0, b, bar + 1 + s);
      tma_stats(sStats + s * kStatsBytes, tm_stats, q0, bh, bar + 1 + s);
    }
  }
  const int lane = tid % 32, r0 = 16 * (tid / 32) + lane / 4, c0 = 2 * (lane % 4);
  float dk[kSub][32], dv[kSub][32];
#pragma unroll
  for (int c = 0; c < kSub; ++c)
#pragma unroll
    for (int e = 0; e < 32; ++e) dk[c][e] = dv[c][e] = 0.f;
  bar_wait(bar, 0);

  for (int t = t_lo; t < t_hi; ++t) {
    const int it = t - t_lo, stage = it % kStages, q0 = qbase + kRows * t;
    bar_wait(bar + 1 + stage, (it / kStages) & 1);
    const uint8_t* q_tile = sQ + stage * kTile;
    const uint8_t* do_tile = sdO + stage * kTile;
    const float4* stats = reinterpret_cast<const float4*>(sStats + stage * kStatsBytes);
    float s[32], dp[32];  // S^T and dP^T: rows are keys, columns queries
    wgmma_fence();
    mma_nt<D>(s, sK, q_tile);
    mma_nt<D>(dp, sV, do_tile);
    wgmma_commit();
    wgmma_wait();
    fence_regs(s);
    fence_regs(dp);

    const bool full = tile_full(p, q0, k0);
    int lo_col[2], hi_col[2];  // the query columns that keys r0 and r0 + 8 see
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      seeing_queries(p, k0 + r0 + 8 * r, q0, &lo_col[r], &hi_col[r]);
      lo_col[r] -= c0;
      hi_col[r] -= c0;
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float4 st[2] = {stats[8 * j + c0], stats[8 * j + c0 + 1]};  // of this thread's two queries
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int e = 4 * j + u, r = (e >> 1) & 1, col = acc_col(e);
        const float lse2 = st[u & 1].x, di = st[u & 1].y;
        float pv = ex2(fmaf(s[e], p.scale_log2, -lse2));
        if (!full && (col < lo_col[r] || col > hi_col[r])) pv = 0.f;
        s[e] = pv;
        dp[e] = pv * (dp[e] - di);
      }
    }
    uint32_t hi[4][4], lo[4][4];
    split(s, hi, lo);
    fence_regs(hi);
    fence_regs(lo);
    wgmma_fence();
    mma_split<D>(dv, hi, lo, do_tile);  // dV += P^T dO
    uint32_t dhi[4][4], dlo[4][4];
    split(dp, dhi, dlo);
    fence_regs(dhi);
    fence_regs(dlo);
    wgmma_fence();
    mma_split<D>(dk, dhi, dlo, q_tile);  // dK += dS^T Q
    wgmma_commit();
    wgmma_wait();
#pragma unroll
    for (int c = 0; c < kSub; ++c) {
      fence_regs(dk[c]);
      fence_regs(dv[c]);
    }
    __syncthreads();  // the stage is read
    if (tid == 0 && t + kStages < t_hi) {
      const int qn = qbase + kRows * (t + kStages);
      async_proxy_fence();
      bar_expect(bar + 1 + stage, 2 * kTile + kStatsBytes);
      load_tile<D>(sQ + stage * kTile, tm_q, h, qn, b, bar + 1 + stage);
      load_tile<D>(sdO + stage * kTile, tm_do, h, qn, b, bar + 1 + stage);
      tma_stats(sStats + stage * kStatsBytes, tm_stats, qn, bh, bar + 1 + stage);
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int kj = k0 + r0 + 8 * r;
    if (kj < 0) continue;
    float* dk_row = p.dk_part + ((size_t)bh * p.sk + kj) * D;
    float* dv_row = p.dv_part + ((size_t)bh * p.sk + kj) * D;
#pragma unroll
    for (int c = 0; c < kSub; ++c)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int e = 4 * j + 2 * r, col = 64 * c + 8 * j + c0;
        if (64 * c + 8 * j >= D) continue;
        *reinterpret_cast<float2*>(dk_row + col) = make_float2(dk[c][e], dk[c][e + 1]);
        *reinterpret_cast<float2*>(dv_row + col) = make_float2(dv[c][e], dv[c][e + 1]);
      }
  }
}

// dK = scale * (sum of the group's dK_h), dV = sum of the group's dV_h, the
// heads added in a fixed order: the same bits on every run. One thread per
// four elements of (B, Sk, Hkv, D).
template <int D>
__global__ void __launch_bounds__(256) flash_bwd_reduce_kernel(const Params p) {
  const size_t i = (size_t)blockIdx.x * 256 + threadIdx.x;
  if (i >= (size_t)p.b * p.sk * p.hkv * (D / 4)) return;
  const int c = (int)(i % (D / 4)) * 4;
  size_t rest = i / (D / 4);
  const int hk = (int)(rest % p.hkv);
  rest /= p.hkv;
  const int kj = (int)(rest % p.sk), b = (int)(rest / p.sk), group = p.hq / p.hkv;
  float4 sk = make_float4(0.f, 0.f, 0.f, 0.f), sv = sk;
  for (int g = 0; g < group; ++g) {
    const size_t src = (((size_t)b * p.hq + hk * group + g) * p.sk + kj) * D + c;
    const float4 x = *reinterpret_cast<const float4*>(p.dk_part + src);
    const float4 y = *reinterpret_cast<const float4*>(p.dv_part + src);
    sk.x += x.x; sk.y += x.y; sk.z += x.z; sk.w += x.w;
    sv.x += y.x; sv.y += y.y; sv.z += y.z; sv.w += y.w;
  }
  uint32_t* dk = reinterpret_cast<uint32_t*>(p.dk + 4 * i);
  uint32_t* dv = reinterpret_cast<uint32_t*>(p.dv + 4 * i);
  dk[0] = bf16x2(__fmul_rn(sk.x, p.scale), __fmul_rn(sk.y, p.scale));
  dk[1] = bf16x2(__fmul_rn(sk.z, p.scale), __fmul_rn(sk.w, p.scale));
  dv[0] = bf16x2(sv.x, sv.y);
  dv[1] = bf16x2(sv.z, sv.w);
}

// dQ: one block per (batch x query head, 64-query tile), as the forward.
// Q, dO and their stats are loaded once; K and V stream through the ring.
template <int D>
__global__ void __launch_bounds__(kThreads, 2)
    flash_bwd_dq_tc_kernel(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
                           const __grid_constant__ CUtensorMap tm_v, const __grid_constant__ CUtensorMap tm_do,
                           const __grid_constant__ CUtensorMap tm_stats, const Params p) {
  constexpr int kSub = subtiles(D), kTile = kSub * kSubBytes;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sQ = align_1k(smem_raw);
  uint8_t* sdO = sQ + kTile;
  uint8_t* sStats = sdO + kTile;
  uint8_t* sK = sStats + kStatsBytes;
  uint8_t* sV = sK + kStages * kTile;
  uint64_t* bar = reinterpret_cast<uint64_t*>(sV + kStages * kTile);  // [0] Q, dO, stats; [1 + s] stage s

  const int nbh = p.b * p.hq;
  const int qt = cdiv(p.sq, kRows) - 1 - (int)blockIdx.x / nbh, bh = (int)blockIdx.x % nbh;
  const int b = bh / p.hq, h = bh % p.hq, hk = h / (p.hq / p.hkv);
  const int q0 = tile_base(p.sq) + kRows * qt, kbase = tile_base(p.sk);
  int t_lo, t_hi;
  key_tiles(p, q0, q0 + kRows - 1, &t_lo, &t_hi);
  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int i = 0; i <= kStages; ++i) bar_init(bar + i);
    bar_init_fence();
  }
  __syncthreads();
  if (tid == 0) {
    bar_expect(bar, 2 * kTile + kStatsBytes);
    load_tile<D>(sQ, tm_q, h, q0, b, bar);
    load_tile<D>(sdO, tm_do, h, q0, b, bar);
    tma_stats(sStats, tm_stats, q0, bh, bar);
    for (int s = 0; s < kStages && t_lo + s < t_hi; ++s) {
      bar_expect(bar + 1 + s, 2 * kTile);
      load_tile<D>(sK + s * kTile, tm_k, hk, kbase + kRows * (t_lo + s), b, bar + 1 + s);
      load_tile<D>(sV + s * kTile, tm_v, hk, kbase + kRows * (t_lo + s), b, bar + 1 + s);
    }
  }
  const int lane = tid % 32, r0 = 16 * (tid / 32) + lane / 4, c0 = 2 * (lane % 4);
  float dq[kSub][32];
#pragma unroll
  for (int c = 0; c < kSub; ++c)
#pragma unroll
    for (int e = 0; e < 32; ++e) dq[c][e] = 0.f;
  bar_wait(bar, 0);
  float lse2[2], di[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float4 st = reinterpret_cast<const float4*>(sStats)[r0 + 8 * r];
    lse2[r] = st.x;
    di[r] = st.y;
  }

  for (int t = t_lo; t < t_hi; ++t) {
    const int it = t - t_lo, stage = it % kStages, k0 = kbase + kRows * t;
    bar_wait(bar + 1 + stage, (it / kStages) & 1);
    const uint8_t* k_tile = sK + stage * kTile;
    const uint8_t* v_tile = sV + stage * kTile;
    float s[32], dp[32];
    wgmma_fence();
    mma_nt<D>(s, sQ, k_tile);
    mma_nt<D>(dp, sdO, v_tile);
    wgmma_commit();
    wgmma_wait();
    fence_regs(s);
    fence_regs(dp);

    const bool full = tile_full(p, q0, k0);
    int lo_col[2], hi_col[2];  // the key columns that queries r0 and r0 + 8 see
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      seen_keys(p, q0 + r0 + 8 * r, k0, &lo_col[r], &hi_col[r]);
      lo_col[r] -= c0;
      hi_col[r] -= c0;
    }
#pragma unroll
    for (int e = 0; e < 32; ++e) {
      const int r = (e >> 1) & 1, col = acc_col(e);
      float pv = ex2(fmaf(s[e], p.scale_log2, -lse2[r]));
      if (!full && (col < lo_col[r] || col > hi_col[r])) pv = 0.f;
      dp[e] = pv * (dp[e] - di[r]);
    }
    uint32_t hi[4][4], lo[4][4];
    split(dp, hi, lo);
    fence_regs(hi);
    fence_regs(lo);
    wgmma_fence();
    mma_split<D>(dq, hi, lo, k_tile);  // dQ += dS K
    wgmma_commit();
    wgmma_wait();
#pragma unroll
    for (int c = 0; c < kSub; ++c) fence_regs(dq[c]);
    __syncthreads();  // the stage is read
    if (tid == 0 && t + kStages < t_hi) {
      bar_expect(bar + 1 + stage, 2 * kTile);
      load_tile<D>(sK + stage * kTile, tm_k, hk, kbase + kRows * (t + kStages), b, bar + 1 + stage);
      load_tile<D>(sV + stage * kTile, tm_v, hk, kbase + kRows * (t + kStages), b, bar + 1 + stage);
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qi = q0 + r0 + 8 * r;
    if (qi < 0) continue;
    __nv_bfloat16* dst = p.dq + ((size_t)(b * p.sq + qi) * p.hq + h) * D;
#pragma unroll
    for (int c = 0; c < kSub; ++c)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int e = 4 * j + 2 * r;
        if (64 * c + 8 * j < D)
          *reinterpret_cast<uint32_t*>(dst + 64 * c + 8 * j + c0) =
              bf16x2(__fmul_rn(dq[c][e], p.scale), __fmul_rn(dq[c][e + 1], p.scale));
      }
  }
}

// -- host side --

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*, const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, fetched from the driver at run time (no -lcuda).
EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err =
        cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &ptr, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess) fn = reinterpret_cast<EncodeTiled>(ptr);
  }
  return fn;
}

cudaError_t encode(CUtensorMap* map, CUtensorMapDataType type, cuuint32_t rank, const void* base,
                   const cuuint64_t* dims, const cuuint64_t* strides, const cuuint32_t* box,
                   CUtensorMapSwizzle swizzle) {
  const EncodeTiled fn = encoder();
  if (fn == nullptr) return cudaErrorNotSupported;
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult res = fn(map, type, rank, const_cast<void*>(base), dims, strides, box, unit,
                          CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                          CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// 64-row x 64-column boxes of one head of a (B, S, H, D) bf16 tensor,
// 128-byte swizzled; rows outside [0, S) read as zeros.
cudaError_t rows_map(CUtensorMap* map, const void* base, int b, int s, int h, int d) {
  const cuuint64_t dims[4] = {(cuuint64_t)d, (cuuint64_t)h, (cuuint64_t)s, (cuuint64_t)b};
  const cuuint64_t strides[3] = {(cuuint64_t)d * 2, (cuuint64_t)h * d * 2, (cuuint64_t)s * h * d * 2};
  const cuuint32_t box[4] = {64, 1, kRows, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, base, dims, strides, box, CU_TENSOR_MAP_SWIZZLE_128B);
}

// The stats of 64 query rows of one (batch x head); rows outside [0, Sq)
// read as zeros.
cudaError_t stats_map(CUtensorMap* map, const Params& p) {
  const cuuint64_t dims[3] = {4, (cuuint64_t)p.sq, (cuuint64_t)p.b * p.hq};
  const cuuint64_t strides[2] = {16, (cuuint64_t)p.sq * 16};
  const cuuint32_t box[3] = {4, kRows, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, p.stats, dims, strides, box, CU_TENSOR_MAP_SWIZZLE_NONE);
}

constexpr size_t tile_bytes(int d) { return (size_t)subtiles(d) * kSubBytes; }
constexpr size_t kBarBytes = 8 * (1 + kStages);
constexpr size_t fwd_smem(int d) {
  return 1024 + (1 + 2 * kStages) * tile_bytes(d) + 8 * (1 + 4 * kStages);
}
constexpr size_t dkdv_smem(int d) {
  return 1024 + (2 + 2 * kStages) * tile_bytes(d) + kStages * kStatsBytes + kBarBytes;
}
constexpr size_t dq_smem(int d) { return 1024 + (2 + 2 * kStages) * tile_bytes(d) + kStatsBytes + kBarBytes; }

template <typename Kernel, typename... Args>
cudaError_t launch(Kernel kernel, int blocks, int threads, size_t smem, cudaStream_t stream, const Args&... args) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<blocks, threads, smem, stream>>>(args...);
  return cudaGetLastError();
}

Params make_params(int b, int sq, int sk, int hq, int hkv, int causal, int window, float scale) {
  Params p = {};
  p.b = b;
  p.sq = sq;
  p.sk = sk;
  p.hq = hq;
  p.hkv = hkv;
  p.causal = causal;
  p.window = window;
  p.scale = scale;
  p.scale_log2 = scale * kLog2e;
  return p;
}

template <int D>
cudaError_t forward(const Params& p, const void* q, const void* k, const void* v, cudaStream_t stream) {
  CUtensorMap tq, tk, tv;
  cudaError_t err = rows_map(&tq, q, p.b, p.sq, p.hq, D);
  if (err == cudaSuccess) err = rows_map(&tk, k, p.b, p.sk, p.hkv, D);
  if (err == cudaSuccess) err = rows_map(&tv, v, p.b, p.sk, p.hkv, D);
  if (err != cudaSuccess) return err;
  return launch(flash_fwd_tc_kernel<D>, cdiv(p.sq, kRows) * p.b * p.hq, kFwdThreads, fwd_smem(D), stream,
                tq, tk, tv, p);
}

template <int D>
cudaError_t backward(const Params& p, const void* q, const void* k, const void* v, cudaStream_t stream) {
  const int rows = p.b * p.sq * p.hq;
  flash_bwd_stats_kernel<D><<<cdiv(rows, 8), 256, 0, stream>>>(p);
  cudaError_t err = cudaGetLastError();
  CUtensorMap tq, tk, tv, tdo, tstats;
  if (err == cudaSuccess) err = rows_map(&tq, q, p.b, p.sq, p.hq, D);
  if (err == cudaSuccess) err = rows_map(&tk, k, p.b, p.sk, p.hkv, D);
  if (err == cudaSuccess) err = rows_map(&tv, v, p.b, p.sk, p.hkv, D);
  if (err == cudaSuccess) err = rows_map(&tdo, p.d_o, p.b, p.sq, p.hq, D);
  if (err == cudaSuccess) err = stats_map(&tstats, p);
  if (err != cudaSuccess) return err;
  err = launch(flash_bwd_dkdv_tc_kernel<D>, cdiv(p.sk, kRows) * p.b * p.hq, kThreads, dkdv_smem(D), stream, tq, tk, tv,
               tdo, tstats, p);
  if (err != cudaSuccess) return err;
  const size_t quads = (size_t)p.b * p.sk * p.hkv * (D / 4);
  flash_bwd_reduce_kernel<D><<<(unsigned)((quads + 255) / 256), 256, 0, stream>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return launch(flash_bwd_dq_tc_kernel<D>, cdiv(p.sq, kRows) * p.b * p.hq, kThreads, dq_smem(D), stream, tq, tk, tv, tdo,
                tstats, p);
}

}  // namespace tc

}  // namespace

extern "C" {

// Whether the route of dtype (0 float32 on the CUDA cores, 1 bfloat16 on the
// tensor cores) takes head_dim d: both take 64 and 128, bf16 also 80.
static bool takes(int d, int dtype) {
  return (dtype == 0 && (d == 64 || d == 128)) || (dtype == 1 && (d == 64 || d == 80 || d == 128));
}

// dtype: 0 float32 (CUDA cores), 1 bfloat16 (tensor cores); head_dim as
// takes() (checked by the caller).
int flash_attention_fwd(const void* q, const void* k, const void* v, void* out, float* lse, int b,
                        int sq, int sk, int hq, int hkv, int d, int dtype, int causal, int window,
                        float scale, cudaStream_t stream) {
  if (!takes(d, dtype)) return cudaErrorInvalidValue;
  if (dtype == 1) {
    tc::Params p = tc::make_params(b, sq, sk, hq, hkv, causal, window, scale);
    p.out = static_cast<__nv_bfloat16*>(out);
    p.lse = lse;
    return d == 64 ? tc::forward<64>(p, q, k, v, stream)
           : d == 80 ? tc::forward<80>(p, q, k, v, stream)
                     : tc::forward<128>(p, q, k, v, stream);
  }
  Params p = make_params(q, k, v, b, sq, sk, hq, hkv, causal, window, scale);
  p.out = out;
  p.lse = lse;
  return d == 64 ? forward<64>(p, stream) : forward<128>(p, stream);
}

// workspace: f32 scratch, as kernel.py allocates it. dtype 0: Di (B, Hq,
// Sq). dtype 1: the stats (B, Hq, Sq, 4), then each query head's dK and dV,
// (B, Hq, Sk, D) each.
int flash_attention_bwd(const void* q, const void* k, const void* v, const void* o, const void* d_o,
                        const float* lse, float* workspace, void* dq, void* dk, void* dv, int b, int sq,
                        int sk, int hq, int hkv, int d, int dtype, int causal, int window, float scale,
                        cudaStream_t stream) {
  if (!takes(d, dtype)) return cudaErrorInvalidValue;
  if (dtype == 1) {
    tc::Params p = tc::make_params(b, sq, sk, hq, hkv, causal, window, scale);
    p.lse = const_cast<float*>(lse);
    p.o = static_cast<const __nv_bfloat16*>(o);
    p.d_o = static_cast<const __nv_bfloat16*>(d_o);
    p.stats = workspace;
    p.dk_part = workspace + (size_t)b * hq * sq * 4;
    p.dv_part = p.dk_part + (size_t)b * hq * sk * d;
    p.dq = static_cast<__nv_bfloat16*>(dq);
    p.dk = static_cast<__nv_bfloat16*>(dk);
    p.dv = static_cast<__nv_bfloat16*>(dv);
    return d == 64 ? tc::backward<64>(p, q, k, v, stream)
           : d == 80 ? tc::backward<80>(p, q, k, v, stream)
                     : tc::backward<128>(p, q, k, v, stream);
  }
  Params p = make_params(q, k, v, b, sq, sk, hq, hkv, causal, window, scale);
  p.o = o;
  p.d_o = d_o;
  p.lse = const_cast<float*>(lse);
  p.delta = workspace;
  p.dq = dq;
  p.dk = dk;
  p.dv = dv;
  return d == 64 ? backward<64>(p, stream) : backward<128>(p, stream);
}

}  // extern "C"
