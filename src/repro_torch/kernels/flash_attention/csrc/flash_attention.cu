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
// What bounds it on this card: at the training shapes (S ~ 512, D = 128)
// the forward moves ~19 MB and does ~1 GFLOP: on the tensor cores it would
// be bound by bytes. This first version computes with f32 FMAs on the CUDA
// cores, so it is bound by those operations, far above its bound; mma/wgmma
// tiles and TMA loads are later work.
//
// Design. The TPU kernel walks a sequential key-block grid axis and keeps
// the running max, sum and output in VMEM scratch. Blocks on this card run
// in no order, so one block of 256 threads takes a (batch x query head,
// 64-query tile) and loops over its 64-key tiles itself, keeping the output
// accumulator, the running max and the running sum in registers. Key tiles
// wholly past the causal or window edge are skipped, not masked; the ragged
// edge of any S is masked. Tiles are staged through shared memory in f32
// (rows padded by 4 floats, so that the 16-byte reads of 8 neighbouring
// rows fall on distinct banks). A thread owns a 4 x 4 block of each 64 x 64
// score tile (rows ty + 16 i, columns tx + 16 j) and 4 rows x D/16 columns
// of the output.
//
// The backward, with no atomics, so that gradients are the same bit for bit
// from run to run:
//   delta:  Di = rowsum(dO * O), one warp per row;
//   dK, dV: one block per (batch x KV head, 64-key tile) accumulates over the
//           group's query heads and every query tile that sees the keys:
//           P = exp(S - lse), dV += P^T dO, dP = dO V^T, dS = P (dP - Di),
//           dK += dS^T Q;
//   dQ:     one block per (batch x query head, 64-query tile) accumulates
//           dQ += dS K over the key tiles the queries see.
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

__device__ __forceinline__ void load16(const float* src, float* dst) {
  *reinterpret_cast<float4*>(dst) = *reinterpret_cast<const float4*>(src);
}

__device__ __forceinline__ void load16(const __nv_bfloat16* src, float* dst) {
  const uint4 raw = *reinterpret_cast<const uint4*>(src);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    dst[2 * i] = f.x;
    dst[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ void store(float* dst, float x) { *dst = x; }
__device__ __forceinline__ void store(__nv_bfloat16* dst, float x) { *dst = __float2bfloat16_rn(x); }
__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

// Rows [row0, row0 + 64) of a (.., S, H, D) operand, starting at ``base``
// (the first row of one (batch, head)), into ``sm`` as f32 with row stride
// D + 4; rows at or past ``rows`` are zero.
template <typename T, int D>
__device__ void load_tile(float* sm, const T* base, int row0, int rows, int row_stride) {
  constexpr int kPer = 16 / sizeof(T);  // elements per 16-byte load
  constexpr int kChunks = D / kPer;
  for (int i = threadIdx.x; i < kTile * kChunks; i += kThreads) {
    const int r = i / kChunks, c = (i % kChunks) * kPer;
    float* dst = sm + r * (D + 4) + c;
    if (row0 + r < rows) {
      load16(base + (size_t)(row0 + r) * row_stride + c, dst);
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
template <typename T, int D>
__device__ void store_rows(T* base, int row0, int rows, int row_stride, const float (&acc)[4][D / 64][4],
                           float mul, int ty, int tx) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = row0 + ty + 16 * i;
    if (r >= rows) continue;
    T* dst = base + (size_t)r * row_stride;
#pragma unroll
    for (int c = 0; c < D / 64; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) store(dst + 4 * tx + 64 * c + e, __fmul_rn(acc[i][c][e], mul));
  }
}

template <typename T, int D>
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
  const T* qb = static_cast<const T*>(p.q) + ((size_t)b * p.sq * p.hq + h) * D;
  const T* kb = static_cast<const T*>(p.k) + ((size_t)b * p.sk * p.hkv + hk) * D;
  const T* vb = static_cast<const T*>(p.v) + ((size_t)b * p.sk * p.hkv + hk) * D;
  load_tile<T, D>(Qs, qb, q0, p.sq, p.hq * D);

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
    load_tile<T, D>(Ks, kb, k0, p.sk, p.hkv * D);
    load_tile<T, D>(Vs, vb, k0, p.sk, p.hkv * D);
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

  T* ob = static_cast<T*>(p.out) + ((size_t)b * p.sq * p.hq + h) * D;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = q0 + ty + 16 * i;
    if (qi >= p.sq) continue;
    const float denom = fmaxf(l[i], 1e-30f);
    T* dst = ob + (size_t)qi * p.hq * D;
#pragma unroll
    for (int c = 0; c < D / 64; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) store(dst + 4 * tx + 64 * c + e, __fdiv_rn(acc[i][c][e], denom));
    if (tx == 0) p.lse[(size_t)bh * p.sq + qi] = l[i] > 0.f ? m[i] + logf(l[i]) : -INFINITY;
  }
}

// Di = rowsum(dO * O) in f32, one warp per (batch, query, head) row.
template <typename T, int D>
__global__ void __launch_bounds__(kThreads) flash_bwd_delta_kernel(Params p) {
  const int row = blockIdx.x * (kThreads / 32) + threadIdx.x / 32, lane = threadIdx.x % 32;
  if (row >= p.b * p.sq * p.hq) return;
  const T* o = static_cast<const T*>(p.o) + (size_t)row * D;
  const T* d_o = static_cast<const T*>(p.d_o) + (size_t)row * D;
  float acc = 0.f;
  for (int d = lane; d < D; d += 32) acc = fmaf(to_float(o[d]), to_float(d_o[d]), acc);
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

template <typename T, int D>
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
  load_tile<T, D>(Ks, static_cast<const T*>(p.k) + kv_off, k0, p.sk, p.hkv * D);
  load_tile<T, D>(Vs, static_cast<const T*>(p.v) + kv_off, k0, p.sk, p.hkv * D);

  float dk[4][D / 64][4] = {}, dv[4][D / 64][4] = {};
  int t_lo, t_hi;
  query_range(p, k0, &t_lo, &t_hi);
  for (int g = 0; g < group; ++g) {
    const int h = hk * group + g, bh = b * p.hq + h;
    const size_t q_off = ((size_t)b * p.sq * p.hq + h) * D;
    for (int t = t_lo; t < t_hi; ++t) {
      const int q0 = t * kTile;
      __syncthreads();  // the previous tile's Q, dO, P^T and dS^T are no longer read
      load_tile<T, D>(Qs, static_cast<const T*>(p.q) + q_off, q0, p.sq, p.hq * D);
      load_tile<T, D>(dOs, static_cast<const T*>(p.d_o) + q_off, q0, p.sq, p.hq * D);
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
  store_rows<T, D>(static_cast<T*>(p.dk) + kv_off, k0, p.sk, p.hkv * D, dk, p.scale, ty, tx);
  store_rows<T, D>(static_cast<T*>(p.dv) + kv_off, k0, p.sk, p.hkv * D, dv, 1.f, ty, tx);
}

template <typename T, int D>
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
  load_tile<T, D>(Qs, static_cast<const T*>(p.q) + q_off, q0, p.sq, p.hq * D);
  load_tile<T, D>(dOs, static_cast<const T*>(p.d_o) + q_off, q0, p.sq, p.hq * D);
  load_rows_stats(p, bh, q0, lse_s, delta_s);

  float dq[4][D / 64][4] = {};
  int t_lo, t_hi;
  key_range(p, q0, &t_lo, &t_hi);
  for (int t = t_lo; t < t_hi; ++t) {
    const int k0 = t * kTile;
    __syncthreads();
    load_tile<T, D>(Ks, static_cast<const T*>(p.k) + kv_off, k0, p.sk, p.hkv * D);
    load_tile<T, D>(Vs, static_cast<const T*>(p.v) + kv_off, k0, p.sk, p.hkv * D);
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
  store_rows<T, D>(static_cast<T*>(p.dq) + q_off, q0, p.sq, p.hq * D, dq, p.scale, ty, tx);
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

template <typename T, int D>
cudaError_t forward(const Params& p, cudaStream_t stream) {
  const dim3 grid((p.sq + kTile - 1) / kTile, p.b * p.hq);
  return launch(flash_fwd_kernel<T, D>, grid, fwd_smem(D), stream, p);
}

template <typename T, int D>
cudaError_t backward(const Params& p, cudaStream_t stream) {
  const int rows = p.b * p.sq * p.hq, warps = kThreads / 32;
  flash_bwd_delta_kernel<T, D><<<(rows + warps - 1) / warps, kThreads, 0, stream>>>(p);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  err = launch(flash_bwd_dkdv_kernel<T, D>, dim3((p.sk + kTile - 1) / kTile, p.b * p.hkv),
               dkdv_smem(D), stream, p);
  if (err != cudaSuccess) return err;
  return launch(flash_bwd_dq_kernel<T, D>, dim3((p.sq + kTile - 1) / kTile, p.b * p.hq),
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

}  // namespace

extern "C" {

// dtype: 0 float32, 1 bfloat16; head_dim 64 or 128 (checked by the caller).
int flash_attention_fwd(const void* q, const void* k, const void* v, void* out, float* lse, int b,
                        int sq, int sk, int hq, int hkv, int d, int dtype, int causal, int window,
                        float scale, cudaStream_t stream) {
  Params p = make_params(q, k, v, b, sq, sk, hq, hkv, causal, window, scale);
  p.out = out;
  p.lse = lse;
  if (dtype == 0) return d == 64 ? forward<float, 64>(p, stream) : forward<float, 128>(p, stream);
  return d == 64 ? forward<__nv_bfloat16, 64>(p, stream) : forward<__nv_bfloat16, 128>(p, stream);
}

int flash_attention_bwd(const void* q, const void* k, const void* v, const void* o, const void* d_o,
                        const float* lse, float* delta, void* dq, void* dk, void* dv, int b, int sq,
                        int sk, int hq, int hkv, int d, int dtype, int causal, int window, float scale,
                        cudaStream_t stream) {
  Params p = make_params(q, k, v, b, sq, sk, hq, hkv, causal, window, scale);
  p.o = o;
  p.d_o = d_o;
  p.lse = const_cast<float*>(lse);
  p.delta = delta;
  p.dq = dq;
  p.dk = dk;
  p.dv = dv;
  if (dtype == 0) return d == 64 ? backward<float, 64>(p, stream) : backward<float, 128>(p, stream);
  return d == 64 ? backward<__nv_bfloat16, 64>(p, stream) : backward<__nv_bfloat16, 128>(p, stream);
}

}  // extern "C"
