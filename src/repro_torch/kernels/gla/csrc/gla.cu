// Chunked gated linear attention (GLA), forward and backward, on Hopper
// (sm_90a). Bound by a plain C interface and ctypes (kernel.py).
//
// Replaces the Pallas TPU kernel gla_chunked_bh (_gla_kernel) in
// src/repro/kernels/gla/kernel.py, which is forward only. The backward has
// no TPU counterpart (the JAX package differentiates its gla_scan): the
// training path needs a gradient through the forward, so it is hand-written
// too.
//
// Layout: q, k (B, S, H, 64), v (B, S, H, 64), all of one type (f32 or
// bf16), contiguous; log_w (B, S, H, 64) f32, <= 0; the optional RWKV6 bonus
// u (H, 64) f32; states (B, H, 64, 64) f32. Per (batch, head) and chunk of
// 64 positions, with W the inclusive prefix sum of log_w along the chunk and
// E the exponent with which a row reads (E = W when the current token is
// included, Mamba2; E[t] = W[t-1], W[-1] = 0, when it is not, RWKV6):
//   A[t,u] = sum_c q[t,c] k[u,c] exp(E[t,c] - W[u,c])   over u <= t (u < t)
//   y      = A v + (q * exp(E)) S_n + (sum_c q u k)[t] v[t]  (bonus: RWKV6 only)
//   S_{n+1} = S_n * exp(W_Q) + (k * exp(W_Q - W))^T v    (W_Q = W at the chunk's end)
//
// Every exponent evaluated is <= 0. Masked (t, u) pairs are never
// exponentiated, or are -inf before the exp; no decay is factored as
// exp(E) * exp(-W), which overflows under strong decay. A pair in two
// different 16-row sub-chunks is split at a reference row r between them,
// u <= r <= E's row of t: exp(E[t] - W[u]) = exp(E[t] - W[r]) exp(W[r] - W[u]),
// two factors <= 1. This is why the chunked form is a kernel.
//
// Two routes, by type.
//
// bf16 (the model's training and serving path): chunk-parallel passes,
// every 64 x 64 and 16 x 16 product on the tensor cores (mma.sync
// m16n8k16, HMMA), tiles staged in shared memory by cp.async.
//   Forward: (1) local pass, one block per (batch, head, chunk): the chunk's
//   (k exp(W_Q - W))^T v and W_Q; (2) state pass, a thread per four state
//   elements, the scan S_{n+1} = S_n exp(W_Q) + that, in place, leaving each
//   chunk's start state S_n and the final state; (3) output pass, one block
//   per (batch, head, chunk), warp i owning rows 16 i .. 16 i + 15: A's
//   off-diagonal blocks as (q exp(E - W[r])) (k exp(W[r] - W))^T with
//   r = 16 i - 1; each 16 x 16 diagonal block cut again at row 8, its
//   lower-left 8 x 8 block a product from r = 16 i + 7 and its two 8 x 8
//   diagonal blocks with one exp a visible (t, u, channel) term (a lane per
//   (t, u) pair); then y = A v + (q exp(E)) S_n + bonus. S_n and A go to the
//   chunk's slot of the states buffer, which the backward reads.
//   Backward: (1) local pass: (q exp(E))^T dy per chunk; (2) reverse scan
//   dS_n = dS_{n+1} exp(W_Q) + that (ds0 after chunk 0), with dW_Q =
//   rowsum(dS_{n+1} S_{n+1}); (3) chunk pass, warp i owning rows 16 i ..
//   16 i + 15 of dq (as t) and of dk, dv (as u):
//     dq = exp(E - W[r]) (dA k exp(W[r] - W) + exp(W[r]) dy S_n^T),  r = 16 i - 1;
//     dk = exp(W[p] - W) (dA^T q exp(E - W[p]) + exp(W_Q - W[p]) v dS^T),  p = 16 i + 15;
//     dv = A^T dy + (k exp(W_Q - W)) dS + bonus,
//   with dA = dy v^T masked, A the forward's, S_n read from L2 into the
//   fragments and dS staged. On the diagonal blocks each decay
//   exp(E[t,c] - W[u,c]) is formed once, by the lane that owns channel c
//   (k and W of the block's 16 rows in registers, dA broadcast from shared
//   memory), for dq and dk alike. dE = q dq, dW = -k dk and dlog_w[s] =
//   dW_Q + sum_{t >= s} (dW[t] + dE[t], or dE[t+1]) by reverse prefix sums;
//   du one partial per (batch, head, chunk), then summed in a fixed order
//   (4). No atomics: the gradients are the same bits every run.
//   Precision: the decayed operands (q and k times decays, A, dA, S, dS)
//   are f32, split into bf16 hi + lo: hi hi + hi lo + lo hi against another
//   split operand, hi b + lo b against an exact bf16 one (q, k, v, dy).
//   Every such product is split so; sums are f32. W is held in base 2
//   (log_w log2 e), so each decay is one ex2. Each host entry point
//   launches its passes on the caller's stream, with the caller's scratch.
//
// What bounds it on this card: at the training shape (B 4, S 513, H 32) the
// forward must move ~52 MB (~16 us at the HBM rate) and the backward ~100 MB
// (~30 us); their products are ~2.2 and ~4.8 GFLOP, far below the tensor
// cores' time. The passes re-read q, k, v and log_w, and the states go
// through L2 between passes (32 KB a chunk). Inside a block the time goes
// to the loads at its start, the diagonal blocks' exps (16 a clock on an
// SM) and instruction issue, with 4 warps a block and 3 blocks an SM
// (shared memory: output pass 64.5 KB, backward chunk pass 74 KB, local
// passes 34.5 KB). Loops whose unrolled copies would not fit the
// instruction cache stay rolled (the backward's warps once waited on
// instruction fetch in lockstep).
//
// f32 (the card-against-CPU checks): the first design, kept below: one block
// of 256 threads per (batch, head) walks its chunks in order with the f32
// state in shared memory and f32 FMAs on the CUDA cores; its backward walks
// them in reverse from the chunk-start states the forward saved.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kChunk = 64;                  // positions per chunk
constexpr int kDim = 64;                    // K = V
constexpr int kP = kDim + 1;                // row stride of a tile in shared memory (floats)
constexpr int kTile = kChunk * kP;          // floats of one 64 x 64 tile
constexpr int kFwdSmem = (6 * kTile + kChunk) * sizeof(float);
constexpr int kBwdSmem = (9 * kTile + 4 * kChunk) * sizeof(float);

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const float* log_w;
  const float* u;        // (H, K), or null: no bonus
  const float* s0;       // (B*H, K, V), or null: zeros
  void* y;
  float* s_final;        // (B*H, K, V): written by the forward, read by the backward
  float* states;         // (B*H, chunks, K, V) chunk-start states, or null
  const void* dy;
  const float* d_final;  // or null: zeros
  void* dq;
  void* dk;
  void* dv;
  float* dlog_w;
  float* du_part;        // (B*H, parts, K), or null: one partial per (batch, head[, chunk])
  float* du;             // (H, K): the partials summed in a fixed order
  float* ds0;            // (B*H, K, V), or null
  // the bf16 route's scratch: per chunk W_Q, the backward's dS slots, dW_Q
  float* wq;             // (B*H, chunks, K)
  float* dstates;        // (B*H, chunks, K, V)
  float* dwq;            // (B*H, chunks, K)
  int b, s, h, include_current;
};

// ---------------------------------------------------------------------------
// The f32 route: one block per (batch, head) walks its chunks in order, f32
// FMAs on the CUDA cores (f32 inputs need f32 products; the card-against-CPU
// checks run this route).
// ---------------------------------------------------------------------------
__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* dst, float x) { *dst = x; }
__device__ __forceinline__ void store(__nv_bfloat16* dst, float x) { *dst = __float2bfloat16_rn(x); }

// Rows t0 .. t0 + 63 of one (batch, head) into a tile, as f32; rows past
// the sequence read 0.
template <typename T>
__device__ void load_tile(float* sm, const T* src, long base, long row_stride, int t0, int len) {
  for (int i = threadIdx.x; i < kChunk * kDim; i += kThreads) {
    const int t = i / kDim, c = i % kDim;
    sm[t * kP + c] = t < len ? to_float(src[base + (t0 + t) * row_stride + c]) : 0.f;
  }
}

__device__ void load_state(float* sm, const float* src) {
  for (int i = threadIdx.x; i < kDim * kDim; i += kThreads)
    sm[(i / kDim) * kP + i % kDim] = src ? src[i] : 0.f;
}

__device__ void store_state(float* dst, const float* sm) {
  for (int i = threadIdx.x; i < kDim * kDim; i += kThreads) dst[i] = sm[(i / kDim) * kP + i % kDim];
}

// In place: the log_w tile becomes its inclusive prefix sum W along t, one
// thread per channel (threads 0..63).
__device__ void prefix_sum(float* sW) {
  const int c = threadIdx.x;
  float acc = 0.f;
  for (int t = 0; t < kChunk; ++t) {
    acc += sW[t * kP + c];
    sW[t * kP + c] = acc;
  }
}

// The exponent with which row t reads: W[t], or W[t-1] (0 for t = 0).
__device__ __forceinline__ float read_exp(const float* sW, int t, int c, int inc) {
  return inc ? sW[t * kP + c] : (t > 0 ? sW[(t - 1) * kP + c] : 0.f);
}

__device__ __forceinline__ bool visible(int t, int u, int inc) { return inc ? u <= t : u < t; }

// exp(E[t,c] - W[u,c]) where u is visible from t, else 0: masked to -inf
// before the exp, so no exponent above 0 is ever evaluated.
__device__ __forceinline__ float pair_decay(float e, float w, bool vis) {
  return __expf(vis ? e - w : -INFINITY);
}

// A[t,u] (rows ty + 16 i, columns tx + 16 j) of the chunk into sA.
__device__ void intra_scores(const float* sQ, const float* sK, const float* sW, float* sA, int inc) {
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  float acc[4][4] = {};
  for (int c = 0; c < kDim; ++c) {
    float qv[4], ev[4], kv[4], wv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      qv[i] = sQ[(ty + 16 * i) * kP + c];
      ev[i] = read_exp(sW, ty + 16 * i, c, inc);
      kv[i] = sK[(tx + 16 * i) * kP + c];
      wv[i] = sW[(tx + 16 * i) * kP + c];
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        acc[i][j] += qv[i] * kv[j] * pair_decay(ev[i], wv[j], visible(ty + 16 * i, tx + 16 * j, inc));
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) sA[(ty + 16 * i) * kP + tx + 16 * j] = acc[i][j];
}

template <typename T>
__global__ void __launch_bounds__(kThreads) gla_fwd_kernel(Params p) {
  extern __shared__ float smem[];
  float* sQ = smem;
  float* sK = sQ + kTile;
  float* sV = sK + kTile;
  float* sW = sV + kTile;
  float* sA = sW + kTile;
  float* sS = sA + kTile;
  float* sCoef = sS + kTile;  // (sum_c q u k)[t], the RWKV6 bonus
  const int bh = blockIdx.x, b = bh / p.h, hh = bh % p.h;
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int inc = p.include_current, chunks = (p.s + kChunk - 1) / kChunk;
  const long row_stride = (long)p.h * kDim, base = ((long)b * p.s * p.h + hh) * kDim;
  const float* u = p.u ? p.u + hh * kDim : nullptr;
  const long state_elems = (long)kDim * kDim;
  load_state(sS, p.s0 ? p.s0 + bh * state_elems : nullptr);

  for (int n = 0; n < chunks; ++n) {
    const int t0 = n * kChunk, len = min(kChunk, p.s - t0);
    __syncthreads();  // the previous chunk's state update is complete
    if (p.states) store_state(p.states + ((long)bh * chunks + n) * state_elems, sS);
    load_tile(sQ, static_cast<const T*>(p.q), base, row_stride, t0, len);
    load_tile(sK, static_cast<const T*>(p.k), base, row_stride, t0, len);
    load_tile(sV, static_cast<const T*>(p.v), base, row_stride, t0, len);
    load_tile(sW, p.log_w, base, row_stride, t0, len);
    __syncthreads();
    if (tid < kDim) {
      prefix_sum(sW);
    } else if (tid < kDim + kChunk) {
      const int t = tid - kDim;
      float coef = 0.f;
      if (u)
        for (int c = 0; c < kDim; ++c) coef += sQ[t * kP + c] * u[c] * sK[t * kP + c];
      sCoef[t] = coef;
    }
    __syncthreads();
    intra_scores(sQ, sK, sW, sA, inc);
    __syncthreads();
    // q <- q exp(E), k <- k exp(W_Q - W): both exponents <= 0
    for (int i = tid; i < kChunk * kDim; i += kThreads) {
      const int t = i / kDim, c = i % kDim;
      sQ[t * kP + c] *= __expf(read_exp(sW, t, c, inc));
      sK[t * kP + c] *= __expf(sW[(kChunk - 1) * kP + c] - sW[t * kP + c]);
    }
    __syncthreads();
    // y = A v + (q exp(E)) S + coef v
    {
      float acc[4][4] = {};
      for (int x = 0; x < kChunk; ++x) {
        float a[4], vv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          a[i] = sA[(ty + 16 * i) * kP + x];
          vv[i] = sV[x * kP + tx + 16 * i];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] += a[i] * vv[j];
      }
      for (int c = 0; c < kDim; ++c) {
        float qe[4], st[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          qe[i] = sQ[(ty + 16 * i) * kP + c];
          st[i] = sS[c * kP + tx + 16 * i];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] += qe[i] * st[j];
      }
      T* y = static_cast<T*>(p.y);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int t = ty + 16 * i;
        if (t >= len) continue;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int col = tx + 16 * j;
          store(y + base + (t0 + t) * row_stride + col, acc[i][j] + sCoef[t] * sV[t * kP + col]);
        }
      }
    }
    __syncthreads();
    // S <- S exp(W_Q) + (k exp(W_Q - W))^T v
    {
      float acc[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int c = ty + 16 * i;
          acc[i][j] = sS[c * kP + tx + 16 * j] * __expf(sW[(kChunk - 1) * kP + c]);
        }
      for (int x = 0; x < kChunk; ++x) {
        float kd[4], vv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          kd[i] = sK[x * kP + ty + 16 * i];
          vv[i] = sV[x * kP + tx + 16 * i];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] += kd[i] * vv[j];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) sS[(ty + 16 * i) * kP + tx + 16 * j] = acc[i][j];
    }
  }
  __syncthreads();
  store_state(p.s_final + bh * state_elems, sS);
}

template <typename T>
__global__ void __launch_bounds__(kThreads) gla_bwd_kernel(Params p) {
  extern __shared__ float smem[];
  float* sQ = smem;
  float* sK = sQ + kTile;
  float* sV = sK + kTile;
  float* sDY = sV + kTile;
  float* sW = sDY + kTile;
  float* sA = sW + kTile;    // A, then dE
  float* sDA = sA + kTile;   // dA, then dW
  float* sS = sDA + kTile;   // S_{n+1}, then S_n
  float* sDS = sS + kTile;   // the gradient of the state after the chunk
  float* sCoef = sDS + kTile;
  float* sDyv = sCoef + kChunk;  // dy[t] . v[t]
  float* sDWQ = sDyv + kChunk;   // gradient of W_Q, per channel
  float* sDU = sDWQ + kChunk;    // this (batch, head)'s du
  const int bh = blockIdx.x, b = bh / p.h, hh = bh % p.h;
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int inc = p.include_current, chunks = (p.s + kChunk - 1) / kChunk;
  const long row_stride = (long)p.h * kDim, base = ((long)b * p.s * p.h + hh) * kDim;
  const float* u = p.u ? p.u + hh * kDim : nullptr;
  const long state_elems = (long)kDim * kDim;
  const T* q = static_cast<const T*>(p.q);
  const T* k = static_cast<const T*>(p.k);
  const T* v = static_cast<const T*>(p.v);
  const T* dy = static_cast<const T*>(p.dy);
  load_state(sDS, p.d_final ? p.d_final + bh * state_elems : nullptr);
  if (tid < kDim) sDU[tid] = 0.f;

  for (int n = chunks - 1; n >= 0; --n) {
    const int t0 = n * kChunk, len = min(kChunk, p.s - t0);
    __syncthreads();  // the previous (later) chunk is complete
    load_tile(sQ, q, base, row_stride, t0, len);
    load_tile(sK, k, base, row_stride, t0, len);
    load_tile(sV, v, base, row_stride, t0, len);
    load_tile(sDY, dy, base, row_stride, t0, len);
    load_tile(sW, p.log_w, base, row_stride, t0, len);
    load_state(sS, n == chunks - 1 ? p.s_final + bh * state_elems
                                   : p.states + ((long)bh * chunks + n + 1) * state_elems);
    __syncthreads();
    if (tid < kDim) {
      prefix_sum(sW);
    } else if (tid < 2 * kDim) {
      const int t = tid - kDim;
      float dyv = 0.f, coef = 0.f;
      for (int c = 0; c < kDim; ++c) dyv += sDY[t * kP + c] * sV[t * kP + c];
      if (u)
        for (int c = 0; c < kDim; ++c) coef += sQ[t * kP + c] * u[c] * sK[t * kP + c];
      sDyv[t] = dyv;
      sCoef[t] = coef;
    } else if (tid < 3 * kDim) {
      const int c = tid - 2 * kDim;  // dW_Q = rowsum(dS * S_{n+1})
      float acc = 0.f;
      for (int x = 0; x < kDim; ++x) acc += sDS[c * kP + x] * sS[c * kP + x];
      sDWQ[c] = acc;
    }
    __syncthreads();
    load_state(sS, p.states + ((long)bh * chunks + n) * state_elems);  // S_n
    intra_scores(sQ, sK, sW, sA, inc);
    {  // dA = (dy v^T), masked
      float acc[4][4] = {};
      for (int x = 0; x < kDim; ++x) {
        float g[4], vv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          g[i] = sDY[(ty + 16 * i) * kP + x];
          vv[i] = sV[(tx + 16 * i) * kP + x];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] += g[i] * vv[j];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          sDA[(ty + 16 * i) * kP + tx + 16 * j] =
              visible(ty + 16 * i, tx + 16 * j, inc) ? acc[i][j] : 0.f;
    }
    __syncthreads();
    {  // dv = A^T dy + (k exp(W_Q - W)) dS + coef dy
      float acc[4][4] = {};
      for (int t = 0; t < kChunk; ++t) {
        float a[4], g[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          a[i] = sA[t * kP + ty + 16 * i];
          g[i] = sDY[t * kP + tx + 16 * i];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] += a[i] * g[j];
      }
      for (int c = 0; c < kDim; ++c) {
        const float wq = sW[(kChunk - 1) * kP + c];
        float kd[4], ds[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int r = ty + 16 * i;
          kd[i] = sK[r * kP + c] * __expf(wq - sW[r * kP + c]);
          ds[i] = sDS[c * kP + tx + 16 * i];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] += kd[i] * ds[j];
      }
      T* dv = static_cast<T*>(p.dv);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = ty + 16 * i;
        if (r >= len) continue;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int col = tx + 16 * j;
          store(dv + base + (t0 + r) * row_stride + col, acc[i][j] + sCoef[r] * sDY[r * kP + col]);
        }
      }
    }
    __syncthreads();
    float dw[4][4];
    {  // dq; dE = q (dq - bonus) into sA
      float intra[4][4] = {}, inter[4][4] = {}, e[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) e[i][j] = read_exp(sW, ty + 16 * i, tx + 16 * j, inc);
      for (int x = 0; x < kChunk; ++x) {
        float da[4], kv[4], wv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          da[i] = sDA[(ty + 16 * i) * kP + x];
          kv[i] = sK[x * kP + tx + 16 * i];
          wv[i] = sW[x * kP + tx + 16 * i];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j)
            intra[i][j] += da[i] * kv[j] * pair_decay(e[i][j], wv[j], visible(ty + 16 * i, x, inc));
      }
      for (int x = 0; x < kDim; ++x) {
        float g[4], st[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          g[i] = sDY[(ty + 16 * i) * kP + x];
          st[i] = sS[(tx + 16 * i) * kP + x];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) inter[i][j] += g[i] * st[j];
      }
      T* dq = static_cast<T*>(p.dq);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int t = ty + 16 * i, c = tx + 16 * j;
          const float g = intra[i][j] + inter[i][j] * __expf(e[i][j]);
          sA[t * kP + c] = sQ[t * kP + c] * g;
          if (t < len)
            store(dq + base + (t0 + t) * row_stride + c,
                  g + (u ? u[c] * sK[t * kP + c] * sDyv[t] : 0.f));
        }
    }
    {  // dk; dW = -k (dk - bonus), kept in registers
      float intra[4][4] = {}, st[4][4] = {}, w[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) w[i][j] = sW[(ty + 16 * i) * kP + tx + 16 * j];
      for (int t = 0; t < kChunk; ++t) {
        float da[4], qv[4], ev[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          da[i] = sDA[t * kP + ty + 16 * i];
          qv[i] = sQ[t * kP + tx + 16 * i];
          ev[i] = read_exp(sW, t, tx + 16 * i, inc);
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j)
            intra[i][j] += da[i] * qv[j] * pair_decay(ev[j], w[i][j], visible(t, ty + 16 * i, inc));
      }
      for (int x = 0; x < kDim; ++x) {
        float vv[4], ds[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          vv[i] = sV[(ty + 16 * i) * kP + x];
          ds[i] = sDS[(tx + 16 * i) * kP + x];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) st[i][j] += vv[i] * ds[j];
      }
      T* dk = static_cast<T*>(p.dk);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int r = ty + 16 * i, c = tx + 16 * j;
          const float g = intra[i][j] + st[i][j] * __expf(sW[(kChunk - 1) * kP + c] - w[i][j]);
          dw[i][j] = -sK[r * kP + c] * g;
          if (r < len)
            store(dk + base + (t0 + r) * row_stride + c,
                  g + (u ? u[c] * sQ[r * kP + c] * sDyv[r] : 0.f));
        }
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) sDA[(ty + 16 * i) * kP + tx + 16 * j] = dw[i][j];
    __syncthreads();
    if (tid < kDim) {
      // dlog_w[s] = sum_{t >= s} (dW[t] + dE[t], or dE[t+1] when E[t] = W[t-1]) + dW_Q
      const int c = tid;
      float acc = sDWQ[c];
      float* dlw = p.dlog_w;
      for (int t = kChunk - 1; t >= 0; --t) {
        const float de = inc ? sA[t * kP + c] : (t + 1 < kChunk ? sA[(t + 1) * kP + c] : 0.f);
        acc += sDA[t * kP + c] + de;
        if (t < len) dlw[base + (t0 + t) * row_stride + c] = acc;
      }
    } else if (tid < 2 * kDim && u) {
      const int c = tid - kDim;
      float acc = 0.f;
      for (int t = 0; t < kChunk; ++t) acc += sQ[t * kP + c] * sK[t * kP + c] * sDyv[t];
      sDU[c] += acc;
    }
    {  // dS <- dS exp(W_Q) + (q exp(E))^T dy
      float acc[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int c = ty + 16 * i;
          acc[i][j] = sDS[c * kP + tx + 16 * j] * __expf(sW[(kChunk - 1) * kP + c]);
        }
      for (int t = 0; t < kChunk; ++t) {
        float qe[4], g[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int c = ty + 16 * i;
          qe[i] = sQ[t * kP + c] * __expf(read_exp(sW, t, c, inc));
          g[i] = sDY[t * kP + tx + 16 * i];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] += qe[i] * g[j];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) sDS[(ty + 16 * i) * kP + tx + 16 * j] = acc[i][j];
    }
  }
  __syncthreads();
  if (p.ds0) store_state(p.ds0 + bh * state_elems, sDS);
  if (p.du_part && tid < kDim) p.du_part[bh * kDim + tid] = sDU[tid];
}


// ---------------------------------------------------------------------------
// The bf16 route: chunk-parallel passes, products on the tensor cores.
// ---------------------------------------------------------------------------
namespace tc {

using bf16 = __nv_bfloat16;

constexpr int kSub = 16;                     // rows of a sub-chunk: one mma tile
constexpr int kWarps = kChunk / kSub;        // warp i owns sub-chunk i
constexpr int kThreadsTc = 32 * kWarps;      // 128
constexpr int kBs = kDim + 8;                // bf16 tile row stride (elements): 144 B
constexpr int kFs = kDim + 2;                // f32 tile row stride (floats): 264 B, 8-byte aligned rows
constexpr int kDs = kSub + 1;                // row stride of a 16 x 16 f32 block
constexpr int kHalf = kSub / 2;               // the forward cuts a diagonal block again at row 8
constexpr int kHalfPairs = kHalf * (kHalf + 1) / 2;  // (t, u), u <= t, of an 8 x 8 diagonal block
constexpr int kState = kDim * kDim;
constexpr int kBfTile = kChunk * kBs * 2;    // bytes
constexpr int kF32Tile = kChunk * kFs * 4;   // bytes
constexpr int kScanThreads = 256;
constexpr float kLog2e = 1.4426950408889634f;  // W is kept in base 2: W log2 e
constexpr int kLocalSmem = 2 * kBfTile + kF32Tile;
constexpr int kChunkPassSmem = 4 * kBfTile + 2 * kF32Tile + (kWarps * kSub * kDs + 3 * kChunk) * 4;
// a slot of the bf16 route's states buffer: the chunk-start state S_n, then
// the forward's A (64 x 64, masked), which the backward reads instead of
// forming its decays again
constexpr int kSlot = kState + kChunk * kChunk;

// A measurement build (-DGLA_CLOCK_STAMPS) records clock64() at the section
// boundaries of one block of each per-chunk pass (the middle chunk of the
// last (batch, head), in the last wave), per warp, read back by
// gla_clock_stamps: where a block's time goes. The plain build records
// nothing.
constexpr int kStampPasses = 3, kStamps = 16;
#ifdef GLA_CLOCK_STAMPS
__device__ long long g_stamps[kStampPasses][kWarps][kStamps];
#define STAMP(pass, k)                                                                          \
  do {                                                                                          \
    if (blockIdx.x == gridDim.x / 2 && blockIdx.y == gridDim.y - 1 && (threadIdx.x & 31) == 0) \
      g_stamps[pass][threadIdx.x >> 5][k] = clock64();                                          \
  } while (0)
#else
#define STAMP(pass, k) \
  do {                 \
  } while (0)
#endif

// Which chunk of which (batch, head) a block of a per-chunk pass takes.
struct Chunk {
  int n, chunks, bh, h, t0, len;
  long base, rs;  // element offset of row 0 of this (batch, head); row stride
};

__device__ __forceinline__ Chunk chunk_of(const Params& p) {
  Chunk c;
  c.n = blockIdx.x;
  c.chunks = gridDim.x;
  c.bh = blockIdx.y;
  c.h = c.bh % p.h;
  c.t0 = c.n * kChunk;
  c.len = min(kChunk, p.s - c.t0);
  c.rs = (long)p.h * kDim;
  c.base = ((long)(c.bh / p.h) * p.s * p.h + c.h) * kDim;
  return c;
}

// An N-byte copy (16 or 8) from global to shared memory that the thread
// does not wait for (cp.async), zero-filled when !valid (src is then not
// read); cp_async_wait() waits for all of the thread's copies. The tiles'
// loads are all in flight together, with log_w's.
template <int N>
__device__ __forceinline__ void cp_async(void* dst, const void* src, bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if constexpr (N == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src), "r"(valid ? 16 : 0)
                 : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(d), "l"(src), "r"(valid ? 8 : 0)
                 : "memory");
}
__device__ __forceinline__ void cp_async_wait() { asm volatile("cp.async.wait_all;\n" ::: "memory"); }

// Rows of the chunk as bf16, 16 bytes a thread, rows past S zero: copies
// issued, not waited for.
__device__ void load_bf16(bf16* sm, const void* src, const Chunk& ch) {
  const bf16* x = static_cast<const bf16*>(src);
  for (int i = threadIdx.x; i < kChunk * kDim / 8; i += kThreadsTc) {
    const int t = i >> 3, c = (i & 7) * 8;
    cp_async<16>(sm + t * kBs + c, t < ch.len ? x + ch.base + (long)(ch.t0 + t) * ch.rs + c : x, t < ch.len);
  }
}

// A (K, V) f32 state into a tile (rows of kFs floats, 8-byte aligned):
// copies issued, not waited for.
__device__ void load_state_tile(float* sm, const float* src) {
  for (int i = threadIdx.x; i < kState / 2; i += kThreadsTc) {
    const int r = i >> 5, c = (i & 31) * 2;
    cp_async<8>(sm + r * kFs + c, src + 2 * i, true);
  }
}

// W, the inclusive prefix sum of log_w along the chunk (rows past S add 0),
// in base 2 (log_w log2 e: see exp_le0), two threads a channel, each a
// segment of 32 rows: a segment's sums, then the total of the segment
// before it added. Rounding is monotone and the second segment's offset is
// exactly the first one's last W, so W never rises along t and every
// W[a] - W[b], a >= b, is <= 0. Ends synchronised.
__device__ void load_prefix(float* sW, const float* log_w, const Chunk& ch) {
  constexpr int kRows = kChunk * kDim / kThreadsTc;
  const int c = threadIdx.x & (kDim - 1), seg = threadIdx.x / kDim;
  float x[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int t = seg * kRows + r;
    x[r] = t < ch.len ? __ldg(log_w + ch.base + (long)(ch.t0 + t) * ch.rs + c) : 0.f;
  }
  float acc = 0.f;
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    acc += x[r] * kLog2e;
    sW[(seg * kRows + r) * kFs + c] = acc;
  }
  __syncthreads();
  if (seg) {
    const float off = sW[(kRows - 1) * kFs + c];
#pragma unroll
    for (int r = 0; r < kRows; ++r) sW[(kRows + r) * kFs + c] += off;
  }
  __syncthreads();
}

__device__ __forceinline__ float bf(const bf16* s, int r, int c) { return __bfloat162float(s[r * kBs + c]); }
__device__ __forceinline__ float2 bf2(const bf16* s, int r, int c) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(s + r * kBs + c));
}

// W and the exponent E with which a row reads, over the chunk's W tile.
// W[-1] = 0 is a select after a load from row 0: no branch, so loads can be
// issued ahead.
struct Decay {
  const float* w;
  int inc;
  __device__ __forceinline__ float W(int t, int c) const {
    const float x = w[max(t, 0) * kFs + c];
    return t >= 0 ? x : 0.f;
  }
  __device__ __forceinline__ float E(int t, int c) const { return W(inc ? t : t - 1, c); }
};

// 2^x for x <= 0 (or -inf), one ex2.approx.ftz: the decays' exponents are
// differences of W, which the tiles hold in base 2 (W log2 e), so exp of
// a difference of W is 2^ of a difference of the tile's values. Results
// below 2^-126, far under any sum they enter, flush to 0.
__device__ __forceinline__ float exp_le0(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// sum_c a[t,c] x[c] b[t,c] for each row t of two bf16 tiles (x null: 1),
// two threads a row (32 channels each, summed by a shuffle); every thread
// of the block calls it, the result is valid in the even thread of a pair.
__device__ __forceinline__ float row_dot(const bf16* a, const bf16* b, const float* x) {
  constexpr int kLanes = kThreadsTc / kChunk, kCh = kDim / kLanes;
  const int t = threadIdx.x / kLanes, c0 = (threadIdx.x % kLanes) * kCh;
  float acc0 = 0.f, acc1 = 0.f;
#pragma unroll
  for (int c = c0; c < c0 + kCh; c += 4) {
    const float2 a0 = bf2(a, t, c), a1 = bf2(a, t, c + 2), b0 = bf2(b, t, c), b1 = bf2(b, t, c + 2);
    const float4 w = x ? __ldg(reinterpret_cast<const float4*>(x + c)) : make_float4(1.f, 1.f, 1.f, 1.f);
    acc0 += a0.x * w.x * b0.x + a0.y * w.y * b0.y;
    acc1 += a1.x * w.z * b1.x + a1.y * w.w * b1.y;
  }
  float acc = acc0 + acc1;
#pragma unroll
  for (int off = 1; off < kLanes; off <<= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  return acc;
}

// -- mma.sync m16n8k16, bf16 in, f32 accumulate --
// An f32 operand x is split into hi = bf16(x) and lo = bf16(x - hi); a
// product of two split operands is hi hi + hi lo + lo hi (the lo lo term is
// below f32 rounding), of a split and an exact bf16 operand hi b + lo b.
struct FragA {
  uint32_t hi[4], lo[4];
};
struct FragB {
  uint32_t hi[2], lo[2];
};

__device__ __forceinline__ uint32_t bits(__nv_bfloat162 h) { return *reinterpret_cast<uint32_t*>(&h); }

template <bool kSplit>
__device__ __forceinline__ void split(float a, float b, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);  // a in the low half
  hi = bits(h);
  if constexpr (kSplit) {
    const float2 f = __bfloat1622float2(h);
    lo = bits(__floats2bfloat162_rn(a - f.x, b - f.y));
  } else {
    lo = 0u;
  }
}

// The A fragment of a 16 x 16 tile, at(row, col) its element.
template <bool kSplit, class F>
__device__ __forceinline__ FragA frag_a(F at) {
  const int lane = threadIdx.x & 31, g = lane >> 2, c = (lane & 3) * 2;
  FragA f;
  split<kSplit>(at(g, c), at(g, c + 1), f.hi[0], f.lo[0]);
  split<kSplit>(at(g + 8, c), at(g + 8, c + 1), f.hi[1], f.lo[1]);
  split<kSplit>(at(g, c + 8), at(g, c + 9), f.hi[2], f.lo[2]);
  split<kSplit>(at(g + 8, c + 8), at(g + 8, c + 9), f.hi[3], f.lo[3]);
  return f;
}

// The B fragment of a 16 x 8 tile, at(k, n) its element; a lane asks only
// for its own column n = lane / 4.
template <bool kSplit, class F>
__device__ __forceinline__ FragB frag_b(F at) {
  const int lane = threadIdx.x & 31, g = lane >> 2, c = (lane & 3) * 2;
  FragB f;
  split<kSplit>(at(c, g), at(c + 1, g), f.hi[0], f.lo[0]);
  split<kSplit>(at(c + 8, g), at(c + 9, g), f.hi[1], f.lo[1]);
  return f;
}

// The B fragment of a 16 x 8 tile whose element (k, n) is scale * src[n ld +
// k] (f32, k pairs adjacent: two 8-byte loads a lane), split.
template <bool kGlobal>
__device__ __forceinline__ FragB frag_b_kpairs(const float* src, int ld, float scale) {
  const int lane = threadIdx.x & 31, g = lane >> 2, c = (lane & 3) * 2;
  const float2* row = reinterpret_cast<const float2*>(src + g * ld + c);
  const float2 x0 = kGlobal ? __ldg(row) : row[0], x1 = kGlobal ? __ldg(row + 4) : row[4];
  FragB f;
  split<true>(scale * x0.x, scale * x0.y, f.hi[0], f.lo[0]);
  split<true>(scale * x1.x, scale * x1.y, f.hi[1], f.lo[1]);
  return f;
}

// The A fragment (k over 16 columns) of a 16-row result held as two
// accumulator tiles of 8 columns: the accumulator layout is the operand's.
__device__ __forceinline__ FragA frag_from_acc(const float (&a)[4], const float (&b)[4]) {
  FragA f;
  split<true>(a[0], a[1], f.hi[0], f.lo[0]);
  split<true>(a[2], a[3], f.hi[1], f.lo[1]);
  split<true>(b[0], b[1], f.hi[2], f.lo[2]);
  split<true>(b[2], b[3], f.hi[3], f.lo[3]);
  return f;
}

__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4], const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

template <bool kSplitA, bool kSplitB>
__device__ __forceinline__ void mma_split(float (&c)[4], const FragA& a, const FragB& b) {
  if constexpr (kSplitA) mma(c, a.lo, b.hi);
  if constexpr (kSplitB) mma(c, a.hi, b.lo);
  mma(c, a.hi, b.hi);
}

// Accumulator element r of this lane sits at row g + 8 (r / 2), column
// 2 (lane % 4) + r % 2 of its 16 x 8 tile.
__device__ __forceinline__ int acc_row(int r) { return ((threadIdx.x & 31) >> 2) + 8 * (r >> 1); }
__device__ __forceinline__ int acc_col(int r) { return (threadIdx.x & 3) * 2 + (r & 1); }

// Pair p of a diagonal block, in the order (0,0), (1,0), (1,1), (2,0), ...
__device__ __forceinline__ void pair_of(int p, int& t, int& u) {
  t = 0;
  while ((t + 1) * (t + 2) / 2 <= p) ++t;
  u = p - t * (t + 1) / 2;
}

// -- local pass: one block per (batch, head, chunk) --
// Forward: the chunk's (k exp(W_Q - W))^T v into its slot of the states
// buffer. Backward: (q exp(E))^T dy into its slot of the dS buffer. Both
// write W_Q, the chunk's total log-decay per channel, for the scan.
template <bool kBwd>
__global__ void __launch_bounds__(kThreadsTc) local_kernel(Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* sX = reinterpret_cast<bf16*>(smem);
  bf16* sY = sX + kChunk * kBs;
  float* sW = reinterpret_cast<float*>(sY + kChunk * kBs);
  const Chunk ch = chunk_of(p);
  STAMP(2, 0);
  load_bf16(sX, kBwd ? p.q : p.k, ch);
  load_bf16(sY, kBwd ? p.dy : p.v, ch);
  load_prefix(sW, p.log_w, ch);
  cp_async_wait();
  __syncthreads();
  const Decay dec{sW, p.include_current};
  const int c0 = kSub * (threadIdx.x >> 5);  // this warp's 16 rows (channels) of the result
  STAMP(2, 1);
  float acc[8][4] = {};
#pragma unroll 1
  for (int ks = 0; ks < kChunk / 16; ++ks) {
    const FragA a = frag_a<true>([&](int m, int kk) {
      const int t = 16 * ks + kk, c = c0 + m;
      return bf(sX, t, c) * exp_le0(kBwd ? dec.E(t, c) : dec.W(kChunk - 1, c) - dec.W(t, c));
    });
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
      mma_split<true, false>(acc[nt], a, frag_b<false>([&](int kk, int nn) { return bf(sY, 16 * ks + kk, 8 * nt + nn); }));
  }
  STAMP(2, 2);
  const long slot = (long)ch.bh * ch.chunks + ch.n;
  float* out = kBwd ? p.dstates + slot * kState : p.states + slot * kSlot;
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
#pragma unroll
    for (int r = 0; r < 4; r += 2)
      *reinterpret_cast<float2*>(out + (c0 + acc_row(r)) * kDim + 8 * nt + acc_col(r)) =
          make_float2(acc[nt][r], acc[nt][r + 1]);
  if (threadIdx.x < kDim) p.wq[slot * kDim + threadIdx.x] = dec.W(kChunk - 1, threadIdx.x);
  STAMP(2, 3);
}

// -- state pass: the scan over chunks, one thread per 4 state elements --
// In place: slot n of the states buffer (kSlot floats) holds the chunk's
// K~^T V and becomes S_n, the state at the chunk's start; the final state is
// S_N. The 16-byte loads of kScanBatch chunks are issued together, ahead of
// their chain.
constexpr int kScanBatch = 8;
constexpr int kScanVec = 4;  // state elements a thread

__device__ __forceinline__ float4 fma4(float4 s, float g, float4 x) {
  return make_float4(s.x * g + x.x, s.y * g + x.y, s.z * g + x.z, s.w * g + x.w);
}

__global__ void __launch_bounds__(kScanThreads) fwd_scan_kernel(Params p, int chunks) {
  const long idx = ((long)blockIdx.x * kScanThreads + threadIdx.x) * kScanVec;
  const long bh = idx / kState;
  const int e = static_cast<int>(idx % kState), c = e / kDim;
  float4* buf = reinterpret_cast<float4*>(p.states + bh * chunks * kSlot + e);
  const float* wq = p.wq + bh * chunks * kDim + c;
  float4 s = p.s0 ? *reinterpret_cast<const float4*>(p.s0 + idx) : make_float4(0.f, 0.f, 0.f, 0.f);
  for (int n0 = 0; n0 < chunks; n0 += kScanBatch) {
    float4 kv[kScanBatch];
    float wt[kScanBatch];
#pragma unroll
    for (int j = 0; j < kScanBatch; ++j) {
      const int n = n0 + j;
      kv[j] = n < chunks ? buf[(long)n * kSlot / kScanVec] : make_float4(0.f, 0.f, 0.f, 0.f);
      wt[j] = n < chunks ? wq[n * kDim] : 0.f;
    }
#pragma unroll
    for (int j = 0; j < kScanBatch; ++j) {
      const int n = n0 + j;
      if (n < chunks) {
        buf[(long)n * kSlot / kScanVec] = s;
        s = fma4(s, exp_le0(wt[j]), kv[j]);
      }
    }
  }
  *reinterpret_cast<float4*>(p.s_final + idx) = s;
}

// The reverse scan: slot n of the dS buffer holds (q exp(E))^T dy and
// becomes dS_{n+1}, the gradient of the state after chunk n; ds0 = dS_0.
// Also dW_Q = rowsum(dS_{n+1} * S_{n+1}): a channel's 64 columns are 16
// lanes of a warp, summed by shuffles in a fixed order.
__global__ void __launch_bounds__(kScanThreads) bwd_scan_kernel(Params p, int chunks) {
  const long idx = ((long)blockIdx.x * kScanThreads + threadIdx.x) * kScanVec;
  const long bh = idx / kState;
  const int e = static_cast<int>(idx % kState), c = e / kDim;
  float4* buf = reinterpret_cast<float4*>(p.dstates + bh * chunks * kState + e);
  const float4* st = reinterpret_cast<const float4*>(p.states + bh * chunks * kSlot + e);
  const float4 fin = *reinterpret_cast<const float4*>(p.s_final + idx);
  float4 ds = p.d_final ? *reinterpret_cast<const float4*>(p.d_final + idx) : make_float4(0.f, 0.f, 0.f, 0.f);
  for (int n0 = chunks - 1; n0 >= 0; n0 -= kScanBatch) {
    float4 g[kScanBatch], s_next[kScanBatch];
    float wt[kScanBatch];
#pragma unroll
    for (int j = 0; j < kScanBatch; ++j) {
      const int n = n0 - j;
      g[j] = n >= 0 ? buf[(long)n * kState / kScanVec] : make_float4(0.f, 0.f, 0.f, 0.f);
      s_next[j] = n < 0 ? make_float4(0.f, 0.f, 0.f, 0.f) : n + 1 < chunks ? st[(long)(n + 1) * kSlot / kScanVec] : fin;
      wt[j] = n >= 0 ? p.wq[(bh * chunks + n) * kDim + c] : 0.f;
    }
#pragma unroll
    for (int j = 0; j < kScanBatch; ++j) {
      const int n = n0 - j;
      if (n >= 0) {  // uniform across the warp
        buf[(long)n * kState / kScanVec] = ds;
        float part = ds.x * s_next[j].x + ds.y * s_next[j].y + ds.z * s_next[j].z + ds.w * s_next[j].w;
#pragma unroll
        for (int off = 8; off; off >>= 1) part += __shfl_xor_sync(0xffffffffu, part, off);
        if ((threadIdx.x & 15) == 0) p.dwq[(bh * chunks + n) * kDim + c] = part;
        ds = fma4(ds, exp_le0(wt[j]), g[j]);
      }
    }
  }
  if (p.ds0) *reinterpret_cast<float4*>(p.ds0 + idx) = ds;
}

// -- output pass: one block per (batch, head, chunk), warp i owns rows
// 16 i .. 16 i + 15 --
// A_i = [A_ij for j < i | A_ii]: off-diagonal blocks from the reference row
// r = 16 i - 1 on the tensor cores, the diagonal block as below; y_i = A_i v
// + (q exp(E))_i S_n + (sum_c q u k) v. A_i goes to the chunk's slot of the
// states buffer for the backward.
constexpr int kOutSmem = 3 * kBfTile + 2 * kF32Tile + (kWarps * kSub * kDs + kChunk) * 4;

__global__ void __launch_bounds__(kThreadsTc, 3) fwd_out_kernel(Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* sQ = reinterpret_cast<bf16*>(smem);
  bf16* sK = sQ + kChunk * kBs;
  bf16* sV = sK + kChunk * kBs;
  float* sW = reinterpret_cast<float*>(sV + kChunk * kBs);
  float* sS = sW + kChunk * kFs;
  float* sDiag = sS + kChunk * kFs;
  float* sCoef = sDiag + kWarps * kSub * kDs;
  const Chunk ch = chunk_of(p);
  const long slot = (long)ch.bh * ch.chunks + ch.n;
  STAMP(0, 0);
  load_bf16(sQ, p.q, ch);
  load_bf16(sK, p.k, ch);
  load_bf16(sV, p.v, ch);
  load_state_tile(sS, p.states + slot * kSlot);
  load_prefix(sW, p.log_w, ch);
  cp_async_wait();
  __syncthreads();
  {
    const float coef = p.u ? row_dot(sQ, sK, p.u + ch.h * kDim) : 0.f;
    if (!(threadIdx.x & 1)) sCoef[threadIdx.x >> 1] = coef;
  }
  __syncthreads();
  const Decay dec{sW, p.include_current};
  STAMP(0, 1);
  const int i = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row0 = kSub * i;

  float accA[8][4] = {};
  if (i > 0) {
    const int r = row0 - 1;
#pragma unroll 1
    for (int ks = 0; ks < kDim / 16; ++ks) {
      const FragA a = frag_a<true>([&](int m, int kk) {
        const int t = row0 + m, c = 16 * ks + kk;
        return bf(sQ, t, c) * exp_le0(dec.E(t, c) - dec.W(r, c));
      });
#pragma unroll
      for (int nt = 0; nt < 2 * (kWarps - 1); ++nt)
        if (nt < 2 * i)
          mma_split<true, true>(accA[nt], a, frag_b<true>([&](int kk, int nn) {
                                  const int u = 8 * nt + nn, c = 16 * ks + kk;
                                  return bf(sK, u, c) * exp_le0(dec.W(r, c) - dec.W(u, c));
                                }));
    }
  }
  STAMP(0, 2);
  // The diagonal block, cut again at row 8: its two 8 x 8 diagonal blocks
  // take one exp a visible (t, u, channel) term (masked pairs are never
  // exponentiated and score 0); its lower-left 8 x 8 block (t in 8..15,
  // u in 0..7) is a product from the reference row r = 16 i + 7, on the
  // tensor cores as one 16 x 8 tile whose rows t < 8 are zero operands.
  float* sD = sDiag + i * kSub * kDs;
  {
    const int r = row0 + kHalf - 1;
    float quad[4] = {};
#pragma unroll 1
    for (int ks = 0; ks < kDim / 16; ++ks) {
      const FragA a = frag_a<true>([&](int m, int kk) {
        const int t = row0 + m, c = 16 * ks + kk;
        return m >= kHalf ? bf(sQ, t, c) * exp_le0(dec.E(t, c) - dec.W(r, c)) : 0.f;
      });
      mma_split<true, true>(quad, a, frag_b<true>([&](int kk, int nn) {
                              const int u = row0 + nn, c = 16 * ks + kk;
                              return bf(sK, u, c) * exp_le0(dec.W(r, c) - dec.W(u, c));
                            }));
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) {  // the lower-left block, and zeros for the upper-right one
      const int tl = acc_row(e), ul = acc_col(e);
      if (tl >= kHalf) sD[tl * kDs + ul] = quad[e];
      sD[ul * kDs + kHalf + tl % kHalf] = 0.f;
    }
  }
  for (int pp = lane; pp < 2 * kHalfPairs; pp += 32) {
    const int sub = pp / kHalfPairs;
    int tl, ul;
    pair_of(pp % kHalfPairs, tl, ul);
    tl += kHalf * sub;
    ul += kHalf * sub;
    float a = 0.f;
    if (p.include_current || ul < tl) {
      const int t = row0 + tl, u = row0 + ul, te = p.include_current ? t : t - 1;
      float a1 = 0.f;
#pragma unroll 8
      for (int c = 0; c < kDim; c += 2) {
        const float2 qq = bf2(sQ, t, c), kk = bf2(sK, u, c);
        const float2 e = *reinterpret_cast<const float2*>(sW + te * kFs + c);
        const float2 w = *reinterpret_cast<const float2*>(sW + u * kFs + c);
        a += qq.x * kk.x * exp_le0(e.x - w.x);
        a1 += qq.y * kk.y * exp_le0(e.y - w.y);
      }
      a += a1;
    }
    sD[tl * kDs + ul] = a;
    if (ul < tl) sD[ul * kDs + tl] = 0.f;
  }
  __syncwarp();
#pragma unroll
  for (int jj = 0; jj < kWarps; ++jj)
    if (jj == i)
#pragma unroll
      for (int h2 = 0; h2 < 2; ++h2)
#pragma unroll
        for (int r = 0; r < 4; ++r) accA[2 * jj + h2][r] = sD[acc_row(r) * kDs + 8 * h2 + acc_col(r)];
  {  // rows 16 i .. 16 i + 15 of A for the backward, in the chunk's slot of the states buffer
    float* a_rows = p.states + slot * kSlot + kState + row0 * kChunk;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int r = 0; r < 4; r += 2)
        *reinterpret_cast<float2*>(a_rows + acc_row(r) * kChunk + 8 * nt + acc_col(r)) =
            make_float2(accA[nt][r], accA[nt][r + 1]);
  }

  STAMP(0, 3);
  float accY[8][4] = {};
#pragma unroll
  for (int kk = 0; kk < kWarps; ++kk) {
    if (kk <= i) {
      const FragA a = frag_from_acc(accA[2 * kk], accA[2 * kk + 1]);
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
        mma_split<true, false>(accY[nt], a, frag_b<false>([&](int k2, int nn) { return bf(sV, 16 * kk + k2, 8 * nt + nn); }));
    }
  }
  STAMP(0, 4);
#pragma unroll 1
  for (int ks = 0; ks < kDim / 16; ++ks) {
    const FragA a = frag_a<true>([&](int m, int kk) {
      const int t = row0 + m, c = 16 * ks + kk;
      return bf(sQ, t, c) * exp_le0(dec.E(t, c));
    });
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
      mma_split<true, true>(accY[nt], a, frag_b<true>([&](int kk, int nn) { return sS[(16 * ks + kk) * kFs + 8 * nt + nn]; }));
  }
  STAMP(0, 5);
  bf16* y = static_cast<bf16*>(p.y);
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
#pragma unroll
    for (int r = 0; r < 4; r += 2) {
      const int t = row0 + acc_row(r), col = 8 * nt + acc_col(r);
      if (t < ch.len) {
        const float2 vv = bf2(sV, t, col);
        *reinterpret_cast<__nv_bfloat162*>(y + ch.base + (long)(ch.t0 + t) * ch.rs + col) =
            __floats2bfloat162_rn(accY[nt][r] + sCoef[t] * vv.x, accY[nt][r + 1] + sCoef[t] * vv.y);
      }
    }
  STAMP(0, 6);
}

// -- the backward's chunk pass: one block per (batch, head, chunk), warp i
// owns rows 16 i .. 16 i + 15 of dq (as t), and of dk and dv (as u) --
__global__ void __launch_bounds__(kThreadsTc, 3) bwd_chunk_kernel(Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* sQ = reinterpret_cast<bf16*>(smem);
  bf16* sK = sQ + kChunk * kBs;
  bf16* sV = sK + kChunk * kBs;
  bf16* sDY = sV + kChunk * kBs;
  float* sW = reinterpret_cast<float*>(sDY + kChunk * kBs);
  float* sX = sW + kChunk * kFs;                 // dS_{n+1}, then the diagonal blocks' dq
  float* sDA = sX + kChunk * kFs;                // per warp: dA of its diagonal block
  float* sCoef = sDA + kWarps * kSub * kDs;      // (sum_c q u k)[t]
  float* sDyv = sCoef + kChunk;                  // dy[t] . v[t]
  float* sDwq = sDyv + kChunk;                   // dW_Q per channel
  float* sDK = reinterpret_cast<float*>(sV);     // the v and dy tiles, once dead: the diagonal blocks' dk
  const Chunk ch = chunk_of(p);
  STAMP(1, 0);
  const long slot = (long)ch.bh * ch.chunks + ch.n;
  load_bf16(sQ, p.q, ch);
  load_bf16(sK, p.k, ch);
  load_bf16(sV, p.v, ch);
  load_bf16(sDY, p.dy, ch);
  load_state_tile(sX, p.dstates + slot * kState);
  load_prefix(sW, p.log_w, ch);
  cp_async_wait();
  __syncthreads();
  {
    const float coef = p.u ? row_dot(sQ, sK, p.u + ch.h * kDim) : 0.f;
    const float dyv = row_dot(sDY, sV, nullptr);
    if (!(threadIdx.x & 1)) {
      sCoef[threadIdx.x >> 1] = coef;
      sDyv[threadIdx.x >> 1] = dyv;
    }
    if (threadIdx.x < kDim) sDwq[threadIdx.x] = p.dwq[slot * kDim + threadIdx.x];
  }
  __syncthreads();
  const Decay dec{sW, p.include_current};
  const int inc = p.include_current;
  const int i = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2;
  const int row0 = kSub * i;
  STAMP(1, 1);

  // dq_i = exp(E - W[r]) (sum_{j<i} dA_ij (k exp(W[r] - W))_j + exp(W[r]) (dy_i S_n^T)),
  // r = 16 i - 1 (W[-1] = 0); the diagonal block is added last
  float accQ[8][4] = {};
  {
    const int r = row0 - 1;
    float sc[8];  // exp(W[r, c]) for this lane's column c = 8 nt + g of S_n^T
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) sc[nt] = exp_le0(dec.W(r, 8 * nt + g));
    const float* s_n = p.states + slot * kSlot;  // S_n [c][v], read from L2 into the fragments
#pragma unroll 2
    for (int ks = 0; ks < kDim / 16; ++ks) {
      const FragA a = frag_a<false>([&](int m, int kk) { return bf(sDY, row0 + m, 16 * ks + kk); });
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
        mma_split<false, true>(accQ[nt], a, frag_b_kpairs<true>(s_n + 8 * nt * kDim + 16 * ks, kDim, sc[nt]));
    }
#pragma unroll 1
    for (int jj = 0; jj < i; ++jj) {
      float da[2][4] = {};  // dA_ij = dy_i v_j^T (all visible: u < t)
#pragma unroll 1
      for (int ks = 0; ks < kDim / 16; ++ks) {
        const FragA a = frag_a<false>([&](int m, int kk) { return bf(sDY, row0 + m, 16 * ks + kk); });
#pragma unroll
        for (int h2 = 0; h2 < 2; ++h2)
          mma_split<false, false>(da[h2], a, frag_b<false>([&](int kk, int nn) {
                                    return bf(sV, kSub * jj + 8 * h2 + nn, 16 * ks + kk);
                                  }));
      }
      const FragA a = frag_from_acc(da[0], da[1]);
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
        mma_split<true, true>(accQ[nt], a, frag_b<true>([&](int kk, int nn) {
                                const int u = kSub * jj + kk, c = 8 * nt + nn;
                                return bf(sK, u, c) * exp_le0(dec.W(r, c) - dec.W(u, c));
                              }));
    }
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int t = row0 + acc_row(e), c = 8 * nt + acc_col(e);
        accQ[nt][e] *= exp_le0(dec.E(t, c) - dec.W(r, c));
      }
  }
  STAMP(1, 2);

  // dk_i = exp(W[p] - W) (sum_{j>i} dA_ji^T (q exp(E - W[p]))_j + exp(W_Q - W[p]) (v_i dS^T)),
  // p = 16 i + 15, the last row of sub-chunk i; the diagonal block is added last
  float accK[8][4] = {};
  {
    const int pr = row0 + kSub - 1;
    float sc[8];  // exp(W_Q[c] - W[p, c]) for this lane's column c = 8 nt + g of dS^T
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) sc[nt] = exp_le0(dec.W(kChunk - 1, 8 * nt + g) - dec.W(pr, 8 * nt + g));
#pragma unroll 1
    for (int ks = 0; ks < kDim / 16; ++ks) {
      const FragA a = frag_a<false>([&](int m, int kk) { return bf(sV, row0 + m, 16 * ks + kk); });
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
        mma_split<false, true>(accK[nt], a, frag_b_kpairs<false>(sX + 8 * nt * kFs + 16 * ks, kFs, sc[nt]));
    }
#pragma unroll 1
    for (int jj = i + 1; jj < kWarps; ++jj) {
      float dat[2][4] = {};  // dA_ji^T = v_i dy_j^T
#pragma unroll 1
      for (int ks = 0; ks < kDim / 16; ++ks) {
        const FragA a = frag_a<false>([&](int m, int kk) { return bf(sV, row0 + m, 16 * ks + kk); });
#pragma unroll
        for (int h2 = 0; h2 < 2; ++h2)
          mma_split<false, false>(dat[h2], a, frag_b<false>([&](int kk, int nn) {
                                    return bf(sDY, kSub * jj + 8 * h2 + nn, 16 * ks + kk);
                                  }));
      }
      const FragA a = frag_from_acc(dat[0], dat[1]);
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
        mma_split<true, true>(accK[nt], a, frag_b<true>([&](int kk, int nn) {
                                const int t = kSub * jj + kk, c = 8 * nt + nn;
                                return bf(sQ, t, c) * exp_le0(dec.E(t, c) - dec.W(pr, c));
                              }));
    }
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int u = row0 + acc_row(e), c = 8 * nt + acc_col(e);
        accK[nt][e] *= exp_le0(dec.W(pr, c) - dec.W(u, c));
      }
  }
  STAMP(1, 3);

  // dv_i = sum_{j>=i} A_ji^T dy_j + (k exp(W_Q - W))_i dS + coef dy_i, with A the forward's
  // (its slot in the states buffer; masked, so the diagonal block holds zeros above it)
  {
    float accV[8][4] = {};
    const float* a_t = p.states + slot * kSlot + kState;  // A[t][u]
#pragma unroll 1
    for (int jj = i; jj < kWarps; ++jj) {
      const FragA a = frag_a<true>([&](int m, int kk) { return __ldg(a_t + (kSub * jj + kk) * kChunk + row0 + m); });
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
        mma_split<true, false>(accV[nt], a, frag_b<false>([&](int kk, int nn) {
                                 return bf(sDY, kSub * jj + kk, 8 * nt + nn);
                               }));
    }
    STAMP(1, 4);
#pragma unroll 1
    for (int ks = 0; ks < kDim / 16; ++ks) {
      const FragA a = frag_a<true>([&](int m, int kk) {
        const int u = row0 + m, c = 16 * ks + kk;
        return bf(sK, u, c) * exp_le0(dec.W(kChunk - 1, c) - dec.W(u, c));
      });
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
        mma_split<true, true>(accV[nt], a, frag_b<true>([&](int kk, int nn) { return sX[(16 * ks + kk) * kFs + 8 * nt + nn]; }));
    }
    bf16* dv = static_cast<bf16*>(p.dv);
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; e += 2) {
        const int t = row0 + acc_row(e), c = 8 * nt + acc_col(e);
        if (t < ch.len) {
          const float2 gy = bf2(sDY, t, c);
          *reinterpret_cast<__nv_bfloat162*>(dv + ch.base + (long)(ch.t0 + t) * ch.rs + c) =
              __floats2bfloat162_rn(accV[nt][e] + sCoef[t] * gy.x, accV[nt][e + 1] + sCoef[t] * gy.y);
        }
      }
  }
  // dA of the diagonal block, masked
  float* sDAw = sDA + i * kSub * kDs;
  {
    float da[2][4] = {};
#pragma unroll 1
    for (int ks = 0; ks < kDim / 16; ++ks) {
      const FragA a = frag_a<false>([&](int m, int kk) { return bf(sDY, row0 + m, 16 * ks + kk); });
#pragma unroll
      for (int h2 = 0; h2 < 2; ++h2)
        mma_split<false, false>(da[h2], a, frag_b<false>([&](int kk, int nn) {
                                  return bf(sV, row0 + 8 * h2 + nn, 16 * ks + kk);
                                }));
    }
#pragma unroll
    for (int h2 = 0; h2 < 2; ++h2)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int tl = acc_row(e), ul = 8 * h2 + acc_col(e);
        sDAw[tl * kDs + ul] = (inc ? ul <= tl : ul < tl) ? da[h2][e] : 0.f;
      }
  }
  STAMP(1, 5);
  __syncthreads();  // dS, v and dy are read no more: their tiles take the diagonal blocks' dq and dk

  // The diagonal block: lane c of the warp takes channels c and c + 32, and
  // forms each visible decay exp(E[t,c] - W[u,c]) once, for dq and dk alike
  // (masked pairs: exp(-inf) = 0), with dA broadcast from shared memory.
  {
#pragma unroll 1
    for (int half = 0; half < 2; ++half) {
      const int c = lane + 32 * half;
      float kc[kSub], wc[kSub], dkc[kSub];
#pragma unroll
      for (int u = 0; u < kSub; ++u) {
        kc[u] = bf(sK, row0 + u, c);
        wc[u] = dec.W(row0 + u, c);
        dkc[u] = 0.f;
      }
#pragma unroll
      for (int t = 0; t < kSub; ++t) {
        const float qt = bf(sQ, row0 + t, c), et = dec.E(row0 + t, c);
        float dqt = 0.f;
#pragma unroll
        for (int u = 0; u <= t; ++u) {
          const float d = exp_le0(u < t || inc ? et - wc[u] : -INFINITY);
          const float da = sDAw[t * kDs + u] * d;
          dqt += da * kc[u];
          dkc[u] += da * qt;
        }
        sX[(row0 + t) * kFs + c] = dqt;
      }
#pragma unroll
      for (int u = 0; u < kSub; ++u) sDK[(row0 + u) * kFs + c] = dkc[u];
    }
  }
  __syncwarp();
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int t = row0 + acc_row(e), c = 8 * nt + acc_col(e);
      accQ[nt][e] += sX[t * kFs + c];
      accK[nt][e] += sDK[t * kFs + c];
    }
  STAMP(1, 6);

  // write dq and dk; dE = q dq and dW = -k dk (bonus excluded) for dlog_w
  bf16* dq = static_cast<bf16*>(p.dq);
  bf16* dk = static_cast<bf16*>(p.dk);
  const float* u = p.u ? p.u + ch.h * kDim : nullptr;
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; e += 2) {
      const int t = row0 + acc_row(e), c = 8 * nt + acc_col(e);
      if (t < ch.len) {
        const float2 qq = bf2(sQ, t, c), kk = bf2(sK, t, c);
        const float2 uu = u ? make_float2(u[c] * sDyv[t], u[c + 1] * sDyv[t]) : make_float2(0.f, 0.f);
        const long off = ch.base + (long)(ch.t0 + t) * ch.rs + c;
        *reinterpret_cast<__nv_bfloat162*>(dq + off) =
            __floats2bfloat162_rn(accQ[nt][e] + uu.x * kk.x, accQ[nt][e + 1] + uu.y * kk.y);
        *reinterpret_cast<__nv_bfloat162*>(dk + off) =
            __floats2bfloat162_rn(accK[nt][e] + uu.x * qq.x, accK[nt][e + 1] + uu.y * qq.y);
      }
    }
  STAMP(1, 7);
  __syncthreads();  // W and the diagonal dq are read no more: their tiles take dW (+ dE) and dE
  float* sZ = sW;  // dW[t] + (dE[t] when E = W)
  float* sE = sX;  // dE[t], for E[t] = W[t-1]
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int t = row0 + acc_row(e), c = 8 * nt + acc_col(e);
      const float de = bf(sQ, t, c) * accQ[nt][e], dw = -bf(sK, t, c) * accK[nt][e];
      sZ[t * kFs + c] = dw + (inc ? de : 0.f);
      sE[t * kFs + c] = de;
    }
  __syncthreads();
  STAMP(1, 8);
  if (threadIdx.x < kDim) {
    // dlog_w[s] = dW_Q + sum_{t >= s} (dW[t] + dE[t], or dE[t + 1])
    const int c = threadIdx.x;
    float acc = sDwq[c];
    for (int t = kChunk - 1; t >= 0; --t) {
      acc += sZ[t * kFs + c] + (!inc && t + 1 < kChunk ? sE[(t + 1) * kFs + c] : 0.f);
      if (t < ch.len) p.dlog_w[ch.base + (long)(ch.t0 + t) * ch.rs + c] = acc;
    }
  } else if (u) {
    // this chunk's du = sum_t q k (dy . v)
    const int c = threadIdx.x - kDim;
    float acc = 0.f;
    for (int t = 0; t < kChunk; ++t) acc += bf(sQ, t, c) * bf(sK, t, c) * sDyv[t];
    p.du_part[slot * kDim + c] = acc;
  }
  STAMP(1, 9);
}

// Lets `kernel` take `smem` bytes of dynamic shared memory, once per device
// (slot: the kernel's bit; the attribute call on every launch cost host time).
cudaError_t with_smem(const void* kernel, int smem, int slot) {
  static unsigned done[64] = {};  // per device, a bit per kernel
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess || dev >= 64 || done[dev] >> slot & 1u) return err;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess) done[dev] |= 1u << slot;
  return err;
}

// The forward's three passes; states and wq are the caller's scratch.
cudaError_t forward(const Params& p, cudaStream_t stream) {
  const int chunks = (p.s + kChunk - 1) / kChunk;
  const dim3 grid(chunks, p.b * p.h);
  const int scan_blocks = p.b * p.h * kState / (kScanThreads * kScanVec);
  cudaError_t err;
  if ((err = with_smem((const void*)local_kernel<false>, kLocalSmem, 0)) != cudaSuccess) return err;
  local_kernel<false><<<grid, kThreadsTc, kLocalSmem, stream>>>(p);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  fwd_scan_kernel<<<scan_blocks, kScanThreads, 0, stream>>>(p, chunks);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  if ((err = with_smem((const void*)fwd_out_kernel, kOutSmem, 1)) != cudaSuccess) return err;
  fwd_out_kernel<<<grid, kThreadsTc, kOutSmem, stream>>>(p);
  return cudaGetLastError();
}

// The backward's three passes, from the forward's saved states and final
// state; dstates, wq and dwq are the caller's scratch.
cudaError_t backward(const Params& p, cudaStream_t stream) {
  const int chunks = (p.s + kChunk - 1) / kChunk;
  const dim3 grid(chunks, p.b * p.h);
  const int scan_blocks = p.b * p.h * kState / (kScanThreads * kScanVec);
  cudaError_t err;
  if ((err = with_smem((const void*)local_kernel<true>, kLocalSmem, 2)) != cudaSuccess) return err;
  local_kernel<true><<<grid, kThreadsTc, kLocalSmem, stream>>>(p);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  bwd_scan_kernel<<<scan_blocks, kScanThreads, 0, stream>>>(p, chunks);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  if ((err = with_smem((const void*)bwd_chunk_kernel, kChunkPassSmem, 3)) != cudaSuccess) return err;
  bwd_chunk_kernel<<<grid, kThreadsTc, kChunkPassSmem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace tc

// du = the sum of the partials over batch and parts (chunks on the bf16
// route, one on the f32 route), in one fixed order: no atomics. A block per
// head; thread (q, c) sums channel c of batches q, q + 4, ..., then thread c
// adds the four sums in order.
constexpr int kReduceThreads = 4 * kDim;

__global__ void __launch_bounds__(kReduceThreads) du_reduce_kernel(const float* du_part, float* du, int b, int h,
                                                                    int parts) {
  __shared__ float sum[kReduceThreads];
  const int hh = blockIdx.x, c = threadIdx.x % kDim, q = threadIdx.x / kDim;
  float acc[4] = {};  // four independent sums, added in order
  for (int bb = q; bb < b; bb += kReduceThreads / kDim) {
    const float* part = du_part + ((long)bb * h + hh) * parts * kDim + c;
#pragma unroll 4
    for (int n = 0; n < parts; ++n) acc[n & 3] += part[(long)n * kDim];
  }
  sum[threadIdx.x] = (acc[0] + acc[1]) + (acc[2] + acc[3]);
  __syncthreads();
  if (q == 0) du[hh * kDim + c] = ((sum[c] + sum[kDim + c]) + sum[2 * kDim + c]) + sum[3 * kDim + c];
}

int reduce_du(const Params& p, int parts, cudaStream_t stream) {
  if (!p.du_part) return cudaSuccess;
  du_reduce_kernel<<<p.h, kReduceThreads, 0, stream>>>(p.du_part, p.du, p.b, p.h, parts);
  return cudaGetLastError();
}

template <typename Kernel>
int launch(Kernel kernel, int smem, const Params& p, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  kernel<<<p.b * p.h, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

Params make_params(const void* q, const void* k, const void* v, const float* log_w, const float* u,
                   int b, int s, int h, int include_current) {
  Params p = {};
  p.q = q;
  p.k = k;
  p.v = v;
  p.log_w = log_w;
  p.u = u;
  p.b = b;
  p.s = s;
  p.h = h;
  p.include_current = include_current;
  return p;
}

}  // namespace

extern "C" {

// dtype: 0 float32 (the f32 route), 1 bfloat16 (the tensor-core passes) for
// q, k, v and y; K = V = 64 (checked by the caller). states: the saved
// states, (B*H, chunks, K, V) chunk-start states on the f32 route (written
// when not null), (B*H, chunks, kSlot) start states and A on the bf16 route
// (always: the passes need them); wq (B*H, chunks, K): bf16 scratch.
int gla_fwd(const void* q, const void* k, const void* v, const float* log_w, const float* u,
            const float* s0, void* y, float* s_final, float* states, float* wq, int b, int s, int h,
            int dtype, int include_current, cudaStream_t stream) {
  Params p = make_params(q, k, v, log_w, u, b, s, h, include_current);
  p.s0 = s0;
  p.y = y;
  p.s_final = s_final;
  p.states = states;
  p.wq = wq;
  if (dtype == 0) return launch(gla_fwd_kernel<float>, kFwdSmem, p, stream);
  return tc::forward(p, stream);
}

// states and s_final are what gla_fwd wrote for the same inputs; dy, dq, dk
// and dv are of the dtype of q. du (H, K) when u is given, from the scratch
// du_part: (B*H, K) for f32, (B*H, chunks, K) for bf16. dstates (B*H,
// chunks, K, V), wq (B*H, chunks, K) and dwq (B*H, chunks, K): bf16
// scratch.
int gla_bwd(const void* q, const void* k, const void* v, const float* log_w, const float* u,
            const void* dy, const float* states, const float* s_final, const float* d_final,
            void* dq, void* dk, void* dv, float* dlog_w, float* du_part, float* du, float* ds0,
            float* dstates, float* wq, float* dwq, int b, int s, int h, int dtype, int include_current,
            cudaStream_t stream) {
  Params p = make_params(q, k, v, log_w, u, b, s, h, include_current);
  p.dy = dy;
  p.states = const_cast<float*>(states);
  p.s_final = const_cast<float*>(s_final);
  p.d_final = d_final;
  p.dq = dq;
  p.dk = dk;
  p.dv = dv;
  p.dlog_w = dlog_w;
  p.du_part = du_part;
  p.du = du;
  p.ds0 = ds0;
  p.dstates = dstates;
  p.wq = wq;
  p.dwq = dwq;
  const int err = dtype == 0 ? launch(gla_bwd_kernel<float>, kBwdSmem, p, stream) : tc::backward(p, stream);
  if (err != cudaSuccess) return err;
  return reduce_du(p, dtype == 0 ? 1 : (s + kChunk - 1) / kChunk, stream);
}

#ifdef GLA_CLOCK_STAMPS
// The measurement build's stamps: (pass: output, backward chunk, local) x
// warp x stamp, as clock64() values.
int gla_clock_stamps(long long* out) {
  return cudaMemcpyFromSymbol(out, tc::g_stamps, sizeof(tc::g_stamps));
}
#endif

}  // extern "C"
