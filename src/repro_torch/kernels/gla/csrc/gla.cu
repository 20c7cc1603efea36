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
// u (H, 64) f32; states (B, H, 64, 64) f32. Per (batch, head), with W the
// inclusive prefix sum of log_w along the chunk and E the exponent with
// which a row reads (E = W when the current token is included, Mamba2;
// E[t] = W[t-1], W[-1] = 0, when it is not, RWKV6):
//   A[t,u] = sum_c q[t,c] k[u,c] exp(E[t,c] - W[u,c])   over u <= t (u < t)
//   y      = A v + (q * exp(E)) S + (sum_c q u k)[t] v[t]  (bonus: RWKV6 only)
//   S     <- S * exp(W_Q) + (k * exp(W_Q - W))^T v        (W_Q = W at the chunk's end)
// Every exponent evaluated is <= 0: masked entries are set to -inf before
// the exp, and the decay is never factored as exp(E) * exp(-W), which
// overflows under strong decay. This is why the chunked form is a kernel.
//
// What bounds it on this card: at the training shape (B 4, S 513, H 32,
// bf16) the forward must move ~52 MB and do ~2.2 GFLOP of matrix products,
// the backward ~100 MB and ~4.8 GFLOP: both bound by bytes (~16 and ~30 us
// at the HBM rate). This first version computes with f32 FMAs and one exp
// per pairwise (t, u, channel) term on the CUDA cores, with one block (8
// warps) per SM, so it is bound by those operations and their latency, far
// above the bound; mma/wgmma products and a grid wider than B x H blocks
// are later work.
//
// Design. The TPU kernel walks a sequential chunk grid axis and keeps the
// (K, V) state in VMEM scratch. Blocks on this card run in no order, so one
// block of 256 threads takes a (batch, head) and walks its chunks of 64
// positions in order itself, keeping the f32 state in shared memory; q, k,
// v and log_w tiles are staged there in f32 (rows padded to 65 floats, so
// that a column read falls on distinct banks). A thread owns a 4 x 4 block
// of every 64 x 64 product (rows ty + 16 i, columns tx + 16 j). The last
// chunk may be short: its rows past S read zeros (log_w 0) and are not
// written, so any S works. About 100 KB of shared memory (backward 151 KB),
// above the 48 KB default, set with cudaFuncSetAttribute.
//
// The forward optionally writes each chunk's starting state for the
// backward. The backward, one block per (batch, head) again, walks the
// chunks in reverse with the state's gradient dS (64 x 64 f32) in shared
// memory, and per chunk recomputes A from the same <= 0 exponents:
//   dA = (dy v^T) masked;  dv = A^T dy + (k exp(W_Q - W)) dS + bonus;
//   dq = (dA * pairwise decay) k + exp(E) (dy S_n^T) + bonus;
//   dk = (dA * pairwise decay)^T q + exp(W_Q - W) (v dS^T) + bonus;
//   dE = q (dq - bonus), dW = -k (dk - bonus), dW_Q = rowsum(dS * S_{n+1});
//   dlog_w[s] = sum_{t >= s} (dW[t] + dE[t] or dE[t+1]) + dW_Q  (reverse prefix sums);
//   dS <- dS exp(W_Q) + (q exp(E))^T dy, which is ds0 after chunk 0.
// du is written per (batch, head) and summed over the batch by the caller
// in a fixed order. No atomics: the gradients are the same bits every run.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

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
  float* du_part;        // (B*H, K), or null
  float* ds0;            // (B*H, K, V), or null
  int b, s, h, include_current;
};

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

// dtype: 0 float32, 1 bfloat16 (q, k, v, y); K = V = 64 (checked by the caller).
int gla_fwd(const void* q, const void* k, const void* v, const float* log_w, const float* u,
            const float* s0, void* y, float* s_final, float* states, int b, int s, int h, int dtype,
            int include_current, cudaStream_t stream) {
  Params p = make_params(q, k, v, log_w, u, b, s, h, include_current);
  p.s0 = s0;
  p.y = y;
  p.s_final = s_final;
  p.states = states;
  if (dtype == 0) return launch(gla_fwd_kernel<float>, kFwdSmem, p, stream);
  return launch(gla_fwd_kernel<__nv_bfloat16>, kFwdSmem, p, stream);
}

// states and s_final are what gla_fwd wrote for the same inputs; dy, dq, dk
// and dv are of the dtype of q.
int gla_bwd(const void* q, const void* k, const void* v, const float* log_w, const float* u,
            const void* dy, const float* states, const float* s_final, const float* d_final,
            void* dq, void* dk, void* dv, float* dlog_w, float* du_part, float* ds0, int b, int s,
            int h, int dtype, int include_current, cudaStream_t stream) {
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
  p.ds0 = ds0;
  if (dtype == 0) return launch(gla_bwd_kernel<float>, kBwdSmem, p, stream);
  return launch(gla_bwd_kernel<__nv_bfloat16>, kBwdSmem, p, stream);
}

}  // extern "C"
