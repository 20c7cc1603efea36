// Fused logits -> token sampler for serving on Hopper (sm_90a). Bound by a
// plain C interface and ctypes (kernel.py).
//
// Replaces the Pallas TPU kernel fused_sample_rows (_sample_kernel) in
// src/repro/kernels/paged_decode/kernel.py, and computes what
// serve/step.py's sample_tokens computes, given the same gumbel noise:
//   greedy row (temperature <= 0): the first-index argmax of the logits;
//   sampled row: keep the logits at or above the k-th largest (duplicates
//   counted, as sort-descending[k - 1] counts them; top_k <= 0 keeps all),
//   divide by max(temperature, 1e-6), add the noise, first-index argmax.
//
// What bounds it on this card: it reads each logit and noise value (f32)
// and does a handful of compares per element, so it is bound by memory:
// B x V x 8 bytes.
//
// Design. One block of 1024 threads per row reduces over the whole
// vocabulary, reading four values per load (16 bytes) so that each thread
// has several loads in flight. The TPU kernel finds the k-th largest by stripping the first
// occurrence of the max top_k - 1 times, one full pass each; here a radix
// select over the logits' order-preserving 32-bit keys finds the same value
// in four passes of 8 bits, whatever k is (shared-memory histograms, one
// atomic per distinct bin per warp through __match_any_sync). Greedy rows
// skip the select and the noise entirely. Division and addition are the
// IEEE round-to-nearest operations, so the sampled token equals the plain
// version's bit for bit.
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kNoBin = 256u;

struct Best {
  float v;
  int i;
};

// larger value wins; among equal values the lower index (first occurrence)
__device__ __forceinline__ Best better(Best a, Best b) {
  return (b.v > a.v || (b.v == a.v && b.i < a.i)) ? b : a;
}

__device__ Best block_argmax(Best mine, Best* scratch) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    Best other{__shfl_xor_sync(0xffffffffu, mine.v, off), __shfl_xor_sync(0xffffffffu, mine.i, off)};
    mine = better(mine, other);
  }
  if (lane == 0) scratch[warp] = mine;
  __syncthreads();
  if (warp == 0) {
    mine = scratch[lane];  // kWarps == 32
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      Best other{__shfl_xor_sync(0xffffffffu, mine.v, off), __shfl_xor_sync(0xffffffffu, mine.i, off)};
      mine = better(mine, other);
    }
    if (lane == 0) scratch[0] = mine;
  }
  __syncthreads();
  Best result = scratch[0];
  __syncthreads();  // scratch is reused by the next reduction
  return result;
}

// unsigned keys in the same order as the floats (-0.0 just below +0.0)
__device__ __forceinline__ unsigned float_key(float x) {
  const unsigned u = __float_as_uint(x);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float key_float(unsigned k) {
  return __uint_as_float((k & 0x80000000u) ? (k & 0x7fffffffu) : ~k);
}

// Four consecutive values of a row, x[4c .. 4c + 3]: one 16-byte load when
// the row is 16-byte aligned (VEC), else four loads, -inf past the end.
template <bool VEC>
__device__ __forceinline__ float4 load4(const float* row, int c, int V) {
  if (VEC) return reinterpret_cast<const float4*>(row)[c];
  const int i = 4 * c;
  return make_float4(i < V ? row[i] : -INFINITY, i + 1 < V ? row[i + 1] : -INFINITY,
                     i + 2 < V ? row[i + 2] : -INFINITY, i + 3 < V ? row[i + 3] : -INFINITY);
}

__device__ __forceinline__ float lane4(const float4& a, int e) {
  return e == 0 ? a.x : e == 1 ? a.y : e == 2 ? a.z : a.w;
}

// the k-th largest value of x[0:V) (1 <= k <= V), duplicates counted
template <bool VEC>
__device__ float kth_largest(const float* x, int V, int k, unsigned* hist, unsigned* shared_state) {
  const int lane = threadIdx.x % 32;
  const int quads = (V + 3) / 4;
  unsigned prefix = 0, mask = 0, remaining = (unsigned)k;
  for (int shift = 24; shift >= 0; shift -= 8) {
    for (int i = threadIdx.x; i < 256; i += kThreads) hist[i] = 0;
    __syncthreads();
    for (int base = threadIdx.x - lane; base < quads; base += kThreads) {  // warp-uniform trip count
      const int c = base + lane;
      const float4 a = c < quads ? load4<VEC>(x, c, V) : make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        unsigned bin = kNoBin;
        if (4 * c + e < V) {
          const unsigned key = float_key(lane4(a, e));
          if ((key & mask) == prefix) bin = (key >> shift) & 255u;
        }
        const unsigned peers = __match_any_sync(0xffffffffu, bin);
        if (bin != kNoBin && lane == __ffs(peers) - 1) atomicAdd(&hist[bin], __popc(peers));
      }
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      unsigned above = 0;
      int bin = 255;
      for (; bin > 0; --bin) {
        if (above + hist[bin] >= remaining) break;
        above += hist[bin];
      }
      shared_state[0] = prefix | ((unsigned)bin << shift);
      shared_state[1] = remaining - above;
    }
    __syncthreads();
    prefix = shared_state[0];
    remaining = shared_state[1];
    mask |= 255u << shift;
    __syncthreads();
  }
  return key_float(prefix);
}

template <bool VEC>
__global__ void __launch_bounds__(kThreads)
    fused_sample_kernel(const float* logits, const float* noise, const float* temperature, const int* top_k,
                        int* out, int V) {
  __shared__ Best scratch[kWarps];
  __shared__ unsigned hist[256];
  __shared__ unsigned shared_state[2];
  const int row = blockIdx.x;
  const int quads = (V + 3) / 4;
  const float* x = logits + (long long)row * V;
  const float t = temperature[row];
  Best mine{-INFINITY, INT_MAX};

  if (!(t > 0.f)) {
    for (int c = threadIdx.x; c < quads; c += kThreads) {
      const float4 a = load4<VEC>(x, c, V);
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (4 * c + e < V) mine = better(mine, Best{lane4(a, e), 4 * c + e});
    }
    const Best best = block_argmax(mine, scratch);
    if (threadIdx.x == 0) out[row] = best.i;
    return;
  }

  const int k = top_k[row];
  const float kth = k > 0 ? kth_largest<VEC>(x, V, min(k, V), hist, shared_state) : -INFINITY;
  const float tt = fmaxf(t, 1e-6f);
  const float* n = noise + (long long)row * V;
  for (int c = threadIdx.x; c < quads; c += kThreads) {
    const float4 a = load4<VEC>(x, c, V), g = load4<VEC>(n, c, V);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float xe = lane4(a, e);
      const float kept = (k > 0 && xe < kth) ? -INFINITY : xe;
      if (4 * c + e < V) mine = better(mine, Best{__fadd_rn(__fdiv_rn(kept, tt), lane4(g, e)), 4 * c + e});
    }
  }
  const Best best = block_argmax(mine, scratch);
  if (threadIdx.x == 0) out[row] = best.i;
}

}  // namespace

extern "C" {

// logits, noise: (B, V) f32; temperature: (B,) f32; top_k: (B,) int32;
// out: (B,) int32. Returns a cudaError_t code (0 = launched).
int fused_sample(const float* logits, const float* noise, const float* temperature, const int* top_k, int* out,
                 int batch, int vocab, void* stream) {
  const bool vec = vocab % 4 == 0 && reinterpret_cast<uintptr_t>(logits) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(noise) % 16 == 0;
  if (vec)
    fused_sample_kernel<true><<<batch, kThreads, 0, (cudaStream_t)stream>>>(logits, noise, temperature, top_k, out,
                                                                            vocab);
  else
    fused_sample_kernel<false><<<batch, kThreads, 0, (cudaStream_t)stream>>>(logits, noise, temperature, top_k,
                                                                             out, vocab);
  return (int)cudaGetLastError();
}

}  // extern "C"
