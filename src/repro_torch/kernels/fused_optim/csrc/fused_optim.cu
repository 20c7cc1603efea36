// Fused SEBS optimizer updates on Hopper (sm_90a): pSGD, Polyak momentum
// and dual-averaging AdaGrad, each one launch over every parameter leaf.
// Bound by a plain C interface and ctypes (kernel.py).
//
// Replaces the Pallas TPU kernels psgd_blocked, momentum_blocked and
// adagrad_blocked (_psgd_kernel, _momentum_kernel, _adagrad_kernel) in
// src/repro/kernels/fused_optim/kernel.py:
//   psgd:       w' = (gamma (w - lr g) + lr a) / (gamma + lr)
//   momentum:   u' = beta u - lr g,  w' = w + u'
//   adagrad_da: z' = z + g,  s2' = s2 + g^2,  w' = a - lr z' / (delta^2 + s2')^nu
// all in f32, written in place into w and the state.
//
// What bounds it on this card: a handful of flops per element against
// 16 (psgd), 20 (momentum) or 28 (adagrad_da, which never reads w) bytes
// moved, so memory: each input is read once and each output written once.
//
// Design. The TPU kernel runs one pallas_call per leaf over (64, 128)
// blocks of the leaf padded to whole rows. Here one launch covers every
// leaf: the wrapper uploads a table of (pointers, element count, first
// block) per leaf, and each block of 256 threads finds its leaf by a
// binary search over the first blocks and handles 2,048 elements of it
// (eight per thread, all loads issued before the arithmetic), masking the
// leaf's tail; nothing is padded. A per-leaf launch would mean ~434
// launches an update at full width. The arithmetic uses the IEEE
// round-to-nearest intrinsics, so no multiply-add is contracted and psgd,
// momentum and adagrad_da (nu = 1) equal their plain PyTorch versions bit
// for bit (adagrad_da also for nu = 1/2, a square root as torch.pow takes
// it); for other nu the power is powf, within a few ulps of torch.pow.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kPerThread = 8;
constexpr int64_t kChunk = (int64_t)kThreads * kPerThread;  // elements per block

// The table, as int64: ``arrays`` pointers per leaf (leaf-major), then each
// leaf's element count, then each leaf's first block and the total.
struct Table {
  const int64_t* t;
  int leaves, arrays;
  __device__ float* ptr(int leaf, int a) const { return reinterpret_cast<float*>(t[leaf * arrays + a]); }
  __device__ int64_t count(int leaf) const { return t[leaves * arrays + leaf]; }
  __device__ int64_t first_block(int leaf) const { return t[leaves * arrays + leaves + leaf]; }
};

// The leaf of block ``blk``: the last leaf whose first block is <= blk.
__device__ int find_leaf(const Table& tab, int64_t blk) {
  int lo = 0, hi = tab.leaves - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) / 2;
    if (tab.first_block(mid) <= blk) lo = mid;
    else hi = mid - 1;
  }
  return lo;
}

// Each update works on kArrays f32 values of an element (v[0] = w, v[1] = g,
// then its state): it reads those named in kLoads and overwrites those named
// in kStores (bit a: v[a]).
struct Psgd {
  float lr, gamma, denom;  // denom = gamma + lr in f32
  static constexpr int kArrays = 3;  // w, g, anchor
  static constexpr unsigned kLoads = 0b111, kStores = 0b1;
  __device__ void operator()(float* v) const {
    const float num = __fadd_rn(__fmul_rn(gamma, __fsub_rn(v[0], __fmul_rn(lr, v[1]))), __fmul_rn(lr, v[2]));
    v[0] = __fdiv_rn(num, denom);
  }
};

struct Momentum {
  float lr, beta;
  static constexpr int kArrays = 3;  // w, g, u
  static constexpr unsigned kLoads = 0b111, kStores = 0b101;
  __device__ void operator()(float* v) const {
    v[2] = __fsub_rn(__fmul_rn(beta, v[2]), __fmul_rn(lr, v[1]));
    v[0] = __fadd_rn(v[0], v[2]);
  }
};

struct AdagradDA {
  float lr, delta2, nu;  // delta2 = delta^2 in f32
  static constexpr int kArrays = 5;  // w (written only), g, anchor, z, s2
  static constexpr unsigned kLoads = 0b11110, kStores = 0b11001;
  __device__ void operator()(float* v) const {
    const float g = v[1];
    v[3] = __fadd_rn(v[3], g);
    v[4] = __fadd_rn(v[4], __fmul_rn(g, g));
    const float base = __fadd_rn(delta2, v[4]);
    // nu = 1 and 1/2 as torch.pow computes them (the identity, a square
    // root); any other exponent through powf
    const float h = nu == 1.0f ? base : nu == 0.5f ? __fsqrt_rn(base) : powf(base, nu);
    v[0] = __fsub_rn(v[2], __fdiv_rn(__fmul_rn(lr, v[3]), h));
  }
};

// Each thread takes elements base + k * kThreads + tid, k < kPerThread: it
// issues every load first, then computes, then stores, so that all of its
// loads are in flight together.
template <typename Update>
__global__ void __launch_bounds__(kThreads) update_kernel(Table tab, Update up) {
  const int64_t blk = blockIdx.x;
  const int leaf = find_leaf(tab, blk);
  const int64_t n = tab.count(leaf);
  const int64_t base = (blk - tab.first_block(leaf)) * kChunk + threadIdx.x;
  float* x[Update::kArrays];
#pragma unroll
  for (int a = 0; a < Update::kArrays; ++a) x[a] = tab.ptr(leaf, a);
  float v[kPerThread][Update::kArrays];
#pragma unroll
  for (int k = 0; k < kPerThread; ++k) {
    const int64_t i = base + (int64_t)k * kThreads;
#pragma unroll
    for (int a = 0; a < Update::kArrays; ++a)
      v[k][a] = (Update::kLoads & (1u << a)) && i < n ? x[a][i] : 0.f;
  }
#pragma unroll
  for (int k = 0; k < kPerThread; ++k) up(v[k]);
#pragma unroll
  for (int k = 0; k < kPerThread; ++k) {
    const int64_t i = base + (int64_t)k * kThreads;
    if (i >= n) continue;
#pragma unroll
    for (int a = 0; a < Update::kArrays; ++a)
      if (Update::kStores & (1u << a)) x[a][i] = v[k][a];
  }
}

template <typename Update>
int run(const int64_t* table, int leaves, int64_t blocks, Update up, cudaStream_t stream) {
  if (blocks <= 0) return 0;
  update_kernel<Update><<<(unsigned)blocks, kThreads, 0, stream>>>(Table{table, leaves, Update::kArrays}, up);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// ``table`` lies on the device (see Table); ``blocks`` is its total.
int fused_psgd(const int64_t* table, int leaves, int64_t blocks, float lr, float gamma, float denom,
               cudaStream_t stream) {
  return run(table, leaves, blocks, Psgd{lr, gamma, denom}, stream);
}

int fused_momentum(const int64_t* table, int leaves, int64_t blocks, float lr, float beta,
                   cudaStream_t stream) {
  return run(table, leaves, blocks, Momentum{lr, beta}, stream);
}

int fused_adagrad_da(const int64_t* table, int leaves, int64_t blocks, float lr, float delta2,
                     float nu, cudaStream_t stream) {
  return run(table, leaves, blocks, AdagradDA{lr, delta2, nu}, stream);
}

}  // extern "C"
