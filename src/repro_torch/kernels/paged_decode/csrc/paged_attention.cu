// Paged attention for serving on Hopper (sm_90a): one-token decode and
// chunked prefill, reading K/V through the page table inside an online
// softmax. Bound by a plain C interface and ctypes (kernel.py).
//
// Replaces the Pallas TPU kernels in src/repro/kernels/paged_decode/kernel.py:
//   paged_flash_decode_grouped  (_decode_kernel)  -> paged_decode_kernel
//   paged_chunk_prefill_grouped (_prefill_kernel) -> paged_prefill_kernel
//
// What bounds them on this card: decode reads each live K/V position once
// (bf16, 2 x Hkv x D x 2 bytes a token) and does ~4 flops per byte, far
// below the H100's ~295 flops/byte ridge, so it is bound by memory, and at
// serving batch sizes by launch and load latency (B x Hkv blocks only).
// Chunked prefill reuses each K/V page for G x C query rows and is bound by
// its f32 FMA work.
//
// Design. The TPU kernels walk a sequential grid axis over pages with VMEM
// scratch carried between steps; here one block walks the pages of its slot
// in a loop and keeps the running max, sum and output in registers:
//   * a block is (row tile, kv head h, slot b); its rows are the G query
//     heads that share kv head h (decode), or the G x C (head, chunk offset)
//     rows of a chunk (prefill), row r = g * C + c at position pos[b] + c;
//   * each warp owns ROWS_PER_WARP rows. For the scores, lane (t, half)
//     dots key t of the page with half of the query, 16 bytes at a time, and
//     one shuffle joins the halves, so no per-key reduction chain is left;
//     for P.V a lane holds D/32 dims of each row's output, so that update
//     needs no reduction;
//   * the block loads each page index itself (the TPU kernel's scalar
//     prefetch) and stages the page's K and V for head h in shared memory
//     with cp.async, in a ring of kStages pages: the copies of the next
//     kStages - 1 pages are in flight while one page is computed on, so a
//     block waits for device memory about once per ring rather than once
//     per page;
//   * the page loop stops after the last page the tile's highest query
//     position can see, and with a sliding window starts at the first page
//     the lowest one can see. The TPU kernel iterates every page and masks
//     them; masked positions contribute nothing, so the result is the same.
//     Within a page, masked positions get probability 0 (scratch page 0 is
//     never read unmasked), exactly as in the TPU kernel.
// Table entries are clamped into the pool, so a corrupt table cannot fault.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kStages = 4;  // pages in the shared-memory ring
constexpr float kNegInf = -1.0e30f;
using KV = __nv_bfloat16;  // K/V pages are bf16

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

// dot product of one 16-byte chunk of a key row with the matching floats of a query
__device__ __forceinline__ float dot_chunk(const __nv_bfloat16* k, const float* q) {
  const uint4 raw = *reinterpret_cast<const uint4*>(k);
  const float4 q0 = *reinterpret_cast<const float4*>(q), q1 = *reinterpret_cast<const float4*>(q + 4);
  const float2 k0 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
  const float2 k1 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
  const float2 k2 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.z));
  const float2 k3 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.w));
  return q0.x * k0.x + q0.y * k0.y + q0.z * k1.x + q0.w * k1.y + q1.x * k2.x + q1.y * k2.y + q1.z * k3.x +
         q1.w * k3.y;
}

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

struct Params {
  const void* q;         // row (b, c, head) at b * q_stride_b + c * q_stride_c + head * D
  void* out;             // same layout and type as q
  const void* k_pages;   // (P, ps, Hkv, D)
  const void* v_pages;
  const int* page_table; // (B, MP)
  const int* pos;        // (B,) decode position, or chunk start
  long long q_stride_b, q_stride_c;
  int num_pages, ps, hkv, group, chunk, max_pages;
  int window;            // <= 0: no sliding window
  float softcap;         // <= 0: no soft-capping
  float scale;
};

// Start the asynchronous copy of page `phys`'s (ps, D) slice for head h
// into one ring stage (raw bf16). Every row is D * sizeof(KV) bytes, a
// multiple of 16, so the copies are 16-byte vectors.
template <int D>
__device__ __forceinline__ void copy_page(KV* ks, KV* vs, const KV* kp, const KV* vp, int phys, int h,
                                          const Params& p) {
  constexpr int kPerVec = 16 / sizeof(KV);
  constexpr int kVecPerRow = D / kPerVec;
  for (int vec = threadIdx.x; vec < p.ps * kVecPerRow; vec += kThreads) {
    const int t = vec / kVecPerRow, c = (vec % kVecPerRow) * kPerVec;
    const long long src = ((long long)(phys * p.ps + t) * p.hkv + h) * D + c;
    cp_async16(ks + t * D + c, kp + src);
    cp_async16(vs + t * D + c, vp + src);
  }
}

template <typename TQ, int DPL, int ROWS_PER_WARP>
__device__ __forceinline__ void paged_attend(const Params& p) {
  constexpr int D = 32 * DPL;
  extern __shared__ __align__(16) unsigned char smem[];
  const int page_elems = p.ps * D;
  KV* ring = reinterpret_cast<KV*>(smem);  // kStages x {K, V} x (ps, D)
  constexpr int kTileRows = kWarps * ROWS_PER_WARP;
  // then (kTileRows, ps) scores / probabilities and (kTileRows, D) queries, f32
  float* sc = reinterpret_cast<float*>(ring + 2 * kStages * page_elems);

  const int b = blockIdx.z, h = blockIdx.y;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int rows_total = p.group * p.chunk;
  const int r0 = blockIdx.x * kTileRows;
  const int r_end = min(r0 + kTileRows, rows_total);
  const int pos0 = p.pos[b];

  // query positions this tile spans
  int c_lo = p.chunk, c_hi = -1;
  for (int r = r0; r < r_end; ++r) {
    c_lo = min(c_lo, r % p.chunk);
    c_hi = max(c_hi, r % p.chunk);
  }
  const int qpos_hi = pos0 + c_hi;
  const int page_end = qpos_hi < 0 ? 0 : min(p.max_pages, qpos_hi / p.ps + 1);
  int page_begin = 0;
  if (p.window > 0) {
    const int first = pos0 + c_lo - p.window + 1;
    page_begin = first > 0 ? first / p.ps : 0;
  }

  // each warp's query rows, scaled, in shared memory: the score loop reads
  // them a 16-byte chunk at a time
  float* qs = sc + kTileRows * p.ps + warp * ROWS_PER_WARP * D;  // (ROWS_PER_WARP, D)
  const TQ* q = static_cast<const TQ*>(p.q);
  float o[ROWS_PER_WARP][DPL];
  float m[ROWS_PER_WARP], l[ROWS_PER_WARP];
  int qpos[ROWS_PER_WARP];
  long long qoff[ROWS_PER_WARP];
  bool valid[ROWS_PER_WARP];
#pragma unroll
  for (int i = 0; i < ROWS_PER_WARP; ++i) {
    const int r = r0 + warp * ROWS_PER_WARP + i;
    valid[i] = r < rows_total;
    const int g = valid[i] ? r / p.chunk : 0, c = valid[i] ? r % p.chunk : 0;
    qpos[i] = pos0 + c;
    qoff[i] = b * p.q_stride_b + c * p.q_stride_c + (long long)(h * p.group + g) * D;
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int k = 0; k < DPL; ++k) {
      qs[i * D + lane + 32 * k] = valid[i] ? to_f32(q[qoff[i] + lane + 32 * k]) * p.scale : 0.f;
      o[i][k] = 0.f;
    }
  }
  __syncwarp();

  const KV* kp = static_cast<const KV*>(p.k_pages);
  const KV* vp = static_cast<const KV*>(p.v_pages);
  const int* table = p.page_table + (long long)b * p.max_pages;
  const int npages = page_end - page_begin;
  // the n-th page of the loop lives in ring stage n % kStages: K, then V
  auto stage_k = [&](int n) { return ring + (2 * (n % kStages)) * page_elems; };
  auto fetch = [&](int n) {
    const int phys = min(max(table[page_begin + n], 0), p.num_pages - 1);
    copy_page<D>(stage_k(n), stage_k(n) + page_elems, kp, vp, phys, h, p);
  };
  // Scores: lane (t, half) = (lane % 16, lane / 16) dots key t of a group
  // of 16 with one half of the query, a 16-byte chunk at a time; the chunk
  // order is rotated by t so that the 8 lanes of a shared-memory phase read
  // 8 different banks. One shuffle joins the halves.
  constexpr int kPerChunk = 16 / sizeof(KV);
  constexpr int kHalfChunks = D / kPerChunk / 2;
  const int t_lane = lane % 16, half = lane / 16;
#pragma unroll
  for (int n = 0; n < kStages - 1; ++n) {
    if (n < npages) fetch(n);
    cp_async_commit();
  }
  for (int n = 0; n < npages; ++n) {
    const int j = page_begin + n;
    if (n + kStages - 1 < npages) fetch(n + kStages - 1);  // its stage was last read in iteration n - 1
    cp_async_commit();
    cp_async_wait<kStages - 1>();  // this thread's copies of page n have landed
    __syncthreads();               // and every thread's
    const KV* ks = stage_k(n);
    const KV* vs = ks + page_elems;

#pragma unroll
    for (int i = 0; i < ROWS_PER_WARP; ++i) {
      if (!valid[i]) continue;  // warp-uniform
      float* srow = sc + (warp * ROWS_PER_WARP + i) * p.ps;
      float page_max = kNegInf;
      for (int t0 = 0; t0 < p.ps; t0 += 16) {
        const int t = t0 + t_lane;
        float part = 0.f;
        if (t < p.ps) {
          const KV* krow = ks + t * D + half * (D / 2);
          const float* qrow = qs + i * D + half * (D / 2);
#pragma unroll
          for (int jj = 0; jj < kHalfChunks; ++jj) {
            const int c = ((jj + t) % kHalfChunks) * kPerChunk;
            part += dot_chunk(krow + c, qrow + c);
          }
        }
        part += __shfl_xor_sync(0xffffffffu, part, 16);
        float s = part;
        if (p.softcap > 0.f) s = p.softcap * tanhf(s / p.softcap);
        const int kpos = j * p.ps + t;
        const bool seen = t < p.ps && kpos <= qpos[i] && (p.window <= 0 || kpos > qpos[i] - p.window);
        s = seen ? s : kNegInf;
        page_max = fmaxf(page_max, s);
        if (half == 0 && t < p.ps) srow[t] = s;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) page_max = fmaxf(page_max, __shfl_xor_sync(0xffffffffu, page_max, off));
      const float m_new = fmaxf(m[i], page_max);
      __syncwarp();  // every lane's scores are in srow
      for (int t = lane; t < p.ps; t += 32) {  // probabilities in place of scores
        const float s = srow[t];
        srow[t] = s > 0.5f * kNegInf ? expf(s - m_new) : 0.f;  // masked keys: exactly 0
      }
      __syncwarp();
      const float alpha = expf(m[i] - m_new);
      l[i] *= alpha;
#pragma unroll
      for (int k = 0; k < DPL; ++k) o[i][k] *= alpha;
      for (int t = 0; t < p.ps; ++t) {
        const float pr = srow[t];
        if (pr == 0.f) continue;  // warp-uniform: masked (or underflowed) keys add nothing
        l[i] += pr;
#pragma unroll
        for (int k = 0; k < DPL; ++k) o[i][k] += pr * to_f32(vs[t * D + lane + 32 * k]);
      }
      m[i] = m_new;
      __syncwarp();  // srow is rewritten on the next page
    }
    __syncthreads();  // the stage is refilled in a later iteration
  }

  TQ* out = static_cast<TQ*>(p.out);
#pragma unroll
  for (int i = 0; i < ROWS_PER_WARP; ++i) {
    if (!valid[i]) continue;
    const float inv = 1.f / fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int k = 0; k < DPL; ++k) out[qoff[i] + lane + 32 * k] = from_f32<TQ>(o[i][k] * inv);
  }
}

constexpr int kDecodeRowsPerWarp = 2;   // a tile of 8 rows: all G = 8 heads of a group
constexpr int kPrefillRowsPerWarp = 4;  // a tile of 16 rows

template <typename TQ, int DPL>
__global__ void __launch_bounds__(kThreads) paged_decode_kernel(Params p) {
  paged_attend<TQ, DPL, kDecodeRowsPerWarp>(p);
}

template <typename TQ, int DPL>
__global__ void __launch_bounds__(kThreads) paged_prefill_kernel(Params p) {
  paged_attend<TQ, DPL, kPrefillRowsPerWarp>(p);
}

template <typename TQ, int DPL>
cudaError_t launch(Params p, int batch, bool decode, cudaStream_t stream) {
  const int rows_per_warp = decode ? kDecodeRowsPerWarp : kPrefillRowsPerWarp;
  const int tile_rows = kWarps * rows_per_warp;
  const int tiles = (p.group * p.chunk + tile_rows - 1) / tile_rows;
  const size_t smem = sizeof(KV) * 2 * kStages * p.ps * 32 * DPL +
                      sizeof(float) * kWarps * rows_per_warp * (p.ps + 32 * DPL);
  if (smem > 227 * 1024) return cudaErrorInvalidValue;  // the ring does not fit (kernel.py checks first)
  void (*kernel)(Params) = decode ? paged_decode_kernel<TQ, DPL> : paged_prefill_kernel<TQ, DPL>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  kernel<<<dim3(tiles, p.hkv, batch), kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename TQ>
cudaError_t dispatch_dim(Params p, int head_dim, int batch, bool decode, cudaStream_t stream) {
  switch (head_dim) {
    case 64: return launch<TQ, 2>(p, batch, decode, stream);
    case 128: return launch<TQ, 4>(p, batch, decode, stream);
    case 256: return launch<TQ, 8>(p, batch, decode, stream);
    default: return cudaErrorInvalidValue;
  }
}

// q dtype codes: 0 = float32, 1 = bfloat16
cudaError_t dispatch(Params p, int head_dim, int q_dtype, int batch, bool decode, cudaStream_t stream) {
  if (q_dtype == 0) return dispatch_dim<float>(p, head_dim, batch, decode, stream);
  if (q_dtype == 1) return dispatch_dim<__nv_bfloat16>(p, head_dim, batch, decode, stream);
  return cudaErrorInvalidValue;
}

Params make_params(const void* q, void* out, const void* k_pages, const void* v_pages, const int* page_table,
                   const int* pos, int hq, int hkv, int head_dim, int num_pages, int page_size, int max_pages,
                   int chunk, int window, float softcap) {
  Params p;
  p.q = q;
  p.out = out;
  p.k_pages = k_pages;
  p.v_pages = v_pages;
  p.page_table = page_table;
  p.pos = pos;
  p.q_stride_c = (long long)hq * head_dim;
  p.q_stride_b = p.q_stride_c * chunk;
  p.num_pages = num_pages;
  p.ps = page_size;
  p.hkv = hkv;
  p.group = hq / hkv;
  p.chunk = chunk;
  p.max_pages = max_pages;
  p.window = window;
  p.softcap = softcap;
  p.scale = (float)(1.0 / sqrt((double)head_dim));  // d ** -0.5, rounded once
  return p;
}

}  // namespace

extern "C" {

// q, out: (B, Hq, D). Returns a cudaError_t code (0 = launched).
int paged_flash_decode(const void* q, void* out, const void* k_pages, const void* v_pages, const int* page_table,
                       const int* positions, int batch, int hq, int hkv, int head_dim, int num_pages,
                       int page_size, int max_pages, int q_dtype, int window, float softcap,
                       void* stream) {
  Params p = make_params(q, out, k_pages, v_pages, page_table, positions, hq, hkv, head_dim, num_pages,
                         page_size, max_pages, 1, window, softcap);
  return (int)dispatch(p, head_dim, q_dtype, batch, true, (cudaStream_t)stream);
}

// q, out: (B, C, Hq, D). Returns a cudaError_t code (0 = launched).
int paged_chunk_prefill(const void* q, void* out, const void* k_pages, const void* v_pages, const int* page_table,
                        const int* pos_start, int batch, int chunk, int hq, int hkv, int head_dim,
                        int num_pages, int page_size, int max_pages, int q_dtype, int window,
                        float softcap, void* stream) {
  Params p = make_params(q, out, k_pages, v_pages, page_table, pos_start, hq, hkv, head_dim, num_pages,
                         page_size, max_pages, chunk, window, softcap);
  return (int)dispatch(p, head_dim, q_dtype, batch, false, (cudaStream_t)stream);
}

}  // extern "C"
