// Paged attention for serving on Hopper (sm_90a): one-token decode and
// chunked prefill, reading K/V through the page table inside an online
// softmax. Bound by a plain C interface and ctypes (kernel.py).
//
// Replaces the Pallas TPU kernels in src/repro/kernels/paged_decode/kernel.py:
//   paged_flash_decode_grouped  (_decode_kernel)
//     bf16 queries: tc::attend_kernel<..., kDecode = true> + tc::combine_kernel
//     f32 queries:  paged_decode_kernel
//   paged_chunk_prefill_grouped (_prefill_kernel)
//     bf16 queries: tc::attend_kernel<..., kDecode = false>
//     f32 queries:  paged_prefill_kernel
// Two routes by the query's type, as flash attention and GLA have: bf16 (the
// serving path at full width) on the tensor cores, f32 (the card-against-CPU
// checks, which need f32 math) on the CUDA-core kernels below.
//
// What bounds them on this card. Decode reads each visible K/V position once
// (bf16, 2 x Hkv x D x 2 bytes a token) and does ~4 flops per byte, far below
// the H100's ~295 flops/byte ridge: at serving sizes (8 slots of 544 tokens
// sharing a 256-token prefix, 2.7 MB of K/V) the byte bound is ~0.8 us, so
// what is left is latency: the
// launch, the dependent loads of position, table entry and page, and the
// combine. Chunked prefill does 4 x D flops per visible (query, key) pair on
// K/V that stays in L2; its bound is the tensor cores' rate, far below what
// a block's chain of dependent steps takes (clock stamps of the measurement
// build -DPAGED_CLOCK_STAMPS: tools/paged_bench.py --stamps).
//
// Design of the bf16 route (namespace tc). A block owns a tile of query rows
// that share one kv head h: row r = c * G + g is head h * G + g at position
// pos[b] + c (decode: C = 1, the G heads; prefill: the tile holds every head
// of a few consecutive positions). It walks the 16-key chunks of logical
// positions its rows can see, staged in shared memory by cp.async (each row of
// a chunk read through the page table, the page index clamped into the pool;
// keys outside the tile's visible range are zero-filled, never read).
//   1. The grid. Decode splits each slot's chunks over blocks. The layout
//      comes from the table width alone (decode_layout), so the host reads no
//      position: kDecodeKeyGroups chunks (two pages of 16) a split up to
//      kMaxDecodeSplits splits, and more chunks a split for a wider table, so
//      the grid and the f32 scratch (B x Hq x nsplit x (D + 2) floats, sized
//      by paged_decode_scratch_floats) stop growing with the cache length
//      past 8,192 positions (there a split of four chunks took 1.4x the time
//      of two; below it, dead splits cost less than longer walks would). A block whose split holds no visible key exits
//      at once. Each live split writes its partial
//      (m, l, o) in f32 to scratch, and combine_kernel merges a slot's live
//      splits in index order (no atomics: the same bits every call). A split
//      with no visible key adds exactly 0 (exp(-1e30 - m) = 0). Prefill
//      tiles hold 32 rows, run longest first, and their warps split the
//      chunks, so a 256-token chunk gives 128 blocks of 8 warps.
//   2. The products. Both go to the tensor cores as mma.sync m16n8k16 (bf16
//      in, f32 sums), FlashAttention-2 style, one warp per 16 query rows and
//      one chunk at a time: S = Q K^T from ldmatrix fragments of Q and K,
//      then O += P V with V from ldmatrix.trans; the accumulator of S is the
//      A fragment of P. q is bf16, so it reaches the tensor cores exactly;
//      the f32 scores are scaled after the product and soft-capped after
//      that. P is split into bf16 hi + lo (two P V products) to keep the
//      forwards within one bf16 ulp of the plain version: with P rounded to
//      bf16 alone, decode read 2.0x and prefill up to 14.4x that allowance on
//      the serving shapes (measured once on a variant that is not kept). The
//      online softmax stays in registers; the warps that split a tile's chunks
//      merge their (m, l, o) in shared memory in a fixed order.
//   3. K/V reuse. A prefill tile holds every head of its positions, so each
//      chunk it stages serves all G heads that share the kv head, instead of
//      one head a tile.
// Head dims: 64, 80 (zamba2's shared attention: 5 k-steps of Q K^T, 10
// n-tiles of P V, each row moved in 10 pieces of 16 bytes; the combine gives
// lanes 0-19 four columns each), 128 and 256 on the bf16 route; the f32
// route's lanes hold D / 32 columns, so it takes 64, 128 and 256.
// Masking is the TPU kernel's: causal on positions, with the optional sliding
// window and logit softcap; masked keys get probability exactly 0, so scratch
// page 0 is never read unmasked; each row ends with o / max(l, 1e-30).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

// ---------------------------------------------------------------------------
// The f32 route: CUDA-core kernels
// ---------------------------------------------------------------------------
// The TPU kernels walk a sequential grid axis over pages with VMEM scratch
// carried between steps; here one block walks the pages of its slot in a
// loop and keeps the running max, sum and output in registers:
//   * a block is (row tile, kv head h, slot b); its rows are the G query
//     heads that share kv head h (decode), or the G x C (head, chunk offset)
//     rows of a chunk (prefill), row r = g * C + c at position pos[b] + c;
//   * each warp owns ROWS_PER_WARP rows. For the scores, lane (t, half)
//     dots key t of the page with half of the query, 16 bytes at a time, and
//     one shuffle joins the halves; for P.V a lane holds D/32 dims of each
//     row's output, so that update needs no reduction;
//   * the block loads each page index itself (the TPU kernel's scalar
//     prefetch) and stages the page's K and V for head h in shared memory
//     with cp.async, in a ring of kStages pages;
//   * the page loop runs over the pages the tile's queries can see; within a
//     page, masked positions get probability 0.
// Table entries are clamped into the pool, so a corrupt table cannot fault.

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

template <int DPL, int ROWS_PER_WARP>
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
  const float* q = static_cast<const float*>(p.q);
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

  float* out = static_cast<float*>(p.out);
#pragma unroll
  for (int i = 0; i < ROWS_PER_WARP; ++i) {
    if (!valid[i]) continue;
    const float inv = 1.f / fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int k = 0; k < DPL; ++k) out[qoff[i] + lane + 32 * k] = o[i][k] * inv;
  }
}

constexpr int kDecodeRowsPerWarp = 2;   // a tile of 8 rows: all G = 8 heads of a group
constexpr int kPrefillRowsPerWarp = 4;  // a tile of 16 rows

template <int DPL>
__global__ void __launch_bounds__(kThreads) paged_decode_kernel(Params p) {
  paged_attend<DPL, kDecodeRowsPerWarp>(p);
}

template <int DPL>
__global__ void __launch_bounds__(kThreads) paged_prefill_kernel(Params p) {
  paged_attend<DPL, kPrefillRowsPerWarp>(p);
}

template <int DPL>
cudaError_t launch(Params p, int batch, bool decode, cudaStream_t stream) {
  const int rows_per_warp = decode ? kDecodeRowsPerWarp : kPrefillRowsPerWarp;
  const int tile_rows = kWarps * rows_per_warp;
  const int tiles = (p.group * p.chunk + tile_rows - 1) / tile_rows;
  const size_t smem = sizeof(KV) * 2 * kStages * p.ps * 32 * DPL +
                      sizeof(float) * kWarps * rows_per_warp * (p.ps + 32 * DPL);
  if (smem > 227 * 1024) return cudaErrorInvalidValue;  // the ring does not fit (kernel.py checks first)
  void (*kernel)(Params) = decode ? paged_decode_kernel<DPL> : paged_prefill_kernel<DPL>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  kernel<<<dim3(tiles, p.hkv, batch), kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// The bf16 route: tensor-core kernels
// ---------------------------------------------------------------------------
namespace tc {

using bf16 = __nv_bfloat16;
constexpr int kChunk = 16;             // keys a chunk: the K side of P V, two 8-key tiles of S
constexpr int kDecodeKeyGroups = 2;    // decode: warps a block, each on every 2nd chunk of the split
constexpr int kMaxDecodeSplits = 256;  // decode: splits a slot at most (8,192 positions at two chunks a split)
constexpr int kPrefillRowGroups = 2;   // prefill: 16-row tiles a block
constexpr int kPrefillKeyGroups = 4;   // prefill: warps on each row tile, each on every 4th chunk
constexpr int kPrefillStages = 2;      // prefill: chunk groups in the shared-memory ring
constexpr int kCombineWarps = 4;       // combine: query rows a block, a warp each

// A measurement build (-DPAGED_CLOCK_STAMPS) sums, per warp of one block
// of each kernel (blockIdx (0, 0, 0): decode's first split of slot 0 and kv
// head 0, the prefill tile that starts first and sees the most keys), the
// clock64() cycles of each section, read back by paged_clock_stamps: where a
// block's time goes. The plain build records nothing.
constexpr int kStampSections = 6;  // setup, waits, products, barrier, merge, store
constexpr int kStampWarps = 8;
#ifdef PAGED_CLOCK_STAMPS
__device__ long long g_stamps[2][kStampWarps][kStampSections];  // decode, prefill
#endif

__device__ __forceinline__ long long cycles() {
  long long t;
  asm volatile("mov.u64 %0, %%clock64;\n" : "=l"(t));
  return t;
}

struct Stamps {
#ifdef PAGED_CLOCK_STAMPS
  bool on;
  long long prev, acc[kStampSections];
  __device__ explicit Stamps(bool on_) : on(on_), prev(cycles()), acc{} {}
  __device__ void section(int k) {
    if (on) {
      const long long t = cycles();
      acc[k] += t - prev;
      prev = t;
    }
  }
  __device__ void flush(int kernel) {
    if (on)
      for (int k = 0; k < kStampSections; ++k) g_stamps[kernel][threadIdx.x >> 5][k] = acc[k];
  }
#else
  __device__ explicit Stamps(bool) {}
  __device__ void section(int) {}
  __device__ void flush(int) {}
#endif
};

struct Params {
  const bf16* q;           // row (b, c, head) at b * q_stride_b + c * q_stride_c + head * D
  bf16* out;               // same layout as q
  const bf16* k_pages;     // (P, ps, Hkv, D)
  const bf16* v_pages;
  const int* page_table;   // (B, MP)
  const int* pos;          // (B,) decode position, or chunk start
  float* part_o;           // decode: (B, Hkv, nsplit, G, D) partial outputs
  float2* part_ml;         // decode: (B, Hkv, nsplit, G) partial (max, sum)
  long long q_stride_b, q_stride_c;
  int batch, hq, num_pages, ps, hkv, group, chunk, max_pages;
  int split_chunks, nsplit;  // decode: chunks a split, and splits a slot (decode_layout)
  int window;              // <= 0: no sliding window
  float softcap;           // <= 0: no soft-capping
  float scale;
};

// The decode's split layout, from the table width alone: split_chunks, a
// multiple of kDecodeKeyGroups, is the fewest that keeps nsplit <= kMaxDecodeSplits.
struct DecodeLayout {
  int split_chunks, nsplit;
};
inline DecodeLayout decode_layout(int max_pages, int ps) {
  const long long chunks = ((long long)max_pages * ps + kChunk - 1) / kChunk;
  const long long groups = (chunks + kDecodeKeyGroups - 1) / kDecodeKeyGroups;
  const long long per = (groups + kMaxDecodeSplits - 1) / kMaxDecodeSplits;  // stages a split
  const int split_chunks = (per > 1 ? (int)per : 1) * kDecodeKeyGroups;
  const long long nsplit = (chunks + split_chunks - 1) / split_chunks;
  return {split_chunks, nsplit > 1 ? (int)nsplit : 1};  // an empty table: one split, which exits
}

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16-byte copy into shared memory; zero-fills (reads nothing) unless `live`
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool live) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(smem)), "l"(gmem),
               "r"(live ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p))
               : "memory");
}
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p))
               : "memory");
}

// c += a b: mma.sync m16n8k16, bf16 in, f32 accumulate
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t bits(__nv_bfloat162 h) { return *reinterpret_cast<uint32_t*>(&h); }

// (x, y) -> bf16 pairs hi = bf16(x, y) and lo = bf16((x, y) - hi)
__device__ __forceinline__ void split_hi_lo(float x, float y, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  const float2 f = __bfloat1622float2(h);
  hi = bits(h);
  lo = bits(__floats2bfloat162_rn(x - f.x, y - f.y));
}

// The keys that query positions [qlo, qhi] may see, [key_lo, key_hi] (the
// table addresses keys below max_pages * ps), as the chunk range
// [c_begin, c_end). The attention and combine kernels must agree on it.
__device__ __forceinline__ void visible_chunks(const Params& p, int qlo, int qhi, int& key_lo, int& key_hi,
                                               int& c_begin, int& c_end) {
  key_lo = p.window > 0 ? max(qlo - p.window + 1, 0) : 0;
  key_hi = min(qhi, p.max_pages * p.ps - 1);
  c_begin = key_lo / kChunk;
  c_end = key_hi >= key_lo ? key_hi / kChunk + 1 : c_begin;
}

// One warp: its 16 query rows (sQ, row stride kLd) against one staged chunk
// of 16 keys (sK, sV) starting at position key0; updates the running max m,
// this lane's part of the sum l and the output o of rows g and g + 8 (g =
// lane / 4). Row ri sees key t iff qwin[ri] < t <= qlim[ri].
template <int D>
__device__ __forceinline__ void attend_chunk(const bf16* sQ, const bf16* sK, const bf16* sV, int key0,
                                             const int (&qlim)[2], const int (&qwin)[2], const Params& p,
                                             float (&o)[D / 8][4], float (&m)[2], float (&l)[2]) {
  constexpr int kLd = D + 8;
  const int lane = threadIdx.x & 31;
  // S = Q K^T as two 16 x 8 tiles (keys 0-7, 8-15). ldmatrix x4 of Q gives
  // the A fragment (rows 0-7 / 8-15 x columns 0-7 / 8-15); of K, keys 0-7
  // and 8-15 at columns 0-7 and 8-15, the B fragments of both tiles.
  float s[2][4] = {};
  const bf16* qa = sQ + ((lane & 7) + 8 * ((lane >> 3) & 1)) * kLd + 8 * (lane >> 4);
  const bf16* kb = sK + ((lane & 7) + 8 * (lane >> 4)) * kLd + 8 * ((lane >> 3) & 1);
#pragma unroll
  for (int ks = 0; ks < D / 16; ++ks) {
    uint32_t a[4], bk[4];
    ldsm_x4(a, qa + 16 * ks);
    ldsm_x4(bk, kb + 16 * ks);
    mma(s[0], a, bk[0], bk[1]);
    mma(s[1], a, bk[2], bk[3]);
  }
  // scale, soft-cap, mask; the online softmax of rows g (elements 0, 1) and
  // g + 8 (2, 3); a row's four lanes (lane % 4) share it by two shuffles
  const int c2 = 2 * (lane & 3);
#pragma unroll
  for (int ri = 0; ri < 2; ++ri) {
    float mx = kNegInf;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float x = s[j][2 * ri + e] * p.scale;
        if (p.softcap > 0.f) x = p.softcap * tanhf(x / p.softcap);
        const int t = key0 + 8 * j + c2 + e;
        x = (t <= qlim[ri] && t > qwin[ri]) ? x : kNegInf;
        s[j][2 * ri + e] = x;
        mx = fmaxf(mx, x);
      }
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float m_new = fmaxf(m[ri], mx);
    const float alpha = __expf(m[ri] - m_new);
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float x = s[j][2 * ri + e];
        const float pr = x > 0.5f * kNegInf ? __expf(x - m_new) : 0.f;  // masked keys: exactly 0
        s[j][2 * ri + e] = pr;
        sum += pr;
      }
    }
    l[ri] = l[ri] * alpha + sum;
#pragma unroll
    for (int nt = 0; nt < D / 8; ++nt) {
      o[nt][2 * ri] *= alpha;
      o[nt][2 * ri + 1] *= alpha;
    }
    m[ri] = m_new;
  }
  // O += P V: the two S tiles are P's A fragment (16 rows x 16 keys), split
  // hi + lo; ldmatrix.trans of V (keys 0-7 / 8-15 x 8 columns) gives B.
  uint32_t ph[4], pl[4];
  split_hi_lo(s[0][0], s[0][1], ph[0], pl[0]);
  split_hi_lo(s[0][2], s[0][3], ph[1], pl[1]);
  split_hi_lo(s[1][0], s[1][1], ph[2], pl[2]);
  split_hi_lo(s[1][2], s[1][3], ph[3], pl[3]);
  const bf16* vb = sV + ((lane & 7) + 8 * ((lane >> 3) & 1)) * kLd + 8 * (lane >> 4);
#pragma unroll
  for (int n2 = 0; n2 < D / 16; ++n2) {
    uint32_t bv[4];
    ldsm_x4_trans(bv, vb + 16 * n2);
    mma(o[2 * n2], pl, bv[0], bv[1]);
    mma(o[2 * n2 + 1], pl, bv[2], bv[3]);
    mma(o[2 * n2], ph, bv[0], bv[1]);
    mma(o[2 * n2 + 1], ph, bv[2], bv[3]);
  }
}

template <int D, int RG, int KG, int ST>
constexpr size_t smem_bytes() {
  constexpr size_t q_tile = size_t(RG) * 16 * (D + 8) * sizeof(bf16);
  constexpr size_t ring = size_t(ST) * KG * 2 * kChunk * (D + 8) * sizeof(bf16);
  // after the walk the ring holds the warps' (m, l) and o for their merge
  constexpr size_t merge = size_t(KG) * RG * 32 * 4 * sizeof(float) + size_t(KG - 1) * RG * D * 4 * 32 / 8 * sizeof(float);
  return q_tile + (ring > merge ? ring : merge);
}

// A block: RG row tiles of 16 query rows of kv head h, and KG warps on each,
// warp (rg, kg) = (warp % RG, warp / RG) taking chunks c_begin + kg,
// c_begin + kg + KG, ...; the ring holds ST groups of KG chunks. Decode: the
// grid is (split, Hkv x row tiles, B) and a block covers the split_chunks
// chunks of its split; prefill: (row tiles, Hkv, B), a block covers every
// chunk its rows see.
template <int D, int RG, int KG, int ST, bool kDecode>
__global__ void __launch_bounds__(RG * KG * 32) attend_kernel(const Params p) {
  constexpr int kThreads = RG * KG * 32;
  constexpr int kRows = RG * 16;
  constexpr int kLd = D + 8;  // padded shared-memory row: the 8 rows of an ldmatrix hit 8 bank groups
  constexpr int kNt = D / 8;
  constexpr int kVec = D / 8;  // 16-byte vectors a row
  constexpr int kChunkElems = kChunk * kLd;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* sQ = reinterpret_cast<bf16*>(smem);  // (kRows, kLd)
  bf16* ring = sQ + kRows * kLd;              // (ST, KG, {K, V}, kChunk, kLd)

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int rg = warp % RG, kg = warp / RG;
  const int b = blockIdx.z;
  Stamps stamps(blockIdx.x == 0 && blockIdx.y == 0 && blockIdx.z == 0 && lane == 0);
  int h, tile, split = 0;
  if constexpr (kDecode) {
    const int tiles = (p.group + 15) / 16;
    h = blockIdx.y / tiles;
    tile = blockIdx.y % tiles;
    split = blockIdx.x;
  } else {
    h = blockIdx.y;
    tile = gridDim.x - 1 - blockIdx.x;  // later rows see more keys: start them first
  }
  const int rows_total = p.group * p.chunk;
  const int r0 = tile * kRows;
  const int pos0 = p.pos[b];
  int key_lo, key_hi, c_begin, c_end;
  visible_chunks(p, pos0 + r0 / p.group, pos0 + (min(r0 + kRows, rows_total) - 1) / p.group, key_lo, key_hi,
                 c_begin, c_end);
  if constexpr (kDecode) {
    c_begin = max(c_begin, split * p.split_chunks);
    c_end = min(c_end, (split + 1) * p.split_chunks);
    if (c_begin >= c_end) return;  // no visible key in this split: the combine skips it
  }

  // the query tile, rows past the last zero-filled
  const bf16* qh = p.q + b * p.q_stride_b + (long long)h * p.group * D;
  for (int v = threadIdx.x; v < kRows * kVec; v += kThreads) {
    const int r = v / kVec, col = (v % kVec) * 8, row = r0 + r;
    uint4 x = make_uint4(0u, 0u, 0u, 0u);
    if (row < rows_total)
      x = *reinterpret_cast<const uint4*>(qh + (row / p.group) * p.q_stride_c + (row % p.group) * D + col);
    *reinterpret_cast<uint4*>(sQ + r * kLd + col) = x;
  }
  // what this lane's rows (g and g + 8 of its warp's tile) may see
  int qlim[2], qwin[2];
#pragma unroll
  for (int ri = 0; ri < 2; ++ri) {
    const int row = r0 + rg * 16 + (lane >> 2) + 8 * ri;
    const int qpos = pos0 + row / p.group;
    qlim[ri] = row < rows_total ? min(qpos, key_hi) : -1;
    qwin[ri] = p.window > 0 ? qpos - p.window : -1;
  }

  const int* table = p.page_table + (long long)b * p.max_pages;
  // stage n: chunks c_begin + n * KG + i, i < KG, each row read through the
  // page table (the page index clamped into the pool); keys outside
  // [key_lo, key_hi] are zero-filled
  auto issue = [&](int n) {
    bf16* st = ring + (n % ST) * KG * 2 * kChunkElems;
    for (int v = threadIdx.x; v < KG * kChunk * kVec; v += kThreads) {
      const int i = v / (kChunk * kVec), t = (v / kVec) % kChunk, col = (v % kVec) * 8;
      const int key = (c_begin + n * KG + i) * kChunk + t;
      const bool live = key >= key_lo && key <= key_hi;
      long long src = 0;
      if (live) {
        const int page = min(max(__ldg(table + key / p.ps), 0), p.num_pages - 1);
        src = ((long long)page * p.ps + key % p.ps) * p.hkv * D + (long long)h * D + col;
      }
      bf16* dst = st + 2 * i * kChunkElems + t * kLd + col;
      cp_async16(dst, p.k_pages + src, live);
      cp_async16(dst + kChunkElems, p.v_pages + src, live);
    }
  };

  float o[kNt][4] = {};
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  const int nstages = (c_end - c_begin + KG - 1) / KG;
#pragma unroll
  for (int n = 0; n < ST - 1; ++n) {
    if (n < nstages) issue(n);
    cp_async_commit();
  }
  stamps.section(0);
  for (int n = 0; n < nstages; ++n) {
    if (n + ST - 1 < nstages) issue(n + ST - 1);  // its stage was last read in iteration n - 1
    cp_async_commit();
    cp_async_wait<ST - 1>();  // this thread's copies of stage n have landed
    __syncthreads();           // and every thread's (and the query tile)
    stamps.section(1);
    const int c = c_begin + n * KG + kg;
    if (c < c_end) {  // warp-uniform
      const bf16* sK = ring + ((n % ST) * KG + kg) * 2 * kChunkElems;
      attend_chunk<D>(sQ + rg * 16 * kLd, sK, sK + kChunkElems, c * kChunk, qlim, qwin, p, o, m, l);
    }
    stamps.section(2);
    __syncthreads();  // the stage is refilled in a later iteration
    stamps.section(3);
  }

  // each row's sum over its four lanes, then the KG warps of a row tile
  // merged in a fixed order: warp kg = 0 ends with (M, L, O) of its rows
#pragma unroll
  for (int ri = 0; ri < 2; ++ri) {
    l[ri] += __shfl_xor_sync(0xffffffffu, l[ri], 1);
    l[ri] += __shfl_xor_sync(0xffffffffu, l[ri], 2);
  }
  if constexpr (KG > 1) {
    __syncthreads();  // the ring is free
    float4* sML = reinterpret_cast<float4*>(ring);                 // (KG, RG, 32 lanes): m0, m1, l0, l1
    float* sO = reinterpret_cast<float*>(sML + KG * RG * 32);      // (KG - 1, RG, kNt, 4, 32 lanes)
    sML[(kg * RG + rg) * 32 + lane] = make_float4(m[0], m[1], l[0], l[1]);
    if (kg > 0) {
#pragma unroll
      for (int nt = 0; nt < kNt; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) sO[((((kg - 1) * RG + rg) * kNt + nt) * 4 + e) * 32 + lane] = o[nt][e];
    }
    __syncthreads();
    if (kg > 0) {
      stamps.section(4);
      stamps.flush(kDecode ? 0 : 1);
      return;
    }
    float mk[KG][2], lk[KG][2], M[2];
#pragma unroll
    for (int k = 0; k < KG; ++k) {
      const float4 x = sML[(k * RG + rg) * 32 + lane];
      mk[k][0] = x.x, mk[k][1] = x.y, lk[k][0] = x.z, lk[k][1] = x.w;
    }
#pragma unroll
    for (int ri = 0; ri < 2; ++ri) {
      M[ri] = mk[0][ri];
#pragma unroll
      for (int k = 1; k < KG; ++k) M[ri] = fmaxf(M[ri], mk[k][ri]);
      l[ri] = 0.f;
#pragma unroll
      for (int k = 0; k < KG; ++k) {
        mk[k][ri] = __expf(mk[k][ri] - M[ri]);  // warp k's factor; a warp that saw nothing has l = o = 0
        l[ri] += lk[k][ri] * mk[k][ri];
      }
      m[ri] = M[ri];
    }
#pragma unroll
    for (int nt = 0; nt < kNt; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = o[nt][e] * mk[0][e >> 1];
#pragma unroll
        for (int k = 1; k < KG; ++k) x += sO[((((k - 1) * RG + rg) * kNt + nt) * 4 + e) * 32 + lane] * mk[k][e >> 1];
        o[nt][e] = x;
      }
  }
  stamps.section(4);

  const int c2 = 2 * (lane & 3);
#pragma unroll
  for (int ri = 0; ri < 2; ++ri) {
    const int row = r0 + rg * 16 + (lane >> 2) + 8 * ri;
    if (row >= rows_total) continue;
    if constexpr (kDecode) {  // the split's partial, row g = row
      const long long idx = (((long long)b * p.hkv + h) * p.nsplit + split) * p.group + row;
      float2* dst = reinterpret_cast<float2*>(p.part_o + idx * D) + (c2 >> 1);
#pragma unroll
      for (int nt = 0; nt < kNt; ++nt) dst[4 * nt] = make_float2(o[nt][2 * ri], o[nt][2 * ri + 1]);
      if ((lane & 3) == 0) p.part_ml[idx] = make_float2(m[ri], l[ri]);
    } else {
      const float inv = 1.f / fmaxf(l[ri], 1e-30f);
      bf16* dst = p.out + b * p.q_stride_b + (row / p.group) * p.q_stride_c +
                  ((long long)h * p.group + row % p.group) * D + c2;
#pragma unroll
      for (int nt = 0; nt < kNt; ++nt)
        *reinterpret_cast<__nv_bfloat162*>(dst + 8 * nt) =
            __floats2bfloat162_rn(o[nt][2 * ri] * inv, o[nt][2 * ri + 1] * inv);
    }
  }
  stamps.section(5);
  stamps.flush(kDecode ? 0 : 1);
}

// Decode's second pass: a warp per query row (b, head) merges the partials
// of its slot's live splits in index order: M = max m_s, L = sum l_s
// exp(m_s - M), out = (sum o_s exp(m_s - M)) / max(L, 1e-30). Lane j holds
// split s0 + j's (m, l) and factor; the partial outputs are read kBatch
// splits at a time, all loads of a batch in flight together.
template <int D>
__global__ void __launch_bounds__(kCombineWarps * 32) combine_kernel(const Params p) {
  // output columns a lane: D / 32 for D = 64, 128, 256; for D = 80 four, on
  // lanes 0-19 (the others hold none)
  constexpr int kPer = 2 * ((D + 63) / 64);
  constexpr int kBatch = 8;
  const int row = blockIdx.x * kCombineWarps + (threadIdx.x >> 5), lane = threadIdx.x & 31;
  if (row >= p.batch * p.hq) return;
  const int b = row / p.hq, head = row % p.hq, h = head / p.group, g = head % p.group;
  const int pos0 = p.pos[b];
  int key_lo, key_hi, c_begin, c_end;
  visible_chunks(p, pos0, pos0, key_lo, key_hi, c_begin, c_end);
  const int s_lo = c_begin / p.split_chunks;
  const int s_hi = c_end > c_begin ? (c_end - 1) / p.split_chunks : s_lo - 1;
  const long long base = ((long long)b * p.hkv + h) * p.nsplit * p.group + g;  // split s at base + s * G
  auto ml_of = [&](int s) {
    return s <= s_hi ? p.part_ml[base + (long long)s * p.group] : make_float2(kNegInf, 0.f);
  };
  const bool cols = lane * kPer < D;  // this lane holds output columns
  const float2 first = ml_of(s_lo + lane);
  float M = first.x;
  for (int s = s_lo + 32 + lane; s <= s_hi; s += 32) M = fmaxf(M, ml_of(s).x);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) M = fmaxf(M, __shfl_xor_sync(0xffffffffu, M, off));
  float acc[kPer] = {};
  float L = 0.f;
  for (int s0 = s_lo; s0 <= s_hi; s0 += 32) {
    const float2 ml = s0 == s_lo ? first : ml_of(s0 + lane);
    const float w = __expf(ml.x - M);  // 0 past s_hi (l = 0 there too)
    L += w * ml.y;
    const int n = min(32, s_hi - s0 + 1);
    for (int j0 = 0; j0 < n; j0 += kBatch) {
      float x[kBatch][kPer];
#pragma unroll
      for (int j = 0; j < kBatch; ++j) {
        const float* src = p.part_o + (base + (long long)(s0 + j0 + j) * p.group) * D + lane * kPer;
#pragma unroll
        for (int i = 0; i < kPer; i += 2) {
          const float2 v = cols && j0 + j < n ? *reinterpret_cast<const float2*>(src + i) : make_float2(0.f, 0.f);
          x[j][i] = v.x, x[j][i + 1] = v.y;
        }
      }
#pragma unroll
      for (int j = 0; j < kBatch; ++j) {
        const float wj = __shfl_sync(0xffffffffu, w, (j0 + j) & 31);
#pragma unroll
        for (int i = 0; i < kPer; ++i) acc[i] += wj * x[j][i];
      }
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) L += __shfl_xor_sync(0xffffffffu, L, off);
  const float inv = 1.f / fmaxf(L, 1e-30f);
  if (!cols) return;
  __nv_bfloat162* dst = reinterpret_cast<__nv_bfloat162*>(p.out + b * p.q_stride_b + (long long)head * D + lane * kPer);
#pragma unroll
  for (int i = 0; i < kPer / 2; ++i) dst[i] = __floats2bfloat162_rn(acc[2 * i] * inv, acc[2 * i + 1] * inv);
}

template <class K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

template <int D>
cudaError_t launch(const Params& p, bool decode, cudaStream_t stream) {
  if (decode) {
    // ST = 1: a split of a table up to 8,192 positions wide is one stage; a
    // wider table's splits walk their stages (a second stage in the ring did
    // not speed them up)
    constexpr int RG = 1, KG = kDecodeKeyGroups, ST = 1;
    constexpr size_t smem = smem_bytes<D, RG, KG, ST>();
    auto kernel = attend_kernel<D, RG, KG, ST, true>;
    cudaError_t err = allow_smem(kernel, smem);
    if (err != cudaSuccess) return err;
    const int tiles = (p.group + 15) / 16;
    kernel<<<dim3(p.nsplit, p.hkv * tiles, p.batch), RG * KG * 32, smem, stream>>>(p);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    const int rows = p.batch * p.hq;
    combine_kernel<D><<<(rows + kCombineWarps - 1) / kCombineWarps, kCombineWarps * 32, 0, stream>>>(p);
  } else {
    constexpr int RG = kPrefillRowGroups, KG = kPrefillKeyGroups, ST = kPrefillStages;
    constexpr size_t smem = smem_bytes<D, RG, KG, ST>();
    auto kernel = attend_kernel<D, RG, KG, ST, false>;
    cudaError_t err = allow_smem(kernel, smem);
    if (err != cudaSuccess) return err;
    const int tiles = (p.group * p.chunk + RG * 16 - 1) / (RG * 16);
    kernel<<<dim3(tiles, p.hkv, p.batch), RG * KG * 32, smem, stream>>>(p);
  }
  return cudaGetLastError();
}

}  // namespace tc

// q dtype codes: 0 = float32 (CUDA cores), 1 = bfloat16 (tensor cores)
cudaError_t dispatch(const void* q, void* out, const void* k_pages, const void* v_pages, const int* page_table,
                     const int* pos, void* scratch, int batch, int chunk, int hq, int hkv, int head_dim,
                     int num_pages, int page_size, int max_pages, int q_dtype, int window,
                     float softcap, bool decode, cudaStream_t stream) {
  const long long q_stride_c = (long long)hq * head_dim;
  const float scale = (float)(1.0 / sqrt((double)head_dim));  // d ** -0.5, rounded once
  if (q_dtype == 0) {
    Params p;
    p.q = q;
    p.out = out;
    p.k_pages = k_pages;
    p.v_pages = v_pages;
    p.page_table = page_table;
    p.pos = pos;
    p.q_stride_c = q_stride_c;
    p.q_stride_b = q_stride_c * chunk;
    p.num_pages = num_pages;
    p.ps = page_size;
    p.hkv = hkv;
    p.group = hq / hkv;
    p.chunk = chunk;
    p.max_pages = max_pages;
    p.window = window;
    p.softcap = softcap;
    p.scale = scale;
    switch (head_dim) {
      case 64: return launch<2>(p, batch, decode, stream);
      case 128: return launch<4>(p, batch, decode, stream);
      case 256: return launch<8>(p, batch, decode, stream);
      default: return cudaErrorInvalidValue;
    }
  }
  if (q_dtype != 1) return cudaErrorInvalidValue;
  tc::Params p;
  p.q = static_cast<const tc::bf16*>(q);
  p.out = static_cast<tc::bf16*>(out);
  p.k_pages = static_cast<const tc::bf16*>(k_pages);
  p.v_pages = static_cast<const tc::bf16*>(v_pages);
  p.page_table = page_table;
  p.pos = pos;
  p.q_stride_c = q_stride_c;
  p.q_stride_b = q_stride_c * chunk;
  p.batch = batch;
  p.hq = hq;
  p.num_pages = num_pages;
  p.ps = page_size;
  p.hkv = hkv;
  p.group = hq / hkv;
  p.chunk = chunk;
  p.max_pages = max_pages;
  const tc::DecodeLayout layout = tc::decode_layout(max_pages, page_size);
  p.split_chunks = layout.split_chunks;
  p.nsplit = layout.nsplit;
  p.part_o = static_cast<float*>(scratch);
  p.part_ml = reinterpret_cast<float2*>(p.part_o + (long long)batch * hq * p.nsplit * head_dim);
  p.window = window;
  p.softcap = softcap;
  p.scale = scale;
  switch (head_dim) {
    case 64: return tc::launch<64>(p, decode, stream);
    case 80: return tc::launch<80>(p, decode, stream);  // zamba2's shared attention
    case 128: return tc::launch<128>(p, decode, stream);
    case 256: return tc::launch<256>(p, decode, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// Floats of the split scratch that paged_flash_decode takes for bf16 q:
// each split's (o, m, l) per query row.
long long paged_decode_scratch_floats(int batch, int hq, int head_dim, int max_pages, int page_size) {
  return (long long)batch * hq * tc::decode_layout(max_pages, page_size).nsplit * (head_dim + 2);
}

// q, out: (B, Hq, D). scratch (bf16 q only): paged_decode_scratch_floats
// floats. Returns a cudaError_t code (0 = launched).
int paged_flash_decode(const void* q, void* out, const void* k_pages, const void* v_pages, const int* page_table,
                       const int* positions, void* scratch, int batch, int hq, int hkv, int head_dim,
                       int num_pages, int page_size, int max_pages, int q_dtype, int window,
                       float softcap, void* stream) {
  return (int)dispatch(q, out, k_pages, v_pages, page_table, positions, scratch, batch, 1, hq, hkv, head_dim,
                       num_pages, page_size, max_pages, q_dtype, window, softcap, true, (cudaStream_t)stream);
}

// q, out: (B, C, Hq, D). Returns a cudaError_t code (0 = launched).
int paged_chunk_prefill(const void* q, void* out, const void* k_pages, const void* v_pages, const int* page_table,
                        const int* pos_start, int batch, int chunk, int hq, int hkv, int head_dim,
                        int num_pages, int page_size, int max_pages, int q_dtype, int window,
                        float softcap, void* stream) {
  return (int)dispatch(q, out, k_pages, v_pages, page_table, pos_start, nullptr, batch, chunk, hq, hkv,
                       head_dim, num_pages, page_size, max_pages, q_dtype, window, softcap, false,
                       (cudaStream_t)stream);
}

#ifdef PAGED_CLOCK_STAMPS
// The measurement build's stamps: (kernel: decode, prefill) x warp x section,
// cycles.
int paged_clock_stamps(long long* out) {
  return cudaMemcpyFromSymbol(out, tc::g_stamps, sizeof(tc::g_stamps));
}
#endif

}  // extern "C"
