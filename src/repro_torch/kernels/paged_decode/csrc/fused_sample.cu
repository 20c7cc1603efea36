// Fused logits -> token sampler for serving on Hopper (sm_90a). Bound by a
// plain C interface and ctypes (kernel.py).
//
// Replaces the Pallas TPU kernel fused_sample_rows (_sample_kernel) in
// src/repro/kernels/paged_decode/kernel.py, and computes what
// serve/step.py's sample_tokens computes, given the same gumbel noise:
//   greedy row (temperature <= 0, or NaN): the first-index argmax of the
//   logits;
//   sampled row: keep the logits at or above the k-th largest (duplicates
//   counted, as sort-descending[k - 1] counts them; top_k <= 0 or >= V
//   keeps all), divide by max(temperature, 1e-6), add the noise, take the
//   first-index argmax.
//
// What bounds it on this card: it must read every logit once (f32) and the
// noise of the logits it scores: all of a row that keeps every logit, the
// kept ones of a top-k row. A handful of operations an element: bound by
// memory, and at serving's batch of 1 to 8 rows by the latency of a chain
// of dependent steps.
//
// Design. Grid (split, row): each row is cut into slices of at most 4,096
// values (a multiple of 4, so that a slice of an aligned row starts on a
// 16-byte boundary), enough of them that the grid fills the card at a
// batch of one (layout). Each block reads its slice once, into registers
// (16-byte loads where the row is aligned and V % 4 == 0, else one value at
// a time), and then, by the row's kind:
//   greedy row: its slice's (max, first index) into the row's partials;
//   keep-all row: the same of x / t + noise, reading the slice's noise;
//   top-k row: a radix select over the order-preserving 32-bit keys of its
//     slice (8 bits a pass, from the top; shared-memory histograms) finds a
//     threshold at or below the slice's own k-th largest, stopping as soon
//     as the bin that holds it adds at most kSlack values beyond k; the
//     block appends every value at or above the threshold to the row's
//     candidates, with its index and its score x / t + noise (the noise
//     gathered for these values alone). The row's k-th largest is never
//     below a slice's own (the slice holds k values at or above its own),
//     so the candidates hold every value the row keeps, ties included.
// The last block of a row to finish merges. A row's counter is one 64-bit
// word, the tickets in its high half and the candidates in its low half,
// so the last ticket also gives their number; the merging block sets it
// back to 0, so no launch clears it. The merge takes the partials in any
// order (the argmax of (value, index) is order-free), or, for a top-k row,
// finds the exact k-th largest among the candidates (their keys in shared
// memory; a radix select below the bits that every candidate shares, the
// keys ranked in one warp once at most 32 are left in the bin that holds
// it) and the argmax of the scores of the candidates at or above it. Where
// no kept score is above -inf, or the k-th largest is NaN, the merging
// block walks the whole row as the plain version does (the masked logits'
// scores then decide). Division and addition are the IEEE round-to-nearest
// operations, so the token equals the plain version's bit for bit, whatever
// the split.
//
// The counters must be 0 when a call starts: the wrapper keeps one buffer
// per (device, stream), so that two calls that may run at once never share
// one.
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;
constexpr int kBlocksPerSM = 2;                      // registers held to 64 a thread
constexpr int kWarps = kThreads / 32;
constexpr int kQuads = 2;                            // 16-byte quads a thread holds
constexpr int kValues = 4 * kQuads;                  // values a thread holds
constexpr int kMaxSlice = kValues * kThreads;        // 4,096
constexpr int kMinSlice = 1024;
constexpr int kTargetBlocks = 2 * 132;               // two a SM at a batch of one
constexpr unsigned kSlack = 16;                      // candidates a slice may add beyond its k
constexpr int kMergeCache = 8192;                    // candidates' keys a merge keeps in shared memory
constexpr int kMergeBatch = 8;                       // candidates a thread loads at once in a merge

// A measurement build (-DSAMPLE_CLOCK_STAMPS) sums, over the blocks of each
// row kind (greedy, keep-all, top-k), thread 0's clock64() cycles in each
// section: the slice pass (0: load and select, or load and the thread's
// argmax; 1: emit the candidates, or the block's argmax; 2: fence and
// ticket) and the merge (3: the partials, or the candidates' keys into
// shared memory; 4: the select; 5: the scores; 6: the whole row), and
// counts the blocks of each pass; read back by fused_sample_clock_stamps.
// The plain build records nothing.
constexpr int kStampSections = 7;
#ifdef SAMPLE_CLOCK_STAMPS
__device__ unsigned long long g_stamps[3][kStampSections + 2];
#endif

__device__ __forceinline__ long long cycles() {
  long long t;
  asm volatile("mov.u64 %0, %%clock64;\n" : "=l"(t));
  return t;
}

struct Stamps {
#ifdef SAMPLE_CLOCK_STAMPS
  int kind;
  long long prev;
  __device__ explicit Stamps(int kind_) : kind(kind_), prev(cycles()) {}
  __device__ void section(int k) {
    if (threadIdx.x == 0) {
      const long long t = cycles();
      atomicAdd(&g_stamps[kind][k], (unsigned long long)(t - prev));
      prev = t;
    }
  }
  __device__ void count(int pass) {
    if (threadIdx.x == 0) atomicAdd(&g_stamps[kind][kStampSections + pass], 1ull);
  }
#else
  __device__ explicit Stamps(int) {}
  __device__ void section(int) {}
  __device__ void count(int) {}
#endif
};

struct Best {
  float v;
  int i;
};

// larger value wins; among equal values the lower index (first occurrence);
// a NaN never wins
__device__ __forceinline__ Best better(Best a, Best b) {
  return (b.v > a.v || (b.v == a.v && b.i < a.i)) ? b : a;
}

__device__ Best block_argmax(Best mine, Best* red) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    Best other{__shfl_xor_sync(0xffffffffu, mine.v, off), __shfl_xor_sync(0xffffffffu, mine.i, off)};
    mine = better(mine, other);
  }
  if (lane == 0) red[warp] = mine;
  __syncthreads();
  if (warp == 0) {
    mine = lane < kWarps ? red[lane] : Best{-INFINITY, INT_MAX};
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      Best other{__shfl_xor_sync(0xffffffffu, mine.v, off), __shfl_xor_sync(0xffffffffu, mine.i, off)};
      mine = better(mine, other);
    }
    if (lane == 0) red[0] = mine;
  }
  __syncthreads();
  const Best result = red[0];
  __syncthreads();  // red is reused by the next reduction
  return result;
}

// unsigned keys in the order of the floats, +0.0 and -0.0 one key (they
// compare equal, so either may stand for the k-th largest)
__device__ __forceinline__ unsigned float_key(float x) {
  const unsigned u = __float_as_uint(x);
  if ((u << 1) == 0u) return 0x80000000u;
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float key_float(unsigned k) {
  return __uint_as_float((k & 0x80000000u) ? (k & 0x7fffffffu) : ~k);
}

// Four consecutive values x[4c .. 4c + 3] of a run of n: one 16-byte load
// when the run is 16-byte aligned (VEC), else four loads, -inf past the end.
template <bool VEC>
__device__ __forceinline__ float4 load4(const float* x, int c, int n) {
  if (VEC) return reinterpret_cast<const float4*>(x)[c];
  const int i = 4 * c;
  return make_float4(i < n ? x[i] : -INFINITY, i + 1 < n ? x[i + 1] : -INFINITY,
                     i + 2 < n ? x[i + 2] : -INFINITY, i + 3 < n ? x[i + 3] : -INFINITY);
}

__device__ __forceinline__ void store4(float* dst, const float4& a) {
  dst[0] = a.x;
  dst[1] = a.y;
  dst[2] = a.z;
  dst[3] = a.w;
}

// Radix select over the keys that for_each(f) hands to f(key, valid), all
// of which share their top `known` bits with `known_prefix`: 8 bits a pass
// below those. Returns the k-th largest key (1 <= k <= the valid keys), or,
// with early, the floor of the first bin that holds it and at most kSlack
// keys beyond the k largest: every key at or above the returned one is then
// among the k largest or that bin. Without early, once the bin holding the
// k-th largest has at most 32 keys, they are gathered and ranked in one
// warp instead of the passes left. state: 3 words; list: 32.
template <class ForEach>
__device__ unsigned radix_select(ForEach for_each, unsigned k, bool early, int known, unsigned known_prefix,
                                 unsigned* hist, unsigned* state, unsigned* list) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  unsigned mask = known > 0 ? ~0u << (32 - known) : 0u;
  unsigned prefix = known_prefix & mask, remaining = k;
  for (int hi = 32 - known; hi > 0; hi -= 8) {
    const int lo = hi > 8 ? hi - 8 : 0;
    const unsigned digit = (1u << (hi - lo)) - 1u;
    for (int i = threadIdx.x; i < 256; i += kThreads) hist[i] = 0;
    __syncthreads();
    for_each([&](unsigned key, bool valid) {  // increments of 1: aggregated per address (ATOMS.POPC.INC)
      if (valid && (key & mask) == prefix) atomicAdd(&hist[(key >> lo) & digit], 1u);
    });
    __syncthreads();
    if (warp == 0) {
      // lane l holds bins 255 - 8l down to 248 - 8l; the bin is the highest b
      // with sum(hist[b..255]) >= remaining
      const int top = 255 - 8 * lane;
      unsigned mine = 0;
#pragma unroll
      for (int j = 0; j < 8; ++j) mine += hist[top - j];
      unsigned incl = mine;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const unsigned up = __shfl_up_sync(0xffffffffu, incl, off);
        if (lane >= off) incl += up;
      }
      unsigned above = incl - mine;
      if (above < remaining && incl >= remaining) {
        int bin = top;
        for (; bin > top - 7; --bin) {
          if (above + hist[bin] >= remaining) break;
          above += hist[bin];
        }
        state[0] = (unsigned)bin;
        state[1] = above;
        state[2] = 0;
      }
    }
    __syncthreads();
    const unsigned bin = state[0];
    const unsigned in_bin = hist[bin];
    prefix |= bin << lo;
    remaining -= state[1];
    mask |= digit << lo;
    if (early) {
      __syncthreads();  // hist and state are rewritten by the next pass
      if (in_bin - remaining <= kSlack) break;
    } else if (lo > 0 && in_bin <= 32) {
      for_each([&](unsigned key, bool valid) {
        if (valid && (key & mask) == prefix) list[atomicAdd(&state[2], 1u)] = key;
      });
      __syncthreads();
      if (warp == 0) {
        // the key with fewer than `remaining` keys above it and at least
        // `remaining` at or above it
        const bool have = lane < (int)in_bin;
        const unsigned mine = have ? list[lane] : 0u;
        unsigned gt = 0, ge = 0;
#pragma unroll
        for (int j = 0; j < 32; ++j) {
          const unsigned other = __shfl_sync(0xffffffffu, mine, j);
          if (j < (int)in_bin) {
            gt += other > mine;
            ge += other >= mine;
          }
        }
        if (have && gt < remaining && ge >= remaining) state[0] = mine;
      }
      __syncthreads();
      prefix = state[0];
      __syncthreads();
      break;
    } else {
      __syncthreads();
    }
  }
  return prefix;
}

// Exclusive prefix of each thread's count over the block; *total gets the sum.
__device__ int block_exclusive_sum(int mine, int* warp_sums, int* total) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  int incl = mine;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int up = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl += up;
  }
  if (lane == 31) warp_sums[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    const int w = lane < kWarps ? warp_sums[lane] : 0;
    int wincl = w;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int up = __shfl_up_sync(0xffffffffu, wincl, off);
      if (lane >= off) wincl += up;
    }
    if (lane < kWarps) warp_sums[lane] = wincl - w;
    if (lane == kWarps - 1) *total = wincl;
  }
  __syncthreads();
  const int result = warp_sums[warp] + incl - mine;
  __syncthreads();
  return result;
}

__device__ __forceinline__ float score(float x, float tt, float g) { return __fadd_rn(__fdiv_rn(x, tt), g); }

// a row's candidates: value, score and index, room for V of each a row
struct Candidates {
  float* v;
  float* s;
  int* i;
};

template <bool VEC>
__global__ void __launch_bounds__(kThreads, kBlocksPerSM)
    sample_kernel(const float* logits, const float* noise, const float* temperature, const int* top_k, int* out,
                  Best* partials, Candidates cand, unsigned long long* counters, int V, int slice) {
  __shared__ Best red[kWarps];
  __shared__ unsigned hist[256];
  __shared__ unsigned state[3];
  __shared__ unsigned list[32];
  __shared__ int warp_sums[kWarps];
  __shared__ int shared_int[2];
  __shared__ unsigned shared_and, shared_or;
  __shared__ unsigned long long shared_ticket;
  __shared__ unsigned merge_keys[kMergeCache];
  const int split = blockIdx.x, splits = gridDim.x, row = blockIdx.y;
  const int lo = split * slice, n = min(slice, V - lo);
  const long long row_base = (long long)row * V;
  const float* x = logits + row_base;
  const float* g = noise + row_base;
  const float t = temperature[row];
  const int k = top_k[row];
  const bool greedy = !(t > 0.f);
  const bool keep_all = !greedy && (k <= 0 || k >= V);
  const float tt = fmaxf(t, 1e-6f);
  Stamps stamps(greedy ? 0 : keep_all ? 1 : 2);

  // this thread's values of the slice: value e of quad j is x[lo + 4 (tid + j kThreads) + e]
  float val[kValues];
#pragma unroll
  for (int j = 0; j < kQuads; ++j) {
    const int c = threadIdx.x + j * kThreads;
    const float4 a = 4 * c < n ? load4<VEC>(x + lo, c, n) : make_float4(-INFINITY, -INFINITY, -INFINITY, -INFINITY);
    store4(val + 4 * j, a);
  }
  auto index = [&](int e) { return lo + 4 * (threadIdx.x + (e / 4) * kThreads) + e % 4; };

  if (greedy || keep_all) {
    float gv[kValues];
    if (keep_all) {
#pragma unroll
      for (int j = 0; j < kQuads; ++j) {
        const int c = threadIdx.x + j * kThreads;
        const float4 a = 4 * c < n ? load4<VEC>(g + lo, c, n) : make_float4(0.f, 0.f, 0.f, 0.f);
        store4(gv + 4 * j, a);
      }
    }
    Best mine{-INFINITY, INT_MAX};
#pragma unroll
    for (int e = 0; e < kValues; ++e) {
      const int i = index(e);
      if (i - lo < n) mine = better(mine, Best{keep_all ? score(val[e], tt, gv[e]) : val[e], i});
    }
    stamps.section(0);
    const Best best = block_argmax(mine, red);
    if (threadIdx.x == 0) partials[(long long)row * splits + split] = best;
  } else {
    const unsigned kk = (unsigned)min(k, n);
    unsigned threshold = 0u;  // a slice of at most k values gives them all
    if (kk < (unsigned)n) {
      threshold = radix_select(
          [&](auto&& f) {
#pragma unroll
            for (int e = 0; e < kValues; ++e) f(float_key(val[e]), index(e) - lo < n);
          },
          kk, true, 0, 0u, hist, state, list);
    }
    stamps.section(0);
    // the candidates' noise first, so that its loads run under the count
    float gv[kValues];
    int count = 0;
#pragma unroll
    for (int e = 0; e < kValues; ++e) {
      const bool kept = index(e) - lo < n && float_key(val[e]) >= threshold;
      gv[e] = kept ? g[index(e)] : 0.f;
      count += kept;
    }
    int* total = &shared_int[0];
    int at = block_exclusive_sum(count, warp_sums, total);
    if (threadIdx.x == 0) shared_int[1] = (int)atomicAdd(&counters[row], (unsigned long long)*total);
    __syncthreads();
    at += shared_int[1];
#pragma unroll
    for (int e = 0; e < kValues; ++e) {
      if (index(e) - lo < n && float_key(val[e]) >= threshold) {
        cand.v[row_base + at] = val[e];
        cand.s[row_base + at] = score(val[e], tt, gv[e]);
        cand.i[row_base + at] = index(e);
        ++at;
      }
    }
  }
  stamps.section(1);

  // the last block of the row merges
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) shared_ticket = atomicAdd(&counters[row], 1ull << 32);
  __syncthreads();
  stamps.section(2);
  stamps.count(0);
  if ((int)(shared_ticket >> 32) != splits - 1) return;
  __threadfence();
  stamps.count(1);
  if (threadIdx.x == 0) counters[row] = 0;

  if (greedy || keep_all) {
    Best mine{-INFINITY, INT_MAX};
    for (int s = threadIdx.x; s < splits; s += kThreads) {
      const Best* p = partials + (long long)row * splits + s;
      mine = better(mine, Best{__ldcg(&p->v), __ldcg(&p->i)});
    }
    const Best best = block_argmax(mine, red);
    if (threadIdx.x == 0) out[row] = best.i;
    stamps.section(3);
    return;
  }

  // top-k row: the candidates' keys, kMergeBatch a thread at a time so that
  // their loads are in flight together: into shared memory where they all
  // fit (read from L2 once), else from L2 at each pass; on the way, the
  // bits every candidate shares (an AND and an OR of their keys)
  const int n_cand = (int)(shared_ticket & 0xffffffffu);
  const float* cv = cand.v + row_base;
  const bool cached = n_cand <= kMergeCache;
  unsigned all_and = ~0u, all_or = 0u;
  for (int base = 0; base < n_cand; base += kMergeBatch * kThreads) {
    float v[kMergeBatch];
#pragma unroll
    for (int j = 0; j < kMergeBatch; ++j) {
      const int c = base + j * kThreads + threadIdx.x;
      v[j] = c < n_cand ? __ldcg(cv + c) : 0.f;
    }
#pragma unroll
    for (int j = 0; j < kMergeBatch; ++j) {
      const int c = base + j * kThreads + threadIdx.x;
      if (c < n_cand) {
        const unsigned key = float_key(v[j]);
        all_and &= key;
        all_or |= key;
        if (cached) merge_keys[c] = key;
      }
    }
  }
  all_and = __reduce_and_sync(0xffffffffu, all_and);
  all_or = __reduce_or_sync(0xffffffffu, all_or);
  if (threadIdx.x == 0) {
    shared_and = ~0u;
    shared_or = 0u;
  }
  __syncthreads();
  if (threadIdx.x % 32 == 0) {
    atomicAnd(&shared_and, all_and);
    atomicOr(&shared_or, all_or);
  }
  __syncthreads();
  const unsigned differ = shared_and ^ shared_or;
  stamps.section(3);
  auto load_keys = [&](int base, unsigned* keys) {
#pragma unroll
    for (int j = 0; j < kMergeBatch; ++j) {
      const int c = base + j * kThreads + threadIdx.x;
      keys[j] = c >= n_cand ? 0u : cached ? merge_keys[c] : float_key(__ldcg(cv + c));
    }
  };
  const unsigned kth_key =
      differ == 0u ? shared_and
                   : radix_select(
                         [&](auto&& f) {
                           for (int base = 0; base < n_cand; base += kMergeBatch * kThreads) {
                             unsigned keys[kMergeBatch];
                             load_keys(base, keys);
#pragma unroll
                             for (int j = 0; j < kMergeBatch; ++j)
                               f(keys[j], base + j * kThreads + (int)threadIdx.x < n_cand);
                           }
                         },
                         (unsigned)k, false, __clz(differ), shared_and, hist, state, list);
  stamps.section(4);
  const float kth = key_float(kth_key);
  Best mine{-INFINITY, INT_MAX};
  if (!isnan(kth)) {
    // the scores of the candidates at or above it (a key's value is the
    // candidate's, but +0.0 for -0.0: the same mask)
    for (int base = 0; base < n_cand; base += kMergeBatch * kThreads) {
      unsigned keys[kMergeBatch];
      load_keys(base, keys);
      float s[kMergeBatch];
      int idx[kMergeBatch];
#pragma unroll
      for (int j = 0; j < kMergeBatch; ++j) {
        const int c = base + j * kThreads + threadIdx.x;
        const bool kept = c < n_cand && !(key_float(keys[j]) < kth);
        s[j] = kept ? __ldcg(cand.s + row_base + c) : -INFINITY;
        idx[j] = kept ? __ldcg(cand.i + row_base + c) : INT_MAX;
      }
#pragma unroll
      for (int j = 0; j < kMergeBatch; ++j) mine = better(mine, Best{s[j], idx[j]});
    }
  }
  Best best = block_argmax(mine, red);
  stamps.section(5);
  if (!(best.v > -INFINITY)) {
    // no kept score above -inf (or a NaN k-th largest): the whole row decides
    mine = Best{-INFINITY, INT_MAX};
    const int quads = (V + 3) / 4;
    for (int c = threadIdx.x; c < quads; c += kThreads) {
      float xs[4], gs[4];
      store4(xs, load4<VEC>(x, c, V));
      store4(gs, load4<VEC>(g, c, V));
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (4 * c + e < V) mine = better(mine, Best{score(xs[e] < kth ? -INFINITY : xs[e], tt, gs[e]), 4 * c + e});
      }
    }
    best = block_argmax(mine, red);
    stamps.section(6);
  }
  if (threadIdx.x == 0) out[row] = best.i;
}

// (slice length, splits) for a (batch, vocab): slices of a multiple of 4,
// at most kMaxSlice values, cut so that batch x splits reaches
// kTargetBlocks where slices of at least kMinSlice values allow it
void layout(int batch, int vocab, int* slice, int* splits) {
  const int want = (kTargetBlocks + batch - 1) / batch;
  const int most = vocab / kMinSlice > 1 ? vocab / kMinSlice : 1;
  int s = want < most ? want : most;
  const int least = (vocab + kMaxSlice - 1) / kMaxSlice;
  if (s < least) s = least;
  const int per = (vocab + s - 1) / s;
  *slice = (per + 3) / 4 * 4;
  *splits = (vocab + *slice - 1) / *slice;
}

long long align16(long long bytes) { return (bytes + 15) / 16 * 16; }

}  // namespace

extern "C" {

// The splits a row is cut into for (batch, vocab).
int fused_sample_splits(int batch, int vocab) {
  int slice, splits;
  layout(batch, vocab, &slice, &splits);
  return splits;
}

// Bytes of the scratch a call needs: the partials (8 bytes a split a row),
// then room for every value of every row as a candidate (value, score and
// index).
long long fused_sample_scratch_bytes(int batch, int vocab) {
  int slice, splits;
  layout(batch, vocab, &slice, &splits);
  return align16(8LL * batch * splits) + 12LL * batch * vocab;
}

// logits, noise: (B, V) f32; temperature: (B,) f32; top_k: (B,) int32;
// out: (B,) int32; scratch: fused_sample_scratch_bytes(B, V) bytes;
// counters: B 64-bit words, all 0 (and left 0). Returns a cudaError_t code
// (0 = launched).
int fused_sample(const float* logits, const float* noise, const float* temperature, const int* top_k, int* out,
                 void* scratch, void* counters, int batch, int vocab, void* stream) {
  int slice, splits;
  layout(batch, vocab, &slice, &splits);
  Best* partials = static_cast<Best*>(scratch);
  const long long values = (long long)batch * vocab;
  float* cand_v = reinterpret_cast<float*>(static_cast<char*>(scratch) + align16(8LL * batch * splits));
  const Candidates cand{cand_v, cand_v + values, reinterpret_cast<int*>(cand_v + 2 * values)};
  auto* words = static_cast<unsigned long long*>(counters);
  const bool vec = vocab % 4 == 0 && reinterpret_cast<uintptr_t>(logits) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(noise) % 16 == 0;
  const dim3 grid(splits, batch);
  if (vec)
    sample_kernel<true><<<grid, kThreads, 0, (cudaStream_t)stream>>>(logits, noise, temperature, top_k, out, partials,
                                                                     cand, words, vocab, slice);
  else
    sample_kernel<false><<<grid, kThreads, 0, (cudaStream_t)stream>>>(logits, noise, temperature, top_k, out,
                                                                      partials, cand, words, vocab, slice);
  return (int)cudaGetLastError();
}

#ifdef SAMPLE_CLOCK_STAMPS
// The measurement build's stamps: (row kind: greedy, keep-all, top-k) x
// (the cycles of kStampSections sections, then the blocks of the slice pass
// and of the merge), summed since the library was loaded.
int fused_sample_clock_stamps(long long* out) {
  return (int)cudaMemcpyFromSymbol(out, g_stamps, sizeof(g_stamps));
}
#endif

}  // extern "C"
