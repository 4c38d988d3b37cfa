// Mining kernel: the encoders' adaptive-distance miner, one CTA per row.
//
// Replaces cblosc_tpu/tpu/codec.py:mine_group (:346; with _mine_distance
// :249, _fold :327 and _eq_at :401), XLA code with no Pallas kernel: the
// port ran it as about 60 small torch ops a row group, and the card
// waited on the host between them. Per row, byte for byte what
// gpu/codec.py:_mine_group_plain returns:
//   prefix   on rows of n >= 1024, the first min(n, 4096) bytes mined with
//            min_gap 4, max_gap MAX_FARDIST
//   fold     on rows of n >= 32768 with n % FG == 0 (FG 32 from 128 KB,
//            else 16): each FG bytes fold to h = sum byte_k * w_k,
//            w_k = ((2654435761 * (k + 1)) >> 13) & 0xFF, to
//            (h ^ h >> 8 ^ h >> 16) & 0xFF; the folded row mined with
//            min_gap 1, max_gap max_d / FG; dg = d * FG kept if < n,
//            hg = hits * FG
//   miner    4-grams (little-endian words) at novel positions (i == 0 or
//            s[i] != s[i-1], i < m - 3); a word of 0xFFFFFFFF is the
//            sentinel, never usable; a position's gap is to its nearest
//            earlier novel position with the same word, usable within
//            [min_gap, max_gap]; d is the mode of the usable gaps (ties to
//            the smaller gap), hits its count, both 0 unless hits >= 4
//   choice   d = dg if hg > hp else dp (dp counts only if <= max_d);
//            coverage = #{i : d <= i < n - 1, s[i] == s[i - d]}; the row
//            adopts d when d > 0, coverage >= n / 6 and d != d_row
//   output   d_m = d if adopted else 0; eq_m the coverage mask on adopted
//            rows, zeros on the others (every byte written)
//
// What bounds it on an H100: neither bytes nor operations. The bytes are
// the row read once (the fold, the coverage) and eq_m written once: 8 MB
// for a 4 MB chunk (16 rows of 256 KB at clevel 9, 32 of 128 KB at clevels
// 5-8), 2.5 us at 3.35 TB/s. With one CTA a row, 16 or 32 rows fill 16 or
// 32 of 132 SMs, and each CTA's chain of barriers sets the time: on an
// NVIDIA H100 80GB HBM3 at 700 W the two sorts take about 80% of it
// (about 39,000 cycles for 4,096 keys, 67,000 for 8,192), the fold 10%.
// The design:
//   - a stable sort of the words, positions ascending within a word, puts
//     each novel position right after its nearest earlier occurrence: in
//     shared memory CUB's block radix sort (eight 4-bit passes over the
//     words, each thread holding P / 1024 consecutive positions), so the
//     sort costs O(P) a pass where a bitonic network costs O(P log^2 P);
//   - the mode is a histogram of usable gaps in shared memory (4608
//     bins: prefix gaps are below 4096, fold gaps at most
//     MAX_FARDIST / 16 = 4607), then one block-wide max over
//     (count, -gap);
//   - a folded row longer than kSmemKeys keys (forced blocks above
//     256 KB at FG 32) sorts its unique (word << 32 | position) keys by a
//     bitonic network in the caller's global scratch, whose size
//     mine_scratch_bytes gives;
//   - the row is read and eq_m written 16 bytes a thread at a time where
//     both are 16-byte aligned (s[i - d] cut from two aligned loads);
//     the coverage is counted in one pass and eq_m written in a second,
//     once the row's choice is known: one launch, no host sync.

#include <cstdint>
#include <cub/block/block_radix_sort.cuh>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kHist = 4608;            // usable gaps 0 .. 4607
constexpr int kPrefix = 4096;          // the prefix miner's bytes
constexpr long long kSmemKeys = 8192;  // a folded row's sort in shared memory
constexpr int kMaxFar = 8192 + 65535;  // MAX_FARDIST
constexpr unsigned long long kSentinel = 0xFFFFFFFFull << 32;

template <int E>
using BlockSort = cub::BlockRadixSort<unsigned, kThreads, E, unsigned short>;
constexpr size_t smax(size_t a, size_t b) { return a > b ? a : b; }
// the block sort's scratch, for any of its E = 1, 2, 4, 8
constexpr size_t kSortTemp =
    (smax(smax(sizeof(BlockSort<1>::TempStorage),
               sizeof(BlockSort<2>::TempStorage)),
          smax(sizeof(BlockSort<4>::TempStorage),
               sizeof(BlockSort<8>::TempStorage))) + 15) / 16 * 16;

__device__ __forceinline__ unsigned long long umax64(unsigned long long a,
                                                     unsigned long long b) {
  return a > b ? a : b;
}

// The block's maximum of v; red holds one word per warp.
__device__ unsigned long long block_max(unsigned long long v,
                                        unsigned long long* red) {
  const int w = threadIdx.x >> 5, l = threadIdx.x & 31;
  for (int o = 16; o; o >>= 1) v = umax64(v, __shfl_xor_sync(~0u, v, o));
  if (l == 0) red[w] = v;
  __syncthreads();
  if (w == 0) {
    v = l < kThreads / 32 ? red[l] : 0;
    for (int o = 16; o; o >>= 1) v = umax64(v, __shfl_xor_sync(~0u, v, o));
    if (l == 0) red[32] = v;
  }
  __syncthreads();
  v = red[32];
  __syncthreads();                      // red is free again
  return v;
}

// The block's sum of v.
__device__ long long block_sum(long long v, unsigned long long* red) {
  const int w = threadIdx.x >> 5, l = threadIdx.x & 31;
  for (int o = 16; o; o >>= 1) v += __shfl_xor_sync(~0u, v, o);
  if (l == 0) red[w] = (unsigned long long)v;
  __syncthreads();
  if (w == 0) {
    v = l < kThreads / 32 ? (long long)red[l] : 0;
    for (int o = 16; o; o >>= 1) v += __shfl_xor_sync(~0u, v, o);
    if (l == 0) red[32] = (unsigned long long)v;
  }
  __syncthreads();
  v = (long long)red[32];
  __syncthreads();
  return v;
}

// The key of position i of b[0, m): (word << 32 | i) at a novel position,
// (sentinel << 32 | i) elsewhere; unique, so any sort of them is stable.
__device__ __forceinline__ unsigned long long gram_key(const uint8_t* b,
                                                       long long m,
                                                       long long i) {
  if (i < m - 3 && (i == 0 || b[i] != b[i - 1])) {
    const unsigned g = (unsigned)b[i] | (unsigned)b[i + 1] << 8 |
                       (unsigned)b[i + 2] << 16 | (unsigned)b[i + 3] << 24;
    return (unsigned long long)g << 32 | (unsigned long long)i;
  }
  return kSentinel | (unsigned long long)i;
}

// One bitonic step (size, stride) over keys in memory: kThreads threads
// on P / 2 pairs, then a barrier.
__device__ void bitonic_step(unsigned long long* k, long long P, long long size,
                             long long stride) {
  for (long long t = threadIdx.x; t < (P >> 1); t += kThreads) {
    const long long lo = 2 * t - (t & (stride - 1)), hi = lo + stride;
    const unsigned long long a = k[lo], b = k[hi];
    if ((a > b) == ((lo & size) == 0)) {
      k[lo] = b;
      k[hi] = a;
    }
  }
  __syncthreads();
}

// The keys of b[0, m) sorted ascending into k[0, P), P = kThreads * E in
// shared memory: thread t holds positions t * E .. t * E + E - 1, so a
// stable radix sort of the words (CUB's block sort, 4 bits a pass) keeps
// each word's positions ascending. tmp: the sort's scratch.
template <int E>
__device__ void sort_shared(const uint8_t* b, long long m,
                            unsigned long long* k, void* tmp) {
  using Sort = BlockSort<E>;
  unsigned word[E];
  unsigned short pos[E];
#pragma unroll
  for (int e = 0; e < E; ++e) {
    const int i = threadIdx.x * E + e;
    word[e] = (unsigned)(gram_key(b, m, i) >> 32);
    pos[e] = (unsigned short)i;
  }
  Sort(*static_cast<typename Sort::TempStorage*>(tmp)).Sort(word, pos);
#pragma unroll
  for (int e = 0; e < E; ++e)
    k[threadIdx.x * E + e] = (unsigned long long)word[e] << 32 | pos[e];
  __syncthreads();
}

// The keys of b[0, m) sorted ascending into k[0, P) in memory, for P above
// kSmemKeys (global scratch): a bitonic network on the unique keys.
__device__ void sort_memory(const uint8_t* b, long long m, long long P,
                            unsigned long long* k) {
  for (long long i = threadIdx.x; i < P; i += kThreads) k[i] = gram_key(b, m, i);
  __syncthreads();
  for (long long size = 2; size <= P; size <<= 1)
    for (long long stride = size >> 1; stride > 0; stride >>= 1)
      bitonic_step(k, P, size, stride);
}

// The modal gap of b[0, m) and its count (0, 0 unless 4 gaps agree); keys
// holds P >= m slots (P a power of two, at least kThreads), hist kHist
// bins. Every thread returns the same.
__device__ void mine(const uint8_t* b, long long m, long long P,
                     unsigned long long* keys, void* tmp, int* hist,
                     int min_gap, int max_gap, unsigned long long* red,
                     long long& d, long long& hits) {
  for (int i = threadIdx.x; i < kHist; i += kThreads) hist[i] = 0;
  switch (P) {                          // each sort ends in a barrier
    case kThreads: sort_shared<1>(b, m, keys, tmp); break;
    case 2 * kThreads: sort_shared<2>(b, m, keys, tmp); break;
    case 4 * kThreads: sort_shared<4>(b, m, keys, tmp); break;
    case 8 * kThreads: sort_shared<8>(b, m, keys, tmp); break;
    default: sort_memory(b, m, P, keys);
  }
  for (long long j = threadIdx.x + 1; j < P; j += kThreads) {
    const unsigned long long a = keys[j - 1], c = keys[j];
    if ((a >> 32) == (c >> 32) && (c >> 32) != 0xFFFFFFFFull) {
      const long long gap = (long long)(c & 0xFFFFFFFFull) -
                            (long long)(a & 0xFFFFFFFFull);
      if (gap >= min_gap && gap <= max_gap) atomicAdd(&hist[gap], 1);
    }
  }
  __syncthreads();
  // the largest count, ties to the smaller gap: max over (count, ~gap)
  unsigned long long best = 0;
  for (int g = threadIdx.x; g < kHist; g += kThreads)
    best = umax64(best, (unsigned long long)(unsigned)hist[g] << 32 |
                            (0xFFFFFFFFu - (unsigned)g));
  best = block_max(best, red);
  hits = (long long)(best >> 32);
  d = hits >= 4 ? (long long)(0xFFFFFFFFu - (unsigned)(best & 0xFFFFFFFFu)) : 0;
  if (d == 0) hits = 0;
}

__device__ __forceinline__ uint4 ld16(const uint8_t* p) {
  return *(const uint4*)p;
}

// Bytes off .. off + 15 of the 32 bytes a | b (0 <= off < 16).
__device__ __forceinline__ uint4 window16(uint4 a, uint4 b, int off) {
  unsigned v0, v1, v2, v3, v4;
  switch (off >> 2) {
    case 0: v0 = a.x; v1 = a.y; v2 = a.z; v3 = a.w; v4 = b.x; break;
    case 1: v0 = a.y; v1 = a.z; v2 = a.w; v3 = b.x; v4 = b.y; break;
    case 2: v0 = a.z; v1 = a.w; v2 = b.x; v3 = b.y; v4 = b.z; break;
    default: v0 = a.w; v1 = b.x; v2 = b.y; v3 = b.z; v4 = b.w; break;
  }
  const unsigned sh = (off & 3) * 8;
  return make_uint4(__funnelshift_r(v0, v1, sh), __funnelshift_r(v1, v2, sh),
                    __funnelshift_r(v2, v3, sh), __funnelshift_r(v3, v4, sh));
}

// eq[i] = i >= d && i < n - 1 && r[i] == r[i - d] over the row: written
// to e where e is given, else counted. A thread takes 16 positions at a
// time; with vec (r and e 16-byte aligned) a chunk inside [d, n - 1) is
// three 16-byte loads, the shifted one cut from two aligned ones.
__device__ long long cover(const uint8_t* r, long long n, long long d,
                           uint8_t* e, bool vec) {
  long long cov = 0;
  const int off = (int)((16 - d % 16) % 16);   // (i0 - d) mod 16
  for (long long i0 = 16 * (long long)threadIdx.x; i0 < n; i0 += 16 * kThreads) {
    if (vec && i0 >= d && i0 + 16 < n) {
      const uint8_t* p = r + (i0 - d - off);
      const uint4 x = ld16(r + i0);
      const uint4 y = window16(ld16(p), off ? ld16(p + 16) : make_uint4(0, 0, 0, 0),
                               off);
      const uint4 q = make_uint4(__vcmpeq4(x.x, y.x) & 0x01010101u,
                                 __vcmpeq4(x.y, y.y) & 0x01010101u,
                                 __vcmpeq4(x.z, y.z) & 0x01010101u,
                                 __vcmpeq4(x.w, y.w) & 0x01010101u);
      if (e) *(uint4*)(e + i0) = q;
      else cov += __popc(q.x) + __popc(q.y) + __popc(q.z) + __popc(q.w);
    } else {
      const long long end = i0 + 16 < n ? i0 + 16 : n;
      for (long long i = i0; i < end; ++i) {
        const bool eq = i >= d && i < n - 1 && r[i] == r[i - d];
        if (e) e[i] = eq;
        else cov += eq;
      }
    }
  }
  return cov;
}

__global__ void __launch_bounds__(kThreads)
mine_kernel(const uint8_t* __restrict__ s, long long n,
            const void* __restrict__ d_row, int d_row_64, int max_d,
            long long p_pre, int fg, long long p_fold, long long p_sh,
            long long b_sh, uint8_t* __restrict__ scratch,
            long long scratch_row,
            long long* __restrict__ d_out, uint8_t* __restrict__ eq_out) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ unsigned long long red[33];
  __shared__ int wts[32];
  int* hist = (int*)smem;
  unsigned long long* keys_sh = (unsigned long long*)(smem + kHist * 4);
  uint8_t* bytes_sh = (uint8_t*)(keys_sh + p_sh);
  void* tmp = smem + kHist * 4 + p_sh * 8 + (b_sh + 15) / 16 * 16;
  const long long row = blockIdx.x;
  const uint8_t* r = s + row * n;
  uint8_t* e = eq_out + row * n;
  const bool vec = (((uintptr_t)r | (uintptr_t)e) & 15) == 0;
  if (threadIdx.x < 32)
    wts[threadIdx.x] =
        (int)(((2654435761ull * (threadIdx.x + 1)) >> 13) & 0xFF);

  long long dp = 0, hp = 0, dg = 0, hg = 0;
  if (n >= 1024) {
    const long long m = n < kPrefix ? n : kPrefix;
    if (vec && m % 16 == 0) {
      for (long long i = 16 * threadIdx.x; i < m; i += 16 * kThreads)
        *(uint4*)(bytes_sh + i) = ld16(r + i);
    } else {
      for (long long i = threadIdx.x; i < m; i += kThreads) bytes_sh[i] = r[i];
    }
    __syncthreads();
    mine(bytes_sh, m, p_pre, keys_sh, tmp, hist, 4, kMaxFar, red, dp, hp);
  }
  if (fg) {
    const long long m = n / fg;
    unsigned long long* keys = keys_sh;
    uint8_t* fb = bytes_sh;
    if (p_fold > kSmemKeys) {
      keys = (unsigned long long*)(scratch + row * scratch_row);
      fb = (uint8_t*)(keys + p_fold);
    }
    __syncthreads();                    // the prefix is done with its bytes
    for (long long g = threadIdx.x; g < m; g += kThreads) {
      const uint8_t* p = r + g * fg;
      int h = 0;
      if (vec) {                        // fg is 16 or 32
        for (int v = 0; v < fg; v += 16) {
          const uint4 q = ld16(p + v);
          const unsigned w[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
          for (int k = 0; k < 16; ++k)
            h += (int)((w[k >> 2] >> (8 * (k & 3))) & 0xFF) * wts[v + k];
        }
      } else {
        for (int k = 0; k < fg; ++k) h += (int)p[k] * wts[k];
      }
      fb[g] = (uint8_t)((h ^ (h >> 8) ^ (h >> 16)) & 0xFF);
    }
    __syncthreads();
    long long d, hits;
    mine(fb, m, p_fold, keys, tmp, hist, 1, max_d / fg, red, d, hits);
    dg = d * fg;
    if (dg >= n) dg = 0;
    hg = dg > 0 ? hits * fg : 0;
  }

  if (dp > max_d) dp = 0;
  if (dp == 0) hp = 0;
  const long long d = hg > hp ? dg : dp;
  bool adopt = false;
  if (d > 0) {
    const long long cov = block_sum(cover(r, n, d, nullptr, vec), red);
    const long long dr = d_row_64 ? ((const long long*)d_row)[row]
                                  : (long long)((const int*)d_row)[row];
    adopt = cov >= n / 6 && d != dr;
  }
  if (adopt) {
    cover(r, n, d, e, vec);
  } else if (vec) {
    for (long long i = 16 * threadIdx.x; i < n; i += 16 * kThreads) {
      if (i + 16 <= n) *(uint4*)(e + i) = make_uint4(0, 0, 0, 0);
      else for (long long j = i; j < n; ++j) e[j] = 0;
    }
  } else {
    for (long long i = threadIdx.x; i < n; i += kThreads) e[i] = 0;
  }
  if (threadIdx.x == 0) d_out[row] = adopt ? d : 0;
}

long long pow2_at_least(long long m) {
  long long p = 1;
  while (p < m) p <<= 1;
  return p;
}

// The fold of a row of n bytes: its group fg (0: no fold), the folded
// row's m bytes and its sort's P keys.
struct Fold {
  int fg;
  long long m, p;
};

Fold fold_of(long long n) {
  const int g = n >= 131072 ? 32 : 16;
  const int fg = n >= 32768 && n % g == 0 ? g : 0;
  const long long m = fg ? n / fg : 0;
  return {fg, m, fg ? pow2_at_least(m) : 0};
}

// Global scratch a row needs: the keys and bytes of a folded row whose
// sort exceeds kSmemKeys, 16-byte aligned; else 0.
long long scratch_of(const Fold& f) {
  return f.p > kSmemKeys ? (f.p * 8 + f.m + 15) / 16 * 16 : 0;
}

}  // namespace

// Bytes of the caller's global scratch a row of n bytes needs (0: none).
extern "C" long long mine_scratch_bytes(long long n) {
  return scratch_of(fold_of(n));
}

// s: uint8 (N, n); d_row: (N,) int64 (d_row_64) or int32; scratch: the
// caller's global memory, N * scratch_row bytes, scratch_row at least
// mine_scratch_bytes(n) (and null where that is 0).
extern "C" int mine_launch(const void* s, int N, long long n,
                           const void* d_row, int d_row_64, int max_d,
                           void* scratch, long long scratch_row, void* d_out,
                           void* eq_out, void* stream) {
  if (max_d < 0 || max_d > kMaxFar) return (int)cudaErrorInvalidValue;
  if (N <= 0) return (int)cudaGetLastError();
  const long long p_pre = n >= 1024 ? pow2_at_least(n < kPrefix ? n : kPrefix)
                                    : 0;
  const Fold f = fold_of(n);
  const bool fold_sh = scratch_of(f) == 0;
  if (!fold_sh && (scratch == nullptr || scratch_row % 8 != 0 ||
                   scratch_row < scratch_of(f)))
    return (int)cudaErrorInvalidValue;
  long long p_sh = p_pre, b_sh = p_pre ? (n < kPrefix ? n : kPrefix) : 0;
  if (fold_sh && f.p > p_sh) p_sh = f.p;
  if (fold_sh && f.m > b_sh) b_sh = f.m;
  const int smem = (int)(kHist * 4 + p_sh * 8 + (b_sh + 15) / 16 * 16 +
                         (p_pre ? kSortTemp : 0));
  static int attr = 0;
  if (smem > 48 * 1024 && smem > attr) {
    const cudaError_t err = cudaFuncSetAttribute(
        mine_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    attr = smem;
  }
  mine_kernel<<<N, kThreads, smem, (cudaStream_t)stream>>>(
      (const uint8_t*)s, n, d_row, d_row_64, max_d, p_pre, f.fg, f.p, p_sh,
      b_sh, (uint8_t*)scratch, scratch_row, (long long*)d_out,
      (uint8_t*)eq_out);
  return (int)cudaGetLastError();
}
