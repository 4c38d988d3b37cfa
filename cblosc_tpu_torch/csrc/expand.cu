// Expand kernel: compacted records -> output bytes, one CTA per row.
//
// Replaces cblosc_tpu/tpu/expand.py:expand (the Pallas kernel built by
// _make_kernel). Record kinds, processed in order until the first
// kind < 0:
//   low nibble 0  literal copy:  len bytes from the compressed row at arg
//   low nibble 1  match fill:    distance arg, out[x] = out[x - d]
//   low nibble 2  immediate:     nb = kind >> 4 (<= 8) bytes packed
//                                little-endian in arg (0-3) and len (4-7)
//
// Clamping rule (identical in the plain version, gpu/expand.py):
//   d0 = clamp(dst, 0, out_len), L = clamp(len, 0, out_len - d0);
//   a literal byte read outside [0, W) reads 0;
//   a match uses d = max(min(arg, out_len), 1) and reads 0 before the row;
//   an immediate byte at or past out_len is dropped.
// So no record, however adversarial, reads or writes outside its row.
//
// What bounds it on an H100: memory traffic. Each output byte is written
// once and read at most once (literal source or earlier output), so the
// bound is (compressed bytes + records + output bytes) / 3.35 TB/s. What
// stands in the way is the order of the records: a match reads output
// that earlier records write.
//
// Design. A row is WELL FORMED when its valid records (those before the
// first kind < 0) have kinds 0-2, extents [dst, dst + n) (n = len, or the
// immediate's byte count) in order, disjoint and inside [0, out_len), and
// match distances in [1, dst]. Every walk of the port emits such rows for
// the rows it accepts. In a well-formed row each output byte has one
// writer, and a match byte x = d0 + j reads p = d0 - d + (j mod d) < d0,
// whose final value is the one the sequential order reads (the records
// that write p all come before). So a byte is a literal or immediate
// value, a gap (0), or a pointer to an earlier byte, and the row is
// resolved by pointer jumping, p <- src[p], with no order among records:
//   - the row goes through windows of up to 32 KB of output, in order;
//     a window holds one 16-bit cell per byte in shared memory: a value
//     (0x8000 | byte) or a pointer into the window;
//   - the records of a window are staged into shared memory, 1024 at a
//     time with their successor, by cp.async, and the next window's
//     records are fetched while this one is resolved (double-buffered);
//     each staged tile is checked on arrival;
//   - each warp fills a contiguous slice of the window, each lane walking
//     the records in order to find the one that covers its byte; a match
//     byte whose source lies before the window reads the finished output
//     (written by the earlier windows of this CTA); one inside it becomes
//     a pointer;
//   - pointer jumping in shared memory, cell <- cell[cell], until no
//     pointer is left (at most 15 rounds for 32 KB; updates in place are
//     safe, a cell only moves along its own chain); then the window is
//     written out with coalesced stores.
// A row whose staged records fail the check is cleared and placed by the
// per-record loop (the first design: the CTA's threads split each
// record's bytes, one barrier per record), which follows the clamping
// rule above; stats[row] records which branch a row took (-1: the
// per-record loop) or else the largest number of jumping rounds of a
// window (0: no byte of the row points to another).
// One row per CTA; 37 KB of static shared memory and 2 B per window byte
// of dynamic (64 KB at 32 KB windows), so two CTAs fit an SM. A row's
// time is the chain of its windows, so a launch of few rows (up to two
// per SM) gives each 1024 threads; a launch of more rows 512, so that
// more rows share the card at once.

#include <cstdint>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>

namespace {

constexpr int kWin = 32768;         // largest window (16-bit pointers)
constexpr int kTile = 1024;         // staged records per window, plus one
constexpr uint16_t kVal = 0x8000;   // a resolved cell: kVal | byte
constexpr int kUnroll = 4;          // bytes a lane fills per step
constexpr int kWide = 264;          // rows up to which a CTA has 1024 threads

struct Tile {
  int32_t k[kTile + 1], a[kTile + 1], d[kTile + 1], l[kTile + 1];
};

// extent length of a record: len, or an immediate's byte count
__device__ __forceinline__ int extent(int kd, int ln) {
  return (kd & 0xF) == 2 ? min(max(kd >> 4, 0), 8) : ln;
}

// records [k0, k0 + kTile] of the row into t; those at or past R read as
// kind -1
template <int kThreads>
__device__ void stage(Tile& t, const int32_t* __restrict__ kind,
                      const int32_t* __restrict__ arg,
                      const int32_t* __restrict__ dst,
                      const int32_t* __restrict__ len, int R, int k0) {
  for (int i = threadIdx.x; i <= kTile; i += kThreads) {
    const int k = k0 + i;
    if (k < R) {
      __pipeline_memcpy_async(&t.k[i], kind + k, 4);
      __pipeline_memcpy_async(&t.a[i], arg + k, 4);
      __pipeline_memcpy_async(&t.d[i], dst + k, 4);
      __pipeline_memcpy_async(&t.l[i], len + k, 4);
    } else {
      t.k[i] = -1;
    }
  }
  __pipeline_commit();
}

// how many of the tile's first nt records end at or before w (the ends
// do not decrease, so they are a prefix); called by every thread
__device__ __forceinline__ int count_ends(const int* ends, int nt, int w,
                                          int tid, int threads) {
  int c = 0;
  for (int i = tid; i < kTile; i += threads)
    c = __syncthreads_count(i < nt && ends[i] <= w) + c;
  return c;
}

// the first design: records in order, the CTA's threads split each
// record's bytes, one barrier per record
__device__ void serial_place(const uint8_t* __restrict__ src, int W,
                             const int32_t* __restrict__ kind,
                             const int32_t* __restrict__ arg,
                             const int32_t* __restrict__ dst,
                             const int32_t* __restrict__ len, int R,
                             uint8_t* o, int out_len) {
  for (int k = 0; k < R; ++k) {
    const int kd = kind[k];
    if (kd < 0) break;  // uniform across the CTA
    const int a = arg[k];
    const int d0 = min(max(dst[k], 0), out_len);
    const int lf = len[k];
    const int low = kd & 0xF;
    if (low == 0) {
      const int L = min(max(lf, 0), out_len - d0);
      for (int j = threadIdx.x; j < L; j += blockDim.x) {
        const long long s = (long long)a + j;
        o[d0 + j] = (s >= 0 && s < W) ? src[s] : 0;
      }
    } else if (low == 1) {
      const int L = min(max(lf, 0), out_len - d0);
      const int d = max(min(a, out_len), 1);
      for (int j = threadIdx.x; j < L; j += blockDim.x) {
        const int p = d0 - d + (j % d);
        o[d0 + j] = p >= 0 ? o[p] : 0;
      }
    } else if (low == 2) {
      const int nb = min(max(kd >> 4, 0), 8);
      const int j = threadIdx.x;
      if (j < nb && d0 + j < out_len) {
        const unsigned w = (unsigned)(j < 4 ? a : lf);
        o[d0 + j] = (uint8_t)((w >> (8 * (j & 3))) & 0xFF);
      }
    }
    __syncthreads();
  }
}

template <int kThreads>
__global__ void __launch_bounds__(kThreads)
expand_kernel(const uint8_t* __restrict__ slots, int W,
              const int32_t* __restrict__ kind,
              const int32_t* __restrict__ arg,
              const int32_t* __restrict__ dst,
              const int32_t* __restrict__ len, int R, uint8_t* out,
              int out_len, int win, int32_t* __restrict__ stats) {
  __shared__ __align__(16) Tile tiles[2];
  __shared__ int ends[kTile + 1];   // extent ends of the current tile
  __shared__ int s_neg;             // first staged kind < 0
  extern __shared__ uint16_t cell[];
  constexpr int kWarps = kThreads / 32;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long long row = blockIdx.x;
  const uint8_t* src = slots + row * (long long)W;
  uint8_t* o = out + row * (long long)out_len;
  const long long rb = row * (long long)R;
  const int32_t *kr = kind + rb, *ar = arg + rb, *dr = dst + rb,
                *lr = len + rb;

  int w0 = 0, klo = 0, prev_end = 0, rounds_max = 0, cur = 0;
  bool serial = false;
  if (tid == 0) s_neg = kTile + 1;
  stage<kThreads>(tiles[0], kr, ar, dr, lr, R, 0);
  while (w0 < out_len) {
    __pipeline_wait_prior(0);
    __syncthreads();
    const Tile& t = tiles[cur];
    // ---- check the staged records ------------------------------------
    for (int i = tid; i <= kTile; i += kThreads)
      if (t.k[i] < 0) atomicMin(&s_neg, i);
    __syncthreads();
    const int nall = s_neg;         // staged valid records, the extra one too
    bool bad = false;
    for (int i = tid; i < nall; i += kThreads) {
      const int kd = t.k[i], d0 = t.d[i], a = t.a[i];
      const int n = extent(kd, t.l[i]);
      const int pe = i == 0 ? prev_end : t.d[i - 1] + extent(t.k[i - 1], t.l[i - 1]);
      bad |= (kd & 0xF) > 2 || n < 0 || d0 < pe ||
             (long long)d0 + n > out_len ||
             ((kd & 0xF) == 1 && (a < 1 || a > d0));
      ends[i] = d0 + n;
    }
    if (__syncthreads_or(bad)) {
      serial = true;
      break;
    }
    const int nt = min(nall, kTile);
    if (nt == 0) break;             // no record left: the rest is a gap
    if (tid == 0) s_neg = kTile + 1;
    // records that end at or before w0 (zero-length ones at the row's
    // start) take no part: restage past them
    const int c0 = count_ends(ends, nt, w0, tid, kThreads);
    if (c0 > 0) {
      prev_end = ends[c0 - 1];
      klo += c0;
      cur ^= 1;
      stage<kThreads>(tiles[cur], kr, ar, dr, lr, R, klo);
      continue;
    }
    const int wlim = nall > kTile ? t.d[kTile] : out_len;
    const int w1 = min(min(w0 + win, out_len), wlim);
    const int c = count_ends(ends, nt, w1, tid, kThreads);
    // prefetch the next window's records while this one resolves
    stage<kThreads>(tiles[cur ^ 1], kr, ar, dr, lr, R, klo + c);
    // ---- fill the window's cells -----------------------------------------
    const int nb = w1 - w0;
    const int seg = ((nb + kWarps - 1) / kWarps + 31) & ~31;
    const int s0 = w0 + warp * seg, s1 = min(s0 + seg, w1);
    int ptrs = 0;                   // a cell of this thread points
    if (s0 + lane < s1) {
      // the last record that starts at or before the lane's first byte
      int lo = 0, hi = nt;          // first record with dst > x
      const int x0 = s0 + lane;
      while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if (t.d[mid] <= x0) lo = mid + 1; else hi = mid;
      }
      int r = lo - 1;
      for (int x = x0; x < s1; x += 32 * kUnroll) {
        int xs[kUnroll];
        const uint8_t* from[kUnroll];
        uint16_t v[kUnroll];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          const int y = x + 32 * u;
          xs[u] = y;
          from[u] = nullptr;
          v[u] = kVal;
          if (y >= s1) continue;
          while (r + 1 < nt && t.d[r + 1] <= y) ++r;
          if (r < 0 || y >= ends[r]) continue;  // a gap: 0
          const int kd = t.k[r], d0 = t.d[r], a = t.a[r], j = y - d0;
          const int low = kd & 0xF;
          if (low == 0) {
            const long long sx = (long long)a + j;
            if (sx >= 0 && sx < W) from[u] = src + sx;
          } else if (low == 1) {
            const int p = d0 - a + (j < a ? j : j % a);
            if (p < w0) from[u] = o + p;
            else v[u] = (uint16_t)(p - w0);
          } else {
            const unsigned w = (unsigned)(j < 4 ? a : t.l[r]);
            v[u] = kVal | (uint16_t)((w >> (8 * (j & 3))) & 0xFF);
          }
        }
        uint8_t b[kUnroll];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) b[u] = from[u] ? *from[u] : 0;
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          if (xs[u] >= s1) continue;
          const uint16_t c = from[u] ? (uint16_t)(kVal | b[u]) : v[u];
          cell[xs[u] - w0] = c;
          ptrs |= !(c & kVal);
        }
      }
    }
    // ---- pointer jumping ---------------------------------------------
    int rounds = 0;
    if (__syncthreads_or(ptrs)) {
      for (;;) {
        int left = 0;
        for (int i = tid; i < nb; i += kThreads) {
          const uint16_t p = cell[i];
          if (!(p & kVal)) {
            const uint16_t q = cell[p];
            cell[i] = q;
            left |= !(q & kVal);
          }
        }
        ++rounds;
        if (!__syncthreads_or(left)) break;
      }
    }
    rounds_max = max(rounds_max, rounds);
    for (int i = tid; i < nb; i += kThreads) o[w0 + i] = (uint8_t)cell[i];
    prev_end = c > 0 ? ends[c - 1] : prev_end;
    klo += c;
    w0 = w1;
    cur ^= 1;
    __syncthreads();
  }
  if (serial) {
    for (int i = tid; i < w0; i += kThreads) o[i] = 0;
    __syncthreads();
    serial_place(src, W, kr, ar, dr, lr, R, o, out_len);
  }
  __pipeline_wait_prior(0);
  if (stats != nullptr && tid == 0) stats[row] = serial ? -1 : rounds_max;
}

}  // namespace

extern "C" int expand_launch(const void* slots, int N, int W,
                             const void* kind, const void* arg,
                             const void* dst, const void* len, int R,
                             void* out, int out_len, void* stats,
                             void* stream) {
  const int win = out_len < kWin ? out_len : kWin;
  const int smem = 2 * win;
  static bool attr = false;
  if (!attr) {
    cudaFuncSetAttribute(expand_kernel<512>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         2 * kWin);
    cudaFuncSetAttribute(expand_kernel<1024>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         2 * kWin);
    attr = true;
  }
  // a row's time is its windows' chain: few rows take 1024 threads each;
  // many rows 512, so that more CTAs share each SM
  if (N > 0 && out_len > 0) {
    auto k = N <= kWide ? expand_kernel<1024> : expand_kernel<512>;
    k<<<N, N <= kWide ? 1024 : 512, smem, (cudaStream_t)stream>>>(
        (const uint8_t*)slots, W, (const int32_t*)kind, (const int32_t*)arg,
        (const int32_t*)dst, (const int32_t*)len, R, (uint8_t*)out, out_len,
        win, (int32_t*)stats);
  }
  return (int)cudaGetLastError();
}
