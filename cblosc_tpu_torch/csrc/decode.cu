// Generic blosclz decoder: one CTA of three warps per row, the row's
// output in shared memory.
//
// Replaces cblosc_tpu/tpu/codec.py:_decode_one (vmapped by codec.decode),
// the lax.while_loop machine that decodes the rows the walk does not
// place. It returns (out, produced, err) with that machine's exact
// semantics, errors included:
//   state    ip = 1, op = 0, token = src[0] & 31, err = csize <= 0,
//            fin = csize <= 1
//   bytes    src[min(x, Wp - 1)] with the row zero-padded to
//            Wp = max(W, 552) (the JAX decoder's padded window clamp)
//   literal  writes its token + 1 bytes (clipped to out_len) even when
//            it errs, then op += len; err if op > out_len or
//            ip + len > csize; fin when ip + len >= csize
//   ext      7-escape with eight 255 bytes: ip += 8, err if the old
//            ip + 8 >= csize
//   match    err (nothing written, op unchanged) if distance > op,
//            op + len > out_len or the next token lies at/past csize;
//            else out[x] = out[x - distance], overlapping, in order
//   produced = op at the end; output bytes past it are 0
//
// What bounds it on an H100: latency. The bytes moved (a compressed row
// in, out_len bytes out) take microseconds at 3.35 TB/s; the parse is a
// chain of dependent steps, one per token, and a serial decoder also
// pays a global-memory round trip for every byte of an overlapping match
// (a store, then a load of the same address). The design takes the
// global round trips out of the chain and splits the rest over three
// warps that run concurrently, handing work on through shared-memory
// counters:
//   * warp 0 (eval_warp) stages the stream with 16-byte cp.async copies
//     into a 16 KB input ring, 2 KB ahead of its use, and evaluates the
//     token that would start at every position (blz::eval_at, 16 bytes a
//     lane) into a table ring, with one-, two- and four-token jumps;
//   * warp 1 (record_warp) follows the chain of real tokens through the
//     jumps, up to four tokens per shared-memory load, 32 records a
//     batch: a warp scan gives each record's op, a ballot the first
//     failing check, and the batch goes to a queue of four;
//   * warp 2 (copy_warp) writes each batch into the row's output, which
//     lives in dynamic shared memory, whole when it fits in 128 KB,
//     otherwise as a 128 KB ring (blosclz's farthest reference is
//     65535 + 8192 = 73727 bytes back) flushed to the global row with
//     16-byte stores as it advances. Literals are copied by their lanes
//     at once; matches go in rounds, each once no earlier match of the
//     batch writes its source, short ones one lane each, long ones by all
//     lanes in closed form out[op + j] = out[op - d + (j mod d)] (every
//     source byte lies before op), a __syncwarp() between rounds.
// What is left is the chain itself: a row's time is about the slowest of
// the three warps' per-token work, which none of them can shorten by
// taking on more lanes.

#include <cstdint>
#include <cuda_runtime.h>

#include "blosclz_parse.cuh"

namespace {

constexpr int kMinWidth = 16 * 33 + 24;  // codec.decode's padded row width
constexpr int kMaxRing = 1 << 17;        // 128 KB output ring
// The copy warp reorders a batch (literals before matches) only when the
// batch writes at most kCap bytes, so the ring still holds every byte a
// match can reach (kMaxRing - 73727 > kCap); longer batches go record by
// record, and matches copy in chunks of kCap.
constexpr int kCap = 1 << 15;

struct Out {
  uint8_t* ring;                 // shared memory, `mask + 1` bytes
  unsigned mask;
  bool wrap;                     // ring shorter than the row
  long long flushed;             // bytes [0, flushed) are in the global row
  uint8_t* __restrict__ o;       // the global row
  long long produced;
  bool err;
  int off0;                      // the row's misalignment: input byte x is
                                 // at in[(x + off0) & (kIn - 1)]
};

// Copy output bytes [from, to) from the ring to the global row.
__device__ __forceinline__ void flush(Out& w, long long from, long long to) {
  const int lane = threadIdx.x & 31;
  long long x = from;
  if (((uintptr_t)w.o & 15) == 0) {
    const long long a = (from + 15) & ~15LL, e = to & ~15LL;
    if (a < e) {
      for (long long y = from + lane; y < a; y += 32)
        w.o[y] = w.ring[(unsigned)y & w.mask];
      for (long long y = a + 16LL * lane; y < e; y += 16 * 32)
        *reinterpret_cast<uint4*>(w.o + y) =
            *reinterpret_cast<const uint4*>(w.ring + ((unsigned)y & w.mask));
      x = e;
    }
  }
  for (long long y = x + lane; y < to; y += 32)
    w.o[y] = w.ring[(unsigned)y & w.mask];
  __syncwarp();
}

// Zero the global row over [from, to).
__device__ __forceinline__ void zero_tail(uint8_t* o, long long from,
                                          long long to) {
  const int lane = threadIdx.x & 31;
  long long x = from;
  if (((uintptr_t)o & 15) == 0) {
    const long long a = (from + 15) & ~15LL, e = to & ~15LL;
    if (a < e) {
      for (long long y = from + lane; y < a; y += 32) o[y] = 0;
      for (long long y = a + 16LL * lane; y < e; y += 16 * 32)
        *reinterpret_cast<uint4*>(o + y) = make_uint4(0, 0, 0, 0);
      x = e;
    }
  }
  for (long long y = x + lane; y < to; y += 32) o[y] = 0;
}

// A match by the whole warp: out[op + j] = out[op - d + (j mod d)] for
// j < len, in chunks of kCap whose sources are the d bytes just before
// the chunk (the match is d-periodic from op - d on, so any such window
// serves).
__device__ __forceinline__ void warp_match(Out& w, long long op, int len,
                                           int d) {
  const int lane = threadIdx.x & 31;
  for (int c0 = 0; c0 < len; c0 += kCap) {
    const int cl = len - c0 < kCap ? len - c0 : kCap;
    const long long at = op + c0;
    if (w.wrap && at + cl > w.flushed + w.mask + 1) {
      flush(w, w.flushed, at);
      w.flushed = at;
    }
    const unsigned ua = (unsigned)at, ub = (unsigned)(at - d);
    for (int j = lane; j < cl; j += 32)
      w.ring[(ua + j) & w.mask] = w.ring[(ub + (j < d ? j : j % d)) & w.mask];
    __syncwarp();
  }
}

// A short match by one lane, reads first: every source byte lies before
// op and is final (no pending match writes it).
__device__ __forceinline__ void lane_match(Out& w, long long op, int len,
                                           int d) {
  const unsigned ua = (unsigned)op, ub = (unsigned)(op - d);
  int m = 0;
  for (int j0 = 0; j0 < len; j0 += 8) {
    uint8_t v[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      v[i] = w.ring[(ub + m) & w.mask];
      m = m + 1 == d ? 0 : m + 1;
    }
#pragma unroll
    for (int i = 0; i < 8; ++i)
      if (j0 + i < len) w.ring[(ua + j0 + i) & w.mask] = v[i];
  }
}

// A literal's bytes, clipped to out_len, by the lane that owns it, from
// the input stage (where the row's byte rule is already applied).
__device__ __forceinline__ void lane_literal(Out& w, const uint8_t* in,
                                             long long op, int len, int src,
                                             int out_len) {
  const unsigned ua = (unsigned)op, us = (unsigned)(src + w.off0);
  const int n = op + len <= out_len ? len : (int)(out_len - op);
  for (int j0 = 0; j0 < n; j0 += 8) {
    uint8_t v[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) v[i] = in[(us + j0 + i) & (blz::kIn - 1)];
#pragma unroll
    for (int i = 0; i < 8; ++i)
      if (j0 + i < n) w.ring[(ua + j0 + i) & w.mask] = v[i];
  }
}

// The record of a batch whose output holds offset pos (pos >= 0).
__device__ __forceinline__ int owner(const blz::Batch& bt, int n, int pos) {
  int lo = 0, hi = n - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (bt.rec[mid].x <= pos) lo = mid;
    else hi = mid - 1;
  }
  return lo;
}

// Bits lo..hi.
__device__ __forceinline__ unsigned span_mask(int lo, int hi) {
  return (hi >= 31 ? ~0u : (1u << (hi + 1)) - 1) & ~((1u << lo) - 1);
}

// Warp 2: place each batch's records in the output ring, flush the ring
// to the global row as it fills, release the input behind the batch.
__device__ __forceinline__ void copy_warp(blz::Pipe& sh, Out& w, int out_len, int cs) {
  const int lane = threadIdx.x & 31;
  int qt = 0;
  long long op = 0;
  bool err = cs <= 0;
  if (cs > 1) {
    for (int h = 0;; ++h) {
      if (h >= qt) qt = blz::wait_at_least(sh.ctl.q_tail, h + 1);
      const blz::Batch& bt = sh.q[h % blz::kQ];
      const int n = bt.n, final = bt.final, cend = bt.cend;
      const long long op0 = bt.op0;
      op = bt.op_end;
      err = bt.err;
      const int4 rc = lane < n ? bt.rec[lane] : make_int4(0, 0, 0, 0);
      const bool v = lane < n, lit = v && !rc.w, mt = v && rc.w;
      const long long opr = op0 + rc.x;
      const long long end = op < out_len ? op : out_len;
      if (end - op0 <= kCap) {
        // literals first (each by its lane), then the matches
        if (w.wrap && end > w.flushed + w.mask + 1) {
          flush(w, w.flushed, op0);
          w.flushed = op0;
        }
        if (lit) lane_literal(w, sh.in, opr, rc.y, rc.z, out_len);
        __syncwarp();
        // matches in rounds: a match goes once no earlier pending match
        // writes the bytes it reads ([x - d, x - d + min(len, d)), found by
        // binary search over the batch's offsets); short ones one lane each
        unsigned pend = __ballot_sync(blz::kFull, mt);
        unsigned dep = 0;
        if (mt) {
          const int sb = rc.x - rc.z, e = sb + min(rc.y, rc.z);
          if (e > 0)
            dep = pend & span_mask(owner(bt, n, sb > 0 ? sb : 0), owner(bt, n, e - 1));
        }
        while (pend) {
          const bool ready = mt && ((pend >> lane) & 1) && !(dep & pend);
          const unsigned rm = __ballot_sync(blz::kFull, ready);
          const bool one = ready && rc.y <= 64;
          if (one) lane_match(w, opr, rc.y, rc.z);
          __syncwarp();
          for (unsigned lm = __ballot_sync(blz::kFull, ready && !one); lm;
               lm &= lm - 1) {
            const int r = __ffs(lm) - 1;
            warp_match(w, op0 + __shfl_sync(blz::kFull, rc.x, r),
                       __shfl_sync(blz::kFull, rc.y, r),
                       __shfl_sync(blz::kFull, rc.z, r));
          }
          pend &= ~rm;
        }
      } else {                     // a long batch: records in order
        for (int r = 0; r < n; ++r) {
          const int x = __shfl_sync(blz::kFull, rc.x, r);
          const int len = __shfl_sync(blz::kFull, rc.y, r);
          const int arg = __shfl_sync(blz::kFull, rc.z, r);
          if (__shfl_sync(blz::kFull, rc.w, r)) {
            warp_match(w, op0 + x, len, arg);
          } else {
            const long long at = op0 + x;
            if (w.wrap && at + len > w.flushed + w.mask + 1) {
              flush(w, w.flushed, at);
              w.flushed = at;
            }
            if (lane < len && at + lane < out_len)
              w.ring[(unsigned)(at + lane) & w.mask] =
                  sh.in[(arg + lane + w.off0) & (blz::kIn - 1)];
            __syncwarp();
          }
        }
      }
      if (final) break;
      blz::publish(sh.ctl.ipos_done, cend);
      blz::publish(sh.ctl.q_head, h + 1);
    }
  }
  blz::vstore(sh.ctl.ipos_done, blz::kNoLimit);
  __syncwarp();
  const long long end = op < out_len ? op : out_len;
  flush(w, w.flushed, end);
  zero_tail(w.o, end, out_len);
  w.produced = op;
  w.err = err;
}

__global__ void __launch_bounds__(96)
decode_kernel(const uint8_t* __restrict__ slots, int N, int W,
              const int32_t* __restrict__ csizes, int out_len, int ring_bytes,
              uint8_t* __restrict__ out, int32_t* __restrict__ produced,
              uint8_t* __restrict__ err_out) {
  extern __shared__ __align__(16) uint8_t smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long row = blockIdx.x;
  const uint8_t* s = slots + row * (long long)W;
  const int cs = csizes[row];
  const int tail = (W >= kMinWidth && W > 0) ? (int)s[W - 1] : 0;
  blz::Pipe& sh = *reinterpret_cast<blz::Pipe*>(smem + ring_bytes);
  if (threadIdx.x == 0) sh.ctl = blz::Ctl{0, 0, 0, 0, 0, cs <= 1 ? 1 : 0};
  __syncthreads();
  if (warp == 0) {
    if (cs > 1) blz::eval_warp(sh, s, W, tail, cs);
  } else if (warp == 1) {
    if (cs > 1)
      blz::record_warp(sh, blz::GlobalReader{s, W, tail}, cs, out_len);
  } else {
    Out w{smem, (unsigned)ring_bytes - 1, ring_bytes < out_len, 0,
          out + row * (long long)out_len, 0, false, (int)((uintptr_t)s & 15)};
    copy_warp(sh, w, out_len, cs);
    if (lane == 0) {
      produced[row] = (int32_t)w.produced;
      err_out[row] = w.err ? 1 : 0;
    }
  }
}

int ring_for(int out_len) {
  int r = 256;
  while (r < out_len && r < kMaxRing) r <<= 1;
  return r;
}

}  // namespace

extern "C" int decode_launch(const void* slots, int N, int W,
                             const void* csizes, int out_len, void* out,
                             void* produced, void* err, void* stream) {
  if (N > 0) {
    const int ring = ring_for(out_len);
    const int smem = ring + (int)sizeof(blz::Pipe);
    cudaError_t e = cudaFuncSetAttribute(
        decode_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    decode_kernel<<<N, 96, smem, (cudaStream_t)stream>>>(
        (const uint8_t*)slots, N, W, (const int32_t*)csizes, out_len, ring,
        (uint8_t*)out, (int32_t*)produced, (uint8_t*)err);
  }
  return (int)cudaGetLastError();
}
