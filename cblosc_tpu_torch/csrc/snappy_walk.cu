// Snappy walk kernel (K5): parse raw snappy streams into compacted
// records, one warp per row.
//
// Replaces cblosc_tpu/tpu/codec_snappy.py:_walk_batch (a batched
// lax.while_loop that parses up to 8 tags per 512-byte window read).
// The grammar and every check are _walk_batch's; bytes at or past csize
// (or the row width) read as 0:
//   preamble the uvarint length in at most 5 bytes, each below csize; err
//            if it runs on past them, sets a bit at or above bit 32,
//            differs from out_len, or reaches csize (rows with csize <= 0
//            are finished and not ok)
//   literal  tag & 3 == 0: (tag >> 2) + 1 bytes, or 1-4 little-endian
//            extra bytes + 1 (tag >> 2 = 60..63); err if the fourth extra
//            byte is set, ipl + len > csize or op + len > out_len
//   copy     tag & 3 == 1: len 4 + (tag >> 2 & 7), offset (tag >> 5) << 8
//            | next byte; 2: len (tag >> 2) + 1, 2-byte offset; 3: the
//            same with a 4-byte offset whose top byte must be 0; err if
//            the offset is 0 or beyond op, op + len > out_len, or the
//            token runs past csize
//   fin      when the next tag would start at or past csize (no
//            terminator)
//   budget   err when a record would be the (E+1)-th
//   ok       = !err && op == out_len
// Records are written compacted, valid first: (kind 0, stream offset, dst,
// len) per literal, (kind 1, offset, dst, len) per copy, then kind -1 and
// zeros up to E; the kernel writes every column. dist is the first copy's
// offset, uni says all share it.
//
// What bounds it on an H100: latency, one dependent step per tag, as for
// the blosclz walk (walk.cu), whose warp-window parser this kernel shares
// (blosclz_parse.cuh): snappy tags are self-contained too. Per row one
// warp, four rows to a CTA:
//   1. the row's stream is staged in shared memory, two stages of 2 KB
//      loaded with 16-byte cp.async copies, the next in flight while the
//      current one is parsed (blz::Stage); bytes at or past min(csize, W)
//      read 0;
//   2. a window is the 128 positions from the current tag. Lane l holds
//      the 16 bytes from position 4l in registers and evaluates, for its
//      four positions, the tag that would start there: successor delta
//      (a literal's may leave the window, so deltas are ints), output
//      length, argument, and the checks that need no output position (a
//      set fourth length byte, offset 0, past csize). A second pass adds
//      the two-tag delta where the second tag starts in the window;
//   3. the chain of real tags is followed through the tables, two tags a
//      shared-memory load where it can; lane r then owns record r (and
//      r + 32: a tag takes at least 2 bytes, so a window holds at most
//      64). A warp scan of the lengths gives each record's op; the checks
//      that need it (offset above op, op + len past out_len) and the
//      budget give the first failing or final record by a ballot and
//      find-first-set; the records are stored by consecutive lanes;
//   4. the next window starts at the tag the chain landed on, which may
//      be far past this one after a long literal.
// The uvarint preamble is read by lanes 0-4 from global memory.

#include <cstdint>
#include <cuda_runtime.h>

#include "blosclz_parse.cuh"

namespace {

constexpr int kWarps = 4;           // rows per CTA
constexpr int kStage = 2048;        // bytes per stage (two per warp)
constexpr int kWin = blz::kWin;     // positions a window evaluates
constexpr uint8_t kCopy = 1;        // flags: a copy (else a literal)
constexpr uint8_t kPerr = 2;        // flags: an error of the tag alone

// A warp's per-window tables in shared memory.
struct Tables {
  int delta[kWin];                  // successor delta of a tag at each position
  int delta2[kWin];                 // two-tag delta, 0 unless both in the window
  int len[kWin];                    // output bytes
  int arg[kWin];                    // literal: offset of its bytes; copy: offset
  uint8_t flags[kWin];
  uint8_t cpos[kWin / 2];           // the chain's positions
};

// The tag at byte j (0..3) of a lane's 16 bytes (lo: bytes 0-7, hi: 8-15),
// at stream position p: returns its successor delta; len, arg and flags
// as the tables hold them.
__device__ __forceinline__ int eval_tag(unsigned long long lo,
                                        unsigned long long hi, int j, int p,
                                        int cs, int& len, int& arg,
                                        int& flags) {
  const int tag = blz::byte_of(lo, hi, j), b1 = blz::byte_of(lo, hi, j + 1);
  const int b2 = blz::byte_of(lo, hi, j + 2), b3 = blz::byte_of(lo, hi, j + 3);
  const int b4 = blz::byte_of(lo, hi, j + 4);
  const int typ = tag & 3, base = tag >> 2;
  if (typ == 0) {
    const int extra = min(max(base - 59, 0), 4);
    const int ext_val = b1 | (extra >= 2 ? b2 << 8 : 0) |
                        (extra >= 3 ? b3 << 16 : 0);
    len = extra == 0 ? base + 1 : ext_val + 1;
    arg = p + 1 + extra;
    flags = ((extra == 4 && b4 != 0) || arg + len > cs) ? kPerr : 0;
    return 1 + extra + len;
  }
  len = typ == 1 ? (base & 7) + 4 : base + 1;
  arg = typ == 1 ? (((base >> 3) << 8) | b1)
                 : (b1 | (b2 << 8) | (typ == 2 ? 0 : b3 << 16));
  const int d = typ == 1 ? 2 : typ == 2 ? 3 : 5;
  flags = kCopy |
          (((typ == 3 && b4 != 0) || arg == 0 || p + d > cs) ? kPerr : 0);
  return d;
}

// Fill the tables for the window at t (a tag at t).
template <int S>
__device__ __forceinline__ void window_tables(const blz::Stage<S>& st,
                                              Tables& tb, int t, int cs) {
  const int lane = threadIdx.x & 31;
  const int p0 = t + 4 * lane;
  unsigned w[4];
  if (t + kWin + 16 <= st.lim) {    // all bytes are the row's
    const int a = (t + st.off0) & 3;
    const int base = p0 - a;        // base + off0 is 4-aligned
    unsigned r[5];
#pragma unroll
    for (int k = 0; k < 5; ++k) r[k] = st.word(base + 4 * k);
#pragma unroll
    for (int k = 0; k < 4; ++k) w[k] = __funnelshift_r(r[k], r[k + 1], 8 * a);
  } else {
#pragma unroll
    for (int k = 0; k < 4; ++k)
      w[k] = (unsigned)st.b(p0 + 4 * k) | ((unsigned)st.b(p0 + 4 * k + 1) << 8) |
             ((unsigned)st.b(p0 + 4 * k + 2) << 16) |
             ((unsigned)st.b(p0 + 4 * k + 3) << 24);
  }
  const unsigned long long lo = w[0] | ((unsigned long long)w[1] << 32);
  const unsigned long long hi = w[2] | ((unsigned long long)w[3] << 32);
  int d[4], ln[4], ag[4], fl[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) d[j] = eval_tag(lo, hi, j, p0 + j, cs, ln[j], ag[j], fl[j]);
  *reinterpret_cast<int4*>(tb.delta + 4 * lane) = make_int4(d[0], d[1], d[2], d[3]);
  *reinterpret_cast<int4*>(tb.len + 4 * lane) = make_int4(ln[0], ln[1], ln[2], ln[3]);
  *reinterpret_cast<int4*>(tb.arg + 4 * lane) = make_int4(ag[0], ag[1], ag[2], ag[3]);
  *reinterpret_cast<uchar4*>(tb.flags + 4 * lane) =
      make_uchar4(fl[0], fl[1], fl[2], fl[3]);
  __syncwarp();
  int d2[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int i = 4 * lane + j;
    d2[j] = i + d[j] < kWin ? d[j] + tb.delta[i + d[j]] : 0;
  }
  *reinterpret_cast<int4*>(tb.delta2 + 4 * lane) = make_int4(d2[0], d2[1], d2[2], d2[3]);
  __syncwarp();
}

// Follow the chain from the window's start: returns the records n (their
// positions in tb.cpos) and sets c to the position after the last one,
// relative to t (>= kWin).
__device__ __forceinline__ int hop(Tables& tb, int& c) {
  int i = 0, n = 0;
  while (i < kWin) {
    const int d2 = tb.delta2[i];
    tb.cpos[n++] = (uint8_t)i;
    if (d2) {
      tb.cpos[n++] = (uint8_t)(i + tb.delta[i]);
      i += d2;
    } else {
      i += tb.delta[i];
    }
  }
  c = i;
  __syncwarp();
  return n;
}

// Record r of the chain (valid when r < n), read from the tables.
struct Rec {
  int len, arg;
  bool match, perr, fin;
};
__device__ __forceinline__ Rec table_rec(const Tables& tb, int t, int r, int n,
                                         int cs) {
  const int i = r < n ? tb.cpos[r] : 0;
  const int fl = tb.flags[i];
  return {tb.len[i], tb.arg[i], (fl & kCopy) != 0, (fl & kPerr) != 0,
          t + i + tb.delta[i] >= cs};
}

__global__ void __launch_bounds__(kWarps * 32)
snappy_walk_kernel(const uint8_t* __restrict__ slots, int N, int W,
                   const int32_t* __restrict__ csizes, int out_len, int E,
                   int32_t* __restrict__ kind, int32_t* __restrict__ arg,
                   int32_t* __restrict__ dst, int32_t* __restrict__ len,
                   int32_t* __restrict__ dist_out,
                   uint8_t* __restrict__ uni_out,
                   uint8_t* __restrict__ ok_out) {
  __shared__ __align__(16) uint8_t stage_buf[kWarps][2 * kStage];
  __shared__ __align__(16) Tables tables[kWarps];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long row = (long long)blockIdx.x * kWarps + warp;
  if (row >= N) return;             // warp-uniform: no block barrier below
  const uint8_t* s = slots + row * (long long)W;
  const int cs = csizes[row];
  const int lim = cs < W ? cs : W;
  const long long rb = row * (long long)E;

  // ---- uvarint preamble (bytes below csize; read as the JAX walk does,
  //      from the row itself) ----------------------------------------------
  const int pb = (lane < 5 && lane < W) ? (int)__ldg(s + lane) : 0;
  unsigned long long val = 0;
  int nv = 0;
  bool cont = true, overflow = false;
  for (int i = 0; i < 5; ++i) {
    const int bi = __shfl_sync(blz::kFull, pb, i);
    const bool take = cont && i < cs;
    if (take) {
      overflow = overflow || (i == 4 && (bi & 0x7F) > 0xF);
      val |= (unsigned long long)(bi & 0x7F) << (7 * i);
      nv = i + 1;
    }
    cont = take && (bi & 0x80) != 0;
  }
  const bool live = cs > 0;
  bool err = live && (cont || overflow || val != (unsigned long long)out_len ||
                      cs <= nv);
  bool fin = !live;

  blz::Stage<kStage> st;
  Tables& tb = tables[warp];
  if (!(err || fin)) st.init(stage_buf[warp], s, lim, 0);
  int t = nv, cnt = 0, dist = 0;
  long long op = 0;
  bool uni = true;
  while (!(err || fin)) {
    st.ensure(t);
    window_tables(st, tb, t, cs);
    int crel;
    const int n = hop(tb, crel);
    const Rec a = table_rec(tb, t, lane, n, cs);
    const Rec b = table_rec(tb, t, lane + 32, n, cs);
    const bool v0 = lane < n, v1 = lane + 32 < n;
    const int L0 = v0 ? a.len : 0, L1 = v1 ? b.len : 0;
    const int i0 = blz::warp_incl_scan(L0);
    const int i1 = blz::warp_incl_scan(L1) + __shfl_sync(blz::kFull, i0, 31);
    const long long op0 = op + i0 - L0, op1 = op + i1 - L1;
    const int c0 = cnt + lane, c1 = cnt + lane + 32;
    const bool e0 = a.perr || op0 + L0 > out_len || c0 >= E ||
                    (a.match && a.arg > op0);
    const bool e1 = b.perr || op1 + L1 > out_len || c1 >= E ||
                    (b.match && b.arg > op1);
    const int f = blz::first_set(__ballot_sync(blz::kFull, v0 && (e0 || a.fin)),
                                 __ballot_sync(blz::kFull, v1 && (e1 || b.fin)),
                                 n);
    // record f stops the row: emitted when it ends the stream without error
    int fstate = 0;                 // 1: err, 2: fin without err
    if (f < n) fstate = blz::pick(e0 ? 1 : 2, e1 ? 1 : 2, f);
    const int nemit = f + (fstate == 2 ? 1 : 0);
    const bool m0 = lane < nemit, m1 = lane + 32 < nemit;
    if (m0) {
      kind[rb + c0] = a.match ? 1 : 0;
      arg[rb + c0] = a.arg;
      dst[rb + c0] = (int)op0;
      len[rb + c0] = L0;
    }
    if (m1) {
      kind[rb + c1] = b.match ? 1 : 0;
      arg[rb + c1] = b.arg;
      dst[rb + c1] = (int)op1;
      len[rb + c1] = L1;
    }
    // dist: the first emitted copy's offset; uni: all emitted share it
    const unsigned mm0 = __ballot_sync(blz::kFull, m0 && a.match);
    const unsigned mm1 = __ballot_sync(blz::kFull, m1 && b.match);
    if (mm0 | mm1) {
      if (dist == 0) dist = blz::pick(a.arg, b.arg, blz::first_set(mm0, mm1, 64));
      uni = uni && !__any_sync(blz::kFull, (m0 && a.match && a.arg != dist) ||
                                             (m1 && b.match && b.arg != dist));
    }
    cnt += nemit;
    if (nemit > 0) op += blz::pick(i0, i1, nemit - 1);  // through the last emitted
    if (fstate == 1) err = true;
    else if (fstate == 2) fin = true;
    else t += crel;
  }
  blz::cp_async_wait<0>();          // no copy lands after the warp is done
  for (int i = cnt + lane; i < E; i += 32) {
    kind[rb + i] = -1;
    arg[rb + i] = 0;
    dst[rb + i] = 0;
    len[rb + i] = 0;
  }
  if (lane == 0) {
    dist_out[row] = dist;
    uni_out[row] = uni ? 1 : 0;
    ok_out[row] = (!err && op == out_len) ? 1 : 0;
  }
}

}  // namespace

extern "C" int snappy_walk_launch(const void* slots, int N, int W,
                                  const void* csizes, int out_len, int E,
                                  void* kind, void* arg, void* dst, void* len,
                                  void* dist, void* uni, void* ok,
                                  void* stream) {
  if (N > 0) {
    snappy_walk_kernel<<<(N + kWarps - 1) / kWarps, kWarps * 32, 0,
                         (cudaStream_t)stream>>>(
        (const uint8_t*)slots, N, W, (const int32_t*)csizes, out_len, E,
        (int32_t*)kind, (int32_t*)arg, (int32_t*)dst, (int32_t*)len,
        (int32_t*)dist, (uint8_t*)uni, (uint8_t*)ok);
  }
  return (int)cudaGetLastError();
}
