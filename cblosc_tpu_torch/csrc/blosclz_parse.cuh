// Warp-window blosclz stream parser, shared by the walk (walk.cu) and the
// generic decoder (decode.cu).
//
// The wire grammar is blosclz.c:679-789 as the JAX machines read it
// (cblosc_tpu/tpu/structured.py:_walk_impl, cblosc_tpu/tpu/codec.py:
// _decode_one). A token at position p has its data at ip = p + 1:
//   literal  v < 32: v + 1 bytes at ip; the next token sits at ip + v + 1
//   match    v >= 32: length (v >> 5) + 2, or with the 7 escape
//            9 + extacc + 255 * k + lastb over k leading 255 bytes; the
//            distance byte follows, then two more bytes for the 31/255 far
//            escape (+ 8192); the next token follows the distance bytes
//   escape   a 7-escape token followed by eight 255 bytes advances ip by 8
//            and re-reads with the same token (err if ip + 8 >= csize)
//   first    the stream starts with the literal src[0] & 31 at ip = 1
//
// How a warp parses (one warp owns one row):
//   1. The row's stream is staged in shared memory: two stages of S bytes,
//      loaded with 16-byte cp.async copies, the next one in flight while
//      the current one is parsed (Stage).
//   2. A window is the kWin = 128 positions starting at the current token.
//      Lane l holds the 16 bytes from position 4l in registers (five
//      aligned 4-byte shared loads and funnel shifts) and evaluates, for its
//      four positions, the token that would start there: successor delta,
//      length, distance. The table goes to shared memory, and a second pass
//      adds the two-token delta (Tables::delta2).
//   3. The chain of real tokens through the window is followed by hopping
//      through the tables, two tokens per shared-memory load where the
//      two-token delta exists; the chain's positions go to Tables::cpos.
//   4. Lane r then owns record r (and record r + 32): it reads its fields
//      from the tables. The kernel scans the record lengths across the warp
//      to get each record's op, applies the op-dependent checks and takes
//      the first failing record by find-first-set of a ballot.
// The first token and 7-escape runs of eight 255 bytes are taken by the
// scalar path (all lanes in step, bytes read from global memory), since an
// escape run may be longer than any window.
//
// The walk (walk.cu) runs steps 1-4 in turn on one warp per row. The
// pipelined parser at the end of this file runs the same steps on three
// warps of one CTA at once (eval_warp, record_warp, and the decoder's copy
// warp in decode.cu), since a decoded row is long and has no other rows to
// hide its latency behind.
//
// Byte rules differ between the two machines, so both readers take the
// row's rule as (lim, tail): a byte at x < lim is the row's, any other is
// tail. The walk reads 0 at or past min(csize, W); the decoder clamps to
// its padded width max(W, 552), which reads src[W - 1] past W when
// W >= 552 and 0 otherwise.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace blz {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kWin = 128;       // token positions one window evaluates
// bytes a window may read from its start: the last position's 32-byte
// literal (kWin + 32) and a match's 12-byte look-ahead fit below this
constexpr int kNeed = 176;
constexpr int kEscapeAcc = 8 * 255;
constexpr int kLitBit = 1 << 12;  // set in a literal's table length

// One record: a token at a known position, its fields as the machine
// computes them.
struct Rec {
  int nxt;         // position of the next token byte
  int len;         // output bytes
  int arg;         // literal: stream offset of its bytes (ip); match: distance
  bool match;
  bool perr;       // position-only error: literal ip2 > csize; match ip4 >= csize
  bool fin;        // literal ending at/past csize
};

// Row bytes straight from global memory, with the row's rule.
struct GlobalReader {
  const uint8_t* __restrict__ s;
  int lim, tail;
  __device__ __forceinline__ int b(long long x) const {
    return x < lim ? (int)__ldg(s + x) : tail;
  }
};

__device__ __forceinline__ Rec literal_rec(int ip, int token, int cs) {
  Rec k;
  k.nxt = ip + token + 1;
  k.len = token + 1;
  k.arg = ip;
  k.match = false;
  k.perr = k.nxt > cs;
  k.fin = k.nxt >= cs;
  return k;
}

// The scalar path: one whole token at the standard state (token byte at t),
// escape runs included. Every lane computes the same result.
__device__ __forceinline__ Rec scalar_rec(const GlobalReader& g, int t, int cs) {
  int ip = t + 1;
  const int token = g.b(t);
  if (token < 32) return literal_rec(ip, token, cs);
  Rec k;
  k.match = true;
  k.fin = false;
  int extacc = 0;
  long long ip2 = ip;
  if ((token >> 5) == 7) {
    int kk;
    while (true) {
      kk = 0;
      while (kk < 8 && g.b(ip + kk) == 255) ++kk;
      if (kk < 8) break;
      if (ip + 8 >= cs) {        // the escape's own check: an error
        k.perr = true;
        k.len = 0;
        k.arg = 0;
        k.nxt = ip + 8;
        return k;
      }
      ip += 8;
      extacc += kEscapeAcc;
    }
    k.len = 9 + extacc + 255 * kk + g.b(ip + kk);
    ip2 = ip + kk + 1;
  } else {
    k.len = (token >> 5) + 2;
  }
  const int dhi = token & 31, dlo = g.b(ip2);
  if (dlo == 255 && dhi == 31) {
    k.arg = (g.b(ip2 + 1) << 8) + g.b(ip2 + 2) + 8192;
    k.nxt = (int)ip2 + 3;
  } else {
    k.arg = (dhi << 8) + dlo + 1;
    k.nxt = (int)ip2 + 1;
  }
  k.perr = k.nxt >= cs;
  return k;
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned sa = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(sa),
               "l"(gmem)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// A warp's double-buffered stage of its row. Stage number sn holds the
// 16-byte-aligned span [sn * S, (sn + 1) * S) of the row in "aligned
// space" u = x + off0 (off0 = the row's misalignment), in buf slot sn & 1,
// so byte x sits at buf[(x + off0) & (2S - 1)]. Stages cur and cur + 1 are
// always issued; ensure(t) makes [t, t + kNeed) resident.
template <int S>
struct Stage {
  static_assert(S % 512 == 0 && S >= kNeed, "stage size");
  static constexpr int kMask = 2 * S - 1;
  uint8_t* buf;                  // 2 * S bytes of shared memory, 16-aligned
  const uint8_t* __restrict__ s; // the row
  const uint8_t* a0;             // s - off0, 16-aligned
  int off0, lim, tail, cur;

  __device__ __forceinline__ void init(uint8_t* sbuf, const uint8_t* row,
                                       int lim_, int tail_) {
    buf = sbuf;
    s = row;
    off0 = (int)((uintptr_t)row & 15);
    a0 = row - off0;
    lim = lim_;
    tail = tail_;
    cur = 0;
    issue(0);
    issue(1);
  }

  __device__ __forceinline__ void issue(int sn) {
    const int lane = threadIdx.x & 31;
    uint8_t* dst = buf + (sn & 1) * S;
    const long long ub = (long long)sn * S;
    for (int q = lane; q < S / 16; q += 32) {
      const long long x = ub + 16 * q - off0;   // row offset of the chunk
      if (x >= 0 && x + 16 <= lim) {
        cp_async16(dst + 16 * q, a0 + ub + 16 * q);
      } else if (x + 16 > 0 && x < lim) {         // ragged row edge
        for (int i = 0; i < 16; ++i)
          if (x + i >= 0 && x + i < lim) dst[16 * q + i] = s[x + i];
      }
    }
    cp_async_commit();
  }

  __device__ __forceinline__ void ensure(int t) {
    __syncwarp();                // every lane is done with the old slot
    const int lo = (t + off0) / S;
    const int hi = (t + off0 + kNeed - 1) / S;
    if (lo == cur + 1) {
      issue(cur + 2);
      cur = lo;
    } else if (lo > cur + 1) {   // the scalar path skipped ahead
      cp_async_wait<0>();
      __syncwarp();
      issue(lo);
      issue(lo + 1);
      cur = lo;
    }
    if (hi == cur) cp_async_wait<1>();
    else cp_async_wait<0>();
    __syncwarp();
  }

  __device__ __forceinline__ int b(int x) const {
    return x < lim ? (int)buf[(x + off0) & kMask] : tail;
  }
  // 4 bytes from x; x + off0 is 4-aligned (no rule applied)
  __device__ __forceinline__ unsigned word(int x) const {
    return *reinterpret_cast<const unsigned*>(buf + ((x + off0) & kMask));
  }
};

// A warp's per-window tables in shared memory.
struct Tables {
  uint8_t delta[kWin];    // successor delta of a token at each position; 0: escape
  uint8_t delta2[kWin];   // two-token delta where both stay in the window, else 0
  uint8_t cpos[kWin / 2]; // the chain's positions
  uint16_t len[kWin];     // output length, kLitBit for a literal
  int dist[kWin];         // a match's distance
};

__device__ __forceinline__ int byte_of(unsigned long long lo,
                                       unsigned long long hi, int q) {
  return (int)((q < 8 ? lo >> (8 * q) : hi >> (8 * (q - 8))) & 255);
}

// Evaluate the token that would start at byte j (0..3) of a lane's 16
// bytes (lo: bytes 0-7, hi: 8-15). Returns the delta (0: escape run); len
// is the output length (| kLitBit for a literal), dist a match's distance.
__device__ __forceinline__ int eval_at(unsigned long long lo,
                                       unsigned long long hi, int j, int& len,
                                       int& dist) {
  const int v = byte_of(lo, hi, j);
  dist = 0;
  if (v < 32) {
    len = (v + 1) | kLitBit;
    return v + 2;
  }
  int q = j + 1;                 // ip, relative
  if (v >= 224) {
    const int s = 8 * (j + 1);   // bytes j+1 .. j+8
    const unsigned long long w = (lo >> s) | (hi << (64 - s));
    const int kk = __clzll(__brevll(~w)) >> 3;   // leading 255 bytes, <= 8
    if (kk == 8) {
      len = 0;
      return 0;
    }
    len = 9 + 255 * kk + byte_of(lo, hi, j + 1 + kk);
    q = j + 2 + kk;
  } else {
    len = (v >> 5) + 2;
  }
  const int dhi = v & 31, dlo = byte_of(lo, hi, q);
  if (dlo == 255 && dhi == 31) {
    dist = (byte_of(lo, hi, q + 1) << 8) + byte_of(lo, hi, q + 2) + 8192;
    return q + 3 - j;
  }
  dist = (dhi << 8) + dlo + 1;
  return q + 1 - j;
}

// Two-token delta at position i with delta d: 0 unless both tokens exist
// and the second starts inside the window.
__device__ __forceinline__ uint8_t delta2_at(const Tables& tb, int i, int d) {
  const int e = (d != 0 && i + d < kWin) ? tb.delta[i + d] : 0;
  return (uint8_t)(e ? d + e : 0);
}

// Fill the tables for the window at t (standard state: a token byte at t).
template <int S>
__device__ __forceinline__ void window_tables(const Stage<S>& st, Tables& tb,
                                              int t) {
  const int lane = threadIdx.x & 31;
  const int p0 = t + 4 * lane;
  unsigned w[4];
  if (t + kWin + 16 <= st.lim) {                  // all bytes are the row's
    const int a = (t + st.off0) & 3;
    const int base = p0 - a;                      // base + off0 is 4-aligned
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
  uchar4 d;
  int ln[4], ds[4];
  d.x = (uint8_t)eval_at(lo, hi, 0, ln[0], ds[0]);
  d.y = (uint8_t)eval_at(lo, hi, 1, ln[1], ds[1]);
  d.z = (uint8_t)eval_at(lo, hi, 2, ln[2], ds[2]);
  d.w = (uint8_t)eval_at(lo, hi, 3, ln[3], ds[3]);
  *reinterpret_cast<uchar4*>(tb.delta + 4 * lane) = d;
  *reinterpret_cast<ushort4*>(tb.len + 4 * lane) =
      make_ushort4(ln[0], ln[1], ln[2], ln[3]);
  *reinterpret_cast<int4*>(tb.dist + 4 * lane) =
      make_int4(ds[0], ds[1], ds[2], ds[3]);
  __syncwarp();
  const uchar4 d2 = make_uchar4(delta2_at(tb, 4 * lane, d.x),
                                delta2_at(tb, 4 * lane + 1, d.y),
                                delta2_at(tb, 4 * lane + 2, d.z),
                                delta2_at(tb, 4 * lane + 3, d.w));
  *reinterpret_cast<uchar4*>(tb.delta2 + 4 * lane) = d2;
  __syncwarp();
}

// Follow the chain from the window's start. Returns the number of records
// n (positions in tb.cpos) and sets c to the position after the last one
// (relative to t): >= kWin, or an escape-run token inside the window.
__device__ __forceinline__ int hop(Tables& tb, int& c) {
  int i = 0, n = 0;
  while (i < kWin) {
    const int d1 = tb.delta[i], d2 = tb.delta2[i];
    if (d1 == 0) break;
    tb.cpos[n++] = (uint8_t)i;
    if (d2) {
      tb.cpos[n++] = (uint8_t)(i + d1);
      i += d2;
    } else {
      i += d1;
    }
  }
  c = i;
  __syncwarp();
  return n;
}

// Record r of the chain (valid when r < n), read from the tables.
__device__ __forceinline__ Rec table_rec(const Tables& tb, int t, int r, int n,
                                         int cs) {
  const int i = r < n ? tb.cpos[r] : 0;
  const int p = t + i;
  const int ln = tb.len[i];
  if (ln & kLitBit) return literal_rec(p + 1, (ln & ~kLitBit) - 1, cs);
  Rec k;
  k.nxt = p + tb.delta[i];
  k.len = ln;
  k.arg = tb.dist[i];
  k.match = true;
  k.perr = k.nxt >= cs;
  k.fin = false;
  return k;
}

// Lane's two records of one parse step from the standard state (token
// byte at t); first: the stream's first token (src[0] & 31 at ip = 1).
// Returns n; c is the token position after the last record.
template <int S>
__device__ __forceinline__ int parse_step(const Stage<S>& st,
                                          const GlobalReader& g, Tables& tb,
                                          int t, int cs, bool first, Rec& r0,
                                          Rec& r1, int& c) {
  const int lane = threadIdx.x & 31;
  if (first) {
    r0 = literal_rec(1, st.b(0) & 31, cs);
    r1 = r0;
    c = r0.nxt;
    return 1;
  }
  window_tables(st, tb, t);
  if (tb.delta[0] == 0) {
    r0 = scalar_rec(g, t, cs);
    r1 = r0;
    c = r0.nxt;
    return 1;
  }
  int crel;
  const int n = hop(tb, crel);
  c = t + crel;
  r0 = table_rec(tb, t, lane, n, cs);
  r1 = table_rec(tb, t, lane + 32, n, cs);
  return n;
}

__device__ __forceinline__ int warp_incl_scan(int v) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int u = __shfl_up_sync(kFull, v, o);
    if (lane >= o) v += u;
  }
  return v;
}

// Record r's value of a per-lane pair (a0 for r < 32, a1 otherwise), to
// every lane; r is warp-uniform.
template <class T>
__device__ __forceinline__ T pick(T a0, T a1, int r) {
  return __shfl_sync(kFull, r < 32 ? a0 : a1, r & 31);
}

// First set index of a 64-record ballot pair, or n when none.
__device__ __forceinline__ int first_set(unsigned m0, unsigned m1, int n) {
  if (m0) return __ffs(m0) - 1;
  if (m1) return 32 + __ffs(m1) - 1;
  return n;
}

// ---------------------------------------------------------------------------
// The pipelined parser: warps of one CTA per row, handing work on through
// counters in shared memory (Ctl).
//   eval_warp    stages the stream with cp.async into an input ring and
//                evaluates the token at every position into a table ring,
//                with one-, two- and four-token jumps;
//   record_warp  follows the chain through the jumps, 32 records a batch,
//                applies the checks and queues the batch (Batch);
//   a consumer   (the decoder's copy warp) takes each batch, then releases the input behind it (ipos_done)
//                and its queue slot (q_head).

constexpr int kIn = 1 << 14;     // input ring (bytes)
constexpr int kChunk = 512;      // one cp.async of 16 B per lane
constexpr int kPrefetch = 2048;  // input bytes issued ahead of the eval
constexpr int kTab = 2048;       // table ring (positions)
constexpr int kQ = 4;            // record batches in flight
constexpr int kNoLimit = 0x7fffffff;

struct Batch {
  int n, final, err, cend;       // records; row ends; its err; stream end
  long long op0, op_end;         // op before and after the batch
  int4 rec[32];                  // (op offset, len, arg, is match)
};

struct Ctl {                     // counters, each written by one warp
  int ready;                     // eval: tables ready below this position
  int tab_done;                  // records: tables free below this position
  int ipos_done;                 // consumer: input free below this position
  int q_tail, q_head, stop;
};

struct Pipe {
  uint8_t in[kIn];
  uint8_t delta[kTab], delta2[kTab];   // one- and two-token deltas
  uint32_t jmp[kTab];            // delta | delta2 << 8 | delta4 << 16
  uint32_t info[kTab];           // len | kLitBit, dist << 13
  Batch q[kQ];
  Ctl ctl;
};

__device__ __forceinline__ int vload(const int& x) {
  return *reinterpret_cast<const volatile int*>(&x);
}
__device__ __forceinline__ void vstore(int& x, int v) {
  *reinterpret_cast<volatile int*>(&x) = v;
}
// Publish v after this warp's earlier shared-memory writes.
__device__ __forceinline__ void publish(int& x, int v) {
  __syncwarp();
  __threadfence_block();
  if ((threadIdx.x & 31) == 0) vstore(x, v);
  __syncwarp();
}
// Wait until x >= at least; returns the value read.
__device__ __forceinline__ int wait_at_least(const int& x, int at_least) {
  int v = vload(x);
  while (v < at_least) v = vload(x);
  __threadfence_block();
  return v;
}

__device__ __forceinline__ void cp_async_wait_n(int n) {
  switch (n < 0 ? 0 : n) {
    case 0: cp_async_wait<0>(); break;
    case 1: cp_async_wait<1>(); break;
    case 2: cp_async_wait<2>(); break;
    case 3: cp_async_wait<3>(); break;
    default: cp_async_wait<4>(); break;
  }
}

// Warp 0: stage the stream (cp.async, the row's byte rule applied to
// positions past lim) and evaluate the token at every position, a block
// of 128 positions at a time, into the table ring: block b's deltas, then
// block b-1's two-token deltas, then block b-2's four-token deltas (each
// 0 where a token of the run is an escape), packed into jmp.
__device__ __forceinline__ void eval_warp(Pipe& sh, const uint8_t* s, int lim,
                                          int tail, int cs) {
  const int lane = threadIdx.x & 31;
  const int off0 = (int)((uintptr_t)s & 15);
  const uint8_t* a0 = s - off0;
  const int nblocks = (cs + 127) / 128 + 2;
  int issued = 0, tab_free = 0, in_free = 0;
  for (int b = 0; b < nblocks; ++b) {
    if (vload(sh.ctl.stop)) break;
    const int need = 128 * b + 128 + 16 + off0;   // aligned-space bytes
    while (issued * kChunk < need + kPrefetch) {
      const int lo = (issued + 1) * kChunk - kIn - off0;
      while (in_free < lo) {     // the slot's old bytes are still needed
        if (vload(sh.ctl.stop)) return cp_async_wait<0>();
        in_free = vload(sh.ctl.ipos_done);
      }
      const int u = issued * kChunk + 16 * lane, x = u - off0;
      uint8_t* dst = sh.in + (u & (kIn - 1));
      if (x >= 0 && x + 16 <= lim) {
        cp_async16(dst, a0 + u);
      } else {
        for (int i = 0; i < 16; ++i)
          dst[i] = x + i >= 0 && x + i < lim ? s[x + i] : (uint8_t)tail;
      }
      cp_async_commit();
      ++issued;
    }
    cp_async_wait_n(issued - (need + kChunk - 1) / kChunk);
    __syncwarp();
    const int tlo = 128 * (b + 1) - kTab;
    while (tab_free < tlo) {     // the table slots are still being read
      if (vload(sh.ctl.stop)) return cp_async_wait<0>();
      tab_free = vload(sh.ctl.tab_done);
    }
    // the block's 128 positions: lane l holds the 16 bytes from 4l
    const int p0 = 128 * b + 4 * lane;
    const int a = (128 * b + off0) & 3;
    unsigned r[5];
#pragma unroll
    for (int k = 0; k < 5; ++k)
      r[k] = *reinterpret_cast<const unsigned*>(
          sh.in + ((p0 - a + off0 + 4 * k) & (kIn - 1)));
    unsigned w[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) w[k] = __funnelshift_r(r[k], r[k + 1], 8 * a);
    const unsigned long long wl = w[0] | ((unsigned long long)w[1] << 32);
    const unsigned long long wh = w[2] | ((unsigned long long)w[3] << 32);
    int ln[4], ds[4], dl[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) dl[k] = eval_at(wl, wh, k, ln[k], ds[k]);
    const int ti = p0 & (kTab - 1);
    *reinterpret_cast<uchar4*>(sh.delta + ti) =
        make_uchar4(dl[0], dl[1], dl[2], dl[3]);
    *reinterpret_cast<uint4*>(sh.info + ti) = make_uint4(
        ln[0] | (ds[0] << 13), ln[1] | (ds[1] << 13), ln[2] | (ds[2] << 13),
        ln[3] | (ds[3] << 13));
    __syncwarp();
    if (b > 0) {                 // two-token deltas of block b-1
      const int q0 = p0 - 128;
      uint8_t d2[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int d1 = sh.delta[(q0 + k) & (kTab - 1)];
        const int e = d1 ? sh.delta[(q0 + k + d1) & (kTab - 1)] : 0;
        d2[k] = (uint8_t)(e ? d1 + e : 0);
      }
      *reinterpret_cast<uchar4*>(sh.delta2 + (q0 & (kTab - 1))) =
          make_uchar4(d2[0], d2[1], d2[2], d2[3]);
      __syncwarp();
    }
    if (b > 1) {                 // four-token deltas of block b-2, packed
      const int q0 = p0 - 256;
      uint32_t jm[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int i = (q0 + k) & (kTab - 1);
        const int d1 = sh.delta[i], d2 = sh.delta2[i];
        const int e = d2 ? sh.delta2[(q0 + k + d2) & (kTab - 1)] : 0;
        jm[k] = d1 | (d2 << 8) | ((e ? d2 + e : 0) << 16);
      }
      *reinterpret_cast<uint4*>(sh.jmp + (q0 & (kTab - 1))) =
          make_uint4(jm[0], jm[1], jm[2], jm[3]);
      publish(sh.ctl.ready, 128 * (b - 1));
    }
  }
  cp_async_wait<0>();
}

// Warp 1: follow the chain through the tables (up to four tokens per
// load; escape runs by the scalar path), 32 records a batch; scan their
// lengths for op, apply the checks, cut the batch at the first record
// that ends the row, and queue it for the consumer.
__device__ __forceinline__ void record_warp(Pipe& sh, const GlobalReader& g,
                                            int cs, int out_len) {
  const int lane = threadIdx.x & 31;
  long long op = 0;
  int c = 0, avail = 0, qh = 0;
  bool first = true;
  for (int qt = 0;; ++qt) {
    if (qt - qh >= kQ)
      qh = wait_at_least(sh.ctl.q_head, qt - kQ + 1);
    // mypos: this lane's record position; adj: add the delta found there
    // (the fourth token of a four-token step)
    int n = 0, mypos = -1;
    bool adj = false;
    Rec mine;
    if (first) {
      avail = wait_at_least(sh.ctl.ready, 1);
      mine = literal_rec(1, g.b(0) & 31, cs);
      c = mine.nxt;
      n = 1;
      first = false;
    }
    while (n < 32 && c < cs) {
      if (c >= avail)
        avail = wait_at_least(sh.ctl.ready, c + 1);
      const uint32_t jm = sh.jmp[c & (kTab - 1)];
      const int d1 = jm & 255, d2 = (jm >> 8) & 255, d4 = jm >> 16;
      if (d1 == 0) {             // escape run: scalar path, then end batch
        const Rec e = scalar_rec(g, c, cs);
        if (lane == n) mine = e;
        ++n;
        c = e.nxt;
        break;
      }
      const int r = lane - n;
      if (d4 && n <= 28 && c + d4 < cs) {
        if (r == 0) mypos = c;
        if (r == 1) mypos = c + d1;
        if (r >= 2 && r < 4) mypos = c + d2;
        if (r == 3) adj = true;
        n += 4;
        c += d4;
      } else if (d2 && n <= 30 && c + d2 < cs) {
        if (r == 0) mypos = c;
        if (r == 1) mypos = c + d1;
        n += 2;
        c += d2;
      } else {
        if (r == 0) mypos = c;
        n += 1;
        c += d1;
      }
    }
    // (delta and info run 256 positions ahead of jmp: these are published)
    if (adj) mypos += sh.delta[mypos & (kTab - 1)];
    if (mypos >= 0) {
      const int ti = mypos & (kTab - 1);
      const uint32_t inf = sh.info[ti];
      const int ln = inf & 0x1fff;
      if (ln & kLitBit) {
        mine = literal_rec(mypos + 1, (ln & ~kLitBit) - 1, cs);
      } else {
        mine.nxt = mypos + sh.delta[ti];
        mine.len = ln;
        mine.arg = (int)(inf >> 13);
        mine.match = true;
        mine.perr = mine.nxt >= cs;
        mine.fin = false;
      }
    }
    const bool v = lane < n;
    const int L = v ? mine.len : 0;
    const int incl = warp_incl_scan(L), x = incl - L;
    const long long opr = op + x;
    const bool e = v && (mine.perr || opr + L > out_len ||
                         (mine.match && mine.arg > opr));
    const unsigned stops = __ballot_sync(kFull, v && (e || mine.fin));
    const int f = stops ? __ffs(stops) - 1 : n;
    Batch& bt = sh.q[qt % kQ];
    const bool flit = !__shfl_sync(kFull, (int)mine.match, f & 31) && f < n;
    const int nrec = f + (flit ? 1 : 0);
    if (lane < nrec) bt.rec[lane] = make_int4(x, L, mine.arg, mine.match ? 1 : 0);
    const int total = __shfl_sync(kFull, incl, 31);
    const int xf = __shfl_sync(kFull, x, f & 31);
    const int lf = __shfl_sync(kFull, L, f & 31);
    const long long op_end = f < n ? op + xf + (flit ? lf : 0) : op + total;
    const int ferr = __shfl_sync(kFull, (int)e, f & 31);
    if (lane == 0) {
      bt.n = nrec;
      bt.final = f < n;
      bt.err = f < n ? ferr : 0;
      bt.cend = c;
      bt.op0 = op;
      bt.op_end = op_end;
      vstore(sh.ctl.tab_done, c);
    }
    publish(sh.ctl.q_tail, qt + 1);
    if (f < n) {
      publish(sh.ctl.stop, 1);
      return;
    }
    op = op_end;
  }
}
}  // namespace blz
