// LZ4 walk kernel (K4): parse LZ4 blocks into compacted records, each row
// split into blocks of kB stream positions resolved in parallel.
//
// Replaces cblosc_tpu/tpu/codec_lz4.py:_walk_batch (a batched
// lax.while_loop that parses up to 8 steps per 512-byte window read; the
// plain version is gpu/codec_lz4._walk_plain). Every check is the JAX
// walk's; bytes at or past min(csize, W) read as 0. A sequence whose token
// sits at p ("node p"):
//   literal  litlen = token >> 4, or 15 + 255 * R + lastb over the R bytes
//            of 255 from p + 1 (lastb the byte after them); ipl = p + 1 or
//            p + R + 2; ip2 = ipl + litlen. err if an 8-byte step of the
//            run fails (R >= 8: p + 8 >= cs for R < 16, else
//            p + 8 * (R >> 3) + 1 >= cs), ip2 > cs or op + litlen > out_len;
//            final (fin) when ip2 >= cs; a zero-literal token makes no record
//   match    at q = ip2: offset = q[0] | q[1] << 8; mlen = 4 + token & 15,
//            or 19 + 255 * R + lastb over the 255-run at q + 2; the next
//            token at q + 2 or q + R + 3. err if a run step fails (q + 8 or
//            q + 8 * (R >> 3) + 2 >= cs), the offset is 0 or beyond op,
//            op + mlen > out_len, or the next token lies past cs (a stream
//            ending on a match errs at the token after it)
//   budget   err when a record would be the (E+1)-th
//   ok       = !err && op == out_len at fin
// Records are compacted, valid first: (kind 0, ipl, op, litlen) per
// literal run, (kind 1, offset, op, mlen) per match, then kind -1 and
// zeros up to E; dist is the first match's offset, uni says all share it.
//
// What bounds it on an H100: latency. The bytes moved (the stream, 16 B a
// record, the flags) take microseconds at 3.35 TB/s, but a row is one chain
// of dependent sequences (30,872 records on the densest 128 KB row of numcodecs'
// default chunk, lz4 clevel 5). A sequence's extent depends only on where
// its token sits, and the walk's state between sequences is (position,
// op), op being a prefix sum; so the chain is a list-ranking problem that
// the whole card shares, one CTA per (row, block of kB positions):
//   1. the CTA stages the block and kA bytes past it, takes every
//      position's 255-run length from a reverse scan (a run past the staged
//      bytes from one forward scan of the CTA), evaluates the sequence a
//      token would start at every position, and pointer-jumps in shared
//      memory (Jacobi rounds, one 64-bit state a node) to where each
//      position's chain leaves the block or ends, with the records, output
//      bytes, the largest offset excess over op and whether all offsets
//      agree on the way; the states after three and five rounds (8 and 32
//      sequences ahead) are kept as checkpoints;
//   2. the block that knows its entry (block 0: position 0) reads its state
//      there and hands the next block its entry, record base, op and
//      dist/uni through two 64-bit words in global memory that carry the
//      launch's epoch (a decoupled look-back: the grid is block-major, so a
//      block waits only on a lower block index, dispatched before it); it
//      marks the blocks a long literal skips, or every later block once the
//      row ends in it. A dense 128 KB row is 24 such hops;
//   3. each entered block re-walks its chain in parallel: one thread follows
//      the 32-sequence checkpoints, a thread each expands one into four
//      8-sequence segments, each segment's record and op bases come from
//      the states, and the segments walk, applying the op checks and the
//      budget and writing the records; the first failure wins by a shared
//      minimum.
// The block where the row ends writes dist, uni, ok and the -1 tail up to
// the records' bound 2 * floor((lim - 1) / 3) + 2 (a sequence advances at
// least three positions and makes at most two records); every CTA of a row
// writes a share of the tail beyond it, 16 bytes a store, while it would
// otherwise wait, so the tail of a large budget is spread over the card. A
// row that fits one block is first walked kSerial sequences by warp 0
// alone (runs taken 32 bytes a ballot), which ends the short rows of the
// speed clevels without the tables.

#include <climits>
#include <cstddef>
#include <cstdint>
#include <cuda/atomic>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 384;
// stream positions (nodes) per CTA: 4096 + 64, so that rows of the slot
// width n + 64 (n a multiple of 4096) take no block past n
constexpr int kB = 4160;
constexpr int kA = 512;                // look-ahead bytes staged past them
constexpr int kS = kB + kA;            // staged bytes
constexpr int kNpt = (kB + kThreads - 1) / kThreads;  // nodes per thread
constexpr int kCap = kNpt * kThreads;  // node slots
constexpr int kChunk = (kS + kThreads - 1) / kThreads;  // run-scan bytes a thread
constexpr int kJumps = 5;              // checkpoints 2^5 sequences apart,
constexpr int kFine = 3;               // then 2^3 apart
constexpr int kMaxCk = kB / 3 / 32 + 4;
constexpr int kLanes = 4 * kMaxCk;     // segments of at most 8 sequences
constexpr int kSerial = 8;             // sequences a one-block row walks first
constexpr int kEarly = 256;            // block 0's bytes staged with its csize
constexpr int kSat = (1 << 21) - 1;    // op sums saturate here (> out_len)

// node state: P (13 bits: the node reached, block-relative), records (13),
// op (21, saturating), moff (16: the largest offset - op before its match,
// relative to the op before the node, clamped to [0, 65535]), uni (1: all
// offsets on the way equal the node's own)
__device__ __forceinline__ uint64_t pack(unsigned P, unsigned n, unsigned o,
                                         unsigned m, unsigned u) {
  return (uint64_t)P | ((uint64_t)n << 13) | ((uint64_t)o << 26) |
         ((uint64_t)m << 47) | ((uint64_t)u << 63);
}
__device__ __forceinline__ unsigned sP(uint64_t s) { return (unsigned)(s & 8191); }
__device__ __forceinline__ unsigned sN(uint64_t s) { return (unsigned)((s >> 13) & 8191); }
__device__ __forceinline__ unsigned sO(uint64_t s) { return (unsigned)((s >> 26) & kSat); }
__device__ __forceinline__ unsigned sM(uint64_t s) { return (unsigned)((s >> 47) & 65535); }
__device__ __forceinline__ unsigned sU(uint64_t s) { return (unsigned)(s >> 63); }

enum { kCont = 0, kLitErr = 1, kFin = 2, kMatchErr = 3 };  // node kinds
enum { kGo = 0, kErr = 1, kDone = 2 };                     // step outcomes

// The sequence a token at p would start, from its position alone.
struct Seq {
  int kind, litlen, ipl, offv, mlen;
  long long nxt;        // ip2 for kLitErr / kFin, the next token otherwise
};

// A row's bytes: the staged span [s, s + nst) from shared memory (run
// lengths from lr, which run_warp does not read), the rest from global
// memory; 0 at or past lim.
struct View {
  const uint8_t* __restrict__ row;
  const uint8_t* sb;
  const uint16_t* lr;
  long long s;
  int nst, lim, cs, tailrun;   // tailrun: 255 bytes from s + nst on

  __device__ __forceinline__ int rd(long long x) const {
    const long long i = x - s;
    if (i >= 0 && i < nst) return sb[i];
    if (x >= lim || x < 0) return 0;
    return __ldg(row + x);
  }
  // bytes of 255 from x on
  __device__ int run(long long x) const {
    const long long i = x - s;
    if (i >= 0 && i < nst) {
      const int r = lr[i];
      return i + r == nst ? r + tailrun : r;
    }
    if (x >= lim) return 0;
    const long long e = s + nst;
    if (x >= e && x < e + tailrun) return (int)(e + tailrun - x);
    int r = 0;
    while (x + r < lim && __ldg(row + x + r) == 255) ++r;
    return r;
  }
  // the same, taken by a whole warp 32 bytes at a time (every lane gets it)
  __device__ int run_warp(long long x) const {
    const int lane = threadIdx.x & 31;
    for (int r = 0;; r += 32) {
      const long long y = x + r + lane;
      const unsigned m = __ballot_sync(0xffffffffu, rd(y) != 255);
      if (m) return r + __ffs(m) - 1;
    }
  }
};

// kWarp: called by a whole warp alike, runs taken by run_warp
template <bool kWarp = false>
__device__ Seq eval(const View& v, long long p) {
  Seq q;
  const int tok = v.rd(p);
  const int L = tok >> 4, ML = tok & 15;
  long long ipl, litlen;
  bool xerr = false;
  if (L == 15) {
    const int R = kWarp ? v.run_warp(p + 1) : v.run(p + 1);
    litlen = 15 + 255LL * R + v.rd(p + 1 + R);
    ipl = p + 2 + R;
    const int m = R >> 3;
    if (m >= 1) xerr = (m == 1 ? p + 8 : p + 8LL * m + 1) >= v.cs;
  } else {
    litlen = L;
    ipl = p + 1;
  }
  const long long ip2 = ipl + litlen;
  q.litlen = (int)litlen;
  q.ipl = (int)ipl;
  q.offv = 0;
  q.mlen = 0;
  q.nxt = ip2;
  if (xerr || ip2 > v.cs) {
    q.kind = kLitErr;
    return q;
  }
  if (ip2 >= v.cs) {
    q.kind = kFin;
    return q;
  }
  const int offv = v.rd(ip2) | (v.rd(ip2 + 1) << 8);
  long long mlen, ip3;
  bool merr = false;
  if (ML == 15) {
    const int R = kWarp ? v.run_warp(ip2 + 2) : v.run(ip2 + 2);
    mlen = 19 + 255LL * R + v.rd(ip2 + 2 + R);
    ip3 = ip2 + 3 + R;
    const int m = R >> 3;
    if (m >= 1) merr = (m == 1 ? ip2 + 8 : ip2 + 8LL * m + 2) >= v.cs;
  } else {
    mlen = 4 + ML;
    ip3 = ip2 + 2;
  }
  q.offv = offv;
  q.mlen = (int)mlen;
  q.nxt = ip3;
  q.kind = (merr || offv == 0 || ip3 > v.cs) ? kMatchErr : kCont;
  return q;
}

struct Out {
  int32_t *kind, *arg, *dst, *len;
  long long rb;
  int E, out_len;
  __device__ __forceinline__ void put(long long c, int k, int a, long long d,
                                      int l) const {
    kind[rb + c] = k;
    arg[rb + c] = a;
    dst[rb + c] = (int)d;
    len[rb + c] = l;
  }
  bool vec;        // 16-byte stores: E and the columns' bases aligned
  __device__ void put_tail(long long i) const {
    kind[rb + i] = -1;
    arg[rb + i] = 0;
    dst[rb + i] = 0;
    len[rb + i] = 0;
  }
  // kind -1 and zeros over [lo, hi), by threads t0, t0 + nt, ... (the
  // whole CTA by default), 16 bytes a store where the columns allow it
  __device__ void tail(long long lo, long long hi, int t0 = threadIdx.x,
                       int nt = kThreads) const {
    long long a = lo, b = lo;
    if (vec && lo < hi) {
      a = min(hi, (lo + 3) & ~3LL);
      b = max(a, hi & ~3LL);
      const int4 m1 = make_int4(-1, -1, -1, -1), z = make_int4(0, 0, 0, 0);
      for (long long q = (a >> 2) + t0; q < (b >> 2); q += nt) {
        reinterpret_cast<int4*>(kind + rb)[q] = m1;
        reinterpret_cast<int4*>(arg + rb)[q] = z;
        reinterpret_cast<int4*>(dst + rb)[q] = z;
        reinterpret_cast<int4*>(len + rb)[q] = z;
      }
    } else {
      a = b = hi;
    }
    for (long long i = lo + t0; i < a; i += nt) put_tail(i);
    for (long long i = b + t0; i < hi; i += nt) put_tail(i);
  }
};

// One sequence of the chain at p, with c records and op o before it: its
// checks, the records it writes, the state after it. moff/midx: the offset
// and index of the match it wrote (moff 0: none).
// kWarp: a whole warp takes the step alike and lane 0 writes.
template <bool kWarp = false>
__device__ int step(const View& v, const Out& out, long long& p,
                    long long& c, long long& o, int& moff, long long& midx) {
  const Seq q = eval<kWarp>(v, p);
  const bool writer = !kWarp || (threadIdx.x & 31) == 0;
  moff = 0;
  if (q.kind == kLitErr) return kErr;
  if (o + q.litlen > out.out_len || (q.litlen > 0 && c >= out.E)) return kErr;
  if (q.litlen > 0) {
    if (writer) out.put(c, 0, q.ipl, o, q.litlen);
    ++c;
  }
  o += q.litlen;
  if (q.kind == kFin) return kDone;
  if (q.kind == kMatchErr) return kErr;
  if (q.offv > o || o + q.mlen > out.out_len || c >= out.E) return kErr;
  if (writer) out.put(c, 1, q.offv, o, q.mlen);
  moff = q.offv;
  midx = c++;
  o += q.mlen;
  p = q.nxt;
  return kGo;
}

// A block's entry: two 64-bit words, each stored and loaded atomically and
// each tagged with the launch's epoch, so a reader that sees the epoch in
// both holds this launch's entry, with no fence between them:
//   a = x | records << 24 | state << 48 (1 entered, 2 not) | epoch << 50
//   b = op | dist << 21 | uni << 37 | epoch << 38
constexpr unsigned kEpochs = 1u << 13;
using Word = unsigned long long;
__device__ __forceinline__ Word load_word(Word* w) {
  return cuda::atomic_ref<Word, cuda::thread_scope_device>(*w).load(
      cuda::memory_order_relaxed);
}
__device__ __forceinline__ void store_word(Word* w, Word v) {
  cuda::atomic_ref<Word, cuda::thread_scope_device>(*w).store(
      v, cuda::memory_order_relaxed);
}
__device__ __forceinline__ void post(Word* slot, long long x, long long cnt,
                                     long long op, int dist, int uni,
                                     unsigned state, unsigned epoch) {
  store_word(slot, (Word)x | (Word)cnt << 24 | (Word)state << 48 |
                       (Word)epoch << 50);
  if (state == 1)
    store_word(slot + 1, (Word)op | (Word)dist << 21 | (Word)uni << 37 |
                             (Word)epoch << 38);
}

struct Shared {
  long long e, cnt0, op0;       // the block's entry
  int dist0, uni0, alive, term; // dist/uni before it; entered; the row ends here
  long long f;                  // the entry's final node
  int m;                        // checkpoints
  int tailrun, sat;
  int ck[kMaxCk];               // checkpoints 32 sequences apart
  int fine[kLanes];             // segment starts, 8 sequences apart
  int segn[kLanes + 1], sego[kLanes + 1];  // their records and op bases
  long long fail, mis, first;   // first failing count, first odd match, first match
  long long fend;               // records after the final node (LLONG_MAX: row goes on)
  long long fop;                // op after it
  int ffin, carry[kThreads / 32];
};

// One work item: block j of row `row`.
__device__ __forceinline__ void walk_block(
    const uint8_t* __restrict__ slots, int N, int W,
    const int32_t* __restrict__ csizes, int out_len, int E, int nblk,
    int32_t* __restrict__ kind, int32_t* __restrict__ arg,
    int32_t* __restrict__ dst, int32_t* __restrict__ len,
    int32_t* __restrict__ dist_out, uint8_t* __restrict__ uni_out,
    uint8_t* __restrict__ ok_out, Word* __restrict__ pay, unsigned epoch,
    int row, int j, uint8_t* smem, Shared& sh) {
  uint64_t* st = reinterpret_cast<uint64_t*>(smem);   // node states
  uint16_t* offt = reinterpret_cast<uint16_t*>(st + kCap);  // offsets
  uint16_t* j5 = offt + kCap;                         // 32-sequence jumps
  uint16_t* j3 = j5 + kCap;                           // 8-sequence jumps
  uint16_t* lr = j3 + kCap;                           // kS run lengths
  uint8_t* sb = reinterpret_cast<uint8_t*>(lr + kS);  // kS staged bytes
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const uint8_t* rowp = slots + (long long)row * W;
  if (j == 0 && warp == 0)          // warp 0, before the csize is known
    for (int i = lane; i < min(kEarly, W); i += 32) sb[i] = __ldg(rowp + i);
  const int cs = csizes[row];
  const int lim = cs <= 0 ? 0 : (cs < W ? cs : W);
  const long long s = (long long)j * kB;
  const Out out{kind, arg, dst, len, (long long)row * E, E, out_len,
                E % 4 == 0 && (((uintptr_t)kind | (uintptr_t)arg |
                                (uintptr_t)dst | (uintptr_t)len) & 15) == 0};
  const long long T0 = lim > 0 ? min((long long)E, 2LL * ((lim - 1) / 3) + 2)
                               : 0;
  // this CTA's share of the tail no record can reach, written where the
  // CTA would otherwise wait
  const long long per = (E - T0 + nblk - 1) / nblk;
  const long long share0 = T0 + per * j, share1 = min((long long)E, share0 + per);
  if (j > 0 && s >= lim) {           // no stream bytes in this block
    out.tail(share0, share1);
    return;
  }
  const long long base = (long long)row * nblk;
  const int nlive = lim > 0 ? (lim + kB - 1) / kB : 1;
  if (cs <= 0) {                      // j == 0: the walk never starts
    out.tail(share0, share1);
    if (tid == 0) {
      dist_out[row] = 0;
      uni_out[row] = 1;
      ok_out[row] = 0;
    }
    return;
  }

  // ---- stage [s, s + nst) ---------------------------------------------------
  const int nst = (int)min((long long)kS, lim - s);
  const int nn = (int)min((long long)kB, lim - s);    // nodes [s, s + nn)
  for (int i = tid + (j == 0 ? kEarly : 0); i < nst; i += kThreads)
    sb[i] = __ldg(rowp + s + i);
  if (tid == 0) {
    sh.e = 0;
    sh.cnt0 = 0;
    sh.op0 = 0;
    sh.dist0 = 0;
    sh.uni0 = 1;
    sh.term = 0;
  }

  // ---- a row that fits one block: warp 0 walks kSerial sequences first,
  //      from the bytes it staged itself (the rest through the cache); the
  //      other warps stage and write the tail share meanwhile -----------------
  bool share_done = false;
  if (j == 0 && lim <= kB) {
    if (warp == 0) {
      __syncwarp();
      const View vg{rowp, sb, nullptr, s, min(kEarly, nst), lim, cs, 0};
      long long p = 0, c = 0, o = 0, midx;
      int dist = 0, uni = 1, mo, r = kGo;
      for (int k = 0; k < kSerial && r == kGo; ++k) {
        r = step<true>(vg, out, p, c, o, mo, midx);
        if (mo) {
          if (!dist) dist = mo;
          uni &= mo == dist;
        }
      }
      if (lane == 0) {
        sh.term = r != kGo;
        if (r != kGo) {
          dist_out[row] = dist;
          uni_out[row] = uni;
          ok_out[row] = r == kDone && o == out_len;
        }
        sh.e = p;
        sh.cnt0 = c;
        sh.op0 = o;
        sh.dist0 = dist;
        sh.uni0 = uni;
      }
    } else {
      out.tail(share0, share1, tid - 32, kThreads - 32);
    }
    share_done = true;
  }
  __syncthreads();
  if (sh.term) {
    out.tail(sh.cnt0, T0);
    return;
  }

  // ---- run lengths of 255 bytes: a reverse scan over the staged bytes ----
  {
    const int lo = tid * kChunk, hi = min(lo + kChunk, nst);
    int first = INT_MAX;
    for (int i = hi - 1; i >= lo; --i)
      if (sb[i] != 255) first = i;
    int incl = first;                 // suffix minimum over the warp
    for (int d = 1; d < 32; d <<= 1) {
      const int o = __shfl_down_sync(0xffffffffu, incl, d);
      if (lane + d < 32) incl = min(incl, o);
    }
    if (lane == 0) sh.carry[warp] = incl;
    __syncthreads();
    int nz = __shfl_down_sync(0xffffffffu, incl, 1);
    if (lane == 31) nz = INT_MAX;
    for (int w = warp + 1; w < kThreads / 32; ++w) nz = min(nz, sh.carry[w]);
    if (nz == INT_MAX) nz = nst;
    for (int i = hi - 1; i >= lo; --i) {
      if (sb[i] != 255) nz = i;
      lr[i] = (uint16_t)(nz - i);
    }
  }
  // a run that reaches the end of the staged bytes: one forward scan
  if (tid == 0) sh.tailrun = 0;
  if (nst == kS && s + kS < lim && sb[kS - 1] == 255) {
    const long long e0 = s + kS;
    if (tid == 0) sh.tailrun = INT_MAX;
    __syncthreads();
    for (long long b0 = e0;; b0 += 16LL * kThreads) {
      bool hit = false;
      for (int k = 0; k < 16; ++k) {
        const long long x = b0 + 16 * tid + k;
        if (x >= lim || __ldg(rowp + x) != 255) {
          atomicMin(&sh.tailrun, (int)(x - e0));
          hit = true;
          break;
        }
      }
      if (__syncthreads_or(hit)) break;
    }
  }
  __syncthreads();
  const View v{rowp, sb, lr, s, nst, lim, cs, sh.tailrun};

  // ---- evaluate every node, initial states --------------------------------
  const long long node_end = s + nn;
  for (int k = 0; k < kNpt; ++k) {
    const int x = tid + k * kThreads;
    if (x >= nn) break;
    const Seq q = eval(v, s + x);
    offt[x] = (uint16_t)q.offv;
    if (q.kind != kCont || q.nxt >= node_end) {
      st[x] = pack(x, 0, 0, 0, 1);    // final: the chain leaves or ends here
    } else {
      const long long ol = (long long)q.litlen + q.mlen;
      st[x] = pack((unsigned)(q.nxt - s), (q.litlen > 0) + 1,
                   (unsigned)min(ol, (long long)kSat),
                   (unsigned)max(0, q.offv - q.litlen), 1);
    }
  }
  __syncthreads();

  // ---- pointer jumping (Jacobi rounds) -------------------------------------
  // each thread keeps its nodes' states in registers; a node whose target
  // is final is done
  uint64_t cur[kNpt];
  unsigned done = 0;
#pragma unroll
  for (int k = 0; k < kNpt; ++k) {
    const int x = tid + k * kThreads;
    cur[k] = x < nn ? st[x] : 0;
    if (x >= nn || sP(cur[k]) == (unsigned)x) done |= 1u << k;
  }
  int rounds = 0;
  while (true) {
    bool any = false;
#pragma unroll
    for (int k = 0; k < kNpt; ++k) {
      if (done >> k & 1) continue;
      const int x = tid + k * kThreads;
      const uint64_t a = cur[k];
      const unsigned y = sP(a);
      const uint64_t b = st[y];
      if (sP(b) == y) {
        done |= 1u << k;
        continue;
      }
      const unsigned o = min(sO(a) + sO(b), (unsigned)kSat);
      const int mb = (int)sM(b) - (int)sO(a);
      const unsigned m = max(sM(a), (unsigned)max(mb, 0));
      const unsigned u = sU(a) & sU(b) & (offt[x] == offt[y]);
      cur[k] = pack(sP(b), sN(a) + sN(b), o, m, u);
      any = true;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kNpt; ++k) {
      const int x = tid + k * kThreads;
      if (x < nn) {
        st[x] = cur[k];
        if (rounds == kFine - 1) j3[x] = (uint16_t)sP(cur[k]);
        if (rounds == kJumps - 1) j5[x] = (uint16_t)sP(cur[k]);
      }
    }
    ++rounds;
    if (!__syncthreads_or(any)) break;
  }
  if (rounds < kJumps) {
    for (int x = tid; x < nn; x += kThreads) {
      if (rounds < kFine) j3[x] = (uint16_t)sP(st[x]);
      j5[x] = (uint16_t)sP(st[x]);
    }
    __syncthreads();
  }

  // ---- the entry: wait for it, publish the next one -----------------------
  if (!share_done && warp > 0) out.tail(share0, share1, tid - 32, kThreads - 32);
  if (tid == 0) {
    int alive = 1;
    if (j > 0) {
      Word* slot = pay + 2 * (base + j);
      Word a;
      while (((a = load_word(slot)) >> 50) != epoch) {
      }
      alive = (a >> 48 & 3) == 1;
      if (alive) {
        Word b;
        while (((b = load_word(slot + 1)) >> 38) != epoch) {
        }
        sh.e = (long long)(a & 0xffffff);
        sh.cnt0 = (long long)(a >> 24 & 0xffffff);
        sh.op0 = (long long)(b & kSat);
        sh.dist0 = (int)(b >> 21 & 0xffff);
        sh.uni0 = (int)(b >> 37 & 1);
      }
    }
    sh.alive = alive;
    if (alive) {
      const long long e = sh.e, cnt0 = sh.cnt0, op0 = sh.op0;
      uint64_t a = pack(0, 0, 0, 0, 1);
      long long f = e;
      if (e < node_end) {
        a = st[e - s];
        f = s + sP(a);
      }
      sh.f = f;
      const Seq q = eval(v, f);
      const long long opf = op0 + sO(a), cntf = cnt0 + sN(a);
      bool ends = (long long)sM(a) > op0 || opf > out_len || cntf > E ||
                  q.kind != kCont;
      long long x = 0, cnt1 = 0, op1 = 0;
      if (!ends) {
        const int nl = q.litlen > 0;
        const long long o2 = opf + q.litlen;
        if (o2 > out_len || (nl && cntf >= E) || q.offv > o2 ||
            o2 + q.mlen > out_len || cntf + nl >= E) {
          ends = true;
        } else {
          x = q.nxt;
          cnt1 = cntf + nl + 1;
          op1 = o2 + q.mlen;
          ends = x >= lim;
        }
      }
      sh.term = ends;
      int jn = nlive;
      if (!ends) {                     // x lies in [s + kB, lim)
        jn = (int)(x / kB);
        const int oe = e < node_end ? offt[e - s] : 0;
        const int dist1 = sh.dist0 ? sh.dist0 : oe;
        const int uni1 = sh.uni0 && sU(a) && (f == e || q.offv == oe) &&
                         (sh.dist0 == 0 || oe == sh.dist0);
        post(pay + 2 * (base + jn), x, cnt1, op1, dist1, uni1, 1, epoch);
      }
      for (int k = j + 1; k < nlive; ++k)
        if (k != jn) {
          if (k > jn && !ends) break;
          post(pay + 2 * (base + k), 0, 0, 0, 0, 0, 2, epoch);
        }
    }
  }
  __syncthreads();
  if (!sh.alive) return;

  // ---- emission: checkpoints, segment bases, records ----------------------
  const uint64_t ae = sh.e < node_end ? st[sh.e - s] : pack(0, 0, 0, 0, 1);
  if (tid == 0) {
    int c = (int)sh.e, m = 0;
    sh.ck[m++] = c;
    if (c < node_end) {
      while (c != sh.f && m < kMaxCk) {
        c = (int)s + j5[c - s];
        sh.ck[m++] = c;
      }
    }
    sh.m = m;
    sh.sat = sO(ae) >= (unsigned)kSat;
    sh.fail = LLONG_MAX;
    sh.mis = LLONG_MAX;
    sh.first = LLONG_MAX;
    sh.fend = LLONG_MAX;
  }
  __syncthreads();
  const int m = sh.m, nf = 4 * (m - 1);   // segments; lane nf: the final node
  if (tid < m - 1) {               // four 8-sequence starts per checkpoint
    int c = sh.ck[tid];
    const int end = sh.ck[tid + 1];
    for (int k = 0; k < 4; ++k) {
      sh.fine[4 * tid + k] = c;
      if (c != end) c = (int)s + j3[c - s];
    }
  }
  __syncthreads();
  // segment l: [fine[l], its next start); the records and op before it
  // from the states (exact: both sums count the nodes up to the final
  // node), or, when the entry's op sum saturated, by walking them
  int p0 = 0, p1 = 0;
  if (tid < nf) {
    p0 = sh.fine[tid];
    p1 = (tid & 3) == 3 ? sh.ck[(tid >> 2) + 1] : sh.fine[tid + 1];
  } else if (tid == nf) {
    p0 = (int)sh.f;
    p1 = -1;
  }
  if (tid <= nf) {
    if (!sh.sat) {
      const uint64_t ax = p0 < node_end && tid < nf ? st[p0 - s] : 0;
      sh.segn[tid] = (int)(sh.cnt0 + sN(ae) - (tid < nf ? sN(ax) : 0));
      sh.sego[tid] = (int)(sh.op0 + sO(ae) - (tid < nf ? sO(ax) : 0));
    } else if (tid < nf) {
      long long p = p0, nr = 0, o = 0;
      while (p != p1) {
        const Seq q = eval(v, p);
        nr += (q.litlen > 0) + 1;
        o = min(o + q.litlen + q.mlen, (long long)kSat);
        p = q.nxt;
      }
      sh.segn[tid] = (int)nr;
      sh.sego[tid] = (int)o;
    }
  }
  __syncthreads();
  if (sh.sat) {
    if (tid == 0) {
      long long c = sh.cnt0, o = sh.op0;
      for (int i = 0; i <= nf; ++i) {
        const long long n1 = sh.segn[i], o1 = sh.sego[i];
        sh.segn[i] = (int)c;
        sh.sego[i] = (int)min(o, (long long)kSat);
        c += n1;
        o = min(o + o1, (long long)kSat);
      }
    }
    __syncthreads();
  }
  const int oe = sh.e < node_end ? offt[sh.e - s] : 0;
  const int D = sh.dist0 ? sh.dist0 : oe;
  if (tid <= nf) {
    long long p = p0, c = sh.segn[tid], o = sh.sego[tid], midx = 0;
    long long mis = LLONG_MAX, first = LLONG_MAX;
    int r = kGo, mo;
    while (r == kGo && p != p1) {
      r = step(v, out, p, c, o, mo, midx);
      if (mo) {
        first = min(first, midx);
        if (mo != D) mis = min(mis, midx);
      }
      if (tid == nf) {               // the final node, and a virtual token
        if (r == kGo && p >= lim) {  // past the bytes, or the row goes on
          r = step(v, out, p, c, o, mo, midx);
        }
        break;
      }
    }
    if (first != LLONG_MAX) atomicMin((unsigned long long*)&sh.first, first);
    if (mis != LLONG_MAX) atomicMin((unsigned long long*)&sh.mis, mis);
    if (tid < nf) {
      if (r == kErr) atomicMin((unsigned long long*)&sh.fail, c);
    } else if (r != kGo) {
      sh.fend = c;
      sh.fop = o;
      sh.ffin = r == kDone;
    }
  }
  __syncthreads();
  if (!sh.term) return;
  const long long cnt = sh.fail != LLONG_MAX ? sh.fail : sh.fend;
  out.tail(cnt, T0);
  if (tid == 0) {
    const bool fin = sh.fail == LLONG_MAX && sh.ffin;
    dist_out[row] = sh.dist0 ? sh.dist0 : (sh.first < cnt ? D : 0);
    uni_out[row] = sh.uni0 && sh.mis >= cnt;
    ok_out[row] = fin && sh.fop == out_len;
  }
}

// One CTA per work item, block-major: CTA t is block t / N of row t % N,
// so every row's block 0 comes first. A block waits only on lower blocks
// of its row, which have lower indices and so were dispatched before it.
__global__ void __launch_bounds__(kThreads, 3)
lz4_walk_kernel(const uint8_t* __restrict__ slots, int N, int W,
                const int32_t* __restrict__ csizes, int out_len, int E,
                int nblk, int32_t* __restrict__ kind, int32_t* __restrict__ arg,
                int32_t* __restrict__ dst, int32_t* __restrict__ len,
                int32_t* __restrict__ dist_out, uint8_t* __restrict__ uni_out,
                uint8_t* __restrict__ ok_out, Word* __restrict__ pay,
                unsigned epoch) {
  extern __shared__ __align__(16) uint8_t smem[];
  __shared__ Shared sh;
  walk_block(slots, N, W, csizes, out_len, E, nblk, kind, arg, dst, len,
             dist_out, uni_out, ok_out, pay, epoch, (int)(blockIdx.x % N),
             (int)(blockIdx.x / N), smem, sh);
}

}  // namespace

// scratch: one 16-byte entry (two words) per block of each row (nblk of
// N rows), needed when a row spans more than one block; epoch (1 .. 8191)
// tags this launch's entries.
extern "C" int lz4_walk_launch(const void* slots, int N, int W,
                               const void* csizes, int out_len, int E,
                               void* kind, void* arg, void* dst, void* len,
                               void* dist, void* uni, void* ok, void* scratch,
                               long long scratch_bytes, unsigned epoch,
                               void* stream) {
  if (N <= 0) return (int)cudaGetLastError();
  const int nblk = W > 0 ? (W + kB - 1) / kB : 1;
  const long long items = (long long)N * nblk;
  if (out_len < 0 || out_len >= kSat || W >= (1 << 23) || E >= (1 << 24) ||
      items > INT_MAX / 2 ||
      (nblk > 1 && (epoch == 0 || epoch >= kEpochs ||
                    scratch_bytes < 16 * items)))
    return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)kCap * (8 + 2 + 2 + 2) + (size_t)kS * 3;
  static bool attr = false;
  if (!attr) {
    const cudaError_t e = cudaFuncSetAttribute(
        lz4_walk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
    attr = true;
  }
  lz4_walk_kernel<<<(int)items, kThreads, smem, (cudaStream_t)stream>>>(
      (const uint8_t*)slots, N, W, (const int32_t*)csizes, out_len, E, nblk,
      (int32_t*)kind, (int32_t*)arg, (int32_t*)dst, (int32_t*)len,
      (int32_t*)dist, (uint8_t*)uni, (uint8_t*)ok, (Word*)scratch, epoch);
  return (int)cudaGetLastError();
}
