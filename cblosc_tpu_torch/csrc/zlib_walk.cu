// zlib walk kernel (K6): parse zlib (DEFLATE) streams into a literal tape
// and compacted placement records, one CTA per row.
//
// Replaces cblosc_tpu/tpu/codec_zlib.py:_fsm_walk (a batched
// lax.while_loop that fetches a 16-byte window per row and iteration and
// decodes up to 4 symbols from it) and its _events_to_records (one sort
// that compacts the literal events into the tape). The decisions are
// _fsm_walk's, line for line, because which rows err decides the byte
// API's retry and its host fallback:
//   container  CM (low nibble of byte 0) must be 8, FDICT (byte 1 bit 5)
//              clear, csize >= 8; no FCHECK and no adler32 check
//   block      BTYPE 0 (stored) and 3 err; 1 takes the fixed tables; 2
//              reads HLIT, HDIST, HCLEN (not range-checked), the HCLEN
//              code-length-code lengths, then code-length symbols: an
//              invalid code, pos + repeat > HLIT + HDIST, or repeat 16
//              at pos 0 err. The distance table takes at most 30 lengths
//   symbols    a code resolves to the SHORTEST length b with first[b] <=
//              code < first[b] + cnt[b] (cnt[b] > 0), as _decode_sym's
//              unrolled compare does, so over-subscribed and incomplete
//              codes decode as in JAX; an invalid code, a length symbol
//              > 285, a distance beyond op, op + len > out_len, a literal
//              at op >= out_len, or a symbol whose bits end past csize*8
//              err
//   budget     a row errs when a valid event (a literal byte or a match)
//              would be the (E+1)-th. JAX counts loop slots, stalls
//              included, so every row it accepts fits here
//   ok         = !err && op == out_len after the final block's EOB
// Bytes at or past csize (or the row width) read as 0.
//
// Outputs: tape[:tlen] the row's literals in output order, zeros after;
// records compacted, valid first: (kind 0, tape offset, dst, len) per
// maximal literal run (runs continue across block boundaries), (kind 1,
// distance, dst, len) per match, then kind -1 and zeros up to E; dist is
// the largest match distance, uni says all matches share it.
//
// What bounds it on an H100: latency. DEFLATE is bit-serial within a
// stream: each symbol's position is known only after the previous one is
// decoded, so a row is one chain of dependent steps and the bytes moved
// (the stream, the tape, 16 bytes per record) take microseconds at
// 3.35 TB/s. The design keeps that chain short and moves all other work
// off it:
//   - one thread decodes (thread 0 of the CTA); its step is one shared-
//     memory lookup per Huffman code. The literal/length and distance
//     codes resolve through 1024-entry tables indexed by the next 10
//     stream bits, each entry (code length, symbol, extra-bit count,
//     base), so one lookup yields a whole length or distance symbol;
//     codes longer than 10 bits (entry 0) take the canonical compare for
//     lengths 11-15. The code-length code resolves through a full 7-bit
//     table. Every entry is filled by evaluating JAX's rule for its bit
//     pattern (the shortest length b whose range holds the code), so the
//     tables are exact on over-subscribed and incomplete codes by
//     construction;
//   - the row's stream is staged into a 16 KB ring in shared memory (two
//     8 KB halves, zero past min(csize, W)); the bit buffer refills 32
//     bits at a time, without a branch, from two ring words held in
//     registers, the next one loaded a refill ahead;
//   - the common symbols (a literal or a length whose code fits the
//     table, a distance whose code fits) take one test each; branches
//     cost the single decoding thread more than the arithmetic does;
//   - the decoder checks only what decides how it decodes (codes, symbol
//     ranges, the bits against csize) and appends one 32-bit event per
//     literal or match to a shared-memory buffer. The checks against the
//     row so far (op, out_len, the event budget, distance <= op), the
//     tape, the records with their maximal literal runs, dist and uni
//     are made by the CTA on each full buffer of 1024 events (flush):
//     per-event prefix sums of output and literals, the first failing
//     event by an atomic minimum, the records' places by a second prefix
//     sum. Events past a failure are dropped, so the outputs are the
//     walk's, which stops there;
//   - the decoder yields to the CTA (one __syncthreads pair) to rebuild
//     tables at a block header, to stage the next 8 KB half, to flush
//     the event buffer, and at the end; the 128 threads then split the
//     table fill (counts by shared atomics, the symbol order by
//     per-symbol counts, 1024 entries each evaluating up to 10 lengths),
//     the copy, the flush, and the kind -1 / zero tail of the record
//     columns and the tape (16-byte stores).
// One row per CTA of 128 threads, 40 KB of static shared memory.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;       // one row per CTA, thread 0 decodes
constexpr int kBits = 10;           // literal/length and distance lookup bits
constexpr int kClBits = 7;          // code-length code: every length fits
constexpr int kHalf = 8192;         // stream bytes staged per half ring
constexpr int kRingWords = 2 * kHalf / 4;
constexpr int kMargin = 32;         // stream bytes a decode step may read
constexpr int kEvBuf = 1024;        // buffered events (literals and matches)
constexpr int kPer = kEvBuf / kThreads;  // events a thread takes in a flush
constexpr uint32_t kMatch = 1u << 31;
constexpr int kLMax = 288 + 32;     // code lengths of one dynamic block

__constant__ int kLBase[29] = {3,  4,  5,  6,  7,  8,  9,  10, 11, 13,
                               15, 17, 19, 23, 27, 31, 35, 43, 51, 59,
                               67, 83, 99, 115, 131, 163, 195, 227, 258};
__constant__ int kLExtra[29] = {0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1, 1, 2, 2, 2,
                                2, 3, 3, 3, 3, 4, 4, 4, 4, 5, 5, 5, 5, 0};
__constant__ int kDBase[30] = {1,    2,    3,    4,     5,     7,    9,    13,
                               17,   25,   33,   49,    65,    97,   129,  193,
                               257,  385,  513,  769,   1025,  1537, 2049, 3073,
                               4097, 6145, 8193, 12289, 16385, 24577};
__constant__ int kDExtra[30] = {0, 0, 0, 0, 1, 1, 2, 2,  3,  3,  4,  4,  5,  5,  6,
                                6, 7, 7, 8, 8, 9, 9, 10, 10, 11, 11, 12, 12, 13, 13};
__constant__ int kClOrder[19] = {16, 17, 18, 0, 8,  7, 9,  6, 10, 5,
                                 11, 4,  12, 3, 13, 2, 14, 1, 15};

// what the decoder asks of the CTA when it yields
enum Yield { kRefill = 1, kBuildCl, kBuildDyn, kBuildFixed, kFlush, kDone };
// decoder modes
enum Mode { kHeader, kLens, kSymbols };

// canonical decode table of one alphabet: per code length b, the first
// code, the number of codes and their offset into the symbol list
struct Table {
  int first[16];
  int cnt[16];
  int offs[16];
};

struct Smem {
  uint32_t ring[kRingWords];        // stream bytes, word x>>2 at x>>2 mod size
  uint32_t lit[1 << kBits];         // entry: len | extra<<4 | sym<<8 | base<<17
  uint32_t dist[1 << kBits];
  uint32_t ev[kEvBuf];              // events: a literal byte, or kMatch |
                                    // distance << 9 | length
  int lbefore[kEvBuf], obefore[kEvBuf];  // per event: literals, output before
  int pa[kThreads], pb[kThreads], pc[kThreads];  // per-thread partials
  uint16_t cl[1 << kClBits];        // entry: len | sym<<3
  Table tl, td, tc;
  uint16_t lsym[288], dsym[32], csym[20];
  uint8_t L[kLMax];                 // literal/length then distance lengths
  uint8_t cll[20];                  // code-length-code lengths
  int cmd, nev, hlit, hdist, rbase, kerr, fm, derr;
  // the row so far: output bytes, literals (tape bytes), events, records,
  // literals at the last match (where the open literal run starts),
  // distances, and whether a check failed
  int op, lits, evs, recs, run0, dmax, dfirst, uni, err;
};
static_assert(sizeof(Smem) <= 48 * 1024, "static shared memory");

__device__ __forceinline__ uint32_t pack(int len, int sym, int extra,
                                         int base) {
  return (uint32_t)len | (uint32_t)extra << 4 | (uint32_t)sym << 8 |
         (uint32_t)base << 17;
}

// words [from, from + nbytes) / 4 of the row into the ring; bytes at or
// past lim read 0
__device__ void stage(uint32_t* ring, const uint8_t* __restrict__ s, int lim,
                      int from, int nbytes, int tid) {
  const bool al = ((uintptr_t)s & 3) == 0;
  for (int w = tid; w < nbytes / 4; w += kThreads) {
    const int x = from + 4 * w;
    uint32_t v = 0;
    if (al && x + 4 <= lim) {
      v = __ldg((const uint32_t*)(s + x));
    } else {
      for (int k = 0; k < 4; ++k)
        if (x + k < lim) v |= (uint32_t)__ldg(s + x + k) << (8 * k);
    }
    ring[(x >> 2) & (kRingWords - 1)] = v;
  }
}

// Canonical code (RFC 1951 3.2.2) of the lengths L[0..n): per-length
// counts, first codes and offsets, and the symbols in (length, symbol)
// order. Called by every thread of the CTA.
__device__ void build(Table& t, uint16_t* sym, const uint8_t* L, int n,
                      int tid) {
  if (tid < 16) t.cnt[tid] = 0;
  __syncthreads();
  for (int i = tid; i < n; i += kThreads)
    if (L[i]) atomicAdd(&t.cnt[L[i]], 1);
  __syncthreads();
  if (tid == 0) {
    int code = 0, off = 0;
    t.first[0] = 0;
    t.offs[0] = 0;
    for (int b = 1; b < 16; ++b) {
      t.first[b] = code;
      t.offs[b] = off;
      code = (code + t.cnt[b]) << 1;
      off += t.cnt[b];
    }
  }
  __syncthreads();
  for (int i = tid; i < n; i += kThreads) {
    const int l = L[i];
    if (!l) continue;
    int before = 0;
    for (int j = 0; j < i; ++j) before += L[j] == l;
    sym[t.offs[l] + before] = (uint16_t)i;
  }
  __syncthreads();
}

// The lookup table of K bits: entry e holds the shortest length b <= K
// whose code range holds the first b stream bits of e (JAX's rule), with
// its symbol; 0 when no length up to K does. alpha: 0 literal/length
// (extra bits and base of symbols 257..285), 1 distance, 2 code length.
template <int K>
__device__ void fill(void* tab, const Table& t, const uint16_t* sym, int alpha,
                     int tid) {
  int first[K + 1], cnt[K + 1], offs[K + 1];
#pragma unroll
  for (int b = 1; b <= K; ++b) {
    first[b] = t.first[b];
    cnt[b] = t.cnt[b];
    offs[b] = t.offs[b];
  }
  for (int e = tid; e < (1 << K); e += kThreads) {
    const int rev = (int)(__brev((unsigned)e) >> (32 - K));
    int len = 0, s = 0;
#pragma unroll
    for (int b = 1; b <= K; ++b) {
      const int c = rev >> (K - b);
      if (len == 0 && cnt[b] > 0 && c >= first[b] && c < first[b] + cnt[b]) {
        len = b;
        s = sym[offs[b] + c - first[b]];
      }
    }
    if (alpha == 2) {
      ((uint16_t*)tab)[e] = (uint16_t)(len | s << 3);
    } else {
      int extra = 0, base = 0;
      if (len && alpha == 0 && s >= 257 && s <= 285) {
        extra = kLExtra[s - 257];
        base = kLBase[s - 257];
      } else if (len && alpha == 1 && s < 30) {
        extra = kDExtra[s];
        base = kDBase[s];
      }
      ((uint32_t*)tab)[e] = len ? pack(len, s, extra, base) : 0u;
    }
  }
}

// a code longer than kBits: the canonical compare for lengths kBits+1..15
// on the first 15 stream bits (peek, LSB-first); len 0 when none holds it
__device__ int decode_long(const Table& t, const uint16_t* sym, unsigned peek,
                           int& len) {
  const int rev = (int)(__brev(peek) >> 17);
  for (int b = kBits + 1; b < 16; ++b) {
    const int c = rev >> (15 - b);
    const int f = t.first[b], n = t.cnt[b];
    if (n > 0 && c >= f && c < f + n) {
      len = b;
      return sym[t.offs[b] + c - f];
    }
  }
  len = 0;
  return 0;
}

// LSB-first bit reader over the staged ring: a 64-bit buffer refilled 32
// bits at a time (at least 32 valid bits after refill). The stream starts
// at byte 2 and refills take 4 bytes, so next is 2 mod 4: the 4 bytes at
// next are the upper half of ring word next/4 and the lower half of the
// one after, both held in registers, the second loaded one refill ahead.
struct Bits {
  const uint32_t* ring;
  unsigned long long buf;
  int nb;                           // valid bits in buf
  int next;                         // next stream byte to load
  int pos;                          // bits consumed
  uint32_t lo, hi;                  // ring words next/4 and next/4 + 1
  __device__ void load() {
    lo = ring[(next >> 2) & (kRingWords - 1)];
    hi = ring[((next >> 2) + 1) & (kRingWords - 1)];
  }
  __device__ __forceinline__ void refill() {
    const bool need = nb < 32;
    const unsigned long long v = __byte_perm(lo, hi, 0x5432);
    buf |= need ? v << nb : 0ull;
    nb += need ? 32 : 0;
    next += need ? 4 : 0;
    const uint32_t nh = ring[((next >> 2) + 1) & (kRingWords - 1)];
    lo = need ? hi : lo;
    hi = need ? nh : hi;
  }
  __device__ __forceinline__ unsigned peek(int off, int n) const {
    return (unsigned)((buf >> off) & ((1ull << n) - 1));
  }
  __device__ __forceinline__ void skip(int n) {
    buf >>= n;
    nb -= n;
    pos += n;
  }
};

// The buffered events (sm.ev[0..sm.nev)) against the row so far, by the
// CTA: each thread takes kPer consecutive events. Per event the output
// and the literals before it (prefix sums: per thread, then thread 0 over
// the threads), then the walk's checks in event order: a literal errs at
// op >= out_len, a match at distance > op or op + len > out_len, either
// when it would be the (E+1)-th event. Events before the first failure
// are written: literal bytes to the tape, a (kind 0) record per maximal
// literal run before a match, a (kind 1) record per match; then the
// row's totals move on. A failure sets sm.err.
__device__ void flush(Smem& sm, int out_len, int E, uint8_t* tp, int32_t* kind,
                      int32_t* arg, int32_t* dst, int32_t* len, int tid) {
  const int n = sm.nev, j0 = tid * kPer, j1 = min(j0 + kPer, n);
  // pass 1: output bytes and literals of the thread's events
  int o = 0, l = 0;
  for (int j = j0; j < j1; ++j) {
    const uint32_t v = sm.ev[j];
    o += v & kMatch ? (int)(v & 511) : 1;
    l += v & kMatch ? 0 : 1;
  }
  sm.pa[tid] = o;
  sm.pb[tid] = l;
  if (tid == 0) sm.kerr = n;
  __syncthreads();
  if (tid == 0) {
    int so = sm.op, sl = sm.lits;
    for (int t = 0; t < kThreads; ++t) {
      const int a = sm.pa[t], b = sm.pb[t];
      sm.pa[t] = so;
      sm.pb[t] = sl;
      so += a;
      sl += b;
    }
  }
  __syncthreads();
  // pass 2: the checks, per event, at its place in the row
  o = sm.pa[tid];
  l = sm.pb[tid];
  int bad = n;
  for (int j = j0; j < j1; ++j) {
    const uint32_t v = sm.ev[j];
    const int ev = sm.evs + j;
    sm.obefore[j] = o;
    sm.lbefore[j] = l;
    if (v & kMatch) {
      const int m = v & 511, d = (int)((v >> 9) & 0xFFFF);
      if ((d > o) | (o + m > out_len) | (ev >= E)) bad = min(bad, j);
      o += m;
    } else {
      if ((o >= out_len) | (ev >= E)) bad = min(bad, j);
      ++o;
      ++l;
    }
  }
  atomicMin(&sm.kerr, bad);
  __syncthreads();
  const int kerr = sm.kerr;
  // pass 3: records before the first failure: a match after literals adds
  // a run record; the literals at the thread's last match
  int r = 0, last = -1;
  for (int j = j0; j < min(j1, kerr); ++j) {
    if (sm.ev[j] & kMatch) {
      last = sm.lbefore[j];
      r += 1;
    }
  }
  sm.pc[tid] = r;
  sm.pa[tid] = last;
  if (tid == 0) sm.fm = kEvBuf;
  __syncthreads();
  if (tid == 0) {
    int sr = sm.recs, sw = sm.run0;
    for (int t = 0; t < kThreads; ++t) {
      const int c = sm.pc[t], w = sm.pa[t];
      sm.pc[t] = sr;                // records before, runs not yet counted
      sm.pa[t] = sw;                // literals at the last match before
      sr += c;
      if (w >= 0) sw = w;
    }
  }
  __syncthreads();
  // runs: a thread's match closes a run when literals came since the
  // match before it; count them with the matches (pass 3 above counted
  // matches only), so the record index is a second prefix sum
  int runs = 0, w = sm.pa[tid];
  for (int j = j0; j < min(j1, kerr); ++j) {
    if (sm.ev[j] & kMatch) {
      runs += sm.lbefore[j] > w;
      w = sm.lbefore[j];
    }
  }
  __syncthreads();
  sm.pb[tid] = runs;
  __syncthreads();
  if (tid == 0) {
    int s = 0;
    for (int t = 0; t < kThreads; ++t) {
      const int c = sm.pb[t];
      sm.pb[t] = s;
      s += c;
    }
  }
  __syncthreads();
  // pass 4: the tape, the records, the distances
  int k = sm.pc[tid] + sm.pb[tid], dm = 0, fm = kEvBuf;
  w = sm.pa[tid];
  for (int j = j0; j < min(j1, kerr); ++j) {
    const uint32_t v = sm.ev[j];
    const int ob = sm.obefore[j], lb = sm.lbefore[j];
    if (!(v & kMatch)) {
      tp[lb] = (uint8_t)v;
      continue;
    }
    if (lb > w) {
      kind[k] = 0;
      arg[k] = w;
      dst[k] = ob - (lb - w);
      len[k] = lb - w;
      ++k;
    }
    const int d = (int)((v >> 9) & 0xFFFF);
    kind[k] = 1;
    arg[k] = d;
    dst[k] = ob;
    len[k] = v & 511;
    ++k;
    w = lb;
    dm = max(dm, d);
    fm = min(fm, j);
  }
  atomicMax(&sm.dmax, dm);
  atomicMin(&sm.fm, fm);
  __syncthreads();
  const int fmi = sm.fm;
  const int df = sm.dfirst ? sm.dfirst
                 : fmi < kerr ? (int)((sm.ev[fmi] >> 9) & 0xFFFF)
                              : 0;
  bool same = true;
  for (int j = j0; j < min(j1, kerr); ++j) {
    const uint32_t v = sm.ev[j];
    same = same && (!(v & kMatch) || (int)((v >> 9) & 0xFFFF) == df);
  }
  if (!same) sm.uni = 0;
  // the thread that holds the last written event moves the row on
  if (kerr > 0 && j0 <= kerr - 1 && kerr - 1 < j1) {
    const int j = kerr - 1;
    const uint32_t v = sm.ev[j];
    const bool m = v & kMatch;
    sm.op = sm.obefore[j] + (m ? (int)(v & 511) : 1);
    sm.lits = sm.lbefore[j] + (m ? 0 : 1);
    sm.recs = k;
    if (w >= 0) sm.run0 = w;
  }
  __syncthreads();
  if (tid == 0) {
    sm.evs += kerr;
    sm.dfirst = df;
    if (kerr < n) sm.err = 1;
  }
}

__global__ void __launch_bounds__(kThreads)
zlib_walk_kernel(const uint8_t* __restrict__ slots, int N, int W,
                 const int32_t* __restrict__ csizes, int out_len, int E,
                 uint8_t* __restrict__ tape, int32_t* __restrict__ tlen_out,
                 int32_t* __restrict__ kind, int32_t* __restrict__ arg,
                 int32_t* __restrict__ dst, int32_t* __restrict__ len,
                 int32_t* __restrict__ dist_out, uint8_t* __restrict__ uni_out,
                 uint8_t* __restrict__ ok_out) {
  __shared__ __align__(16) Smem sm;
  const int tid = threadIdx.x;
  const long long row = blockIdx.x;
  const int cs = csizes[row];
  const int lim = cs < W ? cs : W;
  const uint8_t* s = slots + row * (long long)W;
  const long long rb = row * (long long)E;
  uint8_t* tp = tape + rb;

  stage(sm.ring, s, lim, 0, 2 * kHalf, tid);
  if (tid == 0) {
    sm.rbase = 0;
    sm.op = sm.lits = sm.evs = sm.recs = sm.run0 = 0;
    sm.dmax = sm.dfirst = sm.err = sm.derr = 0;
    sm.uni = 1;
  }
  __syncthreads();

  // decoder state: meaningful in thread 0 only. The decoder emits one
  // event per literal or match; every check that needs the output so far
  // (op, events, distance) is made on the buffered events by the CTA
  // (flush), which also writes the tape and the records.
  Bits br{sm.ring, 0ull, 0, 2, 16, 0u, 0u};
  const int bitlim = cs < (1 << 27) ? 8 * cs : 1 << 30;
  int nev = 0;                      // buffered events
  bool err = false, fixed = false;
  int mode = kHeader, final_blk = 0, lpos = 0, total = 0, prev = 0;
  int rbase = 0;                    // stream byte at the ring's start
  if (tid == 0) {
    br.load();
    const uint32_t w0 = sm.ring[0];
    err = (w0 & 15) != 8 || ((w0 >> 8) & 0x20) != 0 || cs < 8;
  }

  for (;;) {
    if (tid == 0) {
      int cmd = kDone;
      // a step reads at most kMargin bytes past br.next
      const int guard = rbase + 2 * kHalf - kMargin;
      while (!err) {
        if (br.next > guard) {
          cmd = kRefill;
          break;
        }
        if (mode == kHeader) {
          br.refill();
          const unsigned h = br.peek(0, 17);
          final_blk = h & 1;
          const int btype = (h >> 1) & 3;
          if (btype == 0 || btype == 3) {
            err = true;
            break;
          }
          if (btype == 1) {
            br.skip(3);
            mode = kSymbols;
            if (!fixed) {
              fixed = true;
              cmd = kBuildFixed;
              break;
            }
            continue;
          }
          const int hclen = ((h >> 13) & 15) + 4;
          sm.hlit = ((h >> 3) & 31) + 257;
          sm.hdist = ((h >> 8) & 31) + 1;
          total = sm.hlit + sm.hdist;
          br.skip(17);
          for (int k = 0; k < 19; ++k) sm.cll[k] = 0;
          for (int k = 0; k < hclen; ++k) {
            br.refill();
            sm.cll[kClOrder[k]] = (uint8_t)br.peek(0, 3);
            br.skip(3);
          }
          fixed = false;
          mode = kLens;
          lpos = 0;
          prev = 0;
          cmd = kBuildCl;
          break;
        }
        if (mode == kLens) {
          br.refill();
          const unsigned pk = br.peek(0, 14);
          const unsigned e = sm.cl[pk & 127];
          const int clen = e & 7, csym = e >> 3;
          const int rbits = csym == 16 ? 2 : csym == 17 ? 3 : csym == 18 ? 7 : 0;
          const int extv = (int)((pk >> clen) & ((1u << rbits) - 1));
          const int rep = csym == 16 || csym == 17 ? 3 + extv
                          : csym == 18             ? 11 + extv
                                                   : 1;
          const int val = csym < 16 ? csym : csym == 16 ? prev : 0;
          if (clen == 0 || lpos + rep > total || (csym == 16 && lpos == 0)) {
            err = true;
            break;
          }
          for (int i = lpos; i < lpos + rep; ++i) sm.L[i] = (uint8_t)val;
          prev = val;
          lpos += rep;
          br.skip(clen + rbits);
          if (lpos >= total) {
            mode = kSymbols;
            cmd = kBuildDyn;
            break;
          }
          continue;
        }
        // ---- symbols up to the block's EOB: the hot loop ---------------
        for (;;) {
          if ((br.next > guard) | (nev >= kEvBuf)) {
            cmd = br.next > guard ? kRefill : kFlush;
            goto yield;
          }
          br.refill();
          const uint32_t e = sm.lit[(uint32_t)br.buf & ((1u << kBits) - 1)];
          if (e - 1u < 0xFFFFu) {   // a literal whose code fits the table
            const int llen = e & 15;
            if (br.pos + llen > bitlim) {
              err = true;
              goto yield;
            }
            sm.ev[nev++] = e >> 8;
            br.skip(llen);
            continue;
          }
          int llen = e & 15, lsym = (e >> 8) & 511, lext, lbase;
          if (llen == 0 || (unsigned)(lsym - 257) > 28u) {
            // a long code, EOB, a literal past the table or an error
            if (llen == 0) {
              lsym = decode_long(sm.tl, sm.lsym, br.peek(0, 15), llen);
              if (llen == 0) {
                err = true;
                goto yield;
              }
            }
            if (lsym < 256) {
              if (br.pos + llen > bitlim) {
                err = true;
                goto yield;
              }
              sm.ev[nev++] = (uint32_t)lsym;
              br.skip(llen);
              continue;
            }
            if (lsym == 256) {
              if (br.pos + llen > bitlim) {
                err = true;
                goto yield;
              }
              br.skip(llen);
              mode = kHeader;
              if (final_blk) goto yield;  // cmd kDone, err false: the end
              break;
            }
            if (lsym > 285) {
              err = true;
              goto yield;
            }
            lext = kLExtra[lsym - 257];
            lbase = kLBase[lsym - 257];
          } else {                  // a length symbol whose code fits
            lext = (e >> 4) & 15;
            lbase = (int)(e >> 17);
          }
          const int mlen = lbase + (int)br.peek(llen, lext);
          br.skip(llen + lext);
          br.refill();
          const uint32_t e2 = sm.dist[(uint32_t)br.buf & ((1u << kBits) - 1)];
          int dlen = e2 & 15, dsym, dext, dbase;
          if (dlen) {
            dsym = (e2 >> 8) & 511;
            dext = (e2 >> 4) & 15;
            dbase = (int)(e2 >> 17);
          } else {
            dsym = decode_long(sm.td, sm.dsym, br.peek(0, 15), dlen);
            dext = dsym < 30 ? kDExtra[dsym] : 0;
            dbase = dsym < 30 ? kDBase[dsym] : 0;
          }
          const int adv = dlen + dext;
          if ((dlen == 0) | (dsym > 29) | (br.pos + adv > bitlim)) {
            err = true;
            goto yield;
          }
          const int d = dbase + (int)br.peek(dlen, dext);
          sm.ev[nev++] = kMatch | (uint32_t)d << 9 | (uint32_t)mlen;
          br.skip(adv);
        }
      }
    yield:
      sm.cmd = cmd;
      sm.nev = nev;
      sm.derr = err;                // a check of the decoder failed
    }
    __syncthreads();
    const int cmd = sm.cmd;
    if (cmd == kRefill) {
      const int rbs = sm.rbase;
      stage(sm.ring, s, lim, rbs + 2 * kHalf, kHalf, tid);
    } else if (cmd == kBuildCl) {
      build(sm.tc, sm.csym, sm.cll, 19, tid);
      fill<kClBits>(sm.cl, sm.tc, sm.csym, 2, tid);
    } else if (cmd == kBuildDyn || cmd == kBuildFixed) {
      int hlit = sm.hlit, hdist = sm.hdist;
      if (cmd == kBuildFixed) {
        for (int i = tid; i < 288 + 30; i += kThreads)
          sm.L[i] = i < 144 ? 8 : i < 256 ? 9 : i < 280 ? 7 : i < 288 ? 8 : 5;
        hlit = 288;
        hdist = 30;
        __syncthreads();
      }
      build(sm.tl, sm.lsym, sm.L, hlit, tid);
      build(sm.td, sm.dsym, sm.L + hlit, hdist < 30 ? hdist : 30, tid);
      fill<kBits>(sm.lit, sm.tl, sm.lsym, 0, tid);
      fill<kBits>(sm.dist, sm.td, sm.dsym, 1, tid);
    } else {                        // kFlush, kDone: the buffered events
      flush(sm, out_len, E, tp, kind + rb, arg + rb, dst + rb, len + rb, tid);
    }
    __syncthreads();
    // sm.err is written by flushes only, before the barrier above
    if (cmd == kDone || sm.err) break;
    if (tid == 0) {
      if (cmd == kRefill) {
        rbase += kHalf;
        sm.rbase = rbase;
      } else if (cmd == kFlush) {
        nev = 0;
      }
    }
  }
  if (tid == 0 && sm.lits > sm.run0) {  // the open literal run
    const int n = sm.lits - sm.run0, k = sm.recs++;
    kind[rb + k] = 0;
    arg[rb + k] = sm.run0;
    dst[rb + k] = sm.op - n;
    len[rb + k] = n;
  }
  __syncthreads();

  // the kind -1 / zero tail of the record columns and of the tape
  const int nr_all = sm.recs;
  const int nt_all = sm.lits;
  const int r4 = min((nr_all + 3) & ~3, E);
  for (int i = nr_all + tid; i < r4; i += kThreads) {
    kind[rb + i] = -1;
    arg[rb + i] = 0;
    dst[rb + i] = 0;
    len[rb + i] = 0;
  }
  const int4 neg = make_int4(-1, -1, -1, -1), zero = make_int4(0, 0, 0, 0);
  for (int i = r4 + 4 * tid; i < E; i += 4 * kThreads) {
    *(int4*)(kind + rb + i) = neg;
    *(int4*)(arg + rb + i) = zero;
    *(int4*)(dst + rb + i) = zero;
    *(int4*)(len + rb + i) = zero;
  }
  const int t16 = min((nt_all + 15) & ~15, E);
  for (int i = nt_all + tid; i < t16; i += kThreads) tp[i] = 0;
  for (int i = t16 + 16 * tid; i < E; i += 16 * kThreads)
    *(int4*)(tp + i) = zero;
  if (tid == 0) {
    tlen_out[row] = nt_all;
    dist_out[row] = sm.dmax;
    uni_out[row] = sm.uni ? 1 : 0;
    ok_out[row] = (!sm.err && !sm.derr && sm.op == out_len) ? 1 : 0;
  }
}

}  // namespace

extern "C" int zlib_walk_launch(const void* slots, int N, int W,
                                const void* csizes, int out_len, int E,
                                void* tape, void* tlen, void* kind, void* arg,
                                void* dst, void* len, void* dist, void* uni,
                                void* ok, void* stream) {
  // 16-byte stores of the tails need a row stride that keeps them aligned
  if (E % 16 != 0) return (int)cudaErrorInvalidValue;
  if (N > 0) {
    zlib_walk_kernel<<<N, kThreads, 0, (cudaStream_t)stream>>>(
        (const uint8_t*)slots, N, W, (const int32_t*)csizes, out_len, E,
        (uint8_t*)tape, (int32_t*)tlen, (int32_t*)kind, (int32_t*)arg,
        (int32_t*)dst, (int32_t*)len, (int32_t*)dist, (uint8_t*)uni,
        (uint8_t*)ok);
  }
  return (int)cudaGetLastError();
}
