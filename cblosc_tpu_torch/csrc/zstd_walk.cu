// zstd walk kernel (K7): parse zstd frames into a Huffman-literal tape and
// compacted placement records, one warp (one CTA) per row.
//
// Replaces cblosc_tpu/tpu/codec_zstd.py:_fsm_walk (a batched
// lax.while_loop over 17 modes that emits up to 18 event lanes per row and
// iteration) and its _events_to_records (one sort that compacts the
// per-byte literal events into the tape). The decisions are _fsm_walk's,
// line for line, because which rows err decides the byte API's retry and
// its host fallback:
//   frame      magic, the reserved bit and the dictionary-ID flag of the
//              frame header descriptor err; the window and content-size
//              fields are skipped; the content checksum is not read
//   block      type 3, a header past csize, a raw or RLE block past
//              out_len or csize, a compressed block past csize or under 2
//              bytes err
//   literals   regenerated size > out_len, a section past the block, a
//              compressed size < 1, treeless literals with no earlier
//              tree; Huffman: a tree description past the section, FSE
//              weights read by two interleaved states until an update
//              would read below the stream (254 weights at most), the
//              weights' completion to a power of two with K <= 11 and no
//              weight above 11; 1 or 4 backward streams with jump-table
//              checks, each ending exactly on its first bit
//   FSE        normalized counts (accuracy log above the table's maximum,
//              a count past symbol 63 or the table's last symbol, a
//              remainder other than 1), a spread whose live cells differ
//              in number from the count sum. A zero run's 2-bit repeat
//              flags are read to the first flag below 3, as the RFC
//              reads them: JAX errs after 8 flags of 3 (24 zero counts),
//              which rejects most match-length tables of shuffled typed
//              data, so here the port accepts a superset of its rows
//   sequences  reserved mode bits, an RLE symbol above the table's
//              maximum, offset codes above 25, literal length codes above
//              35, match length codes above 52, a zero offset, literals
//              past the section, output past out_len, an offset beyond
//              the output, and a bitstream that does not end exactly on
//              its first bit
//   budget     a row errs when a valid event (a tape byte or a record)
//              would be the (E+1)-th, or a record the (RC+1)-th. JAX
//              counts 18 event slots per loop iteration, so every row it
//              accepts fits here
//   ok         = !err && the last block ended && op == out_len
// Bits below the row's first bit and bytes at or past the row width read
// as 0 (the JAX machine's zero padding and its window clamped at bit 0).
//
// Outputs: tape[:tlen] the Huffman-decoded literals in frame order, zeros
// after; records compacted, valid first, in the JAX machine's emission
// order: (kind 0, src, dst, len) per literal run, src a tape offset or TW
// + a stream offset (raw literals and raw blocks), (kind 1, distance, dst,
// len) per match (RLE literals and RLE blocks become a 1-byte literal and
// a distance-1 match), then kind -1 and zeros up to RC. A row that is not
// ok reports tlen 0, no records and a zero tape. stats (optional): per row
// the sequences the decoder took.
//
// What bounds it on an H100: latency. zstd's literal streams and its
// sequence stream are bit-serial: each symbol's position is known only
// after the previous one is decoded, so a row is one chain of dependent
// steps, and the bytes moved (the stream, the tape, 16 bytes per record)
// take microseconds at 3.35 TB/s. The design keeps that chain short and
// moves all other work off it:
//   - one lane decodes a sequence section (lane 0 of the row's warp). Its
//     step is the three FSE cells, looked up in shared memory at once
//     (each cell: symbol, state bits, state base and the code's extra-bit
//     count, so one lookup gives a step's bit widths), and the three next
//     states, each read at its own position with one shift and mask from
//     a 64-bit container of the 8 bytes below the cursor (at least 57
//     bits), refilled once a step from the staged stream (three
//     shared-memory words, no branch); a step whose states lie below the
//     container takes a second refill. The decoder records each step as
//     its bit position and its three codes; the flush reads the three
//     extra-bit fields (57 bits at most) back from the row;
//   - the decoder runs steps in groups of eight with one check of the
//     ring between groups, and folds what decides how it decodes (the
//     code ranges, the cursor against the section's first bit after each
//     state update) into one flag read at the group's end: a step past a
//     failed check only reads the ring, and the row errs anyway. The
//     stream's exact end is checked after the last step;
//   - a backward stream is staged into a ring of four chunks in shared
//     memory by the thread that reads it, with cp.async, from the
//     stream's end downward: two chunks are resident and the next lower
//     one is in flight while the cursor crosses them, so a refill of the
//     ring costs one wait for a copy issued a chunk earlier. Bytes
//     outside the row read 0;
//   - the warp resolves each buffer of 256 steps (flush): their fields,
//     the repeat-offset machine by a scan of their per-sequence maps
//     (each output repeat offset is an input one plus a constant, or a
//     new offset), the output and literal positions and record places by
//     scans, every check against the row so far, and the records, each
//     lane writing those of its eight sequences. Any failed check errs
//     the row, which then writes no record: the outputs do not depend on
//     which check failed first;
//   - Huffman literals: lanes 0-3 decode one stream each, over their own
//     quarter of the ring, through a container that holds the bits below
//     the cursor left-aligned (a K-bit peek of its top word indexes a
//     direct table of 2^K cells in shared memory, and the bits read are
//     shifted out: on these short steps the shift chain costs less than
//     per-position reads), up to five symbols a refill, into 512-byte
//     stretches of a shared-memory buffer that the warp copies to the
//     tape, consecutive lanes on consecutive bytes;
//   - the FSE spread, the next-state table and the Huffman cell fill run
//     on the whole warp (ballots for the spread's ranks, match_any for
//     each symbol's occurrence order); the table descriptions (a few
//     bytes a block) are read through the read-only cache;
//   - the kind -1 / zero tails of the record columns (RC = record_cap,
//     about 132k slots for a 256 KB row) and of the tape are written by
//     the warp with 16-byte stores.
// One row per CTA of 32 threads with 13 KB of static shared memory, so
// sixteen rows share an SM (with the 1 KB each CTA reserves): the 4,096
// rows of 32 KB blocks in 128 MB at clevel 1 take two waves of the card,
// and the 16 rows of a 4 MB clevel-5 chunk run one per SM.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 32;        // one warp per row, one row per CTA
constexpr unsigned kFull = 0xffffffffu;
constexpr int kChunk = 256;         // sequence stream: ring chunk bytes
constexpr int kRing = 4 * kChunk;   // ring bytes (Huffman: 4 rings of 4 x 64)
constexpr int kSeqBuf = 256;        // decoded sequences per flush
constexpr int kPer = kSeqBuf / kThreads;  // sequences a lane flushes
constexpr int kGroup = 8;           // sequences a ring check covers (a
                                    // sequence reads 83 bits at most)
constexpr int kHufGroup = 4;        // Huffman refills a ring check covers
                                    // (55 bits at most each)

__constant__ int kLLBits[36] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,  0,
                                0, 0, 0, 0, 1, 1, 1, 1, 2, 2, 3,  3,
                                4, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16};
__constant__ int kLLBase[36] = {0,  1,  2,  3,  4,  5,    6,    7,    8,    9,
                                10, 11, 12, 13, 14, 15,   16,   18,   20,   22,
                                24, 28, 32, 40, 48, 64,   128,  256,  512,  1024,
                                2048, 4096, 8192, 16384, 32768, 65536};
__constant__ int kMLBits[53] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
                                0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
                                0, 0, 0, 0, 1, 1, 1, 1, 2, 2, 3, 3, 4, 4,
                                5, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16};
__constant__ int kMLBase[53] = {
    3,  4,  5,  6,  7,  8,  9,  10, 11, 12, 13, 14, 15, 16, 17, 18, 19, 20,
    21, 22, 23, 24, 25, 26, 27, 28, 29, 30, 31, 32, 33, 34, 35, 37, 39, 41,
    43, 47, 51, 59, 67, 83, 99, 131, 259, 515, 1027, 2051, 4099, 8195, 16387,
    32771, 65539};
// predefined distributions (RFC 8878 3.1.1.3.2.2)
__constant__ int16_t kLLDefault[36] = {4, 3, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2,
                                       2, 1, 1, 1, 2, 2, 2, 2, 2, 2, 2, 2,
                                       2, 3, 2, 1, 1, 1, 1, 1, -1, -1, -1, -1};
__constant__ int16_t kMLDefault[53] = {
    1, 4, 3, 2, 2, 2, 2, 2, 2, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
    1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, -1, -1, -1, -1, -1, -1, -1};
__constant__ int16_t kOFDefault[29] = {1, 1, 1, 1, 1, 1, 2, 2, 2, 1, 1, 1, 1, 1, 1,
                                       1, 1, 1, 1, 1, 1, 1, 1, 1, -1, -1, -1, -1, -1};
// per table id (Huffman weights, LL, OF, ML): last symbol, largest
// accuracy log, cells kept
__constant__ int kMaxSym[4] = {255, 35, 31, 52};
__constant__ int kMaxLog[4] = {6, 9, 8, 9};
__constant__ int kTabW[4] = {64, 512, 256, 512};
__constant__ int kTabOff[4] = {0, 64, 576, 832};

// an FSE cell: symbol | state bits << 8 | state base << 16 | the symbol's
// extra-bit count << 25 (sequence tables only)
__device__ __forceinline__ int c_sym(uint32_t c) { return c & 0xFF; }
__device__ __forceinline__ int c_nb(uint32_t c) { return (c >> 8) & 0xFF; }
__device__ __forceinline__ int c_base(uint32_t c) { return (c >> 16) & 0x1FF; }
__device__ __forceinline__ int c_xb(uint32_t c) { return c >> 25; }

__device__ __forceinline__ int hb(int x) { return x > 1 ? 31 - __clz(x) : 0; }

// extra bits of symbol s in table tid (0 for a symbol out of range, which
// the decoder rejects before reading them)
__device__ __forceinline__ uint32_t xbits(int tid, int s) {
  if (tid == 1) return s <= 35 ? kLLBits[s] : 0;
  if (tid == 2) return s;
  if (tid == 3) return s <= 52 ? kMLBits[s] : 0;
  return 0;
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

__device__ __forceinline__ unsigned lanemask_lt() {
  return (1u << (threadIdx.x & 31)) - 1u;
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

// One thread's backward reader of the row: a ring of four chunks of Q
// bytes in shared memory. Chunk c holds the row's bytes [c*Q, (c+1)*Q) in
// aligned space (u = x + off0, off0 the row's misalignment), in slot c & 3.
// Chunks top and top-1 are resident and top-2 is in flight, so bytes
// [(top-1)*Q, (top+1)*Q) may be read (low: the lowest, as a row byte);
// need(lo) moves the window down until it holds byte lo. The thread that
// issues the copies also waits for them.
template <int Q>
struct Back {
  uint8_t* ring;                    // 4 * Q bytes, 16-aligned
  const uint8_t* s;                 // the row
  const uint8_t* a0;                // s - off0, 16-aligned
  int off0, W, top, low;

  __device__ void issue(int c) {
    const long long ub = (long long)c * Q;
    uint8_t* dst = ring + (c & 3) * Q;
    for (int i = 0; i < Q; i += 16) {
      const long long x = ub + i - off0;      // row offset of the piece
      if (x >= 0 && x + 16 <= W) {
        cp_async16(dst + i, a0 + ub + i);
      } else {
        for (int k = 0; k < 16; ++k)
          dst[i + k] = (x + k >= 0 && x + k < W) ? __ldg(s + x + k) : 0;
      }
    }
    cp_async_commit();
  }
  // the stream's highest byte is hi
  __device__ void init(uint8_t* r, const uint8_t* row, int w, int hi) {
    ring = r;
    s = row;
    off0 = (int)((uintptr_t)row & 15);
    a0 = row - off0;
    W = w;
    top = (hi + off0) >= 0 ? (hi + off0) / Q : -((Q - 1 - (hi + off0)) / Q);
    issue(top);
    issue(top - 1);
    issue(top - 2);
    cp_async_wait<1>();
    low = (top - 1) * Q - off0;
  }
  __device__ __forceinline__ void need(int lo) {
    while (lo < low) {
      cp_async_wait<0>();
      --top;
      issue(top - 2);
      low -= Q;
    }
  }
  // 64 bits from row byte x0 (little-endian), resident
  __device__ __forceinline__ unsigned long long load8(int x0) const {
    const uint32_t* r = reinterpret_cast<const uint32_t*>(ring);
    const int u = x0 + off0, w = u >> 2, sh = (u & 3) * 8;
    constexpr int wm = Q - 1;       // 4 * Q bytes = Q words
    const uint32_t a = r[w & wm], b = r[(w + 1) & wm], c = r[(w + 2) & wm];
    return (unsigned long long)__funnelshift_r(a, b, sh) |
           (unsigned long long)__funnelshift_r(b, c, sh) << 32;
  }
  __device__ __forceinline__ void drain() { cp_async_wait<0>(); }
};

// The sequence stream's reads: a container of the 8 bytes from x0 =
// first_byte(q) holds at least 57 bits below the cursor q, and each field
// is read at its own position with one shift and mask, so the fields of a
// step do not wait on one another (a left-aligned container would chain
// every read through the shift before it: slower on this one thread).
__device__ __forceinline__ int first_byte(int q) { return ((q + 7) >> 3) - 8; }
// n bits ending at bit q, from the container c of byte x0
__device__ __forceinline__ int take(unsigned long long c, int x0, int q, int n) {
  return (int)((c >> (q - n - 8 * x0)) & ((1ull << n) - 1));
}

// A backward bit reader over a ring for the Huffman streams: a 64-bit
// container holding the bits below the cursor q left-aligned (the bit
// just below q is bit 63), so a peek is one shift of the top word and the
// bits read are shifted out. refill() loads it from the 8 bytes whose top
// is the byte of bit q - 1 (the caller has made them resident): at least
// 57 bits below q are then valid.
template <int Q>
struct BitsBack {
  unsigned long long c;
  int q;
  __device__ __forceinline__ void refill(const Back<Q>& br) {
    const int x0 = first_byte(q);
    c = br.load8(x0) << (8 * x0 + 64 - q);
  }
};

// a repeat-offset map: output offset k is input offset src[k] plus add[k],
// or add[k] alone when src[k] is 3; src packed two bits each
struct RepMap {
  int src, a0, a1, a2;
  __device__ __forceinline__ int s(int k) const { return (src >> (2 * k)) & 3; }
  __device__ __forceinline__ int add(int k) const {
    return k == 0 ? a0 : k == 1 ? a1 : a2;
  }
};
__device__ __forceinline__ RepMap rep_identity() { return {0 | 1 << 2 | 2 << 4, 0, 0, 0}; }
// the map of one sequence (4.2.2 repeat offsets)
__device__ __forceinline__ RepMap rep_of(int ofv, int ll) {
  if (ofv > 3) return {3 | 0 << 2 | 1 << 4, ofv - 3, 0, 0};
  const int idx = ofv - 1 + (ll == 0);
  if (idx == 0) return rep_identity();
  if (idx == 1) return {1 | 0 << 2 | 2 << 4, 0, 0, 0};
  if (idx == 2) return {2 | 0 << 2 | 1 << 4, 0, 0, 0};
  return {0 | 0 << 2 | 1 << 4, -1, 0, 0};
}
// a, then b
__device__ __forceinline__ RepMap rep_then(const RepMap& a, const RepMap& b) {
  RepMap c;
  int src = 0, ad[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const int j = b.s(k);
    const int sj = j == 3 ? 3 : a.s(j);
    ad[k] = b.add(k) + (j == 3 ? 0 : a.add(j));
    src |= sj << (2 * k);
  }
  c.src = src;
  c.a0 = ad[0];
  c.a1 = ad[1];
  c.a2 = ad[2];
  return c;
}
__device__ __forceinline__ void rep_apply(const RepMap& m, int& r1, int& r2,
                                          int& r3) {
  int in[3] = {r1, r2, r3}, o[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const int j = m.s(k);
    const int v = j == 0 ? in[0] : j == 1 ? in[1] : in[2];
    o[k] = (j == 3 ? 0 : v) + m.add(k);
  }
  r1 = o[0];
  r2 = o[1];
  r3 = o[2];
}

struct Smem {
  unsigned long long seq[kSeqBuf];  // q | (ofc | mlc << 5 | llc << 11) << 32
  uint8_t ring[kRing];              // staged backward streams
  uint32_t cells[1344];             // FSE tables by id at kTabOff: weights
                                    // (64 cells), LL (512), OF (256), ML (512)
  uint16_t huf[2048];               // direct Huffman table: sym | nb << 8
  int16_t ncount[64];               // normalized counts being read
  int16_t nxt[64];                  // build: next state per symbol
  int16_t cum[64];                  // build: cumulative counts
  uint8_t warr[256];                // Huffman weights
  __device__ uint32_t* tab(int tid) { return cells + kTabOff[tid]; }
};
// sixteen rows to an SM: 228 KB of shared memory, 1 KB of it reserved per
// CTA
static_assert(sizeof(Smem) <= 228 * 1024 / 16 - 1024, "sixteen rows to an SM");

struct Row {
  const uint8_t* s;
  int W;
  __device__ int byte(int x) const {
    return (x >= 0 && x < W) ? (int)__ldg(s + x) : 0;
  }
  // n (<= 25) bits at bit position q (may be negative), LSB-first
  __device__ int bits(int q, int n) const {
    const int b = q >= 0 ? q >> 3 : -((-q + 7) >> 3);
    unsigned long long v = 0;
#pragma unroll
    for (int j = 0; j < 5; ++j) v |= (unsigned long long)byte(b + j) << (8 * j);
    return (int)((v >> (q & 7)) & ((1ull << n) - 1));
  }
  // bits [bitpos - n, bitpos): a backward stream read
  __device__ int back(int bitpos, int n) const { return bits(bitpos - n, n); }
  // the 8 bytes from x, little-endian
  __device__ unsigned long long load8(int x) const {
    unsigned long long v = 0;
#pragma unroll
    for (int j = 0; j < 8; ++j) v |= (unsigned long long)byte(x + j) << (8 * j);
    return v;
  }
};

struct Walk {
  Row rd;
  Smem& sm;
  int lane, out_len, TW, E, RC, cs;
  uint8_t* tp;
  int32_t *kind, *arg, *dst, *len;
  int op = 0, tl = 0, nev = 0, nrec = 0, nseq = 0;
  int rep1 = 1, rep2 = 4, rep3 = 8;

  __device__ Walk(Row r, Smem& m, int ln) : rd(r), sm(m), lane(ln) {}

  __device__ void put(int k, int a, int d, int n, int at) {
    if (at < RC) {
      kind[at] = k;
      arg[at] = a;
      dst[at] = d;
      len[at] = n;
    }
  }

  // a record, unless the budget or the record columns are spent
  __device__ bool emit(int k, int a, int d, int n) {
    if (nev >= E || nrec >= RC) return false;
    if (lane == 0) put(k, a, d, n, nrec);
    ++nrec;
    ++nev;
    return true;
  }

  // ll literals at the consumption point, by the literal type (_emit_lits)
  __device__ bool emit_lits(int ltype, int lbase, int lsrc, int lpos, int ll) {
    const bool rle = ltype == 1;
    const int a = ltype >= 2 ? lbase + lpos : TW + lsrc + lpos;
    if (ll > 0 && !emit(0, rle ? TW + lsrc : a, op, rle ? 1 : ll)) return false;
    if (rle && ll > 1 && !emit(1, 1, op + 1, ll - 1)) return false;
    return true;
  }

  // one FSE table description at bit ncbp for table id tid (M_NCOUNT);
  // sets acc and the byte after it
  __device__ bool ncount(int ncbp, int tid, int& acc, int& pos) {
    const int maxsym = kMaxSym[tid];
    acc = rd.bits(ncbp, 4) + 5;
    if (acc > kMaxLog[tid]) return false;
    __syncwarp();
    for (int i = lane; i < 64; i += 32) sm.ncount[i] = 0;
    __syncwarp();
    int rem = (1 << acc) + 1, thr = 1 << acc, nbits = acc + 1, num = 0;
    bool p0 = false;
    ncbp += 4;
    for (;;) {
      if (p0) {
        // the whole run of 2-bit zero-run flags (JAX errs after 8 flags
        // of 3), up to the one past the table's last symbol
        for (;;) {
          const int fl = rd.bits(ncbp, 2);
          num += fl;
          ncbp += 2;
          if (fl < 3 || num > maxsym + 1) break;
        }
        p0 = false;
        if (num > maxsym + 1) return false;
      } else {
        const int maxv = 2 * thr - 1 - rem;
        const int sb = min(max(nbits - 1, 0), 10), bb = min(max(nbits, 0), 11);
        const int vsm = rd.bits(ncbp, 10) & ((1 << sb) - 1);
        const bool small = vsm < maxv;
        const int vbig = rd.bits(ncbp, 11) & ((1 << bb) - 1);
        const int vv = small ? vsm : vbig < thr ? vbig : vbig - maxv;
        const int cval = vv - 1;
        ncbp += small ? nbits - 1 : nbits;
        rem -= cval < 0 ? -cval : cval;
        if (num >= 64) return false;
        if (lane == 0) sm.ncount[num] = (int16_t)cval;
        ++num;
        p0 = cval == 0;
      }
      for (int k = 0; k < 10; ++k) {
        if (rem < thr && thr > 1) {
          --nbits;
          thr >>= 1;
        }
      }
      if (rem <= 1 || num > maxsym) {
        if (rem != 1) return false;
        pos = (ncbp + 7) >> 3;
        __syncwarp();
        return true;
      }
    }
  }

  // FSE decode table (4.1.1) of the counts in sm.ncount into sm.tab[tid];
  // false when the spread's live cells differ in number from the counts.
  // The warp builds it: the k-th live visit of k * step mod size takes the
  // k-th symbol occurrence (ranks by ballot, the symbol by a search of the
  // cumulative counts); then each cell's next state is its symbol's count
  // plus the symbol's cells before it (match_any a round of 32 cells).
  __device__ bool fse_build(int tid, int acc) {
    __syncwarp();
    const int size = 1 << acc, mask = size - 1;
    const unsigned lt = lanemask_lt();
    const int c0 = sm.ncount[lane], c1 = sm.ncount[lane + 32];
    const unsigned m0 = __ballot_sync(kFull, c0 == -1);
    const unsigned m1 = __ballot_sync(kFull, c1 == -1);
    const int nlow = __popc(m0) + __popc(m1);
    const int i0 = warp_incl_scan(max(c0, 0));
    const int t0 = __shfl_sync(kFull, i0, 31);
    const int i1 = warp_incl_scan(max(c1, 0)) + t0;
    const int tot = __shfl_sync(kFull, i1, 31);
    if (size - nlow != tot) return false;
    uint32_t* t = sm.tab(tid);
    const int high = size - 1 - nlow;
    if (c0 == -1) t[size - 1 - __popc(m0 & lt)] = lane;
    if (c1 == -1) t[size - 1 - __popc(m0) - __popc(m1 & lt)] = lane + 32;
    sm.cum[lane] = (int16_t)i0;
    sm.cum[lane + 32] = (int16_t)i1;
    sm.nxt[lane] = (int16_t)(c0 == -1 ? 1 : max(c0, 0));
    sm.nxt[lane + 32] = (int16_t)(c1 == -1 ? 1 : max(c1, 0));
    __syncwarp();
    const int step = (size >> 1) + (size >> 3) + 3;
    int seen = 0;
    for (int k0 = 0; k0 < size; k0 += 32) {
      const int k = k0 + lane, p = (k * step) & mask;
      const bool live = p <= high;
      const unsigned m = __ballot_sync(kFull, live);
      if (live) {
        const int r = seen + __popc(m & lt);
        int lo = 0, hi = 63;        // the first symbol whose cum exceeds r
        while (lo < hi) {
          const int mid = (lo + hi) >> 1;
          if (sm.cum[mid] > r) hi = mid;
          else lo = mid + 1;
        }
        t[p] = lo;
      }
      seen += __popc(m);
    }
    __syncwarp();
    for (int u0 = 0; u0 < size; u0 += 32) {
      const int u = u0 + lane;
      const int s = t[u] & 0xFF;
      const unsigned grp = __match_any_sync(kFull, s);
      const int occ = __popc(grp & lt);
      const int ns = sm.nxt[s] + occ;
      __syncwarp();
      if (occ == __popc(grp) - 1) sm.nxt[s] = (int16_t)(ns + 1);
      __syncwarp();
      const int nb = acc - hb(ns);
      t[u] = (uint32_t)s | ((uint32_t)nb << 8) |
             ((uint32_t)((ns << nb) - size) << 16) | (xbits(tid, s) << 25);
    }
    __syncwarp();
    return true;
  }

  // a predefined table (3.1.1.3.2.2) into sm.tab[tid]
  __device__ void predefined(int tid) {
    const int16_t* d = tid == 1 ? kLLDefault : tid == 2 ? kOFDefault : kMLDefault;
    const int n = tid == 1 ? 36 : tid == 2 ? 29 : 53;
    __syncwarp();
    for (int i = lane; i < 64; i += 32) sm.ncount[i] = i < n ? d[i] : 0;
    __syncwarp();
    fse_build(tid, tid == 2 ? 5 : 6);
  }

  // direct Huffman table of the weights sm.warr[0..nw) and the implied
  // last one (4.2.1, _huf_build): cells in (weight, symbol) order. A
  // symbol's place is the spans of the lighter weights plus its rank among
  // the symbols of its weight (ballots, eight rounds of 32 symbols); each
  // lane fills the spans of its symbols.
  __device__ bool huf_build(int nw, int& K) {
    __syncwarp();
    int part = 0;
    bool big = false;
    for (int s = lane; s < nw; s += 32) {
      const int w = sm.warr[s];
      if (w > 0) part += 1 << min(w - 1, 11);
      big |= w > 11;
    }
    const int total0 = __shfl_sync(kFull, warp_incl_scan(part), 31);
    big = __any_sync(kFull, big);
    K = hb(max(total0, 1)) + 1;
    const int rest = (1 << K) - total0;
    if (total0 < 1 || rest < 1 || (rest & (rest - 1)) || K > 11 || nw > 255 || big)
      return false;
    if (lane == 0) sm.warr[nw] = (uint8_t)(hb(rest) + 1);
    __syncwarp();
    const unsigned lt = lanemask_lt();
    int seen[12], rank[8];
#pragma unroll
    for (int w = 0; w < 12; ++w) seen[w] = 0;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int s = 32 * i + lane;
      const int w = s <= nw ? sm.warr[s] : 0;
      rank[i] = 0;
#pragma unroll
      for (int v = 1; v < 12; ++v) {
        const unsigned m = __ballot_sync(kFull, w == v);
        if (w == v) rank[i] = seen[v] + __popc(m & lt);
        seen[v] += __popc(m);
      }
    }
    int first[12], p = 0;
#pragma unroll
    for (int w = 1; w < 12; ++w) {
      first[w] = p;
      p += seen[w] << (w - 1);
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int s = 32 * i + lane;
      const int w = s <= nw ? sm.warr[s] : 0;
      if (w == 0) continue;
      int at = 0;
#pragma unroll
      for (int v = 1; v < 12; ++v)
        if (v == w) at = first[v];
      const int span = 1 << (w - 1);
      at += rank[i] * span;
      const uint16_t cellv = (uint16_t)(((K + 1 - w) << 8) | s);
      for (int j = 0; j < span; ++j) sm.huf[at + j] = cellv;
    }
    __syncwarp();
    return true;
  }

  __device__ bool literals(int four, int sbase, int tot, int j1, int j2, int j3,
                           int lrsz, int hK);
  __device__ bool sequences(int nbseq, int pos, int bend, const int* logs,
                            int lt, int lbase, int lsrc, int lrsz);
  __device__ bool flush(int n, int lt, int lbase, int lsrc, int lrsz,
                        int& lpos);
  __device__ bool run(int& tlen);
};


// The Huffman streams of a literal section (its setup checks made): lane
// k < 4 decodes stream k backward through its own ring of four 64-byte
// chunks, up to five symbols a container, into its 512-byte stretch of a
// shared-memory buffer (the sequence buffer, free until the section's
// sequences); when a stretch is nearly full or every stream has ended,
// the warp copies the stretches to their places on the tape, consecutive
// lanes on consecutive bytes. An invalid code (no symbol) is flagged and
// decoded past, as the row errs anyway. false when a code is not in the
// table or a stream does not end exactly on its first bit.
__device__ bool Walk::literals(int four, int sbase, int tot, int j1, int j2,
                               int j3, int lrsz, int hK) {
  constexpr int kCap = kSeqBuf * 8 / 4;  // buffer bytes a stream
  const int r13 = (lrsz + 3) >> 2, r4 = lrsz - 3 * r13;
  const int k = lane, ns = four ? 4 : 1;
  uint8_t* buf = reinterpret_cast<uint8_t*>(sm.seq) + (k & 3) * kCap;
  bool bad = false;
  int sr = 0, sbit = 0, at = tl + k * r13;
  BitsBack<kChunk / 4> bb{0ull, 0};
  Back<kChunk / 4> br;
  if (k < ns) {
    const int start = k == 0 ? sbase : k == 1 ? sbase + j1
                      : k == 2 ? sbase + j1 + j2 : sbase + j1 + j2 + j3;
    const int size = k == 0 ? (four ? j1 : tot) : k == 1 ? j2 : k == 2 ? j3
                     : tot - j1 - j2 - j3;
    sr = k == 0 ? (four ? r13 : lrsz) : k < 3 ? r13 : r4;
    sbit = start * 8;
    bb.q = sbit;
    if (sr > 0) {
      const int lastb = rd.byte(start + size - 1);
      bb.q = (start + size - 1) * 8 + hb(max(lastb, 1));
      br.init(sm.ring + k * kChunk, rd.s, rd.W, start + size - 1);
    }
  }
  const int sh = 32 - hK;             // a peek of K bits from the top word
  for (;;) {
    int filled = 0;
    // groups of kHufGroup refills per ring check
    while (sr > 0 && filled <= kCap - 5 * kHufGroup) {
      br.need(first_byte(bb.q) - 7 * kHufGroup);
      for (int r = 0; r < kHufGroup && sr > 0; ++r) {
        bb.refill(br);
        const int m = min(sr, 5);
#pragma unroll
        for (int i = 0; i < 5; ++i) {
          if (i < m) {
            const uint32_t h = sm.huf[(uint32_t)(bb.c >> 32) >> sh];
            const int nb = h >> 8;
            bad |= nb == 0;
            buf[filled++] = (uint8_t)h;
            bb.c <<= nb;
            bb.q -= nb;
          }
        }
        sr -= m;
      }
    }
    __syncwarp();
    for (int j = 0; j < ns; ++j) {
      const int nj = __shfl_sync(kFull, filled, j), aj = __shfl_sync(kFull, at, j);
      const uint8_t* bj = reinterpret_cast<const uint8_t*>(sm.seq) + j * kCap;
      for (int i = lane; i < nj; i += kThreads) tp[aj + i] = bj[i];
    }
    at += filled;
    if (!__any_sync(kFull, sr > 0)) break;
    __syncwarp();
  }
  if (k < ns) {
    if (sbit != bb.q) bad = true;
    br.drain();
  }
  return !__any_sync(kFull, bad);
}

// The sequences in sm.seq[0..n) against the row so far (the warp): each
// lane takes kPer consecutive sequences. The repeat offsets before a
// lane's first sequence come from a scan of the sequences' repeat-offset
// maps, the literal and output positions and the record places from
// scans of their sums; then each lane steps its sequences through the
// checks of _fsm_walk's sequence mode and writes their records. false
// when a check fails or the budget is spent.
__device__ bool Walk::flush(int n, int lt, int lbase, int lsrc, int lrsz,
                            int& lpos) {
  __syncwarp();
  const int j0 = lane * kPer, j1 = min(j0 + kPer, n);
  const bool rle = lt == 1;
  // each sequence's fields: its three extra-bit fields, read from the row
  // at the bit position the decoder recorded (57 bits at most below it)
  int vof[kPer], vll[kPer], vml[kPer];
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    vof[i] = vll[i] = vml[i] = 0;
    if (j0 + i < j1) {
      const unsigned long long v = sm.seq[j0 + i];
      const int q = (int)(uint32_t)v, codes = (int)(v >> 32);
      const int ofc = codes & 31, mlc = (codes >> 5) & 63, llc = codes >> 11;
      const int x0 = first_byte(q);
      const unsigned long long c = rd.load8(x0);
      const int p1 = q - ofc, p2 = p1 - kMLBits[mlc];
      vof[i] = (1 << ofc) + take(c, x0, q, ofc);
      vml[i] = kMLBase[mlc] + take(c, x0, p1, kMLBits[mlc]);
      vll[i] = kLLBase[llc] + take(c, x0, p2, kLLBits[llc]);
    }
  }
  RepMap m = rep_identity();
  int sll = 0, sout = 0, srec = 0;
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    if (j0 + i < j1) {
      const int ll = vll[i], ml = vml[i];
      m = rep_then(m, rep_of(vof[i], ll));
      sll += ll;
      sout += ll + ml;
      srec += (ll > 0) + (rle && ll > 1) + (ml > 0);
    }
  }
  const int ill = warp_incl_scan(sll), iout = warp_incl_scan(sout);
  const int irec = warp_incl_scan(srec);
  RepMap im = m;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    RepMap u;
    u.src = __shfl_up_sync(kFull, im.src, o);
    u.a0 = __shfl_up_sync(kFull, im.a0, o);
    u.a1 = __shfl_up_sync(kFull, im.a1, o);
    u.a2 = __shfl_up_sync(kFull, im.a2, o);
    if (lane >= o) im = rep_then(u, im);
  }
  RepMap em;
  em.src = __shfl_up_sync(kFull, im.src, 1);
  em.a0 = __shfl_up_sync(kFull, im.a0, 1);
  em.a1 = __shfl_up_sync(kFull, im.a1, 1);
  em.a2 = __shfl_up_sync(kFull, im.a2, 1);
  if (lane == 0) em = rep_identity();
  int r1 = rep1, r2 = rep2, r3 = rep3;
  rep_apply(em, r1, r2, r3);
  int lp = lpos + ill - sll, o = op + iout - sout, k = nrec + irec - srec;
  bool bad = false;
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    if (j0 + i >= j1) break;
    const int ofv = vof[i], ll = vll[i], ml = vml[i];
    int off;
    if (ofv > 3) {
      off = ofv - 3;
      r3 = r2;
      r2 = r1;
      r1 = off;
    } else {
      const int idx = ofv - 1 + (ll == 0);
      off = idx == 0 ? r1 : idx == 1 ? r2 : idx == 2 ? r3 : r1 - 1;
      bad |= off <= 0;
      if (idx >= 2) r3 = r2;
      if (idx >= 1) {
        r2 = r1;
        r1 = off;
      }
    }
    bad |= (lp + ll > lrsz) | (o + ll + ml > out_len) | (off > o + ll);
    const int a = lt >= 2 ? lbase + lp : TW + lsrc + lp;
    if (ll > 0) put(0, rle ? TW + lsrc : a, o, rle ? 1 : ll, k++);
    if (rle && ll > 1) put(1, 1, o + 1, ll - 1, k++);
    if (ml > 0) put(1, off, o + ll, ml, k++);
    lp += ll;
    o += ll + ml;
  }
  if (__any_sync(kFull, bad)) return false;
  rep1 = __shfl_sync(kFull, r1, 31);
  rep2 = __shfl_sync(kFull, r2, 31);
  rep3 = __shfl_sync(kFull, r3, 31);
  const int trec = __shfl_sync(kFull, irec, 31);
  lpos += __shfl_sync(kFull, ill, 31);
  op += __shfl_sync(kFull, iout, 31);
  nrec += trec;
  nev += trec;
  nseq += n;
  return nev <= E && nrec <= RC;
}

// A sequence section's bitstream [pos, bend) with the tables of logs:
// lane 0 decodes up to kSeqBuf sequences at a time into sm.seq, through
// the ring over the whole sequence stream, and the warp flushes them;
// then the literals after the last sequence. false when the row errs.
__device__ bool Walk::sequences(int nbseq, int pos, int bend, const int* logs,
                                int lt, int lbase, int lsrc, int lrsz) {
  const int lb = rd.byte(bend - 1);
  if (lb == 0 || bend <= pos) return false;
  const int q0 = pos * 8;
  int lls = 0, ofs = 0, mls = 0, left = nbseq;
  bool derr = false;
  const uint32_t *tll = sm.tab(1), *tof = sm.tab(2), *tml = sm.tab(3);
  Back<kChunk> br;
  int q = (bend - 1) * 8 + hb(lb);
  if (lane == 0) {
    br.init(sm.ring, rd.s, rd.W, bend - 1);
    const int lll = logs[1], ofl = logs[2], mll = logs[3];
    const int x0 = first_byte(q);   // the three states: 26 bits at most
    br.need(x0);
    const unsigned long long c = br.load8(x0);
    lls = take(c, x0, q, lll);
    ofs = take(c, x0, q - lll, ofl);
    mls = take(c, x0, q - lll - ofl, mll);
    q -= lll + ofl + mll;
    derr = q < q0;
  }
  int lpos = 0;
  bool ok = true;
  for (;;) {
    int n = 0;
    if (lane == 0 && !derr) {
      // a step: the three cells, the record of the step (the flush reads
      // its extra bits, 57 at most, back from the row), the next states
      const int cnt = min(left, kSeqBuf);
      while (n < cnt) {
        if (left == 1) {            // the last sequence reads no states
          const uint32_t co = tof[ofs & 255], cm = tml[mls & 511];
          const uint32_t cl = tll[lls & 511];
          const int ofc = c_sym(co), mlc = c_sym(cm), llc = c_sym(cl);
          derr = (ofc > 25) | (mlc > 52) | (llc > 35);
          sm.seq[n++] = (unsigned long long)(uint32_t)q |
                        (unsigned long long)(ofc | mlc << 5 | llc << 11) << 32;
          q -= ofc + c_xb(cm) + c_xb(cl);
          left = 0;
          break;
        }
        // a group of steps with one ring check and the code and cursor
        // checks folded into one flag: a step past a failed check reads
        // only what the ring holds, and the row errs anyway
        const int g = min(min(cnt - n, left - 1), kGroup);
        br.need(first_byte(q) - (83 * kGroup + 7) / 8);
        bool bad = false;
        for (int i = 0; i < g; ++i) {
          const int x0 = first_byte(q);
          const unsigned long long c = br.load8(x0);
          const uint32_t co = tof[ofs & 255], cm = tml[mls & 511];
          const uint32_t cl = tll[lls & 511];
          const int ofc = c_sym(co), mlc = c_sym(cm), llc = c_sym(cl);
          bad |= (ofc > 25) | (mlc > 52) | (llc > 35);
          sm.seq[n + i] = (unsigned long long)(uint32_t)q |
                          (unsigned long long)(ofc | mlc << 5 | llc << 11) << 32;
          const int p3 = q - ofc - c_xb(cm) - c_xb(cl);
          const int nbl = c_nb(cl), nbm = c_nb(cm), nbo = c_nb(co);
          unsigned long long d = c;
          int y0 = x0;
          if (nbl + nbm + nbo > p3 - 8 * x0) {  // the states need a refill
            y0 = first_byte(p3);
            d = br.load8(y0);
          }
          const int p4 = p3 - nbl, p5 = p4 - nbm;
          lls = c_base(cl) + take(d, y0, p3, nbl);
          mls = c_base(cm) + take(d, y0, p4, nbm);
          ofs = c_base(co) + take(d, y0, p5, nbo);
          q = p5 - nbo;
          bad |= q < q0;
        }
        n += g;
        left -= g;
        if (bad) {
          derr = true;
          break;
        }
      }
    }
    __syncwarp();
    n = __shfl_sync(kFull, n, 0);
    derr = __shfl_sync(kFull, derr, 0);
    left = __shfl_sync(kFull, left, 0);
    if (derr) {
      ok = false;
      break;
    }
    if (n > 0 && !flush(n, lt, lbase, lsrc, lrsz, lpos)) {
      ok = false;
      break;
    }
    if (left == 0) break;
  }
  if (lane == 0) br.drain();
  __syncwarp();
  if (!ok) return false;
  q = __shfl_sync(kFull, q, 0);
  if (q != q0 || op + (lrsz - lpos) > out_len) return false;
  if (!emit_lits(lt, lbase, lsrc, lpos, lrsz - lpos)) return false;
  op += lrsz - lpos;
  return true;
}

__device__ bool Walk::run(int& tlen) {
  // ---- frame header ------------------------------------------------------
  if (cs <= 0) return false;
  const unsigned magic = (unsigned)rd.byte(0) | ((unsigned)rd.byte(1) << 8) |
                         ((unsigned)rd.byte(2) << 16) | ((unsigned)rd.byte(3) << 24);
  const int fhd = rd.byte(4);
  if (magic != 0xFD2FB528u || (fhd & 8) || (fhd & 3)) return false;
  const int single = (fhd >> 5) & 1, fl = fhd >> 6;
  int pos = 6 - single + (fl == 0 ? single : fl == 1 ? 2 : fl == 2 ? 4 : 8);

  int hK = 0;                       // Huffman table log, 0 until a tree
  int logs[4] = {0, 0, 0, 0};       // accuracy logs by table id
  for (;;) {
    // ---- block header ----------------------------------------------------
    const int bh = rd.byte(pos) | (rd.byte(pos + 1) << 8) | (rd.byte(pos + 2) << 16);
    const bool last = bh & 1;
    const int btype = (bh >> 1) & 3, bsize = bh >> 3;
    if (btype == 3 || pos + 3 > cs) return false;
    if (btype == 0) {
      if (op + bsize > out_len || pos + 3 + bsize > cs) return false;
      if (bsize > 0 && !emit(0, TW + pos + 3, op, bsize)) return false;
      op += bsize;
      pos += 3 + bsize;
      if (last) break;
      continue;
    }
    if (btype == 1) {
      if (op + bsize > out_len || pos + 4 > cs || bsize < 1) return false;
      if (!emit(0, TW + pos + 3, op, 1)) return false;
      if (bsize > 1 && !emit(1, 1, op + 1, bsize - 1)) return false;
      op += bsize;
      pos += 4;
      if (last) break;
      continue;
    }
    if (pos + 3 + bsize > cs || bsize < 2) return false;
    const int bend = pos + 3 + bsize;
    pos += 3;
    // ---- literals section header ------------------------------------------
    const int b0 = rd.byte(pos), b1 = rd.byte(pos + 1), b2 = rd.byte(pos + 2);
    const int b3 = rd.byte(pos + 3), b4 = rd.byte(pos + 4);
    const int lt = b0 & 3, sf = (b0 >> 2) & 3;
    const bool rawrle = lt <= 1;
    int lrsz, lsrc = 0, lbase = 0;
    if (rawrle) {
      const int rs = (sf & 1) == 0 ? b0 >> 3
                     : sf == 1     ? (b0 >> 4) | (b1 << 4)
                                   : (b0 >> 4) | (b1 << 4) | (b2 << 12);
      const int h = (sf & 1) == 0 ? 1 : sf == 1 ? 2 : 3;
      const int adv = lt == 0 ? h + rs : h + 1;
      if (rs > out_len || pos + adv > bend) return false;
      lrsz = rs;
      lsrc = pos + h;
      pos += adv;
    } else {
      const int rs = sf <= 1 ? (b0 >> 4) | ((b1 & 0x3F) << 4)
                     : sf == 2 ? (b0 >> 4) | (b1 << 4) | ((b2 & 3) << 12)
                               : (b0 >> 4) | (b1 << 4) | ((b2 & 0x3F) << 12);
      const int csz = sf <= 1 ? (b1 >> 6) | (b2 << 2)
                      : sf == 2 ? (b2 >> 2) | (b3 << 6)
                                : (b2 >> 6) | (b3 << 2) | (b4 << 10);
      const int h = sf <= 1 ? 3 : sf == 2 ? 4 : 5;
      const int lcend = pos + h + csz;
      if (rs > out_len || lcend > bend || csz < 1 || (lt == 3 && hK == 0))
        return false;
      lrsz = rs;
      pos += h;
      // ---- Huffman tree description --------------------------------------
      if (lt == 2) {
        const int hby = rd.byte(pos);
        int nw;
        __syncwarp();
        for (int i = lane; i < 256; i += 32) sm.warr[i] = 0;
        __syncwarp();
        if (hby >= 128) {
          nw = hby - 127;
          if (lane == 0) {
            for (int i = 0; i < nw; ++i) {
              const int b = rd.byte(pos + 1 + (i >> 1));
              sm.warr[i] = (uint8_t)((i & 1) == 0 ? b >> 4 : b & 15);
            }
          }
          pos += 1 + ((nw + 1) >> 1);
        } else {
          const int hwend = pos + 1 + hby;
          if (hwend > lcend || hby < 1) return false;
          int wlog;
          if (!ncount((pos + 1) * 8, 0, wlog, pos)) return false;
          if (!fse_build(0, wlog)) return false;
          const int lb = rd.byte(hwend - 1);
          if (lb == 0 || hwend <= pos) return false;
          int hwp = (hwend - 1) * 8 + hb(lb);
          const int hwp0 = pos * 8;
          int st[2];
          st[0] = rd.back(hwp, wlog);
          st[1] = rd.back(hwp - wlog, wlog);
          hwp -= 2 * wlog;
          const uint32_t* tw = sm.tab(0);
          int widx = 0;
          for (;;) {
            if (widx >= 254) return false;
            const int e = widx & 1;
            const uint32_t c = tw[min(max(st[e], 0), 63)];
            if (lane == 0) sm.warr[widx] = (uint8_t)c_sym(c);
            const int nst = c_base(c) + rd.back(hwp, c_nb(c));
            const int hpn = hwp - c_nb(c);
            if (hpn < hwp0) {
              if (lane == 0)
                sm.warr[widx + 1] = (uint8_t)c_sym(tw[min(max(st[e ^ 1], 0), 63)]);
              nw = widx + 2;
              break;
            }
            st[e] = nst;
            hwp = hpn;
            ++widx;
          }
          pos = hwend;
        }
        __syncwarp();
        if (!huf_build(nw, hK)) return false;
      }
      // ---- literal streams ---------------------------------------------
      const bool four = sf != 0;
      const int j1 = rd.byte(pos) | (rd.byte(pos + 1) << 8);
      const int j2 = rd.byte(pos + 2) | (rd.byte(pos + 3) << 8);
      const int j3 = rd.byte(pos + 4) | (rd.byte(pos + 5) << 8);
      const int sbase = four ? pos + 6 : pos;
      const int tot = lcend - sbase, s4 = tot - j1 - j2 - j3;
      const int r13 = (lrsz + 3) >> 2, r4 = lrsz - 3 * r13;
      if (four && (s4 < 1 || j1 < 1 || j2 < 1 || j3 < 1 || r4 < 0)) return false;
      if (tot < 1) return false;
      // the tape holds out_len bytes, and every byte is an event
      if (tl + lrsz > TW || nev + lrsz > E) return false;
      for (int k = 0; k < 4; ++k) {
        const int start = k == 0 ? sbase : k == 1 ? sbase + j1
                          : k == 2 ? sbase + j1 + j2 : sbase + j1 + j2 + j3;
        const int size = k == 0 ? (four ? j1 : tot) : k == 1 ? j2 : k == 2 ? j3 : s4;
        const int r = k == 0 ? (four ? r13 : lrsz) : !four ? 0 : k < 3 ? r13 : r4;
        if (r > 0 && (rd.byte(start + size - 1) == 0 || size < 1)) return false;
      }
      __syncwarp();
      if (!literals(four, sbase, tot, j1, j2, j3, lrsz, hK)) return false;
      lbase = tl;
      tl += lrsz;
      nev += lrsz;
      pos = lcend;
    }
    // ---- sequences section header -------------------------------------------
    const int n0 = rd.byte(pos), n1 = rd.byte(pos + 1), n2 = rd.byte(pos + 2);
    const int nbseq = n0 < 128 ? n0 : n0 < 255 ? ((n0 - 128) << 8) + n1 : n1 + (n2 << 8) + 0x7F00;
    const int nbadv = n0 < 128 ? 1 : n0 < 255 ? 2 : 3;
    if (nbseq == 0) {
      if (pos + nbadv != bend || op + lrsz > out_len) return false;
      if (!emit_lits(lt, lbase, lsrc, 0, lrsz)) return false;
      op += lrsz;
    } else {
      const int smod = rd.byte(pos + nbadv);
      if (smod & 3) return false;
      pos += nbadv + 1;
      // ---- the three table modes (LL, OF, ML) ---------------------------
      for (int tid = 1; tid <= 3; ++tid) {
        const int msel = (smod >> (8 - 2 * tid)) & 3;
        if (msel == 0) {
          predefined(tid);
          logs[tid] = tid == 2 ? 5 : 6;
        } else if (msel == 1) {
          const int rsym = rd.byte(pos);
          if (rsym > kMaxSym[tid]) return false;
          const uint32_t cellv = (uint32_t)rsym | (xbits(tid, rsym) << 25);
          __syncwarp();
          for (int i = lane; i < kTabW[tid]; i += 32) sm.tab(tid)[i] = cellv;
          __syncwarp();
          logs[tid] = 0;
          pos += 1;
        } else if (msel == 2) {
          int acc;
          if (!ncount(pos * 8, tid, acc, pos)) return false;
          if (!fse_build(tid, acc)) return false;
          logs[tid] = acc;
        }                           // 3: repeat, table and log carried
      }
      __syncwarp();
      if (!sequences(nbseq, pos, bend, logs, lt, lbase, lsrc, lrsz)) return false;
    }
    // ---- end of the block ---------------------------------------------------
    pos = bend;
    if (last) break;
  }
  tlen = tl;
  return op == out_len;
}

__global__ void __launch_bounds__(kThreads, 16)
zstd_walk_kernel(const uint8_t* __restrict__ slots, int N, int W,
                 const int32_t* __restrict__ csizes, int out_len, int E, int RC,
                 uint8_t* __restrict__ tape, int32_t* __restrict__ tlen_out,
                 int32_t* __restrict__ kind, int32_t* __restrict__ arg,
                 int32_t* __restrict__ dst, int32_t* __restrict__ len,
                 uint8_t* __restrict__ ok_out, int32_t* __restrict__ stats) {
  __shared__ __align__(16) Smem sm;
  const int lane = threadIdx.x;
  const long long row = blockIdx.x;
  Walk w(Row{slots + row * (long long)W, W}, sm, lane);
  w.out_len = out_len;
  w.TW = out_len;
  w.E = E;
  w.RC = RC;
  w.cs = csizes[row];
  w.tp = tape + row * (long long)out_len;
  const long long rb = row * (long long)RC;
  w.kind = kind + rb;
  w.arg = arg + rb;
  w.dst = dst + rb;
  w.len = len + rb;
  int tl = 0;
  const bool ok = w.run(tl);
  __syncwarp();
  const int nrec = ok ? w.nrec : 0;
  if (!ok) tl = 0;
  // the kind -1 / zero tail of the record columns: to a multiple of 4 one
  // by one, then 16-byte stores (RC is a multiple of 32)
  const int r4 = min((nrec + 3) & ~3, RC);
  for (int i = nrec + lane; i < r4; i += kThreads) {
    w.kind[i] = -1;
    w.arg[i] = 0;
    w.dst[i] = 0;
    w.len[i] = 0;
  }
  const int4 neg = make_int4(-1, -1, -1, -1), zero = make_int4(0, 0, 0, 0);
  for (int i = r4 + 4 * lane; i < RC; i += 4 * kThreads) {
    *reinterpret_cast<int4*>(w.kind + i) = neg;
    *reinterpret_cast<int4*>(w.arg + i) = zero;
    *reinterpret_cast<int4*>(w.dst + i) = zero;
    *reinterpret_cast<int4*>(w.len + i) = zero;
  }
  // the tape's zeros past tl: bytes to a 16-byte boundary, 16-byte stores,
  // the last bytes
  const uintptr_t t0 = (uintptr_t)(w.tp + tl), t1 = (uintptr_t)(w.tp + out_len);
  const uintptr_t up = (t0 + 15) & ~(uintptr_t)15, down = t1 & ~(uintptr_t)15;
  const uintptr_t a0 = up < t1 ? up : t1;
  const uintptr_t a1 = down > a0 ? down : a0;
  for (uintptr_t p = t0 + lane; p < a0; p += kThreads)
    *reinterpret_cast<uint8_t*>(p) = 0;
  for (uintptr_t p = a0 + 16 * lane; p < a1; p += 16 * kThreads)
    *reinterpret_cast<int4*>(p) = zero;
  for (uintptr_t p = a1 + lane; p < t1; p += kThreads)
    *reinterpret_cast<uint8_t*>(p) = 0;
  if (lane == 0) {
    tlen_out[row] = tl;
    ok_out[row] = ok ? 1 : 0;
    if (stats) stats[row] = w.nseq;
  }
}

}  // namespace

extern "C" int zstd_walk_launch(const void* slots, int N, int W,
                                const void* csizes, int out_len, int E, int RC,
                                void* tape, void* tlen, void* kind, void* arg,
                                void* dst, void* len, void* ok, void* stats,
                                void* stream) {
  // 16-byte stores of the record tails need a row stride that keeps them
  // aligned
  if (RC % 4 != 0) return (int)cudaErrorInvalidValue;
  if (N > 0) {
    // all of the SM's shared memory for CTAs: sixteen rows to an SM
    cudaFuncSetAttribute(zstd_walk_kernel,
                         cudaFuncAttributePreferredSharedMemoryCarveout,
                         cudaSharedmemCarveoutMaxShared);
    zstd_walk_kernel<<<N, kThreads, 0, (cudaStream_t)stream>>>(
        (const uint8_t*)slots, N, W, (const int32_t*)csizes, out_len, E, RC,
        (uint8_t*)tape, (int32_t*)tlen, (int32_t*)kind, (int32_t*)arg,
        (int32_t*)dst, (int32_t*)len, (uint8_t*)ok, (int32_t*)stats);
  }
  return (int)cudaGetLastError();
}
