// zstd walk kernel (K7): parse zstd frames into a Huffman-literal tape and
// compacted placement records, one warp per row.
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
// ok reports tlen 0, no records and a zero tape.
//
// What bounds it on an H100: latency. zstd's literal streams and its
// sequence stream are bit-serial: each symbol's position is known only
// after the previous one is decoded, so a row is one chain of dependent
// steps, and the bytes moved (the stream, the tape, 16 bytes per record)
// take microseconds at 3.35 TB/s. This first kernel is simple and right:
// the 32 lanes of a warp run the same scalar state machine on one row
// (each stream byte read through the read-only path, a broadcast), lanes
// 0-3 decode the four Huffman streams of a literal section at once, each
// into its own stretch of the tape, and lane 0 writes the records. The
// row's FSE tables (LL and ML 512 cells, OF 256, Huffman weights 64) and
// its direct Huffman table (2^K <= 2048 cells) live in shared memory,
// about 10 KB a row, four rows to a CTA; tables are built on lane 0 by
// the RFC's sequential spread. A launch lasts as long as its longest
// row's chain: a 256 KB row of the bench data at clevel 5 is about 6,600
// sequences, at clevel 1 about 12,300 Huffman literals.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 4;           // rows per CTA
constexpr unsigned kFull = 0xffffffffu;

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

// an FSE cell: symbol | nb << 8 | base << 16
__device__ __forceinline__ int c_sym(uint32_t c) { return c & 0xFF; }
__device__ __forceinline__ int c_nb(uint32_t c) { return (c >> 8) & 0xFF; }
__device__ __forceinline__ int c_base(uint32_t c) { return c >> 16; }

__device__ __forceinline__ int hb(int x) { return x > 1 ? 31 - __clz(x) : 0; }

struct RowSmem {
  uint32_t cells[1344];             // FSE tables by id at kTabOff: weights
                                    // (64 cells), LL (512), OF (256), ML (512)
  uint16_t huf[2048];               // direct Huffman table: sym | nb << 8
  int16_t ncount[64];               // normalized counts being read
  int16_t nxt[64];                  // build scratch: next state per symbol
  uint8_t warr[256];                // Huffman weights
  __device__ uint32_t* tab(int tid) { return cells + kTabOff[tid]; }
};

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
};

struct Walk {
  Row rd;
  RowSmem& sm;
  int lane, out_len, TW, E, RC, cs;
  uint8_t* tp;
  int32_t *kind, *arg, *dst, *len;
  int op = 0, tl = 0, nev = 0, nrec = 0;

  __device__ Walk(Row r, RowSmem& m, int ln) : rd(r), sm(m), lane(ln) {}

  // a record, unless the budget or the record columns are spent
  __device__ bool emit(int k, int a, int d, int n) {
    if (nev >= E || nrec >= RC) return false;
    if (lane == 0) {
      kind[nrec] = k;
      arg[nrec] = a;
      dst[nrec] = d;
      len[nrec] = n;
    }
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
  // false when the spread's live cells differ in number from the counts
  __device__ bool fse_build(int tid, int acc) {
    __syncwarp();
    const int size = 1 << acc;
    int nlow = 0, tot = 0;
    for (int s = 0; s < 64; ++s) {
      const int c = sm.ncount[s];
      nlow += c == -1;
      tot += c > 0 ? c : 0;
    }
    if (size - nlow != tot) return false;
    uint32_t* t = sm.tab(tid);
    if (lane == 0) {
      int high = size - 1;
      for (int s = 0; s < 64; ++s)
        if (sm.ncount[s] == -1) t[high--] = s;
      const int step = (size >> 1) + (size >> 3) + 3, mask = size - 1;
      int p = 0;
      for (int s = 0; s < 64; ++s) {
        for (int i = 0; i < sm.ncount[s]; ++i) {
          t[p] = s;
          p = (p + step) & mask;
          while (p > high) p = (p + step) & mask;
        }
      }
      for (int s = 0; s < 64; ++s) {
        const int c = sm.ncount[s];
        sm.nxt[s] = (int16_t)(c == -1 ? 1 : c > 0 ? c : 0);
      }
      for (int u = 0; u < size; ++u) {
        const int s = t[u] & 0xFF;
        const int ns = sm.nxt[s]++;
        const int nb = acc - hb(ns);
        t[u] = (uint32_t)s | ((uint32_t)nb << 8) |
               ((uint32_t)((ns << nb) - size) << 16);
      }
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
  // last one (4.2.1, _huf_build): cells in (weight, symbol) order
  __device__ bool huf_build(int nw, int& K) {
    __syncwarp();
    int total0 = 0;
    bool big = false;
    for (int s = 0; s < nw; ++s) {
      const int w = sm.warr[s];
      if (w > 0) total0 += 1 << min(w - 1, 11);
      big |= w > 11;
    }
    K = hb(max(total0, 1)) + 1;
    const int rest = (1 << K) - total0;
    if (total0 < 1 || rest < 1 || (rest & (rest - 1)) || K > 11 || nw > 255 || big)
      return false;
    if (lane == 0) sm.warr[nw] = (uint8_t)(hb(rest) + 1);
    __syncwarp();
    int p = 0;
    for (int w = 1; w <= K; ++w) {
      const int span = 1 << (w - 1);
      const uint16_t cellv = (uint16_t)((K + 1 - w) << 8);
      for (int s = 0; s <= nw; ++s) {
        if (sm.warr[s] != w) continue;
        for (int j = lane; j < span; j += 32) sm.huf[p + j] = cellv | s;
        p += span;
      }
    }
    __syncwarp();
    return true;
  }

  __device__ bool run(int& tlen);
};

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
  int rep1 = 1, rep2 = 4, rep3 = 8;
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
      int sp = 0, sbit = 0, st = 0, sr = 0;     // this lane's stream
      bool bad = false;
      for (int k = 0; k < 4; ++k) {
        const int start = k == 0 ? sbase : k == 1 ? sbase + j1
                          : k == 2 ? sbase + j1 + j2 : sbase + j1 + j2 + j3;
        const int size = k == 0 ? (four ? j1 : tot) : k == 1 ? j2 : k == 2 ? j3 : s4;
        const int r = k == 0 ? (four ? r13 : lrsz) : !four ? 0 : k < 3 ? r13 : r4;
        const int lastb = rd.byte(start + size - 1);
        if (r > 0 && (lastb == 0 || size < 1)) bad = true;
        if (lane == k) {
          sp = r > 0 ? (start + size - 1) * 8 + hb(max(lastb, 1)) : start * 8;
          sbit = start * 8;
          st = tl + k * r13 * (four ? 1 : 0);
          sr = r;
        }
      }
      if (bad) return false;
      lbase = tl;
      tl += lrsz;
      nev += lrsz;
      pos = lcend;
      // lanes 0-3 decode one stream each, backward, straight into the tape
      const int shift = 11 - hK;
      for (; sr > 0; --sr) {
        const int v = rd.bits(sp - 11, 11) >> shift;
        const uint16_t c = sm.huf[v];
        if ((c >> 8) == 0) {
          bad = true;
          break;
        }
        tp[st++] = (uint8_t)(c & 0xFF);
        sp -= c >> 8;
      }
      if (sp != sbit) bad = true;
      if (__ballot_sync(kFull, bad)) return false;
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
          __syncwarp();
          for (int i = lane; i < kTabW[tid]; i += 32) sm.tab(tid)[i] = (uint32_t)rsym;
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
      // ---- sequence bitstream -------------------------------------------
      const int lb = rd.byte(bend - 1);
      if (lb == 0 || bend <= pos) return false;
      int q = (bend - 1) * 8 + hb(lb);
      const int lll = logs[1], ofl = logs[2], mll = logs[3];
      int lls = rd.back(q, lll);
      int ofs = rd.back(q - lll, ofl);
      int mls = rd.back(q - lll - ofl, mll);
      q -= lll + ofl + mll;
      const int q0 = pos * 8;
      if (q < q0) return false;
      const uint32_t *tll = sm.tab(1), *tof = sm.tab(2), *tml = sm.tab(3);
      int lpos = 0;
      for (int left = nbseq; left > 0; --left) {
        const uint32_t co = tof[min(max(ofs, 0), 255)];
        const uint32_t cm = tml[min(max(mls, 0), 511)];
        const uint32_t cl = tll[min(max(lls, 0), 511)];
        const int ofc = c_sym(co), mlc = c_sym(cm), llc = c_sym(cl);
        if (ofc > 25 || mlc > 52 || llc > 35) return false;
        const int ofv = (1 << ofc) + rd.back(q, ofc);
        const int p1 = q - ofc;
        const int ml = kMLBase[mlc] + rd.back(p1, kMLBits[mlc]);
        const int p2 = p1 - kMLBits[mlc];
        const int ll = kLLBase[llc] + rd.back(p2, kLLBits[llc]);
        const int p3 = p2 - kLLBits[llc];
        int off;
        if (ofv > 3) {
          off = ofv - 3;
          rep3 = rep2;
          rep2 = rep1;
          rep1 = off;
        } else {
          const int idx = ofv - 1 + (ll == 0);
          off = idx == 0 ? rep1 : idx == 1 ? rep2 : idx == 2 ? rep3 : rep1 - 1;
          if (off <= 0) return false;
          if (idx >= 2) rep3 = rep2;
          if (idx >= 1) {
            rep2 = rep1;
            rep1 = off;
          }
        }
        if (lpos + ll > lrsz || op + ll + ml > out_len || off > op + ll) return false;
        if (!emit_lits(lt, lbase, lsrc, lpos, ll)) return false;
        if (ml > 0 && !emit(1, off, op + ll, ml)) return false;
        op += ll + ml;
        lpos += ll;
        if (left > 1) {
          lls = c_base(cl) + rd.back(p3, c_nb(cl));
          const int p4 = p3 - c_nb(cl);
          mls = c_base(cm) + rd.back(p4, c_nb(cm));
          const int p5 = p4 - c_nb(cm);
          ofs = c_base(co) + rd.back(p5, c_nb(co));
          q = p5 - c_nb(co);
          if (q < q0) return false;
        } else {
          q = p3;
        }
      }
      if (q != q0 || op + (lrsz - lpos) > out_len) return false;
      if (!emit_lits(lt, lbase, lsrc, lpos, lrsz - lpos)) return false;
      op += lrsz - lpos;
    }
    // ---- end of the block ---------------------------------------------------
    pos = bend;
    if (last) break;
  }
  tlen = tl;
  return op == out_len;
}

__global__ void __launch_bounds__(kWarps * 32)
zstd_walk_kernel(const uint8_t* __restrict__ slots, int N, int W,
                 const int32_t* __restrict__ csizes, int out_len, int E, int RC,
                 uint8_t* __restrict__ tape, int32_t* __restrict__ tlen_out,
                 int32_t* __restrict__ kind, int32_t* __restrict__ arg,
                 int32_t* __restrict__ dst, int32_t* __restrict__ len,
                 uint8_t* __restrict__ ok_out) {
  __shared__ RowSmem smem[kWarps];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long row = (long long)blockIdx.x * kWarps + warp;
  if (row >= N) return;             // warp-uniform: no block barrier below
  Walk w(Row{slots + row * (long long)W, W}, smem[warp], lane);
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
  for (int i = nrec + lane; i < RC; i += 32) {
    w.kind[i] = -1;
    w.arg[i] = 0;
    w.dst[i] = 0;
    w.len[i] = 0;
  }
  for (int i = tl + lane; i < out_len; i += 32) w.tp[i] = 0;
  if (lane == 0) {
    tlen_out[row] = tl;
    ok_out[row] = ok ? 1 : 0;
  }
}

}  // namespace

extern "C" int zstd_walk_launch(const void* slots, int N, int W,
                                const void* csizes, int out_len, int E, int RC,
                                void* tape, void* tlen, void* kind, void* arg,
                                void* dst, void* len, void* ok, void* stream) {
  if (N > 0) {
    zstd_walk_kernel<<<(N + kWarps - 1) / kWarps, kWarps * 32, 0,
                       (cudaStream_t)stream>>>(
        (const uint8_t*)slots, N, W, (const int32_t*)csizes, out_len, E, RC,
        (uint8_t*)tape, (int32_t*)tlen, (int32_t*)kind, (int32_t*)arg,
        (int32_t*)dst, (int32_t*)len, (uint8_t*)ok);
  }
  return (int)cudaGetLastError();
}
