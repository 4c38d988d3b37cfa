// zlib walk kernel (K6): parse zlib (DEFLATE) streams into a literal tape
// and compacted placement records, one warp per row.
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
// 3.35 TB/s. This first kernel is simple and correct: the 32 lanes of a
// warp run the same scalar state machine on one row (the stream read
// through the read-only path into a 64-bit bit buffer, each load a
// broadcast) and split the two parallel parts: the canonical-code search,
// lanes 1-15 each testing one code length and a ballot picking the
// shortest hit, and the table builds (counts by shared atomics, first /
// offs by a 15-step scan, the symbol table in (length, symbol) order by a
// per-length prefix count over __match_any_sync groups). Lane 0 writes
// the tape and the records. The row's code lengths and its three tables
// (code-length, literal/length, distance) live in shared memory, about
// 1.7 KB per row; four rows share a CTA. A launch lasts as long as its
// longest row's chain: a dense 128 KB row of the bench data (the plane of
// three random bits a byte) is tens of thousands of symbol steps.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 4;           // rows per CTA
constexpr unsigned kFull = 0xffffffffu;
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

// canonical decode table of one alphabet: per code length b, the first
// code, the number of codes and their offset into the symbol table
struct Table {
  int first[16];
  int cnt[16];
  int offs[16];
};

struct RowSmem {
  Table cl, lit, dist;
  int cur[16];                      // build scratch: symbols placed per length
  uint16_t cls[20], lsym[288], dsym[30];
  uint8_t L[kLMax];                 // literal/length then distance lengths
  uint8_t cll[20];                  // code-length-code lengths
};

// LSB-first bit reader over one row: a 64-bit buffer refilled a byte at a
// time; bytes at or past lim = min(csize, W) read 0
struct Bits {
  const uint8_t* s;
  int lim;
  int next;                         // next byte to load
  unsigned long long buf;
  int nb;                           // valid bits in buf
  int pos;                          // bits consumed
  __device__ int at(int x) const { return x < lim ? (int)__ldg(s + x) : 0; }
  // after refill at least 57 bits are valid: one symbol needs <= 48
  __device__ void refill() {
    while (nb <= 56) {
      buf |= (unsigned long long)at(next) << nb;
      ++next;
      nb += 8;
    }
  }
  __device__ unsigned peek(int off, int n) const {
    return (unsigned)((buf >> off) & ((1ull << n) - 1));
  }
  __device__ void skip(int n) {
    buf >>= n;
    nb -= n;
    pos += n;
  }
};

// One symbol from the low maxbits bits of `bits` (LSB-first stream
// order): lane b (1..maxbits) tests code length b; the shortest hit wins.
// Returns the symbol and sets len (0 and 0 when no length holds the code).
__device__ __forceinline__ int decode(const Table& t, const uint16_t* sym,
                                      int maxbits, unsigned bits, int lane,
                                      int& len) {
  const unsigned rev = __brev(bits) >> (32 - maxbits);
  bool hit = false;
  if (lane >= 1 && lane <= maxbits) {
    const int c = (int)(rev >> (maxbits - lane));
    const int f = t.first[lane], n = t.cnt[lane];
    hit = n > 0 && c >= f && c < f + n;
  }
  const unsigned m = __ballot_sync(kFull, hit);
  if (m == 0) {
    len = 0;
    return 0;
  }
  const int b = __ffs(m) - 1;
  len = b;
  return sym[t.offs[b] + (int)(rev >> (maxbits - b)) - t.first[b]];
}

// Canonical tables from the code lengths L[0..n) (RFC 1951 3.2.2), built
// by the whole warp.
__device__ void build(Table& t, uint16_t* sym, const uint8_t* L, int n,
                      int* cur, int lane) {
  __syncwarp();                     // every lane is done with the old table
  if (lane < 16) {
    t.cnt[lane] = 0;
    cur[lane] = 0;
  }
  __syncwarp();
  for (int i = lane; i < n; i += 32) {
    const int l = L[i];
    if (l) atomicAdd(&t.cnt[l], 1);
  }
  __syncwarp();
  if (lane == 0) {
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
  __syncwarp();
  for (int base = 0; base < n; base += 32) {
    const int i = base + lane;
    const int l = i < n ? L[i] : 0;
    const unsigned same = __match_any_sync(kFull, l);
    if (l) sym[t.offs[l] + cur[l] + __popc(same & ((1u << lane) - 1))] = (uint16_t)i;
    __syncwarp();
    if (l && lane == 31 - __clz(same)) cur[l] += __popc(same);
    __syncwarp();
  }
}

__global__ void __launch_bounds__(kWarps * 32)
zlib_walk_kernel(const uint8_t* __restrict__ slots, int N, int W,
                 const int32_t* __restrict__ csizes, int out_len, int E,
                 uint8_t* __restrict__ tape, int32_t* __restrict__ tlen_out,
                 int32_t* __restrict__ kind, int32_t* __restrict__ arg,
                 int32_t* __restrict__ dst, int32_t* __restrict__ len,
                 int32_t* __restrict__ dist_out, uint8_t* __restrict__ uni_out,
                 uint8_t* __restrict__ ok_out) {
  __shared__ RowSmem smem[kWarps];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long row = (long long)blockIdx.x * kWarps + warp;
  if (row >= N) return;             // warp-uniform: no block barrier below
  RowSmem& sm = smem[warp];
  const int cs = csizes[row];
  Bits br{slots + row * (long long)W, cs < W ? cs : W, 2, 0ull, 0, 16};
  const long long rb = row * (long long)E;
  uint8_t* tp = tape + rb;
  const long long bitlim = 8ll * cs;

  int op = 0, nev = 0, tlen = 0, nrec = 0, dmax = 0, dfirst = 0;
  bool uni = true;
  bool run = false;                 // an open literal run, not yet written
  int run_arg = 0, run_dst = 0, run_len = 0;
  bool err = (br.at(0) & 15) != 8 || (br.at(1) & 0x20) != 0 || cs < 8;
  bool fin = false;

  while (!err && !fin) {
    // ---- block header --------------------------------------------------
    br.refill();
    const unsigned h = br.peek(0, 17);
    const bool final_blk = h & 1;
    const int btype = (h >> 1) & 3;
    if (btype == 0 || btype == 3) {
      err = true;
      break;
    }
    if (btype == 1) {
      br.skip(3);
      for (int i = lane; i < 288 + 30; i += 32)
        sm.L[i] = i < 144 ? 8 : i < 256 ? 9 : i < 280 ? 7 : i < 288 ? 8 : 5;
      build(sm.lit, sm.lsym, sm.L, 288, sm.cur, lane);
      build(sm.dist, sm.dsym, sm.L + 288, 30, sm.cur, lane);
    } else {
      const int hlit = ((h >> 3) & 31) + 257, hdist = ((h >> 8) & 31) + 1;
      const int hclen = ((h >> 13) & 15) + 4;
      br.skip(17);
      __syncwarp();
      for (int i = lane; i < kLMax; i += 32) sm.L[i] = 0;
      if (lane < 19) sm.cll[lane] = 0;
      __syncwarp();
      for (int k = 0; k < hclen; ++k) {
        br.refill();
        if (lane == 0) sm.cll[kClOrder[k]] = (uint8_t)br.peek(0, 3);
        br.skip(3);
      }
      build(sm.cl, sm.cls, sm.cll, 19, sm.cur, lane);
      const int total = hlit + hdist;
      int pos = 0, prev = 0;
      while (pos < total) {
        br.refill();
        const unsigned pk = br.peek(0, 14);
        int clen;
        const int csym = decode(sm.cl, sm.cls, 7, pk & 127, lane, clen);
        const int rbits = csym == 16 ? 2 : csym == 17 ? 3 : csym == 18 ? 7 : 0;
        const int extv = (int)((pk >> clen) & ((1u << rbits) - 1));
        const int rep = csym == 16 || csym == 17 ? 3 + extv
                        : csym == 18             ? 11 + extv
                                                 : 1;
        const int val = csym < 16 ? csym : csym == 16 ? prev : 0;
        if (clen == 0 || pos + rep > total || (csym == 16 && pos == 0)) {
          err = true;
          break;
        }
        for (int i = pos + lane; i < pos + rep; i += 32) sm.L[i] = (uint8_t)val;
        prev = val;
        pos += rep;
        br.skip(clen + rbits);
      }
      if (err) break;
      build(sm.lit, sm.lsym, sm.L, hlit, sm.cur, lane);
      build(sm.dist, sm.dsym, sm.L + hlit, hdist < 30 ? hdist : 30, sm.cur,
            lane);
    }
    // ---- symbols up to the block's EOB ---------------------------------
    for (;;) {
      br.refill();
      int llen;
      const int lsym = decode(sm.lit, sm.lsym, 15, br.peek(0, 15), lane, llen);
      if (llen == 0) {
        err = true;
        break;
      }
      if (lsym < 256) {
        if (br.pos + llen > bitlim || op >= out_len || nev >= E) {
          err = true;
          break;
        }
        if (lane == 0) tp[tlen] = (uint8_t)lsym;
        if (!run) {
          run = true;
          run_arg = tlen;
          run_dst = op;
          run_len = 0;
        }
        ++run_len;
        ++tlen;
        ++nev;
        ++op;
        br.skip(llen);
        continue;
      }
      if (lsym == 256) {
        if (br.pos + llen > bitlim) {
          err = true;
          break;
        }
        br.skip(llen);
        fin = final_blk;
        break;
      }
      if (lsym > 285) {
        err = true;
        break;
      }
      const int li = lsym - 257, lext = kLExtra[li];
      const int mlen = kLBase[li] + (int)br.peek(llen, lext);
      const int b2 = llen + lext;
      int dlen;
      const int dsym =
          decode(sm.dist, sm.dsym, 15, br.peek(b2, 15), lane, dlen);
      if (dlen == 0 || dsym > 29) {
        err = true;
        break;
      }
      const int dext = kDExtra[dsym];
      const int d = kDBase[dsym] + (int)br.peek(b2 + dlen, dext);
      const int adv = b2 + dlen + dext;
      if (br.pos + adv > bitlim || d > op || op + mlen > out_len || nev >= E) {
        err = true;
        break;
      }
      if (run) {
        if (lane == 0) {
          kind[rb + nrec] = 0;
          arg[rb + nrec] = run_arg;
          dst[rb + nrec] = run_dst;
          len[rb + nrec] = run_len;
        }
        ++nrec;
        run = false;
      }
      if (lane == 0) {
        kind[rb + nrec] = 1;
        arg[rb + nrec] = d;
        dst[rb + nrec] = op;
        len[rb + nrec] = mlen;
      }
      ++nrec;
      if (dmax == 0) dfirst = d;
      uni = uni && d == dfirst;
      dmax = d > dmax ? d : dmax;
      op += mlen;
      ++nev;
      br.skip(adv);
    }
  }
  if (run) {
    if (lane == 0) {
      kind[rb + nrec] = 0;
      arg[rb + nrec] = run_arg;
      dst[rb + nrec] = run_dst;
      len[rb + nrec] = run_len;
    }
    ++nrec;
  }
  for (int i = nrec + lane; i < E; i += 32) {
    kind[rb + i] = -1;
    arg[rb + i] = 0;
    dst[rb + i] = 0;
    len[rb + i] = 0;
  }
  for (int i = tlen + lane; i < E; i += 32) tp[i] = 0;
  if (lane == 0) {
    tlen_out[row] = tlen;
    dist_out[row] = dmax;
    uni_out[row] = uni ? 1 : 0;
    ok_out[row] = (!err && op == out_len) ? 1 : 0;
  }
}

}  // namespace

extern "C" int zlib_walk_launch(const void* slots, int N, int W,
                                const void* csizes, int out_len, int E,
                                void* tape, void* tlen, void* kind, void* arg,
                                void* dst, void* len, void* dist, void* uni,
                                void* ok, void* stream) {
  if (N > 0) {
    zlib_walk_kernel<<<(N + kWarps - 1) / kWarps, kWarps * 32, 0,
                       (cudaStream_t)stream>>>(
        (const uint8_t*)slots, N, W, (const int32_t*)csizes, out_len, E,
        (uint8_t*)tape, (int32_t*)tlen, (int32_t*)kind, (int32_t*)arg,
        (int32_t*)dst, (int32_t*)len, (int32_t*)dist, (uint8_t*)uni,
        (uint8_t*)ok);
  }
  return (int)cudaGetLastError();
}
