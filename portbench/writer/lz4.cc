// Frozen copy of cblosc_tpu_torch/native/src/lz4.cc for the benchmark's
// chunk writer (writer.cc); never edited to follow the original.
// LZ4 block format codec, native implementation.
//
// Same wire format as cblosc_tpu_torch/ops/codecs/lz4.py (the public LZ4 block
// format used by the reference's wrappers, blosc/blosc.c:412-440).
// Fresh C++: greedy encoder with skip acceleration, hash-chain HC
// encoder, and a bounds-checked decoder.

#include "common.h"

#include <vector>

namespace cbt {

namespace {

constexpr int kMinMatch = 4;
constexpr int kMFLimit = 12;      // no match may start in the last 12 bytes
constexpr int kLastLiterals = 5;  // final 5 bytes must be literals
constexpr int kMaxOffset = 65535;
constexpr int kHashLog = 16;

inline uint32_t hash4(uint32_t v) {
  return (v * 2654435761u) >> (32 - kHashLog);
}

inline int64_t prefix_len(const uint8_t* a, const uint8_t* b, int64_t limit) {
  int64_t n = 0;
  while (n + 8 <= limit) {
    uint64_t x = load_u64(a + n) ^ load_u64(b + n);
    if (x) return n + (__builtin_ctzll(x) >> 3);
    n += 8;
  }
  while (n < limit && a[n] == b[n]) n++;
  return n;
}

// Emit one sequence; returns nullptr on overflow.
uint8_t* emit_sequence(uint8_t* op, uint8_t* op_limit, const uint8_t* lit,
                       int64_t litlen, int offset, int64_t mlen) {
  int64_t ml = mlen - kMinMatch;
  int64_t need = 1 + litlen + litlen / 255 + 2 + ml / 255 + 2;
  if (op + need > op_limit) return nullptr;
  uint8_t* token = op++;
  if (litlen >= 15) {
    *token = 15 << 4;
    int64_t rem = litlen - 15;
    for (; rem >= 255; rem -= 255) *op++ = 255;
    *op++ = (uint8_t)rem;
  } else {
    *token = (uint8_t)(litlen << 4);
  }
  std::memcpy(op, lit, litlen);
  op += litlen;
  *op++ = (uint8_t)(offset & 255);
  *op++ = (uint8_t)(offset >> 8);
  if (ml >= 15) {
    *token |= 15;
    int64_t rem = ml - 15;
    for (; rem >= 255; rem -= 255) *op++ = 255;
    *op++ = (uint8_t)rem;
  } else {
    *token |= (uint8_t)ml;
  }
  return op;
}

uint8_t* emit_last_literals(uint8_t* op, uint8_t* op_limit, const uint8_t* lit,
                            int64_t litlen) {
  int64_t need = 1 + litlen + litlen / 255 + 1;
  if (op + need > op_limit) return nullptr;
  if (litlen >= 15) {
    *op++ = 15 << 4;
    int64_t rem = litlen - 15;
    for (; rem >= 255; rem -= 255) *op++ = 255;
    *op++ = (uint8_t)rem;
  } else {
    *op++ = (uint8_t)(litlen << 4);
  }
  std::memcpy(op, lit, litlen);
  return op + litlen;
}

}  // namespace

int lz4_encode(const uint8_t* src, int length, uint8_t* dst, int maxout,
               int accel) {
  uint8_t* op = dst;
  uint8_t* op_limit = dst + maxout;
  if (length == 0) {
    if (maxout < 1) return 0;
    *op = 0;
    return 1;
  }
  if (accel < 1) accel = 1;
  int64_t anchor = 0;
  if (length >= kMFLimit + 1) {
    static thread_local int32_t htab[1 << kHashLog];
    std::memset(htab, -1, sizeof(htab));
    int64_t limit = length - kMFLimit;
    int64_t matchlimit = length - kLastLiterals;
    int64_t ip = 0;
    for (;;) {
      // search with skip acceleration (lz4.c:1021-1034): first advance is
      // always 1, then stride `accel` growing every 64 probes; probe only
      // while the NEXT position stays inside mflimit+1 (byte parity with
      // the numpy oracle's schedule)
      int64_t attempts = (int64_t)accel << 6;
      int64_t step = 1;
      int64_t fwd = ip;
      int64_t ref = -1;
      for (;;) {
        int64_t pos = fwd;
        fwd += step;
        step = attempts >> 6;
        attempts++;
        if (fwd > limit + 1) break;
        uint32_t h = hash4(load_u32(src + pos));
        int64_t cand = htab[h];
        htab[h] = (int32_t)pos;
        if (cand >= 0 && pos - cand <= kMaxOffset &&
            load_u32(src + cand) == load_u32(src + pos)) {
          ref = cand;
          ip = pos;
          break;
        }
      }
      if (ref < 0) break;
      while (ip > anchor && ref > 0 && src[ip - 1] == src[ref - 1]) {
        ip--;
        ref--;
      }
      int64_t mlen =
          kMinMatch + prefix_len(src + ip + kMinMatch, src + ref + kMinMatch,
                                 matchlimit - (ip + kMinMatch));
      op = emit_sequence(op, op_limit, src + anchor, ip - anchor,
                         (int)(ip - ref), mlen);
      if (!op) return 0;
      ip += mlen;
      anchor = ip;
      if (ip >= limit) break;
      htab[hash4(load_u32(src + ip - 2))] = (int32_t)(ip - 2);
    }
  }
  op = emit_last_literals(op, op_limit, src + anchor, length - anchor);
  return op ? (int)(op - dst) : 0;
}

int lz4hc_encode(const uint8_t* src, int length, uint8_t* dst, int maxout,
                 int clevel) {
  uint8_t* op = dst;
  uint8_t* op_limit = dst + maxout;
  if (length == 0) {
    if (maxout < 1) return 0;
    *op = 0;
    return 1;
  }
  int depth = 1 << (clevel < 16 ? clevel : 16);
  int64_t anchor = 0;
  if (length >= kMFLimit + 1) {
    std::vector<int32_t> head((size_t)1 << kHashLog, -1);
    std::vector<int32_t> chain((size_t)length, -1);
    int64_t limit = length - kMFLimit;
    int64_t matchlimit = length - kLastLiterals;
    // insertion watermark: positions < nexti are in the chains once
    int64_t nexti = 0;

    // LAZY matching (defer while a strictly longer match starts at the
    // next position) — byte parity with ops/codecs/lz4.py:compress_hc
    auto best_at = [&](int64_t pos, int64_t* best_ref) -> int64_t {
      while (nexti < pos) {
        uint32_t h = hash4(load_u32(src + nexti));
        chain[nexti] = head[h];
        head[h] = (int32_t)nexti;
        nexti++;
      }
      int64_t cand = head[hash4(load_u32(src + pos))];
      int64_t best_len = 0;
      *best_ref = -1;
      int tries = depth;
      int64_t maxm = matchlimit - pos;
      while (cand >= 0 && pos - cand <= kMaxOffset && tries > 0) {
        tries--;
        if (pos + best_len < matchlimit &&
            src[cand + best_len] == src[pos + best_len]) {
          int64_t m = prefix_len(src + pos, src + cand, maxm);
          if (m > best_len) {
            best_len = m;
            *best_ref = cand;
          }
        }
        cand = chain[cand];
      }
      return best_len;
    };

    int64_t ip = 0;
    while (ip < limit) {
      int64_t best_ref;
      int64_t best_len = best_at(ip, &best_ref);
      if (best_len < kMinMatch) {
        ip++;
        continue;
      }
      while (ip + 1 < limit) {
        int64_t r2;
        int64_t l2 = best_at(ip + 1, &r2);
        if (l2 > best_len) {
          ip++;
          best_len = l2;
          best_ref = r2;
        } else {
          break;
        }
      }
      int64_t ref = best_ref;
      while (ip > anchor && ref > 0 && src[ip - 1] == src[ref - 1]) {
        ip--;
        ref--;
        best_len++;
      }
      op = emit_sequence(op, op_limit, src + anchor, ip - anchor,
                         (int)(ip - ref), best_len);
      if (!op) return 0;
      ip += best_len;
      anchor = ip;
    }
  }
  op = emit_last_literals(op, op_limit, src + anchor, length - anchor);
  return op ? (int)(op - dst) : 0;
}

int lz4_decode(const uint8_t* src, int length, uint8_t* dst, int maxout) {
  const uint8_t* ip = src;
  const uint8_t* ip_end = src + length;
  uint8_t* op = dst;
  uint8_t* op_end = dst + maxout;
  while (ip < ip_end) {
    uint32_t token = *ip++;
    int64_t litlen = token >> 4;
    if (litlen == 15) {
      uint8_t c;
      do {
        if (ip >= ip_end) return -1;
        c = *ip++;
        litlen += c;
      } while (c == 255);
    }
    if (ip + litlen > ip_end || op + litlen > op_end) return -1;
    std::memcpy(op, ip, litlen);
    ip += litlen;
    op += litlen;
    if (ip >= ip_end) break;  // final sequence: literals only
    if (ip + 2 > ip_end) return -1;
    int64_t offset = ip[0] | ((int64_t)ip[1] << 8);
    ip += 2;
    if (offset == 0 || offset > op - dst) return -1;
    int64_t mlen = token & 15;
    if (mlen == 15) {
      uint8_t c;
      do {
        if (ip >= ip_end) return -1;
        c = *ip++;
        mlen += c;
      } while (c == 255);
    }
    mlen += kMinMatch;
    if (op + mlen > op_end) return -1;
    const uint8_t* ref = op - offset;
    if (offset == 1) {
      std::memset(op, *ref, mlen);
      op += mlen;
    } else if (offset >= mlen) {
      std::memcpy(op, ref, mlen);
      op += mlen;
    } else {
      for (int64_t i = 0; i < mlen; ++i) op[i] = ref[i];
      op += mlen;
    }
  }
  return (int)(op - dst);
}

}  // namespace cbt

// Registration with the benchmark's writer (registry.h), not in the
// original: LZ4 at c-blosc's acceleration 10 - clevel, LZ4HC at clevel
// (blosc.c:412-440), one wire format (compformat 1), LZ4HC an HCR codec.

#include "registry.h"

namespace {

int lz4_at(int clevel, const uint8_t* src, int n, uint8_t* dst, int maxout) {
  return cbt::lz4_encode(src, n, dst, maxout, 10 - clevel);
}

int lz4hc_at(int clevel, const uint8_t* src, int n, uint8_t* dst,
             int maxout) {
  return cbt::lz4hc_encode(src, n, dst, maxout, clevel);
}

[[maybe_unused]] const bool registered =
    pbw::add_codec({"lz4", 1, false, true, lz4_at}) &&
    pbw::add_codec({"lz4hc", 1, true, true, lz4hc_at});

}  // namespace
