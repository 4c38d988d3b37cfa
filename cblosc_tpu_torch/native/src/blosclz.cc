// BloscLZ codec, native implementation.
//
// Same wire format and search policy as the Python oracle
// (cblosc_tpu_torch/ops/codecs/blosclz.py; format derivation documented
// there, reference spec blosc/blosclz.c). Fresh C++ with 64-bit-word scans.

#include "common.h"

namespace cbt {

namespace {

constexpr unsigned kMaxCopy = 32;
constexpr unsigned kMaxDist = 8191;
constexpr unsigned kMaxFarDist = 65535 + kMaxDist - 1;
constexpr int kHashLog = 14;
constexpr int kHashLog2 = 12;

inline uint32_t hash_of(uint32_t seq, int log) {
  return (seq * 2654435761u) >> (32 - log);
}

// Match scan: count equal bytes of src[a..] vs src[b..]; on mismatch the
// cursor lands one PAST the mismatching byte; never passes `bound`.
inline int64_t scan_match(const uint8_t* src, int64_t a, int64_t b,
                          int64_t bound) {
  int64_t ip = a;
  int64_t ref = b;
  while (ip + 8 < bound) {
    if (load_u64(src + ref) != load_u64(src + ip)) {
      while (src[ref++] == src[ip++]) {
      }
      return ip;
    }
    ip += 8;
    ref += 8;
  }
  while (ip < bound && src[ref++] == src[ip++]) {
  }
  // mirror the reference's asymmetry: the bounded tail loop also steps
  // one past a mismatch (the final failing compare still incremented)
  return ip;
}

// Run scan: count bytes in src[b..] equal to x; stops AT the first
// non-run byte (no step-past), never passes `bound` (counted on cursor a).
inline int64_t scan_run(const uint8_t* src, int64_t a, int64_t b,
                        int64_t bound, uint8_t x) {
  int64_t ip = a;
  int64_t ref = b;
  uint64_t pat;
  std::memset(&pat, x, 8);
  while (ip + 8 < bound) {
    if (load_u64(src + ref) != pat) {
      while (ip < bound && src[ref++] == x) ip++;
      return ip;
    }
    ip += 8;
    ref += 8;
  }
  while (ip < bound && src[ref++] == x) ip++;
  return ip;
}

// Entropy probe on the tail quarter (cf. blosclz.py::_probe_cratio).
double probe_cratio(const uint8_t* base, int maxlen) {
  const int hashlen = 1 << kHashLog2;
  int limit = maxlen > hashlen ? hashlen : maxlen;
  int64_t bound = limit - 1;
  int64_t stop = limit - 12;
  uint16_t htab[1 << kHashLog2];
  std::memset(htab, 0, sizeof(htab));

  int64_t oc = 5;
  unsigned copy = 4;
  int64_t ip = 0;
  while (ip < stop) {
    int64_t anchor = ip;
    uint32_t seq = load_u32(base + ip);
    uint32_t h = hash_of(seq, kHashLog2);
    int64_t ref = htab[h];
    int64_t distance = anchor - ref;
    htab[h] = (uint16_t)anchor;

    bool matched = distance != 0 && distance < kMaxFarDist &&
                   load_u32(base + ref) == seq;
    if (!matched) {
      oc++;
      ip = anchor + 1;
      if (++copy == kMaxCopy) {
        copy = 0;
        oc++;
      }
      continue;
    }
    ip = anchor + 4;
    distance--;
    ip = distance == 0 ? scan_run(base, ip, ref + 4, bound, base[ip - 1])
                       : scan_match(base, ip, ref + 4, bound);
    ip -= 3;  // probe ipshift
    int64_t len = ip - anchor;
    if (len < 3) {  // probe minlen
      oc++;
      ip = anchor + 1;
      if (++copy == kMaxCopy) {
        copy = 0;
        oc++;
      }
      continue;
    }
    if (!copy) oc--;
    copy = 0;
    if (len >= 7) oc += (len - 7) / 255 + 1;
    oc += distance < kMaxDist ? 2 : 4;
    seq = load_u32(base + ip);
    htab[hash_of(seq, kHashLog2)] = (uint16_t)ip;
    ip += 2;
    oc++;
  }
  return (double)ip / (double)oc;
}

}  // namespace

int blosclz_encode(int clevel, const uint8_t* src, int length, uint8_t* dst,
                   int maxout, bool split) {
  if (length < 16 || maxout < 66) return 0;

  static const double kCratioMin[10] = {0,   2,   1.5, 1.2,  1.2,
                                        1.2, 1.2, 1.15, 1.1, 1.0};
  int maxlen = length / 4;
  double cratio = probe_cratio(src + (length - maxlen), maxlen);
  if (cratio < kCratioMin[clevel]) return 0;

  int ipshift = (!split || cratio < 4) ? 3 : 4;
  int minlen = ipshift;

  static const int kHashlogTab[10] = {0,  kHashLog - 2, kHashLog - 1,
                                      kHashLog, kHashLog, kHashLog,
                                      kHashLog, kHashLog, kHashLog, kHashLog};
  int hashlog = kHashlogTab[clevel];
  static thread_local uint32_t htab[1 << kHashLog];
  std::memset(htab, 0, sizeof(uint32_t) << hashlog);

  int64_t ip = 4;
  int64_t bound = length - 1;
  int64_t stop = length - 12;
  uint8_t* op = dst;
  uint8_t* op_limit = dst + maxout;
  unsigned copy = 4;

  *op++ = kMaxCopy - 1;
  std::memcpy(op, src, 4);
  op += 4;

  while (ip < stop) {
    int64_t anchor = ip;
    uint32_t seq = load_u32(src + ip);
    uint32_t h = hash_of(seq, hashlog);
    int64_t ref = htab[h];
    int64_t distance = anchor - ref;
    htab[h] = (uint32_t)anchor;

    if (distance == 0 || distance >= kMaxFarDist ||
        load_u32(src + ref) != seq) {
      if (op + 2 > op_limit) return 0;
      *op++ = src[anchor];
      ip = anchor + 1;
      if (++copy == kMaxCopy) {
        copy = 0;
        *op++ = kMaxCopy - 1;
      }
      continue;
    }

    ip = anchor + 4;
    distance--;
    ip = distance == 0 ? scan_run(src, ip, ref + 4, bound, src[ip - 1])
                       : scan_match(src, ip, ref + 4, bound);
    ip -= ipshift;
    int64_t len = ip - anchor;
    if (len < minlen || (len <= 5 && distance >= kMaxDist)) {
      if (op + 2 > op_limit) return 0;
      *op++ = src[anchor];
      ip = anchor + 1;
      if (++copy == kMaxCopy) {
        copy = 0;
        *op++ = kMaxCopy - 1;
      }
      continue;
    }

    // patch or drop the pending literal control byte
    if (copy) {
      *(op - copy - 1) = (uint8_t)(copy - 1);
    } else {
      op--;
    }
    copy = 0;

    if (distance < kMaxDist) {
      if (len < 7) {
        if (op + 2 > op_limit) return 0;
        *op++ = (uint8_t)((len << 5) + (distance >> 8));
        *op++ = (uint8_t)(distance & 255);
      } else {
        int64_t rem = len - 7;
        if (op + 3 + rem / 255 > op_limit) return 0;
        *op++ = (uint8_t)((7u << 5) + (distance >> 8));
        for (; rem >= 255; rem -= 255) *op++ = 255;
        *op++ = (uint8_t)rem;
        *op++ = (uint8_t)(distance & 255);
      }
    } else {
      int64_t dfar = distance - kMaxDist;
      if (len < 7) {
        if (op + 4 > op_limit) return 0;
        *op++ = (uint8_t)((len << 5) + 31);
        *op++ = 255;
        *op++ = (uint8_t)(dfar >> 8);
        *op++ = (uint8_t)(dfar & 255);
      } else {
        int64_t rem = len - 7;
        if (op + 5 + rem / 255 > op_limit) return 0;
        *op++ = (7u << 5) + 31;
        for (; rem >= 255; rem -= 255) *op++ = 255;
        *op++ = (uint8_t)rem;
        *op++ = 255;
        *op++ = (uint8_t)(dfar >> 8);
        *op++ = (uint8_t)(dfar & 255);
      }
    }

    seq = load_u32(src + ip);
    htab[hash_of(seq, hashlog)] = (uint32_t)ip;
    ip++;
    if (clevel == 9) {
      seq >>= 8;
      htab[hash_of(seq, hashlog)] = (uint32_t)ip;
    }
    ip++;

    if (op + 1 > op_limit) return 0;
    *op++ = kMaxCopy - 1;
  }

  while (ip <= bound) {
    if (op + 2 > op_limit) return 0;
    *op++ = src[ip++];
    if (++copy == kMaxCopy) {
      copy = 0;
      *op++ = kMaxCopy - 1;
    }
  }
  if (copy) {
    *(op - copy - 1) = (uint8_t)(copy - 1);
  } else {
    op--;
  }

  dst[0] |= 1u << 5;
  return (int)(op - dst);
}

int blosclz_decode(const uint8_t* src, int length, uint8_t* dst, int maxout) {
  if (length <= 0) return 0;
  const uint8_t* ip = src;
  const uint8_t* ip_end = src + length;
  uint8_t* op = dst;
  uint8_t* op_end = dst + maxout;
  uint32_t token = (uint32_t)(*ip++) & 31u;

  for (;;) {
    if (token >= 32) {
      int64_t mlen = (token >> 5) - 1;
      uint32_t dhi = token & 31u;
      if (mlen == 6) {
        uint8_t c;
        do {
          if (ip + 1 >= ip_end) return -1;
          c = *ip++;
          mlen += c;
        } while (c == 255);
      } else {
        if (ip + 1 >= ip_end) return -1;
      }
      uint32_t dlo = *ip++;
      mlen += 3;
      int64_t back = ((int64_t)dhi << 8) + dlo + 1;
      if (dlo == 255 && dhi == 31) {
        if (ip + 1 >= ip_end) return -1;
        back = ((int64_t)ip[0] << 8) + ip[1] + kMaxDist + 1;
        ip += 2;
      }
      if (op + mlen > op_end) return -1;
      if (back > op - dst) return -1;
      if (ip >= ip_end) break;  // a valid stream never ends on a match
      token = *ip++;

      const uint8_t* ref = op - back;
      if (back == 1) {
        std::memset(op, *ref, mlen);
        op += mlen;
      } else if (back >= mlen) {
        // disjoint: wide copies are safe
        std::memcpy(op, ref, mlen);
        op += mlen;
      } else {
        for (int64_t i = 0; i < mlen; ++i) op[i] = ref[i];
        op += mlen;
      }
    } else {
      uint32_t llen = token + 1;
      if (op + llen > op_end) return -1;
      if (ip + llen > ip_end) return -1;
      std::memcpy(op, ip, llen);
      op += llen;
      ip += llen;
      if (ip >= ip_end) break;
      token = *ip++;
    }
  }
  return (int)(op - dst);
}

}  // namespace cbt
