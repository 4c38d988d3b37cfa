// External-format codecs for the native host engine: zlib, zstd, snappy.
//
// zlib/zstd mirror the reference's one-shot wrappers (blosc/blosc.c:
// 469-522: compress2/uncompress, ZSTD_compress with clevel 1-8 ->
// 2*clevel-1 and 9 -> maxCLevel). zstd resolves at runtime via dlopen of
// the path the binding hands to cbt_set_zstd_path, the library the numpy
// engine loaded (cblosc_tpu_torch/ops/codecs/zstd_.py): libzstd versions
// write different bytes, so both engines bind the same code. Snappy is a
// fresh C++ implementation of the public raw format, algorithmically
// identical to the numpy oracle (cblosc_tpu_torch/ops/codecs/snappy.py)
// so the two produce the same bytes: 14-bit multiplicative hash table,
// no skip acceleration, the same literal/copy emission rules.

#include "common.h"

#include <vector>

#ifdef CBT_HAVE_ZLIB
#include <zlib.h>
#endif

#ifdef CBT_HAVE_DLOPEN
#include <dlfcn.h>
#include <mutex>
#include <string>
#endif

namespace cbt {

// ---------------------------------------------------------------------
// zlib (system library; CPython's zlib module links the same one)
// ---------------------------------------------------------------------

int zlib_encode(int clevel, const uint8_t* src, int n, uint8_t* dst,
                int maxout) {
#ifdef CBT_HAVE_ZLIB
  uLongf cl = (uLongf)maxout;
  int status = compress2((Bytef*)dst, &cl, (const Bytef*)src, (uLong)n,
                         clevel);
  if (status != Z_OK) return 0;
  return (int)cl;
#else
  (void)clevel; (void)src; (void)n; (void)dst; (void)maxout;
  return -2;
#endif
}

int zlib_decode(const uint8_t* src, int len, uint8_t* dst, int maxout) {
#ifdef CBT_HAVE_ZLIB
  uLongf ul = (uLongf)maxout;
  int status = uncompress((Bytef*)dst, &ul, (const Bytef*)src, (uLong)len);
  if (status != Z_OK) return 0;
  return (int)ul;
#else
  (void)src; (void)len; (void)dst; (void)maxout;
  return -2;
#endif
}

bool zlib_available() {
#ifdef CBT_HAVE_ZLIB
  return true;
#else
  return false;
#endif
}

// ---------------------------------------------------------------------
// zstd (runtime-resolved; cbt_set_zstd_path names the library)
// ---------------------------------------------------------------------

#ifdef CBT_HAVE_DLOPEN
namespace {
typedef size_t (*zstd_compress_t)(void*, size_t, const void*, size_t, int);
typedef size_t (*zstd_decompress_t)(void*, size_t, const void*, size_t);
typedef unsigned (*zstd_iserror_t)(size_t);
typedef int (*zstd_maxclevel_t)(void);

// The library cbt_set_zstd_path named before the first zstd call; none
// (or an empty name) leaves zstd unavailable, as the numpy engine is
// without libzstd.
std::string g_zstd_path;

struct ZstdApi {
  zstd_compress_t compress = nullptr;
  zstd_decompress_t decompress = nullptr;
  zstd_iserror_t iserror = nullptr;
  zstd_maxclevel_t maxclevel = nullptr;
};

const ZstdApi& zstd_api() {
  static ZstdApi api;
  static std::once_flag once;
  std::call_once(once, [] {
    if (g_zstd_path.empty()) return;
    void* h = dlopen(g_zstd_path.c_str(), RTLD_NOW | RTLD_LOCAL);
    if (!h) return;
    api.compress = (zstd_compress_t)dlsym(h, "ZSTD_compress");
    api.decompress = (zstd_decompress_t)dlsym(h, "ZSTD_decompress");
    api.iserror = (zstd_iserror_t)dlsym(h, "ZSTD_isError");
    api.maxclevel = (zstd_maxclevel_t)dlsym(h, "ZSTD_maxCLevel");
    if (!api.compress || !api.decompress || !api.iserror || !api.maxclevel) {
      api = ZstdApi{};
    }
  });
  return api;
}
}  // namespace
#endif  // CBT_HAVE_DLOPEN

void set_zstd_path(const char* path) {
#ifdef CBT_HAVE_DLOPEN
  g_zstd_path = path ? path : "";
#else
  (void)path;
#endif
}

bool zstd_available() {
#ifdef CBT_HAVE_DLOPEN
  return zstd_api().compress != nullptr;
#else
  return false;
#endif
}

int zstd_encode(int clevel, const uint8_t* src, int n, uint8_t* dst,
                int maxout) {
#ifdef CBT_HAVE_DLOPEN
  const ZstdApi& api = zstd_api();
  if (!api.compress) return -2;
  int level = clevel < 9 ? clevel * 2 - 1 : api.maxclevel();
  size_t code = api.compress(dst, (size_t)maxout, src, (size_t)n, level);
  if (api.iserror(code)) return 0;
  return (int)code;
#else
  (void)clevel; (void)src; (void)n; (void)dst; (void)maxout;
  return -2;
#endif
}

int zstd_decode(const uint8_t* src, int len, uint8_t* dst, int maxout) {
#ifdef CBT_HAVE_DLOPEN
  const ZstdApi& api = zstd_api();
  if (!api.decompress) return -2;
  size_t code = api.decompress(dst, (size_t)maxout, src, (size_t)len);
  if (api.iserror(code)) return 0;
  return (int)code;
#else
  (void)src; (void)len; (void)dst; (void)maxout;
  return -2;
#endif
}

// ---------------------------------------------------------------------
// Snappy raw format (public spec; emission mirrors ops/codecs/snappy.py)
// ---------------------------------------------------------------------

namespace {

constexpr int kSnapHashLog = 14;
constexpr uint32_t kSnapHashMult = 0x1E35A7BDu;

inline uint32_t u32at(const uint8_t* a, int64_t i) {
  uint32_t v;
  std::memcpy(&v, a + i, 4);
  return v;
}

struct Sink {
  uint8_t* dst;
  int64_t cap;
  int64_t pos = 0;
  bool overflow = false;

  void put(uint8_t b) {
    if (pos >= cap) { overflow = true; return; }
    dst[pos++] = b;
  }
  void put_le(uint64_t v, int nbytes) {
    for (int i = 0; i < nbytes; ++i) put((uint8_t)(v >> (8 * i)));
  }
  void put_bytes(const uint8_t* p, int64_t n) {
    if (pos + n > cap) { overflow = true; pos = cap; return; }
    std::memcpy(dst + pos, p, (size_t)n);
    pos += n;
  }
};

void snap_emit_literal(Sink& out, const uint8_t* a, int64_t start,
                       int64_t end) {
  int64_t n = end - start;
  if (n == 0) return;
  if (n <= 60) {
    out.put((uint8_t)((n - 1) << 2));
  } else {
    uint64_t v = (uint64_t)(n - 1);
    int extra = 0;
    for (uint64_t t = v; t; t >>= 8) extra++;
    out.put((uint8_t)((59 + extra) << 2));
    out.put_le(v, extra);
  }
  out.put_bytes(a + start, n);
}

void snap_emit_copy(Sink& out, int64_t offset, int64_t length) {
  if (offset > 0xFFFF) {
    while (length > 64) {
      out.put((63 << 2) | 3);
      out.put_le((uint64_t)offset, 4);
      length -= 64;
    }
    if (length) {
      out.put((uint8_t)(((length - 1) << 2) | 3));
      out.put_le((uint64_t)offset, 4);
    }
    return;
  }
  while (length >= 68) {
    out.put((63 << 2) | 2);
    out.put_le((uint64_t)offset, 2);
    length -= 64;
  }
  if (length > 64) {
    out.put((59 << 2) | 2);  // 60-byte copy leaves >= 4 for the tail
    out.put_le((uint64_t)offset, 2);
    length -= 60;
  }
  if (4 <= length && length <= 11 && offset < 2048) {
    out.put((uint8_t)(((length - 4) << 2) | ((offset >> 8) << 5) | 1));
    out.put((uint8_t)(offset & 255));
  } else {
    out.put((uint8_t)(((length - 1) << 2) | 2));
    out.put_le((uint64_t)offset, 2);
  }
}

}  // namespace

int snappy_encode(const uint8_t* src, int n, uint8_t* dst, int maxout) {
  Sink out{dst, maxout};
  // uvarint uncompressed length
  uint64_t v = (uint64_t)n;
  while (v >= 0x80) {
    out.put((uint8_t)((v & 0x7F) | 0x80));
    v >>= 7;
  }
  out.put((uint8_t)v);

  std::vector<int64_t> htab((size_t)1 << kSnapHashLog, -1);
  int64_t ip = 0, anchor = 0;
  const int64_t limit = (int64_t)n - 15;
  while (ip < limit) {
    uint32_t h = (u32at(src, ip) * kSnapHashMult) >> (32 - kSnapHashLog);
    int64_t cand = htab[h];
    htab[h] = ip;
    if (cand >= 0 && u32at(src, cand) == u32at(src, ip)) {
      snap_emit_literal(out, src, anchor, ip);
      int64_t lim = n - (ip + 4);
      int64_t ml = 0;
      while (ml < lim && src[ip + 4 + ml] == src[cand + 4 + ml]) ml++;
      int64_t mlen = 4 + ml;
      snap_emit_copy(out, ip - cand, mlen);
      ip += mlen;
      anchor = ip;
    } else {
      ip += 1;
    }
    if (out.overflow) return 0;
  }
  snap_emit_literal(out, src, anchor, n);
  if (out.overflow) return 0;
  return (int)out.pos;
}

int snappy_decode(const uint8_t* src, int len, uint8_t* dst, int maxout) {
  int64_t ip = 0;
  uint64_t total = 0;
  int shift = 0;
  while (true) {
    if (ip >= len || shift > 35) return 0;
    uint8_t b = src[ip++];
    total |= (uint64_t)(b & 0x7F) << shift;
    if (!(b & 0x80)) break;
    shift += 7;
  }
  if ((int64_t)total > maxout) return 0;
  int64_t op = 0;
  while (ip < len) {
    uint8_t tag = src[ip++];
    int kind = tag & 3;
    if (kind == 0) {
      int64_t length = (tag >> 2) + 1;
      if (length > 60) {
        int extra = (int)(length - 60);
        if (ip + extra > len) return 0;
        uint64_t l = 0;
        for (int i = 0; i < extra; ++i) l |= (uint64_t)src[ip + i] << (8 * i);
        length = (int64_t)l + 1;
        ip += extra;
      }
      if (ip + length > len || op + length > (int64_t)total) return 0;
      std::memcpy(dst + op, src + ip, (size_t)length);
      ip += length;
      op += length;
      continue;
    }
    int64_t length, offset;
    if (kind == 1) {
      if (ip >= len) return 0;
      length = ((tag >> 2) & 7) + 4;
      offset = ((int64_t)(tag >> 5) << 8) | src[ip];
      ip += 1;
    } else if (kind == 2) {
      if (ip + 2 > len) return 0;
      length = (tag >> 2) + 1;
      offset = (int64_t)src[ip] | ((int64_t)src[ip + 1] << 8);
      ip += 2;
    } else {
      if (ip + 4 > len) return 0;
      length = (tag >> 2) + 1;
      offset = 0;
      for (int i = 0; i < 4; ++i) offset |= (int64_t)src[ip + i] << (8 * i);
      ip += 4;
    }
    if (offset == 0 || offset > op || op + length > (int64_t)total) return 0;
    const uint8_t* ref = dst + op - offset;
    if (offset >= length) {
      std::memcpy(dst + op, ref, (size_t)length);
    } else {
      for (int64_t i = 0; i < length; ++i) dst[op + i] = ref[i];
    }
    op += length;
  }
  if (op != (int64_t)total) return 0;
  return (int)op;
}

}  // namespace cbt
