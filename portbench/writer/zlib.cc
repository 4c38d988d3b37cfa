// zlib for the benchmark's chunk writer: a frozen copy of zlib_encode
// of the port's native host engine (cblosc_tpu_torch/native/src/
// codecs_ext.cc), c-blosc's zlib_wrap_compress (blosc.c:469-480):
// compress2 at clevel into at most maxout bytes, 0 where it does not
// fit. Linked against the system zlib, as the native engine is.
// portbench-writer-link: -lz

#include "common.h"
#include "registry.h"

#include <zlib.h>

namespace {

int zlib_encode(int clevel, const uint8_t* src, int n, uint8_t* dst,
                int maxout) {
  uLongf cl = (uLongf)maxout;
  int status = compress2((Bytef*)dst, &cl, (const Bytef*)src, (uLong)n,
                         clevel);
  if (status != Z_OK) return 0;
  return (int)cl;
}

// compformat 3 (BLOSC_ZLIB_FORMAT), an HCR codec that splits
[[maybe_unused]] const bool registered =
    pbw::add_codec({"zlib", 3, true, true, zlib_encode});

}  // namespace
