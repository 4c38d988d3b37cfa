// The benchmark's frozen C-blosc-format chunk writer: the chunk framing.
//
// A frozen copy of the compress path of the port's native host engine
// (cblosc_tpu_torch/native/src/engine.cc: compute_blocksize, split_block,
// compress_block, cbt_compress_chunk), which writes the bytes c-blosc
// 1.x's blosc_compress writes with its automatic blocksize. The read
// cells decode chunks written here, so that no change to the program can
// change what they read. Differences from the original: one thread (no
// worker pool), the forward-compatible split mode only, and no codec or
// filter named here: each is found by the configuration's name among
// those its source registers (registry.h), with the properties the
// framing needs (compformat, the HCR blocksize, whether it splits).

#include "common.h"
#include "registry.h"

#include <vector>

namespace cbt {
namespace {

using pbw::Codec;
using pbw::Filter;

// c-blosc's forward-compatible split rule (kForwardCompatSplit)
bool split_block(const Codec& codec, int typesize, int blocksize) {
  return codec.split && typesize <= kMaxSplits &&
         blocksize / typesize >= kMinBufferSize;
}

int64_t compute_blocksize(int clevel, int typesize, int64_t nbytes,
                          const Codec& codec) {
  if (nbytes < typesize) return 1;
  int64_t bs = nbytes;
  if (nbytes >= kL1) {
    bs = kL1;
    if (codec.hcr) bs *= 2;
    switch (clevel) {
      case 0: bs /= 4; break;
      case 1: bs /= 2; break;
      case 2: break;
      case 3: bs *= 2; break;
      case 4:
      case 5: bs *= 4; break;
      case 6:
      case 7:
      case 8: bs *= 8; break;
      case 9:
        bs *= 8;
        if (codec.hcr) bs *= 2;
        break;
    }
  }
  if (clevel > 0 && split_block(codec, typesize, (int)bs)) {
    if (bs > (1 << 18)) bs = 1 << 18;
    bs *= typesize;
    if (bs < (1 << 16)) bs = 1 << 16;
    if (bs > (1 << 20)) bs = 1 << 20;
  }
  if (bs > nbytes) bs = nbytes;
  if (bs > typesize) bs = bs / typesize * typesize;
  return bs;
}

// Per-block compression (role of blosc_c, blosc.c:591-722). Returns the
// encoded size, or -1 when the block does not fit its budget.
int64_t compress_block(const Codec& codec, const Filter& filter, int clevel,
                       int typesize, bool dont_split, const uint8_t* block,
                       int64_t bsize, bool leftover, uint8_t* out,
                       int64_t budget, uint8_t* tmp, uint8_t* tmp2) {
  const uint8_t* filtered = block;
  if (filter.apply && filter.apply(typesize, bsize, block, tmp, tmp2))
    filtered = tmp;
  int nsplits = (dont_split || leftover) ? 1 : typesize;
  int64_t neblock = bsize / nsplits;
  int64_t pos = 0;
  for (int s = 0; s < nsplits; ++s) {
    int64_t maxout = neblock;
    int64_t remaining = budget - pos - 4;
    if (maxout > remaining) maxout = remaining;
    if (maxout <= 0) return -1;
    const uint8_t* stream = filtered + s * neblock;
    int cbytes = codec.encode(clevel, stream, (int)neblock, out + pos + 4,
                              (int)maxout);
    if (cbytes < 0) return -1;
    if (cbytes == 0 || cbytes == neblock) {
      if (pos + 4 + neblock > budget) return -1;
      std::memcpy(out + pos + 4, stream, neblock);
      cbytes = (int)neblock;
    }
    store_i32(out + pos, cbytes);
    pos += 4 + cbytes;
  }
  return pos;
}

}  // namespace
}  // namespace cbt

extern "C" {

// Compress a buffer into one chunk with c-blosc's automatic blocksize
// and split rule, by the configuration's filter (shuffle) and codec
// (cname). Returns cbytes, 0 when the data does not fit destsize, or a
// negative error code (-2: a codec no source registers, -3: a filter
// none registers).
int64_t pbw_compress_chunk(int clevel, const char* filter_name, int typesize,
                           const uint8_t* src, int64_t nbytes,
                           uint8_t* dst, int64_t destsize,
                           const char* codec_name) {
  using namespace cbt;
  if (clevel < 0 || clevel > 9 || typesize <= 0) return -10;
  if (destsize < kMaxOverhead) return -10;
  const pbw::Codec* codec = pbw::find_codec(codec_name);
  if (!codec) return -2;
  const pbw::Filter* filter = pbw::find_filter(filter_name);
  if (!filter) return -3;
  if (typesize > kMaxTypesize) typesize = 1;
  if (destsize > nbytes + kMaxOverhead) destsize = nbytes + kMaxOverhead;

  int64_t blocksize = compute_blocksize(clevel, typesize, nbytes, *codec);
  int64_t nblocks = blocksize > 0 ? nbytes / blocksize : 0;
  int64_t leftover = blocksize > 0 ? nbytes % blocksize : 0;
  if (leftover) nblocks++;

  bool memcpyed = (clevel == 0) || (nbytes < kMinBufferSize);
  bool dont_split = !split_block(*codec, typesize, (int)blocksize);
  uint8_t flags = filter->flag;
  if (dont_split) flags |= kDontSplit;
  flags |= codec->compformat << 5;

  auto write_header = [&](uint8_t fl, int64_t cbytes) {
    dst[0] = 2;  // chunk format version
    dst[1] = 1;  // codec format version (all codecs are at 1)
    dst[2] = fl;
    dst[3] = (uint8_t)typesize;
    store_i32(dst + 4, (int32_t)nbytes);
    store_i32(dst + 8, (int32_t)blocksize);
    store_i32(dst + 12, (int32_t)cbytes);
  };
  auto memcpy_path = [&]() -> int64_t {
    int64_t cbytes = nbytes + kMaxOverhead;
    if (cbytes > destsize) return 0;
    write_header(flags | kMemcpyed, cbytes);
    std::memcpy(dst + kHeaderLen, src, nbytes);
    return cbytes;
  };
  if (memcpyed) return memcpy_path();

  // Per-block worst-case budget (cf. ebsize, blosc.c:1745).
  int64_t budget = blocksize + 4 * (int64_t)typesize;
  std::vector<uint8_t> scratch((size_t)(nblocks * budget));
  std::vector<int64_t> sizes((size_t)nblocks, -1);
  std::vector<uint8_t> tl((size_t)(2 * blocksize));
  bool ok = true;
  for (int64_t j = 0; j < nblocks && ok; ++j) {
    int64_t bsize = blocksize;
    bool lob = false;
    if (j == nblocks - 1 && leftover) {
      bsize = leftover;
      lob = true;
    }
    int64_t n = compress_block(*codec, *filter, clevel, typesize, dont_split,
                               src + j * blocksize, bsize, lob,
                               scratch.data() + j * budget, budget, tl.data(),
                               tl.data() + blocksize);
    sizes[(size_t)j] = n;
    ok = n >= 0;
  }
  if (ok) {
    int64_t total = kHeaderLen + 4 * nblocks;
    for (int64_t j = 0; j < nblocks; ++j) total += sizes[(size_t)j];
    if (total <= destsize) {
      write_header(flags, total);
      int64_t pos = kHeaderLen + 4 * nblocks;
      for (int64_t j = 0; j < nblocks; ++j) {
        store_i32(dst + kHeaderLen + 4 * j, (int32_t)pos);
        std::memcpy(dst + pos, scratch.data() + j * budget, sizes[(size_t)j]);
        pos += sizes[(size_t)j];
      }
      return total;
    }
  }
  // Last chance: verbatim copy (blosc.c:1264-1272).
  if (nbytes + kMaxOverhead <= destsize) return memcpy_path();
  return 0;
}

}  // extern "C"
