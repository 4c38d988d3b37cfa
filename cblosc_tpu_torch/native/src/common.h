// cblosc_tpu_torch native host engine — shared definitions.
//
// A fresh C++17 implementation of the host-side compression runtime with
// the same chunk-format semantics as the Python engine (and the reference
// C library it is format-compatible with; see
// cblosc_tpu_torch/format/header.py for the format contract and
// blosc/blosc.c in the reference for the behavioral spec citations).
#pragma once

#include <cstdint>
#include <cstring>
#include <cstddef>

namespace cbt {

// Format constants (must stay in sync with
// cblosc_tpu_torch/format/constants.py).
constexpr int kHeaderLen = 16;
constexpr int kMaxOverhead = 16;
constexpr int kMinBufferSize = 128;
constexpr int kMaxSplits = 16;
constexpr int kL1 = 32 * 1024;
constexpr int kMaxTypesize = 255;

enum Flags : uint8_t {
  kDoShuffle = 0x01,
  kMemcpyed = 0x02,
  kDoBitshuffle = 0x04,
  kReservedBit = 0x08,
  kDontSplit = 0x10,
};

enum Compcode : int {
  kBloscLZ = 0,
  kLZ4 = 1,
  kLZ4HC = 2,
  kSnappy = 3,
  kZlib = 4,
  kZstd = 5,
};

enum SplitMode : int {
  kAlwaysSplit = 1,
  kNeverSplit = 2,
  kAutoSplit = 3,
  kForwardCompatSplit = 4,
};

enum Shuffle : int {
  kNoShuffle = 0,
  kShuffle = 1,
  kBitShuffle = 2,
};

inline int32_t load_i32(const uint8_t* p) {
  int32_t v;
  std::memcpy(&v, p, 4);  // little-endian hosts only (x86/arm LE)
  return v;
}

inline void store_i32(uint8_t* p, int32_t v) { std::memcpy(p, &v, 4); }

inline uint32_t load_u32(const uint8_t* p) {
  uint32_t v;
  std::memcpy(&v, p, 4);
  return v;
}

inline uint64_t load_u64(const uint8_t* p) {
  uint64_t v;
  std::memcpy(&v, p, 8);
  return v;
}

// Filters (filters.cc)
void byte_shuffle(int typesize, int64_t n, const uint8_t* src, uint8_t* dst);
void byte_unshuffle(int typesize, int64_t n, const uint8_t* src, uint8_t* dst);
void bit_shuffle(int typesize, int64_t n, const uint8_t* src, uint8_t* dst,
                 uint8_t* tmp);
void bit_unshuffle(int typesize, int64_t n, const uint8_t* src, uint8_t* dst,
                   uint8_t* tmp);

// Codecs
int blosclz_encode(int clevel, const uint8_t* src, int len, uint8_t* dst,
                   int maxout, bool split);
int blosclz_decode(const uint8_t* src, int len, uint8_t* dst, int maxout);
int lz4_encode(const uint8_t* src, int len, uint8_t* dst, int maxout,
               int accel);
int lz4hc_encode(const uint8_t* src, int len, uint8_t* dst, int maxout,
                 int clevel);
int lz4_decode(const uint8_t* src, int len, uint8_t* dst, int maxout);

// External-format codecs (codecs_ext.cc): zlib/zstd wrappers + a fresh
// snappy raw-format implementation. Encoders return the compressed size,
// 0 on does-not-fit, or -2 when the library is unavailable.
bool zlib_available();
int zlib_encode(int clevel, const uint8_t* src, int n, uint8_t* dst,
                int maxout);
int zlib_decode(const uint8_t* src, int len, uint8_t* dst, int maxout);
void set_zstd_path(const char* path);  // before the first zstd call
bool zstd_available();
int zstd_encode(int clevel, const uint8_t* src, int n, uint8_t* dst,
                int maxout);
int zstd_decode(const uint8_t* src, int len, uint8_t* dst, int maxout);
int snappy_encode(const uint8_t* src, int n, uint8_t* dst, int maxout);
int snappy_decode(const uint8_t* src, int len, uint8_t* dst, int maxout);

inline bool codec_native_available(int compcode) {
  switch (compcode) {
    case kBloscLZ:
    case kLZ4:
    case kLZ4HC:
    case kSnappy:
      return true;
    case kZlib:
      return zlib_available();
    case kZstd:
      return zstd_available();
    default:
      return false;
  }
}

}  // namespace cbt
