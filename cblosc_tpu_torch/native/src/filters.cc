// Byte-shuffle and bit-shuffle filters (host/native path).
//
// Semantics match cblosc_tpu_torch/ops/filters_np.py (the oracle) and, by
// construction, the reference's generic kernels
// (shuffle-generic.h:32-81, bitshuffle-generic.c:13-220). Written as
// cache-blocked scalar loops that GCC/Clang auto-vectorize; the explicit
// SIMD dispatch of the reference is unnecessary at -O3 -march=native.

#include "common.h"

namespace cbt {

namespace {

// Tiled byte transpose: n = rows*ts bytes, viewed as (rows, ts) -> (ts, rows).
template <int TS>
void shuffle_fixed(int64_t rows, const uint8_t* src, uint8_t* dst) {
  for (int64_t i = 0; i < rows; ++i) {
    const uint8_t* s = src + i * TS;
    for (int j = 0; j < TS; ++j) dst[j * rows + i] = s[j];
  }
}

template <int TS>
void unshuffle_fixed(int64_t rows, const uint8_t* src, uint8_t* dst) {
  for (int64_t i = 0; i < rows; ++i) {
    uint8_t* d = dst + i * TS;
    for (int j = 0; j < TS; ++j) d[j] = src[j * rows + i];
  }
}

// Cache-blocked generic transpose for arbitrary typesize.
void shuffle_generic(int ts, int64_t rows, const uint8_t* src, uint8_t* dst) {
  constexpr int64_t kTile = 256;
  for (int64_t i0 = 0; i0 < rows; i0 += kTile) {
    int64_t i1 = i0 + kTile < rows ? i0 + kTile : rows;
    for (int j = 0; j < ts; ++j) {
      uint8_t* d = dst + (int64_t)j * rows;
      const uint8_t* s = src + j;
      for (int64_t i = i0; i < i1; ++i) d[i] = s[i * ts];
    }
  }
}

void unshuffle_generic(int ts, int64_t rows, const uint8_t* src, uint8_t* dst) {
  constexpr int64_t kTile = 256;
  for (int64_t i0 = 0; i0 < rows; i0 += kTile) {
    int64_t i1 = i0 + kTile < rows ? i0 + kTile : rows;
    for (int j = 0; j < ts; ++j) {
      const uint8_t* s = src + (int64_t)j * rows;
      uint8_t* d = dst + j;
      for (int64_t i = i0; i < i1; ++i) d[i * ts] = s[i];
    }
  }
}

// 8x8 bit-matrix transpose of a 64-bit word (textbook recursive-block
// swap; row r = byte r, column c = bit c, LSB-first).
inline uint64_t transpose8x8(uint64_t x) {
  uint64_t t;
  t = (x ^ (x >> 7)) & 0x00AA00AA00AA00AAull;
  x = x ^ t ^ (t << 7);
  t = (x ^ (x >> 14)) & 0x0000CCCC0000CCCCull;
  x = x ^ t ^ (t << 14);
  t = (x ^ (x >> 28)) & 0x00000000F0F0F0F0ull;
  x = x ^ t ^ (t << 28);
  return x;
}

}  // namespace

void byte_shuffle(int ts, int64_t n, const uint8_t* src, uint8_t* dst) {
  if (ts <= 1) {
    std::memcpy(dst, src, n);
    return;
  }
  int64_t rows = n / ts;
  int64_t body = rows * ts;
  switch (ts) {
    case 2: shuffle_fixed<2>(rows, src, dst); break;
    case 4: shuffle_fixed<4>(rows, src, dst); break;
    case 8: shuffle_fixed<8>(rows, src, dst); break;
    case 16: shuffle_fixed<16>(rows, src, dst); break;
    default: shuffle_generic(ts, rows, src, dst); break;
  }
  if (n > body) std::memcpy(dst + body, src + body, n - body);
}

void byte_unshuffle(int ts, int64_t n, const uint8_t* src, uint8_t* dst) {
  if (ts <= 1) {
    std::memcpy(dst, src, n);
    return;
  }
  int64_t rows = n / ts;
  int64_t body = rows * ts;
  switch (ts) {
    case 2: unshuffle_fixed<2>(rows, src, dst); break;
    case 4: unshuffle_fixed<4>(rows, src, dst); break;
    case 8: unshuffle_fixed<8>(rows, src, dst); break;
    case 16: unshuffle_fixed<16>(rows, src, dst); break;
    default: unshuffle_generic(ts, rows, src, dst); break;
  }
  if (n > body) std::memcpy(dst + body, src + body, n - body);
}

// Bit shuffle: three stages over `size` elements of `ts` bytes
// (size % 8 == 0): byte transpose into byte-planes, 8x8 bit transpose of
// each plane word, regroup into ts*8 bit-rows of size/8 bytes.
void bit_shuffle(int ts, int64_t n, const uint8_t* src, uint8_t* dst,
                 uint8_t* tmp) {
  int64_t size = n / ts;
  if (size % 8 != 0) {  // unsupported geometry: pass through
    std::memcpy(dst, src, n);
    return;
  }
  int64_t body = size * ts;
  // stage 1: byte planes (elements x ts -> ts x elements) into tmp
  byte_shuffle(ts, body, src, tmp);
  // stages 2+3 fused: for byte-plane j, word m covers elements 8m..8m+7;
  // transposed byte k goes to bit-row j*8+k at column m.
  int64_t nrow = size / 8;  // bytes per bit-row
  for (int j = 0; j < ts; ++j) {
    const uint8_t* plane = tmp + (int64_t)j * size;
    uint8_t* rows = dst + (int64_t)j * 8 * nrow;
    for (int64_t m = 0; m < nrow; ++m) {
      uint64_t x = transpose8x8(load_u64(plane + m * 8));
      for (int k = 0; k < 8; ++k) {
        rows[(int64_t)k * nrow + m] = (uint8_t)(x >> (8 * k));
      }
    }
  }
  if (n > body) std::memcpy(dst + body, src + body, n - body);
}

void bit_unshuffle(int ts, int64_t n, const uint8_t* src, uint8_t* dst,
                   uint8_t* tmp) {
  int64_t size = n / ts;
  if (size % 8 != 0) {
    std::memcpy(dst, src, n);
    return;
  }
  int64_t body = size * ts;
  int64_t nrow = size / 8;
  // inverse of stages 2+3: rebuild byte-planes into tmp
  for (int j = 0; j < ts; ++j) {
    const uint8_t* rows = src + (int64_t)j * 8 * nrow;
    uint8_t* plane = tmp + (int64_t)j * size;
    for (int64_t m = 0; m < nrow; ++m) {
      uint64_t x = 0;
      for (int k = 0; k < 8; ++k) {
        x |= (uint64_t)rows[(int64_t)k * nrow + m] << (8 * k);
      }
      x = transpose8x8(x);
      std::memcpy(plane + m * 8, &x, 8);
    }
  }
  // inverse of stage 1
  byte_unshuffle(ts, body, tmp, dst);
  if (n > body) std::memcpy(dst + body, src + body, n - body);
}

}  // namespace cbt
