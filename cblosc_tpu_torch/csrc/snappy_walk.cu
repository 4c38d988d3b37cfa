// Snappy walk kernel (K5): parse raw snappy streams into compacted
// records, one warp per row.
//
// Replaces cblosc_tpu/tpu/codec_snappy.py:_walk_batch (a batched
// lax.while_loop that parses up to 8 tags per 512-byte window read).
// The grammar and every check are _walk_batch's; bytes at or past csize
// (or the row width) read as 0:
//   preamble the uvarint length in at most 5 bytes, each below csize; err
//            if it runs on past them, sets a bit at or above bit 32,
//            differs from out_len, or reaches csize (rows with csize <= 0
//            are finished and not ok)
//   literal  tag & 3 == 0: (tag >> 2) + 1 bytes, or 1-4 little-endian
//            extra bytes + 1 (tag >> 2 = 60..63); err if the fourth extra
//            byte is set, ipl + len > csize or op + len > out_len
//   copy     tag & 3 == 1: len 4 + (tag >> 2 & 7), offset (tag >> 5) << 8
//            | next byte; 2: len (tag >> 2) + 1, 2-byte offset; 3: the
//            same with a 4-byte offset whose top byte must be 0; err if
//            the offset is 0 or beyond op, op + len > out_len, or the
//            token runs past csize
//   fin      when the next tag would start at or past csize (no
//            terminator)
//   budget   err when a record would be the (E+1)-th
//   ok       = !err && op == out_len
// Records are written compacted, valid first: (kind 0, stream offset, dst,
// len) per literal, (kind 1, offset, dst, len) per copy, then kind -1 and
// zeros up to E; the kernel writes every column. dist is the first copy's
// offset, uni says all share it.
//
// What bounds it on an H100: latency, as for the LZ4 walk (lz4_walk.cu):
// one dependent step per tag. The 32 lanes of a warp run the same scalar
// state machine on one row; lanes 0-4 read a tag and its four following
// bytes at once (read-only path), lane 0 writes the records, the warp
// fills the -1 tail; four rows share a CTA.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 4;           // rows per CTA
constexpr unsigned kFull = 0xffffffffu;

__global__ void __launch_bounds__(kWarps * 32)
snappy_walk_kernel(const uint8_t* __restrict__ slots, int N, int W,
                   const int32_t* __restrict__ csizes, int out_len, int E,
                   int32_t* __restrict__ kind, int32_t* __restrict__ arg,
                   int32_t* __restrict__ dst, int32_t* __restrict__ len,
                   int32_t* __restrict__ dist_out,
                   uint8_t* __restrict__ uni_out,
                   uint8_t* __restrict__ ok_out) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long row = (long long)blockIdx.x * kWarps + warp;
  if (row >= N) return;             // warp-uniform: no block barrier below
  const uint8_t* s = slots + row * (long long)W;
  const int cs = csizes[row];
  const int lim = cs < W ? cs : W;
  const long long rb = row * (long long)E;

  // lanes 0-4 hold the bytes at x .. x + 4 (0 past lim)
  auto window = [&](long long x) {
    const long long p = x + lane;
    return (lane < 5 && p >= 0 && p < lim) ? (int)__ldg(s + p) : 0;
  };

  // ---- uvarint preamble (bytes below csize; read as the JAX walk does,
  //      from the row itself) ----------------------------------------------
  const int pb = (lane < 5 && lane < W) ? (int)__ldg(s + lane) : 0;
  unsigned long long val = 0;
  int nv = 0;
  bool cont = true, overflow = false;
  for (int i = 0; i < 5; ++i) {
    const int bi = __shfl_sync(kFull, pb, i);
    const bool take = cont && i < cs;
    if (take) {
      overflow = overflow || (i == 4 && (bi & 0x7F) > 0xF);
      val |= (unsigned long long)(bi & 0x7F) << (7 * i);
      nv = i + 1;
    }
    cont = take && (bi & 0x80) != 0;
  }
  const bool live = cs > 0;
  bool err = live && (cont || overflow || val != (unsigned long long)out_len ||
                      cs <= nv);
  bool fin = !live;

  int ip = nv, op = 0, dist = 0, cnt = 0;
  bool uni = true;
  while (!(err || fin)) {
    const int w = window(ip);
    const int tag = __shfl_sync(kFull, w, 0), b1 = __shfl_sync(kFull, w, 1),
              b2 = __shfl_sync(kFull, w, 2), b3 = __shfl_sync(kFull, w, 3),
              b4 = __shfl_sync(kFull, w, 4);
    const int typ = tag & 3, base = tag >> 2;
    int rk, ra, rl, ip_n;
    bool e;
    if (typ == 0) {
      const int extra = min(max(base - 59, 0), 4);
      const int ext_val = b1 | (extra >= 2 ? b2 << 8 : 0) |
                          (extra >= 3 ? b3 << 16 : 0);
      rl = extra == 0 ? base + 1 : ext_val + 1;
      ra = ip + 1 + extra;
      ip_n = ra + rl;
      e = (extra == 4 && b4 != 0) || ip_n > cs || op + rl > out_len;
      rk = 0;
    } else {
      rl = typ == 1 ? (base & 7) + 4 : base + 1;
      ra = typ == 1 ? (((base >> 3) << 8) | b1)
                    : (b1 | (b2 << 8) | (typ == 2 ? 0 : b3 << 16));
      ip_n = ip + (typ == 1 ? 2 : (typ == 2 ? 3 : 5));
      e = (typ == 3 && b4 != 0) || ra == 0 || ra > op || op + rl > out_len ||
          ip_n > cs;
      rk = 1;
    }
    if (e || cnt >= E) {
      err = true;
      break;
    }
    if (lane == 0) {
      kind[rb + cnt] = rk;
      arg[rb + cnt] = ra;
      dst[rb + cnt] = op;
      len[rb + cnt] = rl;
    }
    ++cnt;
    if (rk == 1) {
      if (dist == 0) dist = ra;
      uni = uni && ra == dist;
    }
    ip = ip_n;
    op += rl;
    fin = ip_n >= cs;
  }
  for (int i = cnt + lane; i < E; i += 32) {
    kind[rb + i] = -1;
    arg[rb + i] = 0;
    dst[rb + i] = 0;
    len[rb + i] = 0;
  }
  if (lane == 0) {
    dist_out[row] = dist;
    uni_out[row] = uni ? 1 : 0;
    ok_out[row] = (!err && op == out_len) ? 1 : 0;
  }
}

}  // namespace

extern "C" int snappy_walk_launch(const void* slots, int N, int W,
                                  const void* csizes, int out_len, int E,
                                  void* kind, void* arg, void* dst, void* len,
                                  void* dist, void* uni, void* ok,
                                  void* stream) {
  if (N > 0) {
    snappy_walk_kernel<<<(N + kWarps - 1) / kWarps, kWarps * 32, 0,
                         (cudaStream_t)stream>>>(
        (const uint8_t*)slots, N, W, (const int32_t*)csizes, out_len, E,
        (int32_t*)kind, (int32_t*)arg, (int32_t*)dst, (int32_t*)len,
        (int32_t*)dist, (uint8_t*)uni, (uint8_t*)ok);
  }
  return (int)cudaGetLastError();
}
