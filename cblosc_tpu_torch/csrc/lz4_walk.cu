// LZ4 walk kernel (K4): parse LZ4 blocks into compacted records, one warp
// per row.
//
// Replaces cblosc_tpu/tpu/codec_lz4.py:_walk_batch (a batched
// lax.while_loop that parses up to 8 steps per 512-byte window read).
// The state machine and every check are _walk_batch's; bytes at or past
// csize (or the row width) read as 0:
//   phase 0  at a token: litlen = token >> 4, 15 + 255-extension bytes
//            from ip + 1; phase 1 continues an extension run of 8 or
//            more 255 bytes (taken 8 at a time, extacc carries the sum)
//   literal  copies litlen bytes from ipl; err if ipl + litlen > csize
//            or op + litlen > out_len; fin (the final literals) when
//            ipl + litlen >= csize, else phase 2; a zero-literal token
//            yields no record
//   phase 2  at the 2-byte LE offset: mlen = 4 + token & 15, 15 +
//            extension bytes from ip + 2; phase 3 continues a match
//            extension run; err if the offset is 0 or beyond op,
//            op + mlen > out_len, or the match's last byte lies past csize
//   ext run  err when ip + 8 >= csize
//   budget   err when a record would be the (E+1)-th
//   ok       = !err && op == out_len at fin (a stream ending on a match
//            is not finished and errs at the next token)
// Records are written compacted, valid first: (kind 0, stream offset, dst,
// len) per literal run, (kind 1, offset, dst, len) per match, then kind
// -1 and zeros up to E; the kernel writes every column. dist is the first
// completed match's offset, uni says all share it.
//
// What bounds it on an H100: latency. The bytes moved (the stream, 16
// bytes per record, the flags) take microseconds at 3.35 TB/s; a row's
// parse is a chain of dependent steps. This first kernel is simple: the
// 32 lanes of a warp run the same scalar state machine on one row (the
// row read through the read-only path, each load a broadcast), lanes 0-7
// read an extension run's 8 bytes at once, and lane 0 writes the records;
// the warp fills the -1 tail. Four rows share a CTA so many short rows
// (8 KB splits at the speed clevels) hide one another's latency.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 4;           // rows per CTA
constexpr unsigned kFull = 0xffffffffu;

struct Row {
  const uint8_t* s;
  int lim;                          // min(csize, W): bytes past it read 0
  __device__ int at(long long x) const {
    return (x >= 0 && x < lim) ? (int)__ldg(s + x) : 0;
  }
};

// Leading 255 bytes among the 8 at e (k255, at most 8) and the byte at
// e + min(k255, 7), the run's last byte; every lane gets both.
__device__ void ext_run(const Row& r, long long e, int lane, int& k255,
                        int& lastb) {
  const int b = lane < 8 ? r.at(e + lane) : 0;
  const unsigned m = __ballot_sync(kFull, lane < 8 && b == 255);
  k255 = __ffs(~m) - 1;             // bits 8.. are 0, so k255 <= 8
  lastb = __shfl_sync(kFull, b, k255 < 7 ? k255 : 7);
}

__global__ void __launch_bounds__(kWarps * 32)
lz4_walk_kernel(const uint8_t* __restrict__ slots, int N, int W,
                const int32_t* __restrict__ csizes, int out_len, int E,
                int32_t* __restrict__ kind, int32_t* __restrict__ arg,
                int32_t* __restrict__ dst, int32_t* __restrict__ len,
                int32_t* __restrict__ dist_out, uint8_t* __restrict__ uni_out,
                uint8_t* __restrict__ ok_out) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long row = (long long)blockIdx.x * kWarps + warp;
  if (row >= N) return;             // warp-uniform: no block barrier below
  const int cs = csizes[row];
  const Row r{slots + row * (long long)W, cs < W ? cs : W};
  const long long rb = row * (long long)E;

  // int32 state as in the JAX walk: every value stays below 2^31 for any
  // row width the pipeline forms (extacc grows by 2040 per 8 stream bytes)
  int ip = 0, op = 0, phase = 0, mlsave = 0, offsave = 0, extacc = 0;
  int dist = 0, cnt = 0;
  bool uni = true, err = cs <= 0, fin = cs <= 0;
  while (!(err || fin)) {
    const int tok = r.at(ip);
    const bool is0 = phase == 0, is1 = phase == 1, is2 = phase == 2;
    const bool is_l = phase <= 1;
    const long long ebase = (long long)ip + (is0 ? 1 : (is2 ? 2 : 0));
    int k255, lastb;
    ext_run(r, ebase, lane, k255, lastb);
    bool more, rec = false, done;
    int rk = 0, ra = 0, rl = 0;
    int ip_n = ip, op_n = op, phase_n = 0, extacc_n = 0;
    bool e;
    if (is_l) {
      const bool need = (is0 && (tok >> 4) == 15) || is1;
      more = need && k255 >= 8;
      const int litlen =
          need ? (is0 ? 15 : extacc) + 255 * k255 + lastb : tok >> 4;
      const int ipl = ip + (is0 ? 1 : 0) + (need && !more ? k255 + 1 : 0);
      const int ip2 = ipl + litlen;
      const bool lit_err = !more && (ip2 > cs || op + litlen > out_len);
      done = !more && !lit_err && ip2 >= cs;       // final literals
      e = lit_err || (more && ip + 8 >= cs);
      rec = !more && litlen > 0;
      rk = 0; ra = ipl; rl = litlen;
      if (more) {
        ip_n = ip + (is0 ? 9 : 8);
        phase_n = 1;
        extacc_n = (is0 ? 15 : extacc) + 255 * 8;
      } else {
        ip_n = ip2;
        op_n = op + litlen;
        phase_n = done ? 0 : 2;
      }
      if (is0) mlsave = tok & 15;   // read only by later steps (not on err)
    } else {
      const int offv = is2 ? (tok | (r.at((long long)ip + 1) << 8)) : offsave;
      const bool need = (is2 && mlsave == 15) || !is2;
      more = need && k255 >= 8;
      const int mlen =
          4 + (need ? (is2 ? 15 : extacc) + 255 * k255 + lastb : mlsave);
      const int ip3 = ip + (is2 ? 2 : 0) + (need && !more ? k255 + 1 : 0);
      const bool m_err = !more && (offv == 0 || offv > op ||
                                   op + mlen > out_len || ip3 > cs);
      done = false;
      e = m_err || (more && ip + 8 >= cs);
      rec = !more;
      rk = 1; ra = offv; rl = mlen;
      offsave = offv;               // read only by later steps
      if (more) {
        ip_n = ip + (is2 ? 10 : 8);
        phase_n = 3;
        extacc_n = (is2 ? 15 : extacc) + 255 * 8;
      } else {
        ip_n = ip3;
        op_n = op + mlen;
        phase_n = 0;
      }
    }
    if (!e && rec && cnt >= E) e = true;
    if (e) {
      err = true;
      break;
    }
    if (rec) {
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
    }
    ip = ip_n;
    op = op_n;
    phase = phase_n;
    extacc = extacc_n;
    fin = done;
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

extern "C" int lz4_walk_launch(const void* slots, int N, int W,
                               const void* csizes, int out_len, int E,
                               void* kind, void* arg, void* dst, void* len,
                               void* dist, void* uni, void* ok, void* stream) {
  if (N > 0) {
    lz4_walk_kernel<<<(N + kWarps - 1) / kWarps, kWarps * 32, 0,
                      (cudaStream_t)stream>>>(
        (const uint8_t*)slots, N, W, (const int32_t*)csizes, out_len, E,
        (int32_t*)kind, (int32_t*)arg, (int32_t*)dst, (int32_t*)len,
        (int32_t*)dist, (uint8_t*)uni, (uint8_t*)ok);
  }
  return (int)cudaGetLastError();
}
