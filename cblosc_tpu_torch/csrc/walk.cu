// Walk kernel: parse blosclz streams into compacted records, one warp per
// row.
//
// Replaces cblosc_tpu/tpu/structured.py:_walk_impl (a batched
// lax.while_loop that parses up to 8 tokens per window read). The wire
// grammar and its checks are those of _walk_impl (blosclz.c:679-789):
//   state    ip = 1, op = 0, token = src[0] & 31, err = csize <= 0,
//            fin = csize <= 1; bytes at or past csize read as 0
//   literal  token < 32 copies token + 1 bytes; err if op + len > out_len
//            or ip + len > csize; fin when ip + len >= csize
//   match    token >= 32: length (token >> 5) + 2, or with the 7 escape
//            6 + sum of 255-extension bytes + 3; distance
//            (token & 31) << 8 | next byte, + 1, or the 31/255 far escape
//            with two more bytes + 8192; err if distance > op,
//            op + len > out_len, or the next token lies at/past csize
//   budget   err when a record would be the (E+1)-th
//   ok       = !err && op == out_len at fin
// Records are written compacted, valid first: (kind 0, src, dst, len)
// for a literal, (kind 1, distance, dst, len) for a match, then kind -1
// and zeros up to E; the kernel writes every column. A row needing more
// than E records reports not-ok (the caller decodes it with the generic
// decoder). dist is the first match's distance, uni says all share it.
//
// What bounds it on an H100: latency. The bytes moved (the compressed rows
// plus 16 bytes per record slot) take about a microsecond at 3.35 TB/s;
// a row's parse is a chain of dependent steps, one per token. The kernel
// evaluates the token at every position of a 128-position window at once
// (blosclz_parse.cuh, 16 bytes a lane from a cp.async-staged copy of the
// row), follows the chain through the table with one shared-memory load
// per one to four tokens, and writes the records as consecutive stores of
// consecutive lanes. One warp owns a row and four rows share a CTA, so
// many short rows (8 KB splits at the speed clevels: the 128 walk rows of
// a 4 MB chunk run on 32 SMs, 2048 rows fill the card) hide one another's
// latency. A long row (128 or 256 KB splits at the ratio clevels) runs
// alone on its warp (about 97 ns per token on an NVIDIA H100 80GB HBM3
// at 700.00 W).

#include <cstdint>
#include <cuda_runtime.h>

#include "blosclz_parse.cuh"

namespace {

constexpr int kWarps = 4;         // rows per CTA
constexpr int kStage = 2048;      // bytes per stage (two per warp)

__global__ void __launch_bounds__(kWarps * 32)
walk_kernel(const uint8_t* __restrict__ slots, int N, int W,
            const int32_t* __restrict__ csizes, int out_len, int E,
            int32_t* __restrict__ kind, int32_t* __restrict__ arg,
            int32_t* __restrict__ dst, int32_t* __restrict__ len,
            int32_t* __restrict__ dist_out, uint8_t* __restrict__ uni_out,
            uint8_t* __restrict__ ok_out) {
  __shared__ __align__(16) uint8_t stage_buf[kWarps][2 * kStage];
  __shared__ __align__(16) blz::Tables tables[kWarps];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long row = (long long)blockIdx.x * kWarps + warp;
  if (row >= N) return;          // warp-uniform: no block barrier below
  const uint8_t* s = slots + row * (long long)W;
  const int cs = csizes[row];
  const int lim = cs < W ? cs : W;
  const long long rb = row * (long long)E;
  blz::Stage<kStage> st;
  st.init(stage_buf[warp], s, lim, 0);
  const blz::GlobalReader g{s, lim, 0};
  blz::Tables& tb = tables[warp];

  int t = 0, cnt = 0, dist = 0;
  long long op = 0;
  bool uni = true, err = cs <= 0, fin = cs <= 1, first = true;
  while (!(err || fin)) {
    st.ensure(t);
    blz::Rec a, b;
    int c;
    const int n = blz::parse_step(st, g, tb, t, cs, first, a, b, c);
    first = false;
    const bool v0 = lane < n, v1 = lane + 32 < n;
    const int L0 = v0 ? a.len : 0, L1 = v1 ? b.len : 0;
    const int i0 = blz::warp_incl_scan(L0);
    const int i1 = blz::warp_incl_scan(L1) + __shfl_sync(blz::kFull, i0, 31);
    const long long op0 = op + i0 - L0, op1 = op + i1 - L1;
    const int c0 = cnt + lane, c1 = cnt + lane + 32;
    const bool e0 = a.perr || op0 + L0 > out_len || c0 >= E ||
                    (a.match && a.arg > op0);
    const bool e1 = b.perr || op1 + L1 > out_len || c1 >= E ||
                    (b.match && b.arg > op1);
    const int f = blz::first_set(__ballot_sync(blz::kFull, v0 && (e0 || a.fin)),
                                 __ballot_sync(blz::kFull, v1 && (e1 || b.fin)),
                                 n);
    // record f stops the row: emitted only when it is a literal ending at
    // csize without error
    int fstate = 0;              // 1: err, 2: fin without err
    if (f < n) fstate = blz::pick(e0 ? 1 : 2, e1 ? 1 : 2, f);
    const int nemit = f + (fstate == 2 ? 1 : 0);
    const bool m0 = lane < nemit, m1 = lane + 32 < nemit;
    if (m0) {
      kind[rb + c0] = a.match ? 1 : 0;
      arg[rb + c0] = a.arg;
      dst[rb + c0] = (int)op0;
      len[rb + c0] = L0;
    }
    if (m1) {
      kind[rb + c1] = b.match ? 1 : 0;
      arg[rb + c1] = b.arg;
      dst[rb + c1] = (int)op1;
      len[rb + c1] = L1;
    }
    // dist: the first emitted match's distance; uni: all emitted share it
    const unsigned mm0 = __ballot_sync(blz::kFull, m0 && a.match);
    const unsigned mm1 = __ballot_sync(blz::kFull, m1 && b.match);
    if (mm0 | mm1) {
      if (dist == 0) dist = blz::pick(a.arg, b.arg, blz::first_set(mm0, mm1, 64));
      uni = uni && !__any_sync(blz::kFull, (m0 && a.match && a.arg != dist) ||
                                             (m1 && b.match && b.arg != dist));
    }
    cnt += nemit;
    if (nemit > 0) op += blz::pick(i0, i1, nemit - 1);  // through the last emitted
    if (fstate == 1) err = true;
    else if (fstate == 2) fin = true;
    else t = c;
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

extern "C" int walk_launch(const void* slots, int N, int W, const void* csizes,
                           int out_len, int E, void* kind, void* arg,
                           void* dst, void* len, void* dist, void* uni,
                           void* ok, void* stream) {
  if (N > 0) {
    walk_kernel<<<(N + kWarps - 1) / kWarps, kWarps * 32, 0,
                  (cudaStream_t)stream>>>(
        (const uint8_t*)slots, N, W, (const int32_t*)csizes, out_len, E,
        (int32_t*)kind, (int32_t*)arg, (int32_t*)dst, (int32_t*)len,
        (int32_t*)dist, (uint8_t*)uni, (uint8_t*)ok);
  }
  return (int)cudaGetLastError();
}
