#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (cblosc_tpu_torch) on one GPU.

Run from the repository root on a machine with an NVIDIA GPU:

    python3 chip_smoke.py

Phases (each prints its own lines; any failure raises and exits non-zero):
  1. the card's name and power limit; build the CUDA kernels from
     cblosc_tpu_torch/csrc (in parallel, into build/torch_kernels/) and,
     beside them, the native host engine from
     cblosc_tpu_torch/native/src (g++, into build/torch_native/), with
     the host CPU; the host-engine fixtures (chunks of the host-encoded
     codecs and of the generic decoder's rows) come from core.backend,
     the native engine, and each equals the numpy engine's chunk on one
     4 MB input per codec (blosclz: its 256 KB input);
  2. each kernel on CUDA tensors against its plain PyTorch version on
     the same inputs, outputs equal (tolerance 0: integer code); the
     plain versions of the four serial parsers (walk, decode_one,
     lz4_walk, snappy_walk) run on a host copy ("plain_on": "host"),
     expand's on the card. Inputs: the main path's, host-encoder rows
     and raw streams generated token by token (far matches, escape
     runs, narrow and unaligned rows, corruptions, random bytes).
     Times: each kernel's wrapper called alone between CUDA events (the
     "ms" of the kernels line, which includes the host work of a short
     call), beside the kernel's device time per launch ("device_ms",
     from torch.profiler; "device_ms_source" says when a trace held no
     launch and queued CUDA events stood in) and the wrapper's time per
     call of 20 back to back ("call_ms"); the walk on both its main-path
     shapes (the long row's figures as "long_*"); the token count and ns
     per token of the timed 256 KB decode row. The LZ4 walk (lz4_walk)
     and the snappy walk (snappy_walk) are held on their main-path rows
     (a 4 MB LZ4 chunk from the device encoder; the rows of a 4 MB
     snappy chunk from the host engine) and timed there, the LZ4 walk
     also on one generated 128 KB row ("long_*") and on numcodecs'
     default chunk (the host engine's LZ4 clevel-5 chunk of 4 MB synth:
     24 live rows of 128 KB, 4 of them dense) at the default and the
     escalated budget and on 32 copies of its rows in one launch
     ("chunk5_*", "chunk5x32_*", with the densest row's records and the
     ns a record), held there on two dense and the short rows and the
     32 copies against the 24 rows; they are held besides
     on host-engine rows (LZ4 at clevel 5 and 9, LZ4HC), generated
     streams with corruptions, and a token-dense row at the default and
     the escalated budget; the snappy walk is timed at the escalated
     budget too, with the ns a record on its densest row. The zlib walk
     (zlib_walk) is held, tape and
     records included, on the non-dense live rows of the 4 MB synth
     zlib chunk (clevel 5, 128 KB splits) at the default budget and on
     generated zlib streams (every strategy, corruptions, one-byte flips,
     random rows); rows too long for the plain loop (the chunk's
     dense rows, the generated Huffman-only rows) are held by
     their K6 + K1 output at the escalated budget against
     zlib.decompress. It is timed on the chunk's 24 live rows at the
     escalated budget, the one the byte API settles on, with the events
     of the densest row and the ns an event. The expand kernel (K1) is
     timed on the same 24 rows, over K6's tape, and on the 16 live rows
     of the 4 MB synth clevel-5 zstd chunk, over K7's [tape | stream],
     each held to its plain version on two of those rows on the card;
     on every main-path input (the int32 arange, LZ4, snappy, zlib and
     zstd chunks' rows) it reports the rows that took its per-record
     branch (there must be none) and the largest number of pointer-
     jumping rounds. The walk (K2), expand (K1) and the LZ4 walk (K4) are
     also held and timed on the live rows of the clevel-5 chunks the card
     wrote (the "cl5_*" keys): K2 and K1 on the blosclz synth and int32
     arange chunks, whose staircase rows carry mined far-distance
     matches, K4 on the LZ4 synth chunk (numcodecs' default Blosc()) and
     a uint8 staircase chunk, whose rows carry mined runs abutting static
     ones (a zero-literal sequence after a match). The zstd walk
     (zstd_walk) is held, tape and records included, on the generated
     zstd frames of streams.ZSTD_CARD_CASES up to 32 KB (every frame
     feature, corruptions, one-byte flips, random rows) and on a few
     live rows of the 4 MB synth zstd chunks at clevels 1 and 5; K7 + K1
     replay every live row of those two chunks, and every valid
     generated frame up to 128 KB, to libzstd's bytes. It is timed on the
     clevel-5 chunk's 16 live rows at the default budget, with the
     sequences of its longest row (the kernel's stats output) and the ns
     a sequence;
  3. the main path: byte-API round trips (compress_ctx/decompress_ctx)
     on 4 MB buffers at clevel 1 (blosclz, lz4, lz4hc) plus a clevel-9
     blosclz, a clevel-5 LZ4, a snappy chunk, zlib chunks and zstd
     chunks (synth at clevels 1, 5 and 9, int32 arange at clevel 5) from
     the host engine decoded on the card (gpu.host_api.decompress_chunk
     must return them: no host fallback; but the clevel-9 zstd chunk,
     whose 1 MB blocks are above decode_cap, goes to the host engine, as
     in the JAX package, and a line says so); chunks at the ratio
     clevels 5 and 9 written on the card (blosclz synth and int32
     arange, lz4 and lz4hc synth, an lz4 uint8 staircase), each
     byte-identical to the port's device="cpu" chunk of the same buffer
     and decoded on the card (the blosclz synth chunks by the template
     path alone, the arange chunks by walk and expand, the LZ4 chunks by
     the LZ4 walk); every launch counter is zeroed just before
     each decode and read just after it, the phase's launches are their
     sum, and each kernel must have launched; then the
     clevel-9 chunk's decode is timed warm (CUDA events, median of 5);
     then getitem (api.getitem and gpu.host_api.getitem) on the card on
     the main-path 4 MB blosclz clevel-1 synth chunk, the card-written
     LZ4 clevel-5 synth chunk (numcodecs' default), the host engine's
     zstd clevel-5 synth chunk and a 4 MB + 1234 B synth buffer with a
     leftover block, each over five ranges (the first 100 items, 100
     items across a block boundary, the last full block into the
     leftover, an empty range, the whole chunk): every result equal to
     the input and to the port's device="cpu" getitem (the zstd chunk's
     on its one-block range; its others against the host engine's), the
     rows handed to the decoder exactly those of the range's blocks, the
     codec's walk launched by a one-block range, and the card time of a
     one-block getitem beside the whole decompress_ctx of each chunk;
     then the host engine: on 4 MB of synth (sbits 19, typesize 8,
     shuffle, clevel 5), snappy, zlib and zstd compressed by
     api.compress_ctx, which the native engine must serve
     (core.backend.CALLS), each chunk equal to the numpy engine's
     (snappy's on the first 512 KB) and decoded on the card by
     api.decompress_ctx through its walk and expand, equal to the input,
     both calls timed (median of 5: compress on the host clock, decode by
     CUDA events) beside the host CPU and numinternalthreads; the 256 KB
     clevel-9 blosclz chunk and a 32 KB LZ4 buffer through the API too,
     with the engine or kernels that served them;
  4. the bench geometry on device-resident data: a 128 MB working set
     through gpu.pipeline.compress_blocks -> mask_past_csize ->
     decompress_blocks, verified equal, timed with CUDA events (call
     time on the stream, host syncs included), with the launch counts
     of its first decode (the int32 arange decode must launch the walk
     and expand kernels, the LZ4 synth decode the LZ4 walk); the same for
     128 MB of synth at clevels 5 and 9 (128 KB and 256 KB splits,
     compress_blocks(mine=True)), with mine_group timed alone on the
     streams the compress call mines; and 128 MB
     of synth in zlib chunks written by the host engine at clevel 5
     (host time printed as such), all their rows decoded by
     decompress_blocks at the escalated budget, verified and timed the
     same way, with the number of rows that overflow the default budget;
     and 128 MB of synth in zstd chunks from the host engine at clevels
     5 (256 KB blocks) and 1 (32 KB blocks), all their rows decoded by
     decompress_blocks at the default budget, verified and timed the
     same way, with the rows over the default budget and the rows the
     walk rejects even at the escalated one (the byte API would send
     them to the host), and the zstd walk timed alone in one launch over
     all their live rows;
  5. the sharded engine (cblosc_tpu_torch.parallel) on a one-rank NCCL
     process group on the card over a FileStore in a temporary
     directory: make_mesh, compress_chunk/decompress_chunk,
     training_step, and training_step_2d on make_mesh_2d(1), on 4 MB of
     synth (and compress_chunk/decompress_chunk on 4 MB of int32 arange,
     whose decode launches walk and expand), each chunk and total equal
     to the same calls on a one-rank gloo group on the CPU, with the
     call times; the machine has one
     card, so no multi-GPU scaling is measured; both groups are
     destroyed before the last line;
  6. the kernels line (launches: phases 3 and 5, the host-engine
     decodes included), then the device line, last.

It imports nothing of JAX and nothing of the JAX package, and exits
non-zero without a result when CUDA is unavailable or the package is
missing.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time
import zlib

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12     # H100 SXM HBM3, NVIDIA data sheet
CHUNK = 4 << 20               # bench.py chunk size
WORKSET = 128 << 20           # bench.py working set
BATCH = 20                    # back-to-back calls per kernel timing sample


def check(cond, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def card_line() -> str:
    r = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return r.stdout.strip().splitlines()[0]


def _ms(dev, fn, reps, warmup=1, batch=1):
    """Median ms per call of fn(), each sample a run of `batch` calls back
    to back: CUDA events on the card; the host clock only in a CPU
    rehearsal, whose numbers are never reported as device times."""
    def run():
        for _ in range(batch):
            fn()

    if dev.type == "cuda":
        from cblosc_tpu_torch.utils.timing import time_ms

        return time_ms(run, reps=reps, warmup=warmup) / batch
    t0 = time.perf_counter()
    for _ in range(reps):
        run()
    return (time.perf_counter() - t0) * 1e3 / reps / batch


def _device_ms(dev, fn, kernel: str):
    """(ms, source): the device ms per launch of `kernel` from
    torch.profiler (source "profiler"). Where the trace holds no launch
    at all (seen in long runs of this script, cause unknown), the card's
    ms per call of fn, 20 calls queued behind a spin kernel so that they
    run back to back, between CUDA events (source "queued events": the
    call's other kernels included), and a line says so. NaN in a CPU
    rehearsal, which has no device time."""
    if dev.type != "cuda":
        return float("nan"), "none"
    from cblosc_tpu_torch.utils.profile import kernel_ms

    try:
        return kernel_ms(fn, kernel), "profiler"
    except RuntimeError as e:
        calls = 20
        fn()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(50_000_000)     # tens of ms: the calls queue up
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        torch.cuda.synchronize()
        ms = start.elapsed_time(end) / calls
        print(f"device time of {kernel}: {e}; took {ms:.4f} ms per call from "
              f"{calls} calls queued behind a spin kernel (CUDA events)")
        return ms, "queued events"


def _device_label(source: str) -> str:
    return {"profiler": "profiler, per launch",
            "queued events": "queued CUDA events, per call"}.get(source, source)


def _host_plain(plain_fn, *args):
    """(outputs, ms): plain_fn on a host copy of its tensor arguments,
    one call timed on the host clock. The plain versions of the serial
    machines (walk, decode_one, lz4_walk, snappy_walk) take one parse
    step per iteration, and every op of a step is a launch on the card
    (about 3 ms a step there, several times less on the host), so they
    run on the host; the plain expand, one vectorized pass, runs on the
    card."""
    cargs = [a.cpu() if isinstance(a, torch.Tensor) else a for a in args]
    t0 = time.perf_counter()
    out = plain_fn(*cargs)
    return out, (time.perf_counter() - t0) * 1e3


def print_kernel(name: str, r: dict) -> None:
    print(f"kernel {name}: equal to plain (max_abs_err {r['max_abs_err']}); "
          f"{r['ms']:.4f} ms per call alone (CUDA events); "
          f"{r['device_ms']:.4f} ms on the card "
          f"({_device_label(r['device_ms_source'])}); "
          f"{r['call_ms']:.4f} ms per call ({BATCH} back to back); plain "
          f"{r['plain_ms']:.4f} ms (on the {r['plain_on']}); bound "
          f"{r['bound_ms']:.6f} ms")


def _host_ms(fn, reps) -> float:
    """Median ms of fn() on the host clock (host work: the host engine)."""
    fn()
    samples = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        samples.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(samples)


def counted(totals: dict, fn):
    """(fn(), launches): every launch count zeroed just before fn and read
    just after; the counts add to totals."""
    from cblosc_tpu_torch.gpu import kernels

    kernels.reset_launches()
    out = fn()
    delta = dict(kernels.LAUNCHES)
    for k, v in delta.items():
        totals[k] += v
    return out, delta


def _maxdiff(a, b) -> int:
    """Largest absolute difference over paired outputs, on the host."""
    a, b = tuple(a), tuple(b)
    check(len(a) == len(b), "output arity differs")
    worst = 0
    for x, y in zip(a, b):
        check(x.shape == y.shape, f"shape {tuple(x.shape)} vs {tuple(y.shape)}")
        if x.numel():
            worst = max(worst, int((x.cpu().to(torch.int64)
                                    - y.cpu().to(torch.int64)).abs().max()))
    return worst


# ---------------------------------------------------------------------------
# inputs
# ---------------------------------------------------------------------------

def main_path_walk_rows(dev, chunk_bytes):
    """The rows the walk gets on the main path: an int32 arange chunk at
    clevel 1 (shuffle, typesize 4) through compress_blocks, masked as the
    byte API gathers them, minus stored-raw and template rows."""
    from cblosc_tpu_torch.core import policy
    from cblosc_tpu_torch.format import constants as C
    from cblosc_tpu_torch.gpu import pipeline, structured

    data = np.arange(chunk_bytes // 4, dtype=np.int32).view(np.uint8)
    bs = policy.compute_blocksize_device(1, 4, data.size)
    nsplits = 4
    neblock = bs // nsplits
    x = torch.from_numpy(data.reshape(-1, bs).copy()).to(dev)
    slots, cs = pipeline.compress_blocks(
        x, C.SHUFFLE, 4, nsplits, policy.device_min_bytes_per_iter(1),
        C.BLOSCLZ, policy.device_min_cratio_x100(1), False)
    width = pipeline.decode_slot_width(neblock)
    dec_cs = torch.where(cs >= neblock, 0, cs).to(torch.int32)
    rows = pipeline.mask_past_csize(slots[:, :width], dec_cs, width)
    tmatch = structured._template_match(rows, dec_cs, neblock)[0]
    keep = torch.nonzero(~tmatch & (dec_cs > 0)).flatten()
    return rows[keep].contiguous(), dec_cs[keep].contiguous(), neblock


def host_encoder_rows(dev, n=8192, count=24, seed=7):
    """Mixed-distance streams from the host blosclz encoder (clevel 9),
    plus a copy of each with one corrupted byte."""
    from cblosc_tpu_torch.ops.codecs import blosclz

    rng = np.random.default_rng(seed)
    streams = []
    for i in range(count):
        k = i % 4
        base = np.tile(rng.integers(0, 40, 89 + i).astype(np.uint8),
                       n // 89 + 1)[:n]
        if k == 0:
            s = base
        elif k == 1:
            pat = rng.integers(0, 9, 23 + i).astype(np.uint8)
            s = np.concatenate([pat, base[:n - 2 * pat.size], pat])[:n]
        elif k == 2:
            s = (rng.integers(0, 8, n, dtype=np.uint8) * 16)
        else:
            s = ((np.arange(n) // (i + 3)) % 251).astype(np.uint8)
        enc = blosclz.compress(9, s, n, True)
        if enc:
            streams.append(enc)
    bad = []
    for enc in streams:
        b = bytearray(enc)
        b[int(rng.integers(1, len(b)))] ^= 0x5A
        bad.append(bytes(b))
    allr = streams + bad
    W = n + 64
    buf = np.zeros((len(allr), W), np.uint8)
    cs = np.zeros(len(allr), np.int32)
    for i, r in enumerate(allr):
        buf[i, :len(r)] = np.frombuffer(r, np.uint8)
        cs[i] = len(r)
    return (torch.from_numpy(buf).to(dev), torch.from_numpy(cs).to(dev), n,
            len(streams))


def host_engine_chunk(chunk_bytes):
    """A clevel-9 chunk of low-entropy bytes (<= 256 KB, typesize 1) from
    the port's host engine (core.backend: the native engine): mixed-
    distance, token-dense streams that overflow the walk's record budget,
    so the main path decodes them with the generic decoder (K3)."""
    from cblosc_tpu_torch.core import backend, engine
    from cblosc_tpu_torch.format import constants as C

    rng = np.random.default_rng(11)
    low = (rng.integers(0, 8, min(chunk_bytes, 256 << 10), dtype=np.uint8)
           * 16)
    ctx = engine.build_context(9, C.NOSHUFFLE, 1, low.size, low.size + 16,
                               C.BLOSCLZ)
    return low.tobytes(), backend.compress_chunk(ctx, low.tobytes())


def chunk_rows(dev, chunk):
    """The split rows and csizes the byte API gathers from a chunk."""
    from cblosc_tpu_torch.core import policy
    from cblosc_tpu_torch.format.header import ChunkHeader, read_bstarts
    from cblosc_tpu_torch.gpu import host_api, pipeline

    hdr = ChunkHeader.decode(chunk)
    nsplits = policy.nsplits_decode(hdr.dont_split, hdr.typesize,
                                    hdr.blocksize, False)
    neblock = hdr.blocksize // nsplits
    nfull = hdr.nblocks - (1 if hdr.leftover else 0)
    offs, cs = host_api._split_table(
        np.frombuffer(chunk, np.uint8), read_bstarts(chunk, hdr.nblocks)[:nfull],
        nsplits)
    width = pipeline.decode_slot_width(neblock, hdr.compcode)
    cs_dev = torch.from_numpy(cs).to(dev)
    rows = pipeline.gather_slots(
        torch.from_numpy(np.frombuffer(chunk, np.uint8).copy()).to(dev),
        torch.from_numpy(offs).to(dev), width)
    return pipeline.mask_past_csize(rows, cs_dev, width), cs_dev, neblock


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def generated_rows(dev):
    """[(rows, csizes, out_len)] of cblosc_tpu_torch.utils.streams."""
    from cblosc_tpu_torch.utils import streams

    out = []
    for seed, n, width in streams.CARD_CASES:
        buf, cs, _ = streams.generated_rows(seed, n, width)
        out.append((torch.from_numpy(buf).to(dev), torch.from_numpy(cs).to(dev),
                    n))
    return out


def lz4_main_rows(dev, chunk_bytes):
    """The rows the LZ4 walk gets on the main path: the byte API's LZ4
    chunk of 4 MB synth (sbits 19, typesize 8, shuffle, clevel 1, the
    device encoder), gathered as it gathers them, stored-raw rows
    dropped."""
    import cblosc_tpu_torch as tb
    from cblosc_tpu_torch.format import constants as C
    from cblosc_tpu_torch.utils.timing import synth

    chunk = tb.compress_ctx(1, C.SHUFFLE, 8, synth(chunk_bytes, 8, 19).tobytes(),
                            compressor="lz4", device=dev)
    rows, cs, neblock = chunk_rows(dev, chunk)
    return (*live_rows(rows, cs, neblock), neblock)


def host_codec_chunk(code, clevel, data, typesize):
    """A chunk of `data` from the port's host engine (core.backend: the
    native engine; shuffle)."""
    from cblosc_tpu_torch.core import backend, engine
    from cblosc_tpu_torch.format import constants as C

    ctx = engine.build_context(clevel, C.SHUFFLE, typesize, len(data),
                               len(data) + 16, code)
    return backend.compress_chunk(ctx, data)


def numpy_engine_chunk(code, clevel, shuffle, data, typesize):
    """(chunk, s): the same chunk from the port's numpy engine, the
    native engine's reference, and its host seconds."""
    from cblosc_tpu_torch.core import engine

    ctx = engine.build_context(clevel, shuffle, typesize, len(data),
                               len(data) + 16, code)
    t0 = time.perf_counter()
    chunk = engine.compress_chunk(ctx, data)
    return chunk, time.perf_counter() - t0


def host_cpu() -> str:
    """The host CPU as /proc/cpuinfo names it, and its count."""
    fields = {}
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                key, _, value = line.partition(":")
                fields.setdefault(key.strip(), value.strip())
    except OSError:
        pass
    name = fields.get("model name", "unknown")
    if name == "unknown":
        name += (f" (vendor {fields.get('vendor_id', '?')}, family "
                 f"{fields.get('cpu family', '?')}, model "
                 f"{fields.get('model', '?')})")
    return f"{name}, {os.cpu_count()} CPUs"


def live_rows(rows, cs, neblock):
    """The rows a decoder walks: stored-raw rows (csize == neblock, the
    only raw rule that holds for every codec) dropped."""
    keep = torch.nonzero((cs > 0) & (cs != neblock)).flatten()
    return rows[keep].contiguous(), cs[keep].contiguous()


def _walk_entry(dev, walk_fn, plain_fn, kernel, rows, cs, n, maxrec, reps):
    """One walk kernel on one input, held against its plain version (one
    timed call), with the yardsticks of the other kernels: bound =
    (stream bytes + csizes + 16 B per valid record + dist, uni and ok) /
    HBM rate."""
    from cblosc_tpu_torch.gpu import structured

    E = structured.record_slots(maxrec)
    call = lambda: walk_fn(rows, cs, n, maxrec)  # noqa: E731
    device_ms, source = _device_ms(dev, call, kernel)
    k = call()
    p, plain_ms = _host_plain(plain_fn, rows, cs, n, E)
    N = rows.shape[0]
    nrec = int((k[0][0] >= 0).sum())
    return dict(
        max_abs_err=_maxdiff(k[0] + k[1:], p[0] + p[1:]),
        ms=_ms(dev, call, reps),
        device_ms=device_ms, device_ms_source=source,
        call_ms=_ms(dev, call, reps, batch=BATCH),
        plain_ms=plain_ms, plain_on="host",
        bound_ms=(int(cs.sum()) + 4 * N + 16 * nrec + 6 * N)
        / HBM_BYTES_PER_S * 1e3,
        rows=N, records=nrec, accepted=int(k[3].sum()))


def phase_codec_walks(dev, chunk_bytes, snappy_chunk, lz4_chunk, reps):
    """K4 (LZ4 walk) and K5 (snappy walk) against their plain versions on
    host copies of the same CUDA tensors (_host_plain), at the default
    and the escalated budget; times on the main-path rows and, for K4,
    one generated 128 KB row and numcodecs' default chunk (lz4_chunk)."""
    from cblosc_tpu_torch.format import constants as C
    from cblosc_tpu_torch.gpu import codec_lz4, codec_snappy, structured
    from cblosc_tpu_torch.utils import streams
    from cblosc_tpu_torch.utils.timing import synth

    rng = np.random.default_rng(13)

    def held(walk_fn, plain_fn, cases, label):
        """The kernel against its plain version on more inputs."""
        err = 0
        t0 = time.perf_counter()
        for rows, cs, n, mr in cases:
            k = walk_fn(rows, cs, n, mr)
            p, _ = _host_plain(plain_fn, rows, cs, n,
                               structured.record_slots(mr))
            err = max(err, _maxdiff(k[0] + k[1:], p[0] + p[1:]))
        check(err == 0, f"{label} kernel differs from its plain version ({err})")
        print(f"{label}: held on {len(cases)} more inputs "
              f"({time.perf_counter() - t0:.1f} s)")
        return err

    def on_dev(buf, cs):
        return torch.from_numpy(buf).to(dev), torch.from_numpy(cs).to(dev)

    def dense_cases(walk_fn, mr_fn, dense_fn, width_fn, label):
        dn = 4096
        stream, _ = dense_fn(rng, dn)
        rows, cs = on_dev(*_pack_one(stream, width_fn(dn)))
        out = []
        for budget, accept in ((mr_fn(dn), False),
                               (structured.high_records(dn), True)):
            check(bool(walk_fn(rows, cs, dn, budget)[3][0]) == accept,
                  f"the token-dense {label} row must overflow the default "
                  "budget and walk at the escalated one")
            out.append((rows, cs, dn, budget))
        return out

    out = {}
    # ---- K4: host-engine rows (8 KB splits of 64 KB synth; LZ4 at clevel
    #      5 and 9, LZ4HC), generated streams, a token-dense row ----------
    host = synth(64 << 10, 8, 19).tobytes()
    cases = []
    for code, clevel in ((C.LZ4, 5), (C.LZ4, 9), (C.LZ4HC, 9)):
        h_rows, h_cs, hn = chunk_rows(dev, host_codec_chunk(code, clevel,
                                                            host, 8))
        h_rows, h_cs = live_rows(h_rows, h_cs, hn)
        cases.append((h_rows, h_cs, hn, codec_lz4.max_records(hn)))
    for seed, gn, width in streams.LZ4_CARD_CASES[:-1]:
        buf, cs, _, _ = streams.lz4_rows(seed, gn, width)
        cases.append((*on_dev(buf, cs), gn, codec_lz4.max_records(gn)))
    cases += dense_cases(codec_lz4.walk, codec_lz4.max_records,
                         streams.lz4_dense, lambda n: n + 64, "LZ4")
    m_rows, m_cs, n = lz4_main_rows(dev, chunk_bytes)
    mk = codec_lz4.walk(m_rows, m_cs, n, codec_lz4.max_records(n))
    k1_branches("the LZ4 synth chunk", m_rows, mk[0], n, mk[3])
    out["lz4_walk"] = r = _walk_entry(
        dev, codec_lz4.walk, codec_lz4._walk_plain, "::lz4_walk", m_rows,
        m_cs, n, codec_lz4.max_records(n), reps)
    err = held(codec_lz4.walk, codec_lz4._walk_plain, cases, "lz4_walk")
    # the long row: the first "far" row of the generated 128 KB case
    # (offsets up to 65535, 255-runs) at the default budget
    seed, ln, width = streams.LZ4_CARD_CASES[-1]
    buf, cs = streams.lz4_rows(seed, ln, width)[:2]
    far = 2 * streams.LZ4_KINDS.index("far")
    l_rows, l_cs = on_dev(buf[far:far + 1], cs[far:far + 1])
    lr = _walk_entry(dev, codec_lz4.walk, codec_lz4._walk_plain,
                     "::lz4_walk", l_rows, l_cs, ln,
                     codec_lz4.max_records(ln), reps)
    r["max_abs_err"] = max(err, r["max_abs_err"], lr["max_abs_err"])
    check(r["max_abs_err"] == 0, "lz4_walk kernel differs from its plain "
          f"version ({r['max_abs_err']})")
    r.update({f"long_{k}": lr[k] for k in ("ms", "device_ms",
                                           "device_ms_source", "plain_ms",
                                           "bound_ms", "rows", "records",
                                           "accepted")})
    r.update(_lz4_chunk5(dev, lz4_chunk, reps))
    r["max_abs_err"] = max(r["max_abs_err"], r.pop("chunk5_max_abs_err"))
    check(r["max_abs_err"] == 0, "lz4_walk kernel differs from its plain "
          f"version ({r['max_abs_err']})")
    # ---- K5: the main-path rows (also at the escalated budget, the rows
    #      that overflow the default one), generated streams, a
    #      token-dense row ----------------------------------------------
    s_rows, s_cs, sn = chunk_rows(dev, snappy_chunk)
    s_rows, s_cs = live_rows(s_rows, s_cs, sn)
    smr = codec_snappy.max_records(sn)
    sk = codec_snappy.walk(s_rows, s_cs, sn, structured.high_records(sn))
    k1_branches("the snappy synth chunk", s_rows, sk[0], sn, sk[3])
    out["snappy_walk"] = r = _walk_entry(
        dev, codec_snappy.walk, codec_snappy._walk_plain, "::snappy_walk",
        s_rows, s_cs, sn, smr, reps)
    over = torch.nonzero(~codec_snappy.walk(s_rows, s_cs, sn, smr)[3])
    over = over.flatten()[:4]
    cases = [(s_rows[over].contiguous(), s_cs[over].contiguous(), sn,
              structured.high_records(sn))]
    for seed, gn, width in streams.SNAPPY_CASES:
        buf, cs, _, _ = streams.snappy_rows(seed, gn, width)
        cases.append((*on_dev(buf, cs), gn, codec_snappy.max_records(gn)))
    cases += dense_cases(codec_snappy.walk, codec_snappy.max_records,
                         streams.snappy_dense, lambda n: n + n // 6 + 64,
                         "snappy")
    err = held(codec_snappy.walk, codec_snappy._walk_plain, cases,
               "snappy_walk")
    r["max_abs_err"] = max(err, r["max_abs_err"])
    # the escalated budget, where every row walks: the densest row's
    # records and the ns a record of the launch, which lasts as long as
    # that row
    hmr = structured.high_records(sn)
    high_call = lambda: codec_snappy.walk(s_rows, s_cs, sn, hmr)  # noqa: E731
    hdev, hsrc = _device_ms(dev, high_call, "::snappy_walk")
    per_row = (sk[0][0] >= 0).sum(dim=1)
    r.update(high_ms=_ms(dev, high_call, reps), high_device_ms=hdev,
             high_device_ms_source=hsrc, densest_records=int(per_row.max()),
             high_records=int(per_row.sum()),
             ns_per_record=hdev * 1e6 / max(int(per_row.max()), 1))
    check(r["max_abs_err"] == 0, "snappy_walk kernel differs from its "
          f"plain version ({r['max_abs_err']})")
    for name, shape in (("lz4_walk", f"{m_rows.shape[0]} live rows of the "
                         f"byte API's 4 MB LZ4 synth chunk (out_len {n})"),
                        ("snappy_walk", f"{s_rows.shape[0]} live rows of the "
                         f"host engine's 4 MB snappy synth chunk (out_len "
                         f"{sn}), {over.numel()} of them also at the "
                         "escalated budget")):
        r = out[name]
        print(f"kernel {name} inputs: {shape}, {r['records']} records, "
              f"{r['accepted']} rows accepted at the default budget; held "
              f"on host-engine, generated and token-dense rows too")
    r = out["snappy_walk"]
    print(f"kernel snappy_walk at the escalated budget ({hmr} records): "
          f"{r['high_records']} records, the densest row {r['densest_records']};"
          f" {r['high_ms']:.4f} ms per call alone; {r['high_device_ms']:.4f} ms "
          f"on the card ({_device_label(r['high_device_ms_source'])}), "
          f"{r['ns_per_record']:.1f} ns a record on the densest row")
    r = out["lz4_walk"]
    print(f"kernel lz4_walk on numcodecs' default chunk (host-engine LZ4 "
          f"clevel 5, 4 MB synth: {r['chunk5_rows']} live rows of "
          f"{r['chunk5_out_len'] >> 10} KB, {r['chunk5_dense_rows']} dense): "
          + "; ".join(
              f"{b} budget ({r[f'chunk5_{b}_budget']} slots) "
              f"{r[f'chunk5_{b}_device_ms']:.4f} ms on the card "
              f"({_device_label(r[f'chunk5_{b}_device_ms_source'])}), "
              f"{r[f'chunk5_{b}_ms']:.4f} ms per call alone, "
              f"{r[f'chunk5_{b}_records']} records, "
              f"{r[f'chunk5_{b}_accepted']} rows accepted, bound "
              f"{r[f'chunk5_{b}_bound_ms']:.6f} ms, all slots' 16 B "
              f"{r[f'chunk5_{b}_slots_ms']:.6f} ms; 32 copies in one launch "
              f"{r[f'chunk5x32_{b}_device_ms']:.4f} ms (bound "
              f"{r[f'chunk5x32_{b}_bound_ms']:.6f}, slots "
              f"{r[f'chunk5x32_{b}_slots_ms']:.6f})"
              for b in ("default", "escalated"))
          + f"; the densest row {r['densest_records']} records, "
          f"{r['ns_per_record']:.1f} ns a record at the escalated budget; "
          f"held to the plain version (on the host) on 2 dense and "
          f"{r['chunk5_short_rows']} short rows at both budgets "
          f"({r['chunk5_plain_s']:.1f} s), the 32 copies to the 24 rows")
    print(f"kernel lz4_walk on {r['long_rows']} generated {ln >> 10} KB "
          f"row ({r['long_records']} records, {r['long_accepted']} accepted): "
          f"{r['long_ms']:.4f} ms per call alone; {r['long_device_ms']:.4f} "
          f"ms on the card ({_device_label(r['long_device_ms_source'])}); "
          f"plain {r['long_plain_ms']:.4f} ms (on the host); bound "
          f"{r['long_bound_ms']:.6f} ms")
    return out


def _lz4_chunk5(dev, lz4_chunk, reps) -> dict:
    """K4 on numcodecs' default chunk (the host engine's LZ4 clevel-5
    chunk of 4 MB synth, whose dense rows overflow the default budget, so
    the byte API runs it twice): its live rows and 32 copies of them in
    one launch (the 128 MB working set; only the chunk's rows repeat) at
    the default and the escalated budget, timed; held to the plain version
    on two dense rows and every short row (the plain loop takes one step a
    sequence), and the copies to the rows. Bound as _walk_entry's; every
    record slot's 16 B, which the bound leaves out, beside it."""
    from cblosc_tpu_torch.gpu import codec_lz4, structured

    rows, cs, n = chunk_rows(dev, lz4_chunk)
    rows, cs = live_rows(rows, cs, n)
    N = rows.shape[0]
    dense = torch.nonzero(cs > n // 2).flatten()
    short = torch.nonzero(cs <= n // 2).flatten()
    rows32, cs32 = rows.repeat(32, 1), cs.repeat(32)
    out = dict(chunk5_rows=N, chunk5_out_len=n,
               chunk5_dense_rows=int(dense.numel()),
               chunk5_short_rows=int(short.numel()))
    err, plain_s = 0, 0.0
    for label, mr in (("default", codec_lz4.max_records(n)),
                      ("escalated", structured.high_records(n))):
        E = structured.record_slots(mr)
        k = codec_lz4.walk(rows, cs, n, mr)
        flat = k[0] + k[1:]
        for sel in (dense[:2], short):
            t0 = time.perf_counter()
            p, _ = _host_plain(codec_lz4._walk_plain, rows[sel], cs[sel], n, E)
            plain_s += time.perf_counter() - t0
            err = max(err, _maxdiff(tuple(t[sel] for t in flat), p[0] + p[1:]))
        k32 = codec_lz4.walk(rows32, cs32, n, mr)
        err = max(err, _maxdiff(k32[0] + k32[1:], tuple(
            t.repeat(32, *([1] * (t.dim() - 1))) for t in flat)))
        call = lambda: codec_lz4.walk(rows, cs, n, mr)  # noqa: E731
        call32 = lambda: codec_lz4.walk(rows32, cs32, n, mr)  # noqa: E731
        d1, s1 = _device_ms(dev, call, "::lz4_walk")
        d32, s32 = _device_ms(dev, call32, "::lz4_walk")
        per_row = (k[0][0] >= 0).sum(dim=1)
        nrec = int(per_row.sum())
        stream = int(cs.sum()) + 4 * N + 6 * N
        out.update({
            f"chunk5_{label}_budget": E,
            f"chunk5_{label}_ms": _ms(dev, call, reps),
            f"chunk5_{label}_device_ms": d1,
            f"chunk5_{label}_device_ms_source": s1,
            f"chunk5_{label}_records": nrec,
            f"chunk5_{label}_accepted": int(k[3].sum()),
            f"chunk5_{label}_bound_ms": (stream + 16 * nrec)
            / HBM_BYTES_PER_S * 1e3,
            f"chunk5_{label}_slots_ms": 16 * N * E / HBM_BYTES_PER_S * 1e3,
            f"chunk5x32_{label}_device_ms": d32,
            f"chunk5x32_{label}_device_ms_source": s32,
            f"chunk5x32_{label}_bound_ms": 32 * (stream + 16 * nrec)
            / HBM_BYTES_PER_S * 1e3,
            f"chunk5x32_{label}_slots_ms": 32 * 16 * N * E
            / HBM_BYTES_PER_S * 1e3})
        if label == "escalated":
            out["densest_records"] = int(per_row.max())
            out["ns_per_record"] = d1 * 1e6 / max(int(per_row.max()), 1)
    check(out["chunk5_escalated_accepted"] == N and dense.numel() > 0
          and out["chunk5_default_accepted"] < N,
          "the clevel-5 chunk's dense rows must overflow the default budget "
          "and walk at the escalated one")
    out["chunk5_plain_s"] = plain_s
    out["chunk5_max_abs_err"] = err
    return out


def phase_ratio_rows(dev, chunks5, reps) -> dict:
    """K2, K1 and K4 on the live rows of the clevel-5 chunks the card
    wrote in run() (128 KB splits): K2 on the blosclz synth and int32
    arange chunks (the arange chunk's staircase rows carry mined
    far-distance tokens, d = 65536), K1 on the records K2 makes of them,
    K4 on the LZ4 synth chunk (numcodecs' default Blosc()) and the LZ4
    uint8 staircase chunk (whose rows carry a mined run abutting a static
    one, so a zero-literal sequence follows a match). Each is held to its
    plain version (K2 and K4 on a host copy, K1 on the card on a few rows)
    and timed. Returns {kernel: extra keys}, each key prefixed cl5_."""
    from cblosc_tpu_torch.gpu import codec_lz4, structured

    def rows_of(labels):
        parts = []
        for label in labels:
            rows, cs, n = chunk_rows(dev, chunks5[label])
            parts.append((*live_rows(rows, cs, n), n))
        check(len({p[2] for p in parts}) == 1, "clevel-5 splits differ")
        return (torch.cat([p[0] for p in parts]),
                torch.cat([p[1] for p in parts]), parts[0][2])

    rows, cs, n = rows_of([k for k in chunks5 if k.startswith("blosclz")])
    mr = structured.max_records(n)
    walk = _walk_entry(dev, structured.walk, structured._walk_plain, "::walk",
                       rows, cs, n, mr, reps)
    check(walk["max_abs_err"] == 0,
          f"walk kernel differs from its plain version on the clevel-5 rows "
          f"({walk['max_abs_err']})")
    check(walk["accepted"] == walk["rows"],
          "every live clevel-5 blosclz row must walk")
    rf = structured.walk(rows, cs, n, mr)[0]
    far = int(((rf[0] == 1) & (rf[1] > 8191)).any(dim=1).sum())
    check(far > 0, "no clevel-5 blosclz row carries a far-distance match")
    per_row = (rf[0] >= 0).sum(dim=1)
    held = [int(i) for i in torch.argsort(per_row, descending=True)[:2]]
    held.append(int(torch.argmin(per_row)))
    exp = k1_on_rows(dev, "cl5", rows, rf, n, held, reps)

    lrows, lcs, ln = rows_of([k for k in chunks5 if k.startswith("lz4")])
    lz4 = _walk_entry(dev, codec_lz4.walk, codec_lz4._walk_plain,
                      "::lz4_walk", lrows, lcs, ln,
                      codec_lz4.max_records(ln), reps)
    check(lz4["max_abs_err"] == 0,
          f"lz4_walk kernel differs from its plain version on the clevel-5 "
          f"rows ({lz4['max_abs_err']})")
    check(lz4["accepted"] == lz4["rows"],
          "every live clevel-5 LZ4 row must walk")
    kind = codec_lz4.walk(lrows, lcs, ln, codec_lz4.max_records(ln))[0][0]
    abut = int(((kind[:, 1:] == 1) & (kind[:, :-1] == 1)).sum())
    check(abut > 0, "no clevel-5 LZ4 row carries abutting sequences")
    walk.update(far_rows=far)
    lz4.update(abutting=abut)
    print(f"kernel inputs, clevel 5 (card-written chunks): {walk['rows']} "
          f"blosclz rows ({walk['records']} records, {far} rows with a "
          f"far-distance match), {lz4['rows']} LZ4 rows ({lz4['records']} "
          f"records, {abut} matches that follow a match), out_len {n}")
    for name, r in (("walk", walk), ("lz4_walk", lz4)):
        print(f"kernel {name} on the clevel-5 rows: equal to plain "
              f"(max_abs_err {r['max_abs_err']}); {r['ms']:.4f} ms per call "
              f"alone (CUDA events); {r['device_ms']:.4f} ms on the card "
              f"({_device_label(r['device_ms_source'])}); plain "
              f"{r['plain_ms']:.4f} ms (on the host); bound "
              f"{r['bound_ms']:.6f} ms")
    print_k1_rows(exp, "cl5", "the clevel-5 blosclz rows")
    return {"walk": {f"cl5_{k}": v for k, v in walk.items()},
            "lz4_walk": {f"cl5_{k}": v for k, v in lz4.items()},
            "expand": exp}


# K1's branch on every main-path input: (label, rows, rows on the
# per-record loop, largest number of jumping rounds)
K1_BRANCHES: list = []


def k1_branches(label, src, rf, n, ok=None) -> None:
    """K1 with its per-row branch stats (expand's stats argument) on one
    main-path input (the rows ok selects): every row must take the
    pointer-jumping path; the line of phase 2 prints the rows and the
    largest number of jumping rounds."""
    from cblosc_tpu_torch.gpu import expand

    if ok is not None:
        k = torch.nonzero(ok).flatten()
        src, rf = src[k].contiguous(), tuple(f[k].contiguous() for f in rf)
    stats = torch.empty(src.shape[0], dtype=torch.int32, device=src.device)
    expand.expand(src, rf, n, stats)
    serial = int((stats < 0).sum())
    K1_BRANCHES.append((label, src.shape[0], serial,
                        int(stats.max()) if stats.numel() else 0))
    check(serial == 0, f"expand: {serial} main-path rows of {label} took the "
          "per-record branch")


def k1_on_rows(dev, label, src, rf, n, held, reps) -> dict:
    """K1 on a codec's main-path rows (every row the walk accepted): its
    branch stats, equal to the plain expand on the card on the `held`
    rows (the plain loop takes one record index a step), timed alone and
    by the profiler; bound = (literal bytes read + 16 B a record + out_len
    a row) / HBM rate. Keys prefixed with `label`."""
    from cblosc_tpu_torch.gpu import expand

    k1_branches(f"the {label} chunk", src, rf, n)
    sel = torch.as_tensor(held, device=src.device)
    hs, hrf = src[sel].contiguous(), tuple(f[sel].contiguous() for f in rf)
    t0 = time.perf_counter()
    err = _maxdiff([expand.expand(hs, hrf, n)],
                   [expand._expand_plain(hs, hrf, n)])
    if dev.type == "cuda":
        torch.cuda.synchronize()
    plain_s = time.perf_counter() - t0
    check(err == 0, f"expand kernel differs from its plain version on the "
          f"{label} rows ({err})")
    call = lambda: expand.expand(src, rf, n)  # noqa: E731
    device_ms, source = _device_ms(dev, call, "::expand_kernel")
    N = src.shape[0]
    valid = rf[0] >= 0
    nrec = int(valid.sum())
    lits = int(torch.where(valid & (rf[0] == 0), rf[3], 0).sum())
    return {f"{label}_max_abs_err": err, f"{label}_ms": _ms(dev, call, reps),
            f"{label}_device_ms": device_ms,
            f"{label}_device_ms_source": source,
            f"{label}_bound_ms": (lits + 16 * nrec + N * n)
            / HBM_BYTES_PER_S * 1e3,
            f"{label}_rows": N, f"{label}_records": nrec,
            f"{label}_literal_bytes": lits, f"{label}_held_rows": len(held),
            f"{label}_held_s": plain_s}


def print_k1_rows(e: dict, label: str, what: str) -> None:
    print(f"kernel expand on {what}: {e[label + '_records']} records, "
          f"{e[label + '_literal_bytes']} literal bytes; equal to plain on "
          f"{e[label + '_held_rows']} rows on the card "
          f"({e[label + '_held_s']:.1f} s); {e[label + '_ms']:.4f} ms per "
          f"call alone (CUDA events); {e[label + '_device_ms']:.4f} ms on "
          f"the card ({_device_label(e[label + '_device_ms_source'])}); "
          f"bound {e[label + '_bound_ms']:.6f} ms")


def _zlib_fields(walk):
    """A zlib walk's outputs as one flat tuple of tensors."""
    tape, tlen, rf, dist, uni, ok = walk
    return (tape, tlen, *rf, dist, uni, ok)


def _zlib_replayed(dev, rows, cs, n, budget) -> int:
    """K6 + K1 (codec_zlib.decode) on every row at `budget`: each must
    decode, to zlib.decompress's bytes of its stream. Returns the rows."""
    from cblosc_tpu_torch.gpu import codec_zlib

    out, _, err = codec_zlib.decode(rows, cs, n, budget)
    check(not bool(err.any()), "a valid zlib row did not decode on the card")
    out, rows_h, cs_h = out.cpu().numpy(), rows.cpu().numpy(), cs.cpu().numpy()
    for i in range(rows_h.shape[0]):
        want = zlib.decompress(rows_h[i, :cs_h[i]].tobytes())
        check(out[i].tobytes() == want,
              "K6 + K1 differ from zlib.decompress on a zlib row")
    return rows_h.shape[0]


def phase_zlib_walk(dev, z_chunk, reps):
    """K6 (zlib walk) against its plain version on host copies of the same
    CUDA tensors (tolerance 0 on the tape, tlen, records, dist, uni and
    ok): the non-dense live rows of the 4 MB synth clevel-5 chunk at the
    default budget, and the generated rows of streams.ZLIB_CARD_CASES
    with one-byte flips and random rows. The plain loop takes about a
    millisecond per symbol step on the host, so rows of tens of
    thousands of events (the chunk's dense rows, the generated
    Huffman-only rows) are held instead by K6 + K1 at the escalated
    budget against zlib.decompress. Timed on the chunk's live rows at
    the escalated budget; bound = (stream bytes + csizes + tape bytes +
    16 B per record + tlen, dist, uni and ok) / HBM rate."""
    from cblosc_tpu_torch.gpu import codec_zlib
    from cblosc_tpu_torch.utils import streams

    rows, cs, n = chunk_rows(dev, z_chunk)
    rows, cs = live_rows(rows, cs, n)
    dflt, hi = codec_zlib.default_events(n), codec_zlib.high_events(n)
    light = torch.nonzero(codec_zlib.fsm_walk(rows, cs, n, dflt)[5]).flatten()
    l_rows, l_cs = rows[light].contiguous(), cs[light].contiguous()
    t0 = time.perf_counter()
    cases = [(l_rows, l_cs, n, dflt)]
    dense_cases = []
    for seed, gn, width in streams.ZLIB_CARD_CASES:
        buf, gcs, kinds = streams.zlib_rows(seed, gn, width, garbage=8)
        g_rows, g_cs = (torch.from_numpy(buf).to(dev),
                        torch.from_numpy(gcs).to(dev))
        cases.append((g_rows, g_cs, gn, codec_zlib.default_events(gn)))
        nv = len(streams.ZLIB_VALID) + 1             # valid rows, "dense" last
        dense_cases.append((g_rows[:nv].contiguous(), g_cs[:nv].contiguous(),
                            gn, codec_zlib.high_events(gn)))
    err, plain_ms = 0, None
    for r, c, gn, mev in cases:
        k = codec_zlib.fsm_walk(r, c, gn, mev)
        p, ms = _host_plain(codec_zlib._fsm_walk_plain, r, c, gn,
                            codec_zlib.event_slots(mev))
        plain_ms = ms if plain_ms is None else plain_ms
        err = max(err, _maxdiff(_zlib_fields(k), _zlib_fields(p)))
    check(err == 0, f"zlib_walk kernel differs from its plain version ({err})")
    held_s = time.perf_counter() - t0
    replayed = _zlib_replayed(dev, rows, cs, n, hi)
    for r, c, gn, mev in dense_cases:
        replayed += _zlib_replayed(dev, r, c, gn, mev)
    print(f"zlib_walk: held against its plain version on {l_rows.shape[0]} "
          f"non-dense live rows of the 4 MB synth clevel-5 chunk and "
          f"{sum(c[0].shape[0] for c in cases[1:])} generated rows "
          f"({held_s:.1f} s); {replayed} rows (the chunk's {rows.shape[0]} "
          f"live rows, the generated valid and Huffman-only rows) held by "
          f"K6 + K1 at the escalated budget against zlib.decompress")

    call = lambda: codec_zlib.fsm_walk(rows, cs, n, hi)  # noqa: E731
    device_ms, source = _device_ms(dev, call, "::zlib_walk")
    k = call()
    N = rows.shape[0]
    nrec = int((k[2][0] >= 0).sum())
    lits = int(k[1].sum())
    events = k[1].to(torch.int64) + (k[2][0] == 1).sum(dim=1)
    dense = int(events.argmax())
    # K1 on the same rows, over the tape, as the byte API places them
    held_rows = [int(i) for i in light[:2]]
    e = k1_on_rows(dev, "zlib", k[0], k[2], n, held_rows, reps)
    held_call = lambda: codec_zlib.fsm_walk(l_rows, l_cs, n, dflt)  # noqa: E731
    hk = held_call()
    hN = l_rows.shape[0]
    r = dict(
        max_abs_err=err,
        ms=_ms(dev, call, reps),
        device_ms=device_ms, device_ms_source=source,
        call_ms=_ms(dev, call, reps, batch=BATCH),
        plain_ms=plain_ms, plain_on="host",
        bound_ms=(int(cs.sum()) + 4 * N + lits + 16 * nrec + 10 * N)
        / HBM_BYTES_PER_S * 1e3,
        rows=N, records=nrec, literals=lits, accepted=int(k[5].sum()),
        budget=hi, dense_rows=N - hN,
        held_ms=_ms(dev, held_call, reps), held_rows=hN,
        held_bound_ms=(int(l_cs.sum()) + 4 * hN + int(hk[1].sum())
                       + 16 * int((hk[2][0] >= 0).sum()) + 10 * hN)
        / HBM_BYTES_PER_S * 1e3,
        dense_events=int(events[dense]), dense_literals=int(k[1][dense]),
        dense_records=int((k[2][0][dense] >= 0).sum()),
        ns_per_event=device_ms * 1e6 / max(int(events[dense]), 1))
    print(f"kernel zlib_walk inputs: {N} live rows of the host engine's 4 MB "
          f"synth zlib chunk (clevel 5, out_len {n}) at the escalated budget "
          f"({hi} events): {lits} literals, {nrec} records, {r['accepted']} "
          f"rows accepted; {N - hN} rows overflow the default budget "
          f"({dflt} events). The {hN} others at the default budget: "
          f"{r['held_ms']:.4f} ms per call alone (CUDA events) against plain "
          f"{plain_ms:.4f} ms (on the host); bound {r['held_bound_ms']:.6f} ms."
          f" The densest row: {r['dense_events']} events ({r['dense_literals']}"
          f" literals, {r['dense_records']} records), {r['ns_per_event']:.1f} "
          "ns an event on the card")
    print_k1_rows(e, "zlib", f"the {N} live rows of the 4 MB synth "
                  "clevel-5 zlib chunk (over the tape, escalated budget)")
    return {"zlib_walk": r, "expand": e}


def phase_zlib_bench(dev, workset, chunk_bytes, reps, card):
    """128 MB of synth (sbits 19, typesize 8) in zlib chunks from the host
    engine at clevel 5; all their rows gathered as the byte API gathers
    them and decoded by gpu.pipeline.decompress_blocks at the escalated
    budget (the one the byte API settles on for these chunks), verified
    equal and timed with CUDA events. The launch counters are zeroed just
    before the first decode and read just after it."""
    from cblosc_tpu_torch.format import constants as C
    from cblosc_tpu_torch.format.header import ChunkHeader
    from cblosc_tpu_torch.gpu import codec_zlib, kernels, pipeline
    from cblosc_tpu_torch.utils.timing import synth

    data = synth(workset, 8, 19)
    t0 = time.perf_counter()
    chunks = [host_codec_chunk(C.ZLIB, 5, data[i:i + chunk_bytes].tobytes(), 8)
              for i in range(0, workset, chunk_bytes)]
    host_s = time.perf_counter() - t0
    hdr = ChunkHeader.decode(chunks[0])
    check(hdr.leftover == 0, "zlib bench chunks must hold full blocks only")
    parts = [chunk_rows(dev, c) for c in chunks]
    rows = torch.cat([p[0] for p in parts])
    cs = torch.cat([p[1] for p in parts])
    neblock = parts[0][2]
    nsplits = hdr.blocksize // neblock
    hi = codec_zlib.high_events(neblock)

    def dec():
        return pipeline.decompress_blocks(rows, cs, neblock, C.SHUFFLE, 8,
                                          nsplits, C.ZLIB, hi)

    kernels.reset_launches()
    out, err = dec()
    launches = dict(kernels.LAUNCHES)
    if dev.type == "cuda":
        for name in ("zlib_walk", "expand"):
            check(launches[name] > 0, f"bench zlib: kernel {name} was not "
                  "launched")
    check(not bool(err.any()), "bench zlib: decode reported err")
    check(torch.equal(out.reshape(-1), torch.from_numpy(data).to(dev)),
          "bench zlib: decode differs from the input")
    l_rows, l_cs = live_rows(rows, cs, neblock)
    over = int((~codec_zlib.fsm_walk(l_rows, l_cs, neblock,
                                     codec_zlib.default_events(neblock))[5])
               .sum())
    td = _ms(dev, dec, reps)
    cbytes = sum(len(c) for c in chunks)
    print(json.dumps({
        "bench": "zlib synth sbits19 ts8", "codec": "zlib", "bytes": workset,
        "clevel": 5, "typesize": 8, "ratio": workset / cbytes,
        "host_compress_s": host_s, "decompress_ms": td,
        "decompress_gbps": workset / td / 1e6, "rows": rows.shape[0],
        "live_rows": l_rows.shape[0], "rows_over_default_budget": over,
        "events_budget": hi, "decompress_launches": launches, "card": card,
        "timer": "call time on the CUDA stream (events; includes host syncs)"
        if dev.type == "cuda" else "host clock (rehearsal)"}))


def _zstd_fields(walk):
    """A zstd walk's outputs as one flat tuple of tensors."""
    tape, tlen, rf, ok = walk
    return (tape, tlen, *rf, ok)


def _zstd_replayed(dev, rows, cs, n, budget=0) -> int:
    """K7 + K1 (codec_zstd.decode) on every row: each must decode, to
    libzstd's ZSTD_decompress bytes of its frame. Returns the rows."""
    from cblosc_tpu_torch.gpu import codec_zstd
    from cblosc_tpu_torch.ops.codecs import zstd_

    out, _, err = codec_zstd.decode(rows, cs, n, budget)
    check(not bool(err.any()), "a valid zstd row did not decode on the card")
    out, rows_h, cs_h = out.cpu().numpy(), rows.cpu().numpy(), cs.cpu().numpy()
    for i in range(rows_h.shape[0]):
        want = zstd_.decompress(rows_h[i, :cs_h[i]].tobytes(), n)
        check(out[i].tobytes() == want,
              "K7 + K1 differ from libzstd on a zstd row")
    return rows_h.shape[0]


def phase_zstd_walk(dev, z1_chunk, z5_chunk, reps):
    """K7 (zstd walk) against its plain version on host copies of the same
    CUDA tensors (tolerance 0 on the tape, tlen, records and ok) at the
    default budget: the generated frames of streams.ZSTD_CARD_CASES up to
    32 KB with one-byte flips and random rows, 4 live rows of the 4 MB
    synth clevel-1 chunk (32 KB blocks, Huffman literals) and 2 of the
    clevel-5 chunk (256 KB blocks, about 6,600 sequences each: the plain
    loop takes one sequence a step). K7 + K1 then replay every live row
    of both chunks and every valid generated frame (128 KB ones too) to
    libzstd's bytes. Timed on the clevel-5 chunk's live rows at the
    default budget; bound = (stream bytes + csizes + tape bytes + 16 B per
    record + tlen and ok) / HBM rate."""
    from cblosc_tpu_torch.gpu import codec_zstd
    from cblosc_tpu_torch.utils import streams

    r5, c5, n5 = chunk_rows(dev, z5_chunk)
    r5, c5 = live_rows(r5, c5, n5)
    r1, c1, n1 = chunk_rows(dev, z1_chunk)
    r1, c1 = live_rows(r1, c1, n1)
    t0 = time.perf_counter()
    cases = [(r1[:4].contiguous(), c1[:4].contiguous(), n1),
             (r5[:2].contiguous(), c5[:2].contiguous(), n5)]
    valid = []
    for seed, gn, width in streams.ZSTD_CARD_CASES:
        buf, gcs, kinds = streams.zstd_rows(seed, gn, width, garbage=8)
        g_rows, g_cs = (torch.from_numpy(buf).to(dev),
                        torch.from_numpy(gcs).to(dev))
        if gn <= 32768:
            cases.append((g_rows, g_cs, gn))
        nv = len(streams.ZSTD_VALID) + 1             # valid rows, "dense" last
        valid.append((g_rows[:nv].contiguous(), g_cs[:nv].contiguous(), gn))
    err, plain_ms, held = 0, {}, 0
    for r, c, gn in cases:
        mev = codec_zstd.default_events(gn)
        k = codec_zstd.fsm_walk(r, c, gn, mev)
        p, ms = _host_plain(codec_zstd._fsm_walk_plain, r, c, gn,
                            codec_zstd.event_slots(mev))
        plain_ms.setdefault(gn, ms)
        held += r.shape[0]
        err = max(err, _maxdiff(_zstd_fields(k), _zstd_fields(p)))
    check(err == 0, f"zstd_walk kernel differs from its plain version ({err})")
    held_s = time.perf_counter() - t0
    replayed = _zstd_replayed(dev, r5, c5, n5) + _zstd_replayed(dev, r1, c1, n1)
    for r, c, gn in valid:
        replayed += _zstd_replayed(dev, r, c, gn)
    print(f"zstd_walk: held against its plain version on {held} rows (4 live "
          f"rows of the 4 MB synth clevel-1 chunk, 2 of the clevel-5 chunk, "
          f"the generated rows up to 32 KB; {held_s:.1f} s); {replayed} rows "
          f"(all {r1.shape[0]} + {r5.shape[0]} live rows of the two chunks, "
          "the valid generated frames up to 128 KB) held by K7 + K1 against "
          "libzstd")

    dflt = codec_zstd.default_events(n5)
    call = lambda: codec_zstd.fsm_walk(r5, c5, n5, dflt)  # noqa: E731
    device_ms, source = _device_ms(dev, call, "::zstd_walk")
    k = call()
    N = r5.shape[0]
    nrec = int((k[2][0] >= 0).sum())
    lits = int(k[1].sum())
    accepted = int(k[3].sum())
    seqs = torch.empty(N, dtype=torch.int32, device=r5.device)
    codec_zstd.fsm_walk(r5, c5, n5, dflt, stats=seqs)
    check(accepted == N, "the clevel-5 chunk's rows must walk at the default "
          "budget")
    # K1 on the same rows, over [tape | stream], as the byte API places
    # them; its branch on the clevel-1 chunk's rows too
    e = k1_on_rows(dev, "zstd", torch.cat([k[0], r5], dim=1), k[2], n5,
                   [0, 1], reps)
    k1c = codec_zstd.fsm_walk(r1, c1, n1, codec_zstd.default_events(n1))
    k1_branches("the zstd clevel-1 chunk", torch.cat([k1c[0], r1], dim=1),
                k1c[2], n1, k1c[3])
    r = dict(
        max_abs_err=err,
        ms=_ms(dev, call, reps),
        device_ms=device_ms, device_ms_source=source,
        call_ms=_ms(dev, call, reps, batch=BATCH),
        plain_ms=plain_ms[n5], plain_on="host", plain_rows=2,
        bound_ms=(int(c5.sum()) + 4 * N + lits + 16 * nrec + 5 * N)
        / HBM_BYTES_PER_S * 1e3,
        rows=N, records=nrec, tape_bytes=lits, accepted=accepted,
        budget=dflt, sequences=int(seqs.sum()),
        longest_row_sequences=int(seqs.max()),
        ns_per_sequence=device_ms * 1e6 / max(int(seqs.max()), 1))
    print(f"kernel zstd_walk inputs: {N} live rows of the host engine's 4 MB "
          f"synth zstd chunk (clevel 5, out_len {n5}) at the default budget "
          f"({dflt} events): {lits} tape bytes, {nrec} records, {accepted} rows "
          f"accepted; plain {plain_ms[n5]:.1f} ms for 2 of them, "
          f"{plain_ms[n1]:.1f} ms for 4 clevel-1 rows (on the host). "
          f"{r['sequences']} sequences, the longest row "
          f"{r['longest_row_sequences']}: {r['ns_per_sequence']:.1f} ns a "
          "sequence on the card")
    print_k1_rows(e, "zstd", f"the {N} live rows of the 4 MB synth "
                  "clevel-5 zstd chunk (over [tape | stream])")
    return {"zstd_walk": r, "expand": e}


def phase_zstd_bench(dev, workset, chunk_bytes, reps, card, clevel):
    """128 MB of synth (sbits 19, typesize 8) in zstd chunks from the host
    engine at `clevel`; all their rows gathered as the byte API gathers
    them and decoded by gpu.pipeline.decompress_blocks at the default
    budget, verified equal and timed with CUDA events. The launch
    counters are zeroed just before the first decode and read just after
    it."""
    from cblosc_tpu_torch.format import constants as C
    from cblosc_tpu_torch.format.header import ChunkHeader
    from cblosc_tpu_torch.gpu import codec_zstd, kernels, pipeline
    from cblosc_tpu_torch.utils import streams
    from cblosc_tpu_torch.utils.timing import synth

    data = synth(workset, 8, 19)
    t0 = time.perf_counter()
    chunks = [host_codec_chunk(C.ZSTD, clevel,
                               data[i:i + chunk_bytes].tobytes(), 8)
              for i in range(0, workset, chunk_bytes)]
    host_s = time.perf_counter() - t0
    hdr = ChunkHeader.decode(chunks[0])
    check(hdr.leftover == 0, "zstd bench chunks must hold full blocks only")
    parts = [chunk_rows(dev, c) for c in chunks]
    rows = torch.cat([p[0] for p in parts])
    cs = torch.cat([p[1] for p in parts])
    neblock = parts[0][2]
    nsplits = hdr.blocksize // neblock

    def dec():
        return pipeline.decompress_blocks(rows, cs, neblock, C.SHUFFLE, 8,
                                          nsplits, C.ZSTD)

    kernels.reset_launches()
    out, err = dec()
    launches = dict(kernels.LAUNCHES)
    if dev.type == "cuda":
        for name in ("zstd_walk", "expand"):
            check(launches[name] > 0, f"bench zstd clevel {clevel}: kernel "
                  f"{name} was not launched")
    check(not bool(err.any()), f"bench zstd clevel {clevel}: decode reported "
          "err")
    check(torch.equal(out.reshape(-1), torch.from_numpy(data).to(dev)),
          f"bench zstd clevel {clevel}: decode differs from the input")
    l_rows, l_cs = live_rows(rows, cs, neblock)
    over = int((~codec_zstd.fsm_walk(l_rows, l_cs, neblock,
                                     codec_zstd.default_events(neblock))[3])
               .sum())
    host = int((~codec_zstd.fsm_walk(l_rows, l_cs, neblock,
                                     codec_zstd.high_events(neblock))[3])
               .sum())
    # rows the JAX machine rejects for a zero run of more than 8 repeat
    # flags in a count description (ROADMAP §3); the port decodes them
    lrh, lch = l_rows.cpu().numpy(), l_cs.cpu().numpy()
    long_runs = sum("zero_run_flags_9" in streams.zstd_features(
        lrh[i, :lch[i]].tobytes()) for i in range(lrh.shape[0]))
    td = _ms(dev, dec, reps)
    # K7 alone, one launch over every live row at the default budget (the
    # decode launches it once per 64 MB group)
    dflt = codec_zstd.default_events(neblock)
    walk = lambda: codec_zstd.fsm_walk(l_rows, l_cs, neblock, dflt)  # noqa: E731
    w_dev, w_src = _device_ms(dev, walk, "::zstd_walk")
    wk = walk()
    seqs = torch.empty(l_rows.shape[0], dtype=torch.int32, device=l_rows.device)
    codec_zstd.fsm_walk(l_rows, l_cs, neblock, dflt, stats=seqs)
    wN = l_rows.shape[0]
    k7 = {"rows": wN, "ms": _ms(dev, walk, reps), "device_ms": w_dev,
          "device_ms_source": w_src, "tape_bytes": int(wk[1].sum()),
          "records": int((wk[2][0] >= 0).sum()),
          "longest_row_sequences": int(seqs.max()),
          "bound_ms": (int(l_cs.sum()) + 4 * wN + int(wk[1].sum())
                       + 16 * int((wk[2][0] >= 0).sum()) + 5 * wN)
          / HBM_BYTES_PER_S * 1e3}
    cbytes = sum(len(c) for c in chunks)
    print(json.dumps({
        "bench": "zstd synth sbits19 ts8", "codec": "zstd", "bytes": workset,
        "clevel": clevel, "typesize": 8, "blocksize": hdr.blocksize,
        "ratio": workset / cbytes, "host_compress_s": host_s,
        "decompress_ms": td, "decompress_gbps": workset / td / 1e6,
        "rows": rows.shape[0], "live_rows": l_rows.shape[0],
        "rows_over_default_budget": over, "rows_to_host": host,
        "rows_with_long_zero_runs": long_runs,
        "events_budget": codec_zstd.default_events(neblock),
        "decompress_launches": launches, "zstd_walk_alone": k7, "card": card,
        "timer": "call time on the CUDA stream (events; includes host syncs)"
        if dev.type == "cuda" else "host clock (rehearsal)"}))
    return {f"bench_cl{clevel}_{k}": v for k, v in k7.items()}


def _pack_one(stream: bytes, width: int):
    buf = np.zeros((1, width), np.uint8)
    buf[0, :len(stream)] = np.frombuffer(stream, np.uint8)
    return buf, np.asarray([len(stream)], np.int32)


def phase_kernels(dev, chunk_bytes, host_chunk, reps):
    """Each kernel against its plain version on the same inputs (the
    serial machines' plain versions on a host copy, see _host_plain)."""
    from cblosc_tpu_torch.gpu import codec, expand, structured

    out = {}
    a_rows, a_cs, n = main_path_walk_rows(dev, chunk_bytes)
    h_rows, h_cs, hn, nvalid = host_encoder_rows(dev)
    c_rows, c_cs, cn = chunk_rows(dev, host_chunk)
    gen = generated_rows(dev)
    print(f"kernel inputs: {a_rows.shape[0]} main-path walk rows "
          f"(int32 arange, out_len {n}); {h_rows.shape[0]} host-encoder rows "
          f"({nvalid} valid, {h_rows.shape[0] - nvalid} corrupted); "
          f"{c_rows.shape[0]} clevel-9 host-chunk rows (out_len {cn}); "
          f"{sum(g[0].shape[0] for g in gen)} generated raw-stream rows "
          f"(out_len {', '.join(str(g[2]) for g in gen)})")
    maxrec = structured.max_records(n)
    E = structured.record_slots(maxrec)

    # K2 walk
    rf, dist, uni, ok = structured.walk(a_rows, a_cs, n, maxrec)
    p, walk_plain_ms = _host_plain(structured._walk_plain, a_rows, a_cs, n, E)
    err = _maxdiff((*rf, dist, uni, ok), p[0] + p[1:])
    for rows, cs, ol in ((h_rows, h_cs, hn), *gen):
        mr = structured.max_records(ol)
        k = structured.walk(rows, cs, ol, mr)
        p, _ = _host_plain(structured._walk_plain, rows, cs, ol,
                           structured.record_slots(mr))
        err = max(err, _maxdiff(k[0] + k[1:], p[0] + p[1:]))
    check(err == 0, f"walk kernel differs from its plain version ({err})")
    check(bool(ok.all()), "main-path walk rows must all parse")
    nrec = int((rf[0] >= 0).sum())
    N = a_rows.shape[0]
    csum = int(a_cs.sum())
    walk_call = lambda: structured.walk(a_rows, a_cs, n, maxrec)  # noqa: E731
    # bound: the rows read and the valid records written (bound_ms), or
    # every record slot, since the kernel writes the -1/zero tail too
    device_ms, source = _device_ms(dev, walk_call, "::walk")
    out["walk"] = dict(
        max_abs_err=err,
        ms=_ms(dev, walk_call, reps),
        device_ms=device_ms, device_ms_source=source,
        call_ms=_ms(dev, walk_call, reps, batch=BATCH),
        plain_ms=walk_plain_ms, plain_on="host",
        bound_ms=(csum + 4 * N + 16 * nrec + 9 * N) / HBM_BYTES_PER_S * 1e3,
        bound_slots_ms=(csum + 4 * N + 16 * N * E + 9 * N)
        / HBM_BYTES_PER_S * 1e3)
    # the walk's other main-path shape: the clevel-9 row at its default
    # budget, which it overflows (the byte API then decodes it with K3).
    # Bound: the stream up to the end of the last literal it emitted (less
    # than it reads) and the records it emitted.
    cmr = structured.max_records(cn)
    long_call = lambda: structured.walk(c_rows, c_cs, cn, cmr)  # noqa: E731
    p, long_plain_ms = _host_plain(structured._walk_plain, c_rows, c_cs, cn,
                                   structured.record_slots(cmr))
    k = long_call()
    err = _maxdiff(k[0] + k[1:], p[0] + p[1:])
    check(err == 0, f"walk kernel differs from its plain version ({err})")
    (lkind, larg, _, llen), _, _, lok = k
    check(not bool(lok.any()),
          "the clevel-9 row must overflow the default walk budget")
    lread = int(torch.where(lkind == 0, larg + llen, 0).amax(dim=1).sum())
    Nc = c_rows.shape[0]
    device_ms, source = _device_ms(dev, long_call, "::walk")
    out["walk"].update(
        long_ms=_ms(dev, long_call, reps),
        long_device_ms=device_ms, long_device_ms_source=source,
        long_plain_ms=long_plain_ms,
        long_bound_ms=(lread + 4 * Nc + 16 * int((lkind >= 0).sum()) + 9 * Nc)
        / HBM_BYTES_PER_S * 1e3)

    # K1 expand: main-path records and host-encoder (mixed distances)
    k1_branches("the int32 arange chunk", a_rows, rf, n)
    hrf = structured.walk(h_rows, h_cs, hn, maxrec)[0]
    err = 0
    for rows, rfx, ol in ((a_rows, rf, n), (h_rows, hrf, hn)):
        err = max(err, _maxdiff([expand.expand(rows, rfx, ol)],
                                [expand._expand_plain(rows, rfx, ol)]))
    check(err == 0, f"expand kernel differs from its plain version ({err})")
    expand_call = lambda: expand.expand(a_rows, rf, n)  # noqa: E731
    device_ms, source = _device_ms(dev, expand_call, "::expand_kernel")
    out["expand"] = dict(
        max_abs_err=err,
        ms=_ms(dev, expand_call, reps),
        device_ms=device_ms, device_ms_source=source,
        call_ms=_ms(dev, expand_call, reps, batch=BATCH),
        plain_ms=_ms(dev, lambda: expand._expand_plain(a_rows, rf, n),
                     1), plain_on="card",
        bound_ms=(csum + 16 * nrec + N * n) / HBM_BYTES_PER_S * 1e3)

    # K3 generic decoder: the main path's clevel-9 host-chunk rows, and
    # valid and corrupted host-encoder streams
    k = codec.decode(h_rows, h_cs, hn)
    err = _maxdiff(k, _host_plain(codec._decode_plain, h_rows, h_cs, hn)[0])
    check(not bool(k[2][:nvalid].any()), "valid host streams must decode")
    check(bool(k[2][nvalid:].any()), "some corrupted streams must report err")
    for rows, cs, ol in gen:
        err = max(err, _maxdiff(codec.decode(rows, cs, ol),
                                _host_plain(codec._decode_plain, rows, cs,
                                            ol)[0]))
    k = codec.decode(c_rows, c_cs, cn)
    p, plain_ms = _host_plain(codec._decode_plain, c_rows, c_cs, cn)
    err = max(err, _maxdiff(k, p))
    check(err == 0, f"decode kernel differs from its plain version ({err})")
    check(not bool(k[2].any()), "host-chunk rows must decode")
    decode_call = lambda: codec.decode(c_rows, c_cs, cn)  # noqa: E731
    device_ms, source = _device_ms(dev, decode_call, "::decode_kernel")
    out["decode_one"] = dict(
        max_abs_err=err,
        ms=_ms(dev, decode_call, reps),
        device_ms=device_ms, device_ms_source=source,
        call_ms=_ms(dev, decode_call, reps, batch=BATCH),
        plain_ms=plain_ms, plain_on="host",
        bound_ms=(int(c_cs.sum()) + 4 * Nc + Nc * cn + 5 * Nc)
        / HBM_BYTES_PER_S * 1e3)
    # tokens of the timed rows: the walk's records at a budget every
    # stream fits
    hrf, _, _, hok = structured.walk(c_rows, c_cs, cn,
                                     structured.high_records(cn))
    check(bool(hok.all()), "the host-chunk rows must walk at the high budget")
    ntok = int((hrf[0] >= 0).sum())
    d = out["decode_one"]
    print(f"decode_one timed rows: {ntok} tokens in {int(c_cs.sum())} stream "
          f"bytes; {d['ms'] * 1e6 / ntok:.1f} ns per token per call alone, "
          f"{d['device_ms'] * 1e6 / ntok:.1f} on the card")
    for name, r in out.items():
        print_kernel(name, r)
    w = out["walk"]
    print(f"kernel walk on the {cn >> 10} KB clevel-9 row (budget {cmr}): "
          f"{w['long_ms']:.4f} ms per call alone; {w['long_device_ms']:.4f} "
          f"ms on the card ({_device_label(w['long_device_ms_source'])}); "
          f"plain {w['long_plain_ms']:.4f} ms (on the host); bound "
          f"{w['long_bound_ms']:.6f} ms")
    return out


def phase_byte_api(dev, chunk_bytes, low, host_chunk, codec_chunks,
                   host_only=(), ratio_chunks=()):
    """The main path through the entry points a user calls.
    codec_chunks: [(label, data, chunk, walk kernel)] of host-engine LZ4,
    snappy, zlib and zstd chunks, each decoded through gpu.host_api on
    the card; host_only: [(label, data, chunk)] that gpu.host_api must
    decline (the JAX package's bridge declines them too), decoded by the
    byte API on the host engine; ratio_chunks: [(label, data, chunk
    written by the card, chunk written by the port on the CPU, kernels
    its decode must launch)] at clevels 5 and 9, each chunk equal to the
    CPU's and decoded through gpu.host_api on the card."""
    import cblosc_tpu_torch as tb
    from cblosc_tpu_torch.core import engine
    from cblosc_tpu_torch.format import constants as C
    from cblosc_tpu_torch.gpu import host_api, kernels
    from cblosc_tpu_torch.utils.timing import synth

    totals = dict.fromkeys(kernels.LAUNCHES, 0)

    def count(fn):
        return counted(totals, fn)

    def device_decode(label, c, need):
        """Decode through the device bridge (None would be the host
        fallback) and check that the kernels in need launched."""
        t0 = time.perf_counter()
        r, delta = count(lambda: host_api.decompress_chunk(c, None, dev))
        t1 = time.perf_counter()
        check(r is not None, f"{label}: the device path declined the chunk")
        if dev.type == "cuda":
            for name in need:
                check(delta[name] > 0, f"{label}: decode did not launch {name}")
        return r, t1 - t0, delta

    def roundtrip(label, clevel, shuffle, ts, data, compressor="blosclz",
                  need=()):
        t0 = time.perf_counter()
        c = tb.compress_ctx(clevel, shuffle, ts, data, compressor=compressor,
                            device=dev)
        t1 = time.perf_counter()
        r, td, delta = device_decode(label, c, need)
        check(r == data, f"{label}: round trip differs")
        check(count(lambda: tb.decompress_ctx(c, device=dev))[0] == data,
              f"{label}: byte-API decode differs")
        check(engine.decompress_chunk(c) == data,
              f"{label}: host engine cannot decode the device chunk")
        print(f"byte api {label}: {len(data)} B -> {len(c)} B "
              f"(ratio {len(data) / len(c):.4f}); host clock compress "
              f"{t1 - t0:.3f} s, decompress {td:.3f} s (first calls); "
              f"decompress launches {delta}")

    n = chunk_bytes
    sy = synth(n, 8, 19).tobytes()
    ar = np.arange(n // 4, dtype=np.int32).tobytes()

    roundtrip("synth sbits19 ts8 shuffle", 1, C.SHUFFLE, 8, sy)
    roundtrip("int32 arange ts4 shuffle", 1, C.SHUFFLE, 4, ar,
              need=("walk", "expand"))
    roundtrip("float64 linspace ts8 shuffle", 1, C.SHUFFLE, 8,
              np.linspace(-1.0, 1.0, n // 8).tobytes())
    for comp in ("lz4", "lz4hc"):
        roundtrip(f"{comp} synth sbits19 ts8 shuffle", 1, C.SHUFFLE, 8, sy,
                  comp, need=("lz4_walk",))
        roundtrip(f"{comp} int32 arange ts4 shuffle", 1, C.SHUFFLE, 4, ar,
                  comp, need=("lz4_walk", "expand"))
    r, _, delta = device_decode("host-engine clevel-9 blosclz chunk",
                                host_chunk, ("decode_one",))
    check(r == low, "host-engine clevel-9 chunk decode differs")
    print(f"byte api host-engine clevel-9 low-entropy chunk: {len(low)} B "
          f"<- {len(host_chunk)} B decoded on {dev.type}; "
          f"decompress launches {delta}")
    for label, data, chunk, walk in codec_chunks:
        r, td, delta = device_decode(label, chunk, (walk, "expand"))
        check(r == data, f"{label}: decode differs")
        check(count(lambda: tb.decompress_ctx(chunk, device=dev))[0]
              == data, f"{label}: byte-API decode differs")
        print(f"byte api {label}: {len(data)} B <- {len(chunk)} B decoded "
              f"on {dev.type} in {td:.3f} s (host clock, first call); "
              f"decompress launches {delta}")
    for label, data, chunk, cpu_chunk, need in ratio_chunks:
        check(chunk == cpu_chunk, f"{label}: the card's chunk differs from "
              "the port's device='cpu' chunk of the same buffer")
        r, td, delta = device_decode(label, chunk, need)
        check(r == data, f"{label}: round trip differs")
        check(count(lambda: tb.decompress_ctx(chunk, device=dev))[0]
              == data, f"{label}: byte-API decode differs")
        check(engine.decompress_chunk(chunk) == data,
              f"{label}: host engine cannot decode the card's chunk")
        print(f"byte api {label}: {len(data)} B -> {len(chunk)} B (ratio "
              f"{len(data) / len(chunk):.4f}) written on {dev.type}, equal "
              f"to the CPU's chunk; decompress {td:.3f} s (host clock, first "
              f"call); decompress launches {delta}")
    for label, data, chunk in host_only:
        r, delta = count(lambda: host_api.decompress_chunk(chunk, None, dev))
        check(r is None, f"{label}: the device path must decline it")
        check(tb.decompress_ctx(chunk, device=dev) == data,
              f"{label}: byte-API decode differs")
        print(f"byte api {label}: {len(data)} B <- {len(chunk)} B; its blocks "
              "are above decode_cap, so gpu.host_api declines it (as the JAX "
              "package's bridge does) and the host engine decodes it; "
              f"launches of the declined device attempt {delta}")
    if dev.type == "cuda":
        for name, c in totals.items():
            check(c > 0, f"kernel {name} was not launched on the main path")
    warm = _ms(dev, lambda: tb.decompress_ctx(host_chunk, device=dev), 5)
    print(f"byte api host-engine clevel-9 chunk decode, warm: {warm:.4f} ms "
          f"(median of 5, {'CUDA events' if dev.type == 'cuda' else 'host clock'})")
    return totals


def phase_getitem(dev, cases, reps):
    """getitem through the entry points a user calls (api.getitem and
    gpu.host_api.getitem), on the card. cases: [(label, data, chunk,
    kernels a one-block range must launch, held on the CPU on every
    range)]. Ranges: the first 100 items, 100 items across the first
    block boundary, from the last full block to the end (into the
    leftover where there is one), an empty range at a block boundary,
    the whole chunk. Each result equals the input slice and the port's
    device="cpu" getitem (on the zstd chunk, whose plain walk takes
    seconds a row on the host, only on the one-block range; its other
    ranges against the host engine's getitem too); where gpu.host_api
    declines, the range touches no full block. The rows handed to the
    decoder are recorded: a range decodes its blocks' splits and no
    others. Launch counters are zeroed just before each range's two
    calls and read just after; the phase's launches are their sum.
    Then the card time of a one-block getitem beside the full
    decompress_ctx of the same chunk (CUDA events, median of reps)."""
    import cblosc_tpu_torch as tb
    from cblosc_tpu_torch.core import engine, policy
    from cblosc_tpu_torch.format.header import ChunkHeader
    from cblosc_tpu_torch.gpu import host_api, kernels, pipeline

    totals = dict.fromkeys(kernels.LAUNCHES, 0)
    rows_seen = []
    decode = pipeline.decompress_blocks

    def recording(slots, *a, **k):
        rows_seen.append(slots.shape[0])
        return decode(slots, *a, **k)

    pipeline.decompress_blocks = recording
    try:
        for label, data, chunk, need, cpu_all in cases:
            hdr = ChunkHeader.decode(chunk)
            ts, bs, n = hdr.typesize, hdr.blocksize, hdr.nbytes
            items, nfull = n // ts, n // bs
            nsplits = policy.nsplits_decode(hdr.dont_split, ts, bs, False)
            check(nfull >= 2, f"getitem {label}: {nfull} full blocks, the "
                  "ranges need two")
            tail = nfull * bs // ts - 30 if hdr.leftover else \
                (nfull - 1) * bs // ts + 7
            ranges = [("first 100 items", 0, 100),
                      ("100 items across a block boundary", bs // ts - 50, 100),
                      ("last full block into the leftover" if hdr.leftover
                       else "last full block", tail, items - tail),
                      ("empty range", bs // ts, 0),
                      ("whole chunk", 0, items)]
            for what, start, nitems in ranges:
                want = data[start * ts:(start + nitems) * ts]
                b0 = start * ts // bs
                b_end = min(-(-(start + nitems) * ts // bs), hdr.nblocks)
                b1 = min(b_end, nfull)          # the full blocks decoded
                kernels.reset_launches()
                rows_seen.clear()
                t0 = time.perf_counter()
                dev_out = host_api.getitem(chunk, start, nitems, dev)
                t1 = time.perf_counter()
                rows = list(rows_seen)
                api = tb.getitem(chunk, start, nitems, device=dev)
                delta = dict(kernels.LAUNCHES)
                for k, v in delta.items():
                    totals[k] += v
                check(api == want, f"getitem {label}, {what}: differs from "
                      "the input")
                if b1 <= b0:
                    check(dev_out is None and not rows, f"getitem {label}, "
                          f"{what}: the device path must decline it")
                else:
                    check(dev_out == want, f"getitem {label}, {what}: the "
                          "device path declined or differs")
                    check(rows and set(rows) == {(b1 - b0) * nsplits},
                          f"getitem {label}, {what}: decoded rows {rows}, "
                          f"not the {(b1 - b0) * nsplits} of blocks "
                          f"{b0}..{b1 - 1}")
                on_cpu = cpu_all or what == "first 100 items"
                if on_cpu:
                    check(tb.getitem(chunk, start, nitems, device="cpu")
                          == api, f"getitem {label}, {what}: differs from "
                          "the device='cpu' getitem")
                else:
                    check(engine.getitem(chunk, start, nitems) == api,
                          f"getitem {label}, {what}: differs from the host "
                          "engine's getitem")
                if dev.type == "cuda" and b1 - b0 == 1:
                    for name in need:
                        check(delta[name] > 0, f"getitem {label}, {what}: "
                              f"did not launch {name}")
                print(f"getitem {label}, {what} (items {start}..{start + nitems}"
                      f", blocks {b0}..{max(b_end, b0 + 1) - 1} of {hdr.nblocks}): "
                      f"rows decoded {rows[0] if rows else 0} of "
                      f"{nfull * nsplits}; equal to the input and the "
                      f"{'device=cpu' if on_cpu else 'host engine'} getitem; "
                      f"device layer {t1 - t0:.3f} s (host clock, first call); "
                      f"launches {delta}")
            one = _ms(dev, lambda: tb.getitem(chunk, 0, 100, device=dev), reps)
            full = _ms(dev, lambda: tb.decompress_ctx(chunk, device=dev), reps)
            print(json.dumps({"getitem": label, "nbytes": n, "blocksize": bs,
                              "one_block_getitem_ms": one,
                              "decompress_ctx_ms": full,
                              "timer": "CUDA events, median of "
                              f"{reps}, host work included"
                              if dev.type == "cuda" else "host clock"}))
    finally:
        pipeline.decompress_blocks = decode
    return totals


def phase_host_engine(dev, chunk_bytes, low, host_chunk, reps, card):
    """The byte API's host-encoded codecs as the JAX package runs them:
    compress on the native host engine, decode on the card. On 4 MB of
    synth (sbits 19, typesize 8, shuffle, clevel 5: numcodecs' default
    Blosc() geometry), for snappy, zlib and zstd: api.compress_ctx on the
    default device, which core.backend must serve on the native engine
    (CALLS["native"] up by one, CALLS["numpy"] not), its chunk equal to
    the numpy engine's (snappy on the first 512 KB, to keep the run
    short); api.decompress_ctx on the card, equal to the input, through
    the codec's walk and expand with no host-engine call; each call's
    median ms of `reps` (compress on the host clock, decode by CUDA
    events). Then the 256 KB clevel-9 blosclz input and a 32 KB LZ4
    buffer through the API, and the host engine's blosclz chunk of that
    input, with the engine or kernels that served each call. Returns the
    decodes' launches (each counted from 0)."""
    import cblosc_tpu_torch as tb
    from cblosc_tpu_torch.core import backend
    from cblosc_tpu_torch.format import constants as C
    from cblosc_tpu_torch.format.header import ChunkHeader
    from cblosc_tpu_torch.gpu import kernels
    from cblosc_tpu_torch.utils.timing import synth

    totals = dict.fromkeys(kernels.LAUNCHES, 0)
    sy = synth(chunk_bytes, 8, 19).tobytes()
    host = host_cpu()
    print(f"host engine: host CPU {host}; numinternalthreads 1 (the "
          f"default); card {card}")
    walks = {"snappy": "snappy_walk", "zlib": "zlib_walk",
             "zstd": "zstd_walk"}
    for name, walk in walks.items():
        code = C.COMPCODES[name]

        def comp(d=sy, name=name):
            return tb.compress_ctx(5, C.SHUFFLE, 8, d, compressor=name,
                                   device=dev)

        backend.reset_calls()
        t0 = time.perf_counter()
        chunk = comp()
        first_s = time.perf_counter() - t0
        check(backend.CALLS == {"native": 1, "numpy": 0},
              f"host engine {name}: the native engine did not serve the "
              f"compress ({backend.CALLS})")
        part = sy[:512 << 10] if name == "snappy" else sy
        want, numpy_s = numpy_engine_chunk(code, 5, C.SHUFFLE, part, 8)
        check((comp(part) if part is not sy else chunk) == want,
              f"host engine {name}: the chunk differs from the numpy "
              "engine's")
        backend.reset_calls()
        out, delta = counted(totals, lambda: tb.decompress_ctx(chunk,
                                                               device=dev))
        check(out == sy, f"host engine {name}: the card's decode differs")
        check(backend.CALLS == {"native": 0, "numpy": 0},
              f"host engine {name}: the decode took the host engine")
        if dev.type == "cuda":
            for k in (walk, "expand"):
                check(delta[k] > 0, f"host engine {name}: decode did not "
                      f"launch {k}")
        comp_ms = _host_ms(comp, reps)
        dec_ms = _ms(dev, lambda: tb.decompress_ctx(chunk, device=dev), reps)
        print(json.dumps({
            "host_engine": name, "bytes": len(sy), "clevel": 5,
            "typesize": 8, "chunk_bytes": len(chunk),
            "ratio": len(sy) / len(chunk), "compress_ms": comp_ms,
            "compress_first_s": first_s,
            "compress_timer": f"host clock, median of {reps}",
            "numpy_engine_s": numpy_s, "numpy_engine_bytes": len(part),
            "equal_to_numpy_engine": True, "decompress_ms": dec_ms,
            "decompress_timer": f"CUDA events, median of {reps}"
            if dev.type == "cuda" else "host clock (rehearsal)",
            "decompress_launches": delta, "host_cpu": host, "card": card}))
    # the 256 KB clevel-9 blosclz chunk and a 32 KB LZ4 buffer: the API's
    # chunk of each (its compress served by the card or a host engine),
    # and the host engine's blosclz chunk, each decoded by the API
    for label, data, (cl, sh, ts, comp_name), fixture in (
            ("256 KB clevel-9 blosclz low-entropy", low,
             (9, C.NOSHUFFLE, 1, "blosclz"), host_chunk),
            ("32 KB LZ4 synth", sy[:32 << 10], (5, C.SHUFFLE, 8, "lz4"),
             None)):

        def comp(data=data, cl=cl, sh=sh, ts=ts, comp_name=comp_name):
            return tb.compress_ctx(cl, sh, ts, data, compressor=comp_name,
                                   device=dev)

        backend.reset_calls()
        kernels.reset_launches()
        written = comp()
        served = dict(backend.CALLS)
        entry = {
            "api": label, "bytes": len(data),
            "compress_served_by": "native" if served["native"] else
            "numpy" if served["numpy"] else dev.type,
            "compress_launches": dict(kernels.LAUNCHES),
            "compress_ms": _host_ms(comp, reps), "decodes": []}
        for which, chunk in (("the API's", written),
                             ("the host engine's", fixture)):
            if chunk is None:
                continue
            backend.reset_calls()
            out, delta = counted(totals, lambda: tb.decompress_ctx(
                chunk, device=dev))
            check(out == data, f"host engine {label}: {which} chunk's "
                  "decode differs")
            entry["decodes"].append({
                "chunk": which, "chunk_bytes": len(chunk),
                "memcpyed": bool(ChunkHeader.decode(chunk).memcpyed),
                "host_engine_calls": dict(backend.CALLS),
                "launches": delta,
                "ms": _ms(dev, lambda: tb.decompress_ctx(chunk, device=dev),
                          reps)})
        entry.update(timers=f"compress host clock, decompress CUDA events; "
                     f"median of {reps}", host_cpu=host, card=card)
        print(json.dumps(entry))
    return totals


def phase_sharded(dev, data, arange, reps):
    """The sharded engine (cblosc_tpu_torch.parallel) on a one-rank
    process group: NCCL on the card (gloo in a CPU rehearsal) over a
    FileStore in a temporary directory, then the same calls on a
    one-rank gloo group on the CPU, to which every chunk and total must
    be equal. make_mesh, compress_chunk/decompress_chunk, training_step,
    and training_step_2d on make_mesh_2d(1), on data (4 MB of synth,
    whose decode is template work); compress_chunk/decompress_chunk
    also on an int32 arange, whose decode must launch walk and expand.
    The machine has one card, so no multi-GPU scaling is measured.
    Launch counters are zeroed just before each card call and read just
    after; returns the sum. A failed init or collective fails the run:
    there is no retry on another backend."""
    import datetime
    import tempfile

    import torch.distributed as dist

    from cblosc_tpu_torch import parallel
    from cblosc_tpu_torch.core import policy
    from cblosc_tpu_torch.format import constants as C
    from cblosc_tpu_torch.gpu import kernels

    totals = dict.fromkeys(kernels.LAUNCHES, 0)
    bs = policy.compute_blocksize_device(1, 8, len(data))
    nsplits = policy.nsplits_encode(False, 8, False)
    nblocks = len(data) // bs
    blocks = np.frombuffer(data, np.uint8)[:nblocks * bs].reshape(
        nblocks, bs).copy()

    def calls(mdev, count):
        mesh = parallel.make_mesh()
        mesh2 = parallel.make_mesh_2d(1)
        x = torch.from_numpy(blocks.copy()).to(mdev)
        out = {}

        def one(name, fn):
            if count:
                kernels.reset_launches()
            r = fn()
            if count:
                for k, v in kernels.LAUNCHES.items():
                    totals[k] += v
            out[name] = r
            return r

        c = one("compress_chunk", lambda: parallel.compress_chunk(
            1, C.SHUFFLE, 8, data, mesh))
        one("decompress_chunk", lambda: parallel.decompress_chunk(c, mesh))
        ca = one("compress_chunk_arange", lambda: parallel.compress_chunk(
            1, C.SHUFFLE, 4, arange, mesh))
        before = dict(totals)
        one("decompress_chunk_arange",
            lambda: parallel.decompress_chunk(ca, mesh))
        if count and mdev.type == "cuda":
            for name in ("walk", "expand"):
                check(totals[name] > before[name], "sharded decompress_chunk "
                      f"of the int32 arange did not launch {name}")
        one("training_step", lambda: parallel.training_step(
            x, C.SHUFFLE, 8, nsplits, mesh))
        one("training_step_2d", lambda: parallel.training_step_2d(
            x, C.SHUFFLE, 8, nsplits, mesh2))
        ms = {}
        if count:
            ms = {"compress_chunk_ms": _ms(mdev, lambda: parallel.compress_chunk(
                      1, C.SHUFFLE, 8, data, mesh), reps),
                  "decompress_chunk_ms": _ms(
                      mdev, lambda: parallel.decompress_chunk(c, mesh), reps),
                  "training_step_ms": _ms(mdev, lambda: parallel.training_step(
                      x, C.SHUFFLE, 8, nsplits, mesh), reps),
                  "training_step_2d_ms": _ms(
                      mdev, lambda: parallel.training_step_2d(
                          x, C.SHUFFLE, 8, nsplits, mesh2), reps)}
        return out, ms, dict(zip(mesh2.mesh_dim_names, mesh2.mesh.shape))

    def group(backend, store, fn):
        dist.init_process_group(
            backend, store=dist.FileStore(store, 1), rank=0, world_size=1,
            timeout=datetime.timedelta(seconds=120))
        try:
            return fn()
        finally:
            dist.destroy_process_group()

    with tempfile.TemporaryDirectory() as tmp:
        backend = "nccl" if dev.type == "cuda" else "gloo"
        card, ms, shape2 = group(backend, f"{tmp}/card",
                                 lambda: calls(dev, True))
        host, _, _ = group("gloo", f"{tmp}/cpu",
                           lambda: calls(torch.device("cpu"), False))
    for sfx, src in (("", data), ("_arange", arange)):
        check(card["compress_chunk" + sfx] == host["compress_chunk" + sfx],
              f"sharded compress_chunk{sfx}: the card's chunk differs from "
              "gloo's")
        check(card["decompress_chunk" + sfx] == src
              and host["decompress_chunk" + sfx] == src,
              f"sharded decompress_chunk{sfx} differs from the input")
    for name in ("training_step", "training_step_2d"):
        (co, ce, ct), (ho, he, ht) = card[name], host[name]
        check(torch.equal(co.cpu(), torch.from_numpy(blocks))
              and torch.equal(ho, torch.from_numpy(blocks)),
              f"sharded {name}: round trip differs")
        check(not bool(ce.any()) and not bool(he.any()),
              f"sharded {name}: decode reported err")
        check(int(ct) == int(ht), f"sharded {name}: total {int(ct)} on the "
              f"card, {int(ht)} on gloo")
    print(json.dumps({
        "sharded": f"{backend} one rank", "bytes": len(data),
        "blocksize": bs, "chunk_bytes": len(card["compress_chunk"]),
        "arange_chunk_bytes": len(card["compress_chunk_arange"]),
        "total": int(card["training_step"][2]), "mesh_2d": shape2,
        "equal_to_gloo": True, **ms, "launches": totals,
        "timer": "CUDA events, median of "
        f"{reps}, host work and collectives included"
        if dev.type == "cuda" else "host clock"}))
    print(f"sharded engine: this machine has {torch.cuda.device_count()} "
          "card(s) on one host, so it runs one rank; no multi-GPU scaling "
          "is measured")
    return totals


def phase_bench(dev, label, data, typesize, chunk_bytes, reps, card,
                need=(), code=None, clevel=1):
    """Device-resident bench geometry (bench.py): compress_blocks ->
    mask_past_csize -> decompress_blocks over the whole working set, with
    codec `code` (blosclz by default) at `clevel`'s device geometry and
    policies. The launch counters are zeroed just before the first decode
    and read just after it; each kernel named in need must have launched.
    At the ratio clevels mine_group is also timed alone, on the streams
    that the compress call mines (recorded from one call), in the same
    groups."""
    from cblosc_tpu_torch.core import policy
    from cblosc_tpu_torch.format import constants as C
    from cblosc_tpu_torch.gpu import codec, kernels, pipeline

    code = C.BLOSCLZ if code is None else code
    bs = policy.compute_blocksize_device(clevel, typesize, chunk_bytes)
    nsplits = policy.nsplits_encode(
        not policy.split_block(code, typesize, bs), typesize, False)
    neblock = bs // nsplits
    x = torch.from_numpy(data.reshape(-1, bs).copy()).to(dev)
    total = x.numel()
    mine = policy.device_mine(clevel)

    def comp():
        return pipeline.compress_blocks(
            x, C.SHUFFLE, typesize, nsplits,
            policy.device_min_bytes_per_iter(clevel), code,
            policy.device_min_cratio_x100(clevel), mine)

    slots, cs = comp()
    rows = pipeline.mask_past_csize(slots, cs, slots.shape[1])

    def dec():
        return pipeline.decompress_blocks(rows, cs, neblock, C.SHUFFLE,
                                          typesize, nsplits, code)

    kernels.reset_launches()
    out, err = dec()
    launches = dict(kernels.LAUNCHES)
    if dev.type == "cuda":
        for name in need:
            check(launches[name] > 0,
                  f"bench {label}: kernel {name} was not launched")
    check(not bool(err.any()), f"bench {label}: decode reported err")
    check(torch.equal(out, x), f"bench {label}: round trip differs")
    nchunks = total // chunk_bytes
    cbytes = (int(cs.to(torch.int64).sum()) + 4 * cs.numel()
              + nchunks * (16 + 4 * (chunk_bytes // bs)))
    tc = _ms(dev, comp, reps)
    td = _ms(dev, dec, reps)
    extra = {}
    if mine:
        from cblosc_tpu_torch.utils.profile import mined_inputs

        seen = mined_inputs(comp)
        check(bool(seen), f"bench {label}: compress mined nothing")
        tm = _ms(dev, lambda: [codec.mine_group(*a) for a in seen], reps)
        extra = {"mine_group_ms": tm, "mine_group_share": tm / tc,
                 "mine_group_calls": len(seen),
                 "mined_rows": sum(a[0].shape[0] for a in seen),
                 "rows": cs.numel(), "neblock": neblock}
    print(json.dumps({
        "bench": label, "codec": C.COMPNAMES[code], "bytes": total,
        "clevel": clevel, "typesize": typesize,
        "ratio": total / cbytes, "compress_ms": tc, "decompress_ms": td,
        "compress_gbps": total / tc / 1e6, "decompress_gbps": total / td / 1e6,
        **extra, "decompress_launches": launches, "card": card,
        "timer": "call time on the CUDA stream (events; includes host syncs)"
        if dev.type == "cuda" else "host clock (rehearsal)"}))


def run(dev, chunk_bytes=CHUNK, workset=WORKSET, reps=5):
    from concurrent.futures import ThreadPoolExecutor

    from cblosc_tpu_torch.gpu import kernels
    from cblosc_tpu_torch.native import binding
    from cblosc_tpu_torch.utils.timing import synth

    card = card_line() if dev.type == "cuda" else "cpu rehearsal"
    print(card)

    def timed(fn):
        t0 = time.perf_counter()
        fn()
        return time.perf_counter() - t0

    # the native host engine (g++) builds beside the kernels (nvcc)
    with ThreadPoolExecutor(1) as pool:
        native_s = pool.submit(timed, binding.load)
        if dev.type == "cuda":
            print(f"kernel build: {timed(kernels.build_all):.2f} s "
                  f"({', '.join(kernels.SOURCES.values())})")
            for name, log in kernels.build_log.items():
                for line in log.splitlines():
                    if "registers" in line or "spill" in line:
                        print(f"  ptxas {name}: {line.strip()}")
        print(f"native host engine build: {native_s.result():.2f} s "
              f"({binding.build()}, g++ {' '.join(binding.CXX_FLAGS)}; host "
              f"CPU {host_cpu()})")

    import cblosc_tpu_torch as tb
    from cblosc_tpu_torch.format import constants as C

    low, host_chunk = host_engine_chunk(chunk_bytes)
    sy = synth(chunk_bytes, 8, 19).tobytes()
    t0 = time.perf_counter()
    lz4_chunk = host_codec_chunk(C.LZ4, 5, sy, 8)
    snappy_chunk = host_codec_chunk(C.SNAPPY, 1, sy, 8)
    # zlib chunks through the byte API, which writes them on the host
    # engine as the JAX package does
    ar = np.arange(chunk_bytes // 4, dtype=np.int32).tobytes()
    zlib_chunks = {
        (cl, name): tb.compress_ctx(cl, C.SHUFFLE, ts, d, compressor="zlib",
                                    device=dev)
        for cl, name, ts, d in ((1, "synth", 8, sy), (5, "synth", 8, sy),
                                (9, "synth", 8, sy), (5, "int32 arange", 4, ar))}
    zstd_chunks = {
        (cl, name): tb.compress_ctx(cl, C.SHUFFLE, ts, d, compressor="zstd",
                                    device=dev)
        for cl, name, ts, d in ((1, "synth", 8, sy), (5, "synth", 8, sy),
                                (9, "synth", 8, sy), (5, "int32 arange", 4, ar))}
    print(f"host-engine chunks of 4 MB synth: LZ4 clevel 5 {len(lz4_chunk)} B, "
          f"snappy {len(snappy_chunk)} B, zlib clevel 1/5/9 "
          f"{'/'.join(str(len(zlib_chunks[(c, 'synth')])) for c in (1, 5, 9))} "
          f"B; zlib int32 arange clevel 5 {len(zlib_chunks[(5, 'int32 arange')])}"
          f" B; zstd clevel 1/5/9 "
          f"{'/'.join(str(len(zstd_chunks[(c, 'synth')])) for c in (1, 5, 9))} "
          f"B; zstd int32 arange clevel 5 {len(zstd_chunks[(5, 'int32 arange')])}"
          f" B ({time.perf_counter() - t0:.1f} s)")
    # the fixtures come from the native engine: each equal to the numpy
    # engine's chunk, one 4 MB input per codec (the blosclz one: 256 KB)
    numpy_s = 0.0
    for label, (code, cl, sh, d, ts), chunk in (
            ("blosclz clevel 9", (C.BLOSCLZ, 9, C.NOSHUFFLE, low, 1),
             host_chunk),
            ("LZ4 clevel 5", (C.LZ4, 5, C.SHUFFLE, sy, 8), lz4_chunk),
            ("snappy clevel 1", (C.SNAPPY, 1, C.SHUFFLE, sy, 8), snappy_chunk),
            ("zlib clevel 5", (C.ZLIB, 5, C.SHUFFLE, sy, 8),
             zlib_chunks[(5, "synth")]),
            ("zstd clevel 5", (C.ZSTD, 5, C.SHUFFLE, sy, 8),
             zstd_chunks[(5, "synth")])):
        want, sec = numpy_engine_chunk(code, cl, sh, d, ts)
        numpy_s += sec
        check(chunk == want, f"host-engine {label} chunk differs from the "
              "numpy engine's")
    print(f"host-engine chunks equal to the numpy engine's (blosclz, LZ4, "
          f"snappy, zlib, zstd; the numpy engine took {numpy_s:.1f} s)")
    # the ratio clevels, written on the card and by the port on the CPU:
    # (compressor, data, typesize); the LZ4 synth chunk at clevel 5 is
    # numcodecs' default Blosc(); the int32 arange and the uint8
    # staircase carry mined distances (far in blosclz; abutting a static
    # run in LZ4)
    st = (np.arange(chunk_bytes) // 128 % 256).astype(np.uint8).tobytes()
    ratio_src = {"blosclz synth sbits19 ts8": ("blosclz", sy, 8),
                 "blosclz int32 arange ts4": ("blosclz", ar, 4),
                 "lz4 synth sbits19 ts8": ("lz4", sy, 8),
                 "lz4hc synth sbits19 ts8": ("lz4hc", sy, 8),
                 "lz4 uint8 staircase ts1": ("lz4", st, 1)}
    ratio_chunks, chunks5 = [], {}
    t_card = t_cpu = 0.0
    for clevel in (5, 9):
        for name, (comp, d, ts) in ratio_src.items():
            t0 = time.perf_counter()
            card_c = tb.compress_ctx(clevel, C.SHUFFLE, ts, d,
                                     compressor=comp, device=dev)
            t1 = time.perf_counter()
            cpu_c = tb.compress_ctx(clevel, C.SHUFFLE, ts, d,
                                    compressor=comp, device="cpu")
            t_card += t1 - t0
            t_cpu += time.perf_counter() - t1
            # blosclz synth decodes by the template path alone (its live
            # rows are the PURE zero planes): no kernel launches
            need = (() if name == "blosclz synth sbits19 ts8" else
                    ("walk", "expand") if comp == "blosclz" else
                    ("lz4_walk", "expand") if "staircase" in name else
                    ("lz4_walk",))
            ratio_chunks.append((f"{name} clevel {clevel}", d, card_c, cpu_c,
                                 need))
            if clevel == 5:
                chunks5[name] = card_c
    print(f"clevel-5/9 chunks of 4 MB: {len(ratio_chunks)} written on "
          f"{dev.type} in {t_card:.1f} s and on the CPU in {t_cpu:.1f} s "
          "(host clock, first calls)")
    t_run = time.perf_counter()

    def stamp(label):
        print(f"[{time.perf_counter() - t_run:.1f} s] {label}")

    stats = phase_kernels(dev, chunk_bytes, host_chunk, reps)
    stamp("phase 2: expand, walk, decode_one held and timed")
    stats.update(phase_codec_walks(dev, chunk_bytes, snappy_chunk, lz4_chunk,
                                   reps))
    stamp("phase 2: lz4_walk, snappy_walk held and timed")
    for name, e in phase_ratio_rows(dev, chunks5, reps).items():
        stats[name]["max_abs_err"] = max(
            stats[name]["max_abs_err"],
            *(v for k, v in e.items() if k.endswith("max_abs_err")))
        stats[name].update(e)
    stamp("phase 2: walk, expand and lz4_walk on the card-written clevel-5 "
          "rows held and timed")
    for part in (phase_zlib_walk(dev, zlib_chunks[(5, "synth")], reps),
                 phase_zstd_walk(dev, zstd_chunks[(1, "synth")],
                                 zstd_chunks[(5, "synth")], reps)):
        e = part.pop("expand")
        stats["expand"]["max_abs_err"] = max(
            stats["expand"]["max_abs_err"],
            *(v for k, v in e.items() if k.endswith("max_abs_err")))
        stats["expand"].update(e)
        stats.update(part)
        stamp(f"phase 2: {', '.join(part)} and expand on its rows held and "
              "timed")
    stats["expand"].update(
        serial_rows=sum(b[2] for b in K1_BRANCHES),
        max_rounds=max(b[3] for b in K1_BRANCHES))
    print("kernel expand branches on the main-path inputs: " + "; ".join(
        f"{label}: {rows} rows, {serial} on the per-record loop, at most "
        f"{rounds} jumping rounds" for label, rows, serial, rounds in
        K1_BRANCHES))
    for name in ("lz4_walk", "snappy_walk", "zlib_walk", "zstd_walk"):
        print_kernel(name, stats[name])
    counts = phase_byte_api(
        dev, chunk_bytes, low, host_chunk,
        [("host-engine LZ4 clevel-5 synth chunk", sy, lz4_chunk, "lz4_walk"),
         ("host-engine snappy synth chunk", sy, snappy_chunk, "snappy_walk")]
        + [(f"host-engine zlib clevel-{cl} {name} chunk",
            sy if name == "synth" else ar, c, "zlib_walk")
           for (cl, name), c in zlib_chunks.items()]
        + [(f"host-engine zstd clevel-{cl} {name} chunk",
            sy if name == "synth" else ar, c, "zstd_walk")
           for (cl, name), c in zstd_chunks.items() if cl != 9],
        [("host-engine zstd clevel-9 synth chunk", sy,
          zstd_chunks[(9, "synth")])], ratio_chunks)
    print(json.dumps({"launches": counts}))
    stamp("phase 3: byte API")
    # getitem: the main-path blosclz chunk, the card's LZ4 clevel-5 chunk
    # (numcodecs' default), the host engine's zstd clevel-5 chunk, and a
    # buffer with a leftover block
    left = synth(chunk_bytes + 1240, 8, 19)[:chunk_bytes + 1234].tobytes()
    gi = phase_getitem(dev, [
        ("blosclz clevel-1 synth chunk", sy,
         tb.compress_ctx(1, C.SHUFFLE, 8, sy, device=dev), (), True),
        ("card-written lz4 clevel-5 synth chunk", sy,
         chunks5["lz4 synth sbits19 ts8"], ("lz4_walk",), True),
        ("host-engine zstd clevel-5 synth chunk", sy,
         zstd_chunks[(5, "synth")], ("zstd_walk", "expand"), False),
        ("blosclz clevel-1 synth chunk of 4 MB + 1234 B", left,
         tb.compress_ctx(1, C.SHUFFLE, 8, left, device=dev), (), True)], reps)
    print(json.dumps({"getitem_launches": gi}))
    stamp("phase 3: getitem")
    he = phase_host_engine(dev, chunk_bytes, low, host_chunk, reps, card)
    print(json.dumps({"host_engine_launches": he}))
    stamp("phase 3: host engine")
    phase_bench(dev, "synth sbits19 ts8", synth(workset, 8, 19), 8,
                chunk_bytes, reps, card)
    phase_bench(dev, "int32 arange ts4",
                np.arange(workset // 4, dtype=np.int32).view(np.uint8), 4,
                chunk_bytes, reps, card, need=("walk", "expand"))
    phase_bench(dev, "lz4 synth sbits19 ts8", synth(workset, 8, 19), 8,
                chunk_bytes, reps, card, need=("lz4_walk",), code=C.LZ4)
    for clevel in (5, 9):
        phase_bench(dev, "synth sbits19 ts8", synth(workset, 8, 19), 8,
                    chunk_bytes, reps, card, clevel=clevel)
    stamp("phase 4: 128 MB round trips at clevels 5 and 9")
    phase_zlib_bench(dev, workset, chunk_bytes, reps, card)
    for clevel in (5, 1):
        stats["zstd_walk"].update(
            phase_zstd_bench(dev, workset, chunk_bytes, reps, card, clevel))
    stamp("phase 4: 128 MB round trips and the 128 MB zlib and zstd decodes")
    sharded = phase_sharded(dev, sy, ar, reps)
    stamp("phase 5: the sharded engine on a one-rank group")
    counts = {k: counts[k] + gi[k] + he[k] + sharded[k] for k in counts}

    src = {"expand": ("cblosc_tpu_torch/csrc/expand.cu",
                      "cblosc_tpu/tpu/expand.py:258"),
           "walk": ("cblosc_tpu_torch/csrc/walk.cu",
                    "cblosc_tpu/tpu/structured.py:149"),
           "decode_one": ("cblosc_tpu_torch/csrc/decode.cu",
                          "cblosc_tpu/tpu/codec.py:741"),
           "lz4_walk": ("cblosc_tpu_torch/csrc/lz4_walk.cu",
                        "cblosc_tpu/tpu/codec_lz4.py:338"),
           "snappy_walk": ("cblosc_tpu_torch/csrc/snappy_walk.cu",
                           "cblosc_tpu/tpu/codec_snappy.py:58"),
           "zlib_walk": ("cblosc_tpu_torch/csrc/zlib_walk.cu",
                         "cblosc_tpu/tpu/codec_zlib.py:143"),
           "zstd_walk": ("cblosc_tpu_torch/csrc/zstd_walk.cu",
                         "cblosc_tpu/tpu/codec_zstd.py:242")}
    line = {"kernels": [
        {"name": name, "route": "cuda", "source": src[name][0],
         "replaces": src[name][1], "launches": counts[name],
         **stats[name], "bound_by": "bytes", "library_ms": None}
        for name in src]}
    print(json.dumps(line))


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    try:
        import cblosc_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: the port package is missing ({e})", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    run(dev)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
