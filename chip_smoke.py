#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (cblosc_tpu_torch) on one GPU.

Run from the repository root on a machine with an NVIDIA GPU:

    python3 chip_smoke.py

Phases (each prints its own lines; any failure raises and exits non-zero):
  1. the card's name and power limit; build the CUDA kernels from
     cblosc_tpu_torch/csrc (in parallel, into build/torch_kernels/);
  2. each kernel against its plain PyTorch version on the same CUDA
     tensors, outputs equal (tolerance 0: integer code): the main path's
     inputs, host-encoder rows and raw streams generated token by token
     (far matches, escape runs, narrow and unaligned rows, corruptions,
     random bytes). Times: each kernel's wrapper called alone between
     CUDA events (the "ms" of the kernels line, which includes the host
     work of a short call), beside the kernel's device time per launch
     (torch.profiler, "device_ms") and the wrapper's time per call of 20
     back to back ("call_ms"); the walk on both its main-path shapes
     (the long row's figures as "long_*"); the token count and ns per
     token of the timed 256 KB decode row;
  3. the main path: byte-API round trips (compress_ctx/decompress_ctx)
     on 4 MB buffers at clevel 1 plus a clevel-9 host-engine chunk
     decoded on the card; every launch counter is zeroed just before
     and read just after, and each kernel must have launched; then the
     clevel-9 chunk's decode is timed warm (CUDA events, median of 5);
  4. the bench geometry on device-resident data: a 128 MB working set
     through gpu.pipeline.compress_blocks -> mask_past_csize ->
     decompress_blocks, verified equal, timed with CUDA events (call
     time on the stream, host syncs included), with the launch counts
     of its first decode (the int32 arange decode must launch the walk
     and expand kernels);
  5. the kernels line, then the device line, last.

It imports nothing of JAX and nothing of the JAX package, and exits
non-zero without a result when CUDA is unavailable or the package is
missing.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

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


def _device_ms(dev, fn, kernel: str) -> float:
    """Device ms per launch of `kernel` (torch.profiler); NaN in a CPU
    rehearsal, which has no device time."""
    if dev.type != "cuda":
        return float("nan")
    from cblosc_tpu_torch.utils.profile import kernel_ms

    return kernel_ms(fn, kernel)


def _maxdiff(a, b) -> int:
    a, b = tuple(a), tuple(b)
    check(len(a) == len(b), "output arity differs")
    worst = 0
    for x, y in zip(a, b):
        check(x.shape == y.shape, f"shape {tuple(x.shape)} vs {tuple(y.shape)}")
        if x.numel():
            worst = max(worst, int((x.to(torch.int64)
                                    - y.to(torch.int64)).abs().max()))
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
    the port's host engine: mixed-distance, token-dense streams that
    overflow the walk's record budget, so the main path decodes them with
    the generic decoder (K3)."""
    from cblosc_tpu_torch.core import engine
    from cblosc_tpu_torch.format import constants as C

    rng = np.random.default_rng(11)
    low = (rng.integers(0, 8, min(chunk_bytes, 256 << 10), dtype=np.uint8)
           * 16)
    ctx = engine.build_context(9, C.NOSHUFFLE, 1, low.size, low.size + 16,
                               C.BLOSCLZ)
    return low.tobytes(), engine.compress_chunk(ctx, low.tobytes())


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
    width = pipeline.decode_slot_width(neblock)
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


def phase_kernels(dev, chunk_bytes, host_chunk, reps):
    """Each kernel against its plain version, on the same tensors."""
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
    err = 0
    for rows, cs, ol in ((a_rows, a_cs, n), (h_rows, h_cs, hn), *gen):
        mr = structured.max_records(ol)
        k = structured.walk(rows, cs, ol, mr)
        p = structured._walk_plain(rows, cs, ol, structured.record_slots(mr))
        err = max(err, _maxdiff(k[0] + k[1:], p[0] + p[1:]))
    check(err == 0, f"walk kernel differs from its plain version ({err})")
    rf, dist, uni, ok = structured.walk(a_rows, a_cs, n, maxrec)
    check(bool(ok.all()), "main-path walk rows must all parse")
    nrec = int((rf[0] >= 0).sum())
    N = a_rows.shape[0]
    csum = int(a_cs.sum())
    walk_call = lambda: structured.walk(a_rows, a_cs, n, maxrec)  # noqa: E731
    # bound: the rows read and the valid records written (bound_ms), or
    # every record slot, since the kernel writes the -1/zero tail too
    out["walk"] = dict(
        max_abs_err=err,
        ms=_ms(dev, walk_call, reps),
        device_ms=_device_ms(dev, walk_call, "::walk"),
        call_ms=_ms(dev, walk_call, reps, batch=BATCH),
        plain_ms=_ms(dev, lambda: structured._walk_plain(a_rows, a_cs, n, E),
                     1),
        bound_ms=(csum + 4 * N + 16 * nrec + 9 * N) / HBM_BYTES_PER_S * 1e3,
        bound_slots_ms=(csum + 4 * N + 16 * N * E + 9 * N)
        / HBM_BYTES_PER_S * 1e3)
    # the walk's other main-path shape: the clevel-9 row at its default
    # budget, which it overflows (the byte API then decodes it with K3).
    # Bound: the stream up to the end of the last literal it emitted (less
    # than it reads) and the records it emitted.
    cmr = structured.max_records(cn)
    long_call = lambda: structured.walk(c_rows, c_cs, cn, cmr)  # noqa: E731
    plain = {}

    def long_plain():       # one timed call (a serial 256 KB walk is slow)
        plain["out"] = structured._walk_plain(c_rows, c_cs, cn,
                                              structured.record_slots(cmr))

    long_plain_ms = _ms(dev, long_plain, 1, warmup=0)
    k, p = long_call(), plain["out"]
    err = _maxdiff(k[0] + k[1:], p[0] + p[1:])
    check(err == 0, f"walk kernel differs from its plain version ({err})")
    (lkind, larg, _, llen), _, _, lok = k
    check(not bool(lok.any()),
          "the clevel-9 row must overflow the default walk budget")
    lread = int(torch.where(lkind == 0, larg + llen, 0).amax(dim=1).sum())
    Nc = c_rows.shape[0]
    out["walk"].update(
        long_ms=_ms(dev, long_call, reps),
        long_device_ms=_device_ms(dev, long_call, "::walk"),
        long_plain_ms=long_plain_ms,
        long_bound_ms=(lread + 4 * Nc + 16 * int((lkind >= 0).sum()) + 9 * Nc)
        / HBM_BYTES_PER_S * 1e3)

    # K1 expand: main-path records and host-encoder (mixed distances)
    hrf = structured.walk(h_rows, h_cs, hn, maxrec)[0]
    err = 0
    for rows, rfx, ol in ((a_rows, rf, n), (h_rows, hrf, hn)):
        err = max(err, _maxdiff([expand.expand(rows, rfx, ol)],
                                [expand._expand_plain(rows, rfx, ol)]))
    check(err == 0, f"expand kernel differs from its plain version ({err})")
    expand_call = lambda: expand.expand(a_rows, rf, n)  # noqa: E731
    out["expand"] = dict(
        max_abs_err=err,
        ms=_ms(dev, expand_call, reps),
        device_ms=_device_ms(dev, expand_call, "::expand_kernel"),
        call_ms=_ms(dev, expand_call, reps, batch=BATCH),
        plain_ms=_ms(dev, lambda: expand._expand_plain(a_rows, rf, n),
                     1),
        bound_ms=(csum + 16 * nrec + N * n) / HBM_BYTES_PER_S * 1e3)

    # K3 generic decoder: the main path's clevel-9 host-chunk rows, and
    # valid and corrupted host-encoder streams
    k = codec.decode(h_rows, h_cs, hn)
    p = codec._decode_plain(h_rows, h_cs, hn)
    err = _maxdiff(k, p)
    check(not bool(k[2][:nvalid].any()), "valid host streams must decode")
    check(bool(k[2][nvalid:].any()), "some corrupted streams must report err")
    for rows, cs, ol in gen:
        err = max(err, _maxdiff(codec.decode(rows, cs, ol),
                                codec._decode_plain(rows, cs, ol)))
    k = codec.decode(c_rows, c_cs, cn)
    plain = {}

    def plain_call():       # one timed call (a serial 256 KB decode is slow)
        plain["out"] = codec._decode_plain(c_rows, c_cs, cn)

    plain_ms = _ms(dev, plain_call, 1, warmup=0)
    err = max(err, _maxdiff(k, plain["out"]))
    check(err == 0, f"decode kernel differs from its plain version ({err})")
    check(not bool(k[2].any()), "host-chunk rows must decode")
    decode_call = lambda: codec.decode(c_rows, c_cs, cn)  # noqa: E731
    out["decode_one"] = dict(
        max_abs_err=err,
        ms=_ms(dev, decode_call, reps),
        device_ms=_device_ms(dev, decode_call, "::decode_kernel"),
        call_ms=_ms(dev, decode_call, reps, batch=BATCH),
        plain_ms=plain_ms,
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
        print(f"kernel {name}: equal to plain (max_abs_err {r['max_abs_err']}); "
              f"{r['ms']:.4f} ms per call alone (CUDA events); "
              f"{r['device_ms']:.4f} ms on the card (profiler, per launch); "
              f"{r['call_ms']:.4f} ms per call ({BATCH} back to back); plain "
              f"{r['plain_ms']:.4f} ms; bound {r['bound_ms']:.6f} ms")
    w = out["walk"]
    print(f"kernel walk on the {cn >> 10} KB clevel-9 row (budget {cmr}): "
          f"{w['long_ms']:.4f} ms per call alone; {w['long_device_ms']:.4f} "
          f"ms on the card; plain {w['long_plain_ms']:.4f} ms; bound "
          f"{w['long_bound_ms']:.6f} ms")
    return out


def phase_byte_api(dev, chunk_bytes, low, host_chunk):
    """The main path through the entry points a user calls."""
    import cblosc_tpu_torch as tb
    from cblosc_tpu_torch.core import engine
    from cblosc_tpu_torch.format import constants as C
    from cblosc_tpu_torch.gpu import kernels
    from cblosc_tpu_torch.utils.timing import synth

    def roundtrip(label, clevel, shuffle, ts, data):
        t0 = time.perf_counter()
        c = tb.compress_ctx(clevel, shuffle, ts, data, device=dev)
        t1 = time.perf_counter()
        before = dict(kernels.LAUNCHES)
        r = tb.decompress_ctx(c, device=dev)
        t2 = time.perf_counter()
        check(r == data, f"{label}: round trip differs")
        check(engine.decompress_chunk(c) == data,
              f"{label}: host engine cannot decode the device chunk")
        delta = {k: kernels.LAUNCHES[k] - before[k] for k in before}
        print(f"byte api {label}: {len(data)} B -> {len(c)} B "
              f"(ratio {len(data) / len(c):.4f}); host clock compress "
              f"{t1 - t0:.3f} s, decompress {t2 - t1:.3f} s (first calls); "
              f"decompress launches {delta}")

    n = chunk_bytes

    kernels.reset_launches()
    roundtrip("synth sbits19 ts8 shuffle", 1, C.SHUFFLE, 8,
              synth(n, 8, 19).tobytes())
    before = dict(kernels.LAUNCHES)
    roundtrip("int32 arange ts4 shuffle", 1, C.SHUFFLE, 4,
              np.arange(n // 4, dtype=np.int32).tobytes())
    if dev.type == "cuda":
        check(kernels.LAUNCHES["walk"] > before["walk"]
              and kernels.LAUNCHES["expand"] > before["expand"],
              "int32 arange decode must launch the walk and expand kernels")
    roundtrip("float64 linspace ts8 shuffle", 1, C.SHUFFLE, 8,
              np.linspace(-1.0, 1.0, n // 8).tobytes())
    before = dict(kernels.LAUNCHES)
    r = tb.decompress_ctx(host_chunk, device=dev)
    check(r == low, "host-engine clevel-9 chunk decode differs")
    delta = {k: kernels.LAUNCHES[k] - before[k] for k in before}
    print(f"byte api host-engine clevel-9 low-entropy chunk: {len(low)} B "
          f"<- {len(host_chunk)} B decoded on {dev.type}; "
          f"decompress launches {delta}")
    counts = dict(kernels.LAUNCHES)
    if dev.type == "cuda":
        for name, c in counts.items():
            check(c > 0, f"kernel {name} was not launched on the main path")
    warm = _ms(dev, lambda: tb.decompress_ctx(host_chunk, device=dev), 5)
    print(f"byte api host-engine clevel-9 chunk decode, warm: {warm:.4f} ms "
          f"(median of 5, {'CUDA events' if dev.type == 'cuda' else 'host clock'})")
    return counts


def phase_bench(dev, label, data, typesize, chunk_bytes, reps, card,
                need=()):
    """Device-resident bench geometry (bench.py): compress_blocks ->
    mask_past_csize -> decompress_blocks over the whole working set.
    The launch counters are zeroed just before the first decode and read
    just after it; each kernel named in need must have launched."""
    from cblosc_tpu_torch.core import policy
    from cblosc_tpu_torch.format import constants as C
    from cblosc_tpu_torch.gpu import kernels, pipeline

    bs = policy.compute_blocksize_device(1, typesize, chunk_bytes)
    nsplits = policy.nsplits_encode(
        not policy.split_block(C.BLOSCLZ, typesize, bs), typesize, False)
    neblock = bs // nsplits
    x = torch.from_numpy(data.reshape(-1, bs).copy()).to(dev)
    total = x.numel()

    def comp():
        return pipeline.compress_blocks(
            x, C.SHUFFLE, typesize, nsplits,
            policy.device_min_bytes_per_iter(1), C.BLOSCLZ,
            policy.device_min_cratio_x100(1), False)

    slots, cs = comp()
    rows = pipeline.mask_past_csize(slots, cs, slots.shape[1])

    def dec():
        return pipeline.decompress_blocks(rows, cs, neblock, C.SHUFFLE,
                                          typesize, nsplits)

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
    print(json.dumps({
        "bench": label, "bytes": total, "clevel": 1, "typesize": typesize,
        "ratio": total / cbytes, "compress_ms": tc, "decompress_ms": td,
        "compress_gbps": total / tc / 1e6, "decompress_gbps": total / td / 1e6,
        "decompress_launches": launches, "card": card,
        "timer": "call time on the CUDA stream (events; includes host syncs)"
        if dev.type == "cuda" else "host clock (rehearsal)"}))


def run(dev, chunk_bytes=CHUNK, workset=WORKSET, reps=5):
    from cblosc_tpu_torch.gpu import kernels
    from cblosc_tpu_torch.utils.timing import synth

    card = card_line() if dev.type == "cuda" else "cpu rehearsal"
    print(card)
    if dev.type == "cuda":
        t0 = time.perf_counter()
        kernels.build_all()
        print(f"kernel build: {time.perf_counter() - t0:.2f} s "
              f"({', '.join(kernels.SOURCES.values())})")
        for name, log in kernels.build_log.items():
            for line in log.splitlines():
                if "registers" in line or "spill" in line:
                    print(f"  ptxas {name}: {line.strip()}")

    low, host_chunk = host_engine_chunk(chunk_bytes)
    stats = phase_kernels(dev, chunk_bytes, host_chunk, reps)
    counts = phase_byte_api(dev, chunk_bytes, low, host_chunk)
    print(json.dumps({"launches": counts}))
    phase_bench(dev, "synth sbits19 ts8", synth(workset, 8, 19), 8,
                chunk_bytes, reps, card)
    phase_bench(dev, "int32 arange ts4",
                np.arange(workset // 4, dtype=np.int32).view(np.uint8), 4,
                chunk_bytes, reps, card, need=("walk", "expand"))

    src = {"expand": ("cblosc_tpu_torch/csrc/expand.cu",
                      "cblosc_tpu/tpu/expand.py:258"),
           "walk": ("cblosc_tpu_torch/csrc/walk.cu",
                    "cblosc_tpu/tpu/structured.py:149"),
           "decode_one": ("cblosc_tpu_torch/csrc/decode.cu",
                          "cblosc_tpu/tpu/codec.py:741")}
    line = {"kernels": [
        {"name": name, "route": "cuda", "source": src[name][0],
         "replaces": src[name][1], "launches": counts[name],
         **stats[name], "bound_by": "bytes", "library_ms": None}
        for name in ("expand", "walk", "decode_one")]}
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
