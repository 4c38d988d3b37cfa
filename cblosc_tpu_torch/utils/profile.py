"""Where the time goes: torch.profiler over the device pipeline, read
through the port's own spans (utils/trace.py).

Run on a machine with an NVIDIA GPU, from the repository root:

    python -m cblosc_tpu_torch.utils.profile [--workset-mb 128]

For the bench geometry (clevel 1, 4 MB chunks, shuffle) on two data
sets (``synth`` sbits 19 typesize 8, the bench data; int32 arange
typesize 4, whose decode runs the walk and expand kernels) with blosclz,
on ``synth`` with LZ4 (whose decode runs the LZ4 walk), and on ``synth``
with blosclz at clevels 5 and 9 (128 KB and 256 KB splits, mining;
there also ``gpu.codec.mine_group`` alone over the streams the compress
call mines), it profiles
one steady call each of ``gpu.pipeline.compress_blocks`` and
``decompress_blocks``; then one steady byte-API ``decompress_ctx`` each
of the chunks the host engine (core.backend: the native engine) writes:
a clevel-9 blosclz chunk (256 KB
of low-entropy bytes, the token-dense split the generic decoder takes),
an LZ4 clevel-5 chunk of 4 MB synth (numcodecs' default codec: 128 KB
splits, four of them dense, so the LZ4 walk runs twice, the default
budget then the escalated one), a snappy chunk of 4 MB synth (the snappy walk runs twice, the default
budget then the escalated one, as the byte API retries), a clevel-5
zlib chunk of 4 MB synth (128 KB splits; the zlib walk
runs twice, the default budget then the escalated one, as the byte API
retries) and a clevel-5 zstd chunk of 4 MB synth (16 unsplit 256 KB
blocks, each one zstd frame: the zstd walk and the expand kernel, once
each). It prints one JSON line per call: the host wall time of the call
(ending in a synchronize), the card's busy time (the union of its
kernels, copies and sets) and idle share over that wall time, the top
kernels by device time, and for each span the call recorded, by name in
the order they opened (``api.*`` roots, ``host_api.parse`` /
``stage_in`` / ``err_check`` / ``fetch`` / ``assemble``,
``pipeline.compress_blocks`` / ``decompress_blocks`` / ``gather`` /
``encode_group`` / ``decode_group``, ``filters.apply`` / ``undo``,
``codec.mine_group`` with ``mine.prefix`` / ``fold`` / ``verify``): how
many, their self ms (less their child spans), the ms inside them in
which the card ran nothing, and their counts (``h2d_bytes``,
``d2h_bytes``, ``erred_rows``, ``retried_rows``, ``budget``,
``route.*``).
"""

from __future__ import annotations

import argparse
import json
import subprocess
import time

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

from .. import api
from ..core import backend, engine, policy
from ..format import constants as C
from ..gpu import pipeline
from . import trace
from .timing import synth


def _device_us(evt) -> float:
    for name in ("self_device_time_total", "self_cuda_time_total"):
        v = getattr(evt, name, None)
        if v is not None:
            return float(v)
    return 0.0


def kernel_ms(fn, kernel: str, calls: int = 20) -> float:
    """Mean device milliseconds per launch of the kernels whose name
    contains `kernel`, over `calls` calls of fn: the card's own time for
    the kernel, without the host work of the call around it. Raises,
    naming the kernels the trace holds, when it holds no such launch."""
    from torch.autograd import DeviceType

    fn()                                           # warm up
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    evts = [e for e in prof.key_averages()
            if getattr(e, "device_type", None) == DeviceType.CUDA]
    hits = [e for e in evts if kernel in e.key]
    n = sum(e.count for e in hits)
    if n == 0:
        raise RuntimeError(f"no launch of a kernel named *{kernel}* was "
                           f"traced; traced: {sorted({e.key[:60] for e in evts})}")
    return sum(_device_us(e) for e in hits) / n / 1e3


def mined_inputs(fn) -> list:
    """The arguments (s, d_row, max_d) of every gpu.codec.mine_group call
    that fn() makes (the encoders look the function up at call time)."""
    from ..gpu import codec

    seen, orig = [], codec.mine_group

    def record(s, d_row, max_d=codec.MAX_FARDIST):
        seen.append((s, d_row, max_d))
        return orig(s, d_row, max_d)

    codec.mine_group = record
    try:
        fn()
    finally:
        codec.mine_group = orig
    return seen


def _busy(prof, t0: int, t1: int) -> list:
    """The card's activity in [t0, t1] (host ns), as sorted disjoint
    (start, end) intervals: the union of its kernels, copies and sets."""
    from torch.autograd import DeviceType

    ev = sorted((max(e.start_ns(), t0),
                 min(e.start_ns() + e.duration_ns(), t1))
                for e in prof.profiler.kineto_results.events()
                if e.device_type() == DeviceType.CUDA)
    out: list = []
    for a, b in ev:
        if b <= a:
            continue
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def _span_table(recs: list, busy: list) -> list:
    """Per span name, in the order they opened: count, self ms, ms of the
    card idle inside them, and summed counts."""
    child_ns: dict = {}
    for r in recs:
        if r.parent >= 0:
            child_ns[r.parent] = (child_ns.get(r.parent, 0)
                                  + r.end_ns - r.start_ns)
    rows: dict = {}
    for r in recs:
        row = rows.setdefault(r.name, {"span": r.name, "n": 0,
                                       "self_ms": 0.0, "idle_ms": 0.0,
                                       "counts": {}})
        dur = r.end_ns - r.start_ns
        on = sum(max(0, min(b, r.end_ns) - max(a, r.start_ns))
                 for a, b in busy)
        row["n"] += 1
        row["self_ms"] += (dur - child_ns.get(r.index, 0)) / 1e6
        row["idle_ms"] += (dur - on) / 1e6
        for k, v in (r.counts or {}).items():
            row["counts"][k] = row["counts"].get(k, 0) + v
    return list(rows.values())


def _profile(fn, label: str, card: str) -> dict:
    fn()                                           # warm up
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.time_ns()
        fn()
        torch.cuda.synchronize()
        t1 = time.time_ns()
    from torch.autograd import DeviceType

    evts = [e for e in prof.key_averages()
            if getattr(e, "device_type", None) == DeviceType.CUDA]
    rows = [(e.key, _device_us(e), e.count) for e in evts]
    rows = [r for r in rows if r[1] > 0]
    rows.sort(key=lambda r: -r[1])
    busy = _busy(prof, t0, t1)
    busy_ns = sum(b - a for a, b in busy)
    wall = t1 - t0
    return {
        "call": label, "card": card, "wall_ms": wall / 1e6,
        "device_busy_ms": busy_ns / 1e6,
        "device_idle_share": 1 - busy_ns / wall if wall else None,
        "top": [{"kernel": k[:80], "ms": us / 1e3, "count": c}
                for k, us, c in rows[:10]],
        "spans": _span_table(trace.records(t0, t1), busy),
    }


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workset-mb", type=int, default=128)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile: CUDA is not available")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    ws = args.workset_mb << 20
    dev = torch.device("cuda")
    sy = synth(ws, 8, 19)
    for name, data, ts, code, clevel in (
            ("synth sbits19 ts8", sy, 8, C.BLOSCLZ, 1),
            ("int32 arange ts4",
             np.arange(ws // 4, dtype=np.int32).view(np.uint8), 4, C.BLOSCLZ,
             1),
            ("lz4 synth sbits19 ts8", sy, 8, C.LZ4, 1),
            ("synth sbits19 ts8 clevel 5", sy, 8, C.BLOSCLZ, 5),
            ("synth sbits19 ts8 clevel 9", sy, 8, C.BLOSCLZ, 9)):
        bs = policy.compute_blocksize_device(clevel, ts, 4 << 20)
        nsplits = ts
        neblock = bs // nsplits
        x = torch.from_numpy(data.reshape(-1, bs).copy()).to(dev)

        def comp():
            return pipeline.compress_blocks(
                x, C.SHUFFLE, ts, nsplits,
                policy.device_min_bytes_per_iter(clevel), code,
                policy.device_min_cratio_x100(clevel),
                policy.device_mine(clevel))

        slots, cs = comp()
        rows = pipeline.mask_past_csize(slots, cs, slots.shape[1])

        def dec():
            return pipeline.decompress_blocks(rows, cs, neblock, C.SHUFFLE,
                                              ts, nsplits, code)

        calls = [("compress_blocks", comp), ("decompress_blocks", dec)]
        if policy.device_mine(clevel):
            from ..gpu import codec

            seen = mined_inputs(comp)
            calls.append(("mine_group on the streams compress_blocks mines,",
                          lambda: [codec.mine_group(*a) for a in seen]))
        for label, fn in calls:
            r = _profile(fn, f"{label} {name} {ws >> 20} MB", card)
            print(json.dumps(r))
    n = 256 << 10
    low = (np.random.default_rng(11).integers(0, 8, n, dtype=np.uint8) * 16)
    ctx = engine.build_context(9, C.NOSHUFFLE, 1, n, n + 16, C.BLOSCLZ)
    chunk = backend.compress_chunk(ctx, low.tobytes())
    r = _profile(lambda: api.decompress_ctx(chunk, device=dev),
                 "decompress_ctx host-engine clevel-9 256 KB", card)
    print(json.dumps(r))
    z = sy[:4 << 20].tobytes()
    ctx = engine.build_context(5, C.SHUFFLE, 8, len(z), len(z) + 16, C.LZ4)
    chunk = backend.compress_chunk(ctx, z)
    r = _profile(lambda: api.decompress_ctx(chunk, device=dev),
                 "decompress_ctx host-engine LZ4 clevel-5 synth 4 MB", card)
    print(json.dumps(r))
    ctx = engine.build_context(1, C.SHUFFLE, 8, len(z), len(z) + 16, C.SNAPPY)
    chunk = backend.compress_chunk(ctx, z)
    r = _profile(lambda: api.decompress_ctx(chunk, device=dev),
                 "decompress_ctx host-engine snappy synth 4 MB", card)
    print(json.dumps(r))
    ctx = engine.build_context(5, C.SHUFFLE, 8, len(z), len(z) + 16, C.ZLIB)
    chunk = backend.compress_chunk(ctx, z)
    r = _profile(lambda: api.decompress_ctx(chunk, device=dev),
                 "decompress_ctx host-engine zlib clevel-5 synth 4 MB", card)
    print(json.dumps(r))
    ctx = engine.build_context(5, C.SHUFFLE, 8, len(z), len(z) + 16, C.ZSTD)
    chunk = backend.compress_chunk(ctx, z)
    r = _profile(lambda: api.decompress_ctx(chunk, device=dev),
                 "decompress_ctx host-engine zstd clevel-5 synth 4 MB", card)
    print(json.dumps(r))


if __name__ == "__main__":
    main()
