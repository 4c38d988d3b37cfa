"""A/B of the port's byte-API decodes between two checkouts, one process
per side, to be run in turns (parent, change, change, parent) in one
call on the card:

    python scratch/ab_byte_api.py TREE [--reps 20]

Imports cblosc_tpu_torch from the checkout TREE (its kernels build into
TREE/build/torch_kernels), makes two chunks with the host engine from
4 MB of synth (sbits 19, typesize 8, shuffle): snappy (clevel 1) and
zstd (clevel 5), and prints one JSON line with, per chunk, the median
call time of decompress_ctx(chunk, device="cuda") over --reps calls
(CUDA events around each call; the call ends with the output on the
host), the device time of one profiled call (torch.profiler, all its
kernels and copies), the walk kernel's share of it, and the card's name
and power limit.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("tree")
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args()
    tree = os.path.abspath(args.tree)
    sys.path.insert(0, tree)
    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    import cblosc_tpu_torch as tb
    from cblosc_tpu_torch.core import engine
    from cblosc_tpu_torch.format import constants as C
    from cblosc_tpu_torch.gpu import kernels
    from cblosc_tpu_torch.utils.timing import synth

    if os.path.dirname(os.path.dirname(tb.__file__)) != tree:
        raise SystemExit(f"ab_byte_api: imported {tb.__file__}, not {tree}")
    if not torch.cuda.is_available():
        raise SystemExit("ab_byte_api: CUDA is not available")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
        check=True).stdout.strip().splitlines()[0]
    kernels.build_all()
    dev = torch.device("cuda")
    data = synth(4 << 20, 8, 19).tobytes()
    out = {"tree": args.tree, "card": card}
    for label, code, clevel, walk in (("snappy", C.SNAPPY, 1, "snappy_walk"),
                                      ("zstd", C.ZSTD, 5, "zstd_walk")):
        ctx = engine.build_context(clevel, C.SHUFFLE, 8, len(data),
                                   len(data) + 16, code)
        chunk = engine.compress_chunk(ctx, data)

        def call():
            return tb.decompress_ctx(chunk, device=dev)

        if call() != data:
            raise SystemExit(f"ab_byte_api: {label} decode differs")
        times = []
        for _ in range(args.reps):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            call()
            end.record()
            torch.cuda.synchronize()
            times.append(start.elapsed_time(end))
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            call()
            torch.cuda.synchronize()
        dev_us = walk_us = 0.0
        for e in prof.key_averages():
            if getattr(e, "device_type", None) != DeviceType.CUDA:
                continue
            us = float(getattr(e, "self_device_time_total",
                               getattr(e, "self_cuda_time_total", 0.0)))
            dev_us += us
            if walk in e.key:
                walk_us += us
        out[label] = {"call_ms_median": float(np.median(times)),
                      "call_ms_all": times, "device_ms": dev_us / 1e3,
                      f"{walk}_ms": walk_us / 1e3, "chunk_bytes": len(chunk)}
    print(json.dumps(out))


if __name__ == "__main__":
    main()
