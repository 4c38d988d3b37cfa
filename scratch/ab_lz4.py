"""A/B of the LZ4 walk kernel (K4) and of the byte-API decode of
numcodecs' default chunk between two checkouts, one process per side, to
be run in turns (parent, change, change, parent) in one call on the card:

    python scratch/ab_lz4.py TREE [--reps 20] [--walk] [--check]

Imports cblosc_tpu_torch (and chip_smoke's input helpers) from the
checkout TREE, whose kernels build into TREE/build/torch_kernels. Makes
the host engine's LZ4 clevel-5 chunk of 4 MB synth (sbits 19, typesize
8, shuffle: numcodecs' Blosc() default) and prints one JSON line with
the card's name and power limit and:
  - the median and quartiles of --reps decompress_ctx(chunk) calls (CUDA
    events around each call, which ends with the output on the host),
    and the device time of one profiled call with K4's share of it;
  - with --walk, K4 alone (device ms a launch, torch.profiler over 20
    calls) on the chunk's 24 live rows at the default and the escalated
    budget, on 32 copies of those rows in one launch (the 128 MB working
    set; only the chunk's rows repeat), on the generated 128 KB "far" row
    and on the 320 live rows of the device encoder's clevel-1 chunk; the
    densest row's records, ns a record, the bound (stream bytes, csizes,
    16 B a valid record and the row flags over 3.35 TB/s) and the -1
    tail's bytes;
  - with --check, K4 held to its plain version on a host copy (tolerance
    0) on two dense and two short rows of the chunk at both budgets, and
    the 32 copies' outputs to 32 copies of the 24 rows'.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

HBM = 3.35e12


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("tree")
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--walk", action="store_true")
    ap.add_argument("--check", action="store_true")
    args = ap.parse_args()
    tree = os.path.abspath(args.tree)
    sys.path.insert(0, tree)
    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke as cs_mod
    import cblosc_tpu_torch as tb
    from cblosc_tpu_torch.format import constants as C
    from cblosc_tpu_torch.gpu import codec_lz4, kernels, structured
    from cblosc_tpu_torch.utils import streams
    from cblosc_tpu_torch.utils.profile import kernel_ms
    from cblosc_tpu_torch.utils.timing import synth

    for mod in (tb, cs_mod):
        if not os.path.abspath(mod.__file__).startswith(tree + os.sep):
            raise SystemExit(f"ab_lz4: imported {mod.__file__}, "
                             f"not from {tree}")
    if not torch.cuda.is_available():
        raise SystemExit("ab_lz4: CUDA is not available")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
        check=True).stdout.strip().splitlines()[0]
    kernels.build_all()
    dev = torch.device("cuda")
    data = synth(4 << 20, 8, 19).tobytes()
    chunk = cs_mod.host_codec_chunk(C.LZ4, 5, data, 8)
    out = {"tree": args.tree, "card": card, "chunk_bytes": len(chunk)}

    def call():
        return tb.decompress_ctx(chunk, device=dev)

    if call() != data:
        raise SystemExit("ab_lz4: the byte-API decode differs")
    times = []
    for _ in range(args.reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        call()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
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
        if "lz4_walk" in e.key:
            walk_us += us
    q1, med, q3 = np.percentile(times, [25, 50, 75])
    out["byte_api"] = {"call_ms_median": float(med), "call_ms_q1": float(q1),
                       "call_ms_q3": float(q3), "call_ms_all": times,
                       "device_ms": dev_us / 1e3, "lz4_walk_ms": walk_us / 1e3}

    if args.walk or args.check:
        rows, csz, n = cs_mod.chunk_rows(dev, chunk)
        rows, csz = cs_mod.live_rows(rows, csz, n)
        budgets = {"default": codec_lz4.max_records(n),
                   "escalated": structured.high_records(n)}
        rows32, cs32 = rows.repeat(32, 1), csz.repeat(32)
    if args.walk:
        def entry(r, c, nn, mr):
            fn = lambda: codec_lz4.walk(r, c, nn, mr)  # noqa: E731
            ms = kernel_ms(fn, "lz4_walk")
            k = fn()
            per_row = (k[0][0] >= 0).sum(dim=1)
            nrec = int(per_row.sum())
            E = structured.record_slots(mr)
            N = r.shape[0]
            return {"device_ms": ms, "rows": N, "records": nrec,
                    "densest_records": int(per_row.max()),
                    "ns_per_record": ms * 1e6 / max(int(per_row.max()), 1),
                    "accepted": int(k[3].sum()), "slots": E,
                    "bound_ms": (int(c.sum()) + 4 * N + 16 * nrec + 6 * N)
                    / HBM * 1e3,
                    "tail_ms": 16 * (N * E - nrec) / HBM * 1e3}

        w = {}
        for label, mr in budgets.items():
            w[f"chunk5_{label}"] = entry(rows, csz, n, mr)
            w[f"chunk5x32_{label}"] = entry(rows32, cs32, n, mr)
        seed, ln, width = streams.LZ4_CARD_CASES[-1]
        buf, fcs = streams.lz4_rows(seed, ln, width)[:2]
        far = 2 * streams.LZ4_KINDS.index("far")
        w["far"] = entry(torch.from_numpy(buf[far:far + 1]).to(dev),
                         torch.from_numpy(fcs[far:far + 1]).to(dev), ln,
                         codec_lz4.max_records(ln))
        m_rows, m_cs, mn = cs_mod.lz4_main_rows(dev, 4 << 20)
        w["main"] = entry(m_rows, m_cs, mn, codec_lz4.max_records(mn))
        out["walk"] = w
    if args.check:
        dense = torch.nonzero(csz > n // 2).flatten()[:2]
        short = torch.nonzero(csz <= n // 2).flatten()[:2]
        pick = torch.cat([dense, short])
        worst = 0
        for label, mr in budgets.items():
            r, c = rows[pick].contiguous(), csz[pick].contiguous()
            k = codec_lz4.walk(r, c, n, mr)
            p = codec_lz4._walk_plain(r.cpu(), c.cpu(), n,
                                      structured.record_slots(mr))
            worst = max(worst, cs_mod._maxdiff(k[0] + k[1:], p[0] + p[1:]))
            k24 = codec_lz4.walk(rows, csz, n, mr)
            k32 = codec_lz4.walk(rows32, cs32, n, mr)
            rep = tuple(t.repeat(32, *([1] * (t.dim() - 1)))
                        for t in k24[0] + k24[1:])
            worst = max(worst, cs_mod._maxdiff(k32[0] + k32[1:], rep))
        out["check_max_abs_err"] = worst
        if worst:
            print(json.dumps(out))
            raise SystemExit("ab_lz4: K4 differs from its plain version")
    print(json.dumps(out))


if __name__ == "__main__":
    main()
