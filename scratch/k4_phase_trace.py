"""Where a launch of the LZ4 walk kernel (K4) spends its time, block by
block, on the card:

    python scratch/k4_phase_trace.py

Copies csrc/lz4_walk.cu with a %globaltimer stamp (thread 0 of each CTA)
inserted at the start of each phase of a block: 0 the CTA starts, 1 the
run-length scan starts (the row is staged and the one-block walk is
done), 2 the node evaluation starts, 3 the pointer jumping starts, 4 the
CTA waits for its entry, 5 the entry is in, 6 the emission is done, 7 the
row's last block is done (after the -1 tail; for a row the one-block walk
ends, right after it). Builds the copy with
nvcc into build/k4_trace/, runs it through codec_lz4.walk on the live rows
of the host engine's LZ4 clevel-5 chunk of 4 MB synth (numcodecs'
default) at the escalated budget, the generated 128 KB "far" row and the
320 main-path rows, checks the outputs against the committed kernel's,
and prints one JSON line: per input the microseconds of each stamp from
the launch's first CTA start, for every block of the densest row, and for
the main-path rows the minimum, median and maximum of each stamp.
"""

from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs_mod  # noqa: E402
from cblosc_tpu_torch.format import constants as C  # noqa: E402
from cblosc_tpu_torch.gpu import codec_lz4, kernels, structured  # noqa: E402
from cblosc_tpu_torch.utils import streams  # noqa: E402
from cblosc_tpu_torch.utils.timing import synth  # noqa: E402

STAMPS = 8
# (anchor in lz4_walk.cu, stamp, before the anchor?)
MARKS = [
    ("  const uint8_t* rowp = slots + (long long)row * W;\n", 0, True),
    ("  // ---- run lengths of 255 bytes", 1, True),
    ("  // ---- evaluate every node, initial states", 2, True),
    ("  // ---- pointer jumping (Jacobi rounds)", 3, True),
    ("  // ---- the entry: wait for it, publish the next one", 4, True),
    ("    sh.alive = alive;\n", 5, False),
    ("  if (!sh.term) return;\n", 6, True),
    ("  out.tail(cnt, T0);\n", 7, False),
    ("    out.tail(sh.cnt0, T0);\n", 7, False),
]
STAMP = (
    "__device__ unsigned long long* g_trace;\n"
    "__device__ __forceinline__ void stamp(int k) {\n"
    "  unsigned long long t;\n"
    '  asm volatile("mov.u64 %0, %globaltimer;" : "=l"(t));\n'
    "  if (threadIdx.x == 0)\n"
    f"    g_trace[(long long)blockIdx.x * {STAMPS} + k] = t;\n"
    "}\n")


def build():
    src = open(os.path.join(kernels.CSRC, "lz4_walk.cu")).read()
    src = src.replace("struct Out {", STAMP + "struct Out {", 1)
    for anchor, k, before in MARKS:
        if anchor not in src:
            raise SystemExit(f"k4_phase_trace: anchor not found: {anchor!r}")
        mark = f"  stamp({k});\n"
        src = src.replace(anchor, mark + anchor if before else anchor + mark,
                          1)
    src = src.replace(
        'extern "C" int lz4_walk_launch(',
        'extern "C" int set_trace(void* p) {\n'
        '  return (int)cudaMemcpyToSymbol(g_trace, &p, sizeof(p));\n}\n'
        'extern "C" int lz4_walk_launch(', 1)
    out = os.path.join(ROOT, "build", "k4_trace")
    os.makedirs(out, exist_ok=True)
    cu = os.path.join(out, "lz4_walk_trace.cu")
    so = os.path.join(out, "lib.so")
    open(cu, "w").write(src)
    r = subprocess.run([kernels._nvcc(), *kernels.NVCC_FLAGS, "-o", so, cu],
                       capture_output=True, text=True)
    if r.returncode:
        raise SystemExit(f"k4_phase_trace: build failed\n{r.stdout}{r.stderr}")
    lib = ctypes.CDLL(so)
    lib.lz4_walk_launch.argtypes = kernels._SIGS["lz4_walk"][1]
    lib.lz4_walk_launch.restype = ctypes.c_int
    lib.set_trace.argtypes = [ctypes.c_void_p]
    return lib


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("k4_phase_trace: CUDA is not available")
    dev = torch.device("cuda")
    kernels.build_all()
    plain_fn = kernels.fn("lz4_walk")
    lib = build()
    data = synth(4 << 20, 8, 19).tobytes()
    rows, cs, n = cs_mod.chunk_rows(dev, cs_mod.host_codec_chunk(C.LZ4, 5,
                                                                 data, 8))
    rows, cs = cs_mod.live_rows(rows, cs, n)
    seed, ln, width = streams.LZ4_CARD_CASES[-1]
    buf, fcs = streams.lz4_rows(seed, ln, width)[:2]
    far = 2 * streams.LZ4_KINDS.index("far")
    m_rows, m_cs, mn = cs_mod.lz4_main_rows(dev, 4 << 20)
    inputs = {
        "chunk5_escalated": (rows, cs, n, structured.high_records(n)),
        "far": (torch.from_numpy(buf[far:far + 1]).to(dev),
                torch.from_numpy(fcs[far:far + 1]).to(dev), ln,
                codec_lz4.max_records(ln)),
        "main": (m_rows, m_cs, mn, codec_lz4.max_records(mn))}
    card = cs_mod.card_line()
    out = {"card": card}
    for name, (r, c, nn, mr) in inputs.items():
        N, W = r.shape
        nblk = -(-W // codec_lz4.K4_BLOCK)
        kernels._libs["lz4_walk"] = plain_fn
        want = codec_lz4.walk(r, c, nn, mr)
        kernels._libs["lz4_walk"] = lib.lz4_walk_launch
        tr = torch.zeros(N * nblk * STAMPS, dtype=torch.int64, device=dev)
        if lib.set_trace(tr.data_ptr()):
            raise SystemExit("k4_phase_trace: cannot set the trace buffer")
        for _ in range(3):                          # the last launch is kept
            tr.zero_()
            got = codec_lz4.walk(r, c, nn, mr)
            torch.cuda.synchronize()
        kernels._libs["lz4_walk"] = plain_fn
        if not all(torch.equal(a, b) for a, b in
                   zip(got[0] + got[1:], want[0] + want[1:])):
            raise SystemExit(f"k4_phase_trace: traced kernel differs ({name})")
        t = tr.view(N * nblk, STAMPS).cpu().numpy().astype(np.float64)
        t0 = t[:, 0][t[:, 0] > 0].min()
        us = np.where(t > 0, (t - t0) / 1e3, np.nan)
        def cell(x):
            return None if np.isnan(x) else round(float(x), 2)

        entry = {"rows": N, "blocks_a_row": nblk,
                 "last_stamp_us": cell(np.nanmax(us))}
        if name == "main":
            live = us[:N]                          # block 0 of every row
            entry["block0_min_median_max_us"] = [
                [cell(np.nanmin(live[:, k])), cell(np.nanmedian(live[:, k])),
                 cell(np.nanmax(live[:, k]))] if not np.isnan(live[:, k]).all()
                else None for k in range(STAMPS)]
        else:
            row = int(torch.argmax(c).item())
            entry["densest_row"] = row
            entry["blocks_us"] = [[cell(x) for x in us[j * N + row]]
                                  for j in range(nblk)]
        out[name] = entry
    print(json.dumps(out))


if __name__ == "__main__":
    main()
