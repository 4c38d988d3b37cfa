"""Clock stamps of the mining kernel's phases on the card: a copy of
csrc/mine.cu with clock64() stamps after each phase, built by nvcc and run
on the mine_group calls of one 4 MB synth compress per write cell.

    python3 scratch/mine_phases.py
"""
import ctypes
import os
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from cblosc_tpu_torch.gpu import codec, kernels  # noqa: E402

src = (ROOT / "cblosc_tpu_torch/csrc/mine.cu").read_text()
STAMP = "__syncthreads(); if (threadIdx.x == 0) dbg[blockIdx.x * 8 + {k}] = clock64();\n"


def edit(old, new):
    """src with its one `old` replaced by `new`; raises where mine.cu no
    longer holds `old` exactly once, so that no stamp goes missing."""
    global src
    if src.count(old) != 1:
        raise RuntimeError(f"csrc/mine.cu holds {src.count(old)} of {old!r}, "
                           "not 1: bring this script up to date")
    src = src.replace(old, new)


edit("uint8_t* __restrict__ eq_out) {",
     "uint8_t* __restrict__ eq_out, long long* dbg) {")
edit("  long long dp = 0, hp = 0, dg = 0, hg = 0;\n",
     STAMP.format(k=0) + "  long long dp = 0, hp = 0, dg = 0, hg = 0;\n")
edit("    mine(bytes_sh, m, p_pre, keys_sh, tmp, hist, 4, kMaxFar, red, dp, hp);\n",
     "    mine(bytes_sh, m, p_pre, keys_sh, tmp, hist, 4, kMaxFar, red, dp, hp);\n"
     + STAMP.format(k=1))
edit("    long long d, hits;\n", STAMP.format(k=2) + "    long long d, hits;\n")
edit("    mine(fb, m, p_fold, keys, tmp, hist, 1, max_d / fg, red, d, hits);\n",
     "    mine(fb, m, p_fold, keys, tmp, hist, 1, max_d / fg, red, d, hits);\n"
     + STAMP.format(k=3))
edit("  if (adopt) {\n", STAMP.format(k=4) + "  if (adopt) {\n")
edit("  if (threadIdx.x == 0) d_out[row] = adopt ? d : 0;\n",
     STAMP.format(k=5) + "  if (threadIdx.x == 0) d_out[row] = adopt ? d : 0;\n"
     "  if (threadIdx.x == 0) dbg[blockIdx.x * 8 + 6] = d;\n")
edit("void* eq_out, void* stream) {", "void* eq_out, void* stream, void* dbg) {")
edit("(uint8_t*)eq_out);", "(uint8_t*)eq_out, (long long*)dbg);")
d = ROOT / "build" / "mine_phases"
d.mkdir(parents=True, exist_ok=True)
open(os.path.join(d, "m.cu"), "w").write(src)
so = os.path.join(d, "libm.so")
subprocess.run([kernels._nvcc(), *kernels.NVCC_FLAGS, "-I", str(ROOT / "cblosc_tpu_torch/csrc"),
                "-o", so, os.path.join(d, "m.cu")], check=True, capture_output=True)
fn = ctypes.CDLL(so).mine_launch
P = ctypes.c_void_p
fn.argtypes = [P, ctypes.c_int, ctypes.c_longlong, P, ctypes.c_int, ctypes.c_int, P,
               ctypes.c_longlong, P, P, P, P]

import chip_smoke  # noqa: E402
from cblosc_tpu_torch.core import policy  # noqa: E402
from cblosc_tpu_torch.format import constants as C  # noqa: E402
from cblosc_tpu_torch.gpu import pipeline  # noqa: E402
from cblosc_tpu_torch.utils.profile import mined_inputs  # noqa: E402
from cblosc_tpu_torch.utils.timing import synth  # noqa: E402

dev = torch.device("cuda")
data = synth(4 << 20, 8, 19)
for code, clevel in ((C.BLOSCLZ, 9), (C.LZ4, 5)):
    bs, ns = chip_smoke._write_geometry(code, clevel, 8, 4 << 20)
    x = torch.from_numpy(data.reshape(-1, bs).copy()).to(dev)
    seen = mined_inputs(lambda: pipeline.compress_blocks(
        x, C.SHUFFLE, 8, ns, policy.device_min_bytes_per_iter(clevel), code,
        policy.device_min_cratio_x100(clevel), True))
    for s, d_row, max_d in seen:
        N, n = s.shape
        dr = d_row.reshape(-1).contiguous()
        dm = torch.empty(N, dtype=torch.int64, device=dev)
        eq = torch.empty((N, n), dtype=torch.bool, device=dev)
        dbg = torch.zeros(N * 8, dtype=torch.int64, device=dev)
        for _ in range(3):
            code_ = fn(s.data_ptr(), N, n, dr.data_ptr(), int(dr.dtype == torch.int64),
                       max_d, None, 0, dm.data_ptr(), eq.data_ptr(),
                       kernels.stream_ptr(s), dbg.data_ptr())
            if code_:
                raise RuntimeError(f"launch failed: error {code_}")
        torch.cuda.synchronize()
        t = dbg.view(N, 8).cpu()
        ph = (t[:, 1:6] - t[:, 0:5]).float()
        print(f"{C.COMPNAMES[code]} N={N} n={n}: cycles per phase (prefix, fold bytes, "
              f"fold mine, coverage, eq write), mean over rows: "
              f"{[round(v) for v in ph.mean(0).tolist()]}, max total "
              f"{int((t[:, 5] - t[:, 0]).max())}; d {t[:, 6].tolist()}")
        ref = codec._mine_group_plain(s, d_row, max_d)
        if not (torch.equal(dm, ref[0]) and torch.equal(eq, ref[1])):
            raise RuntimeError("the stamped kernel differs from the plain version")
