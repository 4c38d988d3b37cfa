"""Device time of the zstd walk kernel (K7) alone, for comparing kernel
variants between calls on the card:

    python scratch/zstd_walk_time.py

Builds the kernels of this checkout, prints zstd_walk's ptxas register
line, then K7's device ms a launch (torch.profiler, chip_smoke's
kernel_ms) on the live rows of the 4 MB synth zstd chunks at clevels 5
and 1 (each row first replayed by K7 + K1 against libzstd) and on the
4,096 rows of 128 MB of synth at clevel 1, all at the default budget.
"""

import os
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as cs  # noqa: E402
import cblosc_tpu_torch as tb  # noqa: E402
from cblosc_tpu_torch.format import constants as C  # noqa: E402
from cblosc_tpu_torch.gpu import codec_zstd, kernels  # noqa: E402
from cblosc_tpu_torch.utils.profile import kernel_ms  # noqa: E402
from cblosc_tpu_torch.utils.timing import synth  # noqa: E402


def main() -> None:
    kernels.build_all()
    for line in kernels.build_log["zstd_walk"].splitlines():
        if "registers" in line:
            print("zstd_walk", line.strip())
    dev = torch.device("cuda")
    sy = synth(4 << 20, 8, 19).tobytes()
    for cl in (5, 1):
        ch = tb.compress_ctx(cl, C.SHUFFLE, 8, sy, compressor="zstd", device=dev)
        r, c, n = cs.chunk_rows(dev, ch)
        r, c = cs.live_rows(r, c, n)
        cs._zstd_replayed(dev, r, c, n)
        ms = kernel_ms(lambda: codec_zstd.fsm_walk(
            r, c, n, codec_zstd.default_events(n)), "::zstd_walk")
        print("clevel", cl, "rows", r.shape[0], "K7 device ms", ms)
    big = synth(128 << 20, 8, 19)
    chunks = [cs.host_codec_chunk(C.ZSTD, 1, big[i:i + (4 << 20)].tobytes(), 8)
              for i in range(0, 128 << 20, 4 << 20)]
    parts = [cs.chunk_rows(dev, x) for x in chunks]
    r = torch.cat([p[0] for p in parts])
    c = torch.cat([p[1] for p in parts])
    n = parts[0][2]
    ms = kernel_ms(lambda: codec_zstd.fsm_walk(
        r, c, n, codec_zstd.default_events(n)), "::zstd_walk")
    print("clevel 1 128 MB rows", r.shape[0], "K7 device ms", ms)


if __name__ == "__main__":
    main()
