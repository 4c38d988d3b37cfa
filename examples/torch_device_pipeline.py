"""The PyTorch port's pipeline on device-resident data.

The byte API (examples/simple.py) round-trips through host memory. When
the data already lives on the GPU, use the device pipeline directly:
blocks are filtered and encoded as one data-parallel program, and the
compressed form (worst-case slots and a csize vector) stays on the
device. ``getitem`` then reads one item range out of a serialized chunk,
decoding only the blocks that overlap it.

Runs on the GPU when there is one, else on the CPU (the kernels' plain
PyTorch versions); the first line says which.
"""

import numpy as np
import torch

import cblosc_tpu_torch as blosc
from cblosc_tpu_torch.gpu import pipeline

NBLOCKS, BLOCKSIZE, TYPESIZE = 8, 64 * 1024, 4


def main() -> None:
    dev = torch.device("cuda" if torch.cuda.is_available() else "cpu")
    print("device:", dev)
    rng = np.random.default_rng(0)
    host = (rng.integers(0, 1 << 12, NBLOCKS * BLOCKSIZE // 4,
                         dtype=np.int32) * 8)
    x = torch.from_numpy(host.view(np.uint8).reshape(NBLOCKS, BLOCKSIZE)
                         ).to(dev)

    slots, csizes = pipeline.compress_blocks(
        x, doshuffle=blosc.SHUFFLE, typesize=TYPESIZE, nsplits=TYPESIZE)
    total = int(csizes.sum())
    print(f"compressed on device: {x.numel()} -> ~{total} payload bytes "
          f"({x.numel() / total:.1f}x)")

    rows = pipeline.mask_past_csize(slots, csizes, slots.shape[1])
    blocks, err = pipeline.decompress_blocks(
        rows, csizes, BLOCKSIZE // TYPESIZE, blosc.SHUFFLE, TYPESIZE,
        TYPESIZE)
    assert not bool(err.any())
    assert torch.equal(blocks, x)
    print("device roundtrip OK")

    # random access into a serialized chunk: only the block that holds
    # items 70,000..70,099 is decoded
    chunk = blosc.compress_ctx(1, blosc.SHUFFLE, TYPESIZE, host, device=dev)
    part = blosc.getitem(chunk, 70_000, 100, device=dev)
    assert part == host[70_000:70_100].tobytes()
    print(f"getitem of 100 items from a {len(chunk)}-byte chunk OK")


if __name__ == "__main__":
    main()
