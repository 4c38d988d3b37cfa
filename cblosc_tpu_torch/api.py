"""Byte API of the PyTorch/CUDA port: the stateless context calls
(blosc_compress_ctx / blosc_decompress_ctx, blosc.h:262-330) and the
plain compress/decompress wrappers.

Every call runs the device pipeline on ``device`` (default ``cuda``;
``device="cpu"`` runs the kernels' plain PyTorch versions) and takes the
host engine only where the device bridge declines (memcpyed chunks, no
full block), as the JAX package's ``backend="tpu"`` path does.
``compress`` returns b"" when the data is incompressible and does not
fit ``destsize`` (the reference's return-0 contract, blosc.h:167-169).

Codecs: blosclz, lz4 and lz4hc compress and decompress on the device;
snappy, zlib and zstd chunks compress on the host engine and decompress
on the device (zstd blocks above 512 KB decode on the host engine, as in
the JAX package).

Every clevel compresses on the device for blosclz, lz4 and lz4hc; the
ratio clevels (>= 5) mine per-row adaptive match distances there.

Not ported yet: getitem, global state, BLOSC_* environment overrides
and threads.
"""

from __future__ import annotations

import numpy as np

from . import device as device_mod
from .core import engine
from .format import constants as C
from .gpu import host_api


def _coerce_src(src) -> bytes:
    if isinstance(src, (bytes, bytearray, memoryview)):
        return bytes(src)
    if isinstance(src, np.ndarray):
        return src.tobytes()
    return bytes(src)


def compress_ctx(
    clevel: int,
    doshuffle: int,
    typesize: int,
    src,
    destsize: int | None = None,
    compressor: str = "blosclz",
    blocksize: int = 0,
    splitmode: int = C.FORWARD_COMPAT_SPLIT,
    device=None,
) -> bytes:
    """Stateless compression (blosc_compress_ctx). Returns the serialized
    chunk, or b"" when the data does not fit ``destsize``. splitmode is
    one of ALWAYS_SPLIT, NEVER_SPLIT, AUTO_SPLIT and FORWARD_COMPAT_SPLIT
    (the default), as in the JAX package."""
    dev = device_mod.resolve(device)
    data = _coerce_src(src)
    nbytes = len(data)
    if destsize is None:
        destsize = nbytes + C.MAX_OVERHEAD
    code = C.COMPCODES.get(compressor)
    if code is None:
        raise ValueError(f"unknown compressor '{compressor}'")
    ctx = engine.build_context(
        clevel, doshuffle, typesize, nbytes, destsize, code,
        forced_blocksize=blocksize, splitmode=splitmode,
    )
    out = host_api.compress_chunk(ctx, data, dev)
    if out is None:
        out = engine.compress_chunk(ctx, data)
    return out


def decompress_ctx(src, destsize: int | None = None, device=None) -> bytes:
    """Stateless decompression (blosc_decompress_ctx)."""
    dev = device_mod.resolve(device)
    data = _coerce_src(src)
    out = host_api.decompress_chunk(data, destsize, dev)
    if out is None:
        out = engine.decompress_chunk(data, destsize)
    return out


def compress(clevel: int, doshuffle: int, typesize: int, src,
             destsize: int | None = None, device=None) -> bytes:
    """blosc_compress with the default codec (blosclz)."""
    return compress_ctx(clevel, doshuffle, typesize, src, destsize,
                        device=device)


def decompress(src, destsize: int | None = None, device=None) -> bytes:
    """blosc_decompress."""
    return decompress_ctx(src, destsize, device=device)
