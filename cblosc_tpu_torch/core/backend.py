"""Host-engine router: the native C++ engine first, the numpy engine
where it declines (cf. cblosc_tpu/core/backend.py).

The byte API (api.py) tries the device pipeline and, where the device
path declines (codecs the device does not encode, buffers with no full
block, memcpyed chunks, blocks above the device decoders' caps), hands
the whole chunk job to this router: device -> native -> numpy, the
order of the JAX package's ``backend="tpu"`` path. Both host engines
write the same bytes; the native one (native/binding.py) declines only
a codec it was built without (zlib without its header, zstd without
libzstd), and then the numpy engine (core/engine.py) serves the call.

``CALLS`` counts the calls each engine served, beside
gpu/kernels.LAUNCHES, so that tests and chip_smoke.py see which engine
ran; the open trace span (utils/trace.py) counts it as its route.
"""

from __future__ import annotations

from ..native import binding as native
from ..utils import trace
from . import engine

CALLS = {"native": 0, "numpy": 0}


def reset_calls() -> None:
    for k in CALLS:
        CALLS[k] = 0


def _served(name: str) -> None:
    CALLS[name] += 1
    trace.count("route." + name, 1)


def compress_chunk(ctx, data: bytes) -> bytes:
    out = native.compress_chunk(ctx, data)
    if out is not None:
        _served("native")
        return out
    _served("numpy")
    return engine.compress_chunk(ctx, data)


def decompress_chunk(chunk: bytes, destsize: int | None,
                     nthreads: int) -> bytes:
    out = native.decompress_chunk(chunk, destsize, nthreads)
    if out is not None:
        _served("native")
        return out
    _served("numpy")
    return engine.decompress_chunk(chunk, destsize)


def getitem(chunk: bytes, start: int, nitems: int) -> bytes:
    out = native.getitem(chunk, start, nitems)
    if out is not None:
        _served("native")
        return out
    _served("numpy")
    return engine.getitem(chunk, start, nitems)


def free_resources() -> None:
    native.free_resources()


def after_fork_in_child() -> None:
    native.after_fork_in_child()
