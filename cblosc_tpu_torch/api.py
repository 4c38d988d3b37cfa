"""Public API of the PyTorch/CUDA port: the surface of the reference C
library (blosc/blosc.h's exported functions), as in cblosc_tpu/api.py.

Two layers, like the reference:
  * the stateless context API (``compress_ctx`` / ``decompress_ctx``,
    blosc.h:232-302): pure functions, safe under any concurrency;
  * the global API (``compress`` / ``decompress`` / ``getitem`` /
    ``set_*``, blosc.h:120-219): process-global configuration plus the
    BLOSC_* environment-variable overrides, read per call as
    blosc.c:1320-1408 reads them.

Every call runs the device pipeline on ``device`` (default ``cuda``;
``device="cpu"`` runs the kernels' plain PyTorch versions) and takes the
host engine only where the device bridge declines (memcpyed chunks, no
full block, codecs the device does not encode), as the JAX package's
``backend="tpu"`` path does; ``device`` stands where the JAX calls take
``backend``. The host engine is core/backend.py's router: the native C++
engine (native/, built with g++ on first use), then the numpy engine
where the native one lacks a codec. ``compress`` returns b"" when the
data is incompressible and does not fit ``destsize`` (the reference's
return-0 contract, blosc.h:167-169).

Codecs: blosclz, lz4 and lz4hc compress and decompress on the device
at every clevel (the ratio clevels >= 5 mine per-row adaptive match
distances there); snappy, zlib and zstd chunks compress on the host
engine and decompress on the device (zstd blocks above 512 KB decode on
the host engine, as in the JAX package). ``getitem`` decodes only the
blocks that overlap the range.

The thread counts (``set_nthreads``, ``numinternalthreads``,
``BLOSC_NTHREADS``) are checked and stored as in the JAX package and
size the native engine's worker pool for the chunks the host engine
compresses and decompresses; the device path does not use them.
"""

from __future__ import annotations

import os
import sys
import threading

import numpy as np
import torch

from . import device as device_mod
from .core import backend, engine
from .format import constants as C
from .format.header import (
    FormatError,
    cbuffer_complib,
    cbuffer_metainfo,
    cbuffer_sizes,
    cbuffer_validate,
    cbuffer_versions,
)
from .gpu import host_api
from .models import registry
from .utils import trace

__all__ = [
    "init", "destroy", "free_resources",
    "compress", "compress_ctx", "decompress", "decompress_ctx", "getitem",
    "set_nthreads", "get_nthreads", "set_compressor", "get_compressor",
    "set_blocksize", "get_blocksize", "set_splitmode", "get_splitmode",
    "compcode_to_compname", "compname_to_compcode", "list_compressors",
    "get_version_string", "get_complib_info",
    "cbuffer_sizes", "cbuffer_metainfo", "cbuffer_versions",
    "cbuffer_complib", "cbuffer_validate",
    "FormatError",
]


class _GlobalState:
    """Process-global knobs (cf. globals at blosc.c:142-150)."""

    def __init__(self) -> None:
        self.lock = threading.RLock()
        self.initialized = False
        self.reset()

    def reset(self) -> None:
        self.compressor = C.BLOSCLZ
        self.nthreads = 1
        self.force_blocksize = 0
        self.splitmode = C.FORWARD_COMPAT_SPLIT


_state = _GlobalState()



def _after_fork_in_child() -> None:
    """Fork safety (cf. the pthread_atfork handler, blosc.c:2210-2244):
    a child starts from fresh state and a new lock, and runs torch's CPU
    ops on its own thread, since the parent's intra-op worker threads do
    not exist in it (an op that waits for them would hang); for the same
    reason the native engine's pool drops the parent's workers and
    starts new ones on its next call."""
    _state.__init__()
    torch.set_num_threads(1)
    backend.after_fork_in_child()


if hasattr(os, "register_at_fork"):
    os.register_at_fork(after_in_child=_after_fork_in_child)


def init() -> None:
    """Mark the library initialized (blosc_init, blosc.c:2223-2244);
    every entry point initializes itself."""
    _state.initialized = True


def destroy() -> None:
    """Reset the global configuration (blosc_destroy, blosc.c:2246-2260)."""
    with _state.lock:
        _state.initialized = False
        _state.reset()


def free_resources() -> None:
    """Drop what the port caches between calls (blosc_free_resources,
    blosc.c:2311-2316): the LZ4 walk's look-back scratch on the device,
    the template decoder's tables and the native engine's worker pool
    (JAX: core/backend.py:92-96). Kernels already loaded stay."""
    from .gpu import codec_lz4, structured

    codec_lz4._lookback.clear()
    structured._template_table.cache_clear()
    backend.free_resources()


# --- configuration ----------------------------------------------------------

def set_nthreads(n: int) -> int:
    """Set the thread count; returns the previous value
    (blosc_set_nthreads, blosc.c:1958-1973). The global API hands it to
    the native engine's pool; the device path does not use it."""
    if n <= 0 or n > C.MAX_THREADS:
        raise ValueError(f"nthreads must be in 1..{C.MAX_THREADS}")
    with _state.lock:
        prev = _state.nthreads
        _state.nthreads = int(n)
    return prev


def get_nthreads() -> int:
    return _state.nthreads


def set_compressor(name: str) -> int:
    """Select the default codec by name; returns its code
    (blosc_set_compressor, blosc.c:2010-2020)."""
    codec = registry.get_by_name(name)
    with _state.lock:
        _state.compressor = codec.code
    return codec.code


def get_compressor() -> str:
    return C.COMPNAMES[_state.compressor]


def set_blocksize(blocksize: int) -> None:
    """Force a blocksize, 0 for the automatic one
    (blosc_set_blocksize, blosc.c:2191-2194)."""
    with _state.lock:
        _state.force_blocksize = int(blocksize)


def get_blocksize() -> int:
    return _state.force_blocksize


def set_splitmode(splitmode: int) -> None:
    """(blosc_set_splitmode, blosc.c:2197-2200)"""
    if splitmode not in (C.ALWAYS_SPLIT, C.NEVER_SPLIT, C.AUTO_SPLIT,
                         C.FORWARD_COMPAT_SPLIT):
        raise ValueError(f"unknown split mode {splitmode}")
    with _state.lock:
        _state.splitmode = splitmode


def get_splitmode() -> int:
    return _state.splitmode


# --- name/code conversions --------------------------------------------------

def compcode_to_compname(compcode: int) -> str:
    name = C.COMPNAMES.get(compcode)
    if name is None:
        raise ValueError(f"unknown compressor code {compcode}")
    return name


def compname_to_compcode(compname: str) -> int:
    code = C.COMPCODES.get(compname)
    if code is None:
        return -1
    try:
        registry.get(code)
    except RuntimeError:
        return -1
    return code


def list_compressors() -> list[str]:
    return registry.list_compressors()


def get_version_string() -> str:
    return C.VERSION_STRING


def get_complib_info(compname: str) -> tuple[str, str]:
    return registry.complib_info(compname)


# --- env-var layer (blosc.h:175-219, blosc.c:1320-1408) ---------------------

def _env_int(name: str, minimum: int) -> int | None:
    """The integer value of an environment variable when it parses and
    is at least ``minimum``, else None."""
    v = os.environ.get(name)
    if v is None:
        return None
    try:
        iv = int(v)
    except ValueError:
        return None
    return iv if iv >= minimum else None


def _env_overrides(clevel, doshuffle, typesize):
    iv = _env_int("BLOSC_CLEVEL", 0)
    if iv is not None:
        clevel = iv
    v = os.environ.get("BLOSC_SHUFFLE")
    if v == "NOSHUFFLE":
        doshuffle = C.NOSHUFFLE
    elif v == "SHUFFLE":
        doshuffle = C.SHUFFLE
    elif v == "BITSHUFFLE":
        doshuffle = C.BITSHUFFLE
    iv = _env_int("BLOSC_TYPESIZE", 1)
    if iv is not None:
        typesize = iv
    v = os.environ.get("BLOSC_COMPRESSOR")
    if v is not None:
        set_compressor(v)
    iv = _env_int("BLOSC_BLOCKSIZE", 1)
    if iv is not None:
        set_blocksize(iv)
    iv = _env_int("BLOSC_NTHREADS", 1)
    if iv is not None:
        set_nthreads(iv)
    v = os.environ.get("BLOSC_SPLITMODE")
    if v is not None:
        mode = C.SPLITMODE_NAMES.get(v)
        if mode is None:
            raise ValueError(f"BLOSC_SPLITMODE value '{v}' not recognized")
        set_splitmode(mode)
    return clevel, doshuffle, typesize


def _coerce_src(src) -> bytes:
    if isinstance(src, (bytes, bytearray, memoryview)):
        return bytes(src)
    if isinstance(src, np.ndarray):
        return src.tobytes()
    return bytes(src)


def _warn(out: bytes, nbytes: int, clevel: int) -> None:
    """BLOSC_WARN: stderr notes on incompressible input
    (blosc.h:216-219, blosc.c:1076-1115)."""
    warn = os.environ.get("BLOSC_WARN")
    if not warn:
        return
    try:
        level = int(warn)
    except ValueError:
        level = 0
    if level >= 1 and not out:
        print("Blosc warning: input is not compressible within the "
              "destination budget (returning empty; keep the original "
              "buffer)", file=sys.stderr)
    elif (level >= 2 and out and len(out) >= nbytes + C.MAX_OVERHEAD
          and clevel != 0 and nbytes >= C.MIN_BUFFERSIZE):
        # only where compression was tried and fell back: clevel 0 and
        # tiny buffers are memcpyed by design
        print("Blosc warning: chunk stored uncompressed (memcpy mode)",
              file=sys.stderr)


# --- compression / decompression --------------------------------------------

def compress_ctx(
    clevel: int,
    doshuffle: int,
    typesize: int,
    src,
    destsize: int | None = None,
    compressor: str = "blosclz",
    blocksize: int = 0,
    numinternalthreads: int = 1,
    splitmode: int = C.FORWARD_COMPAT_SPLIT,
    device=None,
) -> bytes:
    """Stateless compression (blosc_compress_ctx, blosc.h:262-302).
    Returns the serialized chunk, or b"" when the data does not fit
    ``destsize``. splitmode is one of ALWAYS_SPLIT, NEVER_SPLIT,
    AUTO_SPLIT and FORWARD_COMPAT_SPLIT (the default).
    numinternalthreads sizes the native engine's pool where the host
    engine writes the chunk; the device path does not use it."""
    with trace.span("api.compress_ctx"):
        dev = device_mod.resolve(device)
        data = _coerce_src(src)
        nbytes = len(data)
        if destsize is None:
            destsize = nbytes + C.MAX_OVERHEAD
        codec = registry.get_by_name(compressor)
        ctx = engine.build_context(
            clevel, doshuffle, typesize, nbytes, destsize, codec.code,
            forced_blocksize=blocksize, splitmode=splitmode,
            nthreads=numinternalthreads,
        )
        out = host_api.compress_chunk(ctx, data, dev)
        if out is None:
            out = backend.compress_chunk(ctx, data)
        else:
            trace.count("route.device", 1)
        _warn(out, nbytes, clevel)
        return out


def compress(clevel: int, doshuffle: int, typesize: int, src,
             destsize: int | None = None, device=None) -> bytes:
    """Global-config compression (blosc_compress, blosc.h:120-173): the
    codec, blocksize, thread count and split mode of the set_* calls,
    each overridden by its BLOSC_* variable."""
    if not _state.initialized:
        init()
    # the BLOSC_* variables apply before the NOLOCK reroute: the
    # reference reads them all first and NOLOCK "should be the last env
    # var" (blosc.c:1320-1408); NOLOCK triggers on any set value
    clevel, doshuffle, typesize = _env_overrides(clevel, doshuffle, typesize)
    if os.environ.get("BLOSC_NOLOCK") is not None:
        # reroute to the lock-free context API (blosc.c:1379-1408)
        return compress_ctx(
            clevel, doshuffle, typesize, src, destsize,
            compressor=C.COMPNAMES[_state.compressor],
            blocksize=_state.force_blocksize,
            numinternalthreads=_state.nthreads,
            splitmode=_state.splitmode, device=device,
        )
    with _state.lock:
        name = C.COMPNAMES[_state.compressor]
        blocksize = _state.force_blocksize
        nthreads = _state.nthreads
        splitmode = _state.splitmode
    return compress_ctx(
        clevel, doshuffle, typesize, src, destsize,
        compressor=name, blocksize=blocksize,
        numinternalthreads=nthreads, splitmode=splitmode, device=device,
    )


def decompress_ctx(src, destsize: int | None = None,
                   numinternalthreads: int = 1, device=None) -> bytes:
    """Stateless decompression (blosc_decompress_ctx, blosc.h:304-330).
    numinternalthreads sizes the native engine's pool where the host
    engine decodes the chunk; the device path does not use it."""
    with trace.span("api.decompress_ctx"):
        dev = device_mod.resolve(device)
        data = _coerce_src(src)
        out = host_api.decompress_chunk(data, destsize, dev)
        if out is None:
            return backend.decompress_chunk(data, destsize,
                                            numinternalthreads)
        trace.count("route.device", 1)
        return out


def decompress(src, destsize: int | None = None, device=None) -> bytes:
    """Global-config decompression (blosc_decompress, blosc.h:221-260)."""
    if not _state.initialized:
        init()
    # BLOSC_NTHREADS applies before the NOLOCK reroute (blosc.c:1543-1562);
    # the context path is lock-free already, so NOLOCK changes nothing here
    iv = _env_int("BLOSC_NTHREADS", 1)
    if iv is not None:
        set_nthreads(iv)
    return decompress_ctx(src, destsize, _state.nthreads, device=device)


def getitem(src, start: int, nitems: int, device=None) -> bytes:
    """Partial decompression of items [start, start+nitems)
    (blosc_getitem, blosc.h:332-352): the device decodes only the blocks
    that overlap the range; the host engine (native first, single-
    threaded as the reference's) takes the chunks and ranges the device
    path declines (gpu/host_api.getitem)."""
    with trace.span("api.getitem"):
        dev = device_mod.resolve(device)
        data = _coerce_src(src)
        out = host_api.getitem(data, start, nitems, dev)
        if out is None:
            return backend.getitem(data, start, nitems)
        trace.count("route.device", 1)
        return out
