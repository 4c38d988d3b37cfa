"""Zstd codec via libzstd, called one-shot through ctypes.

Mirrors the reference wrapper (blosc/blosc.c:498-522): one-shot
``ZSTD_compress``/``ZSTD_decompress`` with clevel 1-8 -> zstd level
2*clevel-1 and clevel 9 -> ZSTD_maxCLevel(). The one-shot simple API
derives its compression parameters from the known source size, which is
what makes the chunk bytes equal to the reference's.

The library is resolved once: the system's libzstd, else the copy
bundled with the `zstandard` package. Different libzstd versions emit
different bytes for the same input, so byte parity holds between engines
that load the same library. Where no libzstd exists the codec reports
itself unavailable (``AVAILABLE`` false) and its calls raise, as the
reference's build without HAVE_ZSTD has no zstd.

``compress2_frame`` exposes ZSTD_compress2 with a compression level, a
window log and the checksum flag, for generated test frames only (a
small window cuts a frame into many blocks).
"""

from __future__ import annotations

import ctypes
import ctypes.util
import glob
import os


def _lib_path() -> str | None:
    path = ctypes.util.find_library("zstd")
    if path:
        return path
    try:
        import zstandard as _zstd_mod
    except ImportError:
        return None
    hits = glob.glob(os.path.join(os.path.dirname(_zstd_mod.__file__),
                                  "_cffi*.so"))
    return hits[0] if hits else None


def _load():
    path = _lib_path()
    if not path:
        return None
    try:
        lib = ctypes.CDLL(path)
        lib.ZSTD_compress.restype = ctypes.c_size_t
        lib.ZSTD_compressBound.restype = ctypes.c_size_t
        lib.ZSTD_decompress.restype = ctypes.c_size_t
        lib.ZSTD_isError.restype = ctypes.c_uint
        lib.ZSTD_maxCLevel.restype = ctypes.c_int
        lib.ZSTD_versionNumber.restype = ctypes.c_uint
        lib.ZSTD_createCCtx.restype = ctypes.c_void_p
        lib.ZSTD_freeCCtx.argtypes = [ctypes.c_void_p]
        lib.ZSTD_CCtx_setParameter.restype = ctypes.c_size_t
        lib.ZSTD_CCtx_setParameter.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                               ctypes.c_int]
        lib.ZSTD_compress2.restype = ctypes.c_size_t
        lib.ZSTD_compress2.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                       ctypes.c_size_t, ctypes.c_void_p,
                                       ctypes.c_size_t]
        return lib
    except (OSError, AttributeError):  # pragma: no cover - broken installation
        return None


_lib = _load()
AVAILABLE = _lib is not None
if AVAILABLE:
    _v = _lib.ZSTD_versionNumber()
    LIBRARY_VERSION = (_v // 10000, (_v // 100) % 100, _v % 100)
else:  # pragma: no cover - environment without libzstd
    LIBRARY_VERSION = (0, 0, 0)


def _require() -> None:
    if not AVAILABLE:
        raise RuntimeError("zstd support not available (no libzstd found)")


def _map_level(clevel: int) -> int:
    # blosc.c:502-504: the reference's `if (clevel == 8)` adjustment tests
    # the already-mapped (odd) value and never fires, so it is not applied
    if clevel < 9:
        return clevel * 2 - 1
    return _lib.ZSTD_maxCLevel()


def compress(src, maxout: int, clevel: int) -> bytes:
    _require()
    data = bytes(src)
    buf = ctypes.create_string_buffer(max(maxout, 1))
    code = _lib.ZSTD_compress(
        buf, ctypes.c_size_t(maxout), data, ctypes.c_size_t(len(data)),
        ctypes.c_int(_map_level(clevel)))
    if _lib.ZSTD_isError(ctypes.c_size_t(code)):
        return b""
    return buf.raw[:code]


def decompress(src, maxout: int) -> bytes:
    _require()
    data = bytes(src)
    buf = ctypes.create_string_buffer(max(maxout, 1))
    code = _lib.ZSTD_decompress(
        buf, ctypes.c_size_t(maxout), data, ctypes.c_size_t(len(data)))
    if _lib.ZSTD_isError(ctypes.c_size_t(code)):
        raise ValueError("zstd decompress error")
    return buf.raw[:code]


def frame(data: bytes, level: int) -> bytes:
    """One-shot ZSTD_compress of data at a zstd level (not a clevel)."""
    _require()
    cap = len(data) * 2 + 512
    buf = ctypes.create_string_buffer(cap)
    code = _lib.ZSTD_compress(buf, ctypes.c_size_t(cap), data,
                              ctypes.c_size_t(len(data)), ctypes.c_int(level))
    if _lib.ZSTD_isError(ctypes.c_size_t(code)):
        raise ValueError("zstd compress error")
    return buf.raw[:code]


_C_LEVEL, _C_WINDOWLOG, _C_CHECKSUM = 100, 101, 201   # ZSTD_cParameter


def compress2_frame(data: bytes, level: int, window_log: int = 0,
                    checksum: bool = False) -> bytes:
    """ZSTD_compress2 of data at a zstd level, with a window log (0: the
    library's choice) and the content checksum flag."""
    _require()
    cctx = _lib.ZSTD_createCCtx()
    try:
        for p, v in ((_C_LEVEL, level), (_C_WINDOWLOG, window_log),
                     (_C_CHECKSUM, int(checksum))):
            if _lib.ZSTD_isError(_lib.ZSTD_CCtx_setParameter(cctx, p, v)):
                raise ValueError(f"zstd parameter {p} = {v} refused")
        cap = len(data) * 2 + 512
        buf = ctypes.create_string_buffer(cap)
        code = _lib.ZSTD_compress2(cctx, buf, cap, data, len(data))
        if _lib.ZSTD_isError(ctypes.c_size_t(code)):
            raise ValueError("zstd compress error")
        return buf.raw[:code]
    finally:
        _lib.ZSTD_freeCCtx(cctx)
