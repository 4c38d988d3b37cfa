"""Codec registry: the names, codes and libraries of the six codecs.

Counterpart of cblosc_tpu/models/registry.py over the port's own
ops/codecs (the role of the reference's codec matrix and name/code
tables, blosc/blosc.c:296-574). Each codec provides
``compress(data, maxout, clevel, split)`` and ``decompress(data,
maxout)`` over one split stream; the host engine encodes and decodes
through them.

zstd is available where libzstd loads (ops/codecs/zstd_.py, by ctypes);
its version is that library's.
"""

from __future__ import annotations

import zlib as _zlib
from dataclasses import dataclass, field
from typing import Callable

from ..core import policy
from ..format import constants as C
from ..ops.codecs import blosclz as _blosclz
from ..ops.codecs import lz4 as _lz4
from ..ops.codecs import snappy as _snappy
from ..ops.codecs import zlib_ as _zlibw
from ..ops.codecs import zstd_ as _zstdw


@dataclass(frozen=True)
class Codec:
    """One compressor: its codes, its library and its split calls."""

    code: int
    name: str
    libcode: int
    libname: str
    library_version: str
    compress: Callable    # (data, maxout, clevel, split) -> bytes, b"" = incompressible
    decompress: Callable  # (data, maxout) -> bytes, raises on malformed input
    available: Callable[[], bool] = field(default=lambda: True)


def _blosclz_c(data, maxout, clevel, split):
    return _blosclz.compress(clevel, data, maxout, split)


def _lz4_c(data, maxout, clevel, split):
    return _lz4.compress(data, maxout, policy.get_accel(C.LZ4, clevel))


def _lz4hc_c(data, maxout, clevel, split):
    return _lz4.compress_hc(data, maxout, clevel)


def _snappy_c(data, maxout, clevel, split):
    return _snappy.compress(data, maxout)


def _zlib_c(data, maxout, clevel, split):
    return _zlibw.compress(data, maxout, clevel)


def _zstd_c(data, maxout, clevel, split):
    return _zstdw.compress(data, maxout, clevel)


_REGISTRY: dict[int, Codec] = {}


def register(codec: Codec) -> None:
    _REGISTRY[codec.code] = codec


def get(compcode: int) -> Codec:
    try:
        codec = _REGISTRY[compcode]
    except KeyError:
        raise ValueError(f"unknown compressor code {compcode}")
    if not codec.available():
        raise RuntimeError(
            f"codec '{codec.name}' is not available in this build")
    return codec


def get_by_name(name: str) -> Codec:
    code = C.COMPCODES.get(name)
    if code is None:
        raise ValueError(f"unknown compressor '{name}'")
    return get(code)


def list_compressors() -> list[str]:
    """Names of the available codecs (blosc_list_compressors)."""
    return [c.name for c in sorted(_REGISTRY.values(), key=lambda c: c.code)
            if c.available()]


def complib_info(compname: str) -> tuple[str, str]:
    """(library name, library version) of a codec name
    (blosc_get_complib_info, blosc.c:2052-2109)."""
    codec = get_by_name(compname)
    return codec.libname, codec.library_version


register(Codec(
    code=C.BLOSCLZ, name="blosclz", libcode=C.BLOSCLZ_LIB,
    libname=C.LIBNAMES[C.BLOSCLZ_LIB], library_version="2.1.0-tpu",
    compress=_blosclz_c, decompress=_blosclz.decompress,
))
register(Codec(
    code=C.LZ4, name="lz4", libcode=C.LZ4_LIB,
    libname=C.LIBNAMES[C.LZ4_LIB], library_version="1.10.0-tpu",
    compress=_lz4_c, decompress=_lz4.decompress,
))
register(Codec(
    code=C.LZ4HC, name="lz4hc", libcode=C.LZ4_LIB,
    libname=C.LIBNAMES[C.LZ4_LIB], library_version="1.10.0-tpu",
    compress=_lz4hc_c, decompress=_lz4.decompress,
))
register(Codec(
    code=C.SNAPPY, name="snappy", libcode=C.SNAPPY_LIB,
    libname=C.LIBNAMES[C.SNAPPY_LIB], library_version="1.1.1-tpu",
    compress=_snappy_c, decompress=_snappy.decompress,
))
register(Codec(
    code=C.ZLIB, name="zlib", libcode=C.ZLIB_LIB,
    libname=C.LIBNAMES[C.ZLIB_LIB], library_version=_zlib.ZLIB_VERSION,
    compress=_zlib_c, decompress=_zlibw.decompress,
))
register(Codec(
    code=C.ZSTD, name="zstd", libcode=C.ZSTD_LIB,
    libname=C.LIBNAMES[C.ZSTD_LIB],
    library_version=".".join(map(str, _zstdw.LIBRARY_VERSION)),
    compress=_zstd_c, decompress=_zstdw.decompress,
    available=lambda: _zstdw.AVAILABLE,
))
