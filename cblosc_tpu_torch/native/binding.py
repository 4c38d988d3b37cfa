"""Build, load and bind the native C++ host engine (``native/src``).

The port's own copy of the JAX package's host engine: a persistent
worker pool, the filters, blosclz, LZ4/LZ4HC and snappy in C++, zlib
through the system library and zstd through the libzstd the numpy
engine loads (``ops/codecs/zstd_.py``), so both engines write the same
bytes. It computes what ``core/engine.py`` computes, chunk for chunk,
hundreds of times faster on the entropy coders (``core/backend.py``
routes to it first).

The sources compile with ``g++`` on first use into
``build/torch_native/<hash>/`` under the checkout, where the hash covers
the sources, the flags and the host CPU's model and feature flags (the
build uses ``-march=native``): an unchanged tree on the same CPU reuses
its build.
The build runs under a file lock and lands by ``os.replace``, so
processes that start together build once. A failed build raises with
the compiler's output.

The chunk entry points take the JAX binding's signatures and return
None where it does (a codec not compiled in, a compress the engine
cannot finish), and the caller takes the numpy engine; a corrupt chunk
raises FormatError. ``_lock`` serializes the C calls (the reference's
global_comp_mutex); the engine's pool runs the blocks of one call.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

from ..format import constants as C
from ..format.header import ChunkHeader, FormatError, validate_header
from ..ops.codecs import zstd_

SRC = Path(__file__).resolve().parent / "src"
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "torch_native"
CXX = "g++"
SOURCES = ("filters.cc", "blosclz.cc", "lz4.cc", "codecs_ext.cc", "engine.cc")
CXX_FLAGS = ("-O3", "-march=native", "-std=c++17", "-fPIC", "-shared",
             "-pthread", "-Wall")

_lock = threading.RLock()
_lib = None

_NATIVE_CODECS = {C.BLOSCLZ, C.LZ4, C.LZ4HC, C.SNAPPY, C.ZLIB, C.ZSTD}


def _optional_flags() -> tuple[list[str], list[str]]:
    """(defines, libraries): zlib where its header is found (else the
    engine declines zlib, code -2), dlopen for zstd on POSIX."""
    defines, libs = [], []
    if any(os.path.exists(os.path.join(d, "zlib.h"))
           for d in ("/usr/include", "/usr/local/include")):
        defines.append("-DCBT_HAVE_ZLIB")
        libs.append("-lz")
    if os.name == "posix":
        defines.append("-DCBT_HAVE_DLOPEN")
        libs.append("-ldl")
    return defines, libs


def _cpu_id() -> str:
    """The host CPU's model name and feature flags (what -march=native
    compiles for), or the machine name where /proc/cpuinfo is absent."""
    found = {}
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                key, _, value = line.partition(":")
                key = key.strip()
                if key in ("model name", "flags") and key not in found:
                    found[key] = value.strip()
                if len(found) == 2:
                    break
    except OSError:
        pass
    return " | ".join(found.values()) or os.uname().machine


def _digest(flags: list[str]) -> str:
    h = hashlib.sha256(" ".join(flags).encode())
    h.update(_cpu_id().encode())
    for f in sorted(SRC.iterdir()):
        if f.suffix in (".cc", ".h"):
            h.update(f.name.encode())
            h.update(f.read_bytes())
    return h.hexdigest()[:16]


def build(root=BUILD_ROOT, cxx: str = CXX) -> Path:
    """Compile the engine unless ``root/<hash>/`` already holds it;
    returns the shared library's path. Raises RuntimeError with the
    compiler's output when the build fails."""
    defines, libs = _optional_flags()
    flags = [*CXX_FLAGS, *defines]
    out_dir = Path(root) / _digest(flags + libs)
    so = out_dir / "libcblosc_tpu_torch_native.so"
    if so.exists():
        return so
    out_dir.mkdir(parents=True, exist_ok=True)
    with open(out_dir / "lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)    # released when the file closes
        if so.exists():                     # another process built it
            return so
        tmp = so.with_suffix(f".{os.getpid()}.tmp")
        cmd = [cxx, *flags, "-o", str(tmp), *(str(SRC / s) for s in SOURCES),
               *libs]
        try:
            res = subprocess.run(cmd, capture_output=True, text=True,
                                 timeout=300)
        except (OSError, subprocess.TimeoutExpired) as e:
            raise RuntimeError(f"native engine build failed: {' '.join(cmd)}"
                               f"\n{e}") from e
        if res.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"native engine build failed: {' '.join(cmd)}"
                               f"\n{res.stdout}{res.stderr}")
        os.replace(tmp, so)
    return so


def _bind(lib) -> None:
    u8p = ctypes.POINTER(ctypes.c_uint8)
    i64 = ctypes.c_int64
    i32 = ctypes.c_int
    sigs = {
        "cbt_compress_chunk": (i64, [i32, i32, i32, u8p, i64, u8p, i64, i32,
                                     i64, i32, i32]),
        "cbt_decompress_chunk": (i64, [u8p, i64, u8p, i64, i32]),
        "cbt_getitem": (i64, [u8p, i64, i64, i64, u8p, i64]),
        "cbt_free_resources": (None, []),
        "cbt_after_fork_in_child": (None, []),
        "cbt_set_zstd_path": (None, [ctypes.c_char_p]),
        "cbt_shuffle": (None, [i32, i64, u8p, u8p]),
        "cbt_unshuffle": (None, [i32, i64, u8p, u8p]),
        "cbt_bitshuffle": (None, [i32, i64, u8p, u8p, u8p]),
        "cbt_bitunshuffle": (None, [i32, i64, u8p, u8p, u8p]),
        "cbt_blosclz_compress": (i32, [i32, u8p, i32, u8p, i32, i32]),
        "cbt_blosclz_decompress": (i32, [u8p, i32, u8p, i32]),
        "cbt_lz4_compress": (i32, [u8p, i32, u8p, i32, i32]),
        "cbt_lz4hc_compress": (i32, [u8p, i32, u8p, i32, i32]),
        "cbt_lz4_decompress": (i32, [u8p, i32, u8p, i32]),
    }
    for name, (restype, argtypes) in sigs.items():
        fn = getattr(lib, name)
        fn.restype = restype
        fn.argtypes = argtypes


def load():
    """The bound engine, built on first use."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            _bind(lib)
            # before any zstd call: the library the numpy engine loaded
            lib.cbt_set_zstd_path((zstd_._lib_path() or "").encode())
            _lib = lib
        return _lib


def after_fork_in_child() -> None:
    """A forked child's reset: a new lock, and the engine's pool drops
    the parent's workers (they do not exist in the child)."""
    global _lock
    _lock = threading.RLock()
    if _lib is not None:
        _lib.cbt_after_fork_in_child()


def _u8(buf) -> np.ndarray:
    return np.frombuffer(buf, dtype=np.uint8)


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def compress_chunk(ctx, data: bytes) -> bytes | None:
    """The chunk, b"" (incompressible within destsize), or None for the
    numpy engine (a codec not compiled in)."""
    if ctx.compcode not in _NATIVE_CODECS:
        return None
    lib = load()
    src = _u8(data)
    dest = np.empty(ctx.destsize, dtype=np.uint8)
    with _lock:
        n = lib.cbt_compress_chunk(
            ctx.clevel, ctx.doshuffle, ctx.typesize, _ptr(src), len(data),
            _ptr(dest), ctx.destsize, ctx.compcode,
            ctx.blocksize, int(ctx.dont_split), ctx.nthreads,
        )
    if n < 0:
        return None
    if n == 0:
        return b""
    return dest[:n].tobytes()


def decompress_chunk(chunk: bytes, destsize: int | None,
                     nthreads: int) -> bytes | None:
    """The chunk's bytes, or None for the numpy engine; raises
    FormatError on a corrupt chunk."""
    if len(chunk) < 16:
        return None
    lib = load()
    hdr = ChunkHeader.decode(chunk)
    if destsize is None:
        destsize = hdr.nbytes
    validate_header(hdr, destsize)      # the Python side's rich errors
    if hdr.nbytes == 0:
        return b""
    if not hdr.memcpyed and hdr.compcode not in _NATIVE_CODECS:
        return None
    src = _u8(chunk)
    dest = np.empty(hdr.nbytes, dtype=np.uint8)
    with _lock:
        n = lib.cbt_decompress_chunk(_ptr(src), len(chunk), _ptr(dest),
                                     hdr.nbytes, nthreads)
    if n == -2:
        return None                     # codec not compiled in
    if n < 0:
        raise FormatError(f"native decompression failed (code {n})")
    return dest[:n].tobytes()


def getitem(chunk: bytes, start: int, nitems: int) -> bytes | None:
    """Items [start, start+nitems) of a chunk (blosc_getitem,
    blosc.c:1574-1703), single-threaded as the reference's is; None for
    the numpy engine."""
    if len(chunk) < 16:
        return None
    lib = load()
    hdr = ChunkHeader.decode(chunk)
    if not hdr.memcpyed and hdr.compcode not in _NATIVE_CODECS:
        return None
    ts = hdr.typesize if hdr.typesize else 1
    stop = start + nitems
    if start < 0 or nitems < 0 or stop * ts > hdr.nbytes:
        raise IndexError("getitem range out of bounds")
    src = _u8(chunk)
    dest = np.empty(max(nitems * ts, 1), dtype=np.uint8)
    with _lock:
        n = lib.cbt_getitem(_ptr(src), len(chunk), start, nitems,
                            _ptr(dest), nitems * ts)
    if n == -2:
        return None
    if n < 0:
        raise FormatError(f"native getitem failed (code {n})")
    return dest[:n].tobytes()


def free_resources() -> None:
    """Stop the engine's worker pool (it restarts on the next call)."""
    with _lock:
        if _lib is not None:
            _lib.cbt_free_resources()


# --- raw kernels (tests) ----------------------------------------------------

def _filter(name: str, typesize: int, data, scratch: bool) -> np.ndarray:
    fn = getattr(load(), name)
    src = _u8(data)
    out = np.empty(src.size, dtype=np.uint8)
    if scratch:
        fn(typesize, src.size, _ptr(src), _ptr(out),
           _ptr(np.empty(src.size, dtype=np.uint8)))
    else:
        fn(typesize, src.size, _ptr(src), _ptr(out))
    return out


def shuffle(typesize: int, data) -> np.ndarray:
    return _filter("cbt_shuffle", typesize, data, False)


def unshuffle(typesize: int, data) -> np.ndarray:
    return _filter("cbt_unshuffle", typesize, data, False)


def bitshuffle(typesize: int, data) -> np.ndarray:
    return _filter("cbt_bitshuffle", typesize, data, True)


def bitunshuffle(typesize: int, data) -> np.ndarray:
    return _filter("cbt_bitunshuffle", typesize, data, True)


def _encoded(out: np.ndarray, n: int) -> bytes:
    return out[:n].tobytes() if n > 0 else b""


def _decode(fn, data, maxout: int, what: str) -> bytes:
    src = _u8(data)
    out = np.empty(max(maxout, 1), dtype=np.uint8)
    n = fn(_ptr(src), src.size, _ptr(out), maxout)
    if n < 0:
        raise ValueError(f"malformed {what} stream")
    return out[:n].tobytes()


def blosclz_compress(clevel: int, data, maxout: int, split: bool) -> bytes:
    src = _u8(data)
    out = np.empty(max(maxout, 1), dtype=np.uint8)
    return _encoded(out, load().cbt_blosclz_compress(
        clevel, _ptr(src), src.size, _ptr(out), maxout, int(split)))


def blosclz_decompress(data, maxout: int) -> bytes:
    return _decode(load().cbt_blosclz_decompress, data, maxout, "blosclz")


def lz4_compress(data, maxout: int, accel: int = 1) -> bytes:
    src = _u8(data)
    out = np.empty(max(maxout, 1), dtype=np.uint8)
    return _encoded(out, load().cbt_lz4_compress(
        _ptr(src), src.size, _ptr(out), maxout, accel))


def lz4hc_compress(data, maxout: int, clevel: int = 9) -> bytes:
    src = _u8(data)
    out = np.empty(max(maxout, 1), dtype=np.uint8)
    return _encoded(out, load().cbt_lz4hc_compress(
        _ptr(src), src.size, _ptr(out), maxout, clevel))


def lz4_decompress(data, maxout: int) -> bytes:
    return _decode(load().cbt_lz4_decompress, data, maxout, "lz4")
