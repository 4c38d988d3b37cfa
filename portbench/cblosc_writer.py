"""Build, load and call the frozen C-blosc-format writer (``writer/``).

The sources compile with ``g++`` on first use into
``build/portbench_writer/<hash>/`` under the checkout, where the hash
covers the sources and the flags, so only a checkout's first run builds.
The build runs under a file lock and lands by ``os.replace``, so runs
that start together build once. It imports nothing of the program.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import subprocess
from pathlib import Path

import numpy as np

from .traffic import SHUFFLES

SRC = Path(__file__).resolve().parent / "writer"
BUILD_ROOT = Path(__file__).resolve().parents[1] / "build" / "portbench_writer"
SOURCES = ("filters.cc", "lz4.cc", "writer.cc")
CXX_FLAGS = ("-O2", "-std=c++17", "-fPIC", "-shared", "-Wall")
CODES = {"lz4": 1, "lz4hc": 2}

_lib = None


def _digest() -> str:
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    for f in sorted(SRC.iterdir()):
        if f.suffix in (".cc", ".h"):
            h.update(f.name.encode())
            h.update(f.read_bytes())
    return h.hexdigest()[:16]


def build(root=BUILD_ROOT) -> Path:
    """The shared library's path, compiled unless ``root/<hash>/`` holds
    it. Raises RuntimeError with the compiler's output on failure."""
    out_dir = Path(root) / _digest()
    so = out_dir / "libpbwriter.so"
    if so.exists():
        return so
    out_dir.mkdir(parents=True, exist_ok=True)
    with open(out_dir / "lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if so.exists():
            return so
        tmp = so.with_suffix(f".{os.getpid()}.tmp")
        cmd = ["g++", *CXX_FLAGS, "-o", str(tmp),
               *(str(SRC / s) for s in SOURCES)]
        res = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
        if res.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"writer build failed: {' '.join(cmd)}\n"
                               f"{res.stdout}{res.stderr}")
        os.replace(tmp, so)
    return so


def _load():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        u8p = ctypes.POINTER(ctypes.c_uint8)
        lib.pbw_compress_chunk.restype = ctypes.c_int64
        lib.pbw_compress_chunk.argtypes = [
            ctypes.c_int, ctypes.c_int, ctypes.c_int, u8p, ctypes.c_int64,
            u8p, ctypes.c_int64, ctypes.c_int]
        _lib = lib
    return _lib


def compress(clevel: int, shuffle: str, typesize: int, data: bytes,
             cname: str) -> bytes:
    """The chunk c-blosc's ``blosc_compress`` writes for these arguments
    with its automatic blocksize (numcodecs' ``Blosc(blocksize=0)``)."""
    lib = _load()
    src = np.frombuffer(data, dtype=np.uint8)
    dest = np.empty(src.size + 16, dtype=np.uint8)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    n = lib.pbw_compress_chunk(
        clevel, SHUFFLES[shuffle], typesize, src.ctypes.data_as(u8p),
        src.size, dest.ctypes.data_as(u8p), dest.size, CODES[cname])
    if n <= 0:
        raise RuntimeError(f"writer failed (code {n})")
    return dest[:n].tobytes()
