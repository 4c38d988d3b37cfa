"""Build, load and call the frozen C-blosc-format writer (``writer/``).

Every ``.cc`` source of ``writer/`` compiles with ``g++`` on first use
into ``build/portbench_writer/<hash>/`` under the checkout, where the
hash covers the sources, the flags and the link flags, so only a
checkout's first run builds. A source that needs a system library names
it on a line of its own, ``// portbench-writer-link: <flags>``. The
codecs and filters are those the sources register (``writer/registry.h``),
by the configuration's names. The build runs under a file lock and lands
by ``os.replace``, so runs that start together build once. It imports
nothing of the program.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import subprocess
from pathlib import Path

import numpy as np

SRC = Path(__file__).resolve().parent / "writer"
BUILD_ROOT = Path(__file__).resolve().parents[1] / "build" / "portbench_writer"
CXX_FLAGS = ("-O2", "-std=c++17", "-fPIC", "-shared", "-Wall")
LINK_MARK = "// portbench-writer-link:"

_lib = None


def sources() -> list[Path]:
    return sorted(SRC.glob("*.cc"))


def link_flags() -> list[str]:
    """What the sources ask to be linked against, in source order."""
    flags = []
    for f in sources():
        for line in f.read_text().splitlines():
            if line.startswith(LINK_MARK):
                flags += line[len(LINK_MARK):].split()
    return flags


def _digest() -> str:
    h = hashlib.sha256(" ".join(CXX_FLAGS + tuple(link_flags())).encode())
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
               *(str(s) for s in sources()), *link_flags()]
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
            ctypes.c_int, ctypes.c_char_p, ctypes.c_int, u8p, ctypes.c_int64,
            u8p, ctypes.c_int64, ctypes.c_char_p]
        for names in (lib.pbw_codec_names, lib.pbw_filter_names):
            names.restype = ctypes.c_char_p
            names.argtypes = []
        _lib = lib
    return _lib


def codecs() -> set[str]:
    """The cnames the writer's sources register."""
    return set(_load().pbw_codec_names().decode().split(","))


def filters() -> set[str]:
    """The shuffle names the writer's sources register."""
    return set(_load().pbw_filter_names().decode().split(","))


def compress(clevel: int, shuffle: str, typesize: int, data: bytes,
             cname: str) -> bytes:
    """The chunk c-blosc's ``blosc_compress`` writes for these arguments
    with its automatic blocksize (numcodecs' ``Blosc(blocksize=0)``)."""
    lib = _load()
    src = np.frombuffer(data, dtype=np.uint8)
    dest = np.empty(src.size + 16, dtype=np.uint8)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    n = lib.pbw_compress_chunk(
        clevel, shuffle.encode(), typesize, src.ctypes.data_as(u8p),
        src.size, dest.ctypes.data_as(u8p), dest.size, cname.encode())
    if n == -2:
        raise ValueError(f"the writer holds no codec {cname!r}: it holds "
                         f"{sorted(codecs())}")
    if n == -3:
        raise ValueError(f"the writer holds no filter {shuffle!r}: it "
                         f"holds {sorted(filters())}")
    if n <= 0:
        raise RuntimeError(f"writer failed (code {n})")
    return dest[:n].tobytes()
