"""Build, load and count the hand-written CUDA kernels.

Each ``csrc/*.cu`` source compiles with ``nvcc`` into its own shared
library with a plain C interface, loaded through ``ctypes`` (no PyTorch
headers, so a build takes seconds). All sources compile in parallel on
first use, into ``build/torch_kernels/<hash>/`` under the checkout, where
the hash covers the sources and the flags: an unchanged tree reuses its
build, a changed one rebuilds.

Every C entry point launches on the stream it is given and returns
``cudaGetLastError()``; :func:`check` raises on a nonzero code.
``LAUNCHES`` counts launches per kernel: a wrapper adds one where it
launches its kernel, and nowhere else.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# kernel name -> source file
SOURCES = {"expand": "expand.cu", "walk": "walk.cu", "decode_one": "decode.cu",
           "lz4_walk": "lz4_walk.cu", "snappy_walk": "snappy_walk.cu",
           "zlib_walk": "zlib_walk.cu", "zstd_walk": "zstd_walk.cu",
           "mine": "mine.cu"}

LAUNCHES = {name: 0 for name in SOURCES}

_P = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong
# C signatures (argtypes, then restype where it is not int) of each entry
# point, by kernel name; "<kernel>.<what>" names a helper of its library
# the three walks share one signature (structured.launch_walk); the LZ4
# walk adds its look-back scratch, the scratch's bytes and the launch's
# epoch before the stream
_WALK = [_P, _I, _I, _P, _I, _I, _P, _P, _P, _P, _P, _P, _P, _P]
_SIGS = {
    # slots, N, W, kind, arg, dst, len, R, out, out_len, stats, stream
    "expand": ("expand_launch", [_P, _I, _I, _P, _P, _P, _P, _I, _P, _I, _P,
                                 _P]),
    "walk": ("walk_launch", _WALK),
    "decode_one": ("decode_launch", [_P, _I, _I, _P, _I, _P, _P, _P, _P]),
    "lz4_walk": ("lz4_walk_launch",
                 _WALK[:-1] + [_P, _LL, ctypes.c_uint, _P]),
    "snappy_walk": ("snappy_walk_launch", _WALK),
    # the zlib walk also writes the literal tape and its length
    "zlib_walk": ("zlib_walk_launch", _WALK[:6] + [_P, _P] + _WALK[6:]),
    # the zstd walk: slots, N, W, csizes, out_len, E, RC, tape, tlen, kind,
    # arg, dst, len, ok, stats, stream
    "zstd_walk": ("zstd_walk_launch", [_P, _I, _I, _P, _I, _I, _I, _P, _P,
                                       _P, _P, _P, _P, _P, _P, _P]),
    # the miner: s, N, n, d_row, d_row is int64, max_d, scratch, scratch
    # bytes a row, d_m, eq_m, stream
    "mine": ("mine_launch", [_P, _I, _LL, _P, _I, _I, _P, _LL, _P, _P, _P]),
    # bytes of global scratch a row of n bytes needs in the miner
    "mine.scratch_bytes": ("mine_scratch_bytes", [_LL], _LL),
}

_lock = threading.Lock()
_libs: dict = {}
build_log: dict = {}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    cand = shutil.which("nvcc")
    if cand is None and CUDA_HOME:
        cand = os.path.join(CUDA_HOME, "bin", "nvcc")
    if cand is None or not os.path.exists(cand):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return cand


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in sorted(CSRC.iterdir()):
        if f.suffix in (".cu", ".cuh"):
            h.update(f.name.encode())
            h.update(f.read_bytes())
    return h.hexdigest()[:16]


def build_all() -> dict:
    """Compile every kernel source (in parallel) unless the hashed build
    directory already holds them; load and bind them. Returns the dict
    of bound C functions by kernel name."""
    with _lock:
        if _libs:
            return _libs
        out_dir = BUILD_ROOT / _digest()
        out_dir.mkdir(parents=True, exist_ok=True)
        todo = {n: out_dir / f"lib{n}.so" for n in SOURCES}
        procs = {}
        for name, so in todo.items():
            if so.exists():
                continue
            tmp = so.with_suffix(f".{os.getpid()}.tmp")
            cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / SOURCES[name])]
            procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                            stderr=subprocess.STDOUT,
                                            text=True), tmp, so)
        failed = []
        for name, (p, tmp, so) in procs.items():
            log, _ = p.communicate()
            build_log[name] = log
            if p.returncode != 0:
                failed.append(f"{name}:\n{log}")
            else:
                os.replace(tmp, so)
        if failed:
            raise RuntimeError("kernel build failed\n" + "\n".join(failed))
        dlls = {name: ctypes.CDLL(str(so)) for name, so in todo.items()}
        for name, (sym, argtypes, *restype) in _SIGS.items():
            fn = getattr(dlls[name.split(".")[0]], sym)
            fn.argtypes = argtypes
            fn.restype = restype[0] if restype else ctypes.c_int
            _libs[name] = fn
        return _libs


def fn(name: str):
    return build_all()[name]


def stream_ptr(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def check(name: str, code: int) -> None:
    if code != 0:
        raise RuntimeError(f"CUDA kernel '{name}' launch failed: error {code}")
    LAUNCHES[name] += 1


def require(t: torch.Tensor, what: str, dtype, ndim: int) -> None:
    """Raise unless t is a contiguous CUDA tensor of this dtype and rank."""
    if not t.is_cuda:
        raise ValueError(f"{what}: expected a CUDA tensor")
    if t.dtype != dtype or t.dim() != ndim:
        raise ValueError(f"{what}: expected {dtype} with {ndim} dims, got "
                         f"{t.dtype} with {t.dim()}")
    if not t.is_contiguous():
        raise ValueError(f"{what}: expected a contiguous tensor")
