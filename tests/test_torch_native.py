"""The port's native C++ host engine (cblosc_tpu_torch/native) and its
router (core/backend.py), held against the port's numpy engine
(core/engine.py, ops/) and the JAX package's native engine
(cblosc_tpu/native): raw filters and codecs bit-exact, chunk bytes of
every codec byte-identical three ways and decoded by both of the port's
engines, a layout independent of the thread count, getitem, the
incompressible and corrupt-chunk contracts, the reference's golden
files. The byte API routes its host fallbacks device -> native -> numpy,
as the JAX package's backend="tpu" path does: its chunks equal the JAX
API's while the numpy engine is made to raise. A forked child compresses
on fresh workers, a failed build raises, and the port's engine reads no
knob of the JAX package.

Inputs are made from a seed with numpy, at most 256 KB; the engine
builds once per process (build/torch_native/<hash>/)."""

import ast
import glob
import os
import signal
from pathlib import Path

import numpy as np
import pytest

import cblosc_tpu as jb
from cblosc_tpu.core import engine as jeng
from cblosc_tpu.native import binding as jnat
import cblosc_tpu_torch as tb
from cblosc_tpu_torch.core import backend, engine as teng
from cblosc_tpu_torch.format import constants as C
from cblosc_tpu_torch.format.header import FormatError
from cblosc_tpu_torch.native import binding as tnat
from cblosc_tpu_torch.ops import filters_np as tf
from cblosc_tpu_torch.ops.codecs import blosclz as tlz, lz4 as tl4
from cblosc_tpu_torch.ops.codecs import zstd_ as tzstd
from cblosc_tpu_torch.utils.timing import synth
from conftest import REFERENCE, reference_available

PKG = Path(tb.__file__).resolve().parent
CODECS = ["blosclz", "lz4", "lz4hc", "snappy", "zlib", "zstd"]
HOST_CODECS = ("snappy", "zlib", "zstd")    # no device encoder


def _data(seed: int, n: int = 48_037) -> bytes:
    """synth with every 7th item random: matches of every length, some
    incompressible runs, and a leftover block at most geometries."""
    rng = np.random.default_rng(seed)
    a = synth(n + 8, 8, 19, seed=seed).view(np.uint64).copy()
    a[::7] = rng.integers(0, 1 << 63, a[::7].size, dtype=np.uint64)
    return a.view(np.uint8)[:n].tobytes()


def _skip_absent(cname: str) -> None:
    if cname == "zstd" and not tzstd.AVAILABLE:
        pytest.skip("libzstd absent")


# --- raw filters and codecs -------------------------------------------------

@pytest.mark.parametrize("typesize", [1, 2, 4, 8, 16, 17])
def test_filters_match_numpy_and_jax(typesize):
    data = np.random.default_rng(typesize).integers(
        0, 256, 30_000 + typesize, dtype=np.uint8).tobytes()
    for name in ("shuffle", "unshuffle", "bitshuffle", "bitunshuffle"):
        got = getattr(tnat, name)(typesize, data)
        assert np.array_equal(got, getattr(tf, name)(typesize, data)), name
        assert np.array_equal(got, getattr(jnat, name)(typesize, data)), name


@pytest.mark.parametrize("clevel", [1, 5, 9])
def test_blosclz_lz4_lz4hc_bit_exact(clevel):
    for seed in (1, 2):
        data = _data(seed, 30_000)
        maxout = 2 * len(data) + 66
        for split in (False, True):
            want = tlz.compress(clevel, data, maxout, split)
            assert tnat.blosclz_compress(clevel, data, maxout, split) == want
            assert jnat.blosclz_compress(clevel, data, maxout, split) == want
            if want:                   # b"": does not pay at this clevel
                assert tnat.blosclz_decompress(want, len(data)) == data
        accel = 10 - clevel            # the engine's clevel -> acceleration
        want = tl4.compress(data, maxout, accel)
        assert tnat.lz4_compress(data, maxout, accel) == want
        assert jnat.lz4_compress(data, maxout, accel) == want
        assert tnat.lz4_decompress(want, len(data)) == data
        want = tl4.compress_hc(data, maxout, clevel)
        assert tnat.lz4hc_compress(data, maxout, clevel) == want
        assert jnat.lz4hc_compress(data, maxout, clevel) == want
        assert tnat.lz4_decompress(want, len(data)) == data


def test_malformed_raw_streams_raise():
    with pytest.raises(ValueError):
        tnat.blosclz_decompress(bytes([0x20, 0x11, 0x20, 99]), 100)
    with pytest.raises(ValueError):
        tnat.lz4_decompress(bytes([0x1F, 0x00, 0x40, 0x00]), 100)


# --- chunks -----------------------------------------------------------------

@pytest.mark.parametrize("clevel", [1, 5, 9])
@pytest.mark.parametrize("shuffle", [0, 1, 2])
@pytest.mark.parametrize("cname", CODECS)
def test_chunk_bytes_three_ways(cname, shuffle, clevel):
    """The router's chunk (native) equals the port's numpy engine's and
    the JAX native engine's, and both of the port's engines decode it;
    where the device has no encoder, the byte API's chunk is that chunk
    and equals the JAX API's."""
    _skip_absent(cname)
    data = _data(clevel * 10 + shuffle)
    code = C.COMPCODES[cname]
    ctx = teng.build_context(clevel, shuffle, 8, len(data), len(data) + 16,
                             code)
    jctx = jeng.build_context(clevel, shuffle, 8, len(data), len(data) + 16,
                              code)
    before = dict(backend.CALLS)
    chunk = backend.compress_chunk(ctx, data)
    assert backend.CALLS["native"] == before["native"] + 1
    assert backend.CALLS["numpy"] == before["numpy"]
    assert chunk == teng.compress_chunk(ctx, data)
    assert chunk == jnat.compress_chunk(jctx, data)
    assert tnat.decompress_chunk(chunk, None, 1) == data
    assert teng.decompress_chunk(chunk) == data
    assert backend.decompress_chunk(chunk, None, 2) == data
    if cname in HOST_CODECS:
        api = tb.compress_ctx(clevel, shuffle, 8, data, compressor=cname,
                              device="cpu")
        assert api == chunk
        assert api == jb.compress_ctx(clevel, shuffle, 8, data,
                                      compressor=cname, backend="tpu")


@pytest.mark.parametrize("nthreads", [1, 2, 4])
def test_layout_independent_of_threads(nthreads):
    data = _data(5, 256 << 10)
    for cname in ("blosclz", "snappy"):
        ctx = teng.build_context(5, C.SHUFFLE, 8, len(data), len(data) + 16,
                                 C.COMPCODES[cname], forced_blocksize=16384,
                                 nthreads=nthreads)
        one = teng.build_context(5, C.SHUFFLE, 8, len(data), len(data) + 16,
                                 C.COMPCODES[cname], forced_blocksize=16384)
        chunks = {tnat.compress_chunk(ctx, data) for _ in range(3)}
        assert chunks == {tnat.compress_chunk(one, data)}
        assert tnat.decompress_chunk(chunks.pop(), None, nthreads) == data


@pytest.mark.parametrize("cname", CODECS)
def test_getitem_matches_numpy_engine(cname):
    _skip_absent(cname)
    data = _data(7, 100_004)
    ctx = teng.build_context(6, C.SHUFFLE, 4, len(data), len(data) + 16,
                             C.COMPCODES[cname], forced_blocksize=16384)
    chunk = teng.compress_chunk(ctx, data)
    n = len(data) // 4
    for start, k in ((0, n), (0, 1), (n - 3, 3), (n // 3, n // 2), (5, 0),
                     (4095, 2), (n - 100, 100)):
        want = data[start * 4:(start + k) * 4]
        assert tnat.getitem(chunk, start, k) == want, (start, k)
        assert teng.getitem(chunk, start, k) == want
    memcpyed = teng.compress_chunk(
        teng.build_context(0, 0, 1, 5000, 5016, C.COMPCODES[cname]),
        data[:5000])
    assert tnat.getitem(memcpyed, 100, 400) == data[100:500]
    with pytest.raises(IndexError):
        tnat.getitem(chunk, n - 1, 2)


def test_incompressible_contract():
    data = np.random.default_rng(3).integers(0, 256, 100_000,
                                             dtype=np.uint8).tobytes()
    for destsize, want in ((len(data) + 15, 0), (len(data) + 16,
                                                 len(data) + 16)):
        ctx = teng.build_context(5, 0, 1, len(data), destsize, C.BLOSCLZ)
        out = tnat.compress_chunk(ctx, data)
        assert len(out) == want
        assert out == teng.compress_chunk(ctx, data)


def test_clobbered_bstart_raises_format_error():
    data = _data(9, 65536)
    ctx = teng.build_context(5, C.SHUFFLE, 4, len(data), len(data) + 16,
                             C.LZ4, forced_blocksize=16384)
    chunk = bytearray(tnat.compress_chunk(ctx, data))
    chunk[20] ^= 0xFF
    with pytest.raises(FormatError):
        tnat.decompress_chunk(bytes(chunk), None, 1)
    with pytest.raises(FormatError):
        tnat.getitem(bytes(chunk), 4096, 10)


@pytest.mark.skipif(not reference_available(), reason="reference not mounted")
def test_golden_files():
    expected = np.arange(1000 * 1000, dtype=np.int32).tobytes()
    paths = sorted(
        glob.glob(os.path.join(REFERENCE, "compat", "*blosclz*.cdata"))
        + glob.glob(os.path.join(REFERENCE, "compat", "*lz4*.cdata")))
    assert paths
    for path in paths:
        with open(path, "rb") as f:
            chunk = f.read()
        assert tnat.decompress_chunk(chunk, None, 2) == expected, path


# --- routing through the byte API --------------------------------------------

@pytest.fixture
def numpy_engine_raises(monkeypatch):
    def boom(*a, **k):
        raise AssertionError("the numpy engine was called")

    for name in ("compress_chunk", "decompress_chunk", "getitem"):
        monkeypatch.setattr(teng, name, boom)


def test_api_snappy_takes_native(numpy_engine_raises):
    data = _data(11, 200_000)
    got = tb.compress_ctx(5, C.SHUFFLE, 8, data, compressor="snappy",
                          numinternalthreads=2, device="cpu")
    assert got == jb.compress_ctx(5, C.SHUFFLE, 8, data, compressor="snappy",
                                  backend="tpu")


def test_api_memcpyed_lz4_takes_native(numpy_engine_raises):
    """The LZ4 buffers the byte API hands to the host engine: below
    MIN_BUFFERSIZE and at clevel 0 (memcpyed; the context clamps the
    blocksize to the buffer, so the device takes any other)."""
    for clevel, data in ((5, _data(12, 100)), (0, _data(12, 32 << 10))):
        got = tb.compress_ctx(clevel, C.SHUFFLE, 8, data, compressor="lz4",
                              device="cpu")
        assert got == jb.compress_ctx(clevel, C.SHUFFLE, 8, data,
                                      compressor="lz4", backend="tpu")
        assert tb.decompress_ctx(got, device="cpu") == data
        assert tb.getitem(got, 3, 5, device="cpu") == data[24:64]


def test_api_getitem_takes_native(numpy_engine_raises):
    """A range in the leftover block alone: the device path declines it
    and the host engine serves it, native first."""
    data = _data(13, 100_004)
    ctx = teng.build_context(5, C.SHUFFLE, 4, len(data), len(data) + 16,
                             C.LZ4, forced_blocksize=16384)
    chunk = tnat.compress_chunk(ctx, data)
    start = 6 * 16384 // 4 + 10
    before = backend.CALLS["native"]
    got = tb.getitem(chunk, start, 50, device="cpu")
    assert backend.CALLS["native"] == before + 1
    assert got == data[start * 4:(start + 50) * 4]
    assert got == jb.getitem(chunk, start, 50, backend="tpu")


# --- fork, build, cleanliness -----------------------------------------------

def test_forked_child_compresses_on_fresh_workers():
    """The parent's pool threads do not exist in a forked child; the
    child's calls must start new ones (the JAX package's engine waits for
    the parent's forever): 16 MB in 256 blocks on 4 threads through the
    router, and a snappy chunk through the byte API."""
    if not hasattr(os, "fork"):
        pytest.skip("no fork on this platform")
    data = np.arange(2 << 20, dtype=np.int64).tobytes()     # 16 MB
    ctx = teng.build_context(5, 1, 8, len(data), len(data) + 16, C.LZ4,
                             forced_blocksize=65536, nthreads=4)

    def calls():
        return (backend.compress_chunk(ctx, data),
                tb.compress_ctx(5, 1, 8, data[:1 << 20], compressor="snappy",
                                numinternalthreads=4, blocksize=65536,
                                device="cpu"))

    before = backend.CALLS["native"]
    chunks = calls()
    assert backend.CALLS["native"] == before + 2
    pid = os.fork()
    if pid == 0:
        signal.alarm(20)            # a hung child dies instead of hanging
        ok = False
        try:
            ok = (calls() == chunks
                  and backend.decompress_chunk(chunks[0], None, 4) == data)
        finally:
            os._exit(0 if ok else 1)
    _, status = os.waitpid(pid, 0)
    assert os.waitstatus_to_exitcode(status) == 0


def test_failed_build_raises(tmp_path):
    with pytest.raises(RuntimeError, match="native engine build failed"):
        tnat.build(root=tmp_path, cxx=str(tmp_path / "no-such-compiler"))
    bad = tmp_path / "cxx"
    bad.write_text("#!/bin/sh\necho 'error: no' >&2\nexit 1\n")
    bad.chmod(0o755)
    with pytest.raises(RuntimeError, match="error: no"):
        tnat.build(root=tmp_path, cxx=str(bad))
    assert not list(tmp_path.glob("*/*.so"))


def test_native_package_is_clean():
    """Nothing under native/ imports jax or cblosc_tpu, and no C source
    reads a CBLOSC_TPU_* variable."""
    for path in (PKG / "native").rglob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            names = ([a.name for a in node.names]
                     if isinstance(node, ast.Import) else
                     [node.module or ""] if isinstance(node, ast.ImportFrom)
                     and node.level == 0 else [])
            for name in names:
                assert name.split(".")[0] not in ("jax", "cblosc_tpu"), path
    sources = list((PKG / "native" / "src").iterdir())
    assert {p.suffix for p in sources} == {".cc", ".h"}
    for path in sources:
        text = path.read_text()
        assert "CBLOSC_TPU_" not in text and "getenv" not in text, path
