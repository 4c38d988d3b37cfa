"""PyTorch port's global API vs the JAX package (cblosc_tpu/api.py): the
exported names, every getter and setter with its range errors, the
name/code conversions and library info, and compress under each global
setting and each BLOSC_* variable, which must write the chunk that
cblosc_tpu.compress(..., backend="tpu") writes (the device chunk, or the
host engine's for codecs the device does not encode). BLOSC_WARN,
BLOSC_NOLOCK, destroy, free_resources and fork safety too.

Each test starts and ends with both packages' global state reset and
the BLOSC_* variables unset (monkeypatch), so the file does not depend
on test order."""

import os
import signal

import numpy as np
import pytest

import cblosc_tpu as jb
from cblosc_tpu.format import constants as C
from cblosc_tpu.utils.timing import synth
import cblosc_tpu_torch as tb
from cblosc_tpu_torch.core import engine as teng
from cblosc_tpu_torch.gpu import structured as tstruct
from cblosc_tpu_torch.ops.codecs import zstd_ as tzstd

DATA = synth(144_000, 8, 19).tobytes()   # two 64 KB blocks and a leftover
_ENV = ("BLOSC_CLEVEL", "BLOSC_SHUFFLE", "BLOSC_TYPESIZE", "BLOSC_COMPRESSOR",
        "BLOSC_BLOCKSIZE", "BLOSC_NTHREADS", "BLOSC_SPLITMODE", "BLOSC_NOLOCK",
        "BLOSC_WARN")


@pytest.fixture(autouse=True)
def clean_state(monkeypatch):
    for var in _ENV:
        monkeypatch.delenv(var, raising=False)
    jb.destroy()
    tb.destroy()
    yield
    jb.destroy()
    tb.destroy()


def _state(m) -> tuple:
    return (m.get_nthreads(), m.get_compressor(), m.get_blocksize(),
            m.get_splitmode())


def _compress_both(clevel=1, shuffle=C.SHUFFLE, typesize=8, data=DATA,
                   **kw):
    """(JAX's chunk through backend="tpu", the port's on the CPU)."""
    return (jb.compress(clevel, shuffle, typesize, data, backend="tpu", **kw),
            tb.compress(clevel, shuffle, typesize, data, device="cpu", **kw))


def test_exported_names_match_jax():
    assert set(tb.__all__) == set(jb.__all__)
    for name in ("NOSHUFFLE", "SHUFFLE", "BITSHUFFLE", "BLOSCLZ", "LZ4",
                 "LZ4HC", "SNAPPY", "ZLIB", "ZSTD", "ALWAYS_SPLIT",
                 "NEVER_SPLIT", "AUTO_SPLIT", "FORWARD_COMPAT_SPLIT",
                 "MAX_OVERHEAD", "MAX_BUFFERSIZE", "MAX_TYPESIZE",
                 "MAX_THREADS", "VERSION_STRING"):
        assert getattr(tb, name) == getattr(jb, name), name
    assert tb.__version__ == jb.__version__
    for name in tb.__all__:
        assert callable(getattr(tb, name)) or name == "constants", name


def _outcome(fn):
    try:
        return ("ok", fn())
    except Exception as e:          # the outcome is the exception's type
        return ("raises", type(e).__name__)


@pytest.mark.parametrize("call", [
    ("set_nthreads", 4), ("set_nthreads", 1), ("set_nthreads", 0),
    ("set_nthreads", C.MAX_THREADS), ("set_nthreads", C.MAX_THREADS + 1),
    ("set_compressor", "blosclz"), ("set_compressor", "lz4"),
    ("set_compressor", "lz4hc"), ("set_compressor", "snappy"),
    ("set_compressor", "zlib"), ("set_compressor", "zstd"),
    ("set_compressor", "nosuchcodec"),
    ("set_blocksize", 0), ("set_blocksize", 131072),
    ("set_splitmode", C.ALWAYS_SPLIT), ("set_splitmode", C.NEVER_SPLIT),
    ("set_splitmode", C.AUTO_SPLIT), ("set_splitmode", C.FORWARD_COMPAT_SPLIT),
    ("set_splitmode", 99),
], ids=lambda c: f"{c[0]}-{c[1]}")
def test_setter_and_getters_match_jax(call):
    name, arg = call
    assert _state(tb) == _state(jb)
    assert (_outcome(lambda: getattr(tb, name)(arg))
            == _outcome(lambda: getattr(jb, name)(arg)))
    assert _state(tb) == _state(jb)


def test_conversions_and_library_info_match_jax():
    for code in list(C.COMPNAMES) + [7, -1]:
        assert (_outcome(lambda: tb.compcode_to_compname(code))
                == _outcome(lambda: jb.compcode_to_compname(code)))
    for name in list(C.COMPCODES) + ["bogus", ""]:
        assert tb.compname_to_compcode(name) == jb.compname_to_compcode(name)
        assert (_outcome(lambda: tb.get_complib_info(name))
                == _outcome(lambda: jb.get_complib_info(name)))
    assert tb.list_compressors() == jb.list_compressors()
    assert tb.get_version_string() == jb.get_version_string()


def test_zstd_library_info():
    """The port reads libzstd through its own ctypes wrapper
    (ops/codecs/zstd_.py), the JAX package through its own, which
    prefers a library named by its CBLOSC_TPU_ZSTD_LIB variable; both
    report the version of the library they loaded. Here both load the
    same library, so the strings are equal; where that variable names
    another library, the versions may differ."""
    if not tzstd.AVAILABLE:
        pytest.skip("libzstd absent")
    name, version = tb.get_complib_info("zstd")
    assert name == "Zstd"
    assert version == ".".join(map(str, tzstd.LIBRARY_VERSION))
    assert (name, version) == jb.get_complib_info("zstd")


def test_cbuffer_calls_match_jax():
    chunk = tb.compress_ctx(1, C.SHUFFLE, 8, DATA, device="cpu")
    for name in ("cbuffer_sizes", "cbuffer_metainfo", "cbuffer_versions",
                 "cbuffer_complib", "cbuffer_validate"):
        assert getattr(tb, name)(chunk) == getattr(jb, name)(chunk), name
    with pytest.raises(tb.FormatError):
        tb.cbuffer_validate(chunk + b"\x00")


@pytest.mark.parametrize("codec", ["blosclz", "lz4", "lz4hc", "snappy", "zlib",
                                   "zstd"])
def test_compress_under_set_compressor(codec):
    if codec == "zstd" and not tzstd.AVAILABLE:
        pytest.skip("libzstd absent")
    jb.set_compressor(codec)
    tb.set_compressor(codec)
    want, got = _compress_both()
    assert got == want
    assert tb.cbuffer_complib(got) == C.LIBNAMES[C.COMPFORMATS[
        C.COMPCODES[codec]]]
    assert teng.decompress_chunk(got) == DATA


def test_compress_under_set_blocksize():
    default = tb.compress(1, C.SHUFFLE, 8, DATA, device="cpu")
    jb.set_blocksize(131072)
    tb.set_blocksize(131072)
    want, got = _compress_both()
    assert got == want
    assert tb.cbuffer_sizes(got)[2] != tb.cbuffer_sizes(default)[2]


@pytest.mark.parametrize("mode", [C.ALWAYS_SPLIT, C.NEVER_SPLIT, C.AUTO_SPLIT,
                                  C.FORWARD_COMPAT_SPLIT])
def test_compress_under_set_splitmode(mode):
    jb.set_splitmode(mode)
    tb.set_splitmode(mode)
    want, got = _compress_both()
    assert got == want
    assert teng.decompress_chunk(got) == DATA


@pytest.mark.parametrize("var,value", [
    ("BLOSC_CLEVEL", "0"), ("BLOSC_CLEVEL", "5"), ("BLOSC_CLEVEL", "-2"),
    ("BLOSC_CLEVEL", "x"),
    ("BLOSC_SHUFFLE", "NOSHUFFLE"), ("BLOSC_SHUFFLE", "BITSHUFFLE"),
    ("BLOSC_SHUFFLE", "bogus"),
    ("BLOSC_TYPESIZE", "4"), ("BLOSC_TYPESIZE", "0"),
    ("BLOSC_COMPRESSOR", "lz4"), ("BLOSC_COMPRESSOR", "zlib"),
    ("BLOSC_BLOCKSIZE", "131072"), ("BLOSC_BLOCKSIZE", "x"),
    ("BLOSC_NTHREADS", "4"), ("BLOSC_NTHREADS", "0"),
    ("BLOSC_SPLITMODE", "NEVER"), ("BLOSC_SPLITMODE", "ALWAYS"),
    ("BLOSC_NOLOCK", "1"), ("BLOSC_NOLOCK", ""),
])
def test_compress_under_env(monkeypatch, var, value):
    """Each variable cblosc_tpu/api.py:188-237 (and :320-331) reads, set
    for both packages at once: the same chunk and the same global state
    after the call (values that do not parse or are out of range are
    ignored, as in JAX)."""
    monkeypatch.setenv(var, value)
    want, got = _compress_both()
    assert got == want
    assert _state(tb) == _state(jb)
    assert teng.decompress_chunk(got) == DATA


@pytest.mark.parametrize("var,value", [("BLOSC_SPLITMODE", "NEVER_SPLIT"),
                                       ("BLOSC_COMPRESSOR", "nosuchcodec")])
def test_env_errors_match_jax(monkeypatch, var, value):
    monkeypatch.setenv(var, value)
    with pytest.raises(ValueError):
        jb.compress(1, C.SHUFFLE, 8, DATA, backend="tpu")
    with pytest.raises(ValueError):
        tb.compress(1, C.SHUFFLE, 8, DATA, device="cpu")


def test_nolock_keeps_env_overrides(monkeypatch):
    """BLOSC_CLEVEL still applies under BLOSC_NOLOCK (blosc.c:1320-1408)."""
    monkeypatch.setenv("BLOSC_NOLOCK", "1")
    monkeypatch.setenv("BLOSC_CLEVEL", "0")
    want, got = _compress_both()
    assert got == want
    assert tb.cbuffer_metainfo(got)[1] & C.MEMCPYED


def test_decompress_reads_blosc_nthreads(monkeypatch):
    chunk = tb.compress_ctx(1, C.SHUFFLE, 8, DATA, device="cpu")
    monkeypatch.setenv("BLOSC_NTHREADS", "3")
    assert tb.decompress(chunk, device="cpu") == jb.decompress(chunk) == DATA
    assert tb.get_nthreads() == jb.get_nthreads() == 3
    assert tb.decompress_ctx(chunk, None, 2, device="cpu") == DATA


@pytest.mark.parametrize("level", ["1", "2"])
def test_blosc_warn(monkeypatch, capfd, level):
    """Level 1 warns when the chunk does not fit destsize, level 2 also
    when compression was tried and the chunk was stored memcpyed; the
    lines are JAX's."""
    rand = np.random.default_rng(3).integers(0, 256, 50_000,
                                             dtype=np.uint8).tobytes()
    monkeypatch.setenv("BLOSC_WARN", level)
    calls = [(rand, 100), (rand, None)]
    got = []
    for data, destsize in calls:
        jb.compress_ctx(5, C.SHUFFLE, 8, data, destsize=destsize)
        want = capfd.readouterr().err
        out = tb.compress_ctx(5, C.SHUFFLE, 8, data, destsize=destsize,
                              device="cpu")
        assert capfd.readouterr().err == want
        got.append((len(out), want))
    assert got[0][0] == 0 and "not compressible" in got[0][1]
    assert got[1][0] == len(rand) + C.MAX_OVERHEAD
    assert ("memcpy mode" in got[1][1]) == (level == "2")
    # clevel 0 and tiny buffers are memcpyed by design: no warning
    tb.compress_ctx(0, C.SHUFFLE, 4, b"\x00" * 4096, device="cpu")
    tb.compress_ctx(5, C.SHUFFLE, 4, b"\x01" * 64, device="cpu")
    assert capfd.readouterr().err == ""


def test_blosc_warn_silent_by_default(capfd):
    rand = np.random.default_rng(4).integers(0, 256, 50_000,
                                             dtype=np.uint8).tobytes()
    assert tb.compress_ctx(5, C.SHUFFLE, 8, rand, destsize=100,
                           device="cpu") == b""
    assert capfd.readouterr().err == ""


def test_destroy_resets_and_init():
    tb.set_compressor("zstd" if tzstd.AVAILABLE else "zlib")
    tb.set_nthreads(7)
    tb.set_blocksize(4096)
    tb.set_splitmode(C.NEVER_SPLIT)
    tb.init()
    tb.destroy()
    assert _state(tb) == _state(jb) == (1, "blosclz", 0,
                                        C.FORWARD_COMPAT_SPLIT)
    # every entry point initializes itself (test_noinit.c)
    assert tb.decompress(tb.compress(5, C.SHUFFLE, 4, bytes(1000),
                                     device="cpu"), device="cpu") == bytes(1000)


def test_free_resources_drops_the_port_caches():
    chunk = tb.compress_ctx(1, C.SHUFFLE, 8, DATA, device="cpu")
    assert tb.decompress(chunk, device="cpu") == DATA
    assert tstruct._template_table.cache_info().currsize > 0
    tb.free_resources()
    jb.free_resources()
    assert tstruct._template_table.cache_info().currsize == 0
    assert tb.decompress(chunk, device="cpu") == DATA


def test_fork_safety():
    """Compress, fork, decompress in the child (test_forksafe.c), as
    tests/test_api.py runs it; the child starts from fresh global state
    (os.register_at_fork)."""
    if not hasattr(os, "fork"):
        pytest.skip("no fork on this platform")
    data = bytes(range(256)) * 500
    chunk = tb.compress(5, C.SHUFFLE, 4, data, device="cpu")
    tb.set_compressor("lz4")
    pid = os.fork()
    if pid == 0:
        signal.alarm(120)       # a hung child dies instead of hanging
        ok = (tb.decompress(chunk, device="cpu") == data
              and tb.get_compressor() == "blosclz")
        os._exit(0 if ok else 1)
    _, status = os.waitpid(pid, 0)
    assert os.waitstatus_to_exitcode(status) == 0
    assert tb.get_compressor() == "lz4"
