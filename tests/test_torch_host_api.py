"""PyTorch port's byte API vs the JAX package: chunks byte-identical to
cblosc_tpu.tpu.host_api.compress_chunk at the speed clevels, and chunks
written by either package (device or host engine) decode in the other."""

import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from cblosc_tpu.core import engine as jeng
from cblosc_tpu.format import constants as C
from cblosc_tpu.tpu import host_api as jh
from cblosc_tpu.utils.timing import synth
import cblosc_tpu_torch as tb
from cblosc_tpu_torch.core import engine as teng
from cblosc_tpu_torch.format.header import FormatError
from conftest import make_buffer
from test_torch_common import cuda  # noqa: F401


def _jax_chunk(clevel, shuffle, typesize, data):
    """What cblosc_tpu's backend='tpu' writes: the device bridge's chunk,
    or the host engine's where the bridge declines (memcpyed)."""
    ctx = jeng.build_context(clevel, shuffle, typesize, len(data),
                             len(data) + C.MAX_OVERHEAD, C.BLOSCLZ)
    out = jh.compress_chunk(ctx, data)
    return jeng.compress_chunk(ctx, data) if out is None else out


_LEFTOVER = np.arange(40_000, dtype=np.int32).tobytes() + b"\x07\x01\x02"


@pytest.mark.parametrize("typesize", [4, 8])
@pytest.mark.parametrize("shuffle", [C.NOSHUFFLE, C.SHUFFLE])
@pytest.mark.parametrize("clevel", [1, 4])
@pytest.mark.parametrize("which", ["leftover", "below_l1"])
def test_chunk_bytes_match_jax(clevel, shuffle, typesize, which):
    data = (_LEFTOVER if which == "leftover"
            else np.arange(4000, dtype=np.int32).tobytes())
    got = tb.compress_ctx(clevel, shuffle, typesize, data, device="cpu")
    assert got == _jax_chunk(clevel, shuffle, typesize, data)
    assert tb.decompress_ctx(got, device="cpu") == data


@pytest.mark.parametrize("typesize", [4, 8])
def test_clevel0_chunk_matches_jax(typesize):
    got = tb.compress_ctx(0, C.SHUFFLE, typesize, _LEFTOVER, device="cpu")
    assert got == _jax_chunk(0, C.SHUFFLE, typesize, _LEFTOVER)
    assert tb.decompress_ctx(got, device="cpu") == _LEFTOVER


@pytest.mark.parametrize("kind", ["ramp", "random", "lowentropy", "zeros",
                                  "synth", "linspace"])
def test_data_kinds_match_jax_and_roundtrip(rng, kind):
    n = 3 * 65536 + 100
    if kind == "synth":
        data = synth(n, 8, 19).tobytes()
    elif kind == "linspace":
        data = np.linspace(-3.0, 3.0, n // 8).tobytes() + b"\x00" * (n % 8)
    else:
        data = make_buffer(rng, n, 8, kind)
    got = tb.compress_ctx(1, C.SHUFFLE, 8, data, device="cpu")
    assert got == _jax_chunk(1, C.SHUFFLE, 8, data)
    assert tb.decompress_ctx(got, device="cpu") == data
    assert jeng.decompress_chunk(got) == data       # the JAX host engine
    assert teng.decompress_chunk(got) == data       # the port's host engine


@pytest.mark.parametrize("clevel", [1, 5, 9])
@pytest.mark.parametrize("kind", ["arange", "lowentropy"])
def test_decodes_jax_device_chunks(rng, clevel, kind):
    """JAX-written chunks, clevel 5/9 included: their mined far-distance
    streams go through the walk and the expand kernel."""
    if kind == "arange":
        data = np.arange(1 << 16, dtype=np.int32).tobytes()
    else:
        data = make_buffer(rng, 1 << 17, 4, "lowentropy")
    chunk = _jax_chunk(clevel, C.SHUFFLE, 4, data)
    assert tb.decompress_ctx(chunk, device="cpu") == data


@pytest.mark.parametrize("clevel", [1, 9])
def test_decodes_jax_host_engine_chunks(rng, clevel):
    data = np.frombuffer(make_buffer(rng, 1 << 16, 1, "lowentropy"),
                         np.uint8).tobytes()
    ctx = jeng.build_context(clevel, C.NOSHUFFLE, 1, len(data),
                             len(data) + 16, C.BLOSCLZ)
    chunk = jeng.compress_chunk(ctx, data)
    assert tb.decompress_ctx(chunk, device="cpu") == data
    # the port's own host engine writes the same chunk
    tctx = teng.build_context(clevel, C.NOSHUFFLE, 1, len(data),
                              len(data) + 16, C.BLOSCLZ)
    assert teng.compress_chunk(tctx, data) == chunk


def test_corrupt_chunk_raises_format_error():
    data = np.arange(1 << 15, dtype=np.int32).tobytes()
    chunk = bytearray(tb.compress_ctx(1, C.SHUFFLE, 4, data, device="cpu"))
    s0 = 16 + 4 * 1 + 4                 # the first split's stream
    # one literal, then a match reaching 100 bytes before the output start
    chunk[s0:s0 + 4] = bytes([0x20, 0x11, 0x20, 99])
    with pytest.raises(FormatError):
        tb.decompress_ctx(bytes(chunk), device="cpu")


def test_refuses_what_is_not_ported():
    """An unknown codec is an error; zstd, ported, round-trips with the
    JAX engine's chunk. (Compress at clevel >= 5 is ported now:
    tests/test_torch_mining.py.)"""
    data = np.arange(1 << 14, dtype=np.int32).tobytes()
    with pytest.raises(ValueError):
        tb.compress_ctx(1, C.SHUFFLE, 4, data, compressor="nope", device="cpu")
    zstd = jeng.compress_chunk(jeng.build_context(
        1, C.SHUFFLE, 4, len(data), len(data) + 16, C.ZSTD), data)
    assert tb.compress_ctx(1, C.SHUFFLE, 4, data, compressor="zstd",
                           device="cpu") == zstd
    assert tb.decompress_ctx(zstd, device="cpu") == data


def test_default_device_is_cuda():
    if torch.cuda.is_available():
        pytest.skip("a card is present: device=None runs on it")
    with pytest.raises(RuntimeError):
        tb.compress(1, C.SHUFFLE, 4, b"\x00" * 4096)
    with pytest.raises(RuntimeError):
        tb.decompress(tb.compress(1, C.SHUFFLE, 4, b"\x00" * 4096,
                                  device="cpu"))


def test_port_imports_no_jax():
    """The port loads neither jax nor cblosc_tpu (run in a fresh
    interpreter: this test process has JAX loaded)."""
    code = textwrap.dedent("""
        import sys
        import numpy as np
        import cblosc_tpu_torch as tb
        d = np.arange(1 << 15, dtype=np.int32).tobytes()
        c = tb.compress_ctx(1, tb.SHUFFLE, 4, d, device="cpu")
        assert tb.decompress_ctx(c, device="cpu") == d
        assert tb.getitem(c, 8000, 300, device="cpu") == d[32000:33200]
        import cblosc_tpu_torch.parallel
        bad = [m for m in sys.modules
               if m == "jax" or m.startswith(("jax.", "cblosc_tpu."))
               or m == "cblosc_tpu"]
        assert not bad, bad
        print("clean")
    """)
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == "clean"


@pytest.mark.cuda
def test_byte_api_on_card(cuda):
    data = np.arange(1 << 18, dtype=np.int32).tobytes()
    c = tb.compress_ctx(1, C.SHUFFLE, 4, data, device=cuda)
    assert c == tb.compress_ctx(1, C.SHUFFLE, 4, data, device="cpu")
    assert tb.decompress_ctx(c, device=cuda) == data
