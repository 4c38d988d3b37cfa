"""PyTorch port's getitem vs the JAX package: for every chunk and range,
the port's api.getitem(device="cpu"), its device layer
gpu.host_api.getitem (None included) and its host engine copy
core.engine.getitem equal cblosc_tpu.core.engine.getitem and the input
slice, and the device layer returns None exactly where the JAX bridge
does. cblosc_tpu.tpu.host_api.getitem runs where it returns before any
device work and on three decoding ranges (two XLA compiles). Errors
are raised with the same exception types. All exact.

Chunks: blosclz at clevels 1 and 5, lz4 and lz4hc at clevel 5 (written
by the port on the CPU, equal to JAX's), snappy, zlib and zstd (host
engine), shuffle and bitshuffle, typesizes 4 and 8: a 72,000-byte
buffer in the device's geometry (blosclz at clevel 1: 64 and 32 KB
blocks), the others of a 36,000-byte buffer with a forced 8 KB
blocksize (four full blocks), all with a leftover block; a memcpyed chunk (clevel 0) and an empty
one.

Deliberate difference, not exercised here: the port's walks accept a
superset of the JAX walks' rows (ROADMAP §3), so on a chunk that only
the port's walk accepts (the zstd rows with a long zero run of counts)
the port's device getitem returns bytes where JAX's returns None; both
APIs then return the same bytes."""

import numpy as np
import pytest

import cblosc_tpu as jb
from cblosc_tpu.core import engine as jeng
from cblosc_tpu.format import constants as C
from cblosc_tpu.format.header import FormatError as JFormatError
from cblosc_tpu.ops.codecs import zstd_ as jzstd
from cblosc_tpu.tpu import host_api as jh
from cblosc_tpu.utils.timing import synth
import cblosc_tpu_torch as tb
from cblosc_tpu_torch.core import engine as teng
from cblosc_tpu_torch.format.header import ChunkHeader, FormatError
from cblosc_tpu_torch.gpu import host_api as th
from conftest import make_buffer
from test_torch_common import cuda  # noqa: F401

N = 72_000          # the buffer of the device-geometry chunks
NF, BS = 36_000, 8192   # and of the forced-blocksize ones: 4 full blocks
NEVER = C.NEVER_SPLIT   # keeps a forced 8 KB blocksize (split codecs widen
                        # theirs to 64 KB and more, blosc.c:1031-1047)

# id -> (compressor, clevel, shuffle, typesize, data kind, forced
# blocksize, splitmode); blocksize 0: the device's default geometry
CASES = {
    "blosclz-1-shuffle-8-synth": ("blosclz", 1, C.SHUFFLE, 8, "synth", 0,
                                  C.FORWARD_COMPAT_SPLIT),
    "blosclz-1-bitshuffle-4-arange": ("blosclz", 1, C.BITSHUFFLE, 4,
                                      "arange", 0, C.FORWARD_COMPAT_SPLIT),
    "blosclz-5-shuffle-4-arange": ("blosclz", 5, C.SHUFFLE, 4, "arange", BS,
                                   NEVER),
    "blosclz-5-shuffle-8-synth": ("blosclz", 5, C.SHUFFLE, 8, "synth", BS,
                                  NEVER),
    "lz4-5-shuffle-8-synth": ("lz4", 5, C.SHUFFLE, 8, "synth", BS, NEVER),
    "lz4hc-5-bitshuffle-4-lowentropy": ("lz4hc", 5, C.BITSHUFFLE, 4,
                                        "lowentropy", BS, NEVER),
    "snappy-5-shuffle-8-synth": ("snappy", 5, C.SHUFFLE, 8, "synth", BS,
                                 NEVER),
    "zlib-5-shuffle-4-arange": ("zlib", 5, C.SHUFFLE, 4, "arange", BS, NEVER),
    "zstd-5-bitshuffle-8-synth": ("zstd", 5, C.BITSHUFFLE, 8, "synth", BS,
                                  C.FORWARD_COMPAT_SPLIT),
    "memcpyed-0-shuffle-4-arange": ("blosclz", 0, C.SHUFFLE, 4, "arange", BS,
                                    NEVER),
}
RANGES = ("first100", "boundary", "last_into_leftover", "empty_at_boundary",
          "whole")


def _data(kind: str, n: int = N) -> bytes:
    if kind == "synth":
        return synth(n, 8, 19).tobytes()
    if kind == "arange":
        return np.arange(n // 4, dtype=np.int32).tobytes()
    return make_buffer(np.random.default_rng(5), n, 4, kind)


@pytest.fixture(scope="module")
def chunks():
    """id -> (data, chunk written by the port on the CPU)."""
    out = {}
    for cid, (comp, clevel, shuffle, ts, kind, bs, split) in CASES.items():
        if comp == "zstd" and not jzstd.AVAILABLE:
            continue
        data = _data(kind, NF if bs else N)
        out[cid] = data, tb.compress_ctx(clevel, shuffle, ts, data,
                                         compressor=comp, blocksize=bs,
                                         splitmode=split, device="cpu")
    return out


def _range(which: str, hdr: ChunkHeader) -> tuple[int, int]:
    ts, bs, n = hdr.typesize, hdr.blocksize, hdr.nbytes
    items = n // ts
    if which == "first100":
        return 0, 100
    if which == "boundary":             # 100 items across the first boundary
        return bs // ts - 50, 100
    if which == "last_into_leftover":   # from the last full block on
        nfull = n // bs
        start = (nfull * bs) // ts - 30
        return start, items - start
    if which == "empty_at_boundary":
        return bs // ts, 0
    return 0, items


def _jax_declines(hdr: ChunkHeader, start: int, nitems: int) -> bool:
    """Where cblosc_tpu.tpu.host_api.getitem returns None before any
    device work (tpu/host_api.py:187-218)."""
    if hdr.memcpyed or hdr.nbytes == 0:
        return True
    b0 = (start * hdr.typesize) // hdr.blocksize
    b1 = min(-(-((start + nitems) * hdr.typesize) // hdr.blocksize),
             hdr.nblocks)
    nfull = hdr.nblocks - (1 if hdr.leftover else 0)
    return min(b1, nfull) <= b0


@pytest.mark.parametrize("which", RANGES)
@pytest.mark.parametrize("cid", list(CASES))
def test_getitem_matches_jax_and_slice(chunks, cid, which):
    if cid not in chunks:
        pytest.skip("libzstd absent")
    data, chunk = chunks[cid]
    hdr = ChunkHeader.decode(chunk)
    start, nitems = _range(which, hdr)
    ts = hdr.typesize
    want = data[start * ts:(start + nitems) * ts]
    assert jeng.getitem(chunk, start, nitems) == want
    assert teng.getitem(chunk, start, nitems) == want
    assert tb.getitem(chunk, start, nitems, device="cpu") == want
    dev = th.getitem(chunk, start, nitems, "cpu")
    if _jax_declines(hdr, start, nitems):
        assert dev is None
        assert jh.getitem(chunk, start, nitems) is None
    else:
        assert dev == want


def test_cases_cover_the_geometry(chunks):
    """Every chunk but the memcpyed one has at least one full block and a
    leftover, and the forced blocksizes hold; so the boundary and
    leftover ranges are what their names say."""
    for cid, (_, _, _, _, _, bs, _) in CASES.items():
        if cid not in chunks:
            continue
        hdr = ChunkHeader.decode(chunks[cid][1])
        assert hdr.memcpyed == cid.startswith("memcpyed"), cid
        assert hdr.leftover == hdr.nbytes % hdr.blocksize > 0, cid
        assert hdr.blocksize == (bs or hdr.blocksize), cid
    geo = {cid: ChunkHeader.decode(c).nblocks for cid, (_, c) in chunks.items()}
    assert geo["blosclz-1-shuffle-8-synth"] == 2          # 64 KB blocks
    assert geo["blosclz-1-bitshuffle-4-arange"] == 3      # 32 KB blocks
    assert geo["lz4-5-shuffle-8-synth"] == 5              # 8 KB blocks


@pytest.mark.parametrize("cid,which", [
    ("blosclz-1-bitshuffle-4-arange", "first100"),
    ("blosclz-1-bitshuffle-4-arange", "last_into_leftover"),
    ("lz4-1-shuffle-4-arange", "boundary"),
])
def test_device_getitem_matches_jax_bridge(chunks, cid, which):
    """The two bridges on ranges they decode on the device. (The JAX LZ4
    walk rejects the unsplit 8 KB synth rows of the lz4 case above, which
    the port's walk accepts: ROADMAP §3; so the LZ4 case here is a split
    chunk.)"""
    if cid in chunks:
        data, chunk = chunks[cid]
    else:
        data = _data("arange")
        chunk = tb.compress_ctx(1, C.SHUFFLE, 4, data, compressor="lz4",
                                device="cpu")
    start, nitems = _range(which, ChunkHeader.decode(chunk))
    want = jh.getitem(chunk, start, nitems)
    assert want is not None
    assert th.getitem(chunk, start, nitems, "cpu") == want


@pytest.mark.parametrize("cid", list(CASES))
def test_decompress_ctx_unchanged(chunks, cid):
    """decompress_ctx shares its device decode with getitem: the whole
    chunk still decodes to the input, through the device path where the
    chunk is not memcpyed."""
    if cid not in chunks:
        pytest.skip("libzstd absent")
    data, chunk = chunks[cid]
    assert tb.decompress_ctx(chunk, device="cpu") == data
    dev = th.decompress_chunk(chunk, None, "cpu")
    assert dev == (None if cid.startswith("memcpyed") else data)
    assert jeng.decompress_chunk(chunk) == data


def test_empty_chunk():
    chunk = tb.compress_ctx(1, C.SHUFFLE, 4, b"", device="cpu")
    assert th.getitem(chunk, 0, 0, "cpu") is None
    assert jh.getitem(chunk, 0, 0) is None
    assert tb.getitem(chunk, 0, 0, device="cpu") == b""
    assert teng.getitem(chunk, 0, 0) == jeng.getitem(chunk, 0, 0) == b""
    for fn in (lambda: tb.getitem(chunk, 0, 1, device="cpu"),
               lambda: teng.getitem(chunk, 0, 1),
               lambda: jeng.getitem(chunk, 0, 1)):
        with pytest.raises(IndexError):
            fn()


def _raises(fn):
    try:
        return fn()
    except Exception as e:      # the outcome is the exception's type
        return type(e)


@pytest.mark.parametrize("cid", ["blosclz-1-bitshuffle-4-arange",
                                 "memcpyed-0-shuffle-4-arange"])
@pytest.mark.parametrize("bad", ["start", "stop", "nitems"])
def test_out_of_bounds(chunks, cid, bad):
    """IndexError in both packages' APIs (the JAX bridge raises before
    any device work); the numpy host engines agree with each other, also
    on a negative nitems, which they read as an empty range. Where the
    bridge declines (memcpyed), each API takes its host-engine router,
    native first, and the two APIs agree (the native engines read a
    negative nitems as out of bounds)."""
    data, chunk = chunks[cid]
    items = N // ChunkHeader.decode(chunk).typesize
    start, nitems = {"start": (-1, 10), "stop": (items - 5, 10),
                     "nitems": (10, -3)}[bad]
    host = _raises(lambda: jeng.getitem(chunk, start, nitems))
    assert _raises(lambda: teng.getitem(chunk, start, nitems)) == host
    api = _raises(lambda: tb.getitem(chunk, start, nitems, device="cpu"))
    if cid.startswith("memcpyed"):
        # the bridge declines: the host-engine router
        assert api == _raises(lambda: jb.getitem(chunk, start, nitems,
                                                 backend="tpu"))
    else:
        assert api is IndexError
        assert _raises(lambda: jh.getitem(chunk, start, nitems)) is IndexError
        assert _raises(lambda: th.getitem(chunk, start, nitems, "cpu")) \
            is IndexError
    if bad != "nitems":
        assert host is IndexError


def test_corrupt_blosclz_chunk_raises_format_error(chunks):
    """One literal, then a match reaching 100 bytes before the output's
    start, in the first split: each package's FormatError from its
    device layer and its host engine, and from the port's API."""
    data, chunk = chunks["blosclz-1-bitshuffle-4-arange"]
    hdr = ChunkHeader.decode(chunk)
    s0 = 16 + 4 * hdr.nblocks + 4
    chunk = bytearray(chunk)
    chunk[s0:s0 + 4] = bytes([0x20, 0x11, 0x20, 99])
    chunk = bytes(chunk)
    for err, fn in ((FormatError, lambda: th.getitem(chunk, 0, 100, "cpu")),
                    (FormatError, lambda: tb.getitem(chunk, 0, 100,
                                                     device="cpu")),
                    (FormatError, lambda: teng.getitem(chunk, 0, 100)),
                    (JFormatError, lambda: jh.getitem(chunk, 0, 100)),
                    (JFormatError, lambda: jeng.getitem(chunk, 0, 100))):
        with pytest.raises(err):
            fn()
    # a range in a later block does not touch the corrupt split
    start = hdr.blocksize // 4 + 7
    assert tb.getitem(chunk, start, 100, device="cpu") == \
        data[start * 4:(start + 100) * 4]


@pytest.mark.cuda
@pytest.mark.parametrize("cid", [c for c in CASES if not c.startswith("mem")])
def test_card_getitem_equals_cpu(chunks, cuda, cid):  # noqa: F811
    """On the card: every range of every chunk, the device layer and the
    API equal the CPU's."""
    if cid not in chunks:
        pytest.skip("libzstd absent")
    data, chunk = chunks[cid]
    hdr = ChunkHeader.decode(chunk)
    for which in RANGES:
        start, nitems = _range(which, hdr)
        assert (th.getitem(chunk, start, nitems, cuda)
                == th.getitem(chunk, start, nitems, "cpu")), which
        assert (tb.getitem(chunk, start, nitems, device=cuda)
                == data[start * hdr.typesize:(start + nitems) * hdr.typesize])
