"""Raw blosclz, LZ4 and snappy streams built token by token from a seed,
and zlib streams from the library's own strategies, for parity checks.

Each stream is written straight in its wire format beside the bytes it
decodes to, so a test or the smoke run can hold a decoder or a walk to
both. blosclz (blosc/blosclz.c:679-789) kinds cover the grammar's
corners:

  near       matches at distances 1..31 (overlapping) and 128..8191
  far        the 31/255 far escape (distances 8192..73727); when the row
             is long enough, the last match reaches exactly 73727 bytes
             back, the oldest byte blosclz can name
  escape     7-escape matches with runs of 8 and 16 or more 255 bytes
  lit32_end  the stream ends with a 32-byte literal exactly at csize

:func:`generated_rows` packs them with error rows: an escape run cut
within 8 bytes of csize (the bytes past csize kept in the row),
one-byte corruptions, and random bytes. :func:`lz4_rows` and
:func:`snappy_rows` do the same for the LZ4 block format and raw snappy
(their kinds are listed there), :func:`zlib_rows` for zlib streams.
:func:`record_rows` writes placement records straight, well formed or
not, for the expand kernel.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

from ..format import constants as C
from ..format.header import ChunkHeader, make_flags

FAR_BASE = 8192
MAX_DIST = 65535 + FAR_BASE      # 73727
KINDS = ("near", "far", "escape", "lit32_end")

# (seed, out_len, row width) of the generated rows the tests and the smoke
# run check: rows narrower than the JAX decoder's 552-byte window, widths
# that are not multiples of 16, escape runs of 8 to 24 bytes of 255, and
# far matches (the 80000-byte rows reach exactly 73727 bytes back). CASES
# stay small enough for the JAX machines on the CPU; CARD_CASES add a row
# longer than the CUDA decoder's 128 KB output ring.
CASES = ((1, 256, 300), (2, 4096, 4099), (3, 20000, 20037), (5, 80000, 40000))
CARD_CASES = CASES + ((7, 300000, 160003),)


def match_bytes(length: int, d: int) -> bytes:
    """Wire bytes of a match of `length` >= 3 at distance 1 <= d <= 73727."""
    far = d >= FAR_BASE
    dhi, dlo = (31, 255) if far else ((d - 1) >> 8, (d - 1) & 255)
    if length <= 8:
        out = bytearray([((length - 2) << 5) | dhi])
    else:
        out = bytearray([(7 << 5) | dhi])
        rem = length - 9
        while rem >= 255:
            out.append(255)
            rem -= 255
        out.append(rem)
    out.append(dlo)
    if far:
        out += bytes([(d - FAR_BASE) >> 8, (d - FAR_BASE) & 255])
    return bytes(out)


class _Writer:
    def __init__(self, rng):
        self.rng = rng
        self.stream = bytearray()
        self.out = bytearray()

    def literal(self, data: bytes) -> None:
        for i in range(0, len(data), 32):
            chunk = data[i:i + 32]
            ctrl = len(chunk) - 1
            if not self.stream:
                ctrl |= 32                       # format marker bit
            self.stream.append(ctrl)
            self.stream += chunk
            self.out += chunk

    def random_literal(self, n: int) -> None:
        self.literal(self.rng.integers(0, 256, n, dtype=np.uint8).tobytes())

    def match(self, length: int, d: int) -> None:
        assert 1 <= d <= len(self.out) and d <= MAX_DIST and length >= 3
        self.stream += match_bytes(length, d)
        start = len(self.out) - d
        for j in range(length):
            self.out.append(self.out[start + j])


def _dist(rng, kind: str, op: int) -> int:
    if kind == "far" and op > FAR_BASE:
        return int(rng.integers(FAR_BASE, min(op, MAX_DIST) + 1))
    if rng.random() < 0.6 or op < 128:
        return int(rng.integers(1, min(op, 31) + 1))
    return int(rng.integers(128, min(op, FAR_BASE - 1) + 1))


def _length(rng, kind: str) -> int:
    if kind == "escape" and rng.random() < 0.5:
        runs = int(rng.choice([8, 9, 16, 17, 24]))
        return 9 + 255 * runs + int(rng.integers(0, 255))
    if rng.random() < 0.7:
        return int(rng.integers(3, 9))
    return int(rng.integers(9, 300))


def build(rng, out_len: int, kind: str):
    """One valid stream of `kind` decoding to out_len >= 64 bytes.
    Returns (stream bytes, decoded bytes)."""
    w = _Writer(rng)
    w.random_literal(int(rng.integers(1, 33)))
    tail = 32 if kind == "lit32_end" else int(rng.integers(1, 33))
    reach = kind == "far" and out_len >= MAX_DIST + 64
    stop = out_len - tail - (12 if reach else 0)
    while len(w.out) < stop:
        room = stop - len(w.out)
        if rng.random() < 0.45 or room < 3:
            w.random_literal(min(room, int(rng.integers(1, 33))))
            continue
        w.match(min(_length(rng, kind), room), _dist(rng, kind, len(w.out)))
    if reach:
        w.random_literal(1)
        w.match(11, MAX_DIST)
    w.random_literal(out_len - len(w.out))
    return bytes(w.stream), bytes(w.out)


def escape_cut(rng, out_len: int):
    """A valid prefix, then a 7-escape token and 16 bytes of 255, with
    csize ending 0..8 bytes past the first group of eight: the escape's
    own `ip + 8 >= csize` error. Returns (row bytes, csize)."""
    w = _Writer(rng)
    w.random_literal(int(rng.integers(1, 33)))
    while len(w.out) < out_len // 2:
        w.match(int(rng.integers(3, 9)), _dist(rng, "near", len(w.out)))
        w.random_literal(int(rng.integers(1, 33)))
    t = len(w.stream)
    row = bytes(w.stream) + bytes([7 << 5]) + b"\xff" * 16 + bytes([4, 0])
    return row, t + 9 + int(rng.integers(0, 9))


def generated_rows(seed: int, out_len: int, width: int, garbage: int = 8):
    """(buf uint8 (N, width), csizes int32 (N,), nvalid): the valid streams
    of every kind first (zero past csize), then escape cuts, one-byte
    corruptions of the valid streams and `garbage` random rows."""
    rng = np.random.default_rng(seed)
    valid = [build(rng, out_len, k)[0] for k in KINDS for _ in range(2)]
    rows = [(s, len(s)) for s in valid]
    for _ in range(2):
        rows.append(escape_cut(rng, out_len))
    for s in valid:
        b = bytearray(s)
        b[int(rng.integers(1, len(b)))] ^= 0x5A
        rows.append((bytes(b), len(b)))
    for i in range(garbage):
        n = int(rng.integers(1, width + 1))
        b = rng.integers(0, 256, n, dtype=np.uint8)
        if i % 2:
            b[::3] = rng.integers(0, 64, b[::3].size)    # small tokens
        rows.append((b.tobytes(), n))
    buf = np.zeros((len(rows), width), np.uint8)
    cs = np.zeros(len(rows), np.int32)
    for i, (r, c) in enumerate(rows):
        if len(r) > width:
            raise ValueError(f"stream of {len(r)} bytes exceeds width {width}")
        buf[i, :len(r)] = np.frombuffer(r, np.uint8)
        cs[i] = c
    return buf, cs, len(valid)


def one_split_chunk(stream: bytes, out_len: int, compcode: int) -> bytes:
    """A conforming chunk of one block and one split (no filter, typesize
    1, DONT_SPLIT) holding a raw stream that decodes to out_len bytes."""
    flags = make_flags(doshuffle=C.NOSHUFFLE, memcpyed=False,
                       dont_split=True, compcode=compcode)
    hdr = ChunkHeader(version=C.VERSION_FORMAT,
                      versionlz=C.FORMAT_VERSIONS[C.COMPFORMATS[compcode]],
                      flags=flags, typesize=1, nbytes=out_len,
                      blocksize=out_len, cbytes=24 + len(stream))
    return hdr.encode() + struct.pack("<ii", 20, len(stream)) + stream


def _pack(rows, width: int):
    buf = np.zeros((len(rows), width), np.uint8)
    cs = np.zeros(len(rows), np.int32)
    for i, (r, c) in enumerate(rows):
        if len(r) > width:
            raise ValueError(f"stream of {len(r)} bytes exceeds width {width}")
        buf[i, :len(r)] = np.frombuffer(r, np.uint8)
        cs[i] = c
    return buf, cs


def _corrupt_and_garbage(rng, valid: list, width: int, garbage: int) -> list:
    """One-byte corruptions of the valid streams (never the first byte),
    then random rows, half of them with small bytes every third place."""
    rows = []
    for v in valid:
        b = bytearray(v)
        b[int(rng.integers(1, len(b)))] ^= 0x5A
        rows.append((bytes(b), len(b)))
    for i in range(garbage):
        n = int(rng.integers(1, width + 1))
        b = rng.integers(0, 256, n, dtype=np.uint8)
        if i % 2:
            b[::3] = rng.integers(0, 64, b[::3].size)
        rows.append((b.tobytes(), n))
    return rows


# ---------------------------------------------------------------------------
# LZ4 block format (blosc/blosc.c:412-440 wrap it)
# ---------------------------------------------------------------------------
#
#   near      matches at offsets 1..64 (overlapping) and up to 4096
#   far       offsets up to 65535; when the row is long enough, one match
#             reaches exactly 65535 bytes back
#   ext       literal and match lengths with runs of 8 to 24 bytes of 255
#             (the walk takes them 8 at a time)
#   zero_lit  matches that follow matches: zero-literal sequences, the
#             way long matches continue
#
# Error rows (lz4_rows): an extension run cut within 8 bytes of csize,
# offset 0, an offset beyond the output so far, and a stream that ends
# on a match (no final literals).

LZ4_KINDS = ("near", "far", "ext", "zero_lit")
LZ4_MAX_OFFSET = 65535

# (seed, out_len, row width): rows of 256 B and 8 KB for the CPU tests
# (each out_len is a JAX compile there); the card adds 64 KB rows and
# 128 KB rows (the split of the ratio clevels) whose far matches reach
# 65535 bytes back
LZ4_CASES = ((21, 256, 300), (22, 8192, 8256))
LZ4_CARD_CASES = LZ4_CASES + ((23, 65536, 60000), (24, 131072, 131136))


def _lz4_len(v: int) -> bytes:
    """255-extension bytes of a length field past its 15 nibble."""
    out = bytearray()
    while v >= 255:
        out.append(255)
        v -= 255
    out.append(v)
    return bytes(out)


def lz4_sequence(lit: bytes, mlen: int = 0, offset: int = 0) -> bytes:
    """Wire bytes of one sequence: literals, then a match of mlen >= 4 at
    offset (mlen 0: a literals-only final sequence)."""
    L = len(lit)
    m = mlen - 4 if mlen else 0
    out = bytearray([(min(L, 15) << 4) | min(m, 15)])
    if L >= 15:
        out += _lz4_len(L - 15)
    out += lit
    if mlen:
        out += bytes([offset & 255, offset >> 8])
        if m >= 15:
            out += _lz4_len(m - 15)
    return bytes(out)


class _LZ4Writer:
    def __init__(self, rng):
        self.rng = rng
        self.stream = bytearray()
        self.out = bytearray()

    def seq(self, lit: bytes, mlen: int = 0, offset: int = 0) -> None:
        self.stream += lz4_sequence(lit, mlen, offset)
        self.out += lit
        if mlen:
            assert 1 <= offset <= min(len(self.out), LZ4_MAX_OFFSET)
            start = len(self.out) - offset
            for j in range(mlen):
                self.out.append(self.out[start + j])

    def random(self, n: int) -> bytes:
        return self.rng.integers(0, 256, n, dtype=np.uint8).tobytes()


def _lz4_offset(rng, kind: str, op: int) -> int:
    if kind == "far" and op > 4096 and rng.random() < 0.6:
        return int(rng.integers(4096, min(op, LZ4_MAX_OFFSET) + 1))
    if rng.random() < 0.6 or op < 64:
        return int(rng.integers(1, min(op, 64) + 1))
    return int(rng.integers(64, min(op, 4096) + 1))


def _lz4_mlen(rng, kind: str) -> int:
    if kind == "ext" and rng.random() < 0.5:
        runs = int(rng.choice([8, 9, 16, 17, 24]))
        return 19 + 255 * runs + int(rng.integers(0, 255))
    if rng.random() < 0.7:
        return int(rng.integers(4, 19))
    return int(rng.integers(19, 600))


def _lz4_litlen(rng, kind: str) -> int:
    if kind == "ext" and rng.random() < 0.3:
        runs = int(rng.choice([8, 9, 16]))
        return 15 + 255 * runs + int(rng.integers(0, 255))
    if kind == "zero_lit" and rng.random() < 0.5:
        return 0
    return int(rng.integers(0 if kind == "zero_lit" else 1, 40))


def lz4_build(rng, out_len: int, kind: str):
    """One valid LZ4 block of `kind` decoding to out_len >= 64 bytes.
    Returns (stream bytes, decoded bytes)."""
    w = _LZ4Writer(rng)
    reach = kind == "far" and out_len >= LZ4_MAX_OFFSET + 64
    tail = int(rng.integers(1, 33))
    stop = out_len - tail - (20 if reach else 0)
    first = True
    while True:
        L = int(rng.integers(1, 33)) if first else _lz4_litlen(rng, kind)
        first = False
        op = len(w.out) + L
        room = stop - op
        if room < 4:
            break
        w.seq(w.random(L), min(_lz4_mlen(rng, kind), room),
              _lz4_offset(rng, kind, op))
    if reach:
        w.seq(w.random(max(stop - len(w.out), 1)), 16, LZ4_MAX_OFFSET)
    w.seq(w.random(out_len - len(w.out)))
    return bytes(w.stream), bytes(w.out)


def _lz4_prefix(rng, n_out: int) -> _LZ4Writer:
    """A writer holding valid sequences up to about n_out bytes."""
    w = _LZ4Writer(rng)
    w.seq(w.random(int(rng.integers(8, 33))), 8, 4)
    while len(w.out) < n_out:
        L = int(rng.integers(1, 20))
        w.seq(w.random(L), int(rng.integers(4, 30)),
              int(rng.integers(1, min(len(w.out) + L, LZ4_MAX_OFFSET) + 1)))
    return w


def lz4_dense(rng, out_len: int):
    """A token-dense valid LZ4 block: a one-byte literal and a 4-byte
    match per 5 output bytes (two records), past the default walk budget
    and within structured.high_records. Returns (stream, decoded)."""
    w = _LZ4Writer(rng)
    while len(w.out) + 10 <= out_len:
        w.seq(w.random(1), 4, int(rng.integers(1, min(len(w.out) + 1, 64) + 1)))
    w.seq(w.random(out_len - len(w.out)))
    return bytes(w.stream), bytes(w.out)


def lz4_error_rows(rng, out_len: int) -> list:
    """(row bytes, csize) of streams every walk must reject."""
    rows = []
    for side in ("lit", "match"):          # extension run cut short
        w = _lz4_prefix(rng, out_len // 2)
        t = len(w.stream)
        tok = bytes([0xF0 if side == "lit" else 0x1F])
        body = (b"\xff" * 16 + b"\x01" if side == "lit"
                else b"\x00" + bytes([1, 0]) + b"\xff" * 16 + b"\x01")
        row = bytes(w.stream) + tok + body
        ext0 = t + 1 + (0 if side == "lit" else 3)
        rows.append((row, ext0 + 8 + int(rng.integers(0, 8))))
    for offset in (0, None):               # offset 0; offset beyond op
        w = _lz4_prefix(rng, min(out_len // 2, 32768))
        off = 0 if offset == 0 else len(w.out) + 3 + int(rng.integers(1, 9))
        s = bytes(w.stream) + lz4_sequence(b"abc", 8, off)
        s += lz4_sequence(bytes(8))
        rows.append((s, len(s)))
    w = _lz4_prefix(rng, out_len // 2)     # ends on a match
    w.seq(w.random(out_len - len(w.out) - 8), 8, 3)
    rows.append((bytes(w.stream), len(w.stream)))
    return rows


def lz4_rows(seed: int, out_len: int, width: int, garbage: int = 8):
    """(buf uint8 (N, width), csizes int32 (N,), nvalid, nbad): the valid
    streams of every kind first (zero past csize), then nbad error rows
    (:func:`lz4_error_rows`; the bytes past csize kept in the row), then
    one-byte corruptions of the valid streams and `garbage` random
    rows."""
    rng = np.random.default_rng(seed)
    valid = [lz4_build(rng, out_len, k)[0] for k in LZ4_KINDS
             for _ in range(2)]
    bad = lz4_error_rows(rng, out_len)
    rows = ([(s, len(s)) for s in valid] + bad
            + _corrupt_and_garbage(rng, valid, width, garbage))
    buf, cs = _pack(rows, width)
    return buf, cs, len(valid), len(bad)


# Rows for K4's block split (lz4_edge_rows), at out_len 8192: with blocks
# of a few dozen positions every sequence straddles a block edge
#   straddle    valid rows of every kind
#   long_runs   a literal whose 255-run (31 bytes) spans blocks; runs of 600
#               and 700 bytes at a token and in a match (past out_len: err)
#   near_end    a literal's 255-run cut 3, 9 and 17 bytes before csize
#   all_255     rows of 255 bytes only, one of them as wide as the row
#   late_error  clean blocks, then an offset beyond the output, offset 0,
#               a match past out_len, a stream ending on a match
#   dense       token-dense rows (lz4_dense): budgets in later blocks
#   one_block   a valid row whose stream fits a block of 64 positions
LZ4_EDGE_GROUPS = ("straddle", "long_runs", "near_end", "all_255",
                   "late_error", "dense", "one_block")


def lz4_edge_rows(seed: int, out_len: int = 8192, width: int = 8256):
    """(buf uint8 (N, width), csizes int32 (N,), groups): the rows of
    LZ4_EDGE_GROUPS, groups[name] their row indices."""
    rng = np.random.default_rng(seed)
    groups = {g: [] for g in LZ4_EDGE_GROUPS}
    rows = []

    def add(group, stream, csize=None):
        groups[group].append(len(rows))
        rows.append((stream[:width], len(stream) if csize is None else csize))

    for k in LZ4_KINDS:
        add("straddle", lz4_build(rng, out_len, k)[0])
    w = _LZ4Writer(rng)
    w.seq(w.random(15 + 255 * 31 + 7), 8, 3)
    w.seq(w.random(out_len - len(w.out)))
    add("long_runs", bytes(w.stream))
    pre = bytes(_lz4_prefix(rng, 1500).stream)
    add("long_runs", pre + b"\xf0" + b"\xff" * 600 + b"\x05" + bytes(64))
    add("long_runs", pre + b"\x1f" + b"a\x01\x00" + b"\xff" * 700 + b"\x03"
        + bytes(40))
    cut = pre + b"\xf0" + b"\xff" * 40
    for back in (3, 9, 17):
        add("near_end", cut, len(cut) - back)
    add("all_255", b"\xff" * 3000)
    add("all_255", b"\xff" * width)
    w = _lz4_prefix(rng, out_len * 3 // 4)
    tail = lz4_sequence(bytes(8))
    add("late_error", bytes(w.stream)
        + lz4_sequence(b"abc", 8, len(w.out) + 50) + tail)
    add("late_error", bytes(w.stream) + lz4_sequence(b"abc", 8, 0) + tail)
    w = _lz4_prefix(rng, out_len - 200)
    add("late_error", bytes(w.stream) + lz4_sequence(b"ab", 400, 3) + tail)
    add("late_error", bytes(_lz4_prefix(rng, out_len * 7 // 8).stream))
    for _ in range(2):
        add("dense", lz4_dense(rng, out_len)[0])
    w = _LZ4Writer(rng)                    # about 60 stream bytes
    w.seq(w.random(16), out_len - 24, 16)
    w.seq(w.random(8))
    add("one_block", bytes(w.stream))
    buf, cs = _pack(rows, width)
    return buf, cs, groups


# ---------------------------------------------------------------------------
# Raw snappy (the public format; blosc/blosc.c:443-467 wrap the library)
# ---------------------------------------------------------------------------
#
#   short     one-byte-offset copies (tag & 3 == 1), literals of 1..60
#   long      literals of 61 and more with 1-4 extra length bytes (the
#             count chosen at random, not the least), 2-byte-offset copies
#   far       4-byte-offset copies (tag & 3 == 3), offsets past 65535 on
#             rows long enough
#   wide      short literals only: the stream is longer than its output
#             (a snappy split may exceed neblock)
#
# Error rows (snappy_rows): a uvarint that differs from out_len, one that
# runs past 5 bytes, offset 0, an offset beyond the output so far, a
# literal whose fourth extra length byte is set, and a stream cut inside
# a copy token.

SNAPPY_KINDS = ("short", "long", "far", "wide")

# (seed, out_len, row width): the width is the pipeline's gather width
# for snappy, out_len + out_len // 6 + 64, room for "wide" streams
SNAPPY_CASES = ((31, 256, 362), (32, 8192, 9621))
SNAPPY_CARD_CASES = SNAPPY_CASES + ((33, 262144, 305898),)


def uvarint(v: int) -> bytes:
    out = bytearray()
    while v >= 0x80:
        out.append((v & 0x7F) | 0x80)
        v >>= 7
    out.append(v)
    return bytes(out)


def snappy_literal(lit: bytes, extra: int = 0) -> bytes:
    """A literal tag and its bytes; extra (1-4) forces that many length
    bytes, else the least encoding."""
    n = len(lit) - 1
    if not extra and n < 60:
        return bytes([n << 2]) + lit
    extra = max(extra, 1 if n < 1 << 8 else 2 if n < 1 << 16 else 3)
    return bytes([(59 + extra) << 2]) + n.to_bytes(extra, "little") + lit


def snappy_copy(mlen: int, offset: int, typ: int) -> bytes:
    """A copy token of tag type typ (1: 4 <= mlen <= 11, offset < 2048;
    2: mlen <= 64, offset < 65536; 3: mlen <= 64, 4-byte offset)."""
    if typ == 1:
        return bytes([((offset >> 8) << 5) | ((mlen - 4) << 2) | 1,
                      offset & 255])
    return (bytes([((mlen - 1) << 2) | typ])
            + offset.to_bytes(2 if typ == 2 else 4, "little"))


class _SnappyWriter:
    def __init__(self, rng, out_len: int):
        self.rng = rng
        self.stream = bytearray(uvarint(out_len))
        self.out = bytearray()

    def literal(self, n: int, extra: int = 0) -> None:
        lit = self.rng.integers(0, 256, n, dtype=np.uint8).tobytes()
        self.stream += snappy_literal(lit, extra)
        self.out += lit

    def copy(self, mlen: int, offset: int, typ: int) -> None:
        assert 1 <= offset <= len(self.out)
        self.stream += snappy_copy(mlen, offset, typ)
        start = len(self.out) - offset
        for j in range(mlen):
            self.out.append(self.out[start + j])


def _snappy_step(w: _SnappyWriter, rng, kind: str, room: int) -> None:
    op = len(w.out)
    if kind == "wide":
        w.literal(min(room, int(rng.integers(6, 9))))
        return
    if rng.random() < 0.4 or room < 4 or op == 0:
        n = min(room, int(rng.integers(61, 400)) if kind == "long"
                else int(rng.integers(1, 61)))
        w.literal(n, int(rng.integers(1, 5)) if kind == "long" and n > 1
                  else 0)
        return
    if kind == "short" and rng.random() < 0.8:
        off = int(rng.integers(1, min(op, 2047) + 1))
        w.copy(min(int(rng.integers(4, 12)), room), off, 1)
        return
    mlen = min(int(rng.integers(1, 65)), room)
    if kind == "far":
        off = int(rng.integers(max(1, op - 200000), op + 1))
        w.copy(mlen, off, 3)
    else:
        w.copy(mlen, int(rng.integers(1, min(op, 65535) + 1)), 2)


def snappy_build(rng, out_len: int, kind: str):
    """One valid raw snappy stream of `kind` decoding to out_len bytes.
    Returns (stream bytes, decoded bytes)."""
    w = _SnappyWriter(rng, out_len)
    w.literal(int(rng.integers(1, 33)))
    while len(w.out) < out_len:
        _snappy_step(w, rng, kind, out_len - len(w.out))
    return bytes(w.stream), bytes(w.out)


def snappy_dense(rng, out_len: int):
    """A token-dense valid snappy stream: a one-byte literal and a 4-byte
    copy per 5 output bytes (two records), past the default walk budget
    and within structured.high_records. Returns (stream, decoded)."""
    w = _SnappyWriter(rng, out_len)
    while len(w.out) + 5 <= out_len:
        w.literal(1)
        w.copy(4, int(rng.integers(1, min(len(w.out), 64) + 1)), 1)
    if len(w.out) < out_len:
        w.literal(out_len - len(w.out))
    return bytes(w.stream), bytes(w.out)


def snappy_error_rows(rng, out_len: int) -> list:
    """(row bytes, csize) of streams every walk must reject."""
    def prefix(n_out):
        w = _SnappyWriter(rng, out_len)
        w.literal(int(rng.integers(8, 33)))
        while len(w.out) < n_out:
            _snappy_step(w, rng, "short", n_out - len(w.out))
        return w

    rows = []
    s, _ = snappy_build(rng, out_len, "short")
    bad_len = uvarint(out_len + 1) + s[len(uvarint(out_len)):]
    rows.append((bad_len, len(bad_len)))                # length differs
    rows.append((b"\x80" * 5 + s, 5 + len(s)))          # runs past 5 bytes
    for case in ("off0", "off_big", "lit_big", "cut"):
        w = prefix(out_len // 2)
        op = len(w.out)
        if case == "off0":
            tail = snappy_copy(8, 0, 2)
        elif case == "off_big":
            tail = snappy_copy(8, op + int(rng.integers(1, 9)), 3)
        elif case == "lit_big":
            tail = bytes([63 << 2, 3, 0, 0, 1]) + bytes(8)
        else:
            tail = snappy_copy(8, 3, 3)[:3]
        row = bytes(w.stream) + tail
        rows.append((row + bytes(8), len(row)))
    return rows


def snappy_rows(seed: int, out_len: int, width: int, garbage: int = 8):
    """(buf uint8 (N, width), csizes int32 (N,), nvalid, nbad), laid out
    as :func:`lz4_rows`'s."""
    rng = np.random.default_rng(seed)
    valid = [snappy_build(rng, out_len, k)[0] for k in SNAPPY_KINDS
             for _ in range(2)]
    bad = snappy_error_rows(rng, out_len)
    rows = ([(s, len(s)) for s in valid] + bad
            + _corrupt_and_garbage(rng, valid, width, garbage))
    buf, cs = _pack(rows, width)
    return buf, cs, len(valid), len(bad)


SNAPPY_LONG_KINDS = ("lit4", "litwin")


def snappy_long_literal_rows(seed: int, out_len: int, width: int):
    """(buf, csizes, nvalid): streams whose literals leave the snappy walk
    kernel's 128-position window. "lit4": literals of 200-2000 bytes with
    a 4-byte length (the fourth byte 0), between short copies; "litwin":
    literals of 129-1000 bytes with the least length encoding. One valid
    row of each, then a one-byte corruption of each."""
    rng = np.random.default_rng(seed)
    valid = []
    for kind in SNAPPY_LONG_KINDS:
        w = _SnappyWriter(rng, out_len)
        while len(w.out) < out_len:
            room = out_len - len(w.out)
            if len(w.out) == 0 or rng.random() < 0.5 or room < 4:
                lo, hi = (200, 2000) if kind == "lit4" else (129, 1000)
                n = min(room, int(rng.integers(lo, hi)))
                w.literal(n, 4 if kind == "lit4" else 0)
            else:
                w.copy(min(int(rng.integers(4, 12)), room),
                       int(rng.integers(1, min(len(w.out), 2047) + 1)), 1)
        valid.append(bytes(w.stream))
    rows = [(v, len(v)) for v in valid] + _corrupt_and_garbage(rng, valid,
                                                                 width, 0)
    buf, cs = _pack(rows, width)
    return buf, cs, len(valid)


# ---------------------------------------------------------------------------
# zlib streams (blosc/blosc.c:469-496 wrap the library's one-shot calls)
# ---------------------------------------------------------------------------
#
# Valid rows come from zlib.compressobj, each checked by a bitwise parse
# of its block types (deflate_blocks):
#   level1/6/9  Z_DEFAULT_STRATEGY at levels 1, 6 and 9
#   fixed       Z_FIXED: fixed-Huffman blocks only
#   rle         Z_RLE: distance-1 matches only
#   filtered    Z_FILTERED
#   multiblock  four pieces, each closed by Z_PARTIAL_FLUSH (which ends a
#               block with an empty fixed-code block; Z_SYNC_FLUSH and
#               Z_FULL_FLUSH would add empty stored blocks, which err)
#   longcodes   one dynamic block written bit by bit, its literal/length
#               and distance codes complete but 11 to 15 bits long for
#               most symbols (lengths 1..11, then 16 codes of 15 bits),
#               so most symbols pass K6's 10-bit lookup
#   dense       Z_HUFFMAN_ONLY: one literal event per output byte, past
#               the default event budget, within high_events
# One row the library itself rejects but the JAX machine decodes:
#   oversub     a dynamic block whose literal/length code is
#               over-subscribed (one length-3 code falls past the
#               canonical range) and whose distance code is incomplete:
#               the JAX rule (the shortest length whose range holds the
#               code) decodes the reachable codes, so every walk accepts
#               it, to "abab" then "b" repeated (matches at distance 1)
# Error rows, which every walk must reject: CM != 8, the FDICT bit,
# csize < 8, a stored block (level 0), BTYPE 3, a distance beyond the
# output so far, output past out_len, a truncated stream, and a
# code-length repeat (16) at position 0.

ZLIB_VALID = ("level1", "level6", "level9", "fixed", "rle", "filtered",
              "multiblock", "longcodes")
ZLIB_BAD = ("cm", "fdict", "short", "stored", "btype3", "far_dist",
            "overrun", "truncated", "rep16_first")
ZLIB_ODD = ("oversub",)
ZLIB_KINDS = ZLIB_VALID + ("dense",) + ZLIB_ODD + ZLIB_BAD

# (seed, out_len, row width): the width is the pipeline's gather width,
# out_len + 64. One shape for the CPU tests (each is a JAX compile that
# takes about a minute); the card adds 8 KB and 32 KB rows
ZLIB_CASES = ((41, 1024, 1088),)
ZLIB_CARD_CASES = ZLIB_CASES + ((42, 8192, 8256), (43, 32768, 32832))

_ZLIB_HDR = b"\x78\x01"       # CM 8, 32 KB window, FCHECK valid


def _zlib_tables():
    from ..gpu import codec_zlib as cz

    return cz._LBASE, cz._LEXTRA, cz._DBASE, cz._DEXTRA, cz._CLORDER, \
        cz._FIXED_LL


def deflate_blocks(stream: bytes, lengths: list | None = None) -> list:
    """The BTYPE of every block of a zlib stream, from a bitwise parse of
    RFC 1951 that skips the payloads. Raises ValueError on a malformed
    stream. When `lengths` is a list, each dynamic block appends its
    code lengths to it: (code-length code (19), literal/length (HLIT),
    distance (HDIST))."""
    lbase, lextra, dbase, dextra, clorder, fixed_ll = _zlib_tables()
    data, pos = stream[2:], 0

    def bits(n):
        nonlocal pos
        v = 0
        for i in range(n):
            if pos >> 3 >= len(data):
                raise ValueError("stream ends inside a block")
            v |= ((data[pos >> 3] >> (pos & 7)) & 1) << i
            pos += 1
        return v

    def table(lengths):
        code, tab = 0, {}
        for b in range(1, 16):
            for sym, ln in enumerate(lengths):
                if ln == b:
                    tab[(b, code)] = sym
                    code += 1
            code <<= 1
        return tab

    def sym(tab):
        c = 0
        for b in range(1, 16):
            c = (c << 1) | bits(1)
            if (b, c) in tab:
                return tab[(b, c)]
        raise ValueError("invalid code")

    types = []
    while True:
        final, btype = bits(1), bits(2)
        types.append(btype)
        if btype == 3:
            raise ValueError("BTYPE 3")
        if btype == 0:
            pos = (pos + 7) & ~7
            n = bits(16)
            bits(16)
            pos += 8 * n
        else:
            if btype == 1:
                lt, dt = table(fixed_ll), table([5] * 30)
            else:
                hlit, hdist, hclen = bits(5) + 257, bits(5) + 1, bits(4) + 4
                cl = [0] * 19
                for k in range(hclen):
                    cl[clorder[k]] = bits(3)
                ct, L = table(cl), []
                while len(L) < hlit + hdist:
                    s = sym(ct)
                    if s < 16:
                        L.append(s)
                    elif s == 16:
                        L += [L[-1]] * (3 + bits(2))
                    else:
                        L += [0] * (3 + bits(3) if s == 17 else 11 + bits(7))
                lt, dt = table(L[:hlit]), table(L[hlit:])
                if lengths is not None:
                    lengths.append((cl, L[:hlit], L[hlit:hlit + hdist]))
            while (s := sym(lt)) != 256:
                if s > 256:
                    bits(int(lextra[s - 257]))
                    bits(int(dextra[sym(dt)]))
        if final:
            return types


class _BitWriter:
    """DEFLATE bits: values LSB-first, Huffman codes MSB-first."""

    def __init__(self):
        self.acc, self.n = 0, 0

    def put(self, v: int, n: int) -> None:
        self.acc |= v << self.n
        self.n += n

    def code(self, c: int, n: int) -> None:
        self.put(int(format(c, f"0{n}b")[::-1], 2), n)

    def fixed_sym(self, s: int) -> None:
        if s < 144:
            self.code(0x30 + s, 8)
        elif s < 256:
            self.code(0x190 + s - 144, 9)
        elif s < 280:
            self.code(s - 256, 7)
        else:
            self.code(0xC0 + s - 280, 8)

    def fixed_match(self, length: int, d: int) -> None:
        lbase, lextra, dbase, dextra = _zlib_tables()[:4]
        li = int(np.searchsorted(lbase, length, side="right")) - 1
        self.fixed_sym(257 + li)
        self.put(length - int(lbase[li]), int(lextra[li]))
        di = int(np.searchsorted(dbase, d, side="right")) - 1
        self.code(di, 5)
        self.put(d - int(dbase[di]), int(dextra[di]))

    def zlib_stream(self, data: bytes | None = None) -> bytes:
        """The bits as a zlib stream, with the adler32 of `data`, or a
        (never checked) placeholder."""
        body = self.acc.to_bytes((self.n + 7) // 8, "little")
        check = (b"\0\0\0\1" if data is None
                 else zlib.adler32(data).to_bytes(4, "big"))
        return _ZLIB_HDR + body + check


def zlib_data(rng, n: int) -> bytes:
    """n bytes that deflate to short literal stretches between matches
    of 3..80 bytes at distances 1..32768 (log-uniform)."""
    out = bytearray(rng.integers(0, 24, 8, dtype=np.uint8).tobytes())
    while len(out) < n:
        if rng.random() < 0.25:
            out += rng.integers(0, 24, int(rng.integers(1, 9)),
                                dtype=np.uint8).tobytes()
            continue
        d = int(np.exp(rng.uniform(0, np.log(min(len(out), 32768) + 1))))
        d = min(max(d, 1), len(out))
        for _ in range(int(rng.integers(3, 81))):
            out.append(out[-d])
    return bytes(out[:n])


def _compress(data: bytes, level: int = 6,
              strategy: int = zlib.Z_DEFAULT_STRATEGY, pieces: int = 1) -> bytes:
    """zlib.compressobj's stream of data, cut into `pieces` closed by
    Z_PARTIAL_FLUSH."""
    co = zlib.compressobj(level, zlib.DEFLATED, zlib.MAX_WBITS, 8, strategy)
    cut = [len(data) * k // pieces for k in range(pieces + 1)]
    out = b""
    for k in range(pieces):
        out += co.compress(data[cut[k]:cut[k + 1]])
        if k + 1 < pieces:
            out += co.flush(zlib.Z_PARTIAL_FLUSH)
    return out + co.flush()


def _canonical(lengths) -> dict:
    """symbol -> (code, length) of the canonical code of `lengths`."""
    out, code = {}, 0
    for b in range(1, 16):
        for sym, ln in enumerate(lengths):
            if ln == b:
                out[sym] = (code, b)
                code += 1
        code <<= 1
    return out


def zlib_longcodes(rng, out_len: int):
    """(stream, data): one final dynamic block whose literal/length code
    gives 11 symbols the lengths 1..11 and 16 more the length 15, and
    whose distance code gives 14 symbols the lengths 1..14 and 2 the
    length 15 (both complete, so zlib decodes it too), the symbols
    shuffled among the lengths; then literals (16 byte values) and
    matches drawn from those symbols up to out_len, and EOB."""
    lbase, lextra, dbase, dextra, clorder, _ = _zlib_tables()
    lens_l = list(range(1, 12)) + [15] * 16
    lits = [int(v) for v in rng.choice(256, 16, replace=False)]
    lsyms = lits + [256] + [int(v) for v in rng.choice(
        np.arange(257, 286), len(lens_l) - 17, replace=False)]
    rng.shuffle(lsyms)
    L = [0] * 286
    for sym, ln in zip(lsyms, lens_l):
        L[sym] = ln
    lens_d = list(range(1, 15)) + [15, 15]
    dsyms = [int(v) for v in rng.permutation(30)[:len(lens_d)]]
    D = [0] * 30
    for sym, ln in zip(dsyms, lens_d):
        D[sym] = ln
    hlit = max(i for i, v in enumerate(L) if v) + 1
    hdist = max(i for i, v in enumerate(D) if v) + 1
    w = _BitWriter()
    w.put(1, 1)
    w.put(2, 2)                                  # final, dynamic Huffman
    w.put(hlit - 257, 5)
    w.put(hdist - 1, 5)
    w.put(19 - 4, 4)                             # HCLEN 19
    for sym in clorder:                          # lengths 0..15: 4 bits each
        w.put(4 if sym < 16 else 0, 3)
    for ln in L[:hlit] + D[:hdist]:
        w.code(ln, 4)
    lc, dc = _canonical(L[:hlit]), _canonical(D[:hdist])
    lens = [s for s in lsyms if s > 256]
    out = bytearray()
    while len(out) < out_len:
        room = out_len - len(out)
        ls = [s for s in lens if lbase[s - 257] <= room]
        ds = [s for s in dsyms if dbase[s] <= len(out)]
        if not ls or not ds or rng.random() < 0.6:
            b = lits[int(rng.integers(0, 16))]
            w.code(*lc[b])
            out.append(b)
            continue
        sym = ls[int(rng.integers(0, len(ls)))]
        i = sym - 257
        ext = int(rng.integers(0, 1 << int(lextra[i])))
        n = min(int(lbase[i]) + ext, room)
        if n < int(lbase[i]):
            continue
        ext = n - int(lbase[i])
        if ext >= 1 << int(lextra[i]):
            continue
        ds_ = ds[int(rng.integers(0, len(ds)))]
        dext = int(rng.integers(0, 1 << int(dextra[ds_])))
        d = min(int(dbase[ds_]) + dext, len(out))
        dext = d - int(dbase[ds_])
        w.code(*lc[sym])
        w.put(ext, int(lextra[i]))
        w.code(*dc[ds_])
        w.put(dext, int(dextra[ds_]))
        for _ in range(n):
            out.append(out[-d])
    w.code(*lc[256])
    return w.zlib_stream(bytes(out)), bytes(out)


def zlib_valid(rng, out_len: int, kind: str) -> bytes:
    """A valid zlib stream of `kind` (ZLIB_VALID or "dense") decoding to
    out_len bytes, its block types checked."""
    if kind == "longcodes":
        s, want = zlib_longcodes(rng, out_len)
        if zlib.decompress(s) != want:
            raise AssertionError("zlib longcodes: unexpected stream")
        return s
    if kind == "dense":
        s = _compress(rng.integers(0, 16, out_len, dtype=np.uint8).tobytes(),
                      6, zlib.Z_HUFFMAN_ONLY)
        want = None
    else:
        data = zlib_data(rng, out_len)
        level = {"level1": 1, "level9": 9}.get(kind, 6)
        strategy = {"fixed": zlib.Z_FIXED, "rle": zlib.Z_RLE,
                    "filtered": zlib.Z_FILTERED}.get(kind,
                                                     zlib.Z_DEFAULT_STRATEGY)
        s = _compress(data, level, strategy, 4 if kind == "multiblock" else 1)
        want = data
    types = deflate_blocks(s)
    if 0 in types or len(zlib.decompress(s)) != out_len or (
            want is not None and zlib.decompress(s) != want):
        raise AssertionError(f"zlib {kind}: unexpected stream {types}")
    if kind == "fixed" and set(types) != {1}:
        raise AssertionError(f"zlib fixed: block types {types}")
    if kind == "multiblock" and len(types) < 4:
        raise AssertionError(f"zlib multiblock: block types {types}")
    return s


def zlib_oversub(out_len: int) -> bytes:
    """The "oversub" row: one final dynamic block, literal/length code
    lengths a = 1, b = 2, EOB = 257 = 258 = 3 (Kraft sum 9/8: 258 gets
    the canonical code 8, beyond 3 bits), one distance code of length 1;
    literals "abab" (plus "a"s to make the rest a multiple of 3), then
    length-3 matches at distance 1 up to out_len, then EOB."""
    w = _BitWriter()
    w.put(1, 1)
    w.put(2, 2)                                  # dynamic Huffman
    w.put(259 - 257, 5)                          # HLIT 259
    w.put(0, 5)                                  # HDIST 1
    w.put(18 - 4, 4)                             # HCLEN 18 (up to symbol 1)
    cl = {17: 3, 18: 2, 3: 3, 2: 2, 1: 2}        # complete: 3/4 + 2/8
    for sym in _zlib_tables()[4][:18]:
        w.put(cl.get(int(sym), 0), 3)
    # canonical code-length code: 1 -> 00, 2 -> 01, 18 -> 10, 3 -> 110,
    # 17 -> 111
    codes = {1: (0, 2), 2: (1, 2), 18: (2, 2), 3: (6, 3), 17: (7, 3)}

    def zeros(n):
        while n:
            k = min(n, 138)
            w.code(*codes[18])
            w.put(k - 11, 7)
            n -= k

    zeros(97)                                    # symbols 0..96
    w.code(*codes[1])                            # a (97): 1
    w.code(*codes[2])                            # b (98): 2
    zeros(256 - 99)                              # symbols 99..255
    for _ in range(3):                           # EOB, 257, 258: 3
        w.code(*codes[3])
    w.code(*codes[1])                            # distance 0: 1
    # literal/length code: a -> 0, b -> 10, EOB -> 110, 257 -> 111
    lits = "abab" + "a" * ((out_len - 4) % 3)
    for ch in lits:
        w.code(*((0, 1) if ch == "a" else (2, 2)))
    for _ in range((out_len - len(lits)) // 3):
        w.code(7, 3)                             # length 3 ...
        w.code(0, 1)                             # ... at distance 1
    w.code(6, 3)                                 # EOB
    return w.zlib_stream()


def zlib_bad(rng, out_len: int, kind: str) -> tuple:
    """(row bytes, csize) of an invalid stream of `kind` (ZLIB_BAD); the
    row is zero past csize."""
    s = _compress(zlib_data(rng, out_len))
    if kind == "cm":
        return bytes([s[0] ^ 0x01]) + s[1:], len(s)
    if kind == "fdict":
        return s[:1] + bytes([s[1] | 0x20]) + s[2:], len(s)
    if kind == "short":
        return s[:7], 7
    if kind == "stored":
        z = zlib.compress(zlib_data(rng, out_len), 0)
        if deflate_blocks(z)[0] != 0:
            raise AssertionError("level 0 must store")
        return z, len(z)
    if kind == "btype3":
        return s[:2] + bytes([s[2] | 0x06]) + s[3:], len(s)
    if kind == "truncated":
        return s[:len(s) // 2], len(s) // 2
    if kind == "overrun":
        z = _compress(zlib_data(rng, out_len + 64))
        return z, len(z)
    w = _BitWriter()
    if kind == "far_dist":
        w.put(1, 1)                              # BFINAL
        w.put(1, 2)                              # fixed Huffman
        for b in b"abc":
            w.fixed_sym(b)
        w.fixed_match(3, 10)                     # 10 > op = 3
        w.fixed_sym(256)
    elif kind == "rep16_first":
        w.put(1, 1)
        w.put(2, 2)                              # dynamic Huffman
        w.put(0, 5)                              # HLIT 257
        w.put(0, 5)                              # HDIST 1
        w.put(0, 4)                              # HCLEN 4: 16, 17, 18, 0
        for ln in (1, 0, 0, 1):                  # 0 -> code 0, 16 -> 1
            w.put(ln, 3)
        w.code(1, 1)                             # symbol 16 at position 0
        w.put(0, 2)
        w.put(0, 40)
    else:
        raise ValueError(kind)
    z = w.zlib_stream()
    return z, len(z)


def zlib_rows(seed: int, out_len: int, width: int, garbage: int = 0):
    """(buf uint8 (N, width), csizes int32 (N,), kinds): one row of each
    of ZLIB_KINDS, in that order, zero past csize; with garbage > 0 then
    a one-byte corruption of each valid row ("flip": over-subscribed and
    incomplete codes among them) and `garbage` random rows."""
    rng = np.random.default_rng(seed)
    valid = [zlib_valid(rng, out_len, k) for k in ZLIB_VALID + ("dense",)]
    odd = zlib_oversub(out_len)
    rows = [(s, len(s)) for s in valid] + [(odd, len(odd))]
    rows += [zlib_bad(rng, out_len, k) for k in ZLIB_BAD]
    kinds = ZLIB_KINDS
    if garbage:
        rows += _corrupt_and_garbage(rng, valid, width, garbage)
        kinds += ("flip",) * len(valid) + ("garbage",) * garbage
    buf, cs = _pack(rows, width)
    return buf, cs, kinds


# ---------------------------------------------------------------------------
# zstd frames (blosc/blosc.c:498-522 wraps the library's one-shot calls)
# ---------------------------------------------------------------------------
#
# Valid frames, each decoding to out_len bytes (ZSTD_VALID): zeros, a raw
# block (random bytes), raw literals (a 64-byte tile), the same frame with
# its literal section rewritten as RLE literals (libzstd writes them only
# where a block's literals are one repeated byte), Huffman literals (16
# spaced byte values) at levels 1 and 19, a short single-stream Huffman
# section, runs and a ramp, shuffled-typed data at level 3, and
# multi-block frames (ZSTD_compress2 with a 1 KB window, so every 1 KB is
# a block: treeless literals and repeated sequence tables) at levels 1,
# 3 and 19, the last with a content checksum. Between them they cover raw, RLE and
# compressed blocks; raw, RLE and Huffman literals, 1- and 4-stream, with
# direct and FSE-coded weights; predefined, RLE, FSE and repeat sequence
# tables; repeat offsets (zstd_features names what a frame holds).
# "shuffled": the bench data byte-shuffled at level 9 (clevel 5), whose
# match-length table holds a zero run of more than 24 counts, which the
# JAX machine rejects (8 repeat flags at most) and the port reads.
# "dense": 4-bit random bytes, one Huffman literal per output byte, which
# the JAX machine's default budget (its slot count) rejects.
# Error rows (ZSTD_BAD), which every walk must reject: a bad magic, the
# dictionary-ID flag, the reserved bit, block type 3, a truncated frame,
# a frame longer than out_len.

ZSTD_VALID = ("zeros", "raw_block", "raw_lits", "rle_lits", "huf_l1",
              "huf_l19", "huf_1s", "runs", "ramp", "typed_l3", "shuffled",
              "multi_huf", "multi_l3", "multi_l19_ck")
ZSTD_BAD = ("magic", "dict", "reserved", "btype3", "truncated", "long")
ZSTD_KINDS = ZSTD_VALID + ("dense",) + ZSTD_BAD

# (seed, out_len, row width): the width is the pipeline's gather width,
# out_len + 64. One shape for the CPU tests (the JAX machine compiles once
# per shape); the card adds 32 KB and 128 KB rows
ZSTD_CASES = ((51, 8192, 8256),)
ZSTD_CARD_CASES = ZSTD_CASES + ((52, 32768, 32832), (53, 131072, 131136))


def zstd_data(rng, kind: str, n: int) -> bytes:
    """The bytes of a ZSTD_VALID (or "dense") kind."""
    if kind == "zeros":
        return bytes(n)
    if kind == "raw_block":
        return rng.integers(0, 256, n, dtype=np.uint8).tobytes()
    if kind in ("raw_lits", "rle_lits"):
        return np.tile(rng.integers(0, 256, 64, dtype=np.uint8),
                       n // 64 + 1)[:n].tobytes()
    if kind in ("huf_l1", "huf_l19", "multi_huf"):
        return (rng.integers(0, 16, n, dtype=np.uint8) * 16).tobytes()
    if kind == "huf_1s":
        return (rng.integers(65, 69, 200, dtype=np.uint8).tobytes()
                + bytes(n - 200))
    if kind == "runs":
        return np.repeat(rng.integers(0, 9, n // 16 + 1).astype(np.uint8),
                         16)[:n].tobytes()
    if kind == "ramp":
        return (np.arange(n) % 251).astype(np.uint8).tobytes()
    if kind == "dense":
        return rng.integers(0, 16, n, dtype=np.uint8).tobytes()
    if kind == "shuffled":
        from ..ops.filters_np import shuffle
        from .timing import synth

        return bytes(shuffle(8, synth(n, 8, 19, seed=int(rng.integers(1 << 16)))))
    # shuffled typed data: slow random walks of int32 values, byte-shuffled
    v = np.cumsum(rng.integers(-3, 4, n // 4 + 1)).astype(np.int32)
    b = v.view(np.uint8)[:n // 4 * 4].reshape(-1, 4).T.reshape(-1)
    return (zlib_data(rng, n - b.size) + b.tobytes())[:n]


def zstd_valid(rng, out_len: int, kind: str) -> bytes:
    from ..ops.codecs import zstd_

    data = zstd_data(rng, kind, out_len)
    if kind.startswith("multi"):
        level = 19 if "l19" in kind else 3 if "l3" in kind else 1
        return zstd_.compress2_frame(data, level, 10, kind.endswith("_ck"))
    level = {"huf_l1": 1, "huf_l19": 19, "huf_1s": 3, "runs": 3, "ramp": 9,
             "typed_l3": 3, "shuffled": 9, "dense": 3}.get(kind, 1)
    frame = zstd_.frame(data, level)
    return _rle_literals(frame) if kind == "rle_lits" else frame


def _rle_literals(frame: bytes) -> bytes:
    """The frame with the raw literal section of its first block, of n >= 2
    bytes, rewritten as an RLE section of n copies of 0x5A (a valid frame
    of the same length that decodes to other bytes)."""
    pos = zstd_block_starts(frame)[0]
    bh = int.from_bytes(frame[pos:pos + 3], "little")
    p = pos + 3
    b0 = frame[p]
    sf = (b0 >> 2) & 3
    if (bh >> 1) & 3 != 2 or b0 & 3 != 0 or sf != 1:
        raise ValueError("the first block has no 2-byte raw literals header")
    n = (b0 >> 4) | (frame[p + 1] << 4)
    rle = bytes([1 | (1 << 2) | ((n & 15) << 4), n >> 4, 0x5A])
    size = (bh >> 3) - (2 + n) + len(rle)
    hdr = ((size << 3) | (bh & 7)).to_bytes(3, "little")
    return frame[:pos] + hdr + rle + frame[p + 2 + n:]


def zstd_bad(rng, out_len: int, kind: str) -> tuple:
    """(stream, csize) of a ZSTD_BAD kind."""
    from ..ops.codecs import zstd_

    good = bytearray(zstd_valid(rng, out_len, "typed_l3"))
    if kind == "magic":
        good[0] ^= 0xFF
    elif kind == "dict":
        good[4] |= 1
    elif kind == "reserved":
        good[4] |= 8
    elif kind == "btype3":
        good[zstd_block_starts(bytes(good))[0]] |= 6
    elif kind == "truncated":
        return bytes(good), len(good) - 5
    elif kind == "long":
        good = bytearray(zstd_.frame(zstd_data(rng, "typed_l3", out_len + 100),
                                     3))
    return bytes(good), len(good)


ZSTD_RING_KINDS = ("seq_long", "multi_rep_tl")


def zstd_ring_rows(seed: int, out_len: int, width: int):
    """(buf, csizes, kinds): frames that reach the zstd walk kernel's
    ring refills and carried tables. "seq_long": short matches drawn from
    64 tokens of 3-5 bytes at level 19, a sequence bitstream longer than
    2 KB (the kernel's whole ring); "multi_rep_tl": Huffman-coded bytes
    and runs in 1 KB blocks at level 6, one frame of many blocks with
    repeated sequence tables and treeless literals. Then a one-byte
    corruption of each ("flip")."""
    from ..ops.codecs import zstd_

    rng = np.random.default_rng(seed)
    toks = [rng.integers(0, 256, int(rng.integers(3, 6)), dtype=np.uint8)
            .tobytes() for _ in range(64)]
    d = b"".join(toks[int(i)] for i in rng.integers(0, 64, out_len))[:out_len]
    valid = [zstd_.frame(d, 19)]
    parts = []
    while sum(map(len, parts)) < out_len:
        parts.append((rng.integers(0, 16, 512, dtype=np.uint8) * 16).tobytes())
        parts.append(np.repeat(rng.integers(0, 9, 32).astype(np.uint8),
                               16).tobytes())
    valid.append(zstd_.compress2_frame(b"".join(parts)[:out_len], 6, 10))
    rows = [(v, len(v)) for v in valid] + _corrupt_and_garbage(rng, valid,
                                                                 width, 0)
    buf, cs = _pack(rows, width)
    return buf, cs, ZSTD_RING_KINDS + ("flip",) * len(valid)


def zstd_block_starts(frame: bytes) -> list:
    """Byte offsets of a frame's block headers."""
    fhd = frame[4]
    single, did, fcs = (fhd >> 5) & 1, fhd & 3, fhd >> 6
    pos = 5 + (1 - single) + (0, 1, 2, 4)[did] + (single, 2, 4, 8)[fcs]
    out = []
    while True:
        out.append(pos)
        bh = int.from_bytes(frame[pos:pos + 3], "little")
        pos += 3 + (1 if (bh >> 1) & 3 == 1 else bh >> 3)
        if bh & 1:
            return out


def _ncount_flag_run(buf: bytes, pos: int, max_symbol: int):
    """(longest run of 2-bit zero-run flags, bytes) of the FSE count
    description at pos (RFC 8878 4.1.1, read as zstd_ref.read_ncount
    reads it)."""
    bit = pos * 8

    def read(n):
        nonlocal bit
        v = 0
        for i in range(n):
            b = bit + i
            v |= ((buf[b >> 3] >> (b & 7)) & 1) << i if b >> 3 < len(buf) else 0
        bit += n
        return v

    log = read(4) + 5
    remaining, threshold, nbits = (1 << log) + 1, 1 << log, log + 1
    n, prev0, worst = 0, False, 0
    while remaining > 1 and n <= max_symbol:
        if prev0:
            run = 1
            while True:
                rep = read(2)
                n += rep
                if rep < 3:
                    break
                run += 1
            worst = max(worst, run)
            prev0 = False
            continue
        maxv = 2 * threshold - 1 - remaining
        v = read(nbits - 1)
        if v >= maxv:
            v |= read(1) << (nbits - 1)
            v = v if v < threshold else v - maxv
        count = v - 1
        remaining -= abs(count)
        n += 1
        prev0 = count == 0
        while remaining < threshold and threshold > 1:
            nbits -= 1
            threshold >>= 1
    return worst, (bit + 7) // 8 - pos


def zstd_features(frame: bytes) -> set:
    """What a frame holds: block types ("raw_block", "rle_block",
    "cmp_block"), literal types ("raw_lits", "rle_lits", "huf_1s",
    "huf_4s", "treeless"), Huffman weights ("w_direct", "w_fse"),
    sequence table modes ("seq_predef", "seq_rle", "seq_fse",
    "seq_repeat"), "seq_stream_2k" (a sequence bitstream of more than
    2048 bytes), "multi_block", "checksum", and "zero_run_flags_9" when
    an FSE count description holds a zero run of 9 or more 2-bit repeat
    flags (more than 24 zero counts), which the JAX machine rejects."""
    out = set()
    starts = zstd_block_starts(frame)
    if len(starts) > 1:
        out.add("multi_block")
    if frame[4] & 4:
        out.add("checksum")
    for pos in starts:
        bh = int.from_bytes(frame[pos:pos + 3], "little")
        btype = (bh >> 1) & 3
        out.add(("raw_block", "rle_block", "cmp_block")[btype])
        if btype != 2:
            continue
        p = pos + 3
        b0 = frame[p]
        lt, sf = b0 & 3, (b0 >> 2) & 3
        if lt <= 1:
            out.add(("raw_lits", "rle_lits")[lt])
            h = 1 if (sf & 1) == 0 else 2 if sf == 1 else 3
            rs = (b0 >> 3 if h == 1 else
                  int.from_bytes(frame[p:p + h], "little") >> 4)
            p += h + (rs if lt == 0 else 1)
        else:
            h = (3, 3, 4, 5)[sf]
            v = int.from_bytes(frame[p:p + h], "little") >> 4
            csz = v >> (10, 10, 14, 18)[sf]
            out.add("huf_1s" if sf == 0 else "huf_4s")
            if lt == 3:
                out.add("treeless")
            elif frame[p + h] >= 128:
                out.add("w_direct")
            else:
                out.add("w_fse")
                if _ncount_flag_run(frame, p + h + 1, 255)[0] > 8:
                    out.add("zero_run_flags_9")
            p += h + csz
        n0 = frame[p]
        if n0 == 0:
            continue
        p += 1 if n0 < 128 else 2 if n0 < 255 else 3
        modes = frame[p]
        p += 1
        for sh, maxsym in ((6, 35), (4, 31), (2, 52)):
            mode = (modes >> sh) & 3
            out.add(("seq_predef", "seq_rle", "seq_fse", "seq_repeat")[mode])
            if mode == 1:
                p += 1
            elif mode == 2:
                run, used = _ncount_flag_run(frame, p, maxsym)
                if run > 8:
                    out.add("zero_run_flags_9")
                p += used
        if pos + 3 + (bh >> 3) - p > 2048:
            out.add("seq_stream_2k")
    return out


def zstd_rows(seed: int, out_len: int, width: int, garbage: int = 0):
    """(buf uint8 (N, width), csizes int32 (N,), kinds): one row of each
    of ZSTD_KINDS, in that order, zero past csize; with garbage > 0 then
    a one-byte corruption of each valid row ("flip") and `garbage`
    random rows, half of them behind a valid frame header."""
    rng = np.random.default_rng(seed)
    valid = [zstd_valid(rng, out_len, k) for k in ZSTD_VALID + ("dense",)]
    rows = [(s, len(s)) for s in valid]
    rows += [zstd_bad(rng, out_len, k) for k in ZSTD_BAD]
    kinds = ZSTD_KINDS
    if garbage:
        extra = _corrupt_and_garbage(rng, valid, width, garbage)
        for i in range(len(valid), len(extra), 2):
            b, n = extra[i]
            hdr = valid[0][:6]
            extra[i] = ((hdr + b)[:width], min(n + 6, width))
        rows += extra
        kinds += ("flip",) * len(valid) + ("garbage",) * garbage
    buf, cs = _pack(rows, width)
    return buf, cs, kinds


# ---------------------------------------------------------------------------
# placement records (the expand kernel's input)
# ---------------------------------------------------------------------------
#
# Rows of records written straight, with the bytes they read. Well-formed
# kinds (extents in order, disjoint, inside the row; match distances in
# [1, dst]), which the kernel resolves by pointer jumping:
#   chain1     a literal byte, then distance-1 matches, each reading the
#              last byte of the one before (one chain through the row)
#   periodic   matches with distance < length (2..16), short literals
#   gaps       records separated by unwritten bytes, immediates, and
#              zero-length records
#   mixed      literals (some reading past the row's ends), immediates
#              and matches at any distance up to dst
#   dense      1-3 byte records, more than one staged tile of them
#   tail       a well-formed row, then kind -1, then records that are not
#              (ignored: a row ends at its first kind < 0)
# Kinds that are not well formed, which take the per-record loop: overlap
# (a record starts inside the one before), far (distance > dst), zero_d
# (distance 0), neg_len, bad_kind (low nibble 5), past_end (an extent
# past out_len), unordered (a record before the one before).
RECORD_WELL_FORMED = ("chain1", "periodic", "gaps", "mixed", "dense", "tail")
RECORD_ADVERSARIAL = ("overlap", "far", "zero_d", "neg_len", "bad_kind",
                      "past_end", "unordered")
RECORD_KINDS = RECORD_WELL_FORMED + RECORD_ADVERSARIAL


def _record_row(rng, out_len: int, width: int, kind: str) -> list:
    """[(kind, arg, dst, len)] of one well-formed row of `kind`."""
    recs, pos = [], 0
    while pos < out_len:
        room = out_len - pos
        r = rng.random()
        if kind == "dense":
            n = min(int(rng.integers(1, 4)), room)
        elif kind == "chain1":
            n = min(int(rng.integers(20, 400)), room)
        else:
            n = min(int(rng.integers(1, 300)), room)
        if pos == 0 or (kind == "chain1" and r < 0.02) or (
                kind in ("periodic", "dense") and r < 0.2) or (
                kind in ("mixed", "gaps") and r < 0.3):
            if kind == "mixed" and r < 0.05:
                src = int(rng.integers(-40, 0))          # reads zeros first
            elif kind == "mixed" and r < 0.1:
                src = width - n + int(rng.integers(1, 40))   # past the end
            else:
                src = int(rng.integers(0, max(width - n, 1)))
            if kind == "chain1":
                n = 1
            recs.append((0, src, pos, n))
        elif kind in ("gaps", "mixed") and r < 0.4:
            nb = min(int(rng.integers(0, 9)), room)
            lo, hi = rng.integers(-2**31, 2**31, 2)
            recs.append(((nb << 4) | 2, int(lo), pos, int(hi)))
            n = nb
        else:
            if kind == "chain1":
                d = 1
            elif kind == "periodic":
                d = min(int(rng.integers(2, 17)), pos)
            elif kind == "dense":
                d = int(rng.integers(1, min(pos, 64) + 1))
            else:
                d = int(np.exp(rng.uniform(0, np.log(pos + 1))))
                d = min(max(d, 1), pos)
            recs.append((1, d, pos, n))
        pos += n
        if kind == "gaps":
            if rng.random() < 0.1:
                recs.append((0, 0, pos, 0))              # zero-length
            pos += int(rng.integers(0, 50))
    return recs


def record_rows(seed: int, out_len: int, width: int,
                kinds=RECORD_KINDS):
    """(slots uint8 (N, width), fields): one row of records per kind, the
    fields (kind, arg, dst, len) int32 (N, R) numpy arrays, kind -1 and
    zeros past each row's records; slots random bytes."""
    rng = np.random.default_rng(seed)
    rows = []
    for kind in kinds:
        base = "mixed" if kind in RECORD_ADVERSARIAL else kind
        recs = _record_row(rng, out_len, width, base)
        k = len(recs) // 2
        if kind == "tail":
            recs = recs + [(-1, 0, 0, 0), (1, 10**6, -5, 7), (3, 0, 0, 1)]
        elif kind == "overlap":
            a, b, c, n = recs[k]
            recs[k] = (a, b, c - 1, n)
        elif kind == "far":
            recs.insert(k, (1, recs[k][2] + 1, recs[k][2], 0))
        elif kind == "zero_d":
            recs.insert(k, (1, 0, recs[k][2], 0))
        elif kind == "neg_len":
            recs.insert(k, (0, 0, recs[k][2], -3))
        elif kind == "bad_kind":
            recs.insert(k, (5, 0, recs[k][2], 1))
        elif kind == "past_end":
            recs.append((1, 1, out_len - 2, 5))
        elif kind == "unordered":
            recs[k], recs[k + 1] = recs[k + 1], recs[k]
        rows.append(recs)
    R = max(len(r) for r in rows)
    f = np.zeros((4, len(rows), R), np.int64)
    f[0] = -1
    for i, recs in enumerate(rows):
        f[:, i, :len(recs)] = np.asarray(recs, np.int64).T
    slots = rng.integers(0, 256, (len(rows), width), dtype=np.uint8)
    return slots, tuple(f.astype(np.int32))
