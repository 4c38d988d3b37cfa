"""Raw blosclz, LZ4 and snappy streams built token by token from a seed,
for parity checks.

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
(their kinds are listed there).
"""

from __future__ import annotations

import struct

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
