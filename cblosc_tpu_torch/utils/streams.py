"""Raw blosclz streams built token by token from a seed, for parity checks.

Each stream is written straight in the wire format (blosc/blosclz.c:
679-789) beside the bytes it decodes to, so a test or the smoke run can
hold a decoder to both. The kinds cover the grammar's corners:

  near       matches at distances 1..31 (overlapping) and 128..8191
  far        the 31/255 far escape (distances 8192..73727); when the row
             is long enough, the last match reaches exactly 73727 bytes
             back, the oldest byte blosclz can name
  escape     7-escape matches with runs of 8 and 16 or more 255 bytes
  lit32_end  the stream ends with a 32-byte literal exactly at csize

:func:`generated_rows` packs them with error rows: an escape run cut
within 8 bytes of csize (the bytes past csize kept in the row),
one-byte corruptions, and random bytes.
"""

from __future__ import annotations

import numpy as np

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
