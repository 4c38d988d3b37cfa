"""Snappy codec — pure-Python/numpy implementation of the public format.

The reference treats snappy as an optional external codec (wrappers at
blosc/blosc.c:443-467, sources not vendored, default-off per
CMakeLists.txt:24-25). We implement the public Snappy raw format natively
so that golden chunks produced with snappy (compat/blosc-1.*-snappy.cdata)
decode without any external dependency.

Raw format: uvarint uncompressed length, then a tag stream.
  tag & 3 == 0: literal, length-1 in bits 2..7 (59 < len: 1-4 extra
                little-endian length bytes, selector 60..63)
  tag & 3 == 1: copy with 3-bit length (4..11) and 11-bit offset
                (bits 5..7 of tag are offset bits 8..10; one more byte)
  tag & 3 == 2: copy, 6-bit length-1, 2-byte LE offset
  tag & 3 == 3: copy, 6-bit length-1, 4-byte LE offset
"""

from __future__ import annotations

import numpy as np

_HASHLOG = 14
_HASH_MULT = 0x1E35A7BD


def _uvarint_encode(v: int) -> bytes:
    out = bytearray()
    while v >= 0x80:
        out.append((v & 0x7F) | 0x80)
        v >>= 7
    out.append(v)
    return bytes(out)


def _uvarint_decode(s: np.ndarray, ip: int) -> tuple[int, int]:
    v = 0
    shift = 0
    while True:
        if ip >= s.size or shift > 35:
            raise ValueError("bad uvarint")
        b = int(s[ip]); ip += 1
        v |= (b & 0x7F) << shift
        if not b & 0x80:
            return v, ip
        shift += 7


def _u32(a: np.ndarray, i: int) -> int:
    return int(a[i]) | int(a[i + 1]) << 8 | int(a[i + 2]) << 16 | int(a[i + 3]) << 24


def _common_prefix(a: np.ndarray, i: int, j: int, limit: int) -> int:
    if limit <= 0:
        return 0
    d = a[i:i + limit] != a[j:j + limit]
    hit = np.argmax(d)
    return int(hit) if d[hit] else limit


def _emit_literal(out: bytearray, a: np.ndarray, start: int, end: int) -> None:
    n = end - start
    if n == 0:
        return
    if n <= 60:
        out.append((n - 1) << 2)
    else:
        extra = (n - 1).bit_length() + 7 >> 3
        out.append((59 + extra) << 2)
        out += (n - 1).to_bytes(extra, "little")
    out += a[start:end].tobytes()


def _emit_copy(out: bytearray, offset: int, length: int) -> None:
    if offset > 0xFFFF:
        # 4-byte-offset copies (tag type 3)
        while length > 64:
            out.append((63 << 2) | 3)
            out += offset.to_bytes(4, "little")
            length -= 64
        if length:
            out.append(((length - 1) << 2) | 3)
            out += offset.to_bytes(4, "little")
        return
    # split long matches into <=64-byte copies
    while length >= 68:
        out.append((63 << 2) | 2)
        out += offset.to_bytes(2, "little")
        length -= 64
    if length > 64:
        out.append((59 << 2) | 2)  # 60-byte copy leaves >=4 for the tail
        out += offset.to_bytes(2, "little")
        length -= 60
    if 4 <= length <= 11 and offset < 2048:
        out.append(((length - 4) << 2) | ((offset >> 8) << 5) | 1)
        out.append(offset & 255)
    else:
        out.append(((length - 1) << 2) | 2)
        out += offset.to_bytes(2, "little")


def compress(src, maxout: int) -> bytes:
    a = np.frombuffer(bytes(src), dtype=np.uint8)
    n = a.size
    out = bytearray(_uvarint_encode(n))
    htab = np.full(1 << _HASHLOG, -1, dtype=np.int64)
    ip = 0
    anchor = 0
    limit = n - 15
    while ip < limit:
        h = ((_u32(a, ip) * _HASH_MULT) & 0xFFFFFFFF) >> (32 - _HASHLOG)
        cand = int(htab[h])
        htab[h] = ip
        if cand >= 0 and ip - cand <= 0xFFFFFFFF and _u32(a, cand) == _u32(a, ip):
            _emit_literal(out, a, anchor, ip)
            mlen = 4 + _common_prefix(a, ip + 4, cand + 4, n - (ip + 4))
            _emit_copy(out, ip - cand, mlen)
            ip += mlen
            anchor = ip
        else:
            ip += 1
        if len(out) > maxout:
            return b""
    _emit_literal(out, a, anchor, n)
    if len(out) > maxout:
        return b""
    return bytes(out)


def decompress(src, maxout: int) -> bytes:
    s = np.frombuffer(bytes(src), dtype=np.uint8)
    total, ip = _uvarint_decode(s, 0)
    if total > maxout:
        raise ValueError("declared size exceeds output buffer")
    out = np.empty(total, dtype=np.uint8)
    op = 0
    n = s.size
    while ip < n:
        tag = int(s[ip]); ip += 1
        kind = tag & 3
        if kind == 0:
            length = (tag >> 2) + 1
            if length > 60:
                extra = length - 60
                if ip + extra > n:
                    raise ValueError("truncated literal length")
                length = int.from_bytes(bytes(s[ip:ip + extra]), "little") + 1
                ip += extra
            if ip + length > n or op + length > total:
                raise ValueError("literal out of bounds")
            out[op:op + length] = s[ip:ip + length]
            ip += length
            op += length
            continue
        if kind == 1:
            if ip >= n:
                raise ValueError("truncated copy1")
            length = ((tag >> 2) & 7) + 4
            offset = ((tag >> 5) << 8) | int(s[ip])
            ip += 1
        elif kind == 2:
            if ip + 2 > n:
                raise ValueError("truncated copy2")
            length = (tag >> 2) + 1
            offset = int(s[ip]) | int(s[ip + 1]) << 8
            ip += 2
        else:
            if ip + 4 > n:
                raise ValueError("truncated copy4")
            length = (tag >> 2) + 1
            offset = int.from_bytes(bytes(s[ip:ip + 4]), "little")
            ip += 4
        if offset == 0 or offset > op or op + length > total:
            raise ValueError("invalid copy")
        ref = op - offset
        if offset == 1:
            out[op:op + length] = out[ref]
        elif offset >= length:
            out[op:op + length] = out[ref:ref + length]
        else:
            reps = -(-length // offset)
            out[op:op + length] = np.tile(out[ref:op], reps)[:length]
        op += length
    if op != total:
        raise ValueError("size mismatch after decode")
    return out.tobytes()
