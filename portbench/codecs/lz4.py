"""LZ4: the LZ4 block format as ``LZ4_decompress_safe`` reads it,
compformat 1; LZ4HC writes the same format.

A frozen copy of the port's numpy oracle (``ops/codecs/lz4.py``),
rewritten over ``bytearray`` for speed, with the same checks.
"""

from ._match import copy_match
from ..registry import ChunkError

COMPFORMAT = 1
VERSIONLZ = 1
CNAMES = ("lz4", "lz4hc")
MINMATCH = 4


def decode(src: bytes, maxout: int) -> bytearray:
    """One LZ4 block (LZ4_decompress_safe): sequences of a token (literal
    length high nibble, match length low nibble, 15 extended by 255-runs),
    literals, a 16-bit little-endian offset and the match; the last
    sequence has literals only."""
    n = len(src)
    out = bytearray()
    ip = 0
    while ip < n:
        token = src[ip]
        ip += 1
        litlen = token >> 4
        if litlen == 15:
            while True:
                if ip >= n:
                    raise ChunkError("lz4: truncated literal length")
                c = src[ip]
                ip += 1
                litlen += c
                if c != 255:
                    break
        if ip + litlen > n or len(out) + litlen > maxout:
            raise ChunkError("lz4: literal run out of bounds")
        out += src[ip:ip + litlen]
        ip += litlen
        if ip >= n:
            break
        if ip + 2 > n:
            raise ChunkError("lz4: truncated offset")
        offset = src[ip] | (src[ip + 1] << 8)
        ip += 2
        op = len(out)
        if offset == 0 or offset > op:
            raise ChunkError("lz4: invalid match offset")
        mlen = token & 15
        if mlen == 15:
            while True:
                if ip >= n:
                    raise ChunkError("lz4: truncated match length")
                c = src[ip]
                ip += 1
                mlen += c
                if c != 255:
                    break
        mlen += MINMATCH
        if op + mlen > maxout:
            raise ChunkError("lz4: match overflows the output")
        copy_match(out, op - offset, offset, mlen)
    return out
