"""blosclz: c-blosc's own LZ77 codec (``blosc/blosclz.c``), compformat 0.

A frozen copy of the port's numpy oracle (``ops/codecs/blosclz.py``),
rewritten over ``bytearray`` for speed, with the same checks.
"""

from ._match import copy_match
from ..registry import ChunkError

COMPFORMAT = 0
VERSIONLZ = 1
CNAMES = ("blosclz",)
MAX_DISTANCE = 8191


def decode(src: bytes, maxout: int) -> bytearray:
    """One blosclz stream (blosclz.c:679-789): a first literal-run token
    in the low 5 bits of byte 0, then literal tokens (ctrl < 32: ctrl+1
    bytes) and match tokens (length (ctrl >> 5) + 2, extended by 255-runs
    at 7; distance ((ctrl & 31) << 8) + next byte + 1, or a far distance
    in two big-endian bytes after 31/255). A stream may not end on a
    match: such a match is not applied, so the output comes out short."""
    n = len(src)
    out = bytearray()
    if n == 0:
        return out
    token = src[0] & 31
    ip = 1
    while True:
        if token >= 32:
            mlen = (token >> 5) - 1
            dhi = token & 31
            if mlen == 6:
                while True:
                    if ip + 1 >= n:
                        raise ChunkError("blosclz: truncated match length")
                    c = src[ip]
                    ip += 1
                    mlen += c
                    if c != 255:
                        break
            elif ip + 1 >= n:
                raise ChunkError("blosclz: truncated match")
            dlo = src[ip]
            ip += 1
            mlen += 3
            back = (dhi << 8) + dlo + 1
            if dlo == 255 and dhi == 31:
                if ip + 1 >= n:
                    raise ChunkError("blosclz: truncated far distance")
                back = (src[ip] << 8) + src[ip + 1] + MAX_DISTANCE + 1
                ip += 2
            op = len(out)
            if op + mlen > maxout:
                raise ChunkError("blosclz: output overflow")
            if back > op:
                raise ChunkError("blosclz: match before the output")
            if ip >= n:
                break
            token = src[ip]
            ip += 1
            copy_match(out, op - back, back, mlen)
        else:
            llen = token + 1
            if len(out) + llen > maxout:
                raise ChunkError("blosclz: output overflow")
            if ip + llen > n:
                raise ChunkError("blosclz: truncated literals")
            out += src[ip:ip + llen]
            ip += llen
            if ip >= n:
                break
            token = src[ip]
            ip += 1
    return out
