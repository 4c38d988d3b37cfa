"""zlib: DEFLATE in zlib's wrapper (RFC 1950 and 1951), compformat 3.

Read with Python's standard ``zlib`` module, which shares no code with
the port's device decoder, one shot as c-blosc's ``zlib_wrap_decompress``
(``blosc/blosc.c``) reads a split with zlib's ``uncompress``: the stream
must end (its final block and its adler32, which zlib checks) within the
split, bytes after its end are not read, and the split must decode to
exactly ``maxout`` bytes (blosc_d's ``cbytes != neblock`` check).
"""

import zlib

from ..registry import ChunkError

COMPFORMAT = 3
VERSIONLZ = 1
CNAMES = ("zlib",)


def decode(src: bytes, maxout: int) -> bytes:
    d = zlib.decompressobj()
    try:
        # one byte past maxout tells a stream that decodes too long
        out = d.decompress(src, maxout + 1)
    except zlib.error as e:
        raise ChunkError(f"zlib: {e}") from None
    if len(out) > maxout:
        raise ChunkError("zlib: stream decodes past its split")
    if not d.eof:
        raise ChunkError("zlib: stream ends before its final block")
    if len(out) != maxout:
        raise ChunkError(f"zlib: split decoded to {len(out)} of {maxout} "
                         "bytes")
    return out
