"""Zlib codec via the CPython built-in zlib (native C zlib underneath).

Byte-stream compatible with the reference's one-shot compress2/uncompress
wrappers (blosc/blosc.c:469-496): same underlying library, same level
semantics.
"""

from __future__ import annotations

import zlib


def compress(src, maxout: int, clevel: int) -> bytes:
    out = zlib.compress(bytes(src), clevel)
    if len(out) > maxout:
        return b""
    return out


def decompress(src, maxout: int) -> bytes:
    return zlib.decompress(bytes(src), bufsize=maxout)
