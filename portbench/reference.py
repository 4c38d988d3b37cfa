"""The plain reference: a Blosc 1.x chunk reader in Python and NumPy.

It decodes what the benchmark's answers are judged by, and imports
nothing of the program under test, of ``jax`` or of the JAX package: it
reads the chunk format as c-blosc's ``README_CHUNK_FORMAT.rst`` and
``blosc/blosc.c`` (``blosc_d``, ``blosc_run_decompression_with_context``)
lay it out. The stream decoders and the filters it undoes are modules of
their own, found by name: ``portbench/codecs/`` (by the header's
compformat) and ``portbench/filters/`` (by its filter bits).

Only what they read is read: streams of a codec found there, a filter
found there or none, split or not, memcpyed chunks and a leftover block.
Anything else raises ``ChunkError``, as does every malformed chunk, so a
reader that cannot vouch for a chunk never passes it.
"""

from __future__ import annotations

import struct

import numpy as np

from . import codecs, filters
from .registry import ChunkError

HEADER = struct.Struct("<BBBBiii")
FLAG_MEMCPYED = 0x02
FLAG_RESERVED = 0x08
FLAG_DONT_SPLIT = 0x10
# bits 0 and 2: the filter flags (README_CHUNK_FORMAT.rst); which filter
# a value stands for is the filter modules' to say
FILTER_BITS = 0x05
MAX_SPLITS = 16
MIN_BUFFERSIZE = 128
MAX_OVERHEAD = 16


def header(chunk: bytes) -> dict:
    """The 16-byte header's fields, with the flag bits spelled out:
    ``codec`` and ``filter`` name the modules that read the chunk's
    compformat and filter bits, or are None where none does."""
    if len(chunk) < 16:
        raise ChunkError("chunk shorter than its header")
    version, versionlz, flags, typesize, nbytes, blocksize, cbytes = \
        HEADER.unpack_from(chunk)
    codec = codecs.BY_FORMAT.get(flags >> 5)
    filt = filters.BY_FLAG.get(flags & FILTER_BITS)
    return {
        "version": version, "versionlz": versionlz, "flags": flags,
        "typesize": typesize, "nbytes": nbytes, "blocksize": blocksize,
        "cbytes": cbytes,
        "memcpyed": bool(flags & FLAG_MEMCPYED),
        "dont_split": bool(flags & FLAG_DONT_SPLIT),
        "compformat": flags >> 5,
        "codec": None if codec is None else codec.__name__.rpartition(".")[2],
        "filter": None if filt is None else filt.NAME,
    }


def split_table(chunk: bytes, h: dict) -> list:
    """Per block of a chunk that is not memcpyed, its size and its
    splits: [(bsize, [(stream start, csize, neblock), ...]), ...], each
    checked to lie inside the chunk."""
    nbytes, blocksize, ts = h["nbytes"], h["blocksize"], h["typesize"]
    nblocks, leftover = divmod(nbytes, blocksize)
    if leftover:
        nblocks += 1
    if 16 + 4 * nblocks > len(chunk):
        raise ChunkError("truncated bstarts")
    bstarts = struct.unpack_from(f"<{nblocks}i", chunk, 16)
    table = []
    for j, pos in enumerate(bstarts):
        last = bool(leftover) and j == nblocks - 1
        bsize = leftover if last else blocksize
        nsplits = 1
        if (not h["dont_split"] and not last and ts <= MAX_SPLITS
                and blocksize // ts >= MIN_BUFFERSIZE):
            nsplits = ts
        neblock = bsize // nsplits
        splits = []
        for _ in range(nsplits):
            if pos < 16 + 4 * nblocks or pos + 4 > len(chunk):
                raise ChunkError("split offset out of range")
            csize = struct.unpack_from("<i", chunk, pos)[0]
            pos += 4
            if csize < 0 or pos + csize > len(chunk):
                raise ChunkError("split size out of range")
            splits.append((pos, csize, neblock))
            pos += csize
        table.append((bsize, splits))
    return table


def decompress(chunk: bytes) -> bytes:
    """The bytes a chunk holds; raises ChunkError where c-blosc's
    decoder would fail or where the chunk is of a kind not read here."""
    chunk = bytes(chunk)
    h = header(chunk)
    nbytes, blocksize, ts = h["nbytes"], h["blocksize"], h["typesize"]
    if h["version"] != 2 or h["flags"] & FLAG_RESERVED:
        raise ChunkError("unknown chunk version or reserved flag set")
    if h["cbytes"] != len(chunk):
        raise ChunkError(f"cbytes {h['cbytes']} != chunk length "
                         f"{len(chunk)}")
    if nbytes == 0:
        return b""
    if nbytes < 0 or blocksize <= 0 or ts <= 0:
        raise ChunkError("header geometry out of range")
    if h["memcpyed"]:
        if nbytes + MAX_OVERHEAD != len(chunk):
            raise ChunkError("memcpyed chunk with inconsistent sizes")
        return chunk[16:]
    if h["filter"] is None:
        raise ChunkError(f"filter bits {h['flags'] & FILTER_BITS:#x} are "
                         "not read by the reference")
    if h["codec"] is None:
        raise ChunkError(f"compformat {h['compformat']} is not read by "
                         "the reference")
    filt = filters.BY_NAME[h["filter"]]
    codec = codecs.ALL[h["codec"]]
    if h["versionlz"] != codec.VERSIONLZ:
        raise ChunkError("codec format version mismatch")
    out = np.empty(nbytes, dtype=np.uint8)
    for j, (bsize, splits) in enumerate(split_table(chunk, h)):
        parts = []
        for pos, csize, neblock in splits:
            stream = chunk[pos:pos + csize]
            if csize == neblock:
                parts.append(stream)
            else:
                got = codec.decode(stream, neblock)
                if len(got) != neblock:
                    raise ChunkError(f"{h['codec']}: split decoded to "
                                     f"{len(got)} of {neblock} bytes")
                parts.append(got)
        block = np.frombuffer(b"".join(parts), dtype=np.uint8)
        out[j * blocksize:j * blocksize + bsize] = filt.undo(ts, block)
    return out.tobytes()
