"""The plain reference: a Blosc 1.x chunk reader in Python and NumPy.

It decodes what the benchmark's answers are judged by, and imports
nothing of the program under test, of ``jax`` or of the JAX package: it
reads the chunk format as c-blosc's ``README_CHUNK_FORMAT.rst`` and
``blosc/blosc.c`` (``blosc_d``, ``blosc_run_decompression_with_context``)
lay it out, the blosclz stream as ``blosc/blosclz.c``'s decoder does and
the LZ4 block format as LZ4's ``LZ4_decompress_safe`` does. The stream
decoders are a frozen copy of the port's numpy oracles
(``ops/codecs/blosclz.py``, ``ops/codecs/lz4.py``), rewritten over
``bytearray`` for speed, with the same checks.

Only what the benchmark's configurations write is read: blosclz and LZ4
(LZ4HC shares its wire format) streams, byte shuffle or none, split or
not, memcpyed chunks and a leftover block. Anything else raises
``ChunkError``, as does every malformed chunk, so a reader that
cannot vouch for a chunk never passes it.
"""

from __future__ import annotations

import struct

import numpy as np

HEADER = struct.Struct("<BBBBiii")
FLAG_SHUFFLE = 0x01
FLAG_MEMCPYED = 0x02
FLAG_BITSHUFFLE = 0x04
FLAG_RESERVED = 0x08
FLAG_DONT_SPLIT = 0x10
MAX_SPLITS = 16
MIN_BUFFERSIZE = 128
MAX_OVERHEAD = 16
# compformat (flags >> 5) -> codec name, and the codec format version
# each writes in byte 1 (blosc.h: BLOSC_*_FORMAT, BLOSC_*_VERSION_FORMAT)
COMPFORMATS = {0: "blosclz", 1: "lz4"}
VERSIONLZ = {0: 1, 1: 1}

BLOSCLZ_MAX_DISTANCE = 8191
LZ4_MINMATCH = 4


class ChunkError(ValueError):
    """A chunk the reference cannot read: malformed, or of a kind the
    benchmark never writes."""


def header(chunk: bytes) -> dict:
    """The 16-byte header's fields, with the flag bits spelled out."""
    if len(chunk) < 16:
        raise ChunkError("chunk shorter than its header")
    version, versionlz, flags, typesize, nbytes, blocksize, cbytes = \
        HEADER.unpack_from(chunk)
    return {
        "version": version, "versionlz": versionlz, "flags": flags,
        "typesize": typesize, "nbytes": nbytes, "blocksize": blocksize,
        "cbytes": cbytes,
        "shuffle": bool(flags & FLAG_SHUFFLE),
        "bitshuffle": bool(flags & FLAG_BITSHUFFLE),
        "memcpyed": bool(flags & FLAG_MEMCPYED),
        "dont_split": bool(flags & FLAG_DONT_SPLIT),
        "codec": COMPFORMATS.get(flags >> 5),
    }


def blosclz_decode(src: bytes, maxout: int) -> bytearray:
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
                back = (src[ip] << 8) + src[ip + 1] + BLOSCLZ_MAX_DISTANCE + 1
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
            _copy_match(out, op - back, back, mlen)
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


def lz4_decode(src: bytes, maxout: int) -> bytearray:
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
        mlen += LZ4_MINMATCH
        if op + mlen > maxout:
            raise ChunkError("lz4: match overflows the output")
        _copy_match(out, op - offset, offset, mlen)
    return out


def _copy_match(out: bytearray, ref: int, back: int, mlen: int) -> None:
    """Append mlen bytes copied from ``back`` bytes behind the end, byte
    after byte as the decoders define it: an overlapping match repeats
    its last ``back`` bytes."""
    if back >= mlen:
        out += out[ref:ref + mlen]
    else:
        pattern = out[ref:]
        out += (pattern * (mlen // back + 1))[:mlen]


_DECODERS = {"blosclz": blosclz_decode, "lz4": lz4_decode}


def unshuffle(typesize: int, block: np.ndarray) -> np.ndarray:
    """Undo the byte shuffle (shuffle-generic.h:54-81): the first
    n // typesize * typesize bytes were transposed, the rest copied."""
    n = block.size
    if typesize <= 1:
        return block.copy()
    nel = n // typesize
    out = block.copy()
    out[:nel * typesize] = (
        block[:nel * typesize].reshape(typesize, nel).T.reshape(-1))
    return out


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
    if h["bitshuffle"]:
        raise ChunkError("bitshuffle is not read by the reference")
    codec = h["codec"]
    if codec is None:
        raise ChunkError(f"compformat {h['flags'] >> 5} is not read by "
                             "the reference")
    if h["versionlz"] != VERSIONLZ[h["flags"] >> 5]:
        raise ChunkError("codec format version mismatch")
    decode = _DECODERS[codec]
    nblocks, leftover = divmod(nbytes, blocksize)
    if leftover:
        nblocks += 1
    if 16 + 4 * nblocks > len(chunk):
        raise ChunkError("truncated bstarts")
    bstarts = struct.unpack_from(f"<{nblocks}i", chunk, 16)
    out = np.empty(nbytes, dtype=np.uint8)
    for j, pos in enumerate(bstarts):
        last = bool(leftover) and j == nblocks - 1
        bsize = leftover if last else blocksize
        nsplits = 1
        if (not h["dont_split"] and not last and ts <= MAX_SPLITS
                and blocksize // ts >= MIN_BUFFERSIZE):
            nsplits = ts
        neblock = bsize // nsplits
        parts = []
        for _ in range(nsplits):
            if pos < 16 + 4 * nblocks or pos + 4 > len(chunk):
                raise ChunkError("split offset out of range")
            csize = struct.unpack_from("<i", chunk, pos)[0]
            pos += 4
            if csize < 0 or pos + csize > len(chunk):
                raise ChunkError("split size out of range")
            stream = chunk[pos:pos + csize]
            if csize == neblock:
                parts.append(stream)
            else:
                got = decode(stream, neblock)
                if len(got) != neblock:
                    raise ChunkError(f"{codec}: split decoded to "
                                         f"{len(got)} of {neblock} bytes")
                parts.append(got)
            pos += csize
        block = np.frombuffer(b"".join(parts), dtype=np.uint8)
        if h["shuffle"]:
            block = unshuffle(ts, block)
        out[j * blocksize:j * blocksize + bsize] = block
    return out.tobytes()
