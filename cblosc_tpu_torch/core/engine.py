"""Host block engine: the chunk pieces the byte API needs on the host.

The device pipeline (cblosc_tpu_torch.gpu) runs the full blocks; this
engine runs the leftover block for it (different geometry,
blosc.c:627-633), as the JAX package's device bridge does, and the
whole chunk jobs the device path declines (memcpyed chunks, codecs
without a device encoder, decodes and ``getitem`` ranges the device
declines) where core/backend.py's native engine lacks the codec. Its
codecs come from the registry (models/registry.py): the numpy oracles
of blosclz, LZ4/LZ4HC and snappy, CPython's built-in zlib and libzstd
through ctypes (ops/codecs/).

A frozen `CompressionContext` carries all per-job state; blocks are laid
out in block order (deterministic, like the device's exclusive scan).
"""

from __future__ import annotations

import struct
from dataclasses import dataclass

import numpy as np

from ..format import constants as C
from ..format.header import ChunkHeader, FormatError, make_flags, read_bstarts, validate_header
from ..models import registry
from ..ops import filters_np
from . import policy


@dataclass(frozen=True)
class CompressionContext:
    """All state for one compression job (cf. struct blosc_context,
    blosc.c:89-131, minus the threading fields)."""

    clevel: int
    doshuffle: int
    typesize: int
    nbytes: int
    destsize: int
    compcode: int
    blocksize: int
    nblocks: int
    leftover: int
    splitmode: int
    memcpyed: bool
    dont_split: bool
    flags: int
    versionlz: int
    nthreads: int = 1     # the native engine's pool size; unused here


def build_context(
    clevel: int,
    doshuffle: int,
    typesize: int,
    nbytes: int,
    destsize: int,
    compcode: int,
    forced_blocksize: int = 0,
    splitmode: int = C.FORWARD_COMPAT_SPLIT,
    nthreads: int = 1,
    exact_blocksize: int = 0,
) -> CompressionContext:
    """Validate arguments and fix the chunk geometry
    (initialize_context_compression + write_compression_header,
    blosc.c:1062-1247). exact_blocksize bypasses the blocksize heuristic
    (the device pipeline's own geometry)."""
    if nbytes > C.MAX_BUFFERSIZE:
        raise ValueError(f"input buffer cannot exceed {C.MAX_BUFFERSIZE} bytes")
    if destsize < C.MAX_OVERHEAD:
        raise ValueError(f"output buffer must be at least {C.MAX_OVERHEAD} bytes")
    destsize = min(destsize, nbytes + C.MAX_OVERHEAD)
    if not 0 <= clevel <= 9:
        raise ValueError("clevel must be between 0 and 9")
    if doshuffle not in (C.NOSHUFFLE, C.SHUFFLE, C.BITSHUFFLE):
        raise ValueError("shuffle must be 0, 1 or 2")
    if typesize <= 0:
        raise ValueError("typesize must be positive")
    if typesize > C.MAX_TYPESIZE:
        typesize = 1  # oversized types degrade to a byte stream (blosc.c:1117-1120)

    if exact_blocksize:
        blocksize = min(max(exact_blocksize, 1), C.MAX_BLOCKSIZE, nbytes)
        if blocksize > typesize:
            blocksize = blocksize // typesize * typesize
    else:
        blocksize = policy.compute_blocksize(
            clevel, typesize, nbytes, forced_blocksize, compcode, splitmode
        )
    nblocks, leftover = policy.block_geometry(nbytes, blocksize)

    memcpyed = clevel == 0 or nbytes < C.MIN_BUFFERSIZE
    dont_split = not policy.split_block(compcode, typesize, blocksize, splitmode)
    flags = make_flags(
        doshuffle=doshuffle, memcpyed=memcpyed,
        dont_split=dont_split, compcode=compcode,
    )
    versionlz = C.FORMAT_VERSIONS[C.COMPFORMATS[compcode]]
    return CompressionContext(
        clevel=clevel, doshuffle=doshuffle, typesize=typesize, nbytes=nbytes,
        destsize=destsize, compcode=compcode, blocksize=blocksize,
        nblocks=nblocks, leftover=leftover, splitmode=splitmode,
        memcpyed=memcpyed, dont_split=dont_split, flags=flags,
        versionlz=versionlz, nthreads=nthreads,
    )


def _snappy_maxout(n: int) -> int:
    """snappy_max_compressed_length's bound (blosc.c:640-645): a snappy
    split may exceed neblock."""
    return 32 + n + n // 6


def compress_block(ctx: CompressionContext, src: np.ndarray, j: int) -> bytes | None:
    """Filter + encode one block into its framed byte string
    (role of blosc_c, blosc.c:591-722). Returns None when the block cannot
    be represented within its worst-case budget."""
    bsize = ctx.blocksize if (j < ctx.nblocks - 1 or not ctx.leftover) else ctx.leftover
    leftoverblock = bsize != ctx.blocksize
    block = src[j * ctx.blocksize: j * ctx.blocksize + bsize]

    filtered = filters_np.apply_filter(ctx.doshuffle, ctx.typesize, block)

    codec = registry.get(ctx.compcode)
    nsplits = policy.nsplits_encode(ctx.dont_split, ctx.typesize, leftoverblock)
    neblock = bsize // nsplits
    # worst-case per-block budget: every split stored raw plus its length
    budget = bsize + 4 * ctx.typesize
    out = bytearray()
    for s in range(nsplits):
        maxout = neblock
        if ctx.compcode == C.SNAPPY:
            maxout = _snappy_maxout(neblock)
        remaining = budget - len(out) - 4
        if maxout > remaining:
            maxout = remaining
            if maxout <= 0:
                return None
        stream = filtered[s * neblock:(s + 1) * neblock]
        cdata = codec.compress(stream, maxout, ctx.clevel, not ctx.dont_split)
        cbytes = len(cdata)
        if cbytes == 0 or cbytes == neblock:
            # Incompressible split: store raw (blosc.c:705-714).
            if len(out) + 4 + neblock > budget:
                return None
            out += struct.pack("<i", neblock)
            out += stream.tobytes()
        else:
            out += struct.pack("<i", cbytes)
            out += cdata
    return bytes(out)


def compress_chunk(ctx: CompressionContext, src_bytes) -> bytes:
    """Compress a whole buffer into one serialized chunk on the host.
    Returns b"" when the data is incompressible and does not fit
    destsize (the reference's return-0 contract, blosc.h:167-169)."""
    src = np.frombuffer(bytes(src_bytes), dtype=np.uint8)
    if src.size != ctx.nbytes:
        raise ValueError("source size does not match the context")

    if ctx.memcpyed:
        return _memcpyed_chunk(ctx, src)

    blocks = [compress_block(ctx, src, j) for j in range(ctx.nblocks)]

    ntbytes = 16 + 4 * ctx.nblocks
    bstarts = []
    total = ntbytes
    ok = True
    for enc in blocks:
        if enc is None:
            ok = False
            break
        bstarts.append(total)
        total += len(enc)
    if ok and total <= ctx.destsize:
        hdr = ChunkHeader(
            version=C.VERSION_FORMAT, versionlz=ctx.versionlz, flags=ctx.flags,
            typesize=ctx.typesize & 0xFF, nbytes=ctx.nbytes,
            blocksize=ctx.blocksize, cbytes=total,
        )
        parts = [hdr.encode(), struct.pack(f"<{ctx.nblocks}i", *bstarts)]
        parts += blocks
        return b"".join(parts)

    # Last chance: store verbatim when it fits (blosc.c:1264-1272).
    if ctx.nbytes + C.MAX_OVERHEAD <= ctx.destsize:
        return _memcpyed_chunk(ctx, src)
    return b""


def _memcpyed_chunk(ctx: CompressionContext, src: np.ndarray) -> bytes:
    flags = ctx.flags | C.MEMCPYED
    cbytes = ctx.nbytes + C.MAX_OVERHEAD
    if cbytes > ctx.destsize:
        return b""
    hdr = ChunkHeader(
        version=C.VERSION_FORMAT, versionlz=ctx.versionlz, flags=flags,
        typesize=ctx.typesize & 0xFF, nbytes=ctx.nbytes,
        blocksize=ctx.blocksize, cbytes=cbytes,
    )
    return hdr.encode() + src.tobytes()


def decompress_block(
    hdr: ChunkHeader, chunk: np.ndarray, offset: int, bsize: int,
    leftoverblock: bool,
) -> np.ndarray:
    """Decode + unfilter one block (role of blosc_d, blosc.c:725-800)."""
    codec = registry.get(hdr.compcode)
    nsplits = policy.nsplits_decode(
        hdr.dont_split, hdr.typesize, hdr.blocksize, leftoverblock
    )
    neblock = bsize // nsplits
    out = np.empty(bsize, dtype=np.uint8)
    pos = offset
    csize_total = hdr.cbytes
    for s in range(nsplits):
        if pos < 0 or pos > csize_total - 4:
            raise FormatError("split offset out of range")
        cbytes = struct.unpack_from("<i", chunk, pos)[0]
        pos += 4
        if cbytes < 0 or cbytes > csize_total - pos:
            raise FormatError("split size out of range")
        stream = chunk[pos:pos + cbytes]
        if cbytes == neblock:
            out[s * neblock:(s + 1) * neblock] = stream
        else:
            try:
                raw = codec.decompress(stream, neblock)
            except ValueError as e:
                raise FormatError(str(e))
            if len(raw) != neblock:
                raise FormatError("decoded split has wrong length")
            out[s * neblock:(s + 1) * neblock] = np.frombuffer(raw, dtype=np.uint8)
        pos += cbytes
    return filters_np.undo_filter(
        C.SHUFFLE if hdr.doshuffle else (C.BITSHUFFLE if hdr.dobitshuffle else 0),
        hdr.typesize, out,
    )


def decompress_chunk(chunk_bytes, destsize: int | None = None) -> bytes:
    """Decompress a serialized chunk on the host
    (blosc_run_decompression_with_context, blosc.c:1435-1518)."""
    chunk = np.frombuffer(bytes(chunk_bytes), dtype=np.uint8)
    hdr = ChunkHeader.decode(chunk_bytes)
    if destsize is None:
        destsize = hdr.nbytes
    validate_header(hdr, destsize)
    if hdr.nbytes == 0:
        return b""

    if hdr.memcpyed:
        if chunk.size < 16 + hdr.nbytes:
            raise FormatError("truncated memcpyed chunk")
        return chunk[16:16 + hdr.nbytes].tobytes()

    nblocks, leftover = hdr.nblocks, hdr.leftover
    bstarts = read_bstarts(chunk_bytes, nblocks)
    sizes = [hdr.blocksize] * nblocks
    if leftover:
        sizes[-1] = leftover
    parts = [
        decompress_block(hdr, chunk, bstarts[j], sizes[j],
                         leftoverblock=(sizes[j] != hdr.blocksize))
        for j in range(nblocks)
    ]
    return b"".join(p.tobytes() for p in parts)


def getitem(chunk_bytes, start: int, nitems: int) -> bytes:
    """Partial decompression: items [start, start+nitems)
    (blosc_getitem, blosc.c:1574-1703). Only the blocks that overlap the
    range are decoded; this is what makes a chunk a random-access
    container."""
    chunk = np.frombuffer(bytes(chunk_bytes), dtype=np.uint8)
    hdr = ChunkHeader.decode(chunk_bytes)
    if hdr.version != C.VERSION_FORMAT:
        raise FormatError("chunk format version not supported")
    if hdr.nbytes == 0:
        if start == 0 and nitems == 0:
            return b""
        raise IndexError("getitem range out of bounds")
    if (
        hdr.blocksize <= 0 or hdr.blocksize > hdr.nbytes
        or hdr.blocksize > C.MAX_BLOCKSIZE
        or hdr.typesize <= 0 or hdr.typesize > C.MAX_TYPESIZE
    ):
        raise FormatError("header geometry out of range")
    stop = start + nitems
    ts = hdr.typesize
    if start < 0 or start * ts > hdr.nbytes:
        raise IndexError("`start` out of bounds")
    if stop < 0 or stop * ts > hdr.nbytes:
        raise IndexError("`start` + `nitems` out of bounds")

    if hdr.memcpyed:
        if hdr.nbytes + C.MAX_OVERHEAD != hdr.cbytes:
            raise FormatError("memcpyed chunk with inconsistent sizes")
        return chunk[16 + start * ts:16 + stop * ts].tobytes()

    nblocks, leftover = hdr.nblocks, hdr.leftover
    bstarts = read_bstarts(chunk_bytes, nblocks)
    out = bytearray()
    for j in range(nblocks):
        bsize = hdr.blocksize
        leftoverblock = False
        if j == nblocks - 1 and leftover:
            bsize = leftover
            leftoverblock = True
        startb = start * ts - j * hdr.blocksize
        stopb = stop * ts - j * hdr.blocksize
        if startb >= hdr.blocksize or stopb <= 0:
            continue
        startb = max(startb, 0)
        stopb = min(stopb, hdr.blocksize)
        block = decompress_block(hdr, chunk, bstarts[j], bsize, leftoverblock)
        out += block[startb:stopb].tobytes()
    return bytes(out)
