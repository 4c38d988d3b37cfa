"""Host-facing device backend: serialized chunks in, serialized chunks out.

PyTorch counterpart of cblosc_tpu/tpu/host_api.py. Full blocks run on
the device pipeline; the leftover block (different geometry,
blosc.c:627-633) runs through the host engine; the result is
byte-for-byte the chunk the JAX package writes, a conforming chunk
(README_CHUNK_FORMAT.rst) any reader decodes.

``compress_chunk`` and ``decompress_chunk`` return None, and the byte
API takes the host engine, exactly where the JAX bridge does: memcpyed
chunks, no full block, a blocksize that is not a multiple of the split
count, a codec without a device encoder (snappy and zlib compress on
the host), and LZ4, snappy, zlib or zstd chunks whose streams the
device walk rejects even with the escalated budget (foreign geometry;
for zlib also stored blocks and preset dictionaries; for zstd blocks
above 512 KB, decode_cap). One more case goes to the host here: LZ4
splits wider than the device encoder's int32 sort keys allow (about 2
MiB, only with a forced blocksize), which the JAX encoder would write
corrupt (gpu/pipeline.encoder decides). Nothing goes to the host because
a card or a kernel is missing.
"""

from __future__ import annotations

import struct

import numpy as np
import torch

from ..core import engine, policy
from ..format import constants as C
from ..format.header import ChunkHeader, FormatError, read_bstarts, validate_header


def compress_chunk(ctx, data: bytes, device: torch.device) -> bytes | None:
    """Compress via the device pipeline. Returns the chunk, b"" when the
    data is incompressible within destsize, or None for the host."""
    from . import pipeline

    if ctx.memcpyed or ctx.nblocks == 0:
        return None
    # retune geometry for the device encoder when the caller used the
    # default (CPU L1) heuristic; a forced blocksize is respected
    default_bs = policy.compute_blocksize(
        ctx.clevel, ctx.typesize, ctx.nbytes, 0, ctx.compcode, ctx.splitmode
    )
    if ctx.blocksize == default_bs:
        dev_bs = policy.compute_blocksize_device(
            ctx.clevel, ctx.typesize, ctx.nbytes, 0, ctx.compcode,
            ctx.splitmode,
        )
        if dev_bs != ctx.blocksize:
            ctx = engine.build_context(
                ctx.clevel, ctx.doshuffle, ctx.typesize, ctx.nbytes,
                ctx.destsize, ctx.compcode, splitmode=ctx.splitmode,
                exact_blocksize=dev_bs,
            )
    nfull = ctx.nbytes // ctx.blocksize
    if nfull == 0:
        return None
    nsplits = policy.nsplits_encode(ctx.dont_split, ctx.typesize, False)
    if (ctx.blocksize % nsplits
            or pipeline.encoder(ctx.compcode, ctx.blocksize // nsplits) is None):
        return None

    src = np.frombuffer(bytes(data), dtype=np.uint8)
    x = torch.from_numpy(
        src[: nfull * ctx.blocksize].reshape(nfull, ctx.blocksize).copy()
    ).to(device)
    slots, csizes = pipeline.compress_blocks(
        x, ctx.doshuffle, ctx.typesize, nsplits,
        policy.device_min_bytes_per_iter(ctx.clevel), ctx.compcode,
        policy.device_min_cratio_x100(ctx.clevel),
        policy.device_mine(ctx.clevel),
    )
    # body assembly on the device at exclusively-scanned offsets; one
    # fetch of the worst-case body
    neblock = ctx.blocksize // nsplits
    cap = nfull * nsplits * (neblock + 4)    # stored-raw rule caps csize
    body = _compact_body(slots, csizes, cap).cpu().numpy()
    cs_np = csizes.cpu().numpy().astype(np.int64)

    header = 16 + 4 * ctx.nblocks
    blk_sizes = (cs_np.reshape(nfull, nsplits) + 4).sum(axis=1)
    bstarts = header + np.concatenate(([0], np.cumsum(blk_sizes)))
    body_len = int(bstarts[-1]) - header
    total = header + body_len
    bstarts = [int(b) for b in bstarts[:nfull]]

    tail = b""
    if ctx.leftover:
        enc = engine.compress_block(ctx, src, nfull)
        if enc is None:
            return _fallback_memcpy(ctx, src)
        tail = bytes(enc)
        bstarts.append(total)
        total += len(tail)
    if total > ctx.destsize:
        return _fallback_memcpy(ctx, src)
    hdr = ChunkHeader(
        version=C.VERSION_FORMAT, versionlz=ctx.versionlz, flags=ctx.flags,
        typesize=ctx.typesize & 0xFF, nbytes=ctx.nbytes,
        blocksize=ctx.blocksize, cbytes=total,
    )
    return b"".join([
        hdr.encode(), struct.pack(f"<{ctx.nblocks}i", *bstarts),
        body[:body_len].tobytes(), tail,
    ])


def _compact_body(slots, csizes, cap: int):
    from . import pipeline

    per = csizes.to(torch.int64) + 4
    split_off = torch.cumsum(per, 0) - per      # body-relative offsets
    return pipeline.compact_chunk(slots, csizes, split_off, cap)


def _fallback_memcpy(ctx, src: np.ndarray) -> bytes:
    if ctx.nbytes + C.MAX_OVERHEAD <= ctx.destsize:
        return engine._memcpyed_chunk(ctx, src)
    return b""


def _escalated_budget(neblock: int, compcode: int) -> int:
    """Retry budget for token-dense LZ4 and snappy chunks (short matches
    every few bytes: records) and event-dense zlib and zstd chunks
    (events); 0 for blosclz, whose overflow rows decode with the generic
    decoder (K3)."""
    from . import codec_zlib, codec_zstd, structured

    if compcode == C.BLOSCLZ:
        return 0
    if compcode == C.ZLIB:
        return codec_zlib.high_events(neblock)
    if compcode == C.ZSTD:
        return codec_zstd.high_events(neblock)
    return structured.high_records(neblock)


def _split_table(chunk: np.ndarray, bstarts, nsplits: int):
    """Per-split (offset, csize) tables for the selected blocks, scanned
    vectorized across blocks; bounds mirror blosc_d's validation
    (blosc.c:762-770)."""
    clen = chunk.size
    nb = len(bstarts)
    pos = np.asarray(bstarts, dtype=np.int64)
    offs = np.empty((nb, nsplits), dtype=np.int32)
    csizes = np.empty((nb, nsplits), dtype=np.int32)
    for s in range(nsplits):
        if nb and (pos.min() < 0 or pos.max() + 4 > clen):
            raise FormatError("split offset out of range")
        idx = pos[:, None] + np.arange(4)
        cs = chunk[idx].astype(np.int64) @ (1 << (8 * np.arange(4)))
        cs = (cs & 0xFFFFFFFF).astype(np.int64)
        cs = np.where(cs >= 1 << 31, cs - (1 << 32), cs)    # int32 LE
        if nb and ((cs < 0).any() or (pos + 4 + cs > clen).any()):
            raise FormatError("split size out of range")
        offs[:, s] = pos + 4
        csizes[:, s] = cs
        pos = pos + 4 + cs
    return offs.reshape(-1), csizes.reshape(-1)


def decompress_chunk(chunk_bytes, destsize: int | None,
                     device: torch.device) -> bytes | None:
    """Decompress via the device pipeline; None for the host engine."""
    from . import pipeline

    chunk = np.frombuffer(bytes(chunk_bytes), dtype=np.uint8)
    hdr = ChunkHeader.decode(chunk_bytes)
    if destsize is None:
        destsize = hdr.nbytes
    validate_header(hdr, destsize)
    if hdr.nbytes == 0:
        return b""
    if hdr.memcpyed:
        return None
    nblocks, leftover = hdr.nblocks, hdr.leftover
    nfull = nblocks - (1 if leftover else 0)
    if nfull == 0:
        return None
    nsplits = policy.nsplits_decode(
        hdr.dont_split, hdr.typesize, hdr.blocksize, False
    )
    if hdr.blocksize % nsplits:
        return None
    neblock = hdr.blocksize // nsplits

    bstarts = read_bstarts(chunk_bytes, nblocks)
    offs, csizes = _split_table(chunk, bstarts[:nfull], nsplits)

    width = pipeline.decode_slot_width(neblock, hdr.compcode)
    chunk_dev = torch.from_numpy(chunk.copy()).to(device)
    cs_dev = torch.from_numpy(csizes).to(device)
    rows = pipeline.gather_slots(chunk_dev, torch.from_numpy(offs).to(device),
                                 width)
    rows = pipeline.mask_past_csize(rows, cs_dev, width)
    doshuffle = (
        C.SHUFFLE if hdr.doshuffle else (C.BITSHUFFLE if hdr.dobitshuffle else 0)
    )
    blocks, err = pipeline.decompress_blocks(
        rows, cs_dev, neblock, doshuffle, hdr.typesize, nsplits, hdr.compcode,
    )
    if bool(err.any()):
        hi = _escalated_budget(neblock, hdr.compcode)
        if hi:      # token- or event-dense streams: one wider-budget retry
            blocks, err = pipeline.decompress_blocks(
                rows, cs_dev, neblock, doshuffle, hdr.typesize, nsplits,
                hdr.compcode, hi)
        if bool(err.any()):
            if hdr.compcode != C.BLOSCLZ:
                return None  # foreign geometry: the host engine decodes it
            raise FormatError("corrupt blosclz stream (device decode)")
    out = blocks.cpu().numpy().reshape(-1)

    if leftover:
        tail = engine.decompress_block(
            hdr, chunk, bstarts[nfull], leftover, leftoverblock=True
        )
        return out.tobytes() + tail.tobytes()
    return out.tobytes()
