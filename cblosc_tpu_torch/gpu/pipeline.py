"""Device chunk pipeline: filter + encode / decode + unfilter.

PyTorch counterpart of cblosc_tpu/tpu/pipeline.py, the device form of
the reference's block engine hot loop (blosc_c / blosc_d, blosc/blosc.c:
591-800): the whole batch of blocks is one data-parallel program,

    blocks (nblocks, blocksize)
      -> filter (shuffle/bitshuffle)                      [filters.py]
      -> split into (nblocks*nsplits, neblock) streams
      -> encode -> worst-case slots + csizes              [codec.py]
      -> stored-raw rule applied with a select

and the serialized layout is an exclusive scan over the csizes
(deterministic, replacing the reference's arrival-order mutex
reservation, blosc.c:1843-1861). BloscLZ and LZ4/LZ4HC encode and decode
here; snappy, zlib and zstd decode (their chunks are written by the host
engine, as in the JAX package).
"""

from __future__ import annotations

import torch

from . import (codec, codec_lz4, codec_snappy, codec_zlib, codec_zstd,
               filters, structured)
from ..format import constants as C
from ..utils import trace

I32 = torch.int32
U8 = torch.uint8

# Blocks per encode sub-batch: the JAX pipeline encodes 64 MB of blocks
# per program, in encode calls of 64 MB of rows (32 MB when mining), and
# the encoder's small-batch branch (<= 8 rows) depends on that grouping,
# so the port keeps it for byte parity.
_ENCODE_GROUP_BYTES = 64 << 20

# compcodes with a device encoder (LZ4HC chunks carry the LZ4 wire format)
DEVICE_CODECS = (C.BLOSCLZ, C.LZ4, C.LZ4HC)
# and with a device decoder: snappy, zlib and zstd chunks, written by the
# host engine, decode on the device too
DEVICE_DECODE_CODECS = DEVICE_CODECS + (C.SNAPPY, C.ZLIB, C.ZSTD)


def encoder(compcode: int, neblock: int):
    """The device encoder module for splits of neblock bytes, or None
    where the host engine encodes: the codecs outside DEVICE_CODECS, as
    in the JAX package, and LZ4 splits too wide for its int32 sort keys
    (codec_lz4.fits; only a forced blocksize gives them)."""
    if compcode not in DEVICE_CODECS:
        return None
    if compcode == C.BLOSCLZ:
        return codec
    return codec_lz4 if codec_lz4.fits(neblock) else None


def _decoder(compcode: int):
    """decode(slots, csizes, out_len, maxrec_hint) of a compcode."""
    if compcode == C.BLOSCLZ:
        # blosclz rows that overflow the walk budget decode with the
        # generic decoder (K3), so the budget takes no hint
        return lambda sl, cs, n, hint: structured.decode(sl, cs, n)
    if compcode in (C.LZ4, C.LZ4HC):
        return codec_lz4.decode
    if compcode == C.SNAPPY:
        return codec_snappy.decode
    if compcode == C.ZLIB:
        return codec_zlib.decode
    if compcode == C.ZSTD:
        return codec_zstd.decode
    raise ValueError(f"compcode {compcode}: no device decoder")


def _encode_grouped(streams: torch.Tensor, mod, min_cratio_x100: int,
                    mine: bool):
    rows, n = streams.shape
    group_bytes = _ENCODE_GROUP_BYTES // (2 if mine else 1)
    group = max(group_bytes // max(n, 1), 8)

    def encode(s):
        with trace.span("pipeline.encode_group"):
            return mod.encode(s, codec.DISTANCES, min_cratio_x100, mine)

    if rows <= group:
        return encode(streams)
    pad = (-rows) % group
    sp = torch.nn.functional.pad(streams, (0, 0, 0, pad))
    parts = [encode(sp[i:i + group]) for i in range(0, sp.shape[0], group)]
    return tuple(torch.cat([p[k] for p in parts])[:rows] for k in range(3))


def compress_blocks(
    blocks: torch.Tensor, doshuffle: int, typesize: int, nsplits: int,
    min_bytes_per_iter: int = 48, compcode: int = C.BLOSCLZ,
    min_cratio_x100: int = 0, mine: bool = False,
):
    """Filter + encode full blocks on the device.

    blocks: uint8 (nblocks, blocksize) with blocksize % nsplits == 0.
    Returns (slots uint8 (nblocks*nsplits, W), csizes int32) where a
    csize == neblock marks a stored-raw split (blosc.c:705-714) whose
    slot holds the filtered bytes verbatim. Streams whose estimated
    decoder iterations exceed neblock / min_bytes_per_iter are stored
    raw too (0 disables that speed policy). compcode picks the encoder
    (:func:`encoder`); where it has none, this raises ValueError."""
    with trace.span("pipeline.compress_blocks"):
        nblocks, blocksize = blocks.shape
        neblock = blocksize // nsplits
        mod = encoder(compcode, neblock)
        if mod is None:
            raise ValueError(f"no device encoder for compcode {compcode} "
                             f"at {neblock}-byte splits")

        def one_batch(blk):
            filtered = filters.apply_filter(doshuffle, typesize, blk)
            streams = filtered.reshape(blk.shape[0] * nsplits, neblock)
            slots, csizes, est_iters = _encode_grouped(streams, mod,
                                                       min_cratio_x100, mine)
            raw = csizes >= neblock
            if min_bytes_per_iter:
                raw |= est_iters > max(neblock // min_bytes_per_iter, 32)
            csizes = torch.where(raw, neblock, csizes).to(I32)
            slots[raw, :neblock] = streams[raw]
            slots[raw, neblock:] = 0
            return slots, csizes

        bpg = max(_ENCODE_GROUP_BYTES // blocksize, 1)
        if nblocks <= bpg:
            return one_batch(blocks)
        pad = (-nblocks) % bpg
        bp = torch.nn.functional.pad(blocks, (0, 0, 0, pad))
        parts = [one_batch(bp[i:i + bpg])
                 for i in range(0, bp.shape[0], bpg)]
        rows = nblocks * nsplits
        return (torch.cat([p[0] for p in parts])[:rows],
                torch.cat([p[1] for p in parts])[:rows])


def decompress_blocks(
    slots: torch.Tensor,
    csizes: torch.Tensor,
    neblock: int,
    doshuffle: int,
    typesize: int,
    nsplits: int,
    compcode: int = C.BLOSCLZ,
    maxrec_hint: int = 0,
):
    """Decode + unfilter full blocks on the device.

    slots: uint8 (nblocks*nsplits, W >= neblock), each row a stream of
    the compcode's codec (or raw bytes, see below), zero past its csize.
    Returns (blocks uint8 (nblocks, nsplits*neblock), err bool (rows,)).
    maxrec_hint widens the LZ4/snappy walk's record budget or the zlib
    and zstd walks' event budget (the byte API's retry for token-dense
    and event-dense chunks).
    """
    with trace.span("pipeline.decompress_blocks"):
        trace.count("budget", maxrec_hint)
        dec = _decoder(compcode)
        rows = slots.shape[0]
        blocksize = neblock * nsplits
        # stored-raw rule: csize == neblock marks a raw split
        # (blosc.c:705-714); a compressed snappy split may exceed neblock
        # (its maxout is 32 + n + n/6, blosc.c:640-645), so only equality
        # marks it raw
        if compcode == C.SNAPPY:
            raw = csizes == neblock
        else:
            raw = csizes >= neblock
        dec_cs = torch.where(raw, 0, csizes).to(I32)
        # decode in 64 MB block groups to bound the workspace
        group = max(_ENCODE_GROUP_BYTES // max(blocksize, 1), 1) * nsplits
        outs, errs = [], []
        for i in range(0, rows, group):
            sl, cs = slots[i:i + group], dec_cs[i:i + group]
            rw = raw[i:i + group]
            with trace.span("pipeline.decode_group"):
                decoded, produced, err = dec(sl, cs, neblock, maxrec_hint)
            streams = torch.where(rw[:, None], sl[:, :neblock], decoded)
            errs.append(torch.where(rw, False, err | (produced != neblock)))
            blk = streams.reshape(sl.shape[0] // nsplits, blocksize)
            outs.append(filters.undo_filter(doshuffle, typesize, blk))
        if not outs:
            dev = slots.device
            return (torch.zeros((0, blocksize), dtype=U8, device=dev),
                    torch.zeros(0, dtype=torch.bool, device=dev))
        return torch.cat(outs), torch.cat(errs)


def decode_slot_width(neblock: int, compcode: int = C.BLOSCLZ) -> int:
    """Gather width covering any conforming split stream: blosclz, LZ4,
    zlib and zstd splits never exceed neblock (their maxout is neblock;
    bigger is stored raw), a compressed snappy split may reach
    32 + n + n/6."""
    if compcode == C.SNAPPY:
        return neblock + neblock // 6 + 64
    return neblock + 64


def gather_slots(chunk: torch.Tensor, offsets: torch.Tensor,
                 width: int) -> torch.Tensor:
    """Slice per-split streams out of a serialized chunk on the device.
    chunk: uint8 (clen,); offsets: (rows,) byte offsets. Returns uint8
    (rows, width); the caller masks bytes past each csize."""
    clen = chunk.shape[0]
    idx = offsets.to(torch.int64)[:, None] + torch.arange(
        width, device=chunk.device)[None, :]
    return chunk[torch.clamp(idx, 0, clen - 1)]


def mask_past_csize(rows: torch.Tensor, csizes: torch.Tensor,
                    width: int) -> torch.Tensor:
    keep = torch.arange(width, device=rows.device)[None, :] < csizes[:, None]
    return torch.where(keep, rows, 0)


def layout_chunk(csizes: torch.Tensor, nblocks: int, nsplits: int):
    """Serialized layout from per-split csizes: (bstarts int32 (nblocks,),
    split_off int32 (rows,), total). Split r's payload goes at
    split_off[r] + 4, after its little-endian length word; offsets are
    absolute (header and bstarts table included)."""
    per_split = csizes.to(torch.int64).reshape(nblocks, nsplits) + 4
    per_block = per_split.sum(dim=1)
    header = 16 + 4 * nblocks
    bstarts = header + torch.cumsum(per_block, 0) - per_block
    flat = per_split.reshape(-1)
    split_off = header + torch.cumsum(flat, 0) - flat
    total = header + per_block.sum()
    return bstarts.to(I32), split_off.to(I32), total


def compact_chunk(slots: torch.Tensor, csizes: torch.Tensor,
                  split_off: torch.Tensor, out_cap: int) -> torch.Tensor:
    """Scatter framed split streams ([int32 LE csize][payload]) to their
    offsets; returns uint8 (out_cap,). Bytes past a row's frame go to a
    sentinel position past out_cap, which is cut off."""
    rows, W = slots.shape
    dev = slots.device
    cs = csizes.to(torch.int64)[:, None]
    le = torch.cat([(cs >> s) & 0xFF for s in (0, 8, 16, 24)], dim=1).to(U8)
    framed = torch.cat([le, slots], dim=1)
    pos = torch.arange(W + 4, device=dev)[None, :]
    dest = torch.where(pos < cs + 4,
                       split_off.to(torch.int64)[:, None] + pos, out_cap)
    dest = torch.clamp(dest, max=out_cap)
    out = torch.zeros(out_cap + 1, dtype=U8, device=dev)
    out[dest.reshape(-1)] = framed.reshape(-1)
    return out[:out_cap]
