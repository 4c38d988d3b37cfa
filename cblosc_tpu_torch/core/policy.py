"""Pure policy functions: blocksize heuristic, block-split decision and
the device encoder's stored-raw policies.

The blocksize table and the split decision are *format-relevant
behavior* (they fix the block geometry and the DONT_SPLIT header bit),
so they reproduce the reference's decision tables exactly (blosc.c:
929-959 split policy, blosc.c:962-1060 blocksize). The device geometry
and the stored-raw policies are the JAX package's defaults, kept
identical so both packages write the same chunk bytes; the port reads
no tuning environment variable.
"""

from __future__ import annotations

from ..format import constants as C

# Codecs "meant for high compression ratios" get doubled block sizes
# (reference HCR() macro, blosc.c:922-925).
_HCR_CODECS = frozenset({C.LZ4HC, C.ZLIB, C.ZSTD})

# clevel -> blocksize multiplier (in units of L1), blosc.c:996-1028.
_CLEVEL_SCALE = {
    0: 0.25,
    1: 0.5,
    2: 1,
    3: 2,
    4: 4,
    5: 4,
    6: 8,
    7: 8,
    8: 8,
    9: 8,
}


def split_block(
    compcode: int,
    typesize: int,
    blocksize: int,
    splitmode: int = C.FORWARD_COMPAT_SPLIT,
) -> bool:
    """Whether blocks are split into ``typesize`` independent sub-streams
    (blosc.c:929-959)."""
    if splitmode == C.ALWAYS_SPLIT:
        return True
    if splitmode == C.NEVER_SPLIT:
        return False
    splittable = (
        typesize <= C.MAX_SPLITS and blocksize // typesize >= C.MIN_BUFFERSIZE
    )
    if splitmode == C.AUTO_SPLIT:
        return compcode in (C.BLOSCLZ, C.SNAPPY) and splittable
    if splitmode == C.FORWARD_COMPAT_SPLIT:
        return compcode != C.ZSTD and splittable
    raise ValueError(f"split mode {splitmode} not supported")


def compute_blocksize(
    clevel: int,
    typesize: int,
    nbytes: int,
    forced_blocksize: int = 0,
    compcode: int = C.BLOSCLZ,
    splitmode: int = C.FORWARD_COMPAT_SPLIT,
) -> int:
    """Choose the internal block size (bytes). Mirrors blosc.c:962-1060."""
    if nbytes < typesize:
        return 1

    blocksize = nbytes

    if forced_blocksize:
        blocksize = min(max(forced_blocksize, C.MIN_BUFFERSIZE), C.MAX_BLOCKSIZE)
    elif nbytes >= C.L1:
        blocksize = C.L1
        if compcode in _HCR_CODECS:
            blocksize *= 2
        try:
            scale = _CLEVEL_SCALE[clevel]
        except KeyError:
            raise ValueError(f"clevel must be 0-9, got {clevel}")
        blocksize = int(blocksize * scale)
        if clevel == 9 and compcode in _HCR_CODECS:
            blocksize *= 2

    # Enlarge the blocksize for splittable codecs (blosc.c:1031-1047).
    if clevel > 0 and split_block(compcode, typesize, blocksize, splitmode):
        blocksize = min(blocksize, 1 << 18)
        blocksize *= typesize
        blocksize = max(blocksize, 1 << 16)
        blocksize = min(blocksize, 1 << 20)

    blocksize = min(blocksize, nbytes)

    # blocksize must be a multiple of typesize (blosc.c:1054-1057).
    if blocksize > typesize:
        blocksize = blocksize // typesize * typesize

    return blocksize


def compute_blocksize_device(
    clevel: int,
    typesize: int,
    nbytes: int,
    forced_blocksize: int = 0,
    compcode: int = C.BLOSCLZ,
    splitmode: int = C.FORWARD_COMPAT_SPLIT,
) -> int:
    """Blocksize for the device pipeline (same format, different tuning):
    8 KB splits at the speed clevels (<= 4), the reference's own
    128 KB / 256 KB split geometry at clevels 5-8 / 9. Any blocksize is
    a conforming chunk, since bstarts make the geometry explicit."""
    if forced_blocksize or nbytes < C.L1:
        return compute_blocksize(
            clevel, typesize, nbytes, forced_blocksize, compcode, splitmode
        )
    if clevel <= 4:
        neblock = 8192
    elif clevel <= 8:
        neblock = 131072
    else:
        neblock = 262144
    nsplits = typesize if split_block(
        compcode, typesize, neblock * typesize, splitmode
    ) else 1
    blocksize = min(neblock * nsplits, C.MAX_BLOCKSIZE, nbytes)
    if blocksize > typesize:
        blocksize = blocksize // typesize * typesize
    return max(blocksize, C.MIN_BUFFERSIZE)


def block_geometry(nbytes: int, blocksize: int) -> tuple[int, int]:
    """Return (nblocks, leftover) for a buffer (blosc.c:1139-1142)."""
    if blocksize <= 0:
        return 0, 0
    nblocks, leftover = divmod(nbytes, blocksize)
    if leftover:
        nblocks += 1
    return nblocks, leftover


def nsplits_encode(dont_split: bool, typesize: int, leftoverblock: bool) -> int:
    """Number of codec sub-streams for one block, encode side
    (blosc.c:627-633)."""
    return 1 if (dont_split or leftoverblock) else typesize


def nsplits_decode(
    dont_split: bool, typesize: int, blocksize: int, leftoverblock: bool
) -> int:
    """Number of codec sub-streams for one block, decode side, with the
    splittability re-check for chunks written before the split flag
    existed (blosc.c:749-757)."""
    if dont_split or leftoverblock:
        return 1
    if typesize <= C.MAX_SPLITS and blocksize // typesize >= C.MIN_BUFFERSIZE:
        return typesize
    return 1


def get_accel(compcode: int, clevel: int) -> int:
    """LZ4 acceleration from clevel (blosc.c:577-587)."""
    if compcode == C.LZ4:
        return 10 - clevel
    return 1


def device_min_bytes_per_iter(clevel: int) -> int:
    """Decode-speed policy for the device encoder's stored-raw rule:
    streams whose estimated decoder iteration count exceeds
    neblock / min_bytes_per_iter are stored raw (see
    gpu.pipeline.compress_blocks). clevel 9 loosens the guard."""
    return 8 if clevel >= 9 else 48


# blosclz's entropy-probe abort thresholds x100 (blosclz.c:432-435).
_MIN_CRATIO_X100 = (0, 200, 150, 120, 120, 120, 120, 115, 110, 100)


def device_min_cratio_x100(clevel: int) -> int:
    return _MIN_CRATIO_X100[max(0, min(clevel, 9))]


def device_mine(clevel: int) -> bool:
    """Whether the device encoder mines a per-row adaptive match
    distance: the ratio levels (>= 5) do, the speed levels do not."""
    return clevel >= 5
