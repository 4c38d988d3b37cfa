"""Multi-device block parallelism over a torch.distributed process group.

PyTorch counterpart of cblosc_tpu/parallel/engine.py. The reference
scales with an intra-process pthread pool (blosc.c:1769-1861); here one
process drives one device (SPMD):

  * the block axis is split over the ranks of a ``DeviceMesh`` with the
    dimension name ``"blocks"`` (``("blocks", "splits")`` for the 2-D
    form); each rank filters and encodes its contiguous slice of blocks;
  * the output layout is not reserved under a lock: the per-split
    compressed sizes are all-gathered and the byte offsets are an
    exclusive scan over them, the same on every rank (deterministic and
    order-preserving);
  * decompression needs no communication until the end: every rank
    decodes its slice of blocks from the replicated chunk bytes.

The caller starts the process group (``init_process_group``: NCCL with
one card per rank, or gloo on the CPU); :func:`make_mesh` builds the
mesh over it and never starts one itself. The mesh's device type
decides where tensors live: ``cuda:{rank % device_count}`` under NCCL,
set by :func:`make_mesh`, the CPU under gloo. The ``*_blocks_sharded``
and ``training_step*`` calls take and return each rank's own slice; the
byte API (:func:`compress_chunk`, :func:`decompress_chunk`) takes the
whole input on every rank and returns the whole result on every rank.
"""

from __future__ import annotations

import struct

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from ..core import engine, policy
from ..format import constants as C
from ..format.header import ChunkHeader, read_bstarts
from ..gpu import codec, filters, pipeline, structured
from ..gpu.host_api import _doshuffle, _split_table

BLOCKS = "blocks"
SPLITS = "splits"

_DEVICE_TYPES = {"nccl": "cuda", "gloo": "cpu"}
# all_gather_into_tensor under its newer name where torch has it
_gather_into = getattr(dist, "all_gather_single", None) or \
    dist.all_gather_into_tensor


def _world() -> tuple[int, str]:
    """(world size, device type) of the started process group."""
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError(
            "the sharded engine needs a started torch.distributed process "
            "group (init_process_group); it does not start one itself")
    backend = str(dist.get_backend())
    if backend not in _DEVICE_TYPES:
        raise ValueError(f"process group backend {backend!r}: the sharded "
                         "engine runs on nccl (cuda) or gloo (cpu)")
    dtype = _DEVICE_TYPES[backend]
    if dtype == "cuda":
        # the rank's card, set explicitly before the mesh is built
        torch.cuda.set_device(dist.get_rank() % torch.cuda.device_count())
    return dist.get_world_size(), dtype


def _check_size(n_devices, world: int) -> None:
    if n_devices is not None and n_devices != world:
        raise ValueError(f"a mesh of {n_devices} devices needs a process "
                         f"group of that size, not {world}")


def make_mesh(n_devices: int | None = None) -> DeviceMesh:
    """1-D mesh over the block axis, one rank per device. n_devices, if
    given, must equal the process group's size."""
    world, dtype = _world()
    _check_size(n_devices, world)
    return init_device_mesh(dtype, (world,), mesh_dim_names=(BLOCKS,))


def make_mesh_2d(n_devices: int | None = None,
                 splits_axis: int = 2) -> DeviceMesh:
    """2-D mesh: blocks x splits, the splits axis halved until it divides
    the world (as the JAX package halves it). Sharding the split axis
    places a block's sub-streams on different devices."""
    world, dtype = _world()
    _check_size(n_devices, world)
    while world % splits_axis:
        splits_axis //= 2
    return init_device_mesh(dtype, (world // splits_axis, splits_axis),
                            mesh_dim_names=(BLOCKS, SPLITS))


def _device(mesh: DeviceMesh) -> torch.device:
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def _size(mesh: DeviceMesh, dim: str) -> int:
    return mesh.size(mesh.mesh_dim_names.index(dim))


def _all_gather(t: torch.Tensor, mesh: DeviceMesh, dim: str) -> torch.Tensor:
    """Concatenate the ranks' equal-shaped tensors along dim 0, in the
    order of their coordinate on the mesh dimension."""
    t = t.contiguous()
    out = torch.empty((_size(mesh, dim) * t.shape[0],) + tuple(t.shape[1:]),
                      dtype=t.dtype, device=t.device)
    _gather_into(out, t, group=mesh.get_group(dim))
    return out


def _nblocks(local: torch.Tensor, mesh: DeviceMesh) -> int:
    """The global block count; every rank must hold the same slice size
    (collectives need equal shapes)."""
    ndev = _size(mesh, BLOCKS)
    counts = _all_gather(torch.tensor([local.shape[0]], dtype=torch.int64,
                                      device=local.device), mesh, BLOCKS)
    counts = counts.tolist()
    nblocks = sum(counts)
    if nblocks % ndev:
        raise ValueError(f"nblocks {nblocks} not divisible by mesh size {ndev}")
    if len(set(counts)) != 1:
        raise ValueError(f"the ranks hold unequal block slices {counts}")
    return nblocks


def compress_blocks_sharded(blocks: torch.Tensor, doshuffle: int,
                            typesize: int, nsplits: int, mesh: DeviceMesh,
                            compcode: int = C.BLOSCLZ):
    """Compress this rank's slice of equal-size blocks.

    blocks: uint8 (nlocal, blocksize), the same nlocal on every rank.
    Returns (slots uint8 (nlocal*nsplits, W), csizes int32, split_off
    int32, the absolute chunk offsets of this rank's framed splits, and
    total, the chunk size, equal on every rank)."""
    nblocks = _nblocks(blocks, mesh)
    header = 16 + 4 * nblocks
    slots, csizes = pipeline.compress_blocks(
        blocks, doshuffle, typesize, nsplits, 48, compcode)
    # the layout: all-gather the sizes, then an exclusive scan (replaces
    # the reference's mutex reservation, blosc.c:1843-1861)
    framed = _all_gather(csizes, mesh, BLOCKS).to(torch.int64) + 4
    starts = header + torch.cumsum(framed, 0) - framed
    total = header + framed.sum()
    rows = csizes.shape[0]
    my = mesh.get_local_rank(BLOCKS)
    split_off = starts[my * rows:(my + 1) * rows].to(torch.int32)
    return slots, csizes, split_off, total


def decompress_blocks_sharded(chunk: torch.Tensor, offs: torch.Tensor,
                              csizes: torch.Tensor, neblock: int,
                              doshuffle: int, typesize: int, nsplits: int,
                              mesh: DeviceMesh, compcode: int = C.BLOSCLZ):
    """Decode this rank's slice of a chunk's full blocks.

    chunk: uint8 (clen,), the whole chunk on every rank; offs/csizes:
    int32 (rows,), this rank's splits. Returns (blocks uint8 (nlocal,
    blocksize), err bool (rows,)), this rank's."""
    width = pipeline.decode_slot_width(neblock, compcode)
    rows = pipeline.gather_slots(chunk, offs, width)
    rows = pipeline.mask_past_csize(rows, csizes, width)
    return pipeline.decompress_blocks(rows, csizes, neblock, doshuffle,
                                      typesize, nsplits, compcode)


def training_step(blocks: torch.Tensor, doshuffle: int, typesize: int,
                  nsplits: int, mesh: DeviceMesh):
    """One sharded round trip (compress -> layout -> decompress) of this
    rank's blocks. Returns (blocks, err, total)."""
    slots, csizes, _, total = compress_blocks_sharded(
        blocks, doshuffle, typesize, nsplits, mesh)
    neblock = blocks.shape[1] // nsplits
    rows = pipeline.mask_past_csize(slots, csizes, slots.shape[1])
    out, err = pipeline.decompress_blocks(rows, csizes, neblock, doshuffle,
                                          typesize, nsplits)
    return out, err, total


def training_step_2d(blocks: torch.Tensor, doshuffle: int, typesize: int,
                     nsplits: int, mesh: DeviceMesh):
    """A round trip over a 2-D (blocks x splits) mesh.

    blocks: this rank's block slice (the ranks of one blocks coordinate
    hold the same slice). The filter runs on the block slice; each
    splits coordinate then encodes and decodes its nsplits / s splits of
    every block, and the decoded streams are all-gathered over the
    splits axis before the unfilter. Returns (this rank's blocks, err
    bool (nlocal, nsplits / s) of this rank's splits, total)."""
    nb, blocksize = blocks.shape
    neblock = blocksize // nsplits
    s = _size(mesh, SPLITS)
    if nsplits % s:
        raise ValueError(f"nsplits {nsplits} not divisible by the splits "
                         f"axis {s}")
    nblocks = nb * _size(mesh, BLOCKS)
    header = 16 + 4 * nblocks
    ns = nsplits // s
    p = mesh.get_local_rank(SPLITS)

    filtered = filters.apply_filter(doshuffle, typesize, blocks)
    # the reshard over the splits axis is a local slice: every rank of a
    # blocks coordinate holds the whole filtered block slice
    flat = filtered.reshape(nb, nsplits, neblock)[:, p * ns:(p + 1) * ns]
    flat = flat.reshape(nb * ns, neblock)
    slots, csizes, _ = codec.encode(flat)
    raw = csizes >= neblock                  # stored-raw rule
    csizes = torch.where(raw, neblock, csizes).to(torch.int32)
    slots[raw, :neblock] = flat[raw]
    slots[raw, neblock:] = 0
    # the layout's sizes over both axes
    all_cs = _all_gather(_all_gather(csizes, mesh, SPLITS), mesh, BLOCKS)
    total = header + (all_cs.to(torch.int64) + 4).sum()

    W = slots.shape[1]
    rows = pipeline.mask_past_csize(slots, csizes, W)
    out, produced, err = structured.decode(
        rows, torch.where(raw, 0, csizes), neblock)
    out = torch.where(raw[:, None], rows[:, :neblock], out)
    err = torch.where(raw, False, err | (produced != neblock))

    # gather the splits back per block, then unfilter
    streams = _all_gather(out.reshape(1, nb, ns, neblock), mesh, SPLITS)
    streams = streams.permute(1, 0, 2, 3).reshape(nb, blocksize)
    return (filters.undo_filter(doshuffle, typesize, streams),
            err.reshape(nb, ns), total)


# ---------------------------------------------------------------------------
# Sharded byte API: serialized chunks in and out over the mesh
# ---------------------------------------------------------------------------

def compress_chunk(clevel: int, doshuffle: int, typesize: int, data: bytes,
                   mesh: DeviceMesh, compcode: int = C.BLOSCLZ) -> bytes:
    """bytes -> sharded pipeline -> serialized chunk, on every rank.

    The full blocks of the mesh-divisible prefix compress across the
    mesh, each rank compacting its contiguous body segment on its
    device; the segments go to every rank (lengths all-gathered, padded
    to the longest, all-gathered, trimmed). The remaining blocks and the
    leftover block run through the host engine, as the reference's
    serial tail does. No mining and no minimum ratio at any clevel, as
    in the JAX package: the chunk may differ from ``compress_ctx``'s,
    and both are valid."""
    nbytes = len(data)
    destsize = nbytes + C.MAX_OVERHEAD
    ctx = engine.build_context(
        clevel, doshuffle, typesize, nbytes, destsize, compcode,
        exact_blocksize=policy.compute_blocksize_device(
            clevel, typesize, nbytes, 0, compcode),
    )
    if (ctx.memcpyed or ctx.nblocks == 0
            or ctx.compcode not in pipeline.DEVICE_CODECS):
        return engine.compress_chunk(ctx, data)
    nsplits = policy.nsplits_encode(ctx.dont_split, ctx.typesize, False)
    if (ctx.blocksize % nsplits
            or pipeline.encoder(ctx.compcode, ctx.blocksize // nsplits) is None):
        return engine.compress_chunk(ctx, data)
    ndev = _size(mesh, BLOCKS)
    nfull = ctx.nbytes // ctx.blocksize
    ndevb = nfull - nfull % ndev
    src = np.frombuffer(bytes(data), dtype=np.uint8)

    parts: list[bytes] = []
    bstarts: list[int] = []
    pos = 16 + 4 * ctx.nblocks

    if ndevb:
        lb = ndevb // ndev
        my = mesh.get_local_rank(BLOCKS)
        x = torch.from_numpy(src[my * lb * ctx.blocksize:
                                 (my + 1) * lb * ctx.blocksize]
                             .reshape(lb, ctx.blocksize).copy()
                             ).to(_device(mesh))
        slots, csizes, split_off, _ = compress_blocks_sharded(
            x, ctx.doshuffle, ctx.typesize, nsplits, mesh, ctx.compcode)
        cap = csizes.shape[0] * (slots.shape[1] + 4)
        seg = pipeline.compact_chunk(slots, csizes, split_off - split_off[0],
                                     cap)
        cs_all = _all_gather(csizes, mesh, BLOCKS)
        seg_len = (csizes.to(torch.int64) + 4).sum().reshape(1)
        lens = _all_gather(seg_len, mesh, BLOCKS).tolist()
        longest = max(lens)
        segs = _all_gather(seg[:longest], mesh, BLOCKS).cpu().numpy()
        blk_sizes = (cs_all.cpu().numpy().astype(np.int64)
                     .reshape(ndevb, nsplits) + 4).sum(axis=1)
        for j in range(ndevb):
            bstarts.append(pos)
            pos += int(blk_sizes[j])
        for d, n in enumerate(lens):
            parts.append(segs[d * longest:d * longest + n].tobytes())

    for j in range(ndevb, ctx.nblocks):
        enc = engine.compress_block(ctx, src, j)
        if enc is None:
            return engine.compress_chunk(ctx, data)   # incompressible
        bstarts.append(pos)
        pos += len(enc)
        parts.append(enc)

    if pos > destsize:
        return engine.compress_chunk(ctx, data)
    hdr = ChunkHeader(
        version=C.VERSION_FORMAT, versionlz=ctx.versionlz, flags=ctx.flags,
        typesize=ctx.typesize & 0xFF, nbytes=ctx.nbytes,
        blocksize=ctx.blocksize, cbytes=pos,
    )
    return b"".join(
        [hdr.encode(), struct.pack(f"<{ctx.nblocks}i", *bstarts)] + parts)


def decompress_chunk(chunk_bytes: bytes, mesh: DeviceMesh) -> bytes:
    """Serialized chunk -> sharded decode -> bytes, on every rank: each
    rank decodes its contiguous slice of the mesh-divisible full blocks
    (the reference's static partition, blosc.c:1777-1791), the slices
    are all-gathered, and the remaining blocks run on the host engine.
    Any device error sends the whole chunk to the host engine, as in the
    JAX package (no wider-budget retry here)."""
    chunk = np.frombuffer(bytes(chunk_bytes), dtype=np.uint8)
    hdr = ChunkHeader.decode(chunk_bytes)
    if (hdr.memcpyed or hdr.nbytes == 0
            or hdr.compcode not in pipeline.DEVICE_DECODE_CODECS):
        return engine.decompress_chunk(bytes(chunk_bytes), hdr.nbytes)
    nsplits = policy.nsplits_decode(
        hdr.dont_split, hdr.typesize, hdr.blocksize, False)
    if hdr.blocksize % nsplits:
        return engine.decompress_chunk(bytes(chunk_bytes), hdr.nbytes)
    neblock = hdr.blocksize // nsplits
    ndev = _size(mesh, BLOCKS)
    nfull = hdr.nblocks - (1 if hdr.leftover else 0)
    ndevb = nfull - nfull % ndev

    bstarts = read_bstarts(chunk_bytes, hdr.nblocks)
    offs, csizes = _split_table(chunk, bstarts[:ndevb], nsplits)

    out_parts = []
    if ndevb:
        dev = _device(mesh)
        lrows = ndevb * nsplits // ndev
        my = mesh.get_local_rank(BLOCKS)
        sl = slice(my * lrows, (my + 1) * lrows)
        blocks, err = decompress_blocks_sharded(
            torch.from_numpy(chunk.copy()).to(dev),
            torch.from_numpy(offs[sl]).to(dev),
            torch.from_numpy(csizes[sl]).to(dev),
            neblock, _doshuffle(hdr), hdr.typesize, nsplits, mesh,
            hdr.compcode)
        bad = err.any().reshape(1).to(torch.uint8)
        if bool(_all_gather(bad, mesh, BLOCKS).any()):
            return engine.decompress_chunk(bytes(chunk_bytes), hdr.nbytes)
        out_parts.append(_all_gather(blocks.reshape(-1), mesh, BLOCKS)
                         .cpu().numpy().tobytes())
    for j in range(ndevb, hdr.nblocks):
        bsize = hdr.blocksize
        lob = False
        if j == hdr.nblocks - 1 and hdr.leftover:
            bsize = hdr.leftover
            lob = True
        out_parts.append(engine.decompress_block(
            hdr, chunk, bstarts[j], bsize, leftoverblock=lob).tobytes())
    return b"".join(out_parts)
