"""Device filters: byte-shuffle and bit-shuffle over batched blocks.

PyTorch counterpart of cblosc_tpu/tpu/filters.py (plain tensor code, no
kernel). Byte-shuffle is a batched (nel, typesize) -> (typesize, nel)
transpose; bit-shuffle is the reference's 3-stage pipeline (byte
transpose -> 8x8 bit transpose -> regroup, bitshuffle-generic.h:42-80)
with the 8x8 bit transpose as a SWAR routine on 32-bit words.

Semantics (leftovers, pass-through geometry) match the numpy oracle
``cblosc_tpu_torch.ops.filters_np``, which mirrors blosc/shuffle.c:
367-443. The entry points take batches of equal-sized blocks, uint8
tensors shaped (nblocks, blocksize).
"""

from __future__ import annotations

import torch

from ..format import constants as C
from ..utils import trace


def _check(x: torch.Tensor, typesize: int, bits: bool) -> int:
    if x.dtype != torch.uint8 or x.dim() != 2:
        raise ValueError("expected a uint8 tensor of shape (nblocks, blocksize)")
    quantum = typesize * (8 if bits else 1)
    if x.shape[1] % quantum:
        raise ValueError(
            f"blocksize {x.shape[1]} not a multiple of {quantum}; "
            "route this block through the host filters"
        )
    return x.shape[1] // typesize


# ---------------------------------------------------------------------------
# Byte shuffle
# ---------------------------------------------------------------------------

def shuffle(x: torch.Tensor, typesize: int) -> torch.Tensor:
    """out[b, j*nel + i] = x[b, i*typesize + j] (shuffle-generic.h:32-56)."""
    if typesize <= 1:
        return x
    nel = _check(x, typesize, bits=False)
    b = x.shape[0]
    return x.reshape(b, nel, typesize).transpose(1, 2).reshape(b, -1)


def unshuffle(x: torch.Tensor, typesize: int) -> torch.Tensor:
    if typesize <= 1:
        return x
    nel = _check(x, typesize, bits=False)
    b = x.shape[0]
    return x.reshape(b, typesize, nel).transpose(1, 2).reshape(b, -1)


# ---------------------------------------------------------------------------
# 8x8 bit transpose (SWAR on 32-bit words)
# ---------------------------------------------------------------------------
#
# Groups of 8 bytes packed little-endian into two words A = g0|g1<<8|..
# and B = g4|..|g7<<24; row k of the bit transpose is the byte whose bit
# i equals bit k of g_i:
#
#   row_k = gather_lsb((A >> k) & 0x01010101)        -> bits 0..3
#         | gather_lsb((B >> k) & 0x01010101) << 4   -> bits 4..7
#
# The words are int32 views; the masks keep only original bits, so the
# arithmetic shift's sign fill never reaches the result.

def _gather_lsb(t: torch.Tensor) -> torch.Tensor:
    return (t | (t >> 7) | (t >> 14) | (t >> 21)) & 0xF


def _bit8x8(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a, b: int32 (..., m). Returns uint8 (..., 8, m): the 8 bit-rows."""
    rows = []
    for k in range(8):
        lo = _gather_lsb((a >> k) & 0x01010101)
        hi = _gather_lsb((b >> k) & 0x01010101)
        rows.append((lo | (hi << 4)).to(torch.uint8))
    return torch.stack(rows, dim=-2)


def _as_words(x: torch.Tensor) -> torch.Tensor:
    """uint8 (..., 4k) -> int32 (..., k), little-endian."""
    flat = x.contiguous().reshape(-1).view(torch.int32)
    return flat.reshape(*x.shape[:-1], x.shape[-1] // 4)


# ---------------------------------------------------------------------------
# Bit shuffle
# ---------------------------------------------------------------------------

def bitshuffle(x: torch.Tensor, typesize: int) -> torch.Tensor:
    """Bit-plane transpose; layout matches filters_np.bitshuffle
    (reference pipeline bitshuffle-generic.c:13-139)."""
    nel = _check(x, typesize, bits=True)
    b = x.shape[0]
    p = x.reshape(b, nel, typesize).transpose(1, 2)          # (b, T, nel)
    w = _as_words(p).reshape(b, typesize, nel // 8, 2)
    rows = _bit8x8(w[..., 0], w[..., 1])                     # (b, T, 8, nel//8)
    return rows.reshape(b, -1)


def bitunshuffle(x: torch.Tensor, typesize: int) -> torch.Tensor:
    nel = _check(x, typesize, bits=True)
    b = x.shape[0]
    rows = x.reshape(b, typesize, 8, nel // 8)
    g = rows.transpose(-1, -2)                               # (b, T, nel//8, 8)
    w = _as_words(g).reshape(b, typesize, nel // 8, 2)
    bytes_ = _bit8x8(w[..., 0], w[..., 1])                   # (b, T, 8, nel//8)
    p = bytes_.transpose(-1, -2).reshape(b, typesize, nel)   # element 8m+i
    return p.transpose(1, 2).reshape(b, -1)


# ---------------------------------------------------------------------------
# Dispatch helpers used by the chunk pipeline
# ---------------------------------------------------------------------------

def _with_tail(kernel, typesize: int, x: torch.Tensor, quantum: int) -> torch.Tensor:
    """Run `kernel` on the complete-element body, pass the tail through
    (leftover semantics of shuffle.c:367-443 / filters_np)."""
    body = x.shape[1] // quantum * quantum
    if body == 0:
        return x
    if body == x.shape[1]:
        return kernel(x, typesize)
    return torch.cat([kernel(x[:, :body], typesize), x[:, body:]], dim=1)


def apply_filter(doshuffle: int, typesize: int, x: torch.Tensor) -> torch.Tensor:
    with trace.span("filters.apply"):
        if doshuffle == C.SHUFFLE and typesize > 1:
            return _with_tail(shuffle, typesize, x, typesize)
        if doshuffle == C.BITSHUFFLE:
            # complete elements only; their count must be a multiple of 8
            if (x.shape[1] // typesize) % 8 == 0:
                return _with_tail(bitshuffle, typesize, x, typesize)
            return x  # pass-through geometry (shuffle.c:412-414)
        return x


def undo_filter(doshuffle: int, typesize: int, x: torch.Tensor) -> torch.Tensor:
    with trace.span("filters.undo"):
        if doshuffle == C.SHUFFLE and typesize > 1:
            return _with_tail(unshuffle, typesize, x, typesize)
        if doshuffle == C.BITSHUFFLE:
            if (x.shape[1] // typesize) % 8 == 0:
                return _with_tail(bitunshuffle, typesize, x, typesize)
            return x
        return x
