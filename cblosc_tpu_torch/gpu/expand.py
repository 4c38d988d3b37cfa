"""Expand: compacted records -> output bytes, per row.

PyTorch/CUDA counterpart of cblosc_tpu/tpu/expand.py. On a CUDA tensor
:func:`expand` launches the hand-written kernel (csrc/expand.cu, one CTA
per row); on a CPU tensor it runs :func:`_expand_plain`, the same
function in plain PyTorch. Both follow the clamping rule documented in
csrc/expand.cu, so adversarial records never read or write outside
their row. The kernel places a well-formed row (:func:`_well_formed`)
by pointer jumping and any other row record by record;
:func:`_expand_jump_plain` is that split in plain PyTorch, for the
tests.

Record kinds (records compacted valid-first; kind < 0 stops a row):
  [0, src, dst, len]              literal copy from the compressed row
  [1, dist, dst, len]             match fill, distance per record
  [(nb<<4)|2, b0-3, dst, b4-7]    nb <= 8 immediate bytes
"""

from __future__ import annotations

import torch

from . import kernels

MAX_OUT = 1 << 19       # largest row the structured decode places


def _as_fields(recs):
    """Records as a field tuple (kind, arg, dst, len) of (N, R) int32
    tensors, the only form the port takes."""
    if not isinstance(recs, (tuple, list)) or len(recs) != 4:
        raise TypeError("records must be a (kind, arg, dst, len) tuple")
    return tuple(recs)


def compact_records(recs):
    """Move valid records (kind >= 0) to the front, preserving order."""
    rf = _as_fields(recs)
    key = (rf[0] < 0).to(torch.int8)
    order = torch.sort(key, dim=1, stable=True).indices
    return tuple(torch.gather(f, 1, order) for f in rf)


def expand(slots: torch.Tensor, recs, out_len: int,
           stats: torch.Tensor | None = None) -> torch.Tensor:
    """Materialize rows from compacted records.

    slots: uint8 (N, W) compressed rows; recs: COMPACTED records as a
    field tuple of int32 (N, R) tensors.
    Returns uint8 (N, out_len), zero where no record writes. stats, an
    int32 (N,) tensor on the slots' device, receives per row -1 when the
    row took the per-record loop (it is not well formed), else its
    pointer-jumping rounds: the kernel's largest over its windows (each
    round in place, so a round may move a pointer more than one hop),
    the plain split's over the whole row."""
    rf = tuple(f.contiguous() for f in _as_fields(recs))
    if not slots.is_cuda:
        if stats is not None:
            stats.copy_(_expand_jump_plain(slots, rf, out_len)[1])
        return _expand_plain(slots, rf, out_len)
    N, W = slots.shape
    kernels.require(slots, "slots", torch.uint8, 2)
    for f in rf:
        kernels.require(f, "records", torch.int32, 2)
        if f.shape[0] != N or f.shape != rf[0].shape or f.device != slots.device:
            raise ValueError("records must be (N, R) on the slots' device")
    R = rf[0].shape[1]
    if stats is not None:
        kernels.require(stats, "stats", torch.int32, 1)
        if stats.shape[0] != N or stats.device != slots.device:
            raise ValueError("stats must be (N,) on the slots' device")
    out = torch.zeros((N, out_len), dtype=torch.uint8, device=slots.device)
    fn = kernels.fn("expand")
    code = fn(slots.data_ptr(), N, W, rf[0].data_ptr(), rf[1].data_ptr(),
              rf[2].data_ptr(), rf[3].data_ptr(), R, out.data_ptr(), out_len,
              0 if stats is None else stats.data_ptr(),
              kernels.stream_ptr(slots))
    kernels.check("expand", code)
    return out


def _expand_plain(slots: torch.Tensor, rf, out_len: int) -> torch.Tensor:
    """The kernel's function in plain PyTorch: records in order (one
    record index per step, batched across rows), same clamping rule."""
    N, W = slots.shape
    dev = slots.device
    kind, arg, dst, ln = (f.to(torch.int64) for f in rf)
    R = kind.shape[1]
    out = torch.zeros((N, out_len), dtype=torch.uint8, device=dev)
    if N == 0 or out_len == 0:
        return out
    done = torch.zeros(N, dtype=torch.bool, device=dev)
    rows_all = torch.arange(N, device=dev)
    for k in range(R):
        kd = kind[:, k]
        done |= kd < 0
        act = ~done
        if not bool(act.any()):
            break
        rows = rows_all[act]
        kd, a = kd[act], arg[act, k]
        d0 = dst[act, k].clamp(0, out_len)
        lf = ln[act, k]
        low = kd & 0xF
        L = torch.minimum(lf.clamp(min=0), out_len - d0)
        # literal and match writes: one (rows, maxL) batch
        lm = (low == 0) | (low == 1)
        Lw = torch.where(lm, L, torch.zeros_like(L))
        maxl = int(Lw.max()) if Lw.numel() else 0
        if maxl > 0:
            j = torch.arange(maxl, device=dev)[None, :]
            valid = j < Lw[:, None]
            pos = (d0[:, None] + j).clamp(max=out_len - 1)
            s = a[:, None] + j
            litv = torch.where(
                (s >= 0) & (s < W),
                slots[rows[:, None], s.clamp(0, W - 1)],
                torch.zeros((), dtype=torch.uint8, device=dev))
            d = a.clamp(max=out_len).clamp(min=1)[:, None]
            p = d0[:, None] - d + torch.remainder(j, d)
            matv = torch.where(
                p >= 0, out[rows[:, None], p.clamp(min=0)],
                torch.zeros((), dtype=torch.uint8, device=dev))
            val = torch.where((low == 0)[:, None], litv, matv)
            rr = rows[:, None].expand_as(pos)
            out[rr[valid], pos[valid]] = val[valid]
        # immediate bytes
        ins = low == 2
        if bool(ins.any()):
            nb = (kd[ins] >> 4).clamp(0, 8)
            j = torch.arange(8, device=dev)[None, :]
            pos = d0[ins][:, None] + j
            valid = (j < nb[:, None]) & (pos < out_len)
            w = torch.where(j < 4, a[ins][:, None], lf[ins][:, None])
            byte = ((w >> (8 * (j & 3))) & 0xFF).to(torch.uint8)
            rr = rows[ins][:, None].expand_as(pos)
            out[rr[valid], pos[valid]] = byte[valid]
    return out


def _extents(rf):
    """(valid, low nibble, extent start, extent length) per record, int64:
    valid marks the records before a row's first kind < 0; an
    immediate's extent is its byte count, any other record's its len."""
    kind, arg, dst, ln = (f.to(torch.int64) for f in rf)
    valid = torch.cumprod((kind >= 0).to(torch.int64), dim=1).bool()
    low = kind & 0xF
    n = torch.where(low == 2, (kind >> 4).clamp(0, 8), ln)
    return valid, low, dst, n


def _well_formed(rf, out_len: int) -> torch.Tensor:
    """bool (N,): the row's valid records have kinds 0-2, extents [dst,
    dst + n) in order, disjoint and inside [0, out_len), and match
    distances in [1, dst]. Only such rows take the kernel's
    pointer-jumping path; every walk of the port emits them."""
    valid, low, d0, n = _extents(rf)
    a = rf[1].to(torch.int64)
    end = d0 + n
    prev = torch.cat([torch.zeros_like(end[:, :1]), end[:, :-1]], dim=1)
    bad = ((low > 2) | (n < 0) | (d0 < prev) | (end > out_len)
           | ((low == 1) & ((a < 1) | (a > d0))))
    return ~(bad & valid).any(dim=1)


def _expand_jump_plain(slots: torch.Tensor, rf, out_len: int):
    """The kernel's split in plain PyTorch: well-formed rows placed by
    pointer jumping over the whole row (every byte a value, a gap or a
    pointer p = d0 - d + ((x - d0) mod d) to an earlier byte; rounds of
    p <- src[p] until none is left), the others by _expand_plain.
    Returns (out uint8 (N, out_len), rounds int32 (N,)): -1 for a row
    placed record by record, else its jumping rounds (0 when no byte
    points to another)."""
    N, W = slots.shape
    dev = slots.device
    rf = tuple(f.contiguous() for f in _as_fields(rf))
    wf = _well_formed(rf, out_len)
    out = torch.zeros((N, out_len), dtype=torch.uint8, device=dev)
    rounds = torch.full((N,), -1, dtype=torch.int32, device=dev)
    bad = torch.nonzero(~wf).flatten()
    if bad.numel():
        out[bad] = _expand_plain(slots[bad], tuple(f[bad] for f in rf),
                                 out_len)
    good = torch.nonzero(wf).flatten()
    if good.numel() == 0 or out_len == 0:
        rounds[good] = 0
        return out, rounds
    valid, low, d0, n = (t[good] for t in _extents(rf))
    a = rf[1][good].to(torch.int64)
    imm_hi = rf[3][good].to(torch.int64)
    G = good.numel()
    # the record that covers byte x: the last valid one starting at or
    # before it (dst is non-decreasing over the valid prefix)
    starts = torch.where(valid, d0, out_len + 1)
    x = torch.arange(out_len, device=dev).expand(G, -1).contiguous()
    r = torch.searchsorted(starts, x, right=True) - 1
    rc = r.clamp(min=0)

    def at(t):
        return t.gather(1, rc)

    j = x - at(d0)
    cover = (r >= 0) & (j < at(n))
    lw, av = at(low), at(a)
    # cells: a value v as -1 - v, a pointer as its index
    s = av + j
    lit = torch.where((s >= 0) & (s < W),
                      slots[good].gather(1, s.clamp(0, W - 1)).to(torch.int64),
                      0)
    w = torch.where(j < 4, av, at(imm_hi))
    imm = (w >> (8 * (j.clamp(0, 7) & 3))) & 0xFF
    d = av.clamp(min=1)
    ptr = at(d0) - d + torch.remainder(j, d)
    val = torch.where(lw == 0, lit, torch.where(lw == 2, imm, 0))
    cell = torch.where(cover & (lw == 1), ptr, -1 - torch.where(cover, val, 0))
    jumps = torch.zeros(G, dtype=torch.int32, device=dev)
    while True:
        live = (cell >= 0).any(dim=1)
        if not bool(live.any()):
            break
        jumps += live.to(torch.int32)
        p = cell.clamp(min=0)
        cell = torch.where(cell >= 0, cell.gather(1, p), cell)
    out[good] = (-1 - cell).to(torch.uint8)
    rounds[good] = jumps
    return out, rounds
