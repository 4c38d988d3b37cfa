"""Device Snappy decoder: tag-stream walk + the shared placement machine.

PyTorch counterpart of cblosc_tpu/tpu/codec_snappy.py. Snappy chunks
are written by the host engine (ops/codecs/snappy.py; the reference
wrapped the external library, blosc/blosc.c:443-467); their splits
decode on the device: the walk turns the raw stream into compacted
(kind, arg, dst, len) records — the hand-written kernel K5
(csrc/snappy_walk.cu) on a CUDA tensor, :func:`_walk_plain` on a CPU
tensor — and gpu/structured.decode_core places them. The grammar:

    uvarint uncompressed length (must equal out_len)
    tag & 3 == 0: literal, (tag>>2)+1 bytes; lengths > 60 spill into
                  1-4 little-endian extra bytes (value+1)
    tag & 3 == 1: copy, 3-bit length-4 (4..11), 11-bit offset
                  (tag bits 5-7 are offset bits 8-10; one extra byte)
    tag & 3 == 2: copy, 6-bit length-1, 2-byte LE offset
    tag & 3 == 3: copy, 6-bit length-1, 4-byte LE offset

Every token is self-contained, so the walk is single-phase; the stream
has no terminator, and its end is the row's end.
"""

from __future__ import annotations

import torch

from . import structured

I32 = torch.int32
I64 = torch.int64


def max_records(out_len: int) -> int:
    """Default walk budget (the JAX walk's): copies carry <= 64 bytes
    and hash-table encoders emit matches as short as 4 bytes, so a
    quarter of the output size plus a margin. Denser streams overflow;
    the byte API retries with structured.high_records before any host
    fallback."""
    return out_len // 4 + out_len // 64 + 32


def walk(slots: torch.Tensor, csizes: torch.Tensor, out_len: int,
         maxrec: int):
    """Parse a batch of snappy streams into compacted records: (kind 0,
    stream offset, dst, len) per literal, (kind 1, offset, dst, len) per
    copy. Outputs as structured.walk's. Launches K5 on a CUDA tensor."""
    E = structured.record_slots(maxrec)
    if not slots.is_cuda:
        return _walk_plain(slots, csizes, out_len, E)
    return structured.launch_walk("snappy_walk", slots, csizes, out_len, E)


def _preamble(slots: torch.Tensor, cs: torch.Tensor, out_len: int):
    """The uvarint length: (bytes it takes, err). An error when it runs
    past 5 bytes or csize, sets a bit at or above bit 32, differs from
    out_len, or leaves no byte for the tags."""
    N, W = slots.shape
    dev = slots.device
    val = torch.zeros(N, dtype=I64, device=dev)
    nv = torch.zeros(N, dtype=I64, device=dev)
    cont = torch.ones(N, dtype=torch.bool, device=dev)
    overflow = torch.zeros(N, dtype=torch.bool, device=dev)
    for i in range(5):
        bi = (slots[:, i].to(I64) if i < W
              else torch.zeros(N, dtype=I64, device=dev))
        take = cont & (i < cs)
        overflow |= take & (i == 4) & ((bi & 0x7F) > 0xF)
        val = torch.where(take, val | ((bi & 0x7F) << (7 * i)), val)
        nv = torch.where(take, i + 1, nv)
        cont = take & ((bi & 0x80) != 0)
    return nv, cont | overflow | (val != out_len) | (cs <= nv)


def _walk_plain(slots: torch.Tensor, csizes: torch.Tensor, out_len: int,
                E: int):
    """K5's function in plain PyTorch: every live row parses one tag per
    iteration with the JAX walk's checks (see csrc/snappy_walk.cu),
    records compacted; a row errs when a record would be the (E+1)-th."""
    N = slots.shape[0]
    dev = slots.device
    cs = csizes.to(I64)
    kind, arg, dst, ln = structured.empty_records(N, E, dev)
    nv, pre_err = _preamble(slots, cs, out_len)
    live = cs > 0
    ip = nv.clone()
    op, dist, cnt = (torch.zeros(N, dtype=I64, device=dev) for _ in range(3))
    uni = torch.ones(N, dtype=torch.bool, device=dev)
    err, fin = live & pre_err, ~live
    byte = structured.byte_reader(slots, cs)
    j5 = torch.arange(5, device=dev)[None, :]
    while True:
        r = torch.nonzero(~(err | fin)).flatten()
        if r.numel() == 0:
            break
        ipr, opr, cr = ip[r], op[r], cs[r]
        b = byte(r, ipr[:, None] + j5)
        tag, b1, b2, b3, b4 = b.unbind(1)
        typ, base = tag & 3, tag >> 2
        # ---- literal (typ 0) ----------------------------------------------
        is_lit = typ == 0
        extra = torch.clamp(base - 59, 0, 4)
        ext_val = (b1 | torch.where(extra >= 2, b2 << 8, 0)
                   | torch.where(extra >= 3, b3 << 16, 0))
        lit_len = torch.where(extra == 0, base + 1, ext_val + 1)
        ipl = ipr + 1 + extra
        ip2 = ipl + lit_len
        # a 4-byte length with its top byte set exceeds any out_len
        lit_err = ((extra == 4) & (b4 != 0)) | (ip2 > cr) | (opr + lit_len
                                                             > out_len)
        # ---- copy (typ 1/2/3) ---------------------------------------------
        is_c1, is_c2 = typ == 1, typ == 2
        mlen = torch.where(is_c1, (base & 7) + 4, base + 1)
        off = torch.where(is_c1, ((base >> 3) << 8) | b1,
                          b1 | (b2 << 8) | torch.where(is_c2, 0, b3 << 16))
        ip3 = ipr + torch.where(is_c1, 2, torch.where(is_c2, 3, 5))
        m_err = (((typ == 3) & (b4 != 0)) | (off == 0) | (off > opr)
                 | (opr + mlen > out_len) | (ip3 > cr))
        # ---- merge, budget, state advance ---------------------------------
        c = cnt[r]
        err_t = torch.where(is_lit, lit_err, m_err) | (c >= E)
        g = ~err_t
        rg, cg = r[g], c[g]
        kind[rg, cg] = torch.where(is_lit, 0, 1)[g].to(I32)
        arg[rg, cg] = torch.where(is_lit, ipl, off)[g].to(I32)
        dst[rg, cg] = opr[g].to(I32)
        n_len = torch.where(is_lit, lit_len, mlen)
        ln[rg, cg] = n_len[g].to(I32)
        cnt[rg] = cg + 1
        ip_n = torch.where(is_lit, ip2, ip3)
        ip[rg] = ip_n[g]
        op[rg] = (opr + n_len)[g]
        dm = g & ~is_lit
        dr = dist[r]
        d2 = torch.where(dr == 0, off, dr)
        dist[r] = torch.where(dm, d2, dr)
        uni[r] = uni[r] & ~(dm & (off != d2))
        err[r] = err_t
        fin[r] = g & (ip_n >= cr)      # no terminator: stream end is fin
    ok = ~err & (op == out_len)
    return (kind, arg, dst, ln), dist.to(I32), uni, ok


# ---------------------------------------------------------------------------
# K5's split, in plain PyTorch (tests only): the tag tables and the chain
# ---------------------------------------------------------------------------

def _tag_at(tag, b1, b2, b3, b4, p, cs):
    """The tag that would start at position p, from its five bytes: its
    successor delta, output length, argument (a literal's stream offset,
    a copy's offset), whether it is a copy, and whether it errs without
    regard to the output so far (a set fourth length byte, offset 0, a
    token past csize)."""
    typ, base = tag & 3, tag >> 2
    lit = typ == 0
    extra = torch.clamp(base - 59, 0, 4)
    ext_val = (b1 | torch.where(extra >= 2, b2 << 8, 0)
               | torch.where(extra >= 3, b3 << 16, 0))
    lit_len = torch.where(extra == 0, base + 1, ext_val + 1)
    ipl = p + 1 + extra
    c1, c2 = typ == 1, typ == 2
    clen = torch.where(c1, (base & 7) + 4, base + 1)
    off = torch.where(c1, ((base >> 3) << 8) | b1,
                      b1 | (b2 << 8) | torch.where(c2, 0, b3 << 16))
    cdelta = torch.where(c1, 2, torch.where(c2, 3, 5))
    delta = torch.where(lit, 1 + extra + lit_len, cdelta)
    perr = torch.where(
        lit, ((extra == 4) & (b4 != 0)) | (ipl + lit_len > cs),
        ((typ == 3) & (b4 != 0)) | (off == 0) | (p + cdelta > cs))
    return (delta, torch.where(lit, lit_len, clen), torch.where(lit, ipl, off),
            ~lit, perr)


def _tag_tables(slots: torch.Tensor, csizes: torch.Tensor):
    """K5's first half: the tag at every position of every row, as its
    windows evaluate them (bytes at or past min(csize, W) read 0):
    (delta, len, arg, copy, perr), each (N, W)."""
    N, W = slots.shape
    cs = csizes.to(I64)
    byte = structured.byte_reader(slots, cs)
    rows = torch.arange(N, device=slots.device)
    p = torch.arange(W, device=slots.device)[None, :].expand(N, W)
    b = [byte(rows, p + j) for j in range(5)]
    return _tag_at(*b, p, cs[:, None])


def _walk_split(slots: torch.Tensor, csizes: torch.Tensor, out_len: int,
                E: int):
    """K5's function as the kernel splits it (tests only): the preamble,
    then the chain of real tags through _tag_tables, one tag of every
    live row a step, with the checks that need the output so far (offset
    above op, output past out_len) and the budget. Outputs as
    _walk_plain's."""
    N, W = slots.shape
    dev = slots.device
    cs = csizes.to(I64)
    tabs = _tag_tables(slots, csizes)
    kind, arg, dst, ln = structured.empty_records(N, E, dev)
    nv, pre_err = _preamble(slots, cs, out_len)
    live = cs > 0
    t = nv.clone()
    op, dist, cnt = (torch.zeros(N, dtype=I64, device=dev) for _ in range(3))
    uni = torch.ones(N, dtype=torch.bool, device=dev)
    err, fin = live & pre_err, ~live
    while True:
        r = torch.nonzero(~(err | fin)).flatten()
        if r.numel() == 0:
            break
        tr, opr, c = t[r], op[r], cnt[r]
        inside = tr < W
        # past the row every byte reads 0: a 1-byte literal
        z = torch.zeros_like(tr)
        far = _tag_at(z, z, z, z, z, tr, cs[r])
        d, L, a, cp, pe = (torch.where(inside, f[r, torch.clamp(tr, max=W - 1)],
                                       g) for f, g in zip(tabs, far))
        e = pe | (opr + L > out_len) | (cp & (a > opr)) | (c >= E)
        g = ~e
        rg, cg = r[g], c[g]
        kind[rg, cg] = cp[g].to(I32)
        arg[rg, cg] = a[g].to(I32)
        dst[rg, cg] = opr[g].to(I32)
        ln[rg, cg] = L[g].to(I32)
        cnt[rg] = cg + 1
        t[rg] = (tr + d)[g]
        op[rg] = (opr + L)[g]
        dm = g & cp
        dr = dist[r]
        d2 = torch.where(dr == 0, a, dr)
        dist[r] = torch.where(dm, d2, dr)
        uni[r] = uni[r] & ~(dm & (a != d2))
        err[r] = e
        fin[r] = g & (tr + d >= cs[r])
    ok = ~err & (op == out_len)
    return (kind, arg, dst, ln), dist.to(I32), uni, ok


def decode(slots: torch.Tensor, csizes: torch.Tensor, out_len: int,
           maxrec_hint: int = 0):
    """Decode batched snappy streams via the structured machine.

    Returns (out, produced, err) as cblosc_tpu.tpu.codec_snappy.decode
    does; see structured.decode_walked."""
    return structured.decode_walked(walk, max_records, slots, csizes, out_len,
                                    maxrec_hint)
