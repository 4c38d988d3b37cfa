"""Device zlib (DEFLATE) decoder: Huffman state machine + expand placement.

PyTorch counterpart of cblosc_tpu/tpu/codec_zlib.py. zlib chunks are
written by the host engine (ops/codecs/zlib_.py; the reference wrapped
the library's one-shot calls, blosc/blosc.c:469-496); each split is a
complete zlib stream (2-byte header, RFC 1951 blocks, adler32) that
decodes on the device in two stages:

  1. WALK — the DEFLATE state machine turns each row into a byte tape of
     its literals, in output order, and compacted records: (kind 0,
     tape offset, dst, len) per maximal literal run, (kind 1, distance,
     dst, len) per match. The hand-written kernel K6 (csrc/zlib_walk.cu)
     on a CUDA tensor, :func:`_fsm_walk_plain` on a CPU tensor.
  2. PLACE — every row the walk accepts goes through the expand kernel
     (K1) with the tape as its byte source.

The decisions are the JAX machine's: the container check (CM 8, no
preset dictionary, csize >= 8; no FCHECK, no adler32 check), stored and
BTYPE-3 blocks err (the host engine decodes those chunks), canonical
codes resolve by the shortest length b with first[b] <= code <
first[b] + cnt[b] (so over-subscribed and incomplete codes decode as
JAX decodes them), and the distance table takes at most 30 lengths.
Bytes at or past csize read as 0. A row errs when a valid event (one
literal byte or one match) would be the (E+1)-th, E = event_slots(maxev):
JAX counts loop slots, stalls included, so the port accepts a superset
of its rows.
"""

from __future__ import annotations

import numpy as np
import torch

from . import kernels, structured

I32 = torch.int32
I64 = torch.int64
U8 = torch.uint8

_T = 4              # the JAX machine's symbols per window fetch
_KCH = 4            # and FSM iterations per event-buffer flush

# RFC 1951 static tables (3.2.5/3.2.7), as in the JAX module
_LBASE = np.array([3, 4, 5, 6, 7, 8, 9, 10, 11, 13, 15, 17, 19, 23, 27, 31,
                   35, 43, 51, 59, 67, 83, 99, 115, 131, 163, 195, 227, 258],
                  np.int64)
_LEXTRA = np.array([0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1, 1, 2, 2, 2, 2,
                    3, 3, 3, 3, 4, 4, 4, 4, 5, 5, 5, 5, 0], np.int64)
_DBASE = np.array([1, 2, 3, 4, 5, 7, 9, 13, 17, 25, 33, 49, 65, 97, 129,
                   193, 257, 385, 513, 769, 1025, 1537, 2049, 3073, 4097,
                   6145, 8193, 12289, 16385, 24577], np.int64)
_DEXTRA = np.array([0, 0, 0, 0, 1, 1, 2, 2, 3, 3, 4, 4, 5, 5, 6, 6, 7, 7,
                    8, 8, 9, 9, 10, 10, 11, 11, 12, 12, 13, 13], np.int64)
_CLORDER = np.array([16, 17, 18, 0, 8, 7, 9, 6, 10, 5, 11, 4, 12, 3, 13, 2,
                     14, 1, 15], np.int64)
# fixed-Huffman code lengths (3.2.6)
_FIXED_LL = np.concatenate([np.full(144, 8), np.full(112, 9),
                            np.full(24, 7), np.full(8, 8)]).astype(np.int64)
_FIXED_D = np.full(30, 5, np.int64)

# walk modes
_M_BLK, _M_CLLEN, _M_BUILD_CL, _M_LENS, _M_BUILD, _M_SYM = range(6)

_LMAX = 288 + 32        # code lengths of one dynamic block (hlit + hdist)


def default_events(out_len: int) -> int:
    """Default event budget (the JAX module's): shuffled typed data
    deflates to long matches plus modest literal stretches; literal-dense
    streams overflow and the byte API retries with high_events."""
    return out_len // 16 + 512


def high_events(out_len: int) -> int:
    """Escalated budget: a conforming stream emits at most one event per
    output byte (every literal is one byte, every match >= 3)."""
    return out_len + out_len // 16 + 512


def event_slots(maxev: int) -> int:
    """Events a row may emit for a budget: maxev rounded up to the JAX
    machine's slot count (_T * _KCH per loop iteration)."""
    return -(-maxev // (_T * _KCH)) * (_T * _KCH)


# ---------------------------------------------------------------------------
# WALK (kernel K6)
# ---------------------------------------------------------------------------

def fsm_walk(slots: torch.Tensor, csizes: torch.Tensor, out_len: int,
             maxev: int):
    """Parse a batch of zlib streams into a tape and compacted records.

    slots: uint8 (N, W), zero past each csize; csizes int32 (N,).
    Returns (tape uint8 (N, E), tlen int32 (N,), rf, dist int32 (N,),
    uni bool (N,), ok bool (N,)) with E = event_slots(maxev): tape[:tlen]
    holds the row's literals, rf the field tuple of four int32 (N, E)
    tensors (kind, arg, dst, len), valid records first and kind -1
    after, dist the largest match distance, uni whether all matches share
    it, ok whether the row ended on a final block's EOB at out_len within
    the budget. Launches K6 on a CUDA tensor."""
    E = event_slots(maxev)
    if not slots.is_cuda:
        return _fsm_walk_plain(slots, csizes, out_len, E)
    return _launch(slots, csizes, out_len, E)


def _launch(slots: torch.Tensor, csizes: torch.Tensor, out_len: int, E: int):
    kernels.require(slots, "slots", U8, 2)
    kernels.require(csizes, "csizes", I32, 1)
    N, W = slots.shape
    if csizes.shape[0] != N or csizes.device != slots.device:
        raise ValueError("csizes must be (N,) on the slots' device")
    dev = slots.device
    # the kernel writes every column: tape zeros past tlen, kind -1 and
    # zeros past the last record
    tape = torch.empty((N, E), dtype=U8, device=dev)
    kind, arg, dst, ln = torch.empty((4, N, E), dtype=I32, device=dev).unbind(0)
    tlen, dist = torch.empty((2, N), dtype=I32, device=dev).unbind(0)
    uni, ok = torch.empty((2, N), dtype=torch.bool, device=dev).unbind(0)
    code = kernels.fn("zlib_walk")(
        slots.data_ptr(), N, W, csizes.data_ptr(), out_len, E,
        tape.data_ptr(), tlen.data_ptr(), kind.data_ptr(), arg.data_ptr(),
        dst.data_ptr(), ln.data_ptr(), dist.data_ptr(), uni.data_ptr(),
        ok.data_ptr(), kernels.stream_ptr(slots))
    kernels.check("zlib_walk", code)
    return tape, tlen, (kind, arg, dst, ln), dist, uni, ok


# the 15 low bits of i reversed (Huffman codes arrive MSB-first while
# bytes fill LSB-first, RFC 1951 3.1.1)
_REV15 = np.zeros(1 << 15, np.int64)
for _i in range(15):
    _REV15 |= ((np.arange(1 << 15) >> _i) & 1) << (14 - _i)


def _build(L: torch.Tensor, maxbits: int):
    """Canonical decode tables of rows of code lengths L (R, S):
    (first, cnt, offs) (R, 16) per bit length and symtab (R, S), the
    symbols in (length, symbol) order (RFC 1951 3.2.2)."""
    R, S = L.shape
    b = torch.arange(16, device=L.device)
    cnt = ((L[:, :, None] == b) & (b >= 1) & (b <= maxbits)).sum(dim=1)
    first = torch.zeros_like(cnt)
    offs = torch.zeros_like(cnt)
    code = torch.zeros(R, dtype=I64, device=L.device)
    off = torch.zeros(R, dtype=I64, device=L.device)
    for k in range(1, maxbits + 1):
        first[:, k], offs[:, k] = code, off
        code = (code + cnt[:, k]) << 1
        off = off + cnt[:, k]
    sym = torch.arange(S, device=L.device)
    key = torch.where(L > 0, L * 512 + sym, (1 << 24) + sym).to(I32)
    symtab = torch.sort(key, dim=1).values.to(I64) & 511
    return first, cnt, offs, symtab


def _decode(peek: torch.Tensor, tab, maxbits: int, rev15: torch.Tensor):
    """(symbol, code length) per row from peek (>= maxbits LSB-first
    bits): the shortest length b whose code range holds the reversed
    bits; length 0 (and symbol 0) when none does."""
    first, cnt, offs, symtab = tab
    rev = rev15[peek & ((1 << maxbits) - 1)] >> (15 - maxbits)
    b = torch.arange(1, maxbits + 1, device=peek.device)
    c = rev[:, None] >> (maxbits - b)
    f, n, o = (t[:, 1:maxbits + 1] for t in (first, cnt, offs))
    hit = (n > 0) & (c >= f) & (c < f + n)
    found = hit.any(dim=1)
    k = torch.argmax(hit.to(torch.int8), dim=1)      # the first hit
    idx = (o + c - f).gather(1, k[:, None])[:, 0]
    sym = symtab.gather(1, torch.clamp(idx, 0, symtab.shape[1] - 1)[:, None])
    return (torch.where(found, sym[:, 0], 0), torch.where(found, k + 1, 0))


# K6's lookup tables (csrc/zlib_walk.cu): literal/length and distance
# codes resolve through 2^_LOOKUP_BITS entries, the code-length code
# through 2^_CL_BITS
_LOOKUP_BITS = 10
_CL_BITS = 7


def _lookup_table(L: torch.Tensor, alpha: int):
    """K6's lookup table of one alphabet, by the kernel's algorithm, for
    the tests: the canonical code of the lengths L (S,) (per-length
    counts, first codes and offsets; the symbols in (length, symbol)
    order, each placed by counting the equal lengths before it), then
    per entry e the shortest length b up to the table's bits whose code
    range holds the first b stream bits of e (JAX's rule). alpha 0
    (literal/length) and 1 (distance) pack an entry as len | extra << 4
    | sym << 8 | base << 17 over _LOOKUP_BITS bits, 0 where no length
    holds the code; alpha 2 (code length) as len | sym << 3 over
    _CL_BITS bits. Returns (table int64 (2^bits,), (first, cnt, offs,
    sym))."""
    L = L.to(I64)
    S = L.shape[0]
    bits = _CL_BITS if alpha == 2 else _LOOKUP_BITS
    b = torch.arange(16)
    cnt = ((L[:, None] == b) & (b >= 1)).sum(dim=0)
    first = torch.zeros(16, dtype=I64)
    offs = torch.zeros(16, dtype=I64)
    code = off = 0
    for k in range(1, 16):
        first[k], offs[k] = code, off
        code = (code + int(cnt[k])) << 1
        off += int(cnt[k])
    before = ((L[None, :] == L[:, None])
              & (torch.arange(S)[None, :] < torch.arange(S)[:, None])).sum(1)
    sym = torch.zeros(max(S, 1), dtype=I64)
    live = L > 0
    sym[offs[L[live]] + before[live]] = torch.arange(S)[live]
    e = torch.arange(1 << bits)
    rev = torch.from_numpy(_REV15)[e] >> (15 - bits)
    ln = torch.zeros_like(e)
    sy = torch.zeros_like(e)
    for k in range(bits, 0, -1):            # the shortest hit is written last
        c = rev >> (bits - k)
        hit = (cnt[k] > 0) & (c >= first[k]) & (c < first[k] + cnt[k])
        ln = torch.where(hit, k, ln)
        sy = torch.where(hit, sym[(offs[k] + c - first[k]).clamp(0, S - 1)],
                         sy)
    if alpha == 2:
        return ln | sy << 3, (first, cnt, offs, sym)
    ext, base = _extra_base(sy, alpha)
    tab = torch.where(ln > 0, ln | ext << 4 | sy << 8 | base << 17, 0)
    return tab, (first, cnt, offs, sym)


def _extra_base(sym: torch.Tensor, alpha: int):
    """(extra-bit count, base) of literal/length symbols 257..285 (alpha
    0) or distance symbols 0..29 (alpha 1); 0 and 0 for other symbols."""
    if alpha == 0:
        i = (sym - 257).clamp(0, 28)
        m = (sym >= 257) & (sym <= 285)
        ext, base = torch.from_numpy(_LEXTRA)[i], torch.from_numpy(_LBASE)[i]
    else:
        i = sym.clamp(0, 29)
        m = sym < 30
        ext, base = torch.from_numpy(_DEXTRA)[i], torch.from_numpy(_DBASE)[i]
    return torch.where(m, ext, 0), torch.where(m, base, 0)


def _lookup_decode(table, canon, alpha: int, peek: torch.Tensor):
    """(sym, len, extra, base) per peek (>= 15 LSB-first stream bits) as
    K6 decodes it: the table entry, or for a code longer than the table
    (entry 0 of a literal/length or distance table) the canonical
    compare for lengths _LOOKUP_BITS+1..15. len 0 where no length holds
    the code."""
    peek = peek.to(I64)
    if alpha == 2:
        e = table[peek & ((1 << _CL_BITS) - 1)]
        z = torch.zeros_like(e)
        return e >> 3, e & 7, z, z
    e = table[peek & ((1 << _LOOKUP_BITS) - 1)]
    ln, sy = e & 15, (e >> 8) & 511
    ext, base = (e >> 4) & 15, e >> 17
    first, cnt, offs, sym = canon
    rev = torch.from_numpy(_REV15)[peek & 0x7FFF]
    lln = torch.zeros_like(ln)
    lsy = torch.zeros_like(sy)
    for k in range(15, _LOOKUP_BITS, -1):
        c = rev >> (15 - k)
        hit = (cnt[k] > 0) & (c >= first[k]) & (c < first[k] + cnt[k])
        lln = torch.where(hit, k, lln)
        lsy = torch.where(hit, sym[(offs[k] + c - first[k]).clamp(
            0, sym.shape[0] - 1)], lsy)
    lext, lbase = _extra_base(lsy, alpha)
    long = ln == 0
    return (torch.where(long, torch.where(lln > 0, lsy, 0), sy),
            torch.where(long, lln, ln),
            torch.where(long & (lln > 0), lext, ext),
            torch.where(long & (lln > 0), lbase, base))


def _fsm_walk_plain(slots: torch.Tensor, csizes: torch.Tensor, out_len: int,
                    E: int):
    """K6's function in plain PyTorch: every live row takes one step of
    the DEFLATE machine per iteration (a block header, a code-length-code
    length, a table build, a code-length symbol with its repeats, or a
    literal/length symbol with its distance); a row errs when a valid
    event would be the (E+1)-th."""
    N, W = slots.shape
    dev = slots.device
    cs = csizes.to(I64)
    byte = structured.byte_reader(slots, cs)
    j8 = torch.arange(8, device=dev)

    def bits(r, pos, n):
        """n (<= 49) bits at bit position pos of rows r, LSB-first (the
        8 bytes from pos >> 3 as one int64; its sign bit lies beyond
        them)."""
        w = byte(r, (pos >> 3)[:, None] + j8)
        v = (w << (8 * j8)).sum(dim=1)
        return (v >> (pos & 7)) & ((1 << n) - 1)

    tape = torch.zeros((N, E), dtype=U8, device=dev)
    kind, arg, dst, ln = structured.empty_records(N, E, dev)
    z = torch.zeros(N, dtype=I64, device=dev)
    (bitpos, mode, final, hlit, hdist, hclen, clidx, pos, prevlen, op,
     nev, tlen, nrec, dist, dfirst) = (z.clone() for _ in range(15))
    bitpos += 16
    run = torch.zeros(N, dtype=torch.bool, device=dev)   # open literal run
    uni = torch.ones(N, dtype=torch.bool, device=dev)
    # the zlib container (RFC 1950): CM 8, no preset dictionary
    rows = torch.arange(N, device=dev)
    err = (((byte(rows, z) & 0xF) != 8) | ((byte(rows, z + 1) & 0x20) != 0)
           | (cs < 8))
    fin = cs <= 0
    Larr = torch.zeros((N, _LMAX), dtype=I64, device=dev)
    cllen = torch.zeros((N, 19), dtype=I64, device=dev)

    def ztab(S):
        return [torch.zeros((N, 16), dtype=I64, device=dev) for _ in range(3)] \
            + [torch.zeros((N, S), dtype=I64, device=dev)]

    clt, litt, dstt = ztab(19), ztab(288), ztab(30)
    fx_l = _build(torch.from_numpy(_FIXED_LL).to(dev)[None, :], 15)
    fx_d = _build(torch.from_numpy(_FIXED_D).to(dev)[None, :], 15)
    lbase, lextra, dbase, dextra, clorder, rev15 = (
        torch.from_numpy(a).to(dev)
        for a in (_LBASE, _LEXTRA, _DBASE, _DEXTRA, _CLORDER, _REV15))
    iota = torch.arange(_LMAX, device=dev)[None, :]

    def put(tab, r, new):
        for t, v in zip(tab, new):
            t[r] = v

    while True:
        act = ~(err | fin)
        if not bool(act.any()):
            break
        mode0 = mode.clone()        # one step per row and iteration
        # ---- block header: BFINAL, BTYPE, and HLIT HDIST HCLEN ------------
        r = torch.nonzero(act & (mode0 == _M_BLK)).flatten()
        if r.numel():
            h = bits(r, bitpos[r], 17)
            btype = (h >> 1) & 3
            err[r] = (btype == 0) | (btype == 3)
            final[r] = h & 1
            fx = r[btype == 1]
            bitpos[fx] += 3
            mode[fx] = _M_SYM
            put(litt, fx, fx_l)
            put(dstt, fx, fx_d)
            m = btype == 2
            dy, hd = r[m], h[m]
            hlit[dy] = ((hd >> 3) & 31) + 257
            hdist[dy] = ((hd >> 8) & 31) + 1
            hclen[dy] = ((hd >> 13) & 15) + 4
            bitpos[dy] += 17
            clidx[dy] = 0
            Larr[dy] = 0
            cllen[dy] = 0
            mode[dy] = _M_CLLEN
        # ---- one code-length-code length ---------------------------------
        r = torch.nonzero(act & (mode0 == _M_CLLEN)).flatten()
        if r.numel():
            cllen[r, clorder[clidx[r]]] = bits(r, bitpos[r], 3)
            bitpos[r] += 3
            clidx[r] += 1
            mode[r] = torch.where(clidx[r] >= hclen[r], _M_BUILD_CL, _M_CLLEN)
        # ---- table builds ----------------------------------------------------
        r = torch.nonzero(act & (mode0 == _M_BUILD_CL)).flatten()
        if r.numel():
            put(clt, r, _build(cllen[r], 7))
            pos[r] = 0
            mode[r] = _M_LENS
        r = torch.nonzero(act & (mode0 == _M_BUILD)).flatten()
        if r.numel():
            hl, hd, La = hlit[r], hdist[r], Larr[r]
            put(litt, r, _build(torch.where(iota[:, :288] < hl[:, None],
                                            La[:, :288], 0), 15))
            didx = torch.clamp(hl[:, None] + iota[:, :30], max=_LMAX - 1)
            d_lens = torch.where(iota[:, :30] < hd[:, None],
                                 La.gather(1, didx), 0)
            put(dstt, r, _build(d_lens, 15))
            mode[r] = _M_SYM
        # ---- one code-length symbol with its repeats -------------------------
        r = torch.nonzero(act & (mode0 == _M_LENS)).flatten()
        if r.numel():
            bp = bitpos[r]
            peek = bits(r, bp, 14)
            csym, clen = _decode(peek, [t[r] for t in clt], 7, rev15)
            rep_bits = torch.where(csym == 16, 2, torch.where(
                csym == 17, 3, torch.where(csym == 18, 7, 0)))
            extv = (peek >> clen) & ((1 << rep_bits) - 1)
            rep = torch.where(csym == 16, 3 + extv, torch.where(
                csym == 17, 3 + extv, torch.where(csym == 18, 11 + extv, 1)))
            p, pl = pos[r], prevlen[r]
            val = torch.where(csym < 16, csym, torch.where(csym == 16, pl, 0))
            total = hlit[r] + hdist[r]
            bad = (clen == 0) | (p + rep > total) | ((csym == 16) & (p == 0))
            err[r] = bad
            g = ~bad
            rg, p, rep, val = r[g], p[g], rep[g], val[g]
            fill = (iota >= p[:, None]) & (iota < (p + rep)[:, None])
            Larr[rg] = torch.where(fill, val[:, None], Larr[rg])
            prevlen[rg] = val
            bitpos[rg] = bp[g] + clen[g] + rep_bits[g]
            pos[rg] = p + rep
            mode[rg] = torch.where(p + rep >= total[g], _M_BUILD, _M_LENS)
        # ---- one literal/length symbol with its distance -------------------
        r = torch.nonzero(act & (mode0 == _M_SYM)).flatten()
        if r.numel():
            bp = bitpos[r]
            lsym, llen = _decode(bits(r, bp, 15), [t[r] for t in litt], 15,
                                 rev15)
            is_lit, is_eob, is_len = lsym < 256, lsym == 256, lsym > 256
            li = torch.clamp(lsym - 257, 0, 28)
            lext = lextra[li]
            b1 = bp + llen
            lval = lbase[li] + (bits(r, b1, 5) & ((1 << lext) - 1))
            b2 = b1 + lext
            dsym, dlen = _decode(bits(r, b2, 15), [t[r] for t in dstt], 15,
                                 rev15)
            di = torch.clamp(dsym, 0, 29)
            dext = dextra[di]
            b3 = b2 + dlen
            dval = dbase[di] + (bits(r, b3, 13) & ((1 << dext) - 1))
            nbp = torch.where(is_len, b3 + dext, b1)
            o = op[r]
            mlen = torch.where(is_len, lval, 1)
            bad = ((llen == 0) | (nbp > cs[r] * 8)
                   | (is_len & ((lsym > 285) | (dlen == 0) | (dsym > 29)
                                | (dval > o) | (o + mlen > out_len)))
                   | (is_lit & (o >= out_len)))
            ev = ~is_eob
            bad |= ev & (nev[r] >= E)
            err[r] = bad
            g = ~bad
            # literals: the tape, and the open run or a new kind-0 record
            lm = g & is_lit
            rl = r[lm]
            tape[rl, tlen[rl]] = lsym[lm].to(U8)
            ext = rl[run[rl]]
            ln[ext, nrec[ext] - 1] += 1
            new = rl[~run[rl]]
            c = nrec[new]
            kind[new, c] = 0
            arg[new, c] = tlen[new].to(I32)
            dst[new, c] = op[new].to(I32)
            ln[new, c] = 1
            nrec[new] += 1
            run[rl] = True
            tlen[rl] += 1
            # matches: a kind-1 record; dist is the largest distance
            mm = g & is_len
            rm, dv = r[mm], dval[mm]
            c = nrec[rm]
            kind[rm, c] = 1
            arg[rm, c] = dv.to(I32)
            dst[rm, c] = op[rm].to(I32)
            ln[rm, c] = mlen[mm].to(I32)
            nrec[rm] += 1
            run[rm] = False
            firstm = dist[rm] == 0
            dfirst[rm] = torch.where(firstm, dv, dfirst[rm])
            uni[rm] &= firstm | (dv == dfirst[rm])
            dist[rm] = torch.maximum(dist[rm], dv)
            # state advance
            rg = r[g]
            nev[rg] += ev[g].to(I64)
            op[rg] += torch.where(is_eob, 0, mlen)[g]
            bitpos[rg] = nbp[g]
            eob = r[g & is_eob]
            mode[eob] = _M_BLK
            fin[eob] = final[eob] == 1
    ok = ~err & (op == out_len)
    return (tape, tlen.to(I32), (kind, arg, dst, ln), dist.to(I32), uni, ok)


# ---------------------------------------------------------------------------
# Decode: walk + expand placement
# ---------------------------------------------------------------------------

def decode(slots: torch.Tensor, csizes: torch.Tensor, out_len: int,
           maxev_hint: int = 0):
    """Decode batched zlib streams on the device.

    Returns (out uint8 (N, out_len), produced int32 (N,), err bool (N,))
    as cblosc_tpu.tpu.codec_zlib.decode does: rows the walk cannot handle
    (stored blocks, preset dictionaries, event overflow, a geometry
    outside decode_cap) report err, and so does a row with csize 0; the
    byte API retries once with high_events and then decodes the chunk on
    the host. Every row the walk accepts is placed by the expand kernel
    (JAX's CPU leg places only rows of one distance through its sort
    machine). maxev_hint overrides the budget default_events(out_len)."""
    N = slots.shape[0]
    dev = slots.device
    if out_len > structured.decode_cap() or out_len < 8:
        return (torch.zeros((N, out_len), dtype=U8, device=dev),
                torch.zeros(N, dtype=I32, device=dev), csizes > 0)
    maxev = maxev_hint or default_events(out_len)
    tape, _, rf, _, _, ok = fsm_walk(slots, csizes, out_len, maxev)
    out = torch.zeros((N, out_len), dtype=U8, device=dev)
    k = torch.nonzero(ok).flatten()
    if k.numel():
        out[k] = structured.kernel_place_rows(
            tape[k], tuple(f[k] for f in rf), out_len, tape.shape[1])
    return out, torch.where(ok, out_len, 0).to(I32), ~ok
