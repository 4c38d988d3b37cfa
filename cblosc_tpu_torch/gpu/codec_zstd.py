"""Device zstd decoder: frame state machine + expand placement.

PyTorch counterpart of cblosc_tpu/tpu/codec_zstd.py. zstd chunks are
written by the host engine (ops/codecs/zstd_.py; the reference wraps the
library's one-shot calls, blosc/blosc.c:498-522); zstd splits are never
cut (core/policy.py), so each row is one whole block and one zstd frame
(RFC 8878), decoded on the device in two stages:

  1. WALK — the frame state machine turns each row into a tape of its
     Huffman-decoded literals, in frame order (the only literal bytes
     that exist nowhere in the stream), and compacted records against
     the byte source [tape | stream]: (kind 0, src, dst, len) per
     literal run, src a tape offset or TW + a stream offset (raw
     literals and raw blocks point into the stream), (kind 1, distance,
     dst, len) per match; RLE literals and RLE blocks become one literal
     byte and a distance-1 match. The hand-written kernel K7
     (csrc/zstd_walk.cu) on a CUDA tensor, :func:`_fsm_walk_plain` on a
     CPU tensor.
  2. PLACE — every row the walk accepts goes through the expand kernel
     (K1) over [tape | stream].

The decisions are the JAX machine's (`_fsm_walk`), because which rows
err decides the byte API's retry and its host fallback: dictionaries,
the reserved frame bit, block type 3, block and section bounds,
treeless literals with no earlier tree, Huffman and FSE table
descriptions (the weight completion, K <= 11, an FSE spread whose live
cells differ from the count sum), sequence codes (offset codes above 25)
and the exact consumption of every backward bitstream. Content
checksums are skipped, not verified. Bits below a row's first bit read
as 0, bytes at or past the row's width as 0.

What differs from JAX, by design: the tape is written in order (JAX
sorts per-byte events); a row errs when a valid event (a tape byte or a
record) would be the (E+1)-th, E = event_slots(maxev), where JAX counts
_NLANES slots per loop iteration; an FSE count description may hold a
zero run of any length (the RFC's repeat flags, read to the first flag
below 3), where JAX errs after 8 flags of 3 (24 zero counts), which
rejects most match-length tables of shuffled typed data. So the port
accepts a superset of the JAX machine's rows; those rows decode to
libzstd's bytes, which JAX's host engine writes for them. A row that
errs reports tlen 0, no records and a zero tape.
"""

from __future__ import annotations

import numpy as np
import torch

from . import kernels, structured
from ..ops.codecs import zstd_ref

I32 = torch.int32
I64 = torch.int64
U8 = torch.uint8

_KCH = 4            # the JAX machine's FSM iterations per scan chunk
_NLANES = 18        # and event lanes per iteration

# walk modes (the JAX machine's)
(_M_FRAME, _M_BLK, _M_LITHDR, _M_HUFHDR, _M_HUFW_DIR, _M_NCOUNT,
 _M_FSEBUILD, _M_HUFW_FSE, _M_HUFBUILD, _M_LITSETUP, _M_LITDEC,
 _M_SEQHDR, _M_SEQTABS, _M_SEQINIT, _M_SEQDEC, _M_BLKEND,
 _M_DONE) = range(17)

# sequence-code value tables (RFC 8878 3.1.1.3.2.1)
_LL_BITS = np.asarray(zstd_ref.LL_BITS, np.int64)
_LL_BASE = np.asarray(zstd_ref.LL_BASE, np.int64)
_ML_BITS = np.asarray(zstd_ref.ML_BITS, np.int64)
_ML_BASE = np.asarray(zstd_ref.ML_BASE, np.int64)

_FSE_PAD = 512          # LL/ML: 2^9 max; OF 2^8; weights 2^6
_NC_CAP = 64            # normalized-count scratch symbols (ML needs 53)

_MAXSYM = (255, 35, 31, 52)        # per table id: weights, LL, OF, ML
_MAXLOG = (6, 9, 8, 9)
_TABW = (64, 512, 256, 512)        # cells kept per table id


def _predef_np(which: str):
    """Predefined FSE decode tables (3.1.1.3.2.2) padded to _FSE_PAD, and
    their accuracy log."""
    dist, log = {"ll": (zstd_ref._LL_DEFAULT, 6),
                 "ml": (zstd_ref._ML_DEFAULT, 6),
                 "of": (zstd_ref._OF_DEFAULT, 5)}[which]
    sym, nb, base = zstd_ref.build_fse_table(dist, log)
    pad = _FSE_PAD - (1 << log)
    return (np.pad(np.asarray(sym, np.int64), (0, pad)),
            np.pad(np.asarray(nb, np.int64), (0, pad)),
            np.pad(np.asarray(base, np.int64), (0, pad)), log)


_PRE = {"ll": _predef_np("ll"), "of": _predef_np("of"),
        "ml": _predef_np("ml")}


def default_events(out_len: int) -> int:
    """Default budget in event slots (the JAX module's): it covers frames
    whose Huffman-literal share is up to about a half; literal-denser
    frames overflow and the byte API retries with high_events."""
    return (out_len * 9) // 8 + 2048


def high_events(out_len: int) -> int:
    """Escalated budget (the JAX module's): every output byte a Huffman
    literal, plus sequence records and headers."""
    return (out_len * 9) // 4 + 8192


def event_slots(maxev: int) -> int:
    """Events a row may emit for a budget: maxev rounded up to the JAX
    machine's slot count (_NLANES * _KCH per loop chunk)."""
    return -(-maxev // (_NLANES * _KCH)) * (_NLANES * _KCH)


def record_cap(out_len: int) -> int:
    """Record columns of a row (JAX decode's reccap): the worst
    conforming density, 2 records per 4 output bytes, plus headroom."""
    return -(-(out_len // 2 + 1024) // 32) * 32


def _hb(x: torch.Tensor) -> torch.Tensor:
    """floor(log2(max(x, 1))) for x < 2^21, exactly."""
    r = torch.zeros_like(x)
    for k in range(1, 21):
        r = r + (x >= (1 << k)).to(x.dtype)
    return r


# ---------------------------------------------------------------------------
# table builds (plain versions of the JAX module's vectorized builders)
# ---------------------------------------------------------------------------

def _fse_build(counts: torch.Tensor, acclog: torch.Tensor):
    """FSE decode tables (4.1.1) of rows of normalized counts (R, _NC_CAP)
    int64, -1 for "less than 1", and accuracy logs (R,): (sym, nb, base)
    each (R, _FSE_PAD) int64 and err (R,) bool, cell for cell the JAX
    module's `_fse_build`. err: the live cells of the spread differ in
    number from the count sum."""
    R = counts.shape[0]
    dev = counts.device
    counts = counts.to(I64)
    acclog = acclog.to(I64)
    size = (1 << acclog)[:, None]
    cell = torch.arange(_FSE_PAD, device=dev)[None, :]
    scount = torch.arange(_NC_CAP, device=dev)[None, :]
    low = counts == -1
    nlow = low.sum(dim=1)
    high = size - 1 - nlow[:, None]
    # lowprob cells: the i-th lowprob symbol sits at cell size-1-i
    lowrank = torch.cumsum(low.to(I64), dim=1) - 1
    lkey = torch.where(low, lowrank * 256 + scount, 1 << 24)
    lsym = torch.sort(lkey, dim=1).values % 256
    lsym_p = torch.nn.functional.pad(lsym, (0, _FSE_PAD - _NC_CAP))
    low_at_cell = lsym_p.gather(1, torch.clamp(size - 1 - cell, 0,
                                               _FSE_PAD - 1))
    # spread: the k-th live visit of p_k = k*step mod size takes the k-th
    # symbol occurrence
    step = (size >> 1) + (size >> 3) + 3
    pk = (cell * step) & (size - 1)
    live = (cell < size) & (pk <= high)
    rank = torch.cumsum(live.to(I64), dim=1) - 1
    cpos = torch.cumsum(torch.clamp(counts, min=0), dim=1)
    sym_of = (rank[:, :, None] >= cpos[:, None, :]).sum(dim=2)
    skey = torch.where(live, pk * 256 + torch.clamp(sym_of, 0, 255), 1 << 24)
    ssorted = torch.sort(skey, dim=1).values
    filled = ssorted < (1 << 24)
    sym = torch.where(cell > high, low_at_cell,
                      torch.where(filled, ssorted % 256, 0))
    err = live.sum(dim=1) != torch.clamp(counts, min=0).sum(dim=1)
    # nextState per cell: occurrence index within its symbol, table order
    okey = torch.where(cell < size, sym * 4096 + cell, 1 << 24)
    osort, order = torch.sort(okey, dim=1, stable=True)
    ocell = cell.expand(R, -1).gather(1, order)
    osym = torch.clamp(osort // 4096, 0, _FSE_PAD - 1)
    newsym = torch.cat([torch.ones((R, 1), dtype=torch.bool, device=dev),
                        osym[:, 1:] != osym[:, :-1]], dim=1)
    grpstart = torch.cummax(torch.where(newsym, cell, 0), dim=1).values
    occ = cell - grpstart
    ncount = torch.where(low, 1, torch.clamp(counts, min=0))
    ncount_p = torch.nn.functional.pad(ncount, (0, _FSE_PAD - _NC_CAP))
    nstate = torch.clamp(ncount_p.gather(1, osym) + occ, min=1)
    nb_s = torch.clamp(acclog[:, None] - _hb(nstate), 0, 16)
    base_s = (nstate << nb_s) - size
    invalid = osort >= (1 << 24)
    inv = torch.argsort(ocell, dim=1)
    nb = torch.where(invalid, 0, nb_s).gather(1, inv)
    base = torch.where(invalid, 0, base_s).gather(1, inv)
    return sym, nb, base, err


def _huf_build(warr: torch.Tensor, nw: torch.Tensor):
    """Huffman decode tables (4.2.1) of rows of weights (R, 256) for
    symbols 0..nw-1, the last symbol's weight implied by the power-of-2
    completion: (K, hbase, cnt, hoffs (R, 12), hsymtab (R, 256), err),
    the JAX module's `_huf_build`. err: no weight, a completion that is
    not a power of 2, K > 11, nw > 255 or a weight above 11."""
    R = warr.shape[0]
    dev = warr.device
    warr, nw = warr.to(I64), nw.to(I64)
    sidx = torch.arange(256, device=dev)[None, :]
    w_known = torch.where(sidx < nw[:, None], warr, 0)
    total0 = torch.where(w_known > 0,
                         1 << torch.clamp(w_known - 1, 0, 11), 0).sum(dim=1)
    K = _hb(torch.clamp(total0, min=1)) + 1
    rest = (1 << K) - total0
    wlast = _hb(torch.clamp(rest, min=1)) + 1
    err = ((total0 < 1) | (rest < 1) | ((rest & (rest - 1)) != 0) | (K > 11)
           | (nw > 255) | (w_known > 11).any(dim=1))
    weights = torch.where(sidx == nw[:, None], wlast[:, None], w_known)
    weights = torch.where(sidx <= nw[:, None], weights, 0)
    w12 = torch.arange(12, device=dev)
    cnt = (weights[:, :, None] == w12).sum(dim=1)
    spans = cnt * (1 << torch.clamp(w12 - 1, min=0))[None, :]
    spans[:, 0] = 0
    hbase = torch.cumsum(spans, dim=1) - spans
    hoffs = torch.cat([torch.zeros((R, 1), dtype=I64, device=dev),
                       torch.cumsum(cnt[:, 1:], dim=1) - cnt[:, 1:]], dim=1)
    key = torch.where(weights > 0, weights * 256 + sidx, (1 << 24) + sidx)
    hsymtab = torch.sort(key, dim=1).values % 256
    return K, hbase, cnt, hoffs, hsymtab, err


def _huf_decode(peek11, K, hbase, hcnt, hoffs, hsymtab):
    """One Huffman symbol per peek from 11-bit peeks (R,) or (R, M)
    ending at the cursor (bits [p-11, p) LSB-first), with row r's tables:
    (sym, nbits), nbits 0 where no weight's range holds the code (the
    JAX module's `_huf_decode`)."""
    one = peek11.dim() == 1
    pk = peek11[:, None] if one else peek11
    K = K[:, None]
    v = pk >> torch.clamp(11 - K, 0, 11)
    sym = torch.zeros_like(pk)
    nb = torch.zeros_like(pk)
    found = torch.zeros(pk.shape, dtype=torch.bool, device=pk.device)
    for w in range(1, 12):
        c, hb = hcnt[:, w:w + 1], hbase[:, w:w + 1]
        inr = (~found & (c > 0) & (v >= hb) & (v < hb + (c << (w - 1)))
               & (w <= K))
        idx = hoffs[:, w:w + 1] + ((v - hb) >> (w - 1))
        s = hsymtab.gather(1, torch.clamp(idx, 0, 255))
        sym = torch.where(inr, s, sym)
        nb = torch.where(inr, K + 1 - w, nb)
        found |= inr
    return (sym[:, 0], nb[:, 0]) if one else (sym, nb)


# ---------------------------------------------------------------------------
# WALK (kernel K7)
# ---------------------------------------------------------------------------

def fsm_walk(slots: torch.Tensor, csizes: torch.Tensor, out_len: int,
             maxev: int, stats: torch.Tensor | None = None):
    """Parse a batch of zstd frames into a literal tape and compacted
    records.

    slots: uint8 (N, W), zero past each csize; csizes int32 (N,).
    Returns (tape uint8 (N, out_len), tlen int32 (N,), rf, ok bool (N,)):
    tape[:tlen] holds the row's Huffman-decoded literals in frame order,
    rf the field tuple of four int32 (N, record_cap(out_len)) tensors
    (kind, arg, dst, len), valid records first and kind -1 after, ok
    whether the row's frame ended at out_len within the budget of
    event_slots(maxev) events and record_cap records. Launches K7 on a
    CUDA tensor. stats, an int32 (N,) tensor on the slots' device,
    receives per row the sequences the kernel's decoder took (the
    split's count, :func:`_fsm_walk_split`, on a CPU tensor)."""
    E = event_slots(maxev)
    if not slots.is_cuda:
        if stats is not None:
            stats.copy_(_fsm_walk_split(slots, csizes, out_len, E)[4])
        return _fsm_walk_plain(slots, csizes, out_len, E)
    return _launch(slots, csizes, out_len, E, stats)


def _launch(slots: torch.Tensor, csizes: torch.Tensor, out_len: int, E: int,
            stats: torch.Tensor | None = None):
    kernels.require(slots, "slots", U8, 2)
    kernels.require(csizes, "csizes", I32, 1)
    N, W = slots.shape
    if csizes.shape[0] != N or csizes.device != slots.device:
        raise ValueError("csizes must be (N,) on the slots' device")
    if stats is not None:
        kernels.require(stats, "stats", I32, 1)
        if stats.shape[0] != N or stats.device != slots.device:
            raise ValueError("stats must be (N,) on the slots' device")
    dev = slots.device
    RC = record_cap(out_len)
    # the kernel writes every column: tape zeros past tlen, kind -1 and
    # zeros past the last record
    tape = torch.empty((N, out_len), dtype=U8, device=dev)
    kind, arg, dst, ln = torch.empty((4, N, RC), dtype=I32, device=dev).unbind(0)
    tlen = torch.empty(N, dtype=I32, device=dev)
    ok = torch.empty(N, dtype=torch.bool, device=dev)
    code = kernels.fn("zstd_walk")(
        slots.data_ptr(), N, W, csizes.data_ptr(), out_len, E, RC,
        tape.data_ptr(), tlen.data_ptr(), kind.data_ptr(), arg.data_ptr(),
        dst.data_ptr(), ln.data_ptr(), ok.data_ptr(),
        0 if stats is None else stats.data_ptr(), kernels.stream_ptr(slots))
    kernels.check("zstd_walk", code)
    return tape, tlen, (kind, arg, dst, ln), ok


class _Rows:
    """Bit and byte reads of a batch of rows: positions below 0 or at or
    past the row width read 0 (the JAX machine pads its rows with zeros
    and reads backward streams through windows clamped at bit 0)."""

    def __init__(self, slots: torch.Tensor):
        self.slots = slots
        self.W = slots.shape[1]
        self.j5 = torch.arange(5, device=slots.device)

    def byte(self, r, x):
        v = self.slots[r, torch.clamp(x, 0, self.W - 1)].to(I64)
        return torch.where((x >= 0) & (x < self.W), v, 0)

    def bits(self, r, q, n):
        """n (<= 25, int or per-row) bits at bit positions q of rows r."""
        b = (q >> 3)[:, None] + self.j5
        x = self.byte(r[:, None].expand_as(b), b)
        v = (x << (8 * self.j5)).sum(dim=1)
        return (v >> (q & 7)) & ((1 << n) - 1)


def _fsm_walk_plain(slots: torch.Tensor, csizes: torch.Tensor, out_len: int,
                    E: int):
    """K7's function in plain PyTorch: every live row takes one step of
    the JAX machine's current mode per iteration (a header, one
    normalized count, a table build, one Huffman weight, one literal per
    stream, one sequence); a row errs when a valid event would be the
    (E+1)-th, or a record the (record_cap+1)-th."""
    N, W = slots.shape
    dev = slots.device
    TW, RC = out_len, record_cap(out_len)
    rd = _Rows(slots)
    byte = rd.byte
    cs = csizes.to(I64)
    z = torch.zeros(N, dtype=I64, device=dev)
    s = {k: z.clone() for k in (
        "pos mode op last bend tl ltype lrsz lsrc lbase lpos lcend hK nw "
        "widx hwp hwp0 hws0 hws1 hwend tid smodes ncbp ncrem ncthr ncbits "
        "ncnum ncp0 nclog nstr nbseq sqp sqp0 lls ofs mls nev nrec").split()}
    rep = torch.tensor([1, 4, 8], device=dev).repeat(N, 1)
    sp, st, sr, sb = (torch.zeros((N, 4), dtype=I64, device=dev)
                      for _ in range(4))
    err = cs <= 0
    fin = torch.zeros(N, dtype=torch.bool, device=dev)
    warr = torch.zeros((N, 256), dtype=I64, device=dev)
    ncounts = torch.zeros((N, _NC_CAP), dtype=I64, device=dev)
    tabs = [[torch.zeros((N, L), dtype=I64, device=dev) for _ in range(3)]
            for L in _TABW]
    hdsym = torch.zeros((N, 2048), dtype=I64, device=dev)   # direct Huffman
    hdnb = torch.zeros((N, 2048), dtype=I64, device=dev)    # tables
    tape = torch.zeros((N, TW), dtype=U8, device=dev)
    kind, arg, dst, ln = structured.empty_records(N, RC, dev)
    pre = {k: [torch.from_numpy(a).to(dev) for a in v[:3]] + [v[3]]
           for k, v in _PRE.items()}
    llb, lla, mlb, mla = (torch.from_numpy(a).to(dev)
                          for a in (_LL_BITS, _LL_BASE, _ML_BITS, _ML_BASE))
    maxsym_t = torch.tensor(_MAXSYM, device=dev)
    maxlog_t = torch.tensor(_MAXLOG, device=dev)
    v2048 = torch.arange(2048, device=dev)
    j4 = torch.arange(4, device=dev)

    def rback(r, bitpos, n):
        """bits [bitpos-n, bitpos) of rows r (n per row, <= 25)."""
        return rd.bits(r, bitpos - n, n)

    def emit(r, go, k, a, d, n):
        """A record (kind k) on rows r where go; a row errs instead when
        the record would exceed the event budget or the record columns."""
        g = torch.nonzero(go).flatten()
        if not g.numel():
            return
        rr = r[g]
        bad = (s["nev"][rr] >= E) | (s["nrec"][rr] >= RC)
        err[rr[bad]] = True
        g, rr = g[~bad], rr[~bad]
        c = s["nrec"][rr]
        kind[rr, c] = k
        arg[rr, c] = a[g].to(I32)
        dst[rr, c] = d[g].to(I32)
        ln[rr, c] = n[g].to(I32)
        s["nrec"][rr] += 1
        s["nev"][rr] += 1

    def emit_lits(r, go, ll):
        """The literal-run records of ll literals at the consumption point,
        by the block's literal type: Huffman -> tape offsets, raw ->
        stream offsets, RLE -> one byte and a distance-1 match."""
        lt, lpos, lsrc, o = s["ltype"][r], s["lpos"][r], s["lsrc"][r], s["op"][r]
        is_rle = lt == 1
        a = torch.where(lt >= 2, s["lbase"][r] + lpos, TW + lsrc + lpos)
        emit(r, go & (ll > 0), 0, torch.where(is_rle, TW + lsrc, a), o,
             torch.where(is_rle, 1, ll))
        emit(r, go & is_rle & (ll > 1), 1, torch.ones_like(o), o + 1, ll - 1)

    def get(k, r):
        return s[k][r]

    def put(k, r, v):
        s[k][r] = v

    while True:
        act = ~(err | fin)
        if not bool(act.any()):
            break
        mode0 = s["mode"].clone()
        present = set(torch.unique(mode0[act]).tolist())

        def rows(m):
            return torch.nonzero(act & (mode0 == m)).flatten()

        # ---- frame header --------------------------------------------------
        if _M_FRAME in present:
            r = rows(_M_FRAME)
            magic = sum(byte(r, z[r] + j) << (8 * j) for j in range(4))
            fhd = byte(r, z[r] + 4)
            single = (fhd >> 5) & 1
            bad = (magic != 0xFD2FB528) | ((fhd & 8) != 0) | ((fhd & 3) != 0)
            fl = fhd >> 6
            fcs_len = torch.where(fl == 0, single, torch.where(
                fl == 1, 2, torch.where(fl == 2, 4, 8)))
            err[r] |= bad
            put("pos", r, torch.where(bad, get("pos", r),
                                      6 - single + fcs_len))
            put("mode", r, torch.where(bad, _M_FRAME, _M_BLK))
        # ---- block header ----------------------------------------------------
        if _M_BLK in present:
            r = rows(_M_BLK)
            p, o, c = get("pos", r), get("op", r), cs[r]
            bh = byte(r, p) | (byte(r, p + 1) << 8) | (byte(r, p + 2) << 16)
            blast, btype, bsize = bh & 1, (bh >> 1) & 3, bh >> 3
            put("last", r, blast)
            bad = (btype == 3) | (p + 3 > c)
            raw, rle, cmp = btype == 0, btype == 1, btype == 2
            bad |= raw & ((o + bsize > out_len) | (p + 3 + bsize > c))
            bad |= rle & ((o + bsize > out_len) | (p + 4 > c) | (bsize < 1))
            bad |= cmp & ((p + 3 + bsize > c) | (bsize < 2))
            err[r] |= bad
            g = ~bad
            emit(r, g & raw & (bsize > 0), 0, TW + p + 3, o, bsize)
            emit(r, g & rle, 0, TW + p + 3, o, torch.ones_like(o))
            emit(r, g & rle & (bsize > 1), 1, torch.ones_like(o), o + 1,
                 bsize - 1)
            put("op", r, torch.where(g & (raw | rle), o + bsize, o))
            put("bend", r, torch.where(g & cmp, p + 3 + bsize, get("bend", r)))
            put("pos", r, torch.where(g & raw, p + 3 + bsize, torch.where(
                g & rle, p + 4, torch.where(g & cmp, p + 3, p))))
            put("mode", r, torch.where(g, torch.where(
                cmp, _M_LITHDR, torch.where(blast == 1, _M_DONE, _M_BLK)),
                _M_BLK))
            fin[r] |= g & (raw | rle) & (blast == 1)
        # ---- literals section header -----------------------------------------
        if _M_LITHDR in present:
            r = rows(_M_LITHDR)
            p = get("pos", r)
            b0, b1, b2, b3, b4 = (byte(r, p + j) for j in range(5))
            lt, sf = b0 & 3, (b0 >> 2) & 3
            rawrle = lt <= 1
            rs_rr = torch.where((sf & 1) == 0, b0 >> 3, torch.where(
                sf == 1, (b0 >> 4) | (b1 << 4),
                (b0 >> 4) | (b1 << 4) | (b2 << 12)))
            h_rr = torch.where((sf & 1) == 0, 1, torch.where(sf == 1, 2, 3))
            rs_c = torch.where(sf <= 1, (b0 >> 4) | ((b1 & 0x3F) << 4),
                               torch.where(sf == 2,
                                           (b0 >> 4) | (b1 << 4) | ((b2 & 3) << 12),
                                           (b0 >> 4) | (b1 << 4)
                                           | ((b2 & 0x3F) << 12)))
            cs_c = torch.where(sf <= 1, (b1 >> 6) | (b2 << 2), torch.where(
                sf == 2, (b2 >> 2) | (b3 << 6),
                (b2 >> 6) | (b3 << 2) | (b4 << 10)))
            h_c = torch.where(sf <= 1, 3, torch.where(sf == 2, 4, 5))
            rsz = torch.where(rawrle, rs_rr, rs_c)
            put("ltype", r, lt)
            put("lrsz", r, rsz)
            put("lpos", r, torch.zeros_like(p))
            put("lsrc", r, torch.where(rawrle, p + h_rr, get("lsrc", r)))
            adv_rr = torch.where(lt == 0, h_rr + rs_rr, h_rr + 1)
            lce = p + h_c + cs_c
            put("lcend", r, torch.where(rawrle, get("lcend", r), lce))
            be = get("bend", r)
            bad = ((rsz > out_len) | (~rawrle & ((lce > be) | (cs_c < 1)))
                   | (rawrle & (p + adv_rr > be))
                   | ((lt == 3) & (get("hK", r) == 0)))
            err[r] |= bad
            put("pos", r, torch.where(bad, p, torch.where(rawrle, p + adv_rr,
                                                          p + h_c)))
            put("mode", r, torch.where(bad, _M_LITHDR, torch.where(
                rawrle, _M_SEQHDR, torch.where(lt == 2, _M_HUFHDR,
                                               _M_LITSETUP))))
            put("nstr", r, torch.where(sf == 0, 1, 4))
        # ---- Huffman tree description header ----------------------------------
        if _M_HUFHDR in present:
            r = rows(_M_HUFHDR)
            p = get("pos", r)
            hby = byte(r, p)
            direct = hby >= 128
            put("nw", r, torch.where(direct, hby - 127, get("nw", r)))
            put("widx", r, torch.zeros_like(p))
            warr[r] = 0
            bad = ~direct & ((p + 1 + hby > get("lcend", r)) | (hby < 1))
            err[r] |= bad
            fse = ~direct
            put("hwend", r, torch.where(fse, p + 1 + hby, get("hwend", r)))
            put("ncbp", r, torch.where(fse, (p + 1) * 8, get("ncbp", r)))
            put("tid", r, torch.where(fse, 0, get("tid", r)))
            put("ncnum", r, torch.where(fse, -1, get("ncnum", r)))
            put("pos", r, torch.where(bad, p, p + 1))
            put("mode", r, torch.where(bad, _M_HUFHDR, torch.where(
                direct, _M_HUFW_DIR, _M_NCOUNT)))
        # ---- direct 4-bit Huffman weights (all at once) ---------------------
        if _M_HUFW_DIR in present:
            r = rows(_M_HUFW_DIR)
            p, n = get("pos", r), get("nw", r)
            i = torch.arange(128, device=dev)[None, :]
            b = byte(r[:, None].expand(-1, 128), p[:, None] + (i >> 1))
            nib = torch.where((i & 1) == 0, b >> 4, b & 15)
            warr[r, :128] = torch.where(i < n[:, None], nib, 0)
            put("pos", r, p + ((n + 1) >> 1))
            put("mode", r, torch.full_like(p, _M_HUFBUILD))
        # ---- one FSE normalized count (or one run of zero-count flags) ------
        if _M_NCOUNT in present:
            r = rows(_M_NCOUNT)
            t = torch.clamp(get("tid", r), 0, 3)
            maxsym, maxlog = maxsym_t[t], maxlog_t[t]
            entry = get("ncnum", r) == -1
            bad = torch.zeros_like(entry)
            e = r[entry]
            if e.numel():
                acc = rd.bits(e, s["ncbp"][e], 4) + 5
                be = acc > maxlog[entry]
                s["nclog"][e] = acc
                s["ncrem"][e] = (1 << acc) + 1
                s["ncthr"][e] = 1 << acc
                s["ncbits"][e] = acc + 1
                s["ncp0"][e] = 0
                ncounts[e] = 0
                s["ncbp"][e] += torch.where(be, 0, 4)
                s["ncnum"][e] = torch.where(be, -1, 0)
                bad[entry] = be
            ne = ~entry
            isrep = ne & (get("ncp0", r) == 1)
            q = r[isrep]
            if q.numel():
                # the whole run of 2-bit flags (JAX errs after 8 flags of
                # 3), up to the one past the table's last symbol
                top = maxsym[isrep] + 1 - s["ncnum"][q]
                reps = torch.zeros_like(q)
                rbits = torch.zeros_like(q)
                stop = torch.zeros(q.shape, dtype=torch.bool, device=dev)
                while not bool(stop.all()):
                    fl = rd.bits(q, s["ncbp"][q] + rbits, 2)
                    reps += torch.where(stop, 0, fl)
                    rbits += torch.where(stop, 0, 2)
                    stop |= (fl < 3) | (reps > top)
                s["ncnum"][q] += reps
                s["ncbp"][q] += rbits
                s["ncp0"][q] = 0
                bad[isrep] = s["ncnum"][q] > maxsym[isrep] + 1
            isval = ne & ~isrep
            q = r[isval]
            if q.numel():
                thr, rem, nbits = s["ncthr"][q], s["ncrem"][q], s["ncbits"][q]
                bp, num = s["ncbp"][q], s["ncnum"][q]
                maxv = 2 * thr - 1 - rem
                vsm = rd.bits(q, bp, 10) & ((1 << torch.clamp(nbits - 1, 0, 10)) - 1)
                small = vsm < maxv
                vbig = rd.bits(q, bp, 11) & ((1 << torch.clamp(nbits, 0, 11)) - 1)
                vv = torch.where(small, vsm, torch.where(vbig < thr, vbig,
                                                         vbig - maxv))
                cval = vv - 1
                s["ncbp"][q] = bp + torch.where(small, nbits - 1, nbits)
                s["ncrem"][q] = rem - cval.abs()
                bad[isval] = num >= _NC_CAP
                ncounts[q, torch.clamp(num, 0, _NC_CAP - 1)] = cval
                s["ncnum"][q] = num + 1
                s["ncp0"][q] = (cval == 0).to(I64)
            q = r[ne]
            if q.numel():
                for _ in range(10):
                    dec = (s["ncrem"][q] < s["ncthr"][q]) & (s["ncthr"][q] > 1)
                    s["ncbits"][q] -= dec.to(I64)
                    s["ncthr"][q] >>= dec.to(I64)
                done = (s["ncrem"][q] <= 1) | (s["ncnum"][q] > maxsym[ne])
                bad[ne] |= done & (s["ncrem"][q] != 1)
                fwd = done & ~bad[ne]
                s["pos"][q] = torch.where(fwd, (s["ncbp"][q] + 7) >> 3,
                                          s["pos"][q])
                s["mode"][q] = torch.where(fwd, _M_FSEBUILD, s["mode"][q])
            err[r] |= bad
        # ---- FSE table build -------------------------------------------------
        if _M_FSEBUILD in present:
            r = rows(_M_FSEBUILD)
            t, lg, p = get("tid", r), get("nclog", r), get("pos", r)
            sym, nb, base, berr = _fse_build(ncounts[r], lg)
            for tid, L in enumerate(_TABW):
                m = r[t == tid]
                for tab, new in zip(tabs[tid], (sym, nb, base)):
                    tab[m] = new[t == tid, :L]
            err[r] |= berr
            sh = torch.where(t == 0, 20, torch.where(
                t == 1, 8, torch.where(t == 2, 12, 16)))
            put("smodes", r, (get("smodes", r) & ~(15 << sh)) | (lg << sh))
            w = t == 0
            rw = r[w]
            if rw.numel():
                hwe, pw, wlog = s["hwend"][rw], p[w], lg[w]
                wlb = byte(rw, hwe - 1)
                err[rw] |= (wlb == 0) | (hwe <= pw)
                hp = (hwe - 1) * 8 + _hb(torch.clamp(wlb, min=1))
                s["hwp0"][rw] = pw * 8
                s["hws0"][rw] = rback(rw, hp, wlog)
                s["hws1"][rw] = rback(rw, hp - wlog, wlog)
                s["hwp"][rw] = hp - 2 * wlog
                s["widx"][rw] = 0
                warr[rw] = 0
            put("mode", r, torch.where(w, _M_HUFW_FSE, torch.where(
                t >= 3, _M_SEQINIT, _M_SEQTABS)))
            put("tid", r, torch.where(t > 0, t + 1, t))
        # ---- one FSE-coded Huffman weight ------------------------------------
        if _M_HUFW_FSE in present:
            r = rows(_M_HUFW_FSE)
            wi, h0, h1, hp = (get(k, r) for k in ("widx", "hws0", "hws1", "hwp"))
            even = (wi & 1) == 0
            stc = torch.clamp(torch.where(even, h0, h1), 0, 63)[:, None]
            wsym, wnb, wbase = (tb[r].gather(1, stc)[:, 0] for tb in tabs[0])
            go = wi < 254
            warr[r[go], wi[go]] = wsym[go]
            nst = wbase + rback(r, hp, wnb)
            hpn = hp - wnb
            over = go & (hpn < get("hwp0", r))
            other = torch.clamp(torch.where(even, h1, h0), 0, 63)[:, None]
            osym = tabs[0][0][r].gather(1, other)[:, 0]
            warr[r[over], wi[over] + 1] = osym[over]
            adv = go & ~over
            put("hws0", r, torch.where(adv & even, nst, h0))
            put("hws1", r, torch.where(adv & ~even, nst, h1))
            put("hwp", r, torch.where(adv, hpn, hp))
            put("nw", r, torch.where(over, wi + 2, get("nw", r)))
            wn = torch.where(go, wi + 1, wi)
            put("widx", r, wn)
            err[r] |= (wn >= 254) & ~over
            put("pos", r, torch.where(over, get("hwend", r), get("pos", r)))
            put("mode", r, torch.where(over, _M_HUFBUILD, _M_HUFW_FSE))
        # ---- Huffman table build ---------------------------------------------
        if _M_HUFBUILD in present:
            r = rows(_M_HUFBUILD)
            K, hbase, hcnt, hoffs, hsym, herr = _huf_build(warr[r], get("nw", r))
            dsym, dnb = _huf_decode(v2048.expand(r.numel(), -1) << torch.clamp(
                11 - K, 0, 11)[:, None] & 2047, K, hbase, hcnt, hoffs, hsym)
            hdsym[r], hdnb[r] = dsym, dnb
            put("hK", r, torch.where(herr, get("hK", r), K))
            err[r] |= herr
            put("mode", r, torch.where(herr, _M_HUFBUILD, _M_LITSETUP))
        # ---- Huffman literal streams setup -----------------------------------
        if _M_LITSETUP in present:
            r = rows(_M_LITSETUP)
            p, lr, lce, t0 = (get(k, r) for k in ("pos", "lrsz", "lcend", "tl"))
            four = get("nstr", r) == 4
            j1, j2, j3 = (byte(r, p + k) | (byte(r, p + k + 1) << 8)
                          for k in (0, 2, 4))
            sbase = torch.where(four, p + 6, p)
            tot = lce - sbase
            s4 = tot - j1 - j2 - j3
            r13 = (lr + 3) >> 2
            r4 = lr - 3 * r13
            bad = ((four & ((s4 < 1) | (j1 < 1) | (j2 < 1) | (j3 < 1)
                            | (r4 < 0))) | (tot < 1))
            starts = torch.stack([sbase, sbase + j1, sbase + j1 + j2,
                                  sbase + j1 + j2 + j3], 1)
            sizes = torch.stack([torch.where(four, j1, tot), j2, j3, s4], 1)
            zero = torch.zeros_like(lr)
            rems = torch.stack([torch.where(four, r13, lr)]
                               + [torch.where(four, r13, zero)] * 2
                               + [torch.where(four, r4, zero)], 1)
            endk = starts + sizes
            lastb = byte(r[:, None].expand(-1, 4), endk - 1)
            use = rems > 0
            bad |= (use & ((lastb == 0) | (sizes < 1))).any(dim=1)
            sp[r] = torch.where(use, (endk - 1) * 8
                                + _hb(torch.clamp(lastb, min=1)), starts * 8)
            sb[r] = starts * 8
            st[r] = t0[:, None] + j4[None, :] * (r13 * four)[:, None]
            sr[r] = rems
            put("lbase", r, t0)
            # the tape holds out_len bytes, and every byte is an event
            bad |= (t0 + lr > TW) | (get("nev", r) + lr > E)
            err[r] |= bad
            put("tl", r, torch.where(bad, t0, t0 + lr))
            put("nev", r, get("nev", r) + torch.where(bad, 0, lr))
            put("pos", r, torch.where(bad, p, lce))
            put("mode", r, torch.where(bad, _M_LITSETUP, _M_LITDEC))
        # ---- one Huffman literal per stream ----------------------------------
        if _M_LITDEC in present:
            r = rows(_M_LITDEC)
            rr = r.repeat_interleave(4)
            p, t, rem, b0 = (x[r].reshape(-1) for x in (sp, st, sr, sb))
            go = rem > 0
            K = s["hK"][rr]
            v = rd.bits(rr, p - 11, 11) >> torch.clamp(11 - K, 0, 11)
            sym, nb = hdsym[rr, v], hdnb[rr, v]
            bad = go & (nb == 0)
            tape[rr[go], t[go]] = sym[go].to(U8)
            p = p - torch.where(go, nb, 0)
            t = t + go.to(I64)
            rem = rem - go.to(I64)
            bad |= (rem == 0) & (p != b0)
            sp[r], st[r], sr[r] = (x.view(-1, 4) for x in (p, t, rem))
            bad = bad.view(-1, 4).any(dim=1)
            err[r] |= bad
            done = rem.view(-1, 4).sum(dim=1) == 0
            put("mode", r, torch.where(done & ~bad, _M_SEQHDR, _M_LITDEC))
        # ---- sequences section header ----------------------------------------
        if _M_SEQHDR in present:
            r = rows(_M_SEQHDR)
            p, o = get("pos", r), get("op", r)
            n0, n1, n2 = (byte(r, p + j) for j in range(3))
            nbs = torch.where(n0 < 128, n0, torch.where(
                n0 < 255, ((n0 - 128) << 8) + n1, n1 + (n2 << 8) + 0x7F00))
            nbadv = torch.where(n0 < 128, 1, torch.where(n0 < 255, 2, 3))
            put("nbseq", r, nbs)
            flush = nbs == 0
            left = get("lrsz", r) - get("lpos", r)
            bad = flush & ((p + nbadv != get("bend", r)) | (o + left > out_len))
            emit_lits(r, flush & ~bad, left)
            put("op", r, torch.where(flush & ~bad, o + left, o))
            smod = byte(r, p + nbadv)
            bad |= ~flush & ((smod & 3) != 0)
            put("smodes", r, torch.where(flush, get("smodes", r),
                                         (get("smodes", r) & ~0xFF) | smod))
            err[r] |= bad
            put("pos", r, torch.where(bad, p, p + nbadv + (~flush).to(I64)))
            put("tid", r, torch.where(flush, get("tid", r), 1))
            put("mode", r, torch.where(bad, _M_SEQHDR, torch.where(
                flush, _M_BLKEND, _M_SEQTABS)))
        # ---- one sequence table mode ------------------------------------------
        if _M_SEQTABS in present:
            r = rows(_M_SEQTABS)
            t, p, sm = get("tid", r), get("pos", r), get("smodes", r)
            # a table id outside 1..3 stalls the JAX machine: it never ends
            err[r] |= (t < 1) | (t > 3)
            mb = sm & 0xFF
            msel = torch.where(t == 1, (mb >> 6) & 3, torch.where(
                t == 2, (mb >> 4) & 3, (mb >> 2) & 3))
            rsym = byte(r, p)
            bad = torch.zeros_like(t, dtype=torch.bool)
            for tid, name, mx, sh in ((1, "ll", 35, 8), (2, "of", 31, 12),
                                      (3, "ml", 52, 16)):
                L = _TABW[tid]
                mp = (t == tid) & (msel == 0)
                m = r[mp]
                for tab, a in zip(tabs[tid], pre[name][:3]):
                    tab[m] = a[:L]
                sm = torch.where(mp, (sm & ~(15 << sh)) | (pre[name][3] << sh),
                                 sm)
                mr = (t == tid) & (msel == 1)
                bad |= mr & (rsym > mx)
                m = r[mr]
                tabs[tid][0][m] = rsym[mr][:, None]
                tabs[tid][1][m] = 0
                tabs[tid][2][m] = 0
                sm = torch.where(mr, sm & ~(15 << sh), sm)
            put("smodes", r, sm)
            put("pos", r, torch.where((msel == 1) & ~bad, p + 1, p))
            fse = msel == 2
            put("ncbp", r, torch.where(fse, p * 8, get("ncbp", r)))
            put("ncnum", r, torch.where(fse, -1, get("ncnum", r)))
            adv = ~fse & ~bad
            nt = torch.where(adv, t + 1, t)
            put("mode", r, torch.where(fse, _M_NCOUNT, torch.where(
                adv & (nt > 3), _M_SEQINIT, _M_SEQTABS)))
            put("tid", r, nt)
            err[r] |= bad
        # ---- sequence bitstream setup -----------------------------------------
        if _M_SEQINIT in present:
            r = rows(_M_SEQINIT)
            p, be, sm = get("pos", r), get("bend", r), get("smodes", r)
            lb = byte(r, be - 1)
            bad = (lb == 0) | (be <= p)
            q = (be - 1) * 8 + _hb(torch.clamp(lb, min=1))
            lll, ofl, mll = (sm >> 8) & 15, (sm >> 12) & 15, (sm >> 16) & 15
            put("lls", r, rback(r, q, lll))
            put("ofs", r, rback(r, q - lll, ofl))
            put("mls", r, rback(r, q - lll - ofl, mll))
            q = q - lll - ofl - mll
            put("sqp", r, q)
            put("sqp0", r, p * 8)
            bad |= q < p * 8
            err[r] |= bad
            put("mode", r, torch.where(bad, _M_SEQINIT, _M_SEQDEC))
        # ---- one sequence ------------------------------------------------------
        if _M_SEQDEC in present:
            r = rows(_M_SEQDEC)
            # a sequence mode with no sequence left stalls the JAX machine
            err[r] |= get("nbseq", r) <= 0
            r = r[get("nbseq", r) > 0]

            def tab3(tid, state):
                i = torch.clamp(state, 0, _TABW[tid] - 1)[:, None]
                return [tb[r].gather(1, i)[:, 0] for tb in tabs[tid]]

            ofc, ofn, ofb = tab3(2, get("ofs", r))
            mlc, mln, mlbs = tab3(3, get("mls", r))
            llc, lln, llbs = tab3(1, get("lls", r))
            bad = (ofc > 25) | (mlc > 52) | (llc > 35)
            ofbits = torch.clamp(ofc, 0, 25)
            q = get("sqp", r)
            ofv = (1 << ofbits) + rback(r, q, ofbits)
            p1 = q - ofbits
            mci, lci = torch.clamp(mlc, 0, 52), torch.clamp(llc, 0, 35)
            ml = mla[mci] + rback(r, p1, mlb[mci])
            p2 = p1 - mlb[mci]
            ll = lla[lci] + rback(r, p2, llb[lci])
            p3 = p2 - llb[lci]
            r1, r2, r3 = rep[r, 0], rep[r, 1], rep[r, 2]
            big = ofv > 3
            idxr = torch.where(big, -1, ofv - 1 + (ll == 0).to(I64))
            off = torch.where(big, ofv - 3, torch.where(
                idxr == 0, r1, torch.where(idxr == 1, r2, torch.where(
                    idxr == 2, r3, r1 - 1))))
            bad |= off <= 0
            shift2 = big | (idxr >= 2)
            shift1 = shift2 | (idxr == 1)
            nrep = torch.stack([torch.where(big | (idxr > 0), off, r1),
                                torch.where(shift1, r1, r2),
                                torch.where(shift2, r2, r3)], 1)
            rep[r] = torch.where(bad[:, None], rep[r], nrep)
            o, lp, lr = get("op", r), get("lpos", r), get("lrsz", r)
            bad |= (lp + ll > lr) | (o + ll + ml > out_len) | (off > o + ll)
            go = ~bad
            emit_lits(r, go, ll)
            emit(r, go & (ml > 0), 1, off, o + ll, ml)
            o = torch.where(go, o + ll + ml, o)
            put("op", r, o)
            lp = lp + torch.where(go, ll, 0)
            put("lpos", r, lp)
            nbs = get("nbseq", r) - go.to(I64)
            put("nbseq", r, nbs)
            upd = go & (nbs > 0)
            lls_n = llbs + rback(r, p3, lln)
            p4 = p3 - lln
            mls_n = mlbs + rback(r, p4, mln)
            p5 = p4 - mln
            ofs_n = ofb + rback(r, p5, ofn)
            p6 = p5 - ofn
            put("lls", r, torch.where(upd, lls_n, get("lls", r)))
            put("mls", r, torch.where(upd, mls_n, get("mls", r)))
            put("ofs", r, torch.where(upd, ofs_n, get("ofs", r)))
            q = torch.where(go, torch.where(upd, p6, p3), q)
            put("sqp", r, q)
            q0 = get("sqp0", r)
            bad |= go & (q < q0) & (nbs > 0)
            done = go & (nbs == 0)
            left = lr - lp
            bad |= done & ((q != q0) | (o + left > out_len))
            flush = done & ~bad
            emit_lits(r, flush, left)
            put("op", r, torch.where(flush, o + left, o))
            put("mode", r, torch.where(flush, _M_BLKEND, _M_SEQDEC))
            err[r] |= bad
        # ---- end of a compressed block ----------------------------------------
        if _M_BLKEND in present:
            r = rows(_M_BLKEND)
            last = get("last", r) == 1
            put("pos", r, get("bend", r))
            fin[r] |= last
            put("mode", r, torch.where(last, _M_DONE, _M_BLK))
    ok = ~err & fin & (s["op"] == out_len)
    tlen = torch.where(ok, s["tl"], 0).to(I32)
    tape[~ok] = 0
    kind[~ok] = -1
    for f in (arg, dst, ln):
        f[~ok] = 0
    return tape, tlen, (kind, arg, dst, ln), ok


# ---------------------------------------------------------------------------
# K7's split, in plain PyTorch (tests only): the decoder and the flush
# ---------------------------------------------------------------------------

class _RowErr(Exception):
    """The row errs: tlen 0, no records, a zero tape."""


class _Bits:
    """One row as an integer: bytes at or past the width and bits below
    bit 0 read 0."""

    def __init__(self, row: torch.Tensor):
        self.W = row.numel()
        self.v = int.from_bytes(row.cpu().numpy().tobytes(), "little")

    def byte(self, x: int) -> int:
        return (self.v >> (8 * x)) & 255 if 0 <= x < self.W else 0

    def bits(self, q: int, n: int) -> int:
        v = self.v >> q if q >= 0 else self.v << -q
        return v & ((1 << n) - 1)

    def back(self, q: int, n: int) -> int:
        """bits [q - n, q): a backward stream read."""
        return self.bits(q - n, n)


def _seq_decode(rd: _Bits, q: int, q0: int, nbseq: int, logs, tabs):
    """The decoder's half of a sequence section (one row): from the
    bitstream's last bit q down to the section's first bit q0, each
    sequence's (ofv, ll, ml), with only the checks that decide how it
    decodes (a code out of range, the cursor below q0 after a state
    update). Returns (ofv, ll, ml) int64 tensors, stop (a check failed)
    and q, the cursor after the last sequence. tabs[tid] for table ids
    1-3 (LL, OF, ML): (sym, nb, base) lists of the table's cells."""
    lll, ofl, mll = logs[1], logs[2], logs[3]
    (lsym, lnb, lba), (osym, onb, oba), (msym, mnb, mba) = tabs[1:4]
    lls = rd.back(q, lll)
    ofs = rd.back(q - lll, ofl)
    mls = rd.back(q - lll - ofl, mll)
    q -= lll + ofl + mll
    out = ([], [], [])
    stop = q < q0
    left = nbseq
    while not stop and left > 0:
        ofc, mlc, llc = osym[ofs], msym[mls], lsym[lls]
        if ofc > 25 or mlc > 52 or llc > 35:
            stop = True
            break
        mlb, llb = int(_ML_BITS[mlc]), int(_LL_BITS[llc])
        p1 = q - ofc
        p2 = p1 - mlb
        p3 = p2 - llb
        out[0].append((1 << ofc) + rd.back(q, ofc))
        out[1].append(int(_LL_BASE[llc]) + rd.back(p2, llb))
        out[2].append(int(_ML_BASE[mlc]) + rd.back(p1, mlb))
        left -= 1
        if left == 0:
            q = p3
            break
        p4 = p3 - lnb[lls]
        p5 = p4 - mnb[mls]
        nxt = (lba[lls] + rd.back(p3, lnb[lls]),
               mba[mls] + rd.back(p4, mnb[mls]),
               oba[ofs] + rd.back(p5, onb[ofs]))
        q = p5 - onb[ofs]
        lls, mls, ofs = nxt
        stop = q < q0
    return (*(torch.tensor(a, dtype=I64) for a in out), stop, q)


def _seq_flush(ofv: torch.Tensor, ll: torch.Tensor, ml: torch.Tensor, rep,
               op: int, lpos: int, lrsz: int, out_len: int, lit):
    """The flush's half (one row): the decoded sequences against the row
    so far. The repeat-offset machine (4.2.2, serial over the sequences,
    rep the three offsets before them), the literal and output positions
    by prefix sums, the checks of _fsm_walk's sequence mode (a zero
    offset, literals past the section, output past out_len, an offset
    beyond the output), and the records of each sequence in order: its
    literal run by the literal type lit = (ltype, lbase, lsrc, TW), then
    its match. Returns (records (R, 4) int64, rep, op, lpos), or raises
    _RowErr when a check fails (which one does not matter: the row
    errs)."""
    n = ofv.numel()
    off = torch.zeros(n, dtype=I64)
    r1, r2, r3 = rep
    for j, (v, l) in enumerate(zip(ofv.tolist(), ll.tolist())):
        if v > 3:
            r1, r2, r3 = v - 3, r1, r2
        else:
            idx = v - 1 + (l == 0)
            o = (r1, r2, r3, r1 - 1)[idx]
            if o <= 0:
                raise _RowErr
            if idx >= 2:
                r3 = r2
            if idx >= 1:
                r1, r2 = o, r1
        off[j] = r1
    lp = lpos + torch.cumsum(ll, 0) - ll
    o = op + torch.cumsum(ll + ml, 0) - ll - ml
    bad = (lp + ll > lrsz) | (o + ll + ml > out_len) | (off > o + ll)
    if bool(bad.any()):
        raise _RowErr
    ltype, lbase, lsrc, TW = lit
    rle = ltype == 1
    src = lbase + lp if ltype >= 2 else TW + lsrc + lp
    one = torch.ones_like(ll)
    # per sequence up to three records: literal run, RLE tail, match
    cand = torch.stack([
        torch.stack([0 * one, TW + lsrc + 0 * lp if rle else src, o,
                     one if rle else ll], 1),
        torch.stack([one, one, o + 1, ll - 1], 1),
        torch.stack([one, off, o + ll, ml], 1)], 1)
    keep = torch.stack([ll > 0, (ll > 1) & rle, ml > 0], 1)
    recs = cand[keep]
    return (recs, (r1, r2, r3), op + int((ll + ml).sum()),
            lpos + int(ll.sum()))


class _SplitWalk:
    """K7's walk of one row as the kernel splits it: the frame machine
    (headers, table descriptions, Huffman literals), each sequence
    section through _seq_decode and then _seq_flush. Raises _RowErr where
    the row errs."""

    def __init__(self, row: torch.Tensor, cs: int, out_len: int, E: int):
        self.rd, self.cs, self.out_len, self.E = _Bits(row), cs, out_len, E
        self.TW, self.RC = out_len, record_cap(out_len)
        self.op = self.nev = self.nseq = 0
        self.tape, self.recs = [], []
        self.rep = (1, 4, 8)
        self.tabs = [None] * 4
        self.huf = None             # (K, sym list, nb list) of the last tree

    def emit(self, k, a, d, n):
        if self.nev >= self.E or len(self.recs) >= self.RC:
            raise _RowErr
        self.recs.append((k, a, d, n))
        self.nev += 1

    def emit_lits(self, lit, lpos, ll):
        ltype, lbase, lsrc, TW = lit
        rle = ltype == 1
        a = lbase + lpos if ltype >= 2 else TW + lsrc + lpos
        if ll > 0:
            self.emit(0, TW + lsrc if rle else a, self.op, 1 if rle else ll)
        if rle and ll > 1:
            self.emit(1, 1, self.op + 1, ll - 1)

    def ncount(self, ncbp, tid):
        """A normalized-count description at bit ncbp: (counts, acc, the
        byte after it)."""
        rd, maxsym = self.rd, _MAXSYM[tid]
        acc = rd.bits(ncbp, 4) + 5
        if acc > _MAXLOG[tid]:
            raise _RowErr
        counts = [0] * _NC_CAP
        rem, thr, nbits, num, p0 = (1 << acc) + 1, 1 << acc, acc + 1, 0, False
        ncbp += 4
        while True:
            if p0:
                while True:
                    fl = rd.bits(ncbp, 2)
                    num += fl
                    ncbp += 2
                    if fl < 3 or num > maxsym + 1:
                        break
                p0 = False
                if num > maxsym + 1:
                    raise _RowErr
            else:
                maxv = 2 * thr - 1 - rem
                sb, bb = min(max(nbits - 1, 0), 10), min(max(nbits, 0), 11)
                vsm = rd.bits(ncbp, 10) & ((1 << sb) - 1)
                vbig = rd.bits(ncbp, 11) & ((1 << bb) - 1)
                small = vsm < maxv
                cval = (vsm if small else vbig if vbig < thr
                        else vbig - maxv) - 1
                ncbp += nbits - 1 if small else nbits
                rem -= abs(cval)
                if num >= _NC_CAP:
                    raise _RowErr
                counts[num] = cval
                num += 1
                p0 = cval == 0
            while rem < thr and thr > 1:
                nbits -= 1
                thr >>= 1
            if rem <= 1 or num > maxsym:
                if rem != 1:
                    raise _RowErr
                return counts, acc, (ncbp + 7) >> 3

    def fse(self, tid, counts, acc):
        sym, nb, base, err = _fse_build(torch.tensor([counts]),
                                        torch.tensor([acc]))
        if bool(err[0]):
            raise _RowErr
        self.tabs[tid] = tuple(t[0, :_TABW[tid]].tolist()
                               for t in (sym, nb, base))

    def tree(self, pos, lcend):
        """A Huffman tree description at pos: the direct table; returns the
        byte after it."""
        rd = self.rd
        hby = rd.byte(pos)
        warr = [0] * 256
        if hby >= 128:
            nw = hby - 127
            for i in range(nw):
                b = rd.byte(pos + 1 + (i >> 1))
                warr[i] = b >> 4 if i % 2 == 0 else b & 15
            pos += 1 + ((nw + 1) >> 1)
        else:
            hwend = pos + 1 + hby
            if hwend > lcend or hby < 1:
                raise _RowErr
            counts, wlog, pos = self.ncount((pos + 1) * 8, 0)
            self.fse(0, counts, wlog)
            wsym, wnb, wbase = self.tabs[0]
            lb = rd.byte(hwend - 1)
            if lb == 0 or hwend <= pos:
                raise _RowErr
            hwp = (hwend - 1) * 8 + int(lb).bit_length() - 1
            hwp0 = pos * 8
            st = [rd.back(hwp, wlog), rd.back(hwp - wlog, wlog)]
            hwp -= 2 * wlog
            widx = 0
            while True:
                if widx >= 254:
                    raise _RowErr
                e = widx & 1
                c = min(max(st[e], 0), 63)
                warr[widx] = wsym[c]
                nst = wbase[c] + rd.back(hwp, wnb[c])
                hpn = hwp - wnb[c]
                if hpn < hwp0:
                    warr[widx + 1] = wsym[min(max(st[e ^ 1], 0), 63)]
                    nw = widx + 2
                    break
                st[e] = nst
                hwp = hpn
                widx += 1
            pos = hwend
        K, hbase, hcnt, hoffs, hsym, herr = _huf_build(
            torch.tensor([warr]), torch.tensor([nw]))
        if bool(herr[0]):
            raise _RowErr
        k = int(K[0])
        peeks = (torch.arange(2048)[None, :] << (11 - k)) & 2047
        dsym, dnb = _huf_decode(peeks, K, hbase, hcnt, hoffs, hsym)
        self.huf = (k, dsym[0].tolist(), dnb[0].tolist())
        return pos

    def streams(self, four, sbase, tot, j, lrsz):
        """The 1 or 4 Huffman streams of a literal section onto the tape."""
        rd = self.rd
        k, hsym, hnb = self.huf
        r13 = (lrsz + 3) >> 2
        sizes = [j[0], j[1], j[2], tot - sum(j)] if four else [tot]
        rems = [r13, r13, r13, lrsz - 3 * r13] if four else [lrsz]
        out = []
        start = sbase
        for size, r in zip(sizes, rems):
            sbit = start * 8
            sp = ((start + size - 1) * 8 + max(rd.byte(start + size - 1), 1)
                  .bit_length() - 1) if r > 0 else sbit
            for _ in range(r):
                v = rd.back(sp, 11) >> (11 - k)
                if hnb[v] == 0:
                    raise _RowErr
                out.append(hsym[v])
                sp -= hnb[v]
            if sp != sbit:
                raise _RowErr
            start += size
        self.tape += out

    def run(self):
        rd, cs, out_len, TW = self.rd, self.cs, self.out_len, self.TW
        if cs <= 0:
            raise _RowErr
        magic = sum(rd.byte(j) << (8 * j) for j in range(4))
        fhd = rd.byte(4)
        if magic != 0xFD2FB528 or fhd & 8 or fhd & 3:
            raise _RowErr
        single, fl = (fhd >> 5) & 1, fhd >> 6
        pos = 6 - single + (single, 2, 4, 8)[fl]
        logs = [0, 0, 0, 0]
        while True:
            bh = rd.byte(pos) | rd.byte(pos + 1) << 8 | rd.byte(pos + 2) << 16
            last, btype, bsize = bh & 1, (bh >> 1) & 3, bh >> 3
            if btype == 3 or pos + 3 > cs:
                raise _RowErr
            if btype <= 1:
                if btype == 0 and (self.op + bsize > out_len
                                   or pos + 3 + bsize > cs):
                    raise _RowErr
                if btype == 1 and (self.op + bsize > out_len or pos + 4 > cs
                                   or bsize < 1):
                    raise _RowErr
                if btype == 0 and bsize > 0:
                    self.emit(0, TW + pos + 3, self.op, bsize)
                if btype == 1:
                    self.emit(0, TW + pos + 3, self.op, 1)
                    if bsize > 1:
                        self.emit(1, 1, self.op + 1, bsize - 1)
                self.op += bsize
                pos += 3 + bsize if btype == 0 else 4
                if last:
                    break
                continue
            if pos + 3 + bsize > cs or bsize < 2:
                raise _RowErr
            bend = pos + 3 + bsize
            pos += 3
            b = [rd.byte(pos + i) for i in range(5)]
            lt, sf = b[0] & 3, (b[0] >> 2) & 3
            lsrc = lbase = 0
            if lt <= 1:
                h = 1 if (sf & 1) == 0 else 2 if sf == 1 else 3
                rs = (b[0] >> 3 if h == 1 else
                      (b[0] >> 4) | (b[1] << 4) | ((b[2] << 12) if h == 3 else 0))
                adv = h + rs if lt == 0 else h + 1
                if rs > out_len or pos + adv > bend:
                    raise _RowErr
                lrsz, lsrc = rs, pos + h
                pos += adv
            else:
                rs = ((b[0] >> 4) | ((b[1] & 0x3F) << 4) if sf <= 1 else
                      (b[0] >> 4) | (b[1] << 4) | ((b[2] & 3) << 12) if sf == 2
                      else (b[0] >> 4) | (b[1] << 4) | ((b[2] & 0x3F) << 12))
                csz = ((b[1] >> 6) | (b[2] << 2) if sf <= 1 else
                       (b[2] >> 2) | (b[3] << 6) if sf == 2 else
                       (b[2] >> 6) | (b[3] << 2) | (b[4] << 10))
                h = 3 if sf <= 1 else 4 if sf == 2 else 5
                lcend = pos + h + csz
                if (rs > out_len or lcend > bend or csz < 1
                        or (lt == 3 and self.huf is None)):
                    raise _RowErr
                lrsz = rs
                pos += h
                if lt == 2:
                    pos = self.tree(pos, lcend)
                four = sf != 0
                j = [rd.byte(pos + i) | rd.byte(pos + i + 1) << 8
                     for i in (0, 2, 4)]
                sbase = pos + 6 if four else pos
                tot = lcend - sbase
                r13 = (lrsz + 3) >> 2
                if four and (tot - sum(j) < 1 or min(j) < 1
                             or lrsz - 3 * r13 < 0):
                    raise _RowErr
                if (tot < 1 or len(self.tape) + lrsz > TW
                        or self.nev + lrsz > self.E):
                    raise _RowErr
                starts = ([sbase, sbase + j[0], sbase + j[0] + j[1],
                           sbase + sum(j)] if four else [sbase])
                sizes = [j[0], j[1], j[2], tot - sum(j)] if four else [tot]
                rems = ([r13, r13, r13, lrsz - 3 * r13] if four else [lrsz])
                for st_, sz, r in zip(starts, sizes, rems):
                    if r > 0 and (rd.byte(st_ + sz - 1) == 0 or sz < 1):
                        raise _RowErr
                lbase = len(self.tape)
                self.streams(four, sbase, tot, j, lrsz)
                self.nev += lrsz
                pos = lcend
            lit = (lt, lbase, lsrc, TW)
            n0, n1, n2 = (rd.byte(pos + i) for i in range(3))
            nbseq = (n0 if n0 < 128 else ((n0 - 128) << 8) + n1 if n0 < 255
                     else n1 + (n2 << 8) + 0x7F00)
            nbadv = 1 if n0 < 128 else 2 if n0 < 255 else 3
            if nbseq == 0:
                if pos + nbadv != bend or self.op + lrsz > out_len:
                    raise _RowErr
                self.emit_lits(lit, 0, lrsz)
                self.op += lrsz
            else:
                smod = rd.byte(pos + nbadv)
                if smod & 3:
                    raise _RowErr
                pos += nbadv + 1
                for tid, name in ((1, "ll"), (2, "of"), (3, "ml")):
                    msel = (smod >> (8 - 2 * tid)) & 3
                    if msel == 0:
                        sym, nb, base, log = _PRE[name]
                        self.tabs[tid] = tuple(a[:_TABW[tid]].tolist()
                                               for a in (sym, nb, base))
                        logs[tid] = log
                    elif msel == 1:
                        rsym = rd.byte(pos)
                        if rsym > _MAXSYM[tid]:
                            raise _RowErr
                        L = _TABW[tid]
                        self.tabs[tid] = ([rsym] * L, [0] * L, [0] * L)
                        logs[tid] = 0
                        pos += 1
                    elif msel == 2:
                        counts, acc, pos = self.ncount(pos * 8, tid)
                        self.fse(tid, counts, acc)
                        logs[tid] = acc
                lb = rd.byte(bend - 1)
                if lb == 0 or bend <= pos:
                    raise _RowErr
                q0 = pos * 8
                ofv, ll, ml, stop, q = _seq_decode(
                    rd, (bend - 1) * 8 + lb.bit_length() - 1, q0, nbseq, logs,
                    self.tabs)
                if stop:
                    raise _RowErr
                recs, self.rep, self.op, lpos = _seq_flush(
                    ofv, ll, ml, self.rep, self.op, 0, lrsz, out_len, lit)
                self.recs += [tuple(r) for r in recs.tolist()]
                self.nev += recs.shape[0]
                self.nseq += ofv.numel()
                if self.nev > self.E or len(self.recs) > self.RC:
                    raise _RowErr
                if q != q0 or self.op + (lrsz - lpos) > out_len:
                    raise _RowErr
                self.emit_lits(lit, lpos, lrsz - lpos)
                self.op += lrsz - lpos
            pos = bend
            if last:
                break
        if self.op != out_len:
            raise _RowErr


def _fsm_walk_split(slots: torch.Tensor, csizes: torch.Tensor, out_len: int,
                    E: int):
    """K7's function as the kernel splits it, row by row in plain PyTorch
    (tests only): _fsm_walk_plain's outputs, plus per row the sequences
    the decoder took (valid on rows that are ok)."""
    N = slots.shape[0]
    RC = record_cap(out_len)
    tape = torch.zeros((N, out_len), dtype=U8)
    tlen = torch.zeros(N, dtype=I32)
    kind, arg, dst, ln = structured.empty_records(N, RC, torch.device("cpu"))
    ok = torch.zeros(N, dtype=torch.bool)
    nseq = torch.zeros(N, dtype=I32)
    for i in range(N):
        w = _SplitWalk(slots[i], int(csizes[i]), out_len, E)
        try:
            w.run()
        except _RowErr:
            nseq[i] = w.nseq
            continue
        ok[i] = True
        nseq[i] = w.nseq
        tlen[i] = len(w.tape)
        tape[i, :len(w.tape)] = torch.tensor(w.tape, dtype=U8)
        if w.recs:
            r = torch.tensor(w.recs, dtype=I32)
            for f, c in zip((kind, arg, dst, ln), r.unbind(1)):
                f[i, :r.shape[0]] = c
    dev = slots.device
    rf = tuple(f.to(dev) for f in (kind, arg, dst, ln))
    return tape.to(dev), tlen.to(dev), rf, ok.to(dev), nseq.to(dev)


# ---------------------------------------------------------------------------
# Decode: walk + expand placement
# ---------------------------------------------------------------------------

def decode(slots: torch.Tensor, csizes: torch.Tensor, out_len: int,
           maxev_hint: int = 0):
    """Decode batched zstd frames on the device.

    Returns (out uint8 (N, out_len), produced int32 (N,), err bool (N,))
    as cblosc_tpu.tpu.codec_zstd.decode does: rows the walk rejects
    (dictionaries, malformed frames, event or record overflow) report
    err, and so do a csize-0 row and every live row of a geometry
    outside decode_cap (or below 8 bytes); the byte API retries once with
    high_events and then decodes the chunk on the host. Every row the
    walk accepts is placed by the expand kernel (K1) over [tape |
    stream]. maxev_hint overrides the budget default_events(out_len)."""
    N, W = slots.shape
    dev = slots.device
    if out_len > structured.decode_cap() or out_len < 8:
        return (torch.zeros((N, out_len), dtype=U8, device=dev),
                torch.zeros(N, dtype=I32, device=dev), csizes > 0)
    maxev = maxev_hint or default_events(out_len)
    tape, _, rf, ok = fsm_walk(slots, csizes, out_len, maxev)
    out = torch.zeros((N, out_len), dtype=U8, device=dev)
    k = torch.nonzero(ok).flatten()
    if k.numel():
        src = torch.cat([tape[k], slots[k]], dim=1)
        out[k] = structured.kernel_place_rows(
            src, tuple(f[k] for f in rf), out_len, out_len + W)
    return out, torch.where(ok, out_len, 0).to(I32), ~ok
