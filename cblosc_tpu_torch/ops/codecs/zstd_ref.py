"""Readable zstd frame decoder (decode side only), RFC 8878.

The PyTorch package's copy of cblosc_tpu/ops/codecs/zstd_ref.py (a
parity test holds the two equal, apart from two fixes: a frame whose
blocks run past its end and an FSE count description whose remainder
goes below 0, which the original reads forever, are refused here): a
pure-Python decoder of the zstd
frame format as one-shot ``ZSTD_compress`` writes it (the reference's
usage, blosc/blosc.c:498-522). The device decoder
(gpu/codec_zstd.py) takes its constant tables (LL_BITS, LL_BASE,
ML_BITS, ML_BASE, the predefined distributions) from here, and the
tests use the decoder as a third engine beside libzstd and the device
path. The production host decode stays libzstd (ops/codecs/zstd_.py).

Scope (everything the one-shot simple API emits):
  * frames with any FCS field size, with/without content checksum
    (checksum bytes are not verified — format validation lives in the
    chunk layer);
  * raw / RLE / compressed blocks;
  * literals: raw, RLE, Huffman (direct or FSE-compressed weights),
    1- and 4-stream, treeless repeats;
  * sequences: predefined / RLE / FSE-compressed / repeat table modes,
    full repeat-offset semantics.
Not in scope: dictionaries (blosc never uses them), skippable frames,
multi-frame concatenation.

Layout references cite RFC 8878 section numbers.
"""

from __future__ import annotations

# ---------------------------------------------------------------------------
# bitstreams
# ---------------------------------------------------------------------------


class _FwdBits:
    """Forward LSB-first bit reader (FSE table descriptions, 4.1.1)."""

    def __init__(self, buf: bytes, pos: int = 0):
        self.buf = buf
        self.bit = pos * 8

    def read(self, n: int) -> int:
        v = 0
        for i in range(n):
            b = self.bit + i
            v |= ((self.buf[b >> 3] >> (b & 7)) & 1) << i
        self.bit += n
        return v

    def byte_align(self) -> int:
        """Consumed bytes (table descriptions end byte-aligned)."""
        return (self.bit + 7) >> 3


class _BackBits:
    """Backward bit reader (Huffman streams, sequences; 3.1.1.2).

    Values written LSB-first at increasing bit positions read back
    verbatim: read(n) consumes the n bits just below the cursor."""

    def __init__(self, buf: bytes):
        if not buf or buf[-1] == 0:
            raise ValueError("zstd: missing bitstream sentinel")
        top = buf[-1].bit_length() - 1          # sentinel bit position
        self.buf = buf
        self.bit = 8 * (len(buf) - 1) + top     # bits below are payload

    def read(self, n: int) -> int:
        if n == 0:
            return 0
        self.bit -= n
        p = self.bit
        if p < 0:
            # zstd semantics: reads may over-consume past the start by
            # up to the register-refill margin; missing bits are zero
            v = 0
            for i in range(n):
                b = p + i
                if b >= 0:
                    v |= ((self.buf[b >> 3] >> (b & 7)) & 1) << i
            return v
        v = 0
        for i in range(n):
            b = p + i
            v |= ((self.buf[b >> 3] >> (b & 7)) & 1) << i
        return v

    def exhausted(self) -> bool:
        return self.bit <= 0


# ---------------------------------------------------------------------------
# FSE (4.1)
# ---------------------------------------------------------------------------


def read_ncount(buf: bytes, pos: int, max_symbol: int):
    """FSE table description (4.1.1). Returns (norm_counts, table_log,
    bytes_consumed). Counts use -1 for 'less than 1' probabilities."""
    bits = _FwdBits(buf, pos)
    table_log = bits.read(4) + 5
    if table_log > 9:
        raise ValueError("zstd: accuracy log > 9")
    remaining = (1 << table_log) + 1
    threshold = 1 << table_log
    nbits = table_log + 1
    counts: list[int] = []
    prev0 = False
    while remaining > 1 and len(counts) <= max_symbol:
        if prev0:
            # runs of zero counts, 2-bit repeat flags (4.1.1)
            while True:
                rep = bits.read(2)
                counts.extend([0] * rep)
                if rep < 3:
                    break
            prev0 = False
            if len(counts) > max_symbol:
                break
            continue
        maxv = 2 * threshold - 1 - remaining
        v = bits.read(nbits - 1)
        if v < maxv:
            count = v
        else:
            v2 = bits.read(1)
            v |= v2 << (nbits - 1)
            count = v if v < threshold else v - maxv
        count -= 1                               # -1 = lowprob
        remaining -= -count if count < 0 else count
        counts.append(count)
        prev0 = count == 0
        # a corrupt description can drive `remaining` below 0; the
        # threshold stops at 1 (the original loops forever there) and the
        # check below refuses it, as libzstd does
        while remaining < threshold and threshold > 1:
            nbits -= 1
            threshold >>= 1
    if remaining != 1:
        raise ValueError("zstd: corrupt FSE ncount")
    counts.extend([0] * (max_symbol + 1 - len(counts)))
    return counts, table_log, bits.byte_align() - pos


def build_fse_table(counts, table_log: int):
    """FSE decode table (4.1.1): per state (symbol, nb_bits, baseline)."""
    size = 1 << table_log
    sym = [0] * size
    high = size - 1
    for s, c in enumerate(counts):
        if c == -1:
            sym[high] = s
            high -= 1
    step = (size >> 1) + (size >> 3) + 3
    pos = 0
    for s, c in enumerate(counts):
        for _ in range(max(c, 0)):
            sym[pos] = s
            pos = (pos + step) & (size - 1)
            while pos > high:
                pos = (pos + step) & (size - 1)
    if pos != 0:
        raise ValueError("zstd: FSE spread did not close")
    nxt = [1 if c == -1 else c for c in counts]
    nb = [0] * size
    base = [0] * size
    for u in range(size):
        s = sym[u]
        ns = nxt[s]
        nxt[s] += 1
        nb[u] = table_log - (ns.bit_length() - 1)
        base[u] = (ns << nb[u]) - size
    return sym, nb, base


# ---------------------------------------------------------------------------
# Huffman (4.2)
# ---------------------------------------------------------------------------


def read_huffman(buf: bytes, pos: int):
    """Huffman tree description (4.2.1). Returns (weights incl. the
    implied last symbol, bytes_consumed)."""
    hbyte = buf[pos]
    if hbyte >= 128:
        n = hbyte - 127
        weights = []
        for i in range(n):
            b = buf[pos + 1 + (i >> 1)]
            weights.append((b >> 4) if i % 2 == 0 else (b & 0xF))
        used = 1 + (n + 1) // 2
    else:
        csize = hbyte
        counts, tlog, hdr = read_ncount(buf, pos + 1, 255)
        table = build_fse_table(counts, tlog)
        bs = _BackBits(buf[pos + 1 + hdr: pos + 1 + csize])
        sym, nb, base = table
        states = [bs.read(tlog), bs.read(tlog)]
        weights = []
        i = 0
        # two interleaved states; updates past the stream start read
        # zero bits; once an update over-consumes, each state emits one
        # final symbol and decoding stops (RFC 8878 4.2.1)
        while len(weights) <= 255:
            st = states[i]
            weights.append(sym[st])
            states[i] = base[st] + bs.read(nb[st])
            if bs.bit < 0:
                weights.append(sym[states[1 - i]])
                break
            i ^= 1
        used = 1 + csize
    total = sum((1 << (w - 1)) for w in weights if w > 0)
    if total == 0:
        raise ValueError("zstd: empty huffman table")
    table_log = total.bit_length()               # log2 of next pow2 > total
    rest = (1 << table_log) - total
    if rest & (rest - 1):
        raise ValueError("zstd: huffman weights do not sum to a power of 2")
    weights.append(rest.bit_length())            # implied last weight
    if table_log > 11:
        raise ValueError("zstd: huffman table log > 11")
    return weights, table_log, used


def build_huffman_table(weights, table_log: int):
    """Direct-lookup decode table (4.2.1): symbols placed from weight 1
    (longest codes) upward, natural symbol order within a weight; each
    weight-w symbol spans 2^(w-1) consecutive cells."""
    size = 1 << table_log
    sym = [0] * size
    nb = [0] * size
    pos = 0
    for w in range(1, table_log + 1):
        for s, ws in enumerate(weights):
            if ws != w:
                continue
            span = 1 << (w - 1)
            for i in range(pos, pos + span):
                sym[i] = s
                nb[i] = table_log + 1 - w
            pos += span
    if pos != size:
        raise ValueError("zstd: huffman table underfilled")
    return sym, nb


def _huf_decode_stream(buf: bytes, table, table_log: int, n_out: int):
    sym, nb = table
    bs = _BackBits(buf)
    out = bytearray()
    for _ in range(n_out):
        # peek table_log bits below the cursor: the next code sits in
        # the HIGH bits of that window (written earlier = lower bits)
        p = bs.bit - table_log
        v = 0
        for i in range(table_log):
            b = p + i
            if b >= 0:
                v |= ((buf[b >> 3] >> (b & 7)) & 1) << i
        out.append(sym[v])
        bs.bit -= nb[v]
    if bs.bit != 0:
        raise ValueError("zstd: huffman stream not fully consumed")
    return bytes(out)


# ---------------------------------------------------------------------------
# sequences (4.1.2, 3.1.1.3.2)
# ---------------------------------------------------------------------------

# predefined distributions (3.1.1.3.2.2)
_LL_DEFAULT = [4, 3, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 1, 1, 1, 2, 2, 2, 2,
               2, 2, 2, 2, 2, 3, 2, 1, 1, 1, 1, 1, -1, -1, -1, -1]
_ML_DEFAULT = [1, 4, 3, 2, 2, 2, 2, 2, 2, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
               1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
               1, 1, 1, 1, 1, 1, -1, -1, -1, -1, -1, -1, -1]
_OF_DEFAULT = [1, 1, 1, 1, 1, 1, 2, 2, 2, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
               1, 1, 1, 1, -1, -1, -1, -1, -1]

LL_BITS = [0] * 16 + [1, 1, 1, 1, 2, 2, 3, 3, 4, 6, 7, 8, 9, 10, 11, 12,
                      13, 14, 15, 16]
LL_BASE = list(range(16)) + [16, 18, 20, 22, 24, 28, 32, 40, 48, 64, 128,
                             256, 512, 1024, 2048, 4096, 8192, 16384,
                             32768, 65536]
ML_BITS = [0] * 32 + [1, 1, 1, 1, 2, 2, 3, 3, 4, 4, 5, 7, 8, 9, 10, 11,
                      12, 13, 14, 15, 16]
ML_BASE = list(range(3, 35)) + [35, 37, 39, 41, 43, 47, 51, 59, 67, 83,
                                99, 131, 259, 515, 1027, 2051, 4099, 8195,
                                16387, 32771, 65539]


def _predef(which: str):
    dist, log = {
        "ll": (_LL_DEFAULT, 6), "ml": (_ML_DEFAULT, 6), "of": (_OF_DEFAULT, 5)
    }[which]
    return build_fse_table(dist, log), log


class _SeqTables:
    """Carried across blocks for the Repeat_Mode (3.1.1.3.2.1)."""

    def __init__(self):
        self.ll = self.of = self.ml = None       # (table, log)
        self.huf = None                          # (table, log)


def _read_seq_table(buf: bytes, pos: int, mode: int, which: str,
                    max_symbol: int, carried):
    """One symbol-compression-mode table (3.1.1.3.2.1)."""
    if mode == 0:
        return _predef(which), pos
    if mode == 1:                                # RLE: one byte = symbol
        s = buf[pos]
        if s > max_symbol:
            raise ValueError("zstd: RLE symbol out of range")
        return (([s], [0], [0]), 0), pos + 1
    if mode == 2:
        counts, tlog, used = read_ncount(buf, pos, max_symbol)
        return (build_fse_table(counts, tlog), tlog), pos + used
    if carried is None:
        raise ValueError("zstd: repeat mode without previous table")
    return carried, pos


def _decode_sequences(buf: bytes, nbseq: int, tables, logs):
    (ll_t, of_t, ml_t) = tables
    (ll_log, of_log, ml_log) = logs
    bs = _BackBits(buf)
    ll_state = bs.read(ll_log)
    of_state = bs.read(of_log)
    ml_state = bs.read(ml_log)
    seqs = []
    for i in range(nbseq):
        of_code = of_t[0][of_state]
        ml_code = ml_t[0][ml_state]
        ll_code = ll_t[0][ll_state]
        if of_code > 31 or ml_code > 52 or ll_code > 35:
            raise ValueError("zstd: sequence code out of range")
        ofv = (1 << of_code) + bs.read(of_code)
        ml = ML_BASE[ml_code] + bs.read(ML_BITS[ml_code])
        ll = LL_BASE[ll_code] + bs.read(LL_BITS[ll_code])
        seqs.append((ll, ml, ofv))
        if i + 1 < nbseq:
            ll_state = ll_t[2][ll_state] + bs.read(ll_t[1][ll_state])
            ml_state = ml_t[2][ml_state] + bs.read(ml_t[1][ml_state])
            of_state = of_t[2][of_state] + bs.read(of_t[1][of_state])
    return seqs


# ---------------------------------------------------------------------------
# frame decode
# ---------------------------------------------------------------------------

_MAGIC = 0xFD2FB528


def decompress(src, max_out: int) -> bytes:
    """Decode one zstd frame (3.1.1). Raises ValueError on anything
    malformed or out of this module's scope."""
    buf = bytes(src)
    if len(buf) < 9:
        raise ValueError("zstd: frame too short")
    if int.from_bytes(buf[:4], "little") != _MAGIC:
        raise ValueError("zstd: bad magic")
    fhd = buf[4]
    pos = 5
    single = (fhd >> 5) & 1
    if fhd & 0x08:
        raise ValueError("zstd: reserved FHD bit set")
    if not single:
        pos += 1                                  # window descriptor
    did_flag = fhd & 3
    pos += (0, 1, 2, 4)[did_flag]
    if did_flag and int.from_bytes(buf[5:pos], "little") != 0:
        raise ValueError("zstd: dictionaries not supported")
    fcs_flag = fhd >> 6
    fcs_len = (1 if single else 0, 2, 4, 8)[fcs_flag]
    fcs = int.from_bytes(buf[pos: pos + fcs_len], "little") if fcs_len else None
    if fcs_flag == 1:
        fcs += 256
    pos += fcs_len

    out = bytearray()
    tabs = _SeqTables()
    reps = [1, 4, 8]
    last = False
    while not last:
        if pos + 3 > len(buf):
            # the original reads empty headers past the end as raw blocks
            # of 0 bytes, forever
            raise ValueError("zstd: truncated frame")
        bh = int.from_bytes(buf[pos: pos + 3], "little")
        pos += 3
        last = bh & 1
        btype = (bh >> 1) & 3
        bsize = bh >> 3
        if btype == 0:                            # raw
            out += buf[pos: pos + bsize]
            pos += bsize
        elif btype == 1:                          # RLE
            out += buf[pos: pos + 1] * bsize
            pos += 1
        elif btype == 2:
            pos = _compressed_block(buf, pos, bsize, out, tabs, reps,
                                    max_out)
        else:
            raise ValueError("zstd: reserved block type")
        if len(out) > max_out:
            raise ValueError("zstd: output overflow")
    if fcs is not None and len(out) != fcs:
        raise ValueError("zstd: content size mismatch")
    return bytes(out)


def _compressed_block(buf, pos, bsize, out, tabs, reps, max_out):
    end = pos + bsize
    # ---- literals section (3.1.1.3.1) ------------------------------------
    b0 = buf[pos]
    ltype = b0 & 3
    sf = (b0 >> 2) & 3
    if ltype in (0, 1):                           # raw / RLE literals
        if sf in (0, 2):
            rsize = b0 >> 3
            pos += 1
        elif sf == 1:
            rsize = (b0 >> 4) | (buf[pos + 1] << 4)
            pos += 2
        else:
            rsize = (b0 >> 4) | (buf[pos + 1] << 4) | (buf[pos + 2] << 12)
            pos += 3
        if ltype == 0:
            lits = buf[pos: pos + rsize]
            pos += rsize
        else:
            lits = buf[pos: pos + 1] * rsize
            pos += 1
    else:                                         # compressed / treeless
        if sf == 0:
            streams, rsize, csize = 1, ((b0 >> 4) | ((buf[pos + 1] & 0x3F)
                                                     << 4)), 0
            csize = (buf[pos + 1] >> 6) | (buf[pos + 2] << 2)
            pos += 3
        elif sf == 1:
            rsize = (b0 >> 4) | ((buf[pos + 1] & 0x3F) << 4)
            csize = (buf[pos + 1] >> 6) | (buf[pos + 2] << 2)
            streams = 4
            pos += 3
        elif sf == 2:
            rsize = (b0 >> 4) | (buf[pos + 1] << 4) | ((buf[pos + 2] & 3)
                                                       << 12)
            csize = (buf[pos + 2] >> 2) | (buf[pos + 3] << 6)
            streams = 4
            pos += 4
        else:
            rsize = (b0 >> 4) | (buf[pos + 1] << 4) | ((buf[pos + 2] & 0x3F)
                                                       << 12)
            csize = (buf[pos + 2] >> 6) | (buf[pos + 3] << 2) | (
                buf[pos + 4] << 10)
            streams = 4
            pos += 5
        cend = pos + csize
        if ltype == 2:
            weights, tlog, used = read_huffman(buf, pos)
            tabs.huf = (build_huffman_table(weights, tlog), tlog)
            pos += used
        elif tabs.huf is None:
            raise ValueError("zstd: treeless literals without a table")
        table, tlog = tabs.huf
        if streams == 1:
            lits = _huf_decode_stream(buf[pos:cend], table, tlog, rsize)
        else:
            s1 = int.from_bytes(buf[pos: pos + 2], "little")
            s2 = int.from_bytes(buf[pos + 2: pos + 4], "little")
            s3 = int.from_bytes(buf[pos + 4: pos + 6], "little")
            pos += 6
            s4 = cend - pos - s1 - s2 - s3
            if s4 <= 0:
                raise ValueError("zstd: bad literal stream sizes")
            r13 = (rsize + 3) // 4
            r4 = rsize - 3 * r13
            if r4 < 0:
                raise ValueError("zstd: bad regenerated size")
            lits = b""
            for sz, rn in ((s1, r13), (s2, r13), (s3, r13), (s4, r4)):
                lits += _huf_decode_stream(buf[pos: pos + sz], table,
                                           tlog, rn)
                pos += sz
        if len(lits) != rsize:
            raise ValueError("zstd: literal count mismatch")
        pos = cend

    # ---- sequences section (3.1.1.3.2) ------------------------------------
    nb0 = buf[pos]
    if nb0 == 0:
        nbseq = 0
        pos += 1
    elif nb0 < 128:
        nbseq = nb0
        pos += 1
    elif nb0 < 255:
        nbseq = ((nb0 - 128) << 8) + buf[pos + 1]
        pos += 2
    else:
        nbseq = int.from_bytes(buf[pos + 1: pos + 3], "little") + 0x7F00
        pos += 3
    if nbseq == 0:
        out += lits
        if pos != end:
            raise ValueError("zstd: trailing bytes in block")
        return pos
    modes = buf[pos]
    if modes & 3:
        raise ValueError("zstd: reserved mode bits set")
    pos += 1
    (ll_e, pos) = _read_seq_table(buf, pos, (modes >> 6) & 3, "ll", 35,
                                  tabs.ll)
    (of_e, pos) = _read_seq_table(buf, pos, (modes >> 4) & 3, "of", 31,
                                  tabs.of)
    (ml_e, pos) = _read_seq_table(buf, pos, (modes >> 2) & 3, "ml", 52,
                                  tabs.ml)
    tabs.ll, tabs.of, tabs.ml = ll_e, of_e, ml_e
    seqs = _decode_sequences(
        buf[pos:end], nbseq,
        (ll_e[0], of_e[0], ml_e[0]), (ll_e[1], of_e[1], ml_e[1]))

    # ---- sequence execution (3.1.1.4) --------------------------------------
    lpos = 0
    for ll, ml, ofv in seqs:
        out += lits[lpos: lpos + ll]
        lpos += ll
        if ofv > 3:
            off = ofv - 3
            reps[2], reps[1], reps[0] = reps[1], reps[0], off
        else:
            ll0 = 1 if ll == 0 else 0
            idx = ofv - 1 + ll0
            if idx == 0:
                off = reps[0]
            elif idx == 1:
                off = reps[1]
                reps[1], reps[0] = reps[0], off
            elif idx == 2:
                off = reps[2]
                reps[2], reps[1], reps[0] = reps[1], reps[0], off
            else:
                off = reps[0] - 1
                if off == 0:
                    raise ValueError("zstd: zero repeat offset")
                reps[2], reps[1], reps[0] = reps[1], reps[0], off
        if off > len(out) or off <= 0:
            raise ValueError("zstd: offset beyond output")
        for _ in range(ml):
            out.append(out[-off])
        if len(out) > max_out:
            raise ValueError("zstd: output overflow")
    out += lits[lpos:]
    return end
