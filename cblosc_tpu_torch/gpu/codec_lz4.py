"""Device LZ4 block-format codec: vectorized encoder + structured decoder.

PyTorch counterpart of cblosc_tpu/tpu/codec_lz4.py (wire grammar per
sequence: token = litlen<<4 | matchlen-4, 255-extension bytes, literals,
2-byte LE offset; reference wrappers blosc/blosc.c:412-440). LZ4HC
chunks carry the same wire format.

  * The encoder is the JAX package's periodic-match strategy, byte for
    byte: per-stream distance selection over static shifts, cummax/
    cummin segmentation, prefix-sum layout and ONE key sort per row.
    A literal stretch's token carries the FOLLOWING match's length
    nibble (a reverse fill); matches are >= 4 bytes, never start in the
    last 12 bytes and never reach into the last 5 (MFLIMIT /
    LASTLITERALS), and a maximal run is one sequence. At the ratio
    clevels (``encode(..., mine=True)``) the blosclz encoder's
    :func:`codec.mine_group`, capped at the 16-bit offset, layers a
    mined distance's runs in first; a run that abuts an earlier one
    carries its own zero-literal token.
  * The decoder walks sequences into compacted records — the
    hand-written kernel K4 (csrc/lz4_walk.cu) on a CUDA tensor,
    :func:`_walk_plain` on a CPU tensor — and places them with the
    shared machinery (gpu/structured.decode_core: pure tiles, expand).
    Rows the walk rejects report err; the byte API then retries with a
    wider budget and, failing that, decodes the chunk on the host, as
    the JAX package does.
"""

from __future__ import annotations

import torch

from . import codec, structured

I32 = torch.int32
I64 = torch.int64
U8 = torch.uint8

# sort key of "no byte here" (the JAX encoder's codec._BIG). A key is
# (pos << 8) | byte in int32, pos < slot_width(n); the keys of real bytes
# stay below _BIG only while slot_width(n) <= _BIG >> 8 (2^21). A wider
# row would sort every byte past 2 MiB behind the empty keys (and past
# 2^23 positions overflow int32), so encode refuses it: the 8 KB splits
# of the speed clevels are far inside, but a forced blocksize of 4 MB at
# typesize 1 is not, and such chunks encode on the host
_BIG = 1 << 29


def slot_width(n: int) -> int:
    """Worst case: token + litlen ext + all-literal payload + slack."""
    return n + n // 255 + 16


def fits(n: int) -> bool:
    """Whether rows of n bytes fit the encoder's int32 sort keys."""
    return slot_width(n) <= _BIG >> 8


# ---------------------------------------------------------------------------
# Encoder
# ---------------------------------------------------------------------------

def encode(s: torch.Tensor, dists: tuple = codec.DISTANCES,
           min_cratio_x100: int = 0, mine: bool = False):
    """Encode batched streams into LZ4 block format.

    s: uint8 (N, n). Returns (slots uint8 (N, slot_width(n)), csizes
    int32 (N,), est_iters int32 (N,)), equal to
    cblosc_tpu.tpu.codec_lz4.encode's on every row; with mining, bytes
    and est_iters on every row with csize < n. Rows whose estimated
    ratio falls below min_cratio_x100/100 report csize n, est 0 and zero
    slots without being emitted (JAX runs its groups of such rows through
    the same raw branch), unless mining adopts a distance on them. Rows
    too wide for the int32 keys (see :func:`fits`) raise ValueError."""
    N, n = s.shape
    if not fits(n):
        raise ValueError(f"LZ4 rows of {n} bytes overflow the encoder's "
                         "int32 sort keys")
    dev = s.device
    covs = []
    for d in dists:
        if d < n - 2:
            e = s[:, d:] == s[:, :n - d]
            h3 = e[:, 2:] & e[:, 1:-1] & e[:, :-2]
            covs.append(h3.sum(dim=1, dtype=I32))
        else:
            covs.append(torch.zeros(N, dtype=I32, device=dev))
    stack = torch.stack(covs, 0)
    best = torch.argmax(stack, dim=0)                    # first maximum
    d_row = torch.tensor(dists, dtype=I32, device=dev)[best][:, None]

    # JAX's class-aligned grouping exists to run lax.cond per group; a
    # row's bytes do not depend on its group, so only the condition that
    # selects the grouped branch is kept, exactly (N counts the rows of
    # this call: gpu.pipeline keeps JAX's encode groups for that reason)
    if not (min_cratio_x100 and N > 8 and n >= 8):
        return _emit_grouped(s, d_row, dists, mine and n >= 1024)
    cov = stack.max(dim=0).values
    est_csize = n - cov + cov // 170 + n // 33 + 16
    hopeless = 100 * n < min_cratio_x100 * est_csize
    slots = torch.zeros((N, slot_width(n)), dtype=U8, device=dev)
    csize = torch.full((N,), n, dtype=I32, device=dev)
    est = torch.zeros(N, dtype=I32, device=dev)
    rows = torch.nonzero(~hopeless).flatten()
    if rows.numel():
        slots[rows], csize[rows], est[rows] = _emit_grouped(
            s[rows], d_row[rows], dists, mine)
    if mine:
        # hopeless rows are mined too, and emitted where a distance is
        # adopted
        rows = torch.nonzero(hopeless).flatten()
        if rows.numel():
            slots[rows], csize[rows], est[rows] = _emit_grouped(
                s[rows], d_row[rows], dists, True, emit_all=False)
    return slots, csize, est


def _emit_grouped(s: torch.Tensor, d_row: torch.Tensor, dists: tuple,
                  mine: bool = False, emit_all: bool = True):
    """_emit over row groups (rows are independent; groups bound the
    int32 workspace to ~32 MB per intermediate), each group mined first
    (codec.mine_group, 16-bit offsets) when mine is set. emit_all False
    emits only the rows that adopt a mined distance; the others report
    csize n, est 0 and zero slots."""
    N, n = s.shape
    dev = s.device
    g = max(1, (8 << 20) // max(n, 1))
    parts = []
    for i in range(0, N, g):
        sg, dg = s[i:i + g], d_row[i:i + g]
        mined = codec.mine_group(sg, dg, max_d=0xFFFF) if mine else None
        if emit_all:
            parts.append(_emit(sg, codec._eq_for(sg, dg, dists,
                                                 last_lit=False), dg, mined))
            continue
        dm, eq_m = mined
        sl = torch.zeros((sg.shape[0], slot_width(n)), dtype=U8, device=dev)
        cs = torch.full((sg.shape[0],), n, dtype=I32, device=dev)
        es = torch.zeros(sg.shape[0], dtype=I32, device=dev)
        r = torch.nonzero(dm > 0).flatten()
        if r.numel():
            sl[r], cs[r], es[r] = _emit(
                sg[r], codec._eq_for(sg[r], dg[r], dists, last_lit=False),
                dg[r], (dm[r], eq_m[r]))
        parts.append((sl, cs, es))
    if len(parts) == 1:
        return parts[0]
    return tuple(torch.cat([p[k] for p in parts]) for k in range(3))


def _rfill_min(x: torch.Tensor) -> torch.Tensor:
    """Reverse cumulative minimum along dim 1."""
    return torch.flip(torch.cummin(torch.flip(x, [1]), dim=1).values, [1])


def _segment(eq: torch.Tensor, min_len: int, idx: torch.Tensor, n: int):
    """LZ4-rule run segmentation: one sequence per maximal run (the
    255-extension length is unbounded). Runs shorter than min_len demote
    to literals; no match may START in the last 12 bytes (MFLIMIT).
    Returns (is_match, roff = offset in the run, runlen)."""
    noneq = torch.where(eq, -1, idx)
    run_start = torch.cummax(noneq, dim=1).values + 1
    next_noneq = _rfill_min(torch.where(eq, n, idx))
    runlen = next_noneq - run_start
    is_match = eq & (runlen >= min_len) & (run_start < n - 12)
    return is_match, idx - run_start, runlen


def _emit(s: torch.Tensor, eq: torch.Tensor, d_row: torch.Tensor,
          mined=None):
    """LZ4 scan + sort emission (codec_lz4._emit).

    With mined = (d_m, eq_m) from codec.mine_group, runs of at least
    codec._MINRUN_MINED at the mined distance claim their positions
    first and the static class segments the rest. A match run then may
    abut another (a mined run next to a static one, no literal between):
    the stretch token before them belongs to the earlier run, so the
    later one carries its own zero-literal token and its train is
    [token][off_lo][off_hi][ext...]. Without mining runs are maximal and
    never abut: every train is [off_lo][off_hi][ext...]."""
    N, n = s.shape
    W = slot_width(n)
    dev = s.device
    idx = torch.arange(n, dtype=I32, device=dev)[None, :]

    eq = eq & (idx < n - 5)                # last 5 bytes stay literal
    if mined is not None:
        d_m, eq_m = mined
        m2, ro2, sl2 = _segment(eq_m & (idx < n - 5), codec._MINRUN_MINED,
                                idx, n)
        m1, ro1, sl1 = _segment(eq & ~m2, 4, idx, n)
        is_match = m1 | m2
        suboff = torch.where(m2, ro2, ro1)
        sub_len = torch.where(m2, sl2, sl1)
        d_pos = torch.where(m2, d_m.to(I32)[:, None], d_row.to(I32))
        # a run that starts right after another match position abuts it
        prev_m = torch.zeros_like(is_match)
        prev_m[:, 1:] = is_match[:, :-1]
        seedv = torch.where((suboff == 0) & is_match,
                            (idx << 1) | prev_m.to(I32), -1)
        later = is_match & (
            (torch.cummax(seedv, dim=1).values & 1) == 1)
    else:
        is_match, suboff, sub_len = _segment(eq, 4, idx, n)
        d_pos = d_row.to(I32)
        later = None
    sub_start = is_match & (suboff == 0)
    ml = sub_len - 4                       # token match nibble basis
    km = torch.where(ml >= 15, (ml - 15) // 255 + 1, 0)

    # -- literal stretches ---------------------------------------------------
    lit = ~is_match
    lit_start = torch.cummax(torch.where(lit, -1, idx), dim=1).values + 1
    lit_off = idx - lit_start
    L = _rfill_min(torch.where(lit, n, idx)) - lit_start
    kl = torch.where(L >= 15, (L - 15) // 255 + 1, 0)
    is_start = lit & (lit_off == 0)

    # the stretch's token needs the FOLLOWING match's ml nibble: reverse-
    # fill min(ml, 15) from run starts back to literal positions
    firstml = torch.clamp(sub_len - 4, max=15)
    seed = torch.where(sub_start, ((n - idx) << 5) | (firstml + 1), 0)
    rfill = torch.flip(torch.cummax(torch.flip(seed, [1]), dim=1).values, [1])
    next_ml = (rfill & 0x1F) - 1           # -1: no following match

    # -- per-position output contributions ----------------------------------
    in_lext = lit & (lit_off >= 1) & (lit_off <= kl)
    train_len = 2 + km if later is None else torch.where(later, 3, 2) + km
    c = (torch.where(lit, 1 + is_start.to(I32) + in_lext.to(I32), 0)
         + torch.where(sub_start, train_len, 0)).to(I32)
    cum = torch.cumsum(c, dim=1, dtype=I32)
    off = cum - c
    csize = cum[:, -1]

    nseq = (sub_start.to(I32) + is_start.to(I32)).sum(dim=1, dtype=I32)
    ext_steps = (torch.where(sub_start, km // 8, 0)
                 + torch.where(is_start, kl // 8, 0)).sum(dim=1, dtype=I32)
    est_iters = nseq + ext_steps + 8

    # -- emission: one full lane + a 4:1-compacted side lane (see the JAX
    #    source): lane 0 holds literal data and match-train bytes, lane 1
    #    the stretch token and the literal-length extension bytes spread at
    #    stride 4, which compacts 4:1 without collisions
    off_s = torch.where(
        is_start, off,
        off - (lit_off + 1 + torch.minimum(torch.clamp(lit_off - 1, min=0),
                                           kl)))
    tok_lit = (torch.clamp(L, max=15) << 4) | torch.where(
        next_ml >= 0, torch.clamp(next_ml, 0, 15), 0)
    data_dst = off_s + 1 + kl + lit_off
    # byte j of a train: [token]? off_lo off_hi ext...
    jj = suboff if later is None else suboff - later.to(I32)
    ext = torch.clamp(ml - 15 - 255 * (jj - 2), 0, 255)
    seq_byte = torch.where(jj == 0, d_pos & 255,
                           torch.where(jj == 1, d_pos >> 8, ext))
    if later is not None:
        seq_byte = torch.where(later & (suboff == 0),
                               torch.clamp(ml, max=15), seq_byte)
    tbase = torch.where(sub_start, off, off - train_len)

    val0 = torch.where(lit, s.to(I32), seq_byte)
    pos0 = torch.where(lit, data_dst, tbase + suboff)
    valid0 = lit | (is_match & (suboff < train_len))
    key0 = torch.where(valid0, (pos0 << 8) | (val0 & 0xFF), _BIG)

    u = lit_off >> 2
    in_lext4 = lit & (lit_off % 4 == 0) & (u >= 1) & (u <= kl)
    lext_val = torch.clamp(L - 15 - 255 * (u - 1), 0, 255)
    val1 = torch.where(is_start, tok_lit, lext_val)
    pos1 = torch.where(is_start, off_s, off_s + u)
    key1 = torch.where(is_start | in_lext4, (pos1 << 8) | (val1 & 0xFF), _BIG)
    side = key1.reshape(N, n // 4, 4).amin(dim=2) if n % 4 == 0 else key1

    keys = torch.sort(torch.cat([key0, side], dim=1).to(I32), dim=1).values
    if keys.shape[1] < W:
        keys = torch.nn.functional.pad(keys, (0, W - keys.shape[1]),
                                       value=_BIG)
    slots = (keys[:, :W] & 0xFF).to(U8)
    slots = torch.where(torch.arange(W, device=dev)[None, :] < csize[:, None],
                        slots, 0)
    return slots, csize, est_iters


# ---------------------------------------------------------------------------
# Structured decode: the LZ4 sequence walk (kernel K4) + shared placement
# ---------------------------------------------------------------------------

def max_records(out_len: int) -> int:
    """Default walk budget (the JAX walk's, whose slots also pay for
    parse stalls and for steps that yield no record; the port's compacted
    records need fewer). Token-dense streams overflow; the byte API
    retries with structured.high_records before any host fallback."""
    return out_len // 16 + out_len // 64 + 32


# stream positions one CTA of K4 resolves (kB in csrc/lz4_walk.cu)
K4_BLOCK = 4160
# K4 saturates its op sums at 2^21 - 1, so out_len stays below it; its
# records hold stream positions and lengths in 32 bits, so rows stay
# narrower than 2^23 bytes (255 * W fits)
_K4_MAX_OUT = (1 << 21) - 2
_K4_MAX_W = (1 << 23) - 1
_EPOCHS = 1 << 13
# K4's look-back scratch, per (device, stream): [buffer, last epoch]
_lookback: dict = {}


def walk(slots: torch.Tensor, csizes: torch.Tensor, out_len: int,
         maxrec: int):
    """Parse a batch of LZ4 blocks into compacted records: (kind 0,
    stream offset, dst, len) per literal run, (kind 1, offset, dst, len)
    per match. Outputs as structured.walk's; dist is the first completed
    match's offset. Launches K4 on a CUDA tensor."""
    E = structured.record_slots(maxrec)
    if not slots.is_cuda:
        return _walk_plain(slots, csizes, out_len, E)
    if out_len > _K4_MAX_OUT or slots.shape[1] > _K4_MAX_W:
        raise ValueError(f"K4 takes out_len <= {_K4_MAX_OUT} and rows of "
                         f"at most {_K4_MAX_W} bytes")
    return structured.launch_walk("lz4_walk", slots, csizes, out_len, E,
                                  _lookback_args(slots))


def _lookback_args(slots: torch.Tensor) -> tuple:
    """K4's look-back scratch for one launch: (pointer, bytes, epoch).
    A row wider than K4_BLOCK passes each block's entry on through 16
    bytes a block that carry the launch's epoch, so the buffer, kept per
    device and stream (launches on one stream run in order), is zeroed
    only when it grows or the epochs (1 .. 8191) wrap. The epoch is set
    here, on the host, so a launch captured in a CUDA graph would find
    its previous replay's entries: K4 is not graph-safe as it stands."""
    N, W = slots.shape
    nblk = -(-W // K4_BLOCK)
    if nblk <= 1:
        return (None, 0, 0)
    need = 16 * N * nblk
    key = (slots.device, torch.cuda.current_stream(slots.device).cuda_stream)
    ent = _lookback.get(key)
    if ent is None or ent[0].numel() < need or ent[1] + 1 >= _EPOCHS:
        ent = _lookback[key] = [torch.zeros(need, dtype=U8,
                                            device=slots.device), 0]
    ent[1] += 1
    return (ent[0].data_ptr(), ent[0].numel(), ent[1])


def _walk_plain(slots: torch.Tensor, csizes: torch.Tensor, out_len: int,
                E: int):
    """K4's function in plain PyTorch: every live row takes one step of
    the JAX walk's four-phase state machine per iteration (see
    csrc/lz4_walk.cu), records compacted; a row errs when a valid record
    would be the (E+1)-th."""
    N = slots.shape[0]
    dev = slots.device
    cs = csizes.to(I64)
    kind, arg, dst, ln = structured.empty_records(N, E, dev)
    z = torch.zeros(N, dtype=I64, device=dev)
    ip, op, phase, mlsave, offsave, extacc, dist, cnt = (
        z.clone() for _ in range(8))
    uni = torch.ones(N, dtype=torch.bool, device=dev)
    err, fin = cs <= 0, cs <= 0
    byte = structured.byte_reader(slots, cs)
    j8 = torch.arange(8, device=dev)[None, :]
    while True:
        r = torch.nonzero(~(err | fin)).flatten()
        if r.numel() == 0:
            break
        ipr, opr, ph, cr, ea = ip[r], op[r], phase[r], cs[r], extacc[r]
        is0, is1, is2, is3 = ph == 0, ph == 1, ph == 2, ph == 3
        tok = byte(r, ipr)
        # one 255-run count per step, at the phase's extension position
        ebase = ipr + torch.where(is0, 1, torch.where(is2, 2, 0))
        w8 = byte(r, ebase[:, None] + j8)
        k255 = torch.cumprod((w8 == 255).to(I64), dim=1).sum(dim=1)
        lastb = w8.gather(1, torch.clamp(k255, max=7)[:, None])[:, 0]
        # ---- literal side (phases 0/1) ------------------------------------
        need_lext = (is0 & ((tok >> 4) == 15)) | is1
        lext_more = need_lext & (k255 >= 8)
        litlen = torch.where(
            need_lext, torch.where(is0, 15, ea) + 255 * k255 + lastb, tok >> 4)
        do_lit = (is0 | is1) & ~lext_more
        ipl = ipr + is0.to(I64) + torch.where(need_lext & ~lext_more,
                                              k255 + 1, 0)
        ip2 = ipl + litlen
        op2 = opr + litlen
        lit_err = do_lit & ((ip2 > cr) | (op2 > out_len))
        lit_fin = do_lit & ~lit_err & (ip2 >= cr)     # final literals
        # ---- match side (phases 2/3) --------------------------------------
        offv = torch.where(is2, tok | (byte(r, ipr + 1) << 8), offsave[r])
        ms = mlsave[r]
        need_mext = (is2 & (ms == 15)) | is3
        mext_more = need_mext & (k255 >= 8)
        mlen = 4 + torch.where(
            need_mext, torch.where(is2, 15, ea) + 255 * k255 + lastb, ms)
        m_done = (is2 | is3) & ~mext_more
        ip3 = (ipr + torch.where(is2, 2, 0)
               + torch.where(need_mext & ~mext_more, k255 + 1, 0))
        m_err = m_done & ((offv == 0) | (offv > opr) | (opr + mlen > out_len)
                          | (ip3 > cr))
        # ---- merge, budget, state advance ---------------------------------
        ext_err = (lext_more | mext_more) & (ipr + 8 >= cr)
        is_l = is0 | is1
        err_t = torch.where(is_l, lit_err, m_err) | ext_err
        valid = ~err_t & ((do_lit & (litlen > 0)) | m_done)
        c = cnt[r]
        err_t |= valid & (c >= E)
        valid &= ~err_t
        rv, cv = r[valid], c[valid]
        kind[rv, cv] = torch.where(is_l, 0, 1)[valid].to(I32)
        arg[rv, cv] = torch.where(is_l, ipl, offv)[valid].to(I32)
        dst[rv, cv] = opr[valid].to(I32)
        ln[rv, cv] = torch.where(is_l, litlen, mlen)[valid].to(I32)
        cnt[r] = c + valid.to(I64)

        g = ~err_t
        rg = r[g]
        ip[rg] = torch.where(
            lext_more, ipr + torch.where(is0, 9, 8),
            torch.where(mext_more, ipr + torch.where(is2, 10, 8),
                        torch.where(do_lit, ip2, ip3)))[g]
        op[rg] = torch.where(do_lit, op2,
                             torch.where(m_done, opr + mlen, opr))[g]
        phase[rg] = torch.where(
            lext_more, 1, torch.where(mext_more, 3, torch.where(
                do_lit & ~lit_fin, 2, 0)))[g]
        mlsave[rg] = torch.where(is0, tok & 15, ms)[g]
        offsave[rg] = offv[g]
        extacc[rg] = torch.where(
            lext_more, torch.where(is0, 15, ea) + 255 * 8,
            torch.where(mext_more, torch.where(is2, 15, ea) + 255 * 8, 0))[g]
        dm = m_done & g
        dr = dist[r]
        d2 = torch.where(dr == 0, offv, dr)
        dist[r] = torch.where(dm, d2, dr)
        uni[r] = uni[r] & ~(dm & (offv != d2))
        err[r] = err_t
        fin[r] = g & lit_fin
    ok = ~err & (op == out_len)
    return (kind, arg, dst, ln), dist.to(I32), uni, ok


# ---------------------------------------------------------------------------
# K4's split in plain PyTorch (tests only): the sequence every position
# would start, the in-block exit tables, the entries across blocks, the
# emission of the records; chained, they compute _walk_plain's function
# ---------------------------------------------------------------------------

_CONT, _LIT_ERR, _FIN, _MATCH_ERR = 0, 1, 2, 3     # kinds of a sequence
_GO, _ERR, _DONE = 0, 1, 2                         # outcomes of a step


def _seq_table(slots: torch.Tensor, csizes: torch.Tensor) -> dict:
    """Pass 1's successor table: the sequence a token at each position p
    would start, from p alone (csrc/lz4_walk.cu, eval). Int64 (N, W)
    tensors kind (_CONT, _LIT_ERR, _FIN or _MATCH_ERR: whether the
    sequence goes on, or its position-only error or end), litlen, ipl,
    offv, mlen (0 unless _CONT or _MATCH_ERR) and nxt (the next token;
    ip2 for _LIT_ERR and _FIN). The 255-run at every position is one
    reverse cumulative minimum, not a loop per position."""
    N, W = slots.shape
    dev = slots.device
    cs = csizes.to(I64)[:, None]
    lim = torch.clamp(cs, 0, W)
    p = torch.arange(W, device=dev)[None, :].expand(N, W)
    b = torch.where(p < lim, slots.to(I64), 0)
    nz = _rfill_min(torch.where(b != 255, p, W))    # first non-255 at or after

    def at(t, x):
        return torch.where(x < lim, t.gather(1, torch.clamp(x, 0, W - 1)), 0)

    def run(x):
        return torch.where(x < lim, at(nz, x) - x, 0)

    tok = b
    L, ML = tok >> 4, tok & 15
    R = torch.where(L == 15, run(p + 1), 0)
    litlen = torch.where(L == 15, 15 + 255 * R + at(b, p + 1 + R), L)
    ipl = torch.where(L == 15, p + 2 + R, p + 1)
    m = R >> 3
    xerr = (m >= 1) & (torch.where(m == 1, p + 8, p + 8 * m + 1) >= cs)
    ip2 = ipl + litlen
    lit_err = xerr | (ip2 > cs)
    fin = ~lit_err & (ip2 >= cs)
    offv = at(b, ip2) | (at(b, ip2 + 1) << 8)
    R2 = torch.where(ML == 15, run(ip2 + 2), 0)
    mlen = torch.where(ML == 15, 19 + 255 * R2 + at(b, ip2 + 2 + R2), 4 + ML)
    ip3 = torch.where(ML == 15, ip2 + 3 + R2, ip2 + 2)
    m2 = R2 >> 3
    merr = (m2 >= 1) & (torch.where(m2 == 1, ip2 + 8, ip2 + 8 * m2 + 2) >= cs)
    stop = lit_err | fin
    kind = torch.where(lit_err, _LIT_ERR, torch.where(fin, _FIN, torch.where(
        merr | (offv == 0) | (ip3 > cs), _MATCH_ERR, _CONT)))
    return dict(kind=kind, litlen=litlen, ipl=ipl,
                offv=torch.where(stop, 0, offv),
                mlen=torch.where(stop, 0, mlen),
                nxt=torch.where(stop, ip2, ip3))


def _seq_at(tab: dict, rows: torch.Tensor, x: torch.Tensor,
            cs: torch.Tensor) -> dict:
    """The table's sequence at positions x of the given rows; a position
    at or past min(csize, W) reads a zero token: no record, _FIN when
    x + 1 == csize, an error otherwise."""
    W = tab["kind"].shape[1]
    c = cs[rows]
    inside = x < torch.clamp(c, 0, W)
    xc = torch.clamp(x, 0, W - 1)
    out = {k: torch.where(inside, t[rows, xc], 0) for k, t in tab.items()}
    vkind = torch.where(x + 1 > c, _LIT_ERR,
                        torch.where(x + 1 == c, _FIN, _MATCH_ERR))
    out["kind"] = torch.where(inside, out["kind"], vkind)
    out["ipl"] = torch.where(inside, out["ipl"], x + 1)
    out["nxt"] = torch.where(inside, out["nxt"], x + 1)
    return out


def _exit_tables(tab: dict, csizes: torch.Tensor, B: int) -> dict:
    """Pass 1's in-block exit tables for blocks of B positions, by pointer
    jumping: for every position, P (the node where its chain leaves its
    block, at a node whose next token lies at or past min(block end,
    csize, W), or ends, at a node whose sequence errs or ends by itself),
    and over the nodes before P: nrec (records), opsum (output bytes),
    moff (the largest offset minus the output before its match, relative
    to the output before the position) and uni (every offset equals the
    position's own). Int64 / bool (N, W)."""
    kind, nxt = tab["kind"], tab["nxt"]
    N, W = kind.shape
    dev = kind.device
    lim = torch.clamp(csizes.to(I64), 0, W)[:, None]
    idx = torch.arange(W, device=dev)[None, :].expand(N, W)
    bend = torch.minimum((idx // B + 1) * B, lim)
    final = (kind != _CONT) | (nxt >= bend) | (idx >= lim)
    P = torch.where(final, idx, nxt)
    litlen, offv = tab["litlen"], tab["offv"]
    nrec = torch.where(final, 0, (litlen > 0).to(I64) + 1)
    opsum = torch.where(final, 0, litlen + tab["mlen"])
    moff = torch.where(final, 0, torch.clamp(offv - litlen, min=0))
    uni = torch.ones((N, W), dtype=torch.bool, device=dev)
    while True:
        PP = P.gather(1, P)
        act = (P != idx) & (PP != P)
        if not bool(act.any()):
            break
        nrec, opsum, moff, uni = (
            torch.where(act, nrec + nrec.gather(1, P), nrec),
            torch.where(act, opsum + opsum.gather(1, P), opsum),
            torch.where(act, torch.maximum(moff, moff.gather(1, P) - opsum),
                        moff),
            torch.where(act, uni & uni.gather(1, P)
                        & (offv.gather(1, P) == offv), uni))
        P = torch.where(act, PP, P)
    return dict(P=P, nrec=nrec, opsum=opsum, moff=moff, uni=uni)


def _block_entries(tab: dict, ex: dict, csizes: torch.Tensor, out_len: int,
                   E: int, B: int):
    """Pass 2: each row's chain from block to block through the exit
    tables, one table read a block. Returns (ent, entered, term): ent a
    dict of int64 (N, nblk) tensors e, cnt, op, dist and bool uni (the
    entry position of each entered block, the records, output, first
    match offset and uni before it), entered (N, nblk) bool, term (N,)
    the block where the row ends (-1 for a row of csize <= 0)."""
    N, W = tab["kind"].shape
    dev = tab["kind"].device
    cs = csizes.to(I64)
    lim = torch.clamp(cs, 0, W)
    nblk = max(1, -(-W // B))
    z = torch.zeros((N, nblk), dtype=I64, device=dev)
    ent = dict(e=z.clone(), cnt=z.clone(), op=z.clone(), dist=z.clone(),
               uni=torch.ones((N, nblk), dtype=torch.bool, device=dev))
    entered = torch.zeros((N, nblk), dtype=torch.bool, device=dev)
    term = torch.full((N,), -1, dtype=I64, device=dev)
    zr = torch.zeros(N, dtype=I64, device=dev)
    e, cnt, op, dist = zr.clone(), zr.clone(), zr.clone(), zr.clone()
    uni = torch.ones(N, dtype=torch.bool, device=dev)
    alive = cs > 0
    while bool(alive.any()):
        r = torch.nonzero(alive).flatten()
        er, c0, o0, d0, u0 = e[r], cnt[r], op[r], dist[r], uni[r]
        j = er // B
        for k, v in (("e", er), ("cnt", c0), ("op", o0), ("dist", d0),
                     ("uni", u0)):
            ent[k][r, j] = v
        entered[r, j] = True
        node = er < torch.minimum((j + 1) * B, lim[r])
        ec = torch.clamp(er, 0, W - 1)
        a = {k: torch.where(node, t[r, ec], 0) for k, t in ex.items()
             if k != "uni"}
        au = torch.where(node, ex["uni"][r, ec], True)
        f = torch.where(node, a["P"], er)
        q = _seq_at(tab, r, f, cs)
        opf, cntf = o0 + a["opsum"], c0 + a["nrec"]
        nl = (q["litlen"] > 0).to(I64)
        o2 = opf + q["litlen"]
        x = q["nxt"]
        ends = ((a["moff"] > o0) | (opf > out_len) | (cntf > E)
                | (q["kind"] != _CONT) | (o2 > out_len)
                | ((nl > 0) & (cntf >= E)) | (q["offv"] > o2)
                | (o2 + q["mlen"] > out_len) | (cntf + nl >= E)
                | (x >= lim[r]))
        oe = torch.where(node, tab["offv"][r, ec], 0)
        term[r[ends]] = j[ends]
        alive[r[ends]] = False
        g = ~ends
        rg = r[g]
        e[rg] = x[g]
        cnt[rg] = (cntf + nl + 1)[g]
        op[rg] = (o2 + q["mlen"])[g]
        dist[rg] = torch.where(d0 != 0, d0, oe)[g]
        uni[rg] = (u0 & au & ((f == er) | (q["offv"] == oe))
                   & ((d0 == 0) | (oe == d0)))[g]
    return ent, entered, term


def _emit_records(tab: dict, ent: dict, entered: torch.Tensor,
                  term: torch.Tensor, csizes: torch.Tensor, out_len: int,
                  E: int, B: int):
    """Pass 3: every entered block walks its chain from its entry, one
    sequence a step, with the op checks and the budget, and writes its
    records; the block where the row ends gives the records' end, dist,
    uni and ok. Returns _walk_plain's outputs."""
    N, W = tab["kind"].shape
    dev = tab["kind"].device
    cs = csizes.to(I64)
    lim = torch.clamp(cs, 0, W)
    kind, arg, dst, ln = structured.empty_records(N, E, dev)
    rows, blks = torch.nonzero(entered, as_tuple=True)
    p, c, o, d = (ent[k][rows, blks].clone() for k in ("e", "cnt", "op",
                                                         "dist"))
    u = ent["uni"][rows, blks].clone()
    bend = torch.minimum((blks + 1) * B, lim[rows])
    res = torch.zeros_like(p)
    live = torch.ones_like(u)
    while bool(live.any()):
        i = torch.nonzero(live).flatten()
        ri, pi, ci, oi = rows[i], p[i], c[i], o[i]
        q = _seq_at(tab, ri, pi, cs)
        k, L = q["kind"], q["litlen"]
        err1 = (k == _LIT_ERR) | (oi + L > out_len) | ((L > 0) & (ci >= E))
        wl = ~err1 & (L > 0)
        kind[ri[wl], ci[wl]] = 0
        arg[ri[wl], ci[wl]] = q["ipl"][wl].to(I32)
        dst[ri[wl], ci[wl]] = oi[wl].to(I32)
        ln[ri[wl], ci[wl]] = L[wl].to(I32)
        c2, o2 = ci + wl.to(I64), oi + torch.where(err1, 0, L)
        done = ~err1 & (k == _FIN)
        err2 = ~err1 & ~done & ((k == _MATCH_ERR) | (q["offv"] > o2)
                                | (o2 + q["mlen"] > out_len) | (c2 >= E))
        wm = ~err1 & ~done & ~err2
        kind[ri[wm], c2[wm]] = 1
        arg[ri[wm], c2[wm]] = q["offv"][wm].to(I32)
        dst[ri[wm], c2[wm]] = o2[wm].to(I32)
        ln[ri[wm], c2[wm]] = q["mlen"][wm].to(I32)
        di = torch.where(wm & (d[i] == 0), q["offv"], d[i])
        u[i] = u[i] & ~(wm & (q["offv"] != di))
        d[i] = di
        c[i] = c2 + wm.to(I64)
        o[i] = o2 + torch.where(wm, q["mlen"], 0)
        pn = torch.where(wm, q["nxt"], pi)
        p[i] = pn
        r = torch.where(err1 | err2, _ERR, torch.where(done, _DONE, _GO))
        res[i] = r
        # a block's walk stops at an error or the end, or where its chain
        # leaves the block for a position of the row; a position past the
        # row's bytes is one more (zero) token
        live[i] = (r == _GO) & ~((pn >= bend[i]) & (pn < lim[ri]))
    last = blks == term[rows]
    dist = torch.zeros(N, dtype=I32, device=dev)
    uni = torch.ones(N, dtype=torch.bool, device=dev)
    ok = torch.zeros(N, dtype=torch.bool, device=dev)
    rl = rows[last]
    dist[rl] = d[last].to(I32)
    uni[rl] = u[last]
    ok[rl] = (res[last] == _DONE) & (o[last] == out_len)
    return (kind, arg, dst, ln), dist, uni, ok


def _walk_split(slots: torch.Tensor, csizes: torch.Tensor, out_len: int,
                E: int, B: int = K4_BLOCK):
    """K4's three passes chained in plain PyTorch, blocks of B positions:
    _walk_plain's outputs."""
    tab = _seq_table(slots, csizes)
    ex = _exit_tables(tab, csizes, B)
    ent, entered, term = _block_entries(tab, ex, csizes, out_len, E, B)
    return _emit_records(tab, ent, entered, term, csizes, out_len, E, B)


def decode(slots: torch.Tensor, csizes: torch.Tensor, out_len: int,
           maxrec_hint: int = 0):
    """Decode batched LZ4 blocks via the structured machine.

    Returns (out, produced, err) as cblosc_tpu.tpu.codec_lz4.decode does;
    see structured.decode_walked."""
    return structured.decode_walked(walk, max_records, slots, csizes, out_len,
                                    maxrec_hint)
