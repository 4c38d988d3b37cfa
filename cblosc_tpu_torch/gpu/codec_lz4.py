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
    LASTLITERALS), and a maximal run is one sequence.
  * The decoder walks sequences into compacted records — the
    hand-written kernel K4 (csrc/lz4_walk.cu) on a CUDA tensor,
    :func:`_walk_plain` on a CPU tensor — and places them with the
    shared machinery (gpu/structured.decode_core: pure tiles, expand).
    Rows the walk rejects report err; the byte API then retries with a
    wider budget and, failing that, decodes the chunk on the host, as
    the JAX package does.

Mining per-row adaptive distances (clevel >= 5) is not ported:
``encode(..., mine=True)`` raises NotImplementedError.
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
    cblosc_tpu.tpu.codec_lz4.encode's on every row. Rows whose estimated
    ratio falls below min_cratio_x100/100 report csize n, est 0 and zero
    slots without being emitted (JAX runs its groups of such rows through
    the same raw branch). Rows too wide for the int32 keys (see
    :func:`fits`) raise ValueError."""
    if mine:
        raise NotImplementedError(
            "adaptive-distance mining (clevel >= 5) is not ported yet")
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
        return _emit_grouped(s, d_row, dists)
    cov = stack.max(dim=0).values
    est_csize = n - cov + cov // 170 + n // 33 + 16
    hopeless = 100 * n < min_cratio_x100 * est_csize
    slots = torch.zeros((N, slot_width(n)), dtype=U8, device=dev)
    csize = torch.full((N,), n, dtype=I32, device=dev)
    est = torch.zeros(N, dtype=I32, device=dev)
    rows = torch.nonzero(~hopeless).flatten()
    if rows.numel():
        slots[rows], csize[rows], est[rows] = _emit_grouped(
            s[rows], d_row[rows], dists)
    return slots, csize, est


def _emit_grouped(s: torch.Tensor, d_row: torch.Tensor, dists: tuple):
    """_emit over row groups (rows are independent; groups bound the
    int32 workspace to ~32 MB per intermediate)."""
    N, n = s.shape
    g = max(1, (8 << 20) // max(n, 1))
    parts = [_emit(s[i:i + g],
                   codec._eq_for(s[i:i + g], d_row[i:i + g], dists,
                                 last_lit=False),
                   d_row[i:i + g]) for i in range(0, N, g)]
    if len(parts) == 1:
        return parts[0]
    return tuple(torch.cat([p[k] for p in parts]) for k in range(3))


def _rfill_min(x: torch.Tensor) -> torch.Tensor:
    """Reverse cumulative minimum along dim 1."""
    return torch.flip(torch.cummin(torch.flip(x, [1]), dim=1).values, [1])


def _segment(eq: torch.Tensor, idx: torch.Tensor, n: int):
    """LZ4-rule run segmentation: one sequence per maximal run (the
    255-extension length is unbounded). Runs shorter than 4 demote to
    literals; no match may START in the last 12 bytes (MFLIMIT).
    Returns (is_match, roff = offset in the run, runlen)."""
    noneq = torch.where(eq, -1, idx)
    run_start = torch.cummax(noneq, dim=1).values + 1
    next_noneq = _rfill_min(torch.where(eq, n, idx))
    runlen = next_noneq - run_start
    is_match = eq & (runlen >= 4) & (run_start < n - 12)
    return is_match, idx - run_start, runlen


def _emit(s: torch.Tensor, eq: torch.Tensor, d_row: torch.Tensor):
    """LZ4 scan + sort emission (codec_lz4._emit without mining).

    Without mining a match run never abuts another (runs are maximal and
    the position after one is not equal), so no sub-match carries its
    own zero-literal token: the JAX emission's `later` is all False and
    every match train is [off_lo][off_hi][ext...]."""
    N, n = s.shape
    W = slot_width(n)
    dev = s.device
    idx = torch.arange(n, dtype=I32, device=dev)[None, :]

    eq = eq & (idx < n - 5)                # last 5 bytes stay literal
    is_match, suboff, sub_len = _segment(eq, idx, n)
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
    train_len = 2 + km
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
    d_pos = d_row.to(I32)
    ext = torch.clamp(ml - 15 - 255 * (suboff - 2), 0, 255)
    seq_byte = torch.where(suboff == 0, d_pos & 255,
                           torch.where(suboff == 1, d_pos >> 8, ext))
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


def walk(slots: torch.Tensor, csizes: torch.Tensor, out_len: int,
         maxrec: int):
    """Parse a batch of LZ4 blocks into compacted records: (kind 0,
    stream offset, dst, len) per literal run, (kind 1, offset, dst, len)
    per match. Outputs as structured.walk's; dist is the first completed
    match's offset. Launches K4 on a CUDA tensor."""
    E = structured.record_slots(maxrec)
    if not slots.is_cuda:
        return _walk_plain(slots, csizes, out_len, E)
    return structured.launch_walk("lz4_walk", slots, csizes, out_len, E)


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


def decode(slots: torch.Tensor, csizes: torch.Tensor, out_len: int,
           maxrec_hint: int = 0):
    """Decode batched LZ4 blocks via the structured machine.

    Returns (out, produced, err) as cblosc_tpu.tpu.codec_lz4.decode does;
    see structured.decode_walked."""
    return structured.decode_walked(walk, max_records, slots, csizes, out_len,
                                    maxrec_hint)
