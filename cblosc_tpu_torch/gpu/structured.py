"""Structured device decoder: templates, record walk, tile and expand.

PyTorch counterpart of cblosc_tpu/tpu/structured.py, kernel leg only:

  1. TEMPLATE: rows whose stream matches the closed-form layout of the
     encoder's PURE emission are recognized with elementwise compares
     and tiled from their d-byte pattern, without any parse;
  2. WALK: the remaining live rows are parsed into compacted records
     (kind, arg, dst, len) plus per-row uniform-distance and ok flags —
     the hand-written walk kernel (csrc/walk.cu, one warp per row) on
     a CUDA tensor, :func:`_walk_plain` on a CPU tensor;
  3. PLACE: walked rows of the pure-tile shape (a literal prefix of d
     bytes, one match at pow2 distance d <= 256, a 1-byte tail) are
     tiled; the others go through the expand kernel (gpu/expand.py);
  4. FALLBACK: rows the walk rejects decode through the generic decoder
     (gpu/codec.decode), the outputs merged by row.

(out, produced, err) equal cblosc_tpu.tpu.structured.decode's on every
row. The JAX package's XLA sort machine (_place_and_fill/_splat_place)
and its window tiering are TPU idioms and are not ported.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from . import codec, kernels
from . import expand as expand_mod

I64 = torch.int64
I32 = torch.int32
U8 = torch.uint8


def max_records(out_len: int) -> int:
    """Default walk record budget (the JAX walk's, whose slots also pay
    for parse stalls; the port's compacted records need fewer)."""
    return out_len // 32 + out_len // 64 + 24


def high_records(out_len: int) -> int:
    """Record budget sufficient for any conforming stream: every record
    consumes >= 2 compressed bytes and a split's stream is < out_len."""
    return (out_len * 9) // 16 + 64


def record_slots(maxrec: int) -> int:
    """Record columns the walk writes for a budget: maxrec rounded up to
    32, the slot count of the JAX walk's chunked loop, so every row the
    JAX walk accepts fits here too."""
    return -(-maxrec // 32) * 32


def decode_cap() -> int:
    """Largest out_len the structured decode handles (expand.MAX_OUT)."""
    return expand_mod.MAX_OUT


# ---------------------------------------------------------------------------
# WALK (kernel K2)
# ---------------------------------------------------------------------------

def walk(slots: torch.Tensor, csizes: torch.Tensor, out_len: int,
         maxrec: int):
    """Parse a batch of blosclz streams into compacted records.

    slots: uint8 (N, W), zero past each csize; csizes int32 (N,).
    Returns (rf, dist, uni, ok): rf is the field tuple of four int32
    (N, record_slots(maxrec)) tensors (kind, arg, dst, len), valid
    records first and kind == -1 after; dist int32 (N,) is the first
    match distance, uni bool (N,) says all matches share it, ok bool
    (N,) says the row parsed completely to out_len within the budget."""
    E = record_slots(maxrec)
    if not slots.is_cuda:
        return _walk_plain(slots, csizes, out_len, E)
    return launch_walk("walk", slots, csizes, out_len, E)


def launch_walk(name: str, slots: torch.Tensor, csizes: torch.Tensor,
                out_len: int, E: int, extra: tuple = ()):
    """Launch the walk kernel `name` (walk, lz4_walk, snappy_walk: one C
    signature, the kernel's own arguments `extra` added before the
    stream) on CUDA tensors; returns walk()'s outputs with E record
    columns."""
    kernels.require(slots, "slots", U8, 2)
    kernels.require(csizes, "csizes", I32, 1)
    N, W = slots.shape
    if csizes.shape[0] != N or csizes.device != slots.device:
        raise ValueError("csizes must be (N,) on the slots' device")
    dev = slots.device
    # the kernel writes every column, the kind -1 / zero tail included
    kind, arg, dst, ln = torch.empty((4, N, E), dtype=I32, device=dev).unbind(0)
    dist = torch.empty(N, dtype=I32, device=dev)
    uni, ok = torch.empty((2, N), dtype=torch.bool, device=dev).unbind(0)
    code = kernels.fn(name)(
        slots.data_ptr(), N, W, csizes.data_ptr(), out_len, E,
        kind.data_ptr(), arg.data_ptr(), dst.data_ptr(), ln.data_ptr(),
        dist.data_ptr(), uni.data_ptr(), ok.data_ptr(), *extra,
        kernels.stream_ptr(slots))
    kernels.check(name, code)
    return (kind, arg, dst, ln), dist, uni, ok


def byte_reader(slots: torch.Tensor, cs: torch.Tensor):
    """byte(rows, x): the bytes at positions x (any shape, leading dim
    rows) of the given rows, 0 at or past the row's csize or width (the
    walks' masked window reads)."""
    W = slots.shape[1]

    def byte(rows, x):
        r = rows.view(-1, *([1] * (x.dim() - 1)))
        c = cs[rows].view(-1, *([1] * (x.dim() - 1)))
        v = slots[r, torch.clamp(x, 0, W - 1)].to(I64)
        return torch.where((x >= 0) & (x < c) & (x < W), v, 0)

    return byte


def empty_records(N: int, E: int, dev):
    """Record columns of a plain walk: kind -1, the rest 0."""
    kind = torch.full((N, E), -1, dtype=I32, device=dev)
    arg, dst, ln = (torch.zeros((N, E), dtype=I32, device=dev)
                    for _ in range(3))
    return kind, arg, dst, ln


def _walk_plain(slots: torch.Tensor, csizes: torch.Tensor, out_len: int,
                E: int):
    """The walk kernel's function in plain PyTorch: every live row
    advances one token per step, with the kernel's state machine (see
    csrc/walk.cu)."""
    N = slots.shape[0]
    dev = slots.device
    cs = csizes.to(I64)
    kind, arg, dst, ln = empty_records(N, E, dev)
    zero = torch.zeros(N, dtype=I64, device=dev)
    ip, op, extacc, dist, cnt = zero + 1, zero.clone(), zero.clone(), \
        zero.clone(), zero.clone()
    uni = torch.ones(N, dtype=torch.bool, device=dev)
    err, fin = cs <= 0, cs <= 1
    byte = byte_reader(slots, cs)

    def record(r, k, a, d, l):
        c = cnt[r]
        kind[r, c], arg[r, c] = k.to(I32), a.to(I32)
        dst[r, c], ln[r, c] = d.to(I32), l.to(I32)
        cnt[r] = c + 1

    token = byte(torch.arange(N, device=dev), zero) & 31
    j8 = torch.arange(8, device=dev)[None, :]
    while True:
        rows = torch.nonzero(~(err | fin)).flatten()
        if rows.numel() == 0:
            break
        tk = token[rows]
        # ---- literal rows ---------------------------------------------
        m = tk < 32
        if bool(m.any()):
            r, llen = rows[m], tk[m] + 1
            ip2, op2 = ip[r] + llen, op[r] + llen
            bad = (op2 > out_len) | (ip2 > cs[r]) | (cnt[r] >= E)
            err[r[bad]] = True
            g = ~bad
            r, llen, ip2, op2 = r[g], llen[g], ip2[g], op2[g]
            record(r, torch.zeros_like(llen), ip[r], op[r], llen)
            op[r] = op2
            f2 = ip2 >= cs[r]
            fin[r] = f2
            token[r] = torch.where(f2, token[r], byte(r, ip2))
            ip[r] = torch.where(f2, ip2, ip2 + 1)
        # ---- match rows -------------------------------------------------
        m = ~m
        if bool(m.any()):
            r, t = rows[m], tk[m]
            ipm = ip[r]
            w8 = byte(r, ipm[:, None] + j8)
            kk = torch.cumprod((w8 == 255).to(I64), dim=1).sum(dim=1)
            he = (t >> 5) == 7
            ext = he & (kk >= 8)
            if bool(ext.any()):
                re = r[ext]
                bad = ip[re] + 8 >= cs[re]
                err[re[bad]] = True
                rg = re[~bad]
                ip[rg] += 8
                extacc[rg] += 8 * 255
            f = ~ext
            r, t, ipm, kk, he, w8 = r[f], t[f], ipm[f], kk[f], he[f], w8[f]
            if r.numel():
                lastb = w8.gather(1, torch.clamp(kk, max=7)[:, None])[:, 0]
                mlen = torch.where(he, 6 + extacc[r] + 255 * kk + lastb,
                                   (t >> 5) - 1) + 3
                eoff = torch.where(he, kk + 1, 0)
                dhi = t & 31
                dlo = byte(r, ipm + eoff)
                far = (dlo == 255) & (dhi == 31)
                bk = torch.where(far, (byte(r, ipm + eoff + 1) << 8)
                                 + byte(r, ipm + eoff + 2) + 8192,
                                 (dhi << 8) + dlo + 1)
                ip4 = ipm + eoff + 1 + torch.where(far, 2, 0)
                opm = op[r]
                bad = ((bk > opm) | (opm + mlen > out_len) | (ip4 >= cs[r])
                       | (cnt[r] >= E))
                err[r[bad]] = True
                g = ~bad
                r, bk, mlen, ip4, opm = r[g], bk[g], mlen[g], ip4[g], opm[g]
                record(r, torch.ones_like(bk), bk, opm, mlen)
                d2 = torch.where(dist[r] == 0, bk, dist[r])
                uni[r] = uni[r] & (bk == d2)
                dist[r] = d2
                op[r] = opm + mlen
                token[r] = byte(r, ip4)
                ip[r] = ip4 + 1
                extacc[r] = 0
    ok = ~err & (op == out_len)
    return (kind, arg, dst, ln), dist.to(I32), uni, ok


# ---------------------------------------------------------------------------
# Pure-tile fast path: periodic rows at any power-of-two distance <= 256
# ---------------------------------------------------------------------------

_TILE_K = 8     # record slots that may hold the prefix literals


def pure_tile_eligible(rf, valid, dist, uni, ok, csizes, out_len: int):
    """Rows of the shape [literal prefix of d bytes][ONE match at
    distance d covering [d, out_len-1)][1-byte literal tail] with d a
    power of two <= 256, prefix literals in the first _TILE_K slots:
    then out[x] = prefix[x mod d] for x < out_len-1."""
    N = valid.shape[0]
    if out_len < 256 or out_len % 256:
        return torch.zeros(N, dtype=torch.bool, device=valid.device)
    kind, srco, dsto, ln = (f.to(I64) for f in rf)
    dist = dist.to(I64)
    d = dist[:, None]
    m = valid & (kind == 1)
    lit = valid & (kind == 0)
    lit_pre = lit & (dsto < d)
    lit_tail = lit & (dsto == out_len - 1)
    zero = torch.zeros((), dtype=I64, device=valid.device)
    nmatch = m.sum(dim=1)
    mlen = torch.where(m, ln, zero).sum(dim=1)
    mdst_ok = (~m | (dsto == d)).all(dim=1)
    mdist_ok = (~m | (srco == d)).all(dim=1)
    cover = torch.where(lit_pre, ln, zero).sum(dim=1) == dist
    inb = (~lit_pre | (dsto + ln <= d)).all(dim=1)
    tail1 = torch.where(lit_tail, ln, zero).sum(dim=1) == 1
    no_other = (~lit | lit_pre | lit_tail).all(dim=1)
    pow2 = (dist & (dist - 1)) == 0
    slot = torch.arange(kind.shape[1], device=valid.device)[None, :]
    lead = (~lit_pre | (slot < _TILE_K)).all(dim=1)
    return (ok & uni & (dist >= 1) & (dist <= 256) & pow2
            & (nmatch == 1) & (mlen == out_len - 1 - dist)
            & mdst_ok & mdist_ok & cover & inb & tail1 & no_other & lead)


def _pure_tile_place(slots, csizes, rf, rec_valid, dist, elig,
                     out_len: int):
    """Closed-form output for pure_tile_eligible rows: the d-byte pattern
    from the prefix literals (the first _TILE_K record slots), tiled to
    out_len, tail byte patched. Returns (out, elig); rows not eligible
    are don't-care."""
    N, W = slots.shape
    dev = slots.device
    kind, srco, dsto, ln = (f.to(I64) for f in rf)
    d = torch.clamp(dist.to(I64), min=1)[:, None]
    lit_pre = rec_valid & elig[:, None] & (kind == 0) & (dsto < d)
    pat = torch.zeros((N, 257), dtype=U8, device=dev)   # column 256: sink
    j = torch.arange(256, device=dev)[None, :]
    rows = torch.arange(N, device=dev)[:, None]
    for r in range(min(_TILE_K, kind.shape[1])):
        s, off, L = srco[:, r:r + 1], dsto[:, r:r + 1], ln[:, r:r + 1]
        p = s + j                                   # stream position
        dp = off + j                                # pattern position
        live = (lit_pre[:, r:r + 1] & (j < L) & (p < csizes[:, None])
                & (p < W) & (dp >= 0) & (dp < d))
        vals = slots[rows, torch.clamp(p, 0, W - 1)]
        pat[rows, torch.where(live, dp, 256)] = vals
    lit_tail = rec_valid & (kind == 0) & (dsto == out_len - 1)
    tsrc = torch.where(lit_tail, srco, -1).max(dim=1).values
    tbyte = slots.gather(1, torch.clamp(tsrc, 0, W - 1)[:, None])[:, 0]
    return _tile_from_pattern(pat[:, :256], dist, tbyte, out_len), elig


def _tile_from_pattern(pat: torch.Tensor, dist: torch.Tensor,
                       tbyte: torch.Tensor, out_len: int) -> torch.Tensor:
    """Tile per-row patterns to out_len and patch the tail byte.

    pat: (N, 256) integer pattern prefix (lanes >= d are overwritten);
    dist: (N,) power-of-two distances <= 256; tbyte: (N,) final byte.
    Eight static bit-clearing passes (pat[j] := pat[j & ~w] wherever
    d <= w) make the pattern d-periodic over 256 lanes, exactly as the
    JAX version does; one broadcast then writes the row."""
    N = pat.shape[0]
    dev = pat.device
    pat = pat.to(U8)
    d = torch.clamp(dist.to(I64), min=1)[:, None]
    col = torch.arange(256, device=dev)[None, :]
    for k in range(8):
        w = 1 << k
        shifted = pat[:, torch.arange(256, device=dev) & ~w]
        pat = torch.where((d <= w) & ((col & w) != 0), shifted, pat)
    out = pat.repeat(1, out_len // 256)
    out[:, -1] = tbyte.to(U8)
    return out


# ---------------------------------------------------------------------------
# Template fast path: closed-form parse of the encoder's PURE streams
# ---------------------------------------------------------------------------

_TEMPLATE_DS = (1, 2, 4, 8, 16, 32, 64, 128, 256)


@lru_cache(maxsize=None)
def _template_table(out_len: int):
    """Static stream templates of codec._emit_pure emissions: for each
    pow2 d <= 256, the positions and values every control/token byte of
    a PURE stream must hold, and its csize. A stream satisfying one
    template (plus csize equality) parses to exactly the pure form under
    the wire grammar (blosc/blosclz.c:679-789).

    Returns [(d, csize, positions, values)]."""
    tmpl = []
    for d in _TEMPLATE_DS:
        if out_len - 1 - d < 3:
            continue
        nc1 = -(-d // 32)
        E1 = d + nc1
        vp = out_len - 4 - d
        kp = (vp - 6) // 255 + 1 if vp >= 6 else 0
        E2 = E1 + 2 + kp
        csize = E2 + 2
        pos, val = [], []
        for k in range(nc1):
            v = min(32, d - 32 * k) - 1
            if k == 0:
                v |= 32                      # format marker bit
            pos.append(33 * k)
            val.append(v)
        dm1 = d - 1
        tok0 = (((vp + 1) << 5) if vp < 6 else (7 << 5)) | (dm1 >> 8)
        pos.append(E1)
        val.append(tok0)
        for q in range(1, kp + 1):
            pos.append(E1 + q)
            val.append(max(0, min(vp - 6 - 255 * (q - 1), 255)))
        pos.append(E1 + kp + 1)
        val.append(dm1 & 255)
        pos.append(E2)
        val.append(0)
        tmpl.append((d, csize, np.asarray(pos, np.int64),
                     np.asarray(val, np.int32)))
    return tmpl


def _template_match(slots: torch.Tensor, csizes: torch.Tensor, out_len: int):
    """Recognize PURE-template rows with elementwise ops only.

    Returns (match (N,) bool, d (N,) int64, pat (N, 256) uint8 pattern
    prefix, tail (N,) int64 last output byte), or None when no template
    applies at this geometry."""
    if out_len < 256 or out_len % 256:
        return None
    tmpl = _template_table(out_len)
    if not tmpl:
        return None
    N, W = slots.shape
    dev = slots.device
    PT = max(264, max(cs for _, cs, _, _ in tmpl))
    PT = -(-PT // 128) * 128
    pre = (slots[:, :PT] if W >= PT
           else torch.nn.functional.pad(slots, (0, PT - W)))
    allpos = np.concatenate(
        [np.concatenate([pos, [csz - 1]]) for _, csz, pos, _ in tmpl])
    sel = pre[:, torch.from_numpy(allpos).to(dev)].to(I64)
    cs = csizes.to(I64)
    match = torch.zeros(N, dtype=torch.bool, device=dev)
    dsel = torch.zeros(N, dtype=I64, device=dev)
    tail = torch.zeros(N, dtype=I64, device=dev)
    off = 0
    for d, csz, pos, val in tmpl:
        k = len(pos)
        okr = (cs == csz) & (
            sel[:, off:off + k] == torch.from_numpy(val).to(dev)[None, :]
        ).all(dim=1)
        new = okr & ~match
        dsel = torch.where(new, d, dsel)
        tail = torch.where(new, sel[:, off + k], tail)
        match = match | okr
        off += k + 1
    # pattern byte j sits at stream position j + 1 + j//32
    jmap = np.minimum(np.arange(256) + 1 + np.arange(256) // 32, PT - 1)
    pat = pre[:, torch.from_numpy(jmap).to(dev)]
    return match, dsel, pat, tail


# ---------------------------------------------------------------------------
# Placement drivers
# ---------------------------------------------------------------------------

_MERGE_TARGET = 32768   # virtual-row size merge_factor aims for


def merge_factor(R: int, out_len: int) -> int:
    """How many small rows merge_rows may fuse into one expand row."""
    m = 1
    while m * 2 * out_len <= _MERGE_TARGET and m * 2 <= R and R % (m * 2) == 0:
        m *= 2
    return m


def merge_rows(sl: torch.Tensor, rf, ok: torch.Tensor, out_len: int, m: int):
    """Fuse m consecutive rows into one virtual row for the expand
    kernel: dst offsets shift by k*out_len, literal src offsets by k*W.
    Records of not-ok rows are invalidated."""
    rf = expand_mod._as_fields(rf)
    R, Wp = sl.shape
    E = rf[0].shape[1]
    k = torch.arange(R, device=sl.device) % m
    kind = torch.where(ok[:, None], rf[0], -1)
    src = rf[1] + torch.where(kind == 0, (k * Wp)[:, None], 0).to(rf[1].dtype)
    dst = rf[2] + (k * out_len)[:, None].to(rf[2].dtype)
    rfm = tuple(a.reshape(R // m, m * E) for a in (kind, src, dst, rf[3]))
    return sl.reshape(R // m, m * Wp), rfm


def kernel_place_rows(sl: torch.Tensor, rf, out_len: int, W: int):
    """Expand-kernel placement of walked rows (records compacted, as the
    walk writes them). Rows are not merged: a CTA per row already fills
    the card at the batch sizes the pipeline sees."""
    return expand_mod.expand(sl[:, :W].contiguous(), rf, out_len)


def decode_core(walk_fn, slots: torch.Tensor, csizes: torch.Tensor,
                out_len: int, maxrec: int):
    """Walk + place one batch of live rows, for any of the three walk
    grammars (walk_fn: this module's walk, codec_lz4.walk or
    codec_snappy.walk). Returns (out uint8 (N, out_len), handled bool
    (N,)); rows not handled are don't-care."""
    N, W = slots.shape
    rf, dist, uni, ok = walk_fn(slots, csizes, out_len, maxrec)
    live = ok & (csizes > 0)
    valid = rf[0] >= 0
    elig = pure_tile_eligible(rf, valid, dist, uni, ok, csizes,
                              out_len) & live
    out = torch.zeros((N, out_len), dtype=U8, device=slots.device)
    t = torch.nonzero(elig).flatten()
    if t.numel():
        tile, _ = _pure_tile_place(
            slots[t], csizes[t], tuple(f[t] for f in rf), valid[t], dist[t],
            elig[t], out_len)
        out[t] = tile
    k = torch.nonzero(live & ~elig).flatten()
    if k.numel():
        out[k] = kernel_place_rows(slots[k], tuple(f[k] for f in rf),
                                   out_len, W)
    return out, live


def decode_walked(walk_fn, default_records, slots: torch.Tensor,
                  csizes: torch.Tensor, out_len: int, maxrec_hint: int = 0):
    """Decode of a codec whose every live row takes its walk (LZ4 and
    snappy have no template path): (out, produced, err) as the JAX
    decoders return them. Rows the walk cannot handle report err (the
    byte API retries with a wider budget, then decodes the chunk on the
    host); so do all live rows of a geometry outside decode_cap.
    maxrec_hint overrides the budget default_records(out_len)."""
    N = slots.shape[0]
    dev = slots.device
    if out_len > decode_cap() or out_len < 8:
        return (torch.zeros((N, out_len), dtype=U8, device=dev),
                torch.zeros(N, dtype=I32, device=dev), csizes > 0)
    maxrec = maxrec_hint or default_records(out_len)
    sk, handled = decode_core(walk_fn, slots, csizes, out_len, maxrec)
    produced = torch.where(handled, out_len, 0).to(I32)
    return sk, produced, ~handled & (csizes > 0)


def decode(slots: torch.Tensor, csizes: torch.Tensor, out_len: int):
    """Drop-in for codec.decode with the structured fast path.

    Returns (out, produced, err) with codec.decode's semantics, equal to
    cblosc_tpu.tpu.structured.decode's."""
    if out_len > decode_cap() or out_len < 8:
        return codec.decode(slots, csizes, out_len)
    maxrec = max_records(out_len)
    N = slots.shape[0]
    dev = slots.device
    sk = torch.zeros((N, out_len), dtype=U8, device=dev)
    handled = torch.zeros(N, dtype=torch.bool, device=dev)
    tm = _template_match(slots, csizes, out_len)
    if tm is not None:
        tmatch, d_t, pat, tail = tm
        t = torch.nonzero(tmatch).flatten()
        if t.numel():
            sk[t] = _tile_from_pattern(pat[t], d_t[t], tail[t], out_len)
            handled = tmatch.clone()
    rest = torch.nonzero(~handled & (csizes > 0)).flatten()
    if rest.numel():
        sk_w, handled_w = decode_core(walk, slots[rest], csizes[rest],
                                      out_len, maxrec)
        h = rest[handled_w]
        sk[h] = sk_w[handled_w]
        handled[h] = True
    produced = torch.where(handled, out_len, 0).to(I32)
    err = ~handled
    fb = torch.nonzero(~handled & (csizes > 0)).flatten()
    if fb.numel():
        fb_out, fb_prod, fb_err = codec.decode(slots[fb].contiguous(),
                                               csizes[fb].contiguous(),
                                               out_len)
        sk[fb] = fb_out
        produced[fb] = fb_prod
        err[fb] = fb_err
    return sk, produced, err
