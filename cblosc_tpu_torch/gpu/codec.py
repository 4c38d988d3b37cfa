"""Device BloscLZ codec: vectorized encoder + generic batched decoder.

PyTorch counterpart of cblosc_tpu/tpu/codec.py. Any conforming token
stream is a valid blosclz stream (the format is fixed by the decoder,
blosc/blosclz.c:679-789), and the encoder is the JAX package's strategy
over that format, reproduced byte for byte:

  * typed data after the shuffle filter is dominated by periodic
    structure inside each byte-plane; :func:`_score` scores a static set
    of candidate distances per stream by adjacent-pair coverage, picks
    the best per stream and flags PURE rows (one run covers everything
    matchable);
  * PURE rows take the closed-form :func:`_emit_pure`; NORMAL rows run
    segmentation (cummax/cummin) and a prefix-sum layout
    (:func:`_emit_full`); HOPELESS rows (estimated ratio below the
    clevel's entropy-probe threshold, blosclz.c:425-435) report
    csize = n and are stored raw by the caller;
  * at the ratio clevels (``encode(..., mine=True)``, clevel >= 5)
    :func:`mine_group` mines a per-row adaptive distance, the modal gap
    between repeated 4-grams on a 4 KB prefix and on a hash-folded copy
    of the whole row, verified by its exact coverage; runs at that
    distance claim their positions before the static class, distances
    above 8191 take the far escape (blosclz.c:733-744). NORMAL rows are
    mined and emitted; HOPELESS rows are mined and emitted only where a
    distance is adopted. On a CUDA tensor the miner is one launch of a
    hand-written kernel (csrc/mine.cu); :func:`_mine_group_plain` is its
    function in plain PyTorch, taken on a CPU tensor.

The generic decoder accepts any blosclz stream. :func:`decode` launches
the hand-written kernel (csrc/decode.cu, a CTA of three pipelined warps
per row, the row's output in shared memory) on a CUDA tensor and runs :func:`_decode_plain`
on a CPU tensor; both reproduce cblosc_tpu.tpu.codec.decode's (out,
produced, err), errors included.
"""

from __future__ import annotations

import torch

from . import kernels
from ..utils import trace

I64 = torch.int64
U8 = torch.uint8

_FASTLIT = 16         # literal cells per fast decoder step (est_iters model)
_MATW = 1024          # match bytes per decoder step (est_iters model)
_MIN_DECODE_W = _FASTLIT * 33 + 24   # the JAX decoder's padded row width

# Candidate match distances: 1 catches constant runs, powers of two catch
# arithmetic ramps and strided layouts, 3 covers RGB-ish strides. All
# < 8192, so the near-distance form always fits.
DISTANCES = (1, 2, 3, 4, 8, 16, 32, 128, 256)

# blosclz far-distance form: dist = (b1 << 8 | b2) + 8192 after the
# 31/255 escape (blosclz.c:733-744)
MAX_FARDIST = 8192 + 65535
_MINRUN_MINED = 16          # min run length of a mined-distance match
_MINE_PREFIX = 4096         # the exact miner's prefix
_FOLD_G = 16                # the fold miner's group below 128 KB rows
_BIGU = 0xFFFFFFFF          # gram key of "no gram here"
_BIGI = 0x7FFFFFFF          # gap of "no usable gap"


def slot_width(n: int) -> int:
    """Worst-case encoded size of an n-byte stream (all literals)."""
    return n + (n + 31) // 32 + 8


# ---------------------------------------------------------------------------
# Encoder
# ---------------------------------------------------------------------------

def _score(s: torch.Tensor, dists: tuple):
    """Distance selection + purity detection.

    Returns (d_row (N,1) int64, pure (N,) bool, cov (N,), total (N,))
    with cov == total == the adjacent-pair match count at the chosen
    distance (first maximum, smallest d). A row is PURE when one run at
    the chosen distance covers [d, n-1)."""
    N, n = s.shape
    pairs, pures = [], []
    for d in dists:
        if d >= n - 2:
            pairs.append(torch.zeros(N, dtype=I64, device=s.device))
            pures.append(torch.zeros(N, dtype=torch.bool, device=s.device))
            continue
        e = s[:, d:n - 1] == s[:, :n - 1 - d]
        cnt = (e[:, 1:] & e[:, :-1]).sum(dim=1)
        pairs.append(cnt)
        pures.append(cnt == n - 2 - d)
    stack = torch.stack(pairs, 0)
    best = torch.argmax(stack, dim=0)                    # first maximum
    d = torch.tensor(dists, dtype=I64, device=s.device)[best]
    total = stack.gather(0, best[None])[0]
    pure_best = torch.stack(pures, 0).gather(0, best[None])[0]
    pure = pure_best & (n - 1 - d >= 3) & (d <= 256)
    total = torch.where(pure, n - 2 - d, total)
    return d[:, None], pure, total, total


def _eq_for(s: torch.Tensor, d_row: torch.Tensor, dists: tuple,
            last_lit: bool = True) -> torch.Tensor:
    """eq mask at each row's chosen distance; last_lit keeps the final
    byte out of matches (the grammar's trailing-literal rule)."""
    N, n = s.shape
    idx = torch.arange(n, device=s.device)
    eq = torch.zeros_like(s, dtype=torch.bool)
    for d in dists:
        if d >= n:
            continue
        prev = torch.cat([s[:, :d], s[:, :-d]], dim=1)
        e = (s == prev) & (idx >= d)
        eq = torch.where(d_row == d, e, eq)
    if last_lit:
        eq = eq & (idx < n - 1)
    return eq


def _emit_pure(s: torch.Tensor, d_vec: torch.Tensor, W: int):
    """Closed-form emission: a literal prefix of d bytes, ONE match token
    covering [d, n-1) (255-extension bytes make the length unbounded,
    blosclz.c:698-706), a 1-byte literal tail. Computed for every row;
    only PURE rows keep it."""
    G, n = s.shape
    dev = s.device
    PW = min(W, 2048)
    d = d_vec.reshape(-1, 1).to(I64)
    eff = n - 1 - d
    vp = eff - 3
    kp = torch.where(vp >= 6, (vp - 6) // 255 + 1, 0)
    nc1 = (d + 31) // 32
    E1 = d + nc1
    E2 = E1 + 2 + kp                        # tok0 + ext... + dist_lo
    csize = (E2 + 2)[:, 0]                  # + tail ctrl + last byte
    dm1 = d - 1
    dhi, dlo = dm1 >> 8, dm1 & 255

    p = torch.arange(PW, device=dev)[None, :]
    # region 1: literal chunks, a control byte every 33 emitted bytes
    k = p // 33
    isc1 = p % 33 == 0
    clen1 = torch.clamp(d - 32 * k, max=32)
    src1 = torch.clamp(p - k - 1, 0, n - 1)[0]
    b1 = torch.where(isc1, clen1 - 1, s[:, src1].to(I64))
    # region 2: tok0, kp extension bytes, dist_lo
    q = p - E1
    tok0p = torch.where(vp < 6, (vp + 1) * 32, 7 * 32) | dhi
    extp = torch.clamp(vp - 6 - 255 * (q - 1), 0, 255)
    b2 = torch.where(q == 0, tok0p, torch.where(q <= kp, extp, dlo))
    # region 3: trailing ctrl (one literal) + the last byte
    b3 = torch.where(p == E2, 0, s[:, n - 1:n].to(I64))

    out = torch.where(p < E1, b1, torch.where(p < E2, b2, b3))
    out = torch.where(p < csize[:, None], out, 0)
    out[:, 0] |= 32                                      # format marker bit
    slots = torch.zeros((G, W), dtype=U8, device=dev)
    slots[:, :PW] = (out & 0xFF).to(U8)

    npart = (d[:, 0] % 32 > 0).to(I64) + 1
    nfull = d[:, 0] // 32
    copy_iters = ((eff - 1) // _MATW + kp // 8)[:, 0]
    est = 1 + npart + nfull // _FASTLIT + copy_iters + 8
    return slots, csize, est


def _mine_distance(s: torch.Tensor, min_gap: int = 4,
                   max_gap: int = MAX_FARDIST):
    """Per-row adaptive match distance: the modal gap between repeated
    4-grams that start where s[i] != s[i-1] (run interiors would drown
    the large periods in gap-1 repeats). A stable sort on the gram makes
    each gram's predecessor its nearest earlier occurrence.

    Returns (d, hits), int64 (N,): d in [min_gap, max_gap] with its
    count of gaps, d = hits = 0 where fewer than 4 gaps agree. A gram of
    four 255 bytes equals the sentinel _BIGU and is never usable, as in
    the JAX miner."""
    N, n = s.shape
    dev = s.device
    idx = torch.arange(n, device=dev)[None, :]
    su = s.to(I64)
    gram = su
    for k in range(1, 4):
        gram = gram | (torch.roll(su, -k, dims=1) << (8 * k))
    novel = torch.ones_like(s, dtype=torch.bool)
    novel[:, 1:] = s[:, 1:] != s[:, :-1]
    novel &= idx < n - 3
    # keys shifted into int32 keep their order and equalities
    key = (torch.where(novel, gram, _BIGU) - (1 << 31)).to(torch.int32)
    sk, si = torch.sort(key, dim=1, stable=True)
    same = (sk == torch.roll(sk, 1, dims=1)) & (sk != _BIGU - (1 << 31))
    same[:, 0] = False
    gap = si - torch.roll(si, 1, dims=1)
    usable = same & (gap >= min_gap) & (gap <= max_gap)
    ds = torch.sort(torch.where(usable, gap, _BIGI).to(torch.int32),
                    dim=1).values.to(I64)
    # the longest run of equal gaps is the mode; ties go to the first
    # (smallest) gap, as JAX's argmax does
    change = torch.ones_like(ds, dtype=torch.bool)
    change[:, 1:] = ds[:, 1:] != ds[:, :-1]
    rstart = torch.cummax(torch.where(change, idx, 0), dim=1).values
    count = torch.where(ds < _BIGI, idx - rstart + 1, 0)
    hits = count.amax(dim=1)
    best = torch.where(count == hits[:, None], idx, n).amin(dim=1)
    d = ds.gather(1, best[:, None])[:, 0]
    d = torch.where((hits >= 4) & (d < _BIGI), d, 0)
    return d, torch.where(d > 0, hits, 0)


def _fold_g(n: int) -> int:
    """The fold miner's group: 32 bytes on rows of 128 KB and more (the
    clevel-9 geometry), else 16."""
    return 32 if n >= 131072 else _FOLD_G


def _fold(s: torch.Tensor, G: int) -> torch.Tensor:
    """Fold every G bytes to one hash byte: 4 equal consecutive hash
    bytes at group gap g stand (whp) for a 4G-byte repeat at byte
    distance G*g."""
    N, n = s.shape
    # the weights ((2654435761 * (k + 1)) >> 13) & 0xFF, made on the
    # device (a host copy would wait for the stream)
    k = torch.arange(1, G + 1, dtype=I64, device=s.device)
    w = (((2654435761 * k) >> 13) & 0xFF).to(torch.int32)
    h = (s.reshape(N, n // G, G).to(torch.int32) * w).sum(
        dim=2, dtype=torch.int32)                # <= 255 * 255 * G: exact
    return ((h ^ (h >> 8) ^ (h >> 16)) & 0xFF).to(U8)


def _eq_at(s: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    """(N, n) bool: s[i] == s[i - d_row] where i >= d_row and i < n - 1
    (the trailing-literal rule); no position where d_row > n."""
    N, n = s.shape
    idx = torch.arange(n, device=s.device)[None, :]
    d = d.to(I64)[:, None]
    prev = s.gather(1, torch.clamp(idx - d, min=0))
    return (s == prev) & (idx >= d) & (idx < n - 1)


def mine_group(s: torch.Tensor, d_row: torch.Tensor,
               max_d: int = MAX_FARDIST):
    """The two miners and one exact verification, per row.

    The exact miner reads the first 4 KB of rows of 1 KB and more; the
    fold miner reads the whole row folded G:1 (rows of 32 KB and more,
    distances that are multiples of G). The candidate with more hits
    (byte-scaled) is verified; a row adopts it when it covers at least
    n/6 positions and differs from the row's static distance.

    On a CUDA tensor one launch of the mining kernel (csrc/mine.cu) does
    all of it; on a CPU tensor :func:`_mine_group_plain` does. The span
    counts the rows and the launches.

    Returns (d_m int64 (N,), 0 = not adopted; eq_m bool (N, n), empty on
    rows that adopt nothing)."""
    with trace.span("codec.mine_group"):
        trace.count("rows", s.shape[0])
        if not s.is_cuda:
            return _mine_group_plain(s, d_row, max_d)
        kernels.require(s, "s", U8, 2)
        N, n = s.shape
        d_row = d_row.reshape(-1)
        if (d_row.numel() != N or d_row.device != s.device
                or d_row.dtype not in (torch.int32, I64)):
            raise ValueError("d_row must hold N int32 or int64 values on "
                             "the rows' device")
        if not 0 <= max_d <= MAX_FARDIST:
            raise ValueError(f"max_d {max_d} outside [0, {MAX_FARDIST}]")
        d_row = d_row.contiguous()
        d_m = torch.empty(N, dtype=I64, device=s.device)
        eq_m = torch.empty((N, n), dtype=torch.bool, device=s.device)
        if N == 0:
            return d_m, eq_m
        per_row = kernels.fn("mine.scratch_bytes")(n)
        scratch = (torch.empty(N * per_row, dtype=U8, device=s.device)
                   if per_row else None)
        code = kernels.fn("mine")(
            s.data_ptr(), N, n, d_row.data_ptr(), int(d_row.dtype == I64),
            max_d, None if scratch is None else scratch.data_ptr(), per_row,
            d_m.data_ptr(), eq_m.data_ptr(), kernels.stream_ptr(s))
        kernels.check("mine", code)
        trace.count("launches", 1)
        return d_m, eq_m


def _mine_group_plain(s: torch.Tensor, d_row: torch.Tensor,
                      max_d: int = MAX_FARDIST):
    """:func:`mine_group` in plain PyTorch, the mining kernel's function."""
    N, n = s.shape
    zero = torch.zeros(N, dtype=I64, device=s.device)
    with trace.span("mine.prefix"):
        if n >= 1024:
            dp, hp = _mine_distance(s[:, :min(n, _MINE_PREFIX)])
        else:
            dp = hp = zero
    FG = _fold_g(n)
    with trace.span("mine.fold"):
        if n >= 32768 and n % FG == 0:
            dg, hg = _mine_distance(_fold(s, FG), 1, max_d // FG)
            dg = dg * FG
            dg = torch.where(dg < n, dg, 0)
            # hits count FG-byte groups
            hg = torch.where(dg > 0, hg * FG, 0)
        else:
            dg = hg = zero
    with trace.span("mine.verify"):
        dp = torch.where(dp <= max_d, dp, 0)
        hp = torch.where(dp > 0, hp, 0)
        d = torch.where(hg > hp, dg, dp)
        eq_m = _eq_at(s, torch.clamp(d, min=1))
        cov = torch.where(d > 0, eq_m.sum(dim=1), -1)
        adopt = (cov >= n // 6) & (d > 0) & (d != d_row.reshape(-1))
        return torch.where(adopt, d, 0), eq_m & adopt[:, None]


def _segment(eq: torch.Tensor, min_len, idx: torch.Tensor):
    """Run segmentation of an eq mask: one token per maximal run.
    Returns (is_match, sub_start, suboff, sub_len) per position."""
    n = eq.shape[1]
    noneq = torch.where(eq, -1, idx)
    run_start = torch.cummax(noneq, dim=1).values + 1
    nxt = torch.where(eq, n, idx)
    next_noneq = torch.flip(torch.cummin(torch.flip(nxt, [1]), dim=1).values,
                            [1])
    runlen = next_noneq - run_start
    is_match = eq & (runlen >= min_len)
    suboff = idx - run_start
    sub_start = is_match & (suboff == 0)
    return is_match, sub_start, suboff, runlen


def _emit_full(s: torch.Tensor, eq: torch.Tensor, d_row: torch.Tensor,
               mined=None):
    """Segmentation + prefix-sum layout emission (any row shape).

    With mined = (d_m, eq_m) from :func:`mine_group`, runs of at least
    _MINRUN_MINED at the mined distance claim their positions first and
    the static class segments what is left.

    Every output byte has a unique position (a literal's byte, the
    control byte opening each 32-byte literal chunk, each token byte on
    the first positions of its match: a token of more than 2 bytes
    needs a static run of at least 9 or a mined one, whose 4 + kext
    bytes fit its >= 16 positions), so the stream is written with two
    scatters: the JAX package's key sort over (pos << 8 | byte) yields
    the same bytes."""
    N, n = s.shape
    dev = s.device
    W = slot_width(n)
    idx = torch.arange(n, device=dev)[None, :]

    if mined is not None:
        d_m, eq_m = mined
        m2, ss2, so2, sl2 = _segment(eq_m, _MINRUN_MINED, idx)
        m1, ss1, so1, sl1 = _segment(eq & ~m2, 3, idx)
        is_match = m1 | m2
        sub_start = torch.where(m2, ss2, ss1)
        suboff = torch.where(m2, so2, so1)
        sub_len = torch.where(m2, sl2, sl1)
        d_pos = torch.where(m2, d_m.to(I64)[:, None], d_row.to(I64))
    else:
        is_match, sub_start, suboff, sub_len = _segment(eq, 3, idx)
        d_pos = d_row.to(I64).expand(N, n)
    far = is_match & (d_pos > 8191)              # 31/255 escape + 2 bytes
    v = sub_len - 3                              # wire len field
    kext = torch.where(v >= 6, (v - 6) // 255 + 1, 0)
    tok_size = 2 + kext + 2 * far.to(I64)

    lit = ~is_match
    lit_start = torch.cummax(torch.where(lit, -1, idx), dim=1).values + 1
    is_ctrl = lit & ((idx - lit_start) % 32 == 0)
    nxtl = torch.where(lit, n, idx)
    next_nonlit = torch.flip(
        torch.cummin(torch.flip(nxtl, [1]), dim=1).values, [1])
    chunk_len = torch.clamp(next_nonlit - idx, max=32)

    c = (torch.where(lit, 1 + is_ctrl.to(I64), 0)
         + torch.where(sub_start, tok_size, 0))
    cum = torch.cumsum(c, dim=1)
    off = cum - c
    csize = cum[:, -1]

    full31 = is_ctrl & (chunk_len == 32)
    nfull = full31.sum(dim=1)
    npart = (is_ctrl & ~full31).sum(dim=1)
    ntok = sub_start.sum(dim=1)
    copy_iters = torch.where(
        sub_start, (sub_len - 1) // _MATW + kext // 8, 0).sum(dim=1)
    est_iters = ntok + npart + nfull // _FASTLIT + copy_iters + 8

    dm1 = d_pos - 1
    dhi = torch.where(far, 31, dm1 >> 8)
    dlo = torch.where(far, 255, dm1 & 255)
    fdist = d_pos - 8192
    tok0 = torch.where(v < 6, (v + 1) * 32, 7 * 32) | dhi
    j = suboff
    ext = torch.clamp(v - 6 - 255 * (j - 1), 0, 255)
    tail = torch.where(j == kext + 1, dlo,
                       torch.where(j == kext + 2, fdist >> 8, fdist & 255))
    tokb = torch.where(j == 0, tok0, torch.where(kext >= j, ext, tail))
    tokbase = torch.where(sub_start, off, off - tok_size)
    si = s.to(I64)

    val0 = torch.where(is_ctrl, chunk_len - 1, torch.where(is_match, tokb, si))
    pos0 = torch.where(is_match, tokbase + suboff, off)
    valid0 = lit | (is_match & (suboff < tok_size))

    buf = torch.zeros((N, W + 1), dtype=U8, device=dev)  # column W: sink
    buf.scatter_(1, torch.where(valid0 & (pos0 < W), pos0, W),
                 (val0 & 0xFF).to(U8))
    buf.scatter_(1, torch.where(is_ctrl & (off + 1 < W), off + 1, W),
                 s)
    slots = buf[:, :W]
    slots = torch.where(torch.arange(W, device=dev)[None, :] < csize[:, None],
                        slots, 0)
    slots[:, 0] |= 32                                    # format marker bit
    return slots.contiguous(), csize, est_iters


def _emit_full_grouped(s: torch.Tensor, d_row: torch.Tensor, dists: tuple,
                       mine: bool = False, emit_all: bool = True):
    """_emit_full over row groups (rows are independent; groups bound the
    int64 workspace to ~64 MB per intermediate), each group mined first
    when mine is set. emit_all False emits only the rows that adopt a
    mined distance (the HOPELESS rows' rule); the others report csize n,
    est 0 and zero slots."""
    N, n = s.shape
    dev = s.device
    W = slot_width(n)
    g = max(1, (8 << 20) // max(n, 1))
    parts = []
    for i in range(0, N, g):
        sg, dg = s[i:i + g], d_row[i:i + g]
        mined = mine_group(sg, dg) if mine else None
        if emit_all:
            parts.append(_emit_full(sg, _eq_for(sg, dg, dists), dg, mined))
            continue
        dm, eq_m = mined
        sl = torch.zeros((sg.shape[0], W), dtype=U8, device=dev)
        cs = torch.full((sg.shape[0],), n, dtype=I64, device=dev)
        es = torch.zeros(sg.shape[0], dtype=I64, device=dev)
        r = torch.nonzero(dm > 0).flatten()
        if r.numel():
            sl[r], cs[r], es[r] = _emit_full(
                sg[r], _eq_for(sg[r], dg[r], dists), dg[r], (dm[r], eq_m[r]))
        parts.append((sl, cs, es))
    return tuple(torch.cat([p[k] for p in parts]) for k in range(3))


def encode(s: torch.Tensor, dists: tuple = DISTANCES,
           min_cratio_x100: int = 0, mine: bool = False):
    """Encode batched streams.

    s: uint8 (N, n). Returns (slots uint8 (N, slot_width(n)), csizes int32
    (N,), est_iters int32 (N,)). est_iters estimates the JAX decoder's
    loop iterations (the caller's stored-raw speed policy). Rows that do
    not compress report csize >= n and the caller stores them raw
    (blosc.c:705-714). mine (clevel >= 5) layers mined adaptive
    distances in (:func:`mine_group`).

    Csizes equal cblosc_tpu.tpu.codec.encode's on every row, bytes and
    est_iters on every row with csize < n. Without mining they are equal
    on the others too (the don't-care slots of HOPELESS rows carry the
    first NORMAL row's emission and est_iters, which the JAX grouped map
    reads from its slot 0, or their own closed-form emission when no
    row is NORMAL); with mining a HOPELESS row that adopts nothing
    reports zero slots and est 0, where JAX gives its group's outcome."""
    N, n = s.shape
    W = slot_width(n)
    d_row, pure, cov, total = _score(s, dists)

    if N <= 8 or n < 8:  # the JAX encoder's small-batch branch: no classes
        mined = mine_group(s, d_row) if (mine and n >= 1024) else None
        slots, csize, est = _emit_full(s, _eq_for(s, d_row, dists), d_row,
                                       mined)
        return slots, csize.to(torch.int32), est.to(torch.int32)

    # entropy-probe analog: matched bytes ~ cov
    est_csize = n - cov + cov // 170 + n // 33 + 16
    hopeless = (~pure) & (100 * n < min_cratio_x100 * est_csize)
    normal = ~pure & ~hopeless

    slots, csize, est = _emit_pure(s, d_row, W)
    csize = torch.where(pure, csize, n)
    est = torch.where(pure, est, 0)
    rows = torch.nonzero(normal).flatten()
    if rows.numel():
        sl_n, cs_n, es_n = _emit_full_grouped(s[rows], d_row[rows], dists,
                                              mine)
        if not mine:
            hrows = torch.nonzero(hopeless).flatten()
            slots[hrows] = sl_n[0]
            est[hrows] = es_n[0]
        slots[rows] = sl_n
        csize[rows] = cs_n
        est[rows] = es_n
    if mine:
        # HOPELESS rows can hold large-period structure only mining sees:
        # they keep an emission where a distance is adopted
        hrows = torch.nonzero(hopeless).flatten()
        if hrows.numel():
            slots[hrows], csize[hrows], est[hrows] = _emit_full_grouped(
                s[hrows], d_row[hrows], dists, True, emit_all=False)
    return slots, csize.to(torch.int32), est.to(torch.int32)


# ---------------------------------------------------------------------------
# Decoder (kernel K3)
# ---------------------------------------------------------------------------

def decode(slots: torch.Tensor, csizes: torch.Tensor, out_len: int):
    """Decode batched blosclz streams.

    slots: uint8 (N, W), each row's stream in its first csizes[i] bytes,
    zero beyond; csizes int32 (N,). Returns (out uint8 (N, out_len),
    produced int32 (N,), err bool (N,))."""
    if not slots.is_cuda:
        return _decode_plain(slots, csizes, out_len)
    kernels.require(slots, "slots", U8, 2)
    kernels.require(csizes, "csizes", torch.int32, 1)
    N, W = slots.shape
    if csizes.shape[0] != N or csizes.device != slots.device:
        raise ValueError("csizes must be (N,) on the slots' device")
    out = torch.empty((N, out_len), dtype=U8, device=slots.device)  # all written
    produced = torch.empty(N, dtype=torch.int32, device=slots.device)
    err = torch.empty(N, dtype=torch.bool, device=slots.device)
    code = kernels.fn("decode_one")(
        slots.data_ptr(), N, W, csizes.data_ptr(), out_len, out.data_ptr(),
        produced.data_ptr(), err.data_ptr(), kernels.stream_ptr(slots))
    kernels.check("decode_one", code)
    return out, produced, err


def _decode_plain(slots: torch.Tensor, csizes: torch.Tensor, out_len: int):
    """The decode kernel's function in plain PyTorch: every live row
    advances one token per step (the shape of the JAX while_loop), with
    the kernel's exact state machine (see csrc/decode.cu)."""
    N, W = slots.shape
    dev = slots.device
    Wp = max(W, _MIN_DECODE_W)
    cs = csizes.to(I64)
    out = torch.zeros((N, out_len), dtype=U8, device=dev)
    zero = torch.zeros(N, dtype=I64, device=dev)
    ip, op, extacc = zero + 1, zero.clone(), zero.clone()
    err, fin = cs <= 0, cs <= 1

    def byte(rows, x):
        i = torch.clamp(x, max=Wp - 1)
        r = rows.view(-1, *([1] * (x.dim() - 1)))
        v = slots[r, torch.clamp(i, 0, W - 1)].to(I64)
        return torch.where(i < W, v, 0)

    token = byte(torch.arange(N, device=dev), zero) & 31
    j32 = torch.arange(32, device=dev)[None, :]
    j8 = torch.arange(8, device=dev)[None, :]
    while True:
        rows = torch.nonzero(~(err | fin)).flatten()
        if rows.numel() == 0:
            break
        tk, ipr, opr, csr = token[rows], ip[rows], op[rows], cs[rows]
        # ---- literal rows ---------------------------------------------
        m = tk < 32
        if bool(m.any()):
            r, t, ipl, opl, c = rows[m], tk[m], ipr[m], opr[m], csr[m]
            llen = t + 1
            pos = opl[:, None] + j32
            wr = (j32 < llen[:, None]) & (pos < out_len)
            vals = byte(r, ipl[:, None] + j32).to(U8)
            rr = r[:, None].expand_as(pos)
            out[rr[wr], pos[wr]] = vals[wr]
            ip2, op2 = ipl + llen, opl + llen
            f2 = ip2 >= c
            err[r] = (op2 > out_len) | (ip2 > c)
            fin[r] = f2
            token[r] = byte(r, ip2)
            ip[r] = torch.where(f2, ip2, ip2 + 1)
            op[r] = op2
        # ---- match rows -------------------------------------------------
        m = ~m
        if bool(m.any()):
            r, t, ipm, opm, c = rows[m], tk[m], ipr[m], opr[m], csr[m]
            w8 = byte(r, ipm[:, None] + j8)
            k = torch.cumprod((w8 == 255).to(I64), dim=1).sum(dim=1)
            has_ext = (t >> 5) == 7
            ext = has_ext & (k == 8)
            if bool(ext.any()):
                re, ipe = r[ext], ipm[ext]
                err[re] = ipe + 8 >= c[ext]
                ip[re] = ipe + 8
                extacc[re] += 8 * 255
            f = ~ext
            if bool(f.any()):
                r, t, ipm, opm, c = r[f], t[f], ipm[f], opm[f], c[f]
                k, he, w8 = k[f], has_ext[f], w8[f]
                lastb = w8.gather(1, torch.clamp(k, max=7)[:, None])[:, 0]
                mlen = torch.where(he, 6 + extacc[r] + 255 * k + lastb,
                                   (t >> 5) - 1) + 3
                ip2 = ipm + torch.where(he, k + 1, 0)
                dhi = t & 31
                dlo = byte(r, ip2)
                far = (dlo == 255) & (dhi == 31)
                bk = torch.where(far, (byte(r, ip2 + 1) << 8)
                                 + byte(r, ip2 + 2) + 8192, (dhi << 8) + dlo + 1)
                ip4 = ip2 + 1 + torch.where(far, 2, 0)
                bad = (bk > opm) | (opm + mlen > out_len) | (ip4 >= c)
                err[r[bad]] = True
                g = ~bad
                if bool(g.any()):
                    r, opm, mlen, bk, ip4 = r[g], opm[g], mlen[g], bk[g], ip4[g]
                    token[r] = byte(r, ip4)
                    jm = torch.arange(int(mlen.max()), device=dev)[None, :]
                    src = opm[:, None] - bk[:, None] + torch.remainder(
                        jm, bk[:, None])
                    wr = jm < mlen[:, None]
                    rr = r[:, None].expand_as(src)
                    vals = out[rr, torch.clamp(src, 0, out_len - 1)]
                    pos = opm[:, None] + jm
                    out[rr[wr], pos[wr]] = vals[wr]
                    op[r] = opm + mlen
                    ip[r] = ip4 + 1
                    extacc[r] = 0
    return out, op.to(torch.int32), err
