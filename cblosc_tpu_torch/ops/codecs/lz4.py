"""LZ4 block-format codec — pure-Python/numpy reference implementation.

Implements the public LZ4 block format (the format emitted/consumed by the
reference's vendored LZ4 via its thin wrappers, blosc/blosc.c:412-440):

  sequence := token | literals | offset(u16le) | ext-match-len
  token    := (literal_len:4bits | match_len-4:4bits), 15 => 255-chained
              extension bytes follow the corresponding field.
  The final sequence carries literals only. Format invariants: the last 5
  bytes of a block are literals; no match may begin within the last 12
  bytes; offsets are 1..65535.

Both a fast greedy encoder (acceleration = 10 - clevel, blosc.c:577-587)
and a high-compression hash-chain encoder (the LZ4HC role, depth scaling
with clevel) are provided. Decoding is shared (LZ4 and LZ4HC share the
wire format, blosc.h:96).
"""

from __future__ import annotations

import numpy as np

MINMATCH = 4
MFLIMIT = 12       # no match may start closer than this to the end
LASTLITERALS = 5   # the final bytes must be literals
MAX_OFFSET = 65535

_HASHLOG = 16
_HASH_MULT = 2654435761


def _u32(a: np.ndarray, i: int) -> int:
    return int(a[i]) | int(a[i + 1]) << 8 | int(a[i + 2]) << 16 | int(a[i + 3]) << 24


def _hash(v: int) -> int:
    return ((v * _HASH_MULT) & 0xFFFFFFFF) >> (32 - _HASHLOG)


def _common_prefix(a: np.ndarray, i: int, j: int, limit: int) -> int:
    if limit <= 0:
        return 0
    d = a[i:i + limit] != a[j:j + limit]
    hit = np.argmax(d)
    if d[hit]:
        return int(hit)
    return limit


def _emit_sequence(out: bytearray, a: np.ndarray, anchor: int, ip: int,
                   offset: int, mlen: int, maxout: int) -> bool:
    litlen = ip - anchor
    need = 1 + litlen + litlen // 255 + 2 + (mlen - MINMATCH) // 255 + 2
    if len(out) + need > maxout:
        return False
    ml = mlen - MINMATCH
    token_lit = 15 if litlen >= 15 else litlen
    token_ml = 15 if ml >= 15 else ml
    out.append((token_lit << 4) | token_ml)
    if litlen >= 15:
        rem = litlen - 15
        while rem >= 255:
            out.append(255)
            rem -= 255
        out.append(rem)
    out += a[anchor:ip].tobytes()
    out.append(offset & 255)
    out.append(offset >> 8)
    if ml >= 15:
        rem = ml - 15
        while rem >= 255:
            out.append(255)
            rem -= 255
        out.append(rem)
    return True


def _emit_last_literals(out: bytearray, a: np.ndarray, anchor: int, n: int,
                        maxout: int) -> bool:
    litlen = n - anchor
    need = 1 + litlen + litlen // 255 + 1
    if len(out) + need > maxout:
        return False
    token_lit = 15 if litlen >= 15 else litlen
    out.append(token_lit << 4)
    if litlen >= 15:
        rem = litlen - 15
        while rem >= 255:
            out.append(255)
            rem -= 255
        out.append(rem)
    out += a[anchor:n].tobytes()
    return True


def compress(src, maxout: int, acceleration: int = 1) -> bytes:
    """Greedy LZ4 encoder with the upstream skip-acceleration heuristic.
    Returns b"" when the output would not fit in maxout (incompressible)."""
    a = np.frombuffer(bytes(src), dtype=np.uint8)
    n = a.size
    out = bytearray()
    if n == 0:
        return b"" if maxout < 1 else bytes([0])
    acceleration = max(1, acceleration)
    anchor = 0
    if n >= MFLIMIT + 1:
        htab = np.full(1 << _HASHLOG, -1, dtype=np.int64)
        limit = n - MFLIMIT
        matchlimit = n - LASTLITERALS
        ip = 0
        while True:
            # --- search with skip acceleration (lz4.c:1021-1034): the
            # FIRST advance is always 1, then the stride becomes `accel`,
            # growing by 1 every 64 probes; a probe happens only if the
            # NEXT position is still inside mflimit+1. Probing p and p+1
            # before skipping matters for ratio: the stride-only grid
            # missed matches worth 1.6x chunk size at accel 9. ---
            attempts = acceleration << 6
            step = 1
            fwd = ip
            ref = -1
            while True:
                pos = fwd
                fwd += step
                step = attempts >> 6
                attempts += 1
                if fwd > limit + 1:
                    ref = -1
                    break
                h = _hash(_u32(a, pos))
                cand = int(htab[h])
                htab[h] = pos
                if cand >= 0 and pos - cand <= MAX_OFFSET and _u32(a, cand) == _u32(a, pos):
                    ref = cand
                    ip = pos
                    break
            if ref < 0:
                break
            # extend backwards over pending literals
            while ip > anchor and ref > 0 and a[ip - 1] == a[ref - 1]:
                ip -= 1
                ref -= 1
            mlen = MINMATCH + _common_prefix(
                a, ip + MINMATCH, ref + MINMATCH, matchlimit - (ip + MINMATCH)
            )
            if not _emit_sequence(out, a, anchor, ip, ip - ref, mlen, maxout):
                return b""
            ip += mlen
            anchor = ip
            if ip >= limit:
                break
            htab[_hash(_u32(a, ip - 2))] = ip - 2
    if not _emit_last_literals(out, a, anchor, n, maxout):
        return b""
    return bytes(out)


def compress_hc(src, maxout: int, clevel: int = 9) -> bytes:
    """High-compression encoder: hash-chain search with LAZY matching
    (defer the match while a strictly longer one starts at the next
    position — the upstream LZ4HC _Search2 idea, lz4hc.c, in the
    simpler zlib formulation). Depth grows with clevel. The round-3
    size audit vs the live reference build measured the greedy version
    up to 1.45x larger at mid clevels; lazy closes most of it."""
    a = np.frombuffer(bytes(src), dtype=np.uint8)
    n = a.size
    out = bytearray()
    if n == 0:
        return b"" if maxout < 1 else bytes([0])
    depth = 1 << min(clevel, 16)  # search depth per position
    anchor = 0
    if n >= MFLIMIT + 1:
        head = np.full(1 << _HASHLOG, -1, dtype=np.int64)
        chain = np.full(n, -1, dtype=np.int64)
        limit = n - MFLIMIT
        matchlimit = n - LASTLITERALS
        nexti = 0                 # insertion watermark: positions < nexti
                                  # are in the chains exactly once

        def best_at(pos: int):
            nonlocal nexti
            while nexti < pos:    # lazily index skipped/covered positions
                h = _hash(_u32(a, nexti))
                chain[nexti] = head[h]
                head[h] = nexti
                nexti += 1
            cand = int(head[_hash(_u32(a, pos))])
            best_len = 0
            best_ref = -1
            tries = depth
            maxm = matchlimit - pos
            while cand >= 0 and pos - cand <= MAX_OFFSET and tries > 0:
                tries -= 1
                # quick reject: candidate must beat the current best
                if (pos + best_len < matchlimit
                        and a[cand + best_len] == a[pos + best_len]):
                    m = _common_prefix(a, pos, cand, maxm)
                    if m > best_len:
                        best_len = m
                        best_ref = cand
                cand = int(chain[cand])
            return best_len, best_ref

        ip = 0
        while ip < limit:
            best_len, best_ref = best_at(ip)
            if best_len < MINMATCH:
                ip += 1
                continue
            # lazy: defer while a strictly longer match starts at ip+1
            while ip + 1 < limit:
                l2, r2 = best_at(ip + 1)
                if l2 > best_len:
                    ip += 1
                    best_len, best_ref = l2, r2
                else:
                    break
            ref = best_ref
            while ip > anchor and ref > 0 and a[ip - 1] == a[ref - 1]:
                ip -= 1
                ref -= 1
                best_len += 1
            if not _emit_sequence(out, a, anchor, ip, ip - ref, best_len, maxout):
                return b""
            ip += best_len
            anchor = ip
    if not _emit_last_literals(out, a, anchor, n, maxout):
        return b""
    return bytes(out)


def decompress(src, maxout: int) -> bytes:
    """LZ4_decompress_safe equivalent; raises ValueError on malformed input."""
    s = np.frombuffer(bytes(src), dtype=np.uint8)
    n = s.size
    out = np.empty(maxout, dtype=np.uint8)
    ip = 0
    op = 0
    while ip < n:
        token = int(s[ip]); ip += 1
        litlen = token >> 4
        if litlen == 15:
            while True:
                if ip >= n:
                    raise ValueError("truncated literal length")
                c = int(s[ip]); ip += 1
                litlen += c
                if c != 255:
                    break
        if ip + litlen > n or op + litlen > maxout:
            raise ValueError("literal run out of bounds")
        out[op:op + litlen] = s[ip:ip + litlen]
        ip += litlen
        op += litlen
        if ip >= n:
            break  # last sequence has no match part
        if ip + 2 > n:
            raise ValueError("truncated offset")
        offset = int(s[ip]) | int(s[ip + 1]) << 8
        ip += 2
        if offset == 0 or offset > op:
            raise ValueError("invalid match offset")
        mlen = token & 15
        if mlen == 15:
            while True:
                if ip >= n:
                    raise ValueError("truncated match length")
                c = int(s[ip]); ip += 1
                mlen += c
                if c != 255:
                    break
        mlen += MINMATCH
        if op + mlen > maxout:
            raise ValueError("match overflows output")
        ref = op - offset
        if offset == 1:
            out[op:op + mlen] = out[ref]
        elif offset >= mlen:
            out[op:op + mlen] = out[ref:ref + mlen]
        else:
            reps = -(-mlen // offset)
            out[op:op + mlen] = np.tile(out[ref:op], reps)[:mlen]
        op += mlen
    return out[:op].tobytes()
