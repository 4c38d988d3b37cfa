"""PyTorch port of the LZ4 codec vs cblosc_tpu.tpu.codec_lz4: the encoder's
slots, csizes and est_iters; the walk's records on every row the JAX walk
accepts (K4's plain version); decode; byte-API chunks for lz4 and lz4hc
byte-identical to the JAX package's; host-engine chunks decoded through
the byte API, the escalated-budget retry included. All exact."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from cblosc_tpu.core import engine as jeng
from cblosc_tpu.format import constants as C
from cblosc_tpu.ops.codecs import lz4 as jhost
from cblosc_tpu.tpu import codec_lz4 as jl, expand as je, host_api as jh
from cblosc_tpu.utils.timing import synth
import cblosc_tpu_torch as tb
from cblosc_tpu_torch.core import engine as teng, policy
from cblosc_tpu_torch.format.header import read_bstarts
from cblosc_tpu_torch.gpu import codec_lz4 as tl, host_api as th
from cblosc_tpu_torch.gpu import pipeline as tp, structured as ts
from cblosc_tpu_torch.ops.codecs import lz4 as thost
from cblosc_tpu_torch.utils import streams
from conftest import make_buffer
from test_torch_common import (assert_walk_matches_jax, corrupt, cuda,  # noqa: F401
                               jax_walk, pack_rows, stream_rows)

N_ROWS = 32     # the 8 KB walk tests share one JAX compile: (32, 8256)


def _textlike(rng, n):
    """Match-rich data: short words from a tiny dictionary, the shape
    that makes hash-table encoders emit a token every few bytes."""
    words = [rng.integers(97, 123, int(k), dtype=np.uint8)
             for k in rng.integers(3, 8, 24)]
    return np.concatenate(
        [words[i] for i in rng.integers(0, len(words), n // 3)])[:n].copy()


def _periodic_with_noise(rng, n) -> bytes:
    """A 97-byte period with one byte in 50 replaced at random: matches
    at several offsets, few tokens."""
    a = np.tile(rng.integers(0, 40, 97).astype(np.uint8), n // 97 + 1)[:n]
    idx = rng.integers(0, n, n // 50)
    a[idx] = rng.integers(0, 256, idx.size)
    return a.tobytes()


def _host_rows(rng, n):
    """LZ4 and LZ4HC streams of the host engine's encoders (mixed
    offsets), the port's own encoder's streams, one-byte corruptions and
    random rows, packed as the pipeline gathers them."""
    datas = [np.tile(rng.integers(0, 40, 97).astype(np.uint8), n // 97 + 1)[:n],
             np.frombuffer(make_buffer(rng, n, 4, "ramp"), np.uint8),
             np.frombuffer(make_buffer(rng, n, 1, "lowentropy"), np.uint8),
             (np.arange(n) // 7 % 251).astype(np.uint8)]
    host = []
    for d in datas:
        for enc in (lambda b: thost.compress(b, n, 1),
                    lambda b: thost.compress(b, n, 9),
                    lambda b: thost.compress_hc(b, n, 4),
                    lambda b: thost.compress_hc(b, n, 9)):
            e = enc(d.tobytes())
            if e:
                host.append(e)
    S = stream_rows(rng, n, 8)
    sl, cs, _ = tl.encode(torch.from_numpy(S))
    ours = [sl[i, :int(cs[i])].numpy().tobytes() for i in range(8)
            if int(cs[i]) < n]
    valid = host + ours
    rows = valid + corrupt(rng, valid[:6])
    rows += [rng.integers(0, 256, int(rng.integers(1, n)),
                          dtype=np.uint8).tobytes()
             for _ in range(N_ROWS - len(rows))]
    buf, cs = pack_rows(rows, n + 64)
    return buf, cs, rows, len(valid)


def test_host_codec_copy_matches_original(rng):
    """ops/codecs/lz4.py is the JAX package's host codec, byte for byte."""
    for d in (_textlike(rng, 5000), np.zeros(3000, np.uint8),
              rng.integers(0, 256, 2000, dtype=np.uint8)):
        b = d.tobytes()
        for accel in (1, 5, 9):
            assert thost.compress(b, 2 * len(b), accel) == \
                jhost.compress(b, 2 * len(b), accel)
        for clevel in (1, 9):
            enc = thost.compress_hc(b, 2 * len(b), clevel)
            assert enc == jhost.compress_hc(b, 2 * len(b), clevel)
            assert thost.decompress(enc, len(b)) == b
    assert policy.get_accel(C.LZ4, 3) == 7 and policy.get_accel(C.LZ4HC, 3) == 1


@pytest.mark.parametrize("N,min_cratio", [(24, 0), (24, 200), (6, 200)])
def test_encode_matches_jax(rng, N, min_cratio):
    """Slots, csizes and est_iters, with hopeless rows (random data at
    min_cratio 200) and the small-batch branch (N <= 8)."""
    n = 2048
    S = stream_rows(rng, n, N)
    want = [np.asarray(a) for a in jl.encode(jnp.asarray(S), jl.codec.DISTANCES,
                                             min_cratio, False)]
    got = [a.numpy() for a in tl.encode(torch.from_numpy(S), tl.codec.DISTANCES,
                                        min_cratio, False)]
    for w, g in zip(want, got):
        assert w.dtype == g.dtype and np.array_equal(w, g)
    if min_cratio and N > 8:
        assert (got[1] == n).any() and (got[1] < n).any()
    for i in range(N):
        if got[1][i] < n:
            assert jhost.decompress(got[0][i, :got[1][i]].tobytes(), n) == \
                S[i].tobytes()


def test_walk_and_decode_match_jax_on_host_rows(rng):
    """The plain walk (K4's function) on host-engine, own-encoder,
    corrupted and random rows: records of every row JAX accepts; the
    decoded bytes equal JAX's records placed by the Pallas expand kernel
    (interpret mode) and the host oracle."""
    n = 8192
    buf, cs, rows, nvalid = _host_rows(rng, n)
    want = jax_walk(buf, cs, n, walk_batch=jl._walk_batch,
                    maxrec=jl.max_records(n))
    got = tl.walk(torch.from_numpy(buf), torch.from_numpy(cs), n,
                  tl.max_records(n))
    ok, pok = assert_walk_matches_jax(want, got)
    assert ok[:nvalid].sum() >= nvalid // 2
    out, prod, err = tl.decode(torch.from_numpy(buf), torch.from_numpy(cs), n)
    assert np.array_equal(err.numpy(), ~pok)
    for i in range(len(rows)):
        try:
            ref = jhost.decompress(rows[i], n)
        except ValueError:
            ref = None
        if pok[i]:
            assert ref is not None and out[i].numpy().tobytes() == ref
    # JAX's records through the Pallas kernel, on a few mixed-offset rows
    mixed = np.nonzero(ok & ~want[2])[0][:4]
    assert mixed.size
    jout = np.asarray(je.expand(
        jnp.asarray(buf[mixed]), tuple(jnp.asarray(f[mixed]) for f in want[0]),
        n, interpret=True))
    assert np.array_equal(jout, out.numpy()[mixed])


@pytest.mark.parametrize("seed,n,W", streams.LZ4_CASES)
def test_walk_matches_jax_on_generated_streams(seed, n, W):
    """Zero-literal sequences, 255-runs of 8 and more bytes on both
    sides, offsets back to the row start: records equal on accepted
    rows; the error rows (an extension run cut short, offset 0, offset
    beyond the output, a stream ending on a match) err in both walks."""
    buf, cs, nvalid, nbad = streams.lz4_rows(seed, n, W)
    if n == 8192:       # share the (N_ROWS, n + 64) compile
        buf, cs = np.pad(buf, ((0, N_ROWS - len(cs)), (0, 0))), \
            np.pad(cs, (0, N_ROWS - len(cs)))
    want = jax_walk(buf, cs, n, walk_batch=jl._walk_batch,
                    maxrec=jl.max_records(n))
    got = tl.walk(torch.from_numpy(buf), torch.from_numpy(cs), n,
                  tl.max_records(n))
    ok, pok = assert_walk_matches_jax(want, got)
    assert ok[:nvalid].all()
    assert not ok[nvalid:nvalid + nbad].any()
    assert not pok[nvalid:nvalid + nbad].any()


def test_token_dense_rows_need_the_escalated_budget(rng):
    """A token-dense stream overflows the default budget in both walks
    (the shared (N_ROWS, n + 64) compile); the byte API decodes a chunk
    of it on the device through its one retry at
    structured.high_records (None would be the host engine), to the
    bytes the stream encodes."""
    n = 8192
    src = _textlike(rng, n).tobytes()
    dense = [thost.compress(src, n, 1)]
    buf, cs = pack_rows(dense, n + 64, rows=N_ROWS)
    want = jax_walk(buf, cs, n, walk_batch=jl._walk_batch,
                    maxrec=jl.max_records(n))
    got = tl.walk(torch.from_numpy(buf), torch.from_numpy(cs), n,
                  tl.max_records(n))
    ok, pok = assert_walk_matches_jax(want, got)
    assert not ok[0] and not pok[0]
    chunk = streams.one_split_chunk(dense[0], n, C.LZ4)
    assert th.decompress_chunk(chunk, None, torch.device("cpu")) == src


def test_decode_matches_jax_on_uniform_rows(rng):
    """The port's encoder's rows have one offset each, which JAX's CPU
    placement takes: (out, produced, err) equal, a csize-0 row too."""
    n = 2048
    S = stream_rows(rng, n, 8)
    sl, cs, _ = (a.numpy() for a in tl.encode(torch.from_numpy(S)))
    cs = np.where(cs >= n, 0, cs).astype(np.int32)
    want = [np.asarray(a) for a in jl.decode(jnp.asarray(sl), jnp.asarray(cs),
                                             n)]
    got = [a.numpy() for a in tl.decode(torch.from_numpy(sl),
                                        torch.from_numpy(cs), n)]
    live = want[1] == n             # the bytes of csize-0 rows are don't-care
    assert np.array_equal(want[0][live], got[0][live])
    assert np.array_equal(want[1], got[1]) and np.array_equal(want[2], got[2])
    assert (cs == 0).any() and not want[2].any()
    # geometries outside the structured decoder report err on live rows
    out, prod, err = tl.decode(torch.from_numpy(sl), torch.from_numpy(cs), 4)
    assert np.array_equal(err.numpy(), cs > 0)


def _jax_chunk(clevel, shuffle, typesize, data, code):
    ctx = jeng.build_context(clevel, shuffle, typesize, len(data),
                             len(data) + C.MAX_OVERHEAD, code)
    out = jh.compress_chunk(ctx, data)
    return jeng.compress_chunk(ctx, data) if out is None else out


@pytest.mark.parametrize("compressor", ["lz4", "lz4hc"])
@pytest.mark.parametrize("clevel", [1, 4])
def test_chunk_bytes_match_jax(compressor, clevel):
    """Device chunks (three full blocks and a leftover) byte-identical to
    the JAX package's; both packages' engines read them back."""
    data = synth(3 * 65536 + 100, 8, 19).tobytes()
    code = C.COMPCODES[compressor]
    got = tb.compress_ctx(clevel, C.SHUFFLE, 8, data, compressor=compressor,
                          device="cpu")
    assert got == _jax_chunk(clevel, C.SHUFFLE, 8, data, code)
    assert tb.decompress_ctx(got, device="cpu") == data
    assert jeng.decompress_chunk(got) == data
    assert teng.decompress_chunk(got) == data


@pytest.mark.parametrize("code,clevel", [(C.LZ4, 5), (C.LZ4, 9),
                                         (C.LZ4HC, 9)])
def test_decodes_host_engine_chunks(rng, code, clevel):
    """Host-engine chunks (one 32 KB block of four 8 KB splits, mixed
    offsets) decode on the device path, not the host fallback; the
    port's host engine writes the JAX package's bytes."""
    data = _periodic_with_noise(rng, 1 << 15)
    ctx = teng.build_context(clevel, C.SHUFFLE, 4, len(data), len(data) + 16,
                             code)
    chunk = teng.compress_chunk(ctx, data)
    assert chunk == jeng.compress_chunk(jeng.build_context(
        clevel, C.SHUFFLE, 4, len(data), len(data) + 16, code), data)
    assert th.decompress_chunk(chunk, None, torch.device("cpu")) == data
    assert tb.decompress_ctx(chunk, device="cpu") == data


def test_splits_too_wide_for_the_encoder_keys_take_the_host_engine():
    """A forced 4 MB block at typesize 32 (no split) is one 4 MB LZ4
    split, past the 2 MiB of positions the encoder's int32 sort keys
    hold: the device bridge declines it and the host engine writes the
    chunk. The data compresses about 1.5x, so the split is neither stored
    raw nor under 2 MiB; its stream decodes with the host oracle."""
    n = 4 << 20
    assert tl.fits(1 << 20) and not tl.fits(n)
    rng = np.random.default_rng(5)
    k = n // 768
    data = np.pad(np.concatenate(
        [rng.integers(0, 256, (k, 512), dtype=np.uint8),
         np.zeros((k, 256), np.uint8)], axis=1).reshape(-1),
        (0, n - 768 * k)).tobytes()
    ctx = teng.build_context(1, C.NOSHUFFLE, 32, n, n + C.MAX_OVERHEAD,
                             C.LZ4, forced_blocksize=n)
    assert ctx.blocksize == n and ctx.dont_split
    assert th.compress_chunk(ctx, data, torch.device("cpu")) is None
    with pytest.raises(ValueError):
        tp.compress_blocks(torch.zeros((1, n), dtype=torch.uint8),
                           C.NOSHUFFLE, 32, 1, compcode=C.LZ4)
    chunk = tb.compress_ctx(1, C.NOSHUFFLE, 32, data, compressor="lz4",
                            blocksize=n, device="cpu")
    offs, css = th._split_table(np.frombuffer(chunk, np.uint8),
                                read_bstarts(chunk, 1), 1)
    assert 2 << 20 < int(css[0]) < n
    assert jhost.decompress(chunk[offs[0]:offs[0] + css[0]], n) == data
    assert tb.decompress_ctx(chunk, device="cpu") == data


@pytest.mark.cuda
@pytest.mark.parametrize("seed,n,W", streams.LZ4_CARD_CASES)
def test_lz4_walk_kernel_matches_plain_on_generated_streams(seed, n, W, cuda):
    """K4 against its plain version at the default and the high budget
    (every column, the -1 tail included)."""
    buf, cs, _, _ = streams.lz4_rows(seed, n, W)
    b, c = torch.from_numpy(buf).to(cuda), torch.from_numpy(cs).to(cuda)
    for mr in (tl.max_records(n), ts.high_records(n)):
        k = tl.walk(b, c, n, mr)
        p = tl._walk_plain(b, c, n, ts.record_slots(mr))
        for x, y in zip(k[0] + k[1:], p[0] + p[1:]):
            assert torch.equal(x, y)


@pytest.mark.cuda
def test_lz4_kernel_and_byte_api_on_card(rng, cuda):
    n = 8192
    buf, cs, _, _ = _host_rows(rng, n)
    b, c = torch.from_numpy(buf).to(cuda), torch.from_numpy(cs).to(cuda)
    mr = tl.max_records(n)
    k = tl.walk(b, c, n, mr)
    p = tl._walk_plain(b, c, n, ts.record_slots(mr))
    for x, y in zip(k[0] + k[1:], p[0] + p[1:]):
        assert torch.equal(x, y)
    data = np.arange(1 << 18, dtype=np.int32).tobytes()
    for comp in ("lz4", "lz4hc"):
        ch = tb.compress_ctx(1, C.SHUFFLE, 4, data, compressor=comp,
                             device=cuda)
        assert ch == tb.compress_ctx(1, C.SHUFFLE, 4, data, compressor=comp,
                                     device="cpu")
        assert tb.decompress_ctx(ch, device=cuda) == data


# ---------------------------------------------------------------------------
# K4's block split (gpu/codec_lz4: _seq_table, _exit_tables, _block_entries,
# _emit) at small block sizes, so that rows span many blocks
# ---------------------------------------------------------------------------

EDGE_BLOCKS = (16, 64, 512)


@pytest.fixture(scope="module")
def edge_rows():
    """streams.lz4_edge_rows padded to the shared (N_ROWS, n + 64) compile,
    with the JAX walk's outputs on them at its default budget."""
    n = 8192
    buf, cs, groups = streams.lz4_edge_rows(41, n, n + 64)
    buf = np.pad(buf, ((0, N_ROWS - len(cs)), (0, 0)))
    cs = np.pad(cs, (0, N_ROWS - len(cs)))
    want = jax_walk(buf, cs, n, walk_batch=jl._walk_batch,
                    maxrec=jl.max_records(n))
    return buf, cs, groups, n, want


def _same(a, b) -> bool:
    return all(torch.equal(x, y) for x, y in zip(a[0] + a[1:], b[0] + b[1:]))


@pytest.mark.parametrize("B", EDGE_BLOCKS)
@pytest.mark.parametrize("group", streams.LZ4_EDGE_GROUPS)
def test_walk_split_matches_plain_on_block_edge_rows(edge_rows, group, B):
    """The split chained (every column, dist, uni, ok) equals _walk_plain on
    each group's rows, at the default and the escalated budget and at 96
    records, where a dense row's 97th record falls in a later block."""
    buf, cs, groups, n, _ = edge_rows
    idx = groups[group]
    b, c = torch.from_numpy(buf[idx]), torch.from_numpy(cs[idx])
    oks = []
    for E in (ts.record_slots(tl.max_records(n)),
              ts.record_slots(ts.high_records(n)), 96):
        want = tl._walk_plain(b, c, n, E)
        assert _same(tl._walk_split(b, c, n, E, B), want)
        oks.append(want[3])
    if group in ("straddle", "one_block"):
        assert oks[0].all()
    if group in ("near_end", "all_255", "late_error"):
        assert not oks[1].any()
    if group == "dense":
        assert oks[1].all() and not oks[0].any()
    if group == "one_block":
        assert int(c.max()) <= 64


@pytest.mark.parametrize("B", EDGE_BLOCKS)
def test_walk_split_matches_jax_on_block_edge_rows(edge_rows, B):
    """The split against JAX's _walk_batch on the same rows: records of
    every row JAX accepts; the error rows err in both walks, the dense
    rows overflow the default budget in both."""
    buf, cs, groups, n, want = edge_rows
    got = tl._walk_split(torch.from_numpy(buf), torch.from_numpy(cs), n,
                         ts.record_slots(tl.max_records(n)), B)
    ok, pok = assert_walk_matches_jax(want, got)
    assert ok[groups["straddle"] + groups["one_block"]].all()
    bad = groups["near_end"] + groups["all_255"] + groups["late_error"]
    assert not ok[bad].any() and not pok[bad].any()
    assert not ok[groups["dense"]].any() and not pok[groups["dense"]].any()


@pytest.mark.parametrize("seed,n,W", streams.LZ4_CASES)
def test_walk_split_matches_plain_on_generated_streams(seed, n, W):
    """Generated streams with their error rows, corruptions and random
    rows: the split equals _walk_plain at blocks of 16 positions and at
    K4's own, at the default budget and at 32 records."""
    buf, cs, _, _ = streams.lz4_rows(seed, n, W)
    b, c = torch.from_numpy(buf), torch.from_numpy(cs)
    for E in (ts.record_slots(tl.max_records(n)), 32):
        want = tl._walk_plain(b, c, n, E)
        for B in (16, tl.K4_BLOCK):
            assert _same(tl._walk_split(b, c, n, E, B), want)


def _one_sequence(row, cs: int, p: int):
    """The JAX walk's phases for the token at p, one step (eight extension
    bytes) at a time, without the op checks: (kind, litlen, ipl, offv,
    mlen, nxt) as _seq_table gives them; for an error or the end, the
    fields the table defines there."""
    lim = min(cs, len(row))

    def byte(x):
        return int(row[x]) if 0 <= x < lim else 0

    def ext(ip, first, acc):
        """(err, k255 and lastb of the last step, its ip)."""
        while True:
            e = ip + first
            w = [byte(e + i) for i in range(8)]
            k = next((i for i in range(8) if w[i] != 255), 8)
            if k < 8:
                return False, acc + 255 * k + w[k], e + k + 1
            if ip + 8 >= cs:
                return True, 0, 0
            ip, acc = e + 8, acc + 255 * 8
            first = 0

    tok = byte(p)
    if tok >> 4 == 15:
        err, litlen, ipl = ext(p, 1, 15)
        if err:
            return (tl._LIT_ERR,)
    else:
        litlen, ipl = tok >> 4, p + 1
    ip2 = ipl + litlen
    if ip2 > cs:
        return (tl._LIT_ERR,)
    if ip2 >= cs:
        return (tl._FIN, litlen, ipl)
    offv = byte(ip2) | byte(ip2 + 1) << 8
    if tok & 15 == 15:
        err, m, ip3 = ext(ip2, 2, 15)
        if err:
            return (tl._MATCH_ERR, litlen, ipl)
        mlen = 4 + m
    else:
        mlen, ip3 = 4 + (tok & 15), ip2 + 2
    if offv == 0 or ip3 > cs:
        return (tl._MATCH_ERR, litlen, ipl)
    return (tl._CONT, litlen, ipl, offv, mlen, ip3)


def test_seq_table_matches_the_step_by_step_machine(edge_rows):
    """Pass 1's closed form (255-runs from a reverse scan, the check of the
    last 8-byte step) against the JAX machine's steps at sampled positions
    of every edge row: inside long runs, at runs cut near csize, in rows
    of 255 bytes."""
    buf, cs, groups, n, _ = edge_rows
    rows = sum(groups.values(), [])
    tab = tl._seq_table(torch.from_numpy(buf[rows]),
                        torch.from_numpy(cs[rows]))
    rng = np.random.default_rng(3)
    keys = ("kind", "litlen", "ipl", "offv", "mlen", "nxt")
    for i, r in enumerate(rows):
        lim = min(int(cs[r]), buf.shape[1])
        pos = np.unique(np.concatenate([rng.integers(0, max(lim, 1), 60),
                                        np.arange(max(lim - 40, 0), lim)]))
        for p in pos.tolist():
            want = _one_sequence(buf[r], int(cs[r]), p)
            got = tuple(int(tab[k][i, p]) for k in keys[:len(want)])
            assert got == want, (r, p)


def test_exit_tables_and_entries_follow_the_chain(edge_rows):
    """Pass 1's exit tables against the successor table followed one node
    at a time, and pass 2's entries against the chain from position 0:
    every entered block is entered at the first chain position in it."""
    buf, cs, groups, n, _ = edge_rows
    B, E = 64, ts.record_slots(ts.high_records(n))
    b, c = torch.from_numpy(buf), torch.from_numpy(cs)
    tab = tl._seq_table(b, c)
    ex = tl._exit_tables(tab, c, B)
    ent, entered, term = tl._block_entries(tab, ex, c, n, E, B)
    rng = np.random.default_rng(4)
    for r in groups["straddle"] + groups["dense"] + groups["late_error"]:
        lim = min(int(cs[r]), buf.shape[1])
        for x in rng.integers(0, lim, 40).tolist():
            y, nrec, op = x, 0, 0
            bend = min((x // B + 1) * B, lim)
            while (int(tab["kind"][r, y]) == tl._CONT
                   and int(tab["nxt"][r, y]) < bend):
                nrec += 1 + (int(tab["litlen"][r, y]) > 0)
                op += int(tab["litlen"][r, y]) + int(tab["mlen"][r, y])
                y = int(tab["nxt"][r, y])
            assert (int(ex["P"][r, x]), int(ex["nrec"][r, x]),
                    int(ex["opsum"][r, x])) == (y, nrec, op)
        chain, p = [], 0
        while p < lim and int(tab["kind"][r, p]) == tl._CONT:
            chain.append(p)
            p = int(tab["nxt"][r, p])
        chain.append(p)
        for j in torch.nonzero(entered[r]).flatten().tolist():
            first = next(q for q in chain if q // B == j)
            assert int(ent["e"][r, j]) == first
        assert int(term[r]) >= int(torch.nonzero(entered[r]).max())


@pytest.mark.cuda
def test_lz4_walk_kernel_matches_plain_on_block_edge_rows(cuda):
    """K4 against _walk_plain (host) on the edge rows at the default and
    escalated budgets and at 96 records."""
    buf, cs, _ = streams.lz4_edge_rows(41)
    b, c = torch.from_numpy(buf).to(cuda), torch.from_numpy(cs).to(cuda)
    for E in (ts.record_slots(tl.max_records(8192)),
              ts.record_slots(ts.high_records(8192)), 96):
        k = tl.walk(b, c, 8192, E)
        p = tl._walk_plain(b.cpu(), c.cpu(), 8192, E)
        for x, y in zip(k[0] + k[1:], p[0] + p[1:]):
            assert torch.equal(x.cpu(), y)


@pytest.mark.cuda
def test_lz4_walk_kernel_on_the_clevel5_chunk(cuda):
    """K4 on the 4 MB synth LZ4 clevel-5 chunk's rows (numcodecs' default
    codec): two dense and two short rows equal _walk_plain (host) at both
    budgets; 32 copies of the 24 live rows in one launch equal 32 copies
    of their outputs; the byte API decodes the chunk on the card."""
    data = synth(4 << 20, 8, 19).tobytes()
    chunk = teng.compress_chunk(teng.build_context(
        5, C.SHUFFLE, 8, len(data), len(data) + 16, C.LZ4), data)
    hdr_n = 131072
    offs, css = th._split_table(np.frombuffer(chunk, np.uint8),
                                read_bstarts(chunk, 4), 8)
    live = [i for i in range(len(css)) if 0 < css[i] < hdr_n]
    buf = np.zeros((len(live), hdr_n + 64), np.uint8)
    whole = np.frombuffer(chunk, np.uint8)
    for r, i in enumerate(live):
        buf[r, :css[i]] = whole[offs[i]:offs[i] + css[i]]
    b = torch.from_numpy(buf).to(cuda)
    c = torch.from_numpy(css[live].astype(np.int32)).to(cuda)
    pick = torch.cat([torch.nonzero(c > hdr_n // 2).flatten()[:2],
                      torch.nonzero(c <= hdr_n // 2).flatten()[:2]])
    assert pick.numel() == 4
    for mr in (tl.max_records(hdr_n), ts.high_records(hdr_n)):
        E = ts.record_slots(mr)
        k = tl.walk(b[pick].contiguous(), c[pick].contiguous(), hdr_n, mr)
        p = tl._walk_plain(b[pick].cpu(), c[pick].cpu(), hdr_n, E)
        for x, y in zip(k[0] + k[1:], p[0] + p[1:]):
            assert torch.equal(x.cpu(), y)
        k1 = tl.walk(b, c, hdr_n, mr)
        k32 = tl.walk(b.repeat(32, 1), c.repeat(32), hdr_n, mr)
        for x, y in zip(k32[0] + k32[1:], k1[0] + k1[1:]):
            assert torch.equal(x, y.repeat(32, *([1] * (y.dim() - 1))))
    assert tb.decompress_ctx(chunk, device=cuda) == data
