"""PyTorch port of the zstd decoder vs cblosc_tpu.tpu.codec_zstd: the
table builders, the frame walk (K7's plain version) on one batch of
generated frames — tape, records and ok on every row the JAX machine
accepts, the replay against libzstd on rows only the port accepts, err
on every corruption in both — K7's split (the decoder's sequence stream,
then the flush) against the plain walk and JAX, then decode, and zstd
chunks (written by the host engine, as in the JAX package) through the
port's byte API. The JAX side compiles three times (the walk at the
default budget, decode at the escalated one, the two table builders),
each once and shared by every case (the walk's compile through
_JAX_WALK, also for the split's rows, packed to the batch's shape). All
exact."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from cblosc_tpu.core import engine as jeng
from cblosc_tpu.format import constants as C
from cblosc_tpu.ops.codecs import zstd_ as jhost, zstd_ref as jref
from cblosc_tpu.tpu import codec_zstd as jz, expand as je, pipeline as jp
import cblosc_tpu_torch as tb
from cblosc_tpu_torch.format.header import ChunkHeader
from cblosc_tpu_torch.core import engine as teng
from cblosc_tpu_torch.gpu import codec_zstd as tz, expand as te
from cblosc_tpu_torch.gpu import host_api as th, pipeline as tp
from cblosc_tpu_torch.ops.codecs import zstd_ as thost, zstd_ref as tref
from cblosc_tpu_torch.utils import streams
from conftest import make_buffer
from test_torch_common import cuda  # noqa: F401

pytestmark = pytest.mark.skipif(not jhost.AVAILABLE, reason="libzstd absent")

SEED, N_OUT, WIDTH = streams.ZSTD_CASES[0]
_PAD = jz._FWD + jz._WIN    # the JAX decoder pads its rows for its windows
VALID = streams.ZSTD_VALID + ("dense",)


def _np(walk):
    """A walk's outputs (JAX's or the port's, any device) as numpy."""
    def a(t):
        return t.cpu().numpy() if torch.is_tensor(t) else np.asarray(t)

    tape, tlen, rf, ok = walk
    return a(tape), a(tlen), tuple(a(f) for f in rf), a(ok)


def _jax_walk(sl, cs, n, maxev):
    ef, ok = jz._fsm_walk(sl, cs, n, maxev)
    tape, rf, ok = jz._events_to_records(ef, ok, n)
    return tape, je.compact_records(rf), ok


_JAX_WALK = jax.jit(_jax_walk, static_argnums=(2, 3))


def _run_jax_walk(buf, cs):
    """The JAX machine at the default budget, as numpy (tape, records,
    ok); rows padded for its windows."""
    tape, rf, ok = _JAX_WALK(jnp.asarray(np.pad(buf, ((0, 0), (0, _PAD)))),
                             jnp.asarray(cs), N_OUT, jz.default_events(N_OUT))
    return np.asarray(tape), tuple(np.asarray(f) for f in rf), np.asarray(ok)


@pytest.fixture(scope="module")
def batch():
    return streams.zstd_rows(SEED, N_OUT, WIDTH, garbage=8)


@pytest.fixture(scope="module")
def jax_walk(batch):
    """The JAX machine on the whole batch at the default budget, once:
    (tape, records, ok) as numpy."""
    buf, cs, _ = batch
    return _run_jax_walk(buf, cs)


@pytest.fixture(scope="module")
def port_walk(batch):
    buf, cs, _ = batch
    return _np(tz.fsm_walk(torch.from_numpy(buf), torch.from_numpy(cs), N_OUT,
                           tz.default_events(N_OUT)))


@pytest.fixture(scope="module")
def jax_decode(batch):
    """JAX decode of the whole batch at the escalated budget, once."""
    buf, cs, _ = batch
    out, prod, err = jz.decode(jnp.asarray(buf), jnp.asarray(cs), N_OUT,
                               jz.high_events(N_OUT))
    return np.asarray(out), np.asarray(prod), np.asarray(err)


@pytest.fixture(scope="module")
def tables():
    """Random normalized counts (valid and invalid) and Huffman weights,
    with the JAX builders' tables of them, computed in one compile."""
    rng = np.random.default_rng(SEED)
    R = 48
    counts = np.zeros((R, jz._NC_CAP), np.int32)
    logs = np.zeros(R, np.int32)
    for i in range(R):
        acc = int(rng.integers(5, 10))
        nsym = int(rng.integers(1, 64))
        c = np.where(rng.random(nsym) < 0.15, -1, 0)
        rem = (1 << acc) - int((c == -1).sum())
        idx = np.nonzero(c == 0)[0]
        if idx.size and rem > 0:
            c[idx] = rng.multinomial(rem, rng.dirichlet(np.ones(idx.size)))
        if i % 4 == 3:                  # a count sum off by one: err
            c[int(rng.integers(0, nsym))] += 1
        counts[i, :nsym] = c
        logs[i] = acc
    weights = np.zeros((R, 256), np.int32)
    nw = np.zeros(R, np.int32)
    for i in range(R):
        n = int(rng.integers(1, 256))
        if i % 3 == 0:                  # a complete set: weights of a code
            k = int(rng.integers(2, 12))
            lens = np.full(n + 1, 0)
            left = 1 << k
            for s in range(n + 1):
                if left <= 0:
                    break
                w = int(rng.integers(1, k + 1))
                while (1 << (w - 1)) > left:
                    w -= 1
                lens[s] = w
                left -= 1 << (w - 1)
            nw[i] = max(int(np.nonzero(lens)[0].max()), 1)
            weights[i, :nw[i]] = lens[:nw[i]]
        else:
            nw[i] = n
            weights[i, :n] = rng.integers(0, 13, n)

    def both(c, lg, w, n):
        return jz._fse_build(c, lg), jz._huf_build(w, n)

    fse, huf = jax.jit(both)(*(jnp.asarray(a) for a in (counts, logs, weights,
                                                        nw)))
    return (counts, logs, tuple(np.asarray(a) for a in fse), weights, nw,
            tuple(np.asarray(a) for a in huf))


def replay(walk, buf, i: int) -> bytes:
    """Row i's output: its records placed over [tape | stream] (the plain
    expand, the function of K1)."""
    tape, _, rf, _ = walk
    src = torch.from_numpy(np.concatenate([tape[i:i + 1], buf[i:i + 1]], 1))
    return te._expand_plain(src, tuple(torch.from_numpy(f[i:i + 1])
                                       for f in rf), N_OUT).numpy().tobytes()


def test_host_codec_copy_matches_original(rng):
    """ops/codecs/zstd_.py is the JAX package's host codec (one library,
    one level mapping)."""
    assert thost.AVAILABLE and thost.LIBRARY_VERSION == jhost.LIBRARY_VERSION
    for kind in ("zeros", "ramp", "lowentropy", "random"):
        b = make_buffer(rng, 5000, 4, kind)
        for clevel in (1, 5, 8, 9):
            enc = thost.compress(b, 2 * len(b), clevel)
            assert enc == jhost.compress(b, 2 * len(b), clevel)
            assert thost.decompress(enc, len(b)) == b
        assert thost.compress(b, 4, 5) == jhost.compress(b, 4, 5) == b""
    with pytest.raises(ValueError):
        thost.decompress(b"\x00" * 16, 100)


def test_ref_copy_matches_original(batch):
    """ops/codecs/zstd_ref.py is the JAX package's readable decoder: the
    same tables, and the same bytes or the same refusal on every row."""
    for name in ("LL_BITS", "LL_BASE", "ML_BITS", "ML_BASE", "_LL_DEFAULT",
                 "_ML_DEFAULT", "_OF_DEFAULT"):
        assert getattr(tref, name) == getattr(jref, name)
    for which in ("ll", "of", "ml"):
        for a, b in zip(tz._PRE[which], jz._PRE[which]):
            assert np.array_equal(a, b)
    buf, cs, kinds = batch
    for i in range(len(kinds)):
        fr = bytes(buf[i, :cs[i]])
        if kinds[i] == "garbage":
            # the original reads some of these forever (blocks past the
            # frame's end); the copy refuses every one
            with pytest.raises((ValueError, IndexError)):
                tref.decompress(fr, N_OUT)
            continue
        try:
            want = jref.decompress(fr, N_OUT)
        except (ValueError, IndexError) as e:
            with pytest.raises(type(e)):
                tref.decompress(fr, N_OUT)
        else:
            assert tref.decompress(fr, N_OUT) == want


def test_budgets_and_widths_match_jax():
    for n in (1024, 8192, 262144):
        assert tz.default_events(n) == jz.default_events(n)
        assert tz.high_events(n) == jz.high_events(n)
        maxev = jz.default_events(n)
        assert tz.event_slots(maxev) == -(-maxev // (jz._NLANES * jz._KCH)) * (
            jz._NLANES * jz._KCH)
        assert tz.record_cap(n) == -(-(n // 2 + 1024) // 32) * 32
        assert tp.decode_slot_width(n, C.ZSTD) == jp.decode_slot_width(n, C.ZSTD)
    assert (tz._KCH, tz._NLANES, tz._FSE_PAD, tz._NC_CAP, tz._MAXSYM,
            tz._MAXLOG) == (jz._KCH, jz._NLANES, jz._FSE_PAD, jz._NC_CAP,
                            jz._MAXSYM, jz._MAXLOG)


def test_fse_build_matches_jax(tables):
    """Every cell (symbol, bits, baseline) and the err flag, on valid
    counts and on count sums that miss the table size."""
    counts, logs, want = tables[:3]
    got = tz._fse_build(torch.from_numpy(counts), torch.from_numpy(logs))
    for w, g in zip(want, got):
        assert np.array_equal(w, g.numpy())
    assert want[3].any() and not want[3].all()


def test_huf_build_matches_jax(tables):
    """K, the per-weight tables, the symbol order and err, on complete
    weight sets and on random ones (most err); then every code of the
    complete sets decodes alike through _huf_decode."""
    weights, nw, want = tables[3:]
    got = tz._huf_build(torch.from_numpy(weights), torch.from_numpy(nw))
    for w, g in zip(want, got):
        assert np.array_equal(w, g.numpy())
    assert (~want[5]).sum() >= 8 and want[5].sum() >= 8
    peeks = np.random.default_rng(SEED).integers(0, 2048, weights.shape[0])
    js, jn = jz._huf_decode(jnp.asarray(peeks), *(jnp.asarray(a)
                                                  for a in want[:5]))
    ps, pn = tz._huf_decode(torch.from_numpy(peeks), *got[:5])
    assert np.array_equal(np.asarray(js), ps.numpy())
    assert np.array_equal(np.asarray(jn), pn.numpy())


def test_generated_frames_cover_the_format(batch):
    """The valid rows hold every frame feature the walk has a mode for."""
    buf, cs, kinds = batch
    seen = set()
    for i, k in enumerate(kinds):
        if k in VALID:
            seen |= streams.zstd_features(bytes(buf[i, :cs[i]]))
    assert seen >= {"raw_block", "rle_block", "cmp_block", "raw_lits",
                    "rle_lits", "huf_1s", "huf_4s", "treeless", "w_direct",
                    "w_fse", "seq_predef", "seq_rle", "seq_fse",
                    "seq_repeat", "multi_block", "checksum",
                    "zero_run_flags_9"}


@pytest.mark.parametrize("kind", streams.ZSTD_KINDS)
def test_walk_matches_jax(kind, batch, jax_walk, port_walk):
    """Rows JAX accepts at the default budget: the port accepts them with
    the same tape[:tlen] and the same records in order. Rows only the
    port accepts (JAX spends 18 event slots a loop iteration) replay to
    libzstd's bytes. Every corruption errs in both."""
    buf, cs, kinds = batch
    i = kinds.index(kind)
    jtape, jrf, jok = jax_walk
    ptape, ptlen, prf, pok = port_walk
    if jok[i]:
        assert pok[i]
        assert np.array_equal(jtape[i, :ptlen[i]], ptape[i, :ptlen[i]])
        nrec = int((jrf[0][i] >= 0).sum())
        assert nrec == int((prf[0][i] >= 0).sum())
        for w, g in zip(jrf, prf):
            assert np.array_equal(w[i, :nrec], g[i, :nrec])
    if kind in VALID:
        assert pok[i]
        assert replay(port_walk, buf, i) == thost.decompress(
            bytes(buf[i, :cs[i]]), N_OUT)
    else:
        assert not jok[i] and not pok[i]
    if kind in ("dense", "shuffled"):
        # over JAX's slot count, and a zero run of more than 8 repeat
        # flags, which JAX rejects: the port takes both
        assert not jok[i]


def test_flips_and_garbage_match_jax(batch, jax_walk, port_walk):
    """One-byte flips of every valid row and random rows: every row JAX
    accepts, the port accepts with the same tape and records."""
    buf, cs, kinds = batch
    jtape, jrf, jok = jax_walk
    ptape, ptlen, prf, pok = port_walk
    rows = [i for i, k in enumerate(kinds) if k in ("flip", "garbage")]
    assert len(rows) == len(VALID) + 8
    for i in rows:
        assert pok[i] or not jok[i]
        if jok[i]:
            assert np.array_equal(jtape[i, :ptlen[i]], ptape[i, :ptlen[i]])
            nrec = int((jrf[0][i] >= 0).sum())
            for w, g in zip(jrf, prf):
                assert np.array_equal(w[i, :nrec], g[i, :nrec])
    assert not pok[[i for i in rows if kinds[i] == "garbage"]].any()


def test_records_are_compacted_and_err_rows_empty(batch, port_walk):
    """The port's records: valid first, kind -1 and zeros after, the tape
    zero past tlen; a row that errs has no records, tlen 0 and a zero
    tape."""
    _, _, kinds = batch
    tape, tlen, rf, ok = port_walk
    for i in range(len(kinds)):
        nrec = int((rf[0][i] >= 0).sum())
        assert (rf[0][i, :nrec] >= 0).all() and (rf[0][i, nrec:] == -1).all()
        assert all((f[i, nrec:] == 0).all() for f in rf[1:])
        assert (tape[i, tlen[i]:] == 0).all()
        if not ok[i]:
            assert nrec == 0 and tlen[i] == 0
    assert ok.sum() >= len(VALID) and (~ok).sum() >= len(streams.ZSTD_BAD)


def _assert_split_equals(split, plain, jax_walk=None, rows=None):
    """K7's split against the plain walk on every column of every row,
    and, where given, against the JAX machine on the rows (indices into
    its batch) it accepts: tape[:tlen] and the records in order."""
    for x, y in zip(_np(split[:4])[:2] + _np(split[:4])[2] + (_np(split[:4])[3],),
                    _np(plain)[:2] + _np(plain)[2] + (_np(plain)[3],)):
        assert np.array_equal(x, y)
    if jax_walk is None:
        return
    jtape, jrf, jok = jax_walk
    tape, tlen, rf, ok = _np(split[:4])
    for i, j in enumerate(rows):
        if not jok[j]:
            continue
        assert ok[i]
        assert np.array_equal(jtape[j, :tlen[i]], tape[i, :tlen[i]])
        nrec = int((jrf[0][j] >= 0).sum())
        assert nrec == int((rf[0][i] >= 0).sum())
        for w, g in zip(jrf, rf):
            assert np.array_equal(w[j, :nrec], g[i, :nrec])


@pytest.mark.parametrize("budget", ["default", "high"])
def test_split_matches_plain_and_jax(budget, batch, jax_walk, port_walk):
    """K7's split — the decoder's (ofv, ll, ml) stream with its stop, then
    the flush's repeat offsets, checks and records (_fsm_walk_split) —
    equals the plain walk on every column of every generated row (valid,
    dense, corrupt, flipped, garbage) at the default and the escalated
    budget, and JAX's machine on every row JAX accepts at the default
    budget; its sequence counts are those of the records."""
    buf, cs, kinds = batch
    b, c = torch.from_numpy(buf), torch.from_numpy(cs)
    maxev = (tz.default_events(N_OUT) if budget == "default"
             else tz.high_events(N_OUT))
    E = tz.event_slots(maxev)
    split = tz._fsm_walk_split(b, c, N_OUT, E)
    if budget == "default":
        _assert_split_equals(split, port_walk, jax_walk, range(len(kinds)))
    else:
        _assert_split_equals(split, tz._fsm_walk_plain(b, c, N_OUT, E))
    ok, nseq, rf = split[3].numpy(), split[4].numpy(), split[2]
    assert ok.sum() >= len(VALID)
    # every sequence emits one match record (matches are 3 bytes or more)
    for i in np.nonzero(ok)[0]:
        assert nseq[i] <= int((rf[0][i] == 1).sum())
    assert nseq[ok].max() >= 256        # more than one flush of the kernel


@pytest.fixture(scope="module")
def ring_batch():
    return streams.zstd_ring_rows(54, N_OUT, WIDTH)


def test_ring_rows_reach_the_kernels_branches(ring_batch):
    """The split's extra rows: a sequence bitstream longer than the
    kernel's ring, and one frame of many blocks with repeated sequence
    tables and treeless literals."""
    buf, cs, kinds = ring_batch
    assert kinds[:2] == streams.ZSTD_RING_KINDS
    f = [streams.zstd_features(bytes(buf[i, :cs[i]])) for i in range(2)]
    assert "seq_stream_2k" in f[0]
    assert f[1] >= {"multi_block", "seq_repeat", "treeless", "huf_4s"}


@pytest.mark.parametrize("budget", ["default", "high"])
def test_split_matches_plain_and_jax_on_ring_rows(budget, batch, ring_batch):
    """K7's split on the ring rows and their flips: equal to the plain
    walk on every column; the valid rows replay to libzstd's bytes; at the
    default budget equal to JAX's machine where it accepts (the rows packed
    into the batch's shape, so its compile is shared)."""
    rbuf, rcs, rkinds = ring_batch
    b, c = torch.from_numpy(rbuf), torch.from_numpy(rcs)
    maxev = (tz.default_events(N_OUT) if budget == "default"
             else tz.high_events(N_OUT))
    E = tz.event_slots(maxev)
    split = tz._fsm_walk_split(b, c, N_OUT, E)
    plain = tz._fsm_walk_plain(b, c, N_OUT, E)
    jw = None
    if budget == "default":
        jb, jc = batch[0].copy(), batch[1].copy()
        jb[:len(rkinds)], jc[:len(rkinds)] = rbuf, rcs
        jw = _run_jax_walk(jb, jc)
    _assert_split_equals(split, plain, jw, range(len(rkinds)))
    walk = _np(split[:4])
    for i, kind in enumerate(rkinds):
        if kind != "flip":
            assert walk[3][i]
            assert replay(walk, rbuf, i) == thost.decompress(
                bytes(rbuf[i, :rcs[i]]), N_OUT)
    assert split[4][0] > 256


def test_decode_matches_jax(batch, jax_decode):
    """decode at the escalated budget against JAX decode (its CPU leg,
    the Pallas expand in interpret mode): every row JAX decodes, flips
    and garbage included, the port decodes to the same bytes; the rows
    only the port decodes are the zero-run frame (and a flip of it),
    which decode to the readable decoder's bytes; a csize-0 row and a
    geometry below 8 bytes err."""
    buf, cs, kinds = batch
    jout, jprod, jerr = jax_decode
    out, prod, err = (a.numpy() for a in tz.decode(
        torch.from_numpy(buf), torch.from_numpy(cs), N_OUT,
        tz.high_events(N_OUT)))
    assert not (err & ~jerr).any()
    assert np.array_equal(out[~jerr], jout[~jerr])
    assert np.array_equal(prod[~jerr], jprod[~jerr])
    only = np.nonzero(~err & jerr)[0]
    assert "shuffled" in [kinds[i] for i in only]
    for i in only:
        assert kinds[i] in ("shuffled", "flip")
        assert out[i].tobytes() == tref.decompress(bytes(buf[i, :cs[i]]), N_OUT)
    assert not out[err].any() and not prod[err].any()
    assert np.array_equal(~err[:len(VALID)], np.ones(len(VALID), bool))
    z = np.zeros((1, WIDTH), np.uint8)
    _, _, e0 = tz.decode(torch.from_numpy(z), torch.zeros(1, dtype=torch.int32),
                         N_OUT)
    assert e0.all()
    _, prod7, e7 = tz.decode(torch.from_numpy(buf), torch.from_numpy(cs), 7)
    assert np.array_equal(e7.numpy(), cs > 0) and not prod7.any()


_LEFTOVER = np.arange(25_000, dtype=np.int32).tobytes() + b"\x07\x01\x02"


@pytest.mark.parametrize("clevel", [1, 5, 9])
@pytest.mark.parametrize("typesize", [4, 8])
def test_chunk_bytes_match_jax_engine_and_decode(clevel, typesize):
    """compress_ctx(compressor="zstd") writes the JAX host engine's chunk
    byte for byte (full blocks and a leftover block); decompress_ctx
    decodes it through the device path on the CPU, and the JAX engine
    decodes the port's chunk."""
    data, ts = _LEFTOVER, typesize
    chunk = tb.compress_ctx(clevel, C.SHUFFLE, ts, data, compressor="zstd",
                            device="cpu")
    ctx = jeng.build_context(clevel, C.SHUFFLE, ts, len(data),
                             len(data) + C.MAX_OVERHEAD, C.ZSTD)
    assert chunk == jeng.compress_chunk(ctx, data)
    assert th.decompress_chunk(chunk, None, torch.device("cpu")) == data
    assert tb.decompress_ctx(chunk, device="cpu") == data
    assert jeng.decompress_chunk(chunk) == data
    assert teng.decompress_chunk(chunk) == data


def test_literal_dense_frame_and_the_escalated_retry(monkeypatch):
    """A literal-dense frame (one Huffman literal per output byte) is over
    the JAX machine's default budget (its slot count) but within the
    port's, which counts events; below its event count the walk errs,
    and the byte API's one escalated retry (high_events) decodes the
    chunk on the device."""
    rng = np.random.default_rng(SEED)
    data = rng.integers(0, 16, 2 * N_OUT, dtype=np.uint8).tobytes()
    frame = thost.frame(data[:N_OUT], 3)
    buf, cs = streams._pack([(frame, len(frame))], WIDTH)
    b, c = torch.from_numpy(buf), torch.from_numpy(cs)
    tape, tlen, rf, ok = tz.fsm_walk(b, c, N_OUT, tz.default_events(N_OUT))
    assert ok[0] and tlen[0] > N_OUT // 2
    events = int(tlen[0]) + int((rf[0] >= 0).sum())
    assert not tz.fsm_walk(b, c, N_OUT, events - 72)[3][0]
    assert tz.fsm_walk(b, c, N_OUT, events)[3][0]
    chunk = teng.compress_chunk(teng.build_context(
        5, C.NOSHUFFLE, 1, len(data), len(data) + 16, C.ZSTD), data)
    neblock = ChunkHeader.decode(chunk).blocksize
    budgets = []
    real = tz.fsm_walk

    def walk(sl, cs_, n, maxev):
        """The walk with its default budget cut below the frame's events."""
        budgets.append(maxev)
        return real(sl, cs_, n, 72 if maxev == tz.default_events(n) else maxev)

    monkeypatch.setattr(tz, "fsm_walk", walk)
    assert th.decompress_chunk(chunk, None, torch.device("cpu")) == data
    assert budgets == [tz.default_events(neblock), tz.high_events(neblock)]


def test_blocks_above_decode_cap_take_the_host_engine():
    """clevel 9 writes 1 MB zstd blocks, above decode_cap (512 KB): the
    device path declines the chunk (every live row errs, also at the
    escalated budget) and the byte API decodes it on the host engine, as
    in the JAX package."""
    data = np.arange(1 << 19, dtype=np.int32).tobytes()
    chunk = tb.compress_ctx(9, C.SHUFFLE, 4, data, compressor="zstd",
                            device="cpu")
    assert teng.decompress_chunk(chunk) == data
    assert th.decompress_chunk(chunk, None, torch.device("cpu")) is None
    assert tb.decompress_ctx(chunk, device="cpu") == data


@pytest.mark.cuda
def test_kernel_matches_plain_on_generated_frames(cuda):
    """K7 against its plain version on the generated rows and the ring
    rows (a sequence bitstream longer than the kernel's ring, a frame of
    many blocks with repeated tables and treeless literals, their flips)
    of the card cases up to 32 KB at the default budget (tape, tlen,
    records, ok, tolerance 0; the plain loop takes a literal a step, too
    slow for the 128 KB rows), its stats (sequences a row) against the
    split's on the 8 KB rows it accepts, and K7 + K1 against libzstd on
    every valid row of every card case."""
    for seed, n, width in streams.ZSTD_CARD_CASES:
        buf, cs, kinds = streams.zstd_rows(seed, n, width, garbage=8)
        rbuf, rcs, rkinds = streams.zstd_ring_rows(seed + 10, n, width)
        buf, cs = np.concatenate([buf, rbuf]), np.concatenate([cs, rcs])
        kinds = kinds + rkinds
        b, c = torch.from_numpy(buf), torch.from_numpy(cs)
        if n <= 32768:
            seqs = torch.empty(b.shape[0], dtype=torch.int32, device=cuda)
            k = _np(tz.fsm_walk(b.to(cuda), c.to(cuda), n,
                                tz.default_events(n), seqs))
            p = _np(tz.fsm_walk(b, c, n, tz.default_events(n)))
            for u, v in zip((*k[:2], *k[2], k[3]), (*p[:2], *p[2], p[3])):
                assert np.array_equal(u, v)
            if n == N_OUT:
                split = tz._fsm_walk_split(b, c, n, tz.event_slots(
                    tz.default_events(n)))
                ok = k[3]
                assert np.array_equal(seqs.cpu().numpy()[ok],
                                      split[4].numpy()[ok])
        out, _, err = tz.decode(b.to(cuda), c.to(cuda), n)
        out, err = out.cpu().numpy(), err.cpu().numpy()
        for i, kind in enumerate(kinds):
            if kind in VALID or kind in streams.ZSTD_RING_KINDS:
                assert not err[i]
                assert out[i].tobytes() == thost.decompress(
                    bytes(buf[i, :cs[i]]), n)
            elif kind in streams.ZSTD_BAD:
                assert err[i]
