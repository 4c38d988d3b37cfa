"""PyTorch port of the snappy decoder vs cblosc_tpu.tpu.codec_snappy: the
walk's records on every row the JAX walk accepts (K5's plain version),
K5's split (the per-position tag tables, then the chain through them)
against the plain walk and JAX, decode, and snappy chunks (written by
the host engine, as in the JAX package) decoded through the port's byte
API on the device path. All exact."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from cblosc_tpu.core import engine as jeng
from cblosc_tpu.format import constants as C
from cblosc_tpu.ops.codecs import snappy as jhost
from cblosc_tpu.tpu import codec_snappy as jsn, expand as je
import cblosc_tpu_torch as tb
from cblosc_tpu_torch.core import engine as teng
from cblosc_tpu_torch.format.header import read_bstarts
from cblosc_tpu_torch.gpu import codec_snappy as tsn, host_api as th
from cblosc_tpu_torch.gpu import pipeline as tp, structured as ts
from cblosc_tpu_torch.ops.codecs import snappy as thost
from cblosc_tpu_torch.utils import streams
from conftest import make_buffer
from test_torch_common import (assert_walk_matches_jax, corrupt, cuda,  # noqa: F401
                               jax_walk, pack_rows)

N_ROWS = 32     # the 8 KB walk tests share one JAX compile: (32, 9621)


def _datas(rng, n):
    return [np.zeros(n, np.uint8),
            np.frombuffer(make_buffer(rng, n, 4, "ramp"), np.uint8),
            np.repeat(rng.integers(0, 5, n // 32).astype(np.uint8), 32),
            np.tile(np.arange(17, dtype=np.uint8), n // 17 + 1)[:n],
            rng.integers(0, 4, n, dtype=np.uint8) * 3,
            rng.integers(0, 256, n, dtype=np.uint8)]


def test_host_codec_copy_matches_original(rng):
    """ops/codecs/snappy.py is the JAX package's host codec, byte for
    byte."""
    for d in _datas(rng, 3000):
        b = d.tobytes()
        enc = thost.compress(b, 2 * len(b) + 64)
        assert enc == jhost.compress(b, 2 * len(b) + 64)
        assert thost.decompress(enc, len(b)) == b


def test_walk_and_decode_match_jax_on_host_rows(rng):
    """The plain walk (K5's function) on host-engine streams (one wider
    than its output), corrupted and random rows: records of every row
    JAX accepts; decoded bytes equal JAX's records placed by the Pallas
    expand kernel (interpret mode) and the host oracle."""
    n = 8192
    W = tp.decode_slot_width(n, C.SNAPPY)
    valid = [thost.compress(d.tobytes(), n + n // 6 + 32)
             for d in _datas(rng, n)]
    assert len(valid[-1]) > n                # random bytes expand
    rows = valid + corrupt(rng, valid)
    rows += [rng.integers(0, 256, int(rng.integers(1, n)),
                          dtype=np.uint8).tobytes() for _ in range(4)]
    buf, cs = pack_rows(rows, W, rows=N_ROWS)
    want = jax_walk(buf, cs, n, walk_batch=jsn._walk_batch,
                    maxrec=jsn.max_records(n))
    got = tsn.walk(torch.from_numpy(buf), torch.from_numpy(cs), n,
                   tsn.max_records(n))
    ok, pok = assert_walk_matches_jax(want, got)
    assert ok[:len(valid)].all()
    out, prod, err = tsn.decode(torch.from_numpy(buf), torch.from_numpy(cs),
                                n)
    assert np.array_equal(err.numpy(), ~pok & (cs > 0))
    for i, r in enumerate(rows):
        if pok[i]:
            assert out[i].numpy().tobytes() == jhost.decompress(r, n)
    mixed = np.nonzero(ok & ~want[2])[0][:4]
    assert mixed.size
    jout = np.asarray(je.expand(
        jnp.asarray(buf[mixed]), tuple(jnp.asarray(f[mixed]) for f in want[0]),
        n, interpret=True))
    assert np.array_equal(jout, out.numpy()[mixed])


@pytest.mark.parametrize("seed,n,W", streams.SNAPPY_CASES)
def test_walk_matches_jax_on_generated_streams(seed, n, W):
    """Literals with 1-4 extra length bytes, 4-byte-offset copies, rows
    longer than their output: records equal on accepted rows; the error
    rows (bad uvarints, offset 0 or beyond the output, a set fourth
    length byte, a cut copy) err in both walks."""
    buf, cs, nvalid, nbad = streams.snappy_rows(seed, n, W)
    if n == 8192:       # share the (N_ROWS, 9621) compile
        buf, cs = np.pad(buf, ((0, N_ROWS - len(cs)), (0, 0))), \
            np.pad(cs, (0, N_ROWS - len(cs)))
    want = jax_walk(buf, cs, n, walk_batch=jsn._walk_batch,
                    maxrec=jsn.max_records(n))
    got = tsn.walk(torch.from_numpy(buf), torch.from_numpy(cs), n,
                   tsn.max_records(n))
    ok, pok = assert_walk_matches_jax(want, got)
    assert ok[:nvalid].all() and (cs[:nvalid] > n).any()
    assert not ok[nvalid:nvalid + nbad].any()
    assert not pok[nvalid:nvalid + nbad].any()


def _split_cases(seed, n, W, budget):
    """Rows and record budget of a split test: the generated rows of a
    case (the 8 KB ones padded to N_ROWS, sharing the JAX compile)."""
    buf, cs, nvalid, nbad = streams.snappy_rows(seed, n, W)
    if n == 8192:
        buf, cs = np.pad(buf, ((0, N_ROWS - len(cs)), (0, 0))), \
            np.pad(cs, (0, N_ROWS - len(cs)))
    mr = tsn.max_records(n) if budget == "default" else ts.high_records(n)
    return buf, cs, nvalid, nbad, mr


def _assert_split(buf, cs, n, mr, jax=True):
    """K5's split against the plain walk on every column, and against the
    JAX walk on every row it accepts (at the default budget). Returns the
    split's ok mask."""
    b, c = torch.from_numpy(buf), torch.from_numpy(cs)
    E = ts.record_slots(mr)
    got = tsn._walk_split(b, c, n, E)
    plain = tsn._walk_plain(b, c, n, E)
    for x, y in zip(got[0] + got[1:], plain[0] + plain[1:]):
        assert torch.equal(x, y)
    if jax:
        want = jax_walk(buf, cs, n, walk_batch=jsn._walk_batch, maxrec=mr)
        assert_walk_matches_jax(want, got)
    return got[3].numpy()


@pytest.mark.parametrize("budget", ["default", "high"])
@pytest.mark.parametrize("seed,n,W", streams.SNAPPY_CASES)
def test_split_matches_plain_and_jax(seed, n, W, budget):
    """K5's split (_tag_tables, then _walk_split's chain through them)
    equals the plain walk on every column of the generated rows (valid,
    error, corrupt and random) at the default and the escalated budget,
    and JAX's walk on every row JAX accepts at the default budget."""
    buf, cs, nvalid, nbad, mr = _split_cases(seed, n, W, budget)
    ok = _assert_split(buf, cs, n, mr, jax=budget == "default")
    assert ok[:nvalid].all() and not ok[nvalid:nvalid + nbad].any()


def test_tag_tables_evaluate_every_position():
    """_tag_tables at the positions the walk reaches: every delta at least
    2, literals with 1-4 length bytes, copies of all three types, and the
    tag-only errors (a set fourth length byte, offset 0) flagged."""
    buf, cs, nvalid, _ = streams.snappy_rows(32, 8192, 9621)
    delta, ln, arg, copy, perr = tsn._tag_tables(torch.from_numpy(buf),
                                                 torch.from_numpy(cs))
    assert (delta >= 2).all()
    tag = torch.from_numpy(buf).to(torch.int64)
    lit = (tag & 3) == 0
    assert torch.equal(copy, ~lit)
    for extra in range(1, 5):
        sel = lit & ((tag >> 2) == 59 + extra)
        assert sel.any()
        assert torch.equal((delta - 1 - extra - ln)[sel],
                           torch.zeros_like(ln[sel]))
    assert perr.any() and not perr.all()


@pytest.mark.parametrize("budget", ["default", "high"])
def test_split_matches_plain_and_jax_on_long_literals(budget):
    """Literals with a 4-byte length and literals longer than the kernel's
    128-position window, and a corruption of each: the split equals the
    plain walk, and JAX's walk where it accepts; the valid rows decode to
    the host codec's bytes."""
    n, W = 8192, 9621
    buf, cs, nvalid = streams.snappy_long_literal_rows(34, n, W)
    lens = []
    for i in range(nvalid):
        d, _ = tsn._tag_tables(torch.from_numpy(buf[i:i + 1]),
                               torch.from_numpy(cs[i:i + 1]))[:2]
        lens.append(int(d.max()))
    assert min(lens) > 128
    k = len(cs)
    buf = np.pad(buf, ((0, N_ROWS - k), (0, 0)))
    cs = np.pad(cs, (0, N_ROWS - k))
    mr = tsn.max_records(n) if budget == "default" else ts.high_records(n)
    ok = _assert_split(buf, cs, n, mr, jax=budget == "default")
    assert ok[:nvalid].all()
    out, _, err = tsn.decode(torch.from_numpy(buf[:nvalid]),
                             torch.from_numpy(cs[:nvalid]), n)
    assert not err.any()
    for i in range(nvalid):
        assert out[i].numpy().tobytes() == thost.decompress(
            bytes(buf[i, :cs[i]]), n)


def test_decode_matches_jax_on_uniform_rows(rng):
    """Rows with one copy offset (or none), which JAX's CPU placement
    takes: (out, produced, err) equal; a mixed row errs in JAX and
    decodes in the port."""
    n = 2048
    datas = _datas(rng, n)
    rows = [thost.compress(d.tobytes(), n + n // 6 + 32) for d in datas]
    buf, cs = pack_rows(rows, tp.decode_slot_width(n, C.SNAPPY))
    want = [np.asarray(a) for a in jsn.decode(jnp.asarray(buf),
                                              jnp.asarray(cs), n)]
    got = [a.numpy() for a in tsn.decode(torch.from_numpy(buf),
                                         torch.from_numpy(cs), n)]
    h = ~want[2]
    assert h.sum() >= 3 and want[2].any() and not got[2].any()
    assert np.array_equal(want[0][h], got[0][h])
    assert np.array_equal(want[1][h], got[1][h])
    assert np.array_equal(got[0], np.stack(datas))


def test_snappy_chunks_decode_on_the_device_path(rng):
    """compress_ctx(compressor="snappy") writes the JAX package's chunk
    (the host engine's, in both packages); it decodes through the device
    path (host_api returns it), a split wider than neblock included; a
    token-dense chunk needs the escalated-budget retry."""
    n = 8192
    # one 16 KB block of eight 2 KB splits: four periodic, four random
    # (their streams are longer than the split)
    data = np.concatenate([np.tile(rng.integers(0, 40, 97).astype(np.uint8),
                                   n // 97 + 1)[:n],
                           rng.integers(0, 256, n, dtype=np.uint8)]).tobytes()
    got = tb.compress_ctx(4, C.NOSHUFFLE, 8, data, compressor="snappy",
                          device="cpu")
    ctx = jeng.build_context(4, C.NOSHUFFLE, 8, len(data),
                             len(data) + C.MAX_OVERHEAD, C.SNAPPY)
    assert got == jeng.compress_chunk(ctx, data)
    _, css = th._split_table(np.frombuffer(got, np.uint8),
                             read_bstarts(got, 1), 8)
    assert (css > 2048).any()
    assert th.decompress_chunk(got, None, torch.device("cpu")) == data
    # token-dense: a one-byte literal and a 4-byte copy per 5 bytes
    n = 4096
    stream, dense = streams.snappy_dense(rng, n)
    chunk = streams.one_split_chunk(stream, n, C.SNAPPY)
    assert jeng.decompress_chunk(chunk) == dense
    assert teng.decompress_chunk(chunk) == dense
    buf, cs = pack_rows([stream], tp.decode_slot_width(n, C.SNAPPY))
    _, _, _, ok = tsn.walk(torch.from_numpy(buf), torch.from_numpy(cs), n,
                           tsn.max_records(n))
    _, _, _, okh = tsn.walk(torch.from_numpy(buf), torch.from_numpy(cs), n,
                            ts.high_records(n))
    assert not bool(ok[0]) and bool(okh[0])
    assert th.decompress_chunk(chunk, None, torch.device("cpu")) == dense


@pytest.mark.cuda
@pytest.mark.parametrize("seed,n,W", streams.SNAPPY_CARD_CASES)
def test_snappy_walk_kernel_matches_plain_on_generated_streams(seed, n, W,
                                                               cuda):
    """K5 against its plain version at the default and the high budget
    (every column, the -1 tail included), on the generated rows and on
    rows of long literals (4-byte lengths, longer than a window)."""
    buf, cs, _, _ = streams.snappy_rows(seed, n, W)
    lbuf, lcs, _ = streams.snappy_long_literal_rows(seed + 10, n, W)
    buf, cs = np.concatenate([buf, lbuf]), np.concatenate([cs, lcs])
    b, c = torch.from_numpy(buf).to(cuda), torch.from_numpy(cs).to(cuda)
    for mr in (tsn.max_records(n), ts.high_records(n)):
        k = tsn.walk(b, c, n, mr)
        p = tsn._walk_plain(b, c, n, ts.record_slots(mr))
        for x, y in zip(k[0] + k[1:], p[0] + p[1:]):
            assert torch.equal(x, y)


@pytest.mark.cuda
def test_snappy_byte_api_on_card(rng, cuda):
    data = np.frombuffer(make_buffer(rng, 1 << 16, 4, "ramp"),
                         np.uint8).tobytes()
    ch = tb.compress_ctx(1, C.SHUFFLE, 4, data, compressor="snappy",
                         device=cuda)
    assert th.decompress_chunk(ch, None, cuda) == data
