"""PyTorch port of the snappy decoder vs cblosc_tpu.tpu.codec_snappy: the
walk's records on every row the JAX walk accepts (K5's plain version),
decode, and snappy chunks (written by the host engine, as in the JAX
package) decoded through the port's byte API on the device path. All
exact."""

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
    (every column, the -1 tail included)."""
    buf, cs, _, _ = streams.snappy_rows(seed, n, W)
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
