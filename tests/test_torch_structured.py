"""PyTorch port of the structured decoder vs cblosc_tpu.tpu.structured:
the walk's compacted records, the template and pure-tile paths, and
decode's (out, produced, err), all exact."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from cblosc_tpu.tpu import codec as jc, structured as js
from cblosc_tpu_torch.gpu import structured as ts
from cblosc_tpu_torch.utils import streams
from test_torch_common import corrupt, cuda, host_streams, jax_walk, pack_rows, stream_rows  # noqa: F401


def _inputs(rng, n):
    """Our encoder's streams, host-encoder streams and corrupted copies,
    packed as the pipeline gathers them (zero past csize)."""
    S = stream_rows(rng, n, 14)
    slots, cs, _ = jc.encode(jnp.asarray(S), jc.DISTANCES, 0, False)
    ours = [np.asarray(slots[i, :int(cs[i])]).tobytes() for i in range(14)
            if int(cs[i]) < n]
    streams = ours + host_streams(rng, n)
    streams += corrupt(rng, streams[-6:])
    return pack_rows(streams, n + 64, rows=_ROWS)


_ROWS = 40      # every JAX call here sees (_ROWS, n + 64): one compile each


def test_walk_matches_jax_on_accepted_rows(rng):
    n = 2048
    buf, cs = _inputs(rng, n)
    want, dist, uni, ok = jax_walk(buf, cs, n)
    rf, pdist, puni, pok = ts.walk(torch.from_numpy(buf),
                                   torch.from_numpy(cs), n, ts.max_records(n))
    pok = pok.numpy()
    assert ok.sum() >= 8
    assert pok[ok].all()                     # the port accepts a superset
    for w, g in zip(want, rf):
        assert w.shape == g.shape
        assert np.array_equal(w[ok], g.numpy()[ok])
    assert np.array_equal(dist[ok], pdist.numpy()[ok])
    assert np.array_equal(uni[ok], puni.numpy()[ok])


def test_walk_rejects_record_overflow(rng):
    """A row with more records than the budget reports not-ok."""
    n = 2048
    streams = host_streams(rng, n)
    buf, cs = pack_rows(streams, n + 64)
    rf, _, _, ok = ts.walk(torch.from_numpy(buf), torch.from_numpy(cs), n,
                           ts.max_records(n))
    nrec = (rf[0] >= 0).sum(dim=1)
    rf2, _, _, ok2 = ts.walk(torch.from_numpy(buf), torch.from_numpy(cs), n, 8)
    assert bool(ok.all())
    assert torch.equal(ok2, ok & (nrec <= ts.record_slots(8)))
    # token-dense streams overflow the default budget, never high_records
    from cblosc_tpu.ops.codecs import blosclz as lzhost
    n = 8192
    dense = [lzhost.compress(9, (rng.integers(0, 4, n, dtype=np.uint8) * 9),
                             n, True) for _ in range(2)]
    buf, cs = pack_rows(dense, n + 64)
    _, _, _, ok = ts.walk(torch.from_numpy(buf), torch.from_numpy(cs), n,
                          ts.max_records(n))
    _, _, _, okh = ts.walk(torch.from_numpy(buf), torch.from_numpy(cs), n,
                           ts.high_records(n))
    assert not bool(ok.any()) and bool(okh.all())


@pytest.mark.parametrize("n", [2048, 8192])
def test_template_match_matches_jax(rng, n):
    S = stream_rows(rng, n, 14)
    slots, cs, _ = jc.encode(jnp.asarray(S), jc.DISTANCES, 0, False)
    sl, cs = np.array(slots), np.array(cs)
    want = [np.asarray(a) for a in
            js._template_match(jnp.asarray(sl), jnp.asarray(cs), n)]
    got = [a.numpy() for a in
           ts._template_match(torch.from_numpy(sl), torch.from_numpy(cs), n)]
    assert want[0].any() and not want[0].all()
    for w, g in zip(want, got):
        assert np.array_equal(w, g)
    assert ts._template_match(torch.from_numpy(sl), torch.from_numpy(cs),
                              1000) is None


def test_tile_from_pattern_matches_jax(rng):
    n = 2048
    pat = rng.integers(0, 256, (9, 256), dtype=np.uint8)
    dist = np.asarray([1, 2, 4, 8, 16, 32, 64, 128, 256], np.int32)
    tb = rng.integers(0, 256, 9).astype(np.int32)
    want = np.asarray(js._tile_from_pattern(jnp.asarray(pat),
                                            jnp.asarray(dist),
                                            jnp.asarray(tb), n))
    got = ts._tile_from_pattern(torch.from_numpy(pat), torch.from_numpy(dist),
                                torch.from_numpy(tb), n).numpy()
    assert np.array_equal(want, got)


def _split_prefix_stream(pat: np.ndarray, n: int) -> bytes:
    """A PURE-shaped stream the template path does not recognize: the
    d-byte literal prefix as a 1-byte literal plus 32-byte literals,
    one match at distance d covering [d, n-1), a 1-byte literal tail."""
    d = pat.size
    out = bytearray([0 | 32, int(pat[0])])
    for i in range(1, d, 32):
        chunk = pat[i:i + 32]
        out += bytes([chunk.size - 1]) + chunk.tobytes()
    v = n - 1 - d - 3
    dm1 = d - 1
    if v < 6:
        out += bytes([((v + 1) << 5) | (dm1 >> 8)])
    else:
        out += bytes([(7 << 5) | (dm1 >> 8)])
        rem = v - 6
        while rem >= 255:
            out.append(255)
            rem -= 255
        out.append(rem)
    out += bytes([dm1 & 255, 0, int(pat[(n - 1) % d])])
    return bytes(out)


def test_pure_tile_matches_jax(rng):
    """pure_tile_eligible on the JAX walk's own records, and the tile
    placement on the eligible rows (streams of the pure shape that the
    template path does not take)."""
    n = 2048
    rows, want_out = [], []
    for d in (2, 4, 16, 64, 128, 256):
        pat = rng.integers(0, 256, d).astype(np.uint8)
        rows.append(_split_prefix_stream(pat, n))
        want_out.append(np.tile(pat, n // d))
    rows += host_streams(rng, n)
    buf, cs = pack_rows(rows, n + 64, rows=_ROWS)
    recs, dist, uni, ok = (jnp.asarray(a) if not isinstance(a, tuple) else
                           tuple(jnp.asarray(f) for f in a)
                           for a in jax_walk(buf, cs, n, compact=False))
    assert not np.asarray(js._template_match(
        jnp.asarray(buf), jnp.asarray(cs), n)[0])[:6].any()
    valid = recs[0] >= 0
    want = np.asarray(js.pure_tile_eligible(recs, valid, dist, uni, ok,
                                            jnp.asarray(cs), n))
    trec = tuple(torch.from_numpy(np.array(f)) for f in recs)
    tdist, tuni, tok = (torch.from_numpy(np.array(a)) for a in (dist, uni, ok))
    got = ts.pure_tile_eligible(trec, trec[0] >= 0, tdist, tuni, tok,
                                torch.from_numpy(cs), n).numpy()
    assert np.array_equal(want, got)
    assert want[:5].all() and not want[5]      # d=256: 9 prefix literals
    jt, _ = js._pure_tile_place(jnp.asarray(buf), jnp.asarray(cs), recs, valid,
                                dist, jnp.asarray(want), n)
    pt, _ = ts._pure_tile_place(torch.from_numpy(buf), torch.from_numpy(cs),
                                trec, trec[0] >= 0, tdist,
                                torch.from_numpy(want.copy()), n)
    assert np.array_equal(np.asarray(jt)[want], pt.numpy()[want])
    assert np.array_equal(pt.numpy()[:5], np.stack(want_out[:5]))
    # the whole decode places them, tile or expand, to the same bytes
    out, prod, err = ts.decode(torch.from_numpy(buf), torch.from_numpy(cs), n)
    assert np.array_equal(out.numpy()[:6], np.stack(want_out))


@pytest.mark.parametrize("n", [8192])
def test_decode_matches_jax(rng, n):
    buf, cs = _inputs(rng, n)
    cs[0] = 0
    want = [np.asarray(a) for a in
            js.decode(jnp.asarray(buf), jnp.asarray(cs), n)]
    got = [a.numpy() for a in
           ts.decode(torch.from_numpy(buf), torch.from_numpy(cs), n)]
    for w, g in zip(want, got):
        assert np.array_equal(w, g)
    assert want[2].any() and not want[2].all()


def test_decode_falls_back_on_overflow(rng, monkeypatch):
    """A tiny record budget sends every non-template row to the generic
    decoder; the output does not change."""
    n = 2048
    buf, cs = _inputs(rng, n)
    a = ts.decode(torch.from_numpy(buf), torch.from_numpy(cs), n)
    monkeypatch.setattr(ts, "max_records", lambda out_len: 4)
    b = ts.decode(torch.from_numpy(buf), torch.from_numpy(cs), n)
    for x, y in zip(a, b):
        assert torch.equal(x, y)


@pytest.mark.cuda
def test_walk_kernel_matches_plain_on_card(rng, cuda):
    n = 8192
    buf, cs = _inputs(rng, n)
    b, c = torch.from_numpy(buf).to(cuda), torch.from_numpy(cs).to(cuda)
    mr = ts.max_records(n)
    k = ts.walk(b, c, n, mr)
    p = ts._walk_plain(b, c, n, ts.record_slots(mr))
    for x, y in zip(k[0] + k[1:], p[0] + p[1:]):
        assert torch.equal(x, y)
    out = ts.decode(b, c, n)
    ref = ts.decode(torch.from_numpy(buf), torch.from_numpy(cs), n)
    for x, y in zip(out, ref):
        assert torch.equal(x.cpu(), y)


@pytest.mark.parametrize("seed,n,W", streams.CASES)
def test_walk_matches_jax_on_generated_streams(seed, n, W):
    """The rows the JAX walk accepts among the generated streams (far
    matches, escape runs, 32-byte literals ending at csize, narrow and
    unaligned rows): records, dist and uni equal."""
    buf, cs, nvalid = streams.generated_rows(seed, n, W)
    want, dist, uni, ok = jax_walk(buf, cs, n)
    rf, pdist, puni, pok = ts.walk(torch.from_numpy(buf),
                                   torch.from_numpy(cs), n, ts.max_records(n))
    pok = pok.numpy()
    assert ok.sum() >= 4 and pok[ok].all()
    assert not pok[nvalid:nvalid + 2].any()          # escape runs cut short
    for w, g in zip(want, rf):
        assert np.array_equal(w[ok], g.numpy()[ok])
    assert np.array_equal(dist[ok], pdist.numpy()[ok])
    assert np.array_equal(uni[ok], puni.numpy()[ok])


@pytest.mark.cuda
@pytest.mark.parametrize("seed,n,W", streams.CARD_CASES)
def test_walk_kernel_matches_plain_on_generated_streams(seed, n, W, cuda):
    """The warp-per-row walk on the generated rows, at the default and at
    the high record budget (every column, the -1 tail included)."""
    buf, cs, _ = streams.generated_rows(seed, n, W)
    b, c = torch.from_numpy(buf).to(cuda), torch.from_numpy(cs).to(cuda)
    for mr in (ts.max_records(n), ts.high_records(n)):
        k = ts.walk(b, c, n, mr)
        p = ts._walk_plain(b, c, n, ts.record_slots(mr))
        for x, y in zip(k[0] + k[1:], p[0] + p[1:]):
            assert torch.equal(x, y)
