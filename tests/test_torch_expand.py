"""PyTorch port of the expand kernel vs cblosc_tpu.tpu.expand (Pallas,
interpret mode on the CPU): the five cases of tests/test_expand_kernel.py,
on the same records, with exact bytes wherever the records are valid;
then the kernel's split (well-formed rows by pointer jumping, the others
record by record) in plain PyTorch against the per-record loop and the
Pallas kernel, on records written straight (utils/streams.record_rows)
and on the records of the port's walks."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from cblosc_tpu.ops.codecs import blosclz as lzhost
from cblosc_tpu.tpu import codec as jc, expand as je, structured as js
from cblosc_tpu_torch.gpu import codec_lz4 as tl, codec_zlib as tz
from cblosc_tpu_torch.gpu import expand as te, structured as ts
from cblosc_tpu_torch.utils import streams
from test_torch_common import cuda, jax_walk, pack_rows  # noqa: F401


def _fields(recs):
    """A (1, R, 4) record array as the port's (kind, arg, dst, len) tuple."""
    return tuple(torch.from_numpy(recs[..., i].copy()) for i in range(4))


def _both(buf, rf, n):
    want = np.asarray(je.expand(jnp.asarray(buf),
                                tuple(jnp.asarray(f) for f in rf), n,
                                interpret=True))
    got = te.expand(torch.from_numpy(buf),
                    tuple(torch.from_numpy(f) for f in rf), n).numpy()
    return want, got


def test_expand_matches_jax_on_our_streams(rng):
    n = 2048
    S = np.stack([
        np.zeros(n, np.uint8),
        np.tile(np.arange(128, dtype=np.uint8), n // 128),
        np.repeat(rng.integers(0, 5, 32).astype(np.uint8), n // 32),
        rng.integers(0, 2, n, dtype=np.uint8) * 7,
    ])
    slots, csizes, _ = jc.encode(jnp.asarray(S))
    keep = [i for i in range(S.shape[0]) if int(csizes[i]) < n]
    rows = [np.asarray(slots[i, :int(csizes[i])]).tobytes() for i in keep]
    buf, cs = pack_rows(rows, n + 128, rows=8)
    rf, _, _, ok = jax_walk(buf, cs, n)
    ok &= cs > 0
    assert ok.sum() >= 3
    want, got = _both(buf, rf, n)
    assert np.array_equal(got[ok], want[ok])
    assert np.array_equal(got[ok], S[keep][ok[:len(keep)]])


def test_expand_matches_jax_on_mixed_distances(rng):
    n = 2048
    base = np.tile(rng.integers(0, 40, 97).astype(np.uint8), n // 97 + 1)[:n]
    pat = rng.integers(0, 9, 23).astype(np.uint8)
    weird = np.concatenate([pat, base[:n - 46], pat])[:n]
    rows = [lzhost.compress(9, s, n, True) for s in (base, weird)]
    buf, cs = pack_rows(rows, n + 128, rows=8)
    rf, _, uni, ok = jax_walk(buf, cs, n)
    assert ok[:2].all() and not uni[:2].all()
    want, got = _both(buf, rf, n)
    assert np.array_equal(got, want)
    assert np.array_equal(got[:2], np.stack([base, weird]))


def test_expand_insert_records_match_jax():
    n = 1024
    recs = np.full((1, 8, 4), -1, np.int32)
    recs[0, 0] = ((5 << 4) | 2, 0x04030201, 7, 0x00000605)
    recs[0, 1] = ((8 << 4) | 2, 0x11223344, 1000, 0x55667788)
    slots = np.zeros((1, 64), np.uint8)
    want = np.asarray(je.expand(jnp.asarray(slots), jnp.asarray(recs), n,
                                interpret=True))
    got = te.expand(torch.from_numpy(slots), _fields(recs), n).numpy()
    assert np.array_equal(got, want)
    assert list(got[0, 7:12]) == [1, 2, 3, 4, 5]
    assert list(got[0, 1000:1008]) == [0x44, 0x33, 0x22, 0x11,
                                       0x88, 0x77, 0x66, 0x55]


def test_expand_clamps_adversarial_records():
    """Out-of-range records stay inside the row; the port's clamping
    rule (csrc/expand.cu) fixes the bytes they produce."""
    n = 1024
    recs = np.full((1, 6, 4), -1, np.int32)
    recs[0, 0] = (0, 10_000, 900, 5_000)    # src+len far out of range
    recs[0, 1] = (1, 0, -50, 100)           # dist 0, negative dst
    recs[0, 2] = (0, -5, 10, 20)            # negative src reads zeros
    recs[0, 3] = (1, 5000, 200, 10)         # distance past the row start
    recs[0, 4] = ((8 << 4) | 2, -1, 1020, -1)   # immediates past the end
    slots = np.arange(64, dtype=np.uint8)[None, :].copy()
    got = te.expand(torch.from_numpy(slots), _fields(recs), n).numpy()
    want = np.zeros(n, np.uint8)
    want[15:30] = np.arange(15)              # src -5..14 -> 0 x5, 0..14
    want[1020:1024] = 0xFF
    assert got.shape == (1, n)
    assert np.array_equal(got[0], want)


def test_expand_merged_virtual_rows(rng):
    """merge_rows fuses m small rows into one expand row: bit-identical
    to per-row expansion; not-ok rows' records are invalidated."""
    n = 2048
    S = np.stack([
        np.zeros(n, np.uint8),
        np.tile(np.arange(64, dtype=np.uint8), n // 64),
        np.repeat(rng.integers(0, 5, n // 32).astype(np.uint8), 32),
        np.tile(np.array([3, 1, 4], np.uint8), n // 3 + 1)[:n],
    ] * 2)
    slots, csizes, _ = jc.encode(jnp.asarray(S))
    sl = np.array(slots)
    cs = np.array(csizes)
    rf, dist, uni, ok = ts.walk(torch.from_numpy(sl), torch.from_numpy(cs),
                                n, ts.max_records(n))
    assert bool(ok.all())
    per_row = te.expand(torch.from_numpy(sl), rf, n)
    m = ts.merge_factor(8, n)
    assert m == js.merge_factor(8, n) and m > 1
    slm, rcm = ts.merge_rows(torch.from_numpy(sl), rf, ok, n, m)
    merged = te.expand(slm, te.compact_records(rcm), m * n).reshape(8, n)
    assert torch.equal(merged, per_row)
    assert np.array_equal(merged.numpy(), S)

    ok_bad = ok & (torch.arange(8) != 2)
    slm, rcm = ts.merge_rows(torch.from_numpy(sl), rf, ok_bad, n, m)
    merged2 = te.expand(slm, te.compact_records(rcm), m * n).reshape(8, n)
    keep = ok_bad.numpy()
    assert np.array_equal(merged2.numpy()[keep], S[keep])
    # the same merge in the JAX package gives the same virtual rows
    jslm, jrcm = js.merge_rows(jnp.asarray(sl), tuple(jnp.asarray(f.numpy())
                                                      for f in rf),
                               jnp.asarray(ok_bad.numpy()), n, m)
    assert np.array_equal(np.asarray(jslm), slm.numpy())
    for a, b in zip(jrcm, rcm):
        assert np.array_equal(np.asarray(a), b.numpy())


def test_compact_records_matches_jax(rng):
    kind = rng.integers(-1, 2, (5, 40)).astype(np.int32)
    fields = [kind] + [rng.integers(0, 1000, (5, 40)).astype(np.int32)
                       for _ in range(3)]
    want = je.compact_records(tuple(jnp.asarray(f) for f in fields))
    got = te.compact_records(tuple(torch.from_numpy(f) for f in fields))
    for w, g in zip(want, got):
        assert np.array_equal(np.asarray(w), g.numpy())


@pytest.mark.cuda
def test_expand_kernel_matches_plain_on_card(rng, cuda):
    n = 8192
    rows = [lzhost.compress(9, np.tile(rng.integers(0, 40, 97 + i).astype(
        np.uint8), n // 97 + 1)[:n], n, True) for i in range(8)]
    buf, cs = pack_rows(rows, n + 64)
    b, c = torch.from_numpy(buf).to(cuda), torch.from_numpy(cs).to(cuda)
    rf = ts.walk(b, c, n, ts.max_records(n))[0]
    assert torch.equal(te.expand(b, rf, n), te._expand_plain(b, rf, n))
    recs = _fields(np.array([[[0, 10_000, 900, 5_000], [1, 0, -50, 100],
                              [-1, 0, 0, 0]]], np.int32))
    s = torch.arange(64, dtype=torch.uint8)[None, :]
    assert torch.equal(
        te.expand(s.to(cuda), tuple(f.to(cuda) for f in recs), 1024).cpu(),
        te.expand(s, recs, 1024))


# kinds whose records read no byte outside the row: the Pallas kernel's
# own clamping may differ from the port's outside it
_JAX_KINDS = ("chain1", "periodic", "gaps", "dense")


def _torch_fields(f):
    return tuple(torch.from_numpy(np.ascontiguousarray(x)) for x in f)


@pytest.mark.parametrize("kind", streams.RECORD_KINDS)
def test_jump_split_matches_per_record_loop(kind):
    """The kernel's split in plain PyTorch: a row of each kind, written
    straight (d = 1 chains, periodic matches with d < len, gaps,
    immediates, zero-length records, more than one staged tile of
    records, literals reading past the row's ends; and every way a row
    can fail the check), places the bytes of the per-record loop; the
    well-formed kinds take pointer jumping, the others the loop."""
    slots, f = streams.record_rows(61, 3000, 700, (kind,))
    rf = _torch_fields(f)
    got, rounds = te._expand_jump_plain(torch.from_numpy(slots), rf, 3000)
    assert torch.equal(got, te._expand_plain(torch.from_numpy(slots), rf,
                                             3000))
    wf = kind in streams.RECORD_WELL_FORMED
    assert bool(te._well_formed(rf, 3000)[0]) == wf
    assert (int(rounds[0]) >= 0) == wf
    if kind in ("chain1", "periodic", "dense"):
        assert int(rounds[0]) >= 2          # chains across records
    stats = torch.zeros(1, dtype=torch.int32)
    assert torch.equal(te.expand(torch.from_numpy(slots), rf, 3000, stats),
                       got)
    assert torch.equal(stats, rounds)


def test_jump_split_matches_jax_expand():
    """The same split against the Pallas kernel (interpret mode) on the
    well-formed kinds whose literals stay inside the row, and on the
    zlib walk's records over its tape (the rows it accepts)."""
    n = 1024
    slots, f = streams.record_rows(62, n, 500, _JAX_KINDS)
    seed, _, width = streams.ZLIB_CASES[0]
    buf, cs, _ = streams.zlib_rows(seed, n, width)
    tape, _, rf, _, _, ok = tz.fsm_walk(torch.from_numpy(buf),
                                        torch.from_numpy(cs), n,
                                        tz.high_events(n))
    k = torch.nonzero(ok).flatten()
    for src, fields in ((slots, f),
                        (tape[k].numpy(), tuple(x[k].numpy() for x in rf))):
        want = np.asarray(je.expand(jnp.asarray(src),
                                    tuple(jnp.asarray(x) for x in fields), n,
                                    interpret=True))
        got, rounds = te._expand_jump_plain(torch.from_numpy(src),
                                            _torch_fields(fields), n)
        assert (rounds >= 0).all()
        assert np.array_equal(got.numpy(), want)


def test_walk_records_are_well_formed(rng):
    """Every row the port's walks accept is well formed, so the kernel
    places it by pointer jumping: blosclz, LZ4 and zlib walks on their
    generated streams (records over the row, or over the zlib tape), the
    split's bytes equal to the per-record loop's."""
    cases = []
    seed, n, width = streams.CASES[1]
    buf, cs, _ = streams.generated_rows(seed, n, width)
    b, c = torch.from_numpy(buf), torch.from_numpy(cs)
    rf, _, _, ok = ts.walk(b, c, n, ts.max_records(n))
    cases.append((b, rf, ok, n))
    seed, n, width = streams.LZ4_CASES[0]
    buf, cs, _, _ = streams.lz4_rows(seed, n, width)
    b, c = torch.from_numpy(buf), torch.from_numpy(cs)
    rf, _, _, ok = tl.walk(b, c, n, ts.max_records(n))
    cases.append((b, rf, ok, n))
    seed, n, width = streams.ZLIB_CASES[0]
    buf, cs, _ = streams.zlib_rows(seed, n, width)
    tape, _, rf, _, _, ok = tz.fsm_walk(torch.from_numpy(buf),
                                        torch.from_numpy(cs), n,
                                        tz.high_events(n))
    cases.append((tape, rf, ok, n))
    for src, rf, ok, n in cases:
        assert bool(ok.any())
        assert bool(te._well_formed(rf, n)[ok].all())
        got, rounds = te._expand_jump_plain(src, rf, n)
        assert bool((rounds[ok] >= 0).all())
        assert torch.equal(got[ok], te._expand_plain(src, rf, n)[ok])


@pytest.mark.cuda
def test_expand_kernel_on_zlib_walk_records(cuda):
    """K1 on the card over the zlib walk's tape and records (every
    generated zlib row at the escalated budget): equal to the per-record
    loop, and every accepted row well formed (stats >= 0)."""
    for seed, n, width in streams.ZLIB_CARD_CASES:
        buf, cs, _ = streams.zlib_rows(seed, n, width, garbage=8)
        tape, _, rf, _, _, ok = tz.fsm_walk(
            torch.from_numpy(buf).to(cuda), torch.from_numpy(cs).to(cuda), n,
            tz.high_events(n))
        stats = torch.empty(buf.shape[0], dtype=torch.int32, device=cuda)
        got = te.expand(tape, rf, n, stats)
        assert torch.equal(got, te._expand_plain(tape, rf, n))
        assert bool((stats[ok] >= 0).all())


@pytest.mark.cuda
def test_expand_kernel_mixes_jumping_and_per_record_rows(cuda):
    """One launch holding a row of every record kind, well formed or not:
    each row equal to the per-record loop, and the rows that took the
    kernel's per-record branch (stats -1) exactly those that are not well
    formed; rows past 32 KB and 1024 records span several windows and
    tiles."""
    for seed, n, width in ((63, 3000, 700), (64, 100000, 20000)):
        slots, f = streams.record_rows(seed, n, width)
        rf = tuple(x.to(cuda) for x in _torch_fields(f))
        s = torch.from_numpy(slots).to(cuda)
        stats = torch.empty(slots.shape[0], dtype=torch.int32, device=cuda)
        got = te.expand(s, rf, n, stats)
        assert torch.equal(got, te._expand_plain(s, rf, n))
        assert torch.equal((stats < 0).cpu(), ~te._well_formed(rf, n).cpu())
