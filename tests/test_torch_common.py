"""Shared inputs and fixtures of the PyTorch port's parity tests
(tests/test_torch_*.py): the same numpy arrays, made from a seed, go
through a cblosc_tpu function and its cblosc_tpu_torch counterpart."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cblosc_tpu.ops.codecs import blosclz as lzhost
from cblosc_tpu.ops.filters_np import shuffle as np_shuffle
from cblosc_tpu.tpu import expand as je, structured as js
from cblosc_tpu.utils.timing import synth
from conftest import make_buffer


@pytest.fixture
def cuda():
    """The CUDA device, or a skip: kernel tests run only on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (hand-written kernel on the card)")
    return torch.device("cuda")


def stream_rows(rng, n: int, N: int) -> np.ndarray:
    """(N, n) uint8 split streams covering the encoder's classes: PURE
    (zeros, periodic planes), HOPELESS (random), NORMAL (low entropy,
    runs, shuffled bench data)."""
    rows = []
    for i in range(N):
        k = i % 7
        if k == 0:
            rows.append(np.frombuffer(make_buffer(rng, n, 1, "zeros"), np.uint8))
        elif k == 1:
            rows.append(np.frombuffer(make_buffer(rng, n, 1, "random"), np.uint8))
        elif k == 2:
            rows.append(np.frombuffer(make_buffer(rng, n, 1, "lowentropy"),
                                      np.uint8))
        elif k == 3:
            rows.append(np_shuffle(4, make_buffer(rng, n, 4, "ramp")))
        elif k == 4:
            rows.append(np_shuffle(8, synth(n, 8, 19, seed=i)))
        elif k == 5:
            rows.append(np.repeat(rng.integers(0, 5, n // 32).astype(np.uint8),
                                  32))
        else:
            rows.append(np_shuffle(8, np.linspace(0.0, 1.0, n // 8).view(np.uint8)))
    return np.stack([np.asarray(r, np.uint8)[:n] for r in rows])


def host_streams(rng, n: int) -> list:
    """Mixed-distance streams from the host blosclz encoder."""
    base = np.tile(rng.integers(0, 40, 97).astype(np.uint8), n // 97 + 1)[:n]
    pat = rng.integers(0, 9, 23).astype(np.uint8)
    weird = np.concatenate([pat, base[:n - 46], pat])[:n]
    ramp = np.frombuffer(make_buffer(rng, n, 4, "ramp"), np.uint8)
    low = np.frombuffer(make_buffer(rng, n, 1, "lowentropy"), np.uint8)
    out = []
    for s in (base, weird, ramp, low):
        for clevel in (1, 9):
            enc = lzhost.compress(clevel, s, n, True)
            if enc:
                out.append(enc)
    return out


def corrupt(rng, streams: list) -> list:
    """One copy of each stream with one byte flipped (never byte 0)."""
    bad = []
    for s in streams:
        b = bytearray(s)
        b[int(rng.integers(1, len(b)))] ^= 0x5A
        bad.append(bytes(b))
    return bad


def pack_rows(streams: list, width: int, rows: int = 0):
    """Streams -> (slots uint8 (N, width) zero past each csize, csizes),
    padded with empty rows to `rows` so tests share JAX compiles."""
    N = max(len(streams), rows)
    buf = np.zeros((N, width), np.uint8)
    cs = np.zeros(N, np.int32)
    for i, r in enumerate(streams):
        buf[i, :len(r)] = np.frombuffer(r, np.uint8)
        cs[i] = len(r)
    return buf, cs


_walk_jits = {}


def jax_walk(buf, cs, n: int, compact: bool = True, walk_batch=None,
             maxrec: int = 0):
    """A JAX walk (the blosclz walk unless walk_batch is given, e.g.
    codec_lz4._walk_batch) on (buf, cs) as the JAX decoder runs it (rows
    padded for its windows; maxrec defaults to the blosclz budget),
    compiled once per shape. Returns (records as numpy fields, dist,
    uni, ok)."""
    walk_batch = walk_batch or js._walk_batch
    fn = _walk_jits.setdefault(
        walk_batch, jax.jit(walk_batch, static_argnums=(2, 3)))
    W = buf.shape[1]
    Wpad = max(-(-(W + js._MARGIN) // 128) * 128, js._WINW)
    rf, dist, uni, ok = fn(
        jnp.asarray(np.pad(buf, ((0, 0), (0, Wpad - W)))), jnp.asarray(cs),
        n, maxrec or js.max_records(n))
    if compact:
        rf = je.compact_records(rf)
    return (tuple(np.array(f) for f in rf), np.array(dist), np.array(uni),
            np.array(ok))


def assert_walk_matches_jax(want, got):
    """On every row the JAX walk accepts, the port's walk accepts it too,
    with the same valid records in order (the JAX walks leave arg, dst
    and len of invalid slots undefined), dist and uni. Returns the ok
    masks (JAX's, the port's) as numpy."""
    rf, dist, uni, ok = want
    prf, pdist, puni, pok = (tuple(f.numpy() for f in a) if isinstance(a, tuple)
                             else a.numpy() for a in got)
    assert pok[ok].all()                     # the port accepts a superset
    valid = rf[0] >= 0
    assert np.array_equal(rf[0][ok], prf[0][ok])
    for w, g in zip(rf[1:], prf[1:]):
        assert np.array_equal(np.where(valid, w, 0)[ok], g[ok])
    assert np.array_equal(dist[ok], pdist[ok])
    assert np.array_equal(uni[ok], puni[ok])
    return ok, pok
