"""PyTorch port of the device blosclz codec vs cblosc_tpu.tpu.codec:
encoder bytes, csizes and est_iters identical; the generic decoder's
(out, produced, err) identical, on valid and corrupted streams."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from cblosc_tpu.ops.codecs import blosclz as lzhost
from cblosc_tpu.tpu import codec as jc
from cblosc_tpu_torch.gpu import codec as tc
from cblosc_tpu_torch.utils import streams
from test_torch_common import corrupt, cuda, host_streams, pack_rows, stream_rows  # noqa: F401


@pytest.mark.parametrize("n,N,min_cratio_x100", [
    (2048, 14, 200),     # clevel 1 threshold, PURE/HOPELESS/NORMAL rows
    (8192, 14, 150),     # the speed-clevel split width
    (8192, 7, 200),      # N <= 8: the small-batch branch, no classes
    (2048, 12, 0),       # no entropy abort: no HOPELESS rows
])
def test_encode_matches_jax(rng, n, N, min_cratio_x100):
    S = stream_rows(rng, n, N)
    want = [np.asarray(a) for a in
            jc.encode(jnp.asarray(S), jc.DISTANCES, min_cratio_x100, False)]
    got = [a.numpy() for a in
           tc.encode(torch.from_numpy(S), tc.DISTANCES, min_cratio_x100, False)]
    for w, g in zip(want, got):
        assert w.shape == g.shape and np.array_equal(w, g)
    cs = got[1]
    if N > 8 and min_cratio_x100:
        assert (cs == n).any() and (cs < n).any()    # hopeless + coded rows


def test_encode_classes_present(rng):
    """The parity inputs do cover PURE, HOPELESS and NORMAL rows."""
    S = torch.from_numpy(stream_rows(rng, 2048, 14))
    d_row, pure, cov, _ = tc._score(S, tc.DISTANCES)
    est_csize = 2048 - cov + cov // 170 + 2048 // 33 + 16
    hopeless = ~pure & (100 * 2048 < 200 * est_csize)
    assert pure.any() and hopeless.any() and (~pure & ~hopeless).any()


def test_encode_stream_decodes_in_host_oracle(rng):
    n = 2048
    S = stream_rows(rng, n, 10)
    slots, cs, _ = tc.encode(torch.from_numpy(S), tc.DISTANCES, 0, False)
    for i in range(S.shape[0]):
        c = int(cs[i])
        if c < n:
            raw = lzhost.decompress(slots[i, :c].numpy().tobytes(), n)
            assert raw == S[i].tobytes()


@pytest.mark.parametrize("n", [2048, 8192])
def test_decode_matches_jax(rng, n):
    S = stream_rows(rng, n, 7)
    slots, cs, _ = tc.encode(torch.from_numpy(S), tc.DISTANCES, 0, False)
    ours = [slots[i, :int(cs[i])].numpy().tobytes() for i in range(7)
            if int(cs[i]) < n]
    streams = ours + host_streams(rng, n)
    streams += corrupt(rng, streams)
    buf, csz = pack_rows(streams, n + 64)
    csz[0] = 0                                  # empty row: err
    csz[1] = 1                                  # one byte: fin, produced 0
    want = [np.asarray(a) for a in
            jc.decode(jnp.asarray(buf), jnp.asarray(csz), n)]
    got = [a.numpy() for a in
           tc.decode(torch.from_numpy(buf), torch.from_numpy(csz), n)]
    for w, g in zip(want, got):
        assert np.array_equal(w, g)
    assert want[2].any() and not want[2].all()


@pytest.mark.parametrize("n,W", [(1024, 300), (2048, 2112)])
def test_decode_matches_jax_on_garbage(rng, n, W):
    """Random and token-biased bytes: the error paths' produced/err and
    partial output agree too, including rows narrower than the JAX
    decoder's padded window (W < 552)."""
    N = 48
    buf = np.zeros((N, W), np.uint8)
    cs = np.zeros(N, np.int32)
    for i in range(N):
        L = int(rng.integers(0, W))
        b = rng.integers(0, 256, L).astype(np.uint8)
        if i % 2:
            b[::3] = rng.integers(0, 64, b[::3].size)   # small tokens
        buf[i, :L] = b
        cs[i] = L
    want = [np.asarray(a) for a in
            jc.decode(jnp.asarray(buf), jnp.asarray(cs), n)]
    got = [a.numpy() for a in
           tc.decode(torch.from_numpy(buf), torch.from_numpy(cs), n)]
    for w, g in zip(want, got):
        assert np.array_equal(w, g)


@pytest.mark.cuda
def test_decode_kernel_matches_plain_on_card(rng, cuda):
    n = 8192
    streams = host_streams(rng, n)
    streams += corrupt(rng, streams)
    buf, csz = pack_rows(streams, n + 64)
    b, c = torch.from_numpy(buf).to(cuda), torch.from_numpy(csz).to(cuda)
    got = tc.decode(b, c, n)
    want = tc._decode_plain(b, c, n)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def _tokens(stream: bytes):
    """(kind, length, distance, 255-bytes) of each token of a valid stream,
    walked as blosc/blosclz.c:679-789 reads it."""
    out, ip, tok = [], 1, stream[0] & 31
    while True:
        if tok < 32:
            out.append(("lit", tok + 1, 0, 0))
            ip += tok + 1
            if ip >= len(stream):
                return out
        else:
            ln, ff = (tok >> 5) + 2, 0
            if tok >> 5 == 7:
                ln = 9
                while stream[ip] == 255:
                    ln, ip, ff = ln + 255, ip + 1, ff + 1
                ln += stream[ip]
                ip += 1
            dhi, dlo = tok & 31, stream[ip]
            ip += 1
            d = (dhi << 8) + dlo + 1
            if dhi == 31 and dlo == 255:
                d = (stream[ip] << 8) + stream[ip + 1] + 8192
                ip += 2
            out.append(("match", ln, d, ff))
        tok = stream[ip]
        ip += 1


def test_generated_streams_cover_the_corners():
    """The generator's valid streams hold every case the parity tests
    below rely on, and decode (host oracle) to what they were built from."""
    rng = np.random.default_rng(0)
    toks, built = [], 0
    for kind in streams.KINDS:
        s, want = streams.build(rng, 80000, kind)
        assert lzhost.decompress(s, 80000) == want
        toks += _tokens(s)
        built += 1
        if kind == "lit32_end":
            assert toks[-1] == ("lit", 32, 0, 0)
    d = np.array([t[2] for t in toks if t[0] == "match"])
    ff = np.array([t[3] for t in toks if t[0] == "match"])
    assert ((d >= 1) & (d <= 31)).any() and (d >= 128).any()
    assert (d >= 8192).any() and (d == streams.MAX_DIST).any()
    assert (ff >= 8).any() and (ff >= 16).any()
    buf, cs, nvalid = streams.generated_rows(2, 4096, 4099)
    assert buf.shape[1] % 16 and nvalid == 2 * len(streams.KINDS)


@pytest.mark.parametrize("seed,n,W", streams.CASES)
def test_decode_matches_jax_on_generated_streams(seed, n, W):
    """Valid streams of every kind, escape runs cut within 8 bytes of
    csize, one-byte corruptions and random rows: (out, produced, err)
    equal; the valid rows decode to their bytes, the cut rows err."""
    buf, cs, nvalid = streams.generated_rows(seed, n, W)
    want = [np.asarray(a) for a in
            jc.decode(jnp.asarray(buf), jnp.asarray(cs), n)]
    got = [a.numpy() for a in
           tc.decode(torch.from_numpy(buf), torch.from_numpy(cs), n)]
    for w, g in zip(want, got):
        assert np.array_equal(w, g)
    assert not want[2][:nvalid].any() and (want[1][:nvalid] == n).all()
    assert want[2][nvalid:nvalid + 2].all()
    for i in range(nvalid):
        raw = lzhost.decompress(buf[i, :cs[i]].tobytes(), n)
        assert raw == got[0][i].tobytes()


@pytest.mark.cuda
@pytest.mark.parametrize("seed,n,W", streams.CARD_CASES)
def test_decode_kernel_matches_plain_on_generated_streams(seed, n, W, cuda):
    """The warp-parallel decoder on the generated rows, including rows
    longer than its 128 KB shared-memory ring (300000 bytes)."""
    buf, cs, _ = streams.generated_rows(seed, n, W)
    b, c = torch.from_numpy(buf).to(cuda), torch.from_numpy(cs).to(cuda)
    for g, w in zip(tc.decode(b, c, n), tc._decode_plain(b, c, n)):
        assert torch.equal(g, w)


@pytest.mark.cuda
def test_decode_kernel_matches_plain_on_host_engine_row(cuda):
    """A 256 KB clevel-9 split of the port's host engine: token-dense, the
    row the main path sends to the generic decoder."""
    from cblosc_tpu_torch.core import engine, policy
    from cblosc_tpu_torch.format import constants as C
    from cblosc_tpu_torch.format.header import ChunkHeader, read_bstarts
    from cblosc_tpu_torch.gpu import host_api

    n = 256 << 10
    low = np.random.default_rng(11).integers(0, 8, n, dtype=np.uint8) * 16
    ctx = engine.build_context(9, C.NOSHUFFLE, 1, n, n + 16, C.BLOSCLZ)
    chunk = engine.compress_chunk(ctx, low.tobytes())
    hdr = ChunkHeader.decode(chunk)
    assert hdr.nblocks == 1 and policy.nsplits_decode(
        hdr.dont_split, hdr.typesize, hdr.blocksize, False) == 1
    offs, csz = host_api._split_table(np.frombuffer(chunk, np.uint8),
                                      read_bstarts(chunk, 1), 1)
    buf, cs = pack_rows([chunk[offs[0]:offs[0] + csz[0]]], n + 64)
    assert cs[0] < n                                  # a compressed split
    b, c = torch.from_numpy(buf).to(cuda), torch.from_numpy(cs).to(cuda)
    got = tc.decode(b, c, n)
    assert got[0].cpu().numpy().tobytes() == low.tobytes()
    for g, w in zip(got, tc._decode_plain(b, c, n)):
        assert torch.equal(g, w)
