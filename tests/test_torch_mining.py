"""PyTorch port of the ratio clevels' adaptive-distance mining vs the JAX
package: _mine_distance, _fold, _eq_at and mine_group exact; the blosclz
and LZ4 encoders with mine=True (csizes on every row, slots and est_iters
on every row with csize < n); byte-API chunks at clevels 5 and 9, and
under every splitmode, byte-identical to cblosc_tpu.tpu.host_api's."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from cblosc_tpu.core import engine as jeng
from cblosc_tpu.format import constants as C
from cblosc_tpu.ops.codecs import blosclz as lzhost, lz4 as lz4host
from cblosc_tpu.tpu import codec as jc, codec_lz4 as jl, host_api as jh
from cblosc_tpu.utils.timing import synth
import cblosc_tpu_torch as tb
from cblosc_tpu_torch.core import engine as teng, policy
from cblosc_tpu_torch.gpu import codec as tc, codec_lz4 as tl
from test_torch_common import cuda, stream_rows  # noqa: F401


def _staircase(n, step=128):
    return (np.arange(n) // step % 256).astype(np.uint8)


def _tiled(seed, period, n):
    """Random bytes repeating at `period`: hopeless to the static probe,
    a mined distance of `period`."""
    rng = np.random.default_rng(seed)
    return np.tile(rng.integers(0, 256, period, np.uint8), n // period + 1)[:n]


def _tie_row(n):
    """Two periodic stretches whose gaps (6 and 10) count 591 each, then
    random bytes: the mode is the first maximum, the smaller gap."""
    rng = np.random.default_rng(5)
    a = np.tile(rng.integers(0, 256, 10, np.uint8), 61)[:604]
    b = np.tile(rng.integers(0, 256, 6, np.uint8), 100)
    row = np.concatenate([b, rng.integers(0, 256, 200, np.uint8), a,
                          rng.integers(0, 256, 200, np.uint8)])
    return np.concatenate([row, rng.integers(0, 256, n - row.size, np.uint8)])


def _ff_row(n):
    """Repeated 0xFF 4-grams (the sentinel's value) among real grams."""
    pat = np.array([255, 255, 255, 255, 1, 2, 3, 255, 255, 255, 255, 7],
                   np.uint8)
    return np.tile(pat, n // pat.size + 1)[:n]


def _both(jfn, tfn, S, *args):
    want = [np.asarray(a) for a in jfn(jnp.asarray(S), *args)]
    got = [a.numpy() for a in tfn(torch.from_numpy(S), *args)]
    return want, got


def test_mine_distance_matches_jax(rng):
    """The rows of the JAX package's own mining test (far staircase,
    prime period, random, runs), all-0xFF and 0xFF-gram rows, a tie."""
    n = 65536
    S = np.stack([_staircase(n), (np.arange(n) % 251).astype(np.uint8),
                  rng.integers(0, 256, n, dtype=np.uint8),
                  np.zeros(n, np.uint8), np.full(n, 255, np.uint8),
                  _ff_row(n), _tie_row(n)])
    want, got = _both(jc._mine_distance, tc._mine_distance, S)
    for w, g in zip(want, got):
        assert np.array_equal(w, g)
    assert list(got[0][:3]) == [32768, 251, 0]
    assert got[0][4] == 0                 # a gram of four 255 is no gram
    assert (got[0][6], got[1][6]) == (6, 591)     # the tie: the smaller gap
    # the fold miner's call: min_gap 1, a capped max_gap
    F = np.asarray(jc._fold(jnp.asarray(S[:4]), 16))
    want, got = _both(jc._mine_distance, tc._mine_distance, F, 1, 0xFFFF // 16)
    for w, g in zip(want, got):
        assert np.array_equal(w, g)


@pytest.mark.parametrize("G", [16, 32])
def test_fold_matches_jax(rng, G):
    n = 32768
    S = np.concatenate([rng.integers(0, 256, (3, n), dtype=np.uint8),
                        np.full((1, n), 255, np.uint8),
                        _staircase(n)[None]])
    want = np.asarray(jc._fold(jnp.asarray(S), G))
    got = tc._fold(torch.from_numpy(S), G).numpy()
    assert want.dtype == got.dtype and np.array_equal(want, got)
    assert [tc._fold_g(n) for n in (32768, 131072, 262144)] == \
        [jc._fold_g(n) for n in (32768, 131072, 262144)] == [16, 32, 32]


def test_eq_at_matches_jax(rng):
    """Per-row distances 1 .. beyond the row (no position then)."""
    n = 4096
    S = np.stack([_tiled(i, p, n) for i, p in
                  enumerate((1, 7, 512, 4095, 4096, 5000, 40000))])
    S[1, ::5] = 0
    d = np.array([1, 7, 512, 4095, 4096, 5000, 40000], np.int32)
    want = np.asarray(jc._eq_at(jnp.asarray(S), jnp.asarray(d)))
    got = tc._eq_at(torch.from_numpy(S), torch.from_numpy(d)).numpy()
    assert np.array_equal(want, got)
    assert got[0].sum() == n - 2 and not got[4:].any()


@pytest.mark.parametrize("n,max_d", [(32768, jc.MAX_FARDIST),
                                     (131072, 0xFFFF)])
def test_mine_group_matches_jax(n, max_d):
    S = np.stack([_staircase(n), _tiled(1, 8192, n), _tiled(2, 3000, n),
                  np.zeros(n, np.uint8)])
    d_row = np.array([[1], [1], [1], [1]], np.int32)
    want = [np.asarray(a) for a in
            jc.mine_group(jnp.asarray(S), jnp.asarray(d_row), max_d)]
    got = [a.numpy() for a in
           tc.mine_group(torch.from_numpy(S), torch.from_numpy(d_row), max_d)]
    assert np.array_equal(want[0], got[0]) and np.array_equal(want[1], got[1])
    # period 3000: the fold miner's multiple of G outscores the prefix's
    far, fold = {32768: (0, 6000), 131072: (32768, 12000)}[n]
    assert list(got[0]) == [far, 8192, fold, 0]


def _encoder_rows(rng, n, N):
    """stream_rows plus a far staircase and a tiled random row, which the
    static probe calls hopeless and mining adopts."""
    S = stream_rows(rng, n, N)
    S[1] = _tiled(3, min(8192, n // 4), n)
    if n >= 65536:
        S[5] = _staircase(n)
    return S


def _assert_mined_parity(want, got, n):
    """csizes on every row; slots and est_iters where csize < n (the
    others are stored raw: ROADMAP §3, deliberate differences)."""
    assert all(w.dtype == g.dtype and w.shape == g.shape
               for w, g in zip(want, got))
    assert np.array_equal(want[1], got[1])
    live = got[1] < n
    assert np.array_equal(want[0][live], got[0][live])
    assert np.array_equal(want[2][live], got[2][live])


@pytest.mark.parametrize("n,N,clevel", [
    (2048, 6, 5),        # the small-batch branch (N <= 8): prefix miner
    (2048, 14, 5),       # the class branch, prefix miner only
    (32768, 10, 5),      # the fold miner at G = 16, far distance 8192
    (131072, 9, 9),      # G = 32, the clevel-9 threshold
])
def test_blosclz_encode_mined_matches_jax(rng, n, N, clevel):
    S = _encoder_rows(rng, n, N)
    mc = policy.device_min_cratio_x100(clevel)
    want, got = _both(jc.encode, tc.encode, S, jc.DISTANCES, mc, True)
    _assert_mined_parity(want, got, n)
    plain = tc.encode(torch.from_numpy(S), tc.DISTANCES, mc, False)[1].numpy()
    assert (got[1] < plain).any()                    # mining moved a row
    assert got[1][1] < n and (N <= 8 or plain[1] >= n)  # hopeless, adopted
    for i in np.nonzero(got[1] < n)[0]:
        stream = got[0][i, :int(got[1][i])].tobytes()
        assert lzhost.decompress(stream, n) == S[i].tobytes()


def _lz4_abutting_rows(rng):
    """The JAX package's LZ4 mining rows: staircase, prime period, a
    random block repeated at 9000 (mined runs abut static ones)."""
    n = 65536
    return np.stack([_staircase(n), (np.arange(n) % 251).astype(np.uint8),
                     np.tile(rng.integers(0, 256, 9000, np.uint8), 8)[:n]])


def _abuts(S):
    """Whether a mined run directly follows or precedes a static run on
    some row (the case where a sub-match carries its own token)."""
    s = torch.from_numpy(S)
    n = S.shape[1]
    idx = torch.arange(n, dtype=torch.int32)[None, :]
    d_row = torch.from_numpy(_lz4_d_row(S)[:, None].astype(np.int32))
    dm, eq_m = tc.mine_group(s, d_row, 0xFFFF)
    eq = tc._eq_for(s, d_row, tc.DISTANCES, last_lit=False) & (idx < n - 5)
    m2 = tl._segment(eq_m & (idx < n - 5), tc._MINRUN_MINED, idx, n)[0]
    m1 = tl._segment(eq & ~m2, 4, idx, n)[0]
    return bool(((m1[:, 1:] & m2[:, :-1]) | (m2[:, 1:] & m1[:, :-1])).any())


def _lz4_d_row(S):
    n = S.shape[1]
    covs = []
    for d in tc.DISTANCES:
        e = S[:, d:] == S[:, :n - d]
        covs.append((e[:, 2:] & e[:, 1:-1] & e[:, :-2]).sum(axis=1))
    return np.asarray(tc.DISTANCES)[np.argmax(np.stack(covs), axis=0)]


def test_lz4_encode_mined_matches_jax_on_abutting_rows(rng):
    S = _lz4_abutting_rows(rng)
    assert _abuts(S)
    want, got = _both(jl.encode, tl.encode, S, jc.DISTANCES, 0, True)
    for w, g in zip(want, got):
        assert np.array_equal(w, g)
    for i in range(S.shape[0]):
        stream = got[0][i, :got[1][i]].tobytes()
        assert lz4host.decompress(stream, S.shape[1]) == S[i].tobytes()


@pytest.mark.parametrize("n,N,clevel", [(2048, 14, 5), (32768, 10, 9),
                                        (32768, 6, 5)])
def test_lz4_encode_mined_matches_jax(rng, n, N, clevel):
    S = _encoder_rows(rng, n, N)
    mc = policy.device_min_cratio_x100(clevel)
    want, got = _both(jl.encode, tl.encode, S, jc.DISTANCES, mc, True)
    _assert_mined_parity(want, got, n)
    assert got[1][1] < n                             # adopted by mining


def _jax_chunk(clevel, shuffle, typesize, data, code=C.BLOSCLZ,
               splitmode=C.FORWARD_COMPAT_SPLIT):
    ctx = jeng.build_context(clevel, shuffle, typesize, len(data),
                             len(data) + C.MAX_OVERHEAD, code,
                             splitmode=splitmode)
    out = jh.compress_chunk(ctx, data)
    return jeng.compress_chunk(ctx, data) if out is None else out


def _mixed_buffer():
    """2 MB of synth, int32 arange and a tiled random block, plus a
    leftover: at clevel 5 two 1 MB blocks of 8 splits (the class branch),
    at clevel 9 one 2 MB block (the small-batch branch) and a leftover."""
    parts = [synth(1 << 20, 8, 19).view(np.uint8),
             np.arange(1 << 17, dtype=np.int32).view(np.uint8),
             _tiled(9, 8192, 1 << 19), np.arange(1000, dtype=np.uint8)]
    return np.concatenate(parts).tobytes()


_MIXED = _mixed_buffer()


@pytest.mark.parametrize("clevel", range(10))
def test_device_policy_copy_matches_original(clevel):
    """The port's copy of the device geometry and encoder policies: the
    128 KB / 256 KB splits of clevels 5-8 / 9, mining from clevel 5."""
    from cblosc_tpu.core import policy as jpolicy

    for code in (C.BLOSCLZ, C.LZ4, C.LZ4HC, C.ZSTD):
        for ts in (1, 2, 4, 8, 16):
            for nbytes in (4096, 100_000, 1 << 20, (16 << 20) + 3):
                for mode in (C.ALWAYS_SPLIT, C.NEVER_SPLIT, C.AUTO_SPLIT,
                             C.FORWARD_COMPAT_SPLIT):
                    args = (clevel, ts, nbytes, 0, code, mode)
                    assert (policy.compute_blocksize_device(*args)
                            == jpolicy.compute_blocksize_device(*args))
    assert policy.device_mine(clevel) == jpolicy.device_mine(clevel)
    assert (policy.device_min_cratio_x100(clevel)
            == jpolicy.device_min_cratio_x100(clevel))
    assert (policy.device_min_bytes_per_iter(clevel)
            == jpolicy.device_min_bytes_per_iter(clevel))


@pytest.mark.parametrize("compressor,clevel,shuffle,typesize", [
    ("blosclz", 5, C.SHUFFLE, 8),
    ("blosclz", 9, C.BITSHUFFLE, 4),
    ("lz4", 5, C.SHUFFLE, 8),            # numcodecs' default Blosc()
    ("lz4", 9, C.BITSHUFFLE, 8),
    ("lz4hc", 5, C.BITSHUFFLE, 4),
    ("lz4hc", 9, C.SHUFFLE, 4),
])
def test_ratio_clevel_chunks_match_jax(compressor, clevel, shuffle, typesize):
    code = C.COMPCODES[compressor]
    got = tb.compress_ctx(clevel, shuffle, typesize, _MIXED,
                          compressor=compressor, device="cpu")
    assert got == _jax_chunk(clevel, shuffle, typesize, _MIXED, code)
    assert len(got) < len(_MIXED) // 2
    assert jeng.decompress_chunk(got) == _MIXED
    assert teng.decompress_chunk(got) == _MIXED
    assert tb.decompress_ctx(got, device="cpu") == _MIXED


@pytest.mark.parametrize("clevel", [1, 5])
@pytest.mark.parametrize("splitmode", [C.ALWAYS_SPLIT, C.NEVER_SPLIT,
                                       C.AUTO_SPLIT, C.FORWARD_COMPAT_SPLIT])
def test_splitmode_chunks_match_jax(splitmode, clevel):
    data = _MIXED[:(1 << 18) + 999]
    got = tb.compress_ctx(clevel, C.SHUFFLE, 8, data, splitmode=splitmode,
                          device="cpu")
    assert got == _jax_chunk(clevel, C.SHUFFLE, 8, data,
                             splitmode=splitmode)
    assert tb.decompress_ctx(got, device="cpu") == data


def test_splitmode_sets_the_dont_split_bit():
    data = _MIXED[:1 << 20]
    flags = {m: tb.compress_ctx(5, C.SHUFFLE, 8, data, splitmode=m,
                                device="cpu")[2] & C.DONT_SPLIT
             for m in (C.ALWAYS_SPLIT, C.NEVER_SPLIT)}
    assert flags == {C.ALWAYS_SPLIT: 0, C.NEVER_SPLIT: C.DONT_SPLIT}


# ---------------------------------------------------------------------------
# on the card: the mined encoders and chunks equal the CPU's
# ---------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("mod", [tc, tl])
def test_mined_encode_on_card_equals_cpu(rng, cuda, mod):
    n = 131072
    S = torch.from_numpy(_encoder_rows(rng, n, 12))
    got = mod.encode(S.to(cuda), tc.DISTANCES, 100, True)
    want = mod.encode(S, tc.DISTANCES, 100, True)
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)


@pytest.mark.cuda
@pytest.mark.parametrize("compressor", ["blosclz", "lz4", "lz4hc"])
@pytest.mark.parametrize("clevel", [5, 9])
def test_ratio_clevel_chunk_on_card_equals_cpu(cuda, compressor, clevel):
    got = tb.compress_ctx(clevel, C.SHUFFLE, 8, _MIXED, compressor=compressor,
                          device=cuda)
    assert got == tb.compress_ctx(clevel, C.SHUFFLE, 8, _MIXED,
                                  compressor=compressor, device="cpu")
    assert tb.decompress_ctx(got, device=cuda) == _MIXED


# ---------------------------------------------------------------------------
# on the card: the mining kernel equals the plain version
# ---------------------------------------------------------------------------

def _mine_kernel_rows(n, N):
    """N rows of n bytes, the same on every call of (n, N): this file's
    edge rows (the tie, 0xFF grams, periods 6, 4,000, 9,000 (far form)
    and 70,000 (above the LZ4 cap), the staircase) in turn with random
    rows."""
    rng = np.random.default_rng((n, N))
    edge = [_tie_row(max(n, 2048))[:n], _ff_row(n), _tiled(11, 6, n),
            _tiled(12, 4000, n), _tiled(13, 9000, n), _tiled(14, 70000, n),
            _staircase(n)]
    k = len(edge) + 2
    return np.stack([edge[i % k] if i % k < len(edge)
                     else rng.integers(0, 256, n, np.uint8)
                     for i in range(N)])


def _mine_kernel_inputs(n, N, max_d):
    """[(rows, d_row, rows where the static distance is the mined one)]
    of one kernel case, the same on every call: N rows (N = 1: each of
    nine rows alone), first with d_row 1, then with the plain version's
    mined distance as d_row on every other row. d_row is int32 at the
    LZ4 cap, int64 at blosclz's, as the encoders pass it."""
    S = _mine_kernel_rows(n, 9 if N == 1 else N)
    dtype = torch.int32 if max_d == 0xFFFF else torch.int64
    out = []
    for B in [S[i:i + 1] for i in range(9)] if N == 1 else [S]:
        ones = torch.ones((B.shape[0], 1), dtype=dtype)
        dm = tc._mine_group_plain(torch.from_numpy(B), ones, max_d)[0]
        if n >= 4096 and B.shape[0] >= 7:
            assert (dm > 0).any()
        same = (torch.arange(B.shape[0]) % 2 == 0) & (dm > 0)
        out += [(B, ones, torch.zeros_like(same)),
                (B, torch.where(same[:, None], dm.to(dtype)[:, None], ones),
                 same)]
    return out


def _mine_kernel_case(cuda, n, N, max_d, offset):
    from cblosc_tpu_torch.gpu import kernels

    inputs = _mine_kernel_inputs(n, N, max_d)
    before = kernels.LAUNCHES["mine"]
    for B, dr, same in inputs:
        s = torch.from_numpy(B)
        want = tc._mine_group_plain(s, dr, max_d)
        # nothing may be adopted where the static distance is the mined one
        assert not want[0][same].any() and not want[1][same].any()
        # offset: every row starts one byte past a 16-byte boundary
        on = torch.empty(s.numel() + offset, dtype=torch.uint8,
                         device=cuda)[offset:].view(s.shape).copy_(s)
        got = tc.mine_group(on, dr.to(cuda), max_d)
        assert got[0].dtype == torch.int64 and got[1].dtype == torch.bool
        assert torch.equal(got[0].cpu(), want[0])
        assert torch.equal(got[1].cpu(), want[1])
    assert kernels.LAUNCHES["mine"] - before == len(inputs)


def _mine_kernel_raises(cuda, bad):
    from cblosc_tpu_torch.gpu import kernels

    s = {"dtype": torch.zeros((4, 2048), dtype=torch.int16, device=cuda),
         "ndim": torch.zeros(2048, dtype=torch.uint8, device=cuda),
         "stride": torch.zeros((4, 4096), dtype=torch.uint8,
                               device=cuda)[:, ::2]}[bad]
    before = kernels.LAUNCHES["mine"]
    with pytest.raises(ValueError):
        tc.mine_group(s, torch.ones((4, 1), dtype=torch.int64, device=cuda))
    assert kernels.LAUNCHES["mine"] == before


def _mine_id(n, N, max_d, offset=0):
    cap = 'far' if max_d == tc.MAX_FARDIST else 'u16'
    return f"n{n}-N{N}-{cap}" + (f"-offset{offset}" if offset else "")


_MINE_KERNEL_CASES = [
    pytest.param(n, N, max_d, 0, id=_mine_id(n, N, max_d))
    for n in (512, 1024, 2000, 2001, 4096, 4099, 40000, 40001, 65536,
              131072, 262144, 524288)
    for N in (1, 8, 40)
    for max_d in (tc.MAX_FARDIST, 0xFFFF)
] + [pytest.param(n, 8, tc.MAX_FARDIST, 1, id=_mine_id(n, 8, tc.MAX_FARDIST, 1))
     for n in (65536, 262144, 524288)
] + [pytest.param(bad, None, None, 0, id=f"raises-{bad}")
     for bad in ("dtype", "ndim", "stride")]


@pytest.mark.cuda
@pytest.mark.parametrize("n,N,max_d,offset", _MINE_KERNEL_CASES)
def test_mine_kernel_matches_plain(cuda, n, N, max_d, offset):
    """The kernel's (d_m, eq_m) equal the plain version's byte for byte
    (rows of 512 B to 512 KB: each of the kernel's sorts, lengths that
    are not multiples of 16, so that rows after the first start off a
    16-byte boundary, rows one byte past one in every case of the
    offset, the 512 KB row's fold through the kernel's global scratch;
    1, 8 and 40 rows; the blosclz and LZ4 caps; static distances equal to
    the mined one); one launch a call; a bad input raises and launches
    nothing. The JAX package does not run on the card: the plain version
    is held to it on the same rows by
    test_mine_group_plain_matches_jax_on_kernel_rows."""
    if isinstance(n, str):
        _mine_kernel_raises(cuda, n)
    else:
        _mine_kernel_case(cuda, n, N, max_d, offset)


@pytest.mark.parametrize("n,N,max_d", [
    pytest.param(n, N, max_d, id=_mine_id(n, N, max_d))
    for n, N, max_d in ((2001, 8, 0xFFFF), (4099, 8, tc.MAX_FARDIST),
                        (40001, 8, 0xFFFF), (131072, 40, 0xFFFF),
                        (262144, 8, tc.MAX_FARDIST),
                        (262144, 40, tc.MAX_FARDIST),
                        (524288, 8, tc.MAX_FARDIST), (524288, 40, 0xFFFF))])
def test_mine_group_plain_matches_jax_on_kernel_rows(n, N, max_d):
    """The plain version, which the card test holds the kernel to, equals
    the JAX package's mine_group on the card test's rows: lengths that
    are not multiples of 16, 40 rows, the blosclz c9 cell's 256 KB rows,
    the kernel's global-scratch length, int32 and int64 d_row, and
    d_row equal to the mined distance."""
    for B, dr, _ in _mine_kernel_inputs(n, N, max_d):
        want = jc.mine_group(jnp.asarray(B),
                             jnp.asarray(dr.numpy().astype(np.int32)), max_d)
        got = tc.mine_group(torch.from_numpy(B), dr, max_d)
        assert np.array_equal(np.asarray(want[0]), got[0].numpy())
        assert np.array_equal(np.asarray(want[1]), got[1].numpy())
