"""PyTorch port of the zlib decoder vs cblosc_tpu.tpu.codec_zlib: the
DEFLATE walk (K6's plain version) on one batch of generated streams —
tape, records, dist, uni and ok on every row the JAX machine accepts,
the replay against zlib.decompress on rows only the port accepts, err on
every corruption in both — then decode, and zlib chunks (written by the
host engine, as in the JAX package) through the port's byte API. The
JAX machine compiles once (about a minute on the CPU): one module-scoped
call on the whole batch, shared by every case. K6's lookup tables, built
by the kernel's algorithm in plain PyTorch, decode every 15-bit peek as
JAX's _decode_sym does (one small compile). All exact."""

import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cblosc_tpu.core import engine as jeng
from cblosc_tpu.format import constants as C
from cblosc_tpu.ops.codecs import zlib_ as jhost
from cblosc_tpu.tpu import codec_zlib as jz, pipeline as jp
import cblosc_tpu_torch as tb
from cblosc_tpu_torch.core import engine as teng
from cblosc_tpu_torch.gpu import codec_zlib as tz, expand as te
from cblosc_tpu_torch.gpu import host_api as th, pipeline as tp
from cblosc_tpu_torch.ops.codecs import zlib_ as thost
from cblosc_tpu_torch.utils import streams
from conftest import make_buffer
from test_torch_common import cuda  # noqa: F401

SEED, N_OUT, WIDTH = streams.ZLIB_CASES[0]
_WIN = 16       # the JAX decoder pads its rows by one window for its reads


def _np(walk):
    """A walk's outputs (JAX's or the port's, any device) as numpy."""
    def a(t):
        return t.cpu().numpy() if torch.is_tensor(t) else np.asarray(t)

    tape, tlen, rf, dist, uni, ok = walk
    return (a(tape), a(tlen), tuple(a(f) for f in rf), a(dist), a(uni), a(ok))


@pytest.fixture(scope="module")
def batch():
    return streams.zlib_rows(SEED, N_OUT, WIDTH)


@pytest.fixture(scope="module")
def jax_walk(batch):
    """The JAX machine on the whole batch at the default budget, once."""
    buf, cs, _ = batch
    fn = jax.jit(jz._fsm_walk, static_argnums=(2, 3))
    return _np(fn(jnp.asarray(np.pad(buf, ((0, 0), (0, _WIN)))),
                  jnp.asarray(cs), N_OUT, jz.default_events(N_OUT)))


@pytest.fixture(scope="module")
def port_walk(batch):
    buf, cs, _ = batch
    return _np(tz.fsm_walk(torch.from_numpy(buf), torch.from_numpy(cs), N_OUT,
                           tz.default_events(N_OUT)))


def merged_records(rf, i: int) -> list:
    """Row i's valid records in order, adjacent literal runs that are
    contiguous in the output and on the tape merged into one (the JAX
    machine splits a run wherever an empty event slot falls inside it)."""
    out = []
    for k, a, d, n in zip(*(f[i] for f in rf)):
        if k < 0:
            continue
        if (k == 0 and out and out[-1][0] == 0 and out[-1][2] + out[-1][3] == d
                and out[-1][1] + out[-1][3] == a):
            out[-1][3] += int(n)
        else:
            out.append([int(k), int(a), int(d), int(n)])
    return out


def replay(walk, i: int) -> bytes:
    """Row i's output: its records placed over its tape (the plain
    expand, the function of K1)."""
    tape, _, rf, _, _, _ = walk
    out = te._expand_plain(torch.from_numpy(tape[i:i + 1]),
                           tuple(torch.from_numpy(f[i:i + 1]) for f in rf),
                           N_OUT)
    return out.numpy().tobytes()


def test_host_codec_copy_matches_original(rng):
    """ops/codecs/zlib_.py is the JAX package's host codec."""
    for kind in ("zeros", "ramp", "lowentropy", "random"):
        b = make_buffer(rng, 5000, 4, kind)
        for clevel in (1, 5, 9):
            enc = thost.compress(b, 2 * len(b), clevel)
            assert enc == jhost.compress(b, 2 * len(b), clevel)
            assert thost.decompress(enc, len(b)) == b
        assert thost.compress(b, 8, 5) == jhost.compress(b, 8, 5) == b""


def test_budgets_and_widths_match_jax():
    for n in (1024, 8192, 131072):
        assert tz.default_events(n) == jz.default_events(n)
        assert tz.high_events(n) == jz.high_events(n)
        maxev = jz.default_events(n)
        assert tz.event_slots(maxev) == -(-maxev // (jz._T * jz._KCH)) * (
            jz._T * jz._KCH)
        assert tp.decode_slot_width(n, C.ZLIB) == jp.decode_slot_width(n, C.ZLIB)


@pytest.mark.parametrize("kind", streams.ZLIB_KINDS)
def test_walk_matches_jax(kind, batch, jax_walk, port_walk):
    """Rows JAX accepts: the port accepts them with the same tape[:tlen],
    merged records, dist and uni. Rows only the port accepts replay to
    zlib.decompress's bytes. The over-subscribed row, which zlib rejects,
    decodes in both by the JAX rule. Every corruption errs in both, and
    so does the literal-dense row at the default budget, which the port
    then walks at high_events."""
    buf, cs, kinds = batch
    i = kinds.index(kind)
    row = bytes(buf[i, :cs[i]])
    jt, pt = jax_walk, port_walk
    jok, pok = bool(jt[5][i]), bool(pt[5][i])
    if jok:
        assert pok
        assert jt[1][i] == pt[1][i]
        assert np.array_equal(jt[0][i, :jt[1][i]], pt[0][i, :pt[1][i]])
        assert merged_records(jt[2], i) == merged_records(pt[2], i)
        assert jt[3][i] == pt[3][i] and jt[4][i] == pt[4][i]
    if pok and kind not in streams.ZLIB_ODD:
        assert replay(pt, i) == zlib.decompress(row)
    if kind in streams.ZLIB_ODD:
        assert jok
    elif kind in streams.ZLIB_VALID:
        assert pok
    else:
        assert not jok and not pok
    if kind == "dense":
        hi = _np(tz.fsm_walk(torch.from_numpy(buf[i:i + 1]),
                             torch.from_numpy(cs[i:i + 1]), N_OUT,
                             tz.high_events(N_OUT)))
        assert hi[5][0] and hi[1][0] == N_OUT
        assert replay(hi, 0) == zlib.decompress(row)


def test_records_are_compacted_with_maximal_runs(batch, port_walk):
    """The port's records: valid first, kind -1 and zeros after, no two
    adjacent literal runs (runs continue across block boundaries), every
    literal on the tape once, in order."""
    buf, cs, kinds = batch
    tape, tlen, rf, dist, uni, ok = port_walk
    kind = rf[0]
    for i in range(len(kinds)):
        nrec = int((kind[i] >= 0).sum())
        assert (kind[i, :nrec] >= 0).all() and (kind[i, nrec:] == -1).all()
        assert all((f[i, nrec:] == 0).all() for f in rf[1:])
        assert (tape[i, tlen[i]:] == 0).all()
        lits = [r for r in merged_records(rf, i) if r[0] == 0]
        assert len(lits) == int((kind[i] == 0).sum())
        assert sum(r[3] for r in lits) == tlen[i]
        starts = np.cumsum([0] + [r[3] for r in lits])[:-1]
        assert [r[1] for r in lits] == list(starts)


def test_decode_matches_zlib(batch):
    """decode on the CPU: rows the walk accepts (a csize-0 row errs, as
    in JAX) decode to zlib.decompress's bytes, every other row errs; the
    escalated budget takes the literal-dense row too; a geometry below 8
    bytes errs on every live row."""
    buf, cs, kinds = batch
    b = np.concatenate([buf, np.zeros((1, buf.shape[1]), np.uint8)])
    c = np.concatenate([cs, [0]]).astype(np.int32)
    good = streams.ZLIB_VALID + streams.ZLIB_ODD
    for budget, accepted in ((0, good), (tz.high_events(N_OUT),
                                         good + ("dense",))):
        out, prod, err = (a.numpy() for a in tz.decode(
            torch.from_numpy(b), torch.from_numpy(c), N_OUT, budget))
        assert np.array_equal(~err, [k in accepted for k in kinds] + [False])
        assert prod[-1] == 0
        for i in np.nonzero(~err)[0]:
            if kinds[i] not in streams.ZLIB_ODD:
                assert out[i].tobytes() == zlib.decompress(bytes(b[i, :c[i]]))
            assert prod[i] == N_OUT
        assert not out[err].any() and not prod[err].any()
    _, prod, err = tz.decode(torch.from_numpy(b), torch.from_numpy(c), 7)
    assert np.array_equal(err.numpy(), c > 0) and not prod.any()


_LEFTOVER = np.arange(25_000, dtype=np.int32).tobytes() + b"\x07\x01\x02"


@pytest.mark.parametrize("clevel", [1, 5, 9])
@pytest.mark.parametrize("typesize", [4, 8])
def test_chunk_bytes_match_jax_engine_and_decode(clevel, typesize):
    """compress_ctx(compressor="zlib") writes the JAX host engine's chunk
    byte for byte (full blocks and a leftover block); decompress_ctx
    decodes it through the device path on the CPU, and the JAX engine
    decodes the port's chunk."""
    data, ts = _LEFTOVER, typesize
    chunk = tb.compress_ctx(clevel, C.SHUFFLE, ts, data, compressor="zlib",
                            device="cpu")
    ctx = jeng.build_context(clevel, C.SHUFFLE, ts, len(data),
                             len(data) + C.MAX_OVERHEAD, C.ZLIB)
    assert chunk == jeng.compress_chunk(ctx, data)
    assert th.decompress_chunk(chunk, None, torch.device("cpu")) == data
    assert tb.decompress_ctx(chunk, device="cpu") == data
    assert jeng.decompress_chunk(chunk) == data
    assert teng.decompress_chunk(chunk) == data


def test_stored_split_decodes_on_the_host(rng):
    """A split that starts with a stored block (zlib stores what it cannot
    compress) errs on the device even at the escalated budget:
    gpu.host_api.decompress_chunk returns None and the byte API decodes
    the chunk with the host engine."""
    data = rng.integers(0, 256, 32768, dtype=np.uint8).tobytes() + bytes(32768)
    stream = zlib.compress(data, 6)          # the random half is stored
    assert streams.deflate_blocks(stream)[0] == 0 and len(stream) < len(data)
    chunk = streams.one_split_chunk(stream, len(data), C.ZLIB)
    assert th.decompress_chunk(chunk, None, torch.device("cpu")) is None
    assert tb.decompress_ctx(chunk, device="cpu") == data
    assert jeng.decompress_chunk(chunk) == data


# ---------------------------------------------------------------------------
# K6's lookup tables
# ---------------------------------------------------------------------------

_PEEKS = 1 << 15
# code-length sets: name -> alphabet (0 literal/length, 1 distance, 2 code
# length); the fixed tables, the dynamic tables of host-engine zlib rows,
# and generated over-subscribed, incomplete, long-code and empty sets
_SETS = {"fixed_ll": 0, "fixed_d": 1,
         **{f"host{i}_{t}": a for i in range(3)
            for t, a in (("cl", 2), ("ll", 0), ("d", 1))},
         "oversub_ll": 0, "oversub_d": 1, "oversub_cl": 2,
         "incomplete_ll": 0, "incomplete_d": 1, "incomplete_cl": 2,
         "long_ll": 0, "long_d": 1, "single_d": 1, "empty_ll": 0}


@pytest.fixture(scope="module")
def code_length_sets():
    """The lengths of every _SETS entry, from a seed through numpy."""
    rng = np.random.default_rng(71)
    out = {"fixed_ll": tz._FIXED_LL, "fixed_d": tz._FIXED_D}
    for i, (ts_, clevel) in enumerate(((8, 1), (8, 5), (4, 9))):
        data = np.frombuffer(make_buffer(rng, 32768, ts_, "lowentropy"),
                             np.uint8)
        lens = []
        streams.deflate_blocks(thost.compress(data, 1 << 17, clevel), lens)
        cl, ll, d = lens[0]
        out.update({f"host{i}_cl": cl, f"host{i}_ll": ll, f"host{i}_d": d})
    for name, S, top in (("ll", 288, 15), ("d", 30, 15), ("cl", 19, 7)):
        out[f"oversub_{name}"] = rng.integers(1, top + 1, S)
        sparse = np.zeros(S, np.int64)
        sparse[rng.choice(S, 5, replace=False)] = rng.integers(2, top + 1, 5)
        out[f"incomplete_{name}"] = sparse
    for name, S in (("ll", 288), ("d", 30)):
        lens = np.zeros(S, np.int64)
        pick = rng.permutation(S)
        lens[pick[:11]] = np.arange(1, 12)
        lens[pick[11:27]] = 15                  # complete, 16 codes of 15 bits
        out[f"long_{name}"] = lens
    out["single_d"] = np.eye(30, dtype=np.int64)[7]
    out["empty_ll"] = np.zeros(288, np.int64)
    return {k: np.asarray(v, np.int64) for k, v in out.items()}


@pytest.fixture(scope="module")
def jax_decode_all():
    """JAX's canonical decode (_build_table, _decode_sym at 15 bits) of
    every 15-bit peek, for one set of lengths padded to 288: one
    compile. Lengths of the code-length code are at most 7, so its
    15-bit decode equals the 7-bit one of the machine."""
    @jax.jit
    def f(L):
        first, cnt, offs, symtab = jz._build_table(L, 15, 288)

        def bc(t):
            return jnp.broadcast_to(t, (_PEEKS,) + t.shape[1:])

        return jz._decode_sym(jnp.arange(_PEEKS, dtype=jnp.int32), bc(first),
                              bc(cnt), bc(offs), bc(symtab), 15)

    def run(L):
        pad = np.zeros((1, 288), np.int32)
        pad[0, :len(L)] = L
        return tuple(np.asarray(a) for a in f(jnp.asarray(pad)))

    return run


@pytest.mark.parametrize("name", list(_SETS))
def test_lookup_table_matches_jax_decode(name, code_length_sets,
                                         jax_decode_all):
    """K6's table rule (codec_zlib._lookup_table and _lookup_decode, the
    kernel's algorithm in plain PyTorch) gives JAX's symbol and code
    length for every 15-bit peek, on valid, over-subscribed, incomplete
    and empty codes, codes past the 10-bit table included; length and
    distance entries carry the RFC 1951 extra bits and bases."""
    L, alpha = code_length_sets[name], _SETS[name]
    want_sym, want_len = jax_decode_all(L)
    tab, canon = tz._lookup_table(torch.from_numpy(L), alpha)
    sym, ln, ext, base = (t.numpy() for t in tz._lookup_decode(
        tab, canon, alpha, torch.arange(_PEEKS)))
    assert np.array_equal(ln, want_len)
    assert np.array_equal(sym, want_sym)
    if name.startswith("long"):
        assert (ln > tz._LOOKUP_BITS).any()
    if alpha == 0:
        m = (ln > 0) & (sym >= 257) & (sym <= 285)
        i = np.clip(sym - 257, 0, 28)
        assert np.array_equal(ext, np.where(m, tz._LEXTRA[i], 0))
        assert np.array_equal(base, np.where(m, tz._LBASE[i], 0))
    elif alpha == 1:
        m = (ln > 0) & (sym < 30)
        i = np.clip(sym, 0, 29)
        assert np.array_equal(ext, np.where(m, tz._DEXTRA[i], 0))
        assert np.array_equal(base, np.where(m, tz._DBASE[i], 0))


@pytest.mark.cuda
def test_kernel_matches_plain_on_generated_streams(cuda):
    """K6 against its plain version on the generated rows of every card
    case at the default budget (tape, tlen, records, dist, uni, ok,
    tolerance 0): every strategy, codes past the 10-bit lookup table
    ("longcodes"), the over-subscribed and incomplete codes of "oversub"
    and of the one-byte flips, random rows; and K6 + K1 at the escalated
    budget against zlib.decompress."""
    for seed, n, width in streams.ZLIB_CARD_CASES:
        buf, cs, kinds = streams.zlib_rows(seed, n, width, garbage=8)
        b, c = torch.from_numpy(buf), torch.from_numpy(cs)
        k = _np(tz.fsm_walk(b.to(cuda), c.to(cuda), n, tz.default_events(n)))
        p = _np(tz.fsm_walk(b, c, n, tz.default_events(n)))
        for u, v in zip((*k[:2], *k[2], *k[3:]), (*p[:2], *p[2], *p[3:])):
            assert np.array_equal(u, v)
        out, _, err = tz.decode(b.to(cuda), c.to(cuda), n, tz.high_events(n))
        ok = ~err.cpu().numpy()
        accepted = streams.ZLIB_VALID + ("dense",) + streams.ZLIB_ODD
        nk = len(streams.ZLIB_KINDS)
        assert np.array_equal(ok[:nk], [k in accepted for k in kinds[:nk]])
        for i in np.nonzero(ok[:nk])[0]:
            if kinds[i] not in streams.ZLIB_ODD:
                assert out[i].cpu().numpy().tobytes() == zlib.decompress(
                    bytes(buf[i, :cs[i]]))
