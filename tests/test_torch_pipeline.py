"""PyTorch port of the device chunk pipeline vs cblosc_tpu.tpu.pipeline:
compress_blocks / decompress_blocks and the layout helpers, exact."""

import numpy as np
import pytest

import jax.numpy as jnp

from cblosc_tpu.format import constants as C
from cblosc_tpu.tpu import pipeline as jp
from cblosc_tpu.utils.timing import synth
from cblosc_tpu_torch.gpu import pipeline as tp
from cblosc_tpu_torch.gpu.bridge import from_numpy, to_numpy
from conftest import make_buffer


def _blocks(rng, kind, nblocks, blocksize, typesize):
    if kind == "synth":
        data = synth(nblocks * blocksize, 8, 19)
    elif kind == "arange":
        data = np.arange(nblocks * blocksize // 4, dtype=np.int32).view(np.uint8)
    else:
        data = np.frombuffer(make_buffer(rng, nblocks * blocksize, typesize,
                                         kind), np.uint8)
    return np.ascontiguousarray(data.reshape(nblocks, blocksize))


@pytest.mark.parametrize("kind,typesize,shuffle", [
    ("synth", 8, C.SHUFFLE),
    ("arange", 4, C.SHUFFLE),
    ("lowentropy", 4, C.BITSHUFFLE),
    ("random", 8, C.NOSHUFFLE),
])
def test_compress_blocks_match_jax(rng, kind, typesize, shuffle):
    nsplits = typesize
    blocksize = 2048 * nsplits
    x = _blocks(rng, kind, 3, blocksize, typesize)
    args = (shuffle, typesize, nsplits, 48, C.BLOSCLZ, 200, False)
    want = [np.asarray(a) for a in jp.compress_blocks(jnp.asarray(x), *args)]
    got = to_numpy(tp.compress_blocks(from_numpy(x), *args))
    for w, g in zip(want, got):
        assert np.array_equal(w, g)
    slots, cs = from_numpy(want)
    rows = tp.mask_past_csize(slots, cs, slots.shape[1])
    blocks, err = tp.decompress_blocks(rows, cs, blocksize // nsplits,
                                       shuffle, typesize, nsplits)
    assert np.array_equal(to_numpy(blocks), x) and not bool(err.any())


def test_decompress_blocks_match_jax(rng):
    """Stored-raw rows, template rows and walk rows, and a damaged row
    whose err must agree."""
    typesize = nsplits = 4
    blocksize = 2048 * nsplits
    x = _blocks(rng, "arange", 3, blocksize, typesize)
    slots, cs = (np.array(a) for a in jp.compress_blocks(
        jnp.asarray(x), C.SHUFFLE, typesize, nsplits, 48, C.BLOSCLZ, 200,
        False))
    live = np.nonzero((cs > 8) & (cs < 2048))[0]
    slots[live[0], 3] ^= 0x40                  # damage one stream
    rows = np.asarray(jp.mask_past_csize(jnp.asarray(slots), jnp.asarray(cs),
                                         slots.shape[1]))
    assert np.array_equal(
        rows, to_numpy(tp.mask_past_csize(*from_numpy((slots, cs)),
                                          slots.shape[1])))
    want = [np.asarray(a) for a in jp.decompress_blocks(
        jnp.asarray(rows), jnp.asarray(cs), 2048, C.SHUFFLE, typesize,
        nsplits)]
    got = to_numpy(tp.decompress_blocks(*from_numpy((rows, cs)), 2048,
                                        C.SHUFFLE, typesize, nsplits))
    for w, g in zip(want, got):
        assert np.array_equal(w, g)


def test_layout_and_compaction_match_jax(rng):
    nblocks, nsplits, W = 3, 4, 40
    cs = rng.integers(0, W, nblocks * nsplits).astype(np.int32)
    slots = rng.integers(0, 256, (nblocks * nsplits, W), dtype=np.uint8)
    want = jp.layout_chunk(jnp.asarray(cs), nblocks, nsplits)
    got = tp.layout_chunk(from_numpy(cs), nblocks, nsplits)
    for w, g in zip(want, got):
        assert np.array_equal(np.asarray(w), to_numpy(g))
    per = cs.astype(np.int64) + 4
    off = (np.cumsum(per) - per).astype(np.int32)
    cap = int(per.sum()) + 7
    w = np.asarray(jp.compact_chunk(jnp.asarray(slots), jnp.asarray(cs),
                                    jnp.asarray(off), cap))
    g = to_numpy(tp.compact_chunk(*from_numpy((slots, cs, off)), cap))
    assert np.array_equal(w, g)
    chunk = rng.integers(0, 256, 500, dtype=np.uint8)
    offs = np.asarray([0, 17, 480, 499], np.int32)
    assert np.array_equal(
        np.asarray(jp.gather_slots(jnp.asarray(chunk), jnp.asarray(offs), 32)),
        to_numpy(tp.gather_slots(*from_numpy((chunk, offs)), 32)))
    assert tp.decode_slot_width(8192) == jp.decode_slot_width(8192)


def test_pipeline_refuses_other_codecs(rng):
    """Snappy, zlib and zstd have no device encoder (in the JAX package
    neither); their decoders refuse streams of another codec: LZ4
    streams handed to the zstd decoder err on every live row."""
    x = from_numpy(_blocks(rng, "zeros", 1, 1024, 4))
    for code in (C.SNAPPY, C.ZLIB, C.ZSTD):
        with pytest.raises(ValueError):
            tp.compress_blocks(x, C.SHUFFLE, 4, 4, 48, code)
    slots, cs = tp.compress_blocks(x, C.SHUFFLE, 4, 4, 48, C.LZ4)
    _, err = tp.decompress_blocks(slots, cs, 256, C.SHUFFLE, 4, 4, C.ZSTD)
    assert err.numpy()[(cs < 256).numpy()].all()
    for code in (C.SNAPPY, C.ZLIB, C.ZSTD):
        assert tp.decode_slot_width(8192, code) == \
            jp.decode_slot_width(8192, code)
