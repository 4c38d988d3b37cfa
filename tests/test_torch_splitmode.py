"""The reference's split-mode limit, pinned: ALWAYS_SPLIT writes chunks
that no decoder reads back where typesize > 16 or blocksize / typesize
< 128. The encoder splits on the header flag alone (policy.nsplits_encode,
after blosc.c:627-633); the decoder re-checks both bounds
(policy.nsplits_decode, after blosc.c:749-757) and reads the first
split's length as the whole block's.

The port reproduces the limit byte for byte: its byte API's chunk equals
the JAX package's (cblosc_tpu.compress_ctx(..., backend="tpu")), and
every decoder raises FormatError on it: the port's byte API, numpy
engine and native engine, and the JAX package's numpy and native
engines. A change to the port's encoder that "fixes" the limit changes
chunk bytes and fails here."""

import numpy as np
import pytest

import cblosc_tpu as jb
from cblosc_tpu.core import engine as jeng
from cblosc_tpu.format.header import FormatError as JFormatError
from cblosc_tpu.native import binding as jnat
import cblosc_tpu_torch as tb
from cblosc_tpu_torch.core import engine as teng
from cblosc_tpu_torch.format import constants as C
from cblosc_tpu_torch.format.header import ChunkHeader, FormatError
from cblosc_tpu_torch.native import binding as tnat
from cblosc_tpu_torch.utils.timing import synth

ARANGE = (np.arange((2 << 20) // 8, dtype=np.int64) // 3).tobytes()   # 2 MB

CASES = {
    # typesize > MAX_SPLITS (16)
    "blosclz-ts32-2MB": ("blosclz", 32, ARANGE),
    "lz4-ts32-2MB": ("lz4", 32, ARANGE),
    # blocksize / typesize < MIN_BUFFERSIZE (128)
    "blosclz-ts8-1000B": ("blosclz", 8, synth(1000, 8, 19).tobytes()),
}


@pytest.mark.parametrize("cid", list(CASES))
def test_always_split_chunk_matches_jax_and_no_decoder_reads_it(cid):
    comp, ts, data = CASES[cid]
    chunk = tb.compress_ctx(5, C.SHUFFLE, ts, data, compressor=comp,
                            splitmode=C.ALWAYS_SPLIT, device="cpu")
    assert chunk == jb.compress_ctx(5, C.SHUFFLE, ts, data, compressor=comp,
                                    splitmode=C.ALWAYS_SPLIT, backend="tpu")
    hdr = ChunkHeader.decode(chunk)
    assert not hdr.memcpyed and not hdr.dont_split     # split on the flag
    assert ts > 16 or hdr.blocksize // ts < 128
    for err, fn in (
            (FormatError, lambda: tb.decompress_ctx(chunk, device="cpu")),
            (FormatError, lambda: teng.decompress_chunk(chunk)),
            (FormatError, lambda: tnat.decompress_chunk(chunk, None, 1)),
            (JFormatError, lambda: jeng.decompress_chunk(chunk)),
            (JFormatError, lambda: jnat.decompress_chunk(chunk, None, 1))):
        with pytest.raises(err):
            fn()
