"""The port's spans and counters (cblosc_tpu_torch.utils.trace) on the
CPU: nothing is recorded without a profiler; under one, every byte-API
call is one root whose spans nest inside it and share its call id, the
copy counters equal the bytes staged and fetched, an LZ4 retry is
counted, and the ring drops its oldest records past its bound."""

import tracemalloc

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from cblosc_tpu_torch import api
from cblosc_tpu_torch.core import policy
from cblosc_tpu_torch.format import constants as C
from cblosc_tpu_torch.format.header import ChunkHeader
from cblosc_tpu_torch.ops.codecs import lz4 as thost
from cblosc_tpu_torch.utils import streams, trace
from cblosc_tpu_torch.utils.timing import synth

CPU = torch.device("cpu")
DATA = synth(64 << 10, 8, 19).tobytes()


def _profiled(fn):
    trace.clear()
    with profile(activities=[ProfilerActivity.CPU]):
        out = fn()
    return out, trace.records()


def _assert_nested(recs):
    by_index = {r.index: r for r in recs}
    for r in recs:
        assert r.start_ns <= r.end_ns
        if r.parent >= 0:
            up = by_index[r.parent]
            assert up.start_ns <= r.start_ns and r.end_ns <= up.end_ns
            assert up.call == r.call


def _counted(recs, key):
    return sum((r.counts or {}).get(key, 0) for r in recs)


def _geometry(chunk):
    hdr = ChunkHeader.decode(chunk)
    nfull = hdr.nblocks - (1 if hdr.leftover else 0)
    nsplits = policy.nsplits_decode(hdr.dont_split, hdr.typesize,
                                    hdr.blocksize, False)
    return hdr, nfull, nsplits


def test_nothing_is_recorded_without_a_profiler():
    trace.clear()
    chunk = api.compress_ctx(9, C.SHUFFLE, 8, DATA, device=CPU)
    assert api.decompress_ctx(chunk, device=CPU) == DATA
    assert trace.records() == [] and trace.RING.dropped == 0
    # one shared no-op context: a span costs no object
    assert trace.span("a") is trace.span("b")
    tracemalloc.start()
    try:
        before = tracemalloc.get_traced_memory()[0]
        for _ in range(1000):
            with trace.span("api.compress_ctx"):
                trace.count("h2d_bytes", 1)
        assert tracemalloc.get_traced_memory()[0] - before < 1024
    finally:
        tracemalloc.stop()
    assert trace.records() == []


@pytest.mark.parametrize("compressor,clevel", [("blosclz", 9), ("lz4", 5)])
def test_round_trip_spans_nest_and_count_the_copies(compressor, clevel):
    def round_trip():
        chunk = api.compress_ctx(clevel, C.SHUFFLE, 8, DATA,
                                 compressor=compressor, device=CPU)
        return chunk, api.decompress_ctx(chunk, device=CPU)

    (chunk, back), recs = _profiled(round_trip)
    assert back == DATA
    roots = [r for r in recs if r.parent == -1]
    assert [r.name for r in roots] == ["api.compress_ctx",
                                       "api.decompress_ctx"]
    assert [r.counts for r in roots] == [{"route.device": 1}] * 2
    assert len({r.call for r in roots}) == 2
    _assert_nested(recs)
    names = {r.name for r in recs}
    assert names >= {"host_api.stage_in", "host_api.fetch",
                     "host_api.assemble", "host_api.parse",
                     "host_api.err_check", "pipeline.compress_blocks",
                     "pipeline.decompress_blocks", "pipeline.gather",
                     "pipeline.encode_group", "pipeline.decode_group",
                     "filters.apply", "filters.undo", "codec.mine_group",
                     "mine.prefix", "mine.fold", "mine.verify"}
    # the miner counts its rows; on the CPU it launches nothing
    mined = [r for r in recs if r.name == "codec.mine_group"]
    assert all(r.counts["rows"] > 0 and "launches" not in r.counts
               for r in mined)

    hdr, nfull, nsplits = _geometry(chunk)
    rows = nfull * nsplits
    write = [r for r in recs if r.call == roots[0].call]
    read = [r for r in recs if r.call == roots[1].call]
    # a write stages its full blocks and fetches the worst-case body
    # (every split at neblock + 4 bytes) with its int32 csizes
    assert _counted(write, "h2d_bytes") == nfull * hdr.blocksize
    assert _counted(write, "d2h_bytes") == (
        rows * (hdr.blocksize // nsplits + 4) + 4 * rows)
    # a read stages the chunk with int32 offsets and csizes, reads one
    # error flag back and fetches its full blocks
    checks = sum(r.name == "host_api.err_check" for r in read)
    assert _counted(read, "h2d_bytes") == len(chunk) + 8 * rows
    assert _counted(read, "d2h_bytes") == checks + nfull * hdr.blocksize
    assert _counted(recs, "retried_rows") == 0


def _textlike(rng, n):
    """Short words from a tiny dictionary: an LZ4 token every few bytes."""
    words = [rng.integers(97, 123, int(k), dtype=np.uint8)
             for k in rng.integers(3, 8, 24)]
    return np.concatenate(
        [words[i] for i in rng.integers(0, len(words), n // 3)])[:n].copy()


def test_lz4_retry_counts_the_erred_and_retried_rows(monkeypatch):
    """A token-dense row errs at the default budget and decodes again at
    the escalated one. The profiler's flag is set alone: the plain LZ4
    walk's many small ops would take seconds under a CPU profile."""
    n = 2048
    src = _textlike(np.random.default_rng(5), n).tobytes()
    chunk = streams.one_split_chunk(thost.compress(src, n, 1), n, C.LZ4)
    trace.clear()
    monkeypatch.setattr(torch.autograd.profiler, "_is_profiler_enabled",
                        True)
    out = api.decompress_ctx(chunk, device=CPU)
    monkeypatch.undo()
    recs = trace.records()
    assert out == src
    _assert_nested(recs)
    assert _counted(recs, "erred_rows") == 1
    assert _counted(recs, "retried_rows") == 1
    budgets = [r.counts["budget"] for r in recs
               if r.name == "pipeline.decompress_blocks"]
    assert budgets[0] == 0 and budgets[1] > 0 and len(budgets) == 2


def test_ring_drops_the_oldest_records_and_counts_them(monkeypatch):
    monkeypatch.setattr(trace, "RING", trace.Ring(4))

    def spans():
        for k in range(6):
            with trace.span(f"s{k}"):
                trace.count("k", k)

    _, recs = _profiled(spans)
    assert [r.name for r in recs] == ["s2", "s3", "s4", "s5"]
    assert [r.counts for r in recs] == [{"k": k} for k in range(2, 6)]
    assert trace.RING.dropped == 2
    trace.clear()
    assert trace.records() == [] and trace.RING.dropped == 0
