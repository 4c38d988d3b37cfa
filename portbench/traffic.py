"""The general traffic generator: a configuration and a mix in, the
cell's data and its list of calls out.

A configuration (``portbench/configs/<config>.json``) fixes the codec
arguments (``codec``), the data (``data``), the chunk size and the
working set. A mix (``portbench/traffic/<mix>.json``) fixes the
operation and what it reads:

- ``op``: ``compress`` (``api.compress_ctx`` over the data chunks),
  ``decompress`` (``api.decompress_ctx`` over chunks written from them)
  or ``getitem`` (``api.getitem`` of ``items`` items at ``ranges``
  random offsets of random chunks, drawn from the seed);
- ``chunks_written_by`` (``decompress``, ``getitem``): ``program``, the
  program's own ``compress_ctx`` in set-up (a round trip), or
  ``cblosc_writer``, the benchmark's frozen C-blosc-format writer;
- ``warmup_passes``: passes over the calls before the window.

Calls cycle through the list in order, one client in a closed loop.
The same seed gives the same data, the same chunks and the same calls;
every seed gives the same sizes.
"""

from __future__ import annotations

import sys

import numpy as np

from . import filters


def rng_for(seed: int, stream: int = 0) -> np.random.Generator:
    """A generator for any whole seed, negative or past 64 bits."""
    return np.random.default_rng([seed & (2**64 - 1), stream])


def make_data(config: dict, seed: int) -> list[bytes]:
    """The working set: ``working_set_chunks`` chunks of ``chunk_bytes``."""
    d = config["data"]
    nchunks, size = config["working_set_chunks"], config["chunk_bytes"]
    total = nchunks * size
    if d["generator"] == "synth":
        # the port's utils/timing.synth, not c-blosc bench.c's words: int64
        # words with `significant_bits` random bits, shifted to end at bit 32
        sbits = d["significant_bits"]
        vals = rng_for(seed).integers(0, 1 << min(sbits, 62), -(-total // 8),
                                      dtype=np.int64)
        vals <<= max(0, 32 - sbits)
        flat = vals.view(np.uint8)[:total]
    elif d["generator"] == "arange":
        # a numpy arange of `dtype`, from an offset drawn from the seed
        dt = np.dtype(d["dtype"])
        start = int(rng_for(seed).integers(0, 1 << 20))
        flat = np.arange(start, start + -(-total // dt.itemsize),
                         dtype=dt).view(np.uint8)[:total]
    else:
        raise SystemExit(
            f"portbench: unknown data generator {d['generator']!r}")
    return [flat[i * size:(i + 1) * size].tobytes() for i in range(nchunks)]


def write_chunks(config: dict, traffic: dict, data: list[bytes], device,
                 log=sys.stderr) -> list[bytes]:
    """The chunks a read mix decodes, each checked to be of the
    configuration's codec and filter and not stored raw."""
    c = config["codec"]
    by = traffic["chunks_written_by"]
    if by == "program":
        from cblosc_tpu_torch import api

        doshuffle = filters.BY_NAME[c["shuffle"]].CODE
        chunks = [api.compress_ctx(c["clevel"], doshuffle,
                                   c["typesize"], d, compressor=c["cname"],
                                   blocksize=c["blocksize"], device=device)
                  for d in data]
    elif by == "cblosc_writer":
        from . import cblosc_writer

        if c["blocksize"]:
            raise SystemExit("portbench: the writer takes c-blosc's "
                             "automatic blocksize only")
        chunks = [cblosc_writer.compress(c["clevel"], c["shuffle"],
                                         c["typesize"], d, c["cname"])
                  for d in data]
    else:
        raise SystemExit(f"portbench: unknown chunk writer {by!r}")
    from .check import header_wrong
    from .reference import header

    for i, (d, ch) in enumerate(zip(data, chunks)):
        if header_wrong(ch, config, len(d)) or header(ch)["memcpyed"]:
            raise SystemExit(f"portbench: input chunk {i} is not a "
                             f"{c['cname']} {c['shuffle']} chunk: "
                             f"{header(ch)}")
    h = header(chunks[0])
    print(f"portbench: {len(chunks)} input chunks written by {by}: "
          f"{c['cname']}, shuffle {c['shuffle']}, not memcpyed, blocksize "
          f"{h['blocksize']}, ratio "
          f"{sum(map(len, data)) / sum(map(len, chunks))}", file=log)
    return chunks


def make_calls(config: dict, traffic: dict, seed: int, device,
               log=sys.stderr):
    """(data, calls): calls is a list of (key, fn, arg, bytes in), where
    the check finds the answer due for ``key``."""
    from cblosc_tpu_torch import api

    data = make_data(config, seed)
    c = config["codec"]
    op = traffic["op"]
    if op == "compress":
        doshuffle = filters.BY_NAME[c["shuffle"]].CODE

        def fn(chunk):
            return api.compress_ctx(c["clevel"], doshuffle,
                                    c["typesize"], chunk,
                                    compressor=c["cname"],
                                    blocksize=c["blocksize"], device=device)
        return data, [(k, fn, d, len(d)) for k, d in enumerate(data)]
    chunks = write_chunks(config, traffic, data, device, log)
    if op == "decompress":
        def fn(chunk):
            return api.decompress_ctx(chunk, device=device)
        return data, [(k, fn, ch, len(ch)) for k, ch in enumerate(chunks)]
    if op == "getitem":
        ts = c["typesize"]
        nitems = traffic["items"]
        rng = rng_for(seed, 1)
        ks = rng.integers(0, len(chunks), traffic["ranges"])
        starts = rng.integers(0, config["chunk_bytes"] // ts - nitems + 1,
                              traffic["ranges"])

        def fn(arg):
            return api.getitem(arg[0], arg[1], arg[2], device=device)
        return data, [((int(k), int(s), nitems), fn,
                       (chunks[k], int(s), nitems), len(chunks[k]))
                      for k, s in zip(ks, starts)]
    raise SystemExit(f"portbench: unknown op {op!r}")


def expected(config: dict, data: list[bytes], key) -> bytes:
    """The bytes due for a call's key: a whole chunk of data, or for
    getitem the items of its range."""
    if isinstance(key, tuple):
        k, start, nitems = key
        ts = config["codec"]["typesize"]
        return data[k][start * ts:(start + nitems) * ts]
    return data[key]
