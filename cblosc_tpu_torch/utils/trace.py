"""Spans and counters inside the port, on the profiler's clock.

The port's one span system. A span is a ``with span(name):`` block in a
function body; ``count(key, n)`` adds to the innermost open span. Each
finished span keeps a :class:`Record`: its name, its start and end in
``time.time_ns()`` (the clock ``torch.profiler`` stamps its device events
with, so spans and device activity line up), the index of its parent
span (-1 for a root), a call id that every span of one top-level call
shares, and its counts. Records go to a bounded ring (:data:`RING`) that
drops the oldest past :data:`CAPACITY` and counts what it dropped.

Spans and counts are recorded only while a ``torch.profiler`` profile is
running (``torch.autograd.profiler._is_profiler_enabled``, read at each
call; ``profile.start()`` sets it whatever the profile's activities):
otherwise ``span`` returns one shared no-op context and ``count`` returns
at once, so the port records and allocates nothing per span.

Spans (``<module>.<phase>``), from the byte API down:

- ``api.compress_ctx``, ``api.decompress_ctx``, ``api.getitem``: the
  roots; each counts the route that served it, ``route.device``,
  ``route.native`` or ``route.numpy`` (1);
- ``host_api.parse`` (reads): header, its validation, bstarts, the split
  table;
- ``host_api.stage_in``: the host copies and the copies to the device of
  the blocks (writes) or of the chunk, its offsets and csizes (reads);
  counts ``h2d_bytes``;
- ``host_api.err_check`` (reads): a read-back of the decoder's error
  flags; counts ``d2h_bytes`` and, where a row erred at the default
  budget, ``erred_rows`` and ``retried_rows`` (the rows the escalated
  pass decodes again);
- ``host_api.fetch``: the body's compaction and its copy off the device
  with the csizes (writes), the decoded blocks' copy (reads); counts
  ``d2h_bytes``;
- ``host_api.assemble``: the leftover block, bstarts, header and the
  bytes returned;
- ``pipeline.compress_blocks``, ``pipeline.decompress_blocks`` (counts
  ``budget``: 0 at the codec's default, else the escalated one),
  ``pipeline.gather``, ``pipeline.encode_group``,
  ``pipeline.decode_group``, ``filters.apply``, ``filters.undo``;
- ``codec.mine_group``: counts ``rows`` and, on the card, ``launches``
  (1: the mining kernel); on the CPU it holds ``mine.prefix``,
  ``mine.fold`` and ``mine.verify``, the plain version's stages.

Bytes are counted from tensors' ``nbytes``, the same on the CPU as on
the card. ``utils/profile.py`` prints these records per profiled call.
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import threading
import time

from torch.autograd import profiler as _profiler

CAPACITY = 1 << 18

Record = collections.namedtuple(
    "Record", "index name start_ns end_ns parent call counts")


class Ring:
    """The newest ``capacity`` records, as plain tuples in
    :class:`Record`'s order; ``dropped`` counts the older ones it let
    go."""

    def __init__(self, capacity: int) -> None:
        self.records: collections.deque = collections.deque(maxlen=capacity)
        self.dropped = 0
        self._lock = threading.Lock()

    def add(self, rec: tuple) -> None:
        with self._lock:
            if len(self.records) == self.records.maxlen:
                self.dropped += 1
            self.records.append(rec)

    def snapshot(self) -> list:
        with self._lock:
            return list(self.records)

    def clear(self) -> None:
        with self._lock:
            self.records.clear()
            self.dropped = 0


RING = Ring(CAPACITY)
_OFF = contextlib.nullcontext()
_index = itertools.count()
_calls = itertools.count()
_local = threading.local()


class _Span:
    __slots__ = ("name", "index", "parent", "call", "counts", "start")

    def __init__(self, name: str) -> None:
        self.name = name

    def __enter__(self):
        stack = getattr(_local, "stack", None)
        if stack is None:
            stack = _local.stack = []
        up = stack[-1] if stack else None
        self.index = next(_index)
        self.parent = up.index if up else -1
        self.call = up.call if up else next(_calls)
        self.counts = None
        stack.append(self)
        self.start = time.time_ns()
        return self

    def __exit__(self, *exc) -> None:
        end = time.time_ns()
        _local.stack.pop()
        RING.add((self.index, self.name, self.start, end, self.parent,
                  self.call, self.counts))


def span(name: str):
    """A context that records a span named ``name`` while a profiler
    runs, else the shared no-op context."""
    if not _profiler._is_profiler_enabled:
        return _OFF
    return _Span(name)


def count(key: str, n) -> None:
    """Add ``n`` to the innermost open span's count ``key``. ``n`` is an
    int, or a tensor whose sum is read back only while recording."""
    if not _profiler._is_profiler_enabled:
        return
    stack = getattr(_local, "stack", None)
    if not stack:
        return
    sp = stack[-1]
    if not isinstance(n, int):
        n = int(n.sum())
    if sp.counts is None:
        sp.counts = {}
    sp.counts[key] = sp.counts.get(key, 0) + n


def records(t0_ns: int | None = None, t1_ns: int | None = None) -> list:
    """The ring's records, in the order their spans opened, kept to those
    that start at ``t0_ns`` or later and end by ``t1_ns``."""
    lo = -1 if t0_ns is None else t0_ns
    hi = float("inf") if t1_ns is None else t1_ns
    return [Record._make(r) for r in sorted(RING.snapshot())
            if r[2] >= lo and r[3] <= hi]


def clear() -> None:
    RING.clear()
