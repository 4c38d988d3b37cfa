"""How ``correct`` is decided: the window's answers against the data and
the plain reference (``reference.py``).

A ``Checker`` compares every answer of the window as it returns with
the bytes due: for a read, the data its chunk was written from; for a
write, the chunk the program wrote for the same data in the warm-up.
That comparison allocates nothing and keeps nothing but the rare answer
that differs: holding the window's answers would make the program take
fresh memory, and fault in its pages, call after call, which is not the
program's own cost. The harness stops the window's clock around it
(``harness.drive``). Once the window has closed, ``judge`` runs the
reference and counts. The configurations promise lossless chunks of
their codec and filter, so every number compared is a count with the
limit 0:

- ``wrong_bytes``: bytes of the window's answers that differ from what was
  due. A read's answer counts its differing bytes. A write's answer
  counts the bytes of the data that the reference's decode of it gets
  wrong (all of them where the reference cannot read it): an answer
  equal to the warm-up's chunk counts that chunk's, which the reference
  decodes once; every chunk the warm-up wrote is decoded and counts at
  least once, also where the window did not reach its data.
- ``wrong_headers`` (writes): chunks of the window whose header names another
  codec, filter, typesize or size than the configuration's.
- ``input_wrong_bytes`` (reads): the reference's decode of every input
  chunk against its data, so that what a read is held to is what its
  chunk holds.
- ``failed_calls``: calls of the window that raised (harness.py).
"""

from __future__ import annotations

import hashlib
import sys
import time

import numpy as np

from . import codecs, reference, traffic


class Checker:
    """The check's part of the window: compare, keep what differs (each
    distinct wrong answer once, with the number of times it came)."""

    def __init__(self, due):
        self.due = due                      # key -> the bytes due
        self.equal: dict = {}               # key -> answers as due
        self.differing: dict = {}           # (key, digest) -> [answer, n]

    def add(self, key, out) -> None:
        if out is not None and out == self.due(key):
            self.equal[key] = self.equal.get(key, 0) + 1
            return
        digest = None if out is None else hashlib.sha1(out).digest()
        self.differing.setdefault((key, digest), [out, 0])[1] += 1

    def wrong_answers(self):
        """(key, answer or None, times) of the answers not as due."""
        return [(k, out, n) for (k, _), (out, n) in self.differing.items()]

    @property
    def compared(self) -> int:
        return (sum(self.equal.values())
                + sum(n for _, n in self.differing.values()))


def wrong_count(got, due: bytes) -> int:
    """Bytes of ``due`` that ``got`` does not reproduce; an answer of
    another length counts the difference too."""
    if got is None:
        return len(due)
    a = np.frombuffer(got, dtype=np.uint8)
    b = np.frombuffer(due, dtype=np.uint8)
    n = min(a.size, b.size)
    return int(np.count_nonzero(a[:n] != b[:n])) + abs(a.size - b.size)


def decoded_wrong(chunk: bytes, due: bytes) -> int:
    """wrong_count of the reference's decode of a chunk; all of ``due``
    where the reference cannot read it."""
    try:
        return wrong_count(reference.decompress(chunk), due)
    except reference.ChunkError:
        return len(due)


def header_wrong(chunk, config: dict, nbytes: int) -> bool:
    """Whether a chunk's header names another codec, filter, typesize or
    size than the configuration's (any codec where it is memcpyed)."""
    c = config["codec"]
    try:
        h = reference.header(chunk)
    except reference.ChunkError:
        return True
    wire = codecs.BY_CNAME.get(c["cname"])
    return (h["version"] != 2 or h["nbytes"] != nbytes
            or h["typesize"] != c["typesize"]
            or h["filter"] != c["shuffle"]
            or (not h["memcpyed"] and (
                wire is None or h["compformat"] != wire.COMPFORMAT)))


def judge(config: dict, mix: dict, data: list[bytes], calls: list,
          checker: Checker, log=sys.stderr) -> dict:
    """The numbers compared, each with its limit, from the checker's
    record of the window; the reference runs here, after the window."""
    t0 = time.perf_counter()
    wrong = 0
    decodes = 0
    out = {}
    if mix["op"] == "compress":
        bad_headers = 0
        for key in range(len(data)):
            # every chunk the warm-up wrote, once, and once more for each
            # answer of the window equal to it
            times = max(1, checker.equal.get(key, 0))
            due = checker.due(key)
            wrong += times * decoded_wrong(due, data[key])
            bad_headers += times * header_wrong(due, config, len(data[key]))
            decodes += 1
        for key, chunk, times in checker.wrong_answers():
            if chunk is None:
                continue            # a call that raised: failed_calls
            wrong += times * decoded_wrong(chunk, data[key])
            decodes += 1
            bad_headers += times * header_wrong(chunk, config,
                                                len(data[key]))
        out["wrong_bytes"] = {"value": wrong, "limit": 0}
        out["wrong_headers"] = {"value": bad_headers, "limit": 0}
    else:
        for key, got, times in checker.wrong_answers():
            if got is not None:
                wrong += times * wrong_count(
                    got, traffic.expected(config, data, key))
        out["wrong_bytes"] = {"value": wrong, "limit": 0}
        inputs = {}
        for key, _, arg, _ in calls:
            k = key[0] if isinstance(key, tuple) else key
            inputs[k] = arg[0] if isinstance(arg, tuple) else arg
        out["input_wrong_bytes"] = {
            "value": sum(decoded_wrong(inputs[k], data[k]) for k in inputs),
            "limit": 0}
        decodes = len(inputs)
    wrong_answers = sum(n for _, _, n in checker.wrong_answers())
    print(f"portbench: check: {checker.compared} answers compared, "
          f"{wrong_answers} not as due, {decodes} reference decodes, "
          f"{time.perf_counter() - t0} s", file=log)
    return out
