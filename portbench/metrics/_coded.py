"""Shared arithmetic of the readers of the zlib read and getitem cells
(not a metric: no entry of BENCHMARK.json names it): the work the
window's input chunks hold, counted from the chunks by the plain
reference and not by the program, and the program's records of its
getitem calls."""

from portbench import reference
from portbench.metrics import _program


def coded_bytes(chunk: bytes, codec: str):
    """Over the splits of a chunk of ``codec`` that are not stored raw,
    their stream bytes (csize) and the bytes they decode to (neblock);
    None for a chunk of another codec, or a memcpyed one."""
    h = reference.header(chunk)
    if h["memcpyed"] or h["codec"] != codec:
        return None
    return sum(csize + neblock
               for _, splits in reference.split_table(chunk, h)
               for _, csize, neblock in splits if csize != neblock)


def window_coded_bytes(run, codec: str):
    """coded_bytes over every call the window completed; None where a
    call's input is not a whole chunk of ``codec``."""
    total = 0
    for key, times in run.completed.items():
        chunk = run.inputs[key]
        if not isinstance(chunk, bytes):
            return None
        n = coded_bytes(chunk, codec)
        if n is None:
            return None
        total += times * n
    return total


def device_s_launched_in(run, root: str, name: str):
    """Seconds of device activity launched inside the program's own
    ``name`` spans in the traced window; None where the program's records
    hold no such span, or not one ``root`` for every call of the window
    (its ring dropped the oldest)."""
    recs = _program.window_records(run)
    if recs is None or sum(r.name == root for r in recs) != run.calls:
        return None
    iv = [(r.start_ns, r.end_ns) for r in recs if r.name == name]
    if not iv:
        return None
    starts, ends = zip(*iv)
    return run.traced.device_s_launched_in(starts, ends)


def getitem_records(run):
    """The program's records of the traced window's getitem calls (their
    ``api.getitem`` roots and all below them), and the number of calls;
    None where the run is not a getitem run or nothing was recorded."""
    recs = _program.window_records(run) if run.op == "getitem" else None
    if recs is None:
        return None
    calls = {r.call for r in recs if r.name == "api.getitem"}
    if not calls:
        return None
    return [r for r in recs if r.call in calls], len(calls)
