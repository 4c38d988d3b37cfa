"""Shared reading of the program's own spans and counters (not a metric:
no entry of BENCHMARK.json names it).

The program records them (``cblosc_tpu_torch.utils.trace``) while a
profiler runs, as in a traced run. A checkout whose program has no such
module, or a run that is not traced, gives None, and every reader then
reports nothing.
"""

import numpy as np

from portbench import spans

STAGE = ("host_api.parse", "host_api.stage_in", "host_api.fetch",
         "host_api.assemble")
ROOTS = {"compress": "api.compress_ctx", "decompress": "api.decompress_ctx"}


def window_records(run):
    """The program's records of the traced window, or None."""
    if run.traced is None:
        return None
    try:
        from cblosc_tpu_torch.utils import trace
    except ImportError:
        return None
    recs = trace.records(run.traced.t0, run.traced.t1)
    return recs or None


def per_call(run, op: str, fn):
    """fn(records) over the records of the window's calls, per call;
    None where the run is not an ``op`` run or the program recorded
    nothing."""
    recs = window_records(run) if run.op == op else None
    if recs is None:
        return None
    calls = {r.call for r in recs if r.name == ROOTS[op]}
    if not calls:
        return None
    return fn([r for r in recs if r.call in calls]) / len(calls)


def total_count(recs, key: str) -> int:
    return sum(r.counts.get(key, 0) for r in recs if r.counts)


def stage_ms(run, op: str):
    """Per call, host ms in the byte API's parse, stage_in, fetch and
    assemble spans."""
    return per_call(run, op, lambda recs: sum(
        r.end_ns - r.start_ns for r in recs if r.name in STAGE) / 1e6)


def copy_amplification(run, op: str):
    """Bytes copied between host and card over the bytes the calls took
    and returned."""
    recs = window_records(run) if run.op == op else None
    moved = run.bytes_in + run.bytes_out
    if recs is None or not moved:
        return None
    return (total_count(recs, "h2d_bytes") +
            total_count(recs, "d2h_bytes")) / moved


def idle_ms(run, op: str, name: str):
    """Per call, ms inside the program's ``name`` spans in which the card
    ran nothing (the spans less the union of device activity in them)."""
    t = run.traced

    def idle(recs):
        iv = np.array([(r.start_ns, r.end_ns) for r in recs
                       if r.name == name], dtype=np.int64).reshape(-1, 2)
        busy = (spans._covered(t.busy_starts, t.busy_ends, iv[:, 1]) -
                spans._covered(t.busy_starts, t.busy_ends, iv[:, 0]))
        return float((iv[:, 1] - iv[:, 0] - busy).sum()) / 1e6
    return per_call(run, op, idle)
