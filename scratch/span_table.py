"""A traced run of one cell, as portbench/run.py --trace 1 makes it, that
also writes the device-idle time by the program's innermost open span
(utils/trace.py) and each span's self and idle ms per call.

    python3 scratch/span_table.py --workload <cell> --seed <n> --seconds 51 --out <file.json>

stdout: the harness's result line; --out: the table.
"""

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from portbench import harness, spans  # noqa: E402
from cblosc_tpu_torch.utils import trace  # noqa: E402


def table(t, recs, calls: int) -> dict:
    bs, be = t.busy_starts, t.busy_ends
    iv = np.array([(r.start_ns, r.end_ns) for r in recs],
                  dtype=np.int64).reshape(-1, 2)
    depth = {}
    for r in recs:
        depth[r.index] = depth.get(r.parent, -1) + 1
    # idle gaps of the window, less the paused check, by the innermost
    # program span open at each gap's midpoint
    gs = np.concatenate(([t.t0], be))
    ge = np.concatenate((bs, [t.t1]))
    keep = ge > gs
    gs, ge = gs[keep], ge[keep]
    ps, pe = t.paused_starts, t.paused_ends
    idle = (ge - gs) - (spans._covered(ps, pe, ge) - spans._covered(ps, pe, gs))
    mid = (gs + ge) // 2
    best = np.full(mid.size, -1)
    best_depth = np.full(mid.size, -1)
    for k, r in enumerate(recs):
        lo, hi = np.searchsorted(mid, [r.start_ns, r.end_ns])
        d = depth[r.index]
        sel = slice(lo, hi)
        take = best_depth[sel] < d
        best[sel] = np.where(take, k, best[sel])
        best_depth[sel] = np.where(take, d, best_depth[sel])
    by_gap: dict = {}
    for k, ns in zip(best, idle):
        name = recs[k].name if k >= 0 else "no program span"
        by_gap[name] = by_gap.get(name, 0) + int(ns)
    child: dict = {}
    for r in recs:
        if r.parent >= 0:
            child[r.parent] = child.get(r.parent, 0) + r.end_ns - r.start_ns
    busy_in = spans._covered(bs, be, iv[:, 1]) - spans._covered(bs, be, iv[:, 0])
    per: dict = {}
    for k, r in enumerate(recs):
        row = per.setdefault(r.name, {"n": 0, "ms": 0.0, "self_ms": 0.0,
                                      "idle_ms": 0.0, "counts": {}})
        dur = r.end_ns - r.start_ns
        row["n"] += 1
        row["ms"] += dur / 1e6
        row["self_ms"] += (dur - child.get(r.index, 0)) / 1e6
        row["idle_ms"] += (dur - int(busy_in[k])) / 1e6
        for key, v in (r.counts or {}).items():
            row["counts"][key] = row["counts"].get(key, 0) + v
    for row in per.values():
        for key in ("ms", "self_ms", "idle_ms"):
            row[key + "_per_call"] = row.pop(key) / calls
        row["counts_per_call"] = {k: v / calls
                                  for k, v in row.pop("counts").items()}
    return {"calls": calls, "window_s": t.window_s, "busy_s": t.busy_s,
            "idle_s_by_innermost_span": sorted(
                ((n, ns / 1e9) for n, ns in by_gap.items()),
                key=lambda x: -x[1]),
            "spans_per_call": per, "ring_dropped": trace.RING.dropped}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--out", required=True)
    args = ap.parse_args()
    spec = harness.load_spec(args.workload)
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    got = {}
    stop = spans.Tracer.stop

    def keep(self, log=sys.stderr):
        got["trace"] = tr = stop(self, log)
        return tr
    spans.Tracer.stop = keep
    line = harness.run_cell(spec, args.seed, args.seconds, True, device)
    t = got["trace"]
    recs = trace.records(t.t0, t.t1)
    out = table(t, recs, line["attempted"])
    out.update(cell=args.workload, seed=args.seed, card=harness.card_line(),
               correct=line["correct"])
    Path(args.out).write_text(json.dumps(out, indent=1))
    return harness.emit(line)


if __name__ == "__main__":
    sys.exit(main())
