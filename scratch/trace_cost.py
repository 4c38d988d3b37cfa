"""On-cost of the port's spans on the card: the benchmark's calls of each
cell under a CUDA-only profile (as a --trace 1 run has), with
utils/trace.py's profiler flag patched off or left on, alternating call
by call; plus the cost of one span alone. One JSON line per cell.

    python3 scratch/trace_cost.py [--passes 10] [cell ...]
"""

import argparse
import io
import json
import statistics
import sys
import time
import types
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

from portbench import harness, traffic  # noqa: E402
from cblosc_tpu_torch.utils import trace  # noqa: E402

OFF = types.SimpleNamespace(_is_profiler_enabled=False)


def span_us(n=100_000) -> float:
    """us per span with a count, recording (the profiler running)."""
    t = time.perf_counter()
    for _ in range(n):
        with trace.span("x"):
            trace.count("k", 1)
    dt = time.perf_counter() - t
    trace.clear()
    return dt / n * 1e6


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--passes", type=int, default=10)
    ap.add_argument("--seed", type=int, default=2147485014)
    ap.add_argument("--cpu-rehearsal", action="store_true")
    ap.add_argument("cells", nargs="*")
    args = ap.parse_args()
    if args.cpu_rehearsal:
        dev, card = torch.device("cpu"), "cpu"
    else:
        dev = torch.device("cuda", 0)
        torch.cuda.set_device(dev)
        card = harness.card_line()
    real = trace._profiler
    cells = args.cells or [w["name"] for w in json.loads(
        (ROOT / "BENCHMARK.json").read_text())["workloads"]]
    for cell in cells:
        spec = harness.load_spec(cell)
        if args.cpu_rehearsal:
            spec.config["chunk_bytes"] = 16 << 10
            spec.config["working_set_chunks"] = 2
        _, calls = traffic.make_calls(spec.config, spec.traffic, args.seed,
                                      dev, io.StringIO())
        harness.warm_up(calls, 2)
        if dev.type == "cuda":
            torch.cuda.synchronize()
        lat = {"on": {}, "off": {}}
        prof = profile(activities=[ProfilerActivity.CUDA
                                   if dev.type == "cuda"
                                   else ProfilerActivity.CPU])
        prof.start()
        trace.clear()
        spans = 0
        try:
            for p in range(args.passes):
                for i, (key, fn, arg, _) in enumerate(calls):
                    side = "on" if (i + p) % 2 == 0 else "off"
                    trace._profiler = real if side == "on" else OFF
                    t = time.perf_counter()
                    fn(arg)
                    lat[side].setdefault(key, []).append(
                        time.perf_counter() - t)
                spans += len(trace.records())
                trace.clear()
            trace._profiler = real
            one = span_us()
        finally:
            trace._profiler = real
            prof.stop()
        on_calls = sum(len(v) for v in lat["on"].values())
        diffs = [statistics.mean(lat["on"][k]) - statistics.mean(lat["off"][k])
                 for k in lat["on"] if k in lat["off"]]
        print(json.dumps({
            "cell": cell, "card": card, "passes": args.passes,
            "on_ms_median": statistics.median(
                x for v in lat["on"].values() for x in v) * 1e3,
            "off_ms_median": statistics.median(
                x for v in lat["off"].values() for x in v) * 1e3,
            "paired_diff_ms_mean": statistics.mean(diffs) * 1e3,
            "paired_diff_ms_quartiles": [
                q * 1e3 for q in statistics.quantiles(diffs, n=4)],
            "spans_per_call": spans / on_calls,
            "span_us": one,
            "span_cost_ms_per_call": spans / on_calls * one / 1e3,
        }), flush=True)


if __name__ == "__main__":
    main()
