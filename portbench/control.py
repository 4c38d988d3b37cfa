"""The correctness check's control and its readings; the benchmark's own
runs never run this.

    python3 portbench/control.py --workload <cell> --seeds 1,2,3 --seconds 3

For each seed, in one process, it runs the cell's window twice at the
cell's own sizes and load, each followed by the check of ``check.py``:
once with the program (a sound run: every number must read 0) and once
with the control in the program's place. The configurations state no
precision but one guarantee, losslessness, and the control breaks it as
a lossy codec would, by the step that would tempt a change made for
speed or ratio: one bit of precision less. Every typesize-wide word
loses its lowest significant bit (the lowest bit set in any word of the
chunk), as numcodecs' BitRound or Quantize filters would drop it:

- a write cell's control is the program's own ``compress_ctx`` fed the
  rounded words (a lossy writer);
- a read cell's control is the plain reference put in the program's
  place, its output rounded (a lossy reader); a getitem cell's, the
  same, its output the call's items of the reference's chunk, rounded.

The check has to read the control as not correct on every seed. Each
run prints one JSON line: cell, seed, side, calls and the numbers
compared.
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

import numpy as np

if __name__ == "__main__":
    sys.path[0] = str(Path(__file__).resolve().parents[1])

from portbench import check, harness, reference, traffic  # noqa: E402

_WORDS = {1: np.uint8, 2: np.uint16, 4: np.uint32, 8: np.uint64}


def drop_low_bit(data: bytes, typesize: int) -> bytes:
    """The bytes with the lowest bit set in any typesize-wide word
    cleared in every word (a trailing partial word is kept)."""
    dt = _WORDS[typesize]
    n = len(data) // typesize * typesize
    words = np.frombuffer(data[:n], dtype=dt).copy()
    used = np.bitwise_or.reduce(words) if words.size else dt(0)
    if used:
        low = int(used) & -int(used)
        words &= dt(~low & np.iinfo(dt).max)
    return words.tobytes() + data[n:]


def control_calls(spec: harness.Spec, calls: list) -> list:
    """The cell's calls with the control in the program's place."""
    ts = spec.config["codec"]["typesize"]
    op = spec.traffic["op"]
    if op == "compress":
        return [(key, fn, drop_low_bit(arg, ts), n)
                for key, fn, arg, n in calls]
    if op == "decompress":
        def lossy_reader(chunk):
            return drop_low_bit(reference.decompress(chunk), ts)
        return [(key, lossy_reader, arg, n) for key, _, arg, n in calls]
    if op == "getitem":
        def lossy_items(arg):
            chunk, start, nitems = arg
            items = reference.decompress(chunk)[start * ts:
                                                (start + nitems) * ts]
            return drop_low_bit(items, ts)
        return [(key, lossy_items, arg, n) for key, _, arg, n in calls]
    raise SystemExit(f"portbench: no control for op {op!r}")


def run_side(spec: harness.Spec, seed: int, seconds: float, device,
             control: bool, log=sys.stderr) -> dict:
    data, calls = traffic.make_calls(spec.config, spec.traffic, seed, device,
                                     log)
    if control:
        calls = control_calls(spec, calls)
    # the program's warm-up as in a run; the control's reads warm
    # nothing and its writes are the program's own calls
    warm = harness.warm_up(calls, 0 if control and spec.traffic["op"] !=
                           "compress" else spec.traffic["warmup_passes"])
    run = harness.Run(op=spec.traffic["op"])
    checker = check.Checker(
        harness.due_of(spec.traffic, spec.config, data, warm))
    harness.drive(calls, seconds, run, checker, log=log)
    checks = check.judge(spec.config, spec.traffic, data, calls, checker,
                         log)
    checks["failed_calls"] = {"value": run.failed, "limit": 0}
    return {"cell": spec.cell["name"], "seed": seed,
            "side": "control" if control else "program", "calls": run.calls,
            "correct": all(c["value"] <= c["limit"] for c in checks.values()),
            "check": {k: c["value"] for k, c in checks.items()}}


def main(argv=None) -> int:
    import argparse

    import torch

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=3.0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("portbench control: no CUDA device", file=sys.stderr)
        return 3
    device = torch.device("cuda", 0)
    spec = harness.load_spec(args.workload)
    for seed in (int(s) for s in args.seeds.split(",")):
        for control in (False, True):
            print(json.dumps(run_side(spec, seed, args.seconds, device,
                                      control)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
