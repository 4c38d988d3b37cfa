"""The benchmark's harness: one cell, one run.

Everything a cell needs is found by name from ``BENCHMARK.json``: its
configuration file (``file``), its traffic mix
(``portbench/traffic/<traffic>.json``) and one reader per metric
(``portbench/metrics/<metric>.py``, a ``read(run)`` function that returns
a number, or None where it finds nothing to read). The codec and the
filter a configuration names are found by name too, in the plain
reference (``portbench/codecs/``, ``portbench/filters/``) and in the
frozen writer (``portbench/writer/``, each codec a source of its own).
Adding a configuration, a codec, a filter, a mix or a metric adds files
and entries and edits none.

A run: make the cell's data from the seed (``traffic.make_calls``), warm
up (``warmup_passes`` passes over the inputs), then drive one client in
a closed loop over the inputs for the window, each call waiting for the
one before, as a python-blosc or numcodecs caller does; then judge what the window
returned against the plain reference (``check.py``) and print one JSON
line. With tracing on, spans around the program's layers and a CUDA
profile of the window feed the per-layer readers (``spans.py``).
"""

from __future__ import annotations

import importlib.util
import json
import subprocess
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

# top-level module names no run may hold once its window has closed:
# JAX, its libraries, and the JAX package the program was ported from
BANNED_MODULES = ("jax", "jaxlib", "flax", "cblosc_tpu")


def banned_modules(names=None) -> list[str]:
    """The banned top-level names among loaded modules, compared whole:
    ``cblosc_tpu_torch`` is not ``cblosc_tpu``."""
    names = sys.modules if names is None else names
    return sorted({n.split(".")[0] for n in names} & set(BANNED_MODULES))


@dataclass
class Spec:
    """One cell, resolved: its entry, configuration, traffic mix, and the
    metrics it reports with the path of each reader."""
    cell: dict
    config: dict
    traffic: dict
    end_to_end: list
    per_layer: list
    root: Path


def _by_name(entries: list, name: str, what: str) -> dict:
    for e in entries:
        if e["name"] == name:
            return e
    raise SystemExit(f"portbench: no {what} named {name!r} in BENCHMARK.json")


def _applies(metric: dict, cell: str, moves: set | None = None) -> bool:
    if "workloads" in metric:
        return cell in metric["workloads"]
    return moves is None or metric["moves"] in moves


def load_spec(workload: str, root: Path = ROOT) -> Spec:
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cell = _by_name(bench["workloads"], workload, "workload")
    entry = _by_name(bench["configs"], cell["config"], "configuration")
    config = json.loads((root / entry["file"]).read_text())
    mix = root / "portbench" / "traffic" / f"{cell['traffic']}.json"
    traffic = json.loads(mix.read_text())
    e2e = [m for m in bench["end_to_end"] if _applies(m, workload)]
    moves = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"] if _applies(m, workload, moves)]
    for m in e2e + per_layer:
        path = root / "portbench" / "metrics" / f"{m['name']}.py"
        if not path.is_file():
            raise SystemExit(f"portbench: metric {m['name']} has no reader "
                             f"at {path}")
    return Spec(cell, config, traffic, e2e, per_layer, root)


def reader(spec: Spec, name: str):
    path = spec.root / "portbench" / "metrics" / f"{name}.py"
    mod_name = "portbench_metric_" + "".join(
        c if c.isalnum() else "_" for c in name)
    mspec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(mspec)
    mspec.loader.exec_module(mod)
    return mod.read


def process_start_s() -> float:
    """Seconds since this process started (its start time in
    /proc/self/stat against the boot-time clock)."""
    import os

    with open("/proc/self/stat") as f:
        fields = f.read().rsplit(")", 1)[1].split()
    start = int(fields[19]) / os.sysconf("SC_CLK_TCK")
    return time.clock_gettime(time.CLOCK_BOOTTIME) - start


@dataclass
class Run:
    """What one run measured, handed to every metric reader."""
    op: str
    calls: int = 0
    failed: int = 0
    latencies_s: list = field(default_factory=list)
    bytes_in: int = 0          # bytes handed to the calls that completed
    bytes_out: int = 0         # bytes they returned
    completed: dict = field(default_factory=dict)   # key -> calls completed
    inputs: dict = field(default_factory=dict)      # key -> the call's input
    window_s: float = 0.0
    setup_s: float = 0.0
    launches: dict = field(default_factory=dict)     # gpu.kernels.LAUNCHES
    engine_calls: dict = field(default_factory=dict)  # core.backend.CALLS
    traced: object = None      # spans.Trace in a traced run


def warm_up(calls, passes: int) -> dict:
    """Every call of the list ``passes`` times, which touches every shape
    the window will use; returns the last pass's answers by key."""
    last = {}
    for _ in range(passes):
        for key, fn, arg, _ in calls:
            last[key] = fn(arg)
    return last


def due_of(mix: dict, config: dict, data: list, warm: dict):
    """key -> the bytes a call is due to return: for a write, the chunk
    the warm-up wrote for the same data (which the check's reference
    decodes); for a read, the data."""
    from . import traffic

    if mix["op"] == "compress":
        return warm.__getitem__
    return lambda key: traffic.expected(config, data, key)


def drive(calls, seconds: float, run: Run, checker, tracer=None,
          log=sys.stderr) -> None:
    """The closed loop: call after call over ``calls`` (a list of
    (key, fn, arg, nbytes_in)) until the window holds ``seconds`` and
    two calls at least, so that a call that returns an earlier call's
    answer shows also in the shortest window. Each
    call's latency runs from its start to the return of its bytes. The
    window runs from the first call's start to the last call's end, less
    the time the check spends comparing each answer between two calls
    (``checker.add``): its clock stops around the comparison, which is
    the benchmark's work and not the program's."""
    n = len(calls)
    i = 0
    checking = 0.0
    t0 = time.perf_counter()
    window = 0.0
    while window < seconds or i < 2:
        key, fn, arg, nin = calls[i % n]
        a = time.perf_counter()
        try:
            out = fn(arg)
        except Exception as e:          # the call failed; the run goes on
            end = time.perf_counter()
            run.failed += 1
            if run.failed == 1:
                import traceback

                traceback.print_exc(file=log)
                print(f"portbench: call {i} failed: {e!r}", file=log)
            out = None
        else:
            end = time.perf_counter()
            run.latencies_s.append(end - a)
            run.bytes_in += nin
            run.bytes_out += len(out)
            run.completed[key] = run.completed.get(key, 0) + 1
        window = end - t0 - checking
        h0 = time.time_ns() if tracer else 0
        checker.add(key, out)
        if tracer:
            tracer.paused.append((h0, time.time_ns()))
        checking += time.perf_counter() - end
        i += 1
    run.calls = i
    run.window_s = window


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi reads them."""
    try:
        res = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        return res.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "nvidia-smi unavailable"


def device_info(device, trace=None) -> dict:
    import torch

    if device.type == "cuda":
        info = {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
                "count": 1,
                "memory_peak_bytes": torch.cuda.max_memory_allocated(device)}
    else:       # the CPU tests' in-process runs; main() never gets here
        info = {"platform": "cpu", "kind": "cpu", "count": 1,
                "memory_peak_bytes": 0}
    if trace is not None:
        info["busy_s"] = trace.busy_s
        info["window_s"] = trace.window_s
    return info


def run_cell(spec: Spec, seed: int, seconds: float, trace: bool, device,
             log=sys.stderr) -> dict:
    """One run of a cell on ``device``; returns the result line's object,
    ``check`` last."""
    from . import check, traffic
    from .spans import Tracer

    import torch

    from cblosc_tpu_torch.core import backend
    from cblosc_tpu_torch.gpu import kernels

    data, calls = traffic.make_calls(spec.config, spec.traffic, seed, device,
                                     log)
    warm = warm_up(calls, spec.traffic["warmup_passes"])
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    run = Run(op=spec.traffic["op"],
              inputs={key: arg for key, _, arg, _ in calls})
    checker = check.Checker(due_of(spec.traffic, spec.config, data, warm))
    kernels.reset_launches()
    backend.reset_calls()
    tracer = Tracer(device) if trace else None
    run.setup_s = process_start_s()
    if tracer:
        tracer.start()
    drive(calls, seconds, run, checker, tracer, log)
    if tracer:
        run.traced = tracer.stop(log)
    run.launches = dict(kernels.LAUNCHES)
    run.engine_calls = dict(backend.CALLS)
    device_line = device_info(device, run.traced)

    metrics = {}
    for m in (spec.per_layer if trace else spec.end_to_end):
        value = reader(spec, m["name"])(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    print(f"portbench: {spec.cell['name']} seed {seed}: {run.calls} calls, "
          f"{run.failed} failed, window {run.window_s} s, set-up "
          f"{run.setup_s} s; launches {run.launches}; host-engine calls "
          f"{run.engine_calls}", file=log)

    checks = check.judge(spec.config, spec.traffic, data, calls, checker,
                         log)
    checks["failed_calls"] = {"value": run.failed, "limit": 0}
    correct = all(c["value"] <= c["limit"] for c in checks.values())
    line = {"correct": correct, "attempted": run.calls, "failed": run.failed,
            "metrics": metrics, "device": device_line}
    if tracer:
        line["breakdown"] = run.traced.breakdown
    line["check"] = checks
    return line


def emit(line: dict, out=sys.stdout, log=sys.stderr) -> int:
    """Print the numbers compared, each with its limit, as the last lines
    of ``log`` and the result as the last line of ``out``; print no
    result, and return nonzero, where the process holds JAX or the JAX
    package."""
    found = banned_modules()
    if found:
        print(f"portbench: the run loaded {found}; nothing it runs may "
              "import JAX or the JAX package", file=log)
        return 4
    for name, c in line["check"].items():
        print(f"check {name}: {c['value']} (limit {c['limit']})", file=log)
    print(json.dumps(line), file=out)
    return 0


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    spec = load_spec(args.workload)

    import torch

    if not torch.cuda.is_available():
        print("portbench: no CUDA device (torch.cuda.is_available() is "
              "False); the benchmark measures the card only", file=sys.stderr)
        return 3
    if torch.cuda.device_count() < spec.cell["chips"]:
        print(f"portbench: the cell needs {spec.cell['chips']} cards, "
              f"{torch.cuda.device_count()} present", file=sys.stderr)
        return 3
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    print(f"portbench: card {card_line()}; peak HBM bandwidth taken as "
          "3.35 TB/s (H100 SXM data sheet)", file=sys.stderr)
    line = run_cell(spec, args.seed, args.seconds, bool(args.trace), device)
    return emit(line)
