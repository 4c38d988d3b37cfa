"""The harness on the CPU: its cells resolve by name from data files, a
tiny in-process pass of each cell prints the contract's line, and the
module guard compares top-level names whole.

    python -m pytest portbench/tests -q
"""

import hashlib
import io
import json
import os
import shutil
import subprocess
import sys
import types
from pathlib import Path

import pytest
import torch

from portbench import harness

ROOT = Path(__file__).resolve().parents[2]
CELLS = [w["name"] for w in
         json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]]
CPU = torch.device("cpu")
SEED = 2**31 + 977          # a seed past 32 signed bits


def tiny(spec, chunk_bytes=32 << 10, chunks=3):
    """The cell at a size the CPU's plain kernels run in seconds."""
    spec.config["chunk_bytes"] = chunk_bytes
    spec.config["working_set_chunks"] = chunks
    return spec


def chunk_size(cell: str) -> int:
    # the plain LZ4 walk is slow on the CPU: the C-blosc-written read cell
    # gets 16 KiB chunks (one block of 8 dense and sparse 2 KiB splits)
    return 16 << 10 if cell == "zarr-lz4-c5.read" else 32 << 10


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("cell", CELLS)
def test_tiny_pass_prints_the_contract_line(cell, trace):
    spec = tiny(harness.load_spec(cell), chunk_size(cell))
    line = harness.run_cell(spec, SEED, 0.3, bool(trace), CPU,
                            log=io.StringIO())
    assert line["correct"] is True, line["check"]
    assert line["attempted"] >= 1 and line["failed"] == 0
    keys = ["correct", "attempted", "failed", "metrics", "device"]
    keys += ["breakdown"] if trace else []
    assert list(line) == keys + ["check"]
    assert set(line["device"]) >= {"platform", "kind", "count",
                                   "memory_peak_bytes"}
    if trace:
        assert set(line["device"]) >= {"busy_s", "window_s"}
        assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
        # the CPU has no device trace: the rooflines find nothing to read
        want = {m["name"] for m in spec.per_layer
                if "roofline" not in m["name"]}
    else:
        want = {m["name"] for m in spec.end_to_end}
    assert set(line["metrics"]) == want
    for m in line["metrics"].values():
        assert set(m) == {"value", "unit"}
    out, err = io.StringIO(), io.StringIO()
    assert harness.emit(line, out, err) == 0
    assert json.loads(out.getvalue().splitlines()[-1]) == line
    assert err.getvalue().splitlines()[-1].startswith("check failed_calls")


def test_same_seed_same_inputs_and_every_seed_same_sizes():
    from portbench import traffic

    spec = tiny(harness.load_spec("pyblosc-blosclz-c9.read"))
    a = traffic.make_calls(spec.config, spec.traffic, SEED, CPU,
                           io.StringIO())
    b = traffic.make_calls(spec.config, spec.traffic, SEED, CPU,
                           io.StringIO())
    c = traffic.make_calls(spec.config, spec.traffic, -5, CPU, io.StringIO())
    assert a[0] == b[0] and [x[2] for x in a[1]] == [x[2] for x in b[1]]
    assert a[0] != c[0] and list(map(len, a[0])) == list(map(len, c[0]))


def test_every_answer_is_compared_off_the_window_clock():
    import time

    from portbench import check

    calls = [(k, lambda x: x, bytes([k]) * 8, 8) for k in range(3)]
    due = {0: b"x" * 8, 1: bytes([1]) * 8, 2: bytes([9]) * 8}
    checker = check.Checker(due.__getitem__)
    slow_add = checker.add

    def add(key, out):
        time.sleep(0.01)
        slow_add(key, out)
    checker.add = add
    run = harness.Run(op="decompress")
    harness.drive(calls, 0.05, run, checker, log=io.StringIO())
    assert checker.compared == run.calls > 10
    # the comparisons slept longer than the window, which leaves them out
    assert run.window_s < 0.06 < 0.01 * run.calls
    wrong = {k: n for k, _, n in checker.wrong_answers()}
    assert set(wrong) == {0, 2} and sum(checker.equal.values()) == \
        run.calls - sum(wrong.values())


def _digests(root: Path) -> dict:
    files = [root / "BENCHMARK.json", *sorted((root / "portbench").rglob("*"))]
    return {str(f.relative_to(root)):
            hashlib.sha256(f.read_bytes()).hexdigest()
            for f in files if f.is_file() and "__pycache__" not in f.parts}


def test_new_config_mix_and_metric_need_only_new_files(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = _digests(tmp_path)
    pb = tmp_path / "portbench"
    (pb / "configs" / "arange-lz4-c5.json").write_text(json.dumps({
        "name": "arange-lz4-c5",
        "codec": {"cname": "lz4", "clevel": 5, "shuffle": "SHUFFLE",
                  "typesize": 4, "blocksize": 0},
        "data": {"generator": "arange", "dtype": "int32"},
        "chunk_bytes": 16384, "working_set_chunks": 2}))
    (pb / "traffic" / "read_twice.json").write_text(json.dumps({
        "op": "decompress", "chunks_written_by": "program",
        "warmup_passes": 2}))
    (pb / "metrics" / "output_MB.py").write_text(
        "def read(run):\n    return run.bytes_out / 1e6\n")
    bench = json.loads((tmp_path / "BENCHMARK.json").read_text())
    bench["configs"].append({
        "name": "arange-lz4-c5", "source": "https://example.org/arange",
        "file": "portbench/configs/arange-lz4-c5.json", "reduced": [],
        "why": "a test"})
    bench["workloads"].append({
        "name": "arange-lz4-c5.read", "config": "arange-lz4-c5",
        "traffic": "read_twice", "chips": 1, "why": "a test"})
    bench["end_to_end"].append({
        "name": "output_MB", "unit": "MB", "better": "higher", "bound": 0.1,
        "source": "host_clock", "workloads": ["arange-lz4-c5.read"]})
    bench["end_to_end"][1]["workloads"].append("arange-lz4-c5.read")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))

    after = _digests(tmp_path)
    changed = {f for f in before if after.get(f) != before[f]}
    assert changed == {"BENCHMARK.json"}      # entries added, no file edited
    spec = harness.load_spec("arange-lz4-c5.read", root=tmp_path)
    assert spec.config["name"] == "arange-lz4-c5"
    assert spec.traffic["warmup_passes"] == 2
    line = harness.run_cell(spec, 12, 0.3, False, CPU, log=io.StringIO())
    assert line["correct"] is True
    assert {"output_MB", "decompress_GBps", "setup_s"} == set(line["metrics"])


def test_guard_compares_top_level_names_whole(monkeypatch):
    assert harness.banned_modules(["cblosc_tpu_torch.api", "numpy",
                                   "cblosc_tpu_fake", "jaxtyping"]) == []
    assert harness.banned_modules(["cblosc_tpu.core.engine", "jax.numpy",
                                   "flax", "jaxlib.xla_client"]) == [
        "cblosc_tpu", "flax", "jax", "jaxlib"]
    line = {"check": {"wrong_bytes": {"value": 0, "limit": 0}}}
    monkeypatch.setitem(sys.modules, "cblosc_tpu_fake",
                        types.ModuleType("cblosc_tpu_fake"))
    out, err = io.StringIO(), io.StringIO()
    assert harness.emit(line, out, err) == 0 and out.getvalue()
    monkeypatch.setitem(sys.modules, "cblosc_tpu",
                        types.ModuleType("cblosc_tpu"))
    out, err = io.StringIO(), io.StringIO()
    assert harness.emit(line, out, err) != 0
    assert out.getvalue() == "" and "cblosc_tpu" in err.getvalue()


def _run_command(cwd: Path):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    return subprocess.run(
        [sys.executable, "portbench/run.py", "--workload",
         "pyblosc-blosclz-c9.write", "--seed", str(SEED), "--seconds", "1",
         "--trace", "0"], cwd=cwd, capture_output=True, text=True,
        timeout=300, env=env)


def test_command_prints_no_result_without_a_card_or_the_program(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the command would measure it")
    res = _run_command(ROOT)
    assert res.returncode != 0 and res.stdout == ""
    assert "no CUDA device" in res.stderr
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    res = _run_command(tmp_path)
    assert res.returncode != 0 and res.stdout == ""


@pytest.mark.cuda
def test_command_prints_no_result_in_a_tree_without_the_program(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs the card: without one the command stops earlier")
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    res = _run_command(tmp_path)
    assert res.returncode != 0 and res.stdout == ""
    assert "cblosc_tpu_torch" in res.stderr


def test_a_getitem_mix_needs_only_a_traffic_file(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    (tmp_path / "portbench" / "traffic" / "getitem_100.json").write_text(
        json.dumps({"op": "getitem", "chunks_written_by": "cblosc_writer",
                    "items": 100, "ranges": 16, "warmup_passes": 1}))
    bench = json.loads((tmp_path / "BENCHMARK.json").read_text())
    bench["workloads"].append({
        "name": "zarr-lz4-c5.getitem", "config": "zarr-lz4-c5",
        "traffic": "getitem_100", "chips": 1, "why": "a test"})
    p95 = next(m for m in bench["end_to_end"] if m["name"] == "call_ms_p95")
    p95["workloads"].append("zarr-lz4-c5.getitem")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    spec = tiny(harness.load_spec("zarr-lz4-c5.getitem", root=tmp_path),
                16 << 10)
    line = harness.run_cell(spec, SEED, 0.3, False, CPU, log=io.StringIO())
    assert line["correct"] is True, line["check"]
    assert set(line["metrics"]) == {"call_ms_p95", "setup_s"}
