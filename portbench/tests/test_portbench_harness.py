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

import numpy as np
import pytest
import torch

from portbench import harness
from portbench.tests._retired import RETIRED, load

ROOT = Path(__file__).resolve().parents[2]
CELLS = [w["name"] for w in
         json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]]
CPU = torch.device("cpu")
SEED = 2**31 + 977          # a seed past 32 signed bits


def tiny(spec, chunk_bytes=32 << 10, chunks=3):
    """The cell at a size the CPU's plain kernels run in seconds: a getitem
    mix reads 8 ranges."""
    spec.config["chunk_bytes"] = chunk_bytes
    spec.config["working_set_chunks"] = chunks
    if "ranges" in spec.traffic:
        spec.traffic["ranges"] = 8
    return spec


def chunk_size(cell: str) -> int:
    # the plain LZ4 and DEFLATE walks are slow on the CPU: the cells that
    # read C-blosc-written chunks get one block of 8 dense and sparse
    # splits, of 2 KiB (LZ4) and of 1 KiB (zlib)
    return {"zarr-lz4-c5.read": 16 << 10, "zarr-lz4-c5.getitem": 16 << 10,
            "numcodecs-zlib-c5.read": 8 << 10}.get(cell, 32 << 10)


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("cell", CELLS + sorted(RETIRED))
def test_tiny_pass_prints_the_contract_line(cell, trace):
    spec = tiny(load(cell), chunk_size(cell))
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

    spec = tiny(load("pyblosc-blosclz-c9.read"))
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
    (tmp_path / "portbench" / "traffic" / "getitem_16.json").write_text(
        json.dumps({"op": "getitem", "chunks_written_by": "cblosc_writer",
                    "items": 16, "ranges": 16, "warmup_passes": 1}))
    bench = json.loads((tmp_path / "BENCHMARK.json").read_text())
    bench["workloads"].append({
        "name": "zarr-lz4-c5.getitem_16", "config": "zarr-lz4-c5",
        "traffic": "getitem_16", "chips": 1, "why": "a test"})
    p95 = next(m for m in bench["end_to_end"] if m["name"] == "call_ms_p95")
    p95["workloads"].append("zarr-lz4-c5.getitem_16")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    spec = tiny(harness.load_spec("zarr-lz4-c5.getitem_16", root=tmp_path),
                16 << 10)
    line = harness.run_cell(spec, SEED, 0.3, False, CPU, log=io.StringIO())
    assert line["correct"] is True, line["check"]
    assert set(line["metrics"]) == {"call_ms_p95", "setup_s"}


def test_inflate_work_is_counted_from_the_input_chunks():
    import zlib

    from portbench import cblosc_writer, traffic
    from portbench.metrics import _coded

    cfg = {"data": {"generator": "synth", "significant_bits": 19},
           "working_set_chunks": 2, "chunk_bytes": 1 << 20}
    data = traffic.make_data(cfg, 9)
    chunks = [cblosc_writer.compress(5, "SHUFFLE", 8, d, "zlib")
              for d in data]
    # by hand: the zlib streams of the splits (raw ones are 128 KiB), each
    # read whole and inflated to its 128 KiB
    want = []
    for ch in chunks:
        pos, n = 16 + 4, 0
        for _ in range(8):
            csize = int.from_bytes(ch[pos:pos + 4], "little")
            stream = ch[pos + 4:pos + 4 + csize]
            if csize != 128 << 10:
                assert len(zlib.decompress(stream)) == 128 << 10
                n += csize + (128 << 10)
            pos += 4 + csize
        want.append(n)
    assert [_coded.coded_bytes(ch, "zlib") for ch in chunks] == want
    assert 0 < want[0] < 2 * len(data[0])
    run = harness.Run(op="decompress", inputs=dict(enumerate(chunks)),
                      completed={0: 3, 1: 2})
    assert _coded.window_coded_bytes(run, "zlib") == 3 * want[0] + 2 * want[1]
    lz4 = cblosc_writer.compress(5, "SHUFFLE", 8, data[0], "lz4")
    assert _coded.coded_bytes(lz4, "zlib") is None
    run.inputs[1] = lz4
    assert _coded.window_coded_bytes(run, "zlib") is None


def test_device_time_goes_to_the_span_that_launched_it(monkeypatch):
    from portbench import spans
    from portbench.metrics import _coded, _program

    # two spans (100-200, 300-400 ns); kernel 1 is launched in the first
    # and runs past its end, kernel 2 is launched before the second and
    # runs inside it, kernel 3 has no launch in the trace, copy 4 is
    # launched in the second and overlaps kernel 2
    events = [(150, 260, "k1", 1), (310, 350, "k2", 2),
              (360, 380, "k3", 3), (340, 370, "copy", 4)]
    launches = {1: 190, 2: 250, 4: 330}
    t = spans.Trace([], events, 0, 1000, "cpu", launches=lambda: launches)
    assert t.device_s_launched_in([300, 100], [400, 200]) == (110 + 30) / 1e9
    assert t.device_s_launched_in([500], [600]) is None
    # inside a span by the host's interval, not by the launch: k2, k3
    spans_ = np.array([[100, 200], [300, 400]], dtype=np.int64)
    t.spans = {"decode_group": spans_}
    assert t.device_s_in("decode_group") == (50 + 70) / 1e9

    Rec = types.SimpleNamespace
    recs = [Rec(name="api.decompress_ctx", start_ns=90, end_ns=210, call=0),
            Rec(name="pipeline.decode_group", start_ns=100, end_ns=200,
                call=0),
            Rec(name="api.decompress_ctx", start_ns=290, end_ns=410, call=1),
            Rec(name="pipeline.decode_group", start_ns=300, end_ns=400,
                call=1)]
    monkeypatch.setattr(_program, "window_records", lambda run: recs)
    run = harness.Run(op="decompress", calls=2, traced=t)
    assert _coded.device_s_launched_in(
        run, "api.decompress_ctx", "pipeline.decode_group") == 140 / 1e9
    # a call whose root the ring let go: nothing is read
    run.calls = 3
    assert _coded.device_s_launched_in(
        run, "api.decompress_ctx", "pipeline.decode_group") is None
