"""Cells that BENCHMARK.json no longer names, whose configuration and
traffic mix stay: the whole-chunk reads of zarr-lz4-c5 (C-blosc's LZ4
chunks) and of pyblosc-blosclz-c9 (the program's own chunks). Their
speed on the host's clock spread too widely between runs to be bounded
(PERF.md); the CPU tests still drive them through the harness and the
check."""

import json

from portbench import harness

RETIRED = {"zarr-lz4-c5.read": ("zarr-lz4-c5", "read_cblosc"),
           "pyblosc-blosclz-c9.read": ("pyblosc-blosclz-c9", "read_roundtrip")}


def load(cell: str) -> harness.Spec:
    """``harness.load_spec(cell)``, or for a retired cell its configuration
    and mix with no metrics."""
    if cell not in RETIRED:
        return harness.load_spec(cell)
    config, mix = RETIRED[cell]
    root = harness.ROOT
    bench = json.loads((root / "BENCHMARK.json").read_text())
    entry = next(c for c in bench["configs"] if c["name"] == config)
    return harness.Spec(
        {"name": cell, "config": config, "traffic": mix, "chips": 1},
        json.loads((root / entry["file"]).read_text()),
        json.loads((root / "portbench" / "traffic" / f"{mix}.json")
                   .read_text()), [], [], root)
