"""One metric's reading under another name (not a metric: no entry of
BENCHMARK.json names it). Where a quantity moves one end-to-end metric
in some cells and another in others, each has an entry and a name of
its own, and the second reader gives the first one's reading."""

import importlib.util
from pathlib import Path


def read_as(name: str, run):
    path = Path(__file__).with_name(f"{name}.py")
    mspec = importlib.util.spec_from_file_location(
        "portbench_alias_" + "".join(c if c.isalnum() else "_" for c in name),
        path)
    mod = importlib.util.module_from_spec(mspec)
    mspec.loader.exec_module(mod)
    return mod.read(run)
