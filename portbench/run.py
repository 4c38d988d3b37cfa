"""Run one cell of the benchmark once and print its result line.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout on a machine with the cards the cell asks
for (``BENCHMARK.json``). The last line of standard output is the JSON
result; the numbers the correctness check compared, each beside its
limit, are the last lines of standard error. Exits nonzero, printing no
result, without a card, in a tree without the program, or where the run
loaded JAX or the JAX package.
"""

import os
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
# the checkout's root, not this directory, heads the import path, so that
# the program and the portbench package import and no file here shadows
# a module of the standard library
sys.path[0] = str(ROOT)
# every build and kernel cache stays at a fixed path inside the checkout
os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" / "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton")

from portbench.harness import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main())
