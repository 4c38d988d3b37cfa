"""The benchmark's CPU tests: ``python -m pytest portbench/tests -q``
from the root of the checkout. Tests marked ``cuda`` need the card and
skip without one, deciding inside the test."""

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line("markers",
                            "cuda: needs an NVIDIA GPU; skips without one")
