"""What the plain reference's codecs and filters share: the error a
reader raises on a chunk it cannot vouch for, and the scan that finds
them by name.

A codec or a filter is a module of its own in ``portbench/codecs/`` or
``portbench/filters/``, found when its package is imported: adding one
adds a file and edits none. Names that start with ``_`` are helpers, not
entries.
"""

from __future__ import annotations

import importlib
import pkgutil


class ChunkError(ValueError):
    """A chunk the reference cannot read: malformed, or of a kind the
    benchmark never writes."""


def scan(package: str, path) -> dict:
    """name -> module, for every module of ``package`` (at ``path``)
    whose name does not start with ``_``."""
    return {m.name: importlib.import_module(f"{package}.{m.name}")
            for m in pkgutil.iter_modules(path)
            if not m.name.startswith("_")}


def index(modules: dict, key: str, what: str) -> dict:
    """value -> module over each module's ``key`` (a value, or a tuple of
    values); two modules that claim one value are a fault of the tree."""
    out: dict = {}
    for name, mod in modules.items():
        values = getattr(mod, key)
        for v in values if isinstance(values, tuple) else (values,):
            if v in out:
                raise ImportError(f"{what} {key} {v!r} is claimed by both "
                                  f"{out[v].__name__} and {mod.__name__}")
            out[v] = mod
    return out
