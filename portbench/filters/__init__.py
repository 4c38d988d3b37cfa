"""The plain reference's filters, one module a filter, found by name
(``portbench.registry.scan``).

Each module holds the configuration's name for it (``NAME``, a value of
the configuration's ``shuffle``), blosc's ``doshuffle`` argument that
asks for it (``CODE``), the header flag bits that mark a chunk filtered
by it (``FLAG``; 0 for none) and ``undo(typesize, block)``: a block's
bytes (a uint8 array) with the filter undone.
"""

from ..registry import index, scan

ALL = scan(__name__, __path__)
BY_NAME = index(ALL, "NAME", "filter")
BY_FLAG = index(ALL, "FLAG", "filter")
