"""The plain reference's stream decoders, one module a codec, found by
name (``portbench.registry.scan``).

Each module holds its wire format's ``COMPFORMAT`` (the header's
``flags >> 5``), the codec format version it writes in byte 1
(``VERSIONLZ``; blosc.h's ``BLOSC_*_VERSION_FORMAT``), the configuration
cnames that write it (``CNAMES``) and ``decode(src, maxout)``: the bytes
of one split stream, exactly ``maxout`` of them or a ``ChunkError``. The
codec's name is its module's.
"""

from ..registry import index, scan

ALL = scan(__name__, __path__)
BY_FORMAT = index(ALL, "COMPFORMAT", "codec")
BY_CNAME = index(ALL, "CNAMES", "codec")
