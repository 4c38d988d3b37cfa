"""cblosc_tpu_torch — the PyTorch/CUDA port of cblosc_tpu.

Blosc-format chunk compression of typed binary data on an NVIDIA H100:
the same chunk bytes as the JAX package (``cblosc_tpu``, the reference),
with its device loops as hand-written CUDA kernels (``csrc/``). Entry
points run on ``cuda`` unless the caller passes ``device="cpu"``. The
global API (``compress``, ``getitem``, ``set_*``, the BLOSC_* variables)
is the JAX package's; ``cblosc_tpu_torch.parallel`` shards the block
axis over the ranks of a ``torch.distributed`` process group.

This package imports torch and numpy, never jax, and nothing of
``cblosc_tpu``: it keeps its own copies of the host layers it needs.
"""

from .api import *  # noqa: F401,F403
from .api import __all__ as _api_all
from .format import constants
from .format.constants import (  # noqa: F401
    ALWAYS_SPLIT, AUTO_SPLIT, BITSHUFFLE, BLOSCLZ, FORWARD_COMPAT_SPLIT,
    LZ4, LZ4HC, MAX_BUFFERSIZE, MAX_OVERHEAD, MAX_THREADS, MAX_TYPESIZE,
    NEVER_SPLIT, NOSHUFFLE, SHUFFLE, SNAPPY, VERSION_STRING, ZLIB, ZSTD,
)

__version__ = constants.VERSION_STRING
__all__ = list(_api_all) + ["constants"]
