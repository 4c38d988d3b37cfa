"""Multi-device parallel engine on torch.distributed (counterpart of
cblosc_tpu/parallel)."""

from .engine import (  # noqa: F401
    BLOCKS,
    SPLITS,
    compress_blocks_sharded,
    compress_chunk,
    decompress_blocks_sharded,
    decompress_chunk,
    make_mesh,
    make_mesh_2d,
    training_step,
    training_step_2d,
)
