"""pipeline_ms.getitem: per getitem call, the time of
gpu.pipeline.decompress_blocks over the blocks the range overlaps
(filters and codec, device work included: its span ends in a device
synchronize)."""

from portbench.metrics._layer import per_call_ms


def read(run):
    t = run.traced
    if run.op != "getitem" or t is None:
        return None
    return per_call_ms(run, t.span_s("decompress_blocks"))
