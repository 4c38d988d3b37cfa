"""pipeline_ms.write: per call, the time of gpu.pipeline.compress_blocks
(filters and codec, device work included: its span ends in a device
synchronize)."""

from portbench.metrics._layer import per_call_ms


def read(run):
    t = run.traced
    if run.op != "compress" or t is None:
        return None
    return per_call_ms(run, t.span_s("compress_blocks"))
