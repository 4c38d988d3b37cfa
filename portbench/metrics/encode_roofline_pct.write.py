"""encode_roofline_pct.write: (uncompressed bytes in + chunk bytes out)
at the card's peak bandwidth, over the device time inside the
gpu.pipeline.compress_blocks spans: the same work whatever implements
the encoders."""

from portbench.metrics._layer import roofline_pct


def read(run):
    if run.op != "compress" or run.traced is None:
        return None
    return roofline_pct(run, "compress_blocks")
