"""decode_roofline_pct.read: (chunk bytes in + bytes out) at the card's
peak bandwidth, over the device time inside the
gpu.pipeline.decompress_blocks spans (the retry's second pass included)."""

from portbench.metrics._layer import roofline_pct


def read(run):
    if run.op != "decompress" or run.traced is None:
        return None
    return roofline_pct(run, "decompress_blocks")
