"""device_idle_pct.read: the share of the traced window in which no
kernel, copy or set ran on the card (1 less the union of its activity)."""

from portbench.metrics._layer import idle_pct


def read(run):
    if run.op != "decompress" or run.traced is None:
        return None
    return idle_pct(run)
