"""pipeline_idle_ms.write_p95: pipeline_idle_ms.write's reading, in the
write cell whose end-to-end speed metric is call_ms_p95 alone: there
compress_GBps, on the host's clock, spreads too widely between runs to
be bounded (PERF.md)."""

from portbench.metrics._alias import read_as


def read(run):
    return read_as("pipeline_idle_ms.write", run)
