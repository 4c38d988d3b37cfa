"""pipeline_idle_ms.write: per call, ms inside the program's own
pipeline.compress_blocks spans (which end before the benchmark's wrapper
synchronizes) in which the card ran nothing: the pipeline's host-bound
time."""

from portbench.metrics._program import idle_ms


def read(run):
    return idle_ms(run, "compress", "pipeline.compress_blocks")
