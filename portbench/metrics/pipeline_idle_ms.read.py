"""pipeline_idle_ms.read: per call, ms inside the program's own
pipeline.decompress_blocks spans (both budgets; they end before the
benchmark's wrapper synchronizes) in which the card ran nothing: the
pipeline's host-bound time."""

from portbench.metrics._program import idle_ms


def read(run):
    return idle_ms(run, "decompress", "pipeline.decompress_blocks")
