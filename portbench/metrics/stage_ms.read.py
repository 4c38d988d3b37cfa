"""stage_ms.read: per call, host ms in the byte API's own staging of a
decompress_ctx call (the program's host_api.parse, stage_in, fetch and
assemble spans)."""

from portbench.metrics._program import stage_ms


def read(run):
    return stage_ms(run, "decompress")
