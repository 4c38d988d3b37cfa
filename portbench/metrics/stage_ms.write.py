"""stage_ms.write: per call, host ms in the byte API's own staging of a
compress_ctx call (the program's host_api.stage_in, fetch and assemble
spans; a write has no parse)."""

from portbench.metrics._program import stage_ms


def read(run):
    return stage_ms(run, "compress")
