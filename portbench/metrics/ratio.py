"""ratio: uncompressed bytes over chunk bytes, over every chunk written
in the window (Blosc's space cost, beside the write and read speeds)."""


def read(run):
    if run.op != "compress" or run.bytes_out <= 0:
        return None
    return run.bytes_in / run.bytes_out
