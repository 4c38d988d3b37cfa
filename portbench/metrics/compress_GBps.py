"""compress_GBps: uncompressed bytes of every compress call that
completed in the window, over the window's seconds (GB = 1e9 B)."""


def read(run):
    if run.op != "compress" or run.window_s <= 0:
        return None
    return run.bytes_in / 1e9 / run.window_s
