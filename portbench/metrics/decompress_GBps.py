"""decompress_GBps: bytes returned by every decompress call that
completed in the window, over the window's seconds (GB = 1e9 B)."""


def read(run):
    if run.op != "decompress" or run.window_s <= 0:
        return None
    return run.bytes_out / 1e9 / run.window_s
