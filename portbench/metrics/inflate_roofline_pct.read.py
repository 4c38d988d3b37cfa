"""inflate_roofline_pct.read: the least time the card needs to read
every zlib split of the window's calls that is not stored raw (its
csize) and to write what it inflates to (neblock), at the card's peak
bandwidth, over the device time of the work launched inside the
program's pipeline.decode_group spans (both budgets), in percent.

The bytes are counted from the input chunks by the plain reference, so
they are the same work whatever inflates them. The device time is that
of every kernel, copy and set whose launch (the profiler's correlation
of a device event with its runtime call) lies inside one of those spans,
wherever it runs on the device: a launch the host does not wait for is
counted all the same. Nothing is read where the program's records do not
hold a root for every call of the window (its ring dropped some)."""

from portbench import peaks
from portbench.metrics._coded import device_s_launched_in, window_coded_bytes


def read(run):
    if run.op != "decompress" or run.traced is None:
        return None
    peak = peaks.hbm_bytes_per_s(run.traced.device_kind)
    work = window_coded_bytes(run, "zlib")
    device_s = device_s_launched_in(run, "api.decompress_ctx",
                                    "pipeline.decode_group")
    if not peak or not work or not device_s:
        return None
    return 100.0 * work / peak / device_s
