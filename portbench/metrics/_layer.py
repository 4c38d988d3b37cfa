"""Shared arithmetic of the per-layer readers (not a metric: no entry of
BENCHMARK.json names it)."""

from portbench import peaks


def per_call_ms(run, seconds: float):
    return seconds / run.calls * 1e3 if run.calls else None


def roofline_pct(run, span: str):
    """The least time the card needs to read a call's input and write its
    output once, over the device time inside ``span``, in percent; None
    where no device time or no peak is known."""
    peak = peaks.hbm_bytes_per_s(run.traced.device_kind)
    device_s = run.traced.device_s_in(span)
    if not peak or device_s <= 0:
        return None
    return 100.0 * (run.bytes_in + run.bytes_out) / peak / device_s


def idle_pct(run):
    t = run.traced
    return 100.0 * (1.0 - t.busy_s / t.window_s) if t.window_s > 0 else None
