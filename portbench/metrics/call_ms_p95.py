"""call_ms_p95: the 95th percentile (numpy's linear interpolation) of
the host-clock latency of every call that completed in the window, each
from its start to the return of its bytes."""

import numpy as np


def read(run):
    if not run.latencies_s:
        return None
    return float(np.percentile(run.latencies_s, 95)) * 1e3
