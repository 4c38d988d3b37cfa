"""launches_per_call.read: launches of the hand-written CUDA kernels
(gpu.kernels.LAUNCHES, every kernel summed) in the window, per call."""


def read(run):
    if run.op != "decompress" or not run.calls:
        return None
    return sum(run.launches.values()) / run.calls
