"""mine_ms.write: per call, the time of gpu.codec.mine_group, the
encoders' adaptive-distance miner (device work included)."""

from portbench.metrics._layer import per_call_ms


def read(run):
    t = run.traced
    if run.op != "compress" or t is None:
        return None
    return per_call_ms(run, t.span_s("mine_group"))
