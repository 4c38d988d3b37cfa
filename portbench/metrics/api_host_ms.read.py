"""api_host_ms.read: per call, the host time of the byte API and chunk
assembly (api.decompress_ctx, gpu/host_api.py): the decompress_ctx
span less the decompress_blocks spans inside it."""

from portbench.metrics._layer import per_call_ms


def read(run):
    t = run.traced
    if run.op != "decompress" or t is None:
        return None
    return per_call_ms(run, t.span_s("decompress_ctx") -
                       t.span_s("decompress_blocks"))
