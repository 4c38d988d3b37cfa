"""api_host_ms.write: per call, the host time of the byte API and chunk
assembly (api.compress_ctx, gpu/host_api.py): the compress_ctx
span less the compress_blocks spans inside it."""

from portbench.metrics._layer import per_call_ms


def read(run):
    t = run.traced
    if run.op != "compress" or t is None:
        return None
    return per_call_ms(run, t.span_s("compress_ctx") -
                       t.span_s("compress_blocks"))
