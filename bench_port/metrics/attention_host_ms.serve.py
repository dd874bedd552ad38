"""``attention_host_ms.serve``: the median over the traced window's requests
of the request's ``dat.attention`` spans summed (each
``DeformableAttention.forward``, either route), host milliseconds."""

from bench_port.metrics.spans import host_ms


def read(run):
    return host_ms("dat.serve", "dat.attention")
