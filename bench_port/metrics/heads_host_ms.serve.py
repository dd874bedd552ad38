"""``heads_host_ms.serve``: the median over the traced window's requests of
the program's ``dat.heads`` span (the neck, the decode head and the logits'
resize), host milliseconds."""

from bench_port.metrics.spans import host_ms


def read(run):
    return host_ms("dat.serve", "dat.heads")
