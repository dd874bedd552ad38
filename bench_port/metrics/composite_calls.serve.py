"""``composite_calls.serve``: the median over the traced window's requests
of the program's ``attn.composite`` counter, the deformable-attention calls
that take the composite route instead of K1 (0 where every 'D' block runs
K1; every 'D' block under exact padded inference)."""

from bench_port.metrics.spans import counted


def read(run):
    return counted("dat.serve", "attn.composite")
