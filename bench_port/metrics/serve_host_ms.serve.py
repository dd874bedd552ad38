"""``serve_host_ms.serve``: the median over the traced window's requests of
the program's ``dat.serve`` span (``SegInferencer.forward_batch``: the cast,
``valid_hw``, the model and the logits' ``.float()``), host milliseconds:
the in-program twin of ``dispatch_ms.serve``."""

from bench_port.metrics.spans import host_ms


def read(run):
    return host_ms("dat.serve", "dat.serve")
