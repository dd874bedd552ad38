"""``backward_host_ms.train``: the median over the traced window's steps of the
program's ``dat.step.backward`` span, ``zero_grad`` and ``loss.backward()``:
the backward's enqueue; host milliseconds."""

from bench_port.metrics.spans import host_ms


def read(run):
    return host_ms("dat.step", "dat.step.backward")
