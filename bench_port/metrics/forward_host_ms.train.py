"""``forward_host_ms.train``: the median over the traced window's steps of the
program's ``dat.step.forward`` span, from the batch's move to the loss: the
forward and the loss; host milliseconds."""

from bench_port.metrics.spans import host_ms


def read(run):
    return host_ms("dat.step", "dat.step.forward")
