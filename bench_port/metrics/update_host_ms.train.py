"""``update_host_ms.train``: the median over the traced window's steps of the
program's ``dat.step.update`` span, the ``no_grad`` block: zero fills,
norms, clip, learning rate, AdamW, update norm and IoU counts (whose CUDA
``bincount`` waits for the device); host milliseconds."""

from bench_port.metrics.spans import host_ms


def read(run):
    return host_ms("dat.step", "dat.step.update")
