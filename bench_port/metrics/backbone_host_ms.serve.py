"""``backbone_host_ms.serve``: the median over the traced window's requests
of the program's ``dat.backbone`` span less its ``dat.attention`` children:
the backbone's host milliseconds outside the deformable attention."""

from bench_port.metrics.spans import host_ms


def read(run):
    return host_ms("dat.serve", "dat.backbone", less=("dat.attention",))
