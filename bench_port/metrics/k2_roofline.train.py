"""``k2_roofline.train``: K2's least time at the step's attention shapes
(PERF.md §6's count, ``yardstick.k2_bound_s``) over the device time of the
kernels named ``deform_attn_bwd``, in the traced window, as a percentage."""

from bench_port.metrics.yardstick import k2_bound_s

KERNEL = "deform_attn_bwd"


def read(run):
    trace = run.get("trace")
    if trace is None or not run.get("calls"):
        return None
    seconds = trace.device_s(KERNEL)
    if seconds <= 0:
        return None
    return 100.0 * k2_bound_s(run["calls"], run["batch"]) * run["units"] / seconds
